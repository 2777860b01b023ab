"""decode_wall_s: seconds a round of ``solve_fleet``'s own
``stats["decode_wall_s"]``, the union of its decode stages over the flow
workers (``decode_s`` is their sum); the mean over the window's rounds that
hold it, None when none does."""


def read(reading):
    vals = [r["stats"]["decode_wall_s"] for r in reading["rounds"]
            if "decode_wall_s" in r["stats"]]
    return sum(vals) / len(vals) if vals else None
