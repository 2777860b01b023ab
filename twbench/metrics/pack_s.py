"""pack_s: seconds a round of ``solve_fleet``'s own ``stats["pack_s"]``, the
mean over the window's rounds."""


def read(reading):
    rounds = reading["rounds"]
    return sum(r["stats"].get("pack_s", 0.0) for r in rounds) / len(rounds)
