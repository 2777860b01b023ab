"""tail_s: seconds a round of ``solve_fleet``'s own ``stats["fleet_tail_s"]``,
from the end of its last fetch from the card to its return (the decode left
after it); the mean over the window's rounds that hold it, None when none
does."""


def read(reading):
    vals = [r["stats"]["fleet_tail_s"] for r in reading["rounds"]
            if "fleet_tail_s" in r["stats"]]
    return sum(vals) / len(vals) if vals else None
