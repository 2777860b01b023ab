"""lead_s: seconds a round of ``solve_fleet``'s own ``stats["fleet_lead_s"]``,
from its entry to the start of its first group's dispatch (plan, window plan,
grouping and the first pack: the card idle throughout); the mean over the
window's rounds that hold it, None when none does."""


def read(reading):
    vals = [r["stats"]["fleet_lead_s"] for r in reading["rounds"]
            if "fleet_lead_s" in r["stats"]]
    return sum(vals) / len(vals) if vals else None
