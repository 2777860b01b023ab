"""wait_s: seconds a round of ``solve_fleet``'s own ``stats["wait_s"]``, the
mean over the window's rounds."""


def read(reading):
    rounds = reading["rounds"]
    return sum(r["stats"].get("wait_s", 0.0) for r in rounds) / len(rounds)
