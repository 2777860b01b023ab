"""round_s: the median seconds of the window's rounds, by the harness's own
clock around each ``solve_fleet`` call (the ``tw:bench:round`` range)."""


def read(reading):
    return reading["round_median_s"]
