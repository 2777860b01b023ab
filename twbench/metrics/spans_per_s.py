"""spans_per_s: spans of every round completed in the window, over the
seconds from the window's start to the end of its last round."""


def read(reading):
    return reading["spans_per_s"]
