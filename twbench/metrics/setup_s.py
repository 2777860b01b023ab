"""setup_s: seconds from the start of the process to the window's start:
the corpus built and ingested, the problems built and compressed, the
cold round's fits and the warm-up rounds (kernel builds included)."""


def read(reading):
    return reading["setup_s"]
