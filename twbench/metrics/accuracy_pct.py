"""accuracy_pct: exp5's end-to-end trace accuracy of the window's last
round, trace counts weighting the call graphs (``twbench/grade.py``)."""


def read(reading):
    return reading["accuracy_pct"]
