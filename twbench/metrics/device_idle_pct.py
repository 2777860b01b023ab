"""device_idle_pct: the share of the traced window in which no operation
ran on the card (``twbench/timeline.py device_timeline``). None untraced."""


def read(reading):
    tr = reading.get("trace")
    return None if tr is None else 100.0 * tr["timeline"]["idle_share"]
