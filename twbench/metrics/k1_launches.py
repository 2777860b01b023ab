"""k1_launches: K1 launches a round in the window, from the program's
launch counter (``ops/cuda_sinkhorn.py LAUNCHES["fused_assign"]``)."""


def read(reading):
    return reading["launches"]["k1"] / len(reading["rounds"])
