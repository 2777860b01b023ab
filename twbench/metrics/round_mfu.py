"""round_mfu: the whole round's share of the card's peak: the least time
that all the K1 and assembly launches of the window need (each bound by
its bytes, f32 operations or exponentials) over the traced window. It
bounds what the kernels' rooflines can gain end to end. None untraced or off the card."""

from twbench.roofline import bound_s


def read(reading):
    tr = reading.get("trace")
    counts = reading.get("counts", {})
    rate = reading.get("exp_rate")
    if tr is None or not rate or not (counts.get("k1") or counts.get("assembly")):
        return None
    least = sum(bound_s(c["bytes"], c["ops"], c["exps"], rate)[0]
                for kind in ("k1", "assembly") for c in counts.get(kind, []))
    return 100.0 * least * tr["rounds"] / (tr["timeline"]["wall"] * 1e-6)
