"""k1_roofline: K1's share of its roofline in the traced window: the least
time its launches need (bytes, f32 operations or exponentials, counted by
``twbench/roofline.py`` with the Sinkhorn iterations the reference needs on
the checked round's blocks) over the device time of ``fused_assign_kernel``
in the profiler's trace. None untraced."""

from twbench.harness import kernel_share


def read(reading):
    return kernel_share(reading, "k1", "fused_assign_kernel")
