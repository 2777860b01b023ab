"""assembly_roofline: the assembly kernel's share of its roofline in the
traced window: the least time its launches need (counted by
``twbench/roofline.py`` from the checked round's blocks) over the device
time of ``assemble_block_kernel`` in the profiler's trace. None untraced."""

from twbench.harness import kernel_share


def read(reading):
    return kernel_share(reading, "assembly", "assemble_block_kernel")
