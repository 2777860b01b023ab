"""peak_mem_gb: the most device memory the window's rounds held
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
in 1e9 bytes."""


def read(reading):
    return reading["peak_bytes"] / 1e9
