"""Device ops of the port (mirrors ``traceweaver_tpu/ops``)."""

from typing import Dict


def kernel_counts() -> Dict[str, object]:
    """This process's kernel launch counters (K1, K2, the assembly
    kernel) and the kernel sources it compiled: a serve replica's
    ``/api/v1/stats`` ``kernels`` block, so that its launches can be read
    from outside its process. On the serve path each K1 launch solves a
    block the assembly kernel built, so a replica whose assembly launches
    fall short of its K1 launches built blocks some other way."""
    from traceweaver_tpu_torch.ops import cuda_build, cuda_sinkhorn, scores

    return dict(fused_assign=cuda_sinkhorn.LAUNCHES["fused_assign"],
                sinkhorn=cuda_sinkhorn.LAUNCHES["sinkhorn"],
                assemble_block=scores.LAUNCHES["assemble_block"],
                built=list(cuda_build.BUILT))
