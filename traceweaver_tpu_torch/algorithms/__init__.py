"""Reconstruction algorithms of the port behind the reference's plugin
contract (mirrors ``traceweaver_tpu/algorithms``).

Every algorithm is a class with ``__init__(all_spans, all_processes)`` and
``FindAssignments(method, process, in_span_partitions,
out_span_partitions, parallel, instrumented_hops, true_assignments, ...)``
returning ``{out_ep: {in_span_id: out_span_id}}``. :func:`make_predictors`
is the reference executor's 11-entry, index-selected registry.
"""

from traceweaver_tpu_torch.algorithms.arrival_order import ArrivalOrder  # noqa: F401
from traceweaver_tpu_torch.algorithms.fcfs import FCFS  # noqa: F401
from traceweaver_tpu_torch.algorithms.vpath import VPath, VPathOld  # noqa: F401
from traceweaver_tpu_torch.algorithms.wap5 import WAP5  # noqa: F401
from traceweaver_tpu_torch.algorithms.weaver_exact import WeaverExact  # noqa: F401


def make_predictors(all_spans, all_processes, device=None, precision: str = "f32",
                    score_gemm: bool = False, mesh=None):
    """The ordered ``(method_name, instance)`` registry, index-compatible
    with the JAX package's (0..10):

    0 MaxScoreBatch (V2)               1 MaxScoreBatchParallel (V2)
    2 MaxScore (V1)                    3 WAP5
    4 FCFS                             5 ArrivalOrder
    6 vPathOld                         7 vPath
    8 MaxScoreBatchParallelWithoutIterations (WeaverTorch)
    9 MaxScoreBatchParallel (WeaverTorch)
    10 MaxScoreBatchSubsetWithSkips (WeaverTorch)

    Slots 0-7 run on the host; slots 8-10 on ``device`` (None: the card,
    raising without one), with the score precision ``precision`` and the
    GEMM score form when ``score_gemm`` (the JAX package's
    ``TW_PRECISION`` and ``TW_SCORE_GEMM``, which its slots 8-10 read),
    sharding their window batches over ``mesh`` when given
    (``WeaverTorch(mesh=)``).
    """
    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch

    def weaver():
        return WeaverTorch(all_spans, all_processes, device=device,
                           precision=precision, score_gemm=score_gemm, mesh=mesh)

    return [
        ("MaxScoreBatch", WeaverExact(all_spans, all_processes)),
        ("MaxScoreBatchParallel", WeaverExact(all_spans, all_processes)),
        ("MaxScore", WeaverExact(all_spans, all_processes)),
        ("WAP5", WAP5(all_spans, all_processes)),
        ("FCFS", FCFS(all_spans, all_processes)),
        ("ArrivalOrder", ArrivalOrder(all_spans, all_processes)),
        ("vPathOld", VPathOld(all_spans, all_processes)),
        ("vPath", VPath(all_spans, all_processes)),
        ("MaxScoreBatchParallelWithoutIterations", weaver()),
        ("MaxScoreBatchParallel", weaver()),
        ("MaxScoreBatchSubsetWithSkips", weaver()),
    ]
