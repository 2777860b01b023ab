"""Alibaba cluster-trace (MSCallGraph) pipeline (mirrors
``traceweaver_tpu/alibaba``).

Mirrors the reference's offline preprocessing chain (reference:
src/trace_reconstructor/ports/python/alibaba-analysis/): shard the
clusterdata CSVs per trace, repair and convert each trace to Jaeger JSON
with synthetic server/client record pairs, and group traces into
call-graph-signature datasets (``call_graph_0..14``) that exp5 sweeps.

Because the reference release ships ``call_graph_data`` only as a git-LFS
pointer and the clusterdata CSVs are external (BASELINE.md artifact gaps),
:mod:`traceweaver_tpu_torch.alibaba.synthesize` can generate MSCallGraph-format
rows for 15 synthetic topologies and push them through the *same* repair /
convert / group pipeline to produce exp5-ready inputs.
"""

from traceweaver_tpu_torch.alibaba.convert import (  # noqa: F401
    convert_trace_to_jaeger,
    repair_trace,
)
from traceweaver_tpu_torch.alibaba.grouping import call_graph_signature, group_traces  # noqa: F401
from traceweaver_tpu_torch.alibaba.schema import CallRecord  # noqa: F401
