"""Streaming reconstruction, the online mode (mirrors
``traceweaver_tpu/stream``).

The batch executor loads a fixed corpus and solves each service once. A
deployed reconstructor instead receives spans as an unbounded,
out-of-order stream; this package is that mode:

- :mod:`sources`: span event streams (replay of a recorded corpus with
  deterministic out-of-order arrival, the capture ingress of
  :mod:`traceweaver_tpu_torch.collector`, or any list of
  :class:`~traceweaver_tpu_torch.stream.sources.SpanEvent`);
- :mod:`watermark`: event-time watermark (bounded out-of-orderness,
  lateness accounting);
- :mod:`window`: overlapping event-time windows, each span owned by one,
  and late-span routing;
- :mod:`scheduler`: micro-batches of sealed windows onto one
  ``solve_fleet`` call each, with a bounded queue, a spill queue, a
  watchdog and retries;
- :mod:`state`: the incremental span store, the per-service statistics
  carried between windows (warm start) and the streamed-accuracy grader;
- :mod:`checkpoint`: atomic checkpoints with a CRC trailer and a
  last-good fallback, so a killed service resumes without reprocessing
  or emitting twice;
- :mod:`service`: the driver that wires them and emits stitched traces.

CLI: ``python -m traceweaver_tpu_torch.runtime.cli stream --source
replay:<corpus-dir> ...`` (or ``collector:<strace-log|dir|fifo>``). :mod:`wal`, the write-ahead ingest log,
serves the serve tier (:mod:`traceweaver_tpu_torch.serve`).
"""

from traceweaver_tpu_torch.stream.checkpoint import (  # noqa: F401
    CheckpointCorrupt,
    load_checkpoint,
    save_checkpoint,
)
from traceweaver_tpu_torch.stream.scheduler import MicroBatchScheduler  # noqa: F401
from traceweaver_tpu_torch.stream.service import (  # noqa: F401
    StreamConfig,
    StreamingReconstructor,
    TraceSink,
)
from traceweaver_tpu_torch.stream.sources import (  # noqa: F401
    IterableSource,
    ReplaySource,
    SpanEvent,
    parse_source_spec,
)
from traceweaver_tpu_torch.stream.state import (  # noqa: F401
    CarriedState,
    LiveTraceStore,
    StreamGrader,
)
from traceweaver_tpu_torch.stream.watermark import WatermarkTracker  # noqa: F401
from traceweaver_tpu_torch.stream.window import (  # noqa: F401
    WindowBuffer,
    WindowingEngine,
)
