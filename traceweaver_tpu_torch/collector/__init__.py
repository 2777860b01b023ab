"""Span collector: capture-side prototypes (§2.5 of the survey).

Offline pipeline over recorded ``strace`` logs — the rebuild of the
reference's span-collector prototypes (reference:
src/span_collector/http2_parser/parser.py, span_collector/ebpf/
http2_filter.py) without the ``h2`` dependency:

1. :mod:`.strace` — reassemble interleaved syscalls into per-(fd,
   iteration) bidirectional byte streams with thread attribution;
2. :mod:`.http2` + :mod:`.hpack` — replay streams as HTTP/2, recovering
   request/response events (self-contained RFC 7540/7541 implementation);
3. :mod:`.threading_model` — join requests via tracing headers and measure
   thread predictability (the vPath hypothesis test);
4. :mod:`.ebpf` — live-capture equivalent (BCC), import-gated.

:func:`collect_from_strace_log` runs 1–3 end-to-end.

The **capture ingress** (:mod:`.source` + :mod:`.skew`, docs/COLLECTOR.md)
closes the loop the offline pipeline leaves open: it runs the same
reassembly/replay machinery incrementally, hardens it against clock skew,
partial capture, and connection churn, and emits the stream layer's
timed span events — ``--source collector:<path|fifo>`` on the stream CLI,
``POST /api/v1/tenants/<id>/capture`` on the serve server.

Mirrors ``traceweaver_tpu/collector/__init__.py``; the port keeps its own copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from traceweaver_tpu_torch.collector.hpack import Decoder, Encoder  # noqa: F401
from traceweaver_tpu_torch.collector.http2 import (  # noqa: F401
    DirectionReplayer,
    Event,
    looks_like_http2,
    replay_connection,
)
from traceweaver_tpu_torch.collector.strace import (  # noqa: F401
    FdStream,
    StraceParser,
    parse_strace_log,
    unescape_strace,
)
from traceweaver_tpu_torch.collector.threading_model import (  # noqa: F401
    AttributedRequest,
    attribute_requests,
    join_causal_pairs,
    request_key,
    thread_predictability,
)

# NOTE: the capture ingress (collector.source.CollectorSource, the
# skew/loss/churn hardening layer) is intentionally NOT imported here —
# it pulls in the stream layer and numpy, and the offline pipeline above
# must stay importable from lint/tail fast paths. Import it explicitly:
#   from traceweaver_tpu_torch.collector.source import CollectorSource


@dataclass
class CollectorReport:
    """Everything the offline collector recovers from one strace log."""

    streams: Dict[Tuple[int, int], FdStream]
    events_by_stream: Dict[Tuple[int, int], Tuple[List[Event], List[Event]]]
    requests: List[AttributedRequest]
    causal_pairs: List[Tuple[AttributedRequest, AttributedRequest]]
    thread_predictability: Optional[float]


def collect_from_strace_log(text: str) -> CollectorReport:
    """Run the full offline pipeline on an ``strace -f`` log."""
    streams = parse_strace_log(text)
    events_by_stream = {
        key: replay_connection(s.inbound, s.outbound)
        for key, s in streams.items()
        if looks_like_http2(s.inbound, s.outbound)
    }
    requests = attribute_requests(streams, events_by_stream)
    pairs = join_causal_pairs(requests)
    return CollectorReport(
        streams=streams,
        events_by_stream=events_by_stream,
        requests=requests,
        causal_pairs=pairs,
        thread_predictability=thread_predictability(pairs),
    )
