"""MSCallGraph row schema (mirrors
``traceweaver_tpu/alibaba/schema.py``).

Alibaba's cluster-trace-microservices-v2021 ``MSCallGraph_*.csv`` rows, as
consumed by the reference pipeline (reference alibaba-analysis/
preprocess.py:40-52, real-parser.py:308-359): columns
``[row_index, traceid, timestamp_ms, rpc_id, um, rpctype, dm, interface,
rt_ms]`` where ``rpc_id`` is the dotted call-position id ("0.1.2"), ``um``
the caller microservice, ``dm`` the callee, and ``rt`` the response time in
milliseconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

# Values the dataset uses for unknown fields (reference real-parser.py's
# ``search_strings``).
MISSING_VALUES = ("(?)", "", "None", "nan")

# column indices (reference code addresses rows positionally)
COL_TRACE_ID = 1
COL_TIMESTAMP = 2
COL_RPC_ID = 3
COL_CALLER = 4
COL_RPC_TYPE = 5
COL_CALLEE = 6
COL_INTERFACE = 7
COL_RT = 8


@dataclass
class CallRecord:
    trace_id: str
    timestamp_ms: int
    rpc_id: str
    caller: str
    rpc_type: str
    callee: str
    interface: str
    rt_ms: int

    @classmethod
    def from_row(cls, row: List[str]) -> "CallRecord":
        return cls(
            trace_id=row[COL_TRACE_ID],
            timestamp_ms=int(float(row[COL_TIMESTAMP])),
            rpc_id=row[COL_RPC_ID],
            caller=row[COL_CALLER],
            rpc_type=row[COL_RPC_TYPE],
            callee=row[COL_CALLEE],
            interface=row[COL_INTERFACE],
            rt_ms=int(float(row[COL_RT])),
        )

    def to_row(self, index: int = 0) -> List[str]:
        return [str(index), self.trace_id, str(self.timestamp_ms), self.rpc_id,
                self.caller, self.rpc_type, self.callee, self.interface,
                str(self.rt_ms)]


def is_missing(value: str) -> bool:
    return value in MISSING_VALUES


def parent_rpc_id(rpc_id: str) -> str:
    return ".".join(rpc_id.split(".")[:-1])


def rpc_depth(rpc_id: str) -> int:
    return len(rpc_id.split("."))
