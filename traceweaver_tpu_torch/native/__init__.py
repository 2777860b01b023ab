"""ctypes bindings of the port's C++ Jaeger-JSON loader (mirrors
``traceweaver_tpu/native/__init__.py``, the part ingest needs:
``parse_files``, ``NativeCorpus``, ``root_start_time``, ``last_error``).

The sources are the port's own copies, ``src/loader.cc`` and
``src/json.hpp``. They are built at first use with ``g++ -std=c++17 -O3
-fPIC -shared -pthread`` (the JAX package's ``native/Makefile`` flags)
into ``traceweaver_tpu_torch/_build/``, under a file name keyed by a
digest of the sources and flags; an ``fcntl`` lock lets parallel
processes share one build, and a thread lock guards the library handle.

Unlike the JAX module nothing here degrades quietly: a failed build, a
failed ``dlopen`` or a parse that returns null raises
:class:`NativeLoaderError` with the loader's own message.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCES = (os.path.join(_SRC_DIR, "loader.cc"), os.path.join(_SRC_DIR, "json.hpp"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
CXX = "g++"
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)


class NativeLoaderError(RuntimeError):
    """The C++ loader could not be built or loaded, or a parse failed."""


def build() -> str:
    """Compile the loader (once per source content and flags) and return
    the shared library's path; raises :class:`NativeLoaderError` with
    the compiler's output when the build fails."""
    h = hashlib.sha1(" ".join([CXX] + CXX_FLAGS).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"libtw_loader_{h.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    # CLI processes started together share one build: the first holds the
    # lock and compiles, the others find the library when they get it
    with open(os.path.join(BUILD_DIR, "loader.lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib):
                return lib
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [CXX, *CXX_FLAGS, SOURCES[0], "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise NativeLoaderError(f"cannot run {CXX}: {e}") from e
            if proc.returncode != 0:
                raise NativeLoaderError(
                    f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def _configure(lib: ctypes.CDLL) -> None:
    lib.tw_last_error.restype = ctypes.c_char_p
    lib.tw_parse_files.restype = ctypes.c_void_p
    lib.tw_parse_files.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long]
    lib.tw_corpus_free.argtypes = [ctypes.c_void_p]
    lib.tw_corpus_free.restype = None
    for name in ("tw_num_spans", "tw_num_traces", "tw_num_strings",
                 "tw_num_process_entries", "tw_num_refs"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    lib.tw_string.restype = ctypes.c_char_p
    lib.tw_string.argtypes = [ctypes.c_void_p, ctypes.c_long]
    for name in ("tw_span_start", "tw_span_duration"):
        fn = getattr(lib, name)
        fn.restype = _c_double_p
        fn.argtypes = [ctypes.c_void_p]
    for name in ("tw_span_trace", "tw_span_sid", "tw_span_op",
                 "tw_span_process", "tw_span_kind", "tw_span_malformed",
                 "tw_ref_trace", "tw_ref_sid", "tw_span_caller",
                 "tw_span_callee", "tw_trace_id", "tw_trace_file",
                 "tw_trace_malformed", "tw_process_trace", "tw_process_pid",
                 "tw_process_service"):
        fn = getattr(lib, name)
        fn.restype = _c_int32_p
        fn.argtypes = [ctypes.c_void_p]
    for name in ("tw_trace_span_offsets", "tw_span_ref_offsets"):
        fn = getattr(lib, name)
        fn.restype = _c_int64_p
        fn.argtypes = [ctypes.c_void_p]
    lib.tw_root_start_time.restype = ctypes.c_double
    lib.tw_root_start_time.argtypes = [ctypes.c_char_p]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises
    :class:`NativeLoaderError` when it cannot be built or loaded."""
    global _LIB
    with _lock:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
                _configure(lib)
            except (OSError, AttributeError) as e:
                raise NativeLoaderError(f"cannot load {path}: {e}") from e
            _LIB = lib
        return _LIB


def _decode(raw: bytes) -> str:
    # Python's json keeps lone surrogates from \uD800-style escapes; the
    # C++ loader encodes them as 3-byte sequences that surrogatepass maps
    # back to the same characters, keeping both front ends identical.
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        try:
            return raw.decode("utf-8", "surrogatepass")
        except UnicodeDecodeError:
            return raw.decode("utf-8", "replace")


class NativeCorpus:
    """Snapshot of a parsed corpus as owned numpy arrays.

    Everything is copied out of native memory during construction and the
    C++ corpus is freed at once, so the arrays do not depend on the
    handle. ``span_malformed`` and ``trace_malformed`` flag the records
    the Python side skips and counts (or raises on under ``strict``).
    """

    def __init__(self, lib: ctypes.CDLL, handle: int, n_files: int):
        self.n_files = n_files
        n = lib.tw_num_spans(handle)
        t = lib.tw_num_traces(handle)
        p = lib.tw_num_process_entries(handle)
        r = lib.tw_num_refs(handle)
        self.n_spans = n
        self.n_traces = t

        def arr(fn, length, ctype):
            if length == 0:
                return np.empty(0, dtype=ctype)
            return np.ctypeslib.as_array(fn(handle), shape=(length,)).copy()

        try:
            self.start = arr(lib.tw_span_start, n, np.float64)
            self.duration = arr(lib.tw_span_duration, n, np.float64)
            self.trace = arr(lib.tw_span_trace, n, np.int32)
            self.sid = arr(lib.tw_span_sid, n, np.int32)
            self.op = arr(lib.tw_span_op, n, np.int32)
            self.process = arr(lib.tw_span_process, n, np.int32)
            self.kind = arr(lib.tw_span_kind, n, np.int32)
            self.span_malformed = arr(lib.tw_span_malformed, n, np.int32)
            self.ref_offsets = arr(lib.tw_span_ref_offsets, n + 1, np.int64)
            self.ref_trace = arr(lib.tw_ref_trace, r, np.int32)
            self.ref_sid = arr(lib.tw_ref_sid, r, np.int32)
            self.caller = arr(lib.tw_span_caller, n, np.int32)
            self.callee = arr(lib.tw_span_callee, n, np.int32)
            self.trace_offsets = arr(lib.tw_trace_span_offsets, t + 1, np.int64)
            self.trace_id = arr(lib.tw_trace_id, t, np.int32)
            self.trace_file = arr(lib.tw_trace_file, t, np.int32)
            self.trace_malformed = arr(lib.tw_trace_malformed, t, np.int32)
            self.proc_trace = arr(lib.tw_process_trace, p, np.int32)
            self.proc_pid = arr(lib.tw_process_pid, p, np.int32)
            self.proc_service = arr(lib.tw_process_service, p, np.int32)
            self.strings: List[str] = [
                _decode(lib.tw_string(handle, i))
                for i in range(lib.tw_num_strings(handle))
            ]
        finally:
            lib.tw_corpus_free(handle)

    def string(self, idx: int) -> Optional[str]:
        return None if idx < 0 else self.strings[idx]

    def span_refs(self, i: int) -> List[Tuple[str, str]]:
        """The full (traceID, spanID) reference list of span ``i``."""
        lo = int(self.ref_offsets[i])
        hi = int(self.ref_offsets[i + 1])
        return [
            (self.strings[self.ref_trace[j]], self.strings[self.ref_sid[j]])
            for j in range(lo, hi)
        ]

    def processes_by_trace(self) -> Dict[int, Dict[str, str]]:
        """Each trace's process table (pid -> service), by trace index."""
        out: Dict[int, Dict[str, str]] = {}
        for t, pid, svc in zip(self.proc_trace, self.proc_pid,
                               self.proc_service):
            out.setdefault(int(t), {})[self.strings[pid]] = self.strings[svc]
        return out

    def close(self) -> None:
        """Kept for the JAX module's interface; the arrays own their memory."""


def last_error() -> str:
    """The message of the calling thread's last failed parse."""
    return get_lib().tw_last_error().decode("utf-8", "replace")


def parse_files(paths: Sequence[str]) -> NativeCorpus:
    """Parse Jaeger-JSON files into one :class:`NativeCorpus`; raises
    :class:`NativeLoaderError` with :func:`last_error` when a file cannot
    be read, is not JSON, or has no ``data`` array."""
    lib = get_lib()
    if not paths:
        raise ValueError("parse_files: no paths")
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    handle = lib.tw_parse_files(arr, len(paths))
    if not handle:
        raise NativeLoaderError(
            f"native parse of {len(paths)} file(s) failed: {last_error()}")
    return NativeCorpus(lib, handle, len(paths))


def root_start_time(path: str) -> float:
    """Root-span start time of a trace file (+inf when it has no rooted
    span or cannot be parsed)."""
    return get_lib().tw_root_start_time(os.fsencode(path))
