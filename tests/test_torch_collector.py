"""The port's offline collector pipeline against the JAX package's
(``tests/test_collector.py``): the HPACK codec on RFC 7541's appendix C
vectors, HTTP/2 replay, strace reassembly, thread attribution and the
thread-predictability fit, end to end on the capture workload's logs and
on a many-thread capture, the eBPF event replay, and the strace runner
(skipped without ``strace``, as in the JAX package). Everything runs on
the CPU; nothing here needs the card."""

import ctypes
import dataclasses
import os
import random
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from traceweaver_tpu_torch import collector as tc  # noqa: E402
from traceweaver_tpu_torch.collector import ebpf as t_ebpf  # noqa: E402
from traceweaver_tpu_torch.collector import hpack as t_hpack  # noqa: E402
from traceweaver_tpu_torch.synth.capture import capture_workload  # noqa: E402

#: RFC 7541 appendix C: (section, table size, [(block hex, headers)])
RFC7541_C = [
    ("C.3", 4096, [
        ("828684410f7777772e6578616d706c652e636f6d",
         [(":method", "GET"), (":scheme", "http"), (":path", "/"),
          (":authority", "www.example.com")]),
        ("828684be58086e6f2d6361636865",
         [(":method", "GET"), (":scheme", "http"), (":path", "/"),
          (":authority", "www.example.com"), ("cache-control", "no-cache")]),
        ("828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565",
         [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
          (":authority", "www.example.com"), ("custom-key", "custom-value")]),
    ]),
    ("C.4", 4096, [
        ("828684418cf1e3c2e5f23a6ba0ab90f4ff", None),
        ("828684be5886a8eb10649cbf", None),
        ("828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf", None),
    ]),
    ("C.5", 256, [
        ("4803333032580770726976617465611d4d6f6e2c203231204f637420323031332032"
         "303a31333a323120474d546e1768747470733a2f2f7777772e6578616d706c652e63"
         "6f6d",
         [(":status", "302"), ("cache-control", "private"),
          ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
          ("location", "https://www.example.com")]),
        ("4803333037c1c0bf",
         [(":status", "307"), ("cache-control", "private"),
          ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
          ("location", "https://www.example.com")]),
        ("88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d54c0"
         "5a04677a69707738666f6f3d4153444a4b48514b425a584f5157454f50495541585157"
         "454f49553b206d61782d6167653d333630303b2076657273696f6e3d31",
         [(":status", "200"), ("cache-control", "private"),
          ("date", "Mon, 21 Oct 2013 20:13:22 GMT"),
          ("location", "https://www.example.com"), ("content-encoding", "gzip"),
          ("set-cookie", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")]),
    ]),
    ("C.6", 256, [
        ("488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62d1b"
         "ff6e919d29ad171863c78f0b97c8e9ae82ae43d3", None),
        ("4883640effc1c0bf", None),
        ("88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab77ad"
         "94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f958731606"
         "5c003ed4ee5b1063d5007", None),
    ]),
]
# the Huffman sections decode to their raw twins' headers
RFC7541_C[1] = ("C.4", 4096, [(h, RFC7541_C[0][2][i][1])
                              for i, (h, _) in enumerate(RFC7541_C[1][2])])
RFC7541_C[3] = ("C.6", 256, [(h, RFC7541_C[2][2][i][1])
                             for i, (h, _) in enumerate(RFC7541_C[3][2])])


def _jax():
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    import traceweaver_tpu.collector as jc

    return jc


@pytest.mark.parametrize("section,table,blocks", RFC7541_C, ids=[c[0] for c in RFC7541_C])
def test_rfc7541_appendix_c_through_both_decoders(section, table, blocks):
    """Each section is one decoder's sequence: the dynamic table carries
    from block to block (and, at 256 bytes, evicts)."""
    jc = _jax()
    td, jd = tc.Decoder(table), jc.Decoder(table)
    for hexblock, want in blocks:
        raw = bytes.fromhex(hexblock)
        got = td.decode(raw)
        assert got == want
        assert got == jd.decode(raw)
    assert td.table.size == jd.table.size


@pytest.mark.parametrize("huffman", [False, True])
def test_encoder_output_equals_jax(huffman):
    jc = _jax()
    rng = random.Random(3)
    te, je = tc.Encoder(huffman=huffman), jc.Encoder(huffman=huffman)
    for _ in range(40):
        headers = [(":path", "/%d" % rng.randrange(50)),
                   ("x-k%d" % rng.randrange(8), "v" * rng.randrange(1, 40)),
                   ("uber-trace-id", "t%04d:1:0:1" % rng.randrange(9999))]
        assert te.encode(headers) == je.encode(headers)
    for value, prefix in [(0, 1), (10, 5), (1337, 5), (2 ** 30, 7)]:
        assert t_hpack.encode_integer(value, prefix) == bytes(
            _jax_hpack().encode_integer(value, prefix))
    data = bytes(range(256)) * 2
    assert t_hpack.huffman_decode(t_hpack.huffman_encode(data)) == data


def _jax_hpack():
    _jax()
    from traceweaver_tpu.collector import hpack

    return hpack


def _plain(obj):
    """Dataclasses (of either package) as plain nested data."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _report(report):
    return dict(
        streams=_plain(report.streams),
        events=_plain(report.events_by_stream),
        requests=_plain(report.requests),
        pairs=_plain(report.causal_pairs),
        predictability=report.thread_predictability)


@pytest.mark.parametrize("source", ["frontend", "search"])
def test_collect_from_strace_log_equals_jax_on_the_capture_workload(source):
    import bench

    logs = capture_workload(40)
    assert logs == bench._capture_workload(40)
    jc = _jax()
    got = _report(tc.collect_from_strace_log(logs[source]))
    want = _report(jc.collect_from_strace_log(logs[source]))
    for key in got:
        assert got[key] == want[key], key
    assert got["streams"] and got["requests"]


def _threaded_capture(seed: int, n: int = 60) -> str:
    """A server whose incoming requests (fd 7) are handled by a pool of
    threads and whose downstream calls (fd 9) leave from a pool too, so
    the downstream thread is partly predictable from the upstream one."""
    from tests.test_collector import _client_request_bytes, _frame, _strace_lines_for

    from traceweaver_tpu.collector.http2 import PREFACE, SETTINGS

    rng = random.Random(seed)
    enc_in, enc_down = tc.Encoder(), tc.Encoder(huffman=True)
    lines = []
    lines += _strace_lines_for(100, "read", 7, PREFACE + _frame(SETTINGS, 0, 0, b""))
    lines += _strace_lines_for(200, "write", 9, PREFACE + _frame(SETTINGS, 0, 0, b""))
    for i in range(n):
        up = 101 + rng.randrange(4)
        down = 201 + (up - 101) % 3 if rng.random() < 0.7 else 201 + rng.randrange(3)
        key = "trace-%03d" % i
        lines += _strace_lines_for(up, "read", 7,
                                   _client_request_bytes(enc_in, 2 * i + 1, "/a", key),
                                   split_at=1 if i % 7 == 0 else None)
        lines += _strace_lines_for(down, "write", 9,
                                   _client_request_bytes(enc_down, 2 * i + 1, "/b", key))
    return "\n".join(lines)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_thread_predictability_equals_jax_on_threaded_captures(seed):
    """The port fits the JAX package's scikit-learn regression with scipy
    (the card's machine has no scikit-learn): same score."""
    jc = _jax()
    text = _threaded_capture(seed)
    got, want = tc.collect_from_strace_log(text), jc.collect_from_strace_log(text)
    assert _report(got) == _report(want)
    assert got.thread_predictability is not None and 0 < got.thread_predictability < 1


def _ebpf_events(log: str):
    """The capture log re-expressed as recorded perf-buffer events: each
    payload chunk the strace parser reassembles becomes one
    ``DataEvent``, serialised and parsed back as a recording replays."""
    events = []
    parser = tc.StraceParser()

    def on_payload(key, direction, payload, ts_us):
        for off in range(0, len(payload), t_ebpf.CHUNK_SIZE):
            chunk = payload[off:off + t_ebpf.CHUNK_SIZE]
            # strace stamps are whole microseconds
            ev = t_ebpf.DataEvent(ts_ns=int(round(ts_us)) * 1000, pid=1, tid=1,
                                  fd=key[0], op=0 if direction == "in" else 1,
                                  chunk=off // t_ebpf.CHUNK_SIZE, len=len(chunk),
                                  ret=len(payload))
            ctypes.memmove(ctypes.addressof(ev) + t_ebpf.DataEvent.buf.offset,
                           chunk, len(chunk))
            events.append(ctypes.string_at(ctypes.addressof(ev), ctypes.sizeof(ev)))
        return True

    parser.payload_hook = on_payload
    for line in log.splitlines():
        parser.feed_line(line)
    return events


def test_ebpf_replay_of_recorded_events_equals_the_strace_replay():
    """Recorded perf-buffer events of the capture replay into the same
    span events as its strace logs, in the port and in the JAX package.
    The JAX package's eBPF replay reads the event's ``char`` array field,
    which ``ctypes`` cuts at the first NUL, so it recovers no exchange;
    the port reads the structure's memory (``source._event_payload``)."""
    from tests.test_torch_capture import event_keys

    _jax()
    from traceweaver_tpu.collector import ebpf as j_ebpf
    from traceweaver_tpu.collector.source import CollectorSource as JSource

    from traceweaver_tpu_torch.collector.source import CollectorSource as TSource

    logs = capture_workload(12, churn_at=99)
    raw = {name: _ebpf_events(text) for name, text in logs.items()}
    t_src = TSource({}, ebpf_events={n: [t_ebpf.parse_event(r) for r in rs]
                                     for n, rs in raw.items()})
    want = JSource(logs)
    assert len(t_src) == 36
    assert event_keys(t_src) == event_keys(want)
    assert t_src.capture_quality() == want.capture_quality()
    j_src = JSource({}, ebpf_events={n: [j_ebpf.parse_event(r) for r in rs]
                                     for n, rs in raw.items()})
    assert len(j_src) == 0
    # the program text and the event mirror are the JAX package's
    assert t_ebpf.BPF_PROGRAM == j_ebpf.BPF_PROGRAM
    assert ctypes.sizeof(t_ebpf.DataEvent) == ctypes.sizeof(j_ebpf.DataEvent)


def test_ebpf_live_capture_gated_on_bcc():
    if t_ebpf.bcc_available():
        pytest.skip("bcc is installed here")
    with pytest.raises(RuntimeError, match="bcc"):
        t_ebpf.run_capture(lambda ev: None)


@pytest.mark.skipif(shutil.which("strace") is None, reason="no strace binary")
def test_strace_runner_runs_with_strace(tmp_path):
    from traceweaver_tpu_torch.collector import strace_runner

    assert strace_runner.run("no-such-process-tw", out_dir=str(tmp_path),
                             duration=0.3) == {}


def test_strace_runner_gated_on_the_strace_binary(tmp_path, monkeypatch):
    from traceweaver_tpu_torch.collector import strace_runner

    monkeypatch.setattr(strace_runner.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="strace"):
        strace_runner.run("search", out_dir=str(tmp_path), duration=0.1)


def test_strace_runner_attaches_to_new_pids(tmp_path, monkeypatch):
    """The JAX package's test of the polling, on the port's runner (the
    attach itself stubbed): once per new PID, the same log names."""
    from traceweaver_tpu_torch.collector import strace_runner

    pids_by_poll = iter([[101], [101, 202], [101, 202]])
    attached = []

    class FakeProc:
        def poll(self):
            return 0

        def terminate(self):
            pass

    monkeypatch.setattr(strace_runner, "pgrep",
                        lambda name: next(pids_by_poll, [101, 202]))
    monkeypatch.setattr(strace_runner.shutil, "which", lambda _: "/usr/bin/strace")
    monkeypatch.setattr(strace_runner, "attach_strace",
                        lambda pid, out_path, string_limit=65536:
                        attached.append((pid, out_path)) or FakeProc())
    seen = strace_runner.run("search", out_dir=str(tmp_path), tag="7",
                             duration=0.3, poll_interval=0.01, max_attempts=2)
    assert sorted(seen) == [101, 202]
    assert [p for p, _ in attached] == [101, 202]
    assert all("output7-attempt" in path for _, path in attached)
