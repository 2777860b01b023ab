"""The port's write-ahead ingest log (``traceweaver_tpu_torch/stream/wal.py``)
against the JAX package's.

- frames: the port's bytes equal the JAX package's for the same records
  (either reads the other's log), round trip, a torn tail truncated at
  every byte boundary of the last frame, mid-frame corruption;
- segments: rotation, low-water truncation, replay across segments, the
  transfer helpers;
- the service: a tenant killed after its acks and before the covering
  checkpoint emits, after replay, the uncrashed run's bytes (the JAX
  package's too); one killed before its first checkpoint recovers from
  the log alone; client-seq dedup, live and across a crash; ``wal=False``
  writes no log;
- the ``wal`` fault site tears half a frame and never acks;
- ``X-TW-Seq`` over HTTP: echo, dedup, 400 on a non-integer.
"""

import os
import threading

import pytest

from tests.test_torch_serve import cfg, hotel_payload, http, raw
from traceweaver_tpu_torch.runtime import faults
from traceweaver_tpu_torch.serve import TenantService, make_server
from traceweaver_tpu_torch.stream import wal as walmod


def test_frame_bytes_equal_jax_and_round_trip():
    from traceweaver_tpu.stream import wal as jwal

    payloads = [b"alpha", b"", b"x" * 300]
    rawb = b"".join(walmod.pack_frame(i + 1, p) for i, p in enumerate(payloads))
    assert rawb == b"".join(jwal.pack_frame(i + 1, p) for i, p in enumerate(payloads))
    frames, valid_end = walmod.scan_frames(rawb)
    assert valid_end == len(rawb)
    assert [(seq, p) for _, seq, p in frames] == [(1, b"alpha"), (2, b""), (3, b"x" * 300)]
    assert jwal.scan_frames(rawb) == walmod.scan_frames(rawb)


def test_each_package_replays_the_others_log(tmp_path):
    from traceweaver_tpu.stream import wal as jwal

    jw = jwal.WriteAheadLog(str(tmp_path / "j"), segment_bytes=64)
    for i in range(5):
        jw.append(b"jax-%d" % i)
    jw.close()
    assert [p for _, p in walmod.WriteAheadLog(str(tmp_path / "j")).replay(0)] == [
        b"jax-%d" % i for i in range(5)]
    pw = walmod.WriteAheadLog(str(tmp_path / "p"), segment_bytes=64)
    for i in range(5):
        pw.append(b"port-%d" % i)
    pw.close()
    assert [p for _, p in jwal.WriteAheadLog(str(tmp_path / "p")).replay(2)] == [
        b"port-%d" % i for i in range(2, 5)]


def test_torn_tail_truncated_at_every_byte_boundary(tmp_path):
    payloads = [b"one", b"two", b"payload-three"]
    full = b"".join(walmod.pack_frame(i + 1, p) for i, p in enumerate(payloads))
    keep = len(b"".join(walmod.pack_frame(i + 1, p) for i, p in enumerate(payloads[:2])))
    for cut in range(keep + 1, len(full)):
        frames, valid_end = walmod.scan_frames(full[:cut])
        assert valid_end == keep and [s for _, s, _ in frames] == [1, 2], cut
        d = tmp_path / f"cut{cut}"
        d.mkdir()
        seg = d / walmod.segment_name(1)
        seg.write_bytes(full[:cut])
        w = walmod.WriteAheadLog(str(d))
        assert w.torn_tails == 1 and w.torn_bytes == cut - keep and w.last_seq == 2
        assert seg.stat().st_size == keep
        assert w.append(payloads[2]) == 3
        w.close()
        assert seg.read_bytes() == full
    d = tmp_path / "clean"
    d.mkdir()
    (d / walmod.segment_name(1)).write_bytes(full[:keep])
    w = walmod.WriteAheadLog(str(d))
    assert w.torn_tails == 0 and w.last_seq == 2
    w.close()


def test_mid_frame_corruption_ends_the_valid_prefix():
    full = b"".join(walmod.pack_frame(i + 1, b"p%d" % i) for i in range(3))
    keep = len(full) - len(walmod.pack_frame(3, b"p2"))
    rotten = bytearray(full)
    rotten[-1] ^= 0xFF
    frames, valid_end = walmod.scan_frames(bytes(rotten))
    assert valid_end == keep and [s for _, s, _ in frames] == [1, 2]


def test_segment_rotation_truncation_and_replay(tmp_path):
    d = str(tmp_path / "wal")
    w = walmod.WriteAheadLog(d, segment_bytes=64)
    for i in range(10):
        assert w.append(b"payload-%02d" % i) == i + 1
    segs = walmod.list_segments(d)
    assert len(segs) >= 3
    assert [p for _, p in w.replay(0)] == [b"payload-%02d" % i for i in range(10)]
    assert [s for s, _ in w.replay(7)] == [8, 9, 10]
    assert w.truncate_below(w.last_seq) == len(segs) - 1
    assert walmod.list_segments(d) == [segs[-1]]
    w.close()
    with pytest.raises(ValueError):
        walmod.WriteAheadLog(d, sync="sometimes")


def test_transfer_roundtrip_with_torn_tail(tmp_path):
    src = str(tmp_path / "src")
    w = walmod.WriteAheadLog(src, segment_bytes=64)
    for i in range(6):
        w.append(b"rec-%d" % i)
    w.close()
    torn = walmod.pack_frame(7, b"torn-in-transfer")
    dst = str(tmp_path / "dst")
    assert walmod.install_bytes(dst, walmod.read_all_bytes(src) + torn[:len(torn) // 2]) == 6
    assert [p for _, p in walmod.WriteAheadLog(dst).replay(0)] == [
        b"rec-%d" % i for i in range(6)]
    assert walmod.install_bytes(str(tmp_path / "empty"), b"junk") == 0


def _post(svc, tid, payload, seq):
    body = raw(payload)
    return svc.wal_ingest(tid, body, raw=body, client_seq=seq)


def _sink(state, tid):
    with open(os.path.join(state, tid, "traces.jsonl"), "rb") as f:
        return f.read()


def test_replay_after_hard_death_emits_identical_bytes(tmp_path):
    chunk1 = hotel_payload(prefix="a")
    chunk2 = hotel_payload(prefix="b", base_us=200e6)
    clean = str(tmp_path / "clean")
    svc = TenantService(cfg(state_dir=clean), device="cpu")
    assert _post(svc, "ten", chunk1, 1)["ingested_traces"] == 24
    assert _post(svc, "ten", chunk2, 2)["ingested_traces"] == 24
    svc.flush()
    svc.drain()
    want = _sink(clean, "ten")
    assert want

    crash = str(tmp_path / "crash")
    svc = TenantService(cfg(state_dir=crash), device="cpu")
    _post(svc, "ten", chunk1, 1)
    assert svc.tenant("ten").checkpoint() is True
    out = _post(svc, "ten", chunk2, 2)
    assert out["ingested_traces"] == 24 and out["seq"] == 2
    del svc  # a kill: no drain, no checkpoint
    resumed = TenantService.resume(cfg(state_dir=crash), device="cpu")
    assert resumed.tenant("ten").counters.get("wal_replayed") == 1
    resumed.flush()
    resumed.drain()
    assert _sink(crash, "ten") == want

    # the JAX package's service emits the same bytes for the same posts
    import traceweaver_tpu.runtime.executor  # noqa: F401 (the ingest cycle)
    from traceweaver_tpu import serve as jserve

    jstate = str(tmp_path / "jax")
    js = jserve.TenantService(jserve.ServeConfig(
        fix=2, window_us=60e6, overlap_us=5e6, ooo_bound_us=1e6, verbose=False,
        pump_windows=10**9, state_dir=jstate))
    for k, chunk in enumerate((chunk1, chunk2)):
        js.wal_ingest("ten", raw(chunk), raw=raw(chunk), client_seq=k + 1)
    js.flush()
    js.drain()
    assert _sink(jstate, "ten") == want


def test_recover_before_first_checkpoint_replays_everything(tmp_path):
    state = str(tmp_path / "s")
    svc = TenantService(cfg(state_dir=state), device="cpu")
    _post(svc, "ten", hotel_payload(prefix="a"), 1)
    del svc
    resumed = TenantService.resume(cfg(state_dir=state), device="cpu")
    t = resumed.tenant("ten", create=False)
    assert t.counters.get("wal_replayed") == 1
    resumed.flush()
    resumed.drain()
    assert _sink(state, "ten")


def test_client_seq_dedup_on_retry_and_across_crash(tmp_path):
    state = str(tmp_path / "s")
    svc = TenantService(cfg(state_dir=state), device="cpu")
    payload = hotel_payload(prefix="a")
    first = _post(svc, "ten", payload, 41)
    assert first["ingested_traces"] == 24 and first["seq"] == 41
    retry = _post(svc, "ten", payload, 41)
    assert retry["deduped"] is True and retry["ingested_traces"] == 24
    t = svc.tenant("ten")
    assert t.wal.stats()["appended"] == 1 and t.counters["wal_deduped"] == 1
    del svc
    resumed = TenantService.resume(cfg(state_dir=state), device="cpu")
    assert _post(resumed, "ten", payload, 41)["deduped"] is True
    resumed.flush()
    resumed.drain()
    assert _sink(state, "ten").count(b"\n") == 1


def test_wal_off_writes_no_log(tmp_path):
    state = str(tmp_path / "s")
    svc = TenantService(cfg(state_dir=state, wal=False), device="cpu")
    assert svc.ingest("ten", raw(hotel_payload()))["ingested_traces"] == 24
    svc.flush()
    assert not os.path.isdir(os.path.join(state, "ten", "wal"))
    assert svc.stats()["tenants"]["ten"]["wal"] is None
    svc.drain()


def test_faulted_append_tears_the_frame_and_never_acks(tmp_path):
    d = str(tmp_path / "wal")
    w = walmod.WriteAheadLog(d)
    w.append(b"good-1")
    with faults.override("wal:1.0:max=1"):
        with pytest.raises(faults.FaultError):
            w.append(b"never-acked")
    assert w.append(b"good-2") == 2
    w.close()
    assert [p for _, p in walmod.WriteAheadLog(d).replay(0)] == [b"good-1", b"good-2"]
    assert faults.SITES.count("wal") == 1


def test_faulted_append_torn_on_disk_when_process_dies(tmp_path):
    d = str(tmp_path / "wal")
    w = walmod.WriteAheadLog(d)
    w.append(b"good-1")
    with faults.override("wal:1.0:max=1"):
        with pytest.raises(faults.FaultError):
            w.append(b"never-acked")
    del w
    r = walmod.WriteAheadLog(d)
    assert r.torn_tails == 1 and r.last_seq == 1
    assert [p for _, p in r.replay(0)] == [b"good-1"]
    r.close()


def test_faulted_service_append_answers_no_ack(tmp_path):
    """Through the service: the faulted POST raises (the HTTP layer's
    500, no ack) and ingests nothing; the client's retry lands."""
    svc = TenantService(cfg(state_dir=str(tmp_path / "s")), device="cpu")
    with faults.override("wal:1.0:max=1"):
        with pytest.raises(faults.FaultError):
            _post(svc, "ten", hotel_payload(), 5)
    assert svc.tenant("ten").svc.consumed == 0
    assert _post(svc, "ten", hotel_payload(), 5)["ingested_traces"] == 24
    svc.drain()


def test_http_seq_echo_and_dedup(tmp_path):
    svc = TenantService(cfg(state_dir=str(tmp_path / "s")), device="cpu")
    server = make_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.port}/api/v1/tenants/ten/spans"
    try:
        code, out, _ = http("POST", url, hotel_payload(), headers={"X-TW-Seq": "7"})
        assert code == 200 and out["seq"] == 7 and out["ingested_traces"] == 24
        code, out, _ = http("POST", url, hotel_payload(), headers={"X-TW-Seq": "7"})
        assert code == 200 and out.get("deduped") is True and out["ingested_traces"] == 24
        st = svc.stats()
        assert st["tenants"]["ten"]["wal"]["appended"] == 1
        assert st["tenants"]["ten"]["counters"]["wal_deduped"] == 1
        code, out, _ = http("POST", url, hotel_payload(prefix="b", base_us=200e6))
        assert code == 200 and "seq" not in out
        code, out, _ = http("POST", url, hotel_payload(),
                            headers={"X-TW-Seq": "not-a-number"})
        assert code == 400 and "X-TW-Seq" in out["error"]
    finally:
        server.shutdown()
        server.server_close()
    svc.drain()
