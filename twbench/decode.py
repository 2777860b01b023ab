"""The reference's own decode: its K1 answers turned into span ids, per
service, from the raw spans, and compared with the program's decoded
answers (``decode_diff``).

The program chooses how a service's incoming spans are cut into windows
(a tiling, as a kernel chooses its blocks); everything else is worked out
again here from the service's raw partitions:

- a service's rows are its incoming spans sorted by ``(start, end)``, and
  each window ``[lo, hi)`` of the program's tiling is a run of them;
- a window's columns on an endpoint are that endpoint's outgoing spans,
  stably sorted by start, that start within ``[first start, latest end]``
  of the window (``traceweaver_tpu_torch/algorithms/weaver_torch.py
  candidate_ranges``, lines 560-574);
- times are ``float32(t - origin)``, the origin the window's first start.

Each launch row of the checked round is found by its content (the
window's row and column times), so the reference's answers for that row
(:mod:`twbench.checks`) land on the window's span ids whatever the
program's batch layout. Column ``M`` (the launch's padded width) is SKIP,
a column past the window's own spans or below 0 is NA. A service's
answers are then put together as ``WeaverTorch._decode`` and
``_resolve_cross_window_duplicates`` (lines 1217-1296) define it: the
chosen span first in its top-k, and across windows the earliest incoming
span keeps a contested outgoing span, the others taking their best free
top-k alternative, SKIP while the endpoint's budget (incoming spans less
outgoing spans) has room, else NA.

A row with no column (an endpoint a window has no candidate for, or a
padded endpoint the service does not have) answers alike whichever window
it stands for, so its answers go to every window with its key. A row with
columns that no window of this round matches, or a service with no
window, counts every answer it should have given as differing.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from twbench.reference import NA, SKIP

#: the reference's answer where no launch row of the round was matched
MISSING = ("missing", "missing")


def _sid(s) -> Tuple[str, str]:
    return (s.trace_id, s.sid)


def _rel(x: np.ndarray, origin: float) -> bytes:
    return (x - origin).astype(np.float32).tobytes()


class Service:
    """One service's rows and columns, sorted from its raw spans."""

    def __init__(self, item):
        (_, spans), = item.in_span_partitions.items()
        ins = sorted(spans, key=lambda s: (s.start_mus, s.start_mus + s.duration_mus))
        self.in_ids = [_sid(s) for s in ins]
        self.in_start = np.array([float(s.start_mus) for s in ins], dtype=np.float64)
        self.in_end = self.in_start + np.array([float(s.duration_mus) for s in ins],
                                               dtype=np.float64)
        self.eps: Dict[str, Tuple[list, np.ndarray, np.ndarray]] = {}
        for ep, outs in item.out_span_partitions.items():
            outs = sorted(outs, key=lambda s: float(s.start_mus))
            start = np.array([float(s.start_mus) for s in outs], dtype=np.float64)
            end = start + np.array([float(s.duration_mus) for s in outs], dtype=np.float64)
            self.eps[ep] = ([_sid(s) for s in outs], start, end)
        self.windows: List[Tuple[int, int]] = []

    def columns(self, ep: str, lo: int, hi: int) -> Tuple[int, int]:
        _, start, _ = self.eps[ep]
        t0, t1 = self.in_start[lo], float(self.in_end[lo:hi].max())
        return (int(np.searchsorted(start, t0, side="left")),
                int(np.searchsorted(start, t1, side="right")))

    def key(self, ep: str, lo: int, hi: int) -> tuple:
        c0, c1 = self.columns(ep, lo, hi)
        _, start, end = self.eps[ep]
        o = self.in_start[lo]
        return (_rel(self.in_start[lo:hi], o), _rel(self.in_end[lo:hi], o),
                _rel(start[c0:c1], o), _rel(end[c0:c1], o))


class DecodeCheck:
    """The windows each service was cut into in the checked round, the
    reference's answers for each, and their decode."""

    def __init__(self, items):
        self.items = items
        self._owner: Dict[int, int] = {}
        for k, item in enumerate(items):
            (_, spans), = item.in_span_partitions.items()
            for s in spans:
                self._owner[id(s)] = k
        self._services: Dict[int, Service] = {}
        #: content key -> the (service, endpoint, lo, hi) windows it names
        self._targets: Dict[tuple, List[Tuple[int, str, int, int]]] = {}
        self._seen: Dict[tuple, int] = {}
        #: (service, endpoint, lo) -> (answers, top-k, launch width M)
        self.answers: Dict[Tuple[int, str, int], Tuple[np.ndarray, np.ndarray, int]] = {}
        self.rows_unmatched = 0
        self.keys_shared = 0
        self._lock = threading.Lock()

    # -- what the program packed ------------------------------------------------

    def packed(self, in_spans, windows) -> None:
        """A service's tiling, from a call of the program's packer: the
        service is found by its incoming spans, the windows by index."""
        if not in_spans or not windows:
            return
        k = self._owner.get(id(in_spans[0]))
        if k is None:
            return
        with self._lock:
            svc = self._services.get(k)
            if svc is None:
                svc = self._services[k] = Service(self.items[k])
            known = set(svc.windows)
            for lo, hi in windows:
                if (lo, hi) in known:
                    continue
                known.add((lo, hi))
                svc.windows.append((lo, hi))
                for ep in svc.eps:
                    ts = self._targets.setdefault(svc.key(ep, lo, hi), [])
                    if ts:
                        self.keys_shared += 1
                    ts.append((k, ep, lo, hi))

    # -- what each launch answered ------------------------------------------------

    def rows(self, in_s, in_e, in_v, o_s, o_e, o_v) -> List[Optional[list]]:
        """The windows each row of one endpoint step's launch stands for
        (None for an empty row)."""
        in_s, in_e, in_v, o_s, o_e, o_v = (t.detach().cpu().numpy()
                                           for t in (in_s, in_e, in_v, o_s, o_e, o_v))
        out: List[Optional[tuple]] = []
        with self._lock:
            for b in range(in_v.shape[0]):
                n, m = int(in_v[b].sum()), int(o_v[b].sum())
                if n == 0:
                    out.append(None)
                    continue
                key = (in_s[b, :n].tobytes(), in_e[b, :n].tobytes(),
                       o_s[b, :m].tobytes(), o_e[b, :m].tobytes())
                ts = self._targets.get(key)
                if m == 0:
                    out.append(ts)
                    continue
                if not in_v[b, :n].all() or not o_v[b, :m].all() or not ts:
                    self.rows_unmatched += 1
                    out.append(None)
                    continue
                i = self._seen.get(key, 0)
                self._seen[key] = i + 1
                out.append([ts[i % len(ts)]])
        return out

    def answered(self, targets, a_r, tk_r, M: int) -> None:
        """The reference's answers ``a_r [B, n_rows]`` and top-k
        ``tk_r [B, n_rows, K]`` of one launch; a later launch of the same
        window (a later sweep or pass) replaces an earlier one."""
        a_r = a_r.detach().cpu().numpy()
        tk_r = tk_r.detach().cpu().numpy()
        with self._lock:
            for b, ts in enumerate(targets):
                for k, ep, lo, hi in ts or ():
                    self.answers[(k, ep, lo)] = (a_r[b, :hi - lo].copy(),
                                                 tk_r[b, :hi - lo].copy(), M)

    # -- the decode and the comparison ---------------------------------------------

    def decoded(self, k: int) -> Dict[str, Dict]:
        """Service ``k``'s answers by the reference, span id to span id
        per endpoint."""
        svc = self._services[k]
        n_in = len(svc.in_ids)
        assign: Dict[str, Dict] = {}
        for ep, (out_ids, _, _) in svc.eps.items():
            amap, tmap = {}, {}
            for lo, hi in sorted(svc.windows):
                got = self.answers.get((k, ep, lo))
                if got is None:
                    for in_id in svc.in_ids[lo:hi]:
                        amap[in_id], tmap[in_id] = MISSING, [MISSING]
                    continue
                cols, tk, M = got
                c0, c1 = svc.columns(ep, lo, hi)

                def span(j: int):
                    if j == M:
                        return SKIP
                    return out_ids[c0 + j] if 0 <= j < c1 - c0 else NA

                for i in range(hi - lo):
                    in_id = svc.in_ids[lo + i]
                    out_id = span(int(cols[i]))
                    tks = [span(int(j)) for j in tk[i]]
                    if out_id in tks:
                        tks.remove(out_id)
                    amap[in_id] = out_id
                    tmap[in_id] = [out_id] + tks[:len(tk[i]) - 1]
            _resolve_duplicates(amap, tmap, svc.in_ids, n_in - len(out_ids))
            assign[ep] = amap
        return assign

    def compare(self, program: List[Optional[Dict]]) -> Tuple[int, int, int]:
        """``(answers that differ, answers, services with no window)`` of
        the program's decoded answers (``program[k]``, endpoint to span id
        to span id) against the reference's."""
        diff = total = unchecked = 0
        for k, item in enumerate(self.items):
            (_, spans), = item.in_span_partitions.items()
            eps = list(item.out_span_partitions)
            n = len(spans) * len(eps)
            total += n
            if k not in self._services:
                unchecked += 1
                diff += n
                continue
            ref = self.decoded(k)
            got = program[k] or {}
            for ep in eps:
                mine = got.get(ep, {})
                for in_id, out_id in ref[ep].items():
                    if mine.get(in_id, MISSING) != out_id or out_id == MISSING:
                        diff += 1
        return diff, total, unchecked


def _resolve_duplicates(amap: Dict, tmap: Dict, in_ids: List, budget: int) -> None:
    claims: Dict = {}
    skips = 0
    for in_id in in_ids:
        out_id = amap.get(in_id)
        if out_id == SKIP:
            skips += 1
        elif out_id is not None and out_id not in (NA, MISSING):
            claims.setdefault(out_id, []).append(in_id)
    used = set(claims)
    for out_id, claimants in claims.items():
        for in_id in claimants[1:]:
            repl = NA
            for cand in tmap.get(in_id, []):
                if cand == SKIP:
                    if skips < budget:
                        repl = SKIP
                        skips += 1
                        break
                    continue
                if cand not in (NA, MISSING) and cand not in used:
                    repl = cand
                    break
            amap[in_id] = repl
            if repl not in (NA, SKIP):
                used.add(repl)
            tk = tmap.get(in_id)
            if tk and repl in tk:
                tk.remove(repl)
                tk.insert(0, repl)
