"""The port's lint rules: its ground rules and cross-cutting contracts,
mechanized (mirrors ``traceweaver_tpu/analysis/rules.py``).

A rule keeps the JAX rule's id where the contract carries over, so a
reader finds its counterpart; the port's own ground rules take ids of
their own (TW1xx). The rules are narrow: each matches the concrete
hazard, so a finding is actionable and a clean run means the contract
holds.

- TW003 host sync         — device-to-host conversions in the hot modules
  only at the ledgered fetch (``fleet._fetch``)
- TW004 pow2 bucketing    — never re-implemented inline
- TW005 lock discipline   — attributes guarded by a class's lock are
  guarded everywhere
- TW006 precision         — no accumulation over a bf16 tensor in ``ops/``
  without an f32 accumulator
- TW007 metric discipline — counters in fleet/stream/serve grow only
  through the obs-mirrored accumulators
- TW008 channel layout    — packed-block channel indices come from
  ``packed_layout.py`` only
- TW009 devcols residency — ring-resident columns reach the host only
  through the ledgered fetch
- TW010 adapt ledger      — adaptation actuations go through the
  controller's evented ledger
- TW012 ticket discipline — per-tenant ``in_flight`` mutates only inside
  the ticket lifecycle
- TW013 ack discipline    — a 2xx ack on the serve ingest paths is
  WAL-ledgered or guarded by the tenant's ``wal`` setting
- TW101 no knob reads     — the port reads no ``TW_*`` environment variable
- TW102 no JAX            — the port imports neither JAX, nor networkx or
  sklearn, nor any module of ``traceweaver_tpu``
- TW103 no gate           — no ``torch.cuda.is_available()`` gate and no
  fallback to a plain version from an ``except`` in ``ops/``
- TW111 launch discipline — ``nvcc`` and ``ctypes.CDLL`` only in the
  build module and the library loaders; kernel-library calls in
  ``ops/cuda_sinkhorn.py`` only under ``_launch_lock``

The JAX package's TW001/TW002 (its knob registry), TW004's jit half and
TW011 (ahead-of-time compiles) have no counterpart: the port has no
knobs, no jit and nothing compiled ahead of time.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from traceweaver_tpu_torch.analysis.engine import Finding, Module

ROOT = "traceweaver_tpu_torch/"

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> str:
    """Dotted name of an expression (``os.environ.get``), ``""`` when it
    is not a plain name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _tw_name(node: ast.AST) -> Optional[str]:
    s = const_str(node)
    return s if s is not None and s.startswith("TW_") else None


def outer_functions(tree: ast.AST) -> List[ast.FunctionDef]:
    """FunctionDefs not nested inside another function (methods count;
    their nested helpers are visited through the outer def)."""
    out: List[ast.FunctionDef] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(child)
            else:
                visit(child)

    visit(tree)
    return out


def target_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(target_names(elt))
        return out
    return []


def raw_env_read(node: ast.AST) -> Optional[Tuple[str, ast.AST]]:
    """(TW_* name, site) for an environment READ: ``os.environ.get``,
    ``os.getenv``, or a Load of ``os.environ[...]``. Writes
    (``os.environ[k] = v``, ``setdefault``, ``pop``) configure a child
    process and are not reads."""
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name in ("os.environ.get", "environ.get", "os.getenv", "getenv"):
            if node.args:
                tw = _tw_name(node.args[0])
                if tw:
                    return tw, node
    elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        if dotted(node.value) in ("os.environ", "environ"):
            tw = _tw_name(node.slice)
            if tw:
                return tw, node
    return None


def _path_in(mod: Module, suffixes: Sequence[str]) -> bool:
    return any(mod.path.endswith(s) for s in suffixes)


def _call_last(node: ast.Call) -> str:
    """The called name's last part: ``np.asarray`` -> ``asarray``,
    ``expr.sum()`` -> ``sum``."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return ""


# ---------------------------------------------------------------------------
# TW003 — host sync
# ---------------------------------------------------------------------------

class HostSyncHazard:
    """Device-to-host conversions in the hot modules only at the ledgered
    fetch.

    An unledgered blocking fetch stalls a flow worker without billing
    ``wait_s`` or the ``d2h_bytes_*`` ledger, so the stall never shows in
    the stats and the pipeline's overlap accounting lies. In the hot
    modules every conversion of a value a device call produced goes
    through ``fleet._fetch`` or carries a per-line justification.

    Name-level taint, per function: names bound (directly, by tuple
    unpack, loop or comprehension targets, or a container append) from
    a device producer — a ``solve_*``, ``refit_*``, ``fused_*`` or
    ``assign_*`` call, ``.cuda()``, ``.to(<device>)`` — are device
    values. ``np.asarray``/``np.array``/``float``/``int``/``bool`` over
    one, or ``.item()``/``.cpu()``/``.numpy()``/``.tolist()``/
    ``.to("cpu")`` on one, is a finding; so is ``torch.cuda.synchronize()``
    anywhere in a hot module. The helper's result is host memory,
    already billed.
    """

    id = "TW003"
    title = "unledgered device sync in a hot-path module"

    HOT = ("algorithms/fleet.py", "algorithms/weaver_torch.py",
           "stream/service.py")
    #: the ledgered helpers, allowed to convert device values
    ALLOWED_FUNCS = ("_fetch",)
    LEDGER_HINT = "fleet._fetch"
    _DEVICE_RE = re.compile(r"^(solve_|refit_|fused_|assign_)")
    _CONVERSIONS = {"np.asarray", "np.array", "numpy.asarray",
                    "numpy.array", "float", "int", "bool"}
    _METHOD_SYNCS = {"item", "cpu", "numpy", "tolist"}
    _LAUNDER = {"_fetch"}
    _SYNC_CALLS = {"torch.cuda.synchronize"}

    @classmethod
    def _device_arg(cls, node: ast.AST) -> bool:
        """Does this ``.to()`` argument name a device (not a dtype)?"""
        s = const_str(node)
        if s is not None:
            return s.startswith("cuda")
        if isinstance(node, ast.Call):
            return dotted(node.func) in ("torch.device", "device")
        last = dotted(node).split(".")[-1].lower()
        return "dev" in last and "dtype" not in last

    @classmethod
    def _to_cpu(cls, node: ast.Call) -> bool:
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr == "to" and bool(node.args)
                and const_str(node.args[0]) == "cpu")

    def _is_device_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        last = _call_last(node)
        if isinstance(node.func, ast.Attribute):
            if last == "cuda":
                return True
            if last == "to":
                if any(k.arg == "device" for k in node.keywords):
                    return True
                return bool(node.args) and self._device_arg(node.args[0])
        return bool(self._DEVICE_RE.match(last))

    def _launders(self, node: ast.Call) -> bool:
        name = dotted(node.func)
        last = _call_last(node)
        if last in self._LAUNDER or name in self._CONVERSIONS:
            return True
        return (isinstance(node.func, ast.Attribute)
                and (last in self._METHOD_SYNCS or self._to_cpu(node)))

    def _value_tainted(self, node: ast.AST, tainted: Set[str]) -> bool:
        """Does evaluating this expression yield (or contain) a device
        value? Conversions yield host values, so the walk does not
        descend into them."""
        if isinstance(node, ast.Call) and self._launders(node):
            return False
        if self._is_device_call(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in tainted
        for child in ast.iter_child_nodes(node):
            if self._value_tainted(child, tainted):
                return True
        return False

    def _collect_taints(self, fn: ast.AST) -> Set[str]:
        tainted: Set[str] = set()
        for _ in range(4):  # a small fixpoint: taint chains are short
            before = len(tainted)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    if self._value_tainted(node.value, tainted):
                        for t in node.targets:
                            tainted.update(target_names(t))
                elif isinstance(node, ast.AnnAssign) and node.value:
                    if self._value_tainted(node.value, tainted):
                        tainted.update(target_names(node.target))
                elif isinstance(node, ast.For):
                    if self._value_tainted(node.iter, tainted):
                        tainted.update(target_names(node.target))
                elif isinstance(node, ast.comprehension):
                    if self._value_tainted(node.iter, tainted):
                        tainted.update(target_names(node.target))
                elif isinstance(node, ast.Call):
                    if _call_last(node) in ("append", "extend", "insert"):
                        base = node.func.value if isinstance(
                            node.func, ast.Attribute) else None
                        if isinstance(base, ast.Name) and any(
                                self._value_tainted(a, tainted)
                                for a in node.args):
                            tainted.add(base.id)
            if len(tainted) == before:
                break
        return tainted

    def _flag(self, mod: Module, node: ast.AST, what: str) -> Finding:
        return mod.finding(
            self.id, node,
            f"{what} over a device value blocks on the card and copies "
            "to the host without billing wait_s / d2h_bytes_* — fetch "
            f"through the ledgered helper ({self.LEDGER_HINT}) or justify "
            "with a suppression")

    def _sync_call(self, node: ast.Call) -> bool:
        return dotted(node.func) in self._SYNC_CALLS

    def check_module(self, mod: Module) -> Iterable[Finding]:
        if not _path_in(mod, self.HOT):
            return []
        findings: List[Finding] = []
        for fn in outer_functions(mod.tree):
            if fn.name in self.ALLOWED_FUNCS:
                continue
            tainted = self._collect_taints(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if self._sync_call(node):
                    findings.append(mod.finding(
                        self.id, node,
                        "torch.cuda.synchronize() in a hot module waits for "
                        "the whole card without billing wait_s — fetch "
                        f"through {self.LEDGER_HINT} or justify with a "
                        "suppression"))
                    continue
                name = dotted(node.func)
                if name in self._CONVERSIONS:
                    if node.args and self._value_tainted(node.args[0],
                                                         tainted):
                        findings.append(self._flag(mod, node, f"{name}()"))
                elif (isinstance(node.func, ast.Attribute)
                        and (node.func.attr in self._METHOD_SYNCS
                             or self._to_cpu(node))
                        and self._value_tainted(node.func.value, tainted)):
                    findings.append(self._flag(
                        mod, node, f".{node.func.attr}()"))
        return findings


# ---------------------------------------------------------------------------
# TW004 — pow2 bucketing
# ---------------------------------------------------------------------------

class BucketingDiscipline:
    """Power-of-two bucketing is never re-implemented inline.

    Dispatch shapes come from ``runtime/bucketing.pow2_bucket`` (and its
    wrappers), so the launch plans and the plan cache's shape classes
    share one contract; an inline ``1 << (n - 1).bit_length()`` is a
    second implementation that can drift. (The JAX rule's other half,
    static jit arguments, has no counterpart: the port has no jit.)
    """

    id = "TW004"
    title = "inline pow2 bucketing outside runtime/bucketing.py"

    BUCKET_MODULES = ("runtime/bucketing.py",)

    def check_module(self, mod: Module) -> Iterable[Finding]:
        if _path_in(mod, self.BUCKET_MODULES):
            return []
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.LShift)
                    and isinstance(node.right, ast.Call)
                    and isinstance(node.right.func, ast.Attribute)
                    and node.right.func.attr == "bit_length"):
                findings.append(mod.finding(
                    self.id, node,
                    "inline power-of-two bucketing (`1 << "
                    "(...).bit_length()`) bypasses the shared helper — use "
                    "traceweaver_tpu_torch.runtime.bucketing.pow2_bucket so "
                    "dispatch shapes share one bucketing contract"))
        return findings


# ---------------------------------------------------------------------------
# TW005 — lock discipline
# ---------------------------------------------------------------------------

class LockDiscipline:
    """Attributes guarded by a class's lock are guarded everywhere.

    Pack threads, flow workers and the serve pump all mutate shared
    state; one bare ``self.d[k] = ...`` outside the lock brings back the
    dropped-count race the accumulators exist to prevent. For every
    class that owns a ``threading.Lock``/``RLock``/``Condition``
    attribute, an attribute written under ``with self.<lock>`` anywhere
    is written under it in every method (``__init__`` excepted).
    Nested functions count as unlocked even inside a ``with`` block:
    closures outlive the critical section.
    """

    id = "TW005"
    title = "lock-guarded attribute written without the lock"

    _LOCK_CTORS = {"threading.Lock", "threading.RLock",
                   "threading.Condition", "Lock", "RLock", "Condition"}
    MUTATORS = {"append", "extend", "add", "update", "setdefault", "pop",
                "popleft", "clear", "remove", "discard", "insert",
                "appendleft"}

    def _lock_attrs(self, cls: ast.ClassDef) -> Set[str]:
        locks: Set[str] = set()
        for node in ast.walk(cls):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and dotted(node.value.func) in self._LOCK_CTORS):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        locks.add(t.attr)
        return locks

    @staticmethod
    def _self_attr(node: ast.AST) -> Optional[str]:
        """``self.X`` -> X; ``self.X[...]`` -> X; else None."""
        if isinstance(node, ast.Subscript):
            node = node.value
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _writes(self, method: ast.FunctionDef, locks: Set[str]
                ) -> List[Tuple[str, bool, ast.AST]]:
        """(attr, under_lock, site) for every self-attribute write."""
        out: List[Tuple[str, bool, ast.AST]] = []

        def visit(node: ast.AST, locked: bool) -> None:
            for child in ast.iter_child_nodes(node):
                child_locked = locked
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    visit(child, False)
                    continue
                if isinstance(child, ast.With):
                    holds = any(
                        self._self_attr(item.context_expr) in locks
                        for item in child.items)
                    child_locked = locked or holds
                if isinstance(child, (ast.Assign, ast.AugAssign)):
                    targets = (child.targets
                               if isinstance(child, ast.Assign)
                               else [child.target])
                    for t in targets:
                        elts = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                                else [t])
                        for e in elts:
                            attr = self._self_attr(e)
                            if attr:
                                out.append((attr, child_locked, child))
                elif (isinstance(child, ast.Call)
                        and isinstance(child.func, ast.Attribute)
                        and child.func.attr in self.MUTATORS):
                    attr = self._self_attr(child.func.value)
                    if attr:
                        out.append((attr, child_locked, child))
                visit(child, child_locked)

        visit(method, False)
        return out

    def check_module(self, mod: Module) -> Iterable[Finding]:
        findings: List[Finding] = []
        for cls in [n for n in ast.walk(mod.tree)
                    if isinstance(n, ast.ClassDef)]:
            locks = self._lock_attrs(cls)
            if not locks:
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            writes = {m.name: self._writes(m, locks) for m in methods}
            guarded: Set[str] = {
                attr
                for name, ws in writes.items() if name != "__init__"
                for attr, locked, _ in ws if locked}
            guarded -= locks
            for name, ws in writes.items():
                if name == "__init__":
                    continue
                for attr, locked, site in ws:
                    if attr in guarded and not locked:
                        findings.append(mod.finding(
                            self.id, site,
                            f"self.{attr} is written under `with "
                            f"self.{'/'.join(sorted(locks))}` elsewhere in "
                            f"class {cls.name} but not here — an unlocked "
                            "read-modify-write silently drops updates "
                            "under the pipelined flow workers"))
        return findings


# ---------------------------------------------------------------------------
# TW006 — precision discipline
# ---------------------------------------------------------------------------

class PrecisionDiscipline:
    """bf16 is storage only: accumulation runs in f32.

    Score blocks may be stored bfloat16, but every accumulating op runs
    f32: bf16's 8-bit mantissa loses whole spans' worth of log-density
    mass when hundreds of window cells reduce into one scalar. In
    ``ops/``, ``sum``/``mean``/``cumsum``/``logsumexp``/``matmul``/
    ``bmm``/``einsum``/``@`` over a value cast to bf16
    (``.to(torch.bfloat16)``, ``.bfloat16()``, ``dtype=torch.bfloat16``)
    is a finding, unless the op upcasts (``.float()``,
    ``.to(torch.float32)``) or accumulates in f32 (``dtype=torch.float32``).
    """

    id = "TW006"
    title = "accumulating op over a bf16 tensor without f32 accumulation"

    OPS_DIR = ROOT + "ops/"
    ACCUM = {"sum", "mean", "cumsum", "logsumexp", "matmul", "bmm",
             "einsum", "nansum", "prod", "cumprod"}
    _WIDE = ("float32", "float64", "float", "double")

    @staticmethod
    def _dtype_last(node: ast.AST) -> str:
        return dotted(node).split(".")[-1]

    def _is_bf16_cast(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if isinstance(node.func, ast.Attribute):
            if node.func.attr == "bfloat16" and not node.args:
                return True
            if node.func.attr == "to" and (
                    any(self._dtype_last(a) == "bfloat16" for a in node.args)
                    or any(k.arg == "dtype"
                           and self._dtype_last(k.value) == "bfloat16"
                           for k in node.keywords)):
                return True
        return any(k.arg == "dtype" and self._dtype_last(k.value) == "bfloat16"
                   for k in node.keywords)

    def _is_f32_cast(self, node: ast.AST) -> bool:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            return False
        if node.func.attr in ("float", "double") and not node.args:
            return True
        return node.func.attr == "to" and (
            any(self._dtype_last(a) in self._WIDE for a in node.args)
            or any(k.arg == "dtype" and self._dtype_last(k.value) in self._WIDE
                   for k in node.keywords))

    def _has_f32_accumulator(self, call: ast.Call) -> bool:
        return any(k.arg == "dtype" and self._dtype_last(k.value) in self._WIDE
                   for k in call.keywords)

    def _value_bf16(self, node: ast.AST, tainted: Set[str]) -> bool:
        if self._is_f32_cast(node):
            return False
        if isinstance(node, ast.Call) and self._has_f32_accumulator(node):
            return False
        if self._is_bf16_cast(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in tainted
        for child in ast.iter_child_nodes(node):
            if self._value_bf16(child, tainted):
                return True
        return False

    def _collect(self, fn: ast.AST) -> Set[str]:
        tainted: Set[str] = set()
        for _ in range(4):
            before = len(tainted)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and self._value_bf16(
                        node.value, tainted):
                    for t in node.targets:
                        tainted.update(target_names(t))
            if len(tainted) == before:
                break
        return tainted

    def _finding(self, mod: Module, node: ast.AST, op: str) -> Finding:
        return mod.finding(
            self.id, node,
            f"{op} accumulates a bfloat16 tensor — bf16 is storage only: "
            "upcast with .float() / .to(torch.float32) first, or "
            "accumulate with dtype=torch.float32")

    def check_module(self, mod: Module) -> Iterable[Finding]:
        if self.OPS_DIR not in mod.path:
            return []
        findings: List[Finding] = []
        for fn in outer_functions(mod.tree):
            tainted = self._collect(fn)
            for node in ast.walk(fn):
                if (isinstance(node, ast.BinOp)
                        and isinstance(node.op, ast.MatMult)):
                    if (self._value_bf16(node.left, tainted)
                            or self._value_bf16(node.right, tainted)):
                        findings.append(self._finding(mod, node, "@"))
                    continue
                if not isinstance(node, ast.Call):
                    continue
                last = _call_last(node)
                if last not in self.ACCUM or self._has_f32_accumulator(node):
                    continue
                hot = any(self._value_bf16(a, tainted) for a in node.args)
                if not hot and isinstance(node.func, ast.Attribute):
                    hot = self._value_bf16(node.func.value, tainted)
                if hot:
                    findings.append(self._finding(mod, node, f"{last}()"))
        return findings


# ---------------------------------------------------------------------------
# TW007 — metric discipline
# ---------------------------------------------------------------------------

class MetricDiscipline:
    """Counters in the telemetry-bearing modules grow only through the
    obs-mirrored accumulators.

    Every sanctioned accumulator (``fleet._Stats.add/merge/note/bucket/
    record_max``, the stream and serve ``_bump`` helpers) mirrors into the
    metrics registry, so a bare ``stats[k] += 1`` or ``d[k] = d.get(k, 0)
    + v`` in ``algorithms/fleet.py``, ``stream/`` or ``serve/`` is a
    counter the scrape never sees; so is a module-level counter table
    (``_COUNTERS = {"x": 0}``). Attribute counters (``self.shed += 1``)
    are typed state with explicit mirror sites and are not flagged.
    """

    id = "TW007"
    title = "ad-hoc counter growth outside the obs-mirrored accumulators"

    WATCH_FILES = ("algorithms/fleet.py",)
    WATCH_DIRS = (ROOT + "stream/", ROOT + "serve/")
    SANCTIONED = {"add", "merge", "note", "bucket", "record_max",
                  "_bump", "bump", "inc", "observe", "set", "set_max"}

    def _watched(self, mod: Module) -> bool:
        return (_path_in(mod, self.WATCH_FILES)
                or any(d in mod.path for d in self.WATCH_DIRS))

    @staticmethod
    def _numeric_const(node: ast.AST) -> bool:
        return (isinstance(node, ast.Constant)
                and isinstance(node.value, (int, float))
                and not isinstance(node.value, bool))

    def _is_counter_table(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Dict) and bool(node.values)
                and all(self._numeric_const(v) for v in node.values))

    @staticmethod
    def _get_rmw(node: ast.Assign) -> bool:
        """``d[k] = d.get(k, 0) + v`` (either operand order)."""
        if len(node.targets) != 1 or not isinstance(
                node.targets[0], ast.Subscript):
            return False
        base_dump = ast.dump(node.targets[0].value)
        if not isinstance(node.value, ast.BinOp) or not isinstance(
                node.value.op, ast.Add):
            return False
        for side in (node.value.left, node.value.right):
            if (isinstance(side, ast.Call)
                    and isinstance(side.func, ast.Attribute)
                    and side.func.attr == "get"
                    and ast.dump(side.func.value) == base_dump):
                return True
        return False

    def check_module(self, mod: Module) -> Iterable[Finding]:
        if not self._watched(mod):
            return []
        findings: List[Finding] = []
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and self._is_counter_table(
                    stmt.value):
                findings.append(mod.finding(
                    self.id, stmt,
                    "module-level counter dict — a private ledger the "
                    "metrics registry never sees; declare a counter on "
                    "traceweaver_tpu_torch.obs (or mirror through the "
                    "sanctioned accumulators) instead"))

        def visit(node: ast.AST, sanctioned: bool) -> None:
            for child in ast.iter_child_nodes(node):
                child_ok = sanctioned
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    child_ok = child.name in self.SANCTIONED
                if (not sanctioned
                        and isinstance(child, ast.AugAssign)
                        and isinstance(child.op, ast.Add)
                        and isinstance(child.target, ast.Subscript)):
                    findings.append(mod.finding(
                        self.id, child,
                        "`...[key] += n` outside the obs-mirrored "
                        "accumulators — this count never reaches the "
                        "metrics registry; route it through _Stats/_bump "
                        "or an obs counter"))
                elif (not sanctioned and isinstance(child, ast.Assign)
                        and self._get_rmw(child)):
                    findings.append(mod.finding(
                        self.id, child,
                        "`d[k] = d.get(k, ...) + v` outside the "
                        "obs-mirrored accumulators — this count never "
                        "reaches the metrics registry; route it through "
                        "_Stats/_bump or an obs counter"))
                visit(child, child_ok)

        visit(mod.tree, False)
        return findings


# ---------------------------------------------------------------------------
# TW008 — packed-block channel layout
# ---------------------------------------------------------------------------

class ChannelLayoutDiscipline:
    """Packed-block channel indices come from ``algorithms/packed_layout.py``.

    The packed solver output multiplexes per-span channels on its last
    axis; a stale ``x[..., 3:]`` literal decodes margins as top-k columns
    without any error when the block grows. Ellipsis-leading subscripts
    with an integer constant (or an integer-bounded slice) in the modules
    that touch packed blocks are findings; ``x[..., None]`` and
    explicit-dim indexing are not.
    """

    id = "TW008"
    title = "raw packed-block channel index outside packed_layout.py"

    WATCH_FILES = ("algorithms/weaver_torch.py", "algorithms/fleet.py",
                   "obs/quality.py")
    ALLOWED = ("algorithms/packed_layout.py",)

    @staticmethod
    def _int_const(node: ast.AST) -> bool:
        return (isinstance(node, ast.Constant)
                and isinstance(node.value, int)
                and not isinstance(node.value, bool))

    def _channel_elt(self, node: ast.AST) -> bool:
        if self._int_const(node):
            return True
        if isinstance(node, ast.Slice):
            return any(part is not None and self._int_const(part)
                       for part in (node.lower, node.upper))
        return False

    def check_module(self, mod: Module) -> Iterable[Finding]:
        if not _path_in(mod, self.WATCH_FILES) or _path_in(mod, self.ALLOWED):
            return []
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Subscript):
                continue
            sl = node.slice
            if not (isinstance(sl, ast.Tuple) and sl.elts
                    and isinstance(sl.elts[0], ast.Constant)
                    and sl.elts[0].value is Ellipsis):
                continue
            if any(self._channel_elt(e) for e in sl.elts[1:]):
                findings.append(mod.finding(
                    self.id, node,
                    "raw channel index on a packed-block trailing axis — "
                    "use the named constants / split_packed from "
                    "traceweaver_tpu_torch.algorithms.packed_layout"))
        return findings


# ---------------------------------------------------------------------------
# TW009 — device-resident columns
# ---------------------------------------------------------------------------

class DevcolsResidency(HostSyncHazard):
    """Ring-resident columns reach the host only through the ledgered
    fetch.

    The resident path (``ops/devcols.py``) keeps the span columns on the
    card and gathers windows there; a bare host copy of a ring buffer or
    an assembled window tensor re-ships the very data the path keeps
    resident and bills nothing, so the byte ledger lies. Host copies go
    through ``devcols.fetch_resident`` or the fleet's ``_fetch``. Same
    taint mechanics as TW003; the sources are the devcols programs
    (``assemble_*``, ``ring_append``) and ``.buf`` reads.
    """

    id = "TW009"
    title = "unledgered host copy of ring-resident device columns"

    HOT = ("algorithms/fleet.py", "algorithms/weaver_torch.py",
           "stream/service.py", "ops/devcols.py")
    ALLOWED_FUNCS = ("_fetch", "fetch_resident")
    LEDGER_HINT = "ops/devcols.fetch_resident"
    _DEVICE_RE = re.compile(r"^(assemble_|ring_append$)")
    _LAUNDER = {"_fetch", "fetch_resident"}
    _SYNC_CALLS: Set[str] = set()

    def _is_device_call(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr == "buf":
            return True
        if not isinstance(node, ast.Call):
            return False
        return bool(self._DEVICE_RE.match(_call_last(node)))


# ---------------------------------------------------------------------------
# TW010 — adaptation ledger
# ---------------------------------------------------------------------------

class AdaptLedgerDiscipline:
    """Adaptation actuations go through the evented ledger.

    A refit replaces a service's carried statistics; unledgered, the
    operator sees reconstruction quality change with no
    ``tw_adapt_actions_total`` increment and no event saying why. Inside
    ``adapt/`` a function that calls an actuation primitive
    (``solve_fleet``, ``refit_from_assignments``) also calls the ledger
    (``_act`` or ``refit_done``); elsewhere, no underscore-private
    controller internal is called through an ``.adapt`` receiver.
    """

    id = "TW010"
    title = "adaptation actuation outside the evented ledger"

    ADAPT_DIR = ROOT + "adapt/"
    ACTUATIONS = {"solve_fleet", "refit_from_assignments"}
    LEDGER = {"_act", "refit_done"}

    def _check_adapt(self, mod: Module) -> Iterable[Finding]:
        findings: List[Finding] = []

        def top_functions(node: ast.AST):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    yield child
                elif isinstance(child, ast.ClassDef):
                    yield from top_functions(child)

        for fn in top_functions(mod.tree):
            actuations = []
            ledgered = False
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_last(node)
                if name in self.ACTUATIONS:
                    actuations.append(node)
                elif name in self.LEDGER:
                    ledgered = True
            if actuations and not ledgered:
                for node in actuations:
                    findings.append(mod.finding(
                        self.id, node,
                        "adaptation actuation primitive outside a ledgered "
                        "function — every refit/fallback path in adapt/ "
                        "lands in the evented ledger (_act / refit_done)"))
        return findings

    def check_module(self, mod: Module) -> Iterable[Finding]:
        if self.ADAPT_DIR in mod.path:
            return self._check_adapt(mod)
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith("_")
                    and isinstance(node.func.value, ast.Attribute)
                    and node.func.value.attr == "adapt"):
                continue
            findings.append(mod.finding(
                self.id, node,
                "private adaptation-controller internal called outside "
                "adapt/ — consumers drive the controller through its "
                "public evented API only (observe/pending_refits/"
                "begin_refit/refit_done/warm_dists)"))
        return findings


# ---------------------------------------------------------------------------
# TW012 — serve ticket discipline
# ---------------------------------------------------------------------------

class TicketDiscipline:
    """Per-tenant ``in_flight`` windows mutate only inside the ticket
    lifecycle.

    ``submit_admitted`` records a ticket's windows in ``Tenant.in_flight``
    and ``_ring_retire_locked`` removes exactly them when it retires;
    everything between only reads the list. A mutation anywhere else
    lets retention prune a buffer mid-solve or leaves a drain barrier
    waiting on a ticket that already completed. Any mutator call on, or
    assignment to, ``<x>.in_flight`` outside ``__init__``,
    ``submit_admitted`` and ``_ring_retire_locked`` is a finding.
    """

    id = "TW012"
    title = "in_flight mutated outside the ticket lifecycle"

    LIFECYCLE = frozenset({"__init__", "submit_admitted",
                           "_ring_retire_locked"})
    ATTR = "in_flight"

    @classmethod
    def _inflight_attr(cls, node: ast.AST) -> bool:
        if isinstance(node, ast.Subscript):
            node = node.value
        return isinstance(node, ast.Attribute) and node.attr == cls.ATTR

    def check_module(self, mod: Module) -> Iterable[Finding]:
        exempt: Set[int] = set()
        for fn in outer_functions(mod.tree):
            if fn.name in self.LIFECYCLE:
                exempt.update(id(n) for n in ast.walk(fn))
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            hit = False
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    elts = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t])
                    hit = hit or any(self._inflight_attr(e) for e in elts)
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in LockDiscipline.MUTATORS):
                hit = self._inflight_attr(node.func.value)
            if hit and id(node) not in exempt:
                findings.append(mod.finding(
                    self.id, node,
                    "in_flight mutated outside the ticket lifecycle — only "
                    "submit_admitted (extend) and _ring_retire_locked "
                    "(identity removal) may touch per-tenant in_flight, "
                    "under the service lock"))
        return findings


# ---------------------------------------------------------------------------
# TW013 — serve ack discipline
# ---------------------------------------------------------------------------

class AckDiscipline:
    """A 2xx ack on the serve ingest paths implies durability.

    A client that got a 200 for a ``/spans`` or ``/capture`` POST may drop
    its send buffer, so the handler routes the bytes through the
    WAL-appending entry points (``wal_ingest``, ``wal_ingest_capture``)
    before replying. In the serve front door a ``*._reply(2xx, payload)``
    whose payload calls a bare ``ingest``/``ingest_capture`` is a
    finding, unless it sits under an ``if`` on the tenant configuration's
    ``wal`` field (``TenantConfig.wal``: the no-durability opt-out is a
    visible operator choice).
    """

    id = "TW013"
    title = "unledgered 2xx ack on a serve ingest path"

    WATCH_FILES = ("serve/http.py",)
    INGEST = {"ingest", "ingest_capture"}
    GUARD_ATTR = "wal"

    def _mentions_wal(self, node: ast.AST) -> bool:
        return any(isinstance(n, ast.Attribute) and n.attr == self.GUARD_ATTR
                   for n in ast.walk(node))

    @staticmethod
    def _ack_payload(node: ast.AST) -> Optional[ast.AST]:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "_reply"
                and len(node.args) >= 2):
            return None
        code = node.args[0]
        if not (isinstance(code, ast.Constant)
                and isinstance(code.value, int)
                and 200 <= code.value < 300):
            return None
        return node.args[1]

    def check_module(self, mod: Module) -> Iterable[Finding]:
        if not _path_in(mod, self.WATCH_FILES):
            return []
        findings: List[Finding] = []

        def visit(node: ast.AST, guarded: bool) -> None:
            for child in ast.iter_child_nodes(node):
                child_guarded = guarded
                if isinstance(child, ast.If) and self._mentions_wal(
                        child.test):
                    child_guarded = True
                payload = self._ack_payload(child)
                if payload is not None and not child_guarded:
                    for n in ast.walk(payload):
                        if (isinstance(n, ast.Call)
                                and isinstance(n.func, ast.Attribute)
                                and n.func.attr in self.INGEST):
                            findings.append(mod.finding(
                                self.id, child,
                                f"2xx ack over bare {n.func.attr}() — a 200 "
                                "on an ingest path promises the client its "
                                "bytes survive kill -9; route through the "
                                "ledgered wal_ingest* entry points, or put "
                                "the reply under an explicit check of the "
                                "tenant's wal setting"))
                            break
                visit(child, child_guarded)

        visit(mod.tree, False)
        return findings


# ---------------------------------------------------------------------------
# TW101 — no knob reads
# ---------------------------------------------------------------------------

class EnvKnobRead:
    """The port reads no ``TW_*`` environment variable.

    The JAX package's knobs are constructor arguments and CLI flags here
    (with the knobs' defaults), so a run's behaviour is what its caller
    passed, never what a stray variable in the environment says. Any
    read — ``os.environ.get``, ``os.getenv``, a Load of
    ``os.environ[...]`` — is a finding; writes that configure a child
    process stay allowed.
    """

    id = "TW101"
    title = "TW_* environment read in the port"

    def check_module(self, mod: Module) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            got = raw_env_read(node)
            if got:
                tw, site = got
                findings.append(mod.finding(
                    self.id, site,
                    f"environment read of {tw!r} — the port reads no TW_* "
                    "variable: make it a constructor argument or a CLI "
                    "flag with the knob's default"))
        return findings


# ---------------------------------------------------------------------------
# TW102 — no JAX
# ---------------------------------------------------------------------------

class ForbiddenImport:
    """The port imports neither JAX nor the JAX package.

    ``traceweaver_tpu_torch`` imports torch, numpy and scipy. The card's
    machine has no JAX, networkx or sklearn, and the port keeps its own
    copy of every module of ``traceweaver_tpu`` it needs (even a JAX-free
    one). ``import``, ``from ... import`` and ``importlib.import_module``
    / ``__import__`` with a constant name are checked.
    """

    id = "TW102"
    title = "import of JAX, networkx, sklearn or the JAX package"

    FORBIDDEN = {"jax", "jaxlib", "networkx", "sklearn", "traceweaver_tpu"}
    _DYNAMIC = {"importlib.import_module", "import_module", "__import__"}

    def _bad(self, name: Optional[str]) -> bool:
        return bool(name) and name.split(".")[0] in self.FORBIDDEN

    def check_module(self, mod: Module) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            names: List[str] = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                    and dotted(node.func) in self._DYNAMIC and node.args):
                names = [const_str(node.args[0]) or ""]
            for name in names:
                if self._bad(name):
                    findings.append(mod.finding(
                        self.id, node,
                        f"import of {name!r} — the port imports torch, "
                        "numpy and scipy only, never JAX or a module of "
                        "traceweaver_tpu; keep a copy of what it needs"))
        return findings


# ---------------------------------------------------------------------------
# TW103 — no gate, no fallback
# ---------------------------------------------------------------------------

class NoDeviceGate:
    """No ``torch.cuda.is_available()`` gate and no fallback.

    The entry points run on the card unless the caller asks for the CPU;
    a kernel wrapper takes its plain version only for a tensor on the
    CPU, and on a CUDA tensor launches its kernel or raises. A call of
    ``torch.cuda.is_available()`` is a finding (a site that raises,
    refuses or only counts devices says so in its suppression), and so
    is an ``except`` handler in ``ops/`` whose body calls a ``*_plain``
    function: a kernel failure that quietly runs the plain version.
    """

    id = "TW103"
    title = "device gate or plain-version fallback"

    OPS_DIR = ROOT + "ops/"

    def check_module(self, mod: Module) -> Iterable[Finding]:
        findings: List[Finding] = []
        in_ops = self.OPS_DIR in mod.path
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and dotted(node.func).endswith("cuda.is_available")):
                findings.append(mod.finding(
                    self.id, node,
                    "torch.cuda.is_available() gate — the port runs on the "
                    "card unless the caller asks for the CPU, and falls "
                    "back to nothing; justify a site that raises, refuses "
                    "or only counts with a suppression"))
            elif in_ops and isinstance(node, ast.ExceptHandler):
                for n in ast.walk(node):
                    if (isinstance(n, ast.Call)
                            and _call_last(n).endswith("_plain")):
                        findings.append(mod.finding(
                            self.id, n,
                            f"{_call_last(n)}() in an except handler — a "
                            "kernel that fails must raise, not fall back to "
                            "its plain version"))
        return findings


# ---------------------------------------------------------------------------
# TW111 — build and launch discipline
# ---------------------------------------------------------------------------

class LaunchDiscipline:
    """Kernels are built and loaded in one place and launched under the
    launch lock.

    ``ops/cuda_build.py`` builds every CUDA source once (an ``fcntl``
    lock shares a build between processes) and the ``_lib()`` /
    ``get_lib()`` loaders load it once; an ``nvcc`` run or a
    ``ctypes.CDLL`` anywhere else is a second build or load that bypasses
    both. In ``ops/cuda_sinkhorn.py`` a kernel's shared-memory limit is set
    per function, so setting it and launching is one step: every call on
    the kernel library (``lib.tw_*``) runs inside ``with … _launch_lock``.
    """

    id = "TW111"
    title = "kernel build/load outside the builder, or launch outside the lock"

    BUILDER = ("ops/cuda_build.py",)
    LOADERS = {"_lib", "get_lib"}
    LAUNCH_MODULE = ("ops/cuda_sinkhorn.py",)
    LOCK = "_launch_lock"

    @staticmethod
    def _is_load(node: ast.Call) -> bool:
        return dotted(node.func) in ("ctypes.CDLL", "CDLL",
                                     "ctypes.cdll.LoadLibrary")

    @staticmethod
    def _is_nvcc(node: ast.Call) -> bool:
        if _call_last(node) == "nvcc":
            return True
        for a in node.args:
            if isinstance(a, (ast.List, ast.Tuple)) and a.elts and \
                    (const_str(a.elts[0]) or "").endswith("nvcc"):
                return True
        return False

    def _locked(self, item: ast.withitem) -> bool:
        return dotted(item.context_expr).split(".")[-1] == self.LOCK

    def check_module(self, mod: Module) -> Iterable[Finding]:
        findings: List[Finding] = []
        builder = _path_in(mod, self.BUILDER)
        launch_mod = _path_in(mod, self.LAUNCH_MODULE)

        def visit(node: ast.AST, fn: Optional[str], locked: bool) -> None:
            for child in ast.iter_child_nodes(node):
                child_fn, child_locked = fn, locked
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    child_fn = child.name if fn is None else fn
                    child_locked = False
                elif isinstance(child, ast.With):
                    child_locked = locked or any(
                        self._locked(i) for i in child.items)
                if isinstance(child, ast.Call) and not builder:
                    if self._is_load(child) and child_fn not in self.LOADERS:
                        findings.append(mod.finding(
                            self.id, child,
                            "ctypes.CDLL outside the library loaders — load "
                            "a kernel library through its module's _lib()"))
                    elif self._is_nvcc(child):
                        findings.append(mod.finding(
                            self.id, child,
                            "nvcc run outside ops/cuda_build.py — build "
                            "through cuda_build.build, which builds once "
                            "and shares the build between processes"))
                if (launch_mod and isinstance(child, ast.Call)
                        and isinstance(child.func, ast.Attribute)
                        and child.func.attr.startswith("tw_")
                        and not child_locked):
                    findings.append(mod.finding(
                        self.id, child,
                        f"{child.func.attr}() outside `with _launch_lock` — "
                        "setting a kernel's shared-memory limit and "
                        "launching it is one step under the lock"))
                visit(child, child_fn, child_locked)

        visit(mod.tree, None, False)
        return findings


#: registration order == reporting order for same-line findings
RULE_CLASSES = [HostSyncHazard, BucketingDiscipline, LockDiscipline,
                PrecisionDiscipline, MetricDiscipline,
                ChannelLayoutDiscipline, DevcolsResidency,
                AdaptLedgerDiscipline, TicketDiscipline, AckDiscipline,
                EnvKnobRead, ForbiddenImport, NoDeviceGate, LaunchDiscipline]
