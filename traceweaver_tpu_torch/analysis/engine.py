"""The port's lint engine: findings, suppressions, baseline, tree walking
(mirrors ``traceweaver_tpu/analysis/engine.py``).

Stdlib ``ast``/``tokenize`` only: ``python -m traceweaver_tpu_torch.analysis``
imports neither torch nor numpy, so the gate costs milliseconds and runs
on a machine with no card.

- :class:`Finding` — one violation, with a content-addressed
  :meth:`~Finding.fingerprint` (rule | path | stripped source line), so a
  baseline entry survives unrelated line drift;
- suppressions — ``# twlint-torch: disable=TW003 — reason`` on the
  offending line (or on a comment-only line just above it) waives the
  named rules; ``# twlint-torch: disable-file=TW004`` anywhere waives a
  rule for the whole file. A suppression that names an unknown rule id
  is itself reported (TW000). The tag is the port's own: the JAX
  package's linter reads ``# twlint:`` comments and this one does not,
  so neither sees the other's waivers;
- baseline — a checked-in file of grandfathered findings
  (:data:`DEFAULT_BASELINE`); every entry carries a ``#`` justification
  or loading fails, and an entry that matches nothing is reported as
  TW000;
- rules — objects with ``check_module(mod)`` and optionally
  ``check_repo(modules)``, made fresh for every :func:`run`.

By default :func:`run` scans the port: ``traceweaver_tpu_torch/`` and
``chip_smoke.py`` (:data:`DEFAULT_PATHS`).
"""

from __future__ import annotations

import ast
import hashlib
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: the meta rule id: engine-level problems (bad suppression ids, stale
#: baseline entries). Not suppressible and never baselined.
META_RULE = "TW000"

#: the suppression comment's tag
TAG = "twlint-torch"

_SUPPRESS_RE = re.compile(
    r"#\s*twlint-torch:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\s]+?)"
    r"(?:\s*(?:—|--|:).*)?$")


@dataclass(frozen=True)
class Finding:
    rule: str          # "TW003"
    path: str          # relative to the root, forward slashes
    line: int          # 1-based
    col: int           # 0-based
    message: str
    line_text: str = ""  # stripped source line, for the fingerprint

    def fingerprint(self) -> str:
        """Content-addressed id for baseline matching: stable across
        line-number drift, invalidated when the flagged line changes."""
        key = "|".join((self.rule, self.path, self.line_text.strip()))
        return hashlib.sha1(key.encode()).hexdigest()[:12]

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} {self.message}")


class Module:
    """One parsed source file handed to the rules."""

    def __init__(self, path: str, text: str) -> None:
        self.path = path.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message,
                       line_text=self.line_text(getattr(node, "lineno", 1)))


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

class Suppressions:
    """A file's suppression table, parsed from its comments."""

    def __init__(self, by_line: Dict[int, Set[str]],
                 file_wide: Set[str], bad_ids: List[Tuple[int, str]]) -> None:
        self.by_line = by_line
        self.file_wide = file_wide
        self.bad_ids = bad_ids  # (line, unknown id), reported as TW000

    def waives(self, finding: Finding) -> bool:
        if finding.rule == META_RULE:
            return False
        if finding.rule in self.file_wide:
            return True
        return finding.rule in self.by_line.get(finding.line, set())


def parse_suppressions(text: str, known_rules: Set[str]) -> Suppressions:
    by_line: Dict[int, Set[str]] = {}
    file_wide: Set[str] = set()
    bad: List[Tuple[int, str]] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError):
        return Suppressions({}, set(), [])
    # a suppression on a comment-only line covers the next source line
    code_lines = {t.start[0] for t in tokens
                  if t.type not in (tokenize.COMMENT, tokenize.NL,
                                    tokenize.NEWLINE, tokenize.INDENT,
                                    tokenize.DEDENT, tokenize.ENCODING,
                                    tokenize.ENDMARKER)}
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        kind, raw_ids = m.groups()
        ids = {s.strip() for s in raw_ids.split(",") if s.strip()}
        line = tok.start[0]
        for rid in ids:
            if rid not in known_rules:
                bad.append((line, rid))
        ids &= known_rules
        if kind == "disable-file":
            file_wide |= ids
        elif line in code_lines:
            by_line.setdefault(line, set()).update(ids)
        else:
            nxt = min((ln for ln in code_lines if ln > line), default=None)
            if nxt is not None:
                by_line.setdefault(nxt, set()).update(ids)
    return Suppressions(by_line, file_wide, bad)


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

class BaselineError(ValueError):
    """A malformed baseline file (missing justification, bad shape)."""


def load_baseline(path: str) -> Dict[Tuple[str, str, str], str]:
    """Parse a baseline file into ``{(rule, path, fingerprint): line}``.

    Grammar (one grandfathered finding per line)::

        TW003 traceweaver_tpu_torch/foo.py 1a2b3c4d5e6f  # why it stays

    The trailing ``#`` justification is mandatory. Blank lines and
    full-line comments are ignored.
    """
    entries: Dict[Tuple[str, str, str], str] = {}
    if not os.path.exists(path):
        return entries
    with open(path, encoding="utf-8") as f:
        for n, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            body, sep, reason = line.partition("#")
            if not sep or not reason.strip():
                raise BaselineError(
                    f"{path}:{n}: baseline entry lacks a '# justification' "
                    f"comment: {line!r}")
            parts = body.split()
            if len(parts) != 3:
                raise BaselineError(
                    f"{path}:{n}: expected 'RULE path fingerprint  "
                    f"# reason', got: {line!r}")
            rule, rel, fp = parts
            if rule == META_RULE:
                raise BaselineError(
                    f"{path}:{n}: {META_RULE} (engine) findings cannot be "
                    "baselined")
            entries[(rule, rel, fp)] = line
    return entries


def format_baseline(findings: Sequence[Finding]) -> str:
    """Render findings as baseline lines (justifications left as TODO:
    the author fills them in, or loading fails)."""
    out = [f"# {TAG} baseline — one grandfathered finding per line.",
           "# Every entry needs a real '# justification'.",
           ""]
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        out.append(f"{f.rule} {f.path} {f.fingerprint()}  "
                   f"# TODO justify: {f.message[:60]}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# tree walking + run
# ---------------------------------------------------------------------------

#: directories never scanned (vcs, caches, build outputs)
EXCLUDE_DIRS = {".git", "__pycache__", ".jax_cache", ".claude",
                ".pytest_cache", ".ruff_cache", "build", "node_modules",
                "_build"}

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.txt")

#: what a run with no paths scans: the port's package and its smoke
DEFAULT_PATHS = ("traceweaver_tpu_torch", "chip_smoke.py")


def iter_python_files(root: str,
                      paths: Optional[Sequence[str]] = None) -> List[str]:
    """Root-relative paths of every ``.py`` file under the given ``paths``
    (default :data:`DEFAULT_PATHS`; a missing one is skipped), sorted,
    caches and build outputs excluded."""
    rels: List[str] = []
    targets = [os.path.join(root, p) for p in (paths or DEFAULT_PATHS)]
    for target in targets:
        if os.path.isfile(target):
            rels.append(os.path.relpath(target, root))
            continue
        for dirpath, dirnames, filenames in os.walk(target):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in EXCLUDE_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rels.append(os.path.relpath(
                        os.path.join(dirpath, fn), root))
    return sorted(set(r.replace(os.sep, "/") for r in rels))


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)   # live, ranked
    suppressed: int = 0
    baselined: int = 0
    files: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"{TAG}: {len(self.findings)} finding(s) across {self.files} "
            f"file(s) ({self.baselined} baselined, "
            f"{self.suppressed} suppressed)")
        return "\n".join(lines)


def _default_rules():
    from traceweaver_tpu_torch.analysis import rules as _rules

    return [cls() for cls in _rules.RULE_CLASSES]


def analyze_sources(sources: Sequence[Tuple[str, str]],
                    rules=None) -> Tuple[List[Finding], int]:
    """Run the rules over in-memory ``(rel_path, text)`` pairs (how the
    tests feed snippets). Applies suppressions but no baseline. Returns
    (findings, suppressed_count)."""
    rules = _default_rules() if rules is None else rules
    known = {r.id for r in rules} | {META_RULE}
    modules: List[Module] = []
    raw: List[Finding] = []
    sups: Dict[str, Suppressions] = {}
    for rel, text in sources:
        try:
            mod = Module(rel, text)
        except SyntaxError as e:
            raw.append(Finding(META_RULE, rel.replace(os.sep, "/"),
                               e.lineno or 1, (e.offset or 1) - 1,
                               f"syntax error: {e.msg}"))
            continue
        modules.append(mod)
        sup = parse_suppressions(text, known)
        sups[mod.path] = sup
        for line, rid in sup.bad_ids:
            raw.append(Finding(META_RULE, mod.path, line, 0,
                               f"suppression names unknown rule {rid!r} "
                               f"(known: {', '.join(sorted(known))})"))
        for rule in rules:
            raw.extend(rule.check_module(mod))
    for rule in rules:
        check_repo = getattr(rule, "check_repo", None)
        if check_repo is not None:
            raw.extend(check_repo(modules))
    live: List[Finding] = []
    suppressed = 0
    for f in raw:
        sup = sups.get(f.path)
        if sup is not None and sup.waives(f):
            suppressed += 1
        else:
            live.append(f)
    live.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return live, suppressed


def run(root: str = REPO_ROOT,
        paths: Optional[Sequence[str]] = None,
        baseline_path: Optional[str] = DEFAULT_BASELINE,
        rules=None) -> Report:
    """The whole pass: walk, parse, rule, suppress, baseline."""
    rels = iter_python_files(root, paths)
    sources: List[Tuple[str, str]] = []
    for rel in rels:
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            sources.append((rel, f.read()))
    findings, suppressed = analyze_sources(sources, rules=rules)
    report = Report(suppressed=suppressed, files=len(sources))
    baseline = (load_baseline(baseline_path) if baseline_path else {})
    matched: Set[Tuple[str, str, str]] = set()
    for f in findings:
        key = (f.rule, f.path, f.fingerprint())
        if key in baseline:
            matched.add(key)
            report.baselined += 1
        else:
            report.findings.append(f)
    for key in sorted(set(baseline) - matched):
        # only meaningful when the entry's file was scanned: a partial run
        # must not call untouched entries stale
        if paths and key[1] not in {s[0] for s in sources}:
            continue
        report.findings.append(Finding(
            META_RULE, os.path.relpath(
                baseline_path, root).replace(os.sep, "/"), 1, 0,
            f"stale baseline entry (nothing matches): {baseline[key]!r} — "
            "delete it"))
    return report
