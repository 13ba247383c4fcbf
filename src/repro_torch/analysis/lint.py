"""Host-path lint of the port (``repro.analysis.lint``): AST rules for the
bug classes earlier work fixed by hand.

``python -m repro_torch.analysis.lint`` walks ``src/repro_torch``, ``docs/``
and ``README.md`` and applies custom rules that encode the port's host-side
discipline, the things a generic linter cannot know:

====== ====================================================================
rule   what it catches
====== ====================================================================
SYNC01 hidden host<->device syncs in serving hot phases: ``.item()``,
       ``.tolist()``, ``torch.cuda.synchronize()`` and ``.synchronize()``
       on a stream or event always; ``.cpu()`` / ``.numpy()``,
       ``np.asarray`` / ``np.array`` and ``float()`` / ``int()`` /
       ``bool()`` when applied to device-state expressions, inside
       stage/poll/dispatch-phase functions. Retire's fetch is the one
       sanctioned wait point; everything else must stay asynchronous or
       the staging pipeline's overlap is silently destroyed.
OBS01  unbounded container growth in obs/telemetry: a ``self.x = []`` /
       ``{}`` (or ``deque()`` without ``maxlen``) that other methods
       append to / insert into. Per-step state must be O(1) in steps
       (a bounded ring or a histogram).
OBS02  mutation of shared obs state outside its lock: in a class that owns
       a ``_lock``/``lock``, any ``self.*`` mutation outside ``__init__``
       must sit lexically inside ``with self._lock:``.
HOST01 module-level ``torch`` / ``triton`` imports in host-only modules
       (obs/, staging, telemetry, stream sources, ingest, the autopilot,
       this module): pure-host tooling imports them and must not drag in a
       device runtime.
DOC01  docs code fences that dodge the executable-docs tripwire: a fenced
       block with no info string whose body looks like Python. Tag it
       ```` ```python ```` (executed by tests/test_docs_examples.py) or
       ```` ```python noexec ```` (illustration only), never leave it
       bare.
====== ====================================================================

Suppression: append ``# lint: ok RULE reason`` on (or on the line above)
the offending line; in markdown use ``<!-- lint: ok RULE reason -->`` on
the preceding line. Fleet-level intentional findings live in the checked-in
baseline (``src/repro_torch/analysis/lint-baseline.json``, keyed by rule +
path + line *text*, so line-number drift never churns it); ``--baseline``
filters them, ``--write-baseline`` regenerates the file, and ``--json``
emits machine-readable output. Exit status is 1 iff un-baselined,
un-suppressed violations remain.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import re
import sys
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_BASELINE = "src/repro_torch/analysis/lint-baseline.json"
DEFAULT_PATHS = ("src/repro_torch", "docs", "README.md")

_SUPPRESS_PY = re.compile(r"#\s*lint:\s*ok\s+([A-Z]+\d+(?:\s*,\s*[A-Z]+\d+)*)")
_SUPPRESS_MD = re.compile(r"<!--\s*lint:\s*ok\s+([A-Z]+\d+(?:\s*,\s*[A-Z]+\d+)*)")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    rule: str
    path: str          # repo-relative posix path
    line: int          # 1-based
    message: str
    line_text: str = ""

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    @property
    def baseline_key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.line_text.strip())


class Module:
    """One linted file: text + (for .py) parsed AST."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        if path.endswith(".py"):
            try:
                self.tree = ast.parse(text)
            except SyntaxError:
                self.tree = None

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:                # pragma: no cover - py<3.9 fallback
        return ast.dump(node)


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

RULES: Dict[str, "Rule"] = {}


def register_rule(cls):
    RULES[cls.id] = cls()
    return cls


class Rule:
    id = ""
    title = ""

    def applies(self, path: str) -> bool:
        raise NotImplementedError

    def check(self, mod: Module) -> Iterator[LintViolation]:
        raise NotImplementedError

    def _v(self, mod: Module, lineno: int, message: str) -> LintViolation:
        return LintViolation(self.id, mod.path, lineno, message,
                             mod.line_text(lineno))


@register_rule
class HiddenSyncRule(Rule):
    """SYNC01 — no hidden host<->device sync in serving hot phases."""

    id = "SYNC01"
    title = "hidden host<->device sync in a serving hot phase"

    SCOPE = ("src/repro_torch/serving/scheduler.py",
             "src/repro_torch/serving/staging.py",
             "src/repro_torch/serving/session.py",
             "src/repro_torch/serving/stream_source.py",
             "src/repro_torch/serving/ingest.py",
             "src/repro_torch/serving/autopilot.py",
             "src/repro_torch/launch/batching.py")
    # stage/poll/dispatch-phase functions: must never wait on the device.
    # The ingest worker's drain path (drain/_poll_one/_poll_round/attach/
    # detach/has_pending) and the depth autopilot's evaluation path
    # (decide/observe/_apply_autopilot) run on or gate the stage critical
    # path — a hidden sync there stalls the grid exactly like one in
    # _stage_body would
    HOT_FUNCS = {"step", "submit", "push", "pop", "push_events", "pop_chunk",
                 "poll", "_stage", "_stage_body", "_poll_sources", "_admit",
                 "_dispatch", "_feed_tokens", "_replace_lanes", "tick",
                 "drain", "_poll_one", "_poll_round", "attach", "detach",
                 "has_pending", "decide", "observe", "_apply_autopilot",
                 "set_depth"}
    # names that (by repo convention) hold device arrays in these modules
    DEVICE_HINTS = ("deltas", "state", "metrics", "logits", "pre_mag",
                    "post_mag", "cache", "wc")
    # .item() / .tolist() copy to the host and wait; torch.cuda.synchronize()
    # and a stream's or event's .synchronize() wait by definition
    ALWAYS_SYNC_ATTRS = ("item", "tolist", "synchronize")
    # copies to the host that wait only when the receiver lives on the card
    HINTED_SYNC_ATTRS = ("cpu", "numpy")

    def applies(self, path: str) -> bool:
        return path in self.SCOPE

    def _mentions_device(self, node: ast.AST) -> bool:
        src = _src(node)
        return any(re.search(rf"\b{h}\b", src) for h in self.DEVICE_HINTS)

    def check(self, mod: Module) -> Iterator[LintViolation]:
        if mod.tree is None:
            return
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name not in self.HOT_FUNCS:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in self.ALWAYS_SYNC_ATTRS):
                    yield self._v(mod, node.lineno,
                                  f"`{_src(node)[:60]}` blocks on the device "
                                  f"inside hot-phase `{fn.name}` — only the "
                                  f"retire phase may wait")
                elif (isinstance(f, ast.Attribute)
                        and f.attr in self.HINTED_SYNC_ATTRS
                        and self._mentions_device(f.value)):
                    yield self._v(mod, node.lineno,
                                  f"`.{f.attr}()` of device state "
                                  f"(`{_src(f.value)[:50]}`) in hot-phase "
                                  f"`{fn.name}` forces a sync — fetch at "
                                  f"retire instead")
                elif (isinstance(f, ast.Attribute)
                        and f.attr in ("asarray", "array")
                        and isinstance(f.value, ast.Name)
                        and f.value.id in ("np", "numpy")
                        and node.args and self._mentions_device(node.args[0])):
                    yield self._v(mod, node.lineno,
                                  f"`np.{f.attr}` on device state "
                                  f"(`{_src(node.args[0])[:50]}`) in hot-"
                                  f"phase `{fn.name}` forces a sync — fetch "
                                  f"at retire instead")
                elif (isinstance(f, ast.Name)
                        and f.id in ("float", "int", "bool")
                        and node.args and self._mentions_device(node.args[0])):
                    yield self._v(mod, node.lineno,
                                  f"`{f.id}(...)` on device state "
                                  f"(`{_src(node.args[0])[:50]}`) in hot-"
                                  f"phase `{fn.name}` forces a sync — fetch "
                                  f"at retire instead")


def _growable_attrs(cls: ast.ClassDef) -> Dict[str, int]:
    """``{attr: lineno}`` for self attributes initialized as a bare list/
    dict/set (or a deque without maxlen) in __init__/__post_init__."""
    out: Dict[str, int] = {}
    for fn in cls.body:
        if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name in ("__init__", "__post_init__")):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            elif isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            else:
                continue
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                if isinstance(value, (ast.List, ast.Dict, ast.Set)) \
                        and not getattr(value, "elts", None) \
                        and not getattr(value, "keys", None):
                    out[t.attr] = node.lineno
                elif isinstance(value, ast.Call):
                    callee = value.func
                    nm = (callee.id if isinstance(callee, ast.Name)
                          else getattr(callee, "attr", ""))
                    if nm in ("list", "dict", "set"):
                        out[t.attr] = node.lineno
                    elif nm == "deque":
                        has_maxlen = any(kw.arg == "maxlen"
                                         for kw in value.keywords) \
                            or len(value.args) >= 2
                        if not has_maxlen:
                            out[t.attr] = node.lineno
    return out


_GROW_METHODS = ("append", "appendleft", "extend", "insert", "add",
                 "setdefault")


@register_rule
class UnboundedGrowthRule(Rule):
    """OBS01 — telemetry/obs containers must be bounded."""

    id = "OBS01"
    title = "unbounded container growth in obs/telemetry state"

    def applies(self, path: str) -> bool:
        return (path.startswith("src/repro_torch/obs/")
                or path == "src/repro_torch/serving/telemetry.py")

    def check(self, mod: Module) -> Iterator[LintViolation]:
        if mod.tree is None:
            return
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            growable = _growable_attrs(cls)
            if not growable:
                continue
            for fn in cls.body:
                if not (isinstance(fn, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                        and fn.name not in ("__init__", "__post_init__")):
                    continue
                for node in ast.walk(fn):
                    attr = self._grown_attr(node)
                    if attr and attr in growable:
                        yield self._v(
                            mod, node.lineno,
                            f"`self.{attr}` (initialized unbounded at line "
                            f"{growable[attr]}) grows in "
                            f"`{cls.name}.{fn.name}` — use a maxlen ring, "
                            f"a histogram, or registry counters (memory "
                            f"must be O(1) in steps/streams)")

    @staticmethod
    def _grown_attr(node: ast.AST) -> Optional[str]:
        # self.X.append(...) / extend / add / insert / setdefault
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            f = node.func
            if (f.attr in _GROW_METHODS and isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id == "self"):
                return f.value.attr
        # self.X[key] = ...
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Attribute)
                        and isinstance(t.value.value, ast.Name)
                        and t.value.value.id == "self"):
                    return t.value.attr
        return None


@register_rule
class UnlockedMutationRule(Rule):
    """OBS02 — shared obs state mutates only under its lock."""

    id = "OBS02"
    title = "mutation of shared obs state outside its lock"

    LOCK_ATTRS = ("_lock", "lock")
    MUTATORS = _GROW_METHODS + ("pop", "popleft", "remove", "clear",
                                "update", "discard")

    def applies(self, path: str) -> bool:
        return (path.startswith("src/repro_torch/obs/")
                or path == "src/repro_torch/serving/telemetry.py"
                or path == "src/repro_torch/serving/ingest.py")

    def check(self, mod: Module) -> Iterator[LintViolation]:
        if mod.tree is None:
            return
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if not self._has_lock(cls):
                continue
            for fn in cls.body:
                if not (isinstance(fn, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                        and fn.name not in ("__init__", "__post_init__")):
                    continue
                yield from self._walk(mod, cls, fn, fn.body,
                                      under_lock=False)

    def _has_lock(self, cls: ast.ClassDef) -> bool:
        for fn in cls.body:
            if (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and fn.name in ("__init__", "__post_init__")):
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign):
                        for t in node.targets:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"
                                    and t.attr in self.LOCK_ATTRS):
                                return True
        return False

    def _is_lock_with(self, node: ast.With) -> bool:
        for item in node.items:
            e = item.context_expr
            if (isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name)
                    and e.value.id == "self" and e.attr in self.LOCK_ATTRS):
                return True
        return False

    def _walk(self, mod: Module, cls: ast.ClassDef, fn, body,
              under_lock: bool) -> Iterator[LintViolation]:
        for node in body:
            if isinstance(node, ast.With):
                inner = under_lock or self._is_lock_with(node)
                yield from self._walk(mod, cls, fn, node.body, inner)
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue          # nested defs: their own discipline
            if not under_lock:
                for desc in self._mutations(node):
                    yield self._v(
                        mod, desc[1],
                        f"`{desc[0]}` mutates `{cls.name}` state in "
                        f"`{fn.name}` outside `with self._lock` — shared "
                        f"obs state must mutate under its lock")
            # recurse into compound statements (if/for/try/...)
            for child_body in self._child_bodies(node):
                yield from self._walk(mod, cls, fn, child_body, under_lock)

    @staticmethod
    def _child_bodies(node: ast.AST):
        for field in ("body", "orelse", "finalbody"):
            b = getattr(node, field, None)
            if isinstance(b, list):
                yield b
        for h in getattr(node, "handlers", []) or []:
            yield h.body

    def _mutations(self, node: ast.AST) -> Iterator[Tuple[str, int]]:
        """(description, lineno) for depth-1 self-attribute mutations in
        this single statement (not recursing into child statement bodies —
        the caller handles those with lock tracking)."""
        def self_attr(t) -> Optional[str]:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                return f"self.{t.attr}"
            if (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Attribute)
                    and isinstance(t.value.value, ast.Name)
                    and t.value.value.id == "self"):
                return f"self.{t.value.attr}[...]"
            return None

        for sub in self._depth1(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    d = self_attr(t)
                    if d:
                        yield (f"{d} {'+' if isinstance(sub, ast.AugAssign) else ''}=",
                               sub.lineno)
            elif (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in self.MUTATORS):
                d = self_attr(sub.func.value)
                if d:
                    yield (f"{d}.{sub.func.attr}()", sub.lineno)

    @staticmethod
    def _depth1(node: ast.AST) -> Iterator[ast.AST]:
        """Like ``ast.walk`` but stops at child statement bodies —
        ``_walk`` visits those itself with lock tracking, so a
        ``with self._lock:`` nested in a loop/try is honored instead of
        its contents being flagged (and double-counted) via the
        enclosing compound statement."""
        stack = [node]
        while stack:
            sub = stack.pop()
            yield sub
            for field, value in ast.iter_fields(sub):
                if field in ("body", "orelse", "finalbody", "handlers"):
                    continue
                if isinstance(value, ast.AST):
                    stack.append(value)
                elif isinstance(value, list):
                    stack.extend(v for v in value if isinstance(v, ast.AST))


@register_rule
class HostOnlyImportRule(Rule):
    """HOST01 — host-only modules never import the device runtime."""

    id = "HOST01"
    title = "torch import in a host-only module"

    SCOPE_PREFIXES = ("src/repro_torch/obs/",)
    SCOPE_FILES = ("src/repro_torch/serving/telemetry.py",
                   "src/repro_torch/serving/staging.py",
                   "src/repro_torch/serving/stream_source.py",
                   "src/repro_torch/serving/ingest.py",
                   "src/repro_torch/serving/autopilot.py",
                   "src/repro_torch/analysis/lint.py")
    DEVICE_RUNTIMES = ("torch", "triton")

    def applies(self, path: str) -> bool:
        return (any(path.startswith(p) for p in self.SCOPE_PREFIXES)
                or path in self.SCOPE_FILES)

    def check(self, mod: Module) -> Iterator[LintViolation]:
        if mod.tree is None:
            return
        for node in mod.tree.body:       # module level only — lazy is fine
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in self.DEVICE_RUNTIMES:
                    yield self._v(
                        mod, node.lineno,
                        f"module-level `import {name}` in a host-only "
                        f"module — import lazily inside the function that "
                        f"needs it, or move the device code out")


_FENCE_RE = re.compile(r"^```([^\n`]*)\n(.*?)^```\s*$", re.M | re.S)
_PYTHONISH = re.compile(
    r"^\s*(from\s+\w[\w.]*\s+import\s|import\s+\w|def\s+\w+\(|class\s+\w+\b)",
    re.M)


@register_rule
class DocsFenceRule(Rule):
    """DOC01 — python-looking docs fences must be tagged for the
    executable-docs tripwire."""

    id = "DOC01"
    title = "untagged python-looking docs code fence"

    def applies(self, path: str) -> bool:
        return path.endswith(".md") and (path.startswith("docs/")
                                         or path == "README.md")

    def check(self, mod: Module) -> Iterator[LintViolation]:
        for m in _FENCE_RE.finditer(mod.text):
            info, body = m.group(1).strip(), m.group(2)
            if info:
                continue
            if _PYTHONISH.search(body):
                lineno = mod.text[:m.start()].count("\n") + 1
                yield self._v(
                    mod, lineno,
                    "bare ``` fence with python-looking content dodges the "
                    "executable-docs check — tag it ```python (executed) "
                    "or ```python noexec (illustration)")


# --------------------------------------------------------------------------
# suppression, baseline, entry points
# --------------------------------------------------------------------------

def _suppressed(mod: Module, v: LintViolation) -> bool:
    pat = _SUPPRESS_MD if mod.path.endswith(".md") else _SUPPRESS_PY
    for lineno in (v.line, v.line - 1):
        m = pat.search(mod.line_text(lineno))
        if m and v.rule in re.split(r"\s*,\s*", m.group(1)):
            return True
    return False


def lint_module(mod: Module) -> List[LintViolation]:
    out = []
    for rule in RULES.values():
        if rule.applies(mod.path):
            out.extend(v for v in rule.check(mod) if not _suppressed(mod, v))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_source(relpath: str, text: str) -> List[LintViolation]:
    """Lint a source snippet as if it lived at ``relpath`` (repo-relative).
    The unit-test / fixture entry point."""
    return lint_module(Module(relpath, text))


def iter_files(root: pathlib.Path, paths: Sequence[str]) -> Iterator[pathlib.Path]:
    for p in paths:
        fp = root / p
        if fp.is_file():
            yield fp
        elif fp.is_dir():
            for child in sorted(fp.rglob("*")):
                if child.suffix in (".py", ".md") and child.is_file():
                    yield child


def lint_paths(root: pathlib.Path,
               paths: Sequence[str] = DEFAULT_PATHS) -> List[LintViolation]:
    out = []
    for fp in iter_files(root, paths):
        rel = fp.relative_to(root).as_posix()
        out.extend(lint_module(Module(rel, fp.read_text())))
    return out


def load_baseline(path: pathlib.Path) -> List[dict]:
    if not path.exists():
        return []
    doc = json.loads(path.read_text())
    return doc.get("entries", [])


def write_baseline(path: pathlib.Path,
                   violations: Sequence[LintViolation]) -> dict:
    doc = {
        "version": 1,
        "comment": ("accepted lint findings — keyed by (rule, path, line "
                    "text) so line drift never churns this file; add a "
                    "`reason` when you accept one (see docs/ANALYSIS.md)"),
        "entries": [{
            "rule": v.rule, "path": v.path,
            "line_text": v.line_text.strip(), "reason": ""}
            for v in violations],
    }
    path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return doc


def apply_baseline(violations: Sequence[LintViolation],
                   entries: Sequence[dict]
                   ) -> Tuple[List[LintViolation], List[dict]]:
    """(new_violations, stale_baseline_entries)."""
    known: Set[Tuple[str, str, str]] = {
        (e["rule"], e["path"], e["line_text"]) for e in entries}
    new = [v for v in violations if v.baseline_key not in known]
    hit = {v.baseline_key for v in violations}
    stale = [e for e in entries
             if (e["rule"], e["path"], e["line_text"]) not in hit]
    return new, stale


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="host-path lint (see docs/ANALYSIS.md for the rules)")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/dirs to lint, relative to --root")
    ap.add_argument("--root", default=str(REPO_ROOT),
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", nargs="?", const=DEFAULT_BASELINE,
                    default=None, metavar="PATH",
                    help="filter findings through the checked-in baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write machine-readable results ('-' for stdout)")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.root).resolve()
    violations = lint_paths(root, args.paths)

    if args.write_baseline:
        bp = root / (args.baseline or DEFAULT_BASELINE)
        write_baseline(bp, violations)
        print(f"wrote {len(violations)} entries to {bp}")
        return 0

    stale: List[dict] = []
    if args.baseline is not None:
        entries = load_baseline(root / args.baseline)
        violations, stale = apply_baseline(violations, entries)

    if args.json:
        doc = {
            "schema": "repro-lint/1",
            "violations": [dataclasses.asdict(v) for v in violations],
            "stale_baseline": stale,
        }
        if args.json == "-":
            json.dump(doc, sys.stdout, indent=1, sort_keys=True)
            print()
        else:
            pathlib.Path(args.json).write_text(
                json.dumps(doc, indent=1, sort_keys=True) + "\n")

    for v in violations:
        print(v.render())
    for e in stale:
        print(f"stale baseline entry (fixed? remove it): "
              f"{e['rule']} {e['path']} `{e['line_text']}`")
    n = len(violations)
    print(f"{n} violation(s)" + (" — lint clean" if n == 0 else ""))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
