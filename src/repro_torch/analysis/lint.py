"""Repo-specific AST lint over the port (port of `repro.analysis.lint`).

Three rules, each encoding a discipline the port's performance or
durability story depends on:

* ``host-sync``       — inside *hot zones* (`HOT_ZONES`: the serve
  decode/admission path, the engine decode loop, the graph replay of
  `retrace.guard_graph`, the per-leaf pipeline sentinels, the Gram
  all-reduce, the observability hooks), flag calls
  that make the host wait for the card: `.item()`, `.cpu()`,
  `.tolist()`, `.numpy()`, `torch.cuda.synchronize(...)` (and a stream's
  or an event's `.synchronize()`),
  `np.asarray(...)`/`np.array(...)` of a call, and `float(...)`/
  `int(...)` of a call. Pulling the sampled tokens is the step's one
  sync by design; such sites carry a pragma, and anything unannotated is
  a new stall on the hot path.
* ``time-in-capture`` — a wall clock (`time.time()`/`perf_counter()`/
  `monotonic()`) inside code that is captured and replayed: a function
  given to `torch.compile` (or decorated with it), to
  `make_graphed_callables` or to `retrace.guard_graph` (the serving
  steps' and prefills' graphs), and the body of a `with
  torch.cuda.graph(...)` block. The clock runs once, at capture, and never again (JAX's
  `time-in-jit`).
* ``fsync-before-replace`` — in `ft/` and `ckpt/`, every `os.replace`
  must be lexically preceded, in the same function, by an fsync-ish call
  (a name containing "fsync"): an un-fsynced rename is atomic but not
  durable.

Intentional sites are annotated ``# comq: allow(<rule>)`` on the same
line or the line above; the pragma names the rule it waives (comma-
separated for several). Findings are (path, line, rule, message):
`lint_paths` walks a tree, `lint_source` lints a snippet.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple

RULES = ("host-sync", "time-in-capture", "fsync-before-replace")

# relpath (under src/repro_torch, "/"-separated) -> qualnames whose bodies
# are decode/solve hot loops: any host sync inside runs once per step/leaf.
# The JAX package's zones, each under the same qualname in the port.
HOT_ZONES: Dict[str, Tuple[str, ...]] = {
    "serve/runtime.py": ("Runtime.step", "Runtime._admit_one",
                         "Runtime.run", "Runtime._emit",
                         "Runtime._clear_slot", "Runtime._retire"),
    "serve/engine.py": ("Engine.generate_batch", "Engine._static_cache",
                        "_decode_into"),
    # the signature check and graph replay every serving step goes through
    "analysis/retrace.py": ("guard_graph.guarded", "guard_fn.guarded"),
    "core/guards.py": ("nonfinite_count", "sanitize_array", "gram_health",
                       "result_ok", "guarded_solve"),
    "core/pipeline.py": ("_results_finite", "_RunCtx.commit",
                         "_finalize_report", "_timed_solve"),
    "dist/calibrate.py": ("sharded_gram", "sharded_batched_gram"),
    # observability hooks run once per token/leaf from inside the zones
    # above: they must stay append-only host work
    "obs/trace.py": ("Tracer.span", "Tracer.instant",
                     "Tracer.request_event", "Tracer.token_event",
                     "Span.__exit__"),
    "obs/metrics.py": ("Counter.inc", "Gauge.set", "Gauge.add",
                       "Histogram.observe"),
}

# dirs (relative to the package root) under the durability rule
DURABLE_DIRS = ("ft", "ckpt")

_TIME_CALLS = {"time", "perf_counter", "monotonic"}
_CAPTURE_FNS = {"compile", "make_graphed_callables", "guard_graph"}
_SYNC_METHODS = {"item": ".item() copies a device scalar to the host and "
                         "waits for it",
                 "cpu": ".cpu() copies a device tensor to the host and "
                        "waits for it",
                 "tolist": ".tolist() copies a device tensor to the host "
                           "and waits for it",
                 "numpy": ".numpy() needs a host tensor: the device value "
                          "was pulled and waited for"}

_PRAGMA_RE = re.compile(r"#\s*comq:\s*allow\(([^)]*)\)")


@dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _pragmas(src: str) -> Dict[int, Set[str]]:
    """line -> set of waived rules, from `# comq: allow(rule[, rule])`."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _dotted(f: ast.AST) -> str:
    """Dotted-ish name of an expression: 'torch.cuda.synchronize',
    'x.item', 'float', ... (tail attributes only; subscripts etc. ->
    '<expr>')."""
    parts: List[str] = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    elif parts:
        parts.append("<expr>")
    else:
        return ""
    return ".".join(reversed(parts))


def _call_name(node: ast.Call) -> str:
    return _dotted(node.func)


# ---------------------------------------------------------------------------
# rule: host-sync (hot zones)
# ---------------------------------------------------------------------------

def _host_sync_reason(call: ast.Call) -> str:
    name = _call_name(call)
    head, _, tail = name.rpartition(".")
    if head and tail in _SYNC_METHODS and not call.args:
        return _SYNC_METHODS[tail]
    if tail == "synchronize":
        return (f"{name}() stalls the host until the card (or the stream, "
                "or the event) drains")
    if (name in ("np.asarray", "np.array", "numpy.asarray", "numpy.array")
            and call.args and isinstance(call.args[0], ast.Call)):
        return (f"{name}(...) of a device value blocks until it reaches "
                "the host")
    if (name in ("float", "int") and call.args
            and isinstance(call.args[0], ast.Call)
            and _call_name(call.args[0]) != "len"):
        return (f"{name}(<call>) pulls a device scalar to the host "
                "synchronously")
    return ""


class _FuncIndexer(ast.NodeVisitor):
    """Collects every FunctionDef with its dotted qualname."""

    def __init__(self):
        self.funcs: List[Tuple[str, ast.AST]] = []
        self._stack: List[str] = []

    def _visit_fn(self, node):
        self._stack.append(node.name)
        self.funcs.append((".".join(self._stack), node))
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_fn(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_fn(node)

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()


def qualnames(tree: ast.AST) -> Set[str]:
    idx = _FuncIndexer()
    idx.visit(tree)
    return {q for q, _ in idx.funcs}


def _lint_host_sync(tree: ast.AST, relpath: str) -> List[Tuple[int, str]]:
    zones = HOT_ZONES.get(relpath)
    if not zones:
        return []
    idx = _FuncIndexer()
    idx.visit(tree)
    out: List[Tuple[int, str]] = []
    for qualname, fn in idx.funcs:
        if qualname not in zones:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                reason = _host_sync_reason(node)
                if reason:
                    out.append((node.lineno,
                                f"host sync in hot zone {qualname}: "
                                f"{reason}"))
    return out


# ---------------------------------------------------------------------------
# rule: time-in-capture
# ---------------------------------------------------------------------------

def _is_capture_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _call_name(node).rsplit(".", 1)[-1] in _CAPTURE_FNS)


def _captured_bodies(tree: ast.AST) -> List[ast.AST]:
    """Functions, lambdas and `with torch.cuda.graph(...)` blocks whose
    code is captured once and replayed."""
    names: Set[str] = set()
    bodies: List[ast.AST] = []
    for node in ast.walk(tree):
        if _is_capture_call(node):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Name):
                    names.add(arg.id)
                elif isinstance(arg, ast.Lambda):
                    bodies.append(arg)
                elif isinstance(arg, (ast.Tuple, ast.List)):
                    names |= {e.id for e in arg.elts
                              if isinstance(e, ast.Name)}
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(it.context_expr, ast.Call)
                   and _call_name(it.context_expr).rsplit(".", 1)[-1]
                   == "graph" for it in node.items):
                bodies.extend(node.body)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if _dotted(target).rsplit(".", 1)[-1] in _CAPTURE_FNS:
                    names.add(node.name)
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in names):
            bodies.append(node)
    return bodies


def _lint_time_in_capture(tree: ast.AST, relpath: str
                          ) -> List[Tuple[int, str]]:
    out: List[Tuple[int, str]] = []
    seen: Set[int] = set()
    for body in _captured_bodies(tree):
        for node in ast.walk(body):
            if isinstance(node, ast.Call) and id(node) not in seen:
                name = _call_name(node)
                head, _, tail = name.rpartition(".")
                if head == "time" and tail in _TIME_CALLS:
                    seen.add(id(node))
                    out.append((node.lineno,
                                f"{name}() inside captured code runs once "
                                "at capture and never on replay"))
    return out


# ---------------------------------------------------------------------------
# rule: fsync-before-replace (ft/ + ckpt/ durability)
# ---------------------------------------------------------------------------

def _lint_fsync_replace(tree: ast.AST, relpath: str) -> List[Tuple[int, str]]:
    top = relpath.split("/", 1)[0]
    if top not in DURABLE_DIRS:
        return []
    idx = _FuncIndexer()
    idx.visit(tree)
    out: List[Tuple[int, str]] = []
    for qualname, fn in idx.funcs:
        replaces = []
        fsync_lines = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _call_name(node)
                if name == "os.replace":
                    replaces.append(node.lineno)
                elif "fsync" in name.rsplit(".", 1)[-1].lower():
                    fsync_lines.append(node.lineno)
        for line in replaces:
            if not any(fl < line for fl in fsync_lines):
                out.append((line,
                            f"os.replace in {qualname} with no preceding "
                            "fsync in the same function — the rename is "
                            "atomic but the contents are not durable"))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

_RULE_FNS = {
    "host-sync": _lint_host_sync,
    "time-in-capture": _lint_time_in_capture,
    "fsync-before-replace": _lint_fsync_replace,
}


def lint_source(src: str, relpath: str) -> List[LintFinding]:
    """Lint one file's source. `relpath` is the path under the package
    root ("/"-separated), which selects hot zones and durable dirs."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [LintFinding(relpath, e.lineno or 0, "parse-error", str(e))]
    pragmas = _pragmas(src)

    def waived(line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            if rule in pragmas.get(ln, ()):
                return True
        return False

    findings: List[LintFinding] = []
    for rule, fn in _RULE_FNS.items():
        for line, msg in fn(tree, relpath):
            if not waived(line, rule):
                findings.append(LintFinding(relpath, line, rule, msg))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def _package_relpath(path: str, root: str) -> str:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    # HOT_ZONES/DURABLE_DIRS are keyed under src/repro_torch
    for prefix in ("src/repro_torch/", "repro_torch/"):
        if rel.startswith(prefix):
            return rel[len(prefix):]
    return rel


def lint_paths(paths: Sequence[str], root: str = ".") -> List[LintFinding]:
    """Lint every .py file under `paths` (files or directories)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, _, names in os.walk(p):
                files += [os.path.join(dirpath, n) for n in names
                          if n.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
    findings: List[LintFinding] = []
    for f in sorted(files):
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        rel = _package_relpath(f, root)
        for finding in lint_source(src, rel):
            findings.append(LintFinding(
                os.path.relpath(f, root), finding.line, finding.rule,
                finding.message))
    return findings
