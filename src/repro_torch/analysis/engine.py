"""Rule engine of the ``repro_torch.analysis`` linter — a copy of
``repro.analysis.engine`` (the port imports nothing of ``repro``) with the
facts its rules need for eager PyTorch.

The linter is AST-based and repo-aware: a :class:`LintContext` parses one
file and precomputes the facts every rule needs — import aliases resolved
to canonical dotted names (``F`` → ``torch.nn.functional``), the set of
RE-RUN functions (handed to ``torch.utils.checkpoint.checkpoint`` /
``remat_wrap``, which run them again in the backward, or to
``torch.jit.trace`` / ``torch.compile`` / CUDA-graph capture, which run
their Python once), parent links, and suppression comments.  Rules (:mod:`repro_torch.analysis.rules`) register themselves
in :data:`RULES` and yield ``(node, message)`` pairs; the engine attaches
severity, applies ``# repro: ignore[rule-id]`` suppressions, and renders
human or JSON output.

Suppressions:

  * same-line: ``expr  # repro: ignore[rule-id]`` (comma-separate several
    ids; bare ``# repro: ignore`` silences every rule on that line);
  * file-level: ``# repro: ignore-file[rule-id]`` anywhere in the file.

Exit policy: findings carry a per-rule severity (``error`` / ``warning``);
only errors fail the run (``--strict`` promotes warnings).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Callable, Iterable, Iterator

__all__ = ["Finding", "Rule", "RULES", "rule", "LintContext", "lint_file",
           "lint_source", "lint_paths", "iter_python_files",
           "render_human", "render_json", "DEFAULT_EXCLUDED_DIRS"]

SEVERITIES = ("error", "warning")

# directories never linted by default: fixture trees deliberately contain
# rule violations, caches/VCS internals are noise
DEFAULT_EXCLUDED_DIRS = frozenset(
    {"fixtures", "__pycache__", ".git", ".venv", "node_modules"})

_IGNORE_RE = re.compile(
    r"#\s*repro:\s*ignore(?:-file)?(?:\[([A-Za-z0-9_,\- ]+)\])?")
_IGNORE_FILE_RE = re.compile(
    r"#\s*repro:\s*ignore-file(?:\[([A-Za-z0-9_,\- ]+)\])?")

# wrappers whose function arguments do not run once per call as written:
# activation checkpointing runs them again in the backward, tracing and
# graph capture run their Python once and replay only the tensor work
TRACE_WRAPPERS = frozenset({
    "torch.utils.checkpoint.checkpoint", "torch.jit.trace",
    "torch.jit.script", "torch.compile", "torch.cuda.make_graphed_callables",
})
# the port's own activation-checkpoint wrapper, by the last part of its
# resolved name (``repro_torch.models.transformer.remat_wrap``)
TRACE_WRAPPER_SUFFIXES = ("remat_wrap",)


def is_trace_wrapper(name: str | None) -> bool:
    return bool(name) and (name in TRACE_WRAPPERS or name.rsplit(
        ".", 1)[-1] in TRACE_WRAPPER_SUFFIXES)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: where, which rule, how bad, and why."""

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity}[{self.rule}] {self.message}")

    def row(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered rule: id, default severity, one-line summary, and the
    check itself — ``check(ctx)`` yields ``(ast.AST | (line, col), msg)``."""

    id: str
    severity: str
    summary: str
    check: Callable[["LintContext"], Iterable[tuple]]


RULES: dict[str, Rule] = {}


def rule(rule_id: str, severity: str = "error", summary: str = ""):
    """Register a rule function under ``rule_id`` (kebab-case)."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}")

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, severity, summary or (fn.__doc__ or
                                                             "").strip(), fn)
        return fn

    return deco


def _parse_suppressions(source: str) -> tuple[dict[int, set], set]:
    """line → suppressed rule ids ({"*"} = all); plus file-level ids."""
    per_line: dict[int, set] = {}
    file_level: set = set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _IGNORE_RE.search(tok.string)
            if not m:
                continue
            ids = ({i.strip() for i in m.group(1).split(",") if i.strip()}
                   if m.group(1) else {"*"})
            if _IGNORE_FILE_RE.search(tok.string):
                file_level |= ids
            else:
                per_line.setdefault(tok.start[0], set()).update(ids)
    except tokenize.TokenError:
        pass
    return per_line, file_level


class LintContext:
    """Parsed file + precomputed facts shared by every rule."""

    def __init__(self, path: str, source: str, tree: ast.AST):
        self.path = path
        self.source = source
        self.tree = tree
        self.suppress_lines, self.suppress_file = _parse_suppressions(source)
        self._parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
        self.imports = self._collect_imports()
        self.traced = self._collect_traced()

    # -- imports / name resolution -------------------------------------------
    def _collect_imports(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def resolve(self, node) -> str | None:
        """Canonical dotted name of a Name/Attribute chain, through the
        file's import aliases (``F.linear`` → ``torch.nn.functional.linear``)."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.imports.get(node.id, node.id))
        return ".".join(reversed(parts))

    def imports_module(self, prefix: str) -> bool:
        return any(m == prefix or m.startswith(prefix + ".")
                   for m in self.imports.values())

    # -- re-run-function discovery -------------------------------------------
    def _collect_traced(self) -> set:
        """The functions a trace wrapper re-runs or traces: a wrapper's
        callable is its first positional argument, a lambda or a function
        named there (by name or as ``obj.method``), or a function it
        decorates."""
        traced: set = set()
        traced_names: set[str] = set()

        def wrapper_of(call: ast.Call) -> str | None:
            name = self.resolve(call.func)
            if is_trace_wrapper(name):
                return name
            # functools.partial(torch.compile, ...) used as wrapper or
            # decorator
            if name in ("functools.partial", "partial") and call.args:
                inner = self.resolve(call.args[0])
                if is_trace_wrapper(inner):
                    return inner
            return None

        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    name = self.resolve(dec) if not isinstance(dec, ast.Call) \
                        else wrapper_of(dec)
                    if is_trace_wrapper(name):
                        traced.add(node)
            elif isinstance(node, ast.Call):
                if wrapper_of(node) is None or not node.args:
                    continue
                fn = node.args[0]
                if self.resolve(node.func) in ("functools.partial",
                                               "partial"):
                    fn = node.args[1] if len(node.args) > 1 else None
                if isinstance(fn, ast.Lambda):
                    traced.add(fn)
                elif isinstance(fn, ast.Name):
                    traced_names.add(fn.id)
                elif isinstance(fn, ast.Attribute):
                    traced_names.add(fn.attr)

        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in traced_names:
                traced.add(node)
        return traced

    # -- tree navigation ------------------------------------------------------
    def parent(self, node) -> ast.AST | None:
        return self._parents.get(node)

    def ancestors(self, node) -> Iterator[ast.AST]:
        node = self._parents.get(node)
        while node is not None:
            yield node
            node = self._parents.get(node)

    def enclosing_function(self, node):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return anc
        return None

    def in_traced(self, node) -> bool:
        """True when any enclosing function/lambda is re-run or traced by a
        trace wrapper (see :data:`TRACE_WRAPPERS`)."""
        for anc in self.ancestors(node):
            if anc in self.traced:
                return True
        return False

    def in_loop(self, node) -> bool:
        """True when the node sits inside a for/while/comprehension body,
        stopping at the nearest enclosing function boundary."""
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return False
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While,
                                ast.ListComp, ast.SetComp, ast.DictComp,
                                ast.GeneratorExp)):
                return True
        return False

    def enclosing_loops(self, node) -> Iterator[ast.AST]:
        """Every for/while loop around the node, innermost first, crossing
        function boundaries (for closure-capture checks)."""
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
                yield anc

    # -- suppression -----------------------------------------------------------
    def suppressed(self, rule_id: str, line: int) -> bool:
        if "*" in self.suppress_file or rule_id in self.suppress_file:
            return True
        ids = self.suppress_lines.get(line)
        return ids is not None and ("*" in ids or rule_id in ids)


def _loc(node) -> tuple[int, int]:
    if isinstance(node, tuple):
        return node
    return (getattr(node, "lineno", 1), getattr(node, "col_offset", 0) + 1)


def lint_source(path: str, source: str,
                select: set[str] | None = None) -> tuple[list[Finding], int]:
    """Lint one source string → (findings, n_suppressed).  ``select``
    restricts to a subset of rule ids (default: all registered)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("syntax", "error", path, e.lineno or 1,
                        (e.offset or 0) + 1, f"syntax error: {e.msg}")], 0
    ctx = LintContext(path, source, tree)
    findings: list[Finding] = []
    suppressed = 0
    for rid, r in sorted(RULES.items()):
        if select is not None and rid not in select:
            continue
        for item in r.check(ctx):
            node, message = item[0], item[1]
            severity = item[2] if len(item) > 2 else r.severity
            line, col = _loc(node)
            if ctx.suppressed(rid, line):
                suppressed += 1
                continue
            findings.append(Finding(rid, severity, path, line, col, message))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings, suppressed


def lint_file(path, select: set[str] | None = None
              ) -> tuple[list[Finding], int]:
    p = Path(path)
    return lint_source(str(p), p.read_text(encoding="utf-8"), select=select)


def iter_python_files(paths: Iterable,
                      excluded_dirs: frozenset = DEFAULT_EXCLUDED_DIRS
                      ) -> Iterator[Path]:
    seen = set()
    for raw in paths:
        p = Path(raw)
        files = [p] if p.is_file() else sorted(
            f for f in p.rglob("*.py")
            if not (set(f.parts) & excluded_dirs))
        for f in files:
            if f.suffix == ".py" and f not in seen:
                seen.add(f)
                yield f


def lint_paths(paths: Iterable, select: set[str] | None = None,
               excluded_dirs: frozenset = DEFAULT_EXCLUDED_DIRS) -> dict:
    """Lint every ``*.py`` under ``paths`` → report dict (see
    :func:`render_json` for the schema)."""
    findings: list[Finding] = []
    n_suppressed = 0
    n_files = 0
    for f in iter_python_files(paths, excluded_dirs):
        n_files += 1
        fs, sup = lint_file(f, select=select)
        findings.extend(fs)
        n_suppressed += sup
    return {
        "version": 1,
        "paths": [str(p) for p in paths],
        "files_checked": n_files,
        "counts": {
            "error": sum(f.severity == "error" for f in findings),
            "warning": sum(f.severity == "warning" for f in findings),
            "suppressed": n_suppressed,
        },
        "findings": [f.row() for f in findings],
    }


def render_human(report: dict) -> str:
    lines = [Finding(**row).render() for row in report["findings"]]
    c = report["counts"]
    lines.append(f"{c['error']} error(s), {c['warning']} warning(s), "
                 f"{c['suppressed']} suppressed — "
                 f"{report['files_checked']} file(s) checked")
    return "\n".join(lines)


def render_json(report: dict) -> str:
    return json.dumps(report, indent=2)
