"""Static analysis (lint) and runtime checks of the port — the counterpart
of ``repro.analysis``.

  * **lint** — ``python -m repro_torch.analysis src/repro_torch`` runs an
    AST rule engine (per-rule severity, ``# repro: ignore[rule-id]``
    suppressions, JSON + human output) over the tree; ``src/repro_torch``
    is kept at zero findings.  The rules are the port's counterparts of
    the reference's six (:mod:`repro_torch.analysis.rules`).
  * **sanitize** — the runtime layer: NaN/Inf checks and candidate / dq
    domain validation on the scoring path, off by default.

    from repro_torch import analysis
    report = analysis.lint_paths(["src/repro_torch"])   # static pass
    with analysis.sanitize.sanitized():
        ev.score_grid(xs, coms)                          # runtime guards
"""

from repro_torch.analysis import rules as _rules  # noqa: F401 — registers rules
from repro_torch.analysis import sanitize
from repro_torch.analysis.engine import (RULES, Finding, Rule, lint_file,
                                         lint_paths, lint_source,
                                         render_human, render_json)
from repro_torch.analysis.errors import AnalysisError

__all__ = [
    "AnalysisError", "Finding", "Rule", "RULES",
    "lint_file", "lint_paths", "lint_source",
    "render_human", "render_json", "sanitize",
]
