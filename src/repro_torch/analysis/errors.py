"""Typed errors for the analysis subsystem (copy of
``repro.analysis.errors`` for the PyTorch port).

:class:`AnalysisError` is raised by the runtime sanitizer
(:mod:`repro_torch.analysis.sanitize`) — it names the violated rule and
carries structured context (the offending array name, ...) so a failure
points at the call site's data instead of a NaN three layers later.
"""

from __future__ import annotations

__all__ = ["AnalysisError"]


class AnalysisError(RuntimeError):
    """A violated trace-safety / numerics invariant, caught at runtime.

    Attributes:
        rule:    the rule id (kebab-case, e.g. ``"dq-domain"``,
                 ``"nan-guard"``).
        context: structured details (``bucket=...``, ``name=...``) for
                 programmatic consumers; rendered into the message too.
    """

    def __init__(self, rule: str, message: str, **context):
        self.rule = rule
        self.context = dict(context)
        detail = ", ".join(f"{k}={v!r}" for k, v in self.context.items())
        super().__init__(f"[{rule}] {message}"
                         + (f" ({detail})" if detail else ""))
