"""Runtime checks of the port (the sanitizer half of ``repro.analysis``)."""

from repro_torch.analysis import sanitize
from repro_torch.analysis.errors import AnalysisError

__all__ = ["AnalysisError", "sanitize"]
