"""Model configurations of the port (``CONFIG`` at published widths,
``SMOKE`` for CPU tests)."""

from repro_torch.configs.registry import get_config, get_smoke_config

__all__ = ["get_config", "get_smoke_config"]
