"""Model configurations of the port (``CONFIG`` at published widths,
``SMOKE`` for CPU tests) and the dry run's input shapes."""

from repro_torch.configs.registry import (ARCH_IDS, SHAPES, Shape,
                                          get_config, get_smoke_config,
                                          runnable_cells, shape_skip_reason,
                                          skipped_cells)

__all__ = ["ARCH_IDS", "SHAPES", "Shape", "get_config", "get_smoke_config",
           "runnable_cells", "shape_skip_reason", "skipped_cells"]
