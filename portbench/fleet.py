"""The example job's fleet, a copy of ``chip_smoke.py:1924-1935``
(``example_fleet``), itself ``examples/geo_placement.py``'s: 3 regions of
4 devices, WAN costs between regions, region 0 twice as fast."""

from __future__ import annotations

import numpy as np


def example_fleet() -> dict:
    """com (12, 12), speed (12,) and region (12,) numpy arrays."""
    rng = np.random.default_rng(0)
    n_dev, n_regions = 12, 3
    region = np.repeat(np.arange(n_regions), n_dev // n_regions)
    wan = np.array([[0.02, 1.5, 2.5], [1.5, 0.02, 1.0], [2.5, 1.0, 0.02]])
    com = wan[np.ix_(region, region)] + rng.uniform(0, 0.05, (n_dev, n_dev))
    com = (com + com.T) / 2
    np.fill_diagonal(com, 0.0)
    speed = np.where(region == 0, 2.0, 1.0)
    return {"com": com, "speed": speed, "region": region}
