"""Device fleets: heterogeneous, geo-distributed compute nodes (paper ``ED``).

Two concrete fleets:

* :class:`ExplicitFleet` — dense ``comCost_{u,v}`` matrix, exactly the paper's
  Table 3 input.  Fine up to a few thousand devices.
* :class:`RegionFleet` — devices grouped into regions (pods / datacenters);
  ``comCost_{u,v} = intra[r]`` if same region else ``inter[r_u, r_v]``.  The
  cost model exploits this structure so evaluation scales to fleets of 10⁵+
  devices (the paper's "massive parallelism" at fleet level) without ever
  materializing the V×V matrix.

numpy-only copy of ``repro.core.devices`` for the PyTorch port.  In place
of the reference's TPU mesh constants and ``fleet_from_tpu_mesh`` it has
:func:`fleet_from_gpu_mesh`, which prices an H100 cluster's two link
classes: NVLink within a node, the network between nodes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ExplicitFleet", "RegionFleet", "RegionFleetFamily",
           "fleet_from_gpu_mesh", "NVLINK_GBPS", "NET_GBPS"]

# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): NVLink 4, 900 GB/s per
# GPU in both directions together, 450 GB/s each way
NVLINK_GBPS = 450.0
# between nodes: one 400 Gb/s InfiniBand NDR port per H100 (NVIDIA DGX H100
# data sheet: eight ConnectX-7 ports for eight GPUs), 50 GB/s each way
NET_GBPS = 50.0


@dataclasses.dataclass
class ExplicitFleet:
    """Paper-faithful fleet: dense pairwise communication cost matrix.

    Attributes:
      com_cost: (V, V) — ``comCost_{u,v}``, time per unit data sent u→v.
        Diagonal is normally 0 (local data stays local).
      speed: (V,) relative compute speed (1.0 = nominal).  Only used by the
        compute-cost *extension*; the paper-faithful model ignores it.
      available: (n_ops, V) boolean — paper's ``available_{i,u}``; or None
        meaning every operator may run anywhere.
      region: (V,) int region id per device (informational here).
    """

    com_cost: np.ndarray
    speed: np.ndarray | None = None
    available: np.ndarray | None = None
    region: np.ndarray | None = None

    def __post_init__(self):
        self.com_cost = np.asarray(self.com_cost, dtype=np.float64)
        if self.com_cost.ndim != 2 or self.com_cost.shape[0] != self.com_cost.shape[1]:
            raise ValueError(f"com_cost must be square, got {self.com_cost.shape}")
        v = self.com_cost.shape[0]
        if self.speed is None:
            self.speed = np.ones(v, dtype=np.float64)
        self.speed = np.asarray(self.speed, dtype=np.float64)
        if self.region is None:
            self.region = np.zeros(v, dtype=np.int64)

    @property
    def n_devices(self) -> int:
        return self.com_cost.shape[0]

    def availability(self, n_ops: int) -> np.ndarray:
        if self.available is None:
            return np.ones((n_ops, self.n_devices), dtype=bool)
        a = np.asarray(self.available, dtype=bool)
        if a.shape != (n_ops, self.n_devices):
            raise ValueError(
                f"available has shape {a.shape}, want {(n_ops, self.n_devices)}")
        return a

    def com_matrix(self) -> np.ndarray:
        return self.com_cost

    def effective_speed(self) -> np.ndarray:
        """(V,) compute speed as priced by the occupancy / compute objectives.

        An ExplicitFleet has no separate degrade state — stragglers are
        folded directly into ``speed`` (see :meth:`degrade_device`)."""
        return self.speed

    def degrade_device(self, u: int, factor: float) -> "ExplicitFleet":
        """Model a straggler: all links touching ``u`` get ``factor``× slower
        and its compute speed drops by the same factor (runtime mitigation
        re-optimizes placement against the degraded fleet)."""
        c = self.com_cost.copy()
        c[u, :] *= factor
        c[:, u] *= factor
        np.fill_diagonal(c, np.diag(self.com_cost))
        s = self.speed.copy()
        s[u] /= factor
        return dataclasses.replace(self, com_cost=c, speed=s)

    def without_devices(self, dead: list[int]) -> tuple["ExplicitFleet", np.ndarray]:
        """Elastic down-scale: drop failed devices; returns (fleet, keep_idx)."""
        keep = np.array([u for u in range(self.n_devices) if u not in set(dead)])
        avail = None
        if self.available is not None:
            avail = np.asarray(self.available)[:, keep]
        return (
            ExplicitFleet(
                com_cost=self.com_cost[np.ix_(keep, keep)],
                speed=self.speed[keep],
                available=avail,
                region=self.region[keep],
            ),
            keep,
        )


@dataclasses.dataclass
class RegionFleet:
    """Region-structured fleet for massive device counts.

    ``comCost_{u,v} = degrade_u · degrade_v · inter[region_u, region_v]`` for
    ``u != v`` and ``self_cost`` (default 0) for ``u == v``.  Devices in the
    same region use the diagonal of ``inter`` (the intra-region link cost).

    ``degrade`` (default all-ones) is the structured straggler/outage model:
    every link touching device ``u`` gets ``degrade_u``× slower — the same
    semantics as ``ExplicitFleet.degrade_device`` but without ever leaving
    the O(R² + V) representation, so what-if families keep 10⁵-device fleets
    structured.
    """

    region: np.ndarray  # (V,) int region ids in [0, R)
    inter: np.ndarray  # (R, R) link cost between regions; diagonal = intra-region
    self_cost: float = 0.0  # u == v
    speed: np.ndarray | None = None
    available: np.ndarray | None = None
    degrade: np.ndarray | None = None  # (V,) per-device link multipliers

    def __post_init__(self):
        self.region = np.asarray(self.region, dtype=np.int64)
        self.inter = np.asarray(self.inter, dtype=np.float64)
        if self.speed is None:
            self.speed = np.ones(self.n_devices, dtype=np.float64)
        if self.degrade is not None:
            self.degrade = np.asarray(self.degrade, dtype=np.float64)
            if self.degrade.shape != (self.n_devices,):
                raise ValueError(
                    f"degrade has shape {self.degrade.shape}, "
                    f"want {(self.n_devices,)}")

    @property
    def n_devices(self) -> int:
        return self.region.shape[0]

    @property
    def n_regions(self) -> int:
        return self.inter.shape[0]

    def availability(self, n_ops: int) -> np.ndarray:
        if self.available is None:
            return np.ones((n_ops, self.n_devices), dtype=bool)
        return np.asarray(self.available, dtype=bool)

    def degrade_or_ones(self) -> np.ndarray:
        if self.degrade is None:
            return np.ones(self.n_devices, dtype=np.float64)
        return self.degrade

    def effective_speed(self) -> np.ndarray:
        """(V,) compute speed with the degrade multiplier applied.

        ``degrade_u`` prices every link touching ``u`` as ``degrade_u``×
        slower; a straggling box is slow on compute too, so the occupancy /
        compute objectives divide its nominal speed by the same multiplier
        (a degrade-2 device occupies 2× longer for the same work)."""
        return self.speed / self.degrade_or_ones()

    def com_matrix(self) -> np.ndarray:
        """Materialize the dense matrix (tests / small fleets only)."""
        c = self.inter[np.ix_(self.region, self.region)].copy()
        if self.degrade is not None:
            c *= np.outer(self.degrade, self.degrade)
        np.fill_diagonal(c, self.self_cost)
        return c

    def region_masses(self, x_row: np.ndarray) -> np.ndarray:
        """Σ_{v ∈ region r} x_v — the aggregation the structured model uses."""
        r = np.zeros(self.n_regions, dtype=x_row.dtype)
        np.add.at(r, self.region, x_row)
        return r

    def degrade_device(self, u: int, factor: float) -> "RegionFleet":
        """Structured straggler: links touching ``u`` get ``factor``× slower
        and, through :meth:`effective_speed`, its compute slows by the same
        factor (mirrors ExplicitFleet.degrade_device without materializing
        the matrix).  The slowdown lives ONLY in ``degrade`` — ``speed``
        stays nominal, so families built from degraded fleets keep one
        shared speed vector and the multiplier is never double-counted."""
        d = self.degrade_or_ones().copy()
        d[u] *= factor
        return dataclasses.replace(self, degrade=d)


@dataclasses.dataclass
class RegionFleetFamily:
    """A packed what-if *family* of RegionFleets sharing one region layout.

    This is the structured counterpart of stacking dense com matrices into
    an (S, V, V) tensor: scenarios share the ``region`` assignment (what-if
    perturbations move link costs and device health, not the fleet layout),
    so the whole family is

      * ``inter``   — (S, R, R) per-scenario inter-region link costs,
      * ``degrade`` — (S, V) per-device link multipliers (stragglers /
        whole-region outages; all-ones ⇒ healthy),

    i.e. O(S·(R² + V)) memory instead of O(S·V²) — the representation the
    batched evaluator's structured path consumes directly, reaching the
    10⁵-device fleets the scalar ``make_latency_fn`` already prices.

    ``S == 1`` families broadcast against a placement batch the same way a
    (1, V, V) dense com does.
    """

    region: np.ndarray  # (V,) shared region assignment
    inter: np.ndarray  # (S, R, R)
    degrade: np.ndarray  # (S, V)
    self_cost: float = 0.0
    speed: np.ndarray | None = None  # (V,) shared or (S, V) per-scenario

    def __post_init__(self):
        self.region = np.asarray(self.region, dtype=np.int64)
        self.inter = np.asarray(self.inter, dtype=np.float64)
        if self.inter.ndim != 3 or self.inter.shape[1] != self.inter.shape[2]:
            raise ValueError(f"inter must be (S, R, R), got {self.inter.shape}")
        if self.degrade is None:
            self.degrade = np.ones((self.n_scenarios, self.n_devices))
        self.degrade = np.asarray(self.degrade, dtype=np.float64)
        if self.degrade.shape != (self.n_scenarios, self.n_devices):
            raise ValueError(
                f"degrade has shape {self.degrade.shape}, "
                f"want {(self.n_scenarios, self.n_devices)}")
        if self.speed is not None:
            self.speed = np.asarray(self.speed, dtype=np.float64)
            if self.speed.shape not in (
                    (self.n_devices,),
                    (self.n_scenarios, self.n_devices)):
                raise ValueError(
                    f"speed has shape {self.speed.shape}, want "
                    f"{(self.n_devices,)} or "
                    f"{(self.n_scenarios, self.n_devices)}")
        if self.region.min(initial=0) < 0 or \
                self.region.max(initial=-1) >= self.n_regions:
            raise ValueError("region ids must lie in [0, n_regions)")

    @property
    def n_scenarios(self) -> int:
        return self.inter.shape[0]

    @property
    def n_devices(self) -> int:
        return self.region.shape[0]

    @property
    def n_regions(self) -> int:
        return self.inter.shape[1]

    @classmethod
    def from_fleets(cls, fleets: list["RegionFleet"]) -> "RegionFleetFamily":
        """Pack RegionFleets that share a region assignment and self_cost.

        Raises ValueError when the fleets don't stack structurally (different
        layouts belong in a dense (S, V, V) pack instead).
        """
        if not fleets:
            raise ValueError("need at least one fleet")
        if not all(isinstance(f, RegionFleet) for f in fleets):
            raise ValueError("all fleets must be RegionFleets")
        first = fleets[0]
        for f in fleets[1:]:
            if f.inter.shape != first.inter.shape \
                    or not np.array_equal(f.region, first.region) \
                    or f.self_cost != first.self_cost:
                raise ValueError(
                    "fleets disagree on region layout / self_cost — "
                    "pack them densely instead")
        # speeds only matter for the compute extension (fleet(s) oracle
        # use), but dropping them would silently mis-price degraded fleets
        # there — keep the shared vector when they agree, stack otherwise
        speeds = np.stack([np.ones(first.n_devices) if f.speed is None
                           else np.asarray(f.speed, dtype=np.float64)
                           for f in fleets])
        speed = speeds[0].copy() if np.allclose(speeds, speeds[0]) else speeds
        return cls(
            region=first.region.copy(),
            inter=np.stack([f.inter for f in fleets]),
            degrade=np.stack([f.degrade_or_ones() for f in fleets]),
            self_cost=first.self_cost,
            speed=speed,
        )

    def speed_or_ones(self) -> np.ndarray:
        """(S, V) nominal speeds, scenario-broadcast when shared."""
        if self.speed is None:
            return np.ones((self.n_scenarios, self.n_devices))
        return np.broadcast_to(self.speed,
                               (self.n_scenarios, self.n_devices))

    def effective_speeds(self) -> np.ndarray:
        """(S, V) per-scenario compute speeds with degrade applied —
        the stacked twin of :meth:`RegionFleet.effective_speed`."""
        return self.speed_or_ones() / self.degrade

    def fleet(self, s: int) -> "RegionFleet":
        """Scenario ``s`` as a standalone RegionFleet (oracle / replay use)."""
        speed = self.speed if self.speed is None or self.speed.ndim == 1 \
            else self.speed[s]
        return RegionFleet(region=self.region, inter=self.inter[s],
                           self_cost=self.self_cost, speed=speed,
                           degrade=self.degrade[s])

    def fleets(self) -> list["RegionFleet"]:
        return [self.fleet(s) for s in range(self.n_scenarios)]

    def com_matrix(self, s: int) -> np.ndarray:
        """Scenario ``s`` materialized densely (tests / small V only)."""
        return self.fleet(s).com_matrix()


def fleet_from_gpu_mesh(
    n_nodes: int = 1,
    gpus_per_node: int = 8,
    nvlink_gbps: float = NVLINK_GBPS,
    net_gbps: float = NET_GBPS,
    unit_bytes: float = 1e9,
) -> RegionFleet:
    """RegionFleet mirroring an H100 cluster: nodes are regions.

    ``comCost`` is seconds per ``unit_bytes`` over the relevant link class:
    traffic within a node rides NVLink, traffic between nodes the network —
    the counterpart of the reference's ``fleet_from_tpu_mesh`` (ICI within
    a pod, DCI between pods), built the same way, so equal link arguments
    give a bitwise equal ``com_matrix()``.
    """
    region = np.repeat(np.arange(n_nodes), gpus_per_node)
    intra = unit_bytes / (nvlink_gbps * 1e9)
    inter_cost = unit_bytes / (net_gbps * 1e9)
    inter = np.full((n_nodes, n_nodes), inter_cost)
    np.fill_diagonal(inter, intra)
    return RegionFleet(region=region, inter=inter, self_cost=0.0)
