"""Harvesting learned-prior training tuples from replay traces.

Replay traces already generate (placement, fleet, observed-cost) tuples for
free: every :class:`repro_torch.core.calibration.ReplayWindow` pins down which
devices carried busy signal, how slow each one actually ran, and what each
operator's true selectivity was.  :func:`training_tuples` pairs those
refit estimates with the identity-free featurization of
:mod:`repro_torch.belief.features`, producing the supervised rows
:func:`repro_torch.belief.prior.fit_prior` trains on — so a prior fit on fleets
the simulator has generated prices devices of a fleet it has never seen.

Rows are evidence-weighted with the same work-mass weights the belief
posterior uses: a device estimate backed by a window of real load teaches
the prior more than a sliver-of-mass one.

numpy copy of ``repro.sim.training`` for the PyTorch port; the tuples are
bitwise equal to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.belief.features import device_features, op_features
from repro_torch.core.calibration import ReplayWindow, refit_from_replay
from repro_torch.core.costmodel import CostConfig

__all__ = ["TrainingTuples", "training_tuples", "merge_tuples"]


@dataclasses.dataclass
class TrainingTuples:
    """Supervised rows for :func:`repro_torch.belief.prior.fit_prior` — the
    keyword layout matches its signature, so fitting is
    ``fit_prior(**dataclasses.asdict(tuples))`` modulo names."""

    device_features: np.ndarray     # (N_d, F_d)
    device_log_degrade: np.ndarray  # (N_d,)
    device_weights: np.ndarray      # (N_d,) work-mass evidence weights
    op_features: np.ndarray         # (N_o, F_o)
    op_log_sel_scale: np.ndarray    # (N_o,)
    op_weights: np.ndarray          # (N_o,) input-row evidence weights

    @property
    def n_device_rows(self) -> int:
        return self.device_log_degrade.size

    @property
    def n_op_rows(self) -> int:
        return self.op_log_sel_scale.size


def training_tuples(graph, fleet, window: ReplayWindow,
                    cfg: CostConfig = CostConfig(),
                    work_unit: float | None = None) -> TrainingTuples:
    """One replay window → supervised rows.

    ``fleet`` must be the belief the window was replayed against (typically
    the BASE fleet for harvested traces) — the refit's degrades are relative
    to it, so the targets are log-slowdowns vs that baseline.  Only devices
    with busy signal and operators with observed input rows contribute rows;
    a window can legitimately yield zero of either.
    """
    refit = refit_from_replay(graph, fleet, window, cfg=cfg,
                              work_unit=work_unit)
    d_feats = device_features(fleet)
    sig = np.asarray(refit.signal, dtype=bool)
    d_rows = d_feats[sig]
    d_y = np.log(np.maximum(refit.degrade[sig], 1e-12))
    d_w = np.asarray(refit.obs_weight, dtype=np.float64)[sig]
    if refit.op_obs_weight is not None:
        o_feats = op_features(graph)
        pos = np.asarray(refit.op_obs_weight, dtype=np.float64) > 0.0
        o_rows = o_feats[pos]
        o_y = np.log(np.maximum(refit.sel_scale[pos], 1e-12))
        o_w = np.asarray(refit.op_obs_weight, dtype=np.float64)[pos]
    else:
        n_f = op_features(graph).shape[1]
        o_rows = np.zeros((0, n_f))
        o_y = np.zeros(0)
        o_w = np.zeros(0)
    return TrainingTuples(device_features=d_rows, device_log_degrade=d_y,
                          device_weights=d_w, op_features=o_rows,
                          op_log_sel_scale=o_y, op_weights=o_w)


def merge_tuples(parts: list[TrainingTuples]) -> TrainingTuples:
    """Concatenate harvested rows across windows / traces / fleets — the
    corpus a transferable prior is fit on."""
    if not parts:
        raise ValueError("merge_tuples needs at least one part")
    return TrainingTuples(
        device_features=np.concatenate([p.device_features for p in parts]),
        device_log_degrade=np.concatenate(
            [p.device_log_degrade for p in parts]),
        device_weights=np.concatenate([p.device_weights for p in parts]),
        op_features=np.concatenate([p.op_features for p in parts]),
        op_log_sel_scale=np.concatenate([p.op_log_sel_scale for p in parts]),
        op_weights=np.concatenate([p.op_weights for p in parts]),
    )
