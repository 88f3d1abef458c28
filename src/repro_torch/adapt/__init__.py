"""Closed-loop adaptive replay on the port — ``repro.adapt`` for PyTorch:
run a trace tick-by-tick, watch modeled-vs-observed drift, recalibrate the
cost model from observations
(:func:`repro_torch.core.calibration.refit_from_replay`), re-optimize
placement and dq in one ``score_grid`` dispatch (K1 on the card), charge
reconfiguration costs, and account regret against the static seed placement
and a per-change oracle."""

from repro_torch.adapt.controller import (AdaptiveConfig, AdaptiveController,
                                          run_adaptive)
from repro_torch.adapt.regret import RegretReport, reconfiguration_cost

__all__ = ["AdaptiveConfig", "AdaptiveController", "RegretReport",
           "reconfiguration_cost", "run_adaptive"]
