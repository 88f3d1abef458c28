"""``quality_scores_torch``, the port's counterpart of the reference's jitted
twin ``quality_scores_jnp`` (ROADMAP A11): on the CPU it is held within
1e-6 of ``quality_scores_jnp`` and 1e-5 of the numpy ``quality_scores`` on
the reference test's seeds (``tests/test_streaming.py``'s
``test_quality_scores_jnp_matches_numpy``) and on wider windows with stuck
and fully-missing rows; its run lengths equal a scan's exactly."""

import numpy as np
import pytest
import torch

from repro.streaming.quality import quality_scores, quality_scores_jnp
from repro_torch.streaming import quality_scores_torch

JNP_TOL, NUMPY_TOL = 1e-6, 1e-5


def _windows(seed, trials, max_b, max_s):
    """The reference test's draws (seed 0: 8 windows, a stuck row in the
    third and a fully missing row in the fourth) or wider ones."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        B, S = int(rng.integers(2, max_b)), int(rng.integers(4, max_s))
        toks = rng.integers(-1, 30, (B, S))
        if trial == 2 or seed:
            toks[0] = 7          # stuck sensor → repetition term must bite
        if trial == 3 or seed:
            toks[1] = -1         # fully-missing row
        yield toks


@pytest.mark.parametrize("seed,trials,max_b,max_s", [
    (0, 8, 24, 48),              # the reference test's windows
    (1, 12, 65, 257),            # B ≤ 64, S ≤ 256
])
@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_twin_matches_jnp_and_numpy(seed, trials, max_b, max_s):
    for toks in _windows(seed, trials, max_b, max_s):
        got = quality_scores_torch(toks, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (toks.shape[0],)
        got = got.numpy()
        np.testing.assert_allclose(got, np.asarray(quality_scores_jnp(toks)),
                                   rtol=0, atol=JNP_TOL)
        np.testing.assert_allclose(got, quality_scores(toks), rtol=0,
                                   atol=NUMPY_TOL)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_fully_missing_and_stuck_rows():
    """A fully missing row scores the reference's 0; a stuck row scores
    below a varied one; a tensor goes in as it is."""
    toks = np.stack([np.full(16, -1), np.full(16, 3), np.arange(16) % 7])
    got = quality_scores_torch(torch.as_tensor(toks), device="cpu").numpy()
    want = np.asarray(quality_scores_jnp(toks))
    np.testing.assert_allclose(got, want, rtol=0, atol=JNP_TOL)
    assert got[0] == 0.0 and got[1] < got[2]


@pytest.mark.parametrize("S", [1, 2, 3, 9])
def test_short_windows(S):
    """S = 1 has no neighbours (no run); the rest as the reference."""
    toks = np.random.default_rng(S).integers(-1, 4, (5, S))
    got = quality_scores_torch(toks, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(quality_scores_jnp(toks)),
                               rtol=0, atol=JNP_TOL)


def test_run_lengths_are_a_scans_exactly():
    """The vectorized run length equals the reference's scan on every row,
    as integers: the repetition term is 1 - run / (S - 1) on both."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 3, (64, 200))
    toks[3, 20:170] = 1                   # one long run
    same = toks[:, 1:] == toks[:, :-1]
    run = np.zeros(64)
    cur = np.zeros(64)
    for t in range(same.shape[1]):
        cur = np.where(same[:, t], cur + 1, 0)
        run = np.maximum(run, cur)
    assert run[3] == 149
    w = np.array([0.0, 0.0, 1.0], np.float32)  # the repetition term alone
    got = quality_scores_torch(toks, weights=w, device="cpu").numpy()
    np.testing.assert_array_equal(
        got, (np.float32(1.0) - (run / 199).astype(np.float32)))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quality_scores_torch(np.zeros((2, 4), np.int64))


def test_chip_smoke_quality_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's quality phase on the CPU at a small window, the
    default device resolved to the CPU and the timer stubbed: the card's
    scores are held against the CPU route and numpy as on the card."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import dispatch
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    cpu = torch.device("cpu")
    monkeypatch.setattr(dispatch, "resolve_device",
                        lambda device=None: cpu)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: 1.0)
    monkeypatch.setattr(chip_smoke, "QUALITY_SHAPE", (256, 240))
    out = chip_smoke.quality_phase(torch, np, cpu)
    assert out["err_cpu"] == 0.0 and out["err_numpy"] <= NUMPY_TOL
    assert "quality_scores_torch on 256 x 240" in capsys.readouterr().out
