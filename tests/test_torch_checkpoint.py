"""The port's checkpoint/restart (``repro_torch.runtime.checkpoint``) and the
trainer's fault tolerance on the CPU: the round trip of a trainer's state
(float32, bfloat16, int8 and int32 leaves, nested dicts), keep-N, the
refusals of a mismatched target, a ``.tmp`` directory never published,
the reference's on-disk layout, and a kill → resume cycle of the trainer,
in process (``SystemExit(13)``) and through the CLI, equal to an
uninterrupted run (bitwise on the CPU)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import checkpoint as jax_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.runtime.checkpoint import (available_steps,  # noqa: E402
                                            latest_step, restore_checkpoint,
                                            save_checkpoint)
from repro_torch.train import optim  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture
def one_thread():
    """One intra-op thread for a loop of many small CPU ops: as fast alone,
    and not slowed by spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(8, 16, generator=g),
              "ln": torch.randn(16, generator=g).to(torch.bfloat16)}
    opt = optim.adamw_init(params, optim.AdamWConfig(bits8=True))
    opt["m"]["w"] = optim.quantize_blockwise(torch.randn(8, 16, generator=g))
    opt["count"] = torch.tensor(3, dtype=torch.int32)
    return {"model": params, "opt": opt}


def _zeros_like(state):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in state.items()}


def _leaves(state):
    for v in state.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_save_restore_roundtrip(tmp_path):
    s = _state()
    save_checkpoint(tmp_path, 10, s, extra={"step": 10,
                                            "pipeline": {"cursor": 99,
                                                         "seed": 0}})
    restored, extra = restore_checkpoint(tmp_path, 10, _zeros_like(s))
    for a, b in zip(_leaves(s), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert restored["opt"]["m"]["w"]["q"].dtype == torch.int8
    assert extra["pipeline"]["cursor"] == 99


def test_restore_places_leaves_like_the_target(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.arange(4.0)})
    out, _ = restore_checkpoint(tmp_path, 1, {"a": torch.zeros(
        4, dtype=torch.bfloat16, device="cpu")})
    assert out["a"].dtype == torch.bfloat16 and out["a"].device.type == "cpu"
    assert torch.equal(out["a"], torch.arange(4.0).to(torch.bfloat16))


def test_keep_n_gc(tmp_path):
    s = _state()
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, step, s, keep=2)
    assert available_steps(tmp_path) == [4, 5]
    assert latest_step(tmp_path) == 5
    assert latest_step(tmp_path / "none") is None


def test_restore_rejects_mismatched_targets(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, 1, {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, 1, {"w": torch.zeros(4),
                                         "b": torch.zeros(1)})


def test_tmp_dir_never_published(tmp_path):
    """A leftover .tmp dir (a crash mid-write) is not listed as a
    checkpoint, and the next save of its step replaces it."""
    save_checkpoint(tmp_path, 1, _state())
    (tmp_path / "step_2.tmp").mkdir()
    (tmp_path / "step_2.tmp" / "garbage").write_text("x")
    assert available_steps(tmp_path) == [1]
    save_checkpoint(tmp_path, 2, _state())
    assert available_steps(tmp_path) == [1, 2]
    assert not (tmp_path / "step_2.tmp").exists()


def test_layout_is_the_references(tmp_path):
    """``step_<N>/{manifest.json, arrays.npz}`` with leaves ``a0…``: the
    reference's ``available_steps`` lists the port's checkpoints and its
    arrays read back by index."""
    s = _state()
    save_checkpoint(tmp_path, 7, s)
    assert sorted(os.listdir(tmp_path / "step_7")) == ["arrays.npz",
                                                       "manifest.json"]
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["n_leaves"] == len(list(_leaves(s)))
    assert manifest["paths"][0] == "model/w"
    assert jax_checkpoint.available_steps(tmp_path) == [7]
    data = np.load(tmp_path / "step_7" / "arrays.npz")
    np.testing.assert_array_equal(data["a0"], s["model"]["w"].numpy())


def _train(ckpt, **kw):
    cfg = get_smoke_config("granite_8b")
    return run_training(cfg, steps=10, global_batch=2, seq_len=16,
                        ckpt_dir=ckpt, ckpt_every=5, lr=1e-3,
                        dq_fraction=0.5, log_every=5, device="cpu", **kw)


def test_kill_and_resume_in_process(tmp_path, capsys, one_thread):
    """The trainer dies after step 6 (``SystemExit(13)``), resumes from
    checkpoint 5 with its optimizer state and pipeline cursor, and ends
    with the parameters and moments of an uninterrupted run, bitwise."""
    with pytest.raises(SystemExit) as died:
        _train(tmp_path / "a", die_at_step=6)
    assert died.value.code == 13
    assert latest_step(tmp_path / "a") == 5
    resumed = _train(tmp_path / "a", resume=True)
    assert "resumed from step 5" in capsys.readouterr().out
    assert latest_step(tmp_path / "a") == 10
    whole = _train(tmp_path / "b")
    a, b = resumed["model"].state_dict(), whole["model"].state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in resumed["opt_state"]["m"]:
        assert torch.equal(resumed["opt_state"]["m"][k],
                           whole["opt_state"]["m"][k])
    assert int(resumed["opt_state"]["count"]) == 10


def test_kill_and_resume_through_the_cli(tmp_path):
    """``python -m repro_torch.launch.train`` exits 13 at ``--die-at-step``
    and picks up the latest checkpoint with ``--resume``."""
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    common = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
              "granite-8b", "--smoke", "--batch", "2", "--seq", "8",
              "--steps", "4", "--ckpt-every", "2", "--device", "cpu",
              "--ckpt-dir", str(tmp_path / "ck")]
    r = subprocess.run(common + ["--die-at-step", "3"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 13, r.stderr
    assert latest_step(tmp_path / "ck") == 2
    r = subprocess.run(common + ["--resume"], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "resumed from step 2" in r.stdout
    assert latest_step(tmp_path / "ck") == 4
