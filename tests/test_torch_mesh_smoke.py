"""The rehearsal of ``chip_smoke.lm_mesh_phase`` on the CPU, as
``tests/test_torch_train.py`` rehearses ``lm_train_phase``: Granite's smoke
widths at 3 layers with bf16 activations on a (1, 1) ("data", "model") mesh
over a ``gloo`` group of one rank, K5, K7 and K7's backward swapped for
counted plain versions under the card plan.  The phase holds the sharded
route against the unsharded one (step 1's loss, gradient norm and
gradients, prefill and decode logits, a scoring forward on K5's route,
each ≤1e-5) and their launches equal; the test checks what it returns.

The process group lives in a child process (this file as a script, killed
past ``TIMEOUT``), never in the pytest worker.  No JAX is imported.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


def _rehearse(out: Path) -> None:
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk

    torch.set_num_threads(1)
    cs.DEVICE = "cpu"

    def fwd(x, w, eps=1e-6):
        rk.launches["rmsnorm"] += 1
        return ref.rmsnorm_plain(x, w, eps)

    def bwd(x, w, g, eps=1e-6):
        rk.launches["rmsnorm_bwd"] += 1
        return ref.rmsnorm_bwd_plain(x, w, g, eps)

    def flash(q, k, v, causal=True):
        fa.launches["flash_attention"] += 1
        return ref.flash_attention_plain(q, k, v, causal=causal)

    real = dispatch._plan
    card = ("rmsnorm", "flash_attention")
    dispatch._plan = lambda kind, what, ts: (
        "cuda" if kind in card else real(kind, what, ts))
    rk.rmsnorm, rk.rmsnorm_bwd, fa.flash_attention = fwd, bwd, flash
    cfg = get_smoke_config("granite_8b").replace(n_layers=3,
                                                 act_dtype="bfloat16")
    got = cs.lm_mesh_phase(torch, np, torch.device("cpu"), cfg, batch=2,
                           seq=16, n_steps=3, serve=(2, 8, 3),
                           backend="gloo")
    got["n_layers"] = cfg.n_layers
    got["train"] = {k: {"launches": v["launches"], "losses": v["losses"]}
                    for k, v in got["train"].items()}
    out.write_text(json.dumps(got))


def test_chip_smoke_lm_mesh_phase_rehearses_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    out = tmp_path / "phase.json"
    p = subprocess.Popen([sys.executable, __file__, str(out)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, start_new_session=True)
    try:
        so, se = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"the rehearsal outlasted {TIMEOUT} s")
    assert p.returncode == 0, (so + se)[-6000:]
    got = json.loads(out.read_text())
    L = got["n_layers"]
    assert all(v <= 1e-5 for v in got["grad"].values())
    assert got["serve_gap"] <= 1e-5 and got["score_gap"] <= 1e-5
    assert got["bitwise"]           # one rank: the same local ops
    launches = got["launches"]
    assert launches["grad"] == launches["step"]
    assert launches["step"]["rmsnorm_bwd"] == 2 * L + 1
    assert launches["step"]["rmsnorm"] == (2 * L + 1) + 2 * L
    assert launches["score"]["flash_attention"] == L
    assert launches["serve"]["flash_attention"] == 0
    assert got["train"]["sharded"]["losses"] == \
        got["train"]["unsharded"]["losses"]
    assert "lm_mesh" in so


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    _rehearse(Path(sys.argv[1]))
