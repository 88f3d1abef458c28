"""The rehearsal of ``chip_smoke.lm_mesh_phase`` on the CPU, as
``tests/test_torch_train.py`` rehearses ``lm_train_phase``: Granite's smoke
widths at 3 layers with bf16 activations on a (1, 1) ("data", "model") mesh
over a ``gloo`` group of one rank, K5, K7 and K7's backward swapped for
counted plain versions under the card plan.  The phase holds the sharded
route against the unsharded one (step 1's loss, gradient norm and
gradients, prefill and decode logits, a scoring forward on K5's route,
each ≤1e-5) and their launches equal; the test checks what it returns.
The families of the mesh planner's second half (``chip_smoke.
MESH_FAMILIES``: Mamba2, Grok's MoE, Zamba2, the VLM, Whisper) rehearse
the same way at their smoke widths with bf16 activations, K6 and its
backward counted too, each part the chip runs held bitwise.

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


def _rehearse(out: Path, which: str) -> None:
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk

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

    def scan(x, B, C, dt, A, D, chunk, final_state=False, state_out=None):
        sk.launches["ssd_scan"] += 1
        return ref.ssd_scan_plain(x, B, C, dt, A, D, chunk, final_state,
                                  state_out)

    def scan_bwd(x, B, C, dt, A, D, dy, chunk):
        sk.launches["ssd_scan_bwd"] += 1
        return ref.ssd_scan_bwd_plain(x, B, C, dt, A, D, dy, chunk)

    real = dispatch._plan
    card = ("rmsnorm", "flash_attention", "ssd_scan")
    dispatch._plan = lambda kind, what, ts: (
        "cuda" if kind in card else real(kind, what, ts))
    rk.rmsnorm, rk.rmsnorm_bwd, fa.flash_attention = fwd, bwd, flash
    sk.ssd_scan, sk.ssd_scan_bwd = scan, scan_bwd
    if which == "families":
        got = {}
        for arch, _, parts in cs.MESH_FAMILIES:
            cfg = get_smoke_config(arch).replace(act_dtype="bfloat16")
            r = cs.lm_mesh_phase(torch, np, torch.device("cpu"), cfg,
                                 batch=2, seq=16, n_steps=2,
                                 serve=(2, 8, 3), backend="gloo",
                                 parts=parts)
            got[arch] = {"parts": list(parts), "n_layers": cfg.n_layers,
                         "launches": r["launches"],
                         **{k: r[k] for k in ("serve_gap", "score_gap",
                                              "serve_bitwise",
                                              "score_bitwise", "bitwise")
                            if k in r}}
            if "train" in r:
                got[arch]["train"] = {k: {"launches": v["launches"],
                                          "losses": v["losses"]}
                                      for k, v in r["train"].items()}
                got[arch]["want_step"] = cs.expected_launches(cfg, "train")
        out.write_text(json.dumps(got))
        return
    cfg = get_smoke_config("granite_8b").replace(n_layers=3,
                                                 act_dtype="bfloat16")
    got = cs.lm_mesh_phase(torch, np, torch.device("cpu"), cfg, batch=2,
                           seq=16, n_steps=3, serve=(2, 8, 3),
                           backend="gloo")
    got["n_layers"] = cfg.n_layers
    got["train"] = {k: {"launches": v["launches"], "losses": v["losses"]}
                    for k, v in got["train"].items()}
    out.write_text(json.dumps(got))


def _child(tmp_path, which: str) -> tuple[dict, str]:
    """The rehearsal ``which`` in a child process: (what it returned, its
    standard output)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    out = tmp_path / f"{which}.json"
    p = subprocess.Popen([sys.executable, __file__, str(out), which],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, start_new_session=True)
    try:
        so, se = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"the rehearsal outlasted {TIMEOUT} s")
    assert p.returncode == 0, (so + se)[-6000:]
    return json.loads(out.read_text()), so


def test_chip_smoke_lm_mesh_families_rehearse_on_the_cpu(tmp_path):
    got, so = _child(tmp_path, "families")
    for arch, r in got.items():
        L = r["n_layers"]
        launches = r["launches"]
        assert r["serve_gap"] == 0 and r["serve_bitwise"], arch
        assert launches["serve"]["rmsnorm"] > 0, arch
        if arch.startswith(("mamba2", "zamba2")):     # K6 in the prefill
            assert launches["serve"]["ssd_scan"] == L, arch
        if "score" in r["parts"]:                     # Mamba2's forward
            assert r["score_gap"] == 0 and r["score_bitwise"]
            assert launches["score"]["ssd_scan"] == L
        if "grad" in r["parts"]:                      # the MoE step
            assert r["bitwise"]
            assert launches["grad"]["rmsnorm_bwd"] == 2 * L + 1
        if "train" in r["parts"]:                     # its AdamW steps
            assert r["train"]["sharded"] == r["train"]["unsharded"]
            assert {k: launches["step"][k] for k in r["want_step"]} \
                == r["want_step"], arch
            if arch.startswith(("mamba2", "zamba2")):  # K6 and its backward
                assert launches["step"]["ssd_scan_bwd"] == L, arch
                assert launches["step"]["ssd_scan"] == 2 * L, arch
    assert set(got) == {"mamba2_1_3b", "grok_1_314b", "zamba2_1_2b",
                        "llama_3_2_vision_11b", "whisper_large_v3"}
    assert so.count("lm_mesh") >= len(got)


def test_chip_smoke_lm_mesh_phase_rehearses_on_the_cpu(tmp_path):
    got, so = _child(tmp_path, "granite")
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
    _rehearse(Path(sys.argv[1]), sys.argv[2])
