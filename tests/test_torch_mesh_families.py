"""The mesh planner's second half on four ``gloo`` ranks: the sharded train,
prefill and decode steps of Mamba2 and Zamba2 here, and with this file's
helpers Arctic's MoE (experts over ``model``, and over ``data`` with
``moe_ep=data``: ``tests/test_torch_mesh_moe.py``), the Llama-Vision VLM
and Whisper (``tests/test_torch_mesh_encdec.py``) and each family's dry-run
cell (``tests/test_torch_mesh_dryrun.py``), each against the JAX
package's single-device train step and the unsharded port.  The files
are four so that pytest-xdist's workers share them.

As in ``tests/test_torch_distributed.py``, no process group is made in the
pytest worker: each case is this file run as a script in a child process
(its own session, killed with its ranks past ``TIMEOUT``) that spawns four
ranks meeting through a ``FileStore``.  Each mesh of a case runs in a
process group of its own (``test_torch_distributed.case_group``), which
ends with a check that every rank issued the same collectives, so a fault
in one mesh's run cannot pass into the next.  The parameters are the
reference's ``init_params(PRNGKey(0))`` of the family's smoke config
(float32 activations; the VLM's cross gates opened to 0.8 / -0.5 / 0.3)
through ``repro_torch.convert``, laid out by ``param_specs()`` and
``fsdp_specs`` with a small FSDP threshold, so that the data axis splits
parameters too.

Bars: loss, gradient norm, MoE aux loss and every gradient (the ones AdamW
is handed, per leaf of the reference's tree as
``tests/test_torch_train_step.py`` holds them: a per-layer parameter
stacked over its layers) ≤1e-5 relative (max |err| / max |want|) of the
JAX package's single-device train step; prefill + 4 forced decode steps,
logits ≤1e-5 of the unsharded port and the same greedy tokens.  Per layer
the VLM's second cross gate, a scalar whose gradient cancels, reads
1.23e-5 from JAX's on the batch-split meshes: JAX's own float32 value is
8.7e-6 from the float64 one, the sharded port's 3.6e-6 (as the unsharded
port's); its stacked leaf, scaled by the first gate's 30× larger
gradient, reads 4e-7.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_distributed as dist_test  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
FSDP_MIN = 1 << 8
MESHES = dist_test.MESHES
GATES = (0.8, -0.5, 0.3)
# 16 tokens a row: a data shard of two rows holds a whole MoE group (32),
# so the groups follow the data shards and moe_ep=data's tokens cross by
# all-to-all
BATCH, SEQ, FORCED = 4, 16, 4
# case → arch; one child a case.  RUNS: (case, mesh, the ``experts``
# rule) of each run in it: every family on (2, 2); Mamba2 also on (1, 4)
# (K6 on a quarter of the heads); the MoE also with the experts over
# ``data`` on (2, 2) (``moe_ep=data``), where the all-to-all moves
# tokens.  (A (2, 1, 2) run of the MoE spends most of its time in
# DTensor's sharding propagation over three mesh dims; the dense family
# holds that mesh in ``tests/test_torch_distributed.py``.)  BITS8_RUN's
# train step takes 8-bit moments (on rows split over the experts' axis),
# held against the unsharded port's 8-bit step
CASES = {"mamba2": "mamba2_1_3b", "zamba2": "zamba2_1_2b",
         "arctic": "arctic_480b", "vlm": "llama_3_2_vision_11b",
         "whisper": "whisper_large_v3"}
RUNS = [(c, "2x2", None) for c in CASES] + [("mamba2", "1x4", None),
                                            ("arctic", "2x2", "data")]
BITS8_RUN = ("arctic", "2x2", "data")
RUN_IDS = [f"{c}-{m}" + (f"-ep_{e}" if e else "") for c, m, e in RUNS]


def runs_of(*cases) -> dict:
    """``parametrize`` arguments for the runs of ``cases``."""
    runs = [r for r in RUNS if r[0] in cases]
    return {"argnames": "run", "argvalues": runs,
            "ids": [RUN_IDS[RUNS.index(r)] for r in runs]}
CONVERT = {"ssm": "mamba2_lm_from_arrays", "hybrid": "zamba2_lm_from_arrays",
           "moe": "decoder_lm_from_arrays", "vlm": "vision_lm_from_arrays",
           "audio": "enc_dec_lm_from_arrays"}


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1), dtype=np.int32)
    out = {"tokens": t[:, :-1], "labels": t[:, 1:],
           "loss_mask": (rng.random((BATCH, SEQ)) > 0.25).astype(np.float32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_frames"] = rng.standard_normal(
            (BATCH, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


# ------------------------------------------------------------ children --

def _build(tmp: Path, arch: str):
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    tree = dist_test._unflat(dict(np.load(tmp / "weights.npz")))
    fn = getattr(convert, CONVERT[cfg.family])
    return cfg, lambda: fn(cfg, tree, device="cpu")


def _rules(ep):
    import contextlib

    from repro_torch.models.sharding import rules_override
    return rules_override(experts=ep) if ep else contextlib.nullcontext()


def _train(cfg, model, bits8: bool = False) -> tuple[dict, dict]:
    """Loss, aux, gradient norm and the gradients AdamW is handed (full
    tensors) of one train step of ``model`` (sharded, under its mesh and
    rules), and the optimizer state after it (``bits8``: 8-bit moments)."""
    from repro_torch.models.sharding import plain
    from repro_torch.train import optim, steps
    seen = {}
    real = steps.adamw_update

    def update(grads, state, params, c):
        seen.update({k: plain(v) for k, v in grads.items()})
        return real(grads, state, params, c)

    steps.adamw_update = update
    try:
        ocfg = optim.AdamWConfig(bits8=bits8)
        state = optim.adamw_init(dict(model.named_parameters()), ocfg)
        state, met = steps.make_train_step(model, cfg, ocfg)(
            state, _batch(cfg, 7))
    finally:
        steps.adamw_update = real
    out = {f"grad:{k}": v.detach().numpy() for k, v in seen.items()}
    out.update({k: float(met[k]) for k in ("loss", "aux", "grad_norm")})
    return out, state


def _serve(cfg, model, mesh=None):
    """Prefill + ``FORCED`` forced decode steps of ``model`` (its cache laid
    out on ``mesh`` when it is sharded): (logits, greedy tokens)."""
    from repro_torch.launch.shardings import shard_cache
    from repro_torch.models.sharding import plain
    from repro_torch.train import steps
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 3).items()}
    extras = {k: v for k, v in b.items()
              if k in ("image_embeds", "audio_frames")}
    out, toks = [], []
    with torch.no_grad():
        cache = model.init_cache(BATCH, SEQ + FORCED)
        if mesh is not None:
            cache = shard_cache(cache, model.cache_specs(), mesh)
        pre = steps.make_prefill_step(model, cfg)
        dec = steps.make_decode_step(model, cfg)
        lg, cache = pre({"tokens": b["tokens"], **extras}, cache)
        out.append(plain(lg))
        for i in range(FORCED):
            nt, lg, cache = dec(cache, SEQ + i, b["labels"][:, i:i + 1])
            out.append(plain(lg))
            toks.append(nt)
    return torch.cat(out, 1), torch.cat(toks, 1)


def _rank(rank: int, world: int, tmp: str, case: str) -> None:
    """Each run of ``case``: one sharded model serves (prefill + decode,
    against the unsharded port's, computed once) and then takes the train
    step; after ``BITS8_RUN``'s, the unsharded port's 8-bit step."""
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import moe
    torch.set_num_threads(1)
    tmp = Path(tmp)
    cfg, build = _build(tmp, CASES[case])
    want, want_tok = _serve(cfg, build())
    moved, real_a2a = [0], moe._all_to_all

    def counted_a2a(*args, **kwargs):
        moved[0] += 1
        return real_a2a(*args, **kwargs)

    moe._all_to_all = counted_a2a
    arrays = {}
    for (c, mesh_name, ep), run in zip(RUNS, RUN_IDS):
        if c != case:
            continue
        moved[0] = 0
        dist_test.mark(rank, f"{run} starts")
        with dist_test.case_group(tmp, run, rank, world):
            mesh = make_mesh(*MESHES[mesh_name], "cpu")
            model = build()
            with use_mesh(mesh), _rules(ep):
                dist_test._shard(model, mesh)
                got, got_tok = _serve(cfg, model, mesh)
                dist_test.mark(rank, f"{run} served")
                bits8 = (c, mesh_name, ep) == BITS8_RUN
                got_train, state = _train(cfg, model, bits8)
                dist_test.mark(rank, f"{run} trained")
            arrays.update({f"train/{run}/{k}": v
                           for k, v in got_train.items()})
            arrays[f"train/{run}/all_to_all"] = moved[0]
            arrays[f"serve/{run}/serve_gap"] = float(
                (got - want).abs().max() / want.abs().max())
            arrays[f"serve/{run}/serve_tokens_equal"] = float(
                torch.equal(got_tok, want_tok))
            if bits8:
                arrays.update({f"bits8/{k}": v for k, v in
                               _bits8_gaps(cfg, build, model, state).items()})
    np.savez(tmp / f"rank{rank}.npz", **arrays)
    dist_test.mark(rank, "saved")


def _bits8_gaps(cfg, build, model, state) -> dict:
    """The sharded ``model``'s 8-bit moments ``state`` against one 8-bit
    step of the unsharded port on the same batch
    (``test_torch_distributed.bits8_gaps``).  Where a row is split the
    scale is a max across devices, whose float32 sum order may differ, so
    an int8 code may sit one step off: the dequantized moments then
    differ by one step of the row's scale and 127 times the scales'
    gap."""
    from repro_torch.train import optim, steps
    flat = build()
    ocfg = optim.AdamWConfig(bits8=True)
    s0 = optim.adamw_init(dict(flat.named_parameters()), ocfg)
    s0, _ = steps.make_train_step(flat, cfg, ocfg)(s0, _batch(cfg, 7))
    return dist_test.bits8_gaps(
        model, state, s0,
        step=lambda sa, sb: sb * 1.000001 + 127 * (sa - sb).abs())


# (arch, variant) of the dry run's miniature cells on 8 fake ranks; "-h6"
# cuts Arctic's smoke config to 6 query heads, which the 4-way model axis
# does not divide (as Arctic's 56 heads on 16): the attention output's
# gradient must come back in a layout its head reshape can undo
FAKE_CELLS = [("mamba2_1_3b", ""), ("zamba2_1_2b", ""),
              ("arctic_480b-h6", ""), ("arctic_480b", "moe_ep=data"),
              ("llama_3_2_vision_11b", ""), ("whisper_large_v3", "")]


def _fake_cfg(name: str):
    from repro_torch.configs import get_smoke_config
    arch, _, heads = name.partition("-h")
    cfg = get_smoke_config(arch)
    return cfg.replace(n_heads=int(heads)) if heads else cfg


def _fake_cells(tmp: str) -> None:
    """The dry run's miniature train cell of each family on an 8-rank fake
    (2, 4) mesh, and what ``choose_layout`` picks for it with the MoE
    branch."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import Shape
    from repro_torch.core.autoshard import choose_layout
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import count_params
    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        for arch, variant in FAKE_CELLS:
            cfg = _fake_cfg(arch)
            shape = Shape("mini", 16, 8, "train")
            rec = dryrun.build_cell(cfg.name, shape, cfg=cfg, mesh=mesh,
                                    variant=variant)
            best = choose_layout(
                8, 1, n_layers=cfg.n_layers, d_model=cfg.d_model,
                d_ff=cfg.d_ff, vocab=cfg.vocab, seq=16, global_batch=8,
                n_params=float(count_params(cfg)[0]),
                moe_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                param_bytes=float(cfg.pdtype.itemsize))
            rec["want_autoshard_step_s"] = best.step_time_s
            out[f"{arch}/{variant}"] = rec
    finally:
        dist.destroy_process_group()
    Path(tmp, "fake.json").write_text(json.dumps(out))


def _main(argv) -> None:
    case, tmp = argv[1], argv[2]
    if case == "fake":
        _fake_cells(tmp)
        return
    torch.multiprocessing.start_processes(
        _rank, args=(WORLD, tmp, case), nprocs=WORLD, start_method="spawn",
        join=True)


# ---------------------------------------------------------------- pytest --

@pytest.fixture(scope="module")
def reference():
    """arch → (the JAX config, model and parameter tree), made the first
    time a test asks for it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.api import build_model as jax_build
    done = {}

    def get(arch):
        if arch not in done:
            jcfg = jax_smoke(arch)
            jmodel = jax_build(jcfg)
            tree = jmodel.init_params(jax.random.PRNGKey(0))
            if jcfg.family == "vlm":
                tree["cross"]["gate"] = jnp.asarray(
                    GATES[:jmodel.n_cross], jnp.float32)
            done[arch] = (jcfg, jmodel, jax.tree.map(np.asarray, tree))
        return done[arch]

    return get


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """case → {rank: arrays}: each case's four-rank run, made the first
    time a test asks for it."""
    done = {}

    def get(case):
        if case not in done:
            tmp = tmp_path_factory.mktemp(case)
            np.savez(tmp / "weights.npz",
                     **dist_test._flat(reference(CASES[case])[2]))
            dist_test._child(case, tmp, script=__file__)
            done[case] = {r: dict(np.load(tmp / f"rank{r}.npz"))
                          for r in range(WORLD)}
        return done[case]

    return get


@pytest.fixture(scope="module")
def jax_step(reference):
    """arch → (loss, aux, gradient norm, gradients) of the JAX package's
    jitted single-device train step, computed once."""
    import jax
    import jax.numpy as jnp

    from repro.train import optim as jax_optim
    from repro.train import steps as jax_steps
    done = {}

    def get(arch):
        if arch in done:
            return done[arch]
        jcfg, jmodel, tree = reference(arch)
        real = jax_steps.adamw_update

        def update(grads, state, params, c):
            p, s, n = real(grads, state, params, c)
            return p, s, {"norm": n, "grads": grads}

        jax_steps.adamw_update = update
        try:
            ocfg = jax_optim.AdamWConfig()
            p0 = jax.tree.map(jnp.asarray, tree)
            step = jax.jit(jax_steps.make_train_step(jmodel, jcfg, ocfg))
            _, _, met = step(p0, jax_optim.adamw_init(p0, ocfg),
                             {k: jnp.asarray(v) for k, v in
                              _batch(jcfg, 7).items()})
        finally:
            jax_steps.adamw_update = real
        done[arch] = (float(met["loss"]), float(met["aux"]),
                      float(met["grad_norm"]["norm"]),
                      jax.tree.map(np.asarray, met["grad_norm"]["grads"]))
        return done[arch]

    return get


def _stacked(tree, flat: dict, prefix: str = "") -> dict:
    """``tree``'s structure filled from the port's per-parameter arrays
    ``flat``: a per-layer parameter stacked over its modules, a leaf the
    port lacks (a non-parametric norm's placeholder) as zeros."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out[k] = _stacked(v, flat, path)
        elif path in flat:
            out[k] = flat[path]
        else:
            top, _, rest = path.partition(".")
            names = [f"{top}.{i}.{rest}" for i in range(np.shape(v)[0])]
            out[k] = np.stack([flat[n] for n in names]) \
                if names and all(n in flat for n in names) \
                else np.zeros_like(v)
    return out


def _leaves(tree, prefix: str = "") -> list:
    """(path, leaf) of a nested dict, in its keys' order."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out += _leaves(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def check_train(ranks, jax_step, run) -> None:
    """The run's loss, gradient norm, aux loss and every gradient (per leaf
    of the reference's tree) ≤1e-5 of the JAX step; every rank's loss the
    same; all-to-alls where the experts take the batch axis."""
    case = run[0]
    loss, aux, norm, grads = jax_step(CASES[case])
    got = ranks(case)
    key = f"train/{RUN_IDS[RUNS.index(run)]}/"
    r0 = got[0]
    rel = dist_test._rel(r0[key + "loss"], loss)
    assert rel <= 1e-5, ("loss", float(r0[key + "loss"]), loss, rel)
    rel = dist_test._rel(r0[key + "grad_norm"], norm)
    assert rel <= 1e-5, ("grad_norm", float(r0[key + "grad_norm"]), norm,
                         rel)
    assert abs(float(r0[key + "aux"]) - aux) <= 1e-5 * max(1.0, abs(aux)), \
        ("aux", float(r0[key + "aux"]), aux)
    flat = {k[len(key) + 5:]: v for k, v in r0.items()
            if k.startswith(key + "grad:")}
    assert flat
    stacked = _stacked(grads, flat)
    for (path, g), want in zip(_leaves(stacked), _leaves(grads)):
        if np.asarray(want[1]).size == 0:   # a norm's placeholder leaf
            continue
        rel = dist_test._rel(g, want[1])
        assert rel <= 1e-5, (path, rel)
    for r in range(1, WORLD):               # every rank holds the same
        assert np.array_equal(got[r][key + "loss"], r0[key + "loss"])
    # the MoE's tokens crossed by all-to-all (out and back) iff the
    # experts took the batch axis
    assert (int(r0[key + "all_to_all"]) > 0) == (run[2] == "data")


def check_serve(ranks, run) -> None:
    """Every rank's prefill + decode logits ≤1e-5 of the unsharded port's,
    the same greedy tokens."""
    got = ranks(run[0])
    name = RUN_IDS[RUNS.index(run)]
    for r in range(WORLD):
        assert float(got[r][f"serve/{name}/serve_gap"]) <= 1e-5
        assert float(got[r][f"serve/{name}/serve_tokens_equal"]) == 1


@pytest.mark.parametrize(**runs_of("mamba2", "zamba2"))
def test_sharded_train_step_matches_reference(ranks, jax_step, run):
    check_train(ranks, jax_step, run)


@pytest.mark.parametrize(**runs_of("mamba2", "zamba2"))
def test_sharded_prefill_and_decode_match_unsharded(ranks, run):
    check_serve(ranks, run)


def check_bits8(ranks) -> None:
    """Arctic with its experts over ``data`` and d_ff over ``model`` on
    (2, 2): an expert leaf's rows (E, d, f) split over ``model``, so each
    8-bit moment's per-row scale is a max across the row's devices,
    replicated there (the reference's ``opt_state_specs`` drops the last
    entry), and equals the unsharded port's; the dequantized moments agree
    within one quantization step of the unsharded row's scale and 127
    times the scales' gap."""
    got = ranks("arctic")
    for r in range(WORLD):
        assert float(got[r]["bits8/bits8_scale_gap"]) <= 1e-5
        assert float(got[r]["bits8/bits8_deq_steps"]) <= 1.0
        assert float(got[r]["bits8/bits8_scale_replicated"]) == 1


def fake_cells(tmp_path_factory) -> dict:
    """The dry-run cells' records from this file's ``fake`` child."""
    tmp = tmp_path_factory.mktemp("fake")
    dist_test._child("fake", tmp, script=__file__)
    return json.loads((tmp / "fake.json").read_text())


def check_fake_cell(fake, arch, variant) -> None:
    """Each family's cell builds and counts on fake ranks: the per-device
    parameter bytes are each parameter's over the ways its spec splits it
    (under the cell's rules: ``moe_ep=data`` puts the experts on data),
    the step issues the FSDP collectives (and under ``moe_ep=data`` the
    MoE's all-to-alls), its terms are positive and its layout pick is
    ``choose_layout``'s with the MoE branch."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import build_model, sharding
    from repro_torch.perf.counts import without_data
    rec = fake[f"{arch}/{variant}"]
    assert rec["variant"] == (variant or "baseline") and rec["chips"] == 8
    mem = rec["memory"]
    assert mem["fits_80GB"] and mem["peak_bytes"] > mem["argument_bytes"]
    mesh = type("M", (), {"axis_names": ("data", "model"),
                          "shape": {"data": 2, "model": 4}})()
    cfg = _fake_cfg(arch)
    if variant.startswith("moe_group"):
        cfg = cfg.replace(moe_group_size=int(variant.split("=")[1]))
    rules = {"experts": "data"} if variant == "moe_ep=data" else {}
    with without_data():
        model = build_model(cfg, device="cpu")
    with use_mesh(mesh), sharding.rules_override(**rules):
        specs = model.param_specs()
    want = 0
    for name, p in model.named_parameters():
        ways = 1
        for e in specs[name]:
            for a in sharding._axes(e):
                ways *= mesh.shape[a]
        want += p.numel() * p.element_size() // ways
    assert mem["param_bytes"] == want
    assert mem["opt_bytes"] == 2 * want + 4
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
        rec["collectives"]["counts"])
    # the tokens cross to their experts and back by all-to-all: a layer's
    # forward, its recompute (full remat) and its backward, a microbatch
    eff = rec["effective"]
    passes = 3 if eff["remat"] == "full" else 2
    a2a = rec["collectives"]["counts"].get("all-to-all", 0)
    assert a2a == (2 * passes * eff["microbatches"] * cfg.n_layers
                   if variant == "moe_ep=data" else 0)
    assert rec["hlo_flops_per_device"] > 0
    assert rec["roofline"]["compute_s"] > 0
    assert rec["autoshard"]["step_time_s"] == rec["want_autoshard_step_s"]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    _main(sys.argv)
