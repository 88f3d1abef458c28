"""The mesh planner across processes on the CPU: the sharded train, prefill
and decode steps, the kernel boundary on local shards and
``compressed_psum`` on four ``gloo`` ranks, and the dry run on torch's
``fake`` process group, each against the JAX package or the unsharded port.

No process group is made in the pytest worker.  Each multi-rank run is this
file run as a script in a child process (its own session, killed with its
ranks if it outlasts ``TIMEOUT``), which spawns its ranks; they meet
through a ``FileStore`` in the test's temporary directory and write what
rank 0 (or each rank) computed there.  One run of four ranks serves every
gloo case: the (2, 2) ("data", "model") mesh (one batch, and two
microbatches), the (1, 4) mesh — Granite's 2 kv heads on 4 ``model``
ranks, so kv heads replicate and wk / wv split into half-head column
blocks — and the (2, 1, 2) ("pod", "data", "model") mesh, all over one
group.  The parameters are the reference's ``init_params(PRNGKey(0))`` of
Granite's smoke config (float32 activations) through
``repro_torch.convert``, laid out by ``param_specs()`` and ``fsdp_specs``
with a small FSDP threshold, so that the data axis splits parameters too.

Bars: loss, gradient norm and every gradient (the ones AdamW is handed)
≤1e-5 relative (max |err| / max |want|) of the JAX package's single-device
train step, gradients compared rather than updated parameters (Adam's
first step moves a roundoff-floor element by ±lr either way); the sharded
prefill and decode logits ≤1e-5 of the unsharded port; ``compressed_psum``
bitwise the reference's quantize / dequantize per rank summed in rank
order.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300        # a child ran 126-224 s beside a full suite run
WORLD = 4
FSDP_MIN = 1 << 8            # small enough that the smoke leaves split
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
TRAIN_CASES = [("2x2", 1), ("2x2", 2), ("1x4", 1), ("2x1x2", 1)]
PSUM_SHAPES = [(3, 130), (257,), (2, 4, 128)]
BATCH, SEQ = 4, 12


# ------------------------------------------------------------ children --

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1), dtype=np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:],
            "loss_mask": (rng.random((BATCH, SEQ)) > 0.25).astype(
                np.float32)}


def _psum_input(rank: int, shape) -> np.ndarray:
    return np.random.default_rng(100 + rank).standard_normal(shape).astype(
        np.float32) * (1 + rank)


def _granite(tmp: Path):
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("granite_8b")
    tree = _unflat(dict(np.load(tmp / "weights.npz")))
    return cfg, lambda: convert.decoder_lm_from_arrays(cfg, tree,
                                                       device="cpu")


def _shard(model, mesh):
    """``model`` laid out by its FSDP specs at the small ``FSDP_MIN``."""
    from repro_torch.launch.shardings import fsdp_specs, shard_params
    specs = fsdp_specs(model.param_specs(), dict(model.named_parameters()),
                       mesh, min_elems=FSDP_MIN)
    shard_params(model, specs, mesh)
    return specs


def _train_case(tmp, rank, mesh_name, micro):
    """Loss, gradient norm and the gradients AdamW is handed (full
    tensors) of one sharded train step."""
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models.sharding import plain
    from repro_torch.train import optim, steps
    cfg, build = _granite(tmp)
    model = build()
    shape, axes = MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "cpu")
    seen = {}
    real = steps.adamw_update

    def update(grads, state, params, c):
        seen.update({k: plain(v) for k, v in grads.items()})
        return real(grads, state, params, c)

    steps.adamw_update = update
    try:
        with use_mesh(mesh):
            specs = _shard(model, mesh)
            ocfg = optim.AdamWConfig()
            state = optim.adamw_init(dict(model.named_parameters()), ocfg)
            _, met = steps.make_train_step(model, cfg, ocfg, micro)(
                state, _batch(cfg, 7 + micro))
    finally:
        steps.adamw_update = real
    from repro_torch.models.sharding import _axes
    split = {n: [list(_axes(e)) for e in s] for n, s in specs.items()}
    out = {f"grad:{k}": v.detach().numpy() for k, v in seen.items()}
    out.update(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]))
    return out, {"specs": split}


def bits8_gaps(model, s1: dict, s0: dict, step=None) -> dict:
    """The 8-bit moments ``s1`` of the sharded ``model``'s AdamW step
    against the unsharded port's ``s0``: the per-row scales' largest
    relative gap, the dequantized moments' largest difference in
    quantization steps (``step(sa, sb)`` of the sharded and unsharded
    scales; one step of the unsharded row's scale by default), and
    whether each scale is replicated over the mesh dims that split its
    parameter's last dim."""
    from repro_torch.models.sharding import plain
    from repro_torch.train.optim import dequantize_blockwise
    scale_gap = deq_gap = 0.0
    replicated = True
    for name, p in model.named_parameters():
        for mom in ("m", "v"):
            a, b = s1[mom][name], s0[mom][name]
            sa, sb = plain(a["scale"]), b["scale"]
            scale_gap = max(scale_gap, float(
                (sa - sb).abs().max() / sb.abs().max()))
            da = plain(dequantize_blockwise(a, p.shape))
            db = dequantize_blockwise(b, p.shape)
            # within one quantization step of the row's scale
            unit = sb * 1.000001 if step is None else step(sa, sb)
            deq_gap = max(deq_gap, float(((da - db).abs() / unit).max()))
            last = p.dim() - 1
            replicated &= all(not pl.is_shard(last)
                              for pl, q in zip(a["scale"].placements,
                                               p.placements)
                              if q.is_shard(last))
    return {"bits8_scale_gap": scale_gap, "bits8_deq_steps": deq_gap,
            "bits8_scale_replicated": float(replicated)}


def _bits8_case(tmp, rank):
    """One 8-bit AdamW step on the (1, 4) mesh against the unsharded port:
    the per-row scales of m and v (a cross-device max where the row is
    split) and the dequantized moments; whether each scale is replicated
    over the mesh dims that split its parameter's last dim."""
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.train import optim, steps
    cfg, build = _granite(tmp)
    flat, sharded = build(), build()
    mesh = make_mesh(*MESHES["1x4"], "cpu")
    ocfg = optim.AdamWConfig(bits8=True)
    batch = _batch(cfg, 11)
    s0 = optim.adamw_init(dict(flat.named_parameters()), ocfg)
    s0, _ = steps.make_train_step(flat, cfg, ocfg)(s0, batch)
    with use_mesh(mesh):
        _shard(sharded, mesh)
        s1 = optim.adamw_init(dict(sharded.named_parameters()), ocfg)
        s1, _ = steps.make_train_step(sharded, cfg, ocfg)(s1, batch)
    return bits8_gaps(sharded, s1, s0), {}


def _serve_case(tmp, rank, mesh_name):
    """Prefill + 4 forced decode steps sharded and unsharded: the largest
    relative gap of their logits."""
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.launch.shardings import shard_cache
    from repro_torch.models.sharding import plain
    from repro_torch.train import steps
    cfg, build = _granite(tmp)
    flat, sharded = build(), build()
    shape, axes = MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "cpu")
    b = _batch(cfg, 3)
    tokens = torch.as_tensor(b["tokens"])
    forced = torch.as_tensor(b["labels"][:, :4])

    def run(model, m=None):
        out = []
        with torch.no_grad():
            cache = model.init_cache(BATCH, SEQ + 4)
            if m is not None:
                cache = shard_cache(cache, model.cache_specs(), m)
            pre = steps.make_prefill_step(model, cfg)
            dec = steps.make_decode_step(model, cfg)
            lg, cache = pre({"tokens": tokens}, cache)
            out.append(plain(lg))
            for i in range(4):
                nt, lg, cache = dec(cache, SEQ + i, forced[:, i:i + 1])
                out.append(plain(lg))
        return torch.cat(out, 1), nt

    want, want_tok = run(flat)
    with use_mesh(mesh):
        _shard(sharded, mesh)
        got, got_tok = run(sharded, mesh)
    gap = float((got - want).abs().max() / want.abs().max())
    return {"serve_gap": gap,
            "serve_tokens_equal": float(torch.equal(got_tok, want_tok))}, {}


def _boundary_case(tmp, rank):
    """K7's and K5's wrappers on DTensor operands (local shards) against
    the plain tensors, forward and K7's gradients; K7 refusing a split
    row."""
    from torch.distributed.tensor import Shard

    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import P, distribute, plain
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 6, 32), generator=g, requires_grad=True)
    w = torch.randn(32, generator=g).requires_grad_(True)
    y = dispatch.rmsnorm(x, w)
    dy = torch.randn(y.shape, generator=g)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    xd = distribute(x.detach(), P("data", "model", None), mesh)
    xd.requires_grad_(True)
    wd = distribute(w.detach(), P(None), mesh).requires_grad_(True)
    yd = dispatch.rmsnorm(xd, wd)
    gxd, gwd = torch.autograd.grad(
        yd, (xd, wd), distribute(dy, P("data", "model", None), mesh))
    out = {"rms_y": float((plain(yd) - y).abs().max()),
           "rms_gx": float((plain(gxd) - gx).abs().max()),
           "rms_gw": float((plain(gwd) - gw).abs().max() / gw.abs().max()),
           "rms_placements": float(tuple(yd.placements)
                                   == (Shard(0), Shard(1)))}
    try:
        dispatch.rmsnorm(distribute(x.detach(), P(None, None, "model"),
                                    mesh), wd)
        out["rms_split_refused"] = 0.0
    except ValueError:
        out["rms_split_refused"] = 1.0
    q, k, v = (torch.randn((2, 16, 4, 8), generator=g) for _ in range(3))
    want = dispatch.flash_attention(q, k, v)
    qd = distribute(q, P("data", None, "model", None), mesh)
    kd, vd = (distribute(t, P("data", None, None, None), mesh)
              for t in (k, v))
    got = dispatch.flash_attention(qd, kd, vd)
    out["flash"] = float((plain(got) - want).abs().max())
    out.update(_ssd_boundary(mesh, g))
    return out, {}


def _ssd_boundary(mesh, g) -> dict:
    """K6's wrapper on head- and row-split DTensors (its plain version on
    each device's shard) against the unsharded scan: y, the final state
    and the gradients of every operand; a split that cuts a head
    refused."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.sharding import P, distribute, plain
    b, L, H, Pd, N, Q = 4, 20, 4, 8, 8, 8
    ops = {"x": torch.randn((b, L, H, Pd), generator=g),
           "B": torch.randn((b, L, N), generator=g),
           "C": torch.randn((b, L, N), generator=g),
           "dt": torch.rand((b, L, H), generator=g) * 0.5 + 0.05,
           "A": -torch.rand(H, generator=g) - 0.5,
           "D": torch.randn(H, generator=g)}
    specs = {"x": P("data", None, "model", None), "B": P("data", None, None),
             "C": P("data", None, None), "dt": P("data", None, "model"),
             "A": P("model"), "D": P(None)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in ops.items()}
    y, S = dispatch.ssd_scan(*leaves.values(), Q, final_state=True)
    dy = torch.randn(y.shape, generator=g)
    want = torch.autograd.grad((y * dy).sum() + S.square().sum(),
                               list(leaves.values()))
    sh = {k: distribute(v, specs[k], mesh).requires_grad_(True)
          for k, v in ops.items()}
    yd, Sd = dispatch.ssd_scan(*sh.values(), Q, final_state=True)
    got = torch.autograd.grad(
        (yd * distribute(dy, specs["x"], mesh)).sum() + Sd.square().sum(),
        list(sh.values()))
    out = {"ssd_y": float((plain(yd) - y).abs().max()),
           "ssd_state": float((plain(Sd) - S).abs().max()),
           "ssd_grads": max(float((plain(a) - w).abs().max()
                                  / w.abs().max())
                            for a, w in zip(got, want)),
           "ssd_placements": float(
               tuple(yd.placements) == tuple(sh["x"].placements)
               and [p.dim for p in Sd.placements] == [0, 1])}
    refused = 0
    for x, spec in ((ops["x"], P("data", None, None, "model")),
                    (ops["x"][:, :, :3], P("data", None, "model", None))):
        try:
            dispatch.ssd_scan(distribute(x, spec, mesh), *(
                distribute(ops[k][..., :x.shape[2]] if k == "dt" else
                           ops[k][:x.shape[2]] if k in ("A", "D") else
                           ops[k], P(), mesh)
                for k in ("B", "C", "dt", "A", "D")), Q)
        except ValueError:
            refused += 1
    out["ssd_split_refused"] = float(refused == 2)
    return out


def _psum_case(tmp, rank):
    """``compressed_psum`` over a pod axis of 2 and of 4, this rank's
    result."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.compress import compressed_psum
    m2 = make_mesh((2, 2), ("pod", "data"), "cpu")
    m4 = make_mesh((4,), ("pod",), "cpu")
    out = {}
    for i, shape in enumerate(PSUM_SHAPES):
        g = torch.as_tensor(_psum_input(rank, shape))
        out[f"psum2:{i}"] = compressed_psum(g, "pod", m2).numpy()
        out[f"psum4:{i}"] = compressed_psum(g, "pod", m4).numpy()
    return out, {}


def _in_step() -> torch.Tensor:
    """The number of collectives this rank has issued on every process
    group it belongs to (their sequence numbers summed)."""
    from torch.distributed import distributed_c10d as c10d
    n = 0
    for pg in list(c10d._world.pg_map):
        if pg is not None and pg is not c10d.GroupMember.NON_GROUP_MEMBER:
            n += pg._get_sequence_number_for_group()
    return torch.tensor([n], dtype=torch.int64)


@contextlib.contextmanager
def case_group(tmp: Path, name: str, rank: int, world: int):
    """A ``gloo`` process group of its own for one case (a ``FileStore`` of
    its own in ``tmp``), destroyed after it, so that no group, sequence
    number or pending collective of one case reaches the next.  The case
    ends with an all-gather of each rank's count of issued collectives
    (:func:`_in_step`): ranks that did not issue the same collectives raise
    here, naming the case."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / f"store-{name}"), world), rank=rank, world_size=world)
    try:
        yield
        mine = _in_step()
        seen = [torch.zeros_like(mine) for _ in range(world)]
        dist.all_gather(seen, mine)
        if any(not torch.equal(t, seen[0]) for t in seen):
            raise RuntimeError(f"case {name}: the ranks issued "
                               f"{[int(t) for t in seen]} collectives")
    finally:
        dist.destroy_process_group()


def _cases(part: str):
    """(name, function of (tmp, rank) → (arrays, meta)) of one child's
    part: "train" (the train steps) or "rest"."""
    if part == "train":
        return [(f"train/{m}/{k}",
                 lambda tmp, rank, m=m, k=k: _train_case(tmp, rank, m, k))
                for m, k in TRAIN_CASES]
    return ([(f"serve/{m}", lambda tmp, rank, m=m: _serve_case(tmp, rank, m))
             for m in ("2x2", "1x4", "2x1x2")]
            + [("boundary", _boundary_case), ("bits8", _bits8_case),
               ("psum", _psum_case)])


def _rank(rank: int, world: int, tmp: str, part: str) -> None:
    torch.set_num_threads(1)
    tmp = Path(tmp)
    arrays, meta = {}, {}
    for name, case in _cases(part):
        mark(rank, f"{name} starts")
        with case_group(tmp, name.replace("/", "-"), rank, world):
            a, m = case(tmp, rank)
        arrays.update({f"{name}/{k}": v for k, v in a.items()})
        if m:
            meta[name] = m
    np.savez(tmp / f"{part}-rank{rank}.npz", **arrays)
    if rank == 0:
        (tmp / f"{part}-meta.json").write_text(json.dumps(meta))
    mark(rank, "saved")


def _fake_cells(tmp: str) -> None:
    """The dry run's miniature cells on an 8-rank fake (2, 4) mesh, then the
    production meshes on 256 and 512 fake ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import Shape, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (data_axes, make_mesh,
                                         make_production_mesh, mesh_chips)
    from repro_torch.models import sharding
    from repro_torch.perf.counts import analyze_call
    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        cfg = get_smoke_config("qwen3_32b")
        for kind in ("train", "prefill", "decode"):
            out[kind] = dryrun.build_cell("qwen3_32b", Shape("mini", 32, 8,
                                                             kind),
                                          cfg=cfg, mesh=mesh)
        cells = []
        for warm_layers in (4, dryrun.WARM_LAYERS):    # the whole stack, 2
            dryrun.WARM_LAYERS = warm_layers
            cells.append(dryrun.build_cell(
                "qwen3_32b", Shape("mini", 32, 8, "train"),
                cfg=cfg.replace(n_layers=4), mesh=mesh))
        cold, warm = cells
        out["warm_up"] = [{k: r[k] for k in ("hlo_flops_per_device",
                                             "hlo_bytes_per_device",
                                             "collectives", "memory")}
                          for r in (cold, warm)]
        x = sharding.distribute(torch.zeros(8, 64),
                                sharding.P("data", None), mesh)
        w = sharding.distribute(torch.zeros(64, 128),
                                sharding.P(None, "model"), mesh)
        x @ w
        st = analyze_call(lambda: x @ w)
        out["matmul_flops"] = st.flops
    finally:
        dist.destroy_process_group()
    for world, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            m = make_production_mesh(multi_pod=multi, device="cpu")
            out[f"mesh{world}"] = {"axes": sharding.mesh_axes(m),
                                   "chips": mesh_chips(m),
                                   "data_axes": list(data_axes(m))}
        finally:
            dist.destroy_process_group()
    Path(tmp, "fake.json").write_text(json.dumps(out))


def _main(argv) -> None:
    what, tmp = argv[1], argv[2]
    if what == "fake":
        _fake_cells(tmp)
        return
    torch.multiprocessing.start_processes(
        _rank, args=(WORLD, tmp, what), nprocs=WORLD, start_method="spawn",
        join=True)


# ---------------------------------------------------------------- pytest --

def mark(rank: int, text: str) -> None:
    """One line on the rank's stderr saying how far it got (C6: a rank
    that dies leaves its last line in the child's output)."""
    print(f"rank {rank}: {text}", file=sys.stderr, flush=True)


def _child(what: str, tmp: Path, script: str = __file__) -> None:
    """``script`` run as ``script what tmp`` in its own session; killed
    with everything it started past ``TIMEOUT``.  The child and its ranks
    run with ``faulthandler`` on, so a rank killed by a signal (C6: a
    SIGABRT from the C library's heap checks) prints every thread's
    Python stack; a failed child's assertion carries the end of its
    output, the ranks' ``mark`` lines among it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1",
           "PYTHONFAULTHANDLER": "1"}
    p = subprocess.Popen([sys.executable, script, what, str(tmp)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"the {what} child outlasted {TIMEOUT} s")
    assert p.returncode == 0, (f"the {what} child exited "
                               f"{p.returncode}:\n" + (out + err)[-12000:])


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The four-rank runs, one child for the train steps and one for the
    rest: {rank: arrays}, the meta of rank 0 and the reference's tree."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.api import build_model as jax_build
    tmp = tmp_path_factory.mktemp("gloo")
    jcfg = jax_smoke("granite_8b")
    jmodel = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0)))
    np.savez(tmp / "weights.npz", **_flat(tree))
    ranks, meta = {r: {} for r in range(WORLD)}, {}
    for part in ("train", "rest"):
        _child(part, tmp)
        for r in range(WORLD):
            ranks[r].update(np.load(tmp / f"{part}-rank{r}.npz"))
        meta.update(json.loads((tmp / f"{part}-meta.json").read_text()))
    return ranks, meta, jcfg, jmodel, tree


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fake")
    _child("fake", tmp)
    return json.loads((tmp / "fake.json").read_text())


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _reference_step(jcfg, jmodel, tree, micro: int):
    """The JAX package's jitted train step on one device: loss, gradient
    norm and the gradients its AdamW is handed."""
    import jax
    import jax.numpy as jnp

    from repro.train import optim as jax_optim
    from repro.train import steps as jax_steps
    seen = {}
    real = jax_steps.adamw_update

    def update(grads, state, params, c):
        p, s, n = real(grads, state, params, c)
        return p, s, {"norm": n, "grads": grads}

    jax_steps.adamw_update = update
    try:
        ocfg = jax_optim.AdamWConfig()
        p0 = jax.tree.map(jnp.asarray, tree)
        step = jax.jit(jax_steps.make_train_step(jmodel, jcfg, ocfg, micro))
        _, _, met = step(p0, jax_optim.adamw_init(p0, ocfg),
                         {k: jnp.asarray(v) for k, v in
                          _batch(jcfg, 7 + micro).items()})
    finally:
        jax_steps.adamw_update = real
    seen = jax.tree.map(np.asarray, met["grad_norm"]["grads"])
    return float(met["loss"]), float(met["grad_norm"]["norm"]), seen


def _ref_leaf(tree, name: str):
    parts = name.split(".")
    idx = None
    if len(parts) > 1 and parts[1].isdigit():
        idx, parts = int(parts[1]), [parts[0]] + parts[2:]
    leaf = tree
    for p in parts:
        leaf = leaf[p]
    return leaf if idx is None else np.asarray(leaf)[idx]


@pytest.mark.parametrize("mesh_name, micro", TRAIN_CASES,
                         ids=[f"{m}-mb{k}" for m, k in TRAIN_CASES])
def test_sharded_train_step_matches_reference(gloo, mesh_name, micro):
    ranks, meta, jcfg, jmodel, tree = gloo
    loss, norm, grads = _reference_step(jcfg, jmodel, tree, micro)
    got = ranks[0]
    key = f"train/{mesh_name}/{micro}/"
    assert _rel(got[key + "loss"], loss) <= 1e-5
    assert _rel(got[key + "grad_norm"], norm) <= 1e-5
    names = [k[len(key) + 5:] for k in got if k.startswith(key + "grad:")]
    assert len(names) == 3 + 2 * 9     # embed, head, final norm, 2 blocks
    for n in names:
        assert _rel(got[key + "grad:" + n], _ref_leaf(grads, n)) <= 1e-5, n
    for r in range(1, WORLD):               # every rank holds the same
        assert np.array_equal(ranks[r][key + "loss"], got[key + "loss"])


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4", "2x1x2"])
def test_sharded_parameters_split_over_every_mesh_axis(gloo, mesh_name):
    """The FSDP layout puts the data axis on the big leaves and the model
    axis on the tensor-parallel ones, never the pod axis (its gathers
    would cross the network tier; it carries the batch); on (1, 4) wk / wv
    split 16 columns into 4-column blocks, half of an 8-wide head."""
    _, meta, *_ = gloo
    specs = meta[f"train/{mesh_name}/1"]["specs"]
    used = {a for s in specs.values() for e in s for a in e}
    shape, axes = MESHES[mesh_name]
    assert {a for a, n in zip(axes, shape) if n > 1 and a != "pod"} <= used
    assert "pod" not in used
    if mesh_name == "1x4":
        assert specs["blocks.0.attn.wk"][-1] == ["model"]


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4", "2x1x2"])
def test_sharded_prefill_and_decode_match_unsharded(gloo, mesh_name):
    ranks, *_ = gloo
    for r in range(WORLD):
        assert float(ranks[r][f"serve/{mesh_name}/serve_gap"]) <= 1e-5
        assert float(ranks[r][f"serve/{mesh_name}/serve_tokens_equal"]) == 1


def test_kernel_boundary_runs_local_shards(gloo):
    """K7, K5 and K6 on DTensor operands run on each device's shards and
    agree with the plain tensors; a split that the kernel cannot take (K7's
    normalized dim, a cut head for K6) is refused before launch."""
    ranks, *_ = gloo
    for r in range(WORLD):
        b = {k[9:]: float(v) for k, v in ranks[r].items()
             if k.startswith("boundary/")}
        assert b["rms_y"] <= 1e-6 and b["rms_gx"] <= 1e-6
        assert b["rms_gw"] <= 1e-6      # a partial sum over the split rows
        assert b["rms_placements"] == 1 and b["rms_split_refused"] == 1
        assert b["flash"] <= 1e-6
        # K6 on each device's rows and heads: the same scan per head
        assert b["ssd_y"] <= 1e-6 and b["ssd_state"] <= 1e-6
        assert b["ssd_grads"] <= 1e-5     # partial sums over heads / rows
        assert b["ssd_placements"] == 1 and b["ssd_split_refused"] == 1


def test_bits8_moments_on_split_rows_match_unsharded(gloo):
    """8-bit moments of parameters whose rows split over ``model``: each
    per-row scale is the max across the row's devices (replicated there,
    as the reference's ``opt_state_specs`` drops the last entry) and
    equals the unsharded port's; the dequantized moments agree within one
    quantization step."""
    ranks, *_ = gloo
    for r in range(WORLD):
        assert float(ranks[r]["bits8/bits8_scale_gap"]) <= 1e-5
        assert float(ranks[r]["bits8/bits8_deq_steps"]) <= 1.0
        assert float(ranks[r]["bits8/bits8_scale_replicated"]) == 1


@pytest.mark.parametrize("pods", [2, 4])
@pytest.mark.parametrize("shape_index", range(len(PSUM_SHAPES)))
def test_compressed_psum_is_the_reference_bitwise(gloo, pods, shape_index):
    import jax.numpy as jnp

    from repro.train.optim import dequantize_blockwise, quantize_blockwise
    ranks, *_ = gloo
    shape = PSUM_SHAPES[shape_index]
    for r in range(WORLD):
        members = ([r % 2, 2 + r % 2] if pods == 2 else list(range(WORLD)))
        total = jnp.zeros(shape, jnp.float32)
        for w in members:             # rank order, as the reference unrolls
            total = total + dequantize_blockwise(
                quantize_blockwise(jnp.asarray(_psum_input(w, shape))),
                shape)
        want = np.asarray(total / len(members))
        got = ranks[r][f"psum/psum{pods}:{shape_index}"]
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_miniature_cell(fake, kind):
    rec = fake[kind]
    for key in ("arch", "shape", "mesh", "variant", "chips", "kind",
                "seq_len", "global_batch", "effective", "memory",
                "collectives", "hlo_flops_per_device",
                "hlo_bytes_per_device", "roofline", "kernel_adjusted",
                "params_total", "params_active", "autoshard"):
        assert key in rec, key
    assert rec["chips"] == 8 and rec["mesh"] == "single"
    mem = rec["memory"]
    assert mem["fits_80GB"] and mem["peak_bytes"] > mem["argument_bytes"]
    # per-device parameter bytes: each parameter's elements over the ways
    # its spec splits it (the smoke leaves are under the FSDP threshold)
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model, sharding
    from repro_torch.perf.counts import without_data
    mesh = type("M", (), {"axis_names": ("data", "model"),
                          "shape": {"data": 2, "model": 4}})()
    from repro_torch.launch.mesh import use_mesh
    with without_data():
        model = build_model(get_smoke_config("qwen3_32b"), device="cpu")
    with use_mesh(mesh):
        specs = model.param_specs()
    want = 0
    for name, p in model.named_parameters():
        ways = 1
        for e in specs[name]:
            for a in sharding._axes(e):
                ways *= mesh.shape[a]
        want += p.numel() * p.element_size() // ways
    assert mem["param_bytes"] == want
    assert rec["hlo_flops_per_device"] > 0
    assert rec["roofline"]["compute_s"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    if kind == "train":
        assert mem["opt_bytes"] == 2 * want + 4
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
            rec["collectives"]["counts"])
        assert rec["loss"]["collectives"]["total_wire_bytes"] > 0
        assert rec["effective"]["microbatches"] == 2
    assert rec["kernel_adjusted"] is None


def test_dry_run_warm_up_on_two_blocks_counts_as_the_whole_stack(fake):
    """The counted run after a warm-up on 2 of 4 blocks counts what it
    counts after a warm-up on all 4: no propagation op is left to count."""
    cold, warm = fake["warm_up"]
    assert cold == warm


def test_dry_run_counts_the_local_shards(fake):
    """A (8, 64) @ (64, 128) DTensor matmul on (2, 4): one device's FLOPs,
    its (4, 64) @ (64, 32) shard, not the global product."""
    assert fake["matmul_flops"] == 2 * 4 * 64 * 32


@pytest.mark.parametrize("world", [256, 512])
def test_production_meshes_on_fake_ranks(fake, world):
    m = fake[f"mesh{world}"]
    assert m["chips"] == world
    if world == 256:
        assert m["axes"] == {"data": 16, "model": 16}
        assert m["data_axes"] == ["data"]
    else:
        assert m["axes"] == {"pod": 2, "data": 16, "model": 16}
        assert m["data_axes"] == ["pod", "data"]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    _main(sys.argv)
