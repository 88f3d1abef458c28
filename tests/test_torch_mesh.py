"""The mesh planner's host-side parts against the JAX package, with no
process group: the logical-axis rules, the parameter, FSDP, batch, cache and
optimizer-state specs, the registry's shapes and cells, the layout choice,
the elastic rescale and the straggler monitor.

The reference's sharding functions read only a mesh's ``axis_names`` and
``shape`` (``repro.models.sharding``: ``AxisRules.resolve``,
``fsdp_leaf_spec``, ``param_spec``), so a stand-in object serves for both
packages and no JAX devices are needed; where the reference reads its
ambient mesh (a model's ``param_specs()``), the test hands it the stand-in
through ``repro.models.sharding._active_mesh``.  Specs are compared as
tuples of entries (a ``PartitionSpec``'s ``tuple()``); the port's
per-layer specs against the reference's stacked ones without their layer
entry.  Bars: every comparison is exact.
"""

import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.core import autoshard as jax_autoshard  # noqa: E402
from repro.launch import shardings as jax_shardings  # noqa: E402
from repro.models import sharding as jax_sharding  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.runtime import elastic as jax_elastic  # noqa: E402
from repro.runtime import stragglers as jax_stragglers  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import autoshard  # noqa: E402
from repro_torch.launch import dryrun, shardings  # noqa: E402
from repro_torch.launch.mesh import use_mesh  # noqa: E402
from repro_torch.models import build_model, sharding  # noqa: E402
from repro_torch.perf.counts import without_data  # noqa: E402
from repro_torch.runtime import elastic, stragglers  # noqa: E402
from repro_torch.train import optim  # noqa: E402

MESHES = {"2x4": ({"data": 2, "model": 4}),
          "16x16": ({"data": 16, "model": 16}),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}),
          "2x2": ({"data": 2, "model": 2}),
          "1x4": ({"data": 1, "model": 4}),
          "2x1x2": ({"pod": 2, "data": 1, "model": 2})}
DENSE = ["olmo_1b", "granite_8b", "deepseek_coder_33b", "qwen3_32b"]
MOE = ["arctic_480b", "grok_1_314b"]
# every registry arch: the dense four first, as their cases were named
ARCHS = DENSE + [a for a in registry.ARCH_IDS if a not in DENSE]
LOGICAL = [("batch", "seq", None), ("batch", None, "vocab"),
           ("batch", None, "heads", None), ("batch", None, "kv_heads", None),
           (None, "ff"), ("vocab", None), ("layers", "embed", "inner"),
           ("experts", "state"), ("batch",), ()]


def _mesh(name: str):
    sizes = MESHES[name]
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


def _t(spec) -> tuple:
    return tuple(spec)


@pytest.fixture
def ambient(monkeypatch):
    """Install a stand-in mesh as both packages' ambient mesh."""
    def install(name):
        mesh = _mesh(name)
        monkeypatch.setattr(jax_sharding, "_active_mesh", lambda: mesh)
        return mesh
    return install


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("seq_shard", [False, True])
def test_axis_rules_resolve_and_param_spec_match_reference(mesh_name,
                                                           seq_shard):
    mesh = _mesh(mesh_name)
    ref_rules, port_rules = jax_sharding.DEFAULT_RULES, sharding.DEFAULT_RULES
    if seq_shard:
        ref_rules = jax_sharding.AxisRules({**ref_rules.rules,
                                            "seq": "model"})
        port_rules = sharding.AxisRules({**port_rules.rules, "seq": "model"})
    for logical in LOGICAL:
        assert _t(port_rules.resolve(*logical, mesh=mesh)) == \
            _t(ref_rules.resolve(*logical, mesh=mesh)), logical
    jax_sharding.set_axis_rules(ref_rules)
    sharding.set_axis_rules(port_rules)
    try:
        for logical in LOGICAL:
            for dims in itertools.product((8, 56, 1024, 3), repeat=len(logical)):
                want = jax_sharding.param_spec(logical, dims, mesh=mesh)
                got = sharding.param_spec(logical, dims, mesh=mesh)
                assert _t(got) == _t(want), (logical, dims)
            assert _t(sharding.param_spec(logical, mesh=mesh)) == \
                _t(jax_sharding.param_spec(logical, mesh=mesh))
    finally:
        jax_sharding.set_axis_rules(jax_sharding.DEFAULT_RULES)
        sharding.set_axis_rules(sharding.DEFAULT_RULES)


# (per-layer shape, spec, layers): a per-layer leaf is sized as the
# reference's stacked (layers, *shape) leaf
FSDP_CASES = [
    ((4096, 4096), (None, "model"), 36),
    ((4096, 128), (None, None), 36),      # 2^19 a layer, 2^24 stacked
    ((4096, 128), (None, None), 1),       # 2^19 alone: unsharded
    ((4096, 128), (None, None), 2),       # exactly 2^20 stacked
    ((1024, 1024), ("model", None), 1),
    ((1000, 1048), (None, None), 1),      # nothing divides 16
    ((49152, 4096), ("model", None), 1),
    ((4096,), (None,), 36),
    ((2, 4096, 256), (None, None, "model"), 8),
    ((16, 65536), (None, None), 4),
    ((64, 131072), ("data", None), 1),    # already on the FSDP axis
]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape, spec, layers", FSDP_CASES)
def test_fsdp_leaf_spec_sizes_a_leaf_as_the_stacked_one(mesh_name, shape,
                                                        spec, layers):
    mesh = _mesh(mesh_name)
    if layers > 1:
        want = _t(jax_sharding.fsdp_leaf_spec(
            jax.sharding.PartitionSpec(None, *spec), (layers, *shape),
            mesh))[1:]
    else:
        want = _t(jax_sharding.fsdp_leaf_spec(
            jax.sharding.PartitionSpec(*spec), shape, mesh))
    got = sharding.fsdp_leaf_spec(sharding.P(*spec), shape, mesh,
                                  layers=layers)
    assert _t(got) == want


def test_fsdp_leaf_spec_gap_is_where_the_stacked_size_decides():
    """A per-layer leaf of 2^19 elements: unsharded alone, sharded as the
    reference's 36-layer stack, as there."""
    mesh = _mesh("16x16")
    alone = sharding.fsdp_leaf_spec(sharding.P(None, None), (4096, 128),
                                    mesh)
    stacked = sharding.fsdp_leaf_spec(sharding.P(None, None), (4096, 128),
                                      mesh, layers=36)
    assert _t(alone) == (None, None)
    assert _t(stacked) == ("data", None)


def _ref_leaf(tree, name: str):
    """The reference's spec (or shape) of the port's parameter ``name``
    and whether the reference stacks it over its layers (a name whose
    second part is a layer index: ``blocks.3.attn.wq``, ``cross.0.gate``,
    ``encoder.1.mlp.wi``)."""
    parts = name.split(".")
    stacked = len(parts) > 1 and parts[1].isdigit()
    node = tree[parts[0]]
    for p in parts[2 if stacked else 1:]:
        node = node[p]
    return node, stacked


def _cache_leaves(tree, prefix: str = "") -> dict:
    """A cache of specs (nested dataclasses) → path → spec."""
    if not dataclasses.is_dataclass(tree):
        return {prefix: tree}
    out = {}
    for f in dataclasses.fields(tree):
        out.update(_cache_leaves(getattr(tree, f.name),
                                 f"{prefix}.{f.name}".lstrip(".")))
    return out


def _models(arch: str, smoke: bool):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    ref = jax_build(jax_registry.get_smoke_config(arch) if smoke
                    else jax_registry.get_config(arch))
    with without_data():
        port = build_model(cfg, device="cpu")
    return cfg, ref, port


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch, smoke", [(a, False) for a in ARCHS]
                         + [("granite_8b", True)])
def test_param_cache_and_fsdp_specs_match_reference(ambient, mesh_name, arch,
                                                    smoke):
    mesh = ambient(mesh_name)
    cfg, ref, port = _models(arch, smoke)
    _specs_match_reference(mesh, ref, port)


@pytest.mark.parametrize("mesh_name", ["2x4", "16x16", "2x2", "2x1x2"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_specs_with_experts_over_data_match_reference(ambient, mesh_name,
                                                          arch):
    """The expert-parallel-over-data variant (``moe_ep=data``: the
    ``experts`` rule on ``data``): E over data, d_ff over model where E
    divides the data axis, else the FFN split; specs, FSDP and moments as
    the reference's under the same rules."""
    mesh = ambient(mesh_name)
    _, ref, port = _models(arch, False)
    ref_rules = jax_sharding.axis_rules()
    jax_sharding.set_axis_rules(jax_sharding.AxisRules(
        {**ref_rules.rules, "experts": "data"}))
    try:
        with sharding.rules_override(experts="data"):
            _specs_match_reference(mesh, ref, port)
    finally:
        jax_sharding.set_axis_rules(ref_rules)


def _specs_match_reference(mesh, ref, port):
    ref_specs = ref.param_specs()
    ref_shapes = jax.eval_shape(ref.init_params, jax.random.PRNGKey(0))
    ref_fsdp = jax_shardings.fsdp_specs(ref_specs, ref_shapes, mesh)
    with use_mesh(mesh):
        specs = port.param_specs()
        shapes = dict(port.named_parameters())
        fsdp = shardings.fsdp_specs(specs, shapes, mesh)
        cache = port.cache_specs()
    assert set(specs) == set(shapes)
    for name in specs:
        (want, stacked), (want_f, _) = (_ref_leaf(ref_specs, name),
                                        _ref_leaf(ref_fsdp, name))
        cut = 1 if stacked else 0
        assert _t(specs[name]) == _t(want)[cut:], name
        assert _t(fsdp[name]) == _t(want_f)[cut:], name
    got_cache, want_cache = (_cache_leaves(cache),
                             _cache_leaves(ref.cache_specs()))
    assert set(got_cache) == set(want_cache)
    for path, spec in got_cache.items():
        assert _t(spec) == _t(want_cache[path]), path
    for bits8 in (False, True):
        ocfg = optim.AdamWConfig(bits8=bits8)
        got = optim.opt_state_specs(fsdp, ocfg)
        want = jax_optim.opt_state_specs(ref_fsdp,
                                         jax_optim.AdamWConfig(bits8=bits8))
        assert _t(got["count"]) == _t(want["count"])
        for name in specs:
            w, stacked = _ref_leaf(want["m"], name)
            cut = 1 if stacked else 0
            g = got["m"][name]
            if bits8:
                assert _t(g["q"]) == _t(w["q"])[cut:]
                assert _t(g["scale"]) == _t(w["scale"])[cut:]
            else:
                assert _t(g) == _t(w)[cut:]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_and_cache_len_match_reference(mesh_name):
    mesh = _mesh(mesh_name)
    for b in (None, 1, 2, 3, 8, 16, 32, 128, 256, 512, 1024):
        if b is not None:
            assert shardings.choose_batch_axes(b, mesh) == \
                jax_shardings.choose_batch_axes(b, mesh)
        assert _t(shardings.batch_specs(mesh, b)) == \
            _t(jax_shardings.batch_specs(mesh, b))
    for name, shape in registry.SHAPES.items():
        assert shardings.cache_len(shape) == jax_shardings.cache_len(
            jax_registry.SHAPES[name])


def test_registry_shapes_and_cells_match_reference():
    assert list(registry.SHAPES) == list(jax_registry.SHAPES)
    for name, s in registry.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(
            jax_registry.SHAPES[name])
    assert registry.runnable_cells() == jax_registry.runnable_cells()
    assert registry.skipped_cells() == jax_registry.skipped_cells()
    assert registry.ALIASES == jax_registry.ALIASES


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    pl = sharding.placements(sharding.P(("pod", "data"), None, "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(sharding.P(), mesh) == (Replicate(),) * 3
    assert sharding.placements(sharding.P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        sharding.placements(sharding.P(("data", "pod")), mesh)


def test_layer_counts_count_the_names_of_a_layer_list():
    names = ["embed", "blocks.0.attn.wq", "blocks.1.attn.wq",
             "blocks.2.attn.wq", "blocks.0.ln1", "blocks.1.ln1",
             "blocks.2.ln1", "head"]
    assert shardings.layer_counts(names) == {
        "embed": 1, "head": 1, **{n: 3 for n in names[1:7]}}


# three model sizes: the reference's test (33 B), an 8 B and a 1 B dense
SIZES = [dict(n_layers=62, d_model=7168, d_ff=19200, vocab=32256, seq=4096,
              global_batch=256, n_params=33e9),
         dict(n_layers=36, d_model=4096, d_ff=14336, vocab=49152, seq=4096,
              global_batch=256, n_params=8.1e9),
         dict(n_layers=16, d_model=2048, d_ff=8192, vocab=50304, seq=4096,
              global_batch=512, n_params=1.2e9)]
FIELDS = ("compute_s", "memory_s", "ici_collective_s", "dci_collective_s",
          "collective_s", "step_time_s", "dominant")


@pytest.mark.parametrize("size", range(len(SIZES)))
@pytest.mark.parametrize("chips", [8, 256, 512])
@pytest.mark.parametrize("pods", [1, 2])
def test_autoshard_matches_reference_with_its_constants(monkeypatch, size,
                                                        chips, pods):
    for name in ("PEAK_BF16_TFLOPS", "HBM_GBPS", "ICI_GBPS", "DCI_GBPS"):
        monkeypatch.setattr(autoshard, name, getattr(jax_autoshard, name))
    kw = SIZES[size]
    got = autoshard.candidate_layouts(chips, pods)
    want = jax_autoshard.candidate_layouts(chips, pods)
    assert [dataclasses.astuple(x) for x in got] == \
        [dataclasses.astuple(x) for x in want]
    for train in (True, False):
        for a, b in zip(got, want):
            ea = autoshard.estimate_layout(a, train=train, **kw)
            eb = jax_autoshard.estimate_layout(b, train=train, **kw)
            assert [getattr(ea, f) for f in FIELDS] == \
                [getattr(eb, f) for f in FIELDS]
        ca = autoshard.choose_layout(chips, pods, train=train, **kw)
        cb = jax_autoshard.choose_layout(chips, pods, train=train, **kw)
        assert dataclasses.astuple(ca.layout) == dataclasses.astuple(cb.layout)
        assert ca.step_time_s == cb.step_time_s


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("pods", [1, 2])
def test_autoshard_moe_branch_matches_reference_on_an_moe_cell(monkeypatch,
                                                               arch, pods):
    """The MoE branch (only top-k experts active, the token all-to-all) on
    the dry run's MoE cell (the config's sizes at train_4k on 256 or 512
    devices), as the dry run calls it: every candidate's terms and the
    choice as the reference's, with its constants."""
    for name in ("PEAK_BF16_TFLOPS", "HBM_GBPS", "ICI_GBPS", "DCI_GBPS"):
        monkeypatch.setattr(autoshard, name, getattr(jax_autoshard, name))
    cfg = get_config(arch)
    shape = registry.SHAPES["train_4k"]
    kw = dict(n_layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
              vocab=cfg.vocab, seq=shape.seq_len,
              global_batch=shape.global_batch,
              n_params=float(registry_params(arch)),
              moe_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
              param_bytes=float(cfg.pdtype.itemsize))
    chips = 256 * pods
    for layout in autoshard.candidate_layouts(chips, pods):
        got = autoshard.estimate_layout(layout, **kw)
        want = jax_autoshard.estimate_layout(
            jax_autoshard.Layout(*dataclasses.astuple(layout)), **kw)
        assert [getattr(got, f) for f in FIELDS] == \
            [getattr(want, f) for f in FIELDS]
    ca = autoshard.choose_layout(chips, pods, **kw)
    cb = jax_autoshard.choose_layout(chips, pods, **kw)
    assert dataclasses.astuple(ca.layout) == dataclasses.astuple(cb.layout)
    dense = autoshard.choose_layout(chips, pods, **{**kw, "moe_experts": 0})
    assert ca.compute_s < dense.compute_s       # only top-k experts active


def registry_params(arch: str) -> float:
    from repro_torch.models.api import count_params
    return count_params(get_config(arch))[0]


def test_autoshard_on_h100_constants_prices_the_network_tier():
    """The reference test's cells (33 B dense on 256 devices, one and two
    pods) with the H100 constants.  Its multi-pod assertions hold: only the
    two-pod layout pays the network tier.  Its first one (pure DP is not
    optimal at 33 B) is a TPU outcome, from ICI at 50 GB/s: at NVLink's
    450 GB/s every layout up to TP 8 is compute-bound at the same compute
    term (the work divides over the devices alike), so the tie goes to the
    smallest TP, pure DP with ZeRO-3, and TP 16 is collective-bound."""
    assert autoshard.PEAK_BF16_TFLOPS == 989.0
    assert autoshard.HBM_GBPS == 3350.0
    assert (autoshard.ICI_GBPS, autoshard.DCI_GBPS) == (450.0, 50.0)
    kw = dict(n_layers=62, d_model=7168, d_ff=19200, vocab=32256, seq=4096,
              n_params=33e9)
    best = autoshard.choose_layout(chips=256, pods=1, global_batch=256, **kw)
    assert best.dominant == "compute" and best.layout.tp == 1
    ties = [autoshard.estimate_layout(
        autoshard.Layout(dp=256 // tp, tp=tp, remat=best.layout.remat),
        global_batch=256, **kw) for tp in (1, 2, 4, 8, 16)]
    assert all(e.step_time_s == best.step_time_s for e in ties[:4])
    assert ties[4].dominant == "collective"
    assert ties[4].step_time_s > best.step_time_s
    single = autoshard.estimate_layout(autoshard.Layout(dp=16, tp=16),
                                       global_batch=256, **kw)
    multi = autoshard.estimate_layout(autoshard.Layout(dp=32, tp=16, pods=2),
                                      global_batch=512, **kw)
    assert multi.dci_collective_s > 0.0
    assert single.dci_collective_s == 0.0


def test_plan_rescale_matches_reference_over_a_grid():
    n = 0
    for old, surviving, model_ways, gb, keep in itertools.product(
            (64, 256, 512), (1, 7, 16, 100, 255, 256, 500), (1, 2, 4, 8, 16),
            (1, 3, 96, 256, 100_000), (True, False)):
        args = (old, surviving, model_ways, gb, keep)
        try:
            want = dataclasses.astuple(jax_elastic.plan_rescale(*args))
        except ValueError:
            with pytest.raises(ValueError):
                elastic.plan_rescale(*args)
            continue
        assert dataclasses.astuple(elastic.plan_rescale(*args)) == want, args
        n += 1
    assert n > 300
    with pytest.raises(ValueError, match="divisible"):
        elastic.rebuild_mesh(10, 4, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_matches_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(alpha=0.25 + 0.1 * seed, threshold=1.5 + 0.2 * seed)
    a = stragglers.StragglerMonitor(16, **kw)
    b = jax_stragglers.StragglerMonitor(16, **kw)
    slow = rng.integers(0, 16, 3)
    for step in range(12):
        t = rng.lognormal(0.0, 0.1, 16)
        t[slow] *= 1.0 + step / 4
        a.observe(t)
        b.observe(t)
        if step == 6:
            a.reset_device(int(slow[0]))
            b.reset_device(int(slow[0]))
        assert np.array_equal(a.ewma, b.ewma)
        assert a.stragglers() == b.stragglers()
    assert a.stragglers()


def test_dryrun_variants_defaults_and_left_out_items():
    train, serve = registry.SHAPES["train_4k"], registry.SHAPES["decode_32k"]
    d = dryrun.parse_variant("", train, 8.1e9)
    assert (d["seq_shard"], d["microbatches"]) == (True, 2)
    assert dryrun.parse_variant("", train, 33e9)["microbatches"] == 4
    assert dryrun.parse_variant("", train, 480e9)["microbatches"] == 8
    s = dryrun.parse_variant("", serve, 8.1e9)
    assert (s["seq_shard"], s["microbatches"], s["overrides"]) == (
        False, 1, {"remat": "none"})
    v = dryrun.parse_variant("remat=dots,microbatches=4,no_vocab_dp,"
                             "no_seq_shard", train, 8.1e9)
    assert v["overrides"] == {"remat": "dots"}
    assert (v["microbatches"], v["fsdp_embed"], v["seq_shard"]) == (
        4, False, False)
    # the MoE levers, parsed as the reference parses them
    m = dryrun.parse_variant("moe_ep=data,moe_group=64", train, 480e9)
    assert m["rules"] == {"experts": "data"}
    assert m["overrides"] == {"moe_group_size": 64}
    for item in ("unroll", "scan"):
        with pytest.raises(ValueError, match="left out"):
            dryrun.parse_variant(item, train, 8.1e9)
    with pytest.raises(ValueError, match="unknown"):
        dryrun.parse_variant("bogus", train, 8.1e9)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in DENSE])
def test_non_dense_families_name_the_second_half(arch):
    """Every family other than dense has the specs of A13d's second half:
    one spec per parameter and per cache leaf, as many entries as the
    tensor has dims, none raising."""
    with without_data():
        model = build_model(get_smoke_config(arch), device="cpu")
    with use_mesh(_mesh("2x4")):
        specs = model.param_specs()
        cache = model.cache_specs()
    params = dict(model.named_parameters())
    assert set(specs) == set(params)
    for name, p in params.items():
        assert len(specs[name]) <= p.dim(), name
    assert all(isinstance(v, sharding.P)
               for v in _cache_leaves(cache).values())


def test_named_shardings_keep_the_tree_and_lay_out_each_spec():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import named_shardings
    from repro_torch.models.layers import KVCache
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    spec = sharding.P(None, "data", None, "model")
    got = named_shardings(mesh, {"cache": KVCache(spec, spec),
                                 "w": [sharding.P("model", None), None]})
    assert got["cache"].k == got["cache"].v == (Shard(1), Shard(3))
    assert got["w"] == [(Replicate(), Shard(0)), (Replicate(), Replicate())]
