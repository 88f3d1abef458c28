"""The mesh planner's dry run: build and count every (arch × shape × mesh)
cell without a card or memory — the counterpart of ``repro.launch.dryrun``.

Per cell, in a process whose default process group is torch's ``fake``
backend at the mesh's size (256 or 512 ranks; this process plays rank 0):

  * the model and the step are built inside
    ``repro_torch.perf.counts.without_data()`` — every tensor is a fake
    CPU tensor (shape and dtype, no storage) — with the parameters laid out
    as DTensors by ``param_specs()`` + ``fsdp_specs``, the batch by
    ``input_specs`` and the cache by ``cache_specs()``;
  * the step runs once on its first ``WARM_LAYERS`` blocks to fill
    DTensor's sharding-propagation cache (its propagation runs ops on fake
    global shapes, which no device runs), then whole under the counters: ``analyze_call``'s per-device FLOPs,
    bytes and collective summary (the ops on this rank's local shards and
    the collectives its redistributions issue) and a live-bytes tracker of
    the fake tensors the step creates;
  * ``memory``: per-device parameter, optimizer-state and input bytes (the
    local shards), the step's peak of live tensors (activations, gradients
    and temporaries) and their sum, with ``fits_80GB`` against the H100's
    80 GB;
  * ``roofline``: ``repro_torch.perf.roofline.step_terms`` with the H100
    constants (dense bf16 tensor-core peak, HBM 3.35 TB/s, NVLink 450 GB/s
    each way for every collective) — estimates for H100 constants, not
    measurements;
  * ``loss``: the vocab-parallel cross-entropy counted alone on logits of
    the step's layout (its bytes and collectives);
  * ``autoshard``: ``repro_torch.core.autoshard.choose_layout``'s pick for
    the same arch, shape and device count.

Defaults are the reference's: training turns on sequence-parallel
activations and microbatches by size (2 under 10 B parameters, 4 under
100 B, else 8); serving turns remat off.  The reference's TPU adjustment
(score rows kept in VMEM by its flash kernel, a 197 TFLOP/s MFU) becomes
``kernel_adjusted`` only where the counted step runs K5 (the forward
without a cache on ``attention_impl="pallas"``): the plain attention's
counted bytes give way to ``roofline.flash_attention_terms``.  The port's
training takes the reference attention, and its prefill and decode take
the chunked route and the grouped einsum, as the reference's do, so no
cell of ``SHAPES`` runs K5 and their ``kernel_adjusted`` is None.

Every family builds: dense, MoE, Mamba2, the hybrid, the VLM and the
encoder–decoder (the warm-up cuts each of a model's layer stacks to its
first ``WARM_LAYERS``, the config's depth with them).

Variants: ``remat=full|dots|none``, ``microbatches=N``, ``attn_chunk=N``,
``moe_group=N`` (the MoE group size), ``moe_ep=AXIS`` (the ``experts``
rule: ``moe_ep=data`` is expert parallelism over the data axis),
``param_dtype=...``, ``no_vocab_dp``, ``no_fsdp``, ``seq_shard``,
``no_seq_shard``.  Left out: ``unroll`` and ``scan`` (the port has one
module per layer and no scan to toggle).

Private PyTorch APIs, each for one purpose: the ``fake`` process-group
backend (``torch.testing._internal.distributed.fake_pg``: registers the
backend and its ``FakeStore``) stands in for 256 or 512 devices.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --sweep --mesh both    # every cell
  python -m repro_torch.launch.dryrun --arch arctic-480b --shape train_4k \
      --variant moe_ep=data
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \
      --variant remat=dots,microbatches=4
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

__all__ = ["H100_HBM_BYTES", "LiveBytes", "parse_variant", "build_cell",
           "run_cell", "main"]

H100_HBM_BYTES = 80e9       # NVIDIA H100 80GB HBM3 (data sheet)
WARM_LAYERS = 2             # blocks the warm-up runs

VARIANTS_LEFT_OUT = {
    "unroll": "the port has one module per layer and no scan to toggle",
    "scan": "the port has one module per layer and no scan to toggle",
}


class LiveBytes:
    """Live and peak bytes of the storages the ops of one device create
    inside the block (DTensor ops are handed back, so the tracker sees the
    ops on local shards); a storage counts until its last tensor dies."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        from repro_torch.perf.counts import _sharded, _tensors
        tracker = self
        self.live = self.peak = 0

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if _sharded(types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if not func.is_view:
                    ins = {id(t) for t in _tensors((args, kwargs))}
                    for t in _tensors(out):
                        if id(t) not in ins:
                            tracker._add(t.untyped_storage())
                return out

        self._mode = _Mode()
        self._seen: dict[int, weakref.ref] = {}

    def _add(self, st) -> None:
        ref = self._seen.get(id(st))
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self._seen[id(st)] = weakref.ref(st)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    from torch.utils import _pytree as pytree
    total = 0
    for t in pytree.tree_leaves(tree):
        local = getattr(t, "_local_tensor", t)
        if hasattr(local, "untyped_storage"):
            total += local.numel() * local.element_size()
    return total


def parse_variant(variant: str, shape, total_params: float) -> dict:
    """The cell's settings: the reference's defaults (training: sequence
    parallel and microbatches by size), then the variant's overrides."""
    train = shape.kind == "train"
    out = {"seq_shard": train,
           "microbatches": (2 if total_params < 10e9 else
                            4 if total_params < 100e9 else 8) if train else 1,
           "fsdp_embed": True, "overrides": {}, "rules": {}}
    for item in filter(None, variant.split(",")):
        k, v = item.split("=", 1) if "=" in item else (item, "1")
        if k in VARIANTS_LEFT_OUT:
            raise ValueError(f"variant {k!r} is left out: "
                             f"{VARIANTS_LEFT_OUT[k]}")
        if k == "microbatches":
            out["microbatches"] = int(v)
        elif k == "remat":
            out["overrides"]["remat"] = v
        elif k == "attn_chunk":
            out["overrides"]["attn_chunk"] = int(v)
        elif k == "moe_group":
            out["overrides"]["moe_group_size"] = int(v)
        elif k == "moe_ep":
            out["rules"]["experts"] = v     # "data": experts over data
        elif k == "param_dtype":
            out["overrides"]["param_dtype"] = v
        elif k == "no_vocab_dp":
            out["fsdp_embed"] = False
        elif k == "no_fsdp":
            out["fsdp_embed"] = "none"    # serve: TP-only weights
        elif k == "seq_shard":
            out["seq_shard"] = True
        elif k == "no_seq_shard":
            out["seq_shard"] = False
        else:
            raise ValueError(f"unknown variant item {item!r}")
    if not train:
        out["overrides"].setdefault("remat", "none")
    return out


@contextlib.contextmanager
def first_layers(model, n: int):
    """``model`` with each of its layer stacks (``blocks``, ``encoder``,
    ``decoder``, the VLM's ``cross``) cut to its first ``n`` layers and its
    config's depth with them inside the block; restored after it."""
    cfg = model.cfg
    saved = {name: getattr(model, name)
             for name in ("blocks", "encoder", "decoder", "cross")
             if hasattr(model, name)}
    model.cfg = cfg.replace(n_layers=min(n, cfg.n_layers),
                            encoder_layers=min(n, cfg.encoder_layers))
    try:
        for name, stack in saved.items():
            keep = model.n_cross if name == "cross" else n
            setattr(model, name, stack[:keep])
        yield model
    finally:
        model.cfg = cfg
        for name, stack in saved.items():
            setattr(model, name, stack)


def _counted(fn, warm) -> tuple:
    """``warm()`` to fill DTensor's propagation cache, then ``fn()`` under
    the op counter and the live-bytes tracker: (stats, tracker, seconds of
    the warm-up, seconds of the counted run)."""
    from repro_torch.perf.counts import analyze_call
    t0 = time.perf_counter()
    warm()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    with LiveBytes() as live:
        stats = analyze_call(fn)
    return stats, live, warm, time.perf_counter() - t0


def build_cell(arch: str, shape_name, multi_pod: bool = False,
               variant: str = "", layers: int | None = None, *, cfg=None,
               mesh=None) -> dict:
    """Build and count one cell in this process, whose default process
    group must be the ``fake`` backend at the mesh's size; returns the
    record.  ``layers`` cuts the depth (recorded).  A miniature cell passes
    its own ``cfg``, ``mesh`` and a ``Shape`` for ``shape_name``.  The
    warm-up runs the step on the first ``WARM_LAYERS`` blocks: every
    layer's ops have the same shapes and layouts, so they fill the cache
    as the whole stack would."""
    import torch

    from repro_torch.configs import SHAPES, get_config, shape_skip_reason
    from repro_torch.core.autoshard import choose_layout
    from repro_torch.launch.mesh import (make_production_mesh, mesh_chips,
                                         use_mesh)
    from repro_torch.launch.shardings import (cache_len, choose_batch_axes,
                                              fsdp_specs, input_specs,
                                              shard_cache, shard_params)
    from repro_torch.models import sharding
    from repro_torch.models.api import (analytic_flops, build_model,
                                        count_params)
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.perf.counts import analyze_call, without_data
    from repro_torch.perf.roofline import (HBM_BW, flash_attention_terms,
                                           step_terms)
    from repro_torch.train.optim import AdamWConfig, adamw_init
    from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                         make_train_step)

    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    skip = shape_skip_reason(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "skipped": skip}
    full_layers = cfg.n_layers
    total_params, active_params = count_params(cfg)
    opts = parse_variant(variant, shape, total_params)
    if opts["overrides"]:
        cfg = cfg.replace(**opts["overrides"])
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    multi_pod = "pod" in sharding.mesh_axes(mesh)
    chips = mesh_chips(mesh)
    baxes = choose_batch_axes(shape.global_batch, mesh)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "variant": variant or "baseline",
        "chips": chips, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "effective": {"seq_shard": opts["seq_shard"],
                      "microbatches": opts["microbatches"],
                      "remat": cfg.remat, "param_dtype": cfg.param_dtype},
        "layers": cfg.n_layers, "layers_published": full_layers,
    }
    rules = {"batch": baxes if baxes else None, **opts["rules"]}
    if opts["seq_shard"]:
        rules["seq"] = "model"
    t0 = time.perf_counter()
    with sharding.rules_override(**rules), use_mesh(mesh), without_data():
        model = build_model(cfg, device="cpu")
        params = dict(model.named_parameters())
        pspecs = model.param_specs()
        if opts["fsdp_embed"] != "none":
            pspecs = fsdp_specs(pspecs, params, mesh)
        if opts["fsdp_embed"] is False:
            plain_specs = model.param_specs()
            pspecs["embed"], pspecs["head"] = (plain_specs["embed"],
                                               plain_specs["head"])
        shard_params(model, pspecs, mesh)
        params = dict(model.named_parameters())
        batch = input_specs(cfg, shape, mesh, device="cpu")
        mem = {"param_bytes": local_bytes(params), "opt_bytes": 0,
               "input_bytes": local_bytes(batch)}
        if shape.kind == "train":
            opt_cfg = AdamWConfig(bits8=(cfg.param_dtype == "bfloat16"))
            opt = adamw_init(params, opt_cfg)
            mem["opt_bytes"] = local_bytes(opt)
            step = make_train_step(model, cfg, opt_cfg,
                                   microbatches=opts["microbatches"])

            def run():
                step(opt, batch)
        else:
            cache = shard_cache(
                model.init_cache(shape.global_batch, cache_len(shape)),
                model.cache_specs(), mesh)
            mem["input_bytes"] += local_bytes(cache)
            if shape.kind == "prefill":
                pstep = make_prefill_step(model, cfg)

                def run():
                    with torch.no_grad():
                        pstep(batch, cache)
            else:
                dstep = make_decode_step(model, cfg)

                def run():
                    with torch.no_grad():
                        dstep(cache, shape.seq_len, batch["tokens"])
        rec["build_s"] = time.perf_counter() - t0

        def warm():
            with first_layers(model, WARM_LAYERS):
                run()

        stats, live, rec["trace_s"], rec["count_s"] = _counted(run, warm)

        # the vocab-parallel loss alone, on logits of the step's layout
        loss_rec = None
        if shape.kind == "train":
            mb = shape.global_batch // opts["microbatches"]
            logits = sharding.distribute(
                torch.empty((mb, shape.seq_len, cfg.vocab_padded),
                            dtype=torch.float32, device="cpu"),
                sharding.logical_spec("batch", None, "vocab"), mesh)
            labels = sharding.distribute(
                torch.zeros((mb, shape.seq_len), dtype=torch.int32,
                            device="cpu"),
                sharding.logical_spec("batch", None), mesh)
            analyze_call(cross_entropy_loss, (logits, labels))
            ls = analyze_call(cross_entropy_loss, (logits, labels))
            loss_rec = {"hbm_bytes": ls.hbm_bytes,
                        "collectives": ls.collectives.summary(),
                        "per_microbatch": True}

    mem["argument_bytes"] = (mem["param_bytes"] + mem["opt_bytes"]
                             + mem["input_bytes"])
    mem["temp_bytes"] = live.peak
    mem["peak_bytes"] = mem["argument_bytes"] + live.peak
    mem["fits_80GB"] = bool(mem["peak_bytes"] < H100_HBM_BYTES)
    rec["memory"] = mem
    coll = stats.collectives
    rec["collectives"] = coll.summary()
    rec["kernels"] = {k: dict(v) for k, v in stats.kernels.items()}
    mflops = analytic_flops(cfg, shape.seq_len, shape.global_batch,
                            shape.kind)
    terms = step_terms(stats.flops, stats.hbm_bytes, coll.total_wire_bytes,
                       chips, mflops)
    rec["hlo_flops_per_device"] = stats.flops
    rec["hlo_bytes_per_device"] = stats.hbm_bytes
    rec["roofline"] = terms.row()
    rec["roofline"]["memory_bytes_per_device"] = stats.hbm_bytes
    rec["roofline"]["wire_bytes_per_device"] = coll.total_wire_bytes
    k5 = stats.kernels.get("flash_attention", {})
    if k5.get("calls", 0):
        sizes = sharding.mesh_axes(mesh)
        model_ways = sizes.get("model", 1)
        data_ways = max(chips // model_ways, 1)
        flash = flash_attention_terms(
            max(shape.global_batch // data_ways, 1), shape.seq_len,
            max(cfg.n_heads // model_ways, 1), cfg.hd, cfg.adtype, True)
        adj = max(stats.hbm_bytes - k5["bytes"], 0.0) \
            + k5["calls"] * flash.bytes
        rec["kernel_adjusted"] = {
            "plain_attention_bytes": k5["bytes"],
            "flash_ideal_bytes": k5["calls"] * flash.bytes,
            "memory_s": adj / HBM_BW,
            "step_time_s": max(terms.compute_s, adj / HBM_BW,
                               terms.collective_s)}
    else:
        rec["kernel_adjusted"] = None
        rec["kernel_adjusted_note"] = (
            "no K5 launch on this cell's route: training takes the "
            "reference attention, prefill and decode the chunked route and "
            "the grouped einsum, as the reference's do")
    rec["loss"] = loss_rec
    best = choose_layout(
        chips, sharding.mesh_axes(mesh).get("pod", 1), n_layers=full_layers,
        d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
        seq=shape.seq_len, global_batch=shape.global_batch,
        n_params=float(total_params), moe_experts=cfg.moe_experts,
        top_k=cfg.moe_top_k, train=shape.kind == "train",
        param_bytes=float(cfg.pdtype.itemsize))
    rec["autoshard"] = {
        "dp": best.layout.dp, "tp": best.layout.tp,
        "pods": best.layout.pods,
        "vocab_parallel_ce": best.layout.vocab_parallel_ce,
        "remat": best.layout.remat, "compute_s": best.compute_s,
        "memory_s": best.memory_s, "ici_collective_s": best.ici_collective_s,
        "dci_collective_s": best.dci_collective_s,
        "step_time_s": best.step_time_s, "dominant": best.dominant}
    rec["params_total"] = total_params
    rec["params_active"] = active_params
    return rec


def _fake_group(world: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``world``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape: str, mesh_name: str, variant: str = "",
             out_dir: Path | None = None, layers: int | None = None) -> dict:
    """One cell in this process on a fresh fake group of its size; the
    record is written to ``out_dir`` (when given) and returned."""
    import torch.distributed as dist
    multi = mesh_name == "multi"
    _fake_group(512 if multi else 256)
    try:
        t0 = time.perf_counter()
        rec = build_cell(arch, shape, multi, variant, layers)
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    tag = f"{arch}__{shape}__{mesh_name}"
    if variant:
        tag += "__" + variant.replace(",", "+").replace("=", "-")
    if out_dir is not None:
        out = Path(out_dir) / f"{tag}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    if "skipped" in rec:
        print(f"SKIP {tag}: {rec['skipped']}")
    else:
        r, m = rec["roofline"], rec["memory"]
        print(f"OK   {tag}: wall={rec['wall_s']:.1f}s "
              f"peak={m['peak_bytes'] / 1e9:.2f}GB fits={m['fits_80GB']} "
              f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s dom={r['dominant']} "
              f"(estimates for H100 constants)")
    return rec


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.configs.registry import canonical_arch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (recorded in the record)")
    ap.add_argument("--out", default=None,
                    help="directory for one JSON record per cell")
    ap.add_argument("--json", action="store_true",
                    help="print each record as one JSON line")
    ap.add_argument("--sweep", action="store_true",
                    help="one subprocess per cell (robust to a crash)")
    args = ap.parse_args(argv)
    archs = (list(ARCH_IDS) if args.arch == "all"
             else [canonical_arch(args.arch)])
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.sweep:
        failures = []
        for arch in archs:
            for shape in shapes:
                for mesh_name in meshes:
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--mesh", mesh_name, "--variant", args.variant]
                    if args.out:
                        cmd += ["--out", args.out]
                    if args.layers is not None:
                        cmd += ["--layers", str(args.layers)]
                    r = subprocess.run(cmd, capture_output=True, text=True)
                    sys.stdout.write(r.stdout)
                    if r.returncode != 0:
                        failures.append(f"{arch}__{shape}__{mesh_name}")
                        sys.stdout.write(r.stderr[-2000:])
        print(f"sweep done; {len(failures)} failures: {failures}")
        return 1 if failures else 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                try:
                    rec = run_cell(arch, shape, mesh_name, args.variant,
                                   args.out, args.layers)
                except Exception:
                    traceback.print_exc()
                    return 1
                if args.json:
                    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
