"""What one call of a torch callable does: FLOPs, device-memory bytes and
collective traffic — the port's counterpart of ``repro.perf.hlo``.

The reference parses compiled HLO and weights every computation by its
loops' trip counts.  Eager PyTorch has no module to parse: the port runs
the callable once under two dispatch modes and counts every aten op as it
happens, so loops are counted by running them.

Accounting rules (one card; run the callable as one rank of a group for a
sharded step):

  * FLOPs: :class:`torch.utils.flop_counter.FlopCounterMode` — matmul-class
    ops (``mm``, ``bmm``, ``addmm``, convolutions, the fused attention
    ops) at 2 FLOPs per multiply-add; elementwise work and reductions
    count 0 (the reference counts a reduce as its operand's elements, so
    its totals run higher by the reductions).
  * Bytes: at op boundaries — every aten op reads its inputs and writes its
    outputs (each tensor once per op, broadcast dims not repeated).  Views
    and allocations without data (``empty``) move nothing; a lookup
    (``embedding``, ``index_select``, ``gather``, ``index``) moves twice
    its output plus its indices, as the reference's ``dynamic-slice``.
    This is eager PyTorch's counterpart of XLA's fusion boundary, and the
    two differ: XLA fuses chains of elementwise ops and keeps their
    intermediates in registers where eager PyTorch writes each (more
    bytes here), and XLA charges an op reading a slice of a stacked buffer
    the whole buffer (more bytes there).
  * Collectives: the ``torch.distributed`` c10d functional ops
    (``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``) under the reference's ring model, per
    participating device: all-reduce 2·B·(n−1)/n, all-gather B_out·(n−1)/n,
    reduce-scatter B_out·n·(n−1)/n, all-to-all B·(n−1)/n, permute B
    (:func:`ring_wire_bytes`).  The reference's ``dot_f32_wire_bytes``
    (CPU XLA's f32 upcast of bf16 dots) has no counterpart: eager
    collectives ride at their tensors' dtype.

The port's kernels (K1–K7) are called through ``ctypes``, so neither mode
sees them.  Each wrapper reports its launch's work instead —
:func:`report_kernel` with the FLOPs and bytes of
``repro_torch.perf.roofline``'s ``*_terms`` for that launch's shape — and
a card forward counts its attention, scan and norm work that way.  On the
CPU the plain versions run through aten and are counted as ops — also
inside :func:`without_data`, where tensors are fake CPU tensors (shapes
and dtypes, no storage), so the CPU route of a full-width model is
counted in seconds without its memory or its time; the device policy
(``repro_torch.kernels.dispatch``) opens a :func:`kernel_scope` around
either route, so :attr:`ModuleStats.kernels` splits a count by kernel.  A
launch is counted once: its kernel's ops are invisible to the modes, and
its plain version never reports.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["COLLECTIVE_OPS", "ACTIVE", "CollectiveStats", "ModuleStats",
           "OpCounter", "analyze_call", "without_data", "ring_wire_bytes",
           "report_kernel", "kernel_scope"]

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# the counters open in this process, innermost last; a wrapper reads this
# one list before it reports, so counting costs nothing while none is open
ACTIVE: list["OpCounter"] = []

# c10d functional op → (collective, position of its group size or name)
_C10D = {"all_reduce": ("all-reduce", 2), "all_reduce_": ("all-reduce", 2),
         "all_gather_into_tensor": ("all-gather", 1),
         "all_gather_into_tensor_out": ("all-gather", 1),
         "reduce_scatter_tensor": ("reduce-scatter", 2),
         "all_to_all_single": ("all-to-all", 3)}
# ops that move no bytes: allocations without data and the wait/wrap
# bookkeeping of the functional collectives (views are found by is_view)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
             "lift_fresh"}
_LOOKUPS = {"embedding", "index_select", "gather", "index"}


def ring_wire_bytes(base: str, result_bytes: float, n: int) -> float:
    """Wire bytes one participating device sends for a collective of
    ``base`` kind with ``result_bytes`` of result over a group of ``n``
    (the reference's ring model, ``repro.perf.hlo._collective_wire``)."""
    ring = (n - 1) / n if n > 1 else 0.0
    if base == "all-reduce":
        return 2.0 * result_bytes * ring
    if base in ("all-gather", "all-to-all"):
        return result_bytes * ring
    if base == "reduce-scatter":
        return result_bytes * n * ring
    if base == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {base!r}; known: {COLLECTIVE_OPS}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict
    wire_bytes: dict

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.counts.values()))

    def summary(self) -> dict:
        return {
            "counts": {k: int(v) for k, v in self.counts.items()},
            "result_bytes": {k: float(v) for k, v in self.result_bytes.items()},
            "wire_bytes": {k: float(v) for k, v in self.wire_bytes.items()},
            "total_wire_bytes": self.total_wire_bytes,
        }


@dataclasses.dataclass
class ModuleStats:
    flops: float        # one card
    hbm_bytes: float    # one card, op-boundary model
    collectives: CollectiveStats
    # kernel name → {"flops", "bytes", "calls", "launches"}: what each
    # kernel's launches reported (card) or its plain version's ops counted
    # (CPU), the routed calls (dispatch scopes) and the reported launches
    kernels: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collectives": self.collectives.summary(),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def _touched_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: broadcast (stride 0) dims once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _group_size(arg) -> int:
    if isinstance(arg, int):
        return arg
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(arg).size()


def _sharded(types) -> bool:
    """Whether an op's operand types include a DTensor.  Both counting modes
    hand such an op back (``NotImplemented``) so that DTensor runs it and
    the modes count what one device does: the ops on its local shards and
    the collectives its redistributions issue.  The first time DTensor
    meets an op's layout its sharding propagation runs the op on fake
    global shapes, which the modes would count too: count a sharded call
    after a warm-up call."""
    return any(t.__name__ == "DTensor" for t in types)


def _local_flops(mode: FlopCounterMode) -> None:
    """Make an entered ``FlopCounterMode`` hand DTensor ops back, as
    :class:`_BytesMode` does (its dispatch mode is the ``mode`` attribute
    it creates on entry)."""
    inner = mode.mode
    base = type(inner)

    class _Local(base):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _sharded(types):
                return NotImplemented
            return base.__torch_dispatch__(self, func, types, args, kwargs)

    inner.__class__ = _Local


class _BytesMode(TorchDispatchMode):
    """Counts each aten op's bytes and each functional collective into
    its :class:`OpCounter`."""

    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _sharded(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_BYTES:
            return out
        outs = _tensors(out)
        if name in _LOOKUPS:
            idx = [t for t in _tensors((args, kwargs))
                   if not t.is_floating_point()]
            moved = 2 * sum(map(_touched_bytes, outs)) \
                + sum(map(_touched_bytes, idx))
        else:
            seen = {id(t): t for t in _tensors((args, kwargs))}
            moved = sum(map(_touched_bytes, seen.values())) \
                + sum(map(_touched_bytes, outs))
        self.counter.hbm_bytes += moved
        if func.namespace == "_c10d_functional" and name in _C10D:
            base, at = _C10D[name]
            b = sum(map(_touched_bytes, outs))
            n = _group_size(args[at])
            self.counter.collective(base, b, n)
        return out


class OpCounter:
    """A context manager counting everything that runs inside it (see the
    module docstring); :meth:`stats` gives the :class:`ModuleStats`."""

    def __init__(self):
        self.hbm_bytes = 0.0
        self.reported_flops = 0.0
        self.kernels: dict[str, dict] = {}
        self._scopes: list[str] = []
        self._ccounts = defaultdict(float)
        self._cresult = defaultdict(float)
        self._cwire = defaultdict(float)
        self._flops_mode = FlopCounterMode(display=False)
        self._bytes_mode = _BytesMode(self)

    def __enter__(self):
        self._flops_mode.__enter__()
        _local_flops(self._flops_mode)
        self._bytes_mode.__enter__()
        ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        self._bytes_mode.__exit__(*exc)
        self._flops_mode.__exit__(*exc)
        return False

    @property
    def flops(self) -> float:
        return float(self._flops_mode.get_total_flops()) + self.reported_flops

    def collective(self, base: str, result_bytes: float, n: int) -> None:
        self._ccounts[base] += 1
        self._cresult[base] += result_bytes
        self._cwire[base] += ring_wire_bytes(base, result_bytes, n)

    def _kernel(self, name: str) -> dict:
        return self.kernels.setdefault(
            name, {"flops": 0.0, "bytes": 0.0, "calls": 0, "launches": 0})

    def report(self, name: str, flops: float, bytes_: float) -> None:
        """One launch of kernel ``name`` that did ``flops`` and moved
        ``bytes_``."""
        self.reported_flops += flops
        self.hbm_bytes += bytes_
        k = self._kernel(name)
        k["launches"] += 1
        if name not in self._scopes:      # an open scope adds it on exit
            k["flops"] += flops
            k["bytes"] += bytes_

    def stats(self) -> ModuleStats:
        return ModuleStats(
            self.flops, self.hbm_bytes,
            CollectiveStats(dict(self._ccounts), dict(self._cresult),
                            dict(self._cwire)),
            {k: dict(v) for k, v in self.kernels.items()})


def report_kernel(name: str, terms) -> None:
    """A kernel wrapper's report of one launch: ``terms`` (a
    ``RooflineTerms``) carries its FLOPs and bytes.  Call it only while
    :data:`ACTIVE` is non-empty."""
    for c in ACTIVE:
        c.report(name, terms.flops, terms.bytes)


class _Scope:
    __slots__ = ("name", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = [(c, c.flops, c.hbm_bytes) for c in ACTIVE]
        for c, _, _ in self.start:
            c._scopes.append(self.name)
        return self

    def __exit__(self, *exc):
        for c, f0, b0 in self.start:
            c._scopes.remove(self.name)
            k = c._kernel(self.name)
            k["flops"] += c.flops - f0
            k["bytes"] += c.hbm_bytes - b0
            k["calls"] += 1
        return False


class _NoScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SCOPE = _NoScope()


def kernel_scope(name: str):
    """Attribute what runs inside (a kernel's launch and report, or its
    plain version's ops) to kernel ``name`` in every open counter; a
    shared no-op while none is open."""
    return _Scope(name) if ACTIVE else _NO_SCOPE


def without_data():
    """A context in which new tensors (a model built with
    ``device="cpu"``, its inputs) are fake CPU tensors: every op computes
    shapes and dtypes only, and the device policy routes them to the plain
    versions as CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def analyze_call(fn, args: tuple = (), kwargs: dict | None = None
                 ) -> ModuleStats:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return what it counted."""
    with OpCounter() as c:
        fn(*args, **(kwargs or {}))
    return c.stats()
