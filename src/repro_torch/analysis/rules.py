"""The port's rule set — one counterpart for each rule of
``repro.analysis.rules``, for the hazard that rule guards against as eager
PyTorch on the card has it:

  ==========================  ==========================================
  reference rule              the port's counterpart
  ==========================  ==========================================
  ``no-silent-retrace``       ``no-silent-rebuild``: a kernel library
                              built or loaded, or a ``torch.compile`` /
                              ``torch.jit`` wrapper made, in a loop or on
                              every call (``kernels/build.events`` counts
                              the port's compiles)
  ``dtype-discipline``        ``dtype-discipline``: float64 in the float32
                              batched twins, float32 in the float64
                              oracle, and a matrix product on a card path
                              of ``core/``, ``sim/`` or ``search/`` whose
                              function never calls ``require_fp32_matmul``
                              (TF32 would break the 1e-5 bar silently)
  ``jit-purity``              ``checkpoint-purity``: Python side effects
                              in a function that activation
                              checkpointing runs twice, or that
                              ``torch.jit.trace`` / ``torch.compile`` /
                              CUDA-graph capture runs once
  ``hidden-host-sync``        ``hidden-host-sync``: ``.item()``,
                              ``.tolist()``, ``.cpu()``, ``.numpy()``,
                              ``float()`` / ``int()`` / ``bool()`` of a
                              tensor, ``np.asarray(tensor)`` and
                              ``torch.cuda.synchronize()`` in a loop
  ``rng-discipline``          ``rng-discipline``: numpy's and the
                              stdlib's global rng (as the reference),
                              ``torch.manual_seed`` and torch samplers
                              without ``generator=``
  ``pallas-constraints``      ``kernel-wrapper-constraints``: a tensor
                              handed to a ctypes launch that no device /
                              dtype / shape / contiguity check passed,
                              and value-dependent shapes between the
                              check and the launch
  ==========================  ==========================================

Rules yield ``(node, message)`` or ``(node, message, severity)`` tuples;
the engine attaches defaults, locations, and suppressions.
"""

from __future__ import annotations

import ast
from pathlib import PurePath

from repro_torch.analysis.engine import LintContext, rule

# -- shared helpers -----------------------------------------------------------

#: numpy.random module-level functions that mutate GLOBAL rng state; the
#: Generator API (np.random.default_rng(...)) is the sanctioned source
_LEGACY_NP_RANDOM = frozenset({
    "seed", "random", "rand", "randn", "randint", "random_sample", "ranf",
    "sample", "uniform", "normal", "lognormal", "standard_normal",
    "poisson", "binomial", "choice", "shuffle", "permutation",
    "exponential", "gamma", "beta", "dirichlet", "multinomial", "integers",
    "random_integers", "bytes", "get_state", "set_state",
})

#: torch functions that seed or read the GLOBAL generators
_TORCH_GLOBAL_SEED = frozenset({
    "torch.manual_seed", "torch.seed", "torch.initial_seed",
    "torch.random.manual_seed", "torch.random.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all", "torch.set_rng_state",
    "torch.get_rng_state", "torch.cuda.set_rng_state",
    "torch.cuda.get_rng_state",
})

#: torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
})

#: in-place / method samplers on a tensor (same rule)
_TORCH_SAMPLER_METHODS = frozenset({
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
    "cauchy_", "log_normal_", "geometric_", "bernoulli",
})

#: methods that mutate their receiver in place (or publish to a registry)
_MUTATORS = frozenset({"append", "extend", "insert", "pop", "remove",
                       "clear", "update", "setdefault", "add", "discard",
                       "observe", "set", "inc", "write", "popitem",
                       "appendleft"})

#: the port's methods whose result lives on the card (batched dispatches)
_DEVICE_METHODS = frozenset({"score_grid", "score_batch", "score_pairs",
                             "edge_latencies"})

#: torch calls whose result is a host value, not a tensor
_TORCH_HOST_CALLS = frozenset({
    "torch.device", "torch.Generator", "torch.Size", "torch.finfo",
    "torch.iinfo", "torch.dtype", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.is_grad_enabled", "torch.is_tensor",
    "torch.get_default_dtype", "torch.get_float32_matmul_precision",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_name",
    "torch.cuda.current_stream", "torch.cuda.Event", "torch.cuda.device",
    "torch.cuda.max_memory_allocated", "torch.cuda.memory_allocated",
})

#: methods that bring a tensor's values to the host
_PULL_METHODS = ("item", "tolist", "cpu", "numpy")

#: float64 spellings in torch
_TORCH_F64 = frozenset({"torch.float64", "torch.double"})

#: torch calls and methods that form a matrix product
_MATMUL_CALLS = frozenset({
    "torch.matmul", "torch.mm", "torch.bmm", "torch.einsum",
    "torch.tensordot", "torch.addmm", "torch.baddbmm", "torch.addbmm",
    "torch.nn.functional.linear",
})
_MATMUL_METHODS = frozenset({"matmul", "mm", "bmm"})

#: ops whose output shape depends on VALUES — a launch takes shapes fixed
#: by the wrapper's check
_DYNAMIC_SHAPE_CALLS = frozenset({
    "torch.nonzero", "torch.argwhere", "torch.unique",
    "torch.unique_consecutive", "torch.masked_select",
})
_DYNAMIC_SHAPE_METHODS = frozenset({"nonzero", "argwhere", "unique",
                                    "unique_consecutive", "masked_select"})

#: makers of a kernel library or compiled callable: a build / load per
#: call or per iteration is the port's silent recompile.  build.load and
#: build.build_all cache their libraries, so only a loop is flagged for
#: them; the rest make a fresh library handle or callable every time
_CACHED_LOADERS = frozenset({"repro_torch.kernels.build.load",
                              "repro_torch.kernels.build.build_all"})
_FRESH_LOADERS = frozenset({
    "ctypes.CDLL", "ctypes.cdll.LoadLibrary",
    "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline",
    "torch.compile", "torch.jit.script", "torch.jit.trace",
})

#: the directories of the batched cost model's card paths (float32 twins)
_TWIN_DIRS = frozenset({"core", "sim", "search"})
_ORACLE_SUFFIXES = ("core/costmodel.py",)


def _target_names(t) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(t):
        if isinstance(node, ast.Name):
            out.add(node.id)
    return out


def _stored_names(t) -> set[str]:
    """Names an assignment target binds: ``a``, ``a, (b, *c)`` — not the
    base of an item or attribute store (``d[k] = ...`` mutates ``d``)."""
    if isinstance(t, ast.Name):
        return {t.id}
    if isinstance(t, (ast.Tuple, ast.List)):
        return set().union(*(_stored_names(e) for e in t.elts)) \
            if t.elts else set()
    if isinstance(t, ast.Starred):
        return _stored_names(t.value)
    return set()


def _bound_names(fn) -> set[str]:
    """Names bound anywhere inside a function node: params, assignments,
    loop/with/comprehension targets, nested defs."""
    a = fn.args
    names = {arg.arg for arg in (*getattr(a, "posonlyargs", ()), *a.args,
                                 *a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                names |= _stored_names(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
            names |= _stored_names(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            names |= _stored_names(node.target)
        elif isinstance(node, ast.comprehension):
            names |= _stored_names(node.target)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            names |= _stored_names(node.optional_vars)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            names.add(node.name)
    return names


def _free_names(fn) -> set[str]:
    """Names a lambda/def loads but does not bind (its closure)."""
    bound = _bound_names(fn)
    loads = {n.id for n in ast.walk(fn)
             if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    return loads - bound


def _bound_names_of_loop(loop) -> set[str]:
    names = set()
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        names |= _target_names(loop.target)
    for stmt in ast.walk(loop):
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                names |= _target_names(t)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            names |= _target_names(stmt.target)
    return names


def _dirs(ctx: LintContext) -> set[str]:
    return set(PurePath(ctx.path.replace("\\", "/")).parts[:-1])


def _is_tensor_call(ctx: LintContext, call: ast.Call) -> bool:
    """A call whose result is a tensor on the operands' device: a torch
    function other than the host-valued ones, or a batched dispatch."""
    name = ctx.resolve(call.func)
    if name and (name == "torch" or name.startswith("torch.")):
        return name not in _TORCH_HOST_CALLS
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr in _DEVICE_METHODS


def _contains_device_value(ctx: LintContext, node,
                           device_names: set[str]) -> bool:
    """Does this expression (sub)tree hold a tensor — a torch call, a
    batched dispatch, or a name assigned from one?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _is_tensor_call(ctx, n):
            return True
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id in device_names:
            return True
    return False


def _device_names_in_scope(ctx: LintContext, scope) -> set[str]:
    """Names assigned from torch calls or batched dispatches in a scope."""
    out: set[str] = set()
    for n in ast.walk(scope):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and _is_tensor_call(ctx, n.value):
            for t in n.targets:
                out |= _target_names(t)
    return out


# -- rule 1: no-silent-rebuild ------------------------------------------------

def _cached_result(ctx: LintContext, call: ast.Call) -> bool:
    """Is this call's result kept past the call — stored into a global,
    a subscript or an attribute (directly, or through the local it was
    assigned to), or is its function memoized?"""
    fn = ctx.enclosing_function(call)
    if fn is None:
        return True                      # module level: runs once
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for dec in fn.decorator_list:
            name = ctx.resolve(dec.func if isinstance(dec, ast.Call) else dec)
            if name in ("functools.cache", "functools.lru_cache", "cache",
                        "lru_cache", "functools.cached_property"):
                return True
    if any(isinstance(n, ast.Global) for n in ast.walk(fn)):
        return True
    stmt = ctx.parent(call)
    if not isinstance(stmt, ast.Assign):
        return False
    if any(isinstance(t, (ast.Subscript, ast.Attribute))
           for t in stmt.targets):
        return True
    locals_ = set().union(*(_target_names(t) for t in stmt.targets))
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Name) \
                and n.value.id in locals_ and any(
                    isinstance(t, (ast.Subscript, ast.Attribute))
                    for t in n.targets):
            return True
    return False


@rule("no-silent-rebuild", severity="error",
      summary="kernel libraries loaded or torch.compile / torch.jit "
              "wrappers made per loop iteration or per call rebuild "
              "silently")
def check_no_silent_rebuild(ctx: LintContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = ctx.resolve(node.func)
        if name not in _FRESH_LOADERS and name not in _CACHED_LOADERS:
            continue
        short = name.replace("repro_torch.kernels.", "")
        fn_arg = node.args[0] if node.args else None

        # (a) a compiled closure capturing an enclosing loop variable:
        # every distinct value is a fresh program
        if isinstance(fn_arg, ast.Lambda):
            frees = _free_names(fn_arg)
            captured = set()
            for loop in ctx.enclosing_loops(node):
                if isinstance(loop, (ast.For, ast.AsyncFor)):
                    captured |= _target_names(loop.target) & frees
            if captured:
                yield (node, f"{short} closes over loop variable(s) "
                             f"{sorted(captured)} — each value is a fresh "
                             f"program to compile; pass them as arguments "
                             f"instead")
                continue

        # (b) built inside a loop
        if ctx.in_loop(node):
            invariant = fn_arg is None or isinstance(
                fn_arg, ast.Constant) or (isinstance(fn_arg, ast.Name) and
                                          not any(
                fn_arg.id in _bound_names_of_loop(loop)
                for loop in ctx.enclosing_loops(node)))
            if invariant:
                yield (node, f"{short} inside a loop rebuilds or reloads a "
                             f"loop-invariant kernel or program every "
                             f"iteration; hoist it out of the loop")
            else:
                yield (node, f"{short} inside a loop builds once per "
                             f"iteration; hoist it if the target is "
                             f"loop-invariant, or suppress if a build per "
                             f"iteration is intended", "warning")
            continue

        # (c) a fresh library handle or callable on every call
        if name in _FRESH_LOADERS and not _cached_result(ctx, node):
            yield (node, f"{short} on every call of its function makes a "
                         f"fresh library handle or compiled callable each "
                         f"time; keep it in a module-level cache (the "
                         f"kernels' `_lib()` pattern) or memoize the "
                         f"function")


# -- rule 2: dtype-discipline -------------------------------------------------

def _is_guard(ctx: LintContext, stmt) -> bool:
    """Is this statement a bare ``require_fp32_matmul(...)`` call?"""
    if not (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)):
        return False
    called = ctx.resolve(stmt.value.func) or ""
    return called.rsplit(".", 1)[-1] == "require_fp32_matmul"


def _matmul_guarded(ctx: LintContext, node) -> bool:
    """Is this product dominated by a ``require_fp32_matmul`` call — one
    that runs before it on every path: an earlier statement of a block
    that holds the product, inside its function or an enclosing one?"""
    child = node
    for anc in ctx.ancestors(node):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(anc, field, None)
            if isinstance(block, list) and child in block:
                if any(_is_guard(ctx, st)
                       for st in block[:block.index(child)]):
                    return True
        child = anc
    return False


@rule("dtype-discipline", severity="error",
      summary="float64 in the float32 batched twins, float32 inside the "
              "float64 oracle, and card-path matrix products without the "
              "FP32 guard")
def check_dtype_discipline(ctx: LintContext):
    path = ctx.path.replace("\\", "/")
    in_oracle = path.endswith(_ORACLE_SUFFIXES)
    in_twin = (not in_oracle and bool(_dirs(ctx) & _TWIN_DIRS)
               and ctx.imports_module("torch"))
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute):
            name = ctx.resolve(node)
            if in_twin and name in _TORCH_F64:
                yield (node, f"{name} in a float32 batched twin — the card "
                             f"path computes in float32 as the reference's "
                             f"jnp twin does; the float64 contract belongs "
                             f"to the numpy oracle")
            elif in_oracle and name and name.endswith(".float32"):
                yield (node, "float32 inside a float64 scalar-oracle module "
                             "— the oracle is the precision reference the "
                             "batched twins are tested against")
        elif isinstance(node, ast.Constant) and node.value == "float32" \
                and in_oracle:
            yield (node, "float32 dtype string inside a float64 "
                         "scalar-oracle module")
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and in_oracle:
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""]
            if any(m == "torch" or m.startswith("torch.") for m in mods):
                yield (node, "torch import inside a scalar-oracle module — "
                             "oracles stay pure float64 numpy; put the "
                             "torch twins in their own module")
        elif isinstance(node, ast.Call):
            name = ctx.resolve(node.func)
            if in_twin and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "double" and not node.args:
                yield (node, "`.double()` in a float32 batched twin — the "
                             "card path computes in float32")
            is_matmul = name in _MATMUL_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _MATMUL_METHODS
                and name not in _MATMUL_CALLS and not (
                    name or "").startswith(("numpy.", "np.")))
            if in_twin and is_matmul and not _matmul_guarded(ctx, node):
                yield (node, _C1_MESSAGE.format(
                    name or f"`.{node.func.attr}()`"))
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult) \
                and in_twin and not _matmul_guarded(ctx, node):
            yield (node, _C1_MESSAGE.format("`@`"))


_C1_MESSAGE = ("{} on a card path of the batched cost model in a function "
               "that never calls torchmodel.require_fp32_matmul — with TF32 "
               "matmuls switched on (a process-wide setting) this product "
               "silently keeps ~3 digits, far outside the 1e-5 bar; guard "
               "its operand first")


# -- rule 3: checkpoint-purity ------------------------------------------------

@rule("checkpoint-purity", severity="error",
      summary="Python side effects inside functions that activation "
              "checkpointing re-runs, or that tracing / graph capture runs "
              "once — prints, registry writes, attribute mutation")
def check_checkpoint_purity(ctx: LintContext):
    bound_cache: dict = {}

    def locals_of(node) -> set[str]:
        """Union of names bound by every enclosing function up to (and
        including) the outermost re-run one — values made by the run,
        which are fair game to mutate."""
        chain = []
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                chain.append(anc)
        key = tuple(id(f) for f in chain)
        if key not in bound_cache:
            names: set[str] = set()
            for f in chain:
                names |= _bound_names(f)
            bound_cache[key] = names
        return bound_cache[key]

    what = ("runs again in the backward under activation checkpointing "
            "(and once only under tracing or graph capture)")
    for node in ast.walk(ctx.tree):
        if not ctx.in_traced(node):
            continue
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "print":
            yield (node, f"print() inside a function that {what}: it fires "
                         f"a second time per step, or never again")
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            kw = "global" if isinstance(node, ast.Global) else "nonlocal"
            yield (node, f"{kw} write inside a function that {what}: the "
                         f"state changes twice per step, or once per trace")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                base = t.value if isinstance(t, (ast.Attribute,
                                                 ast.Subscript)) else None
                if not isinstance(base, ast.Name):
                    continue
                if isinstance(t, ast.Attribute) and (
                        base.id in ("self", "cls")
                        or base.id not in locals_of(node)):
                    yield (t, f"attribute write `{base.id}.{t.attr} = ...` "
                              f"inside a function that {what}")
                elif isinstance(t, ast.Subscript) \
                        and base.id not in locals_of(node):
                    yield (t, f"item write on closed-over `{base.id}` "
                              f"inside a function that {what}")
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            recv = node.func.value
            if isinstance(recv, ast.Name):
                if recv.id not in locals_of(node):
                    yield (node, f"`.{node.func.attr}()` on closed-over "
                                 f"`{recv.id}` inside a function that "
                                 f"{what}; count or record outside it")
            elif isinstance(recv, ast.Call):
                yield (node, f"`.{node.func.attr}()` on a call result "
                             f"(registry/metric write?) inside a function "
                             f"that {what}; record metrics at the call "
                             f"site, outside the re-run region")


# -- rule 4: hidden-host-sync -------------------------------------------------

@rule("hidden-host-sync", severity="error",
      summary=".item()/.cpu()/float()/np.asarray() on tensors and "
              "torch.cuda.synchronize() inside loops stall the card every "
              "iteration on a device→host transfer")
def check_hidden_host_sync(ctx: LintContext):
    if not ctx.imports_module("torch"):
        return
    scope_cache: dict = {}

    def device_names(node) -> set[str]:
        scope = ctx.enclosing_function(node) or ctx.tree
        key = id(scope)
        if key not in scope_cache:
            scope_cache[key] = _device_names_in_scope(ctx, scope)
        return scope_cache[key]

    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and ctx.in_loop(node)):
            continue
        name = ctx.resolve(node.func)
        if name == "torch.cuda.synchronize":
            yield (node, "torch.cuda.synchronize() inside a loop waits for "
                         "the card every iteration — synchronize once after "
                         "the loop, or time with CUDA events")
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _PULL_METHODS and not node.args:
            attr = node.func.attr
            if _contains_device_value(ctx, node.func.value,
                                      device_names(node)):
                yield (node, f"`.{attr}()` on a tensor inside a loop forces "
                             f"a device→host copy and sync every iteration "
                             f"— keep the values on the card and transfer "
                             f"once after the loop")
            elif attr in ("item", "cpu"):
                yield (node, f"`.{attr}()` inside a loop — if the receiver "
                             f"lives on the card this syncs every "
                             f"iteration", "warning")
            continue
        is_cast = isinstance(node.func, ast.Name) \
            and node.func.id in ("float", "int", "bool")
        is_np_pull = name in ("numpy.asarray", "numpy.array")
        if not (is_cast or is_np_pull) or not node.args:
            continue
        if _contains_device_value(ctx, node.args[0], device_names(node)):
            what = node.func.id if is_cast else name.replace("numpy.", "np.")
            yield (node, f"`{what}(...)` on a tensor inside a loop is a "
                         f"hidden host sync per iteration — keep the loop "
                         f"on the card or transfer once afterwards")


# -- rule 5: rng-discipline ---------------------------------------------------

@rule("rng-discipline", severity="error",
      summary="global numpy/stdlib/torch rng state and torch samplers "
              "without a generator break seed-for-seed reproducibility")
def check_rng_discipline(ctx: LintContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = ctx.resolve(node.func)
        if name and name.startswith("numpy.random.") \
                and name.split(".")[-1] in _LEGACY_NP_RANDOM:
            yield (node, f"np.random.{name.split('.')[-1]}() draws from "
                         f"GLOBAL rng state — every generator takes an "
                         f"explicit np.random.Generator (rng=) so traces "
                         f"are seed-for-seed reproducible and rng-stream "
                         f"compatible")
        elif name and name.startswith("random.") and "random" in ctx.imports \
                and ctx.imports["random"] == "random":
            yield (node, f"stdlib {name}() draws from global rng state — "
                         f"pass an explicit np.random.Generator instead")
        elif name in _TORCH_GLOBAL_SEED:
            yield (node, f"{name}() seeds or reads torch's GLOBAL generator "
                         f"— every draw takes an explicit torch.Generator "
                         f"(generator=) seeded from the caller's seed")
        elif name in _TORCH_SAMPLERS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _TORCH_SAMPLER_METHODS):
            if any(kw.arg == "generator" for kw in node.keywords):
                continue
            what = name if name in _TORCH_SAMPLERS else \
                f".{node.func.attr}"
            yield (node, f"{what}() without generator= draws from torch's "
                         f"GLOBAL generator — pass an explicit "
                         f"torch.Generator seeded from the caller's seed")


# -- rule 6: kernel-wrapper-constraints ---------------------------------------

_ALLOCATORS = frozenset({"torch.empty", "torch.empty_like", "torch.zeros",
                         "torch.zeros_like", "torch.ones", "torch.ones_like",
                         "torch.full", "torch.full_like",
                         "torch.empty_strided"})
# what a guard must look at for a tensor to count as checked without a
# check function: its device, dtype, shape and layout
_GUARD_KINDS = {"device": "device", "dtype": "dtype", "shape": "shape",
                "dim": "shape", "numel": "shape", "size": "shape",
                "is_contiguous": "layout", "stride": "layout",
                "data_ptr": "layout"}


def _is_check_name(name: str) -> bool:
    """A check function's name: ``_check``, ``check_shape``, ...."""
    return name.rsplit(".", 1)[-1].lstrip("_").lower().startswith("check")


def _is_check_call(ctx: LintContext, call: ast.Call) -> bool:
    return _is_check_name(ctx.resolve(call.func) or "")


def _raises(stmts) -> bool:
    return any(isinstance(n, ast.Raise) for s in stmts for n in ast.walk(s))


def _launch_helpers(ctx: LintContext) -> dict[str, set[int]]:
    """Module functions that launch on the data pointers of a collection
    they are handed and do not check (``_launch(name, tensors, ...)``, whose
    ``t.data_ptr() for t in tensors`` builds the launch's arguments): name
    → the positions of those parameters.  Their callers' arguments at
    those positions are what is handed to the launch, and are checked
    there."""
    out: dict[str, set[int]] = {}
    for fn in ctx.tree.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = [a.arg for a in fn.args.args]
        checked = _checked_names(ctx, fn)
        hit: set[int] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.comprehension) \
                    and isinstance(n.iter, ast.Name) \
                    and n.iter.id in params and n.iter.id not in checked \
                    and any(isinstance(c, ast.Call)
                            and isinstance(c.func, ast.Attribute)
                            and c.func.attr == "data_ptr"
                            for c in ast.walk(ctx.parent(n))):
                hit.add(params.index(n.iter.id))
        if hit:
            out[fn.name] = hit
    return out


def _launched(ctx: LintContext, fn, helpers) -> list[tuple[str, ast.AST]]:
    """(tensor name, node) for every tensor this function hands to a launch:
    ``t.data_ptr()`` on a name, or an argument of a launch helper.  A
    helper's own loop over its tensor parameter is left to its callers."""
    helper_params = {fn.args.args[i].arg for i in helpers.get(fn.name, ())}
    out = []
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) and n.func.attr == "data_ptr" \
                and isinstance(n.func.value, ast.Name):
            name = n.func.value.id
            if not _over_params(fn, name, helper_params):
                out.append((name, n))
        elif isinstance(n.func, ast.Name) and n.func.id in helpers:
            for i in helpers[n.func.id]:
                if i < len(n.args):
                    for name in _target_names(n.args[i]):
                        out.append((name, n))
    return out


def _over_params(fn, name: str, params: set[str]) -> bool:
    """Is ``name`` a comprehension variable over one of ``params``?"""
    return any(isinstance(c, ast.comprehension)
               and isinstance(c.iter, ast.Name) and c.iter.id in params
               and name in _target_names(c.target) for c in ast.walk(fn))


def _checked_names(ctx: LintContext, fn) -> dict[str, int]:
    """Tensor name → the line by which the wrapper has vouched for it: an
    argument of a check call (directly, or as the loop variable of a loop
    over tuples that holds it), an allocation of the wrapper's own, a view
    made of a checked tensor, or a tensor every property of which — its
    device, dtype, shape and layout — a raising guard looked at."""
    checked: dict[str, int] = {}
    guarded: dict[str, set] = {}

    def vouch(name, line):
        if name not in checked or line < checked[name]:
            checked[name] = line

    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and _is_check_call(ctx, n):
            args = [*n.args, *(k.value for k in n.keywords)]
            names = set().union(*(_target_names(a) for a in args)) \
                if args else set()
            for name in names:
                vouch(name, n.lineno)
            loop = next((a for a in ctx.ancestors(n)
                         if isinstance(a, ast.For)), None)
            if loop is not None and names & _target_names(loop.target):
                for name in _target_names(loop.iter):
                    vouch(name, n.lineno)
        elif isinstance(n, ast.If) and _raises(n.body):
            loop = next((a for a in ctx.ancestors(n)
                         if isinstance(a, ast.For)), None)
            for sub in ast.walk(n.test):
                if isinstance(sub, ast.Attribute) \
                        and isinstance(sub.value, ast.Name) \
                        and sub.attr in _GUARD_KINDS:
                    names = {sub.value.id}
                    if loop is not None and sub.value.id in _target_names(
                            loop.target):
                        names |= _target_names(loop.iter)
                    for name in names:
                        guarded.setdefault(name, set()).add(
                            _GUARD_KINDS[sub.attr])
                        if len(guarded[name]) == 4:
                            vouch(name, n.lineno)
    allocators = _allocator_aliases(ctx, fn)
    for n in ast.walk(fn):
        if not isinstance(n, ast.Assign):
            continue
        pairs = []
        for t in n.targets:
            if isinstance(t, ast.Tuple) and isinstance(n.value, ast.Tuple):
                pairs += list(zip(t.elts, n.value.elts))
            else:
                pairs.append((t, n.value))
        for t, v in pairs:
            if isinstance(t, ast.Name) and _vouched_value(ctx, v, checked,
                                                          allocators):
                vouch(t.id, n.lineno)
    return checked


def _allocator_aliases(ctx: LintContext, fn) -> set[str]:
    """Local names bound to an allocator (``part = torch.empty if ... else
    torch.zeros``)."""
    out = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            vals = [n.value.body, n.value.orelse] \
                if isinstance(n.value, ast.IfExp) else [n.value]
            if vals and all(ctx.resolve(v) in _ALLOCATORS for v in vals):
                out.add(n.targets[0].id)
    return out


def _vouched_value(ctx: LintContext, v, checked, allocators) -> bool:
    if isinstance(v, ast.IfExp):
        return all(_vouched_value(ctx, b, checked, allocators)
                   for b in (v.body, v.orelse))
    if isinstance(v, ast.Constant) and v.value is None:
        return True
    if isinstance(v, ast.Name):
        return v.id in checked
    if isinstance(v, ast.Call):
        name = ctx.resolve(v.func)
        if name in _ALLOCATORS or (isinstance(v.func, ast.Name)
                                   and v.func.id in allocators):
            return True
        # a contiguous / float32 view of a checked tensor
        if isinstance(v.func, ast.Attribute) \
                and v.func.attr in ("contiguous", "float", "view",
                                    "reshape", "zero_") \
                and isinstance(v.func.value, ast.Name):
            return v.func.value.id in checked
    return False


def _dynamic_shape_op(ctx: LintContext, n, masks: set[str]) -> str | None:
    if isinstance(n, ast.Call):
        name = ctx.resolve(n.func)
        if name in _DYNAMIC_SHAPE_CALLS:
            return name
        if name == "torch.where" and len(n.args) == 1:
            return "single-argument torch.where"
        if isinstance(n.func, ast.Attribute) \
                and n.func.attr in _DYNAMIC_SHAPE_METHODS \
                and name not in _DYNAMIC_SHAPE_CALLS:
            return f".{n.func.attr}()"
    elif isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Load):
        idx = n.slice
        if isinstance(idx, ast.Compare) or (isinstance(idx, ast.Name)
                                            and idx.id in masks) or (
                isinstance(idx, ast.Call)
                and isinstance(idx.func, ast.Attribute)
                and idx.func.attr == "bool"):
            return "boolean-mask indexing"
    return None


@rule("kernel-wrapper-constraints", severity="error",
      summary="tensors handed to a ctypes launch without the wrapper's "
              "device/dtype/shape/contiguity check, and value-dependent "
              "shapes between the check and the launch")
def check_kernel_wrapper_constraints(ctx: LintContext):
    if not ctx.imports_module("ctypes"):
        return
    helpers = _launch_helpers(ctx)
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or _is_check_name(fn.name):
            continue
        launched = _launched(ctx, fn, helpers)
        if not launched:
            continue
        checked = _checked_names(ctx, fn)
        for name, node in launched:
            line = checked.get(name)
            if line is None or line > node.lineno:
                yield (node, f"`{name}` reaches a kernel launch without "
                             f"passing the wrapper's device / dtype / shape "
                             f"/ contiguity check — the kernel reads raw "
                             f"pointers and trusts every stride and size")
        first = min(checked.values(), default=None)
        last = max((node.lineno for _, node in launched), default=None)
        if first is None:
            continue
        masks = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Compare):
                for t in n.targets:
                    masks |= _target_names(t)
        for n in ast.walk(fn):
            what = _dynamic_shape_op(ctx, n, masks)
            if what and first <= getattr(n, "lineno", 0) <= last:
                yield (n, f"{what} between the wrapper's check and its "
                          f"launch has a value-dependent shape — the launch "
                          f"takes the shapes the check fixed; mask with a "
                          f"fill value at a static shape instead")
