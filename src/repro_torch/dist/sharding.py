"""Logical-axis sharding: the port of ``repro.dist.sharding``, and the
tensor-parallel sums of the model axis.

Model code never names mesh axes.  ``models.transformer.logical_axes(cfg)``
is the tree of *logical axis tuples* (``("embed_fsdp", "heads")`` …) that
the JAX package's ``init_lm`` returns beside the params, and this module
maps it onto a mesh (``dist.compat.Mesh`` or ``AbstractMesh``):

- ``data`` / ``pod`` — the batch-parallel (manual) axes; the gradient sync
  crosses them;
- ``model`` — the tensor-parallel axis of heads, ff and vocab;
- ``embed_fsdp`` — mapped to ``data`` when ``cfg.fsdp``.  The port keeps a
  leaf whole on every data rank (the ``fsdp``/``streamed`` item of the
  ROADMAP), so the specs name ``data`` as JAX's do and the numbers are the
  same; :func:`local_shard` slices the model axis only.

:func:`param_pspecs` is JAX's, divisibility pruning included: an axis
that does not divide its dimension leaves it whole.  :func:`local_shard`
and :func:`gather_shards` (and their tree forms) cut a full tensor to the
slice a rank holds and join the slices back.

JAX's ``shard``/``axis_rules`` constrain activations for GSPMD.  The port
has no partitioner: :func:`axis_rules` installs the mesh and the rule
table, and the layers (``models.layers``, ``attention``, ``transformer``)
read a split from their weights' local shapes and take the sums of a
split from here, Megatron's way: :func:`copy_to_model` (identity forward,
a model-group sum backward) before a column-parallel product,
:func:`reduce_from_model` (the sum forward, identity backward) after a
row-parallel one.  Outside a context, or on a model axis of 1, nothing is
issued.  Partials are summed in their own dtype (gloo takes bfloat16, on
the CPU and on CUDA tensors), every rank getting the same bits.
"""
from __future__ import annotations

import functools
import math
from contextlib import contextmanager

import torch

from . import compat

# Logical axes that live on the tensor-parallel mesh axis.
MODEL_AXES = ("vocab", "heads", "kv_heads", "ff", "expert")
# Logical axes that are never sharded (layer stacking, plain embed dim).
REPLICATED_AXES = ("layers", "embed", "seq")

SHARDING_ITEM = "ROADMAP Queue 1, item 4.2 (dist/sharding.py: tensor and expert parallelism)"

_ACTIVE: list = []


class PartitionSpec(tuple):
    """A parameter's mesh axes, one entry a dimension (an axis name, a
    tuple of them, or None): JAX's ``PartitionSpec`` as a plain tuple,
    which, as JAX's, holds a tuple of one axis as that axis."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def data_axes(mesh) -> tuple | None:
    """Batch-parallel mesh axes, outermost first (``("pod", "data")`` …)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes or None


def manual_axes(mesh) -> tuple:
    """The axes the gradient sync crosses (JAX's shard_map axis names)."""
    return data_axes(mesh) or ()


def activation_rules(mesh, *, manual_data: bool = False, fsdp: bool = False) -> dict:
    """Logical→mesh rule table (``manual_data`` drops the batch and fsdp
    axes, as inside JAX's train step)."""
    rules: dict = {}
    if "model" in mesh.axis_names:
        for name in MODEL_AXES:
            rules[name] = "model"
    if not manual_data:
        dp = data_axes(mesh)
        if dp:
            rules["batch"] = dp
        if fsdp and "data" in mesh.axis_names:
            rules["embed_fsdp"] = "data"
    return rules


@contextmanager
def axis_rules(mesh, rules: dict):
    """Make ``mesh`` and ``rules`` the active table for the layers' sums."""
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


def model_axis():
    """``(mesh, size, index)`` of the active model axis, or None outside a
    context, without a model rule or on a model axis of 1."""
    if not _ACTIVE:
        return None
    mesh, rules = _ACTIVE[-1]
    if rules.get("heads") != "model" or getattr(mesh, "model_size", 1) == 1:
        return None
    ax = mesh.axes("model")
    return mesh, ax.size, ax.index


def check_model_axis(cfg, n_model: int) -> None:
    """Refuse what this slice of the model axis does not cover: the dense
    decoders whose KV heads divide the axis train and serve on it."""
    if n_model == 1:
        return
    where = f"--mesh with a model axis of {n_model}"
    if cfg.moe is not None:
        raise ValueError(
            f"{cfg.name}: {where}: JAX's MoE parameter specs name the model axis twice and "
            f"JAX refuses to place them (ROADMAP fact F17), so expert parallelism waits for "
            f"{SHARDING_ITEM}")
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: {where}: the {cfg.family} family on a model axis waits "
                         f"for {SHARDING_ITEM}")
    if cfg.num_kv_heads % n_model or cfg.num_heads % n_model:
        raise ValueError(f"{cfg.name}: {where}: {cfg.num_kv_heads} KV heads do not divide the "
                         f"axis (a head split within itself waits for {SHARDING_ITEM})")


# -- parameter specs -----------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of nested dicts (sorted keys, as JAX
    walks them) and NamedTuples (an optimizer's state), with the matching
    leaves of ``rest``.  An axes tuple or a PartitionSpec is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *parts) for parts in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and NamedTuples in JAX's order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves: list):
    """:func:`tree_leaves`' inverse onto the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _leaf_pspec(axes: tuple, shape: tuple | None, mesh, fsdp: bool) -> PartitionSpec:
    entries = []
    for dim, name in enumerate(axes):
        mapped = None
        if name in MODEL_AXES and "model" in mesh.axis_names:
            mapped = "model"
        elif name == "embed_fsdp" and fsdp and "data" in mesh.axis_names:
            mapped = "data"
        if mapped is not None and shape is not None and shape[dim] % mesh.shape[mapped] != 0:
            mapped = None
        entries.append(mapped)
    return PartitionSpec(*entries)


def _names_expert(tree) -> bool:
    if isinstance(tree, dict):
        return any(_names_expert(v) for v in tree.values())
    return "expert" in tree


def param_pspecs(logical, mesh, fsdp: bool, params_like=None):
    """PartitionSpec tree for a parameter tree described by ``logical``.

    ``params_like`` (tensors, meta or not, of the full shapes) enables
    divisibility pruning.  An MoE tree on a model axis above 1 raises:
    JAX's specs name the model axis twice there (ROADMAP fact F17)."""
    if mesh.shape.get("model", 1) > 1 and _names_expert(logical):
        raise ValueError(f"expert weights on a model axis of {mesh.shape['model']}: JAX's MoE "
                         f"parameter specs name the model axis twice (ROADMAP fact F17); "
                         f"expert parallelism waits for {SHARDING_ITEM}")
    if params_like is None:
        return tree_map(lambda a: _leaf_pspec(a, None, mesh, fsdp), logical)
    return tree_map(lambda a, x: _leaf_pspec(a, tuple(x.shape), mesh, fsdp), logical, params_like)


@functools.lru_cache(maxsize=16)
def _lm_pspecs(cfg, axis_names: tuple, sizes: tuple):
    from repro_torch.core import prng
    from repro_torch.dist.compat import AbstractMesh
    from repro_torch.models import transformer

    # repro: allow REPRO204 (a meta draw has no values: the key shapes nothing)
    like = transformer.init_lm(prng.key(0), cfg, device="meta")
    return param_pspecs(transformer.logical_axes(cfg), AbstractMesh(sizes, axis_names),
                        cfg.fsdp, like)


def lm_pspecs(cfg, mesh) -> dict:
    """:func:`param_pspecs` of the LM zoo's params for ``cfg`` on ``mesh``
    (``models.transformer.logical_axes``, pruned on the full shapes of a
    meta init), as JAX's ``make_train_step`` and ``make_serve_fns`` derive
    them."""
    return _lm_pspecs(cfg, tuple(mesh.axis_names), tuple(mesh.sizes))


def strip_to_manual(spec_tree, mesh):
    """Project a PartitionSpec tree onto the manual (data/pod) axes only."""
    keep = set(manual_axes(mesh))

    def one(spec):
        entries = []
        for e in spec:
            if isinstance(e, tuple):
                kept = tuple(a for a in e if a in keep)
                entries.append(kept if kept else None)
            else:
                entries.append(e if e in keep else None)
        return PartitionSpec(*entries)

    return tree_map(one, spec_tree)


def model_split(spec, mesh) -> list:
    """``(dim, axes)`` of each dimension that ``spec`` splits over the
    non-manual (model) axes of ``mesh``."""
    manual = set(manual_axes(mesh))
    out = []
    for dim, e in enumerate(spec):
        axes = e if isinstance(e, tuple) else (e,) if e is not None else ()
        axes = tuple(a for a in axes if a not in manual)
        if axes and math.prod(mesh.shape[a] for a in axes) > 1:
            out.append((dim, axes))
    return out


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The slice of the full tensor ``x`` that this rank of ``mesh`` holds:
    each dimension ``spec`` maps to the model axis cut to its block
    (``mesh.coords``); data entries (fsdp) stay whole.  A new tensor, so
    the full one can be freed."""
    out = x
    for dim, axes in model_split(spec, mesh):
        n, idx = 1, 0
        for a in axes:
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + mesh.coords[a]
        size = x.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather_shards(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The inverse of :func:`local_shard`: the full tensor, from every
    model rank's slice (a collective over the model axis; every rank of it
    calls it, and every rank gets the full tensor)."""
    for dim, axes in reversed(model_split(spec, mesh)):
        if axes != ("model",):
            raise ValueError(f"gather_shards joins the model axis, not {axes}")
        parts = _gather_bits(x, mesh, "model")            # (n, *x.shape)
        x = parts.movedim(0, dim).reshape(
            tuple(x.shape[:dim]) + (parts.shape[0] * x.shape[dim],) + tuple(x.shape[dim + 1:]))
    return x


def shard_tree(tree: dict, pspecs: dict, mesh) -> dict:
    """:func:`local_shard` over a params tree (full tensors, e.g. from
    ``init_lm`` or ``transformer.params_from_jax``)."""
    return tree_map(lambda x, s: local_shard(x, s, mesh), tree, pspecs)


def gather_tree(tree: dict, pspecs: dict, mesh) -> dict:
    """:func:`gather_shards` over a tree of this rank's slices."""
    return tree_map(lambda x, s: gather_shards(x, s, mesh), tree, pspecs)


def _gather_bits(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """All-gather of ``x``'s bits into (n, *x.shape): a bfloat16 or float16
    tensor travels as its bytes (uint8, which every backend moves)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        raw = x.contiguous().reshape(-1).view(torch.uint8)
        parts = compat.all_gather_stacked(raw, mesh, axis)
        return parts.view(x.dtype).reshape(parts.shape[0], *x.shape)
    return compat.all_gather_stacked(x, mesh, axis)


# -- the tensor-parallel sums ------------------------------------------------


def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    # in the partials' own dtype: gloo adds bfloat16 tensors, on the CPU and
    # on CUDA, converting each pair to float32 and rounding the sum once, so
    # over two model ranks a bfloat16 sum is the float32 sum rounded
    return compat.psum(x, mesh, "model")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _active_mesh(what: str):
    tp = model_axis()
    if tp is None:
        raise RuntimeError(f"{what}: a weight is split over a model axis, but no model axis "
                           "is active (run it inside dist.sharding.axis_rules)")
    return tp[0]


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as is; its gradient summed over the model group (the input of
    a column-parallel product)."""
    return _CopyToModel.apply(x, _active_mesh("copy_to_model"))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group; its gradient as is (the output of
    a row-parallel product)."""
    return _ReduceFromModel.apply(x, _active_mesh("reduce_from_model"))


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model group (no gradient)."""
    return compat.pmax(x.detach(), _active_mesh("max_over_model"), "model")


def gather_over_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every model rank's ``x`` joined on ``dim`` in rank order (no
    gradient): the vocab-parallel logits made whole."""
    mesh = _active_mesh("gather_over_model")
    dim = dim % x.dim()
    parts = _gather_bits(x.detach(), mesh, "model")
    return parts.movedim(0, dim).reshape(
        tuple(x.shape[:dim]) + (parts.shape[0] * x.shape[dim],) + tuple(x.shape[dim + 1:]))


def vocab_range(local_rows: int, full_rows: int) -> tuple[int, int] | None:
    """``(start, rows)`` of this rank's vocab block when a vocab dimension
    of ``full_rows`` is split to ``local_rows``, else None."""
    if local_rows == full_rows:
        return None
    _, size, index = model_axis() or (None, 1, 0)
    if local_rows * size != full_rows:
        raise RuntimeError(f"a vocab block of {local_rows} is not 1/{size} of {full_rows} "
                           "(run it inside dist.sharding.axis_rules)")
    return index * local_rows, local_rows
