"""Collectives of the mesh on ``torch.distributed`` — the port of the
collective helpers of ``repro.dist.compat`` (its JAX shims have no torch
counterpart).

A :class:`Mesh` lays the ranks of the default process group out as
``(pods…, data[, model])``, row-major, as ``jax.make_mesh(sizes,
axis_names)`` lays out devices, and holds this rank's process group over
the manual (pod and data) axes, over the data axis, over the pod axes and
over the model axis.  A rank's index in a group is its row-major index
over those axes: the index ``sharded_codec._peer_key`` folds into the key,
and peer ``p·nd + d`` of the one-device replay.  The caller initializes
the default process group (any backend); the mesh only creates subgroups
of it.  :class:`AbstractMesh` is the same geometry without groups.

The helpers take the mesh and an axis name or a tuple of them, as the JAX
ones take an axis name inside ``shard_map``.  An axis of size 1 moves
nothing, and neither does a meta tensor (the dry run's: the result has
the shape the collective would give).  Every collective is synchronous:
it returns a tensor on the device of its input.
"""
from __future__ import annotations

import itertools
import math
from collections.abc import Sequence
from typing import NamedTuple

import torch
import torch.distributed as dist


class _Axes(NamedTuple):
    group: object | None  # this rank's process group over the axes; None at size 1
    size: int
    index: int            # this rank's row-major index over the axes


def _axis_sets(names: tuple) -> dict:
    """The axis sets a mesh holds groups for, in the order every rank
    creates them: the manual (pod and data) axes, the data axis (the last
    manual one), the pod axes before it, and the model axis."""
    manual = tuple(i for i, n in enumerate(names) if n != "model")
    sets = [manual, manual[-1:], manual[:-1]]
    if "model" in names:
        sets.append((names.index("model"),))
    return dict.fromkeys(sets)


class AbstractMesh:
    """The geometry of a mesh without its process groups: ``sizes`` over
    ``axis_names`` (default ``("data",)`` or ``("pod", "data")``), rank
    ``rank`` at the row-major coordinates of ``rank``, as ``jax.make_mesh``
    lays out devices.  A model axis, named ``"model"``, comes last.

    ``shape`` maps each name to its size (as a JAX mesh's does), ``coords``
    to this rank's index on it; ``dp_axes``/``dp_sizes`` are the manual
    (pod and data) axes and their sizes, ``model_size`` the model axis's
    size (1 without one).  The specs (``dist.sharding``) and the dry run
    read this; the collectives here take a :class:`Mesh`, or meta tensors
    on an abstract one (shapes, no communication)."""

    def __init__(self, dp_sizes: Sequence[int], axis_names: Sequence[str] | None = None,
                 rank: int = 0):
        sizes = tuple(int(s) for s in dp_sizes)
        if axis_names is None:
            if not 1 <= len(sizes) <= 2:
                raise ValueError(f"name the axes of mesh {sizes}")
            axis_names = ("pod", "data")[-len(sizes):]
        names = tuple(axis_names)
        if not sizes or len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"mesh needs one distinct name per axis: {sizes} {names}")
        if "model" in names and (names[-1] != "model" or len(names) == 1):
            raise ValueError(f"the model axis comes last, after a data axis: {names}")
        if not 0 <= rank < math.prod(sizes):
            raise ValueError(f"rank {rank} is not on mesh {sizes}")
        self.axis_names = names
        self.sizes = sizes
        self.shape = dict(zip(names, sizes))
        self.dp_axes = tuple(n for n in names if n != "model")
        self.dp_sizes = tuple(self.shape[n] for n in self.dp_axes)
        self.model_size = self.shape.get("model", 1)
        self.rank = rank
        self._strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        self.coords = {n: rank // st % s for n, st, s in zip(names, self._strides, sizes)}
        self._axes = {}
        for sub in _axis_sets(names):
            self._axes[tuple(names[i] for i in sub)] = _Axes(None, *self._size_index(sub))

    def _size_index(self, sub: tuple) -> tuple[int, int]:
        size, index = 1, 0
        for i in sub:
            size *= self.sizes[i]
            index = index * self.sizes[i] + self.coords[self.axis_names[i]]
        return size, index

    def axes(self, axis_name) -> _Axes:
        """This rank's group, size and index over ``axis_name``: a name or a
        tuple of names in mesh order, one of the manual axes, the data
        axis, the pod axes and the model axis."""
        key = tuple(axis_name) if isinstance(axis_name, tuple | list) else (axis_name,)
        try:
            return self._axes[key]
        except KeyError:
            raise KeyError(f"no axes {key} in mesh {self.axis_names} (give them in mesh "
                           "order)") from None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape}, rank={self.rank})"


class Mesh(AbstractMesh):
    """The mesh ``dp_sizes`` over the ranks of the default process group,
    rank ``r`` at the row-major coordinates of ``r``: the data-parallel
    axes (pods…, data) and, named ``"model"`` last, an optional model
    (tensor-parallel) axis — rank ``d·M + m`` of a (D, M) mesh.  The
    gradient sync crosses the manual axes only; the model axis carries the
    layers' sums (``dist.sharding``).

    It holds the groups the sync bodies and the layers use: the manual
    axes, the data axis, the pod axes and the model axis.  Every rank
    must build the same mesh at the same point of its program: the
    constructor creates the subgroups (``dist.new_group``, which all ranks
    of the default group call in one order).  A mesh without a model axis
    creates exactly the groups it did before there was one.
    """

    def __init__(self, dp_sizes: Sequence[int], axis_names: Sequence[str] | None = None):
        if not dist.is_initialized():
            raise RuntimeError("initialize the default process group before building a Mesh")
        sizes = tuple(int(s) for s in dp_sizes)
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {sizes} has {math.prod(sizes)} ranks, the process group "
                             f"{world}")
        super().__init__(sizes, axis_names, dist.get_rank())
        n_axes = len(self.sizes)
        strides = self._strides
        for sub in _axis_sets(self.axis_names):
            size, index = self._size_index(sub)
            group = None
            if size == world:
                group = dist.group.WORLD
            elif size > 1:
                # one group for each setting of the other axes; every rank
                # creates all of them, in this order
                rest = [i for i in range(n_axes) if i not in sub]
                for fixed in itertools.product(*(range(self.sizes[i]) for i in rest)):
                    base = sum(strides[i] * c for i, c in zip(rest, fixed))
                    ranks = sorted(base + sum(strides[i] * c for i, c in zip(sub, at))
                                   for at in itertools.product(*(range(self.sizes[i])
                                                                 for i in sub)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        group = g
            self._axes[tuple(self.axis_names[i] for i in sub)] = _Axes(group, size, index)


def axis_size(mesh: Mesh, axis_name) -> int:
    """Number of ranks over ``axis_name`` (a name or a tuple of names)."""
    return mesh.axes(axis_name).size


def flat_axis_index(mesh: Mesh, axis_name) -> int:
    """This rank's row-major linear index over one or more mesh axes."""
    return mesh.axes(axis_name).index


def all_gather_stacked(x: torch.Tensor, mesh: Mesh, axis_name) -> torch.Tensor:
    """All-gather ``x`` over ``axis_name`` into a stacked (n, *x.shape) tensor,
    row p from the rank of index p."""
    ax = mesh.axes(axis_name)
    if ax.size == 1:
        return x[None]
    if x.is_meta:
        return x[None].expand(ax.size, *x.shape).clone()
    flat = x.reshape(-1).contiguous()
    # the concatenated form of the output: gloo on a CUDA tensor (torch
    # 2.11) refuses the stacked one
    out = flat.new_empty(ax.size * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=_group(ax))
    return out.reshape(ax.size, *x.shape)


def all_to_all_rows(parts: torch.Tensor, mesh: Mesh, axis_name) -> torch.Tensor:
    """All-to-all over the leading axis: row p of ``parts`` goes to the rank
    of index p; row p of the result is the row that rank addressed to this
    one.  ``parts`` has leading dim n = the size of ``axis_name``."""
    ax = mesh.axes(axis_name)
    if ax.size == 1:
        return parts
    if parts.shape[0] != ax.size:
        raise ValueError(f"all_to_all_rows needs {ax.size} rows, got {tuple(parts.shape)}")
    if parts.is_meta:
        return parts.clone()
    parts = parts.contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=_group(ax))
    return out


def psum(x: torch.Tensor, mesh: Mesh, axis_name) -> torch.Tensor:
    """The sum of ``x`` over ``axis_name`` (a new tensor; the backend owns
    the order of the adds)."""
    return _all_reduce(x, mesh, axis_name, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: Mesh, axis_name) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis_name`` (a new tensor)."""
    return _all_reduce(x, mesh, axis_name, dist.ReduceOp.MAX)


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis_name, op) -> torch.Tensor:
    ax = mesh.axes(axis_name)
    out = x.clone()
    if ax.size > 1 and not x.is_meta:
        dist.all_reduce(out, op=op, group=_group(ax))
    return out


def _group(ax: _Axes):
    if ax.group is None:
        raise RuntimeError("an AbstractMesh has no process groups: its collectives take "
                           "meta tensors only")
    return ax.group
