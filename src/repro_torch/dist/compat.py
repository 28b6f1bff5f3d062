"""Collectives of the mesh sync on ``torch.distributed`` — the port of the
collective helpers of ``repro.dist.compat`` (its JAX shims have no torch
counterpart).

A :class:`Mesh` lays the ranks of the default process group out as
``(pods…, data)``, row-major, as ``jax.make_mesh(dp_sizes, axis_names)``
lays out devices, and holds this rank's process group over all axes, over
the data axis and over the pod axes.  A rank's index in a group is its row-major index over
those axes: the index ``sharded_codec._peer_key`` folds into the key, and
peer ``p·nd + d`` of the one-device replay.  The caller initializes the
default process group (any backend); the mesh only creates subgroups of it.

The helpers take the mesh and an axis name or a tuple of them, as the JAX
ones take an axis name inside ``shard_map``.  An axis of size 1 moves
nothing.  Every collective is synchronous: it returns a tensor on the
device of its input.
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


class Mesh:
    """The data-parallel mesh ``dp_sizes`` (pods…, data) over the ranks of
    the default process group, rank ``r`` at the row-major coordinates of
    ``r``.  ``axis_names`` default to ``("data",)`` or ``("pod", "data")``.

    It holds the groups the sync bodies use: all axes, the innermost (data)
    axis and the pod axes before it.  Every rank must build the same mesh
    at the same point of its program: the constructor creates the
    subgroups (``dist.new_group``, which all ranks of the default group
    call in one order).
    """

    def __init__(self, dp_sizes: Sequence[int], axis_names: Sequence[str] | None = None):
        sizes = tuple(int(s) for s in dp_sizes)
        if axis_names is None:
            if not 1 <= len(sizes) <= 2:
                raise ValueError(f"name the axes of mesh {sizes}")
            axis_names = ("pod", "data")[-len(sizes):]
        names = tuple(axis_names)
        if not sizes or len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"mesh needs one distinct name per axis: {sizes} {names}")
        if not dist.is_initialized():
            raise RuntimeError("initialize the default process group before building a Mesh")
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {sizes} has {math.prod(sizes)} ranks, the process group "
                             f"{world}")
        self.axis_names = names
        self.dp_sizes = sizes
        self.rank = dist.get_rank()
        n_axes = len(sizes)
        strides = [math.prod(sizes[i + 1:]) for i in range(n_axes)]
        coords = [self.rank // st % s for st, s in zip(strides, sizes)]
        self._axes = {}
        # all axes, the data axis, the pod axes (empty on a 1-axis mesh)
        for sub in dict.fromkeys((tuple(range(n_axes)), (n_axes - 1,),
                                  tuple(range(n_axes - 1)))):
            size = math.prod(sizes[i] for i in sub)
            index = 0
            for i in sub:
                index = index * sizes[i] + coords[i]
            group = None
            if size == world:
                group = dist.group.WORLD
            elif size > 1:
                # one group for each setting of the other axes; every rank
                # creates all of them, in this order
                rest = [i for i in range(n_axes) if i not in sub]
                for fixed in itertools.product(*(range(sizes[i]) for i in rest)):
                    base = sum(strides[i] * c for i, c in zip(rest, fixed))
                    ranks = sorted(base + sum(strides[i] * c for i, c in zip(sub, at))
                                   for at in itertools.product(*(range(sizes[i]) for i in sub)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        group = g
            self._axes[tuple(names[i] for i in sub)] = _Axes(group, size, index)

    def axes(self, axis_name) -> _Axes:
        """This rank's group, size and index over ``axis_name``: a name or a
        tuple of names in mesh order, one of all axes, the data axis and
        the pod axes."""
        key = tuple(axis_name) if isinstance(axis_name, tuple | list) else (axis_name,)
        try:
            return self._axes[key]
        except KeyError:
            raise KeyError(f"no axes {key} in mesh {self.axis_names} (give them in mesh "
                           "order)") from None

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.dp_sizes))}, rank={self.rank})"


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
    flat = x.reshape(-1).contiguous()
    # the concatenated form of the output: gloo on a CUDA tensor (torch
    # 2.11) refuses the stacked one
    out = flat.new_empty(ax.size * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=ax.group)
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
    parts = parts.contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=ax.group)
    return out


def psum(x: torch.Tensor, mesh: Mesh, axis_name) -> torch.Tensor:
    """The sum of ``x`` over ``axis_name`` (a new tensor; the backend owns
    the order of the adds)."""
    ax = mesh.axes(axis_name)
    out = x.clone()
    if ax.size > 1:
        dist.all_reduce(out, group=ax.group)
    return out
