"""Operation cost of eager PyTorch code — the counterpart of
``repro.launch.hlo_analysis``.

The JAX package walks compiled HLO text.  Here :class:`OpCost` is a
``TorchDispatchMode``: run the code under it (on ``meta`` tensors for a
dry run: shapes without storage) and every aten op it reaches is counted
as it runs.  A Python loop (a tile loop, the units of a model) is counted
once an iteration, so no trip count is guessed.

Cost model per op:

- **FLOPs.**  Matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``convolution``) count 2·m·n·k, kept apart by the dtype of their inputs
  (``matmul_flops``): a card's rate depends on it.  A pointwise op counts
  one FLOP an output element, as ``hlo_analysis`` counts elementwise HLO
  ops; a reduction one an input element.  Other ops (copies, gathers,
  indexing) count none.
- **Bytes.**  Each op reads each tensor input once and writes each output
  once: eager PyTorch launches a kernel an op, so this is eager's device
  memory traffic, the counterpart of XLA's fusion-boundary bytes.  A view,
  an ``empty`` and a ``detach`` move nothing; a broadcast input counts the
  elements it spans (stride 0 repeats nothing).
- **Peak live bytes.**  Every storage an op creates is tracked until its
  last tensor dies (a finalizer on the storage), on top of the ``live``
  tensors given at the start (the parameters, the optimizer state, the
  batch); ``peak_bytes`` is the most alive at once.
- **Collective bytes.**  Calls of ``dist.compat``'s collectives inside the
  context add their per-device bytes by ``roofline``'s ring model
  (:func:`ring_bytes`), by kind.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: ops that launch no kernel: they only make tensors or views
_FREE = frozenset({"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like",
                   "detach", "alias", "lift_fresh", "_unsafe_view", "_reshape_alias",
                   "set_", "resize_", "_local_scalar_dense"})

#: pointwise-tagged ops that only move data: no FLOP
_COPIES = frozenset({"clone", "_to_copy", "copy_", "fill_", "zero_", "lift_fresh_copy"})

_MATMUL = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution"})


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes ``t`` spans: its elements, a broadcast (stride 0) axis once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def matmul_flops(name: str, args, out: torch.Tensor) -> tuple[float, torch.dtype]:
    """2·m·n·k of one matrix-product op, and the dtype it runs in; a
    convolution counts 2 · output elements · (input channels a group × the
    kernel's taps)."""
    if name == "convolution":
        per = 1
        for d in args[1].shape[1:]:
            per *= d
        return 2.0 * out.numel() * per, args[0].dtype
    a, b = (args[0], args[1]) if name in ("mm", "bmm") else (args[1], args[2])
    return 2.0 * a.numel() * b.shape[-1], a.dtype


def ring_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Per-device bytes of one collective over ``n`` ranks whose result is
    ``out_bytes`` on each (``repro.launch.roofline``'s ring model)."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (n - 1) / n
    if kind == "all-reduce":
        return out_bytes * 2 * (n - 1) / n
    if kind == "all-to-all":
        return out_bytes * (n - 1) / n
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class Cost:
    """What :class:`OpCost` counted."""

    matmul_flops: dict = dataclasses.field(default_factory=dict)   # dtype name -> FLOPs
    elementwise_flops: float = 0.0
    bytes: float = 0.0
    peak_bytes: int = 0
    coll: dict = dataclasses.field(default_factory=dict)           # kind -> bytes
    coll_count: dict = dataclasses.field(default_factory=dict)     # kind -> calls

    @property
    def flops(self) -> float:
        return sum(self.matmul_flops.values()) + self.elementwise_flops

    def add(self, other: "Cost") -> None:
        """Add ``other``'s counts (the peak is the larger of the two)."""
        for k, v in other.matmul_flops.items():
            self.matmul_flops[k] = self.matmul_flops.get(k, 0.0) + v
        self.elementwise_flops += other.elementwise_flops
        self.bytes += other.bytes
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v
        for k, v in other.coll_count.items():
            self.coll_count[k] = self.coll_count.get(k, 0) + v


class OpCost(TorchDispatchMode):
    """Count the FLOPs, bytes, live memory and collectives of the code run
    inside ``with OpCost(live=...) as oc:``; the counts are ``oc.cost``.

    ``live``: tensors (or trees of them) alive before the block, counted
    once each storage toward the live bytes."""

    def __init__(self, live=()):
        super().__init__()
        self.cost = Cost()
        self._live: dict[int, int] = {}
        self._now = 0
        self._patched: list = []
        self._depth = 0
        for t in tree_flatten(live)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.cost.peak_bytes = self._now

    # -- live storages -------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live:
            return
        self._live[key] = s.nbytes()
        self._now += s.nbytes()
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    # -- collectives ---------------------------------------------------------

    def __enter__(self):
        from repro_torch.dist import compat

        # re-entered around a composite op's decomposition: the collectives
        # are spied on already (wrapping them again would nest the spies)
        self._depth += 1
        if self._depth > 1:
            return super().__enter__()

        def spy(fn, kind):
            def counted(x, mesh, axis_name):
                out = fn(x, mesh, axis_name)
                n = compat.axis_size(mesh, axis_name)
                self.cost.coll[kind] = (self.cost.coll.get(kind, 0.0)
                                        + ring_bytes(kind, tensor_bytes(out), n))
                self.cost.coll_count[kind] = self.cost.coll_count.get(kind, 0) + 1
                return out
            return counted

        for name, kind in (("all_gather_stacked", "all-gather"), ("psum", "all-reduce"),
                           ("pmax", "all-reduce"), ("all_to_all_rows", "all-to-all")):
            fn = getattr(compat, name)
            self._patched.append((compat, name, fn))
            setattr(compat, name, spy(fn, kind))
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            for mod, name, fn in self._patched:
                setattr(mod, name, fn)
            self._patched.clear()
        return super().__exit__(*exc)

    # -- ops -----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                          "CompositeImplicitAutograd"):
            # under inference_mode composite ops (matmul, einsum, linear)
            # arrive whole: count what they decompose into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        c = self.cost
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if func.is_view or name in _FREE:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        c.bytes += sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
        if name in _MATMUL:
            flops, dtype = matmul_flops(name, args, outs[0])
            key = str(dtype).removeprefix("torch.")
            c.matmul_flops[key] = c.matmul_flops.get(key, 0.0) + flops
        elif torch.Tag.pointwise in func.tags and name not in _COPIES:
            c.elementwise_flops += sum(t.numel() for t in outs[:1])
        elif torch.Tag.reduction in func.tags and ins:
            c.elementwise_flops += ins[0].numel()
        return out
