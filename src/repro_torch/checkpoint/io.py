"""Tree checkpointing in the JAX package's on-disk format — the port of
``repro.checkpoint.io``.

Layout: ``<dir>/step_<N:08d>/arrays.npz`` (leaf i as ``a{i}``, in
``jax.tree.leaves`` order) plus ``tree.json`` (each leaf's path as
``jax.tree_util.keystr`` writes it, each leaf's numpy dtype name, the tree's
structure as ``PyTreeDef`` prints it, the step).  bfloat16 leaves are saved
as their ``uint16`` bits, as numpy cannot store bfloat16.  Either package
reads the other's checkpoints: the leaves are restored by position into the
structure of ``tree_like``.

A tree is nested dicts (keys sorted, as JAX flattens them), NamedTuples
(fields in order), tuples and lists of tensors; ``None`` holds no leaf.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Any, prefix: str = "") -> list:
    """(keystr path, leaf) pairs in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in _flatten_with_paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, tuple | list):
        return [item for i, v in enumerate(tree) for item in _flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _treedef(tree: Any) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints it."""

    def node(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}" for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(node(v) for v in t) + "])")
        if isinstance(t, tuple):
            return "(" + ", ".join(node(v) for v in t) + ("," if len(t) == 1 else "") + ")"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        return "*"

    return f"PyTreeDef({node(tree)})"


def _unflatten(tree_like: Any, leaves) -> Any:
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
    if _is_namedtuple(tree_like):
        return type(tree_like)(*(_unflatten(v, leaves) for v in tree_like))
    if isinstance(tree_like, tuple | list):
        return type(tree_like)(_unflatten(v, leaves) for v in tree_like)
    return next(leaves)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as the array stored and the dtype name recorded."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = x.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def save_checkpoint(directory: str | pathlib.Path, step: int, tree: Any) -> pathlib.Path:
    d = pathlib.Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    items = _flatten_with_paths(tree)
    arrays, dtypes = {}, {}
    for i, (_, v) in enumerate(items):
        arrays[f"a{i}"], dtypes[f"a{i}"] = _to_numpy(v)
    np.savez(d / "arrays.npz", **arrays)
    (d / "tree.json").write_text(json.dumps({
        "paths": [k for k, _ in items],
        "dtypes": dtypes,
        "treedef": _treedef(tree),
        "step": step,
    }))
    return d


def _steps(root: pathlib.Path) -> list[str]:
    return sorted(p.name for p in root.glob("step_*"))


def load_checkpoint(directory: str | pathlib.Path, tree_like: Any,
                    step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (the latest step unless
    ``step``); returns (tree, step).  Each leaf comes back with its saved
    dtype, on the device of the ``tree_like`` leaf in its place (the CPU
    for a leaf on the meta device or not a tensor)."""
    root = pathlib.Path(directory)
    if step is None:
        steps = _steps(root)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        d = root / steps[-1]
        step = int(steps[-1].split("_")[1])
    else:
        d = root / f"step_{step:08d}"
    data = np.load(d / "arrays.npz")
    dtypes = json.loads((d / "tree.json").read_text()).get("dtypes", {})
    likes = [leaf for _, leaf in _flatten_with_paths(tree_like)]
    if len(data.files) != len(likes):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, expected {len(likes)}")
    restored = []
    for i, like in enumerate(likes):
        a = data[f"a{i}"]
        t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
             if dtypes.get(f"a{i}") == "bfloat16" else torch.from_numpy(np.array(a)))
        device = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
        restored.append(t.to("cpu" if device.type == "meta" else device))
    return _unflatten(tree_like, iter(restored)), step


def latest_step(directory: str | pathlib.Path) -> int | None:
    steps = _steps(pathlib.Path(directory))
    return int(steps[-1].split("_")[1]) if steps else None
