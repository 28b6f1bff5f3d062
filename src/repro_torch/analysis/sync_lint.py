"""Pass 1 (``REPRO1xx``): the sync linter — the counterpart of
``repro.analysis.jaxpr_lint``.

The port has no jaxpr to walk, so the pass runs the sync.  Four gloo ranks
(hierarchical as (2, 2)) each run ``dist.train_step.make_sync_fn`` for
every sync mode × codec method on equal gradients, with error feedback,
telemetry and a mixed per-bucket plan where the mode takes them, as the
JAX pass traces ``_make_sync_fn``; one process runs the ``dist.reference``
replay (budget 0).  While a case runs, a spy wraps ``dist.compat``'s
collectives and ``core.prng``'s draws, and a ``TorchDispatchMode`` sees
every op:

- **REPRO101** — collectives counted against the budget the codec registry
  declares (``core.codecs.Codec.collective_budget``): 1 for ``faithful``,
  2 for ``two_phase``, 3 for ``hierarchical``, one ``psum`` a bucket for
  ``dsgd``;
- **REPRO102** — the ranks' draws compared after the case: a draw whose
  uniforms are the same on every rank has a key that does not depend on
  the rank (peers quantizing with identical noise, the correlated-RNG bug);
- **REPRO103** — float64 in any op's inputs or outputs;
- **REPRO104** — a float ``index_add``, ``scatter_add`` or ``index_put``
  with ``accumulate=True`` (its order of adds, and so the synced bits, is
  free on the card);
- **REPRO105** — a tensor that is not int32 or uint32 crossing
  ``all_gather_stacked`` or ``all_to_all_rows`` in a compressed mode (the
  wire contract: one word vector a bucket).

The same four ranks also run each mode on a (data, model) = (2, 2) mesh
(``model:`` cases, tnqsgd), with and without ``metrics_compression`` and
``metrics_gnorm``: the metric sums share the gnorm's one model-group sum,
so the metrics add no collective, and with the gnorm off they add one sum
at most (REPRO101 otherwise; the port of JAX's
``tests/test_obs.py::test_collective_count_unchanged``).

Each finding is anchored at ``path:line`` of the innermost frame of the
port's package outside this pass (outside ``core/prng.py`` for a draw), so
the ``# repro: allow REPROxxx`` comments work; a run label otherwise.
"""
from __future__ import annotations

import collections
import functools
import hashlib
import json
import os
import pathlib
import sys
import tempfile
import time

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from . import Finding, suppressed_codes

_SRC = pathlib.Path(__file__).resolve().parents[2]          # src/
_OWN = pathlib.Path(__file__).resolve().parent              # src/repro_torch/analysis
_PRNG = _SRC / "repro_torch" / "core" / "prng.py"

#: dist.compat's collectives and the primitive each stands for in the JAX pass
COLLECTIVES = {"all_gather_stacked": "all_gather", "all_to_all_rows": "all_to_all",
               "psum": "psum"}
#: collectives whose operand is the compressed wire
_WIRE = frozenset({"all_gather_stacked", "all_to_all_rows"})
_WIRE_DTYPES = (torch.int32, torch.uint32)
_SCATTER_ADDS = frozenset({"index_add", "index_add_", "scatter_add", "scatter_add_"})
_INDEX_PUTS = frozenset({"index_put", "index_put_", "_index_put_impl_"})

N_RANKS = 4
_LEAF_SIZES = (2048, 1024)
_BUCKET_MB = 0.008          # ~2,097-element buckets -> one bucket a leaf
_DATA_SEED = 0x5EED         # the equal gradients every rank syncs
_STEP_SEED = 0x17E          # the step key

#: the mode sweep (dsgd = the uncompressed mean baseline)
MODES = ("faithful", "two_phase", "hierarchical", "dsgd")
QUICK_METHODS = ("tqsgd", "powersgd", "dsgd")
#: reference replays are method-redundant; one per decode family
_REFERENCE_METHODS = ("tqsgd", "tnqsgd", "powersgd", "dsgd")
#: the (data, model) mesh of the metric-invariance cases
MODEL_MESH = ((2, 2), ("data", "model"))
#: (metrics_compression, metrics_gnorm) of each model-mesh case
_METRIC_VARIANTS = ((False, True), (True, True), (False, False), (True, False))


# ---------------------------------------------------------------------------
# Source anchoring + suppression
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _source_lines(rel: str) -> tuple[str, ...]:
    try:
        return tuple((_SRC / rel).read_text().splitlines())
    except OSError:
        return ()


@functools.lru_cache(maxsize=4096)
def _port_path(filename: str) -> str | None:
    """``filename`` relative to ``src/`` when it is a module of the port
    outside this pass, else None."""
    path = pathlib.Path(filename).resolve()
    try:
        rel = path.relative_to(_SRC)
    except ValueError:
        return None
    if rel.parts[0] != "repro_torch" or _OWN in path.parents:
        return None
    return str(rel)


def _site(skip: tuple[pathlib.Path, ...] = ()) -> tuple[str, int] | None:
    """(path, line) of the innermost frame of the port's package outside
    this pass and ``skip``."""
    skipped = {str(p.relative_to(_SRC)) for p in skip}
    f = sys._getframe(1)
    while f is not None:
        rel = _port_path(f.f_code.co_filename)
        if rel is not None and rel not in skipped:
            return rel, f.f_lineno
        f = f.f_back
    return None


def _where(code: str, label: str, site) -> str | None:
    """The finding's anchor, or None when an allow comment suppresses it."""
    if site is None:
        return label
    rel, line = site
    if code in suppressed_codes(list(_source_lines(rel)), line):
        return None
    return f"{rel}:{line}"


# ---------------------------------------------------------------------------
# The spy: collectives, draws and every op of one case
# ---------------------------------------------------------------------------


class _Spy(TorchDispatchMode):
    """REPRO103/104/105 findings, collective counts and draw digests of
    the code run inside ``with spy.patched(), spy:``."""

    def __init__(self, label: str, compressed: bool):
        super().__init__()
        self.label, self.compressed = label, compressed
        self.findings: list[Finding] = []
        self.counts: collections.Counter = collections.Counter()
        self.draws: list[tuple[str, str]] = []      # (anchor, digest of the bits)

    def _emit(self, code: str, message: str, skip=()) -> None:
        where = _where(code, self.label, _site(skip))
        if where is not None:
            self.findings.append(Finding(code, where, f"[{self.label}] {message}"))

    def patched(self):
        """Wrap ``dist.compat``'s collectives and ``core.prng.random_bits``
        (every draw goes through it) for the block."""
        from contextlib import ExitStack

        from repro_torch.core import prng
        from repro_torch.dist import compat

        stack = ExitStack()

        def wrap(name, fn):
            def spied(x, mesh, axis_name):
                self.counts[COLLECTIVES[name]] += 1
                if self.compressed and name in _WIRE and x.dtype not in _WIRE_DTYPES:
                    self._emit("REPRO105", f"{name} moves {str(x.dtype)[6:]} across the "
                               "compressed wire; the codec contract is int32 words")
                return fn(x, mesh, axis_name)
            return spied

        def drawn(key, shape, device=None, _fn=prng.random_bits):
            bits = _fn(key, shape, device)
            where = _where("REPRO102", self.label, _site((_PRNG,)))
            digest = hashlib.sha1(bits.detach().cpu().numpy().tobytes()).hexdigest()
            self.draws.append((where, digest))
            return bits

        for name in COLLECTIVES:
            fn = getattr(compat, name)
            setattr(compat, name, wrap(name, fn))
            stack.callback(setattr, compat, name, fn)
        stack.callback(setattr, prng, "random_bits", prng.random_bits)
        prng.random_bits = drawn
        return stack

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        tensors = [t for t in tree_flatten((args, kwargs, out))[0] if isinstance(t, torch.Tensor)]
        if any(t.dtype == torch.float64 for t in tensors):
            self._emit("REPRO103", f"{name} touches float64")
        if name in _SCATTER_ADDS or name in _INDEX_PUTS:
            accumulate = name in _SCATTER_ADDS or bool(
                args[3] if len(args) > 3 else kwargs.get("accumulate", False))
            if accumulate and args[0].is_floating_point():
                self._emit("REPRO104", f"float {name} ({str(args[0].dtype)[6:]}): its order "
                           "of adds, and so the synced bytes, is free on the card")
        return out


def lint_run(fn, label: str, *, budget: int | None, compressed: bool) -> dict:
    """Run ``fn()`` under the spy.  Returns ``{"findings", "collectives",
    "draws", "budget", "launches"}``: REPRO101 when the collectives pass
    ``budget`` (None: no budget), REPRO103-105 as found, the draws'
    (anchor, digest) for :func:`check_draws`, and the port kernels this
    run launched."""
    from repro_torch import kernels

    before = kernels.launch_counts()
    spy = _Spy(label, compressed)
    with spy.patched(), spy:
        fn()
    after = kernels.launch_counts()
    findings = list(dict.fromkeys(spy.findings))
    total = sum(spy.counts.values())
    if budget is not None and total > budget:
        detail = ", ".join(f"{k}={v}" for k, v in sorted(spy.counts.items()))
        findings.append(Finding("REPRO101", label, f"[{label}] {total} collectives issued "
                                                   f"({detail}) vs a budget of {budget}"))
    return {"findings": findings, "collectives": dict(spy.counts), "draws": spy.draws,
            "budget": budget,
            "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}}


def check_draws(label: str, per_rank: list[list[tuple[str, str]]]) -> list[Finding]:
    """REPRO102 over one case's draws on every rank (equal gradients): a
    draw whose bits are the same on all ranks."""
    findings = []
    for i in range(min(len(d) for d in per_rank)):
        where = per_rank[0][i][0]
        if where is not None and len({d[i][1] for d in per_rank}) == 1:
            findings.append(Finding(
                "REPRO102", where, f"[{label}] draw {i} is the same on all {len(per_rank)} "
                "ranks: its key does not depend on the rank, so peers quantize with "
                "identical noise"))
    return list(dict.fromkeys(findings))


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------


def _bits_plan(method: str, n_buckets: int):
    """A mixed per-bucket plan for quantizer methods: bucket 0 at 2 bits of
    the method, bucket 1 at 3 bits of the other decode family (codebook for
    a uniform method, uniform for a codebook one), then 4, 2, ... bits;
    rank-based codecs keep the base config."""
    from repro_torch.core.codecs import get_codec

    if get_codec(method).rank_based or n_buckets < 2:
        return None
    other = "tqsgd" if method in ("nqsgd", "tnqsgd", "tbqsgd") else "tnqsgd"
    return tuple((other, 3) if i == 1 else 2 + (i % 3) for i in range(n_buckets))


def _grads(device) -> list:
    """The gradient leaves every rank syncs: the same heavy-tailed values."""
    from repro_torch.core import prng

    keys = prng.split(prng.key(_DATA_SEED), 2 * len(_LEAF_SIZES))
    return [(prng.normal(keys[2 * i], (s,), device)
             * torch.exp(prng.normal(keys[2 * i + 1], (s,), device)) * 1e-3)
            for i, s in enumerate(_LEAF_SIZES)]


def _cfg(method: str):
    from repro_torch.core.compressors import CompressorConfig

    return CompressorConfig(method=method, bits=3, rank=2, approx_gmin=True)


def sync_case(method: str, mode: str, meshes: dict, device) -> tuple[str, dict]:
    """One mode × method through ``make_sync_fn`` on this rank: EF and
    telemetry threaded (where the mode takes them) and the mixed plan.
    ``meshes``: ``{"flat": Mesh((4,)), "pods": Mesh((2, 2))}``."""
    from repro_torch.adaptive.controller import AdaptiveConfig
    from repro_torch.core import prng
    from repro_torch.core.codecs import get_codec
    from repro_torch.dist.train_step import (TrainStepConfig, init_ef_state,
                                             init_telemetry_state, local_bucket_sizes,
                                             make_sync_fn)

    mesh = meshes["pods" if mode == "hierarchical" else "flat"]
    grads = _grads(device)
    compressed = not (mode == "dsgd" or method == "dsgd")
    cfg = _cfg(method)
    n_buckets = len(local_bucket_sizes(grads, TrainStepConfig(sync=mode, compressor=cfg,
                                                               bucket_mb=_BUCKET_MB)))
    ts = TrainStepConfig(sync=mode, compressor=cfg, bucket_mb=_BUCKET_MB,
                         error_feedback=compressed,
                         adaptive=AdaptiveConfig() if compressed else None,
                         bits_plan=_bits_plan(method, n_buckets) if compressed else None)
    extras = []
    if ts.error_feedback:
        extras.append(init_ef_state(grads, ts))
    if ts.adaptive is not None:
        extras.append(init_telemetry_state(grads, ts))
    sync = make_sync_fn(ts, mesh, grads)
    key = prng.key(_STEP_SEED)
    label = f"sync:{mode}/{method}"
    rec = lint_run(lambda: sync(grads, key, *extras), label,
                   budget=get_codec(method).collective_budget(mode, n_buckets),
                   compressed=compressed)
    rec["n_buckets"] = n_buckets
    return label, rec


def reference_case(method: str, mode: str, device) -> tuple[str, dict]:
    """The one-process replay of all ranks (no collectives: budget 0)."""
    from repro_torch.core import prng
    from repro_torch.dist.reference import reference_sync
    from repro_torch.dist.train_step import TrainStepConfig

    ts = TrainStepConfig(sync=mode, compressor=_cfg(method), bucket_mb=_BUCKET_MB)
    leaves = [g[None].expand(N_RANKS, -1).contiguous() for g in _grads(device)]
    dp = (2, 2) if mode == "hierarchical" else (N_RANKS,)
    key = prng.key(_STEP_SEED)
    label = f"reference:{mode}/{method}"
    return label, lint_run(lambda: reference_sync(ts, leaves, dp, key), label, budget=0,
                           compressed=not (mode == "dsgd" or method == "dsgd"))


def model_label(mode: str, metrics: bool, gnorm: bool) -> str:
    return f"model:{mode}/tnqsgd{'+metrics' if metrics else ''}{'' if gnorm else '-gnorm'}"


def model_case(mode: str, metrics: bool, gnorm: bool, meshes: dict,
               device) -> tuple[str, dict]:
    """One mode on the (data, model) mesh ``meshes["data_model"]``: each
    rank syncs its model shard's leaves over the data axis; the gnorm's
    square and the metric sums take the model group's one sum."""
    from repro_torch.core import prng
    from repro_torch.core.codecs import get_codec
    from repro_torch.dist.train_step import TrainStepConfig, local_bucket_sizes, make_sync_fn

    mesh = meshes["data_model"]
    grads = _grads(device)
    ts = TrainStepConfig(sync=mode, compressor=_cfg("tnqsgd"), bucket_mb=_BUCKET_MB,
                         metrics_compression=metrics, metrics_gnorm=gnorm)
    n_buckets = len(local_bucket_sizes(grads, ts))
    sync = make_sync_fn(ts, mesh, grads)
    key = prng.key(_STEP_SEED)
    label = model_label(mode, metrics, gnorm)
    budget = get_codec("tnqsgd").collective_budget(mode, n_buckets) + int(metrics or gnorm)
    rec = lint_run(lambda: sync(grads, key), label, budget=budget, compressed=mode != "dsgd")
    rec["n_buckets"] = n_buckets
    return label, rec


def check_metric_counts(traces: dict, modes) -> list[Finding]:
    """REPRO101 where the model-mesh metrics change the collective count:
    with the gnorm on, none; with it off, one model-group sum at most."""
    findings = []
    for mode in modes:
        for gnorm in (True, False):
            off = traces.get(model_label(mode, False, gnorm))
            on = traces.get(model_label(mode, True, gnorm))
            if off is None or on is None:
                continue
            delta = collections.Counter(on["collectives"])
            delta.subtract(off["collectives"])
            delta = {k: v for k, v in delta.items() if v}
            if delta not in ({},) + (() if gnorm else ({"psum": 1},)):
                label = model_label(mode, True, gnorm)
                findings.append(Finding("REPRO101", label, f"[{label}] the compression "
                                        f"metrics change the collectives by {delta}"))
    return findings


def matrix(methods, modes, quick: bool) -> tuple[list, list]:
    """(sync cases, reference cases) as (method, mode) pairs."""
    syncs = [(m, mode) for mode in modes for m in methods]
    ref_methods = methods if quick else tuple(m for m in _REFERENCE_METHODS if m in methods)
    return syncs, [(m, mode) for mode in modes for m in ref_methods]


def gather_case(label: str, rec: dict) -> dict:
    """Every rank's findings and draws of one sync case, merged on all ranks
    (a collective of the world group): the findings' union plus REPRO102."""
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, (rec["findings"], rec["draws"], rec["launches"]))
    findings = [f for r in per_rank for f in r[0]] + check_draws(label, [r[1] for r in per_rank])
    out = {k: v for k, v in rec.items() if k not in ("draws", "findings")}
    out["findings"] = list(dict.fromkeys(findings))
    out["launches"] = {k: sum(r[2].get(k, 0) for r in per_rank)
                       for k in sorted({k for r in per_rank for k in r[2]})}
    return out


def _rank_main(rank: int, world: int, init: str, out_dir: str, methods, modes, quick: bool,
               device: str) -> None:
    """One rank of the pass: every sync case, then (rank 0) the replays."""
    from repro_torch.dist import compat

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        meshes = {"flat": compat.Mesh((N_RANKS,)), "pods": compat.Mesh((2, 2)),
                  "data_model": compat.Mesh(*MODEL_MESH)}
        syncs, refs = matrix(methods, modes, quick)
        traces = {}
        for method, mode in syncs:
            t0 = time.perf_counter()
            label, rec = sync_case(method, mode, meshes, dev)
            traces[label] = gather_case(label, rec)
            traces[label]["seconds"] = time.perf_counter() - t0
        for mode in modes:
            for metrics, gnorm in _METRIC_VARIANTS:
                t0 = time.perf_counter()
                label, rec = model_case(mode, metrics, gnorm, meshes, dev)
                traces[label] = gather_case(label, rec)
                traces[label]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            for method, mode in refs:
                label, rec = reference_case(method, mode, dev)
                del rec["draws"]
                traces[label] = rec
            with open(os.path.join(out_dir, "sync_lint.json"), "w") as f:
                json.dump({label: dict(rec, findings=[x.to_json() for x in rec["findings"]])
                           for label, rec in traces.items()}, f)
    finally:
        dist.destroy_process_group()


def run_pass(methods=None, modes=None, *, quick: bool = False, device: str = "cuda"):
    """Run the mode × method matrix on ``N_RANKS`` spawned gloo ranks (all
    on ``cuda:0`` for ``device="cuda"``).  Returns ``(findings, stats)``;
    ``stats`` carries each case's collective counts, budget and kernel
    launches for the JSON report.  ``quick`` takes one method per codec
    family (tqsgd, powersgd, dsgd), as the JAX pass does."""
    import torch.multiprocessing as tmp

    from repro_torch.core.codecs import known_methods

    if methods is None:
        methods = QUICK_METHODS if quick else known_methods()
    if modes is None:
        modes = MODES
    with tempfile.TemporaryDirectory() as wd:
        tmp.start_processes(_rank_main, args=(N_RANKS, f"file://{wd}/rendezvous", wd,
                                              tuple(methods), tuple(modes), quick, device),
                            nprocs=N_RANKS, join=True, start_method="spawn")
        traces = json.loads(pathlib.Path(wd, "sync_lint.json").read_text())
    findings = [Finding(**f) for rec in traces.values() for f in rec.pop("findings")]
    findings += check_metric_counts(traces, modes)
    return findings, {"traces": len(traces), "per_trace": traces}

