"""Dry run: one (arch × input shape × mesh) step costed without a card —
the port of ``repro.launch.dryrun``.

The JAX package lowers and compiles each step against 512 placeholder
devices and reads XLA's analyses.  Here the step runs eagerly on PyTorch's
``meta`` device (shapes, no storage, no kernel) under
``launch.op_cost.OpCost``, one rank's share of it:

- **train**: ``transformer.loss_fn``'s forward and backward (through
  ``dist.train_step._loss_and_grads``, unit remat where the config asks)
  and the optimizer's update.  The gradient sync cannot run on meta (its
  plan fits α from the values), so :func:`sync_cost` adds it from the
  port's own accounting: ``dist.collectives.wire_bytes_per_device`` over
  the ring's hops is the collective term, ``encode_hbm_bytes`` and
  ``decode_hbm_bytes`` the fused kernels' bytes, 4 B a stochastic-rounding
  uniform for the threefry draw, plus the float32 cast, the bucket concat
  and the gradient norm;
- **prefill** and **decode**: through ``dist.serve_step.make_serve_fns``.

On a ``DxM`` mesh with M > 1 the step runs one rank's model shard: its
slices of the params (``dist.sharding.shard_tree`` by ``lm_pspecs``, so the
bytes a device holds come from the specs), the layers' model-group sums
inside ``dist.sharding.axis_rules`` over an ``AbstractMesh`` (counted as
all-reduces, no communication on meta), and the sync over its model-local
buckets.  The parameter counts and model FLOPs stay the whole model's,
divided over the chips.

A train record also splits its terms into ``parts``: ``model`` (the
forward, backward and update) and ``sync`` (with its wire's bits an
element, ``compressors.wire_bits_per_element``, for a quantizer).  Records keep the JAX
package's schema (``repro.launch.dryrun``) and go to
``runs/dryrun_torch/<arch>__<shape>__<mesh>.json``; ``launch.report``
renders them.  A step whose per-device peak passes the card's 80 GB is
recorded with ``"fits_one_card": false``, not refused.  An op that meta
tensors cannot run (a data-dependent shape, a read of a value) stops the
pair with :class:`MetaTraceError`, naming the op.

Usage::

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k [--mesh 4]
      [--sync faithful --method tnqsgd --bits 3 --ef] [--optimizer adamw]
      [--batch B --seq S] [--reduced] [--out PATH]
  python -m repro_torch.launch.dryrun --all [--reduced]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import (INPUT_SHAPES, InputShape, get_config, get_shape, list_archs,
                                 reduced, variant_for_shape)
from repro_torch.core import codecs, compressors
from repro_torch.core.compressors import CompressorConfig
from repro_torch.dist import collectives, sharding
from repro_torch.dist import train_step as tsmod
from repro_torch.dist.compat import AbstractMesh
from repro_torch.dist.serve_step import make_serve_fns
from repro_torch.models.smallnet import tree_leaves, tree_unflatten
from repro_torch.optim.optimizers import get_optimizer

from . import roofline as rl
from .mesh import HBM_PER_CHIP, data_parallel_axes, mesh_axes
from .op_cost import Cost, OpCost
from .specs import abstract_init, count_active_params, count_params, input_specs

RUNS_DIR = pathlib.Path(__file__).resolve().parents[3] / "runs" / "dryrun_torch"
LANES = 128                 # the (rows, 128) tile the stochastic-rounding draw fills


class MetaTraceError(RuntimeError):
    """A step that meta tensors cannot run: an op with a data-dependent
    output shape, or a read of a value."""


def sync_cost(ts: tsmod.TrainStepConfig, sizes, dp: tuple[int, ...],
              grad_bytes_per_elem: int) -> tuple[Cost, int]:
    """One rank's bucketed gradient sync: its device bytes and collective
    bytes (a ``Cost``), and its live working set in bytes beyond the
    step's state and gradients.

    The collective bytes are ``wire_bytes_per_device`` (bytes a hop) times
    the hops of its ring schedule: (N−1) for each phase of two_phase and
    hierarchical's intra-pod stage (an all-to-all and an all-gather of
    chunks), N(N−1) for faithful's and the cross-pod exchange's whole wires
    sent round the ring in N chunks, 2(N−1) for dsgd's all-reduce.  The
    working set is what ``dist.train_step._sync_buckets`` holds at once at
    its end: the float32 gradient leaves, the EF-corrected buckets, the mean
    buckets and the new residual rows (4 B an element each), and the
    largest bucket's concatenation in flight."""
    cfg = ts.compressor
    sizes = [int(m) for m in sizes]
    n = sum(sizes)
    shards = math.prod(dp)
    wire = collectives.wire_bytes_per_device
    c = Cost()
    if grad_bytes_per_elem != 4:
        c.bytes += (grad_bytes_per_elem + 4) * n        # the float32 cast of the grads
    c.bytes += 8 * n                                    # bucket_concat: read, write
    c.bytes += 12 * n                                   # gnorm: square (read, write), sum
    plan = codecs.size_adaptive_plan(cfg, ts.bits_plan, sizes, ts.fp16_threshold)
    if ts.sync == "dsgd" or cfg.method == "dsgd":
        c.bytes += 12 * n                               # each bucket's sum and 1/n
        moved = {"all-reduce": wire(cfg, sizes, shards, "dsgd") * 2 * (shards - 1)}
    else:
        c.bytes += collectives.encode_hbm_bytes(cfg, sizes, True, ef=ts.error_feedback,
                                                adaptive=False, bits=plan)
        c.bytes += 4 * sum(-(-m // LANES) * LANES for m in sizes)       # the draw
        if ts.sync == "faithful" or shards == 1:
            c.bytes += collectives.decode_hbm_bytes(cfg, sizes, shards, True, plan)
            moved = {"all-gather": wire(cfg, sizes, shards, "faithful", plan)
                     * shards * (shards - 1)}
        else:
            inner = dp[-1]
            chunks = [-(-m // inner) for m in sizes]
            # every chunk decoded, re-encoded, and every peer's chunk row decoded
            c.bytes += 2 * collectives.decode_hbm_bytes(cfg, chunks, inner, True, plan)
            c.bytes += collectives.encode_hbm_bytes(cfg, chunks, True, ef=False,
                                                    adaptive=False, bits=plan)
            c.bytes += 4 * sum(-(-m // LANES) * LANES for m in chunks)
            phase = wire(cfg, sizes, inner, "two_phase", plan) * (inner - 1)
            moved = {"all-to-all": phase, "all-gather": phase}
            pods = math.prod(dp[:-1])
            if ts.sync == "hierarchical" and pods > 1:
                moved["all-gather"] += wire(cfg, sizes, pods, "faithful", plan) * pods * (pods - 1)
    for kind, b in moved.items():
        if b:
            c.coll[kind] = float(b)
    working = 16 * n + 4 * max(sizes)
    return c, working


def _terms(cost: Cost) -> dict:
    """One part of a step: its counts and roofline terms."""
    r = rl.build_roofline(cost, 0.0, tf32=torch.backends.cuda.matmul.allow_tf32)
    return {"flops": r.flops, "hbm_bytes": r.hbm_bytes, "collective_bytes": r.collective_bytes,
            "compute_s": r.compute_s, "memory_s": r.memory_s, "collective_s": r.collective_s}


def _meta_run(label: str, fn):
    """``fn()``, a meta-tensor failure raised as :class:`MetaTraceError`."""
    try:
        return fn()
    except (NotImplementedError, RuntimeError) as e:
        if isinstance(e, MetaTraceError):
            raise
        raise MetaTraceError(f"{label}: meta tensors cannot run this step: "
                             f"{type(e).__name__}: {str(e).splitlines()[0]}") from e


def _train_cost(cfg, params, batch, dp, ts, sizes, optimizer: str, mesh=None):
    """(op cost of the forward, backward and update, the sync's cost over
    the buckets ``sizes``, the peak per-device bytes, the bytes alive at
    the start)."""
    opt = get_optimizer(optimizer)
    opt_state = opt.init(params)
    ef = tsmod.init_ef_state(params, ts) if ts.error_feedback else ()
    with OpCost(live=(params, opt_state, ef, batch)) as oc:
        base = oc.cost.peak_bytes
        with (sharding.axis_rules(mesh, sharding.activation_rules(mesh, manual_data=True))
              if mesh is not None else contextlib.nullcontext()):
            _, grads = tsmod._loss_and_grads(cfg, params, batch, ts.streamed)
        g32 = [g.to(torch.float32) for g in tree_leaves(grads)]
        del grads
        opt.update(params, tree_unflatten(params, g32), opt_state, 0)
    leaves = tree_leaves(params)
    sync, working = sync_cost(ts, sizes, dp, leaves[0].element_size())
    grads_bytes = sum(p.numel() * p.element_size() for p in leaves)
    return oc.cost, sync, max(oc.cost.peak_bytes, base + grads_bytes + working), base


def run_one(arch: str, shape: InputShape, *, mesh_spec: str = "1", sync: str = "faithful",
            method: str = "tnqsgd", bits: int = 3, ef: bool = False,
            optimizer: str = "adamw", is_reduced: bool = False) -> dict:
    """The dry-run record of one (arch × shape × mesh)."""
    base_cfg = get_config(arch)
    if is_reduced:
        base_cfg = reduced(base_cfg)
    cfg = variant_for_shape(base_cfg, shape)
    names, dims = mesh_axes(mesh_spec)
    _, dp = data_parallel_axes(mesh_spec)
    n_model = dict(zip(names, dims)).get("model", 1)
    sharding.check_model_axis(cfg, n_model)
    mesh = AbstractMesh(dims, names) if n_model > 1 else None
    n_chips = math.prod(dims)
    n_dp = math.prod(dp)
    if shape.global_batch % n_dp:
        raise ValueError(f"global batch {shape.global_batch} does not split over {n_dp} "
                         "data-parallel ranks")
    b_local = shape.global_batch // n_dp
    t0 = time.time()
    params = abstract_init(cfg)
    n_params = count_params(params)
    n_active = count_active_params(cfg, params)
    if mesh is not None:   # this rank's model shard
        params = sharding.shard_tree(params, sharding.lm_pspecs(cfg, mesh), mesh)
    label = f"{arch} x {shape.name}"
    parts = None
    ins = input_specs(cfg, dataclasses.replace(shape, global_batch=b_local))
    ts = None
    if shape.kind == "train":
        if shape.name == "long_500k":
            raise ValueError("long_500k is decode-only")
        ts = tsmod.TrainStepConfig(sync=sync, error_feedback=ef,
                                   compressor=CompressorConfig(method=method, bits=bits))
        sizes = list(tsmod.local_bucket_sizes(params, ts))
        cost, scost, peak, base = _meta_run(
            label, lambda: _train_cost(cfg, params, ins["batch"], dp, ts, sizes, optimizer, mesh))
        parts = {"model": _terms(cost), "sync": _terms(scost)}
        if method in compressors.METHODS and method != "dsgd" and sync != "dsgd":
            parts["sync"]["wire_bits_per_element"] = compressors.wire_bits_per_element(
                ts.compressor, sizes)
        cost.add(scost)
    else:
        prefill_fn, decode_fn = make_serve_fns(cfg, shape.seq_len, mesh)[:2] if mesh \
            else make_serve_fns(cfg, shape.seq_len)
        live = (params, ins)
        if shape.kind == "prefill":
            def call():
                prefill_fn(params, ins["batch"])
        else:
            def call():
                decode_fn(params, ins["token"], ins["caches"], ins["position"])

        def serve():
            with OpCost(live=live) as oc:
                base = oc.cost.peak_bytes
                call()
            return oc.cost, oc.cost.peak_bytes, base

        cost, peak, base = _meta_run(label, serve)
    trace_s = time.time() - t0
    model_flops = rl.model_flops_for(cfg, shape, n_params, n_active) / n_chips
    roof = rl.build_roofline(cost, model_flops, tf32=torch.backends.cuda.matmul.allow_tf32)
    memory = {"argument_size_in_bytes": int(base), "output_size_in_bytes": 0,
              "temp_size_in_bytes": int(peak - base), "alias_size_in_bytes": 0,
              "total_per_device_bytes": int(peak)}
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(str(d) for d in dims),
        "axes": list(names),
        "chips": n_chips,
        "sync": sync if shape.kind == "train" else None,
        "kind": shape.kind,
        "n_params": n_params,
        "n_active_params": n_active,
        "lower_s": round(trace_s, 2),
        "compile_s": 0.0,
        "memory": memory,
        "roofline": roof.to_dict(),
        "fsdp": cfg.fsdp,
        "sliding_window": cfg.sliding_window,
        "fits_one_card": peak <= HBM_PER_CHIP,
        "device": "meta",
        "batch_per_rank": b_local,
        "seq_len": shape.seq_len,
        "method": method if ts is not None else None,
        "bits": bits if ts is not None else None,
        "ef": ef if ts is not None else None,
        "optimizer": optimizer if ts is not None else None,
        "reduced": is_reduced,
        "param_dtype": cfg.param_dtype,
        "remat": cfg.remat,
        "parts": parts,
    }


def summary_line(rec: dict) -> str:
    r = rec["roofline"]
    mem = rec["memory"]["total_per_device_bytes"]
    fits = "" if rec["fits_one_card"] else " (does not fit one card)"
    return (f"{rec['arch']} x {rec['shape']} [{rec['mesh']}]: "
            f"compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms "
            f"collective={r['collective_s']*1e3:.2f}ms bottleneck={r['bottleneck']} "
            f"useful={r['useful_flops_ratio']:.2f} mem/dev={mem/2**30:.2f}GiB{fits} "
            f"(meta trace {rec['lower_s']}s)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="1",
                    help="N (data), DxM (data x model) or PxDxM (pod x data x model)")
    ap.add_argument("--sync", default="faithful", choices=tsmod.SYNC_MODES)
    ap.add_argument("--method", default="tnqsgd", choices=codecs.known_methods())
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--ef", action="store_true", help="error feedback (train)")
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "momentum_sgd"))
    ap.add_argument("--batch", type=int, default=None, help="override the shape's global batch")
    ap.add_argument("--seq", type=int, default=None, help="override the shape's length")
    ap.add_argument("--reduced", action="store_true", help="the reduced config (CPU tests)")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape), a subprocess each")
    ap.add_argument("--out", default=None)
    return ap


def shape_for(name: str, batch: int | None = None, seq: int | None = None) -> InputShape:
    """``INPUT_SHAPES[name]``, its batch or length overridden; an overridden
    shape is named ``<kind>_<batch>x<seq>``."""
    shape = get_shape(name)
    if batch is None and seq is None:
        return shape
    b, s = batch or shape.global_batch, seq or shape.seq_len
    return dataclasses.replace(shape, name=f"{shape.kind}_{b}x{s}", global_batch=b, seq_len=s)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.all:
        RUNS_DIR.mkdir(parents=True, exist_ok=True)
        failures = []
        for arch in list_archs():
            for name in INPUT_SHAPES:
                out = RUNS_DIR / f"{arch}__{name}__{args.mesh}.json"
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", name, "--mesh", args.mesh, "--sync", args.sync,
                       "--method", args.method, "--bits", str(args.bits),
                       "--optimizer", args.optimizer, "--out", str(out)]
                cmd += ["--ef"] * args.ef + ["--reduced"] * args.reduced
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True)
                tag = f"{arch}__{name}__{args.mesh}"
                print(f"{'OK' if r.returncode == 0 else 'FAIL':4s} {tag} "
                      f"({time.time() - t0:.0f}s)", flush=True)
                if r.returncode != 0:
                    failures.append(tag)
                    print(r.stdout[-2000:], r.stderr[-2000:], flush=True)
        print(f"done: {len(failures)} failures: {failures}")
        return 1 if failures else 0
    if args.arch is None or args.shape is None:
        parser().error("give --arch and --shape, or --all")
    shape = shape_for(args.shape, args.batch, args.seq)
    try:
        rec = run_one(args.arch, shape, mesh_spec=args.mesh, sync=args.sync, method=args.method,
                      bits=args.bits, ef=args.ef, optimizer=args.optimizer,
                      is_reduced=args.reduced)
    except Exception:
        traceback.print_exc()
        return 1
    out = pathlib.Path(args.out or RUNS_DIR / f"{args.arch}__{shape.name}__{rec['mesh']}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2))
    print(summary_line(rec))
    print(json.dumps(rec["memory"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
