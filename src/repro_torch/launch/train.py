"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]`` —
the port of ``repro.launch.train``, with its flags and log lines.

Every rank of the default process group is one rank of a
``dist.compat.Mesh`` (``dist.train_step.make_train_step`` over it): the
client of its index over the data (and pod) axes, holding its model
shard's slices of the params:

- under ``torchrun`` the group comes from its environment (``env://``);
- ``--fake-devices N`` (N > 1) spawns N processes on a gloo group over
  ``tcp://127.0.0.1`` on a free port, as the JAX launcher forces N host
  devices;
- otherwise the process starts its own 1-rank group, so the sync (and on
  the card its kernels) runs even alone.

The groups are gloo: the mesh's collectives run on CPU and CUDA tensors
alike, and several ranks may share one card.  ``--mesh`` reads the JAX
launcher's specs over the ranks through ``launch.mesh.mesh_axes`` (``N``
data; ``DxM`` data x model; ``PxDxM`` pod x data x model).  A model axis
above 1 trains the dense family tensor-parallel (``dist.sharding``); the
rest of the zoo on one stops with the ROADMAP item it waits for.  Each
rank draws the full ``init_lm(key(0))`` and keeps its slices
(``dist.sharding.shard_tree``).  The ``fsdp`` entries of the specs name
the data axis as JAX's do, but every data rank keeps its slices whole
until the ``fsdp``/``streamed`` item of the ROADMAP: the numbers are the
same.  ``--device`` picks ``cuda`` (the default; a rank takes card
``LOCAL_RANK`` modulo the cards) or ``cpu``.  Rank 0 prints and writes
the checkpoints, which hold the full params and optimizer state gathered
over the model axis, so a checkpoint restores on any mesh, as the JAX
package's do.  ``--obs-dir`` turns on every rank's per-bucket compression
metrics (their gather is a collective) and gives rank 0 alone the event
sink (``<obs-dir>/events.jsonl``), a span recorder synchronized on its
device and a drift monitor, in the JAX launcher's order of events.
:func:`run` is one rank's loop for callers in the same process; it
returns the history and the final state.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import socket
import sys

import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.configs import reduced as make_reduced
from repro_torch.core import prng
from repro_torch.core.codecs import known_methods
from repro_torch.core.compressors import CompressorConfig
from repro_torch.data.synthetic import lm_batch
from repro_torch.dist import compat, sharding
from repro_torch.dist.train_step import (SYNC_MODES, TrainStepConfig, _opt_specs, init_ef_state,
                                         make_train_step)
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.transformer import init_lm
from repro_torch.obs import SCHEMA_VERSION, DriftMonitor, JsonlSink, SpanRecorder, metrics_event
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.train import _float32_and_deterministic, resolve_device

def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-trainable)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 4, 4x2 (data x model) or 2x2x2 (pod x data x model); default "
                         "all ranks data-parallel")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="spawn this many gloo ranks in place of devices")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sync", default="two_phase", choices=SYNC_MODES)
    ap.add_argument("--method", default="tnqsgd", choices=known_methods())
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--rank", type=int, default=4,
                    help="factor rank for rank-based codecs (powersgd)")
    ap.add_argument("--bucket-mb", type=float, default=4.0,
                    help="bucketed-codec target bucket size; 0 = per-leaf codec")
    ap.add_argument("--ef", action="store_true",
                    help="error feedback on the worker-side compressor (not checkpointed)")
    ap.add_argument("--dropout-rate", type=float, default=0.0,
                    help="elastic: per-(step,peer) dropout probability under "
                         "the deterministic counter-hash schedule (0 = full "
                         "participation)")
    ap.add_argument("--chaos-trace", default=None,
                    help="elastic: scripted live-mask JSON trace "
                         "(repro_torch.elastic.save_trace format); overrides "
                         "--dropout-rate")
    ap.add_argument("--fp16-threshold", type=int, default=0,
                    help="buckets of at most this many local elements ship "
                         "raw fp16 instead of the quantizer (0 = off)")
    ap.add_argument("--adaptive", action="store_true",
                    help="online tail telemetry + wire-budget bit allocation per bucket")
    ap.add_argument("--wire-budget-mb", type=float, default=0.0,
                    help="adaptive wire budget (bytes/step, MB); 0 = match the "
                         "fixed --bits allocation")
    ap.add_argument("--replan-every", type=int, default=10,
                    help="steps between adaptive bit replans")
    ap.add_argument("--optimizer", default="momentum_sgd")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--obs-dir", default=None,
                    help="write observability JSONL here; turns on the per-bucket "
                         "compression metrics (see repro_torch.obs)")
    ap.add_argument("--obs-every", type=int, default=1,
                    help="steps between compression-metric events")
    return ap


def _check_args(ap: argparse.ArgumentParser, args) -> None:
    if args.mesh:
        try:
            names, dims = mesh_axes(args.mesh)
            cfg = get_config(args.arch)
            sharding.check_model_axis(make_reduced(cfg) if args.reduced else cfg,
                                      dict(zip(names, dims)).get("model", 1))
        except ValueError as e:
            ap.error(str(e))
    if (args.chaos_trace or args.dropout_rate > 0.0) and args.bucket_mb <= 0:
        ap.error("--dropout-rate/--chaos-trace require the bucketed codec (--bucket-mb > 0)")
    if args.obs_dir and args.bucket_mb <= 0:
        ap.error("--obs-dir requires the bucketed codec (--bucket-mb > 0)")


def build_mesh(spec: str) -> tuple[compat.Mesh, dict]:
    """The :class:`~repro_torch.dist.compat.Mesh` of ``spec`` over the
    default process group, and its axes as a dict (for the log line)."""
    names, dims = mesh_axes(spec)
    world = dist.get_world_size()
    if math.prod(dims) != world:
        raise ValueError(f"mesh {spec!r} has {math.prod(dims)} ranks, the process group {world}")
    return compat.Mesh(dims, names), dict(zip(names, dims))


def _to(tree, device):
    return sharding.tree_map(lambda t: t.to(device), tree)


def _train(args) -> dict:
    """One rank's training loop over the initialized default group."""
    rank = dist.get_rank()

    def say(*a, **kw):
        if rank == 0:
            print(*a, **kw)

    _float32_and_deterministic()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    mesh, shown = build_mesh(args.mesh or str(dist.get_world_size()))
    device = resolve_device(args.device, mesh)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    say(f"arch={cfg.name} mesh={shown} sync={args.sync} method={args.method} bits={args.bits}")

    # repro: allow REPRO204 (CLI entry point: the reproducible demo seed, JAX's)
    params = init_lm(prng.key(0), cfg, device=device)
    split = mesh.model_size > 1
    pspecs = sharding.lm_pspecs(cfg, mesh) if split else None
    if split:
        params = sharding.shard_tree(params, pspecs, mesh)
    opt = (get_optimizer(args.optimizer, lr=args.lr) if args.optimizer == "momentum_sgd"
           else get_optimizer(args.optimizer))
    acfg = None
    if args.adaptive:
        from repro_torch.adaptive.controller import AdaptiveConfig

        acfg = AdaptiveConfig(wire_budget_mb=args.wire_budget_mb,
                              replan_every=args.replan_every)
    ecfg = None
    if args.chaos_trace:
        from repro_torch.elastic import load_trace

        ecfg = load_trace(args.chaos_trace).elastic()
        say(f"elastic: chaos trace {args.chaos_trace} "
            f"({len(ecfg.trace)} steps, wraps modulo length)")
    elif args.dropout_rate > 0.0:
        from repro_torch.elastic import ElasticConfig

        ecfg = ElasticConfig(rate=args.dropout_rate)
        say(f"elastic: scheduled dropout rate {args.dropout_rate}")
    obs_sink = obs_rec = drift_mon = None
    if args.obs_dir and rank == 0:
        obs_sink = JsonlSink(os.path.join(args.obs_dir, "events.jsonl"))
        obs_rec = SpanRecorder(sink=obs_sink, device=device)
        drift_mon = DriftMonitor(sink=obs_sink)
    ts = TrainStepConfig(sync=args.sync,
                         compressor=CompressorConfig(method=args.method, bits=args.bits,
                                                     rank=args.rank,
                                                     approx_gmin=args.adaptive),
                         bucket_mb=args.bucket_mb, error_feedback=args.ef, adaptive=acfg,
                         elastic=ecfg, fp16_threshold=args.fp16_threshold,
                         metrics_compression=args.obs_dir is not None)
    batch0 = lm_batch(cfg, 0, args.batch, args.seq, device)
    opt_state = opt.init(params)
    stepper = step_fn = None
    if args.adaptive:
        from repro_torch.adaptive.runtime import AdaptiveStepper

        stepper = AdaptiveStepper(cfg, mesh, opt, ts, batch0, params_like=params,
                                  obs=obs_rec, drift=drift_mon)
        say(f"adaptive: {len(stepper.sizes)} buckets, wire budget "
            f"{stepper.budget/2**20:.2f} MB/step, replan every {acfg.replan_every}")
    else:
        step_fn = make_train_step(cfg, mesh, opt, ts, batch0, params_like=params)

    o_specs = None
    if split:
        # repro: allow REPRO204 (a meta draw has no values: the key shapes nothing)
        full_like = init_lm(prng.key(0), cfg, device="meta")
        o_specs = _opt_specs(opt.init(full_like), full_like, pspecs)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        if split:   # the full tree on the host, then this rank's slices
            (fp, fo), start = load_checkpoint(args.ckpt_dir, (full_like, opt.init(full_like)))
            params = _to(sharding.shard_tree(fp, pspecs, mesh), device)
            opt_state = _to(sharding.shard_tree(fo, o_specs, mesh), device)
        else:
            (params, opt_state), start = load_checkpoint(args.ckpt_dir, (params, opt_state))
        say(f"resumed from step {start}")
    ef_state = init_ef_state(params, ts) if args.ef else None
    tstate = stepper.init_telemetry() if stepper is not None else None

    history = []
    try:
        for i in range(start, start + args.steps):
            b = lm_batch(cfg, i, args.batch, args.seq, device)
            span = (obs_rec.span("train.step", step=i) if obs_rec is not None
                    else contextlib.nullcontext())
            with span:
                if stepper is not None:
                    prev_bits = stepper.bits
                    params, opt_state, ef_state, tstate, m = stepper.step(
                        params, opt_state, ef_state, tstate, b, i)
                    if stepper.bits != prev_bits:
                        from repro_torch.launch.report import adaptive_table

                        plan, tails = stepper.plan, stepper.tails
                        say(f"step {i}: replanned bits -> {plan.bits} "
                            f"({plan.spend_bytes}/{plan.budget_bytes} B/step)")
                        say(adaptive_table(stepper.sizes, plan.bits, plan.alphas,
                                           gammas=None if tails is None else tails.gamma,
                                           rhos=None if tails is None else tails.rho))
                elif args.ef:
                    params, opt_state, ef_state, m = step_fn(params, opt_state, ef_state, b, i)
                else:
                    params, opt_state, m = step_fn(params, opt_state, b, i)
            if obs_sink is not None and "compression" in m and i % max(args.obs_every, 1) == 0:
                event = metrics_event(i, m["compression"])
                obs_sink.write(event)
                drift_mon.check_ratio([row["realized_mse"] for row in event["buckets"]],
                                      [row["predicted_mse"] for row in event["buckets"]], step=i)
            rec = {"step": i, "loss": float(m["loss"][0])}
            if "gnorm" in m:
                rec["gnorm"] = float(m["gnorm"][0])
            lvs = ""
            if ecfg is not None and "live_count" in m:
                lv = m["live"].cpu().reshape(-1)
                n_peers, n_live = int(lv.numel()), int(round(float(m["live_count"][0])))
                rec["live"] = n_live
                lvs = f" live {n_live}/{n_peers}"
                if n_live < n_peers and obs_sink is not None:
                    obs_sink.write({"v": SCHEMA_VERSION, "kind": "dropout",
                                    "step": i, "live": n_live, "n_peers": n_peers,
                                    "dropped": [p for p in range(n_peers)
                                                if float(lv[p]) == 0.0]})
                if drift_mon is not None:
                    drift_mon.check_participation(n_live / n_peers, step=i)
            history.append(rec)
            if args.log_every and i % args.log_every == 0:
                gn = f" gnorm {rec['gnorm']:.3f}" if "gnorm" in rec else ""
                say(f"step {i:5d} loss {rec['loss']:.4f}{gn}{lvs}", flush=True)
            if args.ckpt_every and args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                tree = (params, opt_state)
                if split:   # every rank joins the gathers; rank 0 writes
                    tree = (sharding.gather_tree(params, pspecs, mesh),
                            sharding.gather_tree(opt_state, o_specs, mesh))
                if rank == 0:
                    save_checkpoint(args.ckpt_dir, i + 1, tree)
                say(f"checkpointed step {i+1}")
    finally:
        if obs_sink is not None:
            obs_sink.close()
    obs = None
    if obs_sink is not None:
        say(f"obs: {obs_sink.n_written} events -> {obs_sink.path} "
            f"(render with `python -m repro_torch.obs report --dir {args.obs_dir}`)")
        obs = {"path": str(obs_sink.path), "n_written": obs_sink.n_written,
               "spans": obs_rec.summary(), "drift": [e.to_event() for e in drift_mon.events]}
    return {"history": history, "params": params, "opt_state": opt_state,
            "ef_state": ef_state, "tstate": tstate, "plan": getattr(stepper, "plan", None),
            "obs": obs}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(argv: list[str]) -> dict:
    """One rank of the launcher in this process: over the default group if
    one is initialized (or ``torchrun``'s environment), else over a 1-rank
    gloo group it starts and ends.  Returns ``{"history": [{"step",
    "loss", "gnorm", ...}], "params", "opt_state", "ef_state", "tstate",
    "plan", "obs"}`` of this rank; ``"obs"`` (rank 0 under ``--obs-dir``,
    else None) is ``{"path", "n_written", "spans", "drift"}``: the event
    log, its count, the span recorder's summary and the drift events."""
    ap = parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    own = not dist.is_initialized()
    if own:
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group("gloo", init_method="env://")
        else:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    rank=0, world_size=1)
    try:
        return _train(args)
    finally:
        if own:
            dist.destroy_process_group()


def _spawned(rank: int, world: int, init: str, argv: list[str]) -> None:
    torch.set_num_threads(max(1, torch.get_num_threads() // world))   # the host's cores, shared
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        _train(parser().parse_args(argv))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    if args.fake_devices > 1:
        import torch.multiprocessing as mp

        mp.spawn(_spawned, args=(args.fake_devices, f"tcp://127.0.0.1:{_free_port()}", argv),
                 nprocs=args.fake_devices)
    else:
        run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
