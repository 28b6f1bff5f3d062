#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with ``python3 chip_smoke.py``; it needs one
CUDA card, ``nvcc`` and no JAX.  Phases, each fatal on failure:

1. card: print ``nvidia-smi``'s name and power limit, require CUDA;
2. build: compile every kernel of the main path from ``csrc/``, print the
   ``-Xptxas -v`` register and shared-memory report and hold it to the
   kernels pass (``repro_torch.analysis.kernel_resources``): K1-K17 all
   built, no kernel spills, none past 227 KB of shared memory or 255
   registers;
3. kernel parity: each of the seventeen kernels against its plain PyTorch
   version on the card on identical inputs.  K1-K10 at smallnet's bucket
   (206,922 elements), a full 4 MB bucket (1,048,576) and a ragged size, 8
   peers, 1, 3 and 8 bits, and at 3 bits at every shape and peer count the
   main path gives them (the padded buckets and chunks of two_phase (8,)
   and of a (2, 4) pod, and the 2-peer cross-pod stage); K1/K10 also on
   inputs that fill every bin, all zeros and all overflow at smallnet's
   and a 4 MB bucket, through the (rows, 128) wrappers and the flat path,
   the EF row aligned or not (their sums against the plain version's on
   every input, and against float64 sums); K11 at the P factors of
   smallnet's bucket (809 rows), of the mixed plan's (784) and of a 4 MB
   bucket (1,024), ranks 1, 3, 4 and 64, and at (1, 1) and (7, 3), the
   register and the global-memory path bitwise equal where the factor fits
   in registers ((1024, 64) takes the global path), a rank-deficient factor (by
   reconstruction) and a zero column; K12-K17 bitwise at a 4 MB tensor and
   at each of smallnet's eight leaf sizes (10 to 200,704 elements), 2, 3
   and 8 bits, with the per-tensor plan's α and levels, on the padded tile
   and through their ``kernels.ops`` wrappers; K16 and K17 (on the encode
   body of K2-K7) also at every width 1 to 8 on random codebooks and α,
   at n under one row, off a multiple of 32 and at 4 MB, their codes K12's
   and K14's zeroed past n, from the flat entry on the tensor as it lies
   (aligned, 4 bytes off) and through ``kernels.ops`` on the unpadded
   tensor; the segmented K14 and K12
   (one launch over many tiles) bitwise against the plain version per tile
   at smallnet's eight leaves at 2, 3 and 8 bits, with mixed widths, and
   over 1 and 64 tiles; K4, K5, K8 and K9 also bitwise the serial body they
   replaced and equal from the stacked wire as it lies (strided rows or
   contiguous), at every case above and on random wires at bits 1, 2, 3, 4
   and 8 over 1, 3, 8, 9 and 16 peers; K2, K3, K6 and K7 likewise bitwise
   the serial body and equal from the flat entry on the bucket as it lies
   (contiguous, 4 bytes off a 16-byte boundary, shorter than the code
   length), at every case above and on random codebooks at bits 1, 2, 3, 4
   and 8; K6, K7 and K4, K5, K8, K9 at the per-leaf codec's rows (2, 4, 18
   and 576 elements over 1, 2, 4 and 8 peers, sort-based plans), also
   through ``core.codecs`` card against CPU; the encode body's build must
   report no spill stores;
4. main path: the paper's 8-client smallnet training through
   ``repro_torch.train.train_synced``: at 3 bits faithful tnqsgd (EF off and
   on), two_phase tnqsgd (EF off, and EF on), hierarchical (2, 4) tnqsgd,
   faithful tqsgd and qsgd, two_phase tqsgd; PowerSGD at rank 4 with EF
   in the faithful, two_phase (8,) and hierarchical (2, 4) modes; the
   20%-dropout EF run (faithful tnqsgd, ``ElasticConfig(rate=0.2,
   seed=0x17E)``, its live peers per step the JAX package's); each
   EF-on run twice to show it repeats bit for bit.  Each run is held to the
   JAX package's golden window after 30 steps (or its own value under the
   original threefry layout), or to convergence after 15 steps, and every
   kernel's launch count, read around each run, to the count its sync mode
   implies.  Then the paper's
   per-tensor loop through ``repro_torch.train.train_clients`` with
   ``use_pallas`` (tnqsgd, tqsgd, and tnqsgd with EF; 30 rounds), each run
   twice and held bit for bit, to 240 launches of K14 or K12 (one
   segmented launch per client a round) and none of any other kernel, and
   to the JAX package's final loss within ± 0.05.
   Then the uncompressed dsgd run (the JAX package's window) and the
   per-leaf codec (``bucket_mb=0``): faithful tnqsgd (30 steps) and
   two_phase (8,) and hierarchical (2, 4) tnqsgd (3 steps) held to the JAX
   package's per-leaf runs, faithful tqsgd (15 steps, convergence), each
   with its launches per step.  Then one synced step of the mixed plan (tnqsgd 3
   bits, powersgd rank 4, tnqsgd 2 bits over three buckets), one step of
   the fp16 small-bucket tier on the same buckets (fp16_threshold 5,000),
   one adaptive step (3 steps of telemetry, the bits water-filled on
   the card and from the same telemetry on the CPU, equal, then a step
   with them) and one per-leaf sync in each of the four per-leaf runs'
   modes, each on the card held against the same step on the CPU with
   the card's plans replayed.  Then elastic participation under a mask
   that drops pod 0 of (2, 4) and peer 5: one step in each bucketed mode
   (tnqsgd with EF and telemetry), one of the fp16 tier and one of
   faithful powersgd, card against CPU (means and EF rows bitwise,
   powersgd's within rtol 1e-5, every dropped peer's EF row its corrected
   bucket); the straggler pin (a dropped peer's gradient times -3.7 moves
   no mean bit, faithful and two_phase); the solo survivor (the faithful
   mean bitwise the survivor's own decoded wire); and one step with
   ``metrics_compression``, with and without the mask, card against CPU
   (every metric bitwise but the predicted E_TQ, within PRED_CARD_RTOL);
4b. mesh: the sync on ``torch.distributed`` (``dist.train_step.make_sync_fn``
   over ``dist.compat.Mesh``), 8 ranks spawned on a gloo group, every one
   on ``cuda:0``: (a) one sync per case (faithful, two_phase (8,) and
   hierarchical (2, 4) tnqsgd with EF, telemetry and
   ``metrics_compression``, the same under the mask that drops pod 0 and
   peer 5, dsgd, faithful powersgd rank 4 with EF, the per-leaf faithful
   sync), every rank's means bitwise every other's and, with its EF,
   telemetry and metrics rows, bitwise its row of the card
   replay (dsgd within 1e-6), each rank's launches as predicted; (b) the
   golden faithful tnqsgd run through ``train_synced(mesh=...)``, one
   client a rank, every rank's history bitwise phase 4's; (c) a synced
   step's median of 5 a rank and the collectives' share of it;
4c. serving: the LM zoo through ``dist.serve_step.make_serve_fns`` at
   full config, no port kernel (the launch counts must not move): (a)
   llama3.2-1b (16 layers, bfloat16, ``init_lm(prng.key(0))`` on the card)
   prefills ``lm_batch``'s 4 x 64 and then 4 x 2,048 prompts and decodes
   16 greedy tokens each, every run twice and bitwise equal (tokens and
   logits); (b) the same weights cast to float32 and cut to 2 layers,
   the card's prefill logits and 4 decode steps against the port's CPU
   run within rtol 1e-4 / atol 1e-4 x max|logit|; (c) at 16 layers, decode
   step k against a prefill over the prompt and the k decoded tokens, in
   float32 within rtol/atol 2e-3 and in bfloat16 within a relative L2 of
   3e-2; (d) qwen2-vl-2b (4 x 320 with its 256 patches) and whisper-base
   (1,500 frames, 4 x 64) at full config, 8 tokens, twice bitwise, and
   (b)'s check at 2 layers; then the MoE, SSM and hybrid families, each
   at 4 x 64 and 4 x 2,048, twice bitwise, with (b)'s check at 2 units:
   mamba2-2.7b at its published config (64 layers, 16 tokens; and (c)'s
   check at 64 layers), phi3.5-moe at every published width with 8 of its
   32 layers (16 tokens), qwen3-moe-235b at every published width with 2
   of its 94 layers (8 tokens), and jamba-1.5-large's superblock (8
   sublayers: attention at 4, 16-expert top-2 MoE on every other one) as
   2 units at narrowed widths (d_model 1,024, 8 heads of 128 over 1 KV
   head, d_ff 3,072, 8 tokens); (f) the prefill and decode times,
   tokens/s, ``flash_attention``'s share of llama's 2,048 prefill,
   ``ssd_chunked``'s of mamba2's and ``moe_apply``'s of phi3.5-moe's (CUDA
   events), ``init_lm``'s time and the peak memory of each;
4d. training: the LM zoo's train step (``dist.train_step.make_train_step``)
   on the card: (a) llama3.2-1b at its published config (1.24 B
   parameters, bfloat16, remat) through the launcher's code path
   (``launch.train.run``) on one rank: batch 4 x 2,048, faithful tnqsgd at
   3 bits with EF over 4 MB buckets (ten buckets, up to 268,435,456
   elements; on one rank the two_phase mode transmits nothing, in both
   packages, while the faithful one still encodes and decodes every
   bucket), momentum SGD at lr 0.05, 3 steps, twice: the losses, gnorms
   and final parameters bitwise equal, the loss falling, each step's
   launches K1, K2 and K4 once a bucket, the peak memory under 70 GB, each
   step's host-clock split (forward+backward, plan, draw, kernels,
   optimizer, the rest); the second run with observability on
   (``--obs-dir``, ``--obs-every 1``): still bitwise the first, 3
   ``metrics`` events of 10 buckets, each the step's ``metrics_event``
   (bits 3, rank 0, the codec's wire bytes, α > 0, clip fraction in [0, 1],
   EF norm 0 at step 0 only, realized and predicted E_TQ finite and > 0),
   3 ``train.step`` spans each at least the step's synchronized time, the
   report CLI (``python -m repro_torch.obs report --json``) exiting 0 with 3
   steps, 10 buckets and the one phase; it prints each bucket's
   realized/predicted ratio and the step ms and peak beside the first
   run's; (b) 2 gloo ranks on ``cuda:0``, the reduced llama
   in float32, faithful and two_phase tnqsgd with EF, 3 steps: every
   rank's params, EF rows, loss and gnorm bitwise the in-process replay
   (``train.lm_replay_step``), each rank's launches as predicted; (c) the
   gradients of one reduced config of each family (2 units, float32)
   twice bitwise on the card and card against CPU within 2e-5 of each
   leaf's max |g|; (d) the adaptive
   stepper on the reduced llama (replan every 2, 5 steps), each step card
   against CPU from the card's state: the same bits adopted, the new
   telemetry within rtol 1e-5 up to elements at a bin edge (fact F8);
   (e) ``launch.train.main`` spawning 2 gloo ranks on ``cuda:0`` with
   ``--obs-dir``, the reduced llama, ``--adaptive --replan-every 2`` and
   dropout 0.2, 5 steps: rank 0's log alone, its dropout events the host
   replay of ``live_mask``, 5 ``train.step`` spans and one
   ``adaptive.replan`` span a replan, the drift events those a fresh
   monitor gives on the logged rows and live fractions;
4e. the model axis (``dist.sharding``), every rank a gloo process on
   ``cuda:0``: (a) llama3.2-1b at its published config through
   ``launch.train.run`` on ``--mesh 1x2`` (each rank its model shard's
   slices of ``init_lm(key(0))``; 4d (a)'s batch, codec, buckets,
   optimizer and 3 steps), twice: both runs bitwise alike (losses, gnorms,
   each rank's params and EF rows), both ranks the same losses, the loss
   falling, step 0's loss within rtol 1e-4 of 4d (a)'s, each rank
   launching K1, K2 and K4 once a model-local bucket a step, each rank's
   peak under 30 GB, each step's split beside 4d (a)'s, and whether gloo
   adds bfloat16 CUDA tensors; (b) llama3.2-1b served on ``--mesh 1x2``:
   4 x 2,048 prompts and 16 greedy tokens twice bitwise on both ranks,
   fed 4c (a)'s tokens within a relative L2 of 3e-2 of its logits (the
   one-rank run made again, its tokens 4c (a)'s), and at 2 layers in
   float32 within rtol 1e-4 / atol 1e-4 x max|logit| of the one-rank run,
   the times beside 4c (a)'s; (c) the reduced llama in float32 on 2x2 (4
   ranks; faithful and two_phase, 3 steps) and 2x2x2 (8 ranks;
   hierarchical, one step) at once, tnqsgd with EF, telemetry and
   metrics: every rank's mean slices, EF rows, telemetry row and metrics
   bitwise the one-device replay of its model shard (the metrics' sums
   added over the shards), its gnorm the root of the shards' summed
   squares, its launches as predicted;
5. times: K1-K10 and K12-K17 and their plain versions at the 4 MB
   (x 8 peers) shape, K2-K9 beside the serial body they replaced (in
   turns), K11 at smallnet's, the mixed plan's and a 4 MB bucket's P
   factor beside torch.linalg.qr and its global-memory path, each beside
   its byte bound, K1/K10 at smallnet's bucket, K2-K9 at smallnet's
   bucket and two_phase chunk (beside the serial body; the encodes also
   through the flat entry on stacked rows), K12/K14 at each of its leaf
   sizes, K16/K17 at smallnet's largest leaf (200,704; also through the
   flat entry), K2-K9 also at the per-leaf two_phase chunk (25,088), the
   segmented K14 and K12 over a client's eight leaves
   beside their eight launches, the phase-2
   kernels at a 4 MB bucket's chunk shape, K1, K2, K4 and K8 at the
   largest LM gradient bucket (268,435,456 elements, one peer; each first
   held to its plain version there), one synced step's wall time per sync
   mode and method, and one per-tensor round's compression phase by phase;
6. (run after 4e, before 5) the dry run and the analysis passes: (a)
   ``launch.dryrun.run_one`` of phase 4d (a)'s step (llama3.2-1b
   published, 4 x 2,048, faithful tnqsgd 3 bits with EF, momentum SGD) and
   of 4c's 4 x 2,048 prefill on meta tensors, each taking no card memory
   and launching no port kernel; their predicted compute, memory and
   collective terms, model FLOPs and bytes a device beside 4d's measured
   step (forward+backward+optimizer, kernels, peak) and 4c's prefill, the
   measured step's MFU, and both records through ``launch.report``; (b)
   ``python -m repro_torch.analysis --quick``: the sync pass on 4 gloo
   ranks on ``cuda:0`` (its collectives at the budgets, K1, K2, K4, K6,
   K8, K10 and K11 launched through the real sync), the AST pass and the
   kernels pass, clean.

The second-to-last line is the per-kernel JSON record, the last line the
device record.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate
PEERS = 8
SLICE_N = 206_922                  # smallnet's parameters: one bucket
FULL_N = 1_048_576                 # one full 4 MB bucket (bucket_mb=4.0)
RAGGED_N = 100_003                 # not a multiple of 32
FP32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
STATS_RTOL = 1e-5
GS_RTOL, GS_ATOL = 1e-5, 1e-6      # K11 against its plain version (another sum order)
PRED_CARD_RTOL = 1e-3              # a metrics step's predicted E_TQ, card against CPU
# The JAX package's per-tensor runs (benchmarks/common.py::train_clients,
# 8 clients, batch 32, 30 rounds, 3 bits, CompressorConfig bound to
# use_pallas=True, the original threefry layout, on the CPU): label ->
# (train_clients keywords, (final loss, accuracy on 2,048), the encode
# kernel, its launches a round: one segmented launch per client, K14 for
# the codebook methods, K12 for tqsgd)
JAX_PER_TENSOR = {
    "per_tensor_tnqsgd": (dict(method="tnqsgd"), (0.0008406252600252628, 0.99462890625),
                          "quantize.codebook_encode_2d", 8),
    "per_tensor_tqsgd": (dict(method="tqsgd"), (0.0013530668802559376, 0.994140625),
                         "quantize.uniform_encode_2d", 8),
    "per_tensor_tnqsgd_ef": (dict(method="tnqsgd", error_feedback=True),
                             (0.0018120473250746727, 0.99462890625),
                             "quantize.codebook_encode_2d", 8),
}
# live peers per step of the JAX package's 20%-dropout golden run
# (ElasticConfig(rate=0.2, seed=0x17E), 8 peers, steps 0-29)
DROPOUT_LIVE = [4, 7, 7, 8, 6, 6, 4, 6, 6, 5, 8, 6, 7, 7, 5, 5, 7, 8, 6, 5, 5, 7, 6, 6, 8, 7, 6, 7,
                7, 5]
OPS_ONLY = ("quantize.uniform_decode_2d", "quantize.codebook_decode_2d",
            "quantize.uniform_encode_pack_2d", "quantize.codebook_encode_pack_2d")
# smallnet's gradient leaves, in jax.tree.leaves order
SMALLNET_SHAPES = [(16,), (3, 3, 1, 16), (32,), (3, 3, 16, 32), (128,), (1568, 128), (10,),
                   (128, 10)]


def bound(nbytes: int, flops: int = 0) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gs_bytes(rows: int, r: int) -> int:
    """K11's bytes: the (rows, r) fp32 factor read once and written once."""
    return 2 * rows * r * 4


def gs_flops(rows: int, r: int) -> int:
    """K11's float operations: per pivot, the reorthogonalization against
    the earlier columns and the projection out of the later ones (a dot
    product and an update, 4·rows, per column pair), the norm and the
    scaling (3·rows)."""
    return r * rows * (4 * r - 1)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


MESH_RANKS = 8                     # the paper's 8 clients, one gloo rank each
MESH_TIMEOUT_S = 300               # the mesh phase's ranks must finish by then
MESH_MASK = [0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 1.0]   # pod 0 of (2, 4) and peer 5 down


def _mesh_cases() -> dict:
    """The mesh phase's syncs: label -> (TrainStepConfig, dp_sizes, masked).

    Every compressed bucketed case runs tnqsgd at 3 bits with EF, telemetry
    and ``metrics_compression`` on; dsgd takes none of EF, telemetry or
    metrics; the masked cases drop pod 0 of (2, 4) and peer 5 (the
    schedule only puts the mask in the signature).  None returns the gnorm:
    the results are held to the replay, which has none."""
    from repro_torch.adaptive.controller import AdaptiveConfig
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.dist.train_step import TrainStepConfig
    from repro_torch.elastic import ElasticConfig

    def config(**kw):
        return TrainStepConfig(metrics_gnorm=False, **kw)

    tn = CompressorConfig(method="tnqsgd", bits=3)
    on = dict(error_feedback=True, adaptive=AdaptiveConfig(), metrics_compression=True,
              compressor=tn)
    layouts = (("faithful", (MESH_RANKS,)), ("two_phase", (MESH_RANKS,)),
               ("hierarchical", (2, MESH_RANKS // 2)))
    cases = {sync: (config(sync=sync, **on), dp, False) for sync, dp in layouts}
    cases["dsgd"] = (config(sync="dsgd", compressor=tn), (MESH_RANKS,), False)
    for sync, dp in layouts:
        cases[f"{sync}_masked"] = (config(sync=sync, elastic=ElasticConfig(rate=0.2), **on), dp,
                                   True)
    cases["faithful_powersgd"] = (config(
        sync="faithful", error_feedback=True, compressor=CompressorConfig(method="powersgd",
                                                                          rank=4)),
        (MESH_RANKS,), False)
    cases["per_leaf_faithful"] = (config(sync="faithful", bucket_mb=0, compressor=tn),
                                  (MESH_RANKS,), False)
    return cases


def _mesh_rank(rank: int, world: int, init: str, workdir: str, src: str,
               golden_steps: int) -> None:
    """One rank of the mesh phase, a spawned process on the gloo group of
    ``init``: (a) each of :func:`_mesh_cases`'s syncs on the inputs the
    parent saved, with its launches; (b) the golden run through
    ``train_synced(mesh=...)``; (c) the synced step's time and its
    collectives' share.  Writes everything to ``workdir/rank<r>.pt``."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.adaptive.telemetry import init_telemetry
    from repro_torch.core.codecs import bucket_state_sizes
    from repro_torch.dist import compat
    from repro_torch.dist.train_step import make_sync_fn
    from repro_torch.train import _float32_and_deterministic, resolve_device, train_synced

    torch.set_num_threads(1)
    _float32_and_deterministic()
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        meshes = {(world,): compat.Mesh((world,)), (2, world // 2): compat.Mesh((2, world // 2))}
        dev = resolve_device("cuda", meshes[(world,)])
        torch.cuda.set_device(dev)
        inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
        leaves = [x[rank].to(dev) for x in inp["leaves"]]
        key, live = inp["key"], inp["live"].to(dev)
        out = {"device": str(dev), "cases": {}, "times": {}}
        prepared = {}
        for label, (ts, dp, masked) in _mesh_cases().items():
            sync = make_sync_fn(ts, meshes[dp], leaves)
            args = [leaves, key]
            if ts.elastic is not None:
                args.append(live if masked else torch.ones(world, device=dev))
            if ts.error_feedback:
                args.append(tuple(inp["ef"][m][rank].to(dev) for m in bucket_state_sizes(
                    ts.compressor, [sum(x.numel() for x in leaves)])))
            if ts.adaptive is not None:
                args.append(init_telemetry(1, dev))
            prepared[label] = (sync, args)
            kernels.reset_launch_counts()
            res = sync(*args)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            res = list(res) if isinstance(res, tuple) else [res]
            rec = {"mean": [m.cpu() for m in res.pop(0)], "counts": counts}
            if ts.error_feedback:
                rec["ef"] = [e.cpu() for e in res.pop(0)]
            if ts.adaptive is not None:
                rec["tstate"] = [f.cpu() for f in res.pop(0)]
            if ts.metrics_compression:
                rec["metrics"] = [f.cpu() for f in res.pop(0)]
            out["cases"][label] = rec

        # (b) the golden run, one client a rank
        kernels.reset_launch_counts()
        t0 = time.time()
        out["golden"] = train_synced(sync="faithful", bits=3, steps=golden_steps,
                                     n_clients=world, batch=32, device="cuda",
                                     mesh=meshes[(world,)])
        torch.cuda.synchronize()
        out["golden_s"] = time.time() - t0
        out["golden_counts"] = {k: v for k, v in kernels.launch_counts().items() if v}

        # (c) a synced step's wall time, and the share of it in compat's
        # collectives (each synchronized on both sides)
        coll = [0.0]
        originals = {name: getattr(compat, name)
                     for name in ("all_gather_stacked", "all_to_all_rows", "psum")}

        def timed(fn):
            def wrapper(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(*a)
                torch.cuda.synchronize()
                coll[0] += time.perf_counter() - t
                return r
            return wrapper

        for name, fn in originals.items():
            setattr(compat, name, timed(fn))
        for label in ("faithful", "two_phase", "hierarchical", "dsgd"):
            sync, args = prepared[label]
            walls, shares = [], []
            for _ in range(6):
                dist.barrier()
                torch.cuda.synchronize()
                coll[0] = 0.0
                t = time.perf_counter()
                sync(*args)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
                shares.append(coll[0] * 1e3 / walls[-1])
            out["times"][label] = {"runs_ms": walls[1:], "collective_share": shares[1:]}
        for name, fn in originals.items():
            setattr(compat, name, fn)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


SERVE_TOKENS = 16                  # examples/serve_batched.py's default --tokens
SERVE_RTOL = 1e-4                  # card against CPU, float32: rtol, and atol x max|logit|
DECODE_F32_TOL = 2e-3              # decode against prefill, float32 (tests/test_models.py:62)
DECODE_BF16_REL_L2 = 3e-2          # the same in bfloat16, relative L2
SSM_BF16_UNITS = 16                # mamba2's bfloat16 decode against prefill, layers


def _tmap(f, tree):
    return {k: _tmap(f, v) for k, v in tree.items()} if isinstance(tree, dict) else f(tree)


def _leaves(tree) -> list:
    return [x for v in tree.values() for x in _leaves(v)] if isinstance(tree, dict) else [tree]


def serving_phase(card: str) -> dict:
    """Phase 4c: the LM zoo's serving path through ``make_serve_fns`` at
    full config on the card (the module docstring lists its checks).
    Returns llama3.2-1b's 4 x 2,048 prefill ms (two runs), its decode's
    median ms a token, its greedy tokens and the peak memory."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist.serve_step import make_serve_fns
    from repro_torch.models import attention as tattn
    from repro_torch.models import ssm as tssm
    from repro_torch.models import transformer as tfm
    from repro_torch.train import _float32_and_deterministic

    _float32_and_deterministic()
    t_phase = time.time()
    dev = torch.device("cuda")
    counts0 = kernels.launch_counts()

    def ms_since(t0: float) -> float:
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def serve(cfg, params, batch, n_tokens: int):
        """Prefill, then greedy decode up to ``n_tokens`` tokens.  Returns the
        tokens (B, n), the logits (n, B, V), the prefill's ms and each decode
        step's ms (host clock, synchronized)."""
        t = batch.tokens.shape[1]
        prefill_fn, decode_fn = make_serve_fns(cfg, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill_fn(params, batch)
        prefill_ms = ms_since(t0)
        toks, outs, step_ms = [logits.argmax(-1)[:, None]], [logits], []
        for i in range(n_tokens - 1):
            t0 = time.perf_counter()
            logits, caches = decode_fn(params, toks[-1], caches, t + i)
            toks.append(logits.argmax(-1)[:, None])
            step_ms.append(ms_since(t0))
            outs.append(logits)
        return torch.cat(toks, 1), torch.stack(outs), prefill_ms, step_ms

    def serve_twice(label: str, cfg, params, batch, n_tokens: int):
        runs = [serve(cfg, params, batch, n_tokens) for _ in range(2)]
        (ta, la, pa, sa), (tb, lb, pb, sb) = runs
        check(torch.equal(ta, tb) and torch.equal(la, lb), f"serve {label}: two runs differ")
        check(bool(torch.isfinite(la).all()), f"serve {label}: logits not finite")
        print(f"[serve] {label}: prefill then {n_tokens} greedy tokens, twice bit for bit; "
              f"prefill {pa:.2f} / {pb:.2f} ms, decode median "
              f"{statistics.median(sa + sb):.2f} ms a step; first row {ta[0].tolist()}")
        return ta, pa, pb, sa + sb

    def cut(cfg, params, layers: int, device):
        """``cfg`` and ``params`` at ``layers`` units (the stacked blocks
        sliced, the encoder's too; a hybrid unit is ``attn_period`` layers),
        every leaf float32 on ``device``."""
        def f32(t):
            return t.to(device=device, dtype=torch.float32)

        out = {k: _tmap(f32, v) for k, v in params.items() if k not in ("blocks", "encoder")}
        out["blocks"] = _tmap(lambda t: f32(t[:layers]), params["blocks"])
        per_unit = cfg.attn_period if cfg.family == "hybrid" else 1
        kw = dict(num_layers=layers * per_unit, param_dtype="float32", compute_dtype="float32")
        if cfg.enc_dec:
            enc = params["encoder"]
            out["encoder"] = {"blocks": _tmap(lambda t: f32(t[:layers]), enc["blocks"]),
                              "final_norm": _tmap(f32, enc["final_norm"])}
            kw["num_enc_layers"] = layers
        return cfg.replace(**kw), out

    def card_vs_cpu(label: str, cfg, params, batch, steps: int = 4) -> None:
        """Float32 at 2 units: the card's prefill logits and ``steps``
        decode steps against the port's CPU run, fed the card's tokens."""
        cfg2, p_card = cut(cfg, params, 2, dev)
        _, p_cpu = cut(cfg, params, 2, "cpu")
        toks, got, _, _ = serve(cfg2, p_card, batch, steps + 1)
        t = batch.tokens.shape[1]
        prefill_fn, decode_fn = make_serve_fns(cfg2, t)
        logits, caches = prefill_fn(p_cpu, tfm.Batch(*(None if x is None else x.cpu()
                                                       for x in batch)))
        want = [logits]
        for i in range(steps):
            logits, caches = decode_fn(p_cpu, toks[:, i:i + 1].cpu(), caches, t + i)
            want.append(logits)
        want, got = torch.stack(want), got.cpu()
        scale = float(want.abs().max())
        diff = (got - want).abs()
        check(bool((diff <= SERVE_RTOL * scale + SERVE_RTOL * want.abs()).all()),
              f"serve {label}: card against CPU at 2 layers off by {float(diff.max()):g} "
              f"(max |logit| {scale:g})")
        print(f"[serve] {label} float32 at 2 layers, card against CPU (prefill and {steps} "
              f"decode steps): max abs err {float(diff.max()):.3g}, max |logit| {scale:.4g} "
              f"(within rtol {SERVE_RTOL:g}, atol {SERVE_RTOL:g} x max |logit|)")

    def decode_vs_prefill(cfg, params, batch, steps: int = 4):
        """Decode step k's logits and the last-position logits of a prefill
        over the prompt and the k tokens decoded so far, a pair per step."""
        t = batch.tokens.shape[1]
        prefill_fn, decode_fn = make_serve_fns(cfg, t)
        logits, caches = prefill_fn(params, batch)
        seq, pairs = batch.tokens, []
        for k in range(steps):
            tok = logits.argmax(-1)[:, None]
            seq = torch.cat([seq, tok], 1)
            logits, caches = decode_fn(params, tok, caches, t + k)
            ref, _ = make_serve_fns(cfg, t + k + 1)[0](params, tfm.Batch(tokens=seq, labels=seq))
            pairs.append((logits, ref))
        return pairs

    def decode_prefill_check(label: str, cfg, params, batch, bf16_units: int | None = None):
        """(c): decode against prefill at full depth in float32 (the weights
        cast; rtol/atol), and in bfloat16 (relative L2) at ``bf16_units``
        units (default all; the full depth's is printed either way)."""
        def bf16_rel_l2(c, p):
            return max(float((d.float() - r.float()).norm() / r.float().norm())
                       for d, r in decode_vs_prefill(c, p, batch))

        rel_l2 = full_l2 = bf16_rel_l2(cfg, params)
        bf16_at = cfg.num_layers
        if bf16_units is not None:
            bf16_at = bf16_units
            cut_p = dict(params, blocks=_tmap(lambda t: t[:bf16_units], params["blocks"]))
            rel_l2 = bf16_rel_l2(cfg.replace(num_layers=bf16_units), cut_p)
        check(rel_l2 <= DECODE_BF16_REL_L2, f"serve {label} bfloat16: decode {rel_l2:g} "
              f"relative L2 from prefill at {bf16_at} layers")
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        p32 = _tmap(lambda t: t.float(), params)
        pairs = decode_vs_prefill(cfg32, p32, batch)
        f32_abs = max(float((d - r).abs().max()) for d, r in pairs)
        f32_ratio = max(float(((d - r).abs() / (DECODE_F32_TOL + DECODE_F32_TOL * r.abs())).max())
                        for d, r in pairs)
        check(f32_ratio <= 1.0, f"serve {label} float32: decode off prefill by {f32_abs:g} "
              f"({f32_ratio:g} of rtol/atol {DECODE_F32_TOL:g})")
        del p32, pairs
        at = "" if bf16_units is None else (
            f" at {bf16_units} layers ({full_l2:.3g} at {cfg.num_layers}, not bounded)")
        print(f"[serve] {label} decode against prefill over the prompt and the decoded "
              f"tokens, {cfg.num_layers} layers, 4 steps: float32 max abs err {f32_abs:.3g} "
              f"({f32_ratio:.3g} of rtol/atol {DECODE_F32_TOL:g}), bfloat16 relative L2 "
              f"{rel_l2:.3g}{at} (bound {DECODE_BF16_REL_L2:g})")

    def span_share(module, name: str, cfg, params, batch) -> tuple[float, float]:
        """One prefill with CUDA events around every call of ``module.name``:
        (its share of the prefill, the prefill's ms)."""
        spans, orig = [], getattr(module, name)

        def timed(*a, **kw):
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = orig(*a, **kw)
            e[1].record()
            spans.append(e)
            return out

        whole = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        prefill_fn, _ = make_serve_fns(cfg, batch.tokens.shape[1])
        setattr(module, name, timed)
        try:
            whole[0].record()
            prefill_fn(params, batch)
            whole[1].record()
        finally:
            setattr(module, name, orig)
        torch.cuda.synchronize()
        total = whole[0].elapsed_time(whole[1])
        return sum(a.elapsed_time(b) for a, b in spans) / total, total

    # (a) llama3.2-1b at its published config: 16 layers, bfloat16
    cfg = get_config("llama3.2-1b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_lm(prng.key(0), cfg, device=dev)
    init_ms = ms_since(t0)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] llama3.2-1b init_lm on the card: {n_params:,} parameters "
          f"({cfg.param_dtype}) in {init_ms:.0f} ms")
    b64 = lm_batch(cfg, 0, 4, 64, device=dev)
    b2k = lm_batch(cfg, 0, 4, 2048, device=dev)
    _, p64a, p64b, d64 = serve_twice("llama3.2-1b 4 x 64", cfg, params, b64, SERVE_TOKENS)
    toks2k, p2ka, p2kb, d2k = serve_twice("llama3.2-1b 4 x 2048", cfg, params, b2k,
                                          SERVE_TOKENS)
    share, share_total = span_share(tattn, "flash_attention", cfg, params, b2k)
    peak = torch.cuda.max_memory_allocated()

    # (b) float32 at 2 layers, card against CPU
    card_vs_cpu("llama3.2-1b", cfg, params, b64)

    # (c) decode against prefill at full depth, bfloat16 and float32
    decode_prefill_check("llama3.2-1b", cfg, params, b64)
    del params
    torch.cuda.empty_cache()

    # (d) qwen2-vl-2b (256 patches) and whisper-base (1,500 frames) at full config
    others = {}
    for arch, seq in (("qwen2-vl-2b", 320), ("whisper-base", 64)):
        ocfg = get_config(arch)
        op = tfm.init_lm(prng.key(0), ocfg, device=dev)
        ob = lm_batch(ocfg, 0, 4, seq, device=dev)
        _, pa, pb, ds = serve_twice(f"{arch} 4 x {seq}", ocfg, op, ob, 8)
        card_vs_cpu(arch, ocfg, op, ob)
        others[arch] = {"prefill_ms": [pa, pb], "decode_ms_median": statistics.median(ds)}
        del op
        torch.cuda.empty_cache()

    # the MoE, SSM and hybrid families: published widths, depth cut where
    # the model does not fit one card (jamba's superblock also narrowed)
    jamba = get_config("jamba-1.5-large-398b")
    families = (
        ("mamba2-2.7b", get_config("mamba2-2.7b"), SERVE_TOKENS, (tssm, "ssd_chunked")),
        ("phi3.5-moe 8 layers", get_config("phi3.5-moe-42b-a6.6b").replace(num_layers=8),
         SERVE_TOKENS, (tfm, "moe_apply")),
        ("qwen3-moe 2 layers", get_config("qwen3-moe-235b-a22b").replace(num_layers=2), 8, None),
        ("jamba superblock x 2", jamba.replace(
            num_layers=2 * jamba.attn_period, d_model=1024, num_heads=8, num_kv_heads=1,
            d_ff=3072, moe=dataclasses.replace(jamba.moe, d_ff=3072)), 8, None),
    )
    family_times = {}
    for label, fcfg, n_tok, span in families:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fp = tfm.init_lm(prng.key(0), fcfg, device=dev)
        f_init_ms = ms_since(t0)
        print(f"[serve] {label} init_lm on the card: {sum(t.numel() for t in _leaves(fp)):,} "
              f"parameters ({fcfg.param_dtype}, {fcfg.num_layers} layers) in {f_init_ms:.0f} ms")
        fb64 = lm_batch(fcfg, 0, 4, 64, device=dev)
        fb2k = lm_batch(fcfg, 0, 4, 2048, device=dev)
        _, a64, c64, s64 = serve_twice(f"{label} 4 x 64", fcfg, fp, fb64, n_tok)
        _, a2k, c2k, s2k = serve_twice(f"{label} 4 x 2048", fcfg, fp, fb2k, n_tok)
        rec = {"prefill_ms_4x64": [a64, c64], "prefill_ms_4x2048": [a2k, c2k],
               "decode_ms_per_token_median_4x64": statistics.median(s64),
               "decode_ms_per_token_median_4x2048": statistics.median(s2k),
               "tokens_per_s_4x64": 4e3 / statistics.median(s64),
               "tokens_per_s_4x2048": 4e3 / statistics.median(s2k)}
        if span is not None:
            sh, sh_total = span_share(*span, fcfg, fp, fb2k)
            rec[f"{span[1]}_share_4x2048"] = sh
            rec["prefill_ms_4x2048_events"] = sh_total
        rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        rec["init_lm_ms"] = f_init_ms
        card_vs_cpu(label, fcfg, fp, fb64)
        if fcfg.family == "ssm":
            # bfloat16's bound holds at llama's 16 layers: at 64 even the JAX
            # package's own decode is 0.055 from its prefill (width 1,024,
            # tools/ssm_bf16_drift.py)
            decode_prefill_check(label, fcfg, fp, fb64, bf16_units=SSM_BF16_UNITS)
        family_times[label] = rec
        del fp
        torch.cuda.empty_cache()

    # (e) serving launches no port kernel
    check(kernels.launch_counts() == counts0, "serving launched a port kernel")

    # (f) times
    b = b64.tokens.shape[0]
    print("[time] " + json.dumps({
        "serve": "llama3.2-1b", "batch": b, "prefill_ms_4x64": [p64a, p64b],
        "prefill_ms_4x2048": [p2ka, p2kb],
        "decode_ms_per_token_median_4x64": statistics.median(d64),
        "decode_ms_per_token_median_4x2048": statistics.median(d2k),
        "tokens_per_s_4x64": b * 1e3 / statistics.median(d64),
        "tokens_per_s_4x2048": b * 1e3 / statistics.median(d2k),
        "flash_attention_share_4x2048": share, "prefill_ms_4x2048_events": share_total,
        "max_memory_allocated_bytes": peak, "init_lm_ms": init_ms, "card": card}))
    print("[time] " + json.dumps({"serve_others": others, "card": card}))
    for label, rec in family_times.items():
        print("[time] " + json.dumps({"serve": label, "batch": 4, **rec, "card": card}))
    print(f"[serve] no port kernel launched; phase wall time {time.time() - t_phase:.1f} s")
    return {"prefill_ms_4x2048": [p2ka, p2kb], "peak_bytes": peak,
            "decode_ms_median_4x2048": statistics.median(d2k), "tokens_4x2048": toks2k.cpu()}


TRAIN_ARGV = ["--arch", "llama3.2-1b", "--batch", "4", "--seq", "2048", "--sync", "faithful",
              "--method", "tnqsgd", "--bits", "3", "--ef", "--bucket-mb", "4", "--steps", "3",
              "--device", "cuda"]
TRAIN_MAX_PEAK_GB = 70.0           # past it, the full-width step would cut --seq to 1,024
TRAIN_RANKS = 2                    # (b): gloo ranks on cuda:0, one client each
TRAIN_STEPS = 3
GRAD_CARD_RTOL = 2e-5              # (c): card against CPU, of each leaf's max |g|
TRAIN_FAMILIES = {                 # (c): arch -> reduced() keywords (2 units each)
    "llama3.2-1b": {}, "qwen2-vl-2b": {}, "whisper-base": {}, "phi3.5-moe-42b-a6.6b": {},
    "mamba2-2.7b": {}, "jamba-1.5-large-398b": {"layers": 16}}


class _Split:
    """Host-clock time of the train step's parts, each call synchronized on
    both sides; a part's time excludes the parts it calls (a kernel's
    wrapper excludes its draw).  Only calls inside a step count."""

    def __init__(self):
        self.stack, self.ms = [], {}

    def wrap(self, label: str, fn):
        import torch

        def timed(*a, **kw):
            if not self.stack and label != "step":
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.stack.append(0.0)
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                el = (time.perf_counter() - t0) * 1e3
                inner = self.stack.pop()
                self.ms[label] = self.ms.get(label, 0.0) + el - inner
                if self.stack:
                    self.stack[-1] += el
        return timed


KERNEL_OPS = ("ef_correct_stats", "bucket_stats", "codebook_encode_pack_residual",
              "codebook_encode_pack", "codebook_decode_reduce", "codebook_decode_rows")


def _instrumented_run(argv: list) -> tuple[dict, list, dict]:
    """``launch.train.run(argv)`` with each step's parts timed (``_Split``):
    returns the run's result, each step's ``{split_ms, peak_bytes,
    launches, compression}`` and the port kernels' launches of the run."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import codecs, prng
    from repro_torch.dist import train_step as tsmod
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.optim.optimizers import Optimizer

    split = _Split()
    steps = []
    saved = {"make_train_step": launcher.make_train_step,
             "get_optimizer": launcher.get_optimizer, "loss": tsmod._loss_and_grads,
             "plan": codecs.QuantizerCodec.plan, "uniform": prng.uniform,
             **{f"ops.{k}": getattr(ops, k) for k in KERNEL_OPS}}

    def make_step(*a, **kw):
        fn = saved["make_train_step"](*a, **kw)

        def step(*args):
            torch.cuda.reset_peak_memory_stats()
            before, split.ms = kernels.launch_counts(), {}
            out = split.wrap("step", fn)(*args)
            after = kernels.launch_counts()
            steps.append({"split_ms": dict(split.ms),
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "launches": {k: after[k] - before[k] for k in after
                                       if after[k] > before[k]},
                          "compression": out[-1].get("compression")})
            return out
        return step

    def get_opt(*a, **kw):
        opt = saved["get_optimizer"](*a, **kw)
        return Optimizer(init=opt.init, update=split.wrap("optimizer", opt.update))

    launcher.make_train_step, launcher.get_optimizer = make_step, get_opt
    tsmod._loss_and_grads = split.wrap("forward_backward", saved["loss"])
    codecs.QuantizerCodec.plan = split.wrap("plan", saved["plan"])
    prng.uniform = split.wrap("draw", saved["uniform"])
    for k in KERNEL_OPS:
        setattr(ops, k, split.wrap("kernels", saved[f"ops.{k}"]))
    kernels.reset_launch_counts()
    try:
        out = launcher.run(list(argv))
    finally:
        launcher.make_train_step, launcher.get_optimizer = (saved["make_train_step"],
                                                            saved["get_optimizer"])
        tsmod._loss_and_grads = saved["loss"]
        codecs.QuantizerCodec.plan = saved["plan"]
        prng.uniform = saved["uniform"]
        for k in KERNEL_OPS:
            setattr(ops, k, saved[f"ops.{k}"])
    torch.cuda.synchronize()
    return out, steps, {k: v for k, v in kernels.launch_counts().items() if v}


def _lm_rank(rank: int, world: int, init: str, workdir: str, src: str, device: str) -> None:
    """One rank of phase 4d (b): the reduced llama in float32 through
    ``make_train_step`` on a gloo mesh, every rank on ``cuda:0``, faithful
    and two_phase tnqsgd with EF, ``TRAIN_STEPS`` steps each.  Writes its
    params, EF rows, metrics and launches to ``workdir/rank<r>.pt``."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import prng
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist import compat
    from repro_torch.dist.train_step import TrainStepConfig, init_ef_state, make_train_step
    from repro_torch.models.smallnet import tree_leaves
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizers import momentum_sgd
    from repro_torch.train import _float32_and_deterministic, resolve_device

    torch.set_num_threads(1)
    _float32_and_deterministic()
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        mesh = compat.Mesh((world,))
        dev = resolve_device(device, mesh)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        cfg = reduced(get_config("llama3.2-1b"))
        params = init_lm(prng.key(0), cfg, device=dev)
        out = {"device": str(dev)}
        for sync in ("faithful", "two_phase"):
            ts = TrainStepConfig(sync=sync, error_feedback=True,
                                 compressor=CompressorConfig(method="tnqsgd", bits=3))
            opt = momentum_sgd(lr=0.05)
            batches = [lm_batch(cfg, i, 2 * world, 64, dev) for i in range(TRAIN_STEPS)]
            fn = make_train_step(cfg, mesh, opt, ts, batches[0], params_like=params)
            p, o, ef, ms = params, opt.init(params), init_ef_state(params, ts), []
            kernels.reset_launch_counts()
            for i in range(TRAIN_STEPS):
                p, o, ef, m = fn(p, o, ef, batches[i], i)
                ms.append({k: v.cpu() for k, v in m.items()})
            out[sync] = {"params": [t.cpu() for t in tree_leaves(p)],
                         "ef": [e.cpu() for e in ef], "metrics": ms,
                         "counts": {k: v for k, v in kernels.launch_counts().items() if v}}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def training_phase(card: str, device: str = "cuda") -> tuple[dict, list]:
    """Phase 4d: the LM zoo's train step on the card (the module docstring
    lists its checks).  Returns the port kernels' launches of (a)'s first
    full-width run and of (b)'s ranks, and (a)'s first run's steps (each
    step's ms, its split, its peak bytes, its loss and gnorm)."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch import kernels, train
    from repro_torch.adaptive import runtime, telemetry
    from repro_torch.adaptive.controller import AdaptiveConfig
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import prng
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist import compat
    from repro_torch.dist import train_step as tsmod
    from repro_torch.launch import train as launcher
    from repro_torch.models import transformer as tfm
    from repro_torch.models.smallnet import tree_leaves
    from repro_torch.optim.optimizers import momentum_sgd

    def resolve(d):
        return torch.device("cuda", 0) if d.type == "cuda" else d

    t_phase = time.time()
    dev = torch.device(device)

    # (a) llama3.2-1b at its published config through the launcher's code
    # path, one rank, twice; each step's parts timed
    def full_width_run(extra=()) -> tuple[dict, list, dict]:
        return _instrumented_run(TRAIN_ARGV + list(extra))

    t0 = time.time()
    first, steps_a, counts_a = full_width_run()
    wall_a = time.time() - t0
    hist = first["history"]
    for st, h in zip(steps_a, hist):
        st["loss"], st["gnorm"] = h["loss"], h["gnorm"]
    n_params = sum(t.numel() for t in tree_leaves(first["params"]))
    n_buckets = len(tsmod.local_bucket_sizes(first["params"], tsmod.TrainStepConfig(bucket_mb=4.0)))
    final = [t.cpu() for t in tree_leaves(first["params"])]
    del first
    torch.cuda.empty_cache()
    # run 2 with observability on (every step's metrics event, spans and
    # drift checks): it may change no bit of run 1
    obs_dir = tempfile.TemporaryDirectory()
    t0 = time.time()
    second, steps_b, counts_obs = full_width_run(["--obs-dir", obs_dir.name, "--obs-every", "1"])
    wall_b = time.time() - t0
    check(counts_obs == counts_a, f"train: launches of the run with observability {counts_obs}, "
                                  f"run 1's {counts_a}")
    check(second["obs"] is not None and second["obs"]["n_written"] > 0,
          f"train: the run with observability wrote no events: {second['obs']}")
    check([h["loss"] for h in second["history"]] == [h["loss"] for h in hist]
          and [h["gnorm"] for h in second["history"]] == [h["gnorm"] for h in hist],
          f"train: the second full-width run's losses differ: {second['history']} vs {hist}")
    check(all(torch.equal(a, b.cpu()) for a, b in zip(final, tree_leaves(second["params"]),
                                                       strict=True)),
          "train: the second full-width run's final parameters differ")
    sizes_a = tsmod.local_bucket_sizes(second["params"], tsmod.TrainStepConfig(bucket_mb=4.0))
    second["params"] = second["opt_state"] = second["ef_state"] = None
    del final
    torch.cuda.empty_cache()
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["gnorm"]) for h in hist),
          f"train: non-finite loss or gnorm {hist}")
    check(hist[-1]["loss"] < hist[0]["loss"], f"train: the loss did not fall: {hist}")
    per_step = {"encode_fused.ef_correct_stats_2d": n_buckets,
                "encode_fused.codebook_encode_pack_resid_2d": n_buckets,
                "decode.codebook_decode_reduce_3d": n_buckets}
    for s in steps_a + steps_b:
        check(s["launches"] == per_step, f"train: launches a step {s['launches']}, expected "
                                         f"{per_step}")
    check(counts_a == {k: v * TRAIN_STEPS for k, v in per_step.items()},
          f"train: launches of the run {counts_a}")
    peak_gb = max(s["peak_bytes"] for s in steps_a + steps_b) / 1e9
    check(peak_gb <= TRAIN_MAX_PEAK_GB, f"train: peak {peak_gb:.2f} GB past {TRAIN_MAX_PEAK_GB}")
    for s in steps_a + steps_b:   # the step's own time outside the timed parts
        s["split_ms"]["other"] = s["split_ms"].pop("step")
        s["step_ms"] = sum(s["split_ms"].values())
    for i, (h, sa, sb) in enumerate(zip(hist, steps_a, steps_b)):
        print(f"[train] llama3.2-1b step {i}: loss {h['loss']:.6f} gnorm {h['gnorm']:.6f}; "
              f"step {sa['step_ms']:.1f} / {sb['step_ms']:.1f} ms, peak "
              f"{sa['peak_bytes'] / 1e9:.2f} GB; launches {json.dumps(sa['launches'])}")
    print(f"[train] llama3.2-1b at its published config ({n_params:,} parameters, bfloat16, "
          f"remat, {n_buckets} buckets of up to 268,435,456 elements) through the launcher, "
          f"one rank, faithful tnqsgd 3 bits with EF, {TRAIN_STEPS} steps, twice bit for bit "
          f"(losses, gnorms and final parameters); the loss fell {hist[0]['loss']:.6f} -> "
          f"{hist[-1]['loss']:.6f}; peak {peak_gb:.2f} GB; first run {wall_a:.1f} s")
    for label, steps in (("first", steps_a), ("second", steps_b)):
        for i, s in enumerate(steps):
            print("[time] " + json.dumps({
                "train": "llama3.2-1b", "run": label, "obs": label == "second", "step": i,
                "step_ms": s["step_ms"], "split_ms": s["split_ms"],
                "max_memory_allocated_bytes": s["peak_bytes"], "batch": 4, "seq": 2048,
                "sync": "faithful", "ranks": 1, "card": card}))
    with obs_dir:
        obs_checks(obs_dir.name, steps_a, steps_b, n_buckets, sizes_a, second["obs"], wall_a,
                   wall_b, card)
    del second

    # (b) 2 gloo ranks on cuda:0 against the in-process replay
    cfg_r = reduced(get_config("llama3.2-1b"))
    with tempfile.TemporaryDirectory() as wd:
        t_spawn = time.time()
        ctx = tmp.start_processes(_lm_rank, args=(TRAIN_RANKS, f"file://{wd}/rendezvous", wd,
                                                  str(ROOT / "src"), device),
                                  nprocs=TRAIN_RANKS, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.time() - t_spawn > MESH_TIMEOUT_S:
                    fail(f"train ranks still running after {MESH_TIMEOUT_S} s")
        except Exception as e:  # a rank raised: report its traceback
            fail(f"a train rank failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        ranks = [torch.load(os.path.join(wd, f"rank{r}.pt"), weights_only=False)
                 for r in range(TRAIN_RANKS)]
    check(all(r["device"] == str(resolve(dev)) for r in ranks), "train ranks' devices")
    params_r = tfm.init_lm(prng.key(0), cfg_r, device=dev)
    nb_r = len(tsmod.local_bucket_sizes(params_r, tsmod.TrainStepConfig()))
    kn = {k: kernels.kernel_name(k) for k in kernels.KERNELS}
    k1, k2, k4, k6, k8, k10 = (kn[kernels.ef_correct_stats_2d],
                               kn[kernels.codebook_encode_pack_resid_2d],
                               kn[kernels.codebook_decode_reduce_3d],
                               kn[kernels.codebook_encode_pack_2d],
                               kn[kernels.codebook_decode_rows_3d], kn[kernels.bucket_stats_2d])
    want_b = {"faithful": {k1: nb_r, k2: nb_r, k4: nb_r},
              "two_phase": {k1: nb_r, k2: nb_r, k4: nb_r, k10: nb_r, k6: nb_r, k8: nb_r}}
    counts_b = {}
    for sync in ("faithful", "two_phase"):
        ts = tsmod.TrainStepConfig(sync=sync, error_feedback=True,
                                   compressor=CompressorConfig(method="tnqsgd", bits=3))
        opt = momentum_sgd(lr=0.05)
        p, o = params_r, opt.init(params_r)
        ef = [torch.zeros((TRAIN_RANKS, e.numel()), device=dev)
              for e in tsmod.init_ef_state(params_r, ts)]
        for i in range(TRAIN_STEPS):
            p, o, ef, want = train.lm_replay_step(cfg_r, ts, opt, (TRAIN_RANKS,), p, o, ef,
                                                  lm_batch(cfg_r, i, 2 * TRAIN_RANKS, 64, dev), i)
            for r, rank in enumerate(ranks):
                for k in ("loss", "gnorm"):
                    check(torch.equal(rank[sync]["metrics"][i][k], want[k].cpu()),
                          f"train (b) {sync}: rank {r}'s {k} at step {i} is not the replay's")
        for r, rank in enumerate(ranks):
            check(all(torch.equal(a, b.cpu()) for a, b in zip(rank[sync]["params"],
                                                              tree_leaves(p), strict=True)),
                  f"train (b) {sync}: rank {r}'s params are not the replay's")
            check(all(torch.equal(a, b[r].cpu()) for a, b in zip(rank[sync]["ef"], ef,
                                                                 strict=True)),
                  f"train (b) {sync}: rank {r}'s EF rows are not the replay's")
            want = {k: v * TRAIN_STEPS for k, v in want_b[sync].items()} if dev.type == "cuda" \
                else {}
            check(rank[sync]["counts"] == want, f"train (b) {sync}: rank {r}'s launches "
                                                f"{rank[sync]['counts']}, expected {want}")
            for k, v in rank[sync]["counts"].items():
                counts_b[k] = counts_b.get(k, 0) + v
        losses = [float(m["loss"][0]) for m in ranks[0][sync]["metrics"]]
        print(f"[train] (b) {sync}: {TRAIN_RANKS} gloo ranks on cuda:0, reduced llama3.2-1b "
              f"float32, tnqsgd 3 bits with EF, {TRAIN_STEPS} steps: every rank's params, EF "
              f"rows, loss and gnorm bitwise the in-process replay; losses {losses}; launches "
              f"a rank {json.dumps(ranks[0][sync]['counts'])}")
    del params_r

    # (c) gradients card against CPU, float32 at 2 units, one config a
    # family; the card's twice, bit for bit (the MoE dispatch and combine
    # backward, the SSM chunk loop and the embedding gathers included)
    for arch, kw in TRAIN_FAMILIES.items():
        cfg = reduced(get_config(arch), **kw)
        p_cpu = tfm.init_lm(prng.key(0), cfg, device="cpu")
        b_cpu = lm_batch(cfg, 0, 2, 64 + cfg.vlm_patches, "cpu")
        loss_cpu, g_cpu = tsmod._loss_and_grads(cfg, p_cpu, b_cpu, False)
        p_dev = _tmap(lambda t: t.to(dev), p_cpu)
        b_dev = tfm.Batch(*(None if x is None else x.to(dev) for x in b_cpu))
        loss_dev, g_dev = tsmod._loss_and_grads(cfg, p_dev, b_dev, False)
        loss_again, g_again = tsmod._loss_and_grads(cfg, p_dev, b_dev, False)
        check(torch.equal(loss_again, loss_dev)
              and all(torch.equal(a, b) for a, b in zip(tree_leaves(g_again), tree_leaves(g_dev),
                                                        strict=True)),
              f"train (c) {arch}: the card's loss and gradients differ between two runs")
        del g_again
        worst = 0.0
        for a, w in zip(tree_leaves(g_dev), tree_leaves(g_cpu), strict=True):
            scale = max(float(w.abs().max()), 1e-30)
            worst = max(worst, float((a.cpu() - w).abs().max()) / scale)
        check(worst <= GRAD_CARD_RTOL, f"train (c) {arch}: gradients {worst:g} of the leaf max "
                                       f"from the CPU's")
        check(abs(float(loss_dev) - float(loss_cpu)) <= GRAD_CARD_RTOL * abs(float(loss_cpu)),
              f"train (c) {arch}: loss {float(loss_dev)} vs the CPU's {float(loss_cpu)}")
        print(f"[train] (c) {arch} ({cfg.num_layers} layers, float32): gradients twice bitwise "
              f"on the card, card against CPU within {worst:.3g} of each leaf's max |g|, loss "
              f"{float(loss_dev):.6f} (CPU {float(loss_cpu):.6f})")

    # (d) the adaptive stepper on the reduced llama, one rank, each step
    # card against CPU: the CPU's stepper takes the card's state and plan
    # and steps on the same batch; both adopt the same bits, the new
    # telemetry within rtol 1e-5 up to elements at a bin edge (fact F8)
    acfg = AdaptiveConfig(replan_every=2, warmup_steps=1, min_bits=2, max_bits=6)
    ts = tsmod.TrainStepConfig(sync="faithful", error_feedback=True, bucket_mb=0.25,
                               adaptive=acfg, compressor=CompressorConfig(method="tnqsgd",
                                                                          bits=3))

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(to_cpu(v) for v in tree)) if hasattr(tree, "_fields") \
                else tuple(to_cpu(v) for v in tree)
        return tree.cpu()

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{launcher._free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = compat.Mesh((1,))
        opt = momentum_sgd(lr=0.05)
        p = tfm.init_lm(prng.key(0), cfg_r, device=dev)
        card, cpu = (runtime.AdaptiveStepper(cfg_r, mesh, opt, ts, lm_batch(cfg_r, 0, 4, 64, w),
                                             params_like=to_cpu(p) if w == "cpu" else p)
                     for w in (dev, "cpu"))
        o, t, e = opt.init(p), card.init_telemetry(), tsmod.init_ef_state(p, ts)
        plans, apart, moved = [], {}, 0.0
        for i in range(5):
            cpu.bits, cpu.plan = card.bits, card.plan
            ins = to_cpu((p, o, e, t))
            p, o, e, t, m = card.step(p, o, e, t, lm_batch(cfg_r, i, 4, 64, dev), i)
            *_, t_cpu, _ = cpu.step(*ins, lm_batch(cfg_r, i, 4, 64, "cpu"), i)
            check(cpu.bits == card.bits, f"train (d): step {i} plans {card.bits} on the card, "
                                         f"{cpu.bits} on the CPU")
            plans.append(card.bits)
            t_card = to_cpu(t)
            check(torch.equal(t_card.steps, t_cpu.steps), "train (d): telemetry steps")
            for f in ("g_max", "mean", "msq"):   # a bucket's mean against its RMS
                a_, b_ = getattr(t_card, f), getattr(t_cpu, f)
                scale = torch.sqrt(t_cpu.msq) if f == "mean" else torch.abs(b_).max()
                d = float((torch.abs(a_ - b_) / torch.clamp_min(scale, 1e-30)).max())
                apart[f] = max(apart.get(f, 0.0), d)
                check(d <= STATS_RTOL, f"train (d): step {i} telemetry {f} {d:g} apart")
            dcounts = torch.abs(t_card.counts - t_cpu.counts)
            moved = max(moved, float(dcounts.sum()) / (2 * (1 - acfg.ema)))
            check(moved <= 1e-4 * sum(card.sizes), f"train (d): step {i}: {moved} elements in "
                                                    "another bin on the card")
            dlog = torch.abs(t_card.log_sums - t_cpu.log_sums)
            check(bool((dlog <= STATS_RTOL * float(torch.abs(t_cpu.log_sums).max())
                        + 69.1 * dcounts + 1e-6).all()),
                  f"train (d): step {i} telemetry ln sums beyond rtol and the bin-edge moves")
    finally:
        dist.destroy_process_group()
    check(plans[-1] != plans[0], f"train (d): the stepper never replanned: {plans}")
    print(f"[train] (d) AdaptiveStepper on the reduced llama3.2-1b (replan every 2, 5 steps), "
          f"each step card against CPU from the card's state: plans {plans} on both; "
          f"telemetry apart {json.dumps(apart)} (a mean against its bucket's RMS), at most "
          f"{moved:g} elements a step in another bin; last loss {float(m['loss'][0]):.6f}")
    # (e) the launcher with observability on: 2 gloo ranks on cuda:0 spawned
    # by launcher.main, the reduced llama, adaptive replans every 2 steps,
    # a dropout schedule, 5 steps
    launcher_obs_phase(device)
    print(f"[train] phase wall time {time.time() - t_phase:.1f} s")
    return ({k: counts_a.get(k, 0) + counts_b.get(k, 0) for k in set(counts_a) | set(counts_b)},
            [{k: s[k] for k in ("step_ms", "split_ms", "peak_bytes", "loss", "gnorm")}
             for s in steps_a])


def obs_checks(obs_dir: str, steps_a: list, steps_b: list, n_buckets: int, sizes: list,
               obs_out: dict, wall_a: float, wall_b: float, card: str) -> None:
    """Phase 4d (a), run 2: the events that the launcher's ``--obs-dir``
    wrote at full width, held to the steps' captured metrics and times, and
    the report CLI on them; prints the per-bucket realized/predicted E_TQ
    and the cost of observability beside run 1."""
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.obs import metrics_event, read_events

    events = read_events(obs_dir)
    metrics = [e for e in events if e["kind"] == "metrics"]
    spans = [e for e in events if e["kind"] == "span"]
    drift = [e for e in events if e["kind"] == "drift"]
    check(len(events) == obs_out["n_written"], f"obs (a): {len(events)} events read back, "
                                               f"{obs_out['n_written']} written")
    check([e["step"] for e in metrics] == list(range(TRAIN_STEPS))
          and all(len(e["buckets"]) == n_buckets for e in metrics),
          f"obs (a): metrics events {[(e['step'], len(e['buckets'])) for e in metrics]}")
    import torch

    # the metric's wire bytes are a float32 leaf (JAX's too): above 2**24
    # bytes they are the codec's count rounded to float32
    cfg = CompressorConfig(method="tnqsgd", bits=3)
    wire = [float(torch.tensor(get_codec("tnqsgd").wire_bytes(cfg, n), dtype=torch.float32))
            for n in sizes]
    for i, (ev, s) in enumerate(zip(metrics, steps_b, strict=True)):
        check(ev == metrics_event(i, s["compression"]),
              f"obs (a): step {i}'s metrics event is not the step's metrics_event")
        for r, w in zip(ev["buckets"], wire, strict=True):
            ok = (r["bits"] == 3 and r["rank"] == 0 and r["wire_bytes"] == w and r["alpha"] > 0
                  and 0 <= r["clip_frac"] <= 1 and (r["ef_norm"] == 0) == (i == 0)
                  and all(math.isfinite(r[k]) and r[k] > 0 for k in ("realized_mse",
                                                                    "predicted_mse")))
            check(ok, f"obs (a): step {i} bucket {r['bucket']}: {r} (wire bytes {w})")
    steps = [e for e in spans if e["name"] == "train.step"]
    check([e["step"] for e in steps] == list(range(TRAIN_STEPS)) and len(steps) == len(spans),
          f"obs (a): spans {[(e['name'], e.get('step')) for e in spans]}")
    for e, s in zip(steps, steps_b, strict=True):
        check(e["dur_s"] * 1e3 >= s["step_ms"], f"obs (a): step {e['step']}'s span "
                                                f"{e['dur_s'] * 1e3:.1f} ms < its step "
                                                f"{s['step_ms']:.1f} ms")
    check(obs_out["drift"] == drift, "obs (a): run()'s drift events are not the logged ones")
    summary_path = os.path.join(obs_dir, "summary.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report", "--dir", obs_dir,
                        "--json", summary_path], capture_output=True, text=True, timeout=120,
                       env=env, cwd=str(ROOT))
    check(r.returncode == 0, f"obs (a): the report CLI exited {r.returncode}: {r.stderr[-2000:]}")
    summary = json.loads(pathlib.Path(summary_path).read_text())
    check(summary["n_steps"] == TRAIN_STEPS and len(summary["buckets"]) == n_buckets
          and [(p["name"], p["count"]) for p in summary["phases"]] == [("train.step",
                                                                         TRAIN_STEPS)],
          f"obs (a): report summary {summary['n_steps']} steps, {len(summary['buckets'])} "
          f"buckets, phases {summary['phases']}")
    ratios = [[r["realized_mse"] / r["predicted_mse"] for r in e["buckets"]] for e in metrics]
    for i, (ev, rs) in enumerate(zip(metrics, ratios)):
        print(f"[obs] llama3.2-1b step {i}: realized/predicted E_TQ per bucket "
              f"{json.dumps([round(x, 4) for x in rs])}; alpha "
              f"{json.dumps([float('%.4g' % r['alpha']) for r in ev['buckets']])}; clip "
              f"{json.dumps([round(r['clip_frac'], 5) for r in ev['buckets']])}")
    for e in drift:
        print(f"[obs] drift: {e['message']}")
    step_a = [s["step_ms"] for s in steps_a[1:]]
    step_b = [s["step_ms"] for s in steps_b[1:]]
    peak_a = max(s["peak_bytes"] for s in steps_a) / 1e9
    peak_b = max(s["peak_bytes"] for s in steps_b) / 1e9
    print(f"[obs] (a) run 2 with --obs-dir --obs-every 1: bitwise run 1; {len(events)} events "
          f"({len(metrics)} metrics of {n_buckets} buckets, {len(spans)} spans, {len(drift)} "
          f"drift); spans {json.dumps([round(e['dur_s'] * 1e3, 1) for e in steps])} ms; a step "
          f"after the first {json.dumps([round(x, 1) for x in step_b])} ms against run 1's "
          f"{json.dumps([round(x, 1) for x in step_a])}; peak {peak_b:.2f} GB against "
          f"{peak_a:.2f}; runs {wall_a:.1f} / {wall_b:.1f} s; report CLI exit 0")
    print("[time] " + json.dumps({
        "obs": "llama3.2-1b", "step_ms_after_first_run1": step_a,
        "step_ms_after_first_run2": step_b, "span_ms": [e["dur_s"] * 1e3 for e in steps],
        "peak_gb_run1": peak_a, "peak_gb_run2": peak_b, "ratios": ratios,
        "drift": [e["message"] for e in drift], "card": card}))


OBS_E_STEPS = 5
OBS_E_REPLAN = 2
OBS_E_DROPOUT = 0.2    # the counter hash (seed 0x17E) drops peer 0 of 2 at steps 0, 2 and 4


def launcher_obs_phase(device: str) -> None:
    """Phase 4d (e): ``launch.train.main`` with ``--fake-devices 2 --obs-dir``
    on the reduced llama, adaptive and elastic; rank 0's events against the
    host replay of the schedule and a fresh drift monitor."""
    import tempfile

    from repro_torch.elastic import ElasticConfig
    from repro_torch.elastic.schedule import live_mask
    from repro_torch.launch import train as launcher
    from repro_torch.obs import DriftMonitor, read_events

    t0 = time.time()
    with tempfile.TemporaryDirectory() as od:
        argv = ["--arch", "llama3.2-1b", "--reduced", "--device", device, "--batch", "4",
                "--seq", "64", "--sync", "faithful", "--ef", "--steps", str(OBS_E_STEPS),
                "--fake-devices", "2", "--adaptive", "--replan-every", str(OBS_E_REPLAN),
                "--dropout-rate", str(OBS_E_DROPOUT), "--obs-dir", od]
        try:
            rc = launcher.main(argv)
        except Exception as e:  # a rank raised: report its traceback
            fail(f"obs (e): the launcher failed: {e}")
        check(rc == 0, f"obs (e): the launcher returned {rc}")
        files = sorted(os.listdir(od))
        check(files == ["events.jsonl"], f"obs (e): files {files}: rank 0 alone writes")
        events = read_events(od)
    spans = [e for e in events if e["kind"] == "span"]
    metrics = [e for e in events if e["kind"] == "metrics"]
    dropouts = [e for e in events if e["kind"] == "dropout"]
    drift = [e for e in events if e["kind"] == "drift"]
    check([e["step"] for e in spans if e["name"] == "train.step"] == list(range(OBS_E_STEPS)),
          f"obs (e): train.step spans {[e.get('step') for e in spans]}")
    replans = [i for i in range(OBS_E_STEPS) if i and i % OBS_E_REPLAN == 0]
    n_replan = sum(e["name"] == "adaptive.replan" for e in spans)
    check(n_replan == len(replans), f"obs (e): {n_replan} adaptive.replan spans for the "
                                    f"replans at steps {replans}")
    check([e["step"] for e in metrics] == list(range(OBS_E_STEPS)),
          f"obs (e): metrics events at steps {[e['step'] for e in metrics]}")
    want = []
    for i in range(OBS_E_STEPS):
        lv = live_mask(ElasticConfig(rate=OBS_E_DROPOUT), i, 2)
        if float(lv.sum()) < 2:
            want.append({"v": 1, "kind": "dropout", "step": i, "live": int(lv.sum()),
                         "n_peers": 2, "dropped": [p for p in range(2) if float(lv[p]) == 0.0]})
    check(want and dropouts == want, f"obs (e): dropout events {dropouts}, the schedule's {want}")
    mon = DriftMonitor(warn=False)
    live = {e["step"]: e["live"] / e["n_peers"] for e in dropouts}
    for ev in metrics:
        mon.check_ratio([r["realized_mse"] for r in ev["buckets"]],
                        [r["predicted_mse"] for r in ev["buckets"]], step=ev["step"])
        mon.check_participation(live.get(ev["step"], 1.0), step=ev["step"])
    check([e for e in drift if e["drift"] != "tail_regime"] == [e.to_event() for e in mon.events],
          "obs (e): a fresh monitor on the logged rows gives other drift events")
    check(all(e["step"] in replans for e in drift if e["drift"] == "tail_regime"),
          "obs (e): a tail event outside a replan")
    print(f"[obs] (e) launcher.main --fake-devices 2 --device {device} --obs-dir: reduced "
          f"llama3.2-1b, faithful tnqsgd with EF, adaptive (replan every {OBS_E_REPLAN}), "
          f"dropout {OBS_E_DROPOUT}, {OBS_E_STEPS} steps: rank 0's {len(events)} events; "
          f"dropouts at steps {[e['step'] for e in dropouts]} as the schedule; {n_replan} replan "
          f"spans; {len(drift)} drift events as a fresh monitor gives them "
          f"({json.dumps([e['message'] for e in drift])}); {time.time() - t0:.1f} s")


# -- phase 4e: the model axis ------------------------------------------------

TP_ARGV = TRAIN_ARGV + ["--mesh", "1x2"]   # 4d (a)'s run on a (data, model) = (1, 2) mesh
TP_RANKS = 2                       # gloo ranks on cuda:0, one model shard each
TP_MAX_PEAK_GB = 30.0              # (a): each rank's peak
# (a): step 0's loss against 4d (a)'s: the bfloat16 partials of the row-split
# products are rounded before they are summed.  Measured 2.0e-6 on the card;
# the bound is 50 times that and 20 times under one bfloat16 ulp (2**-9)
TP_STEP0_RTOL = 1e-4
TP_SERVE_REL_L2 = DECODE_BF16_REL_L2   # (b): bfloat16 logits against 4c (a)'s, relative L2
TP_BUCKET_MB = 1.0                 # (c): a few model-local buckets of the reduced llama
# (c): label -> (mesh sizes, axis names, sync modes, steps)
TP_LAYOUTS = {"2x2": ((2, 2), ("data", "model"), ("faithful", "two_phase"), TRAIN_STEPS),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"), ("hierarchical",), 1)}


def _spawn_all(jobs: list) -> list:
    """Each job ``(fn, n, args, label)`` as ``fn(rank, n, init, workdir,
    *args)`` on ``n`` spawned ranks, all jobs at once; each rank writes
    ``workdir/rank<r>.pt``.  Returns every job's results in rank order.
    Fails when a rank raises or the ranks pass ``MESH_TIMEOUT_S``."""
    import tempfile

    import torch
    import torch.multiprocessing as tmp

    dirs = [tempfile.TemporaryDirectory() for _ in jobs]
    try:
        t0 = time.time()
        ctxs = [tmp.start_processes(fn, args=(n, f"file://{wd.name}/rendezvous", wd.name)
                                    + tuple(args), nprocs=n, join=False, start_method="spawn")
                for (fn, n, args, _), wd in zip(jobs, dirs)]
        try:
            for ctx, (_, _, _, label) in zip(ctxs, jobs):
                try:
                    while not ctx.join(timeout=5):
                        if time.time() - t0 > MESH_TIMEOUT_S:
                            fail(f"{label}: ranks still running after {MESH_TIMEOUT_S} s")
                except Exception as e:  # a rank raised: report its traceback
                    fail(f"{label}: a rank failed: {e}")
        finally:
            for ctx in ctxs:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                    p.join(timeout=30)
        return [[torch.load(os.path.join(wd.name, f"rank{r}.pt"), weights_only=False)
                 for r in range(n)] for (_, n, _, _), wd in zip(jobs, dirs)]
    finally:
        for wd in dirs:
            wd.cleanup()


def _spawn(fn, n: int, args: tuple, label: str) -> list:
    """One job of :func:`_spawn_all`."""
    return _spawn_all([(fn, n, args, label)])[0]


def _tp_train_rank(rank: int, world: int, init: str, workdir: str, src: str) -> None:
    """One rank of 4e (a): ``launch.train.run(TP_ARGV)`` twice, each step's
    parts timed; writes both runs' histories, steps and launches, whether
    the runs' final params and EF rows are bitwise alike, and whether gloo
    sums a bfloat16 CUDA tensor."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch.models.smallnet import tree_leaves

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        probe = torch.full((8,), rank + 1.0, dtype=torch.bfloat16, device="cuda:0")
        try:
            dist.all_reduce(probe)
            bf16 = f"accepted (sum {float(probe[0])})"
        except Exception as e:  # record the refusal
            bf16 = f"refused ({type(e).__name__}: {str(e).splitlines()[0][:160]})"
        runs, finals = [], []
        for _ in range(2):
            out, steps, counts = _instrumented_run(TP_ARGV)
            finals.append(([t.cpu() for t in tree_leaves(out["params"])],
                           [e.cpu() for e in out["ef_state"]]))
            runs.append({"history": out["history"], "counts": counts,
                         "steps": [{k: v for k, v in st.items() if k != "compression"}
                                   for st in steps]})
            del out
            torch.cuda.empty_cache()
        (pa, ea), (pb, eb) = finals
        same = (all(torch.equal(x, y) for x, y in zip(pa, pb, strict=True))
                and all(torch.equal(x, y) for x, y in zip(ea, eb, strict=True)))
        torch.save({"runs": runs, "same": same, "bf16_all_reduce": bf16,
                    "n_params": sum(t.numel() for t in pa), "ef_sizes": [e.numel() for e in ea]},
                   os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tp_serve_rank(rank: int, world: int, init: str, workdir: str, src: str) -> None:
    """One rank of 4e (b): llama3.2-1b served on a (1, 2) mesh (its slices
    of ``init_lm(key(0))``): 4 x 2,048 prompts and 16 greedy tokens twice,
    then fed the one-rank run's tokens; and float32 at 2 layers fed the
    one-rank run's tokens.  Rank 0 makes the one-rank runs (4c (a)'s and
    (b)'s, on the full params).  Writes the tokens, logits and times."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist import compat, sharding
    from repro_torch.dist.serve_step import make_serve_fns
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import _float32_and_deterministic

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    _float32_and_deterministic()
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        mesh = compat.Mesh((1, world), ("data", "model"))

        def run(fns, params, batch, n_tokens, forced=None):
            """Prefill, then ``n_tokens - 1`` decode steps, greedy or fed
            ``forced``'s tokens: (tokens, logits (n, B, V) on the host,
            prefill ms, each decode step's ms)."""
            prefill_fn, decode_fn = fns[:2]
            t = batch.tokens.shape[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill_fn(params, batch)
            torch.cuda.synchronize()
            pre = (time.perf_counter() - t0) * 1e3
            outs, toks, dec = [logits.cpu()], [logits.argmax(-1)[:, None]], []
            for i in range(n_tokens - 1):
                tok = toks[-1] if forced is None else forced[:, i:i + 1].to(dev)
                t0 = time.perf_counter()
                logits, caches = decode_fn(params, tok, caches, t + i)
                torch.cuda.synchronize()
                dec.append((time.perf_counter() - t0) * 1e3)
                outs.append(logits.cpu())
                toks.append(logits.argmax(-1)[:, None])
            return torch.cat(toks, 1).cpu(), torch.stack(outs), pre, dec

        cfg = get_config("llama3.2-1b")
        b2k, b64 = lm_batch(cfg, 0, 4, 2048, dev), lm_batch(cfg, 0, 4, 64, dev)
        full = init_lm(prng.key(0), cfg, device=dev)
        cfg2 = cfg.replace(num_layers=2, param_dtype="float32", compute_dtype="float32")
        full2 = _tmap(lambda t: t.float(), dict(full, blocks=_tmap(lambda t: t[:2],
                                                                   full["blocks"])))
        # the one-rank runs on rank 0; their tokens fed to both ranks
        ref = ref2 = None
        toks = torch.zeros((4, SERVE_TOKENS), dtype=torch.int64)
        toks2 = torch.zeros((4, 5), dtype=torch.int64)
        if rank == 0:
            ref = run(make_serve_fns(cfg, 2048), full, b2k, SERVE_TOKENS)
            ref2 = run(make_serve_fns(cfg2, 64), full2, b64, 5)
            toks, toks2 = ref[0], ref2[0]
        dist.broadcast(toks, 0)
        dist.broadcast(toks2, 0)
        params = sharding.shard_tree(full, sharding.lm_pspecs(cfg, mesh), mesh)
        params2 = sharding.shard_tree(full2, sharding.lm_pspecs(cfg2, mesh), mesh)
        del full, full2
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fns = make_serve_fns(cfg, 2048, mesh)
        greedy = [run(fns, params, b2k, SERVE_TOKENS) for _ in range(2)]
        forced = run(fns, params, b2k, SERVE_TOKENS, forced=toks)
        forced2 = run(make_serve_fns(cfg2, 64, mesh), params2, b64, 5, forced=toks2)
        torch.save({"ref": ref, "greedy": greedy, "forced": forced, "ref2": ref2,
                    "forced2": forced2, "peak_bytes": torch.cuda.max_memory_allocated()},
                   os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tp_reduced_rank(rank: int, world: int, init: str, workdir: str, src: str,
                     layout: str, device: str) -> None:
    """One rank of 4e (c): the reduced llama in float32 on ``layout``'s mesh,
    each sync mode of it with EF, telemetry and metrics through
    ``make_train_step``; writes every sync's inputs and outputs and the
    launches."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.adaptive.controller import AdaptiveConfig
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import prng
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist import compat, sharding
    from repro_torch.dist import train_step as tsmod
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizers import momentum_sgd
    from repro_torch.train import _float32_and_deterministic

    torch.set_num_threads(1)
    _float32_and_deterministic()
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        sizes, names, syncs, steps = TP_LAYOUTS[layout]
        dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = compat.Mesh(sizes, names)
        n_dp = math.prod(mesh.dp_sizes)
        cfg = reduced(get_config("llama3.2-1b"))
        params = sharding.shard_tree(init_lm(prng.key(0), cfg, device=dev),
                                     sharding.lm_pspecs(cfg, mesh), mesh)
        out = {"coords": mesh.coords}
        real = tsmod.make_sync_fn
        for sync in syncs:
            ts = tsmod.TrainStepConfig(sync=sync, bucket_mb=TP_BUCKET_MB, error_feedback=True,
                                       adaptive=AdaptiveConfig(), metrics_compression=True,
                                       compressor=CompressorConfig(method="tnqsgd", bits=3))
            calls = []

            def recording(ts_, mesh_, like):
                fn = real(ts_, mesh_, like)

                def sync_fn(grads, key, ef, tstate):
                    res = fn(grads, key, ef, tstate)
                    calls.append({"in": ([g.cpu() for g in grads], key.cpu(),
                                         [e.cpu() for e in ef], [t.cpu() for t in tstate]),
                                  "out": ([m.cpu() for m in res[0]], [e.cpu() for e in res[1]],
                                          [t.cpu() for t in res[2]], res[3].cpu(),
                                          [f.cpu() for f in res[4]])})
                    return res
                return sync_fn

            tsmod.make_sync_fn = recording
            try:
                opt = momentum_sgd(lr=0.05)
                batches = [lm_batch(cfg, i, 2 * n_dp, 64, dev) for i in range(steps)]
                fn = tsmod.make_train_step(cfg, mesh, opt, ts, batches[0], params_like=params)
                p, o = params, opt.init(params)
                ef = tsmod.init_ef_state(params, ts)
                t = tsmod.init_telemetry_state(params, ts)
                kernels.reset_launch_counts()
                losses = []
                for i, b in enumerate(batches):
                    p, o, ef, t, m = fn(p, o, ef, t, b, i)
                    losses.append(float(m["loss"][0]))
                counts = {k: v for k, v in kernels.launch_counts().items() if v}
            finally:
                tsmod.make_sync_fn = real
            out[sync] = {"calls": calls, "counts": counts, "losses": losses,
                         "n_buckets": len(ef)}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _model_axis_reduced(device: str) -> dict:
    """Phase 4e (c) on ``device``: the reduced llama on the meshes of
    ``TP_LAYOUTS``, every rank's syncs against the one-device replay of its
    model shard on ``device`` (no launch on the CPU).  Returns every rank's
    port kernel launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.adaptive import telemetry
    from repro_torch.adaptive.controller import AdaptiveConfig
    from repro_torch.core.compressors import CompressorConfig, bucket_concat, plan_buckets
    from repro_torch.dist import train_step as tsmod
    from repro_torch.dist.reference import reference_sync_state
    from repro_torch.obs import metrics as obs_metrics

    src = str(ROOT / "src")
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    kn = {k: kernels.kernel_name(k) for k in kernels.KERNELS}
    k1, k2, k4, k6, k8, k10 = (kn[kernels.ef_correct_stats_2d],
                               kn[kernels.codebook_encode_pack_resid_2d],
                               kn[kernels.codebook_decode_reduce_3d],
                               kn[kernels.codebook_encode_pack_2d],
                               kn[kernels.codebook_decode_rows_3d], kn[kernels.bucket_stats_2d])
    launches = {}
    want_rows = {"faithful": {k1: 1, k2: 1, k4: 1},
                 "two_phase": {k1: 1, k2: 1, k4: 1, k10: 1, k6: 1, k8: 1},
                 "hierarchical": {k1: 1, k2: 2, k4: 2, k10: 2, k6: 1, k8: 1}}
    t0 = time.time()
    jobs = [(_tp_reduced_rank, math.prod(sizes), (src, layout, device), f"model axis {layout}")
            for layout, (sizes, _, _, _) in TP_LAYOUTS.items()]
    results = _spawn_all(jobs)      # the meshes' ranks run at once
    print(f"[model] (c) {' and '.join(TP_LAYOUTS)} ranks' wall {time.time() - t0:.1f} s")
    for (layout, (sizes, names, syncs, steps)), ranks in zip(TP_LAYOUTS.items(), results):
        n_model = sizes[-1]
        n_dp = len(ranks) // n_model
        dp_sizes = tuple(sizes[:-1])
        for sync in syncs:
            ts = tsmod.TrainStepConfig(sync=sync, bucket_mb=TP_BUCKET_MB, error_feedback=True,
                                       adaptive=AdaptiveConfig(), metrics_compression=True,
                                       compressor=CompressorConfig(method="tnqsgd", bits=3))
            for r, rk in enumerate(ranks):
                nb = rk[sync]["n_buckets"]
                want = ({k: v * nb * steps for k, v in want_rows[sync].items()}
                        if dev.type == "cuda" else {})
                check(rk[sync]["counts"] == want, f"model axis {layout} {sync}: rank {r}'s "
                                                  f"launches {rk[sync]['counts']}, expected {want}")
                for k, v in rk[sync]["counts"].items():
                    launches[k] = launches.get(k, 0) + v
            for i in range(steps):
                own_sq, sums = [], []
                for m in range(n_model):
                    calls = [ranks[d * n_model + m][sync]["calls"][i] for d in range(n_dp)]
                    grads, key, _, _ = calls[0]["in"]
                    check(all(torch.equal(c["in"][1], key) for c in calls)
                          and torch.equal(ranks[0][sync]["calls"][i]["in"][1], key),
                          f"model axis {layout} {sync}: the step keys differ")
                    stacked = [torch.stack([c["in"][0][j] for c in calls]).to(dev)
                               for j in range(len(grads))]
                    ef = [torch.stack([c["in"][2][b] for c in calls]).to(dev)
                          for b in range(len(calls[0]["in"][2]))]
                    n_fields = len(calls[0]["in"][3])
                    tst = telemetry.TelemetryState(*(
                        torch.stack([c["in"][3][f] for c in calls]).to(dev)
                        for f in range(n_fields)))
                    captured, real_fin = [], obs_metrics.finalize

                    def spy(s_, static, n_, _real=real_fin, _out=captured):
                        _out.append((s_.clone(), static))
                        return _real(s_, static, n_)

                    obs_metrics.finalize = spy
                    try:
                        wmean, wres, wt, _ = reference_sync_state(ts, stacked, dp_sizes,
                                                                  key.to(dev), ef=ef, tstate=tst)
                    finally:
                        obs_metrics.finalize = real_fin
                    sums.append(captured)
                    bp = plan_buckets([x.numel() for x in wmean], ts.bucket_elements)
                    own_sq.append(tsmod._sum_of_squares(bucket_concat(list(wmean), bp)))
                    for d, c in enumerate(calls):
                        mean, ef_out, t_out, _, _ = c["out"]
                        check(all(torch.equal(a, b.cpu())
                                  for a, b in zip(mean, wmean, strict=True)),
                              f"model axis {layout} {sync} step {i}: rank ({d}, {m})'s mean "
                              "slices are not its shard's replay")
                        check(all(torch.equal(a, b[d].cpu()) for a, b in zip(ef_out, wres,
                                                                               strict=True)),
                              f"model axis {layout} {sync} step {i}: rank ({d}, {m})'s EF rows")
                        check(all(torch.equal(a, b[d].cpu()) for a, b in zip(t_out, wt,
                                                                               strict=True)),
                              f"model axis {layout} {sync} step {i}: rank ({d}, {m})'s "
                              "telemetry row")
                gsq = own_sq[0]
                for m in range(1, n_model):
                    gsq = gsq + own_sq[m]
                for d in range(n_dp):
                    s_, static = sums[0][d]
                    for m in range(1, n_model):
                        s_ = s_ + sums[m][d][0]
                    want_cm = obs_metrics.finalize(s_, static, n_model)
                    for m in range(n_model):
                        _, _, _, gnorm, cm = ranks[d * n_model + m][sync]["calls"][i]["out"]
                        check(torch.equal(gnorm, torch.sqrt(gsq).cpu()),
                              f"model axis {layout} {sync} step {i}: rank ({d}, {m})'s gnorm "
                              "is not the root of the shards' summed squares")
                        check(all(torch.equal(a, b.cpu()) for a, b in zip(cm, want_cm,
                                                                           strict=True)),
                              f"model axis {layout} {sync} step {i}: rank ({d}, {m})'s metrics")
            print(f"[model] (c) {layout} {sync}: {len(ranks)} gloo ranks on {dev}, reduced "
                  f"llama3.2-1b float32, tnqsgd 3 bits with EF, telemetry and metrics, {steps} "
                  f"step(s), {ranks[0][sync]['n_buckets']} model-local buckets: every rank's "
                  f"mean slices, EF rows, telemetry row and metrics bitwise its model shard's "
                  f"one-device replay, its gnorm the root of the shards' summed squares; losses "
                  f"{ranks[0][sync]['losses']}; launches a rank "
                  f"{json.dumps(ranks[0][sync]['counts'])}")
        del ranks
    return launches


def model_axis_phase(card: str, steps_4d: list, served: dict) -> dict:
    """Phase 4e: the model axis on the card (the module docstring lists its
    checks).  ``steps_4d`` and ``served`` are 4d (a)'s first run's steps
    and 4c's llama results.  Returns every rank's port kernel launches."""
    import torch

    from repro_torch import kernels

    t_phase = time.time()
    src = str(ROOT / "src")
    dev = torch.device("cuda", 0)
    kn = {k: kernels.kernel_name(k) for k in kernels.KERNELS}
    k1, k2, k4, k6, k8, k10 = (kn[kernels.ef_correct_stats_2d],
                               kn[kernels.codebook_encode_pack_resid_2d],
                               kn[kernels.codebook_decode_reduce_3d],
                               kn[kernels.codebook_encode_pack_2d],
                               kn[kernels.codebook_decode_rows_3d], kn[kernels.bucket_stats_2d])
    launches = {}

    # (a) llama3.2-1b at its published config on (1, 2), through the launcher
    t0 = time.time()
    ranks = _spawn(_tp_train_rank, TP_RANKS, (src,), "model axis (a)")
    wall_a = time.time() - t0
    hist0 = ranks[0]["runs"][0]["history"]
    for r, rk in enumerate(ranks):
        a, b = rk["runs"]
        check(rk["same"] and a["history"] == b["history"],
              f"model axis (a): rank {r}'s two runs differ: {a['history']} vs {b['history']}")
        check(a["history"] == hist0, f"model axis (a): rank {r}'s losses {a['history']} are not "
                                     f"rank 0's {hist0}")
        nb = len(rk["ef_sizes"])
        per_step = {k1: nb, k2: nb, k4: nb}
        for run in (a, b):
            for s in run["steps"]:
                check(s["launches"] == per_step, f"model axis (a): rank {r}'s launches a step "
                                                 f"{s['launches']}, expected {per_step}")
            check(run["counts"] == {k: v * TRAIN_STEPS for k, v in per_step.items()},
                  f"model axis (a): rank {r}'s launches of a run {run['counts']}")
        for k, v in a["counts"].items():
            launches[k] = launches.get(k, 0) + v
    losses = [h["loss"] for h in hist0]
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["gnorm"]) for h in hist0),
          f"model axis (a): non-finite loss or gnorm {hist0}")
    check(losses[-1] < losses[0], f"model axis (a): the loss did not fall: {losses}")
    step0_4d = steps_4d[0]["loss"]
    step0_rel = abs(losses[0] - step0_4d) / abs(step0_4d)
    check(step0_rel <= TP_STEP0_RTOL, f"model axis (a): step 0's loss {losses[0]} is {step0_rel:g} "
                                      f"from 4d (a)'s {step0_4d} (rtol {TP_STEP0_RTOL:g})")
    peaks = [max(s["peak_bytes"] for run in rk["runs"] for s in run["steps"]) for rk in ranks]
    check(max(peaks) <= TP_MAX_PEAK_GB * 1e9, f"model axis (a): peaks {peaks} past "
                                               f"{TP_MAX_PEAK_GB} GB")
    for rk in ranks:
        for run in rk["runs"]:
            for s in run["steps"]:
                s["split_ms"]["other"] = s["split_ms"].pop("step")
                s["step_ms"] = sum(s["split_ms"].values())
    print(f"[model] (a) llama3.2-1b at its published config on --mesh 1x2 ({TP_RANKS} gloo ranks "
          f"on cuda:0, {ranks[0]['n_params']:,} parameters a rank, "
          f"{len(ranks[0]['ef_sizes'])} model-local buckets of up to "
          f"{max(ranks[0]['ef_sizes']):,} elements), faithful tnqsgd 3 bits with EF, "
          f"{TRAIN_STEPS} steps, twice bit for bit (losses, gnorms, each rank's params and EF); "
          f"losses {losses}; step 0 {step0_rel:.3g} from 4d (a)'s {step0_4d:.6f} (rtol "
          f"{TP_STEP0_RTOL:g}); peaks {[round(p / 1e9, 2) for p in peaks]} GB; gloo on a "
          f"bfloat16 CUDA all_reduce: {ranks[0]['bf16_all_reduce']}; wall {wall_a:.1f} s")
    for i, s4 in enumerate(steps_4d):
        per_rank = [rk["runs"][0]["steps"][i] for rk in ranks]
        print(f"[model] (a) step {i}: ms a rank {[round(s['step_ms'], 1) for s in per_rank]} "
              f"(4d (a) one rank {s4['step_ms']:.1f}); split rank 0 "
              f"{json.dumps({k: round(v, 1) for k, v in per_rank[0]['split_ms'].items()})}, "
              f"4d (a) {json.dumps({k: round(v, 1) for k, v in s4['split_ms'].items()})}")
    for r, rk in enumerate(ranks):
        for label, run in zip(("first", "second"), rk["runs"]):
            for i, s in enumerate(run["steps"]):
                print("[time] " + json.dumps({
                    "train": "llama3.2-1b", "mesh": "1x2", "rank": r, "run": label, "step": i,
                    "step_ms": s["step_ms"], "split_ms": s["split_ms"],
                    "max_memory_allocated_bytes": s["peak_bytes"], "batch": 4, "seq": 2048,
                    "sync": "faithful", "ranks": TP_RANKS, "card": card}))
    del ranks

    # (b) serving llama3.2-1b on (1, 2)
    t0 = time.time()
    ranks = _spawn(_tp_serve_rank, TP_RANKS, (src,), "model axis (b)")
    wall_b = time.time() - t0
    rel_l2, err2, scale2 = 0.0, 0.0, 0.0
    ref, ref2 = ranks[0]["ref"], ranks[0]["ref2"]
    check(torch.equal(ref[0], served["tokens_4x2048"]), "model axis (b): the one-rank run is not "
                                                        "4c (a)'s")
    for r, rk in enumerate(ranks):
        (ta, la, pa, da), (tb, lb, pb, db) = rk["greedy"]
        check(torch.equal(ta, tb) and torch.equal(la, lb),
              f"model axis (b): rank {r}'s two greedy runs differ")
        check(torch.equal(la, ranks[0]["greedy"][0][1]), f"model axis (b): rank {r}'s logits "
                                                         "are not rank 0's")
        want, got = ref[1].float(), rk["forced"][1].float()
        rel = [float((g - w).norm() / w.norm()) for g, w in zip(got, want)]
        check(max(rel) <= TP_SERVE_REL_L2, f"model axis (b): bfloat16 logits {max(rel):g} "
                                           f"relative L2 from 4c (a)'s (bound {TP_SERVE_REL_L2:g})")
        want2, got2 = ref2[1], rk["forced2"][1]
        scale = float(want2.abs().max())
        diff = (got2 - want2).abs()
        check(bool((diff <= SERVE_RTOL * scale + SERVE_RTOL * want2.abs()).all()),
              f"model axis (b): float32 at 2 layers off the one-rank run by "
              f"{float(diff.max()):g} (max |logit| {scale:g})")
        rel_l2, err2, scale2 = max(rel_l2, max(rel)), max(err2, float(diff.max())), scale
    rk = ranks[0]
    (ta, _, pa, da), (_, _, pb, db) = rk["greedy"]
    agree = int((ta == ref[0]).all(0).long().cumprod(0).sum())
    print(f"[model] (b) llama3.2-1b served on --mesh 1x2: 4 x 2,048 prompts, {SERVE_TOKENS} "
          f"greedy tokens twice bit for bit on both ranks; fed 4c (a)'s tokens, bfloat16 "
          f"logits within relative L2 {rel_l2:.3g} of 4c (a)'s (bound {TP_SERVE_REL_L2:g}); "
          f"its own greedy tokens agree with 4c (a)'s for the first {agree} of {SERVE_TOKENS}; "
          f"float32 at 2 layers, prefill and 4 decode steps: max abs err "
          f"{err2:.3g}, max |logit| {scale2:.4g} (rtol {SERVE_RTOL:g}, atol "
          f"{SERVE_RTOL:g} x max |logit|); prefill {pa:.2f} / {pb:.2f} ms (4c (a) one rank "
          f"{served['prefill_ms_4x2048'][0]:.2f} / {served['prefill_ms_4x2048'][1]:.2f}), "
          f"decode median {statistics.median(da + db):.2f} ms a token (4c (a) "
          f"{served['decode_ms_median_4x2048']:.2f}); wall {wall_b:.1f} s")
    print("[time] " + json.dumps({
        "serve": "llama3.2-1b", "mesh": "1x2", "batch": 4, "prefill_ms_4x2048": [pa, pb],
        "decode_ms_per_token_median_4x2048": statistics.median(da + db),
        "max_memory_allocated_bytes_per_rank": [x["peak_bytes"] for x in ranks],
        "one_rank_prefill_ms_4x2048": served["prefill_ms_4x2048"],
        "one_rank_decode_ms_per_token_median_4x2048": served["decode_ms_median_4x2048"],
        "card": card}))
    del ranks

    # (c) the reduced llama on 2x2 and 2x2x2, every rank's syncs against the
    # one-device replay of its model shard
    for k, v in _model_axis_reduced("cuda").items():
        launches[k] = launches.get(k, 0) + v
    print(f"[model] phase wall time {time.time() - t_phase:.1f} s")
    return launches


DRYRUN_OPTIMIZER = "momentum_sgd"  # phase 4d (a)'s: the launcher's default
ANALYSIS_TIMEOUT_S = 600
# the kernels the sync pass's quick matrix must launch through the real sync
ANALYSIS_KERNELS = ("encode_fused.ef_correct_stats_2d",
                    "encode_fused.codebook_encode_pack_resid_2d",
                    "decode.codebook_decode_reduce_3d", "encode_fused.codebook_encode_pack_2d",
                    "decode.codebook_decode_rows_3d", "stats.bucket_stats_2d",
                    "orthogonalize.orthogonalize_2d")


def dryrun_phase(card: str, train_steps: list, served: dict) -> None:
    """Phase 6 (a): the dry runs of phase 4d (a)'s step and 4c's llama
    prefill on meta tensors (``launch.dryrun.run_one``) in this process,
    each taking no card memory and launching no port kernel; their
    predicted terms beside what 4c and 4d measured, the measured step's
    MFU, and the records through ``launch.report``."""
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.launch import dryrun, report, roofline

    t_phase = time.time()
    runs = {
        "train": (dryrun.shape_for("train_4k", 4, 2048),
                  dict(sync="faithful", method="tnqsgd", bits=3, ef=True,
                       optimizer=DRYRUN_OPTIMIZER)),
        "prefill": (dryrun.shape_for("prefill_32k", 4, 2048), {}),
    }
    recs = {}
    for label, (shape, kw) in runs.items():
        # free what earlier phases left to the collector first, so that a
        # collection during the dry run cannot move the count
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0, counts0 = torch.cuda.memory_allocated(), kernels.launch_counts()
        t0 = time.time()
        rec = dryrun.run_one("llama3.2-1b", shape, **kw)
        torch.cuda.synchronize()
        check(torch.cuda.memory_allocated() == mem0 == torch.cuda.max_memory_allocated(),
              f"dry run {label}: card memory {mem0} -> {torch.cuda.memory_allocated()} (peak "
              f"{torch.cuda.max_memory_allocated()})")
        check(kernels.launch_counts() == counts0, f"dry run {label} launched a port kernel")
        r = rec["roofline"]
        check(r["flops"] > 0 and r["hbm_bytes"] > 0 and rec["fits_one_card"],
              f"dry run {label}: {r}")
        recs[label] = rec
        print(f"[dryrun] {dryrun.summary_line(rec)}; {time.time() - t0:.1f} s, no card memory, "
              "no kernel")

    # predicted against measured: 4d (a)'s steps after the first, 4c's prefill
    later = train_steps[1:]
    step_ms = statistics.median(s["step_ms"] for s in later)
    fb_ms = statistics.median(s["split_ms"]["forward_backward"] + s["split_ms"]["optimizer"]
                              for s in later)
    kern_ms = statistics.median(s["split_ms"]["kernels"] for s in later)
    peak = max(s["peak_bytes"] for s in train_steps)
    tr, parts = recs["train"]["roofline"], recs["train"]["parts"]
    model_ms = max(parts["model"]["compute_s"], parts["model"]["memory_s"]) * 1e3
    pre_ms = statistics.median(served["prefill_ms_4x2048"])
    pr = recs["prefill"]["roofline"]
    mfu = roofline.mfu(tr["model_flops"], step_ms / 1e3)
    out = {
        "train": {
            "predicted": {"compute_ms": tr["compute_s"] * 1e3, "memory_ms": tr["memory_s"] * 1e3,
                          "collective_ms": tr["collective_s"] * 1e3,
                          "model_compute_ms": parts["model"]["compute_s"] * 1e3,
                          "model_memory_ms": parts["model"]["memory_s"] * 1e3,
                          "sync_memory_ms": parts["sync"]["memory_s"] * 1e3,
                          "model_flops": tr["model_flops"], "flops": tr["flops"],
                          "hbm_bytes": tr["hbm_bytes"],
                          "peak_bytes": recs["train"]["memory"]["total_per_device_bytes"]},
            "measured": {"step_ms": step_ms, "forward_backward_optimizer_ms": fb_ms,
                         "kernels_ms": kern_ms, "peak_bytes": peak},
            "ratios": {"compute": parts["model"]["compute_s"] * 1e3 / fb_ms,
                       "memory": parts["model"]["memory_s"] * 1e3 / fb_ms,
                       "model_bound": model_ms / fb_ms,
                       "step_bound": max(tr["compute_s"], tr["memory_s"]) * 1e3 / step_ms,
                       "peak": recs["train"]["memory"]["total_per_device_bytes"] / peak},
            "mfu": mfu},
        "prefill": {
            "predicted": {"compute_ms": pr["compute_s"] * 1e3, "memory_ms": pr["memory_s"] * 1e3,
                          "model_flops": pr["model_flops"],
                          "peak_bytes": recs["prefill"]["memory"]["total_per_device_bytes"]},
            "measured": {"prefill_ms": pre_ms, "prefill_ms_runs": served["prefill_ms_4x2048"]},
            "ratios": {"compute": pr["compute_s"] * 1e3 / pre_ms,
                       "memory": pr["memory_s"] * 1e3 / pre_ms,
                       "bound": max(pr["compute_s"], pr["memory_s"]) * 1e3 / pre_ms}},
    }
    print("[time] " + json.dumps({"dryrun_vs_measured": out, "card": card}))
    print(f"[dryrun] llama3.2-1b train 4 x 2048 (one rank, faithful tnqsgd 3 bits with EF): "
          f"predicted compute {tr['compute_s'] * 1e3:.1f} ms, memory {tr['memory_s'] * 1e3:.1f} "
          f"ms, collective {tr['collective_s'] * 1e3:.1f} ms, {tr['model_flops']:.4g} model "
          f"FLOPs, {recs['train']['memory']['total_per_device_bytes'] / 1e9:.2f} GB a device; "
          f"measured step {step_ms:.1f} ms (forward+backward+optimizer {fb_ms:.1f}, kernels "
          f"{kern_ms:.1f}), peak {peak / 1e9:.2f} GB; MFU {mfu:.4f} on {card}")
    print(f"[dryrun] llama3.2-1b prefill 4 x 2048: predicted compute {pr['compute_s'] * 1e3:.1f} "
          f"ms, memory {pr['memory_s'] * 1e3:.1f} ms, {pr['model_flops']:.4g} model FLOPs, "
          f"{recs['prefill']['memory']['total_per_device_bytes'] / 1e9:.2f} GB a device; "
          f"measured {pre_ms:.2f} ms on {card}")
    with tempfile.TemporaryDirectory() as d:
        for rec in recs.values():
            pathlib.Path(d, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json").write_text(
                json.dumps(rec))
        loaded = report.load(pathlib.Path(d))
        check(len(loaded) == 2, f"report.load read {len(loaded)} of the 2 records")
        print(report.roofline_table(loaded, "1"))
        print(report.dryrun_table(loaded))
    print(f"[dryrun] phase wall time {time.time() - t_phase:.1f} s")


def analysis_phase(card: str) -> dict:
    """Phase 6 (b): ``python -m repro_torch.analysis --quick`` (its sync
    pass on 4 gloo ranks on ``cuda:0``, the AST pass, the kernels pass
    over this build's reports): clean, every budget met, the sync's
    kernels launched.  Returns the launches its ranks counted."""
    import tempfile

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as d:
        out = pathlib.Path(d, "ANALYSIS.json")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--quick", "--json",
                               str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=ANALYSIS_TIMEOUT_S)
        print("\n".join(f"[analysis] {ln}" for ln in proc.stdout.splitlines()))
        check(proc.returncode == 0, f"repro_torch.analysis --quick exited {proc.returncode}:\n"
                                    f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        rep = json.loads(out.read_text())
    check(rep["clean"] and rep["findings"] == [], f"analysis findings {rep['findings']}")
    per = rep["passes"]["sync"]["per_trace"]
    budgets = {"faithful": 1, "two_phase": 2, "hierarchical": 3}
    for mode, budget in budgets.items():
        row = per[f"sync:{mode}/tqsgd"]
        check(sum(row["collectives"].values()) == row["budget"] == budget,
              f"analysis {mode}: collectives {row['collectives']}, budget {budget}")
    dsgd = per["sync:dsgd/tqsgd"]
    check(dsgd["collectives"] == {"psum": dsgd["n_buckets"]} == {"psum": dsgd["budget"]},
          f"analysis dsgd: {dsgd}")
    launched: dict[str, int] = {}
    for row in per.values():
        for k, v in row.get("launches", {}).items():
            launched[k] = launched.get(k, 0) + v
    missing = [k for k in ANALYSIS_KERNELS if not launched.get(k)]
    check(not missing, f"the sync pass never launched {missing}: {launched}")
    kern = rep["passes"]["kernels"]
    check(all(row["entries"] for row in kern["per_kernel"].values()),
          f"kernels pass: {kern['per_kernel']}")
    print(f"[analysis] clean: {rep['passes']['sync']['traces']} sync runs on 4 gloo ranks on "
          f"cuda:0 (collectives at their budgets), {rep['passes']['ast']['files']} files, "
          f"{kern['kernels']} kernel entries; launches {json.dumps(launched)}; phase wall "
          f"time {time.time() - t_phase:.1f} s")
    return launched


def main() -> int:
    t_script = time.time()
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1

    from repro_torch import kernels
    from repro_torch.core import prng
    from repro_torch.core.compressors import CompressorConfig, plan_from_stats
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode as kdec
    from repro_torch.kernels import encode_fused as kenc
    from repro_torch.kernels import ops
    from repro_torch.kernels import orthogonalize as korth
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels import stats as kstats

    # -- 1. card ----------------------------------------------------------
    card = card_line()
    print(f"[card] {card}")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 2. build ---------------------------------------------------------
    t0 = time.time()
    reports = _build.build_all()
    print(f"[build] {len(reports)} libraries in {time.time() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "ptxas info" in line:
                print(f"[build] {name}.cu: {line.strip()}")
    # the kernels pass over these reports: no kernel of any source spills,
    # none passes 227 KB of shared memory or 255 registers, K1-K17 all built
    from repro_torch.analysis import kernel_resources

    res_findings, res_table = kernel_resources.run_pass(reports)
    check(not res_findings, f"kernels pass: {[str(f) for f in res_findings]}")
    per_k = kernel_resources.per_kernel(res_table)
    print(f"[build] kernels pass: {len(res_table)} entry functions, K1-K17 all built, no spill "
          f"stores, at most {max(r.registers for r in res_table)} registers and "
          f"{max(r.smem_bytes for r in res_table)} B of static shared memory")
    print("[time] " + json.dumps({"kernel_resources": per_k, "card": card}))

    # -- 3. kernel parity -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1234)

    def heavy(n: int, scale: float) -> torch.Tensor:
        z = torch.randn(n, generator=gen, device=dev)
        return scale * z * torch.exp(torch.randn(n, generator=gen, device=dev))

    def to2d(x: torch.Tensor) -> torch.Tensor:
        return ops._to_2d(x)[0]

    def plan(g2: torch.Tensor, n: int, bits: int, method: str):
        st = ref.bucket_stats(g2, n)
        return plan_from_stats(CompressorConfig(method=method, bits=bits), st[0], st[1], st[2, 0])

    def plan_levels(g2: torch.Tensor, n: int, bits: int) -> torch.Tensor:
        return plan(g2, n, bits, "tnqsgd").levels

    def note_err(name: str, err: float) -> None:
        max_err[name] = max(max_err[name], err)

    def agree(name: str, got, want, what: str) -> None:
        """Bitwise agreement of a kernel's output with its plain version."""
        check(got.shape == want.shape and torch.equal(got, want), f"{name} {what} differs")
        if got.dtype == torch.float32:
            note_err(name, float(torch.abs(got - want).max()))

    def stats_err(got, want, x2, n, what, counts=None):
        """The tile against the plain one: counts and max bitwise, rows 1, 3
        and 4 within rtol.  ``counts``: the exact float64 counts behind
        ``want[0]``, where a bin passes 2**24 and float32 rounds it."""
        total = float((got[0] if counts is None else counts).sum())
        check(torch.equal(got[0], want[0]), f"{what}: histogram counts differ")
        check(torch.equal(got[2], want[2]), f"{what}: max differs")
        check(total == n, f"{what}: counts sum {total} != {n}")
        absx = torch.abs(x2.reshape(-1)[:n])
        for row, scale in ((1, torch.abs(want[1])), (3, absx.sum()), (4, want[4])):
            d = torch.abs(got[row] - want[row])
            check(bool((d <= STATS_RTOL * scale).all()),
                  f"{what}: row {row} beyond rtol {STATS_RTOL} (max diff {float(d.max())})")
        return float(torch.abs(got - want).max())

    max_err = {kernels.kernel_name(k): 0.0 for k in kernels.KERNELS}
    from repro_torch.core.quantizers import pack_codes, packed_size

    DECODES = {kdec.codebook_decode_reduce_3d: (ref.codebook_decode_reduce, False, True),
               kdec.uniform_decode_reduce_3d: (ref.uniform_decode_reduce, True, True),
               kdec.codebook_decode_rows_3d: (ref.codebook_decode_rows, False, False),
               kdec.uniform_decode_rows_3d: (ref.uniform_decode_rows, True, False)}

    def decode_parity(kernel, words3, meta, n: int, bits: int, at: str) -> None:
        """A decode kernel on the padded words bitwise its plain version and
        the serial body it replaced, and the same bits from the stacked wire
        as the codec leaves it: strided rows (the padded words' own rows
        sliced to packed_size) and a copy with every row contiguous."""
        plain, uniform, reduce = DECODES[kernel]
        name = kernels.kernel_name(kernel)
        got = kernel(words3, meta, bits)
        agree(name, got, plain(words3, meta, bits), at)
        agree(name, got, kdec.serial_3d(uniform, reduce, words3, meta, bits),
              f"against the serial body, {at}")
        strided = words3.reshape(words3.shape[0], -1)[:, :packed_size(n, bits)]
        for wire in (strided, strided.contiguous()):
            agree(name, kdec.from_wire(kernel, wire, meta, n, bits), got,
                  f"from the wire (row stride {wire.stride(0)}), {at}")
    ENCODES = {kenc.codebook_encode_pack_resid_2d: (ref.codebook_encode_pack_residual, False, True),
               kenc.uniform_encode_pack_resid_2d: (ref.uniform_encode_pack_residual, True, True),
               kenc.codebook_encode_pack_2d: (ref.codebook_encode_pack, False, False),
               kenc.uniform_encode_pack_2d: (ref.uniform_encode_pack, True, False)}

    def encode_parity(kernel, c2, rand, meta, n: int, bits: int, at: str):
        """An encode kernel on the padded tile bitwise its plain version and
        the serial body it replaced, and the same bits from the flat entry
        on the bucket as it lies: contiguous, 4 bytes off a 16-byte
        boundary (as a row of the stacked EF-off bucket can lie), and
        shorter than the code length with the rest read as zero (as
        encode_chunks hands it over).  Returns the kernel's output."""
        plain, uniform, resid = ENCODES[kernel]
        name = kernels.kernel_name(kernel)
        got = kernel(c2, rand, meta, n, bits)
        outs = got if resid else (got,)
        want = plain(c2, rand, meta, n, bits)
        serial = kenc.serial_2d(uniform, resid, c2, rand, meta, n, bits)
        for what, a, b, c in zip(("words", "residual"), outs, want if resid else (want,),
                                 serial if resid else (serial,)):
            agree(name, a, b, f"{what} at {at}")
            agree(name, a, c, f"{what} against the serial body, at {at}")
        m = max(1, n - 37)
        short = c2.clone()
        short.reshape(-1)[m:] = 0.0
        short_outs = kernel(short, rand, meta, n, bits)
        short_outs = short_outs if resid else (short_outs,)
        buf = torch.empty(n + 1, device=dev)
        buf[1:] = c2.reshape(-1)[:n]
        for flat, ref_outs in ((c2.reshape(-1)[:n], outs), (buf[1:], outs),
                               (short.reshape(-1)[:m], short_outs)):
            k = flat.numel()
            f = kenc.encode_flat(kernel, flat, n, rand, meta, bits)
            f = f if resid else (f,)
            where = f"flat entry, {k} of {n} elements at byte offset {flat.data_ptr() % 16}, {at}"
            agree(name, f[0], ref_outs[0], f"words from the {where}")
            if resid:
                agree(name, f[1], ref_outs[1].reshape(-1)[:k], f"residual from the {where}")
        return got

    # (elements, bits, peers): the convention shapes, then the main path's
    # own at 3 bits.  two_phase (8,) encodes smallnet's bucket padded for 8
    # chunks and decodes, re-encodes and row-decodes its chunks over 8
    # peers; a (2, 4) pod does the same padded for 4 chunks over 4 peers;
    # the cross-pod stage encodes and decodes the bucket over 2 peers.
    from repro_torch.core.codecs import get_codec
    chunk = get_codec("tnqsgd").chunk_elems
    cfg3 = CompressorConfig(method="tnqsgd", bits=3)
    cases = [(SLICE_N, 3, PEERS), (FULL_N, 3, PEERS), (FULL_N, 8, PEERS), (RAGGED_N, 1, PEERS),
             (RAGGED_N, 8, PEERS)]
    for pod in (PEERS, PEERS // 2):
        m = chunk(cfg3, SLICE_N, pod)
        cases += [(pod * m, 3, pod), (m, 3, pod)]
    cases.append((SLICE_N, 3, 2))
    full_inputs = None
    for n, bits, peers in cases:
        g = [to2d(heavy(n, 1e-3)) for _ in range(peers)]
        e = [to2d(heavy(n, 1e-4)) for _ in range(peers)]
        words, levels, uwords, alphas, cwords = [], [], [], [], []
        for p in range(peers):
            s10 = kstats.bucket_stats_2d(g[p], n)
            c, s1 = kenc.ef_correct_stats_2d(g[p], e[p], n)
            # a second launch on the same input must agree bit for bit
            check(torch.equal(kstats.bucket_stats_2d(g[p], n), s10),
                  f"K10 not deterministic at n={n}")
            c2, s1b = kenc.ef_correct_stats_2d(g[p], e[p], n)
            check(torch.equal(c2, c) and torch.equal(s1b, s1), f"K1 not deterministic at n={n}")
            err = stats_err(s10, ref.bucket_stats(g[p], n), g[p], n, f"K10 n={n}")
            note_err("stats.bucket_stats_2d", err)
            c_ref, s1_ref = ref.ef_correct_stats(g[p], e[p], n)
            check(torch.equal(c, c_ref), f"K1 corrected bucket differs at n={n}")
            err = stats_err(s1, s1_ref, c, n, f"K1 n={n}")
            note_err("encode_fused.ef_correct_stats_2d", err)
            lv = plan_levels(c, n, bits)
            rand = prng.uniform(prng.key(1000 * p + bits), c.shape, device=dev)
            at = f"n={n} bits={bits}"
            w, _ = encode_parity(kenc.codebook_encode_pack_resid_2d, c, rand, lv, n, bits, at)
            words.append(w)
            levels.append(lv)
            wc = encode_parity(kenc.codebook_encode_pack_2d, c, rand, lv, n, bits, at)
            check(torch.equal(wc, w), f"K6 words differ from K2's at {at}")
            cwords.append(wc)
            alpha = plan(c, n, bits, "tqsgd").alpha.reshape(1).contiguous()
            uw, _ = encode_parity(kenc.uniform_encode_pack_resid_2d, c, rand, alpha, n, bits, at)
            check(torch.equal(encode_parity(kenc.uniform_encode_pack_2d, c, rand, alpha, n, bits,
                                            at), uw), f"K7 words differ from K3's at {at}")
            uwords.append(uw)
            alphas.append(alpha)
        words3 = torch.stack(words).contiguous()
        levels2 = torch.stack(levels).contiguous()
        uwords3, alphas1 = torch.stack(uwords).contiguous(), torch.cat(alphas)
        cwords3 = torch.stack(cwords).contiguous()
        for kernel, w3, meta, what in ((kdec.codebook_decode_reduce_3d, words3, levels2, "mean"),
                                       (kdec.uniform_decode_reduce_3d, uwords3, alphas1, "mean"),
                                       (kdec.uniform_decode_rows_3d, uwords3, alphas1, "rows"),
                                       (kdec.codebook_decode_rows_3d, cwords3, levels2, "rows")):
            decode_parity(kernel, w3, meta, n, bits, f"{what} at {at} peers={peers}")
        torch.cuda.synchronize()
        print(f"[parity] n={n} bits={bits} peers={peers}: K1, K10 counts/max exact, sums within "
              f"rtol {STATS_RTOL}, bitwise deterministic; K2, K3, K6, K7 words and residuals, "
              f"K4, K5 means and K8, K9 rows bitwise, and bitwise the serial bodies, the flat "
              f"encode entry (aligned, 4 bytes off, shorter than n) and the strided wire entry")
        if (n, bits, peers) == (FULL_N, 3, PEERS):
            full_inputs = dict(g=g, e=e, c=[to2d(heavy(n, 1e-3)) for _ in range(PEERS)],
                               levels=levels, words3=words3, levels2=levels2,
                               alphas=alphas, uwords3=uwords3, alphas1=alphas1)

    # the decode body at every width 1, 2, 3, 4 and 8, over 1, 3, 8, 9 and
    # 16 peers (one batch of 8 loads, a partial one, two), at a partial last
    # row and at RAGGED_N, on random wire words (every bit pattern is a
    # valid wire; the words past packed_size read as zero)
    for bits in (1, 2, 3, 4, 8):
        for peers in (1, 3, 8, 9, 16):
            for n in (1000, RAGGED_N):
                w = packed_size(n, bits)
                wire = torch.randint(-2**31, 2**31, (peers, w), generator=gen, device=dev,
                                     dtype=torch.int64).to(torch.int32)
                words3 = ops._to_words3(wire, n, bits)
                levels2 = torch.sort(torch.randn(peers, 2**bits, generator=gen, device=dev),
                                     1).values
                alphas1 = 0.05 + torch.rand(peers, generator=gen, device=dev)
                for kernel, (_, uniform, _) in DECODES.items():
                    decode_parity(kernel, words3, alphas1 if uniform else levels2, n, bits,
                                  f"random wire n={n} bits={bits} peers={peers}")
    torch.cuda.synchronize()
    print("[parity] K4, K5, K8, K9 on random wires, bits 1, 2, 3, 4, 8 x peers 1, 3, 8, 9, 16 x "
          f"n 1000, {RAGGED_N}: bitwise the plain versions and the serial body, from the padded "
          "words and from the contiguous and the strided wire")

    # the encode body at every width 1, 2, 3, 4 and 8 (the codebook in
    # registers up to 4, in shared memory above), at a partial last row and
    # at RAGGED_N, on random sorted codebooks and alphas
    for bits in (1, 2, 3, 4, 8):
        for n in (1000, RAGGED_N):
            c2 = to2d(heavy(n, 1e-3))
            rand = prng.uniform(prng.key(77 * n + bits), c2.shape, device=dev)
            lv = torch.sort(1e-3 * torch.randn(2**bits, generator=gen, device=dev)).values
            alpha = 1e-3 + 2e-3 * torch.rand(1, generator=gen, device=dev)
            for kernel, (_, uniform, _) in ENCODES.items():
                encode_parity(kernel, c2, rand, alpha if uniform else lv, n, bits,
                              f"random codebook n={n} bits={bits}")
    torch.cuda.synchronize()
    print("[parity] K2, K3, K6, K7 on random codebooks and alphas, bits 1, 2, 3, 4, 8 x n 1000, "
          f"{RAGGED_N}: bitwise the plain versions and the serial body, and from the flat entry")

    # the per-leaf codec's shapes (bucket_mb=0): smallnet's leaves split
    # into per-peer rows of 2 (the 10- and 16-element leaves over 8 peers),
    # 4 (the 32-element leaf; a (2, 4) pod's 16-element leaf), 18 (the
    # 144-element leaf) and 576 (the 4,608-element leaf), over 1, 2, 4 and
    # 8 peers, each row planned by the sort-based fit: K6/K7 on the padded
    # tile and from the flat entry, K4, K5, K8, K9 on the padded words and
    # from the wire, bitwise the plain versions; and through kernels.ops as
    # the per-leaf sync calls them (core.codecs.encode_pack, decode_reduce,
    # decode_rows), card against CPU on the same rows and keys
    from repro_torch.core import codecs as kcodecs
    from repro_torch.core.compressors import plan as sort_plan

    leaf_cfgs = {m: CompressorConfig(method=m, bits=3) for m in ("tnqsgd", "tqsgd")}
    for n in (2, 4, 18, 576):
        for peers in (1, 2, 4, 8):
            rows_g = [heavy(n, 1e-3) for _ in range(peers)]
            for method, lcfg in leaf_cfgs.items():
                uniform = method == "tqsgd"
                metas = [sort_plan(lcfg, x) for x in rows_g]
                keys = [prng.fold_in(prng.key(31 * n + peers), p) for p in range(peers)]
                enc = kenc.uniform_encode_pack_2d if uniform else kenc.codebook_encode_pack_2d
                at = f"per-leaf row n={n} peers={peers} {method}"
                words = []
                for x, m_, k in zip(rows_g, metas, keys):
                    meta = m_.alpha.reshape(1).contiguous() if uniform else m_.levels
                    x2 = to2d(x)
                    words.append(encode_parity(enc, x2, prng.uniform(k, x2.shape, device=dev),
                                               meta, n, 3, at))
                words3 = torch.stack(words).contiguous()
                meta2 = (torch.stack([m_.alpha for m_ in metas]) if uniform
                         else torch.stack([m_.levels for m_ in metas]).contiguous())
                for kernel in ((kdec.uniform_decode_reduce_3d, kdec.uniform_decode_rows_3d)
                               if uniform else (kdec.codebook_decode_reduce_3d,
                                                kdec.codebook_decode_rows_3d)):
                    decode_parity(kernel, words3, meta2, n, 3, at)
                wire = torch.stack([kcodecs.encode_pack(lcfg, x, m_, k)
                                    for x, m_, k in zip(rows_g, metas, keys)])
                wire_cpu = torch.stack([kcodecs.encode_pack(
                    lcfg, x.cpu(), m_._replace(levels=m_.levels.cpu(), alpha=m_.alpha.cpu()), k)
                    for x, m_, k in zip(rows_g, metas, keys)])
                check(torch.equal(wire.cpu(), wire_cpu), f"encode_pack card vs CPU at {at}")
                lv = torch.stack([m_.levels for m_ in metas])
                for op in (kcodecs.decode_reduce, kcodecs.decode_rows):
                    check(torch.equal(op(lcfg, wire, lv, n).cpu(),
                                      op(lcfg, wire_cpu, lv.cpu(), n)),
                          f"{op.__name__} card vs CPU at {at}")
    torch.cuda.synchronize()
    print("[parity] per-leaf rows of 2, 4, 18, 576 elements over 1, 2, 4, 8 peers (tnqsgd, "
          "tqsgd, sort-based plans): K6, K7 and K4, K5, K8, K9 bitwise the plain versions, the "
          "serial bodies, the flat encode entry and the wire entry; core.codecs.encode_pack, "
          "decode_reduce and decode_rows card against CPU bitwise")

    # K1/K10 on inputs that fill every bin (1% exact zeros, 1% subnormals,
    # under- and overflow, the rest at least 0.1% off each bin edge), all
    # zeros and all overflow (bin 127), at smallnet's bucket and a 4 MB one:
    # through the (rows, 128) wrappers and the flat path the sync takes (no
    # padding), the EF row also 4 bytes off a 16-byte boundary, as a row of
    # the sync's (n_clients, s) state can lie; every launch twice
    def stats_input(kind: str, n: int, seed: int) -> torch.Tensor:
        cpu = torch.Generator().manual_seed(seed)
        sign = torch.where(torch.rand(n, generator=cpu) < 0.5, -1.0, 1.0).double()
        u = 0.01 + 0.98 * torch.rand(n, generator=cpu, dtype=torch.float64)
        if kind == "zeros":
            x = torch.zeros(n, dtype=torch.float64)
        elif kind == "overflow":
            x = sign * torch.exp2(8 + 12 * u)
        else:
            b = torch.randint(-8, 140, (n,), generator=cpu).double()
            x = sign * torch.exp2(-24 + 0.25 * (b + u))
            r = torch.rand(n, generator=cpu)
            x[r < 0.01] = 0.0
            sub = (r >= 0.01) & (r < 0.02)
            x[sub] = sign[sub] * 2.0**-130 * u[sub]
        return x.to(torch.float32).to(dev)

    def exact_err(got, x, n, what, enforce=True) -> float:
        """Rows 1, 3 and 4 against the float64 sums of the same float32
        terms (ln|x| binned as the kernel bins it, x, x²), rtol STATS_RTOL
        where ``enforce``; returns the largest relative error."""
        x = x.reshape(-1)[:n]
        ln = torch.log(torch.clamp_min(torch.abs(x), 1e-30))
        ln2 = torch.tensor(math.log(2.0), dtype=torch.float32, device=dev)
        b = torch.clamp(torch.floor((ln / ln2 + 24.0) / 0.25), 0, 127).long()
        xd = x.double()
        rel = []
        for row, want, scale in (
                (1, torch.zeros(128, dtype=torch.float64, device=dev).index_add_(0, b, ln.double()),
                 None),
                (3, xd.sum(), xd.abs().sum()), (4, (xd * xd).sum(), (xd * xd).sum())):
            scale = torch.abs(want) if scale is None else scale
            d = torch.abs(got[row].double() - want)
            check(not enforce or bool((d <= STATS_RTOL * scale).all()),
                  f"{what}: row {row} beyond rtol {STATS_RTOL} of the float64 sum "
                  f"(max diff {float(d.max())})")
            rel.append(float((d / torch.clamp_min(scale, 1e-300)).max()))
        return max(rel)

    exact_rel, plain_rel = {}, {}
    for n in (SLICE_N, FULL_N):
        for kind in ("every_bin", "zeros", "overflow"):
            at = f"{kind} n={n}"
            g = stats_input(kind, n, n)
            e = stats_input(kind, n, n + 1) * 2.0**-10
            g2, e2 = to2d(g), to2d(e)
            s10 = kstats.bucket_stats_2d(g2, n)
            check(torch.equal(kstats.bucket_stats_2d(g2, n), s10), f"K10 not deterministic, {at}")
            check(torch.equal(kstats.bucket_stats_flat(g, n), s10), f"K10 flat path differs, {at}")
            c2, s1 = kenc.ef_correct_stats_2d(g2, e2, n)
            c2b, s1b = kenc.ef_correct_stats_2d(g2, e2, n)
            check(torch.equal(c2b, c2) and torch.equal(s1b, s1), f"K1 not deterministic, {at}")
            c_ref, s1_ref = ref.ef_correct_stats(g2, e2, n)
            check(torch.equal(c2, c_ref), f"K1 corrected bucket differs, {at}")
            # counts and max bitwise the plain version's; the sums within
            # rtol of the plain version's (which sums each tile in float64,
            # rounded once) and of the float64 sums
            for name, tile, want, x2 in (
                    ("stats.bucket_stats_2d", s10, ref.bucket_stats(g2, n), g2),
                    ("encode_fused.ef_correct_stats_2d", s1, s1_ref, c2)):
                what = f"{name} {at}"
                check(torch.equal(tile[0], want[0]) and float(tile[0].sum()) == n,
                      f"{what}: histogram counts differ")
                check(torch.equal(tile[2], want[2]), f"{what}: max differs")
                err = stats_err(tile, want, x2, n, what)
                if kind == "every_bin":  # max_abs_err on the inputs of earlier runs
                    note_err(name, err)
                exact_rel[what] = exact_err(tile, x2, n, what)
                plain_rel[what] = exact_err(want, x2, n, what, enforce=False)
            buf = torch.zeros(n + 1, device=dev)
            buf[1:] = e
            for ef in (e, buf[1:], buf[1:]):
                c, sf = kenc.ef_correct_stats_flat(g, ef, n)
                check(torch.equal(c, c2.reshape(-1)[:n]) and torch.equal(sf, s1),
                      f"K1 flat path differs, {at}, EF at byte offset {ef.data_ptr() % 16}")
        torch.cuda.synchronize()
        print(f"[parity] K1, K10 every-bin, zeros, overflow at n={n}: counts/max exact, sums "
              f"within rtol {STATS_RTOL} of the plain version's and of the float64 sums, "
              f"bitwise deterministic and equal through the flat path, the EF row "
              f"16-byte aligned or 4 bytes off")
    print(f"[parity] K1, K10 largest relative error against the float64 sums: "
          f"{json.dumps(exact_rel)}; the plain version's: {json.dumps(plain_rel)}")

    # K11: the P factor of smallnet's bucket (matrix_shape(206,922) = (809,
    # 256)), of the mixed plan's 200,704-element bucket ((784, 256)) and of
    # a 4 MB bucket ((1024, 1024)), at rank 4, the rank cap 64 (beyond the
    # register path: the global-memory path), rank 1, tests/test_lowrank.py's
    # (1000, 3), and the smallest shapes.  Where the factor fits in
    # registers the global-memory path must give the same bits: both reduce
    # in one order.
    for rows, r in ((809, 4), (784, 4), (1024, 4), (1024, 64), (1000, 3), (809, 1), (1, 1),
                    (7, 3)):
        p = torch.randn(rows, r, generator=gen, device=dev)
        out = korth.orthogonalize_2d(p)
        check(torch.equal(korth.orthogonalize_2d(p), out), f"K11 not deterministic at {rows}x{r}")
        fits = korth.on_chip(p)
        check(fits == ((rows, r) != (1024, 64)), f"K11 at {rows}x{r}: register path {fits}")
        if fits:
            check(torch.equal(korth._launch(p, False), out),
                  f"K11 register and global-memory paths differ at {rows}x{r}")
        want = ref.orthogonalize(p)
        d = torch.abs(out - want)
        check(bool((d <= GS_ATOL + GS_RTOL * torch.abs(want)).all()),
              f"K11 beyond rtol {GS_RTOL} / atol {GS_ATOL} at {rows}x{r} (max {float(d.max())})")
        note_err("orthogonalize.orthogonalize_2d", float(d.max()))
        print(f"[parity] K11 {rows}x{r} ({'registers' if fits else 'global memory'}): within rtol "
              f"{GS_RTOL} / atol {GS_ATOL}, max abs err {float(d.max()):.3e}, bitwise "
              f"deterministic{', bitwise the global-memory path' if fits else ''}")
    # a rank-deficient factor: its surplus columns are normalized rounding
    # noise, so it is held by P̂ᵀP̂ = I and the reconstruction P̂P̂ᵀp = p
    p = torch.randn(809, 4, generator=gen, device=dev)
    p[:, 2] = 0.5 * p[:, 0] + 2.0 * p[:, 1]
    p[:, 3] = p[:, 1]
    scale = float(p.abs().max())
    for label, q in (("K11", ops.orthogonalize(p)), ("plain", ref.orthogonalize(p))):
        gram = float(torch.abs(q.T @ q - torch.eye(4, device=dev)).max())
        recon = float(torch.abs(q @ (q.T @ p) - p).max())
        check(gram <= 1e-5 and recon <= 1e-5 * scale,
              f"{label} rank-deficient 809x4: |P̂ᵀP̂ - I| {gram}, |P̂P̂ᵀp - p| {recon}")
        print(f"[parity] {label} rank-deficient 809x4: |P̂ᵀP̂ - I| {gram:.3e}, "
              f"|P̂P̂ᵀp - p| {recon:.3e} (scale {scale:.3f})")
    z = torch.zeros(64, 4, device=dev)
    z[:, 0] = 1.0
    q = ops.orthogonalize(z)
    check(bool((q[:, 1:] == 0).all()) and bool((q[:, 0] == 0.125).all()),
          "K11 zero columns not exactly zero")
    print("[parity] K11 zero columns stay exactly zero")
    torch.cuda.synchronize()

    # K12-K17: each kernel on the padded (rows, 128) tile against its plain
    # version, and each through its kernels.ops wrapper (flat in, the draw
    # on the padded tile, sliced to n) against the plain version on the
    # same draw; K16/K17's codes against K12/K14's and their words against
    # pack_codes of those.  At every leaf size of smallnet (each a tile
    # shape the per-tensor path gives K12/K14) and a full 4 MB tensor, with
    # α and the levels from the per-tensor plan (compressors.plan) that the
    # path uses.
    from repro_torch.core import compressors

    Q = {k: f"quantize.{k}" for k in ("uniform_encode_2d", "uniform_decode_2d",
                                      "codebook_encode_2d", "codebook_decode_2d",
                                      "uniform_encode_pack_2d", "codebook_encode_pack_2d")}

    def pack_parity(g, g2, key, rand, alpha, lv, uc, cc, n: int, bits: int, at: str) -> None:
        """K16 and K17 on the padded tile bitwise their plain versions,
        their codes K12's (uc) and K14's (cc) zeroed past n and their words
        pack_codes of those codes; the same from the flat entry on g as it
        lies and 4 bytes off a 16-byte boundary, and through kernels.ops on
        the unpadded g (its draw: rand, from key)."""
        buf = torch.empty(n + 1, device=dev)
        buf[1:] = g
        for name, kernel, plain, meta, unpacked, wrap in (
                (Q["uniform_encode_pack_2d"], kq.uniform_encode_pack_2d,
                 ref.uniform_encode_pack_codes, alpha, uc, ops.uniform_encode_packed),
                (Q["codebook_encode_pack_2d"], kq.codebook_encode_pack_2d,
                 ref.codebook_encode_pack_codes, lv, cc, ops.codebook_encode_packed)):
            codes, words = kernel(g2, rand, meta, n, bits)
            want_c, want_w = plain(g2, rand, meta, n, bits)
            agree(name, codes, want_c, f"codes at {at}")
            agree(name, words, want_w, f"words at {at}")
            flat = unpacked.reshape(-1)[:n]
            agree(name, codes.reshape(-1)[:n], flat, f"codes against the unpacked encode's at {at}")
            wire = words.reshape(-1)[:packed_size(n, bits)]
            agree(name, wire, pack_codes(flat, bits),
                  f"words against pack_codes of the unpacked encode's codes at {at}")
            for x in (g, buf[1:]):
                where = f"flat entry at byte offset {x.data_ptr() % 16}, {at}"
                fc, fw = kenc.encode_flat(kernel, x, n, rand, meta, bits)
                agree(name, fc, codes, f"codes from the {where}")
                agree(name, fw, words, f"words from the {where}")
            w8, c8 = wrap(g, meta, bits, key)
            agree(name, c8, flat.to(torch.uint8), f"ops codes at {at}")
            agree(name, w8, wire, f"ops words at {at}")

    for n in sorted({math.prod(s) for s in SMALLNET_SHAPES} | {FULL_N}):
        for bits in (2, 3, 8):
            at = f"n={n} bits={bits}"
            g = heavy(n, 1e-3)
            key = prng.key(7 * n + bits)
            g2, _, rand = ops._draw(g, key)
            alpha = compressors.plan(CompressorConfig(method="tqsgd", bits=bits), g).alpha
            alpha = alpha.reshape(1).contiguous()
            lv = compressors.plan(CompressorConfig(method="tnqsgd", bits=bits), g).levels
            uc = kq.uniform_encode_2d(g2, rand, alpha, bits)
            agree(Q["uniform_encode_2d"], uc, ref.uniform_encode(g2, rand, alpha, bits),
                  f"codes at {at}")
            cc = kq.codebook_encode_2d(g2, rand, lv)
            agree(Q["codebook_encode_2d"], cc, ref.codebook_encode(g2, rand, lv), f"codes at {at}")
            pack_parity(g, g2, key, rand, alpha, lv, uc, cc, n, bits, at)
            agree(Q["uniform_decode_2d"], kq.uniform_decode_2d(uc, alpha, bits),
                  ref.uniform_decode(uc, alpha, bits), f"values at {at}")
            agree(Q["codebook_decode_2d"], kq.codebook_decode_2d(cc, lv),
                  ref.codebook_decode(cc, lv), f"values at {at}")
            # the ops wrappers on the flat tensor
            u8 = ops.uniform_encode(g, alpha, bits, key)
            agree(Q["uniform_encode_2d"], u8, uc.reshape(-1)[:n].to(torch.uint8),
                  f"ops codes at {at}")
            c8 = ops.codebook_encode(g, lv, key)
            agree(Q["codebook_encode_2d"], c8, cc.reshape(-1)[:n].to(torch.uint8),
                  f"ops codes at {at}")
            agree(Q["uniform_decode_2d"], ops.uniform_decode(u8, alpha, bits),
                  ref.uniform_decode(uc, alpha, bits).reshape(-1)[:n], f"ops values at {at}")
            agree(Q["codebook_decode_2d"], ops.codebook_decode(c8, lv),
                  ref.codebook_decode(cc, lv).reshape(-1)[:n], f"ops values at {at}")
        torch.cuda.synchronize()
        print(f"[parity] n={n} bits=2, 3, 8: K12, K14 codes, K16, K17 codes and words, K13, K15 "
              f"values bitwise, on the tile and through kernels.ops; K16/K17 codes equal "
              f"K12/K14's zeroed past n, their words pack_codes of those, also from the flat "
              f"entry (aligned, 4 bytes off)")

    # K16 and K17 at every width 1 to 8 (the codebook in registers up to 4
    # bits, in shared memory above) on random sorted codebooks and alphas:
    # n under one row, off a multiple of 32 and of 128, and a 4 MB tensor
    for bits in range(1, 9):
        for n in (100, 1000, RAGGED_N, FULL_N):
            at = f"random codebook n={n} bits={bits}"
            g = heavy(n, 1e-3)
            key = prng.key(31 * n + bits)
            g2, _, rand = ops._draw(g, key)
            lv = torch.sort(1e-3 * torch.randn(2**bits, generator=gen, device=dev)).values
            alpha = 1e-3 + 2e-3 * torch.rand(1, generator=gen, device=dev)
            uc = kq.uniform_encode_2d(g2, rand, alpha, bits)
            agree(Q["uniform_encode_2d"], uc, ref.uniform_encode(g2, rand, alpha, bits),
                  f"codes at {at}")
            cc = kq.codebook_encode_2d(g2, rand, lv)
            agree(Q["codebook_encode_2d"], cc, ref.codebook_encode(g2, rand, lv), f"codes at {at}")
            pack_parity(g, g2, key, rand, alpha, lv, uc, cc, n, bits, at)
    torch.cuda.synchronize()
    print(f"[parity] K16, K17 on random codebooks and alphas, bits 1-8 x n 100, 1000, {RAGGED_N}, "
          f"{FULL_N}: codes and words bitwise the plain versions, the codes K12/K14's zeroed past "
          f"n, from the flat entry (aligned, 4 bytes off) and through kernels.ops")

    # the segmented K14: one launch over smallnet's eight leaf tiles (as
    # one client's round gives them) at 2, 3 and 8 bits, with mixed widths
    # (a bits_plan), over one tile and over 64, each tile's codes bitwise
    # the plain version's, and the same through kernels.ops on flat leaves
    leaf_sizes = [math.prod(sh) for sh in SMALLNET_SHAPES]
    seg_cases = {f"smallnet bits={b}": (leaf_sizes, [b] * 8) for b in (2, 3, 8)}
    seg_cases["smallnet mixed bits"] = (leaf_sizes, [2, 3, 8, 3, 2, 3, 8, 2])
    seg_cases["1 tile"] = ([200_704], [3])
    seg_cases["64 tiles"] = ([leaf_sizes[i % 8] for i in range(64)], [3, 2, 8, 3] * 16)
    for label, (sizes, widths) in seg_cases.items():
        gs = [heavy(n, 1e-3) for n in sizes]
        keys = [prng.fold_in(prng.key(77), j) for j in range(len(gs))]
        lvs = [compressors.plan(CompressorConfig(method="tnqsgd", bits=b), g).levels
               for g, b in zip(gs, widths)]
        drawn = [ops._draw(g, k) for g, k in zip(gs, keys)]
        g2s, rands = [d[0] for d in drawn], [d[2] for d in drawn]
        codes = kq.codebook_encode_segments(g2s, rands, lvs)
        agree(Q["codebook_encode_2d"], codes, ref.codebook_encode_segments(g2s, rands, lvs),
              f"segmented codes, {label}")
        row = 0
        for i, (g2, rand, lv) in enumerate(zip(g2s, rands, lvs)):
            agree(Q["codebook_encode_2d"], codes[row:row + g2.shape[0]],
                  ref.codebook_encode(g2, rand, lv), f"segmented codes of tile {i}, {label}")
            row += g2.shape[0]
        for i, c8 in enumerate(ops.codebook_encode_leaves(gs, lvs, keys)):
            agree(Q["codebook_encode_2d"], c8, ops.codebook_encode(gs[i], lvs[i], keys[i]),
                  f"ops.codebook_encode_leaves codes of leaf {i}, {label}")
        # the segmented K12 on the same tiles, each with its plan's α
        alphas = [compressors.plan(CompressorConfig(method="tqsgd", bits=b), g).alpha
                  .reshape(1).contiguous() for g, b in zip(gs, widths)]
        codes = kq.uniform_encode_segments(g2s, rands, alphas, widths)
        agree(Q["uniform_encode_2d"], codes,
              ref.uniform_encode_segments(g2s, rands, alphas, widths),
              f"segmented codes, {label}")
        row = 0
        for i, (g2, rand, a, b) in enumerate(zip(g2s, rands, alphas, widths)):
            agree(Q["uniform_encode_2d"], codes[row:row + g2.shape[0]],
                  kq.uniform_encode_2d(g2, rand, a, b), f"segmented codes of tile {i}, {label}")
            row += g2.shape[0]
        for i, c8 in enumerate(ops.uniform_encode_leaves(gs, alphas, widths, keys)):
            agree(Q["uniform_encode_2d"], c8, ops.uniform_encode(gs[i], alphas[i], widths[i],
                                                                 keys[i]),
                  f"ops.uniform_encode_leaves codes of leaf {i}, {label}")
        torch.cuda.synchronize()
        print(f"[parity] segmented K14 and K12, {label} ({len(sizes)} tiles, "
              f"{sum(g2.shape[0] for g2 in g2s)} rows), each in one launch: bitwise the plain "
              f"version per tile and the one-tile launches, also through kernels.ops")

    # -- 4. main path -----------------------------------------------------
    from repro_torch.elastic import ElasticConfig, live_mask, partition, solo_survivor
    from repro_torch.train import train_synced

    # 30 steps for a run held to a window; a run held to convergence alone
    # (window None) takes 15, enough to fall below 1.49 (about 0.3 there)
    steps, short = 30, 15
    # label -> (train_synced keywords, window (final loss, tolerance) or None
    # for convergence alone, launches per synced step).  Per step, for one
    # bucket and 8 clients: the peers' statistics (K1 with EF, else K10) and
    # full-bucket encodes (K2|K3, uniform methods in the second slot); the
    # faithful decode K4|K5; two_phase decodes 8 chunks (K4|K5), plans them
    # (K10), re-encodes them (K6|K7) and decodes the rows once (K8|K9);
    # hierarchical (2, 4) runs that in two pods of 4 (K8|K9 twice), then
    # plans (K10), encodes (K2|K3) and decodes (K4|K5) the 2 pod means.
    K1, K10, K11 = ("encode_fused.ef_correct_stats_2d", "stats.bucket_stats_2d",
                    "orthogonalize.orthogonalize_2d")

    def expected_launches(stats, enc, dec, enc2=0, rows=0, uniform=False):
        kind = "uniform" if uniform else "codebook"
        counts = dict.fromkeys(launches, 0)
        counts.update({f"encode_fused.{kind}_encode_pack_resid_2d": enc,
                       f"decode.{kind}_decode_reduce_3d": dec,
                       f"encode_fused.{kind}_encode_pack_2d": enc2,
                       f"decode.{kind}_decode_rows_3d": rows})
        counts.update(stats)
        return counts

    launches = {kernels.kernel_name(k): 0 for k in kernels.KERNELS}
    ef_off, ef_on = {K10: 8}, {K1: 8}
    DROPOUT = ElasticConfig(rate=0.2, seed=0x17E)
    golden = {
        "faithful_ef_off": (dict(sync="faithful"), (0.0162, 0.05),
                            expected_launches(ef_off, 8, 1)),
        "faithful_ef_on": (dict(sync="faithful", error_feedback=True), None,
                           expected_launches(ef_on, 8, 1)),
        # 20% scheduled dropout, EF on: the JAX package's elastic golden
        # window; every peer still encodes (a dead peer's wire is zeroed)
        "faithful_ef_dropout20": (dict(sync="faithful", error_feedback=True, elastic=DROPOUT),
                                  (0.0938, 0.07), expected_launches(ef_on, 8, 1)),
        "two_phase_ef_off": (dict(sync="two_phase"), (0.0037, 0.05),
                             expected_launches({K10: 16}, 8, 8, 8, 1)),
        "two_phase_ef_on": (dict(sync="two_phase", error_feedback=True), None,
                            expected_launches({K1: 8, K10: 8}, 8, 8, 8, 1)),
        "hierarchical_ef_off": (dict(sync="hierarchical", dp_sizes=(2, 4)), (0.0207, 0.05),
                                expected_launches({K10: 18}, 10, 9, 8, 2)),
        "faithful_tqsgd": (dict(sync="faithful", method="tqsgd"), (0.0179, 0.05),
                           expected_launches(ef_off, 8, 1, uniform=True)),
        "faithful_qsgd": (dict(sync="faithful", method="qsgd"), (0.0085, 0.05),
                          expected_launches(ef_off, 8, 1, uniform=True)),
        "two_phase_tqsgd": (dict(sync="two_phase", method="tqsgd"), None,
                            expected_launches({K10: 16}, 8, 8, 8, 1, uniform=True)),
        # PowerSGD, rank 4, EF on: per step K1 and K11 for each of the 8
        # peers; no plan, no quantizer kernel.  two_phase decodes every
        # peer's full wire in phase 1 (not chunkable); hierarchical adds
        # the cold cross-pod stage: K10 for the 2 pod means' (unused)
        # statistics and K11 for each.  Windows: faithful the JAX
        # package's; the other two JAX's own runs under the original
        # threefry layout (CPU), with its tolerance.
        "faithful_powersgd": (dict(sync="faithful", method="powersgd", error_feedback=True),
                              (0.0110, 0.05), expected_launches({K1: 8, K11: 8}, 0, 0)),
        "two_phase_powersgd": (dict(sync="two_phase", method="powersgd", error_feedback=True),
                               (0.011024, 0.05), expected_launches({K1: 8, K11: 8}, 0, 0)),
        "hierarchical_powersgd": (dict(sync="hierarchical", dp_sizes=(2, 4), method="powersgd",
                                       error_feedback=True), (0.136193, 0.05),
                                  expected_launches({K1: 8, K11: 10, K10: 2}, 0, 0)),
        # the uncompressed mean: the JAX package's dsgd window, no kernel
        "dsgd": (dict(sync="dsgd"), (0.0000, 0.02), expected_launches({}, 0, 0)),
        # the per-leaf codec (bucket_mb=0): each of smallnet's 8 leaves on
        # its own, every tensor planned by the sort-based fit (no statistics
        # kernel).  Per step: faithful encodes 8 peers' leaves (K6|K7 64)
        # and decodes each leaf (K4|K5 8); two_phase (8,) encodes 8 chunk
        # rows a peer and leaf (64) and the 8 mean chunks (8), decodes 8
        # chunks (K4 8) and the rows once (K8 1), each leaf: K6 576, K4 64,
        # K8 8; hierarchical (2, 4) does that in two pods of 4 (K6 2·20, K4
        # 2·4, K8 2) and then faithful over the 2 pod means (K6 2, K4 1),
        # each leaf: K6 336, K4 72, K8 16.  The faithful tnqsgd run is held
        # to the JAX package's per-leaf run (the golden harness with
        # bucket_mb=0, the original threefry layout, 30 steps on the CPU:
        # final loss 0.0004110558), faithful tqsgd to convergence.  The
        # staged modes plan 576 and 336 tensors a step (4.7 and 3.0 s a
        # step on the card), so they run 3 steps, held to the JAX package's
        # loss at step 3 on the CPU (the same harness, its per-leaf sync
        # run eagerly with the plans and encodes jitted: 5.563355,
        # 5.327789; a sync that did nothing would leave about 6.49).  Each
        # mode's sync is also held bit for bit to the CPU's, one step with
        # the card's plans replayed (after the adaptive step below).
        "per_leaf_faithful": (dict(sync="faithful", bucket_mb=0), (0.0004110558, 0.05),
                              expected_launches({}, 0, 8, 64)),
        "per_leaf_faithful_tqsgd": (dict(sync="faithful", method="tqsgd", bucket_mb=0), None,
                                    expected_launches({}, 0, 8, 64, uniform=True)),
        "per_leaf_two_phase": (dict(sync="two_phase", bucket_mb=0), (5.563355, 0.05),
                               expected_launches({}, 0, 64, 576, 8), 3),
        "per_leaf_hierarchical": (dict(sync="hierarchical", dp_sizes=(2, 4), bucket_mb=0),
                                  (5.327789, 0.05), expected_launches({}, 0, 72, 336, 16), 3),
    }
    runs = {}
    for label, (kw, window, counts_per_step, *depth) in golden.items():
        # the EF-on runs twice: the loss history must repeat bit for bit
        n_steps = depth[0] if depth else steps if window is not None else short
        for again in ((False, True) if kw.get("error_feedback") else (False,)):
            kernels.reset_launch_counts()
            t0 = time.time()
            hist = train_synced(bits=3, steps=n_steps, n_clients=PEERS, batch=32, device="cuda",
                                **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = kernels.launch_counts()
            name = label + ("_again" if again else "")
            print(f"[golden] {name}: first {hist[0]:.6f} last {hist[-1]:.6f} "
                  f"({len(hist)} steps, {wall:.2f} s) launches {json.dumps(counts)}")
            print(f"[golden] {name} losses {json.dumps(hist)}")
            check(all(math.isfinite(x) for x in hist), f"{name}: non-finite loss {hist}")
            want = {k: v * n_steps for k, v in counts_per_step.items()}
            check(counts == want, f"{name}: launches {counts}, expected {want}")
            if again:
                check(hist == runs[label]["hist"],
                      f"{label}: loss history differs between two runs of the same seeds")
                print(f"[golden] {label} repeats bit for bit")
                continue
            for k, v in counts.items():
                launches[k] += v
            runs[label] = dict(hist=hist, counts=counts, wall=wall)
            check(abs(hist[0] - 6.4895) <= 1e-3, f"{label}: first-step loss {hist[0]}")
            if not depth:
                check(hist[-1] < hist[0] - 5.0, f"{label} did not converge: {hist}")
            if window is not None:
                check(abs(hist[-1] - window[0]) <= window[1],
                      f"{label}: final loss {hist[-1]} outside {window[0]} ± {window[1]}")

    # the dropout run's schedule: live peers per step, the JAX package's
    live_counts = [int(live_mask(DROPOUT, i, PEERS, dev).sum()) for i in range(steps)]
    print(f"[golden] faithful_ef_dropout20 live peers per step {json.dumps(live_counts)}, "
          "launches per step " + json.dumps({k: v // steps for k, v in
                                               runs["faithful_ef_dropout20"]["counts"].items()
                                               if v}))
    check(live_counts == DROPOUT_LIVE, f"dropout schedule {live_counts}, expected {DROPOUT_LIVE}")

    # the paper's per-tensor §V loop (train_clients): 8 clients, batch 32,
    # 30 rounds, every leaf planned by the sort-based fit and encoded with
    # use_pallas, all of a client's 8 leaves in one segmented launch of K14
    # (codebook methods) or K12 (tqsgd), 8 a round, and no other kernel.  Each run
    # twice: the loss history and accuracy must repeat bit for bit.
    # Final losses: the JAX package's benchmarks.common.train_clients with
    # CompressorConfig bound to use_pallas=True under the original threefry
    # layout, 30 rounds on the CPU (JAX_PER_TENSOR).
    from repro_torch.train import train_clients

    rounds = 30
    for label, (kw, (want_loss, want_acc), kernel, per_round) in JAX_PER_TENSOR.items():
        results = []
        for _ in range(2):
            kernels.reset_launch_counts()
            t0 = time.time()
            acc, hist = train_clients(bits=3, rounds=rounds, use_pallas=True, device="cuda", **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = kernels.launch_counts()
            results.append((acc, hist))
            print(f"[golden] {label}: first {hist[0]:.6f} last {hist[-1]:.6f} accuracy {acc:.6f} "
                  f"({rounds} rounds, {wall:.2f} s) launches {json.dumps(counts)}")
            print(f"[golden] {label} losses {json.dumps(hist)}")
            check(all(math.isfinite(x) for x in hist), f"{label}: non-finite loss {hist}")
            want = dict.fromkeys(launches, 0)
            want[kernel] = per_round * rounds
            check(counts == want, f"{label}: launches {counts}, expected {want}")
        check(results[1] == results[0], f"{label}: history or accuracy differs between two runs")
        print(f"[golden] {label} repeats bit for bit")
        acc, hist = results[0]
        for k, v in counts.items():
            launches[k] += v
        runs[label] = dict(hist=hist, counts=counts, wall=wall)
        check(abs(hist[0] - 6.4895) <= 1e-3, f"{label}: first-round loss {hist[0]}")
        check(abs(hist[-1] - want_loss) <= 0.05,
              f"{label}: final loss {hist[-1]} outside the JAX run's {want_loss} ± 0.05")
        check(abs(acc - want_acc) <= 0.05, f"{label}: accuracy {acc} vs the JAX run's {want_acc}")
    # K13, K15, K16 and K17 are reached only through kernels.ops (no module
    # of either package's training calls them): phase 3 launches them
    for k, v in launches.items():
        if k in OPS_ONLY:
            check(v == 0, f"kernel {k} launched {v} times on the main path")
        else:
            check(v > 0, f"kernel {k} never launched on the main path")

    # one synced step of a mixed plan, EF on (a random warm-start aux), on
    # the card and then on the CPU with the card's quantizer plans replayed:
    # the quantizer buckets must agree bit for bit (every kernel is bitwise
    # to its plain version given the plan), the powersgd bucket within
    # rtol 1e-5 / atol 1e-5 x its largest magnitude (cuBLAS and the CPU
    # reduce the products in other orders).  At bucket_mb=0.02 (5,242
    # elements) smallnet's leaves form three buckets.
    from repro_torch.core import codecs as kcodecs
    from repro_torch.core.compressors import plan_buckets
    from repro_torch.core.quantizers import QuantMeta
    from repro_torch.dist import reference as kreference
    from repro_torch.dist import sharded_codec as ksharded
    from repro_torch.dist.reference import reference_sync, reference_sync_state
    from repro_torch.dist.train_step import TrainStepConfig

    mixed_ts = TrainStepConfig(sync="faithful", error_feedback=True, bucket_mb=0.02,
                               bits_plan=(3, ("powersgd", 4), 2),
                               compressor=CompressorConfig(method="tnqsgd", bits=3))
    bp = plan_buckets([math.prod(s) for s in SMALLNET_SHAPES], mixed_ts.bucket_elements)
    check(bp.sizes == (4928, 200704, 1290), f"mixed-plan buckets {bp.sizes}")
    mleaves = [heavy(PEERS * math.prod(s), 1e-3).reshape(PEERS, *s) for s in SMALLNET_SHAPES]
    mef = [heavy(PEERS * m, 1e-4).reshape(PEERS, m)
           for m in kcodecs.bucket_state_sizes(mixed_ts.compressor, bp.sizes, mixed_ts.bits_plan)]
    mkey = prng.fold_in(prng.key(0x5EED), 0)
    # every planner the syncs call: the bucketed codec's, and the per-leaf
    # codec's sort-based plan as dist.reference and dist.sharded_codec call it
    planners = [(kcodecs.QuantizerCodec, "plan"), (kreference, "plan"), (ksharded, "plan")]
    originals = [getattr(owner, attr) for owner, attr in planners]

    def card_and_cpu(run):
        """``run("cuda")`` with every plan it makes recorded, then
        ``run("cpu")`` with those plans replayed in order; returns both
        results and the card run's launches."""
        recorded = []

        def recording(orig):
            def planned(*args):
                recorded.append(orig(*args))
                return recorded[-1]
            return planned

        replay = iter(recorded)
        try:
            for (owner, attr), orig in zip(planners, originals):
                setattr(owner, attr, recording(orig))
            kernels.reset_launch_counts()
            card_out = run("cuda")
            torch.cuda.synchronize()
            step_counts = kernels.launch_counts()
            for owner, attr in planners:
                setattr(owner, attr, lambda *args: QuantMeta(*(x.cpu() for x in next(replay))))
            cpu_out = run("cpu")
        finally:
            for (owner, attr), orig in zip(planners, originals):
                setattr(owner, attr, orig)
        check(next(replay, None) is None, "the CPU replay made fewer plans than the card")
        return card_out, cpu_out, step_counts

    def card_and_cpu_step(ts, leaves_, ef_, key_, tstate=None, dp=(PEERS,), live=None):
        """One reference_sync_state step on the card and on the CPU."""
        def run(device):
            return reference_sync_state(
                ts, [x.to(device) for x in leaves_], dp, key_,
                ef=None if ef_ is None else [e.to(device) for e in ef_],
                tstate=None if tstate is None else type(tstate)(*(x.to(device) for x in tstate)),
                live=None if live is None else live.to(device))
        return card_and_cpu(run)

    (mean_card, ef_card, _, _), (mean_cpu, ef_cpu, _, _), counts = card_and_cpu_step(
        mixed_ts, mleaves, mef, mkey)
    want = dict.fromkeys(launches, 0)
    want.update({K1: 3 * PEERS, "encode_fused.codebook_encode_pack_resid_2d": 2 * PEERS,
                 "decode.codebook_decode_reduce_3d": 2, K11: PEERS})
    check(counts == want, f"mixed plan: launches {counts}, expected {want}")
    for b in (0, 2):
        check(torch.equal(ef_card[b].cpu(), ef_cpu[b]), f"mixed plan: bucket {b} EF rows differ")
    for i in (0, 1, 2, 3, 4, 6, 7):
        check(torch.equal(mean_card[i].cpu(), mean_cpu[i]), f"mixed plan: leaf {i} mean differs")
    m1 = bp.sizes[1]
    mixed_err = {}
    for what, got, ref_ in (("mean", mean_card[5], mean_cpu[5]),
                            ("residual", ef_card[1][:, :m1], ef_cpu[1][:, :m1]),
                            ("aux", ef_card[1][:, m1:], ef_cpu[1][:, m1:])):
        d = torch.abs(got.cpu() - ref_)
        scale = float(ref_.abs().max())
        check(bool((d <= 1e-5 * torch.abs(ref_) + 1e-5 * scale).all()),
              f"mixed plan: powersgd {what} beyond tolerance (max {float(d.max())} of {scale})")
        mixed_err[what] = float(d.max()) / scale
    print(f"[mixed] plan (3, ('powersgd', 4), 2) over buckets {bp.sizes}: launches "
          f"{json.dumps(counts)}; quantizer buckets bitwise card vs CPU, powersgd bucket max "
          f"abs err / max magnitude {json.dumps(mixed_err)}")

    def same(card_xs, cpu_xs, what: str) -> None:
        for i, (a, b) in enumerate(zip(card_xs, cpu_xs)):
            check(torch.equal(a.cpu(), b), f"{what} {i} differs between the card and the CPU")

    # one step of the fp16 small-bucket tier, EF on: on the mixed plan's
    # layout with fp16_threshold 5,000 the 4,928- and 1,290-element buckets
    # ship float16 (two values a word, no kernel: a cast) and the
    # 200,704-element one tnqsgd at 3 bits; card and CPU bitwise equal
    fp16_ts = TrainStepConfig(sync="faithful", error_feedback=True, bucket_mb=0.02,
                              fp16_threshold=5000,
                              compressor=CompressorConfig(method="tnqsgd", bits=3))
    fef = [heavy(PEERS * m, 1e-4).reshape(PEERS, m) for m in bp.sizes]
    fp16_plan = kcodecs.size_adaptive_plan(fp16_ts.compressor, None, bp.sizes, 5000)
    check([e[0] if isinstance(e, tuple) else e.method for e in fp16_plan]
          == ["fp16", "tnqsgd", "fp16"], f"fp16 tier plan {fp16_plan}")
    (fmean, fres, _, _), (cmean, cres, _, _), counts = card_and_cpu_step(fp16_ts, mleaves, fef,
                                                                        mkey)
    want = dict.fromkeys(launches, 0)
    want.update({K1: 3 * PEERS, "encode_fused.codebook_encode_pack_resid_2d": PEERS,
                 "decode.codebook_decode_reduce_3d": 1})
    check(counts == want, f"fp16 tier: launches {counts}, expected {want}")
    same(fmean, cmean, "fp16 tier: mean leaf")
    same(fres, cres, "fp16 tier: EF rows of bucket")
    check(all(bool(torch.isfinite(x).all()) for x in fmean), "fp16 tier: non-finite mean")
    print(f"[fp16] buckets {bp.sizes} under fp16_threshold 5000 "
          f"({[e if isinstance(e, tuple) else e.method for e in fp16_plan]}): launches "
          f"{json.dumps(counts)}; means and EF rows bitwise card vs CPU")

    # one adaptive step on the same layout: 3 steps of telemetry folded in
    # by the sync (reference_sync_state(tstate=...), EF off: K10), then the
    # peers' rows aggregated, tails and densities estimated and bits
    # water-filled under the uniform 3-bit plan's budget, on the card and
    # from the same telemetry moved to the CPU: the plans must be equal; one
    # step then runs with the plan, card against CPU bitwise
    from repro_torch.adaptive import controller, telemetry

    ada_ts = TrainStepConfig(sync="faithful", bucket_mb=0.02,
                             adaptive=controller.AdaptiveConfig(),
                             compressor=CompressorConfig(method="tnqsgd", bits=3))
    tstate = telemetry.stack_rows([telemetry.init_telemetry(bp.n_buckets, dev)] * PEERS)
    for i in range(3):
        tleaves_ = [heavy(PEERS * math.prod(s), 10.0 ** -(2 + j % 3)).reshape(PEERS, *s)
                    for j, s in enumerate(SMALLNET_SHAPES)]
        kernels.reset_launch_counts()
        _, _, tstate, _ = reference_sync_state(ada_ts, tleaves_, (PEERS,),
                                               prng.fold_in(mkey, i), tstate=tstate)
        check(kernels.launch_counts()[K10] == 3 * PEERS, "adaptive: K10 launches per step")

    def allocate(state):
        agg = telemetry.aggregate_peers(state)
        budget = controller.budget_bytes(ada_ts.adaptive, ada_ts.compressor, bp.sizes)
        return controller.allocate_bits(
            telemetry.estimate_tails(agg), bp.sizes, budget, ada_ts.compressor,
            dens=telemetry.estimate_densities(agg), min_bits=ada_ts.adaptive.min_bits,
            max_bits=ada_ts.adaptive.max_bits)

    bits_card = allocate(tstate)
    bits_cpu = allocate(type(tstate)(*(x.cpu() for x in tstate)))
    check(bits_card.bits == bits_cpu.bits and bits_card.spend_bytes == bits_cpu.spend_bytes,
          f"adaptive: card plan {bits_card} vs CPU plan {bits_cpu}")
    run_ts = TrainStepConfig(sync="faithful", bucket_mb=0.02, bits_plan=bits_card.bits,
                             adaptive=ada_ts.adaptive, compressor=ada_ts.compressor)
    (amean, _, at_card, _), (amean_cpu, _, at_cpu, _), counts = card_and_cpu_step(
        run_ts, mleaves, None, mkey, tstate)
    same(amean, amean_cpu, "adaptive step: mean leaf")

    def telemetry_close(at_card, at_cpu, keep: float, what: str) -> float:
        """The telemetry a step folded in, card against CPU: the max
        envelope and the step count exact; the moments within K10's rtol;
        the histogram up to elements at a bin edge, where the card's logf
        and the CPU's torch.log may round apart (each moves keep = 1 − ema
        of a count, and its ln|g|, at most 69.1 = −ln 1e-30, to the next
        bin): at most 1e-4 of the elements.  Returns the elements moved."""
        for f in ("g_max", "steps"):
            check(torch.equal(getattr(at_card, f).cpu(), getattr(at_cpu, f)),
                  f"{what}: telemetry {f} differ between the card and the CPU")
        for f in ("mean", "msq"):
            a, b = getattr(at_card, f).cpu(), getattr(at_cpu, f)
            check(bool((torch.abs(a - b) <= STATS_RTOL * float(torch.abs(b).max())).all()),
                  f"{what}: telemetry {f} beyond rtol {STATS_RTOL} of the CPU's")
        dcounts = torch.abs(at_card.counts.cpu() - at_cpu.counts)
        moved = float(dcounts.sum()) / (2 * keep)
        check(moved <= 1e-4 * PEERS * sum(bp.sizes),
              f"{what}: {moved} elements in another bin on the card than on the CPU")
        dlog = torch.abs(at_card.log_sums.cpu() - at_cpu.log_sums)
        check(bool((dlog <= STATS_RTOL * float(torch.abs(at_cpu.log_sums).max())
                    + 69.1 * dcounts + 1e-6).all()),
              f"{what}: telemetry ln sums beyond rtol and the bin-edge moves")
        return moved

    flips = telemetry_close(at_card, at_cpu, 1.0 - ada_ts.adaptive.ema, "adaptive step")
    print(f"[adaptive] 3 telemetry steps, then bits {bits_card.bits} (spend "
          f"{bits_card.spend_bytes} of {bits_card.budget_bytes} B, alphas "
          f"{[round(a, 9) for a in bits_card.alphas]}), equal from the CPU; one step with the "
          f"plan: launches {json.dumps(counts)}, means bitwise card vs CPU, telemetry within "
          f"rtol {STATS_RTOL} and {flips:g} elements a bin apart")

    # one per-leaf sync (reference_sync, bucket_mb=0) of the mixed plan's
    # leaves in each mode of the per-leaf runs, on the card and then on the
    # CPU with the card's plans replayed: every mean leaf bitwise equal
    # (the kernels are bitwise their plain versions given the plans), and
    # the launches those runs make a step
    for label in ("per_leaf_faithful", "per_leaf_faithful_tqsgd", "per_leaf_two_phase",
                  "per_leaf_hierarchical"):
        kw, _, per_step, *_ = golden[label]
        kw = dict(kw)
        dp = kw.pop("dp_sizes", (PEERS,))
        leaf_ts = TrainStepConfig(compressor=CompressorConfig(method=kw.pop("method", "tnqsgd"),
                                                              bits=3), **kw)
        lmean, lmean_cpu, counts = card_and_cpu(
            lambda device: reference_sync(leaf_ts, [x.to(device) for x in mleaves], dp, mkey))
        check(counts == per_step, f"{label} step: launches {counts}, expected {per_step}")
        same(lmean, lmean_cpu, f"{label} step: mean leaf")
        check(all(bool(torch.isfinite(x).all()) for x in lmean), f"{label} step: non-finite mean")
        print(f"[per_leaf] {label} one step over dp {dp}: launches {json.dumps(counts)}; "
              f"every mean leaf bitwise card vs CPU")

    t_elastic = time.time()
    # elastic participation, one step per bucketed mode on the mixed plan's
    # layout (buckets of 4,928, 200,704 and 1,290), tnqsgd at 3 bits with EF
    # and telemetry, on the card and then on the CPU with the card's plans
    # replayed, under a mask that kills pod 0 of (2, 4) and peer 5: means,
    # EF rows and launches bitwise; a dropped peer's EF row is its whole
    # corrected bucket; the telemetry as in the adaptive step.  Every peer
    # still encodes: per bucket faithful K2 8, K4 1; two_phase (8,) K2 8,
    # K4 8, K10 8 (the chunk means' plans), K6 8, K8 1; hierarchical (2, 4)
    # K2 8 + 2, K4 8 + 1, K10 8 + 2, K6 8, K8 2; K1 8 each.
    from repro_torch.core.compressors import bucket_concat
    from repro_torch.obs import metrics

    nb = bp.n_buckets
    elastic_live = live_mask(partition(PEERS, down=(0, 1, 2, 3, 5), down_steps=1).elastic(), 0,
                             PEERS, dev)
    check(elastic_live.tolist() == [0.0] * 4 + [1.0, 0.0, 1.0, 1.0], f"mask {elastic_live}")
    dead = [p for p in range(PEERS) if elastic_live[p] == 0.0]
    corrected = [[g + e[p] for g, e in zip(bucket_concat([x[p] for x in mleaves], bp), fef)]
                 for p in range(PEERS)]

    def counts_of(**per_bucket) -> dict:
        want = dict.fromkeys(launches, 0)
        names = {"K1": K1, "K10": K10, "K11": K11, "K2": "encode_fused.codebook_encode_pack_resid_2d",
                 "K4": "decode.codebook_decode_reduce_3d", "K6": "encode_fused.codebook_encode_pack_2d",
                 "K8": "decode.codebook_decode_rows_3d"}
        want.update({names[k]: v for k, v in per_bucket.items()})
        return want

    def dead_rows_are_buckets(resids, what: str) -> None:
        for b in range(nb):
            for p in dead:
                check(torch.equal(resids[b][p][:bp.sizes[b]], corrected[p][b]),
                      f"{what}: dropped peer {p}'s EF row of bucket {b} is not its corrected "
                      f"bucket")

    el_modes = {
        "faithful": ((PEERS,), counts_of(K1=8 * nb, K2=8 * nb, K4=nb)),
        "two_phase": ((PEERS,), counts_of(K1=8 * nb, K2=8 * nb, K4=8 * nb, K10=8 * nb, K6=8 * nb,
                                          K8=nb)),
        "hierarchical": ((2, PEERS // 2), counts_of(K1=8 * nb, K2=10 * nb, K4=9 * nb, K10=10 * nb,
                                                    K6=8 * nb, K8=2 * nb)),
    }
    for sync, (dp, want) in el_modes.items():
        el_ts = TrainStepConfig(sync=sync, error_feedback=True, bucket_mb=0.02,
                                adaptive=controller.AdaptiveConfig(),
                                compressor=CompressorConfig(method="tnqsgd", bits=3))
        t0 = telemetry.stack_rows([telemetry.init_telemetry(nb, dev)] * PEERS)
        (emean, eres, et_card, _), (emean_cpu, eres_cpu, et_cpu, _), counts = card_and_cpu_step(
            el_ts, mleaves, fef, mkey, t0, dp, elastic_live)
        check(counts == want, f"elastic {sync}: launches {counts}, expected {want}")
        same(emean, emean_cpu, f"elastic {sync}: mean leaf")
        same(eres, eres_cpu, f"elastic {sync}: EF rows of bucket")
        dead_rows_are_buckets(eres, f"elastic {sync}")
        check(all(bool(torch.isfinite(x).all()) for x in emean), f"elastic {sync}: non-finite mean")
        moved = telemetry_close(et_card, et_cpu, 1.0 - el_ts.adaptive.ema, f"elastic {sync}")
        print(f"[elastic] {sync} over dp {dp}, live {elastic_live.tolist()}: launches "
              f"{json.dumps(counts)}; means and EF rows bitwise card vs CPU, dropped peers' EF "
              f"rows their corrected buckets, telemetry {moved:g} elements a bin apart")

    # the fp16 tier under the mask: buckets 0 and 2 ship float16; bitwise
    (fmean, fres, _, _), (cmean, cres, _, _), counts = card_and_cpu_step(
        fp16_ts, mleaves, fef, mkey, live=elastic_live)
    want = counts_of(K1=3 * PEERS, K2=PEERS, K4=1)
    check(counts == want, f"elastic fp16 tier: launches {counts}, expected {want}")
    same(fmean, cmean, "elastic fp16 tier: mean leaf")
    same(fres, cres, "elastic fp16 tier: EF rows of bucket")
    dead_rows_are_buckets(fres, "elastic fp16 tier")
    print(f"[elastic] fp16 tier under the mask: launches {json.dumps(counts)}; means and EF rows "
          f"bitwise card vs CPU")

    # faithful powersgd (rank 4, EF on, a random warm start) under the mask:
    # the dropped peers' EF residuals bitwise (their corrected buckets), the
    # rest within the mixed plan's tolerance (cuBLAS and the CPU reduce the
    # products in other orders)
    pw_ts = TrainStepConfig(sync="faithful", error_feedback=True, bucket_mb=0.02,
                            compressor=CompressorConfig(method="powersgd", rank=4))
    pw_ef = [heavy(PEERS * m, 1e-4).reshape(PEERS, m)
             for m in kcodecs.bucket_state_sizes(pw_ts.compressor, bp.sizes)]
    (pmean, pres, _, _), (pmean_cpu, pres_cpu, _, _), counts = card_and_cpu_step(
        pw_ts, mleaves, pw_ef, mkey, live=elastic_live)
    want = counts_of(K1=3 * PEERS, K11=3 * PEERS)
    check(counts == want, f"elastic powersgd: launches {counts}, expected {want}")
    pcorr = [[g + e[p][:g.numel()] for g, e in zip(bucket_concat([x[p] for x in mleaves], bp),
                                                    pw_ef)] for p in range(PEERS)]
    for b in range(nb):
        for p in dead:
            check(torch.equal(pres[b][p][:bp.sizes[b]], pcorr[p][b]),
                  f"elastic powersgd: dropped peer {p}'s EF residual of bucket {b}")
    pw_err = 0.0
    for got, ref_ in zip(list(pres) + list(pmean), list(pres_cpu) + list(pmean_cpu)):
        d = torch.abs(got.cpu() - ref_)
        scale = float(ref_.abs().max())
        check(bool((d <= 1e-5 * torch.abs(ref_) + 1e-5 * scale).all()),
              f"elastic powersgd: beyond tolerance (max {float(d.max())} of {scale})")
        pw_err = max(pw_err, float(d.max()) / max(scale, 1e-30))
    print(f"[elastic] faithful powersgd under the mask: launches {json.dumps(counts)}; dropped "
          f"peers' EF residuals bitwise, means and EF rows within rtol 1e-5 (max abs err / max "
          f"magnitude {pw_err:.3g})")

    # the straggler pin: a dropped peer's gradient times -3.7 leaves every
    # mean bit as it was (its encode runs, its wire is zeroed); EF off
    def bits_equal(xs, ys) -> bool:
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(xs, ys))

    poked = [x.clone() for x in mleaves]
    for x in poked:
        x[5] *= -3.7
    for sync in ("faithful", "two_phase"):
        st_ts = TrainStepConfig(sync=sync, bucket_mb=0.02,
                                compressor=CompressorConfig(method="tnqsgd", bits=3))
        a = reference_sync_state(st_ts, mleaves, (PEERS,), mkey, live=elastic_live)[0]
        b = reference_sync_state(st_ts, poked, (PEERS,), mkey, live=elastic_live)[0]
        check(bits_equal(a, b), f"straggler pin, {sync}: a dropped peer's gradient moved the mean")
    print("[elastic] straggler pin: peer 5's gradient times -3.7 leaves the faithful and "
          "two_phase means bitwise unchanged")

    # solo survivor: with peer 0 alone live the faithful mean is its own
    # decoded wire (the zero-filled mean over 8, times 8), bit for bit
    solo = live_mask(solo_survivor(PEERS).elastic(), 0, PEERS, dev)
    so_ts = TrainStepConfig(sync="faithful", bucket_mb=0.02,
                            compressor=CompressorConfig(method="tnqsgd", bits=3))
    smeans = bucket_concat(reference_sync_state(so_ts, mleaves, (PEERS,), mkey, live=solo)[0], bp)
    codec = kcodecs.get_codec("tnqsgd")
    k0 = prng.fold_in(mkey, 0)
    for b, g in enumerate(bucket_concat([x[0] for x in mleaves], bp)):
        own = codec.encode_residual(so_ts.compressor, g, codec.plan(so_ts.compressor, g, None),
                                    prng.fold_in(k0, b))[0]
        check(torch.equal(smeans[b], codec.decode_reduce(so_ts.compressor, own[None], g.numel())),
              f"solo survivor: bucket {b} mean is not the survivor's decoded wire")
    print(f"[elastic] solo survivor {solo.tolist()}: every bucket's mean bitwise the survivor's "
          f"own decoded wire")

    # one metrics step, faithful tnqsgd with EF, with and without the mask,
    # card against CPU with the plans (the metrics' own replans too)
    # replayed: the geometry, alpha, clip_frac, ef_norm and realized_mse
    # bitwise (the squares added in a fixed pairwise tree); predicted_mse
    # within PRED_CARD_RTOL (each device bins by its own log, fact F8, and
    # the tail fit is ill-conditioned, fact F3)
    me_ts = TrainStepConfig(sync="faithful", error_feedback=True, bucket_mb=0.02,
                            metrics_compression=True,
                            compressor=CompressorConfig(method="tnqsgd", bits=3))
    pred_err = 0.0
    for live in (None, elastic_live):
        (_, _, _, cm_card), (_, _, _, cm_cpu), counts = card_and_cpu_step(me_ts, mleaves, fef, mkey,
                                                                           live=live)
        want = counts_of(K1=3 * PEERS, K2=3 * PEERS, K4=3)
        check(counts == want, f"metrics step: launches {counts}, expected {want}")
        for f in ("bits", "rank", "wire_bytes", "alpha", "clip_frac", "ef_norm", "realized_mse"):
            a, c = getattr(cm_card, f).cpu(), getattr(cm_cpu, f)
            check(a.shape == (PEERS, nb) and torch.equal(a, c),
                  f"metrics step ({'masked' if live is not None else 'all live'}): {f} differs")
        a, c = cm_card.predicted_mse.cpu(), cm_cpu.predicted_mse
        rel = float((torch.abs(a - c) / torch.abs(c)).max())
        check(rel <= PRED_CARD_RTOL, f"metrics step: predicted_mse rel err {rel} > {PRED_CARD_RTOL}")
        pred_err = max(pred_err, rel)
        if live is not None:
            # a dropped peer's realized error is its corrected bucket's mean square
            for p in dead:
                for b in range(nb):
                    whole = metrics._sum_sq(corrected[p][b]) / torch.tensor(float(bp.sizes[b]),
                                                                            device=dev)
                    check(torch.equal(cm_card.realized_mse[p, b], whole),
                          f"metrics: dropped peer {p}'s realized error of bucket {b}")
            print("[metrics] (8, B) table under the mask: " + json.dumps(
                {f: getattr(cm_card, f).cpu().tolist() for f in cm_card._fields}))
    print(f"[metrics] faithful tnqsgd, EF on, with and without the mask: launches "
          f"{json.dumps(counts)}; bits, rank, wire_bytes, alpha, clip_frac, ef_norm, realized_mse "
          f"bitwise card vs CPU, predicted_mse max rel err {pred_err:.3g}")
    print(f"[elastic] masked, straggler, solo-survivor and metrics checks: "
          f"{time.time() - t_elastic:.1f} s")

    # -- 4b. mesh ---------------------------------------------------------
    # the mesh sync on torch.distributed: 8 gloo ranks, spawned, every one on
    # cuda:0 (NCCL takes one card a rank).  (a) one sync per case of
    # _mesh_cases on inputs made here from the generator: every rank's means
    # bitwise every other's and, with its EF row, telemetry row and metrics,
    # bitwise its row of this process's card replay (reference_sync_state;
    # the per-leaf sync reference_sync); dsgd (gloo owns the order of the
    # sum) within 1e-6 relative.  Launches a rank, per sync: faithful K1, K2, K4 one each;
    # two_phase (8,) adds K10 (its mean chunk's plan), K6 and K8;
    # hierarchical (2, 4) does that inside its pod of 4 and then plans
    # (K10), encodes (K2) and decodes (K4) the 2 pod means; the masked
    # syncs launch what the unmasked do (a dropped rank still encodes);
    # dsgd none; powersgd K1 and K11; the per-leaf sync K6 and K4 once a
    # leaf (8).  (b) the golden faithful tnqsgd run, one client a rank:
    # every rank's history bitwise phase 4's faithful_ef_off history, K10,
    # K2 and K4 once a step.  (c) a synced step's median of 5 a rank.
    import tempfile

    import torch.multiprocessing as tmp

    from repro_torch.adaptive import telemetry as ktel
    from repro_torch.obs import metrics as kmetrics

    t_mesh = time.time()
    mcases = _mesh_cases()
    mgen = torch.Generator(device=dev).manual_seed(0x3E5)

    def mheavy(n: int, scale: float) -> torch.Tensor:
        z = torch.randn(n, generator=mgen, device=dev)
        return scale * z * torch.exp(torch.randn(n, generator=mgen, device=dev))

    mleaves8 = [mheavy(MESH_RANKS * math.prod(s), 1e-3).reshape(MESH_RANKS, *s)
                for s in SMALLNET_SHAPES]
    mstate = {m: mheavy(MESH_RANKS * m, 1e-4).reshape(MESH_RANKS, m)
              for ts_, _, _ in mcases.values() if ts_.error_feedback
              for m in kcodecs.bucket_state_sizes(ts_.compressor, [SLICE_N])}
    mlive = torch.tensor(MESH_MASK, device=dev)
    mkey8 = prng.fold_in(prng.key(0x5EED), 7)
    golden_hist = runs["faithful_ef_off"]["hist"]
    with tempfile.TemporaryDirectory() as wd:
        torch.save({"leaves": [x.cpu() for x in mleaves8], "key": mkey8, "live": mlive.cpu(),
                    "ef": {m: e.cpu() for m, e in mstate.items()}},
                   os.path.join(wd, "inputs.pt"))
        t_spawn = time.time()
        ctx = tmp.start_processes(_mesh_rank, args=(MESH_RANKS, f"file://{wd}/rendezvous", wd,
                                                    str(ROOT / "src"), len(golden_hist)),
                                  nprocs=MESH_RANKS, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.time() - t_spawn > MESH_TIMEOUT_S:
                    fail(f"mesh ranks still running after {MESH_TIMEOUT_S} s")
        except Exception as e:  # a rank raised: report its traceback
            fail(f"a mesh rank failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        ranks_wall = time.time() - t_spawn
        mres = [torch.load(os.path.join(wd, f"rank{r}.pt"), weights_only=True)
                for r in range(MESH_RANKS)]
    check(all(r["device"] == "cuda:0" for r in mres),
          f"mesh ranks' devices {[r['device'] for r in mres]}")
    print(f"[mesh] {MESH_RANKS} gloo ranks on {mres[0]['device']} ran in {ranks_wall:.1f} s "
          "(spawn included); compat stages nothing through host memory: gloo took the CUDA "
          "tensors of all_gather_into_tensor (the concatenated form), all_to_all_single and "
          "all_reduce")

    def mesh_counts(**per_rank) -> dict:
        names = {"K1": K1, "K10": K10, "K11": K11,
                 "K2": "encode_fused.codebook_encode_pack_resid_2d",
                 "K4": "decode.codebook_decode_reduce_3d",
                 "K6": "encode_fused.codebook_encode_pack_2d",
                 "K8": "decode.codebook_decode_rows_3d"}
        return {names[k]: v for k, v in per_rank.items()}

    mwant = {"faithful": mesh_counts(K1=1, K2=1, K4=1),
             "two_phase": mesh_counts(K1=1, K2=1, K4=1, K10=1, K6=1, K8=1),
             "hierarchical": mesh_counts(K1=1, K2=2, K4=2, K10=2, K6=1, K8=1),
             "dsgd": {}, "faithful_powersgd": mesh_counts(K1=1, K11=1),
             "per_leaf_faithful": mesh_counts(K6=8, K4=8)}
    for sync in ("faithful", "two_phase", "hierarchical"):
        mwant[f"{sync}_masked"] = mwant[sync]
    for label, (ts_, dp, masked) in mcases.items():
        n_ = math.prod(dp)
        live_ = mlive if masked else None
        if ts_.bucket_mb > 0:
            t0_ = (ktel.stack_rows([ktel.init_telemetry(1, dev)] * n_) if ts_.adaptive is not None
                   else None)
            ef_ = None
            if ts_.error_feedback:
                ef_ = [mstate[m] for m in kcodecs.bucket_state_sizes(ts_.compressor, [SLICE_N])]
            wmean, wres, wt, wcm = reference_sync_state(ts_, mleaves8, dp, mkey8, ef=ef_,
                                                        tstate=t0_, live=live_)
        else:
            wmean, wres, wt, wcm = reference_sync(ts_, mleaves8, dp, mkey8), None, None, None
        wmean = [m.cpu() for m in wmean]
        dsgd_err = 0.0
        for r, res_ in enumerate(mres):
            got = res_["cases"][label]
            check(got["counts"] == mwant[label],
                  f"mesh {label}: rank {r} launches {got['counts']}, expected {mwant[label]}")
            for a, b in zip(got["mean"], mres[0]["cases"][label]["mean"], strict=True):
                check(torch.equal(a, b), f"mesh {label}: rank {r}'s means differ from rank 0's")
            if ts_.sync == "dsgd":
                for a, b in zip(got["mean"], wmean, strict=True):
                    rel = float((a - b).abs().max() / b.abs().max())
                    check(rel <= 1e-6, f"mesh dsgd: rank {r} {rel:g} from the replay")
                    dsgd_err = max(dsgd_err, rel)
                continue
            for i, (a, b) in enumerate(zip(got["mean"], wmean, strict=True)):
                check(torch.equal(a, b), f"mesh {label}: rank {r} mean leaf {i} is not the "
                      f"replay's (max abs {float((a - b).abs().max()):g})")
            if ts_.error_feedback:
                for b, e in enumerate(got["ef"]):
                    check(torch.equal(e, wres[b][r].cpu()),
                          f"mesh {label}: rank {r} EF row of bucket {b} is not the replay's")
            if ts_.adaptive is not None:
                for f, a in zip(ktel.TelemetryState._fields, got["tstate"], strict=True):
                    check(torch.equal(a, getattr(wt, f)[r].cpu()),
                          f"mesh {label}: rank {r} telemetry {f} is not the replay's")
            if ts_.metrics_compression:
                for f, a in zip(kmetrics.CompressionMetrics._fields, got["metrics"], strict=True):
                    check(torch.equal(a, getattr(wcm, f)[r].cpu()),
                          f"mesh {label}: rank {r} metric {f} is not the replay's")
        for k, v in mwant[label].items():
            launches[k] += v * MESH_RANKS
        print(f"[mesh] {label} over dp {dp}{' masked ' + str(MESH_MASK) if masked else ''}: "
              f"launches per rank {json.dumps(mres[0]['cases'][label]['counts'])} (predicted "
              f"{json.dumps(mwant[label])}); "
              + (f"means within {dsgd_err:.3g} relative of the replay, bitwise across ranks"
                 if ts_.sync == "dsgd" else
                 "means, EF, telemetry and metrics rows bitwise the card replay's and across "
                 "ranks"))

    # (b) the golden run, one client a rank
    gwant = {k: v * len(golden_hist) for k, v in mesh_counts(K10=1, K2=1, K4=1).items()}
    for r, res_ in enumerate(mres):
        check(res_["golden"] == golden_hist,
              f"mesh golden: rank {r}'s history is not phase 4's faithful_ef_off history: "
              f"{res_['golden']}")
        check(res_["golden_counts"] == gwant,
              f"mesh golden: rank {r} launches {res_['golden_counts']}, expected {gwant}")
    for k, v in gwant.items():
        launches[k] += v * MESH_RANKS
    ghist = mres[0]["golden"]
    check(abs(ghist[-1] - 0.0162) <= 0.05, f"mesh golden: final loss {ghist[-1]}")
    print(f"[mesh] golden faithful tnqsgd over {MESH_RANKS} ranks: first {ghist[0]:.6f} last "
          f"{ghist[-1]:.6f} ({len(ghist)} steps, {max(r['golden_s'] for r in mres):.2f} s), every "
          f"rank's history bitwise phase 4's faithful_ef_off; launches per rank "
          f"{json.dumps(mres[0]['golden_counts'])}")
    print(f"[mesh] golden losses {json.dumps(ghist)}")

    # (c) a synced step on each rank: median of 5 (host clock, synchronized)
    for label in ("faithful", "two_phase", "hierarchical", "dsgd"):
        per_rank = [statistics.median(r["times"][label]["runs_ms"]) for r in mres]
        shares = [statistics.median(r["times"][label]["collective_share"]) for r in mres]
        print("[time] " + json.dumps({
            "mesh_synced_step_ms_per_rank": per_rank, "collective_share_per_rank": shares,
            "sync": label, "dp_sizes": list(mcases[label][1]), "ranks": MESH_RANKS,
            "backend": "gloo", "elements": SLICE_N, "card": card}))
    print(f"[mesh] phase wall time {time.time() - t_mesh:.1f} s")

    # -- 4c. serving ------------------------------------------------------
    served = serving_phase(card)

    # -- 4d. training -----------------------------------------------------
    trained, train_steps = training_phase(card)
    for k, v in trained.items():
        launches[k] += v

    # -- 4e. the model axis ----------------------------------------------
    for k, v in model_axis_phase(card, train_steps, served).items():
        launches[k] += v

    # -- 6. the dry run beside 4c and 4d, and the analysis passes ----------
    dryrun_phase(card, train_steps, served)
    for k, v in analysis_phase(card).items():
        launches[k] += v

    # -- 5. times ---------------------------------------------------------
    def graph_ms(fn, calls, reps=20) -> float:
        """Device time per call: a CUDA graph of every call in ``calls`` (whose
        inputs together exceed the 50 MB L2), replayed ``reps`` times."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for args in calls:
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for args in calls:
                fn(*args)
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * len(calls))

    def eager_ms(fn, calls, reps=3) -> float:
        for args in calls:
            fn(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            for args in calls:
                fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * len(calls))

    def serial_body(uniform: bool, reduce: bool):
        return lambda w3, meta, b: kdec.serial_3d(uniform, reduce, w3, meta, b)

    def serial_encode(uniform: bool, resid: bool):
        return lambda g2, r, meta, n_, b: kenc.serial_2d(uniform, resid, g2, r, meta, n_, b)

    def in_turns(fn, old, calls) -> tuple[list, list]:
        """A kernel and the body it replaced timed in turns (new, old, new,
        old) on the same calls."""
        times = [graph_ms(f, calls) for f in (fn, old, fn, old)]
        return times[0::2], times[1::2]

    fi = full_inputs
    n, bits, rows = FULL_N, 3, -(-FULL_N // 128)
    rand = [prng.uniform(prng.key(p), (rows, 128), device=dev) for p in range(PEERS)]
    wbytes = rows * 4 * bits * 4
    tile = 8 * 128 * 4
    spec = {
        "encode_fused.ef_correct_stats_2d": dict(
            fn=kenc.ef_correct_stats_2d, plain=ref.ef_correct_stats,
            calls=[(fi["g"][p], fi["e"][p], n) for p in range(PEERS)],
            bytes=3 * 4 * n + tile, source="src/repro_torch/kernels/csrc/stats.cu",
            replaces="src/repro/kernels/encode_fused.py:90"),
        "stats.bucket_stats_2d": dict(
            fn=kstats.bucket_stats_2d, plain=ref.bucket_stats,
            calls=[(x, n) for x in fi["g"] + fi["e"] + fi["c"]],
            bytes=4 * n + tile, source="src/repro_torch/kernels/csrc/stats.cu",
            replaces="src/repro/kernels/stats.py:106"),
        "encode_fused.codebook_encode_pack_resid_2d": dict(
            fn=kenc.codebook_encode_pack_resid_2d,
            serial=serial_encode(False, True), plain=ref.codebook_encode_pack_residual,
            calls=[(fi["c"][p], rand[p], fi["levels"][p], n, bits) for p in range(PEERS)],
            bytes=2 * 4 * n + 4 * (2**bits) + wbytes + 4 * n,
            source="src/repro_torch/kernels/csrc/encode_fused.cu",
            replaces="src/repro/kernels/encode_fused.py:215"),
        "decode.codebook_decode_reduce_3d": dict(
            fn=kdec.codebook_decode_reduce_3d, plain=ref.codebook_decode_reduce,
            calls=[(fi["words3"].clone(), fi["levels2"], bits) for _ in range(8)],
            bytes=PEERS * wbytes + PEERS * 4 * (2**bits) + 4 * n,
            serial=serial_body(False, True),
            source="src/repro_torch/kernels/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:165"),
    }
    spec.update({
        "encode_fused.uniform_encode_pack_resid_2d": dict(
            fn=kenc.uniform_encode_pack_resid_2d,
            serial=serial_encode(True, True), plain=ref.uniform_encode_pack_residual,
            calls=[(fi["c"][p], rand[p], fi["alphas"][p], n, bits) for p in range(PEERS)],
            bytes=2 * 4 * n + 4 + wbytes + 4 * n,
            source="src/repro_torch/kernels/csrc/encode_fused.cu",
            replaces="src/repro/kernels/encode_fused.py:196"),
        "decode.uniform_decode_reduce_3d": dict(
            fn=kdec.uniform_decode_reduce_3d, plain=ref.uniform_decode_reduce,
            calls=[(fi["uwords3"].clone(), fi["alphas1"], bits) for _ in range(8)],
            bytes=PEERS * wbytes + PEERS * 4 + 4 * n,
            serial=serial_body(True, True),
            source="src/repro_torch/kernels/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:159"),
        "encode_fused.codebook_encode_pack_2d": dict(
            fn=kenc.codebook_encode_pack_2d,
            serial=serial_encode(False, False), plain=ref.codebook_encode_pack,
            calls=[(fi["c"][p], rand[p], fi["levels"][p], n, bits) for p in range(PEERS)],
            bytes=2 * 4 * n + 4 * (2**bits) + wbytes,
            source="src/repro_torch/kernels/csrc/encode_fused.cu",
            replaces="src/repro/kernels/encode_fused.py:206"),
        "encode_fused.uniform_encode_pack_2d": dict(
            fn=kenc.uniform_encode_pack_2d,
            serial=serial_encode(True, False), plain=ref.uniform_encode_pack,
            calls=[(fi["c"][p], rand[p], fi["alphas"][p], n, bits) for p in range(PEERS)],
            bytes=2 * 4 * n + 4 + wbytes,
            source="src/repro_torch/kernels/csrc/encode_fused.cu",
            replaces="src/repro/kernels/encode_fused.py:187"),
        "decode.codebook_decode_rows_3d": dict(
            fn=kdec.codebook_decode_rows_3d, plain=ref.codebook_decode_rows,
            calls=[(fi["words3"].clone(), fi["levels2"], bits) for _ in range(2)],
            bytes=PEERS * wbytes + PEERS * 4 * (2**bits) + PEERS * 4 * n,
            serial=serial_body(False, False),
            source="src/repro_torch/kernels/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:177"),
        "decode.uniform_decode_rows_3d": dict(
            fn=kdec.uniform_decode_rows_3d, plain=ref.uniform_decode_rows,
            calls=[(fi["uwords3"].clone(), fi["alphas1"], bits) for _ in range(2)],
            bytes=PEERS * wbytes + PEERS * 4 + PEERS * 4 * n,
            serial=serial_body(True, False),
            source="src/repro_torch/kernels/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:171"),
    })
    # K11 at the main path's shape: the (809, 4) P factor of smallnet's
    # bucket, one per peer; the library yardstick is torch.linalg.qr (Q
    # equals MGS's up to column signs at full column rank).
    gs_p = [torch.randn(809, 4, generator=gen, device=dev) for _ in range(PEERS)]
    spec["orthogonalize.orthogonalize_2d"] = dict(
        fn=korth.orthogonalize_2d, plain=ref.orthogonalize,
        calls=[(x,) for x in gs_p], bytes=gs_bytes(809, 4), flops=gs_flops(809, 4),
        library=lambda x: torch.linalg.qr(x, mode="reduced"), library_calls=[(x,) for x in gs_p],
        library_name="torch.linalg.qr", source="src/repro_torch/kernels/csrc/orthogonalize.cu",
        replaces="src/repro/kernels/orthogonalize.py:71")
    # K12-K17 at a 4 MB tensor, on the same 8 corrected buckets, draws and
    # plans as K2-K7 above; the decodes on the encodes' codes.  The library
    # yardstick of K15 is torch.take(levels, codes) (its codes as int64,
    # converted outside the timing); no single PyTorch call computes the
    # others.
    qsrc, qpy = "src/repro_torch/kernels/csrc/quantize.cu", "src/repro/kernels/quantize.py"
    esrc = "src/repro_torch/kernels/csrc/encode_fused.cu"    # K16, K17
    uc = [kq.uniform_encode_2d(fi["c"][p], rand[p], fi["alphas"][p], bits) for p in range(PEERS)]
    cc = [kq.codebook_encode_2d(fi["c"][p], rand[p], fi["levels"][p]) for p in range(PEERS)]
    cc64 = [c.to(torch.int64) for c in cc]
    lvb = 4 * (2**bits)
    spec.update({
        "quantize.uniform_encode_2d": dict(
            fn=kq.uniform_encode_2d, plain=ref.uniform_encode,
            calls=[(fi["c"][p], rand[p], fi["alphas"][p], bits) for p in range(PEERS)],
            bytes=12 * n + 4, source=qsrc, replaces=f"{qpy}:76"),
        "quantize.uniform_decode_2d": dict(
            fn=kq.uniform_decode_2d, plain=ref.uniform_decode,
            calls=[(uc[p], fi["alphas"][p], bits) for p in range(PEERS)],
            bytes=8 * n + 4, source=qsrc, replaces=f"{qpy}:103"),
        "quantize.codebook_encode_2d": dict(
            fn=kq.codebook_encode_2d, plain=ref.codebook_encode,
            calls=[(fi["c"][p], rand[p], fi["levels"][p]) for p in range(PEERS)],
            bytes=12 * n + lvb, source=qsrc, replaces=f"{qpy}:130"),
        "quantize.codebook_decode_2d": dict(
            fn=kq.codebook_decode_2d, plain=ref.codebook_decode,
            calls=[(cc[p], fi["levels"][p]) for p in range(PEERS)],
            bytes=8 * n + lvb, library=lambda c, lv: torch.take(lv, c),
            library_calls=[(cc64[p], fi["levels"][p]) for p in range(PEERS)],
            library_name="torch.take", source=qsrc, replaces=f"{qpy}:271"),
        "quantize.uniform_encode_pack_2d": dict(
            fn=kq.uniform_encode_pack_2d, plain=ref.uniform_encode_pack_codes,
            calls=[(fi["c"][p], rand[p], fi["alphas"][p], n, bits) for p in range(PEERS)],
            bytes=12 * n + 4 + 4 + wbytes, source=esrc, replaces=f"{qpy}:193"),
        "quantize.codebook_encode_pack_2d": dict(
            fn=kq.codebook_encode_pack_2d, plain=ref.codebook_encode_pack_codes,
            calls=[(fi["c"][p], rand[p], fi["levels"][p], n, bits) for p in range(PEERS)],
            bytes=12 * n + lvb + 4 + wbytes, source=esrc, replaces=f"{qpy}:232"),
    })
    check(set(spec) == set(launches), "every kernel needs a timing spec")
    per_step = {k: max(r["counts"][k] / len(r["hist"]) for r in runs.values()) for k in launches}
    records = []
    for name, sp in spec.items():
        extra = {}
        if "serial" in sp:
            new_ms, old_ms = in_turns(sp["fn"], sp["serial"], sp["calls"])
            ms, extra = new_ms[0], {"ms_turns": new_ms, "serial_body_ms_turns": old_ms}
        else:
            ms = graph_ms(sp["fn"], sp["calls"])
        plain_ms = eager_ms(sp["plain"], sp["calls"][:2])
        bound_ms, bound_by = bound(sp["bytes"], sp.get("flops", 0))
        library_ms = eager_ms(sp["library"], sp["library_calls"]) if "library" in sp else None
        rec = {"name": name, "route": "cuda", "source": sp["source"],
               "replaces": sp["replaces"], "launches": launches[name],
               "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        records.append(rec)
        print("[time] " + json.dumps(dict(rec, bytes=sp["bytes"], x_bound=ms / bound_ms,
                                          launches_per_step_or_round=per_step[name],
                                          library=sp.get("library_name", "none"), card=card,
                                          **extra)))

    # K1, K2, K4 and K8 at the largest LM gradient bucket: llama3.2-1b's
    # stacked FFN leaf, 268,435,456 elements (25,165,824 wire words at 3
    # bits), one peer, as phase 4d's faithful step launches K1, K2 and K4
    # on it (K8 is a two_phase peer's decode); each first held to its plain
    # version on the same inputs.  K1: c bitwise the plain g + e; the tile
    # against the plain tiles of c's 2**24-element slices (a bin's count
    # exact in float32 there) merged in float64, as phase 3 holds it:
    # every bin's count bitwise the exact count rounded once to float32
    # (the kernel counts in integers and rounds once), the max exact, the
    # log sums and sums within STATS_RTOL of the merged tile and of the
    # float64 sums
    big_n = 268_435_456
    big_rows = big_n // 128
    bg, be = heavy(big_n, 1e-3).reshape(big_rows, 128), heavy(big_n, 1e-4).reshape(big_rows, 128)
    c_big, tile_big = kenc.ef_correct_stats_2d(bg, be, big_n)
    check(torch.equal(c_big, bg + be), "K1 at the LM bucket: c is not g + e")
    part_rows = (1 << 24) // 128
    parts = torch.stack([ref.bucket_stats(c_big[r:r + part_rows], part_rows * 128).double()
                         for r in range(0, big_rows, part_rows)])
    big_counts = parts[:, 0].sum(0)
    tile_want = parts.sum(0).float()
    tile_want[0] = big_counts.float()
    tile_want[2] = parts[:, 2].amax(0).float()
    big_rel = (stats_err(tile_big, tile_want, c_big, big_n, "K1 at the LM bucket",
                         counts=big_counts),
               exact_err(tile_big, c_big, big_n, "K1 at the LM bucket"))
    del parts
    print(f"[parity] K1 at the LM bucket ({big_n:,} elements): c bitwise g + e, the "
          f"{kstats.NUM_BINS} bins' counts bitwise the exact ones rounded once (largest bin "
          f"{int(big_counts.max()):,}), max exact, rows 1, 3, 4 within rtol {STATS_RTOL} of "
          f"the plain tile (max abs diff {big_rel[0]:.6g}) and of the float64 sums (largest "
          f"relative error {big_rel[1]:.3g})")
    big_levels = plan_from_stats(cfg3, tile_big[0], tile_big[1], tile_big[2, 0]).levels
    big_rand = prng.uniform(prng.key(268), (big_rows, 128), device=dev)
    big_words, big_resid = kenc.codebook_encode_pack_resid_2d(c_big, big_rand, big_levels,
                                                              big_n, bits)
    want_words, want_resid = ref.codebook_encode_pack_residual(c_big, big_rand, big_levels,
                                                               big_n, bits)
    agree("encode_fused.codebook_encode_pack_resid_2d", big_words, want_words,
          "words at the LM bucket")
    agree("encode_fused.codebook_encode_pack_resid_2d", big_resid, want_resid,
          "residual at the LM bucket")
    del want_words, want_resid
    big_w3, big_lv2 = big_words[None].contiguous(), big_levels[None].contiguous()
    for kernel, plain in ((kdec.codebook_decode_reduce_3d, ref.codebook_decode_reduce),
                          (kdec.codebook_decode_rows_3d, ref.codebook_decode_rows)):
        agree(kernels.kernel_name(kernel), kernel(big_w3, big_lv2, bits),
              plain(big_w3, big_lv2, bits), "at the LM bucket")
    torch.cuda.empty_cache()
    big_wb, big_lvb = big_words.numel() * 4, big_levels.numel() * 4
    for name, fn, args, nbytes in (
            ("encode_fused.ef_correct_stats_2d", kenc.ef_correct_stats_2d, (bg, be, big_n),
             3 * 4 * big_n + tile),
            ("encode_fused.codebook_encode_pack_resid_2d", kenc.codebook_encode_pack_resid_2d,
             (c_big, big_rand, big_levels, big_n, bits), 3 * 4 * big_n + big_lvb + big_wb),
            ("decode.codebook_decode_reduce_3d", kdec.codebook_decode_reduce_3d,
             (big_w3, big_lv2, bits), big_wb + big_lvb + 4 * big_n),
            ("decode.codebook_decode_rows_3d", kdec.codebook_decode_rows_3d,
             (big_w3, big_lv2, bits), big_wb + big_lvb + 4 * big_n)):
        ms = graph_ms(fn, [args], reps=10)
        b_ms, b_by = bound(nbytes)
        print("[time] " + json.dumps({
            "lm_bucket": name, "elements": big_n, "peers": 1, "bits": bits, "ms": ms,
            "bound_ms": b_ms, "bound_by": b_by, "x_bound": ms / b_ms, "bytes": nbytes,
            "card": card}))
    del bg, be, c_big, big_rand, big_words, big_resid, big_w3
    torch.cuda.empty_cache()

    # K10 and K1 at the main path's bucket (smallnet, 206,922 elements) as
    # the sync launches them: on the 8 peers' flat buckets, the EF rows
    # the rows of one (8, 206,922) state (every other one 8 bytes off a
    # 16-byte boundary); L2-resident, as right after the backward pass
    sg = [heavy(SLICE_N, 1e-3) for _ in range(PEERS)]
    sstate = heavy(PEERS * SLICE_N, 1e-4).reshape(PEERS, SLICE_N)
    sg2, se2 = [to2d(x) for x in sg], [to2d(x) for x in sstate]
    for name, fn, plain_fn, calls, plain_calls, nbytes in (
            ("stats.bucket_stats_2d", kstats.bucket_stats_flat, ref.bucket_stats,
             [(x, SLICE_N) for x in sg], [(x, SLICE_N) for x in sg2], 4 * SLICE_N + tile),
            ("encode_fused.ef_correct_stats_2d", kenc.ef_correct_stats_flat,
             ref.ef_correct_stats, [(x, sstate[p], SLICE_N) for p, x in enumerate(sg)],
             [(x, y, SLICE_N) for x, y in zip(sg2, se2)], 12 * SLICE_N + tile)):
        ms = graph_ms(fn, calls)
        b_ms, b_by = bound(nbytes)
        print("[time] " + json.dumps({
            "main_path_bucket": name, "elements": SLICE_N, "ms": ms,
            "plain_ms": eager_ms(plain_fn, plain_calls[:2]), "bound_ms": b_ms, "bound_by": b_by,
            "x_bound": ms / b_ms, "bytes": nbytes, "launches_per_step": per_step[name],
            "card": card}))

    # K2-K9 at the shapes the main path launches them at: smallnet's
    # bucket (206,922 elements: the faithful mode encodes it with K2/K3 and
    # decodes the 8 peers' wires with K4/K5) and its two_phase chunk
    # (25,888: K4/K5 decode the 8 peers' chunk wires, K6/K7 re-encode a
    # chunk mean, K8/K9 decode the 8 re-encoded chunks); L2-resident, as on
    # the path; each kernel beside the serial body it replaced, in turns,
    # and each encode also through the flat entry on the rows of a stacked
    # (8, n) tensor, as the path hands it the peers' buckets (at the
    # bucket every other row lies 8 bytes off a 16-byte boundary)
    # (and the per-leaf two_phase chunk of smallnet's largest leaf: 200,704
    # elements over 8 peers, 25,088 a row: K6/K7 encode it, K4/K5 decode 8
    # peers' rows, K8/K9 the 8 re-encoded chunks)
    tp_chunk = chunk(cfg3, SLICE_N, PEERS)
    for shape, sn in (("bucket", SLICE_N), ("two_phase_chunk", tp_chunk),
                      ("per_leaf_chunk", 200_704 // PEERS)):
        srows = -(-sn // 128)
        stacked = heavy(PEERS * sn, 1e-3).reshape(PEERS, sn)
        sc = [to2d(x) for x in stacked]
        srand = [prng.uniform(prng.key(200 + p), (srows, 128), device=dev) for p in range(PEERS)]
        slv = [plan_levels(x, sn, bits) for x in sc]
        sal = [plan(x, sn, bits, "tqsgd").alpha.reshape(1).contiguous() for x in sc]
        cenc = [(x, r, lv, sn, bits) for x, r, lv in zip(sc, srand, slv)]
        uenc = [(x, r, a, sn, bits) for x, r, a in zip(sc, srand, sal)]
        cw3 = torch.stack([kenc.codebook_encode_pack_2d(*a) for a in cenc]).contiguous()
        uw3 = torch.stack([kenc.uniform_encode_pack_2d(*a) for a in uenc]).contiguous()
        slv2, sal1 = torch.stack(slv).contiguous(), torch.cat(sal)
        cdec = [(cw3.clone(), slv2, bits) for _ in range(PEERS)]
        udec = [(uw3.clone(), sal1, bits) for _ in range(PEERS)]
        swb = srows * 4 * bits * 4
        for name, fn, plain_fn, calls, nbytes, serial in (
                ("encode_fused.codebook_encode_pack_resid_2d", kenc.codebook_encode_pack_resid_2d,
                 ref.codebook_encode_pack_residual, cenc, 3 * 4 * sn + lvb + swb,
                 serial_encode(False, True)),
                ("encode_fused.uniform_encode_pack_resid_2d", kenc.uniform_encode_pack_resid_2d,
                 ref.uniform_encode_pack_residual, uenc, 3 * 4 * sn + 4 + swb,
                 serial_encode(True, True)),
                ("encode_fused.codebook_encode_pack_2d", kenc.codebook_encode_pack_2d,
                 ref.codebook_encode_pack, cenc, 2 * 4 * sn + lvb + swb,
                 serial_encode(False, False)),
                ("encode_fused.uniform_encode_pack_2d", kenc.uniform_encode_pack_2d,
                 ref.uniform_encode_pack, uenc, 2 * 4 * sn + 4 + swb,
                 serial_encode(True, False)),
                ("decode.codebook_decode_reduce_3d", kdec.codebook_decode_reduce_3d,
                 ref.codebook_decode_reduce, cdec, PEERS * (swb + lvb) + 4 * sn,
                 serial_body(False, True)),
                ("decode.uniform_decode_reduce_3d", kdec.uniform_decode_reduce_3d,
                 ref.uniform_decode_reduce, udec, PEERS * (swb + 4) + 4 * sn,
                 serial_body(True, True)),
                ("decode.codebook_decode_rows_3d", kdec.codebook_decode_rows_3d,
                 ref.codebook_decode_rows, cdec, PEERS * (swb + lvb + 4 * sn),
                 serial_body(False, False)),
                ("decode.uniform_decode_rows_3d", kdec.uniform_decode_rows_3d,
                 ref.uniform_decode_rows, udec, PEERS * (swb + 4 + 4 * sn),
                 serial_body(True, False))):
            new_ms, old_ms = in_turns(fn, serial, calls)
            ms, extra = new_ms[0], {"ms_turns": new_ms, "serial_body_ms_turns": old_ms}
            if name.startswith("encode_fused."):
                extra["flat_entry_ms"] = graph_ms(
                    lambda x, r, meta, n_, b: kenc.encode_flat(fn, x, n_, r, meta, b),
                    [(stacked[p],) + a[1:] for p, a in enumerate(calls)])
            b_ms, b_by = bound(nbytes)
            print("[time] " + json.dumps({
                "main_path_shape": shape, "kernel": name, "elements": sn, "peers": PEERS,
                "bits": bits, "ms": ms, "plain_ms": eager_ms(plain_fn, calls[:2]),
                "bound_ms": b_ms, "bound_by": b_by, "x_bound": ms / b_ms, "bytes": nbytes,
                "launches_per_step": per_step[name], "card": card, **extra}))

    # K12 and K14 at each of smallnet's leaf sizes, the shapes the
    # per-tensor path launches them at (each size 8 launches a round, one
    # per client): L2-resident, as right after the backward pass
    for leaf in sorted({math.prod(sh) for sh in SMALLNET_SHAPES}):
        frows = -(-leaf // 128)
        fg = [to2d(heavy(leaf, 1e-3)) for _ in range(PEERS)]
        fr = [prng.uniform(prng.key(100 + p), (frows, 128), device=dev) for p in range(PEERS)]
        fa = [plan(x, leaf, bits, "tqsgd").alpha.reshape(1).contiguous() for x in fg]
        fl = [plan_levels(x, leaf, bits) for x in fg]
        for name, fn, plain_fn, calls, nbytes in (
                ("quantize.uniform_encode_2d", kq.uniform_encode_2d, ref.uniform_encode,
                 [(x, r, a, bits) for x, r, a in zip(fg, fr, fa)], 12 * frows * 128 + 4),
                ("quantize.codebook_encode_2d", kq.codebook_encode_2d, ref.codebook_encode,
                 [(x, r, lv) for x, r, lv in zip(fg, fr, fl)], 12 * frows * 128 + lvb)):
            ms = graph_ms(fn, calls)
            b_ms, b_by = bound(nbytes)
            print("[time] " + json.dumps({
                "per_tensor_leaf": name, "elements": leaf, "rows": frows, "bits": bits,
                "ms": ms, "plain_ms": eager_ms(plain_fn, calls[:2]), "bound_ms": b_ms,
                "bound_by": b_by, "x_bound": ms / b_ms, "bytes": nbytes,
                "launches_per_round": PEERS, "card": card}))

    # K16 and K17 at smallnet's largest leaf (200,704 elements, 1,568 rows),
    # 8 distinct inputs, L2-resident; also through the flat entry that
    # kernels.ops launches on the unpadded tensor.  No path launches them.
    leaf, frows = 200_704, 200_704 // 128
    fg = [heavy(leaf, 1e-3) for _ in range(PEERS)]
    fr = [prng.uniform(prng.key(400 + p), (frows, 128), device=dev) for p in range(PEERS)]
    fwb = frows * 4 * bits * 4
    for name, fn, plain_fn, metas, nbytes in (
            ("quantize.uniform_encode_pack_2d", kq.uniform_encode_pack_2d,
             ref.uniform_encode_pack_codes,
             [plan(to2d(x), leaf, bits, "tqsgd").alpha.reshape(1).contiguous() for x in fg],
             12 * leaf + 4 + 4 + fwb),
            ("quantize.codebook_encode_pack_2d", kq.codebook_encode_pack_2d,
             ref.codebook_encode_pack_codes, [plan_levels(to2d(x), leaf, bits) for x in fg],
             12 * leaf + lvb + 4 + fwb)):
        calls = [(x.view(frows, 128), r, meta, leaf, bits) for x, r, meta in zip(fg, fr, metas)]
        ms = graph_ms(fn, calls)
        b_ms, b_by = bound(nbytes)
        print("[time] " + json.dumps({
            "per_tensor_leaf": name, "elements": leaf, "rows": frows, "bits": bits, "ms": ms,
            "flat_entry_ms": graph_ms(lambda x, r, meta, n_, b: kenc.encode_flat(
                fn, x.reshape(-1), n_, r, meta, b), calls),
            "plain_ms": eager_ms(plain_fn, calls[:2]), "bound_ms": b_ms, "bound_by": b_by,
            "x_bound": ms / b_ms, "bytes": nbytes, "launches_per_round": 0, "card": card}))

    # the segmented K14 as the per-tensor path launches it: one launch over
    # a client's eight leaf tiles (1,620 rows), the 8 clients' sets on
    # distinct inputs, L2-resident; beside the same client's eight one-tile
    # launches on the same inputs
    leaf_sets = []
    for c in range(PEERS):
        lg = [to2d(heavy(leaf, 1e-3)) for leaf in leaf_sizes]
        lr = [prng.uniform(prng.key(300 + 8 * c + j), x.shape, device=dev)
              for j, x in enumerate(lg)]
        leaf_sets.append((lg, lr, [plan_levels(x, leaf, bits) for x, leaf in zip(lg, leaf_sizes)]))
    seg_rows = sum(x.shape[0] for x in leaf_sets[0][0])
    seg_bytes = 12 * seg_rows * 128 + sum(4 * lv.numel() for lv in leaf_sets[0][2])
    seg_ms = graph_ms(kq.codebook_encode_segments, leaf_sets)
    b_ms, b_by = bound(seg_bytes)
    print("[time] " + json.dumps({
        "segmented_k14": "quantize.codebook_encode_segments", "tiles": len(leaf_sizes),
        "rows": seg_rows, "bits": bits, "ms": seg_ms,
        "eight_launches_ms": len(leaf_sizes) * graph_ms(
            kq.codebook_encode_2d, [t for lg, lr, ll in leaf_sets for t in zip(lg, lr, ll)]),
        "plain_ms": eager_ms(ref.codebook_encode_segments, leaf_sets[:2]), "bound_ms": b_ms,
        "bound_by": b_by, "x_bound": seg_ms / b_ms, "bytes": seg_bytes,
        "launches_per_round": PEERS, "card": card}))

    # the segmented K12 as the per-tensor tqsgd round launches it, on the
    # same leaf tiles with each tile's plan α
    uleaf_sets = [(lg, lr, [plan(x, leaf, bits, "tqsgd").alpha.reshape(1).contiguous()
                            for x, leaf in zip(lg, leaf_sizes)], [bits] * len(lg))
                  for lg, lr, _ in leaf_sets]
    useg_bytes = 12 * seg_rows * 128 + 4 * len(leaf_sizes)
    useg_ms = graph_ms(kq.uniform_encode_segments, uleaf_sets)
    b_ms, b_by = bound(useg_bytes)
    print("[time] " + json.dumps({
        "segmented_k12": "quantize.uniform_encode_segments", "tiles": len(leaf_sizes),
        "rows": seg_rows, "bits": bits, "ms": useg_ms,
        "eight_launches_ms": len(leaf_sizes) * graph_ms(
            kq.uniform_encode_2d, [t for lg, lr, la, lb in uleaf_sets
                                   for t in zip(lg, lr, la, lb)]),
        "plain_ms": eager_ms(ref.uniform_encode_segments, uleaf_sets[:2]), "bound_ms": b_ms,
        "bound_by": b_by, "x_bound": useg_ms / b_ms, "bytes": useg_bytes,
        "launches_per_round": PEERS, "card": card}))

    # K11 at the P factors of smallnet's bucket, of the mixed plan's
    # 200,704-element bucket (matrix_shape = (784, 256)) and of a full 4 MB
    # bucket ((1024, 1024)), rank 4: the register path the wrapper picks,
    # beside the global-memory path (the working factor in the output
    # buffer, as the kernel kept it before) on the same inputs
    for frows, fr in ((809, 4), (784, 4), (1024, 4)):
        gs_f = [torch.randn(frows, fr, generator=gen, device=dev) for _ in range(PEERS)]
        f_bound, f_by = bound(gs_bytes(frows, fr), gs_flops(frows, fr))
        ms = graph_ms(korth.orthogonalize_2d, [(x,) for x in gs_f])
        print("[time] " + json.dumps({
            "k11_factor": [frows, fr], "ms": ms,
            "global_path_ms": graph_ms(lambda x: korth._launch(x, False),
                                       [(x,) for x in gs_f]),
            "plain_ms": eager_ms(ref.orthogonalize, [(x,) for x in gs_f[:2]]),
            "library_ms": eager_ms(lambda x: torch.linalg.qr(x, mode="reduced"),
                                   [(x,) for x in gs_f]),
            "bound_ms": f_bound, "bound_by": f_by, "x_bound": ms / f_bound,
            "bytes": gs_bytes(frows, fr), "flops": gs_flops(frows, fr),
            "library": "torch.linalg.qr", "card": card}))

    # the phase-2 sites: 8 peers x 131,072-element chunks of one 4 MB bucket
    # (one chunk per encode, all 8 chunks per rows decode); likely launch-bound
    cn, crows = n // PEERS, rows // PEERS
    chunk = [(fi["c"][p][j * crows:(j + 1) * crows], rand[p][j * crows:(j + 1) * crows])
             for p in range(PEERS) for j in range(PEERS)]
    cw3 = [fi["words3"][:, j * crows:(j + 1) * crows].contiguous() for j in range(PEERS)]
    uw3 = [fi["uwords3"][:, j * crows:(j + 1) * crows].contiguous() for j in range(PEERS)]
    cwb = crows * 4 * bits * 4
    chunk_spec = {
        "encode_fused.codebook_encode_pack_2d": (kenc.codebook_encode_pack_2d,
                                    [(c, r, fi["levels"][0], cn, bits) for c, r in chunk],
                                    2 * 4 * cn + 4 * (2**bits) + cwb),
        "encode_fused.uniform_encode_pack_2d": (kenc.uniform_encode_pack_2d,
                                   [(c, r, fi["alphas"][0], cn, bits) for c, r in chunk],
                                   2 * 4 * cn + 4 + cwb),
        "decode.codebook_decode_reduce_3d": (kdec.codebook_decode_reduce_3d,
                                      [(w, fi["levels2"], bits) for w in cw3],
                                      PEERS * cwb + PEERS * 4 * (2**bits) + 4 * cn),
        "decode.uniform_decode_reduce_3d": (kdec.uniform_decode_reduce_3d,
                                     [(w, fi["alphas1"], bits) for w in uw3],
                                     PEERS * cwb + PEERS * 4 + 4 * cn),
        "decode.codebook_decode_rows_3d": (kdec.codebook_decode_rows_3d,
                                    [(w, fi["levels2"], bits) for w in cw3],
                                    PEERS * cwb + PEERS * 4 * (2**bits) + PEERS * 4 * cn),
        "decode.uniform_decode_rows_3d": (kdec.uniform_decode_rows_3d,
                                   [(w, fi["alphas1"], bits) for w in uw3],
                                   PEERS * cwb + PEERS * 4 + PEERS * 4 * cn),
    }
    for name, (fn, calls, nbytes) in chunk_spec.items():
        print("[time] " + json.dumps({
            "chunk_site": name, "elements_per_chunk": cn, "peers": PEERS, "bits": bits,
            "ms": graph_ms(fn, calls), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes, "card": card}))

    # the synced step: 8 peers' smallnet gradients through each sync mode
    leaves = [heavy(PEERS * math.prod(s), 1e-3).reshape(PEERS, *s) for s in SMALLNET_SHAPES]
    key = prng.fold_in(prng.key(0x5EED), 0)
    for sync, dp, method, ef_on in (("faithful", (PEERS,), "tnqsgd", False),
                                    ("faithful", (PEERS,), "tnqsgd", True),
                                    ("two_phase", (PEERS,), "tnqsgd", False),
                                    ("two_phase", (PEERS,), "tnqsgd", True),
                                    ("hierarchical", (2, PEERS // 2), "tnqsgd", False),
                                    ("faithful", (PEERS,), "tqsgd", False),
                                    ("two_phase", (PEERS,), "tqsgd", False),
                                    ("faithful", (PEERS,), "powersgd", True)):
        ts = TrainStepConfig(sync=sync, error_feedback=ef_on,
                             compressor=CompressorConfig(method=method, bits=3))
        ef = None
        if ef_on:   # the powersgd row carries its Q factor after the residual
            ef = [torch.zeros((PEERS, m), device=dev)
                  for m in kcodecs.bucket_state_sizes(ts.compressor, [SLICE_N])]
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reference_sync_state(ts, leaves, dp, key, ef=ef)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print("[time] " + json.dumps({"synced_step_ms": statistics.median(walls[1:]),
                                      "runs_ms": walls[1:], "sync": sync, "dp_sizes": dp,
                                      "method": method, "error_feedback": ef_on,
                                      "peers": PEERS, "elements": SLICE_N, "card": card}))

    # where the synced step's time goes, phase by phase (host clock, synchronized)
    cfg = CompressorConfig(method="tnqsgd", bits=3)
    codec = get_codec("tnqsgd")
    flats = [torch.cat([x[p].reshape(-1) for x in leaves]) for p in range(PEERS)]

    def phase(fn, reps=5) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    stats = [ops.bucket_stats(f) for f in flats]
    plans = [codec.plan(cfg, f, tuple(s)) for f, s in zip(flats, stats)]
    wires = [codec.encode_residual(cfg, f, pl, prng.key(p))[0] for p, (f, pl) in
             enumerate(zip(flats, plans))]
    breakdown = {
        "stats_K10_x8": phase(lambda: [ops.bucket_stats(f) for f in flats]),
        "plan_x8": phase(lambda: [codec.plan(cfg, f, tuple(s)) for f, s in zip(flats, stats)]),
        "rand_draw_x8": phase(lambda: [prng.uniform(prng.key(p), (-(-SLICE_N // 128), 128),
                                                    device=dev)
                                       for p in range(PEERS)]),
        "encode_K2_with_rand_x8": phase(lambda: [codec.encode_residual(cfg, f, pl, prng.key(p))
                                                 for p, (f, pl) in enumerate(zip(flats, plans))]),
        "decode_K4_x1": phase(lambda: codec.decode_reduce(cfg, torch.stack(wires), SLICE_N)),
    }
    print("[time] " + json.dumps({"synced_step_breakdown_ms": breakdown, "card": card}))

    # the faithful powersgd step (rank 4, EF on, a warm start), phase by phase
    from repro_torch.core import lowrank

    pcfg = CompressorConfig(method="powersgd", rank=4)
    pcodec = get_codec("powersgd")
    prows, pcols = lowrank.matrix_shape(SLICE_N)
    resid = [heavy(SLICE_N, 1e-4) for _ in range(PEERS)]
    corrected = [ops.ef_correct_stats(f, e)[0] for f, e in zip(flats, resid)]
    aux = [heavy(pcols * 4, 1.0) for _ in range(PEERS)]
    mats = []
    for c in corrected:
        m_ = torch.zeros(prows * pcols, device=dev)
        m_[:SLICE_N] = c
        mats.append(m_.reshape(prows, pcols))
    ps = [m_ @ a.reshape(pcols, 4) for m_, a in zip(mats, aux)]
    phats = [ops.orthogonalize(x) for x in ps]
    pwires = [pcodec.encode_residual(pcfg, c, None, None, a)[0] for c, a in zip(corrected, aux)]
    pbreak = {
        "ef_correct_K1_x8": phase(lambda: [ops.ef_correct_stats(f, e) for f, e in zip(flats, resid)]),
        "matmul_P_x8": phase(lambda: [m_ @ a.reshape(pcols, 4) for m_, a in zip(mats, aux)]),
        "orthogonalize_K11_x8": phase(lambda: [ops.orthogonalize(x) for x in ps]),
        "matmul_Qn_own_x8": phase(lambda: [(ph @ (m_.T @ ph).T) for m_, ph in zip(mats, phats)]),
        "encode_residual_x8": phase(lambda: [pcodec.encode_residual(pcfg, c, None, None, a)
                                             for c, a in zip(corrected, aux)]),
        "decode_x1": phase(lambda: pcodec.decode_reduce(pcfg, torch.stack(pwires), SLICE_N)),
    }
    print("[time] " + json.dumps({"powersgd_step_breakdown_ms": pbreak, "card": card}))

    # one per-tensor round's compression (train_clients, tnqsgd, 3 bits,
    # use_pallas): 8 clients x smallnet's 8 leaves, phase by phase; the
    # encode both per leaf (64 K14 launches) and per client (8 segmented
    # launches, as train_clients now runs it)
    tcfg = CompressorConfig(method="tnqsgd", bits=3, use_pallas=True)
    tleaves = [[heavy(math.prod(s), 1e-3).reshape(s) for s in SMALLNET_SHAPES]
               for _ in range(PEERS)]
    tkeys = [[prng.fold_in(prng.key(c), j) for j in range(len(SMALLNET_SHAPES))]
             for c in range(PEERS)]
    tmetas = [[compressors.plan(tcfg, x) for x in ls] for ls in tleaves]
    umetas = [[compressors.plan(CompressorConfig(method="tqsgd", bits=3), x) for x in ls]
              for ls in tleaves]
    tcodes = [[ops.codebook_encode(x.reshape(-1), m.levels, k) for x, m, k in zip(ls, ms, ks)]
              for ls, ms, ks in zip(tleaves, tmetas, tkeys)]
    twires = [[pack_codes(c8, 3) for c8 in cs] for cs in tcodes]
    tbreak = {
        "plan_x64": phase(lambda: [[compressors.plan(tcfg, x) for x in ls] for ls in tleaves], 3),
        "encode_K14_with_rand_x64": phase(lambda: [
            [ops.codebook_encode(x.reshape(-1), m.levels, k) for x, m, k in zip(ls, ms, ks)]
            for ls, ms, ks in zip(tleaves, tmetas, tkeys)], 3),
        "encode_K14_with_rand_x8": phase(lambda: [
            ops.codebook_encode_leaves([x.reshape(-1) for x in ls], [m.levels for m in ms], ks)
            for ls, ms, ks in zip(tleaves, tmetas, tkeys)], 3),
        "pack_x64": phase(lambda: [[pack_codes(c8, 3) for c8 in cs] for cs in tcodes], 3),
        "decode_x64": phase(lambda: [
            [compressors.decode(tcfg, w, m, tuple(x.shape)) for w, m, x in zip(ws, ms, ls)]
            for ws, ms, ls in zip(twires, tmetas, tleaves)], 3),
        "compress_decompress_x64": phase(lambda: [
            [compressors.compress_decompress(tcfg, x, k) for x, k in zip(ls, ks)]
            for ls, ks in zip(tleaves, tkeys)], 3),
        "compress_decompress_leaves_x8": phase(lambda: [
            compressors.compress_decompress_leaves([tcfg] * len(ls), ls, ks)
            for ls, ks in zip(tleaves, tkeys)], 3),
        # tqsgd's encode: per leaf (64 K12 launches) and per client (8
        # segmented launches, as train_clients runs it)
        "tqsgd_encode_K12_with_rand_x64": phase(lambda: [
            [ops.uniform_encode(x.reshape(-1), m.alpha, 3, k) for x, m, k in zip(ls, ms, ks)]
            for ls, ms, ks in zip(tleaves, umetas, tkeys)], 3),
        "tqsgd_encode_K12_with_rand_x8": phase(lambda: [
            ops.uniform_encode_leaves([x.reshape(-1) for x in ls], [m.alpha for m in ms],
                                      [3] * len(ls), ks)
            for ls, ms, ks in zip(tleaves, umetas, tkeys)], 3),
    }
    print("[time] " + json.dumps({"per_tensor_round_breakdown_ms": tbreak, "card": card}))

    print(f"[time] whole script {time.time() - t_script:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
