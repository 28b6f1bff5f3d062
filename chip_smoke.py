#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with ``python3 chip_smoke.py``; it needs one
CUDA card, ``nvcc`` and no JAX.  Phases, each fatal on failure:

1. card: print ``nvidia-smi``'s name and power limit, require CUDA;
2. build: compile every kernel of the main path from ``csrc/`` and print
   the ``-Xptxas -v`` register and shared-memory report;
3. kernel parity: each kernel against its plain PyTorch version on the card
   on identical inputs, at the slice's bucket (206,922 elements), a full
   4 MB bucket (1,048,576) and a ragged size, 8 peers, 1, 3 and 8 bits;
4. main path: the paper's 8-client smallnet training through
   ``repro_torch.train.train_synced`` (faithful tnqsgd at 3 bits, EF off and
   on, the EF-on run twice to show it repeats bit for bit), held to the JAX
   package's golden windows, with every kernel's launch count read around
   each run;
5. times: every kernel and its plain version at the 4 MB x 8-peer shape,
   beside its byte bound, and the synced step's wall time.

The second-to-last line is the per-kernel JSON record, the last line the
device record.
"""
from __future__ import annotations

import json
import math
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
STATS_RTOL = 1e-5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
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

    # -- 3. kernel parity -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1234)

    def heavy(n: int, scale: float) -> torch.Tensor:
        z = torch.randn(n, generator=gen, device=dev)
        return scale * z * torch.exp(torch.randn(n, generator=gen, device=dev))

    def to2d(x: torch.Tensor) -> torch.Tensor:
        return ops._to_2d(x)[0]

    def plan_levels(g2: torch.Tensor, n: int, bits: int) -> torch.Tensor:
        st = ref.bucket_stats(g2, n)
        return plan_from_stats(CompressorConfig(bits=bits), st[0], st[1], st[2, 0]).levels

    def stats_err(got, want, x2, n, what):
        check(torch.equal(got[0], want[0]), f"{what}: histogram counts differ")
        check(torch.equal(got[2], want[2]), f"{what}: max differs")
        check(float(got[0].sum()) == n, f"{what}: counts sum {float(got[0].sum())} != {n}")
        absx = torch.abs(x2.reshape(-1)[:n])
        for row, scale in ((1, torch.abs(want[1])), (3, absx.sum()), (4, want[4])):
            d = torch.abs(got[row] - want[row])
            check(bool((d <= STATS_RTOL * scale).all()),
                  f"{what}: row {row} beyond rtol {STATS_RTOL} (max diff {float(d.max())})")
        return float(torch.abs(got - want).max())

    max_err = {k.__name__: 0.0 for k in kernels.KERNELS}
    cases = [(SLICE_N, 3), (FULL_N, 3), (FULL_N, 8), (RAGGED_N, 1), (RAGGED_N, 8)]
    full_inputs = None
    for n, bits in cases:
        g = [to2d(heavy(n, 1e-3)) for _ in range(PEERS)]
        e = [to2d(heavy(n, 1e-4)) for _ in range(PEERS)]
        words, levels = [], []
        for p in range(PEERS):
            s10 = kstats.bucket_stats_2d(g[p], n)
            c, s1 = kenc.ef_correct_stats_2d(g[p], e[p], n)
            # a second launch on the same input must agree bit for bit
            check(torch.equal(kstats.bucket_stats_2d(g[p], n), s10),
                  f"K10 not deterministic at n={n}")
            c2, s1b = kenc.ef_correct_stats_2d(g[p], e[p], n)
            check(torch.equal(c2, c) and torch.equal(s1b, s1), f"K1 not deterministic at n={n}")
            err = stats_err(s10, ref.bucket_stats(g[p], n), g[p], n, f"K10 n={n}")
            max_err["bucket_stats_2d"] = max(max_err["bucket_stats_2d"], err)
            c_ref, s1_ref = ref.ef_correct_stats(g[p], e[p], n)
            check(torch.equal(c, c_ref), f"K1 corrected bucket differs at n={n}")
            err = stats_err(s1, s1_ref, c, n, f"K1 n={n}")
            max_err["ef_correct_stats_2d"] = max(max_err["ef_correct_stats_2d"], err)
            lv = plan_levels(c, n, bits)
            rand = prng.uniform(prng.key(1000 * p + bits), c.shape, device=dev)
            w, r = kenc.codebook_encode_pack_resid_2d(c, rand, lv, n, bits)
            w_ref, r_ref = ref.codebook_encode_pack_residual(c, rand, lv, n, bits)
            check(torch.equal(w, w_ref), f"K2 words differ at n={n} bits={bits}")
            check(torch.equal(r, r_ref), f"K2 residual differs at n={n} bits={bits}")
            words.append(w)
            levels.append(lv)
        words3 = torch.stack(words).contiguous()
        levels2 = torch.stack(levels).contiguous()
        mean = kdec.codebook_decode_reduce_3d(words3, levels2, bits)
        check(torch.equal(mean, ref.codebook_decode_reduce(words3, levels2, bits)),
              f"K4 mean differs at n={n} bits={bits}")
        torch.cuda.synchronize()
        print(f"[parity] n={n} bits={bits} peers={PEERS}: K1, K10 counts/max exact, sums within "
              f"rtol {STATS_RTOL}, bitwise deterministic; K2 words+residual and K4 mean bitwise")
        if (n, bits) == (FULL_N, 3):
            full_inputs = dict(g=g, e=e, c=[to2d(heavy(n, 1e-3)) for _ in range(PEERS)],
                               levels=levels, words3=words3, levels2=levels2)

    # -- 4. main path -----------------------------------------------------
    from repro_torch.train import train_synced

    runs = {}
    launches = {k.__name__: 0 for k in kernels.KERNELS}
    # the EF-on run twice: the loss history must repeat bit for bit
    for label, ef in (("faithful_ef_off", False), ("faithful_ef_on", True),
                      ("faithful_ef_on_again", True)):
        kernels.reset_launch_counts()
        t0 = time.time()
        hist = train_synced(sync="faithful", method="tnqsgd", bits=3, error_feedback=ef,
                            steps=30, n_clients=PEERS, batch=32, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        if label != "faithful_ef_on_again":
            for k, v in counts.items():
                launches[k] += v
        runs[label] = dict(hist=hist, counts=counts, wall=wall)
        check(all(math.isfinite(x) for x in hist), f"{label}: non-finite loss {hist}")
        print(f"[golden] {label}: first {hist[0]:.6f} last {hist[-1]:.6f} "
              f"({len(hist)} steps, {wall:.2f} s) launches {json.dumps(counts)}")
        print(f"[golden] {label} losses {json.dumps(hist)}")
    off, on = runs["faithful_ef_off"], runs["faithful_ef_on"]
    check(abs(off["hist"][0] - 6.4895) <= 1e-3, f"EF-off first-step loss {off['hist'][0]}")
    check(abs(off["hist"][-1] - 0.0162) <= 0.05, f"EF-off final loss {off['hist'][-1]}")
    check(on["hist"][-1] < on["hist"][0] - 5.0, f"EF-on did not converge: {on['hist']}")
    check(runs["faithful_ef_on_again"]["hist"] == on["hist"],
          "EF-on loss history differs between two runs of the same seeds")
    print("[golden] faithful_ef_on repeats bit for bit")
    check(off["counts"]["bucket_stats_2d"] > 0 and off["counts"]["ef_correct_stats_2d"] == 0,
          "EF-off run must go through K10 and not K1")
    check(on["counts"]["ef_correct_stats_2d"] > 0, "EF-on run must go through K1")
    for label in runs:
        for k in ("codebook_encode_pack_resid_2d", "codebook_decode_reduce_3d"):
            check(runs[label]["counts"][k] > 0, f"{label}: {k} never launched")

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

    fi = full_inputs
    n, bits, rows = FULL_N, 3, -(-FULL_N // 128)
    rand = [prng.uniform(prng.key(p), (rows, 128), device=dev) for p in range(PEERS)]
    wbytes = rows * 4 * bits * 4
    tile = 8 * 128 * 4
    spec = {
        "ef_correct_stats_2d": dict(
            fn=kenc.ef_correct_stats_2d, plain=ref.ef_correct_stats,
            calls=[(fi["g"][p], fi["e"][p], n) for p in range(PEERS)],
            bytes=3 * 4 * n + tile, source="src/repro_torch/kernels/csrc/stats.cu",
            replaces="src/repro/kernels/encode_fused.py:90"),
        "bucket_stats_2d": dict(
            fn=kstats.bucket_stats_2d, plain=ref.bucket_stats,
            calls=[(x, n) for x in fi["g"] + fi["e"] + fi["c"]],
            bytes=4 * n + tile, source="src/repro_torch/kernels/csrc/stats.cu",
            replaces="src/repro/kernels/stats.py:106"),
        "codebook_encode_pack_resid_2d": dict(
            fn=kenc.codebook_encode_pack_resid_2d, plain=ref.codebook_encode_pack_residual,
            calls=[(fi["c"][p], rand[p], fi["levels"][p], n, bits) for p in range(PEERS)],
            bytes=2 * 4 * n + 4 * (2**bits) + wbytes + 4 * n,
            source="src/repro_torch/kernels/csrc/encode_fused.cu",
            replaces="src/repro/kernels/encode_fused.py:215"),
        "codebook_decode_reduce_3d": dict(
            fn=kdec.codebook_decode_reduce_3d, plain=ref.codebook_decode_reduce,
            calls=[(fi["words3"].clone(), fi["levels2"], bits) for _ in range(8)],
            bytes=PEERS * wbytes + PEERS * 4 * (2**bits) + 4 * n,
            source="src/repro_torch/kernels/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:165"),
    }
    per_step = {k: max(r["counts"][k] / len(r["hist"]) for r in runs.values()) for k in launches}
    records = []
    for name, sp in spec.items():
        ms = graph_ms(sp["fn"], sp["calls"])
        plain_ms = eager_ms(sp["plain"], sp["calls"][:2])
        bound_ms = sp["bytes"] / HBM_BYTES_PER_S * 1e3
        rec = {"name": name, "route": "cuda", "source": sp["source"],
               "replaces": sp["replaces"], "launches": launches[name],
               "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
        records.append(rec)
        print("[time] " + json.dumps(dict(rec, bytes=sp["bytes"], launches_per_step=per_step[name],
                                          library="none", card=card)))

    # the synced step: 8 peers' smallnet gradients through the faithful sync
    from repro_torch.core.codecs import get_codec
    from repro_torch.dist.reference import reference_sync_state
    from repro_torch.dist.train_step import TrainStepConfig

    shapes = [(16,), (3, 3, 1, 16), (32,), (3, 3, 16, 32), (128,), (1568, 128), (10,), (128, 10)]
    leaves = [heavy(PEERS * math.prod(s), 1e-3).reshape(PEERS, *s) for s in shapes]
    key = prng.fold_in(prng.key(0x5EED), 0)
    for ef_on in (False, True):
        ts = TrainStepConfig(sync="faithful", error_feedback=ef_on,
                             compressor=CompressorConfig(method="tnqsgd", bits=3))
        ef = [torch.zeros((PEERS, SLICE_N), device=dev)] if ef_on else None
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reference_sync_state(ts, leaves, (PEERS,), key, ef=ef)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print("[time] " + json.dumps({"synced_step_ms": statistics.median(walls[1:]),
                                      "runs_ms": walls[1:], "error_feedback": ef_on,
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
    srows = -(-SLICE_N // 128)
    breakdown = {
        "stats_K10_x8": phase(lambda: [ops.bucket_stats(f) for f in flats]),
        "plan_x8": phase(lambda: [codec.plan(cfg, f, tuple(s)) for f, s in zip(flats, stats)]),
        "rand_draw_x8": phase(lambda: [prng.uniform(prng.key(p), (srows, 128), device=dev)
                                       for p in range(PEERS)]),
        "encode_K2_with_rand_x8": phase(lambda: [codec.encode_residual(cfg, f, pl, prng.key(p))
                                                 for p, (f, pl) in enumerate(zip(flats, plans))]),
        "decode_K4_x1": phase(lambda: codec.decode_reduce(cfg, torch.stack(wires), SLICE_N)),
    }
    print("[time] " + json.dumps({"synced_step_breakdown_ms": breakdown, "card": card}))

    print(card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
