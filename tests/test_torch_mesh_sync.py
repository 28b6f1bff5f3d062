"""The port's mesh sync (``dist.train_step.make_sync_fn`` over a
``dist.compat.Mesh`` of gloo processes) against its one-device replay
(``dist.reference``), on the CPU.

The cross-mesh sweep of ``tests/test_mesh_invariance.py``: its leaf shapes
(64, 48), (37, 61), (2048,) and (999,) at ``bucket_mb = 1/64`` (three
buckets of 3,072, 2,257 and 3,047 elements), data from a numpy seed,
meshes (1,), (2,), (4,) and (2, 2).  Every mesh runs the four modes in
tnqsgd; the 2-rank mesh runs the full sweep (tqsgd, a mixed plan with a
powersgd bucket and its aux tail, the fp16 tier, EF with telemetry, a live
mask with one rank dropped, ``metrics_compression``, the per-leaf codec in
each mode) and the other meshes one targeted case
each of several (on (2, 2) a whole pod dropped).  One spawn a mesh: each
rank runs every case of its mesh and the port's replay of all ranks
itself, at one thread, and reports per case; each case is a test.

Held, per case:

- every rank's means bitwise every other's;
- each rank's means, EF rows, telemetry row and metrics bitwise its row of
  ``reference_sync_state`` (the per-leaf codec: ``reference_sync``); dsgd
  (gloo owns the order of the sum) within 1e-6;
- a spy on ``compat``'s collectives counts ``Codec.collective_budget(mode,
  n_buckets)`` calls over axes of more than one rank (faithful 1,
  two_phase 2, hierarchical 3, dsgd one ``psum`` a bucket; none on one
  rank), with and without the mask, and each fused wire tensor is as wide
  as the sum of its buckets' ``wire_words`` (``chunk_wire_words`` for the
  two_phase rows).

Also a 2-rank ``train_synced(mesh=...)`` of 3 steps (faithful tnqsgd,
two_phase with EF, faithful with EF under a 50% dropout schedule) whose
loss history is bitwise the one-device ``train_synced`` run in the same
process at one thread.

About 30 s alone in one process: one spawn per mesh (1 + 2 + 4 + 4
processes) and one 2-process spawn for the training runs, each rank at
one thread.
"""
import hashlib
import json
import math
import os
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.adaptive.controller import AdaptiveConfig  # noqa: E402
from repro_torch.adaptive.telemetry import init_telemetry, peer_row, stack_rows  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.codecs import (bucket_cfgs, bucket_state_sizes, get_codec,  # noqa: E402
                                     size_adaptive_plan)
from repro_torch.core.compressors import CompressorConfig, bucket_concat, plan_buckets  # noqa: E402
from repro_torch.dist import compat  # noqa: E402
from repro_torch.dist.reference import reference_sync, reference_sync_state  # noqa: E402
from repro_torch.dist.train_step import (TrainStepConfig, global_norm, init_ef_state,  # noqa: E402
                                          make_sync_fn)
from repro_torch.elastic import ElasticConfig  # noqa: E402

LEAF_SHAPES = [(64, 48), (37, 61), (2048,), (999,)]
BUCKET_MB = 1.0 / 64.0
BP = plan_buckets([math.prod(s) for s in LEAF_SHAPES],
                  TrainStepConfig(bucket_mb=BUCKET_MB).bucket_elements)
MIXED_PLAN = (3, ("powersgd", 4), 2)
MESHES = {"data1": (1,), "data2": (2,), "data4": (4,), "pod2x2": (2, 2)}
DSGD_RTOL = 1e-6


def _cases(mesh_id: str) -> dict:
    """case name -> (TrainStepConfig keywords, live mask or None)."""
    dp = MESHES[mesh_id]
    n = math.prod(dp)
    full = n == 2
    cases = {}

    def add(name, live=None, **kw):
        if live is not None:
            # the schedule only puts the mask in the signature: each case
            # passes its own mask
            kw["elastic"] = ElasticConfig(rate=0.5)
        kw.setdefault("bucket_mb", BUCKET_MB)
        kw.setdefault("compressor", CompressorConfig(method="tnqsgd", bits=3))
        cases[name] = (kw, live)

    for sync in ("dsgd", "two_phase", "hierarchical", "faithful"):
        add(f"bucketed/{sync}/tnqsgd", sync=sync)
    one_dropped = tuple([0.0] + [1.0] * (n - 1)) if n > 1 else None
    if full:
        for sync in ("faithful", "two_phase"):
            add(f"bucketed/{sync}/tqsgd", sync=sync,
                compressor=CompressorConfig(method="tqsgd", bits=4))
            add(f"bucketed/{sync}/mixed_plan_ef", sync=sync, bits_plan=MIXED_PLAN,
                error_feedback=True)
            add(f"bucketed/{sync}/fp16_tier_ef", sync=sync, fp16_threshold=2500,
                error_feedback=True)
            add(f"bucketed/{sync}/ef_telemetry", sync=sync, error_feedback=True,
                adaptive=AdaptiveConfig(ema=0.9))
            add(f"bucketed/{sync}/metrics", sync=sync, error_feedback=True,
                metrics_compression=True)
        for sync in ("dsgd", "faithful", "two_phase"):
            add(f"elastic/{sync}/one_dropped", one_dropped, sync=sync,
                error_feedback=sync != "dsgd", adaptive=None if sync == "dsgd" else
                AdaptiveConfig(ema=0.9))
        add("elastic/faithful/metrics_one_dropped", one_dropped, sync="faithful",
            error_feedback=True, metrics_compression=True)
        for sync in ("dsgd", "faithful", "two_phase", "hierarchical"):
            add(f"per_leaf/{sync}/tnqsgd", sync=sync, bucket_mb=0.0)
    elif mesh_id == "data1":
        add("per_leaf/faithful/tnqsgd", sync="faithful", bucket_mb=0.0)
        add("bucketed/faithful/ef_telemetry", sync="faithful", error_feedback=True,
            adaptive=AdaptiveConfig(ema=0.9))
    elif mesh_id == "data4":
        add("bucketed/two_phase/tqsgd", sync="two_phase",
            compressor=CompressorConfig(method="tqsgd", bits=4))
        add("bucketed/faithful/metrics", sync="faithful", error_feedback=True,
            metrics_compression=True)
        add("elastic/two_phase/one_dropped", one_dropped, sync="two_phase",
            error_feedback=True)
    else:
        add("bucketed/hierarchical/ef_telemetry", sync="hierarchical", error_feedback=True,
            adaptive=AdaptiveConfig(ema=0.9))
        add("bucketed/hierarchical/mixed_plan_ef", sync="hierarchical", bits_plan=MIXED_PLAN,
            error_feedback=True)
        add("bucketed/hierarchical/fp16_tier_ef", sync="hierarchical", fp16_threshold=2500,
            error_feedback=True)
        add("elastic/hierarchical/pod_dropped", (0.0, 0.0, 1.0, 1.0), sync="hierarchical",
            error_feedback=True, adaptive=AdaptiveConfig(ema=0.9))
        add("elastic/hierarchical/one_dropped", one_dropped, sync="hierarchical",
            error_feedback=True)
        add("per_leaf/hierarchical/tnqsgd", sync="hierarchical", bucket_mb=0.0)
    return cases


CASE_IDS = [(m, c) for m in MESHES for c in _cases(m)]


def _inputs(n: int, ts: TrainStepConfig, seed: int = 5):
    """Leaves (n, *shape), EF rows (n, state) and the step key, from a seed."""
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy((0.05 * (i + 1) * rng.standard_normal((n, *s)))
                               .astype(np.float32)) for i, s in enumerate(LEAF_SHAPES)]
    plan = size_adaptive_plan(ts.compressor, ts.bits_plan, BP.sizes, ts.fp16_threshold)
    ef = [torch.from_numpy((0.01 * rng.standard_normal((n, m))).astype(np.float32))
          for m in bucket_state_sizes(ts.compressor, BP.sizes, plan)]
    return leaves, ef, prng.key(123)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _same(got, want, what: str, rtol: float = 0.0) -> None:
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if rtol:
            torch.testing.assert_close(a, b, rtol=rtol, atol=rtol, msg=f"{what} {i}")
        elif not torch.equal(a, b):
            d = float((a - b).abs().max())
            raise AssertionError(f"{what} {i} differs (max abs {d:g})")


def _expected_widths(ts: TrainStepConfig, dp: tuple) -> list:
    """(collective, width) of every call over more than one rank."""
    n = math.prod(dp)
    cfgs = bucket_cfgs(ts.compressor, BP.n_buckets,
                       size_adaptive_plan(ts.compressor, ts.bits_plan, BP.sizes,
                                          ts.fp16_threshold))
    codecs = [get_codec(c.method) for c in cfgs]
    full = sum(cd.wire_words(c, m) for cd, c, m in zip(codecs, cfgs, BP.sizes))
    if n == 1:
        return []
    if ts.sync == "dsgd":
        return [("psum", m) for m in BP.sizes]
    if ts.sync == "faithful":
        return [("all_gather", full)]

    def two_phase(k):
        rows = sum(cd.chunk_wire_words(c, m, k) if cd.chunkable else cd.wire_words(c, m)
                   for cd, c, m in zip(codecs, cfgs, BP.sizes))
        chunks = sum(cd.chunk_wire_words(c, m, k) for cd, c, m in zip(codecs, cfgs, BP.sizes)
                     if cd.chunkable)
        return [("all_to_all", rows)] + ([("all_gather", chunks)] if chunks else [])

    if ts.sync == "two_phase" or len(dp) == 1:
        return two_phase(n)
    return two_phase(dp[-1]) + [("all_gather", full)]


def _install_spy(calls: list) -> None:
    """Record (collective, width) of each compat collective over more than
    one rank (this process is a throwaway rank)."""
    def wrap(name, fn):
        def spy(x, mesh, axis_name):
            if compat.axis_size(mesh, axis_name) > 1:
                calls.append((name, x.shape[-1] if x.dim() else 1))
            return fn(x, mesh, axis_name)
        return spy

    compat.all_gather_stacked = wrap("all_gather", compat.all_gather_stacked)
    compat.all_to_all_rows = wrap("all_to_all", compat.all_to_all_rows)
    compat.psum = wrap("psum", compat.psum)


def _run_case(mesh, rank: int, dp: tuple, kw: dict, live_t, calls: list) -> dict:
    ts = TrainStepConfig(**kw)
    n = math.prod(dp)
    leaves, ef, key = _inputs(n, ts)
    mine = [x[rank] for x in leaves]
    live = None if live_t is None else torch.tensor(live_t, dtype=torch.float32)
    tstate = None
    if ts.adaptive is not None:
        tstate = init_telemetry(BP.n_buckets)
    args = [mine, key]
    if ts.elastic is not None:
        args.append(live)
    if ts.error_feedback:
        args.append(tuple(e[rank] for e in ef))
    if ts.adaptive is not None:
        args.append(tstate)
    calls.clear()
    out = make_sync_fn(ts, mesh, mine)(*args)
    spied = list(calls)
    out = list(out) if isinstance(out, tuple) else [out]
    mean = out.pop(0)
    new_ef = out.pop(0) if ts.error_feedback else None
    new_t = out.pop(0) if ts.adaptive is not None else None
    gnorm = out.pop(0) if ts.metrics_gnorm else None
    cm = out.pop(0) if ts.metrics_compression else None
    dsgd = ts.sync == "dsgd"
    rtol = DSGD_RTOL if dsgd else 0.0
    if ts.bucket_mb > 0:
        t0 = stack_rows([init_telemetry(BP.n_buckets)] * n) if ts.adaptive is not None else None
        w_mean, w_resid, w_t, w_cm = reference_sync_state(
            ts, leaves, dp, key, ef=ef if ts.error_feedback else None, tstate=t0, live=live)
    else:
        w_mean = reference_sync(ts, leaves, dp, key)
        w_resid = w_t = w_cm = None
    _same(mean, w_mean, "mean leaf", rtol)
    if new_ef is not None:
        _same(new_ef, [r[rank] for r in w_resid], "EF row of bucket")
    if new_t is not None:
        _same(list(new_t), list(peer_row(w_t, rank)), "telemetry field")
    if cm is not None:
        _same(list(cm), [f[rank] for f in w_cm], "metrics field")
    # the gnorm of the replay's mean, taken over its buckets as the sync does
    _same([gnorm], [global_norm(bucket_concat(w_mean, BP) if ts.bucket_mb > 0 else w_mean)],
          "gnorm", rtol)
    if ts.bucket_mb > 0:
        mode = "two_phase" if ts.sync == "hierarchical" and len(dp) == 1 else ts.sync
        budget = get_codec(ts.compressor.method).collective_budget(mode, BP.n_buckets)
        want_calls = _expected_widths(ts, dp)
        if len(want_calls) != (budget if n > 1 else 0):
            raise AssertionError(f"expected calls {want_calls} against budget {budget}")
        if spied != want_calls:
            raise AssertionError(f"collectives {spied}, expected {want_calls} (budget {budget})")
    return {"digest": _digest(mean), "calls": spied}


def _mesh_rank(rank: int, world: int, init: str, out_dir: str, mesh_id: str) -> None:
    dp = MESHES[mesh_id]
    mesh = compat.Mesh(dp)
    calls: list = []
    _install_spy(calls)
    report = {}
    for name, (kw, live) in _cases(mesh_id).items():
        t0 = time.perf_counter()
        try:
            rec = _run_case(mesh, rank, dp, dict(kw), live, calls)
            rec["ok"] = True
        except Exception:  # report the case's failure and go on with the next
            rec = {"ok": False, "error": traceback.format_exc()}
        rec["seconds"] = time.perf_counter() - t0
        report[name] = rec
    with open(os.path.join(out_dir, f"{mesh_id}_rank{rank}.json"), "w") as f:
        json.dump(report, f)


def _entry(rank: int, fn, world: int, init: str, args: tuple) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank,
                                         world_size=world)
    try:
        fn(rank, world, init, *args)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(fn, world: int, tmp, *args) -> None:
    init = f"file://{tmp}/rendezvous"
    torch.multiprocessing.start_processes(_entry, args=(fn, world, init, args), nprocs=world,
                                          join=True, start_method="spawn")


@pytest.fixture(scope="module")
def mesh_reports(tmp_path_factory):
    """mesh id -> per-rank reports; one spawn per mesh, on first use."""
    done = {}

    def get(mesh_id):
        if mesh_id not in done:
            tmp = tmp_path_factory.mktemp(mesh_id)
            world = math.prod(MESHES[mesh_id])
            t0 = time.perf_counter()
            _spawn(_mesh_rank, world, tmp, str(tmp), mesh_id)
            done[mesh_id] = [json.load(open(tmp / f"{mesh_id}_rank{r}.json"))
                             for r in range(world)]
            # the spawn's wall time and each case's slowest rank (pytest -s)
            print(f"{mesh_id}: {world} ranks in {time.perf_counter() - t0:.1f} s; " + ", ".join(
                f"{c} {max(r[c]['seconds'] for r in done[mesh_id]):.2f} s"
                for c in done[mesh_id][0]))
        return done[mesh_id]

    return get


@pytest.mark.parametrize("mesh_id,case", CASE_IDS, ids=[f"{m}-{c}" for m, c in CASE_IDS])
def test_mesh_sync_matches_replay(mesh_reports, mesh_id, case):
    reports = [r[case] for r in mesh_reports(mesh_id)]
    for rank, rec in enumerate(reports):
        assert rec["ok"], f"rank {rank}:\n{rec['error']}"
    digests = {rec["digest"] for rec in reports}
    assert len(digests) == 1, f"ranks' means differ: {[r['digest'][:12] for r in reports]}"
    assert all(rec["calls"] == reports[0]["calls"] for rec in reports)


def _train_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    from repro_torch.train import train_synced

    mesh = compat.Mesh((world,))
    runs = {"faithful": dict(sync="faithful"),
            "two_phase_ef": dict(sync="two_phase", error_feedback=True),
            "faithful_ef_dropout": dict(sync="faithful", error_feedback=True,
                                        elastic=ElasticConfig(rate=0.5, seed=3))}
    out = {}
    for label, kw in runs.items():
        out[label] = {"mesh": train_synced(steps=3, n_clients=world, device="cpu", mesh=mesh,
                                           **kw)}
        if rank == 0:
            out[label]["replay"] = train_synced(steps=3, n_clients=world, device="cpu", **kw)
    ef_rows = init_ef_state([torch.zeros(s) for s in LEAF_SHAPES],
                            TrainStepConfig(sync="faithful", bucket_mb=BUCKET_MB,
                                            error_feedback=True))
    out["ef_rows"] = [tuple(e.shape) for e in ef_rows]
    with open(os.path.join(out_dir, f"train_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def test_train_synced_on_two_ranks_is_the_replay(tmp_path):
    """Two gloo ranks, one client each, 3 steps: the history every rank
    returns is bitwise the one-device run's at one thread, with and
    without EF and a dropout schedule."""
    _spawn(_train_rank, 2, tmp_path, str(tmp_path))
    ranks = [json.load(open(tmp_path / f"train_rank{r}.json")) for r in range(2)]
    for label in ("faithful", "two_phase_ef", "faithful_ef_dropout"):
        want = ranks[0][label]["replay"]
        assert len(want) == 3 and all(math.isfinite(x) for x in want)
        for rank in ranks:
            assert rank[label]["mesh"] == want, (label, rank[label]["mesh"], want)
    assert ranks[0]["ef_rows"] == [[m] for m in BP.sizes]


def test_mesh_rejects_a_wrong_layout(tmp_path):
    """A mesh must cover the process group exactly, with one name an axis
    (named by the caller past two axes), and holds all axes, the data axis
    and the pod axes, looked up in mesh order."""
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                                         rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="has 2 ranks"):
            compat.Mesh((2,))
        with pytest.raises(ValueError, match="distinct name"):
            compat.Mesh((1, 1), ("data", "data"))
        with pytest.raises(ValueError, match="name the axes"):
            compat.Mesh((1, 1, 1))
        mesh = compat.Mesh((1, 1))
        assert (mesh.axis_names, compat.axis_size(mesh, ("pod", "data"))) == (("pod", "data"), 1)
        assert compat.flat_axis_index(mesh, "pod") == compat.flat_axis_index(mesh, "data") == 0
        with pytest.raises(KeyError, match="mesh order"):
            mesh.axes(("data", "pod"))
        mesh3 = compat.Mesh((1, 1, 1), ("pod", "rack", "data"))
        assert compat.axis_size(mesh3, ("pod", "rack")) == 1
        with pytest.raises(KeyError, match="no axes"):
            mesh3.axes("rack")
        x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
        assert torch.equal(compat.all_gather_stacked(x, mesh, "data"), x[None])
        assert torch.equal(compat.all_to_all_rows(x[:1], mesh, "pod"), x[:1])
        sync = make_sync_fn(TrainStepConfig(sync="faithful", bucket_mb=BUCKET_MB), mesh,
                            [torch.zeros(3, 2)])
        with pytest.raises(ValueError, match="gradient shapes"):
            sync([torch.zeros(2, 3)], prng.key(0))
        with pytest.raises(TypeError, match="state arguments"):
            sync([torch.zeros(3, 2)], prng.key(0), torch.ones(1))
    finally:
        torch.distributed.destroy_process_group()
