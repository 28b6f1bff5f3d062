"""The gradient sync on a (data, model) = (2, 2) mesh against the JAX
package's, per device, on the CPU.

One JAX subprocess on 4 forced host devices (under the original threefry
layout, ROADMAP fact F1) runs ``_make_sync_fn`` for faithful and two_phase
tnqsgd at 3 bits with error feedback, telemetry (``adaptive``), the
gnorm and the compression metrics, on stacked per-client leaves whose
specs split two of them over the model axis (by columns and by rows) and
leave two whole; it writes every device's shard of every output and every
device's plans (``jax.debug.callback``, in the order they were traced).
One spawn of 4 gloo ranks runs the port's ``make_sync_fn`` on a
``Mesh((2, 2), ("data", "model"))``: rank (d, m) = d·2 + m takes client
d's model-local slices (``dist.sharding.local_shard``), its EF rows out of
JAX's layout (``train_step.ef_rank_rows``) and JAX device (d, m)'s plans.

- Each rank's means and EF rows are bitwise JAX device (d, m)'s, the
  whole leaves' means included (each model shard codes its own bucket
  composition, so those are a device's own, as JAX keeps them).
- Its telemetry row within rtol 1e-5 of the largest magnitude of each
  field (the statistics' sums are added in another order, ROADMAP fact
  F5), its gnorm within rtol 1e-6, and its metrics: bits, rank, wire
  bytes and α exactly, the clip fraction (an exact count that XLA, jitted
  whole, multiplies by the bucket size's reciprocal), realized error and
  EF norm within rtol 1e-6, predicted error within rtol 2e-5 (the tail fit
  on the statistics, as ``tests/test_torch_obs_metrics.py``).
- The gnorm's square is the sum of the two model shards' own sums of
  squares of their mean buckets (a whole leaf counted twice, as JAX's
  ``psum`` counts it).
- The same ranks run ``analysis.sync_lint``'s model-mesh cases: the
  compression metrics leave the collective count as it was (the gnorm's
  one model-group sum takes them); with the gnorm off they add one sum.
- ``sharding.gather_shards`` joins the model ranks' ``local_shard`` slices
  back into the full tensor, bfloat16 included.

About 30 s alone.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.adaptive.controller import AdaptiveConfig  # noqa: E402
from repro_torch.adaptive.telemetry import init_telemetry  # noqa: E402
from repro_torch.analysis import sync_lint  # noqa: E402
from repro_torch.core import codecs, prng  # noqa: E402
from repro_torch.core.compressors import (CompressorConfig, bucket_concat,  # noqa: E402
                                          plan_buckets)
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist import compat, sharding, train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D, M = 4, 2, 2
# full leaf shapes and specs over ("data", "model"): split by columns, by
# rows, and two leaves whole
LEAVES = [((64, 48), (None, "model")), ((40, 30), ("model", None)), ((2048,), (None,)),
          ((999,), (None,))]
BUCKET_MB = 1.0 / 64.0
SYNCS = ("faithful", "two_phase")
TEL_RTOL, GNORM_RTOL, SUM_RTOL, PRED_RTOL = 1e-5, 1e-6, 1e-6, 2e-5


def _local_shape(shape, spec):
    return tuple(s // M if e == "model" else s for s, e in zip(shape, spec))


BP = plan_buckets([math.prod(_local_shape(s, p)) for s, p in LEAVES], 4096)

_JAX_SCRIPT = """
import json, sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P, AxisType
from repro.adaptive.controller import AdaptiveConfig
from repro.core import codecs as jcodecs
from repro.core.compressors import CompressorConfig, plan_from_stats
from repro.dist import train_step as jts

jax.config.update("jax_threefry_partitionable", False)   # the port's layout
inp = np.load(sys.argv[1])
cfg = json.loads(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
specs = [P(*s) for _, s in cfg["leaves"]]
leaves = [jnp.asarray(inp[f"leaf{i}"]) for i in range(len(specs))]
ef = tuple(jnp.asarray(inp[f"ef{b}"]) for b in range(int(inp["n_buckets"])))
key = jax.random.key(int(inp["key"]))
pos = {mesh.devices[d, m].id: d * 2 + m for d in range(2) for m in range(2)}
out = {}


def per_device(x, tag):
    for sh in x.addressable_shards:
        out[f"{tag}/r{pos[sh.device.id]}"] = np.asarray(sh.data)


for sync in cfg["syncs"]:
    ts = jts.TrainStepConfig(sync=sync, bucket_mb=cfg["bucket_mb"], error_feedback=True,
                             compressor=CompressorConfig(method="tnqsgd", bits=3),
                             adaptive=AdaptiveConfig(), metrics_compression=True)
    full_like = [x[0] for x in leaves]
    tstate = jts.init_telemetry_state(full_like, mesh, specs, ts)
    n_traced = [0]

    def keep(seq, rank, levels, alpha):
        out[f"{sync}/rank{int(rank)}/plan{seq}/levels"] = np.asarray(levels)
        out[f"{sync}/rank{int(rank)}/plan{seq}/alpha"] = np.asarray(alpha)

    def recording(self, c, flat, stat, use_pallas):
        if stat is None:
            stat = jcodecs._bucket_stats(flat, use_pallas)
        meta = plan_from_stats(c, stat[0], stat[1], stat[2])
        rank = jax.lax.axis_index("data") * 2 + jax.lax.axis_index("model")
        jax.debug.callback(partial(keep, n_traced[0]), rank, meta.levels, meta.alpha)
        n_traced[0] += 1
        return meta

    jcodecs.QuantizerCodec.plan, saved = recording, jcodecs.QuantizerCodec.plan
    try:
        fn = jts._make_sync_fn(ts, mesh, specs, list(leaves))
        mean, new_ef, new_t, gnorm, cm = jax.jit(fn)(list(leaves), key, ef, tstate)
        jax.block_until_ready(mean)
    finally:
        jcodecs.QuantizerCodec.plan = saved
    for i, x in enumerate(mean):
        per_device(x, f"{sync}/mean{i}")
    for b, x in enumerate(new_ef):
        per_device(x, f"{sync}/ef{b}")
    for f, x in zip(new_t._fields, new_t):
        per_device(x, f"{sync}/tel_{f}")
    per_device(gnorm, f"{sync}/gnorm")
    for f, x in zip(cm._fields, cm):
        per_device(x, f"{sync}/cm_{f}")
np.savez(sys.argv[3], **out)
print("ALL_OK")
"""


def _inputs(seed: int = 11):
    """Stacked per-client leaves (D, *shape), and every rank's EF rows in
    JAX's (D, M · row) layout, from a numpy seed."""
    rng = np.random.default_rng(seed)
    leaves = [(0.05 * (i + 1) * rng.standard_normal((D, *s)) * np.exp(rng.standard_normal(
        (D, *s)))).astype(np.float32) for i, (s, _) in enumerate(LEAVES)]
    ef = [(0.01 * rng.standard_normal((D, M * m))).astype(np.float32) for m in BP.sizes]
    return leaves, ef


def _plans_of(jax_out: dict, sync: str, rank: int) -> list:
    plans = []
    while (k := f"{sync}/rank{rank}/plan{len(plans)}") + "/alpha" in jax_out:
        plans.append((jax_out[k + "/levels"], jax_out[k + "/alpha"]))
    return plans


def _sync_rank(mesh, rank: int, jax_out: dict) -> dict:
    """Both syncs on this rank with JAX device ``rank``'s plans."""
    leaves, ef = _inputs()
    d, m = divmod(rank, M)
    specs = [sharding.P(*p) for _, p in LEAVES]
    mine = [sharding.local_shard(torch.from_numpy(x[d]), s, mesh) for x, s in zip(leaves, specs)]
    rows = train_step.ef_rank_rows([torch.from_numpy(e) for e in ef], d, m, M)
    got = {}
    for sync in SYNCS:
        ts = train_step.TrainStepConfig(sync=sync, bucket_mb=BUCKET_MB, error_feedback=True,
                                        compressor=CompressorConfig(method="tnqsgd", bits=3),
                                        adaptive=AdaptiveConfig(), metrics_compression=True)
        queue = iter(_plans_of(jax_out, sync, rank))

        def injected(self, cfg, flat, stat):
            levels, alpha = next(queue)
            return QuantMeta(levels=torch.from_numpy(levels), alpha=torch.tensor(alpha))

        codecs.QuantizerCodec.plan, saved = injected, codecs.QuantizerCodec.plan
        try:
            sync_fn = train_step.make_sync_fn(ts, mesh, mine)
            mean, new_ef, new_t, gnorm, cm = sync_fn(mine, prng.key(123), rows,
                                                     init_telemetry(BP.n_buckets))
        finally:
            codecs.QuantizerCodec.plan = saved
        if next(queue, None) is not None:
            raise AssertionError(f"{sync}: rank {rank} made fewer plans than JAX's")
        for i, x in enumerate(mean):
            got[f"{sync}/mean{i}"] = x.numpy()
        for b, x in enumerate(new_ef):
            got[f"{sync}/ef{b}"] = x.numpy()
        for f, x in zip(new_t._fields, new_t):
            got[f"{sync}/tel_{f}"] = x.numpy()
        got[f"{sync}/gnorm"] = gnorm.numpy()
        for f, x in zip(cm._fields, cm):
            got[f"{sync}/cm_{f}"] = x.numpy()
        # this shard's own sum of squares of its mean buckets
        got[f"{sync}/own_sq"] = train_step._sum_of_squares(bucket_concat(
            list(mean), plan_buckets([x.numel() for x in mean], ts.bucket_elements))).numpy()
    return got


def _rank_main(rank: int, world: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        jax_out = dict(np.load(os.path.join(out_dir, "jax.npz")))
        meshes = {"data_model": compat.Mesh((D, M), ("data", "model"))}
        got = _sync_rank(meshes["data_model"], rank, jax_out)
        # the collective counts of the model-mesh cases, with and without metrics
        traces = {}
        for mode in sync_lint.MODES:
            for metrics, gnorm in sync_lint._METRIC_VARIANTS:
                label, rec = sync_lint.model_case(mode, metrics, gnorm, meshes, "cpu")
                traces[label] = sync_lint.gather_case(label, rec)
        got["lint"] = np.array(json.dumps({
            "counts": {k: v["collectives"] for k, v in traces.items()},
            "findings": [f.to_json() for rec in traces.values() for f in rec["findings"]]
            + [f.to_json() for f in sync_lint.check_metric_counts(traces, sync_lint.MODES)]}))
        # gather_shards joins local_shard's slices, float32 and bfloat16
        full = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8) / 7
        mesh = meshes["data_model"]
        ok = True
        for spec in (sharding.P(None, "model"), sharding.P("model", None), sharding.P()):
            for x in (full, full.to(torch.bfloat16)):
                back = sharding.gather_shards(sharding.local_shard(x, spec, mesh), spec, mesh)
                ok = ok and back.dtype == x.dtype and torch.equal(back, x)
        got["round_trip"] = np.array(ok)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_sync")
    leaves, ef = _inputs()
    np.savez(tmp / "inputs.npz", n_buckets=len(ef), key=123,
             **{f"leaf{i}": x for i, x in enumerate(leaves)},
             **{f"ef{b}": e for b, e in enumerate(ef)})
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cfg = {"leaves": [[list(s), list(p)] for s, p in LEAVES], "syncs": list(SYNCS),
           "bucket_mb": BUCKET_MB}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT),
                        str(tmp / "inputs.npz"), json.dumps(cfg), str(tmp / "jax.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and "ALL_OK" in r.stdout, f"{r.stdout}\n{r.stderr[-4000:]}"
    torch.multiprocessing.start_processes(
        _rank_main, args=(N, f"file://{tmp}/rendezvous", str(tmp)), nprocs=N, join=True,
        start_method="spawn")
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)])


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("rank", range(N))
@pytest.mark.parametrize("sync", SYNCS)
def test_sync_means_and_ef_are_jax_per_device(runs, sync, rank):
    jax_out, ranks = runs
    got = ranks[rank]
    assert _plans_of(jax_out, sync, rank), "JAX recorded no plan"
    for i, (shape, spec) in enumerate(LEAVES):
        a, want = got[f"{sync}/mean{i}"], jax_out[f"{sync}/mean{i}/r{rank}"]
        assert a.shape == want.shape == _local_shape(shape, spec)
        assert (_bits(a) == _bits(want)).all(), (sync, rank, i, float(np.abs(a - want).max()))
    for b in range(BP.n_buckets):
        a, want = got[f"{sync}/ef{b}"], jax_out[f"{sync}/ef{b}/r{rank}"]
        assert want.shape == (1, a.size)
        assert (_bits(a) == _bits(want[0])).all(), (sync, rank, b)


@pytest.mark.parametrize("rank", range(N))
@pytest.mark.parametrize("sync", SYNCS)
def test_sync_telemetry_metrics_gnorm_are_jax_per_device(runs, sync, rank):
    jax_out, ranks = runs
    got = ranks[rank]
    tel = [k for k in got if k.startswith(f"{sync}/tel_")]
    assert len(tel) == len([k for k in jax_out if k.startswith(f"{sync}/tel_")
                            and k.endswith(f"/r{rank}")]) >= 3
    for k in tel:
        want = jax_out[f"{k}/r{rank}"][0]
        np.testing.assert_allclose(got[k], want, rtol=TEL_RTOL,
                                   atol=TEL_RTOL * max(float(np.abs(want).max()), 1e-30),
                                   err_msg=k)
    np.testing.assert_allclose(got[f"{sync}/gnorm"], jax_out[f"{sync}/gnorm/r{rank}"],
                               rtol=GNORM_RTOL)
    # the clip count is exact, but jitted whole XLA multiplies it by the
    # reciprocal of the bucket size: one ulp
    for f, rtol in (("bits", 0), ("rank", 0), ("wire_bytes", 0), ("alpha", 0),
                    ("clip_frac", SUM_RTOL), ("realized_mse", SUM_RTOL), ("ef_norm", SUM_RTOL),
                    ("predicted_mse", PRED_RTOL)):
        a, want = got[f"{sync}/cm_{f}"], jax_out[f"{sync}/cm_{f}/r{rank}"][0]
        if rtol == 0:
            assert np.array_equal(a, want), (f, a, want)
        else:
            np.testing.assert_allclose(a, want, rtol=rtol, atol=0, err_msg=f)


@pytest.mark.parametrize("sync", SYNCS)
def test_gnorm_sums_the_model_shards_squares(runs, sync):
    _, ranks = runs
    for d in range(D):
        shards = [ranks[d * M + m] for m in range(M)]
        total = np.float32(sum(np.float32(s[f"{sync}/own_sq"]) for s in shards))
        for s in shards:
            assert _bits(s[f"{sync}/gnorm"]) == _bits(np.sqrt(total))
    # the whole leaves' means: each model shard's own (its bucket composition)
    assert all(ranks[0][f"{sync}/mean{i}"].shape == s for i, (s, _) in enumerate(LEAVES)
               if i >= 2)


def test_metrics_leave_the_collective_count(runs):
    _, ranks = runs
    lint = json.loads(str(ranks[0]["lint"]))
    assert lint["findings"] == []
    counts = lint["counts"]
    for mode in sync_lint.MODES:
        label = sync_lint.model_label
        assert counts[label(mode, True, True)] == counts[label(mode, False, True)], mode
        assert counts[label(mode, False, True)].get("psum", 0) == counts[
            label(mode, False, False)].get("psum", 0) + 1, mode
    assert counts["model:faithful/tnqsgd+metrics"] == {"all_gather": 1, "psum": 1}


def test_gather_shards_inverts_local_shard(runs):
    _, ranks = runs
    assert all(bool(r["round_trip"]) for r in ranks)
