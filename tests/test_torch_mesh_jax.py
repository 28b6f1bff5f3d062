"""The mesh sync against the JAX package's, on the CPU.

- ``dist.train_step.make_sync_fn`` on 2 gloo ranks against the JAX
  package's ``_make_sync_fn`` on 2 forced host devices (a subprocess), on
  the same leaves, key and EF rows: the leaf shapes of
  ``tests/test_mesh_invariance.py`` at ``bucket_mb = 1/64`` (three
  buckets), tnqsgd at 3 bits; dsgd, faithful and two_phase over (2,),
  hierarchical over (1, 2), EF on in every compressed case, and two_phase
  under the mask that drops one rank.  The JAX package plans each bucket
  from its own statistics, an ulp from the port's, so its sync sends every
  device's plans to the host as it runs (``jax.debug.callback``, tagged
  with the order they were traced in) and each rank of the port takes its
  device's plans in that order.  With those plans every rank's means and
  EF rows are bitwise JAX's; dsgd (no plan; gloo owns the order of the
  sum) within 1e-6.
- ``dist.train_step.local_bucket_sizes`` equal to JAX's, and the shapes of
  ``init_ef_state`` and of the telemetry row JAX's rows, on smallnet's
  parameters over a 1-device ``("data",)`` mesh, under the tnqsgd,
  powersgd, mixed and fp16-tier plans at ``bucket_mb=0.02`` (buckets of
  4,928, 200,704 and 1,290 elements).

About 35 s alone in one process (the JAX subprocess compiles each sync
and replay).
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
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.dist import train_step as jts  # noqa: E402
from repro.models.smallnet import init_smallnet as jinit_smallnet  # noqa: E402
from repro_torch.adaptive.telemetry import init_telemetry  # noqa: E402
from repro_torch.core import codecs, prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig, plan_buckets  # noqa: E402
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist import compat, train_step  # noqa: E402
from repro_torch.elastic import ElasticConfig  # noqa: E402
from repro_torch.models.smallnet import init_smallnet, tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

PLANS = {
    "tnqsgd": dict(compressor=("tnqsgd", 3)),
    "powersgd": dict(compressor=("powersgd", 4)),
    "mixed": dict(compressor=("tnqsgd", 3), bits_plan=(3, ("powersgd", 4), 2)),
    "fp16_tier": dict(compressor=("tnqsgd", 3), fp16_threshold=5000),
}

LEAF_SHAPES = [(64, 48), (37, 61), (2048,), (999,)]
BUCKET_MB = 1.0 / 64.0
BP = plan_buckets([math.prod(s) for s in LEAF_SHAPES], 4096)
N = 2
# case -> (sync, dp sizes, live mask or None); EF on in every compressed case
SYNC_CASES = {
    "dsgd": ("dsgd", (2,), None),
    "faithful_ef": ("faithful", (2,), None),
    "two_phase_ef": ("two_phase", (2,), None),
    "hierarchical_ef": ("hierarchical", (1, 2), None),
    "two_phase_ef_one_dropped": ("two_phase", (2,), (1.0, 0.0)),
}
DSGD_RTOL = 1e-6

# the JAX package's side, on N forced host devices: its mesh sync for every
# case, each device's plans sent to the host as the sync runs
_JAX_SCRIPT = """
import json, sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P, AxisType
from repro.core import codecs as jcodecs
from repro.core.compressors import CompressorConfig, plan_from_stats
from repro.dist.train_step import TrainStepConfig, _make_sync_fn
from repro.elastic import ElasticConfig

jax.config.update("jax_threefry_partitionable", False)   # the port's layout
inp = np.load(sys.argv[1])
cases = json.loads(sys.argv[2])
leaves = [jnp.asarray(inp[f"leaf{i}"]) for i in range(int(inp["n_leaves"]))]
ef = tuple(jnp.asarray(inp[f"ef{b}"]) for b in range(int(inp["n_buckets"])))
key = jax.random.key(int(inp["key"]))
out = {}
for name, (sync, dp, live) in cases.items():
    names = ("pod", "data")[-len(dp):]
    mesh = jax.make_mesh(tuple(dp), names, axis_types=(AxisType.Auto,) * len(dp))
    ef_on = sync != "dsgd"
    ts = TrainStepConfig(sync=sync, bucket_mb=float(inp["bucket_mb"]), error_feedback=ef_on,
                         compressor=CompressorConfig(method="tnqsgd", bits=3),
                         elastic=None if live is None else ElasticConfig(rate=0.5),
                         metrics_gnorm=False)
    n_traced = [0]

    def keep(seq, rank, levels, alpha):
        out[f"{name}/rank{int(rank)}/plan{seq}/levels"] = np.asarray(levels)
        out[f"{name}/rank{int(rank)}/plan{seq}/alpha"] = np.asarray(alpha)

    def recording(self, cfg, flat, stat, use_pallas):
        if stat is None:
            stat = jcodecs._bucket_stats(flat, use_pallas)
        meta = plan_from_stats(cfg, stat[0], stat[1], stat[2])
        rank = 0
        for a, s in zip(names, dp):
            rank = rank * s + jax.lax.axis_index(a)
        jax.debug.callback(partial(keep, n_traced[0]), rank, meta.levels, meta.alpha)
        n_traced[0] += 1
        return meta

    args = [list(leaves), key]
    if live is not None:
        args.append(jnp.asarray(live, jnp.float32))
    if ef_on:
        args.append(ef)
    jcodecs.QuantizerCodec.plan, saved = recording, jcodecs.QuantizerCodec.plan
    try:
        res = jax.jit(_make_sync_fn(ts, mesh, [P() for _ in leaves], list(leaves)))(*args)
        jax.block_until_ready(res)
    finally:
        jcodecs.QuantizerCodec.plan = saved
    mean, new_ef = res if ef_on else (res, ())
    for i, m in enumerate(mean):
        out[f"{name}/mean{i}"] = np.asarray(m)
    for b, r in enumerate(new_ef):
        out[f"{name}/ef{b}"] = np.asarray(r)
np.savez(sys.argv[3], **out)
print("ALL_OK")
"""


def _inputs(seed: int = 5):
    """Leaves (N, *shape) and EF rows (N, m), from a numpy seed."""
    rng = np.random.default_rng(seed)
    leaves = [(0.05 * (i + 1) * rng.standard_normal((N, *s))).astype(np.float32)
              for i, s in enumerate(LEAF_SHAPES)]
    ef = [(0.01 * rng.standard_normal((N, m))).astype(np.float32) for m in BP.sizes]
    return leaves, ef


def _plans_of(jax_out: dict, case: str, rank: int) -> list:
    """The (levels, alpha) of every plan JAX's sync made on ``rank``, in
    the order it traced them."""
    plans = []
    while (k := f"{case}/rank{rank}/plan{len(plans)}") + "/alpha" in jax_out:
        plans.append((jax_out[k + "/levels"], jax_out[k + "/alpha"]))
    return plans


def _jax_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    """One gloo rank: every case through the port's mesh sync with the JAX
    package's plans; writes its means and EF rows."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        jax_out = dict(np.load(os.path.join(out_dir, "jax.npz")))
        leaves, ef = _inputs()
        leaves = [torch.from_numpy(x) for x in leaves]
        ef = [torch.from_numpy(e) for e in ef]
        meshes = {dp: compat.Mesh(dp) for dp in sorted({c[1] for c in SYNC_CASES.values()})}
        key = prng.key(123)
        got = {}
        for name, (sync, dp, live) in SYNC_CASES.items():
            ef_on = sync != "dsgd"
            ts = train_step.TrainStepConfig(
                sync=sync, bucket_mb=BUCKET_MB, error_feedback=ef_on, metrics_gnorm=False,
                compressor=CompressorConfig(method="tnqsgd", bits=3),
                elastic=None if live is None else ElasticConfig(rate=0.5))
            live_t = None if live is None else torch.tensor(live, dtype=torch.float32)
            queue = iter(_plans_of(jax_out, name, rank))

            def injected(self, cfg, flat, stat):
                levels, alpha = next(queue)
                return QuantMeta(levels=torch.from_numpy(levels), alpha=torch.tensor(alpha))

            args = [[x[rank] for x in leaves], key]
            if live_t is not None:
                args.append(live_t)
            if ef_on:
                args.append(tuple(e[rank] for e in ef))
            codecs.QuantizerCodec.plan, saved = injected, codecs.QuantizerCodec.plan
            try:
                res = train_step.make_sync_fn(ts, meshes[dp], args[0])(*args)
            finally:
                codecs.QuantizerCodec.plan = saved
            if next(queue, None) is not None:
                raise AssertionError(f"{name}: rank {rank} made fewer plans than JAX's")
            mean, new_ef = res if ef_on else (res, ())
            for i, m in enumerate(mean):
                got[f"{name}/mean{i}"] = m.numpy()
            for b, r in enumerate(new_ef):
                got[f"{name}/ef{b}"] = r.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    """(JAX's outputs, each rank's outputs): one JAX subprocess on N host
    devices, one spawn of N gloo ranks."""
    tmp = tmp_path_factory.mktemp("mesh_jax")
    leaves, ef = _inputs()
    np.savez(tmp / "inputs.npz", n_leaves=len(leaves), n_buckets=len(ef), key=123,
             bucket_mb=BUCKET_MB, **{f"leaf{i}": x for i, x in enumerate(leaves)},
             **{f"ef{b}": e for b, e in enumerate(ef)})
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(tmp / "inputs.npz"),
                        json.dumps(SYNC_CASES), str(tmp / "jax.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and "ALL_OK" in r.stdout, f"{r.stdout}\n{r.stderr[-4000:]}"
    torch.multiprocessing.start_processes(
        _jax_rank, args=(N, f"file://{tmp}/rendezvous", str(tmp)), nprocs=N, join=True,
        start_method="spawn")
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)])


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_mesh_sync_matches_jax(sync_runs, case):
    jax_out, ranks = sync_runs
    sync = SYNC_CASES[case][0]
    if sync != "dsgd":
        assert all(_plans_of(jax_out, case, r) for r in range(N)), "JAX recorded no plan"
    for rank, got in enumerate(ranks):
        for i in range(len(LEAF_SHAPES)):
            a, want = got[f"{case}/mean{i}"], jax_out[f"{case}/mean{i}"]
            assert a.shape == want.shape, (case, rank, i)
            if sync == "dsgd":
                np.testing.assert_allclose(a, want, rtol=DSGD_RTOL, atol=0, err_msg=case)
            else:
                assert (_bits(a) == _bits(want)).all(), (case, rank, i,
                                                         float(np.abs(a - want).max()))
        if sync == "dsgd":
            continue
        for b in range(BP.n_buckets):
            a, want = got[f"{case}/ef{b}"], jax_out[f"{case}/ef{b}"][rank]
            assert (_bits(a) == _bits(want)).all(), (case, rank, b)


@pytest.mark.parametrize("plan", list(PLANS))
def test_state_geometry_matches_jax(plan):
    kw = dict(PLANS[plan])
    method, value = kw.pop("compressor")
    field = "rank" if method == "powersgd" else "bits"
    common = dict(sync="faithful", bucket_mb=0.02, error_feedback=True, **kw)
    ts = train_step.TrainStepConfig(**common, compressor=CompressorConfig(method=method,
                                                                          **{field: value}))
    jts_cfg = jts.TrainStepConfig(**common, compressor=JConfig(method=method, **{field: value}))
    jparams = jinit_smallnet(jax.random.key(0))
    jmesh = jax.make_mesh((1,), ("data",))
    pspecs = jax.tree.map(lambda _: P(), jparams)
    params = tree_leaves(init_smallnet(prng.key(0), device="cpu"))

    sizes = train_step.local_bucket_sizes(params, ts)
    assert sizes == tuple(jts.local_bucket_sizes(jparams, jmesh, pspecs, jts_cfg))
    assert sizes == (4928, 200704, 1290)
    ef = train_step.init_ef_state(params, ts)
    jef = jts.init_ef_state(jparams, jmesh, pspecs, jts_cfg)
    assert [tuple(e.shape) for e in ef] == [tuple(e.shape[1:]) for e in jef]
    assert all(e.shape[0] == 1 for e in jef)
    assert all(e.dtype == torch.float32 and not e.any() for e in ef)
    # a rank's telemetry row over its buckets, the sync's ``tstate``
    t = init_telemetry(len(sizes))
    jt = jts.init_telemetry_state(jparams, jmesh, pspecs, jts_cfg)
    assert [tuple(x.shape) for x in t] == [tuple(x.shape[1:]) for x in jt]
