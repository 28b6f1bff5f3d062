"""The port's LM train step (``dist.train_step.make_train_step``), adaptive
runtime and launcher against the JAX package's, and a 2-rank mesh run
against its one-process replay.

Contract:
- ``make_train_step`` on a 1-rank gloo mesh against JAX's on one CPU device
  (JAX's params carried over, the same numpy batches, JAX pinned to the
  port's threefry layout), 2 steps: with dsgd every param within 1e-5 of
  the leaf's max |p|, the losses and gnorms within rtol 1e-5; with
  faithful tnqsgd and EF the step-0 loss within rtol 1e-5, and the step-1
  loss and both gnorms within a tenth of the gap between JAX's own tnqsgd
  and dsgd runs at this size (fact F3 moves α by ulps, which can flip a
  code);
- 2 gloo ranks spawned once, every case inside: each rank's params, EF
  rows and loss and gnorm metrics bitwise ``train.lm_replay_step`` (both
  clients in one process, ``reference_sync_state``, the update; fact F10
  at one thread) for faithful tnqsgd with EF over 3 steps, two_phase with
  a dropout schedule and ``metrics_compression``, and the adaptive
  stepper; the metrics contract (``loss``/``gnorm`` (n_dp,) float32
  replicated, ``compression`` (n_dp, n_buckets) leaves, ``live`` and
  ``live_count``);
- ``AdaptiveStepper.replan`` on the same telemetry as JAX's stepper gives
  JAX's bits (adopt, switch, keep under hysteresis), an ``adaptive.replan``
  span a replan and JAX's drift events (kind, bucket and step; γ within
  fact F3's 1e-4); the step cache is LRU-bounded at ``max_cached_steps``;
- the launcher on the CPU (1 rank, then ``--fake-devices 2``): its step-0
  loss is JAX's ``loss_fn`` on the same params and batch; a checkpoint
  resumes; ``--obs-dir`` writes a span and a metrics event a step.
"""
import dataclasses
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.adaptive import runtime as jruntime  # noqa: E402
from repro.adaptive import telemetry as jtel  # noqa: E402
from repro.adaptive.controller import AdaptiveConfig as JAdaptive  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.dist import train_step as jts  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.obs import DriftMonitor as JDriftMonitor  # noqa: E402
from repro.obs import SpanRecorder as JSpanRecorder  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.adaptive import runtime, telemetry  # noqa: E402
from repro_torch.adaptive.controller import AdaptiveConfig, BitPlan  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.dist import compat, train_step  # noqa: E402
from repro_torch.elastic import ElasticConfig  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.smallnet import tree_leaves  # noqa: E402
from repro_torch.obs import DriftMonitor, SpanRecorder, read_events  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

ARCH = "llama3.2-1b"
B, S = 2, 32
RTOL = 1e-5
TNQ = CompressorConfig(method="tnqsgd", bits=3)


def _np_batch(vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def _tbatch(nb: dict):
    return transformer.Batch(**{k: torch.from_numpy(v.astype(np.int64)) for k, v in nb.items()})


def _jbatch(nb: dict):
    return jtf.Batch(**{k: jnp.asarray(v) for k, v in nb.items()})


@pytest.fixture
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


@pytest.fixture
def one_rank(tmp_path):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                                         rank=0, world_size=1)
    try:
        yield compat.Mesh((1,))
    finally:
        torch.distributed.destroy_process_group()


def _jax_run(jcfg, jparams, ts, batches):
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    opt = jopt.momentum_sgd(lr=0.05)
    box = {}

    def init(key):
        params, box["logical"] = jtf.init_lm(key, jcfg)
        return params

    jax.eval_shape(init, jax.random.key(0))
    logical = box["logical"]
    fn, pspecs = jts.make_train_step(jcfg, mesh, logical, opt, ts, _jbatch(batches[0]),
                                     params_like=jparams)
    p, o = jparams, opt.init(jparams)
    ef = jts.init_ef_state(jparams, mesh, pspecs, ts) if ts.error_feedback else None
    hist = []
    for i, nb in enumerate(batches):
        if ef is None:
            p, o, m = fn(p, o, _jbatch(nb), jnp.uint32(i))
        else:
            p, o, ef, m = fn(p, o, ef, _jbatch(nb), jnp.uint32(i))
        hist.append((float(m["loss"][0]), float(m["gnorm"][0])))
    return jax.tree.map(np.asarray, p), hist


def _port_run(cfg, mesh, params, ts, batches):
    opt = optimizers.momentum_sgd(lr=0.05)
    fn = train_step.make_train_step(cfg, mesh, opt, ts, _tbatch(batches[0]))
    p, o = params, opt.init(params)
    ef = train_step.init_ef_state(params, ts) if ts.error_feedback else None
    hist = []
    for i, nb in enumerate(batches):
        if ef is None:
            p, o, m = fn(p, o, _tbatch(nb), i)
        else:
            p, o, ef, m = fn(p, o, ef, _tbatch(nb), i)
        assert m["loss"].shape == m["gnorm"].shape == (1,)
        assert m["loss"].dtype == m["gnorm"].dtype == torch.float32
        hist.append((float(m["loss"][0]), float(m["gnorm"][0])))
    return p, hist


def test_one_rank_step_matches_jax(one_rank, same_layout):
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jparams = jax.jit(lambda k: jtf.init_lm(k, jcfg)[0])(jax.random.key(0))
    params = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batches = [_np_batch(cfg.vocab, 20 + i) for i in range(2)]
    dsgd = (jts.TrainStepConfig(sync="dsgd"), train_step.TrainStepConfig(sync="dsgd"))
    tnq = (jts.TrainStepConfig(sync="faithful", error_feedback=True,
                               compressor=JConfig(method="tnqsgd", bits=3)),
           train_step.TrainStepConfig(sync="faithful", error_feedback=True, compressor=TNQ))
    jp, jd = _jax_run(jcfg, jparams, dsgd[0], batches)
    p, d = _port_run(cfg, one_rank, params, dsgd[1], batches)
    np.testing.assert_allclose(d, jd, rtol=RTOL)
    for a, b in zip(tree_leaves(p), jax.tree.leaves(jp), strict=True):
        assert float(np.abs(a.numpy() - b).max()) <= RTOL * float(np.abs(b).max())
    _, jq = _jax_run(jcfg, jparams, tnq[0], batches)
    _, q = _port_run(cfg, one_rank, params, tnq[1], batches)
    assert abs(q[0][0] - jq[0][0]) <= RTOL * abs(jq[0][0])
    for i, k in ((1, 0), (0, 1), (1, 1)):   # step 1's loss, both steps' gnorm
        window = 0.1 * abs(jq[i][k] - jd[i][k])   # the quantizer's own move at this size
        assert 0 < abs(q[i][k] - jq[i][k]) <= window or q[i][k] == jq[i][k], (i, k, q, jq, jd)
    # no mesh: no sync, and the state slots need one
    fn = train_step.make_train_step(cfg, None, optimizers.momentum_sgd(lr=0.05), dsgd[1],
                                    _tbatch(batches[0]))
    p1, _, m = fn(params, optimizers.momentum_sgd().init(params), _tbatch(batches[0]), 0)
    assert float(m["loss"][0]) == d[0][0] and m["gnorm"].shape == (1,)
    with pytest.raises(ValueError, match="data-parallel mesh"):
        train_step.make_train_step(cfg, None, None, tnq[1], _tbatch(batches[0]))


# -- 2 ranks -----------------------------------------------------------------

MESH_STEPS = 3
# label -> (TrainStepConfig keywords, steps); every case runs on the mesh and
# in the replay
MESH_CASES = {
    "faithful_ef": (dict(sync="faithful", error_feedback=True, compressor=TNQ), MESH_STEPS),
    "two_phase_elastic_metrics": (dict(sync="two_phase", compressor=TNQ, metrics_compression=True,
                                       elastic=ElasticConfig(rate=0.5, seed=3)), 2),
}
ADAPTIVE = AdaptiveConfig(replan_every=2, warmup_steps=1, min_bits=2, max_bits=6)


def _mesh_setup():
    cfg = reduced(get_config(ARCH))
    params = transformer.init_lm(prng.key(0), cfg, device="cpu")
    return cfg, params, [lm_batch(cfg, i, B, S, "cpu") for i in range(MESH_STEPS)]


def _train_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    mesh = compat.Mesh((world,))
    cfg, params, batches = _mesh_setup()
    out = {}
    for label, (kw, steps) in MESH_CASES.items():
        ts = train_step.TrainStepConfig(**kw)
        opt = optimizers.momentum_sgd(lr=0.05)
        fn = train_step.make_train_step(cfg, mesh, opt, ts, batches[0], params_like=params)
        p, o = params, opt.init(params)
        ef = train_step.init_ef_state(params, ts) if ts.error_feedback else None
        ms = []
        for i in range(steps):
            if ef is None:
                p, o, m = fn(p, o, batches[i], i)
            else:
                p, o, ef, m = fn(p, o, ef, batches[i], i)
            ms.append(m)
        out[label] = {"params": tree_leaves(p), "ef": ef, "metrics": ms}
    ts = train_step.TrainStepConfig(sync="faithful", compressor=CompressorConfig(
        method="tqsgd", bits=3), bucket_mb=0.25, adaptive=ADAPTIVE)
    opt = optimizers.adamw()
    stepper = runtime.AdaptiveStepper(cfg, mesh, opt, ts, batches[0], params_like=params)
    p, o, t = params, opt.init(params), stepper.init_telemetry()
    for i in range(MESH_STEPS):
        p, o, _, t, _ = stepper.step(p, o, None, t, batches[i], i)
    out["adaptive"] = {"params": tree_leaves(p), "bits": stepper.bits,
                       "cached": list(stepper._cache), "steps": t.steps}
    try:
        train_step.make_train_step(cfg, mesh, opt, ts, lm_batch(cfg, 0, 3, S, "cpu"))
    except ValueError as e:
        out["odd_batch"] = str(e)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _entry(rank: int, world: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        _train_rank(rank, world, init, out_dir)
    finally:
        torch.distributed.destroy_process_group()


def _bitwise(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def test_two_rank_mesh_is_the_replay(tmp_path):
    torch.multiprocessing.start_processes(_entry, args=(2, f"file://{tmp_path}/rdzv",
                                                        str(tmp_path)),
                                          nprocs=2, join=True, start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # fact F10: the ranks' gradients at one thread
    try:
        cfg, params, batches = _mesh_setup()
        for label, (kw, steps) in MESH_CASES.items():
            ts = train_step.TrainStepConfig(**kw)
            opt = optimizers.momentum_sgd(lr=0.05)
            p, o = params, opt.init(params)
            ef = ([torch.zeros((2, e.numel())) for e in train_step.init_ef_state(params, ts)]
                  if ts.error_feedback else None)
            for i in range(steps):
                p, o, ef, want = train.lm_replay_step(cfg, ts, opt, (2,), p, o, ef, batches[i],
                                                      i)
                for r, rank in enumerate(ranks):
                    m = rank[label]["metrics"][i]
                    for k in ("loss", "gnorm"):
                        assert _bitwise(m[k], want[k]), (label, r, i, k, m[k], want[k])
                    if ts.metrics_compression:
                        nb = len(train_step.local_bucket_sizes(params, ts))
                        assert all(f.shape == (2, nb) for f in m["compression"])
                        assert all(torch.equal(f, g) for f, g in zip(
                            m["compression"], ranks[0][label]["metrics"][i]["compression"]))
                    if ts.elastic is not None:
                        assert m["live"].shape == (2,) and m["live_count"].shape == (2,)
                        assert float(m["live_count"][0]) == float(m["live"].sum())
            if ts.elastic is not None:
                assert any(float(m["live_count"][0]) < 2 for m in ranks[0][label]["metrics"]), \
                    "the schedule must drop a peer once"
            for r, rank in enumerate(ranks):
                assert all(_bitwise(a, b) for a, b in zip(rank[label]["params"], tree_leaves(p),
                                                          strict=True)), (label, r)
                if ef is not None:
                    assert all(_bitwise(e, w[r]) for e, w in zip(rank[label]["ef"], ef,
                                                                 strict=True)), (label, r)
        a0, a1 = ranks[0]["adaptive"], ranks[1]["adaptive"]
        assert a0["bits"] == a1["bits"] and a0["cached"] == a1["cached"]
        assert all(_bitwise(x, y) for x, y in zip(a0["params"], a1["params"], strict=True))
        assert float(a0["steps"]) == MESH_STEPS
        assert "global batch 3 must be divisible by the 2 data shards" in ranks[0]["odd_batch"]
    finally:
        torch.set_num_threads(threads)


# -- the adaptive runtime ----------------------------------------------------


def _telemetry(sizes, seed: int, updates: int = 3):
    """One peer's telemetry of heavy-tailed numpy buckets (the tail index
    moves from bucket to bucket): the port's row, and JAX's stacked state
    of that one row."""
    rng = np.random.default_rng(seed)
    st = telemetry.init_telemetry(len(sizes))
    for _ in range(updates):
        bks = [torch.from_numpy((rng.standard_t(2.5 + b, n) * 1e-3).astype(np.float32))
               for b, n in enumerate(sizes)]
        st = telemetry.update_telemetry(st, bks, decay=0.9)
    return st, jtel.TelemetryState(*(jnp.asarray(f.numpy()[None]) for f in st))


def _shells(sizes, threshold: float):
    ts = train_step.TrainStepConfig(sync="faithful", bucket_mb=1.0, compressor=CompressorConfig(
        method="tnqsgd", bits=3, approx_gmin=True), adaptive=AdaptiveConfig(
        warmup_steps=1, max_cached_steps=2, switch_threshold=threshold, max_bits=5))
    jtsc = jts.TrainStepConfig(sync="faithful", bucket_mb=1.0, compressor=JConfig(
        method="tnqsgd", bits=3, approx_gmin=True), adaptive=JAdaptive(
        warmup_steps=1, max_cached_steps=2, switch_threshold=threshold, max_bits=5))
    out = []
    for cls, cfg in ((runtime.AdaptiveStepper, ts), (jruntime.AdaptiveStepper, jtsc)):
        s = cls.__new__(cls)
        s.ts, s.sizes, s.bits, s.plan, s.tails = cfg, tuple(sizes), (3,) * len(sizes), None, None
        out.append(s)
    return out


def test_replan_gives_jaxs_bits_and_hysteresis():
    sizes = (1 << 15, 3000)
    tstate, jstate = _telemetry(sizes, seed=4)
    port, jx = _shells(sizes, 0.02)
    # the hooks: a margin of 0.3 puts bucket 0's tail (gamma 3.26) on a rail
    port.obs, port.drift = SpanRecorder(), DriftMonitor(warn=False, gamma_margin=0.3)
    jx.obs, jx.drift = JSpanRecorder(), JDriftMonitor(warn=False, gamma_margin=0.3)
    # the first replan always adopts; a starved current plan switches
    for current in (None, (2, 2)):
        if current is not None:   # starved
            for s, plan_cls in ((port, BitPlan), (jx, jruntime.BitPlan)):
                s.bits, s.plan = current, plan_cls(current, (), 0, 0, err=0.0)
        got, want = port.replan(tstate), jx.replan(jstate)
        assert got.bits == want.bits and port.bits == jx.bits == got.bits
        assert (got.spend_bytes, got.budget_bytes) == (want.spend_bytes, want.budget_bytes)
        assert got.spend_bytes <= got.budget_bytes
    assert got.bits != (2, 2)
    # a prohibitive threshold keeps a perturbed current plan in both
    port.ts = dataclasses.replace(port.ts, adaptive=dataclasses.replace(
        port.ts.adaptive, switch_threshold=0.95))
    jx.ts = dataclasses.replace(jx.ts, adaptive=dataclasses.replace(
        jx.ts.adaptive, switch_threshold=0.95))
    perturbed = tuple(max(2, b - 1) for b in got.bits)
    assert perturbed != got.bits
    port.bits, port.plan = perturbed, BitPlan(perturbed, (), 0, 0, err=got.err)
    jx.bits, jx.plan = perturbed, jruntime.BitPlan(perturbed, (), 0, 0, err=want.err)
    assert port.replan(tstate).bits == jx.replan(jstate).bits == perturbed
    # every replan ran under a span and fed the fresh tails to the monitor
    assert port.obs.summary()["adaptive.replan"]["count"] == 3
    assert jx.obs.summary()["adaptive.replan"]["count"] == 3
    assert [(e.kind, e.bucket, e.step) for e in port.drift.events] == \
        [(e.kind, e.bucket, e.step) for e in jx.drift.events] == [("tail_regime", 0, 3)] * 3
    assert all(abs(a.value - b.value) <= 1e-4 * b.value
               for a, b in zip(port.drift.events, jx.drift.events, strict=True))
    # the step cache is LRU-bounded at max_cached_steps
    port._build = lambda bits: ("step", bits)
    port._cache = __import__("collections").OrderedDict()
    for bits in [(2, 2, 2), (3, 3, 3), (4, 4, 4), (3, 3, 3)]:
        assert port._step_for(bits) == ("step", bits)
    assert list(port._cache) == [(4, 4, 4), (3, 3, 3)]
    with pytest.raises(ValueError, match="adaptive"):
        runtime.AdaptiveStepper(None, None, None, train_step.TrainStepConfig(), None)


# -- the launcher ------------------------------------------------------------


def _jax_loss(cfg_name: str, params: dict, batch) -> float:
    jcfg = jreduced(jget_config(cfg_name))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jb = jtf.Batch(tokens=jnp.asarray(batch.tokens.numpy()), labels=jnp.asarray(batch.labels.numpy()))
    return float(jax.jit(lambda p, b: jtf.loss_fn(jcfg, p, b))(jp, jb))


def test_launcher_on_cpu(tmp_path, capfd):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", str(B), "--seq", str(S)]
    cfg = reduced(get_config(ARCH))
    params = transformer.init_lm(prng.key(0), cfg, device="cpu")
    batch0 = lm_batch(cfg, 0, B, S, "cpu")
    ck = str(tmp_path / "ckpt")
    obs_dir = tmp_path / "obs"
    out = launcher.run(argv + ["--steps", "2", "--ef", "--ckpt-dir", ck, "--ckpt-every", "1",
                               "--obs-dir", str(obs_dir)])
    want = _jax_loss(ARCH, params, batch0)
    assert abs(out["history"][0]["loss"] - want) <= RTOL * want
    assert len(out["ef_state"]) == len(train_step.local_bucket_sizes(
        params, train_step.TrainStepConfig()))
    resumed = launcher.run(argv + ["--steps", "1", "--ckpt-dir", ck])
    assert [h["step"] for h in resumed["history"]] == [2]
    text = capfd.readouterr().out
    assert "arch=llama3.2-1b mesh={'data': 1} sync=two_phase method=tnqsgd bits=3" in text
    assert "checkpointed step 2" in text and "resumed from step 2" in text
    assert re.search(r"step     1 loss \d+\.\d{4} gnorm \d+\.\d{3}", text)
    events = read_events(obs_dir)
    assert f"obs: {len(events)} events -> {obs_dir / 'events.jsonl'}" in text
    assert [(e["kind"], e["step"]) for e in events if e["kind"] != "drift"] == [
        ("span", 0), ("metrics", 0), ("span", 1), ("metrics", 1)]
    assert out["obs"]["n_written"] == len(events)
    assert out["obs"]["spans"]["train.step"]["count"] == 2
    # two spawned gloo ranks, one client each: the mean of the halves' losses
    assert launcher.main(argv + ["--steps", "1", "--fake-devices", "2"]) == 0
    text = capfd.readouterr().out
    assert "mesh={'data': 2}" in text
    got = float(re.search(r"step     0 loss (\d+\.\d{4})", text).group(1))
    halves = [transformer.Batch(tokens=batch0.tokens[i:i + 1], labels=batch0.labels[i:i + 1])
              for i in range(B)]
    want = sum(_jax_loss(ARCH, params, h) for h in halves) / B
    assert abs(got - want) <= 6e-5, (got, want)
    for bad, what in ((["--mesh", "1x2", "--arch", "phi3.5-moe-42b-a6.6b"], "model axis"),
                      (["--obs-dir", str(tmp_path), "--bucket-mb", "0"], "bucketed codec")):
        with pytest.raises(SystemExit):
            launcher.main(argv + bad)
        assert what in capfd.readouterr().err
    assert math.isfinite(out["history"][1]["gnorm"])
