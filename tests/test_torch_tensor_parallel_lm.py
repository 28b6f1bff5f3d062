"""The dense LM family trained and served tensor-parallel on a (data,
model) = (2, 2) mesh against the JAX package, on the CPU.

One JAX subprocess on 4 forced host devices (the original threefry
layout, ROADMAP fact F1) and one spawn of 4 gloo ranks (a
``Mesh((2, 2), ("data", "model"))``, each rank holding its model shard's
slices of ``init_lm(key(0))``, ``dist.sharding.shard_tree``), reduced
llama3.2-1b in float32:

- each client's loss (rows d·2, d·2 + 1 of a 4 × 32 batch) within rtol
  1e-5 of JAX's ``value_and_grad(loss_fn)`` with the params placed by
  their specs, and its gradients, gathered over the model axis, within
  1e-4 of each leaf's largest magnitude;
- ``make_train_step`` with dsgd and momentum SGD (``fsdp`` on, as
  ``tests/test_dist.py::test_streamed_equals_plain_dsgd``): the losses of
  3 steps within 1e-4 of JAX's, the layer-streamed schedule's within 1e-4
  of the plain one's;
- ``make_serve_fns`` with the mesh: the prefill's logits (4 × 32 prompts)
  and two greedy decode steps' within 1e-4 of the largest magnitude of
  JAX's, each rank's KV caches holding its own KV heads.

- the launcher in the same ranks (``launch.train.run``, ``--mesh 2x2``):
  rank 0's checkpoint is the full tree gathered over the model axis, the
  ranks resume their slices from it, and one process resumes it on
  ``--mesh 1`` to the same loss within rtol 1e-5.

And the launchers, concurrently: ``python -m repro_torch.launch.train
--arch llama3.2-1b --reduced --mesh 2x2 --fake-devices 4 --device cpu
--steps 3`` (two_phase tnqsgd at 3 bits) prints the JAX launcher's lines
under F1: the mesh line exactly, each step's loss to its 4 printed
decimals and gnorm to its 3 (one unit of the last digit apart at most, a
rounding boundary).

About 25 s alone.
"""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.checkpoint.io import load_checkpoint  # noqa: E402
from repro_torch.dist import compat, serve_step, sharding, train_step  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.smallnet import tree_leaves  # noqa: E402
from repro_torch.optim.optimizers import momentum_sgd  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
N, D, M = 4, 2, 2
B, S, STEPS = 4, 32, 3
LOSS_RTOL, GRAD_TOL, DSGD_ATOL, LOGIT_TOL = 1e-5, 1e-4, 1e-4, 1e-4
LAUNCH = ["--arch", ARCH, "--reduced", "--mesh", "2x2", "--fake-devices", "4", "--steps",
          str(STEPS)]

_JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P, AxisType
from repro.configs import get_config, reduced
from repro.data.synthetic import lm_batch
from repro.dist import sharding
from repro.dist.serve_step import make_serve_fns
from repro.dist.train_step import TrainStepConfig, make_train_step
from repro.models import transformer as tf
from repro.optim.optimizers import momentum_sgd

jax.config.update("jax_threefry_partitionable", False)   # the port's layout
B, S, STEPS = (int(a) for a in sys.argv[2:5])
cfg = reduced(get_config(sys.argv[1]))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
params, logical = tf.init_lm(jax.random.key(0), cfg)
out = {}


def place(tree, specs):
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs, is_leaf=lambda x: isinstance(x, P))
    return jax.device_put(tree, sh)


pspecs = sharding.param_pspecs(logical, mesh, cfg.fsdp, params)
p = place(params, pspecs)
batch = lm_batch(cfg, jnp.uint32(0), B, S)
rules = sharding.activation_rules(mesh)


@jax.jit
def loss_and_grads(p, b):
    with sharding.axis_rules(mesh, rules):
        return jax.value_and_grad(lambda q: tf.loss_fn(cfg, q, b))(p)


h = B // 2
for c in range(2):
    b = tf.Batch(tokens=batch.tokens[c * h:(c + 1) * h], labels=batch.labels[c * h:(c + 1) * h])
    loss, g = loss_and_grads(p, b)
    out[f"loss{c}"] = np.asarray(loss)
    for i, x in enumerate(jax.tree.leaves(g)):
        out[f"grad{c}_{i}"] = np.asarray(x)

fcfg = cfg.replace(fsdp=True)
opt = momentum_sgd(lr=0.05)
step_fn, fspecs = make_train_step(fcfg, mesh, logical, opt, TrainStepConfig(sync="dsgd"), batch)
q = place(jax.tree.map(jnp.copy, params), fspecs)
o = jax.tree.map(jnp.zeros_like, q)
losses = []
for i in range(STEPS):
    q, o, m = step_fn(q, o, lm_batch(fcfg, jnp.uint32(i), B, S), jnp.uint32(i))
    losses.append(float(m["loss"][0]))
out["dsgd_losses"] = np.asarray(losses)

prefill_fn, decode_fn, sspecs, cspecs = make_serve_fns(cfg, mesh, logical, batch, B, S)
ps = place(params, sspecs)
logits, caches = prefill_fn(ps, batch)
out["prefill"] = np.asarray(logits)
tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
for t in range(2):
    logits, caches = decode_fn(ps, tok, caches, jnp.int32(S + t))
    out[f"decode{t}"] = np.asarray(logits)
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
np.savez(sys.argv[5], **out)
print("ALL_OK")
"""


def _rank_main(rank: int, world: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        mesh = compat.Mesh((D, M), ("data", "model"))
        d = compat.flat_axis_index(mesh, "data")
        cfg = reduced(get_config(ARCH))
        full = transformer.init_lm(prng.key(0), cfg, device="cpu")
        pspecs = sharding.lm_pspecs(cfg, mesh)
        params = sharding.shard_tree(full, pspecs, mesh)
        batch = lm_batch(cfg, 0, B, S, "cpu")
        got = {}
        # (a) this client's loss and gradients
        split, axes = train_step._client_batch(batch, D)
        rules = sharding.activation_rules(mesh, manual_data=True)
        with sharding.axis_rules(mesh, rules):
            loss, grads = train_step._loss_and_grads(
                cfg, params, train_step.client_row(split, axes, d), False)
        got["loss"] = loss.numpy()
        for i, g in enumerate(tree_leaves(sharding.gather_tree(grads, pspecs, mesh))):
            got[f"grad{i}"] = g.numpy()
        # (b) dsgd through make_train_step, plain and streamed, fsdp on
        fcfg = cfg.replace(fsdp=True)
        for streamed in (False, True):
            ts = train_step.TrainStepConfig(sync="dsgd", streamed=streamed)
            opt = momentum_sgd(lr=0.05)
            fn = train_step.make_train_step(fcfg, mesh, opt, ts, batch, params_like=params)
            p, o, losses = params, opt.init(params), []
            for i in range(STEPS):
                p, o, m = fn(p, o, lm_batch(fcfg, i, B, S, "cpu"), i)
                losses.append(float(m["loss"][0]))
            got[f"dsgd_losses_{'streamed' if streamed else 'plain'}"] = np.asarray(losses)
        got["fsdp_pspecs"] = np.array(repr(fn.pspecs))
        # (c) serving
        prefill_fn, decode_fn, _ = serve_step.make_serve_fns(cfg, S, mesh)
        logits, caches = prefill_fn(params, batch)
        got["prefill"] = logits.numpy()
        got["cache_heads"] = np.asarray(caches.k.shape)
        tok = torch.argmax(logits, dim=-1)[:, None]
        for t in range(2):
            logits, caches = decode_fn(params, tok, caches, S + t)
            got[f"decode{t}"] = logits.numpy()
            tok = torch.argmax(logits, dim=-1)[:, None]
        # (d) the launcher on this mesh: rank 0 checkpoints the gathered
        # full tree at step 2, and every rank resumes its slices from it
        argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "2x2", "--batch",
                str(B), "--seq", str(S), "--ckpt-dir", os.path.join(out_dir, "ckpt")]
        out = launcher.run(argv + ["--steps", "2", "--ckpt-every", "2"])
        for i, g in enumerate(tree_leaves(sharding.gather_tree(out["params"], pspecs, mesh))):
            got[f"final{i}"] = g.numpy()
        resumed = launcher.run(argv + ["--steps", "1"])
        got["resumed"] = np.asarray([h["loss"] for h in resumed["history"]])
        got["resumed_step"] = np.asarray([h["step"] for h in resumed["history"]])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's arrays, each rank's arrays, the JAX launcher's output, the
    port launcher's output): the three subprocesses run while the gloo
    ranks do."""
    tmp = tmp_path_factory.mktemp("tp_lm")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               JAX_THREEFRY_PARTITIONABLE="0")
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env)
             for cmd in ([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), ARCH, str(B),
                          str(S), str(STEPS), str(tmp / "jax.npz")],
                         [sys.executable, "-m", "repro.launch.train"] + LAUNCH,
                         [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"]
                         + LAUNCH)]
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(N, f"file://{tmp}/rendezvous", str(tmp)), nprocs=N, join=True,
            start_method="spawn")
    finally:
        outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"{o}\n{e[-4000:]}"
    assert "ALL_OK" in outs[0][0]
    return (dict(np.load(tmp / "jax.npz")), [dict(np.load(tmp / f"rank{r}.npz"))
                                             for r in range(N)],
            outs[1][0], outs[2][0], tmp)


@pytest.mark.parametrize("rank", range(N))
def test_client_loss_and_grads_are_jax(runs, rank):
    jax_out, ranks, _, _, _ = runs
    got, c = ranks[rank], rank // M
    np.testing.assert_allclose(got["loss"], jax_out[f"loss{c}"], rtol=LOSS_RTOL)
    n = len([k for k in jax_out if k.startswith(f"grad{c}_")])
    assert n == len([k for k in got if k.startswith("grad")]) == 11
    for i in range(n):
        want = jax_out[f"grad{c}_{i}"]
        np.testing.assert_allclose(got[f"grad{i}"], want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()), err_msg=str(i))


@pytest.mark.parametrize("rank", range(N))
def test_dsgd_losses_are_jax(runs, rank):
    jax_out, ranks, _, _, _ = runs
    got = ranks[rank]
    np.testing.assert_allclose(got["dsgd_losses_plain"], jax_out["dsgd_losses"], rtol=0,
                               atol=DSGD_ATOL)
    np.testing.assert_allclose(got["dsgd_losses_streamed"], got["dsgd_losses_plain"], rtol=0,
                               atol=DSGD_ATOL)
    assert "'data', 'model'" in str(got["fsdp_pspecs"])     # fsdp's entries, as JAX's


@pytest.mark.parametrize("rank", range(N))
def test_serve_logits_are_jax(runs, rank):
    jax_out, ranks, _, _, _ = runs
    got = ranks[rank]
    cfg = reduced(get_config(ARCH))
    assert got["cache_heads"][3] == cfg.num_kv_heads // M       # this rank's KV heads
    for k in ("prefill", "decode0", "decode1"):
        want = jax_out[k]
        assert got[k].shape == want.shape == (B, cfg.vocab)
        np.testing.assert_allclose(got[k], want, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL * float(np.abs(want).max()), err_msg=k)


def _lines(text: str) -> list:
    return [(int(a), float(b), float(c)) for a, b, c in re.findall(
        r"step\s+(\d+) loss (\d+\.\d{4}) gnorm (\d+\.\d{3})", text)]


def test_launcher_lines_are_jax(runs):
    _, _, jax_text, port_text, _ = runs
    mesh_line = "arch=llama3.2-1b mesh={'data': 2, 'model': 2} sync=two_phase method=tnqsgd bits=3"
    assert mesh_line in jax_text and mesh_line in port_text
    want, got = _lines(jax_text), _lines(port_text)
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == list(range(STEPS))
    for (_, l1, g1), (_, l2, g2) in zip(got, want):
        assert abs(l1 - l2) <= 1e-4 + 1e-9 and abs(g1 - g2) <= 1e-3 + 1e-9, (got, want)


def test_checkpoint_holds_the_full_tree_and_resumes_on_any_mesh(runs):
    """Rank 0's checkpoint of the 2x2 run is the full tree, the model
    shards' slices gathered (model rank 0's whole leaves); the 4 ranks
    resume their slices from it at step 2, and one process resumes the
    same checkpoint on ``--mesh 1`` to the same loss within rtol 1e-5."""
    _, ranks, _, _, tmp = runs
    cfg = reduced(get_config(ARCH))
    like = transformer.init_lm(prng.key(0), cfg, device="meta")
    from repro_torch.optim.optimizers import momentum_sgd as sgd

    (params, _), step = load_checkpoint(tmp / "ckpt", (like, sgd().init(like)))
    assert step == 2
    for i, x in enumerate(tree_leaves(params)):
        assert np.array_equal(x.numpy(), ranks[0][f"final{i}"]), i
    for rk in ranks:
        assert rk["resumed_step"].tolist() == [2]
        assert rk["resumed"].tolist() == ranks[0]["resumed"].tolist()
    one = launcher.run(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", str(B),
                        "--seq", str(S), "--ckpt-dir", str(tmp / "ckpt"), "--steps", "1"])
    assert [h["step"] for h in one["history"]] == [2]
    np.testing.assert_allclose(one["history"][0]["loss"], ranks[0]["resumed"][0],
                               rtol=LOSS_RTOL)
