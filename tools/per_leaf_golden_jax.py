"""The JAX package's per-leaf (``bucket_mb=0``) smallnet losses that
``chip_smoke.py`` holds the PyTorch port's per-leaf runs to.

The run of ``tests/test_golden_convergence.py::_run`` (8 clients, batch 32,
tnqsgd at 3 bits, momentum SGD, the sync key ``fold_in(key(0x5EED), i)``)
with ``TrainStepConfig(bucket_mb=0)``, on the CPU, under the original
threefry layout the port draws in (``jax_threefry_partitionable`` off).

- ``--whole-step`` jits the whole step, sync included, as the golden
  harness does (the faithful mode: 64 plans a step compile in about a
  minute).
- Otherwise the gradients and the optimizer run jitted and the per-leaf
  sync (``repro.dist.reference.reference_sync``) eagerly, its sort-based
  plans and fused encodes jitted one call at a time: two_phase (8,) and
  hierarchical (2, 4) plan 576 and 336 tensors a step, too many for one
  compiled step.

Run:  PYTHONPATH=src python tools/per_leaf_golden_jax.py two_phase 3
      PYTHONPATH=src python tools/per_leaf_golden_jax.py hierarchical 3 --dp 2,4
      PYTHONPATH=src python tools/per_leaf_golden_jax.py faithful 30 --whole-step
Prints the per-step losses as one JSON line.
"""
import argparse
import json
import time

import jax

jax.config.update("jax_threefry_partitionable", False)

import jax.numpy as jnp  # noqa: E402

from repro.core.compressors import CompressorConfig, plan  # noqa: E402
from repro.core.quantizers import QuantMeta  # noqa: E402
from repro.data.synthetic import client_batches, make_templates  # noqa: E402
from repro.dist import reference, sharded_codec  # noqa: E402
from repro.dist.train_step import TrainStepConfig  # noqa: E402
from repro.models.smallnet import init_smallnet, smallnet_loss  # noqa: E402
from repro.optim.optimizers import momentum_sgd  # noqa: E402

N_CLIENTS, BATCH = 8, 32
_plan = jax.jit(plan, static_argnums=0)
_row_plans = jax.jit(lambda cfg, rows: jax.vmap(lambda r: plan(cfg, r))(rows), static_argnums=0)
_encode = jax.jit(sharded_codec.encode_pack, static_argnums=(0, 4))
_row_encodes = jax.jit(
    lambda cfg, rows, levels, alpha, keys: jax.vmap(
        lambda r, lv, a, k: sharded_codec.encode_pack(cfg, r, QuantMeta(levels=lv, alpha=a), k,
                                                      False))(rows, levels, alpha, keys),
    static_argnums=0)


def _plan_encode_rows(cfg, rows, key, use_pallas):
    metas = _row_plans(cfg, rows)
    keys = jax.random.split(key, rows.shape[0])
    return _row_encodes(cfg, rows, metas.levels, metas.alpha, keys), metas


def run(sync: str, method: str, dp: tuple, steps: int, whole_step: bool) -> list[float]:
    ts = TrainStepConfig(sync=sync, bucket_mb=0,
                         compressor=CompressorConfig(method=method, bits=3))
    templates = make_templates(jax.random.key(42))
    params = init_smallnet(jax.random.key(0))
    opt = momentum_sgd(lr=0.01, momentum=0.9, weight_decay=5e-4)
    state = opt.init(params)

    def grads(p, i):
        imgs, labels = client_batches(templates, i, N_CLIENTS, BATCH)
        losses, g = jax.vmap(lambda im, lb: jax.value_and_grad(smallnet_loss)(p, im, lb))(
            imgs, labels)
        return jnp.mean(losses), g

    def sync_step(g, i):
        leaves, treedef = jax.tree.flatten(g)
        key = jax.random.fold_in(jax.random.key(0x5EED), i)
        return jax.tree.unflatten(treedef, reference.reference_sync(ts, leaves, dp, key))

    def step(p, s, i):
        loss, g = grads(p, i)
        p2, s2 = opt.update(p, sync_step(g, i), s, i)
        return p2, s2, loss

    update = jax.jit(lambda p, s, g, i: opt.update(p, g, s, i))
    grads_jit, step_jit = jax.jit(grads), jax.jit(step)
    hist = []
    for i in range(steps):
        i32 = jnp.uint32(i)
        if whole_step:
            params, state, loss = step_jit(params, state, i32)
        else:
            loss, g = grads_jit(params, i32)
            saved = reference.plan, sharded_codec._plan_encode_rows, sharded_codec.encode_pack
            reference.plan, sharded_codec._plan_encode_rows = _plan, _plan_encode_rows
            sharded_codec.encode_pack = _encode
            try:
                mean = sync_step(g, i32)
            finally:
                reference.plan, sharded_codec._plan_encode_rows, sharded_codec.encode_pack = saved
            params, state = update(params, state, mean, i32)
        hist.append(float(loss))
    return hist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sync", choices=["faithful", "two_phase", "hierarchical"])
    ap.add_argument("steps", type=int)
    ap.add_argument("--method", default="tnqsgd")
    ap.add_argument("--dp", default="8", help="the (pods…, data) layout, e.g. 2,4")
    ap.add_argument("--whole-step", action="store_true", help="jit the whole step, sync included")
    args = ap.parse_args()
    dp = tuple(int(x) for x in args.dp.split(","))
    t0 = time.time()
    hist = run(args.sync, args.method, dp, args.steps, args.whole_step)
    print(json.dumps(dict(sync=args.sync, method=args.method, dp=dp, steps=args.steps,
                          whole_step=args.whole_step, losses=hist,
                          seconds=time.time() - t0)))


if __name__ == "__main__":
    main()
