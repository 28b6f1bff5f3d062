"""How far a bfloat16 mamba2 stack's decode drifts from its own prefill, in
the JAX package and in the PyTorch port, on the CPU.

Both from JAX's weights (``init_lm(key(0))``, the original threefry
layout) on mamba2-2.7b's config at a given depth and width (vocab 4,096):
prefill 64 tokens, decode the 65th, and compare its logits with a prefill
over all 65 (the relative L2 of the difference); also the port's 65-token
prefill against JAX's.  Float32 rounding noise in bfloat16 grows with the
depth, in the reference as in the port.

Run:  PYTHONPATH=src python tools/ssm_bf16_drift.py --layers 64 --d-model 1024
Prints one JSON line.
"""
import argparse
import json

import jax

jax.config.update("jax_threefry_partitionable", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import lm_batch as jlm_batch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=1024)
    args = ap.parse_args(argv)
    kw = dict(num_layers=args.layers, d_model=args.d_model, vocab=4096)
    cfg, jcfg = get_config("mamba2-2.7b").replace(**kw), jget_config("mamba2-2.7b").replace(**kw)
    jp, _ = jtf.init_lm(jax.random.key(0), jcfg)
    p = transformer.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.asarray(jlm_batch(jcfg, jnp.uint32(0), 2, 65).tokens)

    jprefill = jax.jit(lambda p, t: jtf.prefill(jcfg, p, jtf.Batch(tokens=t, labels=t)))
    _, jc = jprefill(jp, toks[:, :64])
    jdec, _ = jax.jit(lambda p, t, c: jtf.decode_step(jcfg, p, t, c, jnp.int32(64)))(
        jp, toks[:, 64:65], jc)
    jref, _ = jprefill(jp, toks)

    tt = torch.from_numpy(toks.astype(np.int64))
    with torch.inference_mode():
        _, c = transformer.prefill(cfg, p, transformer.Batch(tokens=tt[:, :64], labels=tt[:, :64]))
        dec, _ = transformer.decode_step(cfg, p, tt[:, 64:65], c, 64)
        ref, _ = transformer.prefill(cfg, p, transformer.Batch(tokens=tt, labels=tt))
    print(json.dumps({
        "arch": "mamba2-2.7b", "layers": args.layers, "d_model": args.d_model,
        "dtype": "bfloat16", "jax_decode_vs_prefill_rel_l2": rel_l2(jdec, jref),
        "port_decode_vs_prefill_rel_l2": rel_l2(dec.numpy(), ref.numpy()),
        "port_vs_jax_prefill_rel_l2": rel_l2(ref.numpy(), jref)}))


if __name__ == "__main__":
    main()
