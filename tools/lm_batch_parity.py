"""How far the PyTorch port's ``lm_batch`` is from the JAX package's, at
the batch shapes the port serves on the card.

Both under the original threefry layout (``jax_threefry_partitionable``
off), on the CPU.  For each shape it prints the tokens that differ, the
``uniform`` draws that differ (JAX's jitted ``u·(1 − 1e-6) + 1e-6``
against ``prng.uniform``'s two roundings), and the draws that still differ
when the port's map runs fused in float64 and is rounded once, as XLA's
contracted multiply-add rounds.

Run:  PYTHONPATH=src python tools/lm_batch_parity.py
Prints one JSON line per shape.
"""
import json

import jax

jax.config.update("jax_threefry_partitionable", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import lm_batch as jlm_batch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402

SHAPES = (("llama3.2-1b", 4, 64), ("llama3.2-1b", 4, 2048), ("qwen2-vl-2b", 4, 320),
          ("whisper-base", 4, 64), ("gemma-7b", 8, 4096))
LO = np.float32(1e-6)


def main():
    for arch, b, s in SHAPES:
        jb = jlm_batch(jget_config(arch), jnp.uint32(0), b, s)
        ours = lm_batch(get_config(arch), 0, b, s, device="cpu")
        k_tok = jax.random.split(jax.random.fold_in(jax.random.key(0), 0))[0]
        ju = np.asarray(jax.jit(lambda k: jax.random.uniform(k, (b, s), minval=1e-6))(k_tok))
        t_tok = prng.split(prng.fold_in(prng.key(0), 0))[0]
        u = prng.uniform(t_tok, (b, s), "cpu", minval=1e-6).numpy()
        f = prng._unit_floats(prng.random_bits(t_tok, (b, s))).numpy().astype(np.float64)
        fused = np.maximum((f * np.float64(np.float32(1.0) - LO) + np.float64(LO))
                           .astype(np.float32), LO)
        print(json.dumps({"arch": arch, "batch": b, "seq": s, "tokens": b * s,
                          "tokens_differ": int((ours.tokens.numpy() != np.asarray(jb.tokens)).sum()),
                          "uniform_differ": int((u != ju).sum()),
                          "fused_uniform_differ": int((fused != ju).sum())}))


if __name__ == "__main__":
    main()
