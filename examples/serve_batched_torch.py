"""Serving example of the PyTorch port: batched prefill + greedy decode
with KV caches (the counterpart of ``examples/serve_batched.py``).

Runs a reduced llama (or another --arch of the zoo) through
``dist.serve_step.make_serve_fns``: prefill a batch of prompts, then
greedily decode tokens step by step.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py --arch qwen2-vl-2b --tokens 16 [--device cpu]
"""
import argparse
import pathlib
import sys

_SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import torch  # noqa: E402

from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.dist.serve_step import make_serve_fns  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.train import resolve_device  # noqa: E402

#: the archs the port serves: every arch of the zoo
SERVED_ARCHS = list_archs()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=SERVED_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    params = init_lm(prng.key(0), cfg, device=device)
    batch = lm_batch(cfg, 0, args.batch, args.prompt_len, device=device)
    prefill_fn, decode_fn = make_serve_fns(cfg, args.prompt_len)

    logits, caches = prefill_fn(params, batch)
    print(f"prefilled {args.batch} x {args.prompt_len}; logits {tuple(logits.shape)}")

    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    for i in range(args.tokens - 1):
        logits, caches = decode_fn(params, tok, caches, args.prompt_len + i)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    seqs = torch.cat(out, dim=1)
    print("greedy decode:")
    for row in seqs.tolist():
        print("  ", row)


if __name__ == "__main__":
    main()
