"""Quickstart of the PyTorch port: the two-stage quantizer as a library,
end to end (the counterpart of ``examples/quickstart.py``).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import pathlib
import sys

_SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import torch  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.compressors import (CompressorConfig, compress_decompress,  # noqa: E402
                                          decode, encode, plan, wire_bytes)
from repro_torch.core.distributions import fit_power_law_tail, sample_power_law  # noqa: E402
from repro_torch.train import resolve_device  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # 1. A heavy-tailed "gradient" with a known power-law tail.
    g = sample_power_law(prng.key(0), (1_000_000,), gamma=4.0, g_min=0.01, rho=0.1,
                         device=device)

    # 2. Fit the tail (Hill estimator): paper Eq. 10 and §V.
    tail = fit_power_law_tail(g)
    print(f"fitted tail: gamma={float(tail.gamma):.2f} g_min={float(tail.g_min):.4f} "
          f"rho={float(tail.rho):.3f}")

    # 3. Compare every scheme at b=3 (the paper's headline setting).
    for method in ("qsgd", "nqsgd", "tqsgd", "tnqsgd", "tbqsgd"):
        cfg = CompressorConfig(method=method, bits=3)
        out = compress_decompress(cfg, g, prng.key(1))
        mse = float(torch.mean((out - g) ** 2))
        meta = plan(cfg, g)
        bytes_per = wire_bytes(cfg, g.numel()) / g.numel()
        print(f"{method:8s} alpha={float(meta.alpha):.4f} mse={mse:.3e} "
              f"wire={bytes_per:.3f} B/elem (fp32: 4.0)")

    # 4. Wire-format round trip (what the collectives move).
    cfg = CompressorConfig(method="tnqsgd", bits=3)
    meta = plan(cfg, g)
    payload = encode(cfg, g, meta, prng.key(2))
    g_hat = decode(cfg, payload, meta, tuple(g.shape))
    print(f"payload: {payload.numel() * 4} bytes for {g.numel()} elements "
          f"({payload.numel() * 32 / g.numel():.2f} bits/elem), "
          f"recon err={float(torch.mean((g_hat - g) ** 2)):.3e}")


if __name__ == "__main__":
    main()
