"""The paper's §V experiment on the PyTorch port: 8 clients, momentum SGD,
every gradient leaf quantized on its own, on the synthetic shapes dataset
(the counterpart of ``examples/train_8clients.py``, over
``repro_torch.train.train_clients``).

Run:  PYTHONPATH=src python examples/train_8clients_torch.py --method tnqsgd --rounds 120
"""
import argparse
import pathlib
import sys

_SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.train import train_clients  # noqa: E402


def main():
    ap = argparse.ArgumentParser(
        description="Per-layer adaptive bit plans (the JAX example's --adaptive) are not "
                    "offered here yet: their report table (launch/report.py) is not ported.")
    ap.add_argument("--method", default="tnqsgd",
                    choices=["dsgd", "qsgd", "nqsgd", "tqsgd", "tnqsgd", "tbqsgd"])
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--ef", action="store_true",
                    help="error feedback: compensate truncation bias with the client residual")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    acc, hist = train_clients(args.method, args.bits, rounds=args.rounds,
                              n_clients=args.clients, error_feedback=args.ef,
                              device=args.device)
    tag = args.method + ("+ef" if args.ef else "")
    print(f"loss: {hist[0]:.3f} -> {hist[-1]:.3f} over {args.rounds} rounds")
    print(f"test accuracy ({tag}, b={args.bits}, N={args.clients}): {acc:.4f}")


if __name__ == "__main__":
    main()
