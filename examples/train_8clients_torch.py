"""The paper's §V experiment on the PyTorch port: 8 clients, momentum SGD,
every gradient leaf quantized on its own, on the synthetic shapes dataset
(the counterpart of ``examples/train_8clients.py``, over
``repro_torch.train.train_clients``).

Run:  PYTHONPATH=src python examples/train_8clients_torch.py --method tnqsgd --rounds 120
          [--adaptive] [--device cpu]
"""
import argparse
import pathlib
import sys

_SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.train import train_clients  # noqa: E402


def adaptive_leaf_plan(method: str, bits: int, device="cuda"):
    """Per-leaf bit plan from a probe gradient: fit one power-law tail per
    gradient leaf, then water-fill wire bits under the uniform-``bits``
    budget (the JAX example's ``_adaptive_leaf_plan``).  Returns
    (BitPlan, table_markdown)."""
    from repro_torch.adaptive.controller import allocate_bits
    from repro_torch.core import prng
    from repro_torch.core.compressors import CompressorConfig, wire_bytes
    from repro_torch.core.distributions import fit_empirical_density, fit_power_law_tail
    from repro_torch.data.synthetic import client_batches, make_templates
    from repro_torch.launch.report import adaptive_table
    from repro_torch.models.smallnet import init_smallnet
    from repro_torch.train import client_grads

    params = init_smallnet(prng.key(0), device=device)
    templates = make_templates(prng.key(42), device=device)
    imgs, labels = client_batches(templates, 0, 1, 64)
    _, stacked = client_grads(params, imgs, labels)
    leaves = [g[0] for g in stacked]
    tails = [fit_power_law_tail(g) for g in leaves]
    dens = [fit_empirical_density(g) for g in leaves]
    sizes = [g.numel() for g in leaves]
    ccfg = CompressorConfig(method=method, bits=bits)
    plan = allocate_bits(tails, sizes, wire_bytes(ccfg, sizes), ccfg, dens=dens)
    table = adaptive_table(sizes, plan.bits, plan.alphas,
                           gammas=[float(t.gamma) for t in tails],
                           rhos=[float(t.rho) for t in tails])
    return plan, table


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="tnqsgd",
                    choices=["dsgd", "qsgd", "nqsgd", "tqsgd", "tnqsgd", "tbqsgd"])
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--ef", action="store_true",
                    help="error feedback: compensate truncation bias with the client residual")
    ap.add_argument("--adaptive", action="store_true",
                    help="per-layer wire bits from fitted tails at the uniform-bits budget")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    bits_plan = None
    if args.adaptive and args.method != "dsgd":
        plan, table = adaptive_leaf_plan(args.method, args.bits, args.device)
        bits_plan = plan.bits
        print(f"adaptive per-layer plan ({plan.spend_bytes}/{plan.budget_bytes} wire B):")
        print(table)
    acc, hist = train_clients(args.method, args.bits, rounds=args.rounds,
                              n_clients=args.clients, error_feedback=args.ef,
                              bits_plan=bits_plan, device=args.device)
    tag = args.method + ("+ef" if args.ef else "") + ("+adaptive" if bits_plan else "")
    print(f"loss: {hist[0]:.3f} -> {hist[-1]:.3f} over {args.rounds} rounds")
    print(f"test accuracy ({tag}, b={args.bits}, N={args.clients}): {acc:.4f}")


if __name__ == "__main__":
    main()
