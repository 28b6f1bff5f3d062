"""``python -m repro_torch.analysis`` — run the three static-analysis passes.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis [--json ANALYSIS.json]
        [--pass sync|ast|kernels ...] [--quick] [--device cuda|cpu]

The sync pass runs its four gloo ranks on ``cuda:0`` by default (on the CPU
with ``--device cpu``); the kernels pass reads the build's ``-Xptxas -v``
reports and so needs ``nvcc`` (the card's machine).  Exit status is
non-zero iff any finding survives suppression.  The JSON report keeps the
JAX package's layout with the port's pass names::

    {"version": 1,
     "passes": {"sync":    {"traces": N, "per_trace": {...}},
                "ast":     {"files": N},
                "kernels": {"kernels": N, "table": [...], "per_kernel": {...}}},
     "findings": [{"code": ..., "where": ..., "message": ...}],
     "clean": true}
"""
from __future__ import annotations

import argparse
import json
import sys

PASSES = ("sync", "ast", "kernels")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="three-pass static analysis of the port")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the ANALYSIS.json report here")
    ap.add_argument("--pass", dest="passes", action="append", choices=PASSES,
                    metavar="|".join(PASSES), default=None,
                    help="run only the named pass (repeatable; default: all)")
    ap.add_argument("--quick", action="store_true",
                    help="sync pass: one method per codec family")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the sync pass's ranks run")
    args = ap.parse_args(argv)
    selected = tuple(args.passes) if args.passes else PASSES

    findings = []
    passes: dict[str, dict] = {}

    if "sync" in selected:
        from repro_torch.analysis import sync_lint

        f, stats = sync_lint.run_pass(quick=args.quick, device=args.device)
        findings += f
        passes["sync"] = stats
        print(f"[sync]    {stats['traces']} runs on {sync_lint.N_RANKS} ranks "
              f"({args.device}), {len(f)} finding(s)")

    if "ast" in selected:
        from repro_torch.analysis import ast_lint

        f, stats = ast_lint.run_pass()
        findings += f
        passes["ast"] = stats
        print(f"[ast]     {stats['files']} files, {len(f)} finding(s)")

    if "kernels" in selected:
        from repro_torch.analysis import kernel_resources

        f, table = kernel_resources.run_pass()
        findings += f
        per = kernel_resources.per_kernel(table)
        passes["kernels"] = {"kernels": len(table), "table": [e.to_json() for e in table],
                             "per_kernel": per}
        print(f"[kernels] {len(table)} entry functions, K1-K17 "
              f"{sum(1 for row in per.values() if row['entries'])}/17, most registers "
              f"{max((e.registers for e in table), default=0)}, most shared memory "
              f"{max((e.smem_bytes for e in table), default=0)} B, spill stores "
              f"{sum(e.spill_stores for e in table)} B, {len(f)} finding(s)")

    for f in findings:
        print(f"  {f}", file=sys.stderr)

    report = {"version": 1, "passes": passes,
              "findings": [f.to_json() for f in findings],
              "clean": not findings}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
        print(f"report -> {args.json}")

    if findings:
        print(f"FAIL: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
