"""Report tables — the port of ``repro.launch.report``: the dry-run and
roofline tables over ``runs/dryrun_torch/*.json`` (``launch.dryrun``), and
the adaptive bit plan's table.  Given the same records, each table is the
JAX package's string, so each package renders the other's records.

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [--dir runs/dryrun_torch]
            [--mesh 1]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

RUNS = pathlib.Path(__file__).resolve().parents[3] / "runs" / "dryrun_torch"
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
_MESH = re.compile(r"\d+(x\d+)*")


def load(dirpath: pathlib.Path, canonical: bool = True):
    """Canonical records: <arch>__<shape>__<mesh>.json, the mesh a spec
    such as ``1``, ``4``, ``16x16`` or ``2x16x16`` (the JAX package's
    canonical names are among them); other files (a sync variant's
    ``…__16x16_<sync>.json``) are excluded unless canonical=False.  An
    unreadable record is skipped with a warning."""
    recs = []
    for f in sorted(dirpath.glob("*.json")):
        parts = f.stem.split("__")
        is_canon = len(parts) == 3 and _MESH.fullmatch(parts[2]) is not None
        if canonical != is_canon:
            continue
        try:
            recs.append(json.loads(f.read_text()))
        except (OSError, json.JSONDecodeError) as e:
            print(f"warning: skipping unreadable record {f}: {e}", file=sys.stderr)
    return recs


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def _shape_key(r):
    return SHAPE_ORDER.index(r["shape"]) if r["shape"] in SHAPE_ORDER else 9


def roofline_table(recs, mesh="16x16") -> str:
    rows = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | bottleneck | "
        "useful FLOPs | HBM GiB/dev | compile (s) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted([r for r in recs if r["mesh"] == mesh], key=lambda r: (r["arch"],
                                                                           _shape_key(r))):
        rl = r["roofline"]
        mem = r["memory"].get("total_per_device_bytes", 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']*1e3:.1f} | {rl['memory_s']*1e3:.1f} "
            f"| {rl['collective_s']*1e3:.1f} | {rl['bottleneck']} | {rl['useful_flops_ratio']:.2f} "
            f"| {fmt_bytes(mem)} | {r['compile_s']:.0f} |"
        )
    return "\n".join(rows)


def dryrun_table(recs) -> str:
    rows = [
        "| arch | shape | mesh | params | FLOPs/dev | HBM bytes/dev | collective bytes/dev | "
        "ag / ar / rs / a2a / cp (GiB) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], _shape_key(r), r["mesh"])):
        rl = r["roofline"]
        kinds = rl.get("collective_bytes_by_kind", {})

        def gk(k):
            return kinds.get(k, 0) / 2**30

        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['n_params']/1e9:.1f}B "
            f"| {rl['flops']:.2e} | {rl['hbm_bytes']:.2e} | {rl['collective_bytes']:.2e} "
            f"| {gk('all-gather'):.1f} / {gk('all-reduce'):.1f} / {gk('reduce-scatter'):.1f} / "
            f"{gk('all-to-all'):.1f} / {gk('collective-permute'):.1f} |"
        )
    return "\n".join(rows)


def adaptive_table(sizes, bits, alphas=None, gammas=None, rhos=None) -> str:
    """Markdown table of one adaptive bit plan: per-bucket elements, wire
    bits, solver α and (when known) the telemetry-estimated tail (γ, ρ).
    Used by ``launch.train --adaptive`` and
    ``examples/train_8clients_torch.py --adaptive``."""
    n = len(sizes)
    alphas = list(alphas) if alphas else [None] * n
    gammas = list(gammas) if gammas is not None else [None] * n
    rhos = list(rhos) if rhos is not None else [None] * n
    rows = ["| bucket | elements | bits | alpha | gamma | rho |",
            "|---|---|---|---|---|---|"]

    def fmt(v, spec):
        return format(float(v), spec) if v is not None else "-"

    for b in range(n):
        rows.append(
            f"| {b} | {sizes[b]} | {bits[b]} | {fmt(alphas[b], '.3e')} "
            f"| {fmt(gammas[b], '.2f')} | {fmt(rhos[b], '.3f')} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dir", default=str(RUNS))
    ap.add_argument("--mesh", default="1")
    args = ap.parse_args(argv)
    recs = load(pathlib.Path(args.dir))
    print(f"## Roofline ({args.mesh}, {len(recs)} records)\n")
    print(roofline_table(recs, args.mesh))
    print("\n## Dry-run detail\n")
    print(dryrun_table(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
