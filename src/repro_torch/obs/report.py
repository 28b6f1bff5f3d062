"""Render observability reports from ``runs/obs/*.jsonl`` event logs — the
port of ``repro.obs.report``: on the same log it prints what the JAX
package's prints and writes the same ``--json`` summary.

``python -m repro_torch.obs report --dir runs/obs`` prints

- a per-bucket table (bits/rank, EMA-smoothed α, clip %, wire bytes,
  predicted vs realized per-element MSE and their ratio), flagging buckets
  whose realized/predicted ratio exceeds ``--threshold`` — i.e. where the
  heavy-tail fit the controller relied on broke;
- a step-time phase breakdown from the wall-clock ``"span"`` events;
- any structured ``"drift"`` warnings the run recorded.

``--json OBS.json`` additionally writes the machine-readable summary;
``--csv FILE`` dumps the raw per-step metric rows.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from .sink import EmaAggregator, export_csv, read_events

DEFAULT_THRESHOLD = 2.0


def _ratio(row: dict) -> float | None:
    pred = row.get("predicted_mse", 0.0)
    if not pred or pred <= 0.0:
        return None
    return row.get("realized_mse", 0.0) / pred


def summarize(events: list[dict], threshold: float = DEFAULT_THRESHOLD,
              ema_decay: float = 0.9) -> dict:
    """Aggregate an event list into the OBS summary dict."""
    ema = EmaAggregator(decay=ema_decay)
    steps = set()
    for ev in events:
        if ev.get("kind") == "metrics":
            steps.add(ev.get("step"))
            ema.update(ev)
    buckets = []
    for row in ema.summary():
        ratio = _ratio(row)
        buckets.append({**row, "ratio": ratio,
                        "flagged": bool(ratio is not None and ratio > threshold)})
    spans: dict[str, dict] = {}
    for ev in events:
        if ev.get("kind") != "span":
            continue
        agg = spans.setdefault(ev["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += ev.get("dur_s", 0.0)
        agg["max_s"] = max(agg["max_s"], ev.get("dur_s", 0.0))
    phases = [{"name": k, **v, "mean_s": v["total_s"] / v["count"]}
              for k, v in sorted(spans.items())]
    drift = [ev for ev in events if ev.get("kind") == "drift"]
    return {"version": 1, "n_events": len(events), "n_steps": len(steps),
            "threshold": threshold, "buckets": buckets, "phases": phases,
            "drift": drift,
            "flagged": [b["bucket"] for b in buckets if b["flagged"]]}


def bucket_table(summary: dict) -> str:
    rows = ["| bucket | bits | rank | alpha | clip % | wire B | predicted | "
            "realized | ratio | |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    fmt = lambda v: "-" if v is None else f"{v:.3e}"
    for b in summary["buckets"]:
        flag = "**DRIFT**" if b["flagged"] else ""
        ratio_s = "-" if b["ratio"] is None else f"{b['ratio']:.2f}"
        rows.append(
            f"| {b['bucket']} | {b.get('bits', 0):.0f} | {b.get('rank', 0):.0f} "
            f"| {fmt(b.get('alpha'))} | {100.0 * b.get('clip_frac', 0.0):.2f} "
            f"| {b.get('wire_bytes', 0):.0f} | {fmt(b.get('predicted_mse'))} "
            f"| {fmt(b.get('realized_mse'))} | {ratio_s} | {flag} |")
    return "\n".join(rows)


def phase_table(summary: dict) -> str:
    rows = ["| phase | count | total (s) | mean (ms) | max (ms) |",
            "|---|---|---|---|---|"]
    for p in summary["phases"]:
        rows.append(f"| {p['name']} | {p['count']} | {p['total_s']:.3f} "
                    f"| {1e3 * p['mean_s']:.1f} | {1e3 * p['max_s']:.1f} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs report")
    ap.add_argument("--dir", default="runs/obs",
                    help="directory of *.jsonl event files (or one file)")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="realized/predicted MSE ratio above which a bucket "
                         "is flagged as drifted")
    ap.add_argument("--ema", type=float, default=0.9, help="EMA decay")
    ap.add_argument("--json", default=None, dest="json_path",
                    help="write the machine-readable OBS summary here")
    ap.add_argument("--csv", default=None, dest="csv_path",
                    help="export raw per-step metric rows as CSV")
    args = ap.parse_args(argv)

    events = read_events(args.dir)
    if not events:
        print(f"no events under {args.dir}")
        return 1
    summary = summarize(events, threshold=args.threshold, ema_decay=args.ema)

    print(f"## Compression metrics ({summary['n_steps']} steps, "
          f"{len(summary['buckets'])} buckets, EMA decay {args.ema}, "
          f"drift threshold {args.threshold:g})\n")
    print(bucket_table(summary))
    if summary["flagged"]:
        print(f"\ndrifted buckets (realized/predicted > {args.threshold:g}): "
              f"{summary['flagged']}")
    if summary["phases"]:
        print("\n## Phase breakdown (host wall clock)\n")
        print(phase_table(summary))
    if summary["drift"]:
        print(f"\n## Drift warnings ({len(summary['drift'])})\n")
        for ev in summary["drift"]:
            print(f"- {ev.get('message', ev)}")

    if args.csv_path:
        n = export_csv(events, args.csv_path)
        print(f"\nwrote {n} rows to {args.csv_path}")
    if args.json_path:
        pathlib.Path(args.json_path).write_text(json.dumps(summary, indent=2) + "\n")
        print(f"wrote {args.json_path}")
    return 0
