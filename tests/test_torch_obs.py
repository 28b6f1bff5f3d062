"""The port's observability layer (``repro_torch.obs``: sink, spans, drift
monitor, report CLI) against the JAX package's ``repro.obs``, and the
launcher's ``--obs-dir`` on the CPU.

Contract:
- ``metrics_event`` of the same ``CompressionMetrics`` values (numpy into
  JAX's, torch into the port's; ``(n_dp, B)`` and ``(B,)`` leaves) is the
  same JSON line;
- each package's ``read_events`` reads the other's ``JsonlSink`` log, with
  the same warnings for a malformed line and a wrong schema version;
- ``EmaAggregator``, ``export_csv`` and ``SpanRecorder`` (a fake clock)
  give JAX's rows, file and events; the recorder synchronizes only a CUDA
  device;
- ``DriftMonitor`` gives JAX's events, messages and warnings for the same
  γ (also a stacked ``PowerLawTail``), ratio and live-fraction inputs;
- ``report.main`` prints what JAX's prints and writes the same ``--json``
  and ``--csv`` on one log;
- the launcher with ``--obs-dir`` (the reduced llama, 2 steps): bitwise
  the history and params of the same run without it; a span then a
  metrics event a step, each row the step's ``metrics_event``; both
  reports render the log alike.  Then 2 spawned gloo ranks with
  ``--adaptive --replan-every 2`` and a dropout rate: rank 0's log alone,
  the dropout events the host replay of ``live_mask``, an
  ``adaptive.replan`` span a replan, and the drift events a fresh monitor
  gives on the logged rows.

About 25 s alone in one process.
"""
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs.metrics import CompressionMetrics as JMetrics  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.codecs import get_codec  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.distributions import GAMMA_MAX, GAMMA_MIN, PowerLawTail  # noqa: E402
from repro_torch.dist import train_step  # noqa: E402
from repro_torch.elastic import ElasticConfig  # noqa: E402
from repro_torch.elastic.schedule import live_mask  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.smallnet import tree_leaves  # noqa: E402
from repro_torch.obs import report  # noqa: E402

ARGV = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
        "--sync", "faithful", "--ef"]
DROPOUT = 0.2    # drops peer 0 of 2 at steps 0 and 2 (the counter hash, seed 0x17E)


def _metrics(seed: int, shape: tuple[int, ...]):
    """The same random metric values as the JAX package's and the port's
    ``CompressionMetrics``."""
    rng = np.random.default_rng(seed)
    vals = {"bits": rng.integers(1, 9, shape).astype(np.int32),
            "rank": rng.integers(0, 5, shape).astype(np.int32)}
    for k in obs.METRIC_FIELDS[2:]:
        vals[k] = (rng.standard_exponential(shape) * 10.0 ** rng.integers(-9, 6, shape)
                   ).astype(np.float32)
    return (JMetrics(**vals),
            obs.CompressionMetrics(**{k: torch.from_numpy(v) for k, v in vals.items()}))


@pytest.mark.parametrize("shape", [(5,), (4, 5)])
def test_metrics_event_matches_jax(shape):
    jm, tm = _metrics(len(shape), shape)
    for step in (0, 7):
        want = jobs.metrics_event(step, jm)
        got = obs.metrics_event(step, tm)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        assert len(got["buckets"]) == 5 and got["step"] == step


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sink_cross_read(tmp_path, capsys, writer):
    jm, tm = _metrics(3, (2, 3))
    sink_cls, comp = (obs.JsonlSink, tm) if writer == "port" else (jobs.JsonlSink, jm)
    mev = obs.metrics_event if writer == "port" else jobs.metrics_event
    path = tmp_path / "events.jsonl"
    with sink_cls(path, flush_every=2) as sink:
        for step in range(3):
            sink.write(mev(step, comp))
        sink.write({"kind": "span", "name": "train.step", "t_start": 1.0, "dur_s": 0.5})
    assert sink.n_written == 4
    with path.open("a") as fh:
        fh.write("{not json\n")
        fh.write(json.dumps({"v": 99, "kind": "metrics"}) + "\n")
    got, err_port = obs.read_events(tmp_path), capsys.readouterr().err
    want, err_jax = jobs.read_events(tmp_path), capsys.readouterr().err
    assert got == want and len(got) == 4 and got[3]["v"] == obs.SCHEMA_VERSION
    assert err_port == err_jax
    assert "malformed" in err_port and str(path) in err_port and "unknown schema" in err_port
    assert obs.read_events(tmp_path / "none") == jobs.read_events(tmp_path / "none") == []


def test_ema_csv_and_spans(tmp_path):
    jm, tm = _metrics(5, (3, 4))
    events = [obs.metrics_event(i, tm) for i in range(4)]
    assert events == [jobs.metrics_event(i, jm) for i in range(4)]
    ema, jema = obs.EmaAggregator(decay=0.5), jobs.EmaAggregator(decay=0.5)
    for ev in events + [{"kind": "span"}]:
        ema.update(ev)
        jema.update(ev)
    assert ema.summary() == jema.summary() and ema.n_events == jema.n_events == 4
    with pytest.raises(ValueError, match="decay"):
        obs.EmaAggregator(decay=1.0)
    assert obs.export_csv(events, tmp_path / "a.csv") == jobs.export_csv(events,
                                                                       tmp_path / "b.csv") == 16
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
    recs = []
    for pkg in (obs, jobs):
        ticks = iter([0.0, 1.0, 2.0, 2.25, 3.0, 3.5])
        sink = pkg.JsonlSink(tmp_path / f"spans_{pkg.__name__}.jsonl", flush_every=1)
        rec = pkg.SpanRecorder(sink=sink, clock=lambda t=ticks: next(t))
        with rec.span("train.step", step=0):
            pass
        with rec.span("train.step", step=1, bits=3):
            pass
        with rec.span("adaptive.replan"):
            pass
        sink.close()
        recs.append((rec.summary(), pkg.read_events(sink.path)))
    assert recs[0] == recs[1]
    assert recs[0][0]["train.step"] == {"count": 2, "total_s": 1.25, "mean_s": 0.625, "max_s": 1.0}
    assert recs[0][1][1] == obs.span_event("train.step", 2.0, 0.25, 1, {"bits": 3})
    # a CPU device (or none) never synchronizes
    assert obs.SpanRecorder(device="cpu")._cuda is None and obs.SpanRecorder()._cuda is None


def test_drift_monitor_matches_jax(tmp_path):
    gammas = np.array([GAMMA_MIN, 4.0, GAMMA_MAX, 3.06, 4.99, 3.5], np.float32)
    realized = np.array([10.0, 1.0, 5.0, np.nan, 9.0, 4.5])
    predicted = np.array([1.0, 1.0, 0.0, 1.0, np.inf, 1.0])
    out = []
    for pkg, tails in ((obs, PowerLawTail(*(torch.from_numpy(gammas),) * 4)), (jobs, gammas)):
        sink = pkg.JsonlSink(tmp_path / f"drift_{pkg.__name__}.jsonl", flush_every=1)
        mon = pkg.DriftMonitor(sink=sink, ratio_threshold=4.0)
        with pytest.warns(pkg.ObsDriftWarning) as caught:
            t = mon.check_tails(tails, step=10)
            r = mon.check_ratio(realized, predicted, step=11)
            p = [mon.check_participation(f, step=s) for s, f in ((12, 0.25), (13, 0.5), (14, 1.0))]
        sink.close()
        out.append(([e.bucket for e in t], [e.bucket for e in r], [len(x) for x in p],
                    [str(w.message) for w in caught], [e.to_event() for e in mon.events],
                    pkg.read_events(sink.path)))
    assert out[0] == out[1]
    assert out[0][:3] == ([0, 2, 3, 4], [0, 5], [1, 0, 0])
    assert "railed outside the power-law" in out[0][3][0] and "ratio 10.00" in out[0][3][4]
    quiet = obs.DriftMonitor(warn=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet.check_tails(torch.tensor([GAMMA_MIN]))
        quiet.check_participation(torch.tensor(0.125))
    assert [e.kind for e in quiet.events] == ["tail_regime", "participation"]


def test_report_matches_jax(tmp_path, capsys):
    jm, tm = _metrics(7, (2, 3))
    log = tmp_path / "log"
    with obs.JsonlSink(log / "events.jsonl") as sink:
        mon = obs.DriftMonitor(sink=sink, warn=False, ratio_threshold=1.0)
        for i in range(3):
            sink.write(obs.span_event("train.step", float(i), 0.1 + 0.01 * i, step=i))
            ev = obs.metrics_event(i, tm)
            sink.write(ev)
            mon.check_ratio([r["realized_mse"] for r in ev["buckets"]],
                            [r["predicted_mse"] for r in ev["buckets"]], step=i)
        sink.write(obs.span_event("adaptive.replan", 2.0, 0.02))
    outs = []
    for name, main in (("port", report.main), ("jax", jreport.main)):
        out = tmp_path / name
        rc = main(["--dir", str(log), "--threshold", "1.5", "--json", str(out / "s.json"),
                   "--csv", str(out / "rows.csv")])
        outs.append((rc, capsys.readouterr().out.replace(str(out), "OUT")))
    assert outs[0] == outs[1] and outs[0][0] == 0
    assert "Phase breakdown" in outs[0][1] and "Drift warnings" in outs[0][1]
    for f in ("s.json", "rows.csv"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    summary = json.loads((tmp_path / "port" / "s.json").read_text())
    assert summary["n_steps"] == 3 and len(summary["buckets"]) == 3
    assert [p["name"] for p in summary["phases"]] == ["adaptive.replan", "train.step"]
    assert report.main(["--dir", str(tmp_path / "empty")]) == 1
    from repro_torch.obs.__main__ import main as cli

    assert cli(["report", "--dir", str(log)]) == 0 and cli(["nope"]) == 2


def test_launcher_obs_on_cpu(tmp_path, capsys):
    steps = []
    make = launcher.make_train_step

    def capture(*a, **kw):   # the step's metrics, as the launcher gets them
        fn = make(*a, **kw)

        def step(*args):
            out = fn(*args)
            steps.append(out[-1])
            return out
        return step

    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # facts F5, F10: the CPU's bits repeat at one thread
    try:
        plain = launcher.run(ARGV + ["--steps", "2"])
        launcher.make_train_step = capture
        got = launcher.run(ARGV + ["--steps", "2", "--obs-dir", str(tmp_path)])
    finally:
        launcher.make_train_step = make
        torch.set_num_threads(threads)
    assert got["history"] == plain["history"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got["params"]),
                                                 tree_leaves(plain["params"]), strict=True))
    events = obs.read_events(tmp_path)
    assert [(e["kind"], e["step"]) for e in events] == [("span", 0), ("metrics", 0),
                                                        ("span", 1), ("metrics", 1)]
    assert [events[1], events[3]] == [obs.metrics_event(i, m["compression"])
                                      for i, m in enumerate(steps)]
    sizes = train_step.local_bucket_sizes(got["params"], train_step.TrainStepConfig())
    cfg = CompressorConfig(method="tnqsgd", bits=3)
    for i, ev in enumerate((events[1], events[3])):
        assert [r["bucket"] for r in ev["buckets"]] == list(range(len(sizes)))
        for r, n in zip(ev["buckets"], sizes, strict=True):
            assert (r["bits"], r["rank"]) == (3, 0)
            assert r["wire_bytes"] == float(np.float32(get_codec("tnqsgd").wire_bytes(cfg, n)))
            assert r["alpha"] > 0 and 0 <= r["clip_frac"] <= 1
            assert r["realized_mse"] > 0 and r["predicted_mse"] > 0
            assert (r["ef_norm"] == 0) == (i == 0)
    assert got["obs"]["n_written"] == 4 and got["obs"]["spans"]["train.step"]["count"] == 2
    assert got["obs"]["drift"] == [e for e in events if e["kind"] == "drift"]
    assert plain["obs"] is None
    capsys.readouterr()
    texts = []
    for main in (report.main, jreport.main):
        assert main(["--dir", str(tmp_path)]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and "| train.step | 2 |" in texts[0]


def test_launcher_obs_two_ranks(tmp_path, capfd):
    n_steps, every = 3, 2
    assert launcher.main(ARGV + ["--steps", str(n_steps), "--fake-devices", "2", "--adaptive",
                                 "--replan-every", str(every), "--dropout-rate", str(DROPOUT),
                                 "--obs-dir", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["events.jsonl"]   # rank 0's alone
    events = obs.read_events(tmp_path)
    assert f"obs: {len(events)} events" in capfd.readouterr().out   # the ranks print to fd 1
    spans = [e for e in events if e["kind"] == "span"]
    assert [e["step"] for e in spans if e["name"] == "train.step"] == list(range(n_steps))
    replans = [i for i in range(n_steps) if i and i % every == 0]
    assert sum(e["name"] == "adaptive.replan" for e in spans) == len(replans) == 1
    metrics = [e for e in events if e["kind"] == "metrics"]
    assert [e["step"] for e in metrics] == list(range(n_steps))
    # the dropout events: the schedule replayed on the host
    want = []
    for i in range(n_steps):
        lv = live_mask(ElasticConfig(rate=DROPOUT), i, 2)
        if float(lv.sum()) < 2:
            want.append({"v": 1, "kind": "dropout", "step": i, "live": int(lv.sum()),
                         "n_peers": 2, "dropped": [p for p in range(2) if float(lv[p]) == 0.0]})
    dropouts = [e for e in events if e["kind"] == "dropout"]
    assert dropouts == want and len(want) == 2
    # a fresh monitor on the logged rows and live fractions gives the logged
    # ratio and participation events; tail events come from the replans
    mon = obs.DriftMonitor(warn=False)
    live = {e["step"]: e["live"] / e["n_peers"] for e in dropouts}
    for ev in metrics:
        mon.check_ratio([r["realized_mse"] for r in ev["buckets"]],
                        [r["predicted_mse"] for r in ev["buckets"]], step=ev["step"])
        mon.check_participation(live.get(ev["step"], 1.0), step=ev["step"])
    drift = [e for e in events if e["kind"] == "drift"]
    assert [e for e in drift if e["drift"] != "tail_regime"] == [e.to_event() for e in mon.events]
    assert all(e["step"] in replans for e in drift if e["drift"] == "tail_regime")
    # the JAX launcher's order within a step: span(s), metrics, drift, dropout
    kinds = [e["kind"] for e in events if e.get("step") == 2 and e["kind"] != "drift"]
    assert kinds == ["span", "metrics", "dropout"]
