"""The port's elastic schedule and chaos traces (``repro_torch.elastic``)
against the JAX package's ``repro.elastic``, on the CPU.

- ``live_mask`` is JAX's bit for bit: the counter hash over seeds × steps
  0–199 × n ∈ {1, 3, 8, 16} × rate ∈ {0, 0.2, 0.75, 1}, each with
  ``min_live`` 1, 2 and 64 (the floor and its fallback), with the step a
  Python int and a 0-d tensor; and over chaos-trace rows, the step
  wrapping the table.  JAX evaluates the 200 steps in one vmapped eager
  call, no compilation per case.
- ``expected_live_fraction`` equals JAX's float; ``budget_bytes`` fed by
  it equals JAX's.
- The config and trace checks raise JAX's errors with JAX's messages; the
  scenario constructors give JAX's rows and names; a trace file saved by
  either package loads in the other.

About 22 s alone in one process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import elastic as jel  # noqa: E402
from repro.adaptive import controller as jctl  # noqa: E402
from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro_torch import elastic as el  # noqa: E402
from repro_torch.adaptive import controller  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402

STEPS = 200
SEEDS = (0, 0x17E, (1 << 32) + 5)
MIN_LIVE = (1, 2, 64)


def _jax_masks(cfg, n: int, steps: int = STEPS) -> np.ndarray:
    return np.asarray(jax.vmap(lambda s: jel.live_mask(cfg, s, n))(
        jnp.arange(steps, dtype=jnp.uint32)))


def _port_masks(cfg, n: int, steps: int = STEPS, as_tensor: bool = False) -> np.ndarray:
    out = [el.live_mask(cfg, torch.tensor(s) if as_tensor else s, n) for s in range(steps)]
    assert all(m.dtype == torch.float32 and m.shape == (n,) for m in out)
    return torch.stack(out).numpy()


@pytest.mark.parametrize("rate", (0.0, 0.2, 0.75, 1.0))
@pytest.mark.parametrize("n", (1, 3, 8, 16))
def test_live_mask_bitwise(n, rate):
    for seed in SEEDS:
        for min_live in MIN_LIVE:
            want = _jax_masks(jel.ElasticConfig(rate=rate, seed=seed, min_live=min_live), n)
            cfg = el.ElasticConfig(rate=rate, seed=seed, min_live=min_live)
            assert np.array_equal(_port_masks(cfg, n), want), (seed, min_live)
            assert np.array_equal(_port_masks(cfg, n, 8, as_tensor=True), want[:8]), (seed,
                                                                                     min_live)
            if rate == 0.0:
                assert (want == 1.0).all()


def test_live_mask_trace_rows_bitwise():
    rows = ((1, 0, 1, 1), (0, 0, 0, 0), (0, 1, 0, 0), (1, 1, 1, 1), (0, 0, 1, 1))
    for min_live in (1, 2, 3, 64):
        want = _jax_masks(jel.ElasticConfig(trace=rows, min_live=min_live), 4, 23)
        got = _port_masks(el.ElasticConfig(trace=rows, min_live=min_live), 4, 23)
        assert np.array_equal(got, want), min_live
    with pytest.raises(ValueError) as jerr:
        jel.live_mask(jel.ElasticConfig(trace=rows), 0, 5)
    with pytest.raises(ValueError) as err:
        el.live_mask(el.ElasticConfig(trace=rows), 0, 5)
    assert str(err.value) == str(jerr.value)


def test_live_mask_on_the_callers_device():
    cfg = el.ElasticConfig(rate=0.2)
    assert el.live_mask(cfg, 3, 8).device.type == "cpu"
    assert el.live_mask(cfg, torch.tensor(3), 8, device="cpu").device.type == "cpu"
    counts = [int(el.live_mask(el.ElasticConfig(rate=0.2, seed=0x17E), i, 8).sum())
              for i in range(30)]
    # the golden dropout run's schedule (tests/test_golden_convergence.py)
    assert counts == [4, 7, 7, 8, 6, 6, 4, 6, 6, 5, 8, 6, 7, 7, 5, 5, 7, 8, 6, 5, 5, 7, 6, 6,
                      8, 7, 6, 7, 7, 5]


@pytest.mark.parametrize("n", (1, 3, 8, 16))
def test_expected_live_fraction_and_budget_match_jax(n):
    sizes, acfg, jacfg = [4928, 200704, 1290], controller.AdaptiveConfig(), jctl.AdaptiveConfig()
    for rate, start, window in ((0.0, 0, 10), (0.2, 0, 30), (0.2, 17, 5), (0.75, 3, 1),
                                (1.0, 0, 4), (0.5, 11, 0)):
        jcfg, cfg = jel.ElasticConfig(rate=rate), el.ElasticConfig(rate=rate)
        want = jel.expected_live_fraction(jcfg, n, start, window)
        got = el.expected_live_fraction(cfg, n, start, window)
        assert isinstance(got, float) and got == want, (rate, start, window)
        for method in ("tnqsgd", "qsgd"):
            assert controller.budget_bytes(acfg, CompressorConfig(method=method), sizes, got) == \
                jctl.budget_bytes(jacfg, JConfig(method=method), sizes, want)
    assert el.expected_live_fraction(None, n, 0, 5) == jel.expected_live_fraction(None, n, 0,
                                                                                   5) == 1.0
    assert el.expected_live_fraction(el.ElasticConfig(rate=1.0), 0, 0, 5) == 1.0


def _same_error(jax_call, port_call) -> None:
    with pytest.raises(ValueError) as jerr:
        jax_call()
    with pytest.raises(ValueError) as err:
        port_call()
    assert str(err.value) == str(jerr.value)


BAD_CONFIGS = [dict(rate=-0.1), dict(rate=1.5), dict(min_live=0), dict(trace=()),
               dict(trace=((),)), dict(trace=((1, 0), (1,))), dict(trace=((1, 2),))]
BAD_TRACES = [
    ("ChaosTrace", ((),), {}), ("ChaosTrace", (((),),), {}),
    ("ChaosTrace", (((1, 0), (1, 0, 1)),), {}), ("ChaosTrace", (((1, 3),),), {}),
    ("flap", (4,), dict(peer=4)), ("flap", (4,), dict(period=0)),
    ("partition", (4, ()), dict(down_steps=1)), ("partition", (4, (5,)), dict(down_steps=1)),
    ("partition", (2, 2), dict(down_steps=1)), ("partition", (4, 1), dict(down_steps=0)),
    ("partition", (4, 1), dict(down_steps=2, up_steps=0)),
    ("solo_survivor", (3,), dict(survivor=3)),
]


def test_checks_raise_jax_messages():
    for kw in BAD_CONFIGS:
        _same_error(lambda kw=kw: jel.ElasticConfig(**kw), lambda kw=kw: el.ElasticConfig(**kw))
    for name, args, kw in BAD_TRACES:
        _same_error(lambda: getattr(jel, name)(*args, **kw),
                    lambda: getattr(el, name)(*args, **kw))


def test_constructors_give_jax_rows():
    cases = [("flap", (4,), {}), ("flap", (5,), dict(peer=2, period=3)),
             ("flap", (3,), dict(peer=1, period=1, steps=7)),
             ("partition", (4, (0,)), dict(down_steps=3)),
             ("partition", (8, 3), dict(down_steps=2, up_steps=4)),
             ("partition", (6, (1, 4)), dict(down_steps=1)),
             ("solo_survivor", (4,), dict(survivor=2)), ("solo_survivor", (8,), dict(steps=0)),
             ("solo_survivor", (1,), dict(steps=3))]
    for name, args, kw in cases:
        want, got = getattr(jel, name)(*args, **kw), getattr(el, name)(*args, **kw)
        assert (got.rows, got.name, got.n_peers, got.n_steps) == \
            (want.rows, want.name, want.n_peers, want.n_steps), name
        for min_live in (1, 2):
            jcfg, cfg = want.elastic(min_live), got.elastic(min_live)
            assert (cfg.rate, cfg.seed, cfg.trace, cfg.min_live) == \
                (jcfg.rate, jcfg.seed, jcfg.trace, jcfg.min_live)
    trace = el.ChaosTrace([[1, 0], [True, 1]], name="x")
    assert trace.rows == ((1, 0), (1, 1)) == jel.ChaosTrace([[1, 0], [True, 1]]).rows
    assert sorted(el.__all__) == sorted(jel.__all__)


def test_trace_files_load_in_either_package(tmp_path):
    trace = jel.partition(5, (1, 3), down_steps=2, up_steps=2)
    jel.save_trace(trace, tmp_path / "jax.json")
    got = el.load_trace(tmp_path / "jax.json")
    assert (got.rows, got.name) == (trace.rows, trace.name)
    mine = el.flap(6, peer=5, period=2, steps=5)
    el.save_trace(mine, tmp_path / "port.json")
    back = jel.load_trace(tmp_path / "port.json")
    assert (back.rows, back.name) == (mine.rows, mine.name)
    assert (tmp_path / "port.json").read_text() == (
        jel.save_trace(jel.flap(6, peer=5, period=2, steps=5), tmp_path / "j2.json")
        or (tmp_path / "j2.json").read_text())
    for text in ('{"version": 2, "rows": [[1]]}',
                 '{"version": 1, "n_peers": 3, "rows": [[1, 0]]}'):
        (tmp_path / "bad.json").write_text(text)
        _same_error(lambda: jel.load_trace(tmp_path / "bad.json"),
                    lambda: el.load_trace(tmp_path / "bad.json"))
