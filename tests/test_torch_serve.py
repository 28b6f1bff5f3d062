"""The port's serving path (``models.transformer.prefill``/``decode_step``,
``dist.serve_step.make_serve_fns``, ``examples/serve_batched_torch.py``)
against the JAX package's, for the zoo's ten archs: the attention-only,
MoE, SSM and hybrid families.

Contract: from the same weights (``params_from_jax``) and JAX's batch, the
prefill logits, the caches (KV caches, SSM states and the hybrid's
``sub{j}`` dicts) and 4 decode steps within rtol 1e-4 / atol 1e-4 in
float32, with the greedy tokens equal; in bfloat16 within a
relative L2 error of 2e-2; the port's decode against its own prefill over
the longer prompt within 2e-3 (``tests/test_models.py``'s bound).  The
VLM's decode positions follow JAX's ``decode_step``, which broadcasts the
scalar position to the three M-RoPE streams (ROADMAP fact F11).
"""
import dataclasses
import importlib.util
import inspect
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data.synthetic import lm_batch as jlm_batch  # noqa: E402
from repro.dist import serve_step as jserve  # noqa: E402
from jax.sharding import AxisType  # noqa: E402  (after repro.dist, which shims older jax)
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.dist.serve_step import DECODE_MARGIN, make_serve_fns  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVED = ["llama3.2-1b", "gemma-7b", "granite-20b", "minitron-8b", "qwen2-vl-2b", "whisper-base",
          "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "mamba2-2.7b", "jamba-1.5-large-398b"]
RTOL = ATOL = 1e-4
BF16_REL_L2 = 2e-2
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _cfgs(arch, **kw):
    return reduced(get_config(arch)).replace(**kw), jreduced(jget_config(arch)).replace(**kw)


def _batch(jb) -> transformer.Batch:
    """JAX's batch as the port's: integers int64, floats float32."""
    def one(x):
        if x is None:
            return None
        x = np.array(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype.kind == "i" else x)
    return transformer.Batch(*(one(x) for x in jb))


def _params(jp) -> dict:
    return transformer.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _assert_caches(c, jc):
    if isinstance(jc, dict) and "cross_kv" in jc:
        _assert_caches(c["self"], jc["self"])
        for a, w in zip(c["cross_kv"], jc["cross_kv"], strict=True):
            _close(a, w, "cross_kv")
        return
    if isinstance(jc, dict):             # a hybrid superblock's sublayers
        assert sorted(c) == sorted(jc)
        for k in jc:
            _assert_caches(c[k], jc[k])
        return
    if hasattr(jc, "ssm"):               # an SSM state, stacked on the unit axis
        assert isinstance(c, ssm.SSMState)
        for f in jc._fields:
            _close(getattr(c, f), getattr(jc, f), f"ssm state {f}")
        return
    assert (np.asarray(jc.length) == c.length).all()
    _close(c.k, jc.k, "cache k")
    _close(c.v, jc.v, "cache v")


def _run_both(cfg, jcfg, jp, jb, capacity, steps=STEPS):
    """Prefill and ``steps`` greedy decode steps in both packages; returns
    the (port, JAX) logits of every step, after checking caches and tokens."""
    p, b = _params(jp), _batch(jb)
    t = b.tokens.shape[1]
    jl, jc = jax.jit(lambda p, b: jtf.prefill(jcfg, p, b, capacity=capacity))(jp, jb)
    lg, c = transformer.prefill(cfg, p, b, capacity=capacity)
    _assert_caches(c, jc)
    jdec = jax.jit(lambda p, t, c, pos: jtf.decode_step(jcfg, p, t, c, pos))
    out = [(lg, jl)]
    for i in range(steps):
        tok, jtok = lg.argmax(-1)[:, None], jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        assert (tok.numpy() == np.asarray(jtok)).all(), f"greedy tokens differ at step {i}"
        jl, jc = jdec(jp, jtok, jc, jnp.int32(t + i))
        lg, c = transformer.decode_step(cfg, p, tok, c, t + i)
        out.append((lg, jl))
    _assert_caches(c, jc)
    return out


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_match_jax(arch):
    cfg, jcfg = _cfgs(arch)
    jp, _ = jtf.init_lm(jax.random.key(0), jcfg)
    jb = jlm_batch(jcfg, jnp.uint32(0), 2, 32)
    for i, (lg, jl) in enumerate(_run_both(cfg, jcfg, jp, jb, capacity=32 + 8)):
        _close(lg, jl, f"{arch} logits, step {i}")


def test_moe_sort_path_matches_jax():
    # 8 experts: _ffn_apply takes the sort-based dispatch, not the dense
    # path it takes at <= 4, in prefill and in decode
    cfg, jcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    cfg, jcfg = (c.replace(moe=dataclasses.replace(c.moe, num_experts=8)) for c in (cfg, jcfg))
    jp, _ = jtf.init_lm(jax.random.key(0), jcfg)
    assert jp["blocks"]["ffn"]["wi"].shape[1] == 8
    jb = jlm_batch(jcfg, jnp.uint32(0), 2, 32)
    for i, (lg, jl) in enumerate(_run_both(cfg, jcfg, jp, jb, capacity=32 + 8)):
        _close(lg, jl, f"8-expert logits, step {i}")


def test_bfloat16_llama_matches_jax():
    cfg, jcfg = _cfgs("llama3.2-1b", param_dtype="bfloat16", compute_dtype="bfloat16")
    jp, _ = jtf.init_lm(jax.random.key(0), jcfg)
    jb = jlm_batch(jcfg, jnp.uint32(0), 2, 32)
    p, b = _params(jp), _batch(jb)
    assert p["embed"].dtype == torch.bfloat16
    jl, jc = jax.jit(lambda p, b: jtf.prefill(jcfg, p, b, capacity=40))(jp, jb)
    lg, c = transformer.prefill(cfg, p, b, capacity=40)
    assert c.k.dtype == torch.bfloat16
    jdec = jax.jit(lambda p, t, c, pos: jtf.decode_step(jcfg, p, t, c, pos))
    errs = []
    for i in range(STEPS + 1):
        want = np.asarray(jl, np.float32)
        errs.append(float(np.linalg.norm(lg.numpy() - want) / np.linalg.norm(want)))
        if i == STEPS:
            break
        tok = torch.from_numpy(np.asarray(jnp.argmax(jl, -1)[:, None], np.int64))
        jl, jc = jdec(jp, tok.numpy().astype(np.int32), jc, jnp.int32(32 + i))
        lg, c = transformer.decode_step(cfg, p, tok, c, 32 + i)
    assert max(errs) <= BF16_REL_L2, errs


def test_sliding_window_rolling_cache_matches_jax():
    # 32 prompt positions through a window of 16: the cache keeps 16-31 in
    # slots 0-15 (position % 16), and the 4 decode steps overwrite slots 0-3
    cfg, jcfg = _cfgs("llama3.2-1b", sliding_window=16)
    jp, _ = jtf.init_lm(jax.random.key(0), jcfg)
    jb = jlm_batch(jcfg, jnp.uint32(1), 2, 32)
    for i, (lg, jl) in enumerate(_run_both(cfg, jcfg, jp, jb, capacity=None)):
        _close(lg, jl, f"windowed logits, step {i}")


def test_decode_matches_prefill():
    cfg = reduced(get_config("llama3.2-1b"))
    params = transformer.init_lm(prng.key(0), cfg, device="cpu")
    b = lm_batch(cfg, 0, 2, 33, device="cpu")
    prefix = transformer.Batch(tokens=b.tokens[:, :32], labels=b.labels[:, :32])
    _, caches = transformer.prefill(cfg, params, prefix, capacity=40)
    kept = caches._replace(k=caches.k.clone(), v=caches.v.clone())
    got, after = transformer.decode_step(cfg, params, b.tokens[:, 32:33], caches, 32)
    want, _ = transformer.prefill(cfg, params, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)
    # decode wrote slot 32 of the caches passed in and left the others
    assert after.k is caches.k and after.length == 33 and kept.length == 32
    assert torch.equal(after.k[:, :, :32], kept.k[:, :, :32])
    assert not torch.equal(after.k[:, :, 32], kept.k[:, :, 32])


@pytest.fixture(scope="module")
def jax_served():
    """JAX's ``make_serve_fns`` on a one-device mesh: reduced llama, 4
    prompts of 64, 4 greedy tokens (the example's defaults but --tokens)."""
    jcfg = jreduced(jget_config("llama3.2-1b"))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jp, logical = jtf.init_lm(jax.random.key(0), jcfg)
    jb = jlm_batch(jcfg, jnp.uint32(0), 4, 64)
    prefill_fn, decode_fn, _, _ = jserve.make_serve_fns(jcfg, mesh, logical, jb, 4, 64,
                                                        params_like=jp)
    logits, caches = prefill_fn(jp, jb)
    toks, outs = [jnp.argmax(logits, -1)[:, None].astype(jnp.int32)], [logits]
    for i in range(STEPS - 1):
        logits, caches = decode_fn(jp, toks[-1], caches, jnp.int32(64 + i))
        toks.append(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
        outs.append(logits)
    return jp, jb, np.concatenate([np.asarray(t) for t in toks], 1), outs


def test_serve_fns_match_jax(jax_served):
    jp, jb, want_seqs, want_logits = jax_served
    cfg = reduced(get_config("llama3.2-1b"))
    p, b = _params(jp), _batch(jb)
    prefill_fn, decode_fn = make_serve_fns(cfg, 64)
    logits, caches = prefill_fn(p, b)
    assert caches.k.shape[2] == 64 + DECODE_MARGIN and caches.length == 64
    toks, outs = [logits.argmax(-1)[:, None]], [logits]
    for i in range(STEPS - 1):
        logits, caches = decode_fn(p, toks[-1], caches, 64 + i)
        toks.append(logits.argmax(-1)[:, None])
        outs.append(logits)
    assert (torch.cat(toks, 1).numpy() == want_seqs).all()
    for i, (lg, jl) in enumerate(zip(outs, want_logits)):
        _close(lg, jl, f"served logits, step {i}")


def test_example_prints_jax_greedy_tokens(jax_served, capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_batched_torch", ROOT / "examples" / "serve_batched_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert sorted(example.SERVED_ARCHS) == sorted(SERVED)
    example.main(["--device", "cpu", "--tokens", str(STEPS)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["prefilled 4 x 64; logits (4, 512)", "greedy decode:"]
    rows = [[int(t) for t in ln.strip()[1:-1].split(",")] for ln in lines[2:]]
    assert rows == jax_served[2].tolist()


@pytest.mark.parametrize("arch,window", [("llama3.2-1b", None), ("llama3.2-1b", 16),
                                         ("whisper-base", None), ("mamba2-2.7b", None),
                                         ("jamba-1.5-large-398b", None)])
def test_init_caches_match_jax(arch, window):
    cfg, jcfg = _cfgs(arch, sliding_window=window)
    jc = jtf.init_caches(jcfg, 2, 24)
    _assert_caches(transformer.init_caches(cfg, 2, 24, device="cpu"), jc)


def test_entry_points_default_to_the_card():
    for fn in (transformer.init_lm, transformer.init_caches, lm_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert transformer.Batch._fields == ("tokens", "labels", "positions", "patches", "frames")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            transformer.init_lm(prng.key(0), reduced(get_config("llama3.2-1b")))
