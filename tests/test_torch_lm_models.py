"""The port's LM zoo layers, positions, attention, init and synthetic LM
data against the JAX package's, on the same numpy inputs.

Contract: norms and MLPs within float32 rounding (rtol 1e-5 / atol
1e-5); RoPE, M-RoPE and the sincos table within atol 2e-5 at positions
below 128 (a few of their frequencies are an ulp from XLA's ``pow`` and
``exp``, so an angle drifts by up to position x 1.2e-7 rad: the sincos
table's row 1,499 is 1.2e-4 from JAX's); ``flash_attention`` and the
prefill and decode attention with their caches within atol 2e-5, the JAX tests' own
bound (``tests/test_models.py``); the diagonal skip bitwise the full tile
loop; ``init_lm`` on ``key(0)`` within a few ulp (``prng.normal``'s
contract); M-RoPE positions bitwise; ``lm_batch``'s tokens bitwise at
these sizes (a token can move at a bin edge at larger ones: XLA contracts
``uniform``'s affine map into one rounding, ROADMAP fact F12).  JAX runs
under ``jax.jit``, pinned to the original threefry layout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import attention, layers, rope, transformer  # noqa: E402

SERVED = ["llama3.2-1b", "gemma-7b", "granite-20b", "minitron-8b", "qwen2-vl-2b", "whisper-base"]
ATTN_ATOL = 2e-5


@pytest.fixture(autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _cfgs(arch):
    return reduced(get_config(arch)), jreduced(jget_config(arch))


def test_norms_match_jax():
    x, s, b = _rand((2, 8, 64), 0), _rand((64,), 1, 0.1), _rand((64,), 2, 0.1)
    want_rms = jax.jit(jlayers.rmsnorm)(x, s)
    want_ln = jax.jit(jlayers.layernorm)(x, s, b)
    np.testing.assert_allclose(layers.rmsnorm(_t(x), _t(s)).numpy(), want_rms, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layers.layernorm(_t(x), _t(s), _t(b)).numpy(), want_ln, rtol=1e-5,
                               atol=1e-5)
    xb = _t(x).to(torch.bfloat16)
    assert layers.rmsnorm(xb, _t(s)).dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_mlp"])
def test_mlp_matches_jax(act):
    cfg, jcfg = (c.replace(act=act) for c in _cfgs("llama3.2-1b"))
    jp, _ = jlayers.mlp_init(jax.random.key(3), jcfg, 256, 512, jnp.float32)
    ours = layers.mlp_init(prng.key(3), cfg, 256, 512, torch.float32, "cpu")
    assert sorted(ours) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)
    x = _rand((2, 8, 256), 4)
    want = jax.jit(lambda p, x: jlayers.mlp_apply(jcfg, p, x))(jp, x)
    got = layers.mlp_apply(cfg, transformer.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                           _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=ATTN_ATOL)


def test_rope_mrope_and_sincos_match_jax():
    x = _rand((2, 80, 3, 32), 5)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32)[None] + np.array([[0], [40]]), (2, 80))
    want = jax.jit(lambda x, p: jrope.rope(x, p, 5e5))(x, pos)
    np.testing.assert_allclose(rope.rope(_t(x), _t(pos).long(), 5e5).numpy(), want, rtol=1e-5,
                               atol=ATTN_ATOL)
    mpos = np.asarray(jsynth.make_mrope_positions(2, 80, 16))
    ours_mpos = synthetic.make_mrope_positions(2, 80, 16)
    assert (ours_mpos.numpy() == mpos).all()
    want = jax.jit(lambda x, p: jrope.mrope(x, p, 1e6))(x, mpos)
    np.testing.assert_allclose(rope.mrope(_t(x), ours_mpos, 1e6).numpy(), want, rtol=1e-5,
                               atol=ATTN_ATOL)
    # M-RoPE of a text stream: all three sections take the (B, S) positions
    cfg, jcfg = _cfgs("qwen2-vl-2b")
    want = jax.jit(lambda x, p: jrope.apply_positional(jcfg, x, p))(x, pos)
    np.testing.assert_allclose(rope.apply_positional(cfg, _t(x), _t(pos).long()).numpy(), want,
                               rtol=1e-5, atol=ATTN_ATOL)
    table = rope.sincos_embedding(1500, 512)
    want = jax.jit(jrope.sincos_embedding, static_argnums=(0, 1))(1500, 512)
    np.testing.assert_allclose(table[:128].numpy(), want[:128], atol=ATTN_ATOL)
    np.testing.assert_allclose(table.numpy(), want, atol=1500 * 1.2e-7)
    for p in (0, 63, 1499):
        assert torch.equal(rope.sincos_row(p, 512), table[p])


@pytest.mark.parametrize("arch", SERVED)
def test_lm_batch_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    jb = jsynth.lm_batch(jcfg, jnp.uint32(3), 2, 64)
    b = synthetic.lm_batch(cfg, 3, 2, 64, device="cpu")
    assert (b.tokens.numpy() == np.asarray(jb.tokens)).all()
    assert (b.labels.numpy() == np.asarray(jb.labels)).all()
    for name in ("positions", "patches", "frames"):
        ours, want = getattr(b, name), getattr(jb, name)
        assert (ours is None) == (want is None), name
        if want is not None and name == "positions":
            assert (ours.numpy() == np.asarray(want)).all()
        elif want is not None:
            np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


FLASH_CASES = {
    # label: (B, Sq, Skv, H, D, causal, window, q_chunk, kv_chunk)
    "causal": (2, 128, 128, 4, 16, True, None, 32, 32),
    "window": (1, 64, 64, 2, 8, True, 16, 16, 16),
    "uneven_tiles": (2, 96, 96, 2, 16, True, None, 32, 48),
    "window_uneven": (1, 90, 90, 2, 8, True, 20, 18, 45),
    "bidirectional": (2, 40, 40, 2, 16, False, None, 16, 16),
    "cross": (2, 8, 60, 2, 16, False, None, 1024, 64),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_jax(case, monkeypatch):
    b, sq, skv, h, d, causal, win, qc, kc = FLASH_CASES[case]
    q, k, v = _rand((b, sq, h, d), 6), _rand((b, skv, h, d), 7), _rand((b, skv, h, d), 8)
    kw = dict(causal=causal, window=win, q_chunk=qc, kv_chunk=kc)
    want = jax.jit(lambda q, k, v: jattn.flash_attention(q, k, v, **kw))(q, k, v)
    got = attention.flash_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL)
    # the causal diagonal skip gives the bits of the full tile loop
    monkeypatch.setattr(attention, "_kv_tiles", lambda qi, qc, kc, nk, causal: nk)
    assert torch.equal(attention.flash_attention(_t(q), _t(k), _t(v), **kw), got)


def test_causal_tiles_skip_only_above_the_diagonal():
    # q-chunks of 32 against kv tiles of 48: chunk 0 (rows 0-31) meets tile 0
    # only, chunk 1 (32-63) tiles 0-1, chunk 2 (64-95) both
    assert [attention._kv_tiles(qi, 32, 48, 2, True) for qi in range(3)] == [1, 2, 2]
    assert attention._kv_tiles(0, 32, 48, 2, False) == 2
    assert attention._pick_chunk(97, 64) == 1 and attention._pick_chunk(1500, 1024) == 750


@pytest.mark.parametrize("variant", ["gqa", "gqa_window"])
def test_attention_prefill_and_decode_caches_match_jax(variant):
    cfg, jcfg = (c.replace(num_kv_heads=2) for c in _cfgs("llama3.2-1b"))
    win = 16 if variant == "gqa_window" else None
    jp, _ = jattn.attn_init(jax.random.key(9), jcfg, 256)
    p = transformer.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = _rand((2, 32, 256), 10)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32)[None], (2, 32))
    cap = None if win else 36
    jy, jc = jax.jit(lambda p, x, ps: jattn.attention_prefill(jcfg, p, x, ps, window=win,
                                                               capacity=cap))(jp, x, pos)
    y, c = attention.attention_prefill(cfg, p, _t(x), _t(pos).long(), window=win, capacity=cap)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATTN_ATOL)
    assert c.length == int(jc.length) and c.k.shape == jc.k.shape
    np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), atol=ATTN_ATOL)
    np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v), atol=ATTN_ATOL)
    jdec = jax.jit(lambda p, x, c, ps: jattn.attention_decode(jcfg, p, x, c, ps, window=win))
    for i in range(3):  # the windowed cache wraps: slots 0, 1, 2 take positions 32-34
        xt = _rand((2, 1, 256), 11 + i)
        jy, jc = jdec(jp, xt, jc, jnp.int32(32 + i))
        y, c = attention.attention_decode(cfg, p, _t(xt), c, 32 + i, window=win)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATTN_ATOL)
        assert c.length == int(jc.length)
        np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), atol=ATTN_ATOL)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v), atol=ATTN_ATOL)


@pytest.mark.parametrize("arch", SERVED + ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                                           "mamba2-2.7b", "jamba-1.5-large-398b"])
def test_init_lm_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    jp, _ = jtf.init_lm(jax.random.key(0), jcfg)
    ours = transformer.init_lm(prng.key(0), cfg, device="cpu")
    flat_ours = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), ours))[0]
    flat_jax = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [k for k, _ in flat_ours] == [k for k, _ in flat_jax]
    for (path, a), (_, w) in zip(flat_ours, flat_jax):
        assert a.shape == w.shape and a.dtype == w.dtype, path
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=str(path))


def test_init_lm_bfloat16_matches_jax_and_crosses_over():
    cfg, jcfg = (c.replace(param_dtype="bfloat16") for c in _cfgs("llama3.2-1b"))
    jp, _ = jtf.init_lm(jax.random.key(0), jcfg)
    ours = transformer.init_lm(prng.key(0), cfg, device="cpu")
    back = transformer.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for a, b, w in zip(jax.tree.leaves(ours), jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32)
        # params_from_jax carries JAX's bits; the port's own draw is a bfloat16
        # ulp from them at most (its float32 draw is a few float32 ulp off)
        assert (b.float().numpy() == np.asarray(w, np.float32)).all()
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2 ** -8, atol=0)
