"""The port's MoE FFN (``models/moe.py``) and Mamba2 SSD block
(``models/ssm.py``) against the JAX package's, on the same numpy inputs.

Contract: the routing is JAX's exactly (the expert ids, the kept mask of
the sort-based dispatch, the rows a capacity drop leaves zero); the MoE
outputs and the load-balance loss within rtol/atol 1e-4; ``ssd_chunked``
within atol 2e-5 of JAX's and of ``naive_recurrence`` (``tests/test_models.py``'s
bound), at a length the chunk does not divide and continued from a state;
``ssm_forward`` with its state and ``ssm_decode`` within 1e-4; ``moe_init``
and ``ssm_init`` on one key within a few ulp (``prng.normal``'s contract).
JAX runs under ``jax.jit``, pinned to the original threefry layout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402

RTOL = ATOL = 1e-4
SSD_ATOL = 2e-5
# label -> (experts, top_k, capacity_factor, tokens, patched GROUP_TOKENS)
MOE_CASES = {
    "e8_top2": (8, 2, 1.25, 64, None),
    "e16_top8": (16, 8, 1.25, 64, None),
    "drop": (8, 2, 0.5, 64, None),
    "grouped": (8, 2, 1.25, 160, 48),   # groups of 40: 48 lowered to a divisor of 160
}


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


def _moe_cfgs(experts, top_k, cf):
    def one(c):
        return c.replace(d_model=64, moe=dataclasses.replace(
            c.moe, num_experts=experts, top_k=top_k, capacity_factor=cf, d_ff=32))
    return (one(reduced(get_config("phi3.5-moe-42b-a6.6b"))),
            one(jreduced(jget_config("phi3.5-moe-42b-a6.6b"))))


def _jax_keep(jcfg, idx, t):
    """JAX's kept mask (sorted order) for one group, ``_moe_group``'s lines."""
    e, c = jcfg.moe.num_experts, jmoe.capacity(jcfg, t)
    e_sorted = idx.reshape(-1)[jnp.argsort(idx.reshape(-1), stable=True)]
    starts = jnp.searchsorted(e_sorted, jnp.arange(e), side="left")
    return jnp.arange(e_sorted.shape[0]) - starts[e_sorted] < c


def _same(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def test_moe_and_ssm_init_match_jax():
    cfg, jcfg = _moe_cfgs(8, 2, 1.25)
    scfg, jscfg = reduced(get_config("mamba2-2.7b")), jreduced(jget_config("mamba2-2.7b"))
    jmoe_init = jax.jit(lambda k: jmoe.moe_init(k, jcfg, 64)[0])
    jssm_init = jax.jit(lambda k: jssm.ssm_init(k, jscfg, 256)[0])
    for name, ours, want in (
            ("moe", moe.moe_init(prng.key(5), cfg, 64, "cpu"), jmoe_init(jax.random.key(5))),
            ("ssm", ssm.ssm_init(prng.key(6), scfg, 256, "cpu"), jssm_init(jax.random.key(6)))):
        assert sorted(ours) == sorted(want), name
        for k, w in want.items():
            assert ours[k].shape == w.shape and str(ours[k].dtype)[6:] == str(w.dtype), (name, k)
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{k}")


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case, monkeypatch):
    experts, top_k, cf, tokens, group = MOE_CASES[case]
    if group is not None:
        monkeypatch.setattr(moe, "GROUP_TOKENS", group)
        monkeypatch.setattr(jmoe, "GROUP_TOKENS", group)
    cfg, jcfg = _moe_cfgs(experts, top_k, cf)
    jp, _ = jmoe.moe_init(jax.random.key(1), jcfg, 64)
    p = {k: _t(v) for k, v in jp.items()}
    x = _rand((2, tokens // 2, 64), 2, 0.5)

    y, aux = moe.moe_apply(cfg, p, _t(x))
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(jcfg, p, x))(jp, x)
    _same(y, jy, f"{case} y")
    _same(aux, jaux, f"{case} aux")
    # rows every assignment of which was dropped are zero in both
    zero = (y.reshape(tokens, 64) == 0).all(1)
    assert (zero.numpy() == (np.asarray(jy).reshape(tokens, 64) == 0).all(1)).all()
    if case == "drop":
        assert zero.any()

    # the routing and the kept mask of each dispatch group, exactly
    xf = x.reshape(tokens, 64)
    g = tokens if group is None else 40
    for i in range(0, tokens, g):
        gates, idx, _ = moe._route(cfg, p, _t(xf[i:i + g]))
        jgates, jidx, _ = jax.jit(lambda p, x: jmoe._route(jcfg, p, x))(jp, xf[i:i + g])
        assert (idx.numpy() == np.asarray(jidx)).all(), f"{case}: expert ids differ"
        _same(gates, jgates, f"{case} gates")
        keep = moe._dispatch(cfg, idx, gates, moe.capacity(cfg, g))[0]
        assert (keep.numpy() == np.asarray(_jax_keep(jcfg, jidx, g))).all()
        if case == "drop":
            assert not bool(keep.all())

    if group is None:
        yd, auxd = moe.dense_moe_apply(cfg, p, _t(x))
        jyd, jauxd = jax.jit(lambda p, x: jmoe.dense_moe_apply(jcfg, p, x))(jp, x)
        _same(yd, jyd, f"{case} dense y")
        _same(auxd, jauxd, f"{case} dense aux")


def _ssd_inputs(s, seed=0, h=4, p=8, g=2, n=16):
    b = 2
    return (_rand((b, s, h, p), seed), -np.abs(_rand((b, s, h), seed + 1)) * 0.5,
            _rand((b, s, g, n), seed + 2, 0.3), _rand((b, s, g, n), seed + 3, 0.3))


@pytest.mark.parametrize("s", [96, 40])
def test_ssd_chunked_matches_jax_and_naive(s):
    # 96 in chunks of 16; 40 lowers the chunk to 10.  Then the first 24
    # positions, and the rest continued from their state.
    x, ld, bs, cs = _ssd_inputs(s)
    jssd = jax.jit(jssm.ssd_chunked, static_argnames="chunk")
    y, fin = ssm.ssd_chunked(_t(x), _t(ld), _t(bs), _t(cs), 16)
    jy, jfin = jssd(x, ld, bs, cs, chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SSD_ATOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), atol=SSD_ATOL)
    naive = ssm.naive_recurrence(_t(x), _t(ld), _t(bs), _t(cs))
    jnaive = jax.jit(jssm.naive_recurrence)(x, ld, bs, cs)
    np.testing.assert_allclose(naive.numpy(), np.asarray(jnaive), atol=SSD_ATOL)
    np.testing.assert_allclose(y.numpy(), naive.numpy(), atol=SSD_ATOL)
    ya, fa = ssm.ssd_chunked(_t(x[:, :24]), _t(ld[:, :24]), _t(bs[:, :24]), _t(cs[:, :24]), 16)
    yb, fb = ssm.ssd_chunked(_t(x[:, 24:]), _t(ld[:, 24:]), _t(bs[:, 24:]), _t(cs[:, 24:]), 16,
                             init_state=fa)
    np.testing.assert_allclose(torch.cat([ya, yb], 1).numpy(), naive.numpy(), atol=SSD_ATOL)
    np.testing.assert_allclose(fb.numpy(), fin.numpy(), atol=SSD_ATOL)


def test_ssm_forward_and_decode_match_jax():
    cfg, jcfg = reduced(get_config("mamba2-2.7b")), jreduced(jget_config("mamba2-2.7b"))
    jp, _ = jssm.ssm_init(jax.random.key(3), jcfg, 256)
    p = {k: _t(v) for k, v in jp.items()}
    x = _rand((2, 40, 256), 4, 0.5)       # 40 positions: a chunk of 32 lowered to 20
    steps = _rand((3, 2, 1, 256), 5, 0.5)

    y, st = ssm.ssm_forward(cfg, p, _t(x), return_state=True)
    jy, jst = jax.jit(lambda p, x: jssm.ssm_forward(jcfg, p, x, return_state=True))(jp, x)
    _same(y, jy, "forward y")
    for f in ssm.SSMState._fields:
        assert getattr(st, f).dtype == torch.float32
        _same(getattr(st, f), getattr(jst, f), f"forward state {f}")
    jdec = jax.jit(lambda p, x, s: jssm.ssm_decode(jcfg, p, x, s))
    for i, xt in enumerate(steps):
        y, out = ssm.ssm_decode(cfg, p, _t(xt), st)
        jy, jst = jdec(jp, xt, jst)
        assert out is st      # the state was written in place
        _same(y, jy, f"decode y, step {i}")
        for f in ssm.SSMState._fields:
            _same(getattr(st, f), getattr(jst, f), f"decode state {f}, step {i}")
    # prefill continued from a state: the conv tails and the recurrent state carry
    _, head = ssm.ssm_forward(cfg, p, _t(x[:, :24]), return_state=True)
    jfull = jax.jit(lambda p, x: jssm.ssm_forward(jcfg, p, x))(jp, x)
    _same(ssm.ssm_forward(cfg, p, _t(x[:, 24:]), head), np.asarray(jfull)[:, 24:],
          "forward continued from a state")
