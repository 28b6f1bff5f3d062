"""The port's closed-form error model (``core.theory``), the truncation
bias, the wire bits per element and the power-law sampler against the
JAX package, on the CPU.

The error expressions get the same tails, densities, α and codebooks in
both packages and agree to rtol 1e-6 (float32 powers and sums rounded in
another order).  ``sample_power_law`` draws in JAX's original threefry
layout: its selection, body and sign draws are JAX's bit for bit, so the
tail mask, the signs and the body elements are equal; a tail element is
``g_min·u^(−1/(γ−1))`` with u the affine map of a uniform onto [1e-6, 1),
whose float32 power and multiply-add round differently in XLA, so those
magnitudes agree to rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compressors as jcomp  # noqa: E402
from repro.core import distributions as jdist  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro_torch.core import compressors, distributions, prng, theory  # noqa: E402

RTOL = 1e-6
TAILS = [(3.5, 1e-3, 0.05, 2e-2), (4.2, 3e-4, 0.1, 1e-2), (3.06, 2e-3, 0.02, 0.5)]


def _tails(gamma, g_min, rho, g_max):
    vals = [np.float32(v) for v in (gamma, g_min, rho, g_max)]
    return (distributions.PowerLawTail(*(torch.tensor(v) for v in vals)),
            jdist.PowerLawTail(*(jnp.asarray(v) for v in vals)))


def _densities(seed: int):
    rng = np.random.default_rng(seed)
    g = (1e-3 * rng.standard_normal(4096) * np.exp(rng.standard_normal(4096))).astype(np.float32)
    jd = jdist.fit_empirical_density(jnp.asarray(g))
    edges, dens = np.array(jd.edges), np.array(jd.density)
    return (distributions.EmpiricalDensity(edges=torch.from_numpy(edges),
                                           density=torch.from_numpy(dens)), jd)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL)


@pytest.mark.parametrize("t", range(len(TAILS)))
def test_error_model_matches_jax(t):
    tail, jtail = _tails(*TAILS[t])
    dens, jdens = _densities(t)
    g_min, g_max = TAILS[t][1], TAILS[t][3]
    for a in (g_min, 3 * g_min, g_max):
        alpha, jalpha = torch.tensor(np.float32(a)), jnp.float32(a)
        _close(distributions.truncation_bias(tail, alpha), jdist.truncation_bias(jtail, jalpha))
        for bits in (2, 3, 8):
            _close(theory.quant_variance_uniform(tail, alpha, bits),
                   jtheory.quant_variance_uniform(jtail, jalpha, bits))
            _close(theory.e_tq_uniform(tail, alpha, bits), jtheory.e_tq_uniform(jtail, jalpha, bits))
            _close(theory.e_tq_nonuniform(tail, dens, alpha, bits),
                   jtheory.e_tq_nonuniform(jtail, jdens, jalpha, bits))
        k, jk = torch.tensor(np.float32(0.3)), jnp.float32(0.3)
        for got, want in zip(theory.holder_chain(tail, dens, alpha, k),
                             jtheory.holder_chain(jtail, jdens, jalpha, jk)):
            _close(got, want)
    for q in (0.5, 0.9, 1.0):
        for bits in (2, 3, 4):
            _close(theory.e_tq_bound(tail, torch.tensor(np.float32(q)), bits),
                   jtheory.e_tq_bound(jtail, jnp.float32(q), bits))
    levels = np.sort(np.float32(g_max) * np.linspace(-1, 1, 8, dtype=np.float32) ** 3)
    _close(theory.quant_variance_density(dens, torch.from_numpy(levels)),
           jtheory.quant_variance_density(jdens, jnp.asarray(levels)))
    assert theory.dsgd_error(2.0, 0.1, 30, 0.5, 8, 32) == jtheory.dsgd_error(2.0, 0.1, 30, 0.5, 8, 32)


def test_wire_bits_per_element_matches_jax():
    for method in ("dsgd", "qsgd", "tnqsgd", "powersgd", "fp16"):
        for bits in (1, 3, 8):
            cfg = compressors.CompressorConfig(method=method, bits=bits)
            jcfg = jcomp.CompressorConfig(method=method, bits=bits)
            for n in (10, 4096, 206_922, [4928, 200_704, 1290]):
                assert compressors.wire_bits_per_element(cfg, n) == \
                    jcomp.wire_bits_per_element(jcfg, n)
    cfg, jcfg = compressors.CompressorConfig(), jcomp.CompressorConfig()
    sizes, plan = [4928, 200_704, 1290], [2, ("powersgd", 4), ("fp16", 3)]
    assert compressors.wire_bits_per_element(cfg, sizes, plan) == \
        jcomp.wire_bits_per_element(jcfg, sizes, plan)


@pytest.mark.parametrize("gamma,rho,body", [(4.0, 0.1, None), (3.2, 0.3, 0.5)])
def test_sample_power_law_matches_jax(gamma, rho, body):
    shape, g_min = (37, 129), 0.01
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        jkey = jax.random.key(5)
        want = np.array(jdist.sample_power_law(jkey, shape, gamma=gamma, g_min=g_min, rho=rho,
                                               body_scale=body))
        k_sel, _, _, k_sign = jax.random.split(jkey, 4)
        is_tail = np.array(jax.random.uniform(k_sel, shape)) < 2.0 * rho
        positive = np.array(jax.random.bernoulli(k_sign, 0.5, shape))
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    got = distributions.sample_power_law(prng.key(5), shape, gamma=gamma, g_min=g_min, rho=rho,
                                         body_scale=body).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert (np.sign(got) == np.where(positive, 1.0, -1.0)).all()
    assert (got[~is_tail] == want[~is_tail]).all()
    np.testing.assert_allclose(got[is_tail], want[is_tail], rtol=RTOL)
    assert (np.abs(got[is_tail]) >= g_min).all() and is_tail.any() and (~is_tail).any()
    sel, _, _, sign = prng.split(prng.key(5), 4)
    assert (prng.bernoulli(sign, 0.5, shape).numpy() == positive).all()
    assert ((prng.uniform(sel, shape) < 2.0 * rho).numpy() == is_tail).all()
