"""The port's threefry PRNG (``repro_torch.core.prng``) against
``jax.random``, with JAX pinned to the original threefry counter layout
(``jax_threefry_partitionable`` off, the layout the port draws in and the
golden windows were recorded under), on the key paths the sync takes.

Keys, folds, splits, uniform and randint draws are bitwise equal; normal
draws agree to rtol 1e-5 / atol 1e-6 and the port's copy of XLA's
``erf_inv`` to 4 ulp, because XLA may contract a multiply-add that torch
rounds twice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402


@pytest.fixture(params=[False], ids=["original"])
def layout(request):
    """Pin JAX to the port's counter layout for the test, then restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 0x5EED, 2**31 - 1])
def test_key_from_seed(seed):
    assert (prng.key(seed).numpy() == _kd(jax.random.key(seed))).all()


def test_sync_key_paths(layout):
    """fold_in(key(0x5EED), step) -> per-peer fold -> per-bucket fold."""
    for step in (0, 29, 2**31 + 7):
        ks = jax.random.fold_in(jax.random.key(0x5EED), jnp.uint32(step))
        kt = prng.fold_in(prng.key(0x5EED), step)
        assert (kt.numpy() == _kd(ks)).all(), step
        for i in (0, 7):
            for b in range(2):
                want = jax.random.fold_in(jax.random.fold_in(ks, i), b)
                assert (prng.fold_in(prng.fold_in(kt, i), b).numpy() == _kd(want)).all()


@pytest.mark.parametrize("num", [1, 2, 3, 4, 5, 8])
def test_split(layout, num):
    k = jax.random.key(42)
    assert (prng.split(prng.key(42), num).numpy() == _kd(jax.random.split(k, num))).all()


@pytest.mark.parametrize("shape", [(1, 128), (17, 128), (1617, 128), (7,), (3, 4, 5), (1,), (2,),
                                   (8193,), (64, 128)])
def test_uniform_bitwise(layout, shape):
    k = jax.random.fold_in(jax.random.key(0x5EED), 3)
    got = prng.uniform(prng.fold_in(prng.key(0x5EED), 3), shape).numpy()
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == shape
    assert (got.view(np.uint32) == want.view(np.uint32)).all()


def test_randint_bitwise(layout):
    k = jax.random.key(7)
    got = prng.randint(prng.key(7), (256,), 0, 10).numpy()
    assert (got == np.asarray(jax.random.randint(k, (256,), 0, 10))).all()


@pytest.mark.parametrize("lo,hi", [(0, 8), (-5, 7), (3, 1000003)])
def test_randint_ranges_bitwise(layout, lo, hi):
    k = jax.random.key(8)
    got = prng.randint(prng.key(8), (256,), lo, hi).numpy()
    assert (got == np.asarray(jax.random.randint(k, (256,), lo, hi))).all()


def test_uniform_range_close(layout):
    """The affine map to [lo, hi) is two float32 roundings, which XLA may
    contract into one: within an ulp of the range."""
    k = jax.random.key(3)
    got = prng.uniform(prng.key(3), (1000,), minval=-2.0, maxval=3.0).numpy()
    want = np.asarray(jax.random.uniform(k, (1000,), jnp.float32, -2.0, 3.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=5 * np.finfo(np.float32).eps * 3.0)


def test_oversized_draw_raises():
    with pytest.raises(ValueError, match="32-bit counter"):
        prng.random_bits(prng.key(0), (2**32,))


@pytest.mark.parametrize("shape", [(10, 28, 28), (3, 3, 16, 32), (5,)])
def test_normal_close(layout, shape):
    k = jax.random.key(42)
    got = prng.normal(prng.key(42), shape).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.random.normal(k, shape)), rtol=1e-5, atol=1e-6)


def test_erfinv_matches_xla():
    """XLA's erf_inv polynomial, ±1 to ±inf; a few ulp from JAX."""
    x = np.concatenate([np.linspace(-1, 1, 4001, dtype=np.float32),
                        1 - np.float32(2.0) ** -np.arange(1, 24, dtype=np.float32)])
    got = prng.erfinv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert (np.isinf(got) == np.isinf(want)).all() and (got[np.isinf(got)] == want[np.isinf(want)]).all()
    fin = np.isfinite(want)
    ulps = np.abs(got[fin].view(np.int32).astype(np.int64) - want[fin].view(np.int32))
    assert ulps.max() <= 4, ulps.max()
