"""The port's smallnet, data, optimizer and training loop against the JAX
package: the JAX init carried across with ``params_from_jax`` and the
port's replay of the data stream give JAX's first-step loss within 1e-4,
and the port's own 30-step faithful run on the CPU lands in the golden
window of ``tests/test_golden_convergence.py`` (0.0162 ± 0.05).  The window
was recorded under the pinned jax 0.4.37, whose PRNG uses the original
threefry counter layout — the one the port draws in.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import client_batches as jbatches  # noqa: E402
from repro.data.synthetic import make_templates as jtemplates  # noqa: E402
from repro.models.smallnet import init_smallnet as jinit  # noqa: E402
from repro.models.smallnet import smallnet_loss as jloss  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data.synthetic import client_batches, make_templates  # noqa: E402
from repro_torch.models.smallnet import init_smallnet, params_from_jax, tree_leaves  # noqa: E402
from repro_torch.optim.optimizers import momentum_sgd  # noqa: E402


@pytest.fixture
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def test_first_step_loss_matches_jax(same_layout):
    jp = jinit(jax.random.key(0))
    ji, jl = jbatches(jtemplates(jax.random.key(42)), jnp.uint32(0), 8, 32)
    want = float(jnp.mean(jax.vmap(lambda im, lb: jloss(jp, im, lb))(ji, jl)))
    params = params_from_jax(jax.tree.map(np.array, jp), device="cpu")
    imgs, labels = client_batches(make_templates(prng.key(42), device="cpu"), 0, 8, 32)
    assert (labels.numpy() == np.asarray(jl)).all()
    np.testing.assert_allclose(imgs.numpy(), np.asarray(ji), atol=1e-4)
    losses, grads = train.client_grads(params, imgs, labels)
    assert abs(float(losses.mean()) - want) <= 1e-4
    assert [g.shape[1:] for g in grads] == [x.shape for x in jax.tree.leaves(jp)]
    ours = tree_leaves(init_smallnet(prng.key(0), device="cpu"))
    for a, b in zip(ours, jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_momentum_sgd_decays_weights_only():
    opt = momentum_sgd(lr=0.1, momentum=0.5, weight_decay=0.1)
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    grads = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    p, s = opt.update(params, grads, opt.init(params), 0)
    assert torch.allclose(p["w"], torch.full((2, 2), 0.99)) and torch.equal(p["b"], params["b"])
    assert torch.allclose(s["w"], torch.full((2, 2), 0.1))


def test_golden_faithful_run_on_cpu():
    hist = train.train_synced(sync="faithful", method="tnqsgd", bits=3, error_feedback=False,
                              steps=30, device="cpu")
    assert len(hist) == 30
    assert hist[0] == pytest.approx(6.4895, abs=1e-3), hist
    assert hist[-1] == pytest.approx(0.0162, abs=0.05), hist
    assert hist[-1] < hist[0] - 5.0, hist


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train.train_synced(steps=1, device="cuda")
