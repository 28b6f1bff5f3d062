"""The port's LM train path against the JAX package's, on the same numpy
inputs and JAX's params carried over with ``params_from_jax``.

Contract:
- ``transformer.loss_fn`` and its ``torch.autograd`` gradients against
  ``jax.value_and_grad(transformer.loss_fn)`` for one reduced config of each
  family (dense, VLM with M-RoPE, encoder-decoder, MoE on the sort-based
  dispatch in token groups, SSM, hybrid) and a sliding window, float32:
  the loss within rtol 1e-5, each gradient leaf within 1e-4 of its max
  |g|; the MoE routing exactly JAX's; ``cfg.remat`` and the per-tile and
  per-group checkpoints give autograd's bits through the plain forward;
- ``chunked_xent`` with masked labels and a chunk that does not divide S;
- the streamed schedule against the plain one and against JAX's
  ``_streamed_loss_and_grads``;
- ``optim.adamw`` and ``momentum_sgd`` bitwise JAX's on float32 inputs
  (adamw at steps 0-3: XLA's float32 ``pow`` rounds ``b**t`` differently
  from torch's at some later t, fact F15);
- a checkpoint each package writes, read back bitwise by the other,
  bfloat16 included.
JAX runs under ``jax.jit``, one compile per case.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.dist import train_step as jts  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.dist import train_step  # noqa: E402
from repro_torch.models import attention, moe, transformer  # noqa: E402
from repro_torch.models.smallnet import tree_leaves  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's max |g|
B, S = 2, 64
# label -> (arch, config overrides); "moe" takes the sort path (8 experts)
# in groups of 32 tokens (GROUP_TOKENS patched in both packages); the
# hybrid is a superblock of 2 sublayers (attention with an MLP, then SSM
# with the MoE), where the reduced one has 8, to bound JAX's compile
HYBRID = ("jamba-1.5-large-398b", {"num_layers": 2, "attn_period": 2, "attn_offset": 0})
FAMILIES = {
    "dense": ("llama3.2-1b", {}),
    "vlm_mrope": ("qwen2-vl-2b", {}),
    "enc_dec": ("whisper-base", {}),
    "moe": ("phi3.5-moe-42b-a6.6b", {"experts": 8}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": HYBRID,
    "sliding_window": ("llama3.2-1b", {"sliding_window": 16}),
}
MOE_GROUP = 32


def _cfgs(arch: str, over: dict):
    over = dict(over)
    experts = over.pop("experts", None)
    out = []
    for c in (jreduced(jget_config(arch)), reduced(get_config(arch))):
        c = c.replace(**over)
        if experts:
            c = c.replace(moe=dataclasses.replace(c.moe, num_experts=experts))
        out.append(c)
    return out


def _np_batch(cfg, seed: int, b: int = B, s: int = S) -> dict:
    """A train batch from a numpy seed: tokens, labels (shifted, the last
    position and ~1/8 of the rest masked with -1) and each family's extras."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[rng.random((b, s)) < 0.125] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.vlm_patches:
        out["patches"] = rng.standard_normal((b, cfg.vlm_patches, cfg.vlm_vision_dim),
                                             dtype=np.float32)
        from repro.data.synthetic import make_mrope_positions

        out["positions"] = np.asarray(make_mrope_positions(b, s, cfg.vlm_patches))
        labels[:, :cfg.vlm_patches] = -1
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    return out


def _jbatch(nb: dict):
    return jtf.Batch(**{k: jnp.asarray(v) for k, v in nb.items()})


def _tbatch(nb: dict):
    def t(a):
        return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)

    return transformer.Batch(**{k: t(v) for k, v in nb.items()})


def _jax_loss_and_grads(jcfg, nb: dict):
    """JAX's init, loss and gradients in one compile."""
    def f(key, batch):
        params = jtf.init_lm(key, jcfg)[0]
        loss, grads = jax.value_and_grad(lambda p: jtf.loss_fn(jcfg, p, batch))(params)
        return params, loss, grads

    params, loss, grads = jax.jit(f)(jax.random.key(0), _jbatch(nb))
    return jax.tree.map(np.asarray, params), float(loss), jax.tree.map(np.asarray, grads)


def _close_grads(got: dict, want, what: str) -> None:
    pairs = list(zip(tree_leaves(got), jax.tree.leaves(want), strict=True))
    for i, (a, w) in enumerate(pairs):
        a = a.detach().float().numpy()
        assert a.shape == w.shape, (what, i)
        tol = GRAD_TOL * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(a - w).max())
        assert err <= tol, f"{what}: leaf {i} off by {err:.3g} (tolerance {tol:.3g})"


@pytest.fixture
def small_moe_groups(monkeypatch):
    monkeypatch.setattr(jmoe, "GROUP_TOKENS", MOE_GROUP)
    monkeypatch.setattr(moe, "GROUP_TOKENS", MOE_GROUP)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family, small_moe_groups):
    jcfg, cfg = _cfgs(*FAMILIES[family])
    nb = _np_batch(jcfg, seed=7)
    jparams, jloss, jgrads = _jax_loss_and_grads(jcfg, nb)
    params = transformer.params_from_jax(jparams, device="cpu")
    batch = _tbatch(nb)
    loss, grads = train_step._loss_and_grads(cfg, params, batch, streamed=False)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss), (float(loss), jloss)
    _close_grads(grads, jgrads, family)
    if family == "dense":
        # unit remat recomputes each unit: autograd's bits
        _, again = train_step._loss_and_grads(cfg.replace(remat=True), params, batch, False)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(grads)))
    if family == "moe":
        # the routing of the same float32 tokens is JAX's exactly
        x = np.random.default_rng(3).standard_normal((128, cfg.d_model), dtype=np.float32)
        router = {"router": params["blocks"]["ffn"]["router"][0]}
        _, idx, _ = moe._route(cfg, router, torch.from_numpy(x))
        _, jidx, _ = jax.jit(lambda r, v: jmoe._route(jcfg, r, v))(
            {"router": jnp.asarray(router["router"].numpy())}, jnp.asarray(x))
        assert (idx.numpy() == np.asarray(jidx)).all()


def test_tile_and_group_checkpoints_are_autograds_bits(monkeypatch):
    """The checkpointed attention tiles (q and kv chunks of 16 over 64
    positions, a window) and MoE groups give the gradients of autograd
    through the same forward uncheckpointed."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 4, 16), dtype=np.float32))
               for _ in range(3))
    _, cfg = _cfgs("phi3.5-moe-42b-a6.6b", {"experts": 8})
    p = moe.moe_init(prng.key(7), cfg, cfg.d_model, "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 48, cfg.d_model), dtype=np.float32))
    monkeypatch.setattr(moe, "GROUP_TOKENS", 32)

    def run():
        ins = [t.clone().requires_grad_(True) for t in (q, k, v, x, *p.values())]
        y = attention.flash_attention(*ins[:3], q_chunk=16, kv_chunk=16, window=24)
        z, aux = moe.moe_apply(cfg, dict(zip(p, ins[4:])), ins[3])
        loss = (y * y).sum() + (z * z).sum() + aux
        return torch.autograd.grad(loss, ins)

    checkpointed = run()
    monkeypatch.setattr(attention, "checkpoint", lambda f, *a, **kw: f(*a))
    monkeypatch.setattr(moe, "checkpoint", lambda f, *a, **kw: f(*a))
    plain = run()
    for a, b in zip(checkpointed, plain, strict=True):
        assert torch.equal(a, b)


def test_chunked_xent_masks_labels_like_jax():
    jcfg, cfg = _cfgs("llama3.2-1b", {})
    rng = np.random.default_rng(11)
    hidden = rng.standard_normal((2, 60, cfg.d_model), dtype=np.float32)
    embed = (rng.standard_normal((cfg.vocab, cfg.d_model)) * 0.05).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 60)).astype(np.int32)
    labels[rng.random((2, 60)) < 0.3] = -1
    for chunk in (16, 60):   # 16 lowers to 15, a divisor of 60
        want = jax.jit(lambda e, h, lb, c=chunk: jtf.chunked_xent(jcfg, {"embed": e}, h, lb, c))(
            embed, hidden, labels)
        got = transformer.chunked_xent(cfg, {"embed": torch.from_numpy(embed)},
                                       torch.from_numpy(hidden),
                                       torch.from_numpy(labels.astype(np.int64)), chunk)
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want)), chunk
    none = torch.full((2, 60), -1)
    assert float(transformer.chunked_xent(cfg, {"embed": torch.from_numpy(embed)},
                                          torch.from_numpy(hidden), none)) == 0.0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hybrid"])
def test_streamed_schedule_matches_plain_and_jax(arch):
    jcfg, cfg = _cfgs(*HYBRID) if arch == "hybrid" else _cfgs(arch, {})
    nb = _np_batch(jcfg, seed=9)

    def f(key, batch):
        params = jtf.init_lm(key, jcfg)[0]
        return params, *jts._streamed_loss_and_grads(jcfg, params, batch)

    jparams, jloss, jgrads = jax.jit(f)(jax.random.key(1), _jbatch(nb))
    params = transformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = _tbatch(nb)
    loss, grads = train_step._loss_and_grads(cfg, params, batch, streamed=True)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _close_grads(grads, jax.tree.map(np.asarray, jgrads), f"{arch} streamed vs JAX")
    ploss, pgrads = train_step._loss_and_grads(cfg, params, batch, streamed=False)
    assert abs(float(loss) - float(ploss)) <= LOSS_RTOL * abs(float(ploss))
    _close_grads(grads, jax.tree.map(lambda t: t.numpy(), pgrads), f"{arch} streamed vs plain")
    # a unit is its sublayers in order
    p_u = transformer._unit(params["blocks"], 0)
    positions = transformer._positions_for(cfg, batch)
    h = transformer.embed_fn(cfg, params, batch)
    want, _ = transformer.unit_fn(cfg, p_u, h, positions)
    for j in range(transformer.num_sublayers(cfg)):
        h, _ = transformer.sublayer_fn(cfg, j, p_u[f"sub{j}"] if arch == "hybrid" else p_u, h,
                                       positions)
    assert torch.equal(h, want)
    with pytest.raises(ValueError, match="decoder-only"):
        train_step._streamed_loss_and_grads(reduced(get_config("whisper-base")), params, batch)


def _opt_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16), dtype=np.float32),
            "b": rng.standard_normal(16, dtype=np.float32),
            "blocks": {"wi": rng.standard_normal((2, 4, 8), dtype=np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "momentum_sgd"])
def test_optimizers_bitwise_jax_on_float32(name):
    opt, jo = optimizers.get_optimizer(name), jopt.get_optimizer(name)
    params, jparams = ({k: v for k, v in _opt_tree(0).items()},) * 2
    params = jax.tree.map(torch.from_numpy, params)
    jparams = jax.tree.map(jnp.asarray, jparams)
    state, jstate = opt.init(params), jo.init(jparams)
    for step in range(4):
        grads = _opt_tree(10 + step)
        params, state = opt.update(params, jax.tree.map(torch.from_numpy, grads), state, step)
        jparams, jstate = jo.update(jparams, jax.tree.map(jnp.asarray, grads), jstate,
                                    jnp.uint32(step))
        for a, b in zip(tree_leaves(params), jax.tree.leaves(jparams), strict=True):
            assert a.dtype == torch.float32
            assert (a.numpy().view(np.uint32) == np.asarray(b).view(np.uint32)).all(), step
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.get_optimizer("sgd")


def test_optimizers_keep_bfloat16_params():
    """Float32 math on bfloat16 params; each leaf keeps its dtype."""
    p = {"w": torch.ones(2, 2, dtype=torch.bfloat16), "s": torch.zeros(2)}
    g = {"w": torch.full((2, 2), 0.5, dtype=torch.bfloat16), "s": torch.ones(2)}
    for name in ("adamw", "momentum_sgd"):
        opt = optimizers.get_optimizer(name)
        new, state = opt.update(p, g, opt.init(p), 0)
        assert new["w"].dtype == torch.bfloat16 and new["s"].dtype == torch.float32
        m = state.m if name == "adamw" else state
        assert m["w"].dtype == torch.bfloat16


def test_checkpoints_cross_read_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    bf = rng.standard_normal((3, 5), dtype=np.float32)
    tree = ({"blocks": {"wi": torch.from_numpy(rng.standard_normal((2, 3), dtype=np.float32))},
             "embed": torch.from_numpy(bf).to(torch.bfloat16)},
            optimizers.AdamWState(m={"a": torch.arange(4, dtype=torch.int32)},
                                  v={"a": torch.zeros(4, dtype=torch.int32)}))
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                         if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    jtree = (jtree[0], jopt.AdamWState(m=jtree[1].m, v=jtree[1].v))

    def same(a, b):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        b = np.asarray(b)
        b = b.view(np.int16) if b.dtype == jnp.bfloat16 else b
        return a.dtype == b.dtype and a.shape == b.shape and (a == b).all()

    # the port writes, JAX reads
    io.save_checkpoint(tmp_path / "port", 3, tree)
    got, step = jio.load_checkpoint(tmp_path / "port", jtree)
    assert step == 3 and all(same(a, b) for a, b in zip(tree_leaves(tree[0]) + tree_leaves(
        tree[1].m) + tree_leaves(tree[1].v), jax.tree.leaves(got)))
    # JAX writes, the port reads (the latest of two steps)
    jio.save_checkpoint(tmp_path / "jax", 1, jtree)
    jio.save_checkpoint(tmp_path / "jax", 12, jtree)
    back, step = io.load_checkpoint(tmp_path / "jax", tree)
    assert step == 12 == io.latest_step(tmp_path / "jax")
    assert isinstance(back[1], optimizers.AdamWState)
    assert all(same(a, b) for a, b in zip(
        tree_leaves(back[0]) + tree_leaves(back[1].m) + tree_leaves(back[1].v),
        jax.tree.leaves(jtree)))
    # the same paths, dtype names and structure as JAX writes
    import json

    mine = json.loads((tmp_path / "port" / "step_00000003" / "tree.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "step_00000001" / "tree.json").read_text())
    assert mine["paths"] == theirs["paths"] and mine["dtypes"] == theirs["dtypes"]
    assert mine["treedef"] == theirs["treedef"]
    assert io.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        io.load_checkpoint(tmp_path / "none", tree)
    with pytest.raises(ValueError, match="leaves"):
        io.load_checkpoint(tmp_path / "jax", tree[0])
