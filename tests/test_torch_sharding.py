"""The port's sharding specs (``dist.sharding``) against the JAX package's,
on the CPU, with no process group: ``param_pspecs`` reads only a mesh's
axis names and sizes, so the port's ``AbstractMesh`` faces JAX's
``jax.sharding.AbstractMesh``.

- ``transformer.logical_axes`` equals the second result of JAX's
  ``init_lm`` for all ten archs, reduced and at their published sizes.
- ``param_pspecs`` equals JAX's on (data, model) = (2, 2) and (pod, data,
  model) = (2, 2, 2), with ``fsdp`` on and off, divisibility pruning on the
  full shapes included; an MoE tree on a model axis raises with ROADMAP
  fact F17's words (JAX's own specs name the model axis twice there).
- ``local_bucket_sizes``, the EF state's and the telemetry row's shapes
  (JAX's ``(n_dp, n_model · row)``, a rank's ``row``), ``cache_pspecs``
  and the optimizer's specs equal JAX's.
- ``local_shard`` cuts each leaf into the blocks that tile it: the model
  ranks' blocks joined in rank order give it back, and every data rank
  holds the same ones.
- ``check_model_axis`` refuses what the slice does not cover.
- ``train_step.ef_rank_rows`` and ``ef_stacked`` carry EF state between
  JAX's layout and each rank's rows, both ways.
- The dry run on ``2x2``: one model shard's bytes, the layers' sums as
  all-reduces, the whole model's counts; MoE refused.

A few seconds alone.
"""
import functools
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.dist import serve_step as jserve  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.dist import train_step as jts  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.dist import compat, serve_step, sharding, train_step  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

ARCHS = configs.list_archs()
MESHES = {"2x2": ((2, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SIZES = ("reduced", "full")
DENSE = ("llama3.2-1b", "gemma-7b", "minitron-8b", "granite-20b")


def _cfgs(arch: str, size: str):
    if size == "reduced":
        return (configs.reduced(configs.get_config(arch)),
                jconfigs.reduced(jconfigs.get_config(arch)))
    return configs.get_config(arch), jconfigs.get_config(arch)


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str, size: str):
    """JAX's (params as ShapeDtypeStructs, logical axes)."""
    _, jcfg = _cfgs(arch, size)
    box = {}

    def init(key):
        params, box["logical"] = jtf.init_lm(key, jcfg)
        return params

    return jax.eval_shape(init, jax.random.key(0)), box["logical"]


@functools.lru_cache(maxsize=None)
def _meta_init(arch: str, size: str):
    cfg, _ = _cfgs(arch, size)
    # repro: allow REPRO204 (a meta draw has no values: the key shapes nothing)
    return transformer.init_lm(prng.key(0), cfg, device="meta")


def _jmesh(name):
    sizes, names = MESHES[name]
    return jax.sharding.AbstractMesh(sizes, names)


def _tuples(jspecs):
    return jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(x, JP))


def _is_spec(x) -> bool:
    """A spec as a tuple: each entry None, a name or a tuple of names (a
    NamedTuple state or a pair of specs is a node)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and e
                                            and all(isinstance(a, str) for a in e))
        for e in x)


def _spec_leaves(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=_is_spec)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_are_jax(arch, size):
    cfg, _ = _cfgs(arch, size)
    assert transformer.logical_axes(cfg) == _jax_init(arch, size)[1]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_are_jax(arch, size, mesh, fsdp):
    cfg, _ = _cfgs(arch, size)
    jparams, jlogical = _jax_init(arch, size)
    want = _tuples(jsharding.param_pspecs(jlogical, _jmesh(mesh), fsdp, jparams))
    amesh = compat.AbstractMesh(*MESHES[mesh])
    logical = transformer.logical_axes(cfg)
    if cfg.moe is not None:
        # JAX names the model axis twice on the stacked expert weights (F17)
        flat = _spec_leaves(want)
        assert any(s.count("model") == 2 for s in flat)
        with pytest.raises(ValueError, match="F17"):
            sharding.param_pspecs(logical, amesh, fsdp, _meta_init(arch, size))
        return
    got = sharding.param_pspecs(logical, amesh, fsdp, _meta_init(arch, size))
    assert got == want
    assert all(isinstance(s, sharding.PartitionSpec) for s in sharding.tree_leaves(got))
    # without shapes: no pruning, as JAX's
    assert sharding.param_pspecs(logical, amesh, fsdp) == _tuples(
        jsharding.param_pspecs(jlogical, _jmesh(mesh), fsdp))
    assert sharding.strip_to_manual(got, amesh) == _tuples(
        jsharding.strip_to_manual(jsharding.param_pspecs(jlogical, _jmesh(mesh), fsdp, jparams),
                                  _jmesh(mesh)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", DENSE)
def test_state_geometry_is_jax(arch, size, mesh):
    cfg, jcfg = _cfgs(arch, size)
    jparams, jlogical = _jax_init(arch, size)
    jmesh = _jmesh(mesh)
    jspecs = jsharding.param_pspecs(jlogical, jmesh, jcfg.fsdp, jparams)
    amesh = compat.AbstractMesh(*MESHES[mesh])
    pspecs = sharding.lm_pspecs(cfg, amesh)
    params = _meta_init(arch, size)
    kw = dict(sync="faithful", error_feedback=True, bucket_mb=4.0 if size == "full" else 0.05)
    ts = train_step.TrainStepConfig(**kw, compressor=CompressorConfig(method="tnqsgd", bits=3))
    jts_cfg = jts.TrainStepConfig(**kw, compressor=JConfig(method="tnqsgd", bits=3))
    sizes = train_step.local_bucket_sizes(params, ts, amesh, pspecs)
    assert sizes == tuple(jts.local_bucket_sizes(jparams, jmesh, jspecs, jts_cfg))
    assert len(sizes) > 1
    # a rank's slices give the same sizes as the full tree and its specs
    local = sharding.shard_tree(params, pspecs, amesh)
    assert train_step.local_bucket_sizes(local, ts) == sizes
    jef = jax.eval_shape(lambda: jts.init_ef_state(jparams, jmesh, jspecs, jts_cfg))
    ef = train_step.init_ef_state(params, ts, amesh, pspecs)
    n_dp = math.prod(amesh.dp_sizes)
    assert [tuple(e.shape) for e in jef] == [(n_dp, amesh.model_size * e.numel()) for e in ef]
    # JAX's EF layout carried to each rank's rows and back (row sizes of
    # the reduced config: the full ones are GBs)
    m_rows = [e.numel() if size == "reduced" else 8 for e in ef[:2]]
    full_ef = [torch.arange(n_dp * amesh.model_size * m, dtype=torch.float32).reshape(n_dp, -1)
               for m in m_rows]
    rows = [train_step.ef_rank_rows(full_ef, d, m, amesh.model_size)
            for d in range(n_dp) for m in range(amesh.model_size)]
    assert rows[1][0].numel() == m_rows[0]
    back = train_step.ef_stacked(rows, n_dp, amesh.model_size)
    assert all(torch.equal(a, b) for a, b in zip(back, full_ef, strict=True))
    jt = jax.eval_shape(lambda: jts.init_telemetry_state(jparams, jmesh, jspecs, jts_cfg))
    t = train_step.init_telemetry_state(params, ts, amesh, pspecs)
    assert [tuple(x.shape) for x in t] == [tuple(x.shape[1:]) for x in jt]
    # the optimizers' state specs
    for name in ("momentum_sgd", "adamw"):
        jo = jax.eval_shape(jopt.get_optimizer(name).init, jparams)
        want = _tuples(jts._opt_specs(jo, jparams, jspecs))
        got = train_step._opt_specs(optimizers.get_optimizer(name).init(params), params, pspecs)
        assert sharding.tree_leaves(got) == _spec_leaves(want), name


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_are_jax(arch, mesh):
    cfg, jcfg = _cfgs(arch, "reduced")
    for b in (4, 3):
        want = _spec_leaves(_tuples(jserve.cache_pspecs(jcfg, b, 80, _jmesh(mesh))))
        got = serve_step.cache_pspecs(cfg, b, 80, compat.AbstractMesh(*MESHES[mesh]))
        # JAX's KV cache carries its lengths as a (units,) leaf; the port's
        # is a host int
        got_leaves = []
        serve_step._map_caches(got_leaves.append, got)
        assert got_leaves == [s for s in want if len(s) > 1], (arch, b)


def test_local_shard_tiles_each_leaf():
    cfg = configs.reduced(configs.get_config("llama3.2-1b"))
    full = transformer.init_lm(prng.key(0), cfg, device="cpu")
    sizes, names = MESHES["2x2"]
    pspecs = sharding.lm_pspecs(cfg, compat.AbstractMesh(sizes, names))
    ranks = [sharding.shard_tree(full, pspecs, compat.AbstractMesh(sizes, names, r))
             for r in range(4)]
    leaves = list(zip(*(sharding.tree_leaves(r) for r in ranks)))
    for x, spec, per_rank in zip(sharding.tree_leaves(full), sharding.tree_leaves(pspecs),
                                 leaves, strict=True):
        split = [d for d, e in enumerate(spec) if e == "model"]
        # ranks (d, m) = (0, 0), (0, 1), (1, 0), (1, 1): data ranks alike
        assert torch.equal(per_rank[0], per_rank[2]) and torch.equal(per_rank[1], per_rank[3])
        if split:
            assert per_rank[0].shape[split[0]] * 2 == x.shape[split[0]]
            assert torch.equal(torch.cat(per_rank[:2], dim=split[0]), x)
        else:
            assert torch.equal(per_rank[0], x) and torch.equal(per_rank[1], x)
    # the embedding, the heads, the MLP: all split; the norms whole
    assert pspecs["embed"] == ("model", None)
    assert pspecs["blocks"]["mixer"]["wo"] == (None, "model", None)
    assert pspecs["blocks"]["ln1"]["scale"] == (None, None)


def test_check_model_axis_refusals():
    refused = {"phi3.5-moe-42b-a6.6b": "F17", "qwen3-moe-235b-a22b": "F17",
               "jamba-1.5-large-398b": "F17", "qwen2-vl-2b": "vlm family",
               "whisper-base": "audio family", "mamba2-2.7b": "ssm family",
               "granite-20b": "1 KV heads"}
    for arch in ARCHS:
        for cfg in _cfgs(arch, "full")[:1] + _cfgs(arch, "reduced")[:1]:
            sharding.check_model_axis(cfg, 1)
            if arch in refused:
                with pytest.raises(ValueError, match=refused[arch]) as e:
                    sharding.check_model_axis(cfg, 2)
                assert r"Queue 1, item 4.2" in str(e.value)
            else:
                sharding.check_model_axis(cfg, 2)
    with pytest.raises(ValueError, match="8 KV heads do not divide"):
        sharding.check_model_axis(configs.get_config("llama3.2-1b"), 16)


def test_dry_run_on_a_model_axis():
    """``launch.dryrun`` on ``DxM``: one model shard's step (its slices of
    the params, the layers' sums counted as all-reduces), the whole
    model's parameter counts; MoE refused by fact F17."""
    from repro_torch.launch import dryrun

    train = dryrun.shape_for("train_4k", 4, 64)
    one = dryrun.run_one("llama3.2-1b", train, mesh_spec="2", ef=True, is_reduced=True)
    tp = dryrun.run_one("llama3.2-1b", train, mesh_spec="2x2", ef=True, is_reduced=True)
    assert tp["n_params"] == one["n_params"] and tp["chips"] == 4 and tp["axes"] == ["data",
                                                                                   "model"]
    cfg = configs.reduced(configs.get_config("llama3.2-1b"))
    mesh = compat.AbstractMesh((2, 2), ("data", "model"))
    local = sharding.shard_tree(_meta_init("llama3.2-1b", "reduced"),
                                sharding.lm_pspecs(cfg, mesh), mesh)
    saved = 4 * (one["n_params"] - sum(x.numel() for x in sharding.tree_leaves(local)))
    # the params (float32 here), their optimizer state and EF rows: a model
    # shard's share
    assert saved > 0
    assert (one["memory"]["argument_size_in_bytes"] - tp["memory"]["argument_size_in_bytes"]
            >= 3 * saved)
    assert one["roofline"]["collective_bytes_by_kind"].get("all-reduce", 0) == 0
    assert tp["roofline"]["collective_bytes_by_kind"]["all-reduce"] > 0
    pre = dryrun.run_one("llama3.2-1b", dryrun.shape_for("prefill_32k", 2, 64),
                         mesh_spec="1x2", is_reduced=True)
    assert pre["roofline"]["collective_bytes_by_kind"]["all-gather"] > 0   # the logits
    with pytest.raises(ValueError, match="F17"):
        dryrun.run_one("phi3.5-moe-42b-a6.6b", train, mesh_spec="2x2", is_reduced=True)
