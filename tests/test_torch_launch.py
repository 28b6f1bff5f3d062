"""The port's dry run and roofline (``repro_torch.launch``: ``mesh``,
``specs``, ``op_cost``, ``roofline``, ``dryrun``, ``report``), the input
shapes of ``repro_torch.configs`` and ``examples/train_8clients_torch.py
--adaptive``, against the JAX package on the CPU.

Contract:
- ``INPUT_SHAPES``, ``get_shape`` and ``variant_for_shape`` are JAX's;
- ``count_params`` and ``count_active_params`` of the meta-device init are
  exactly JAX's ``abstract_init`` counts for all ten archs at full size;
- ``input_specs`` has JAX's shapes for each reduced arch and shape, its
  dtypes JAX's up to the port's int64 token ids (the decode position is a
  host int);
- ``model_flops_for`` is JAX's for every arch and shape;
- ``op_cost`` counts a hand-counted two-layer MLP and one attention tile
  exactly (FLOPs by dtype, elementwise FLOPs, bytes, peak live bytes), and
  the reduced llama's forward matrix products at the analytic count;
- dry-run records of the reduced archs carry JAX's keys, and JAX's report
  renders them as the port's does (``roofline_table``, ``dryrun_table``,
  ``load`` with its warning);
- ``--adaptive``'s plan is JAX's: the same bits, α within rtol 1e-4
  (ROADMAP fact F3).

About 50 s alone in one process (the JAX example's eager plan is 35 s).
"""
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, mesh, op_cost, report, roofline, specs  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.smallnet import tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = configs.list_archs()
SMALL = {"train": ("train_4k", 2, 64), "prefill": ("prefill_32k", 2, 64),
         "decode": ("decode_32k", 2, 64)}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_input_shapes_are_jax():
    assert {k: dataclasses.asdict(v) for k, v in configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    for name in configs.INPUT_SHAPES:
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(jconfigs.get_shape(name))
        assert configs.get_shape(name).is_decode == jconfigs.get_shape(name).is_decode
        for arch in ARCHS:
            got = configs.variant_for_shape(configs.get_config(arch), configs.get_shape(name))
            want = jconfigs.variant_for_shape(jconfigs.get_config(arch),
                                              jconfigs.get_shape(name))
            assert got.sliding_window == want.sliding_window, (arch, name)
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("train_1m")


@pytest.mark.parametrize("spec,names,dims", [
    ("4", ("data",), (4,)), ("4x1", ("data", "model"), (4, 1)),
    ("2X4x1", ("pod", "data", "model"), (2, 4, 1))])
def test_mesh_axes_each_spec_form(spec, names, dims):
    assert mesh.mesh_axes(spec) == (names, dims)
    dp = tuple(n for n in names if n != "model")
    assert mesh.data_parallel_axes(spec) == (dp, tuple(d for n, d in zip(names, dims)
                                                       if n != "model"))


def test_mesh_rejects_model_axis_and_bad_specs():
    # a model axis above 1 trains the dense family; MoE waits (fact F17)
    assert mesh.data_parallel_axes("4x2") == (("data",), (4,))
    mesh.check_model_axis(configs.get_config("llama3.2-1b"), 2)
    with pytest.raises(ValueError, match=r"F17.*Queue 1, item 4\.2"):
        mesh.check_model_axis(configs.get_config("phi3.5-moe-42b-a6.6b"), 2)
    for bad in ("2x2x2x2", "x4", "0", "four"):
        with pytest.raises(ValueError, match="bad mesh spec"):
            mesh.mesh_axes(bad)
    assert mesh.matmul_peak(torch.bfloat16, False) == 989e12
    assert mesh.matmul_peak(torch.float32, True) == 495e12
    assert mesh.matmul_peak(torch.float32, False) == 67e12


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_are_jax(arch):
    cfg = configs.get_config(arch)
    p = specs.abstract_init(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(p))
    jp, jla = jspecs.abstract_init(jconfigs.get_config(arch))
    assert specs.count_params(p) == jspecs.count_params(jp)
    assert specs.count_active_params(cfg, p) == \
        jspecs.count_active_params(jconfigs.get_config(arch), jp, jla)


def _tensors(tree) -> list:
    """The tensors of a cache tree (dicts, KV caches, SSM states, tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return []


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_jax(arch):
    cfg = configs.reduced(configs.get_config(arch))
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    ids = {"int32": "int64"}      # the port's token ids and positions are int64
    for name in configs.INPUT_SHAPES:
        shape = dataclasses.replace(configs.get_shape(name), seq_len=64, global_batch=2)
        jshape = dataclasses.replace(jconfigs.get_shape(name), seq_len=64, global_batch=2)
        got = specs.input_specs(configs.variant_for_shape(cfg, shape), shape)
        want = jspecs.input_specs(jconfigs.variant_for_shape(jcfg, jshape), jshape)
        if shape.kind != "decode":
            for f, a, b in zip(transformer.Batch._fields, got["batch"], want["batch"]):
                assert (a is None) == (b is None), (name, f)
                if a is not None:
                    assert tuple(a.shape) == tuple(b.shape), (name, f)
                    assert _dtype_name(a) == ids.get(str(b.dtype), str(b.dtype)), (name, f)
                    assert a.device.type == "meta"
            continue
        assert tuple(got["token"].shape) == want["token"].shape
        assert isinstance(got["position"], int) and want["position"].shape == ()
        # the port's cache lengths are host ints, JAX's int32 leaves
        w_leaves = [t for t in jax.tree.leaves(want["caches"]) if str(t.dtype) != "int32"]
        assert sorted((tuple(t.shape), _dtype_name(t)) for t in _tensors(got["caches"])) == \
            sorted((tuple(t.shape), str(t.dtype)) for t in w_leaves), name


def test_model_flops_are_jax():
    for arch in ARCHS:
        p = specs.abstract_init(configs.get_config(arch))
        n, a = specs.count_params(p), specs.count_active_params(configs.get_config(arch), p)
        for name in configs.INPUT_SHAPES:
            got = roofline.model_flops_for(configs.get_config(arch), configs.get_shape(name), n, a)
            want = jroofline.model_flops_for(jconfigs.get_config(arch),
                                             jconfigs.get_shape(name), n, a)
            assert got == want, (arch, name)
    # the yardstick of a measured step: model FLOPs over the bf16 peak
    assert roofline.mfu(989e12, 1.0) == 1.0
    assert roofline.mfu(6.0 * 1_235_814_400 * 4 * 2048, 2.0) == pytest.approx(0.0307, rel=1e-3)


def test_op_cost_two_layer_mlp_exact():
    b, d, h, o = 8, 16, 32, 4
    x, w1, w2 = _meta(b, d), _meta(d, h), _meta(h, o, dtype=torch.bfloat16)
    with op_cost.OpCost(live=(x, w1, w2)) as oc:
        y = torch.relu(x @ w1).to(torch.bfloat16) @ w2
    c = oc.cost
    assert c.matmul_flops == {"float32": 2.0 * b * d * h, "bfloat16": 2.0 * b * h * o}
    assert c.elementwise_flops == b * h                      # relu; the cast is a copy
    assert c.bytes == (4 * (b * d + d * h + b * h)           # mm 1: read x, w1, write h
                       + 4 * b * h * 2                       # relu
                       + 4 * b * h + 2 * b * h               # the cast
                       + 2 * (b * h + h * o + b * o))        # mm 2
    base = 4 * (b * d + d * h) + 2 * h * o
    # at most the matmul's and relu's outputs alive at once, then y beside the cast
    assert c.peak_bytes == base + 2 * 4 * b * h
    assert c.flops == sum(c.matmul_flops.values()) + c.elementwise_flops
    assert y.shape == (b, o)


def test_op_cost_attention_tile_exact():
    b, q, k, h, d = 2, 8, 16, 4, 32
    qb, kb, vb = _meta(b, q, h, d), _meta(b, k, h, d), _meta(b, k, h, d)
    mask = _meta(q, k, dtype=torch.bool)
    m, l, acc = _meta(b, q, h), _meta(b, q, h), _meta(b, q, h, d)
    with op_cost.OpCost() as oc:
        attention._kv_step(qb, kb, vb, mask, m, l, acc, 0.125)
    c = oc.cost
    s, r, a = b * q * h * k, b * q * h, b * q * h * d      # score tile, row stats, acc
    assert c.matmul_flops == {"float32": 2 * 2.0 * b * h * q * k * d}
    # scale, mask, max (reads s), s - m, exp, sum (reads s); max, m - m_new,
    # exp, l·corr, + sum; acc·corr, + PV
    assert c.elementwise_flops == 6 * s + 5 * r + 2 * a
    f4 = 4
    einsum_copies = 2 * f4 * (b * h * q * d + 2 * b * h * k * d)   # q, k, v made contiguous
    bmm = f4 * (b * h * q * d + b * h * d * k + s) + f4 * (s + b * h * k * d + a)
    pointwise = (f4 * 2 * s                                 # s * scale
                 + (q * k + f4 * s + f4 + f4 * s)           # where(mask, s, scalar)
                 + f4 * (s + r) * 2                         # amax, sum
                 + f4 * 3 * r * 4                           # maximum, sub, mul, add on rows
                 + f4 * 2 * r                               # exp on rows
                 + f4 * (2 * s + r)                         # s - m_new
                 + f4 * 2 * s                               # exp
                 + f4 * (2 * a + r)                         # acc * corr
                 + f4 * 3 * a)                              # + PV
    assert c.bytes == einsum_copies + bmm + pointwise + f4  # + the scalar_tensor


def test_reduced_llama_forward_matmul_flops_are_analytic():
    cfg = configs.reduced(configs.get_config("llama3.2-1b"))
    bsz, seq = 2, 64
    p = specs.abstract_init(cfg)
    batch = specs.abstract_batch(cfg, bsz, seq)
    with torch.no_grad(), op_cost.OpCost() as oc:
        transformer.loss_fn(cfg, p, batch)
    t, dm, dh = bsz * seq, cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * t * dm * dh * (2 * hq + 2 * hkv)               # wq, wk, wv, wo
    mlp = 3 * 2 * t * dm * cfg.d_ff                             # wi, wg, wo
    attn = 2 * 2 * bsz * hq * seq * seq * dh                    # one tile: QKᵀ and PV
    head = 2 * t * dm * cfg.vocab
    assert oc.cost.matmul_flops == {"float32": float(cfg.num_layers * (proj + mlp + attn)
                                                     + head)}


JAX_RECORD_KEYS = ("arch", "shape", "mesh", "axes", "chips", "sync", "kind", "n_params",
                   "n_active_params", "lower_s", "compile_s", "memory", "roofline", "fsdp",
                   "sliding_window")
JAX_MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                   "alias_size_in_bytes", "total_per_device_bytes")


@pytest.fixture(scope="module")
def records():
    jax_roof_keys = jroofline.Roofline(1.0, 1.0, 0.0, 1.0, jroofline.CollectiveStats({}, {}))
    keys = set(jax_roof_keys.to_dict())
    out = []
    for arch in ARCHS:
        for kind, (name, bsz, seq) in SMALL.items():
            rec = dryrun.run_one(arch, dryrun.shape_for(name, bsz, seq), is_reduced=True,
                                 ef=kind == "train", optimizer="momentum_sgd")
            assert keys <= set(rec["roofline"]), arch
            out.append(rec)
    return out


def test_dryrun_records_in_jax_schema(records):
    assert len(records) == 3 * len(ARCHS)
    for rec in records:
        assert set(JAX_RECORD_KEYS) <= set(rec), rec["arch"]
        assert set(JAX_MEMORY_KEYS) <= set(rec["memory"])
        r = rec["roofline"]
        assert rec["mesh"] == "1" and rec["chips"] == 1 and rec["axes"] == ["data"]
        assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["collective_bytes"] == 0.0
        assert r["bottleneck"] in ("compute", "memory")
        assert rec["fits_one_card"] and rec["device"] == "meta"
        assert rec["memory"]["total_per_device_bytes"] >= \
            rec["memory"]["argument_size_in_bytes"] > 0
        assert (rec["sync"] is not None) == (rec["kind"] == "train")
        if rec["kind"] == "train":    # tnqsgd at 3 bits: the codebook's words on top
            assert 3.0 < rec["parts"]["sync"]["wire_bits_per_element"] < 3.2
            assert rec["parts"]["model"]["flops"] + rec["parts"]["sync"]["flops"] == r["flops"]
        json.dumps(rec)


def test_dryrun_sync_terms_and_the_cli(tmp_path):
    """Four ranks: the sync's wire over the ring (``wire_bytes_per_device``
    times its hops); one rank moves nothing.  The CLI writes the record."""
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.dist import collectives
    from repro_torch.dist.train_step import TrainStepConfig

    sizes = [1000, 3000]
    for sync, kinds in (("faithful", {"all-gather"}), ("two_phase", {"all-to-all", "all-gather"}),
                        ("dsgd", {"all-reduce"})):
        ts = TrainStepConfig(sync=sync, error_feedback=sync != "dsgd",
                             compressor=CompressorConfig(method="tnqsgd", bits=3))
        c, working = dryrun.sync_cost(ts, sizes, (4,), 2)
        assert set(c.coll) == kinds and working == 16 * 4000 + 4 * 3000
        one, _ = dryrun.sync_cost(ts, sizes, (1,), 2)
        assert one.coll == {}
    ts = TrainStepConfig(sync="faithful", compressor=CompressorConfig(method="tnqsgd", bits=3))
    c, _ = dryrun.sync_cost(ts, sizes, (4,), 4)
    assert c.coll["all-gather"] == collectives.wire_bytes_per_device(
        ts.compressor, sizes, 4, "faithful") * 4 * 3
    out = tmp_path / "rec.json"
    assert dryrun.main(["--arch", "whisper-base", "--shape", "train_4k", "--batch", "2",
                        "--seq", "64", "--reduced", "--mesh", "2", "--ef", "--out",
                        str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["shape"] == "train_2x64" and rec["batch_per_rank"] == 1 and rec["chips"] == 2
    assert rec["roofline"]["collective_bytes"] > 0
    assert dryrun.main(["--arch", "phi3.5-moe-42b-a6.6b", "--shape", "train_4k", "--mesh",
                        "2x2", "--reduced"]) == 1    # MoE on a model axis: item 4.2 (F17)


def test_report_tables_are_jax(records, tmp_path, capsys):
    for mesh_name in ("1", "16x16"):
        recs = [dict(r, mesh=mesh_name) for r in records]
        assert report.roofline_table(recs, mesh_name) == jreport.roofline_table(recs, mesh_name)
        assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    multi = [dict(records[0], mesh="2x16x16", roofline=dict(
        records[0]["roofline"], collective_bytes_by_kind={"all-gather": 3 * 2**30,
                                                          "all-to-all": 2**29}))]
    assert report.dryrun_table(multi) == jreport.dryrun_table(multi)
    # load: the JAX package's canonical names read alike; a sync variant is not canonical
    for r in records[:3]:
        (tmp_path / f"{r['arch']}__{r['shape']}__16x16.json").write_text(json.dumps(r))
    (tmp_path / f"{records[0]['arch']}__train_4k__16x16_two_phase.json").write_text("{}")
    assert report.load(tmp_path) == jreport.load(tmp_path)
    assert report.load(tmp_path, canonical=False) == jreport.load(tmp_path, canonical=False)
    (tmp_path / "broken__train_4k__16x16.json").write_text("{not json")
    capsys.readouterr()
    got = report.load(tmp_path)
    err = capsys.readouterr().err
    assert len(got) == 3 and "warning: skipping unreadable record" in err and "broken" in err
    assert report.main(["--dir", str(tmp_path), "--mesh", "16x16"]) == 0
    assert "## Roofline (16x16, 3 records)" in capsys.readouterr().out


def _load_example(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_adaptive_leaf_plan_is_jax(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    jex = _load_example(ROOT / "examples" / "train_8clients.py", "train_8clients_jax")
    tex = _load_example(ROOT / "examples" / "train_8clients_torch.py", "train_8clients_port")
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        jplan, jtable = jex._adaptive_leaf_plan("tnqsgd", 3)
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    plan, table = tex.adaptive_leaf_plan("tnqsgd", 3, device="cpu")
    assert tuple(plan.bits) == tuple(jplan.bits)
    assert (plan.spend_bytes, plan.budget_bytes) == (jplan.spend_bytes, jplan.budget_bytes)
    np.testing.assert_allclose(np.asarray(plan.alphas, np.float64),
                               np.asarray(jplan.alphas, np.float64), rtol=1e-4)
    assert table.splitlines()[:2] == jtable.splitlines()[:2]
    assert [ln.split("|")[1:4] for ln in table.splitlines()[2:]] == \
        [ln.split("|")[1:4] for ln in jtable.splitlines()[2:]]
