"""The port's static-analysis passes (``repro_torch.analysis``) on the CPU.

Contract:
- each REPRO2xx rule flags its snippet (given as source text under the
  path it applies to) and an allow comment silences it again; the port's
  own tree is clean under the AST pass;
- one spawn of four gloo ranks runs the sync pass's quick matrix
  (tqsgd, powersgd, dsgd × the four modes, with EF, telemetry and a mixed
  plan) and the one-process replays: clean, the collectives at their
  budgets (faithful 1, two_phase 2, hierarchical 3, dsgd one a bucket);
  and seeded violations, each flagged: an extra collective (REPRO101), a
  rank-independent draw key (REPRO102), a float64 (REPRO103), a float
  ``index_add_`` (REPRO104) and an int64 wire (REPRO105); and
  ``launch.op_cost`` counts a real all-gather's and psum's ring bytes;
- the ptxas parser reads a recorded report of the build into K1–K17's
  resources (a spilling kernel, too much shared memory or too many
  registers is REPRO301; a budget admits it);
- the CLI writes the JAX package's report layout with the port's passes.

About 20 s alone in one process (the spawn).
"""
import json
import os
import pathlib
import traceback

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (RULES, Finding, ast_lint, filter_suppressed,  # noqa: E402
                                  kernel_resources, suppressed_codes)
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis import sync_lint  # noqa: E402

REPORTS = pathlib.Path(__file__).resolve().parent / "torch_ptxas_reports.txt"


def _codes(findings):
    return [f.code for f in findings]


# ---------------------------------------------------------------------------
# Taxonomy, suppression and the AST rules (REPRO2xx)
# ---------------------------------------------------------------------------


def test_rule_taxonomy_and_suppression():
    assert {c[:6] for c in RULES} == {"REPRO1", "REPRO2", "REPRO3"}
    assert all(len(c) == 8 and RULES[c] for c in RULES)
    lines = ["x = 1", "y = f()  # repro: allow REPRO104 (documented)",
             "# repro: allow REPRO102, REPRO204 (both)", "z = g()"]
    assert suppressed_codes(lines, 2) == {"REPRO104"}
    assert suppressed_codes(lines, 4) == {"REPRO102", "REPRO204"}
    assert suppressed_codes(lines, 1) == frozenset()
    assert Finding("REPRO104", "a.py:2", "m").to_json() == {
        "code": "REPRO104", "where": "a.py:2", "message": "m"}
    found = [Finding("REPRO104", "a.py:2", "m"), Finding("REPRO104", "a.py:1", "m"),
             Finding("REPRO101", "sync:faithful/tqsgd", "m")]
    assert filter_suppressed(found, {"a.py": lines}) == found[1:]


SNIPPETS = {
    "REPRO201": ("repro_torch/dist/sharded_codec.py", [
        "def body(cfg, x):",
        "    if cfg.method == 'tqsgd':",
        "        return x",
        "    return -x"]),
    "REPRO202": ("repro_torch/dist/train_step.py", [
        "import ctypes",
        "lib = ctypes.CDLL('build/kernels/stats.so')"]),
    "REPRO203": ("repro_torch/kernels/ops.py", [
        "def _on_card(x):",
        "    return x.device.type == 'cuda'",
        "def bucket_stats(g):",
        "    return _k.stats(g) if _on_card(g) else ref.stats(g)",
        "def fancy_encode(g):",
        "    return ref.encode(g)"]),
    "REPRO204": ("repro_torch/core/helpers.py", [
        "import torch",
        "gen = torch.Generator().manual_seed(1234)"]),
}


@pytest.mark.parametrize("code", sorted(SNIPPETS))
def test_ast_rule_flags_its_snippet_and_allow_silences_it(code):
    rel, lines = SNIPPETS[code]
    src = "\n".join(lines)
    f = ast_lint.lint_source(src, rel)
    assert _codes(f) == [code], [str(x) for x in f]
    hit = int(f[0].where.rsplit(":", 1)[1])
    allowed = list(lines)
    allowed.insert(hit - 1, f"# repro: allow {code} (the test's own reason)")
    assert ast_lint.lint_source("\n".join(allowed), rel) == []


def test_ast_rules_scope_and_variants():
    # out of its scope the method dispatch and the loader are legal
    assert ast_lint.lint_source("\n".join(SNIPPETS["REPRO201"][1]),
                                "repro_torch/core/helpers.py") == []
    assert ast_lint.lint_source("\n".join(SNIPPETS["REPRO202"][1]),
                                "repro_torch/kernels/_build.py") == []
    # a fallback that hides a failed launch, and the other seeders and loaders
    fallback = ["def _on_card(x):", "    return True", "def orthogonalize(p):",
                "    try:", "        return _o.run(p) if _on_card(p) else ref.run(p)",
                "    except RuntimeError:", "        return ref.run(p)"]
    f = ast_lint.lint_source("\n".join(fallback), "repro_torch/kernels/ops.py")
    assert _codes(f) == ["REPRO203"] and "fall back" in f[0].message
    seeds = ["torch.manual_seed(0)", "torch.cuda.manual_seed(-3)", "k = prng.key(7)",
             "k = prng.key(seed)", "g.manual_seed(seed)"]
    f = ast_lint.lint_source("\n".join(seeds), "repro_torch/x.py")
    assert [x.where for x in f] == ["repro_torch/x.py:1", "repro_torch/x.py:2",
                                    "repro_torch/x.py:3"]
    loads = ["from torch.utils import cpp_extension", "cpp_extension.load(name='k')",
             "_build.bind('stats', 'fn', [])", "_build.build_all()"]
    f = ast_lint.lint_source("\n".join(loads), "repro_torch/analysis/x.py")
    assert [x.where for x in f] == ["repro_torch/analysis/x.py:2", "repro_torch/analysis/x.py:3"]
    assert _codes(ast_lint.lint_source("def f(:\n", "repro_torch/x.py")) == ["REPRO202"]


def test_ast_pass_port_tree_clean():
    findings, stats = ast_lint.run_pass()
    assert findings == [], [str(f) for f in findings]
    assert stats["files"] >= 70


# ---------------------------------------------------------------------------
# The sync pass (REPRO1xx): one spawn of four gloo ranks
# ---------------------------------------------------------------------------


def _seeded_cases(meshes, dev) -> dict:
    """label -> (fn, budget, compressed) of the seeded violations."""
    from repro_torch.core import prng
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.dist import compat
    from repro_torch.dist.train_step import TrainStepConfig, make_sync_fn

    mesh = meshes["flat"]
    grads = sync_lint._grads(dev)
    ts = TrainStepConfig(sync="faithful", bucket_mb=sync_lint._BUCKET_MB,
                         compressor=CompressorConfig(method="tqsgd", bits=3))
    sync = make_sync_fn(ts, mesh, grads)
    key = prng.key(3)

    def extra_collective():
        mean, _ = sync(grads, key)
        compat.psum(mean[0], mesh, "data")

    return {
        "seeded:extra_collective": (extra_collective, 1, True),
        "seeded:float64": (lambda: torch.ones(3, dtype=torch.float64, device=dev).sum(), 0,
                           True),
        "seeded:index_add": (lambda: torch.zeros(4, device=dev).index_add_(
            0, torch.tensor([0, 1, 1, 2], device=dev), torch.ones(4, device=dev)), 0, True),
        "seeded:int64_wire": (lambda: compat.all_gather_stacked(
            torch.zeros(4, dtype=torch.int64, device=dev), mesh, "data"), 1, True),
    }


def _lint_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    from repro_torch.dist import compat
    from repro_torch.dist import sharded_codec as sc

    dev = torch.device("cpu")
    report = {}
    try:
        meshes = {"flat": compat.Mesh((sync_lint.N_RANKS,)), "pods": compat.Mesh((2, 2))}
        syncs, refs = sync_lint.matrix(sync_lint.QUICK_METHODS, sync_lint.MODES, True)
        for method, mode in syncs:
            label, rec = sync_lint.sync_case(method, mode, meshes, dev)
            report[label] = sync_lint.gather_case(label, rec)
        for label, (fn, budget, compressed) in _seeded_cases(meshes, dev).items():
            rec = sync_lint.lint_run(fn, label, budget=budget, compressed=compressed)
            report[label] = sync_lint.gather_case(label, rec)
        # every rank's peer key the same step key: identical draws everywhere
        real = sc._peer_key
        sc._peer_key = lambda key, mesh, axis_name: key
        try:
            _, rec = sync_lint.sync_case("tqsgd", "faithful", meshes, dev)
        finally:
            sc._peer_key = real
        report["seeded:rank_independent_key"] = sync_lint.gather_case("seeded", rec)
        # launch.op_cost's spy on dist.compat: a real sync's collective bytes
        from repro_torch.launch.op_cost import OpCost

        fn, _, _ = _seeded_cases(meshes, dev)["seeded:extra_collective"]
        with OpCost() as oc:
            fn()
        report["op_cost"] = {"coll": oc.cost.coll, "count": oc.cost.coll_count,
                             "findings": []}
        if rank == 0:
            for method, mode in refs:
                label, rec = sync_lint.reference_case(method, mode, dev)
                del rec["draws"]
                report[label] = rec
        for rec in report.values():
            rec["findings"] = [f.to_json() for f in rec["findings"]]
    except Exception:  # report the failure to the test
        report = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def _entry(rank: int, world: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        _lint_rank(rank, world, init, out_dir)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def lint_report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync_lint")
    torch.multiprocessing.start_processes(
        _entry, args=(sync_lint.N_RANKS, f"file://{tmp}/rendezvous", str(tmp)),
        nprocs=sync_lint.N_RANKS, join=True, start_method="spawn")
    reports = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(sync_lint.N_RANKS)]
    for r in reports:
        assert "error" not in r, r.get("error")
    return reports[0]


def test_sync_pass_real_sync_and_replay_clean(lint_report):
    real = {k: v for k, v in lint_report.items() if k.startswith(("sync:", "reference:"))}
    assert len(real) == 24
    for label, rec in real.items():
        assert rec["findings"] == [], (label, rec["findings"])
        if label.startswith("reference:"):
            assert rec["collectives"] == {} and rec["budget"] == 0
        else:
            assert sum(rec["collectives"].values()) <= rec["budget"], (label, rec)
    # the budgets, met exactly by the quantizer codec
    assert real["sync:faithful/tqsgd"]["collectives"] == {"all_gather": 1}
    assert real["sync:two_phase/tqsgd"]["collectives"] == {"all_to_all": 1, "all_gather": 1}
    assert sum(real["sync:hierarchical/tqsgd"]["collectives"].values()) == 3
    assert real["sync:dsgd/tqsgd"]["collectives"] == {"psum": real["sync:dsgd/tqsgd"]["n_buckets"]}
    assert real["sync:faithful/tqsgd"]["n_buckets"] == 2
    assert all(rec["launches"] == {} for rec in real.values())   # the CPU runs plain versions


@pytest.mark.parametrize("label,code", [
    ("seeded:extra_collective", "REPRO101"), ("seeded:rank_independent_key", "REPRO102"),
    ("seeded:float64", "REPRO103"), ("seeded:index_add", "REPRO104"),
    ("seeded:int64_wire", "REPRO105")])
def test_sync_pass_flags_seeded_violation(lint_report, label, code):
    found = lint_report[label]["findings"]
    assert code in _codes(Finding(**f) for f in found), found
    assert {f["code"] for f in found} == {code}, found
    if code == "REPRO102":
        # anchored in the port (the draw's caller), where an allow comment would go
        assert all(f["where"].startswith("repro_torch/") for f in found), found
    if code == "REPRO101":
        assert lint_report[label]["collectives"] == {"all_gather": 1, "psum": 1}


def test_op_cost_counts_the_ring_bytes_of_a_real_collective(lint_report):
    """``launch.op_cost``'s spy on ``dist.compat``: the extra-collective
    case's fused all-gather (two tqsgd buckets at 3 bits over 4 ranks)
    moves (4 − 1)/4 of its stacked output, and its psum of the first mean
    leaf 2·(4 − 1)/4 of it."""
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.compressors import CompressorConfig

    cfg = CompressorConfig(method="tqsgd", bits=3)
    wire = 4 * sum(get_codec("tqsgd").wire_words(cfg, n) for n in sync_lint._LEAF_SIZES)
    got = lint_report["op_cost"]
    assert got["count"] == {"all-gather": 1, "all-reduce": 1}
    assert got["coll"] == {"all-gather": 4 * wire * 3 / 4,
                           "all-reduce": 4.0 * sync_lint._LEAF_SIZES[0] * 2 * 3 / 4}


# ---------------------------------------------------------------------------
# The kernels pass (REPRO3xx): the ptxas parser on a recorded report
# ---------------------------------------------------------------------------


def _recorded_reports() -> dict:
    reports, src = {}, None
    for line in REPORTS.read_text().splitlines():
        if line.startswith("#"):
            continue
        if line.startswith("== "):
            src = line[3:]
            reports[src] = ""
        else:
            reports[src] += line + "\n"
    return reports


def test_ptxas_parser_reads_the_recorded_build():
    table = kernel_resources.resource_table(_recorded_reports())
    assert len(table) == 105
    per = kernel_resources.per_kernel(table)
    assert list(per) == [f"K{i}" for i in range(1, 18)] and all(r["entries"] for r in per.values())
    assert per["K1"]["registers"] == 57 and per["K1"]["smem_bytes"] == 33336
    assert per["K11"]["entries"] == 9 and per["K12"]["entries"] == 2
    assert {(r.source, r.function) for r in table if r.ports is None} == {
        ("encode_fused", "serial_kernel"), ("decode", "serial_kernel")}
    enc = [r for r in table if r.source == "encode_fused" and r.function == "encode_kernel"]
    assert sorted({r.args[2] for r in enc}) == [1, 2, 3, 4, 5, 6, 7, 8]
    assert kernel_resources.check(table) == []
    assert kernel_resources.demangle(
        "_ZN48_GLOBAL__N__cfdfb181_15_encode_fused_cu_65b679f313encode_kernelILb1ELNS_3OutE2E"
        "Li3EEEvPKfxS3_S3_ixxPiPfS4_") == ("encode_kernel", (1, 2, 3))
    assert kernel_resources.demangle("_Z12stats_kernelILb0EEvPKf") == ("stats_kernel", (0,))


def test_ptxas_parser_flags_a_spilling_kernel():
    name = "_Z13decode_kernelILb0ELb1ELi3EEvPKixxPKfiixPf"
    text = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 240000 bytes smem, 400 bytes cmem[0]"])
    table = kernel_resources.parse_report("decode", text)
    assert len(table) == 1
    r = table[0]
    assert (r.ports, r.registers, r.smem_bytes, r.stack_bytes, r.spill_stores,
            r.spill_loads) == ("K4", 255, 240000, 24, 20, 16)
    f = kernel_resources.check(table)
    msgs = [x.message for x in f if x.where.startswith("csrc/")]
    assert msgs == ["K4: spill_stores 20 > 0", "K4: smem_bytes 240000 > 232448"]
    assert len(f) == 2 + 16                      # and the 16 other kernels have no entry
    ok = kernel_resources.check(table, {"K4": {"spill_stores": 20, "smem_bytes": 240000}})
    assert all(not x.where.startswith("csrc/") for x in ok)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_json_layout(tmp_path, capsys):
    out = tmp_path / "ANALYSIS.json"
    assert cli.main(["--pass", "ast", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep == {"version": 1, "passes": {"ast": rep["passes"]["ast"]}, "findings": [],
                   "clean": True}
    assert rep["passes"]["ast"]["files"] >= 70
    assert "clean" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--pass", "jaxpr"])
