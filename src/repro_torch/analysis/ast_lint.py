"""Pass 2 (``REPRO2xx``): AST linter for the port's architectural rules —
the counterpart of ``repro.analysis.ast_lint``.

Rules (all honor the ``# repro: allow REPROxxx`` comment suppression):

- **REPRO201** — no method-string dispatch inside the collective bodies
  (``dist/sharded_codec.py``): comparing ``*.method`` against string
  literals (``==``, ``!=``, ``in``) brings back the branching the codec
  registry removed; collective code branches on the ``Codec`` interface.
- **REPRO202** — no kernel library loaded or launched outside
  ``kernels/``: ``ctypes.CDLL`` / ``LoadLibrary``,
  ``torch.utils.cpp_extension.load`` / ``load_inline``, and
  ``_build.library`` / ``bind`` / ``check`` belong to the kernel modules,
  whose wrappers count launches and check each launch's error code.
- **REPRO203** — every public function of ``kernels/ops.py`` dispatches
  through ``_on_card`` (directly or through a private helper of the
  module that does), and no function there catches an exception: a
  ``try`` around a dispatch is the fallback that hides a kernel that
  failed to build or launch, which the port forbids.
- **REPRO204** — no literal seed in library code: ``torch.manual_seed``,
  ``<generator>.manual_seed``, ``torch.cuda.manual_seed`` or
  ``prng.key`` with a constant argument.  A baked-in seed correlates
  whatever derives from it across callers; keys flow in from the caller
  (a dataset's or a demo's fixed stream carries an allow comment saying
  why the constant is sound).

The linter is plain ``ast``, so it runs anywhere, fast.
"""
from __future__ import annotations

import ast
import pathlib

from . import Finding, suppressed_codes

#: files whose bodies are collective wiring (REPRO201 scope)
COLLECTIVE_MODULES = ("dist/sharded_codec.py",)

#: directory whose modules may load and launch kernels (REPRO202)
KERNELS_DIR = "kernels/"

#: the kernel-wrapper module (REPRO203 scope)
OPS_MODULE = "kernels/ops.py"

#: the device dispatch every wrapper resolves (REPRO203)
DISPATCH = "_on_card"

_LOADERS = frozenset({"CDLL", "LoadLibrary", "load_inline"})
_BUILD_CALLS = frozenset({"library", "bind", "check"})


def _is_method_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "method"


def _is_str_const(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    return (isinstance(node, ast.Tuple | ast.List | ast.Set)
            and all(_is_str_const(e) for e in node.elts))


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` of an attribute chain of names, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _loads_kernel(call: ast.Call) -> str | None:
    """The kernel-loading or launching callee of ``call``, if it is one."""
    name = _dotted(call.func)
    last = name.rsplit(".", 1)[-1]
    if last in _LOADERS:
        return name
    if name.endswith("cpp_extension.load"):
        return name
    if last in _BUILD_CALLS and name.split(".")[-2:-1] == ["_build"]:
        return name
    return None


def _literal_seed(call: ast.Call) -> str | None:
    """The seeding callee of ``call`` when its seed is a constant."""
    name = _dotted(call.func)
    last = name.rsplit(".", 1)[-1] if name else getattr(call.func, "attr", "")
    seeded = last == "manual_seed" or (last == "key" and name.endswith("prng.key"))
    if not seeded or len(call.args) != 1 or call.keywords:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.UnaryOp) and isinstance(arg.op, ast.USub):
        arg = arg.operand
    if isinstance(arg, ast.Constant) and isinstance(arg.value, int):
        return name or last
    return None


def _reaches_dispatch(tree: ast.Module) -> set[str]:
    """Module-level functions that call ``_on_card``, directly or through
    other functions of the module."""
    calls: dict[str, set[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            calls[node.name] = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
    reach = {name for name, names in calls.items() if DISPATCH in names}
    grew = True
    while grew:
        grew = False
        for name, names in calls.items():
            if name not in reach and names & reach:
                reach.add(name)
                grew = True
    return reach


def _lint_tree(tree: ast.Module, relpath: str) -> list[tuple[str, int, str]]:
    """Raw (code, lineno, message) hits for one parsed module."""
    hits: list[tuple[str, int, str]] = []
    in_collective = any(relpath.endswith(m) for m in COLLECTIVE_MODULES)
    in_kernels = KERNELS_DIR in relpath
    in_ops = relpath.endswith(OPS_MODULE)

    if in_ops:
        reach = _reaches_dispatch(tree)
        for node in tree.body:
            if (isinstance(node, ast.FunctionDef) and not node.name.startswith("_")
                    and node.name not in reach):
                hits.append((
                    "REPRO203", node.lineno,
                    f"kernel wrapper {node.name}() never dispatches through {DISPATCH}(): "
                    "the tensor's device picks the kernel or its plain version"))

    for node in ast.walk(tree):
        # REPRO201: cfg.method == "..." / cfg.method in ("...",) dispatch
        if in_collective and isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            if any(_is_method_attr(s) for s in sides) and \
                    any(_is_str_const(s) for s in sides):
                hits.append((
                    "REPRO201", node.lineno,
                    "method-string comparison in a collective body; branch "
                    "on the Codec interface (get_codec(...).<attr>) instead"))

        # REPRO203: no exception caught around a dispatch in ops.py
        if in_ops and isinstance(node, ast.Try) and node.handlers:
            hits.append((
                "REPRO203", node.lineno,
                "try/except in a kernel wrapper: a kernel that fails to build or "
                "launch must raise, not fall back to its plain version"))

        if isinstance(node, ast.Call):
            # REPRO202: kernel libraries loaded or launched outside kernels/
            callee = None if in_kernels else _loads_kernel(node)
            if callee:
                hits.append((
                    "REPRO202", node.lineno,
                    f"{callee}() outside kernels/; load and launch kernels through "
                    "the kernels.ops wrappers (launch counts, error checks)"))
            # REPRO204: literal seeds
            seeder = _literal_seed(node)
            if seeder:
                hits.append((
                    "REPRO204", node.lineno,
                    f"{seeder} with a baked-in seed in library code; thread the key "
                    "or generator in from the caller"))
    return hits


def lint_source(source: str, relpath: str) -> list[Finding]:
    """Lint one module's source; ``relpath`` selects the scoped rules."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("REPRO202", f"{relpath}:{e.lineno or 0}",
                        f"unparseable module: {e.msg}")]
    lines = source.splitlines()
    out = []
    for code, lineno, message in _lint_tree(tree, relpath):
        if code in suppressed_codes(lines, lineno):
            continue
        out.append(Finding(code, f"{relpath}:{lineno}", message))
    return out


def lint_file(path: pathlib.Path, relpath: str | None = None) -> list[Finding]:
    """Lint one file.  ``relpath`` overrides the scope key (a test's
    snippet can stand in for e.g. ``repro_torch/kernels/ops.py``)."""
    rel = relpath if relpath is not None else str(path)
    return lint_source(path.read_text(), rel)


def run_pass(root: pathlib.Path | None = None):
    """Lint every module of the port's package (library code only: tests,
    examples and ``chip_smoke.py`` may seed and load at will)."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[1]  # src/repro_torch
    findings: list[Finding] = []
    files = sorted(root.rglob("*.py"))
    for path in files:
        findings += lint_file(path, str(path.relative_to(root.parent)))
    return findings, {"files": len(files)}
