"""Pass 3 (``REPRO3xx``): each CUDA kernel's registers, shared memory,
stack and spills — the counterpart of ``repro.analysis.vmem``.

A TPU kernel's limit is its VMEM footprint; a Hopper kernel's are the
registers a thread (at most 255), the shared memory a block (at most 227
KB, 232,448 bytes) and spills to local memory (none: a spill is a round
trip through the cache hierarchy in the kernel's inner loop).  ``nvcc
-Xptxas -v`` reports all of them for every compiled entry function, and
``kernels._build.build_all()`` returns those reports, one a source.
:func:`parse_report` reads one; :func:`resource_table` maps each entry to
the TPU kernel it ports (K1–K17, ROADMAP Queue 2) by its source, name and
template arguments.  ``REPRO301`` fires on a spill store, or on shared
memory or registers past the limits, unless a per-kernel :data:`BUDGETS`
entry allows it (its reason in ``PERF.md``).

The build needs ``nvcc``, so :func:`run_pass` runs on the card's machine;
the parser is plain text and runs anywhere.
"""
from __future__ import annotations

import dataclasses
import re

from . import Finding

MAX_REGISTERS = 255
MAX_SMEM_BYTES = 232_448          # 227 KB a block
MAX_SPILL_STORES = 0

#: per-kernel overrides ({"K11": {"spill_stores": 64}}), each explained in PERF.md
BUDGETS: dict[str, dict[str, int]] = {}

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")

#: (source, function) -> the template arguments' map to a TPU kernel
_PORTS = {
    ("stats", "stats_kernel"): lambda a: {1: "K1", 0: "K10"}[a[0]],
    # encode_kernel<UNIFORM, Out{WORDS, RESID, CODES}, BITS>
    ("encode_fused", "encode_kernel"): lambda a: {
        (0, 1): "K2", (1, 1): "K3", (0, 0): "K6", (1, 0): "K7", (1, 2): "K16",
        (0, 2): "K17"}[tuple(a[:2])],
    # decode_kernel<UNIFORM, REDUCE, BITS>
    ("decode", "decode_kernel"): lambda a: {
        (0, 1): "K4", (1, 1): "K5", (0, 0): "K8", (1, 0): "K9"}[tuple(a[:2])],
    ("orthogonalize", "gram_schmidt_regs"): lambda a: "K11",
    ("orthogonalize", "gram_schmidt_global"): lambda a: "K11",
    # encode_kernel<UNIFORM, CAP>, decode_kernel<UNIFORM>
    ("quantize", "encode_kernel"): lambda a: {1: "K12", 0: "K14"}[a[0]],
    ("quantize", "decode_kernel"): lambda a: {1: "K13", 0: "K15"}[a[0]],
    # the serial bodies K2-K9 ran before their redesign, kept to compare with
    ("encode_fused", "serial_kernel"): lambda a: None,
    ("decode", "serial_kernel"): lambda a: None,
}

KERNELS = tuple(f"K{i}" for i in range(1, 18))


@dataclasses.dataclass(frozen=True)
class KernelResources:
    """One compiled entry function's resources."""

    source: str              # csrc/<source>.cu
    entry: str               # the mangled name
    function: str
    args: tuple[int, ...]    # its template arguments
    ports: str | None        # K1-K17, or None for a serial body
    registers: int
    smem_bytes: int
    stack_bytes: int
    spill_stores: int
    spill_loads: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self) | {"args": list(self.args)}


def demangle(entry: str) -> tuple[str, tuple[int, ...]]:
    """(function name, integer template arguments) of an Itanium-mangled
    kernel name: the last source name of its (possibly nested) name and
    the values of its literal template arguments (bools, ints, enums)."""
    s, i = entry, 2                       # past "_Z"
    name, args = "", []

    def source_name(i):
        m = re.match(r"\d+", s[i:])
        n = int(m.group())
        j = i + len(m.group())
        return s[j:j + n], j + n

    nested = s[i:i + 1] == "N"
    i += nested
    while i < len(s) and s[i].isdigit():
        name, i = source_name(i)
        if s[i:i + 1] == "I":             # template arguments: L <type> <value> E ...
            i += 1
            while s[i:i + 1] == "L":
                i += 1
                if s[i] == "N":           # a nested type (an enum): to its E
                    i = s.index("E", i) + 1
                elif s[i].isdigit():
                    _, i = source_name(i)
                else:                     # a builtin type: b, i, j, l, x, ...
                    i += 1
                m = re.match(r"n?\d+", s[i:])
                args.append(int(m.group().replace("n", "-")))
                i += len(m.group()) + 1   # past the value and its E
            i += 1                        # past the arguments' E
        if not nested:
            break
    return name, tuple(args)


def parse_report(source: str, text: str) -> list[KernelResources]:
    """Every entry function of one ``-Xptxas -v`` report of ``source``."""
    out, entry, props_for, frame = [], None, None, {}
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = _PROPS.search(line)
        if m:
            props_for = m.group(1)
            continue
        m = _FRAME.search(line)
        if m and entry is not None and props_for == entry:
            frame[entry] = tuple(int(x) for x in m.groups())
            continue
        m = _USED.search(line)
        if m and entry is not None:
            smem = _SMEM.search(line)
            stack, stores, loads = frame.get(entry, (0, 0, 0))
            function, args = demangle(entry)
            port = _PORTS.get((source, function))
            out.append(KernelResources(
                source=source, entry=entry, function=function, args=args,
                ports=port(args) if port else None, registers=int(m.group(1)),
                smem_bytes=int(smem.group(1)) if smem else 0, stack_bytes=stack,
                spill_stores=stores, spill_loads=loads))
            entry = None
    return out


def resource_table(reports: dict[str, str]) -> list[KernelResources]:
    """Every entry of every source's report, in build order."""
    return [r for source, text in reports.items() for r in parse_report(source, text)]


def per_kernel(table: list[KernelResources]) -> dict[str, dict]:
    """K1–K17 -> the most any of its entries uses: registers, shared
    memory, stack, spill stores and loads, and the entries' count."""
    out = {}
    for k in KERNELS:
        rows = [r for r in table if r.ports == k]
        out[k] = {"entries": len(rows),
                  **{f: max((getattr(r, f) for r in rows), default=0)
                     for f in ("registers", "smem_bytes", "stack_bytes", "spill_stores",
                               "spill_loads")}}
    return out


def check(table: list[KernelResources], budgets: dict | None = None) -> list[Finding]:
    """REPRO301 over the table; a K1–K17 with no entry is a finding too
    (a stale mapping or a kernel that no longer builds)."""
    budgets = BUDGETS if budgets is None else budgets
    findings = []
    for r in table:
        lim = budgets.get(r.ports or r.function, {})
        where = f"csrc/{r.source}.cu:{r.function}{list(r.args) if r.args else ''}"
        for field, limit in (("spill_stores", MAX_SPILL_STORES), ("smem_bytes", MAX_SMEM_BYTES),
                             ("registers", MAX_REGISTERS)):
            if getattr(r, field) > lim.get(field, limit):
                findings.append(Finding("REPRO301", where,
                                        f"{r.ports or 'serial body'}: {field} "
                                        f"{getattr(r, field)} > {lim.get(field, limit)}"))
    counts = per_kernel(table)
    for k, row in counts.items():
        if not row["entries"]:
            findings.append(Finding("REPRO301", k, f"{k} has no compiled entry in the reports"))
    return findings


def run_pass(reports: dict[str, str] | None = None):
    """The build's reports (``kernels._build.build_all()``, which compiles
    what is not built yet: it needs ``nvcc``) -> (findings, table)."""
    if reports is None:
        from repro_torch.kernels import _build

        reports = _build.build_all()
    table = resource_table(reports)
    return check(table), table
