"""``python -m repro_torch.obs <command>`` — observability CLI.

Commands:
  report   render per-bucket metric tables + phase breakdown from JSONL
           event logs (see ``python -m repro_torch.obs report --help``)
"""
from __future__ import annotations

import sys

from . import report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "report":
        return report.main(rest)
    print(f"unknown command {cmd!r}; expected 'report'", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
