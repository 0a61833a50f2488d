"""Umbrella CLI: ``python -m annotatedvdb_tpu_torch <command> [flags]``.

Port of ``annotatedvdb_tpu/__main__.py`` for the commands ported so far;
each delegates to its module's ``main(argv)``.
"""

from __future__ import annotations

import sys

COMMANDS = {
    "load-vcf": ("annotatedvdb_tpu_torch.cli.load_vcf",
                 "load a VCF into the store (on the card by default)"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m annotatedvdb_tpu_torch <command> [flags]\n")
        width = max(len(c) for c in COMMANDS)
        for cmd, (_, desc) in COMMANDS.items():
            print(f"  {cmd:<{width}}  {desc}")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    entry = COMMANDS.get(cmd)
    if entry is None:
        print(f"unknown command {cmd!r}; run with --help for the list",
              file=sys.stderr)
        return 2
    import importlib

    return importlib.import_module(entry[0]).main(rest) or 0


if __name__ == "__main__":
    raise SystemExit(main())
