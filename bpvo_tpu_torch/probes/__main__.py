"""python -m bpvo_tpu_torch.probes [features|gather|band|kernel ...]
    [--device cuda|cpu] [--out build/<name>.json]

Runs the probe groups (all four by default) and prints one JSON object.
``--out`` also writes it to a file, which must lie under the checkout's
``build/`` directory.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from bpvo_tpu_torch.probes import GROUPS, run

BUILD = Path(__file__).resolve().parents[2] / "build"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bpvo_tpu_torch.probes")
    ap.add_argument("groups", nargs="*", metavar="group",
                    help=f"probe groups to run, of {list(GROUPS)} (default: "
                         f"all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.out is not None and not args.out.resolve().is_relative_to(
            BUILD.resolve()):
        ap.error(f"--out must lie under {BUILD}")
    report = run(tuple(args.groups) or tuple(GROUPS), args.device)
    text = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
