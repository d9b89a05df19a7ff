"""The dry-run and roofline tables in markdown, as the reference's
``experiments/make_report.py`` prints them, from the port's own outputs:
the per-cell JSON files of ``python -m repro_torch.launch.dryrun --all
--out DIR`` and the list that ``python -m repro_torch.launch.roofline
--all --out FILE`` writes.

The roofline table has the reference's columns and format; its
collective seconds are the port's counts (``launch/roofline.py``): a
coordinate's gathers and, with tensor parallelism, its group's moves
(the sums; serving, the prefill's key/value exchange, the flash-decode
combine and the logits' blocks). The dry-run table's columns are the
port's: it has no XLA compile (``build_s`` in place of ``compile_s``),
reports the working set a device gathers, the matmul flops its body
counts and the members of a rank's tensor-parallel group that compute
("TP"; the flops are one member's, serving cells included), and its
``temp_bytes``, ``flops_per_device`` and ``bytes_per_device`` are
``null``; a null prints as "—", never as 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report --dryrun DIR \\
      --roofline FILE
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

NULL = "—"


def _gib(n: Optional[float]) -> str:
    return NULL if n is None else f"{n / 2 ** 30:.2f}"


def _sci(x: Optional[float]) -> str:
    return NULL if x is None else f"{x:.2e}"


def dryrun_table(directory: str) -> str:
    """The dry-run table of every ``*.json`` cell report in
    ``directory``."""
    rows = []
    for fn in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        mem = r["memory"]
        build = NULL if r.get("build_s") is None else f"{r['build_s']:.0f}s"
        rows.append(((r["arch"], r["shape"], r["mesh"]),
                     f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                     f"{r['kind']} | {build} | "
                     f"{_gib(mem['argument_bytes'])} | "
                     f"{_gib(mem['gathered_bytes'])} | "
                     f"{_gib(mem['temp_bytes'])} | "
                     f"{_sci(r['matmul_flops_per_device'])} | "
                     f"{r['tp_members']} | "
                     f"{_sci(r['flops_per_device'])} | "
                     f"{_sci(r['bytes_per_device'])} | "
                     f"{r['dropped_shardings']} | {r['fits']} |"))
    lines = ["| arch | shape | mesh | kind | build | args GiB/dev | "
             "gathered GiB/dev | temp GiB/dev | matmul flops/dev | TP | "
             "HLO flops/dev | HLO bytes/dev | dropped | fits |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    lines += [line for _, line in sorted(rows)]
    lines.append(f"\n{len(rows)} cells built on meta. temp, HLO flops and "
                 "HLO bytes are XLA's, which the port has no compiled "
                 f"program to give ({NULL}); see the roofline table for "
                 "the port's counts.")
    return "\n".join(lines)


def roofline_lines(reports: List[dict]) -> List[str]:
    lines = ["| arch | shape | compute s | memory s | collective s | bound | "
             "MODEL_FLOPS | useful | roofline frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(reports, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['model_flops']:.2e} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.1%} |")
    return lines


def roofline_table(path: str) -> str:
    """The roofline table of the report list in ``path``."""
    if not os.path.exists(path):
        return f"({path} not present yet)"
    with open(path) as f:
        return "\n".join(roofline_lines(json.load(f)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default=None,
                    help="dir of the dry run's per-cell JSON")
    ap.add_argument("--roofline", default=None,
                    help="the roofline's report list (JSON)")
    args = ap.parse_args(argv)
    if not (args.dryrun or args.roofline):
        ap.error("--dryrun DIR and/or --roofline FILE")
    if args.dryrun:
        print("## Dry-run table\n")
        print(dryrun_table(args.dryrun))
    if args.roofline:
        print("\n## Roofline table\n" if args.dryrun else
              "## Roofline table\n")
        print(roofline_table(args.roofline))


if __name__ == "__main__":
    main()
