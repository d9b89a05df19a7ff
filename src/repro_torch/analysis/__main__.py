"""``python -m repro_torch.analysis`` — the kernel-verify sweep CLI, the
reference's (``src/repro/analysis/__main__.py``) on the port. It runs on
the CPU: the schedule model needs no card.

Exit codes (pinned in ``tests/test_torch_analysis.py``):

    0  every selected configuration scheduled and analyzed clean
    1  at least one finding (an invariant violation in a shipped config)
    2  at least one error (the verifier itself could not analyze a
       config — treated as worse than a finding)
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.analysis.passes import PASSES
from repro_torch.analysis.verify import EXECUTORS, SWEEP_DTYPES, sweep
from repro_torch.core.border_spec import POLICIES


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Kernel verifier: sweep the shipped executor x dtype x "
                    "border matrix (the cuda lanes at one block and at the "
                    "ring's own grid, under both loaders) and report "
                    "invariant violations.")
    p.add_argument("--sweep", action="store_true",
                   help="run the full shipped matrix (default when no "
                        "filter narrows it; this flag just states intent)")
    p.add_argument("--executor", action="append",
                   choices=EXECUTORS + ("pallas",),
                   help="restrict to an executor (repeatable; 'pallas', "
                        "the reference's name, is 'cuda')")
    p.add_argument("--dtype", action="append", choices=SWEEP_DTYPES,
                   help="restrict to a storage dtype (repeatable)")
    p.add_argument("--border", action="append", choices=POLICIES,
                   help="restrict to a border policy (repeatable)")
    p.add_argument("--jsonl", metavar="PATH",
                   help="append one obs-convention record per report / "
                        "finding to PATH")
    p.add_argument("--list-passes", action="store_true",
                   help="print the pass catalogue and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="only print non-clean reports and the summary")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.list_passes:
        for name, desc in PASSES.items():
            print(f"{name:12s} {desc}")
        return 0

    records = []

    def progress(key, report):
        if not (args.quiet and report.clean):
            print(report.render(), flush=True)
        if args.jsonl:
            records.extend(report.to_records())

    t0 = time.perf_counter()
    reports = sweep(executors=args.executor, dtypes=args.dtype,
                    borders=args.border, progress=progress)
    dt = time.perf_counter() - t0

    if args.jsonl:
        with open(args.jsonl, "w") as fh:
            for i, rec in enumerate(records):
                rec["seq"] = i + 1
                fh.write(json.dumps(rec) + "\n")

    errors = [r for r in reports.values() if r.error is not None]
    findings = [f for r in reports.values() for f in r.findings]
    clean = sum(1 for r in reports.values() if r.clean)
    print(f"\nverified {len(reports)} configs in {dt:.1f}s: "
          f"{clean} clean, {len(findings)} finding(s), "
          f"{len(errors)} trace error(s)")
    if errors:
        return 2
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
