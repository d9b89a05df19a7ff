"""Time the mesh train step across source trees, on the card.

    python3 tools/spmd_ab.py --tree parent=DIR

Runs ``chip_smoke.py``'s phase 16 (a) published run
(``Smoke.spmd_full_width``: h2o-danube-1.8b as published, bf16 compute
on float32 master weights, [4, 2048], 3 steps of ``train_loop(mesh=)``
on (data 2, model 2) of four entries of the first card, beside the same
run on one device and, where the tree splits the products over 'model',
beside the same mesh without the split) from this checkout ("this") and
from each ``--tree
NAME=DIR`` (another checkout, for example the parent commit's from ``git
archive``), in turns (this, the trees, the trees again in reverse, this),
each in a process of its own that imports that tree's ``src/`` and
``chip_smoke.py``. Prints each run's readings as a line of JSON and, last,
every run's. Exits 1 where a run fails, 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import json, sys
tree = sys.argv[1]
sys.path[:0] = [tree + "/src", tree]
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from repro_torch.configs.base import get_model_config
from repro_torch.obs import roofline
part = roofline.PARTS[roofline.part_of(torch.cuda.get_device_name(0))]
smoke = chip_smoke.Smoke(torch, chip_smoke.card_line(), part)
out = smoke.spmd_full_width(get_model_config("h2o_danube_1_8b"))
print(json.dumps(out, default=repr), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of another checkout")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("spmd_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = [("this", ROOT)] + [
        (n, Path(d).resolve()) for n, d in (t.split("=", 1)
                                            for t in args.tree)]
    order = trees + trees[::-1]
    runs = []
    for name, tree in order:
        p = subprocess.run([sys.executable, "-c", RUN, str(tree)],
                           capture_output=True, text=True, cwd=tree)
        sys.stdout.write(p.stdout[-6000:])
        if p.returncode:
            print(f"spmd_ab: {name} failed:\n{p.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append({"tree": name, **rec})
        alone = rec.get("without_split")
        print(f"spmd_ab {name}: median step {rec['median_step_ms']!r} ms "
              f"(one device {rec['single_device_step_ms']!r}"
              + ("" if alone is None else
                 f"; without the split {alone['step_ms']!r}")
              + f"), peak {rec['peak_allocated_bytes']} B (one device "
              f"{rec['single_device_peak_bytes']} B"
              + ("" if alone is None else
                 f"; without the split {alone['peak_allocated_bytes']} B")
              + f"), coordinate flops {rec.get('coord_flops')!r}, "
              f"traffic {rec['traffic']!r}", flush=True)
    print(json.dumps(runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
