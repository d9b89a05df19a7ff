"""Port vs reference: the report tables (``launch/report.py``).

The reference's ``experiments/make_report.py`` imports no JAX; it is
loaded by path and its ``roofline_table`` run on the same report list as
the port's (its ``HERE`` pointed at a temporary directory that holds
``roofline.json``). Tolerance: none, the printed tables are equal line for
line. The dry-run table renders the port's own dry-run JSON, with "—" for
each null and never a 0 in its place.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun, report

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

REPORTS = [
    {"arch": "yi_6b", "shape": "train_4k", "compute_s": 3.45196123,
     "memory_s": 13.3711923, "collective_s": 0.96472, "dominant": "memory",
     "model_flops": 2.5e17, "useful_ratio": 0.6412, "roofline_fraction":
     0.01031},
    {"arch": "h2o_danube_1_8b", "shape": "decode_32k", "compute_s": 4.1e-5,
     "memory_s": 0.00763, "collective_s": 0.14555, "dominant": "collective",
     "model_flops": 1.2e12, "useful_ratio": 0.74, "roofline_fraction": 0.0},
    {"arch": "h2o_danube_1_8b", "shape": "train_4k", "compute_s": 1.1378,
     "memory_s": 9.2909, "collective_s": 0.29111, "dominant": "memory",
     "model_flops": 4.3e16, "useful_ratio": 0.58, "roofline_fraction":
     0.0045},
]


def _reference_module():
    spec = importlib.util.spec_from_file_location(
        "make_report", os.path.join(ROOT, "experiments", "make_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_report_imports_no_jax():
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('m', sys.argv[1])\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n")
    r = subprocess.run([sys.executable, "-c", code,
                        os.path.join(ROOT, "experiments", "make_report.py")],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("reports", [REPORTS, REPORTS[:1], []])
def test_roofline_table_equals_the_references(tmp_path, reports):
    ref = _reference_module()
    ref.HERE = str(tmp_path)
    path = tmp_path / "roofline.json"
    path.write_text(json.dumps(reports))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.roofline_table()
    assert report.roofline_table(str(path)) + "\n" == buf.getvalue()


def test_roofline_table_without_a_file(tmp_path):
    assert "not present yet" in report.roofline_table(
        str(tmp_path / "none.json"))


def test_dryrun_table_renders_nulls_as_dashes(tmp_path):
    from repro_torch.configs.base import SHAPES, RunConfig
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.sharding.mesh import make_mesh
    import dataclasses
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    for arch, shape in (("yi_6b", "train_4k"), ("hymba_1_5b", "decode_32k")):
        sh = SHAPES[shape]
        rc = RunConfig(model=tiny_of(arch), shape=dataclasses.replace(
            sh, seq_len=32, global_batch=min(8, sh.global_batch)))
        rep = dryrun.run_cell(arch, shape, False, rc=rc, mesh=mesh)
        (tmp_path / f"{arch}__{shape}.json").write_text(json.dumps(rep))
    table = report.dryrun_table(str(tmp_path))
    lines = table.splitlines()
    assert lines[0].startswith("| arch | shape | mesh | kind | build |")
    rows = [line for line in lines if line.startswith("| hymba") or
            line.startswith("| yi")]
    assert len(rows) == 2 and rows[0].startswith("| hymba_1_5b |")
    for row in rows:
        cells = [c.strip() for c in row.strip("|").split("|")]
        assert len(cells) == 14
        # temp bytes, HLO flops and HLO bytes are null: dashes, not zeros
        assert cells[7] == cells[10] == cells[11] == "—"
        assert cells[8] != "—" and float(cells[8]) > 0
        # the members of a rank's tensor-parallel group that compute: a
        # train cell's and, since the mesh serving path, a decode cell's
        assert cells[9] == "2"
        assert cells[12].isdigit() and cells[13] == "True"
    assert "2 cells built on meta" in table


def test_report_command(tmp_path):
    (tmp_path / "dr").mkdir()
    rep = {"arch": "yi_6b", "shape": "decode_32k", "mesh": "16x16",
           "kind": "decode", "build_s": None, "matmul_flops_per_device": 1e9,
           "tp_members": 1,
           "flops_per_device": None, "bytes_per_device": None,
           "memory": {"argument_bytes": 2 ** 30, "output_bytes": 0,
                      "gathered_bytes": None, "temp_bytes": None,
                      "generated_code_bytes": None},
           "dropped_shardings": 3, "fits": False}
    (tmp_path / "dr" / "a.json").write_text(json.dumps(rep))
    (tmp_path / "r.json").write_text(json.dumps(REPORTS))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                        "--dryrun", str(tmp_path / "dr"), "--roofline",
                        str(tmp_path / "r.json")], capture_output=True,
                       text=True, timeout=60, env=dict(os.environ,
                                                       PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert out.startswith("## Dry-run table\n")
    assert ("| yi_6b | decode_32k | 16x16 | decode | — | 1.00 | — | — | "
            "1.00e+09 | 1 | — | — | 3 | False |") in out
    assert "## Roofline table" in out
    assert out.rstrip().endswith(
        "| yi_6b | train_4k | 3.4520 | 13.3712 | 0.9647 | memory | "
        "2.50e+17 | 0.64 | 1.0% |")
