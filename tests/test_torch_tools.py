"""``tools/filter_ab.py`` on the CPU: the edited copy of the kernel source
and the refusal without a card (its timing runs on the card only)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.filter2d import _build

ROOT = Path(__file__).resolve().parents[1]
BOUNDS = "__launch_bounds__(NT, W == 0 ? 2 : 1)"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "filter_ab", ROOT / "tools" / "filter_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_edited_copy_replaces_the_text_once(tmp_path):
    ab = _tool()
    src = Path(_build.CSRC)
    dst = ab.edited_copy(src, tmp_path / "v", BOUNDS,
                         "__launch_bounds__(NT, 1)")
    ring = (dst / "filter2d_halo_ring.cuh").read_text()
    assert BOUNDS not in ring and "__launch_bounds__(NT, 1)" in ring
    assert ring == (src / "filter2d_halo_ring.cuh").read_text().replace(
        BOUNDS, "__launch_bounds__(NT, 1)")
    assert sorted(p.name for p in dst.iterdir()) == \
        sorted(p.name for p in src.iterdir())
    # a second copy over the first starts from the source again
    ab.edited_copy(src, tmp_path / "v", BOUNDS, BOUNDS)
    assert (dst / "filter2d_halo_ring.cuh").read_text() == \
        (src / "filter2d_halo_ring.cuh").read_text()


@pytest.mark.parametrize("old", ["no such text", "#include"])
def test_edited_copy_refuses_text_not_there_once(tmp_path, old):
    with pytest.raises(ValueError, match="times in"):
        _tool().edited_copy(Path(_build.CSRC), tmp_path / "v", old, "x")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_exits_2_without_a_card(capsys):
    assert _tool().main(["--tree", "x=/nonexistent"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_rows_name_each_datapath_once():
    rows = _tool().ROWS
    assert len({r[0] for r in rows}) == len(rows)
    assert {r[1] for r in rows} == {"float32", "bfloat16", "int8", "uint8",
                                    "int16"}
