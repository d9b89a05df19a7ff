"""The generic window's tree form as the CUDA kernel forms its sums
(``ring.cuh::tree_chunk`` / ``tree_fold``), modelled on the CPU by
``halo.tree_schedule_sum``: a window row's taps in chunks of 16, each
pixel's binary counter of partial sums settling its lowest levels at every
tap and carrying past them once a chunk, the level count a case of w*w's
range, the blocks left folded from the right. The model is held bit for
bit against the reference's pairwise tree (``repro.core.filter2d._tree``,
run eagerly) and against the port's plain version
(``kernel.py::_reduce_taps(form="tree")``, what the kernel is held to on
the card), at every odd window from 9 to 61 (float32's largest) and at
87 (bfloat16's largest), so that w*w crosses each power of two. The
products span six decades, so that another order of the same sums would
show: each case also checks that a left fold differs somewhere.

Then the twin's level cases against the kernel source, and the ring's
refusal against the one of a counter of 16 levels, which ran every
window the ring holds."""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d import kernel as K

# the module (``repro.core`` exports a function of the same name)
rcore = importlib.import_module("repro.core.filter2d")

RING_CUH = (Path(K.__file__).resolve().parent / "csrc"
            / "filter2d_halo_ring.cuh")
WINDOWS = tuple(range(9, 62, 2)) + (87,)
H, W = 3, 5                      # output pixels a case


def _inputs(w: int):
    """An extended frame [1, H + w - 1, W + w - 1] and [w, w]
    coefficients, float32, whose products span six decades."""
    rng = np.random.default_rng(1000 + w)
    xp = (rng.standard_normal((1, H + w - 1, W + w - 1))
          * 10.0 ** rng.integers(-3, 3, (1, H + w - 1, W + w - 1)))
    co = rng.standard_normal((w, w)) * 10.0 ** rng.integers(-3, 3, (w, w))
    return xp.astype(np.float32), co.astype(np.float32)


def _products(xp, co):
    """[w*w, H * W]: tap t = i * w + j of every output pixel, in float32."""
    w = co.shape[0]
    return np.stack([(xp[0, i:i + H, j:j + W] * co[i, j]).reshape(-1)
                     for i in range(w) for j in range(w)])


def _bits(a):
    return np.asarray(a, dtype=np.float32).reshape(-1).view(np.uint32)


@pytest.mark.parametrize("w", WINDOWS)
def test_kernel_schedule_equals_the_reference_tree(w):
    xp, co = _inputs(w)
    prods = _products(xp, co)
    got = halo.tree_schedule_sum(prods, w)
    want = np.asarray(rcore._tree(jnp.asarray(xp), jnp.asarray(co), H, W))
    assert np.array_equal(_bits(got), _bits(want))
    fold = prods[0].copy()
    for p in prods[1:]:
        fold = fold + p
    assert not np.array_equal(_bits(fold), _bits(got))


@pytest.mark.parametrize("w", WINDOWS)
def test_kernel_schedule_equals_the_plain_version(w):
    xp, co = _inputs(w)
    got = halo.tree_schedule_sum(_products(xp, co), w)
    want = K._reduce_taps(torch.from_numpy(xp), torch.from_numpy(co), H, W,
                          w, "tree")
    assert np.array_equal(_bits(got), _bits(want.numpy()))


def test_level_case_is_the_smallest_that_holds_the_taps():
    """Every odd window the float datapaths run past 7: the case the twin
    picks holds w*w and no smaller case does; both largest windows fit
    the counter; the twin's cases and carry level are the kernel's."""
    tops = [halo.max_ring_window(4, 4), halo.max_ring_window(2, 2)]
    assert tops == [61, 87]
    for w in range(9, max(tops) + 1, 2):
        levels = halo.tree_levels(w)
        assert levels in halo.TREE_LEVEL_CASES and w * w < 1 << levels
        assert all(w * w >= 1 << c for c in halo.TREE_LEVEL_CASES
                   if c < levels)
    assert halo.tree_levels(87) == 13 and halo.tree_levels(61) == 12
    assert halo.tree_levels(9) == halo.tree_levels(15) == 8
    with pytest.raises(ValueError):
        halo.tree_levels(91)
    src = RING_CUH.read_text()
    body = src[src.index("constexpr int tree_levels(int w) {"):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"w \* w < \(1 << (\w+)\) \? (\w+)", body)
    top = int(re.search(r"constexpr int TREE_LEVELS = (\d+);", src)[1])
    cases = [top if c == "TREE_LEVELS" else int(c) for c, _ in cases]
    assert tuple(cases) == halo.TREE_LEVEL_CASES
    assert halo.TREE_TAPS_LIMIT == 1 << top
    assert int(re.search(r"constexpr int TREE_LOW = (\d+);", src)[1]) \
        == halo.TREE_LOW
    assert int(re.search(r"constexpr int JC = (\d+);", src)[1]) \
        == halo.RING_CHUNK


def _old_refusal(geo, separable):
    """The refusal beside the counter of 16 levels the kernel had before:
    a TMA box past 256 a side, a block past its shared memory, w*w past
    2^16 for every datapath and form."""
    if geo.box_w > halo.TMA_BOX_LIMIT or geo.eh > halo.TMA_BOX_LIMIT:
        return "box"
    if halo.ring_smem_bytes(geo, 1, separable) > halo.SMEM_BLOCK_LIMIT:
        return "shared memory"
    if geo.w * geo.w >= 1 << 16:
        return "tree"
    return None


@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("s,so", [(4, 4), (2, 2), (1, 4), (1, 1), (1, 2),
                                  (2, 4), (2, 1)])
def test_refusal_refuses_nothing_the_old_counter_ran(s, so, separable):
    ran = 0
    for w in range(1, 261, 2):
        geo = halo.ring_geometry(s, so, w)
        if _old_refusal(geo, separable) is None:
            assert halo.ring_refusal(geo, separable) is None, w
            ran += 1
        else:
            assert halo.ring_refusal(geo, separable) is not None, w
    assert ran == (halo.max_ring_window(s, so, separable) + 1) // 2
