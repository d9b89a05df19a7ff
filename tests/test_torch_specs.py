"""Port vs reference: the pure-Python specs, the presets and the static
halo planning (``repro_torch.core.border_spec``/``requant``/``filters``,
``repro_torch.kernels.filter2d.halo``). These are copies, so the results
must be *equal*: same specs, same numbers, same plans."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import border_spec as r_bs
from repro.core import filters as r_filters
from repro.core import requant as r_rq
from repro.kernels.filter2d import halo as r_halo
from repro.kernels.filter2d import kernel as r_kernel
from repro_torch.core import border_spec as p_bs
from repro_torch.core import filters as p_filters
from repro_torch.core import requant as p_rq
from repro_torch.kernels.filter2d import halo as p_halo

DTYPES = ["float32", "int8", "uint8", "int16"]


@pytest.mark.parametrize("name", list(r_bs.POLICIES) + list(r_bs.ALIASES))
def test_border_spec_aliases(name):
    r, p = r_bs.BorderSpec(name, 2.5), p_bs.BorderSpec(name, 2.5)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert r.same_size == p.same_size
    assert r_bs.np_pad_mode(name) == p_bs.np_pad_mode(name)
    for radius in range(4):
        assert r_bs.min_extent(r, radius) == p_bs.min_extent(p, radius)
    assert r_bs.out_shape(13, 17, 5, r) == p_bs.out_shape(13, 17, 5, p)


def test_border_spec_rejects_unknown():
    with pytest.raises(ValueError):
        p_bs.BorderSpec("bogus")


@pytest.mark.parametrize("dtype", DTYPES + ["bfloat16"])
@pytest.mark.parametrize("c", [-300.0, -1.5, 0.0, 0.5, 2.5, 3.7, 255.0,
                               70000.0])
def test_quantize_constant(dtype, c):
    import jax.numpy as jnp
    ref = r_bs.quantize_constant(c, jnp.dtype(dtype))
    got = p_bs.quantize_constant(c, dtype)
    assert got == ref and type(got) is type(ref)
    assert p_bs.quantize_constant(c, getattr(torch, dtype)) == ref


@pytest.mark.parametrize("rounding", r_rq.ROUNDING_MODES)
@pytest.mark.parametrize("dtype", r_rq.STORAGE_DTYPES)
def test_requant_spec_params_and_unity_gain(rounding, dtype, rng):
    for m, s in [(3, 2), ((1, 2, 3), (0, 4, 31)), ((5,), (7,))]:
        r = r_rq.RequantSpec(m, s, rounding, dtype)
        p = p_rq.RequantSpec(m, s, rounding, dtype)
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
        assert r.params(3) == p.params(3)
        assert r.gain_free() == r_rq.RequantSpec(**dataclasses.asdict(
            p.gain_free()))
    bank = rng.integers(-4, 9, (3, 5, 5)).astype(np.int32)
    bank[:, 2, 2] += 40                   # non-zero sums
    for k in (bank, bank[0]):
        r = r_rq.RequantSpec.unity_gain(k, dtype, rounding=rounding)
        p = p_rq.RequantSpec.unity_gain(k, dtype, rounding=rounding)
        assert dataclasses.asdict(r) == dataclasses.asdict(p)


@pytest.mark.parametrize("rounding", r_rq.ROUNDING_MODES)
@pytest.mark.parametrize("dtype", r_rq.STORAGE_DTYPES)
def test_requantize_ref_and_round_shift(rounding, dtype, rng):
    acc = rng.integers(-2 ** 20, 2 ** 20, (7, 9)).astype(np.int32)
    acc.flat[:4] = [0, 1, -1, 2 ** 19]
    for m, s in [(1, 0), (3, 1), (-7, 5), (123, 11)]:
        r = r_rq.requantize_ref(acc, r_rq.RequantSpec(m, s, rounding, dtype))
        p = p_rq.requantize_ref(acc, p_rq.RequantSpec(m, s, rounding, dtype))
        np.testing.assert_array_equal(r, p)
        np.testing.assert_array_equal(
            r_rq.round_shift_ref(acc * m, s, rounding),
            p_rq.round_shift_ref(acc * m, s, rounding))


def test_requant_spec_validation():
    for bad in (dict(shift=32), dict(rounding="up"), dict(dtype="float32"),
                dict(multiplier=2 ** 31)):
        with pytest.raises(ValueError):
            p_rq.RequantSpec(**bad)


@pytest.mark.parametrize("name", sorted(r_filters.PRESETS))
@pytest.mark.parametrize("w", [3, 5, 7])
def test_presets(name, w):
    r = np.asarray(r_filters.preset(name, w))
    p = p_filters.preset(name, w).numpy()
    np.testing.assert_array_equal(r, p)


@pytest.mark.parametrize("name", ["gaussian", "box", "identity", "sobel_x",
                                  "laplacian", "sharpen", "motion_blur",
                                  "log"])
@pytest.mark.parametrize("w", [3, 5])
def test_decompose_separable(name, w):
    k = np.asarray(r_filters.preset(name, w))
    r = r_filters.decompose_separable(k)
    p = p_filters.decompose_separable(k)
    assert (r is None) == (p is None)
    if r is not None:
        np.testing.assert_array_equal(r[0], p[0])
        np.testing.assert_array_equal(r[1], p[1])


def test_coefficient_file_from_numpy_and_default_bank():
    rbank = r_filters.default_bank(7, 8)
    pbank = p_filters.default_bank(7, 8, device="cpu")
    np.testing.assert_array_equal(np.asarray(rbank.table),
                                  pbank.table.numpy())
    cf = p_filters.CoefficientFile.from_numpy(np.asarray(rbank.table),
                                              device="cpu")
    assert (cf.w_max, cf.num_slots) == (7, 8)
    np.testing.assert_array_equal(cf.as_bank().numpy(),
                                  np.asarray(rbank.table))
    rbank.write(2, r_filters.sobel_x())
    cf.write(2, p_filters.sobel_x())
    np.testing.assert_array_equal(cf.read(2).numpy(),
                                  np.asarray(rbank.read(2)))
    with pytest.raises(ValueError):
        p_filters.embed_window(torch.ones(5, 5), 3)


GEOMETRIES = [(13, 17, 3, 8, 128), (40, 70, 5, 16, 128), (64, 300, 7, 16, 256),
              (9, 9, 3, 9, 128), (128, 129, 5, 32, 128)]


@pytest.mark.parametrize("H,W,w,strip,tile", GEOMETRIES)
@pytest.mark.parametrize("policy", list(r_bs.POLICIES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_make_plan_and_bytes(H, W, w, strip, tile, policy, dtype):
    import jax.numpy as jnp
    rq = (dict(multiplier=3, shift=2, rounding="nearest", dtype="int8")
          if dtype != "float32" else None)
    rspec, pspec = r_bs.BorderSpec(policy, -3.6), p_bs.BorderSpec(policy, -3.6)
    r_rq_spec = r_rq.RequantSpec(**rq) if rq else None
    p_rq_spec = p_rq.RequantSpec(**rq) if rq else None
    r = r_halo.make_plan(H, W, w, rspec, strip, tile, dtype=jnp.dtype(dtype),
                         requant=r_rq_spec)
    p = p_halo.make_plan(H, W, w, pspec, strip, tile, dtype=dtype,
                         requant=p_rq_spec)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    for fn in ("read_amplification", "read_bytes_per_pixel",
               "hbm_write_bytes_per_pixel", "hbm_bytes_per_pixel"):
        assert getattr(r_halo, fn)(r) == getattr(p_halo, fn)(p), fn


def test_make_plan_rejects_small_frames():
    for policy, H in [("neglect", 4), ("mirror", 2)]:
        with pytest.raises(ValueError):
            r_halo.make_plan(H, 30, 5, r_bs.BorderSpec(policy), 8, 128)
        with pytest.raises(ValueError):
            p_halo.make_plan(H, 30, 5, p_bs.BorderSpec(policy), 8, 128)


@pytest.mark.parametrize("H,W", [(1080, 1920), (1440, 1920), (2160, 3840),
                                 (33, 150), (7, 7), (480, 640)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [3, 7])
def test_derive_strip_tile(H, W, dtype, w):
    import jax.numpy as jnp
    for budget in (8 * 2 ** 20, 2 ** 20, 256 * 2 ** 10):
        for kw in (dict(), dict(num_filters=4), dict(separable=True),
                   dict(same_size=False), dict(tile_w=256),
                   dict(strip_h=64), dict(overlap=False)):
            if kw.get("same_size") is False and min(H, W) <= w:
                continue
            r = r_halo.derive_strip_tile(H, W, w, dtype=jnp.dtype(dtype),
                                         vmem_budget=budget, **kw)
            p = p_halo.derive_strip_tile(H, W, w, dtype=dtype,
                                         vmem_budget=budget, **kw)
            assert r == p, (budget, kw)


@pytest.mark.parametrize("dtype", DTYPES + ["bfloat16"])
def test_datapath_byte_widths_and_working_set(dtype):
    import jax.numpy as jnp
    for rq in (None, "int8", "int16"):
        if rq and dtype in ("float32", "bfloat16"):
            continue
        r_spec = r_rq.RequantSpec(dtype=rq) if rq else None
        p_spec = p_rq.RequantSpec(dtype=rq) if rq else None
        assert (r_halo.datapath_byte_widths(jnp.dtype(dtype), r_spec)
                == p_halo.datapath_byte_widths(dtype, p_spec))
    args = (64, 256, 5, 2)
    for kw in (dict(), dict(separable=True), dict(num_filters=3,
                                                  out_banks=2, ext_banks=2)):
        assert (r_kernel.stream_vmem_working_set(*args, **kw)
                == p_halo.stream_vmem_working_set(*args, **kw))
