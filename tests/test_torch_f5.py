"""Every odd window and any bank (ROADMAP F5): the ring's Python geometry
twin, the compile-time refusal of windows the ring cannot hold, the rule
that cuts a bank into launches, and the kernel's plain version
(``filter2d_halo_ref``, what the CUDA kernel is held to bit for bit on the
card) at w 9, 11 and 13 against the reference's oracles on the same numpy
inputs: ``filter_bank`` / ``filter2d`` for the four forms,
``_filter2d_sep_impl`` for the separable form, ``filter2d_xla`` for the
library convolution and ``requantize_ref`` for the epilogue (ROADMAP R1:
the reference's own Pallas kernel does not run on this jax). The
reference's functions run eagerly (``jax.disable_jit``): jitting a w 13
tree per case would cost more than the case. Integers match bit for bit;
float32 within rtol=atol=3e-4 and bfloat16 within 3e-2 (the reference
accumulates bfloat16 at bfloat16, the port in float32), the tolerances of
the filter parity suites (``_torch_parity.TOL``)."""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core.border_spec import BorderSpec as RBorder
from repro.core.border_spec import quantize_constant as rquantize
from repro.core.requant import RequantSpec as RRequant
from repro.core.requant import requantize_ref
from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.pipeline import Filter2D
from repro_torch.core.requant import RequantSpec
from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d import kernel as K

from _torch_parity import (DTYPES, FORMS, POLICIES, assert_match,
                           border_constant, coeffs, frame, is_int, to_jax,
                           to_torch)

# the module (``repro.core`` exports a function of the same name)
rcore = importlib.import_module("repro.core.filter2d")

# (storage bytes, output bytes) of every datapath the kernel builds
WIDTHS = {("float32", None): (4, 4), ("bfloat16", None): (2, 2),
          ("int8", None): (1, 4), ("int8", "int8"): (1, 1),
          ("uint8", "uint8"): (1, 1), ("int16", None): (2, 4),
          ("int16", "int16"): (2, 2)}


# -- the geometry twin ------------------------------------------------------


@pytest.mark.parametrize("s,so,w,stage", [(4, 4, 5, 19584), (1, 1, 3, 10624)])
def test_twin_reproduces_the_stage_bytes_the_roadmap_states(s, so, w, stage):
    g = halo.ring_geometry(s, so, w)
    assert g.stage == stage
    assert g.as_dict()["stage_bytes"] == stage
    assert tuple(g.as_dict()) == K.GEOMETRY_KEYS


@pytest.mark.parametrize("widths", list(WIDTHS), ids=str)
def test_twin_meets_the_layout_rules_up_to_the_largest_window(widths):
    """``ring.cuh``'s static asserts for every odd window that fits: a box
    of at most 256 a side, LEAD >= r with the box origin on 16 bytes, the
    last thread's words inside the row, and windows up to 7 exactly as the
    instantiations lay them out (LEAD = 16 / s)."""
    s, so = WIDTHS[widths]
    top = halo.max_ring_window(s, so)
    assert top >= 15
    for w in range(1, top + 1, 2):
        g = halo.ring_geometry(s, so, w)
        assert g.box_w <= 256 and g.eh <= 256
        assert g.lead >= g.r and (g.lead * s) % 16 == 0
        assert g.pitch % 16 == 0 and g.box_w * s == g.pitch
        C = g.cols_per_thread
        D = g.lead - g.r
        last = ((D + C + 2 * g.r) * s + 3) // 4
        assert (halo.RING_TILE_W - C) * s + 4 * last <= g.pitch
        assert halo.RING_CONSUMERS % g.tx == 0 and (C * s) % g.g == 0
        if w <= 7:
            assert g.lead == 16 // s
        assert halo.ring_smem_bytes(g, 1) <= halo.SMEM_BLOCK_LIMIT
    assert halo.ring_refusal(halo.ring_geometry(s, so, top + 2)) is not None


@pytest.mark.parametrize("widths", list(WIDTHS), ids=str)
def test_twin_blocks_the_float32_generic_window_eight_by_two(widths):
    """A thread's outputs: 16 bytes of columns by 4 rows (2 at 16
    columns), but 8 x 2 for float32 windows past 7. The strip, pitch and
    stage are the same either way."""
    s, so = WIDTHS[widths]
    for w in (3, 7, 9, 13, 61):
        g = halo.ring_geometry(s, so, w)
        wide = w > 7 and (s, so) == (4, 4)
        C = 8 if wide else 16 // so
        ROWS = 2 if wide or C == 16 else 4
        assert (g.cols_per_thread, g.rows_per_thread) == (C, ROWS)
        assert g.tx == halo.RING_TILE_W // C
        assert g.strip_h == halo.RING_CONSUMERS // g.tx * ROWS
        assert g.g == min(C * s, 16)
    assert halo.ring_geometry(4, 4, 9).strip_h == \
        halo.ring_geometry(4, 4, 7).strip_h == 32


# -- the compile-time refusal -------------------------------------------------


@pytest.mark.parametrize("execution", ["cuda", "streaming", "sharded"])
@pytest.mark.parametrize("dtype,requant,top", [
    ("float32", None, 61), ("bfloat16", None, 87), ("int16", None, 101),
    ("int8", "int8", 129)])
def test_compile_refuses_a_window_the_ring_cannot_hold(execution, dtype,
                                                       requant, top):
    rq = RequantSpec(dtype=requant) if requant else None
    H = 8 * (top + 3)
    kw = dict(mesh=["cpu"]) if execution == "sharded" else dict(device="cpu")
    Filter2D(window=top, dtype=dtype, requant=rq).compile(
        (H, H), execution, **kw)
    with pytest.raises(ValueError) as e:
        Filter2D(window=top + 2, dtype=dtype, requant=rq).compile(
            (H, H), execution, **kw)
    msg = str(e.value)
    assert f"w={top + 2}" in msg and f"largest window it runs for them is " \
        f"{top}" in msg
    assert "shared memory" in msg or "TMA box" in msg
    # the plain executors run any window
    Filter2D(window=top + 2, dtype=dtype, requant=rq).compile(
        (H, H), "core", device="cpu")


# the largest window the ring runs per (storage, output) width, direct and
# separable; the generic path's coefficient file may not lower any of them
MAX_WINDOWS = {(4, 4): (61, 65), (2, 2): (87, 97), (1, 4): (129, 129),
               (1, 1): (129, 129), (1, 2): (129, 129), (2, 4): (101, 119),
               (2, 1): (87, 97)}


@pytest.mark.parametrize("widths", sorted(MAX_WINDOWS), ids=str)
def test_max_ring_window_holds_for_every_datapath(widths):
    s, so = widths
    assert halo.max_ring_window(s, so) >= MAX_WINDOWS[widths][0]
    assert halo.max_ring_window(s, so, True) >= MAX_WINDOWS[widths][1]


def _generic_file(bank: np.ndarray, separable: bool, packed: bool):
    """A numpy model of the generic path's coefficient file
    (``ring.cuh::stage_generic_coeffs``): the bank's rows padded to
    ``round_up(w, 4)`` int32 words, or packed four signed bytes a word in
    rows of ``round_up(w, 16)`` bytes, zero past w."""
    n, rows, w = bank.shape
    if not packed:
        out = np.zeros((n, rows, -(-w // 4) * 4), np.int64)
        out[..., :w] = bank
        return out.reshape(-1)
    out = np.zeros((n, rows, -(-w // 16) * 16), np.uint8)
    out[..., :w] = bank.astype(np.int8).view(np.uint8)
    return out.reshape(-1).view("<u4")


@pytest.mark.parametrize("w", [1, 3, 5, 7, 9, 13, 15, 17, 31, 33, 61, 129])
@pytest.mark.parametrize("separable", [False, True])
def test_coefficient_file_words_match_its_model(w, separable, rng):
    """``ring_coeff_words`` (the twin of ``ring.cuh::coeff_words``): the
    bank's layout for a window with its own instantiation, the padded rows
    of the generic path, and room for the packed bytes of its dp4a
    route."""
    rows = 2 if separable else w
    bank = rng.integers(-128, 128, (3, rows, w))
    words = halo.ring_coeff_words(w, separable)
    if w <= halo.RING_FIXED_MAX:
        assert words == rows * w
        return
    assert 3 * words == _generic_file(bank, separable, False).size
    assert words % 4 == 0                  # 16-byte rows
    packed = _generic_file(bank, separable, True)
    assert packed.size <= 3 * words
    # a packed word holds taps 4q .. 4q + 3 of its row, low byte first
    q = packed.reshape(3, rows, -1)
    for t in (0, w // 2, w - 1):
        got = (q[1, rows - 1, t // 4] >> (8 * (t % 4))) & 0xff
        assert np.int8(np.uint8(got)) == bank[1, rows - 1, t]


def test_a_bank_past_the_coefficient_file_is_cut_into_launches():
    """The wrapper's launches for banks past the file, on CPU tensors: the
    chunks of ``coeff_chunks``, each file within 24 KiB and each block
    within its shared memory."""
    for dtype, w, n, sep in (("float32", 13, 48, False),
                             ("int8", 15, 40, False),
                             ("bfloat16", 33, 9, False),
                             ("int16", 61, 2, False),
                             ("float32", 31, 120, True)):
        plan = halo.make_plan(40, 96, w, BorderSpec("mirror"), 40, 96,
                              dtype=dtype)
        x = torch.zeros((2, 40, 96), dtype=getattr(torch, dtype))
        fixed = dtype not in ("float32", "bfloat16")
        co = torch.zeros((n, 2, w) if sep else (n, w, w),
                         dtype=torch.int32 if fixed else torch.float32)
        form = "separable" if sep else "direct"
        out, launches = K.launch_args(x, co, plan, None, form, "thread")
        geo = halo.plan_ring_geometry(plan)
        chunks = halo.coeff_chunks(n, geo, sep)
        assert [(a, b) for a, b, _ in launches] == list(chunks)
        assert out.shape[1] == n and len(chunks) >= 2
        for a, b in chunks:
            file = (b - a) * halo.ring_coeff_words(w, sep) * halo.COEFF_BYTES
            assert file <= max(halo.COEFF_FILE_BYTES,
                               halo.ring_coeff_words(w, sep) * 4)
            assert halo.ring_smem_bytes(geo, b - a, sep) \
                <= halo.SMEM_BLOCK_LIMIT


def test_refusal_names_the_box_limit_where_it_binds():
    why = halo.ring_refusal(halo.ring_geometry(1, 1, 131))
    assert "TMA box" in why and "256" in why


# -- the bank's chunks --------------------------------------------------------


@pytest.mark.parametrize("n,w,sep,want", [
    (1, 5, False, ((0, 1),)),
    (48, 5, False, ((0, 48),)),                  # 48 x 25 x 4 B fit 24 KiB
    # the generic path's rows padded to 16 bytes: 13 x 16 x 4 B a filter
    (48, 13, False, ((0, 29), (29, 48))),
    (256, 13, False, tuple((n0, min(n0 + 29, 256))
                           for n0 in range(0, 256, 29))),
    (3, 61, False, ((0, 1), (1, 2), (2, 3))),    # one filter past 24 KiB
    (1, 13, True, ((0, 1),))])
def test_bank_chunks(n, w, sep, want):
    g = halo.ring_geometry(4, 4, w)
    chunks = halo.coeff_chunks(n, g, sep)
    assert chunks == want
    per = chunks[0][1] - chunks[0][0]
    assert halo.ring_smem_bytes(g, per, sep) <= halo.SMEM_BLOCK_LIMIT
    assert halo.smem_working_set(
        halo.make_plan(64, 300, w, BorderSpec("mirror"), 64, 300),
        num_filters=n, separable=sep) == halo.ring_smem_bytes(g, per, sep)


def test_check_operands_takes_any_odd_window_and_any_bank():
    plan = halo.make_plan(40, 50, 15, BorderSpec("mirror"), 40, 50)
    K.check_operands(torch.zeros(2, 40, 50), torch.zeros(300, 15, 15), plan,
                     None, "direct")
    with pytest.raises(ValueError, match="match the plan"):
        K.check_operands(torch.zeros(2, 40, 50), torch.zeros(3, 13, 13),
                         plan, None, "direct")


# -- the kernel's plain version at w 9, 11, 13 against the reference -------


def _planes(x_hwc: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(x_hwc, -1, 0))


def _ref_bank(xr, bank, form, border):
    """The reference's ``filter_bank`` ([H, W, M, N]) as [M, N, Ho, Wo]."""
    y = np.asarray(rcore.filter_bank(xr, bank, form=form, border=border))
    return np.moveaxis(y, (2, 3), (0, 1))


@pytest.mark.parametrize("form", FORMS + ("separable",))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [9, 11, 13])
def test_plain_version_at_large_windows_matches_the_reference(w, dtype, form,
                                                              rng):
    H, W, M = 29, 31, 2
    with jax.disable_jit():
        for policy in POLICIES:
            c = border_constant(dtype)
            x = frame(rng, dtype, (H, W, M))
            xr = to_jax(x, dtype)
            xt = to_torch(_planes(x), dtype)
            rb = RBorder(policy, c)
            plan = halo.make_plan(H, W, w, BorderSpec(policy, c), H, W,
                                  dtype=dtype)
            what = f"w{w} {dtype} {policy} {form}"
            if form == "separable":
                uv = coeffs(rng, dtype, (2, w))
                got = K.filter2d_halo_ref(xt, torch.from_numpy(uv)[None],
                                          plan, form="separable")
                qc = jax.numpy.asarray(rquantize(c, xr.dtype), xr.dtype)
                y = rcore._filter2d_sep_impl(
                    xr, to_jax(uv[0], "int32" if is_int(dtype) else dtype),
                    to_jax(uv[1], "int32" if is_int(dtype) else dtype),
                    border_policy=policy, border_constant=qc)
                ref = np.moveaxis(np.asarray(y), -1, 0)[:, None]
                assert_match(got, ref, dtype, what)
                continue
            bank = coeffs(rng, dtype, (2, w, w))
            co = torch.from_numpy(bank)
            got = K.filter2d_halo_ref(xt, co, plan, form=form)
            ref = _ref_bank(xr, bank, form, rb)
            assert_match(got, ref, dtype, what)
            if form == "direct" and not is_int(dtype):
                # the library convolution, filter by filter
                for f in range(2):
                    y = np.asarray(rcore.filter2d_xla(xr, bank[f],
                                                      border=rb))
                    assert_match(got[:, f], np.moveaxis(y, -1, 0), dtype,
                                 what + " xla")
            if is_int(dtype):
                # the fused epilogue against requantize_ref, per filter
                # multipliers within the epilogue's int32 headroom at w 13
                gains = (((37, 9), (29, 5)) if dtype == "int16"
                         else (((1 << 11) + 3, 9), ((1 << 12) - 5, 13)))
                rq = RRequant(multiplier=tuple(g[0] for g in gains),
                              shift=tuple(g[1] for g in gains),
                              rounding="nearest_even", dtype=dtype)
                qplan = halo.make_plan(
                    H, W, w, BorderSpec(policy, c), H, W, dtype=dtype,
                    requant=RequantSpec(rounding="nearest_even",
                                        dtype=dtype))
                q = torch.tensor(gains, dtype=torch.int32)
                gotq = K.filter2d_halo_ref(xt, co, qplan, q_params=q,
                                           form=form)
                for f in range(2):
                    want = requantize_ref(ref[:, f], rq, filter_index=f)
                    np.testing.assert_array_equal(gotq[:, f].numpy(), want,
                                                  err_msg=what + " requant")


@pytest.mark.parametrize("execution", ["cuda", "streaming", "sharded"])
def test_large_window_pipelines_on_the_cpu_match_core(execution, rng):
    """w 9 through the executors that run the kernel (its plain version
    on the CPU), against ``'core'``."""
    x = to_torch(frame(rng, "int16", (48, 40, 2)), "int16")
    k = torch.from_numpy(coeffs(rng, "int16", (9, 9)))
    spec = Filter2D(window=9, dtype="int16", border="mirror")
    kw = (dict(mesh=["cpu"] * 2) if execution == "sharded"
          else dict(device="cpu", strip_h=16) if execution == "streaming"
          else dict(device="cpu"))
    got = spec.compile(x.shape, execution, **kw)(x, k)
    want = spec.compile(x.shape, "core", device="cpu")(x, k)
    assert torch.equal(got, want)
