"""Port vs reference: the ``Filter2D`` → ``CompiledFilter`` front door on
the CPU — every caller layout, banks, the public wrappers, the plan
accounting, batch admission, and the executor/device rules."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.filter2d import filter2d as r_filter2d
from repro.core.filter2d import filter_bank as r_filter_bank
from repro.core import filters as r_filters
from repro.core.border_spec import BorderSpec as RBorder
from repro.core.pipeline import Filter2D as RFilter2D
from repro.core.pipeline import admit_batch as r_admit
from repro.core.pipeline import split_batch as r_split
from repro.core.requant import RequantSpec as RRequant
from repro.kernels.filter2d import halo as r_halo
from repro_torch import obs
from repro_torch.convert import from_reference
from repro_torch.core.filter2d import filter2d as p_filter2d
from repro_torch.core.filter2d import filter_bank as p_filter_bank
from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.pipeline import (Filter2D, admit_batch, batched_shape,
                                       bucket_key, split_batch)
from repro_torch.core.requant import RequantSpec
from repro_torch.kernels.filter2d import (filter2d_cuda, filter2d_ref,
                                          filter_bank_cuda)

from _torch_parity import assert_match, coeffs, frame, to_jax, to_torch

LAYOUTS = [(18, 23), (18, 23, 3), (2, 18, 23, 2)]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("shape", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_layouts_and_banks(shape, n, dtype, rng):
    x = frame(rng, dtype, shape)
    k = coeffs(rng, dtype, (5, 5) if n == 1 else (n, 5, 5))
    rq = None
    if dtype == "int8":
        kk = k if n > 1 else k[None]
        kk[:, 2, 2] = 60
        rq = RRequant.unity_gain(k, "int8", rounding="nearest_even")
    rspec = RFilter2D(window=5, num_filters=n, dtype=dtype,
                      border=RBorder("mirror_dup"),
                      requant=rq.gain_free() if rq else None)
    xr = to_jax(x, dtype)
    ref = rspec.compile(xr, "core")(xr, k, gains=rq)
    spec, co, table = from_reference(
        dataclasses.asdict(rspec), k, dataclasses.asdict(rq) if rq else None)
    xt = to_torch(x, dtype)
    for execution in ("auto", "core", "cuda"):
        cf = spec.compile(xt, execution, device="cpu")
        got = cf(xt, co, gains=table)
        assert_match(got, ref, dtype, f"{execution} {shape} n={n}")
        assert got.device.type == "cpu"


@pytest.mark.parametrize("policy", ["mirror", "neglect", "constant"])
def test_public_wrappers(policy, rng):
    x = frame(rng, "float32", (20, 26))
    k = r_filters.log_filter(5)
    bank = coeffs(rng, "float32", (3, 5, 5))
    rb = RBorder(policy, 1.5)
    pb = BorderSpec(policy, 1.5)
    xr, xt = to_jax(x, "float32"), to_torch(x, "float32")
    ref = r_filter2d(xr, k, form="tree", border=rb)
    assert_match(p_filter2d(xt, k, form="tree", border=pb), ref,
                 "float32")
    assert_match(filter2d_cuda(xt, k, form="tree", border=pb), ref,
                 "float32")
    ref_b = r_filter_bank(xr, bank, border=rb)
    assert_match(p_filter_bank(xt, bank, border=pb), ref_b, "float32")
    assert_match(filter_bank_cuda(xt, bank, border=pb), ref_b, "float32")
    g = r_filters.gaussian(5)
    ref_s = r_filter2d(xr, g, border=rb, separable="auto")
    assert_match(filter2d_cuda(xt, g, border=pb, separable="auto"), ref_s,
                 "float32")
    assert_match(filter2d_ref(xt, k, policy, 1.5),
                 r_filter2d(xr, k, border=rb), "float32")


def test_public_wrappers_requant(rng):
    x = frame(rng, "uint8", (20, 26))
    k = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.int32)
    rq_r = RRequant.unity_gain(k, "uint8", rounding="truncate")
    rq_p = RequantSpec.unity_gain(k, "uint8", rounding="truncate")
    xr, xt = to_jax(x, "uint8"), to_torch(x, "uint8")
    ref = r_filter2d(xr, k, border=RBorder("wrap"), requant=rq_r)
    assert_match(p_filter2d(xt, k, border=BorderSpec("wrap"),
                                requant=rq_p), ref, "uint8")
    assert_match(filter2d_cuda(xt, k, border=BorderSpec("wrap"),
                               requant=rq_p), ref, "uint8")
    u, v = np.array([1, 2, 1], np.int32), np.array([1, 2, 1], np.int32)
    assert_match(filter2d_cuda(xt, k, border=BorderSpec("wrap"),
                               separable=(u, v), requant=rq_p), ref, "uint8")


@pytest.mark.parametrize("shape", [(96, 128), (64, 96, 3), (2, 600, 900, 1),
                                   (4, 1440, 1920, 1)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("n", [1, 4])
def test_plan_is_the_reference_plan(shape, dtype, n):
    """The cuda executor's plan is the plan the reference's Pallas kernel
    would run for the same spec and geometry (pixel-cache regime when the
    frame-resident working set fits the budget, else the derived stream
    geometry); core's is the reference core's accounting plan."""
    rq = (RRequant(rounding="nearest", dtype="int8")
          if dtype == "int8" else None)
    rspec = RFilter2D(window=5, num_filters=n, dtype=dtype,
                      requant=rq)
    spec, _, _ = from_reference(dataclasses.asdict(rspec),
                                np.zeros((n, 5, 5)))
    cf = spec.compile(shape, "cuda", device="cpu")
    regime = ("small" if cf.resident_vmem_bytes <= cf.vmem_budget
              else "stream")
    rcf = rspec.compile(shape, "pallas", regime=regime)
    assert cf.resident_vmem_bytes == rcf.resident_vmem_bytes
    assert dataclasses.asdict(cf.plan) == dataclasses.asdict(rcf.plan)
    assert (cf.strip_h, cf.tile_w) == (rcf.strip_h, rcf.tile_w)
    assert cf.hbm_bytes_per_pixel() == rcf.hbm_bytes_per_pixel()
    core = spec.compile(shape, "core", device="cpu")
    rcore = rspec.compile(shape, "core")
    assert dataclasses.asdict(core.plan) == dataclasses.asdict(rcore.plan)


def test_plan_errors_surface_at_compile():
    spec = Filter2D(window=5, border="neglect")
    with pytest.raises(ValueError):
        spec.compile((4, 30), "cuda", device="cpu")
    assert spec.compile((4, 30), "core", device="cpu").plan is None


@pytest.mark.parametrize("execution", ["core", "xla", "sharded", "cuda"])
@pytest.mark.parametrize("policy,w,shape", [
    ("mirror", 5, (16, 2)), ("mirror", 5, (2, 16)), ("mirror", 3, (1, 9)),
    ("mirror_dup", 5, (16, 1)), ("wrap", 5, (1, 16)),
    ("wrap", 7, (2, 8, 2, 3))])
def test_frames_below_min_extent_refused_at_compile(policy, w, shape,
                                                    execution):
    """Every executor that extends the frame refuses a frame below the
    policy's ``min_extent`` at compile time, where the reference's own
    planner (``halo.make_plan``) refuses it; the reference's jnp paths
    would return ``np.pad``'s values or NaN instead."""
    H, W = shape[1:3] if len(shape) == 4 else shape[:2]
    with pytest.raises(ValueError, match="at least"):
        r_halo.make_plan(H, W, w, RBorder(policy), H, W)
    kw = (dict(mesh=["cpu"]) if execution == "sharded"
          else dict(device="cpu"))
    with pytest.raises(ValueError, match="min_extent"):
        Filter2D(window=w, border=policy).compile(shape, execution, **kw)


def test_executor_and_spec_rules():
    spec = Filter2D(window=3)
    for name in ("sharded",):
        with pytest.raises(ValueError, match="needs a mesh"):
            spec.compile((8, 8), name, device="cpu")
    with pytest.raises(ValueError):
        spec.compile((8, 8), "pallas", device="cpu")
    assert spec.compile((8, 8), "auto", device="cpu").execution == "core"
    assert spec.compile((8, 8), device="cpu") is spec.compile(
        (8, 8), device="cpu")
    assert Filter2D(window=3, dtype=torch.bfloat16).dtype == "bfloat16"
    assert Filter2D(window=3, dtype=np.int16).dtype == "int16"
    for bad in (dict(dtype="int32"), dict(form="fft"), dict(window=0),
                dict(separable=True, num_filters=2)):
        with pytest.raises(ValueError):
            Filter2D(**{"window": 3, **bad})
    with pytest.raises(ValueError):
        spec.compile(torch.zeros(8, 8, dtype=torch.int8), device="cpu")
    with pytest.raises(ValueError):
        spec.compile((8,), device="cpu")


def test_operand_validation_and_variant_count(rng):
    spec = Filter2D(window=3)
    cf = spec.compile((10, 12), "cuda", device="cpu")
    x = torch.from_numpy(frame(rng, "float32", (10, 12)))
    assert cf.cache_size() == 0
    for _ in range(3):                    # coefficient swaps
        cf(x, coeffs(rng, "float32", (3, 3)))
    assert cf.cache_size() == 1
    with pytest.raises(ValueError):
        cf(x, np.ones((5, 5)))
    with pytest.raises(ValueError):
        cf(torch.zeros(10, 13), np.ones((3, 3)))
    with pytest.raises(ValueError):
        cf(x, np.ones((3, 3)), gains=(1, 0))
    rq = Filter2D(window=3, dtype="int8", requant=RequantSpec())
    cq = rq.compile((10, 12), "cuda", device="cpu")
    xi = torch.zeros(10, 12, dtype=torch.int8)
    with pytest.raises(ValueError):
        cq(xi, np.ones((3, 3), np.int32), gains=(1, 40))
    with pytest.raises(ValueError):
        cq(xi, np.ones((3, 3), np.int32),
           gains=RequantSpec(rounding="truncate"))


def test_admit_and_split_match_the_reference(rng):
    frames = [frame(rng, "float32", (6, 7)) for _ in range(3)]
    x = admit_batch(frames, 4)
    xr = r_admit(frames, 4)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xr))
    assert tuple(x.shape) == batched_shape((6, 7), 4)
    y = torch.arange(4 * 6 * 7 * 1 * 2).reshape(4, 6, 7, 1, 2)
    for a, b in zip(split_batch(y, 3, 2), r_split(y.numpy(), 3, 2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pinned = admit_batch([f[..., None] for f in frames], 3)
    assert tuple(pinned.shape) == (3, 6, 7, 1)
    with pytest.raises(ValueError):
        admit_batch(frames, 2)
    with pytest.raises(ValueError):
        admit_batch([frames[0], frames[1].astype(np.float64)], 4)
    with pytest.raises(ValueError):
        admit_batch([frames[0], frames[1][:5]], 4)
    with pytest.raises(ValueError):
        admit_batch([], 4)


def test_bucket_key_identity():
    spec = Filter2D(window=5)
    k = bucket_key(spec, (64, 96), batch=4, device="cpu")
    assert k == bucket_key(Filter2D(window=5), (64, 96), batch=4,
                           device="cpu")
    for other in (bucket_key(Filter2D(window=3), (64, 96), batch=4,
                             device="cpu"),
                  bucket_key(spec, (64, 97), batch=4, device="cpu"),
                  bucket_key(spec, (64, 96), batch=2, device="cpu"),
                  bucket_key(spec, (64, 96), batch=4, device="cuda"),
                  bucket_key(spec, (64, 96), batch=4, device="cpu",
                             execution="core")):
        assert other != k


def test_compile_and_execute_events(rng):
    spec = Filter2D(window=3, border="wrap", form="compress")
    with obs.tracing() as trace:
        obs.REGISTRY.reset()
        cf = spec.compile((9, 11), "auto", device="cpu")
        cf(torch.from_numpy(frame(rng, "float32", (9, 11))),
           np.ones((3, 3), np.float32))
        kinds = [type(e).__name__ for e in trace.events()]
        assert kinds == ["AutoSelectEvent", "CompileEvent", "ExecuteEvent"]
        assert obs.REGISTRY.counters()["pipeline.calls"] == 1
    obs.REGISTRY.reset()
