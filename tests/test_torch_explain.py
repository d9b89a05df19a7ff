"""Port vs reference: ``CompiledFilter.explain()`` and the accounting under
it (``macs_per_pixel`` and kin, ``plan_banks``, ``plan_vmem_working_set``),
the roofline in the H100's constants, and the ``torch.profiler`` hooks
(``annotate``, ``profile_dump``) behind the obs switch."""
import dataclasses
import glob
import importlib
import json
import os

import numpy as np
import pytest
import torch

from repro.core.border_spec import BorderSpec as RBorder
from repro.core.pipeline import Filter2D as RFilter2D
from repro.core.requant import RequantSpec as RRequant
from repro.kernels.filter2d import halo as r_halo
from repro.kernels.filter2d import kernel as r_kernel
from repro_torch import obs
from repro_torch.convert import from_reference
from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.pipeline import Filter2D
from repro_torch.kernels.filter2d import halo
from repro_torch.obs import roofline

# the modules (each package re-exports a *function* named filter2d)
R_F2D = importlib.import_module("repro.core.filter2d")
P_F2D = importlib.import_module("repro_torch.core.filter2d")

EXACT = ("spec", "frame", "geometry", "vmem", "hbm")
# (port executor, reference executor)
PAIRS = (("core", "core"), ("streaming", "streaming"), ("xla", "xla"),
         ("cuda", "pallas"))
SPECS = {
    "f32w5": dict(window=5),
    "f32w3dup": dict(window=3, border=("duplicate", 0.0)),
    "i8w3rq": dict(window=3, dtype="int8", border=("constant", 300.0),
                   requant=dict(rounding="nearest_even", dtype="int8")),
    "i16w5": dict(window=5, dtype="int16", form="tree",
                  border=("wrap", 0.0)),
    "bf16w7": dict(window=7, dtype="bfloat16", form="compress"),
    "u8bank": dict(window=5, dtype="uint8", num_filters=3),
    "f32sep": dict(window=5, separable=True),
    "f32neglect": dict(window=5, border=("neglect", 0.0)),
}


def _specs(name):
    kw = dict(SPECS[name])
    b = kw.pop("border", None)
    rq = kw.pop("requant", None)
    rspec = RFilter2D(**kw, border=RBorder(*b) if b else RBorder("mirror"),
                      requant=RRequant(**rq) if rq else None)
    spec, _, _ = from_reference(dataclasses.asdict(rspec), np.zeros(1))
    return rspec, spec


def _pair(rspec, spec, shape, pexe, rexe):
    try:
        cf = spec.compile(shape, pexe, device="cpu")
    except ValueError:
        with pytest.raises((ValueError, AssertionError)):
            rcf = rspec.compile(shape, rexe)
            if rexe == "streaming":          # the reference refuses at call
                assert rcf.strip_h >= spec.window - 1
                assert shape[-3 if len(shape) == 4 else 0] % rcf.strip_h == 0
                assert spec.border.policy != "neglect"
        return None, None
    kw = {}
    if rexe == "pallas":
        kw["regime"] = cf.regime
    return cf, rspec.compile(shape, rexe, **kw)


@pytest.mark.parametrize("pexe,rexe", PAIRS)
@pytest.mark.parametrize("shape", [(96, 128), (4, 1440, 1920, 1),
                                   (2, 60, 90, 3), (1, 4320, 7680, 1)])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_explain_accounting_equals_the_reference(name, shape, pexe, rexe):
    """spec, frame, geometry, vmem and hbm sections, flops and bytes per
    pixel: equal to the reference's, for core/streaming/xla and for cuda
    against pallas."""
    rspec, spec = _specs(name)
    cf, rcf = _pair(rspec, spec, shape, pexe, rexe)
    if cf is None:
        return
    d, rd = cf.explain(as_dict=True), rcf.explain(as_dict=True)
    for key in EXACT:
        assert d[key] == rd[key], (key, d[key], rd[key])
    for key in ("flops_per_pixel", "bytes_per_pixel"):
        assert d["roofline"][key] == rd["roofline"][key], key
    assert d["execution"]["executor"] == pexe
    assert set(d["execution"]) == {"executor", "regime", "rule", "why"}
    assert d["verify"] is None
    assert cf.vmem_working_set() == rcf.vmem_working_set()
    assert cf.hbm_bytes_per_pixel() == rcf.hbm_bytes_per_pixel()
    assert cf._plan_banks() == rcf._plan_banks()


def test_explain_dict_agrees_with_accounting_exactly():
    """``test_obs.py::test_explain_dict_agrees_with_accounting_exactly``."""
    cf = Filter2D(window=5).compile((4, 1440, 1920, 1), "cuda", device="cpu")
    d = cf.explain(as_dict=True)
    assert d["vmem"]["working_set_bytes"] == cf.vmem_working_set()
    assert d["vmem"]["budget_bytes"] == cf.vmem_budget
    assert d["vmem"]["resident_estimate_bytes"] == cf.resident_vmem_bytes
    assert d["hbm"]["bytes_per_pixel"] == cf.hbm_bytes_per_pixel()
    assert d["hbm"]["read_bytes_per_pixel"] == \
        halo.read_bytes_per_pixel(cf.plan)
    assert d["hbm"]["write_bytes_per_pixel"] == \
        halo.hbm_write_bytes_per_pixel(cf.plan)
    assert d["hbm"]["read_amplification"] == halo.read_amplification(cf.plan)
    assert d["geometry"]["strips"] == cf.plan.rows.n
    assert d["geometry"]["tiles"] == cf.plan.cols.n
    assert (d["geometry"]["ext_banks"], d["geometry"]["out_banks"]) == \
        halo.plan_banks(cf.plan)
    assert d["execution"]["executor"] == cf.execution
    assert d["execution"]["rule"] == cf.selection[0]


@pytest.mark.parametrize("dtype,peak", [("float32", 67e12),
                                        ("bfloat16", 989e12),
                                        ("int8", 33.5e12),
                                        ("uint8", 33.5e12),
                                        ("int16", 33.5e12)])
def test_explain_roofline_in_h100_constants(dtype, peak):
    """``test_obs.py::test_explain_roofline_from_shared_constants``, in the
    SXM5 part's constants on the CPU."""
    cf = Filter2D(window=5, dtype=dtype).compile((96, 128), "cuda",
                                                 device="cpu")
    roof = cf.explain(as_dict=True)["roofline"]
    bpp = cf.hbm_bytes_per_pixel()
    assert roof["flops_per_pixel"] == 2.0 * 5 * 5
    assert roof["part"] == "H100 SXM5"
    assert roof["peak_flops"] == peak == roofline.PEAK_OPS_PER_S[dtype]
    assert roof["hbm_bw"] == 3.35e12 == roofline.HBM_BW
    expect = min(peak / 50.0, 3.35e12 / bpp)
    assert roof["predicted_pixels_per_s"] == pytest.approx(expect)
    assert roof["bound"] == ("compute" if peak / 50.0 < 3.35e12 / bpp
                             else "memory")
    text = cf.explain()
    assert "H100 SXM5" in text
    for tpu in ("1.97e+14", "8.19e+11", "5e+10"):
        assert tpu not in text


def test_roofline_constants_and_formula():
    assert {k: (p.hbm_bw, p.peak_ops["float32"], p.peak_ops["bfloat16"])
            for k, p in roofline.PARTS.items()} == {
        "sxm5": (3.35e12, 67e12, 989e12), "pcie": (2.0e12, 51e12, 756e12),
        "nvl": (3.9e12, 60e12, 835e12)}
    for p in roofline.PARTS.values():     # int32 MAC: half the FP32 lanes
        assert p.peak_ops["int8"] == p.peak_ops["int16"] == \
            p.peak_ops["float32"] / 2
    assert roofline.part_of("NVIDIA H100 80GB HBM3") == "sxm5"
    assert roofline.part_of("NVIDIA H100 PCIe") == "pcie"
    assert roofline.part_of("NVIDIA H100 NVL") == "nvl"
    assert roofline.part_of(None) == "sxm5"
    r = roofline.predicted_pixel_rate(50.0, 8.0)
    assert r["memory_bound_pixels_per_s"] == 3.35e12 / 8.0
    assert r["compute_bound_pixels_per_s"] == 67e12 / 50.0
    assert r["bound"] == "memory" and r["predicted_pixels_per_s"] == \
        3.35e12 / 8.0
    r = roofline.predicted_pixel_rate(2000.0, 2.0, peak_flops=33.5e12,
                                      hbm_bw=2.0e12)
    assert r["bound"] == "compute" and r["predicted_pixels_per_s"] == \
        33.5e12 / 2000.0
    r = roofline.predicted_pixel_rate(0, None)
    assert r["predicted_pixels_per_s"] == float("inf")
    assert r["bytes_per_pixel"] is None
    for value in (roofline.PEAK_FLOPS, roofline.HBM_BW,
                  *roofline.PEAK_OPS_PER_S.values()):
        assert value not in (197e12, 819e9, 50e9)      # the TPU's


def test_explain_text_report_and_repr():
    """``test_obs.py::test_explain_text_report_and_repr``."""
    cf = Filter2D(window=5).compile((4, 1440, 1920, 1), "cuda", device="cpu")
    text = cf.explain()
    assert "executor  cuda" in text
    assert "strips" in text and "tiles" in text
    assert "vmem" in text and "roofline" in text
    assert cf.selection[1].split("->")[0].strip()[:20] in text
    r = repr(cf)
    assert "execution='cuda'" in r
    assert "banks ext=" in r and "out=" in r
    assert f"{cf.plan.rows.n}x{cf.plan.cols.n} grid" in r
    s = Filter2D(window=5).compile((1, 4320, 7680, 1), "streaming",
                                   device="cpu")
    assert "strip_h=60" in repr(s) and "72 strips" in s.explain()
    assert "executor  xla" in Filter2D(window=5).compile(
        (96, 128), "xla", device="cpu").explain()


def test_explain_without_plan():
    """``test_obs.py::test_explain_without_plan``: a frame below the
    policy's minimum extent leaves core without a plan; the report still
    renders."""
    cf = Filter2D(window=5, border="neglect").compile((4, 30), "core",
                                                      device="cpu")
    assert cf.plan is None
    d = cf.explain(as_dict=True)
    assert d["execution"]["executor"] == "core"
    assert d["geometry"] is None and d["hbm"] is None
    assert d["vmem"]["working_set_bytes"] is None
    assert d["roofline"]["bytes_per_pixel"] is None
    assert isinstance(cf.explain(), str)
    core = Filter2D(window=5).compile((48, 160), "core", device="cpu")
    assert core.explain(as_dict=True)["execution"]["executor"] == "core"


@pytest.mark.parametrize("w", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("form", ["direct", "transposed", "tree",
                                  "compress"])
def test_accounting_functions_equal_the_reference(form, w):
    for sep in (False, True):
        assert P_F2D.macs_per_pixel(w, form, sep) == \
            R_F2D.macs_per_pixel(w, form, sep)
        assert P_F2D.startup_latency_rows(w, form, sep) == \
            R_F2D.startup_latency_rows(w, form, sep)
    assert P_F2D.reduction_depth(w, form) == R_F2D.reduction_depth(w, form)
    for db in (1, 2, 4):
        for extra in (0, 1, 3):
            assert P_F2D.hbm_bytes_per_pixel(db, extra) == \
                R_F2D.hbm_bytes_per_pixel(db, extra)
    with pytest.raises(ValueError):
        P_F2D.reduction_depth(w, "fft")


@pytest.mark.parametrize("w", [1, 3, 5, 7, 9, 15])
def test_flops_and_intensity_equal_the_reference(w):
    """``core/filters.py::flops_per_pixel`` / ``arithmetic_intensity``."""
    from repro.core import filters as r_filters
    from repro_torch.core import filters as p_filters
    assert p_filters.flops_per_pixel(w) == r_filters.flops_per_pixel(w)
    for bpp in (1, 2, 8):
        assert p_filters.arithmetic_intensity(w, bpp) == \
            r_filters.arithmetic_intensity(w, bpp)
    assert p_filters.arithmetic_intensity(w) == \
        r_filters.arithmetic_intensity(w)


@pytest.mark.parametrize("policy", ["mirror", "neglect", "wrap"])
@pytest.mark.parametrize("dtype,rq", [("float32", None), ("int8", "int8"),
                                      ("int16", None)])
@pytest.mark.parametrize("H,W,S,T", [(96, 128, 96, 128), (2160, 3840, 128,
                                                           512),
                                     (1440, 1920, 256, 1920), (67, 301, 8,
                                                               128)])
def test_plan_banks_and_working_set_equal_the_reference(policy, dtype, rq,
                                                        H, W, S, T):
    rrq = None if rq is None else RRequant(dtype=rq)
    prq = None if rq is None else from_reference(
        dataclasses.asdict(RFilter2D(window=5, dtype=dtype, requant=rrq)),
        np.zeros(1))[0].requant
    rplan = r_halo.make_plan(H, W, 5, RBorder(policy), S, T,
                             dtype=np.dtype(dtype), requant=rrq)
    plan = halo.make_plan(H, W, 5, BorderSpec(policy), S, T, dtype=dtype,
                          requant=prq)
    for n in (1, 3):
        for overlap in (True, False):
            assert halo.plan_banks(plan, n, overlap) == \
                r_kernel.plan_banks(rplan, n, overlap)
            for sep in (False, True):
                assert halo.plan_vmem_working_set(
                    plan, num_filters=n, separable=sep, overlap=overlap) == \
                    r_kernel.plan_vmem_working_set(
                        rplan, num_filters=n, separable=sep, overlap=overlap)


# -- the profiler hooks -------------------------------------------------------


def test_annotate_is_a_no_op_when_obs_is_off():
    obs.disable()
    ctx = obs.annotate("x")
    assert type(ctx).__name__ == "nullcontext"
    with ctx:
        pass


def test_annotate_and_profile_dump_ranges(tmp_path, rng):
    with obs.profile_dump(None):              # no-op without a directory
        pass
    assert not os.listdir(tmp_path)
    x = torch.from_numpy(rng.standard_normal((24, 30)).astype(np.float32))
    k = np.ones((3, 3), np.float32)
    with obs.tracing():
        with obs.profile_dump(str(tmp_path / "a")):
            with obs.annotate("outer.range"):
                cf = Filter2D(window=3).compile(x, "xla", device="cpu")
                cf(x, k)
    (path,) = glob.glob(str(tmp_path / "a" / "*.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"outer.range", "repro_torch.pipeline.compile",
            "repro_torch.pipeline.call"} <= names


def test_compile_profile_dump_captures_the_first_call(tmp_path, rng):
    d = str(tmp_path / "dump")
    x = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32))
    k = np.ones((3, 3), np.float32)
    spec = Filter2D(window=3)
    cf = spec.compile(x, "streaming", strip_h=4, profile_dump=d,
                      device="cpu")
    assert cf is spec.compile(x, "streaming", strip_h=4, profile_dump=d,
                              device="cpu")
    assert cf is not spec.compile(x, "streaming", strip_h=4, device="cpu")
    plain = spec.compile(x, "core", device="cpu")(x, k)
    for _ in range(3):
        torch.testing.assert_close(cf(x, k), plain, rtol=3e-4, atol=3e-4)
    assert len(glob.glob(os.path.join(d, "*.trace.json"))) == 1
    assert cf.cache_size() == 1
