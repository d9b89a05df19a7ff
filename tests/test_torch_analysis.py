"""The port's kernel verifier (``repro_torch.analysis``): clean verdicts
across every executor and the whole sweep under both loaders, the
seeded-bug fixtures flagged by exactly their intended pass, the Report
JSONL round trip through both packages, the sweep matrix equal to the
reference's with ``'pallas'`` read as ``'cuda'``, the card log's decoder,
the read-once figure, and the ``python -m repro_torch.analysis`` CLI exit
codes (0 clean / 1 findings / 2 error)."""
import dataclasses
import importlib
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import __main__ as analysis_cli
from repro_torch.analysis import ir
from repro_torch.analysis.report import Finding, Report, load_report
from repro_torch.analysis.verify import (cfg_blocks, cfg_key, compile_cfg,
                                         sweep_configs)
from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.pipeline import Filter2D
from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d import kernel as K

from _torch_analysis_fixtures import FIXTURES, build

ROOT = Path(__file__).resolve().parents[1]


# -- verify() across the executor matrix ------------------------------------


@pytest.mark.parametrize("execution", ["core", "xla", "cuda", "streaming",
                                       "sharded"])
def test_verify_clean_every_executor(execution):
    kw = (dict(mesh=["cpu"]) if execution == "sharded"
          else dict(device="cpu", strip_h=8) if execution == "streaming"
          else dict(device="cpu"))
    cf = Filter2D(window=5, border="mirror").compile((24, 300), execution,
                                                     **kw)
    report = cf.verify()
    assert report.clean, report.render()
    calls = {"core": 0, "xla": 0, "cuda": 1, "streaming": 3, "sharded": 1}
    assert report.stat("filter2d_halo_calls") == calls[execution]
    if execution in K.RING_EXECUTIONS:
        # both loaders at one block and at the geometry's grid
        assert set(report.passes) == set(analysis.PASSES)
        assert report.stat("read_amplification_traced") is not None
        assert {s for s, _ in report.stats} >= {"smem_bytes", "blocks"}
    else:
        assert report.passes == ("trace",)


_SWEEP = {cfg_key(c): c for c in sweep_configs()}


@pytest.mark.parametrize("key", sorted(_SWEEP))
def test_sweep_config_verifies_clean(key):
    """Every configuration of the sweep, the kernel's lanes under both
    loaders; the ring's shared memory equal to ``smem_working_set``."""
    cfg = _SWEEP[key]
    cf = compile_cfg(cfg)
    report = analysis.verify(cf, blocks=cfg_blocks(cf, cfg))
    assert report.clean, report.render()
    if cf.execution in K.RING_EXECUTIONS:
        keys = [k for k, _ in report.stats if k == "smem_bytes"]
        assert len(keys) == 2                    # tma and thread
        assert report.stat("smem_bytes") == report.stat("smem_working_set")


def test_verify_surfaces_in_explain():
    cf = Filter2D(window=3, border="mirror").compile((24, 300), "cuda",
                                                    device="cpu")
    text = cf.explain(verify=True)
    assert "verify" in text and "clean" in text
    d = cf.explain(as_dict=True)           # the cached report
    assert d["verify"]["clean"] is True
    assert d["verify"]["error"] is None and d["verify"]["findings"] == []
    assert set(d["verify"]["passes"]) == set(analysis.PASSES)
    fresh = Filter2D(window=3, border="wrap").compile((24, 300), "cuda",
                                                      device="cpu")
    assert fresh.explain(as_dict=True)["verify"] is None


def test_verify_a_bank_past_the_coefficient_file():
    """48 w13 float32 filters: two launches, each clean, the frame read
    once per launch."""
    cf = Filter2D(window=13, num_filters=48).compile((64, 300), "cuda",
                                                     device="cpu")
    report = cf.verify()
    assert report.clean, report.render()
    assert report.stat("coeff_chunks") == 2.0


# -- seeded-bug fixtures: each flagged by exactly its pass -------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_flagged_by_intended_pass_only(name):
    cfg = FIXTURES[name]
    plan, kw = build(name)
    report = analysis.verify_kernel(plan, **kw)
    assert report.error is None, report.error
    assert report.findings, f"fixture {name} verified clean"
    flagged = {f.passname for f in report.findings}
    assert flagged == {cfg["expect_pass"]}, report.render()
    assert any(cfg["expect_msg"] in f.message for f in report.findings), \
        report.render()


@pytest.mark.parametrize("name,differs", [
    ("stale_guard", True), ("widen_mac", True), ("premature_reuse", False)])
def test_schedule_diff_sees_what_not_when(name, differs):
    """``schedule_diff`` (the card's log against the model) compares what
    each block did — the producer's events in order, each item's consumer
    events as a multiset — and not the interleaving, which the warps'
    timing decides: a refill that comes one arrival early is the same
    events in another order, which the passes catch on either source."""
    plan, kw = build(name)
    ct = K.kernel_contract(plan, kw["num_filters"], "direct", kw["dtype"],
                           "tma")
    geo = halo.plan_ring_geometry(plan)
    good = analysis.schedule_model(ct, geo, plan, kw["M"], 2)
    bad = kw["schedule"](ct, geo, plan, kw["M"], 2)
    assert analysis.schedule_diff(good, good) == []
    assert bool(analysis.schedule_diff(good, bad)) == differs


# -- Report JSONL round-trip, both packages -----------------------------------


def _records(report):
    return [dataclasses.asdict(f) for f in report.findings], \
        {k: v for k, v in dataclasses.asdict(report).items()
         if k != "findings"}


def test_report_jsonl_round_trip(tmp_path):
    from repro.analysis import report as rreport
    plan, kw = build("stale_guard")
    report = analysis.verify_kernel(plan, **kw)
    assert report.findings
    path = str(tmp_path / "report.jsonl")
    report.to_jsonl(path)
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    assert recs[0]["kind"] == "verify_report"
    assert all(r["kind"] == "finding" for r in recs[1:])
    assert all("seq" in r and "t" in r for r in recs)
    assert load_report(path) == report
    # the reference reads the port's file, and the port the reference's
    theirs = rreport.load_report(path)
    assert _records(theirs) == _records(report)
    back = str(tmp_path / "back.jsonl")
    theirs.to_jsonl(back)
    assert load_report(back) == report


def test_clean_report_round_trip(tmp_path):
    report = Report(key="k", passes=("a", "b"), stats=(("x", 1.5),))
    path = str(tmp_path / "clean.jsonl")
    report.to_jsonl(path)
    assert load_report(path) == report


def test_report_merge():
    f = Finding(passname="p", message="m", key="k2")
    merged = Report(key="k1", passes=("a",)).merge(
        Report(key="k2", passes=("a", "b"), findings=(f,), error="boom"))
    assert merged.key == "k1"
    assert merged.passes == ("a", "b")
    assert merged.findings == (f,)
    assert merged.error == "boom"
    assert not merged.clean


# -- the sweep matrix against the reference's ---------------------------------


def _cfg_fields(cfg):
    rq = cfg.get("requant")
    return (cfg["execution"], cfg["dtype"], cfg["border"].policy,
            float(cfg["border"].constant), cfg["overlap"],
            cfg.get("num_filters", 1), bool(cfg.get("separable", False)),
            None if rq is None else dataclasses.asdict(rq))


@pytest.mark.parametrize("narrow", [
    {}, dict(executors=["pallas"]), dict(dtypes=["int8"]),
    dict(borders=["constant", "wrap"]),
    dict(executors=["streaming", "pallas"], dtypes=["float32"])],
    ids=["all", "pallas", "int8", "borders", "mixed"])
def test_sweep_configs_and_keys_equal_the_references(narrow):
    # the module (``repro.analysis`` exports a function of the same name)
    rverify = importlib.import_module("repro.analysis.verify")
    theirs = rverify.sweep_configs(**narrow)
    ours = sweep_configs(**narrow)
    mapped = [dict(c, execution="cuda" if c["execution"] == "pallas"
                   else c["execution"]) for c in theirs]
    assert [_cfg_fields(c) for c in ours] == [_cfg_fields(c) for c in mapped]
    assert [cfg_key(c) for c in ours] == [
        rverify.cfg_key(c).replace("pallas/", "cuda/", 1) for c in theirs]


# -- the card's log: the decoder ----------------------------------------------


def _encode(kir):
    """The events as the trace build writes them (ring.cuh trace_event),
    with the host's header row per launch."""
    rows = []
    codes = {ir.WaitEmpty: 1, ir.ExpectTx: 2, ir.Load: 3, ir.WaitFull: 4,
             ir.MuxWrite: 5, ir.Read: 6, ir.Arrive: 7, ir.Store: 8}
    for ln in kir.launches:
        rows.append([0, ln.launch, ln.blocks, ln.n0, ln.n1, ln.smem_bytes]
                    + [0] * 10)
    for e in kir.events:
        t = [codes[type(e)], e.launch, e.block, e.item, e.seq]
        warp = getattr(e, "warp", -1)
        stage = getattr(e, "stage", 0)
        if isinstance(e, ir.WaitEmpty):
            a = [e.parity]
        elif isinstance(e, ir.ExpectTx):
            a = [e.bytes]
        elif isinstance(e, ir.Load):
            a = [e.plane, e.row0, e.col0, e.rows, e.cols, e.elem_bytes,
                 int(e.loader == "tma")]
        elif isinstance(e, ir.WaitFull):
            a = [e.parity]
        elif isinstance(e, ir.MuxWrite):
            bits = struct.unpack("<Q", struct.pack(
                "<d", 0.0 if e.value is None else e.value))[0]
            lo, hi = bits & 0xffffffff, bits >> 32
            a = [e.slots, int(e.value is not None),
                 lo - (1 << 32) if lo >= 1 << 31 else lo,
                 hi - (1 << 32) if hi >= 1 << 31 else hi]
        elif isinstance(e, ir.Read):
            a = [e.row0, e.col0, e.rows, e.cols, e.elem_bytes,
                 1 if e.acc_kind == "int32" else 2]
        elif isinstance(e, ir.Store):
            a = [e.plane, e.filter, e.row0, e.col0, e.rows, e.cols, e.bytes]
        else:
            a = []
        rows.append(t + [stage, warp] + a + [0] * (9 - len(a)))
    return torch.tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("dtype,policy,loader", [
    ("float32", "constant", "tma"), ("int8", "constant", "thread"),
    ("float32", "wrap", "thread")])
def test_device_log_decodes_to_the_schedule(dtype, policy, loader):
    plan = halo.make_plan(40, 300, 5, BorderSpec(policy, -3.25), 40, 300,
                          dtype=dtype)
    ct = K.kernel_contract(plan, 3, "direct", dtype, loader)
    geo = halo.plan_ring_geometry(plan)
    model = analysis.schedule_model(ct, geo, plan, 2, 4)
    log = _encode(model)
    dev = analysis.from_device_log(log, contract=ct, plan=plan, M=2)
    assert dev.source == "device"
    assert analysis.schedule_diff(model, dev) == []
    assert sorted(e.body() for e in dev.events) == \
        sorted(e.body() for e in model.events)
    report = analysis.verify_kernel(
        plan, num_filters=3, dtype=dtype, M=2, loader=loader, blocks=4,
        schedule=lambda *a: analysis.from_device_log(
            log, contract=ct, plan=plan, M=2))
    assert report.clean, report.render()


@pytest.mark.parametrize("dtype,packed_every", [
    ("float32", 0), ("int8", 0), ("int8", 1), ("int8", 3)])
def test_mac_routes_counts_reads_by_their_packed_flag(dtype, packed_every):
    """The trace build writes a read's packed flag (the block took the dp4a
    route) as its seventh payload int: ``trace.mac_routes`` counts the
    reads by route as a numpy count of the same columns does, and the
    decoder's schedule is the model's whatever the flag."""
    from repro_torch.kernels.filter2d import trace
    plan = halo.make_plan(40, 300, 9, BorderSpec("mirror"), 40, 300,
                          dtype=dtype)
    ct = K.kernel_contract(plan, 2, "direct", dtype, "thread")
    model = analysis.schedule_model(ct, halo.plan_ring_geometry(plan), plan,
                                    2, 4)
    log = _encode(model)
    reads = (log[:, 0] == trace.EV_READ).nonzero().flatten()
    if packed_every:
        log[reads[::packed_every], 13] = 1
    rows = log.numpy()
    is_read = rows[:, 0] == 6
    want = {"dp4a": int((is_read & (rows[:, 12] == 1)
                         & (rows[:, 13] != 0)).sum()),
            "int32 MAC": int((is_read & (rows[:, 12] == 1)
                              & (rows[:, 13] == 0)).sum()),
            "float": int((is_read & (rows[:, 12] == 2)).sum())}
    got = trace.mac_routes(log)
    assert got == want and sum(got.values()) == len(reads) > 0
    if dtype == "float32":
        assert got["float"] == len(reads)
    elif packed_every == 1:
        assert got == {"dp4a": len(reads), "int32 MAC": 0, "float": 0}
    dev = analysis.from_device_log(log, contract=ct, plan=plan, M=2)
    assert analysis.schedule_diff(model, dev) == []


def test_a_log_missing_an_arrival_is_a_finding():
    plan = halo.make_plan(40, 300, 5, BorderSpec("mirror"), 40, 300)
    ct = K.kernel_contract(plan, 1, "direct", "float32", "tma")
    model = analysis.schedule_model(ct, halo.plan_ring_geometry(plan), plan,
                                    2, 2)
    drop = next(i for i, e in enumerate(model.events)
                if isinstance(e, ir.Arrive))
    log = _encode(model)
    log = torch.cat([log[:len(model.launches) + drop],
                     log[len(model.launches) + drop + 1:]])
    report = analysis.verify_kernel(
        plan, M=2, blocks=2, schedule=lambda *a: analysis.from_device_log(
            log, contract=ct, plan=plan, M=2))
    assert {f.passname for f in report.findings} == {"bank_hazard"}
    assert any("rewritten while" in f.message for f in report.findings)


# -- read once ----------------------------------------------------------------


@pytest.mark.parametrize("H,W,w,dtype,n", [
    (24, 300, 5, "float32", 1), (67, 336, 13, "float32", 48),
    (64, 300, 9, "int8", 2), (5, 48, 7, "bfloat16", 1)])
def test_read_once_is_the_frame_times_the_amplification(H, W, w, dtype, n):
    """Frame bytes loaded equal (Σ clipped box rows)(Σ clipped box
    columns) × planes × element bytes × chunks, exactly."""
    plan = halo.make_plan(H, W, w, BorderSpec("mirror"), H, W, dtype=dtype)
    M = 3
    report = analysis.verify_kernel(plan, num_filters=n, dtype=dtype, M=M,
                                    loader="thread")
    assert report.clean, report.render()
    geo = halo.plan_ring_geometry(plan)
    rows = sum(min(H, i * geo.strip_h - geo.r + geo.eh)
               - max(0, i * geo.strip_h - geo.r)
               for i in range(-(-H // geo.strip_h)))
    cols = sum(min(W, j * 128 - geo.lead + geo.box_w) - max(0, j * 128
                                                             - geo.lead)
               for j in range(-(-W // 128)))
    elem = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    chunks = len(halo.coeff_chunks(n, geo))
    assert report.stat("frame_bytes_loaded") == rows * cols * M * elem \
        * chunks
    amp = halo.ring_read_amplification(plan)
    assert amp == rows * cols / (H * W)
    assert report.stat("read_amplification_traced") == pytest.approx(amp)


# -- errors come back as reports ---------------------------------------------


def test_error_report_not_raise():
    plan = halo.make_plan(24, 300, 5, BorderSpec("mirror"), 24, 300)

    def broken(*a):
        raise AttributeError("nope")
    r = analysis.verify_kernel(plan, schedule=broken, key="broken")
    assert r.error is not None and "AttributeError" in r.error
    assert not r.clean


# -- CLI exit-code contract --------------------------------------------------


def test_cli_exit_0_clean_subprocess(tmp_path):
    out = str(tmp_path / "sweep.jsonl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--sweep",
         "--executor", "cuda", "--executor", "xla", "--dtype", "int8",
         "--border", "mirror", "--jsonl", out, "-q"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 trace error(s)" in proc.stdout
    with open(out) as fh:
        recs = [json.loads(line) for line in fh]
    assert recs and all(r["kind"] == "verify_report" for r in recs)


def test_cli_exit_1_on_findings(monkeypatch, capsys):
    bad = Report(key="k", passes=("bank_hazard",), findings=(
        Finding(passname="bank_hazard", message="seeded", key="k"),))
    monkeypatch.setattr(analysis_cli, "sweep",
                        lambda progress=None, **kw: {"k": bad})
    assert analysis_cli.main(["--sweep"]) == 1
    assert "1 finding(s)" in capsys.readouterr().out


def test_cli_exit_2_on_error(monkeypatch, capsys):
    bad = Report(key="a", findings=(
        Finding(passname="dma_pairing", message="x", key="a"),))
    err = Report(key="b", error="ValueError: no plan")
    monkeypatch.setattr(analysis_cli, "sweep",
                        lambda progress=None, **kw: {"a": bad, "b": err})
    assert analysis_cli.main(["--sweep"]) == 2
    assert "1 trace error(s)" in capsys.readouterr().out


def test_cli_list_passes(capsys):
    assert analysis_cli.main(["--list-passes"]) == 0
    out = capsys.readouterr().out
    for name in analysis.PASSES:
        assert name in out
