"""Port vs reference: ``FilterServeEngine`` on the CPU over the
reference's own request mix (``build_mix``, same seed → same frames,
coefficients and gains in both packages), plus the scheduler semantics
with a fake executor and the open-loop bench."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.serving import FilterServeEngine as RFilterServeEngine
from repro.serving.bench import build_mix as r_build_mix
from repro_torch import obs
from repro_torch.core.pipeline import Filter2D
from repro_torch.serving import FilterServeEngine
from repro_torch.serving import bench
from repro_torch.serving.bench import build_mix

from _torch_parity import assert_match


def _drive(engine, templates, order):
    reqs = [engine.submit(templates[i].frame, templates[i].coeffs,
                          spec=templates[i].spec, gains=templates[i].gains,
                          tenant=templates[i].tenant) for i in order]
    assert engine.drain(timeout=120)
    return reqs


@pytest.mark.parametrize("execution", ["auto", "cuda"])
def test_engine_matches_the_reference_engine(execution):
    order = [0, 1, 2, 3, 0, 0, 1, 3, 2, 1, 0, 3]
    ref_templates = r_build_mix(np.random.default_rng(5), scale=1)
    with RFilterServeEngine(batch_size=3, execution="core") as reng:
        ref = [r.result(timeout=60) for r in _drive(reng, ref_templates,
                                                    order)]
    templates = build_mix(np.random.default_rng(5), scale=1)
    for t, rt in zip(templates, ref_templates):
        np.testing.assert_array_equal(t.frame, rt.frame)
        np.testing.assert_array_equal(np.asarray(t.coeffs),
                                      np.asarray(rt.coeffs))
    with FilterServeEngine(batch_size=3, execution=execution,
                           device="cpu") as eng:
        reqs = _drive(eng, templates, order)
        st = eng.stats()
        buckets = eng.cache_size()
    assert st["recompiles"] == buckets == 3
    assert st["errors"] == 0 and st["completed"] == len(order)
    for i, r, want in zip(order, reqs, ref):
        got = r.result(timeout=10)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert_match(got, want, templates[i].spec.dtype, templates[i].name)


def test_bench_smoke_tiny():
    with obs.tracing():
        payload = bench.run_bench(duration_s=0.3, rate_rps=20.0,
                                  batch_size=2, device="cpu", seed=1)
    assert payload["schema"] == "bench_trajectory_v1"
    assert payload["device"] == "cpu"
    agg = payload["rows"][0]
    assert agg["recompiles"] == agg["buckets"] == 3
    assert agg["pixels_per_s"] > 0 and agg["p99_us"] >= agg["p50_us"]
    assert len(payload["rows"]) == 4
    assert all("hbm_bytes_per_pixel" in r for r in payload["rows"][1:])
    assert bench.main(["--duration", "0.2", "--rate", "10", "--device",
                       "cpu"]) == 0


class FakeExecutor:
    """Stands in for a CompiledFilter: output = frame * coeffs.flat[0]."""

    def __init__(self, fail_scale=None):
        self.compiles, self.calls = [], []
        self.fail_scale = fail_scale

    def compile_fn(self, spec, shape):
        self.compiles.append((spec, shape))

        def pipe(x, coeffs, gains=None):
            scale = float(np.asarray(coeffs).flat[0])
            if scale == self.fail_scale:
                raise RuntimeError("injected wave failure")
            self.calls.append(scale)
            return x * scale
        return pipe


def _frame(h, w):
    return np.full((h, w), 2.0, np.float32)


def test_buckets_waves_and_lru_eviction():
    fx = FakeExecutor()
    spec3, spec5 = Filter2D(window=3), Filter2D(window=5)
    k = np.full((3, 3), 3.0, np.float32)
    with FilterServeEngine(batch_size=4, cache_slots=2, device="cpu",
                           compile_fn=fx.compile_fn) as eng:
        for shape, spec in [((4, 5), spec3), ((4, 6), spec3),
                            ((4, 5), spec5)]:
            r = eng.submit(_frame(*shape), k, spec=spec)
            assert float(r.result(timeout=10)[0, 0]) == 6.0
        st = eng.stats()
        assert st["recompiles"] == 3 and st["evictions"] == 1
        assert eng.cache_size() == 2
        reqs = [eng.submit(_frame(4, 5), k, spec=spec5) for _ in range(6)]
        assert eng.drain(timeout=10)
        assert all(r.done() for r in reqs)
    assert eng.stats()["recompiles"] == 3


def test_tenants_split_waves_and_errors_stay_in_their_wave():
    fx = FakeExecutor(fail_scale=9.0)
    spec = Filter2D(window=3)
    ka, kb = np.full((3, 3), 2.0), np.full((3, 3), 9.0)
    with FilterServeEngine(batch_size=4, device="cpu",
                           compile_fn=fx.compile_fn) as eng:
        a = [eng.submit(_frame(4, 4), ka, spec=spec, tenant="a")
             for _ in range(3)]
        b = eng.submit(_frame(4, 4), kb, spec=spec, tenant="b")
        assert eng.drain(timeout=10)
    assert all(float(r.result(timeout=1)[0, 0]) == 4.0 for r in a)
    with pytest.raises(RuntimeError, match="injected"):
        b.result(timeout=1)
    st = eng.stats()
    assert st["errors"] == 1 and st["completed"] == 3


def test_shutdown_without_drain_cancels_and_submitters_are_thread_safe():
    gate = threading.Event()

    def slow_compile(spec, shape):
        gate.wait(10)
        return lambda x, c, gains=None: x
    eng = FilterServeEngine(batch_size=2, device="cpu",
                            compile_fn=slow_compile)
    spec = Filter2D(window=3)
    results = []

    def submitter():
        for _ in range(10):
            results.append(eng.submit(_frame(3, 3), np.ones((3, 3)),
                                      spec=spec))
    threads = [threading.Thread(target=submitter) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert eng.stats()["requests"] == 40
    time.sleep(0.05)
    eng.shutdown(drain=False, timeout=0)
    gate.set()
    eng._worker.join(10)
    assert not eng._worker.is_alive()
    st = eng.stats()
    assert st["cancelled"] + st["completed"] == 40 and st["cancelled"] > 0
    with pytest.raises(RuntimeError):
        eng.submit(_frame(3, 3), np.ones((3, 3)), spec=spec)


def test_submit_validation():
    with FilterServeEngine(device="cpu") as eng:
        with pytest.raises(TypeError):
            eng.submit(_frame(3, 3), np.ones((3, 3)), spec="w3")
        with pytest.raises(ValueError):
            eng.submit(np.zeros((2, 3, 3, 1), np.float32), np.ones((3, 3)),
                       spec=Filter2D(window=3))
        with pytest.raises(ValueError):
            eng.submit(np.zeros((3, 3), np.int8), np.ones((3, 3)),
                       spec=Filter2D(window=3))
    with pytest.raises(ValueError):
        FilterServeEngine(batch_size=0, device="cpu")
