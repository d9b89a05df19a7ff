"""The port stands alone: ``import repro_torch`` pulls in neither JAX nor
the reference package, no source file of the port (or ``chip_smoke.py``)
imports them, and asking for the card where there is none raises instead
of carrying on silently on the CPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:[.\s]|$)",
                       re.M)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys\n"
            "import repro_torch, repro_torch.convert, repro_torch.core\n"
            "import repro_torch.core.streaming, repro_torch.obs.roofline, "
            "repro_torch.obs.profiler, repro_torch.core.distributed\n"
            "import repro_torch.serving.bench\n"
            "import repro_torch.kernels.filter2d, "
            "repro_torch.kernels.filter2d._build\n"
            "import repro_torch.kernels._build, repro_torch.kernels.swattn, "
            "repro_torch.kernels.dwconv1d\n"
            "import repro_torch.configs, repro_torch.configs.tiny\n"
            "import repro_torch.models.registry, repro_torch.models.ssm\n"
            "import repro_torch.models.moe, repro_torch.models.rope\n"
            "import repro_torch.configs.mixtral_8x7b, "
            "repro_torch.configs.qwen3_moe_30b_a3b, "
            "repro_torch.configs.gemma3_4b, repro_torch.configs.qwen2_vl_7b, "
            "repro_torch.configs.codeqwen15_7b, "
            "repro_torch.configs.xlstm_350m, "
            "repro_torch.configs.whisper_large_v3, "
            "repro_torch.configs.spatial_filter_hd\n"
            "import repro_torch.models.xlstm, repro_torch.models.whisper\n"
            "import repro_torch.training, repro_torch.optim, "
            "repro_torch.checkpoint, repro_torch.data, repro_torch.runtime, "
            "repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.training.trainer\n"
            "import repro_torch.sharding, repro_torch.sharding.rules, "
            "repro_torch.sharding.mesh, repro_torch.sharding.collectives, "
            "repro_torch.training.dp_shardmap, "
            "repro_torch.training.pipeline, repro_torch.launch.mesh\n"
            "import repro_torch.sharding.placement, "
            "repro_torch.training.spmd, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.roofline, repro_torch.launch.report\n"
            "import repro_torch.analysis, repro_torch.analysis.ir, "
            "repro_torch.analysis.passes, repro_torch.analysis.report, "
            "repro_torch.analysis.verify, repro_torch.analysis.__main__, "
            "repro_torch.kernels.filter2d.contract, "
            "repro_torch.kernels.filter2d.trace\n"
            "sys.path.insert(0, sys.argv[1]); import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_source_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here; this pins the no-card path")
    from repro_torch.core.pipeline import Filter2D
    from repro_torch.serving import FilterServeEngine
    spec = Filter2D(window=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.compile((8, 8))                 # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.compile((8, 8), "cuda", device="cuda")
    for execution in ("streaming", "xla"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spec.compile((8, 8), execution)  # the default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.compile((8, 8), "sharded", mesh=["cuda"] * 2)
    from repro_torch.core import (filter2d_sharded, filter2d_streaming,
                                  filter2d_xla)
    assert filter2d_sharded(torch.zeros(8, 8), np.ones((3, 3)),
                            ["cpu"] * 2).device.type == "cpu"
    assert filter2d_xla(torch.zeros(8, 8), np.ones((3, 3))).device.type == \
        "cpu"                                # the wrappers follow the frame
    assert filter2d_streaming(torch.zeros(8, 8), np.ones((3, 3)),
                              strip_h=4).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FilterServeEngine()
    from repro_torch.serving import bench
    from repro_torch import obs
    with obs.tracing(), pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench(duration_s=0.1)
    from repro_torch.core.filters import CoefficientFile, default_bank
    table = np.zeros((2, 3, 3), np.float32)
    for make in (CoefficientFile, default_bank,
                 lambda: CoefficientFile.from_numpy(table)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()                           # the default device is the card
    assert CoefficientFile(device="cpu").table.device.type == "cpu"
    cf = CoefficientFile.from_numpy(table, device="cpu")
    assert cf.table.device.type == "cpu" and cf.num_slots == 2
    from repro_torch.configs.base import SHAPES, RunConfig
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.convert import params_from_reference
    from repro_torch.models import registry
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.build(RunConfig(model=tiny_of("yi_6b"),
                                 shape=SHAPES["train_4k"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference({"w": table})


def _state_helpers():
    from repro_torch.configs.tiny import tiny_of
    from repro_torch.core.border_spec import BorderSpec
    from repro_torch.core.streaming import strip_plans
    from repro_torch.models import attention, ssm, transformer, whisper, xlstm
    mc = tiny_of("hymba_1_5b")
    st = transformer.make_stages(mc)[0]
    xmc = tiny_of("xlstm_350m")
    return {
        "mlstm_state_init": lambda **kw: xlstm.mlstm_state_init(xmc, 1, **kw),
        "slstm_state_init": lambda **kw: xlstm.slstm_state_init(xmc, 1, **kw),
        "self_cache_init": lambda **kw: whisper.self_cache_init(
            tiny_of("whisper_large_v3"), 1, **kw),
        "init_cache": lambda **kw: attention.init_cache(1, 4, 2, 16, **kw),
        "stage_cache_init": lambda **kw: transformer.stage_cache_init(
            mc, st, 1, 8, **kw),
        "cache_init": lambda **kw: transformer.cache_init(mc, 1, 8, **kw),
        "mamba_state_init": lambda **kw: ssm.mamba_state_init(mc, 1, **kw),
        "strip_plans": lambda **kw: strip_plans(
            16, 8, 3, BorderSpec("mirror"), 4, dtype="float32", **kw)}


@pytest.mark.parametrize("name", ["init_cache", "stage_cache_init",
                                  "cache_init", "mamba_state_init",
                                  "strip_plans", "mlstm_state_init",
                                  "slstm_state_init", "self_cache_init"])
def test_state_helpers_take_no_default_device(name):
    """A caller who forgets the device gets a TypeError, not state on the
    host."""
    make = _state_helpers()[name]
    with pytest.raises(TypeError, match="device"):
        make()
    assert make(device="cpu") is not None


def test_kernel_wrapper_routes_by_device_only():
    from repro_torch.core.border_spec import BorderSpec
    from repro_torch.kernels.filter2d import halo
    from repro_torch.kernels.filter2d import kernel as K
    plan = halo.make_plan(8, 9, 3, BorderSpec("mirror"), 8, 9)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 9)).astype(np.float32))
    co = torch.ones(1, 3, 3)
    before = K.filter2d_halo.launches
    y = K.filter2d_halo(x, co, plan)
    assert K.filter2d_halo.launches == before       # CPU: plain version
    torch.testing.assert_close(y, K.filter2d_halo_ref(x, co, plan))
    with pytest.raises(ValueError, match="no filter2d_halo for device"):
        K.filter2d_halo(x.to("meta"), co.to("meta"), plan)
    with pytest.raises(ValueError, match="unknown form"):
        K.filter2d_halo(x, co, plan, form="fft")


def test_lm_kernel_wrappers_route_by_device_only():
    from repro_torch.kernels.dwconv1d import kernel as DW
    from repro_torch.kernels.swattn import kernel as SW
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 9, 2, 16))
                         .astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 9, 1, 16))
                          .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 9, 6)).astype(np.float32))
    w, b = torch.ones(4, 6), torch.zeros(6)
    sw_before, dw_before = SW.swattn.launches, DW.dwconv1d.launches
    torch.testing.assert_close(SW.swattn(q, kv, kv, window=3, scale=0.5),
                               SW.swattn_ref(q, kv, kv, window=3, scale=0.5))
    torch.testing.assert_close(DW.dwconv1d(x, w, b), DW.dwconv1d_ref(x, w, b))
    assert (SW.swattn.launches, DW.dwconv1d.launches) == (sw_before,
                                                          dw_before)
    # meta (the dry run and the roofline): an empty output of q's shape
    # through the counted operator, no launch
    out = SW.swattn(q.to("meta"), kv.to("meta"), kv.to("meta"), window=3,
                    scale=0.5)
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="head dims"):
        SW.swattn(q[..., :8].to("meta"), kv[..., :8].to("meta"),
                  kv[..., :8].to("meta"), window=3, scale=0.5)
    with pytest.raises(ValueError, match="no dwconv1d for device"):
        DW.dwconv1d(x.to("meta"), w.to("meta"), b.to("meta"))
    assert (SW.swattn.launches, DW.dwconv1d.launches) == (sw_before,
                                                          dw_before)


def test_build_without_nvcc_raises():
    from repro_torch.kernels.filter2d import _build
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here; this pins the no-toolkit path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert len(_build._sources()[0]) >= 2
    from repro_torch.kernels import _build as shared
    libs = shared.all_libraries()
    assert [lib.name for lib in libs] == ["filter2d_halo", "swattn",
                                          "dwconv1d"]
    for lib in libs:
        assert lib.sources()[0], lib.name
        assert lib.build_dir.parent == shared.ROOT / "build"
        with pytest.raises(RuntimeError, match="nvcc not found"):
            lib.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        shared.build_all(libs)
