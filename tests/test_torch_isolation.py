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
            "import repro_torch.serving.bench\n"
            "import repro_torch.kernels.filter2d, "
            "repro_torch.kernels.filter2d._build\n"
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FilterServeEngine()
    from repro_torch.serving import bench
    from repro_torch import obs
    with obs.tracing(), pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench(duration_s=0.1)


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


def test_build_without_nvcc_raises():
    from repro_torch.kernels.filter2d import _build
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here; this pins the no-toolkit path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert len(_build._sources()[0]) >= 2
