"""Build and load the CUDA ``filter2d_halo`` kernel.

The sources in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so the build takes seconds. Each ``.cu`` file compiles in
its own ``nvcc`` process, all started together, and one link step makes
the library. The build happens at first use, into ``build/`` at the root
of the checkout, under a name that hashes the sources and flags: an
edited source builds afresh, an unchanged one loads the library already
there.

    python -m repro_torch.kernels.filter2d._build   # build and print ptxas
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "filter2d_halo"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
PTXAS_LOG = BUILD_DIR / "ptxas.log"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernel is built from "
                       f"{CSRC} with the CUDA toolkit, which this machine "
                       "does not have")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    srcs, hdrs = _sources()
    for f in srcs + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path. ``verbose`` rebuilds with ``-Xptxas -v`` and writes the
    compiler's report (registers, shared memory, spills per kernel) to
    ``PTXAS_LOG``. A library already built from the same sources and
    flags is reused otherwise."""
    lib = BUILD_DIR / f"libfilter2d_halo_{_digest()}.so"
    if lib.exists() and not verbose:
        return lib
    nvcc = _nvcc()
    srcs, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        objs, procs = [], []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed, report = [], []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            report.append(f"# nvcc {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (rc {proc.returncode}):\n{out}")
        if verbose:
            PTXAS_LOG.write_text("".join(report))
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib)          # atomic: no half-written library
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with ``filter2d_halo_launch``'s C signature set:
    ``c_void_p`` for every pointer and the stream, ``c_int`` for every
    int, ``c_double`` for the border constant."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.filter2d_halo_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_double] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    print(build(verbose=True))
    print(PTXAS_LOG.read_text())
