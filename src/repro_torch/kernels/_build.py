"""Build and load the port's CUDA kernels.

Each kernel package keeps its sources in its own ``csrc/``. A
:class:`KernelLibrary` compiles them with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Each ``.cu`` file compiles in
its own ``nvcc`` process, every process of every library started
together (:func:`build_all`), and one link step per library makes it. The
build happens at first use, into ``build/<name>/`` at the root of the
checkout, under a name that hashes the sources and flags: an edited
source builds afresh, an unchanged one loads the library already there.

    python -m repro_torch.kernels._build      # build all, print ptxas
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[3]
# headers every kernel package may include (hopper.cuh: mbarriers, TMA)
COMMON = Path(__file__).resolve().parent / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "their csrc/ directories with the CUDA toolkit, which "
                       "this machine does not have")


class KernelLibrary:
    """One kernel package's ``csrc/`` as a ``ctypes`` library.

    ``signatures`` maps each exported C function to its ``argtypes``
    (``c_void_p`` for every pointer and the stream, ``c_int`` for every
    int); each returns the launch's CUDA error code as an int.
    ``defines`` are extra ``-D`` macros of every unit, and ``only`` names
    the ``.cu`` files to build when the library takes a subset of
    ``csrc/`` (a second build of the same sources, as the trace build).
    """

    def __init__(self, name: str, csrc: Path,
                 signatures: Dict[str, Sequence],
                 defines: Sequence[str] = (),
                 only: Optional[Sequence[str]] = None):
        self.name = name
        self.csrc = Path(csrc)
        self.signatures = dict(signatures)
        self.defines = tuple(defines)
        self.only = None if only is None else tuple(only)
        self.build_dir = ROOT / "build" / name
        self.ptxas_log = self.build_dir / "ptxas.log"
        self._lib = None
        self._lock = threading.Lock()

    def sources(self):
        """(``.cu`` files, ``.cuh`` headers), sorted."""
        cus = sorted(self.csrc.glob("*.cu"))
        if self.only is not None:
            cus = [f for f in cus if f.name in self.only]
        return cus, sorted(self.csrc.glob("*.cuh"))

    def flags(self) -> List[str]:
        return FLAGS + [f"-D{d}" for d in self.defines]

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(self.flags()).encode())
        srcs, hdrs = self.sources()
        for f in srcs + hdrs + sorted(COMMON.glob("*.cuh")):
            h.update(f.name.encode())
            h.update(f.read_bytes())
        return h.hexdigest()[:16]

    def path(self) -> Path:
        return self.build_dir / f"lib{self.name}_{self._digest()}.so"

    def build(self, verbose: bool = False) -> Path:
        """Compile the sources (in parallel) and link the library; returns
        its path. ``verbose`` rebuilds with ``-Xptxas -v`` and writes the
        compiler's report (registers, shared memory, spills per kernel)
        to ``ptxas_log``. A library already built from the same sources
        and flags is reused otherwise."""
        return build_all([self], verbose=verbose)[0]

    def load(self) -> ctypes.CDLL:
        """The built library, each exported function's C signature set."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn_name, argtypes in self.signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


def build_all(libs: Sequence[KernelLibrary],
              verbose: bool = False) -> List[Path]:
    """Build ``libs`` with one ``nvcc`` per source, all started together,
    then one link per library. Returns the libraries' paths in order."""
    todo = [lib for lib in libs if verbose or not lib.path().exists()]
    if todo:
        nvcc = _nvcc()
        extra = ["-Xptxas", "-v"] if verbose else []
        tmps, jobs = {}, []
        try:
            for lib in todo:
                lib.build_dir.mkdir(parents=True, exist_ok=True)
                tmps[lib.name] = tempfile.TemporaryDirectory(dir=lib.build_dir)
                for src in lib.sources()[0]:
                    obj = Path(tmps[lib.name].name) / (src.stem + ".o")
                    jobs.append((lib, src, obj, subprocess.Popen(
                        [nvcc, *lib.flags(), "-I", str(COMMON), *extra, "-c",
                         str(src), "-o", str(obj)], stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True)))
            failed, report = [], {lib.name: [] for lib in todo}
            for lib, src, _, proc in jobs:
                out, _ = proc.communicate()
                report[lib.name].append(f"# nvcc {src.name}\n{out}")
                if proc.returncode != 0:
                    failed.append(f"{src.name} (rc {proc.returncode}):\n{out}")
            if verbose:
                for lib in todo:
                    lib.ptxas_log.write_text("".join(report[lib.name]))
            if failed:
                raise RuntimeError("nvcc failed on " + "\n".join(failed))
            for lib in todo:
                objs = [str(o) for lb, _, o, _ in jobs if lb is lib]
                final = lib.path()
                tmp_lib = Path(tmps[lib.name].name) / final.name
                link = subprocess.run(
                    [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *objs],
                    capture_output=True, text=True)
                if link.returncode != 0:
                    raise RuntimeError(f"nvcc link of {lib.name} failed:\n"
                                       f"{link.stdout}{link.stderr}")
                os.replace(tmp_lib, final)  # atomic: no half-written library
        finally:
            for _, _, _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for tmp in tmps.values():
                tmp.cleanup()
    return [lib.path() for lib in libs]


def all_libraries() -> List[KernelLibrary]:
    """Every kernel library of the port."""
    from repro_torch.kernels.dwconv1d import _build as dw
    from repro_torch.kernels.filter2d import _build as f2d
    from repro_torch.kernels.swattn import _build as sw
    return [f2d.LIBRARY, sw.LIBRARY, dw.LIBRARY]


if __name__ == "__main__":
    libs = all_libraries()
    for lib, path in zip(libs, build_all(libs, verbose=True)):
        print(path)
        print(lib.ptxas_log.read_text())
