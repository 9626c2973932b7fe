"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under csrc/ with a plain C interface (csrc/ is
on the include path, for its .cuh headers).  It is compiled with nvcc for
sm_90a into fsvid2vid_tpu_torch/build/ at first use (or when the source or
any header in csrc/ is newer than the library) and loaded with ctypes.
Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    cuda_home_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                  "bin", "nvcc")
    if nvcc is None and os.path.exists(cuda_home_nvcc):
        nvcc = cuda_home_nvcc
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's CUDA kernels")
    return nvcc


class CudaLibrary:
    """One csrc/<name>.cu and its build/lib<name>.so.  `declare(lib)` sets
    argtypes / restype of the library's functions, once, when it is loaded."""

    def __init__(self, name: str, declare):
        self.name = name
        self.declare = declare
        self.source = CSRC_DIR / f"{name}.cu"
        self.library = BUILD_DIR / f"lib{name}.so"
        self._lib = None

    def _command(self, out: str, verbose: bool):
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", str(CSRC_DIR), "-o", out, str(self.source)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        return cmd

    def start_build(self, verbose: bool = False):
        """Start nvcc and return a function that waits for it and returns
        (seconds, compiler output), so several sources can compile at once.

        nvcc writes to a temporary file that is renamed when it succeeds, so
        concurrent builds never leave a half-written library behind."""
        build_dir = self.library.parent
        build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.Popen(self._command(tmp, verbose),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        except BaseException:
            os.remove(tmp)
            raise

        def finish():
            try:
                out, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) on "
                        f"{self.source.name}:\n{err}")
                os.replace(tmp, self.library)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
            return time.perf_counter() - t0, out + err
        return finish

    def build(self, verbose: bool = False) -> tuple[float, str]:
        """Compile the source; returns (seconds, compiler output)."""
        return self.start_build(verbose)()

    def out_of_date(self) -> bool:
        """True when the library is missing or older than its source or
        than any header in csrc/ (which a source may include)."""
        if not self.library.exists():
            return True
        inputs = [self.source, *CSRC_DIR.glob("*.cuh")]
        return self.library.stat().st_mtime < max(p.stat().st_mtime for p in inputs)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if missing or out of date."""
        if self._lib is None:
            if self.out_of_date():
                self.build()
            lib = ctypes.CDLL(str(self.library))
            self.declare(lib)
            self._lib = lib
        return self._lib
