"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The build runs at first use, from the package's own sources, into
``wiflow_tpu_torch/build/`` (listed in ``.gitignore``).  The file name
carries a hash of the sources and flags, so an edited kernel is rebuilt.
``build(names)`` starts one nvcc per library, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90
SMS = 132             # streaming multiprocessors of an H100 SXM


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, in
    parallel.  Returns the seconds each build took (0 when already built);
    raises with nvcc's output if one fails.  nvcc's ``-Xptxas -v`` report
    (registers, shared memory, spills) is kept in ``build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures: List[str] = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (rc={proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


class CudaKernel:
    """One exported C entry point of a ``csrc/`` library.

    ``replaces`` names the ``pallas_call`` (file:line) of the JAX package
    that the kernel ports.  ``launches`` counts the launches made through
    :meth:`launch` — a plain integer that callers may reset to 0.  The
    library is built and loaded on the first launch; without a CUDA
    device that raises.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 replaces: str):
        self.name, self.symbol = name, symbol
        self.argtypes = list(argtypes)
        self.source = f"wiflow_tpu_torch/csrc/{name}.cu"
        self.replaces = replaces
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        if self._fn is None:
            if not torch.cuda.is_available():
                raise RuntimeError(f"{self.name}: no CUDA device; the CUDA "
                                   f"kernel runs on the card only")
            build([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.wf_error_string.argtypes = [ctypes.c_int]
            lib.wf_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self.load()(*args)
        if rc != 0:
            msg = self._lib.wf_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{rc} ({msg})")
        self.launches += 1


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dtype_code(dtype: torch.dtype) -> int:
    """The C side's dtype switch: 0 = float32, 1 = bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device`` (a CUDA tensor's device), read
    without building a ``torch.cuda.Stream``: a launch's host time counts."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))


def check_tensor(t: torch.Tensor, name: str, *, device: torch.device,
                 dtype: torch.dtype, shape: Sequence[int] | None = None
                 ) -> None:
    """Raise unless ``t`` is contiguous, on ``device``, of ``dtype`` and
    ``shape``: a kernel reads raw pointers and checks none of it."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
