"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/sph_bvf_tpu_torch/`` at the repository root, named by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags so a changed source
never loads a stale library.  The library is loaded with ``ctypes``: no
PyTorch headers are compiled, which keeps a cold build to seconds.

Nothing is built at import time.  A missing ``nvcc`` or a failed build
raises: a CUDA tensor never falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from sph_bvf_tpu_torch.utils import profiler

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sph_bvf_tpu_torch"
# -Xptxas=-v: ptxas reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict = {}  # name -> ctypes.CDLL, one load per process
build_seconds: dict = {}  # name -> seconds spent compiling in this process
build_log: dict = {}  # name -> the compiler's messages (ptxas resource usage)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or the
    toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin): the "
        "CUDA kernels of sph_bvf_tpu_torch cannot be built"
    )


def nvcc_version() -> str:
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it
    (the span ``load.<name>``, host time, recorded in every mode)."""
    if name in _loaded:
        return _loaded[name]
    with profiler.once(f"load.{name}"):
        return _load(name)


def _load(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent processes never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{proc.stderr}{proc.stdout}"
                )
            build_log[name] = proc.stderr + proc.stdout
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib


def current_stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``: kernels launch
    on it, in order with the PyTorch ops around them."""
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def check(lib: ctypes.CDLL, code: int, what: str):
    """Raise on a non-zero cudaError_t returned by a kernel's C entry point."""
    if code != 0:
        lib.sph_cuda_error_string.restype = ctypes.c_char_p
        lib.sph_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.sph_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
