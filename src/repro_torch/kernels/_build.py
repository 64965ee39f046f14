"""Build the port's CUDA kernels at first use, load them with ctypes, and
count their launches.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
placed under ``build/kernels/`` at the root of the checkout and named by
a hash of the source, the shared headers of ``kernels/csrc/`` (on the
include path) and the flags, so an edited source or header never loads a
stale library.  Concurrent builders each compile to a private temporary name
and the last ``os.replace`` wins with identical content.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Tuple

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
INCLUDE_DIR = pathlib.Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build_library(source: pathlib.Path, *, force: bool = False
                  ) -> Tuple[pathlib.Path, str]:
    """Compile ``source`` into ``build/kernels/`` unless already built.

    Returns ``(library path, compiler log)``; the log is empty when an
    existing library was reused.  ``force`` rebuilds regardless (the
    chip smoke test does, to print the ptxas report).
    """
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(INCLUDE_DIR.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{source.stem}_{digest[:12]}.so"
    if lib.exists() and not force:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", tmp,
             str(source)],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, log


def load_library(source: pathlib.Path) -> ctypes.CDLL:
    """Build (if needed) and ``dlopen`` the library compiled from ``source``."""
    lib, _ = build_library(source)
    return ctypes.CDLL(str(lib))


def launches_kernel(who: str, t, interpret) -> bool:
    """Whether a wrapper given tensor ``t`` launches its kernel (True) or
    runs its plain version (False), by the reference wrappers' keyword
    ``interpret``.  ``None``: the device decides, the kernel on a CUDA
    tensor and the plain version on a CPU tensor.  ``True`` asks for the
    plain version, the counterpart of Pallas' interpret mode, which only a
    CPU tensor has: a CUDA kernel has no interpret mode, so on a CUDA
    tensor it raises.  ``False`` asks for the kernel, which a CPU tensor
    cannot run, so there it raises."""
    dev = t.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"{who}: no path for device {t.device}")
    if interpret is None:
        return dev == "cuda"
    if bool(interpret) == (dev == "cuda"):
        raise ValueError(
            f"{who}: interpret={interpret} on a {dev} tensor: the plain "
            "version runs only on CPU tensors and the CUDA kernel only on "
            "CUDA tensors")
    return not interpret


class LaunchCounter:
    """Kernel launches since the last :meth:`reset`, by entry: each
    wrapper adds one to its key where it launches its kernel, and nowhere
    else, so a run can show which kernels its path went through."""

    def __init__(self, *keys: str) -> None:
        self.by_key = dict.fromkeys(keys, 0)

    @property
    def count(self) -> int:
        return sum(self.by_key.values())

    def reset(self) -> None:
        for k in self.by_key:
            self.by_key[k] = 0
