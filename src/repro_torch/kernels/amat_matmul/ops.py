"""Public wrapper of the batched-expert fused AMAT dequant-matmul.

:func:`amat_expert_matmul` keeps the semantics of the reference wrapper
(``repro/kernels/amat_matmul/ops.py::amat_expert_matmul``):
``[E, M, K] @ per-expert-dequant([E, K, N] codes) -> [E, M, N] f32``, with
``use_lsb [E]`` choosing MSB+LSB or MSB-only per expert and
``transposed=True`` reading output-major ``[E, N, K]`` codes (the ``wo``
layout).

* On CUDA tensors it launches the hand-written Hopper kernel
  (``csrc/amat_batched_matmul.cu``) or raises; it checks device, dtype,
  shape, contiguity and alignment, allocates the output, checks the
  launch's return code and adds one to :data:`LAUNCHES`.
* On CPU tensors it runs the plain PyTorch version in :mod:`.ref`.

The kernel handles ragged M and N itself, so no padding happens here.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels.amat_matmul.ref import (amat_batched_matmul_ref,
                                                 amat_batched_matmul_t_ref)

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" \
    / "amat_batched_matmul.cu"

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Kernel launches since the last :meth:`reset`, by code layout:
    ``k_major`` (``wi``) and ``output_major`` (``wo``, transposed)."""

    def __init__(self) -> None:
        self.by_layout = {"k_major": 0, "output_major": 0}

    @property
    def count(self) -> int:
        return sum(self.by_layout.values())

    def reset(self) -> None:
        for k in self.by_layout:
            self.by_layout[k] = 0


LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels._build import load_library

    lib = load_library(SOURCE)
    fn = lib.amat_batched_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.amat_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"amat_expert_matmul: {msg}")


def _launch(x, codes, scales, zps, use_lsb, group_size, shift, transposed):
    E, M, K = x.shape
    N = codes.shape[1] if transposed else codes.shape[2]
    dev = x.device
    for name, t in (("codes", codes), ("scales", scales), ("zps", zps),
                    ("use_lsb", use_lsb)):
        _check(t.device == dev, f"{name} on {t.device}, x on {dev}")
    _check(x.dtype in _X_DTYPES,
           f"x dtype {x.dtype}: the kernel takes float32 or bfloat16")
    _check(codes.dtype == torch.uint8, f"codes dtype {codes.dtype}")
    _check(scales.dtype == torch.float32, f"scales dtype {scales.dtype}")
    _check(zps.dtype == torch.uint8, f"zps dtype {zps.dtype}")
    _check(group_size % 32 == 0 and K % group_size == 0,
           f"K={K} and group_size={group_size}: the kernel needs "
           "group_size % 32 == 0 and K % group_size == 0")
    want = (E, N, K) if transposed else (E, K, N)
    _check(tuple(codes.shape) == want, f"codes {tuple(codes.shape)} != {want}")
    _check(transposed or N % 4 == 0,
           f"N={N}: K-major codes need N % 4 == 0 (4-byte row loads)")
    G = K // group_size
    _check(tuple(scales.shape) == (E, G, N), f"scales {tuple(scales.shape)}")
    _check(tuple(zps.shape) == (E, G, N), f"zps {tuple(zps.shape)}")
    _check(tuple(use_lsb.shape) == (E,), f"use_lsb {tuple(use_lsb.shape)}")
    for name, t in (("x", x), ("codes", codes), ("scales", scales),
                    ("zps", zps), ("use_lsb", use_lsb)):
        _check(t.is_contiguous(), f"{name} is not contiguous")
    _check(codes.data_ptr() % 16 == 0, "codes are not 16-byte aligned")
    if use_lsb.dtype != torch.bool:
        use_lsb = use_lsb != 0
    out = torch.empty((E, M, N), dtype=torch.float32, device=dev)
    if E == 0 or M == 0 or N == 0:
        return out
    fn, err = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), _X_DTYPES[x.dtype], codes.data_ptr(),
                scales.data_ptr(), zps.data_ptr(), use_lsb.data_ptr(),
                out.data_ptr(), E, M, K, N, group_size, shift,
                int(transposed), stream)
    if rc != 0:
        raise RuntimeError(
            f"amat_batched_matmul launch failed: {err(rc).decode()}")
    LAUNCHES.by_layout["output_major" if transposed else "k_major"] += 1
    return out


def amat_expert_matmul(x, codes, scales, zps, use_lsb, *,
                       group_size: int = 32, shift: int = 4,
                       transposed: bool = False):
    """[E, M, K] @ per-expert-dequant([E, K, N] codes) -> [E, M, N] f32.

    ``use_lsb`` [E] selects MSB+LSB (high-bit) vs MSB-only dequant per
    expert.  ``transposed=True`` reads output-major codes ``[E, N, K]``
    with the metadata still K-major ``[E, K//G, N]``.
    """
    if x.device.type == "cuda":
        return _launch(x, codes, scales, zps, use_lsb, group_size, shift,
                       transposed)
    if x.device.type == "cpu":
        ref = amat_batched_matmul_t_ref if transposed \
            else amat_batched_matmul_ref
        return ref(x, codes, scales, zps, use_lsb, group_size=group_size,
                   shift=shift)
    raise ValueError(f"amat_expert_matmul: no path for device {x.device}")


def amat_expert_matmul_qt(x, qt, use_lsb, *, shift: int):
    """QuantizedTensor convention for the batched expert kernel."""
    if not qt.asymmetric:
        raise ValueError("AMAT kernel expects asymmetric group quant")
    return amat_expert_matmul(x, qt.codes, qt.scales, qt.zero_points,
                              use_lsb, group_size=qt.group_size, shift=shift)


def amat_expert_matmul_t(x, codes_t, scales, zps, use_lsb, *, shift: int,
                         group_size: int = 32):
    """Transposed-weight entry point: codes_t [E, N, K] output-major."""
    return amat_expert_matmul(x, codes_t, scales, zps, use_lsb,
                              group_size=group_size, shift=shift,
                              transposed=True)
