"""Public wrapper of the flash-attention kernel.

:func:`flash_attention` keeps the semantics of the reference wrapper
(``repro/kernels/flash_attn/ops.py``).  Its tile keywords ``bq`` and ``bk``
choose no tile (the kernel's tiles are fixed by the head dim) and
``interpret`` chooses the route
(:func:`repro_torch.kernels._build.launches_kernel`).

* On CUDA tensors it launches a hand-written Hopper kernel
  (``csrc/flash_attention.cu``) or raises: it checks device, dtype,
  shapes, head dim, contiguity and alignment, allocates the output, checks
  the launch's return code and adds one to :data:`LAUNCHES`.  Both kernels
  take head dims 16, 32, 64 and 128.  The route by dtype:

  - bf16 q, k, v: the tensor-core kernel.  q.k is exact in ``mma.sync``
    bf16 -> f32; the f32 probabilities are split as ``p_hi = bf16(p)``,
    ``p_lo = bf16(p - p_hi)`` and p.v runs as two bf16 products into the
    f32 accumulator (within 2^-18 |p| of f32 p);
  - f32 q, k, v: the tensor-core kernel in 3xTF32.  Each operand x of q.k
    and p.v is split as ``hi = tf32(x)`` (round to nearest, ties away)
    and ``lo = x - hi`` (read by the tensor cores truncated to tf32), and
    each product runs as ``hi.hi + hi.lo + lo.hi`` in ``mma.sync`` tf32
    -> f32, within about 2^-21 of each f32 product (one TF32 product
    would miss the tolerance).
* On CPU tensors it runs the plain PyTorch version in :mod:`.ref`.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels._build import LaunchCounter, launches_kernel
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" \
    / "flash_attention.cu"

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

LAUNCHES = LaunchCounter("flash")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C entry typed."""
    from repro_torch.kernels._build import load_library

    return bind(load_library(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the C entries of ``lib``, built from :data:`SOURCE` or from a
    variant of it with the same entries."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention.argtypes = [P, P, P, I, P, I, I, I, I, I, I, I, I,
                                    ctypes.c_float, P]
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [I]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _launch(q, k, v, causal, sliding_window):
    _check(q.dim() == 4 and k.dim() == 4,
           f"q {tuple(q.shape)} and k {tuple(k.shape)} must be 4-D")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check(tuple(v.shape) == tuple(k.shape),
           f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    _check(k.shape[0] == B and k.shape[3] == D,
           f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _check(Hkv > 0 and H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    _check(D in HEAD_DIMS, f"head dim {D}: the kernel takes {HEAD_DIMS}")
    _check(Sk > 0, "no keys")
    _check(sliding_window is None or sliding_window >= 1,
           f"sliding_window={sliding_window}")
    for name, t in (("k", k), ("v", v)):
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype}, q {q.dtype}")
    _check(q.dtype in DTYPES,
           f"dtype {q.dtype}: the kernel takes float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.is_contiguous(), f"{name} is not contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    out = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPES[q.dtype],
            out.data_ptr(), B, Sq, Sk, H, Hkv, D, int(causal),
            sliding_window or 0, D ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           f"{lib.flash_error_string(rc).decode()}")
    LAUNCHES.by_key["flash"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, sliding_window=None,
                    bq: int = 128, bk: int = 128, interpret=None):
    """q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, H, D] f32.

    Causal masking is start-aligned (query and key positions both count
    from 0); ``sliding_window`` keeps keys with ``q - k < window``.  H must
    be a multiple of Hkv: query head ``h`` reads KV head ``h // (H //
    Hkv)``.  ``bq`` / ``bk`` choose no tile and ``interpret`` the route
    (module docstring).
    """
    if launches_kernel("flash_attention", q, interpret):
        return _launch(q, k, v, causal, sliding_window)
    return flash_attention_ref(q, k, v, causal=causal,
                               sliding_window=sliding_window)
