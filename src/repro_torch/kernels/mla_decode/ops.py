"""Public wrapper of the absorbed-MLA decode kernel, and the choice of route.

:func:`mla_decode_fused`: the attention of one multi-head latent attention
layer of a decode step after its projections and the absorption of
``W_UK``: q_lat [B, H, 512], q_pe [B, H, 64] before RoPE, the new rows
ckv_new [B, 512] and kpe_new [B, 64] (before RoPE); RoPE on q_pe and the
new key, both new rows written into the caches ckv [B, S, 512] and kpe [B,
S, 64] in place at each sequence's position (dropped at ``pos >= S``), and
attention of every head over each sequence's valid rows -> o_lat [B, H,
512] (:mod:`.ref` is its plain version).  The query tensors may be strided
views (each row contiguous): the model passes the transposed output of its
``W_UK`` product and the rope half of its query projection without a copy.

On CUDA tensors it launches the hand-written Hopper kernels
(``csrc/mla_decode.cu``: a split kernel over chunks of rows and a merge
kernel, the merge left out when the cache is one chunk long) or raises: it
checks device, dtype, shapes, widths, strides and alignment, allocates the
output (in [H, B, 512], returned as its [B, H, 512] view) and the f32
scratch, checks the launch's return code and adds the launches made to
:data:`LAUNCHES`.  Nothing waits for the device: the kernels read the
positions from device memory.  On CPU tensors it runs the plain version.

:func:`route` says whether a decode step's MLA takes the kernel
(``"kernel"``: bf16 on CUDA) or the plain route (``"plain"``: every other
dtype and device).  :func:`frequencies` keeps each layer's RoPE frequencies
and cos/sin scale on the device, computed once by the plain code.

A CTA takes one sequence and one chunk of ``CHUNK`` rows (a sweep on the
card, ``PERF.md``: 256 is as fast as 512 at the benchmark cell's shape
and the fastest for one long sequence).
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels._build import LaunchCounter, launches_kernel
from repro_torch.kernels.mla_decode.ref import mla_decode_fused_ref
from repro_torch.models import layers as L

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mla_decode.cu"

RANK, ROPE = 512, 64
MAX_HEADS = 16
CHUNK = 256
PART_WORDS = 4      # m, l and two pad words before each partial's sum

LAUNCHES = LaunchCounter("mla_decode")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C entry typed."""
    from repro_torch.kernels._build import load_library

    lib = load_library(SOURCE)
    P, I, F, LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    lib.mla_decode.argtypes = [P, LL, LL, P, LL, LL, P, LL, P, LL, P, P, P,
                               I, P, F, F, P, P, I, I, I, I, P]
    lib.mla_decode.restype = ctypes.c_int
    lib.mla_decode_error_string.argtypes = [I]
    lib.mla_decode_error_string.restype = ctypes.c_char_p
    return lib


def route(dtype: torch.dtype, device) -> str:
    """``"kernel"`` or ``"plain"`` for a decode step whose MLA reads
    ``dtype`` rows on ``device`` (module docstring)."""
    if torch.device(device).type != "cuda" or dtype != torch.bfloat16:
        return "plain"
    return "kernel"


@functools.lru_cache(maxsize=None)
def frequencies(mla, theta: float, device: torch.device):
    """(frequencies [qk_rope_head_dim / 2] f32 on ``device``, cos/sin
    scale) of an ``MLACfg`` (:func:`layers.mla_rope`)."""
    return L.mla_rope(mla, theta, device)


def _refuse(msg: str):
    raise ValueError(f"mla_decode: {msg}")


def check_args(q_lat, q_pe, ckv_new, kpe_new, ckv, kpe, pos, freqs) -> None:
    """Raise ``ValueError`` on what the kernel does not take.  Each message
    is built only on refusal: this runs in every decode layer."""
    if ckv.dim() != 3 or kpe.dim() != 3:
        _refuse(f"caches {tuple(ckv.shape)}, {tuple(kpe.shape)} must be "
                "[B, S, 512] and [B, S, 64]")
    B, S, Rk = ckv.shape
    if Rk != RANK or kpe.shape != (B, S, ROPE):
        _refuse(f"caches {tuple(ckv.shape)}, {tuple(kpe.shape)}: the "
                f"kernel takes a latent of {RANK} and rope dims of {ROPE}")
    if q_lat.dim() != 3 or q_lat.shape[0] != B or q_lat.shape[2] != RANK:
        _refuse(f"q_lat {tuple(q_lat.shape)} must be [{B}, H, {RANK}]")
    H = q_lat.shape[1]
    if not 0 < H <= MAX_HEADS:
        _refuse(f"{H} heads: the kernel takes 1 to {MAX_HEADS}")
    if q_pe.shape != (B, H, ROPE) or ckv_new.shape != (B, RANK) \
            or kpe_new.shape != (B, ROPE):
        _refuse(f"q_pe {tuple(q_pe.shape)}, ckv_new "
                f"{tuple(ckv_new.shape)}, kpe_new {tuple(kpe_new.shape)} "
                f"must be [{B}, {H}, {ROPE}], [{B}, {RANK}], [{B}, {ROPE}]")
    if B == 0 or S == 0:
        _refuse("empty batch or cache")
    if pos.dtype not in (torch.int64, torch.int32) or pos.dim() > 1 or (
            pos.dim() == 1 and pos.shape[0] != B):
        _refuse(f"positions {pos.dtype} {tuple(pos.shape)}: int64 or int32, "
                f"[] or [{B}]")
    dev = ckv.device
    named = (("q_lat", q_lat), ("q_pe", q_pe), ("ckv_new", ckv_new),
             ("kpe_new", kpe_new), ("ckv", ckv), ("kpe", kpe))
    for name, t in named:
        rows_ok = t.stride(-1) == 1 and all(st % 8 == 0
                                             for st in t.stride()[:-1])
        if t.dtype != torch.bfloat16 or t.device != dev or not rows_ok \
                or t.data_ptr() % 16:
            _refuse(f"{name} must be bfloat16 on {dev} with contiguous, "
                    f"16-byte aligned rows: {t.dtype} on {t.device}, "
                    f"strides {t.stride()}, address {t.data_ptr()}")
    if not (ckv.is_contiguous() and kpe.is_contiguous()):
        _refuse("the caches must be contiguous")
    if pos.device != dev or freqs.device != dev \
            or freqs.dtype != torch.float32 or freqs.shape != (ROPE // 2,) \
            or not freqs.is_contiguous():
        _refuse(f"positions on {pos.device} and frequencies "
                f"{freqs.dtype} {tuple(freqs.shape)} on {freqs.device} must "
                f"be on {dev}, the frequencies f32 [{ROPE // 2}]")


def _launch(q_lat, q_pe, ckv_new, kpe_new, ckv, kpe, pos, freqs, scale,
            rope_scale):
    check_args(q_lat, q_pe, ckv_new, kpe_new, ckv, kpe, pos, freqs)
    if pos.dtype == torch.int32:        # the kernel reads int64
        pos = pos.to(torch.int64)
    B, S, _ = ckv.shape
    H = q_lat.shape[1]
    n_chunks = -(-S // CHUNK)
    out = torch.empty((H, B, RANK), dtype=torch.bfloat16, device=ckv.device)
    part = None if n_chunks == 1 else torch.empty(
        (B, H, n_chunks, PART_WORDS + RANK), dtype=torch.float32,
        device=ckv.device)
    lib = library()
    with torch.cuda.device(ckv.device):
        rc = lib.mla_decode(
            q_lat.data_ptr(), q_lat.stride(0), q_lat.stride(1),
            q_pe.data_ptr(), q_pe.stride(0), q_pe.stride(1),
            ckv_new.data_ptr(), ckv_new.stride(0), kpe_new.data_ptr(),
            kpe_new.stride(0), ckv.data_ptr(), kpe.data_ptr(),
            pos.data_ptr(), int(pos.dim() == 1), freqs.data_ptr(),
            float(rope_scale), float(scale),
            None if part is None else part.data_ptr(), out.data_ptr(), B, S,
            H, CHUNK, torch.cuda.current_stream(ckv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("mla_decode launch failed: "
                           f"{lib.mla_decode_error_string(rc).decode()}")
    LAUNCHES.by_key["mla_decode"] += 1 if part is None else 2
    return out.transpose(0, 1)


def mla_decode_fused(q_lat: torch.Tensor, q_pe: torch.Tensor,
                     ckv_new: torch.Tensor, kpe_new: torch.Tensor,
                     ckv_cache: torch.Tensor, kpe_cache: torch.Tensor,
                     pos: torch.Tensor, freqs: torch.Tensor, *,
                     scale: float, rope_scale: float = 1.0) -> torch.Tensor:
    """q_lat [B, H, 512]; q_pe [B, H, 64] before RoPE; new rows ckv_new
    [B, 512] and kpe_new [B, 64] (before RoPE); caches [B, S, 512] and [B,
    S, 64], written in place; ``pos`` int64 or int32, [B] or scalar;
    ``freqs`` the rope dims' frequencies, ``rope_scale`` their cos/sin
    scale, ``scale`` the softmax scale -> o_lat [B, H, 512] bf16 (the
    plain version: q_lat's dtype, any width)."""
    if launches_kernel("mla_decode_fused", ckv_cache, None):
        return _launch(q_lat, q_pe, ckv_new, kpe_new, ckv_cache, kpe_cache,
                       pos, freqs, scale, rope_scale)
    return mla_decode_fused_ref(q_lat, q_pe, ckv_new, kpe_new, ckv_cache,
                                kpe_cache, pos, freqs, scale=scale,
                                rope_scale=rope_scale)
