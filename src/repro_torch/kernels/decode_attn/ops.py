"""Public wrappers of the decode-attention kernel, and the choice of route.

* :func:`decode_attention_fused`: one attention layer of a decode step
  after its projections, q [B, H, D] and the new rows k, v [B, Hkv, D]:
  RoPE on q and k, the new K and V rows written into the caches [B, S, Hkv,
  D] in place at each sequence's position (dropped at ``pos >= S``), and
  attention over each sequence's valid rows (:mod:`.ref` is its plain
  version);
* :func:`decode_attention`: attention alone, with the signature of
  :func:`repro_torch.models.layers.decode_attention` (``cur_pos`` valid
  rows), for caches whose rows are written elsewhere: the ring cache,
  int8 KV after its dequantization, the aligned window's selected rows.

On CUDA tensors each launches the hand-written Hopper kernels
(``csrc/decode_attention.cu``: a split kernel over chunks of rows and a
merge kernel, the merge left out when the cache is one chunk long) or
raises: it checks device, dtype, shapes, head dim, contiguity and
alignment, allocates the output and the f32 scratch, checks the launch's
return code and adds the launches made to :data:`LAUNCHES`.  Nothing waits
for the device: the kernels read the positions from device memory.  On CPU
tensors each runs its plain version.

:func:`route` says which of the three a decode step's attention takes, by
what its input shows: ``"fused"`` (bf16 on CUDA, neither ring nor int8),
``"attend"`` (bf16 on CUDA, ring or int8: plain writes, then
:func:`decode_attention`) or ``"plain"`` (every other dtype and device).

Plan by shape (:func:`plan`): a CTA takes up to 8 query heads of one KV
head (``R``, the smallest power of two at or above the GQA ratio, at most
8) and one chunk of 256, 128 or 64 rows, the largest that still gives 8
CTAs per SM over the whole cache; a CTA reads its row as D / 8 threads of
16 bytes.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCounter, launches_kernel
from repro_torch.kernels.decode_attn.ref import decode_attention_fused_ref
from repro_torch.models import layers as L

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" \
    / "decode_attention.cu"

HEAD_DIMS = (32, 64, 128, 256)
CHUNKS = (256, 128, 64)
CTAS_PER_SM = 8
PART_WORDS = 4      # m, l and two pad words before each partial's sum

LAUNCHES = LaunchCounter("decode_attn")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C entry typed."""
    from repro_torch.kernels._build import load_library

    lib = load_library(SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention.argtypes = [P, P, P, P, P, P, I, I, P, P, P,
                                     I, I, I, I, I, I, I, I, F, F, P]
    lib.decode_attention.restype = ctypes.c_int
    lib.decode_attn_error_string.argtypes = [I]
    lib.decode_attn_error_string.restype = ctypes.c_char_p
    return lib


def route(dtype: torch.dtype, device, *, ring: bool, kv_dtype) -> str:
    """``"fused"``, ``"attend"`` or ``"plain"`` for a decode step whose
    attention reads ``dtype`` rows on ``device`` (module docstring)."""
    if torch.device(device).type != "cuda" or dtype != torch.bfloat16:
        return "plain"
    return "attend" if ring or kv_dtype == "int8" else "fused"


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, H: int, Hkv: int, n_sm: int):
    """``(R, chunk, n_chunks)`` for these shapes on ``n_sm`` SMs."""
    rep = H // Hkv
    R = min(1 << (rep - 1).bit_length(), 8)
    pairs = B * Hkv * -(-rep // R)
    chunk = next((c for c in CHUNKS
                  if pairs * -(-S // c) >= CTAS_PER_SM * n_sm), CHUNKS[-1])
    return R, chunk, -(-S // chunk)


@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device: torch.device):
    # The plain route's vector, computed by the same code on the same device.
    return L.rope_frequencies(head_dim, theta, device)


def _refuse(msg: str):
    raise ValueError(f"decode_attention: {msg}")


def check_args(q, k_cache, v_cache, pos, k=None, v=None,
               sliding_window=None, logit_softcap=None) -> None:
    """Raise ``ValueError`` on what the kernel does not take.  Each message
    is built only on refusal: this runs in every decode layer."""
    if q.dim() != 3 or k_cache.dim() != 4:
        _refuse(f"q {tuple(q.shape)} must be [B, H, D] and k_cache "
                f"{tuple(k_cache.shape)} [B, S, Hkv, D]")
    B, S, Hkv, D = k_cache.shape
    H = q.shape[1]
    if v_cache.shape != k_cache.shape:
        _refuse(f"v_cache {tuple(v_cache.shape)} != k_cache "
                f"{tuple(k_cache.shape)}")
    if q.shape[0] != B or q.shape[2] != D:
        _refuse(f"q {tuple(q.shape)} does not match the cache "
                f"{tuple(k_cache.shape)}")
    if Hkv == 0 or H % Hkv:
        _refuse(f"H={H} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        _refuse(f"head dim {D}: the kernel takes {HEAD_DIMS}")
    if B == 0 or S == 0:
        _refuse("empty batch or cache")
    if sliding_window is not None and sliding_window < 1:
        _refuse(f"sliding_window={sliding_window}")
    if logit_softcap is not None and logit_softcap <= 0:
        _refuse(f"logit_softcap={logit_softcap}")
    if pos.dtype not in (torch.int64, torch.int32) or pos.dim() > 1 or (
            pos.dim() == 1 and pos.shape[0] != B):
        _refuse(f"positions {pos.dtype} {tuple(pos.shape)}: int64 or int32, "
                f"[] or [{B}]")
    named = (q, k_cache, v_cache) if k is None else (q, k_cache, v_cache, k, v)
    if k is not None and (k.shape != (B, Hkv, D) or v.shape != (B, Hkv, D)):
        _refuse(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                f"[{B}, {Hkv}, {D}]")
    dev = q.device
    for i, t in enumerate(named):
        if t.dtype != torch.bfloat16 or t.device != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            name = ("q", "k_cache", "v_cache", "k", "v")[i]
            _refuse(f"{name} must be bfloat16, contiguous, 16-byte aligned "
                    f"and on {dev}: {t.dtype} on {t.device}, contiguous "
                    f"{t.is_contiguous()}, address {t.data_ptr()}")
    if pos.device != dev:
        _refuse(f"positions on {pos.device}, q on {dev}")


def _launch(q, k, v, k_cache, v_cache, pos, cur_offset, freq,
            sliding_window, logit_softcap):
    check_args(q, k_cache, v_cache, pos, k, v, sliding_window, logit_softcap)
    if pos.dtype == torch.int32:        # the kernel reads int64
        pos = pos.to(torch.int64)
    B, S, Hkv, D = k_cache.shape
    H = q.shape[1]
    R, chunk, n_chunks = plan(B, S, H, Hkv, _sm_count(q.device))
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    part = None if n_chunks == 1 else torch.empty(
        (B, H, n_chunks, PART_WORDS + D), dtype=torch.float32,
        device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        rc = lib.decode_attention(
            q.data_ptr(), None if k is None else k.data_ptr(),
            None if v is None else v.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), pos.data_ptr(), int(pos.dim() == 1),
            cur_offset, None if freq is None else freq.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            B, S, H, Hkv, D, R, chunk, sliding_window or 0, D ** -0.5,
            logit_softcap or 0.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("decode_attention launch failed: "
                           f"{lib.decode_attn_error_string(rc).decode()}")
    LAUNCHES.by_key["decode_attn"] += 1 if part is None else 2
    return out


def decode_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: torch.Tensor, theta: float, *,
                           sliding_window: Optional[int] = None,
                           logit_softcap: Optional[float] = None
                           ) -> torch.Tensor:
    """q [B, H, D]; new rows k, v [B, Hkv, D]; caches [B, S, Hkv, D],
    written in place; ``pos`` int64 or int32, [B] or scalar -> [B, H, D]
    bf16 (the plain version: q's dtype).  Query head ``h`` reads KV head
    ``h // (H // Hkv)``."""
    if launches_kernel("decode_attention_fused", q, None):
        return _launch(q, k, v, k_cache, v_cache, pos, 1,
                       _freqs(q.shape[-1], float(theta), q.device),
                       sliding_window, logit_softcap)
    return decode_attention_fused_ref(q, k, v, k_cache, v_cache, pos, theta,
                                      sliding_window=sliding_window,
                                      logit_softcap=logit_softcap)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos, *,
                     sliding_window: Optional[int] = None,
                     logit_softcap: Optional[float] = None) -> torch.Tensor:
    """:func:`repro_torch.models.layers.decode_attention` (q [B, H, D],
    caches [B, S, Hkv, D], ``cur_pos`` [] or [B] valid rows) on the
    kernel for CUDA tensors."""
    if launches_kernel("decode_attention", q, None):
        cur = torch.as_tensor(cur_pos, device=q.device)
        return _launch(q, None, None, k_cache, v_cache, cur, 0, None,
                       sliding_window, logit_softcap)
    return L.decode_attention(q, k_cache, v_cache, cur_pos,
                              sliding_window=sliding_window,
                              logit_softcap=logit_softcap)
