"""Public wrappers of the fused AMAT dequant-matmuls.

They keep the semantics of the reference wrappers
(``repro/kernels/amat_matmul/ops.py``):

* :func:`amat_expert_matmul`: ``[E, M, K] @ per-expert-dequant([E, K, N]
  codes) -> [E, M, N] f32``, with ``use_lsb [E]`` choosing MSB+LSB or
  MSB-only per expert and ``transposed=True`` reading output-major
  ``[E, N, K]`` codes (the ``wo`` layout);
* :func:`amat_matmul`: one matrix, ``[M, K] @ dequant([K, N] codes) ->
  [M, N] f32`` at a static precision, ``mode='high'`` (MSB+LSB) or
  ``'low'`` (MSB only at ``shift``).

On CUDA tensors each launches a hand-written Hopper kernel
(``csrc/amat_batched_matmul.cu``) or raises: it checks device, dtype,
shape, contiguity and alignment, allocates the output, checks the
launch's return code and adds one to its key of :data:`LAUNCHES`.  On CPU
tensors it runs the plain PyTorch version in :mod:`.ref`.

Every route runs on the tensor cores.  Each weight is an integer of at
most 8 bits, exact in bf16, so each 32-row group's product is exact in
``mma.sync`` bf16 -> f32 and its scale applies after it.

* bf16 ``x`` runs as it is.  :func:`amat_expert_matmul` (and
  ``expert_matmul``) runs one block per expert, 64 columns and
  :func:`mma_m_tiles` rows over the whole of K, on either code layout.
  :func:`amat_matmul` splits K across blocks in whole groups at small M
  (:func:`mma_plan`) and a second kernel sums the splits in order; the
  call still counts one launch;
* f32 ``x`` runs the same kernels on three bf16 planes of x, ``hi =
  bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``, which
  sum to x exactly (:func:`split_planes` is their plain version), written
  by a split pass into ``[3, *x.shape]`` scratch the wrapper allocates;
  each plane's product with the integer weights is exact in f32, so only
  the order of the f32 sums differs from the plain version.  In the
  batched kernels this is the parity mode of the engine's f32 models.

Every wrapper takes the reference's tile keywords ``bm``, ``bn``, ``bk``
(with its defaults) and ``interpret``.  They choose no tile: on the card
:func:`mma_m_tiles` and :func:`mma_plan` choose the tiling from the
shapes, and the plain version has none, so the output does not depend on
them.  ``interpret`` chooses the route
(:func:`repro_torch.kernels._build.launches_kernel`): ``None`` by the
device, ``True`` the plain version (CPU tensors only), ``False`` the
kernel (CUDA tensors only).

The kernels mask ragged M and N themselves.  Their metadata loads take
16 columns at a time, so :func:`launch`, the one launch path of every
wrapper here and of ``expert_matmul``, pads a ragged N to a multiple of
16 (zero scales null the pad).  No model shape has such an N, so the copy
never runs on them.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import LaunchCounter, launches_kernel
from repro_torch.kernels.amat_matmul.ref import (amat_batched_matmul_ref,
                                                 amat_batched_matmul_t_ref,
                                                 amat_matmul_ref)

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" \
    / "amat_batched_matmul.cu"

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# k_major: ``wi`` (K-major codes); output_major: ``wo`` (transposed);
# single: the one-matrix kernel of :func:`amat_matmul`.
LAUNCHES = LaunchCounter("k_major", "output_major", "single")

MODES = ("high", "low")

# The kernels' block: 64 columns and 16 * m_tiles rows; with the three
# planes of f32 x, whose x tiles take three times the shared memory, at
# most 4 m16 tiles, and one m16 tile takes 8 rows of x (its planes packed
# into two m16 tiles, :func:`mma_rows`).
MMA_BN = 64
MMA_M_TILES = (1, 2, 4, 8)
PLANES_M_TILES = (1, 2, 4)
# Blocks per SM that :func:`mma_plan` aims its K split at: two of the
# largest blocks (77 KB of shared memory at 128 rows of one plane, 107 KB
# at 64 rows of three) fit on an SM.
MMA_BLOCKS_PER_SM = 2
# The planes of f32 x.
X_PLANES = 3


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C entries typed."""
    from repro_torch.kernels._build import load_library

    return bind(load_library(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the C entries of ``lib``, built from :data:`SOURCE` or from a
    variant of it with the same entries."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.amat_batched_matmul.argtypes = [P, I, P, P, P, P, P, P,
                                        I, I, I, I, I, I, I, I, P]
    lib.amat_single_matmul.argtypes = [P, I, P, P, P, P, P, P,
                                       I, I, I, I, I, I, I, I, P]
    for fn in (lib.amat_batched_matmul, lib.amat_single_matmul):
        fn.restype = ctypes.c_int
    lib.amat_error_string.argtypes = [I]
    lib.amat_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_error(rc: int, entry: str) -> None:
    if rc != 0:
        msg = library().amat_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg}")


def stream_of(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def mma_rows(m_tiles: int, planes: int = 1) -> int:
    """The rows of x a block of ``m_tiles`` m16 tiles covers: 16 per tile,
    but 8 for one tile of three planes, whose hi and mid planes share one
    m16 tile and lo takes a second."""
    return 8 if planes > 1 and m_tiles == 1 else 16 * m_tiles


def mma_m_tiles(M: int, planes: int = 1) -> int:
    """The m16 tiles of a tensor-core block for ``M`` rows of x in
    ``planes`` planes: the fewest of :data:`MMA_M_TILES` (one plane) or
    :data:`PLANES_M_TILES` (three) whose block covers ``min(M, rows of the
    largest)`` (:func:`mma_rows`): 128 rows of one plane, 64 of three."""
    tiles = MMA_M_TILES if planes == 1 else PLANES_M_TILES
    rows = min(M, mma_rows(tiles[-1], planes))
    return next(t for t in tiles if mma_rows(t, planes) >= rows)


def mma_plan(M: int, K: int, N: int, group_size: int, sms: int = 132,
             planes: int = 1):
    """``(m_tiles, splits)`` of the single-matrix tensor-core kernel for x
    [M, K] in ``planes`` planes and codes [K, N]: :func:`mma_m_tiles`, and
    the split of K that brings the grid to :data:`MMA_BLOCKS_PER_SM`
    blocks per SM (one wave), at most one split per group and at most as
    many as keep the f32 partials (``splits * M * N * 4`` bytes) within
    twice the codes' ``K * N`` bytes."""
    m_tiles = mma_m_tiles(M, planes)
    blocks = -(-N // MMA_BN) * -(-M // mma_rows(m_tiles, planes))
    want = -(-MMA_BLOCKS_PER_SM * sms // blocks)
    cap = K // (2 * M)
    return m_tiles, max(1, min(want, cap, K // group_size))


def split_planes(x):
    """f32 ``x`` as ``[3, *x.shape]`` bf16 planes ``hi = bf16(x)``, ``mid
    = bf16(x - hi)``, ``lo = bf16(x - hi - mid)`` (round to nearest even):
    the plain version of the kernels' split pass.  Each subtraction is
    exact in f32 and at most 8 significant bits are left for ``lo``, so
    the planes sum to ``x`` exactly (subnormals aside)."""
    rest = x.to(torch.float32)
    planes = []
    for _ in range(X_PLANES):
        plane = rest.to(torch.bfloat16)
        rest = rest - plane.to(torch.float32)
        planes.append(plane)
    return torch.stack(planes)


def split_groups(n_groups: int, splits: int):
    """The ``[begin, end)`` quantization groups of each split, as the
    kernel cuts them (split ``s`` from ``s * G // splits``)."""
    return [(s * n_groups // splits, (s + 1) * n_groups // splits)
            for s in range(splits)]


def check_operands(who: str, x, codes, scales, zps, *, group_size: int,
                   codes_shape, meta_shape, use_lsb=None):
    """Raise ``ValueError`` on what the kernel does not take.  Returns
    ``use_lsb`` as bool."""
    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"{who}: {msg}")

    K = x.shape[-1]
    dev = x.device
    named = [("x", x), ("codes", codes), ("scales", scales), ("zps", zps)]
    if use_lsb is not None:
        named.append(("use_lsb", use_lsb))
    for name, t in named[1:]:
        check(t.device == dev, f"{name} on {t.device}, x on {dev}")
    check(x.dtype in X_DTYPES,
          f"x dtype {x.dtype}: the kernel takes float32 or bfloat16")
    check(codes.dtype == torch.uint8, f"codes dtype {codes.dtype}")
    check(scales.dtype == torch.float32, f"scales dtype {scales.dtype}")
    check(zps.dtype == torch.uint8, f"zps dtype {zps.dtype}")
    check(group_size % 32 == 0 and K % group_size == 0,
          f"K={K} and group_size={group_size}: the kernel needs "
          "group_size % 32 == 0 and K % group_size == 0")
    check(tuple(codes.shape) == tuple(codes_shape),
          f"codes {tuple(codes.shape)} != {tuple(codes_shape)}")
    check(tuple(scales.shape) == tuple(meta_shape),
          f"scales {tuple(scales.shape)}")
    check(tuple(zps.shape) == tuple(meta_shape), f"zps {tuple(zps.shape)}")
    if use_lsb is not None:
        check(tuple(use_lsb.shape) == (x.shape[0],),
              f"use_lsb {tuple(use_lsb.shape)}")
    for name, t in named:
        check(t.is_contiguous(), f"{name} is not contiguous")
    check(codes.data_ptr() % 16 == 0, "codes are not 16-byte aligned")
    if use_lsb is not None and use_lsb.dtype != torch.bool:
        use_lsb = use_lsb != 0
    return use_lsb


def pad_columns(n_to: int, codes, scales, zps, *, transposed: bool = False):
    """Zero-pad the N dimension of codes (the last, or the rows of
    output-major ``[..., N, K]`` codes when ``transposed``) and the last
    of the metadata to ``n_to`` columns.  A padded column has scale 0, so
    its weights are 0 and its output columns, which the caller drops, are
    0."""
    pad = n_to - scales.shape[-1]
    codes = F.pad(codes, (0, 0, 0, pad) if transposed else (0, pad))
    return (codes, *(F.pad(t, (0, pad)) for t in (scales, zps)))


def launch(who: str, counter: LaunchCounter, key: str, x, codes, scales,
           zps, use_lsb, *, group_size: int, shift: int,
           transposed: bool = False, high: bool = False):
    """Check the operands, pad a ragged N to a multiple of 16, launch the
    kernel on ``x``'s card and add one to ``counter``'s ``key``.  ``x`` is
    ``[E, M, K]`` with ``use_lsb [E]`` (C entry ``amat_batched_matmul``)
    or ``[M, K]`` with ``use_lsb=None`` and the static precision ``high``
    (C entry ``amat_single_matmul``).  f32 x gets the scratch of its
    three bf16 planes here."""
    *lead, M, K = x.shape
    N = codes.shape[-2] if transposed else codes.shape[-1]
    use_lsb = check_operands(
        who, x, codes, scales, zps, group_size=group_size,
        codes_shape=(*lead, N, K) if transposed else (*lead, K, N),
        meta_shape=(*lead, K // group_size, N), use_lsb=use_lsb)
    single = use_lsb is None
    for name, t in (("x", x), ("scales", scales), ("zps", zps)):
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    n_pad = -N % 16
    if n_pad:
        codes, scales, zps = pad_columns(N + n_pad, codes, scales, zps,
                                         transposed=transposed)
    out = torch.empty((*lead, M, N + n_pad), dtype=torch.float32,
                      device=x.device)
    if out.numel():
        lib = library()
        ptrs = (x.data_ptr(), X_DTYPES[x.dtype], codes.data_ptr(),
                scales.data_ptr(), zps.data_ptr())
        planes = X_PLANES if x.dtype == torch.float32 else 1
        x_planes = torch.empty(
            (planes, *x.shape), dtype=torch.bfloat16,
            device=x.device) if planes > 1 else None
        planes_ptr = None if x_planes is None else x_planes.data_ptr()
        with torch.cuda.device(x.device):
            if single:
                sms = torch.cuda.get_device_properties(
                    x.device).multi_processor_count
                m_tiles, splits = mma_plan(M, K, N + n_pad, group_size, sms,
                                           planes)
                partials = torch.empty(
                    (splits, M, N + n_pad), dtype=torch.float32,
                    device=x.device) if splits > 1 else None
                rc = lib.amat_single_matmul(
                    *ptrs, out.data_ptr(),
                    None if partials is None else partials.data_ptr(),
                    planes_ptr, m_tiles, splits, M, K, N + n_pad, group_size,
                    shift, int(high), stream_of(x.device))
            else:
                rc = lib.amat_batched_matmul(
                    *ptrs, use_lsb.data_ptr(), out.data_ptr(), planes_ptr,
                    mma_m_tiles(M, planes), lead[0], M, K, N + n_pad,
                    group_size, shift, int(transposed), stream_of(x.device))
        raise_on_error(rc, who)
        counter.by_key[key] += 1
    return out[..., :N].contiguous() if n_pad else out


def amat_expert_matmul(x, codes, scales, zps, use_lsb, *,
                       group_size: int = 32, shift: int = 4,
                       transposed: bool = False,
                       bm: int = 128, bn: int = 128, bk: int = 128,
                       interpret=None):
    """[E, M, K] @ per-expert-dequant([E, K, N] codes) -> [E, M, N] f32.

    ``use_lsb`` [E] selects MSB+LSB (high-bit) vs MSB-only dequant per
    expert.  ``transposed=True`` reads output-major codes ``[E, N, K]``
    with the metadata still K-major ``[E, K//G, N]``.  On the card both
    types of ``x`` run on the tensor cores, f32 ``x`` as three exact bf16
    planes.  ``bm`` / ``bn`` / ``bk`` choose no tile and ``interpret``
    the route (module docstring).
    """
    if launches_kernel("amat_expert_matmul", x, interpret):
        return launch("amat_expert_matmul", LAUNCHES,
                      "output_major" if transposed else "k_major", x, codes,
                      scales, zps, use_lsb, group_size=group_size,
                      shift=shift, transposed=transposed)
    ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref
    return ref(x, codes, scales, zps, use_lsb, group_size=group_size,
               shift=shift)


def amat_expert_matmul_qt(x, qt, use_lsb, *, shift: int, **kw):
    """QuantizedTensor convention for the batched expert kernel; ``kw``
    goes to :func:`amat_expert_matmul`."""
    if not qt.asymmetric:
        raise ValueError("AMAT kernel expects asymmetric group quant")
    return amat_expert_matmul(x, qt.codes, qt.scales, qt.zero_points,
                              use_lsb, group_size=qt.group_size, shift=shift,
                              **kw)


def amat_expert_matmul_t(x, codes_t, scales, zps, use_lsb, *, shift: int,
                         group_size: int = 32, **kw):
    """Transposed-weight entry point: codes_t [E, N, K] output-major;
    ``kw`` goes to :func:`amat_expert_matmul`."""
    return amat_expert_matmul(x, codes_t, scales, zps, use_lsb,
                              group_size=group_size, shift=shift,
                              transposed=True, **kw)


def amat_matmul(x, codes, scales, zps, *, group_size: int = 32,
                shift: int = 0, mode: str = "high",
                bm: int = 128, bn: int = 128, bk: int = 128,
                interpret=None):
    """x [M, K] @ dequant(codes [K, N]) -> [M, N] f32.

    On the card both types of ``x`` run on the tensor cores, f32 ``x`` as
    three exact bf16 planes.  ``mode='high'`` dequantizes ``(c - z) * s``
    and ignores ``shift``; ``mode='low'`` the MSB-only ``(c >> shift - z
    >> shift) * s * 2^shift``.  scales / zps are ``[K // group_size,
    N]``.  ``bm`` / ``bn`` / ``bk`` choose no tile and ``interpret`` the
    route (module docstring).
    """
    if mode not in MODES:
        raise ValueError(f"amat_matmul: mode {mode!r} is not one of {MODES}")
    if launches_kernel("amat_matmul", x, interpret):
        return launch("amat_matmul", LAUNCHES, "single", x, codes, scales,
                      zps, None, group_size=group_size, shift=shift,
                      high=mode == "high")
    return amat_matmul_ref(x, codes, scales, zps, group_size=group_size,
                           shift=shift, mode=mode)


def amat_matmul_qt(x, qt, *, shift: int = 0, mode: str = "high", **kw):
    """QuantizedTensor convention for the single-matrix kernel; ``kw``
    goes to :func:`amat_matmul`."""
    if not qt.asymmetric:
        raise ValueError("AMAT kernel expects asymmetric group quant")
    return amat_matmul(x, qt.codes, qt.scales, qt.zero_points,
                       group_size=qt.group_size, shift=shift, mode=mode,
                       **kw)
