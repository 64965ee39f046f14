"""Port parity: the batched-expert AMAT dequant-matmul.

CPU tests hold the plain PyTorch version (and the wrapper's CPU path)
against the JAX package's wrapper run in Pallas interpret mode, at the
reference's kernel tolerance (atol 1e-4, tests/test_kernels.py).  The
``gpu`` tests hold the CUDA kernel against the plain version on the card;
they decide inside the test whether a card is present and import nothing
of JAX, so they run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.amat import MatConfig, amat_quantize
from repro_torch.kernels.amat_matmul import ops as TOPS
from repro_torch.kernels.amat_matmul.ref import (amat_batched_matmul_ref,
                                                 amat_batched_matmul_t_ref)

# The port's CPU ops are small here; one intra-op thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

# (E, M, K, N): qwen15-moe-repro wi / wo at decode capacity, a ragged case,
# and an N that is not a multiple of 4 (the card wrapper pads K-major codes).
CASES = {
    "repro_wi": (60, 8, 256, 128),
    "repro_wo": (60, 8, 64, 256),
    "ragged": (3, 5, 96, 72),
    "ragged_n": (3, 5, 96, 70),
}


def _inputs(E, M, K, N, *, seed, transposed, device="cpu"):
    """[x, codes, scales, zps, use_lsb] on ``device``: expert weights drawn
    as the model draws them (normal at fan-in scale) and AMAT-quantized
    there, so the codes, scales and zero-points have the distribution the
    main path feeds the kernel; a mixed per-expert precision."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((E, M, K)).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32))
    use_lsb = rng.random(E) < 0.5
    use_lsb[0], use_lsb[-1] = True, False
    qt = amat_quantize(w.to(device), MatConfig(8, 4))
    codes = qt.codes.transpose(1, 2).contiguous() if transposed else qt.codes
    return [x.to(device), codes, qt.scales, qt.zero_points,
            torch.from_numpy(use_lsb).to(device)]


def _jax_wrapper(args, transposed):
    import jax.numpy as jnp

    from repro.kernels.amat_matmul.ops import amat_expert_matmul

    x, codes, scales, zps, use_lsb = (jnp.asarray(a) for a in args)
    out = amat_expert_matmul(x, codes, scales, zps, use_lsb, group_size=32,
                             shift=4, transposed=transposed, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("transposed", [False, True], ids=["wi", "wo_t"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_and_cpu_wrapper_match_reference(case, transposed):
    E, M, K, N = CASES[case]
    args = _inputs(E, M, K, N, seed=7, transposed=transposed)
    want = _jax_wrapper([a.numpy() for a in args], transposed)
    ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref
    plain = ref(*args, group_size=32, shift=4).numpy()
    before = TOPS.LAUNCHES.count
    got = TOPS.amat_expert_matmul(*args, group_size=32, shift=4,
                                  transposed=transposed).numpy()
    assert TOPS.LAUNCHES.count == before     # the CPU path launches nothing
    assert got.shape == (E, M, N) and got.dtype == np.float32
    np.testing.assert_allclose(plain, want, atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_transposed_equals_untransposed_on_swapped_codes():
    E, M, K, N = CASES["ragged"]
    x, codes, scales, zps, use_lsb = _inputs(E, M, K, N, seed=3,
                                             transposed=False)
    codes_t = codes.transpose(1, 2).contiguous()
    a = TOPS.amat_expert_matmul(x, codes, scales, zps, use_lsb)
    b = TOPS.amat_expert_matmul(x, codes_t, scales, zps, use_lsb,
                                transposed=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_rejects_an_unsupported_device():
    args = [a.to("meta") for a in _inputs(2, 3, 32, 8, seed=0,
                                            transposed=False)]
    with pytest.raises(ValueError, match="no path for device"):
        TOPS.amat_expert_matmul(*args)


# --------------------------------------------------------------------------
# The numerics of the tensor-core routes, emulated on the CPU.
# --------------------------------------------------------------------------
def _mma_route_emulated(x, codes, scales, zps, use_lsb, *, transposed,
                        shift=4, group_size=32):
    """The tensor-core kernel's order in torch, expert by expert: the bf16
    planes of x (bf16 x itself, or the three exact planes of f32 x,
    ``TOPS.split_planes``) times the exact integer weights ``(c >> sh) -
    (z >> sh)`` of each 32-row chunk (exact products, f32 sums), every
    plane into one group sum, then the group's scale times 2^sh (sh = 0
    where ``use_lsb``, else ``shift``), over the whole K in one pass (no
    split)."""
    E, M, K = x.shape
    out = []
    for e in range(E):
        c = (codes[e].T if transposed else codes[e]).to(torch.int32)
        sh = 0 if bool(use_lsb[e]) else shift
        z = (zps[e].to(torch.int32) >> sh).repeat_interleave(group_size, 0)
        w = ((c >> sh) - z).to(torch.float32)
        scale = scales[e] * 2.0 ** sh
        planes = (TOPS.split_planes(x[e]) if x.dtype == torch.float32
                  else x[e][None]).to(torch.float32)
        acc = torch.zeros((M, c.shape[1]))
        for k0 in range(0, K, 32):
            group = sum(p[:, k0:k0 + 32] @ w[k0:k0 + 32] for p in planes)
            acc = acc + scale[k0 // group_size] * group
        out.append(acc)
    return torch.stack(out)


@pytest.mark.parametrize("M", [1, 8, 11])
@pytest.mark.parametrize("transposed", [False, True], ids=["wi", "wo_t"])
def test_mma_route_order_matches_plain(transposed, M):
    """At qwen15-moe-a2.7b's depths (``wi`` K=2048, ``wo`` K=1408) the
    kernel's order holds the card's tolerance against the plain version,
    with a mixed per-expert precision; M is one token, the decode
    capacity (8) and the prefill capacity (11)."""
    K = 1408 if transposed else 2048
    args = _inputs(4, M, K, 48, seed=M, transposed=transposed)
    args[0] = args[0].to(torch.bfloat16)
    assert 0 < int(args[4].sum()) < 4           # both precisions occur
    got = _mma_route_emulated(*args, transposed=transposed)
    ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref
    plain = ref(*args, group_size=32, shift=4)
    err = (got - plain).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.abs()).all()), float(err.max())


@pytest.mark.parametrize("M", [1, 8, 18])
@pytest.mark.parametrize("transposed", [False, True], ids=["wi", "wo_t"])
def test_planes_route_order_matches_plain(transposed, M):
    """The f32 route: three exact bf16 planes of x, each plane's product
    with the integer weights of a 32-row chunk into one group sum, then
    the group's scale.  At qwen15-moe-a2.7b's depths (``wi`` K=2048,
    ``wo`` K=1408) it holds the card's tolerance against the plain
    version, with a mixed per-expert precision; M is one token, the
    decode capacity (8) and the prefill capacity (18, two m16 tiles)."""
    K = 1408 if transposed else 2048
    args = _inputs(4, M, K, 48, seed=20 + M, transposed=transposed)
    assert args[0].dtype == torch.float32
    assert 0 < int(args[4].sum()) < 4           # both precisions occur
    planes = TOPS.split_planes(args[0])
    assert planes.shape == (TOPS.X_PLANES, 4, M, K)
    torch.testing.assert_close(planes.to(torch.float32).sum(0), args[0],
                               rtol=0, atol=0)
    got = _mma_route_emulated(*args, transposed=transposed)
    ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref
    plain = ref(*args, group_size=32, shift=4)
    err = (got - plain).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.abs()).all()), float(err.max())


@pytest.mark.parametrize("transposed", [False, True], ids=["wi", "wo_t"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_planes_route_matches_reference(case, transposed):
    """The emulated f32 route against the JAX package's wrapper (Pallas
    interpret mode) on the file's cases, at the reference's kernel
    tolerance."""
    E, M, K, N = CASES[case]
    args = _inputs(E, M, K, N, seed=7, transposed=transposed)
    want = _jax_wrapper([a.numpy() for a in args], transposed)
    got = _mma_route_emulated(*args, transposed=transposed).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("transposed", [False, True], ids=["wi", "wo_t"])
def test_column_padding_keeps_the_function(transposed):
    """The card wrapper's pad of a ragged N to the tensor-core kernel's 16
    columns, on both layouts: padded columns give zeros and leave the
    others as they were."""
    E, M, K, N = CASES["ragged_n"]
    x, codes, scales, zps, use_lsb = _inputs(E, M, K, N, seed=5,
                                             transposed=transposed)
    ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref
    want = ref(x, codes, scales, zps, use_lsb)
    padded = TOPS.pad_columns(80, codes, scales, zps, transposed=transposed)
    assert padded[0].shape == ((E, 80, K) if transposed else (E, K, 80))
    assert padded[1].shape == padded[2].shape == (E, K // 32, 80)
    got = ref(x, *padded, use_lsb)
    torch.testing.assert_close(got[..., :N], want, rtol=0, atol=0)
    assert bool((got[..., N:] == 0).all())


@pytest.mark.parametrize("M", [1, 8, 11, 16, 17, 33, 64, 65, 128, 200])
def test_mma_m_tiles_is_the_fewest_covering(M):
    """A block of 16 * m_tiles rows covers min(M, 128), and no smaller
    choice would."""
    m_tiles = TOPS.mma_m_tiles(M)
    rows = min(M, 128)
    assert m_tiles in TOPS.MMA_M_TILES and 16 * m_tiles >= rows
    assert all(16 * t < rows for t in TOPS.MMA_M_TILES if t < m_tiles)


@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 18, 33, 64, 65, 200])
def test_planes_m_tiles_is_the_fewest_covering(M):
    """With the three planes of f32 x the batched kernel's block covers
    min(M, 64), the most that three planes' x tiles allow, and no smaller
    choice would; one m16 tile of three planes covers 8 rows (hi and mid
    packed into one tile's rows), more tiles 16 rows each."""
    planes = TOPS.X_PLANES
    m_tiles = TOPS.mma_m_tiles(M, planes=planes)
    rows = min(M, 64)
    assert [TOPS.mma_rows(t, planes) for t in TOPS.PLANES_M_TILES] \
        == [8, 32, 64]
    assert m_tiles in TOPS.PLANES_M_TILES
    assert TOPS.mma_rows(m_tiles, planes) >= rows
    assert all(TOPS.mma_rows(t, planes) < rows
               for t in TOPS.PLANES_M_TILES if t < m_tiles)


# --------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version.
# --------------------------------------------------------------------------
# On the card also: qwen15-moe-a2.7b's shapes at the decode and prefill
# capacities, M past the kernel's largest block (two 128-row tiles with
# bf16 x, four 64-row tiles of three planes with f32 x), and every expert
# at one precision.
GPU_CASES = dict(CASES, full_wi=(60, 8, 2048, 2816), full_wo=(60, 8, 1408, 2048),
                 prefill_wi=(60, 18, 2048, 2816),
                 prefill_wo=(60, 18, 1408, 2048),
                 two_row_tiles=(4, 200, 2048, 256),
                 all_lsb=(6, 8, 1408, 256), no_lsb=(6, 8, 1408, 256))
UNIFORM_LSB = {"all_lsb": True, "no_lsb": False}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transposed", [False, True], ids=["wi", "wo_t"])
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_kernel_matches_plain(cuda_device, case, transposed, x_dtype):
    E, M, K, N = GPU_CASES[case]
    args = _inputs(E, M, K, N, seed=11, transposed=transposed,
                   device=cuda_device)
    args[0] = args[0].to(x_dtype)
    if case in UNIFORM_LSB:
        args[4].fill_(UNIFORM_LSB[case])
    ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref
    plain = ref(*args, group_size=32, shift=4)
    before = TOPS.LAUNCHES.count
    got = TOPS.amat_expert_matmul(*args, group_size=32, shift=4,
                                  transposed=transposed)
    torch.cuda.synchronize()
    assert TOPS.LAUNCHES.count == before + 1
    assert got.shape == (E, M, N) and got.dtype == torch.float32
    # f32 accumulation in another order than the plain version's bmm.
    tol = 1e-4 + 1e-4 * plain.abs()
    err = (got - plain).abs()
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input(cuda_device):
    args = _inputs(2, 3, 64, 8, seed=0, transposed=False, device=cuda_device)
    with pytest.raises(ValueError, match="group_size"):
        TOPS.amat_expert_matmul(*args, group_size=16)
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        TOPS.amat_expert_matmul(*bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TOPS.amat_expert_matmul(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="use_lsb"):
        TOPS.amat_expert_matmul(*args[:4], args[4][:1])
    # The tensor-core route reads x by 16-byte copies: a bf16 view 2 bytes
    # off alignment is refused on both layouts, and nothing is launched.
    xb = torch.zeros(2 * 3 * 64 + 1, dtype=torch.bfloat16,
                     device=cuda_device)[1:].view(2, 3, 64)
    codes_t = args[1].transpose(1, 2).contiguous()
    before = TOPS.LAUNCHES.count
    for codes, transposed in ((args[1], False), (codes_t, True)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            TOPS.amat_expert_matmul(xb, codes, *args[2:],
                                    transposed=transposed)
    assert TOPS.LAUNCHES.count == before


@pytest.mark.gpu
@pytest.mark.parametrize("exponent", [-100, -40, 40, 100])
@pytest.mark.parametrize("M", [8, 18])
@pytest.mark.parametrize("transposed", [False, True], ids=["wi", "wo_t"])
def test_cuda_f32_route_holds_wide_exponents(cuda_device, transposed, M,
                                             exponent):
    """f32 x with row r of expert e scaled by 2^(exponent + e_r), e_r drawn
    from -8 to 8: the three bf16 planes carry every bit of x whatever its
    exponent, so each row stays within the tolerance the unscaled row has,
    1e-4 * 2^(exponent + e_r) + 1e-4 * |plain| (a power of two scales the
    plain version exactly).  qwen15-moe-a2.7b's depths at the decode
    capacity (one m16 tile: the planes packed into two) and the prefill
    capacity (two m16 tiles)."""
    E, K, N = (4, 1408, 256) if transposed else (4, 2048, 256)
    args = _inputs(E, M, K, N, seed=13, transposed=transposed,
                   device=cuda_device)
    rows = torch.from_numpy(np.random.default_rng(13).integers(
        -8, 9, (E, M, 1)).astype(np.float32)).to(cuda_device)
    row_scale = torch.exp2(rows + exponent)
    args[0] = (args[0] * row_scale).contiguous()
    ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref
    plain = ref(*args, group_size=32, shift=4)
    got = TOPS.amat_expert_matmul(*args, group_size=32, shift=4,
                                  transposed=transposed)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    tol = 1e-4 * row_scale + 1e-4 * plain.abs()
    err = (got - plain).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.gpu
def test_cuda_f32_route_refuses_misaligned_x(cuda_device):
    """The split pass reads f32 x by 16-byte loads: a contiguous f32 view 4
    bytes off alignment is refused on both layouts before any launch."""
    args = _inputs(2, 3, 64, 16, seed=0, transposed=False,
                   device=cuda_device)
    xf = torch.zeros(2 * 3 * 64 + 1, dtype=torch.float32,
                     device=cuda_device)[1:].view(2, 3, 64)
    assert xf.is_contiguous() and xf.data_ptr() % 16
    codes_t = args[1].transpose(1, 2).contiguous()
    before = TOPS.LAUNCHES.count
    for codes, transposed in ((args[1], False), (codes_t, True)):
        with pytest.raises(ValueError, match="x is not 16-byte aligned"):
            TOPS.amat_expert_matmul(xf, codes, *args[2:],
                                    transposed=transposed)
    assert TOPS.LAUNCHES.count == before
