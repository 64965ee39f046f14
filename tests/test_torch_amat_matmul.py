"""Port parity: the single-matrix AMAT dequant-matmul (``amat_matmul``).

CPU tests hold the plain PyTorch version and the wrapper's CPU path
against the JAX package's wrapper run in Pallas interpret mode, on the
reference's own cases (``tests/test_kernels.py``: its M, K, N shapes x
the three precision modes x f32 and bf16 activations), at atol
1e-4 * max(1, max|ref|).  bf16 activations are cast to f32 exactly on
both sides, so 1e-4 holds for them too.  The ``gpu`` tests hold the CUDA
kernel against the plain version on the card; they decide inside the test
whether a card is present and import nothing of JAX, so they run on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_amat_matmul.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.amat import MatConfig, amat_quantize_stacked
from repro_torch.kernels.amat_matmul import ops as TOPS
from repro_torch.kernels.amat_matmul.ref import (amat_batched_matmul_ref,
                                                 amat_matmul_ref)
from repro_torch.quant.groupquant import quantize

# One intra-op thread per test process: parallel test workers would
# otherwise oversubscribe the cores.
torch.set_num_threads(1)

# The reference's kernel cases (tests/test_kernels.py::SHAPES_MKN).
SHAPES_MKN = [(8, 32, 16), (16, 64, 48), (128, 256, 128), (7, 96, 33),
              (1, 32, 128)]
MODES = [("high", 0), ("low", 4), ("low", 2)]
X_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CASES = [(mkn, mode, shift, xd) for mkn in SHAPES_MKN
         for mode, shift in MODES for xd in X_DTYPES]
CASE_IDS = [f"{m}x{k}x{n}-{mode}{shift}-{xd}"
            for (m, k, n), mode, shift, xd in CASES]


def _inputs(M, K, N, x_dtype, *, seed, device="cpu"):
    """x [M, K] in ``x_dtype`` and the AMAT (8-bit, G32, asymmetric)
    quantization of a [K, N] weight drawn as the reference test draws it."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.1)
                         .astype(np.float32))
    qt = quantize(w.to(device), bits=8, group_size=32, asymmetric=True)
    return x.to(x_dtype).to(device), qt


def _case_inputs(case):
    (M, K, N), _, _, xd = case
    return _inputs(M, K, N, X_DTYPES[xd], seed=M * 1000 + N)


def _jax_amat_matmul(x, qt, *, shift, mode):
    import jax.numpy as jnp

    from repro.kernels.amat_matmul.ops import amat_matmul

    xj = jnp.asarray(x.to(torch.float32).numpy())
    if x.dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)            # exact: already bf16 values
    out = amat_matmul(xj, jnp.asarray(qt.codes.numpy()),
                      jnp.asarray(qt.scales.numpy()),
                      jnp.asarray(qt.zero_points.numpy()), group_size=32,
                      shift=shift, mode=mode, interpret=True)
    return np.asarray(out)


@pytest.fixture(scope="module")
def jax_result():
    """The JAX wrapper's output for a case, computed once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            _, mode, shift, _ = case
            x, qt = _case_inputs(case)
            cache[case] = _jax_amat_matmul(x, qt, shift=shift, mode=mode)
        return cache[case]
    return get


def _assert_matches(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(
        got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_matches_reference(jax_result, case):
    _, mode, shift, _ = case
    x, qt = _case_inputs(case)
    got = amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                          group_size=32, shift=shift, mode=mode)
    _assert_matches(got.numpy(), jax_result(case))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_cpu_wrapper_matches_reference(jax_result, case):
    _, mode, shift, _ = case
    x, qt = _case_inputs(case)
    before = TOPS.LAUNCHES.count
    got = TOPS.amat_matmul_qt(x, qt, shift=shift, mode=mode)
    assert TOPS.LAUNCHES.count == before     # the CPU path launches nothing
    _assert_matches(got.numpy(), jax_result(case))


def test_single_matrix_is_the_batched_function_at_one_expert():
    """What lets the CUDA entry reuse the batched body: 'high' is
    use_lsb = True, 'low' at a shift is use_lsb = False at that shift, and
    'low' at shift 0 truncates nothing."""
    x, qt = _inputs(7, 96, 36, torch.float32, seed=5)
    for mode, shift in MODES + [("low", 0)]:
        single = TOPS.amat_matmul(x, qt.codes, qt.scales, qt.zero_points,
                                  shift=shift, mode=mode)
        batched = TOPS.amat_expert_matmul(
            x[None], qt.codes[None], qt.scales[None], qt.zero_points[None],
            torch.tensor([mode == "high"]), shift=shift)[0]
        torch.testing.assert_close(single, batched, rtol=0, atol=1e-5)
    high = TOPS.amat_matmul(x, qt.codes, qt.scales, qt.zero_points,
                            mode="high")
    low0 = TOPS.amat_matmul(x, qt.codes, qt.scales, qt.zero_points,
                            shift=0, mode="low")
    torch.testing.assert_close(high, low0, rtol=0, atol=0)


def test_column_padding_keeps_the_function():
    """The card wrapper's pad of a ragged N: padded columns give zeros and
    leave the others as they were."""
    x, qt = _inputs(7, 96, 33, torch.float32, seed=2)
    want = amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points)
    codes, scales, zps = TOPS.pad_columns(36, qt.codes, qt.scales,
                                          qt.zero_points)
    assert codes.shape == (96, 36) and scales.shape == zps.shape == (3, 36)
    got = amat_matmul_ref(x, codes, scales, zps)
    torch.testing.assert_close(got[:, :33], want, rtol=0, atol=1e-6)
    assert bool((got[:, 33:] == 0).all())


# --------------------------------------------------------------------------
# The numerics of the tensor-core route (bf16 x, and f32 x as three bf16
# planes), emulated on the CPU.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shift", [0, 1, 2, 3, 4])
def test_every_amat_weight_is_exact_in_bf16(shift):
    """(c >> s) - (z >> s) for every uint8 code c and zero-point z (s = 0 is
    the 'high' weight c - z) is an integer of at most 8 bits: bf16 holds it
    exactly, so the tensor cores multiply the weights the plain version
    uses."""
    c = torch.arange(256, dtype=torch.int32)[:, None]
    z = torch.arange(256, dtype=torch.int32)[None, :]
    w = ((c >> shift) - (z >> shift)).to(torch.float32)
    assert bool((w.to(torch.bfloat16).to(torch.float32) == w).all())


def _mma_route_emulated(x, qt, *, shift, mode, splits):
    """The tensor-core kernel's order in torch: bf16 x (or each bf16 plane
    of f32 x, :func:`split_planes`) times the integer weights of each
    32-row chunk (exact products, f32 sums, the planes into one group
    sum), then the group's scale (times 2^shift in 'low'), each K split
    summed on its own and the splits added in order."""
    K, N = qt.codes.shape
    gs = qt.group_size
    sh = shift if mode == "low" else 0
    planes = (x[None] if x.dtype == torch.bfloat16
              else TOPS.split_planes(x)).to(torch.float32)
    w = ((qt.codes.to(torch.int32) >> sh)
         - (qt.zero_points.to(torch.int32) >> sh)
         .repeat_interleave(gs, 0)).to(torch.float32)
    scale = qt.scales * 2.0 ** sh
    out = None
    for g0, g1 in TOPS.split_groups(K // gs, splits):
        part = torch.zeros((x.shape[0], N))
        for k0 in range(g0 * gs, g1 * gs, 32):
            group_acc = sum(p[:, k0:k0 + 32] @ w[k0:k0 + 32]
                            for p in planes)
            part = part + scale[k0 // gs] * group_acc
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("M", [1, 7, 128])
@pytest.mark.parametrize("mode,shift", [("high", 0), ("low", 4)])
def test_mma_route_order_matches_plain(M, mode, shift):
    """At K=2048 the kernel's order (exact bf16 group products, scale
    after the group, K split as the wrapper plans it) stays within the
    card's tolerance of the plain version."""
    x, qt = _inputs(M, 2048, 64, torch.bfloat16, seed=M)
    _, splits = TOPS.mma_plan(M, 2048, 2816, 32)
    got = _mma_route_emulated(x, qt, shift=shift, mode=mode, splits=splits)
    plain = amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                            shift=shift, mode=mode)
    err = (got - plain).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.abs()).all()), float(err.max())


def _planes_test_values():
    """f32 values drawn from the standard normal, then with every exponent
    from 2^-110 (below it the lo plane falls among bf16's subnormals) to
    2^126, both signs, and the edges of that range."""
    rng = np.random.default_rng(21)
    normal = rng.standard_normal(4096)
    wide = (rng.choice([-1.0, 1.0], 4096) * rng.uniform(1.0, 2.0, 4096)
            * np.exp2(rng.integers(-110, 127, 4096)))
    edges = np.array([0.0, -0.0, 2.0 ** -110, -(2.0 ** -110), 2.0 ** 126,
                      np.nextafter(np.float32(2.0 ** 127), np.float32(0)),
                      1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24, 1.0 / 3.0])
    return torch.from_numpy(
        np.concatenate([normal, wide, edges]).astype(np.float32))


def test_three_bf16_planes_sum_to_x_exactly():
    """hi + mid + lo is f32 x bit for bit: each subtraction is exact and
    at most 8 significant bits are left for lo, so f32 x runs exactly on
    the bf16 tensor cores."""
    x = _planes_test_values()
    planes = TOPS.split_planes(x)
    assert planes.shape == (3, *x.shape) and planes.dtype == torch.bfloat16
    hi, mid, lo = planes.to(torch.float32)
    assert bool((hi + mid + lo == x).all())
    assert bool(((hi + mid) + lo == x).all()) and bool(((lo + mid) + hi == x)
                                                       .all())
    # Two planes are not enough: the third carries bits of most values.
    assert int((hi + mid != x).sum()) > x.numel() // 2


@pytest.mark.parametrize("mode,shift", [("high", 0), ("low", 4)])
def test_plane_route_order_matches_plain(mode, shift):
    """f32 x at M=128, K=2048 as the kernel computes it: three bf16 plane
    products per 32-row chunk into one group sum (each plane.float() @ w
    in f32), the scale after the group, K split as the wrapper plans it
    for three planes; within the card's tolerance of the plain version."""
    x, qt = _inputs(128, 2048, 64, torch.float32, seed=128)
    _, splits = TOPS.mma_plan(128, 2048, 2816, 32, planes=3)
    got = _mma_route_emulated(x, qt, shift=shift, mode=mode, splits=splits)
    plain = amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                            shift=shift, mode=mode)
    err = (got - plain).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.abs()).all()), float(err.max())


@pytest.mark.parametrize("M", [1, 7, 16, 17, 64, 65, 128, 200])
def test_plane_plan_fits_two_blocks_per_sm(M):
    """Three planes take blocks of at most 64 rows (4 m16 tiles, 107 KB
    of shared memory, two per SM; one m16 tile takes 8 rows): the fewest
    tiles that cover min(M, 64), and a K split that still fills the card
    at K=2048."""
    m_tiles, splits = TOPS.mma_plan(M, 2048, 2816, 32, planes=3)
    rows = TOPS.mma_rows(m_tiles, planes=3)
    assert m_tiles in TOPS.PLANES_M_TILES and rows >= min(M, 64)
    assert m_tiles == 1 or TOPS.mma_rows(m_tiles // 2, planes=3) < min(M, 64)
    assert 1 <= splits <= 2048 // 32
    assert splits == 1 or splits * M * 2816 * 4 <= 2 * 2048 * 2816
    blocks = -(-2816 // TOPS.MMA_BN) * -(-M // rows) * splits
    assert blocks >= 2 * 132 or splits == 2048 // (2 * M)


@pytest.mark.parametrize("K", [32, 96, 2048])
@pytest.mark.parametrize("M", [1, 7, 128])
def test_mma_plan_splits_k_in_whole_groups(M, K):
    """The split covers K in whole groups, each split non-empty, and keeps
    the f32 partials within twice the codes' bytes; the block's rows
    cover min(M, 128)."""
    N, gs = 2816, 32
    m_tiles, splits = TOPS.mma_plan(M, K, N, gs)
    assert 16 * m_tiles >= min(M, 128)
    assert m_tiles == 1 or 8 * m_tiles < min(M, 128)
    ranges = TOPS.split_groups(K // gs, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == K // gs
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))
    assert splits == 1 or splits * M * N * 4 <= 2 * K * N
    if K == 2048 and M in (1, 128):     # enough groups to fill the card
        blocks = -(-N // TOPS.MMA_BN) * splits
        assert blocks >= 2 * 132


def test_wrapper_rejects_an_unknown_mode_and_device():
    x, qt = _inputs(2, 32, 8, torch.float32, seed=0)
    with pytest.raises(ValueError, match="mode"):
        TOPS.amat_matmul_qt(x, qt, mode="mid")
    with pytest.raises(ValueError, match="no path for device"):
        TOPS.amat_matmul(x.to("meta"), qt.codes.to("meta"),
                         qt.scales.to("meta"), qt.zero_points.to("meta"))


# --------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version.
# --------------------------------------------------------------------------
# The reference's shapes, then one qwen15-moe-a2.7b expert's ``wi`` at the
# prefill capacity and at one decode token, then M on both sides of the
# tensor-core kernel's 16-row tiles and past its 128-row block, and one
# group of K (no split).
GPU_SHAPES = SHAPES_MKN + [(128, 2048, 2816), (1, 2048, 2816),
                           (16, 2048, 2816), (17, 2048, 2816),
                           (64, 2048, 2816), (200, 2048, 2816),
                           (4, 32, 2816)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("xd", sorted(X_DTYPES))
@pytest.mark.parametrize("mode,shift", MODES + [("low", 0)])
@pytest.mark.parametrize("mkn", GPU_SHAPES, ids=str)
def test_cuda_kernel_matches_plain(cuda_device, mkn, mode, shift, xd):
    M, K, N = mkn
    x, qt = _inputs(M, K, N, X_DTYPES[xd], seed=11, device=cuda_device)
    plain = amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                            shift=shift, mode=mode)
    before = TOPS.LAUNCHES.by_key["single"]
    got = TOPS.amat_matmul_qt(x, qt, shift=shift, mode=mode)
    torch.cuda.synchronize()
    assert TOPS.LAUNCHES.by_key["single"] == before + 1
    assert got.shape == (M, N) and got.dtype == torch.float32
    # f32 accumulation in another order than the plain version's matmul.
    err = (got - plain).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.abs()).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("exponent", [-100, -40, 40, 100])
@pytest.mark.parametrize("mkn", [(128, 2048, 2816), (7, 96, 33)], ids=str)
def test_cuda_f32_route_holds_wide_exponents(cuda_device, mkn, exponent):
    """f32 x with row r scaled by 2^(exponent + e_r), e_r drawn from -8 to
    8: the three bf16 planes carry every bit of x whatever its exponent,
    so each row stays within the tolerance the unscaled row has, 1e-4 *
    2^(exponent + e_r) + 1e-4 * |plain| (a power of two scales the plain
    version exactly)."""
    M, K, N = mkn
    x, qt = _inputs(M, K, N, torch.float32, seed=13, device=cuda_device)
    rows = torch.from_numpy(np.random.default_rng(13).integers(-8, 9, (M, 1))
                            .astype(np.float32)).to(cuda_device)
    row_scale = torch.exp2(rows + exponent)
    x = (x * row_scale).contiguous()
    plain = amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points)
    got = TOPS.amat_matmul_qt(x, qt)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    tol = 1e-4 * row_scale + 1e-4 * plain.abs()
    err = (got - plain).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input(cuda_device):
    x, qt = _inputs(3, 64, 8, torch.float32, seed=0, device=cuda_device)
    args = (qt.codes, qt.scales, qt.zero_points)
    with pytest.raises(ValueError, match="group_size"):
        TOPS.amat_matmul(x, *args, group_size=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TOPS.amat_matmul(x.half(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        TOPS.amat_matmul(x.t().contiguous().t(), *args)
    with pytest.raises(ValueError, match="codes"):
        TOPS.amat_matmul(x, qt.codes[:32], *args[1:])
    # The tensor-core route reads x by 16-byte copies.
    xb = torch.zeros(3 * 64 + 1, dtype=torch.bfloat16,
                     device=cuda_device)[1:].view(3, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TOPS.amat_matmul(xb, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("xd", sorted(X_DTYPES))
@pytest.mark.parametrize("M", [8, 69])
def test_cuda_k1_at_the_flat_wo_shape(cuda_device, M, xd):
    """K1 on K-major ``wo`` codes, the route of the ``quantized_serve``
    tree (no output-major copy): qwen15-moe-a2.7b's ``wo`` (E=60, K=1408,
    N=2048) at the decode (M=8) and 4 x 128-token prefill (M=69)
    capacities, the weights quantized the way ``quantize_params_for_serve``
    quantizes them, half the experts MSB-only."""
    E, K, N = 60, 1408, 2048
    rng = np.random.default_rng(29)
    w = torch.from_numpy((rng.standard_normal((E, K, N)) * K ** -0.5)
                         .astype(np.float32)).to(cuda_device)
    qt = amat_quantize_stacked(w, MatConfig(8, 4))
    del w
    x = torch.from_numpy(rng.standard_normal((E, M, K)).astype(np.float32))
    x = x.to(X_DTYPES[xd]).to(cuda_device)
    use_lsb = torch.arange(E, device=cuda_device) % 2 == 0
    plain = amat_batched_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                                    use_lsb, group_size=32, shift=4)
    before = TOPS.LAUNCHES.by_key["k_major"]
    got = TOPS.amat_expert_matmul_qt(x, qt, use_lsb, shift=4)
    torch.cuda.synchronize()
    assert TOPS.LAUNCHES.by_key["k_major"] == before + 1
    assert got.shape == (E, M, N) and got.dtype == torch.float32
    # f32 accumulation in another order than the plain version's bmm.
    err = (got - plain).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.abs()).all()), float(err.max())
