"""Port parity: flash attention (causal, GQA, optional sliding window).

CPU tests hold the plain PyTorch version and the wrapper's CPU path
against the JAX package's wrapper run in Pallas interpret mode (with the
reference test's 8 x 8 tiles), on the reference's own cases
(``tests/test_kernels.py::TestFlashAttention``), at atol
1e-4 * max(1, max|ref|).  The ``gpu`` tests hold the CUDA kernel against
the plain version on the card; they decide inside the test whether a card
is present and import nothing of JAX, so they run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_attn.py

Every case keeps a visible key for every query row: rows without one are
outside the contract (``repro_torch/kernels/flash_attn/ref.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import ops as TOPS
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

# One intra-op thread per test process: parallel test workers would
# otherwise oversubscribe the cores.
torch.set_num_threads(1)

# The reference's cases: (B, Sq, Sk, H, Hkv, D, causal, window).
DIMS = [(1, 16, 16, 4, 2, 32, True, None),
        (2, 24, 40, 8, 2, 32, True, None),
        (1, 17, 33, 4, 4, 64, True, 8),      # ragged + sliding window
        (1, 16, 16, 4, 2, 32, False, None)]  # non-causal (encoder)


def _inputs(B, Sq, Sk, H, Hkv, D, *, seed, dtype=torch.float32,
            device="cpu"):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype).to(device)
               for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    return q, k, v


def _case_inputs(dims):
    return _inputs(*dims[:6], seed=sum(dims[:6]))


@pytest.fixture(scope="module")
def jax_result():
    """The JAX wrapper's output (interpret mode, 8 x 8 tiles) for a case,
    computed once per module."""
    cache = {}

    def get(dims):
        if dims not in cache:
            import jax.numpy as jnp

            from repro.kernels.flash_attn.ops import flash_attention

            q, k, v = _case_inputs(dims)
            out = flash_attention(
                *(jnp.asarray(t.numpy()) for t in (q, k, v)),
                causal=dims[6], sliding_window=dims[7], bq=8, bk=8,
                interpret=True)
            cache[dims] = np.asarray(out)
        return cache[dims]
    return get


def _assert_matches(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(
        got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_plain_matches_reference(jax_result, dims):
    q, k, v = _case_inputs(dims)
    got = flash_attention_ref(q, k, v, causal=dims[6],
                              sliding_window=dims[7])
    _assert_matches(got.numpy(), jax_result(dims))


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_cpu_wrapper_matches_reference(jax_result, dims):
    q, k, v = _case_inputs(dims)
    before = TOPS.LAUNCHES.count
    got = TOPS.flash_attention(q, k, v, causal=dims[6],
                               sliding_window=dims[7])
    assert TOPS.LAUNCHES.count == before     # the CPU path launches nothing
    _assert_matches(got.numpy(), jax_result(dims))


@pytest.mark.parametrize("window", [None, 300])
def test_plain_matches_the_oracle_across_query_chunks(window):
    """The plain version works through the query rows 1024 at a time (so
    that the full-width shapes fit on the card); with more rows than that
    it still computes the reference oracle's function."""
    import jax.numpy as jnp

    from repro.kernels.flash_attn.ref import flash_attention_ref as oracle

    q, k, v = _inputs(1, 1030, 1030, 2, 1, 16, seed=8)
    want = oracle(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                  sliding_window=window)
    got = flash_attention_ref(q, k, v, sliding_window=window)
    _assert_matches(got.numpy(), np.asarray(want))


def test_gqa_query_head_reads_kv_head_h_div_rep():
    """Query head h reads KV head h // rep, as the reference's (hkv, rep)
    reshape does: heads 0-1 of a 4-head, 2-KV-head case see KV head 0."""
    q, k, v = _inputs(1, 6, 6, 4, 2, 16, seed=9)
    out = flash_attention_ref(q, k, v)
    for h in range(4):
        one = flash_attention_ref(q[:, :, h:h + 1], k[:, :, h // 2:h // 2 + 1],
                                  v[:, :, h // 2:h // 2 + 1])
        torch.testing.assert_close(out[:, :, h:h + 1], one, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# The numerics of the tensor-core kernels (bf16 inputs; f32 inputs in
# 3xTF32), emulated on the CPU.
# --------------------------------------------------------------------------
def _exact_qk(qt, kt):
    return torch.einsum("bqhd,bkhd->bhqk", qt, kt)


def _tiled_kernel_emulated(q, k, v, *, causal, window, bk, qk, pv):
    """The kernels' tiling and softmax in torch: blocks of 64 query rows,
    the key tiles of ``bk`` they visit, ``qk(q_tile, k_tile)`` the f32
    scores [B, H, rows, keys] before the scale, the scale on the f32
    score, -1e30 where masked, an online softmax in f32, and ``pv(p,
    v_tile)`` the tile's p.v [B, H, rows, D]."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.to(torch.float32)
    kf, vf = (t.to(torch.float32).repeat_interleave(rep, 2) for t in (k, v))
    out = torch.empty((B, Sq, H, D))
    n_kt = -(-Sk // bk)
    for q0 in range(0, Sq, 64):
        q1 = min(q0 + 64, Sq)
        kt_end = min(n_kt, (q1 - 1) // bk + 1) if causal else n_kt
        first = q0 - window + 1 if window else 0
        kt_begin = first // bk if first > 0 else 0
        qi = torch.arange(q0, q1)[:, None]
        m = torch.full((B, H, q1 - q0), -1e30)
        l = torch.zeros((B, H, q1 - q0))
        acc = torch.zeros((B, H, q1 - q0, D))
        for kt in range(kt_begin, kt_end):
            k0, k1 = kt * bk, min(kt * bk + bk, Sk)
            kj = torch.arange(k0, k1)[None, :]
            vis = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                vis &= qi >= kj
            if window:
                vis &= qi - kj < window
            sc = qk(qf[:, q0:q1], kf[:, k0:k1])
            sc = torch.where(vis, sc * D ** -0.5, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l, m = l * corr + p.sum(-1), m_new
            acc = acc * corr[..., None] + pv(p, vf[:, k0:k1].transpose(1, 2))
        out[:, q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)
    return out


def _mma_kernel_emulated(q, k, v, *, causal, window, split_p=True):
    """The bf16 kernel's arithmetic: key tiles of 64, exact q.k in f32,
    and p.v as bf16(p) . v + bf16(p - bf16(p)) . v (``split_p``) or
    bf16(p) . v alone."""
    def pv(p, vt):
        p_hi = p.to(torch.bfloat16).to(torch.float32)
        out = p_hi @ vt
        if split_p:
            out = out + (p - p_hi).to(torch.bfloat16).to(torch.float32) @ vt
        return out
    return _tiled_kernel_emulated(q, k, v, causal=causal, window=window,
                                  bk=64, qk=_exact_qk, pv=pv)


def _tf32(x):
    """f32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` does it (and the
    kernel's ``tf32_rna``): to nearest on the low 13 mantissa bits, ties
    away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """f32 ``x`` as a tf32 ``mma`` operand reads it: the low 13 mantissa
    bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_split(x):
    """The kernel's ``split_tf32`` as the tensor cores see it: hi =
    tf32(x), and lo = x - hi (exact in f32) truncated to tf32."""
    hi = _tf32(x)
    return hi, _tf32_trunc(x - hi)


def _tf32_kernel_emulated(q, k, v, *, causal, window, products=3):
    """The f32 kernel's arithmetic: key tiles of 32, each operand split as
    :func:`_tf32_split` does, and q.k and p.v each as hi.hi + (hi.lo +
    lo.hi) (``products=3``) or hi.hi alone (``products=1``).  A product of
    two tf32 values is exact in f32."""
    def qk(qt, kt):
        (qh, ql), (kh, kl) = _tf32_split(qt), _tf32_split(kt)
        out = _exact_qk(qh, kh)
        if products == 3:
            out = out + (_exact_qk(qh, kl) + _exact_qk(ql, kh))
        return out

    def pv(p, vt):
        (ph, pl), (vh, vl) = _tf32_split(p), _tf32_split(vt)
        out = ph @ vh
        if products == 3:
            out = out + ph @ vl + pl @ vh
        return out
    return _tiled_kernel_emulated(q, k, v, causal=causal, window=window,
                                  bk=32, qk=qk, pv=pv)


# (B, Sq, Sk, H, Hkv, causal, window) at D=128: 1024 causal keys; a window
# whose first visited tile is fully masked for the block's last rows; GQA.
MMA_CASES = [(1, 1024, 1024, 2, 2, True, None),
             (1, 320, 320, 2, 1, True, 100),
             (2, 200, 200, 8, 2, True, None)]


def _within_tolerance(got, want):
    err = (got - want).abs()
    return bool((err <= 1e-4 + 1e-4 * want.abs()).all()), float(err.max())


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_split_p_holds_the_tolerance(case):
    """p.v as two bf16 products (hi and lo parts of p) stays within the
    card's tolerance of the plain version."""
    B, Sq, Sk, H, Hkv, causal, win = case
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, 128, seed=Sq + H,
                      dtype=torch.bfloat16)
    if win:
        # The block at q0=256 visits key tile 2 (keys 128-191), which lies
        # wholly outside the window of its last row, 319.
        assert (256 - win + 1) // 64 == 2 and 319 - 191 >= win
    got = _mma_kernel_emulated(q, k, v, causal=causal, window=win)
    ok, err = _within_tolerance(
        got, flash_attention_ref(q, k, v, causal=causal, sliding_window=win))
    assert ok, err


def test_one_bf16_p_misses_the_tolerance():
    """p.v with p rounded once to bf16 misses the tolerance: the lo part
    is needed."""
    B, Sq, Sk, H, Hkv, causal, win = MMA_CASES[0]
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, 128, seed=Sq + H,
                      dtype=torch.bfloat16)
    got = _mma_kernel_emulated(q, k, v, causal=causal, window=win,
                               split_p=False)
    ok, err = _within_tolerance(got, flash_attention_ref(q, k, v))
    assert not ok and err > 1e-3, err


def test_tf32_rounds_to_nearest_with_ties_away():
    """The emulation's tf32 rounding: 10 mantissa bits kept, a tie (the
    13 dropped bits exactly half) rounds away from zero in magnitude, and
    x - tf32(x) is exact, so hi + lo, lo truncated to tf32, misses x by
    less than 2^-21 |x|."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2),
                      one + ulp / 2 - 2.0 ** -23, one + 3 * ulp / 2,
                      3.0 ** 0.5], dtype=torch.float32)
    got = _tf32(x)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         1774 / 1024])
    assert torch.equal(got, want)
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(10000)
                         .astype(np.float32))
    hi, lo = _tf32_split(r)
    assert bool(((r - hi) + hi == r).all())
    assert bool(((r - hi).abs() <= 2.0 ** -11 * r.abs()).all())
    assert bool(((r - hi - lo).abs() < 2.0 ** -21 * r.abs()).all())


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_three_tf32_products_hold_the_tolerance(case):
    """f32 q, k, v at D=128 as the f32 kernel computes them (3xTF32 for q.k
    and p.v, key tiles of 32) stay within the card's tolerance of the
    plain version."""
    B, Sq, Sk, H, Hkv, causal, win = case
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, 128, seed=Sq + H)
    if win:
        # The block at q0=256 visits key tile 4 (keys 128-159), which lies
        # wholly outside the window of its last row, 319.
        assert (256 - win + 1) // 32 == 4 and 319 - 159 >= win
    got = _tf32_kernel_emulated(q, k, v, causal=causal, window=win)
    ok, err = _within_tolerance(
        got, flash_attention_ref(q, k, v, causal=causal, sliding_window=win))
    assert ok, err


def test_one_tf32_product_misses_the_tolerance():
    """q.k and p.v as one TF32 product each (hi.hi) miss the tolerance:
    the cross products are needed."""
    B, Sq, Sk, H, Hkv, causal, win = MMA_CASES[0]
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, 128, seed=Sq + H)
    got = _tf32_kernel_emulated(q, k, v, causal=causal, window=win,
                                products=1)
    ok, err = _within_tolerance(got, flash_attention_ref(q, k, v))
    assert not ok and err > 3e-4, err


def test_wrapper_rejects_an_unsupported_device():
    q, k, v = _inputs(1, 4, 4, 2, 1, 16, seed=0)
    with pytest.raises(ValueError, match="no path for device"):
        TOPS.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# --------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version.
# --------------------------------------------------------------------------
# The reference's cases, then each head dim the kernel is built for, with
# ragged lengths (tiles of 64 rows and keys), GQA, a window and Sq != Sk.
GPU_DIMS = DIMS + [
    (b, sq, sk, h, hkv, d, causal, win)
    for d in (16, 32, 64, 128)
    for b, sq, sk, h, hkv, causal, win in (
        (2, 100, 130, 8, 2, True, None),
        (1, 200, 200, 4, 1, True, 48),
        (1, 70, 50, 4, 4, False, None),
        (1, 130, 190, 6, 3, False, 40))] + [
    # rep-8 GQA with a window, Sq and Sk not multiples of 16
    (1, 77, 93, 16, 2, 128, True, 33),
    (2, 45, 61, 16, 2, 64, True, 20)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", GPU_DIMS, ids=str)
def test_cuda_kernel_matches_plain(cuda_device, dims, dtype):
    B, Sq, Sk, H, Hkv, D, causal, win = dims
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, D, seed=11, dtype=dtype,
                      device=cuda_device)
    plain = flash_attention_ref(q, k, v, causal=causal, sliding_window=win)
    before = TOPS.LAUNCHES.by_key["flash"]
    got = TOPS.flash_attention(q, k, v, causal=causal, sliding_window=win)
    torch.cuda.synchronize()
    assert TOPS.LAUNCHES.by_key["flash"] == before + 1
    assert got.shape == (B, Sq, H, D) and got.dtype == torch.float32
    # f32 sums in another order (online softmax over tiles of 64 keys).
    err = (got - plain).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.abs()).all()), float(err.max())


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input(cuda_device):
    q, k, v = _inputs(1, 8, 8, 4, 2, 48, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        TOPS.flash_attention(q, k, v)
    q, k, v = _inputs(1, 8, 8, 4, 3, 32, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        TOPS.flash_attention(q, k, v)
    q, k, v = _inputs(1, 8, 8, 4, 2, 32, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TOPS.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        TOPS.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        TOPS.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v)
