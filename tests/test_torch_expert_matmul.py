"""Port parity: the per-expert sliced dequant matmul (``expert_matmul``).

CPU tests hold the plain PyTorch version and the wrapper's CPU path
against the JAX package's wrapper run in Pallas interpret mode, on the
reference's own cases (``tests/test_kernels.py::TestExpertMatmul``), at
atol 1e-4 * max(1, max|ref|).  The ``gpu`` tests hold the CUDA kernel
against the plain version on the card; they decide inside the test
whether a card is present and import nothing of JAX, so they run on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_expert_matmul.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.amat_matmul import ops as AMAT
from repro_torch.kernels.expert_matmul import ops as TOPS
from repro_torch.kernels.expert_matmul.ref import expert_matmul_ref
from repro_torch.quant.groupquant import quantize

# One intra-op thread per test process: parallel test workers would
# otherwise oversubscribe the cores.
torch.set_num_threads(1)

# The reference's cases: (E, C, K, N).
ECKN = [(4, 16, 64, 32), (8, 33, 96, 128), (2, 128, 128, 128), (3, 1, 32, 16)]


def _inputs(E, C, K, N, *, seed, x_dtype=torch.float32, device="cpu"):
    """x [E, C, K], the AMAT (8-bit, G32, asymmetric) quantization of
    [E, K, N] weights drawn as the reference test draws them, and its
    alternating per-expert flags (``arange(E) % 2 == 0``)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((E, C, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((E, K, N)) * 0.1)
                         .astype(np.float32))
    qt = quantize(w.to(device), bits=8, group_size=32, asymmetric=True)
    use_lsb = torch.arange(E, device=device) % 2 == 0
    return x.to(x_dtype).to(device), qt, use_lsb


def _case_inputs(eckn):
    E, C, K, N = eckn
    return _inputs(E, C, K, N, seed=E * 100 + C)


@pytest.fixture(scope="module")
def jax_result():
    """The JAX wrapper's output (interpret mode, shift 4) for a case,
    computed once per module."""
    cache = {}

    def get(eckn):
        if eckn not in cache:
            import jax.numpy as jnp

            from repro.kernels.expert_matmul.ops import expert_matmul

            x, qt, use_lsb = _case_inputs(eckn)
            out = expert_matmul(
                jnp.asarray(x.numpy()), jnp.asarray(qt.codes.numpy()),
                jnp.asarray(qt.scales.numpy()),
                jnp.asarray(qt.zero_points.numpy()),
                jnp.asarray(use_lsb.numpy()), group_size=32, shift=4,
                interpret=True)
            cache[eckn] = np.asarray(out)
        return cache[eckn]
    return get


def _assert_matches(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(
        got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("eckn", ECKN, ids=str)
def test_plain_matches_reference(jax_result, eckn):
    x, qt, use_lsb = _case_inputs(eckn)
    got = expert_matmul_ref(x, qt.codes, qt.scales, qt.zero_points, use_lsb,
                            group_size=32, shift=4)
    _assert_matches(got.numpy(), jax_result(eckn))


@pytest.mark.parametrize("eckn", ECKN, ids=str)
def test_cpu_wrapper_matches_reference(jax_result, eckn):
    x, qt, use_lsb = _case_inputs(eckn)
    before = TOPS.LAUNCHES.count
    got = TOPS.expert_matmul_qt(x, qt, use_lsb, shift=4)
    assert TOPS.LAUNCHES.count == before     # the CPU path launches nothing
    _assert_matches(got.numpy(), jax_result(eckn))


def test_is_the_batched_amat_function():
    """What lets the CUDA entry reuse the batched K-major body: the same
    function as ``amat_expert_matmul``, at shift 4 and at shift 0 (where
    the reference's floor(c * 1) truncates nothing)."""
    x, qt, use_lsb = _inputs(5, 9, 64, 40, seed=3)
    for shift in (4, 0):
        a = TOPS.expert_matmul_qt(x, qt, use_lsb, shift=shift)
        b = AMAT.amat_expert_matmul_qt(x, qt, use_lsb, shift=shift)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    hi = TOPS.expert_matmul_qt(x, qt, torch.ones(5, dtype=torch.bool),
                               shift=0)
    torch.testing.assert_close(TOPS.expert_matmul_qt(x, qt, use_lsb, shift=0),
                               hi, rtol=0, atol=0)


def test_use_lsb_flag_changes_result():
    x, qt, _ = _inputs(2, 8, 64, 32, seed=4)
    hi = TOPS.expert_matmul_qt(x, qt, torch.ones(2, dtype=torch.bool),
                               shift=4)
    lo = TOPS.expert_matmul_qt(x, qt, torch.zeros(2, dtype=torch.bool),
                               shift=4)
    assert float(torch.linalg.norm(hi - lo)) > 1e-3


def test_wrapper_rejects_an_unsupported_device():
    x, qt, use_lsb = _inputs(2, 3, 32, 8, seed=0)
    with pytest.raises(ValueError, match="no path for device"):
        TOPS.expert_matmul(*(t.to("meta") for t in (
            x, qt.codes, qt.scales, qt.zero_points, use_lsb)))


# --------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version.
# --------------------------------------------------------------------------
# The reference's cases, a ragged N (padded by the wrapper), and
# qwen15-moe-a2.7b's ``wi`` at the decode and prefill capacities.
GPU_ECKN = ECKN + [(3, 5, 64, 33), (60, 8, 2048, 2816), (60, 18, 2048, 2816)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [4, 0])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eckn", GPU_ECKN, ids=str)
def test_cuda_kernel_matches_plain(cuda_device, eckn, x_dtype, shift):
    E, C, K, N = eckn
    x, qt, use_lsb = _inputs(E, C, K, N, seed=11, x_dtype=x_dtype,
                             device=cuda_device)
    plain = expert_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                              use_lsb, shift=shift)
    before = TOPS.LAUNCHES.by_key["expert"]
    got = TOPS.expert_matmul_qt(x, qt, use_lsb, shift=shift)
    torch.cuda.synchronize()
    assert TOPS.LAUNCHES.by_key["expert"] == before + 1
    assert got.shape == (E, C, N) and got.dtype == torch.float32
    # f32 accumulation in another order than the plain version's bmm.
    err = (got - plain).abs()
    assert bool((err <= 1e-4 + 1e-4 * plain.abs()).all()), float(err.max())


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input(cuda_device):
    x, qt, use_lsb = _inputs(2, 3, 64, 8, seed=0, device=cuda_device)
    args = (qt.codes, qt.scales, qt.zero_points)
    with pytest.raises(ValueError, match="group_size"):
        TOPS.expert_matmul(x, *args, use_lsb, group_size=16)
    with pytest.raises(ValueError, match="use_lsb"):
        TOPS.expert_matmul(x, *args, use_lsb[:1])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TOPS.expert_matmul(x.half(), *args, use_lsb)
