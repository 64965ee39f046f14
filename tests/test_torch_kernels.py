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
# On the card: the CUDA kernel against its plain version.
# --------------------------------------------------------------------------
GPU_CASES = dict(CASES, full_wi=(60, 8, 2048, 2816), full_wo=(60, 8, 1408, 2048),
                 prefill_wi=(60, 18, 2048, 2816),
                 prefill_wo=(60, 18, 1408, 2048))


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
