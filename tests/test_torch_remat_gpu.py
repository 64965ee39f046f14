"""Activation checkpointing on the card (imports no JAX).

``lm_loss``'s gradients under ``remat_policy`` "full" and "dots" against
the un-checkpointed route (``_remat=False``) on ``cuda``, from one seed:
the 2-layer f32 ``qwen15-moe-repro`` (MoE dispatch through
``index_put_``, top-k routing) and reduced ``jamba-v0.1-52b`` (SSM and
MoE in one period).  Tolerance: the loss equal, every gradient leaf
within atol 1e-5 + rtol 1e-4 of the plain route's, the CPU parity
tolerance against the reference (recomputation runs the same kernels on
the same shapes, so equality is expected; the tolerance leaves room for
an accumulation order the card does not fix).  Then the peak: a
reduced-width ``smollm-360m`` at 8 layers and 1024 positions, whose
attention probabilities dominate, allocates less under "full" than on
the plain route.  Needs a card:

    python -m pytest --noconftest -m gpu tests/test_torch_remat_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CONFIGS = {
    "moe": lambda: dataclasses.replace(get_config("qwen15-moe-repro"),
                                       n_layers=2, dtype="float32"),
    "hybrid": lambda: dataclasses.replace(
        get_config("jamba-v0.1-52b").reduced(), dtype="float32"),
}


def _loss_and_grads(params, cfg, tokens, labels, remat=True):
    leaves = list(TO.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TM.lm_loss(params, cfg, tokens, labels, _remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_gradients_on_the_card_equal_the_plain_route(cuda_device, name,
                                                     policy):
    cfg = dataclasses.replace(CONFIGS[name](), remat_policy=policy)
    params = TM.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    tokens, labels = (torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (2, 64)),
                                      device=cuda_device)
                      for _ in range(2))
    loss, grads = _loss_and_grads(params, cfg, tokens, labels)
    want_loss, want = _loss_and_grads(params, cfg, tokens, labels,
                                      remat=False)
    assert torch.equal(loss, want_loss)
    for i, (got, ref) in enumerate(zip(grads, want)):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-4,
                                   msg=f"leaf {i}")


@pytest.mark.gpu
def test_full_peak_below_the_plain_route(cuda_device):
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_layers=8, dtype="float32")
    params = TM.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(1)
    tokens, labels = (torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (4, 1024)),
                                      device=cuda_device)
                      for _ in range(2))
    peaks = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _loss_and_grads(params, cfg, tokens, labels, remat=remat)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
    assert peaks[True] < peaks[False], peaks
