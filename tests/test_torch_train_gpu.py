"""The port's train step on the card against the CPU (imports no JAX).

One ``make_train_step`` on the 2-layer f32 ``qwen15-moe-repro`` from the
same weights and batch, on ``cuda`` and on the CPU: the loss at rtol
1e-5 and the params within the tolerance of the CPU parity test
(``tests/test_torch_train.py``): every entry within AdamW's worst-case
divergence under gradients that agree to their tolerance, and the
entries beyond 1e-6 under ``MAX_SHARE_OFF`` of all.  Needs a card:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from _adamw_bound import MAX_SHARE_OFF, divergence_bound
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_step_card_matches_cpu(cuda_device):
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    opt_cfg = TO.AdamWConfig(lr=2e-3, total_steps=3, warmup_steps=1)
    full = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2, seed=0)).sample_batch(0, 2)
    cpu_params = TM.init_params(cfg, seed=0, device="cpu")
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        params = TO.tree_map(lambda t: t.to(dev, copy=True), cpu_params)
        state = TO.init_state(params, opt_cfg)
        batch = {"tokens": torch.as_tensor(full[:, :-1], device=dev).long(),
                 "labels": torch.as_tensor(full[:, 1:], device=dev).long()}
        params, state, metrics = make_train_step(cfg, opt_cfg)(
            params, state, batch)
        out[dev.type] = (TO.tree_map(lambda t: t.cpu(), params),
                         float(metrics["loss"]))
    (cpu, cpu_loss), (card, card_loss) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    bound = divergence_bound(opt_cfg, 1)
    n_off = n_all = 0
    for a, b in zip(TO.tree_leaves(card), TO.tree_leaves(cpu)):
        diff = (a - b).abs()
        assert float(diff.max()) <= bound
        n_off += int((diff > 1e-6).sum())
        n_all += diff.numel()
    assert n_off <= MAX_SHARE_OFF * n_all, (n_off, n_all)
