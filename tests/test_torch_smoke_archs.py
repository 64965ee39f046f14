"""Per-arch smoke tests on the port (the counterpart of
``tests/test_smoke_archs.py``), and every configuration of the port held
to the reference's.

* ``ARCH_IDS`` and ``REPRO_IDS`` equal the reference's, in its order,
  and ``list_configs`` gives every assigned architecture; each of the
  twelve configs equals the reference's field for field, full and
  ``.reduced()``, with the same parameter shapes.
* For every one of them, the ``.reduced()`` variant at its own dtype,
  built once per arch (a module-scoped fixture): the reference's
  ``TestSmoke`` on the port, that is one forward, one train step and one
  decode step on the CPU with shapes checked and no NaN, the prefix and
  the encoder frames drawn from numpy where the config takes them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.models import model as JM
from repro_torch.configs import base as TC
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as TM
from repro_torch.optim import adamw as OPT

torch.set_num_threads(1)

ALL_IDS = TC.ARCH_IDS + TC.REPRO_IDS


def test_id_lists_equal_reference():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert TC.REPRO_IDS == JC.REPRO_IDS
    configs = TC.list_configs()
    assert list(configs) == list(JC.ARCH_IDS)
    assert all(c.name == a for a, c in configs.items())


@pytest.mark.parametrize("arch", ALL_IDS)
def test_config_equals_reference(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        td = dataclasses.asdict(tc)
        assert {k: td.pop(k) for k in TC.PORT_ONLY} == TC.PORT_ONLY
        assert td == dataclasses.asdict(jc)
        assert TM.param_shapes(tc) == JM.param_shapes(jc)


def _inputs(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    dtype = getattr(torch, cfg.dtype)
    kw = {}
    if cfg.prefix_len:
        kw["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model), np.float32) * 0.1).to(dtype)
    if cfg.is_encdec:
        kw["encoder_frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), np.float32) * 0.1).to(dtype)
    return toks, kw


@pytest.fixture(scope="module", params=ALL_IDS)
def arch_setup(request):
    cfg = TC.get_config(request.param).reduced()
    return request.param, cfg, TM.init_params(cfg, seed=0, device="cpu")


class TestSmoke:
    def test_reduced_respects_limits(self, arch_setup):
        _, cfg, _ = arch_setup
        assert cfg.d_model <= 512
        assert cfg.n_layers <= 2 * len(cfg.block_pattern)
        if cfg.moe:
            assert cfg.moe.n_experts <= 4

    def test_forward_shapes_no_nan(self, arch_setup):
        name, cfg, params = arch_setup
        toks, kw = _inputs(cfg, 1)
        with torch.no_grad():
            h, _ = TM.forward(params, cfg, toks, **kw)
            logits = TM.unembed(params, cfg, h[:, -1])
        assert h.shape == (2, 16 + cfg.prefix_len, cfg.d_model)
        assert not torch.isnan(h.float()).any(), name
        assert logits.shape == (2, cfg.vocab_size)
        assert torch.isfinite(logits).all()

    def test_train_step_no_nan(self, arch_setup):
        name, cfg, params = arch_setup
        toks, kw = _inputs(cfg, 2)
        opt_cfg = OPT.AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
        params = OPT.tree_map(torch.clone, params)  # updated in place
        before = [t.clone() for t in TM.tree_leaves(params)]
        new, _, metrics = make_train_step(cfg, opt_cfg)(
            params, OPT.init_state(params, opt_cfg),
            {"tokens": toks, "labels": toks, **kw})
        assert np.isfinite(float(metrics["loss"])), name
        assert np.isfinite(float(metrics["grad_norm"]))
        delta = sum(float((a.float() - b.float()).abs().sum())
                    for a, b in zip(TM.tree_leaves(new), before))
        assert delta > 0                    # params actually changed

    def test_decode_step_no_nan(self, arch_setup):
        name, cfg, params = arch_setup
        toks, kw = _inputs(cfg, 3)
        logits_p, cache, _ = TM.prefill(params, cfg, toks, 32 + cfg.prefix_len,
                                        **kw)
        token = torch.argmax(logits_p, -1)
        dec_kw = {"encoder_frames": kw["encoder_frames"]} \
            if cfg.is_encdec else {}
        logits_d, cache2, _ = TM.decode_step(params, cfg, token, cache,
                                             **dec_kw)
        assert logits_d.shape == (2, cfg.vocab_size)
        assert torch.isfinite(logits_d).all(), name
        assert int(cache2["pos"]) == int(cache["pos"]) + 1
