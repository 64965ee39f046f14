"""Port parity: the training path (``forward``, ``lm_loss``, gradients,
the train step, the train loop and the trained-model cache).

Both eval models at 2 layers in f32, one numpy tree of weights shared by
the two packages (drawn by the port's init, as in
``tests/test_torch_engine.py``).  Tolerances: hidden states, aux loss and
loss at 1e-5 (absolute and relative); every gradient leaf at atol 1e-5 +
rtol 1e-4; train-step losses at rtol 1e-5, params as derived in
``test_train_step_matches_reference``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.launch.steps import make_train_step as j_train_step
from repro.models import model as JM
from repro.optim import adamw as JO
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as TCK
from repro_torch.configs.base import get_config as tget
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as TT
from repro_torch.launch.steps import make_train_step as t_train_step
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO

from _adamw_bound import MAX_SHARE_OFF, divergence_bound  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import torch_common  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["qwen15-moe-repro", "deepseek-v2-lite-repro"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    tcfg = dataclasses.replace(tget(arch), n_layers=2, dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2, seed=0))
    return cfg, tcfg, tree, data


def _params(tree):
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _batch(data, step):
    full = data.sample_batch(step, 2)
    return full[:, :-1], full[:, 1:]


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_forward_matches_reference(model):
    cfg, tcfg, tree, data = model
    jp, tp = _params(tree)
    toks, _ = _batch(data, 0)
    jh, jaux = JM.forward(jp, cfg, jnp.asarray(toks))
    with torch.no_grad():
        th, taux = TM.forward(tp, tcfg, _t(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), atol=1e-5, rtol=1e-5)
    for k in ("aux_loss", "dropped_frac"):
        np.testing.assert_allclose(taux["moe"][k].numpy(),
                                   np.asarray(jaux["moe"][k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("aux_weight", [0.01, 0.0])
def test_lm_loss_matches_reference(model, aux_weight):
    cfg, tcfg, tree, data = model
    jp, tp = _params(tree)
    toks, labels = _batch(data, 1)
    jl, _ = JM.lm_loss(jp, cfg, jnp.asarray(toks), jnp.asarray(labels),
                       aux_weight=aux_weight)
    with torch.no_grad():
        tl, _ = TM.lm_loss(tp, tcfg, _t(toks), _t(labels),
                           aux_weight=aux_weight)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=1e-5)


def test_gradients_match_reference(model):
    cfg, tcfg, tree, data = model
    jp, tp = _params(tree)
    toks, labels = _batch(data, 2)

    def j_loss(p):
        return JM.lm_loss(p, cfg, jnp.asarray(toks), jnp.asarray(labels))

    (jl, _), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    leaves = list(TO.tree_leaves(tp))
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = TM.lm_loss(tp, tcfg, _t(toks), _t(labels))
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5,
                               rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(grads)
    for (path, want), got in zip(jleaves, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_step_matches_reference(model):
    """Three steps of ``make_train_step`` in both packages.  The losses
    agree at rtol 1e-5.  Params: every entry within the worst-case
    divergence of AdamW under gradients that agree to their tolerance
    (``_adamw_bound.divergence_bound``, about 2 * sum(lr_t)); and the
    entries beyond 1e-6 stay under ``MAX_SHARE_OFF`` (0.5%) of all."""
    cfg, tcfg, tree, data = model
    jp, tp = _params(tree)
    kw = dict(lr=2e-3, total_steps=3, warmup_steps=1)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    j_step = jax.jit(j_train_step(cfg, jc))
    t_step = t_train_step(tcfg, tc)
    js, ts = JO.init_state(jp, jc), TO.init_state(tp, tc)
    for step in range(3):
        toks, labels = _batch(data, step)
        jp, js, jm = j_step(jp, js, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})
        tp, ts, tm = t_step(tp, ts, {"tokens": _t(toks),
                                     "labels": _t(labels)})
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    bound = divergence_bound(tc, 3)
    n_off = n_all = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        got = tp
        for k in path:
            got = got[k.key]
        assert not got.requires_grad
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= bound, (jax.tree_util.keystr(path), diff.max())
        n_off += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_off <= MAX_SHARE_OFF * n_all, (n_off, n_all)


def test_train_loop_loss_falls():
    cfg = tget("qwen15-moe-repro").reduced()
    params, state, hist = TT.train_loop(
        cfg, steps=20, global_batch=4, seq_len=32,
        opt_cfg=TO.AdamWConfig(lr=2e-3, total_steps=20, warmup_steps=2),
        log_every=10, collect_history=True, device="cpu")
    assert [m["step"] for m in hist] == list(range(20))
    losses = [m["loss"] for m in hist]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 1.0, losses
    assert state.step == 20
    assert params["embed"].shape == (cfg.vocab_size, cfg.d_model)


def test_train_or_load_caches(tmp_path, monkeypatch):
    monkeypatch.setattr(torch_common, "TRAINED_DIR", str(tmp_path))
    cfg, params = torch_common.train_or_load(
        "qwen15-moe-repro", steps=2, seq=16, batch=2, device="cpu")
    path = tmp_path / "qwen15-moe-repro_s2"
    assert (path / "manifest.msgpack").exists()
    assert TCK.restore_step(str(path)) == 2

    def no_training(*a, **kw):
        raise AssertionError("the cached checkpoint was not used")

    monkeypatch.setattr(torch_common, "train_loop", no_training)
    cfg2, loaded = torch_common.train_or_load(
        "qwen15-moe-repro", steps=2, seq=16, batch=2, device="cpu")
    assert cfg2 == cfg
    for a, b in zip(TO.tree_leaves(loaded), TO.tree_leaves(params)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
    ppl = torch_common.synthetic_ppl(
        loaded, cfg, torch_common.eval_batches(cfg, n_batches=1, batch=2,
                                               seq=16))
    assert np.isfinite(ppl) and 1.0 < ppl < cfg.vocab_size * 2


def test_unported_launch_settings_name_their_queue_item(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen15-moe-repro",
                                      "--mesh", "pod", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Launch and dry-run"):
        TT.main()
