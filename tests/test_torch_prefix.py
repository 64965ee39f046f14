"""Port parity: prefix embeddings (the VLM stub), ``internvl2-1b``
reduced (2 layers, a prefix of 8), and the engine's ``**model_kwargs``
pass-through, against the reference on one numpy tree (the port's CPU
init, carried to both packages through ``repro_torch.bridge``), f32.

* ``embed_inputs`` with and without the prefix (a config without a
  prefix ignores the argument), and at ``onehot_embed=True``, where the
  reference's one-hot product picks the same rows as the port's gather,
  bit for bit.
* ``forward``'s ``[B, prefix + S, d]``, ``lm_loss`` dropping the prefix
  positions, ``prefill``'s cache position counting the prefix, greedy
  decode steps (logits 1e-4, tokens exact), each step also within
  ``1e-4 + 1e-4*|oracle|`` of the forward over the prefix and the tokens
  so far (``chip_smoke.py`` 14a's check at reduced size).
* ``PlainEngine.generate`` with ``prefix_embeds``: tokens equal the
  reference's; both servers (which pass no keywords) serve the prefix
  config on text only, with equal tokens.
* ``train.py``'s ``_stub_prefix`` / ``_stub_frames`` equal the
  reference's bit for bit, ``train_loop`` cuts ``prefix_len`` tokens off
  each batch and feeds the stubs, and ``make_train_step`` with a prefix
  gives the reference's loss, gradient norm (rtol 1e-5) and updated
  parameters (within ``_adamw_bound.divergence_bound``); ``lm_loss``'s
  gradients with a prefix equal ``jax.grad``'s at atol 1e-5.
* The engine: ``SliceMoEEngine.prefill`` / ``decode`` and
  ``run_prefill`` + ``decode_batch`` with ``prefix_embeds`` on
  ``qwen15-moe-repro`` reduced with ``prefix_len=4``, quantized execution,
  through ``_torch_parity.run_both``: routing ids of every prefill and
  decode step, per-epoch miss counts and tokens exact, the ledger at rtol
  1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _adamw_bound import divergence_bound
from _torch_parity import REF, run_both
from repro.configs.base import get_config
from repro.core import engine as JE
from repro.core.amat import MatConfig as JMat
from repro.launch import train as JT
from repro.launch.steps import make_train_step as j_train_step
from repro.models import model as JM
from repro.models.moe import RoutingPolicy as JRP
from repro.optim import adamw as JO
from repro.serving import server as JSV
from repro.sim import TraceRecorder as JRecorder
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core import engine as TE
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.launch import train as TT
from repro_torch.launch.steps import make_train_step as t_train_step
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.optim import adamw as TO
from repro_torch.serving import server as TSV
from repro_torch.sim import TraceRecorder as TRecorder

torch.set_num_threads(1)

ARCH = "internvl2-1b"
MAX_SEQ = 40

j_forward = jax.jit(JM.forward, static_argnames=("cfg",))
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_seq"))
j_decode = jax.jit(JM.decode_step, static_argnames=("cfg",))


def _cfgs(arch=ARCH, **over):
    over = {"dtype": "float32", **over}
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(TC.get_config(arch).reduced(), **over))


def _tree(tcfg, seed=0):
    return jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=seed, device="cpu"))


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _prefix(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cfg.prefix_len, cfg.d_model))
            * 0.02).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    assert tcfg.prefix_len == 8 and tcfg.arch_type == "vlm"
    return (jcfg, tcfg, *_both(_tree(tcfg)))


# -------------------------------------------------------------- embeddings
def test_embed_inputs_with_and_without_the_prefix(model):
    jcfg, tcfg, jp, tp = model
    toks, prefix = _tokens(tcfg.vocab_size, (2, 6), 1), _prefix(tcfg, 2, 2)
    got = TM.embed_inputs(tp, tcfg, _t(toks), torch.from_numpy(prefix))
    want = JM.embed_inputs(jp, jcfg, jnp.asarray(toks), jnp.asarray(prefix))
    assert got.shape == (2, tcfg.prefix_len + 6, tcfg.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :tcfg.prefix_len].numpy(), prefix)
    text = TM.embed_inputs(tp, tcfg, _t(toks))
    np.testing.assert_array_equal(
        text.numpy(), np.asarray(JM.embed_inputs(jp, jcfg, jnp.asarray(toks),
                                                 None)))
    np.testing.assert_array_equal(got[:, tcfg.prefix_len:].numpy(),
                                  text.numpy())
    # A config without a prefix ignores the argument, as the reference.
    jno, tno = (dataclasses.replace(c, prefix_len=0) for c in (jcfg, tcfg))
    np.testing.assert_array_equal(
        TM.embed_inputs(tp, tno, _t(toks), torch.from_numpy(prefix)).numpy(),
        np.asarray(JM.embed_inputs(jp, jno, jnp.asarray(toks),
                                   jnp.asarray(prefix))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_at_onehot_embed(dtype):
    """The reference's one-hot product picks the table's rows exactly, so
    the port's gather equals it bit for bit."""
    jcfg, tcfg = _cfgs(onehot_embed=True, dtype=dtype)
    tree = jax.tree.map(
        lambda t: t.view(torch.int16).numpy().view(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else t.numpy(),
        TM.init_params(tcfg, seed=1, device="cpu"))
    jp, tp = _both(tree)
    toks, prefix = _tokens(tcfg.vocab_size, (3, 7), 3), _prefix(tcfg, 3, 4)
    got = TM.embed_inputs(tp, tcfg, _t(toks), torch.from_numpy(prefix))
    want = JM.embed_inputs(jp, jcfg, jnp.asarray(toks), jnp.asarray(prefix))
    assert str(want.dtype) == dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------------------ full sequence
def test_forward_spans_prefix_and_text(model):
    jcfg, tcfg, jp, tp = model
    toks, prefix = _tokens(tcfg.vocab_size, (2, 10), 5), _prefix(tcfg, 2, 6)
    jh, _ = j_forward(jp, jcfg, jnp.asarray(toks),
                      prefix_embeds=jnp.asarray(prefix))
    with torch.no_grad():
        th, _ = TM.forward(tp, tcfg, _t(toks),
                           prefix_embeds=torch.from_numpy(prefix))
        text, _ = TM.forward(tp, tcfg, _t(toks))
    assert th.shape == (2, tcfg.prefix_len + 10, tcfg.d_model)
    assert text.shape == (2, 10, tcfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    assert float((th[:, tcfg.prefix_len:] - text).abs().max()) > 1e-3


def test_lm_loss_drops_the_prefix(model):
    jcfg, tcfg, jp, tp = model
    toks, prefix = _tokens(tcfg.vocab_size, (2, 16), 7), _prefix(tcfg, 2, 8)
    labels = _tokens(tcfg.vocab_size, (2, 16), 9)
    jl, _ = JM.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                       prefix_embeds=jnp.asarray(prefix))
    with torch.no_grad():
        tl, _ = TM.lm_loss(tp, tcfg, _t(toks), _t(labels),
                           prefix_embeds=torch.from_numpy(prefix))
        h, _ = TM.forward(tp, tcfg, _t(toks),
                          prefix_embeds=torch.from_numpy(prefix))
        logits = TM.unembed(tp, tcfg, h[:, tcfg.prefix_len:])
        manual = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), _t(labels).reshape(-1))
        text, _ = TM.lm_loss(tp, tcfg, _t(toks), _t(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(manual), rtol=1e-5)
    assert abs(float(text) - float(tl)) > 1e-4


def test_lm_loss_gradients_with_a_prefix_match_reference(model):
    jcfg, tcfg, jp, tp = model
    toks, prefix = _tokens(tcfg.vocab_size, (2, 16), 10), _prefix(tcfg, 2, 11)

    def j_loss(p):
        return JM.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(toks),
                          prefix_embeds=jnp.asarray(prefix))[0]

    jg = jax.jit(jax.grad(j_loss))(jp)
    tp = TO.tree_map(torch.clone, tp)
    leaves = list(TM.tree_leaves(tp))
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl, _ = TM.lm_loss(tp, tcfg, _t(toks), _t(toks),
                       prefix_embeds=torch.from_numpy(prefix))
    grads = torch.autograd.grad(tl, leaves)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(grads)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5)


# ------------------------------------------------------- prefill and decode
def test_prefill_counts_the_prefix_and_decode_matches(model):
    jcfg, tcfg, jp, tp = model
    toks, prefix = _tokens(tcfg.vocab_size, (2, 12), 12), _prefix(tcfg, 2, 13)
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ,
                          prefix_embeds=jnp.asarray(prefix))
    tl, tc, _ = TM.prefill(tp, tcfg, _t(toks), MAX_SEQ,
                           prefix_embeds=torch.from_numpy(prefix))
    n = tcfg.prefix_len + 12
    assert int(tc["pos"]) == int(jc["pos"]) == n
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    seq = toks
    for step in range(4):
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy(),
                                      np.asarray(jnp.argmax(jl, -1)))
        seq = np.concatenate([seq, tt.numpy()[:, None].astype(np.int32)], 1)
        jl, jc, _ = j_decode(jp, jcfg, jnp.asarray(tt.numpy(), jnp.int32),
                             jc)
        tl, tc, _ = TM.decode_step(tp, tcfg, tt, tc)
        assert int(tc["pos"]) == int(jc["pos"]) == n + step + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        with torch.no_grad():
            h, _ = TM.forward(tp, tcfg, _t(seq),
                              prefix_embeds=torch.from_numpy(prefix))
            oracle = TM.unembed(tp, tcfg, h[:, -1])
        assert bool(((tl - oracle).abs()
                     <= 1e-4 + 1e-4 * oracle.abs()).all())


def test_prefill_without_the_prefix_runs_on_text_only(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(tcfg.vocab_size, (1, 9), 14)
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ)
    tl, tc, _ = TM.prefill(tp, tcfg, _t(toks), MAX_SEQ)
    assert int(tc["pos"]) == int(jc["pos"]) == 9
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


# ------------------------------------------------------------------ serving
def test_plain_engine_generate_with_a_prefix_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    prompt, prefix = _tokens(tcfg.vocab_size, (7,), 30), _prefix(tcfg, 1, 31)
    ref, _ = JSV.PlainEngine(jcfg, jp, MAX_SEQ).generate(
        prompt, 6, prefix_embeds=jnp.asarray(prefix))
    port, metrics = TSV.PlainEngine(tcfg, tp, MAX_SEQ, device="cpu").generate(
        prompt, 6, prefix_embeds=torch.from_numpy(prefix))
    assert metrics is None and len(port) == 6
    assert port.tolist() == np.asarray(ref).tolist()


def test_servers_serve_a_prefix_config_on_text_only(model):
    """Both servers call ``generate`` without keywords, so a prefix
    config serves on text only, with the same tokens."""
    jcfg, tcfg, jp, tp = model
    outs = []
    for SV, cfg, params, kw in ((JSV, jcfg, jp, {}),
                                (TSV, tcfg, tp, {"device": "cpu"})):
        server = SV.SliceMoEServer(cfg, params, max_seq=MAX_SEQ, **kw)
        for i in range(2):
            server.submit(SV.Request(request_id=i, prompt=_tokens(
                cfg.vocab_size, (6 + i,), 32 + i), max_new_tokens=5))
        outs.append([np.asarray(c.tokens).tolist() for c in server.run()])
    assert outs[1] == outs[0] and [len(t) for t in outs[1]] == [5, 5]


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("arch", [ARCH, "whisper-small"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stubs_equal_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    name = "_stub_prefix" if tcfg.prefix_len else "_stub_frames"
    for step in (0, 3):
        got = getattr(TT, name)(tcfg, 2, step, "cpu")
        want = getattr(JT, name)(jcfg, 2, step)
        assert str(want.dtype) == dtype and got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("arch", [ARCH, "whisper-small"])
def test_train_loop_cuts_the_prefix_and_feeds_the_stubs(arch, monkeypatch):
    _, tcfg = _cfgs(arch)
    seen = []

    def recording(cfg, opt_cfg):
        step = t_train_step(cfg, opt_cfg)

        def run(params, opt_state, batch):
            seen.append(batch)
            return step(params, opt_state, batch)
        return run

    monkeypatch.setattr(TT, "make_train_step", recording)
    seq = 12 + tcfg.prefix_len
    _, _, hist = TT.train_loop(tcfg, steps=2, global_batch=2, seq_len=seq,
                               log_every=100, collect_history=True,
                               device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    for step, batch in enumerate(seen):
        want = (2, 12) if tcfg.prefix_len else (2, seq)
        assert batch["tokens"].shape == batch["labels"].shape == want
        if tcfg.prefix_len:
            torch.testing.assert_close(batch["prefix_embeds"],
                                       TT._stub_prefix(tcfg, 2, step, "cpu"),
                                       rtol=0, atol=0)
            assert "encoder_frames" not in batch
        else:
            torch.testing.assert_close(batch["encoder_frames"],
                                       TT._stub_frames(tcfg, 2, step, "cpu"),
                                       rtol=0, atol=0)
            assert "prefix_embeds" not in batch


def test_make_train_step_with_a_prefix_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    toks, prefix = _tokens(tcfg.vocab_size, (2, 16), 15), _prefix(tcfg, 2, 16)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jp2, _, jm = jax.jit(j_train_step(jcfg, jc))(
        jp, JO.init_state(jp, jc), {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(toks),
                                    "prefix_embeds": jnp.asarray(prefix)})
    tp = TO.tree_map(torch.clone, tp)       # the port updates in place
    tp2, _, tm = t_train_step(tcfg, tc)(
        tp, TO.init_state(tp, tc), {"tokens": _t(toks), "labels": _t(toks),
                                    "prefix_embeds": torch.from_numpy(prefix)})
    for k in ("loss", "aux_loss", "grad_norm"):
        assert np.isfinite(float(tm[k])), k
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    bound = divergence_bound(tc, 1)
    for got, want in zip(TM.tree_leaves(tp2),
                         jax.tree_util.tree_leaves(jp2)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= bound


# ------------------------------------------------------- engine pass-through
def _engine_run(ns, persistent: bool) -> dict:
    """``qwen15-moe-repro`` reduced with a 4-embedding prefix, f32, one
    request of 16 tokens behind the prefix, then 4 decode steps:
    through ``SliceMoEEngine.prefill`` / ``decode``, or through
    ``run_prefill`` + ``decode_batch``."""
    ref = ns is REF
    jcfg, tcfg = _cfgs("qwen15-moe-repro", prefix_len=4)
    cfg = jcfg if ref else tcfg
    tree = _tree(tcfg, seed=5)
    toks = _tokens(cfg.vocab_size, (1, 16), 17)
    prefix = _prefix(cfg, 1, 18)
    kw = dict(cache_bytes=1.0e6, miss_rate_target=0.1, warmup="pcw",
              max_seq=32)
    if ref:
        ecfg = JE.EngineConfig(mat=JMat(8, 4), policy=JRP(
            kind="cache_prior", slice_mode="dbsc", quant_execution=True),
            **kw)
        params, arr = jax.tree.map(jnp.asarray, tree), jnp.asarray
        cls = JE.PersistentEngine if persistent else JE.SliceMoEEngine
        engine = cls(cfg, params, ecfg)
        recorder = JRecorder(engine)
    else:
        ecfg = TE.EngineConfig(mat=TMat(8, 4), policy=TRP(
            kind="cache_prior", slice_mode="dbsc", quant_execution=True),
            **kw)
        params, arr = params_from_numpy(tree, "cpu"), torch.from_numpy
        cls = TE.PersistentEngine if persistent else TE.SliceMoEEngine
        engine = cls(cfg, params, ecfg, device="cpu")
        recorder = TRecorder(engine)
    tokens = arr(toks) if ref else _t(toks)
    if persistent:
        logits, kv, _ = engine.run_prefill(tokens, label="r0",
                                           prefix_embeds=arr(prefix))
        pos = int(kv["pos"])
        out = []
        for _ in range(4):
            token = np.asarray(logits).argmax(-1) if ref else \
                torch.argmax(logits, -1)
            token = jnp.asarray(token, jnp.int32) if ref else token
            out.append(int(token[0]))
            logits, kv, charge = engine.decode_batch(
                token, kv, slot_active=np.array([True]),
                encoder_frames=None)
        tokens_out = out
    else:
        logits = engine.prefill(tokens, prefix_embeds=arr(prefix))
        pos = int(engine.kv_cache["pos"])
        first = jnp.argmax(logits, -1).astype(jnp.int32) if ref else \
            torch.argmax(logits, -1)
        toks_out, metrics = engine.decode(first, 4, encoder_frames=None)
        tokens_out = np.asarray(toks_out).tolist()
    trace = recorder.trace()
    return {"pos": pos, "tokens": tokens_out,
            "ids": [np.asarray(e.ids).tolist() for e in trace.events],
            "kinds": [e.kind for e in trace.events],
            "epoch_counts": engine.cache.epoch_counts(),
            "ledger": engine.ledger.snapshot()}


@pytest.mark.parametrize("persistent", [False, True],
                         ids=["prefill_decode", "run_prefill_decode_batch"])
def test_engine_passes_prefix_embeds_through(persistent):
    port = run_both(lambda ns: _engine_run(ns, persistent))
    assert port["pos"] == 4 + 16
    assert port["kinds"] == ["prefill"] + ["decode"] * 4
    # The prefill routed the prefix positions too: T = 4 + 16 rows.
    assert np.asarray(port["ids"][0]).shape[2] == 20
    assert port["ledger"]["total_energy_j"] > 0
