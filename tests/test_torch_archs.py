"""Port parity: the dense architecture, sliding windows, logit soft-capping,
tied and padded vocabularies and the GeGLU / squared-ReLU / GELU MLPs,
through the six configurations they unlock: ``smollm-360m``,
``gemma-7b``, ``nemotron-4-15b``, ``starcoder2-3b``,
``llama4-scout-17b-a16e`` and ``llama4-maverick-400b-a17b``.

* Each config equals the reference's field by field, with the same
  properties, parameter shapes and count (full width, shapes only).
* Each ``.reduced()`` config at f32, one numpy tree for both packages
  (drawn by the port's init, carried through ``params_from_numpy``): the
  counterparts of ``tests/test_smoke_archs.py``, forward, ``lm_loss``
  plus one AdamW step, prefill and decode, each held against the
  reference (hidden states and logits at 1e-4, tokens and routing ids
  exactly, the loss at rtol 1e-5, the step's params within AdamW's
  divergence bound).
* Windows: ``tests/test_perf_variants.py:70``
  (``test_window_sliced_decode_exact``) on both packages, the compact
  window read at aligned positions against the masked full read at
  per-sequence positions, and the windowed forward, prefill and decode
  against the reference where the window bites.
* ``pad_vocab_to``: pad columns at -1e30, the same loss as the unpadded
  model, and parity with the reference, tied and untied.
* A tied tree (no ``unembed``) and the one-matrix ``wi`` of ``gelu`` /
  ``relu2`` cross the bridge and the checkpoint unchanged.
* Serving: ``test_server_dense_arch`` (``tests/test_system.py:71-79``)
  through ``PlainEngine``, its tokens against the reference's server;
  the CLI with ``--arch smollm-360m`` (no engine config, as the
  reference's ``launch/serve.py:314``); ``llama4-scout`` (top-1, one
  shared expert) served by both packages' SliceMoE servers with
  quantized execution (tokens, cache stats exact; ledger rtol 1e-6).
* ``ring_kv`` and ``quantized_serve``, the last settings ported (their
  parity is ``tests/test_torch_{ring_kv,serve_variants}.py``), and the
  four that raised before prefix embeddings and the encoder-decoder were
  ported give the reference's ``param_shapes`` and ``init_cache``.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _adamw_bound import divergence_bound
from _torch_parity import REF, run_both
from repro.checkpoint import ckpt as JCK
from repro.configs.base import get_config
from repro.core.amat import MatConfig as JMat
from repro.core.engine import EngineConfig as JEC
from repro.launch import serve as JSERVE
from repro.launch.steps import make_train_step as j_train_step
from repro.models import model as JM
from repro.models.moe import RoutingPolicy as JRP
from repro.optim import adamw as JO
from repro.serving import server as JSV
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import ckpt as TCK
from repro_torch.configs import base as TC
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.launch import serve as TSERVE
from repro_torch.launch.steps import make_train_step as t_train_step
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.optim import adamw as TO
from repro_torch.serving import server as TSV

torch.set_num_threads(1)

ARCHS = ["smollm-360m", "gemma-7b", "nemotron-4-15b", "starcoder2-3b",
         "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"]
PROPS = ("padded_vocab", "has_attention", "has_ssm", "has_moe", "is_encdec",
         "subquadratic", "n_periods")
MAX_SEQ = 32

j_forward = jax.jit(JM.forward, static_argnames=("cfg", "collect_trace",
                                                 "use_window"))
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_seq",
                                                 "collect_trace",
                                                 "use_window"))
j_decode = jax.jit(JM.decode_step, static_argnames=("cfg", "collect_trace",
                                                    "use_window"))
j_loss = jax.jit(JM.lm_loss, static_argnames=("cfg",))


def _cfgs(arch, **over):
    """The reference's and the port's ``.reduced()`` config at f32."""
    over = dict(dtype="float32", **over)
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


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    j, t = get_config(arch), TC.get_config(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        td = dataclasses.asdict(tc)
        assert {k: td.pop(k) for k in TC.PORT_ONLY} == TC.PORT_ONLY
        assert td == dataclasses.asdict(jc)
        for prop in PROPS:
            assert getattr(tc, prop) == getattr(jc, prop), prop
        assert [(b.mixer, b.ffn) for b in tc.block_pattern] == \
            [(b.mixer, b.ffn) for b in jc.block_pattern]
        assert TM.param_shapes(tc) == JM.param_shapes(jc)
        assert tc.param_count() == jc.param_count()
    assert ("unembed" in TM.param_shapes(t)) == (not t.tie_embeddings)


# -------------------------------------------------- smoke tests, in parity
@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    tree = _tree(tcfg)
    return (request.param, jcfg, tcfg, *_both(tree))


def test_forward_matches_reference(model):
    """``TestSmoke::test_forward_shapes_no_nan``, held to the reference."""
    arch, jcfg, tcfg, jp, tp = model
    toks = _tokens(tcfg.vocab_size, (2, 16), seed=1)
    jh, jaux = j_forward(jp, jcfg, jnp.asarray(toks), collect_trace=True)
    with torch.no_grad():
        th, taux = TM.forward(tp, tcfg, _t(toks), collect_trace=True)
        logits = TM.unembed(tp, tcfg, th[:, -1])
    assert th.shape == (2, 16, tcfg.d_model)
    assert logits.shape == (2, tcfg.vocab_size)
    assert torch.isfinite(logits).all(), arch
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(JM.unembed(jp, jcfg, jh[:, -1])),
        atol=1e-4)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), atol=1e-5)
    if tcfg.has_moe:
        np.testing.assert_array_equal(taux["moe"]["ids"].numpy(),
                                      np.asarray(jaux["moe"]["ids"]))


def test_train_step_matches_reference(model):
    """``TestSmoke::test_train_step_no_nan``: ``lm_loss`` and one AdamW
    step in both packages."""
    arch, jcfg, tcfg, jp, tp = model
    toks = _tokens(tcfg.vocab_size, (2, 16), seed=2)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    before = jax.tree.map(np.asarray, jp)
    jp2, _, jm = jax.jit(j_train_step(jcfg, jc))(
        jp, JO.init_state(jp, jc), {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(toks)})
    tp = TO.tree_map(torch.clone, tp)       # the port updates in place
    tp2, _, tm = t_train_step(tcfg, tc)(
        tp, TO.init_state(tp, tc), {"tokens": _t(toks), "labels": _t(toks)})
    for k in ("loss", "aux_loss", "grad_norm"):
        assert np.isfinite(float(tm[k])), (arch, k)
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    bound = divergence_bound(tc, 1)
    delta = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(jp2):
        got, old = tp2, before
        for k in path:
            got, old = got[k.key], old[k.key]
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= bound, (jax.tree_util.keystr(path), diff.max())
        delta += float(np.abs(got.numpy() - old).sum())
    assert delta > 0                        # params actually changed


def test_prefill_and_decode_match_reference(model):
    """``TestSmoke::test_decode_step_no_nan``: prefill, then two decode
    steps, in both packages."""
    arch, jcfg, tcfg, jp, tp = model
    toks = _tokens(tcfg.vocab_size, (2, 16), seed=3)
    jl, jc, ja = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ,
                           collect_trace=True)
    tl, tc, ta = TM.prefill(tp, tcfg, _t(toks), MAX_SEQ, collect_trace=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for step in range(2):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc, ja = j_decode(jp, jcfg, jt, jc, collect_trace=True)
        tl, tc, ta = TM.decode_step(tp, tcfg, tt, tc, collect_trace=True)
        assert tl.shape == (2, tcfg.vocab_size)
        assert torch.isfinite(tl).all(), arch
        assert int(tc["pos"]) == 16 + step + 1 == int(jc["pos"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        if tcfg.has_moe:
            np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                          np.asarray(ja["moe"]["ids"]))


# ------------------------------------------------------------------ windows
def _window_model(arch="smollm-360m", **over):
    jcfg, tcfg = _cfgs(arch, sliding_window=8, **over)
    return (jcfg, tcfg, *_both(_tree(tcfg)))


def test_window_sliced_decode_exact():
    """``tests/test_perf_variants.py:70`` on both packages: with
    ``always_swa`` a decode step (the compact read of the last 8 of 24
    cache rows) equals the windowed forward's last position."""
    jcfg, tcfg, jp, tp = _window_model(always_swa=True)
    toks = _tokens(tcfg.vocab_size, (1, 20), seed=2)
    for cfg, params, pkg, arr in ((jcfg, jp, JM, jnp.asarray),
                                  (tcfg, tp, TM, _t)):
        lp, cache, _ = pkg.prefill(params, cfg, arr(toks), max_seq=24)
        t = np.asarray(lp).argmax(-1) if pkg is JM else lp.argmax(-1)
        t = jnp.asarray(t, jnp.int32) if pkg is JM else t
        ld, _, _ = pkg.decode_step(params, cfg, t, cache)
        full = np.concatenate([toks, np.asarray(t)[:, None]], 1)
        h, _ = pkg.forward(params, cfg, arr(full))
        oracle = pkg.unembed(params, cfg, h[:, -1])
        np.testing.assert_allclose(np.asarray(ld), np.asarray(oracle),
                                   atol=1e-4)


def test_windowed_decode_steps_hold_against_the_windowed_forward():
    """``use_window=True`` (not ``always_swa``) over several steps past
    the window: each step's logits equal the windowed forward's last
    position and the reference's step; the unwindowed forward differs."""
    jcfg, tcfg, jp, tp = _window_model("starcoder2-3b")
    toks = _tokens(tcfg.vocab_size, (1, 14), seed=5)
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=20,
                          use_window=True)
    tl, tc, _ = TM.prefill(tp, tcfg, _t(toks), 20, use_window=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    seq = toks
    for _ in range(4):
        tt = torch.argmax(tl, -1)
        seq = np.concatenate([seq, tt.numpy()[:, None].astype(np.int32)], 1)
        jl, jc, _ = j_decode(jp, jcfg, jnp.asarray(tt.numpy(), jnp.int32),
                             jc, use_window=True)
        tl, tc, _ = TM.decode_step(tp, tcfg, tt, tc, use_window=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        with torch.no_grad():
            h, _ = TM.forward(tp, tcfg, _t(seq), use_window=True)
            oracle = TM.unembed(tp, tcfg, h[:, -1])
            h_all, _ = TM.forward(tp, tcfg, _t(seq))
            unwindowed = TM.unembed(tp, tcfg, h_all[:, -1])
        tol = 1e-4 + 1e-4 * oracle.abs()
        assert bool(((tl - oracle).abs() <= tol).all())
        assert not bool(((unwindowed - oracle).abs() <= tol).all())


def test_vector_positions_read_the_window_by_mask():
    """Two sequences prefilled at 20 and 13 tokens, packed into one cache
    with per-sequence positions: the masked full read gives each
    sequence's windowed forward, and the 20-token row equals the compact
    read of an aligned step."""
    jcfg, tcfg, jp, tp = _window_model(always_swa=True)
    prompts = [_tokens(tcfg.vocab_size, (1, n), seed=10 + n) for n in (20, 13)]
    batch = TM.init_cache(tcfg, 2, 24, device="cpu")
    batch["pos"] = torch.zeros((2,), dtype=torch.int64)
    first, caches = [], []
    for slot, toks in enumerate(prompts):
        lp, cache, _ = TM.prefill(tp, tcfg, _t(toks), 24)
        caches.append(cache)
        batch = TPE.install_slot(batch, cache, slot)
        first.append(int(torch.argmax(lp, -1)[0]))
    assert batch["pos"].tolist() == [20, 13]
    token = torch.tensor(first)
    ld, _, _ = TM.decode_step(tp, tcfg, token, batch)
    aligned, _, _ = TM.decode_step(tp, tcfg, token[:1], caches[0])
    np.testing.assert_allclose(ld[:1].numpy(), aligned.numpy(), atol=1e-5)
    for slot, toks in enumerate(prompts):
        full = np.concatenate([toks, [[first[slot]]]], 1)
        with torch.no_grad():
            h, _ = TM.forward(tp, tcfg, _t(full))
            oracle = TM.unembed(tp, tcfg, h[:, -1])
        np.testing.assert_allclose(ld[slot:slot + 1].numpy(), oracle.numpy(),
                                   atol=1e-4)
    # The reference's batched decode over the same packed cache.
    jb = jax.tree.map(lambda t: jnp.asarray(t.numpy()), batch)
    jld, _, _ = j_decode(jp, jcfg, jnp.asarray(first, jnp.int32), jb)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), atol=1e-4)


@pytest.mark.parametrize("arch", ["gemma-7b", "llama4-scout-17b-a16e"])
def test_windowed_forward_and_softcap_match_reference(arch):
    """The window where it bites (20 tokens, window 8) with Gemma's
    soft-capped attention and Scout's MoE blocks."""
    jcfg, tcfg, jp, tp = _window_model(arch)
    toks = _tokens(tcfg.vocab_size, (2, 20), seed=6)
    jh, _ = j_forward(jp, jcfg, jnp.asarray(toks), use_window=True)
    with torch.no_grad():
        th, _ = TM.forward(tp, tcfg, _t(toks), use_window=True)
        th_all, _ = TM.forward(tp, tcfg, _t(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    assert float((th - th_all).abs().max()) > 1e-3


# -------------------------------------------------------------- vocabularies
@pytest.mark.parametrize("arch", ["smollm-360m", "nemotron-4-15b"],
                         ids=["tied", "untied"])
def test_pad_vocab(arch):
    """``pad_vocab_to=96`` pads 512 to 576: the pad columns' logits are
    -1e30, the loss equals the unpadded model's over the same weights,
    and both equal the reference's."""
    jcfg, tcfg = _cfgs(arch, pad_vocab_to=96)
    _, tbase = _cfgs(arch)
    assert tcfg.padded_vocab == 576 and tbase.padded_vocab == 512
    tree = _tree(tcfg, seed=4)
    jp, tp = _both(tree)
    base = dict(tp)
    if tcfg.tie_embeddings:
        assert tp["embed"].shape[0] == 576 and "unembed" not in tp
        base["embed"] = tp["embed"][:512]
    else:
        assert tp["embed"].shape[0] == 512
        assert tp["unembed"].shape[1] == 576
        base["unembed"] = tp["unembed"][:, :512]
    toks = _tokens(512, (2, 16), seed=7)
    with torch.no_grad():
        h, _ = TM.forward(tp, tcfg, _t(toks))
        logits = TM.unembed(tp, tcfg, h)
        loss, _ = TM.lm_loss(tp, tcfg, _t(toks), _t(toks))
        loss_base, _ = TM.lm_loss(base, tbase, _t(toks), _t(toks))
    assert logits.shape[-1] == 576
    assert bool((logits[..., 512:] == -1e30).all())
    assert int(logits.argmax(-1).max()) < 512
    np.testing.assert_allclose(float(loss), float(loss_base), rtol=1e-6)
    jl, _ = j_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(toks))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jlp, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ)
    tlp, tc, _ = TM.prefill(tp, tcfg, _t(toks), MAX_SEQ)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_crosses_bridge_and_checkpoint(arch, tmp_path):
    """A tied tree (no ``unembed``) and the one-matrix ``wi`` of the
    ungated MLPs cross the bridge and both packages' checkpoint readers
    bit for bit."""
    _, tcfg = _cfgs(arch)
    tree = _tree(tcfg)
    assert ("unembed" in tree) == (not tcfg.tie_embeddings)
    blk = tree["blocks"]["pos0"]
    ffn = blk["moe"]["experts"] if tcfg.has_moe else blk["mlp"]
    gated = tcfg.mlp_type in ("swiglu", "geglu")
    d_ff = tcfg.moe.d_ff if tcfg.has_moe else tcfg.d_ff
    assert ffn["wi"].shape[-1] == (2 if gated else 1) * d_ff
    TCK.save(str(tmp_path / "ckpt"), {"params": params_from_numpy(tree,
                                                                  "cpu")})
    back = TCK.restore(str(tmp_path / "ckpt"), device="cpu")["params"]
    ref = JCK.restore(str(tmp_path / "ckpt"))["params"]
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(jax.tree_util.tree_leaves(ref)) == len(flat)
    for path, want in flat:
        got, jgot = back, ref
        for k in path:
            got, jgot = got[k.key], jgot[k.key]
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.asarray(jgot), want)


# ------------------------------------------------------------------ serving
def test_server_dense_arch():
    """``tests/test_system.py:71-79`` on the port: ``smollm-360m``
    through ``SliceMoEServer(engine_cfg=None)``, that is
    ``PlainEngine``."""
    cfg = TC.get_config("smollm-360m").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    server = TSV.SliceMoEServer(cfg, params, engine_cfg=None, max_seq=64,
                                device="cpu")
    server.submit(TSV.Request(request_id=0,
                              prompt=np.arange(16, dtype=np.int32),
                              max_new_tokens=4))
    done = server.run()
    assert len(done[0].tokens) == 4
    assert server._engine is None and done[0].metrics is None


def _serve_dense(SV, cfg, params, **kw):
    server = SV.SliceMoEServer(cfg, params, engine_cfg=None, max_seq=64,
                               **kw)
    for i in range(2):
        server.submit(SV.Request(
            request_id=i, prompt=_tokens(cfg.vocab_size, (12,), seed=20 + i),
            max_new_tokens=6))
    return [np.asarray(c.tokens).tolist() for c in server.run()]


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma-7b"])
def test_dense_server_tokens_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_tree(tcfg))
    ref = _serve_dense(JSV, jcfg, jp)
    port = _serve_dense(TSV, tcfg, tp, device="cpu")
    assert port == ref and all(len(t) == 6 for t in port)
    # The plain engine's loop, by hand.
    toks = _tokens(tcfg.vocab_size, (1, 12), seed=20)
    logits, cache, _ = TM.prefill(tp, tcfg, _t(toks), 64)
    token, out = torch.argmax(logits, -1), []
    for _ in range(6):
        out.append(int(token[0]))
        logits, cache, _ = TM.decode_step(tp, tcfg, token, cache)
        token = torch.argmax(logits, -1)
    assert out == port[0]


CLI = ["--arch", "smollm-360m", "--reduced", "--n-requests", "2",
       "--prompt-len", "8", "--max-new", "4", "--seed", "2"]


def _cli_lines(text):
    return [{k: v for k, v in json.loads(line).items()
             if k not in ("prefill_s", "decode_s")}
            for line in text.splitlines() if line.startswith("{")]


def test_cli_serves_a_dense_arch(tmp_path, capsys, monkeypatch):
    """``--arch smollm-360m``: the CLI passes no engine config (the
    reference's ``launch/serve.py:314``), so ``PlainEngine`` serves; its
    lines equal the reference CLI's on one checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    TCK.save(ckpt, {"params": TM.init_params(
        TC.get_config("smollm-360m").reduced(), seed=0, device="cpu")})
    built = []

    class Recording(TSV.SliceMoEServer):
        def __init__(self, *a, **kw):
            built.append(kw.get("engine_cfg"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(TSERVE, "SliceMoEServer", Recording)
    capsys.readouterr()
    TSERVE.main(CLI + ["--device", "cpu", "--ckpt", ckpt])
    port = _cli_lines(capsys.readouterr().out)
    assert built == [None]
    assert port == [{"request": i, "n_tokens": 4} for i in range(2)]
    monkeypatch.setattr(sys, "argv", ["serve"] + CLI + ["--ckpt", ckpt])
    JSERVE.main()
    assert _cli_lines(capsys.readouterr().out) == port


def _scout_view(ref: bool):
    """llama4-scout reduced (4 experts top-1, one shared expert) at f32
    through the package's persistent SliceMoE server with quantized
    execution: every completion's tokens, decode totals and cache stats."""
    jcfg, tcfg = _cfgs("llama4-scout-17b-a16e")
    tree = _tree(tcfg, seed=1)
    if ref:
        cfg, params, SV, EC, Mat, RP = (jcfg, jax.tree.map(jnp.asarray, tree),
                                        JSV, JEC, JMat, JRP)
        kw = {}
    else:
        cfg, params, SV, EC, Mat, RP = (tcfg, params_from_numpy(tree, "cpu"),
                                        TSV, TEC, TMat, TRP)
        kw = {"device": "cpu"}
    ecfg = EC(mat=Mat(8, 4), cache_bytes=4.0e5,
              policy=RP(kind="cache_prior", slice_mode="dbsc",
                        quant_execution=True),
              miss_rate_target=0.1, warmup="pcw")
    server = SV.SliceMoEServer(cfg, params, engine_cfg=ecfg, max_seq=32,
                               **kw)
    for i in range(2):
        server.submit(SV.Request(
            request_id=i, prompt=_tokens(cfg.vocab_size, (12,), seed=30 + i),
            max_new_tokens=5))
    return [{"id": c.request_id, "tokens": np.asarray(c.tokens).tolist(),
             "decode_totals": c.metrics["decode_totals"],
             "cache_stats": c.metrics["cache_stats"]} for c in server.run()]


def test_llama4_scout_served_by_both_packages():
    port = run_both(lambda ns: _scout_view(ref=ns is REF))
    assert [len(c["tokens"]) for c in port] == [5, 5]
    assert all(c["decode_totals"]["total_energy_j"] > 0 for c in port)


# ------------------------------------------------ once unported settings
def _over_id(d):
    return next(iter(d)) + "=" + str(next(iter(d.values())))


def _cache_view(cache):
    """An ``init_cache`` tree's leaves as (shape, dtype name)."""
    return {k: {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for n, t in v.items()}
            for k, v in cache.items() if k != "pos"}


@pytest.mark.parametrize("over", [
    dict(ring_kv=True), dict(quantized_serve=True),
], ids=_over_id)
def test_unported_settings_name_their_queue_item(over):
    """The two settings that raised until the serving variants were
    ported (queue 1 item 1d): both now build, with the reference's
    ``param_shapes`` and ``init_cache``, on a dense and a MoE config."""
    for arch in ("smollm-360m", "llama4-scout-17b-a16e"):
        jcfg = dataclasses.replace(get_config(arch).reduced(), **over)
        tcfg = dataclasses.replace(TC.get_config(arch).reduced(), **over)
        assert TM.param_shapes(tcfg) == JM.param_shapes(jcfg)
        assert _cache_view(TM.init_cache(tcfg, 1, 8, device="cpu")) == \
            _cache_view(JM.init_cache(jcfg, 1, 8))


@pytest.mark.parametrize("over", [
    dict(arch_type="vlm"),
    dict(arch_type="audio"), dict(prefix_len=4), dict(encoder_layers=2),
], ids=_over_id)
def test_prefix_and_encoder_settings_match_reference(over):
    """The four settings that raised until prefix embeddings and the
    encoder-decoder were ported: ``param_shapes`` and ``init_cache`` (its
    leaves, shapes and dtypes) equal the reference's."""
    jcfg = dataclasses.replace(get_config("smollm-360m").reduced(), **over)
    tcfg = dataclasses.replace(TC.get_config("smollm-360m").reduced(), **over)
    assert TM.param_shapes(tcfg) == JM.param_shapes(jcfg)
    got = TM.init_cache(tcfg, 2, 8, device="cpu")
    assert _cache_view(got) == _cache_view(JM.init_cache(jcfg, 2, 8))
    assert ("ck" in got["pos0"]) == bool(over.get("encoder_layers"))
