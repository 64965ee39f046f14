"""Port parity: the encoder-decoder (the Whisper stub), ``whisper-small``
reduced (2 + 2 layers, 16 frames), against ``repro.models.model`` on one
numpy tree (the port's CPU init, carried to both packages through
``repro_torch.bridge``).

* ``param_shapes`` (the ``encoder`` subtree and the ``c_``-prefixed
  cross-attention leaves) at full width and reduced.
* ``_encode``, ``forward`` with frames, ``prefill`` logits and its
  ``ck`` / ``cv``, decode steps at a scalar position and at ``[B]``
  positions with a ``token_mask``: f32 at 1e-4 with exact tokens
  (``tests/test_system.py:172-177``); bf16 at atol 5e-2: matmuls
  accumulate in another order on the two sides and round to bf16 at
  every block, so the hidden states differ by up to one bf16 step
  (0.03125 at magnitudes of 4 to 8) and the logits, which the jitted
  reference leaves unrounded, by up to 0.035 over four decode steps
  (measured); ``tests/test_torch_layers.py`` holds one bf16 MLP at
  2e-2.
* ``lm_loss`` and its gradients, every encoder leaf included, against
  ``jax.grad`` (f32: loss rtol 1e-5, gradients atol 1e-5; bf16: loss
  rtol 2^-8, gradients within 5% of each leaf's largest entry).
* ``init_cache`` leaves and dtypes with bf16 and with int8 KV (``ck`` /
  ``cv`` stay in the model dtype), equal to the reference's and to the
  cache ``prefill`` returns.
* ``decode_step`` accepts ``encoder_frames`` and ignores it, and returns
  the ``ck`` / ``cv`` tensors it was given, unchanged.
* ``PlainEngine.generate`` with ``encoder_frames``: tokens equal.
* A missing ``encoder_frames``: the port raises ``ValueError`` naming it
  where the reference asserts; so both packages' servers and CLIs, which
  call ``generate`` without keywords, refuse ``whisper-small``.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.launch import serve as JSERVE
from repro.models import model as JM
from repro.serving import server as JSV
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.launch import serve as TSERVE
from repro_torch.models import model as TM
from repro_torch.serving import server as TSV

torch.set_num_threads(1)

ARCH = "whisper-small"
MAX_SEQ = 32
BF16_TOL = dict(atol=5e-2)

j_forward = jax.jit(JM.forward, static_argnames=("cfg",))
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_seq"))
j_decode = jax.jit(JM.decode_step, static_argnames=("cfg",))
j_encode = jax.jit(JM._encode, static_argnames=("cfg",))


def _cfgs(dtype, **over):
    return (dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype,
                                **over),
            dataclasses.replace(TC.get_config(ARCH).reduced(), dtype=dtype,
                                **over))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frames(cfg, batch, seed, n=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n or cfg.encoder_seq, cfg.d_model))
            * 0.02).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _tol(dtype):
    return dict(atol=1e-4) if dtype == "float32" else BF16_TOL


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    tree = jax.tree.map(
        lambda t: t.view(torch.int16).numpy().view(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else t.numpy(),
        TM.init_params(tcfg, seed=0, device="cpu"))
    return (request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


# ------------------------------------------------------------------ shapes
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_shapes_equal_reference(reduced):
    j, t = get_config(ARCH), TC.get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    shapes = TM.param_shapes(t)
    assert shapes == JM.param_shapes(j)
    enc = shapes["encoder"]
    assert enc["final_norm"] == (t.d_model,)
    assert enc["blocks"]["wq"][0] == t.encoder_layers
    assert not any(k.startswith("c_") for k in enc["blocks"])
    dec = shapes["blocks"]["pos0"]
    assert {"c_wq", "c_wk", "c_wv", "c_wo", "c_norm"} <= set(dec)
    assert dec["c_norm"] == (t.n_periods, t.d_model)
    assert t.param_count() == j.param_count()


# ------------------------------------------------------- encoder, forward
def test_encode_matches_reference(model):
    dtype, jcfg, tcfg, jp, tp = model
    frames = _frames(tcfg, 2, seed=1)
    want = j_encode(jp, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        got = TM._encode(tp, tcfg, torch.from_numpy(frames))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (2, tcfg.encoder_seq, tcfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_forward_with_frames_matches_reference(model):
    dtype, jcfg, tcfg, jp, tp = model
    toks, frames = _tokens(tcfg.vocab_size, (2, 12), 2), _frames(tcfg, 2, 3)
    jh, _ = j_forward(jp, jcfg, jnp.asarray(toks),
                      encoder_frames=jnp.asarray(frames))
    with torch.no_grad():
        th, _ = TM.forward(tp, tcfg, _t(toks),
                           encoder_frames=torch.from_numpy(frames))
        tl = TM.unembed(tp, tcfg, th[:, -1])
    assert th.shape == (2, 12, tcfg.d_model)
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(_f32(th), _f32(jh), **_tol(dtype))
    np.testing.assert_allclose(
        tl.numpy(), np.asarray(JM.unembed(jp, jcfg, jh[:, -1])),
        **_tol(dtype))
    # The frames matter: other frames, other hidden states.
    with torch.no_grad():
        other, _ = TM.forward(tp, tcfg, _t(toks),
                              encoder_frames=torch.from_numpy(
                                  _frames(tcfg, 2, 4)))
    assert float((other.float() - th.float()).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_gradients_match_reference(dtype):
    """Gradients of every leaf, the encoder's and the cross-attention's
    included.  bf16: the loss within one bf16 rounding (rtol 2^-8; the
    measured gap was up to 4e-4 of it), each gradient within 5% of its
    leaf's largest entry (measured: up to 2.4%)."""
    jcfg, tcfg = _cfgs(dtype)
    tree = jax.tree.map(
        lambda t: t.view(torch.int16).numpy().view(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else t.numpy(),
        TM.init_params(tcfg, seed=1, device="cpu"))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    toks, frames = _tokens(tcfg.vocab_size, (2, 16), 5), _frames(tcfg, 2, 6)
    labels = _tokens(tcfg.vocab_size, (2, 16), 7)

    def j_loss(p):
        return JM.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                          encoder_frames=jnp.asarray(frames))[0]

    jl, jg = jax.jit(jax.value_and_grad(j_loss))(jp)
    leaves = list(TM.tree_leaves(tp))
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl, _ = TM.lm_loss(tp, tcfg, _t(toks), _t(labels),
                       encoder_frames=torch.from_numpy(frames))
    grads = torch.autograd.grad(tl, leaves)
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=1e-5 if f32 else 2 ** -8)
    names = []
    flat_j = jax.tree_util.tree_leaves_with_path(jg)
    by_name = {jax.tree_util.keystr(p): _f32(g) for p, g in flat_j}
    for name, got in zip(_leaf_names(tp), grads):
        want = by_name[name]
        assert got.shape == want.shape, name
        assert got.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(
            _f32(got), want, err_msg=name,
            atol=1e-5 if f32 else 0.05 * float(np.abs(want).max()))
        names.append(name)
    assert len(names) == len(by_name)
    enc = [n for n in names if n.startswith("['encoder']")]
    cross = [n for n in names if "['c_w" in n]
    assert len(enc) > 5 and len(cross) == 4
    assert all(float(np.abs(by_name[n]).max()) > 0 for n in enc + cross)


def _leaf_names(tree, prefix=""):
    """``jax.tree_util.keystr`` names of ``tree``'s leaves in
    ``TM.tree_leaves`` order (sorted keys)."""
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}['{k}']"
        if isinstance(v, dict):
            yield from _leaf_names(v, name)
        else:
            yield name


# ------------------------------------------------------------------- cache
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_init_cache_dtypes_equal_reference(kv_dtype):
    """At the config's bf16: ``k`` / ``v`` bf16 or int8 (with f32
    scales), ``ck`` / ``cv`` bf16 either way; the same leaves, shapes and
    dtypes as the reference's ``init_cache`` and as ``prefill``'s cache."""
    jcfg, tcfg = _cfgs("bfloat16", kv_dtype=kv_dtype)
    got = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    want = JM.init_cache(jcfg, 2, MAX_SEQ)

    def view(tree):
        return {k: {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for n, t in v.items()}
                for k, v in tree.items() if k != "pos"}

    assert view(got) == view(want)
    entry = got["pos0"]
    assert entry["ck"].dtype == entry["cv"].dtype == torch.bfloat16
    assert entry["ck"].shape == (tcfg.n_periods, 2, tcfg.encoder_seq,
                                 tcfg.n_kv_heads, tcfg.head_dim)
    assert entry["k"].dtype == (torch.int8 if kv_dtype == "int8"
                                else torch.bfloat16)
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    _, cache, _ = TM.prefill(tp, tcfg, _t(_tokens(tcfg.vocab_size, (2, 8), 8)),
                             MAX_SEQ, encoder_frames=torch.from_numpy(
                                 _frames(tcfg, 2, 9)))
    assert view(cache) == view(got)


def test_prefill_logits_and_cross_kv_match_reference(model):
    dtype, jcfg, tcfg, jp, tp = model
    toks, frames = _tokens(tcfg.vocab_size, (2, 10), 10), _frames(tcfg, 2, 11)
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ,
                          encoder_frames=jnp.asarray(frames))
    tl, tc, _ = TM.prefill(tp, tcfg, _t(toks), MAX_SEQ,
                           encoder_frames=torch.from_numpy(frames))
    assert int(tc["pos"]) == int(jc["pos"]) == 10
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_tol(dtype))
    for name in ("ck", "cv", "k", "v"):
        got, want = tc["pos0"][name], jc["pos0"][name]
        assert got.dtype == getattr(torch, dtype), name
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype),
                                   err_msg=name)


def test_decode_steps_match_reference(model):
    """Prefill, then four greedy steps in both packages: logits, tokens."""
    dtype, jcfg, tcfg, jp, tp = model
    toks, frames = _tokens(tcfg.vocab_size, (2, 9), 12), _frames(tcfg, 2, 13)
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ,
                          encoder_frames=jnp.asarray(frames))
    tl, tc, _ = TM.prefill(tp, tcfg, _t(toks), MAX_SEQ,
                           encoder_frames=torch.from_numpy(frames))
    for step in range(4):
        tt = torch.argmax(tl, -1)
        if dtype == "float32":
            np.testing.assert_array_equal(tt.numpy(), np.asarray(
                jnp.argmax(jl, -1)))
        jl, jc, _ = j_decode(jp, jcfg, jnp.asarray(tt.numpy(), jnp.int32),
                             jc)
        tl, tc, _ = TM.decode_step(tp, tcfg, tt, tc)
        assert int(tc["pos"]) == int(jc["pos"]) == 10 + step
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **_tol(dtype))


def test_decode_at_vector_positions_with_token_mask():
    """Two requests prefilled apart (8 and 5 tokens, each with its own
    frames) and packed into a 3-slot cache, the third slot idle and
    masked: the port's step equals the reference's over the same packed
    cache (f32), and each live row its own request's aligned step."""
    jcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=2, device="cpu"))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    batch = TM.init_cache(tcfg, 3, MAX_SEQ, device="cpu")
    batch["pos"] = torch.zeros((3,), dtype=torch.int64)
    first, caches = [], []
    for slot, n in enumerate((8, 5)):
        lp, cache, _ = TM.prefill(
            tp, tcfg, _t(_tokens(tcfg.vocab_size, (1, n), 20 + n)), MAX_SEQ,
            encoder_frames=torch.from_numpy(_frames(tcfg, 1, 30 + n)))
        caches.append(cache)
        batch = TPE.install_slot(batch, cache, slot)
        first.append(int(torch.argmax(lp, -1)[0]))
    first.append(0)
    assert batch["pos"].tolist() == [8, 5, 0]
    token, mask = torch.tensor(first), torch.tensor([True, True, False])
    jb = jax.tree.map(lambda t: jnp.asarray(t.numpy()), batch)
    ld, nb, _ = TM.decode_step(tp, tcfg, token, batch, token_mask=mask)
    jld, jnb, _ = j_decode(jp, jcfg, jnp.asarray(first, jnp.int32), jb,
                           token_mask=jnp.asarray(mask.numpy()))
    assert nb["pos"].tolist() == [9, 6, 1] == np.asarray(jnb["pos"]).tolist()
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), atol=1e-4)
    for slot in range(2):
        aligned, _, _ = TM.decode_step(tp, tcfg, token[slot:slot + 1],
                                       caches[slot])
        np.testing.assert_allclose(ld[slot:slot + 1].numpy(),
                                   aligned.numpy(), atol=1e-5)


def test_decode_ignores_encoder_frames_and_keeps_cross_kv():
    """``encoder_frames`` on a decode step changes nothing in either
    package; the port's step returns the very ``ck`` / ``cv`` tensors of
    its input cache, bit-equal to what they were."""
    jcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=3, device="cpu"))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    toks, frames = _tokens(tcfg.vocab_size, (1, 6), 40), _frames(tcfg, 1, 41)
    other = _frames(tcfg, 1, 42)
    _, tc, _ = TM.prefill(tp, tcfg, _t(toks), MAX_SEQ,
                          encoder_frames=torch.from_numpy(frames))
    _, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ,
                         encoder_frames=jnp.asarray(frames))
    token = torch.tensor([3])
    before = {n: tc["pos0"][n].clone() for n in ("ck", "cv")}
    ids = {n: id(tc["pos0"][n]) for n in ("ck", "cv")}
    plain_tc = {k: v.clone() if k == "pos" else
                {n: t.clone() for n, t in v.items()} for k, v in tc.items()}
    l_plain, _, _ = TM.decode_step(tp, tcfg, token, plain_tc)
    l_kw, out, _ = TM.decode_step(tp, tcfg, token, tc,
                                  encoder_frames=torch.from_numpy(other))
    assert torch.equal(l_kw, l_plain)
    for n in ("ck", "cv"):
        assert id(out["pos0"][n]) == ids[n]
        assert torch.equal(out["pos0"][n], before[n])
    jt = jnp.asarray([3], jnp.int32)
    jl_plain, _, _ = j_decode(jp, jcfg, jt, jc)
    jl_kw, _, _ = j_decode(jp, jcfg, jt, jc,
                           encoder_frames=jnp.asarray(other))
    np.testing.assert_array_equal(np.asarray(jl_kw), np.asarray(jl_plain))
    np.testing.assert_allclose(l_kw.numpy(), np.asarray(jl_kw), atol=1e-4)


# ----------------------------------------------------------------- serving
def test_plain_engine_generate_with_frames_matches_reference():
    jcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=4, device="cpu"))
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    prompt, frames = _tokens(tcfg.vocab_size, (7,), 50), _frames(tcfg, 1, 51)
    ref, _ = JSV.PlainEngine(jcfg, jp, MAX_SEQ).generate(
        prompt, 6, encoder_frames=jnp.asarray(frames))
    port, metrics = TSV.PlainEngine(tcfg, tp, MAX_SEQ, device="cpu").generate(
        prompt, 6, encoder_frames=torch.from_numpy(frames))
    assert metrics is None
    assert port.tolist() == np.asarray(ref).tolist()
    assert len(port) == 6
    other, _ = TSV.PlainEngine(tcfg, tp, MAX_SEQ, device="cpu").generate(
        prompt, 6, encoder_frames=_frames(tcfg, 1, 52))
    assert len(other) == 6


@pytest.mark.parametrize("fn", ["forward", "prefill", "lm_loss"])
def test_missing_encoder_frames_is_refused_by_both_packages(fn):
    jcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    toks = _tokens(tcfg.vocab_size, (1, 4), 60)
    calls = {"forward": lambda M, p, c, t: M.forward(p, c, t),
             "prefill": lambda M, p, c, t: M.prefill(p, c, t, MAX_SEQ),
             "lm_loss": lambda M, p, c, t: M.lm_loss(p, c, t, t)}[fn]
    with pytest.raises(ValueError, match="encoder_frames"):
        calls(TM, params_from_numpy(tree, "cpu"), tcfg, _t(toks))
    with pytest.raises(AssertionError):
        calls(JM, jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks))


def test_servers_refuse_whisper():
    """Both servers call ``generate`` without keywords (the reference's
    ``serving/server.py:195-196``), so neither can serve the
    encoder-decoder."""
    jcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    prompt = _tokens(tcfg.vocab_size, (5,), 61)
    servers = ((TSV.SliceMoEServer(tcfg, params_from_numpy(tree, "cpu"),
                                   max_seq=MAX_SEQ, device="cpu"),
                TSV, ValueError),
               (JSV.SliceMoEServer(jcfg, jax.tree.map(jnp.asarray, tree),
                                   max_seq=MAX_SEQ), JSV, AssertionError))
    for server, SV, err in servers:
        server.submit(SV.Request(request_id=0, prompt=prompt,
                                 max_new_tokens=3))
        with pytest.raises(err):
            server.run()


def test_clis_refuse_whisper(monkeypatch):
    argv = ["--arch", ARCH, "--reduced", "--n-requests", "1",
            "--prompt-len", "6", "--max-new", "2"]
    with pytest.raises(ValueError, match="encoder_frames"):
        TSERVE.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(AssertionError):
        JSERVE.main()
