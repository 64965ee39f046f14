"""Port parity: the Mamba2 (SSD) mixer and the ``ssm`` and ``hybrid``
architectures, held against ``repro.models.ssm`` and
``repro.models.model`` on one numpy tree.

* Module level: ``ssd_chunked`` at lengths equal to, shorter than,
  longer than and not a multiple of the chunk, with and without
  ``init_state``; ``_segsum`` and ``_causal_conv``; ``ssm_forward`` with
  ``return_state`` and ``init_conv`` at 1, 2, 3 and 40 tokens (the
  left-padded conv window); ``ssm_decode_step`` chained from a prefill
  state.  Tolerances of ``tests/test_ssm.py``: y 2e-4, state 1e-4, conv
  1e-5.  The SSM parameters are one mixer of the port's init for
  ``mamba2-2.7b`` reduced (its special ``A_log``, ``D``, ``dt_bias`` and
  ``conv_w``).
* Configs: ``mamba2-2.7b`` and ``jamba-v0.1-52b`` equal the reference's
  field for field (``ssm`` and ``pattern`` included), full and
  ``.reduced()``, with the same properties, parameter shapes and counts
  (2831296000 and 51460000640).
* Model level, each ``.reduced()`` config at f32 (TF32 off): ``forward``
  and ``lm_loss`` with ``lm_loss``'s gradients against ``jax.grad``;
  ``prefill``, then 6 ``decode_step``s of two prompts packed at
  per-sequence positions with an idle third slot masked out; the
  ``init_cache`` tree's shapes and dtypes at the model's bf16.  Logits
  at 1e-4, tokens and Jamba's routing ids exact.
* An SSM position without an ``SSMCfg`` is refused by both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core.engine import PersistentEngine as JPE
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["mamba2-2.7b", "jamba-v0.1-52b"]
PROPS = ("padded_vocab", "has_attention", "has_ssm", "has_moe", "is_encdec",
         "subquadratic", "n_periods")
COUNTS = {"mamba2-2.7b": 2831296000, "jamba-v0.1-52b": 51460000640}
Y_TOL, STATE_TOL, CONV_TOL = 2e-4, 1e-4, 1e-5
MAX_SEQ = 32


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(arch, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(TC.get_config(arch).reduced(), **over))


def _tree(tcfg, seed=0):
    return jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=seed, device="cpu"))


# -------------------------------------------------------------- module level
# The reference's functions under jit, one compile per shape, as its model
# runs them (eager, each primitive would compile on its own).
j_ssd = jax.jit(JS.ssd_chunked, static_argnums=5)
j_ssm_forward = jax.jit(JS.ssm_forward, static_argnames=("cfg",
                                                         "return_state"))
j_ssm_decode = jax.jit(JS.ssm_decode_step, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def mixer():
    """(SSMCfg of both packages, d_model, the numpy params of one mixer)."""
    _, tcfg = _cfgs("mamba2-2.7b")
    tree = _tree(tcfg, seed=3)
    p = {k: v[0] for k, v in tree["blocks"]["pos0"]["ssm"].items()}
    jcfg = JS.SSMCfg(**dataclasses.asdict(tcfg.ssm))
    return jcfg, tcfg.ssm, tcfg.d_model, p


def test_mixer_init_is_the_references_rule(mixer):
    """``A_log``, ``D`` and ``dt_bias`` equal the reference's init (f32 in
    the bf16 model), ``conv_w`` is drawn at the reference's 0.2 in the
    model dtype, and the shapes are the reference's."""
    _, cfg, d_model, p = mixer
    jcfg = get_config("mamba2-2.7b").reduced()
    tcfg = TC.get_config("mamba2-2.7b").reduced()
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    want = JM.init_params(jcfg, jax.random.PRNGKey(0))["blocks"]["pos0"]
    got = TM.init_params(tcfg, seed=0, device="cpu")["blocks"]["pos0"]
    for name in ("A_log", "D", "dt_bias"):
        w, g = np.asarray(want["ssm"][name]), got["ssm"][name]
        assert w.dtype == np.float32 and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, err_msg=name)
    assert got["ssm"]["conv_w"].dtype == torch.bfloat16
    assert str(want["ssm"]["conv_w"].dtype) == "bfloat16"
    for conv_w in (got["ssm"]["conv_w"].float().numpy(),
                   np.asarray(want["ssm"]["conv_w"], np.float32)):
        assert 0.18 < conv_w.std() < 0.22
    assert {k: v.shape for k, v in p.items()} == \
        TS.ssm_param_shapes(d_model, cfg) == \
        JS.ssm_param_shapes(d_model, JS.SSMCfg(**dataclasses.asdict(cfg)))


def _scan_inputs(b, l, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    B_ = (0.5 * rng.standard_normal((b, l, n))).astype(np.float32)
    C_ = (0.5 * rng.standard_normal((b, l, n))).astype(np.float32)
    init = (0.3 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    return x, dt, A, B_, C_, init


@pytest.mark.parametrize("length", [16, 15, 40, 48])
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_ssd_chunked_matches_reference(length, with_init):
    """Chunk 16: one chunk whole, one chunk padded, 2.5 chunks, 3 whole."""
    x, dt, A, B_, C_, init = _scan_inputs(2, length, 4, 8, 16, seed=length)
    init = init if with_init else None
    jy, js = j_ssd(*map(jnp.asarray, (x, dt, A, B_, C_)), 16,
                   None if init is None else jnp.asarray(init))
    ty, ts = TS.ssd_chunked(*map(_t, (x, dt, A, B_, C_)), 16,
                            None if init is None else _t(init))
    assert ty.shape == (2, length, 4, 8) and ty.dtype == torch.float32
    assert ts.shape == (2, 4, 8, 16) and ts.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=STATE_TOL)


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_ssd_chunk_size_invariance(chunk):
    """``tests/test_ssm.py::test_chunk_size_invariance`` on both packages:
    at each chunk size the port equals the reference, and both equal the
    reference at chunk 24 (one chunk, no recurrence)."""
    args = _scan_inputs(2, 24, 4, 8, 16, seed=9)[:5]
    want = np.asarray(j_ssd(*map(jnp.asarray, args), 24, None)[0])
    jy = np.asarray(j_ssd(*map(jnp.asarray, args), chunk, None)[0])
    ty = TS.ssd_chunked(*map(_t, args), chunk)[0].numpy()
    np.testing.assert_allclose(ty, jy, atol=Y_TOL)
    np.testing.assert_allclose(ty, want, atol=1e-4)


def test_segsum_and_causal_conv_match_reference():
    rng = np.random.default_rng(4)
    t = rng.standard_normal((2, 3, 16)).astype(np.float32)
    want = np.asarray(JS._segsum(jnp.asarray(t)))
    got = TS._segsum(_t(t)).numpy()
    assert np.isneginf(got).sum() == 2 * 3 * (16 * 15 // 2)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6)

    x = rng.standard_normal((2, 10, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        TS._causal_conv(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(JS._causal_conv(*map(jnp.asarray, (x, w, b)))),
        atol=1e-6)


def _u(length, d_model, seed, b=2):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (b, length, d_model))).astype(np.float32)


@pytest.mark.parametrize("length", [1, 2, 3, 40])
def test_ssm_forward_with_state_matches_reference(mixer, length):
    """``return_state`` from a zero window (the model's prefill) and
    continued from ``init_state`` and ``init_conv``.  Under 3 tokens the
    window is padded on the left; with ``init_conv`` the reference pads
    the already long window and returns 6 rows, of which the port returns
    the last 3 (``repro_torch.models.ssm``'s departure)."""
    jcfg, tcfg, d_model, p = mixer
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    u = _u(length, d_model, seed=length)
    jy, (js, jconv) = j_ssm_forward(jp, jnp.asarray(u), cfg=jcfg,
                                    return_state=True)
    ty, (ts, tconv) = TS.ssm_forward(tp, _t(u), tcfg, return_state=True)
    assert tconv.shape == (2, 3, tcfg.conv_channels(d_model))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=STATE_TOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv),
                               atol=CONV_TOL)
    if length < 3:
        assert not tconv[:, :3 - length].any()

    # Continue from that state with a second stretch of the same length.
    u2 = _u(length, d_model, seed=100 + length)
    jy2, (js2, jconv2) = j_ssm_forward(
        jp, jnp.asarray(u2), cfg=jcfg, init_state=js, init_conv=jconv,
        return_state=True)
    ty2, (ts2, tconv2) = TS.ssm_forward(
        tp, _t(u2), tcfg, init_state=ts, init_conv=tconv, return_state=True)
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), atol=Y_TOL)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), atol=STATE_TOL)
    assert jconv2.shape[1] == (3 if length >= 3 else 6)
    assert tconv2.shape == (2, 3, tcfg.conv_channels(d_model))
    np.testing.assert_allclose(tconv2.numpy(), np.asarray(jconv2)[:, -3:],
                               atol=CONV_TOL)
    # The continuation equals the forward over both stretches at once.
    yy = TS.ssm_forward(tp, _t(np.concatenate([u, u2], 1)), tcfg)
    np.testing.assert_allclose(ty2.numpy(), yy[:, length:].numpy(),
                               atol=Y_TOL)


def test_decode_steps_chained_from_prefill_match_reference(mixer):
    """Prefill 20 tokens, then 6 ``ssm_decode_step``s in both packages;
    every step also equals the forward over the whole sequence."""
    jcfg, tcfg, d_model, p = mixer
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    u = _u(26, d_model, seed=7)
    _, (js, jconv) = j_ssm_forward(jp, jnp.asarray(u[:, :20]), cfg=jcfg,
                                   return_state=True)
    _, (ts, tconv) = TS.ssm_forward(tp, _t(u[:, :20]), tcfg,
                                    return_state=True)
    full = TS.ssm_forward(tp, _t(u), tcfg)
    for t in range(20, 26):
        jy, js, jconv = j_ssm_decode(jp, jnp.asarray(u[:, t]), js, jconv,
                                     cfg=jcfg)
        ty, ts, tconv = TS.ssm_decode_step(tp, _t(u[:, t]), ts, tconv, tcfg)
        assert ts.dtype == torch.float32
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                   atol=STATE_TOL)
        np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv),
                                   atol=CONV_TOL)
        np.testing.assert_allclose(ty.numpy(), full[:, t].numpy(),
                                   atol=Y_TOL)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    j, t = get_config(arch), TC.get_config(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        td = dataclasses.asdict(tc)
        assert {k: td.pop(k) for k in TC.PORT_ONLY} == TC.PORT_ONLY
        assert td == dataclasses.asdict(jc)
        assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
        for prop in PROPS:
            assert getattr(tc, prop) == getattr(jc, prop), prop
        assert [(b.mixer, b.ffn) for b in tc.block_pattern] == \
            [(b.mixer, b.ffn) for b in jc.block_pattern]
        assert TM.param_shapes(tc) == JM.param_shapes(jc)
        assert tc.param_count() == jc.param_count()
    assert t.param_count() == COUNTS[arch]
    assert (t.reduced().ssm.d_state, t.reduced().ssm.head_dim,
            t.reduced().ssm.chunk) == (16, 32, 32)


def test_ssm_position_needs_an_ssm_config():
    """Both packages refuse ``arch_type="ssm"`` without an ``SSMCfg``."""
    jc = dataclasses.replace(get_config("smollm-360m").reduced(),
                             arch_type="ssm")
    tc = dataclasses.replace(TC.get_config("smollm-360m").reduced(),
                             arch_type="ssm")
    with pytest.raises(AssertionError):
        JM.param_shapes(jc)
    with pytest.raises(ValueError, match="SSMCfg"):
        TM.param_shapes(tc)


# -------------------------------------------------------------- model level
j_forward = jax.jit(JM.forward, static_argnames=("cfg", "collect_trace"))
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_seq",
                                                 "collect_trace"))
j_decode = jax.jit(JM.decode_step, static_argnames=("cfg", "collect_trace"))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    tree = _tree(tcfg)
    return (request.param, jcfg, tcfg, tree, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_forward_matches_reference(model):
    arch, jcfg, tcfg, _, jp, tp = model
    toks = _tokens(tcfg.vocab_size, (2, 40), seed=1)
    jh, jaux = j_forward(jp, jcfg, jnp.asarray(toks), collect_trace=True)
    with torch.no_grad():
        th, taux = TM.forward(tp, tcfg, _t(toks).long(), collect_trace=True)
        logits = TM.unembed(tp, tcfg, th)
    assert torch.isfinite(logits).all(), arch
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(JM.unembed(jp, jcfg, jh)),
                               atol=1e-4)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), atol=1e-6)
    assert ("moe" in taux) == tcfg.has_moe == ("moe" in jaux)
    if tcfg.has_moe:
        # Jamba: only the 4 MoE positions of each period give aux.
        assert taux["moe"]["ids"].shape[:2] == (tcfg.n_periods, 4)
        for k in jaux["moe"]:
            assert taux["moe"][k].shape == jaux["moe"][k].shape, k
        np.testing.assert_array_equal(taux["moe"]["ids"].numpy(),
                                      np.asarray(jaux["moe"]["ids"]))
        np.testing.assert_allclose(taux["moe"]["gates"].numpy(),
                                   np.asarray(jaux["moe"]["gates"]),
                                   atol=1e-5)


@pytest.fixture(scope="module")
def j_grad():
    return jax.jit(jax.value_and_grad(
        lambda p, cfg, t: JM.lm_loss(p, cfg, t, t)[0]), static_argnums=1)


def test_lm_loss_and_gradients_match_reference(model, j_grad):
    arch, jcfg, tcfg, tree, jp, _ = model
    toks = _tokens(tcfg.vocab_size, (2, 24), seed=2)
    jl, jg = j_grad(jp, jcfg, jnp.asarray(toks))
    tp = jax.tree.map(lambda a: _t(np.array(a)).requires_grad_(True), tree)
    tl, _ = TM.lm_loss(tp, tcfg, _t(toks).long(), _t(toks).long())
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    n = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        got = tp
        for k in path:
            got = got[k.key]
        assert got.grad is not None, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            got.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4,
            err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(jax.tree_util.tree_leaves(tree))


def test_prefill_and_batched_decode_match_reference(model):
    """Two prompts (16 and 9 tokens) prefilled one at a time and packed
    into slots 0 and 1 of a 3-slot cache at per-sequence positions; slot 2
    idle and masked out of MoE routing.  Six steps in both packages."""
    arch, jcfg, tcfg, _, jp, tp = model
    jb = JM.init_cache(jcfg, 3, MAX_SEQ)
    jb["pos"] = jnp.zeros((3,), jnp.int32)
    tb = TM.init_cache(tcfg, 3, MAX_SEQ, device="cpu")
    tb["pos"] = torch.zeros((3,), dtype=torch.int64)
    first = np.zeros(3, np.int32)
    for slot, n in enumerate((16, 9)):
        toks = _tokens(tcfg.vocab_size, (1, n), seed=10 + n)
        jl, jc, ja = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ,
                               collect_trace=True)
        tl, tc, ta = TM.prefill(tp, tcfg, _t(toks).long(), MAX_SEQ,
                                collect_trace=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        for key in (k for k in tc if k != "pos"):
            for name, leaf in tc[key].items():
                np.testing.assert_allclose(
                    leaf.numpy(), np.asarray(jc[key][name]), atol=1e-4,
                    err_msg=f"{key}/{name}")
        if tcfg.has_moe:
            np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                          np.asarray(ja["moe"]["ids"]))
        jb = JPE.install_slot(jb, jc, slot)
        tb = TPE.install_slot(tb, tc, slot)
        first[slot] = int(np.argmax(np.asarray(jl), -1)[0])
    mask = np.array([True, True, False])
    buffers = {(key, name): leaf for key, entry in tb.items() if key != "pos"
               for name, leaf in entry.items()}
    jt, tt = jnp.asarray(first), _t(first).long()
    for _ in range(6):
        jl, jb, ja = j_decode(jp, jcfg, jt, jb, collect_trace=True,
                              token_mask=jnp.asarray(mask))
        tl, tb, ta = TM.decode_step(tp, tcfg, tt, tb, collect_trace=True,
                                    token_mask=_t(mask))
        # The cache is written in place: the same tensors come back.
        assert all(tb[key][name] is leaf
                   for (key, name), leaf in buffers.items())
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=1e-4)
        np.testing.assert_array_equal(tb["pos"].numpy(),
                                      np.asarray(jb["pos"]))
        if tcfg.has_moe:
            np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                          np.asarray(ja["moe"]["ids"]))
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy()[mask], np.asarray(jt)[mask])
    for key in (k for k in tb if k != "pos"):
        for name, leaf in tb[key].items():
            want = np.asarray(jb[key][name])
            np.testing.assert_allclose(leaf.numpy()[:, :2], want[:, :2],
                                       atol=1e-4, err_msg=f"{key}/{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """At the config's own bf16: SSM ``state`` f32, ``conv`` bf16, KV
    rows bf16, shapes as the reference's."""
    jc, tc = get_config(arch).reduced(), TC.get_config(arch).reduced()
    jcache = JM.init_cache(jc, 3, 20)
    tcache = TM.init_cache(tc, 3, 20, device="cpu")
    assert set(tcache) == set(jcache)
    for key in (k for k in jcache if k != "pos"):
        assert set(tcache[key]) == set(jcache[key])
        for name, leaf in jcache[key].items():
            got = tcache[key][name]
            assert tuple(got.shape) == leaf.shape, (key, name)
            assert str(got.dtype).replace("torch.", "") == str(leaf.dtype)
            assert not got.any()
    kinds = {tuple(sorted(e)) for k, e in tcache.items() if k != "pos"}
    assert kinds == ({("conv", "state")} if arch == "mamba2-2.7b"
                     else {("conv", "state"), ("k", "v")})
