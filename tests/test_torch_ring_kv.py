"""Port parity: the ring-buffer KV cache (``ring_kv``).

Reduced ``smollm-360m`` (dense) and reduced ``llama4-scout-17b-a16e``
(MoE) in f32 with a window of 64 and a cache of 64 rows, one numpy tree
of weights for both packages, each step held against the reference's
``decode_step`` with ``ring_kv=True``:

* scalar positions across the wrap (a 58-token prompt, 10 steps:
  positions 58-67, rows 0-3 overwritten): logits at 1e-4, tokens and
  routing ids exact; the cache's layout exact (each step changes exactly
  row ``pos % 64`` in both packages and leaves every other row bit for
  bit as it was), its values at 1e-4 against the reference's (int8
  codes within one step);
* the same steps against the port's own ``forward(use_window=True)`` at
  the last position (1e-4 + 1e-4*|oracle|), and the unwindowed forward
  outside that tolerance once the prompt has left the window;
* ``[B]`` positions, two slots prefilled at 60 and 50 tokens, 20 steps
  (the first slot wraps at step 4, the second at step 14);
* int8 KV (both packages start from the reference's carried prefill
  cache, as ``tests/test_torch_kv_int8.py`` does), and ring together with
  ``quantized_serve`` (the reference's ``ringkv_qserve`` dry-run variant),
  dense-dequant and quantized execution;
* ``init_cache`` equal to the reference's, and a prompt longer than the
  cache raising in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core.amat import MatConfig as JMat
from repro.models import model as JM
from repro.models.moe import quantize_params_for_serve as j_qserve
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.models import model as TM

torch.set_num_threads(1)

WINDOW = S = 64
PROMPT, STEPS = 58, 10
VEC_LENS, VEC_STEPS = (60, 50), 20
ARCHS = ["smollm-360m", "llama4-scout-17b-a16e"]

j_prefill = jax.jit(JM.prefill, static_argnames=(
    "cfg", "max_seq", "collect_trace", "mat", "quant_execution"))
j_decode = jax.jit(JM.decode_step, static_argnames=(
    "cfg", "collect_trace", "mat", "quant_execution"))


def _cfgs(arch, **over):
    """The reference's and the port's reduced config in f32 with a window
    of 64 and a ring cache (Scout's MoE with ``capacity_factor=8``, as
    ``tests/test_perf_variants.py`` serves it)."""
    out = []
    for get in (get_config, TC.get_config):
        cfg = get(arch).reduced()
        kw = dict(dtype="float32", sliding_window=WINDOW, ring_kv=True)
        if cfg.moe is not None:
            kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=8.0)
        out.append(dataclasses.replace(cfg, **{**kw, **over}))
    return tuple(out)


def _tree(tcfg, seed=0):
    return jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=seed, device="cpu"))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    tree = _tree(tcfg)
    return (request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _attn_keys(cfg):
    return [f"pos{i}" for i, s in enumerate(cfg.block_pattern)
            if s.mixer == "attn"]


def _changed_rows(before, after):
    """The cache rows [.., B, S, ...] -> per-slot rows that differ."""
    diff = np.asarray(before) != np.asarray(after)
    diff = diff.any(axis=tuple(a for a in range(diff.ndim) if a not in (1, 2)))
    return [np.flatnonzero(d).tolist() for d in diff]


def _decode_both(jcfg, tcfg, jp, tp, jl, jc, tl, tc, n_steps, *, positions,
                 mat=None, quant_execution=None):
    """``n_steps`` greedy decode steps in both packages from their own
    caches; each step's logits at 1e-4, tokens and ids exact, and (with
    ``check_layout``) each step's written rows exactly ``pos % S`` in both
    caches with every other row bit for bit unchanged.  Returns the
    port's logits per step and the final caches."""
    jmat = JMat(8, 4) if mat else None
    out = []
    for step in range(n_steps):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        keys = _attn_keys(tcfg)
        t_before = {k: tc[k]["k"].clone() for k in keys}
        j_before = {k: jc[k]["k"] for k in keys}
        jl, jc, ja = j_decode(jp, jcfg, jt, jc, collect_trace=True, mat=jmat,
                              quant_execution=quant_execution)
        tl, tc, ta = TM.decode_step(tp, tcfg, tt, tc, collect_trace=True,
                                    mat=mat, quant_execution=quant_execution)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   err_msg=f"step {step}")
        if tcfg.has_moe:
            np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                          np.asarray(ja["moe"]["ids"]))
        want = [[int(p + step) % S] for p in positions]
        for k in keys:
            assert _changed_rows(t_before[k], tc[k]["k"]) == want
            assert _changed_rows(j_before[k], jc[k]["k"]) == want
        for k in keys:
            for name in tc[k]:
                np.testing.assert_allclose(
                    tc[k][name].numpy().astype(np.float32),
                    np.asarray(jc[k][name]).astype(np.float32),
                    atol=1e-4 if tc[k][name].is_floating_point() else 1)
        out.append(tl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    return out, jc, tc


# ------------------------------------------------------------- scalar, wrap
def test_ring_decode_matches_reference_across_the_wrap(model):
    arch, jcfg, tcfg, jp, tp = model
    toks = _tokens(tcfg.vocab_size, (2, PROMPT), seed=1)
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=S)
    tl, tc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(), S)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _, _, tc = _decode_both(jcfg, tcfg, jp, tp, jl, jc, tl, tc, STEPS,
                            positions=[PROMPT, PROMPT])
    assert tc[_attn_keys(tcfg)[0]]["k"].shape[2] == S
    assert int(tc["pos"]) == PROMPT + STEPS


def test_ring_decode_is_the_windowed_forward(model):
    """The ring step equals ``unembed(forward(..., use_window=True))`` at
    the last position, before and after the wrap; the unwindowed forward
    misses by more once the sequence is longer than the window."""
    arch, jcfg, tcfg, jp, tp = model
    seq = torch.from_numpy(_tokens(tcfg.vocab_size, (1, PROMPT),
                                   seed=2)).long()
    with torch.no_grad():
        logits, cache, _ = TM.prefill(tp, tcfg, seq, S)
        for step in range(STEPS):
            token = torch.argmax(logits, -1)
            seq = torch.cat([seq, token[:, None]], 1)
            logits, cache, _ = TM.decode_step(tp, tcfg, token, cache)
            h, _ = TM.forward(tp, tcfg, seq, use_window=True)
            want = TM.unembed(tp, tcfg, h[:, -1])
            tol = 1e-4 + 1e-4 * want.abs()
            assert bool(((logits - want).abs() <= tol).all()), step
        h, _ = TM.forward(tp, tcfg, seq)
        unwindowed = TM.unembed(tp, tcfg, h[:, -1])
    assert seq.shape[1] > WINDOW
    assert bool(((unwindowed - want).abs() > tol).any())


# ----------------------------------------------------------- [B] positions
def _slot_caches(prefill, params, cfg, prompts, cat):
    """Each prompt prefilled alone, the caches stacked along the batch."""
    outs = [prefill(params, cfg, p) for p in prompts]
    cache = {k: {n: cat([o[1][k][n] for o in outs], 1) for n in outs[0][1][k]}
             for k in outs[0][1] if k != "pos"}
    return cat([o[0] for o in outs], 0), cache


def test_ring_decode_at_per_sequence_positions(model):
    arch, jcfg, tcfg, jp, tp = model
    prompts = [_tokens(tcfg.vocab_size, (1, n), seed=10 + n)
               for n in VEC_LENS]
    jl, jc = _slot_caches(
        lambda p, c, x: j_prefill(p, c, jnp.asarray(x), max_seq=S), jp, jcfg,
        prompts, lambda xs, a: jnp.concatenate(xs, a))
    tl, tc = _slot_caches(
        lambda p, c, x: TM.prefill(p, c, torch.from_numpy(x).long(), S), tp,
        tcfg, prompts, lambda xs, a: torch.cat(xs, a))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    jc["pos"] = jnp.asarray(VEC_LENS, jnp.int32)
    tc["pos"] = torch.tensor(VEC_LENS)
    _decode_both(jcfg, tcfg, jp, tp, jl, jc, tl, tc, VEC_STEPS,
                 positions=list(VEC_LENS))


# -------------------------------------------------------------------- int8
@pytest.mark.parametrize("arch", ARCHS)
def test_ring_decode_with_int8_kv(arch):
    """int8 KV under ring: both packages decode from the reference's
    prefill cache, carried across (a value within an f32 ulp of a rounding
    tie may take either code, ``tests/test_torch_kv_int8.py``); the scale
    rows are written at the wrapped row with the codes."""
    jcfg, tcfg = _cfgs(arch, kv_dtype="int8")
    tree = _tree(tcfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    toks = _tokens(tcfg.vocab_size, (2, PROMPT), seed=3)
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=S)
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    tl = torch.from_numpy(np.array(jl))
    assert tc[_attn_keys(tcfg)[0]]["k"].dtype == torch.int8
    keys = _attn_keys(tcfg)
    before = {k: tc[k]["k_scale"].clone() for k in keys}
    _, _, tc = _decode_both(jcfg, tcfg, jp, tp, jl, jc, tl, tc, STEPS,
                            positions=[PROMPT, PROMPT])
    for k in keys:
        rows = _changed_rows(before[k], tc[k]["k_scale"])
        # The prefill's rows PROMPT.. held the floor scale of its zero
        # padding; the steps wrote them, then rows 0-3.
        assert rows == [list(range(4)) + list(range(PROMPT, S))] * 2


# ------------------------------------------------------ ring + qserve
@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
def test_ring_with_quantized_serve(quant_execution):
    """The reference's ``ringkv_qserve`` variant: Scout's flat AMAT experts
    behind a ring cache, across the wrap."""
    jcfg, tcfg = _cfgs("llama4-scout-17b-a16e", quantized_serve=True)
    base = dataclasses.replace(tcfg, quantized_serve=False)
    tree = _tree(base)
    qtree = jax.tree.map(np.asarray, j_qserve(
        jax.tree.map(jnp.asarray, tree), jcfg, JMat(8, 4)))
    jp, tp = jax.tree.map(jnp.asarray, qtree), params_from_numpy(qtree,
                                                                 "cpu")
    assert "wi_codes" in tp["blocks"]["pos0"]["moe"]["experts"]
    toks = _tokens(tcfg.vocab_size, (2, PROMPT), seed=4)
    mat = TMat(8, 4)
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=S,
                          mat=JMat(8, 4), quant_execution=quant_execution)
    tl, tc, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(), S,
                           mat=mat, quant_execution=quant_execution)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _decode_both(jcfg, tcfg, jp, tp, jl, jc, tl, tc, STEPS,
                 positions=[PROMPT, PROMPT], mat=mat,
                 quant_execution=quant_execution)


# ------------------------------------------------------- cache, refusals
@pytest.mark.parametrize("over", [
    dict(), dict(kv_dtype="int8"), dict(quantized_serve=True),
    dict(kv_dtype="int8", quantized_serve=True)],
    ids=["bf16", "int8", "qserve", "int8_qserve"])
@pytest.mark.parametrize("arch", ARCHS + ["jamba-v0.1-52b", "whisper-small"])
def test_ring_cache_and_shapes_match_reference(arch, over):
    jcfg = dataclasses.replace(get_config(arch).reduced(), ring_kv=True,
                               **over)
    tcfg = dataclasses.replace(TC.get_config(arch).reduced(), ring_kv=True,
                               **over)
    assert TM.param_shapes(tcfg) == JM.param_shapes(jcfg)
    jc = jax.tree.map(np.asarray, JM.init_cache(jcfg, 2, S))
    tc = TM.init_cache(tcfg, 2, S, device="cpu")
    assert set(tc) == set(jc)
    for k in tc:
        if k == "pos":
            continue
        assert set(tc[k]) == set(jc[k])
        for n, t in tc[k].items():
            assert tuple(t.shape) == jc[k][n].shape, (k, n)
            assert str(t.dtype).removeprefix("torch.") == \
                jc[k][n].dtype.name, (k, n)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "no_ring"])
def test_prompt_longer_than_the_cache_raises(ring):
    jcfg, tcfg = _cfgs("smollm-360m", ring_kv=ring)
    tree = _tree(tcfg)
    toks = _tokens(tcfg.vocab_size, (1, S + 6), seed=5)
    with pytest.raises(ValueError):
        JM.prefill(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks),
                   max_seq=S)
    with pytest.raises(ValueError, match="max_seq"):
        TM.prefill(params_from_numpy(tree, "cpu"), tcfg,
                   torch.from_numpy(toks).long(), S)
