"""Port parity: ``quantized_serve``, the flat-dict AMAT expert form.

* ``quantized_expert_shapes`` and ``param_shapes`` with ``quantized_serve``
  equal the reference's for every config, at full width and reduced.
* ``quantize_params_for_serve`` on one numpy tree of floats (f32 and
  bf16): codes, zero-points and scales exactly the reference's; every
  other leaf the same tensor.  ``init_params`` with ``quantized_serve``
  equals ``quantize_params_for_serve(init_params(base))`` leaf for leaf.
* Reduced llama4-scout in f32 with ``capacity_factor=8``
  (``tests/test_perf_variants.py:25-37``): prefill and two decode steps
  on the flat form, dense-dequant and ``quant_execution=True`` (the
  reference's Pallas kernel in interpret mode), against the reference on
  the same codes: logits at 1e-4, tokens and routing ids exact, and each
  within relative L2 0.05 of the float model
  (``tests/test_perf_variants.py:59-67``).  The flat form gives what the
  engine's ``wi_q`` form gives on the same codes, and ``forward`` on it
  (with and without ``ring_kv``) the reference's hidden states.
* A per-expert ``use_lsb`` override on the flat form, both routes.
* ``seq_parallel`` and ``onehot_embed`` change nothing on one host, in
  either package (``tests/test_perf_variants.py:41-47``, ``:86-93``).
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
from repro.models import moe as JMOE
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.slices import quantize_moe_params
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

torch.set_num_threads(1)

MAX_SEQ = 32
SCOUT = "llama4-scout-17b-a16e"
ALL_IDS = TC.ARCH_IDS + TC.REPRO_IDS

j_prefill = jax.jit(JM.prefill, static_argnames=(
    "cfg", "max_seq", "collect_trace", "mat", "quant_execution"))
j_decode = jax.jit(JM.decode_step, static_argnames=(
    "cfg", "collect_trace", "mat", "quant_execution"))
j_forward = jax.jit(JM.forward, static_argnames=(
    "cfg", "collect_trace", "mat", "quant_execution"))


def _scout_cfgs(**over):
    """``tests/test_perf_variants.py``'s setup: reduced Scout in f32 with
    ``capacity_factor=8``, in both packages."""
    out = []
    for get in (get_config, TC.get_config):
        cfg = get(SCOUT).reduced()
        out.append(dataclasses.replace(
            cfg, dtype="float32",
            moe=dataclasses.replace(cfg.moe, capacity_factor=8.0), **over))
    return tuple(out)


def _np(t):
    """A tensor as numpy, bf16 as ``ml_dtypes``' bfloat16 (bit for bit)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _np_tree(tree):
    return jax.tree.map(_np, tree)


def _float_tree(tcfg, seed=0):
    return _np_tree(TM.init_params(tcfg, seed=seed, device="cpu"))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _flat_experts(tree):
    for pos, blk in sorted(tree["blocks"].items()):
        if "moe" in blk:
            yield pos, blk["moe"]["experts"]


# ------------------------------------------------------------------- shapes
@pytest.mark.parametrize("arch", ALL_IDS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_shapes_match_reference(arch, reduced):
    jcfg, tcfg = get_config(arch), TC.get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jcfg = dataclasses.replace(jcfg, quantized_serve=True)
    tcfg = dataclasses.replace(tcfg, quantized_serve=True)
    assert TM.param_shapes(tcfg) == JM.param_shapes(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    if tcfg.moe is not None:
        for g in (32, 64):
            assert TMOE.quantized_expert_shapes(tcfg.d_model, tcfg.moe, g) \
                == JMOE.quantized_expert_shapes(jcfg.d_model, jcfg.moe, g)


# ------------------------------------------------------------- quantization
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [SCOUT, "qwen15-moe-repro",
                                  "jamba-v0.1-52b"])
def test_quantize_params_for_serve_matches_reference(arch, dtype):
    tcfg = dataclasses.replace(TC.get_config(arch).reduced(), dtype=dtype,
                               quantized_serve=True)
    jcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                               quantized_serve=True)
    tree = _float_tree(dataclasses.replace(tcfg, quantized_serve=False))
    tp = params_from_numpy(tree, "cpu")
    tq = TMOE.quantize_params_for_serve(tp, tcfg, TMat(8, 4))
    jq = JMOE.quantize_params_for_serve(jax.tree.map(jnp.asarray, tree),
                                        jcfg, JMat(8, 4))
    assert jax.tree.structure(_np_tree(tq)) == jax.tree.structure(jq)
    n_moe = 0
    for (pos, te), (_, je) in zip(_flat_experts(tq), _flat_experts(jq)):
        n_moe += 1
        assert set(te) == {f"{m}_{p}" for m in ("wi", "wo")
                           for p in ("codes", "scales", "zps")}
        for name, t in te.items():
            want = np.asarray(je[name])
            assert t.dtype == (torch.float32 if name.endswith("scales")
                               else torch.uint8), name
            np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    assert n_moe == sum(s.ffn == "moe" for s in tcfg.block_pattern)
    # Every other leaf is the float tree's own tensor.
    for pos, blk in tp["blocks"].items():
        for k, v in blk.items():
            if k != "moe":
                assert tq["blocks"][pos][k] is v
            else:
                assert tq["blocks"][pos]["moe"]["w_router"] is v["w_router"]
    assert tq["embed"] is tp["embed"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [SCOUT, "qwen15-moe-repro",
                                  "jamba-v0.1-52b"])
def test_quantized_init_is_the_quantized_float_init(arch, dtype):
    cfg = dataclasses.replace(TC.get_config(arch).reduced(), dtype=dtype,
                              quantized_serve=True)
    got = TM.init_params(cfg, seed=3, device="cpu")
    want = TMOE.quantize_params_for_serve(
        TM.init_params(dataclasses.replace(cfg, quantized_serve=False),
                       seed=3, device="cpu"), cfg, TMat(8, 4))
    gl, wl = (jax.tree_util.tree_leaves_with_path(_np_tree(t))
              for t in (got, want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g, w,
                                      err_msg=jax.tree_util.keystr(path))
    shapes = TM.param_shapes(cfg)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes


def test_quantized_init_matches_reference_dtypes():
    """``tests/test_perf_variants.py::test_quantized_serve_init_params`` on
    the port: uint8 codes and zero-points, f32 scales."""
    cfg = dataclasses.replace(TC.get_config(SCOUT).reduced(),
                              quantized_serve=True)
    e = TM.init_params(cfg, seed=0, device="cpu")["blocks"]["pos0"]["moe"][
        "experts"]
    assert e["wi_codes"].dtype == torch.uint8
    assert e["wi_zps"].dtype == torch.uint8
    assert e["wi_scales"].dtype == torch.float32


def test_flat_form_needs_a_mat():
    tcfg = _scout_cfgs(quantized_serve=True)[1]
    params = TM.init_params(tcfg, seed=0, device="cpu")
    p = TM._index(params["blocks"], 0)["pos0"]["moe"]
    x = torch.randn(4, tcfg.d_model)
    with pytest.raises(ValueError, match="MatConfig"):
        TMOE.moe_apply(p, x, tcfg.moe)
    y, _ = TMOE.moe_apply(p, x, tcfg.moe, mat=TMat(8, 4))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


# ------------------------------------------------------- serving, in parity
@pytest.fixture(scope="module")
def scout():
    """Reduced Scout: the float tree, its flat AMAT form in both packages,
    a prompt, and the port's float-model logits (prefill and one greedy
    decode step)."""
    jcfg, tcfg = _scout_cfgs()
    jq, tq = _scout_cfgs(quantized_serve=True)
    tree = _float_tree(tcfg)
    tp = params_from_numpy(tree, "cpu")
    qtree = _np_tree(TMOE.quantize_params_for_serve(tp, tq, TMat(8, 4)))
    toks = _tokens(tcfg.vocab_size, (2, 12), seed=1)
    lp, cache, _ = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                              MAX_SEQ)
    t = torch.argmax(lp, -1)
    ld, _, _ = TM.decode_step(tp, tcfg, t, cache)
    return dict(jcfg=jcfg, tcfg=tcfg, jq=jq, tq=tq, tp=tp, tree=tree,
                jqp=jax.tree.map(jnp.asarray, qtree),
                tqp=params_from_numpy(qtree, "cpu"), toks=toks,
                float_logits=(lp, ld))


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _run_both(s, *, quant_execution, steps=2, use_lsb=None):
    """Prefill and ``steps`` decode steps of the flat form in both
    packages, each checked against the other; returns the port's logits
    per call."""
    jmat, tmat = JMat(8, 4), TMat(8, 4)
    jl, jc, ja = j_prefill(s["jqp"], s["jq"], jnp.asarray(s["toks"]),
                           max_seq=MAX_SEQ, collect_trace=True, mat=jmat,
                           quant_execution=quant_execution)
    tl, tc, ta = TM.prefill(s["tqp"], s["tq"],
                            torch.from_numpy(s["toks"]).long(), MAX_SEQ,
                            collect_trace=True, mat=tmat,
                            quant_execution=quant_execution)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                  np.asarray(ja["moe"]["ids"]))
    out = [tl]
    jul = tul = None
    if use_lsb is not None:
        jul = {k: jnp.asarray(v) for k, v in use_lsb.items()}
        tul = {k: torch.from_numpy(v) for k, v in use_lsb.items()}
    for _ in range(steps):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc, ja = j_decode(s["jqp"], s["jq"], jt, jc, collect_trace=True,
                              mat=jmat, quant_execution=quant_execution,
                              use_lsb=jul)
        tl, tc, ta = TM.decode_step(s["tqp"], s["tq"], tt, tc,
                                    collect_trace=True, mat=tmat,
                                    quant_execution=quant_execution,
                                    use_lsb=tul)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                      np.asarray(ja["moe"]["ids"]))
        out.append(tl)
    return out


@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
def test_flat_form_serves_as_the_reference(scout, quant_execution):
    out = _run_both(scout, quant_execution=quant_execution)
    lp, ld = scout["float_logits"]
    # tests/test_perf_variants.py:66-67: quantized serving within 5% of
    # the float model.
    assert _rel(out[0], lp) < 0.05
    assert _rel(out[1], ld) < 0.05


@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
def test_forward_on_the_flat_form(scout, quant_execution):
    """``forward`` (with ``ring_kv`` too, which only the decode cache
    reads) on the flat form against the reference's: hidden states at
    1e-4, routing ids exact."""
    toks = scout["toks"]
    for ring in (False, True):
        jq = dataclasses.replace(scout["jq"], ring_kv=ring)
        tq = dataclasses.replace(scout["tq"], ring_kv=ring)
        jh, ja = j_forward(scout["jqp"], jq, jnp.asarray(toks),
                           collect_trace=True, mat=JMat(8, 4),
                           quant_execution=quant_execution)
        with torch.no_grad():
            th, ta = TM.forward(scout["tqp"], tq,
                                torch.from_numpy(toks).long(),
                                collect_trace=True, mat=TMat(8, 4),
                                quant_execution=quant_execution)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
        np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                      np.asarray(ja["moe"]["ids"]))


def test_quant_execution_agrees_with_dense_dequant(scout):
    dense = _run_both(scout, quant_execution=False, steps=1)
    quant = _run_both(scout, quant_execution=True, steps=1)
    for a, b in zip(dense, quant):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
def test_flat_form_equals_the_engine_form(scout, quant_execution):
    """The flat leaves and the engine's ``wi_q`` / ``wo_q`` tree (with the
    output-major ``wo_codes_t`` under quantized execution) hold the same
    codes; the port computes the same logits from either."""
    tcfg, tq = scout["tcfg"], scout["tq"]
    eng, _, _ = quantize_moe_params(scout["tp"], tcfg, TMat(8, 4),
                                    quant_execution=quant_execution)
    for pos, e in _flat_experts(scout["tqp"]):
        qe = eng["blocks"][pos]["moe"]["experts"]
        for m in ("wi", "wo"):
            qt = qe[f"{m}_q"]
            assert torch.equal(qt.codes, e[f"{m}_codes"])
            assert torch.equal(qt.scales, e[f"{m}_scales"])
            assert torch.equal(qt.zero_points, e[f"{m}_zps"])
    toks = torch.from_numpy(scout["toks"]).long()
    kw = dict(mat=TMat(8, 4), quant_execution=quant_execution)
    a, ca, _ = TM.prefill(scout["tqp"], tq, toks, MAX_SEQ, **kw)
    b, cb, _ = TM.prefill(eng, tcfg, toks, MAX_SEQ, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    t = torch.argmax(a, -1)
    a, _, _ = TM.decode_step(scout["tqp"], tq, t, ca, **kw)
    b, _, _ = TM.decode_step(eng, tcfg, t, cb, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
def test_per_expert_use_lsb_on_the_flat_form(scout, quant_execution):
    """``decode_step``'s per-position ``use_lsb`` [n_periods, E] on the
    flat form: half the experts MSB-only, in both packages."""
    tq = scout["tq"]
    E = tq.moe.n_experts
    mask = (np.arange(tq.n_periods * E).reshape(tq.n_periods, E) % 2 == 0)
    use_lsb = {f"pos{i}": mask for i, s in enumerate(tq.block_pattern)
               if s.ffn == "moe"}
    low = _run_both(scout, quant_execution=quant_execution, steps=1,
                    use_lsb=use_lsb)
    high = _run_both(scout, quant_execution=quant_execution, steps=1)
    np.testing.assert_array_equal(low[0].numpy(), high[0].numpy())
    assert float((low[1] - high[1]).abs().max()) > 1e-4


@pytest.mark.parametrize("flag", ["seq_parallel", "onehot_embed"])
def test_host_only_flags_change_nothing(scout, flag):
    """``seq_parallel`` and ``onehot_embed`` are a mesh's sharding hints
    and an exact one-hot lookup: on one host both packages give the
    unflagged logits (the reference's own tests hold it at 1e-5 and
    1e-4)."""
    jcfg = dataclasses.replace(scout["jcfg"], **{flag: True})
    tcfg = dataclasses.replace(scout["tcfg"], **{flag: True})
    lp, ld = scout["float_logits"]
    toks = scout["toks"]
    tl, tc, _ = TM.prefill(scout["tp"], tcfg, torch.from_numpy(toks).long(),
                           MAX_SEQ)
    np.testing.assert_array_equal(tl.numpy(), lp.numpy())
    t = torch.argmax(tl, -1)
    td, _, _ = TM.decode_step(scout["tp"], tcfg, t, tc)
    np.testing.assert_array_equal(td.numpy(), ld.numpy())
    jp = jax.tree.map(jnp.asarray, scout["tree"])
    jl, jc, _ = j_prefill(jp, jcfg, jnp.asarray(toks), max_seq=MAX_SEQ)
    jd, _, _ = j_decode(jp, jcfg, jnp.asarray(t.numpy(), jnp.int32), jc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
