"""Port parity: the MoE path's reference keywords, ``moe_apply``'s
``use_lsb`` / ``gate_override`` / ``deterministic`` / ``rng``,
``decode_step``'s per-position ``use_lsb`` and ``gate_override`` dicts,
and ``forward``'s ``collect_trace`` / ``mat`` / ``quant_execution``.

* ``tests/test_moe.py:97-163`` on the port: AMAT experts under forced
  gates track the float layer, the kernel path (its plain version here)
  equals the dense-dequant path for every ``use_lsb`` shape, the
  output-major ``wo`` codes equal the canonical layout, and ``use_lsb``
  selects the precision.  Each is also held against the reference's
  ``moe_apply`` on the same numpy weights (1e-5; ids exactly).
* ``decode_step`` with a gate override and a ``use_lsb`` mask per MoE
  position, and ``forward`` on AMAT parameters through the kernel path,
  against the reference (f32 logits 1e-4, routing ids exactly).
* Router noise, which no ``jax.random`` draw can reproduce: held by its
  bounds.  Every chosen expert's probability times ``1 + noise`` is at
  least every unchosen one's times ``1 - noise``; a fixed generator seed
  repeats its routing; noise 0, ``deterministic=True`` or no ``rng``
  leave the layer unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core.amat import MAT84 as J_MAT84
from repro.core.amat import amat_quantize as j_amat_quantize
from repro.core.slices import quantize_moe_params as j_quantize_moe
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core.amat import MAT84, amat_quantize
from repro_torch.core.slices import quantize_moe_params as t_quantize_moe
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

torch.set_num_threads(1)

E, D = 8, 32
CFG = dict(n_experts=E, top_k=2, d_ff=32, capacity_factor=4.0)


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def layer():
    """One MoE layer (8 experts top-2, d 32, ``tests/test_moe.py``'s CFG)
    in f32, float and AMAT-quantized, in both packages, and 32 tokens."""
    shapes = TMOE.moe_param_shapes(D, TMOE.MoECfg(**CFG))
    tree = {"w_router": _np(shapes["w_router"], 1, 0.1),
            "experts": {k: _np(s, 2 + i, 0.1) for i, (k, s) in
                        enumerate(sorted(shapes["experts"].items()))}}
    jf = jax.tree.map(jnp.asarray, tree)
    tf = params_from_numpy(tree, "cpu")
    jq = dict(jf, experts={f"{k}_q": j_amat_quantize(jf["experts"][k],
                                                     J_MAT84)
                           for k in ("wi", "wo")})
    tq = dict(tf, experts={f"{k}_q": amat_quantize(tf["experts"][k], MAT84)
                           for k in ("wi", "wo")})
    x = _np((32, D), 9, 0.5)
    return {"jf": jf, "tf": tf, "jq": jq, "tq": tq, "x": x,
            "jcfg": JMOE.MoECfg(**CFG), "tcfg": TMOE.MoECfg(**CFG)}


def _float_routing(layer):
    """The float layer's routing, as the reference tests force it."""
    _, aux = TMOE.moe_apply(layer["tf"], torch.from_numpy(layer["x"]),
                            layer["tcfg"])
    return aux["gates"], aux["ids"]


def _both_apply(layer, params, go, **kw):
    """``moe_apply`` on both packages under the gate override ``go``
    (torch tensors); returns (port y, reference y as numpy)."""
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
               else v) for k, v in kw.items()}
    if "mat" in kw:
        jkw["mat"] = J_MAT84
    jy, jaux = JMOE.moe_apply(
        layer["j" + params], jnp.asarray(layer["x"]), layer["jcfg"],
        gate_override=(jnp.asarray(go[0].numpy()), jnp.asarray(go[1].numpy())),
        **jkw)
    ty, taux = TMOE.moe_apply(layer["t" + params],
                              torch.from_numpy(layer["x"]), layer["tcfg"],
                              gate_override=go, **kw)
    np.testing.assert_array_equal(taux["ids"].numpy(), np.asarray(jaux["ids"]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    return ty, np.asarray(jy)


def test_gate_override_routes_the_float_layer(layer):
    go = _float_routing(layer)
    y, aux = TMOE.moe_apply(layer["tf"], torch.from_numpy(layer["x"]),
                            layer["tcfg"])
    got, _ = _both_apply(layer, "f", go)
    assert torch.equal(got, y)


def test_quantized_matches_float_closely(layer):
    """``tests/test_moe.py:97``."""
    go = _float_routing(layer)
    y_float, _ = _both_apply(layer, "f", go)
    y_q, _ = _both_apply(layer, "q", go, mat=MAT84)
    rel = float(torch.linalg.norm(y_q - y_float)
                / (torch.linalg.norm(y_float) + 1e-9))
    assert rel < 0.05, f"8-bit expert path diverges: rel={rel}"


@pytest.mark.parametrize("ul", ["none", "ones", "zeros", "every_third"])
def test_quant_execution_matches_dense_dequant(layer, ul):
    """``tests/test_moe.py:113``: the kernel path (its plain version on
    the CPU) equals the dense-dequant path for every ``use_lsb`` shape."""
    mask = {"none": None, "ones": torch.ones(E, dtype=torch.bool),
            "zeros": torch.zeros(E, dtype=torch.bool),
            "every_third": torch.arange(E) % 3 == 0}[ul]
    go = _float_routing(layer)
    kw = {} if mask is None else {"use_lsb": mask}
    dense, _ = _both_apply(layer, "q", go, mat=MAT84, quant_execution=False,
                           **kw)
    kern, _ = _both_apply(layer, "q", go, mat=MAT84, quant_execution=True,
                          **kw)
    np.testing.assert_allclose(kern.numpy(), dense.numpy(), atol=1e-4)


def test_quant_execution_uses_transposed_wo_codes(layer):
    """``tests/test_moe.py:137``."""
    go = _float_routing(layer)
    x = torch.from_numpy(layer["x"])
    y_canon, _ = TMOE.moe_apply(layer["tq"], x, layer["tcfg"], mat=MAT84,
                                gate_override=go, quant_execution=True)
    qt = dict(layer["tq"], experts=dict(
        layer["tq"]["experts"],
        wo_codes_t=layer["tq"]["experts"]["wo_q"].codes.transpose(
            -1, -2).contiguous()))
    y_t, _ = TMOE.moe_apply(qt, x, layer["tcfg"], mat=MAT84,
                            gate_override=go, quant_execution=True)
    np.testing.assert_allclose(y_t.numpy(), y_canon.numpy(), atol=1e-4)


def test_use_lsb_selects_precision(layer):
    """``tests/test_moe.py:160``."""
    go = _float_routing(layer)
    y_hi, _ = _both_apply(layer, "q", go, mat=MAT84,
                          use_lsb=torch.ones(E, dtype=torch.bool))
    y_lo, _ = _both_apply(layer, "q", go, mat=MAT84,
                          use_lsb=torch.zeros(E, dtype=torch.bool))
    assert float(torch.linalg.norm(y_hi - y_lo)) > 1e-4


def test_gate_override_and_policy_are_exclusive(layer):
    with pytest.raises(ValueError, match="exclusive"):
        TMOE.moe_apply(layer["tf"], torch.from_numpy(layer["x"]),
                       layer["tcfg"], gate_override=_float_routing(layer),
                       policy=TMOE.RoutingPolicy())


# ------------------------------------------------------------ router noise
@pytest.mark.parametrize("noise", [0.05, 0.3])
def test_router_noise_stays_in_its_bounds(layer, noise):
    cfg = dataclasses.replace(layer["tcfg"], router_noise=noise)
    x = torch.from_numpy(layer["x"])
    probs = TMOE.router_probs(x, layer["tf"]["w_router"])
    changed = False
    base_ids = torch.sort(TMOE.moe_apply(layer["tf"], x, cfg)[1]["ids"],
                          -1).values
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        _, aux = TMOE.moe_apply(layer["tf"], x, cfg, deterministic=False,
                                rng=gen)
        chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(
            1, aux["ids"], True)
        lo = torch.where(chosen, probs, torch.inf).amin(-1)
        hi = torch.where(chosen, -torch.inf, probs).amax(-1)
        assert bool((lo * (1 + noise) >= hi * (1 - noise)).all()), seed
        np.testing.assert_allclose(aux["gates"].sum(-1).numpy(), 1.0,
                                   rtol=1e-6)
        again = TMOE.moe_apply(layer["tf"], x, cfg, deterministic=False,
                               rng=torch.Generator().manual_seed(seed))[1]
        assert torch.equal(again["ids"], aux["ids"])
        changed |= not torch.equal(torch.sort(aux["ids"], -1).values,
                                   base_ids)
    if noise >= 0.3:
        assert changed               # large jitter moves some routing


def test_router_noise_is_off_unless_asked(layer):
    x = torch.from_numpy(layer["x"])
    noisy = dataclasses.replace(layer["tcfg"], router_noise=0.5)
    want, _ = TMOE.moe_apply(layer["tf"], x, layer["tcfg"])
    for cfg, kw in ((noisy, {}),
                    (noisy, {"deterministic": False}),
                    (noisy, {"rng": torch.Generator().manual_seed(0)}),
                    (layer["tcfg"], {"deterministic": False,
                                     "rng": torch.Generator().manual_seed(0)})):
        got, _ = TMOE.moe_apply(layer["tf"], x, cfg, **kw)
        assert torch.equal(got, want)


# -------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def model():
    """qwen15-moe-repro at 2 layers in f32, float and AMAT-quantized, in
    both packages from one numpy tree."""
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(TC.get_config("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    jq, _, _ = j_quantize_moe(jp, cfg, J_MAT84, quant_execution=True)
    tq, _, _ = t_quantize_moe(tp, tcfg, MAT84, quant_execution=True)
    return cfg, tcfg, jq, tq


def _prompt(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (2, n)).astype(
        np.int32)


@pytest.mark.parametrize("quant_execution", [False, True])
def test_forward_on_amat_params_matches_reference(model, quant_execution):
    cfg, tcfg, jq, tq = model
    toks = _prompt(12, 1, cfg.vocab_size)
    jh, jaux = JM.forward(jq, cfg, jnp.asarray(toks), collect_trace=True,
                          mat=J_MAT84, quant_execution=quant_execution)
    with torch.no_grad():
        th, taux = TM.forward(tq, tcfg, torch.from_numpy(toks).long(),
                              collect_trace=True, mat=MAT84,
                              quant_execution=quant_execution)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_array_equal(taux["moe"]["ids"].numpy(),
                                  np.asarray(jaux["moe"]["ids"]))
    np.testing.assert_allclose(taux["moe"]["gates"].numpy(),
                               np.asarray(jaux["moe"]["gates"]), atol=1e-5)
    np.testing.assert_allclose(
        TM.unembed(tq, tcfg, th[:, -1]).numpy(),
        np.asarray(JM.unembed(jq, cfg, jh[:, -1])), atol=1e-4)


@pytest.mark.parametrize("quant_execution", [False, True])
def test_decode_step_per_position_overrides_match_reference(model,
                                                            quant_execution):
    """Forced gates (a fixed expert pair per sequence) and a ``use_lsb``
    mask per period at the one MoE position, over three decode steps."""
    cfg, tcfg, jq, tq = model
    P, m = cfg.n_periods, cfg.moe
    rng = np.random.default_rng(5)
    ids = np.stack([np.stack([rng.permutation(m.n_experts)[:m.top_k]
                              for _ in range(2)])
                    for _ in range(P)]).astype(np.int32)      # [P, B, k]
    gates = rng.random((P, 2, m.top_k)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    use_lsb = rng.random((P, m.n_experts)) < 0.5
    toks = _prompt(9, 2, cfg.vocab_size)
    jl, jc, _ = JM.prefill(jq, cfg, jnp.asarray(toks), 16, mat=J_MAT84)
    tl, tc, _ = TM.prefill(tq, tcfg, torch.from_numpy(toks).long(), 16,
                           mat=MAT84)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    j_over = dict(use_lsb={"pos0": jnp.asarray(use_lsb)},
                  gate_override={"pos0": (jnp.asarray(gates),
                                          jnp.asarray(ids))})
    t_over = dict(use_lsb={"pos0": torch.from_numpy(use_lsb)},
                  gate_override={"pos0": (torch.from_numpy(gates),
                                          torch.from_numpy(ids).long())})
    for _ in range(3):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc, ja = JM.decode_step(jq, cfg, jt, jc, collect_trace=True,
                                    mat=J_MAT84,
                                    quant_execution=quant_execution,
                                    **j_over)
        tl, tc, ta = TM.decode_step(tq, tcfg, tt, tc, collect_trace=True,
                                    mat=MAT84,
                                    quant_execution=quant_execution,
                                    **t_over)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_array_equal(ta["moe"]["ids"][:, 0].numpy(), ids)
        np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                      np.asarray(ja["moe"]["ids"]))
