"""Port parity: routing policies and the MoE layer.

Routing ids, ``critical``, ``msb_needed``, ``lsb_needed``, ``use_lsb`` and
``active`` must equal the JAX package's exactly; layer outputs agree at
1e-4 in f32 (sums in another order).  Both expert paths are covered:
dense dequant and quantized execution (the JAX side runs its Pallas
kernel in interpret mode, the port its plain CPU version).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core import routing as JR
from repro.core.amat import MAT84
from repro.core.slices import quantize_moe_params as j_quantize_moe
from repro.models import moe as JMOE
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core import routing as TR
from repro_torch.core.amat import MatConfig
from repro_torch.core.slices import quantize_moe_params as t_quantize_moe
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

# The port's CPU ops are small here; one intra-op thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

T_MAT = MatConfig(8, 4)

# The JAX layer under jit, as its engine runs it: one compile per shape
# instead of one per primitive per shape in eager mode.
j_moe_apply = jax.jit(JMOE.moe_apply, static_argnames=(
    "cfg", "mat", "policy", "quant_execution", "force_high_bit"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# Routing, ties included
# --------------------------------------------------------------------------
def _tied_probs(T=6, E=12, seed=0):
    """Softmax-like rows with deliberate exact ties across the top-k
    boundary and inside it."""
    rng = np.random.default_rng(seed)
    p = rng.random((T, E)).astype(np.float32)
    p[:, 3] = p[:, 7] = p[:, 9] = 0.9           # a three-way tie at the top
    p[1, :] = 0.5                               # an all-equal row
    p[2, 10] = p[2, 2]                          # a tie further down
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_topk_routing_ties_resolve_like_jax(k):
    p = _tied_probs()
    jg, ji = JR.topk_routing(jnp.asarray(p), k)
    tg, ti = TR.topk_routing(torch.from_numpy(p), k)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(tg), _np(jg), atol=1e-6)


def test_cumsum_routing_matches():
    p = _tied_probs(seed=1)
    jg, ji, ja = JR.cumsum_routing(jnp.asarray(p), 0.6, 5)
    tg, ti, ta = TR.cumsum_routing(torch.from_numpy(p), 0.6, 5)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(ta), _np(ja))
    np.testing.assert_allclose(_np(tg), _np(jg), atol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.7, 5.0])
def test_cache_prior_routing_matches(alpha):
    p = _tied_probs(seed=2)
    cached = np.zeros(p.shape[1], bool)
    cached[[0, 7, 11]] = True
    jg, ji = JR.cache_prior_routing(jnp.asarray(p), jnp.asarray(cached),
                                    jnp.float32(alpha), 3)
    tg, ti = TR.cache_prior_routing(torch.from_numpy(p),
                                    torch.from_numpy(cached), alpha, 3)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(tg), _np(jg), atol=1e-6)


def test_criticality_and_expert_demand_match():
    p = _tied_probs(seed=3)
    jg, ji = JR.topk_routing(jnp.asarray(p), 3)
    tg, ti = TR.topk_routing(torch.from_numpy(p), 3)
    jc, tc = JR.criticality(jg, 0.3), TR.criticality(tg, 0.3)
    np.testing.assert_array_equal(_np(tc), _np(jc))
    for a, b in zip(TR.expert_demand(ti, tc, 12), JR.expert_demand(ji, jc, 12)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_miss_rate_controller_trajectory_matches():
    jc, tc = JR.MissRateController(0.05), TR.MissRateController(0.05)
    rates = np.random.default_rng(4).random(40) * 0.3
    assert [tc.update(float(r)) for r in rates] == \
        [jc.update(float(r)) for r in rates]
    assert tc.active == jc.active


# --------------------------------------------------------------------------
# The MoE layer
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def layer():
    """One qwen15-moe-repro MoE layer (60 experts, top-4, shared experts)
    in f32, float and AMAT-quantized, in both packages."""
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=1,
                              dtype="float32")
    # Drawn by the port's init on the CPU (jax.random compiles every shape
    # on its first call), handed to JAX as arrays and to the port through
    # the bridge.
    tcfg = dataclasses.replace(TC.get_config("qwen15-moe-repro"), n_layers=1,
                               dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=5, device="cpu"))
    params = jax.tree.map(jnp.asarray, tree)
    jq, _, _ = j_quantize_moe(params, cfg, MAT84, quant_execution=True)
    tparams = params_from_numpy(tree, "cpu")
    tq, _, _ = t_quantize_moe(tparams, cfg, T_MAT, quant_execution=True)

    def moe_block(tree, pkg_index):
        blk = tree["blocks"]["pos0"]["moe"]
        return jax.tree.map(lambda a: a[0], blk) if pkg_index == "jax" \
            else _index0(blk)

    return dict(cfg=cfg,
                j_float=moe_block(params, "jax"),
                t_float=moe_block(tparams, "torch"),
                j_quant=moe_block(jq, "jax"),
                t_quant=moe_block(tq, "torch"))


def _index0(tree):
    from repro_torch.models.model import _index
    return _index(tree, 0)


def _tokens(T, d, seed):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)


AUX_EXACT = ("ids", "critical", "msb_needed", "lsb_needed", "use_lsb",
             "active")


def _compare(jy, jaux, ty, taux):
    for k in AUX_EXACT:
        if k in jaux:
            np.testing.assert_array_equal(_np(taux[k]), _np(jaux[k]), err_msg=k)
    np.testing.assert_allclose(_np(taux["gates"]), _np(jaux["gates"]),
                               atol=1e-6)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4)


def test_float_experts_policy_free(layer):
    cfg = layer["cfg"]
    x = _tokens(24, cfg.d_model, 0)
    jy, jaux = j_moe_apply(layer["j_float"], jnp.asarray(x), cfg.moe)
    ty, taux = TMOE.moe_apply(layer["t_float"], torch.from_numpy(x), cfg.moe)
    _compare(jy, jaux, ty, taux)


@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
@pytest.mark.parametrize("slice_mode", ["dbsc", "highbit", "lowbit"])
def test_quantized_experts_cache_prior_with_token_mask(layer, slice_mode,
                                                       quant_execution):
    cfg = layer["cfg"]
    E = cfg.moe.n_experts
    T = 8
    x = _tokens(T, cfg.d_model, 1)
    rng = np.random.default_rng(2)
    cached_msb = rng.random(E) < 0.4
    cached_lsb = cached_msb & (rng.random(E) < 0.5)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 1], bool)   # padding slots 2, 4
    pol = dict(kind="cache_prior", slice_mode=slice_mode, theta=0.3,
               quant_execution=quant_execution)
    jy, jaux = j_moe_apply(
        layer["j_quant"], jnp.asarray(x), cfg.moe, mat=MAT84,
        policy=JMOE.RoutingPolicy(**pol),
        policy_state={"cached_msb": jnp.asarray(cached_msb),
                      "cached_lsb": jnp.asarray(cached_lsb),
                      "alpha": jnp.float32(2.5)},
        token_mask=jnp.asarray(mask))
    ty, taux = TMOE.moe_apply(
        layer["t_quant"], torch.from_numpy(x), cfg.moe, mat=T_MAT,
        policy=TMOE.RoutingPolicy(**pol),
        policy_state={"cached_msb": torch.from_numpy(cached_msb),
                      "cached_lsb": torch.from_numpy(cached_lsb),
                      "alpha": float(np.float32(2.5))},
        token_mask=torch.from_numpy(mask))
    _compare(jy, jaux, ty, taux)
    assert (_np(taux["ids"])[~mask] == E).all()      # sentinel ids


@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
def test_prefill_discipline_force_high_bit_cumsum(layer, quant_execution):
    """Prefill routes with a state-free policy (cumsum) but computes every
    routed expert high-bit; ``active`` marks the live cumsum slots."""
    cfg = layer["cfg"]
    x = _tokens(40, cfg.d_model, 3)
    pol = dict(kind="cumsum", slice_mode="dbsc", cumsum_tau=0.3,
               cumsum_kmax=6)
    jy, jaux = j_moe_apply(layer["j_quant"], jnp.asarray(x), cfg.moe,
                           mat=MAT84, policy=JMOE.RoutingPolicy(**pol),
                           quant_execution=quant_execution,
                           force_high_bit=True)
    ty, taux = TMOE.moe_apply(layer["t_quant"], torch.from_numpy(x), cfg.moe,
                              mat=T_MAT, policy=TMOE.RoutingPolicy(**pol),
                              quant_execution=quant_execution,
                              force_high_bit=True)
    _compare(jy, jaux, ty, taux)
    assert _np(taux["use_lsb"]).all()


def test_fetch_lsb_on_miss_off_intersects_residency(layer):
    cfg = layer["cfg"]
    E = cfg.moe.n_experts
    x = _tokens(6, cfg.d_model, 4)
    cached_lsb = np.arange(E) % 2 == 0
    pol = dict(kind="topk", slice_mode="dbsc", theta=0.2,
               fetch_lsb_on_miss=False)
    jy, jaux = j_moe_apply(
        layer["j_quant"], jnp.asarray(x), cfg.moe, mat=MAT84,
        policy=JMOE.RoutingPolicy(**pol),
        policy_state={"cached_msb": jnp.ones(E, bool),
                      "cached_lsb": jnp.asarray(cached_lsb),
                      "alpha": jnp.float32(0.0)})
    ty, taux = TMOE.moe_apply(
        layer["t_quant"], torch.from_numpy(x), cfg.moe, mat=T_MAT,
        policy=TMOE.RoutingPolicy(**pol),
        policy_state={"cached_msb": torch.ones(E, dtype=torch.bool),
                      "cached_lsb": torch.from_numpy(cached_lsb),
                      "alpha": 0.0})
    _compare(jy, jaux, ty, taux)


def _sentinel_case(E, rng):
    """A masked token (sentinel id E, zero gate) and overfull experts."""
    ids = np.array([[0, 1], [0, 2], [0, 1], [E, E], [2, 1]], np.int32)
    gates = rng.random((5, 2)).astype(np.float32)
    gates[3] = 0.0
    return ids, gates


def _overflow_case(E, rng):
    """30 tokens whose first choice is expert 0: most overflow capacity."""
    T = 30
    ids = np.zeros((T, 2), np.int32)
    ids[:, 1] = np.arange(T) % (E - 1) + 1
    return ids, np.full((T, 2), 0.5, np.float32)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _j_dispatch_combine(x, ids, gates, E, cap):
    pos, keep = JMOE.dispatch_indices(ids, gates, E, cap)
    buf = JMOE.dispatch(x, ids, pos, keep, E, cap)
    return pos, keep, buf, JMOE.combine(buf * 2.0, ids, pos, keep, gates)


@pytest.mark.parametrize("case", [_sentinel_case, _overflow_case],
                         ids=["sentinels", "overflow"])
def test_dispatch_and_combine_match(case):
    """Positions, keep mask, the scattered buffer and the combined output
    agree with JAX: the sentinel id and the overflow slot vanish in
    dispatch and are clamped (then zero-weighted) in combine."""
    E, cap, d = 3, 2, 4
    rng = np.random.default_rng(6)
    ids, gates = case(E, rng)
    x = rng.standard_normal((ids.shape[0], d)).astype(np.float32)
    jpos, jkeep, jbuf, jy = _j_dispatch_combine(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(gates), E, cap)
    tpos, tkeep = TMOE.dispatch_indices(torch.from_numpy(ids).long(),
                                        torch.from_numpy(gates), E, cap)
    np.testing.assert_array_equal(_np(tpos), _np(jpos))
    np.testing.assert_array_equal(_np(tkeep), _np(jkeep))
    tbuf = TMOE.dispatch(torch.from_numpy(x), torch.from_numpy(ids).long(),
                         tpos, tkeep, E, cap)
    np.testing.assert_array_equal(_np(tbuf), _np(jbuf))
    ty = TMOE.combine(tbuf * 2.0, torch.from_numpy(ids).long(), tpos, tkeep,
                      torch.from_numpy(gates))
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6)


@pytest.mark.parametrize("n_tokens", [1, 4, 8, 128, 1000])
def test_capacity_rule_matches(n_tokens):
    for k, E, f in ((4, 60, 2.0), (6, 64, 2.0), (2, 8, 1.25)):
        assert TMOE.capacity(n_tokens, k, E, f) == \
            JMOE.capacity(n_tokens, k, E, f)
