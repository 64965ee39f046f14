"""Port parity: configs, the parameter tree, prefill and decode_step.

f32 logits agree with the JAX package's at 1e-4, routing ids exactly.
Batched decode with per-sequence ``[B]`` positions is held against the
JAX package's own batched decode (its batched-vs-separate comparison is
not bit-identical, so it is no oracle here).
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM

# The port's CPU ops are small here; one intra-op thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

MAX_SEQ = 32

# The JAX side under jit, as its engine runs it: one compile per shape
# instead of one per primitive per shape in eager mode.
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_seq",
                                                 "collect_trace"))
j_decode_step = jax.jit(JM.decode_step, static_argnames=("cfg",
                                                         "collect_trace"))


@pytest.mark.parametrize("arch", ["qwen15-moe-repro", "deepseek-v2-lite-repro"])
def test_repro_configs_equal_reference(arch):
    j, t = get_config(arch), TC.get_config(arch)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert set(jd) == set(td)
    assert jd == td
    assert t.n_periods == j.n_periods and t.block_pattern == tuple(
        TC.BlockSpec(b.mixer, b.ffn) for b in j.block_pattern)
    assert TM.param_shapes(t) == JM.param_shapes(j)
    assert t.param_count() == j.param_count()


def test_full_width_config():
    """qwen15-moe-a2.7b: the published widths, same family as the repro
    config, ~14.3 B parameters (counted from shapes, nothing allocated)."""
    cfg = TC.get_config("qwen15-moe-a2.7b")
    repro = TC.get_config("qwen15-moe-repro")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (24, 2048, 16, 16, 128, 151936)
    assert (cfg.rope_theta, cfg.norm_eps, cfg.qkv_bias) == (1e6, 1e-6, True)
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_ff, m.n_shared_experts, m.d_ff_shared,
            m.capacity_factor) == (60, 4, 1408, 4, 5632, 2.0)
    assert (cfg.arch_type, cfg.mlp_type, m.mlp_type) == \
        (repro.arch_type, repro.mlp_type, repro.moe.mlp_type)
    assert "Qwen/Qwen1.5-MoE-A2.7B" in cfg.source
    assert 14.2e9 < cfg.param_count() < 14.4e9


def _shared_params(tcfg, seed):
    """One set of weights for both packages: drawn by the port's init on the
    CPU (``jax.random`` compiles every shape on its first call, seconds per
    module), handed to JAX as arrays and to the port through the bridge."""
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=seed, device="cpu"))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(TC.get_config("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    return (cfg, tcfg, *_shared_params(tcfg, seed=0))


def _prompt(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def test_init_params_tree_dtype_and_count(model):
    cfg, tcfg, _, _ = model
    ours = TM.init_params(tcfg, seed=0, device="cpu")
    # The JAX package's own init, traced for its tree and shapes only.
    theirs = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), theirs)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(ours) == jshapes
    assert TM.count_params(ours) == JM.count_params(theirs)
    assert all(t.dtype == torch.float32 for t in TM.tree_leaves(ours))
    again = TM.init_params(tcfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(TM.tree_leaves(ours), TM.tree_leaves(again)))
    wi = ours["blocks"]["pos0"]["moe"]["experts"]["wi"]
    assert abs(float(wi.std()) - tcfg.d_model ** -0.5) < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_jax_arrays_bit_exactly(dtype):
    """A tree of the JAX package's arrays (bf16 included, which numpy holds
    as ``ml_dtypes.bfloat16``) lands on the port's tensors bit for bit."""
    rng = np.random.default_rng(0)
    tree = {"w": jnp.asarray(rng.standard_normal((3, 5)), dtype=dtype),
            "blocks": {"ids": jnp.arange(4, dtype=jnp.int32)}}
    out = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    assert out["w"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(tree["w"], np.float32))
    assert out["blocks"]["ids"].dtype == torch.int32
    assert out["blocks"]["ids"].tolist() == [0, 1, 2, 3]


def test_entry_points_default_to_cuda(model):
    """Without a card, asking for the default device raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, _ = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(tcfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(tcfg, 1, 8)


def test_prefill_logits_cache_and_trace(model):
    cfg, tcfg, params, tparams = model
    toks = _prompt(13, 1, cfg.vocab_size)
    jl, jc, ja = j_prefill(params, cfg, jnp.asarray(toks), max_seq=MAX_SEQ,
                           collect_trace=True)
    tl, tc, ta = TM.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                            MAX_SEQ, collect_trace=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tc["pos0"]["k"].numpy(),
                               np.asarray(jc["pos0"]["k"]), atol=1e-5)
    np.testing.assert_allclose(tc["pos0"]["v"].numpy(),
                               np.asarray(jc["pos0"]["v"]), atol=1e-5)
    assert int(tc["pos"]) == int(jc["pos"])
    np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                  np.asarray(ja["moe"]["ids"]))
    assert ta["moe"]["ids"].shape == (2, 1, 13, 4)


def test_decode_steps_scalar_position(model):
    cfg, tcfg, params, tparams = model
    toks = _prompt(9, 2, cfg.vocab_size)
    jl, jc, _ = j_prefill(params, cfg, jnp.asarray(toks), max_seq=MAX_SEQ)
    tl, tc, _ = TM.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                           MAX_SEQ)
    for _ in range(3):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc, ja = j_decode_step(params, cfg, token=jt, cache=jc,
                                   collect_trace=True)
        tl, tc, ta = TM.decode_step(tparams, tcfg, tt, tc,
                                    collect_trace=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                      np.asarray(ja["moe"]["ids"]))
        assert int(tc["pos"]) == int(jc["pos"])


def test_batched_decode_vector_positions_and_token_mask(model):
    """Three slots prefilled at different lengths, one of them padding:
    the port's batched decode against the JAX package's batched decode."""
    cfg, tcfg, params, tparams = model
    jb = JM.init_cache(cfg, 3, MAX_SEQ)
    jb["pos"] = jnp.zeros((3,), jnp.int32)
    tb = TM.init_cache(tcfg, 3, MAX_SEQ, device="cpu")
    tb["pos"] = torch.zeros((3,), dtype=torch.int64)
    first = np.zeros(3, np.int32)
    for slot, (n, seed) in enumerate(((10, 3), (17, 4))):
        toks = _prompt(n, seed, cfg.vocab_size)
        jl, jc, _ = j_prefill(params, cfg, jnp.asarray(toks),
                              max_seq=MAX_SEQ)
        _, tc, _ = TM.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                              MAX_SEQ)
        jb = JPE.install_slot(jb, jc, slot)
        tb = TPE.install_slot(tb, tc, slot)
        first[slot] = int(jnp.argmax(jl, -1)[0])
    mask = np.array([True, True, False])
    jt, tt = jnp.asarray(first), torch.from_numpy(first).long()
    for _ in range(2):
        jl, jb, ja = j_decode_step(params, cfg, token=jt, cache=jb,
                                   collect_trace=True,
                                   token_mask=jnp.asarray(mask))
        tl, tb, ta = TM.decode_step(tparams, tcfg, tt, tb,
                                    collect_trace=True,
                                    token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=1e-4)
        np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                      np.asarray(ja["moe"]["ids"]))
        np.testing.assert_array_equal(tb["pos"].numpy(), np.asarray(jb["pos"]))
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy()[mask], np.asarray(jt)[mask])


def test_unported_model_features_raise(model):
    _, tcfg, _, _ = model
    with pytest.raises(NotImplementedError, match="architecture"):
        TM.param_shapes(dataclasses.replace(tcfg, arch_type="dense",
                                            moe=None))
