"""Port parity: the int8 KV cache (``kv_dtype="int8"``).

``_quant_kv`` against the reference's compiled ``_quant_kv`` on the same
inputs: codes and scales exact (f32 and bf16 rows, zero rows at the scale
floor); ``_dequant_kv`` exact.  The 2-layer f32 ``qwen15-moe-repro`` with
int8 KV (one numpy tree of weights for both packages): ``prefill`` logits
at 1e-4 with routing ids exact, scalar-position and batched
``decode_step`` logits at 1e-4 with tokens and ids exact, and the engine
serving through the scheduler with tokens exact.

The decode tests start both packages from one cache, the reference's
quantized prefill cache carried across with the bridge: the two forwards
agree to about an f32 ulp, and a K/V value that close to a rounding tie
can take either code, where one code step (about 1% of the row's
maximum) moves the logits by about 3e-4.  The prefill test holds the two
packages' own caches to within one code instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core.amat import MatConfig as JMat
from repro.core.engine import EngineConfig as JEC
from repro.core.engine import PersistentEngine as JPE
from repro.models import model as JM
from repro.models.moe import RoutingPolicy as JRP
from repro.serving import scheduler as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TC
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.core.engine import EngineConfig as TEC
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP
from repro_torch.serving import scheduler as TS

torch.set_num_threads(1)

MAX_SEQ = 32
j_quant = jax.jit(JM._quant_kv)
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "max_seq",
                                                 "collect_trace"))
j_decode_step = jax.jit(JM.decode_step, static_argnames=("cfg",
                                                         "collect_trace"))


def _rows(seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 40, 4, 16)) * rng.gamma(1.0, size=(3, 40, 4,
                                                                  1))
    x[0, :3] = 0.0                       # zero rows: the scale floor
    x = x.astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    return jx, torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_kv_codes_and_scales_exact(seed, dtype):
    jx, tx = _rows(seed, dtype)
    jc, js = j_quant(jx)
    tc, ts = TM._quant_kv(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 0, 0]) == np.float32(1e-8)
    assert int(tc.abs().max()) == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_kv_exact(dtype):
    jx, tx = _rows(5, dtype)
    jc, js = j_quant(jx)
    tc, ts = TM._quant_kv(tx)
    jd = JM._dequant_kv(jc, js, jnp.dtype(dtype))
    td = TM._dequant_kv(tc, ts, getattr(torch, dtype))
    np.testing.assert_array_equal(td.to(torch.float32).numpy(),
                                  np.asarray(jd.astype(jnp.float32)))


def test_rounding_is_half_to_even():
    """Rows built so that x / scale lands on .5 exactly."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    codes, scale = TM._quant_kv(x)
    jc, js = j_quant(jnp.asarray(x.numpy()))
    assert float(scale[0]) == float(np.asarray(js)[0])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32", kv_dtype="int8")
    tcfg = dataclasses.replace(TC.get_config("qwen15-moe-repro"), n_layers=2,
                               dtype="float32", kv_dtype="int8")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _prompt(n, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def _assert_codes_close(t, j):
    """Codes of K/V computed by two packages: equal but at rounding ties
    moved by the last ulp of the f32 forward, never more than one code."""
    diff = np.abs(t.numpy().astype(np.int32) - np.asarray(j, np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def test_init_cache_layout(model):
    cfg, tcfg, _, _ = model
    jc = JM.init_cache(cfg, 2, MAX_SEQ)
    tc = TM.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    assert set(tc["pos0"]) == set(jc["pos0"]) == {"k", "v", "k_scale",
                                                  "v_scale"}
    for name, leaf in tc["pos0"].items():
        assert tuple(leaf.shape) == tuple(jc["pos0"][name].shape)
        assert str(leaf.dtype).split(".")[-1] == str(jc["pos0"][name].dtype)


def test_prefill_int8_logits_cache_and_ids(model):
    cfg, tcfg, params, tparams = model
    toks = _prompt(13, 1, cfg.vocab_size)
    jl, jc, ja = j_prefill(params, cfg, jnp.asarray(toks), max_seq=MAX_SEQ,
                           collect_trace=True)
    tl, tc, ta = TM.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                            MAX_SEQ, collect_trace=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(ta["moe"]["ids"].numpy(),
                                  np.asarray(ja["moe"]["ids"]))
    for name in ("k", "v"):
        _assert_codes_close(tc["pos0"][name], jc["pos0"][name])
        np.testing.assert_allclose(tc["pos0"][f"{name}_scale"].numpy(),
                                   np.asarray(jc["pos0"][f"{name}_scale"]),
                                   rtol=1e-5)
    # padded rows carry the reference's floor scale and zero codes
    assert float(tc["pos0"]["k_scale"][0, 0, 13:].max()) == np.float32(1e-8)
    assert int(tc["pos0"]["k"][0, 0, 13:].abs().max()) == 0


def _to_port(cache):
    out = params_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
    out["pos"] = out["pos"].long()
    return out


def test_decode_int8_scalar_position(model):
    cfg, tcfg, params, tparams = model
    toks = _prompt(9, 2, cfg.vocab_size)
    jl, jc, _ = j_prefill(params, cfg, jnp.asarray(toks), max_seq=MAX_SEQ)
    tl, _, _ = TM.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                          MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    tc = _to_port(jc)
    for _ in range(4):
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
    _assert_codes_close(tc["pos0"]["v"], jc["pos0"]["v"])


def test_batched_decode_int8_vector_positions(model):
    """Three slots prefilled at different lengths, one of them padding:
    the port's batched int8 decode against the reference's."""
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
        jb = JPE.install_slot(jb, jc, slot)
        tb = TPE.install_slot(tb, _to_port(jc), slot)
        first[slot] = int(jnp.argmax(jl, -1)[0])
    for name, leaf in tb["pos0"].items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(jb["pos0"][name]))
    mask = np.array([True, True, False])
    jt, tt = jnp.asarray(first), torch.from_numpy(first).long()
    for _ in range(3):
        jl, jb, ja = j_decode_step(params, cfg, token=jt, cache=jb,
                                   collect_trace=True,
                                   token_mask=jnp.asarray(mask))
        tl, tb, ta = TM.decode_step(tparams, tcfg, tt, tb,
                                    collect_trace=True,
                                    token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=1e-4)
        np.testing.assert_array_equal(
            ta["moe"]["ids"].numpy()[:, :, mask],
            np.asarray(ja["moe"]["ids"])[:, :, mask])
        np.testing.assert_array_equal(tb["pos"].numpy(), np.asarray(jb["pos"]))
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        np.testing.assert_array_equal(tt.numpy()[mask], np.asarray(jt)[mask])


def test_int8_kv_is_half_the_bf16_cache_bytes(model):
    _, tcfg, _, _ = model
    q = TM.init_cache(tcfg, 2, 64, device="cpu")
    b = TM.init_cache(dataclasses.replace(tcfg, dtype="bfloat16",
                                          kv_dtype="bfloat16"), 2, 64,
                      device="cpu")

    def nbytes(c):
        return sum(t.numel() * t.element_size() for k, e in c.items()
                   if k != "pos" for t in e.values())
    hd = tcfg.head_dim
    assert nbytes(q) / nbytes(b) == pytest.approx((hd + 4) / (2 * hd))


def test_engine_serves_int8_kv_like_reference(model):
    cfg, tcfg, params, tparams = model
    kw = dict(cache_bytes=1.0e6, miss_rate_target=0.1, warmup="pcw",
              max_seq=24)
    pol = dict(kind="cache_prior", slice_mode="dbsc")
    je = JPE(cfg, params, JEC(mat=JMat(8, 4), policy=JRP(**pol), **kw))
    te = TPE(tcfg, tparams, TEC(mat=TMat(8, 4), policy=TRP(**pol), **kw),
             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
               for _ in range(3)]
    out = []
    for mod, eng, kwargs in ((JS, je, {}), (TS, te, {"device": "cpu"})):
        sched = mod.ContinuousBatchingScheduler(
            eng, mod.SchedulerConfig(max_batch=2, max_queue=8), **kwargs)
        for i, p in enumerate(prompts):
            sched.submit(mod.Request(request_id=i, prompt=p,
                                     max_new_tokens=4 + i))
        done = sched.run()
        out.append(({c.request_id: np.asarray(c.tokens) for c in done},
                    eng.cache.epoch_counts()))
    (jt, jcounts), (tt, tcounts) = out
    assert sorted(tt) == sorted(jt) == [0, 1, 2]
    for rid in jt:
        np.testing.assert_array_equal(tt[rid], jt[rid])
    assert tcounts == jcounts
