"""Port parity: the SliceMoE engine's sync charge path.

Parameters reach both packages as one numpy tree (the port's side through
the weight bridge).  Tokens and per-epoch miss counts must be exact;
ledger totals agree at rtol 1e-6; the analytic expert-weight traffic is
equal.  The JAX side with ``quant_execution`` runs its Pallas kernel in
interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core import engine as JE
from repro.core.amat import MatConfig as JMat
from repro.models.moe import RoutingPolicy as JRP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core import engine as TE
from repro_torch.core.amat import MatConfig as TMat
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy as TRP

# The port's CPU ops are small here; one intra-op thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

KW = dict(cache_bytes=2.5e6, miss_rate_target=0.1, warmup="pcw", max_seq=48)


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
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    return (cfg, tcfg, *_shared_params(tcfg, seed=0))


def _engines(model, cls, policy, **over):
    cfg, tcfg, params, tparams = model
    kw = dict(KW, **over)
    j = getattr(JE, cls)(cfg, params, JE.EngineConfig(
        mat=JMat(8, 4), policy=JRP(**policy), **kw))
    t = getattr(TE, cls)(tcfg, tparams, TE.EngineConfig(
        mat=TMat(8, 4), policy=TRP(**policy), **kw), device="cpu")
    return j, t


def _assert_ledger_close(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-15,
                                   err_msg=k)


@pytest.mark.parametrize("quant_execution", [False, True],
                         ids=["dense_dequant", "quant_exec"])
def test_slicemoe_engine_matches_reference(model, quant_execution):
    cfg = model[0]
    policy = dict(kind="cache_prior", slice_mode="dbsc",
                  quant_execution=quant_execution)
    je, te = _engines(model, "SliceMoEEngine", policy)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    jl = je.prefill(jnp.asarray(toks, jnp.int32))
    tl = te.prefill(toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert te.warmup_summary == je.warmup_summary
    _assert_ledger_close(je.prefill_snapshot, te.prefill_snapshot)

    jt, jm = je.decode(jnp.argmax(jl, -1).astype(jnp.int32), 6)
    tt, tm = te.decode(torch.argmax(tl, -1), 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tm["cache_stats"] == jm["cache_stats"]
    _assert_ledger_close(jm["decode_totals"], tm["decode_totals"])
    assert [s["miss_rate"] for s in tm["per_step"]] == \
        [s["miss_rate"] for s in jm["per_step"]]
    assert [s["alpha"] for s in tm["per_step"]] == \
        [s["alpha"] for s in jm["per_step"]]
    _assert_ledger_close(je.ledger.snapshot(), te.ledger.snapshot())
    assert te.expert_weight_bytes_per_step() == \
        je.expert_weight_bytes_per_step()
    for qe in (False, True):
        assert te.expert_weight_bytes_per_step(quant_execution=qe) == \
            je.expert_weight_bytes_per_step(quant_execution=qe)
    assert te.resident_bytes == je.resident_bytes
    if quant_execution:
        e = te.qparams["blocks"]["pos0"]["moe"]["experts"]
        P, E, F, d = e["wo_q"].codes.shape
        assert tuple(e["wo_codes_t"].shape) == (P, E, d, F)


def test_deepseek_repro_engine_matches_reference():
    """The paper's other eval model (64 experts, top-6, 2 shared experts)
    through the quantized-execution path."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-repro"),
                              n_layers=2, dtype="float32")
    tcfg = dataclasses.replace(tget("deepseek-v2-lite-repro"), n_layers=2,
                               dtype="float32")
    params, tparams = _shared_params(tcfg, seed=1)
    policy = dict(kind="cache_prior", slice_mode="dbsc",
                  quant_execution=True)
    je, te = _engines((cfg, tcfg, params, tparams), "SliceMoEEngine", policy)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 14))
    jl = je.prefill(jnp.asarray(toks, jnp.int32))
    tl = te.prefill(toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    jt, jm = je.decode(jnp.argmax(jl, -1).astype(jnp.int32), 4)
    tt, tm = te.decode(torch.argmax(tl, -1), 4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tm["cache_stats"] == jm["cache_stats"]
    _assert_ledger_close(jm["decode_totals"], tm["decode_totals"])


@pytest.mark.parametrize("warmup", ["pcw", "empty", "last_layer"])
def test_persistent_engine_epoch_counts_across_requests(model, warmup):
    """Two labelled requests through run_prefill + decode_batch on a
    small cache: per-epoch (accesses, misses), hotness and every step's
    charge must match."""
    cfg = model[0]
    policy = dict(kind="cache_prior", slice_mode="dbsc", theta=0.3)
    je, te = _engines(model, "PersistentEngine", policy, cache_bytes=1.2e6,
                      warmup=warmup)
    rng = np.random.default_rng(1)
    for r in range(2):
        toks = rng.integers(0, cfg.vocab_size, (1, 12))   # one prefill compile
        jl, jkv, jinfo = je.run_prefill(jnp.asarray(toks, jnp.int32),
                                        label=f"r{r}")
        tl, tkv, tinfo = te.run_prefill(toks, label=f"r{r}")
        assert tinfo["warmup"] == jinfo["warmup"]
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        for step in range(4):
            alpha = 0.5 * step
            jl, jkv, jc = je.decode_batch(jt, jkv, alpha=alpha)
            tl, tkv, tc = te.decode_batch(tt, tkv, alpha=alpha)
            assert (tc.accesses, tc.misses) == (jc.accesses, jc.misses)
            np.testing.assert_array_equal(tc.per_slot_miss, jc.per_slot_miss)
            _assert_ledger_close(jc.ledger_delta, tc.ledger_delta)
            jt = jnp.argmax(jl, -1).astype(jnp.int32)
            tt = torch.argmax(tl, -1)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    je.cache.end_epoch()
    te.cache.end_epoch()
    assert te.cache.epoch_counts() == je.cache.epoch_counts()
    # Hotness accumulates gate mass: gates agree to f32 rounding only.
    np.testing.assert_allclose(te.tracker.hotness(), je.tracker.hotness(),
                               rtol=1e-5)
    assert te.cache.resident_keys() == je.cache.resident_keys()


def test_charge_step_trace_is_identical_on_identical_routing(model):
    """The charge path alone: the same routing trace replayed into both
    engines gives equal StepCharge values and ledger snapshots."""
    policy = dict(kind="topk", slice_mode="dbsc")
    je, te = _engines(model, "PersistentEngine", policy, cache_bytes=0.8e6,
                      fused_slices=False)
    E = 60
    rng = np.random.default_rng(2)
    for _ in range(5):
        ids = rng.integers(0, E, (2, 1, 3, 4))
        gates = rng.dirichlet(np.ones(4), size=(2, 1, 3))
        crit = gates >= 0.5
        active = np.ones(ids.shape, bool)
        slot = np.array([True, False, True])
        jtr = JE._StepTrace(ids=ids, gates=gates, active=active,
                            critical=crit, slot_mask=slot,
                            slot_accesses=np.zeros(3, np.int64),
                            slot_misses=np.zeros(3, np.int64))
        ttr = TE._StepTrace(ids=ids, gates=gates, active=active,
                            critical=crit, slot_mask=slot,
                            slot_accesses=np.zeros(3, np.int64),
                            slot_misses=np.zeros(3, np.int64))
        jc, tc = je.charge_step_trace(jtr), te.charge_step_trace(ttr)
        assert (tc.accesses, tc.misses, tc.miss_rate) == \
            (jc.accesses, jc.misses, jc.miss_rate)
        np.testing.assert_array_equal(tc.per_slot_miss, jc.per_slot_miss)
        _assert_ledger_close(jc.ledger_delta, tc.ledger_delta)
    _assert_ledger_close(je.ledger.snapshot(), te.ledger.snapshot())


def test_aux_to_host_restores_dtypes_in_one_buffer():
    aux = {"ids": torch.tensor([[3, 59]]), "gates": torch.tensor(
        [[0.25, 0.75]], dtype=torch.bfloat16), "active": torch.tensor(
        [[True, False]])}
    h = TE.aux_to_host(aux, ("ids", "gates", "active"))
    assert h["ids"].dtype == np.int64 and h["ids"].tolist() == [[3, 59]]
    assert h["gates"].dtype == np.float64 and h["gates"].tolist() == \
        [[0.25, 0.75]]
    assert h["active"].dtype == bool and h["active"].tolist() == \
        [[True, False]]


@pytest.mark.parametrize("over, item", [
    (dict(system="tpu_offload"), "tpu_offload profile"),
])
def test_unported_engine_settings_name_their_queue_item(model, over, item):
    """Each setting here once raised ``NotImplementedError`` naming its
    ROADMAP.md queue 1 item (``item``).  Every one is ported now: the
    engine builds with it and its ledger charges the profile it names,
    and a name in no profile raises the reference's ``KeyError``."""
    from repro_torch.hw.specs import SYSTEM_PROFILES

    _, tcfg, _, tparams = model
    eng = TE.PersistentEngine(tcfg, tparams, TE.EngineConfig(**over),
                              device="cpu")
    assert eng.ledger.system is SYSTEM_PROFILES[over["system"]]
    with pytest.raises(KeyError):
        TE.PersistentEngine(tcfg, tparams, TE.EngineConfig(system="nope"),
                            device="cpu")


@pytest.mark.parametrize("poison", [False, True], ids=["finite", "nan"])
def test_decode_reports_whether_every_logit_was_finite(model, poison):
    _, tcfg, _, tparams = model
    if poison:
        tparams = dict(tparams, final_norm=torch.full_like(
            tparams["final_norm"], float("nan")))
    te = TE.SliceMoEEngine(tcfg, tparams, TE.EngineConfig(
        mat=TMat(8, 4), **KW), device="cpu")
    te.prefill(np.arange(8)[None])
    _, metrics = te.decode(torch.tensor([1]), 2)
    assert metrics["logits_finite"] is (not poison)
