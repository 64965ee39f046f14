"""Port parity: the serving-load benchmark's sections
(``benchmarks/torch_serving_load``) on one numpy tree of weights (2-layer
f32 ``qwen15-moe-repro``, the port's CPU init):

* the traced twin: the port's gates (energy exact, p50 within 5%,
  makespan equal to the ledger's latency) and its event and span counts
  against the reference's;
* the timeline's energy check and the ici check;
* the placement live-vs-replay check, and its migrations against the
  reference's live run;
* ``expert_weight_bytes_per_step`` and the dense-vs-quantized section;
* an idle slot whose position passes the KV cache's end: the reference's
  scatter drops its row, and so must the port (it raised ``IndexError``).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro import obs as JO
from repro import sim as JSim
from repro.configs.base import get_config
from repro.core.engine import PersistentEngine as JPE
from repro.models import model as JM
from repro_torch import obs as TO
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core.engine import PersistentEngine as TPE
from repro_torch.models import model as TM

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import serving_load as JSL  # noqa: E402
from benchmarks import torch_serving_load as TSL  # noqa: E402

torch.set_num_threads(1)

WALL_KEYS = ("wall_s", "wall_tok_per_s")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config(JSL.ARCH), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(tget(TSL.ARCH), n_layers=2, dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def test_section_gates_on_the_port(model):
    """The timeline's energy check, the ici check and the traced twin's
    gates (all true by construction) on the port's sections, and the
    traced twin's events and spans against the reference's."""
    cfg, tcfg, params, tparams = model
    rows = TSL.timeline(tcfg, tparams, max_batch=4, n_requests=2,
                        device="cpu")
    assert list(rows) == [label for label, _ in TSL.TIMELINE_CELLS]
    TSL.check_async_energy(rows)
    assert "prefetch" in rows["async+prefetch(markov)"]
    obs_row, p50_rel, _ = TSL.observability(
        tcfg, tparams, rows["async"], max_batch=4, n_requests=2,
        device="cpu")
    assert p50_rel == 0.0
    jtrc = JO.TimelineTracer()
    JSL.run_cell(cfg, params, max_batch=4, n_requests=2, async_io=True,
                 tracer=jtrc)
    assert (obs_row["n_trace_events"], obs_row["n_spans"]) == \
        (len(jtrc.events), len(jtrc.spans))
    with pytest.raises(AssertionError, match="modeled energy"):
        TSL.observability(tcfg, tparams, dict(
            rows["async"], energy_per_token_j=1.0), max_batch=4,
            n_requests=2, device="cpu", tracer=TO.TimelineTracer())
    ep = TSL.ep_scaling(tcfg, tparams, max_batch=4, n_requests=2,
                        ep_values=[1, 2], device="cpu")
    TSL.check_ici(ep)
    assert len(ep[2]["per_shard_miss"]) == 2


def test_placement_fidelity(model):
    """The port's live-vs-replay placement check at ep=4 with a short
    period, and its migrations against the reference's live run."""
    cfg, tcfg, params, tparams = model
    n_mig = TSL.placement_fidelity(tcfg, tparams, n_requests=3, period=4,
                                   device="cpu")
    assert n_mig > 0
    rec = JSim.TraceRecorder()
    _, je = JSL.run_cell(cfg, params, max_batch=1, n_requests=3,
                         ep_shards=4, placement="hotness",
                         placement_period=4, cache_bytes=0.8e6,
                         recorder=rec)
    assert len(je.migration_events) == n_mig


def test_expert_weight_bytes_and_expert_ffn_section(model):
    cfg, tcfg, params, tparams = model
    for qe in (False, True):
        je = JPE(cfg, params, JSL._engine_cfg(qe))
        te = TPE(tcfg, tparams, TSL._engine_cfg(qe), device="cpu")
        for q in (False, True):
            assert te.expert_weight_bytes_per_step(quant_execution=q) == \
                je.expert_weight_bytes_per_step(quant_execution=q)
    seen = []

    def on_row(label, run):
        seen.append(label)
        return run()

    rows, reduction = TSL.expert_ffn(tcfg, tparams, max_batch=2,
                                     n_requests=2, device="cpu",
                                     on_row=on_row)
    assert seen == ["dense_dequant", "quant_execution"]
    assert reduction == pytest.approx(
        rows["dense_dequant"]["expert_weight_bytes_per_step"]
        / rows["quant_execution"]["expert_weight_bytes_per_step"])
    assert reduction > 1.0


def test_idle_slot_past_the_cache_end_drops_its_row(model):
    """A slot whose position reached ``max_seq`` (a padding slot keeps
    counting): the reference's KV scatter drops that row, the port's
    decode must do the same, and the live rows agree."""
    cfg, tcfg, params, tparams = model
    max_seq = 8
    jb = JM.init_cache(cfg, 2, max_seq)
    jb["pos"] = jnp.zeros((2,), jnp.int32)
    tb = TM.init_cache(tcfg, 2, max_seq, device="cpu")
    tb["pos"] = torch.zeros((2,), dtype=torch.int64)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    _, jc, _ = JM.prefill(params, cfg, jnp.asarray(toks), max_seq)
    _, tc, _ = TM.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                          max_seq)
    jb = JPE.install_slot(jb, jc, 0)
    tb = TPE.install_slot(tb, tc, 0)
    jb["pos"] = jb["pos"].at[1].set(max_seq)
    tb["pos"][1] = max_seq
    before = tb["pos0"]["k"][:, 1].clone()
    mask = np.array([True, False])
    token = np.array([7, 3], np.int32)
    jl, jb, _ = JM.decode_step(params, cfg, jnp.asarray(token), jb,
                               token_mask=jnp.asarray(mask))
    tl, tb, _ = TM.decode_step(tparams, tcfg, torch.from_numpy(token).long(),
                               tb, token_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], atol=1e-4)
    assert torch.equal(tb["pos0"]["k"][:, 1], before)
    np.testing.assert_allclose(tb["pos0"]["k"].numpy(),
                               np.asarray(jb["pos0"]["k"]), atol=1e-5)
    np.testing.assert_array_equal(tb["pos"].numpy(), [6, max_seq + 1])


def test_poisson_cell_past_max_seq_matches_reference(model):
    """The sweep's ``poisson@2`` cell at batch 2 over 12 requests (the
    reference's size) keeps one slot idle for more than ``MAX_SEQ``
    decode steps: it runs in both packages and the summaries agree."""
    cfg, tcfg, params, tparams = model
    kw = dict(max_batch=2, n_requests=12, kind="poisson", rate=2.0)
    js, _ = JSL.run_cell(cfg, params, **kw)
    ts, _ = TSL.run_cell(tcfg, tparams, device="cpu", **kw)
    assert_same({k: v for k, v in js.items() if k not in WALL_KEYS},
                {k: v for k, v in ts.items() if k not in WALL_KEYS})
    assert ts["n_requests"] == 12
