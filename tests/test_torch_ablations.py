"""Port parity: the ablations (θ, LSB keep fraction, slice-aware cache,
prefetch baseline, storage).

The reference's ``run`` and the port's, on one numpy tree of weights
(2-layer f32 ``qwen15-moe-repro``), for each of the ``--quick`` rows:
decode energy and latency at rtol 1e-6 (cost model), LSB fetches exactly
and the miss rate at rtol 1e-6; and the storage rows exactly.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SliceMoEEngine as JEngine
from repro.models.moe import RoutingPolicy as JPolicy
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core.engine import EngineConfig, SliceMoEEngine
from repro_torch.models import model as TM
from repro_torch.models.moe import RoutingPolicy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import ablations as JA  # noqa: E402
from benchmarks import torch_ablations as TA  # noqa: E402

torch.set_num_threads(1)

# The --quick rows, as (name, the reference's overrides, the port's).
ROWS = [
    ("theta_0.5",
     dict(policy=JPolicy(kind="cache_prior", slice_mode="dbsc", theta=0.5)),
     dict(policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                               theta=0.5))),
    ("lsb_keep_frac_0.125", dict(lsb_keep_frac=0.125),
     dict(lsb_keep_frac=0.125)),
    ("slice_aware", dict(fused_slices=False), dict(fused_slices=False)),
    ("fused", dict(fused_slices=True), dict(fused_slices=True)),
    ("prefetch_topk",
     dict(policy=JPolicy(kind="topk", slice_mode="highbit"),
          fused_slices=True, warmup="empty", miss_rate_target=None,
          prefetch_top_m=4),
     dict(policy=RoutingPolicy(kind="topk", slice_mode="highbit"),
          fused_slices=True, warmup="empty", miss_rate_target=None,
          prefetch_top_m=4)),
]


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    toks = np.random.default_rng(21).integers(0, tcfg.vocab_size,
                                              (1, TA.PROMPT))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"), toks)


def test_constants_are_the_reference_ones():
    assert (TA.ARCH, TA.STEPS) == (JA.ARCH, JA.STEPS)
    assert TA.HEADER == ["ablation", "setting", "energy_mj", "latency_ms",
                         "lsb_fetches", "miss_rate"]
    assert TA.CACHE_BYTES == 4e6


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_run_matches_reference(model, row):
    _, jover, tover = row
    cfg, tcfg, params, tparams, toks = model
    ref = JA.run(cfg, params, jnp.asarray(toks, jnp.int32), **jover)
    port = TA.run(tcfg, tparams, toks, device="cpu", **tover)
    assert set(port) == set(ref)
    assert port["lsb_fetches"] == ref["lsb_fetches"]
    for key in ("energy_mj", "latency_ms", "miss_rate"):
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-6,
                                   err_msg=key)


def test_quick_rows_are_the_reference_rows(model, monkeypatch):
    """``run_rows(quick=True)`` runs exactly the rows above, in the
    reference's order (each engine run stubbed out)."""
    cfg, tcfg, params, tparams, toks = model
    seen = []
    monkeypatch.setattr(TA, "run", lambda *a, **over: seen.append(over))
    rows = TA.run_rows(tcfg, tparams, toks, quick=True, device="cpu")
    assert [(r[0], r[1]) for r in rows] == [
        ("theta", 0.5), ("lsb_keep_frac", 0.125),
        ("slice_aware_cache", True), ("slice_aware_cache", False),
        ("prefetch_topk", 4)]
    for over, (_, _, tover) in zip(seen, ROWS):
        assert over.pop("device") == "cpu"
        assert over.pop("quant_execution") is False
        assert over.pop("cache_bytes") == TA.CACHE_BYTES
        assert over == tover


def test_storage_rows_match(model):
    cfg, tcfg, params, tparams, _ = model
    jst = JEngine(cfg, params, JEngineConfig(max_seq=96)).store
    tst = SliceMoEEngine(tcfg, tparams, EngineConfig(max_seq=96),
                         device="cpu").store
    rows = TA.storage_rows(tst)
    assert rows == [
        ("storage_per_expert_bytes", "amat_matryoshka",
         round(jst.highbit_expert_bytes()), "", "", ""),
        ("storage_per_expert_bytes", "hobbit_duplicated",
         round(jst.highbit_expert_bytes() + jst.msb_bytes_per_expert),
         "", "", "")]
    assert rows[0][2] < rows[1][2]
