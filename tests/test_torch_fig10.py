"""Port parity: the Fig. 10 warmup experiment.

The reference's ``run_init`` and the port's, on one numpy tree of weights
(2-layer f32 ``deepseek-v2-lite-repro``), for all four initial cache
states at 30% of the slice store: misses exactly, early and total decode
energy and latency at rtol 1e-6 (cost model), and the prefill-to-decode
hotness rank correlation at 1e-6.
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config as tget
from repro_torch.core.engine import EngineConfig, SliceMoEEngine
from repro_torch.models import model as TM

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import fig10_warmup as JF  # noqa: E402
from benchmarks import torch_fig10_warmup as TF  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-repro"),
                              n_layers=2, dtype="float32")
    tcfg = dataclasses.replace(tget("deepseek-v2-lite-repro"), n_layers=2,
                               dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    tparams = params_from_numpy(tree, "cpu")
    total = SliceMoEEngine(tcfg, tparams, EngineConfig(max_seq=96),
                           device="cpu").store.total_bytes()
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size,
                                              (1, TF.PROMPT))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree), tparams, toks,
            0.3 * total)


def test_constants_are_the_reference_ones():
    assert (TF.ARCH, TF.DECODE_STEPS, TF.EARLY, TF.PROMPT) == \
        (JF.ARCH, JF.DECODE_STEPS, JF.EARLY, JF.PROMPT)
    assert TF.INITS == ("empty", "last_layer", "random", "pcw")
    assert TF.HEADER == ["init_state", "early_energy_j", "early_latency_s",
                         "total_energy_j", "total_latency_s", "misses",
                         "hotness_corr"]


@pytest.mark.parametrize("init", TF.INITS)
def test_run_init_matches_reference(model, init):
    cfg, tcfg, params, tparams, toks, cache_bytes = model
    ref = JF.run_init(cfg, params, jnp.asarray(toks, jnp.int32), init,
                      cache_bytes)
    port = TF.run_init(tcfg, tparams, toks, init, cache_bytes, device="cpu")
    assert set(port) == set(ref)
    assert port["misses"] == ref["misses"]
    for key in ("early_energy", "early_latency", "total_energy",
                "total_latency"):
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(port["hotness_corr"], ref["hotness_corr"],
                               rtol=0, atol=1e-6)


def test_rank_corr_matches():
    rng = np.random.default_rng(3)
    a, b = rng.random(40), rng.random(40)
    b[:10] = a[:10]
    assert TF._rank_corr(a, b) == JF._rank_corr(a, b)
    assert TF._rank_corr(a, a) == pytest.approx(1.0)
