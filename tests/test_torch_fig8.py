"""Port parity: the Fig. 8 accuracy-vs-miss-rate experiment.

The reference's ``_oracle_trajectory`` and ``_run_scheme`` and the port's,
on one numpy tree of weights (2-layer f32 ``qwen15-moe-repro``), at the
quick cell (cache 30% of the slice store, miss target 0.05) for all four
schemes: the float oracle's trajectory and each scheme's decode
trajectory exactly, the high-bit-normalized miss rate at rtol 1e-6 and
the cache stats exactly.
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
from benchmarks import fig8_accuracy as JF  # noqa: E402
from benchmarks import torch_fig8_accuracy as TF  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    tparams = params_from_numpy(tree, "cpu")
    total = SliceMoEEngine(tcfg, tparams, EngineConfig(max_seq=96),
                           device="cpu").store.total_bytes()
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size,
                                             (1, TF.PROMPT))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree), tparams, toks,
            0.3 * total)


def test_constants_are_the_reference_ones():
    assert (TF.ARCH, TF.DECODE_STEPS, TF.PROMPT) == \
        (JF.ARCH, JF.DECODE_STEPS, JF.PROMPT)
    assert TF.HEADER == ["scheme", "cache_frac", "miss_target",
                         "norm_miss_rate", "top1_agreement"]
    assert TF.SCHEMES == ("highbit", "lowbit", "amat_static", "dbsc")


@pytest.fixture(scope="module")
def oracles(model):
    cfg, tcfg, params, tparams, toks, _ = model
    return (JF._oracle_trajectory(cfg, params, jnp.asarray(toks, jnp.int32)),
            TF._oracle_trajectory(tcfg, tparams, toks))


def test_oracle_trajectory_matches(oracles):
    ref, port = oracles
    assert port == ref
    assert len(port) == TF.DECODE_STEPS


@pytest.mark.parametrize("mode", TF.SCHEMES)
def test_run_scheme_matches_reference(model, oracles, mode):
    cfg, tcfg, params, tparams, toks, cache_bytes = model
    jt, jm, jmet = JF._run_scheme(cfg, params, jnp.asarray(toks, jnp.int32),
                                  mode=mode, cache_bytes=cache_bytes,
                                  miss_target=0.05)
    tt, tm, tmet = TF._run_scheme(tcfg, tparams, toks, mode=mode,
                                  cache_bytes=cache_bytes, miss_target=0.05,
                                  device="cpu")
    assert tt == jt
    assert tmet["cache_stats"] == dict(jmet["cache_stats"])
    np.testing.assert_allclose(tm, jm, rtol=1e-6)
    assert 0.0 <= tm <= 1.0
    ref_oracle, port_oracle = oracles
    assert TF.agreement(tt, port_oracle) == \
        float(np.mean([a == b for a, b in zip(jt, ref_oracle)]))
