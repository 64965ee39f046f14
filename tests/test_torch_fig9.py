"""Port parity: the Fig. 9 scheme comparison.

The reference's ``run_one`` and the port's, on one numpy tree of weights
(2-layer f32 ``qwen15-moe-repro``), for all six schemes at one cache
capacity (30% of the slice store): MSB miss counts exact, decode energy
and latency at rtol 1e-6 (cost model).
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
from benchmarks import fig9_energy as JF  # noqa: E402
from benchmarks import torch_fig9_energy as TF  # noqa: E402

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
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size,
                                             (1, TF.PROMPT))
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree), tparams, toks,
            0.3 * total)


def test_schemes_are_the_reference_schemes():
    assert list(TF.SCHEMES) == list(JF.SCHEMES)
    assert (TF.MODELS, TF.DECODE_STEPS, TF.PROMPT) == \
        (JF.MODELS, JF.DECODE_STEPS, JF.PROMPT)
    for name, kw in TF.SCHEMES.items():
        jkw = JF.SCHEMES[name]
        assert set(kw) == set(jkw), name
        assert dataclasses.asdict(kw["policy"]) == \
            dataclasses.asdict(jkw["policy"]), name
        assert {k: v for k, v in kw.items() if k != "policy"} == \
            {k: v for k, v in jkw.items() if k != "policy"}, name


@pytest.mark.parametrize("scheme", list(TF.SCHEMES))
def test_run_one_matches_reference(model, scheme):
    cfg, tcfg, params, tparams, toks, cache_bytes = model
    je, jl, jm = JF.run_one(cfg, params, jnp.asarray(toks, jnp.int32),
                            cache_bytes, JF.SCHEMES[scheme])
    te, tl, tm = TF.run_one(tcfg, tparams, toks, cache_bytes,
                            TF.SCHEMES[scheme], device="cpu")
    assert tm == jm
    np.testing.assert_allclose(te, je, rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_run_one_with_quantized_execution_matches_reference(model):
    """``quant_execution=True`` sets the scheme's policy to quantized
    execution, on the CPU the batched kernels' plain versions; the
    reference gets the same policy (its Pallas kernel in interpret
    mode)."""
    cfg, tcfg, params, tparams, toks, cache_bytes = model
    jkw = dict(JF.SCHEMES["dbsc_pcw"])
    jkw["policy"] = dataclasses.replace(jkw["policy"], quant_execution=True)
    je, jl, jm = JF.run_one(cfg, params, jnp.asarray(toks, jnp.int32),
                            cache_bytes, jkw)
    te, tl, tm = TF.run_one(tcfg, tparams, toks, cache_bytes,
                            TF.SCHEMES["dbsc_pcw"], device="cpu",
                            quant_execution=True)
    assert not TF.SCHEMES["dbsc_pcw"]["policy"].quant_execution
    assert tm == jm
    np.testing.assert_allclose(te, je, rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
