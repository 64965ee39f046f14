"""Port parity: Table 1 (AMAT against naive truncation, by synthetic PPL).

The reference's ``_scheme_weights`` / ``_replace_experts`` and the port's,
on one numpy tree of weights (2-layer f32 ``qwen15-moe-repro``), for every
scheme of all three paper MAT configs under symmetric and asymmetric
group-32 quantization: the dequantized expert weights exactly, and the
synthetic perplexity on one held-out batch at rtol 1e-4.
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
from repro_torch.models import model as TM

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import common as JC  # noqa: E402
from benchmarks import table1_amat as JT  # noqa: E402
from benchmarks import torch_common as TC  # noqa: E402
from benchmarks import torch_table1_amat as TT  # noqa: E402

torch.set_num_threads(1)

CASES = [(j, t, asym, scheme, bits)
         for j, t in zip(JT.PAPER_CONFIGS, TT.PAPER_CONFIGS)
         for asym in (False, True)
         for scheme, bits in TT.schemes_of(t, asym)]


def _id(case):
    j, _, asym, scheme, _ = case
    return f"{j.name}-{'asym' if asym else 'sym'}-{scheme}"


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=2,
                               dtype="float32")
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=0, device="cpu"))
    batches = TC.eval_batches(tcfg, n_batches=1)
    return (cfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"), batches)


def test_constants_and_schemes_are_the_reference_ones():
    assert TT.MODELS == JT.MODELS
    assert [dataclasses.asdict(c) for c in TT.PAPER_CONFIGS] == \
        [dataclasses.asdict(c) for c in JT.PAPER_CONFIGS]
    for t in TT.PAPER_CONFIGS:
        assert [s for s, _ in TT.schemes_of(t, False)] == \
            ["base_high", "base_low", "trunc_low"]
        assert [s for s, _ in TT.schemes_of(t, True)] == \
            ["base_high", "base_low", "trunc_low", "amat_high", "amat_low"]


def test_eval_batches_are_the_reference_ones(model):
    cfg, tcfg, *_ = model
    for t, j in zip(TC.eval_batches(tcfg, n_batches=2),
                    JC.eval_batches(cfg, n_batches=2)):
        np.testing.assert_array_equal(t, np.asarray(j))


def test_float_ppl_matches(model):
    cfg, tcfg, params, tparams, batches = model
    np.testing.assert_allclose(TC.synthetic_ppl(tparams, tcfg, batches),
                               JC.synthetic_ppl(params, cfg, batches),
                               rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_scheme_weights_and_ppl_match(model, case):
    jmat, tmat, asym, scheme, _ = case
    cfg, tcfg, params, tparams, batches = model

    def jtf(wi, wo):
        return tuple(JT._scheme_weights(w, scheme=scheme,
                                        high=jmat.high_bits,
                                        low=jmat.low_bits, asym=asym)
                     for w in (wi, wo))

    jq = JT._replace_experts(params, jtf)
    tq = TT.scheme_params(tparams, scheme, tmat, asym)
    for pos, blk in jq["blocks"].items():
        if "moe" not in blk:
            continue
        for name in ("wi", "wo"):
            np.testing.assert_array_equal(
                tq["blocks"][pos]["moe"]["experts"][name].numpy(),
                np.asarray(blk["moe"]["experts"][name]), err_msg=name)
    np.testing.assert_allclose(TC.synthetic_ppl(tq, tcfg, batches),
                               JC.synthetic_ppl(jq, cfg, batches),
                               rtol=1e-4)
