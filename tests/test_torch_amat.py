"""Port parity: group quantization and AMAT numerics.

Codes and zero-points must equal the JAX package's exactly on identical
f32 input (both round half to even); scales exactly; dequantized weights
at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amat as JA
from repro.core import slices as JS
from repro.quant import groupquant as JQ
from repro_torch.core import amat as TA
from repro_torch.core import slices as TS
from repro_torch.quant import groupquant as TQ

# The port's CPU ops are small here; one intra-op thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _weights(kind, shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if kind == "one_sided":
        w = np.abs(w)
    elif kind == "constant_groups":
        w[..., :32, :] = 0.25       # a group with zero range (scale -> 1)
    elif kind == "grid":
        # values on a coarse grid, so many w / s land on .5 exactly
        w = (np.round(w * 8) / 8).astype(np.float32)
    return w


KINDS = ["normal", "one_sided", "constant_groups", "grid"]


def _assert_qt_equal(tq, jq):
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.zero_points.numpy(),
                                  np.asarray(jq.zero_points))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert (tq.bits, tq.group_size, tq.asymmetric) == \
        (jq.bits, jq.group_size, jq.asymmetric)


@pytest.mark.parametrize("asymmetric", [True, False])
@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_matches_reference_exactly(kind, bits, asymmetric):
    w = _weights(kind, (3, 96, 40), seed=bits)
    jq = JQ.quantize(jnp.asarray(w), bits=bits, group_size=32,
                     asymmetric=asymmetric)
    tq = TQ.quantize(torch.from_numpy(w), bits=bits, group_size=32,
                     asymmetric=asymmetric)
    _assert_qt_equal(tq, jq)
    np.testing.assert_allclose(TQ.dequantize(tq).numpy(),
                               np.asarray(JQ.dequantize(jq)), atol=1e-6)
    assert tq.nbytes_weights == jq.nbytes_weights


def test_quantize_leaves_its_f32_input_untouched():
    w = torch.from_numpy(_weights("normal", (64, 16), seed=0))
    before = w.clone()
    TQ.quantize(w)
    torch.testing.assert_close(w, before, rtol=0, atol=0)


def test_quantize_rejects_ragged_groups():
    with pytest.raises(ValueError, match="group_size"):
        TQ.quantize(torch.zeros(48, 8), group_size=32)


@pytest.mark.parametrize("mat", JA.PAPER_CONFIGS, ids=lambda m: m.name)
@pytest.mark.parametrize("kind", KINDS)
def test_amat_quantize_truncate_dequant_mixed(mat, kind):
    w = _weights(kind, (4, 64, 24), seed=mat.high_bits)
    tmat = TA.MatConfig(mat.high_bits, mat.low_bits, mat.group_size)
    jq = JA.amat_quantize(jnp.asarray(w), mat)
    tq = TA.amat_quantize(torch.from_numpy(w), tmat)
    _assert_qt_equal(tq, jq)

    for tz, rs in ((True, True), (False, False)):
        jl = JA.truncate(jq, low_bits=mat.low_bits, truncate_zp=tz,
                         rescale=rs)
        tl = TA.truncate(tq, low_bits=mat.low_bits, truncate_zp=tz,
                         rescale=rs)
        _assert_qt_equal(tl, jl)
    low = TA.truncate(tq, low_bits=mat.low_bits)
    np.testing.assert_allclose(TQ.dequantize(low).numpy(),
                               np.asarray(JA.dequant_low(jq, mat)),
                               atol=1e-6)

    use_lsb = np.array([True, False, False, True])
    np.testing.assert_allclose(
        TA.dequant_mixed(tq, torch.from_numpy(use_lsb), mat.shift).numpy(),
        np.asarray(JA.dequant_mixed(jq, jnp.asarray(use_lsb), mat.shift)),
        atol=1e-6)


@pytest.mark.parametrize("shift", [1, 2, 3, 4])
def test_bit_slices_match_and_reconstruct(shift):
    codes = np.arange(256, dtype=np.uint8).reshape(16, 16)
    tc, jc = torch.from_numpy(codes), jnp.asarray(codes)
    msb, lsb = TA.msb_slice(tc, shift), TA.lsb_slice(tc, shift)
    np.testing.assert_array_equal(msb.numpy(),
                                  np.asarray(JA.msb_slice(jc, shift)))
    np.testing.assert_array_equal(lsb.numpy(),
                                  np.asarray(JA.lsb_slice(jc, shift)))
    np.testing.assert_array_equal(TA.reconstruct(msb, lsb, shift).numpy(),
                                  codes)


@pytest.mark.parametrize("which", ["msb", "lsb"])
@pytest.mark.parametrize("mat", JA.PAPER_CONFIGS, ids=lambda m: m.name)
def test_slice_nbytes_matches(mat, which):
    for shape in ((256, 128), (64, 256), (2048, 2816), (1408, 2048)):
        assert TA.slice_nbytes(shape, mat.high_bits, mat.group_size,
                               which=which, shift=mat.shift) == \
            JA.slice_nbytes(shape, mat.high_bits, mat.group_size,
                            which=which, shift=mat.shift)


def test_quantize_moe_params_period_by_period_matches_whole_stack():
    """The port quantizes one period at a time (the reference casts the
    whole stack to f32 first); codes, scales, zero-points, the transposed
    wo codes and the store's slice sizes must be identical."""
    from repro.configs.base import get_config
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.base import get_config as tget
    from repro_torch.models import model as TM

    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=3,
                              dtype="float32")
    tcfg = dataclasses.replace(tget("qwen15-moe-repro"), n_layers=3,
                               dtype="float32")
    # Drawn by the port's init on the CPU (jax.random compiles every shape
    # on its first call), handed to JAX as arrays and to the port through
    # the bridge.
    tree = jax.tree.map(lambda t: t.numpy(),
                        TM.init_params(tcfg, seed=3, device="cpu"))
    params = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, "cpu")
    jp, jstore, jmap = JS.quantize_moe_params(params, cfg, JA.MAT84,
                                              quant_execution=True)
    tp, tstore, tmap = TS.quantize_moe_params(tparams, tcfg, TA.MAT84,
                                              quant_execution=True)
    assert jmap == tmap
    je, te = jp["blocks"]["pos0"]["moe"]["experts"], \
        tp["blocks"]["pos0"]["moe"]["experts"]
    for name in ("wi_q", "wo_q"):
        _assert_qt_equal(te[name], je[name])
    np.testing.assert_array_equal(te["wo_codes_t"].numpy(),
                                  np.asarray(je["wo_codes_t"]))
    assert tstore.msb_bytes_per_expert == jstore.msb_bytes_per_expert
    assert tstore.lsb_bytes_per_expert == jstore.lsb_bytes_per_expert
    assert tstore.total_bytes() == jstore.total_bytes()
    assert sorted(tstore.layers) == sorted(jstore.layers)
    assert list(tstore.all_keys()) == list(jstore.all_keys())
