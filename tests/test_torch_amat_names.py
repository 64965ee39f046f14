"""Port parity: the AMAT, group-quantization, slice-store and routing names
the paper's experiments use (``MAT42``, ``MAT63``, ``PAPER_CONFIGS``,
``dequant_high``, ``dequant_low``, ``QuantMeta``, ``quantization_error``,
``ExpertSliceStore.from_float`` / ``layer_weights`` / ``use_lsb_mask`` and
``topk_select``), each against its reference on the same numpy input:
codes, zero-points, scales and ids exactly, dequantized weights exactly,
errors and gates at 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amat as JA
from repro.core import slices as JS
from repro.models import moe as JM
from repro.quant import groupquant as JQ
from repro_torch.core import amat as TA
from repro_torch.core import slices as TS
from repro_torch.models import moe as TM
from repro_torch.quant import groupquant as TQ

torch.set_num_threads(1)

MATS = [c.name for c in JA.PAPER_CONFIGS]


def _mat(name):
    return (next(c for c in JA.PAPER_CONFIGS if c.name == name),
            next(c for c in TA.PAPER_CONFIGS if c.name == name))


def _weights(shape, seed, scale=0.05, bias=0.01):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
            + np.float32(bias))


def _assert_qt_equal(tq, jq):
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.zero_points.numpy(),
                                  np.asarray(jq.zero_points))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert (tq.bits, tq.group_size, tq.asymmetric) == \
        (jq.bits, jq.group_size, jq.asymmetric)


def test_paper_configs_equal_field_by_field():
    assert len(TA.PAPER_CONFIGS) == len(JA.PAPER_CONFIGS)
    for t, j in zip(TA.PAPER_CONFIGS, JA.PAPER_CONFIGS):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.shift, t.name) == (j.shift, j.name)
    for name in ("MAT42", "MAT63", "MAT84"):
        assert dataclasses.asdict(getattr(TA, name)) == \
            dataclasses.asdict(getattr(JA, name))


@pytest.mark.parametrize("name", MATS)
@pytest.mark.parametrize("seed", [0, 1])
def test_dequant_high_and_low_exact(name, seed):
    jmat, tmat = _mat(name)
    w = _weights((2, 64, 96), seed)
    jq = JA.amat_quantize(jnp.asarray(w), jmat)
    tq = TA.amat_quantize(torch.from_numpy(w), tmat)
    _assert_qt_equal(tq, jq)
    np.testing.assert_array_equal(TA.dequant_high(tq).numpy(),
                                  np.asarray(JA.dequant_high(jq)))
    np.testing.assert_array_equal(TA.dequant_low(tq, tmat).numpy(),
                                  np.asarray(JA.dequant_low(jq, jmat)))


@pytest.mark.parametrize("asymmetric", [True, False])
@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_quantization_error_matches(bits, asymmetric):
    w = _weights((3, 64, 40), seed=bits)
    jq = JQ.quantize(jnp.asarray(w), bits=bits, group_size=32,
                     asymmetric=asymmetric)
    tq = TQ.quantize(torch.from_numpy(w), bits=bits, group_size=32,
                     asymmetric=asymmetric)
    _assert_qt_equal(tq, jq)
    got = TQ.quantization_error(torch.from_numpy(w), tq)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(
        float(got), float(JQ.quantization_error(jnp.asarray(w), jq)),
        rtol=1e-6)


def test_quant_meta_fields():
    assert [f.name for f in dataclasses.fields(TQ.QuantMeta)] == \
        [f.name for f in dataclasses.fields(JQ.QuantMeta)]
    t, j = TQ.QuantMeta(4, 32, True), JQ.QuantMeta(4, 32, True)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.bits = 8


@pytest.fixture(scope="module", params=MATS)
def stores(request):
    """Both packages' stores from the same float expert weights: three
    layers of 8 experts, ``wi`` [8, 32, 64] and ``wo`` [8, 64, 32]."""
    jmat, tmat = _mat(request.param)
    w = {l: {"wi": _weights((8, 32, 64), 10 + l, scale=0.1, bias=0.0),
             "wo": _weights((8, 64, 32), 100 + l, scale=0.1, bias=0.0)}
         for l in range(3)}
    js = JS.ExpertSliceStore.from_float(
        {l: {k: jnp.asarray(v) for k, v in d.items()} for l, d in w.items()},
        jmat)
    ts = TS.ExpertSliceStore.from_float(
        {l: {k: torch.from_numpy(v) for k, v in d.items()}
         for l, d in w.items()}, tmat)
    return js, ts


def test_from_float_codes_and_bytes(stores):
    js, ts = stores
    assert dataclasses.asdict(ts.mat) == dataclasses.asdict(js.mat)
    assert list(ts.layers) == list(js.layers)
    for l in js.layers:
        _assert_qt_equal(ts.layers[l].wi_q, js.layers[l].wi_q)
        _assert_qt_equal(ts.layers[l].wo_q, js.layers[l].wo_q)
    assert ts.msb_bytes_per_expert == js.msb_bytes_per_expert
    assert ts.lsb_bytes_per_expert == js.lsb_bytes_per_expert
    assert ts.highbit_expert_bytes() == js.highbit_expert_bytes()
    assert ts.total_bytes() == js.total_bytes()
    assert (ts.n_layers, ts.n_experts) == (js.n_layers, js.n_experts)


def test_layer_weights_and_use_lsb_mask(stores):
    js, ts = stores
    for l in js.layers:
        tl, jl = ts.layer_weights(l), js.layer_weights(l)
        assert tl is ts.layers[l]
        _assert_qt_equal(tl.wi_q, jl.wi_q)
        assert tl.n_experts == jl.n_experts
    row = np.array([1, 0, 0, 1, 1, 0, 1, 0], np.int8)
    got = ts.use_lsb_mask(1, row)
    assert got.dtype == torch.bool
    assert got.device == ts.layers[1].wi_q.codes.device
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(js.use_lsb_mask(1, row)))


def _probs(kind, T, E, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if kind == "ties":
        # whole blocks of equal probabilities: ties decide the order
        logits = np.round(logits * 2) / 2
        logits[:, ::3] = logits[:, :1]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("renormalize", [True, False])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_topk_select_matches(kind, k, renormalize):
    p = _probs(kind, 13, 12, seed=k)
    jg, ji = JM.topk_select(jnp.asarray(p), k, renormalize=renormalize)
    tg, ti = TM.topk_select(torch.from_numpy(p), k, renormalize=renormalize)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=0)
