"""Port parity: the building blocks of ``repro_torch.models.layers`` that
the dense and windowed architectures add, against ``repro.models.layers``
on the same numpy inputs: the four MLP types (``mlp_apply``,
``ffn_activation``), ``layer_norm`` and decode attention with a sliding
window and logit soft-capping, at scalar and per-sequence positions; f32
at atol 1e-5 (the two sides round their f32 sums and the tanh GELU in
another order), bf16 activations within one bf16 rounding (rtol 2^-7,
atol 1e-5 where the GELU's tail cancels).  Then the reference's own
layer tests (``tests/test_layers.py:76-136``) on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.models import layers as TL

torch.set_num_threads(1)

MLP_TYPES = ["swiglu", "geglu", "relu2", "gelu"]


def _np(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _both(a, dtype="float32"):
    return (jnp.asarray(a, dtype=dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.to(torch.float32).numpy()


def _mlp_params(d, f, mlp_type, seed):
    shapes = TL.mlp_param_shapes(d, f, mlp_type)
    assert shapes == JL.mlp_param_shapes(d, f, mlp_type)
    return {k: _np(s, seed + i, 0.05) for i, (k, s) in
            enumerate(sorted(shapes.items()))}


# --------------------------------------------------------------------- MLPs
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", MLP_TYPES)
def test_mlp_apply_matches_reference(mlp_type, dtype):
    p = _mlp_params(32, 64, mlp_type, seed=1)
    jx, tx = _both(_np((6, 32), 2), dtype)
    jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    want, got = JL.mlp_apply(jp, jx, mlp_type), TL.mlp_apply(tp, tx, mlp_type)
    assert got.shape == (6, 32) and got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)
    else:
        # Matmuls in bf16 accumulate in another order on the two sides.
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", MLP_TYPES)
def test_ffn_activation_matches_reference(mlp_type, dtype):
    """The activation alone: the gated halves, the f32 nonlinearity (the
    tanh GELU for ``geglu`` and ``gelu``) and the cast."""
    jh, th = _both(_np((3, 5, 64), 3, scale=2.0), dtype)
    want = JM._ffn_activation(jh, mlp_type, jh.dtype)
    got = TL.ffn_activation(th, mlp_type, th.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                               rtol=1e-5 if dtype == "float32" else 2 ** -7)


def test_unknown_mlp_type_raises():
    with pytest.raises(ValueError, match="unknown mlp_type"):
        TL.mlp_apply({"wi": torch.zeros(4, 4), "wo": torch.zeros(4, 4)},
                     torch.zeros(1, 4), "relu")


@pytest.mark.parametrize("mlp_type", MLP_TYPES)
def test_mlp_shapes_and_finiteness(mlp_type):
    """``tests/test_layers.py::TestMLP::test_shapes_and_finiteness``."""
    p = {k: torch.from_numpy(v) for k, v in
         _mlp_params(32, 64, mlp_type, seed=4).items()}
    y = TL.mlp_apply(p, torch.from_numpy(_np((4, 32), 5)), mlp_type)
    assert y.shape == (4, 32)
    assert torch.isfinite(y).all()


def test_relu2_is_a_nonnegative_mix_of_wo_rows():
    """``TestMLP::test_relu2_nonnegative_preactivation``, on the port's
    activation: with ``wo`` the identity the output is the squared ReLU."""
    wi = torch.from_numpy(_np((16, 32), 6))
    x = torch.from_numpy(_np((4, 16), 7))
    h = TL.mlp_apply({"wi": wi, "wo": torch.eye(32)}, x, "relu2")
    assert (h >= 0).all()
    torch.testing.assert_close(h, torch.square(torch.relu(x @ wi)))


# -------------------------------------------------------------------- norms
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    jx, tx = _both(_np((4, 32), 8, shift=3.0), dtype)
    js, ts = _both(_np((32,), 9, shift=1.0))
    jb, tb = _both(_np((32,), 10))
    got = TL.layer_norm(tx, ts, tb)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_f32(got), _f32(JL.layer_norm(jx, js, jb)),
                               atol=1e-5,
                               rtol=1e-5 if dtype == "float32" else 2 ** -7)


def test_layernorm_zero_mean():
    """``TestNorms::test_layernorm_zero_mean``."""
    x = torch.from_numpy(_np((4, 32), 11, shift=3.0))
    y = TL.layer_norm(x, torch.ones(32), torch.zeros(32))
    np.testing.assert_allclose(y.mean(-1).numpy(), 0.0, atol=1e-5)


def test_rmsnorm_scale_invariant_direction():
    """``TestNorms::test_rmsnorm_scale_invariant_direction``."""
    x = torch.from_numpy(_np((4, 32), 12))
    s = torch.zeros(32)
    torch.testing.assert_close(TL.rms_norm(x, s), TL.rms_norm(x * 10.0, s),
                               atol=1e-4, rtol=0)


# ---------------------------------------------------------------- attention
def _qkv(b=2, sq=16, sk=16, h=4, kv=2, d=32, seed=0):
    return (_np((b, sq, h, d), seed), _np((b, sk, kv, d), seed + 1),
            _np((b, sk, kv, d), seed + 2))


@pytest.mark.parametrize("cap", [None, 5.0])
@pytest.mark.parametrize("window", [None, 1, 4, 11])
@pytest.mark.parametrize("cur", [11, [11, 3], [16, 1]], ids=str)
def test_decode_attention_matches_reference(cur, window, cap):
    q, k, v = _qkv(sq=1, sk=16, seed=13)
    q = q[:, 0] * 3.0                       # larger scores: the cap bites
    jcur = jnp.asarray(cur, jnp.int32)
    tcur = torch.tensor(cur)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jcur, sliding_window=window,
                               logit_softcap=cap)
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), tcur,
                              sliding_window=window, logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("window,cap", [(None, None), (5, None), (None, 5.0),
                                        (5, 5.0)])
def test_decode_matches_full(window, cap):
    """``TestAttention::test_decode_matches_full``, with a window and a
    soft-cap: a decode step equals the last row of full attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(sq=8, sk=8, seed=16))
    full = TL.attention(q, k, v, causal=True, sliding_window=window,
                        logit_softcap=cap)
    dec = TL.decode_attention(q[:, -1], k, v, cur_pos=torch.tensor(8),
                              sliding_window=window, logit_softcap=cap)
    torch.testing.assert_close(full[:, -1], dec, atol=1e-5, rtol=0)


def test_decode_ignores_stale_cache():
    """``TestAttention::test_decode_ignores_stale_cache``, windowed too."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(sq=1, sk=16, seed=19))
    k2 = k.clone()
    k2[:, 10:] = 7.0
    for window in (None, 3):
        d1 = TL.decode_attention(q[:, 0], k, v, torch.tensor(4),
                                 sliding_window=window)
        d2 = TL.decode_attention(q[:, 0], k2, v, torch.tensor(4),
                                 sliding_window=window)
        torch.testing.assert_close(d1, d2, atol=1e-6, rtol=0)


def test_decode_window_ignores_rows_before_it():
    """Rows older than the window do not move the output."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(sq=1, sk=16, seed=22))
    k2, v2 = k.clone(), v.clone()
    k2[:, :8], v2[:, :8] = 5.0, -5.0
    d1 = TL.decode_attention(q[:, 0], k, v, torch.tensor(12),
                             sliding_window=4)
    d2 = TL.decode_attention(q[:, 0], k2, v2, torch.tensor(12),
                             sliding_window=4)
    torch.testing.assert_close(d1, d2, atol=0, rtol=0)


def test_softcap_stays_finite():
    """``TestAttention::test_softcap``."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed=25))
    a = TL.attention(q * 10, k * 10, v, causal=True, logit_softcap=5.0)
    assert not torch.isnan(a).any()


def test_gqa_equals_repeated_mha():
    """``TestAttention::test_gqa_equals_repeated_mha``."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(h=8, kv=2, seed=28))
    gqa = TL.attention(q, k, v, causal=True)
    mha = TL.attention(q, TL._expand_kv(k, 4), TL._expand_kv(v, 4),
                       causal=True)
    torch.testing.assert_close(gqa, mha, atol=1e-5, rtol=0)
