"""Port parity: blockwise (online-softmax) attention and the dispatch of
``attention`` above ``BLOCKWISE_THRESHOLD`` keys.

``blockwise_attention`` against the reference's on the same seeded numpy
inputs at small ``block_kv``: causal on and off, ``q_offset`` (int and
tensor), ``sliding_window``, ``logit_softcap``, GQA, and padding where
``sk % block_kv != 0``; f32 outputs at 1e-4 (``tests/test_layers.py``'s
tolerance for the blockwise-vs-dense check).  The port's blockwise result
also holds its own dense ``attention`` at the same tolerance, and
``attention`` dispatches to the blockwise body above 8192 keys at tiny
heads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

torch.set_num_threads(1)


def _qkv(seed, b=2, sq=24, sk=24, h=4, hkv=2, d=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(dtype)
    k = rng.standard_normal((b, sk, hkv, d)).astype(dtype)
    v = rng.standard_normal((b, sk, hkv, d)).astype(dtype)
    return q, k, v


def _both(fn_j, fn_t, q, k, v, **kw):
    j = np.asarray(fn_j(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        **kw))
    t = fn_t(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             **kw).numpy()
    return j, t


CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(causal=False),
    "q_offset": dict(causal=True, q_offset=7),
    "sliding_window": dict(causal=True, sliding_window=5),
    "window_and_offset": dict(causal=True, sliding_window=9, q_offset=3),
    "softcap": dict(causal=True, logit_softcap=2.0),
    "softcap_non_causal": dict(causal=False, logit_softcap=5.0),
}


@pytest.mark.parametrize("block_kv", [4, 7, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_matches_reference(case, block_kv):
    kw = dict(CASES[case], block_kv=block_kv)
    seed = sorted(CASES).index(case)
    q, k, v = _qkv(seed, sk=30 if block_kv == 7 else 24)
    if kw.get("q_offset"):
        q = q[:, :16]                      # a chunk at an offset
    j, t = _both(JL.blockwise_attention, TL.blockwise_attention, q, k, v,
                 **kw)
    assert t.shape == j.shape == q.shape
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_equals_dense(case):
    """The port's blockwise result against its own dense body."""
    kw = CASES[case]
    q, k, v = _qkv(11, sk=24)
    if kw.get("q_offset"):
        q = q[:, :16]
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    dense = TL.dense_attention(qt, kt, vt, **kw)
    assert torch.equal(dense, TL.attention(qt, kt, vt, **kw))
    blk = TL.blockwise_attention(qt, kt, vt, block_kv=5, **kw)
    np.testing.assert_allclose(blk.numpy(), dense.numpy(), atol=1e-4,
                               rtol=0)


def test_dense_extras_match_reference():
    """q_offset, sliding window and soft-cap in the dense body."""
    q, k, v = _qkv(3)
    for kw in CASES.values():
        j, t = _both(JL.attention, TL.attention, q, k, v, **kw)
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


def test_tensor_q_offset():
    q, k, v = _qkv(5, sq=8, sk=20)
    j = np.asarray(JL.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=jnp.asarray(12, jnp.int32), block_kv=6))
    t = TL.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_offset=torch.tensor(12), block_kv=6)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=0)


def test_bf16_inputs_keep_their_dtype():
    q, k, v = _qkv(9, sk=20)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = TL.blockwise_attention(qt, kt, vt, causal=True, block_kv=8)
    assert out.dtype == torch.bfloat16
    j = JL.blockwise_attention(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)), causal=True,
                               block_kv=8)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_dispatches_blockwise_above_threshold(causal):
    """Above 8192 keys ``attention`` runs the blockwise body (tiny heads:
    B=1, H=2, Hkv=1, D=4), and matches the reference's dispatch."""
    sk = TL.BLOCKWISE_THRESHOLD + 300
    q, k, v = _qkv(21, b=1, sq=4, sk=sk, h=2, hkv=1, d=4)
    kw = dict(causal=causal, q_offset=sk - 4)
    j, t = _both(JL.attention, TL.attention, q, k, v, **kw)
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    blk = TL.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_array_equal(t, blk.numpy())
    dense = TL.dense_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(t, dense.numpy(), atol=1e-4, rtol=0)
    assert TL.BLOCK_KV == JL.BLOCK_KV == 1024
    assert TL.BLOCKWISE_THRESHOLD == JL.BLOCKWISE_THRESHOLD
