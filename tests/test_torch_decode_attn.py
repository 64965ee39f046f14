"""The decode-attention kernel's plain version and its routes, on the CPU.

``kernels/decode_attn/ref.py`` is the plain route of one attention layer
of a decode step (RoPE on q and the new k, the new K/V rows written at
each sequence's position, attention over the cache).  Held here:

* through the wrapper's CPU path, bit for bit against the op sequence
  ``models/model.py::_attn_decode`` ran before the kernel existed
  (``_parent_ops`` below: ``apply_rope`` twice, ``write_row`` twice, the
  aligned window's ``index_select``, ``decode_attention``), in bf16, output
  and caches; and against the JAX reference's ``apply_rope`` and
  ``decode_attention`` over the same rows, in f32 at atol 1e-5 (the two
  sides take cos, sin and their sums in another order), as
  ``tests/test_torch_layers.py`` holds decode attention;
* over per-sequence and scalar positions, a slot at ``pos >= S`` (its row
  dropped; with a window, no row valid and every row weighed alike), GQA
  ratios 1, 3 and 4, head dims 32, 64, 128 and 256, a window and a
  soft-cap of 30;
* the route each (dtype, device, ring, kv_dtype) takes, the shape plan,
  and the wrapper's refusals of what the kernel does not take.

The kernel itself runs only on the card: ``tests/test_torch_decode_attn_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels.decode_attn import ops as DA_ops
from repro_torch.models import layers as L

torch.set_num_threads(1)

B, S, THETA = 4, 16, 10000.0
POSITIONS = {
    "vector": [3, S - 1, 0, 9],
    "scalar": 9,
    "past_end": [S + 7, 2, S - 1, 11],
}


def _parent_ops(q, k, v, k_cache, v_cache, pos, theta, window, cap):
    """``_attn_decode``'s attention as it was before the kernel, for a cache
    that is neither a ring nor int8 (q [B, 1, H, D], k/v [B, 1, Hkv, D])."""
    b = q.shape[0]
    vector_pos = pos.ndim == 1
    positions = pos[:, None] if vector_pos else pos.reshape(1, 1)
    rows = torch.arange(b, device=q.device)
    q = L.apply_rope(q, positions, theta)
    k = L.apply_rope(k, positions, theta)
    s_cache = k_cache.shape[1]

    def write_row(buf, val):
        if vector_pos:
            at = pos.clamp(max=buf.shape[1] - 1)
            keep = (pos < buf.shape[1]).reshape(
                (b,) + (1,) * (buf.ndim - 2))
            buf[rows, at] = torch.where(
                keep, val[:, 0].to(buf.dtype), buf[rows, at])
        else:
            buf[:, pos.reshape(1)] = val.to(buf.dtype)
        return buf

    bufs = [write_row(k_cache, k), write_row(v_cache, v)]
    cur, win_mask = pos + 1, window
    if not vector_pos and window is not None and s_cache > window:
        start = torch.clamp(pos + 1 - window, 0, s_cache - window)
        idx = start + torch.arange(window, device=q.device)
        bufs = [t.index_select(1, idx) for t in bufs]
        cur, win_mask = pos + 1 - start, None
    kc, vc = bufs
    return L.decode_attention(q[:, 0], kc, vc, cur, sliding_window=win_mask,
                              logit_softcap=cap)


def _inputs(h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, h, d) * 2.0, f(B, hkv, d), f(B, hkv, d), f(B, S, hkv, d),
            f(B, S, hkv, d))


def _jax_rows(q, k, v, kc, vc, pos, window, cap):
    """The JAX reference's rotation, the rows written where pos < S, and
    its decode attention over the cache."""
    vec = np.ndim(pos) == 1
    pj = jnp.asarray(pos)
    positions = pj[:, None] if vec else pj.reshape(1, 1)
    qr = np.asarray(JL.apply_rope(jnp.asarray(q[:, None]), positions,
                                  THETA))[:, 0]
    kr = np.asarray(JL.apply_rope(jnp.asarray(k[:, None]), positions,
                                  THETA))[:, 0]
    kc, vc = kc.copy(), vc.copy()
    for i, p in enumerate(np.broadcast_to(pos, (B,))):
        if p < S:
            kc[i, p], vc[i, p] = kr[i], v[i]
    out = JL.decode_attention(jnp.asarray(qr), jnp.asarray(kc),
                              jnp.asarray(vc), pj + 1,
                              sliding_window=window, logit_softcap=cap)
    return np.asarray(out), kc, vc


@pytest.mark.parametrize("window,cap", [(None, None), (5, None),
                                        (None, 30.0)], ids=str)
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("h,hkv", [(4, 4), (6, 2), (8, 2)],
                         ids=["rep1", "rep3", "rep4"])
@pytest.mark.parametrize("pos_kind", list(POSITIONS))
def test_fused_plain_version(pos_kind, h, hkv, d, window, cap):
    q, k, v, kc, vc = _inputs(h, hkv, d, seed=d + 7 * h + hkv)
    pos = torch.tensor(POSITIONS[pos_kind])

    # bf16: the wrapper's CPU path equals the parent's op sequence.
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    caches = [t(kc), t(vc)]
    want_caches = [c.clone() for c in caches]
    want = _parent_ops(t(q)[:, None], t(k)[:, None], t(v)[:, None],
                       *want_caches, pos, THETA, window, cap)
    got = DA.decode_attention_fused(t(q), t(k), t(v), *caches, pos, THETA,
                                    sliding_window=window, logit_softcap=cap)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    for c, w in zip(caches, want_caches):
        assert torch.equal(c, w)

    # f32: the JAX reference over the same rows.
    caches = [torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())]
    got = DA.decode_attention_fused(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        *caches, pos, THETA, sliding_window=window, logit_softcap=cap)
    want, want_k, want_v = _jax_rows(q, k, v, kc, vc, POSITIONS[pos_kind],
                                     window, cap)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(caches[0].numpy(), want_k, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(caches[1].numpy(), want_v)


@pytest.mark.parametrize("dtype,device,ring,kv_dtype,want", [
    (torch.bfloat16, "cuda", False, None, "fused"),
    (torch.bfloat16, "cuda", True, None, "attend"),
    (torch.bfloat16, "cuda", False, "int8", "attend"),
    (torch.bfloat16, "cuda", True, "int8", "attend"),
    (torch.float32, "cuda", False, None, "plain"),
    (torch.float32, "cuda", True, "int8", "plain"),
    (torch.float16, "cuda", False, None, "plain"),
    (torch.bfloat16, "cpu", False, None, "plain"),
    (torch.bfloat16, "cpu", True, "int8", "plain"),
    (torch.float32, "cpu", False, None, "plain"),
], ids=lambda v: str(v).replace("torch.", ""))
def test_route(dtype, device, ring, kv_dtype, want):
    assert DA.route(dtype, torch.device(device), ring=ring,
                    kv_dtype=kv_dtype) == want


@pytest.mark.parametrize("shape,n_sm,want", [
    ((64, 1537, 16, 16), 132, (1, 256, 7)),      # qwen15-moe-a2.7b cell
    ((64, 1537, 32, 8), 132, (4, 256, 7)),       # jamba cell
    ((1, 4096, 8, 8), 132, (1, 64, 64)),         # one long sequence
    ((2, 200, 24, 2), 132, (8, 64, 4)),          # GQA 12: two groups of 8
    ((4, 100, 15, 5), 132, (4, 64, 2)),          # GQA 3
    ((8, 64, 16, 16), 132, (1, 64, 1)),          # one chunk: no merge
], ids=str)
def test_plan(shape, n_sm, want):
    DA_ops.plan.cache_clear()
    assert DA_ops.plan(*shape, n_sm) == want


def _args(**over):
    a = dict(q=torch.zeros(2, 4, 64, dtype=torch.bfloat16),
             k_cache=torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16),
             v_cache=torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16),
             pos=torch.zeros(2, dtype=torch.int64),
             k=torch.zeros(2, 2, 64, dtype=torch.bfloat16),
             v=torch.zeros(2, 2, 64, dtype=torch.bfloat16))
    a.update(over)
    return a


@pytest.mark.parametrize("over,msg", [
    ({}, None),
    ({"q": torch.zeros(2, 4, 64)}, "q must be bfloat16.*float32"),
    ({"k_cache": torch.zeros(2, 8, 2, 64), "v_cache": torch.zeros(2, 8, 2, 64)},
     "k_cache must be bfloat16.*float32"),
    ({"q": torch.zeros(2, 4, 48, dtype=torch.bfloat16),
      "k_cache": torch.zeros(2, 8, 2, 48, dtype=torch.bfloat16),
      "v_cache": torch.zeros(2, 8, 2, 48, dtype=torch.bfloat16)}, "head dim"),
    ({"q": torch.zeros(2, 3, 64, dtype=torch.bfloat16)}, "multiple"),
    ({"v_cache": torch.zeros(2, 9, 2, 64, dtype=torch.bfloat16)}, "v_cache"),
    ({"pos": torch.zeros(2, dtype=torch.float32)}, "positions"),
    ({"pos": torch.zeros(3, dtype=torch.int64)}, "positions"),
    ({"k": torch.zeros(2, 1, 64, dtype=torch.bfloat16)}, "must be"),
    ({"q": torch.zeros(2, 64, 4, dtype=torch.bfloat16).transpose(1, 2)},
     "contiguous False"),
    ({"sliding_window": 0}, "sliding_window"),
    ({"pos": torch.tensor(3, dtype=torch.int32)}, None),
], ids=lambda v: v if isinstance(v, str) else None)
def test_wrapper_refuses(over, msg):
    a = _args(**over)
    if msg is None:
        DA_ops.check_args(**a)
        return
    with pytest.raises(ValueError, match=msg):
        DA_ops.check_args(**a)


def test_attend_only_cpu_is_layers_decode_attention():
    q, _, _, kc, vc = _inputs(8, 2, 32, seed=3)
    cur = torch.tensor([5, 16, 1, 9])
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            cur)
    assert torch.equal(
        DA.decode_attention(*args, sliding_window=4, logit_softcap=30.0),
        L.decode_attention(*args, sliding_window=4, logit_softcap=30.0))
