"""The decode-attention kernel on the card (imports no JAX).

The kernel (``kernels/decode_attn/csrc/decode_attention.cu``) against the
plain route on the same card (``kernels/decode_attn/ref.py``: the ops the
model ran before the kernel), from the same bf16 inputs:

* at the benchmark cells' shapes, qwen15-moe-a2.7b (B=64, S=1537, 16/16
  heads of 128) and Jamba's attention (32/8), with each sequence's valid
  rows drawn over 1..S, S - 1 and S among them, and one idle slot at pos >=
  S; gemma-7b's head dim 256 with its soft-cap of 30; starcoder2-3b's
  window of 4096 (24/2: two query groups of 8, the second short); head dims
  64 and 32 (a cache of one chunk: no merge); a scalar position with a
  window; an int32 scalar position at gemma-7b's head dim (the launch
  layer's decode steps hold int32 positions); the attend-only route;
* the rows written equal the plain route's bit for bit (the rotation's
  products and sums are rounded one by one, as PyTorch's elementwise
  kernels round them); a row that differs would be cosf or sinf taking
  another path than PyTorch's, so the count of such values is printed and
  they are held within one bf16 ulp; every other row of the cache is
  untouched;
* the outputs within one bf16 ulp of the plain route's (both sum in f32,
  in another order; the rounding to bf16 can fall either side), or within
  1e-6 where the value is so near 0 that f32 rounding of its terms spans
  more than an ulp;
* one decode step of ``qwen15-moe-repro`` in bf16 at per-sequence
  positions through the model, on the fused route and on the attend-only
  route of a ring cache and of int8 KV: logits within 1e-4 of the plain
  route's and the next tokens equal;
* ``LAUNCHES`` counts 1-2 launches per attention layer per decode step on
  the cells' two configurations (qwen15-moe-a2.7b cut to 2 layers, Jamba to
  one period of 8 with its one attention layer; widths as published).

Needs a card:

    python -m pytest --noconftest -m gpu -s tests/test_torch_decode_attn_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels.decode_attn.ref import (decode_attention_fused_ref,
                                                 write_row)
from repro_torch.models import layers as L
from repro_torch.models import model as TM


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    return torch.device("cuda")


CASES = {
    "qwen15": dict(B=64, S=1537, H=16, Hkv=16, D=128, theta=1e6),
    "jamba8": dict(B=64, S=1537, H=32, Hkv=8, D=128, theta=1e4),
    "gemma7b": dict(B=8, S=2048, H=16, Hkv=16, D=256, theta=1e4, cap=30.0),
    "starcoder2": dict(B=8, S=5000, H=24, Hkv=2, D=128, theta=1e5,
                       window=4096),
    "smollm": dict(B=16, S=300, H=15, Hkv=5, D=64, theta=1e4),
    "repro": dict(B=4, S=40, H=8, Hkv=8, D=32, theta=1e4),
    "scalar_window": dict(B=4, S=700, H=8, Hkv=2, D=128, theta=1e4,
                          window=256, scalar=True),
    "gemma7b_int32_scalar": dict(B=2, S=4096, H=16, Hkv=16, D=256, theta=1e4,
                                 cap=30.0, scalar=True, int32=True),
}


def _positions(rng, B, S):
    pos = rng.integers(0, S, B)
    pos[:4] = [S - 1, S - 2, S + 5, 0][:B]    # kv lens S, S - 1; idle; 1
    return pos


def _data(c, seed):
    rng = np.random.default_rng(seed)
    B, S, H, Hkv, D = c["B"], c["S"], c["H"], c["Hkv"], c["D"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    pos = torch.tensor(_positions(rng, B, S), device="cuda")
    if c.get("scalar"):
        pos = torch.tensor(S // 2 + 17, device="cuda")
    if c.get("int32"):
        pos = pos.to(torch.int32)
    return (r(B, H, D, scale=2.0), r(B, Hkv, D), r(B, Hkv, D),
            r(B, S, Hkv, D), r(B, S, Hkv, D), pos)


def _ulps(a, b):
    """bf16 ulps between a and b, elementwise (int64)."""
    def key(t):
        u = t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - u, u)
    return (key(a) - key(b)).abs()


def _hold_out(got, want, what):
    ulps = _ulps(got, want)
    near0 = (got.float() - want.float()).abs() <= 1e-6
    bad = (ulps > 1) & ~near0
    print(f"[decode_attn] {what}: {int((ulps > 0).sum())} of {ulps.numel()} "
          f"values differ, max {int(ulps.max())} ulp, {int(bad.sum())} "
          "beyond one ulp")
    assert int(bad.sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_against_plain_route(cuda, name):
    c = CASES[name]
    q, k, v, kc, vc, pos = _data(c, seed=len(name))
    args = dict(sliding_window=c.get("window"), logit_softcap=c.get("cap"))
    kc0, vc0 = kc.clone(), vc.clone()
    want_k, want_v = kc.clone(), vc.clone()
    want = decode_attention_fused_ref(q, k, v, want_k, want_v, pos,
                                      c["theta"], **args)
    DA.LAUNCHES.reset()
    got = DA.decode_attention_fused(q, k, v, kc, vc, pos, c["theta"], **args)
    torch.cuda.synchronize()
    assert DA.LAUNCHES.count in (1, 2)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # Rows written: those of sequences at pos < S.
    written = torch.zeros(kc.shape[:2], dtype=torch.bool, device="cuda")
    pb = pos.expand(c["B"]) if pos.ndim == 0 else pos
    for b, p in enumerate(pb.tolist()):
        if p < c["S"]:
            written[b, p] = True
    for name_, got_c, want_c, old in (("k", kc, want_k, kc0),
                                      ("v", vc, want_v, vc0)):
        assert torch.equal(got_c[~written], old[~written])
        _hold_out(got_c[written], want_c[written], f"{name} {name_} rows")
    _hold_out(got, want, f"{name} output")


@pytest.mark.gpu
@pytest.mark.parametrize("ring", [False, True], ids=["window", "ring"])
def test_attend_only(cuda, ring):
    """Rows written by the plain ops, then the kernel attends alone (the
    ring's clipped count; a windowed count of the full cache)."""
    c = dict(B=8, S=512, H=32, Hkv=8, D=128)
    q, k, v, kc, vc, pos = _data(dict(c, theta=1e4), seed=5)
    pos = pos + (600 if ring else 0)
    bufs = [write_row(kc, k, pos, ring=ring), write_row(vc, v, pos,
                                                        ring=ring)]
    cur = torch.clamp(pos + 1, max=c["S"]) if ring else pos + 1
    window = None if ring else 100
    want = L.decode_attention(q, *bufs, cur, sliding_window=window)
    got = DA.decode_attention(q, *bufs, cur, sliding_window=window)
    _hold_out(got, want, f"attend-only {'ring' if ring else 'window'}")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [{}, {"ring_kv": True},
                                     {"kv_dtype": "int8"}],
                         ids=["fused", "ring", "int8"])
def test_repro_decode_step(cuda, monkeypatch, variant):
    """One bf16 decode step of ``qwen15-moe-repro`` through the model, on
    the kernel's route (fused; attend-only for the ring cache, whose slot
    at 45 wraps to row 5 of 40, and for int8 KV after its dequantization)
    against the plain route forced on the same card."""
    cfg = dataclasses.replace(get_config("qwen15-moe-repro"),
                              dtype="bfloat16", **variant)
    params = TM.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 12), generator=g,
                           device="cuda")
    _, cache, _ = TM.prefill(params, cfg, tokens, max_seq=40)
    cache["pos"] = torch.tensor([12, 7, 30, 45], device="cuda")
    nxt = torch.randint(0, cfg.vocab_size, (4,), generator=g, device="cuda")

    def step(route):
        c = {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in cache.items()}
        if route == "plain":
            monkeypatch.setattr(DA, "route", lambda *a, **kw: "plain")
        DA.LAUNCHES.reset()
        logits, new, _ = TM.decode_step(params, cfg, nxt, c)
        n = DA.LAUNCHES.count
        monkeypatch.undo()
        return logits.float(), new, n

    want, want_c, n_plain = step("plain")
    got, got_c, n_kernel = step("kernel")
    assert n_plain == 0 and n_kernel in (cfg.n_layers, 2 * cfg.n_layers)
    diff = float((got - want).abs().max())
    route = DA.route(torch.bfloat16, cuda, ring=cfg.ring_kv,
                     kv_dtype=cfg.kv_dtype)
    print(f"[decode_attn] qwen15-moe-repro bf16 decode step ({route} "
          f"route): logits max |diff| {diff:.3g}")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    for n, t in want_c["pos0"].items():
        if variant:     # the rows are written by the same plain ops
            assert torch.equal(got_c["pos0"][n], t), n
        else:
            _hold_out(got_c["pos0"][n], t, f"repro cache {n}")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n_layers,n_attn", [
    ("qwen15-moe-a2.7b", 2, 2),
    ("jamba-v0.1-52b", 8, 1),
])
def test_launches_per_step(cuda, arch, n_layers, n_attn):
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="bfloat16")
    params = TM.init_params(cfg, seed=0, device="cuda")
    cache = TM.init_cache(cfg, 64, 1537, device="cuda")
    cache["pos"] = torch.arange(64, device="cuda") * 24
    token = torch.zeros(64, dtype=torch.int64, device="cuda")
    DA.LAUNCHES.reset()
    TM.decode_step(params, cfg, token, cache)
    torch.cuda.synchronize()
    print(f"[decode_attn] {arch} at {n_layers} layers: "
          f"{DA.LAUNCHES.count} launches, {n_attn} attention layers")
    assert n_attn <= DA.LAUNCHES.count <= 2 * n_attn
    del params, cache
    torch.cuda.empty_cache()
