"""The absorbed-MLA decode kernel on the card (imports no JAX).

The kernel (``kernels/mla_decode/csrc/mla_decode.cu``) against its plain
route on the same card (``kernels/mla_decode/ref.py``), from the same bf16
inputs, the query tensors passed as the model passes them (``q_lat`` the
transposed [H, B, 512] output of the ``W_UK`` product, ``q_pe`` and the new
rope key strided views of their projections):

* at the ``dsv2lite-longkv-c32`` cell's shape: B = 32, S = 12,289, 16 heads,
  a latent of 512 and rope dims of 64 under DeepSeek-V2-Lite's YaRN, each
  sequence's valid rows drawn as the cell's closed loop holds them in its
  steady state (a prompt of the ``longkv-c32`` mix plus the age of a
  length-biased answer), 1, S - 1 and S rows and an idle slot at pos >= S
  among them; at B = 1 with 12,288 rows; a cache of one chunk (no merge);
  12 heads; an int32 scalar position;
* the rows written equal the plain route's bit for bit, every other row of
  the caches is untouched;
* the outputs within one bf16 ulp of the plain route's (both sum in f32, in
  another order), or within 1e-6 where the value is that near 0, or, where
  neither holds, no farther from the exact result (the plain route's
  arithmetic in float64 on the same inputs) than the plain route is, plus
  1e-6: a score sums 576 products, and its f32 rounding (the plain route's
  and the tensor cores' alike) moves each probability by about 1e-6 of
  itself, which an output summed to near 0 from terms of order 1 keeps as
  an absolute error (2 of 262,144 outputs at the cell's shape);
* 2 launches a call where the cache spans more than one chunk, so 2 a layer
  of a decode step: one bf16 decode step of a DeepSeek-shaped model at the
  published widths (the leading dense layer and one MoE layer of 8
  experts) gives 2 launches a layer and the plain route's logits within
  the rounding of bf16.

Needs a card:

    python -m pytest --noconftest -m gpu -s tests/test_torch_mla_decode_gpu.py
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import mla_decode as MD
from repro_torch.kernels.mla_decode import ref as MD_ref
from repro_torch.kernels.mla_decode.ref import mla_decode_fused_ref
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models.moe import MoECfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
MLA = get_config("deepseek-v2-lite").mla


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    return torch.device("cuda")


def cell_kv_lens(rng, n, s_max):
    """Valid rows of ``n`` slots of the ``longkv-c32`` loop in its steady
    state: a prompt plus the age of a length-biased answer."""
    with open(ROOT / "portbench" / "traffic" / "longkv-c32.json") as f:
        mix = json.load(f)

    def lognormal(d, size):
        x = np.exp(np.log(d["value"]) + d["sigma"]
                   * rng.standard_normal(size))
        return np.clip(np.round(x), d["min_len"], d["max_len"]).astype(
            np.int64)

    answers = lognormal(mix["output"], 200_000)
    biased = rng.choice(answers, size=n, p=answers / answers.sum())
    age = np.floor(rng.random(n) * biased).astype(np.int64)
    return np.minimum(lognormal(mix["prompt"], n) + age + 1, s_max)


CASES = {
    "dsv2lite_cell": dict(B=32, S=12289, H=16, cell=True),
    "b1_12288": dict(B=1, S=12288, H=16, pos=[12287]),
    "one_chunk": dict(B=3, S=40, H=16, pos=[0, 17, 39]),
    "heads_12": dict(B=8, S=700, H=12),
    "int32_scalar": dict(B=4, S=3000, H=16, scalar=True),
}


def _data(c, seed):
    rng = np.random.default_rng(seed)
    B, S, H = c["B"], c["S"], c["H"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    if c.get("cell"):
        lens = cell_kv_lens(rng, B, S)
        lens[:4] = [1, S - 1, S, S + 6]          # the last: an idle slot
        pos = torch.tensor(lens - 1, device="cuda")
    elif "pos" in c:
        pos = torch.tensor(c["pos"], device="cuda")
    elif c.get("scalar"):
        pos = torch.tensor(S // 2 + 17, dtype=torch.int32, device="cuda")
    else:
        pos = torch.tensor(rng.integers(0, S, B), device="cuda")
    q_lat = r(H, B, 512).transpose(0, 1)          # as the W_UK product
    q = r(B, H, 192)                              # the query projection
    c_all = r(B, 576)                             # the kv_a projection
    return (q_lat, q[..., 128:], r(B, 512), c_all[:, 512:], r(B, S, 512),
            r(B, S, 64), pos)


def _ulps(a, b):
    """bf16 ulps between a and b, elementwise (int64)."""
    def key(t):
        u = t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - u, u)
    return (key(a) - key(b)).abs()


def _exact(q_lat, q_pe, ckv, kpe, pos, freqs, rope_scale, scale):
    """The plain route's attention in float64 on the same inputs (the
    caches as written), q_pe rotated as the plain route rotates it."""
    q_pe = MD_ref.rope_at(q_pe, pos, freqs, rope_scale)
    f = torch.float64
    s = (torch.einsum("bhr,bsr->bhs", q_lat.to(f), ckv.to(f))
         + torch.einsum("bhe,bse->bhs", q_pe.to(f), kpe.to(f))) * scale
    cur = (pos.expand(ckv.shape[0]) if pos.ndim == 0 else pos) + 1
    valid = torch.arange(ckv.shape[1], device=ckv.device)[None] \
        < cur[:, None]
    s = s.masked_fill(~valid[:, None], float("-inf"))
    return torch.einsum("bhs,bsr->bhr", torch.softmax(s, -1), ckv.to(f))


def _hold_out(got, want, what, exact=None):
    ulps = _ulps(got, want)
    near0 = (got.float() - want.float()).abs() <= 1e-6
    bad = (ulps > 1) & ~near0
    if exact is not None and int(bad.sum()):
        err_got = (got.double() - exact).abs()
        err_want = (want.double() - exact).abs()
        print(f"[mla_decode] {what}: against float64, kernel "
              f"{err_got[bad].tolist()}, plain {err_want[bad].tolist()}")
        bad &= err_got > err_want + 1e-6
    print(f"[mla_decode] {what}: {int((ulps > 0).sum())} of {ulps.numel()} "
          f"values differ, max {int(ulps.max())} ulp, {int(bad.sum())} "
          "beyond one ulp")
    if int(bad.sum()):
        at = torch.nonzero(bad)[:8].tolist()
        print(f"[mla_decode] {what}: beyond one ulp at {at}: "
              f"{[float(got[tuple(i)]) for i in at]} against "
              f"{[float(want[tuple(i)]) for i in at]}")
    assert int(bad.sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_against_plain_route(cuda, name):
    c = CASES[name]
    q_lat, q_pe, ckv_new, kpe_new, ckv, kpe, pos = _data(c, len(name))
    freqs, rs = MD.frequencies(MLA, 1e4, cuda)
    kw = dict(scale=L.mla_softmax_scale(MLA), rope_scale=rs)
    old = ckv.clone(), kpe.clone()
    want_c = ckv.clone(), kpe.clone()
    want = mla_decode_fused_ref(q_lat, q_pe, ckv_new, kpe_new, *want_c,
                                pos, freqs, **kw)
    MD.LAUNCHES.reset()
    got = MD.mla_decode_fused(q_lat, q_pe, ckv_new, kpe_new, ckv, kpe, pos,
                              freqs, **kw)
    torch.cuda.synchronize()
    assert MD.LAUNCHES.count == (1 if c["S"] <= MD.ops.CHUNK else 2)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    written = torch.zeros(ckv.shape[:2], dtype=torch.bool, device="cuda")
    pb = pos.expand(c["B"]) if pos.ndim == 0 else pos
    for b, p in enumerate(pb.tolist()):
        if p < c["S"]:
            written[b, p] = True
    same = []
    for got_c, w_c, o in zip((ckv, kpe), want_c, old):
        same += [torch.equal(got_c[~written], o[~written]),
                 int((got_c[written] != w_c[written]).sum())]
    print(f"[mla_decode] {name}: {int(written.sum())} rows written; ckv "
          f"untouched elsewhere {same[0]}, values differing {same[1]}; kpe "
          f"untouched elsewhere {same[2]}, values differing {same[3]}")
    assert same == [True, 0, True, 0]
    _hold_out(got, want, f"{name} output",
              _exact(q_lat, q_pe, ckv, kpe, pos, freqs, rs, kw["scale"]))


def _small_model():
    """DeepSeek-V2-Lite's widths at two layers: the leading dense layer
    and one MoE layer of 8 experts, a vocabulary of 1024."""
    cfg = get_config("deepseek-v2-lite")
    return dataclasses.replace(
        cfg, n_layers=2, vocab_size=1024,
        moe=MoECfg(n_experts=8, top_k=6, d_ff=1408, n_shared_experts=2,
                   d_ff_shared=2816, capacity_factor=2.0))


@pytest.mark.gpu
def test_decode_step_on_the_kernel(cuda, monkeypatch):
    cfg = _small_model()
    params = TM.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    B, S = 32, 1300
    tokens = torch.randint(0, cfg.vocab_size, (B, 40), generator=g,
                           device="cuda")
    _, cache, _ = TM.prefill(params, cfg, tokens, max_seq=S)
    cache["pos"] = torch.tensor(
        np.random.default_rng(3).integers(40, S - 1, B), device="cuda")
    nxt = torch.randint(0, cfg.vocab_size, (B,), generator=g, device="cuda")

    def step(route):
        c = {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in cache.items()}
        if route == "plain":
            monkeypatch.setattr(MD, "route", lambda *a, **kw: "plain")
        MD.LAUNCHES.reset()
        logits, new, _ = TM.decode_step(params, cfg, nxt, c)
        torch.cuda.synchronize()
        n = MD.LAUNCHES.count
        monkeypatch.undo()
        return logits.float(), new, n

    want, want_c, n_plain = step("plain")
    got, got_c, n_kernel = step("kernel")
    print(f"[mla_decode] deepseek-v2-lite at 2 layers, B={B}: {n_kernel} "
          f"launches a step; logits max |diff| "
          f"{float((got - want).abs().max()):.3g} of max "
          f"{float(want.abs().max()):.3g}")
    assert n_plain == 0 and n_kernel == 2 * cfg.n_layers
    # The leading layer's rows come from the same inputs on both routes;
    # the next layer's from the leading layer's outputs, which differ by
    # an ulp here and there.
    for n, t in want_c["lead"].items():
        assert torch.equal(got_c["lead"][n], t), n
    for n, t in want_c["pos0"].items():
        torch.testing.assert_close(got_c["pos0"][n].float(), t.float(),
                                   atol=0.05, rtol=0.02)
    # bf16 logits: the kernel's outputs differ from the plain route's by at
    # most one bf16 ulp, which the later layers carry on.
    torch.testing.assert_close(got, want, atol=0.05, rtol=0.02)
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.9
