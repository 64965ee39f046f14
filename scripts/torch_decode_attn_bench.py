"""Time the decode-attention kernel at the shapes the port serves.

    python3 scripts/torch_decode_attn_bench.py [--out FILE]

On the card, one attention layer of a decode step at three shapes:
qwen15-moe-a2.7b's benchmark cell (B=64, S=1537, 16/16 heads of 128, each
sequence's valid rows drawn as the ``chat-c64`` closed loop holds them in
its steady state: a prompt plus the age of a length-biased answer, mean
about 404), Jamba's (32/8 heads) on the same rows, and gemma-7b's
``decode_32k`` of ``chip_smoke.py`` phase 16b (B=2, S=32768, 16/16 heads of
256, soft-cap 30, every row valid).  For each: ``ms``, CUDA events around
20 calls of the wrapper (host cost included); ``graph_ms``, the same 20
calls replayed from one CUDA graph (device time); ``bound_ms``, the valid
rows' K and V bytes at 3.35 TB/s; ``plain_ms``, the plain route
(``kernels/decode_attn/ref.py``, 5 calls); ``sdpa_ms``, PyTorch's
``scaled_dot_product_attention`` over the same cache and mask with the
rows written beforehand (no soft-cap), a yardstick the port never calls.
Then the attend-only route at Qwen's cell shape, for an int8 KV cache
(each sequence's valid rows as above) and for a full ring cache (every
row resident): ``ms``, the whole route (the plain rotation, the rows
written, int8's quantization and dequantization, then the kernel's
attention; CUDA events, 20 calls), against ``plain_ms``, the same route
with the plain attention (5 calls), and ``kernel_graph_ms``, the kernel's
attention alone from one CUDA graph.  Prints one JSON line per shape,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import decode_attn as DA  # noqa: E402
from repro_torch.kernels.decode_attn.ref import (  # noqa: E402
    Int8KV, decode_attention_fused_ref)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

HBM = 3.35e12
CALLS = 20


def chat_kv_lens(rng, n, s_max):
    """Valid rows of ``n`` slots of the chat-c64 loop in its steady state."""
    def lognormal(median, sigma, lo, hi, size):
        x = np.exp(np.log(median) + sigma * rng.standard_normal(size))
        return np.clip(np.round(x), lo, hi).astype(np.int64)

    answers = lognormal(286, 0.6, 16, 1024, 200_000)
    biased = rng.choice(answers, size=n, p=answers / answers.sum())
    age = np.floor(rng.random(n) * biased).astype(np.int64)
    prompt = lognormal(143, 0.5, 16, 512, n)
    return np.minimum(prompt + age + 1, s_max)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def events_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def graph_ms(fn, n=CALLS, replays=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return events_ms(g.replay, replays) / n


def shape(name, B, S, H, Hkv, D, kv_lens, theta, cap=None, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*sh):
        return torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = r(B, H, D), r(B, Hkv, D), r(B, Hkv, D)
    kc, vc = r(B, S, Hkv, D), r(B, S, Hkv, D)
    pos = torch.tensor(kv_lens - 1, device="cuda")
    kw = dict(logit_softcap=cap)

    def kernel():
        return DA.decode_attention_fused(q, k, v, kc, vc, pos, theta, **kw)

    def plain():
        return decode_attention_fused_ref(q, k, v, kc, vc, pos, theta, **kw)

    DA.LAUNCHES.reset()
    kernel()
    launches = DA.LAUNCHES.count
    mask = (torch.arange(S, device="cuda")[None, :]
            < torch.tensor(kv_lens, device="cuda")[:, None])[:, None, None]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, scale=D ** -0.5,
            enable_gqa=H != Hkv)

    rows = int(np.sum(kv_lens))
    kv_bytes = rows * Hkv * D * 2 * 2
    out = dict(shape=name, B=B, S=S, H=H, Hkv=Hkv, D=D,
               mean_rows=rows / B, launches_a_call=launches,
               ms=events_ms(kernel, CALLS), graph_ms=graph_ms(kernel),
               bound_ms=1e3 * kv_bytes / HBM, kv_bytes=kv_bytes,
               plain_ms=events_ms(plain, 5), sdpa_ms=events_ms(sdpa, 5),
               sdpa_graph_ms=graph_ms(sdpa))
    out["roofline_pct"] = 100.0 * out["bound_ms"] / out["graph_ms"]
    return out


def attend_only(name, B, S, H, Hkv, D, kv_lens, theta, *, ring, seed=0):
    """The attend-only route of a ring cache (``ring``) or of int8 KV."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*sh):
        return torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = r(B, H, D), r(B, Hkv, D), r(B, Hkv, D)
    kc, vc = r(B, S, Hkv, D), r(B, S, Hkv, D)
    pos = torch.tensor(kv_lens - 1, device="cuda")
    int8 = None
    if not ring:
        (kc, ks), (vc, vs) = TM._quant_kv(kc), TM._quant_kv(vc)
        int8 = Int8KV(ks, vs, TM._quant_kv,
                      functools.partial(TM._dequant_kv, dtype=torch.bfloat16))

    def route(attend):
        return lambda: decode_attention_fused_ref(
            q, k, v, kc, vc, pos, theta, ring=ring, int8=int8, attend=attend)

    kernel, plain = route(DA.decode_attention), route(L.decode_attention)
    DA.LAUNCHES.reset()
    kernel()
    launches = DA.LAUNCHES.count
    rows_k = TM._dequant_kv(kc, int8.k_scale, torch.bfloat16) if int8 \
        else kc
    rows_v = TM._dequant_kv(vc, int8.v_scale, torch.bfloat16) if int8 \
        else vc
    cur = torch.clamp(pos + 1, max=S)
    rows = int(cur.sum())
    kv_bytes = rows * Hkv * D * 2 * 2
    out = dict(shape=name, B=B, S=S, H=H, Hkv=Hkv, D=D,
               mean_rows=rows / B, launches_a_call=launches,
               ms=events_ms(kernel, CALLS),
               kernel_graph_ms=graph_ms(lambda: DA.decode_attention(
                   q, rows_k, rows_v, cur)),
               bound_ms=1e3 * kv_bytes / HBM, kv_bytes=kv_bytes,
               plain_ms=events_ms(plain, 5))
    out["roofline_pct"] = 100.0 * out["bound_ms"] / out["kernel_graph_ms"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    rng = np.random.default_rng(1234)
    lens = chat_kv_lens(rng, 64, 1537)
    rows = [shape("qwen15-decode-c64", 64, 1537, 16, 16, 128, lens, 1e6),
            shape("jamba8-decode-c64", 64, 1537, 32, 8, 128, lens, 1e4),
            shape("gemma-7b decode_32k", 2, 32768, 16, 16, 256,
                  np.full(2, 32768), 1e4, cap=30.0),
            attend_only("qwen15-decode-c64 int8 KV, attend-only", 64, 1537,
                        16, 16, 128, lens, 1e6, ring=False),
            attend_only("qwen15-decode-c64 full ring, attend-only", 64,
                        1537, 16, 16, 128, lens + 1537, 1e6, ring=True)]
    who = card()
    lines = [json.dumps(dict(r, card=who)) for r in rows]
    print("\n".join(lines))
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
