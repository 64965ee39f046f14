"""Time the absorbed-MLA decode kernel at the shapes the port serves.

    python3 scripts/torch_mla_decode_bench.py [--out FILE]

On the card, the attention of one multi-head latent attention layer of a
decode step (DeepSeek-V2-Lite: 16 heads, a latent of 512 and rope dims of
64) at two shapes: the ``dsv2lite-longkv-c32`` cell's (B = 32, S = 12,289,
each sequence's valid rows drawn as the cell's closed loop holds them in
its steady state: a prompt of the ``longkv-c32`` mix plus the age of a
length-biased answer, mean about 5,000) and one sequence of 12,288 rows.
For each: ``ms``, CUDA events around 20 calls of the wrapper (host cost
included); ``graph_ms``, the same 20 calls replayed from one CUDA graph
(device time); ``bound_ms``, the larger of the valid rows' latent and rope
bytes (1,152 a row) at 3.35 TB/s and their operations (2 x 16 x (576 +
512) a row) at 989 TFLOP/s; ``roofline_pct``, ``bound_ms`` over
``graph_ms``; ``plain_ms``, the plain route (``kernels/mla_decode/ref.py``,
5 calls); and ``graph_ms`` at chunks of 64 to 512 rows, the kernel's
``CHUNK`` among them.  Prints one JSON line per shape, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import mla_decode as MD  # noqa: E402
from repro_torch.kernels.mla_decode import ops as MD_ops  # noqa: E402
from repro_torch.kernels.mla_decode.ref import (  # noqa: E402
    mla_decode_fused_ref)
from repro_torch.models import layers as L  # noqa: E402

HBM = 3.35e12
PEAK = 989e12
CALLS = 20
ROW_BYTES = (512 + 64) * 2
ROW_FLOPS = 2 * 16 * (576 + 512)


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


def shape(name, B, S, kv_lens, seed=0):
    mla = get_config("deepseek-v2-lite").mla
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*sh):
        return torch.randn(sh, generator=g, device="cuda").to(torch.bfloat16)

    H = 16
    q_lat = r(H, B, 512).transpose(0, 1)
    q_pe = r(B, H, 192)[..., 128:]
    ckv_new, kpe_new = r(B, 512), r(B, 576)[:, 512:]
    ckv, kpe = r(B, S, 512), r(B, S, 64)
    pos = torch.tensor(kv_lens - 1, device="cuda")
    freqs, rs = MD.frequencies(mla, 1e4, torch.device("cuda", 0))
    kw = dict(scale=L.mla_softmax_scale(mla), rope_scale=rs)
    args = (q_lat, q_pe, ckv_new, kpe_new, ckv, kpe, pos, freqs)

    def kernel():
        return MD.mla_decode_fused(*args, **kw)

    def plain():
        return mla_decode_fused_ref(*args, **kw)

    MD.LAUNCHES.reset()
    kernel()
    launches = MD.LAUNCHES.count
    rows = int(np.sum(kv_lens))
    bound_s = max(rows * ROW_BYTES / HBM, rows * ROW_FLOPS / PEAK)
    out = dict(shape=name, B=B, S=S, H=H, mean_rows=rows / B,
               launches_a_call=launches, chunk=MD_ops.CHUNK,
               ms=events_ms(kernel, CALLS), graph_ms=graph_ms(kernel),
               bound_ms=1e3 * bound_s, latent_bytes=rows * ROW_BYTES,
               plain_ms=events_ms(plain, 5))
    out["roofline_pct"] = 100.0 * out["bound_ms"] / out["graph_ms"]
    sweep = {}
    chunk = MD_ops.CHUNK
    try:
        for c in (64, 128, 256, 512):
            MD_ops.CHUNK = c
            sweep[c] = graph_ms(kernel)
    finally:
        MD_ops.CHUNK = chunk
    out["chunk_graph_ms"] = sweep
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    rng = np.random.default_rng(1234)
    rows = [shape("dsv2lite-longkv-c32", 32, 12289,
                  cell_kv_lens(rng, 32, 12289)),
            shape("one sequence of 12288 rows", 1, 12288,
                  np.array([12288]))]
    who = card()
    for row in rows:
        row["card"] = who
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
