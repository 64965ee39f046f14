"""Time variants of the flash-attention kernel source against each other
on the card.

    python3 scripts/torch_flash_ab.py [VARIANT.cu ...] [--splits] [--rounds 2]

A variant is a copy of ``src/repro_torch/kernels/flash_attn/csrc/
flash_attention.cu`` with the same C entry, edited (keep it under
``build/``, which git ignores).  ``--splits`` adds three variants written
from the checkout's source under ``build/flash_ab/``, which differ only in
how the f32 kernel splits each operand into tf32 hi and lo
(:data:`SPLITS`).  The checkout's source runs first, as ``base``.  Every
source is built (one ``nvcc`` each, all started together), held against
the plain version (1e-4 + 1e-4*|plain|) on qwen15-moe-a2.7b's causal
attention (B=4, S=4096, 16 heads of 128) in f32 and bf16 and on small
ragged f32 cases at every head dim, and timed by ``graph_ms``
(``chip_smoke.py``'s timer: 20 calls in one CUDA graph) on the two
full-width rows.  The sources take turns, in order and then in reverse,
``--rounds`` times, so that a drift of the card's clock falls on all of
them alike.  Needs one card; prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels._build import build_library  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402


# The f32 kernel's split, in place of the checkout's ``split_tf32`` (hi
# rounded to nearest by integer instructions, lo = x - hi unrounded).
SPLITS = {
    # hi and lo by the conversion instruction
    "split_cvt": """
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
""",
    # lo rounded too, by the same two integer instructions as hi
    "split_rna_lo": """
  hi = hopper::tf32_rna(x);
  lo = hopper::tf32_rna(x - __uint_as_float(hi));
""",
    # hi by Veltkamp's split on the FP32 pipe (nearest, ties to even)
    "split_veltkamp": """
  const float t = __fmul_rn(x, 8193.0f);
  const float h = __fsub_rn(t, __fsub_rn(t, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
""",
}


def split_variants() -> list:
    """Write the :data:`SPLITS` variants of the checkout's source."""
    src = ops.SOURCE.read_text()
    include = '#include "hopper_mma.cuh"\n'
    assert src.count(include) == 1 and "split_tf32(" in src
    out_dir = ROOT / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, body in SPLITS.items():
        fn = ("namespace {\n__device__ __forceinline__ void split_v(float x, "
              "uint32_t& hi, uint32_t& lo) {" + body + "}\n}  // namespace\n")
        path = out_dir / f"{name}.cu"
        path.write_text(src.replace("split_tf32(", "split_v(")
                        .replace(include, include + fn))
        paths.append(path)
    return paths


def cases(cfg):
    """``(name, call, timed)`` of each row: ``call()`` runs the wrapper on
    the row's inputs and returns its output and the plain version's."""
    g = torch.Generator(device="cuda")
    g.manual_seed(500)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = [(f"qwen_causal_{str(dt)[6:]}", (4, 4096, 4096, hq, hkv, d),
             True, None, dt, True) for dt in (torch.float32, torch.bfloat16)]
    rows += [(f"small_f32_d{dd}", (1, 77, 93, 16, 2, dd), True, 33,
              torch.float32, False) for dd in (16, 32, 64, 128)]
    out = []
    for name, (b, sq, sk, h, hk, dd), causal, win, dt, timed in rows:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for shape in ((b, sq, h, dd), (b, sk, hk, dd),
                                 (b, sk, hk, dd)))

        def call(q=q, k=k, v=v, causal=causal, win=win):
            return ops.flash_attention(q, k, v, causal=causal,
                                       sliding_window=win)

        def check(call=call, q=q, k=k, v=v, causal=causal, win=win):
            return call(), flash_attention_ref(q, k, v, causal=causal,
                                               sliding_window=win)
        out.append((name, call, check, timed))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", type=pathlib.Path)
    ap.add_argument("--splits", action="store_true",
                    help="add the split variants of SPLITS")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(smoke.smi_name_power(), flush=True)
    variants = args.variants + (split_variants() if args.splits else [])
    if not variants:
        sys.exit("no variant to compare")
    sources = [ops.SOURCE, *variants]
    names = ["base", *(v.stem for v in variants)]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda s: build_library(s, force=True),
                              sources))
    for name, (_, log) in zip(names, built):
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[build] {name}: " + " | ".join(regs), flush=True)
    libs = [ops.bind(ctypes.CDLL(str(path))) for path, _ in built]
    rows = cases(get_config("qwen15-moe-a2.7b"))
    timed = [(r, call) for r, call, _, t in rows if t]
    times = {(n, r): [] for n in names for r, _ in timed}
    order = list(range(len(libs)))
    failed = False
    for turn in range(2 * args.rounds):
        for i in (order if turn % 2 == 0 else order[::-1]):
            ops.library = lambda lib=libs[i]: lib
            if turn == 0:
                for row, _, check, _ in rows:
                    got, want = check()
                    err = (got - want).abs()
                    ok = bool((err <= 1e-4 + 1e-4 * want.abs()).all())
                    failed |= not ok
                    print(f"[check] {names[i]} {row}: max|kernel-plain| "
                          f"{float(err.max()):.3e} {'ok' if ok else 'FAIL'}",
                          flush=True)
                    del got, want
            for row, call in timed:
                times[(names[i], row)].append(smoke.graph_ms(call, row))
            torch.cuda.empty_cache()
    for row, _ in timed:
        print(f"[ab] {row} graph_ms: " + "; ".join(
            f"{n} median {np.median(times[(n, row)]):.4f} "
            f"({', '.join(f'{t:.4f}' for t in times[(n, row)])})"
            for n in names), flush=True)
    if failed:
        sys.exit("a variant disagrees with the plain version")


if __name__ == "__main__":
    main()
