"""Time variants of the AMAT kernel source against each other on the card.

    python3 scripts/torch_amat_ab.py VARIANT.cu [VARIANT.cu ...] [--rounds 2]

A variant is a copy of ``src/repro_torch/kernels/amat_matmul/csrc/
amat_batched_matmul.cu`` with the same C entries, edited (keep it under
``build/``, which git ignores).  The checkout's source runs first, as
``base``.  Every source is built (one ``nvcc`` each, all started
together), held against the plain version (1e-4 + 1e-4*|plain|) and timed
by ``graph_ms`` (``chip_smoke.py``'s timer: 20 calls in one CUDA graph) on
the rows the kernels serve at qwen15-moe-a2.7b's widths: K1 ``wi`` and
K2 ``wo`` at the decode capacity (E=60, M=8) with bf16 x and with f32 x
(the three-plane route), and K3 at M=128 and M=1 with bf16 x and at M=128
with f32 x (rotating over 10 quantized copies, as ``chip_smoke.py``
does).  The sources take turns, in order and then in reverse,
``--rounds`` times, so that a drift of the card's clock falls on all of
them alike.  Needs one card; prints the card's name and power limit
first, then each source's ptxas registers and spills by kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.amat import MatConfig, amat_quantize  # noqa: E402
from repro_torch.kernels._build import build_library  # noqa: E402
from repro_torch.kernels.amat_matmul import ops  # noqa: E402
from repro_torch.kernels.amat_matmul.ref import (  # noqa: E402
    amat_batched_matmul_ref, amat_batched_matmul_t_ref, amat_matmul_ref)
from repro_torch.models.moe import capacity  # noqa: E402


def cases(cfg):
    """``(name, timed kernel call, check)`` of each row; ``check()``
    returns the kernel's and the plain version's outputs on one input."""
    m = cfg.moe
    E, C = m.n_experts, capacity(4, m.top_k, m.n_experts, m.capacity_factor)
    out = []
    wi, wo = (cfg.d_model, 2 * m.d_ff), (m.d_ff, cfg.d_model)
    for seed, (name, transposed, (K, N), xd) in enumerate((
            ("wi_bf16_decode", False, wi, torch.bfloat16),
            ("wo_t_bf16_decode", True, wo, torch.bfloat16),
            ("wi_f32_decode", False, wi, torch.float32),
            ("wo_t_f32_decode", True, wo, torch.float32))):
        args = smoke._kernel_inputs(E, C, K, N, seed=seed,
                                    transposed=transposed, x_dtype=xd)
        ref = amat_batched_matmul_t_ref if transposed \
            else amat_batched_matmul_ref
        kern = (lambda a=args, t=transposed:
                ops.amat_expert_matmul(*a, transposed=t))
        out.append((name, kern, lambda k=kern, a=args, r=ref: (k(), r(*a))))
    g = torch.Generator(device="cuda")
    g.manual_seed(100)
    K, N = cfg.d_model, 2 * m.d_ff
    qts = [amat_quantize(torch.randn((K, N), generator=g, device="cuda")
                         * K ** -0.5, MatConfig(8, 4)) for _ in range(10)]
    for name, M, mode, shift, xd in (
            ("k3_prefill_high", 128, "high", 0, torch.bfloat16),
            ("k3_decode_low4", 1, "low", 4, torch.bfloat16),
            ("k3_prefill_high_f32", 128, "high", 0, torch.float32)):
        x = torch.randn((M, K), generator=g, device="cuda").to(xd)

        def kern(qt, x=x, mode=mode, shift=shift):
            return ops.amat_matmul_qt(x, qt, shift=shift, mode=mode)

        def check(kern=kern, x=x, mode=mode, shift=shift, qt=qts[0]):
            return kern(qt), amat_matmul_ref(
                x, qt.codes, qt.scales, qt.zero_points, shift=shift,
                mode=mode)
        out.append((name, smoke._rotating(kern, qts), check))
    return out


def demangled_kernel(line: str) -> str:
    """``name<template args>`` of the kernel whose mangled name ``line``
    holds: the length-prefixed identifier that ends in ``_kernel``, and
    the integer and bool arguments after it."""
    for m in re.finditer(r"\d+", line):
        digits = m.group()
        for i in range(len(digits)):
            name = line[m.end():m.end() + int(digits[i:])]
            if name.endswith("_kernel") and name.isidentifier():
                rest = line[m.end() + len(name):]
                t = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
                args = re.findall(r"L[a-z](\d+)E", t.group(1)) if t else []
                return name + (f"<{', '.join(args)}>" if args else "")
    return line.strip()


def ptxas_summary(log: str):
    """``kernel<template args>: registers, spills`` for each entry that
    the ptxas report of ``log`` lists."""
    out, entry, spill = [], None, []
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry, spill = demangled_kernel(line), ["0", "0"]
        elif entry and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
        elif entry and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{entry}: {regs} registers, spill "
                       f"{'/'.join(spill)} bytes")
            entry = None
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(smoke.smi_name_power(), flush=True)
    sources = [ops.SOURCE, *args.variants]
    names = ["base", *(v.stem for v in args.variants)]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda s: build_library(s, force=True),
                              sources))
    for name, (_, log) in zip(names, built):
        for line in ptxas_summary(log):
            print(f"[ptxas] {name} {line}", flush=True)
    libs = [ops.bind(ctypes.CDLL(str(path))) for path, _ in built]
    rows = cases(get_config("qwen15-moe-a2.7b"))
    times = {(n, r): [] for n in names for r, _, _ in rows}
    order = list(range(len(libs)))
    for turn in range(2 * args.rounds):
        for i in (order if turn % 2 == 0 else order[::-1]):
            ops.library = lambda lib=libs[i]: lib
            for row, kern, check in rows:
                if turn == 0:
                    got, want = check()
                    err = (got - want).abs()
                    ok = bool((err <= 1e-4 + 1e-4 * want.abs()).all())
                    print(f"[check] {names[i]} {row}: max|kernel-plain| "
                          f"{float(err.max()):.3e} {'ok' if ok else 'FAIL'}",
                          flush=True)
                times[(names[i], row)].append(smoke.graph_ms(kern, row))
    for row, _, _ in rows:
        print(f"[ab] {row} graph_ms: " + "; ".join(
            f"{n} median {np.median(times[(n, row)]):.4f} "
            f"({', '.join(f'{t:.4f}' for t in times[(n, row)])})"
            for n in names), flush=True)


if __name__ == "__main__":
    main()
