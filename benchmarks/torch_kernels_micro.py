"""Micro-benchmarks of the port's AMAT kernels beside their plain PyTorch
versions (the counterpart of ``benchmarks/kernels_micro.py``; imports no
JAX).

On the card each ``*_cuda`` row times a hand-written Hopper kernel through
its public wrapper: K3 ``amat_matmul_qt`` (one matrix, ``mode='low'``),
K4 ``expert_matmul_qt`` and K1 ``amat_expert_matmul_qt`` (the batched
expert kernel with a per-expert ``use_lsb``), all with f32 activations
(three exact bf16 planes on the tensor cores).  Each ``*_plain`` row times
the plain version in ``ref.py`` on the same inputs and device.  On the CPU
the wrappers run their plain versions themselves, so the kernel rows are
named ``*_wrapper_plain`` there.  K3 and K4 run on 8-bit codes at shift 4,
as the reference's rows do, and all three again at each of the paper's
MAT configurations.  Without ``--quick``, K1 also runs at each MAT on the
decode shape of ``qwen15-moe-a2.7b`` (E=60 experts, M=8 rows each,
K=2048, N=2816) with the bf16 activations of the serving path.

Two times per row: ``[wrapper_host]`` / ``*_host_us`` is the median host
wall per call, the card synchronized before and after each
(``torch_common.time_call``): what one caller sees, host cost included.
``[device]`` / ``kernel_us`` and ``plain_us`` is the device time per
call, 20 calls replayed in one CUDA graph between CUDA events
(``torch_common.device_time_us``); there is none off the card (``null``).
At the reference's small shapes the host time is the wrapper's own cost.

Also reports, per paper MAT config, the analytic HBM weight bytes moved by
one expert-FFN step under **dense dequantization** (read codes, write the
dense f32 tensor, read it back into the matmul) vs **quantized execution**
(stream packed codes straight into the fused kernel); at the full shape
(E=8, C=64, K=512, N=256) they equal the reference's
``results/BENCH_kernels_micro.json``.  MAT84's reduction must be at least
2x (asserted).  The JSON record is ``results/BENCH_torch_kernels_micro.json``
with the device it ran on; the CSV ``results/bench/torch_kernels_micro.csv``.

Run:  PYTHONPATH=src python benchmarks/torch_kernels_micro.py [--quick]
      [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import (CsvSink, device_time_us,  # noqa: E402
                                     json_record, report, time_call)
from repro_torch.core.amat import PAPER_CONFIGS, amat_quantize  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.hw.energy import expert_weight_step_bytes  # noqa: E402
from repro_torch.kernels.amat_matmul.ops import (amat_expert_matmul_qt,  # noqa: E402
                                                 amat_matmul_qt)
from repro_torch.kernels.amat_matmul.ref import (amat_batched_matmul_ref,  # noqa: E402
                                                 amat_matmul_ref)
from repro_torch.kernels.expert_matmul.ops import expert_matmul_qt  # noqa: E402
from repro_torch.kernels.expert_matmul.ref import expert_matmul_ref  # noqa: E402
from repro_torch.quant.groupquant import quantize  # noqa: E402

HEADER = ["kernel", "shape", "us_per_call"]
# qwen15-moe-a2.7b's decode shape of K1 (E, M, K, N): 60 experts, 8 rows
# each (4 sequences at top-4), d_model 2048, 2 x d_ff 2816.
DECODE_SHAPE = (60, 8, 2048, 2816)


def shapes(quick: bool):
    """(M, K, N) of the one-matrix rows and (E, C) of the batched rows."""
    return ((64, 256, 128), (4, 32)) if quick else ((128, 512, 256), (8, 64))


def analytic_bytes(E: int, K: int, N: int, mat) -> dict:
    """Weight bytes of one expert-FFN step over ``[E, K, N]`` codes,
    dense dequantization (f32) against quantized execution."""
    n_elems = float(E * K * N)
    n_groups = float(E * (K // mat.group_size) * N)
    dense_b = expert_weight_step_bytes(n_elems, n_groups,
                                       quant_execution=False,
                                       dense_itemsize=4)
    quant_b = expert_weight_step_bytes(n_elems, n_groups,
                                       quant_execution=True)
    return {"dense_dequant_bytes": dense_b, "quant_execution_bytes": quant_b,
            "reduction_x": dense_b / quant_b}


def inputs(M: int, K: int, N: int, E: int, C: int, dev):
    """Seed-0 inputs drawn with numpy: x [M, K], w [K, N] * 0.1,
    xe [E, C, K], we [E, K, N] * 0.1 (f32), and use_lsb on even experts."""
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)
                               * np.float32(scale), device=dev)

    x, w = t(M, K), t(K, N, scale=0.1)
    xe, we = t(E, C, K), t(E, K, N, scale=0.1)
    use_lsb = torch.arange(E, device=dev) % 2 == 0
    return x, w, xe, we, use_lsb


def device_info(dev) -> dict:
    """Where the run happened; on the card its name and power limit as
    ``nvidia-smi`` reports them."""
    if dev.type != "cuda":
        return {"type": dev.type}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.splitlines()[0]}


def decode_inputs(mat, dev):
    """K1's inputs at the decode shape, drawn on ``dev`` from seed 0 by an
    explicit generator: x [E, M, K] bf16, weights [E, K, N] * K**-0.5 (as
    the model draws them) quantized at ``mat``, use_lsb on even experts."""
    E, M, K, N = DECODE_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn((E, M, K), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5
    use_lsb = torch.arange(E, device=dev) % 2 == 0
    return x, amat_quantize(w, mat), use_lsb


def main(quick: bool = False, device=None) -> dict:
    t0 = time.perf_counter()
    dev = resolve_device(device)
    route = "cuda" if dev.type == "cuda" else "wrapper_plain"
    sink = CsvSink("torch_kernels_micro", HEADER)

    (M, K, N), (E, C) = shapes(quick)
    x, w, xe, we, ul = inputs(M, K, N, E, C, dev)
    mk, ek = f"{M}x{K}x{N}", f"{E}x{C}x{K}x{N}"
    qt = quantize(w, bits=8, group_size=32, asymmetric=True)
    qte = quantize(we, bits=8, group_size=32, asymmetric=True)

    def k3(q, shift):
        return (lambda: amat_matmul_qt(x, q, shift=shift, mode="low"),
                lambda: amat_matmul_ref(x, q.codes, q.scales, q.zero_points,
                                        group_size=32, shift=shift,
                                        mode="low"))

    def k4(q, shift):
        return (lambda: expert_matmul_qt(xe, q, ul, shift=shift),
                lambda: expert_matmul_ref(xe, q.codes, q.scales,
                                          q.zero_points, ul, group_size=32,
                                          shift=shift))

    def k1(xb, q, use_lsb, shift):
        return (lambda: amat_expert_matmul_qt(xb, q, use_lsb, shift=shift),
                lambda: amat_batched_matmul_ref(xb, q.codes, q.scales,
                                                q.zero_points, use_lsb,
                                                group_size=32, shift=shift))

    def timed(name, shape, fns, tag="", prefix=""):
        """Host and device times of a kernel and its plain version, as
        CSV rows and as ``{prefix}kernel_us`` ... entries."""
        kern, plain = fns
        t = {"kernel_us": device_time_us(kern, dev),
             "plain_us": device_time_us(plain, dev),
             "wrapper_host_us": time_call(kern),
             "plain_host_us": time_call(plain)}
        for key, row in (("wrapper_host_us", f"{name}_{route}{tag}"
                          "[wrapper_host]"),
                         ("plain_host_us", f"{name}_plain{tag}[host]"),
                         ("kernel_us", f"{name}_{route}{tag}[device]"),
                         ("plain_us", f"{name}_plain{tag}[device]")):
            if t[key] is not None:
                sink.add(row, shape, round(t[key], 3))
        return {prefix + k: v for k, v in t.items()}

    record = {
        "shape": {"M": M, "E": E, "C": C, "K": K, "N": N},
        "device": device_info(dev),
        "route": route,
        "timing": {
            "kernel_us, plain_us": "device time per call: 20 calls "
            "replayed in one CUDA graph between CUDA events (null off "
            "the card)",
            "*_host_us": "median host wall per call of 5, the card "
            "synchronized before and after each: what a caller sees",
        },
    }
    record.update(timed("amat_matmul", mk, k3(qt, 4), prefix="amat_matmul_"))
    record.update(timed("expert_matmul", ek, k4(qte, 4),
                        prefix="expert_matmul_"))

    bytes_rows = {}
    for mat in PAPER_CONFIGS:
        qtm = amat_quantize(we, mat)
        tag = f"[{mat.name}]"
        row = analytic_bytes(E, K, N, mat)
        row.update(timed("amat_batched", ek, k1(xe, qtm, ul, mat.shift), tag))
        row.update(timed("amat_matmul", mk, k3(amat_quantize(w, mat),
                                               mat.shift), tag,
                         prefix="amat_matmul_"))
        row.update(timed("expert_matmul", ek, k4(qtm, mat.shift), tag,
                         prefix="expert_matmul_"))
        if not quick:
            xd, qd, uld = decode_inputs(mat, dev)
            row["decode"] = {
                "shape": dict(zip("EMKN", DECODE_SHAPE)),
                "x_dtype": "bfloat16",
                **timed("amat_batched_decode",
                        "x".join(map(str, DECODE_SHAPE)),
                        k1(xd, qd, uld, mat.shift), tag)}
            del xd, qd, uld
        bytes_rows[mat.name] = row
        sink.add(f"weight_bytes_dense{tag}", ek,
                 round(row["dense_dequant_bytes"], 1))
        sink.add(f"weight_bytes_quant_exec{tag}", ek,
                 round(row["quant_execution_bytes"], 1))
    # The analytic traffic model's headline claim (a model of the two
    # execution paths, not a runtime measurement).
    assert bytes_rows["MAT84"]["reduction_x"] >= 2.0, bytes_rows["MAT84"]
    record["dense_vs_quant_execution"] = bytes_rows

    path = sink.flush()
    json_record("kernels_micro", record)
    us = (time.perf_counter() - t0) * 1e6
    mat84 = bytes_rows["MAT84"]
    key = "kernel_us" if dev.type == "cuda" else "wrapper_host_us"
    report("torch_kernels_micro", us,
           f"{key}:amat={record['amat_matmul_' + key]:.1f};"
           f"expert={record['expert_matmul_' + key]:.1f};"
           f"batched[MAT84]={mat84[key]:.1f};"
           f"mat84_bytes_reduction={mat84['reduction_x']:.1f}x;csv={path}")
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller shapes (E=4, C=32, K=256, N=128)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
