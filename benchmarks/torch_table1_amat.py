"""Paper Table 1 on the port: AMAT accuracy (PPL) across Base / Trunc /
AMAT schemes (the counterpart of ``benchmarks/table1_amat.py``; imports
no JAX).

For each eval model (DeepSeek-V2-Lite-repro, Qwen1.5-MoE-repro) and each
MAT(h,l) config, expert weights are replaced by dequantized variants:

  Base(b)   — independent b-bit quantization (quality reference),
  Trunc(l)  — naive truncation of the h-bit codes (no zp/scale fix),
  AMAT(l)   — joint code+zero-point truncation (the paper's scheme),

under symmetric and asymmetric group-32 quantization, and synthetic-data
perplexity is measured.  Expected orderings (the paper's claims):
AMAT(h) == Base(h); AMAT(l) ~ Base(l); Trunc(l) catastrophically worse.
The models are ``torch_common.train_or_load``'s; the CSV is
``results/bench/torch_table1_amat.csv``.

Run:  PYTHONPATH=src python benchmarks/torch_table1_amat.py [--quick]
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
import time  # noqa: E402

import torch  # noqa: E402

from benchmarks.torch_common import (CsvSink, eval_batches, report,  # noqa: E402
                                     synthetic_ppl, train_or_load)
from repro_torch.core.amat import PAPER_CONFIGS, truncate  # noqa: E402
from repro_torch.quant.groupquant import dequantize, quantize  # noqa: E402

MODELS = ("deepseek-v2-lite-repro", "qwen15-moe-repro")
HEADER = ["model", "quant", "scheme", "mat", "bits", "ppl"]


def _replace_experts(params, transform):
    """Apply ``transform(wi, wo) -> (wi', wo')`` to every MoE layer."""
    new_blocks = {}
    for pos, blk in params["blocks"].items():
        if "moe" in blk:
            blk = dict(blk)
            moe = dict(blk["moe"])
            e = moe["experts"]
            wi, wo = transform(e["wi"], e["wo"])
            moe["experts"] = {"wi": wi.to(e["wi"].dtype),
                              "wo": wo.to(e["wo"].dtype)}
            blk["moe"] = moe
        new_blocks[pos] = blk
    out = dict(params)
    out["blocks"] = new_blocks
    return out


@torch.no_grad()
def _scheme_weights(w, *, scheme: str, high: int, low: int, asym: bool,
                    group: int = 32):
    wf = w.to(torch.float32)
    if scheme == "base_high":
        return dequantize(quantize(wf, bits=high, group_size=group,
                                   asymmetric=asym))
    if scheme == "base_low":
        return dequantize(quantize(wf, bits=low, group_size=group,
                                   asymmetric=asym))
    qt = quantize(wf, bits=high, group_size=group, asymmetric=asym)
    if scheme == "trunc_low":
        return dequantize(truncate(qt, low_bits=low, truncate_zp=False,
                                   rescale=False))
    if scheme == "amat_low":
        return dequantize(truncate(qt, low_bits=low))
    if scheme == "amat_high":
        return dequantize(qt)
    raise ValueError(scheme)


def schemes_of(mat, asym: bool):
    """(scheme, bits) rows of one MAT config and quantization mode."""
    rows = [("base_high", mat.high_bits), ("base_low", mat.low_bits),
            ("trunc_low", mat.low_bits)]
    if asym:
        rows += [("amat_high", mat.high_bits), ("amat_low", mat.low_bits)]
    return rows


def scheme_params(params, scheme: str, mat, asym: bool):
    """``params`` with every expert weight replaced by its ``scheme``
    dequantization."""
    def tf(wi, wo):
        return tuple(_scheme_weights(w, scheme=scheme, high=mat.high_bits,
                                     low=mat.low_bits, asym=asym)
                     for w in (wi, wo))
    return _replace_experts(params, tf)


def table_rows(arch, cfg, params, batches, mats):
    """The table's rows for one model, PPL unrounded: the float model,
    then every MAT config x quantization mode x scheme."""
    rows = [(arch, "fp", "float", "-", "-",
             synthetic_ppl(params, cfg, batches))]
    for mat in mats:
        for asym in (False, True):
            for scheme, bits in schemes_of(mat, asym):
                ppl = synthetic_ppl(scheme_params(params, scheme, mat, asym),
                                    cfg, batches)
                rows.append((arch, "asym" if asym else "sym", scheme,
                             mat.name, bits, ppl))
    return rows


def main(quick: bool = False, device=None) -> None:
    sink = CsvSink("torch_table1_amat", HEADER)
    mats = PAPER_CONFIGS if not quick else PAPER_CONFIGS[-1:]
    models = MODELS if not quick else MODELS[:1]
    t0 = time.perf_counter()

    for arch in models:
        cfg, params = train_or_load(arch, device=device)
        batches = eval_batches(cfg, n_batches=2 if quick else 4)
        for *row, ppl in table_rows(arch, cfg, params, batches, mats):
            sink.add(*row, round(ppl, 4))

    path = sink.flush()
    us = (time.perf_counter() - t0) * 1e6
    # headline derived metric: AMAT-low vs naive-trunc PPL ratio (asym, MAT84)
    amat = [r for r in sink.rows if r[2] == "amat_low" and r[3] == "MAT84"]
    trunc = [r for r in sink.rows
             if r[2] == "trunc_low" and r[1] == "asym" and r[3] == "MAT84"]
    derived = "n/a"
    if amat and trunc:
        derived = f"trunc/amat_ppl_ratio={trunc[0][5] / amat[0][5]:.1f}"
    report("torch_table1_amat", us, derived + f";csv={path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one model, MAT84 only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(quick=args.quick, device=args.device)
