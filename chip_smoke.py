"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and ``nvcc``; builds
every kernel from the sources in this checkout.  Phases, each printing as
it goes, any failure exiting non-zero:

1. device: the card's name, count and power limit;
2. build: every kernel source, one ``nvcc`` each, all started together,
   with the ptxas register / shared-memory / spill report and the kernels
   that spill;
3. the batched AMAT kernels (K1 ``wi``, K2 ``wo``) against their plain
   PyTorch versions on the card (tolerance 1e-4 + 1e-4*|plain|: f32
   accumulation in another order): both code layouts with the bf16
   activations the main path gives them at its decode (4 sequences) and
   prefill (128 tokens) capacities and at phase 7c's long-prefill
   capacity (9216 tokens: 1229 rows, ten row blocks with a ragged last),
   with f32 activations (the engine's parity mode: three exact bf16
   planes of x) at the decode and prefill capacities, and ragged cases in both types (N = 72, and N = 70 for
   bf16, which the wrapper pads); every route runs on the tensor cores.
   The decode shapes are then timed beside the plain version, one
   ``torch.bmm`` on pre-dequantized f32 weights (the nearest library
   call; it reads dense f32 weights, not the packed codes) and the card's
   bound.  Every timed row gives ``ms`` (CUDA events around 20 calls: what
   a caller of the wrapper sees, host cost included) and, for the kernel
   and the library call, ``graph_ms`` (the same 20 calls captured in one
   CUDA graph and replayed: device time); ``[versus]`` lines set each
   decode row's ``graph_ms`` beside the library call's, and each bf16 row
   beside the f32 row of the same run and against its bound.  The
   kernels line reports the bf16 decode variant, the one the decode steps
   launch, and the f32 decode variant as rows of their own;
3b. the slice's kernels against their plain versions at the same
   tolerance, at the widths of configs in the repo: K3 ``amat_matmul``
   (one qwen15-moe-a2.7b expert matrix), K4 ``expert_matmul`` (K1's
   shapes) and K5 ``flash_attention`` (qwen15-moe-a2.7b's causal
   attention, llama4-scout-17b-a16e's windowed GQA attention), each with
   a ragged or small case, K3-K5 with bf16 and f32 inputs (all on the
   tensor cores: f32 K3 and K4 as three exact bf16 planes, f32 K5 in
   3xTF32); timed rows beside the plain version, one library call
   (``torch.matmul`` / ``torch.bmm`` on dense f32 weights,
   ``scaled_dot_product_attention``) and the card's bound, and for the
   K3 and K5 rows a ``[versus]`` line comparing ``graph_ms`` with the
   library call's;
   Then a sweep of K3's K split: ``graph_ms`` of the tensor-core kernel
   with bf16 x at M = 1, 16, 64 and 128 and with f32 x at M = 1 and 128,
   for each split count, the plan's choice marked (the evidence for
   ``mma_plan``);
3c. the slice's path: the public entry points of K3-K5 driven once each
   at those full widths, with the launch counts set to 0 just before and
   read just after; every kernel must have launched and every output be
   finite;
3d. the f32 path: the public entry points of K3 and K5 driven once each
   with f32 inputs at the same widths (the three-plane and 3xTF32
   kernels), counted the same way;
4. a small reference check: the qwen15-moe-repro model (2 layers, f32)
   served on the card through the kernel (K1/K2 on three bf16 planes of
   x) and on the CPU through the plain dense-dequant path must agree
   (tokens exact, logits 1e-4, cache stats equal), with the launch counts
   set to 0 just before and read just after: K1 and K2 must have
   launched.  Then the same with the int8 KV cache (``kv_dtype="int8"``),
   the card's prefill and its decode each counted on their own (K1 and
   K2 must launch in both): prefill logits at 1e-4 and the two devices' caches compared code by
   code; the card decodes from the CPU's cache, carried across (a value
   within an f32 ulp of a rounding tie may take either code), and each
   of 6 steps' logits must agree at 1e-4, tokens and cache stats
   exactly;
5. serving at full width: Qwen1.5-MoE-A2.7B (24 layers, d_model 2048,
   60 experts, bf16, random weights from seed 0), cache-prior + DBSC
   routing with quantized execution, 4 requests of 128 prompt tokens and
   16 new tokens through the continuous-batching scheduler; the kernel's
   launch count must be 2 x 24 x (prefills + decode steps) and every
   logit finite.  The run is recorded (``repro_torch.sim.TraceRecorder``);
   the trace, written to ``build/`` and read back, must equal the record
   and replay (``repro_torch.sim.replay_trace``) to the live run: epoch
   counts, decode accesses and misses and the miss curve exactly, the
   ledger at rtol 1e-6.  Replayed on the async timeline, the same trace
   must keep the energy (rtol 1e-6) and not raise the latency (``[replay]``
   lines, cost model);
5b. the same traffic over the same params on the async slice-I/O timeline
   with request-level prefetch (``prefetch_top_m=4``, lookahead 2, score
   floor 0.02, PCW warmup): K1 and K2 launched 24 x (4 + 16) times each,
   every logit finite, every request served in full, and its recorded
   trace replaying to the live run with the prefetch summary exact
   (``[serve-async]`` lines);
6. train, checkpoint, serve (after 5b's params are released):
   Qwen1.5-MoE-A2.7B at its published widths with its depth cut to 2 of
   24 layers (training holds 16 B per parameter: 1.76 B parameters, 28
   GB, where 24 layers would need 229 GB), bf16 from the port's init
   with seed 0, trained for 40 steps with ``train_or_load``'s settings
   (batch 8, seq 64, lr 2e-3, cosine, warmup 4) on ``SyntheticLM``
   (``[train]`` lines: every loss, the wall per step, the peak memory;
   every loss finite and the last below the first and ln(vocab)); the
   weights saved with the port's checkpoint writer under ``build/`` and
   restored onto the card bit for bit (``[ckpt]``); the restored model
   served with phase 5's traffic shape (4 prompts of 128 tokens from
   ``eval_batches``, 16 new tokens each) under Fig. 9's
   ``buddy_highbit`` and under phase 5's Cache-Prior + DBSC + PCW, both
   with quantized execution, each run with the launch counts reset just
   before and read just after (K1 and K2 2 x (4 + 16) = 40 times each);
   the same model at its untrained init served beside it, for the
   ``[serve-6]`` lines' decode miss rates and modeled energy and
   latency (descriptive, cost model).

7. expert parallelism, the SLO controller, int8 KV and blockwise
   attention at full width, over phase 5's params after 5b (each
   engine released before the next is built; phase 6 runs last), every
   serving run with K1 and K2 launched once per MoE layer per forward:
   7a. phase 5's traffic with ``ep_shards=4`` (simulated in the charge
       path on this one card), hotness placement re-packed every 4
       decode steps and the 2 hottest (layer, expert) pairs replicated
       (``[ep]`` lines: per-shard counts, all-to-all and migration
       bytes, ``placement_summary()``); its recorded trace must replay to
       the live run, per-shard epoch counts, migrations and placement
       exactly; at least one migration and some all-to-all traffic;
   7b. the same traffic from two tenants in turn with the int8 KV cache
       and the SLO controller (two tenant SLOs, a partitioned cache):
       the controller's actions and summary, per-tenant miss rates and
       low-bit shares, the KV cache's bytes ((head_dim + 4) / (2
       head_dim) of bf16's) (``[ctl-int8]``); the trace's replay must
       reproduce the live epoch counts and miss curve exactly, the
       energy curve at rtol 1e-6 and the controller's summary;
   7c. one request of 9216 prompt tokens (above the 8192-key threshold:
       every layer's prefill attention runs blockwise) with the int8 KV
       cache, then 4 decode steps; before it, layer 0's q/k/v of that
       prompt in f32 through ``blockwise_attention`` and the dense body
       on the card, which must agree at 1e-4 + 1e-4*|dense|
       (``[long]``: both times, the prefill's wall, peak memory).

``--profile`` adds a phase run between 5 and 5b: a second round of the
same traffic with its decode steps under ``torch.profiler`` (device time
and launches per step by kernel, the engine's host ranges, the device's
busy share).  Without arguments the script runs phases 1 to 7.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' JSON record (K1-K5, and the f32 routes of K1, K2, K3
and K5 as rows of their own; ``launches`` counts phase 5's run for K1 and
K2, phase 3c's for K3-K5, phase 3d's for the f32 rows of K3 and K5 and
phase 4's bf16-KV run for the f32 rows of K1 and K2; ``graph_ms`` and
``library_graph_ms`` beside ``ms`` and ``library_ms``).
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Card peaks (NVIDIA H100 SXM data sheet, dense) for the bound of each
# kernel: HBM3, and operations by the type of their operands: bf16 and
# tf32 on the tensor cores (a bf16 x bf16 or tf32 x tf32 product is exact
# in an f32 accumulator), f32 on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}

TOL_ABS, TOL_REL = 1e-4, 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, what: str, *, warmup: int = 3, iters: int = 20) -> float:
    """The same ``iters`` calls as :func:`time_ms`, after warm-up on a side
    stream, captured once in a CUDA graph and replayed between CUDA events:
    device time without the host's launch gaps.  A capture that the
    default mode refuses is said and retried in the relaxed mode; raises
    ``RuntimeError`` if neither takes it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for mode in ("global", "relaxed"):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode=mode):
                for _ in range(iters):
                    fn()
        except RuntimeError as e:
            say(f"[graph] {what}: capture in mode {mode!r} refused: {e}")
            torch.cuda.synchronize()
            continue
        graph.replay()                  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / iters
    raise RuntimeError(f"{what}: no CUDA graph could be captured")


# --------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_name_power()
    say(f"[device] {name} x{count}; nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    """Every kernel source, one ``nvcc`` each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels._build import build_library
    from repro_torch.kernels.amat_matmul.ops import SOURCE as AMAT_SOURCE
    from repro_torch.kernels.flash_attn.ops import SOURCE as FLASH_SOURCE

    def build(source):
        t0 = time.perf_counter()
        lib, log = build_library(source, force=True)
        return lib, log, time.perf_counter() - t0

    sources = (AMAT_SOURCE, FLASH_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build, sources))
    spills = []
    for source, (lib, log, dt) in zip(sources, built):
        say(f"[build] {os.path.relpath(source, HERE)} -> "
            f"{os.path.relpath(lib, HERE)} in {dt:.1f} s")
        entry = None
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                say("[build]   " + line.strip())
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "spill" in line and any(
                    int(w) for w in line.split() if w.isdigit()):
                spills.append(entry)
    say(f"[build] kernels that spill: {spills or 'none'}")


def _kernel_inputs(E, M, K, N, *, seed, transposed, x_dtype):
    """Weights drawn as the model draws them and AMAT-quantized on the
    card; a seeded mixed use_lsb; activations in ``x_dtype``."""
    from repro_torch.core.amat import MatConfig, amat_quantize

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((E, M, K), generator=g, device="cuda").to(x_dtype)
    w = torch.randn((E, K, N), generator=g, device="cuda") * K ** -0.5
    qt = amat_quantize(w, MatConfig(8, 4))
    del w
    codes = qt.codes.transpose(1, 2).contiguous() if transposed else qt.codes
    use_lsb = torch.rand((E,), generator=g, device="cuda") < 0.5
    use_lsb[0], use_lsb[-1] = True, False
    return x, codes, qt.scales, qt.zero_points, use_lsb


def _bound(nbytes: float, flops: dict):
    """The least time the card could take: the largest of the bytes over
    HBM3's rate and, for each operand type, its operations (``flops``,
    by key of :data:`PEAK_FLOPS`) over the card's peak for that type.
    The tensor cores and the CUDA cores run side by side, so the types'
    times do not add."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_FLOPS[kind] * 1e3 for kind, n in flops.items())
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _amat_flops(x_dtype, n: float) -> dict:
    """The operations of an AMAT dequant-matmul by operand type.  Its
    weights are integers of at most 8 bits, exact in bf16, times one
    scale per 32-row group, which can be applied after the group's
    product: with bf16 activations the whole product is bf16 work, and
    f32 activations split exactly into three bf16 planes, so their
    product is three times that bf16 work."""
    return {"bf16": n if x_dtype == torch.bfloat16 else 3 * n}


def _visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the attention mask lets through, per sequence
    and head: the work this input needs."""
    q = np.arange(sq, dtype=np.int64)
    last = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    first = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(last - first + 1, 0, None).sum())


def _rotating(fn, items):
    """A call of ``fn`` on the next of ``items`` each time, in turn."""
    it = itertools.cycle(items)
    return lambda: fn(next(it))


def _check_row(name, got, want, shape) -> float:
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(shape) or not bool(torch.isfinite(got).all()):
        fail(f"kernel {name}: bad output {tuple(got.shape)}")
    err = (got - want).abs()
    max_err = float(err.max())
    ok = bool((err <= TOL_ABS + TOL_REL * want.abs()).all())
    say(f"[kernel] {name}: max|kernel-plain| = {max_err:.3e} "
        f"(tol 1e-4 + 1e-4*|plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"kernel {name} disagrees with its plain version")
    return max_err


def _timed(name, kern, plain, library, library_what, nbytes, flops, note):
    t = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
         "library_ms": None, "library_graph_ms": None}
    try:
        t["graph_ms"] = graph_ms(kern, name)
    except RuntimeError as e:
        fail(str(e))
    try:
        t["library_ms"] = time_ms(library)
        t["library_graph_ms"] = graph_ms(library, f"{name} library call")
    except RuntimeError as e:       # out of memory, or no backend for it
        say(f"[kernel] {name}: library call {library_what} not timed: {e}")
    t["bound_ms"], t["bound_by"] = _bound(nbytes, flops)
    lib = ", ".join(f"{k} {'null' if t[k] is None else f'{t[k]:.4f}'}"
                    for k in ("library_ms", "library_graph_ms"))
    say(f"[kernel] {name} timing: kernel {t['ms']:.4f} ms (graph "
        f"{t['graph_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
        f"{library_what} {lib}; bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({nbytes / 1e6:.1f} MB, "
        + ", ".join(f"{n / 1e9:.2f} GFLOP {kind}"
                    for kind, n in flops.items()) + f"); {note}")
    torch.cuda.empty_cache()
    return t


def _versus_library(name, t) -> None:
    """Say whether the kernel's graph time is no slower than the library
    call's (the yardstick of a redesigned kernel)."""
    if t["library_graph_ms"] is None:
        say(f"[versus] {name}: library call not timed")
        return
    ratio = t["graph_ms"] / t["library_graph_ms"]
    say(f"[versus] {name}: graph_ms kernel {t['graph_ms']:.4f} / library "
        f"{t['library_graph_ms']:.4f} = {ratio:.3f} "
        f"({'no slower' if ratio <= 1.0 else 'SLOWER'} than the library)")


def phase_kernels(cfg):
    """Each variant of the kernel against its plain version at the shapes
    the main path gives it, then timed.  The main path runs bf16
    activations (the model's dtype) at the decode capacity (4 sequences),
    the prefill capacity (128 tokens) and phase 7c's long-prefill capacity
    (``LONG_PROMPT`` tokens, more than one block of rows); the f32 rows
    are the engine's f32 parity mode (three bf16 planes of x) at the
    decode and prefill shapes.  Returns, per code layout and activation
    type (``k_major``, ``output_major``, with ``_f32`` for f32 x), the
    timings of the decode variant and the largest error over all its
    rows."""
    from repro_torch.kernels.amat_matmul import ops
    from repro_torch.kernels.amat_matmul.ref import (
        _dequant_mixed_ref, amat_batched_matmul_ref, amat_batched_matmul_t_ref)
    from repro_torch.models.moe import capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg.moe
    m_dec = capacity(4, m.top_k, m.n_experts, m.capacity_factor)
    m_pre = capacity(128, m.top_k, m.n_experts, m.capacity_factor)
    m_long = capacity(LONG_PROMPT, m.top_k, m.n_experts, m.capacity_factor)
    wi = (m.n_experts, cfg.d_model, 2 * m.d_ff)         # (E, K, N)
    wo = (m.n_experts, m.d_ff, cfg.d_model)
    f32, bf16 = torch.float32, torch.bfloat16
    variants = [
        # name, layout, transposed, x dtype, (E, M, K, N), timed, reported
        ("wi_f32_decode", "k_major", False, f32, (wi[0], m_dec, *wi[1:]),
         True, True),
        ("wo_t_f32_decode", "output_major", True, f32,
         (wo[0], m_dec, *wo[1:]), True, True),
        ("wi_bf16_decode", "k_major", False, bf16, (wi[0], m_dec, *wi[1:]),
         True, True),
        ("wo_t_bf16_decode", "output_major", True, bf16,
         (wo[0], m_dec, *wo[1:]), True, True),
        ("wi_bf16_prefill", "k_major", False, bf16, (wi[0], m_pre, *wi[1:]),
         False, False),
        ("wo_t_bf16_prefill", "output_major", True, bf16,
         (wo[0], m_pre, *wo[1:]), False, False),
        ("wi_bf16_long_prefill", "k_major", False, bf16,
         (wi[0], m_long, *wi[1:]), False, False),
        ("wo_t_bf16_long_prefill", "output_major", True, bf16,
         (wo[0], m_long, *wo[1:]), False, False),
        ("wi_f32_prefill", "k_major", False, f32, (wi[0], m_pre, *wi[1:]),
         False, False),
        ("wo_t_f32_prefill", "output_major", True, f32,
         (wo[0], m_pre, *wo[1:]), False, False),
        ("ragged_wi_f32", "k_major", False, f32, (3, 5, 96, 72), False,
         False),
        ("ragged_wo_t_f32", "output_major", True, f32, (3, 5, 96, 72), False,
         False),
        ("ragged_wi_bf16", "k_major", False, bf16, (3, 5, 96, 72), False,
         False),
        ("ragged_wo_t_bf16", "output_major", True, bf16, (3, 5, 96, 72),
         False, False),
        ("ragged_n_wi_bf16", "k_major", False, bf16, (3, 5, 96, 70), False,
         False),
        ("ragged_n_wo_t_bf16", "output_major", True, bf16, (3, 5, 96, 70),
         False, False),
    ]
    results = {k: {"max_abs_err": 0.0} for k in (
        "k_major", "output_major", "k_major_f32", "output_major_f32")}
    timings = {}
    for seed, (name, layout, transposed, x_dtype, (E, M, K, N), timed,
               reported) in enumerate(variants):
        args = _kernel_inputs(E, M, K, N, seed=seed, transposed=transposed,
                              x_dtype=x_dtype)
        ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref

        def kern():
            return ops.amat_expert_matmul(*args, group_size=32, shift=4,
                                          transposed=transposed)

        def plain():
            return ref(*args, group_size=32, shift=4)

        max_err = _check_row(f"{name} E={E} M={M} K={K} N={N}", kern(),
                             plain(), (E, M, N))
        row = results[layout + ("_f32" if x_dtype == f32 else "")]
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        if timed:
            x, codes, scales, zps, use_lsb = args
            codes_kn = codes.transpose(1, 2) if transposed else codes
            w_dense = _dequant_mixed_ref(codes_kn, scales, zps, use_lsb,
                                         group_size=32, shift=4).contiguous()
            x32 = x.float()             # exact for bf16 x: the same function
            nbytes = (codes.numel() + scales.numel() * 4 + zps.numel()
                      + x.numel() * x.element_size() + E * M * N * 4
                      + use_lsb.numel())
            t = _timed(name, kern, plain, lambda: torch.bmm(x32, w_dense),
                       "torch.bmm on dense f32 weights", nbytes,
                       _amat_flops(x_dtype, 2.0 * E * M * K * N),
                       f"the library call reads {E * K * N * 4 / 1e6:.0f} MB "
                       f"of f32 weights, not the {codes.numel() / 1e6:.0f} MB "
                       "of codes")
            del w_dense, x32
            timings[name] = t
            if reported:
                row.update(t)
        del args
        torch.cuda.empty_cache()
    for bf, f in (("wi_bf16_decode", "wi_f32_decode"),
                  ("wo_t_bf16_decode", "wo_t_f32_decode")):
        t, t32 = timings[bf], timings[f]
        _versus_library(bf, t)
        _versus_library(f, t32)
        say(f"[versus] {bf}: graph_ms bf16 x {t['graph_ms']:.4f} / f32 x as "
            f"three bf16 planes ({f}) {t32['graph_ms']:.4f} = "
            f"{t['graph_ms'] / t32['graph_ms']:.3f}, both on the tensor "
            f"cores; {t['bound_ms'] / t['graph_ms']:.1%} and "
            f"{t32['bound_ms'] / t32['graph_ms']:.1%} of their "
            f"{t['bound_by']} / {t32['bound_by']} bounds {t['bound_ms']:.4f} "
            f"/ {t32['bound_ms']:.4f} ms")
    return results


def phase_slice_kernels(cfg):
    """This slice's kernels against their plain versions on the card, at
    the widths of configs in the repo, and the timed rows beside the
    plain version, one library call and the card's bound:

    * K3 ``amat_matmul``: one qwen15-moe-a2.7b expert's ``wi`` (K=2048,
      N=2816) at the prefill capacity (M=128) in each precision mode, with
      bf16 and f32 (three bf16 planes) activations, and at one
      decode token, and the reference's ragged M=7, K=96, N=33 in both;
    * K4 ``expert_matmul``: K1's ``wi`` shapes (E=60 at the decode and
      prefill capacities; the decode row timed with bf16 and f32 x) and
      the reference's ragged E=8, C=33, K=96;
    * K5 ``flash_attention``: qwen15-moe-a2.7b's causal attention at 4
      sequences of 4096 (bf16 and f32 inputs), llama4-scout-17b-a16e's
      windowed GQA attention
      at 12288 tokens, and two of the reference's small cases.

    Returns, per reported kernel (the launch-counter key, with ``_f32``
    for the f32 routes of K3 and K5), the reported row's timings and the
    largest error over all that kernel's rows."""
    from repro_torch.core.amat import MatConfig, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.amat_matmul.ref import (_dequant_mixed_ref,
                                                     amat_matmul_ref)
    from repro_torch.kernels.expert_matmul import ops as expert_ops
    from repro_torch.kernels.expert_matmul.ref import expert_matmul_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.models.moe import capacity

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda")
    g.manual_seed(100)
    results = {k: {"max_abs_err": 0.0} for k in (
        "single", "single_f32", "expert", "flash", "flash_f32")}

    def record(key, max_err, timing, reported):
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"],
                                          max_err)
        if reported:
            results[key].update(timing)

    # K3: one matrix.  Ten quantized copies (58 MB of codes) rotate in the
    # timed loops, so that the bytes come from HBM and not the 50 MB L2.
    # Its f32 rows report as "single_f32".
    mat = MatConfig(8, 4)

    def quantized(k, n):
        return amat_quantize(
            torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, mat)

    m = cfg.moe
    K, N = cfg.d_model, 2 * m.d_ff
    copies = [quantized(K, N) for _ in range(10)]
    single_rows = [
        # name, M, K, N, x dtype, mode, shift, timed, reported
        ("amat_single_prefill_high", 128, K, N, bf16, "high", 0, True, True),
        ("amat_single_prefill_high_f32", 128, K, N, f32, "high", 0, True,
         True),
        ("amat_single_prefill_low4", 128, K, N, bf16, "low", 4, True, False),
        ("amat_single_prefill_low2", 128, K, N, bf16, "low", 2, False, False),
        ("amat_single_decode_low4", 1, K, N, bf16, "low", 4, True, False),
        ("amat_single_ragged", 7, 96, 33, f32, "low", 4, False, False),
        ("amat_single_ragged_bf16", 7, 96, 33, bf16, "low", 4, False, False),
    ]
    for name, M, k, n, xd, mode, shift, timed, reported in single_rows:
        qts = copies if k == K else [quantized(k, n)]
        x = torch.randn((M, k), generator=g, device="cuda").to(xd)

        def kern(qt):
            return amat_ops.amat_matmul_qt(x, qt, shift=shift, mode=mode)

        def plain(qt):
            return amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                                   shift=shift, mode=mode)

        err = _check_row(f"{name} M={M} K={k} N={n} {mode} shift={shift} "
                         f"{str(xd)[6:]}", kern(qts[0]), plain(qts[0]),
                         (M, n))
        t = None
        if timed:
            hi = torch.tensor([mode == "high"], device="cuda")
            dense = [_dequant_mixed_ref(
                qt.codes[None], qt.scales[None], qt.zero_points[None], hi,
                group_size=32, shift=shift)[0] for qt in qts]
            x32 = x.float()         # exact for bf16 x: the same function
            nbytes = (k * n + (k // 32) * n * 5
                      + x.numel() * x.element_size() + M * n * 4)
            t = _timed(name, _rotating(kern, qts), _rotating(plain, qts),
                       _rotating(lambda w: torch.matmul(x32, w), dense),
                       "torch.matmul on dense f32 weights", nbytes,
                       _amat_flops(xd, 2.0 * M * k * n),
                       "each loop rotates over 10 copies (58 MB of codes, "
                       "231 MB of dense f32 for the library call)")
            _versus_library(name, t)
            del dense
        record("single" if xd == bf16 else "single_f32", err, t, reported)
    del copies
    torch.cuda.empty_cache()

    # K4: the batched expert matmul at K1's wi shapes.
    E = m.n_experts
    c_dec = capacity(4, m.top_k, E, m.capacity_factor)
    c_pre = capacity(128, m.top_k, E, m.capacity_factor)
    expert_rows = [
        # name, (E, C, K, N), x dtype, timed, reported
        ("expert_decode", (E, c_dec, K, N), bf16, True, True),
        ("expert_decode_f32", (E, c_dec, K, N), f32, True, False),
        ("expert_prefill", (E, c_pre, K, N), bf16, False, False),
        ("expert_ragged", (8, 33, 96, 128), f32, False, False),
    ]
    for seed, (name, (e, c, k, n), xd, timed, reported) in enumerate(
            expert_rows, start=20):
        args = _kernel_inputs(e, c, k, n, seed=seed, transposed=False,
                              x_dtype=xd)

        def kern():
            return expert_ops.expert_matmul(*args, group_size=32, shift=4)

        def plain():
            return expert_matmul_ref(*args, group_size=32, shift=4)

        err = _check_row(f"{name} E={e} C={c} K={k} N={n} {str(xd)[6:]}",
                         kern(), plain(), (e, c, n))
        t = None
        if timed:
            x, codes, scales, zps, use_lsb = args
            w_dense = _dequant_mixed_ref(codes, scales, zps, use_lsb,
                                         group_size=32, shift=4).contiguous()
            x32 = x.float()
            nbytes = (codes.numel() + scales.numel() * 4 + zps.numel()
                      + x.numel() * x.element_size() + e * c * n * 4 + e)
            t = _timed(name, kern, plain, lambda: torch.bmm(x32, w_dense),
                       "torch.bmm on dense f32 weights", nbytes,
                       _amat_flops(xd, 2.0 * e * c * k * n),
                       f"{codes.numel() / 1e6:.0f} MB of codes, past the L2")
            del w_dense, x32
        record("expert", err, t, reported)
        del args
        torch.cuda.empty_cache()

    # K5: attention.  llama4-scout-17b-a16e's widths are those of
    # src/repro/configs/llama4_scout_17b_a16e.py (40 heads, 8 KV heads of
    # 128, sliding window 8192); the port does not carry that config.
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    flash_rows = [
        # name, (B, Sq, Sk, H, Hkv, D), causal, window, dtype, timed, reported
        ("flash_qwen_causal", (4, 4096, 4096, hq, hkv, d), True, None, bf16,
         True, True),
        ("flash_qwen_causal_f32", (4, 4096, 4096, hq, hkv, d), True, None,
         f32, True, True),
        ("flash_scout_window", (1, 12288, 12288, 40, 8, 128), True, 8192,
         bf16, True, False),
        ("flash_small_noncausal", (1, 16, 16, 4, 2, 32), False, None, f32,
         False, False),
        ("flash_small_ragged", (1, 17, 33, 4, 4, 64), True, 8, f32, False,
         False),
    ]
    for name, (b, sq, sk, h, hk, dd), causal, win, dt, timed, reported \
            in flash_rows:
        q = torch.randn((b, sq, h, dd), generator=g, device="cuda").to(dt)
        k = torch.randn((b, sk, hk, dd), generator=g, device="cuda").to(dt)
        v = torch.randn((b, sk, hk, dd), generator=g, device="cuda").to(dt)

        def kern():
            return flash_ops.flash_attention(q, k, v, causal=causal,
                                             sliding_window=win)

        def plain():
            return flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=win)

        want = plain()
        err = _check_row(f"{name} B={b} Sq={sq} Sk={sk} H={h} Hkv={hk} "
                         f"D={dd} causal={causal} window={win} "
                         f"{str(dt)[6:]}", kern(), want, (b, sq, h, dd))
        t = None
        if timed:
            qf, kf, vf = (t_.float().repeat_interleave(h // t_.shape[2], 2)
                          .transpose(1, 2).contiguous() for t_ in (q, k, v))
            mask = None
            if win is not None:
                qpos = torch.arange(sq, device="cuda")[:, None]
                kpos = torch.arange(sk, device="cuda")[None, :]
                mask = qpos - kpos < win
                if causal:
                    mask &= qpos >= kpos

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qf, kf, vf, attn_mask=mask,
                    is_causal=causal and mask is None)

            what = ("scaled_dot_product_attention on f32 [B, H, S, D] with "
                    + ("is_causal" if mask is None else "a boolean mask"))
            try:
                lib_err = float((library().transpose(1, 2) - want).abs().max())
                note = f"library max|sdpa-plain| = {lib_err:.3e}"
            except RuntimeError as e:
                note = f"library call failed: {e}"
            del want
            nbytes = ((q.numel() + k.numel() + v.numel()) * q.element_size()
                      + q.numel() * 4)
            # 2*D for q.k and 2*D for p.v per visible (query, key) pair.
            # With bf16 inputs the cheapest route that holds the tolerance
            # is three bf16 products: q.k (exact) and p.v as p_hi.v +
            # p_lo.v (the f32 p split in two bf16 parts); with f32 inputs
            # six TF32 products: q.k and p.v each as hi.hi + hi.lo + lo.hi.
            half = 2.0 * dd * b * h * _visible_pairs(sq, sk, causal, win)
            flops = {"bf16": 3 * half} if dt == bf16 else {"tf32": 6 * half}
            t = _timed(name, kern, plain, library, what, nbytes, flops, note)
            _versus_library(name, t)
            del qf, kf, vf, mask
        record("flash" if dt == bf16 else "flash_f32", err, t, reported)
        del q, k, v
        torch.cuda.empty_cache()
    return results


def phase_sweep_splits(cfg):
    """``graph_ms`` of K3's tensor-core kernel ('low' at shift 4, one
    qwen15-moe-a2.7b ``wi``, rotating over 10 copies) for each K split in
    turn, the plan's choice marked: the evidence for the split rule.  bf16
    x at four sizes of M, f32 x (three planes) at the prefill and decode
    ends."""
    from repro_torch.core.amat import MatConfig, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(300)
    K, N = cfg.d_model, 2 * cfg.moe.d_ff
    qts = [amat_quantize(torch.randn((K, N), generator=g, device="cuda")
                         * K ** -0.5, MatConfig(8, 4)) for _ in range(10)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = amat_ops.mma_plan
    try:
        for M, xd in ((1, torch.bfloat16), (16, torch.bfloat16),
                      (64, torch.bfloat16), (128, torch.bfloat16),
                      (1, torch.float32), (128, torch.float32)):
            x = torch.randn((M, K), generator=g, device="cuda").to(xd)
            planes = 1 if xd == torch.bfloat16 else amat_ops.X_PLANES
            m_tiles, chosen = plan(M, K, N, 32, sms, planes)
            row = []
            for splits in (1, 2, 3, 4, 6, 8, 12, 16):
                amat_ops.mma_plan = (lambda *a, s=splits, t=m_tiles: (t, s))
                t = graph_ms(_rotating(lambda qt: amat_ops.amat_matmul_qt(
                    x, qt, shift=4, mode="low"), qts), f"sweep M={M}")
                row.append(f"{splits}{'*' if splits == chosen else ''}: "
                           f"{t:.4f}")
            say(f"[sweep] K3 {str(xd)[6:]} M={M} K={K} N={N} "
                f"m_tiles={m_tiles}, "
                f"graph_ms by splits (* = the plan's): " + ", ".join(row))
    finally:
        amat_ops.mma_plan = plan


def _counted(run):
    """``run()`` with every kernel's launch count set to 0 just before and
    read just after; returns its result and the counts."""
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.expert_matmul import ops as expert_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops

    counters = (amat_ops.LAUNCHES, expert_ops.LAUNCHES, flash_ops.LAUNCHES)
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    out = run()
    torch.cuda.synchronize()
    return out, {k: n for c in counters for k, n in c.by_key.items()}


def _drive_entry_points(tag, run, want):
    """Set every kernel's launch count to 0, call ``run()``, which returns
    ``{what: (output, expected shape)}``, and read the counts just after.
    Fails if an output is not finite or of another shape, or if the counts
    are not ``want``; returns the counts."""
    outs, launches = _counted(run)
    for what, (out, shape) in outs.items():
        finite = bool(torch.isfinite(out).all())
        say(f"[{tag}] {what}: {tuple(out.shape)} f32, finite {finite}")
        if tuple(out.shape) != shape or not finite:
            fail(f"{tag}: {what} gave a bad output")
    say(f"[{tag}] kernel launches: {launches} (want {want})")
    if launches != want:
        fail(f"{tag}: the entry points did not each launch their kernel")
    return launches


def phase_slice_path(cfg):
    """This slice's path: the public entry points of K3-K5
    (``amat_matmul_qt`` in both precisions, ``expert_matmul_qt``,
    ``flash_attention`` causal and windowed), driven once each at the
    full-width shapes of phase 3b, with every launch count set to 0 just
    before and read just after.  Returns the counts."""
    from repro_torch.core.amat import MatConfig, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.expert_matmul import ops as expert_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models.moe import capacity

    g = torch.Generator(device="cuda")
    g.manual_seed(200)
    bf16 = torch.bfloat16
    m = cfg.moe
    E, K, N = m.n_experts, cfg.d_model, 2 * m.d_ff
    C = capacity(4, m.top_k, E, m.capacity_factor)
    mat = MatConfig(8, 4)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    qt_one = amat_quantize(randn(K, N) * K ** -0.5, mat)
    qt_experts = amat_quantize(randn(E, K, N) * K ** -0.5, mat)
    use_lsb = torch.rand((E,), generator=g, device="cuda") < 0.5
    x_pre, x_dec, x_exp = (randn(128, K).to(bf16), randn(1, K).to(bf16),
                           randn(E, C, K).to(bf16))
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qwen = [randn(4, 4096, h, d).to(bf16) for h in (hq, hkv, hkv)]
    scout = [randn(1, 12288, h, 128).to(bf16) for h in (40, 8, 8)]
    return _drive_entry_points("path", lambda: {
        "amat_matmul_qt high, M=128": (amat_ops.amat_matmul_qt(
            x_pre, qt_one, mode="high"), (128, N)),
        "amat_matmul_qt low shift 4, M=1": (amat_ops.amat_matmul_qt(
            x_dec, qt_one, shift=4, mode="low"), (1, N)),
        f"expert_matmul_qt E={E} C={C}": (expert_ops.expert_matmul_qt(
            x_exp, qt_experts, use_lsb, shift=4), (E, C, N)),
        "flash_attention causal (qwen)": (flash_ops.flash_attention(
            *qwen, causal=True), (4, 4096, hq, d)),
        "flash_attention window 8192 (scout)": (flash_ops.flash_attention(
            *scout, causal=True, sliding_window=8192), (1, 12288, 40, 128)),
    }, {"k_major": 0, "output_major": 0, "single": 2, "expert": 1,
        "flash": 2})


def phase_f32_path(cfg):
    """The f32 path: ``amat_matmul_qt`` with f32 x (one qwen15-moe-a2.7b
    ``wi`` at M=128, 'high') and ``flash_attention`` on f32 q, k, v
    (qwen15-moe-a2.7b's causal attention, 4 x 4096 tokens), driven once
    each with every launch count set to 0 just before and read just
    after.  Returns the counts, keyed as the JSON rows of the f32
    routes."""
    from repro_torch.core.amat import MatConfig, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(400)
    K, N = cfg.d_model, 2 * cfg.moe.d_ff
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    qt = amat_quantize(randn(K, N) * K ** -0.5, MatConfig(8, 4))
    x = randn(128, K)
    qkv = [randn(4, 4096, h, d) for h in (hq, hkv, hkv)]
    launches = _drive_entry_points("path f32", lambda: {
        "amat_matmul_qt high f32, M=128": (amat_ops.amat_matmul_qt(
            x, qt, mode="high"), (128, N)),
        "flash_attention causal f32 (qwen)": (flash_ops.flash_attention(
            *qkv, causal=True), (4, 4096, hq, d)),
    }, {"k_major": 0, "output_major": 0, "single": 1, "expert": 0,
        "flash": 1})
    return {"single_f32": launches["single"],
            "flash_f32": launches["flash"]}


def _small_engine(cfg, params, device: str):
    """Phase 4's engine over ``params`` on ``device``: the kernel path on
    the card, the plain dense path on the CPU."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig, SliceMoEEngine
    from repro_torch.models.moe import RoutingPolicy

    return SliceMoEEngine(cfg, params, EngineConfig(
        mat=MatConfig(8, 4), cache_bytes=50e6,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=device == "cuda"),
        miss_rate_target=0.05, warmup="pcw", max_seq=48), device=device)


def _launched_k1_k2(launches) -> bool:
    return launches["k_major"] > 0 and launches["output_major"] > 0


def phase_small_reference():
    """The kernel path on the card against the plain dense path on the
    CPU, end to end through the engine, on a small input in f32: the
    batched expert kernels' f32 route (three bf16 planes of x), then the
    same with the int8 KV cache.  Every launch count is set to 0 just
    before each card run and read just after; K1 and K2 must have
    launched in each.  Returns the bf16-KV run's counts, keyed as the JSON
    rows of the f32 routes."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 24))

    def run(dev):
        eng = _small_engine(cfg, params, dev)
        logits = eng.prefill(prompt)
        toks, metrics = eng.decode(torch.argmax(logits, -1), 6)
        return logits.cpu(), toks.cpu(), metrics["cache_stats"]

    out = {"cpu": run("cpu")}
    out["cuda"], launches = _counted(lambda: run("cuda"))
    lerr = float((out["cpu"][0] - out["cuda"][0]).abs().max())
    same_tokens = bool(torch.equal(out["cpu"][1], out["cuda"][1]))
    same_stats = out["cpu"][2] == out["cuda"][2]
    say(f"[reference] qwen15-moe-repro (2 layers, f32): kernel on the card vs "
        f"plain dense path on the CPU: prefill logits max diff {lerr:.2e}, "
        f"tokens equal {same_tokens}, cache stats equal {same_stats}")
    say(f"[reference] kernel launches: {launches} (want k_major and "
        f"output_major > 0: the f32 route of K1 and K2)")
    if not (lerr <= 1e-4 and same_tokens and same_stats):
        fail("small-input reference check")
    if not _launched_k1_k2(launches):
        fail("reference check: the f32 path did not launch K1 and K2")
    _small_int8_kv(cfg, params, prompt)
    return {"k_major_f32": launches["k_major"],
            "output_major_f32": launches["output_major"]}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _small_int8_kv(cfg, params, prompt, steps: int = 6):
    """Phase 4's int8-KV run: the same model and prompt with
    ``kv_dtype="int8"``, on the card through the kernel and on the CPU
    through the plain path.  Both prefill (logits at 1e-4, and the two
    caches' codes compared); the card then decodes from the CPU's cache,
    carried across, so both decodes start from the same int8 codes: a
    K/V value within an f32 ulp of a rounding tie may take either code,
    and one code step moves the logits by about 3e-4.  Each decode
    step's logits must agree at 1e-4, the tokens exactly, and the cache
    stats at the end.  The card's prefill and its decode each count their
    own launches, and K1 and K2 must launch in both."""
    import dataclasses

    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    eng = {dev: _small_engine(cfg8, params, dev) for dev in ("cpu", "cuda")}
    first = {"cpu": eng["cpu"].prefill(prompt).cpu()}
    first["cuda"], pre_launches = _counted(
        lambda: eng["cuda"].prefill(prompt).cpu())
    perr = float((first["cpu"] - first["cuda"]).abs().max())
    code_diff = [int((eng["cpu"].kv_cache[key][name]
                      != eng["cuda"].kv_cache[key][name].cpu()).sum())
                 for key in eng["cpu"].kv_cache if key != "pos"
                 for name in ("k", "v")]
    n_codes = sum(eng["cpu"].kv_cache[key][name].numel()
                  for key in eng["cpu"].kv_cache if key != "pos"
                  for name in ("k", "v"))
    eng["cuda"].kv_cache = _to_device(eng["cpu"].kv_cache, "cuda")

    def decode(e, first_logits):
        token = torch.argmax(first_logits, -1).to(e.device)
        logits, tokens = [], [token.cpu()]
        for _ in range(steps):
            lg, e.kv_cache, charge = e.decode_batch(token, e.kv_cache,
                                                    alpha=e.alpha)
            if e.controller is not None:
                e.alpha = e.controller.update(charge.miss_rate)
            token = torch.argmax(lg, -1)
            logits.append(lg.cpu())
            tokens.append(token.cpu())
        return logits, tokens

    logits, tokens = {}, {}
    logits["cpu"], tokens["cpu"] = decode(eng["cpu"], first["cpu"])
    (logits["cuda"], tokens["cuda"]), dec_launches = _counted(
        lambda: decode(eng["cuda"], first["cuda"]))
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["cpu"], logits["cuda"])]
    same_tokens = all(torch.equal(a, b)
                      for a, b in zip(tokens["cpu"], tokens["cuda"]))
    same_stats = eng["cpu"].cache.stats.snapshot() == \
        eng["cuda"].cache.stats.snapshot()
    kv = eng["cuda"].kv_cache["pos0"]
    say(f"[reference] int8 KV (kv_dtype int8, cache leaves "
        f"{ {n: str(t.dtype) for n, t in kv.items()} }): prefill logits max "
        f"diff {perr:.2e}; the two prefill caches differ in "
        f"{sum(code_diff)} of {n_codes} codes; decode from one cache, "
        f"{steps} steps: logits max diff per step "
        f"{[f'{e:.2e}' for e in errs]}, tokens equal {same_tokens}, cache "
        f"stats equal {same_stats}")
    say(f"[reference] int8-KV kernel launches: prefill {pre_launches}, "
        f"decode {dec_launches} (want k_major and output_major > 0 in each)")
    if not (perr <= 1e-4 and max(errs) <= 1e-4 and same_tokens
            and same_stats):
        fail("int8-KV reference check")
    if not (_launched_k1_k2(pre_launches) and _launched_k1_k2(dec_launches)):
        fail("int8-KV reference check: the card's prefill or decode did not "
             "launch K1 and K2")


SERVE_PROMPT, SERVE_NEW, SERVE_REQ = 128, 16, 4


def _serve(cfg, params, ecfg, prompts, tag: str, device: str, *,
           new: int = SERVE_NEW, tenants=None):
    """Serve ``prompts`` (``new`` new tokens each, request ``i`` from
    tenant ``tenants[i]`` when given) through the continuous-batching
    scheduler (one slot per prompt, at most ``SERVE_REQ``) with a trace
    recorder attached, the launch counts set to 0 just before the run and
    read just after.  Fails unless every request is served in full, every
    logit is finite and (on the card) K1 and K2 launched once per MoE
    layer per forward.  Returns the run's engine, scheduler, trace and
    figures."""
    from repro_torch.core.engine import PersistentEngine
    from repro_torch.kernels.amat_matmul import ops
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request, SchedulerConfig)
    from repro_torch.sim import TraceRecorder

    class CheckedEngine(PersistentEngine):
        """Records on the card whether every logit it returns is finite,
        and counts the decode steps' slice accesses and misses."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.all_finite = torch.ones((), dtype=torch.bool,
                                         device=self.device)
            self.decode_accesses = self.decode_misses = 0

        def run_prefill(self, tokens, **kw):
            logits, kv, info = super().run_prefill(tokens, **kw)
            self.all_finite &= torch.isfinite(logits).all()
            return logits, kv, info

        def decode_batch(self, token, kv_cache, **kw):
            logits, kv, charge = super().decode_batch(token, kv_cache, **kw)
            self.all_finite &= torch.isfinite(logits).all()
            self.decode_accesses += charge.accesses
            self.decode_misses += charge.misses
            return logits, kv, charge

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    engine = CheckedEngine(cfg, params, ecfg, device=device)
    sync()
    t_quant = time.perf_counter() - t0
    sched = ContinuousBatchingScheduler(
        engine, SchedulerConfig(max_batch=min(len(prompts), SERVE_REQ)),
        device=device)
    for i, prompt in enumerate(prompts):
        if not sched.submit(Request(
                request_id=i, prompt=prompt, max_new_tokens=new,
                tenant="default" if tenants is None else tenants[i])):
            fail(f"{tag}: request {i} was not admitted")

    class TimedRecorder(TraceRecorder):
        """Adds up its own host time: the run's walls include it."""
        seconds = 0.0

        def on_prefill(self, *a, **kw):
            t0 = time.perf_counter()
            super().on_prefill(*a, **kw)
            self.seconds += time.perf_counter() - t0

        def on_decode(self, tr):
            t0 = time.perf_counter()
            super().on_decode(tr)
            self.seconds += time.perf_counter() - t0

    recorder = sched.attach_recorder(TimedRecorder())

    sync()
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    completions = sched.run()
    sync()
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES.by_key[k]
                for k in ("k_major", "output_major")}
    n_prefill, n_steps = len(sched.wall_prefill_s), len(sched.wall_step_s)
    want = cfg.n_layers * (n_prefill + n_steps)
    say(f"[{tag}] kernel launches: {launches} (want {want} each, "
        f"{2 * want} in all)")
    if len(completions) != len(prompts) or any(
            len(c.tokens) != new for c in completions):
        fail(f"{tag}: not every request was served in full")
    if on_card and (launches["k_major"] != want
                    or launches["output_major"] != want):
        fail(f"{tag}: the main path did not launch the kernel once per MoE "
             "layer projection per forward pass")
    if not bool(engine.all_finite):
        fail(f"{tag}: non-finite logits")
    return {"engine": engine, "sched": sched, "completions": completions,
            "launches": launches, "wall": wall, "t_quant": t_quant,
            "trace": recorder.trace(), "record_s": recorder.seconds}


def _check_replay(run, tag: str, path: str):
    """The recorded trace through a file, replayed by ``repro_torch.sim``:
    it must equal the live run (epoch counts, decode accesses and misses,
    the miss curve and the prefetch summary exactly; every ledger figure
    at rtol 1e-6).  Returns the replay's report."""
    from repro_torch.sim import Trace, replay_trace, traces_equal

    engine, sched = run["engine"], run["sched"]
    t0 = time.perf_counter()
    loaded = Trace.load(run["trace"].save(path))
    if not traces_equal(loaded, run["trace"]):
        fail(f"{tag}: the trace read back from {path} differs")
    rep = replay_trace(loaded)
    wall = time.perf_counter() - t0
    live = engine.ledger.snapshot()
    off = [k for k in live if not (rep.ledger[k] == live[k] or abs(
        rep.ledger[k] - live[k]) <= 1e-6 * max(abs(rep.ledger[k]),
                                               abs(live[k])))]
    pf_live = (engine.prefetcher.summary()
               if engine.prefetcher is not None else None)
    say(f"[replay] {tag}: {loaded.n_prefills} prefills, "
        f"{loaded.n_decode_steps} decode steps, "
        f"{os.path.getsize(path)} bytes, replayed in {wall:.2f} s (host)")
    say(f"[replay] {tag}: decode accesses/misses replay "
        f"{rep.decode_accesses}/{rep.decode_misses}, live "
        f"{engine.decode_accesses}/{engine.decode_misses}; energy replay "
        f"{rep.total_energy_j!r} J, live {live['total_energy_j']!r} J; "
        f"latency replay {rep.total_latency_s!r} s, live "
        f"{live['total_latency_s']!r} s (cost model)")
    if rep.epoch_counts != engine.cache.epoch_counts():
        fail(f"{tag}: replayed epoch counts differ from the live run")
    if (rep.decode_accesses, rep.decode_misses) != (
            engine.decode_accesses, engine.decode_misses):
        fail(f"{tag}: replayed decode accesses/misses differ")
    if rep.miss_curve != sched.telemetry.miss_rate_curve():
        fail(f"{tag}: replayed miss curve differs from the live run")
    if rep.prefetch != pf_live:
        fail(f"{tag}: replayed prefetch summary {rep.prefetch} differs "
             f"from the live {pf_live}")
    if off:
        fail(f"{tag}: replayed ledger differs from the live one at "
             f"{off}")
    return rep


def _store_bytes(cfg, mat) -> float:
    """The slice store's size from the shapes: MSB and LSB slices of
    every expert's ``wi`` and ``wo`` in every layer."""
    from repro_torch.core.amat import slice_nbytes

    m = cfg.moe
    per_expert = sum(
        slice_nbytes(shape, mat.high_bits, mat.group_size, which=w,
                     shift=mat.shift)
        for shape in ((cfg.d_model, 2 * m.d_ff), (m.d_ff, cfg.d_model))
        for w in ("msb", "lsb"))
    return per_expert * cfg.n_layers * m.n_experts


def phase_serving(cfg, device: str = "cuda"):
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import RoutingPolicy
    from repro_torch.serving.scheduler import Request
    from repro_torch.sim import replay_trace

    on_card = device == "cuda"
    mat = MatConfig(8, 4)
    m = cfg.moe
    store_bytes = _store_bytes(cfg, mat)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    if on_card:
        torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    ecfg = EngineConfig(
        mat=mat, cache_bytes=store_bytes / 4,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=True),
        miss_rate_target=0.05, warmup="pcw",
        max_seq=SERVE_PROMPT + SERVE_NEW + 1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQ)]
    run = _serve(cfg, params, ecfg, prompts, "serve", device)
    engine, sched = run["engine"], run["sched"]
    if engine.store.total_bytes() != store_bytes:
        fail("slice store size differs from its analytic size")
    say(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{m.n_experts} experts top-{m.top_k}, {n_params / 1e9:.2f} B params "
        f"in {cfg.dtype}; init {t_init:.1f} s, AMAT quantization "
        f"{run['t_quant']:.1f} s; slice cache {ecfg.cache_bytes / 1e9:.3f} GB "
        f"(a quarter of the {store_bytes / 1e9:.3f} GB store)")

    def new_requests(n_new):
        return [Request(request_id=100 + i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            SERVE_PROMPT).astype(np.int32),
                        max_new_tokens=n_new) for i in range(SERVE_REQ)]

    for c in sorted(run["completions"], key=lambda c: c.request_id):
        dt = c.metrics["decode_totals"]
        cs = c.metrics["cache_stats"]
        acc = cs["msb_hits"] + cs["msb_misses"] + cs["lsb_hits"] \
            + cs["lsb_misses"]
        miss = (cs["msb_misses"] + cs["lsb_misses"]) / max(acc, 1)
        say(f"[serve] request {c.request_id}: tokens {c.tokens.tolist()}")
        say(f"[serve]   decode_totals: energy {dt['total_energy_j']:.6g} J, "
            f"latency {dt['total_latency_s']:.6g} s, flash "
            f"{dt['flash_bytes']:.6g} B, dram {dt['dram_bytes']:.6g} B "
            f"(mobile_soc cost model); cache_stats miss rate {miss:.4f} "
            f"({acc} accesses)")
    say(f"[serve] {len(sched.wall_prefill_s)} prefills, "
        f"{len(sched.wall_step_s)} decode steps, wall {run['wall']:.2f} s; "
        f"wall per prefill (s) "
        f"{[round(s, 4) for s in sched.wall_prefill_s]}; wall per decode "
        f"step: median {np.median(sched.wall_step_s):.4f} s, "
        f"min {min(sched.wall_step_s):.4f} s, max "
        f"{max(sched.wall_step_s):.4f} s")
    say(f"[serve] the walls include the trace recorder's host time: "
        f"{run['record_s']:.6f} s in the run's wall, "
        f"{run['record_s'] / run['wall']:.3%} of it")
    if on_card:
        say(f"[serve] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    summary = sched.summary()
    say(f"[serve] fleet: {summary['n_tokens']} tokens, mean miss rate "
        f"{summary['mean_miss_rate']:.4f}, steady-state miss rate "
        f"{summary['steady_state_miss_rate']:.4f}")

    # The recorded trace: a file, a replay equal to the live run, and the
    # same trace on the async timeline, which must keep the energy and
    # not raise the latency (the reference's timeline invariant).
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    rep = _check_replay(run, "serve",
                        os.path.join(HERE, "build", "serve_trace.npz"))
    asyn = replay_trace(run["trace"], async_io=True)
    de = abs(asyn.total_energy_j - rep.total_energy_j) \
        / rep.total_energy_j
    say(f"[replay] serve on the async timeline: energy "
        f"{asyn.total_energy_j!r} J (rel diff {de:.2e} from the serialized "
        f"replay), latency {asyn.total_latency_s!r} s against "
        f"{rep.total_latency_s!r} s, overlap_saved_s "
        f"{asyn.ledger['overlap_saved_s']!r} (cost model)")
    if de > 1e-6 or asyn.total_latency_s > rep.total_latency_s:
        fail("the async replay changed the energy or raised the latency")
    p5 = {"energy_j": rep.total_energy_j, "latency_s": rep.total_latency_s,
          "cache_bytes": ecfg.cache_bytes}
    return (run["launches"], engine, new_requests,
            float(np.median(sched.wall_step_s)), params, prompts, p5)


def phase_serving_async(cfg, params, prompts, p5, device: str = "cuda"):
    """Phase 5b: phase 5's traffic over phase 5's params again, on the
    async slice-I/O timeline with request-level prefetch (the golden
    ``request_prefetch`` knobs, PCW warmup).  Its recorded trace must
    replay to the live run, prefetch counters included."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.moe import RoutingPolicy

    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mat = MatConfig(8, 4)
    ecfg = EngineConfig(
        mat=mat, cache_bytes=p5["cache_bytes"],
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=True),
        miss_rate_target=0.05, warmup="pcw",
        max_seq=SERVE_PROMPT + SERVE_NEW + 1, async_io=True,
        prefetch_top_m=4, prefetch_kind="request", prefetch_lookahead=2,
        prefetch_min_score=0.02)
    run = _serve(cfg, params, ecfg, prompts, "serve-async", device)
    sched = run["sched"]
    rep = _check_replay(run, "serve-async",
                        os.path.join(HERE, "build", "serve_async_trace.npz"))
    live = run["engine"].ledger.snapshot()
    say(f"[serve-async] prefetch: {rep.prefetch}")
    say(f"[serve-async] energy {live['total_energy_j']!r} J, latency "
        f"{live['total_latency_s']!r} s, overlap_saved_s "
        f"{live['overlap_saved_s']!r}, prefetch fills "
        f"{live['n_prefetch_fills']}, wasted prefetch energy "
        f"{live['prefetch_wasted_energy_j']!r} J; phase 5 (serialized, no "
        f"prefetch): energy {p5['energy_j']!r} J, latency "
        f"{p5['latency_s']!r} s (cost model)")
    say(f"[serve-async] {len(sched.wall_prefill_s)} prefills, "
        f"{len(sched.wall_step_s)} decode steps, wall {run['wall']:.2f} s; "
        f"wall per decode step: median {np.median(sched.wall_step_s):.4f} "
        f"s, min {min(sched.wall_step_s):.4f} s, max "
        f"{max(sched.wall_step_s):.4f} s; recorder host time "
        f"{run['record_s']:.6f} s ({run['record_s'] / run['wall']:.3%} "
        "of the wall)")
    if on_card:
        say(f"[serve-async] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    p = rep.prefetch
    if p["in_flight"] or p["issued"] != p["useful"] + p["late"] + p["wasted"]:
        fail(f"serve-async: prefetch outcomes do not partition: {p}")
    return run["launches"]


EP_SHARDS, EP_PERIOD, EP_REPLICAS = 4, 4, 2
LONG_PROMPT, LONG_NEW = 9216, 4


def _phase7_engine_config(p5, **over):
    """Phase 5's engine settings (MAT84, Cache-Prior + DBSC with quantized
    execution, PCW, a quarter of the store cached) with ``over``."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.moe import RoutingPolicy

    kw = dict(mat=MatConfig(8, 4), cache_bytes=p5["cache_bytes"],
              policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                                   quant_execution=True),
              miss_rate_target=0.05, warmup="pcw",
              max_seq=SERVE_PROMPT + SERVE_NEW + 1)
    kw.update(over)
    return EngineConfig(**kw)


def _say_walls(tag: str, run) -> None:
    sched = run["sched"]
    say(f"[{tag}] {len(sched.wall_prefill_s)} prefills, "
        f"{len(sched.wall_step_s)} decode steps, wall {run['wall']:.2f} s; "
        f"wall per prefill (s) {[round(x, 4) for x in sched.wall_prefill_s]}"
        f"; wall per decode step: median {np.median(sched.wall_step_s):.4f}"
        f" s, min {min(sched.wall_step_s):.4f} s, max "
        f"{max(sched.wall_step_s):.4f} s")


def phase_ep_placement(cfg, params, prompts, p5, device: str = "cuda"):
    """Phase 7a: phase 5's traffic over phase 5's params with expert
    parallelism simulated in the charge path on this one device:
    ``ep_shards=4``, hotness placement re-packed every 4 decode steps
    with the 2 hottest (layer, expert) pairs replicated.  Prints the
    per-shard counts, the all-to-all and migration traffic and the
    placement summary; the recorded trace must replay to the live run
    (epoch counts, per-shard epoch counts, migrations and the placement
    summary exactly, the ledger at rtol 1e-6)."""
    ecfg = _phase7_engine_config(
        p5, ep_shards=EP_SHARDS, placement="hotness",
        placement_period=EP_PERIOD, replicate_k=EP_REPLICAS)
    run = _serve(cfg, params, ecfg, prompts, "ep", device)
    engine = run["engine"]
    for row in engine.shard_breakdown():
        say(f"[ep] shard {row['shard']}: owns {len(row['experts'])} of "
            f"layer 0's {cfg.moe.n_experts} experts; accesses "
            f"{row['accesses']}, misses {row['misses']} (miss rate "
            f"{row['miss_rate']:.4f}); flash {row['flash_bytes']!r} B, "
            f"energy {row['energy_j']!r} J, makespan {row['makespan_s']!r} "
            f"s (cost model)")
    led = engine.ledger.snapshot()
    a2a = led["ici_bytes"] - led["migration_bytes"]
    say(f"[ep] all-to-all bytes {a2a!r}, migrations {led['n_migrations']} "
        f"slices, migration bytes {led['migration_bytes']!r}, interconnect "
        f"energy {led['ici_energy_j']!r} J; total energy "
        f"{led['total_energy_j']!r} J, latency {led['total_latency_s']!r} "
        f"s; phase 5 (one device): {p5['energy_j']!r} J, "
        f"{p5['latency_s']!r} s (cost model)")
    say(f"[ep] placement_summary: {engine.placement_summary()}")
    say(f"[ep] migration events: {engine.migration_events}")
    say(f"[ep] kernel launches {run['launches']}")
    _say_walls("ep", run)
    rep = _check_replay(run, "ep",
                        os.path.join(HERE, "build", "ep_trace.npz"))
    per_shard = engine.cache.per_shard_epoch_counts()
    say(f"[replay] ep: per-shard epoch counts equal "
        f"{rep.per_shard_epoch_counts == per_shard}, migrations equal "
        f"{(rep.migration_events or []) == engine.migration_events}, "
        f"placement summary equal "
        f"{rep.placement == engine.placement_summary()}")
    if rep.per_shard_epoch_counts != per_shard:
        fail("ep: replayed per-shard epoch counts differ")
    if (rep.migration_events or []) != engine.migration_events \
            or rep.placement != engine.placement_summary():
        fail("ep: replayed migrations or placement differ")
    if not engine.migration_events or a2a <= 0:
        fail("ep: no migration or no all-to-all traffic in the run")
    return run["launches"]


def _kv_bytes(cache) -> float:
    return float(sum(t.numel() * t.element_size()
                     for key, entry in cache.items() if key != "pos"
                     for t in entry.values()))


def phase_controller_int8(cfg, params, prompts, p5, device: str = "cuda"):
    """Phase 7b: phase 5's traffic from two tenants in turn, with the int8
    KV cache and the SLO controller (two tenant SLOs, a partitioned cache,
    one device).  ``batch`` carries a miss SLO no run meets, so the
    controller demotes it and then moves cache bytes to it from
    ``premium``.  Prints the controller's actions and summary, each
    tenant's miss rate and low-bit share and the KV cache's bytes (about
    half of bf16's); the recorded trace must replay to the live run
    (epoch counts and the miss curve exactly, the energy curve and the
    ledger at rtol 1e-6, the controller's summary equal)."""
    import dataclasses

    from repro_torch.control import ControllerConfig, TenantSLO

    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    ctl = ControllerConfig(
        slos={"premium": TenantSLO(miss_rate=0.60, lowbit_frac=0.05,
                                   bit_floor="high"),
              "batch": TenantSLO(miss_rate=1e-6, lowbit_frac=1.0)},
        interval=2, window=8, cooldown=4, partition=True)
    ecfg = _phase7_engine_config(p5, controller=ctl)
    tenants = ["premium", "batch"] * (len(prompts) // 2)
    run = _serve(cfg8, params, ecfg, prompts, "ctl-int8", device,
                 tenants=tenants)
    engine, sched = run["engine"], run["sched"]
    kv8 = _kv_bytes(sched.batch_cache)
    kv16 = float(sum(2 * sched.batch_cache[key][name].numel()
                     for key in sched.batch_cache if key != "pos"
                     for name in ("k", "v")))
    say(f"[ctl-int8] KV cache {kv8 / 1e6:.3f} MB (int8 codes + f32 scales, "
        f"{max(len(prompts), 1)} slots x {ecfg.max_seq} positions x "
        f"{cfg.n_layers} layers), bf16 would take {kv16 / 1e6:.3f} MB: "
        f"{kv8 / kv16:.4f} of it, (head_dim + 4) / (2 head_dim)")
    summary = engine.slo_controller.summary()
    say(f"[ctl-int8] controller actions: {engine.slo_controller.actions}")
    say(f"[ctl-int8] controller summary: levels {summary['levels']}, "
        f"budgets {summary['budgets']}, admit_fracs "
        f"{summary['admit_fracs']}, {summary['n_actions']} actions over "
        f"{summary['steps']} steps; cache segments "
        f"{engine.cache.budgets()}")
    totals: dict = {}
    for step in sched.telemetry.steps:
        for t, row in (step.per_tenant or {}).items():
            acc = totals.setdefault(t, dict.fromkeys(row, 0))
            for k, v in row.items():
                acc[k] += v
    for t, row in sorted(totals.items()):
        say(f"[ctl-int8] tenant {t}: {row['tokens']} decode tokens, miss "
            f"rate {row['misses'] / max(row['accesses'], 1):.4f} "
            f"({row['misses']} of {row['accesses']}), low-bit share of "
            f"critical selections "
            f"{row['critical_low'] / max(row['critical'], 1):.4f} "
            f"({row['critical_low']} of {row['critical']})")
    say(f"[ctl-int8] kernel launches {run['launches']}")
    _say_walls("ctl-int8", run)
    rep = _check_replay(run, "ctl-int8",
                        os.path.join(HERE, "build", "ctl_int8_trace.npz"))
    live_e = sched.telemetry.energy_curve()
    e_off = [i for i, (a, b) in enumerate(zip(rep.energy_curve, live_e))
             if abs(a - b) > 1e-6 * max(abs(a), abs(b))]
    say(f"[replay] ctl-int8: energy curve equal at rtol 1e-6 "
        f"{not e_off and len(rep.energy_curve) == len(live_e)}, controller "
        f"summary equal {rep.controller_summary == summary}")
    if e_off or len(rep.energy_curve) != len(live_e):
        fail(f"ctl-int8: replayed energy curve differs at steps {e_off}")
    if rep.controller_summary != summary:
        fail("ctl-int8: replayed controller summary differs")
    hd = cfg.head_dim
    if kv8 * 2 * hd != kv16 * (hd + 4):
        fail("ctl-int8: the int8 KV cache is not (head_dim + 4) / "
             "(2 head_dim) of bf16's")
    if not summary["n_actions"]:
        fail("ctl-int8: the controller never acted")
    return run["launches"]


def phase_long_prefill(cfg, params, p5, device: str = "cuda",
                       n_prompt: int = LONG_PROMPT):
    """Phase 7c: one request of ``n_prompt`` tokens (above the 8192-key
    threshold, so every layer's prefill attention runs blockwise) with
    the int8 KV cache through the engine, then ``LONG_NEW`` decode steps.
    First layer 0's q/k/v of that prompt (from the float params, in f32)
    go through ``blockwise_attention`` and the dense body of
    ``attention`` on the device: they must agree at 1e-4 + 1e-4*|dense|.
    Prints both times, the prefill's wall and the peak memory."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models import model as MDL

    on_card = device == "cuda"
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, n_prompt).astype(np.int32)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        p0 = MDL._index(params["blocks"], 0)["pos0"]
        x = params["embed"][torch.as_tensor(prompt, device=device)[None]]
        h = L.rms_norm(x.to(MDL._dt(cfg)), p0["norm"], cfg.norm_eps)
        q, k, v = MDL._attn_qkv(p0, h, cfg)
        pos = torch.arange(n_prompt, device=device)[None]
        q, k, v = (L.apply_rope(q, pos, cfg.rope_theta).float(),
                   L.apply_rope(k, pos, cfg.rope_theta).float(), v.float())
        sync()
        t0 = time.perf_counter()
        blk = L.blockwise_attention(q, k, v, causal=True)
        sync()
        t_blk = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = L.dense_attention(q, k, v, causal=True)
        sync()
        t_dense = time.perf_counter() - t0
        err = (blk - dense).abs()
        bad = int((err > TOL_ABS + TOL_REL * dense.abs()).sum())
        max_err = float(err.max())
    peak_check = torch.cuda.max_memory_allocated() if on_card else 0
    say(f"[long] layer 0 of a {n_prompt}-token prompt ({cfg.n_heads} heads "
        f"of {cfg.head_dim}, f32 q/k/v): blockwise_attention (blocks of "
        f"{L.BLOCK_KV} keys) {t_blk * 1e3:.1f} ms, dense body "
        f"{t_dense * 1e3:.1f} ms (first calls, host clock); max abs diff "
        f"{max_err:.2e}, {bad} entries over 1e-4 + 1e-4*|dense|; peak "
        f"memory of the check {peak_check / 1e9:.2f} GB")
    if bad or not bool(torch.isfinite(blk).all()):
        fail("long: blockwise attention disagrees with the dense body")
    del q, k, v, blk, dense, err, x, h
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ecfg = _phase7_engine_config(p5, max_seq=n_prompt + LONG_NEW + 12)
    run = _serve(cfg8, params, ecfg, [prompt], "long", device, new=LONG_NEW)
    sched = run["sched"]
    kv = _kv_bytes(sched.batch_cache)
    say(f"[long] prefill of {n_prompt} tokens through the engine: wall "
        f"{sched.wall_prefill_s[0]:.4f} s; {len(sched.wall_step_s)} decode "
        f"steps, wall per step {[round(x, 4) for x in sched.wall_step_s]} "
        f"s; int8 KV cache {kv / 1e9:.3f} GB for {ecfg.max_seq} positions; "
        f"kernel launches {run['launches']}")
    if on_card:
        say(f"[long] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return run["launches"]


TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 2, 40, 8, 64, 2e-3


def _scheme_configs(cfg):
    """Phase 6's two serving schemes, both with quantized execution and a
    slice cache of a quarter of the store: Fig. 9's ``buddy_highbit``, and
    phase 5's Cache-Prior + DBSC + PCW."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.moe import RoutingPolicy

    mat = MatConfig(8, 4)
    common = dict(mat=mat, cache_bytes=_store_bytes(cfg, mat) / 4,
                  miss_rate_target=0.05,
                  max_seq=SERVE_PROMPT + SERVE_NEW + 1)
    return {
        "buddy_highbit": EngineConfig(
            policy=RoutingPolicy(kind="buddy", slice_mode="highbit",
                                 quant_execution=True),
            fused_slices=True, warmup="empty", **common),
        "cache_prior_dbsc_pcw": EngineConfig(
            policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                                 quant_execution=True),
            warmup="pcw", **common),
    }


def _serve_schemes(cfg, params, prompts, tag: str, device: str) -> dict:
    """Serve ``prompts`` under both schemes in turn (``_serve``: launch
    counts reset just before each run and read just after, every request
    in full, finite logits); returns each scheme's decode miss rate and
    modeled energy and latency."""
    out = {}
    for name, ecfg in _scheme_configs(cfg).items():
        run = _serve(cfg, params, ecfg, prompts, f"{tag} {name}", device)
        engine = run["engine"]
        live = engine.ledger.snapshot()
        out[name] = {
            "miss_rate": engine.decode_misses / max(engine.decode_accesses, 1),
            "accesses": engine.decode_accesses,
            "misses": engine.decode_misses,
            "energy_j": live["total_energy_j"],
            "latency_s": live["total_latency_s"],
            "launches": run["launches"], "wall": run["wall"]}
        del run, engine
        gc.collect()
    return out


def phase_train_serve(cfg, device: str = "cuda"):
    """Phase 6: train, checkpoint, serve.  ``cfg`` at its published widths,
    cut to ``TRAIN_LAYERS`` layers, trained from the port's init (seed 0)
    with ``train_or_load``'s settings on ``SyntheticLM``; the weights go
    through the port's checkpoint writer and reader (bit for bit), and the
    restored model is served under two schemes.  The same model at its
    untrained init is served beside it (descriptive only)."""
    import dataclasses
    import math
    import shutil

    sys.path.insert(0, HERE)
    from benchmarks.torch_common import eval_batches
    from repro_torch.checkpoint import ckpt as CKPT
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import init_params, tree_leaves
    from repro_torch.optim.adamw import AdamWConfig

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    small = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    n_small, n_full = small.param_count(), cfg.param_count()
    say(f"[train] {cfg.name} at its published widths, depth cut to "
        f"{TRAIN_LAYERS} of {cfg.n_layers} layers: training holds 16 B per "
        "parameter (bf16 weights and grads; f32 mu, nu and master copy), "
        f"{n_small / 1e9:.3f} B params x 16 B = {16 * n_small / 1e9:.1f} GB "
        f"at {TRAIN_LAYERS} layers against {16 * n_full / 1e9:.0f} GB at "
        f"{cfg.n_layers}, which one card cannot hold")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    opt_cfg = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                          warmup_steps=max(TRAIN_STEPS // 10, 1))
    t0 = time.perf_counter()
    params, opt_state, hist = train_loop(
        small, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, opt_cfg=opt_cfg,
        log_every=max(TRAIN_STEPS // 4, 1), seed=0, collect_history=True,
        device=device)
    sync()
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in hist]
    ends = [m["wall_s"] for m in hist]
    per_step = np.diff([0.0] + ends)
    say(f"[train] {TRAIN_STEPS} steps, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"lr {TRAIN_LR} cosine, warmup {opt_cfg.warmup_steps}, vocab "
        f"{small.vocab_size}: losses {[round(x, 4) for x in losses]}")
    say(f"[train] aux_loss first/last {hist[0]['aux_loss']:.4f} / "
        f"{hist[-1]['aux_loss']:.4f}; grad_norm first/last "
        f"{hist[0]['grad_norm']:.3f} / {hist[-1]['grad_norm']:.3f}")
    say(f"[train] wall {wall:.2f} s; per step: first {per_step[0]:.4f} s, "
        f"median {np.median(per_step):.4f} s, min {per_step.min():.4f} s, "
        f"max {per_step.max():.4f} s (host clock; each step ends when its "
        "loss reaches the host)")
    if on_card:
        say(f"[train] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    uniform = math.log(small.vocab_size)
    if not all(np.isfinite(losses)):
        fail("train: a non-finite loss")
    if not (losses[-1] < losses[0] and losses[-1] < uniform):
        fail(f"train: the last loss {losses[-1]:.4f} is not below both the "
             f"first {losses[0]:.4f} and ln(vocab) = {uniform:.4f}")
    del opt_state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    path = os.path.join(HERE, "build", "phase6_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    CKPT.save(path, {"params": params}, step=TRAIN_STEPS)
    t_save = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    t0 = time.perf_counter()
    restored = CKPT.restore(path, device)["params"]
    sync()
    t_restore = time.perf_counter() - t0
    def bits(t):                    # floats compared by their bit patterns
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
            if t.is_floating_point() else t

    pairs = list(zip(tree_leaves(restored), tree_leaves(params)))
    same = len(pairs) == len(list(tree_leaves(params))) and all(
        a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
        and torch.equal(bits(a), bits(b)) for a, b in pairs)
    say(f"[ckpt] {len(pairs)} leaves, {nbytes} bytes: save {t_save:.2f} s, "
        f"restore onto {device} {t_restore:.2f} s; step "
        f"{CKPT.restore_step(path)}; bit-equal: {same}")
    shutil.rmtree(path)
    if not same:
        fail("ckpt: the restored leaves differ from the trained ones")
    del params, pairs
    gc.collect()

    prompts = [row[:SERVE_PROMPT] for row in eval_batches(
        small, n_batches=1, batch=SERVE_REQ, seq=SERVE_PROMPT)[0]]
    trained = _serve_schemes(small, restored, prompts, "serve-trained",
                             device)
    del restored
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    init = _serve_schemes(small, init_params(small, seed=0, device=device),
                          prompts, "serve-init", device)
    for name in trained:
        for label, r in (("trained", trained[name]), ("init", init[name])):
            say(f"[serve-6] {name} {label}: decode miss rate "
                f"{r['miss_rate']:.4f} ({r['misses']} of {r['accesses']}), "
                f"energy {r['energy_j']!r} J, latency {r['latency_s']!r} s "
                f"(cost model); K1/K2 launches {r['launches']}; wall "
                f"{r['wall']:.2f} s")


def phase_profile(engine, new_requests, wall_step_s):
    """A second round of the same traffic on the warm engine with its
    decode steps under ``torch.profiler``: device kernel time and launches
    per step, the engine's host ranges, and the device's busy share of the
    unprofiled decode step (``wall_step_s``, from the main run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig)

    sched = ContinuousBatchingScheduler(engine, SchedulerConfig(max_batch=4),
                                        device="cuda")
    for req in new_requests(8):
        sched.submit(req)
    sched._admit()                  # the prefills stay outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched.run()
        torch.cuda.synchronize()
    n = len(sched.wall_step_s)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side events, less the engine's own ranges (the profiler also
    # places those on the device timeline, spanning their kernels).
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not e.key.startswith("slicemoe.")]
    k_ms = sum(dev_us(e) for e in kern) / 1e3 / n
    launches = sum(e.count for e in kern) / n
    say(f"[profile] {n} decode steps of 4 sequences: kernels {k_ms:.2f} ms "
        f"and {launches:.0f} launches per step; device busy "
        f"{k_ms / 1e3 / wall_step_s:.1%} of the unprofiled median step "
        f"({wall_step_s * 1e3:.1f} ms wall)")
    for e in events:
        if e.key.startswith("slicemoe.") and e.cpu_time_total > 0:
            say(f"[profile] host range {e.key}: "
                f"{e.cpu_time_total / 1e3 / e.count:.1f} ms per call "
                f"(profiler on)")
    for e in sorted(kern, key=dev_us, reverse=True)[:12]:
        say(f"[profile] {dev_us(e) / 1e3 / n:8.3f} ms/step "
            f"{e.count / n:6.1f} launches/step  {e.key[:80]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    name, count, _ = phase_device()
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen15-moe-a2.7b")
    phase_build()
    timings = phase_kernels(cfg)
    timings.update(phase_slice_kernels(cfg))
    phase_sweep_splits(cfg)
    launches = phase_slice_path(cfg)
    launches.update(phase_f32_path(cfg))
    launches.update(phase_small_reference())
    serve_launches, engine, new_requests, wall_step, params, prompts, p5 = \
        phase_serving(cfg)
    launches.update(serve_launches)     # k_major and output_major
    if "--profile" in sys.argv[1:]:
        phase_profile(engine, new_requests, wall_step)
    # Phase 5b builds its engine over the same params: release phase 5's
    # codes and caches first, so the peak stays near phase 5's.
    del engine, new_requests
    _release()
    phase_serving_async(cfg, params, prompts, p5)
    # Phase 7 serves phase 5's params again, one engine at a time, each
    # released before the next is built.
    for phase in (phase_ep_placement, phase_controller_int8):
        _release()
        phase(cfg, params, prompts, p5)
    _release()
    phase_long_prefill(cfg, params, p5)
    # Phase 6 trains and serves a model of its own: release the params.
    del params, prompts
    _release()
    phase_train_serve(cfg)
    amat_src = "src/repro_torch/kernels/amat_matmul/csrc/amat_batched_matmul.cu"
    kernels = []
    for variant, key, source, replaces in (
            ("amat_batched_matmul (wi, K-major codes)", "k_major", amat_src,
             "src/repro/kernels/amat_matmul/kernel.py:225"),
            ("amat_batched_matmul_t (wo, output-major codes)",
             "output_major", amat_src,
             "src/repro/kernels/amat_matmul/kernel.py:234"),
            ("amat_batched_matmul, f32 x (three exact bf16 planes)",
             "k_major_f32", amat_src,
             "src/repro/kernels/amat_matmul/kernel.py:225"),
            ("amat_batched_matmul_t, f32 x (three exact bf16 planes)",
             "output_major_f32", amat_src,
             "src/repro/kernels/amat_matmul/kernel.py:234"),
            ("amat_matmul (one matrix, static precision)", "single",
             amat_src, "src/repro/kernels/amat_matmul/kernel.py:101"),
            ("amat_matmul, f32 x (three exact bf16 planes)", "single_f32",
             amat_src, "src/repro/kernels/amat_matmul/kernel.py:101"),
            ("expert_matmul (per-expert sliced, K-major codes)", "expert",
             amat_src, "src/repro/kernels/expert_matmul/kernel.py:81"),
            ("flash_attention (causal GQA, sliding window)", "flash",
             "src/repro_torch/kernels/flash_attn/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attn/kernel.py:115"),
            ("flash_attention, f32 inputs (3xTF32)", "flash_f32",
             "src/repro_torch/kernels/flash_attn/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attn/kernel.py:115")):
        t = timings[key]
        kernels.append({
            "name": variant, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "graph_ms": t["graph_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_graph_ms": t["library_graph_ms"]})
    say(smi_name_power())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
