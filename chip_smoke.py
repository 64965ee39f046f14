"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernel) and ``nvcc``; builds
every kernel of the main path from the sources in this checkout.  Phases,
each printing as it goes, any failure exiting non-zero:

1. device: the card's name, count and power limit;
2. build: the kernel library, with the ptxas register / shared-memory /
   spill report;
3. kernels against their plain PyTorch versions on the card (tolerance
   1e-4 + 1e-4*|plain|: f32 accumulation in another order): both code
   layouts with the bf16 activations the main path gives them at its
   decode (4 sequences) and prefill (128 tokens) capacities, with f32
   activations at the decode capacity, and a ragged case; the decode
   shapes are then timed with CUDA events beside the plain version, one
   ``torch.bmm`` on pre-dequantized f32 weights (the nearest library
   call; it reads dense f32 weights, not the packed codes) and the card's
   bound.  The kernels line reports the bf16 decode variant, the one the
   decode steps launch;
4. a small reference check: the qwen15-moe-repro model (2 layers, f32)
   served on the card through the kernel and on the CPU through the
   plain dense-dequant path must agree (tokens exact, logits 1e-4);
5. serving at full width: Qwen1.5-MoE-A2.7B (24 layers, d_model 2048,
   60 experts, bf16, random weights from seed 0), cache-prior + DBSC
   routing with quantized execution, 4 requests of 128 prompt tokens and
   16 new tokens through the continuous-batching scheduler; the kernel's
   launch count must be 2 x 24 x (prefills + decode steps) and every
   logit finite.

``--profile`` adds a sixth phase: a second round of the same traffic
with its decode steps under ``torch.profiler`` (device time and launches
per step by kernel, the engine's host ranges, the device's busy share).  The run the driver makes has no flag.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' JSON record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Card peaks (NVIDIA H100 SXM data sheet) for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

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
    from repro_torch.kernels._build import build_library
    from repro_torch.kernels.amat_matmul.ops import SOURCE

    t0 = time.perf_counter()
    lib, log = build_library(SOURCE, force=True)
    say(f"[build] {os.path.relpath(SOURCE, HERE)} -> "
        f"{os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers",
                                   "spill", "smem")):
            say("[build]   " + line.strip())


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


def phase_kernels(cfg):
    """Each variant of the kernel against its plain version at the shapes
    the main path gives it, then timed.  The main path runs bf16
    activations (the model's dtype) at the decode capacity (4 sequences)
    and the prefill capacity (128 tokens); the f32 rows are the
    reference's own kernel check.  Returns, per code layout, the timings of
    the bf16 decode variant and the largest error over all its rows."""
    from repro_torch.kernels.amat_matmul import ops
    from repro_torch.kernels.amat_matmul.ref import (
        _dequant_mixed_ref, amat_batched_matmul_ref, amat_batched_matmul_t_ref)
    from repro_torch.models.moe import capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg.moe
    m_dec = capacity(4, m.top_k, m.n_experts, m.capacity_factor)
    m_pre = capacity(128, m.top_k, m.n_experts, m.capacity_factor)
    wi = (m.n_experts, cfg.d_model, 2 * m.d_ff)         # (E, K, N)
    wo = (m.n_experts, m.d_ff, cfg.d_model)
    f32, bf16 = torch.float32, torch.bfloat16
    variants = [
        # name, layout, transposed, x dtype, (E, M, K, N), timed, reported
        ("wi_f32_decode", "k_major", False, f32, (wi[0], m_dec, *wi[1:]),
         True, False),
        ("wo_t_f32_decode", "output_major", True, f32,
         (wo[0], m_dec, *wo[1:]), True, False),
        ("wi_bf16_decode", "k_major", False, bf16, (wi[0], m_dec, *wi[1:]),
         True, True),
        ("wo_t_bf16_decode", "output_major", True, bf16,
         (wo[0], m_dec, *wo[1:]), True, True),
        ("wi_bf16_prefill", "k_major", False, bf16, (wi[0], m_pre, *wi[1:]),
         False, False),
        ("wo_t_bf16_prefill", "output_major", True, bf16,
         (wo[0], m_pre, *wo[1:]), False, False),
        ("ragged_wi_f32", "k_major", False, f32, (3, 5, 96, 72), False,
         False),
        ("ragged_wo_t_f32", "output_major", True, f32, (3, 5, 96, 72), False,
         False),
    ]
    results = {"k_major": {"max_abs_err": 0.0},
               "output_major": {"max_abs_err": 0.0}}
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

        got = kern()
        want = plain()
        torch.cuda.synchronize()
        if got.shape != (E, M, N) or not bool(torch.isfinite(got).all()):
            fail(f"kernel {name}: bad output {tuple(got.shape)}")
        err = (got - want).abs()
        max_err = float(err.max())
        ok = bool((err <= TOL_ABS + TOL_REL * want.abs()).all())
        say(f"[kernel] {name} E={E} M={M} K={K} N={N}: max|kernel-plain| = "
            f"{max_err:.3e} (tol 1e-4 + 1e-4*|plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"kernel {name} disagrees with its plain version")
        row = results[layout]
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        if timed:
            x, codes, scales, zps, use_lsb = args
            codes_kn = codes.transpose(1, 2) if transposed else codes
            w_dense = _dequant_mixed_ref(codes_kn, scales, zps, use_lsb,
                                         group_size=32, shift=4).contiguous()
            x32 = x.float()             # exact for bf16 x: the same function
            t = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
                 "library_ms": time_ms(lambda: torch.bmm(x32, w_dense))}
            del w_dense, x32
            nbytes = (codes.numel() + scales.numel() * 4 + zps.numel()
                      + x.numel() * x.element_size() + E * M * N * 4
                      + use_lsb.numel())
            flops = 2.0 * E * M * K * N
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOPS * 1e3
            t["bound_ms"] = max(t_bytes, t_ops)
            t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            say(f"[kernel] {name} timing: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, torch.bmm on dense f32 weights "
                f"{t['library_ms']:.4f} ms (reads {E * K * N * 4 / 1e6:.0f} "
                f"MB of f32 weights, not the {codes.numel() / 1e6:.0f} MB of "
                f"codes); bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            if reported:
                row.update(t)
        del args
        torch.cuda.empty_cache()
    return results


def phase_small_reference():
    """The kernel path on the card against the plain dense path on the
    CPU, end to end through the engine, on a small input."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig, SliceMoEEngine
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import RoutingPolicy

    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 24))
    out = {}
    for dev, qe in (("cpu", False), ("cuda", True)):
        eng = SliceMoEEngine(cfg, params, EngineConfig(
            mat=MatConfig(8, 4), cache_bytes=50e6,
            policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                                 quant_execution=qe),
            miss_rate_target=0.05, warmup="pcw", max_seq=48), device=dev)
        logits = eng.prefill(prompt)
        toks, metrics = eng.decode(torch.argmax(logits, -1), 6)
        out[dev] = (logits.cpu(), toks.cpu(), metrics["cache_stats"])
    lerr = float((out["cpu"][0] - out["cuda"][0]).abs().max())
    same_tokens = bool(torch.equal(out["cpu"][1], out["cuda"][1]))
    same_stats = out["cpu"][2] == out["cuda"][2]
    say(f"[reference] qwen15-moe-repro (2 layers, f32): kernel on the card vs "
        f"plain dense path on the CPU: prefill logits max diff {lerr:.2e}, "
        f"tokens equal {same_tokens}, cache stats equal {same_stats}")
    if not (lerr <= 1e-4 and same_tokens and same_stats):
        fail("small-input reference check")


def phase_serving(cfg, device: str = "cuda"):
    from repro_torch.core.amat import MatConfig, slice_nbytes
    from repro_torch.core.engine import EngineConfig, PersistentEngine
    from repro_torch.kernels.amat_matmul import ops
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import RoutingPolicy
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request, SchedulerConfig)

    class CheckedEngine(PersistentEngine):
        """Records on the card whether every logit it returns is finite."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.all_finite = torch.ones((), dtype=torch.bool,
                                         device=self.device)

        def run_prefill(self, tokens, **kw):
            logits, kv, info = super().run_prefill(tokens, **kw)
            self.all_finite &= torch.isfinite(logits).all()
            return logits, kv, info

        def decode_batch(self, token, kv_cache, **kw):
            logits, kv, charge = super().decode_batch(token, kv_cache, **kw)
            self.all_finite &= torch.isfinite(logits).all()
            return logits, kv, charge

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    mat = MatConfig(8, 4)
    m = cfg.moe
    per_expert = sum(
        slice_nbytes(shape, mat.high_bits, mat.group_size, which=w,
                     shift=mat.shift)
        for shape in ((cfg.d_model, 2 * m.d_ff), (m.d_ff, cfg.d_model))
        for w in ("msb", "lsb"))
    store_bytes = per_expert * cfg.n_layers * m.n_experts
    prompt_len, new_tokens, n_req = 128, 16, 4

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    sync()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    ecfg = EngineConfig(
        mat=mat, cache_bytes=store_bytes / 4,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=True),
        miss_rate_target=0.05, warmup="pcw",
        max_seq=prompt_len + new_tokens + 1)
    t0 = time.perf_counter()
    engine = CheckedEngine(cfg, params, ecfg, device=device)
    sync()
    t_quant = time.perf_counter() - t0
    if engine.store.total_bytes() != store_bytes:
        fail("slice store size differs from its analytic size")
    say(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{m.n_experts} experts top-{m.top_k}, {n_params / 1e9:.2f} B params "
        f"in {cfg.dtype}; init {t_init:.1f} s, AMAT quantization "
        f"{t_quant:.1f} s; slice cache {ecfg.cache_bytes / 1e9:.3f} GB "
        f"(a quarter of the {store_bytes / 1e9:.3f} GB store)")

    rng = np.random.default_rng(0)
    sched = ContinuousBatchingScheduler(
        engine, SchedulerConfig(max_batch=4), device=device)
    for i in range(n_req):
        sched.submit(Request(
            request_id=i,
            prompt=rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32),
            max_new_tokens=new_tokens))

    sync()
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    completions = sched.run()
    sync()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES.by_layout)

    def new_requests(n_new):
        return [Request(request_id=100 + i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            prompt_len).astype(np.int32),
                        max_new_tokens=n_new) for i in range(n_req)]

    n_prefill, n_steps = len(sched.wall_prefill_s), len(sched.wall_step_s)
    for c in sorted(completions, key=lambda c: c.request_id):
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
    say(f"[serve] {n_prefill} prefills, {n_steps} decode steps, wall "
        f"{wall:.2f} s; wall per prefill (s) "
        f"{[round(s, 4) for s in sched.wall_prefill_s]}; wall per decode "
        f"step: median {np.median(sched.wall_step_s):.4f} s, "
        f"min {min(sched.wall_step_s):.4f} s, max "
        f"{max(sched.wall_step_s):.4f} s")
    if on_card:
        say(f"[serve] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    summary = sched.summary()
    say(f"[serve] fleet: {summary['n_tokens']} tokens, mean miss rate "
        f"{summary['mean_miss_rate']:.4f}, steady-state miss rate "
        f"{summary['steady_state_miss_rate']:.4f}")
    want = cfg.n_layers * (n_prefill + n_steps)
    say(f"[serve] kernel launches: {launches} (want {want} each, "
        f"{2 * want} in all)")
    if len(completions) != n_req or any(
            len(c.tokens) != new_tokens for c in completions):
        fail("not every request was served in full")
    if on_card and (launches["k_major"] != want
                    or launches["output_major"] != want):
        fail("the main path did not launch the kernel once per MoE layer "
             "projection per forward pass")
    if not bool(engine.all_finite):
        fail("non-finite logits")
    return launches, engine, new_requests, float(np.median(sched.wall_step_s))


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


def main() -> None:
    name, count, _ = phase_device()
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen15-moe-a2.7b")
    phase_build()
    timings = phase_kernels(cfg)
    phase_small_reference()
    launches, engine, new_requests, wall_step = phase_serving(cfg)
    if "--profile" in sys.argv[1:]:
        phase_profile(engine, new_requests, wall_step)
    kernels = []
    for variant, layout, replaces in (
            ("amat_batched_matmul (wi, K-major codes)", "k_major",
             "src/repro/kernels/amat_matmul/kernel.py:225"),
            ("amat_batched_matmul_t (wo, output-major codes)",
             "output_major", "src/repro/kernels/amat_matmul/kernel.py:234")):
        t = timings[layout]
        kernels.append({
            "name": variant, "route": "cuda",
            "source": "src/repro_torch/kernels/amat_matmul/csrc/"
                      "amat_batched_matmul.cu",
            "replaces": replaces, "launches": launches[layout],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    say(smi_name_power())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
