"""Serving entry point (port of ``repro.launch.serve``):
``python -m repro_torch.launch.serve --arch qwen15-moe-repro``.

Boots a model (fresh-init or checkpoint) on one device, ``cuda`` unless
``--device`` says otherwise, wraps it in the SliceMoE server and runs a
batch of synthetic requests through the full offload-simulated pipeline,
printing per-request latency/energy as JSON lines with the reference's
keys.

The parameters come from ``--ckpt`` (a checkpoint either package wrote,
restored onto ``--device``) or from the port's own init,
``init_params(cfg, seed=--seed)``: a different tree from the reference's
``init_params(cfg, jax.random.PRNGKey(seed))``, so the two CLIs serve
different weights for one seed.  Like the reference, the CLI builds its
``RoutingPolicy`` without ``quant_execution``: it serves on the
dense-dequant path, and the AMAT kernels run only where an engine is
built with ``quant_execution=True``.

Trace tooling (repro_torch.sim):

* ``--record-trace PATH``: additionally capture the served traffic's
  routing trace (``.npz`` or ``.jsonl``) for offline replay/autotuning.
* ``--replay-trace PATH``: skip the model entirely: replay a recorded
  trace (of either package) through the model-free simulator under THIS
  command line's engine knobs (``--cache-mb``, ``--miss-target``,
  ``--warmup``, ``--slice-mode``, ``--high-bits``/``--low-bits``,
  ``--routing``, ``--theta``, ``--system``, ...) and print the simulated
  report as JSON.

Observability (repro_torch.obs):

* ``--trace-out PATH``: export the charge-path timeline as Chrome-trace
  JSON (per-shard channel tracks + request spans); open in Perfetto.
  Works on both the live and ``--replay-trace`` paths, and the two
  exports are event-identical for the same trace.
* ``--metrics-out PATH`` / ``--prom-out PATH``: per-decode-step metrics
  registry time series (JSONL) / final Prometheus text.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.configs.base import get_config
from repro_torch.core.amat import MatConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.models.moe import RoutingPolicy
from repro_torch.serving.server import Request, SliceMoEServer


# One CLI-flag -> engine-knob mapping serves both the live path (with
# defaults applied) and the replay path (explicitly-passed flags only,
# so an untouched flag replays the trace's *recorded* value).  Flags
# default to None in argparse; the live defaults live here.
DEFAULT_KNOBS = {
    "high_bits": 8, "low_bits": 4, "cache_bytes": 4.0e6,
    "policy_kind": "cache_prior", "slice_mode": "dbsc", "theta": 0.5,
    "fetch_lsb_on_miss": True,
    "miss_rate_target": 0.05, "warmup": "pcw", "async_io": False,
    "lsb_keep_frac": 0.125, "system": "mobile_soc", "fused_slices": False,
    "hotness_request_decay": 0.5,
    "ep_shards": 1, "controller": None,
    "prefetch_top_m": None, "prefetch_kind": "request",
    "prefetch_lookahead": 2, "prefetch_min_obs": 0,
    "prefetch_min_score": 0.02,
    "placement": "round_robin", "placement_period": 64, "replicate_k": 0,
}


def parse_controller(spec):
    """``--controller`` value -> ControllerConfig.

    Accepts inline JSON (a string starting with ``{``) or a path to a
    JSON file; either way the payload is a
    :class:`repro_torch.control.ControllerConfig` dict, e.g.
    ``{"slos": {"premium": {"miss_rate": 0.05}}}``.
    """
    if spec is None:
        return None
    from repro_torch.control import ControllerConfig

    if spec.lstrip().startswith("{"):
        payload = json.loads(spec)
    else:
        with open(spec) as f:
            payload = json.load(f)
    return ControllerConfig.from_dict(payload)


def cli_engine_knobs(args) -> dict:
    """Engine knob values from the CLI; None where the flag was unset."""
    return {
        "high_bits": args.high_bits,
        "low_bits": args.low_bits,
        "cache_bytes": (None if args.cache_mb is None
                        else args.cache_mb * 1e6),
        "policy_kind": args.routing,
        "slice_mode": args.slice_mode,
        "theta": args.theta,
        "fetch_lsb_on_miss": args.fetch_lsb_on_miss,
        "miss_rate_target": args.miss_target,
        "warmup": args.warmup,
        "async_io": args.async_io,
        "lsb_keep_frac": args.lsb_keep_frac,
        "system": args.system,
        "fused_slices": args.fused_slices,
        "hotness_request_decay": args.hotness_request_decay,
        "ep_shards": args.ep_shards,
        "controller": parse_controller(args.controller),
        "prefetch_top_m": args.prefetch_top_m,
        "prefetch_kind": args.prefetch_kind,
        "prefetch_lookahead": args.prefetch_lookahead,
        "prefetch_min_obs": args.prefetch_min_obs,
        "prefetch_min_score": args.prefetch_min_score,
        "placement": args.placement,
        "placement_period": args.placement_period,
        "replicate_k": args.replicate_k,
    }


def build_engine_config(args) -> EngineConfig:
    k = {key: (DEFAULT_KNOBS[key] if v is None else v)
         for key, v in cli_engine_knobs(args).items()}
    return EngineConfig(
        mat=MatConfig(k["high_bits"], k["low_bits"]),
        cache_bytes=k["cache_bytes"],
        policy=RoutingPolicy(kind=k["policy_kind"],
                             slice_mode=k["slice_mode"],
                             theta=k["theta"],
                             fetch_lsb_on_miss=k["fetch_lsb_on_miss"]),
        miss_rate_target=k["miss_rate_target"],
        warmup=k["warmup"],
        async_io=k["async_io"],
        lsb_keep_frac=k["lsb_keep_frac"],
        system=k["system"],
        fused_slices=k["fused_slices"],
        hotness_request_decay=k["hotness_request_decay"],
        ep_shards=k["ep_shards"],
        controller=k["controller"],
        prefetch_top_m=k["prefetch_top_m"],
        prefetch_kind=k["prefetch_kind"],
        prefetch_lookahead=k["prefetch_lookahead"],
        prefetch_min_obs=k["prefetch_min_obs"],
        prefetch_min_score=k["prefetch_min_score"],
        placement=k["placement"],
        placement_period=k["placement_period"],
        replicate_k=k["replicate_k"],
    )


def run_replay(args) -> None:
    """Model-free path: replay a recorded trace.

    Knobs the user passed explicitly override the trace's recorded
    config; everything else replays as recorded — so a bare
    ``--replay-trace t.npz`` reproduces the live run exactly.
    """
    from repro_torch.sim import Trace
    from repro_torch.sim.replay import ReplayEngine

    trace = Trace.load(args.replay_trace)
    overrides = {key: v for key, v in cli_engine_knobs(args).items()
                 if v is not None}
    eng = ReplayEngine(trace.meta, **overrides)
    if args.trace_out:
        from repro_torch.obs import TimelineTracer

        eng.attach_tracer(TimelineTracer())
    eng.consume_all(trace.events)
    report = eng.finish()
    if args.trace_out:
        eng.export_trace(args.trace_out)
    out = {
        "trace": args.replay_trace,
        "model": trace.meta.model,
        "overrides": {key: (v.to_dict() if hasattr(v, "to_dict") else v)
                      for key, v in overrides.items()},
        **report.summary(),
        "epoch_miss": [
            {"epoch": label, "miss_rate": round(m, 6)}
            for label, m in report.epoch_miss],
    }
    if args.trace_out:
        out["trace_out"] = args.trace_out
    print(json.dumps(out, indent=2))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen15-moe-repro")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--n-requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    # Engine knobs default to None so the replay path can tell "flag
    # passed" from "defaulted"; live serving applies DEFAULT_KNOBS.
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="DRAM cache budget in MB (live default 4.0)")
    ap.add_argument("--routing", default=None,
                    choices=["topk", "cache_prior", "cumsum"])
    ap.add_argument("--slice-mode", default=None,
                    choices=["dbsc", "highbit", "lowbit", "amat_static"])
    ap.add_argument("--warmup", default=None,
                    choices=["pcw", "empty", "last_layer", "random"])
    ap.add_argument("--high-bits", type=int, default=None)
    ap.add_argument("--low-bits", type=int, default=None)
    ap.add_argument("--theta", type=float, default=None)
    ap.add_argument("--fetch-lsb-on-miss",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="fetch the LSB slice on an LSB miss; "
                         "--no-fetch-lsb-on-miss degrades the expert to "
                         "MSB-only compute instead (live default: fetch)")
    ap.add_argument("--miss-target", type=float, default=None,
                    help="miss-rate constraint (live default 0.05)")
    ap.add_argument("--lsb-keep-frac", type=float, default=None,
                    help="fraction of experts whose LSB slice PCW warmup "
                         "retains (live default 0.125)")
    ap.add_argument("--system", default=None,
                    help="hardware system profile from repro_torch.hw.specs."
                         "SYSTEM_PROFILES (live default 'mobile_soc')")
    ap.add_argument("--fused-slices",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="whole-expert caching: move MSB+LSB together "
                         "(high-bit baseline; live default: split slices)")
    ap.add_argument("--hotness-request-decay", type=float, default=None,
                    help="cross-request hotness aging factor applied at "
                         "each request boundary, 1.0 = never forget "
                         "(live default 0.5)")
    ap.add_argument("--async-io", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="asynchronous slice-I/O decode timeline "
                         "(live default: serialized; --no-async-io "
                         "forces a recorded async trace back to the "
                         "serialized replay)")
    ap.add_argument("--ep-shards", type=int, default=None,
                    help="expert-parallel shards: partition experts and "
                         "their DRAM slice caches round-robin across "
                         "this many shards, charging all-to-all token "
                         "dispatch on the interconnect channel (live "
                         "default 1 = single device)")
    ap.add_argument("--placement", default=None,
                    help="expert placement policy across EP shards: "
                         "'round_robin' (live default; expert %% shards), "
                         "'hotness' (greedy balanced bin-packing by "
                         "observed hotness, periodically re-placed with "
                         "migration charged on the interconnect), or "
                         "'hotness+replicate:K' (additionally replicate "
                         "the K hottest experts on every shard)")
    ap.add_argument("--placement-period", type=int, default=None,
                    help="decode steps between hotness re-placements "
                         "(live default 64; ignored by round_robin)")
    ap.add_argument("--replicate-k", type=int, default=None,
                    help="replicate the K globally hottest experts on "
                         "every shard (requires --placement hotness; "
                         "live default 0)")
    ap.add_argument("--prefetch-top-m", type=int, default=None,
                    help="enable speculative slice prefetch: max fills "
                         "issued per routed layer (live default: off)")
    ap.add_argument("--prefetch-kind", default=None,
                    choices=["request", "transition"],
                    help="predictor: 'request' = sparsity-aware "
                         "request-level activation predictor (default), "
                         "'transition' = one-step Markov baseline")
    ap.add_argument("--prefetch-lookahead", type=int, default=None,
                    help="request predictor: how many layer executions "
                         "ahead to score candidates (live default 2)")
    ap.add_argument("--prefetch-min-obs", type=int, default=None,
                    help="confidence gate: observations a target layer "
                         "needs before its candidates issue")
    ap.add_argument("--prefetch-min-score", type=float, default=None,
                    help="request predictor: activation-share floor "
                         "under the confidence-weighted admission gate "
                         "(live default 0.02)")
    ap.add_argument("--controller", default=None, metavar="JSON|PATH",
                    help="enable the closed-loop SLO controller "
                         "(repro_torch.control): inline ControllerConfig JSON "
                         "or a path to a JSON file, e.g. "
                         "'{\"slos\": {\"default\": "
                         "{\"miss_rate\": 0.05}}}'.  Applies to live "
                         "serving and (as an override) to --replay-trace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="save the served traffic's routing trace "
                         "(.npz or .jsonl) for offline replay")
    ap.add_argument("--replay-trace", default=None, metavar="PATH",
                    help="model-free: replay a recorded trace under this "
                         "command line's engine knobs and print the "
                         "simulated report (no model is built)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the run's charge-path timeline as "
                         "Chrome-trace JSON (open in Perfetto / "
                         "chrome://tracing); works for live serving and "
                         "--replay-trace")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the per-decode-step metrics registry "
                         "time series as JSONL (live serving only)")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the final metrics registry state in "
                         "Prometheus text exposition format (live "
                         "serving only)")
    # The port's own flag; not an engine knob.
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.replay_trace:
        run_replay(args)
        return

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    if args.ckpt:
        params = CKPT.restore(args.ckpt, dev)["params"]
    else:
        params = init_params(cfg, seed=args.seed, device=dev)

    max_seq = args.prompt_len + args.max_new + 8
    server = SliceMoEServer(
        cfg, params,
        engine_cfg=build_engine_config(args) if cfg.has_moe else None,
        max_seq=max_seq, device=dev)

    recorder = None
    if args.record_trace:
        from repro_torch.sim import TraceRecorder

        recorder = server.attach_recorder(TraceRecorder())

    tracer = None
    if args.trace_out:
        from repro_torch.obs import TimelineTracer

        tracer = server.attach_tracer(TimelineTracer())
    metrics = None
    if args.metrics_out or args.prom_out:
        from repro_torch.obs import MetricsRegistry

        metrics = server.attach_metrics(MetricsRegistry())

    rng = np.random.default_rng(args.seed)
    for rid in range(args.n_requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=args.prompt_len).astype(np.int32)
        server.submit(Request(request_id=rid, prompt=prompt,
                              max_new_tokens=args.max_new))

    for c in server.run():
        line = {
            "request": c.request_id,
            "n_tokens": int(len(c.tokens)),
            "prefill_s": round(c.prefill_s, 3),
            "decode_s": round(c.decode_s, 3),
        }
        if c.metrics is not None:
            d = c.metrics["decode_totals"]
            line["sim_decode_energy_mJ"] = round(d["total_energy_j"] * 1e3, 3)
            line["sim_decode_latency_ms"] = round(
                d["total_latency_s"] * 1e3, 3)
            line["miss_rate"] = round(
                c.metrics["cache_stats"]["msb_misses"]
                / max(c.metrics["cache_stats"]["msb_hits"]
                      + c.metrics["cache_stats"]["msb_misses"], 1), 4)
        print(json.dumps(line))

    engine = getattr(server, "_engine", None)
    if engine is not None \
            and getattr(engine, "prefetcher", None) is not None:
        print(json.dumps({"prefetch": engine.prefetcher.summary()}))
    if engine is not None \
            and getattr(engine, "slo_controller", None) is not None:
        print(json.dumps(
            {"controller": engine.slo_controller.summary()}))
    if engine is not None and hasattr(engine, "shard_breakdown"):
        breakdown = engine.shard_breakdown()
        if breakdown is not None:
            print(json.dumps({"per_shard": [
                {k: round(v, 6) if isinstance(v, float) else v
                 for k, v in row.items() if k != "experts"}
                for row in breakdown]}))
            snap = engine.ledger.snapshot()
            print(json.dumps({
                "all_to_all_bytes": snap["ici_bytes"],
                "all_to_all_energy_mJ": round(
                    snap["ici_energy_j"] * 1e3, 6)}))
    if engine is not None and hasattr(engine, "placement_summary"):
        psum = engine.placement_summary()
        if psum is not None:
            print(json.dumps({"placement": psum}))

    if recorder is not None:
        tr = recorder.trace()
        path = tr.save(args.record_trace)
        print(json.dumps({"recorded_trace": path,
                          "n_prefills": tr.n_prefills,
                          "n_decode_steps": tr.n_decode_steps}))

    if tracer is not None:
        data = server.export_trace(args.trace_out)
        print(json.dumps({"trace_out": args.trace_out,
                          "n_trace_events": len(tracer.events),
                          "n_spans": len(tracer.spans),
                          "n_json_events": len(data["traceEvents"])}))
    if metrics is not None:
        if args.metrics_out:
            metrics.to_jsonl(args.metrics_out)
            print(json.dumps({"metrics_out": args.metrics_out,
                              "n_samples": len(metrics.series)}))
        if args.prom_out:
            with open(args.prom_out, "w") as f:
                f.write(metrics.prometheus_text())
            print(json.dumps({"prom_out": args.prom_out}))


if __name__ == "__main__":
    main()
