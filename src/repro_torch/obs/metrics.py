"""Low-overhead metrics registry: counters, gauges, histograms (port of
``repro.obs.metrics``).

One :class:`MetricsRegistry` per serving run.  Instruments are created
lazily (``registry.counter("tokens_total")``) and cached by name +
labels, so the hot path is attribute arithmetic on a resolved object —
no dict lookups per event once the caller holds the instrument.

Two export formats, both schema-stable:

* **JSONL time series** — :meth:`MetricsRegistry.sample` appends one
  flat row (every scalar instrument, histograms as ``_count``/``_sum``)
  per decode step; :meth:`MetricsRegistry.to_jsonl` writes the series.
* **Prometheus text exposition** — :meth:`MetricsRegistry.prometheus_text`
  renders the current values with ``# HELP`` / ``# TYPE`` headers and
  cumulative histogram buckets, scrape-ready.

:class:`MetricsSampler` is the serving-stack glue: a
:class:`~repro_torch.serving.telemetry.FleetTelemetry` listener that folds
each :class:`~repro_torch.serving.telemetry.StepRecord` into the registry and
samples engine-side state (cache occupancy, ledger traffic, prefetch
outcomes, controller actuation, shard balance) per decode step —
replacing ad-hoc per-consumer snapshot plumbing with one catalog (see
docs/observability.md).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsSampler", "DEFAULT_BUCKETS"]

#: Default histogram buckets (seconds-flavored, log-ish spacing).
DEFAULT_BUCKETS = (1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
                   1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                   1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0)


def _label_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically non-decreasing accumulator."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative inc {v}")
        self.value += v

    def set_to(self, v: float) -> None:
        """Monotonic set from a cumulative upstream total (e.g. a ledger
        accumulator) — refuses to go backwards."""
        if v < self.value:
            raise ValueError(
                f"counter {self.name}: set_to({v}) < current {self.value}")
        self.value = v


class Gauge:
    """Point-in-time value (may move in either direction)."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Fixed-bucket histogram with ``sum``/``count`` (Prometheus model)."""

    __slots__ = ("name", "labels", "buckets", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, str],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if math.isnan(v):
            return
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                break

    def cumulative(self) -> List[Tuple[float, int]]:
        """``(le, cumulative_count)`` rows, exposition-ready."""
        out, acc = [], 0
        for le, c in zip(self.buckets, self.counts):
            acc += c
            out.append((le, acc))
        return out


class MetricsRegistry:
    """Name → instrument registry with a sampled JSONL time series."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._families: Dict[str, str] = {}   # family name -> kind
        self._help: Dict[str, str] = {}
        self.series: List[dict] = []

    # ------------------------------------------------------------ create
    def _get(self, cls, name: str, help: str, labels: Dict[str, str],
             **kw):
        key = _label_key(name, labels)
        inst = self._metrics.get(key)
        if inst is None:
            kind = self._families.setdefault(name, cls.kind)
            if kind != cls.kind:
                raise TypeError(
                    f"metric {name!r} already registered as {kind}")
            if help:
                self._help.setdefault(name, help)
            inst = cls(name, labels, **kw)
            self._metrics[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {key!r} is a {inst.kind}, "
                            f"not a {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """Flat ``{key: value}`` view of every instrument right now
        (histograms contribute ``_count`` and ``_sum``)."""
        out = {}
        for key, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[key + "_count"] = m.count
                out[key + "_sum"] = m.sum
            else:
                out[key] = m.value
        return out

    def sample(self, *, t: float, step: int) -> dict:
        """Append (and return) one time-series row at sim-time ``t``."""
        row = {"t": t, "step": step}
        row.update(self.snapshot())
        self.series.append(row)
        return row

    def to_jsonl(self, path: str) -> int:
        """Write the sampled series, one JSON object per line; returns
        the number of rows written."""
        with open(path, "w") as fh:
            for row in self.series:
                fh.write(json.dumps(row, sort_keys=True))
                fh.write("\n")
        return len(self.series)

    def prometheus_text(self) -> str:
        """Current values in the Prometheus text exposition format."""
        by_family: Dict[str, List[object]] = {}
        for m in self._metrics.values():
            by_family.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_family):
            help_ = self._help.get(name, "")
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {self._families[name]}")
            for m in sorted(by_family[name],
                            key=lambda m: sorted(m.labels.items())):
                if isinstance(m, Histogram):
                    for le, acc in m.cumulative():
                        lab = dict(m.labels, le=repr(le))
                        lines.append(f"{_label_key(name + '_bucket', lab)}"
                                     f" {acc}")
                    lab = dict(m.labels, le="+Inf")
                    lines.append(
                        f"{_label_key(name + '_bucket', lab)} {m.count}")
                    lines.append(f"{_label_key(name + '_sum', m.labels)}"
                                 f" {m.sum}")
                    lines.append(f"{_label_key(name + '_count', m.labels)}"
                                 f" {m.count}")
                else:
                    lines.append(f"{_label_key(name, m.labels)} {m.value}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# Serving-stack sampler
# --------------------------------------------------------------------------
class MetricsSampler:
    """FleetTelemetry listener that feeds a :class:`MetricsRegistry`.

    Registered via ``scheduler.attach_metrics(registry)``; per decode
    step it folds the :class:`StepRecord` into counters/histograms,
    reads cumulative engine-side state (ledger traffic via monotonic
    ``set_to``, cache occupancy, prefetch outcomes, controller
    actuation, shard balance) and appends one time-series row.
    """

    def __init__(self, registry: MetricsRegistry, engine=None):
        self.registry = registry
        self.engine = engine
        self._steps = 0
        # Last-seen values of upstream windows that may reset (the
        # cache stats window is wiped at request boundaries).
        self._prev: Dict[str, float] = {}
        r = registry
        self._c_steps = r.counter(
            "decode_steps_total", "decode steps executed")
        self._c_tokens = r.counter(
            "tokens_total", "tokens generated across the fleet")
        self._c_requests = r.counter(
            "requests_submitted_total", "requests submitted")
        self._c_first = r.counter(
            "requests_first_token_total", "requests that produced a token")
        self._c_energy = r.counter(
            "energy_joules_total", "modeled energy spent")
        self._c_latency = r.counter(
            "sim_latency_seconds_total", "simulated decode time spent")
        self._c_stall = r.counter(
            "io_stall_seconds_total", "compute idle time waiting on data")
        self._c_overlap = r.counter(
            "overlap_saved_seconds_total", "latency hidden by overlap")
        self._g_miss = r.gauge(
            "step_miss_rate", "cache miss rate of the last decode step")
        self._g_active = r.gauge(
            "batch_occupancy", "active sequences in the last decode step")
        self._h_step = r.histogram(
            "step_latency_seconds", "simulated decode-step latency")
        self._h_ttft = r.histogram(
            "ttft_seconds", "time to first token")

    # --------------------------------------------- telemetry callbacks
    def on_submit(self, record) -> None:
        self._c_requests.inc()

    def on_first_token(self, record) -> None:
        self._c_first.inc()
        self._h_ttft.observe(record.ttft)

    def on_step(self, step) -> None:
        r = self.registry
        self._steps += 1
        self._c_steps.inc()
        self._c_tokens.inc(step.n_active)
        self._c_energy.inc(max(0.0, step.energy_j))
        self._c_latency.inc(max(0.0, step.latency_s))
        self._c_stall.inc(max(0.0, step.io_stall_s))
        self._c_overlap.inc(max(0.0, step.overlap_saved_s))
        self._g_miss.set(step.miss_rate)
        self._g_active.set(step.n_active)
        self._h_step.observe(step.latency_s)
        for tenant, row in (step.per_tenant or {}).items():
            r.counter("tenant_tokens_total", "tokens per tenant",
                      tenant=tenant).inc(row.get("tokens", 0))
            r.gauge("tenant_step_miss_rate", "per-tenant step miss rate",
                    tenant=tenant).set(
                        row.get("misses", 0)
                        / max(row.get("accesses", 0), 1))
        if self.engine is not None:
            self._sample_engine(r)
        r.sample(t=step.t, step=self._steps - 1)

    # --------------------------------------------- engine-side sampling
    def _fold_window(self, counter: Counter, key: str, cur: float) -> None:
        """Accumulate an upstream counter that may reset to 0 between
        samples (Prometheus counter-reset semantics): on a drop, the
        current value counts from the reset, not from our last sample."""
        prev = self._prev.get(key, 0.0)
        counter.inc(cur - prev if cur >= prev else cur)
        self._prev[key] = cur

    def _sample_engine(self, r: MetricsRegistry) -> None:
        eng = self.engine
        cache = eng.cache
        u = cache.usage()
        r.gauge("cache_capacity_bytes",
                "slice-cache capacity").set(u["capacity_bytes"])
        r.gauge("cache_used_bytes",
                "resident slice bytes").set(u["used_bytes"])
        r.gauge("cache_resident_slices",
                "resident slice count").set(u["n_slices"])
        r.gauge("cache_occupancy",
                "used/capacity byte fraction").set(u["occupancy"])
        # usage() folds archived epochs in, but the serving engine also
        # hard-resets the open stats window at each prefill->decode
        # transition — fold deltas with counter-reset semantics.
        self._fold_window(r.counter("cache_accesses_total",
                                    "slice-cache accesses"),
                          "cache_accesses", u["accesses"])
        self._fold_window(r.counter("cache_misses_total",
                                    "slice-cache misses"),
                          "cache_misses", u["misses"])
        seg = getattr(cache, "segment_summary", None)
        if callable(seg):
            for tenant, row in seg().items():
                r.gauge("tenant_resident_bytes",
                        "resident bytes per tenant partition",
                        tenant=tenant).set(row["used_bytes"])
        per_shard = getattr(cache, "per_shard_counts", None)
        if callable(per_shard):
            counts = per_shard()
            accs = [a for a, _m in counts]
            if accs and max(accs) > 0:
                mean = sum(accs) / len(accs)
                r.gauge("shard_imbalance",
                        "max/mean shard access ratio").set(
                            max(accs) / mean if mean else 0.0)
        led = eng.ledger.snapshot()
        for key, name in (("flash_bytes", "flash_bytes_total"),
                          ("dram_bytes", "dram_bytes_total"),
                          ("ici_bytes", "ici_bytes_total"),
                          ("migration_bytes", "migration_bytes_total"),
                          ("prefetch_flash_bytes",
                           "prefetch_flash_bytes_total")):
            r.counter(name, f"ledger {key}").set_to(led[key])
        pf = getattr(eng, "prefetcher", None)
        if pf is not None:
            s = pf.summary()
            for key in ("issued", "useful", "late", "wasted"):
                r.counter(f"prefetch_{key}_total",
                          "prefetch outcome").set_to(s[key])
        ctl = getattr(eng, "slo_controller", None)
        if ctl is not None:
            r.counter("controller_actions_total",
                      "controller actuations").set_to(len(ctl.actions))
            for tenant, frac in ctl.admit_fracs.items():
                r.gauge("tenant_admit_frac", "admission fraction",
                        tenant=tenant).set(frac)
            for tenant, lvl in ctl.levels.items():
                r.gauge("tenant_bit_level", "controller bit level",
                        tenant=tenant).set(lvl)
            r.gauge("low_bit_fraction",
                    "fraction of tenants demoted below full bits").set(
                        ctl.low_bit_fraction())
