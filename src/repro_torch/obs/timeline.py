"""Timeline tracing: per-channel event capture + Chrome-trace export
(port of ``repro.obs.timeline``).

The cost model is an event timeline (:mod:`repro_torch.hw.energy`) — every
fill / dram_read / matmul / prefetch_fill / a2a / migrate charge issues
a ``(start, end)`` span on one hardware channel.  A
:class:`TimelineTracer` attached to the ledger captures exactly one
:class:`TraceEvent` per charge, stamped with the attribution context
the engine maintains while charging (layer, expert, slice kind, bits,
phase, decode-step index).  Because the tracer hangs off the shared
charge path, a record→replay run of the same trace emits an identical
event stream — live≡replay observability is by construction, not by a
second implementation.

The capture is export-agnostic; :func:`chrome_trace` renders the event
list (plus scheduler-emitted request spans) as Chrome-trace JSON that
loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.  See docs/observability.md for the schema.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Tuple

#: Stable thread-id per hardware channel inside a shard's process track.
CHANNEL_TIDS = {"flash": 0, "flash_bg": 1, "dram": 2, "compute": 3, "ici": 4}

#: Synthetic pids for the non-shard tracks in the Chrome export.
INTERCONNECT_PID = 900     # shared ici sub-ledger (shard id < 0)
REQUESTS_PID = 1000        # scheduler-emitted request / step spans

#: Event kinds a ledger can emit (the trace schema's closed vocabulary).
EVENT_KINDS = ("fill", "prefetch_fill", "dram_read", "matmul", "a2a",
               "migrate")


@dataclasses.dataclass
class TraceEvent:
    """One charge on one hardware channel.

    ``kind`` is one of :data:`EVENT_KINDS`; ``channel`` names the
    :class:`~repro_torch.hw.energy.ChannelTimeline` the span occupies
    (``flash``/``flash_bg``/``dram``/``compute``/``ici``); ``shard`` is
    the owning shard's index (``-1`` for the shared interconnect
    sub-ledger).  ``layer``/``expert``/``slice_kind``/``bits`` carry the
    attribution the engine set when it issued the charge (``-1``/empty
    for unattributed traffic such as the shared resident-weight
    stream); ``phase`` is ``prefill`` or ``decode`` and ``step`` the
    decode-step index (``-1`` before the first decode step).
    """

    kind: str
    channel: str
    shard: int
    start: float
    end: float
    nbytes: float = 0.0
    ops: float = 0.0
    bits: int = 0
    layer: int = -1
    expert: int = -1
    slice_kind: str = ""
    phase: str = ""
    step: int = -1

    def key(self) -> tuple:
        """Total-order comparison key (used by the equivalence gate)."""
        return (self.kind, self.channel, self.shard, self.start, self.end,
                self.nbytes, self.ops, self.bits, self.layer, self.expert,
                self.slice_kind, self.phase, self.step)


class TimelineTracer:
    """Event sink + attribution context for one engine's ledger(s).

    The ledger calls :meth:`emit` once per charge; the engine moves the
    attribution context (:meth:`begin_step` / :meth:`begin_prefill` /
    :meth:`set_attr`) as it walks layers and experts, so every emitted
    event is stamped with what the charge was *for*.  The scheduler adds
    request-lifecycle spans via :meth:`span`.  Overhead when no tracer
    is attached is a single ``is None`` test per charge.
    """

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []
        self.spans: List[dict] = []
        # mutable attribution context (engine-owned)
        self.phase = ""
        self.step = -1
        self.layer = -1
        self.expert = -1
        self.slice_kind = ""
        self.bits = 0

    # ------------------------------------------------------------ context
    def begin_step(self) -> int:
        """Enter the next decode step: bump the step index and clear the
        per-expert attribution.  Returns the new step index."""
        self.step += 1
        self.phase = "decode"
        self.layer = -1
        self.expert = -1
        self.slice_kind = ""
        self.bits = 0
        return self.step

    def begin_prefill(self) -> None:
        """Enter a prefill charge (attribution cleared, step unchanged)."""
        self.phase = "prefill"
        self.layer = -1
        self.expert = -1
        self.slice_kind = ""
        self.bits = 0

    def set_attr(self, layer: int = -1, expert: int = -1,
                 slice_kind: str = "", bits: int = 0) -> None:
        """Point the context at what is being charged next."""
        self.layer = layer
        self.expert = expert
        self.slice_kind = slice_kind
        self.bits = bits

    # ------------------------------------------------------------ capture
    def emit(self, kind: str, channel: str, shard: int,
             start: float, end: float, *, nbytes: float = 0.0,
             ops: float = 0.0, bits: Optional[int] = None) -> None:
        """Record one charge (called by the ledger, context pre-set)."""
        self.events.append(TraceEvent(
            kind, channel, shard, start, end, nbytes, ops,
            self.bits if bits is None else bits,
            self.layer, self.expert, self.slice_kind,
            self.phase, self.step))

    def span(self, name: str, track: str, start: float, end: float,
             **args) -> None:
        """Record one scheduler-level span (queue/prefill/decode/step)
        on a named track of the ``requests`` process."""
        self.spans.append({"name": name, "track": track,
                           "start": float(start), "end": float(end),
                           "args": dict(args)})

    def clear(self) -> None:
        self.events.clear()
        self.spans.clear()
        self.phase = ""
        self.step = -1
        self.layer = -1
        self.expert = -1
        self.slice_kind = ""
        self.bits = 0

    # ------------------------------------------------------------ queries
    def channel_makespans(self) -> Dict[Tuple[int, str], float]:
        """Latest event end per ``(shard, channel)`` — must equal that
        channel's ``busy_until`` clock (the makespan gate)."""
        out: Dict[Tuple[int, str], float] = {}
        for e in self.events:
            k = (e.shard, e.channel)
            if e.end > out.get(k, 0.0):
                out[k] = e.end
        return out

    def makespan(self) -> float:
        """Overall makespan over the demand channels (the background
        prefetch lane is excluded, mirroring ``CostLedger.now``)."""
        return max((e.end for e in self.events
                    if e.channel != "flash_bg"), default=0.0)


def events_equal(a: Iterable[TraceEvent], b: Iterable[TraceEvent]) -> bool:
    """Exact event-stream equality (the live≡replay gate)."""
    ka = [e.key() for e in a]
    kb = [e.key() for e in b]
    return ka == kb


def first_divergence(a: List[TraceEvent],
                     b: List[TraceEvent]) -> Optional[int]:
    """Index of the first differing event, or ``None`` if identical
    (length mismatch reports the shorter length)."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i].key() != b[i].key():
            return i
    if len(a) != len(b):
        return n
    return None


# ---------------------------------------------------------------- export
def _event_name(e: TraceEvent) -> str:
    who = "shared" if e.layer < 0 else (
        f"L{e.layer}" if e.expert < 0 else f"L{e.layer}.E{e.expert}")
    if e.slice_kind:
        who += f".{e.slice_kind}"
    if e.kind == "matmul":
        return f"matmul {e.bits}b {who}"
    return f"{e.kind} {who}"


def _event_pid(e: TraceEvent) -> int:
    return INTERCONNECT_PID if e.shard < 0 else e.shard


def chrome_trace(tracer: TimelineTracer) -> dict:
    """Render the captured events + spans as a Chrome-trace JSON dict.

    Layout: one process per shard (threads = hardware channels, the
    background prefetch lane on its own ``flash_bg`` thread so it is
    visually distinct from demand fills), one process for the shared
    interconnect, and one ``requests`` process whose threads are the
    scheduler's span tracks.  Timestamps are microseconds (Chrome-trace
    convention); all events are complete (``ph: "X"``) spans.
    """
    trace_events: List[dict] = []
    pids_seen: Dict[int, str] = {}
    tids_seen: Dict[Tuple[int, int], str] = {}

    for e in tracer.events:
        pid = _event_pid(e)
        tid = CHANNEL_TIDS[e.channel]
        pids_seen.setdefault(
            pid, "interconnect" if e.shard < 0 else f"shard {e.shard}")
        tids_seen.setdefault((pid, tid), e.channel)
        args = {"phase": e.phase, "step": e.step, "shard": e.shard}
        if e.nbytes:
            args["nbytes"] = e.nbytes
        if e.ops:
            args["ops"] = e.ops
        if e.bits:
            args["bits"] = e.bits
        if e.layer >= 0:
            args["layer"] = e.layer
        if e.expert >= 0:
            args["expert"] = e.expert
        if e.slice_kind:
            args["slice"] = e.slice_kind
        trace_events.append({
            "name": _event_name(e), "cat": e.kind, "ph": "X",
            "ts": e.start * 1e6, "dur": (e.end - e.start) * 1e6,
            "pid": pid, "tid": tid, "args": args,
        })

    span_tids: Dict[str, int] = {}
    for s in tracer.spans:
        tid = span_tids.setdefault(s["track"], len(span_tids))
        pids_seen.setdefault(REQUESTS_PID, "requests")
        tids_seen.setdefault((REQUESTS_PID, tid), s["track"])
        trace_events.append({
            "name": s["name"], "cat": "span", "ph": "X",
            "ts": s["start"] * 1e6,
            "dur": (s["end"] - s["start"]) * 1e6,
            "pid": REQUESTS_PID, "tid": tid, "args": s["args"],
        })

    meta: List[dict] = []
    for pid, pname in sorted(pids_seen.items()):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": pname}})
    for (pid, tid), tname in sorted(tids_seen.items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": tname}})
    return {"traceEvents": meta + trace_events, "displayTimeUnit": "ms"}


def export_chrome_trace(tracer: TimelineTracer, path: str) -> dict:
    """Write the Chrome-trace JSON for ``tracer`` to ``path``; returns
    the exported dict (handy for asserting on what was written)."""
    data = chrome_trace(tracer)
    with open(path, "w") as fh:
        json.dump(data, fh)
        fh.write("\n")
    return data
