"""The traced segment: ``torch.profiler`` over a few steady scheduler
steps after the window, read back from its Chrome trace.

Device events are the trace's kernels, copies and sets.  A kernel belongs
to the host range open when its launch ran (matched by the launch's
correlation id): ``slicemoe.decode_forward``, ``slicemoe.decode_charge``,
``slicemoe.prefill_forward``, ``slicemoe.prefill_charge`` (the engine's
ranges) inside ``portbench.step`` (the benchmark's, one per scheduler
step).  The traced window runs from the first step's start to the last
step's end on the trace's clock.

The profiler's own host work (it records every operator the host runs)
stretches the traced steps' host walls, and not the device's work.  So
shares of a step's wall are taken against the measured window's own step
walls (``busy_per``), not against the traced segment's.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGES = ("slicemoe.decode_forward", "slicemoe.decode_charge",
          "slicemoe.prefill_forward", "slicemoe.prefill_charge")
STEP = "portbench.step"


@dataclasses.dataclass
class Kernel:
    """A device operation: a kernel, a copy or a set."""

    name: str
    start_us: float
    dur_us: float
    range: Optional[str]          # the engine range its launch ran in
    launch_us: Optional[float] = None
    cat: str = "kernel"

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclasses.dataclass
class Trace:
    window_s: float
    ops: List[Kernel]                   # every device operation
    ranges: Dict[str, List[Tuple[float, float]]]
    t0_us: float
    t1_us: float

    @property
    def kernels(self) -> List[Kernel]:
        return [k for k in self.ops if k.cat == "kernel"]

    @property
    def device(self) -> List[Tuple[float, float]]:
        """(start, end) us of every device operation."""
        return [(k.start_us, k.end_us) for k in self.ops]

    def _union_s(self, spans) -> float:
        busy, end = 0.0, self.t0_us
        for s, e in sorted(spans):
            s, e = max(s, end), min(e, self.t1_us)
            if e > s:
                busy += e - s
                end = e
        return busy * 1e-6

    def busy_s(self) -> float:
        """Seconds in the window in which some device operation ran."""
        return self._union_s(self.device)

    def busy_in_s(self, ranges) -> float:
        """Seconds in the window in which a device operation ran whose
        launch ran in one of ``ranges``."""
        return self._union_s((k.start_us, k.end_us) for k in self.ops
                             if k.range in ranges)

    def host_after_device(self, forward: str, after: str) -> List[float]:
        """For each span of the range ``after``: the host microseconds of
        it that follow the end of the device work launched in the span of
        ``forward`` just before it (the whole span where that work ended
        before it began)."""
        fwd = sorted(self.ranges.get(forward, []))
        if not fwd:
            return []
        ends = [max((k.end_us for k in self.ops if k.range == forward
                     and k.launch_us is not None and fs <= k.launch_us < fe),
                    default=fs) for fs, fe in fwd]
        fstarts = [fs for fs, _ in fwd]
        out = []
        for s, e in sorted(self.ranges.get(after, [])):
            i = bisect.bisect_right(fstarts, s) - 1
            if i < 0:
                continue
            out.append(e - max(s, ends[i]))
        return out

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, end = [], self.t0_us
        for s, e in sorted(self.device):
            if s > end:
                gaps.append((end, min(s, self.t1_us)))
            end = max(end, e)
            if end >= self.t1_us:
                break
        if end < self.t1_us:
            gaps.append((end, self.t1_us))
        return [(s, e) for s, e in gaps if e > s]

    def range_at(self, t_us: float) -> str:
        best, width = STEP, float("inf")
        for name, spans in self.ranges.items():
            for s, e in spans:
                if s <= t_us < e and e - s < width:
                    best, width = name, e - s
        return best

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            by_name[k.name[:160]] += k.dur_us * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[f"host in {self.range_at((s + e) / 2)}",
                               (e - s) * 1e-6] for s, e in gaps]}


def trace_steps(loop, n_steps: int, path: str, device) -> Trace:
    """Profile ``n_steps`` scheduler steps of ``loop`` and read them back.
    The file is removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        for _ in range(n_steps):
            with record_function(STEP):
                loop.step()
        if cuda:
            torch.cuda.synchronize(device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read_events(events)


def read_events(events: list) -> Trace:
    ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    launches: Dict[int, float] = {}
    ops_raw = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), \
            float(ev.get("dur", 0.0))
        if cat == "user_annotation" and (ev["name"] in RANGES
                                         or ev["name"] == STEP):
            ranges[ev["name"]].append((ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[int(corr)] = ts
        elif cat in DEVICE_CATS:
            ops_raw.append(ev)
    steps = sorted(ranges.get(STEP, []))
    if not steps:
        raise RuntimeError("the trace holds no benchmark step")
    t0, t1 = steps[0][0], steps[-1][1]
    engine = {n: sorted(ranges.get(n, [])) for n in RANGES}
    starts = {n: [s for s, _ in v] for n, v in engine.items()}

    def owner(t: float) -> Optional[str]:
        for n, spans in engine.items():
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and spans[i][0] <= t < spans[i][1]:
                return n
        return None

    ops = []
    for ev in ops_raw:
        corr = ev.get("args", {}).get("correlation")
        at = launches.get(int(corr)) if corr is not None else None
        ops.append(Kernel(ev["name"], float(ev["ts"]),
                          float(ev.get("dur", 0.0)),
                          owner(at) if at is not None else None,
                          launch_us=at, cat=ev.get("cat", "")))
    return Trace(window_s=(t1 - t0) * 1e-6, ops=ops, ranges=dict(ranges),
                 t0_us=t0, t1_us=t1)
