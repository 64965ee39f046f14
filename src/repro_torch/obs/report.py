"""Per-channel stall/overlap/waste analysis of an exported trace (port
of ``repro.obs.report``).

Operates on the Chrome-trace JSON produced by
:func:`repro_torch.obs.timeline.chrome_trace` (stdlib-only: the CLI in
``scripts/torch_trace_report.py`` is a thin wrapper), so a trace
exported from any run — live, replay, CI artifact — can be summarized
without the engine that produced it.

Per ``(process, thread)`` channel track it reports busy time, idle
time inside the track's own active window, utilization against the
overall makespan, bytes moved and event count; per process it reports
the overlap saved (sum of channel busy time minus the process
makespan — what a fully serialized replay would have added).  The
speculative prefetch lane (``flash_bg``) is summarized separately as
*waste-at-risk*: bytes moved on spec that demand traffic never had to
wait for.
"""

from __future__ import annotations

import json
from typing import Dict, List


def _tracks(data: dict) -> Dict[tuple, dict]:
    """Group complete events by (pid, tid); resolve metadata names."""
    pnames: Dict[int, str] = {}
    tnames: Dict[tuple, str] = {}
    tracks: Dict[tuple, dict] = {}
    for ev in data.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                pnames[ev["pid"]] = ev["args"]["name"]
            elif ev.get("name") == "thread_name":
                tnames[(ev["pid"], ev.get("tid", 0))] = ev["args"]["name"]
            continue
        if ph != "X":
            continue
        key = (ev["pid"], ev.get("tid", 0))
        tr = tracks.setdefault(key, {
            "events": 0, "busy_us": 0.0, "bytes": 0.0, "ops": 0.0,
            "first_us": float("inf"), "last_us": 0.0,
        })
        ts, dur = ev["ts"], ev.get("dur", 0.0)
        tr["events"] += 1
        tr["busy_us"] += dur
        tr["first_us"] = min(tr["first_us"], ts)
        tr["last_us"] = max(tr["last_us"], ts + dur)
        args = ev.get("args", {})
        tr["bytes"] += args.get("nbytes", 0.0)
        tr["ops"] += args.get("ops", 0.0)
    for key, tr in tracks.items():
        tr["process"] = pnames.get(key[0], f"pid {key[0]}")
        tr["channel"] = tnames.get(key, f"tid {key[1]}")
    return tracks


def trace_report(data: dict) -> dict:
    """Summarize an exported Chrome trace.

    Returns ``{"makespan_us", "channels": [...], "processes": [...]}``
    where each channel row carries busy/idle/utilization/bytes and each
    process row the overlap saved across its channels.
    """
    tracks = _tracks(data)
    hw = {k: t for k, t in tracks.items() if t["process"] != "requests"}
    makespan = max((t["last_us"] for k, t in hw.items()
                    if t["channel"] != "flash_bg"), default=0.0)
    channels: List[dict] = []
    for (pid, tid), t in sorted(hw.items()):
        window = t["last_us"] - min(t["first_us"], t["last_us"])
        channels.append({
            "process": t["process"], "channel": t["channel"],
            "events": t["events"], "busy_us": t["busy_us"],
            "bytes": t["bytes"], "ops": t["ops"],
            "stall_us": max(0.0, window - t["busy_us"]),
            "util_vs_makespan": (t["busy_us"] / makespan
                                 if makespan else 0.0),
        })
    processes: List[dict] = []
    by_proc: Dict[str, List[dict]] = {}
    for (pid, tid), t in hw.items():
        by_proc.setdefault(t["process"], []).append(t)
    for proc in sorted(by_proc):
        rows = [t for t in by_proc[proc] if t["channel"] != "flash_bg"]
        spec = [t for t in by_proc[proc] if t["channel"] == "flash_bg"]
        serial = sum(t["busy_us"] for t in rows)
        span = max((t["last_us"] for t in rows), default=0.0)
        processes.append({
            "process": proc,
            "serial_us": serial,
            "makespan_us": span,
            "overlap_saved_us": max(0.0, serial - span),
            "speculative_bytes": sum(t["bytes"] for t in spec),
            "speculative_events": sum(t["events"] for t in spec),
        })
    return {"makespan_us": makespan, "channels": channels,
            "processes": processes}


def format_trace_report(rep: dict) -> str:
    """Human-readable table of a :func:`trace_report` result."""
    lines = [f"makespan: {rep['makespan_us']:.1f} us", "",
             f"{'process':<14}{'channel':<10}{'events':>8}"
             f"{'busy_us':>12}{'stall_us':>12}{'util':>8}"
             f"{'bytes':>14}"]
    for row in rep["channels"]:
        lines.append(
            f"{row['process']:<14}{row['channel']:<10}"
            f"{row['events']:>8}{row['busy_us']:>12.1f}"
            f"{row['stall_us']:>12.1f}{row['util_vs_makespan']:>8.1%}"
            f"{row['bytes']:>14.0f}")
    lines.append("")
    lines.append(f"{'process':<14}{'serial_us':>12}{'makespan_us':>14}"
                 f"{'overlap_us':>12}{'spec_bytes':>12}")
    for row in rep["processes"]:
        lines.append(
            f"{row['process']:<14}{row['serial_us']:>12.1f}"
            f"{row['makespan_us']:>14.1f}"
            f"{row['overlap_saved_us']:>12.1f}"
            f"{row['speculative_bytes']:>12.0f}")
    return "\n".join(lines)


def load_trace(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
