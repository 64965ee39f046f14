#!/usr/bin/env python
"""Summarize an exported Chrome-trace: stall/overlap/waste per channel
(the port's counterpart of ``scripts/trace_report.py``, on
``repro_torch.obs``; stdlib only, no card).

Usage::

    python scripts/torch_trace_report.py trace.json           # text tables
    python scripts/torch_trace_report.py trace.json --json    # machine-readable

The input is the JSON written by ``engine.export_trace(path)`` or
``server.export_trace(path)`` of either package (the schema is in
docs/observability.md).  Per channel it reports busy time, bytes/ops
moved, stall (idle time inside the channel's active window) and
utilization against the global makespan; per process (shard) it reports
serial-vs-makespan overlap savings and the speculative (prefetch)
traffic that was in flight.  All times are the cost model's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.obs.report import (format_trace_report, load_trace,  # noqa: E402
                                    trace_report)


def main() -> int:
    ap = argparse.ArgumentParser(
        description="per-channel stall/overlap/waste summary of an "
                    "exported Chrome-trace JSON")
    ap.add_argument("trace", help="path to an exported trace")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON instead of tables")
    args = ap.parse_args()

    rep = trace_report(load_trace(args.trace))
    if args.json:
        print(json.dumps(rep, indent=2, sort_keys=True))
    else:
        print(format_trace_report(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
