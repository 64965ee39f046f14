"""The 95th percentile (numpy's linear interpolation) of every gap, in
the window, between two consecutive output tokens of one request.  A
token is stamped with the host time after the scheduler step that made
it; a gap counts when both its tokens fall in the window."""

import numpy as np


def read(run):
    last, gaps = {}, []
    for k in run.window_decodes():
        t = run.step_end[k]
        for rid, _ in run.decodes[k].slots.values():
            if rid in last:
                gaps.append(t - last[rid])
            last[rid] = t
    if not gaps:
        return None
    return float(np.percentile(gaps, 95)) * 1e3
