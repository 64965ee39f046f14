"""The program's host spans of the window's decode steps, for the metric
readers.

The program keeps the host seconds of each named span, one record per
scheduler step, in ``repro_torch.obs.spans.SPANS``, which the first
scheduler of a process claims and clears when it is built.  The harness
builds one scheduler per run and every scheduler step it takes runs one
decode step, so record *k* is decode step *k* (``run.decodes[k]``,
``run.step_end[k]``).  A program without the recorder reads nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

MODULE = "repro_torch.obs.spans"


def window_mean_ms(run, names: Sequence[str]) -> Optional[float]:
    """Mean over the window's decode steps of the summed host seconds of
    the spans ``names``, in ms.  Raises where the recorder's steps do not
    line up with the run's, or where a window step lacks one of the
    spans."""
    try:
        from repro_torch.obs.spans import SPANS
    except ModuleNotFoundError as e:
        if e.name != MODULE:
            raise
        return None
    if SPANS.n_steps != len(run.step_end):
        raise RuntimeError(f"the span recorder holds {SPANS.n_steps} "
                           f"steps, the run {len(run.step_end)}")
    ks = run.window_decodes()
    if not ks:
        return None
    total = 0.0
    for k in ks:
        rec = SPANS.step(k)
        total += sum(rec[n] for n in names)
    return total / len(ks) * 1e3
