"""Host milliseconds per window decode step of the scheduler's own work
around the engine's decode step: the program's spans
``slicemoe.sched.prepare`` (the token and slot arrays),
``slicemoe.sched.sample`` (the next tokens' argmax, copy to the host
and synchronize) and ``slicemoe.sched.update`` (telemetry, the
per-sequence loop and retirement)."""

from portbench.lib.spans import window_mean_ms

SPANS = ("slicemoe.sched.prepare", "slicemoe.sched.sample",
         "slicemoe.sched.update")


def read(run):
    return window_mean_ms(run, SPANS)
