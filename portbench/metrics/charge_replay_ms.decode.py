"""Host milliseconds per window decode step of the slice cache and cost
ledger replay: the program's span ``slicemoe.decode_charge.replay``,
read in the window, where no profiler stretches it.  The device has no
work queued while it runs."""

from portbench.lib.spans import window_mean_ms

SPANS = ("slicemoe.decode_charge.replay",)


def read(run):
    return window_mean_ms(run, SPANS)
