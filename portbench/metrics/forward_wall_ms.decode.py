"""Host milliseconds per window decode step from the first launch of the
step's forward until its routing is on the host: the program's spans
``slicemoe.decode_forward`` and ``slicemoe.decode_charge.to_host`` (the
wait for the device and the routing trace's copy).  The forward's time
on the step's critical path, device work included."""

from portbench.lib.spans import window_mean_ms

SPANS = ("slicemoe.decode_forward", "slicemoe.decode_charge.to_host")


def read(run):
    return window_mean_ms(run, SPANS)
