"""Host milliseconds per window decode step spent launching the step's
forward: the program's span ``slicemoe.decode_forward`` (its launches
and the policy state's copy to the device).  Near
``forward_wall_ms.decode``, the forward is bound by its launches."""

from portbench.lib.spans import window_mean_ms

SPANS = ("slicemoe.decode_forward",)


def read(run):
    return window_mean_ms(run, SPANS)
