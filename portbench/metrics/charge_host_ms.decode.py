"""Host milliseconds per decode step that the engine's charge path
(``slicemoe.decode_charge``) spends once the step's forward has finished
on the device: the part of the range after the end of the last device
operation launched from the step's ``slicemoe.decode_forward`` range
(torch.profiler).  The range begins by moving the routing to the host,
which waits for the forward; that wait is left out."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.host_after_device("slicemoe.decode_forward",
                                        "slicemoe.decode_charge")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e-3
