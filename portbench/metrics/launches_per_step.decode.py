"""Device kernels launched from the engine's decode ranges
(``slicemoe.decode_forward`` and ``slicemoe.decode_charge``) per decode
step of the traced segment (torch.profiler)."""

RANGES = ("slicemoe.decode_forward", "slicemoe.decode_charge")


def read(run):
    if run.trace is None:
        return None
    n_steps = len(run.trace.ranges.get("slicemoe.decode_forward", []))
    if n_steps == 0:
        return None
    return sum(k.range in RANGES for k in run.trace.kernels) / n_steps
