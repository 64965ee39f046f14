"""The share of a decode step in which the device idles, in percent: 1 -
the device time of a traced decode step (the union of the operations
launched from the engine's decode ranges, over the traced decode steps;
torch.profiler) over the mean host wall of the window's decode steps
(the scheduler's ``wall_step_s``).  The window's walls, not the traced
segment's: the profiler's host work stretches those, not the device's."""

DECODE = ("slicemoe.decode_forward", "slicemoe.decode_charge")


def read(run):
    if run.trace is None:
        return None
    n = run.traced_decodes[1] - run.traced_decodes[0]
    ks = run.window_decodes()
    if n <= 0 or not ks:
        return None
    wall = sum(run.wall_step_s[k] for k in ks) / len(ks)
    return 100.0 * (1.0 - run.trace.busy_in_s(DECODE) / n / wall)
