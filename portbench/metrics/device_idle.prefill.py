"""The share of a prefill in which the device idles, in percent: 1 - the
device time per prompt token of the traced prefills (the union of the
operations launched from the engine's prefill ranges; torch.profiler)
over the host wall per prompt token of the window's prefills (the
scheduler's ``wall_prefill_s``).  The window's walls, not the traced
segment's: the profiler's host work stretches those, not the device's."""

PREFILL = ("slicemoe.prefill_forward", "slicemoe.prefill_charge")


def read(run):
    if run.trace is None:
        return None
    traced = sum(run.prefills[i].n_tokens
                 for i in range(*run.traced_prefills))
    ps = run.window_prefills()
    tokens = sum(run.prefills[i].n_tokens for i in ps)
    wall = sum(run.wall_prefill_s[i] for i in ps)
    if traced <= 0 or tokens <= 0 or wall <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_in_s(PREFILL) / traced
                    / (wall / tokens))
