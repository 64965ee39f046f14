"""The scheduler's host wall of the window's prefills (``wall_prefill_s``,
each ending in a synchronize) over the window, in percent: the time the
decoding sequences waited for admissions."""


def read(run):
    return 100.0 * sum(run.wall_prefill_s[i] for i in run.window_prefills()) \
        / run.window_s
