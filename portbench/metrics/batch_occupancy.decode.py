"""Mean share of the scheduler's slots that a decode step of the window
ran (``sched.n_active() / max_batch``), in percent."""


def read(run):
    ks = run.window_decodes()
    if not ks:
        return None
    cap = run.cell.mix.max_batch
    return 100.0 * sum(len(run.decodes[k].slots) for k in ks) \
        / (len(ks) * cap)
