"""Slice misses over slice accesses of the window's decode steps (the
charge path's ``StepCharge.misses`` / ``.accesses``), in percent."""


def read(run):
    ks = run.window_decodes()
    acc = sum(run.decodes[k].accesses for k in ks)
    if acc == 0:
        return None
    return 100.0 * sum(run.decodes[k].misses for k in ks) / acc
