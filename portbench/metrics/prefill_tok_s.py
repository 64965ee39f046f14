"""Prompt tokens whose prefill finished in the window, over the window's
seconds.  A prefill counts in the window when the scheduler step that
admitted it ended in the window."""


def read(run):
    return sum(run.prefills[i].n_tokens
               for i in run.window_prefills()) / run.window_s
