"""Output tokens that reached the host in the window, over the window's
seconds.  Each decode step gives one token to every sequence it ran; the
prefills inside the window count in the time."""


def read(run):
    n = sum(len(run.decodes[k].slots) for k in run.window_decodes())
    return n / run.window_s
