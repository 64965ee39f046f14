"""The prefills' share of the chip's peak: for each prefill of the window,
the larger of its operations at 989 TFLOP/s and its bytes at 3.35 TB/s
(``portbench.lib.counts.prefill_work``), summed, over the summed host
walls of those prefills (``wall_prefill_s``), in percent."""


def read(run):
    ps = run.window_prefills()
    wall = sum(run.wall_prefill_s[i] for i in ps)
    if wall <= 0:
        return None
    return 100.0 * sum(run.prefill_work(i).bound_s for i in ps) / wall
