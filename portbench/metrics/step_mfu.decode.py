"""The decode steps' share of the chip's peak: for each decode step of the
window, the larger of its operations at 989 TFLOP/s and its bytes at
3.35 TB/s (``portbench.lib.counts.decode_work``: the routing it had, the
experts it used at the precision they ran, each sequence's KV up to its
position), summed, over the summed host walls of those steps
(``wall_step_s``), in percent."""


def read(run):
    ks = run.window_decodes()
    wall = sum(run.wall_step_s[k] for k in ks)
    if wall <= 0:
        return None
    return 100.0 * sum(run.decode_work(k).bound_s for k in ks) / wall
