"""Host milliseconds per window decode step spent launching the step's
multi-head latent attention layers: the program's span
``slicemoe.decode_forward.mla`` (inside ``slicemoe.decode_forward``: each
MLA layer's projections, the ``W_UK`` and ``W_UV`` products and the
kernel's launch), summed over a step's layers.  None on a program that
records no such span."""

from portbench.lib.spans import window_mean_ms

SPANS = ("slicemoe.decode_forward.mla",)


def read(run):
    try:
        from repro_torch.obs.spans import SPANS as REC
    except ModuleNotFoundError:
        return None
    ks = run.window_decodes()
    if not ks or REC.n_steps <= ks[0] or SPANS[0] not in REC.step(ks[0]):
        return None
    return window_mean_ms(run, SPANS)
