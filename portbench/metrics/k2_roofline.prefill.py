"""K2's share of its roofline in the prefill forwards of the traced segment:
the batched-expert kernel on the ``wo`` codes, matched by its name
below.  The sum over its launches of the larger of each launch's
operations at 989 TFLOP/s and its bytes at 3.35 TB/s
(``portbench.lib.counts.kernel_work`` on the forward's routing: the
experts with rows, the rows they kept, each at the precision it ran),
over the launches' summed device time, in percent."""

import re

KERNEL = re.compile(r"amat_batched_mma_kernel<\s*\d+\s*,\s*true\b")
RANGE = "slicemoe.prefill_forward"


def read(run):
    from portbench.lib.rooflines import kernel_share

    return kernel_share(run, "prefill", 1, KERNEL, RANGE)
