"""The absorbed-MLA decode kernels' share of their roofline in the decode
forwards of the traced segment: the latent rows the MLA layers need, at
the larger of their bytes at 3.35 TB/s and their operations at 989
TFLOP/s, over the summed device time of the MLA decode kernels (the split
and merge kernels of ``csrc/mla_decode.cu``, matched by name below)
launched in the forward, in percent.

The rows: for each traced decode step, each sequence's valid rows
(``DecodeRec.slots``: the rows after the step's row is written, as
``counts.decode_work`` counts them), read once by every head of every MLA
layer: the model module's ``layer_work`` gives ``kv_bytes_row`` (for
``deepseek_v2``, 512 + 64 bf16 values a row and layer) and
``attn_flops_row``.  None where the trace holds no such kernel (a program
without it)."""

import re

KERNEL = re.compile(r"mla_decode_(split|merge)_kernel")
RANGE = "slicemoe.decode_forward"
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = 989e12


def read(run):
    if run.trace is None:
        return None
    dev_s = 1e-6 * sum(k.dur_us for k in run.trace.kernels
                       if k.range == RANGE and KERNEL.search(k.name))
    if dev_s <= 0:
        return None
    work = run.model.layer_work(run.cfg)
    rows = sum(kv_len for k in range(*run.traced_decodes)
               for _, kv_len in run.decodes[k].slots.values())
    bound = max(work.kv_bytes_row * rows / HBM_BYTES_S,
                work.attn_flops_row * rows / PEAK_FLOPS)
    return 100.0 * bound / dev_s
