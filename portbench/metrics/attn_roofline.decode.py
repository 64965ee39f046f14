"""Decode attention's share of its roofline in the decode forwards of the
traced segment: the KV bytes of the rows the attention layers need, at
3.35 TB/s, over the summed device time of the decode-attention kernels
(the split and merge kernels of ``csrc/decode_attention.cu``, matched by
name below) launched in the forward, in percent.

The bytes: for each traced decode step, the attention layers read each
sequence's valid cached rows once, ``kv_bytes_row`` bytes a row over all
of them (the model module's ``layer_work``: for ``periodic``,
``2 * n_kv_heads * head_dim`` bf16 values a row and layer), over
``kv_lens`` rows (``DecodeRec.slots``: the rows after the step's row is
written, as ``counts.decode_work`` counts them), cut to the window where a
configuration has one.  None where the trace holds no such kernel (a
program without it)."""

import re

KERNEL = re.compile(r"decode_attn_(split|merge)_kernel")
RANGE = "slicemoe.decode_forward"
HBM_BYTES_S = 3.35e12


def read(run):
    if run.trace is None:
        return None
    dev_s = 1e-6 * sum(k.dur_us for k in run.trace.kernels
                       if k.range == RANGE and KERNEL.search(k.name))
    if dev_s <= 0:
        return None
    cfg = run.cfg
    row = run.model.layer_work(cfg).kv_bytes_row
    window = cfg.get("sliding_window")
    rows = 0
    for k in range(*run.traced_decodes):
        for _, kv_len in run.decodes[k].slots.values():
            rows += kv_len if window is None else min(kv_len, window)
    return 100.0 * row * rows / HBM_BYTES_S / dev_s
