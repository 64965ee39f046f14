"""A kernel's share of its roofline over the traced forwards of one kind."""

from __future__ import annotations

from portbench.lib import counts as C


def kernel_share(run, phase: str, which: int, pattern, host_range: str):
    """Sum of the bounds of the ``which``-th expert product (0: K1 on
    ``wi``, 1: K2 on ``wo``) over every MoE layer of the traced
    ``phase`` forwards, over the summed device time of the kernels whose
    name matches ``pattern`` and whose launch ran in ``host_range``, in
    percent.  None where the trace holds no such kernel."""
    if run.trace is None:
        return None
    dev_s = 1e-6 * sum(k.dur_us for k in run.trace.kernels
                       if k.range == host_range and pattern.search(k.name))
    if dev_s <= 0:
        return None
    if phase == "decode":
        recs = [run.decodes[k] for k in range(*run.traced_decodes)]
        parts = [(r.ids, r.active, r.critical, r.slot_mask) for r in recs]
    else:
        recs = [run.prefills[i] for i in range(*run.traced_prefills)]
        parts = [(p.ids, p.active, None, None) for p in recs]
    bound = 0.0
    E = run.cfg["moe"]["n_experts"]
    for ids, active, critical, mask in parts:
        rows = C.expert_rows(run.cfg, ids, active, mask).reshape(-1, E)
        high = C.expert_high(run.cfg, ids, active, critical,
                             mask).reshape(-1, E)
        for r, h in zip(rows, high):
            bound += C.kernel_work(run.cfg, r, h,
                                   run.mat_bits())[which].bound_s
    return 100.0 * bound / dev_s
