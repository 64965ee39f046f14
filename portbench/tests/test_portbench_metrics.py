"""End-to-end metrics from synthetic timestamps."""

import types

import numpy as np
import pytest

from portbench.lib.bench import Run, metric_reader


def _run(step_end, slots_per_step, t_open, t_close, d_open, d_close,
         prefills=()):
    decodes = [types.SimpleNamespace(slots={s: (rid, 0) for s, rid in
                                            enumerate(rids)},
                                     energy_j=0.5, accesses=10, misses=1)
               for rids in slots_per_step]
    cell = types.SimpleNamespace(mix=types.SimpleNamespace(max_batch=4))
    return Run(cell=cell, seconds=t_close - t_open, setup_s=1.0,
               t_open=t_open, t_close=t_close, d_open=d_open,
               d_close=d_close, step_end=list(step_end),
               wall_step_s=[0.1] * len(step_end),
               wall_prefill_s=[p[2] for p in prefills],
               decodes=decodes,
               prefills=[types.SimpleNamespace(step=p[0], n_tokens=p[1])
                         for p in prefills])


def test_rates_and_tail_with_a_stall():
    # Three requests decode every step, 0.1 s apart, except one stall of
    # 1.0 s between steps 5 and 6.  The window opens at step 2's end.
    t = [0.1 * i for i in range(6)] + [0.5 + 1.0 + 0.1 * i
                                      for i in range(10)]
    slots = [[0, 1, 2]] * len(t)
    run = _run(t, slots, t_open=t[1], t_close=t[-1], d_open=2,
               d_close=len(t))
    n_tok = 3 * (len(t) - 2)
    assert metric_reader("decode_tok_s")(run) == pytest.approx(
        n_tok / (t[-1] - t[1]))
    gaps = np.diff(t[2:])
    gaps = np.repeat(gaps, 3)
    want = float(np.percentile(gaps, 95)) * 1e3
    assert metric_reader("itl_p95_ms")(run) == pytest.approx(want)
    # The stall is one gap in 13 per request: above the 92nd percentile,
    # so the tail is pulled into it, far above a 0.1 s step.
    assert want > 100.0
    assert metric_reader("modeled_decode_mj_per_tok")(run) == \
        pytest.approx(0.5 * (len(t) - 2) / n_tok * 1e3)
    assert metric_reader("slice_miss_rate.decode")(run) == \
        pytest.approx(10.0)
    assert metric_reader("batch_occupancy.decode")(run) == \
        pytest.approx(75.0)


def test_gap_counts_only_tokens_inside_the_window():
    t = [0.0, 1.0, 5.0, 5.1, 5.2]
    run = _run(t, [[7]] * 5, t_open=t[1], t_close=t[-1], d_open=2,
               d_close=5)
    # The 4 s gap ends at step 2, whose previous token (step 1) lies
    # before the window: it is not counted.
    assert metric_reader("itl_p95_ms")(run) == pytest.approx(100.0)


def test_prefill_rate_and_share():
    t = [0.5 * i for i in range(8)]
    run = _run(t, [[0]] * 8, t_open=t[2], t_close=t[7], d_open=3,
               d_close=8, prefills=[(1, 100, 0.2), (3, 300, 0.3),
                                    (7, 500, 0.4)])
    assert metric_reader("prefill_tok_s")(run) == pytest.approx(
        800 / (t[7] - t[2]))
    assert metric_reader("prefill_share.decode")(run) == pytest.approx(
        100 * 0.7 / (t[7] - t[2]))


def test_trace_shares_leave_the_profiler_wait_and_walls_out():
    from portbench.lib.profile import STEP, Kernel, Trace

    fwd, chg = "slicemoe.decode_forward", "slicemoe.decode_charge"
    # Two traced decode steps.  Step 1's forward work outlives its host
    # range (it ends at 180 us, inside the charge range 100-250); step
    # 2's ends at 350 us, before its charge range 400-500 begins.
    ops = [Kernel("k", 60.0, 120.0, fwd, launch_us=50.0),
           Kernel("k", 320.0, 30.0, fwd, launch_us=310.0),
           Kernel("copy", 190.0, 5.0, chg, launch_us=185.0,
                  cat="gpu_memcpy"),
           Kernel("p", 505.0, 10.0, "slicemoe.prefill_forward",
                  launch_us=502.0)]
    trace = Trace(window_s=520e-6, ops=ops,
                  ranges={fwd: [(0.0, 100.0), (300.0, 400.0)],
                          chg: [(100.0, 250.0), (400.0, 500.0)],
                          STEP: [(0.0, 260.0), (290.0, 520.0)]},
                  t0_us=0.0, t1_us=520.0)
    run = _run([0.1 * i for i in range(6)], [[0]] * 6, t_open=0.1,
               t_close=0.5, d_open=2, d_close=6)
    run.wall_step_s = [0.0004] * 6
    run.trace, run.traced_decodes = trace, (6, 8)
    # Host time after the device's forward: 250 - 180 and 500 - 400 us.
    assert metric_reader("charge_host_ms.decode")(run) == pytest.approx(
        (70.0 + 100.0) / 2 * 1e-3)
    # Device time of the decode ranges, 155 us over 2 steps, against the
    # window's 0.4 ms step wall, not the traced segment's.
    assert metric_reader("device_idle.decode")(run) == pytest.approx(
        100.0 * (1.0 - 155e-6 / 2 / 4e-4))
