"""``attn_roofline.decode`` from a synthetic trace: the valid rows' KV
bytes at 3.35 TB/s over the decode-attention kernels' device time in the
decode forward, and nothing where the trace holds no such kernel."""

import types

import pytest

from portbench.lib import loader
from portbench.lib.bench import Run, metric_reader
from portbench.lib.profile import STEP, Kernel, Trace
from portbench.tests.cells import TINY_HYBRID

FWD = "slicemoe.decode_forward"
CFG = dict(TINY_HYBRID, n_layers=8, n_kv_heads=8, head_dim=128,
           pattern=[{"mixer": "attn", "ffn": "dense"},
                    {"mixer": "ssm", "ffn": "moe"},
                    {"mixer": "attn", "ffn": "moe"},
                    {"mixer": "ssm", "ffn": "dense"}])


def _run(ops, cfg=CFG):
    decodes = [types.SimpleNamespace(slots={0: (1, 100), 1: (2, 300)}),
               types.SimpleNamespace(slots={0: (1, 101), 1: (2, 301)})]
    trace = Trace(window_s=1e-3, ops=ops,
                  ranges={FWD: [(0.0, 400.0), (500.0, 900.0)],
                          STEP: [(0.0, 450.0), (500.0, 1000.0)]},
                  t0_us=0.0, t1_us=1000.0)
    cell = types.SimpleNamespace(cfg=cfg, model=loader.model_module(cfg))
    return Run(cell=cell, seconds=1.0,
               setup_s=1.0, t_open=0.0, t_close=1.0, d_open=0, d_close=0,
               step_end=[], wall_step_s=[], wall_prefill_s=[],
               decodes=decodes, prefills=[], trace=trace,
               traced_decodes=(0, 2))


def test_share_of_the_valid_rows_bytes():
    split = "void (anonymous namespace)::decode_attn_split_kernel<128, 4>"
    merge = "(anonymous namespace)::decode_attn_merge_kernel(Params)"
    ops = [Kernel(split, 10.0, 30.0, FWD, launch_us=5.0),
           Kernel(merge, 45.0, 5.0, FWD, launch_us=6.0),
           Kernel(split, 510.0, 25.0, FWD, launch_us=505.0),
           Kernel("elementwise_kernel", 60.0, 50.0, FWD, launch_us=7.0),
           Kernel(split, 960.0, 20.0, "slicemoe.prefill_forward",
                  launch_us=955.0)]
    # 2 periods x 2 attention layers; 8 x 128 x 2 values of 2 bytes a row;
    # rows 100 + 300 + 101 + 301; device time 30 + 5 + 25 us.
    bound_s = 4 * 4096 * 802 / 3.35e12
    assert metric_reader("attn_roofline.decode")(_run(ops)) == \
        pytest.approx(100.0 * bound_s / 60e-6)
    window = dict(CFG, sliding_window=200)
    bound_s = 4 * 4096 * (100 + 200 + 101 + 200) / 3.35e12
    assert metric_reader("attn_roofline.decode")(_run(ops, window)) == \
        pytest.approx(100.0 * bound_s / 60e-6)


def test_nothing_without_the_kernel():
    ops = [Kernel("elementwise_kernel", 60.0, 50.0, FWD, launch_us=7.0)]
    assert metric_reader("attn_roofline.decode")(_run(ops)) is None
    run = _run(ops)
    run.trace = None
    assert metric_reader("attn_roofline.decode")(run) is None
