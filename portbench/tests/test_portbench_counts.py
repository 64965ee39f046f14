"""The frozen operation and byte counts."""

import numpy as np
import pytest

from portbench.lib import counts as C
from portbench.tests.cells import QWEN_REPRO


def _cfg(E=6, k=2, cf=100.0):
    cfg = dict(QWEN_REPRO)
    cfg["moe"] = dict(cfg["moe"], n_experts=E, top_k=k, capacity_factor=cf)
    return cfg


def test_bytes_fall_when_experts_get_no_rows_and_equal_a_hand_sum():
    cfg = _cfg()
    d, f = cfg["d_model"], cfg["moe"]["d_ff"]
    all_rows = np.array([3, 1, 2, 1, 1, 2])
    some_rows = np.array([5, 0, 5, 0, 0, 0])
    high = np.array([True, False, True, True, False, False])
    k1_all, k2_all = C.kernel_work(cfg, all_rows, high)
    k1, k2 = C.kernel_work(cfg, some_rows, high)
    assert k1.bytes < k1_all.bytes and k2.bytes < k2_all.bytes
    assert k1.flops == k1_all.flops      # the same 10 rows either way
    # By hand: experts 0 and 2 ran, both on both slices (8 bits).
    rows = 10
    k1_hand = 2 * (d * 2 * f) + 2 * (d // 32) * 2 * f * 5 \
        + rows * d * 2 + rows * 2 * f * 4
    k2_hand = 2 * (f * d) + 2 * (f // 32) * d * 5 \
        + rows * f * 2 + rows * d * 4
    assert k1.bytes == k1_hand and k2.bytes == k2_hand
    assert k1.flops == 2 * rows * d * 2 * f


def test_msb_only_experts_count_half_the_code_bytes():
    cfg = _cfg()
    rows = np.array([1, 0, 0, 0, 0, 0])
    hi = C.kernel_work(cfg, rows, np.ones(6, bool))[0].bytes
    lo = C.kernel_work(cfg, rows, np.zeros(6, bool))[0].bytes
    d, f = cfg["d_model"], cfg["moe"]["d_ff"]
    assert hi - lo == d * 2 * f * 4 / 8


def test_rows_follow_capacity_and_masks():
    cfg = _cfg(E=4, k=2, cf=1.0)
    # 8 tokens all routed to experts 0 and 1: capacity max(8, ...) = 8
    ids = np.zeros((1, 1, 8, 2), np.int64)
    ids[..., 1] = 1
    active = np.ones_like(ids, bool)
    rows = C.expert_rows(cfg, ids, active, None)[0, 0]
    assert rows.tolist() == [8, 8, 0, 0]
    mask = np.array([True] * 4 + [False] * 4)
    rows = C.expert_rows(cfg, ids, active, mask)[0, 0]
    assert rows.tolist() == [4, 4, 0, 0]
    # 16 tokens on expert 0 in slot 0: capacity int(16*2*1/4)+1 = 9.
    ids = np.zeros((1, 1, 16, 2), np.int64)
    ids[..., 1] = 2
    rows = C.expert_rows(cfg, ids, np.ones_like(ids, bool), None)[0, 0]
    assert rows.tolist() == [9, 0, 9, 0]


def test_decode_step_bytes_fall_with_unused_experts():
    cfg = _cfg(E=6, k=2)
    T = 4
    spread = np.array([[0, 1], [2, 3], [4, 5], [0, 2]])
    packed = np.array([[0, 1], [0, 1], [0, 1], [0, 1]])
    P, npos = cfg["n_layers"], 1
    mk = lambda a: np.broadcast_to(a, (P, npos, T, 2)).copy()
    ones = np.ones((P, npos, T, 2), bool)
    crit = np.zeros_like(ones)
    mask = np.ones(T, bool)
    w_spread = C.decode_work(cfg, mk(spread), ones, crit, mask, [10] * T)
    w_packed = C.decode_work(cfg, mk(packed), ones, crit, mask, [10] * T)
    assert w_packed.bytes < w_spread.bytes
    assert w_packed.flops == pytest.approx(w_spread.flops)
    assert w_packed.bound_s <= w_spread.bound_s
