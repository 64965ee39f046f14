"""The small cells on the card, through the port's CUDA kernels (the f32
route of K1/K2 on three exact bf16 planes).  Skips without a card; on the
card: python -m pytest -m gpu portbench/tests/test_portbench_gpu.py"""

import time

import pytest
import torch

from portbench.lib import bench
from portbench.tests.cells import QWEN_REPRO, TINY_HYBRID, cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [QWEN_REPRO, TINY_HYBRID],
                         ids=["qwen15-moe-repro", "tiny-hybrid"])
def test_small_cell_on_the_card(cuda, cfg):
    res = bench.run_cell(cell(cfg, 1e-3, 1e-4), 2 ** 31 + 21, 2.0, True,
                         cuda, time.perf_counter(), control=True)
    ch = res["checks"]
    assert res["correct"], ch
    assert ch["control_mean_logit_gap"]["value"] > 1e-2
    assert res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["k1_roofline.decode"]["value"] <= 100
