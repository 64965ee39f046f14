"""The check catches a broken timed path: the rest of a run is driven on
the CPU (no look for a chip) with the program's decode step broken
underneath (``portbench.lib.faults``), and ``correct`` must come out
false."""

import dataclasses
import time

import pytest
import torch

import repro_torch.models.model as MDL
from portbench.lib import bench
from portbench.lib.faults import FAULTS
from portbench.tests.cells import QWEN_REPRO, TINY_HYBRID, cell


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cfg", [QWEN_REPRO, TINY_HYBRID],
                         ids=["qwen15-moe-repro", "tiny-hybrid"])
def test_a_broken_step_is_not_correct(monkeypatch, fault, cfg):
    monkeypatch.setattr(MDL, "decode_step", FAULTS[fault](MDL.decode_step))
    res = bench.run_cell(cell(cfg, 1e-3, 1e-4), 2 ** 31 + 3, 3.0, False,
                         torch.device("cpu"), time.perf_counter())
    ch = res["checks"]
    assert ch["tokens_judged"]["value"] > 0
    assert not res["correct"], ch


def test_an_altered_token_fails_the_count_of_big_gaps(monkeypatch):
    # A mean limit the fault stays under: only the count can catch it.
    monkeypatch.setattr(MDL, "decode_step",
                        FAULTS["token_altered"](MDL.decode_step))
    c = cell(TINY_HYBRID, None, 10.0)
    c = dataclasses.replace(c, check=dict(c.check, big_gap=2.0,
                                          max_big_gaps=1))
    res = bench.run_cell(c, 2 ** 31 + 9, 3.0, False, torch.device("cpu"),
                         time.perf_counter())
    ch = res["checks"]
    assert ch["mean_logit_gap"]["value"] <= 10.0
    assert ch["big_gaps"]["value"] > 1
    assert not res["correct"], ch
