"""Smoke runs of the port's examples on the CPU, each in a subprocess
with ``--device cpu`` at its smallest size, under a timeout:
``examples/{quickstart,serve_traffic,compare_policies,offline_tune}
_torch.py``.  The examples that would train first serve a checkpoint of
the port's init instead (``--ckpt``), so none of them trains;
``examples/train_small_torch.py`` trains 4 steps of a reduced config.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt as TCK
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TIMEOUT = 60


def _run(name, *argv, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), "--device",
         "cpu", *argv], capture_output=True, text=True, timeout=TIMEOUT,
        cwd=str(cwd), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def _ckpt(tmp_path, arch):
    path = str(tmp_path / arch)
    TCK.save(path, {"params": TM.init_params(get_config(arch), seed=0,
                                             device="cpu")}, step=0)
    return path


def test_quickstart(tmp_path):
    lines = _run("quickstart_torch.py", cwd=tmp_path)
    assert lines[0].startswith("model: deepseek-v2-lite-repro")
    assert "decoded 32 tokens" in lines
    assert any(line.startswith("  decode energy:") for line in lines)


@pytest.mark.parametrize("scenario, batch", [("steady", "2"),
                                             ("bursty", "1")])
def test_serve_traffic(tmp_path, scenario, batch):
    lines = _run("serve_traffic_torch.py", "--ckpt",
                 _ckpt(tmp_path, "qwen15-moe-repro"), "--scenario",
                 scenario, "--requests", "3", "--max-batch", batch,
                 cwd=tmp_path)
    served = [line for line in lines if line.startswith("  req ")]
    assert len(served) == 3
    assert f"--- fleet summary ({scenario}) ---" in lines
    if batch == "1":
        assert "prefill miss-rate per request (cache warming up):" in lines


def test_compare_policies(tmp_path):
    lines = _run("compare_policies_torch.py", "--ckpt",
                 _ckpt(tmp_path, "deepseek-v2-lite-repro"), cwd=tmp_path)
    rows = [line.split()[0] for line in lines if "/" in line.split(" ")[0]]
    assert rows == ["topk/highbit/empty", "cache_prior/highbit/empty",
                    "cache_prior/lowbit/empty", "cache_prior/dbsc/empty",
                    "cache_prior/dbsc/pcw"]


@pytest.mark.parametrize("synthetic", [False, True],
                         ids=["live", "synthetic"])
def test_offline_tune(tmp_path, synthetic):
    argv = ["--requests", "2", "--save-trace", str(tmp_path / "t.npz")]
    if synthetic:
        argv.append("--synthetic")
    lines = _run("offline_tune_torch.py", *argv, cwd=tmp_path)
    assert "=== phase 3: Pareto report ===" in lines
    assert os.path.exists(tmp_path / "t.npz")
    assert any(line.startswith("cheapest config") or
               line.startswith("no config met") for line in lines)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_train_small(tmp_path, arch):
    """``examples/train_small_torch.py`` trains the reduced stub
    architectures (frames, a prefix) and restores its checkpoint."""
    lines = _run("train_small_torch.py", "--arch", arch, "--steps", "4",
                 cwd=tmp_path)
    assert lines[0].startswith(f"training {arch}-reduced: 2L")
    loss = next(line for line in lines if line.startswith("loss "))
    first, last = (float(x) for x in loss.split()[1:4:2])
    assert np.isfinite(first) and np.isfinite(last)
    assert lines[-1] == ("checkpoint roundtrip: max logit delta = 0.00e+00 "
                         "(OK)")
