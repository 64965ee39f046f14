"""Smoke run of ``examples/serve_slicemoe_torch.py`` on the CPU.

The example serves a checkpoint that either package wrote (``--ckpt``):
weights drawn once by the port's init at ``qwen15-moe-repro``'s full
repro size, saved by the reference's writer or the port's, then served
at a tiny traffic size in a subprocess with a timeout.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro_torch.checkpoint import ckpt as TCK
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLE = os.path.join(ROOT, "examples", "serve_slicemoe_torch.py")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_serve_example_runs_on_a_checkpoint(tmp_path, writer):
    params = TM.init_params(get_config("qwen15-moe-repro"), seed=0,
                            device="cpu")
    path = str(tmp_path / "ckpt")
    if writer == "port":
        TCK.save(path, {"params": params}, step=0)
    else:
        tree = jax.tree.map(
            lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), params)
        JCK.save(path, {"params": tree}, step=0)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, EXAMPLE, "--ckpt", path, "--device", "cpu",
         "--requests", "2", "--prompt-len", "8", "--max-new", "3",
         "--cache-mb", "1.0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any(line.startswith("=== phase 1: load") for line in lines)
    for rid in range(2):
        assert any(line.startswith(f"request {rid}: 3 tokens")
                   for line in lines), out.stdout
