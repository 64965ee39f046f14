"""Training entry point (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch qwen15-moe-repro ...``

Trains on one device, ``cuda`` unless ``--device`` says otherwise, on the
synthetic zipf-markov stream.  A prefix config (``internvl2-1b``) trains
on the text after ``prefix_len`` tokens are cut off each batch, behind
stub patch embeddings; an encoder-decoder (``whisper-small``) on stub
encoder frames; both stubs are numpy draws seeded by the step, scaled by
0.02, as the reference draws them.  The reference's ``--mesh
pod|multipod`` lowers onto a TPU pod mesh and raises here (ROADMAP.md
queue 1, 'Launch and dry-run, last').
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as MDL
from repro_torch.optim import adamw as OPT


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               opt_cfg=None, log_every: int = 10,
               ckpt_dir: str | None = None, seed: int = 0,
               collect_history: bool = False, device=None):
    """Returns final (params, opt_state, history).  Params start from the
    port's init with ``seed``; ``history`` holds the metrics of every
    logged step (of every step with ``collect_history``) with ``step``
    and ``wall_s``, the seconds since the loop began, read after the
    step's loss reached the host."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OPT.AdamWConfig(total_steps=steps,
                                         warmup_steps=max(steps // 10, 1))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq_len,
                                  global_batch=global_batch, seed=seed))
    step_fn = make_train_step(cfg, opt_cfg)
    params = MDL.init_params(cfg, seed=seed, device=dev)
    opt_state = OPT.init_state(params, opt_cfg)

    history = []
    t0 = time.perf_counter()
    for step, batch in enumerate(data.batches()):
        if step >= steps:
            break
        inputs = {k: torch.as_tensor(batch[k], dtype=torch.int64,
                                     device=dev)
                  for k in ("tokens", "labels")}
        if cfg.prefix_len:
            inputs["tokens"] = inputs["tokens"][:, :-cfg.prefix_len]
            inputs["labels"] = inputs["labels"][:, :-cfg.prefix_len]
            inputs["prefix_embeds"] = _stub_prefix(
                cfg, global_batch, batch["step"], dev)
        if cfg.is_encdec:
            inputs["encoder_frames"] = _stub_frames(
                cfg, global_batch, batch["step"], dev)
        params, opt_state, metrics = step_fn(params, opt_state, inputs)
        logged = step % log_every == 0 or step == steps - 1
        if collect_history or logged:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if logged:
                print(f"step {step:5d}  loss {m['loss']:.4f}  "
                      f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}",
                      flush=True)
    if ckpt_dir:
        CKPT.save(ckpt_dir, {"params": params}, step=steps)
    return params, opt_state, history


def _stub(cfg, shape, seed, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    draw = rng.standard_normal(shape, np.float32) * 0.02
    return torch.from_numpy(draw).to(device=resolve_device(device),
                                     dtype=MDL._dt(cfg))


def _stub_prefix(cfg, batch, step, device=None) -> torch.Tensor:
    """Stand-in patch embeddings [batch, prefix_len, d_model] for
    ``step``, in the model dtype."""
    return _stub(cfg, (batch, cfg.prefix_len, cfg.d_model), (step, 0xF00D),
                 device)


def _stub_frames(cfg, batch, step, device=None) -> torch.Tensor:
    """Stand-in encoder frames [batch, encoder_seq, d_model] for
    ``step``, in the model dtype."""
    return _stub(cfg, (batch, cfg.encoder_seq, cfg.d_model), (step, 0xFEED),
                 device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant of the arch")
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh} lowers onto a TPU pod mesh, which is not "
            "ported (ROADMAP.md queue 1, 'Launch and dry-run, last')")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = OPT.AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 10, 1))
    _, _, history = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        opt_cfg=opt_cfg, ckpt_dir=args.ckpt, device=args.device)
    print(json.dumps(history[-1]))


if __name__ == "__main__":
    main()
