"""Training example on the port (the counterpart of
``examples/train_small.py``; imports no JAX): any assigned architecture,
reduced or full config.

Trains on the synthetic zipf-markov stream with AdamW + cosine schedule,
prints the loss curve, saves a checkpoint with the port's writer,
restores it and checks that the logits match: the whole substrate loop
(data -> train -> ckpt -> restore).  A prefix config (``internvl2-1b``)
trains behind stub patch embeddings and an encoder-decoder
(``whisper-small``) on stub frames; the round trip feeds both zeros, as
the reference does.

Run:  PYTHONPATH=src python examples/train_small_torch.py --arch whisper-small
      [--device cpu] (the reduced variant by default; --full for the real
      config)
"""

import os as _os
import sys as _sys

_root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..")
for _p in (_os.path.join(_root, "src"), _root):
    if _p not in _sys.path:
        _sys.path.insert(0, _p)

import argparse  # noqa: E402
import os  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from repro_torch.checkpoint import ckpt as CKPT  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.model import forward, unembed  # noqa: E402
from repro_torch.optim import adamw as OPT  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="train the full config (CPU: very slow)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"pattern={[f'{b.mixer}/{b.ffn}' for b in cfg.block_pattern]}")

    ckpt_dir = os.path.join(tempfile.gettempdir(), f"repro_torch_{cfg.name}")
    params, _, history = train_loop(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        opt_cfg=OPT.AdamWConfig(lr=2e-3, total_steps=args.steps,
                                warmup_steps=max(args.steps // 10, 1)),
        ckpt_dir=ckpt_dir, log_every=max(args.steps // 8, 1), device=dev)

    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")

    # restore + verify
    restored = CKPT.restore(ckpt_dir, dev)["params"]
    toks = (torch.arange(16, device=dev)[None, :] % cfg.vocab_size)
    dtype = getattr(torch, cfg.dtype)
    kw = {}
    if cfg.prefix_len:
        kw["prefix_embeds"] = torch.zeros((1, cfg.prefix_len, cfg.d_model),
                                          dtype=dtype, device=dev)
    if cfg.is_encdec:
        kw["encoder_frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                                           dtype=dtype, device=dev)
    with torch.no_grad():
        h1, _ = forward(params, cfg, toks, **kw)
        h2, _ = forward(restored, cfg, toks, **kw)
        l1 = unembed(params, cfg, h1[:, -1])
        l2 = unembed(restored, cfg, h2[:, -1])
    err = float((l1 - l2).abs().max())
    print(f"checkpoint roundtrip: max logit delta = {err:.2e} "
          f"({'OK' if err < 1e-5 else 'MISMATCH'})")


if __name__ == "__main__":
    main()
