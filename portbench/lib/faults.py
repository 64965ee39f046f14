"""Faults planted under the timed path, to show that the check catches
them: each wraps the program's decode step (``repro_torch.models.model.
decode_step``).

The faults a serving cell can have: a step that returns its state
unchanged; half of the batch left out; a token altered where it is
produced.  The exchange between chips has no counterpart: every cell runs
on one chip, and the port has no path across chips."""

from __future__ import annotations

import torch


def _state_unchanged(orig):
    def step(params, cfg, token, cache, **kw):
        saved = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in cache.items() if k != "pos"}
        out = orig(params, cfg, token, cache, **kw)
        for k, v in saved.items():
            for n, t in v.items():
                cache[k][n].copy_(t)
        return out
    return step


def _half_batch(orig):
    def step(params, cfg, token, cache, **kw):
        logits, new_cache, aux = orig(params, cfg, token, cache, **kw)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, new_cache, aux
    return step


def _token_altered(orig):
    gen = torch.Generator().manual_seed(5)

    def step(params, cfg, token, cache, **kw):
        logits, new_cache, aux = orig(params, cfg, token, cache, **kw)
        logits = logits.clone()
        b = int(torch.randint(logits.shape[0], (1,), generator=gen))
        v = int(torch.randint(logits.shape[1], (1,), generator=gen))
        logits[b, v] = 1e9
        return logits, new_cache, aux
    return step


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


def plant(name: str):
    """Break the program's decode step with fault ``name``; returns a
    function that mends it."""
    import repro_torch.models.model as MDL

    orig = MDL.decode_step
    MDL.decode_step = FAULTS[name](orig)

    def mend():
        MDL.decode_step = orig
    return mend
