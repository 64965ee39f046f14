"""Plain PyTorch reference of a served request, in float32: what every
MoE model shares.

It imports nothing of the program.  It reads the configuration as the
benchmark's JSON dict, the float weights the benchmark made, a request's
prompt and the tokens the program served, and for each decode position
the state the program routed that step by (``DecodeContext``).  From the
float weights it works out again the AMAT codes of every expert (8-bit
asymmetric groups of 32 along K; the 4-bit MSB view truncates code and
zero-point and scales by 16).

One request is one causal sequence: the prompt, then the token the
prefill produced, then each served token but the last.  Every layer runs
over the whole sequence at once.  The layer loop and the layers that
differ between architectures (embedding, attention, recurrent mixers,
dense FFNs, logits) are each configuration's model module's
(``portbench/models/<model>.py``, its ``served_logits``).  Here, the
parts they share:

* RMSNorm ``x * rsqrt(mean(x^2) + eps) * (1 + w)``; SwiGLU FFNs;
* the MoE layer of a prompt position: softmax router, top-k (lower index
  first among equals), gates renormalized, capacity over the prompt's
  tokens in GShard order (slot k before slot k+1, token order within a
  slot), every expert at 8 bits (prefill is high-bit);
* the MoE layer of a decode position: Cache-Prior (top-k of
  ``p * (1 + alpha * cached)``, gates from ``p``), DBSC criticality
  (gate >= theta), then the capacity and the experts' precision of that
  decode step's batch: the other slots' selections come from the
  context, this slot's are the reference's own.  An expert runs at 8 bits
  when any selection of the batch is critical for it, else at 4;
* shared experts beside the routed ones.

``fp8=True`` is the control: every matrix product takes its operands
rounded to float8 e4m3, activations scaled per row and weights per
output column.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


@dataclasses.dataclass
class DecodeContext:
    """One decode step of the program, as the reference needs it.

    ``cached``: [*layout, E] bool, experts whose MSB slice was resident;
    ``alpha``: the Cache-Prior boost; ``ids``/``active``/``critical``:
    [*layout, T, k] routing of the step's batch; ``slot_mask``: [T];
    ``slot``: this request's row of the batch.  ``layout`` is the model
    module's ``moe_layout``: the leading axes over the MoE layers."""

    cached: np.ndarray
    alpha: float
    ids: np.ndarray
    active: np.ndarray
    critical: np.ndarray
    slot_mask: np.ndarray
    slot: int


@dataclasses.dataclass
class RefRequest:
    prompt: np.ndarray            # [S] int
    fed: np.ndarray               # tokens after the prompt: t0, g0..g[n-2]
    contexts: List[DecodeContext]  # one per fed token


# --------------------------------------------------------------- numerics
def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(F32) * s


def _mm(a: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    a, w = a.to(F32), w.to(F32)
    if fp8:
        a, w = _q8(a, -1), _q8(w, -2)
    return a @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.to(F32))


def _swiglu(x, wi, wo, fp8):
    h = _mm(x, wi, fp8)
    g, u = h.chunk(2, dim=-1)
    return _mm(F.silu(g) * u, wo, fp8)


def amat_dequant(w: torch.Tensor, group: int = 32, bits: int = 8,
                 low_bits: int = 4):
    """(8-bit, 4-bit) dequantized copies of a [K, N] weight, in f32."""
    K, N = w.shape
    wg = w.to(F32).reshape(K // group, group, N)
    qmax = 2 ** bits - 1
    wmin = wg.amin(dim=1, keepdim=True).clamp_max(0.0)
    wmax = wg.amax(dim=1, keepdim=True).clamp_min(0.0)
    s = (wmax - wmin) * (1.0 / qmax)
    s = torch.where(s <= 0, torch.ones_like(s), s)
    zp = torch.clamp(torch.round(-wmin / s), 0, qmax)
    q = torch.clamp(torch.round(wg / s) + zp, 0, qmax)
    shift = 2.0 ** (bits - low_bits)
    hi = (q - zp) * s
    lo = (torch.floor(q / shift) - torch.floor(zp / shift)) * (s * shift)
    return hi.reshape(K, N), lo.reshape(K, N)


def top_k(x: torch.Tensor, k: int):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def capacity(T: int, k: int, E: int, factor: float) -> int:
    return max(8, min(int(T * k * factor / E) + 1, T))


def keep_mask(ids: np.ndarray, E: int, cap: int) -> np.ndarray:
    """GShard capacity over [..., T, k] ids (id ``E`` = no expert):
    slot k before slot k+1, token order within a slot."""
    *lead, T, k = ids.shape
    order = np.swapaxes(ids, -1, -2).reshape(*lead, k * T)
    onehot = order[..., None] == np.arange(E)
    pos = np.cumsum(onehot, axis=-2) - 1
    kept = (pos < cap) & onehot
    keep = kept.any(-1).reshape(*lead, k, T)
    return np.swapaxes(keep, -1, -2)


# ---------------------------------------------------------------------- MoE
def _route_prefill(probs, moe):
    E, k = moe["n_experts"], moe["top_k"]
    g, ids = top_k(probs, k)
    g = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
    T = ids.shape[0]
    keep = keep_mask(ids.cpu().numpy()[None], E,
                     capacity(T, k, E, moe["capacity_factor"]))[0]
    hi = np.ones(ids.shape, bool)
    return g, ids, keep, hi


def _route_decode(probs, moe, ctxs: List[DecodeContext], at: tuple,
                  theta, flips=None):
    E, k = moe["n_experts"], moe["top_k"]
    n = probs.shape[0]
    dev = probs.device
    cached = torch.as_tensor(np.stack([c.cached[at] for c in ctxs]),
                             device=dev).to(F32)
    alpha = torch.tensor([c.alpha for c in ctxs], dtype=F32, device=dev)
    _, ids = top_k(probs * (1.0 + alpha[:, None] * cached), k)
    g = torch.gather(probs, -1, ids)
    g = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
    crit = (g >= theta).cpu().numpy()
    own = ids.cpu().numpy()
    keep = np.zeros((n, k), bool)
    hi = np.zeros((n, k), bool)
    for j, c in enumerate(ctxs):
        act = c.active[at] & c.slot_mask[:, None]
        bids = np.where(act, c.ids[at], E)
        bcrit = c.critical[at] & act
        bids[c.slot], bcrit[c.slot] = own[j], crit[j]
        T = bids.shape[0]
        keep[j] = keep_mask(bids[None], E,
                            capacity(T, k, E, moe["capacity_factor"]))[0][
                                c.slot]
        lsb = np.zeros(E + 1, bool)
        np.logical_or.at(lsb, bids[bcrit], True)
        hi[j] = lsb[own[j]]
        if flips is not None:
            flips[j] += set(own[j]) != set(c.ids[at][c.slot])
    return g, ids, keep, hi


def _moe(p, x, cfg, at: tuple, n_prompt, ctxs, fp8, theta, flips):
    """The MoE layer at index ``at`` of the routing layout, over the
    prompt's ``n_prompt`` positions and then one decode position per
    context."""
    moe = cfg["moe"]
    m = p["moe"]
    h = _rms(x, p["moe_norm"], cfg["norm_eps"])
    probs = torch.softmax(_mm(h, m["w_router"], fp8), dim=-1)
    parts = [_route_prefill(probs[:n_prompt], moe)]
    if ctxs:
        parts.append(_route_decode(probs[n_prompt:], moe, ctxs, at, theta,
                                   flips))
    g = torch.cat([q[0] for q in parts])
    ids = torch.cat([q[1] for q in parts]).cpu().numpy()
    keep = np.concatenate([q[2] for q in parts])
    hi = np.concatenate([q[3] for q in parts])
    y = torch.zeros_like(h)
    for e in np.unique(ids[keep]):
        wi2 = amat_dequant(m["experts"]["wi"][e])
        wo2 = amat_dequant(m["experts"]["wo"][e])
        for j, prec in enumerate((True, False)):     # (8-bit, 4-bit)
            rows, slots = np.nonzero((ids == e) & keep & (hi == prec))
            if rows.size == 0:
                continue
            wi, wo = wi2[j], wo2[j]
            r = torch.as_tensor(rows, device=x.device)
            out = _swiglu(h[r], wi, wo, fp8)
            gate = g[r, torch.as_tensor(slots, device=x.device)]
            y.index_add_(0, r, out * gate[:, None])
        del wi2, wo2
    if "shared" in m:
        y = y + _swiglu(h, m["shared"]["wi"], m["shared"]["wo"], fp8)
    return x + y


@contextlib.contextmanager
def no_tf32():
    """Matrix products in full float32 on the card, TF32 off."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def logit_gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the row's best."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, chosen[:, None].long())[:, 0]
