"""Mamba2 (SSD, state-space duality) mixer (port of ``repro.models.ssm``).

The chunked SSD algorithm [arXiv:2405.21060] for train and prefill, and
the O(1)-per-token recurrent update for decode.  Used by ``mamba2-2.7b``
(a pure SSM stack) and ``jamba-v0.1-52b`` (a 1:7 attention:SSM hybrid;
Jamba ships Mamba-1, adapted here to the SSD form with its published
state size, as in the reference).  Plain PyTorch, as the reference is
plain ``jnp``: the reference's ``lax.scan`` over chunks is a Python loop
with f32 carries.

Shapes (one group for B/C, broadcast over heads):
  u        [B, L, d_model]
  x        [B, L, H, P]      P = head_dim
  dt       [B, L, H]
  B_, C_   [B, L, N]         N = d_state
  state    [B, H, P, N]      f32

The cast points are the reference's, so a bf16 run rounds where the
reference rounds: the conv sums in f32 and casts to the input dtype, its
SiLU runs in f32 and casts to ``u``'s dtype, ``ssd_chunked`` returns ``y``
in ``x``'s dtype, ``D`` is cast to ``u``'s dtype before ``y + x*D``, the
gated RMSNorm runs in f32 and casts before ``out_proj``; in decode the
conv sums in f32 and adds ``conv_b`` before the SiLU.

One departure: with ``init_conv`` and a sequence shorter than
``d_conv - 1``, the reference pads the already long window (``init_conv``
followed by the new rows) on the left and returns ``2 * (d_conv - 1)``
rows; ``ssm_forward`` returns the last ``d_conv - 1`` of them, the window
``ssm_decode_step`` reads.  Without ``init_conv`` (the model's prefill)
the two agree.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_channels(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.d_state

    def in_proj_cols(self, d_model: int) -> int:
        # z, x, B, C, dt
        return (2 * self.d_inner(d_model) + 2 * self.d_state
                + self.n_heads(d_model))


def ssm_param_shapes(d_model: int, cfg: SSMCfg) -> dict:
    di = cfg.d_inner(d_model)
    return {
        "in_proj": (d_model, cfg.in_proj_cols(d_model)),
        "conv_w": (cfg.d_conv, cfg.conv_channels(d_model)),
        "conv_b": (cfg.conv_channels(d_model),),
        "A_log": (cfg.n_heads(d_model),),
        "D": (cfg.n_heads(d_model),),
        "dt_bias": (cfg.n_heads(d_model),),
        "norm_scale": (di,),
        "out_proj": (di, d_model),
    }


def _split_proj(proj: torch.Tensor, d_model: int, cfg: SSMCfg):
    di = cfg.d_inner(d_model)
    n = cfg.d_state
    return torch.split(proj, [di, di, n, n, proj.shape[-1] - 2 * di - 2 * n],
                       dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: [B, L, C]; w: [K, C].  The reference's
    loop over the K taps, summed in f32 in its order (``F.conv1d`` sums in
    another)."""
    k, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + length].to(torch.float32) \
            * w[i].to(torch.float32)
    return (out + b.to(torch.float32)).to(x.dtype)


def _segsum(t: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < s <= i} t[..., s],
    -inf above the diagonal."""
    n = t.shape[-1]
    c = torch.cumsum(t, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=t.device))
    return out.masked_fill(~mask, float("-inf"))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, that is ``logaddexp(x, 0)``, in the same form.
    ``F.softplus`` returns ``x`` itself above its ``threshold=20`` and
    ``log1p(exp(x))`` below; writing the reference's formula keeps the
    question of that switch out of the parity."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor, chunk: int,
                init_state=None):
    """Chunked SSD scan.

    x [b,l,h,p], dt [b,l,h] (post-softplus), A [h] (negative), B_/C_ [b,l,n].
    Returns (y [b,l,h,p] in ``x``'s dtype, final_state [b,h,p,n] f32).
    """
    b, l, h, p = x.shape
    n = B_.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    L = x.shape[1]
    nc = L // chunk
    f32 = torch.float32

    xf = x.to(f32).reshape(b, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(b, nc, chunk, h)
    Bf = B_.to(f32).reshape(b, nc, chunk, n)
    Cf = C_.to(f32).reshape(b, nc, chunk, n)

    dA = dtf * A.to(f32)[None, None, None, :]               # [b,c,q,h]
    dA_cum = torch.cumsum(dA, dim=2)                        # [b,c,q,h]

    # --- intra-chunk (the "attention-like" quadratic term) ---------------
    Lmat = torch.exp(_segsum(dA.transpose(2, 3)))           # [b,c,h,q,q]
    CB = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)            # [b,c,q,q]
    gate = Lmat * CB[:, :, None]                            # [b,c,h,q,k]
    xdt = xf * dtf[..., None]                               # [b,c,q,h,p]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", gate, xdt)
    del Lmat, gate

    # --- chunk boundary states -------------------------------------------
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # [b,c,q,h]
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bf,
                          decay_states * dtf, xf)            # [b,c,h,p,n]

    # --- inter-chunk recurrence over chunk states (the reference's scan) --
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])             # [b,c,h]
    st = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # [b,c,h,p,n]

    # --- contribution of previous-chunk states ---------------------------
    state_decay = torch.exp(dA_cum)                          # [b,c,q,h]
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cf, prev_states,
                         state_decay)

    y = (y_diag + y_off).reshape(b, L, h, p)[:, :l]
    return y.to(x.dtype), st


def _gated_norm_out(params: dict, y: torch.Tensor, z: torch.Tensor,
                    dtype) -> torch.Tensor:
    """Gated RMSNorm in f32, cast to ``dtype``, then ``out_proj``."""
    g = F.silu(z.to(torch.float32))
    yf = y.to(torch.float32) * g
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yn = yf * torch.rsqrt(var + 1e-5) * (1.0 + params["norm_scale"])
    return yn.to(dtype) @ params["out_proj"]


def ssm_forward(params: dict, u: torch.Tensor, cfg: SSMCfg,
                init_state=None, init_conv=None, return_state=False):
    """Full Mamba2 mixer forward over a sequence.  u: [B, L, d_model].
    With ``return_state`` returns (out, (state, conv_tail)): the final
    SSD state [B, H, P, N] in f32 and the last ``d_conv - 1`` conv inputs
    [B, d_conv - 1, conv_channels], zero-padded on the left for a shorter
    sequence."""
    b, l, d_model = u.shape
    di = cfg.d_inner(d_model)
    h = cfg.n_heads(d_model)

    proj = u @ params["in_proj"]
    z, xc, Bc, Cc, dt = _split_proj(proj, d_model, cfg)

    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    if init_conv is not None:
        conv_in = torch.cat([init_conv.to(conv_in.dtype), conv_in], dim=1)
    conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    if init_conv is not None:
        conv_out = conv_out[:, init_conv.shape[1]:]
    conv_out = F.silu(conv_out.to(torch.float32)).to(u.dtype)
    xc, Bc, Cc = torch.split(conv_out, [di, cfg.d_state, cfg.d_state],
                             dim=-1)

    x = xc.reshape(b, l, h, cfg.head_dim)
    A = -torch.exp(params["A_log"].to(torch.float32))
    dt = _softplus(dt.to(torch.float32)
                   + params["dt_bias"].to(torch.float32))

    y, state = ssd_chunked(x, dt, A, Bc, Cc, cfg.chunk, init_state)
    y = y + x * params["D"].to(u.dtype)[None, None, :, None]
    out = _gated_norm_out(params, y.reshape(b, l, di), z, u.dtype)

    if return_state:
        # The final conv window, for decode to continue from.
        k1 = cfg.d_conv - 1
        tail = conv_in[:, -k1:] if conv_in.shape[1] >= k1 else \
            F.pad(conv_in, (0, 0, k1 - conv_in.shape[1], 0))
        return out, (state, tail)
    return out


def ssm_decode_step(params: dict, u: torch.Tensor, state: torch.Tensor,
                    conv_buf: torch.Tensor, cfg: SSMCfg):
    """One-token recurrent update.

    u: [B, d_model]; state: [B, H, P, N] (f32);
    conv_buf: [B, d_conv-1, conv_channels], the trailing conv window.
    Returns (y [B, d_model], new_state, new_conv_buf), new tensors.
    """
    b, d_model = u.shape
    di = cfg.d_inner(d_model)
    h = cfg.n_heads(d_model)
    f32 = torch.float32

    proj = u @ params["in_proj"]
    z, xc, Bc, Cc, dt = _split_proj(proj, d_model, cfg)

    conv_in = torch.cat([xc, Bc, Cc], dim=-1)                # [B, convch]
    window = torch.cat([conv_buf, conv_in[:, None, :].to(conv_buf.dtype)],
                       dim=1)
    conv = torch.sum(window.to(f32) * params["conv_w"].to(f32)[None],
                     dim=1) + params["conv_b"].to(f32)
    conv = F.silu(conv).to(u.dtype)
    xc, Bc, Cc = torch.split(conv, [di, cfg.d_state, cfg.d_state], dim=-1)

    x = xc.reshape(b, h, cfg.head_dim).to(f32)
    A = -torch.exp(params["A_log"].to(f32))
    dt = _softplus(dt.to(f32) + params["dt_bias"].to(f32))   # [B, H]
    da = torch.exp(dt * A[None, :])                          # [B, H]

    Bf = Bc.to(f32)                                          # [B, N]
    Cf = Cc.to(f32)
    state = state * da[..., None, None] \
        + torch.einsum("bh,bhp,bn->bhpn", dt, x, Bf)
    y = torch.einsum("bhpn,bn->bhp", state, Cf) \
        + x * params["D"].to(f32)[None, :, None]
    out = _gated_norm_out(params, y.reshape(b, di), z, u.dtype)
    return out, state, window[:, 1:]
