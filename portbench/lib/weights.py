"""The model's float weights, made on the device from the seed.

The benchmark makes the weights itself and hands the same tree to the
program and to the plain reference (which makes it again after the
window, from the same seed).  The tree's layout is the program's input
format: ``embed [V, d]``, ``unembed [d, V]``, ``final_norm [d]`` and
``blocks/pos{i}`` for each position of the layer pattern, every leaf
stacked over the pattern's periods.  The draws follow the program's rule
(vectors zero, matrices normal at ``fan_in ** -0.5``, the SSD mixer's
``A_log = log(linspace(1, 16, H))``, ``D = 1``, ``dt_bias = -2`` in f32 and
``conv_w`` normal times 0.2; a leaf that is a vector in each period is
zero) but are the benchmark's own numbers: one ``torch.randn`` per period
of a leaf, in the model's dtype, from one ``torch.Generator`` on the
device.
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_F32_SSM = ("A_log", "D", "dt_bias")


def _gated(mlp_type: str) -> bool:
    return mlp_type in ("swiglu", "geglu")


def _mlp(d: int, f: int, mlp_type: str) -> dict:
    return {"wi": (d, 2 * f if _gated(mlp_type) else f), "wo": (f, d)}


def ssm_dims(cfg: dict) -> dict:
    s, d = cfg["ssm"], cfg["d_model"]
    di = s["expand"] * d
    return {"d_inner": di, "heads": di // s["head_dim"],
            "head_dim": s["head_dim"], "d_state": s["d_state"],
            "d_conv": s["d_conv"], "conv_ch": di + 2 * s["d_state"]}


def _block(cfg: dict, spec: dict) -> dict:
    d, h, kv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    sh: dict = {}
    if spec["mixer"] == "attn":
        sh.update({"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
                   "wo": (h * hd, d), "norm": (d,)})
        if cfg.get("qkv_bias", False):
            sh.update({"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)})
    else:
        m = ssm_dims(cfg)
        H = m["heads"]
        sh["ssm"] = {
            "in_proj": (d, 2 * m["d_inner"] + 2 * m["d_state"] + H),
            "conv_w": (m["d_conv"], m["conv_ch"]),
            "conv_b": (m["conv_ch"],), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm_scale": (m["d_inner"],),
            "out_proj": (m["d_inner"], d)}
        sh["ssm_norm"] = (d,)
    if spec["ffn"] == "dense":
        sh["mlp"] = _mlp(d, cfg["d_ff"], cfg["mlp_type"])
        sh["mlp_norm"] = (d,)
    elif spec["ffn"] == "moe":
        moe = cfg["moe"]
        E, f = moe["n_experts"], moe["d_ff"]
        wi_cols = 2 * f if _gated(moe["mlp_type"]) else f
        sh["moe"] = {"w_router": (d, E),
                     "experts": {"wi": (E, d, wi_cols), "wo": (E, f, d)}}
        if moe.get("n_shared_experts", 0) > 0:
            sh["moe"]["shared"] = _mlp(d, moe.get("d_ff_shared") or f,
                                       moe["mlp_type"])
        sh["moe_norm"] = (d,)
    return sh


def _stack(tree: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + tuple(v)
            for k, v in tree.items()}


def pattern(cfg: dict) -> list:
    return cfg["pattern"]


def n_periods(cfg: dict) -> int:
    return cfg["n_layers"] // len(pattern(cfg))


def shape_tree(cfg: dict) -> dict:
    """Shapes of the weight tree (the program's input format)."""
    blocks = {f"pos{i}": _stack(_block(cfg, spec), n_periods(cfg))
              for i, spec in enumerate(pattern(cfg))}
    return {"embed": (cfg["vocab_size"], cfg["d_model"]), "blocks": blocks,
            "final_norm": (cfg["d_model"],),
            "unembed": (cfg["d_model"], cfg["vocab_size"])}


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict:
    """The weight tree for ``seed`` on ``device``, in the model dtype."""
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + 97) % (2 ** 63))

    def leaf(name: str, shape: tuple, stacked: bool,
             in_ssm: bool) -> torch.Tensor:
        core = shape[1:] if stacked else shape
        if in_ssm and name in _F32_SSM:
            if name == "A_log":
                row = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                               device=device))
                return row.expand(shape).contiguous()
            fill = 1.0 if name == "D" else -2.0
            return torch.full(shape, fill, dtype=torch.float32,
                              device=device)
        if len(core) == 1:
            return torch.zeros(shape, dtype=dtype, device=device)
        std = 0.2 if (in_ssm and name == "conv_w") else core[-2] ** -0.5
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out.view(shape[0], -1) if stacked else [out]):
            torch.randn(part.shape, generator=gen, out=part)
            part.mul_(std)
        return out

    def build(tree: dict, stacked: bool, in_ssm: bool = False) -> dict:
        out = {}
        for k in sorted(tree):
            v = tree[k]
            out[k] = build(v, stacked or k == "blocks", k == "ssm") \
                if isinstance(v, dict) else leaf(k, v, stacked, in_ssm)
        return out

    return build(shape_tree(cfg), False)
