"""A test-only model module: one dense layer, then three MoE layers, each
with one attention mixer.  Its routing records have one leading axis of
3 MoE layers, which ``n_layers // len(pattern)`` periods cannot express.
It models only what the layout tests read: ``moe_layout`` and
``layer_work``."""

from portbench.lib.counts import BF16, LayerWork

N_MOE = 3


def moe_layout(cfg: dict) -> tuple:
    return (N_MOE,)


def layer_work(cfg: dict) -> LayerWork:
    d, f, E = cfg["d_model"], cfg["d_ff"], cfg["moe"]["n_experts"]
    H, hd = cfg["n_heads"], cfg["head_dim"]
    n_layers = 1 + N_MOE
    mm = d * 2 * f + f * d + N_MOE * d * E + n_layers * 4 * d * H * hd
    return LayerWork(mm=mm, weight_bytes=mm * BF16,
                     attn_flops_row=n_layers * 4.0 * H * hd,
                     kv_bytes_row=n_layers * 2 * H * hd * BF16,
                     state_bytes=0, scan_flops=0)
