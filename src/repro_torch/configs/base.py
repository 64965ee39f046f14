"""Model / shape configuration system (port of ``repro.configs.base``).

Each ported configuration is a ``repro_torch/configs/<id>.py`` exporting
``CONFIG``.  Field names and defaults equal the reference dataclass, so a
config compares field by field with its JAX counterpart.  The ported
configurations are every one of the reference's: the ten assigned
architectures (``ARCH_IDS``: the dense ``smollm-360m``, ``gemma-7b``,
``nemotron-4-15b`` and ``starcoder2-3b``, the MoE
``llama4-scout-17b-a16e`` and ``llama4-maverick-400b-a17b``, the SSM
``mamba2-2.7b``, the hybrid ``jamba-v0.1-52b``, the VLM backbone
``internvl2-1b`` with its 256-embedding prefix stub and the
encoder-decoder ``whisper-small`` with its frame stub), the two
paper-reproduction MoE models (``REPRO_IDS``) and the full-width
``qwen15-moe-a2.7b``.  ``reduced()`` derives the CPU-smoke-test variant
(2 layers, or two periods of a longer pattern; d_model <= 256, <= 4
experts, an SSM state of <= 16 with heads of 32 and chunks of 32, <= 2
encoder layers over <= 16 frames, a prefix of <= 8) of the same family.
``SHAPES`` holds the four input shapes of the dry-run and the launch
layer (``ShapeConfig``: a train, a prefill and two decode shapes).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

from repro_torch.models.moe import MoECfg
from repro_torch.models.ssm import SSMCfg


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One position in the repeating layer pattern."""

    mixer: str          # 'attn' | 'ssm'
    ffn: str            # 'dense' | 'moe' | 'none'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    pattern: Optional[Tuple[BlockSpec, ...]] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None
    always_swa: bool = False
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    qkv_bias: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0
    prefix_len: int = 0
    dtype: str = "bfloat16"
    source: str = ""                     # citation
    seq_parallel: bool = False
    onehot_embed: bool = False
    kv_dtype: str = "bfloat16"
    quantized_serve: bool = False
    ring_kv: bool = False
    remat_policy: str = "full"
    pad_vocab_to: int = 1

    @property
    def padded_vocab(self) -> int:
        pv = self.pad_vocab_to
        return ((self.vocab_size + pv - 1) // pv) * pv if pv > 1 \
            else self.vocab_size

    @property
    def block_pattern(self) -> Tuple[BlockSpec, ...]:
        if self.pattern is not None:
            return self.pattern
        ffn = "moe" if self.moe is not None else "dense"
        mixer = "ssm" if self.arch_type == "ssm" else "attn"
        if self.arch_type == "ssm":
            ffn = "none"
        return (BlockSpec(mixer, ffn),)

    @property
    def n_periods(self) -> int:
        plen = len(self.block_pattern)
        if self.n_layers % plen != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {plen}")
        return self.n_layers // plen

    @property
    def has_attention(self) -> bool:
        return any(b.mixer == "attn" for b in self.block_pattern)

    @property
    def has_ssm(self) -> bool:
        return any(b.mixer == "ssm" for b in self.block_pattern)

    @property
    def has_moe(self) -> bool:
        return any(b.ffn == "moe" for b in self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the 500k decode shape?"""
        if self.arch_type in ("ssm",):
            return True
        if self.arch_type == "hybrid":
            return True      # attention layers get the sliding window
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        from repro_torch.models.model import param_shapes, shape_leaves

        total = 0
        for shape in shape_leaves(param_shapes(self)):
            n = 1
            for s in shape:
                n *= s
            total += n
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        total = self.param_count()
        if self.moe is None:
            return total
        from repro_torch.models.moe import moe_param_shapes

        es = moe_param_shapes(self.d_model, self.moe)["experts"]
        per_expert = 0
        for shape in es.values():
            n = 1
            for s in shape[1:]:
                n *= s
            per_expert += n
        n_moe_layers = sum(
            1 for b in self.block_pattern if b.ffn == "moe") * self.n_periods
        inactive = per_expert * (self.moe.n_experts - self.moe.top_k) \
            * n_moe_layers
        return total - inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (the reference's
        rule)."""
        plen = len(self.block_pattern)
        n_kv = min(self.n_kv_heads, 2)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff=min(self.moe.d_ff, 128),
                d_ff_shared=min(self.moe.d_ff_shared, 128)
                if self.moe.d_ff_shared else 0,
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(
                self.ssm, d_state=min(self.ssm.d_state, 16),
                head_dim=32, chunk=32)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 * plen if plen > 1 else 2,
            d_model=min(self.d_model, 256),
            n_heads=n_kv * max(1, min(self.n_heads // self.n_kv_heads, 2)),
            n_kv_heads=n_kv,
            head_dim=32,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            moe=moe,
            ssm=ssm,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            prefix_len=min(self.prefix_len, 8) if self.prefix_len else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
        )


# --------------------------------------------------------------------------
# Input shapes (the reference's four, same names and numbers)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = (
    "internvl2-1b",
    "llama4-maverick-400b-a17b",
    "jamba-v0.1-52b",
    "starcoder2-3b",
    "llama4-scout-17b-a16e",
    "nemotron-4-15b",
    "gemma-7b",
    "smollm-360m",
    "mamba2-2.7b",
    "whisper-small",
)

# Paper-reproduction MoE configs (DeepSeek-V2-Lite / Qwen1.5-MoE structure).
REPRO_IDS = ("deepseek-v2-lite-repro", "qwen15-moe-repro")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def list_configs():
    return {a: get_config(a) for a in ARCH_IDS}
