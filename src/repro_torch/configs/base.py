"""Architecture + shape configuration system (the reference's
``repro/configs/base.py``, copied; only the imports differ).

``ModelConfig`` is the single source of truth consumed by
``repro_torch.models.transformer`` (init/forward/prefill/decode); one
``configs/<arch>.py`` per architecture instantiates it with the published
numbers, and ``reduced()`` derives the CPU-test variant of the same
family.  ``ShapeConfig`` records the reference's input shapes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 ⇒ d_model // num_heads
    mlp_type: str = "swiglu"       # swiglu | gelu | relu2
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM / recurrent
    ssm_state: int = 0
    block_pattern: str = "attn"    # attn | xlstm | zamba
    shared_attn_every: int = 0     # zamba: 1 shared attn per this many mamba
    xlstm_slstm_every: int = 0     # xlstm: 1 sLSTM per this many layers
    # frontends
    input_mode: str = "tokens"     # tokens | embeddings (modality stub)
    # distribution hints (set by the launcher, not by arch files)
    kv_replication: int = 1        # GQA KV-head replication for TP
    # numerics / schedule hints
    dtype: str = "bfloat16"
    residual_scale: float = 1.0    # minicpm depth-scaled residuals
    embed_scale: float = 1.0
    lr_schedule: str = "cosine"    # cosine | wsd
    # long-context applicability (assignment: sub-quadratic archs only)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to 128 so the embedding/head shard over the
        model axis (vocab-parallel logits); pad columns are masked to −inf
        in the loss/sampling paths.  49155-style vocabs otherwise force
        d_model-sharded embeddings, whose CE contraction all-reduces the
        full (B, S, V) logit tensor — catastrophic (measured in §Perf)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
        num_layers = {"xlstm": 4, "zamba": 5}.get(self.block_pattern, 2)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2))
            if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            xlstm_slstm_every=2 if self.xlstm_slstm_every else 0,
        )

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count (used for memory estimates)."""
        from repro_torch.models import transformer
        return transformer.param_count(self)

    def active_param_count(self) -> int:
        """Active (per-token) parameters — N in MODEL_FLOPS = 6·N·D."""
        from repro_torch.models import transformer
        return transformer.param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic sequence mixing."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 512k dense KV cache is "
                       "intractable; skipped per assignment rules")
    return True, ""
