"""Zamba2-7B: Mamba2 backbone (81 layers, ssm_state=64) with one
weight-shared attention+MLP block applied every 6 Mamba layers
(simplified: no per-application LoRA; see DESIGN.md). Runs long_500k.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14_336, vocab_size=32_000, mlp_type="swiglu",
    ssm_state=64, block_pattern="zamba", shared_attn_every=6,
    supports_long_context=True,
)
