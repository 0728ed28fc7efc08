"""MusicGen-large: decoder-only over EnCodec tokens; the EnCodec frontend
is a STUB — inputs are precomputed frame embeddings (B, S, d_model), the
head predicts the 2048-entry codebook. [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, mlp_type="gelu",
    input_mode="embeddings",
)
