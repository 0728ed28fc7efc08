"""StarCoder2-3B: dense GQA kv=2, gelu MLP, RoPE.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12_288, vocab_size=49_152, mlp_type="gelu",
    rope_theta=100_000.0,
)
