"""Nemotron-4-15B: dense GQA kv=8, squared-ReLU MLP, 256k vocab.
[arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24_576, vocab_size=256_000, mlp_type="relu2",
)
