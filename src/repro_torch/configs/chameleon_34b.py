"""Chameleon-34B: early-fusion VLM — VQ image tokens share the 65536-entry
vocabulary with text (the VQ tokenizer itself is the STUB frontend), so
the backbone consumes plain token ids. GQA kv=8, qk-norm.
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22_016, vocab_size=65_536, mlp_type="swiglu", qk_norm=True,
)
