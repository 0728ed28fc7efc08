"""MiniCPM-2B: llama-like dense MHA (kv=36), WSD schedule, depth-scaled
residuals and scaled embeddings. [arXiv:2404.06395; hf]"""
import math

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122_753, mlp_type="swiglu",
    lr_schedule="wsd", tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(40), embed_scale=12.0,
)
