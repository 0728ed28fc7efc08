"""xLSTM-350M: 24 layers, xLSTM[7:1] — 7 mLSTM per 1 sLSTM group.
Recurrent state => O(1)-per-token decode; runs long_500k.
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50_304, block_pattern="xlstm",
    xlstm_slstm_every=8, supports_long_context=True,
    tie_embeddings=True,
)
