"""Architecture registry: the reference's 10 model configurations
(``repro/configs``), copied; the LLM serving path runs the ``attn``
block pattern without experts (``models/transformer.py``)."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable  # noqa: F401

from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3
from repro_torch.configs.phi35_moe_42b_a66b import CONFIG as _phi35
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    _qwen3, _phi35, _granite, _nemotron, _minicpm,
    _starcoder2, _musicgen, _xlstm, _chameleon, _zamba2,
]}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
