from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeCell, SHAPES, get_config, all_configs,
    register, reduced, ATTN_KINDS, RECURRENT_KINDS, FFN_MIXERS, YaRN,
)
