"""Architecture registry of the PyTorch port: the same ten ``ModelConfig``s
as the JAX package, kept as the port's own copy (pure data), and
granite-4.0-h-small, which the port alone serves (``STUDY_ARCHS`` names
the ten, the dry-run's architectures)."""
from .base import (ModelConfig, ShapeConfig, SHAPES, shape_applicable,
                   smoke_variant)

from . import (arctic_480b, chatglm3_6b, deepseek_7b,
               granite_4_0_h_small, h2o_danube_1_8b, mamba2_370m,
               paligemma_3b, qwen3_moe_235b_a22b, recurrentgemma_9b,
               seamless_m4t_large_v2, stablelm_3b)

_STUDY = (chatglm3_6b, stablelm_3b, deepseek_7b, h2o_danube_1_8b,
          seamless_m4t_large_v2, paligemma_3b, recurrentgemma_9b,
          arctic_480b, qwen3_moe_235b_a22b, mamba2_370m)
STUDY_ARCHS = tuple(m.CONFIG.name for m in _STUDY)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (*_STUDY, granite_4_0_h_small)
}


def get_arch(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "SHAPES", "STUDY_ARCHS", "ShapeConfig",
           "get_arch", "shape_applicable", "smoke_variant"]
