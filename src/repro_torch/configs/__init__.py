"""Architecture registry of the PyTorch port: the same ten ``ModelConfig``s
as the JAX package, kept as the port's own copy (pure data)."""
from .base import (ModelConfig, ShapeConfig, SHAPES, shape_applicable,
                   smoke_variant)

from . import (arctic_480b, chatglm3_6b, deepseek_7b, h2o_danube_1_8b,
               mamba2_370m, paligemma_3b, qwen3_moe_235b_a22b,
               recurrentgemma_9b, seamless_m4t_large_v2, stablelm_3b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (chatglm3_6b, stablelm_3b, deepseek_7b, h2o_danube_1_8b,
              seamless_m4t_large_v2, paligemma_3b, recurrentgemma_9b,
              arctic_480b, qwen3_moe_235b_a22b, mamba2_370m)
}


def get_arch(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "SHAPES", "ShapeConfig", "get_arch",
           "shape_applicable", "smoke_variant"]
