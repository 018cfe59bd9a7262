"""Public model API of the port: init / shape-spec / input entry points.

Counterpart of the JAX package's models/model.py.  Every entry point runs
on the CUDA card unless the caller passes ``device="cpu"``; random draws
come from an explicit ``torch.Generator`` on that device.  The modality
front ends are stubs, as in the reference: a VLM cell feeds precomputed
patch embeddings (``prefix_emb``), an encoder-decoder cell frame
embeddings (``src_emb``).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..tree import tree_leaves
from . import decode as D
from . import layers as L
from . import transformer as T
from .decode import TensorSpec

Params = dict


def _check_generator(gen: torch.Generator, device: torch.device) -> None:
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, model on {device}: "
                         "draw on the device the tensors live on")


def init_model(gen: torch.Generator, cfg: ModelConfig, tp_pad: int = 1,
               device=None) -> Params:
    device = resolve_device(device)
    _check_generator(gen, device)
    return T.init_model(gen, cfg, tp_pad)


def param_shapes(cfg: ModelConfig, tp_pad: int = 1) -> Params:
    """The param tree as meta tensors: every leaf's shape and dtype, nothing
    allocated or drawn (the dry-run path)."""
    return T.init_model(None, cfg, tp_pad)


def param_count(params: Params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Token count fed to the LM trunk for a cell's seq_len budget."""
    if cfg.family == "vlm":
        return seq_len - cfg.n_prefix_tokens
    if cfg.family == "encdec":
        return seq_len // 2
    return seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """TensorSpec stand-ins for every model input of this cell: the tokens,
    and the VLM's ``prefix_emb`` or the encoder-decoder's ``src_emb`` in
    the params' dtype, splitting the seq_len budget as ``text_len`` does."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        St = text_len(cfg, S)
        batch = {"tokens": TensorSpec((B, St), torch.int32)}
        dt = L._dtype(cfg)
        if cfg.family == "vlm":
            batch["prefix_emb"] = TensorSpec(
                (B, cfg.n_prefix_tokens, cfg.d_model), dt)
        if cfg.family == "encdec":
            batch["src_emb"] = TensorSpec((B, S - St, cfg.d_model), dt)
        return batch
    return {
        "tokens": TensorSpec((B, 1), torch.int32),
        "cache": D.cache_spec(cfg, S, B),
        "pos": TensorSpec((), torch.int32),
    }


def make_inputs(gen: torch.Generator, cfg: ModelConfig, shape: ShapeConfig,
                device=None) -> dict:
    """Concrete random inputs matching input_specs, drawn from ``gen`` in
    the specs' key order (smoke runs)."""
    device = resolve_device(device)
    _check_generator(gen, device)

    def materialize(s):
        if isinstance(s, dict):
            return {k: materialize(v) for k, v in s.items()}
        if s.dtype == torch.int32 and s.shape == ():
            return torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                device=device)
        if not s.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, s.shape, generator=gen,
                                 device=device, dtype=s.dtype)
        x = torch.randn(s.shape, generator=gen, device=device,
                        dtype=torch.float32)
        return x.to(s.dtype) * 0.02

    return materialize(input_specs(cfg, shape))


# re-exports for callers
forward_train = T.forward_train
forward_prefill = D.forward_prefill
forward_decode = D.forward_decode
cache_spec = D.cache_spec
init_cache = D.init_cache
