"""Config system: model architectures and benchmark input shapes.

Every assigned architecture is a ``ModelConfig`` (one module per arch in this
package); every benchmark cell is a (ModelConfig, ShapeConfig) pair.  Configs
are frozen dataclasses — hashable, so the dry-run cache can key on them.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "encdec", "vlm", "hybrid", "moe", "ssm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention options
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    swa_window: int = 0              # sliding-window attention; 0 = full
    mlp: str = "swiglu"              # swiglu | geglu | gelu
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # prefix-LM frontends (vlm/audio): stub supplies this many embeddings
    n_prefix_tokens: int = 0
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_ff: int = 0            # arctic: parallel dense-residual FFN
    capacity_factor: float = 1.25
    # hybrid (recurrentgemma / griffin)
    attn_every: int = 0              # one attention block per N blocks
    lru_width: int = 0
    local_window: int = 0
    conv_width: int = 4
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # numerics / training
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor
    remat: bool = True
    grad_compression: bool = False   # int8 pod-axis gradient compression
    # perf knobs (hillclimb surface; see EXPERIMENTS.md §Perf)
    attn_impl: str = "flash"         # flash | flash_cvjp | flash_pallas
    flash_bq: int = 256
    flash_bk: int = 512
    moe_dispatch: str = "cumsum"     # cumsum | sort (slot-rank algorithm)
    norm_bf16: bool = False          # bf16 norm/rope products (H5)
    moe_expert_cvjp: bool = False    # hand-written expert-FFN VJP (H9)
    # capability flags
    subquadratic: bool = False       # may run long_500k
    has_decoder: bool = True

    # ---------------- derived ----------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_headdim

    def padded_vocab(self, multiple: int = 256) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def padded_heads(self, tp: int) -> int:
        """q heads padded up so TP always divides (zero-weight pad heads)."""
        if self.n_heads % tp == 0:
            return self.n_heads
        return -(-self.n_heads // tp) * tp

    def n_params(self) -> int:
        """Parameter count (excluding frontend stubs)."""
        d, V = self.d_model, self.padded_vocab()
        emb = V * d
        per_layer = 0
        if self.family == "ssm":
            din = self.ssm_expand * d
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D,norm
            H, N, P = self.ssm_heads, self.ssm_state, self.ssm_headdim
            per_layer = d * (2 * din + 2 * N + H) + din * d + 4 * din + 2 * H + din
            return emb + self.n_layers * per_layer + d
        attn = d * self.q_dim * 2 + d * self.kv_dim * 2
        if self.mlp in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family == "moe":
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            if self.moe_dense_ff:
                moe += 3 * d * self.moe_dense_ff
            per_layer = attn + moe + 2 * d
        elif self.family == "hybrid":
            n_attn = self.n_layers // self.attn_every if self.attn_every else 0
            n_rec = self.n_layers - n_attn
            w = self.lru_width or d
            rec = d * w * 2 + w * self.conv_width + 2 * w + w * d + 2 * w
            mlp_all = self.n_layers * (mlp + 2 * d)
            return (emb + n_attn * (attn + d) + n_rec * (rec + d)
                    + mlp_all + d)
        else:
            per_layer = attn + mlp + 2 * d
        n_blocks = self.n_layers
        if self.family == "encdec":
            # decoder adds cross-attention
            cross = d * self.q_dim * 2 + d * self.kv_dim * 2 + d
            return (emb + self.enc_layers * per_layer
                    + self.dec_layers * (per_layer + cross) + d)
        return emb + n_blocks * per_layer + d

    def active_params(self) -> int:
        """Params touched per token (MoE: routed experts only)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        moe_total = self.n_layers * self.n_experts * 3 * d * self.d_ff
        moe_active = self.n_layers * self.experts_per_token * 3 * d * self.d_ff
        return full - moe_total + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the brief's applicability rules."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, ""


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.family != "hybrid" else 3),
        d_model=64,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=16, d_ff=128, vocab_size=256,
        param_dtype="float32", remat=False)
    if cfg.family == "encdec":
        changes.update(enc_layers=2, dec_layers=2)
    if cfg.family == "moe":
        changes.update(n_experts=4, experts_per_token=min(
            cfg.experts_per_token, 2), moe_dense_ff=32 if cfg.moe_dense_ff else 0)
    if cfg.family == "hybrid":
        changes.update(attn_every=3, lru_width=64, local_window=32)
    if cfg.family == "ssm":
        changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
    if cfg.n_prefix_tokens:
        changes.update(n_prefix_tokens=4)
    if cfg.swa_window:
        changes.update(swa_window=32)
    return dataclasses.replace(cfg, **changes)
