"""The yardstick's arithmetic: the card's peaks, the flash kernels' bounds and
the model FLOPs of a step, computed from shapes alone.

Frozen copies, kept here so that a change to the program cannot move them:
``allowed_pairs`` is ``repro_torch.kernels.flash_attention.allowed_pairs``,
``bound`` is ``chip_smoke._bound``, the flash bounds are the products and
bytes ``chip_smoke.attn_times`` counts, and ``train_model_flops`` is
``chip_smoke.train_model_flops`` for the dense and encoder-decoder families,
with the parameter counts taken from the benchmark's own layout.  A
configuration whose step those two formulas would miscount (a MoE touches
k of its E experts a token; a hybrid attends in only some layers) gives its
own ``prefill_flops`` / ``train_model_flops`` in ``configs/<config>.py``,
and ``model_flops`` takes that.  ``decode_attn_bound`` bounds the port's
decode-attention call (``decode_attn_bytes`` in
``repro_torch/kernels/decode_attention.py`` counts the same bytes).
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def allowed_pairs(S: int, Sk: int, causal: bool, window: int = 0,
                  prefix: int = 0) -> int:
    """The (query, key) pairs a causal / window / prefix mask lets through,
    row by row in closed form."""
    total = 0
    p = min(prefix, Sk)
    for qi in range(S):
        hi = min(qi, Sk - 1) if causal else Sk - 1
        lo = max(qi - window + 1, 0) if window else 0
        n = max(hi - lo + 1, 0)
        if p:
            n += p - max(min(hi, p - 1) - lo + 1, 0)
        total += n
    return total


def bound(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the operations
    over the bf16 peak and the bytes over HBM's rate."""
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def flash_fwd_bound(B: int, H: int, D: int, Sq: int, Sk: int,
                    causal: bool) -> float:
    """One forward: q.k and p.v over the pairs the mask allows; q, k, v and
    out (bf16) and lse (fp32) read or written once."""
    prod = 2.0 * B * H * D * allowed_pairs(Sq, Sk, causal)
    nq, nkv, rows = 2 * B * Sq * H * D, 2 * B * Sk * H * D, 4 * B * H * Sq
    return bound(2 * prod, 2 * nq + 2 * nkv + rows)


def flash_bwd_bound(B: int, H: int, D: int, Sq: int, Sk: int,
                    causal: bool) -> float:
    """One backward pair, each pass bounded on its own: dq does 3 products
    (q.k, dO.v, ds.k), dk/dv 4; each reads q, k, v, dO, lse and delta once
    and writes its own outputs once."""
    prod = 2.0 * B * H * D * allowed_pairs(Sq, Sk, causal)
    nq, nkv, rows = 2 * B * Sq * H * D, 2 * B * Sk * H * D, 4 * B * H * Sq
    reads = 2 * nq + 2 * nkv + 2 * rows
    return bound(3 * prod, reads + nq) + bound(4 * prod, reads + 2 * nkv)


def matmul_params(layout, spec) -> dict:
    """Parameter counts by where they act, from the layout: ``total``, the
    token embedding (a lookup, no product) and, for the encoder-decoder,
    the encoder's and the cross-attention's k/v projections."""
    out = {"total": 0, "tok": 0, "enc": 0, "xkv": 0, "final_norm": 0}
    for path, shape, *_ in layout:
        n = math.prod(shape)
        out["total"] += n
        if path in ("embed/tok", "embed/final_norm"):
            out[path.split("/")[1]] = n
        elif path.startswith("encoder/"):
            out["enc"] += n
        elif path in ("decoder/xattn/wk", "decoder/xattn/wv"):
            out["xkv"] += n
    return out


def train_model_flops(layout, spec, B: int, S: int) -> float:
    """Model FLOPs of one training step (no recompute): 6 per matmul weight
    a position passes through, plus 3 x 4 B H D a (query, key) pair an
    attention layer.  The encoder-decoder's budget of S positions splits
    into Se = S - S // 2 frames and Sd = S // 2 tokens: the encoder's
    weights and the cross-attention's k/v projections see the frames, the
    rest of the decoder and the head the tokens (the final norm's scale
    uncounted, as chip_smoke.py leaves it), over Se^2 bidirectional,
    Sd(Sd+1)/2 causal and Sd Se cross pairs a layer."""
    n = matmul_params(layout, spec)
    per_pair = 4.0 * B * spec["heads"] * spec["head_dim"]
    if spec["family"] == "encdec":
        Sd = S // 2
        Se = S - Sd
        enc = n["enc"] + n["xkv"]
        dec = n["total"] - n["tok"] - n["final_norm"] - n["enc"] - n["xkv"]
        pairs = spec["enc_layers"] * Se * Se + spec["dec_layers"] * (
            Sd * (Sd + 1) / 2 + Sd * Se)
        return 6.0 * B * (enc * Se + dec * Sd) + 3.0 * per_pair * pairs
    active = n["total"] - n["tok"]
    pairs = S * (S + 1) / 2
    return 6.0 * active * B * S + 3.0 * spec["layers"] * per_pair * pairs


def prefill_flops(layout, spec, B: int, S: int) -> float:
    """Model FLOPs of a decoder-only prefill of B prompts of S tokens: 2 per
    matmul weight a token passes through (the head on the last position
    only), plus 4 B H D a causal pair an attention layer."""
    n = matmul_params(layout, spec)
    head = spec["d_model"] * spec["padded_vocab"]
    body = n["total"] - n["tok"] - head
    pairs = S * (S + 1) / 2
    return (2.0 * body * B * S + 2.0 * head * B
            + 4.0 * B * spec["heads"] * spec["head_dim"] * pairs
            * spec["layers"])


def model_flops(refmod, name: str, layout, spec, B: int, S: int) -> float:
    """``name`` (``prefill_flops`` or ``train_model_flops``) of B x S: the
    configuration's own count, ``refmod.<name>(spec, B, S)``, where its
    reference module defines one, else this module's formula."""
    own = getattr(refmod, name, None)
    if own is not None:
        return float(own(spec, B, S))
    return globals()[name](layout, spec, B, S)


def decode_attn_bytes(B: int, Hq: int, Hkv: int, D: int, pos: int,
                      slots: int) -> int:
    """The bf16 bytes one decode-attention call at position ``pos`` must
    move, over a cache of ``slots`` slots: q read and the output written
    (B Hq D each), the new k/v row written (2 B Hkv D) and every valid K/V
    row read once (2 B Hkv D each of min(pos + 1, slots))."""
    row = B * Hkv * D * 2
    return 2 * B * Hq * D * 2 + 2 * row + 2 * row * min(pos + 1, slots)


def decode_attn_bound(B: int, Hq: int, Hkv: int, D: int, pos: int,
                      slots: int) -> float:
    """The least seconds of one decode-attention call: q.k and p.v over
    the valid slots (2 x 2 B Hq D a slot) against its bytes."""
    flops = 4.0 * B * Hq * D * min(pos + 1, slots)
    return bound(flops, decode_attn_bytes(B, Hq, Hkv, D, pos, slots))
