"""What the benchmark takes from the program (``repro_torch``): its
configuration object, its launch counters, and a look at its param tree.
Nothing else in ``cbench`` imports the program, and the references never
do."""
from __future__ import annotations

import dataclasses

# the reference's spec keys whose ModelConfig fields have other names
RENAMED = {"heads": "n_heads", "kv_heads": "n_kv_heads", "vocab": "vocab_size"}
# set from the configuration file's ``run`` block, never held to the arch
RUN_FIELDS = ("param_dtype", "attn_impl", "grad_compression", "remat",
              "optimizer")
# widths: a cut never changes one (the model would be another model)
WIDTHS = ("d_model", "head_dim", "d_ff", "moe_dense_ff", "experts_per_token",
          "lru_width", "ssm_state", "ssm_headdim", "ssm_expand", "conv_width")


def config_sizes(spec: dict, fields) -> dict:
    """The ModelConfig fields a reference's spec gives: its ``heads``,
    ``kv_heads``, ``vocab`` and ``layers`` (the encoder-decoder's
    ``enc_layers`` + ``dec_layers``) under the port's names, and every key
    that is itself a field (``d_model``, ``n_experts``, ``ssm_state``,
    ...), but for the family and the run settings."""
    sizes = {RENAMED[k]: v for k, v in spec.items() if k in RENAMED}
    sizes.update({k: v for k, v in spec.items()
                  if k in fields and k not in RUN_FIELDS + ("family",)})
    if spec["family"] == "encdec":
        sizes["n_layers"] = spec["enc_layers"] + spec["dec_layers"]
    else:
        sizes["n_layers"] = spec["layers"]
    return sizes


def cut_fields(cfg: dict, reduced, sizes: dict) -> dict:
    """The run's cuts (``run.cut``: ModelConfig field -> the source's key
    it cuts), each checked: a size the spec gives, no width, and its key
    in the configuration's ``reduced``."""
    cut = cfg["run"].get("cut", {})
    for field, key in cut.items():
        if field not in sizes or field in WIDTHS:
            raise ValueError(f"run.cut may not set {field!r}: only sizes "
                             f"the spec gives, and no width")
        if key not in reduced:
            raise ValueError(f"run.cut sets {field!r} from {key!r}, which "
                             f"the configuration's reduced does not list")
    return cut


def model_config(cfg: dict, spec: dict, check_arch: bool = True,
                 reduced=()):
    """The program's ``ModelConfig`` for a configuration file: the sizes
    from the file (``config_sizes``), the run settings from its ``run``
    block.  With ``check_arch`` every size but the run's cuts
    (``cut_fields``) must equal the program's own entry for the
    architecture (the file holds the configuration as it is run)."""
    from repro_torch.configs import get_arch
    run = cfg["run"]
    arch = get_arch(run["program_arch"])
    fields = {f.name for f in dataclasses.fields(arch)}
    sizes = config_sizes(spec, fields)
    cut = cut_fields(cfg, reduced, sizes)
    if arch.family != spec["family"]:
        raise ValueError(f"{arch.name} is {arch.family}, the file says "
                         f"{spec['family']}")
    if check_arch:
        differ = {k: (getattr(arch, k), v) for k, v in sizes.items()
                  if k not in cut and getattr(arch, k) != v}
        if differ:
            raise ValueError(f"{arch.name}: the program's sizes differ from "
                             f"the file's: {differ}")
    mc = dataclasses.replace(arch, **sizes, param_dtype="bfloat16",
                             attn_impl=run["attn_impl"],
                             grad_compression=run["grad_compression"],
                             remat=run["remat"], optimizer=run["optimizer"])
    if mc.padded_vocab() != spec["padded_vocab"]:
        raise ValueError(f"padded vocabulary {mc.padded_vocab()} != "
                         f"{spec['padded_vocab']}")
    return mc


def check_layout(mc, layout) -> None:
    """The benchmark's layout must be the program's param tree: the same
    paths, in the same order, with the same shapes and dtypes."""
    from repro_torch.models import param_shapes
    from repro_torch.tree import tree_items

    from .weights import entry
    got = [(p, tuple(t.shape), t.dtype)
           for p, t in tree_items(param_shapes(mc))]
    want = [(p, tuple(s), dt) for p, s, _, dt in map(entry, layout)]
    if got != want:
        raise ValueError(f"layout differs from the program's tree: "
                         f"{sorted(set(got) ^ set(want), key=str)[:6]}")


def _decode_attention():
    """The program's decode-attention module, or None where it has none."""
    try:
        from repro_torch.kernels import decode_attention
    except ImportError:
        return None
    return decode_attention


def zero_counters() -> None:
    from repro_torch.kernels import flash_attention as fa
    fa.LAUNCHES = 0
    fa.BWD_DQ_LAUNCHES = 0
    fa.BWD_DKV_LAUNCHES = 0
    da = _decode_attention()
    if da is not None and hasattr(da, "DECODE_ATTN_LAUNCHES"):
        da.DECODE_ATTN_LAUNCHES = 0


def counters() -> dict:
    """The program's flash counters: forward calls and backward calls (one
    dq pass each); and its decode-attention calls (None in a program
    without that counter)."""
    from repro_torch.kernels import flash_attention as fa
    da = _decode_attention()
    return {"flash_fwd_calls": fa.LAUNCHES,
            "flash_bwd_calls": fa.BWD_DQ_LAUNCHES,
            "decode_attn_calls": getattr(da, "DECODE_ATTN_LAUNCHES", None)}
