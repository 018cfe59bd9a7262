"""What the benchmark takes from the program (``repro_torch``): its
configuration object, its launch counters, and a look at its param tree.
Nothing else in ``cbench`` imports the program, and the references never
do."""
from __future__ import annotations

import dataclasses

SIZE_FIELDS = ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
               "vocab_size")


def model_config(cfg: dict, spec: dict, check_arch: bool = True):
    """The program's ``ModelConfig`` for a configuration file: the sizes
    from the file, the run settings from its ``run`` block.  With
    ``check_arch`` the program's own entry for the architecture must have
    the same sizes (the file holds the configuration as it is run)."""
    from repro_torch.configs import get_arch
    run = cfg["run"]
    arch = get_arch(run["program_arch"])
    sizes = {"d_model": spec["d_model"], "n_heads": spec["heads"],
             "n_kv_heads": spec["kv_heads"], "head_dim": spec["head_dim"],
             "d_ff": spec["d_ff"], "vocab_size": spec["vocab"]}
    if spec["family"] == "encdec":
        sizes.update(enc_layers=spec["enc_layers"],
                     dec_layers=spec["dec_layers"],
                     n_layers=spec["enc_layers"] + spec["dec_layers"])
    else:
        sizes.update(n_layers=spec["layers"])
    if arch.family != spec["family"]:
        raise ValueError(f"{arch.name} is {arch.family}, the file says "
                         f"{spec['family']}")
    if check_arch:
        differ = {k: (getattr(arch, k), v) for k, v in sizes.items()
                  if getattr(arch, k) != v}
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
    paths, in the same order, with the same shapes."""
    from repro_torch.models import param_shapes
    from repro_torch.tree import tree_items
    got = [(p, tuple(t.shape)) for p, t in tree_items(param_shapes(mc))]
    want = [(p, tuple(s)) for p, s, _ in layout]
    if got != want:
        raise ValueError(f"layout differs from the program's tree: "
                         f"{sorted(set(got) ^ set(want))[:6]}")


def zero_counters() -> None:
    from repro_torch.kernels import flash_attention as fa
    fa.LAUNCHES = 0
    fa.BWD_DQ_LAUNCHES = 0
    fa.BWD_DKV_LAUNCHES = 0


def counters() -> dict:
    """The program's flash counters: forward calls and backward calls
    (one dq pass each)."""
    from repro_torch.kernels import flash_attention as fa
    return {"flash_fwd_calls": fa.LAUNCHES,
            "flash_bwd_calls": fa.BWD_DQ_LAUNCHES}
