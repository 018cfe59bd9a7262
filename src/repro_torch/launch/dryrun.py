"""Dry-run of every (arch x shape) cell: what one step costs, before any run.

Counterpart of the JAX package's launch/dryrun.py.

    python -m repro_torch.launch.dryrun --list
    python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k \\
        --set attn_impl=flash_pallas
    python -m repro_torch.launch.dryrun --all --set attn_impl=flash_pallas

The reference fakes 512 host devices, compiles each cell's step for its TPU
mesh and reads FLOPs, HBM bytes and collectives from the HLO.  The port has
no compiler and no partitioner, so a cell is counted on the host, on the
meta device, at full width and depth, for one NVIDIA H100 (mesh ``1x1``):
the step runs as it would on the card, through the same Python, with every
tensor a meta tensor, inside ``op_cost.OpCost``.  No arithmetic runs and
no memory is taken; no card is needed.  A record holds

  * the step's FLOPs, by ``torch.utils.flop_counter``'s registry, the
    kernels' custom ops by their own formulas (one kernel, one unit);
  * the bytes its eager ops move (each reads its operands and writes its
    result once; views are free; nothing fuses);
  * argument, output and temporary bytes (``temp_bytes``: the most bytes of
    storages the step creates alive at once, its outputs included), and
    whether argument + temporary bytes fit the card;
  * a roofline at the H100's published peaks;
  * the bytes each device would hold of the params, optimizer state,
    batch and cache under the reference's sharding rules on its 16x16 and
    2x16x16 meshes, read as grids of H100s (``mesh.py``).

``--mesh 16x16`` or ``2x16x16`` writes that state alone: there is no
partitioner, so a multi-device mesh's step FLOPs, bytes and collectives are
``null``, not 0.  ``--set attn_impl=flash_pallas`` counts the attention
kernels through their custom ops in seconds (the reference lowers the
math-identical ``flash_cvjp`` instead and corrects its bytes); the default
``flash`` counts the blockwise twin op by op, which at 32k positions takes
minutes a cell.  Records go to ``artifacts/dryrun_torch/`` or ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import time

import torch

from ..configs import (ARCHS, SHAPES, STUDY_ARCHS, ShapeConfig, get_arch,
                       shape_applicable)
from ..models import input_specs, param_count, param_shapes, text_len
from ..models import layers as L
from ..serve import make_decode_step, make_prefill_step
from ..train import make_train_step, opt_state_shapes
from ..tree import tree_leaves
from .mesh import MESHES, ShardingRules, axis_size, per_device_bytes
from .op_cost import OpCost

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")

# NVIDIA H100 SXM5 80GB (H100 80GB HBM3), the published datasheet figures
# at its 700 W limit: dense bf16 tensor-core FLOP/s, HBM3 bytes/s, memory.
PEAKS_OF = "NVIDIA H100 80GB HBM3, published, 700 W"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9

# the attention kernels' custom ops, as OpCost names them
KERNEL_BUCKET = r":repro_torch\.flash_"


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode counts one
    token per sequence; prefill counts forward only (2 N D).  The
    reference's formula on ``cfg.active_params()``, which leaves out every
    family's untied head (see ``model_flops_tree``)."""
    return _flops_per_param(shape) * cfg.active_params()


def model_flops_tree(cfg, shape, params) -> float:
    """``model_flops`` with N counted from the param tree (a MoE layer's
    experts: the k routed of E)."""
    n = param_count(params)
    if cfg.family == "moe":
        n -= cfg.n_layers * (cfg.n_experts - cfg.experts_per_token) \
            * 3 * cfg.d_model * cfg.d_ff
    return _flops_per_param(shape) * n


def _flops_per_param(shape) -> float:
    if shape.kind == "train":
        return 6.0 * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * shape.global_batch * shape.seq_len
    return 2.0 * shape.global_batch  # decode: one token per sequence


def _typed(cur, value: str):
    if isinstance(cur, bool):
        return value.lower() in ("1", "true", "yes")
    return type(cur)(value) if cur is not None else value


def _meta(spec):
    if isinstance(spec, dict):
        return {k: _meta(v) for k, v in spec.items()}
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


@dataclasses.dataclass
class Cell:
    """One (arch x shape) cell built on the meta device: its step and the
    step's arguments, and the trees the sharding rules read."""
    cfg: object
    shape: ShapeConfig
    step: object
    args: tuple
    params: dict
    opt_state: dict | None
    batch: dict
    cache: dict | None


def build_cell(arch, shape, mesh, *, fsdp: bool = True, remat=None,
               overrides: dict | None = None) -> tuple[Cell, ShardingRules]:
    """``arch`` is a ``ModelConfig`` or a name in ``ARCHS``, ``shape`` a
    ``ShapeConfig`` or a name in ``SHAPES``; ``overrides`` are
    ``ModelConfig`` fields (strings are typed after the field).  Params,
    optimizer state and inputs are meta tensors; a decode cell's ``pos``
    is the Python int seq_len - 1."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if overrides:
        cfg = dataclasses.replace(cfg, **{
            k: _typed(getattr(cfg, k), v) if isinstance(v, str) else v
            for k, v in overrides.items()})
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rules = ShardingRules(cfg, mesh, fsdp=fsdp)
    tp = mesh.shape.get("model", 1)
    params = param_shapes(cfg, tp_pad=tp)
    inputs = _meta(input_specs(cfg, shape))
    opt_state = cache = None
    if shape.kind == "decode":
        cache = inputs["cache"]
        batch = {"tokens": inputs["tokens"]}
        step = make_decode_step(cfg, device="meta")
        args = (params, cache, batch["tokens"], shape.seq_len - 1)
    elif shape.kind == "prefill":
        batch = inputs
        step = make_prefill_step(cfg, device="meta")
        args = (params, batch)
    else:
        batch = inputs
        opt_state = opt_state_shapes(cfg.optimizer, params)
        step = make_train_step(cfg, n_groups=axis_size(mesh, "pod", "data"),
                               device="meta")
        args = (params, opt_state, batch)
    return Cell(cfg, shape, step, args, params, opt_state, batch,
                cache), rules


def state_bytes(cell: Cell, rules: ShardingRules) -> dict:
    """The bytes one device of ``rules.mesh`` holds of the cell's params,
    optimizer state, batch and cache."""
    mesh = rules.mesh
    pspecs = rules.param_specs(cell.params)
    out = {"params": per_device_bytes(cell.params, pspecs, mesh),
           "opt_state": 0, "batch": per_device_bytes(
               cell.batch, rules.batch_specs(cell.batch), mesh),
           "cache": 0}
    if cell.opt_state is not None:
        out["opt_state"] = per_device_bytes(
            cell.opt_state, rules.opt_specs(cell.opt_state, pspecs), mesh)
    if cell.cache is not None:
        out["cache"] = per_device_bytes(
            cell.cache, rules.cache_specs(cell.cache), mesh)
    out["total"] = sum(out.values())
    return out


def attention_kernel_ideal_bytes(cfg, shape) -> dict | None:
    """The bytes the attention kernels read and write at their boundary in
    one step on one card: ``flash_fwd`` reads q, k, v and writes out and
    fp32 lse; the backward pair reads q, k, v, dO, lse and delta and writes
    dq, dk, dv.  The reference's formula (``dryrun.py``) with three
    departures: D is the head dim the port's kernels take as it is (the
    TPU kernel pads it to a multiple of 128); the backward reads delta
    (lse-sized), not O, since the port computes delta outside the kernel;
    and each attention layer has its own lengths (the encoder-decoder's
    encoder Se, decoder Sd and cross-attention Sd over Se; the VLM's text
    and prefix).  Train steps run the forward twice under remat.  The
    dry-run's ``OpCost`` counts the same bytes at the custom ops'
    boundary (``KERNEL_BUCKET``)."""
    if shape.kind not in ("train", "prefill"):
        return None
    B = shape.global_batch
    D = cfg.head_dim
    bdt = 2 if cfg.param_dtype == "bfloat16" else 4
    Hq, kv = cfg.n_heads, cfg.n_kv_heads
    St = text_len(cfg, shape.seq_len)

    def layer(Sq, Sk):
        q_b = B * Sq * Hq * D * bdt
        kv_b = B * Sk * kv * D * bdt
        lse_b = B * Sq * Hq * 4
        fwd = 2 * q_b + 2 * kv_b + lse_b           # read q,k,v; write o,lse
        bwd = (2 * q_b + 2 * kv_b + 2 * lse_b      # read q,do,k,v,lse,delta
               + q_b + 2 * kv_b)                   # write dq,dk,dv
        return fwd, bwd

    if cfg.family == "ssm":
        return {"ideal_bytes": 0, "attn_layers": 0}
    if cfg.family == "encdec":
        Se = shape.seq_len - St
        layers = ([layer(Se, Se)] * cfg.enc_layers
                  + [layer(St, St), layer(St, Se)] * cfg.dec_layers)
    elif cfg.family == "hybrid":
        layers = [layer(St, St)] * (cfg.n_layers // cfg.attn_every)
    else:
        S = St + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
        layers = [layer(S, S)] * cfg.n_layers
    fwd_passes, bwd_passes = ((2 if cfg.remat else 1, 1)
                              if shape.kind == "train" else (1, 0))
    return {"ideal_bytes": sum(fwd_passes * f + bwd_passes * b
                               for f, b in layers),
            "ideal_fwd_bytes": layers[0][0], "ideal_bwd_bytes": layers[0][1],
            "attn_layers": len(layers)}


def count_step(cell: Cell) -> tuple[OpCost, int, float]:
    """Run the cell's step once inside ``OpCost`` -> (the counter, the
    bytes of the storages it created that its outputs hold, host seconds
    the count took).  ``layers.set_norm_bf16`` follows the config for the
    count and is restored after it."""
    norm_bf16 = L._NORM_BF16
    L.set_norm_bf16(cell.cfg.norm_bf16)
    t0 = time.perf_counter()
    try:
        with OpCost(bucket_re=KERNEL_BUCKET) as cost:
            out = cell.step(*cell.args)
            gc.collect()
            out_bytes = cost.live_bytes
        del out
    finally:
        L.set_norm_bf16(norm_bf16)
    return cost, out_bytes, time.perf_counter() - t0


def tree_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               if tree is not None for t in tree_leaves(tree))


def run_cell(arch, shape, mesh_name: str = "1x1", *, fsdp=True,
             tag="baseline", overrides=None, verbose=True) -> dict:
    """The record of one cell (``arch``, ``shape`` and the keywords as
    ``build_cell`` takes them) on the mesh ``mesh_name``: on ``1x1`` the
    step counted on the meta device, on a multi-device mesh its per-card
    state only; the state on 16x16 and 2x16x16 in either."""
    mesh = MESHES[mesh_name]
    cell, rules = build_cell(arch, shape, mesh, fsdp=fsdp,
                             overrides=overrides)
    cfg, shape = cell.cfg, cell.shape
    mf = model_flops(cfg, shape)
    result = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": mesh_name, "n_devices": mesh.size, "tag": tag,
        "attn_impl": cfg.attn_impl, "counted_on": None,
        "peaks_of": PEAKS_OF, "count_wall_s": None,
        "per_device": {"flops": None, "bytes": None,
                       "collective_bytes": None, "n_ops": None},
        "memory": None,
        "model_flops_global": mf,
        "model_flops_tree": model_flops_tree(cfg, shape, cell.params),
        "attention_kernel_bytes": None,
        "state_per_device": {},
        "roofline": None,
    }
    for name in ("16x16", "2x16x16"):
        if name == mesh_name:
            result["state_per_device"][name] = state_bytes(cell, rules)
        else:
            other, other_rules = build_cell(
                arch, shape, MESHES[name], fsdp=fsdp, overrides=overrides)
            result["state_per_device"][name] = state_bytes(other,
                                                           other_rules)
    if mesh.size > 1:   # no partitioner: the step is not counted
        if verbose:
            print(f"[{cfg.name} x {shape.name} x {mesh_name}] state per card "
                  f"{result['state_per_device'][mesh_name]['total']:,} B")
        return result

    args_b = tree_bytes(cell.params, cell.opt_state, cell.batch, cell.cache)
    cost, out_bytes, wall = count_step(cell)
    result["counted_on"] = "meta"
    result["count_wall_s"] = wall
    result["per_device"] = {"flops": cost.flops, "bytes": cost.bytes,
                            "collective_bytes": 0, "n_ops": cost.n_ops}
    result["memory"] = {
        "argument_bytes": args_b, "output_bytes": out_bytes,
        "temp_bytes": cost.peak_bytes,
        "peak_bytes": args_b + cost.peak_bytes,
        "fits": args_b + cost.peak_bytes <= HBM_BYTES,
        "capacity_bytes": HBM_BYTES}
    ideal = attention_kernel_ideal_bytes(cfg, shape)
    if cfg.attn_impl == "flash_pallas" and ideal is not None:
        result["attention_kernel_bytes"] = {
            **ideal, "counted_bytes": cost.bucket_bytes,
            "counted_flops": cost.bucket_flops}
    terms = {"compute_s": cost.flops / PEAK_FLOPS,
             "memory_s": cost.bytes / HBM_BW, "collective_s": 0.0}
    terms["dominant"] = max(("compute_s", "memory_s"), key=terms.get)
    terms["model_flops_ratio"] = mf / cost.flops if cost.flops else 0.0
    result["roofline"] = terms
    if verbose:
        print(json.dumps(terms, indent=2))
        print(f"[{cfg.name} x {shape.name} x {mesh_name}] counted on meta in "
              f"{wall:.1f}s, {cost.n_ops} ops, dominant={terms['dominant']}")
        print("memory:", result["memory"])
    return result


def save_result(res: dict, out_dir=None) -> pathlib.Path:
    out_dir = pathlib.Path(out_dir) if out_dir else ARTIFACTS
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / _record_name(res["arch"], res["shape"], res["mesh"],
                                  res["tag"])
    path.write_text(json.dumps(res, indent=2))
    return path


def _record_name(arch, shape, mesh, tag) -> str:
    return f"{arch}__{shape}__{mesh}__{tag}.json"


def all_cells():
    """The (arch, shape) cells of the study's ten architectures."""
    out = []
    for arch in STUDY_ARCHS:
        cfg = ARCHS[arch]
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            if ok:
                out.append((arch, sname))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="1x1", choices=list(MESHES))
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {ARTIFACTS})")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="ModelConfig override, e.g. attn_impl=flash_pallas")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.set)

    if args.list:
        for a, s in all_cells():
            print(f"{a:28s} {s}")
        return

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    out_dir = pathlib.Path(args.out) if args.out else ARTIFACTS
    for arch, shape in cells:
        out = out_dir / _record_name(arch, shape, args.mesh, args.tag)
        if args.skip_existing and out.exists():
            print(f"skip {arch} x {shape} ({out.name} exists)")
            continue
        try:
            res = run_cell(arch, shape, args.mesh, fsdp=not args.no_fsdp,
                           tag=args.tag, overrides=overrides)
            print("saved", save_result(res, out_dir))
        except Exception as e:  # noqa: BLE001 — sweep must continue
            print(f"FAILED {arch} x {shape}: {type(e).__name__}: {e}")
            if not args.all:
                raise


if __name__ == "__main__":
    main()
