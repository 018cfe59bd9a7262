"""The port's dry-run (``repro_torch.launch.dryrun``): every family's
prefill, decode and train steps counted on the meta device at smoke size,
records written where the caller says (never into the repository), the
model-FLOP formula and the cell list held against the JAX package's
dry-run, the count on meta held against the same step run on the CPU, and
the kernels' wrappers refusing meta tensors that do not come through their
custom ops."""
import dataclasses
import json
import os

import jax
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, smoke_variant
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.attention_math import rope_table
from repro_torch.kernels import quantize as qz
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import init_model, make_inputs
from repro_torch.train import make_train_step, opt_init

FAMILIES = ["deepseek-7b", "qwen3-moe-235b-a22b", "mamba2-370m",
            "recurrentgemma-9b", "seamless-m4t-large-v2", "paligemma-3b"]
SMOKE_SHAPES = {"prefill": ShapeConfig("smoke_prefill", 16, 2, "prefill"),
                "decode": ShapeConfig("smoke_decode", 16, 2, "decode"),
                "train": ShapeConfig("smoke_train", 16, 2, "train")}


@pytest.fixture(scope="module")
def reference_dryrun():
    """The JAX package's dry-run module.  Importing it sets XLA_FLAGS to
    fake 512 host devices for a JAX that is not yet running; JAX here is
    started first and the variable put back, so nothing else in this
    process sees either."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _smoke(arch):
    return dataclasses.replace(smoke_variant(ARCHS[arch]),
                               attn_impl="flash_pallas")


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_on_meta_writes_where_asked(arch, kind, tmp_path):
    cfg = _smoke(arch)
    res = dryrun.run_cell(cfg, SMOKE_SHAPES[kind], tag="pytest",
                          verbose=False)
    path = dryrun.save_result(res, tmp_path)
    assert path.parent == tmp_path
    assert not (dryrun.ARTIFACTS / path.name).exists()
    rec = json.loads(path.read_text())
    assert (rec["arch"], rec["kind"], rec["mesh"], rec["n_devices"]) \
        == (cfg.name, kind, "1x1", 1)
    assert rec["counted_on"] == "meta"
    assert rec["peaks_of"] == dryrun.PEAKS_OF
    dev = rec["per_device"]
    assert dev["flops"] > 0 and dev["bytes"] > 0 and dev["n_ops"] > 0
    assert dev["collective_bytes"] == 0
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["fits"] is True
    assert 0 < mem["output_bytes"] <= mem["temp_bytes"]
    roof = rec["roofline"]
    assert roof["dominant"] in ("compute_s", "memory_s")
    assert roof["model_flops_ratio"] == rec["model_flops_global"] \
        / dev["flops"]
    for mesh in ("16x16", "2x16x16"):
        st = rec["state_per_device"][mesh]
        assert st["total"] == st["params"] + st["opt_state"] + st["batch"] \
            + st["cache"] > 0
        assert (st["opt_state"] > 0) == (kind == "train")
        assert (st["cache"] > 0) == (kind == "decode")
    kernels = rec["attention_kernel_bytes"]
    if kind == "decode":
        assert kernels is None
    else:
        # the kernels' boundary bytes, counted at the custom ops, are the
        # formula's
        assert kernels["counted_bytes"] == kernels["ideal_bytes"]
        assert (kernels["ideal_bytes"] > 0) == (arch != "mamba2-370m")


def test_multi_device_mesh_reports_state_only(tmp_path, capsys):
    dryrun.main(["--arch", "deepseek-7b", "--shape", "train_4k", "--mesh",
                 "2x16x16", "--tag", "pytest", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "deepseek-7b__train_4k__2x16x16__pytest"
                      ".json").read_text())
    assert rec["n_devices"] == 512 and rec["counted_on"] is None
    assert set(rec["per_device"].values()) == {None}
    assert rec["memory"] is None and rec["roofline"] is None
    # FSDP over all 512 cards: the bf16 params and fp32 moments split
    st = rec["state_per_device"]["2x16x16"]
    assert 0 < st["params"] < 13.9e9 / 500
    assert "saved" in capsys.readouterr().out


def test_main_counts_a_full_size_cell_and_skips_existing(tmp_path, capsys):
    args = ["--arch", "mamba2-370m", "--shape", "long_500k", "--tag",
            "pytest", "--out", str(tmp_path)]
    dryrun.main(args)
    rec = json.loads((tmp_path / "mamba2-370m__long_500k__1x1__pytest.json")
                     .read_text())
    assert rec["counted_on"] == "meta" and rec["memory"]["fits"] is True
    assert rec["per_device"]["flops"] > 0
    dryrun.main(args + ["--skip-existing"])
    assert "skip mamba2-370m x long_500k" in capsys.readouterr().out


def test_list_prints_the_references_cells(reference_dryrun, capsys):
    dryrun.main(["--list"])
    got = capsys.readouterr().out.splitlines()
    want = [f"{a:28s} {s}" for a, s in reference_dryrun.all_cells()]
    assert got == want and len(got) == 33
    assert dryrun.all_cells() == reference_dryrun.all_cells()


def test_model_flops_equal_the_references(reference_dryrun):
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import SHAPES as JAX_SHAPES
    for arch, shape in dryrun.all_cells():
        assert dryrun.model_flops(ARCHS[arch], SHAPES[shape]) \
            == reference_dryrun.model_flops(JAX_ARCHS[arch],
                                            JAX_SHAPES[shape])


def test_set_overrides_are_typed():
    cell, _ = dryrun.build_cell(
        "deepseek-7b", "decode_32k", dryrun.MESHES["1x1"],
        overrides={"n_layers": "2", "remat": "false",
                   "attn_impl": "flash_pallas"})
    assert (cell.cfg.n_layers, cell.cfg.remat, cell.cfg.attn_impl) \
        == (2, False, "flash_pallas")
    assert cell.args[-1] == SHAPES["decode_32k"].seq_len - 1


def test_count_on_meta_equals_the_step_run_on_the_cpu():
    """The blockwise train step (no custom op) counted on the meta device
    and run for real on the CPU: the same FLOPs, ops, bytes and peak live
    bytes.  The rope table exists on both devices before the count, as it
    does after a step's first call: its one copy to a device is not a
    step's."""
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              remat=True)
    shape = SMOKE_SHAPES["train"]
    for dev in ("meta", "cpu"):
        rope_table(torch.device(dev), cfg.head_dim, cfg.rotary_pct,
                   cfg.rope_theta)
    cell, _ = dryrun.build_cell(cfg, shape, dryrun.MESHES["1x1"])
    meta_cost, _, _ = dryrun.count_step(cell)
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg, device="cpu")
    batch = make_inputs(gen, cfg, shape, device="cpu")
    state = opt_init(cfg.optimizer, params)
    step = make_train_step(cfg, device="cpu")
    with OpCost() as cpu_cost:
        step(params, state, batch)
    # (n_ops aside: lifting a host scalar into a tensor is a free op that
    # the two devices take in different numbers)
    assert meta_cost.summary() == {**cpu_cost.summary(),
                                   "n_ops": meta_cost.n_ops}
    assert meta_cost.by_op["aten._to_copy"]["calls"] \
        == cpu_cost.by_op["aten._to_copy"]["calls"]


def test_kernel_wrappers_refuse_meta_tensors():
    """The meta path is the custom ops' fakes; the wrappers themselves never
    take a meta tensor to a twin."""
    q = torch.zeros(1, 2, 1, 8, 16, device="meta")
    k = torch.zeros(1, 2, 8, 16, device="meta")
    lse = torch.zeros(1, 2, 1, 8, device="meta")
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, k)
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, k, q, lse, lse)
    groups = torch.zeros(8, qz.GROUP, device="meta")
    with pytest.raises(ValueError):
        qz.quantize(groups)
    with pytest.raises(ValueError):
        qz.dequantize(groups.to(torch.int8), torch.zeros(8, 1,
                                                         device="meta"))
