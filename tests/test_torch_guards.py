"""Guards of the PyTorch port: it, its examples and chip_smoke.py import
neither JAX nor the JAX package, its entry points never fall back to the
CPU on their own, and chip_smoke.py refuses to run (and prints no result)
without a card."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCHS

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ["torch_serve_kvcache", "torch_quickstart", "torch_train_restart"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _run(args, cwd, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=cwd, timeout=timeout,
                          capture_output=True, text=True,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    mods = list(_modules())
    for m in ("repro_torch.kernels.flash_attention",
              "repro_torch.kernels.quantize", "repro_torch.train.train_step",
              "repro_torch.models.attention_flash_vjp",
              "repro_torch.kernels.checksum", "repro_torch.kernels.shard_pack",
              "repro_torch.ckpt.serializer", "repro_torch.ckpt.checkpointer",
              "repro_torch.ckpt.manager", "repro_torch.core.engine",
              "repro_torch.data.pipeline", "repro_torch.ft.failures",
              "repro_torch.launch.train", "repro_torch.serve.kvstore",
              "repro_torch.serve.scheduler", "repro_torch.models.ssm",
              "repro_torch.models.rglru", "repro_torch.launch.mesh",
              "repro_torch.launch.op_cost", "repro_torch.launch.dryrun"):
        assert m in mods
    scripts = [ROOT / "chip_smoke.py"] + [ROOT / "examples" / f"{e}.py"
                                          for e in EXAMPLES]
    code = "\n".join([
        "import importlib, importlib.util, sys",
        f"sys.path.insert(0, {str(ROOT / 'src')!r})",
        f"for m in {mods!r}: importlib.import_module(m)",
        f"for i, f in enumerate({[str(p) for p in scripts]!r}):",
        "    spec = importlib.util.spec_from_file_location(f'script{i}', f)",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m.startswith('jaxlib'))",
        "print('BAD', bad)",
        "sys.exit(1 if bad else 0)"])
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("call", ["init_model", "make_inputs", "init_cache",
                                  "make_prefill_step", "make_decode_step",
                                  "make_train_step", "make_eval_step",
                                  "launch.train.run", "KVCacheStore"])
def test_entry_points_refuse_cpu_without_being_asked(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.configs import ARCHS, ShapeConfig, smoke_variant
    from repro_torch import models, serve, train
    cfg = smoke_variant(ARCHS["deepseek-7b"])
    gen = torch.Generator().manual_seed(0)
    calls = {
        "init_model": lambda: models.init_model(gen, cfg),
        "make_inputs": lambda: models.make_inputs(
            gen, cfg, ShapeConfig("t", 8, 1, "prefill")),
        "init_cache": lambda: models.init_cache(cfg, 8, 1),
        "make_prefill_step": lambda: serve.make_prefill_step(cfg),
        "make_decode_step": lambda: serve.make_decode_step(cfg),
        "make_train_step": lambda: train.make_train_step(cfg),
        "make_eval_step": lambda: train.make_eval_step(cfg),
        "launch.train.run": lambda: _run_driver_on_the_default_device(),
        "KVCacheStore": lambda: _kvcache_store_on_the_default_device(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[call]()


def _kvcache_store_on_the_default_device():
    from repro_torch.core import Pool, Topology
    from repro_torch.core.interfaces import DFS
    from repro_torch.serve import KVCacheStore
    pool = Pool(Topology(n_server_nodes=2, engines_per_node=1))
    KVCacheStore(DFS(pool.create_container("c", oclass="S1")))


def _run_driver_on_the_default_device():
    import argparse
    from repro_torch.launch.train import run
    run(argparse.Namespace(
        arch="deepseek-7b", smoke=True, steps=1, batch=1, seq=8, vocab=64,
        interface="dfs", oclass="S2", ckpt_oclass="RP_2GX",
        ckpt_layout="sharded", ckpt_every=1, kill_at_step=0,
        grad_compression=False, servers=2, workers=2, corpus_tokens=1000,
        shard_tokens=512, seed=0))


def test_storage_seam_never_falls_back_to_the_host(monkeypatch):
    """A CUDA leaf's checksum goes to the kernel; if the kernel cannot run
    the call raises instead of computing ``integrity.checksum``."""
    from repro_torch.ckpt import serializer as S
    from repro_torch.kernels import checksum as ck
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    class LooksLikeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    calls = []
    monkeypatch.setattr(S.integrity, "checksum",
                        lambda *a: calls.append(a) or 0)
    before = ck.CHECKSUM_LAUNCHES
    with pytest.raises((RuntimeError, AssertionError), match="nvcc|CUDA"):
        S.checksum_leaf(torch.zeros(4).as_subclass(LooksLikeCuda))
    assert calls == [] and ck.CHECKSUM_LAUNCHES == before


@pytest.mark.parametrize("factory", ["make_prefill_step", "make_train_step",
                                     "make_eval_step"])
def test_step_refuses_tokens_on_another_device(factory):
    from repro_torch import serve, train
    from repro_torch.configs import ARCHS, smoke_variant
    cfg = smoke_variant(ARCHS["deepseek-7b"])
    make = getattr(serve, factory, None) or getattr(train, factory)
    step = make(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="step bound to"):
        if factory == "make_train_step":
            step({}, {}, {"tokens": tokens})
        else:
            step({}, {"tokens": tokens})


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_model_builds_every_arch(arch):
    """Every architecture's smoke model builds, with no family left out:
    the configs name eight families, the architectures use seven of them,
    and the eighth ("audio") takes the dense stack as in the reference
    (held against it in test_torch_families.py)."""
    from typing import get_args

    from repro_torch.configs import smoke_variant
    from repro_torch.configs.base import Family
    from repro_torch.models import init_model
    assert get_args(Family) == ("dense", "encdec", "vlm", "hybrid", "moe",
                                "ssm", "audio", "ssm_moe")
    assert {a.family for a in ARCHS.values()} == set(get_args(Family)) \
        - {"audio"}
    cfg = smoke_variant(ARCHS[arch])
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["embed"]["tok"].shape[1] == cfg.d_model
    if cfg.family == "encdec":
        assert sorted(params) == ["decoder", "embed", "encoder"]


def test_flash_cvjp_runs_and_matches_flash():
    """``attn_impl="flash_cvjp"`` is ported: forward_train through it gives
    the blockwise path's hidden states (fp32, summation order only)."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.models import forward_train, init_model
    cfg = smoke_variant(ARCHS["deepseek-7b"])
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    h = {impl: forward_train(params, dataclasses.replace(cfg, attn_impl=impl),
                             {"tokens": tokens})[0]
         for impl in ("flash", "flash_cvjp")}
    torch.testing.assert_close(h["flash_cvjp"], h["flash"], rtol=1e-4,
                               atol=1e-4)


def test_chip_smoke_fails_without_a_card():
    res = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "FAIL" in res.stderr
    assert "build_s" not in res.stdout     # refused before any build


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
