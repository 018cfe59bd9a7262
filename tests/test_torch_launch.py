"""The port's end-to-end driver on the CPU: the four training stories of
tests/test_system.py (loss decreases, the injected engine + worker failure
restores and resumes, gradient compression, the shared-file checkpoint
layout) through ``repro_torch.launch.train.run(args, device="cpu")``, with
the same arguments."""
import argparse

import pytest
import torch

from repro_torch.launch import train as driver


def _train_args(**over):
    base = dict(arch="deepseek-7b", smoke=True, steps=18, batch=4, seq=48,
                vocab=128, interface="dfs", oclass="S2",
                ckpt_oclass="RP_2GX", ckpt_layout="sharded", ckpt_every=5,
                kill_at_step=0, grad_compression=False, servers=4, workers=4,
                corpus_tokens=60_000, shard_tokens=8192, seed=0)
    base.update(over)
    return argparse.Namespace(**base)


def test_train_end_to_end_loss_decreases():
    out = driver.run(_train_args(), device="cpu")
    assert out["steps"] == 18 and out["restarts"] == 0
    assert out["final_loss"] < out["first_loss"]
    assert set(out) == {"final_loss", "first_loss", "steps", "restarts",
                        "stragglers_skipped", "wall_s", "sim_io_s"}


def test_train_survives_injected_failure(monkeypatch):
    restores = []
    orig = driver.CheckpointManager.restore_latest

    def spy(self, template, pool=None):
        step, tree = orig(self, template, pool=pool)
        restores.append((step, template, tree))
        return step, tree

    monkeypatch.setattr(driver.CheckpointManager, "restore_latest", spy)
    out = driver.run(_train_args(kill_at_step=9, steps=16), device="cpu")
    assert out["restarts"] == 1
    assert out["steps"] == 16
    assert out["final_loss"] < out["first_loss"]
    # the newest committed save before the failure (steps 0 and 5) is
    # restored, into fresh tensors
    (step, template, tree), = restores
    assert step == 5
    old = {id(t) for t in template["params"].values()}
    assert not old & {id(t) for t in tree["params"].values()}


def test_train_with_grad_compression():
    out = driver.run(_train_args(steps=10, grad_compression=True),
                     device="cpu")
    assert out["final_loss"] < out["first_loss"]


def test_train_shared_file_checkpoint_layout():
    out = driver.run(_train_args(steps=8, ckpt_layout="shared"),
                     device="cpu")
    assert out["final_loss"] < out["first_loss"]


def test_run_takes_a_callers_config(monkeypatch):
    """``cfg`` replaces the named arch; --vocab still applies to it."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke_variant
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              n_layers=1, optimizer="adafactor")
    seen = []
    orig = driver.init_model
    monkeypatch.setattr(driver, "init_model",
                        lambda gen, c, device=None: seen.append(c)
                        or orig(gen, c, device=device))
    out = driver.run(_train_args(steps=3, ckpt_every=2), cfg=cfg,
                     device="cpu")
    assert out["steps"] == 3
    assert seen == [dataclasses.replace(cfg, vocab_size=128)]


def test_run_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.run(_train_args(steps=1))


def test_a_cuda_error_is_not_recovered_by_a_restore(monkeypatch):
    """Only the injected failure and storage errors take the recovery
    path; any other RuntimeError (a kernel launch failure) propagates."""
    def broken_step(cfg, device=None):
        def step(params, state, batch):
            raise RuntimeError("kernel launch failed: cudaError 1")
        return step

    monkeypatch.setattr(driver, "make_train_step", broken_step)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        driver.run(_train_args(steps=2), device="cpu")
