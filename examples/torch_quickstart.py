"""Quickstart on the PyTorch port: train a small LM end-to-end on the
DAOS-model store.

The port's counterpart of examples/quickstart.py, with the same sizes and
checks.  Training data is read from object-store shards (prefetched,
straggler-tolerant), checkpoints are saved asynchronously under epoch
transactions with a replicated object class (on the card, every leaf is
checksummed there by the checksum kernel), and the interface is a config
knob.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.ckpt import Checkpointer, CheckpointManager
from repro_torch.ckpt import serializer as S
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core import Pool, Topology
from repro_torch.core.interfaces import DFS
from repro_torch.data import ObjectStoreDataset, Prefetcher, \
    synthetic_corpus, write_corpus
from repro_torch.device import resolve_device
from repro_torch.models import init_model, param_count
from repro_torch.train import make_train_step, opt_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    device = resolve_device(ap.parse_args(argv).device)

    # ---- storage cluster (8 servers x 2 engines, paper's testbed) ----
    pool = Pool(Topology())
    cont = pool.create_container("quickstart", oclass="S2")
    dfs = DFS(cont)

    # ---- corpus -> object store ----
    corpus = synthetic_corpus(400_000, vocab=256, seed=0)
    n_shards = write_corpus(dfs, corpus, shard_tokens=32768,
                            interface="dfs", oclass="S2")
    print(f"corpus: {corpus.size:,} tokens in {n_shards} S2 objects")

    # ---- model (reduced deepseek-7b family) ----
    cfg = dataclasses.replace(smoke_variant(get_arch("deepseek-7b")),
                              vocab_size=256)
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    opt = opt_init(cfg.optimizer, params)
    step = make_train_step(cfg, device=device)
    print(f"model: {param_count(params):,} params ({cfg.name} smoke)")

    # ---- checkpointing through the paper's interfaces ----
    ck = Checkpointer(dfs, interface="dfs", oclass="RP_2GX",
                      layout="sharded", n_writers=8)
    mgr = CheckpointManager(ck, save_every=20, keep_n=2)

    ds = ObjectStoreDataset(dfs)
    pf = Prefetcher(ds, depth=4)
    losses = []
    for i, batch in enumerate(pf.batches(batch=8, seq=64)):
        if i >= 60:
            break
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        mgr.maybe_save(i, {"params": params, "opt": opt})
        if i % 10 == 0:
            print(f"step {i:3d}  loss {losses[-1]:.4f}")
    mgr.drain()

    assert losses[-1] < losses[0] - 0.5, "model failed to learn"
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f}  "
          f"(sim storage time {pool.sim.clock.now * 1e3:.1f} ms)")

    # restore (the checksums are verified on the way) and compare
    stepno, tree = mgr.restore_latest({"params": params, "opt": opt})
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        S.flatten_tree(tree["params"]), S.flatten_tree(params))) \
        if stepno == 59 else True
    print(f"restored checkpoint from step {stepno} (verified checksums"
          f"{'' if same else '; differs from the live params'})")


if __name__ == "__main__":
    main()
