"""End-to-end training driver of the port.

Counterpart of the JAX package's launch/train.py, line for line: config ->
model -> object-store data pipeline -> train step -> async transactional
checkpointing -> failure detection/restart, with the same CLI flags and the
same result dict.  It runs on the CUDA card, or raises where there is none,
unless ``run`` is given ``device="cpu"`` (the tests do).

``--kill-at-step N`` simulates a mid-run crash (storage engine failure +
worker loss) and demonstrates the recovery path: detector fires -> pool
rebuild -> restore_latest -> elastic replan -> training resumes.  The
checkpoints' leaf checksums are computed on the card by the checksum
kernel, and the restored leaves land on the card, where the kernel verifies
them again.

Two departures from the JAX driver, both about failure handling: the
recovery path catches the injected failure and storage errors only (a CUDA
error is a RuntimeError too, and restoring a checkpoint would not cure it),
and it waits for in-flight saves to settle before the pool rebuilds, so the
rebuild never races a save that is still writing replicas.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..ckpt import Checkpointer, CheckpointManager
from ..configs import get_arch, smoke_variant
from ..core import Pool, Topology
from ..core.interfaces import DFS
from ..data import ObjectStoreDataset, Prefetcher, synthetic_corpus, \
    write_corpus
from ..device import resolve_device
from ..ft import FailureDetector, replan_data_parallel
from ..models import init_model
from ..train import make_train_step, opt_init


class InjectedFailure(RuntimeError):
    """The simulated node failure of ``--kill-at-step``."""


def build_world(args):
    pool = Pool(Topology(n_server_nodes=args.servers,
                         engines_per_node=2))
    cont = pool.create_container("train", oclass=args.oclass)
    dfs = DFS(cont)
    corpus = synthetic_corpus(args.corpus_tokens, args.vocab)
    write_corpus(dfs, corpus, shard_tokens=args.shard_tokens,
                 interface=args.interface, oclass=args.oclass)
    ds = ObjectStoreDataset(dfs, interface=args.interface)
    # checkpoints use a *protected* object class (paper's RP_*/EC_* classes):
    # losing an engine must never lose training state.
    ckpt = Checkpointer(dfs, interface=args.interface,
                        oclass=args.ckpt_oclass,
                        layout=args.ckpt_layout, n_writers=args.servers)
    mgr = CheckpointManager(ckpt, save_every=args.ckpt_every, keep_n=2)
    return pool, dfs, ds, mgr


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run(args, cfg=None, device=None) -> dict:
    """``cfg``, when given, takes the place of ``args.arch`` and
    ``args.smoke`` (a caller's own cut of a config: depth, optimizer,
    attention kernel); ``--vocab`` and ``--grad-compression`` apply to it
    as to the named arch."""
    device = resolve_device(device)
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.smoke:
            cfg = smoke_variant(cfg)
    cfg = dataclasses.replace(cfg, vocab_size=args.vocab,
                              grad_compression=args.grad_compression)

    pool, dfs, ds, mgr = build_world(args)
    det = FailureDetector(pool, n_workers=args.workers)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_model(gen, cfg, device=device)
    opt_state = opt_init(cfg.optimizer, params)
    step_fn = make_train_step(cfg, device=device)

    pf = Prefetcher(ds, depth=4)
    batches = pf.batches(args.batch, args.seq, seed=args.seed)

    losses = []
    step = 0
    restarts = 0
    t0 = time.time()
    while step < args.steps:
        try:
            if args.kill_at_step and step == args.kill_at_step and \
                    restarts == 0:
                # simulate: one storage engine dies AND a worker is lost
                pool.fail_engine(sorted(pool.engines)[0])
                det.fail_worker(args.workers - 1, step)
                raise InjectedFailure("injected node failure")

            batch = _on(next(batches), device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            mgr.maybe_save(step, {"params": params, "opt": opt_state},
                           extra_meta={"step": step}, async_=True)
            step += 1
        except StopIteration:
            break
        except (InjectedFailure, IOError) as e:  # incl. EngineFailed/DataLoss
            # ---- recovery path ----
            restarts += 1
            events = det.poll(step)
            try:
                mgr.drain()
            except Exception:
                pass   # a save the failure killed never committed
            pool.rebuild()
            dp, per_replica = replan_data_parallel(
                args.batch, det.n_alive_workers or 1)
            restored_step, tree = mgr.restore_latest(
                {"params": params, "opt": opt_state}, pool=pool)
            # the restored tensors (on the template's device) replace the
            # live ones; nothing aliases the old params or state
            params, opt_state = tree["params"], tree["opt"]
            del tree
            step = restored_step + 1
            pf = Prefetcher(ds, depth=4)
            batches = pf.batches(args.batch, args.seq, seed=args.seed + step)
            print(f"[recovery] {e}: events="
                  f"{[(ev.kind, ev.ident) for ev in events]}"
                  f" restored step {restored_step}, dp={dp}, "
                  f"per_replica={per_replica}")
    mgr.drain()
    out = {
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "steps": step, "restarts": restarts,
        "stragglers_skipped": pf.skipped,
        "wall_s": time.time() - t0,
        "sim_io_s": pool.sim.clock.now,
    }
    print({k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in out.items()})
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--interface", default="dfs")
    ap.add_argument("--oclass", default="S2")
    ap.add_argument("--ckpt-oclass", default="RP_2GX")
    ap.add_argument("--ckpt-layout", default="sharded",
                    choices=["sharded", "shared"])
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--kill-at-step", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--corpus-tokens", type=int, default=300_000)
    ap.add_argument("--shard-tokens", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    run(ap.parse_args())


if __name__ == "__main__":
    main()
