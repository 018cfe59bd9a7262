"""Serving demo on the PyTorch port: batched prefill+decode, with the model
weights pulled from an object-store checkpoint and the KV cache offloaded
and restored between "sessions" through the serving tier's
``KVCacheStore`` (the paper's fine-grained-I/O use case).

The port's counterpart of examples/serve_kvcache.py, with the same sizes
and checks.  On the card every cache leaf is checksummed there by the
checksum kernel before it is offloaded, and verified there after it is
restored.  Both directions of the session round trip run inside simulator
phases, so the demo reports modeled offload and restore bandwidth, then
shows the hot-session effect: the same session restored through a cached
mount and through the uncached one.

    PYTHONPATH=src python examples/torch_serve_kvcache.py [--device cpu]
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.ckpt import Checkpointer
from repro_torch.ckpt import serializer as S
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core import Pool, Topology, bandwidth
from repro_torch.core.interfaces import DFS
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.serve import (KVCacheStore, make_decode_step,
                               make_prefill_step)


def tree_bytes(t):
    return sum(x.numel() * x.element_size() for _, x in S.flatten_tree(t))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = dataclasses.replace(smoke_variant(get_arch("chatglm3-6b")),
                              vocab_size=256)
    gen = torch.Generator(device=device).manual_seed(0)

    pool = Pool(Topology())
    dfs = DFS(pool.create_container("serve", oclass="S2"))

    # publish weights to the store; the serving fleet restores from there
    trained = init_model(gen, cfg, device=device)
    ck = Checkpointer(dfs, interface="dfs", oclass="RP_2GX", n_writers=8)
    ck.save(0, trained)
    params = ck.restore(0, trained)
    print(f"weights via object store: {tree_bytes(params) / 2**20:.1f} MiB")

    # batched requests: prefill a prompt batch, decode greedily
    B, S = 4, 24
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device, dtype=torch.int32)
    prefill = make_prefill_step(cfg, pad_to=S + 16, device=device)
    decode = make_decode_step(cfg, device=device)
    logits, cache = prefill(params, {"tokens": prompts})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out = [tok]
    for t in range(8):
        tok, lg, cache = decode(params, cache, tok, S + t)
        out.append(tok)
    print("generated tokens:\n", torch.cat(out, dim=1).cpu().numpy())

    # offload the KV cache between sessions through the native array API —
    # an atomic, manifest-published session snapshot
    store = KVCacheStore(dfs, interface="daos-array", base="/kvcache",
                         device=device)
    nbytes = tree_bytes(cache)
    with pool.sim.phase() as wph:
        store.offload("sess0", cache, step=S + 8)
    print(f"kv cache offload: {nbytes / 2**20:.1f} MiB at "
          f"{bandwidth(nbytes, wph.elapsed):.1f} GiB/s (modeled)")

    with pool.sim.phase() as rph:
        cache2 = store.restore("sess0")
    print(f"kv cache restore: {nbytes / 2**20:.1f} MiB at "
          f"{bandwidth(nbytes, rph.elapsed):.1f} GiB/s (modeled)")

    # decoding from the restored cache must continue identically (decode
    # writes each cache in place; the two are separate tensors)
    t1, _, _ = decode(params, cache, tok, S + 8)
    t2, _, _ = decode(params, cache2, tok, S + 8)
    assert torch.equal(t1, t2)
    print("restored KV cache decodes identically — session resumed.")

    # the hot-session effect: a just-offloaded session restored through a
    # cached mount comes from warm page caches, not the fabric.  The
    # smoke model's cache is too small to show it (the per-phase setup
    # constant dominates), so use a production-shaped session: many
    # small leaves, as serve_bench does.
    rng = np.random.default_rng(0)
    hot = {f"layer{i:03d}": torch.from_numpy(
        rng.integers(0, 255, (64 << 10,), np.uint8)).to(device)
        for i in range(64)}
    hot_bytes = tree_bytes(hot)
    print(f"\nhot-session contrast ({len(hot)} x 64 KiB leaves):")
    for mount in ("posix", "posix-cached"):
        st = KVCacheStore(dfs, interface=mount, base=f"/kvhot-{mount}",
                          device=device)
        with pool.sim.phase():
            st.offload("hot", hot)
        with pool.sim.phase() as ph:
            st.restore("hot")
        extra = ""
        if st.iface.cache_mode != "none":
            s = st.iface.cache_stats()
            hits, miss = s.get("read_hits", 0), s.get("read_misses", 0)
            extra = f"  (hit rate {hits / max(1, hits + miss):.2f})"
        print(f"hot restore via {mount:13s}: "
              f"{bandwidth(hot_bytes, ph.elapsed):7.1f} GiB/s{extra}")
        st.evict("hot")

    store.evict("sess0")
    print(f"sessions after evict: {store.sessions()}")


if __name__ == "__main__":
    main()
