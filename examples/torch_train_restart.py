"""Fault-tolerance demo on the PyTorch port: training survives a
storage-engine + worker loss.

The port's counterpart of examples/train_restart.py, with the same run.  At
step 12 an engine dies and a worker is lost.  The driver detects the
failure, rebuilds redundancy in the pool, restores the newest committed
checkpoint (replicated RP_2GX — the dead engine cannot brick it) onto the
device, replans the data-parallel degree elastically, and resumes to
completion.

    PYTHONPATH=src python examples/torch_train_restart.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    device = ap.parse_args(argv).device
    args = argparse.Namespace(
        arch="deepseek-7b", smoke=True, steps=30, batch=8, seq=64,
        vocab=256, interface="dfs", oclass="S2", ckpt_oclass="RP_2GX",
        ckpt_layout="sharded", ckpt_every=5, kill_at_step=12,
        grad_compression=False, servers=4, workers=4,
        corpus_tokens=200_000, shard_tokens=16384, seed=0)
    out = run(args, device=device)
    assert out["restarts"] == 1, "expected exactly one recovery"
    assert out["final_loss"] < out["first_loss"], "did not keep learning"
    print("\nrecovered from injected node failure and kept training.")


if __name__ == "__main__":
    main()
