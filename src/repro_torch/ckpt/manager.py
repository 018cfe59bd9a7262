"""Checkpoint lifecycle: rolling saves, latest-restore, failure recovery.

The manager is the piece the 1000-node story leans on:
  * saves every `save_every` steps, asynchronously, keeping `keep_n`;
  * on restore it walks back from the newest manifest until one passes
    checksum verification (a half-dead engine can't brick training);
  * if the pool lost engines, it triggers rebuild() before reading;
  * elastic: `restore(..., template)` reads whatever shard ranges the new
    topology needs (see Checkpointer.restore_slice).
"""
from __future__ import annotations

from ..core import DataLossError, EngineFailedError
from .checkpointer import Checkpointer, CheckpointError


class CheckpointManager:
    def __init__(self, ckpt: Checkpointer, save_every: int = 100,
                 keep_n: int = 3,
                 demote_old: bool | None = None) -> None:
        self.ckpt = ckpt
        self.save_every = save_every
        self.keep_n = keep_n
        # keep_n demotion: on a tiered mount, GC *demotes* expired steps
        # to the cold tier (still restorable — an elastic restart reaching
        # past the hot window promotes them back) instead of deleting.
        # None = autodetect from the mount; asking for it without a cold
        # tier is an error, not a silent fallback to delete.
        tiered = getattr(ckpt.iface, "tier_aware", False)
        if demote_old and not tiered:
            raise CheckpointError(
                "demote_old requires a tiered:// checkpoint mount: "
                f"{type(ckpt.iface).__name__} has no cold tier")
        self.demote_old = tiered if demote_old is None else bool(demote_old)
        self.saved_steps: list[int] = []
        self.demoted_steps: list[int] = []
        self._pending: list = []

    # ------------- save path -------------
    def maybe_save(self, step: int, tree, extra_meta=None,
                   async_: bool = True) -> bool:
        if step % self.save_every:
            return False
        if async_:
            ev = self.ckpt.async_save(step, tree, extra_meta)
            self._pending.append((step, ev))
        else:
            self.ckpt.save(step, tree, extra_meta)
        self.saved_steps.append(step)
        self._gc()
        return True

    def _gc(self) -> None:
        while len(self.saved_steps) > self.keep_n:
            old = self.saved_steps.pop(0)
            try:
                if self.demote_old:
                    # keep_n bounds the HOT tier: expired steps spill to
                    # cold capacity, still restorable for elastic restarts
                    # reaching past the hot window
                    self.ckpt.drain()   # the step's save must be durable
                    self.ckpt.demote_step(old)
                    self.demoted_steps.append(old)
                else:
                    # full reclamation: shard files, manifest KV object and
                    # the step directory entry — keep_n bounds store use
                    self.ckpt.delete_step(old)
            except Exception:
                pass  # gc is best-effort

    def drain(self) -> None:
        self.ckpt.drain()
        self._pending.clear()

    # ------------- restore path -------------
    def restore_latest(self, template, pool=None):
        """-> (step, tree) from the newest restorable checkpoint."""
        try:
            self.drain()
        except Exception:
            # an async save racing the failure may itself have died — that
            # epoch never committed, so it simply doesn't exist.
            self._pending.clear()
        candidates = sorted(set(self.saved_steps) | set(self.demoted_steps),
                            reverse=True) or self._discover_steps()
        last_err: Exception | None = None
        for step in candidates:
            try:
                return step, self.ckpt.restore(step, template)
            except (CheckpointError, EngineFailedError, DataLossError,
                    KeyError) as e:
                last_err = e
                if pool is not None:
                    # degraded read failed: restore redundancy, retry once
                    pool.rebuild()
                    try:
                        return step, self.ckpt.restore(step, template)
                    except Exception as e2:  # walk back to older step
                        last_err = e2
        raise CheckpointError(
            f"no restorable checkpoint found: {last_err}")

    def _discover_steps(self) -> list[int]:
        return self.ckpt.list_steps()
