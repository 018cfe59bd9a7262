"""Serving of the PyTorch port: the steps, the KV-cache store and the
fleet scheduler."""
from .kvstore import KVCacheStore, KVStoreError
from .scheduler import NodeState, SchedulerError, ServeScheduler
from .serve_step import make_decode_step, make_prefill_step

__all__ = ["KVCacheStore", "KVStoreError", "NodeState", "SchedulerError",
           "ServeScheduler", "make_decode_step", "make_prefill_step"]
