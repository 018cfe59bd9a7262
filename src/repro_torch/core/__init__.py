"""repro.core — the paper's contribution: a DAOS-model distributed object
store (pools / containers / objects, object classes S1..SX, RAFT-lite
metadata, epoch transactions, event queues, end-to-end integrity,
replication + erasure coding) with a calibrated performance model standing in
for the Optane/fabric hardware the paper benchmarks."""
from .cache import CacheStats, ClientCache
from .coherence import (BroadcastPolicy, CoherencePolicy, CoherenceStats,
                        TimeoutPolicy, make_policy, object_token)
from .engine import Engine, EngineFailedError, NoSpaceError, NotFoundError
from .events import Event, EventQueue, QueuedOp, SubmissionQueue
from .iopath import CellPlanner, FlowAccumulator, IOD_BATCH, iod_batch
from .integrity import ChecksumError, checksum, verify
from .layout import (ObjectClass, StripeLayout, get_class, jump_hash,
                     oid_for, place_object)
from .multipart import (MP_PART_BYTES, MP_THRESHOLD, multipart_read,
                        multipart_write, multipart_write_at, plan_parts,
                        should_multipart)
from .object import ArrayObject, IOCtx, KVBatch, KVObject
from .pool import Pool
from .container import Container
from .raft import NoQuorumError, NotLeaderError, RaftGroup
from .redundancy import DataLossError
from .simnet import AUTO_QD, HWProfile, IOSim, PROFILES, Topology, bandwidth
from .transactions import Transaction, TxStateError

__all__ = [
    "AUTO_QD", "ArrayObject", "BroadcastPolicy", "CacheStats", "CellPlanner",
    "ChecksumError", "CoherencePolicy", "CoherenceStats",
    "ClientCache", "Container", "DataLossError", "Engine",
    "EngineFailedError", "Event", "EventQueue", "FlowAccumulator",
    "HWProfile", "IOCtx", "IOD_BATCH", "IOSim", "KVBatch", "KVObject",
    "MP_PART_BYTES", "MP_THRESHOLD", "NoQuorumError",
    "NoSpaceError", "NotFoundError", "NotLeaderError", "ObjectClass",
    "PROFILES", "Pool", "QueuedOp", "RaftGroup", "StripeLayout",
    "SubmissionQueue", "TimeoutPolicy",
    "Topology", "Transaction", "TxStateError", "bandwidth", "checksum",
    "get_class", "iod_batch", "jump_hash", "make_policy",
    "multipart_read", "multipart_write", "multipart_write_at",
    "object_token",
    "oid_for", "place_object", "plan_parts", "should_multipart", "verify",
]
