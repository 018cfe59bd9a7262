"""Fabric + media performance model.

The container is CPU-only; it cannot *measure* Optane-class storage bandwidth.
What it can do — the same move the dry-run makes for TPU compute — is move the
real bytes and charge them against a calibrated hardware model.  This module is
that model: a bottleneck-flow solver over the NEXTGenIO-like topology the paper
benchmarks (8 server nodes x 2 DAOS engines, Optane DCPMM media, ~100 Gb/s
fabric).

Semantics: an I/O *phase* (one IOR write pass, one checkpoint save, ...) is a
set of concurrent flows client->engine (or engine->client).  All flows start
together (IOR barrier semantics).  Completion time is

    T = setup + max( max_r  bytes(r) / bw(r),          # every shared resource
                     max_c  serial op chain of client c )

where resources are: engine media (direction-dependent bw + per-op service
time), engine RPC processors, server NICs, client NICs, and optional per-
process stream caps (the DFuse kernel-crossing bottleneck).  This "concurrent
saturation" approximation is monotone, deterministic and captures exactly the
effects the paper measures: placement imbalance (S1/S2 hot spots), wide-stripe
fan-out overhead (SX), interface per-op costs (FUSE, HDF5), and contention
growth with client-node count.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Iterator

import contextlib

#: Sentinel queue depth carried by flows from a ``qd=auto`` mount: the
#: solver picks the window from measured engine congestion instead of a
#: mount constant (see ``PhaseRecorder.solve``).
AUTO_QD = -1


@dataclasses.dataclass
class HWProfile:
    """Hardware constants. Default profile: NEXTGenIO (paper's testbed).

    Engine media = one socket of 6x 256 GiB gen-1 Optane DCPMM, AppDirect
    interleaved: ~40 GB/s read, ~13 GB/s write per engine.  Fabric =
    100 Gb/s OmniPath per node (~12.5 GB/s).
    """
    name: str = "nextgenio-dcpmm"
    engine_read_bw: float = 40e9        # B/s per engine, media read
    engine_write_bw: float = 13e9       # B/s per engine, media write
    engine_op_time: float = 8e-6        # s per RPC of engine service CPU
    engine_rpc_threads: int = 16        # concurrent service streams per engine
    media_eff_floor_bytes: float = 64e3 # cell size at which media eff = 50%
    server_nic_bw: float = 12.5e9       # B/s per server node (each direction)
    client_nic_bw: float = 12.5e9       # B/s per client node
    fabric_lat: float = 3e-6            # one-way network latency
    client_op_time: float = 6e-6        # client-side per-op CPU cost
    queue_depth: int = 16               # async RPCs in flight per process
    setup_time: float = 300e-6          # per-phase constant (connect/barrier)
    # DFuse daemon: one user-space fuse process per client node; everything
    # mounted through it pays a kernel crossing + daemon CPU per op and
    # shares the daemon's streaming capacity.
    fuse_bw: float = 12e9               # B/s per client-node dfuse daemon
    fuse_op_time: float = 18e-6         # daemon CPU per fuse op
    # Client page cache: a hit is a kernel memcpy — no daemon crossing, no
    # fabric, no engine.  Shared per client node (memory bandwidth), plus a
    # cheap syscall per op on the caller's serial chain.
    cache_bw: float = 20e9              # B/s page-cache copy per client node
    cache_op_time: float = 2e-6         # syscall + page-cache lookup per op
    # Coherence revalidation: a timeout-expired cache entry is revalidated
    # against an engine-side version token — one tiny RPC (no payload, no
    # media access), an order of magnitude cheaper than re-fetching the
    # readahead window the entry caches.
    reval_op_time: float = 2e-6         # engine service CPU per token lookup
    # Coherence invalidation delivery (broadcast policy): each message to a
    # sharer is a real upcall — the writer's flush blocks until the sharer
    # acks (strict coherence), the recipient's daemon spends CPU applying
    # it, and a tiny control payload crosses the recipient NIC.  Setting
    # both to 0 recovers the free-oracle delivery of the original CO1
    # study (the coherence bench uses that as its lower-bound contrast).
    coh_msg_time: float = 15e-6         # per-message upcall/ack service time
    coh_msg_bytes: int = 256            # control payload per message
    # Fan-in/fan-out (incast) efficiency: an endpoint streaming to/from k
    # concurrent peers loses NIC efficiency to flow interleaving — the
    # effect that makes wide striping (SX) *worse* than S2 for reads
    # (paper claim C1) while barely hurting writes (C2: SX wins under
    # write contention).  Server side counts client *processes* fanned in.
    incast_alpha_read: float = 0.006
    incast_alpha_write: float = 0.003
    srv_incast_alpha_read: float = 0.006
    srv_incast_alpha_write: float = 0.001
    # Cold object store (the ``cold://`` scheme): an S3-like capacity
    # tier behind a shared gateway.  The cost shape is deliberately the
    # inverse of the engines: every request pays a large time-to-first-
    # byte (auth + HTTP + gateway queueing) on the caller's serial
    # chain, each process streams at a modest per-connection rate, and
    # all concurrent cold traffic shares the gateway aggregate — so
    # parallelism comes from fanning parts across processes (multipart),
    # not from queue depth, and capacity is unbounded (blobs live
    # outside the engines entirely).
    cold_req_time: float = 10e-3        # s per request (TTFB/auth/queue)
    cold_stream_bw: float = 0.30e9      # B/s per process connection
    cold_gw_bw: float = 5e9             # B/s shared gateway aggregate
    # Useful-concurrency ceiling for submission windows: an engine keeps
    # at most qd_overdrive_limit x engine_rpc_threads in-flight slots
    # doing useful work, shared by however many (process, engine) windows
    # target it.  Windows offered beyond that share still congest the
    # service streams (the RPCs really sit in the engine's queues) but
    # complete over the capped *effective* window — overdriving a fixed
    # deep queue under fan-in buys nothing, which is the feedback signal
    # qd=auto mounts pick their steady window from.
    qd_overdrive_limit: float = 8.0

    def incast_eff(self, peers: int, direction: str, server: bool = False
                   ) -> float:
        if server:
            a = (self.srv_incast_alpha_read if direction == "read"
                 else self.srv_incast_alpha_write)
        else:
            a = (self.incast_alpha_read if direction == "read"
                 else self.incast_alpha_write)
        return 1.0 / (1.0 + a * max(0, peers - 1))

    def media_eff(self, cell_bytes: float) -> float:
        """Per-access media efficiency: small stripe cells waste DCPMM/NVMe
        bandwidth (256 B XPLine granularity, prefetcher depth)."""
        if cell_bytes <= 0:
            return 1.0
        return cell_bytes / (cell_bytes + self.media_eff_floor_bytes)


# Alternate profiles for the hardware-adaptation study.
PROFILES = {
    "nextgenio-dcpmm": HWProfile(),
    "nvme-gen4": HWProfile(name="nvme-gen4", engine_read_bw=28e9,
                           engine_write_bw=18e9, media_eff_floor_bytes=128e3,
                           engine_op_time=12e-6),
    "tmpfs": HWProfile(name="tmpfs", engine_read_bw=80e9, engine_write_bw=60e9,
                       media_eff_floor_bytes=8e3, engine_op_time=2e-6),
}


@dataclasses.dataclass(frozen=True)
class Topology:
    n_server_nodes: int = 8
    engines_per_node: int = 2
    n_client_nodes: int = 8
    procs_per_client_node: int = 8

    @property
    def n_engines(self) -> int:
        return self.n_server_nodes * self.engines_per_node

    def node_of_engine(self, engine_id: int) -> int:
        return engine_id // self.engines_per_node

    def engine_ids(self) -> list[int]:
        return list(range(self.n_engines))


class SimClock:
    """Simulated wall clock, advanced by completed phases."""

    def __init__(self) -> None:
        self.now = 0.0
        # observers fired after every advance with the elapsed dt — this is
        # how background I/O debt drains against wall time (compute think
        # time between phases hides prefetch cost exactly like real overlap)
        self.on_advance: list = []

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time cannot run backwards")
        self.now += dt
        for cb in self.on_advance:
            cb(dt)


@dataclasses.dataclass
class _Flow:
    client_node: int
    process: int            # global process rank (client-side)
    engine: int
    direction: str          # 'read' | 'write'
    nbytes: int             # payload through the network & media
    nops: int               # RPC count
    cell_bytes: float       # per-access granularity at the media
    client_lat_per_op: float   # interface-added client latency per op
    proc_bw_cap: float      # per-process stream cap (0 = uncapped)
    via_fuse: bool = False  # passes through the client node's dfuse daemon
    sync: bool = True       # False => async qd; True => serialized per-op
    qd: int = 0             # async in-flight window; 0 = hw.queue_depth,
                            # AUTO_QD (-1) = solver-picked adaptive window


class PhaseRecorder:
    """Accumulates flows for one concurrent I/O phase and solves its time."""

    def __init__(self, sim: "IOSim") -> None:
        self.sim = sim
        # background debt outstanding when this phase began: only *that*
        # debt can stall this phase — prefetch dispatched mid-phase starts
        # draining afterwards (think time, or later phases)
        self._carry = sim._bg_debt
        self.flows: list[_Flow] = []
        # cache-local flows: (client_node, process, nbytes, nops) served
        # from the node's page cache — client memory only, no fabric/engine
        self.local_flows: list[tuple[int, int, int, int]] = []
        # revalidation round trips: (client_node, process, engine, nops) —
        # version-token lookups, charged per-op (no bytes, no media time)
        self.reval_flows: list[tuple[int, int, int, int]] = []
        # coherence invalidation deliveries: (origin_process | None,
        # recipient_node, nops) — per-recipient fabric/upcall time for
        # broadcast messages (origin_process None = async/unattributed:
        # only the recipient side is charged)
        self.coh_flows: list[tuple[int | None, int, int]] = []
        # cold object-store requests: (client_node, process, direction,
        # nbytes, nops) — gateway round trips, no engines and no media
        self.cold_flows: list[tuple[int, int, str, int, int]] = []
        self.md_ops: int = 0         # metadata service round-trips (serial-ish)
        self.elapsed: float | None = None

    def record(self, *, client_node: int, process: int, engine: int,
               direction: str, nbytes: int, nops: int = 1,
               cell_bytes: float | None = None,
               client_lat_per_op: float = 0.0,
               proc_bw_cap: float = 0.0,
               via_fuse: bool = False, sync: bool = True,
               qd: int = 0) -> None:
        if direction not in ("read", "write"):
            raise ValueError(direction)
        self.flows.append(_Flow(client_node, process, engine, direction,
                                int(nbytes), int(nops),
                                float(cell_bytes if cell_bytes else
                                      (nbytes / max(1, nops))),
                                client_lat_per_op, proc_bw_cap,
                                via_fuse, sync, int(qd)))

    def record_md(self, nops: int) -> None:
        self.md_ops += int(nops)

    def record_local(self, *, client_node: int, process: int, nbytes: int,
                     nops: int = 1) -> None:
        self.local_flows.append((client_node, process, int(nbytes),
                                 int(nops)))

    def record_reval(self, *, client_node: int, process: int, engine: int,
                     nops: int = 1) -> None:
        """A revalidation round trip: client -> engine version-token lookup.
        Distinct from a full re-fetch: per-op latency only, no payload."""
        self.reval_flows.append((client_node, process, int(engine),
                                 int(nops)))

    def record_coherence(self, *, recipient_node: int,
                         origin_process: int | None = None,
                         nops: int = 1) -> None:
        """A broadcast invalidation delivered to one sharer: the origin
        process (when known) blocks for the message round trip, and the
        recipient node's daemon pays the upcall service time plus a tiny
        control payload on its NIC."""
        self.coh_flows.append((origin_process, int(recipient_node),
                               int(nops)))

    def record_cold(self, *, client_node: int, process: int, direction: str,
                    nbytes: int, nops: int = 1) -> None:
        """A cold object-store transfer: ``nops`` gateway requests moving
        ``nbytes`` through the caller's connection.  No engines, no media —
        the payload crosses the client NIC, streams at the per-process cold
        connection rate and shares the gateway aggregate."""
        if direction not in ("read", "write"):
            raise ValueError(direction)
        self.cold_flows.append((int(client_node), int(process), direction,
                                int(nbytes), int(nops)))

    # -- solver ------------------------------------------------------------
    def solve(self, setup: bool = True) -> float:
        hw = self.sim.hw
        topo = self.sim.topo
        if (not self.flows and not self.md_ops and not self.local_flows
                and not self.reval_flows and not self.coh_flows
                and not self.cold_flows):
            return 0.0

        eng_media = defaultdict(float)      # engine -> media seconds
        eng_rpc = defaultdict(float)        # engine -> rpc service seconds
        srv_nic = defaultdict(float)        # server node -> bytes
        cli_nic = defaultdict(float)        # client node -> bytes
        cli_peers = defaultdict(set)        # client node -> engines touched
        # byte-weighted direction tallies per endpoint: a node moving data
        # both ways gets the incast efficiency of wherever *most* of its
        # bytes go (ties read), not of whichever flow was recorded last
        cli_dirb = defaultdict(lambda: defaultdict(float))
        srv_dirb = defaultdict(lambda: defaultdict(float))
        proc_chain = defaultdict(float)     # process -> serial client seconds
        proc_stream = defaultdict(lambda: [0.0, 0.0])  # process -> [bytes, cap]
        fuse = defaultdict(lambda: [0.0, 0])  # client node -> [bytes, ops]
        # async submission windows, grouped per (process, engine): every
        # IOD a process has outstanding at one engine pipelines through the
        # same in-flight window — [total ops, deepest fixed qd offered,
        # whether any flow asked for the adaptive (qd=auto) window]
        win_grp = defaultdict(lambda: [0, 0, False])

        # server-side fan-in: reads interleave per requesting *process*
        # (response streams), writes land per client *node* (the NIC-level
        # aggregation point) — this asymmetry is why wide striping hurts
        # reads (C1) but wins contended writes (C2).
        srv_peers = defaultdict(set)        # server node -> peer endpoints
        for f in self.flows:
            cli_peers[f.client_node].add(f.engine)
            cli_dirb[f.client_node][f.direction] += f.nbytes
            srv_node = topo.node_of_engine(f.engine)
            srv_dirb[srv_node][f.direction] += f.nbytes
            peer = f.process if f.direction == "read" else f.client_node
            srv_peers[srv_node].add(peer)
            bw = hw.engine_read_bw if f.direction == "read" else hw.engine_write_bw
            eff = hw.media_eff(f.cell_bytes)
            eng_media[f.engine] += f.nbytes / (bw * eff)
            eng_rpc[f.engine] += f.nops * hw.engine_op_time / hw.engine_rpc_threads
            srv_nic[srv_node] += f.nbytes
            cli_nic[f.client_node] += f.nbytes
            if f.sync:
                # synchronous chain: the caller blocks for the full round
                # trip of every op (POSIX/FUSE semantics)
                proc_chain[f.process] += f.nops * (
                    hw.client_op_time + 2 * hw.fabric_lat
                    + f.client_lat_per_op)
            else:
                # async submission: issuing an RPC is still serial client
                # CPU — that cost never pipelines away, which is what makes
                # deep queues *saturate* instead of dividing latency to
                # zero.  Completion waits are charged below, per window.
                proc_chain[f.process] += f.nops * (hw.client_op_time
                                                   + f.client_lat_per_op)
                g = win_grp[(f.process, f.engine)]
                g[0] += f.nops
                if f.qd == AUTO_QD:
                    g[2] = True
                else:
                    g[1] = max(g[1], f.qd if f.qd > 0 else hw.queue_depth)
            if f.proc_bw_cap:
                s = proc_stream[f.process]
                s[0] += f.nbytes
                s[1] = f.proc_bw_cap
            if f.via_fuse:
                fu = fuse[f.client_node]
                fu[0] += f.nbytes
                fu[1] += f.nops

        # window resolution.  An engine's *useful* concurrency is
        # qd_overdrive_limit x engine_rpc_threads in-flight slots, shared
        # equally by the (process, engine) windows targeting it.  A fixed
        # window keeps its offered depth for the congestion tally (those
        # RPCs really occupy the engine's queues) but completes over the
        # capped effective window — overdriving past the useful share
        # only adds queue-sitting RPCs.  A qd=auto window reads the same
        # feedback upfront: its steady window is the useful share, capped
        # by the client-side auto window (2x the hardware default depth)
        # and the ops it actually has, so auto never overdrives.  Cold
        # auto windows slow-start: one windowed feedback round trip per
        # doubling from the remembered (process, engine) window, then the
        # steady window carries the rest of the phase.
        n_grp = defaultdict(int)
        for (_p, e) in win_grp:
            n_grp[e] += 1
        w_useful = {e: max(1, math.ceil(hw.engine_rpc_threads
                                        * hw.qd_overdrive_limit / n))
                    for e, n in n_grp.items()}
        auto_cap = 2 * hw.queue_depth
        win = {}                 # (p, e) -> (nops, offered, effective)
        ramp_rounds = defaultdict(int)
        for (p, e), (nops, qd, is_auto) in win_grp.items():
            offered = min(qd, max(1, nops)) if qd else 0
            if is_auto:
                steady = min(auto_cap, w_useful[e], max(1, nops))
                offered = max(offered, steady)
                prev_w = self.sim.qd_state.get((p, e), 1)
                if steady > prev_w:
                    ramp_rounds[p] = max(
                        ramp_rounds[p],
                        math.ceil(math.log2(steady / prev_w)))
                self.sim.qd_state[(p, e)] = steady
            win[(p, e)] = (nops, offered, min(offered, w_useful[e]))
        # per-engine service concurrency: the in-flight windows offered to
        # an engine compete for its RPC service streams; once the offered
        # depth exceeds engine_rpc_threads every completion slot stretches
        # proportionally (service-time dilation under load)
        eng_win = defaultdict(int)
        for (_p, e), (_n, offered, _w) in win.items():
            eng_win[e] += offered
        cong = {e: max(1.0, w / hw.engine_rpc_threads)
                for e, w in eng_win.items()}
        # head-of-line blocking: a process's windows drain at the pace of
        # the most congested engine it has IODs outstanding on — one slow
        # engine stalls the whole submission queue behind it
        proc_hol = defaultdict(lambda: 1.0)
        for (p, e) in win_grp:
            proc_hol[p] = max(proc_hol[p], cong[e])
        for (p, e), (nops, _offered, w_eff) in win.items():
            wait = 2 * hw.fabric_lat + hw.engine_op_time * proc_hol[p]
            proc_chain[p] += nops * wait / w_eff
        # slow-start surcharge: each doubling of a cold auto window waits
        # one feedback round trip before widening (AIMD additive phases
        # are folded into the steady window above — congestion here is
        # static within a phase, so only the ramp-in is visible)
        for p, rounds in ramp_rounds.items():
            proc_chain[p] += rounds * (2 * hw.fabric_lat + hw.engine_op_time)

        # cache-local traffic: per-node memory bandwidth + per-op syscall
        # cost on the calling process's serial chain
        cache_node = defaultdict(float)     # client node -> bytes
        for cn, p, nb, ops in self.local_flows:
            cache_node[cn] += nb
            proc_chain[p] += ops * hw.cache_op_time

        # revalidation round trips: serialized on the caller (sync lookup),
        # tiny service slice on the engine, no bytes and no media time
        for cn, p, eng, ops in self.reval_flows:
            proc_chain[p] += ops * (hw.client_op_time + 2 * hw.fabric_lat
                                    + hw.reval_op_time)
            eng_rpc[eng] += ops * hw.reval_op_time / hw.engine_rpc_threads

        # coherence invalidation delivery: the origin process blocks per
        # recipient (strict coherence: the flush completes once sharers
        # ack), the recipient node's daemon applies the upcall, and the
        # control payload crosses the recipient NIC.  With coh_msg_time
        # zeroed the whole charge — round-trip latency included — is off:
        # that is the documented free-delivery oracle contract.
        coh_node = defaultdict(float)       # recipient node -> daemon seconds
        if hw.coh_msg_time > 0:
            for op, rn, ops in self.coh_flows:
                if op is not None:
                    proc_chain[op] += ops * (hw.coh_msg_time
                                             + 2 * hw.fabric_lat)
                coh_node[rn] += ops * hw.coh_msg_time
                cli_nic[rn] += ops * hw.coh_msg_bytes

        # cold object-store traffic: every request pays the gateway's
        # time-to-first-byte on the caller's serial chain, the payload
        # streams over that process's cold connection, crosses the client
        # NIC, and all concurrent cold bytes share the gateway aggregate.
        # Per-process chains are what multipart fan-out parallelizes —
        # up to the gateway cap.
        cold_total = 0
        for cn, p, direction, nb, ops in self.cold_flows:
            proc_chain[p] += ops * hw.cold_req_time + nb / hw.cold_stream_bw
            cli_nic[cn] += nb
            cli_dirb[cn][direction] += nb
            cold_total += nb

        def dominant(dirb: dict) -> str:
            return ("write" if dirb.get("write", 0.0) > dirb.get("read", 0.0)
                    else "read")

        t = 0.0
        for e in set(eng_media) | set(eng_rpc):
            t = max(t, eng_media[e] + eng_rpc[e])
        for n, b in srv_nic.items():
            eff = hw.incast_eff(len(srv_peers[n]), dominant(srv_dirb[n]),
                                server=True)
            t = max(t, b / (hw.server_nic_bw * eff))
        for n, b in cli_nic.items():
            eff = hw.incast_eff(len(cli_peers[n]), dominant(cli_dirb[n]))
            t = max(t, b / (hw.client_nic_bw * eff))
        for p, chain in proc_chain.items():
            t = max(t, chain)
        for p, (b, cap) in proc_stream.items():
            if cap:
                t = max(t, b / cap)
        for n, (b, ops) in fuse.items():
            t = max(t, b / hw.fuse_bw + ops * hw.fuse_op_time)
        for n, b in cache_node.items():
            t = max(t, b / hw.cache_bw)
        for n, s in coh_node.items():
            t = max(t, s)
        if cold_total:
            t = max(t, cold_total / hw.cold_gw_bw)
        # metadata service: treated as a single serialised RPC pipeline
        t = max(t, self.md_ops * self.sim.md_op_time)
        return t + (hw.setup_time if setup else 0.0)

    def finish(self) -> float:
        if self.elapsed is None:
            t = self.solve()
            # background work issued by *earlier* phases drains concurrently
            # with this phase's foreground I/O; only what the phase cannot
            # hide extends it — that remainder is the *visible* prefetch
            # cost Q3 measures.  Debt issued during this phase is not
            # settled here: it drains against whatever wall time follows.
            carry = min(self._carry, self.sim._bg_debt)
            extra = max(0.0, carry - t) if t > 0 else 0.0
            if extra:
                self.sim.bg_stats["paid_s"] += extra
            self.elapsed = t + extra
            self.sim.clock.advance(self.elapsed)
        return self.elapsed

    # -- introspection (used by tests & the bench report) -------------------
    def total_bytes(self, direction: str | None = None) -> int:
        return sum(f.nbytes for f in self.flows
                   if direction is None or f.direction == direction)

    def engine_bytes(self) -> dict[int, int]:
        out: dict[int, int] = defaultdict(int)
        for f in self.flows:
            out[f.engine] += f.nbytes
        return dict(out)

    def imbalance(self) -> float:
        """max/mean engine load — the S1/S2 hot-spot metric."""
        eb = self.engine_bytes()
        if not eb:
            return 1.0
        loads = [eb.get(e, 0) for e in self.sim.topo.engine_ids()]
        mean = sum(loads) / len(loads)
        return (max(loads) / mean) if mean else 1.0


class IOSim:
    """Owns the clock and produces phases."""

    def __init__(self, topo: Topology | None = None,
                 hw: HWProfile | str | None = None,
                 md_op_time: float = 15e-6) -> None:
        self.topo = topo or Topology()
        if isinstance(hw, str):
            hw = PROFILES[hw]
        self.hw = hw or PROFILES["nextgenio-dcpmm"]
        self.clock = SimClock()
        self.md_op_time = md_op_time
        self._active: PhaseRecorder | None = None
        # background (async readahead) accounting: seconds of prefetch I/O
        # issued but not yet drained by wall-time advances, plus lifetime
        # totals for the hidden-fraction metric (Q3)
        self._bg_debt = 0.0
        self.bg_stats = {"issued_s": 0.0, "paid_s": 0.0}
        self.clock.on_advance.append(self._drain_bg)
        # adaptive-qd memory: (process, engine) -> last converged window.
        # Persists across phases, so a process that already ramped re-enters
        # at its steady window instead of slow-starting from 1 every phase.
        self.qd_state: dict[tuple[int, int], int] = {}

    def _drain_bg(self, dt: float) -> None:
        self._bg_debt = max(0.0, self._bg_debt - dt)

    @contextlib.contextmanager
    def phase(self) -> Iterator[PhaseRecorder]:
        rec = PhaseRecorder(self)
        prev, self._active = self._active, rec
        try:
            yield rec
        finally:
            self._active = prev
            rec.finish()

    @contextlib.contextmanager
    def background_phase(self) -> Iterator[PhaseRecorder]:
        """Record flows *off* the caller's critical path.

        Flows recorded inside land in a detached recorder whose solved time
        (no per-phase setup: the connection is already up) becomes *debt*
        instead of advancing the clock.  Debt drains one-for-one against
        subsequent wall-time advances — think time between phases, or other
        phases' foreground I/O — and only the un-drained remainder extends
        the next working phase (``PhaseRecorder.finish``).  Outside any
        enclosing phase this is a no-op recorder, matching ``record()``'s
        contract that un-phased data movement costs nothing.
        """
        rec = PhaseRecorder(self)
        prev, self._active = self._active, rec
        try:
            yield rec
        finally:
            self._active = prev
            rec.elapsed = 0.0           # never advances the clock itself
            if prev is not None:
                dt = rec.solve(setup=False)
                self._bg_debt += dt
                self.bg_stats["issued_s"] += dt

    def bg_hidden_fraction(self) -> float:
        """Fraction of issued background I/O time hidden behind foreground
        work / think time (1.0 when nothing was ever issued)."""
        issued = self.bg_stats["issued_s"]
        return 1.0 - self.bg_stats["paid_s"] / issued if issued else 1.0

    @property
    def active_phase(self) -> PhaseRecorder | None:
        return self._active

    def record(self, **kw) -> None:
        """Record a flow into the active phase; no-op outside a phase (unit
        tests exercising pure data movement don't care about time)."""
        if self._active is not None:
            self._active.record(**kw)

    def record_md(self, nops: int) -> None:
        if self._active is not None:
            self._active.record_md(nops)

    def record_local(self, **kw) -> None:
        """Record a cache-local (client-memory) flow into the active phase."""
        if self._active is not None:
            self._active.record_local(**kw)

    def record_reval(self, **kw) -> None:
        """Record a coherence revalidation round trip into the active
        phase."""
        if self._active is not None:
            self._active.record_reval(**kw)

    def record_coherence(self, **kw) -> None:
        """Record a broadcast invalidation delivery into the active
        phase."""
        if self._active is not None:
            self._active.record_coherence(**kw)

    def record_cold(self, **kw) -> None:
        """Record a cold object-store transfer into the active phase."""
        if self._active is not None:
            self._active.record_cold(**kw)


def bandwidth(nbytes: int, seconds: float) -> float:
    """GiB/s, the paper's reporting unit."""
    if seconds <= 0:
        return math.inf
    return nbytes / seconds / 2**30
