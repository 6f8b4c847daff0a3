"""The scoring sidecar: a TCP server around ClusterState + Engine.

The port of the JAX package's ``SidecarServer`` (service/server.py) for the
verbs the Go shim's product path sends: HELLO, APPLY, SCORE (with the
per-plugin ``breakdown``), SCHEDULE, EXPLAIN, QUOTA_REFRESH, PING and ECHO,
and the descheduler's DESCHEDULE (``service/descheduler.py``; the binary
``cmd/descheduler.py`` sends its ticks), over the same KTPU frames
(``service/protocol.py``).  Every reply header is
built field for field and in the JAX handlers' key order, so a reply is
byte-identical to the JAX sidecar's for the same frames.

Concurrency: each connection thread reads a frame, hands it to the one
worker thread and writes its reply before reading the next, so replies
leave in request order.  The worker owns the store and the engine, which
makes every dispatch serial; on the card it creates the ``Engine`` and
binds its device.  SCHEDULE is answered serially (the JAX server's depth-2
deferral changes when a reply is written, never its bytes).

What the port does not serve yet is refused with a ``BAD_REQUEST`` ERROR
frame whose message names its slice (``slices.later``), never answered
without the work: the other verbs, SCHEDULE's ``preempt`` while the
ElasticQuotaPreemption gate is on, SCORE's ``debug_scores``, and frames
with a tenant or QoS trailer.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import queue
import socket
import socketserver
import threading
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from koordinator_tpu_torch import slices
from koordinator_tpu_torch.core.config import LoadAwareArgs, NodeFitArgs
from koordinator_tpu_torch.core.configio import SchedulerConfig
from koordinator_tpu_torch.core.cycle import PluginWeights
from koordinator_tpu_torch.service import protocol as proto
from koordinator_tpu_torch.service.engine import Engine
from koordinator_tpu_torch.service.state import ClusterState
from koordinator_tpu_torch.utils.features import FeatureGates

M = proto.MsgType
# the verbs of later slices: (what, slice)
REFUSED_VERBS: Dict[int, tuple] = {
    M.HEALTH: ("the HEALTH verb", slices.OBSERVABILITY),
    M.METRICS: ("the METRICS verb", slices.OBSERVABILITY),
    M.TRACE: ("the TRACE verb", slices.OBSERVABILITY),
    M.DEBUG: ("the DEBUG verb", slices.OBSERVABILITY),
    M.DIGEST: ("the DIGEST verb", slices.OBSERVABILITY),
    M.REVOKE: ("the REVOKE verb", slices.PREEMPTION),
    M.RECONCILE: ("the RECONCILE verb", slices.MANAGER),
    M.HOOK: ("the HOOK verb", slices.RUNTIME),
    M.SUBSCRIBE: ("the SUBSCRIBE verb", slices.DURABILITY),
    M.REPL_ACK: ("the REPL_ACK verb", slices.DURABILITY),
    M.PROMOTE: ("the PROMOTE verb", slices.DURABILITY),
    M.REPL_APPLY: ("the REPL_APPLY verb", slices.DURABILITY),
    M.JOIN: ("the JOIN verb", slices.DURABILITY),
    M.STANDBY: ("the STANDBY verb", slices.DURABILITY),
}


class SidecarServer:
    # request-shape failures that can never succeed on retry, and the
    # refusals of later slices
    _BAD_REQUEST_ERRORS = (ValueError, KeyError, TypeError, AssertionError, NotImplementedError)

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        la_args: Optional[LoadAwareArgs] = None,
        nf_args: Optional[NodeFitArgs] = None,
        extra_scalars: tuple = (),
        initial_capacity: int = 256,
        sched_cfg: Optional[SchedulerConfig] = None,
        gates: Optional[FeatureGates] = None,
        device_state: bool = True,
        device=None,
        shards: int = 1,
        shard_map: bool = False,
    ):
        self.gates = gates or FeatureGates()
        # coscheduling/elasticquota args ride HELLO to the shim
        self.sched_cfg = sched_cfg or SchedulerConfig()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the sidecar runs on the card unless the caller "
                "asks for the CPU (device='cpu')"
            )
        # node-axis sharded serving (--shards N): SCORE and SCHEDULE go
        # through a ShardedEngine wrapped around the engine, equal to it by
        # construction.  Power-of-two counts only: capacity buckets are
        # powers of two and the shard count must divide them.
        self._shards_n = max(1, int(shards))
        if self._shards_n & (self._shards_n - 1):
            raise ValueError(f"shards must be a power of two (capacity buckets are), got {shards}")
        self._shard_map = bool(shard_map)
        if self._shard_map and self._shards_n > 1:
            # a misconfigured mesh must not boot and advertise shards in
            # HELLO: its mesh is the cards, or the CPU's one device
            have = torch.cuda.device_count() if self.device.type == "cuda" else 1
            if have < self._shards_n:
                raise ValueError(f"shard_map mode needs >= {self._shards_n} devices, have {have}")
        # the ShardedEngine around the engine, made at the first dispatch
        self._sharded = None
        self.state = ClusterState(la_args, nf_args, extra_scalars=extra_scalars,
                                  initial_capacity=initial_capacity,
                                  device_state=device_state)
        self.engine: Optional[Engine] = None
        # the persistent descheduler (its detector state lives across ticks)
        self._descheduler = None
        # per-plugin scores are bounded by MaxNodeScore, so the weighted
        # total's bound is static config
        bound = 100 * sum(PluginWeights())
        self._score_dtype = np.int16 if bound < 2**15 else np.int32
        self._names_version = 0
        # EXPLAIN decomposition cache: (store content key, exact wire-pod
        # payload, now) -> entries; a hit is bit-identical by
        # construction (the key carries everything the pipeline reads)
        self._explain_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._explain_cache_max = 64
        self.max_frame_length = proto.MAX_FRAME_LENGTH
        self._refusing = False  # terminal drain: new requests get UNAVAILABLE
        self._closed = threading.Event()
        self._work: "queue.Queue" = queue.Queue()
        booted = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._worker_main, args=(booted,), daemon=True,
                                        name="ktpu-worker")
        self._worker.start()
        booted.wait()
        if self._boot_error is not None:
            raise self._boot_error

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
                reader = proto.FrameReader(sock, max_length=outer.max_frame_length)
                writer = proto.FrameWriter(sock)
                try:
                    while True:
                        mt, rid, payload, crc, trace, tenant, qos = reader.read_frame(
                            return_flags=True)
                        reply = outer._serve_frame((mt, rid, payload), tenant, qos)
                        if trace is not None:
                            reply = proto.with_trace(reply, trace)
                        if crc:
                            reply = proto.with_crc(reply)
                        writer.write(reply)
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._serve_thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                              name="ktpu-accept")
        self._serve_thread.start()

    # ------------------------------------------------------------- worker

    def _worker_main(self, booted: threading.Event) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self.engine = Engine(self.state, device=self.device)
        except BaseException as e:  # noqa: BLE001 — raised again by __init__
            self._boot_error = e
            booted.set()
            return
        booted.set()
        while True:
            item = self._work.get()
            if item is None:
                break
            self._process_item(item)
        # a frame enqueued concurrently with close() must not leave its
        # connection waiting forever
        while True:
            try:
                item = self._work.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                frame, box, done = item
                box["claimed"] = True
                box["reply"] = proto.encode_error(frame[1], "server shutting down",
                                                  code=proto.ErrCode.UNAVAILABLE)
                done.set()

    def _serve_frame(self, frame, tenant, qos):
        """One frame from a connection thread: queue it for the worker and
        wait for its reply."""
        if self._refusing:
            return proto.encode_error(frame[1], "server draining for shutdown",
                                      code=proto.ErrCode.UNAVAILABLE)
        if tenant is not None or qos is not None:
            what = "the tenant trailer" if tenant is not None else "the QoS trailer"
            return self._error_reply(frame[1], slices.later(what, slices.TENANCY))
        box: dict = {}
        done = threading.Event()
        self._work.put((frame, box, done))
        while not done.wait(1.0):
            if self._closed.is_set() and not box.get("claimed"):
                return proto.encode_error(frame[1], "server shutting down",
                                          code=proto.ErrCode.UNAVAILABLE)
        return box["reply"]

    def _process_item(self, item) -> None:
        frame, box, done = item
        box["claimed"] = True
        try:
            # the deadline check reads the header alone: a backlog of
            # expired frames drains without materializing their arrays
            _, _, fields, manifest = proto.decode_header(frame)
            shed = self._shed_expired(frame[1], fields)
            box["reply"] = shed if shed is not None else self._dispatch(
                frame[0], frame[1], fields, proto.decode_arrays(manifest))
        except Exception as e:  # noqa: BLE001 — protocol errors go back as ERROR frames
            box["reply"] = self._error_reply(frame[1], e)
        finally:
            done.set()

    def _shed_expired(self, req_id: int, fields) -> Optional[bytes]:
        """A queued request whose ``deadline_ms`` (absolute epoch millis)
        already passed gets DEADLINE_EXCEEDED instead of a cycle."""
        if not isinstance(fields, dict) or fields.get("deadline_ms") is None:
            return None
        deadline = float(fields["deadline_ms"])
        now_ms = time.time() * 1000.0
        if now_ms <= deadline:
            return None
        return proto.encode_error(
            req_id,
            f"deadline exceeded before dispatch ({now_ms - deadline:.0f} ms past deadline_ms)",
            code=proto.ErrCode.DEADLINE_EXCEEDED,
        )

    def _error_reply(self, req_id: int, e: BaseException) -> bytes:
        code = (proto.ErrCode.BAD_REQUEST if isinstance(e, self._BAD_REQUEST_ERRORS)
                else proto.ErrCode.INTERNAL)
        return proto.encode_error(req_id, f"{type(e).__name__}: {e}", code=code,
                                  trace="".join(traceback.format_exception(e)))

    def _serving_engine(self):
        """The engine SCORE and SCHEDULE run through: the plain Engine, or
        (``shards`` > 1) the ShardedEngine wrapped around it, kept with its
        warm per-shard caches (one engine a server until tenants arrive).
        Worker thread only, as every engine consumer."""
        if self._shards_n <= 1:
            return self.engine
        if self._sharded is None:
            from koordinator_tpu_torch.service.sharding import ShardedEngine

            self._sharded = ShardedEngine(self.state, self._shards_n, engine=self.engine,
                                          shard_map=self._shard_map)
        return self._sharded

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        self._closed.set()
        self._server.shutdown()
        self._server.server_close()
        self._work.put(None)
        self._worker.join(timeout=10)

    def shutdown_graceful(self, timeout: float = 30.0) -> bool:
        """SIGTERM semantics: refuse new requests retryably, let the worker
        finish everything already queued, then tear the sockets down.
        True when the worker drained within ``timeout``."""
        self._refusing = True
        self._work.put(None)  # after the flag: nothing new enqueues
        self._worker.join(timeout=timeout)
        self._closed.set()
        self._server.shutdown()
        self._server.server_close()
        return not self._worker.is_alive()

    # -------------------------------------------------------- descheduler

    @staticmethod
    def _build_plugins(entries, allowed=None, point: str = ""):
        """Plugin entries (a bare name, or {"name", "args"}: the
        DeschedulerProfile pluginConfig shape) -> plugin callables; an
        unknown name, or one outside ``allowed``, raises before anything
        changes."""
        from koordinator_tpu_torch.service.descheduler import PLUGIN_FACTORIES

        out = []
        for entry in entries:
            if isinstance(entry, str):
                name, args = entry, None
            else:
                name, args = entry.get("name"), entry.get("args")
            if name not in PLUGIN_FACTORIES:
                raise KeyError(f"unknown descheduler plugins: ['{name}']")
            if allowed is not None and name not in allowed:
                raise ValueError(f"plugin {name!r} is not a {point} plugin")
            out.append(PLUGIN_FACTORIES[name](args))
        return tuple(out)

    @classmethod
    def _build_profiles(cls, entries):
        """DeschedulerProfiles: [{name, deschedule: [entry], balance:
        [entry]}]; each plugin is checked against its extension point."""
        from koordinator_tpu_torch.service.descheduler import (
            BALANCE_PLUGIN_NAMES,
            DESCHEDULE_PLUGIN_NAMES,
            DeschedulerProfile,
        )

        return [DeschedulerProfile(
            name=p.get("name", "default"),
            deschedule=cls._build_plugins(p.get("deschedule", []), DESCHEDULE_PLUGIN_NAMES,
                                          "deschedule"),
            balance=cls._build_plugins(p.get("balance", []), BALANCE_PLUGIN_NAMES, "balance"),
        ) for p in entries]

    def _descheduler_for(self, fields):
        """The server's persistent Descheduler; the frame's pool, limit,
        evictor, plugin, profile and workload fields reconfigure it in
        place, after every plugin and profile entry has been built (a bad
        entry rejects the whole message)."""
        from koordinator_tpu_torch.core.evictor import EvictorArgs, ObjectLimiter
        from koordinator_tpu_torch.service.descheduler import (
            Descheduler,
            EvictionLimits,
            PoolConfig,
        )

        built_plugins = self._build_plugins(fields["plugins"]) if "plugins" in fields else None
        built_profiles = (self._build_profiles(fields["profiles"]) if "profiles" in fields
                          else None)
        if self._descheduler is None:
            self._descheduler = Descheduler(self.state, self.engine)
        d = self._descheduler
        if "use_kernel" in fields:
            d.use_kernel = bool(fields["use_kernel"])
        if "verify" in fields:
            d.verify = bool(fields["verify"])
        if "pools" in fields:
            d.pools = [
                PoolConfig(
                    name=p.get("name", "default"),
                    selector=((lambda n, pre=p["node_prefix"]: n.startswith(pre))
                              if p.get("node_prefix") else None),
                    low_pct={k: float(v) for k, v in p.get("low", {}).items()},
                    high_pct={k: float(v) for k, v in p.get("high", {}).items()},
                    use_deviation=p.get("deviation", False),
                    consecutive_abnormalities=p.get("abnormalities", 5),
                    consecutive_normalities=p.get("normalities", 3),
                    number_of_nodes=p.get("number_of_nodes", 0),
                    weights={k: int(v) for k, v in p.get("weights", {}).items()},
                )
                for p in fields["pools"]
            ]
        if "limits" in fields:
            lim = fields["limits"]
            d.limits = EvictionLimits(per_node=lim.get("per_node"),
                                      per_namespace=lim.get("per_namespace"),
                                      total=lim.get("total"))
        if "evictor" in fields:
            ev = fields["evictor"] or {}
            arb = d.arbitrator
            arb.args = EvictorArgs(
                evict_system_critical_pods=ev.get("system_critical", False),
                evict_local_storage_pods=ev.get("local_storage", False),
                evict_failed_bare_pods=ev.get("failed_bare", False),
                ignore_pvc_pods=ev.get("ignore_pvc", False),
                priority_threshold=ev.get("priority_threshold"),
                label_selector=ev.get("label_selector"),
                max_migrating_per_node=ev.get("max_per_node"),
                max_migrating_per_namespace=ev.get("max_per_namespace"),
                max_migrating_per_workload=ev.get("max_per_workload"),
                max_unavailable_per_workload=ev.get("max_unavailable"),
                skip_check_expected_replicas=ev.get("skip_replicas_check", False),
                object_limiter_duration=ev.get("limiter_duration", 0.0),
                object_limiter_max_migrating=ev.get("limiter_max_migrating"),
            )
            # a new filter config rebuilds the rate limiter; the active
            # jobs outlive it
            arb.limiter = ObjectLimiter(arb.args.object_limiter_duration,
                                        arb.args.object_limiter_max_migrating,
                                        arb.args.max_migrating_per_workload)
        if built_plugins is not None:
            d.plugins = built_plugins
        if built_profiles is not None:
            d.profiles = built_profiles
        if "workloads" in fields:
            # the controllerfinder feed, owner_uid -> expectedReplicas: an
            # authoritative snapshot that replaces the last one
            d.arbitrator.workloads = {k: int(v) for k, v in fields["workloads"].items()}
        return d

    def start_descheduler(self, interval: float, fields: Optional[dict] = None):
        """The timed loop (wait.Until(deschedulerOnce, interval)): a thread
        enqueues DESCHEDULE ticks (executing unless ``fields`` say
        otherwise) into the worker's queue; each reply's fields append to
        ``descheduler_history``."""
        self.descheduler_history: list = []
        fields = dict(fields or {})

        def loop():
            while not self._closed.is_set():
                done = threading.Event()
                box: dict = {}
                f = dict(fields)
                f.setdefault("execute", True)
                f["now"] = time.time()
                frame = proto.encode(M.DESCHEDULE, 0, f)
                self._work.put(((M.DESCHEDULE, 0, memoryview(frame)[proto._HDR.size:]), box,
                                done))
                while not done.wait(1.0):
                    if self._closed.is_set() and not box.get("claimed"):
                        return
                if "reply" in box:
                    _, _, rf, _ = proto.decode((0, 0, memoryview(box["reply"])[proto._HDR.size:]))
                    self.descheduler_history.append(rf)
                self._closed.wait(interval)

        t = threading.Thread(target=loop, daemon=True, name="ktpu-desched-tick")
        t.start()
        return t

    # ----------------------------------------------------------- messages

    def _apply_ops_reply(self, ops) -> dict:
        """Apply one delta batch through the wire-op switch, bump the
        name<->column mapping version only on a column mutation."""
        from koordinator_tpu_torch.service.wireops import apply_wire_ops

        muts_before = self.state._imap.mutations
        rejects = apply_wire_ops(self.state, ops)
        if self.state._imap.mutations != muts_before:
            self._names_version += 1
        reply = {
            "num_live": self.state.num_live,
            "dirty": self.state.dirty_count,
            "names_version": self._names_version,
        }
        if rejects:
            reply["rejects"] = rejects
        return reply

    def _schedule_reply(self, req_id, fields, hosts, scores, snap, allocations,
                        names_version):
        """The SCHEDULE reply: live-column translation + PreBind records."""
        live_idx = np.flatnonzero(snap.valid)
        reply_fields = {
            "generation": snap.generation,
            "num_live": int(live_idx.size),
            "names_version": names_version,
        }
        reply_arrays = {"live_idx": live_idx.astype(np.int32)}
        if fields.get("names_version") != names_version:
            reply_fields["names"] = [snap.names[i] for i in live_idx]
        # hosts are row indices; translate to live-column positions
        pos = np.full(snap.valid.shape[0], -1, dtype=np.int32)
        pos[live_idx] = np.arange(live_idx.size, dtype=np.int32)
        reply_arrays["hosts"] = np.where(hosts >= 0, pos[hosts], -1).astype(np.int32)
        reply_arrays["scores"] = scores.astype(np.int64)
        reply_fields["allocations"] = [
            None
            if rec is None
            else {
                "rsv": rec["reservation"],
                "consumed": rec["consumed"],
                **({"devices": rec["devices"]} if rec.get("devices") else {}),
                **({"cpuset": rec["cpuset"]} if rec.get("cpuset") else {}),
            }
            for rec in allocations
        ]
        if self.engine.last_reservations_placed:
            reply_fields["reservations_placed"] = self.engine.last_reservations_placed
        return proto.encode_parts(M.SCHEDULE, req_id, reply_fields, reply_arrays)

    def _dispatch(self, msg_type, req_id, fields, arrays):
        if msg_type == M.PING:
            return proto.encode(M.PING, req_id, {"gen": self.state._generation})

        if msg_type == M.ECHO:
            # asymmetric probe: "resp_like" asks for zero arrays of given specs
            out = dict(arrays)
            for spec in fields.get("resp_like", []):
                out[spec["name"]] = np.zeros(spec["shape"], dtype=np.dtype(spec["dtype"]))
            return proto.encode_parts(M.ECHO, req_id, {}, out)

        if msg_type == M.HELLO:
            hello = {
                "axis": self.state.axis,
                "resources": self.state.la_args.resources,
                "score_resources": self.state.rs,
                "capacity": self.state.capacity,
                "names_version": self._names_version,
                "coscheduling": dataclasses.asdict(self.sched_cfg.coscheduling),
                "elasticquota": dataclasses.asdict(self.sched_cfg.elasticquota),
            }
            if self._shards_n > 1:
                # sharded serving's advertisement, absent for one shard (the
                # Go golden transcript's bytes are unchanged)
                hello["shards"] = self._shards_n
            return proto.encode(M.HELLO, req_id, hello)

        if msg_type == M.APPLY:
            return proto.encode(M.APPLY, req_id, self._apply_ops_reply(fields.get("ops", [])))

        if msg_type == M.SCHEDULE:
            pods = [proto.pod_from_wire(d) for d in fields.get("pods", [])]
            if fields.get("preempt", False) and self.gates.enabled("ElasticQuotaPreemption"):
                raise slices.later("SCHEDULE's preempt (the preemption plan)", slices.PREEMPTION)
            deferred = self._serving_engine().schedule_begin(pods, now=fields.get("now"),
                                                             assume=fields.get("assume", False))
            # the columns are the begin-time snapshot's
            nv0 = self._names_version
            hosts, scores, snap, allocations = deferred.finish()
            return self._schedule_reply(req_id, fields, hosts, scores, snap, allocations, nv0)

        if msg_type == M.SCORE:
            if fields.get("debug_scores"):
                raise slices.later("SCORE's debug_scores", slices.OBSERVABILITY)
            pods = [proto.pod_from_wire(d) for d in fields.get("pods", [])]
            now = fields.get("now")
            totals, feasible, snap = self._serving_engine().score(pods, now=now)
            live_idx = np.flatnonzero(snap.valid)
            reply_fields = {
                "generation": snap.generation,
                "num_live": int(live_idx.size),
                "names_version": self._names_version,
            }
            reply_arrays = {"live_idx": live_idx.astype(np.int32)}
            if fields.get("names_version") != self._names_version:
                reply_fields["names"] = [snap.names[i] for i in live_idx]
            reply_arrays["scores"] = totals[:, live_idx].astype(self._score_dtype)
            reply_arrays["feasible"] = np.packbits(feasible[:, live_idx], axis=1)
            if fields.get("breakdown"):
                parts, _ = self.engine.score_breakdown(pods, now=now)
                reply_fields["breakdown_plugins"] = sorted(parts)
                for plugin, mat in parts.items():
                    reply_arrays[f"breakdown_{plugin}"] = mat[:, live_idx].astype(
                        self._score_dtype)
            return proto.encode_parts(msg_type, req_id, reply_fields, reply_arrays)

        if msg_type == M.EXPLAIN:
            wire_pods = fields.get("pods", [])
            now = fields.get("now")
            if now is None:
                # a clockless request reads the wall clock now, so the
                # cache key carries the clock the pipeline uses
                now = time.time()
            ckey = (self.state.content_key, json.dumps(wire_pods, sort_keys=True), now)
            entries = self._explain_cache.get(ckey)
            if entries is not None:
                self._explain_cache.move_to_end(ckey)
            else:
                pods = [proto.pod_from_wire(d) for d in wire_pods]
                entries = self.engine.explain(pods, now=now)
                self._explain_cache[ckey] = entries
                while len(self._explain_cache) > self._explain_cache_max:
                    self._explain_cache.popitem(last=False)
            return proto.encode(M.EXPLAIN, req_id, {
                "explain": entries,
                "generation": self.state._generation,
                "num_live": self.state.num_live,
            })

        if msg_type == M.QUOTA_REFRESH:
            groups = [proto.quota_group_from_wire(d) for d in fields["groups"]]
            qs, runtime = self.engine.quota_refresh(groups, fields["resources"], fields["total"])
            return proto.encode(M.QUOTA_REFRESH, req_id, {"groups": [g.name for g in qs.groups]},
                                {"runtime": runtime[1:]})  # row 0 = virtual root

        if msg_type == M.DESCHEDULE:
            if not self.gates.enabled("LowNodeLoad"):
                return proto.encode(M.DESCHEDULE, req_id, {"plan": [], "executed": 0})
            d = self._descheduler_for(fields)
            execute = bool(fields.get("execute", False))
            plan = d.tick(fields.get("now", 0.0), dry_run=not execute)
            executed = d.execute(plan, fields.get("now", 0.0)) if execute else 0
            reply = {"plan": plan, "executed": executed}
            if execute:
                # the completed moves (pod, from, to)
                reply["migrated"] = list(d.last_migrations)
            if d.last_util:
                # the node-utilisation percentiles per pool
                reply["util"] = d.last_util
            return proto.encode(M.DESCHEDULE, req_id, reply)

        refused = REFUSED_VERBS.get(msg_type)
        if refused is not None:
            raise slices.later(*refused)
        raise ValueError(f"unknown message type {msg_type}")
