"""Blocking client — the in-repo stand-in for the Go ``TPUScoreBackend``
shim (the ScorePlugin registered like any other plugin,
cmd/koord-scheduler/main.go:46-54 pattern, calling out at the
RunScorePlugins cut point framework_extender.go:237).

It speaks the verbs the port's sidecar serves: HELLO (on connect), APPLY,
SCORE (with ``breakdown``), SCHEDULE, EXPLAIN, QUOTA_REFRESH, PING, ECHO
and DESCHEDULE.  Caches the live-column -> node-name mapping by ``names_version`` so
steady-state score calls move only numeric buffers.
"""

from __future__ import annotations

import itertools
import socket
from typing import Dict, List, Optional, Sequence

import numpy as np

from koordinator_tpu_torch.service import protocol as proto


class SidecarError(RuntimeError):
    """A structured ERROR reply: ``code`` is the protocol.ErrCode taxonomy,
    ``retryable`` tells a caller whether re-sending the same request can
    ever succeed."""

    def __init__(self, message: str, code: str = proto.ErrCode.INTERNAL,
                 retryable: bool = False, trace: str = ""):
        super().__init__(message)
        self.code = code
        self.retryable = retryable
        self.trace = trace

    def __repr__(self) -> str:
        # name the taxonomy code, not its default object repr
        return (
            f"SidecarError(code={self.code}, retryable={self.retryable}, "
            f"{str(self)!r})"
        )


class Client:
    """``connect_timeout`` bounds the TCP handshake; ``call_timeout`` each
    call, generous because a first call on the card builds the kernels."""

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0,
                 call_timeout: float = 600.0):
        self._sock = socket.create_connection(
            (host, port), timeout=min(connect_timeout, call_timeout)
        )
        self._sock.settimeout(call_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        # zero-copy codec (one reusable recv buffer, one grow-only send
        # scratch): the serial call pattern fully consumes each reply
        # before the next read, so the reuse is safe by construction
        self._reader = proto.FrameReader(self._sock)
        self._writer = proto.FrameWriter(self._sock)
        self._req_ids = itertools.count(1)
        self._names_version = -1
        self._names: List[str] = []
        self.hello = self._call(proto.MsgType.HELLO, {})[0]

    def close(self):
        self._sock.close()

    def _call(self, msg_type: int, fields: dict, arrays=None):
        """One request/response; an ERROR reply raises ``SidecarError``."""
        req_id = next(self._req_ids)
        self._writer.write(proto.encode_parts(msg_type, req_id, fields, arrays))
        r_type, r_id, r_fields, r_arrays = proto.decode(self._reader.read_frame())
        if r_type == proto.MsgType.ERROR:
            raise SidecarError(
                f"sidecar error: {r_fields['error']}\n{r_fields.get('trace', '')}",
                code=r_fields.get("code", proto.ErrCode.INTERNAL),
                retryable=r_fields.get("retryable", False),
                trace=r_fields.get("trace", ""),
            )
        assert r_id == req_id, (r_id, req_id)
        return r_fields, r_arrays

    def _note_names(self, fields):
        if "names" in fields:
            self._names = list(fields["names"])
            self._names_version = fields["names_version"]

    # ------------------------------------------------------------- calls

    def ping(self) -> dict:
        return self._call(proto.MsgType.PING, {})[0]

    def echo(self, arrays=None, resp_like=None) -> dict:
        """Wire-overhead probe: round-trips ``arrays``; ``resp_like``
        [{name, dtype, shape}] additionally requests bulk zero arrays in
        the response only (the real traffic shape)."""
        return self._call(
            proto.MsgType.ECHO, {"resp_like": resp_like or []}, arrays
        )[1]

    @staticmethod
    def op_upsert(node) -> dict:
        return {"op": "upsert", "node": proto.node_spec_to_wire(node)}

    @staticmethod
    def op_metric(name: str, metric) -> dict:
        return {"op": "metric", "node": name, "m": proto.metric_to_wire(metric)}

    @staticmethod
    def op_assign(node: str, ap) -> dict:
        return {"op": "assign", "node": node, "pod": proto.pod_to_wire(ap.pod), "t": ap.assign_time}

    @staticmethod
    def op_unassign(pod_key: str) -> dict:
        return {"op": "unassign", "key": pod_key}

    @staticmethod
    def op_remove(name: str) -> dict:
        return {"op": "remove", "node": name}

    @staticmethod
    def op_topology(node: str, info) -> dict:
        """NodeResourceTopology report (CPU layout + TM policy + ratio)."""
        return {"op": "topology", "node": node, "t": proto.topology_to_wire(info)}

    @staticmethod
    def op_topology_remove(node: str) -> dict:
        return {"op": "topology_remove", "node": node}

    @staticmethod
    def op_devices(node: str, gpus, rdma=()) -> dict:
        """Device CRD inventory (fresh free state; tracked allocations
        replay server-side)."""
        return {"op": "devices", "node": node, "d": proto.devices_to_wire(gpus, rdma)}

    @staticmethod
    def op_devices_remove(node: str) -> dict:
        return {"op": "devices_remove", "node": node}

    @staticmethod
    def op_gang(info) -> dict:
        return {"op": "gang", "g": proto.gang_to_wire(info)}

    @staticmethod
    def op_gang_remove(name: str) -> dict:
        return {"op": "gang_remove", "name": name}

    @staticmethod
    def op_quota(group) -> dict:
        return {"op": "quota", "g": proto.quota_group_to_wire(group)}

    @staticmethod
    def op_quota_remove(name: str) -> dict:
        return {"op": "quota_remove", "name": name}

    @staticmethod
    def op_quota_total(total: Dict[str, int]) -> dict:
        return {"op": "quota_total", "total": total}

    @staticmethod
    def op_reservation(info) -> dict:
        return {"op": "rsv", "r": proto.reservation_to_wire(info)}

    @staticmethod
    def op_reservation_remove(name: str) -> dict:
        return {"op": "rsv_remove", "name": name}

    def apply_ops(self, ops: Sequence[dict]) -> dict:
        """Send one ordered delta batch (built with the op_* helpers).  Ops
        are applied server-side in exactly this order — required whenever a
        batch contains order-dependent compounds (pod move = unassign then
        assign; node recreate = remove then upsert)."""
        return self._call(proto.MsgType.APPLY, {"ops": list(ops)})[0]

    def apply(
        self,
        upserts: Sequence = (),
        metrics: Optional[Dict[str, object]] = None,
        assigns: Sequence = (),
        unassigns: Sequence[str] = (),
        removes: Sequence[str] = (),
    ) -> dict:
        """Category convenience over apply_ops.  Flattened in the order
        removes, unassigns, upserts, metrics, assigns — deletions first so
        the common compounds (remove+recreate, unassign+assign elsewhere)
        apply correctly; histories that interleave within a category across
        these boundaries must use apply_ops directly."""
        ops: List[dict] = []
        ops += [self.op_remove(n) for n in removes]
        ops += [self.op_unassign(k) for k in unassigns]
        ops += [self.op_upsert(n) for n in upserts]
        ops += [self.op_metric(name, m) for name, m in (metrics or {}).items()]
        ops += [self.op_assign(node, ap) for node, ap in assigns]
        return self.apply_ops(ops)

    def score(self, pods: Sequence, now: Optional[float] = None):
        """(scores [P, L], feasible [P, L] bool, node_names [L]).

        Score dtype is int16 when the values fit (the common case) and
        int32 otherwise — shim implementers must honor the manifest dtype,
        not assume a fixed width."""
        fields, arrays = self._call(
            proto.MsgType.SCORE,
            {
                "pods": [proto.pod_to_wire(p) for p in pods],
                "now": now,
                "names_version": self._names_version,
            },
        )
        self._note_names(fields)
        L = fields["num_live"]
        feasible = np.unpackbits(arrays["feasible"], axis=1, count=L).astype(bool)
        return arrays["scores"], feasible, list(self._names)

    def score_breakdown(self, pods: Sequence, now: Optional[float] = None):
        """The per-plugin query API: {plugin: [P, live] raw scores} per
        live node column (frameworkext/services debug endpoints)."""
        fields, arrays = self._call(
            proto.MsgType.SCORE,
            {
                "pods": [proto.pod_to_wire(p) for p in pods],
                "now": now,
                "names_version": self._names_version,
                "breakdown": True,
            },
        )
        self._note_names(fields)
        return {
            plugin: arrays[f"breakdown_{plugin}"]
            for plugin in fields.get("breakdown_plugins", [])
        }

    def schedule_full(self, pods: Sequence, now: Optional[float] = None,
                      assume: bool = False):
        """The whole SCHEDULE reply: (host_names, scores, allocations,
        reply_fields).  ``reply_fields`` carries the pieces a real shim
        consumes beyond the convenience tuple — ``reservations_placed``
        above all (the resync mirror needs it)."""
        fields, arrays = self._call(
            proto.MsgType.SCHEDULE,
            {
                "pods": [proto.pod_to_wire(p) for p in pods],
                "now": now,
                "names_version": self._names_version,
                "assume": assume,
            },
        )
        self._note_names(fields)
        hosts = arrays["hosts"]
        names = [self._names[h] if h >= 0 else None for h in hosts]
        return (
            names,
            arrays["scores"],
            fields.get("allocations", [None] * len(names)),
            fields,
        )

    def schedule(
        self, pods: Sequence, now: Optional[float] = None, assume: bool = False
    ):
        """(host_names [P] (None = unschedulable), scores [P] int64,
        allocations [P]).  ``allocations[i]`` is the PreBind-equivalent
        record {rsv, consumed} for placed pods (None otherwise).  With
        assume=True the sidecar applies the placements to its own state
        (the scheduler assume path) so back-to-back cycles see them."""
        names, scores, allocations, _ = self.schedule_full(pods, now=now, assume=assume)
        return names, scores, allocations

    def explain(self, pods: Sequence, now: Optional[float] = None) -> dict:
        """The EXPLAIN verb: per-pod schedule decomposition over the
        sidecar's live state — ``{"explain": [{pod, node, total,
        components, weights, stages, infeasible, demoted?}, ...],
        "generation", ...}``.  The chosen node + total bit-match a
        SCHEDULE reply over the same state; every infeasible node carries
        non-empty reason codes (Gang | Quota | Placement | Device |
        LoadAware | NodeFit)."""
        f, _ = self._call(
            proto.MsgType.EXPLAIN,
            {"pods": [proto.pod_to_wire(p) for p in pods], "now": now},
        )
        return f

    def quota_refresh(self, groups: Sequence, resources: List[str], total: Dict[str, int]):
        """{group-name: {resource: runtime}} (RefreshRuntime over the wire)."""
        fields, arrays = self._call(
            proto.MsgType.QUOTA_REFRESH,
            {
                "groups": [proto.quota_group_to_wire(g) for g in groups],
                "resources": resources,
                "total": total,
            },
        )
        runtime = arrays["runtime"]
        return {
            name: {r: int(runtime[i, j]) for j, r in enumerate(resources)}
            for i, name in enumerate(fields["groups"])
        }

    def deschedule(
        self,
        now: float,
        pools: Optional[Sequence[dict]] = None,
        limits: Optional[dict] = None,
        execute: bool = False,
        evictor: Optional[dict] = None,
        workloads: Optional[dict] = None,
        plugins: Optional[Sequence[str]] = None,
        profiles: Optional[Sequence[dict]] = None,
    ):
        """One descheduling tick -> (migration plan, executed count).  Pool
        dicts: {name, node_prefix, low, high, deviation, abnormalities,
        normalities, number_of_nodes, weights}.  ``evictor`` reconfigures
        the safety layer ({system_critical, local_storage, failed_bare,
        ignore_pvc, priority_threshold, label_selector, max_per_node,
        max_per_namespace, max_per_workload, max_unavailable,
        skip_replicas_check, limiter_duration, limiter_max_migrating});
        ``workloads`` feeds owner_uid -> expectedReplicas; ``plugins`` names
        the enabled plugins (or {name, args}); ``profiles`` are
        DeschedulerProfiles [{name, deschedule: [...], balance: [...]}]
        replacing the flat plugin list."""
        fields = {"now": now, "execute": execute}
        for key, val in (("pools", pools), ("limits", limits), ("evictor", evictor),
                         ("workloads", workloads), ("plugins", plugins),
                         ("profiles", profiles)):
            if val is not None:
                fields[key] = list(val) if key in ("pools", "plugins", "profiles") else val
        f = self.deschedule_full(**fields)
        return f["plan"], f["executed"]

    def deschedule_full(self, **fields):
        """One DESCHEDULE tick returning the whole reply: plan, executed,
        ``migrated`` (completed moves {pod, from, to}) and ``util`` (the
        node-utilisation percentiles per pool).  ``fields`` are the knobs
        ``deschedule`` assembles, and ``use_kernel`` and ``verify``."""
        f, _ = self._call(proto.MsgType.DESCHEDULE, dict(fields))
        return f
