"""The scoring engine over published snapshots: SCORE and SCHEDULE.

The port of the JAX package's ``Engine.score`` / ``Engine.schedule``
(service/engine.py) for plain pods under the default LoadAware and NodeFit
args, in its default serving configuration: the node inputs are the
store's device-resident tables (``ClusterState(device_state=True)``) and
SCHEDULE warm-starts from the previous cycle's init carry.  It returns what
the JAX engine returns — ``(totals, feasible, snapshot)`` and ``(hosts,
scores, snapshot, allocations)`` as numpy — bit for bit.

Shape discipline is the JAX engine's: the node axis is the store capacity
(power-of-two buckets) and the pending-pod axis is padded to a power-of-two
bucket; padded pod rows are masked infeasible and sliced off the result.

Devices: the engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, where the plain PyTorch versions run).  With no card and
no device asked for, construction raises.  A failed transfer or launch on
the card raises; nothing falls back to the host arrays.  What this slice
does not carry raises ``NotImplementedError``: pods with gang, quota,
reservation, device, cpuset, node-selector or anti-affinity constraints,
and ``assume=True``.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from koordinator_tpu_torch import convert
from koordinator_tpu_torch.api.model import Pod
from koordinator_tpu_torch.core.cycle import PluginWeights, score_fn, tie_base
from koordinator_tpu_torch.core.resolved import (
    _submission_order,
    kernel_queue,
    schedule_fn,
    schedule_refresh,
    schedule_rounds_warm,
)
from koordinator_tpu_torch.service import transformers as tf
from koordinator_tpu_torch.service.state import ClusterState, next_bucket
from koordinator_tpu_torch.slices import CONSTRAINTS, PLACEMENT, later
from koordinator_tpu_torch.snapshot import loadaware as la_snap
from koordinator_tpu_torch.snapshot import nodefit as nf_snap

# the deviceshare plugin's resources (core/deviceshare.py in the JAX package)
DEVICE_RESOURCES = (
    "koordinator.sh/gpu-core",
    "koordinator.sh/gpu-memory-ratio",
    "koordinator.sh/rdma",
)

# the resolved engine's packed-key score bound under the default weight
# profile, the JAX engine's _SCHED_SCORE_BOUND (service/engine.py:150):
# the host decides warm-carry eligibility exactly as the JAX kernel does
_w = PluginWeights()
SCHED_SCORE_BOUND = 100 * (_w.loadaware + _w.nodefit + _w.reservation + _w.numa + _w.nodefit)
del _w

COMMIT_CAP = 16
BLOCK_SIZE = 16


def _pad_rows(arr: np.ndarray, p: int) -> np.ndarray:
    if arr.shape[0] == p:
        return arr
    pad = np.zeros((p - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def queue_order(pods: List[Pod], p_bucket: int) -> np.ndarray:
    """The coscheduling QueueSort ``Less`` over plain pods (priority desc,
    sub-priority desc, creation time asc, submission order), padded rows
    last: the JAX package's ``queue_sort_perm`` over the gang store's pod
    rows, where a plain pod has gang row 0."""
    prio = np.full(p_bucket, -(1 << 60), dtype=np.int64)
    sub = np.zeros(p_bucket, dtype=np.int64)
    ts = np.full(p_bucket, np.inf, dtype=np.float64)
    for i, p in enumerate(pods):
        prio[i] = p.priority or 0
        sub[i] = p.sub_priority or 0
        ts[i] = p.create_time
    return np.lexsort((np.arange(p_bucket), ts, -sub, -prio))


def check_slice(pods: List[Pod]) -> None:
    """Refuse every pod the port does not serve yet, naming what it carries
    and the slice that brings it."""
    for p in pods:
        for what, hit, slice_name in (
            ("a gang", p.gang, CONSTRAINTS),
            ("a quota", p.quota, CONSTRAINTS),
            ("reservations", p.reservations, CONSTRAINTS),
            ("a device request", any(p.requests.get(r, 0) > 0 for r in DEVICE_RESOURCES),
             PLACEMENT),
            ("a cpuset request", p.wants_cpuset(), PLACEMENT),
            ("a node selector", p.node_selector, PLACEMENT),
            ("required anti-affinity", p.anti_affinity, PLACEMENT),
        ):
            if hit:
                raise later(f"pod {p.key} carries {what}: scheduling it", slice_name)


def check_pods_axis(state: ClusterState, pods: List[Pod]) -> None:
    """Reject pods requesting scalars outside the configured filter axis
    (silently dropping a request dimension would admit pods the reference
    would reject)."""
    ax = set(state.axis)
    for p in pods:
        for r, v in p.requests.items():
            if (
                v > 0
                and r != "pods"
                and r not in ax
                and r not in DEVICE_RESOURCES
                and not state.nf_args.is_ignored(r)
            ):
                raise ValueError(
                    f"pod {p.key} requests scalar {r!r} outside the "
                    f"configured filter axis {state.axis}"
                )


class _DeferredSchedule:
    """An in-flight SCHEDULE: the kernels are launched, the host has not
    synchronized.  ``finish()`` is the one sync and host copy."""

    __slots__ = ("engine", "out_dev", "P", "snap")

    def __init__(self, engine, out_dev, P, snap):
        self.engine, self.out_dev, self.P, self.snap = engine, out_dev, P, snap

    def finish(self):
        return self.engine._finish_schedule(self)


class Engine:
    def __init__(self, state: ClusterState, pod_bucket_min: int = 16, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the engine runs on the card unless the caller "
                "asks for the CPU (device='cpu')"
            )
        self.state = state
        self._pod_bucket_min = pod_bucket_min
        weights = la_snap.build_weights(state.la_args)
        if weights.sum() <= 0:
            raise ValueError("the LoadAware resource weights must sum to > 0")
        self._weights = convert.weights(weights, self.device)
        self._nf_static = nf_snap.build_static([], state.nf_args, axis=state.axis)
        self.transformers = tf.default_registry()
        self.last_rounds = 0  # resolution rounds of the last SCHEDULE
        # cross-cycle SCHEDULE warm start: the carry is the resolved
        # engine's init state (M, Mb, la_feas_T) on the device, with the key
        # it is valid under, the row-version watermarks to diff against and
        # the clock its time gates were evaluated at
        self._sched_carry: Optional[dict] = None
        # single-entry begin-input cache: the pod-side tensors keyed on
        # (batch fingerprint, store content, exclude set)
        self._sched_inputs_key: Optional[tuple] = None
        self._sched_inputs_val: Optional[tuple] = None
        self.sched_warm_enabled = True
        self.sched_warm_hits = 0
        self.sched_cold_inits = 0
        self.sched_begin_hits = 0
        self.sched_last_dirty = 0  # rows the last warm cycle refreshed
        # dirty fraction above which the cold rebuild replaces the refresh
        self._sched_warm_max_frac = 0.25

    def _prepare(self, pods: List[Pod]) -> List[Pod]:
        for stage in (tf.BEFORE_PRE_FILTER, tf.BEFORE_FILTER, tf.BEFORE_SCORE):
            pods = self.transformers.run(stage, pods, self.state)
        check_pods_axis(self.state, pods)
        check_slice(pods)
        return pods

    def _pod_arrays(self, pods: List[Pod], p_bucket: int):
        la = la_snap.build_pod_arrays(pods, self.state.la_args)
        nf = nf_snap.build_pod_arrays(pods, self.state.nf_args, axis=self.state.axis)
        la = type(la)(*(_pad_rows(np.asarray(a), p_bucket) for a in la))
        nf = type(nf)(*(_pad_rows(np.asarray(a), p_bucket) for a in nf))
        return convert.la_pods(la, self.device), convert.nf_pods(nf, self.device)

    def _node_inputs(self, snap, now: float):
        """(la_nodes, nf_nodes, valid) on the engine's device.  With
        residency on (the default), the resident tables, synced by delta
        scatter and time-gated on the device; they must not be written.
        With ``device_state=False``, the published host arrays, copied."""
        res = self.state.residency
        if res.enabled:
            return res.serving_node_inputs(now, self.device)
        return (
            convert.la_nodes(snap.la_nodes, self.device),
            convert.nf_nodes(snap.nf_nodes, self.device),
            convert.tensor(snap.valid, self.device),
        )

    def score(self, pods: List[Pod], now: Optional[float] = None):
        """(totals [P, cap] int64, feasible [P, cap] bool, snapshot).
        Columns follow snapshot row indices; dead columns are infeasible."""
        pods = self._prepare(pods)
        now = time.time() if now is None else now
        snap = self.state.publish(now)
        p_bucket = next_bucket(max(len(pods), 1), self._pod_bucket_min)
        la_pods, nf_pods = self._pod_arrays(pods, p_bucket)
        la_nodes, nf_nodes, valid = self._node_inputs(snap, now)
        totals, feasible = score_fn(
            la_pods, la_nodes, self._weights, nf_pods, nf_nodes, self._nf_static, valid
        )
        P = len(pods)
        return totals[:P].cpu().numpy(), feasible[:P].cpu().numpy(), snap

    # ------------------------------------- cross-cycle SCHEDULE warm start

    def sched_warm_token(self) -> tuple:
        """Provider-identity part of the warm-carry and input-cache keys
        (a sharded engine substitutes its layout here)."""
        return ("solo",)

    def sched_versions(self) -> tuple:
        return self.state.sched_versions()

    def sched_dirty_rows(self, vers: tuple) -> np.ndarray:
        return self.state.sched_dirty_rows(vers)

    def _sched_warm_ok(self, num_nodes: int) -> bool:
        """The JAX kernel's warm-carry eligibility: the packed-key matrix
        engine with int32 key lanes under the JAX bound."""
        return (
            self.sched_warm_enabled
            and self._nf_static.strategy == "LeastAllocated"
            and (SCHED_SCORE_BOUND + 1) * tie_base(num_nodes) < (1 << 30)
        )

    def _pods_fingerprint(self, pods: List[Pod]) -> tuple:
        """Exact-content key over every pod field a plain pod's SCHEDULE
        inputs read: the snapshot builders and the queue sort.  The
        constraints and placement slices add the fields they read."""
        return tuple(
            (
                p.name, p.namespace, tuple(sorted(p.requests.items())),
                tuple(sorted(p.limits.items())), p.priority, p.priority_class_label,
                p.qos_fallback_class, p.is_daemonset, p.sub_priority, p.create_time, p.qos,
            )
            for p in pods
        )

    def schedule_begin(
        self,
        pods: List[Pod],
        now: Optional[float] = None,
        assume: bool = False,
        exclude: Optional[List[str]] = None,
    ) -> _DeferredSchedule:
        """Launch a SCHEDULE and return without waiting for the device; the
        result's ``finish()`` is the one sync and host copy.  Store
        mutations during the flight are safe (the snapshot is a copy)."""
        if assume:
            raise later("SCHEDULE with assume=True", CONSTRAINTS)
        pods = self._prepare(pods)
        now = time.time() if now is None else now
        st = self.state
        snap = st.publish(now)
        P = len(pods)
        p_bucket = next_bucket(max(P, 1), self._pod_bucket_min)
        cap = snap.valid.shape[0]
        excl = tuple(sorted(set(exclude or ())))
        pods_fp = self._pods_fingerprint(pods)
        # begin-input cache: the pod-side assembly is a pure function of
        # the key, so a hit is bit-identical by construction
        in_key = (pods_fp, p_bucket, P, cap, st.content_key, st.warm_fence, excl,
                  self.sched_warm_token())
        if in_key == self._sched_inputs_key:
            la_pods, nf_pods, order, excl_rows = self._sched_inputs_val
            self.sched_begin_hits += 1
        else:
            la_pods, nf_pods = self._pod_arrays(pods, p_bucket)
            order = convert.tensor(queue_order(pods, p_bucket), self.device)
            rows = [i for i in (st._imap.get(n) for n in excl) if i is not None]
            excl_rows = torch.tensor(rows, dtype=torch.int64, device=self.device) if rows else None
            self._sched_inputs_key = in_key
            self._sched_inputs_val = (la_pods, nf_pods, order, excl_rows)
        la_nodes, nf_nodes, valid = self._node_inputs(snap, now)
        if excl_rows is not None:
            valid = valid.clone()  # never write the resident table
            valid[excl_rows] = False
        # carry arbitration: reusable iff everything the init state bakes in
        # is unchanged — batch content, shapes, the store's fence and
        # identity, the name->row map, the exclude set and the provider.
        # The constraints slice adds the gang and reservation versions.
        carry_key = (pods_fp, p_bucket, P, cap, st.warm_fence, st.sched_store_token,
                     st._imap.mutations, excl, self.sched_warm_token())
        carry = self._sched_carry
        warm_ok = self._sched_warm_ok(cap)
        use_warm = warm_ok and carry is not None and carry["key"] == carry_key
        if use_warm:
            # rows whose stamps moved past the carry's watermarks, plus rows
            # whose metric-expiry gate flips between the two clocks
            dirty = self.sched_dirty_rows(carry["vers"])
            flips = st.sched_gate_flips(carry["now"], now)
            if flips.size:
                dirty = np.union1d(dirty, flips).astype(np.int32)
            if dirty.size > self._sched_warm_max_frac * cap:
                use_warm = False
        if use_warm:
            warm = carry["warm"]
            self.sched_last_dirty = int(dirty.size)
            xs, q_la, q_nf, salts, pod_ok = kernel_queue(la_pods, nf_pods, valid, P, order)
            node_args = (la_nodes, self._weights, q_nf, nf_nodes, self._nf_static, valid, pod_ok,
                         salts)
            if dirty.size:
                # pow2-bucketed, padded by repeating a real row
                idx = np.full(next_bucket(int(dirty.size), 16), dirty[0], dtype=np.int32)
                idx[: dirty.size] = dirty
                warm = schedule_refresh(warm, idx, q_la, *node_args, BLOCK_SIZE)
            hosts_q, scores_q, rounds = schedule_rounds_warm(
                warm, q_la, *node_args, COMMIT_CAP, BLOCK_SIZE
            )
            self.sched_warm_hits += 1
            hosts, scores = _submission_order(hosts_q, scores_q, xs, p_bucket)
        else:
            # cold: the full build; on the CPU a strategy other than
            # LeastAllocated takes the scan and leaves no carry, as in the
            # JAX package
            hosts, scores, _, rounds, warm = schedule_fn(
                la_pods, la_nodes, self._weights, nf_pods, nf_nodes, self._nf_static, valid, P,
                order, COMMIT_CAP, BLOCK_SIZE,
            )
            self.sched_cold_inits += 1
        # the carry records the watermarks after this cycle's publish
        self._sched_carry = None
        if warm_ok and warm is not None:
            self._sched_carry = {"key": carry_key, "warm": warm,
                                 "vers": self.sched_versions(), "now": float(now)}
        out = torch.cat([hosts[:P].to(torch.int64), scores[:P], rounds.view(1).to(torch.int64)])
        return _DeferredSchedule(self, out, P, snap)

    def schedule(
        self,
        pods: List[Pod],
        now: Optional[float] = None,
        assume: bool = False,
        exclude: Optional[List[str]] = None,
    ):
        """The greedy batch assignment in queue order, conflict-resolved.

        Returns (hosts [P] row index or -1, scores [P] int64, snapshot,
        allocations): ``allocations[i]`` is pod i's PreBind record
        {node, reservation, consumed}, None for unplaced pods.  ``exclude``
        names nodes no pod may take."""
        return self.schedule_begin(pods, now=now, assume=assume, exclude=exclude).finish()

    def _finish_schedule(self, d: _DeferredSchedule):
        out = d.out_dev.cpu().numpy()  # the one sync
        P, snap = d.P, d.snap
        hosts = out[:P].astype(np.int32)
        scores = out[P:2 * P]
        self.last_rounds = int(out[2 * P])
        allocations = [
            {"node": snap.names[h], "reservation": None, "consumed": {}} if h >= 0 else None
            for h in hosts.tolist()
        ]
        scores = np.where(hosts >= 0, scores, 0)
        return hosts, scores, snap, allocations
