"""The scoring engine over published snapshots: SCORE and SCHEDULE.

The port of the JAX package's ``Engine.score`` / ``Engine.schedule``
(service/engine.py) under the default LoadAware and NodeFit args, in its
default serving configuration: the node inputs are the store's
device-resident tables (``ClusterState(device_state=True)``) and SCHEDULE
warm-starts from the previous cycle's init carry.  Every constraint the
stores hold rides into the cycle: the coscheduling queue order and gang
Permit, ElasticQuota admission against the runtime refresh, and the
reservation restore, scores and nomination; ``assume=True`` applies the
placements to the stores and schedules pending reservations' reserve pods
first.  It returns what the JAX engine returns — ``(totals, feasible,
snapshot)`` and ``(hosts, scores, snapshot, allocations)`` as numpy — bit
for bit.

Shape discipline is the JAX engine's: the node axis is the store capacity
(power-of-two buckets) and the pending-pod axis is padded to a power-of-two
bucket; padded pod rows are masked infeasible and sliced off the result.

Devices: the engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, where the plain PyTorch versions run).  With no card and
no device asked for, construction raises.  A failed transfer or launch on
the card raises; nothing falls back to the host arrays.  What this slice
does not carry raises ``NotImplementedError``: pods with device, cpuset,
node-selector or anti-affinity constraints, and gang, quota or
reservation constraints under a strategy other than LeastAllocated.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from koordinator_tpu_torch import convert
from koordinator_tpu_torch.api.model import AssignedPod, Pod
from koordinator_tpu_torch.core import quota as quota_mod
from koordinator_tpu_torch.core import reservation as rsv_mod
from koordinator_tpu_torch.core.cycle import (
    GangInputs,
    PluginWeights,
    QuotaInputs,
    ReservationInputs,
    score_fn,
    tie_base,
)
from koordinator_tpu_torch.core.gang import GangPodArrays, queue_sort_perm
from koordinator_tpu_torch.core.resolved import (
    _submission_order,
    con_inputs,
    kernel_queue,
    schedule_fn,
    schedule_refresh,
    schedule_rounds_warm,
)
from koordinator_tpu_torch.service import transformers as tf
from koordinator_tpu_torch.service.state import ClusterState, next_bucket
from koordinator_tpu_torch.slices import PLACEMENT, STRATEGIES, later
from koordinator_tpu_torch.snapshot import loadaware as la_snap
from koordinator_tpu_torch.snapshot import nodefit as nf_snap
from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot

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
CHECK_PARENT_DEPTH = 0  # EnableCheckParentQuota off, the JAX engine's default
ANCESTOR_DEPTH = 8  # the quota consumption walk's depth


def _pad_rows(arr: np.ndarray, p: int) -> np.ndarray:
    if arr.shape[0] == p:
        return arr
    pad = np.zeros((p - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def check_slice(pods: List[Pod]) -> None:
    """Refuse every pod the port does not serve yet, naming what it carries
    and the slice that brings it."""
    for p in pods:
        for what, hit in (
            ("a device request", any(p.requests.get(r, 0) > 0 for r in DEVICE_RESOURCES)),
            ("a cpuset request", p.wants_cpuset()),
            ("a node selector", p.node_selector),
            ("required anti-affinity", p.anti_affinity),
        ):
            if hit:
                raise later(f"pod {p.key} carries {what}: scheduling it", PLACEMENT)


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


def reserve_pod_specs(state: ClusterState) -> List[Pod]:
    """Synthesized reserve pods for the store's PENDING reservations
    (reservation_handler.go NewReservePod).  Device-bearing reservations
    stay pending (the restore covers the filter axis only), as do those
    requesting off-axis scalars."""
    specs: List[Pod] = []
    for r in state.reservations.pending():
        spec = Pod(
            name=f"reserve-{r.name}",
            namespace="koord-reservation",
            requests=dict(r.allocatable),
            priority=r.priority or None,
            create_time=r.create_time,
        )
        try:
            check_pods_axis(state, [spec])
        except ValueError:
            continue
        if any(spec.requests.get(res, 0) > 0 for res in DEVICE_RESOURCES):
            continue
        specs.append(spec)
    return specs


class _Constraints(NamedTuple):
    """A batch's constraint inputs: the device tensors the kernels take and
    the host arrays the allocation replay reads."""

    order: np.ndarray  # [p_bucket] queue order (QueueSort Less)
    gang_np: tuple  # (GangPodArrays, GangArrays) of numpy arrays
    gang_names: List[str]
    gang: GangInputs  # tensors
    quota: Optional[QuotaInputs]  # tensors
    rsv_np: Optional[tuple]  # (ReservationArrays numpy, matched [P, Rv])
    rsv_names: List[str]
    rsv: Optional[ReservationInputs]  # tensors (rscore/scores from the kernels)
    rsv_midx: Optional[torch.Tensor]  # [p_bucket, Mm] int32
    rsv_rank: Optional[torch.Tensor]  # [Rv] int64

    @property
    def constrained(self) -> bool:
        """Whether the cycle needs the constrained kernels: a gang row beyond
        the sentinel, a quota tree or a reservation."""
        return (self.gang_np[1].min_member.shape[0] > 1 or self.quota is not None
                or self.rsv is not None)


class _DeferredSchedule:
    """An in-flight SCHEDULE: the kernels are launched, the host has not
    synchronized.  ``finish()`` is the one sync and host copy."""

    __slots__ = ("engine", "out_dev", "P", "snap", "pods", "now", "assume", "cin", "n_reserve",
                 "rscore_dev")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

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
        self.last_ub_rounds = 0  # of which took the quota upper-bound path
        self.last_reservations_placed: Dict[str, str] = {}
        # cross-cycle SCHEDULE warm start: the carry is the resolved
        # engine's init state (M, Mb, la_feas_T) on the device, with the key
        # it is valid under, the row-version watermarks to diff against and
        # the clock its time gates were evaluated at
        self._sched_carry: Optional[dict] = None
        # single-entry begin-input cache: the pod-side tensors keyed on
        # (batch fingerprint, store content, exclude set)
        self._sched_inputs_key: Optional[tuple] = None
        self._sched_inputs_val: Optional[tuple] = None
        # the quota admission limit and the reservation score rows, each
        # cached on the exact inputs it is a pure function of
        self._quota_limit_key: Optional[tuple] = None
        self._quota_limit_val = None
        self._rsv_rows_key: Optional[tuple] = None
        self._rsv_rows_val = None
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

    def _pod_arrays_np(self, pods: List[Pod], p_bucket: int):
        la = la_snap.build_pod_arrays(pods, self.state.la_args)
        nf = nf_snap.build_pod_arrays(pods, self.state.nf_args, axis=self.state.axis)
        la = type(la)(*(_pad_rows(np.asarray(a), p_bucket) for a in la))
        nf = type(nf)(*(_pad_rows(np.asarray(a), p_bucket) for a in nf))
        return la, nf

    def _pod_arrays(self, pods: List[Pod], p_bucket: int):
        la, nf = self._pod_arrays_np(pods, p_bucket)
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
        Columns follow snapshot row indices; dead columns are infeasible.
        Gang, quota and reservation fields do not enter SCORE, as in the
        JAX package."""
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

    # --------------------------------------------------- constraint inputs

    def _tensors(self, nt):
        return type(nt)(*(None if a is None else convert.tensor(a, self.device) for a in nt))

    def _batch_req(self, pods: List[Pod]) -> Dict[str, np.ndarray]:
        """Per-group request vectors of a pending batch (accrued into the
        runtime refresh like the reference accrues pending pods)."""
        st = self.state
        batch_req: Dict[str, np.ndarray] = {}
        for p in pods:
            if p.quota:
                vec = np.array([p.requests.get(r, 0) for r in st.quota.resources],
                               dtype=np.int64)
                batch_req[p.quota] = batch_req.get(p.quota, 0) + vec
        return batch_req

    def _quota_limit_cached(self, qs: QuotaSnapshot, pods: List[Pod]) -> torch.Tensor:
        """The admission limit ([Q, R] runtime refresh, row 0 unlimited) on
        the device, from the ``quota_limit`` kernel, cached on (quota-store
        version, exact batch demand): a hit is bit-identical by
        construction, and a miss launches without a host sync."""
        st = self.state
        batch_req = self._batch_req(pods)
        key = (st.quota.version, tuple(sorted(
            (name, tuple(int(v) for v in vec)) for name, vec in batch_req.items())))
        if self._quota_limit_key == key:
            return self._quota_limit_val
        total = np.array([st.quota.cluster_total.get(r, 0) for r in st.quota.resources],
                         dtype=np.int64)
        qa = qs.arrays()._replace(own_request=st.quota.request_arrays(qs, batch_req))
        val = quota_mod.quota_limit_fn(self._tensors(quota_mod.QuotaArrays(*qa)),
                                       qs.level_tuple(), convert.tensor(total, self.device))
        self._quota_limit_key, self._quota_limit_val = key, val
        return val

    def _rsv_rows_cached(self, req: np.ndarray, matched: np.ndarray, num_nodes: int, rsv_t,
                         rank_t):
        """The reservation plugin's (rscore [P, Rv], scores [P, N]) on the
        device, from the ``rsv_rscore`` and ``rsv_score`` kernels, cached on
        (reservation-store version, node-row mapping, exact request and
        match bytes): both kernels are pure in these inputs."""
        st = self.state
        key = (st.reservations.version, st._imap.mutations, num_nodes, req.shape,
               req.tobytes(), matched.shape, matched.tobytes())
        if self._rsv_rows_key == key:
            return self._rsv_rows_val
        req_t = convert.tensor(req, self.device)
        matched_t = convert.tensor(matched, self.device)
        val = (rsv_mod.rsv_rscore(req_t, rsv_t),
               rsv_mod.rsv_score(req_t, matched_t, num_nodes, rsv_t, rank_t), matched_t)
        self._rsv_rows_key, self._rsv_rows_val = key, val
        return val

    def _constraint_inputs(self, pods: List[Pod], p_bucket: int, nf_req: np.ndarray,
                           num_nodes: int) -> _Constraints:
        """The gang, quota and reservation inputs of a batch from the stores
        (the JAX engine's ``_constraint_inputs``), and its queue order."""
        st = self.state
        gang_pods, gang_arr, gang_names = st.gangs.build(pods, [p.gang for p in pods], p_bucket)
        order = queue_sort_perm(GangPodArrays(*map(torch.from_numpy, gang_pods))).numpy()
        gang = GangInputs(pods=self._tensors(gang_pods), gangs=self._tensors(gang_arr))

        quota = None
        if len(st.quota) and st.quota.cluster_total:
            qs = st.quota.snapshot()
            used, npu = st.quota.used_arrays(qs)
            quota = QuotaInputs(
                pods=self._tensors(st.quota.pod_arrays(pods, [p.quota for p in pods], p_bucket)),
                used=convert.tensor(used, self.device),
                limit=self._quota_limit_cached(qs, pods),
                npu=convert.tensor(npu, self.device),
                min=convert.tensor(qs.prefilter_min(), self.device),
                parent=convert.tensor(qs.parent, self.device),
            )

        rsv_np = rsv = midx = rank = None
        rsv_names: List[str] = []
        if len(st.reservations):
            rv_bucket = next_bucket(max(len(st.reservations), 1), 8)
            rsv_arr, rsv_names = st.reservations.build(st._imap.get, st.axis, rv_bucket)
            if rsv_names:
                row_of = {n: i for i, n in enumerate(rsv_names)}
                matched = np.zeros((p_bucket, rv_bucket), dtype=bool)
                hits: List[List[int]] = [[] for _ in range(p_bucket)]
                for i, p in enumerate(pods):
                    for rn in p.reservations:
                        j = row_of.get(rn)
                        if j is not None and not matched[i, j]:
                            matched[i, j] = True
                            hits[i].append(j)
                # the compact matched view's width: the most matches of one
                # pod, power-of-two bucketed as the JAX engine buckets it
                bound = next_bucket(max(max(len(h) for h in hits), 1), 2)
                midx_np = np.full((p_bucket, bound), -1, dtype=np.int32)
                for i, h in enumerate(hits):
                    midx_np[i, :len(h)] = sorted(h)
                rsv_t = self._tensors(rsv_mod.ReservationArrays(*rsv_arr))
                rank = rsv_mod.order_ranks(torch.from_numpy(rsv_arr.order))[0].to(self.device)
                rscore, scores, matched_t = self._rsv_rows_cached(nf_req, matched, num_nodes,
                                                                  rsv_t, rank)
                rsv = ReservationInputs(rsv=rsv_t, matched=matched_t, rscore=rscore,
                                        scores=scores)
                rsv_np = (rsv_arr, matched)
                midx = convert.tensor(midx_np, self.device)
        return _Constraints(order=order, gang_np=(gang_pods, gang_arr), gang_names=gang_names,
                            gang=gang, quota=quota, rsv_np=rsv_np, rsv_names=rsv_names, rsv=rsv,
                            rsv_midx=midx, rsv_rank=rank)

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
        """Exact-content key over every pod field the SCHEDULE inputs read:
        the snapshot builders, the queue sort and the gang, quota and
        reservation builders.  The placement slice adds the fields it
        reads."""
        return tuple(
            (
                p.name, p.namespace, tuple(sorted(p.requests.items())),
                tuple(sorted(p.limits.items())), p.priority, p.priority_class_label,
                p.qos_fallback_class, p.is_daemonset, p.sub_priority, p.create_time, p.gang,
                p.quota, p.non_preemptible, tuple(p.reservations), p.qos,
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
        mutations during the flight are safe (the snapshot is a copy), but
        they land before the finish-side replay reads the stores."""
        pods = self._prepare(pods)
        now = time.time() if now is None else now
        st = self.state
        self.last_reservations_placed = {}
        n_reserve = 0
        if assume:
            reserve = reserve_pod_specs(st)
            n_reserve = len(reserve)
            pods = reserve + list(pods)
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
            la_pods, nf_pods, excl_rows, cin, order = self._sched_inputs_val
            self.sched_begin_hits += 1
        else:
            la_np, nf_np = self._pod_arrays_np(pods, p_bucket)
            la_pods = convert.la_pods(la_np, self.device)
            nf_pods = convert.nf_pods(nf_np, self.device)
            cin = self._constraint_inputs(pods, p_bucket, np.asarray(nf_np.req), cap)
            order = convert.tensor(cin.order, self.device)
            rows = [i for i in (st._imap.get(n) for n in excl) if i is not None]
            excl_rows = torch.tensor(rows, dtype=torch.int64, device=self.device) if rows else None
            self._sched_inputs_key = in_key
            self._sched_inputs_val = (la_pods, nf_pods, excl_rows, cin, order)
        if cin.constrained and self._nf_static.strategy != "LeastAllocated":
            raise later(f"gang, quota or reservation constraints under "
                        f"{self._nf_static.strategy}", STRATEGIES)
        la_nodes, nf_nodes, valid = self._node_inputs(snap, now)
        if excl_rows is not None:
            valid = valid.clone()  # never write the resident table
            valid[excl_rows] = False
        # carry arbitration: reusable iff everything the init state bakes in
        # is unchanged — batch content, shapes, the store's fence and
        # identity, the gang and reservation stores (their masks and scores
        # enter the packed keys), the name->row map, the exclude set and the
        # provider.  Quota is absent by design: admission enters the rounds,
        # never the init keys, so a quota change keeps the carry warm.
        carry_key = (pods_fp, p_bucket, P, cap, st.warm_fence, st.sched_store_token,
                     st.gangs.version, st.reservations.version, st._imap.mutations, excl,
                     self.sched_warm_token())
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
        con_kw = {}
        if use_warm:
            warm = carry["warm"]
            self.sched_last_dirty = int(dirty.size)
            xs, q_la, q_nf, salts, pod_ok = kernel_queue(la_pods, nf_pods, valid, P, order)
            if cin.constrained:
                con_kw = dict(con=con_inputs(xs, **self._con_args(cin)),
                              check_parent_depth=CHECK_PARENT_DEPTH,
                              ancestor_depth=ANCESTOR_DEPTH)
            node_args = (la_nodes, self._weights, q_nf, nf_nodes, self._nf_static, valid, pod_ok,
                         salts)
            if dirty.size:
                # pow2-bucketed, padded by repeating a real row
                idx = np.full(next_bucket(int(dirty.size), 16), dirty[0], dtype=np.int32)
                idx[: dirty.size] = dirty
                warm = schedule_refresh(warm, idx, q_la, *node_args, BLOCK_SIZE,
                                        **{k: v for k, v in con_kw.items() if k == "con"})
            out = schedule_rounds_warm(warm, q_la, *node_args, COMMIT_CAP, BLOCK_SIZE, **con_kw)
            self.sched_warm_hits += 1
            if cin.constrained:
                hosts_q, scores_q, pre_q, rounds = out
            else:
                hosts_q, scores_q, rounds = out
                pre_q = hosts_q
            hosts, scores = _submission_order(hosts_q, scores_q, xs, p_bucket)
            precommit = _submission_order(pre_q, scores_q, xs, p_bucket)[0]
        else:
            # cold: the full build; on the CPU a strategy other than
            # LeastAllocated takes the scan and leaves no carry, as in the
            # JAX package
            hosts, scores, precommit, rounds, warm = schedule_fn(
                la_pods, la_nodes, self._weights, nf_pods, nf_nodes, self._nf_static, valid, P,
                order, COMMIT_CAP, BLOCK_SIZE,
                con_args=self._con_args(cin) if cin.constrained else None,
                check_parent_depth=CHECK_PARENT_DEPTH, ancestor_depth=ANCESTOR_DEPTH,
            )
            self.sched_cold_inits += 1
        # the carry records the watermarks after this cycle's publish
        self._sched_carry = None
        if warm_ok and warm is not None:
            self._sched_carry = {"key": carry_key, "warm": warm,
                                 "vers": self.sched_versions(), "now": float(now)}
        rounds = rounds.view(-1).to(torch.int64)
        if rounds.numel() == 1:
            rounds = torch.cat([rounds, torch.zeros_like(rounds)])
        out = torch.cat([hosts[:P].to(torch.int64), scores[:P], precommit[:P].to(torch.int64),
                         rounds])
        return _DeferredSchedule(engine=self, out_dev=out, P=P, snap=snap, pods=pods, now=now,
                                 assume=assume, cin=cin, n_reserve=n_reserve,
                                 rscore_dev=None if cin.rsv is None else cin.rsv.rscore)

    @staticmethod
    def _con_args(cin: _Constraints) -> dict:
        """``con_inputs``' arguments besides the queue order."""
        return dict(gang=cin.gang, quota=cin.quota, reservation=cin.rsv, rsv_midx=cin.rsv_midx,
                    rsv_rank=cin.rsv_rank)

    def schedule(
        self,
        pods: List[Pod],
        now: Optional[float] = None,
        assume: bool = False,
        exclude: Optional[List[str]] = None,
    ):
        """The greedy batch assignment in queue order, conflict-resolved,
        with every constraint the stores hold.

        Returns (hosts [P] row index or -1, scores [P] int64, snapshot,
        allocations): ``allocations[i]`` is pod i's PreBind record
        {node, reservation, consumed}, None for unplaced pods.  ``exclude``
        names nodes no pod may take.  ``assume=True`` applies the
        placements to the stores (node rows, quota used, reservation
        allocations, gang satisfaction) and schedules the pending
        reservations' reserve pods ahead of the batch, binding those that
        land (``last_reservations_placed``)."""
        return self.schedule_begin(pods, now=now, assume=assume, exclude=exclude).finish()

    def _finish_schedule(self, d: _DeferredSchedule):
        out = d.out_dev.cpu().numpy()  # the one sync
        P, snap, pods, cin = d.P, d.snap, d.pods, d.cin
        hosts = out[:P].astype(np.int32)
        scores = out[P:2 * P]
        precommit = out[2 * P:3 * P].astype(np.int32)
        self.last_rounds, self.last_ub_rounds = int(out[3 * P]), int(out[3 * P + 1])
        rscore = None if d.rscore_dev is None else d.rscore_dev.cpu().numpy()
        allocations = self._allocation_records(pods, hosts, precommit, cin, rscore, snap, d.now,
                                               d.assume)
        scores = np.where(hosts >= 0, scores, 0)
        if d.assume and cin.gang_names:
            self._mark_satisfied_gangs(pods, hosts, cin)
        if d.n_reserve:
            # bind the reservations whose reserve pods landed; a failed
            # reserve pod marks its reservation unschedulable
            for i in range(d.n_reserve):
                name = pods[i].name[len("reserve-"):]
                if hosts[i] >= 0:
                    node_name = snap.names[hosts[i]]
                    self.state.reservations.bind(name, node_name)
                    self.last_reservations_placed[name] = node_name
                else:
                    info = self.state.reservations.get(name)
                    if info is not None:
                        info.unschedulable_count += 1
                        info.last_error = "reserve pod unschedulable"
            hosts, scores = hosts[d.n_reserve:], scores[d.n_reserve:]
            allocations = allocations[d.n_reserve:]
        return hosts, scores, snap, allocations

    def _allocation_records(self, pods, hosts, precommit, cin: _Constraints, rscore, snap, now,
                            assume):
        """Per-pod PreBind records: the reservation nomination replayed in
        queue order (nominator.go:134-190) against live remainders, over
        the PRE-commit placements so that gang-revoked pods still deplete
        the remainders later pods saw; only surviving pods get records and,
        with ``assume``, store effects.  (The JAX engine's demotions —
        device and cpuset grants, in-batch anti-affinity — and the gang
        rollback they trigger arrive with the placement-and-devices slice:
        no pod of this slice is demoted.)"""
        P = len(pods)
        axis = self.state.axis
        remains = None
        if cin.rsv_np is not None:
            rsv_arr, matched = cin.rsv_np
            remains = np.asarray(rsv_arr.allocatable) - np.asarray(rsv_arr.allocated)
            rsv_nodes, rsv_order = np.asarray(rsv_arr.node), np.asarray(rsv_arr.order)
        allocations: List[Optional[dict]] = [None] * P
        for idx in cin.order:
            if idx >= P or precommit[idx] < 0:
                continue
            pod, host = pods[idx], int(precommit[idx])
            node_name = snap.names[host]
            nom = consume = None
            if remains is not None:
                cand = np.flatnonzero(matched[idx] & (rsv_nodes == host))
                if cand.size:
                    ordered = cand[rsv_order[cand] > 0]
                    if ordered.size:
                        nom = int(ordered[np.lexsort((ordered, rsv_order[ordered]))[0]])
                    else:
                        nom = int(cand[np.argmax(rscore[idx, cand])])
                    pod_req = np.array([pod.requests.get(r, 0) for r in axis], dtype=np.int64)
                    consume = np.maximum(np.minimum(pod_req, remains[nom]), 0)
                    remains[nom] -= consume
            if hosts[idx] < 0:
                continue
            rec = {"node": node_name, "reservation": None, "consumed": {}}
            if nom is not None:
                rec["reservation"] = cin.rsv_names[nom]
                rec["consumed"] = {r: int(v) for r, v in zip(axis, consume) if v}
                if assume:
                    self.state.reservations.note_consume(pod.key, rec["reservation"],
                                                         rec["consumed"])
            if assume:
                self.state.assign_pod(node_name, AssignedPod(pod=pod, assign_time=now))
            allocations[idx] = rec
        return allocations

    def _mark_satisfied_gangs(self, pods, hosts, cin: _Constraints) -> None:
        """setResourceSatisfied for every gang of a group that passed the
        batch Permit (its pods survived commit_gangs)."""
        gang_pods, gangs = cin.gang_np
        G = 1 + len(cin.gang_names)
        placed = np.zeros(G, dtype=np.int64)
        rows = np.asarray(gang_pods.gang)[: len(pods)]
        for i in range(len(pods)):
            if hosts[i] >= 0 and rows[i] > 0:
                placed[rows[i]] += 1
        sat = (placed + np.asarray(gangs.bound_count) >= np.asarray(gangs.min_member)) | \
            np.asarray(gangs.once_satisfied)
        grp = np.asarray(gangs.group)
        ok: Dict[int, bool] = {}
        for gi in range(1, G):
            ok[grp[gi]] = ok.get(grp[gi], True) and bool(sat[gi])
        names = [cin.gang_names[gi - 1] for gi in range(1, G) if ok[grp[gi]]]
        self.state.gangs.mark_satisfied(names)

    def quota_refresh(self, groups, resources: List[str], cluster_total: Dict[str, int]):
        """Whole-tree runtime refresh (RefreshRuntime) on the ``quota``
        kernel: (QuotaSnapshot, runtime [Q, R] numpy)."""
        qs = QuotaSnapshot(groups, resources)
        total = np.array([cluster_total.get(r, 0) for r in resources], dtype=np.int64)
        runtime = quota_mod.quota_fn(self._tensors(quota_mod.QuotaArrays(*qs.arrays())),
                                     qs.level_tuple(), convert.tensor(total, self.device))
        return qs, runtime.cpu().numpy()
