"""The descheduler as a system around the LowNodeLoad round.

The port of the JAX package's ``service/descheduler.py`` (pkg/descheduler):

- a multi-pool tick (``Descheduler.tick``, driven by the sidecar's
  DESCHEDULE message or ``SidecarServer.start_descheduler``, the
  ``wait.Until(deschedulerOnce, interval)`` loop of descheduler.go:246-259),
  with per-pool anomaly-detector state carried across rounds;
- the balance of each pool as ONE ``deschedule_round`` kernel family on the
  engine's device (``core.deschedule``), its outputs read back in one copy;
- the migration arbitrator (arbitrator.go + filter.go), whose band order is
  the ``pod_band_rank`` kernel;
- the eviction limiter (evictions.go:65-221): per-node, per-namespace and
  total caps in the arbitrated order, scoped to one tick;
- migration-as-reservation (controllers/migration/controller.go:218-241):
  every surviving eviction becomes a PodMigrationJob-shaped plan entry, and
  ``execute`` drives the reservation-first migration machine in-store
  (reservation, eviction, rebind with ``Engine.schedule(assume=True)``),
  writing every store effect through ``wireops.apply_wire_ops``.

``verify`` (on by default on the CPU, off on the card) re-runs the unfused
host pipeline — ``balance_round`` plus the eviction-order sort, and
``core.evictor.pod_sort_order`` for the band order — on CPU copies of the
same inputs and raises on any difference; it never replaces a result.
``use_kernel`` only decides whether the reply carries the utilisation
percentiles: the round runs as the kernel on the card either way.

Not carried: the journal of the controller effects, metrics, tracing and
the flight recorder (each a later slice of the port).
"""

from __future__ import annotations

import copy
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.core.deschedule import (
    band_keys,
    deschedule_round,
    pod_band_rank,
    to_host,
)
from koordinator_tpu_torch.core.evictor import (
    MAX_EVICTION_COST,
    EvictorArgs,
    ObjectLimiter,
    build_evict_arrays,
    evictable_mask,
    job_sort_order,
    max_cost_mask,
    max_unavailable,
    pod_sort_order,
)
from koordinator_tpu_torch.core.lownodeload import (
    AnomalyState,
    LNLNodeArrays,
    LNLPodArrays,
    as_tensors,
    balance_round,
    usage_score,
)

# PodMigrationJob phases + abort reasons (apis/scheduling PodMigrationJob,
# controllers/migration/controller.go abort paths)
JOB_PENDING = "Pending"
JOB_RUNNING = "Running"
JOB_SUCCEEDED = "Succeeded"
JOB_FAILED = "Failed"
REASON_RESERVATION_UNSCHEDULABLE = "ReservationUnschedulable"
REASON_RESERVATION_BOUND_BY_OTHER = "ReservationBoundByAnotherPod"
REASON_RESERVATION_EXPIRED = "ReservationExpired"
REASON_RESERVATION_MISSING = "ReservationMissing"
REASON_POD_CHANGED = "PodChanged"
REASON_EXPIRED = "JobExpired"
REASON_CAPPED = "EvictionLimited"
REASON_INTERRUPTED = "ReconcileInterrupted"


def _pod_bucket(n: int) -> int:
    """Candidate-pod axis bucket (powers of two, floor 16); padding rows
    are ``removable=False`` and inert in every output."""
    if n <= 0:
        return 1
    return max(16, 1 << (n - 1).bit_length())


@dataclass
class PoolConfig:
    """One node pool's LowNodeLoad args (LowNodeLoadArgs + NodePool)."""

    name: str = "default"
    # node-name predicate; None = every node
    selector: Optional[Callable[[str], bool]] = None
    low_pct: Dict[str, float] = field(default_factory=dict)
    high_pct: Dict[str, float] = field(default_factory=dict)
    use_deviation: bool = False
    consecutive_abnormalities: int = 5
    consecutive_normalities: int = 3
    number_of_nodes: int = 0
    weights: Dict[str, int] = field(default_factory=dict)


@dataclass
class EvictionLimits:
    """evictions.go:65-221 caps; None = unlimited."""

    per_node: Optional[int] = None
    per_namespace: Optional[int] = None
    total: Optional[int] = None


class Arbitrator:
    """The migration arbitrator (arbitrator.go doOnceArbitrate + filter.go):
    candidate jobs are SORTED by the four-stage SortFn chain, then FILTERED
    — non-retryable failures (max eviction cost, defaultevictor
    constraints, expected replicas) drop the job; retryable ones (workload
    rate limiter, per-node / per-namespace / per-workload migrating and
    unavailable budgets) defer it.  Passed jobs are active until
    ``job_done`` retires them and count against later budgets.

    ``workloads`` is the controllerfinder stand-in: owner_uid ->
    expectedReplicas; an unregistered owner fails the workload filters.
    The band order runs as ``pod_band_rank`` on ``device`` (the card
    unless the caller asks for the CPU); ``verify`` (on for the CPU, off on
    the card) holds it against ``pod_sort_order``."""

    def __init__(self, state, args: Optional[EvictorArgs] = None,
                 workloads: Optional[Dict[str, int]] = None, device=None):
        self.state = state
        self.args = args or EvictorArgs()
        self.workloads = dict(workloads or {})
        self.limiter = ObjectLimiter(
            self.args.object_limiter_duration,
            self.args.object_limiter_max_migrating,
            self.args.max_migrating_per_workload,
        )
        # pod key -> {"node", "ns", "owner", "phase", "created_at"}
        self.active: Dict[str, dict] = {}
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the arbitrator runs on the card unless the caller "
                "asks for the CPU (device='cpu')"
            )
        self.verify = self.device.type == "cpu"

    # -- counting helpers (the reference's field-indexed client Lists) -----

    def _count_node(self, node: str, self_key: str) -> int:
        return sum(1 for k, j in self.active.items() if k != self_key and j["node"] == node)

    def _count_namespace(self, ns: str, self_key: str) -> int:
        return sum(1 for k, j in self.active.items() if k != self_key and j["ns"] == ns)

    def _unavailable_by_owner(self, owners) -> Dict[str, set]:
        """owner_uid -> keys of its pods that are not (active && ready),
        one cluster walk a round (filter.go:394-407)."""
        out: Dict[str, set] = {o: set() for o in owners if o is not None}
        for node in self.state._nodes.values():
            for ap in node.assigned_pods:
                o = ap.pod.owner_uid
                if o in out and (not ap.pod.is_ready or ap.pod.is_failed):
                    out[o].add(ap.pod.key)
        return out

    # ------------------------------------------------------------- filters

    def _nonretryable_ok(self, pod, ev_ok: bool) -> bool:
        """filter.go:118-127: max eviction cost, defaultevictor.Filter
        (``ev_ok``), expected replicas."""
        if pod.eviction_cost == MAX_EVICTION_COST:
            return False
        if not ev_ok:
            return False
        return self._expected_replicas_ok(pod)

    def _expected_replicas_ok(self, pod) -> bool:
        """filter.go:362-392 filterExpectedReplicas."""
        if pod.owner_uid is None:
            return True
        replicas = self.workloads.get(pod.owner_uid)
        if replicas is None:
            return False  # controllerfinder error path
        if self.args.skip_check_expected_replicas:
            return True
        mm = max_unavailable(replicas, self.args.max_migrating_per_workload)
        mu = max_unavailable(replicas, self.args.max_unavailable_per_workload)
        return not (replicas == 1 or replicas == mm or replicas == mu)

    def _retryable_ok(self, pod, node: str, now: float, unavail: Dict[str, set]) -> bool:
        """filter.go:131-139: the evict annotation bypasses the budget
        filters; otherwise limiter + the three budget caps."""
        if pod.evict_annotation:
            return True
        if not self.limiter.allow(pod.owner_uid, now):
            return False
        if (self.args.max_migrating_per_node is not None
                and self.args.max_migrating_per_node > 0
                and self._count_node(node, pod.key) >= self.args.max_migrating_per_node):
            return False
        if (self.args.max_migrating_per_namespace is not None
                and self.args.max_migrating_per_namespace > 0
                and self._count_namespace(pod.namespace, pod.key)
                >= self.args.max_migrating_per_namespace):
            return False
        return self._workload_budget_ok(pod, unavail)

    def _workload_budget_ok(self, pod, unavail: Dict[str, set]) -> bool:
        """filter.go:291-360 filterMaxMigratingOrUnavailablePerWorkload."""
        if pod.owner_uid is None:
            return True
        replicas = self.workloads.get(pod.owner_uid)
        if replicas is None:
            return False
        mm = max_unavailable(replicas, self.args.max_migrating_per_workload)
        mu = max_unavailable(replicas, self.args.max_unavailable_per_workload)
        migrating = {k for k, j in self.active.items()
                     if k != pod.key and j.get("owner") == pod.owner_uid}
        if migrating and len(migrating) >= mm:
            return False
        # the candidate itself counts when unavailable
        unavailable = set(unavail.get(pod.owner_uid, ()))
        unavailable |= migrating
        return len(unavailable) < mu

    # ----------------------------------------------------------- arbitrate

    def band_order(self, arrays) -> np.ndarray:
        """Stage 2 of the SortFn chain: the ``pod_band_rank`` kernel on the
        arbitrator's device (its plain version on the CPU)."""
        order = pod_band_rank(band_keys(arrays, device=self.device)).cpu().numpy()
        if self.verify and not np.array_equal(order, pod_sort_order(arrays)):
            raise RuntimeError("pod_band_rank diverged from the pod_sort_order host oracle")
        return order

    def arbitrate(self, jobs: List[dict], now: float):
        """Sort + filter one round of candidate jobs ({"_pod", "from"}).
        Returns (passed, requeued, failed), ``passed`` in arbitrated order;
        passed jobs become active at once so later jobs see them."""
        if not jobs:
            return [], [], []
        pods = [j["_pod"] for j in jobs]
        unavail = self._unavailable_by_owner({p.owner_uid for p in pods})
        arrays = build_evict_arrays(pods, self.args.label_selector)
        ev_ok = evictable_mask(arrays, self.args) & max_cost_mask(arrays)
        migrating_per_owner: Dict[str, int] = {}
        for j in self.active.values():
            o = j.get("owner")
            if o is not None:
                migrating_per_owner[o] = migrating_per_owner.get(o, 0) + 1
        order = job_sort_order(
            arrays, np.arange(len(jobs)),
            np.array([j.get("job_create_time", now) for j in jobs]),
            migrating_per_owner, pod_order=self.band_order(arrays),
        )
        passed, requeued, failed = [], [], []
        for idx in order:
            job, pod = jobs[idx], pods[idx]
            # filterExistingPodMigrationJob (arbitrator.go:126)
            if pod.key in self.active:
                failed.append(job)
                continue
            if not self._nonretryable_ok(pod, bool(ev_ok[idx])):
                failed.append(job)
                continue
            if not self._retryable_ok(pod, job["from"], now, unavail):
                requeued.append(job)
                continue
            self.active[pod.key] = {
                "node": job["from"],
                "ns": pod.namespace,
                "owner": pod.owner_uid,
                "phase": "pending",
                "created_at": now,
            }
            passed.append(job)
        return passed, requeued, failed

    def job_done(self, pod_key: str, evicted_pod=None, now: float = 0.0) -> None:
        """Migration finished (or aborted): retire the job; on a real
        eviction, feed the workload rate limiter (trackEvictedPod)."""
        self.active.pop(pod_key, None)
        if evicted_pod is not None and evicted_pod.owner_uid is not None:
            replicas = self.workloads.get(evicted_pod.owner_uid)
            if replicas:
                self.limiter.track(evicted_pod.owner_uid, replicas, now)


# ---------------------------------------------------- violation plugins
#
# The k8s descheduler plugin family (RemovePodsViolating*): each scans the
# live store for pods whose placement no longer satisfies a constraint
# that was checked at schedule time, yielding (pod, node) eviction
# candidates for the shared arbitrate/probe/limiter pipeline.


def tolerates(pod, taint: Dict[str, str]) -> bool:
    """corev1 Toleration.ToleratesTaint: the effect check applies FIRST
    to every toleration (empty toleration effect matches all); then an
    empty key with Exists matches any taint, Exists matches on key, Equal
    needs key+value."""
    for tol in pod.tolerations:
        eff = tol.get("effect", "")
        if eff != "" and eff != taint.get("effect"):
            continue
        op = tol.get("operator", "Equal")
        if tol.get("key", "") == "":
            if op == "Exists":
                return True
            continue
        if tol.get("key") != taint.get("key"):
            continue
        if op == "Exists" or tol.get("value") == taint.get("value"):
            return True
    return False


def remove_pods_violating_node_affinity(state, now: float = 0.0, evict_ok=None):
    """RemovePodsViolatingNodeAffinity: the pod's required node selector
    no longer matches its node's labels (labels changed after binding)."""
    out = []
    for name, node in state._nodes.items():
        for ap in node.assigned_pods:
            sel = ap.pod.node_selector
            if sel and not all(node.labels.get(k) == v for k, v in sel.items()):
                out.append((ap.pod, name))
    return out


def remove_pods_violating_node_taints(state, now: float = 0.0, evict_ok=None):
    """RemovePodsViolatingNodeTaints: the node carries a NoSchedule/
    NoExecute taint the pod does not tolerate."""
    out = []
    for name, node in state._nodes.items():
        bad = [
            t
            for t in node.taints
            if t.get("effect") in ("NoSchedule", "NoExecute")
        ]
        if not bad:
            continue
        for ap in node.assigned_pods:
            if any(not tolerates(ap.pod, t) for t in bad):
                out.append((ap.pod, name))
    return out


def remove_pods_violating_interpod_antiaffinity(state, now: float = 0.0, evict_ok=None):
    """RemovePodsViolatingInterPodAntiAffinity (node topology): a pod
    whose required anti-affinity selector matches a CO-LOCATED pod's
    labels is violating; the matched pod is the eviction candidate (the
    upstream plugin evicts the pods the term selects, not the holder)."""
    out = []
    seen = set()
    for name, node in state._nodes.items():
        pods = node.assigned_pods
        for ap in pods:
            sel = ap.pod.anti_affinity
            if not sel:
                continue
            for other in pods:
                if other.pod.key == ap.pod.key:
                    continue
                if all(other.pod.labels.get(k) == v for k, v in sel.items()):
                    if other.pod.key not in seen:
                        seen.add(other.pod.key)
                        out.append((other.pod, name))
    return out


DEFAULT_VIOLATION_PLUGINS = (
    remove_pods_violating_node_affinity,
    remove_pods_violating_node_taints,
    remove_pods_violating_interpod_antiaffinity,
)

# the plugin registry (descheduler framework registry.go + profiles):
# DESCHEDULE's "plugins" field selects by name, like a deschedulerProfile's
# enabled-plugins list
VIOLATION_PLUGIN_REGISTRY = {
    "RemovePodsViolatingNodeAffinity": remove_pods_violating_node_affinity,
    "RemovePodsViolatingNodeTaints": remove_pods_violating_node_taints,
    "RemovePodsViolatingInterPodAntiAffinity": (
        remove_pods_violating_interpod_antiaffinity
    ),
}


def _plugin_factories():
    """Full registry parity with the reference's ten upstream plugins +
    this framework's three zero-arg violation scans
    (pkg/descheduler/framework/plugins/kubernetes/
    plugin.go:63-127).  Each factory takes the plugin's args dict (the
    DeschedulerProfile pluginConfig equivalent) and returns the callable
    ``plugin(state, now, evict_ok)``."""
    from koordinator_tpu_torch.service import deschedplugins as dp

    def _no_args(fn):
        def make(args=None):
            if args:
                raise ValueError(f"plugin takes no args, got {sorted(args)}")
            return fn

        return make

    def _dataclass_factory(plugin_cls, args_cls):
        def make(args=None):
            kw = dict(args or {})
            # tuple-ify list-valued fields so dataclass defaults compare
            for k, v in kw.items():
                if isinstance(v, list):
                    kw[k] = tuple(v)
            try:
                return plugin_cls(args_cls(**kw))
            except TypeError as e:
                raise ValueError(f"{plugin_cls.name}: bad args: {e}") from None

        return make

    reg = {n: _no_args(f) for n, f in VIOLATION_PLUGIN_REGISTRY.items()}
    reg.update(
        {
            "PodLifeTime": _dataclass_factory(dp.PodLifeTime, dp.PodLifeTimeArgs),
            "RemoveFailedPods": _dataclass_factory(
                dp.RemoveFailedPods, dp.RemoveFailedPodsArgs
            ),
            "RemovePodsHavingTooManyRestarts": _dataclass_factory(
                dp.RemovePodsHavingTooManyRestarts,
                dp.RemovePodsHavingTooManyRestartsArgs,
            ),
            "RemoveDuplicates": _dataclass_factory(
                dp.RemoveDuplicates, dp.RemoveDuplicatesArgs
            ),
            "RemovePodsViolatingTopologySpreadConstraint": _dataclass_factory(
                dp.RemovePodsViolatingTopologySpreadConstraint,
                dp.TopologySpreadArgs,
            ),
            "HighNodeUtilization": _dataclass_factory(
                dp.HighNodeUtilization, dp.HighNodeUtilizationArgs
            ),
            "LowNodeUtilization": _dataclass_factory(
                dp.LowNodeUtilization, dp.LowNodeUtilizationArgs
            ),
        }
    )
    return reg


PLUGIN_FACTORIES = _plugin_factories()

# extension-point classification (framework/types.go:80-96: the upstream
# family registers as DeschedulePlugin or BalancePlugin; deschedulerOnce
# runs all profiles' Deschedule pass, then all profiles' Balance pass,
# descheduler.go:271-283)
DESCHEDULE_PLUGIN_NAMES = frozenset(
    {
        "PodLifeTime",
        "RemoveFailedPods",
        "RemovePodsHavingTooManyRestarts",
        "RemovePodsViolatingNodeAffinity",
        "RemovePodsViolatingNodeTaints",
        "RemovePodsViolatingInterPodAntiAffinity",
    }
)
BALANCE_PLUGIN_NAMES = frozenset(
    {
        "RemoveDuplicates",
        "RemovePodsViolatingTopologySpreadConstraint",
        "HighNodeUtilization",
        "LowNodeUtilization",
    }
)


@dataclass
class DeschedulerProfile:
    """One DeschedulerProfile (apis/config v1alpha2 + runtime/framework.go):
    a named plugin set split by extension point."""

    name: str = "default"
    deschedule: Tuple[Callable, ...] = ()
    balance: Tuple[Callable, ...] = ()



class Descheduler:
    """The descheduling loop of one store and engine.  The round runs on
    the engine's device; ``last_split`` holds the last tick's host-clock
    seconds by stage (``pool_arrays``, ``kernel``, ``verify``,
    ``arbitrate``, ``probe``, ``execute``) and ``last_arbitrations`` its arbitrations of a
    non-empty job list (one band order each)."""

    def __init__(
        self,
        state,
        engine,
        pools: Optional[List[PoolConfig]] = None,
        limits: Optional[EvictionLimits] = None,
        resources: Tuple[str, ...] = ("cpu", "memory"),
        evictor_args: Optional[EvictorArgs] = None,
        workloads: Optional[Dict[str, int]] = None,
        plugins: Optional[Tuple[Callable, ...]] = DEFAULT_VIOLATION_PLUGINS,
        profiles: Optional[List["DeschedulerProfile"]] = None,
        use_kernel: bool = True,
        verify: Optional[bool] = None,
    ):
        self.state = state
        self.engine = engine
        self.device = engine.device
        self.pools = pools or [PoolConfig()]
        self.limits = limits or EvictionLimits()
        self.resources = list(resources)
        self.arbitrator = Arbitrator(state, evictor_args, workloads, device=self.device)
        self.plugins = tuple(plugins or ())
        # DeschedulerProfiles: when set they REPLACE the flat plugin list
        # (every profile's Deschedule pass, then every Balance pass)
        self.profiles: List[DeschedulerProfile] = list(profiles or [])
        self._anomaly: Dict[str, Tuple[AnomalyState, List[str]]] = {}
        # the PodMigrationJob ledger: pod key -> {"phase", "reason", "from",
        # "to"}; bounded history
        self.jobs: Dict[str, dict] = {}
        self.job_ttl: float = 300.0  # PMJ TTL (controller abort on expiry)
        # in-flight migration jobs: pod key -> {"stage", "entry", "from",
        # "reservation", "created_at"}
        self.migrations: Dict[str, dict] = {}
        # spec.ttl stamped onto migration-created reservations
        self.reservation_ttl: Optional[float] = 300.0
        self.use_kernel = bool(use_kernel)
        self.verify = verify
        # last tick's node-utilisation percentiles by pool (use_kernel only)
        self.last_util: Optional[Dict[str, dict]] = None
        # completed migrations of the last executing tick: [{pod, from, to}]
        self.last_migrations: List[dict] = []
        self.last_split: Dict[str, float] = {}
        self.last_arbitrations = 0
        self._ledger_on = True

    @property
    def verify(self) -> bool:
        return self.arbitrator.verify

    @verify.setter
    def verify(self, on: Optional[bool]) -> None:
        """None: on for the CPU, off on the card (an explicit request runs
        it anywhere)."""
        self.arbitrator.verify = self.device.type == "cpu" if on is None else bool(on)

    @contextmanager
    def _timed(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.last_split[stage] = self.last_split.get(stage, 0.0) + time.perf_counter() - t0

    # ------------------------------------------------------------- effects

    def _apply_effect(self, ops: List[dict]) -> None:
        """Apply controller effects through the one wire-op switch
        (``admit=False``: post-admission controller forms)."""
        from koordinator_tpu_torch.service.wireops import apply_wire_ops

        apply_wire_ops(self.state, ops, admit=False)

    def _note_anomaly(self, pool: str, state: AnomalyState, names: List[str]) -> None:
        """Store one pool's detector counters as an ``anomaly`` effect, only
        on change (and never all-zero counters that were never stored);
        dry-run ticks touch nothing."""
        if not self._ledger_on:
            return
        payload = {
            "names": [str(n) for n in names],
            "anomaly": [bool(x) for x in np.asarray(state.anomaly)],
            "ab": [int(x) for x in np.asarray(state.ab)],
            "norm": [int(x) for x in np.asarray(state.norm)],
        }
        if self.state.desched_anomaly.get(pool) == payload:
            return
        if pool not in self.state.desched_anomaly and not (
                any(payload["anomaly"]) or any(payload["ab"]) or any(payload["norm"])):
            return
        self._apply_effect([{"op": "anomaly", "pool": pool, **payload}])

    def _job(self, key: str, phase: str, reason: str = "", **kw) -> None:
        if not self._ledger_on:
            return  # dry-run ticks must not fabricate PMJ history
        rec = self.jobs.pop(key, {})
        rec.update({"phase": phase, "reason": reason, **kw})
        # re-insert at the end: the bound evicts by update recency
        self.jobs[key] = rec
        if len(self.jobs) > 4096:
            for k in list(self.jobs)[: len(self.jobs) - 4096]:
                del self.jobs[k]

    def _expire_stale_jobs(self, now: float) -> None:
        """controller.go abortJobIfTimeout (:422): a job older than the TTL
        aborts, frees its budgets, and drops its reservation."""
        for key, j in list(self.arbitrator.active.items()):
            t0 = j.get("created_at")
            if t0 is not None and now - t0 > self.job_ttl:
                mj = self.migrations.pop(key, None)
                if mj is not None and self.state.reservations.consumer_of(
                        mj["reservation"]) is None:
                    self._apply_effect([{"op": "rsv_remove", "name": mj["reservation"]}])
                self.arbitrator.job_done(key)
                self._job(key, JOB_FAILED, REASON_EXPIRED)

    # ------------------------------------------------------------ snapshot

    def _pool_arrays(self, pool: PoolConfig, now: float):
        """(LNLNodeArrays, LNLPodArrays of numpy arrays, node names,
        candidate pods)."""
        st = self.state
        names = [n for n in st._nodes if pool.selector is None or pool.selector(n)]
        R = len(self.resources)
        N = max(len(names), 1)
        usage = np.zeros((N, R), dtype=np.int64)
        alloc = np.zeros((N, R), dtype=np.int64)
        unsched = np.zeros(N, dtype=bool)
        valid = np.zeros(N, dtype=bool)
        cand_pods = []  # (pod, node_idx, usage vec, removable)
        for i, name in enumerate(names):
            node = st._nodes[name]
            for j, r in enumerate(self.resources):
                alloc[i, j] = node.allocatable.get(r, 0)
            m = node.metric
            if m is None or m.node_usage is None:
                continue
            valid[i] = True
            for j, r in enumerate(self.resources):
                usage[i, j] = m.node_usage.get(r, 0)
            for ap in node.assigned_pods:
                pu = m.pods_usage.get(ap.pod.key)
                if pu is None:
                    # no metric: the requests keep the walk conservative
                    pu = ap.pod.requests
                vec = np.array([pu.get(r, 0) for r in self.resources], dtype=np.int64)
                cand_pods.append((ap.pod, i, vec, True))
        # candidacy: the defaultevictor constraints, the non-preemptible
        # knob, and the arbitrator's non-retryable expected-replicas /
        # unknown-owner reject (a pod failed every round must not soak up
        # the walk's eviction budget)
        if cand_pods:
            arb = self.arbitrator
            arrays = build_evict_arrays([c[0] for c in cand_pods], arb.args.label_selector)
            ok = evictable_mask(arrays, arb.args) & max_cost_mask(arrays)
            cand_pods = [
                (p, i, vec, bool(ok[k]) and not p.non_preemptible and arb._expected_replicas_ok(p))
                for k, (p, i, vec, _) in enumerate(cand_pods)
            ]
        Pc = _pod_bucket(len(cand_pods))
        p_node = np.zeros(Pc, dtype=np.int32)
        p_usage = np.zeros((Pc, R), dtype=np.int64)
        p_rm = np.zeros(Pc, dtype=bool)
        for k, (_, ni, vec, rm) in enumerate(cand_pods):
            p_node[k] = ni
            p_usage[k] = vec
            p_rm[k] = rm
        return (
            LNLNodeArrays(usage=usage, alloc=alloc, unschedulable=unsched, valid=valid),
            LNLPodArrays(node=p_node, usage=p_usage, removable=p_rm),
            names,
            cand_pods,
        )

    def _detector_state(self, pool: PoolConfig, names: List[str]) -> AnomalyState:
        """Per-pool detector state (numpy), remapped when the node set
        changes; a fresh process seeds it from the store's ``anomaly``
        counters."""
        prev = self._anomaly.get(pool.name)
        if prev is None:
            stored = self.state.desched_anomaly.get(pool.name)
            if stored:
                prev = (
                    AnomalyState(
                        anomaly=np.array(stored["anomaly"], dtype=bool),
                        ab=np.array(stored["ab"], dtype=np.int64),
                        norm=np.array(stored["norm"], dtype=np.int64),
                    ),
                    list(stored["names"]),
                )
        n = len(names)
        out = [np.zeros(n, dtype=bool), np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.int64)]
        if prev is None:
            return AnomalyState(*out)
        state, prev_names = prev
        idx = {nm: i for i, nm in enumerate(prev_names)}
        old = [np.asarray(a) for a in state]
        for i, nm in enumerate(names):
            j = idx.get(nm)
            if j is not None:
                for f in range(3):
                    out[f][i] = old[f][j]
        return AnomalyState(*out)

    # ----------------------------------------------------- balance kernel

    @staticmethod
    def _oracle_order(ev: np.ndarray, nodes, pods, weights) -> List[int]:
        """The host eviction order (source nodes by usage score descending,
        then each node's pods by usage score descending) of the flagged
        candidates: the verify pipeline's sort key."""
        flagged = [int(k) for k in np.flatnonzero(ev)]
        t_nodes = as_tensors(nodes)
        node_scores = usage_score(t_nodes.usage, t_nodes.alloc, weights).numpy()
        pod_scores = usage_score(torch.as_tensor(pods.usage),
                                 t_nodes.alloc[torch.as_tensor(pods.node).long()],
                                 weights).numpy()
        p_node = np.asarray(pods.node)
        flagged.sort(key=lambda k: (-node_scores[p_node[k]], int(p_node[k]), -pod_scores[k], k))
        return flagged

    def _balance_pool(self, pool: PoolConfig, state: AnomalyState, nodes, pods, low, high,
                      weights) -> Tuple[AnomalyState, List[int]]:
        """One pool's round: the ``deschedule_round`` kernel on the
        engine's device (its plain version on the CPU), the four outputs
        read back in one copy.  ``verify`` re-runs ``balance_round`` and the
        host eviction order on CPU copies and raises on any difference."""
        kw = dict(use_deviation=pool.use_deviation,
                  consecutive_abnormalities=pool.consecutive_abnormalities,
                  consecutive_normalities=pool.consecutive_normalities,
                  number_of_nodes=pool.number_of_nodes)
        with self._timed("kernel"):
            dev = self.device
            rnd = to_host(deschedule_round(
                as_tensors(state, dev), as_tensors(nodes, dev), as_tensors(pods, dev),
                torch.as_tensor(low, device=dev), torch.as_tensor(high, device=dev),
                torch.as_tensor(weights, device=dev), **kw,
            ))
        evicted, rank, util = rnd.evicted, rnd.rank, rnd.util_pct
        new_state = AnomalyState(*(np.asarray(a) for a in rnd.state))
        flagged = sorted((int(k) for k in np.flatnonzero(evicted)), key=lambda k: rank[k])
        if self.last_util is not None and np.isfinite(util).any():
            self.last_util[pool.name] = {
                "p50": [round(float(v), 3) for v in util[0]],
                "p90": [round(float(v), 3) for v in util[1]],
                "p99": [round(float(v), 3) for v in util[2]],
            }
        if self.verify:
            with self._timed("verify"):
                self._verify_round(state, nodes, pods, low, high, weights, kw, rnd, flagged)
        return new_state, flagged

    def _verify_round(self, state, nodes, pods, low, high, weights, kw, rnd, flagged) -> None:
        """The round's evictions, order and detector state against the host
        pipeline on CPU copies of its inputs; raises on a difference."""
        o_state, o_evicted, _u, _o, _s = balance_round(
            as_tensors(state), as_tensors(nodes), as_tensors(pods), torch.as_tensor(low),
            torch.as_tensor(high), torch.as_tensor(weights), **kw)
        o_evicted = o_evicted.numpy()
        ok = (np.array_equal(rnd.evicted, o_evicted)
              and flagged == self._oracle_order(o_evicted, nodes, pods, weights)
              and all(np.array_equal(a, b.numpy()) for a, b in zip(rnd.state, o_state)))
        if not ok:
            raise RuntimeError("deschedule_round diverged from the host pipeline "
                               "(balance_round + eviction order)")

    # ---------------------------------------------------------------- tick

    def tick(self, now: float, dry_run: bool = False) -> List[dict]:
        """One deschedulerOnce pass over every pool.  Returns migration plan
        entries {pod, namespace, from, to, reservation}.  ``dry_run`` plans
        without creating migration jobs: the arbitrator's active-job ledger
        is restored afterwards."""
        self.last_split, self.last_arbitrations = {}, 0
        if dry_run:
            saved_active = copy.deepcopy(self.arbitrator.active)
            self._ledger_on = False
            try:
                return self._tick(now)
            finally:
                self._ledger_on = True
                # restored even when a pool fails mid-tick: a leaked phantom
                # pending job would block its pod's migrations for good
                self.arbitrator.active = saved_active
        # completed moves of THIS executing tick, the reconcile arm's
        # leftovers included (the reply's ``migrated``)
        self.last_migrations = []
        with self._timed("execute"):
            self._expire_stale_jobs(now)
            # the migration controller's reconcile loop runs beside the
            # descheduling loop: in-flight jobs advance or abort every tick
            self.reconcile_migrations(now)
        before = set(self.arbitrator.active)
        try:
            return self._tick(now)
        except BaseException:
            # a pool failing mid-tick must not strand this round's jobs
            for k in set(self.arbitrator.active) - before:
                self.arbitrator.active.pop(k, None)
            raise

    def _tick(self, now: float) -> List[dict]:
        plan: List[dict] = []
        self.last_util = {} if self.use_kernel else None
        evicted_per_node: Dict[str, int] = {}
        evicted_per_ns: Dict[str, int] = {}
        counters = {"total": 0}
        for pool in self.pools:
            with self._timed("pool_arrays"):
                nodes, pods, names, cand = self._pool_arrays(pool, now)
            if not names or not cand:
                continue
            state = self._detector_state(pool, names)
            low = np.array([pool.low_pct.get(r, 100.0) for r in self.resources])
            high = np.array([pool.high_pct.get(r, 100.0) for r in self.resources])
            weights = np.array([pool.weights.get(r, 1) for r in self.resources], dtype=np.int64)
            state, flagged = self._balance_pool(pool, state, nodes, pods, low, high, weights)
            self._anomaly[pool.name] = (state, names)
            self._note_anomaly(pool.name, state, names)
            jobs = [{"_pod": cand[k][0], "from": names[cand[k][1]]} for k in flagged]
            plan.extend(self._admit_jobs(jobs, now, evicted_per_node, evicted_per_ns, counters))
        # the upstream plugin family through the same arbitrate -> probe ->
        # limiter pipeline; plugins get the defaultevictor verdict
        if self.profiles:
            evict_ok = self._evict_ok_predicate()
            for point in ("deschedule", "balance"):
                for profile in self.profiles:
                    jobs = []
                    for plugin in getattr(profile, point):
                        for pod, node_name in plugin(self.state, now, evict_ok):
                            jobs.append({"_pod": pod, "from": node_name})
                    plan.extend(self._admit_jobs(jobs, now, evicted_per_node, evicted_per_ns,
                                                 counters))
        elif self.plugins:
            evict_ok = self._evict_ok_predicate()
            jobs = []
            for plugin in self.plugins:
                for pod, node_name in plugin(self.state, now, evict_ok):
                    jobs.append({"_pod": pod, "from": node_name})
            plan.extend(self._admit_jobs(jobs, now, evicted_per_node, evicted_per_ns, counters))
        return plan

    def _evict_ok_predicate(self):
        """Per-pod defaultevictor verdict for plugins that separate "counts
        toward balance" from "may be evicted"."""
        arb = self.arbitrator
        cache: Dict[str, bool] = {}

        def ok(pod) -> bool:
            v = cache.get(pod.key)
            if v is None:
                arrays = build_evict_arrays([pod], arb.args.label_selector)
                v = bool((evictable_mask(arrays, arb.args) & max_cost_mask(arrays))[0])
                cache[pod.key] = v
            return v

        return ok

    def _admit_jobs(self, jobs: List[dict], now: float, evicted_per_node: Dict[str, int],
                    evicted_per_ns: Dict[str, int], counters: Dict[str, int]) -> List[dict]:
        """Arbitrate candidate jobs, probe targets reservation-first in one
        batched SCHEDULE, and apply the eviction limiter."""
        out: List[dict] = []
        self.last_arbitrations += bool(jobs)
        with self._timed("arbitrate"):
            passed, _requeued, _failed = self.arbitrator.arbitrate(jobs, now)
        specs = []
        for job in passed:
            spec = copy.copy(job["_pod"])
            spec.reservations = []
            specs.append(spec)
        sources = sorted({job["from"] for job in passed})
        probe_hosts, probe_snap = [], None
        if specs:
            with self._timed("probe"):
                probe_hosts, _, probe_snap, _ = self.engine.schedule(specs, now=now,
                                                                     exclude=sources)
        for pos, job in enumerate(passed):
            pod = job.pop("_pod")
            node_name = job["from"]
            # the eviction limiter (evictions.go Evict), in arbitrated order;
            # a capped or target-less job fails and retires
            capped = (
                (self.limits.per_node is not None
                 and evicted_per_node.get(node_name, 0) >= self.limits.per_node)
                or (self.limits.per_namespace is not None
                    and evicted_per_ns.get(pod.namespace, 0) >= self.limits.per_namespace)
                or (self.limits.total is not None and counters["total"] >= self.limits.total)
            )
            if capped or probe_hosts[pos] < 0:
                self.arbitrator.job_done(pod.key)
                self._job(pod.key, JOB_FAILED,
                          REASON_CAPPED if capped else REASON_RESERVATION_UNSCHEDULABLE,
                          **{"from": node_name})
                continue
            entry = {
                "pod": pod.key,
                "namespace": pod.namespace,
                "from": node_name,
                "to": probe_snap.names[probe_hosts[pos]],
                "reservation": f"migrate-{pod.namespace}-{pod.name}",
            }
            self._job(pod.key, JOB_PENDING, **{"from": node_name})
            evicted_per_node[node_name] = evicted_per_node.get(node_name, 0) + 1
            evicted_per_ns[pod.namespace] = evicted_per_ns.get(pod.namespace, 0) + 1
            counters["total"] += 1
            out.append(entry)
        return out

    # ------------------------------------------------------------- execute
    #
    # The migration controller (controller.go:241 doMigrate), reservation
    # first: create the AllocateOnce reservation, wait for it to schedule,
    # abort when it goes missing / expires / stays unschedulable / is bound
    # by another pod, and evict the source pod only once the target is held.

    def execute(self, plan: List[dict], now: float) -> int:
        """Apply a migration plan in-store: start every job, then reconcile
        until all are terminal.  A failed re-schedule rolls the pod back to
        its source and drops the reservation.  Returns the number of
        completed migrations."""
        try:
            with self._timed("execute"):
                self.start_migrations(plan, now)
                done = 0
                for _ in range(3):  # pending -> wait -> terminal
                    if not self.migrations:
                        break
                    done += self.reconcile_migrations(now)
                return done
        except BaseException:
            # abort every in-flight job (dropping unconsumed reservations)
            for entry in plan:
                mj = self.migrations.get(entry["pod"])
                if mj is not None:
                    self._abort_migration(entry["pod"], mj, REASON_INTERRUPTED)
                else:
                    self.arbitrator.job_done(entry["pod"])
            raise

    def start_migrations(self, plan: List[dict], now: float) -> None:
        """Admit plan entries into the migration machine (the PMJ create)."""
        for entry in plan:
            self.migrations[entry["pod"]] = {
                "stage": "pending",
                "entry": entry,
                "from": entry["from"],
                "reservation": entry["reservation"],
                "created_at": now,
            }

    def _abort_migration(self, key: str, mj: dict, reason: str) -> None:
        self.migrations.pop(key, None)
        # drop the job's own reservation unless another pod now owns it
        if reason != REASON_RESERVATION_BOUND_BY_OTHER:
            info = self.state.reservations.get(mj["reservation"])
            if info is not None and self.state.reservations.consumer_of(
                    mj["reservation"]) is None:
                self._apply_effect([{"op": "rsv_remove", "name": mj["reservation"]}])
        self.arbitrator.job_done(key)
        self._job(key, JOB_FAILED, reason, **{"from": mj["from"]})

    def _find_pod_on(self, key: str, node_name: str):
        st = self.state
        if st._pod_node.get(key) != node_name:
            return None
        for ap in st._nodes[node_name].assigned_pods:
            if ap.pod.key == key:
                return ap.pod
        return None

    def reconcile_migrations(self, now: float) -> int:
        """One reconcile pass over in-flight jobs; returns how many
        completed."""
        return sum(self._reconcile_one(key, mj, now) for key, mj in list(self.migrations.items()))

    def _reconcile_one(self, key: str, mj: dict, now: float) -> int:
        """One job's reconcile step; 1 when its migration completed."""
        from koordinator_tpu_torch.service import protocol as proto
        from koordinator_tpu_torch.service.constraints import ReservationInfo

        st = self.state
        if mj["stage"] == "pending":
            # preparePendingJob + createReservation (controller.go:275)
            pod = self._find_pod_on(key, mj["from"])
            if pod is None:
                self._abort_migration(key, mj, REASON_POD_CHANGED)
                return 0
            self._job(key, JOB_RUNNING, **{"from": mj["from"]})
            spec = copy.copy(pod)
            spec.reservations = []
            hosts, _, snap, _ = self.engine.schedule([spec], now=now, exclude=[mj["from"]])
            alloc = {r: v for r, v in pod.requests.items() if r in st.axis or r in self.resources}
            if hosts[0] < 0:
                # the reserve pod cannot schedule: Unschedulable on the CR;
                # the abort arm fires at the next reconcile
                info = ReservationInfo(
                    name=mj["reservation"], node=None, allocatable=alloc, allocate_once=True,
                    create_time=now, ttl=self.reservation_ttl, unschedulable_count=1,
                    last_error="reserve pod unschedulable",
                )
            else:
                info = ReservationInfo(
                    name=mj["reservation"], node=snap.names[hosts[0]], allocatable=alloc,
                    allocate_once=True, create_time=now, ttl=self.reservation_ttl,
                )
            self._apply_effect([{"op": "rsv", "r": proto.reservation_to_wire(info)}])
            mj["stage"] = "wait"
            return 0
        # stage == "wait": observe the reservation's live state
        info = st.reservations.get(mj["reservation"])
        if info is None:
            self._abort_migration(key, mj, REASON_RESERVATION_MISSING)
            return 0
        if info.is_expired(now):
            self._abort_migration(key, mj, REASON_RESERVATION_EXPIRED)
            return 0
        consumer = st.reservations.consumer_of(mj["reservation"])
        if consumer is not None and consumer != key:
            self._abort_migration(key, mj, REASON_RESERVATION_BOUND_BY_OTHER)
            return 0
        if info.node is None:
            self._abort_migration(key, mj, REASON_RESERVATION_UNSCHEDULABLE)
            return 0
        target = info.node
        pod = self._find_pod_on(key, mj["from"])
        if pod is None:
            self._abort_migration(key, mj, REASON_POD_CHANGED)
            return 0
        # target held: evict the source pod and bind it into the
        # reservation; a failing bind rolls the pod back onto its source
        self._apply_effect([{"op": "unassign", "key": key}])
        rollback_op = {"op": "assign", "node": mj["from"], "pod": proto.pod_to_wire(pod),
                       "t": now}
        try:
            spec = copy.copy(pod)
            spec.reservations = [mj["reservation"]]
            hosts, _, snap2, _ = self.engine.schedule([spec], now=now, assume=True,
                                                      exclude=[mj["from"]])
        except BaseException:
            self._apply_effect([rollback_op])
            raise
        landed = snap2.names[hosts[0]] if hosts[0] >= 0 else None
        self.migrations.pop(key, None)
        if landed == target:
            mj["entry"]["to"] = target
            # the eviction happened: retire the job, scavenge the consumed
            # AllocateOnce reservation, feed the workload rate limiter
            self._apply_effect([{"op": "rsv_retire", "name": mj["reservation"]}])
            self.arbitrator.job_done(key, evicted_pod=pod, now=now)
            self._job(key, JOB_SUCCEEDED, to=target)
            self.last_migrations.append({"pod": key, "from": mj["from"], "to": target})
            return 1
        # the pod lands on the reserved target or does not move at all
        ops = []
        if landed is not None:
            ops.append({"op": "unassign", "key": key})
        ops.append({"op": "rsv_remove", "name": mj["reservation"]})
        ops.append(rollback_op)
        self._apply_effect(ops)
        self.arbitrator.job_done(key)
        self._job(key, JOB_FAILED, REASON_RESERVATION_BOUND_BY_OTHER)
        return 0
