"""Descheduler safety layer: evictability mask + arbitration ordering kernels.

The reference guards every eviction behind two stacked layers this module
re-creates tensor-first:

- the **defaultevictor filter** (upstream sigs.k8s.io/descheduler semantics
  wrapped by pkg/descheduler/framework/plugins/kubernetes/defaultevictor/
  evictor.go:106-118): a per-pod evictability predicate over ownership,
  static/mirror status, criticality, volumes, label selection;
- the **migration arbitrator** (pkg/descheduler/controllers/migration/
  arbitrator/{arbitrator,sort,filter}.go): a deterministic sort chain over
  candidate PodMigrationJobs followed by retryable/non-retryable filters that
  enforce per-node / per-namespace / per-workload migration and availability
  budgets plus a per-workload rate limiter.

Where the Go code runs one comparator chain per pair inside sort.Sort and one
client List per filter call, this module computes a dense attribute matrix
once per round and answers every question with numpy reductions:
``np.lexsort`` for the full multi-key pod order, segment counts over owner /
node / namespace ids for the budgets.  The scalar semantics are restated in
``golden/evictor_ref.py`` and the two are property-tested against each other
on random clusters (tests/test_evictor.py).

Quantities follow api/model.py conventions (milli-cores / bytes, int64).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.api.model import Pod, PriorityClass, priority_class_of

# math.MaxInt32 sentinel: "never evict me" (migration/util/util.go:115-119).
MAX_EVICTION_COST = (1 << 31) - 1

# k8s SystemCriticalPriority (scheduling/types.go): 2e9.
SYSTEM_CRITICAL_PRIORITY = 2_000_000_000

# utils/sorter/pod.go:31-37 koordPriorityClassOrder — higher = more important.
KOORD_PRIORITY_ORDER = {
    PriorityClass.NONE: 5,
    PriorityClass.PROD: 4,
    PriorityClass.MID: 3,
    PriorityClass.BATCH: 2,
    PriorityClass.FREE: 1,
}

# utils/sorter/pod.go:39-45 koordQoSClassOrder.
KOORD_QOS_ORDER = {
    None: 5,
    "": 5,
    "SYSTEM": 4,
    "LSE": 4,
    "LSR": 3,
    "LS": 2,
    "BE": 1,
}

# utils/sorter/pod.go:47-51 k8sQoSClassOrder.
K8S_QOS_GUARANTEED = 3
K8S_QOS_BURSTABLE = 2
K8S_QOS_BESTEFFORT = 1


def kube_qos_class(pod: Pod) -> int:
    """k8s QOSClass from the pod-level aggregate requests/limits.

    The reference computes this per container (util.GetKubeQosClass →
    v1qos.GetPodQOS); our Pod model carries pod-level aggregates, so the
    classification runs on those: BestEffort when nothing is requested,
    Guaranteed when cpu+memory limits exist and equal requests, else
    Burstable.  The golden oracle uses the same definition, keeping the
    vector/scalar pair bit-comparable.
    """
    req = {k: v for k, v in pod.requests.items() if v}
    lim = {k: v for k, v in pod.limits.items() if v}
    if not req and not lim:
        return K8S_QOS_BESTEFFORT
    if (
        "cpu" in lim
        and "memory" in lim
        and req.get("cpu", 0) == lim["cpu"]
        and req.get("memory", 0) == lim["memory"]
    ):
        return K8S_QOS_GUARANTEED
    return K8S_QOS_BURSTABLE


@dataclass
class EvictorArgs:
    """DefaultEvictorArgs + the MigrationControllerArgs the filters consume.

    Defaults mirror the reference's conservative zero values
    (descheduler/apis/config/types.go MigrationControllerArgs +
    upstream DefaultEvictorArgs): nothing critical/bare/static is evictable,
    budgets unlimited when None.
    """

    evict_system_critical_pods: bool = False
    evict_local_storage_pods: bool = False
    evict_failed_bare_pods: bool = False
    ignore_pvc_pods: bool = False
    priority_threshold: Optional[int] = None
    label_selector: Optional[Dict[str, str]] = None
    # arbitrator budgets (filter.go:218-392)
    max_migrating_per_node: Optional[int] = None
    max_migrating_per_namespace: Optional[int] = None
    # int (absolute) or str "N%" (floored percentage), like intstr
    max_migrating_per_workload: Optional[object] = None
    max_unavailable_per_workload: Optional[object] = None
    skip_check_expected_replicas: bool = False
    # object limiter (filter.go:424-457): workload token bucket over duration
    object_limiter_duration: float = 0.0
    object_limiter_max_migrating: Optional[object] = None


def scaled_value(int_or_percent, total: int, round_up: bool = False) -> int:
    """intstr.GetScaledValueFromIntOrPercent — "35%" of total (floored by
    default) or the plain int."""
    if isinstance(int_or_percent, str):
        pct = float(int_or_percent.rstrip("%"))
        v = pct * total / 100.0
        return int(np.ceil(v)) if round_up else int(v)
    return int(int_or_percent)


def max_unavailable(replicas: int, int_or_percent) -> int:
    """migration/util/util.go:80-113 GetMaxUnavailable/GetMaxMigrating.

    Explicit value scaled against replicas; a zero result falls back to the
    sliding default (10% above 10 replicas, 2 for 4..10, else 1), capped at
    replicas.
    """
    v = 0
    if int_or_percent is not None:
        v = scaled_value(int_or_percent, replicas)
    if v == 0:
        if replicas > 10:
            v = scaled_value("10%", replicas)
        elif 4 <= replicas <= 10:
            v = 2
        else:
            v = 1
    return min(v, replicas)


# ------------------------------------------------------------------ arrays


@dataclass
class PodEvictArrays:
    """Dense per-pod attribute matrix the mask and sort kernels consume.

    Integer id columns (node/namespace/owner) are dense indexes into the
    parallel name lists so budget counts become bincounts.
    """

    pods: List[Pod]
    koord_prio_rank: np.ndarray  # [P] int8
    priority: np.ndarray  # [P] int64 (0 when unset, like corev1 PodPriority)
    k8s_qos_rank: np.ndarray  # [P] int8
    koord_qos_rank: np.ndarray  # [P] int8
    deletion_cost: np.ndarray  # [P] int64
    eviction_cost: np.ndarray  # [P] int64
    create_time: np.ndarray  # [P] float64
    has_owner: np.ndarray  # [P] bool
    owner_is_daemonset: np.ndarray  # [P] bool
    is_static: np.ndarray  # [P] bool (mirror/static)
    is_terminating: np.ndarray  # [P] bool
    is_failed: np.ndarray  # [P] bool
    has_local_storage: np.ndarray  # [P] bool
    has_pvc: np.ndarray  # [P] bool
    label_match: np.ndarray  # [P] bool (True when no selector)
    evict_annotation: np.ndarray  # [P] bool
    owner_id: np.ndarray  # [P] int32, -1 = no owner
    owner_uids: List[str] = field(default_factory=list)


def build_evict_arrays(
    pods: Sequence[Pod], label_selector: Optional[Dict[str, str]] = None
) -> PodEvictArrays:
    P = len(pods)
    a = PodEvictArrays(
        pods=list(pods),
        koord_prio_rank=np.zeros(P, dtype=np.int8),
        priority=np.zeros(P, dtype=np.int64),
        k8s_qos_rank=np.zeros(P, dtype=np.int8),
        koord_qos_rank=np.zeros(P, dtype=np.int8),
        deletion_cost=np.zeros(P, dtype=np.int64),
        eviction_cost=np.zeros(P, dtype=np.int64),
        create_time=np.zeros(P, dtype=np.float64),
        has_owner=np.zeros(P, dtype=bool),
        owner_is_daemonset=np.zeros(P, dtype=bool),
        is_static=np.zeros(P, dtype=bool),
        is_terminating=np.zeros(P, dtype=bool),
        is_failed=np.zeros(P, dtype=bool),
        has_local_storage=np.zeros(P, dtype=bool),
        has_pvc=np.zeros(P, dtype=bool),
        label_match=np.zeros(P, dtype=bool),
        evict_annotation=np.zeros(P, dtype=bool),
        owner_id=np.full(P, -1, dtype=np.int32),
    )
    owner_index: Dict[str, int] = {}
    for i, p in enumerate(pods):
        a.koord_prio_rank[i] = KOORD_PRIORITY_ORDER[priority_class_of(p)]
        a.priority[i] = p.priority or 0
        a.k8s_qos_rank[i] = kube_qos_class(p)
        a.koord_qos_rank[i] = KOORD_QOS_ORDER.get(p.qos, 5)
        a.deletion_cost[i] = p.deletion_cost
        a.eviction_cost[i] = p.eviction_cost
        a.create_time[i] = p.create_time
        a.has_owner[i] = p.owner_uid is not None or p.is_daemonset
        a.owner_is_daemonset[i] = p.is_daemonset or p.owner_kind == "DaemonSet"
        a.is_static[i] = p.is_mirror
        a.is_terminating[i] = p.is_terminating
        a.is_failed[i] = p.is_failed
        a.has_local_storage[i] = p.has_local_storage
        a.has_pvc[i] = p.has_pvc
        a.label_match[i] = label_selector is None or all(
            p.labels.get(k) == v for k, v in label_selector.items()
        )
        a.evict_annotation[i] = p.evict_annotation
        if p.owner_uid is not None:
            oid = owner_index.setdefault(p.owner_uid, len(owner_index))
            a.owner_id[i] = oid
    a.owner_uids = list(owner_index)
    return a


# -------------------------------------------------------------------- mask


def evictable_mask(a: PodEvictArrays, args: EvictorArgs) -> np.ndarray:
    """Vectorized defaultevictor.Filter (upstream IsEvictable constraints,
    reached through evictor.go:110-112).

    A pod is NOT evictable when any of the following holds, unless it carries
    the evict annotation (which bypasses every check but the static/
    terminating ones — evictions.HaveEvictAnnotation short-circuits the
    constraint walk in upstream ListPodsOnANode usage):

    - no controller owner and not (failed && EvictFailedBarePods);
    - owned by a DaemonSet;
    - a mirror/static pod;
    - already terminating;
    - system-critical priority (>= 2e9) or >= PriorityThreshold, without
      EvictSystemCriticalPods;
    - local-storage volumes without EvictLocalStoragePods;
    - PVC volumes with IgnorePvcPods;
    - label selector present and not matching.
    """
    bare_ok = a.is_failed if args.evict_failed_bare_pods else np.zeros(
        len(a.pods), dtype=bool
    )
    not_evictable = (~a.has_owner & ~bare_ok) | a.owner_is_daemonset
    if not args.evict_system_critical_pods:
        not_evictable |= a.priority >= SYSTEM_CRITICAL_PRIORITY
        if args.priority_threshold is not None:
            not_evictable |= a.priority >= args.priority_threshold
    if not args.evict_local_storage_pods:
        not_evictable |= a.has_local_storage
    if args.ignore_pvc_pods:
        not_evictable |= a.has_pvc
    not_evictable |= ~a.label_match
    # annotation bypass — but never for static/terminating pods
    not_evictable &= ~a.evict_annotation
    not_evictable |= a.is_static | a.is_terminating
    return ~not_evictable


def max_cost_mask(a: PodEvictArrays) -> np.ndarray:
    """FilterPodWithMaxEvictionCost (util.go:115-119): cost == MaxInt32 is a
    hard opt-out that even the evict annotation does not bypass (it is wired
    as a non-retryable filter ahead of defaultevictor, filter.go:118-122)."""
    return a.eviction_cost != MAX_EVICTION_COST


# -------------------------------------------------------------------- sort


def pod_sort_order(
    a: PodEvictArrays, usage_score: Optional[np.ndarray] = None
) -> np.ndarray:
    """utils/sorter/pod.go:161-174 PodSorter as one lexsort.

    Ascending = least-important-first (the eviction order).  Comparator
    chain, most significant first: koord priority class rank, priority,
    k8s QoS rank, koord QoS rank, deletion cost, eviction cost, [usage
    descending when given — SortPodsByUsage's Reverse(PodUsage)], creation
    timestamp (younger first: PodCreationTimestamp ranks older pods
    greater).  Go's sort.Sort is unstable on full ties; the trailing index
    key makes this one deterministic, which is a superset of legal
    reference outcomes.
    """
    P = len(a.pods)
    keys = [np.arange(P), -a.create_time]
    if usage_score is not None:
        keys.append(-np.asarray(usage_score))
    keys += [
        a.eviction_cost,
        a.deletion_cost,
        a.koord_qos_rank,
        a.k8s_qos_rank,
        a.priority,
        a.koord_prio_rank,
    ]
    return np.lexsort(tuple(keys))


def job_sort_order(
    a: PodEvictArrays,
    job_pod: np.ndarray,
    job_create_time: np.ndarray,
    migrating_per_owner: Optional[Dict[str, int]] = None,
    pod_order: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The arbitrator's SortFn chain (arbitrator.go:84-89) over candidate
    jobs, as successive stable sorts (each mirrors one SortFn):

    1. SortJobsByCreationTime — newest job first;
    2. SortJobsByPod — rank by the pod sorter's position;
    3. SortJobsByController — every job of a "Job"-kind owner moves up to
       the group's best-ranked member (stable within group);
    4. SortJobsByMigratingNum — owners with more already-migrating jobs
       first (counts include this round's candidates plus
       ``migrating_per_owner`` carry-in).

    ``job_pod`` maps job -> pod row in ``a``; returns the job order.
    ``pod_order`` optionally supplies the stage-2 pod-sorter permutation
    (the ``core.deschedule.pod_band_rank`` kernel — bit-equal
    to ``pod_sort_order`` by its verify gate); None computes it here.
    """
    J = len(job_pod)
    order = np.arange(J)

    def stable_by(rank: np.ndarray) -> None:
        nonlocal order
        order = order[np.argsort(rank[order], kind="stable")]

    # 1. newest first (sort.go:71-78, Less = created later)
    stable_by(-job_create_time)
    # 2. pod sorter position (sort.go:41-68)
    if pod_order is None:
        pod_order = pod_sort_order(a)
    pod_rank_of = np.empty(len(a.pods), dtype=np.int64)
    pod_rank_of[np.asarray(pod_order)] = np.arange(len(a.pods))
    stable_by(pod_rank_of[job_pod])
    # 3. controller grouping, "Job" owners only (sort.go:108-130)
    is_job_owner = np.array(
        [a.pods[p].owner_kind == "Job" and a.owner_id[p] >= 0 for p in job_pod]
    )
    group_rank = np.empty(J, dtype=np.int64)
    best_of_owner: Dict[int, int] = {}
    for pos, j in enumerate(order):
        if is_job_owner[j]:
            oid = int(a.owner_id[job_pod[j]])
            group_rank[j] = best_of_owner.setdefault(oid, pos)
        else:
            group_rank[j] = pos
    stable_by(group_rank)
    # 4. migrating-count descending (sort.go:81-105)
    counts = np.zeros(J, dtype=np.int64)
    if migrating_per_owner:
        for j in range(J):
            p = job_pod[j]
            if is_job_owner[j]:
                counts[j] = migrating_per_owner.get(a.pods[p].owner_uid or "", 0)
    stable_by(-counts)
    return order


# ------------------------------------------------------------ rate limiter


class ObjectLimiter:
    """filter.go:415-479 per-workload token bucket (golang.org/x/time/rate
    semantics, burst 1): refill rate = maxMigrating(replicas)/duration.

    ``track`` consumes a token when a pod of the workload is actually
    evicted; ``allow`` answers filterLimitedObject — False while the bucket
    lacks a full token.  Entries expire after 1.5× duration of inactivity
    like the reference's limiterCache.
    """

    def __init__(self, duration: float, max_migrating, default_max_migrating):
        self.duration = float(duration)
        self.max_migrating = (
            max_migrating if max_migrating is not None else default_max_migrating
        )
        # owner_uid -> (tokens, last_update, rate, last_touch)
        self._buckets: Dict[str, List[float]] = {}

    def _refill(self, b: List[float], now: float) -> None:
        tokens, last, rate = b[0], b[1], b[2]
        b[0] = min(1.0, tokens + (now - last) * rate)
        b[1] = now

    def track(self, owner_uid: str, replicas: int, now: float) -> None:
        if self.duration <= 0:
            return
        mm = max_unavailable(replicas, self.max_migrating)
        if mm == 0:
            return
        rate = mm / self.duration
        b = self._buckets.get(owner_uid)
        if b is None:
            b = [1.0, now, rate, now]
            self._buckets[owner_uid] = b
        b[2] = rate
        self._refill(b, now)
        if b[0] >= 1.0:  # rate.AllowN consumes only when a token is available
            b[0] -= 1.0
        b[3] = now

    def allow(self, owner_uid: Optional[str], now: float) -> bool:
        if self.duration <= 0 or owner_uid is None:
            return True
        self._expire(now)
        b = self._buckets.get(owner_uid)
        if b is None:
            return True
        self._refill(b, now)
        return b[0] - 1.0 >= 0

    def _expire(self, now: float) -> None:
        ttl = self.duration * 1.5
        dead = [k for k, b in self._buckets.items() if now - b[3] > ttl]
        for k in dead:
            del self._buckets[k]
