"""Scalar transliterations of the descheduler safety-layer Go logic —
bit-match test oracles only (SURVEY §7 golden extraction), mirroring:

- the upstream defaultevictor constraint walk reached through
  pkg/descheduler/framework/plugins/kubernetes/defaultevictor/evictor.go:110;
- utils/sorter/pod.go:161-174 PodSorter comparator chain (OrderedBy
  ascending, helper.go:74-90 Less);
- arbitrator/sort.go SortJobsByCreationTime / SortJobsByPod /
  SortJobsByController / SortJobsByMigratingNum as sequential stable sorts.

Operates on `api.model.Pod` objects directly (the same inputs the kernels
densify) via per-pair comparator functions and Python's stable ``sorted``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

from koordinator_tpu_torch.api.model import Pod, priority_class_of
from koordinator_tpu_torch.core.evictor import (
    EvictorArgs,
    KOORD_PRIORITY_ORDER,
    KOORD_QOS_ORDER,
    MAX_EVICTION_COST,
    SYSTEM_CRITICAL_PRIORITY,
    kube_qos_class,
)


def golden_evictable(pod: Pod, args: EvictorArgs) -> bool:
    """One pod through the defaultevictor constraint list (scalar)."""
    if pod.is_mirror or pod.is_terminating:
        return False
    if pod.evict_annotation:
        return True
    has_owner = pod.owner_uid is not None or pod.is_daemonset
    if not has_owner and not (args.evict_failed_bare_pods and pod.is_failed):
        return False
    if pod.is_daemonset or pod.owner_kind == "DaemonSet":
        return False
    if not args.evict_system_critical_pods:
        prio = pod.priority or 0
        if prio >= SYSTEM_CRITICAL_PRIORITY:
            return False
        if args.priority_threshold is not None and prio >= args.priority_threshold:
            return False
    if not args.evict_local_storage_pods and pod.has_local_storage:
        return False
    if args.ignore_pvc_pods and pod.has_pvc:
        return False
    if args.label_selector is not None and not all(
        pod.labels.get(k) == v for k, v in args.label_selector.items()
    ):
        return False
    return True


def golden_max_cost_ok(pod: Pod) -> bool:
    return pod.eviction_cost != MAX_EVICTION_COST


# ------------------------------------------------------------- comparators


def _cmp(v1, v2) -> int:
    return (v1 > v2) - (v1 < v2)


def cmp_koord_priority_class(p1: Pod, p2: Pod) -> int:
    return _cmp(
        KOORD_PRIORITY_ORDER[priority_class_of(p1)],
        KOORD_PRIORITY_ORDER[priority_class_of(p2)],
    )


def cmp_priority(p1: Pod, p2: Pod) -> int:
    return _cmp(p1.priority or 0, p2.priority or 0)


def cmp_k8s_qos(p1: Pod, p2: Pod) -> int:
    return _cmp(kube_qos_class(p1), kube_qos_class(p2))


def cmp_koord_qos(p1: Pod, p2: Pod) -> int:
    return _cmp(KOORD_QOS_ORDER.get(p1.qos, 5), KOORD_QOS_ORDER.get(p2.qos, 5))


def cmp_deletion_cost(p1: Pod, p2: Pod) -> int:
    return _cmp(p1.deletion_cost, p2.deletion_cost)


def cmp_eviction_cost(p1: Pod, p2: Pod) -> int:
    return _cmp(p1.eviction_cost, p2.eviction_cost)


def cmp_creation(p1: Pod, p2: Pod) -> int:
    # pod.go:127-135: the OLDER pod ranks greater (evicted later)
    return -_cmp(p1.create_time, p2.create_time)


POD_COMPARATORS = (
    cmp_koord_priority_class,
    cmp_priority,
    cmp_k8s_qos,
    cmp_koord_qos,
    cmp_deletion_cost,
    cmp_eviction_cost,
    cmp_creation,
)


def golden_pod_order(
    pods: Sequence[Pod], usage: Optional[Dict[int, float]] = None
) -> List[int]:
    """PodSorter(...).Sort index order, ascending (eviction order).  The
    trailing original-index key pins full ties (Go's sort.Sort is unstable
    there; any permutation of a full tie is a legal reference outcome)."""

    def chain(i: int, j: int) -> int:
        for k, cmp in enumerate(POD_COMPARATORS):
            if usage is not None and cmp is cmp_creation:
                # SortPodsByUsage inserts Reverse(PodUsage) before creation
                c = -_cmp(usage.get(i, 0.0), usage.get(j, 0.0))
                if c != 0:
                    return c
            c = cmp(pods[i], pods[j])
            if c != 0:
                return c
        return _cmp(i, j)

    return sorted(range(len(pods)), key=functools.cmp_to_key(chain))


def golden_job_order(
    pods: Sequence[Pod],
    job_pod: Sequence[int],
    job_create_time: Sequence[float],
    migrating_per_owner: Optional[Dict[str, int]] = None,
) -> List[int]:
    """The arbitrator's four SortFns applied in order, each a stable sort
    (arbitrator.go:84-89 + sort.go)."""
    order = list(range(len(job_pod)))
    # 1. SortJobsByCreationTime: newest first
    order = sorted(order, key=lambda j: -job_create_time[j])
    # 2. SortJobsByPod: rank by pod-sorter position
    pod_rank = {p: r for r, p in enumerate(golden_pod_order(pods))}
    order = sorted(order, key=lambda j: pod_rank[job_pod[j]])
    # 3. SortJobsByController ("Job" owners adjacent at best rank)
    best: Dict[str, int] = {}
    rank3 = {}
    for pos, j in enumerate(order):
        pod = pods[job_pod[j]]
        if pod.owner_kind == "Job" and pod.owner_uid is not None:
            rank3[j] = best.setdefault(pod.owner_uid, pos)
        else:
            rank3[j] = pos
    order = sorted(order, key=lambda j: rank3[j])
    # 4. SortJobsByMigratingNum: more migrating in the same Job first
    def migrating(j: int) -> int:
        pod = pods[job_pod[j]]
        if pod.owner_kind != "Job" or pod.owner_uid is None:
            return 0
        return (migrating_per_owner or {}).get(pod.owner_uid, 0)

    order = sorted(order, key=lambda j: -migrating(j))
    return order
