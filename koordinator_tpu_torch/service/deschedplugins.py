"""The upstream-descheduler plugin family.

The reference registers ten sigs.k8s.io/descheduler v0.26 plugins plus its
own defaultevictor into the koord-descheduler framework
(pkg/descheduler/framework/plugins/kubernetes/plugin.go:63-127);
the plugin *implementations* live in the external dependency (go.mod:62
``sigs.k8s.io/descheduler v0.26.0``), so what follows is a from-scratch
restatement of each plugin's documented v0.26 semantics over this
framework's ``ClusterState`` — not a translation of any vendored source.

Protocol: every plugin is a callable ``plugin(state, now=0.0, evict_ok=None)
-> List[(Pod, node_name)]`` producing eviction candidates in the plugin's
own eviction order.  ``evict_ok(pod) -> bool`` is the handle.Evictor().Filter
equivalent (the defaultevictor mask the Descheduler builds from its
arbitrator args); plugins that must distinguish "counts toward skew /
duplicates" from "may actually be evicted" consult it, everything else
leaves final filtering to the shared arbitrate -> probe -> limiter pipeline
(service/descheduler.py:_admit_jobs).

Deschedule plugins (run every tick, stateless):
- PodLifeTime              — age > maxPodLifeTimeSeconds, optional state match
- RemoveFailedPods         — phase == Failed, reason/owner-kind/min-age gates
- RemovePodsHavingTooManyRestarts — restart sum >= threshold

Balance plugins (cluster-shape driven):
- RemoveDuplicates         — > ceil(total/feasible-nodes) replicas of one
                             owner on a node
- RemovePodsViolatingTopologySpreadConstraint — two-pointer domain balance
- HighNodeUtilization      — drain request-underutilized nodes (bin-pack)
- LowNodeUtilization       — shed request-overutilized nodes toward targets

High/LowNodeUtilization are the *request-based* upstream pair; the
usage-based koordinator LowNodeLoad (NodeMetric-driven, anomaly debounce)
is `core/lownodeload.py` and runs as the pool walk, exactly as the
reference runs both families side by side.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from koordinator_tpu_torch.api.model import CPU, PODS, Node, Pod

EvictOk = Optional[Callable[[Pod], bool]]


def _always(_pod: Pod) -> bool:
    return True


def _matches_selector(labels: Dict[str, str], sel: Optional[Dict[str, str]]) -> bool:
    if not sel:
        return True
    return all(labels.get(k) == v for k, v in sel.items())


def _ns_allowed(ns: str, include: Sequence[str], exclude: Sequence[str]) -> bool:
    """Upstream Namespaces{Include,Exclude} (mutually exclusive by
    validation; include wins when both set here)."""
    if include:
        return ns in include
    if exclude:
        return ns not in exclude
    return True


def _sort_pods_low_priority_first(pods: List[Tuple[Pod, str]]) -> None:
    """podutil.SortPodsBasedOnPriorityLowToHigh: no-priority pods first,
    then ascending priority; BestEffort (no requests) before others at
    equal priority.  Stable key keeps ties deterministic by create time
    then name."""
    pods.sort(
        key=lambda e: (
            e[0].priority is not None,
            e[0].priority or 0,
            bool(e[0].requests),
            e[0].create_time,
            e[0].key,
        )
    )


# --------------------------------------------------------------------------
# Deschedule plugins
# --------------------------------------------------------------------------


@dataclass
class PodLifeTimeArgs:
    """podlifetime.PodLifeTimeArgs: maxPodLifeTimeSeconds is required;
    ``states`` matches pod phase OR any container waiting/terminated
    reason (Pending, CrashLoopBackOff, ...)."""

    max_pod_life_time_seconds: float = 86400.0
    states: Tuple[str, ...] = ()
    label_selector: Optional[Dict[str, str]] = None
    namespaces_include: Tuple[str, ...] = ()
    namespaces_exclude: Tuple[str, ...] = ()


class PodLifeTime:
    """Evict pods older than the configured lifetime, oldest first
    (upstream sorts candidates by age before handing to the evictor)."""

    name = "PodLifeTime"

    def __init__(self, args: Optional[PodLifeTimeArgs] = None):
        self.args = args or PodLifeTimeArgs()

    def _state_match(self, pod: Pod) -> bool:
        st = self.args.states
        if not st:
            return True
        if pod.phase in st:
            return True
        return any(r in st for r in pod.status_reasons)

    def __call__(self, state, now: float = 0.0, evict_ok: EvictOk = None):
        a = self.args
        out: List[Tuple[Pod, str]] = []
        for name, node in state._nodes.items():
            for ap in node.assigned_pods:
                pod = ap.pod
                if now - pod.create_time <= a.max_pod_life_time_seconds:
                    continue
                if not _ns_allowed(
                    pod.namespace, a.namespaces_include, a.namespaces_exclude
                ):
                    continue
                if not _matches_selector(pod.labels, a.label_selector):
                    continue
                if not self._state_match(pod):
                    continue
                out.append((pod, name))
        out.sort(key=lambda e: (e[0].create_time, e[0].key))  # oldest first
        return out


@dataclass
class RemoveFailedPodsArgs:
    """removefailedpods.RemoveFailedPodsArgs."""

    exclude_owner_kinds: Tuple[str, ...] = ()
    reasons: Tuple[str, ...] = ()
    including_init_containers: bool = False
    min_pod_lifetime_seconds: Optional[float] = None
    label_selector: Optional[Dict[str, str]] = None
    namespaces_include: Tuple[str, ...] = ()
    namespaces_exclude: Tuple[str, ...] = ()


class RemoveFailedPods:
    """Evict Failed-phase pods, optionally gated on failure reason
    (pod status reason or container terminated/waiting reasons,
    init containers included only when the flag says so), owner kind
    and minimum age.  Oldest first."""

    name = "RemoveFailedPods"

    def __init__(self, args: Optional[RemoveFailedPodsArgs] = None):
        self.args = args or RemoveFailedPodsArgs()

    def _reason_match(self, pod: Pod) -> bool:
        if not self.args.reasons:
            return True
        reasons = list(pod.status_reasons)
        if self.args.including_init_containers:
            reasons += list(pod.init_status_reasons)
        return any(r in self.args.reasons for r in reasons)

    def __call__(self, state, now: float = 0.0, evict_ok: EvictOk = None):
        a = self.args
        out: List[Tuple[Pod, str]] = []
        for name, node in state._nodes.items():
            for ap in node.assigned_pods:
                pod = ap.pod
                if pod.phase != "Failed" and not pod.is_failed:
                    continue
                if not _ns_allowed(
                    pod.namespace, a.namespaces_include, a.namespaces_exclude
                ):
                    continue
                if not _matches_selector(pod.labels, a.label_selector):
                    continue
                if (
                    a.min_pod_lifetime_seconds is not None
                    and now - pod.create_time < a.min_pod_lifetime_seconds
                ):
                    continue
                if pod.owner_kind and pod.owner_kind in a.exclude_owner_kinds:
                    continue
                if not self._reason_match(pod):
                    continue
                out.append((pod, name))
        out.sort(key=lambda e: (e[0].create_time, e[0].key))
        return out


@dataclass
class RemovePodsHavingTooManyRestartsArgs:
    """removepodshavingtoomanyrestarts.RemovePodsHavingTooManyRestartsArgs."""

    pod_restart_threshold: int = 100
    including_init_containers: bool = False
    label_selector: Optional[Dict[str, str]] = None
    namespaces_include: Tuple[str, ...] = ()
    namespaces_exclude: Tuple[str, ...] = ()


class RemovePodsHavingTooManyRestarts:
    """Evict pods whose summed container restart count reaches the
    threshold (init containers counted only when the flag says so)."""

    name = "RemovePodsHavingTooManyRestarts"

    def __init__(self, args: Optional[RemovePodsHavingTooManyRestartsArgs] = None):
        self.args = args or RemovePodsHavingTooManyRestartsArgs()

    def __call__(self, state, now: float = 0.0, evict_ok: EvictOk = None):
        a = self.args
        out: List[Tuple[int, Pod, str]] = []
        for name, node in state._nodes.items():
            for ap in node.assigned_pods:
                pod = ap.pod
                restarts = pod.restart_count
                if a.including_init_containers:
                    restarts += pod.init_restart_count
                if restarts < a.pod_restart_threshold:
                    continue
                if not _ns_allowed(
                    pod.namespace, a.namespaces_include, a.namespaces_exclude
                ):
                    continue
                if not _matches_selector(pod.labels, a.label_selector):
                    continue
                out.append((restarts, pod, name))
        # churniest first, by the same effective count the threshold used
        out.sort(key=lambda e: (-e[0], e[1].key))
        return [(p, n) for _, p, n in out]


# --------------------------------------------------------------------------
# Balance plugins
# --------------------------------------------------------------------------


def _pod_feasible_on(pod: Pod, node: Node) -> bool:
    """The targetNodes feasibility slice RemoveDuplicates uses: node
    schedulable, pod nodeSelector matches, NoSchedule/NoExecute taints
    tolerated (the upstream nodeFit resource check is left to the
    migration controller's reservation-first probe, which is
    authoritative here)."""
    from koordinator_tpu_torch.service.descheduler import tolerates

    if node.unschedulable:
        return False
    if pod.node_selector and not _matches_selector(node.labels, pod.node_selector):
        return False
    for t in node.taints:
        if t.get("effect") in ("NoSchedule", "NoExecute") and not tolerates(pod, t):
            return False
    return True


@dataclass
class RemoveDuplicatesArgs:
    """removeduplicates.RemoveDuplicatesArgs."""

    exclude_owner_kinds: Tuple[str, ...] = ()
    namespaces_include: Tuple[str, ...] = ()
    namespaces_exclude: Tuple[str, ...] = ()


class RemoveDuplicates:
    """One replica of a workload per node, spread-aware.

    v0.26 algorithm: pods group by duplication key (namespace, owner,
    sorted container images); per key, a node's pods beyond the first are
    duplicates.  Eviction only brings each node down to
    ``ceil(total_replicas / feasible_nodes)`` — if the cluster cannot
    spread wider (fewer than two feasible nodes), nothing is evicted.
    """

    name = "RemoveDuplicates"

    def __init__(self, args: Optional[RemoveDuplicatesArgs] = None):
        self.args = args or RemoveDuplicatesArgs()

    def _dup_key(self, pod: Pod):
        return (
            pod.namespace,
            pod.owner_kind or "",
            pod.owner_uid,
            tuple(sorted(pod.container_images)),
        )

    def __call__(self, state, now: float = 0.0, evict_ok: EvictOk = None):
        a = self.args
        # key -> node -> [pods]  (insertion-ordered; we sort per node)
        by_key: Dict[tuple, Dict[str, List[Pod]]] = {}
        rep: Dict[tuple, Pod] = {}
        for name, node in state._nodes.items():
            for ap in node.assigned_pods:
                pod = ap.pod
                if pod.owner_uid is None:
                    continue  # bare pods never duplicate
                if pod.owner_kind and pod.owner_kind in a.exclude_owner_kinds:
                    continue
                if not _ns_allowed(
                    pod.namespace, a.namespaces_include, a.namespaces_exclude
                ):
                    continue
                k = self._dup_key(pod)
                by_key.setdefault(k, {}).setdefault(name, []).append(pod)
                rep.setdefault(k, pod)
        out: List[Tuple[Pod, str]] = []
        for k, nodes_pods in sorted(by_key.items(), key=lambda e: str(e[0])):
            if not any(len(p) > 1 for p in nodes_pods.values()):
                continue
            total = sum(len(p) for p in nodes_pods.values())
            feasible = [
                n
                for n, node in state._nodes.items()
                if _pod_feasible_on(rep[k], node)
            ]
            if len(feasible) < 2:
                continue
            upper_avg = math.ceil(total / len(feasible))
            for node_name in sorted(nodes_pods):
                pods = sorted(
                    nodes_pods[node_name], key=lambda p: (p.create_time, p.key)
                )
                if len(pods) > upper_avg:
                    # keep the oldest upper_avg, evict the newer surplus
                    out.extend((p, node_name) for p in pods[upper_avg:])
        return out


@dataclass
class TopologySpreadArgs:
    """removepodsviolatingtopologyspreadconstraint args: soft
    (ScheduleAnyway) constraints join only when the flag says so."""

    include_soft_constraints: bool = False
    namespaces_include: Tuple[str, ...] = ()
    namespaces_exclude: Tuple[str, ...] = ()


class RemovePodsViolatingTopologySpreadConstraint:
    """Re-balance topology domains whose pod-count skew exceeds a
    constraint's maxSkew.

    v0.26 balanceDomains: per namespace, distinct constraints are
    collected from pods; for each constraint the pods matching its
    selector are bucketed by the nodes' topology value (every node
    carrying the topology key contributes a domain, even when empty).
    Domains sort by size ascending; a two-pointer walk moves
    ``min(ceil(skew/2), above-avg, below-avg)`` pods from the biggest to
    the smallest domain until every pair is within maxSkew.  All matching
    pods count toward skew, but only evictor-approved pods may move —
    the sort puts unevictable pods first so the moved tail is evictable
    whenever possible.
    """

    name = "RemovePodsViolatingTopologySpreadConstraint"

    def __init__(self, args: Optional[TopologySpreadArgs] = None):
        self.args = args or TopologySpreadArgs()

    def __call__(self, state, now: float = 0.0, evict_ok: EvictOk = None):
        evict_ok = evict_ok or _always
        a = self.args
        # namespace -> {constraint-key: constraint}
        constraints: Dict[str, Dict[tuple, dict]] = {}
        for node in state._nodes.values():
            for ap in node.assigned_pods:
                pod = ap.pod
                if not _ns_allowed(
                    pod.namespace, a.namespaces_include, a.namespaces_exclude
                ):
                    continue
                for c in pod.topology_spread:
                    when = c.get("when_unsatisfiable", "DoNotSchedule")
                    if when == "ScheduleAnyway" and not a.include_soft_constraints:
                        continue
                    sel = c.get("label_selector") or {}
                    key = (
                        c.get("topology_key"),
                        int(c.get("max_skew", 1)),
                        when,
                        tuple(sorted(sel.items())),
                    )
                    constraints.setdefault(pod.namespace, {})[key] = c
        out: List[Tuple[Pod, str]] = []
        chosen: set = set()
        for ns in sorted(constraints):
            for key in sorted(constraints[ns], key=str):
                topo_key, max_skew, _when, sel_items = key
                sel = dict(sel_items)
                # domain value -> [(pod, node_name)]; nodes with the key
                # but no matching pods still open a (possibly empty) domain
                domains: Dict[str, List[Tuple[Pod, str]]] = {}
                for node_name, node in state._nodes.items():
                    val = node.labels.get(topo_key)
                    if val is None:
                        continue
                    domains.setdefault(val, [])
                    for ap in node.assigned_pods:
                        pod = ap.pod
                        if pod.namespace != ns:
                            continue
                        if not _matches_selector(pod.labels, sel):
                            continue
                        domains[val].append((pod, node_name))
                if len(domains) < 2:
                    continue
                for pods in domains.values():
                    # unevictable first, then high priority, then old —
                    # the tail is what balanceDomains moves
                    pods.sort(
                        key=lambda e: (
                            evict_ok(e[0]),
                            -(e[0].priority or 0),
                            e[0].create_time,
                            e[0].key,
                        )
                    )
                sorted_domains = sorted(
                    domains.items(), key=lambda e: (len(e[1]), e[0])
                )
                ideal_avg = sum(len(p) for _, p in sorted_domains) / len(
                    sorted_domains
                )
                i, j = 0, len(sorted_domains) - 1
                while i < j:
                    low, high = sorted_domains[i][1], sorted_domains[j][1]
                    skew = len(high) - len(low)
                    if skew <= max_skew:
                        i += 1
                        continue
                    above_avg = math.ceil(len(high) - ideal_avg)
                    below_avg = math.ceil(ideal_avg - len(low))
                    move = min(above_avg, below_avg, math.ceil(skew / 2))
                    if move <= 0:
                        # the high domain reached the average: retire it and
                        # compare the next-largest (balanceDomains walks j--
                        # here; advancing i instead would strand other
                        # still-oversized domains)
                        j -= 1
                        continue
                    moved = high[len(high) - move :]
                    del high[len(high) - move :]
                    low.extend(moved)
                    for pod, node_name in moved:
                        if evict_ok(pod) and pod.key not in chosen:
                            chosen.add(pod.key)
                            out.append((pod, node_name))
        return out


# --------------------------------------------------------------------------
# Request-based node utilization pair
# --------------------------------------------------------------------------


def node_requested(node: Node, resources: Sequence[str]) -> Dict[str, int]:
    """Per-resource requested totals on a node; the synthetic ``pods``
    resource counts one per assigned pod (upstream nodeutilization
    always tracks it)."""
    out = {r: 0 for r in resources}
    for ap in node.assigned_pods:
        for r in resources:
            if r == PODS:
                out[r] += 1
            else:
                out[r] += ap.pod.requests.get(r, 0)
    return out


def _usage_pct(requested: Dict[str, int], node: Node, resources) -> Dict[str, float]:
    out = {}
    for r in resources:
        alloc = node.allocatable.get(r, 0)
        out[r] = (requested[r] * 100.0 / alloc) if alloc > 0 else 0.0
    return out


def _raw_sum(requested: Dict[str, int]) -> int:
    """sortNodesByUsage's crude raw sum (milli-cpu + bytes + count —
    upstream sums the raw quantities, a documented quirk kept here)."""
    return sum(requested.values())


@dataclass
class _UtilState:
    name: str
    node: Node
    requested: Dict[str, int]
    pct: Dict[str, float]


def _classify(state, resources) -> List[_UtilState]:
    out = []
    for name, node in state._nodes.items():
        req = node_requested(node, resources)
        out.append(_UtilState(name, node, req, _usage_pct(req, node, resources)))
    return out


def _evict_from_sources(
    sources: List[_UtilState],
    destinations: List[_UtilState],
    resources: Sequence[str],
    dest_threshold_pct: Dict[str, float],
    continue_cond: Callable[[_UtilState], bool],
    evict_ok: Callable[[Pod], bool],
    ascending: bool,
) -> List[Tuple[Pod, str]]:
    """The shared evictPodsFromSourceNodes walk: a per-resource capacity
    budget accumulated over destination nodes bounds how much the sources
    may shed; sources iterate in usage order, pods lowest-priority
    first."""
    avail = {r: 0.0 for r in resources}
    for d in destinations:
        for r in resources:
            if r not in d.node.allocatable:
                # missing allocatable entry = unlimited, the framework-wide
                # convention (snapshot/nodefit.py _UNLIMITED_PODS); a node
                # that doesn't publish a pods count must not zero the budget
                avail[r] = math.inf
                continue
            cap = d.node.allocatable[r] * dest_threshold_pct.get(r, 100.0) / 100.0
            avail[r] += max(0.0, cap - d.requested[r])
    sources = sorted(
        sources,
        key=lambda s: (_raw_sum(s.requested), s.name),
        reverse=not ascending,
    )
    out: List[Tuple[Pod, str]] = []
    for s in sources:
        pods = [(ap.pod, s.name) for ap in s.node.assigned_pods]
        _sort_pods_low_priority_first(pods)
        for pod, node_name in pods:
            if not continue_cond(s):
                break
            if any(avail[r] <= 0 for r in resources):
                return out
            if not evict_ok(pod):
                continue
            out.append((pod, node_name))
            for r in resources:
                take = 1 if r == PODS else pod.requests.get(r, 0)
                s.requested[r] -= take
                avail[r] -= take
            s.pct = _usage_pct(s.requested, s.node, resources)
    return out


@dataclass
class HighNodeUtilizationArgs:
    """nodeutilization.HighNodeUtilizationArgs: thresholds mark
    UNDER-utilization; underutilized nodes are drained so workloads
    bin-pack onto the rest."""

    thresholds: Dict[str, float] = field(default_factory=lambda: {CPU: 20.0})
    number_of_nodes: int = 0


class HighNodeUtilization:
    name = "HighNodeUtilization"

    def __init__(self, args: Optional[HighNodeUtilizationArgs] = None):
        self.args = args or HighNodeUtilizationArgs()

    def __call__(self, state, now: float = 0.0, evict_ok: EvictOk = None):
        evict_ok = evict_ok or _always
        thr = self.args.thresholds
        resources = sorted(set(thr) | {PODS})
        # resources without a configured threshold are unconstrained (100)
        full_thr = {r: thr.get(r, 100.0) for r in resources}
        infos = _classify(state, resources)
        sources = [
            s for s in infos if all(s.pct[r] < full_thr[r] for r in resources)
        ]
        source_names = {s.name for s in sources}
        dests = [
            s
            for s in infos
            if s.name not in source_names and not s.node.unschedulable
        ]
        if not sources or len(sources) == len(infos) or not dests:
            return []
        if len(sources) <= self.args.number_of_nodes:
            return []
        # destinations may fill to capacity (upstream sets the target
        # threshold to MaxResourcePercentage for this plugin)
        dest_thr = {r: 100.0 for r in resources}
        return _evict_from_sources(
            sources,
            dests,
            resources,
            dest_thr,
            # keep draining while the node remains underutilized (which
            # draining preserves): the budget or the pod list ends it
            lambda s: all(s.pct[r] < full_thr[r] for r in resources),
            evict_ok,
            ascending=True,
        )


@dataclass
class LowNodeUtilizationArgs:
    """nodeutilization.LowNodeUtilizationArgs: below ``thresholds`` on
    every resource = underutilized; above ``target_thresholds`` on any =
    overutilized; overutilized nodes shed onto the underutilized."""

    thresholds: Dict[str, float] = field(default_factory=lambda: {CPU: 20.0})
    target_thresholds: Dict[str, float] = field(default_factory=lambda: {CPU: 50.0})
    number_of_nodes: int = 0


class LowNodeUtilization:
    name = "LowNodeUtilization"

    def __init__(self, args: Optional[LowNodeUtilizationArgs] = None):
        self.args = args or LowNodeUtilizationArgs()

    def __call__(self, state, now: float = 0.0, evict_ok: EvictOk = None):
        evict_ok = evict_ok or _always
        a = self.args
        resources = sorted(set(a.thresholds) | set(a.target_thresholds) | {PODS})
        low_thr = {r: a.thresholds.get(r, 100.0) for r in resources}
        high_thr = {r: a.target_thresholds.get(r, 100.0) for r in resources}
        infos = _classify(state, resources)
        low = [
            s
            for s in infos
            if not s.node.unschedulable
            and all(s.pct[r] < low_thr[r] for r in resources)
        ]
        high = [
            s for s in infos if any(s.pct[r] > high_thr[r] for r in resources)
        ]
        if not low or len(low) == len(infos) or not high:
            return []
        if len(low) <= a.number_of_nodes:
            return []
        return _evict_from_sources(
            high,
            low,
            resources,
            # a destination absorbs up to its target threshold
            high_thr,
            # stop per node once it is no longer overutilized
            lambda s: any(s.pct[r] > high_thr[r] for r in resources),
            evict_ok,
            ascending=False,
        )
