"""Server-side cross-cycle constraint state: gangs, the quota tree, and
reservations.

The round-2 sidecar served only the 2-plugin subset (LoadAware + NodeFit);
gang specs, the quota tree and reservations entered the kernels solely from
test/bench fixtures.  These stores give that state a home in the sidecar so
the FULL pipeline rides the wire (SURVEY §7's service shape), with the
cross-cycle semantics the Go plugins keep in their caches:

- ``GangStore`` — the gangCache slice the batch kernels need
  (coscheduling/core/gang.go:43-100): minMember, member counts, gang
  groups, match policy, the irreversible OnceResourceSatisfied bit
  (gang.go:455-463), and bound children per gang (credited toward Permit
  satisfaction under the waiting-and-running policy, gang.go:488-495).
  The scheduleCycle bookkeeping (gang.go:71-100) exists in Go because pods
  re-enter the queue one at a time; a batch IS one schedule cycle per gang,
  so a failed gang retries by being resubmitted in the next batch.

- ``QuotaStore`` — GroupQuotaManager state (elasticquota/core): the group
  tree with webhook topology invariants enforced at ingestion
  (pkg/webhook/elasticquota/quota_topology_check.go — malformed trees are
  rejected before they can poison a waterfill), per-group used/non-
  preemptible-used maintained incrementally from pod assign/unassign
  deltas keyed by pod (so the shim's authoritative post-bind event and the
  sidecar's own schedule-time assume cannot double count), and the runtime
  refresh (used as the PreFilter limit) recomputed when the tree or its
  requests change.

- ``ReservationStore`` — the reservation cache + AllocateOnce lifecycle
  (reservation/plugin.go:64-72, transformer.go:103-116): available
  reservations become dense rows; owner matching stays in the Go shim
  (label/ownerRef string work — pods arrive with their matched reservation
  names), consumption is tracked per pod so unassign releases it, and an
  allocate-once reservation leaves the available set on first consumption.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from koordinator_tpu_torch.api.model import Pod
from koordinator_tpu_torch.api.quota import ROOT_QUOTA, QuotaGroup
from koordinator_tpu_torch.core.gang import GangArrays, GangPodArrays
from koordinator_tpu_torch.core.quota import QuotaPodArrays
from koordinator_tpu_torch.core.reservation import ReservationArrays
from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot

# gang modes / match policies (apis/extension/coscheduling constants)
GANG_MODE_STRICT = "StrictMode"
GANG_MODE_NON_STRICT = "NonStrictMode"
MATCH_ONCE_SATISFIED = "once-satisfied"
MATCH_ONLY_WAITING = "only-waiting"
MATCH_WAITING_AND_RUNNING = "waiting-and-running"


@dataclass
class GangInfo:
    name: str
    min_member: int
    total_children: int = 0  # known created child pods (informer count)
    mode: str = GANG_MODE_STRICT
    match_policy: str = MATCH_ONCE_SATISFIED
    gang_group: Tuple[str, ...] = ()  # group ids; () = itself
    create_time: float = 0.0
    once_satisfied: bool = False  # irreversible (gang.go:459-461)
    bound: Set[str] = field(default_factory=set)  # bound child pod keys


class GangStore:
    def __init__(self):
        self._gangs: Dict[str, GangInfo] = {}
        self._pod_gang: Dict[str, str] = {}  # bound pod key -> gang
        # content version: bumped by every mutator — a cheap cache key for
        # engine-side batch caches (EXPLAIN decomposition).  Never
        # serialized and never compared across processes; it only promises
        # "unchanged version => unchanged store content" WITHIN one.
        self.version = 0

    def upsert(self, info: GangInfo) -> None:
        self.version += 1
        if info.mode not in (GANG_MODE_STRICT, GANG_MODE_NON_STRICT):
            # unknown modes silently fall back to strict (gang.go:134-137)
            info.mode = GANG_MODE_STRICT
        prev = self._gangs.get(info.name)
        if prev is not None:
            # live state survives a spec update
            info.once_satisfied = info.once_satisfied or prev.once_satisfied
            info.bound = prev.bound
        self._gangs[info.name] = info

    def remove(self, name: str) -> None:
        self.version += 1
        info = self._gangs.pop(name, None)
        if info:
            for key in info.bound:
                self._pod_gang.pop(key, None)

    def get(self, name: str) -> Optional[GangInfo]:
        return self._gangs.get(name)

    def note_assign(self, pod_key: str, gang_name: str) -> None:
        info = self._gangs.get(gang_name)
        if info is not None and pod_key not in info.bound:
            self.version += 1
            info.bound.add(pod_key)
            self._pod_gang[pod_key] = gang_name

    def note_unassign(self, pod_key: str) -> None:
        gang_name = self._pod_gang.pop(pod_key, None)
        if gang_name and gang_name in self._gangs:
            self.version += 1
            self._gangs[gang_name].bound.discard(pod_key)

    def mark_satisfied(self, names: Sequence[str]) -> None:
        """setResourceSatisfied for gangs whose group passed Permit."""
        for n in names:
            info = self._gangs.get(n)
            if info is not None:
                self.version += 1
                info.once_satisfied = True

    def build(
        self, pods: List[Pod], gang_of: List[Optional[str]], p_bucket: int
    ) -> Tuple[GangPodArrays, GangArrays, List[str]]:
        """Dense rows for every gang referenced by the batch plus all other
        members of their gang groups (their satisfaction gates the commit,
        core/core.go:330-345).  Returns (pod arrays [p_bucket], gang arrays,
        row->name)."""
        names: List[str] = []
        row: Dict[str, int] = {}

        def add(name: str) -> int:
            if name not in row:
                row[name] = len(names) + 1  # row 0 = sentinel
                names.append(name)
            return row[name]

        for g in gang_of:
            if g:
                # unknown gang names (pod event racing ahead of the gang
                # spec) still get a dense row — marked uninitialized below,
                # so gang_prefilter rejects their pods the way the reference
                # fails PreFilter for a missing gang (core/core.go:232)
                # instead of scheduling them ganglessly via the sentinel
                add(g)
                if g in self._gangs:
                    for member in self._gangs[g].gang_group:
                        if member in self._gangs:
                            add(member)

        G = 1 + len(names)
        min_member = np.zeros(G, dtype=np.int64)
        member_count = np.zeros(G, dtype=np.int64)
        has_init = np.ones(G, dtype=bool)
        once = np.zeros(G, dtype=bool)
        group = np.zeros(G, dtype=np.int32)
        bound = np.zeros(G, dtype=np.int64)
        non_strict = np.zeros(G, dtype=bool)
        group_row: Dict[Tuple[str, ...], int] = {}
        for name in names:
            i = row[name]
            info = self._gangs.get(name)
            if info is None:
                has_init[i] = False
                # belt over suspenders: should a pod of an uninitialized
                # gang ever place, the unreachable minMember revokes it
                min_member[i] = 1 << 60
                group[i] = i
                continue
            min_member[i] = info.min_member
            member_count[i] = max(info.total_children, len(info.bound))
            once[i] = (
                info.match_policy == MATCH_ONCE_SATISFIED and info.once_satisfied
            )
            non_strict[i] = info.mode == GANG_MODE_NON_STRICT
            if info.match_policy == MATCH_WAITING_AND_RUNNING or non_strict[i]:
                # waiting-and-running credits bound children; a non-strict
                # gang's assumed survivors of earlier cycles are literally
                # "waiting at Permit" (PostFilter never rolled them back),
                # so they count toward the quorum under every match policy
                bound[i] = len(info.bound)
            gg = info.gang_group or (name,)
            key = tuple(sorted(gg))
            group[i] = group_row.setdefault(key, i)

        P = len(pods)
        gang_rows = np.zeros(p_bucket, dtype=np.int32)
        prio = np.full(p_bucket, -(1 << 60), dtype=np.int64)  # padding sorts last
        sub = np.zeros(p_bucket, dtype=np.int64)
        ts = np.full(p_bucket, np.inf, dtype=np.float64)
        for i, (p, g) in enumerate(zip(pods, gang_of)):
            info = self._gangs.get(g) if g else None
            gang_rows[i] = row.get(g, 0) if g else 0
            prio[i] = p.priority or 0
            sub[i] = getattr(p, "sub_priority", 0) or 0
            ts[i] = info.create_time if info else getattr(p, "create_time", 0.0)
        return (
            GangPodArrays(
                gang=gang_rows, priority=prio, sub_priority=sub, timestamp=ts
            ),
            GangArrays(
                min_member=min_member,
                member_count=member_count,
                has_init=has_init,
                once_satisfied=once,
                group=group,
                bound_count=bound,
                non_strict=non_strict,
            ),
            names,
        )


class QuotaValidationError(ValueError):
    """A quota upsert violating the webhook topology invariants."""


class QuotaStore:
    def __init__(self, resources: Sequence[str] = ("cpu", "memory")):
        self.resources = list(resources)
        self._groups: Dict[str, QuotaGroup] = {}
        self._children: Dict[str, Set[str]] = {}
        self._used: Dict[str, np.ndarray] = {}  # own (leaf) used per group
        self._npu: Dict[str, np.ndarray] = {}
        self._pod_quota: Dict[str, Tuple[str, np.ndarray, bool]] = {}
        # consumption racing ahead of its group's upsert (pod informer vs
        # ElasticQuota CR informer have no cross-ordering) — buffered and
        # replayed, mirroring ClusterState._pending_assigns
        self._pending_consume: Dict[str, List[Tuple[Pod, bool]]] = {}
        # QuotaOverUsedGroupMonitor debounce: when each group last sat at or
        # under its runtime (quota_overuse_revoke.go:61-90)
        self._last_under: Dict[str, float] = {}
        self._dirty_tree = True
        self._snapshot: Optional[QuotaSnapshot] = None
        self.cluster_total: Dict[str, int] = {}
        # content version (see GangStore.version): bumped whenever the
        # tree, the total, or any used/npu aggregate changes — the key the
        # engine's quota-runtime cache invalidates on
        self.version = 0

    def __len__(self):
        return len(self._groups)

    # --------------------------------------------------------- validation

    def _validate(self, g: QuotaGroup) -> None:
        """quota_topology_check.go invariants, enforced at the wire:
        non-negative min/max/weight, min <= max (validateQuotaSelfItem:38-66),
        existing parent with isParent (checkParentQuotaInfo), identical max
        key-sets down an inner tree (checkSubAndParentGroupMaxQuotaKeySame),
        sibling/child min sums bounded by the parent min
        (checkMinQuotaValidate:215-258), guarantee <= min
        (checkGuaranteedForMin), and no parent cycles."""
        for rl, what in ((g.min, "min"), (g.max, "max"), (g.guarantee, "guarantee")):
            for r, v in rl.items():
                if v < 0:
                    raise QuotaValidationError(f"{g.name}: negative {what}[{r}]")
        if g.shared_weight is not None:
            for r, v in g.shared_weight.items():
                if v < 0:
                    raise QuotaValidationError(f"{g.name}: negative weight[{r}]")
        for r, v in g.min.items():
            if r not in g.max or g.max[r] < v:
                raise QuotaValidationError(f"{g.name}: min[{r}]={v} > max")
        for r, v in g.guarantee.items():
            if g.min.get(r, 0) < v:
                raise QuotaValidationError(f"{g.name}: guarantee[{r}]={v} > min")
        if g.parent != ROOT_QUOTA:
            parent = self._groups.get(g.parent)
            if parent is None:
                raise QuotaValidationError(f"{g.name}: parent {g.parent} not found")
            if not parent.is_parent:
                raise QuotaValidationError(
                    f"{g.name}: parent {g.parent} has isParent=false"
                )
            # no cycles: walking up from the parent must not revisit g
            seen, cur = {g.name}, g.parent
            while cur != ROOT_QUOTA:
                if cur in seen:
                    raise QuotaValidationError(f"{g.name}: parent cycle via {cur}")
                seen.add(cur)
                cur = self._groups[cur].parent if cur in self._groups else ROOT_QUOTA
            if set(parent.max) != set(g.max):
                raise QuotaValidationError(
                    f"{g.name}: max key-set differs from parent {g.parent}"
                )
            # sibling min sum <= parent min
            for r in parent.min:
                sib = sum(
                    self._groups[c].min.get(r, 0)
                    for c in self._children.get(g.parent, ())
                    if c != g.name
                )
                if sib + g.min.get(r, 0) > parent.min[r]:
                    raise QuotaValidationError(
                        f"{g.name}: sibling min sum exceeds parent min[{r}]"
                    )
        # children min sum <= own min
        for r in g.min:
            kids = sum(
                self._groups[c].min.get(r, 0) for c in self._children.get(g.name, ())
            )
            if kids > g.min[r]:
                raise QuotaValidationError(
                    f"{g.name}: children min sum exceeds min[{r}]"
                )

    # ------------------------------------------------------------- deltas

    def upsert(self, g: QuotaGroup) -> None:
        self._validate(g)
        self.version += 1
        prev = self._groups.get(g.name)
        if prev is not None and prev.parent != g.parent:
            self._children.get(prev.parent, set()).discard(g.name)
        self._groups[g.name] = g
        self._children.setdefault(g.parent, set()).add(g.name)
        self._used.setdefault(g.name, np.zeros(len(self.resources), dtype=np.int64))
        self._npu.setdefault(g.name, np.zeros(len(self.resources), dtype=np.int64))
        self._dirty_tree = True
        for pod, npu in self._pending_consume.pop(g.name, ()):
            self.consume(pod, g.name, npu)

    def remove(self, name: str) -> None:
        if self._children.get(name):
            raise QuotaValidationError(f"{name}: has children, remove them first")
        self.version += 1
        g = self._groups.pop(name, None)
        if g is not None:
            self._children.get(g.parent, set()).discard(name)
            self._used.pop(name, None)
            self._npu.pop(name, None)
            self._dirty_tree = True

    def set_total(self, total: Dict[str, int]) -> None:
        self.version += 1
        self.cluster_total = dict(total)
        self._dirty_tree = True

    def _req_vec(self, pod: Pod) -> np.ndarray:
        return np.array(
            [pod.requests.get(r, 0) for r in self.resources], dtype=np.int64
        )

    def consume(self, pod: Pod, quota_name: str, non_preemptible: bool) -> None:
        """updateGroupDeltaUsedNoLock, keyed by pod so replays are no-ops."""
        if pod.key in self._pod_quota:
            return
        if quota_name not in self._groups:
            self._pending_consume.setdefault(quota_name, []).append(
                (pod, non_preemptible)
            )
            return
        req = self._req_vec(pod)
        self.version += 1
        self._pod_quota[pod.key] = (quota_name, req, non_preemptible)
        self._used[quota_name] += req
        if non_preemptible:
            self._npu[quota_name] += req

    def release(self, pod_key: str) -> None:
        entry = self._pod_quota.pop(pod_key, None)
        if entry is None:
            for waiting in self._pending_consume.values():
                waiting[:] = [(p, n) for p, n in waiting if p.key != pod_key]
            return
        quota_name, req, npu = entry
        if quota_name in self._used:
            self.version += 1
            self._used[quota_name] -= req
            if npu:
                self._npu[quota_name] -= req

    # ------------------------------------------------------------ publish

    def snapshot(self) -> QuotaSnapshot:
        if self._dirty_tree or self._snapshot is None:
            groups = []
            for g in self._groups.values():
                groups.append(g)
            self._snapshot = QuotaSnapshot(groups, self.resources)
            self._dirty_tree = False
        return self._snapshot

    def request_arrays(
        self, qs: QuotaSnapshot, batch: Optional[Dict[str, np.ndarray]] = None
    ) -> np.ndarray:
        """[Q, R] per-group OWN request (leaf pod demand) for the runtime
        refresh: the group spec's pod_requests (demand outside the sidecar's
        view, normally empty) + tracked assigned-pod requests + the current
        pending batch.  The reference accrues request from pod events
        (updateGroupDeltaRequestNoLock); assigned + pending is exactly the
        pod set the sidecar sees."""
        Q = 1 + len(qs.groups)
        req = np.zeros((Q, len(self.resources)), dtype=np.int64)
        for g in self._groups.values():
            i = qs.index.get(g.name)
            if i:
                req[i] = [g.pod_requests.get(r, 0) for r in self.resources]
        for name, vec in self._used.items():
            i = qs.index.get(name)
            if i:
                req[i] += vec
        for name, vec in (batch or {}).items():
            i = qs.index.get(name)
            if i:
                req[i] += vec
        return req

    def used_arrays(self, qs: QuotaSnapshot) -> Tuple[np.ndarray, np.ndarray]:
        """[Q, R] used / non-preemptible-used, aggregated up ancestor chains
        (root row 0 excluded) from the incrementally tracked leaf values."""
        Q = 1 + len(qs.groups)
        used = np.zeros((Q, len(self.resources)), dtype=np.int64)
        npu = np.zeros_like(used)
        for name, vec in self._used.items():
            i = qs.index.get(name)
            if i:
                used[i] = vec
                npu[i] = self._npu[name]
        for lvl in reversed(qs.levels):
            for i in lvl:
                p = qs.parent[i]
                if p != 0:
                    used[p] += used[i]
                    npu[p] += npu[i]
        return used, npu

    def overused_past_trigger(
        self, qs: QuotaSnapshot, runtime: np.ndarray, now: float, trigger: float
    ) -> np.ndarray:
        """[Q] bool — groups whose used has exceeded runtime continuously
        for longer than ``trigger`` seconds (the monitor's debounce,
        quota_overuse_revoke.go:61-90).  Resets the under-used timestamps
        as the Go monitor does."""
        used, _ = self.used_arrays(qs)
        over_now = np.any(used > runtime, axis=-1)
        out = np.zeros(len(over_now), dtype=bool)
        for name, i in qs.index.items():
            if i == 0:
                continue
            if not over_now[i]:
                self._last_under[name] = now
                continue
            since = self._last_under.setdefault(name, now)
            if now - since > trigger:
                out[i] = True
                self._last_under[name] = now  # the monitor rearms after firing
        return out

    def pod_arrays(
        self, pods: List[Pod], quota_of: List[Optional[str]], p_bucket: int
    ) -> QuotaPodArrays:
        qs = self.snapshot()
        R = len(self.resources)
        req = np.zeros((p_bucket, R), dtype=np.int64)
        present = np.zeros((p_bucket, R), dtype=bool)
        rows = np.zeros(p_bucket, dtype=np.int32)
        npu = np.zeros(p_bucket, dtype=bool)
        for i, (p, q) in enumerate(zip(pods, quota_of)):
            if not q or q not in qs.index:
                continue
            rows[i] = qs.index[q]
            for j, r in enumerate(self.resources):
                if r in p.requests:
                    req[i, j] = p.requests[r]
                    present[i, j] = True
            npu[i] = bool(getattr(p, "non_preemptible", False))
        return QuotaPodArrays(
            req=req, present=present, quota=rows, non_preemptible=npu
        )


@dataclass
class ReservationInfo:
    name: str
    # None = the reserve pod is still PENDING: the cycle itself schedules it
    # (reservation_handler.go synthesizes reserve pods into the queue) and
    # binds the reservation to the chosen node
    node: Optional[str]
    allocatable: Dict[str, int]
    allocated: Dict[str, int] = field(default_factory=dict)
    order: int = 0  # LabelReservationOrder; 0 = unset
    allocate_once: bool = False
    consumed_once: bool = False  # AllocateOnce reservation already claimed
    priority: int = 0  # reserve-pod priority (template spec)
    create_time: float = 0.0
    # the scheduler error-handler's status surface (frameworkext
    # eventhandlers MakeReservationErrorHandler: a reserve pod failing to
    # schedule patches Unschedulable onto the Reservation CR status)
    unschedulable_count: int = 0
    last_error: str = ""
    # spec.ttl (reservation_types.go:27-64 TTLSecondsAfterCreation): the
    # reservation expires ttl seconds after create_time; None = no expiry.
    # The migration controller's IsReservationExpired arm consumes this.
    ttl: Optional[float] = None

    def is_expired(self, now: float) -> bool:
        return self.ttl is not None and now - self.create_time > self.ttl


class ReservationStore:
    def __init__(self):
        self._rsv: Dict[str, ReservationInfo] = {}
        self._pod_alloc: Dict[str, Tuple[str, np.ndarray]] = {}
        # content version (see GangStore.version): the key the engine's
        # reservation score-row cache invalidates on
        self.version = 0
        # ``build``'s rows: name -> its allocatable and allocated over
        # ``_row_axis`` as int64 bytes, dropped by every mutator that
        # changes them (the store's mutators are their only writers)
        self._row_axis: tuple = ()
        self._rows: Dict[str, bytes] = {}

    def __len__(self):
        return len(self._rsv)

    def upsert(self, info: ReservationInfo) -> None:
        self.version += 1
        prev = self._rsv.get(info.name)
        if prev is not None:
            # locally tracked consumption survives a spec update (a full
            # authoritative resync is remove + re-add); consumed_once is
            # irreversible whichever side observed it first
            info.allocated = prev.allocated
            info.consumed_once = info.consumed_once or prev.consumed_once
        self._rsv[info.name] = info
        self._rows.pop(info.name, None)

    def remove(self, name: str) -> None:
        self.version += 1
        self._rsv.pop(name, None)
        self._rows.pop(name, None)

    def get(self, name: str) -> Optional[ReservationInfo]:
        return self._rsv.get(name)

    def available(self) -> List[ReservationInfo]:
        """transformer.go:103-116: unavailable / allocate-once-consumed /
        still-pending reservations never enter the restore."""
        return [
            r
            for r in self._rsv.values()
            if r.node is not None and not (r.allocate_once and r.consumed_once)
        ]

    def pending(self) -> List[ReservationInfo]:
        """Reservations whose reserve pod has not been scheduled yet."""
        return [r for r in self._rsv.values() if r.node is None]

    def bind(self, name: str, node: str) -> None:
        """The reserve pod landed: the reservation becomes available, and
        a stale Unschedulable status clears (the upstream error handler
        removes the condition on success)."""
        info = self._rsv.get(name)
        if info is not None:
            self.version += 1
            info.node = node
            info.unschedulable_count = 0
            info.last_error = ""

    def note_consume(
        self, pod_key: str, rsv_name: str, consume: Dict[str, int]
    ) -> None:
        """Record a pod's allocation (Reserve/PreBind path), idempotently."""
        info = self._rsv.get(rsv_name)
        if info is None or pod_key in self._pod_alloc:
            return
        self.version += 1
        self._rows.pop(rsv_name, None)
        vec = dict(consume)
        for r, v in vec.items():
            info.allocated[r] = info.allocated.get(r, 0) + v
        if info.allocate_once:
            info.consumed_once = True
        self._pod_alloc[pod_key] = (rsv_name, vec)

    def retire(self, name: str) -> None:
        """Delete a reservation AND its consumption records (the
        scavenger deleting a Succeeded/expired CR): a later reservation
        reusing the name must start fresh — ``remove`` alone would leave
        ``_pod_alloc`` pointing at the name, poisoning ``consumer_of``
        and the upsert merge for the next same-named reservation."""
        self.version += 1
        self._rsv.pop(name, None)
        self._rows.pop(name, None)
        for pod_key in [
            k for k, (n, _v) in self._pod_alloc.items() if n == name
        ]:
            del self._pod_alloc[pod_key]

    def consumer_of(self, rsv_name: str) -> Optional[str]:
        """The pod key holding an allocation against this reservation
        (reservationObj.GetBoundPod for the bound-by-other abort arm);
        None when unconsumed."""
        for pod_key, (name, _vec) in self._pod_alloc.items():
            if name == rsv_name:
                return pod_key
        return None

    def note_release(self, pod_key: str) -> None:
        entry = self._pod_alloc.pop(pod_key, None)
        if entry is None:
            return
        rsv_name, vec = entry
        info = self._rsv.get(rsv_name)
        if info is None:
            return
        self.version += 1
        self._rows.pop(rsv_name, None)
        for r, v in vec.items():
            info.allocated[r] = info.allocated.get(r, 0) - v

    def build(
        self,
        node_index,  # name -> row (ClusterState index map get)
        axis: List[str],
        rv_bucket: int,
    ) -> Tuple[ReservationArrays, List[str]]:
        """Dense rows for the available reservations on known nodes; padded
        rows point at node 0 with zero allocatable (inert: zero remain adds
        no free capacity and scoreReservation's zero-cap dims drop out)."""
        axis = tuple(axis)
        if axis != self._row_axis:
            self._row_axis, self._rows = axis, {}
        cache, R = self._rows, len(axis)
        names, nodes, orders, blobs = [], [], [], []
        for r in self.available():
            row = node_index(r.node)
            if row is None:
                continue
            blob = cache.get(r.name)
            if blob is None:
                blob = cache[r.name] = np.array(
                    [[r.allocatable.get(ax, 0) for ax in axis],
                     [r.allocated.get(ax, 0) for ax in axis]], dtype=np.int64).tobytes()
            names.append(r.name)
            nodes.append(row)
            orders.append(r.order)
            blobs.append(blob)
        Rv, n = rv_bucket, len(names)
        node = np.zeros(Rv, dtype=np.int32)
        allocatable = np.zeros((Rv, R), dtype=np.int64)
        allocated = np.zeros((Rv, R), dtype=np.int64)
        order = np.zeros(Rv, dtype=np.int64)
        if n:
            node[:n] = nodes
            order[:n] = orders
        if n and R:
            both = np.frombuffer(b"".join(blobs), dtype=np.int64).reshape(n, 2, R)
            allocatable[:n] = both[:, 0]
            allocated[:n] = both[:, 1]
        return (
            ReservationArrays(
                node=node, allocatable=allocatable, allocated=allocated, order=order
            ),
            names,
        )
