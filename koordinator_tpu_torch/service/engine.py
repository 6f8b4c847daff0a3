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
first.  So do the placement policies and devices: node selectors, hard
taints and tolerations, required anti-affinity both ways (the
``placement`` kernel), GPU and RDMA requests and cpusets under the nodes'
NUMA topology policies (``dev_feasible``, ``ds_score``, the host's exact
walk where a policy or a cpuset needs it, and the amplified-CPU score),
with the device and cpuset grants and the demotions of the allocation
replay.  All three NodeFit scoring strategies are served: LeastAllocated
through the resolved engine (warm-started), MostAllocated and
RequestedToCapacityRatio through the greedy scan (``scan`` kernel), cold
every cycle as in the JAX package, its begin-input cache still applying.
It returns what the JAX engine returns — ``(totals, feasible,
snapshot)`` and ``(hosts, scores, snapshot, allocations)`` as numpy — bit
for bit.

Shape discipline is the JAX engine's: the node axis is the store capacity
(power-of-two buckets) and the pending-pod axis is padded to a power-of-two
bucket; padded pod rows are masked infeasible and sliced off the result.

Devices: the engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, where the plain PyTorch versions run).  With no card and
no device asked for, construction raises.  A failed transfer or launch on
the card raises; nothing falls back to the host arrays.  What the port
does not carry yet raises ``NotImplementedError`` naming its slice.

The debug paths are served too: ``score_breakdown`` (the per-plugin raw
scores, the ``la_score`` and ``nf_score`` kernels over the snapshot's node
arrays) and ``explain`` (the per-pod schedule decomposition of the host
pipeline, ``golden.host_fallback``, over the live store).
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from koordinator_tpu_torch import convert
from koordinator_tpu_torch.api.model import AssignedPod, Pod
from koordinator_tpu_torch.core import placement as pl
from koordinator_tpu_torch.core import quota as quota_mod
from koordinator_tpu_torch.core import reservation as rsv_mod
from koordinator_tpu_torch.core import topologymanager as tm
from koordinator_tpu_torch.core.cycle import (
    GangInputs,
    PluginWeights,
    QuotaInputs,
    ReservationInputs,
    score_fn,
    tie_base,
)
from koordinator_tpu_torch.core.deviceshare import (
    GPU_CORE,
    GPU_MEMORY_RATIO,
    RDMA,
    allocate_joint,
    allocate_rdma_vfs,
    apply_allocation,
    deviceshare_score,
    gpu_topology_hints,
    parse_gpu_request,
)
from koordinator_tpu_torch.core.gang import GangPodArrays, queue_sort_perm
from koordinator_tpu_torch.core.loadaware import loadaware_score
from koordinator_tpu_torch.core.nodefit import (
    NodeFitNodeArrays,
    NodeFitPodArrays,
    nodefit_score,
    nodefit_score_plain,
)
from koordinator_tpu_torch.core.numa import FULL_PCPUS, amplified_cpu_score, take_cpus
from koordinator_tpu_torch.core.resolved import (
    _submission_order,
    con_inputs,
    extra_inputs,
    kernel_queue,
    schedule_fn,
    schedule_refresh,
    schedule_rounds_warm,
    warm_args,
)
from koordinator_tpu_torch.service import transformers as tf
from koordinator_tpu_torch.service.descheduler import tolerates
from koordinator_tpu_torch.service.state import (
    ClusterState,
    UploadStage,
    cpu_allocs_from,
    next_bucket,
)
from koordinator_tpu_torch.snapshot import loadaware as la_snap
from koordinator_tpu_torch.snapshot import nodefit as nf_snap
from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot

# the deviceshare plugin's resources, served by the device path, not the
# NodeFit axis
DEVICE_RESOURCES = (GPU_CORE, GPU_MEMORY_RATIO, RDMA)

# the resolved engine's packed-key score bound under the default weight
# profile, the JAX engine's _SCHED_SCORE_BOUND (service/engine.py:150):
# the host decides warm-carry eligibility exactly as the JAX kernel does
_w = PluginWeights()
SCHED_SCORE_BOUND = 100 * (_w.loadaware + _w.nodefit + _w.reservation + _w.numa + _w.nodefit)
# the extra channel's share of it: deviceshare (<= 100 * numa) and the
# amplified-CPU delta (|.| <= 100 * nodefit)
EXTRA_SCORE_BOUND = 100 * (_w.numa + _w.nodefit)
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


class _AdmittedBySig:
    """(pod index, node name) -> the Filter-time admitted NUMA set, resolved
    through the pod's request signature.  Missing == None ==
    unconstrained."""

    __slots__ = ("pod_sig", "by_sig")

    def __init__(self, pod_sig, by_sig):
        self.pod_sig = pod_sig
        self.by_sig = by_sig

    def get(self, key, default=None):
        i, name = key
        sig = self.pod_sig.get(i)
        if sig is None:
            return default
        return self.by_sig.get(sig, {}).get(name, default)

    def __bool__(self):
        return bool(self.by_sig)


class _TolView:
    """A minimal pod stand-in for ``tolerates`` (it reads only
    ``.tolerations``): the mask's pod side works from signatures."""

    __slots__ = ("tolerations",)

    def __init__(self, tolerations):
        self.tolerations = tolerations


def _mask_sig_key(p) -> tuple:
    """The placement-policy signature of a pod: everything its mask row
    depends on.  Identically constrained pods share one cached row."""
    return (
        tuple(sorted(p.node_selector.items())) if p.node_selector else None,
        tuple(tuple(sorted(t.items())) for t in p.tolerations) if p.tolerations else (),
        tuple(sorted(p.labels.items())) if p.labels else (),
        tuple(sorted(p.anti_affinity.items())) if p.anti_affinity else None,
    )


def _device_sig(p, greq, wants_cs: bool) -> tuple:
    """A device pod's request signature: (gpu request, rdma, and with a
    cpuset its cpu, bind and exclusive policies)."""
    return (greq, int(p.requests.get(RDMA, 0)),
            p.requests.get("cpu", 0) if wants_cs else None,
            p.cpu_bind_policy if wants_cs else None,
            p.cpu_exclusive_policy if wants_cs else None)


def _device_pods(pods) -> list:
    """(index, pod, gpu request, wants a cpuset) of the pods the device
    path serves: a GPU, RDMA or cpuset request."""
    out = []
    for i, p in enumerate(pods):
        greq, cs = parse_gpu_request(p.requests), p.wants_cpuset()
        if greq is not None or cs or int(p.requests.get(RDMA, 0)) > 0:
            out.append((i, p, greq, cs))
    return out


def _amped_nodes(st) -> list:
    """(name, topology) of the live nodes that amplify CPU."""
    return [(name, info) for name, info in st._topo.items()
            if info.cpu_ratio > 1.0 and st._imap.get(name) is not None]


def _grant(st, dev_state, pod, node_name: str, greq, rdma_req: int, wants_cs: bool, mask_nodes):
    """Phase A's grant for one pod on one node against the dry-run device
    state (applied there on success): (gpu, rdma, cpuset) grants within
    the admitted NUMA set ``mask_nodes`` (None = unconstrained), or None
    when the node can no longer serve the request."""
    def in_mask(devs):
        return [d for d in devs if mask_nodes is None or d.numa_node in mask_nodes]

    grant_gpu, grant_rdma, grant_cpus = [], [], []
    if greq is not None:
        joint = allocate_joint(in_mask(dev_state["gpus"].get(node_name, ())), greq[0], greq[1],
                               rdma_devices=in_mask(dev_state["rdma"].get(node_name, ())),
                               want_rdma=rdma_req > 0)
        if joint is None:
            return None
        grant_gpu, grant_rdma = joint["gpu"], joint["rdma"]
    elif rdma_req > 0:
        # a standalone RDMA request: VFs without GPUs
        vfs = allocate_rdma_vfs(in_mask(dev_state["rdma"].get(node_name, ())), rdma_req)
        if vfs is None:
            return None
        grant_rdma = vfs
    if wants_cs:
        info = st._topo.get(node_name)
        if info is None:
            return None
        taken = dev_state["cpus"].get(node_name, {})
        mrc = info.max_ref_count
        avail = [c for c in range(info.topo.num_cpus) if len(taken.get(c, ())) < mrc
                 and (mask_nodes is None or info.topo.node_of_cpu(c) in mask_nodes)]
        got = take_cpus(info.topo, avail, pod.requests.get("cpu", 0) // 1000,
                        bind_policy=pod.cpu_bind_policy or FULL_PCPUS,
                        allocated=cpu_allocs_from(taken), max_ref_count=mrc,
                        exclusive_policy=pod.cpu_exclusive_policy or "")
        if got is None:
            return None
        grant_cpus = got
    if grant_gpu:
        apply_allocation(dev_state["gpus"].get(node_name, ()), grant_gpu)
    if grant_rdma:
        by_minor = {r.minor: r for r in dev_state["rdma"].get(node_name, ())}
        for minor, vfs_n in grant_rdma:
            by_minor[minor].vfs_free -= vfs_n
    if grant_cpus:
        held = dev_state["cpus"].setdefault(node_name, {})
        for c in grant_cpus:
            held.setdefault(c, []).append(pod.cpu_exclusive_policy or "")
    return grant_gpu, grant_rdma, grant_cpus


class _DeferredSchedule:
    """An in-flight SCHEDULE: the kernels are launched, the host has not
    synchronized.  ``finish()`` is the one sync and host copy."""

    __slots__ = ("engine", "out_dev", "P", "snap", "pods", "now", "assume", "cin", "n_reserve",
                 "rscore_dev", "admitted")

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
        # pods the last SCHEDULE's allocation replay demoted, by cause
        self.last_demotions = {"anti_affinity": 0, "devices": 0}
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
        # the quota refreshes' one copy a call, and their trees' plans (the
        # admission limit's and the QUOTA_REFRESH verb's), each kept on the
        # device until its tree changes
        self._quota_upload = UploadStage()
        self._quota_stage = quota_mod.QuotaStage()
        self._quota_refresh_stage = quota_mod.QuotaStage()
        self._rsv_rows_key: Optional[tuple] = None
        self._rsv_rows_val = None
        # the reservation rows' order ranks, cached on the store's version
        # and the node-row mapping (``rsv_rank_builds`` counts their
        # builds), and the one copy a cycle's reservation inputs take
        self._rsv_rank_key: Optional[tuple] = None
        self._rsv_rank_val: Optional[np.ndarray] = None
        self.rsv_rank_builds = 0
        self._rsv_upload = UploadStage()
        self.sched_warm_enabled = True
        self.sched_warm_hits = 0
        self.sched_cold_inits = 0
        self.sched_begin_hits = 0
        self.sched_last_dirty = 0  # rows the last warm cycle refreshed
        # dirty fraction above which the cold rebuild replaces the refresh
        self._sched_warm_max_frac = 0.25
        # per-signature placement, device-feasibility and deviceshare-score
        # rows on the device, each cache valid for one (epoch, capacity)
        self._sel_rows: Dict[tuple, torch.Tensor] = {}
        self._sel_rows_key: Optional[tuple] = None
        self._dev_rows: Dict[tuple, tuple] = {}
        self._dev_rows_key: Optional[tuple] = None
        # the DeviceStages over node shards' columns (and every node's when
        # the residency is off)
        self._dev_stages: Dict[Optional[tuple], pl.DeviceStage] = {}
        self._ds_rows: Dict[tuple, torch.Tensor] = {}
        self._ds_rows_key: Optional[tuple] = None
        # (fingerprint id, signature) -> (ok, admitted NUMA set) of the exact
        # walk: valid forever, a changed node gets a new fingerprint id
        self._dev_exact_memo: Dict[tuple, tuple] = {}
        # the amplified-CPU delta: one (exact content key, [P, amped] delta)
        self._amp_cache: Optional[tuple] = None

    def _prepare(self, pods: List[Pod]) -> List[Pod]:
        for stage in (tf.BEFORE_PRE_FILTER, tf.BEFORE_FILTER, tf.BEFORE_SCORE):
            pods = self.transformers.run(stage, pods, self.state)
        check_pods_axis(self.state, pods)
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

    # ------------------------------------------ placement-policy inputs

    def _node_selector_mask(self, pods: List[Pod], p_bucket: int, cap: int):
        """[p_bucket, cap] bool on the engine's device, or None: node
        selectors, untolerated hard taints and required anti-affinity both
        ways, from the ``placement`` kernel over the store's policy rows.
        Rows are cached per pod signature and invalidated by the policy
        epoch; padded pod rows are all True.  None when nothing in the
        batch or the fleet triggers a policy."""
        st = self.state
        if not (any(p.node_selector or p.anti_affinity for p in pods) or st._tainted_nodes
                or st._aa_holder_count):
            return None
        key = (st.policy_epoch, cap)
        if self._sel_rows_key != key:
            self._sel_rows, self._sel_rows_key = {}, key
        sigs = [_mask_sig_key(p) for p in pods]
        missing = list(dict.fromkeys(s for s in sigs if s not in self._sel_rows))
        if missing:
            self._compute_mask_rows(missing)
        uniq = list(dict.fromkeys(sigs))
        slot = {s: k + 1 for k, s in enumerate(uniq)}
        rows = torch.stack([torch.ones(cap, dtype=torch.bool, device=self.device)]
                           + [self._sel_rows[s] for s in uniq])
        pick = np.zeros(p_bucket, dtype=np.int64)
        pick[: len(sigs)] = [slot[s] for s in sigs]
        return rows[convert.tensor(pick, self.device)]

    def _placement_sigs(self, sig_list: list) -> pl.PlacementSigs:
        """The ``placement`` kernel's pod side for ``sig_list``: per
        signature, the label columns of its selector pairs (a pair the
        fleet never carried is absent from the vocab and counts in
        ``sel_cnt`` only), the hard taints it does not tolerate, the holder
        selectors that select it and the assigned label sets its own
        anti-affinity selects, over the store's vocabularies."""
        st = self.state
        Mb = next_bucket(len(sig_list), 8)
        sel, tol, hold, aa = ([[] for _ in range(Mb)] for _ in range(4))
        sel_cnt = np.zeros(Mb, dtype=np.int32)
        for m, (selector, tols, labels, anti) in enumerate(sig_list):
            if selector:
                sel_cnt[m] = len(selector)
                sel[m] = [j for j in (st._label_vocab.get(pair) for pair in selector)
                          if j is not None]
            view = _TolView([dict(t) for t in tols])
            tol[m] = [j for (tk, tv, te), j in st._taint_vocab.items()
                      if not tolerates(view, {"key": tk, "value": tv, "effect": te})]
            lab = dict(labels)
            hold[m] = [j for sel_key, j in st._aa_vocab.items()
                       if all(lab.get(kk) == vv for kk, vv in sel_key)]
            if anti:
                aa[m] = [j for sig_key, j in st._sig_vocab.items()
                         if all(dict(sig_key).get(kk) == vv for kk, vv in anti)]
        return pl.PlacementSigs(*pl.csr(sel), torch.from_numpy(sel_cnt), *pl.csr(tol),
                                *pl.csr(hold), *pl.csr(aa))

    def _compute_mask_rows(self, sig_list: list, out=None, cols=None) -> None:
        """Evaluate the ``placement`` kernel for the signatures missing from
        the epoch cache.  ``out``/``cols``: the sharded engine
        (``service.sharding``) evaluates one node shard, ``cols=(lo, hi)``,
        into its own cache ``out``."""
        rows = self._policy_node_rows()
        if cols is not None:
            rows = tuple(r[cols[0]:cols[1]] for r in rows)
        mask = pl.placement(self._placement_sigs(sig_list), *rows)
        dst = self._sel_rows if out is None else out
        for m, s in enumerate(sig_list):
            dst[s] = mask[m]

    # ---------------------------------------------- resident node-side rows

    def _policy_node_rows(self) -> tuple:
        """(labels, taints, aa, sig) on the engine's device: the resident
        policy table, or with ``device_state=False`` the host rows copied."""
        st = self.state
        if st.residency.enabled:
            return st.residency.policy_rows(self.device)
        return tuple(convert.tensor(getattr(st, a), self.device) for a in st.residency._POLICY)

    def _device_node_rows(self) -> tuple:
        """(core, mem, full, vfs, alloc2, used2) on the engine's device, as
        ``_policy_node_rows`` serves the policy rows."""
        st = self.state
        if st.residency.enabled:
            return st.residency.device_rows(self.device)
        return tuple(convert.tensor(getattr(st, a), self.device) for a in st.residency._DEVICE)

    # ------------------------------------------------------ device inputs

    def _numa_device_inputs(self, pods: List[Pod], p_bucket: int, cap: int):
        """(extra_scores [p_bucket, cap] int64 | None, extra_feasible
        [p_bucket, cap] bool | None, admitted) on the engine's device — the
        NUMA and deviceshare plugins at the Score/Filter cut points:

        - joint-allocation feasibility of policy-free nodes from the
          ``dev_feasible`` kernel over the device rows;
        - nodes that need the combinatorial walk (a cpuset request, or a
          topology policy other than none) grouped by device fingerprint
          and walked once per (fingerprint, signature), memoized; the walk
          overrides the dense row on the card;
        - deviceshare's binpack score from the ``ds_score`` kernel; the
          amplified-CPU delta from the host (float64, as the reference).

        Per-signature rows are cached and invalidated by the device epoch.
        Equal to the host-loop oracle (``numa_device_inputs_host``).
        (None, None, {}) when no pod and no node needs any of it."""
        st = self.state
        relevant = _device_pods(pods)
        amped = _amped_nodes(st)
        if not relevant and not amped:
            return None, None, {}
        key = (st.device_epoch, cap)
        if self._dev_rows_key != key:
            self._dev_rows, self._dev_rows_key = {}, key
        sig_groups: Dict[tuple, list] = {}
        sig_rep: Dict[tuple, Pod] = {}
        for i, p, greq, wants_cs in relevant:
            sig = _device_sig(p, greq, wants_cs)
            sig_groups.setdefault(sig, []).append(i)
            sig_rep.setdefault(sig, p)
        missing = [s for s in sig_groups if s not in self._dev_rows]
        if missing:
            self._compute_device_rows(missing, sig_rep, cap)
        # assembly on the device: row 0 is the all-feasible row of pods the
        # device path does not serve, then one row per signature
        uniq = list(sig_groups)
        pick = np.zeros(p_bucket, dtype=np.int64)
        admitted_by_sig: Dict[tuple, dict] = {}
        pod_sig: Dict[int, tuple] = {}
        for k, sig in enumerate(uniq):
            admitted_by_sig[sig] = self._dev_rows[sig][1]
            for i in sig_groups[sig]:
                pick[i] = k + 1
                pod_sig[i] = sig
        rows = torch.stack([torch.ones(cap, dtype=torch.bool, device=self.device)]
                           + [self._dev_rows[s][0] for s in uniq])
        feas = rows[convert.tensor(pick, self.device)]
        admitted = _AdmittedBySig(pod_sig, admitted_by_sig)

        gpu_pods = [(i, greq) for i, _, greq, _ in relevant if greq is not None]
        score_rows = [torch.zeros(cap, dtype=torch.int64, device=self.device)]
        pick[:] = 0
        if gpu_pods and bool(st._dv_in_gpus.any()):
            if self._ds_rows_key != key:
                self._ds_rows, self._ds_rows_key = {}, key
            greqs = list(dict.fromkeys(g for _, g in gpu_pods))
            todo = [g for g in greqs if g not in self._ds_rows]
            if todo:
                self._compute_device_score_rows(todo, cap)
            slot = {g: k + 1 for k, g in enumerate(greqs)}
            score_rows += [self._ds_rows[g] for g in greqs]
            for i, g in gpu_pods:
                pick[i] = slot[g]
        scores = torch.stack(score_rows)[convert.tensor(pick, self.device)]
        # scoreWithAmplifiedCPUs delta on amplified nodes, every pod
        if amped and pods:
            self._amplified_scores_cached(pods, scores, amped)
        return scores, feas, admitted

    def _compute_device_rows(self, sig_list, sig_rep, cap: int, out=None, cols=None) -> None:
        """Feasibility rows for the signatures missing from the epoch cache:
        one ``dev_feasible`` launch over every node for the cpuset-free
        signatures (``_dense_device_rows``), then on the card the candidate
        mask and the exact-walk overrides (fingerprint-grouped, memoized),
        before the row is cached.
        ``out``/``cols``: one node shard's rows, ``cols=(lo, hi)``, into the
        sharded engine's cache ``out`` (the exact walks' memo is
        shard-agnostic: it keys on device fingerprints)."""
        st = self.state
        lo, hi = (0, cap) if cols is None else cols
        dst = self._dev_rows if out is None else out
        dense_sigs = [s for s in sig_list if s[2] is None]  # no cpuset
        drows: Dict[tuple, torch.Tensor] = {}
        if dense_sigs:
            dense = self._dense_device_rows(dense_sigs, cols)
            for m, sg in enumerate(dense_sigs):
                drows[sg] = dense[m]
        if len(self._dev_exact_memo) > 200_000:
            self._dev_exact_memo.clear()  # long-churn backstop
        in_gpus, in_topo, in_rdma = (st._dv_in_gpus[lo:hi], st._dv_in_topo[lo:hi],
                                     st._dv_in_rdma[lo:hi])
        exact, fp_col = st._dv_exact[lo:hi], st._dv_fp[lo:hi]
        for sig in sig_list:
            greq, rdma_req, cs_cpu, _bp, _ep = sig
            wants_cs = cs_cpu is not None
            if greq is not None:
                cand = in_gpus & in_topo if wants_cs else in_gpus
            elif rdma_req > 0 and not wants_cs:
                cand = in_rdma
            else:
                cand = in_topo
            sig_masks: dict = {}
            if wants_cs:
                row = torch.zeros(hi - lo, dtype=torch.bool, device=self.device)
                exact_cols = np.flatnonzero(cand)
            else:
                row = drows[sig] & convert.tensor(cand, self.device)
                exact_cols = np.flatnonzero(cand & exact)
            if exact_cols.size:
                uniq, inv = np.unique(fp_col[exact_cols], return_inverse=True)
                ok_by = np.zeros(uniq.size, dtype=bool)
                mask_by: list = [None] * uniq.size
                for u in range(uniq.size):
                    col = lo + int(exact_cols[int(np.argmax(inv == u))])
                    mkey = (int(uniq[u]), sig)
                    hit = self._dev_exact_memo.get(mkey)
                    if hit is None:
                        hit = _eval_device_sig_view(
                            self._device_view(st._imap._names[col], sig), sig, sig_rep[sig])
                        self._dev_exact_memo[mkey] = hit
                    ok_by[u], mask_by[u] = hit
                row[convert.tensor(exact_cols, self.device)] = convert.tensor(ok_by[inv],
                                                                              self.device)
                for k in range(exact_cols.size):
                    mn = mask_by[inv[k]]
                    if ok_by[inv[k]] and mn is not None:
                        sig_masks[st._imap._names[lo + int(exact_cols[k])]] = mn
            dst[sig] = (row, sig_masks)

    def _dense_device_rows(self, dense_sigs, cols=None) -> torch.Tensor:
        """[M, n] bool of the cpuset-free signatures over the device rows at
        ``cols``: the signatures packed into one host block, which rides in
        the ``dev_feasible`` kernel's launch parameters, through
        ``_device_stage``."""
        block = np.zeros((len(dense_sigs), pl.SIG_WORDS), dtype=np.int32)
        for m, (greq, rdma_req, _cs, _bp, _ep) in enumerate(dense_sigs):
            flags = pl.SIG_VALID
            if greq is not None:
                flags |= pl.SIG_HAS_GPU
                c, r = greq
                if c >= 100:
                    flags |= pl.SIG_IS_MULTI
                    block[m, pl.SIG_COUNT] = c // 100
                    if c % 100:
                        flags &= ~pl.SIG_VALID  # ValidateDeviceRequest
                else:
                    block[m, pl.SIG_CORE_REQ] = c
                    block[m, pl.SIG_RATIO_REQ] = r
                # the joint draw takes ONE VF whatever the count
                block[m, pl.SIG_RDMA_NEED] = 1 if rdma_req > 0 else 0
            else:
                block[m, pl.SIG_RDMA_NEED] = rdma_req
            block[m, pl.SIG_FLAGS] = flags
        return self._device_stage(cols).feasible(block)

    def _device_stage(self, cols=None) -> "pl.DeviceStage":
        """The ``DeviceStage`` over the device rows at ``cols`` (a node
        shard's ``(lo, hi)``, or every node): the residency's own for every
        node, else this engine's for ``cols``, rebound when the rows are
        replaced or moved."""
        st = self.state
        if cols is None and st.residency.enabled:
            return st.residency.device_stage(self.device)
        rows = self._device_node_rows()
        stage = self._dev_stages.get(cols)
        if stage is None:
            stage = self._dev_stages[cols] = pl.DeviceStage()
        if not stage.bound_to(rows, cols):
            stage.bind(rows, cols)
        return stage

    def _compute_device_score_rows(self, greqs, cap: int, out=None, cols=None) -> None:
        """deviceshare binpack score rows per distinct GPU request, times
        the numa weight, zero on nodes without GPUs: the requests packed
        into one host block and one ``ds_score`` launch through
        ``_device_stage`` over the device aggregates, the weight applied in
        the kernel; each request's row is a view of the one output.  A node
        without GPUs holds the aggregates (0, 0) (every writer of the device
        rows keeps it so), which score 0 with no mask.  ``cap`` columns, or
        ``out``/``cols``: one node shard's rows into the sharded engine's
        cache."""
        dst = self._ds_rows if out is None else out
        block = np.array(greqs, dtype=np.int64).reshape(-1, 2)
        ds = self._device_stage(cols).score(block, PluginWeights().numa)
        if ds.shape[1] != (cap if cols is None else cols[1] - cols[0]):
            raise ValueError(f"the device rows hold {ds.shape[1]} columns, not {cap}")
        for m, g in enumerate(greqs):
            dst[g] = ds[m]

    def _device_view(self, name: str, sig: tuple):
        """The node-local inputs the exact walk reads (live objects,
        read-only)."""
        st = self.state
        wants_cs = sig[2] is not None
        info = st._topo.get(name)
        avail = (st.available_cpus(name, info.max_ref_count)
                 if wants_cs and info is not None else [])
        allocs = st.cpu_allocs(name) if wants_cs else {}
        return (info, st._gpus.get(name, ()), st._rdma.get(name, ()), avail, allocs)

    def _amplified_scores_cached(self, pods: List[Pod], scores: torch.Tensor, amped) -> None:
        """Add the amplified-CPU delta (times the nodefit weight) into
        ``scores`` at the amplified columns; the [P, amped] delta is cached
        on the exact node rows and batch it is a function of."""
        st = self.state
        cpu_dim = st.rs.index("cpu") if "cpu" in st.rs else None
        if cpu_dim is None:
            return
        idxs, rows, allocated, ratios = _amplified_inputs(st, amped)
        nf_pods = nf_snap.build_pod_arrays(pods, st.nf_args, axis=st.axis)
        key = _amplified_delta_key(idxs, rows, allocated, ratios, nf_pods)
        cached = self._amp_cache
        if cached is None or cached[0] != key:
            delta = _amplified_delta(self._nf_static, nf_pods, rows, allocated, ratios, cpu_dim)
            self._amp_cache = (key, delta)
        else:
            delta = cached[1]
        cols = convert.tensor(np.asarray(idxs, dtype=np.int64), self.device)
        add = convert.tensor(delta * PluginWeights().nodefit, self.device)
        scores[: len(pods)].index_add_(1, cols, add)

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
        The device and amplified-CPU scores add into the totals inside the
        ``score`` kernel; the device and placement masks AND into the
        feasibility on the card, before the host copy.  Gang, quota and
        reservation fields do not enter SCORE, as in the JAX package."""
        pods = self._prepare(pods)
        now = time.time() if now is None else now
        snap = self.state.publish(now)
        cap = snap.valid.shape[0]
        p_bucket = next_bucket(max(len(pods), 1), self._pod_bucket_min)
        la_pods, nf_pods = self._pod_arrays(pods, p_bucket)
        x_scores, x_feas, _ = self._numa_device_inputs(pods, p_bucket, cap)
        la_nodes, nf_nodes, valid = self._node_inputs(snap, now)
        totals, feasible = score_fn(
            la_pods, la_nodes, self._weights, nf_pods, nf_nodes, self._nf_static, valid, x_scores
        )
        for mask in (x_feas, self._node_selector_mask(pods, p_bucket, cap)):
            if mask is not None:
                feasible = feasible & mask
        P = len(pods)
        return totals[:P].cpu().numpy(), feasible[:P].cpu().numpy(), snap

    def score_breakdown(self, pods: List[Pod], now: Optional[float] = None):
        """The per-plugin query API (frameworkext/services): ``({plugin:
        [P, cap] int64}, snapshot)``.  'loadaware' and 'nodefit' are RAW
        (un-weighted) plugin scores from the ``la_score`` and ``nf_score``
        kernels; 'extra', present only when NUMA/deviceshare inputs exist,
        is the pre-weighted channel exactly as the total adds it.  A debug
        path, as in the JAX package: it runs no transformer, recomputes the
        batch from the snapshot's node arrays and reads no resident table."""
        check_pods_axis(self.state, pods)
        now = time.time() if now is None else now
        snap = self.state.publish(now)
        p_bucket = next_bucket(max(len(pods), 1), self._pod_bucket_min)
        la_pods, nf_pods = self._pod_arrays(pods, p_bucket)
        P = len(pods)
        la = loadaware_score(la_pods, convert.la_nodes(snap.la_nodes, self.device), self._weights)
        nf = nodefit_score(nf_pods, convert.nf_nodes(snap.nf_nodes, self.device), self._nf_static)
        out = {"loadaware": la[:P].cpu().numpy(), "nodefit": nf[:P].cpu().numpy()}
        x_scores, _, _ = self._numa_device_inputs(pods, p_bucket, snap.valid.shape[0])
        if x_scores is not None:
            out["extra"] = x_scores[:P].cpu().numpy()
        return out, snap

    def explain(self, pods: List[Pod], now: Optional[float] = None) -> List[dict]:
        """The EXPLAIN verb's computation: per pod, the chosen node and total
        (equal to a SCHEDULE reply over the same state), the raw per-plugin
        components at selection time, the per-stage verdicts and a reason
        code for every infeasible node.  Runs the host pipeline
        (``golden.host_fallback.fallback_schedule_full``) over the live
        store, read-only, with this engine's transformer chain."""
        from koordinator_tpu_torch.golden.host_fallback import fallback_schedule_full

        for stage in (tf.BEFORE_PRE_FILTER, tf.BEFORE_FILTER, tf.BEFORE_SCORE):
            pods = self.transformers.run(stage, pods, self.state)
        now = time.time() if now is None else now
        sink: List[dict] = []
        fallback_schedule_full(self.state, pods, now, assume=False, explain=sink,
                               run_transformers=False)
        return sink

    # --------------------------------------------------- constraint inputs

    def _tensors(self, nt):
        return type(nt)(*(None if a is None else convert.tensor(a, self.device) for a in nt))

    def _batch_req(self, pods: List[Pod]) -> Dict[str, tuple]:
        """Per-group request vectors of a pending batch (accrued into the
        runtime refresh like the reference accrues pending pods), as
        tuples of ints in the store's resource order."""
        res = self.state.quota.resources
        acc: Dict[str, list] = {}
        for p in pods:
            if p.quota:
                vec = acc.get(p.quota)
                if vec is None:
                    vec = acc[p.quota] = [0] * len(res)
                req = p.requests
                for k, r in enumerate(res):
                    vec[k] += req.get(r, 0)
        return {name: tuple(vec) for name, vec in acc.items()}

    def _quota_limit_cached(self, qs: QuotaSnapshot, pods: List[Pod]) -> torch.Tensor:
        """The admission limit ([Q, R] runtime refresh, row 0 unlimited) on
        the device, from the ``quota_limit`` kernel, cached on (quota-store
        version, exact batch demand): a hit is bit-identical by
        construction, and a miss launches without a host sync: the
        refresh's per-group arrays go up in one copy, and the tree's plan
        is the stage's, built once a tree from the host parent rows."""
        st = self.state
        batch_req = self._batch_req(pods)
        key = (st.quota.version, tuple(sorted(batch_req.items())))
        if self._quota_limit_key == key:
            return self._quota_limit_val
        total = np.array([st.quota.cluster_total.get(r, 0) for r in st.quota.resources],
                         dtype=np.int64)
        qa = qs.arrays()._replace(own_request=st.quota.request_arrays(
            qs, {name: np.array(vec, dtype=np.int64) for name, vec in batch_req.items()}))
        *arrs, total_t = self._quota_upload.upload(tuple(qa[1:]) + (total,), self.device)
        val = quota_mod.quota_limit_fn(quota_mod.QuotaArrays(qa.parent, *arrs),
                                       qs.level_tuple(), total_t, stage=self._quota_stage)
        self._quota_limit_key, self._quota_limit_val = key, val
        return val

    def _rsv_rows_cached(self, req: np.ndarray, matched: np.ndarray, num_nodes: int, req_t,
                         matched_t, rsv_t, rank_t):
        """The reservation plugin's (rscore [P, Rv], scores [P, N]) on the
        device, from one ``rsv_rows`` launch over the uploaded tensors,
        cached on (reservation-store version, node-row mapping, exact
        request and match bytes): the rows are pure in these inputs."""
        st = self.state
        key = (st.reservations.version, st._imap.mutations, num_nodes, req.shape,
               req.tobytes(), matched.shape, matched.tobytes())
        if self._rsv_rows_key == key:
            return self._rsv_rows_val
        val = rsv_mod.rsv_rows(req_t, matched_t, num_nodes, rsv_t, rank_t) + (matched_t,)
        self._rsv_rows_key, self._rsv_rows_val = key, val
        return val

    def _rsv_ranks(self, order: np.ndarray) -> np.ndarray:
        """``order_ranks`` of the built reservation rows' order labels, [Rv]
        int64 on the host, cached on (reservation-store version, node-row
        mapping, rows): computed once a change."""
        st = self.state
        key = (st.reservations.version, st._imap.mutations, order.shape[0])
        if self._rsv_rank_key != key:
            self._rsv_rank_val = rsv_mod.order_ranks_host(order)
            self._rsv_rank_key = key
            self.rsv_rank_builds += 1
        return self._rsv_rank_val

    @staticmethod
    def _rsv_match(pods: List[Pod], rsv_names: List[str], p_bucket: int, rv_bucket: int):
        """The batch's match mask [p_bucket, rv_bucket] bool and its compact
        view (``match_index``'s layout, [p_bucket, bound] int32, ascending,
        -1 past the last)."""
        row_of = {n: i for i, n in enumerate(rsv_names)}
        hits: Dict[int, set] = {}
        for i, p in enumerate(pods):
            for rn in p.reservations:
                j = row_of.get(rn)
                if j is not None:
                    hits.setdefault(i, set()).add(j)
        most = max(map(len, hits.values()), default=0)
        matched = np.zeros((p_bucket, rv_bucket), dtype=bool)
        # the compact matched view's width: the most matches of one pod,
        # power-of-two bucketed as the JAX engine buckets it
        midx = np.full((p_bucket, next_bucket(max(most, 1), 2)), -1, dtype=np.int32)
        if hits:
            # each pod's rows ascending, at their positions within the pod:
            # one fancy assignment an array
            rows, cols, pos = [], [], []
            for i, h in hits.items():
                for k, j in enumerate(sorted(h)):
                    rows.append(i)
                    cols.append(j)
                    pos.append(k)
            matched[rows, cols] = True
            midx[rows, pos] = cols
        return matched, midx

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
                matched, midx_np = self._rsv_match(pods, rsv_names, p_bucket, rv_bucket)
                # the request, the match mask and index, the ranks and the
                # four reservation arrays: one copy into a fresh buffer
                req_t, matched_t, midx, rank, *arr = self._rsv_upload.upload(
                    (nf_req, matched, midx_np, self._rsv_ranks(rsv_arr.order)) + tuple(rsv_arr),
                    self.device)
                rsv_t = rsv_mod.ReservationArrays(*arr)
                rscore, scores, matched_t = self._rsv_rows_cached(
                    nf_req, matched, num_nodes, req_t, matched_t, rsv_t, rank)
                rsv = ReservationInputs(rsv=rsv_t, matched=matched_t, rscore=rscore,
                                        scores=scores)
                rsv_np = (rsv_arr, matched)
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
        the snapshot builders, the queue sort, the gang, quota and
        reservation builders, the device path (GPU/RDMA/cpuset signatures)
        and the placement mask (``_mask_sig_key``)."""
        return tuple(
            (
                p.name, p.namespace, tuple(sorted(p.requests.items())),
                tuple(sorted(p.limits.items())), p.priority, p.priority_class_label,
                p.qos_fallback_class, p.is_daemonset, p.sub_priority, p.create_time, p.gang,
                p.quota, p.non_preemptible, tuple(p.reservations), p.qos, p.cpu_bind_policy,
                p.cpu_exclusive_policy, parse_gpu_request(p.requests),
                int(p.requests.get(RDMA, 0)), p.wants_cpuset(), _mask_sig_key(p),
            )
            for p in pods
        )

    def schedule_begin(
        self,
        pods: List[Pod],
        now: Optional[float] = None,
        assume: bool = False,
        exclude: Optional[List[str]] = None,
        _inputs_provider=None,
    ) -> _DeferredSchedule:
        """Launch a SCHEDULE and return without waiting for the device; the
        result's ``finish()`` is the one sync and host copy.  Store
        mutations during the flight are safe (the snapshot is a copy), but
        they land before the finish-side replay reads the stores.

        ``_inputs_provider``: a sharded engine (``service.sharding``)
        substitutes the placement-and-devices inputs, assembled from its
        per-shard caches, and its layout in the warm carry's key, versions
        and dirty rows; the rest of the cycle is this engine's own."""
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
        inputs = self if _inputs_provider is None else _inputs_provider
        # begin-input cache: the pod-side assembly is a pure function of
        # the key, so a hit is bit-identical by construction
        in_key = (pods_fp, p_bucket, P, cap, st.content_key, st.warm_fence, excl,
                  inputs.sched_warm_token())
        if in_key == self._sched_inputs_key:
            (la_pods, nf_pods, excl_rows, cin, order, x_scores, extra,
             admitted) = self._sched_inputs_val
            self.sched_begin_hits += 1
        else:
            la_np, nf_np = self._pod_arrays_np(pods, p_bucket)
            la_pods = convert.la_pods(la_np, self.device)
            nf_pods = convert.nf_pods(nf_np, self.device)
            # the placement-and-devices inputs, composed on the card: the
            # device mask AND the placement mask; the values are fresh
            # tensors no later cycle writes
            x_scores, extra, admitted = inputs._numa_device_inputs(pods, p_bucket, cap)
            sel_mask = inputs._node_selector_mask(pods, p_bucket, cap)
            if sel_mask is not None:
                extra = sel_mask if extra is None else extra & sel_mask
            cin = self._constraint_inputs(pods, p_bucket, np.asarray(nf_np.req), cap)
            order = convert.tensor(cin.order, self.device)
            rows = [i for i in (st._imap.get(n) for n in excl) if i is not None]
            excl_rows = torch.tensor(rows, dtype=torch.int64, device=self.device) if rows else None
            self._sched_inputs_key = in_key
            self._sched_inputs_val = (la_pods, nf_pods, excl_rows, cin, order, x_scores, extra,
                                      admitted)
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
                     inputs.sched_warm_token())
        carry = self._sched_carry
        warm_ok = self._sched_warm_ok(cap)
        use_warm = warm_ok and carry is not None and carry["key"] == carry_key
        if use_warm:
            # rows whose stamps moved past the carry's watermarks, plus rows
            # whose metric-expiry gate flips between the two clocks
            dirty = inputs.sched_dirty_rows(carry["vers"])
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
            xin = extra_inputs(extra, x_scores, xs)
            if cin.constrained:
                con_kw = dict(con=con_inputs(xs, **self._con_args(cin)),
                              check_parent_depth=CHECK_PARENT_DEPTH,
                              ancestor_depth=ANCESTOR_DEPTH)
            node_args = (la_nodes, self._weights, q_nf, nf_nodes, self._nf_static, valid, pod_ok,
                         salts)
            # the refresh and the round loop share one check and layout of
            # their launch arguments
            args = warm_args(q_la, *node_args, con_kw.get("con"))
            if dirty.size:
                # pow2-bucketed, padded by repeating a real row (the JAX
                # engine's bucket; the kernel's plan collapses the repeats)
                idx = np.full(next_bucket(int(dirty.size), 16), dirty[0], dtype=np.int32)
                idx[: dirty.size] = dirty
                warm = schedule_refresh(warm, idx, q_la, *node_args, BLOCK_SIZE,
                                        con_kw.get("con"), xin, args)
            out = schedule_rounds_warm(warm, q_la, *node_args, COMMIT_CAP, BLOCK_SIZE, xin=xin,
                                       args=args, **con_kw)
            self.sched_warm_hits += 1
            if cin.constrained:
                hosts_q, scores_q, pre_q, rounds = out
            else:
                hosts_q, scores_q, rounds = out
                pre_q = hosts_q
            hosts, scores = _submission_order(hosts_q, scores_q, xs, p_bucket)
            precommit = _submission_order(pre_q, scores_q, xs, p_bucket)[0]
        else:
            # cold: the full build; a strategy other than LeastAllocated
            # takes the scan (0 rounds) and leaves no carry, as in the JAX
            # package
            hosts, scores, precommit, rounds, warm = schedule_fn(
                la_pods, la_nodes, self._weights, nf_pods, nf_nodes, self._nf_static, valid, P,
                order, COMMIT_CAP, BLOCK_SIZE,
                con_args=self._con_args(cin) if cin.constrained else None,
                check_parent_depth=CHECK_PARENT_DEPTH, ancestor_depth=ANCESTOR_DEPTH,
                extra_feasible=extra, extra_scores=x_scores, extra_score_bound=EXTRA_SCORE_BOUND,
            )
            self.sched_cold_inits += 1
        # the carry records the watermarks after this cycle's publish
        self._sched_carry = None
        if warm_ok and warm is not None:
            self._sched_carry = {"key": carry_key, "warm": warm,
                                 "vers": inputs.sched_versions(), "now": float(now)}
        rounds = rounds.view(-1).to(torch.int64)
        if rounds.numel() == 1:
            rounds = torch.cat([rounds, torch.zeros_like(rounds)])
        out = torch.cat([hosts[:P].to(torch.int64), scores[:P], precommit[:P].to(torch.int64),
                         rounds])
        return _DeferredSchedule(engine=self, out_dev=out, P=P, snap=snap, pods=pods, now=now,
                                 assume=assume, cin=cin, n_reserve=n_reserve,
                                 rscore_dev=None if cin.rsv is None else cin.rsv.rscore,
                                 admitted=admitted)

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
        _inputs_provider=None,
    ):
        """The greedy batch assignment in queue order, conflict-resolved,
        with every constraint the stores hold.

        Returns (hosts [P] row index or -1, scores [P] int64, snapshot,
        allocations): ``allocations[i]`` is pod i's PreBind record
        {node, reservation, consumed}, with ``devices`` {gpu, rdma} and
        ``cpuset`` grants where the pod asked for them, None for unplaced
        pods (among them those the replay demoted).  ``exclude``
        names nodes no pod may take.  ``assume=True`` applies the
        placements to the stores (node rows, quota used, reservation
        allocations, gang satisfaction) and schedules the pending
        reservations' reserve pods ahead of the batch, binding those that
        land (``last_reservations_placed``)."""
        return self.schedule_begin(pods, now=now, assume=assume, exclude=exclude,
                                   _inputs_provider=_inputs_provider).finish()

    def _finish_schedule(self, d: _DeferredSchedule):
        out = d.out_dev.cpu().numpy()  # the one sync
        P, snap, pods, cin = d.P, d.snap, d.pods, d.cin
        hosts = out[:P].astype(np.int32)
        scores = out[P:2 * P]
        precommit = out[2 * P:3 * P].astype(np.int32)
        self.last_rounds, self.last_ub_rounds = int(out[3 * P]), int(out[3 * P + 1])
        rscore = None if d.rscore_dev is None else d.rscore_dev.cpu().numpy()
        self.last_demotions = {"anti_affinity": 0, "devices": 0}
        allocations = _allocation_records(self.state, pods, hosts, precommit, cin, rscore,
                                          snap.names, d.now, d.assume, d.admitted,
                                          self.last_demotions)
        scores = np.where(hosts >= 0, scores, 0)
        if d.assume and cin.gang_names:
            _mark_satisfied_gangs(self.state, pods, hosts, cin)
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

    def quota_refresh(self, groups, resources: List[str], cluster_total: Dict[str, int]):
        """Whole-tree runtime refresh (RefreshRuntime) on the ``quota``
        kernel: (QuotaSnapshot, runtime [Q, R] numpy)."""
        qs = QuotaSnapshot(groups, resources)
        total = np.array([cluster_total.get(r, 0) for r in resources], dtype=np.int64)
        qa = qs.arrays()
        *arrs, total_t = self._quota_upload.upload(tuple(qa[1:]) + (total,), self.device)
        runtime = quota_mod.quota_fn(quota_mod.QuotaArrays(qa.parent, *arrs), qs.level_tuple(),
                                     total_t, stage=self._quota_refresh_stage)
        return qs, runtime.cpu().numpy()


# ------------------------------------------------------- PreBind replay


def _allocation_records(state, pods, hosts, precommit, cin: _Constraints, rscore, names, now,
                        assume, admitted, demotions: Dict[str, int]) -> List[Optional[dict]]:
    """Per-pod PreBind records (the JAX engine's ``_allocation_records``)
    over ``state`` and its column ``names``, in queue order; ``hosts`` is
    demoted in place and each demotion counted in ``demotions``.

    Phase A, a dry run against copies of the device state: the
    reservation nomination (nominator.go:134-190) against live
    remainders over the PRE-commit placements, so that gang-revoked
    pods still deplete what later pods saw; in-batch required
    anti-affinity both ways against the pods placed earlier in the
    queue; GPU/RDMA/cpuset grants within the Filter-time admitted NUMA
    set.  A pod whose feasibility an earlier pod consumed is demoted to
    unplaced.  Phase B: a demoted member of a strict, not once-satisfied
    gang takes its whole gang group down.  Phase C: the survivors'
    records and, with ``assume``, their store effects."""
    st = state
    P = len(pods)
    axis = st.axis
    needs_dev = any(parse_gpu_request(p.requests) is not None
                    or int(p.requests.get(RDMA, 0)) > 0 or p.wants_cpuset() for p in pods)
    dev_state = ({"gpus": copy.deepcopy(st._gpus), "rdma": copy.deepcopy(st._rdma),
                  "cpus": copy.deepcopy(st._cpus_taken)}
                 if needs_dev else {"gpus": {}, "rdma": {}, "cpus": {}})
    remains = None
    if cin.rsv_np is not None:
        rsv_arr, matched = cin.rsv_np
        remains = np.asarray(rsv_arr.allocatable) - np.asarray(rsv_arr.allocated)
        rsv_nodes, rsv_order = np.asarray(rsv_arr.node), np.asarray(rsv_arr.order)
    gang_pods, gangs = cin.gang_np
    gang_rows = np.asarray(gang_pods.gang)
    gang_group = np.asarray(gangs.group)

    plan: Dict[int, dict] = {}
    demoted: List[int] = []
    aa_active = any(p.anti_affinity for p in pods[:P])
    batch_by_node: Dict[str, List] = {}
    for idx in cin.order:
        if idx >= P or precommit[idx] < 0:
            continue
        pod, host = pods[idx], int(precommit[idx])
        node_name = names[host]
        entry: dict = {"node": node_name, "nom": None, "consume": None}
        if aa_active and hosts[idx] >= 0:
            for q in batch_by_node.get(node_name, ()):
                if (pod.anti_affinity and all(q.labels.get(k) == v
                                              for k, v in pod.anti_affinity.items())) or (
                        q.anti_affinity and all(pod.labels.get(k) == v
                                                for k, v in q.anti_affinity.items())):
                    hosts[idx] = -1
                    demoted.append(idx)
                    demotions["anti_affinity"] += 1
                    break
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
                entry["nom"], entry["consume"] = nom, consume
        greq = parse_gpu_request(pod.requests)
        rdma_req = int(pod.requests.get(RDMA, 0))
        wants_cs = pod.wants_cpuset()
        if (greq is not None or rdma_req > 0 or wants_cs) and hosts[idx] >= 0:
            grants = _grant(st, dev_state, pod, node_name, greq, rdma_req, wants_cs,
                            (admitted or {}).get((idx, node_name)))
            if grants is None:
                # the batch-start feasibility was consumed by an earlier
                # pod: Reserve fails, the pod waits for the next cycle
                hosts[idx] = -1
                demoted.append(idx)
                demotions["devices"] += 1
            else:
                entry["grants"] = grants
        if aa_active and hosts[idx] >= 0:
            batch_by_node.setdefault(node_name, []).append(pod)
        plan[idx] = entry

    # phase B: the gang-group rollback a demotion triggers
    # (coscheduling Unreserve, core/core.go:356-360)
    gang_nonstrict = (np.asarray(gangs.non_strict) if gangs.non_strict is not None
                      else np.zeros(gang_group.shape[0], dtype=bool))
    gang_once = np.asarray(gangs.once_satisfied)
    bad_groups = {gang_group[gang_rows[i]] for i in demoted
                  if gang_rows[i] > 0 and not gang_nonstrict[gang_rows[i]]
                  and not gang_once[gang_rows[i]]}
    if bad_groups:
        for i in range(P):
            if gang_rows[i] > 0 and gang_group[gang_rows[i]] in bad_groups:
                hosts[i] = -1

    # phase C: the survivors' records and store effects
    allocations: List[Optional[dict]] = [None] * P
    for idx in cin.order:
        if idx >= P or hosts[idx] < 0 or idx not in plan:
            continue
        pod, entry = pods[idx], plan[idx]
        node_name = entry["node"]
        rec = {"node": node_name, "reservation": None, "consumed": {}}
        if entry["nom"] is not None:
            rec["reservation"] = cin.rsv_names[entry["nom"]]
            rec["consumed"] = {r: int(v) for r, v in zip(axis, entry["consume"]) if v}
            if assume:
                st.reservations.note_consume(pod.key, rec["reservation"], rec["consumed"])
        grants = entry.get("grants")
        if grants is not None:
            if grants[0] or grants[1]:
                rec["devices"] = {"gpu": grants[0], "rdma": grants[1]}
            if grants[2]:
                rec["cpuset"] = grants[2]
        if assume:
            # assign first: a moved pod releases its stale device record
            # before the new grant is noted
            st.assign_pod(node_name, AssignedPod(pod=pod, assign_time=now))
            if grants is not None:
                st.note_device_alloc(pod.key, node_name, grants[0], grants[1], grants[2],
                                     cpu_excl=pod.cpu_exclusive_policy or "")
        allocations[idx] = rec
    return allocations

def _mark_satisfied_gangs(state, pods, hosts, cin: _Constraints) -> None:
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
    state.gangs.mark_satisfied(names)



# ------------------------------------------------ host-side device helpers


def _eval_device_sig_view(view, sig, p) -> tuple:
    """The reference-order combinatorial evaluation for ONE (node, request
    signature): collect hints -> Admit under the node's policy -> allocate
    against devices filtered to the admitted affinity
    (AutopilotAllocator.filterNodeDevice).  Returns (ok, admitted NUMA set
    | None).  Pure in ``view`` (topology, device lists, available CPUs, cpu
    allocs — ``Engine._device_view``)."""
    info, devs, rdma_devs, avail, allocs = view
    greq, rdma_req, cs, _bp, _ep = sig
    wants_cs = cs is not None
    ok = True
    providers = []
    if greq is not None:
        if not devs:
            ok = False
        else:
            providers.append(gpu_topology_hints(devs, greq[0], greq[1]))
    if wants_cs:
        if info is None:
            ok = False
        else:
            numa_ids = list(range(info.topo.num_nodes))
            free = {n: {"cpu": 1000 * sum(1 for c in avail if info.topo.node_of_cpu(c) == n)}
                    for n in numa_ids}
            providers.append(tm.generate_resource_hints(
                [(n, {"cpu": 1000 * info.topo.cpus_per_node}) for n in numa_ids], free,
                {"cpu": p.requests.get("cpu", 0)}))
    mask_nodes: Optional[set] = None
    if ok and info is not None and info.policy != tm.POLICY_NONE:
        best, admit = tm.merge(providers, list(range(info.topo.num_nodes)), info.policy)
        ok &= admit
        if ok and best.mask is not None:
            mask_nodes = set(tm.mask_bits(best.mask))

    def in_mask(ds):
        return [d for d in ds if mask_nodes is None or d.numa_node in mask_nodes]

    if ok and greq is not None:
        ok &= allocate_joint(in_mask(devs), greq[0], greq[1], rdma_devices=in_mask(rdma_devs),
                             want_rdma=rdma_req > 0) is not None
    elif ok and rdma_req > 0:
        # a standalone RDMA request: the node must yield the VFs
        ok &= allocate_rdma_vfs(in_mask(rdma_devs), rdma_req) is not None
    if ok and wants_cs:
        sel_cpus = [c for c in avail
                    if mask_nodes is None or info.topo.node_of_cpu(c) in mask_nodes]
        ok &= take_cpus(info.topo, sel_cpus, p.requests.get("cpu", 0) // 1000,
                        bind_policy=p.cpu_bind_policy or FULL_PCPUS, allocated=allocs,
                        max_ref_count=info.max_ref_count,
                        exclusive_policy=p.cpu_exclusive_policy or "") is not None
    return bool(ok), mask_nodes


def _amplified_inputs(state, amped):
    """(idxs, rows, allocated, ratios): the amplified nodes' nodefit rows
    (fresh numpy copies), their cpuset allocation milli-CPU and ratios."""
    st = state
    idxs = [st._imap.get(n) for n, _ in amped]
    rows = NodeFitNodeArrays(
        alloc=st._nf_alloc[idxs], requested=st._nf_requested[idxs],
        num_pods=st._nf_num_pods[idxs], allowed_pods=st._nf_allowed[idxs],
        alloc_score=st._nf_alloc_score[idxs], req_score=st._nf_req_score[idxs],
    )
    allocated = np.array([1000 * len(st._cpus_taken.get(n, ())) for n, _ in amped],
                         dtype=np.int64)
    ratios = np.array([info.cpu_ratio for _, info in amped])
    return idxs, rows, allocated, ratios


def _amplified_delta_key(idxs, rows, allocated, ratios, nf_pods) -> tuple:
    """Exact content key of the delta matrix: equal key, equal delta."""
    return (
        tuple(idxs), tuple(np.asarray(a).tobytes() for a in rows), allocated.tobytes(),
        ratios.tobytes(), np.asarray(nf_pods.req).tobytes(),
        np.asarray(nf_pods.req_score).tobytes(), np.asarray(nf_pods.has_any_request).tobytes(),
    )


def _amplified_delta(nf_static, nf_pods, rows, allocated, ratios, cpu_dim) -> np.ndarray:
    """[P, amped] int64 score delta, amplified minus plain nodefit, on the
    host in float64 (``core.numa.amplified_cpu_score``)."""
    t = lambda nt: type(nt)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in nt))  # noqa: E731
    pods, nodes = t(NodeFitPodArrays(*nf_pods)), t(rows)
    amped = amplified_cpu_score(pods, nodes, nf_static, cpu_dim, torch.from_numpy(allocated),
                                torch.from_numpy(ratios))
    return (amped - nodefit_score_plain(pods, nodes, nf_static)).numpy()


def _apply_amplified_scores(state, nf_static, pods, scores: np.ndarray, amped) -> None:
    """scoreWithAmplifiedCPUs (scoring.go:99-118): the amplified score
    replaces the nodefit score on amplified nodes, so the delta carries
    nodefit's weight.  Adds into the host ``scores`` in place."""
    cpu_dim = state.rs.index("cpu") if "cpu" in state.rs else None
    if cpu_dim is None:
        return
    idxs, rows, allocated, ratios = _amplified_inputs(state, amped)
    nf_pods = nf_snap.build_pod_arrays(pods, state.nf_args, axis=state.axis)
    delta = _amplified_delta(nf_static, nf_pods, rows, allocated, ratios, cpu_dim)
    for col, ix in enumerate(idxs):
        scores[: len(pods), ix] += delta[:, col] * PluginWeights().nodefit


# ------------------------------------------------------ host-loop oracles
#
# The JAX package's pre-tensorization host loops, kept as the oracles the
# tests hold the engine's placement and device inputs against.  Nothing on
# the serving path calls them.


def _host_constraints(gang_in, rsv_in, rsv_names) -> _Constraints:
    """The host half of ``_Constraints`` from numpy ``GangInputs`` and
    ``ReservationInputs``: the queue order (QueueSort Less, the JAX
    engine's lexsort) and the arrays the replay reads."""
    g = gang_in.pods
    order = np.lexsort((np.arange(len(np.asarray(g.gang))), np.asarray(g.gang),
                        np.asarray(g.timestamp), -np.asarray(g.sub_priority),
                        -np.asarray(g.priority)))
    rsv_np = None if rsv_in is None else (rsv_in.rsv, np.asarray(rsv_in.matched))
    return _Constraints(order=order, gang_np=(gang_in.pods, gang_in.gangs), gang_names=[],
                        gang=gang_in, quota=None, rsv_np=rsv_np, rsv_names=list(rsv_names),
                        rsv=None, rsv_midx=None, rsv_rank=None)


def allocation_records_host(state, pods, hosts, precommit, gang_in, rsv_in, rsv_names, names,
                            now, assume, admitted=None):
    """The PreBind replay over an arbitrary store and name table (the JAX
    package's free function of the same name), shared with the host
    pipeline, so its records equal the engine's by construction.
    ``gang_in``/``rsv_in`` hold numpy arrays."""
    rscore = None if rsv_in is None else np.asarray(rsv_in.rscore)
    return _allocation_records(state, pods, hosts, precommit,
                               _host_constraints(gang_in, rsv_in, rsv_names), rscore, names,
                               now, assume, admitted, {"anti_affinity": 0, "devices": 0})


def mark_satisfied_gangs_host(state, pods, hosts, gang_in, gang_names) -> None:
    """The gang satisfaction of a committed batch over an arbitrary store."""
    cin = _host_constraints(gang_in, None, [])._replace(gang_names=list(gang_names))
    _mark_satisfied_gangs(state, pods, hosts, cin)


def placement_mask_host(state, pods, p_bucket: int, cap: int):
    """The host-loop placement mask: [p_bucket, cap] bool numpy, or None
    when no pod and no node triggers a policy."""
    st = state
    if not (any(p.node_selector or p.anti_affinity for p in pods) or st._tainted_nodes
            or st._aa_holder_count):
        return None
    tainted = []  # (row, [NoSchedule/NoExecute taints])
    holders = []  # (row, [co-located pods' anti-affinity selectors])
    for name in st._tainted_nodes:
        ix, node = st._imap.get(name), st._nodes.get(name)
        if ix is None or node is None:
            continue
        bad = [t for t in node.taints if t.get("effect") in ("NoSchedule", "NoExecute")]
        if bad:
            tainted.append((ix, bad))
    for name in st._aa_holder_count:
        ix, node = st._imap.get(name), st._nodes.get(name)
        if ix is None or node is None:
            continue
        sels = [ap.pod.anti_affinity for ap in node.assigned_pods if ap.pod.anti_affinity]
        if sels:
            holders.append((ix, sels))
    mask = np.ones((p_bucket, cap), dtype=bool)
    memo: Dict[tuple, np.ndarray] = {}
    aa_memo: Dict[tuple, list] = {}
    for i, p in enumerate(pods):
        if p.node_selector:
            key = tuple(sorted(p.node_selector.items()))
            row = memo.get(key)
            if row is None:
                names = None
                for pair in key:
                    rows = st._node_label_rows.get(pair)
                    if not rows:
                        names = set()
                        break
                    names = rows.copy() if names is None else names & rows
                row = np.zeros(cap, dtype=bool)
                for name in names or ():
                    ix = st._imap.get(name)
                    if ix is not None:
                        row[ix] = True
                memo[key] = row
            mask[i] &= row
        for ix, bad in tainted:
            if any(not tolerates(p, t) for t in bad):
                mask[i, ix] = False
        for ix, sels in holders:
            # an existing holder's anti-affinity selects the incoming pod
            if any(all(p.labels.get(k) == v for k, v in s.items()) for s in sels):
                mask[i, ix] = False
        if p.anti_affinity:
            # the incoming pod's own anti-affinity: nodes holding a pod it
            # selects are closed
            key = tuple(sorted(p.anti_affinity.items()))
            closed = aa_memo.get(key)
            if closed is None:
                cand = None
                for pair in key:
                    rows = st._pod_label_rows.get(pair)
                    if not rows:
                        cand = set()
                        break
                    cand = set(rows) if cand is None else cand & rows.keys()
                closed = []
                for name in cand or ():
                    node, ix = st._nodes.get(name), st._imap.get(name)
                    if node is None or ix is None:
                        continue
                    if any(all(ap.pod.labels.get(k) == v for k, v in p.anti_affinity.items())
                           for ap in node.assigned_pods):
                        closed.append(ix)
                aa_memo[key] = closed
            for ix in closed:
                mask[i, ix] = False
    return mask


def numa_device_inputs_host(state, nf_static, pods, p_bucket: int, cap: int):
    """The host-loop NUMA/deviceshare walk: (extra_scores, extra_feasible,
    admitted) as numpy, the oracle of ``Engine._numa_device_inputs``."""
    st = state
    relevant = _device_pods(pods)
    amped = _amped_nodes(st)
    if not relevant and not amped:
        return None, None, {}
    scores = np.zeros((p_bucket, cap), dtype=np.int64)
    feas = np.ones((p_bucket, cap), dtype=bool)
    dev_nodes = [(n, st._imap.get(n)) for n in sorted(st._gpus) if st._imap.get(n) is not None]
    topo_nodes = {n: st._imap.get(n) for n in st._topo if st._imap.get(n) is not None}
    rdma_nodes = {n: st._imap.get(n) for n in sorted(st._rdma) if st._imap.get(n) is not None}
    memo: Dict[tuple, tuple] = {}
    fp_cache: Dict[tuple, tuple] = {}

    def fingerprint(name: str, needs_dev: bool, needs_cs: bool) -> tuple:
        ck = (name, needs_dev, needs_cs)
        fp = fp_cache.get(ck)
        if fp is None:
            parts = []
            if needs_dev:
                parts.append(tuple((d.minor, d.numa_node, d.pcie, d.core_free,
                                    d.memory_ratio_free) for d in st._gpus.get(name, ())))
                parts.append(tuple((r.minor, r.numa_node, r.vfs_free)
                                   for r in st._rdma.get(name, ())))
            info = st._topo.get(name)
            if info is None:
                parts.append(None)
            else:
                parts.append((info.topo.sockets, info.topo.nodes_per_socket,
                              info.topo.cores_per_node, info.topo.cpus_per_core, info.policy,
                              info.max_ref_count))
                if needs_cs:
                    parts.append(tuple(sorted((c, tuple(pols))
                                              for c, pols in st._cpus_taken.get(name, {}).items())))
            fp = tuple(parts)
            fp_cache[ck] = fp
        return fp

    sig_groups: Dict[tuple, list] = {}
    sig_info: Dict[tuple, tuple] = {}
    for i, p, greq, wants_cs in relevant:
        rdma_req = int(p.requests.get(RDMA, 0))
        feas[i, :] = False
        sig = _device_sig(p, greq, wants_cs)
        sig_groups.setdefault(sig, []).append(i)
        if sig not in sig_info:
            if greq:
                cand = dict(dev_nodes)
            elif rdma_req > 0 and not wants_cs:
                cand = dict(rdma_nodes)
            else:
                cand = dict(topo_nodes)
            if greq and wants_cs:
                cand = {n: ix for n, ix in cand.items() if n in topo_nodes}
            sig_info[sig] = (p, greq, wants_cs, rdma_req, cand)
    admitted_by_sig: Dict[tuple, dict] = {}
    pod_sig: Dict[int, tuple] = {}
    for sig, idxs in sig_groups.items():
        p, greq, wants_cs, rdma_req, cand = sig_info[sig]
        needs_dev = greq is not None or rdma_req > 0
        row = np.zeros(cap, dtype=bool)
        sig_masks: dict = {}
        for name, ix in cand.items():
            fp = fingerprint(name, needs_dev, wants_cs)
            hit = memo.get((fp, sig))
            if hit is None:
                info = st._topo.get(name)
                avail = (st.available_cpus(name, info.max_ref_count)
                         if wants_cs and info is not None else [])
                hit = _eval_device_sig_view(
                    (info, st._gpus.get(name, ()), st._rdma.get(name, ()), avail,
                     st.cpu_allocs(name)), sig, p)
                memo[(fp, sig)] = hit
            ok, mask_nodes = hit
            row[ix] = ok
            if ok:
                sig_masks[name] = mask_nodes
        admitted_by_sig[sig] = sig_masks
        feas[np.asarray(idxs, dtype=np.int64)] = row[None, :]
        for i in idxs:
            pod_sig[i] = sig
    admitted = _AdmittedBySig(pod_sig, admitted_by_sig)
    # deviceshare Score for GPU pods over device nodes, pre-weighted
    gpu_pods = [(i, p) for i, p, greq, _ in relevant if greq is not None]
    if gpu_pods and dev_nodes:
        ds = deviceshare_score([st._gpus[n] for n, _ in dev_nodes],
                               [p.requests for _, p in gpu_pods])
        for r, (i, _) in enumerate(gpu_pods):
            for col, (_, ix) in enumerate(dev_nodes):
                scores[i, ix] += ds[r, col] * PluginWeights().numa
    if amped and pods:
        _apply_amplified_scores(state, nf_static, pods, scores, amped)
    return scores, feas, admitted
