"""Incremental sparse->dense snapshot store, with device-resident node tables.

Informer-event deltas (node spec / NodeMetric / pod assign / pod delete —
the events the Go shim forwards) refresh ONLY the touched node's dense row,
so publish cost is O(dirty rows) + O(N) vectorized time-gating.  The rows
are the JAX package's (service/state.py) bit for bit: the same builders
(``snapshot.loadaware.node_row_raw``, ``snapshot.nodefit.node_row``), the
same stable index map with smallest-index-first reuse, the same
power-of-two capacity buckets.

Every row refresh stamps the row with a monotone epoch (``_row_ver``).
The stamps drive two consumers that advance at different times and keep
their own watermarks: the device residency (``DeviceResidency``, the
default, ``device_state=True``), which keeps the node tables on the card
and ships only the rows whose stamps moved (``dstate_scatter``), and the
engine's SCHEDULE warm carry (``sched_versions``/``sched_dirty_rows``),
which rebuilds only those rows of its key matrix.

What this port does not carry raises ``NotImplementedError`` instead of
serving a different answer: NUMA topologies, device inventories, hard node
taints, assigned pods with required anti-affinity or device grants, and
the policy/device resident tables that belong to them.  The gang, quota
and reservation stores are the JAX package's (``service.constraints``),
hooked into node removal, assign and unassign as there.
"""

from __future__ import annotations

import ctypes
import heapq
import itertools
from typing import Dict, List, NamedTuple, Optional, Set

import numpy as np
import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.api.model import AssignedPod, Node, NodeMetric
from koordinator_tpu_torch.core.config import LoadAwareArgs, NodeFitArgs
from koordinator_tpu_torch.core.loadaware import LoadAwareNodeArrays
from koordinator_tpu_torch.core.nodefit import NodeFitNodeArrays
from koordinator_tpu_torch.service.constraints import GangStore, QuotaStore, ReservationStore
from koordinator_tpu_torch.snapshot import loadaware as la_snap
from koordinator_tpu_torch.slices import PLACEMENT, later
from koordinator_tpu_torch.snapshot import nodefit as nf_snap

# process-unique ClusterState identities for engine-side warm-carry keys
_SCHED_STORE_TOKENS = itertools.count(1)


def next_bucket(n: int, minimum: int = 256) -> int:
    """Smallest power-of-two bucket >= n (>= minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


class IndexMap:
    """Stable name -> row-index map with free-list reuse, smallest index
    first (a min-heap): a full remove + re-add in a fixed order reproduces
    the exact row layout of a fresh store fed in that order."""

    def __init__(self):
        self._idx: Dict[str, int] = {}
        self._names: List[Optional[str]] = []
        self._free: List[int] = []  # min-heap (heapq)
        self.mutations = 0  # bumps whenever the name<->index mapping changes

    def __len__(self) -> int:
        return len(self._idx)

    def get(self, name: str) -> Optional[int]:
        return self._idx.get(name)

    def add(self, name: str) -> int:
        i = self._idx.get(name)
        if i is not None:
            return i
        if self._free:
            i = heapq.heappop(self._free)
            self._names[i] = name
        else:
            i = len(self._names)
            self._names.append(name)
        self._idx[name] = i
        self.mutations += 1
        return i

    def remove(self, name: str) -> int:
        i = self._idx.pop(name)
        self._names[i] = None
        heapq.heappush(self._free, i)
        self.mutations += 1
        return i


class Snapshot(NamedTuple):
    """An immutable published view.  Arrays are capacity-padded numpy;
    ``valid`` marks live rows (padding/holes are False and must be ANDed
    into any feasibility the kernels produce)."""

    la_nodes: LoadAwareNodeArrays
    nf_nodes: NodeFitNodeArrays
    valid: np.ndarray  # [cap] bool
    names: tuple  # [cap] node name or None
    generation: int
    num_live: int


# --------------------------------------------------------------- residency
#
# The three device programs of the residency, each a wrapper beside its
# plain PyTorch version: CPU tensors take the plain version, CUDA tensors
# launch the kernel of ``csrc/dstate.cu`` or raise.  ``dstate_rows`` is a
# transfer with no arithmetic.


def _host_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def dstate_rows(arrays, device: torch.device) -> tuple:
    """Whole-table adoption (the JAX package's ``dstate_rows``, an identity
    on the device): one ``copy_`` per array from pinned host memory into a
    fresh resident buffer.  On the CPU the resident buffers are private
    copies, never views of the store's arrays."""
    out = []
    for a in arrays:
        host = _host_tensor(a)
        if device.type == "cpu":
            out.append(host.clone())
            continue
        buf = torch.empty(host.shape, dtype=host.dtype, device=device)
        buf.copy_(host.pin_memory(), non_blocking=True)
        out.append(buf)
    return tuple(out)


def _scatter_inputs(bufs, idx, vals):
    """Validate one delta batch against the resident buffers before any
    launch; return (idx, vals) as CPU tensors."""
    idx = np.asarray(idx)
    if idx.dtype != np.int32 or idx.ndim != 1 or idx.size == 0:
        raise ValueError(f"idx: expected a non-empty 1-D int32 array, got {idx.dtype} {idx.shape}")
    if len(vals) != len(bufs):
        raise ValueError(f"{len(vals)} value arrays for {len(bufs)} buffers")
    rows, dev = bufs[0].shape[0], bufs[0].device
    if int(idx.min()) < 0 or int(idx.max()) >= rows:
        raise ValueError(f"idx outside [0, {rows})")
    out = []
    for i, (b, v) in enumerate(zip(bufs, vals)):
        v = _host_tensor(v)
        want = (idx.size,) + tuple(b.shape[1:])
        if (b.device != dev or b.shape[0] != rows or not b.is_contiguous()
                or v.dtype != b.dtype or tuple(v.shape) != want):
            raise ValueError(
                f"array {i}: buffer {b.dtype} {tuple(b.shape)} on {b.device}, "
                f"values {v.dtype} {tuple(v.shape)} (want {want})"
            )
        out.append(v)
    return torch.from_numpy(idx), out


def dstate_scatter_plain(bufs, idx: torch.Tensor, vals) -> tuple:
    """``buf[idx[k]] = vals[k]`` for every buffer, in place.  Duplicate
    indices carry identical rows, so any writer is right."""
    i = idx.to(torch.int64)
    for b, v in zip(bufs, vals):
        b[i] = v
    return tuple(bufs)


def dstate_scatter(bufs, idx, vals) -> tuple:
    """Apply one delta batch to the resident buffers, in place: the JAX
    package's ``dstate_scatter`` (state.py:200).  ``idx`` [D] int32 (host)
    is padded to a power-of-two bucket by repeating a real row; ``vals``
    are the host rows ``host[idx]``, one array per buffer.  On CUDA the
    index and every row travel in ONE pinned host->device copy and ONE
    launch of ``csrc/dstate.cu`` walks a descriptor table of (buffer, row
    bytes)."""
    idx_t, vals_t = _scatter_inputs(bufs, idx, vals)
    dev = bufs[0].device
    if dev.type == "cpu":
        return dstate_scatter_plain(bufs, idx_t, vals_t)
    if len(bufs) > cuda.DSTATE_MAX_ARRAYS:
        raise ValueError(f"{len(bufs)} buffers exceed {cuda.DSTATE_MAX_ARRAYS}")
    parts = [idx_t.numpy().view(np.uint8)] + [v.numpy().reshape(-1).view(np.uint8) for v in vals_t]
    offsets = np.cumsum([0] + [p.size for p in parts])
    pinned = torch.empty(int(offsets[-1]), dtype=torch.uint8, pin_memory=True)
    np.concatenate(parts, out=pinned.numpy())
    packed = torch.empty(pinned.shape, dtype=torch.uint8, device=dev)
    packed.copy_(pinned, non_blocking=True)
    n = len(bufs)
    dst = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bufs))
    row_bytes = (ctypes.c_longlong * n)(*(b[0].numel() * b.element_size() for b in bufs))
    src_off = (ctypes.c_longlong * n)(*(int(o) for o in offsets[1:-1]))
    cuda.DSTATE_SCATTER.launch(
        n, dst, row_bytes, packed.data_ptr(), src_off, int(idx_t.shape[0]),
        cuda.device_index(dev), cuda.stream(dev),
    )
    return tuple(bufs)


def _gate_inputs(raw):
    N, dev = raw[4].shape[0], raw[4].device
    for k, dtype in ((3, torch.bool), (4, torch.float64), (6, torch.bool), (9, torch.bool),
                     (11, torch.bool)):
        t = raw[k]
        if t.dtype != dtype or tuple(t.shape) != (N,) or t.device != dev:
            raise ValueError(
                f"gate input {k}: expected {dtype} ({N},) on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    return N, dev


def dstate_gate_plain(raw, now: float, exp, fexp: bool) -> LoadAwareNodeArrays:
    """Raw resident LoadAware rows + ``now`` -> the gated arrays, in float64
    exactly as ``snapshot.loadaware.gate_node_rows`` compares (a NaN update
    time is expired)."""
    (alloc, base_nonprod, base_prod, has_metric, update_time, filter_usage,
     filter_active, thresholds, prod_usage, prod_active, prod_thresholds, has_prod_thr) = raw
    if exp is not None:
        expired = torch.isnan(update_time)
        if exp > 0:
            expired = expired | ~((float(now) - update_time) < exp)
    else:
        expired = torch.zeros_like(has_metric)
    filter_live = ~expired if fexp else torch.ones_like(has_metric)
    return LoadAwareNodeArrays(
        alloc=alloc,
        base_nonprod=base_nonprod,
        base_prod=base_prod,
        score_valid=has_metric & ~expired,
        filter_usage=filter_usage,
        filter_active=filter_active & filter_live,
        thresholds=thresholds,
        prod_usage=prod_usage,
        prod_filter_active=prod_active & filter_live,
        prod_thresholds=prod_thresholds,
        has_prod_thresholds=has_prod_thr & filter_live,
    )


def dstate_gate(raw, now: float, exp, fexp: bool) -> LoadAwareNodeArrays:
    """The JAX package's ``dstate_gate`` (state.py:222): the 12 raw resident
    LoadAware rows (``DeviceResidency._ROWS[:12]``) + ``now`` -> gated
    ``LoadAwareNodeArrays``.  The [N, R] rows pass through; the four gated
    [N] masks are new tensors.  On CUDA one elementwise launch of
    ``csrc/dstate.cu`` computes them, ``now`` and ``exp`` as doubles."""
    N, dev = _gate_inputs(raw)
    if dev.type == "cpu":
        return dstate_gate_plain(raw, now, exp, fexp)
    gated = [torch.empty(N, dtype=torch.bool, device=dev) for _ in range(4)]
    if N:
        cuda.DSTATE_GATE.launch(
            N, raw[3].data_ptr(), raw[4].data_ptr(), raw[6].data_ptr(), raw[9].data_ptr(),
            raw[11].data_ptr(), float(now), int(exp is not None),
            int(exp is not None and exp > 0), float(exp or 0), int(bool(fexp)),
            *(g.data_ptr() for g in gated), cuda.device_index(dev), cuda.stream(dev),
        )
    score_valid, filter_active, prod_active, has_prod_thr = gated
    return LoadAwareNodeArrays(
        alloc=raw[0], base_nonprod=raw[1], base_prod=raw[2], score_valid=score_valid,
        filter_usage=raw[5], filter_active=filter_active, thresholds=raw[7],
        prod_usage=raw[8], prod_filter_active=prod_active, prod_thresholds=raw[10],
        has_prod_thresholds=has_prod_thr,
    )


class ResidencyMismatch(AssertionError):
    """A resident device table diverged from its host-built oracle.  Raised
    by ``DeviceResidency.verify`` after invalidating, so the next read
    rebuilds cold instead of re-serving the divergent table."""


class _ResidentTable:
    """One family of resident buffers + its own sync watermark (apart from
    the engine's warm-carry watermark: a SCORE syncs the residency without
    touching the carry)."""

    __slots__ = ("attrs", "bufs", "watermark", "shape_key", "audit_cursor")

    def __init__(self, attrs: tuple):
        self.attrs = attrs
        self.bufs: Optional[tuple] = None
        self.watermark = 0
        self.shape_key: Optional[tuple] = None
        self.audit_cursor = 0  # rotating sampled-audit window start


def _norm_device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceResidency:
    """The store's device-resident companion: the JAX package's
    ``DeviceResidency`` (state.py:309) for the ``rows`` table — the la/nf
    node rows and the valid mask, stamped by ``_row_ver``.

    The tables live on one explicit device, bound by the first
    ``serving_node_inputs(now, device)``; a read asking for another device
    raises.  A cold table adopts wholesale (``dstate_rows``); a warm one
    ships only the rows whose stamp moved past its watermark in one
    ``dstate_scatter``; past ``scatter_max_frac`` of the capacity it
    re-uploads wholesale.  A failed transfer or launch raises: nothing
    falls back to the host arrays (``device_state=False`` is the explicit
    host-built path).  ``verify`` bit-compares against the host arrays."""

    #: serving reads between automatic bit-match audits (0 = never)
    verify_every = 64
    #: rows the automatic audit compares (a rotating window)
    verify_sample_rows = 1024
    #: dirty fraction past which a wholesale re-upload replaces the scatter
    scatter_max_frac = 0.25

    _ROWS = (
        # la raw rows — ORDER IS the dstate_gate argument order
        "_la_alloc", "_la_base_nonprod", "_la_base_prod", "_la_has_metric",
        "_la_update_time", "_la_filter_usage", "_la_filter_active",
        "_la_thresholds", "_la_prod_usage", "_la_prod_active",
        "_la_prod_thresholds", "_la_has_prod_thr",
        # nf rows — NodeFitNodeArrays field order
        "_nf_alloc", "_nf_requested", "_nf_num_pods", "_nf_allowed",
        "_nf_alloc_score", "_nf_req_score",
        "_valid",
    )

    def __init__(self, state: "ClusterState", enabled: bool = True):
        self._state = state
        self.enabled = bool(enabled)
        self._rows = _ResidentTable(self._ROWS)
        self.device: Optional[torch.device] = None
        # one-entry gated-la cache: SCORE and SCHEDULE in one cycle share
        # one dstate_gate launch
        self._gate_key: Optional[tuple] = None
        self._gate_val = None
        self.h2d_bytes_total = 0
        self.full_uploads = 0
        self.scatters = 0
        self.last_dirty_rows = 0
        self.verifies = 0
        self._reads = 0

    def invalidate(self) -> None:
        """Drop the resident buffers: the next sync rebuilds cold (capacity
        growth, a failed audit)."""
        t = self._rows
        t.bufs = None
        t.shape_key = None
        t.watermark = 0
        self._gate_key = None
        self._gate_val = None

    def _bind(self, device) -> torch.device:
        d = _norm_device(device)
        if self.device is None:
            self.device = d
        elif d != self.device:
            raise ValueError(
                f"the resident tables live on {self.device}; a read asked for {d}"
            )
        return d

    def _sync(self) -> tuple:
        t, st = self._rows, self._state
        host = [getattr(st, a) for a in t.attrs]
        shape_key = tuple((a.shape, a.dtype.str) for a in host)
        ver = st._row_ver
        if t.bufs is None or t.shape_key != shape_key:
            # cold (first touch, capacity growth, invalidation)
            t.bufs = dstate_rows(host, self.device)
            t.shape_key = shape_key
            t.watermark = int(ver.max(initial=0))
            self.full_uploads += 1
            self.last_dirty_rows = host[0].shape[0]
            self.h2d_bytes_total += sum(a.nbytes for a in host)
            self._gate_key = None
            return t.bufs
        dirty = np.flatnonzero(ver > t.watermark)
        if dirty.size == 0:
            return t.bufs
        self.last_dirty_rows = int(dirty.size)
        if dirty.size >= self.scatter_max_frac * ver.shape[0]:
            t.bufs = None  # dense churn: re-upload wholesale
            return self._sync()
        db = next_bucket(int(dirty.size), 16)
        idx = np.full(db, dirty[0], dtype=np.int32)
        idx[: dirty.size] = dirty
        vals = tuple(np.ascontiguousarray(h[idx]) for h in host)
        t.bufs = dstate_scatter(t.bufs, idx, vals)
        t.watermark = int(ver.max(initial=0))
        self.scatters += 1
        self.h2d_bytes_total += idx.nbytes + sum(v.nbytes for v in vals)
        self._gate_key = None
        return t.bufs

    def serving_node_inputs(self, now: float, device):
        """(la_nodes, nf_nodes, valid) resident on ``device``, freshly
        synced and time-gated from ``now``.  The caller must not write
        them: clear a copy of ``valid`` to exclude nodes."""
        self._bind(device)
        bufs = self._sync()
        self._reads += 1
        if self.verify_every and self._reads % self.verify_every == 0:
            self.verify(sample=self.verify_sample_rows)
        key = (self.full_uploads, self.scatters, float(now))
        if self._gate_key != key:
            la_args = self._state.la_args
            self._gate_val = dstate_gate(
                bufs[:12], now, la_args.node_metric_expiration_seconds,
                bool(la_args.filter_expired_node_metrics),
            )
            self._gate_key = key
        return self._gate_val, NodeFitNodeArrays(*bufs[12:18]), bufs[18]

    def policy_rows(self):
        raise later("the resident policy-row table (taints, labels, anti-affinity)", PLACEMENT)

    def device_rows(self):
        raise later("the resident device-inventory table", PLACEMENT)

    def note_vocab_growth(self, attrs, fill) -> None:
        raise later("vocab-axis growth of the policy/device tables (dstate_extend)", PLACEMENT)

    def verify(self, sample: Optional[int] = None) -> int:
        """Bit-compare the warm resident table against the live host arrays
        after syncing it: every row (``sample=None``) or a ``sample``-row
        rotating window.  Returns the number of arrays checked; raises
        ``ResidencyMismatch`` (after invalidating) on any divergence."""
        t = self._rows
        if t.bufs is None:
            return 0
        self._sync()
        rows = getattr(self._state, t.attrs[0]).shape[0]
        if sample is None or sample >= rows:
            lo, hi = 0, rows
        else:
            lo = t.audit_cursor % rows
            hi = min(lo + sample, rows)
            t.audit_cursor = hi % rows
        for attr, buf in zip(t.attrs, t.bufs):
            host = getattr(self._state, attr)[lo:hi]
            dev = buf[lo:hi].cpu().numpy()
            equal = host.shape == dev.shape and host.dtype == dev.dtype and np.array_equal(
                host, dev, equal_nan=np.issubdtype(host.dtype, np.floating)
            )
            if not equal:
                self.invalidate()
                raise ResidencyMismatch(
                    f"resident array {attr!r} diverged from the host oracle (rows {lo}:{hi})"
                )
        self.verifies += 1
        return len(t.attrs)


def _hard_taints(node: Node) -> bool:
    return any(t.get("effect") in ("NoSchedule", "NoExecute") for t in node.taints)


def _refuse_assigned(pods) -> None:
    for ap in pods:
        if ap.pod.anti_affinity:
            raise later("assigned pods with required anti-affinity", PLACEMENT)
        if ap.pod.device_allocation:
            raise later("assigned pods holding devices or cpusets", PLACEMENT)


class ClusterState:
    """The live store the engine publishes from.  ``device_state=True`` (the
    default, as in the JAX package) keeps the node tables resident on the
    engine's device; ``device_state=False`` ships the published host
    arrays every cycle."""

    def __init__(
        self,
        la_args: Optional[LoadAwareArgs] = None,
        nf_args: Optional[NodeFitArgs] = None,
        extra_scalars: tuple = (),
        initial_capacity: int = 256,
        quota_resources: tuple = ("cpu", "memory"),
        device_state: bool = True,
    ):
        self.la_args = la_args if la_args is not None else LoadAwareArgs()
        self.nf_args = nf_args if nf_args is not None else NodeFitArgs()
        # cross-cycle constraint state (gangCache / GroupQuotaManager /
        # reservation cache equivalents) — see service.constraints
        self.gangs = GangStore()
        self.quota = QuotaStore(quota_resources)
        self.reservations = ReservationStore()
        # the NodeFit filter axis is fixed at config time (the Go shim
        # declares the scalar resources it schedules on)
        self.axis: List[str] = nf_snap.fixed_axis(extra_scalars, self.nf_args)
        self.rs: List[str] = [r for r, _ in self.nf_args.resources]
        self._R = len(self.la_args.resources)
        self._Rf = len(self.axis)
        self._Rs = len(self.rs)
        self._imap = IndexMap()
        self._nodes: Dict[str, Node] = {}
        self._pod_node: Dict[str, str] = {}
        # assigns racing ahead of their node-add are buffered, not dropped
        self._pending_assigns: Dict[str, List[AssignedPod]] = {}
        self._dirty: Set[str] = set()
        self._generation = 0
        # monotone row-refresh counter feeding the _row_ver stamps
        self._node_epoch = 0
        # bumped by every public mutator: the begin-input cache's key
        self._content_ver = 0
        # bumped by capacity growth: a warm carry taken before it is void
        self._warm_fence = 0
        # process-unique store identity for engine-side carry keys
        self._sched_store_token = next(_SCHED_STORE_TOKENS)
        self._cap = 0
        self._copies = None  # publish-time copy cache; None = stale
        # the tables upload lazily on the first serving read
        self.residency = DeviceResidency(self, enabled=device_state)
        self._grow(next_bucket(initial_capacity))

    # ------------------------------------------------------------- storage

    def _grow(self, cap: int) -> None:
        def g(name, cols, dtype=np.int64, fill=0):
            arr = np.full((cap, cols) if cols else (cap,), fill, dtype=dtype)
            old = getattr(self, name, None)
            if old is not None:
                arr[: old.shape[0]] = old
            return arr

        self._la_alloc = g("_la_alloc", self._R)
        self._la_base_nonprod = g("_la_base_nonprod", self._R)
        self._la_base_prod = g("_la_base_prod", self._R)
        self._la_has_metric = g("_la_has_metric", 0, bool, False)
        self._la_update_time = g("_la_update_time", 0, np.float64, np.nan)
        self._la_filter_usage = g("_la_filter_usage", self._R)
        self._la_filter_active = g("_la_filter_active", 0, bool, False)
        self._la_thresholds = g("_la_thresholds", self._R)
        self._la_prod_usage = g("_la_prod_usage", self._R)
        self._la_prod_active = g("_la_prod_active", 0, bool, False)
        self._la_prod_thresholds = g("_la_prod_thresholds", self._R)
        self._la_has_prod_thr = g("_la_has_prod_thr", 0, bool, False)
        self._nf_alloc = g("_nf_alloc", self._Rf)
        self._nf_requested = g("_nf_requested", self._Rf)
        self._nf_num_pods = g("_nf_num_pods", 0)
        self._nf_allowed = g("_nf_allowed", 0, np.int64, nf_snap._UNLIMITED_PODS)
        self._nf_alloc_score = g("_nf_alloc_score", self._Rs)
        self._nf_req_score = g("_nf_req_score", self._Rs)
        self._valid = g("_valid", 0, bool, False)
        # per-row change stamps: the epoch at which each row last changed
        self._row_ver = g("_row_ver", 0)
        self._cap = cap
        self._copies = None
        # the resident shapes no longer match, and any warm carry was taken
        # at the old shape
        self._warm_fence += 1
        self.residency.invalidate()

    # -------------------------------------------------------------- deltas

    def upsert_node(self, node: Node) -> None:
        """Node spec event.  The node's live metric and assign cache are
        owned by their own delta streams and survive a spec upsert."""
        if _hard_taints(node):
            raise later("nodes with NoSchedule/NoExecute taints", PLACEMENT)
        self._content_ver += 1
        prev = self._nodes.get(node.name)
        if prev is not None:
            node.metric = prev.metric
            node.assigned_pods = prev.assigned_pods
        else:
            _refuse_assigned(node.assigned_pods)
        self._nodes[node.name] = node
        i = self._imap.add(node.name)
        if i >= self._cap:
            self._grow(next_bucket(i + 1, self._cap * 2))
        self._dirty.add(node.name)
        for ap in self._pending_assigns.pop(node.name, ()):
            self.assign_pod(node.name, ap)

    def remove_node(self, name: str) -> None:
        self._content_ver += 1
        self._pending_assigns.pop(name, None)
        node = self._nodes.pop(name, None)
        if node is None:
            return
        for ap in node.assigned_pods:
            key = ap.pod.key
            self._pod_node.pop(key, None)
            # a removed node's pods release their quota, gang membership
            # and reservation allocations, as unassign_pod does
            self.quota.release(key)
            self.gangs.note_unassign(key)
            self.reservations.note_release(key)
        i = self._imap.remove(name)
        self._dirty.discard(name)
        self._clear_row(i)

    def update_metric(self, name: str, metric: NodeMetric) -> None:
        """NodeMetric status event; ignored for unknown nodes (the shim may
        race a metric ahead of its node, the next sync repairs it)."""
        self._content_ver += 1
        node = self._nodes.get(name)
        if node is None:
            return
        node.metric = metric
        self._dirty.add(name)

    def set_topology(self, name: str, info) -> None:
        raise later("NUMA topologies", PLACEMENT)

    def set_devices(self, name: str, gpus: list, rdma: list = ()) -> None:
        raise later("device inventories", PLACEMENT)

    def assign_pod(self, node_name: str, assigned: AssignedPod) -> None:
        """podAssignCache assign (pod_assign_cache.go:47): pod assumed/bound
        on the node.  Re-assign of a known pod moves it.  An assign for a
        node not (yet) known is buffered and replayed on the node's upsert."""
        _refuse_assigned([assigned])
        self._content_ver += 1
        node = self._nodes.get(node_name)
        if node is None:
            lst = self._pending_assigns.setdefault(node_name, [])
            lst[:] = [ap for ap in lst if ap.pod.key != assigned.pod.key]
            lst.append(assigned)
            return
        key = assigned.pod.key
        if key in self._pod_node:
            self.unassign_pod(key)
        node.assigned_pods.append(assigned)
        self._pod_node[key] = node_name
        self._dirty.add(node_name)
        # constraint-state hooks (idempotent by pod key): quota used walks
        # the group chain, gang membership counts toward waiting+bound
        # satisfaction
        if assigned.pod.quota:
            self.quota.consume(assigned.pod, assigned.pod.quota, assigned.pod.non_preemptible)
        if assigned.pod.gang:
            self.gangs.note_assign(key, assigned.pod.gang)

    def unassign_pod(self, pod_key: str) -> None:
        self._content_ver += 1
        self.quota.release(pod_key)
        self.gangs.note_unassign(pod_key)
        self.reservations.note_release(pod_key)
        node_name = self._pod_node.pop(pod_key, None)
        if node_name is None:
            for aps in self._pending_assigns.values():
                aps[:] = [ap for ap in aps if ap.pod.key != pod_key]
            return
        node = self._nodes[node_name]
        node.assigned_pods = [ap for ap in node.assigned_pods if ap.pod.key != pod_key]
        self._dirty.add(node_name)

    # ------------------------------------------------------------- publish

    def _clear_row(self, i: int) -> None:
        self._copies = None
        for arr in (
            self._la_alloc, self._la_base_nonprod, self._la_base_prod,
            self._la_filter_usage, self._la_thresholds, self._la_prod_usage,
            self._la_prod_thresholds, self._nf_alloc, self._nf_requested,
            self._nf_alloc_score, self._nf_req_score,
        ):
            arr[i] = 0
        self._la_has_metric[i] = False
        self._la_update_time[i] = np.nan
        self._la_filter_active[i] = False
        self._la_prod_active[i] = False
        self._la_has_prod_thr[i] = False
        self._nf_num_pods[i] = 0
        self._nf_allowed[i] = nf_snap._UNLIMITED_PODS
        self._valid[i] = False
        self._node_epoch += 1
        self._row_ver[i] = self._node_epoch

    def _refresh_row(self, name: str) -> None:
        self._copies = None
        node = self._nodes[name]
        i = self._imap.get(name)
        row = la_snap.node_row_raw(node, self.la_args)
        self._la_alloc[i] = row.alloc
        self._la_base_nonprod[i] = row.base_nonprod
        self._la_base_prod[i] = row.base_prod
        self._la_has_metric[i] = row.has_metric
        self._la_update_time[i] = row.update_time if row.has_metric else np.nan
        self._la_filter_usage[i] = row.filter_usage
        self._la_filter_active[i] = row.filter_active_raw
        self._la_thresholds[i] = row.thresholds
        self._la_prod_usage[i] = row.prod_usage
        self._la_prod_active[i] = row.prod_filter_active_raw
        self._la_prod_thresholds[i] = row.prod_thresholds
        self._la_has_prod_thr[i] = row.has_prod_thresholds_raw
        (
            self._nf_alloc[i],
            self._nf_requested[i],
            self._nf_num_pods[i],
            self._nf_allowed[i],
            self._nf_alloc_score[i],
            self._nf_req_score[i],
        ) = nf_snap.node_row(node, self.axis, self.rs)
        self._valid[i] = True
        self._node_epoch += 1
        self._row_ver[i] = self._node_epoch

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def content_key(self) -> tuple:
        """Equality token over the store's content within this process:
        node-side content (every mutator bumps ``_content_ver``) plus the
        gang, quota and reservation stores' versions."""
        return (self._content_ver, self.gangs.version, self.quota.version,
                self.reservations.version)

    # ----------------------------- cross-cycle SCHEDULE warm-start surface

    @property
    def warm_fence(self) -> int:
        """Monotone counter over shape discontinuities (capacity growth):
        part of the engine's warm-carry key."""
        return self._warm_fence

    @property
    def sched_store_token(self) -> int:
        """Process-unique identity of this store instance."""
        return self._sched_store_token

    def sched_versions(self) -> tuple:
        """The (node, policy, device) row-version watermarks a warm carry
        records when it is taken.  Only the node rows exist in this port:
        the policy and device slots are 0 until the placement-and-devices
        slice brings their stamps."""
        return (int(self._row_ver.max(initial=0)), 0, 0)

    def sched_dirty_rows(self, vers: tuple) -> np.ndarray:
        """Node rows whose stamp advanced past the recorded watermarks
        (int32, sorted): exactly the columns a warm carry must refresh."""
        return np.flatnonzero(self._row_ver > vers[0]).astype(np.int32)

    def sched_gate_flips(self, now0: float, now1: float) -> np.ndarray:
        """Node rows whose LoadAware metric-expiry gate flips between the
        two clocks (int32): their served inputs change with no stamp
        moving.  NaN update times never flip; a disabled expiry flips
        nothing."""
        exp = self.la_args.node_metric_expiration_seconds
        if exp is None or not (exp > 0) or now0 == now1:
            return np.empty(0, dtype=np.int32)
        ut = self._la_update_time
        with np.errstate(invalid="ignore"):
            return np.flatnonzero((now0 - ut < exp) != (now1 - ut < exp)).astype(np.int32)

    def publish(self, now: float) -> Snapshot:
        """Refresh dirty rows (O(dirty)), re-apply time gates (O(N)
        vectorized), return an immutable copy-snapshot.  The row copies are
        cached between publishes and re-copied only when a row changed."""
        for name in self._dirty:
            if name in self._nodes:
                self._refresh_row(name)
        self._dirty.clear()
        if self._copies is None:
            self._copies = {
                "la": [
                    a.copy()
                    for a in (
                        self._la_alloc, self._la_base_nonprod, self._la_base_prod,
                        self._la_has_metric, self._la_update_time, self._la_filter_usage,
                        self._la_filter_active, self._la_thresholds, self._la_prod_usage,
                        self._la_prod_active, self._la_prod_thresholds, self._la_has_prod_thr,
                    )
                ],
                "nf": NodeFitNodeArrays(
                    alloc=self._nf_alloc.copy(),
                    requested=self._nf_requested.copy(),
                    num_pods=self._nf_num_pods.copy(),
                    allowed_pods=self._nf_allowed.copy(),
                    alloc_score=self._nf_alloc_score.copy(),
                    req_score=self._nf_req_score.copy(),
                ),
                "valid": self._valid.copy(),
                "names": tuple(self._imap._names),
            }
        self._generation += 1
        c = self._copies
        la = la_snap.assemble_node_arrays(*c["la"], self.la_args, now)
        return Snapshot(
            la_nodes=la,
            nf_nodes=c["nf"],
            valid=c["valid"],
            names=c["names"],
            generation=self._generation,
            num_live=len(self._imap),
        )
