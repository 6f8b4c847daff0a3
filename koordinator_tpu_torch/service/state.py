"""Incremental sparse->dense snapshot store, with device-resident node tables.

Informer-event deltas (node spec / NodeMetric / NRT and device inventories
/ pod assign / pod delete — the events the Go shim forwards) refresh ONLY
the touched node's dense rows, so publish cost is O(dirty rows) + O(N)
vectorized time-gating.  The rows are the JAX package's (service/state.py)
bit for bit: the same builders (``snapshot.loadaware.node_row_raw``,
``snapshot.nodefit.node_row``), the same stable index map with
smallest-index-first reuse, the same power-of-two capacity buckets, the
same interning vocabularies for the placement-policy rows (taints, node
labels, assigned pods' anti-affinity selectors and label sets) and the
same device-inventory aggregates.

Every row refresh stamps the row with a monotone epoch, one family per
table: ``_row_ver`` (la/nf rows), ``_pp_row_ver`` (policy rows, bumped only
when a row actually changes) and ``_dv_row_ver`` (device rows).  The
stamps drive two consumers that advance at different times and keep their
own watermarks: the device residency (``DeviceResidency``, the default,
``device_state=True``), which keeps the three tables on the card and ships
only the rows whose stamps moved (``dstate_scatter``) or widens a table's
vocabulary axis in place of a re-upload (``dstate_extend``), and the
engine's SCHEDULE warm carry (``sched_versions``/``sched_dirty_rows``),
which rebuilds only those rows of its key matrix.  The gang, quota and
reservation stores are the JAX package's (``service.constraints``), hooked
into node removal, assign and unassign as there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
import itertools
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.api.model import AssignedPod, Node, NodeMetric
from koordinator_tpu_torch.core.config import LoadAwareArgs, NodeFitArgs
from koordinator_tpu_torch.core.loadaware import LoadAwareNodeArrays
from koordinator_tpu_torch.core.nodefit import NodeFitNodeArrays
from koordinator_tpu_torch.core.numa import CPUAlloc, CPUTopology
from koordinator_tpu_torch.core.placement import DeviceStage
from koordinator_tpu_torch.service.constraints import GangStore, QuotaStore, ReservationStore
from koordinator_tpu_torch.snapshot import loadaware as la_snap
from koordinator_tpu_torch.snapshot import nodefit as nf_snap

# process-unique ClusterState identities for engine-side warm-carry keys
_SCHED_STORE_TOKENS = itertools.count(1)

_VOCAB_MIN = 8  # smallest vocabulary-axis bucket of the policy/device rows


@dataclasses.dataclass
class NodeTopologyInfo:
    """The node's NodeResourceTopology report as the scheduler consumes it:
    CPU layout, the node's topology-manager policy, and the CPU
    amplification ratio."""

    topo: CPUTopology
    policy: str = "none"  # none | best-effort | restricted | single-numa-node
    cpu_ratio: float = 1.0
    # kubelet CPU-sharing option: how many pods may share one CPU
    # (cpu_accumulator.go maxRefCount; 1 = dedicated)
    max_ref_count: int = 1


def cpu_allocs_from(held: Dict[int, List[str]]):
    """cpu id -> CPUAlloc from a holder-policies map (the one
    representation the Filter-time walk and the allocation replay share)."""
    return {c: CPUAlloc(ref_count=len(pols), exclusive_policies=tuple(pols))
            for c, pols in held.items()}


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


def dstate_rows(arrays, device: torch.device) -> tuple:
    """Whole-table adoption (the JAX package's ``dstate_rows``, an identity
    on the device, a transfer with no arithmetic) through a module
    ``UploadStage``; the residency keeps one a table.  The arrays are
    packed at 256-byte offsets (``upload_layout``, as ``cudaMalloc`` aligns
    an allocation, so the device kernels' 16-byte loads keep their vector
    instantiations) into the stage's staging, pinned for a card and reused
    across adoptions, and ONE ``non_blocking`` copy moves it into one fresh
    device ``uint8`` slab; the resident buffers are typed, contiguous views
    of the slab, private copies, never views of the store's arrays (on the
    CPU, views of one copy of the staging).  The slab's cost: a buffer that
    ``dstate_extend`` later widens is replaced by a buffer of its own and
    leaves its old bytes in the slab until the table's next adoption, at
    most one table's size."""
    return tuple(_ADOPT.upload(arrays, device))


def scatter_layout(row_bytes, D: int) -> tuple:
    """The packed bytes of one scatter of ``D`` rows (csrc/dstate.cu's
    ``koord_dstate_scatter``): the D int32 indices, then each array's D
    rows from the next 16-byte boundary on.  Returns (each array's offset,
    the total bytes)."""
    offsets, end = [], 4 * D
    for rb in row_bytes:
        end = (end + 15) & ~15
        offsets.append(end)
        end += D * rb
    return offsets, end


@functools.lru_cache(maxsize=None)
def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


class ScatterStage:
    """``dstate_scatter``'s staging for one set of resident buffers: the
    descriptor of the buffers (``bind``, rebuilt only when they change),
    and a packed host buffer (pinned for a card) and device buffer, both
    grown by doubling and reused call after call.  ``gather`` takes the
    rows of the host arrays straight into the staging, ``pack`` given
    rows; ``scatter`` applies them: on the CPU the plain version from the
    staging's views, on a card one host->device copy and one launch of
    ``csrc/dstate.cu``.  The staging is rewritten only after the event
    recorded behind the last copy and launch has completed."""

    def __init__(self):
        self.binds = 0  # descriptors built
        self.desc = None  # ctypes int64 [n, 2]: destination, row bytes
        self.ptrs: tuple = ()
        self.rows = 0
        self.row_bytes: tuple = ()
        self.row_total = 0  # bytes of one row over every array
        self.device: Optional[torch.device] = None
        self._key = None
        self._layout: tuple = ()  # (numpy dtype, row shape) of each buffer
        self._host: Optional[torch.Tensor] = None
        self._dev: Optional[torch.Tensor] = None
        self._views: Dict[int, tuple] = {}  # D -> (index view, row views)
        self._event = None
        self._pending = False
        self._stream = None

    def bind(self, bufs) -> None:
        """Validate the resident buffers and build their descriptor: one
        device, one row count, contiguous, at most ``cuda.DSTATE_MAX_ARRAYS``
        on a card."""
        if not bufs:
            raise ValueError("no buffers to scatter into")
        rows, dev = bufs[0].shape[0], bufs[0].device
        if dev.type != "cpu" and len(bufs) > cuda.DSTATE_MAX_ARRAYS:
            raise ValueError(f"{len(bufs)} buffers exceed {cuda.DSTATE_MAX_ARRAYS}")
        for i, b in enumerate(bufs):
            if b.device != dev or b.shape[0] != rows or not b.is_contiguous():
                raise ValueError(f"buffer {i}: {b.dtype} {tuple(b.shape)} on {b.device} "
                                 f"(want {rows} contiguous rows on {dev})")
        layout = tuple((_np_dtype(b.dtype), tuple(b.shape[1:])) for b in bufs)
        row_bytes = tuple(b.element_size() * math.prod(b.shape[1:]) for b in bufs)
        if dev != self.device:
            # the staging is pinned only for a card, the device buffer, the
            # event and the stream belong to one device: a new device starts
            # them anew, once the last copy out of the old ones is done
            if self._pending:
                self._event.synchronize()
            self._host = self._dev = self._event = self._stream = None
            self._pending = False
        if layout != self._layout or dev != self.device:
            self._views = {}
        self.ptrs = tuple(b.data_ptr() for b in bufs)
        self.desc = (ctypes.c_longlong * (2 * len(bufs)))(
            *(v for p, rb in zip(self.ptrs, row_bytes) for v in (p, rb)))
        self.rows, self.device, self._layout = rows, dev, layout
        self.row_bytes, self.row_total = row_bytes, sum(row_bytes)
        self._key = self._key_of(bufs)
        self.binds += 1

    @staticmethod
    def _key_of(bufs) -> tuple:
        return (bufs[0].device,) + tuple((b.data_ptr(), b.dtype, b.shape) for b in bufs)

    def bound_to(self, bufs) -> bool:
        return self._key == self._key_of(bufs)

    def _index(self, idx) -> int:
        idx = np.asarray(idx)
        if idx.dtype != np.int32 or idx.ndim != 1 or idx.size == 0:
            raise ValueError(f"idx: expected a non-empty 1-D int32 array, got {idx.dtype} "
                             f"{idx.shape}")
        if int(idx.min()) < 0 or int(idx.max()) >= self.rows:
            raise ValueError(f"idx outside [0, {self.rows})")
        return int(idx.size)

    def _staging(self, D: int) -> tuple:
        """(index view, row views) of the staging for ``D`` rows, after the
        last copy out of it has completed."""
        if self._pending:
            self._event.synchronize()
            self._pending = False
        views = self._views.get(D)
        if views is None:
            offsets, total = scatter_layout(self.row_bytes, D)
            if self._host is None or self._host.numel() < total:
                cap = max(4096, 1 << (total - 1).bit_length())
                self._host = torch.empty(cap, dtype=torch.uint8,
                                         pin_memory=self.device.type == "cuda")
                self._views = {}
            raw = self._host.numpy()
            views = (raw[: 4 * D].view(np.int32),
                     [raw[o: o + D * rb].view(dt).reshape((D,) + shape)
                      for o, rb, (dt, shape) in zip(offsets, self.row_bytes, self._layout)],
                     total)
            self._views[D] = views
        return views

    def gather(self, host, idx) -> int:
        """The rows ``host[a][idx]`` of every host array (the buffers' own
        dtypes and row shapes) into the staging; returns D."""
        D = self._index(idx)
        iv, rows, _ = self._staging(D)
        iv[:] = idx
        for h, out in zip(host, rows):
            np.take(h, idx, axis=0, out=out, mode="clip")
        return D

    def pack(self, idx, vals) -> int:
        """Given rows ``vals`` (one host array per buffer, [D, ...]) into the
        staging, validated against the buffers in one pass; returns D."""
        D = self._index(idx)
        if len(vals) != len(self._layout):
            raise ValueError(f"{len(vals)} value arrays for {len(self._layout)} buffers")
        for i, (v, (dt, shape)) in enumerate(zip(vals, self._layout)):
            if v.dtype != dt or v.shape != (D,) + shape:
                raise ValueError(f"array {i}: values {v.dtype} {v.shape} for a buffer of "
                                 f"{dt} rows {shape} (want {(D,) + shape})")
        iv, rows, _ = self._staging(D)
        iv[:] = idx
        for v, out in zip(vals, rows):
            out[...] = v
        return D

    def scatter(self, bufs, D: int) -> tuple:
        """Apply the staged rows to ``bufs`` (the buffers bound), in place."""
        iv, rows, total = self._views[D]
        dev = self.device
        if dev.type == "cpu":
            return dstate_scatter_plain(bufs, torch.from_numpy(iv),
                                        [torch.from_numpy(r) for r in rows])
        if self._dev is None or self._dev.numel() < total:
            self._dev = torch.empty(self._host.numel(), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev)
        if self._event is None:
            self._event = torch.cuda.Event()
        elif stream != self._stream:
            # the device buffer is reused in stream order: a new stream waits
            # for the last launch that read it
            stream.wait_event(self._event)
        self._stream = stream
        cuda.DSTATE_SCATTER.launch(len(bufs), self.desc, self._host.data_ptr(),
                                   self._dev.data_ptr(), self._dev.numel(), D,
                                   cuda.device_index(dev), stream.cuda_stream)
        self._event.record(stream)
        self._pending = True
        return tuple(bufs)


def dstate_scatter_plain(bufs, idx: torch.Tensor, vals) -> tuple:
    """``buf[idx[k]] = vals[k]`` for every buffer, in place.  Duplicate
    indices carry identical rows, so any writer is right."""
    i = idx.to(torch.int64)
    for b, v in zip(bufs, vals):
        b[i] = v
    return tuple(bufs)


UPLOAD_ALIGN = 256  # each array of an UploadStage copy starts at a multiple
# the packing's host threads (numpy's copies release the GIL) and the bytes
# a thread takes at least: below two shares the caller packs alone.  Small
# shares lose to the threads' hand-offs: on the host of an NVIDIA H100
# 80GB HBM3 (700 W) 4.1 MB in seven shares packed in 0.92-1.20 ms
# against 0.34-0.42 on the caller alone, while 273 MB in eight took
# 11.1-14.4 ms against 27.6-39.5
PACK_THREADS = min(8, os.cpu_count() or 1)
PACK_SHARE_BYTES = 1 << 24


def upload_layout(nbytes) -> tuple:
    """The packed layout of one ``UploadStage`` copy: each array from the
    next multiple of ``UPLOAD_ALIGN`` bytes on (8-byte views for the int64
    arrays, 16-byte loads for any reader).  Returns (each array's offset,
    the total bytes)."""
    offsets, end = [], 0
    for nb in nbytes:
        offsets.append(end)
        end += (int(nb) + UPLOAD_ALIGN - 1) // UPLOAD_ALIGN * UPLOAD_ALIGN
    return offsets, end


def _pack_shares(srcs, offsets) -> list:
    """The packing's copies, (staging offset, uint8 source) pairs, cut into
    up to ``PACK_THREADS`` shares of about equal bytes, each at least
    ``PACK_SHARE_BYTES`` (an array may span two shares); one share, or
    none, below twice that."""
    size = sum(src.size for src in srcs)
    n = max(1, min(PACK_THREADS, size // PACK_SHARE_BYTES))
    per = -(-size // n) if size else 0
    shares, job, room = [], [], per
    for src, o in zip(srcs, offsets):
        pos = 0
        while pos < src.size:
            take = min(room, src.size - pos)
            job.append((o + pos, src[pos:pos + take]))
            pos, room = pos + take, room - take
            if room == 0:
                shares.append(job)
                job, room = [], per
    if job:
        shares.append(job)
    return shares


def _copy_into(raw: np.ndarray, job) -> None:
    for o, src in job:
        raw[o:o + src.size] = src


@functools.lru_cache(maxsize=None)
def _pack_pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(PACK_THREADS - 1, "koord-pack")


class UploadStage:
    """Host arrays carried to a device in one copy: packed into one host
    staging buffer (``upload_layout``), copied with one ``non_blocking``
    host->device copy into a device buffer allocated fresh each call, and
    returned as views of it, each with its array's dtype and shape.  A
    fresh device buffer each call: a caller may keep the views of earlier
    calls (a cycle's cached inputs, a table's old buffers), and no later
    call writes them.  The staging is grown by doubling and reused call
    after call, pinned for a card; it is rewritten only after the event
    recorded behind its last copy has completed.  On the CPU the same
    packing fills the same staging, unpinned, and the views are of one
    copy of it."""

    def __init__(self):
        self.copies = 0
        self.grows = 0  # staging buffers allocated
        self._host: Optional[torch.Tensor] = None
        self._pinned = False
        self._event = None
        self._pending = False

    def _pack(self, arrays, pin: bool) -> tuple:
        """The contiguous ``arrays`` into the staging (pinned when ``pin``),
        after the last copy out of it has completed; returns (each array's
        offset, the total bytes)."""
        offsets, total = upload_layout(a.nbytes for a in arrays)
        if self._pending:
            self._event.synchronize()
            self._pending = False
        if self._host is None or self._host.numel() < total or self._pinned != pin:
            # at least double the old staging (a table's capacity doubles),
            # the first one to its need, in whole pages
            old = 0 if self._host is None or self._pinned != pin else self._host.numel()
            cap = max((total + 4095) // 4096 * 4096, 2 * old, 4096)
            self._host = torch.empty(cap, dtype=torch.uint8, pin_memory=pin)
            self._pinned = pin
            self.grows += 1
        raw = self._host.numpy()
        shares = _pack_shares([a.reshape(-1).view(np.uint8) for a in arrays], offsets)
        rest = [_pack_pool().submit(_copy_into, raw, job) for job in shares[1:]]
        for job in shares[:1]:
            _copy_into(raw, job)  # the caller packs the first share
        for f in rest:
            f.result()
        return offsets, total

    def upload(self, arrays, device) -> list:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        device = torch.device(device)
        card = device.type != "cpu"
        offsets, total = self._pack(arrays, card)
        if card:
            buf = torch.empty(total, dtype=torch.uint8, device=device)
            buf.copy_(self._host[:total], non_blocking=True)
            if self._event is None:
                self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
            self._pending = True
        else:
            buf = self._host[:total].clone()
        self.copies += 1
        # each view strided over one view of the buffer a dtype: one tensor
        # call an array, where a slice and two views take three
        bases: Dict[torch.dtype, torch.Tensor] = {}
        out = []
        for a, o in zip(arrays, offsets):
            dt = _torch_dtype(a.dtype)
            base = bases.get(dt)
            if base is None:
                base = bases[dt] = buf.view(dt)
            out.append(base.as_strided(a.shape, _strides(a.shape), o // a.itemsize))
        return out


@functools.lru_cache(maxsize=None)
def _strides(shape: tuple) -> tuple:
    """The contiguous strides of ``shape``, in elements."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= n
    return tuple(reversed(out))


@functools.lru_cache(maxsize=None)
def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


# the stagings of calls that name their buffers or arrays each time (tests,
# studies); the residency keeps one of each a table
_STAGE = ScatterStage()
_ADOPT = UploadStage()


def dstate_scatter(bufs, idx, vals) -> tuple:
    """Apply one delta batch to the resident buffers, in place: the JAX
    package's ``dstate_scatter`` (state.py:200).  ``idx`` [D] int32 (host)
    is padded to a power-of-two bucket by repeating a real row; ``vals``
    are the host rows ``host[idx]``, one array per buffer.  They are packed
    into a ``ScatterStage`` (rebound when ``bufs`` change); on CUDA the
    index and every row travel in ONE host->device copy and ONE launch of
    ``csrc/dstate.cu`` applies them.  The residency gathers its rows
    straight into a stage of its own (``DeviceResidency._sync``)."""
    if not bufs or not _STAGE.bound_to(bufs):
        _STAGE.bind(bufs)
    return _STAGE.scatter(bufs, _STAGE.pack(idx, vals))


# the raw rows the gate reads, in the kernel's descriptor order
# (has_metric, update_time, filter_active, prod_active, has_prod_thr)
_GATE_INPUTS = ((3, torch.bool), (4, torch.float64), (6, torch.bool), (9, torch.bool),
                (11, torch.bool))


def _gate_inputs(raw):
    """Check the five gated rows: one dtype each, [N], one device, and
    contiguous (the kernel reads each through its base pointer, so a
    strided view is refused rather than read as other elements)."""
    N, dev = raw[4].shape[0], raw[4].device
    for k, dtype in _GATE_INPUTS:
        t = raw[k]
        if (t.dtype != dtype or tuple(t.shape) != (N,) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"gate input {k}: expected a contiguous {dtype} ({N},) on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} stride {tuple(t.stride())} on {t.device}"
            )
    return N, dev


class GateStage:
    """``dstate_gate`` over one set of raw resident rows: ``bind`` checks the
    five gated inputs once and packs their pointers, N and the device index
    into one host descriptor (again only when the rows are replaced);
    ``gate`` then launches ``csrc/dstate.cu``'s gate once on a card, into a
    fresh [4, N] bool allocation whose rows are the four masks (a fresh one
    each call: callers may keep the arrays of earlier calls), or runs the
    plain version on the CPU.  The stage keeps the rows it is bound to."""

    def __init__(self):
        self.binds = 0  # descriptors built
        self.raw: tuple = ()
        self.device: Optional[torch.device] = None
        self.desc = None  # ctypes int64 [7]: the five inputs' pointers, N, device
        self._key: tuple = ()
        self._desc_ptr = 0
        self._n = 0

    def bind(self, raw) -> None:
        N, dev = _gate_inputs(raw)
        self.raw, self._key = tuple(raw), self._key_of(raw)
        self.device, self._n = dev, N
        if dev.type == "cuda":
            self.desc = (ctypes.c_longlong * 7)(*(raw[k].data_ptr() for k, _ in _GATE_INPUTS),
                                               N, cuda.device_index(dev))
            self._desc_ptr = ctypes.addressof(self.desc)
        else:
            self.desc, self._desc_ptr = None, 0
        self.binds += 1

    @staticmethod
    def _key_of(raw) -> tuple:
        # the rows passed through are returned as the tensors they are, so
        # their identity is enough; a gated row's pointer, length and
        # layout are what the descriptor holds (a tensor's dtype cannot
        # change in place)
        return tuple(map(id, raw)) + tuple(
            (raw[k].data_ptr(), raw[k].numel(), raw[k].is_contiguous()) for k, _ in _GATE_INPUTS)

    def bound_to(self, raw) -> bool:
        """Whether ``raw`` holds the very rows bound, each gated one still
        over the same memory: a row moved to new storage under the same
        tensor (``set_``, a ``resize_`` that reallocates) rebinds, as
        ``ScatterStage.bound_to`` keys on its buffers' pointers."""
        return self._key == self._key_of(raw)

    def gate(self, now: float, exp, fexp: bool) -> LoadAwareNodeArrays:
        raw = self.raw
        if self._desc_ptr == 0:
            return dstate_gate_plain(raw, now, exp, fexp)
        out = torch.empty((4, self._n), dtype=torch.bool, device=self.device)
        if self._n:
            flags = ((cuda.GATE_HAS_EXP | (cuda.GATE_EXP_POS if exp > 0 else 0))
                     if exp is not None else 0) | (cuda.GATE_FEXP if fexp else 0)
            cuda.DSTATE_GATE.launch(self._desc_ptr, float(now), float(exp or 0), flags,
                                    out.data_ptr(), cuda.stream(self.device))
        # one call for the four row views (iterating the tensor costs more)
        score_valid, filter_active, prod_active, has_prod_thr = out.unbind(0)
        return LoadAwareNodeArrays(raw[0], raw[1], raw[2], score_valid, raw[5], filter_active,
                                   raw[7], raw[8], prod_active, raw[10], has_prod_thr)


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


# the stage of calls that name their rows each time (tests, studies); the
# residency keeps one bound to its rows table
_GATE = GateStage()


def dstate_gate(raw, now: float, exp, fexp: bool) -> LoadAwareNodeArrays:
    """The JAX package's ``dstate_gate`` (state.py:222): the 12 raw resident
    LoadAware rows (``DeviceResidency._ROWS[:12]``) + ``now`` -> gated
    ``LoadAwareNodeArrays``.  The [N, R] rows pass through; the four gated
    [N] masks are new tensors.  Through a ``GateStage``, rebound (and the
    inputs checked) when ``raw`` holds other rows; on CUDA one elementwise
    launch of ``csrc/dstate.cu`` computes them, ``now`` and ``exp`` as
    doubles."""
    if not _GATE.bound_to(raw):
        _GATE.bind(raw)
    return _GATE.gate(now, exp, fexp)


_EXTEND_DTYPES = (torch.bool, torch.int32, torch.int64)


def _extend_inputs(bufs, new_cols, fills):
    """Validate one vocab-axis widening before any launch, in one pass:
    one to ``cuda.DSTATE_MAX_ARRAYS`` buffers, each a contiguous [N, c]
    table of one device and row count, widening to ``new_cols`` >= c;
    ``fills`` fit the dtypes (bool, int32, int64).  Returns (rows, device,
    new widths as ints)."""
    n = len(bufs)
    if not (n == len(new_cols) == len(fills)) or not n:
        raise ValueError(f"{n} buffers, {len(new_cols)} widths, {len(fills)} fills")
    if n > cuda.DSTATE_MAX_ARRAYS:
        raise ValueError(f"{n} buffers exceed {cuda.DSTATE_MAX_ARRAYS}")
    rows, dev, di = bufs[0].shape[0], bufs[0].device, bufs[0].get_device()
    widths = [int(nc) for nc in new_cols]
    for i, b in enumerate(bufs):
        shape = b.shape
        if (len(shape) != 2 or shape[0] != rows or widths[i] < shape[1]
                or b.dtype not in _EXTEND_DTYPES or not b.is_contiguous()
                or b.get_device() != di):
            raise ValueError(f"buffer {i}: {b.dtype} {tuple(shape)} on {b.device} cannot "
                             f"widen to {widths[i]} columns")
        if b.dtype is torch.bool and fills[i] not in (0, 1, False, True):
            raise ValueError(f"buffer {i}: fill {fills[i]!r} for a bool table")
    return rows, dev, widths


def extend_desc(src_ptrs, dst_ptrs, old_cols, widths, elem_sizes, fills) -> ctypes.Array:
    """The packed host descriptor of csrc/dstate.cu's extend: one row of six
    int64 words a buffer (source, destination, old columns, new columns,
    element size, fill)."""
    words = [int(v) for row in zip(src_ptrs, dst_ptrs, old_cols, widths, elem_sizes, fills)
             for v in row]
    return (ctypes.c_longlong * len(words))(*words)


def dstate_extend_plain(bufs, new_cols, fills) -> tuple:
    """[N, c] -> fresh [N, c'] buffers: the old columns copied, the new ones
    the fill."""
    out = []
    for b, nc, fl in zip(bufs, new_cols, fills):
        wide = torch.full((b.shape[0], int(nc)), fl, dtype=b.dtype, device=b.device)
        wide[:, : b.shape[1]] = b
        out.append(wide)
    return tuple(out)


def dstate_extend(bufs, new_cols, fills) -> tuple:
    """Widen resident tables' vocabulary axis: the JAX package's
    ``dstate_extend`` (state.py:208).  Returns fresh [N, c'] buffers whose
    old columns hold the resident bytes and whose new columns hold the
    fill the host growth wrote; the old buffers are never written.  On
    CUDA one launch of ``csrc/dstate.cu`` widens every buffer from one
    packed descriptor (``extend_desc``).  Each output is one ``torch.empty``,
    a buffer of its own for the residency's later scatters: measured no
    dearer on the host than one allocation carved into views (PERF.md §6,
    ``chip_smoke.py --rounds``)."""
    rows, dev, widths = _extend_inputs(bufs, new_cols, fills)
    if dev.type == "cpu":
        return dstate_extend_plain(bufs, new_cols, fills)
    out = tuple(torch.empty((rows, nc), dtype=b.dtype, device=dev)
                for b, nc in zip(bufs, widths))
    if rows:
        cuda.DSTATE_EXTEND.launch(
            len(bufs), extend_desc([b.data_ptr() for b in bufs], [o.data_ptr() for o in out],
                                   [b.shape[1] for b in bufs], widths,
                                   [b.element_size() for b in bufs], fills),
            rows, cuda.device_index(dev), cuda.stream(dev),
        )
    return out


class ResidencyMismatch(AssertionError):
    """A resident device table diverged from its host-built oracle.  Raised
    by ``DeviceResidency.verify`` after invalidating, so the next read
    rebuilds cold instead of re-serving the divergent table."""


class _ResidentTable:
    """One family of resident buffers + its own sync watermark (apart from
    the engine's warm-carry watermark: a SCORE syncs the residency without
    touching the carry)."""

    __slots__ = ("attrs", "ver_attr", "bufs", "watermark", "shape_key", "audit_cursor", "upload",
                 "stage", "gate", "dev")

    def __init__(self, attrs: tuple, ver_attr: str, gated: bool = False, devices: bool = False):
        self.attrs = attrs
        self.ver_attr = ver_attr
        self.bufs: Optional[tuple] = None
        self.watermark = 0
        self.shape_key: Optional[tuple] = None
        self.audit_cursor = 0  # rotating sampled-audit window start
        # the cold adoption's staging (``dstate_rows``: one pinned staging
        # reused across adoptions, one copy a table; it holds page-locked
        # host memory of the largest adoption's size, up to twice it, as
        # long as the residency lives); the scatter's
        # staging, (the rows table) the gate's stage over its 12 raw
        # LoadAware rows and (the device table) the stage of
        # ``dev_feasible`` and ``ds_score`` over its rows, bound whenever
        # ``bufs`` are replaced; a scatter writes in place and keeps them
        # all
        self.upload = UploadStage()
        self.stage = ScatterStage()
        self.gate = GateStage() if gated else None
        self.dev = DeviceStage() if devices else None

    def adopt(self, bufs: tuple) -> None:
        """New resident buffers (a full upload, a capacity growth or a
        widening): the scatter's descriptor, the gate's and the device
        stage's are rebuilt for them."""
        self.bufs = bufs
        self.stage.bind(bufs)
        if self.gate is not None:
            self.gate.bind(bufs[:12])
        if self.dev is not None:
            self.dev.bind(bufs)


def _norm_device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceResidency:
    """The store's device-resident companion: the JAX package's
    ``DeviceResidency`` (state.py:309), three tables, one per stamp family:

    - ``rows``   — the la/nf node rows and the valid mask (``_row_ver``);
    - ``policy`` — the taint/label/anti-affinity rows (``_pp_row_ver``),
      the ``placement`` kernel's node inputs;
    - ``device`` — the device-inventory aggregates (``_dv_row_ver``), the
      ``dev_feasible`` and ``ds_score`` kernels' node inputs, with the
      ``DeviceStage`` both launch through.

    The tables live on one explicit device, bound by the first read; a
    read asking for another device raises.  A cold table adopts wholesale
    (``dstate_rows``: one pinned staging of its own, reused, and one copy
    into one slab of views); a warm one ships only the rows whose stamp moved
    past its watermark in one ``dstate_scatter``, gathered straight into
    the table's ``ScatterStage``; past
    ``scatter_max_frac`` of the capacity it re-uploads wholesale.  A
    vocabulary-axis growth recorded by the store (``note_vocab_growth``)
    widens the resident buffers on the device (``dstate_extend``) instead
    of re-uploading; a capacity growth or a dtype change rebuilds cold.
    A failed transfer or launch raises: nothing falls back to the host
    arrays (``device_state=False`` is the explicit host-built path).
    ``verify`` bit-compares against the host arrays."""

    #: serving reads between automatic bit-match audits (0 = never)
    verify_every = 64
    #: rows per table the automatic audit compares (a rotating window)
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
    _POLICY = ("_pp_label", "_pp_taint", "_pp_aa", "_pp_sig")
    _DEVICE = ("_dv_core", "_dv_mem", "_dv_full", "_dv_vfs", "_dv_alloc2", "_dv_used2")

    def __init__(self, state: "ClusterState", enabled: bool = True):
        self._state = state
        self.enabled = bool(enabled)
        self._tables: Dict[str, _ResidentTable] = {
            "rows": _ResidentTable(self._ROWS, "_row_ver", gated=True),
            "policy": _ResidentTable(self._POLICY, "_pp_row_ver"),
            "device": _ResidentTable(self._DEVICE, "_dv_row_ver", devices=True),
        }
        self.device: Optional[torch.device] = None
        # one-entry gated-la cache: SCORE and SCHEDULE in one cycle share
        # one dstate_gate launch
        self._gate_key: Optional[tuple] = None
        self._gate_val = None
        # the fill each widened attr's new columns took on the host
        # (``note_vocab_growth``): what dstate_extend writes
        self._extend_fill: Dict[str, object] = {}
        self.h2d_bytes_total = 0
        self.full_uploads = 0
        self.scatters = 0
        self.extends = 0
        self.last_dirty_rows = 0
        self.verifies = 0
        self._reads = 0

    def invalidate(self, table: Optional[str] = None) -> None:
        """Drop one table's resident buffers, or all: the next sync rebuilds
        cold (capacity growth, a failed audit)."""
        for name, t in self._tables.items():
            if table is None or name == table:
                t.bufs = None
                t.shape_key = None
                t.watermark = 0
        self._gate_key = None
        self._gate_val = None

    def is_warm(self, table: str = "rows") -> bool:
        return self._tables[table].bufs is not None

    def table_bytes(self, table: str) -> int:
        """Bytes of a table's resident buffers (0 when cold)."""
        t = self._tables[table]
        return 0 if t.bufs is None else sum(b.numel() * b.element_size() for b in t.bufs)

    def note_vocab_growth(self, attrs, fill) -> None:
        """``ClusterState._grow_vocab``'s hook: the fill the host growth
        wrote into each widened attr's new columns, so the next sync widens
        the resident buffers on the device instead of re-uploading."""
        for a in attrs:
            self._extend_fill[a] = fill

    def _bind(self, device) -> torch.device:
        d = _norm_device(device)
        if self.device is None:
            self.device = d
        elif d != self.device:
            raise ValueError(
                f"the resident tables live on {self.device}; a read asked for {d}"
            )
        return d

    def _vocab_extend(self, t: _ResidentTable, host, shape_key) -> bool:
        """The warm vocabulary-growth path: when a table's shape change only
        widens axis 1 of some [N, c] arrays (same rows, same dtypes, a fill
        on record for each widened one) and leaves the others as they were,
        widen the resident buffers with one ``dstate_extend``.  False for
        any other reshape: the caller rebuilds cold.  (Unlike the JAX
        package's, an array whose shape did not change may be 1-D, so the
        device table, whose full-free and VF counts are [N], widens warm
        too.)"""
        if t.bufs is None or t.shape_key is None:
            return False
        grow = []
        for k, ((oshape, odt), (nshape, ndt), attr) in enumerate(
                zip(t.shape_key, shape_key, t.attrs)):
            if odt != ndt:
                return False
            if oshape == nshape:
                continue
            if (len(oshape) != 2 or len(nshape) != 2 or oshape[0] != nshape[0]
                    or nshape[1] < oshape[1] or attr not in self._extend_fill):
                return False
            grow.append(k)
        if not grow:
            return False
        wide = dstate_extend([t.bufs[k] for k in grow], [host[k].shape[1] for k in grow],
                             [self._extend_fill[t.attrs[k]] for k in grow])
        bufs = list(t.bufs)
        for k, b in zip(grow, wide):
            bufs[k] = b
        t.adopt(tuple(bufs))
        t.shape_key = shape_key
        self.extends += 1
        return True

    def _sync(self, name: str) -> tuple:
        t, st = self._tables[name], self._state
        host = [getattr(st, a) for a in t.attrs]
        shape_key = tuple((a.shape, a.dtype) for a in host)
        ver = getattr(st, t.ver_attr)
        if t.bufs is None or t.shape_key != shape_key:
            if not self._vocab_extend(t, host, shape_key):
                # cold (first touch, capacity growth, invalidation)
                t.adopt(tuple(t.upload.upload(host, self.device)))
                t.shape_key = shape_key
                t.watermark = int(ver.max(initial=0))
                self.full_uploads += 1
                self.last_dirty_rows = host[0].shape[0]
                self.h2d_bytes_total += sum(a.nbytes for a in host)
                if name == "rows":
                    self._gate_key = None
                return t.bufs
            # widened warm: the rows whose stamps moved scatter below, at
            # the new width
        # a clean table's check: one max over the stamps, no index list
        if ver.max(initial=0) <= t.watermark:
            return t.bufs
        dirty = np.flatnonzero(ver > t.watermark)
        self.last_dirty_rows = int(dirty.size)
        if dirty.size >= self.scatter_max_frac * ver.shape[0]:
            t.bufs = None  # dense churn: re-upload wholesale
            return self._sync(name)
        db = next_bucket(int(dirty.size), 16)
        idx = np.full(db, dirty[0], dtype=np.int32)
        idx[: dirty.size] = dirty
        # the rows host[idx] straight into the staging: one copy and one
        # launch of dstate_scatter's kernel on a card
        t.stage.scatter(t.bufs, t.stage.gather(host, idx))
        t.watermark = int(ver.max(initial=0))
        self.scatters += 1
        self.h2d_bytes_total += idx.nbytes + db * t.stage.row_total
        if name == "rows":
            self._gate_key = None
        return t.bufs

    def serving_node_inputs(self, now: float, device):
        """(la_nodes, nf_nodes, valid) resident on ``device``, freshly
        synced and time-gated from ``now``.  The caller must not write
        them: clear a copy of ``valid`` to exclude nodes."""
        self._bind(device)
        bufs = self._sync("rows")
        self._reads += 1
        if self.verify_every and self._reads % self.verify_every == 0:
            self.verify(sample=self.verify_sample_rows)
        # every change of the rows table clears the key (``_sync``), so the
        # clock is the whole key: syncing another table keeps the gate
        key = float(now)
        if self._gate_key != key:
            la_args = self._state.la_args
            self._gate_val = self._tables["rows"].gate.gate(
                now, la_args.node_metric_expiration_seconds,
                bool(la_args.filter_expired_node_metrics),
            )
            self._gate_key = key
        return self._gate_val, NodeFitNodeArrays(*bufs[12:18]), bufs[18]

    def policy_rows(self, device) -> tuple:
        """(labels, taints, aa, sig) resident on ``device``, freshly synced:
        the ``placement`` kernel's node inputs."""
        self._bind(device)
        return self._sync("policy")

    def device_rows(self, device) -> tuple:
        """(core, mem, full, vfs, alloc2, used2) resident on ``device``,
        freshly synced: the ``dev_feasible`` / ``ds_score`` node inputs."""
        self._bind(device)
        return self._sync("device")

    def device_stage(self, device) -> DeviceStage:
        """The ``DeviceStage`` bound to the device table resident on
        ``device``, freshly synced: ``dev_feasible`` and ``ds_score`` over
        every node."""
        self._bind(device)
        self._sync("device")
        return self._tables["device"].dev

    def verify(self, tables: Optional[tuple] = None, sample: Optional[int] = None) -> int:
        """Bit-compare the warm resident tables against the live host arrays
        after syncing each: every row (``sample=None``) or a ``sample``-row
        rotating window per table.  Returns the number of arrays checked;
        raises ``ResidencyMismatch`` (after invalidating) on any
        divergence."""
        checked = 0
        for name, t in self._tables.items():
            if (tables is not None and name not in tables) or t.bufs is None:
                continue
            self._sync(name)
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
                        f"resident table {name!r} array {attr!r} diverged from the host "
                        f"oracle (rows {lo}:{hi})"
                    )
                checked += 1
        self.verifies += 1
        return checked


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
        # the descheduler's anomaly-detector counters (the ``anomaly`` wire
        # op, a controller effect): pool -> {names, anomaly, ab, norm} as
        # plain lists; a fresh Descheduler seeds its debounce streaks here
        self.desched_anomaly: Dict[str, dict] = {}
        # the NodeFit filter axis is fixed at config time (the Go shim
        # declares the scalar resources it schedules on)
        self.axis: List[str] = nf_snap.fixed_axis(extra_scalars, self.nf_args)
        self.rs: List[str] = [r for r, _ in self.nf_args.resources]
        self._R = len(self.la_args.resources)
        self._Rf = len(self.axis)
        self._Rs = len(self.rs)
        # NUMA topologies and device inventories (NRT / Device CRD
        # informers); allocations are tracked per pod, so an authoritative
        # re-inventory replays them
        self._topo: Dict[str, NodeTopologyInfo] = {}
        self._gpus: Dict[str, list] = {}  # name -> [GPUDevice]
        self._rdma: Dict[str, list] = {}  # name -> [RDMADevice]
        # name -> cpu id -> the exclusive-policy strings of its holders
        # ("" = none); len(list) is the CPU's refcount
        self._cpus_taken: Dict[str, Dict[int, List[str]]] = {}
        # pod key -> (node, gpu grants, rdma grants, cpuset, cpu_excl)
        self._dev_alloc: Dict[str, Tuple[str, list, list, list, str]] = {}
        # placement-policy indexes: nodes with hard taints, per-node counts
        # of assigned anti-affinity holders, and the inverted label indexes
        # the host-loop mask walks: (k, v) -> nodes carrying that label,
        # and (k, v) -> node -> count of assigned pods labelled so
        self._tainted_nodes: Set[str] = set()
        self._aa_holder_count: Dict[str, int] = {}
        self._node_label_rows: Dict[Tuple[str, str], Set[str]] = {}
        self._labels_indexed: Dict[str, Set[Tuple[str, str]]] = {}
        self._pod_label_rows: Dict[Tuple[str, str], Dict[str, int]] = {}
        # the policy and device rows' epochs: bumped only when a dense row
        # actually changes (compare-and-bump), so a twin fed the same ops
        # reproduces them
        self._policy_epoch = 0
        self._device_epoch = 0
        # interning vocabularies (insertion order = first-seen order)
        self._taint_vocab: Dict[Tuple[str, str, str], int] = {}
        self._label_vocab: Dict[Tuple[str, str], int] = {}
        self._aa_vocab: Dict[tuple, int] = {}  # anti-affinity selectors
        self._sig_vocab: Dict[tuple, int] = {}  # assigned-pod label sets
        self._fp_vocab: Dict[tuple, int] = {}  # device/topology fingerprints
        # vocab-axis buckets (power-of-two growth)
        self._Tb = self._Lb = self._Sb = self._Gb = _VOCAB_MIN
        self._Gm = _VOCAB_MIN  # device columns per node
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
        # placement-policy rows [cap, vocab bucket]; the vocab axis grows
        # apart, in _grow_vocab
        self._pp_taint = g("_pp_taint", self._Tb, bool, False)
        self._pp_label = g("_pp_label", self._Lb, bool, False)
        self._pp_aa = g("_pp_aa", self._Sb, np.int32)
        self._pp_sig = g("_pp_sig", self._Gb, np.int32)
        # device-inventory rows
        self._dv_core = g("_dv_core", self._Gm, np.int32, -1)
        self._dv_mem = g("_dv_mem", self._Gm, np.int32, -1)
        self._dv_full = g("_dv_full", 0, np.int32)
        self._dv_vfs = g("_dv_vfs", 0, np.int32)
        self._dv_alloc2 = g("_dv_alloc2", 2, np.int64)
        self._dv_used2 = g("_dv_used2", 2, np.int64)
        self._dv_in_gpus = g("_dv_in_gpus", 0, bool, False)
        self._dv_in_rdma = g("_dv_in_rdma", 0, bool, False)
        self._dv_in_topo = g("_dv_in_topo", 0, bool, False)
        self._dv_exact = g("_dv_exact", 0, bool, False)  # policy != none
        self._dv_fp = g("_dv_fp", 0, np.int64, -1)  # fingerprint id
        # per-row change stamps, one family per table
        self._row_ver = g("_row_ver", 0)
        self._pp_row_ver = g("_pp_row_ver", 0)
        self._dv_row_ver = g("_dv_row_ver", 0)
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
        self._content_ver += 1
        prev = self._nodes.get(node.name)
        if prev is not None:
            node.metric = prev.metric
            node.assigned_pods = prev.assigned_pods
        self._nodes[node.name] = node
        # node-label inverted index: diff what the INDEX holds against the
        # new label set (prev may be this same object)
        old_labels = self._labels_indexed.get(node.name, set())
        new_labels = set(node.labels.items())
        for pair in old_labels - new_labels:
            rows = self._node_label_rows.get(pair)
            if rows is not None:
                rows.discard(node.name)
                if not rows:
                    del self._node_label_rows[pair]
        for pair in new_labels - old_labels:
            self._node_label_rows.setdefault(pair, set()).add(node.name)
        if new_labels:
            self._labels_indexed[node.name] = new_labels
        else:
            self._labels_indexed.pop(node.name, None)
        if prev is None:
            # a Node built with assigned_pods then upserted indexes them too
            for ap in node.assigned_pods:
                self._index_pod_labels(node.name, ap.pod, +1)
        if any(t.get("effect") in ("NoSchedule", "NoExecute") for t in node.taints):
            self._tainted_nodes.add(node.name)
        else:
            self._tainted_nodes.discard(node.name)
        holders = sum(1 for ap in node.assigned_pods if ap.pod.anti_affinity)
        if holders:
            self._aa_holder_count[node.name] = holders
        else:
            self._aa_holder_count.pop(node.name, None)
        i = self._imap.add(node.name)
        if i >= self._cap:
            self._grow(next_bucket(i + 1, self._cap * 2))
        self._dirty.add(node.name)
        self._refresh_policy_row(node.name)
        # device/topology state may have raced ahead of the node's upsert
        self._refresh_device_row(node.name)
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
            # a removed node's pods release their quota, gang membership,
            # reservation allocations and device grants, as unassign_pod does
            self.quota.release(key)
            self.gangs.note_unassign(key)
            self.reservations.note_release(key)
            self.release_device_alloc(key)
        # the node's NRT and device inventories die with it
        self.remove_topology(name)
        self.remove_devices(name)
        self._cpus_taken.pop(name, None)
        self._tainted_nodes.discard(name)
        self._aa_holder_count.pop(name, None)
        for pair in self._labels_indexed.pop(name, set()):
            rows = self._node_label_rows.get(pair)
            if rows is not None:
                rows.discard(name)
                if not rows:
                    del self._node_label_rows[pair]
        for ap in node.assigned_pods:
            self._index_pod_labels(name, ap.pod, -1)
        i = self._imap.remove(name)
        self._dirty.discard(name)
        self._clear_row(i)
        self._zero_policy_row(i)
        self._zero_device_row(i)

    def update_metric(self, name: str, metric: NodeMetric) -> None:
        """NodeMetric status event; ignored for unknown nodes (the shim may
        race a metric ahead of its node, the next sync repairs it)."""
        self._content_ver += 1
        node = self._nodes.get(name)
        if node is None:
            return
        node.metric = metric
        self._dirty.add(name)

    # ------------------------------------------------- topology / devices

    def set_topology(self, name: str, info: NodeTopologyInfo) -> None:
        """NRT report for a node; may race ahead of the node's upsert."""
        self._content_ver += 1
        self._topo[name] = info
        self._cpus_taken.setdefault(name, {})
        self._refresh_device_row(name)

    def remove_topology(self, name: str) -> None:
        self._content_ver += 1
        self._topo.pop(name, None)
        self._refresh_device_row(name)

    def set_devices(self, name: str, gpus: list, rdma: list = ()) -> None:
        """Authoritative device inventory (Device CRD): fresh free state,
        then the tracked pod allocations on this node replay onto it."""
        self._content_ver += 1
        self._gpus[name] = list(gpus)
        self._rdma[name] = list(rdma)
        gpu_by_minor = {d.minor: d for d in self._gpus[name]}
        by_minor = {r.minor: r for r in self._rdma[name]}
        for entry in self._dev_alloc.values():
            node, galloc, ralloc = entry[0], entry[1], entry[2]
            if node != name:
                continue
            for minor, core, ratio in galloc:
                # a granted minor missing from the fresh inventory has
                # nothing to replay onto
                d = gpu_by_minor.get(minor)
                if d is not None:
                    d.core_free -= core
                    d.memory_ratio_free -= ratio
            for minor, vfs in ralloc:
                if minor in by_minor:
                    by_minor[minor].vfs_free -= vfs
        self._refresh_device_row(name)

    def remove_devices(self, name: str) -> None:
        self._content_ver += 1
        self._gpus.pop(name, None)
        self._rdma.pop(name, None)
        self._refresh_device_row(name)

    def available_cpus(self, name: str, max_ref_count: int = 1) -> List[int]:
        """CPUs whose refcount is below the sharing cap."""
        info = self._topo.get(name)
        if info is None:
            return []
        taken = self._cpus_taken.get(name, {})
        return [c for c in range(info.topo.num_cpus) if len(taken.get(c, ())) < max_ref_count]

    def cpu_allocs(self, name: str):
        """cpu id -> CPUAlloc for the node's held CPUs."""
        return cpu_allocs_from(self._cpus_taken.get(name, {}))

    def note_device_alloc(self, pod_key: str, node: str, gpu: list, rdma: list, cpuset: list,
                          cpu_excl: str = "") -> None:
        """Record and apply a pod's device/cpuset allocation, keyed by pod so
        the shim's authoritative assign and the engine's own assume
        reconcile instead of double counting.  A different allocation for a
        known pod releases the stale record first."""
        from koordinator_tpu_torch.core.deviceshare import apply_allocation

        self._content_ver += 1
        if not (gpu or rdma or cpuset):
            return
        new_entry = (node, [tuple(x) for x in gpu], [tuple(x) for x in rdma], list(cpuset),
                     cpu_excl)
        prev = self._dev_alloc.get(pod_key)
        if prev is not None:
            if (prev[0] == new_entry[0] and [tuple(x) for x in prev[1]] == new_entry[1]
                    and [tuple(x) for x in prev[2]] == new_entry[2]
                    and list(prev[3]) == new_entry[3] and prev[4] == cpu_excl):
                return  # identical replay: no-op
            self.release_device_alloc(pod_key)
        if gpu and node in self._gpus:
            apply_allocation(self._gpus[node], gpu)
        if rdma and node in self._rdma:
            by_minor = {r.minor: r for r in self._rdma[node]}
            for minor, vfs in rdma:
                if minor in by_minor:
                    by_minor[minor].vfs_free -= vfs
        if cpuset:
            held = self._cpus_taken.setdefault(node, {})
            for c in cpuset:
                held.setdefault(int(c), []).append(cpu_excl)
        self._dev_alloc[pod_key] = (node, list(gpu), list(rdma), list(cpuset), cpu_excl)
        self._refresh_device_row(node)

    def release_device_alloc(self, pod_key: str) -> None:
        self._content_ver += 1
        entry = self._dev_alloc.pop(pod_key, None)
        if entry is None:
            return
        node, gpu, rdma, cpuset, cpu_excl = entry
        if gpu and node in self._gpus:
            by_minor = {d.minor: d for d in self._gpus[node]}
            for minor, core, ratio in gpu:
                if minor in by_minor:
                    by_minor[minor].core_free += core
                    by_minor[minor].memory_ratio_free += ratio
        if rdma and node in self._rdma:
            by_minor = {r.minor: r for r in self._rdma[node]}
            for minor, vfs in rdma:
                if minor in by_minor:
                    by_minor[minor].vfs_free += vfs
        if cpuset:
            held = self._cpus_taken.get(node, {})
            for c in cpuset:
                pols = held.get(int(c))
                if pols is None:
                    continue
                if cpu_excl in pols:
                    pols.remove(cpu_excl)
                elif pols:
                    pols.pop()
                if not pols:
                    del held[int(c)]
        self._refresh_device_row(node)

    def _index_pod_labels(self, node_name: str, pod, delta: int) -> None:
        """Maintain the assigned-pod label inverted index."""
        for pair in pod.labels.items():
            rows = self._pod_label_rows.setdefault(pair, {})
            n = rows.get(node_name, 0) + delta
            if n > 0:
                rows[node_name] = n
            else:
                rows.pop(node_name, None)
                if not rows:
                    del self._pod_label_rows[pair]

    def assign_pod(self, node_name: str, assigned: AssignedPod) -> None:
        """podAssignCache assign (pod_assign_cache.go:47): pod assumed/bound
        on the node.  Re-assign of a known pod moves it.  An assign for a
        node not (yet) known is buffered and replayed on the node's upsert.
        A pod's device allocation annotation replays into the device
        state."""
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
        self._index_pod_labels(node_name, assigned.pod, +1)
        if assigned.pod.anti_affinity:
            self._aa_holder_count[node_name] = self._aa_holder_count.get(node_name, 0) + 1
        self._refresh_policy_row(node_name)
        # constraint-state hooks (idempotent by pod key): quota used walks
        # the group chain, gang membership counts toward waiting+bound
        # satisfaction
        if assigned.pod.quota:
            self.quota.consume(assigned.pod, assigned.pod.quota, assigned.pod.non_preemptible)
        if assigned.pod.gang:
            self.gangs.note_assign(key, assigned.pod.gang)
        da = assigned.pod.device_allocation
        if da:
            self.note_device_alloc(
                key, node_name, [tuple(x) for x in da.get("gpu", [])],
                [tuple(x) for x in da.get("rdma", [])], list(da.get("cpuset", [])),
                cpu_excl=assigned.pod.cpu_exclusive_policy or "",
            )

    def unassign_pod(self, pod_key: str) -> None:
        self._content_ver += 1
        self.quota.release(pod_key)
        self.gangs.note_unassign(pod_key)
        self.reservations.note_release(pod_key)
        self.release_device_alloc(pod_key)
        node_name = self._pod_node.pop(pod_key, None)
        if node_name is None:
            for aps in self._pending_assigns.values():
                aps[:] = [ap for ap in aps if ap.pod.key != pod_key]
            return
        node = self._nodes[node_name]
        for ap in node.assigned_pods:
            if ap.pod.key != pod_key:
                continue
            self._index_pod_labels(node_name, ap.pod, -1)
            if ap.pod.anti_affinity:
                n = self._aa_holder_count.get(node_name, 0) - 1
                if n > 0:
                    self._aa_holder_count[node_name] = n
                else:
                    self._aa_holder_count.pop(node_name, None)
            break
        node.assigned_pods = [ap for ap in node.assigned_pods if ap.pod.key != pod_key]
        self._dirty.add(node_name)
        self._refresh_policy_row(node_name)

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

    # ---------------------------------- placement-policy and device rows

    def _grow_vocab(self, attrs, bucket_attr: str, need: int, fill=0) -> None:
        """Widen the vocabulary axis of the given dense arrays to hold
        column ``need`` (power-of-two growth), and record the fill so the
        residency widens its buffers on the device."""
        b = getattr(self, bucket_attr)
        if need < b:
            return
        nb = b
        while nb <= need:
            nb <<= 1
        for attr in attrs:
            arr = getattr(self, attr)
            wide = np.full((arr.shape[0], nb), fill, dtype=arr.dtype)
            wide[:, : arr.shape[1]] = arr
            setattr(self, attr, wide)
        setattr(self, bucket_attr, nb)
        self.residency.note_vocab_growth(attrs, fill)

    def _intern(self, vocab: dict, key, attr: str, bucket_attr: str) -> int:
        i = vocab.get(key)
        if i is None:
            i = len(vocab)
            vocab[key] = i
            self._grow_vocab((attr,), bucket_attr, i)
        return i

    def _refresh_policy_row(self, name: str) -> None:
        """Recompute the node's dense taint/label/anti-affinity rows from
        the live objects; bump the policy epoch ONLY if something changed."""
        i = self._imap.get(name)
        node = self._nodes.get(name)
        if i is None or node is None:
            return
        t_ids = [
            # missing keys stay None: tolerates() tells an absent value
            # from an empty one
            self._intern(self._taint_vocab, (t.get("key"), t.get("value"), t.get("effect")),
                         "_pp_taint", "_Tb")
            for t in node.taints
            if t.get("effect") in ("NoSchedule", "NoExecute")
        ]
        l_ids = [self._intern(self._label_vocab, pair, "_pp_label", "_Lb")
                 for pair in node.labels.items()]
        aa_counts: Dict[int, int] = {}
        sig_counts: Dict[int, int] = {}
        for ap in node.assigned_pods:
            if ap.pod.anti_affinity:
                j = self._intern(self._aa_vocab, tuple(sorted(ap.pod.anti_affinity.items())),
                                 "_pp_aa", "_Sb")
                aa_counts[j] = aa_counts.get(j, 0) + 1
            if ap.pod.labels:
                j = self._intern(self._sig_vocab, tuple(sorted(ap.pod.labels.items())),
                                 "_pp_sig", "_Gb")
                sig_counts[j] = sig_counts.get(j, 0) + 1
        new_t = np.zeros(self._Tb, dtype=bool)
        new_t[t_ids] = True
        new_l = np.zeros(self._Lb, dtype=bool)
        new_l[l_ids] = True
        new_aa = np.zeros(self._Sb, dtype=np.int32)
        for j, c in aa_counts.items():
            new_aa[j] = c
        new_sig = np.zeros(self._Gb, dtype=np.int32)
        for j, c in sig_counts.items():
            new_sig[j] = c
        if (np.array_equal(self._pp_taint[i], new_t) and np.array_equal(self._pp_label[i], new_l)
                and np.array_equal(self._pp_aa[i], new_aa)
                and np.array_equal(self._pp_sig[i], new_sig)):
            return
        self._pp_taint[i] = new_t
        self._pp_label[i] = new_l
        self._pp_aa[i] = new_aa
        self._pp_sig[i] = new_sig
        self._policy_epoch += 1
        self._pp_row_ver[i] = self._policy_epoch

    def _zero_policy_row(self, i: int) -> None:
        if (self._pp_taint[i].any() or self._pp_label[i].any() or self._pp_aa[i].any()
                or self._pp_sig[i].any()):
            self._pp_taint[i] = False
            self._pp_label[i] = False
            self._pp_aa[i] = 0
            self._pp_sig[i] = 0
            self._policy_epoch += 1
            self._pp_row_ver[i] = self._policy_epoch

    def _device_fingerprint(self, name: str) -> Optional[tuple]:
        """The node's device/topology/cpuset identity: two nodes with equal
        fingerprints give identical joint-allocation answers for any
        request signature, so the engine walks once per (fingerprint,
        signature)."""
        gpus = self._gpus.get(name)
        rdma = self._rdma.get(name)
        info = self._topo.get(name)
        if gpus is None and rdma is None and info is None:
            return None
        return (
            tuple((d.minor, d.numa_node, d.pcie, d.core_free, d.memory_ratio_free)
                  for d in gpus or ()),
            tuple((r.minor, r.numa_node, r.pcie, r.vfs_free) for r in rdma or ()),
            None if info is None else (
                info.topo.sockets, info.topo.nodes_per_socket, info.topo.cores_per_node,
                info.topo.cpus_per_core, info.policy, info.max_ref_count,
            ),
            tuple(sorted((c, tuple(pols)) for c, pols in self._cpus_taken.get(name, {}).items())),
        )

    def _refresh_device_row(self, name: str) -> None:
        """Recompute the node's dense device-inventory row (free shares,
        full-free count, VF total, score aggregates, fingerprint id); bump
        the device epoch only on an actual change."""
        i = self._imap.get(name)
        if i is None:
            return
        gpus = self._gpus.get(name)
        rdma = self._rdma.get(name)
        info = self._topo.get(name)
        key = self._device_fingerprint(name)
        fp = -1 if key is None else self._fp_vocab.setdefault(key, len(self._fp_vocab))
        in_g, in_r, in_t = gpus is not None, rdma is not None, info is not None
        if (self._dv_fp[i] == fp and self._dv_in_gpus[i] == in_g and self._dv_in_rdma[i] == in_r
                and self._dv_in_topo[i] == in_t):
            return  # the fingerprint covers every derived column below
        ng = len(gpus) if gpus else 0
        if ng > self._Gm:
            self._grow_vocab(("_dv_core", "_dv_mem"), "_Gm", ng - 1, fill=-1)
        new_core = np.full(self._Gm, -1, dtype=np.int32)
        new_mem = np.full(self._Gm, -1, dtype=np.int32)
        for k, d in enumerate(gpus or ()):
            new_core[k] = d.core_free
            new_mem[k] = d.memory_ratio_free
        self._dv_core[i] = new_core
        self._dv_mem[i] = new_mem
        self._dv_full[i] = sum(1 for d in gpus or () if d.full_free())
        self._dv_vfs[i] = sum(r.vfs_free for r in rdma or ())
        self._dv_alloc2[i] = (100 * ng, 100 * ng)
        self._dv_used2[i] = (sum(100 - d.core_free for d in gpus or ()),
                             sum(100 - d.memory_ratio_free for d in gpus or ()))
        self._dv_in_gpus[i] = in_g
        self._dv_in_rdma[i] = in_r
        self._dv_in_topo[i] = in_t
        self._dv_exact[i] = in_t and info.policy != "none"
        self._dv_fp[i] = fp
        self._device_epoch += 1
        self._dv_row_ver[i] = self._device_epoch

    def _zero_device_row(self, i: int) -> None:
        if not (self._dv_in_gpus[i] or self._dv_in_rdma[i] or self._dv_in_topo[i]
                or self._dv_fp[i] != -1):
            return
        self._dv_core[i] = -1
        self._dv_mem[i] = -1
        self._dv_full[i] = 0
        self._dv_vfs[i] = 0
        self._dv_alloc2[i] = 0
        self._dv_used2[i] = 0
        self._dv_in_gpus[i] = False
        self._dv_in_rdma[i] = False
        self._dv_in_topo[i] = False
        self._dv_exact[i] = False
        self._dv_fp[i] = -1
        self._device_epoch += 1
        self._dv_row_ver[i] = self._device_epoch

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
    def num_live(self) -> int:
        return len(self._imap)

    @property
    def dirty_count(self) -> int:
        """Distinct node rows mutated since the last published snapshot:
        the APPLY reply's ``dirty`` field.  Only ``publish`` clears the
        dirty set here, so its size is the JAX store's ``_dirty_pub``."""
        return len(self._dirty)

    @property
    def policy_epoch(self) -> int:
        """Bumps whenever a node's taints, labels, or assigned-pod
        anti-affinity/label-signature row actually changes."""
        return self._policy_epoch

    @property
    def device_epoch(self) -> int:
        """Bumps whenever a node's device inventory, NUMA topology, or
        cpuset consumption row actually changes."""
        return self._device_epoch

    @property
    def content_key(self) -> tuple:
        """Equality token over the store's content within this process:
        node-side content (every mutator bumps ``_content_ver``), the policy
        and device epochs, and the gang, quota and reservation stores'
        versions."""
        return (self._content_ver, self._policy_epoch, self._device_epoch, self.gangs.version,
                self.quota.version, self.reservations.version)

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
        records when it is taken."""
        return (int(self._row_ver.max(initial=0)), int(self._pp_row_ver.max(initial=0)),
                int(self._dv_row_ver.max(initial=0)))

    def sched_dirty_rows(self, vers: tuple) -> np.ndarray:
        """Node rows whose la/nf, policy or device stamp advanced past the
        recorded watermarks (int32, sorted): exactly the columns a warm
        carry must refresh."""
        v0, v1, v2 = vers
        return np.flatnonzero((self._row_ver > v0) | (self._pp_row_ver > v1)
                              | (self._dv_row_ver > v2)).astype(np.int32)

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

    def set_desched_anomaly(self, pool: str, names, anomaly, ab, norm) -> None:
        """Adopt one pool's descheduler anomaly-detector counters (the
        ``anomaly`` wire op) as plain lists."""
        self.desched_anomaly[str(pool)] = {
            "names": [str(n) for n in names],
            "anomaly": [bool(x) for x in anomaly],
            "ab": [int(x) for x in ab],
            "norm": [int(x) for x in norm],
        }

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
