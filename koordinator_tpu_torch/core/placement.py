"""The placement-policy and device kernels of SCORE and SCHEDULE.

Three device programs the JAX package defines beside its engine
(service/engine.py): ``placement`` (``placement_mask_fn``, :276),
``dev_feasible`` (``device_feasible_fn``, :292) and ``ds_score``
(``nodefit_score`` under the deviceshare static, :384 and :899-942).  Each
evaluates per (request signature, node column) from the store's dense
policy or device rows and tiny per-signature inputs; the engine caches
the rows per signature and epoch.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel, or raises, for CUDA tensors (``csrc/placement.cu``,
``csrc/device.cu``).

The placement kernel's pod side is sparse: the JAX form multiplies
[M, vocab] indicator matrices into the [N, vocab] rows; here each
signature's selector pairs, untolerated taints, matching holder selectors
and selected label sets are CSR index lists (``PlacementSigs``) built on
the host from the same vocabulary walk, and the plain version is the same
gather, affordable at full width.  ``dev_feasible``'s signatures and
``ds_score``'s requests are host data too: packed into one block each
(``pack_device_sigs``, an int64 [M, 2] block), they ride in the launch's
parameters, and both kernels' node rows (the residency's device table) are
bound once in a ``DeviceStage``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.core.nodefit import (
    NodeFitNodeArrays,
    NodeFitPodArrays,
    NodeFitStatic,
    nodefit_score_plain,
)


class PlacementSigs(NamedTuple):
    """M signatures' placement inputs as CSR lists over the store's
    vocabulary columns (int32 host tensors; ``*_off`` [M+1], ``*_idx``
    [nnz])."""

    sel_off: torch.Tensor  # selector pairs present in the label vocab
    sel_idx: torch.Tensor
    sel_cnt: torch.Tensor  # [M] int32 selector pairs, absent ones included
    tol_off: torch.Tensor  # hard taints the signature does not tolerate
    tol_idx: torch.Tensor
    hold_off: torch.Tensor  # holder selectors that select the signature
    hold_idx: torch.Tensor
    aa_off: torch.Tensor  # assigned label sets the signature's anti-affinity selects
    aa_idx: torch.Tensor


def csr(lists) -> tuple:
    """(offsets [M+1] int32, indices [nnz] int32) of a list of index lists."""
    off = [0]
    flat = []
    for lst in lists:
        flat.extend(lst)
        off.append(len(flat))
    return torch.tensor(off, dtype=torch.int32), torch.tensor(flat, dtype=torch.int32)


def _segment_hits(rows: torch.Tensor, off: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[M, N] int64: for signature m, the sum over its listed columns of
    ``rows[:, col]`` (a gather and a prefix sum over the list)."""
    N = rows.shape[0]
    vals = rows[:, idx.long()].to(torch.int64)  # [N, nnz]
    cs = torch.cat([torch.zeros((N, 1), dtype=torch.int64, device=rows.device),
                    vals.cumsum(dim=1)], dim=1)
    o = off.long()
    return (cs[:, o[1:]] - cs[:, o[:-1]]).T


def placement_plain(sigs: PlacementSigs, labels, taints, aa_cnt, sig_cnt) -> torch.Tensor:
    """[M, N] bool: a node is open to signature m iff it carries every
    selector pair (a pair absent from the vocab counts in ``sel_cnt`` and
    never matches), no untolerated hard taint, no assigned pod whose
    anti-affinity selects m, and no assigned pod m's anti-affinity
    selects."""
    sigs = PlacementSigs(*(t.to(labels.device) for t in sigs))
    ok = _segment_hits(labels, sigs.sel_off, sigs.sel_idx) == sigs.sel_cnt.long()[:, None]
    ok &= _segment_hits(taints, sigs.tol_off, sigs.tol_idx) <= 0
    ok &= _segment_hits(aa_cnt, sigs.hold_off, sigs.hold_idx) <= 0
    ok &= _segment_hits(sig_cnt, sigs.aa_off, sigs.aa_idx) <= 0
    return ok


def _check_placement(sigs: PlacementSigs, labels, taints, aa_cnt, sig_cnt) -> tuple:
    N, dev = labels.shape[0], labels.device
    M = sigs.sel_cnt.shape[0]
    vocab = {}
    for what, t, dtype in (("labels", labels, torch.bool), ("taints", taints, torch.bool),
                           ("aa_cnt", aa_cnt, torch.int32), ("sig_cnt", sig_cnt, torch.int32)):
        if t.dtype != dtype or t.dim() != 2 or t.shape[0] != N or t.device != dev:
            raise ValueError(f"{what}: expected {dtype} [{N}, c] on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        vocab[what] = t.shape[1]
    if sigs.sel_cnt.dtype != torch.int32 or sigs.sel_cnt.dim() != 1:
        raise ValueError("sel_cnt: expected [M] int32")
    for name, cols in (("sel", "labels"), ("tol", "taints"), ("hold", "aa_cnt"),
                       ("aa", "sig_cnt")):
        off, idx = getattr(sigs, f"{name}_off"), getattr(sigs, f"{name}_idx")
        if (off.dtype != torch.int32 or idx.dtype != torch.int32 or tuple(off.shape) != (M + 1,)
                or idx.dim() != 1 or off.device.type != "cpu" or idx.device.type != "cpu"):
            raise ValueError(f"{name} lists: expected int32 host offsets [{M + 1}] and indices, "
                             f"got {off.dtype} {tuple(off.shape)} / {idx.dtype} "
                             f"{tuple(idx.shape)} on {idx.device}")
        if int(off[0]) != 0 or int(off[-1]) != idx.numel() or bool((off[1:] < off[:-1]).any()):
            raise ValueError(f"{name} offsets are not a partition of the {idx.numel()} indices")
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= vocab[cols]):
            raise ValueError(f"{name} indices outside [0, {vocab[cols]})")
    return M, N, dev


#: node columns a block of csrc/placement.cu takes (kTile), and the shared
#: memory a phase of its gather may fill: a union of columns wider than
#: this goes in phases (csrc/placeplan.cuh)
PLACEMENT_TILE = 64
PLACEMENT_SMEM = 40 * 1024


def _lists_fine(sigs: PlacementSigs, rows) -> int:
    """M when the node rows and the lists' dtypes, shapes and devices are
    what ``placement`` takes, else -1 (attributes only; no data read)."""
    labels, taints, aa_cnt, sig_cnt = rows
    N, dev = labels.shape[0], labels.device
    sel_cnt = sigs.sel_cnt
    if not (sel_cnt.dtype == torch.int32 and sel_cnt.dim() == 1
            and labels.dtype == torch.bool and taints.dtype == torch.bool
            and aa_cnt.dtype == torch.int32 and sig_cnt.dtype == torch.int32
            and all(t.dim() == 2 and t.shape[0] == N and t.device == dev for t in rows)):
        return -1
    M = sel_cnt.shape[0]
    for t in sigs:
        if t.dtype is not torch.int32 or t.ndim != 1 or not t.is_cpu:
            return -1
    if not (sigs.sel_off.shape[0] == sigs.tol_off.shape[0] == sigs.hold_off.shape[0]
            == sigs.aa_off.shape[0] == M + 1):
        return -1
    return M


def host_lists(sigs: PlacementSigs, rows) -> tuple:
    """The plan's inputs: ONE host int32 array of the lists (the four
    offset arrays, ``sel_cnt``, the four index arrays) and each list's
    entries then each table's width (ctypes int32 [8])."""
    idxs = (sigs.sel_idx, sigs.tol_idx, sigs.hold_idx, sigs.aa_idx)
    flat = torch.cat([sigs.sel_off, sigs.tol_off, sigs.hold_off, sigs.aa_off, sigs.sel_cnt,
                      *idxs])
    return flat, (ctypes.c_int * 8)(*(t.shape[0] for t in idxs), *(t.shape[1] for t in rows))


def placement_plan(sigs: PlacementSigs, rows) -> tuple:
    """The calling thread's next launch planned by the library
    (csrc/placeplan.cuh, ``koord_placement_plan``): the lists checked and
    rewritten as positions in the union of the columns they name, the
    gather's phases.  Returns (M, the int32 descriptor's words, the largest
    phase's shared memory, whether a table spans two phases); on any fault
    in the lists the sequential checks (``_check_placement``) raise the
    first error in their order.  Needs the library (a CUDA toolkit)."""
    M = _lists_fine(sigs, rows)
    if M >= 0:
        flat, dims = host_lists(sigs, rows)
        info = (ctypes.c_int * 4)()
        cuda.PLACEMENT_PLAN(flat.data_ptr(), M, dims, PLACEMENT_SMEM, info)
        if info[0] == 0:
            return M, info[1], info[2], bool(info[3])
    _check_placement(sigs, *rows)
    raise ValueError("placement: sel_cnt and the lists must be int32 host tensors")


def placement(sigs: PlacementSigs, labels, taints, aa_cnt, sig_cnt) -> torch.Tensor:
    """The ``placement`` kernel: [M, N] bool, node open to signature m.
    Node inputs are the store's policy rows (labels [N, Lb] bool, taints
    [N, Tb] bool, aa_cnt [N, Sb] int32, sig_cnt [N, Gb] int32) on the
    device; the signatures' lists are host tensors, concatenated into one
    host array.  On CUDA the library checks and plans them on the host
    (``placement_plan``), and one launch, its descriptor in the launch's
    parameters, has a block a tile of node columns gather their union
    columns into shared memory once, then evaluate every signature from
    there.  On the CPU the checks run here and the plain version
    computes."""
    rows = (labels, taints, aa_cnt, sig_cnt)
    dev = labels.device
    if dev.type == "cpu":
        _check_placement(sigs, *rows)
        return placement_plain(sigs, *rows)
    M, words, _, carries = placement_plan(sigs, rows)
    N = labels.shape[0]
    out = torch.empty((M, N), dtype=torch.bool, device=dev)
    if M and N:
        rows = tuple(t.contiguous() for t in rows)
        acc = torch.empty((M, N), dtype=torch.int64, device=dev) if carries else None
        ddesc = (torch.empty(words, dtype=torch.int32, device=dev)
                 if words > cuda.PLACEMENT_PARAM_WORDS else None)
        cuda.PLACEMENT.launch(*(t.data_ptr() for t in rows), *(t.shape[1] for t in rows), N,
                              0 if acc is None else acc.data_ptr(),
                              0 if ddesc is None else ddesc.data_ptr(), out.data_ptr(),
                              cuda.device_index(dev), cuda.stream(dev))
    return out


class DeviceSigs(NamedTuple):
    """M device-request signatures of the policy-free dense check, each
    [M] (bool or int32), host data (numpy arrays or CPU tensors)."""

    has_gpu: torch.Tensor
    is_multi: torch.Tensor
    count: torch.Tensor  # full devices a multi-GPU request takes
    core_req: torch.Tensor  # a partial share's core percent
    ratio_req: torch.Tensor  # and memory ratio
    rdma_need: torch.Tensor  # VFs the node's RDMA total must hold
    sig_valid: torch.Tensor


#: a packed signature's int32 words (csrc/device.cu kSigWords): the flags,
#: count, core_req, ratio_req, rdma_need
SIG_WORDS = 5
SIG_FLAGS, SIG_COUNT, SIG_CORE_REQ, SIG_RATIO_REQ, SIG_RDMA_NEED = range(SIG_WORDS)
#: the flags word's bits (csrc/device.cu SigFlag)
SIG_HAS_GPU, SIG_IS_MULTI, SIG_VALID = 1, 2, 4
_SIG_BOOL = {"has_gpu": SIG_HAS_GPU, "is_multi": SIG_IS_MULTI, "sig_valid": SIG_VALID}
_SIG_INT = {"count": SIG_COUNT, "core_req": SIG_CORE_REQ, "ratio_req": SIG_RATIO_REQ,
            "rdma_need": SIG_RDMA_NEED}
_SIG_FIELD = {name: k for k, name in enumerate(DeviceSigs._fields)}
_BOOL, _INT32 = np.dtype(np.bool_), np.dtype(np.int32)


def _host_array(name: str, t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if not t.is_cpu:
            raise ValueError(f"{name}: the signatures are host data (numpy or CPU tensors), "
                             f"got a tensor on {t.device}")
        return t.numpy()
    return np.asarray(t)


def pack_device_sigs(sigs: DeviceSigs) -> np.ndarray:
    """The signatures as one host block, [M, ``SIG_WORDS``] int32 (the flags
    word, then count, core_req, ratio_req and rdma_need), as
    ``csrc/device.cu`` reads them from the launch's parameters.  Raises
    ``ValueError`` on a field of another dtype or length, or on the card."""
    cols = [_host_array(name, t) for name, t in zip(DeviceSigs._fields, sigs)]
    M = cols[0].shape[0] if cols[0].ndim == 1 else -1
    for name, a in zip(DeviceSigs._fields, cols):
        want = _BOOL if name in _SIG_BOOL else _INT32
        if a.dtype != want or a.shape != (M,):
            raise ValueError(f"{name}: expected {want} ({M},), got {a.dtype} {a.shape}")
    block = np.empty((M, SIG_WORDS), dtype=np.int32)
    block[:, SIG_FLAGS] = (cols[0].view(np.uint8) | (cols[1].view(np.uint8) << 1)
                           | (cols[6].view(np.uint8) << 2))
    for name, k in _SIG_INT.items():
        block[:, k] = cols[_SIG_FIELD[name]]
    return block


def unpack_device_sigs(block: np.ndarray) -> DeviceSigs:
    """``pack_device_sigs``' inverse: the seven fields as CPU tensors."""
    flags = block[:, SIG_FLAGS]
    return DeviceSigs(*(
        torch.from_numpy((flags & _SIG_BOOL[name]) != 0) if name in _SIG_BOOL
        else torch.from_numpy(np.ascontiguousarray(block[:, _SIG_INT[name]]))
        for name in DeviceSigs._fields))


def _sig_block(sigs) -> np.ndarray:
    """A call's signatures as the packed host block: ``DeviceSigs`` are
    packed, a block (numpy [M, ``SIG_WORDS``] int32, C order) is taken as it
    is."""
    if (type(sigs) is np.ndarray and sigs.dtype == np.int32 and sigs.ndim == 2
            and sigs.shape[1] == SIG_WORDS and sigs.flags.c_contiguous):
        return sigs
    if isinstance(sigs, DeviceSigs):
        return pack_device_sigs(sigs)
    block = _host_array("signatures", sigs)
    if block.dtype != np.int32 or block.ndim != 2 or block.shape[1] != SIG_WORDS:
        raise ValueError(f"signatures: expected a DeviceSigs or an int32 [M, {SIG_WORDS}] "
                         f"block, got {block.dtype} {block.shape}")
    return np.ascontiguousarray(block)


def dev_feasible_plain(core, mem, full, vfs, sigs: DeviceSigs) -> torch.Tensor:
    """[M, N] bool joint-allocation feasibility for policy-free nodes: a
    partial share needs ONE device with enough core and memory ratio, a
    multi-GPU request ``count`` fully free devices, then the VF total and
    the signature's validity.  Padded device slots hold -1 and never
    pass.  The signatures go to the rows' device."""
    sigs = DeviceSigs(*(torch.as_tensor(t).to(core.device) for t in sigs))
    partial = ((core[None, :, :] >= sigs.core_req[:, None, None])
               & (mem[None, :, :] >= sigs.ratio_req[:, None, None])).any(dim=-1)
    multi = full[None, :] >= sigs.count[:, None]
    gpu_ok = torch.where(sigs.is_multi[:, None], multi, partial)
    gpu_ok = torch.where(sigs.has_gpu[:, None], gpu_ok, torch.ones_like(gpu_ok))
    return gpu_ok & (vfs[None, :] >= sigs.rdma_need[:, None]) & sigs.sig_valid[:, None]


_FEAS_ROWS = (("core", 2), ("mem", 2), ("full", 1), ("vfs", 1))
_AGG_ROWS = ("alloc2", "used2")


def _device_rows(rows) -> tuple:
    """Check the node rows a ``DeviceStage`` binds: ``dev_feasible``'s core
    and mem [N, Gm] int32, full and vfs [N] int32 (four ``None`` for a
    stage that only scores), then ``ds_score``'s aggregates alloc2 and
    used2 [N, 2] int64 where given; one device, each contiguous (the
    kernels read each through its base pointer, so a strided view is
    refused rather than read as other elements).  Returns (N, Gm, device),
    Gm 0 without the feasibility rows."""
    feas, aggs = rows[0] is not None, len(rows) > 4
    if not feas and (not aggs or any(t is not None for t in rows[:4])):
        raise ValueError("device rows: expected core, mem, full and vfs, or four None before "
                         "alloc2 and used2")
    ref = rows[0] if feas else rows[4]
    N, dev = ref.shape[0], ref.device
    Gm = (ref.shape[1] if ref.dim() == 2 else -1) if feas else 0
    checks = []
    if feas:
        checks += [(what, t, torch.int32, (N, Gm) if dims == 2 else (N,))
                   for (what, dims), t in zip(_FEAS_ROWS, rows)]
    if aggs:
        checks += [(what, t, torch.int64, (N, 2)) for what, t in zip(_AGG_ROWS, rows[4:6])]
    for what, t, dtype, shape in checks:
        if (t is None or t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            got = ("None" if t is None else f"{t.dtype} {tuple(t.shape)} stride "
                   f"{tuple(t.stride())} on {t.device}")
            raise ValueError(f"{what}: expected a contiguous {dtype} {shape} on {dev}, got {got}")
    return N, Gm, dev


def _req_block(reqs) -> np.ndarray:
    """A call's requests as one host block, [M, 2] int64 in C order (core
    percent, memory ratio), as ``csrc/device.cu`` reads them from the
    launch's parameters: a numpy block is taken as it is, a CPU tensor
    viewed; requests on a card raise ``ValueError``."""
    if (type(reqs) is np.ndarray and reqs.dtype == np.int64 and reqs.ndim == 2
            and reqs.shape[1] == 2 and reqs.flags.c_contiguous):
        return reqs
    block = _host_array("requests", reqs)
    if block.dtype != np.int64 or block.ndim != 2 or block.shape[1] != 2:
        raise ValueError(f"requests: expected an int64 [M, 2] block, got {block.dtype} "
                         f"{block.shape}")
    return np.ascontiguousarray(block)


class DeviceStage:
    """``dev_feasible`` and ``ds_score`` over one set of device rows:
    ``bind`` checks the rows (core, mem, full, vfs, then the aggregates
    alloc2 and used2 where given, as the residency's device table holds
    them) once and packs their pointers at the column range ``cols`` (a
    node shard's, or all), its width, Gm and the device index into one host
    descriptor, again only when the rows are replaced or moved.
    ``feasible`` then launches ``csrc/device.cu``'s feasibility once on a
    card, the signatures in the launch's parameters (past
    ``cuda.DEV_SIG_CAP`` of them, uploaded in one copy), into a fresh [M,
    n] bool output; ``score`` launches its deviceshare score once, the
    requests in the launch's parameters (past ``cuda.DS_REQ_CAP``, one
    upload) and the weight applied in the kernel, into a fresh [M, n] int64
    output.  On the CPU both run their plain versions.  The stage keeps the
    rows it is bound to."""

    def __init__(self):
        self.binds = 0  # descriptors built
        self.rows: tuple = ()
        self.cols: Optional[tuple] = None
        self.device: Optional[torch.device] = None
        # ctypes int64 [9]: the four feasibility rows' pointers, n, Gm, the
        # device, the two aggregates' pointers (0 for rows not bound)
        self.desc = None
        self._key: tuple = ()
        self._desc_ptr = 0
        self._n = 0
        self._feas = self._aggs = False

    def bind(self, rows, cols: Optional[tuple] = None) -> None:
        N, Gm, dev = _device_rows(rows)
        lo, hi = (0, N) if cols is None else cols
        if not 0 <= lo <= hi <= N:
            raise ValueError(f"columns [{lo}, {hi}) outside the {N} rows")
        self.rows, self.cols, self._key = tuple(rows), cols, self._key_of(rows, cols)
        self.device, self._n = dev, hi - lo
        self._feas, self._aggs = rows[0] is not None, len(rows) > 4
        if dev.type == "cuda":
            # each row's pointer at column lo (bytes a node: core and mem 4
            # Gm, full and vfs 4, alloc2 and used2 16); 0 where not bound
            ptrs = [t.data_ptr() + lo * math.prod(t.shape[1:]) * t.element_size()
                    if t is not None else 0
                    for t in tuple(rows[:6]) + (None,) * (6 - len(rows))]
            self.desc = (ctypes.c_longlong * 9)(*ptrs[:4], hi - lo, Gm, cuda.device_index(dev),
                                                *ptrs[4:])
            self._desc_ptr = ctypes.addressof(self.desc)
        else:
            self.desc, self._desc_ptr = None, 0
        self.binds += 1

    @staticmethod
    def _key_of(rows, cols) -> tuple:
        # the rows' identity, and each bound row's pointer, length and
        # layout (what the descriptor holds; a dtype cannot change in place)
        return tuple(map(id, rows)) + tuple(
            (t.data_ptr(), t.numel(), t.is_contiguous()) for t in rows[:6] if t is not None
        ) + (cols,)

    def bound_to(self, rows, cols: Optional[tuple] = None) -> bool:
        """Whether ``rows`` are the very rows bound at ``cols``, each still
        over the same memory: a row moved to new storage under the same
        tensor (``set_``, a ``resize_`` that reallocates) rebinds."""
        return self._key == self._key_of(rows, cols)

    def _cols(self, rows) -> tuple:
        lo, hi = (0, self._n) if self.cols is None else self.cols
        return tuple(t[lo:hi] for t in rows)

    def feasible(self, sigs) -> torch.Tensor:
        """[M, n] bool for the signatures (``DeviceSigs`` of host arrays, or
        their packed block); a signature on the card raises ``ValueError``
        before any launch, as does a stage bound without the feasibility
        rows."""
        if not self._feas:
            raise ValueError("this DeviceStage binds no feasibility rows (core, mem, full, vfs)")
        block = _sig_block(sigs)
        M = block.shape[0]
        if self._desc_ptr == 0:
            return dev_feasible_plain(*self._cols(self.rows[:4]), unpack_device_sigs(block))
        out = torch.empty((M, self._n), dtype=torch.bool, device=self.device)
        if M and self._n:
            # past the launch parameters' cap, the block in one copy
            dblock = (torch.from_numpy(block).to(self.device) if M > cuda.DEV_SIG_CAP
                      else None)
            cuda.DEV_FEASIBLE.launch(self._desc_ptr, block.__array_interface__["data"][0],
                                     0 if dblock is None else dblock.data_ptr(), M,
                                     out.data_ptr(), cuda.stream(self.device))
        return out

    def score(self, reqs, weight: int = 1) -> torch.Tensor:
        """[M, n] int64: the deviceshare binpack score of the GPU requests
        (host data: an int64 [M, 2] numpy block of (core percent, memory
        ratio), or a CPU tensor) times ``weight``, wrapping as int64; a
        request block on the card raises ``ValueError`` before any launch,
        as does a stage bound without the aggregates."""
        if not self._aggs:
            raise ValueError("this DeviceStage binds no aggregates (alloc2, used2)")
        block = _req_block(reqs)
        M, weight = block.shape[0], int(weight)
        if self._desc_ptr == 0:
            alloc2, used2 = self._cols(self.rows[4:6])
            return ds_score_plain(torch.from_numpy(block).to(alloc2.device), alloc2,
                                  used2) * weight
        out = torch.empty((M, self._n), dtype=torch.int64, device=self.device)
        if M and self._n:
            # past the launch parameters' cap, the block in one copy
            dblock = (torch.from_numpy(block).to(self.device) if M > cuda.DS_REQ_CAP
                      else None)
            cuda.DS_SCORE.launch(self._desc_ptr, block.__array_interface__["data"][0],
                                 0 if dblock is None else dblock.data_ptr(), M, weight,
                                 out.data_ptr(), cuda.stream(self.device))
        return out


# the stages of calls that name their rows each time (tests, studies); the
# residency keeps one bound to its device table
_DEV = DeviceStage()
_DS = DeviceStage()


def dev_feasible(core, mem, full, vfs, sigs) -> torch.Tensor:
    """The ``dev_feasible`` kernel: [M, N] bool from the device rows (core,
    mem [N, Gm] int32, full, vfs [N] int32, contiguous) and the signatures
    on the host (``DeviceSigs`` of numpy arrays or CPU tensors, or their
    ``pack_device_sigs`` block).  Through a ``DeviceStage``, rebound when the
    rows change or move; on CUDA one launch, a thread a node column over a
    block row's signatures, the signatures in the launch's parameters."""
    rows = (core, mem, full, vfs)
    if not _DEV.bound_to(rows):
        _DEV.bind(rows)
    return _DEV.feasible(sigs)


#: the deviceshare scorer's static: MostAllocated (binpack) over (core,
#: memory ratio), weights (1, 1), both dimensions bypassed when the pod
#: asks none (service/engine.py:925-936 in the JAX package)
DS_STATIC = NodeFitStatic(always_check=(False, False), scalar_bypass=(True, True),
                          weights=(1, 1), strategy="MostAllocated")


def ds_score_plain(req, alloc2, used2) -> torch.Tensor:
    """[M, N] int64 ``nodefit_score_plain`` under ``DS_STATIC``."""
    M, N = req.shape[0], alloc2.shape[0]
    pods = NodeFitPodArrays(req=req, req_score=req,
                            has_any_request=torch.ones(M, dtype=torch.bool, device=req.device))
    nodes = NodeFitNodeArrays(
        alloc=alloc2, requested=used2,
        num_pods=torch.zeros(N, dtype=torch.int64, device=req.device),
        allowed_pods=torch.full((N,), 1 << 30, dtype=torch.int64, device=req.device),
        alloc_score=alloc2, req_score=used2,
    )
    return nodefit_score_plain(pods, nodes, DS_STATIC)


def ds_score(req, alloc2, used2) -> torch.Tensor:
    """The ``ds_score`` kernel: the deviceshare binpack score of M GPU
    requests (req [M, 2] int64, core and memory ratio, on the aggregates'
    device) against the device aggregates (alloc2, used2 [N, 2] int64,
    contiguous), rounded as ``core/nodefit.py`` rounds.  Through a
    ``DeviceStage`` bound to the aggregates alone, rebound when they change
    or move; on CUDA the requests are read back into the launch's
    parameters (the engine passes its own host block to its stage), one
    launch, a thread a node column."""
    M, N, dev = req.shape[0], alloc2.shape[0], alloc2.device
    for what, t, shape in (("req", req, (M, 2)), ("alloc2", alloc2, (N, 2)),
                           ("used2", used2, (N, 2))):
        if t.dtype != torch.int64 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{what}: expected int64 {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    rows = (None,) * 4 + (alloc2, used2)
    if not _DS.bound_to(rows):
        _DS.bind(rows)
    return _DS.score(req.cpu())
