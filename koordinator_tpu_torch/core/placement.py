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
gather, affordable at full width.
"""

from __future__ import annotations

from typing import NamedTuple

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


def placement(sigs: PlacementSigs, labels, taints, aa_cnt, sig_cnt) -> torch.Tensor:
    """The ``placement`` kernel: [M, N] bool, node open to signature m.
    Node inputs are the store's policy rows (labels [N, Lb] bool, taints
    [N, Tb] bool, aa_cnt [N, Sb] int32, sig_cnt [N, Gb] int32) on the
    device; the signatures' lists are host tensors, checked there and
    shipped in one copy.  On CUDA one thread per (signature, node) walks
    the signature's lists."""
    M, N, dev = _check_placement(sigs, labels, taints, aa_cnt, sig_cnt)
    if dev.type == "cpu":
        return placement_plain(sigs, labels, taints, aa_cnt, sig_cnt)
    out = torch.empty((M, N), dtype=torch.bool, device=dev)
    rows = [t.contiguous() for t in (labels, taints, aa_cnt, sig_cnt)]
    flat = torch.cat(list(sigs)).pin_memory().to(dev, non_blocking=True)
    lists = flat.split([t.numel() for t in sigs])
    if M and N:
        cuda.PLACEMENT.launch(
            *(t.data_ptr() for t in lists), *(t.data_ptr() for t in rows),
            *(t.shape[1] for t in rows), M, N, out.data_ptr(), cuda.device_index(dev),
            cuda.stream(dev),
        )
    return out


class DeviceSigs(NamedTuple):
    """M device-request signatures of the policy-free dense check, each
    [M] (bool or int32)."""

    has_gpu: torch.Tensor
    is_multi: torch.Tensor
    count: torch.Tensor  # full devices a multi-GPU request takes
    core_req: torch.Tensor  # a partial share's core percent
    ratio_req: torch.Tensor  # and memory ratio
    rdma_need: torch.Tensor  # VFs the node's RDMA total must hold
    sig_valid: torch.Tensor


def dev_feasible_plain(core, mem, full, vfs, sigs: DeviceSigs) -> torch.Tensor:
    """[M, N] bool joint-allocation feasibility for policy-free nodes: a
    partial share needs ONE device with enough core and memory ratio, a
    multi-GPU request ``count`` fully free devices, then the VF total and
    the signature's validity.  Padded device slots hold -1 and never
    pass."""
    partial = ((core[None, :, :] >= sigs.core_req[:, None, None])
               & (mem[None, :, :] >= sigs.ratio_req[:, None, None])).any(dim=-1)
    multi = full[None, :] >= sigs.count[:, None]
    gpu_ok = torch.where(sigs.is_multi[:, None], multi, partial)
    gpu_ok = torch.where(sigs.has_gpu[:, None], gpu_ok, torch.ones_like(gpu_ok))
    return gpu_ok & (vfs[None, :] >= sigs.rdma_need[:, None]) & sigs.sig_valid[:, None]


def _check_device(core, mem, full, vfs, sigs: DeviceSigs) -> tuple:
    N, dev = core.shape[0], core.device
    Gm = core.shape[1] if core.dim() == 2 else -1
    M = sigs.has_gpu.shape[0]
    for what, t, dtype, shape in (("core", core, torch.int32, (N, Gm)),
                                  ("mem", mem, torch.int32, (N, Gm)),
                                  ("full", full, torch.int32, (N,)),
                                  ("vfs", vfs, torch.int32, (N,))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{what}: expected {dtype} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in zip(DeviceSigs._fields, sigs):
        want = torch.bool if name in ("has_gpu", "is_multi", "sig_valid") else torch.int32
        if t.dtype != want or tuple(t.shape) != (M,) or t.device != dev:
            raise ValueError(f"{name}: expected {want} ({M},) on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return M, N, Gm, dev


def dev_feasible(core, mem, full, vfs, sigs: DeviceSigs) -> torch.Tensor:
    """The ``dev_feasible`` kernel: [M, N] bool from the device rows (core,
    mem [N, Gm] int32, full, vfs [N] int32).  On CUDA one thread per
    (signature, node) loops over the node's Gm device slots."""
    M, N, Gm, dev = _check_device(core, mem, full, vfs, sigs)
    if dev.type == "cpu":
        return dev_feasible_plain(core, mem, full, vfs, sigs)
    out = torch.empty((M, N), dtype=torch.bool, device=dev)
    rows = [t.contiguous() for t in (core, mem, full, vfs)]
    if M and N:
        cuda.DEV_FEASIBLE.launch(
            *(t.data_ptr() for t in rows), *(t.data_ptr() for t in sigs), M, N, Gm,
            out.data_ptr(), cuda.device_index(dev), cuda.stream(dev),
        )
    return out


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
    requests (req [M, 2] int64, core and memory ratio) against the device
    aggregates (alloc2, used2 [N, 2] int64), rounded as ``core/nodefit.py``
    rounds.  On CUDA one thread per (request, node)."""
    M, N, dev = req.shape[0], alloc2.shape[0], alloc2.device
    for what, t, shape in (("req", req, (M, 2)), ("alloc2", alloc2, (N, 2)),
                           ("used2", used2, (N, 2))):
        if t.dtype != torch.int64 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{what}: expected int64 {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if dev.type == "cpu":
        return ds_score_plain(req, alloc2, used2)
    out = torch.empty((M, N), dtype=torch.int64, device=dev)
    rows = [t.contiguous() for t in (req, alloc2, used2)]
    if M and N:
        cuda.DS_SCORE.launch(*(t.data_ptr() for t in rows), M, N, out.data_ptr(),
                             cuda.device_index(dev), cuda.stream(dev))
    return out
