"""Reservation plugin as tensor ops, in torch.

The JAX package's core/reservation.py.  Owner/affinity matching is host-side
string work; the kernels consume a dense ``matched[P, Rv]`` mask plus the
per-reservation arrays:

- ``restore_extra_free``: the BeforePreFilter restore (transformer.go:41-235)
  — a pod matching a reservation on a node sees its unallocated resources
  as additional free capacity.
- ``score_reservation``: scoreReservation (scoring.go:183-203), MostAllocated
  over the reservation's non-zero allocatable.
- ``reservation_score``: PreScore/Score/NormalizeScore (scoring.go:42-131):
  per (pod, node) the matched reservation with the smallest positive order
  label is nominated, else the highest ``score_reservation``; the globally
  most-preferred reservation's node scores 1000; scores normalize max->100.
- ``nominate_with_ranks``: the nominator (nominator.go:134-190): per pod
  (or batch of pods), the reservation it consumes on its node.

``order_ranks`` ranks the positive order labels by (order, index).  The
kernels take the ranks computed once, on the host.

``rsv_rscore`` and ``rsv_score`` are the wrappers of the two
instantiations of ``csrc/reservation.cu``'s one template, and ``rsv_rows``
computes both rows of a cycle in one launch: they check their inputs'
dtypes and shapes on every device, then CPU tensors take the plain
versions here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.ops.rounding import floor_div_fixup

MOST_PREFERRED_SCORE = 1000  # scoring.go:39
MAX_NODE_SCORE = 100
_INF = 1 << 60


class ReservationArrays(NamedTuple):
    """[Rv] dense available reservations."""

    node: torch.Tensor  # [Rv] int32 — node row the reserve pod is bound to
    allocatable: torch.Tensor  # [Rv, R] int64
    allocated: torch.Tensor  # [Rv, R] int64
    order: torch.Tensor  # [Rv] int64 — LabelReservationOrder, 0 = unset


def restore_extra_free(matched: torch.Tensor, rsv: ReservationArrays, num_nodes: int):
    """[P, N, R] additional free capacity visible to each pod per node."""
    remain = rsv.allocatable - rsv.allocated  # [Rv, R]
    contrib = torch.where(matched[:, :, None], remain[None], torch.zeros_like(remain)[None])
    out = torch.zeros((matched.shape[0], num_nodes, remain.shape[1]), dtype=remain.dtype,
                      device=remain.device)
    return out.index_add(1, rsv.node.long(), contrib)


def match_index(matched: torch.Tensor, bound: int) -> torch.Tensor:
    """[P, bound] int32: each pod's matched reservation rows, ascending,
    -1 past the last — the compact matched view, the JAX package's stable
    argsort of ``~matched`` (``bound`` must be at least every pod's match
    count)."""
    bound = max(int(bound), 1)
    P, Rv = matched.shape
    idx = torch.sort((~matched).to(torch.uint8), dim=1, stable=True).indices[:, :bound]
    idx = torch.where(torch.gather(matched, 1, idx), idx, -1).to(torch.int32)
    if bound > Rv:
        pad = torch.full((P, bound - Rv), -1, dtype=torch.int32, device=matched.device)
        idx = torch.cat([idx, pad], dim=1)
    return idx


def score_reservation(pod_req: torch.Tensor, rsv: ReservationArrays) -> torch.Tensor:
    """[P, Rv] scoreReservation: MostAllocated over the reservation's
    non-zero allocatable dims, all weights 1."""
    cap = rsv.allocatable[None]
    req = pod_req[:, None, :] + rsv.allocated[None]
    nonzero = cap != 0
    fits = nonzero & (req <= cap)
    zero = torch.zeros((), dtype=torch.int64, device=pod_req.device)
    per_r = floor_div_fixup(torch.where(fits, req, zero) * MAX_NODE_SCORE,
                            torch.where(cap == 0, torch.ones_like(cap), cap), MAX_NODE_SCORE)
    per_r = torch.where(fits, per_r, zero)
    w = nonzero.sum(dim=-1)
    s = per_r.sum(dim=-1)
    return torch.where(w == 0, zero, torch.div(s, torch.where(w == 0, torch.ones_like(w), w),
                                               rounding_mode="floor"))


def order_ranks(order: torch.Tensor):
    """Dense 1-based ranks of the positive order labels by (order, index):
    (rank [Rv] int64 with 0 = no order, sorted_idx [Rv] int32 mapping
    rank-1 -> reservation index).  One stable sort by the label with the
    absent ones last (the sort by index is the identity)."""
    Rv = order.shape[0]
    has = order > 0
    key = torch.where(has, order, torch.full_like(order, _INF))
    sorted_idx = torch.sort(key, stable=True).indices
    rank = torch.zeros(Rv, dtype=torch.int64, device=order.device)
    rank[sorted_idx] = torch.arange(1, Rv + 1, device=order.device)
    return torch.where(has, rank, torch.zeros_like(rank)), sorted_idx.to(torch.int32)


def order_ranks_host(order: np.ndarray) -> np.ndarray:
    """``order_ranks``' ranks of a host array of order labels, [Rv] int64:
    the same stable sort of the same keys in numpy, so the same ranks."""
    has = order > 0
    rank = np.zeros(order.shape[0], dtype=np.int64)
    rank[np.argsort(np.where(has, order, _INF), kind="stable")] = np.arange(1, order.shape[0] + 1)
    rank[~has] = 0
    return rank


def default_normalize_score(scores: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """DefaultNormalizeScore over the node axis: the max becomes 100; an
    all-zero row stays unchanged (or becomes all 100 when reverse)."""
    mx = scores.amax(dim=-1, keepdim=True)
    safe = torch.where(mx == 0, torch.ones_like(mx), mx)
    out = floor_div_fixup(scores * MAX_NODE_SCORE, safe, MAX_NODE_SCORE)
    if reverse:
        out = MAX_NODE_SCORE - out
    return torch.where(mx == 0, torch.full_like(out, MAX_NODE_SCORE if reverse else 0), out)


def reservation_score(pod_req: torch.Tensor, matched: torch.Tensor, num_nodes: int,
                      rsv: ReservationArrays) -> torch.Tensor:
    """[P, N] normalized reservation scores (Score + NormalizeScore)."""
    P, Rv = matched.shape
    dev = pod_req.device
    rscore = score_reservation(pod_req, rsv)  # [P, Rv]
    node = rsv.node.long()
    rank, sorted_idx = order_ranks(rsv.order)
    has_order = matched & (rank > 0)[None]
    keys = torch.where(has_order, rank[None].expand(P, Rv),
                       torch.full((P, Rv), Rv + 1, dtype=torch.int64, device=dev))
    idx = node[None].expand(P, Rv)
    big = torch.iinfo(torch.int64)
    min_key = torch.full((P, num_nodes), big.max, dtype=torch.int64, device=dev).scatter_reduce(
        1, idx, keys, reduce="amin", include_self=True)
    ordered_exists = min_key <= Rv
    order_idx = sorted_idx.long()[torch.clamp(min_key - 1, 0, Rv - 1)]
    order_score = torch.gather(rscore, 1, order_idx)
    best = torch.full((P, num_nodes), big.min, dtype=torch.int64, device=dev).scatter_reduce(
        1, idx, torch.where(matched, rscore, torch.full_like(rscore, -1)), reduce="amax",
        include_self=True)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    score = torch.where(ordered_exists, order_score, torch.where(best >= 0, best, zero))
    pod_min_key = keys.amin(dim=1)
    none = torch.full((P,), -1, dtype=torch.int64, device=dev)
    preferred = torch.where(
        pod_min_key <= Rv, node[sorted_idx.long()[torch.clamp(pod_min_key - 1, 0, Rv - 1)]], none
    )
    node_ids = torch.arange(num_nodes, device=dev)[None]
    score = torch.where(preferred[:, None] == node_ids, torch.full_like(score, MOST_PREFERRED_SCORE),
                        score)
    return default_normalize_score(score)


def nominate_with_ranks(matched, rscore, rsv: ReservationArrays, host, rank, sorted_idx):
    """The reservation a pod consumes on ``host``: among its matched
    reservations there, the one with the smallest positive order label,
    else the first highest ``score_reservation``.  ``matched``/``rscore``
    are [..., Rv] and ``host`` [...] (one pod, or one per committed
    slot); the ranks are ``order_ranks``'.  Returns (index, valid)."""
    Rv = rsv.node.shape[0]
    host = torch.as_tensor(host, device=matched.device)
    cand = matched & (rsv.node.long() == host[..., None])
    key = torch.where(cand & (rank > 0), rank, torch.full_like(rank, Rv + 1))
    mn = key.amin(dim=-1)
    idx_ordered = sorted_idx.long()[torch.clamp(mn - 1, 0, Rv - 1)]
    idx_best = torch.argmax(torch.where(cand, rscore, torch.full_like(rscore, -1)), dim=-1)
    return torch.where(mn <= Rv, idx_ordered, idx_best), cand.any(dim=-1)


def nominate_on_node(matched_row, rscore_row, rsv: ReservationArrays, host):
    rank, sorted_idx = order_ranks(rsv.order)
    return nominate_with_ranks(matched_row, rscore_row, rsv, host, rank, sorted_idx)


# ------------------------------------------------------------------ kernels


def _rsv_args(pod_req, rsv: ReservationArrays):
    dev = pod_req.device
    P, Rf = pod_req.shape
    Rv = rsv.node.shape[0]
    if Rf > cuda.MAXR:
        raise ValueError(f"{Rf} reservation dimensions exceed {cuda.MAXR}")
    i64 = torch.int64
    return (
        cuda._checked(pod_req, i64, (P, Rf), dev, "pod_req"),
        cuda._checked(rsv.node, torch.int32, (Rv,), dev, "reservation node"),
        cuda._checked(rsv.allocatable, i64, (Rv, Rf), dev, "reservation allocatable"),
        cuda._checked(rsv.allocated, i64, (Rv, Rf), dev, "reservation allocated"),
    )


def _score_args(pod_req, matched, rsv: ReservationArrays, rank):
    """The checked inputs of the score launch: request, node, allocatable,
    allocated, rank, matched."""
    dev = pod_req.device
    P = pod_req.shape[0]
    Rv = rsv.node.shape[0]
    args = _rsv_args(pod_req, rsv) + (
        cuda._checked(rank, torch.int64, (Rv,), dev, "reservation rank"),
        cuda._checked(matched, torch.bool, (P, Rv), dev, "matched"),
    )
    if Rv > cuda.RSV_MAX:
        raise ValueError(f"{Rv} reservations exceed the score kernel's {cuda.RSV_MAX}")
    return args


def _launch_score(args, num_nodes: int, rscore, out) -> None:
    """One launch of the score instantiation: ``out`` [P, N] and, when
    ``rscore`` is given, the [P, Rv] rows into it."""
    P, Rf = args[0].shape
    Rv = args[1].shape[0]
    if P:
        dev = args[0].device
        cuda.RSV_SCORE.launch(*(a.data_ptr() for a in args), P, Rv, Rf, num_nodes,
                              0 if rscore is None else rscore.data_ptr(), out.data_ptr(),
                              cuda.device_index(dev), cuda.stream(dev))


def rsv_rscore(pod_req: torch.Tensor, rsv: ReservationArrays) -> torch.Tensor:
    """The ``rsv_rscore`` kernel: ``score_reservation``, [P, Rv] int64.  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/reservation.cu`` or raise."""
    P, Rf = pod_req.shape
    Rv = rsv.node.shape[0]
    args = _rsv_args(pod_req, rsv)
    if pod_req.device.type == "cpu":
        return score_reservation(pod_req, rsv)
    out = torch.empty((P, Rv), dtype=torch.int64, device=pod_req.device)
    if P and Rv:
        cuda.RSV_RSCORE.launch(args[0].data_ptr(), *(a.data_ptr() for a in args[2:]), P, Rv, Rf,
                               out.data_ptr(), cuda.device_index(pod_req.device),
                               cuda.stream(pod_req.device))
    return out


def rsv_score(pod_req: torch.Tensor, matched: torch.Tensor, num_nodes: int,
              rsv: ReservationArrays, rank: torch.Tensor) -> torch.Tensor:
    """The ``rsv_score`` kernel: ``reservation_score``, [P, N] int64, with the
    order ranks ``rank`` ([Rv] int64, ``order_ranks`` of ``rsv.order``)
    computed by the caller.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/reservation.cu`` or raise."""
    args = _score_args(pod_req, matched, rsv, rank)
    if pod_req.device.type == "cpu":
        return reservation_score(pod_req, matched, num_nodes, rsv)
    out = torch.empty((pod_req.shape[0], num_nodes), dtype=torch.int64, device=pod_req.device)
    _launch_score(args, num_nodes, None, out)
    return out


def rsv_rows(pod_req: torch.Tensor, matched: torch.Tensor, num_nodes: int,
             rsv: ReservationArrays, rank: torch.Tensor):
    """A cycle's reservation rows, (``score_reservation`` [P, Rv],
    ``reservation_score`` [P, N]), both int64, with the order ranks
    ``rank`` computed by the caller: one set of checks, and on a card one
    launch of the ``rsv_score`` kernel writing both.  CPU tensors take the
    two plain versions; CUDA tensors launch ``csrc/reservation.cu`` or
    raise."""
    args = _score_args(pod_req, matched, rsv, rank)
    dev = pod_req.device
    if dev.type == "cpu":
        return (score_reservation(pod_req, rsv),
                reservation_score(pod_req, matched, num_nodes, rsv))
    P, Rv = matched.shape
    # int64 on the request's device, as the request (no dtype or device to parse)
    rscore = pod_req.new_empty((P, Rv))
    out = pod_req.new_empty((P, num_nodes))
    _launch_score(args, num_nodes, rscore, out)
    return rscore, out
