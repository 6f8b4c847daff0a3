"""The scheduling cycle's scoring pass and its sequential oracle, in torch.

* ``score_batch``: the [P, N] weighted total-score matrix + feasibility mask
  for a batch scored against a fixed snapshot (LoadAware + NodeResourcesFit).
  ``score_fn`` adds the live-column mask; it is the ``score`` kernel's
  wrapper: a CPU tensor takes the plain version, a CUDA tensor launches the
  hand-written kernel (``csrc/score.cu``).

* ``schedule_batch``: the Go scheduler's one-pod-at-a-time loop (vendored
  scheduleOne) as a Python loop in queue order, carrying the assume-path
  node state.  It is the oracle of ``core.resolved`` and the route for the
  strategies the resolved engine cannot take.  Plain pods only: its gang,
  quota and reservation branches arrive with the strategies slice, with
  the scan on the card.

Host selection is the score argmax; Go breaks exact ties by reservoir
sampling, so any tied node is a legal reference outcome.  Two deterministic
tie-breaks are offered, as in the JAX package: ``"index"`` (lowest node
index) and ``"salted"`` (lowest per-pod-rotated index, a multiplicative-hash
rotation of the node axis).  Pods that fit nowhere get host -1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.core.gang import GangArrays, GangPodArrays
from koordinator_tpu_torch.core.loadaware import (
    LoadAwareNodeArrays,
    LoadAwarePodArrays,
    loadaware_filter,
    loadaware_score,
)
from koordinator_tpu_torch.core.nodefit import (
    NodeFitNodeArrays,
    NodeFitPodArrays,
    NodeFitStatic,
    nodefit_filter,
    nodefit_score,
)
from koordinator_tpu_torch.core.quota import QuotaPodArrays
from koordinator_tpu_torch.core.reservation import ReservationArrays, restore_extra_free

_TIE_HASH = 2654435761  # Knuth multiplicative hash (32-bit wraparound)


def tie_base(num_nodes: int) -> int:
    """Smallest power of two >= num_nodes: the composite-key radix."""
    return 1 << max(int(num_nodes - 1).bit_length(), 1)


def tie_salt(pod_index: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Per-pod node-axis rotation offset ``(uint32)(p * 2654435761u) % N``,
    computed in int64 with an explicit 32-bit wrap."""
    wrapped = (pod_index.to(torch.int64) * _TIE_HASH) & 0xFFFFFFFF
    return torch.remainder(wrapped, num_nodes).to(torch.int32)


def tie_keys(masked: torch.Tensor, salt) -> torch.Tensor:
    """Composite ordering keys ``masked * TB + (TB-1 - rotated_index)``:
    argmax over keys = (score desc, per-pod rotated node index asc)."""
    N = masked.shape[-1]
    tb = tie_base(N)
    rot = torch.remainder(torch.arange(N, dtype=torch.int64, device=masked.device) + salt, N)
    return masked * tb + (tb - 1 - rot)


class PluginWeights(NamedTuple):
    """framework profile plugin weights (default 1 per enabled plugin)."""

    loadaware: int = 1
    nodefit: int = 1
    reservation: int = 1
    numa: int = 1


class GangInputs(NamedTuple):
    pods: GangPodArrays
    gangs: GangArrays


class QuotaInputs(NamedTuple):
    """Quota admission state for the batch: used/npu are the starting
    aggregates (already summed up ancestor chains), limit/min as
    ``core.quota.quota_prefilter`` takes them."""

    pods: QuotaPodArrays
    used: torch.Tensor  # [Q, R]
    limit: torch.Tensor  # [Q, R]
    npu: torch.Tensor  # [Q, R]
    min: torch.Tensor  # [Q, R]
    parent: torch.Tensor  # [Q] int32


class ReservationInputs(NamedTuple):
    """Reservations on the nodefit FILTER resource axis.  ``scores`` and
    ``rscore`` are computed against the batch-start allocations and stay
    fixed through the cycle; consumption is tracked live."""

    rsv: ReservationArrays
    matched: torch.Tensor  # [P, Rv] bool — owner/affinity match (host-side)
    rscore: torch.Tensor  # [P, Rv] int64 — score_reservation
    scores: torch.Tensor  # [P, N] int64 — reservation_score (normalized)


def score_batch(
    la_pods: LoadAwarePodArrays,
    la_nodes: LoadAwareNodeArrays,
    la_weights: torch.Tensor,
    nf_pods: NodeFitPodArrays,
    nf_nodes: NodeFitNodeArrays,
    nf_static: NodeFitStatic,
    plugin_weights: PluginWeights = PluginWeights(),
    reservation: Optional[ReservationInputs] = None,
):
    """([P, N] int64 weighted total scores, [P, N] bool feasibility); a
    reservation adds its restore to the filter and its scores to the
    total."""
    la_s = loadaware_score(la_pods, la_nodes, la_weights)
    nf_s = nodefit_score(nf_pods, nf_nodes, nf_static)
    total = la_s * plugin_weights.loadaware + nf_s * plugin_weights.nodefit
    extra = None
    if reservation is not None:
        extra = restore_extra_free(reservation.matched, reservation.rsv, nf_nodes.alloc.shape[0])
        total = total + reservation.scores * plugin_weights.reservation
    feasible = loadaware_filter(la_pods, la_nodes) & nodefit_filter(
        nf_pods, nf_nodes, nf_static, extra
    )
    return total, feasible


def score_fn(
    la_pods: LoadAwarePodArrays,
    la_nodes: LoadAwareNodeArrays,
    la_weights: torch.Tensor,
    nf_pods: NodeFitPodArrays,
    nf_nodes: NodeFitNodeArrays,
    nf_static: NodeFitStatic,
    valid: torch.Tensor,
    extra_scores: Optional[torch.Tensor] = None,
):
    """The ``score`` kernel: ``score_batch`` under the default plugin
    weights, as the JAX engine's ``score_fn`` calls it, with dead columns
    masked infeasible and the batch's pre-weighted ``extra_scores`` [P, N]
    (deviceshare, amplified CPU) added to the totals.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/score.cu`` (LeastAllocated
    only) or raise."""
    P, N = la_pods.est.shape[0], valid.shape[0]
    if extra_scores is not None and (extra_scores.dtype != torch.int64
                                     or tuple(extra_scores.shape) != (P, N)
                                     or extra_scores.device != valid.device):
        raise ValueError(f"extra_scores: expected int64 {(P, N)} on {valid.device}, got "
                         f"{extra_scores.dtype} {tuple(extra_scores.shape)} on "
                         f"{extra_scores.device}")
    if valid.device.type == "cpu":
        totals, feasible = score_batch(la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static)
        if extra_scores is not None:
            totals = totals + extra_scores
        return totals, feasible & valid[None, :]
    args = cuda.pair_args(la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static, valid)
    xsc = None if extra_scores is None else extra_scores.contiguous()
    totals = torch.empty((P, N), dtype=torch.int64, device=valid.device)
    feasible = torch.empty((P, N), dtype=torch.bool, device=valid.device)
    if P and N:
        cuda.SCORE.launch(
            args.pods, args.nodes, args.cfg, args.la_w, args.valid,
            0 if xsc is None else xsc.data_ptr(), P, N, totals.data_ptr(), feasible.data_ptr(),
            cuda.device_index(valid.device), cuda.stream(valid.device),
        )
    return totals, feasible


def _assign_updates(la, nf, la_pods, nf_pods, i, host):
    """The assume-path node-state updates for pod i placed on host."""
    est = la_pods.est[i]
    la = la._replace(
        base_nonprod=la.base_nonprod.index_add(0, host, est[None]),
        base_prod=la.base_prod.index_add(
            0, host, (est * la_pods.is_prod_class[i].to(torch.int64))[None]
        ),
    )
    nf = nf._replace(
        requested=nf.requested.index_add(0, host, nf_pods.req[i][None]),
        req_score=nf.req_score.index_add(0, host, nf_pods.req_score[i][None]),
        num_pods=nf.num_pods.index_add(0, host, torch.ones_like(host, dtype=torch.int64)),
    )
    return la, nf


def schedule_batch(
    la_pods: LoadAwarePodArrays,
    la_nodes: LoadAwareNodeArrays,
    la_weights: torch.Tensor,
    nf_pods: NodeFitPodArrays,
    nf_nodes: NodeFitNodeArrays,
    nf_static: NodeFitStatic,
    plugin_weights: PluginWeights = PluginWeights(),
    extra_feasible: Optional[torch.Tensor] = None,
    order: Optional[torch.Tensor] = None,
    tie_break: str = "index",
):
    """Greedy sequential batch assignment in queue order, plain pods.

    Returns (hosts [P] int32 — node index or -1, scores [P] int64 — the
    winning total, 0 when unplaced)."""
    P = la_pods.est.shape[0]
    N = la_nodes.alloc.shape[0]
    dev = la_pods.est.device
    xs = torch.arange(P, device=dev) if order is None else order.to(dev)
    hosts = torch.full((P,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(P, dtype=torch.int64, device=dev)
    neg = torch.tensor(-1 << 40, dtype=torch.int64, device=dev)
    la, nf = la_nodes, nf_nodes
    for i in xs.tolist():
        la_p1 = LoadAwarePodArrays(*(a[i : i + 1] for a in la_pods))
        nf_p1 = NodeFitPodArrays(*(a[i : i + 1] for a in nf_pods))
        total, feasible = score_batch(la_p1, la, la_weights, nf_p1, nf, nf_static, plugin_weights)
        total, feasible = total[0], feasible[0]
        if extra_feasible is not None:
            feasible = feasible & extra_feasible[i]
        if not bool(feasible.any()):
            continue
        masked = torch.where(feasible, total, neg)
        if tie_break == "salted":
            salt = tie_salt(torch.tensor(i, device=dev), N).to(torch.int64)
            host = int(torch.argmax(tie_keys(masked, salt)))
        else:
            host = int(torch.argmax(masked))
        la, nf = _assign_updates(
            la, nf, la_pods, nf_pods, i, torch.tensor([host], device=dev)
        )
        hosts[i] = host
        scores[i] = masked[host]
    return hosts, scores
