"""LoadAwareScheduling Filter + Score over dense (pods x nodes x resources) tensors.

The reference scores one (pod, node) pair per call inside the framework's
16-goroutine per-node loop (pkg/scheduler/plugins/loadaware/load_aware.go:269).
Here the plain PyTorch version produces the full [P, N] score matrix and the
[P, N] feasibility mask at once; the CUDA kernels of ``core.cycle`` and
``core.resolved`` evaluate the same arithmetic per pair (``csrc/pair.cuh``).
The wrappers ``loadaware_score`` (the ``la_score`` kernel) and
``loadaware_score_and_filter`` launch ``csrc/breakdown.cu``'s LoadAware
strip (``la_strip_kernel``, one launch a call) for CUDA tensors and run the
plain versions for CPU tensors.

  score(p, n) = sum_r w_r * lrs(est_p[r] + base_n[r], alloc_n[r])  /  sum_r w_r
  lrs(u, c)   = 0 if c == 0 or u > c else (c - u) * 100 / c        (load_aware.go:388-397)

with base_n selected per pod between the prod and non-prod precomputations
(load_aware.go:291-327) and nodes with missing/expired NodeMetric scored 0
(load_aware.go:278-289).

The filter reproduces load_aware.go:123-254: utilization-percent thresholds
per resource, a prod-specific branch for prod-class pods on nodes that carry
prod thresholds, and a DaemonSet bypass.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.ops.rounding import floor_div_fixup

MAX_NODE_SCORE = 100  # k8s framework.MaxNodeScore


class LoadAwarePodArrays(NamedTuple):
    """Per-pending-pod dense inputs ([P, R] / [P])."""

    est: torch.Tensor  # [P, R] int64 — estimator.EstimatePod (default_estimator.go:57-108)
    is_prod_score: torch.Tensor  # [P] bool — prod class && ScoreAccordingProdUsage (load_aware.go:291)
    is_prod_class: torch.Tensor  # [P] bool — prod class (filter branch, load_aware.go:150)
    is_daemonset: torch.Tensor  # [P] bool — filter bypass (load_aware.go:129)


class LoadAwareNodeArrays(NamedTuple):
    """Per-node dense inputs ([N, R] / [N]), precomputed by the snapshot layer."""

    alloc: torch.Tensor  # [N, R] int64 — estimator.EstimateNode allocatable
    base_nonprod: torch.Tensor  # [N, R] int64 — assigned-pod estimates + deduped node usage
    base_prod: torch.Tensor  # [N, R] int64 — prod-path base (load_aware.go:303-306)
    score_valid: torch.Tensor  # [N] bool — NodeMetric exists && not expired
    filter_usage: torch.Tensor  # [N, R] int64 — usage the filter compares (instant or aggregated)
    filter_active: torch.Tensor  # [N] bool — node has usable metric + usage for filtering
    thresholds: torch.Tensor  # [N, R] int64 — merged per-node thresholds; 0 = disabled
    prod_usage: torch.Tensor  # [N, R] int64 — sum of prod pods' reported usage
    prod_filter_active: torch.Tensor  # [N] bool — node has pod metrics (load_aware.go:227)
    prod_thresholds: torch.Tensor  # [N, R] int64 — merged prod thresholds; 0 = disabled
    has_prod_thresholds: torch.Tensor  # [N] bool — len(profile.ProdUsageThresholds) > 0
    # (load_aware.go:150 — the branch is chosen by map presence, which may
    # include all-zero thresholds, so it cannot be derived from the values)


def _least_requested(used: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """(cap - used) * MaxNodeScore / cap with the reference's guards
    (load_aware.go:388-397). int64; Go truncating division == floor here."""
    guard = (cap == 0) | (used > cap)
    safe_cap = torch.where(cap == 0, torch.ones_like(cap), cap)
    safe_used = torch.where(guard, torch.zeros_like(used), used)
    score = floor_div_fixup((cap - safe_used) * MAX_NODE_SCORE, safe_cap, MAX_NODE_SCORE)
    return torch.where(guard, torch.zeros_like(score), score)


def loadaware_score_plain(
    pods: LoadAwarePodArrays, nodes: LoadAwareNodeArrays, weights: torch.Tensor
) -> torch.Tensor:
    """Full [P, N] raw int64 score matrix (pre-NormalizeScore), load_aware.go:269-335:
    the plain version of the ``la_score`` kernel.

    weights: [R] int64, the ResourceWeights vector over the resource axis.
    """
    base = torch.where(
        pods.is_prod_score[:, None, None], nodes.base_prod[None], nodes.base_nonprod[None]
    )  # [P, N, R]
    used = pods.est[:, None, :] + base
    per_resource = _least_requested(used, nodes.alloc[None])
    weight_sum = weights.sum()
    score = floor_div_fixup(
        (per_resource * weights[None, None, :]).sum(dim=-1), weight_sum, MAX_NODE_SCORE
    )
    return torch.where(nodes.score_valid[None, :], score, torch.zeros_like(score))


def _threshold_reject(usage, total, thresholds, active) -> torch.Tensor:
    """Per-node rejection: any resource with threshold > 0, total > 0 and
    round(100*usage/total) >= threshold (load_aware.go:185-222). [N] bool.

      pct_round(u, t) >= thr  <=>  200u + t >= 2t*thr.
    """
    exceeded = (thresholds > 0) & (total > 0) & (
        200 * usage + total >= 2 * total * thresholds
    )
    return active & exceeded.any(dim=-1)


def loadaware_filter(pods: LoadAwarePodArrays, nodes: LoadAwareNodeArrays) -> torch.Tensor:
    """[P, N] feasibility mask (True = schedulable), load_aware.go:123-254."""
    normal_reject = _threshold_reject(
        nodes.filter_usage, nodes.alloc, nodes.thresholds, nodes.filter_active
    )  # [N]
    prod_reject = _threshold_reject(
        nodes.prod_usage, nodes.alloc, nodes.prod_thresholds, nodes.prod_filter_active
    )  # [N]
    use_prod_branch = pods.is_prod_class[:, None] & nodes.has_prod_thresholds[None, :]
    reject = torch.where(use_prod_branch, prod_reject[None, :], normal_reject[None, :])
    return pods.is_daemonset[:, None] | ~reject


def loadaware_score(
    pods: LoadAwarePodArrays, nodes: LoadAwareNodeArrays, weights: torch.Tensor
) -> torch.Tensor:
    """The ``la_score`` kernel: the raw [P, N] int64 LoadAware score, no
    plugin weight folded in (``Engine.score_breakdown``).  CPU tensors take
    the plain version; CUDA tensors launch ``csrc/breakdown.cu`` or raise."""
    if pods.est.device.type == "cpu":
        return loadaware_score_plain(pods, nodes, weights)
    args = cuda.loadaware_args(pods, nodes, weights)
    P, N = pods.est.shape[0], nodes.alloc.shape[0]
    dev = pods.est.device
    out = torch.empty((P, N), dtype=torch.int64, device=dev)
    if P and N:
        cuda.LA_SCORE.launch(args.pods, args.nodes, args.cfg, args.la_w, P, N, out.data_ptr(),
                             cuda.device_index(dev), cuda.stream(dev))
    return out


def loadaware_score_and_filter(
    pods: LoadAwarePodArrays, nodes: LoadAwareNodeArrays, weights: torch.Tensor
):
    """The LoadAware plugin's library entry point, (scores [P, N] int64,
    feasible [P, N] bool) in one dispatch: the ``loadaware_score_and_filter``
    kernel for CUDA tensors (or raise), the plain versions for CPU tensors."""
    if pods.est.device.type == "cpu":
        return loadaware_score_plain(pods, nodes, weights), loadaware_filter(pods, nodes)
    args = cuda.loadaware_args(pods, nodes, weights)
    P, N = pods.est.shape[0], nodes.alloc.shape[0]
    dev = pods.est.device
    scores = torch.empty((P, N), dtype=torch.int64, device=dev)
    feasible = torch.empty((P, N), dtype=torch.bool, device=dev)
    if P and N:
        cuda.LA_SCORE_FILTER.launch(args.pods, args.nodes, args.cfg, args.la_w, P, N,
                                    scores.data_ptr(), feasible.data_ptr(),
                                    cuda.device_index(dev), cuda.stream(dev))
    return scores, feasible
