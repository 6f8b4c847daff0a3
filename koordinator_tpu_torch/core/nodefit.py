"""NodeResourcesFit (vendored k8s scheduler plugin) as dense [P, N] tensor code.

The koord-scheduler runs the upstream NodeResourcesFit plugin from its
vendored kube-scheduler (k8s.io/kubernetes v1.24) inside the per-node
Filter/Score loops.  This module re-expresses both extension points over
the dense layout, as the plain PyTorch version of the arithmetic the CUDA
kernels evaluate per pair (``csrc/pair.cuh``, all three strategies).

Filter (noderesources/fit.go fitsRequest): a pod fits a node iff
  - len(nodeInfo.Pods) + 1 <= allocatable pod count, and
  - for cpu/memory/ephemeral-storage: podRequest <= allocatable - requested
    (checked even when podRequest is 0 — an overcommitted node fails it),
  - for scalar (extended) resources: the same, but only for resources the
    pod actually requests,
  - unless the pod requests nothing at all, in which case only the pod-count
    check applies.

Score (noderesources/resource_allocation.go): three strategies over the
configured resource weights — LeastAllocated, MostAllocated,
RequestedToCapacityRatio.  A scalar resource the pod does not request is
bypassed (drops out of the weight sum), as is any resource with zero
allocatable, so the weight sum varies per (pod, node) pair.

``nodefit_score`` is the ``nf_score`` kernel's wrapper: CUDA tensors launch
``csrc/breakdown.cu`` (every strategy), CPU tensors take the plain version
``nodefit_score_plain``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.ops.rounding import floor_div_fixup

MAX_NODE_SCORE = 100
MAX_UTILIZATION = 100  # maxUtilization, noderesources/requested_to_capacity_ratio.go


class NodeFitPodArrays(NamedTuple):
    """Pending-pod inputs on the two resource axes (filter Rf / score Rs)."""

    req: torch.Tensor  # [P, Rf] int64 — actual requests (computePodResourceRequest)
    req_score: torch.Tensor  # [P, Rs] int64 — requests with non-zero cpu/mem defaults
    # fit.go's zero-request early return tests the FULL request set including
    # ignored scalars, so this flag is computed host-side
    has_any_request: torch.Tensor  # [P] bool


class NodeFitNodeArrays(NamedTuple):
    alloc: torch.Tensor  # [N, Rf] int64 — nodeInfo.Allocatable on the filter axis
    requested: torch.Tensor  # [N, Rf] int64 — nodeInfo.Requested (actual, filter path)
    num_pods: torch.Tensor  # [N] int64 — len(nodeInfo.Pods)
    allowed_pods: torch.Tensor  # [N] int64 — Allocatable.AllowedPodNumber
    alloc_score: torch.Tensor  # [N, Rs] int64 — Allocatable on the scoring axis
    req_score: torch.Tensor  # [N, Rs] int64 — NonZeroRequested for cpu/mem, Requested otherwise


@dataclasses.dataclass(frozen=True)
class NodeFitStatic:
    """Static plugin config (the same fields as the JAX package's)."""

    always_check: Tuple[bool, ...]  # Rf — cpu/memory/ephemeral-storage class
    scalar_bypass: Tuple[bool, ...]  # Rs — scalar: drop when pod request == 0
    weights: Tuple[int, ...]  # Rs — ScoringStrategy.Resources weights
    strategy: str = "LeastAllocated"  # ScoringStrategyType value
    shape: Tuple[Tuple[int, int], ...] = ()  # RTC shape, scores pre-scaled to 0..100


def nodefit_score(pods: NodeFitPodArrays, nodes: NodeFitNodeArrays, static: NodeFitStatic):
    """The ``nf_score`` kernel: the raw [P, N] int64 NodeFit score under the
    configured strategy, no plugin weight folded in
    (``Engine.score_breakdown``).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/breakdown.cu`` or raise."""
    if pods.req.device.type == "cpu":
        return nodefit_score_plain(pods, nodes, static)
    args = cuda.nodefit_args(pods, nodes, static)
    P, N = pods.req.shape[0], nodes.alloc.shape[0]
    dev = pods.req.device
    out = torch.empty((P, N), dtype=torch.int64, device=dev)
    if P and N:
        cuda.NF_SCORE.launch(args.pods, args.nodes, args.cfg, P, N, out.data_ptr(),
                             cuda.device_index(dev), cuda.stream(dev))
    return out


def nodefit_score_plain(pods: NodeFitPodArrays, nodes: NodeFitNodeArrays, static: NodeFitStatic):
    """Dispatch on the configured ScoringStrategy (fit.go
    nodeResourceStrategyTypeMap): the plain version of ``nf_score``."""
    if static.strategy == "MostAllocated":
        return most_allocated_score(pods, nodes, static)
    if static.strategy == "RequestedToCapacityRatio":
        return requested_to_capacity_ratio_score(pods, nodes, static)
    return least_allocated_score(pods, nodes, static)


def nodefit_filter(
    pods: NodeFitPodArrays, nodes: NodeFitNodeArrays, static: NodeFitStatic, extra_free=None
) -> torch.Tensor:
    """[P, N] feasibility mask (True = fits), fit.go fitsRequest.

    extra_free: optional [P, N, Rf] per-pod free-capacity allowance — the
    reservation BeforePreFilter restore (a pod matching a reservation on a
    node sees its unallocated resources as free)."""
    always = torch.tensor(static.always_check, dtype=torch.bool, device=pods.req.device)
    req = pods.req[:, None, :]  # [P, 1, Rf]
    free = (nodes.alloc - nodes.requested)[None]  # [1, N, Rf]
    if extra_free is not None:
        free = free + extra_free
    checked = always[None, None, :] | (req > 0)
    insufficient = (checked & (req > free)).any(dim=-1)  # [P, N]
    all_zero = ~pods.has_any_request  # [P]
    pods_ok = nodes.num_pods + 1 <= nodes.allowed_pods  # [N]
    return (all_zero[:, None] | ~insufficient) & pods_ok[None, :]


def _included(pods: NodeFitPodArrays, nodes: NodeFitNodeArrays, static: NodeFitStatic):
    """[P, N, Rs] mask of resources that enter the score / weight sum:
    allocatable != 0 and not a scalar the pod does not request."""
    bypass = torch.tensor(static.scalar_bypass, dtype=torch.bool, device=pods.req.device)
    alloc_ok = (nodes.alloc_score != 0)[None]  # [1, N, Rs]
    pod_ok = ~(bypass[None, None, :] & (pods.req_score[:, None, :] == 0))
    return alloc_ok & pod_ok


def _requested_total(pods: NodeFitPodArrays, nodes: NodeFitNodeArrays):
    """[P, N, Rs] requested-including-this-pod on the scoring axis."""
    return pods.req_score[:, None, :] + nodes.req_score[None]


def _weights(static: NodeFitStatic, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(static.weights, dtype=torch.int64, device=like.device)


def _weighted_mean(per_r, inc, w):
    """The shared scorer tail: zero out excluded resources, weight, and divide
    by the per-(pod, node) weight sum with truncating division; 0 when
    nothing counted."""
    zero = torch.zeros((), dtype=torch.int64, device=per_r.device)
    per_r = torch.where(inc, per_r, zero)
    wsum = torch.where(inc, w[None, None, :], zero).sum(dim=-1)  # [P, N]
    acc = (per_r * w[None, None, :]).sum(dim=-1)
    score = floor_div_fixup(acc, torch.where(wsum == 0, torch.ones_like(wsum), wsum), MAX_NODE_SCORE)
    return torch.where(wsum == 0, zero, score)


def least_allocated_score(
    pods: NodeFitPodArrays, nodes: NodeFitNodeArrays, static: NodeFitStatic
):
    """leastResourceScorer: per resource ((cap - req) * 100 / cap, 0 if
    req > cap or cap == 0), weighted mean with truncating division."""
    cap = nodes.alloc_score[None]
    req = _requested_total(pods, nodes)
    zero = torch.zeros((), dtype=torch.int64, device=req.device)
    safe_cap = torch.where(cap == 0, torch.ones_like(cap), cap)
    guard = (cap == 0) | (req > cap)
    per_r = floor_div_fixup(
        (cap - torch.where(guard, zero, req)) * MAX_NODE_SCORE, safe_cap, MAX_NODE_SCORE
    )
    per_r = torch.where(guard, zero, per_r)
    return _weighted_mean(per_r, _included(pods, nodes, static), _weights(static, req))


def most_allocated_score(
    pods: NodeFitPodArrays, nodes: NodeFitNodeArrays, static: NodeFitStatic
):
    """mostResourceScorer: per resource (req * 100 / cap).  An overcommitted
    resource (req > cap) is CLAMPED to cap and scores 100 — not zeroed."""
    cap = nodes.alloc_score[None]
    req = _requested_total(pods, nodes)
    zero = torch.zeros((), dtype=torch.int64, device=req.device)
    safe_cap = torch.where(cap == 0, torch.ones_like(cap), cap)
    req = torch.minimum(req, cap)  # the overcommit clamp
    per_r = floor_div_fixup(req * MAX_NODE_SCORE, safe_cap, MAX_NODE_SCORE)
    per_r = torch.where(cap == 0, zero, per_r)
    return _weighted_mean(per_r, _included(pods, nodes, static), _weights(static, req))


def _broken_linear(p: torch.Tensor, shape: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """helper.BuildBrokenLinearFunction as a statically unrolled piecewise
    expression over int64 utilization percents.  Go's interpolation divides
    with truncation toward zero (the slope numerator is negative on
    decreasing segments), emulated as sign * (|a| // |b|)."""
    out = torch.full_like(p, shape[-1][1])  # p beyond the last point
    for i in range(len(shape) - 1, 0, -1):
        u0, s0 = shape[i - 1]
        u1, s1 = shape[i]
        num = (s1 - s0) * (p - u0)
        den = u1 - u0  # > 0 (validated strictly increasing)
        q = torch.sign(num) * torch.div(num.abs(), den, rounding_mode="floor")
        out = torch.where(p <= u1, s0 + q, out)
    return torch.where(p <= shape[0][0], torch.full_like(p, shape[0][1]), out)


def requested_to_capacity_ratio_score(
    pods: NodeFitPodArrays,
    nodes: NodeFitNodeArrays,
    static: NodeFitStatic,
    shape: Tuple[Tuple[int, int], ...] = None,
):
    """requestedToCapacityRatioScorer: raw broken-linear of the utilization
    percent per resource; a resource counts toward the weight sum only when
    its raw score > 0; final score = math.Round(acc / weightSum)."""
    if shape is None:
        shape = static.shape
    cap = nodes.alloc_score[None]
    req = _requested_total(pods, nodes)
    zero = torch.zeros((), dtype=torch.int64, device=req.device)
    inc = _included(pods, nodes, static)
    w = _weights(static, req)
    safe_cap = torch.where(cap == 0, torch.ones_like(cap), cap)
    over = (cap == 0) | (req > cap)
    # k8s computes the utilization as maxUtilization - free percent, NOT
    # floor(req*100/cap); the two differ by one whenever cap does not
    # divide req*100
    free_pct = floor_div_fixup(
        (cap - torch.where(over, zero, req)) * MAX_UTILIZATION, safe_cap, MAX_UTILIZATION
    )
    util = torch.where(over, torch.full_like(free_pct, MAX_UTILIZATION), MAX_UTILIZATION - free_pct)
    per_r = _broken_linear(util, shape)
    counted = inc & (per_r > 0)
    wsum = torch.where(counted, w[None, None, :], zero).sum(dim=-1)
    acc = torch.where(counted, per_r * w[None, None, :], zero).sum(dim=-1)
    # int64(math.Round(float64(acc)/float64(wsum))) — exact rational round-half-up
    safe_wsum = torch.where(wsum == 0, torch.ones_like(wsum), wsum)
    score = floor_div_fixup(2 * acc + safe_wsum, 2 * safe_wsum, MAX_NODE_SCORE)
    return torch.where(wsum == 0, zero, score)
