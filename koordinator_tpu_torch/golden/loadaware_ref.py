"""Golden oracle: a scalar, per-(pod, node) re-statement of the reference's
LoadAwareScheduling Filter and Score with Go's exact numeric semantics.

This module deliberately mirrors the *shape* of the Go code — one pod against
one node at a time, float64 where Go uses float64 (``math.Round`` == floor(x+0.5)
for the non-negative values on these paths), int64 truncating division — so
that the dense kernels can be bit-match-tested against it.  It shares no
code with the snapshot/kernel path beyond the object model.

References (the upstream koordinator sources):
  pkg/scheduler/plugins/loadaware/load_aware.go:123-254 (Filter)
  pkg/scheduler/plugins/loadaware/load_aware.go:269-397 (Score + scorer)
  pkg/scheduler/plugins/loadaware/helper.go (profiles, aggregation, sums)
  pkg/scheduler/plugins/loadaware/estimator/default_estimator.go:57-129
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Set, Tuple

from koordinator_tpu_torch.api.model import (
    BATCH_CPU,
    BATCH_MEMORY,
    CPU,
    MEMORY,
    Node,
    NodeMetric,
    Pod,
    PriorityClass,
    priority_class_of,
    translate_resource_name,
)
from koordinator_tpu_torch.core.config import LoadAwareArgs

MAX_NODE_SCORE = 100
DEFAULT_MILLI_CPU_REQUEST = 250
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


def _go_round(x: float) -> int:
    """math.Round for x >= 0: floor(x + 0.5)."""
    return int(math.floor(x + 0.5))


def golden_estimate_pod(pod: Pod, args: LoadAwareArgs) -> Dict[str, int]:
    """estimatedPodUsed + estimatedUsedByResource (default_estimator.go:61-108),
    with Go's float64 multiply/divide order: float64(q) * float64(sf) / 100."""
    cls = priority_class_of(pod)
    out: Dict[str, int] = {}
    for resource in args.resource_weights:
        real = translate_resource_name(cls, resource)
        sf = args.estimated_scaling_factors.get(resource, 0)
        lim = pod.limits.get(real, 0)
        req = pod.requests.get(real, 0)
        if lim > req:
            sf = 100
            q = lim
        else:
            q = req
        if q == 0:
            if real in (CPU, BATCH_CPU):
                out[resource] = DEFAULT_MILLI_CPU_REQUEST
            elif real in (MEMORY, BATCH_MEMORY):
                out[resource] = DEFAULT_MEMORY_REQUEST
            else:
                out[resource] = 0
            continue
        v = _go_round(float(q) * float(sf) / 100.0)
        if lim > 0 and v > lim:
            v = lim
        out[resource] = v
    return out


def _is_expired(metric: Optional[NodeMetric], now: float, expiration: int) -> bool:
    """helper.go:36-41."""
    return (
        metric is None
        or metric.update_time is None
        or (expiration > 0 and now - metric.update_time >= expiration)
    )


def _profile(node: Node, args: LoadAwareArgs):
    """generateUsageThresholdsFilterProfile, helper.go:102-140."""
    agg_from_args = None
    if args.filter_with_aggregation():
        agg_from_args = (
            args.aggregated.usage_thresholds,
            args.aggregated.usage_aggregation_type,
            args.aggregated.usage_aggregated_duration,
        )
    if not node.has_custom_annotation:
        return args.usage_thresholds, args.prod_usage_thresholds, agg_from_args
    usage = node.custom_usage_thresholds or args.usage_thresholds
    prod = node.custom_prod_usage_thresholds or args.prod_usage_thresholds
    agg = None
    if node.custom_agg_usage_thresholds and node.custom_agg_type:
        agg = (node.custom_agg_usage_thresholds, node.custom_agg_type, node.custom_agg_duration)
    if agg is None and agg_from_args is not None:
        agg = agg_from_args
    return usage, prod, agg


def _build_pod_metric_map(metric: NodeMetric, filter_prod: bool) -> Dict[str, Dict[str, int]]:
    """buildPodMetricMap, helper.go:153-170 (all referenced pods assumed live)."""
    out = {}
    for k, u in metric.pods_usage.items():
        if filter_prod and not metric.prod_pods.get(k, False):
            continue
        out[k] = u
    return out


def _sum_pod_usages(
    pod_metrics: Dict[str, Dict[str, int]], estimated: Optional[Set[str]]
) -> Tuple[Dict[str, int], Dict[str, int]]:
    """sumPodUsages, helper.go:172-186."""
    actual: Dict[str, int] = {}
    est_actual: Dict[str, int] = {}
    for k, usage in pod_metrics.items():
        target = est_actual if (estimated is not None and k in estimated) else actual
        for r, v in usage.items():
            target[r] = target.get(r, 0) + v
    return actual, est_actual


def golden_filter(pod: Pod, node: Node, args: LoadAwareArgs, now: float) -> bool:
    """Plugin.Filter (load_aware.go:123-171): True = schedulable."""
    if pod.is_daemonset:
        return True
    metric = node.metric
    if metric is None:
        return True
    if (
        args.filter_expired_node_metrics
        and args.node_metric_expiration_seconds is not None
        and _is_expired(metric, now, args.node_metric_expiration_seconds)
    ):
        return True
    usage_thr, prod_thr, agg = _profile(node, args)
    alloc = node.estimated_allocatable()
    if prod_thr and priority_class_of(pod) is PriorityClass.PROD:
        return _filter_prod_usage(metric, alloc, prod_thr)
    thresholds = agg[0] if agg is not None else usage_thr
    if thresholds:
        return _filter_node_usage(metric, alloc, thresholds, agg)
    return True


def _filter_node_usage(metric, alloc, thresholds, agg) -> bool:
    """filterNodeUsage (load_aware.go:173-224)."""
    if metric.node_usage is None:
        return True
    for r, thr in thresholds.items():
        if thr == 0:
            continue
        total = alloc.get(r, 0)
        if total == 0:
            continue
        if agg is not None:
            nu = metric.target_aggregated_usage(agg[2], agg[1])
        else:
            nu = metric.node_usage
        if nu is None:
            continue
        used = nu.get(r, 0)
        usage = _go_round(float(used) / float(total) * 100.0)
        if usage >= thr:
            return False
    return True


def _filter_prod_usage(metric, alloc, prod_thresholds) -> bool:
    """filterProdUsage (load_aware.go:226-254)."""
    if not metric.pods_usage:
        return True
    pod_metrics = _build_pod_metric_map(metric, True)
    prod_usages, _ = _sum_pod_usages(pod_metrics, None)
    for r, thr in prod_thresholds.items():
        if thr == 0:
            continue
        total = alloc.get(r, 0)
        if total == 0:
            continue
        used = prod_usages.get(r, 0)
        usage = _go_round(float(used) / float(total) * 100.0)
        if usage >= thr:
            return False
    return True


def _estimated_assigned_pod_used(
    node: Node,
    metric: NodeMetric,
    pod_metrics: Dict[str, Dict[str, int]],
    filter_prod: bool,
    args: LoadAwareArgs,
) -> Tuple[Dict[str, int], Set[str]]:
    """estimatedAssignedPodUsed (load_aware.go:337-376)."""
    update_time = metric.update_time or 0.0
    interval = metric.report_interval
    est_used: Dict[str, int] = {}
    est_pods: Set[str] = set()
    agg_nil = False
    if args.score_with_aggregation():
        agg_nil = (
            metric.target_aggregated_usage(
                args.aggregated.score_aggregated_duration, args.aggregated.score_aggregation_type
            )
            is None
        )
    for ap in node.assigned_pods:
        if filter_prod and priority_class_of(ap.pod) is not PriorityClass.PROD:
            continue
        usage = pod_metrics.get(ap.pod.key, {})
        if (
            not usage
            or ap.assign_time > update_time
            or (ap.assign_time < update_time and update_time - ap.assign_time < interval)
            or agg_nil
        ):
            est = golden_estimate_pod(ap.pod, args)
            for r, v in est.items():
                u = usage.get(r)
                if u is not None and u > v:
                    v = u
                est_used[r] = est_used.get(r, 0) + v
            est_pods.add(ap.pod.key)
    return est_used, est_pods


def golden_score(pod: Pod, node: Node, args: LoadAwareArgs, now: float) -> int:
    """Plugin.Score (load_aware.go:269-335)."""
    metric = node.metric
    if metric is None:
        return 0
    if args.node_metric_expiration_seconds is not None and _is_expired(
        metric, now, args.node_metric_expiration_seconds
    ):
        return 0
    prod_pod = (
        priority_class_of(pod) is PriorityClass.PROD and args.score_according_prod_usage
    )
    pod_metrics = _build_pod_metric_map(metric, prod_pod)
    estimated_used = golden_estimate_pod(pod, args)
    assigned_est, est_pods = _estimated_assigned_pod_used(node, metric, pod_metrics, prod_pod, args)
    for r, v in assigned_est.items():
        estimated_used[r] = estimated_used.get(r, 0) + v
    pod_actual, est_actual = _sum_pod_usages(pod_metrics, est_pods)
    if prod_pod:
        for r, q in pod_actual.items():
            estimated_used[r] = estimated_used.get(r, 0) + q
    else:
        if metric.node_usage is not None:
            if args.score_with_aggregation():
                nu = metric.target_aggregated_usage(
                    args.aggregated.score_aggregated_duration,
                    args.aggregated.score_aggregation_type,
                )
            else:
                nu = metric.node_usage
            if nu is not None:
                for r, q in nu.items():
                    e = est_actual.get(r, 0)
                    if e != 0 and q >= e:
                        q = q - e
                    estimated_used[r] = estimated_used.get(r, 0) + q
    alloc = node.estimated_allocatable()
    return _scorer(args.resource_weights, estimated_used, alloc)


def _scorer(weights: Dict[str, int], used: Dict[str, int], alloc: Dict[str, int]) -> int:
    """loadAwareSchedulingScorer + leastRequestedScore (load_aware.go:378-397)."""
    node_score, weight_sum = 0, 0
    for r, w in weights.items():
        node_score += _least_requested(used.get(r, 0), alloc.get(r, 0)) * w
        weight_sum += w
    return node_score // weight_sum


def _least_requested(requested: int, capacity: int) -> int:
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    return ((capacity - requested) * MAX_NODE_SCORE) // capacity
