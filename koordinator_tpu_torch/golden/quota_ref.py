"""Pure-Python replay of the ElasticQuota runtime calculation.

Follows the Go implementation operation-for-operation (Python floats ARE
IEEE-754 float64, so the reference's float64 rounding is reproduced exactly):

- quotaTree.redistribution + iterationForRedistribution
  (core/runtime_quota_calculator.go:111-168): per resource dimension, give
  every child max(min, guarantee) (or its request if it lent resources back),
  then water-fill the remainder over still-hungry children by sharedWeight,
  delta = int64(float64(w)*float64(total)/float64(totalW) + 0.5).
- request aggregation (group_quota_manager.go:184-224): leaf ChildRequest =
  pod requests; Request = ChildRequest floored at Min when !allowLent;
  passing up, a child contributes min(Request, Max) ("limited request",
  quota_info.go:201-212).
- RefreshRuntime root-to-leaf recursion (group_quota_manager.go:264-325):
  each parent's runtime is the child level's total; min-quota auto-scaling
  (scale_minquota_when_over_root_res.go:102-160) shrinks enable-scale
  children's min proportionally when the level's min sum exceeds the total,
  newMin = int64(float64(avail)*float64(origMin)/float64(enableSum)).
- PreFilter admission (plugin.go:210-254 + plugin_helper.go): used+request
  <= runtime (or max when runtime quota disabled) on the pod's requested
  dimensions; non-preemptible pods additionally against min.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.api.quota import DEFAULT_QUOTA, ROOT_QUOTA, SYSTEM_QUOTA, QuotaGroup

ResourceList = Dict[str, int]


def resource_keys(groups: List[QuotaGroup]) -> List[str]:
    """updateResourceKeyNoLock: the union of all groups' Max keys."""
    keys = set()
    for g in groups:
        keys.update(g.max.keys())
    return sorted(keys)


def limited_request(request: ResourceList, max_q: ResourceList) -> ResourceList:
    """getLimitRequestNoLock: min(request, max) on max's present keys."""
    out = dict(request)
    for r, v in request.items():
        if r in max_q and v > max_q[r]:
            out[r] = max_q[r]
    return out


def aggregate_requests(groups: List[QuotaGroup]) -> Dict[str, ResourceList]:
    """Bottom-up Request per group (see module docstring). Returns
    {name: Request}."""
    by_name = {g.name: g for g in groups}
    children: Dict[str, List[QuotaGroup]] = {}
    for g in groups:
        children.setdefault(g.parent, []).append(g)

    request: Dict[str, ResourceList] = {}

    def visit(g: QuotaGroup) -> ResourceList:
        if g.name in request:
            return request[g.name]
        child_request: ResourceList = dict(g.pod_requests)
        for c in children.get(g.name, []):
            for r, v in limited_request(visit(c), c.max).items():
                child_request[r] = child_request.get(r, 0) + v
        real = dict(child_request)
        if not g.allow_lent:
            for r, v in g.min.items():  # floor at min
                if v > real.get(r, 0):
                    real[r] = v
        request[g.name] = real
        return real

    for g in groups:
        visit(g)
    return request


def aggregate_used(groups: List[QuotaGroup]) -> Tuple[Dict[str, ResourceList], Dict[str, ResourceList]]:
    """used / nonPreemptibleUsed summed up the ancestor chain
    (updateGroupDeltaUsedNoLock)."""
    by_name = {g.name: g for g in groups}
    used = {g.name: dict(g.used) for g in groups}
    npu = {g.name: dict(g.non_preemptible_used) for g in groups}
    for g in groups:
        p = by_name.get(g.parent)
        chain = []
        while p is not None:
            chain.append(p)
            p = by_name.get(p.parent)
        for anc in chain:
            for r, v in g.used.items():
                used[anc.name][r] = used[anc.name].get(r, 0) + v
            for r, v in g.non_preemptible_used.items():
                npu[anc.name][r] = npu[anc.name].get(r, 0) + v
    return used, npu


def redistribute(
    total: int,
    nodes: List[dict],
) -> Dict[str, int]:
    """quotaTree.redistribution for one resource dimension.

    nodes: [{name, request, weight, min, guarantee, allow_lent}] where
    request is the LIMITED request (min(Request, Max)).
    Returns {name: runtimeQuota}.
    """
    runtime: Dict[str, int] = {}
    to_partition = total
    total_weight = 0
    adjust = []
    for n in nodes:
        mn = n["min"]
        if n["guarantee"] > mn:
            mn = n["guarantee"]
        if n["request"] > mn:
            adjust.append(n)
            total_weight += n["weight"]
            runtime[n["name"]] = mn
        else:
            runtime[n["name"]] = n["request"] if n["allow_lent"] else mn
        to_partition -= runtime[n["name"]]

    while to_partition > 0 and adjust and total_weight > 0:
        nxt, nxt_weight, surplus = [], 0, 0
        for n in adjust:
            delta = int(float(n["weight"]) * float(to_partition) / float(total_weight) + 0.5)
            runtime[n["name"]] += delta
            if runtime[n["name"]] < n["request"]:
                nxt.append(n)
                nxt_weight += n["weight"]
            else:
                surplus += runtime[n["name"]] - n["request"]
                runtime[n["name"]] = n["request"]
        adjust, total_weight, to_partition = nxt, nxt_weight, surplus
    return runtime


def scaled_min(
    total: int, orig_min: int, enable_sum: int, disable_sum: int, enable: bool
) -> int:
    """getScaledMinQuota for one (child, dimension)."""
    if not enable:
        return orig_min
    if total >= enable_sum + disable_sum:
        return orig_min
    avail = total - disable_sum
    if avail <= 0:
        return 0
    if enable_sum <= 0:
        return 0
    return int(float(avail) * float(orig_min) / float(enable_sum))


def refresh_runtime(
    groups: List[QuotaGroup],
    cluster_total: ResourceList,
    scale_min_enabled: bool = True,
) -> Dict[str, ResourceList]:
    """Full-tree runtime refresh: the fixed point every
    RefreshRuntime(quotaName) path computes, for all groups at once.

    cluster_total must already exclude system/default used
    (totalResourceExceptSystemAndDefaultUsed).  System/default groups are not
    in the tree (their runtime is their max, refreshRuntimeNoLock:274-276).
    """
    keys = resource_keys(groups)
    request = aggregate_requests(groups)
    children: Dict[str, List[QuotaGroup]] = {}
    for g in groups:
        children.setdefault(g.parent, []).append(g)

    runtime: Dict[str, ResourceList] = {}

    def distribute(parent_name: str, parent_total: ResourceList):
        childs = children.get(parent_name, [])
        if not childs:
            return
        for r in keys:
            total_r = parent_total.get(r, 0)
            # min-quota auto-scaling across this sibling set
            enable_sum = sum(c.min.get(r, 0) for c in childs if c.enable_scale_min)
            disable_sum = sum(c.min.get(r, 0) for c in childs if not c.enable_scale_min)
            nodes = []
            for c in childs:
                mn = c.min.get(r, 0)
                if scale_min_enabled:
                    mn = scaled_min(total_r, mn, enable_sum, disable_sum, c.enable_scale_min)
                lim_req = limited_request(request[c.name], c.max)
                sw = c.effective_shared_weight()
                nodes.append(
                    {
                        "name": c.name,
                        "request": lim_req.get(r, 0),
                        "weight": sw.get(r, 0),
                        "min": mn,
                        "guarantee": c.guarantee.get(r, 0),
                        "allow_lent": c.allow_lent,
                    }
                )
            for name, v in redistribute(total_r, nodes).items():
                runtime.setdefault(name, {})[r] = v
        for c in childs:
            distribute(c.name, runtime[c.name])

    distribute(ROOT_QUOTA, dict(cluster_total))
    return runtime


def masked_runtime(g: QuotaGroup, runtime: ResourceList) -> ResourceList:
    """getMaskedRuntimeNoLock: runtime masked to the group's max keys."""
    return {r: v for r, v in runtime.items() if r in g.max}


def prefilter(
    pod_request: ResourceList,
    quota_used: ResourceList,
    used_limit: ResourceList,
    non_preemptible: bool = False,
    non_preemptible_used: Optional[ResourceList] = None,
    quota_min: Optional[ResourceList] = None,
) -> bool:
    """plugin.go:210-254 admission for one pod against one group.

    used_limit keys define the limit; a requested dimension absent from the
    limit counts as limit 0 (quotav1.LessThanOrEqual treats missing as zero).
    """
    for r, v in pod_request.items():
        if quota_used.get(r, 0) + v > used_limit.get(r, 0):
            return False
    if non_preemptible:
        npu = non_preemptible_used or {}
        mn = quota_min or {}
        for r, v in pod_request.items():
            if npu.get(r, 0) + v > mn.get(r, 0):
                return False
    return True
