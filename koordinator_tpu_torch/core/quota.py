"""ElasticQuota hierarchical runtime calculation, in torch.

The JAX package's core/quota.py: groups are dense rows (row 0 the virtual
root) with a parent pointer array and BFS levels; ``refresh_runtime`` runs
request aggregation bottom-up, then per level the min-quota auto-scaling
and a segmented water-fill whose per-(parent, dimension) live mask
reproduces the Go recursion's independent termination conditions
(elasticquota/core/runtime_quota_calculator.go:111-168).

Float semantics are the Go code's: the water-fill delta is
``int64(float64(w)*float64(to_part)/float64(tw) + 0.5)`` and the min scaling
``int64(float64(avail)*float64(mn)/float64(esum))``, each op rounded to
nearest in float64 and the conversion truncating toward zero.

``quota_fn`` and ``quota_limit_fn`` are the wrappers of the ``quota`` and
``quota_limit`` kernels (``csrc/quota.cu``, one thread block); CPU tensors
take the plain ``refresh_runtime`` here.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from koordinator_tpu_torch import cuda

INF = 1 << 60  # stand-in for "no max configured on this dimension"
QUOTA_SCRATCH = 10  # [Q, R] int64 scratch arrays quota_kernel lays out (csrc/quota.cu)


class QuotaArrays(NamedTuple):
    """[Q, R] dense quota tree (row 0 = virtual root)."""

    parent: torch.Tensor  # [Q] int32
    min: torch.Tensor  # [Q, R] int64
    max_eff: torch.Tensor  # [Q, R] int64, INF where absent
    weight: torch.Tensor  # [Q, R] int64
    guarantee: torch.Tensor  # [Q, R] int64
    own_request: torch.Tensor  # [Q, R] int64
    allow_lent: torch.Tensor  # [Q] bool
    enable_scale: torch.Tensor  # [Q] bool


class QuotaPodArrays(NamedTuple):
    """Pending pods against the quota tree."""

    req: torch.Tensor  # [P, R] int64
    present: torch.Tensor  # [P, R] bool
    quota: torch.Tensor  # [P] int32 — group row (0 = no quota)
    non_preemptible: torch.Tensor  # [P] bool


def _seg(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add(0, idx, x)


def _f64_trunc(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)  # float64 -> int64 truncates toward zero


def aggregate_requests(q: QuotaArrays, levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """[Q, R] Request per group, bottom-up: a child contributes
    min(Request, Max), Request floored at Min when !allowLentResource."""
    child_sum = q.own_request.clone()
    request = q.own_request.clone()
    for lvl in reversed(levels):
        lvl = lvl.long()
        agg = child_sum[lvl]
        req_l = torch.where(q.allow_lent[lvl][:, None], agg, torch.maximum(agg, q.min[lvl]))
        request[lvl] = req_l
        limited = torch.minimum(req_l, q.max_eff[lvl])
        child_sum = child_sum.index_add(0, q.parent[lvl].long(), limited)
    return request


def _scaled_min(total_par, mn, enable, par, num_groups: int, scale_min_enabled: bool):
    """Min-quota auto-scaling for one sibling level (level-sliced mn/enable)."""
    if not scale_min_enabled:
        return mn
    en = enable[:, None]
    zero = torch.zeros_like(mn)
    esum = _seg(torch.where(en, mn, zero), par, num_groups)
    dsum = _seg(torch.where(en, zero, mn), par, num_groups)
    need = total_par < (esum + dsum)
    avail = total_par - dsum
    e = esum[par]
    scaled = _f64_trunc(
        avail[par].to(torch.float64) * mn.to(torch.float64)
        / torch.where(e == 0, torch.ones_like(e), e).to(torch.float64)
    )
    scaled = torch.where((avail[par] <= 0) | (e <= 0), zero, scaled)
    return torch.where(en & need[par], scaled, mn)


def _segment_waterfill(total_par, lim_req, weight, eff_min, allow_lent, par, num_groups: int):
    """quotaTree.redistribution for every parent of one level at once.
    Returns the level's [L, R] runtime."""
    adjust = lim_req > eff_min
    runtime = torch.where(adjust, eff_min, torch.where(allow_lent[:, None], lim_req, eff_min))
    to_part = total_par - _seg(runtime, par, num_groups)
    active = adjust
    zero = torch.zeros_like(weight)
    while True:
        tw = _seg(torch.where(active, weight, zero), par, num_groups)
        live = (to_part > 0) & (tw > 0)
        if not bool(live.any()):
            return runtime
        go = active & live[par]
        t = tw[par]
        delta = _f64_trunc(
            weight.to(torch.float64) * to_part[par].to(torch.float64)
            / torch.where(t == 0, torch.ones_like(t), t).to(torch.float64)
            + 0.5
        )
        cand = runtime + torch.where(go, delta, zero)
        capped = go & (cand >= lim_req)
        surplus = torch.where(capped, cand - lim_req, zero)
        runtime = torch.where(go, torch.minimum(cand, lim_req), runtime)
        active = active & ~capped
        to_part = torch.where(live, _seg(surplus, par, num_groups), to_part)


def refresh_runtime(q: QuotaArrays, levels: Sequence[torch.Tensor], cluster_total: torch.Tensor,
                    scale_min_enabled: bool = True) -> torch.Tensor:
    """[Q, R] runtime for every group (row 0 = cluster total)."""
    Q = q.parent.shape[0]
    request = aggregate_requests(q, levels)
    runtime = torch.zeros_like(q.min)
    runtime[0] = cluster_total
    for lvl in levels:
        lvl = lvl.long()
        par = q.parent[lvl].long()
        mn = _scaled_min(runtime, q.min[lvl], q.enable_scale[lvl], par, Q, scale_min_enabled)
        eff_min = torch.maximum(mn, q.guarantee[lvl])
        lim_req = torch.minimum(request[lvl], q.max_eff[lvl])
        runtime[lvl] = _segment_waterfill(
            runtime, lim_req, q.weight[lvl], eff_min, q.allow_lent[lvl], par, Q
        )
    return runtime


def quota_prefilter(pods: QuotaPodArrays, used, used_limit, non_preemptible_used, quota_min,
                    parent, check_parent_depth: int = 0) -> torch.Tensor:
    """[P] admission mask (plugin.go PreFilter): used + request <= limit on
    the requested dimensions, non-preemptible pods also against min at
    their own group, ``check_parent_depth`` ancestor hops re-checked."""

    def admit_at(group):
        return (~pods.present | (used[group] + pods.req <= used_limit[group])).all(dim=-1)

    g = pods.quota.long()
    np_ok = (~pods.present | (non_preemptible_used[g] + pods.req <= quota_min[g])).all(dim=-1)
    feasible = admit_at(g) & (np_ok | ~pods.non_preemptible)
    for _ in range(check_parent_depth):
        g = parent[g].long()
        feasible = feasible & ((g == 0) | admit_at(g))
    return feasible


# ------------------------------------------------------------------ kernels


def flat_levels(levels: Sequence) -> tuple:
    """(flat int32 rows, int32 offsets [L+1]) of the BFS levels, as the
    kernel takes them."""
    arrs = [np.asarray(lv, dtype=np.int32) for lv in levels]
    offs = np.zeros(len(arrs) + 1, dtype=np.int32)
    offs[1:] = np.cumsum([a.size for a in arrs])
    flat = np.concatenate(arrs) if arrs else np.zeros(0, dtype=np.int32)
    return flat, offs


def _quota_args(q: QuotaArrays, levels, cluster_total):
    """The kernel's checked inputs: the arrays, then the host-built level
    block (offsets, then the flat rows) and the level count.  Raises on
    bad dtypes, shapes or level rows, on any device."""
    dev = q.min.device
    Q, R = q.min.shape
    if R > cuda.MAXR:
        raise ValueError(f"{R} quota dimensions exceed {cuda.MAXR}")
    i64, b = torch.int64, torch.bool
    args = (
        cuda._checked(q.parent, torch.int32, (Q,), dev, "quota parent"),
        cuda._checked(q.min, i64, (Q, R), dev, "quota min"),
        cuda._checked(q.max_eff, i64, (Q, R), dev, "quota max_eff"),
        cuda._checked(q.weight, i64, (Q, R), dev, "quota weight"),
        cuda._checked(q.guarantee, i64, (Q, R), dev, "quota guarantee"),
        cuda._checked(q.own_request, i64, (Q, R), dev, "quota own_request"),
        cuda._checked(q.allow_lent, b, (Q,), dev, "quota allow_lent"),
        cuda._checked(q.enable_scale, b, (Q,), dev, "quota enable_scale"),
        cuda._checked(cluster_total, i64, (R,), dev, "cluster total"),
    )
    flat, offs = flat_levels(levels)
    if flat.size and (int(flat.min()) < 1 or int(flat.max()) >= Q):
        raise ValueError(f"quota level rows outside [1, {Q})")
    return args, np.concatenate([offs, flat]), len(offs) - 1


def _quota(kernel, q: QuotaArrays, levels, cluster_total, scale_min_enabled: bool,
           limit_row0: bool) -> torch.Tensor:
    args, lv, L = _quota_args(q, levels, cluster_total)
    if q.min.device.type == "cpu":
        out = refresh_runtime(q, [torch.as_tensor(np.asarray(a, dtype=np.int64)) for a in levels],
                              cluster_total, scale_min_enabled)
        if limit_row0:
            out[0] = INF
        return out
    dev = q.min.device
    Q, R = q.min.shape
    lv = torch.from_numpy(lv).pin_memory().to(dev, non_blocking=True)
    out = torch.empty((Q, R), dtype=torch.int64, device=dev)
    scratch = torch.empty((QUOTA_SCRATCH, Q, R), dtype=torch.int64, device=dev)
    kernel.launch(*(a.data_ptr() for a in args), lv.data_ptr(), L, Q, R, int(scale_min_enabled),
                  int(limit_row0), out.data_ptr(), scratch.data_ptr(), cuda.device_index(dev),
                  cuda.stream(dev))
    return out


def quota_fn(q: QuotaArrays, levels, cluster_total, scale_min_enabled: bool = True):
    """The ``quota`` kernel: ``refresh_runtime`` (``levels`` host arrays).
    The inputs are checked on every device; CPU tensors then take the
    plain version, CUDA tensors launch ``csrc/quota.cu`` or raise."""
    return _quota(cuda.QUOTA, q, levels, cluster_total, scale_min_enabled, False)


def quota_limit_fn(q: QuotaArrays, levels, cluster_total):
    """The ``quota_limit`` kernel: ``refresh_runtime`` with row 0 set to the
    2**60 sentinel ``QuotaSnapshot.used_limit`` writes, the admission limit
    the SCHEDULE kernels take."""
    return _quota(cuda.QUOTA_LIMIT, q, levels, cluster_total, True, True)
