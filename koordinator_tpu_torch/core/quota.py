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
``quota_limit`` kernels (``csrc/quota.cu``, one thread block over a plan of
the tree, ``quota_plan``, which a ``QuotaStage`` builds and keeps on the
card once a tree); CPU tensors take the plain ``refresh_runtime`` here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch import cuda

INF = 1 << 60  # stand-in for "no max configured on this dimension"


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


def quota_scratch_bytes(Q: int, R: int) -> int:
    """Bytes of the global tier's scratch (mirrors ``quota_scratch_bytes``
    in csrc/quota.cu): Request, runtime and the water-fill's limits as
    [Q, R] int64, its active flags as [Q, R] bytes, 16-byte aligned."""
    return (Q * R * 25 + 15) & ~15


def quota_smem_bytes(Q: int, R: int, plan_words: int) -> int:
    """Shared memory of the kernel's shared tier (mirrors
    ``quota_smem_bytes`` in csrc/quota.cu): the scratch's rows, the
    per-group inputs the passes read (four [Q, R] int64, two [Q] flags)
    and the plan's int32 words."""
    return ((Q * R * 57 + Q * 2 + 15) & ~15) + plan_words * 4


def quota_plan(parent, levels) -> tuple:
    """The kernel's plan of one tree, on the host: (int32 block, levels,
    runs).  Each level's members are sorted by parent, so that a parent's
    children are one contiguous run; the block holds the levels' run
    offsets [L+1], the runs' parents [runs], the runs' member offsets
    [runs+1], then the members.  Raises ``ValueError`` on parent rows
    outside [0, Q), level rows outside [1, Q), a row in two levels, or a
    member whose parent is a row of its own level or a later one."""
    parent = np.asarray(parent, dtype=np.int64)
    Q = parent.shape[0]
    if Q and (int(parent.min()) < 0 or int(parent.max()) >= Q):
        raise ValueError(f"quota parent rows outside [0, {Q})")
    level_of = np.full(Q, -1, dtype=np.int64)
    arrs = [np.asarray(lv, dtype=np.int64).reshape(-1) for lv in levels]
    for depth, lv in enumerate(arrs):
        if lv.size and (int(lv.min()) < 1 or int(lv.max()) >= Q):
            raise ValueError(f"quota level rows outside [1, {Q})")
        if (level_of[lv] >= 0).any() or np.unique(lv).size != lv.size:
            raise ValueError("a quota row in two levels")
        level_of[lv] = depth
    members = np.concatenate(arrs) if arrs else np.zeros(0, dtype=np.int64)
    if members.size and (level_of[parent[members]] >= level_of[members]).any():
        raise ValueError("a quota level row whose parent is not in an earlier level")
    lrun, rpar, roff, mem = [0], [], [], []
    at = 0
    for lv in arrs:
        lv = lv[np.argsort(parent[lv], kind="stable")]
        par = parent[lv]
        starts = np.flatnonzero(np.r_[True, par[1:] != par[:-1]]) if lv.size else lv
        rpar.append(par[starts])
        roff.append(at + starts)
        mem.append(lv)
        at += lv.size
        lrun.append(lrun[-1] + starts.size)
    runs = lrun[-1]
    block = np.concatenate([np.asarray(lrun)] + rpar + roff + [np.asarray([at])] + mem)
    return block.astype(np.int32), len(arrs), runs


class QuotaStage:
    """A quota tree's plan (``quota_plan``) on the card, and the kernel's
    global scratch for the trees past the shared-memory tier: ``bind``
    keys the plan on the content of the host parent rows and levels and on
    the device, so a refresh whose tree is unchanged plans and copies
    nothing, and a new ``own_request`` (an array of the call) changes no
    key.  ``quota_fn`` and ``quota_limit_fn`` bind the stage they are given
    to their own call's tree, so a stage that last held another tree plans
    this one rather than launch the other's.  Trees whose rows, inputs and
    plan fit ``budget`` bytes (``quota_smem_bytes``) take the shared-memory
    tier, the others the global one (``quota_scratch_bytes``).  ``plans``
    counts the plans built."""

    def __init__(self, budget: int = cuda.MAX_SMEM):
        self.budget = budget
        self.plans = 0
        self._key = None
        self._scratch = None
        self.plan = None
        self.Q = self.L = self.runs = 0

    def bind(self, parent, levels, device) -> "QuotaStage":
        """Plan the tree of ``parent`` ([Q] host rows) and ``levels`` on
        ``device`` unless this stage already holds it; returns the stage."""
        device = torch.device(device)
        parent = np.asarray(parent)
        key = (device, parent.dtype.str, parent.tobytes(),
               tuple((np.asarray(lv).dtype.str, np.asarray(lv).tobytes()) for lv in levels))
        if key != self._key:
            block, self.L, self.runs = quota_plan(parent, levels)
            self.plan = torch.from_numpy(block).to(device)
            self.Q = parent.shape[0]
            self._scratch = None
            self._key = key
            self.plans += 1
        return self

    def tier(self, R: int) -> str:
        """The kernel's memory tier for this tree at R dimensions."""
        words = 0 if self.plan is None else self.plan.numel()
        return "shared" if quota_smem_bytes(self.Q, R, words) <= self.budget else "global"

    def scratch(self, R: int) -> int:
        """The global tier's scratch pointer (allocated once a tree and R),
        0 for the shared tier."""
        if self.tier(R) == "shared":
            return 0
        n = (quota_scratch_bytes(self.Q, R) + 7) // 8
        if self._scratch is None or self._scratch.numel() != n:
            self._scratch = torch.empty(n, dtype=torch.int64, device=self.plan.device)
        return self._scratch.data_ptr()


def quota_launch_args(q: QuotaArrays, cluster_total, stage: QuotaStage) -> tuple:
    """The kernel's arguments before its flags: the per-group arrays and
    the total, checked (what changes between calls), then the stage's
    plan, its words, level and run counts, Q, R and scratch.  Raises on bad dtypes,
    shapes or devices, and on a stage of another tree size or device."""
    dev = q.min.device
    Q, R = q.min.shape
    if R > cuda.MAXR:
        raise ValueError(f"{R} quota dimensions exceed {cuda.MAXR}")
    if stage.Q != Q or stage.plan is None or stage.plan.device != dev:
        raise ValueError(f"the quota stage holds a tree of {stage.Q} rows on "
                         f"{None if stage.plan is None else stage.plan.device}, "
                         f"not {Q} on {dev}")
    i64, b = torch.int64, torch.bool
    return (
        cuda._checked(q.min, i64, (Q, R), dev, "quota min").data_ptr(),
        cuda._checked(q.max_eff, i64, (Q, R), dev, "quota max_eff").data_ptr(),
        cuda._checked(q.weight, i64, (Q, R), dev, "quota weight").data_ptr(),
        cuda._checked(q.guarantee, i64, (Q, R), dev, "quota guarantee").data_ptr(),
        cuda._checked(q.own_request, i64, (Q, R), dev, "quota own_request").data_ptr(),
        cuda._checked(q.allow_lent, b, (Q,), dev, "quota allow_lent").data_ptr(),
        cuda._checked(q.enable_scale, b, (Q,), dev, "quota enable_scale").data_ptr(),
        cuda._checked(cluster_total, i64, (R,), dev, "cluster total").data_ptr(),
        stage.plan.data_ptr(), stage.plan.numel(), stage.L, stage.runs, Q, R, stage.scratch(R),
    )


def _host_parent(parent, Q: int) -> np.ndarray:
    """The tree's [Q] int32 parent rows on the host, checked: a host array
    or tensor as it is, a device tensor read back."""
    if torch.is_tensor(parent):
        dtype, shape = parent.dtype, tuple(parent.shape)
        ok = dtype is torch.int32
    else:
        parent = np.asarray(parent)
        dtype, shape = parent.dtype, parent.shape
        ok = dtype == np.int32
    if not ok or shape != (Q,):
        raise ValueError(f"quota parent: expected int32 ({Q},), got {dtype} {shape}")
    return parent.cpu().numpy() if torch.is_tensor(parent) else parent


def _quota(kernel, q: QuotaArrays, levels, cluster_total, scale_min_enabled: bool,
           limit_row0: bool, stage: Optional["QuotaStage"]) -> torch.Tensor:
    dev = q.min.device
    Q, R = q.min.shape
    parent = _host_parent(q.parent, Q)
    # the call's own tree keys the plan: every input is checked, on any device
    stage = (QuotaStage() if stage is None else stage).bind(parent, levels, dev)
    args = quota_launch_args(q, cluster_total, stage)
    if dev.type == "cpu":
        out = refresh_runtime(q._replace(parent=torch.as_tensor(parent)),
                              [torch.as_tensor(np.asarray(a, dtype=np.int64)) for a in levels],
                              cluster_total, scale_min_enabled)
        if limit_row0:
            out[0] = INF
        return out
    out = torch.empty((Q, R), dtype=torch.int64, device=dev)
    kernel.launch(*args, int(scale_min_enabled), int(limit_row0), out.data_ptr(),
                  cuda.device_index(dev), cuda.stream(dev))
    return out


def quota_fn(q: QuotaArrays, levels, cluster_total, scale_min_enabled: bool = True,
             stage: Optional[QuotaStage] = None):
    """The ``quota`` kernel: ``refresh_runtime`` (``levels`` host arrays).
    The inputs are checked on every device; CPU tensors then take the
    plain version, CUDA tensors launch ``csrc/quota.cu`` or raise.
    ``q.parent``: the tree's parent rows, best on the host (the engine
    keeps them there; rows on the card are read back), which key the
    tree's plan.  ``stage``: a ``QuotaStage`` kept between calls (the
    engine's), bound here to this call's tree, so that an unchanged tree is
    planned once; without one the call plans its tree.  The output is a
    fresh tensor."""
    return _quota(cuda.QUOTA, q, levels, cluster_total, scale_min_enabled, False, stage)


def quota_limit_fn(q: QuotaArrays, levels, cluster_total,
                   stage: Optional[QuotaStage] = None):
    """The ``quota_limit`` kernel: ``refresh_runtime`` with row 0 set to the
    2**60 sentinel ``QuotaSnapshot.used_limit`` writes, the admission limit
    the SCHEDULE kernels take; ``q.parent`` and ``stage`` as ``quota_fn``
    takes them."""
    return _quota(cuda.QUOTA_LIMIT, q, levels, cluster_total, True, True, stage)
