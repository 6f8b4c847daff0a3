"""Descheduler LowNodeLoad (load rebalancing) in PyTorch: the plain versions.

The port of the JAX package's ``core/lownodeload.py``, function for
function, over int64 tensors.  Reference: pkg/descheduler/framework/
plugins/loadaware/{low_node_load.go,utilization_util.go},
pkg/descheduler/utils/sorter/scorer.go and pkg/descheduler/utils/anomaly/
{basic_detector.go,counter.go}.  Per node pool, every descheduling round
(``processOneNodePool``, low_node_load.go:153-238):

1. thresholds: per-node low/high quantity thresholds = pct * 0.01 *
   capacity, truncated through float64 (resourceThreshold); deviation mode
   replaces the static percents with the mean usage percent -/+ pct,
   clamped to [0, 100] (getNodeThresholds + calcAverageResourceUsagePercent:
   the mean divides by ALL valid nodes, zero-allocatable ones included).
2. classify: underutilized = schedulable && ALL resources <= low threshold;
   overutilized = ANY resource > high threshold.
3. anomaly debounce (filterRealAbnormalNodes + anomaly.BasicDetector).
4. gates, in the reference's order: no sources -> stop; no underutilized ->
   stop; Reset() underutilized nodes' detectors; stop unless
   len(under) > NumberOfNodes and some node is not underutilized.
5. source nodes sort by the weighted MostRequested usage score, their
   removable pods by the same scorer over pod usage (weights zeroed for
   resources the node does not overuse), both on pre-eviction usage.
6. the eviction walk (evictPodsFromSourceNodes + evictPods) as segmented
   prefix sums and one monotone headroom cut (``select_evictions``).
7. tryMarkNodesAsNormal on every source.

Two choices differ in form from the JAX module and not in result:

- the deviation mean is summed in node order, one node after the other,
  as the reference's Go loop and the scalar oracle
  (``golden/lownodeload_ref.py``) sum it (``mean_usage_pct``).  A float
  sum depends on its order; integer thresholds and evictions are what the
  JAX package and the oracle agree on, and this order makes the mean
  itself equal the oracle's bit for bit;
- divisions are exact floor divisions (``ops.rounding``), each lexsort is
  a chain of stable sorts from the minor key to the major, and the
  scatter-max is ``scatter_reduce(..., "amax")``.

``core.deschedule`` fuses these into the ``deschedule_round`` kernel;
these functions are its plain composition and the host oracle of the
descheduler's ``verify``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from koordinator_tpu_torch.ops.rounding import floor_div_fixup

MAX_RESOURCE_PCT = 100.0
MIN_RESOURCE_PCT = 0.0


class LNLNodeArrays(NamedTuple):
    usage: torch.Tensor  # [N, R] int64 — NodeMetric usage (quantity units)
    alloc: torch.Tensor  # [N, R] int64 — Node allocatable
    unschedulable: torch.Tensor  # [N] bool
    valid: torch.Tensor  # [N] bool — fresh NodeMetric + pods listed


class LNLPodArrays(NamedTuple):
    """Eviction candidates living on (potential) source nodes."""

    node: torch.Tensor  # [Pc] int32
    usage: torch.Tensor  # [Pc, R] int64 — pod metric usage
    removable: torch.Tensor  # [Pc] bool — podFilter (host-side)


class AnomalyState(NamedTuple):
    """Per-node anomaly.BasicDetector state carried across rounds."""

    anomaly: torch.Tensor  # [N] bool — StateAnomaly
    ab: torch.Tensor  # [N] int64 — Counter.ConsecutiveAbnormalities
    norm: torch.Tensor  # [N] int64 — Counter.ConsecutiveNormalities


def new_anomaly_state(n: int, device=None) -> AnomalyState:
    return AnomalyState(
        anomaly=torch.zeros(n, dtype=torch.bool, device=device),
        ab=torch.zeros(n, dtype=torch.int64, device=device),
        norm=torch.zeros(n, dtype=torch.int64, device=device),
    )


def as_tensors(nt, device=None):
    """A NamedTuple of arrays as one of tensors (numpy arrays are copied in
    without changing their dtype)."""
    return type(nt)(*(torch.as_tensor(a, device=device) for a in nt))


def usage_pct(nodes: LNLNodeArrays) -> torch.Tensor:
    """[N, R] float64 100 * usage / allocatable on valid nodes with non-zero
    allocatable, NaN elsewhere."""
    ok = (nodes.alloc > 0) & nodes.valid[:, None]
    alloc_f = torch.where(ok, nodes.alloc.to(torch.float64), 1.0)
    return torch.where(ok, 100.0 * nodes.usage.to(torch.float64) / alloc_f,
                       torch.full_like(alloc_f, float("nan")))


def mean_usage_pct(nodes: LNLNodeArrays) -> torch.Tensor:
    """[R] float64 calcAverageResourceUsagePercent: the usage percents of
    the valid nodes summed in node order, one after the other (a node with
    zero allocatable adds nothing), over the number of valid nodes (at
    least 1).  The sum runs on the host, in Python floats, so its order is
    the reference's whatever device the inputs live on."""
    pct = usage_pct(nodes)
    cols = torch.where(torch.isnan(pct), 0.0, pct).T.cpu().tolist()
    n = max(int(nodes.valid.sum()), 1)
    sums = []
    for col in cols:
        s = 0.0
        for v in col:
            s += v
        sums.append(s / n)
    return torch.tensor(sums, dtype=torch.float64, device=nodes.usage.device)


def node_thresholds(nodes: LNLNodeArrays, low_pct, high_pct, use_deviation: bool = False):
    """([N, R] low, [N, R] high) quantity thresholds (getNodeThresholds).
    ``low_pct``/``high_pct`` are [R] float64 (missing = 100)."""
    alloc_f = nodes.alloc.to(torch.float64)
    low_pct = torch.as_tensor(low_pct, dtype=torch.float64, device=alloc_f.device)
    high_pct = torch.as_tensor(high_pct, dtype=torch.float64, device=alloc_f.device)
    if use_deviation:
        avg = mean_usage_pct(nodes)
        lo = torch.clamp(avg - low_pct, MIN_RESOURCE_PCT, MAX_RESOURCE_PCT)
        hi = torch.clamp(avg + high_pct, MIN_RESOURCE_PCT, MAX_RESOURCE_PCT)
        # MinResourcePercentage markers pin the threshold to full capacity
        pinned = low_pct == MIN_RESOURCE_PCT
        lo = torch.where(pinned, 100.0, lo)
        hi = torch.where(pinned, 100.0, hi)
    else:
        lo, hi = low_pct, high_pct
    low_q = (lo[None] * 0.01 * alloc_f).to(torch.int64)
    high_q = (hi[None] * 0.01 * alloc_f).to(torch.int64)
    return low_q, high_q


def classify(nodes: LNLNodeArrays, low_q, high_q):
    """([N] under, [N] over) — classifyNodes.  Invalid nodes are neither."""
    under = (nodes.usage <= low_q).all(dim=-1) & ~nodes.unschedulable & nodes.valid
    over = (nodes.usage > high_q).any(dim=-1) & ~under & nodes.valid
    return under, over


def mark_abnormal(state: AnomalyState, over, bound):
    """Mark(false) on every node in ``over``: OK state counts
    abnormalities (normalities zeroed) and passes to StateAnomaly once the
    count EXCEEDS the bound, which clears both counters.  Returns
    (state', source [N]): over nodes whose detector ends in StateAnomaly."""
    trans = over & ~state.anomaly & (state.ab + 1 > bound)
    ab = torch.where(over, torch.where(trans, 0, state.ab + 1), state.ab)
    norm = torch.where(over, 0, state.norm)
    anomaly = state.anomaly | trans
    return AnomalyState(anomaly=anomaly, ab=ab, norm=norm), over & anomaly


def reset_ok(state: AnomalyState, mask):
    """Reset() -> StateOK on masked nodes; counters clear only on an actual
    state change."""
    clear = mask & state.anomaly
    return AnomalyState(
        anomaly=state.anomaly & ~mask,
        ab=torch.where(clear, 0, state.ab),
        norm=torch.where(clear, 0, state.norm),
    )


def mark_normal(state: AnomalyState, mask, norm_bound):
    """Mark(true) on masked nodes: normalities +1, abnormalities zeroed; a
    node in StateAnomaly returns to StateOK (clearing counters) once
    normalities EXCEED the bound."""
    norm = torch.where(mask, state.norm + 1, state.norm)
    ab = torch.where(mask, 0, state.ab)
    back_ok = mask & state.anomaly & (norm > norm_bound)
    return AnomalyState(
        anomaly=state.anomaly & ~back_ok,
        ab=torch.where(back_ok, 0, ab),
        norm=torch.where(back_ok, 0, norm),
    )


def usage_score(usage, alloc, weights):
    """ResourceUsageScorer: weighted MostRequested over the usage resources,
    0..1000 scale (scorer.go:24-51).  usage/alloc [.., R]; weights [R] or
    broadcastable [.., R] (the per-pod path zeroes weights per node)."""
    cap = alloc
    req = torch.minimum(usage, cap)  # overcommit clamp
    per_r = floor_div_fixup(req * 1000, torch.where(cap == 0, 1, cap), 1000)
    per_r = torch.where(cap == 0, 0, per_r)
    weights = torch.as_tensor(weights, dtype=torch.int64, device=per_r.device)
    wsum = torch.broadcast_to(weights, per_r.shape).sum(dim=-1)
    score = floor_div_fixup((per_r * weights).sum(dim=-1), torch.where(wsum == 0, 1, wsum), 1000)
    return torch.where(wsum == 0, 0, score)


def lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` over 1-D tensors (the LAST key is the primary one):
    stable sorts from the minor key to the major, ties left in index
    order."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def inverse_perm(order: torch.Tensor) -> torch.Tensor:
    """rank with rank[order[i]] = i, int64."""
    rank = torch.empty_like(order, dtype=torch.int64)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank


def seg_excl_cumsum(x: torch.Tensor, start_pos: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum of ``x`` [Pc, ...] restarting at every segment
    start (``start_pos[k]`` is the first index of k's segment)."""
    cum = torch.cumsum(x, dim=0)
    base = cum[start_pos] - x[start_pos]
    return cum - x - base


def segment_starts(node_s: torch.Tensor) -> torch.Tensor:
    """[Pc] int64 index of the first position of each position's run of
    equal ``node_s`` values."""
    Pc = node_s.shape[0]
    pos = torch.arange(Pc, device=node_s.device)
    is_start = torch.ones(Pc, dtype=torch.bool, device=node_s.device)
    is_start[1:] = node_s[1:] != node_s[:-1]
    return torch.cummax(torch.where(is_start, pos, 0), dim=0).values


def select_evictions(nodes: LNLNodeArrays, pods: LNLPodArrays, low_q, high_q, source, under,
                     weights):
    """(evicted [Pc] bool, reset_mid [N] bool) — evictPodsFromSourceNodes /
    evictPods without the sequential walk (JAX ``select_evictions``).
    Per node, evictions are a prefix of its sorted candidates (a segmented
    cumsum with the prefix cut as "no prior continue-condition failure");
    the shared destination headroom only decreases, so the global stop is
    one monotone cut.  ``reset_mid`` marks sources whose continue
    condition saw them back under the high threshold mid-walk."""
    N = nodes.usage.shape[0]
    Pc = pods.node.shape[0]
    dev = nodes.usage.device
    weights = torch.as_tensor(weights, dtype=torch.int64, device=dev)
    node = pods.node.long()

    avail0 = torch.where(under[:, None], high_q - nodes.usage, 0).sum(dim=0)  # [R]
    node_score = usage_score(nodes.usage, nodes.alloc, weights)
    node_rank = inverse_perm(lexsort((torch.arange(N, device=dev), -node_score)))

    overused = nodes.usage > high_q  # [N, R]
    pod_w = torch.where(overused[node], weights[None], 0)
    pod_score = usage_score(pods.usage, nodes.alloc[node], pod_w)

    order = lexsort((torch.arange(Pc, device=dev), -pod_score, node_rank[node]))
    node_s = node[order]
    usage_s = pods.usage[order]
    active_s = pods.removable[order] & source[node_s]
    start_pos = segment_starts(node_s)

    u_act = torch.where(active_s[:, None], usage_s, 0)
    live_before = nodes.usage[node_s] - seg_excl_cumsum(u_act, start_pos)
    still_over = (live_before > high_q[node_s]).any(dim=-1)

    fail = active_s & ~still_over
    no_prior_fail = seg_excl_cumsum(fail.long(), start_pos) == 0
    evict_pre = active_s & still_over & no_prior_fail

    u_pre = torch.where(evict_pre[:, None], usage_s, 0)
    avail_before = avail0[None] - (torch.cumsum(u_pre, dim=0) - u_pre)
    evict_s = evict_pre & (avail_before > 0).all(dim=-1)

    mismatch = evict_pre & ~evict_s
    clean_priors = seg_excl_cumsum(mismatch.long(), start_pos) == 0
    first_fail = fail & no_prior_fail & clean_priors
    reset_mid = torch.zeros(N, dtype=torch.uint8, device=dev).scatter_reduce(
        0, node_s, first_fail.to(torch.uint8), "amax").bool()

    evicted = torch.zeros(Pc, dtype=torch.bool, device=dev)
    evicted[order] = evict_s
    return evicted, reset_mid


def balance_round(state: AnomalyState, nodes: LNLNodeArrays, pods: LNLPodArrays, low_pct,
                  high_pct, weights, *, use_deviation: bool = False,
                  consecutive_abnormalities: int = 5, consecutive_normalities: int = 3,
                  number_of_nodes: int = 0):
    """One full Balance round for one node pool (processOneNodePool).
    Returns (state', evicted [Pc], under [N], over [N], source [N]).  With
    consecutive_abnormalities <= 1 the debounce is bypassed and the carried
    state passes through unchanged."""
    N = nodes.usage.shape[0]
    low_q, high_q = node_thresholds(nodes, low_pct, high_pct, use_deviation)
    under, over = classify(nodes, low_q, high_q)

    debounce = consecutive_abnormalities > 1
    if debounce:
        state, source = mark_abnormal(state, over, consecutive_abnormalities)
    else:
        source = over

    # reference gate order: sources -> abnormal -> lowNodes -> Reset(under)
    # -> NumberOfNodes -> all-under; a failed gate skips everything after it
    n_under = int(under.sum())
    reach_reset = bool(source.any()) and n_under > 0
    proceed = reach_reset and n_under > number_of_nodes and n_under < N
    if debounce and reach_reset:
        state = reset_ok(state, under)

    source_eff = source & proceed
    evicted, reset_mid = select_evictions(nodes, pods, low_q, high_q, source_eff, under, weights)
    if debounce:
        state = reset_ok(state, reset_mid)
        state = mark_normal(state, source_eff, consecutive_normalities)
    return state, evicted, under, over, source
