"""The scheduling cycle as prefix-committed conflict resolution, in torch.

``core.cycle.schedule_batch`` reproduces the Go scheduler's one-pod-at-a-time
loop; ``schedule_batch_resolved`` computes the *identical* assignment with
data-parallel rounds instead of P sequential steps (the JAX package's
core/resolved.py, engine ``matrix_packed``):

1. The committed set is always a PREFIX of the queue order, so the carried
   node state is exactly the state the Go loop would hold after that prefix.
2. Each round every pending pod takes its argmax pick, and the longest
   prefix that provably commits together commits at once.  Placing a pod
   only ever lowers scores and feasibility (LeastAllocated, LoadAware
   least-requested, capacity masks), so a pending pod's pick stays its
   argmax after earlier in-prefix pods commit — unless one of them landed
   on the SAME node.  The prefix is cut at the first pod whose pick
   collides with an earlier pending pod's pick, and at ``commit_cap``
   placements.  A pod with no feasible node commits as unplaced.

Score and tie-break pack into one int32 ordering key,
``key = score * TB + (TB-1 - rot)`` (TB = pow2 >= N, rot the per-pod rotated
node index), in an [N_pad, P] key matrix ``M`` with a ``block_size``-row max
hierarchy ``Mb``.  A round's pick is a max over ``Mb`` whose low bits are
the winning node; only the <= commit_cap touched rows are rescored.

Exactness needs the monotonicity above, hence LeastAllocated only; other
strategies (MostAllocated, RequestedToCapacityRatio) route to the scan
(``core.cycle.schedule_batch``, with every constraint and the extras), as
in the JAX package, and report 0 rounds.

``impl`` picks the round engine as the JAX package does: ``"auto"`` takes
``matrix_packed`` while the packed key's bound fits int32 (``fits_i32``)
and the ``matrix`` engine beyond it: an [P, N] int64 masked score matrix
whose round pick is a composite-key argmax (``run_matrix_plain``), with
the same commit logic.  Its kernel holds the same composite key in int64
lanes of the packed layout (``schedule_keys``/``schedule_rounds`` with
``wide=True``).  An unknown ``impl`` raises ``ValueError`` on every path.

The cross-cycle warm start keeps the init state (M, Mb, la_feas_T) as a
carry: ``return_warm`` hands it out of a cold run, ``refresh_only`` with
``dirty_cols`` rebuilds the carry's rows of the nodes that changed, and
``warm_init`` starts the rounds from it.

Gang, quota and reservation inputs take the constrained round loop
(``run_rounds_plain`` with a ``ConInputs``): a pod commits only when its
quota PreFilter verdict is provably the same under the committed
aggregates and under committed + every earlier candidate's consumption; each committed pod
nominates and consumes a matched reservation on its node; the reservation
restore and frozen scores enter every key; after the rounds the gang
Permit (``commit_gangs``) revokes the groups that missed their quorum.

The placement-and-devices channel: ``extra_feasible`` [P, N] (selectors,
taints, anti-affinity, device and cpuset feasibility) is ANDed into every
pair's feasibility and ``extra_scores`` [P, N] (the pre-weighted
deviceshare and amplified-CPU scores) is added to every pair's total, both
frozen for the batch like the reservation scores; ``extra_score_bound``
joins the packed key's bound.  The kernels take them node-major in queue
order (``ExtraInputs``).

``schedule_keys`` and ``schedule_rounds`` are the wrappers of the two CUDA
launches of the cold ``schedule`` kernel (``csrc/schedule.cu``);
``schedule_refresh`` and ``schedule_rounds_warm`` those of the warm
``sched_refresh`` and ``sched_rounds``; ``schedule_fn`` composes the cold
pair the way the JAX package's ``schedule_fn`` (service/engine.py) composes
its jitted cycle, and sends other strategies to the ``scan`` kernel
(``core.cycle.scan_fn``).  Given a ``ConInputs`` each launches the
constrained instantiation.  CPU tensors take the plain versions beside
them; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.core.cycle import (
    GangInputs,
    PluginWeights,
    QuotaInputs,
    ReservationInputs,
    scan_fn,
    schedule_batch,
    score_batch,
    tie_base,
    tie_keys,
    tie_salt,
)
from koordinator_tpu_torch.core.gang import (
    GangArrays,
    GangPodArrays,
    commit_gangs,
    dense_gangs,
    gang_prefilter,
)
from koordinator_tpu_torch.core.loadaware import (
    LoadAwareNodeArrays,
    LoadAwarePodArrays,
    loadaware_filter,
    loadaware_score_plain,
)
from koordinator_tpu_torch.core.nodefit import (
    NodeFitNodeArrays,
    NodeFitPodArrays,
    NodeFitStatic,
    nodefit_filter,
    nodefit_score_plain,
)
from koordinator_tpu_torch.core.reservation import (
    ReservationArrays,
    match_index,
    nominate_with_ranks,
    order_ranks,
)

# packed-key infeasible sentinel; the fits_i32 guard keeps every real key
# clear of it
NEGK = -(1 << 30)
NEGK_THRESH = -(1 << 29)
# the int64 lanes' sentinel (masked totals and int64 keys), the JAX NEG
NEG = -(1 << 40)
NEG_THRESH = -(1 << 39)
IMPLS = ("auto", "matrix_packed", "matrix")


def _sentinel(dtype: torch.dtype) -> tuple:
    """(infeasible sentinel, placed threshold) of a key lane."""
    return (NEGK, NEGK_THRESH) if dtype == torch.int32 else (NEG, NEG_THRESH)


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (matrix_packed | matrix)")


def key_bound(plugin_weights: PluginWeights, extra_score_bound: int = 0) -> int:
    """The static score bound the packed key must hold (per-plugin scores
    are <= MaxNodeScore after normalization), plus the extra channel's."""
    return 100 * (
        plugin_weights.loadaware + plugin_weights.nodefit + plugin_weights.reservation
    ) + extra_score_bound


class ExtraInputs(NamedTuple):
    """A batch's frozen placement-and-devices inputs as the schedule kernels
    take them: node-major [N, P] in queue order, None when absent."""

    feas: Optional[torch.Tensor]  # [N, P] bool, ANDed into feasibility
    scores: Optional[torch.Tensor]  # [N, P] int64, added to the totals


def extra_inputs(extra_feasible, extra_scores, xs) -> Optional[ExtraInputs]:
    """Lay [P, N] submission-order extras out node-major in queue order
    ``xs`` (glue on the device); None when both are absent."""
    if extra_feasible is None and extra_scores is None:
        return None
    t = lambda a: None if a is None else a[xs].T.contiguous()  # noqa: E731
    return ExtraInputs(feas=t(extra_feasible), scores=t(extra_scores))


def _q_extras(xin: Optional[ExtraInputs], q_extra):
    """The plain versions' view of ``xin``: (the mask ANDed into
    ``q_extra`` [P, N], the [P, N] scores or None)."""
    if xin is None:
        return q_extra, None
    if xin.feas is not None:
        q_extra = q_extra & xin.feas.T
    return q_extra, None if xin.scores is None else xin.scores.T


def fits_i32(score_bound: int, num_nodes: int) -> bool:
    return (score_bound + 1) * tie_base(num_nodes) < (1 << 30)


def _rows(nt, idx):
    return type(nt)(*(a[idx] for a in nt))


def _queue(la_pods, nf_pods, order, N: int, tie_break: str):
    """(xs, pod arrays in queue order, per-pod tie salts): the salt of a
    pod follows its submission index, not its queue position."""
    P, dev = la_pods.est.shape[0], la_pods.est.device
    xs = torch.arange(P, device=dev) if order is None else order.to(dev)
    salts = (tie_salt(xs, N) if tie_break == "salted"
             else torch.zeros(xs.shape[0], dtype=torch.int32, device=dev))
    return xs, _rows(la_pods, xs), _rows(nf_pods, xs), salts


def _submission_order(hosts_q, scores_q, xs, P: int):
    """Scatter queue-order results back to submission order; pods outside
    a partial order stay unplaced."""
    hosts = torch.full((P,), -1, dtype=torch.int32, device=xs.device)
    hosts[xs] = hosts_q
    scores = torch.zeros(P, dtype=torch.int64, device=xs.device)
    scores[xs] = scores_q
    return hosts, scores


def _pack_keys(total, feas, salts, N: int, TB: int, neg: int = NEGK) -> torch.Tensor:
    """[P, N] packed ordering keys (score * TB + rotated tie bits), int64,
    ``neg`` where infeasible."""
    rot = torch.remainder(
        torch.arange(N, dtype=torch.int64, device=total.device)[None, :] + salts[:, None], N
    )
    key = total * TB + (TB - 1 - rot)
    return torch.where(feas, key, torch.full_like(key, neg))


def _rsv_cols(rsv_node, remain, midx, q_scores, colsc):
    """The reservation terms of the node columns ``colsc`` over the compact
    matched view: ([P, K, Rf] restored free capacity — the sum of the
    remainders of each pod's matched reservations on the column — and the
    [P, K] frozen reservation scores).  int64 adds are exact, so the sum
    over the matched rows equals the masked sum over every reservation."""
    ok = midx >= 0
    m = midx.clamp(min=0).long()
    hit = ok[:, None, :] & (rsv_node.long()[m][:, None, :] == colsc[None, :, None])  # [P, K, Mm]
    r_pm = remain[m]  # [P, Mm, Rf]
    extra = torch.where(hit[..., None], r_pm[:, None], torch.zeros_like(r_pm[:, None])).sum(dim=2)
    return extra, q_scores[:, colsc]


def _touched_scores(q_la, la, la_w, q_nf, nf, nf_static, plugin_weights, la_feas_T, q_extra_T,
                    colsc, rsv=None, q_xsc_T=None):
    """([P, K] int64 totals, [P, K] feasibility) of the touched node rows
    ``colsc`` against the current state (core/resolved.py
    touched_scores); ``rsv`` = (node, remain, midx, queue-order scores)
    adds the reservation restore and score, ``q_xsc_T`` [N, P] the extra
    scores."""
    la_cols, nf_cols = _rows(la, colsc), _rows(nf, colsc)
    tot = loadaware_score_plain(q_la, la_cols, la_w) * plugin_weights.loadaware
    tot = tot + nodefit_score_plain(q_nf, nf_cols, nf_static) * plugin_weights.nodefit
    extra = None
    if rsv is not None:
        extra, rs = _rsv_cols(*rsv, colsc)
        tot = tot + rs * plugin_weights.reservation
    if q_xsc_T is not None:
        tot = tot + q_xsc_T[colsc].T
    feas = (la_feas_T[colsc].T & nodefit_filter(q_nf, nf_cols, nf_static, extra)
            & q_extra_T[colsc].T)
    return tot, feas


def _touched_keys(q_la, la, la_w, q_nf, nf, nf_static, plugin_weights, la_feas_T, q_extra_T,
                  salts, colsc, TB, rsv=None, q_xsc_T=None, dtype=torch.int32):
    """[K, P] keys (of ``dtype``) of the touched node rows ``colsc``
    against the current state: ``_touched_scores`` and the key repack."""
    N = la.alloc.shape[0]
    tot, feas = _touched_scores(q_la, la, la_w, q_nf, nf, nf_static, plugin_weights, la_feas_T,
                                q_extra_T, colsc, rsv, q_xsc_T)
    rot = torch.remainder(colsc.to(torch.int64)[None, :] + salts[:, None], N)
    key = torch.where(feas, tot * TB + (TB - 1 - rot), torch.full_like(tot, _sentinel(dtype)[0]))
    return key.T.to(dtype)


def build_keys_plain(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights, q_extra,
                     salts, block_size: int, reservation=None, q_xsc=None,
                     key_dtype: torch.dtype = torch.int32):
    """The cold init: (M [N_pad, P], Mb [NB, P] of ``key_dtype`` — int32
    for the packed engine, int64 for the matrix engine's kernel —,
    la_feas_T [N, P] bool) for pods already in queue order; ``q_extra``
    [P, N] is every mask beyond the two plugin filters; ``reservation``
    (queue order) adds its restore and scores, ``q_xsc`` [P, N] the extra
    scores."""
    P, N = q_la.est.shape[0], la_nodes.alloc.shape[0]
    TB = tie_base(N)
    NB = -(-N // block_size)
    la_feas_T = loadaware_filter(q_la, la_nodes).T.contiguous()
    total, feas = score_batch(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights,
                              reservation)
    if q_xsc is not None:
        total = total + q_xsc
    neg = _sentinel(key_dtype)[0]
    M = _pack_keys(total, feas & q_extra, salts.to(torch.int64), N, TB, neg).T.to(key_dtype)
    if NB * block_size != N:
        pad = torch.full((NB * block_size - N, P), neg, dtype=key_dtype, device=M.device)
        M = torch.cat([M, pad], dim=0)
    M = M.contiguous()
    Mb = M.view(NB, block_size, P).amax(dim=1)
    return M, Mb, la_feas_T


def refresh_plain(M, Mb, la_feas_T, dirty, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
                  plugin_weights, q_extra, salts, block_size: int, rsv=None, q_xsc=None):
    """The warm carry's delta refresh, in place: for the node rows
    ``dirty`` [D] (padding repeats a real row), the real LoadAware filter
    into ``la_feas_T``, the packed keys into ``M`` from the current node
    state, then the block maxima of their blocks into ``Mb``; ``rsv`` as
    ``_touched_keys`` takes it, at the batch-start allocations.  Returns
    (M, Mb, la_feas_T)."""
    N, P = la_feas_T.shape
    NB = Mb.shape[0]
    d = dirty.to(torch.int64)
    la_feas_T[d] = loadaware_filter(q_la, _rows(la_nodes, d)).T
    M[d] = _touched_keys(
        q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights, la_feas_T, q_extra.T,
        salts.to(torch.int64), d, tie_base(N), rsv, None if q_xsc is None else q_xsc.T,
    )
    bc = torch.div(d, block_size, rounding_mode="floor")
    Mb[bc] = M.view(NB, block_size, P)[bc].amax(dim=1)
    return M, Mb, la_feas_T


class ConInputs(NamedTuple):
    """A cycle's gang, quota and reservation inputs as the constrained
    kernels and their plain versions take them (``con_inputs``).  Pod axes
    are in queue order unless noted."""

    xs: torch.Tensor  # [P] queue position -> submission row
    gang_row: torch.Tensor  # [P] int32
    gangs: GangArrays  # [G], the optional fields filled
    quota: Optional[QuotaInputs]  # pods in queue order
    rsv: Optional[ReservationArrays]  # batch-start allocations
    rsv_matched: Optional[torch.Tensor]  # [P, Rv] bool
    rsv_midx: Optional[torch.Tensor]  # [P, Mm] int32 matched rows ascending, -1 past the last
    rsv_rscore: Optional[torch.Tensor]  # [P_sub, Rv] int64, submission order
    rsv_scores: Optional[torch.Tensor]  # [P_sub, N] int64, submission order
    rsv_rank: Optional[torch.Tensor]  # [Rv] int64, order_ranks of rsv.order


def con_inputs(xs, gang=None, quota=None, reservation=None, rsv_match_bound=None, rsv_midx=None,
               rsv_rank=None) -> ConInputs:
    """Lay the constraint inputs out in queue order ``xs``.  ``rsv_midx``
    ([P_sub, Mm] int32, submission order) and ``rsv_rank`` may come from
    the caller (the engine builds both on the host); otherwise they are
    computed here, the match bound from ``matched`` unless given."""
    P, dev = xs.shape[0], xs.device
    if gang is None:
        one = torch.ones(1, dtype=torch.int64, device=dev)
        gangs = GangArrays(min_member=one * 0, member_count=one * 0,
                           has_init=one.bool(), once_satisfied=~one.bool())
        gang_row = torch.zeros(P, dtype=torch.int32, device=dev)
    else:
        gangs, gang_row = gang.gangs, gang.pods.gang[xs].to(torch.int32)
    q_quota = None
    if quota is not None:
        q_quota = quota._replace(pods=_rows(quota.pods, xs))
    rsv = matched = midx = rscore = scores = rank = None
    if reservation is not None:
        rsv, rscore, scores = reservation.rsv, reservation.rscore, reservation.scores
        matched = reservation.matched[xs]
        if rsv_midx is not None:
            midx = rsv_midx[xs]
        else:
            bound = rsv_match_bound
            if bound is None:
                bound = int(matched.sum(dim=1).max()) if matched.numel() else 1
            midx = match_index(matched, bound)
        rank = order_ranks(rsv.order)[0] if rsv_rank is None else rsv_rank
    return ConInputs(xs, gang_row, dense_gangs(gangs), q_quota, rsv, matched, midx, rscore,
                     scores, rank)


def gang_pass(con: ConInputs) -> torch.Tensor:
    """[P] bool gang_prefilter in queue order."""
    pods = GangPodArrays(gang=con.gang_row, priority=None, sub_priority=None, timestamp=None)
    return gang_prefilter(pods, con.gangs)


def rsv_view(con: ConInputs, allocated=None) -> tuple:
    """(node, remainders, match index, queue-order scores): the reservation
    terms the rescoring reads, at ``allocated`` (the batch start's when
    None)."""
    allocated = con.rsv.allocated if allocated is None else allocated
    return (con.rsv.node, con.rsv.allocatable - allocated, con.rsv_midx,
            con.rsv_scores[con.xs])


def _queue_rsv(con: ConInputs) -> Optional[ReservationInputs]:
    """The reservation inputs in queue order (the plain versions' view)."""
    if con.rsv is None:
        return None
    return ReservationInputs(rsv=con.rsv, matched=con.rsv_matched, rscore=con.rsv_rscore[con.xs],
                             scores=con.rsv_scores[con.xs])


def _chain(quota: QuotaInputs, depth: int) -> torch.Tensor:
    """[P, depth] the group rows each pod's consumption chain walks: its
    group, then its ancestors (row 0, the root, contributes nothing)."""
    g = quota.pods.quota.long()
    out = []
    for _ in range(depth):
        out.append(g)
        g = quota.parent[g].long()
    return torch.stack(out, dim=1) if out else g[:, None][:, :0]


def _admit(quota: QuotaInputs, used_at, npu_at, check_parent_depth: int) -> torch.Tensor:
    """[P] PreFilter verdicts; used_at/npu_at map a [P] group vector to the
    [P, R] aggregates seen at those groups (core/resolved.py
    _admit_batched)."""
    req, present = quota.pods.req, quota.pods.present
    g = quota.pods.quota.long()

    def admit_at(grp):
        return (~present | (used_at(grp) + req <= quota.limit[grp])).all(dim=-1)

    np_ok = (~present | (npu_at(g) + req <= quota.min[g])).all(dim=-1)
    ok = admit_at(g) & (np_ok | ~quota.pods.non_preemptible)
    grp = g
    for _ in range(check_parent_depth):
        grp = quota.parent[grp].long()
        ok = ok & ((grp == 0) | admit_at(grp))
    return ok


def _round_loop(pick, rescore, q_la, la_nodes, q_nf, nf_nodes, commit_cap: int,
                con: Optional[ConInputs], check_parent_depth: int, ancestor_depth: int):
    """The rounds shared by both engines (core/resolved.py quota_certainty
    and commit_core): per round every pending pod's pick from ``pick()``
    -> (picks [P], pick scores [P], has a feasible column [P]), the quota
    certainty, the first-picker rule, the prefix cut at the first blocked
    pod and at K placements, the assume path over <= K touched rows, then
    ``rescore(la, nf, rsv_terms, colsc)`` of the touched columns.  Returns
    (hosts, scores, precommit — before the gang rollback —, rounds, the
    rounds that took the quota upper bound) in queue order."""
    P, N = q_la.est.shape[0], la_nodes.alloc.shape[0]
    dev = q_la.est.device
    i64 = torch.int64
    K = min(commit_cap, max(P, 1))
    qpos = torch.arange(P, device=dev)
    committed = torch.zeros(P, dtype=torch.bool, device=dev)
    hosts = torch.full((P,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(P, dtype=i64, device=dev)
    la, nf = la_nodes, nf_nodes
    quota = None if con is None else con.quota
    if quota is not None:
        Rq = quota.used.shape[1]
        Q = quota.parent.shape[0]
        chain = _chain(quota, ancestor_depth)  # [P, D]
        eff_req = torch.where(quota.pods.present, quota.pods.req, torch.zeros_like(quota.pods.req))
        # [P, Q, 2R] what each pod's placement adds to each group: used | non-preemptible used
        chain_w = torch.zeros((P, Q), dtype=i64, device=dev).index_put(
            (qpos[:, None].expand_as(chain), chain), (chain != 0).to(i64), accumulate=True)
        contrib = chain_w[:, :, None] * eff_req[:, None, :]
        npm = quota.pods.non_preemptible.to(i64)[:, None, None]
        contrib_all = torch.cat([contrib, contrib * npm], dim=-1)
        used, npu = quota.used.clone(), quota.npu.clone()
    rsv_alloc = None
    if con is not None and con.rsv is not None:
        rsv, rank = con.rsv, con.rsv_rank
        Rv = rsv.node.shape[0]
        # rank r's reservation at r - 1 (the ranks are dense, 0 last)
        sorted_idx = torch.sort(torch.where(rank > 0, rank, torch.full_like(rank, Rv + 1)),
                                stable=True).indices
        rsv_alloc = rsv.allocated.clone()
        q_rscore = con.rsv_rscore[con.xs]
    rounds = ub_rounds = 0
    while P and not bool(committed.all()):
        pending = ~committed
        picks, pickscore, any_ok = pick()
        placed = pending & any_ok
        picks = torch.where(placed, picks, 0)
        pickscore = torch.where(placed, pickscore, 0)

        # quota_certainty: the verdict under the committed aggregates (the
        # lower bound) and under committed + every earlier candidate's
        # consumption (the upper bound, exclusive prefix sums)
        certain_admit = torch.ones(P, dtype=torch.bool, device=dev)
        certain_reject = torch.zeros(P, dtype=torch.bool, device=dev)
        if quota is not None:
            admit_lo = _admit(quota, lambda g: used[g], lambda g: npu[g], check_parent_depth)
            cand = pending & placed & admit_lo
            contrib_cand = torch.where(cand[:, None, None], contrib_all,
                                       torch.zeros_like(contrib_all))
            tp = contrib_cand.sum(dim=0)  # [Q, 2R]
            zero_r = torch.zeros_like(eff_req)
            mr = torch.where(pending[:, None], eff_req, zero_r).amax(dim=0)
            mr_npu = torch.where((pending & quota.pods.non_preemptible)[:, None], eff_req,
                                 zero_r).amax(dim=0)
            # the shortcut: every group keeps headroom for one more maximal
            # request after every candidate consumed, so both bounds agree
            safe = bool(
                (used + tp[:, :Rq] + mr[None] <= quota.limit)[1:].all()
                & (npu + tp[:, Rq:] + mr_npu[None] <= quota.min)[1:].all()
            )
            admit_hi = admit_lo
            if not safe:
                ub_rounds += 1
                exc = torch.cumsum(contrib_cand, dim=0) - contrib_cand  # [P, Q, 2R]

                def at_hi(lo, base):
                    return lambda g: base[g] + exc[qpos, g, lo:lo + Rq]

                admit_hi = _admit(quota, at_hi(0, used), at_hi(Rq, npu), check_parent_depth)
            certain_admit, certain_reject = admit_hi, ~admit_lo

        # commit_core: the first-picker rule among the blockers, the prefix
        # cut at the first blocked pod and at K placements
        blockers = pending & placed & ~certain_reject
        node_first = torch.full((N,), P, dtype=i64, device=dev).scatter_reduce(
            0, torch.where(blockers, picks, 0), torch.where(blockers, qpos, P),
            reduce="amin", include_self=True,
        )
        is_first = blockers & (node_first[picks] == qpos)
        blocked = blockers & ~(is_first & certain_admit)
        first_blocked = torch.where(blocked, qpos, P).min()
        in_prefix = pending & (qpos < first_blocked)
        place_mask = in_prefix & placed & certain_admit
        placed_rank = torch.cumsum(place_mask.to(i64), 0)
        overflow = place_mask & (placed_rank > K)
        cutpos = torch.where(overflow, qpos, P).min()
        in_prefix = in_prefix & (qpos < cutpos)
        place_mask = place_mask & in_prefix
        hosts = torch.where(in_prefix, torch.where(place_mask, picks, -1), hosts).to(torch.int32)
        scores = torch.where(place_mask, pickscore, torch.where(in_prefix, 0, scores))
        committed = committed | in_prefix

        col_slot = torch.where(place_mask, placed_rank - 1, K)
        cols = torch.full((K + 1,), N, dtype=i64, device=dev).index_put(
            (col_slot[place_mask],), picks[place_mask])[:K]
        pod_slot = torch.zeros(K + 1, dtype=i64, device=dev).index_put(
            (col_slot[place_mask],), qpos[place_mask])[:K]
        slot_ok = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_put(
            (col_slot[place_mask],), place_mask[place_mask])[:K]
        colsc = cols.clamp(max=N - 1)
        sv = slot_ok[:, None].to(i64)
        est_rows = q_la.est[pod_slot] * sv
        la = la._replace(
            base_nonprod=la.base_nonprod.index_add(0, colsc, est_rows),
            base_prod=la.base_prod.index_add(
                0, colsc, est_rows * q_la.is_prod_class[pod_slot].to(i64)[:, None]
            ),
        )
        nf = nf._replace(
            requested=nf.requested.index_add(0, colsc, q_nf.req[pod_slot] * sv),
            req_score=nf.req_score.index_add(0, colsc, q_nf.req_score[pod_slot] * sv),
            num_pods=nf.num_pods.index_add(0, colsc, slot_ok.to(i64)),
        )
        if quota is not None:
            dq = (contrib_all[pod_slot] * sv[:, None, :1]).sum(dim=0)
            used, npu = used + dq[:, :Rq], npu + dq[:, Rq:]
        rsv_terms = None
        if rsv_alloc is not None:
            # nominate per committed slot; committed pods sit on distinct
            # nodes, so the nominated rows are distinct
            noms, has = nominate_with_ranks(con.rsv_matched[pod_slot], q_rscore[pod_slot], rsv,
                                            cols, rank, sorted_idx)
            remain = rsv.allocatable - rsv_alloc
            consume = torch.clamp(torch.minimum(q_nf.req[pod_slot], remain[noms]), min=0)
            take = slot_ok & has
            consume = torch.where(take[:, None], consume, torch.zeros_like(consume))
            rsv_alloc = rsv_alloc.index_add(0, torch.where(take, noms, 0), consume)
            rsv_terms = rsv_view(con, rsv_alloc)
        rescore(la, nf, rsv_terms, colsc)
        rounds += 1
    precommit = hosts
    if con is not None:
        pods = GangPodArrays(gang=con.gang_row, priority=None, sub_priority=None, timestamp=None)
        hosts, _ = commit_gangs(precommit, pods, con.gangs)
        scores = torch.where(hosts >= 0, scores, torch.zeros_like(scores))
    return hosts, scores, precommit, rounds, ub_rounds


def _loop_result(out, con):
    """The round loop's results as the callers return them: (hosts, scores,
    rounds), or with ``con`` (hosts, scores, precommit, rounds, rounds on
    the quota upper bound)."""
    return (out[0], out[1], out[3]) if con is None else out


def run_rounds_plain(M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
                     plugin_weights, q_extra, salts, commit_cap: int, block_size: int,
                     con: Optional[ConInputs] = None, check_parent_depth: int = 0,
                     ancestor_depth: int = 8, q_xsc=None):
    """The packed engine's round loop from the init state (core/resolved.py
    round_body): each round's picks are the per-pod maxima over ``Mb``
    decoded from the keys' low bits; the touched rows are rekeyed and
    their blocks re-reduced.  ``M``/``Mb`` hold int32 keys (the packed
    engine) or int64 keys (the matrix engine's kernel layout) and are
    updated in place.  ``q_extra`` [P, N] holds every pod/node mask (the
    gang prefilter included), ``q_xsc`` [P, N] the extra scores.  Returns
    (hosts, scores, rounds) in queue order; with ``con`` the constrained
    loop (quota certainty and consumption, reservation nomination and
    consumption with the restore in the rescoring, then commit_gangs),
    returning (hosts, scores, precommit — before the gang rollback —,
    rounds, the rounds that took the quota upper bound)."""
    N = la_nodes.alloc.shape[0]
    TB = tie_base(N)
    NB = Mb.shape[0]
    P = M.shape[1]
    thresh = _sentinel(M.dtype)[1]
    salts64 = salts.to(torch.int64)
    q_extra_T = q_extra.T
    q_xsc_T = None if q_xsc is None else q_xsc.T

    def pick():
        vmax = Mb.amax(dim=0).to(torch.int64)
        rot = TB - 1 - torch.remainder(vmax, TB)
        picks = torch.remainder(rot - salts64 + N, N)
        return picks, torch.div(vmax, TB, rounding_mode="floor"), vmax > thresh

    def rescore(la, nf, rsv_terms, colsc):
        M[colsc] = _touched_keys(
            q_la, la, la_w, q_nf, nf, nf_static, plugin_weights, la_feas_T, q_extra_T,
            salts64, colsc, TB, rsv_terms, q_xsc_T, M.dtype,
        )
        bc = torch.div(colsc, block_size, rounding_mode="floor")
        Mb[bc] = M.view(NB, block_size, P)[bc].amax(dim=1)

    return _loop_result(_round_loop(pick, rescore, q_la, la_nodes, q_nf, nf_nodes, commit_cap,
                                    con, check_parent_depth, ancestor_depth), con)


def masked_init(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights, q_extra,
                reservation=None, q_xsc=None):
    """The matrix engine's init state: (M [P, N] int64 masked totals, NEG
    where infeasible, la_feas_T [N, P] bool) for pods in queue order
    (core/resolved.py run_matrix)."""
    la_feas_T = loadaware_filter(q_la, la_nodes).T.contiguous()
    total, feas = score_batch(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights,
                              reservation)
    if q_xsc is not None:
        total = total + q_xsc
    M = torch.where(feas & q_extra, total, torch.full_like(total, NEG))
    return M, la_feas_T


def run_matrix_plain(M, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
                     plugin_weights, q_extra, salts, commit_cap: int,
                     con: Optional[ConInputs] = None, check_parent_depth: int = 0,
                     ancestor_depth: int = 8, q_xsc=None):
    """The matrix engine's round loop (core/resolved.py run_matrix) from
    ``masked_init``: each round's pick is the composite-key argmax of the
    [P, N] masked totals (the score, then the rotated index: salts of 0
    give the lowest index), the touched columns are rescored.  ``M`` is
    updated in place.  Returns what ``run_rounds_plain`` returns; the
    outputs and the round count equal the int64-key kernel's."""
    N = la_nodes.alloc.shape[0]
    salts64 = salts.to(torch.int64)
    q_extra_T = q_extra.T
    q_xsc_T = None if q_xsc is None else q_xsc.T

    def pick():
        picks = torch.argmax(tie_keys(M, salts64[:, None]), dim=1)
        pickval = M.gather(1, picks[:, None])[:, 0]
        return picks, pickval, pickval > NEG_THRESH

    def rescore(la, nf, rsv_terms, colsc):
        tot, feas = _touched_scores(q_la, la, la_w, q_nf, nf, nf_static, plugin_weights,
                                    la_feas_T, q_extra_T, colsc, rsv_terms, q_xsc_T)
        M[:, colsc] = torch.where(feas, tot, torch.full_like(tot, NEG))

    return _loop_result(_round_loop(pick, rescore, q_la, la_nodes, q_nf, nf_nodes, commit_cap,
                                    con, check_parent_depth, ancestor_depth), con)


def schedule_batch_resolved(
    la_pods: LoadAwarePodArrays,
    la_nodes: LoadAwareNodeArrays,
    la_weights: torch.Tensor,
    nf_pods: NodeFitPodArrays,
    nf_nodes: NodeFitNodeArrays,
    nf_static: NodeFitStatic,
    plugin_weights: PluginWeights = PluginWeights(),
    extra_feasible: Optional[torch.Tensor] = None,
    order: Optional[torch.Tensor] = None,
    gang: Optional[GangInputs] = None,
    quota: Optional[QuotaInputs] = None,
    reservation: Optional[ReservationInputs] = None,
    check_parent_depth: int = 0,
    ancestor_depth: int = 8,
    commit_cap: int = 16,
    tie_break: str = "salted",
    block_size: int = 16,
    extra_scores: Optional[torch.Tensor] = None,
    extra_score_bound: int = 0,
    return_rounds: bool = False,
    return_precommit: bool = False,
    rsv_match_bound: Optional[int] = None,
    warm_init: Optional[tuple] = None,
    dirty_cols: Optional[torch.Tensor] = None,
    refresh_only: bool = False,
    return_warm: bool = False,
    impl: str = "auto",
):
    """``schedule_batch`` bit-for-bit (same ``tie_break``), via
    prefix-committed rounds, plain PyTorch.  commit_cap and block_size do
    not affect results.  Returns (hosts, scores[, rounds][, precommit][,
    warm]).

    ``impl`` as in the JAX package: ``"auto"`` takes ``matrix_packed``
    when the packed key's bound fits int32, else ``matrix`` (also when
    ``matrix_packed`` is asked for beyond the bound); an unknown name
    raises ``ValueError`` on every path.  Under a strategy other than
    LeastAllocated the scan answers, with every constraint and the extras,
    reporting 0 rounds and its post-commit hosts as ``precommit``.

    Gang, quota and reservation inputs take the constrained round loop:
    quota admission decided only when provable, reservation restore,
    scores and nomination, and the gang rollback after the rounds
    (``precommit`` is the assignment before it).  The restore contracts
    over the compact matched view (``rsv_match_bound`` matches per pod at
    most; computed from ``matched`` when not given).

    The warm start, as in the JAX package: ``warm_init`` (M [N_pad, P]
    int32, Mb [NB, P] int32, la_feas_T [N, P] bool) is the init state a
    cold run over the same inputs would build, and the rounds start from
    it; ``refresh_only`` rebuilds its ``dirty_cols`` rows against the
    current inputs and returns the refreshed carry instead of scheduling;
    ``return_warm`` appends a cold run's init carry to the outputs.  The
    caller's carry tensors are never written.

    ``extra_scores`` [P, N] (pre-weighted, frozen for the batch) adds to
    every pair's total; ``extra_score_bound`` bounds it for the packed
    key."""
    check_impl(impl)
    constrained = gang is not None or quota is not None or reservation is not None
    P_full = la_pods.est.shape[0]
    N = la_nodes.alloc.shape[0]
    dev = la_pods.est.device
    wants_warm = warm_init is not None or refresh_only or return_warm
    if refresh_only and (warm_init is None or dirty_cols is None):
        raise ValueError("refresh_only requires warm_init and dirty_cols")
    if nf_static.strategy != "LeastAllocated" and wants_warm:
        raise ValueError(
            "warm-start schedule requires the LeastAllocated matrix engine "
            "(monotonicity precondition)"
        )
    if nf_static.strategy != "LeastAllocated":
        # monotonicity precondition: other strategies take the scan
        hosts, scores = schedule_batch(
            la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static, plugin_weights,
            extra_feasible, order, gang, quota, reservation, check_parent_depth, ancestor_depth,
            tie_break, extra_scores,
        )
        out = (hosts, scores)
        if return_rounds:
            out = out + (0,)
        return out + (hosts,) if return_precommit else out
    fits = fits_i32(key_bound(plugin_weights, extra_score_bound), N)
    if impl == "auto" or not fits:
        impl = "matrix_packed" if fits else "matrix"
    if wants_warm and impl != "matrix_packed":
        raise ValueError(
            "warm-start flags require the matrix_packed engine (score bound "
            f"{key_bound(plugin_weights, extra_score_bound)} with tie base {tie_base(N)} does "
            "not fit the int32 key lane)"
        )
    xs, q_la, q_nf, salts = _queue(la_pods, nf_pods, order, N, tie_break)
    q_xsc = None if extra_scores is None else extra_scores[xs]
    if extra_feasible is None:
        q_extra = torch.ones((xs.shape[0], N), dtype=torch.bool, device=dev)
    else:
        q_extra = extra_feasible[xs]
    con = None
    if constrained:
        con = con_inputs(xs, gang, quota, reservation, rsv_match_bound)
        q_extra = q_extra & gang_pass(con)[:, None]
    if refresh_only:
        rsv = rsv_view(con) if con is not None and con.rsv is not None else None
        return refresh_plain(
            *(a.clone() for a in warm_init), dirty_cols, q_la, la_nodes, la_weights, q_nf,
            nf_nodes, nf_static, plugin_weights, q_extra, salts, block_size, rsv, q_xsc,
        )
    rsv_q = None if con is None else _queue_rsv(con)
    if impl == "matrix":
        M0, la_feas_T = masked_init(q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static,
                                    plugin_weights, q_extra, rsv_q, q_xsc)
        out = run_matrix_plain(
            M0, la_feas_T, q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static, plugin_weights,
            q_extra, salts, commit_cap, con, check_parent_depth, ancestor_depth, q_xsc,
        )
    else:
        if warm_init is not None:
            M0, Mb0, la_feas_T = warm_init
        else:
            M0, Mb0, la_feas_T = build_keys_plain(
                q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static, plugin_weights, q_extra,
                salts, block_size, rsv_q, q_xsc,
            )
        out = run_rounds_plain(
            M0.clone(), Mb0.clone(), la_feas_T, q_la, la_nodes, la_weights, q_nf, nf_nodes,
            nf_static, plugin_weights, q_extra, salts, commit_cap, block_size, con,
            check_parent_depth, ancestor_depth, q_xsc,
        )
    if con is None:
        hosts_q, scores_q, rounds = out
        pre_q = hosts_q
    else:
        hosts_q, scores_q, pre_q, rounds, _ = out
    hosts, scores = _submission_order(hosts_q, scores_q, xs, P_full)
    out = (hosts, scores)
    if return_rounds:
        out = out + (rounds,)
    if return_precommit:
        out = out + (_submission_order(pre_q, scores_q, xs, P_full)[0],)
    if return_warm:
        out = out + ((M0, Mb0, la_feas_T),)
    return out


# ------------------------------------------------------------------ kernels


def kernel_queue(la_pods, nf_pods, valid, p_real: int, order, tie_break: str = "salted"):
    """The kernels' pod inputs in queue order, as the JAX engine's
    ``schedule_fn`` lays them out: (xs, pod arrays in queue order, the tie
    salts — 0 under ``"index"`` —, ``pod_ok`` marking the real, unpadded
    pod rows)."""
    xs, q_la, q_nf, salts = _queue(la_pods, nf_pods, order, valid.shape[0], tie_break)
    pod_ok = (torch.arange(la_pods.est.shape[0], device=valid.device) < p_real)[xs]
    return xs, q_la, q_nf, salts, pod_ok


def con_scratch_words(P: int, Q: int, Rq: int, G: int, cpd: int, ad: int) -> int:
    """int64 words of the constrained round kernel's global scratch, in the
    layout ``rounds_kernel`` reads (csrc/schedule.cu): the candidate
    totals [Q, 2R], the exclusive prefixes at each pod's admission groups
    [P, cpd+1, 2R], the gang counts [2, G], then int32 words for the
    per-group entry lists (offsets [Q+1], entries [P * ad])."""
    i32 = (Q + 1) + P * ad
    return Q * 2 * Rq + P * (cpd + 1) * 2 * Rq + 2 * G + (i32 + 1) // 2


_CON_PTRS = 26
_CON_INTS = 10


def _xin_args(xin: Optional[ExtraInputs], P: int, N: int, dev) -> tuple:
    """The extras' two device pointers (0 when absent), checked before any
    launch, and the tensors to keep alive."""
    if xin is None:
        return 0, 0, ()
    feas = sc = None
    if xin.feas is not None:
        feas = cuda._checked(xin.feas, torch.bool, (N, P), dev, "extra feasibility")
    if xin.scores is not None:
        sc = cuda._checked(xin.scores, torch.int64, (N, P), dev, "extra scores")
    return (0 if feas is None else feas.data_ptr(), 0 if sc is None else sc.data_ptr(),
            (feas, sc))


@functools.lru_cache(maxsize=16)
def _absent(dev: torch.device) -> torch.Tensor:
    """One int64 word on ``dev`` standing for a constraint the launch does
    not have (no kernel reads it: ``has_quota``/``has_rsv`` are 0) and for
    the scratch of a launch that takes none; allocated once a device."""
    return torch.zeros(1, dtype=torch.int64, device=dev)


class ConTables(NamedTuple):
    """The constraint inputs checked and laid out in ``koord_con``'s order
    (csrc/pair.cuh), without the launch's own scratch: ``tabs`` [25]
    tensors, then (G, Q, Rq, Rv, Mm) and whether quota and reservations
    are present."""

    tabs: tuple
    dims: tuple
    has_quota: bool
    has_rsv: bool


def _con_tables(con: ConInputs, P: int, N: int, Rf: int, dev) -> ConTables:
    i64, i32, b = torch.int64, torch.int32, torch.bool
    g = con.gangs
    G = g.min_member.shape[0]
    tabs = [
        cuda._checked(con.gang_row, i32, (P,), dev, "gang rows"),
        cuda._checked(g.min_member, i64, (G,), dev, "gang min_member"),
        cuda._checked(g.member_count, i64, (G,), dev, "gang member_count"),
        cuda._checked(g.has_init, b, (G,), dev, "gang has_init"),
        cuda._checked(g.once_satisfied, b, (G,), dev, "gang once_satisfied"),
        cuda._checked(g.group.to(i32), i32, (G,), dev, "gang group"),
        cuda._checked(g.bound_count, i64, (G,), dev, "gang bound_count"),
        cuda._checked(g.non_strict, b, (G,), dev, "gang non_strict"),
    ]
    q = con.quota
    Q = Rq = 1
    if q is not None:
        Q, Rq = q.used.shape
        if Rq > cuda.MAXR:
            raise ValueError(f"{Rq} quota dimensions exceed {cuda.MAXR}")
        tabs += [
            cuda._checked(q.pods.quota, i32, (P,), dev, "quota rows"),
            cuda._checked(q.pods.req, i64, (P, Rq), dev, "quota req"),
            cuda._checked(q.pods.present, b, (P, Rq), dev, "quota present"),
            cuda._checked(q.pods.non_preemptible, b, (P,), dev, "quota non_preemptible"),
            cuda._checked(q.used, i64, (Q, Rq), dev, "quota used"),
            cuda._checked(q.npu, i64, (Q, Rq), dev, "quota npu"),
            cuda._checked(q.limit, i64, (Q, Rq), dev, "quota limit"),
            cuda._checked(q.min, i64, (Q, Rq), dev, "quota min"),
            cuda._checked(q.parent, i32, (Q,), dev, "quota parent"),
        ]
    else:
        tabs += [_absent(dev)] * 9
    Rv = Mm = 0
    if con.rsv is not None:
        r = con.rsv
        Rv, Mm = r.node.shape[0], con.rsv_midx.shape[1]
        P_sub = con.rsv_scores.shape[0]
        tabs += [
            cuda._checked(r.node, i32, (Rv,), dev, "reservation node"),
            cuda._checked(r.allocatable, i64, (Rv, Rf), dev, "reservation allocatable"),
            cuda._checked(r.allocated, i64, (Rv, Rf), dev, "reservation allocated"),
            cuda._checked(con.rsv_rank, i64, (Rv,), dev, "reservation rank"),
            cuda._checked(con.rsv_midx, i32, (P, Mm), dev, "reservation match index"),
            cuda._checked(con.rsv_rscore, i64, (P_sub, Rv), dev, "reservation rscore"),
            cuda._checked(con.rsv_scores, i64, (P_sub, N), dev, "reservation scores"),
            cuda._checked(con.xs.to(i32), i32, (P,), dev, "queue order"),
        ]
    else:
        tabs += [_absent(dev)] * 8
    return ConTables(tuple(tabs), (G, Q, Rq, Rv, Mm), q is not None, con.rsv is not None)


def _con_launch_args(con: ConInputs, P: int, N: int, Rf: int, dev, rounds: bool, cpd: int,
                     ad: int, w_rsv: int, words: Optional[int] = None,
                     tables: Optional[ConTables] = None):
    """The constrained kernels' (pointer table, int64 parameter block,
    tensors to keep alive), laid out as ``koord_con`` in csrc/pair.cuh
    reads them; ``tables`` the inputs already checked (``_con_tables``).
    The round and scan kernels (``rounds``) get private copies of the
    quota aggregates and the reservation allocations, which they update,
    and a zeroed global scratch of ``words`` int64 words (the round
    kernel's ``con_scratch_words`` when None); the other launches read
    neither."""
    if tables is None:
        tables = _con_tables(con, P, N, Rf, dev)
    G, Q, Rq, Rv, Mm = tables.dims
    if tables.has_quota and not 0 <= cpd < ad <= 16:
        raise ValueError(f"the kernels take 0 <= check_parent_depth < ancestor_depth <= 16, "
                         f"got {cpd}, {ad}")
    tabs = list(tables.tabs)
    if rounds:
        if tables.has_quota:  # the quota used and non-preemptible used
            tabs[12], tabs[13] = tabs[12].clone(), tabs[13].clone()
        if tables.has_rsv:  # the reservation allocations
            tabs[19] = tabs[19].clone()
        if words is None:
            words = con_scratch_words(P, Q, Rq, G, cpd, ad)
        tabs.append(torch.zeros(max(words, 1), dtype=torch.int64, device=dev))
    else:
        tabs.append(_absent(dev))
    ptrs = (ctypes.c_void_p * _CON_PTRS)(*(t.data_ptr() for t in tabs))
    ints = (ctypes.c_longlong * _CON_INTS)(G, Q, Rq, Rv, Mm, cpd, ad, w_rsv,
                                            int(tables.has_quota), int(tables.has_rsv))
    return ptrs, ints, (tabs, ptrs, ints)


class WarmArgs(NamedTuple):
    """A warm cycle's launch arguments, checked and laid out once
    (``warm_args``) and shared by its refresh and its round loop: the
    pair tables, the pod mask and salts, the constraint tables (or
    None), and the refresh's constraint pointer table and parameter block
    (or None)."""

    pair: cuda.PairArgs
    pod_ok: torch.Tensor
    salts: torch.Tensor
    con: Optional[ConTables]
    refresh_con: Optional[tuple]


def warm_args(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok, salts,
              con: Optional[ConInputs] = None) -> Optional[WarmArgs]:
    """Check and lay out a warm cycle's launch arguments once, for its
    ``schedule_refresh`` and ``schedule_rounds_warm`` (their ``args``);
    None on the CPU, where both take their plain versions."""
    dev = valid.device
    if dev.type == "cpu":
        return None
    P, N = q_la.est.shape[0], valid.shape[0]
    pair = cuda.pair_args(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid)
    tables = refresh_con = None
    if con is not None:
        tables = _con_tables(con, P, N, q_nf.req.shape[1], dev)
        refresh_con = _con_launch_args(con, P, N, q_nf.req.shape[1], dev, False, 0, 1,
                                       PluginWeights().reservation, tables=tables)
    return WarmArgs(pair, cuda._checked(pod_ok, torch.bool, (P,), dev, "pod_ok"),
                    cuda._checked(salts, torch.int32, (P,), dev, "salts"), tables, refresh_con)


def schedule_keys(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok, salts,
                  block_size: int, con: Optional[ConInputs] = None,
                  xin: Optional[ExtraInputs] = None, wide: bool = False,
                  la_feas: bool = True):
    """First launch of the ``schedule`` kernel: the cold key build for pods
    in queue order under the default plugin weights and any NodeFit
    strategy, the extra mask factorized as ``pod_ok[q] & valid[n]``;
    ``con`` adds the gang prefilter and the reservation restore and scores
    (the constrained instantiation), ``xin`` the placement-and-devices mask
    and scores; ``wide`` builds the int64 keys (``schedule_keys64``: the
    matrix engine's, and the scan's) instead of the packed int32 ones;
    ``la_feas=False`` leaves out the LoadAware filter, which only the round
    loop reads.  Returns (M, Mb, la_feas_T or None)."""
    P, N = q_la.est.shape[0], valid.shape[0]
    dev = valid.device
    kdt = torch.int64 if wide else torch.int32
    if con is not None:  # the constraint inputs are checked on every device
        con_args = _con_launch_args(con, P, N, q_nf.req.shape[1], dev, False, 0, 1,
                                    PluginWeights().reservation)
    xf, xsc, xkeep = _xin_args(xin, P, N, dev)
    if dev.type == "cpu":
        q_extra = pod_ok[:, None] & valid[None, :]
        rsv = None
        if con is not None:
            q_extra = q_extra & gang_pass(con)[:, None]
            rsv = _queue_rsv(con)
        q_extra, q_xsc = _q_extras(xin, q_extra)
        M, Mb, la_feas_T = build_keys_plain(
            q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, PluginWeights(), q_extra, salts,
            block_size, rsv, q_xsc, kdt,
        )
        return M, Mb, la_feas_T if la_feas else None
    args = cuda.pair_args(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid)
    NB = -(-N // block_size)
    pod_ok = cuda._checked(pod_ok, torch.bool, (P,), dev, "pod_ok")
    salts = cuda._checked(salts, torch.int32, (P,), dev, "salts")
    M = torch.empty((NB * block_size, P), dtype=kdt, device=dev)
    Mb = torch.empty((NB, P), dtype=kdt, device=dev)
    la_feas_T = torch.empty((N, P), dtype=torch.bool, device=dev) if la_feas else None
    head = (args.pods, args.nodes, args.cfg, args.la_w, args.valid, pod_ok.data_ptr(),
            salts.data_ptr(), xf, xsc, P, N, block_size, tie_base(N))
    tail = (M.data_ptr(), Mb.data_ptr(), 0 if la_feas_T is None else la_feas_T.data_ptr(),
            cuda.device_index(dev), cuda.stream(dev))
    if con is None:
        if P and N:
            (cuda.SCHEDULE_KEYS64 if wide else cuda.SCHEDULE_KEYS).launch(*head, *tail)
        return M, Mb, la_feas_T
    ptrs, ints, keep = con_args
    if P and N:
        (cuda.SCHEDULE_KEYS64_CON if wide else cuda.SCHEDULE_KEYS_CON).launch(*head, ptrs, ints,
                                                                             *tail)
    return M, Mb, la_feas_T


def _launch_rounds(kernel, M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
                   valid, pod_ok, salts, commit_cap: int, block_size: int, con=None,
                   check_parent_depth: int = 0, ancestor_depth: int = 8, xin=None,
                   args: Optional[WarmArgs] = None):
    """One cooperative launch of the round-loop kernel on CUDA tensors,
    counted on ``kernel``; ``M``/``Mb`` are updated in place.  The grid
    spreads the pods over up to one block a SM (``cuda.rounds_grid``).
    ``args``: the inputs already checked (``warm_args``); the kernel's
    private copies of the node state it commits into are made here either
    way (``cuda.with_private_nodes``)."""
    P, N = q_la.est.shape[0], valid.shape[0]
    dev = valid.device
    K = min(commit_cap, max(P, 1))
    kdt = M.dtype
    kb = 8 if kdt == torch.int64 else 4
    smem = cuda.rounds_smem(P, K, kb)
    if con is not None:
        smem = cuda.rounds_smem_con(P, K, ancestor_depth, con.quota is not None, kb)
    if smem > cuda.MAX_SMEM:
        raise ValueError(f"{P} pods exceed the round kernel's shared memory")
    NB = -(-N // block_size)
    if args is None:
        pa = cuda.pair_args(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid)
        pod_ok = cuda._checked(pod_ok, torch.bool, (P,), dev, "pod_ok")
        salts = cuda._checked(salts, torch.int32, (P,), dev, "salts")
    else:
        pa, pod_ok, salts = args.pair, args.pod_ok, args.salts
    pa = cuda.with_private_nodes(pa)
    M = cuda._checked(M, kdt, (NB * block_size, P), dev, "M")
    Mb = cuda._checked(Mb, kdt, (NB, P), dev, "Mb")
    la_feas_T = cuda._checked(la_feas_T, torch.bool, (N, P), dev, "la_feas_T")
    xf, xsc, xkeep = _xin_args(xin, P, N, dev)
    hosts = torch.full((P,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(P, dtype=torch.int64, device=dev)
    scratch = torch.empty(cuda.rounds_scratch_words(P, K, N), dtype=torch.int64, device=dev)
    G = cuda.rounds_grid(P, N, block_size, K, cuda.sm_count(dev)) if P and N else 1
    head = (pa.pods, pa.nodes, pa.cfg, pa.la_w, pa.valid, pod_ok.data_ptr(),
            salts.data_ptr(), xf, xsc, P, N, block_size, tie_base(N), K, G)
    if con is None:
        rounds = torch.zeros(1, dtype=torch.int32, device=dev)
        if P and N:
            kernel.launch(
                *head, M.data_ptr(), Mb.data_ptr(), la_feas_T.data_ptr(), scratch.data_ptr(),
                hosts.data_ptr(), scores.data_ptr(), rounds.data_ptr(), cuda.device_index(dev),
                cuda.stream(dev),
            )
        return hosts, scores, rounds[0]
    precommit = torch.full((P,), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros(2, dtype=torch.int32, device=dev)
    ptrs, ints, keep = _con_launch_args(con, P, N, q_nf.req.shape[1], dev, True,
                                        check_parent_depth, ancestor_depth,
                                        PluginWeights().reservation,
                                        tables=None if args is None else args.con)
    if P and N:
        kernel.launch(
            *head, ptrs, ints, M.data_ptr(), Mb.data_ptr(), la_feas_T.data_ptr(),
            scratch.data_ptr(), hosts.data_ptr(), scores.data_ptr(), precommit.data_ptr(),
            rounds.data_ptr(), cuda.device_index(dev), cuda.stream(dev),
        )
    return hosts, scores, precommit, rounds


def _check_keys(M, Mb, la_feas_T, P: int, N: int, block_size: int, dev) -> None:
    """The round loop's key inputs, on any device before any launch: M
    [N_pad, P] and Mb [N_pad / block_size, P] of one key lane (int32 or
    int64), la_feas_T [N, P] bool."""
    if M.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"M: expected int32 or int64 keys, got {M.dtype}")
    NB = -(-N // block_size)
    cuda._checked(M, M.dtype, (NB * block_size, P), dev, "M")
    cuda._checked(Mb, M.dtype, (NB, P), dev, "Mb")
    cuda._checked(la_feas_T, torch.bool, (N, P), dev, "la_feas_T")


def _plain_rounds(M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid,
                  pod_ok, salts, commit_cap: int, block_size: int, con=None,
                  check_parent_depth: int = 0, ancestor_depth: int = 8, xin=None):
    q_extra, q_xsc = _q_extras(xin, pod_ok[:, None] & valid[None, :])
    if con is None:
        hosts, scores, rounds = run_rounds_plain(
            M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, PluginWeights(),
            q_extra, salts, commit_cap, block_size, q_xsc=q_xsc,
        )
        return hosts, scores, torch.tensor(rounds, dtype=torch.int32)
    hosts, scores, pre, rounds, ub = run_rounds_plain(
        M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, PluginWeights(),
        q_extra & gang_pass(con)[:, None], salts, commit_cap, block_size, con,
        check_parent_depth, ancestor_depth, q_xsc,
    )
    return hosts, scores, pre, torch.tensor([rounds, ub], dtype=torch.int32)


def schedule_rounds(M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid,
                    pod_ok, salts, commit_cap: int, block_size: int, con=None,
                    check_parent_depth: int = 0, ancestor_depth: int = 8, xin=None):
    """Second launch of the ``schedule`` kernel: the whole round loop under
    the default plugin weights.  Returns (hosts [P] int32, scores [P]
    int64, rounds as a 0-d int32 tensor) in queue order; with ``con``
    (the constrained instantiation) (hosts after the gang rollback,
    scores, precommit hosts before it, [rounds, rounds that took the quota
    upper bound] as an int32 tensor).  ``M``/``Mb`` are consumed (updated
    in place); the node arrays, quota aggregates and reservation
    allocations are not touched (the kernel commits into private
    copies).  ``xin`` is the batch's placement-and-devices mask and scores,
    which the rescoring reads as the key build did.  int64 ``M``/``Mb``
    (``schedule_keys(wide=True)``) take the matrix engine's int64-key
    round loop (``schedule_rounds64``).  LeastAllocated only."""
    cuda.require_least_allocated(nf_static, "the schedule round loop")
    _check_keys(M, Mb, la_feas_T, q_la.est.shape[0], valid.shape[0], block_size, valid.device)
    args = (M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok,
            salts, commit_cap, block_size, con, check_parent_depth, ancestor_depth, xin)
    if valid.device.type == "cpu":
        if con is not None:
            _con_launch_args(con, q_la.est.shape[0], valid.shape[0], q_nf.req.shape[1],
                             valid.device, False, check_parent_depth, ancestor_depth, 1)
        return _plain_rounds(*args)
    if M.dtype == torch.int64:
        kernel = cuda.SCHEDULE_ROUNDS64 if con is None else cuda.SCHEDULE_ROUNDS64_CON
    else:
        kernel = cuda.SCHEDULE_ROUNDS if con is None else cuda.SCHEDULE_ROUNDS_CON
    return _launch_rounds(kernel, *args)


def _check_carry(carry, N: int, P: int, block_size: int, dev) -> tuple:
    NB = -(-N // block_size)
    M, Mb, la_feas_T = carry
    return (
        cuda._checked(M, torch.int32, (NB * block_size, P), dev, "carry M"),
        cuda._checked(Mb, torch.int32, (NB, P), dev, "carry Mb"),
        cuda._checked(la_feas_T, torch.bool, (N, P), dev, "carry la_feas_T"),
    )


def schedule_rounds_warm(carry, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok,
                         salts, commit_cap: int, block_size: int, con=None,
                         check_parent_depth: int = 0, ancestor_depth: int = 8, xin=None,
                         args: Optional[WarmArgs] = None):
    """The ``sched_rounds`` kernel: the round loop from a warm carry
    (M, Mb, la_feas_T), launched on COPIES of M and Mb — the carry seeds
    the next cycle and is never written; ``args`` the cycle's launch
    arguments (``warm_args`` over the same inputs), when its refresh built
    them.  Returns what ``schedule_rounds`` returns."""
    cuda.require_least_allocated(nf_static, "the warm round loop")
    P, N = q_la.est.shape[0], valid.shape[0]
    M, Mb, la_feas_T = _check_carry(carry, N, P, block_size, valid.device)
    rargs = (M.clone(), Mb.clone(), la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
             valid, pod_ok, salts, commit_cap, block_size, con, check_parent_depth,
             ancestor_depth, xin)
    if valid.device.type == "cpu":
        if con is not None:
            _con_launch_args(con, P, N, q_nf.req.shape[1], valid.device, False,
                             check_parent_depth, ancestor_depth, 1)
        return _plain_rounds(*rargs)
    return _launch_rounds(cuda.SCHED_ROUNDS if con is None else cuda.SCHED_ROUNDS_CON, *rargs,
                          args=args)


def _host_index(dirty, N: int) -> np.ndarray:
    """The refresh's dirty rows as a contiguous 1-D int32 host array inside
    [0, N), checked before any launch."""
    d = dirty.numpy() if torch.is_tensor(dirty) and dirty.device.type == "cpu" else dirty
    if not isinstance(d, np.ndarray) or d.dtype != np.int32 or d.ndim != 1:
        raise ValueError(f"dirty: expected a 1-D int32 host index, got "
                         f"{getattr(d, 'dtype', type(d))} {tuple(getattr(d, 'shape', ()))}"
                         f" on {getattr(dirty, 'device', 'the host')}")
    d = np.ascontiguousarray(d)
    if d.size and d.view(np.uint32).max() >= N:  # a negative row reads as >= 2**31
        raise ValueError(f"dirty rows outside [0, {N})")
    return d


def schedule_refresh(carry, dirty, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid,
                     pod_ok, salts, block_size: int, con: Optional[ConInputs] = None,
                     xin: Optional[ExtraInputs] = None, args: Optional[WarmArgs] = None):
    """The ``sched_refresh`` kernel: rebuild the carry's rows of the node
    columns ``dirty`` ([D] int32 on the host, in any order, duplicates
    allowed: the engine's padded bucket repeats a real row) against the
    current node inputs, in place; ``con`` adds the
    gang prefilter and the reservation restore and scores at the
    batch-start allocations (quota never enters the carry), ``xin`` the
    batch's placement-and-devices mask and scores; ``args`` the cycle's
    launch arguments (``warm_args`` over the same inputs), built here when
    None.  On the card one launch planned on the host: the distinct node
    blocks with masks of their dirty rows (csrc/refreshplan.cuh).  Returns
    the carry (M, Mb, la_feas_T)."""
    cuda.require_least_allocated(nf_static, "the warm refresh")
    P, N = q_la.est.shape[0], valid.shape[0]
    dev = valid.device
    M, Mb, la_feas_T = _check_carry(carry, N, P, block_size, dev)
    d = _host_index(dirty, N)
    xf, xsc, xkeep = _xin_args(xin, P, N, dev)
    if dev.type == "cpu":
        q_extra = pod_ok[:, None] & valid[None, :]
        rsv = None
        if con is not None:
            _con_tables(con, P, N, q_nf.req.shape[1], dev)  # checked on every device
            q_extra = q_extra & gang_pass(con)[:, None]
            if con.rsv is not None:
                rsv = rsv_view(con)
        q_extra, q_xsc = _q_extras(xin, q_extra)
        return refresh_plain(
            M, Mb, la_feas_T, torch.from_numpy(d), q_la, la_nodes, la_w, q_nf, nf_nodes,
            nf_static, PluginWeights(), q_extra, salts, block_size, rsv, q_xsc,
        )
    if args is None:
        args = warm_args(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok, salts,
                         con)
    pa = args.pair
    if P and d.size:
        head = (pa.pods, pa.nodes, pa.cfg, pa.la_w, pa.valid, args.pod_ok.data_ptr(),
                args.salts.data_ptr(), xf, xsc, P, N, block_size, tie_base(N))
        tail = (d.ctypes.data, int(d.size), M.data_ptr(), Mb.data_ptr(), la_feas_T.data_ptr(),
                cuda.device_index(dev), cuda.stream(dev))
        if con is None:
            cuda.SCHED_REFRESH.launch(*head, *tail)
        else:
            cuda.SCHED_REFRESH_CON.launch(*head, *args.refresh_con[:2], *tail)
    return M, Mb, la_feas_T


def schedule_fn(
    la_pods: LoadAwarePodArrays,
    la_nodes: LoadAwareNodeArrays,
    la_weights: torch.Tensor,
    nf_pods: NodeFitPodArrays,
    nf_nodes: NodeFitNodeArrays,
    nf_static: NodeFitStatic,
    valid: torch.Tensor,
    p_real: int,
    order: Optional[torch.Tensor] = None,
    commit_cap: int = 16,
    block_size: int = 16,
    con_args: Optional[dict] = None,
    check_parent_depth: int = 0,
    ancestor_depth: int = 8,
    extra_feasible: Optional[torch.Tensor] = None,
    extra_scores: Optional[torch.Tensor] = None,
    extra_score_bound: int = 0,
    impl: str = "auto",
):
    """The ``schedule`` kernel: live node columns x the first ``p_real``
    pod rows, queue order ``order``, the default plugin weights and the
    salted tie-break, as the JAX engine's ``schedule_fn`` runs it;
    ``con_args`` (``con_inputs``' arguments besides the queue order)
    selects the constrained instantiation; ``extra_feasible`` and
    ``extra_scores`` ([P, N], submission order) are the batch's
    placement-and-devices mask and pre-weighted scores, bounded by
    ``extra_score_bound``.  Returns (hosts [P] int32,
    scores [P] int64, precommit [P] int32, rounds, warm) in submission
    order: ``precommit`` is the assignment before the gang rollback,
    ``rounds`` an int32 tensor of the round count (with the count of
    rounds that took the quota upper bound after it when constrained),
    and ``warm`` the init carry (M, Mb, la_feas_T) that seeds the next
    cycle's warm start (the rounds run on copies of it).

    The routes are the JAX package's: a strategy other than LeastAllocated
    takes the scan (``core.cycle.scan_fn``, the int64 key build and the
    step kernel: its hosts after the gang commit are also its
    ``precommit``, its rounds 0); LeastAllocated
    whose packed key bound does not fit int32, or ``impl="matrix"``, takes
    the int64-key kernels; neither leaves a warm carry (``warm`` None).
    An unknown ``impl`` raises ``ValueError``."""
    check_impl(impl)
    P, N = la_pods.est.shape[0], valid.shape[0]
    dev = valid.device
    if nf_static.strategy != "LeastAllocated":
        hosts, scores = scan_fn(
            la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static, valid, p_real, order,
            con_args, check_parent_depth, ancestor_depth, extra_feasible, extra_scores,
            block_size=block_size,
        )
        return hosts, scores, hosts, torch.zeros(2, dtype=torch.int32, device=dev), None
    wide = impl == "matrix" or not fits_i32(key_bound(PluginWeights(), extra_score_bound), N)
    xs, q_la, q_nf, salts, pod_ok = kernel_queue(la_pods, nf_pods, valid, p_real, order)
    con = None if con_args is None else con_inputs(xs, **con_args)
    xin = extra_inputs(extra_feasible, extra_scores, xs)
    M, Mb, la_feas_T = schedule_keys(
        q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static, valid, pod_ok, salts, block_size,
        con, xin, wide,
    )
    out = schedule_rounds(
        M.clone(), Mb.clone(), la_feas_T, q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static,
        valid, pod_ok, salts, commit_cap, block_size, con, check_parent_depth, ancestor_depth,
        xin,
    )
    if con is None:
        hosts_q, scores_q, rounds = out
        pre_q = hosts_q
    else:
        hosts_q, scores_q, pre_q, rounds = out
    hosts, scores = _submission_order(hosts_q, scores_q, xs, P)
    precommit = _submission_order(pre_q, scores_q, xs, P)[0]
    return hosts, scores, precommit, rounds, None if wide else (M, Mb, la_feas_T)
