"""The scheduling cycle's scoring pass and its sequential oracle, in torch.

* ``score_batch``: the [P, N] weighted total-score matrix + feasibility mask
  for a batch scored against a fixed snapshot (LoadAware + NodeResourcesFit).
  ``score_fn`` adds the live-column mask; it is the ``score`` kernel's
  wrapper: a CPU tensor takes the plain version, a CUDA tensor launches the
  hand-written kernel (``csrc/score.cu``).

* ``schedule_batch``: the Go scheduler's one-pod-at-a-time loop (vendored
  scheduleOne) as a Python loop in queue order, carrying the live state the
  assume path mutates (``CycleState``): the LoadAware estimates, the
  NodeFit requested and pod counts, the ElasticQuota used aggregates up
  the ancestor chain (re-checked per pod), and the reservation-restored
  free capacity against the live reservation remainders, with each placed
  pod nominating and consuming a matched reservation on its node; after
  the loop ``commit_gangs`` revokes the gang groups that missed their
  quorum.  It is the oracle of ``core.resolved`` and of the ``scan``
  kernel, and the route for the strategies the resolved engine cannot take
  (MostAllocated, RequestedToCapacityRatio).

* ``scan_fn``: the wrapper of the ``scan`` kernel (``csrc/scan.cu``), the
  whole loop in one launch: a CPU tensor takes ``schedule_batch``, a CUDA
  tensor launches the kernel or raises.

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
from koordinator_tpu_torch.core.gang import GangArrays, GangPodArrays, commit_gangs, gang_prefilter
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
from koordinator_tpu_torch.core.quota import QuotaPodArrays
from koordinator_tpu_torch.core.reservation import (
    ReservationArrays,
    nominate_on_node,
    restore_extra_free,
)

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


class NumaInputs(NamedTuple):
    """nodenumaresource at the Score cut point: the amplified-CPU (or NUMA
    policy) scores and the host-side cpuset fit mask, computed against the
    batch-start allocations; ``score_batch`` adds the scores under the numa
    plugin weight and ANDs the mask."""

    scores: torch.Tensor  # [P, N] int64
    feasible: torch.Tensor  # [P, N] bool


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


class CycleState(NamedTuple):
    """The live state the greedy assignment threads through the loop."""

    la_nodes: LoadAwareNodeArrays
    nf_nodes: NodeFitNodeArrays
    quota_used: torch.Tensor  # [Q, R] (a placeholder without quota inputs)
    quota_npu: torch.Tensor
    rsv_allocated: torch.Tensor  # [Rv, Rf] (a placeholder without reservations)


def _quota_admit(q: QuotaInputs, used, npu, i: int, check_parent_depth: int) -> bool:
    """The single-pod quota PreFilter against the live used aggregates."""
    g = int(q.pods.quota[i])
    req, present = q.pods.req[i], q.pods.present[i]

    def admit_at(grp: int) -> bool:
        return bool((~present | (used[grp] + req <= q.limit[grp])).all())

    ok = admit_at(g)
    if bool(q.pods.non_preemptible[i]):
        ok = ok and bool((~present | (npu[g] + req <= q.min[g])).all())
    grp = g
    for _ in range(check_parent_depth):
        grp = int(q.parent[grp])
        ok = ok and (grp == 0 or admit_at(grp))
    return ok


def _quota_consume(q: QuotaInputs, used, npu, i: int, ancestor_depth: int):
    """updateGroupDeltaUsedNoLock: add the placed pod's request to its group
    and every ancestor (the root row 0 excluded)."""
    req = torch.where(q.pods.present[i], q.pods.req[i], torch.zeros_like(q.pods.req[i]))
    np_ = bool(q.pods.non_preemptible[i])
    used, npu = used.clone(), npu.clone()
    g = int(q.pods.quota[i])
    for _ in range(ancestor_depth):
        if g != 0:
            used[g] += req
            if np_:
                npu[g] += req
        g = int(q.parent[g])
    return used, npu


def score_batch(
    la_pods: LoadAwarePodArrays,
    la_nodes: LoadAwareNodeArrays,
    la_weights: torch.Tensor,
    nf_pods: NodeFitPodArrays,
    nf_nodes: NodeFitNodeArrays,
    nf_static: NodeFitStatic,
    plugin_weights: PluginWeights = PluginWeights(),
    reservation: Optional[ReservationInputs] = None,
    numa: Optional[NumaInputs] = None,
):
    """([P, N] int64 weighted total scores, [P, N] bool feasibility); the
    NodeFit strategy comes from ``nf_static.strategy``.  A reservation adds
    its restore to the filter and its scores to the total; ``numa`` adds
    its scores (under the numa plugin weight) and ANDs its mask."""
    la_s = loadaware_score_plain(la_pods, la_nodes, la_weights)
    nf_s = nodefit_score_plain(nf_pods, nf_nodes, nf_static)
    total = la_s * plugin_weights.loadaware + nf_s * plugin_weights.nodefit
    extra = None
    if reservation is not None:
        extra = restore_extra_free(reservation.matched, reservation.rsv, nf_nodes.alloc.shape[0])
        total = total + reservation.scores * plugin_weights.reservation
    if numa is not None:
        total = total + numa.scores * plugin_weights.numa
    feasible = loadaware_filter(la_pods, la_nodes) & nodefit_filter(
        nf_pods, nf_nodes, nf_static, extra
    )
    if numa is not None:
        feasible = feasible & numa.feasible
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
    plain version; CUDA tensors launch ``csrc/score.cu`` (every NodeFit
    strategy) or raise."""
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


def _assign_updates(state: CycleState, la_pods, nf_pods, i: int, host: int) -> CycleState:
    """The assume-path node-state updates for pod i placed on host."""
    h = torch.tensor([host], device=la_pods.est.device)
    est = la_pods.est[i][None]
    la, nf = state.la_nodes, state.nf_nodes
    la = la._replace(
        base_nonprod=la.base_nonprod.index_add(0, h, est),
        base_prod=la.base_prod.index_add(0, h, est * la_pods.is_prod_class[i].to(torch.int64)),
    )
    nf = nf._replace(
        requested=nf.requested.index_add(0, h, nf_pods.req[i][None]),
        req_score=nf.req_score.index_add(0, h, nf_pods.req_score[i][None]),
        num_pods=nf.num_pods.index_add(0, h, torch.ones_like(h, dtype=torch.int64)),
    )
    return state._replace(la_nodes=la, nf_nodes=nf)


def _rows(nt, i: int):
    return type(nt)(*(a[i:i + 1] for a in nt))


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
    gang: Optional[GangInputs] = None,
    quota: Optional[QuotaInputs] = None,
    reservation: Optional[ReservationInputs] = None,
    check_parent_depth: int = 0,
    ancestor_depth: int = 8,
    tie_break: str = "index",
    extra_scores: Optional[torch.Tensor] = None,
):
    """Greedy sequential batch assignment in queue order ``order`` (all
    pods when None; pods it does not list stay unplaced).

    ``extra_scores`` [P, N] adds batch-frozen, pre-weighted score
    components (deviceshare, amplified CPU); ``extra_feasible`` [P, N] is
    ANDed into feasibility.  Under ``reservation`` each pod's restore is
    taken against the LIVE reservation remainders (which may be negative
    and are not clamped), its frozen reservation scores are added, and a
    placed pod consumes its nominated reservation.  ``quota`` admits each
    pod against the live aggregates and consumes on placement; ``gang``
    masks pods failing the prefilter and, after the loop, revokes the gang
    groups that missed minMember.  A pod that fits nowhere changes no
    state.

    Returns (hosts [P] int32 — node index or -1 after the gang commit,
    scores [P] int64 — the winning total, 0 when unplaced)."""
    P = la_pods.est.shape[0]
    N = la_nodes.alloc.shape[0]
    dev = la_pods.est.device
    i64 = torch.int64
    xs = torch.arange(P, device=dev) if order is None else order.to(dev)
    hosts = torch.full((P,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(P, dtype=i64, device=dev)
    neg = torch.tensor(-1 << 40, dtype=i64, device=dev)
    gang_mask = None if gang is None else gang_prefilter(gang.pods, gang.gangs)
    zero_q = torch.zeros((1, 1), dtype=i64, device=dev)
    state = CycleState(
        la_nodes=la_nodes, nf_nodes=nf_nodes,
        quota_used=zero_q if quota is None else quota.used,
        quota_npu=zero_q if quota is None else quota.npu,
        rsv_allocated=zero_q if reservation is None else reservation.rsv.allocated,
    )
    if reservation is not None:
        rsv = reservation.rsv
        rsv_node = rsv.node.long()
    for i in xs.tolist():
        la_p1, nf_p1 = _rows(la_pods, i), _rows(nf_pods, i)
        la_n, nf_n = state.la_nodes, state.nf_nodes
        total = (loadaware_score_plain(la_p1, la_n, la_weights)[0] * plugin_weights.loadaware
                 + nodefit_score_plain(nf_p1, nf_n, nf_static)[0] * plugin_weights.nodefit)
        extra_free = None
        if reservation is not None:
            # the restore against the LIVE remaining reservation capacity
            remain = rsv.allocatable - state.rsv_allocated  # [Rv, Rf]
            contrib = torch.where(reservation.matched[i][:, None], remain,
                                  torch.zeros_like(remain))
            extra_free = torch.zeros((N, remain.shape[1]), dtype=i64, device=dev).index_add(
                0, rsv_node, contrib)[None]
            total = total + reservation.scores[i] * plugin_weights.reservation
        feasible = (loadaware_filter(la_p1, la_n)[0]
                    & nodefit_filter(nf_p1, nf_n, nf_static, extra_free)[0])
        if extra_scores is not None:
            total = total + extra_scores[i]
        if extra_feasible is not None:
            feasible = feasible & extra_feasible[i]
        if gang_mask is not None and not bool(gang_mask[i]):
            continue
        if quota is not None and not _quota_admit(quota, state.quota_used, state.quota_npu, i,
                                                  check_parent_depth):
            continue
        if not bool(feasible.any()):
            continue
        masked = torch.where(feasible, total, neg)
        if tie_break == "salted":
            salt = tie_salt(torch.tensor(i, device=dev), N).to(i64)
            host = int(torch.argmax(tie_keys(masked, salt)))
        else:
            host = int(torch.argmax(masked))
        state = _assign_updates(state, la_pods, nf_pods, i, host)
        if quota is not None:
            used, npu = _quota_consume(quota, state.quota_used, state.quota_npu, i,
                                       ancestor_depth)
            state = state._replace(quota_used=used, quota_npu=npu)
        if reservation is not None:
            # the Reserve path: the nominated reservation's remainder
            # shrinks for the next pod's restore
            nom, has = nominate_on_node(reservation.matched[i], reservation.rscore[i], rsv, host)
            if bool(has):
                nom = int(nom)
                remain = rsv.allocatable[nom] - state.rsv_allocated[nom]
                consume = torch.clamp(torch.minimum(nf_pods.req[i], remain), min=0)
                state = state._replace(
                    rsv_allocated=state.rsv_allocated.index_add(
                        0, torch.tensor([nom], device=dev), consume[None]))
        hosts[i] = host
        scores[i] = masked[host]
    if gang is not None:
        hosts, _ = commit_gangs(hosts, gang.pods, gang.gangs)
        scores = torch.where(hosts >= 0, scores, torch.zeros_like(scores))
    return hosts, scores


def scan_fn(
    la_pods: LoadAwarePodArrays,
    la_nodes: LoadAwareNodeArrays,
    la_weights: torch.Tensor,
    nf_pods: NodeFitPodArrays,
    nf_nodes: NodeFitNodeArrays,
    nf_static: NodeFitStatic,
    valid: torch.Tensor,
    p_real: int,
    order: Optional[torch.Tensor] = None,
    con_args: Optional[dict] = None,
    check_parent_depth: int = 0,
    ancestor_depth: int = 8,
    extra_feasible: Optional[torch.Tensor] = None,
    extra_scores: Optional[torch.Tensor] = None,
    tie_break: str = "salted",
    block_size: int = 16,
):
    """The ``scan`` kernel: ``schedule_batch`` over the live node columns x
    the first ``p_real`` pod rows in queue order ``order``, under the
    default plugin weights, as the JAX engine's ``schedule_fn`` takes the
    scan; ``con_args`` (``core.resolved.con_inputs``' arguments besides the
    queue order) adds the gang, quota and reservation branches,
    ``extra_feasible``/``extra_scores`` ([P, N] submission order) the
    batch's placement-and-devices mask and pre-weighted scores.  Returns
    (hosts [P] int32 after the gang commit, scores [P] int64) in submission
    order, equal to ``schedule_batch``'s.

    It runs as a key build plus one step a pod (``scan_launch``): the
    int64 keys of every pair against the batch-start state, then the pods
    in queue order over their ``block_size``-row block maxima, the
    committed node's row rescored after each placement.  CPU tensors take
    the plain versions of both (``build_keys_plain``, ``scan_steps_plain``),
    CUDA tensors launch the kernels or raise.  The node, quota and
    reservation inputs are never written.  A key must stay above the int64
    lane's sentinel (``core.resolved.NEG``): totals above -2**39 / TB, far
    beyond the engine's extra scores (at most ``EXTRA_SCORE_BOUND`` in
    magnitude)."""
    from koordinator_tpu_torch.core import resolved as rs

    P, N = la_pods.est.shape[0], valid.shape[0]
    if tie_break not in ("salted", "index"):
        raise ValueError(f"unknown tie_break {tie_break!r} (salted | index)")
    if extra_scores is not None and (extra_scores.dtype != torch.int64
                                     or tuple(extra_scores.shape) != (P, N)):
        raise ValueError(f"extra_scores: expected int64 {(P, N)}, got {extra_scores.dtype} "
                         f"{tuple(extra_scores.shape)}")
    xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(la_pods, nf_pods, valid, p_real, order,
                                                    tie_break)
    con = None if con_args is None else rs.con_inputs(xs, **con_args)
    xin = rs.extra_inputs(extra_feasible, extra_scores, xs)
    args = (q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static, valid, pod_ok, salts, con,
            check_parent_depth, ancestor_depth, xin, block_size)
    hosts_q, scores_q = scan_launch(*args)
    return rs._submission_order(hosts_q, scores_q, xs, P)


def scan_launch(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok, salts, con=None,
                check_parent_depth: int = 0, ancestor_depth: int = 8, xin=None,
                block_size: int = 16):
    """The scan, pods in queue order (``core.resolved.kernel_queue``): the
    key build on the int64 lane without the LoadAware filter
    (``schedule_keys``, counted on ``cuda.SCHEDULE_KEYS64`` or, with a
    ``ConInputs``, ``_CON``), then the step kernel on its fresh keys
    (``scan_steps``, ``cuda.SCAN`` or ``cuda.SCAN_CON``).  Each takes its
    plain version on CPU tensors and launches its kernel on CUDA tensors;
    any other device is refused before a launch.  Returns (hosts [P] int32
    after the gang commit, scores [P] int64) in queue order."""
    from koordinator_tpu_torch.core import resolved as rs

    M, Mb, _ = rs.schedule_keys(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok,
                                salts, block_size, con, xin, wide=True, la_feas=False)
    return scan_steps(M, Mb, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok,
                      salts, block_size, con, check_parent_depth, ancestor_depth, xin)


def scan_steps(M, Mb, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok, salts,
               block_size: int, con=None, check_parent_depth: int = 0, ancestor_depth: int = 8,
               xin=None):
    """The step kernel (``csrc/scan.cu``): the pods in queue order over the
    key build's int64 keys ``M`` [N_pad, P] and block maxima ``Mb`` [NB, P]
    (``schedule_keys(wide=True)``), each taking its block maxima's maximum
    and, on a placement, rescoring the node's row for the pods after it.
    ``M`` and ``Mb`` are consumed (updated in place); the node, quota and
    reservation inputs are not touched (the kernel commits into private
    copies).  CPU tensors take ``scan_steps_plain``; CUDA tensors launch
    ``cuda.SCAN`` (``cuda.SCAN_CON`` with a ``ConInputs``) or raise.
    Returns (hosts [P] int32 after the gang commit, scores [P] int64) in
    queue order."""
    from koordinator_tpu_torch.core import resolved as rs

    P, N = q_la.est.shape[0], valid.shape[0]
    dev = valid.device
    NB = -(-N // block_size)
    M = cuda._checked(M, torch.int64, (NB * block_size, P), dev, "M")
    Mb = cuda._checked(Mb, torch.int64, (NB, P), dev, "Mb")
    if dev.type == "cpu":
        if con is not None:
            rs._con_launch_args(con, P, N, q_nf.req.shape[1], dev, False, check_parent_depth,
                                ancestor_depth, 1)
        return scan_steps_plain(M, Mb, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid,
                                pod_ok, salts, block_size, con, check_parent_depth,
                                ancestor_depth, xin)
    args = cuda.with_private_nodes(
        cuda.pair_args(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid))
    pod_ok = cuda._checked(pod_ok, torch.bool, (P,), dev, "pod_ok")
    salts = cuda._checked(salts, torch.int32, (P,), dev, "salts")
    xf, xsc, xkeep = rs._xin_args(xin, P, N, dev)
    if con is not None:
        ptrs, ints, keep = rs._con_launch_args(con, P, N, q_nf.req.shape[1], dev, True,
                                               check_parent_depth, ancestor_depth,
                                               PluginWeights().reservation,
                                               words=2 * con.gangs.min_member.shape[0])
    if not (P and N):
        return (torch.full((P,), -1, dtype=torch.int32, device=dev),
                torch.zeros(P, dtype=torch.int64, device=dev))
    hosts = torch.empty(P, dtype=torch.int32, device=dev)  # the kernel writes both in full
    scores = torch.empty(P, dtype=torch.int64, device=dev)
    # the block maxima pod-major too: a step's sweep reads one pod's row
    MbT = Mb.t().contiguous()
    head = (args.pods, args.nodes, args.cfg, args.la_w, args.valid, pod_ok.data_ptr(),
            salts.data_ptr(), xf, xsc, P, N, block_size, tie_base(N))
    tail = (M.data_ptr(), Mb.data_ptr(), MbT.data_ptr(), hosts.data_ptr(), scores.data_ptr(),
            cuda.device_index(dev), cuda.stream(dev))
    if con is None:
        cuda.SCAN.launch(*head, *tail)
    else:
        cuda.SCAN_CON.launch(*head, ptrs, ints, *tail)
    return hosts, scores


def scan_steps_plain(M, Mb, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok,
                     salts, block_size: int, con=None, check_parent_depth: int = 0,
                     ancestor_depth: int = 8, xin=None):
    """The step kernel's plain version, on the same keys: for each pod q in
    queue order, the maximum of its block maxima; when feasible and admitted
    by the live quota, the placement on the decoded node j (the assume-path
    update, the quota consumption, a matched reservation on j nominated and
    consumed), then row j's keys for the pods after q rebuilt against j's
    new state (``core.resolved._touched_keys``, the restore at the live
    reservation remainders) and their block maxima re-reduced.  A key
    built at the batch start stays exact on every untouched row, because a
    pod's key on node j reads node j's live row and nothing else that a
    placement changes.  ``M``/``Mb`` are updated in place.  After the pods,
    ``commit_gangs``.  Returns (hosts [P] int32, scores [P] int64) in queue
    order."""
    from koordinator_tpu_torch.core import resolved as rs

    P, N = q_la.est.shape[0], valid.shape[0]
    dev = valid.device
    i64 = torch.int64
    TB = tie_base(N)
    q_extra, q_xsc = rs._q_extras(xin, pod_ok[:, None] & valid[None, :])
    quota = rsv = None
    if con is not None:
        q_extra = q_extra & rs.gang_pass(con)[:, None]
        quota, rsv = con.quota, con.rsv
    la_feas_T = loadaware_filter(q_la, la_nodes).T
    q_extra_T, q_xsc_T = q_extra.T, None if q_xsc is None else q_xsc.T
    zero = torch.zeros((1, 1), dtype=i64, device=dev)
    state = CycleState(la_nodes=la_nodes, nf_nodes=nf_nodes,
                       quota_used=zero if quota is None else quota.used,
                       quota_npu=zero if quota is None else quota.npu,
                       rsv_allocated=zero if rsv is None else rsv.allocated)
    q_rscore = q_scores = None
    if rsv is not None:
        q_rscore, q_scores = con.rsv_rscore[con.xs], con.rsv_scores[con.xs]
    hosts = torch.full((P,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(P, dtype=i64, device=dev)
    for q in range(P):
        win = int(Mb[:, q].max())
        if win == rs.NEG:
            continue
        low = win % TB
        j = (TB - 1 - low - int(salts[q]) + N) % N
        if quota is not None and not _quota_admit(quota, state.quota_used, state.quota_npu, q,
                                                  check_parent_depth):
            continue
        hosts[q], scores[q] = j, (win - low) // TB
        state = _assign_updates(state, q_la, q_nf, q, j)
        if quota is not None:
            used, npu = _quota_consume(quota, state.quota_used, state.quota_npu, q,
                                       ancestor_depth)
            state = state._replace(quota_used=used, quota_npu=npu)
        rsv_terms = None
        if rsv is not None:
            nom, has = nominate_on_node(con.rsv_matched[q], q_rscore[q], rsv, j)
            if bool(has):
                nom = int(nom)
                remain = rsv.allocatable[nom] - state.rsv_allocated[nom]
                consume = torch.clamp(torch.minimum(q_nf.req[q], remain), min=0)
                state = state._replace(rsv_allocated=state.rsv_allocated.index_add(
                    0, torch.tensor([nom], device=dev), consume[None]))
            # rs.rsv_view's terms, the queue-order scores gathered once
            rsv_terms = (rsv.node, rsv.allocatable - state.rsv_allocated, con.rsv_midx, q_scores)
        if q + 1 < P:
            key = rs._touched_keys(q_la, state.la_nodes, la_w, q_nf, state.nf_nodes, nf_static,
                                   PluginWeights(), la_feas_T, q_extra_T, salts.to(i64),
                                   torch.tensor([j], device=dev), TB, rsv_terms, q_xsc_T, i64)
            M[j, q + 1:] = key[0, q + 1:]
            b = j // block_size
            Mb[b, q + 1:] = M[b * block_size:(b + 1) * block_size, q + 1:].amax(dim=0)
    if con is not None:
        pods = GangPodArrays(gang=con.gang_row, priority=None, sub_priority=None, timestamp=None)
        hosts, _ = commit_gangs(hosts, pods, con.gangs)
        scores = torch.where(hosts >= 0, scores, torch.zeros_like(scores))
    return hosts, scores
