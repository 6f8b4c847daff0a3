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
strategies route to the scan, as in the JAX package.

The cross-cycle warm start keeps the init state (M, Mb, la_feas_T) as a
carry: ``return_warm`` hands it out of a cold run, ``refresh_only`` with
``dirty_cols`` rebuilds the carry's rows of the nodes that changed, and
``warm_init`` starts the rounds from it.

This slice covers plain pods: gang, quota and reservation inputs and the
extra-score channel arrive with later slices and raise
``NotImplementedError`` here.

``schedule_keys`` and ``schedule_rounds`` are the wrappers of the two CUDA
launches of the cold ``schedule`` kernel (``csrc/schedule.cu``);
``schedule_refresh`` and ``schedule_rounds_warm`` those of the warm
``sched_refresh`` and ``sched_rounds``; ``schedule_fn`` composes the cold
pair the way the JAX package's ``schedule_fn`` (service/engine.py) composes
its jitted cycle.  CPU tensors take the plain versions beside them; CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.core.cycle import (
    PluginWeights,
    schedule_batch,
    score_batch,
    tie_base,
    tie_salt,
)
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
from koordinator_tpu_torch.slices import CONSTRAINTS, PLACEMENT, STRATEGIES, later

# packed-key infeasible sentinel; the fits_i32 guard keeps every real key
# clear of it
NEGK = -(1 << 30)
NEGK_THRESH = -(1 << 29)


def key_bound(plugin_weights: PluginWeights) -> int:
    """The static score bound the packed key must hold (per-plugin scores
    are <= MaxNodeScore after normalization)."""
    return 100 * (
        plugin_weights.loadaware + plugin_weights.nodefit + plugin_weights.reservation
    )


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


def _pack_keys(total, feas, salts, N: int, TB: int) -> torch.Tensor:
    """[P, N] packed ordering keys (score * TB + rotated tie bits), int64."""
    rot = torch.remainder(
        torch.arange(N, dtype=torch.int64, device=total.device)[None, :] + salts[:, None], N
    )
    key = total * TB + (TB - 1 - rot)
    return torch.where(feas, key, torch.full_like(key, NEGK))


def _touched_keys(q_la, la, la_w, q_nf, nf, nf_static, plugin_weights, la_feas_T, q_extra_T,
                  salts, colsc, TB):
    """[K, P] int32 keys of the touched node rows ``colsc`` against the
    current state (core/resolved.py touched_scores + the key repack)."""
    N = la.alloc.shape[0]
    la_cols, nf_cols = _rows(la, colsc), _rows(nf, colsc)
    tot = loadaware_score(q_la, la_cols, la_w) * plugin_weights.loadaware
    tot = tot + nodefit_score(q_nf, nf_cols, nf_static) * plugin_weights.nodefit
    feas = la_feas_T[colsc].T & nodefit_filter(q_nf, nf_cols, nf_static) & q_extra_T[colsc].T
    rot = torch.remainder(colsc.to(torch.int64)[None, :] + salts[:, None], N)
    key = torch.where(feas, tot * TB + (TB - 1 - rot), torch.full_like(tot, NEGK))
    return key.T.to(torch.int32)


def build_keys_plain(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights, q_extra,
                     salts, block_size: int):
    """The cold init: (M [N_pad, P] int32, Mb [NB, P] int32, la_feas_T
    [N, P] bool) for pods already in queue order; ``q_extra`` [P, N] is
    every mask beyond the two plugin filters."""
    P, N = q_la.est.shape[0], la_nodes.alloc.shape[0]
    TB = tie_base(N)
    NB = -(-N // block_size)
    la_feas_T = loadaware_filter(q_la, la_nodes).T.contiguous()
    total, feas = score_batch(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights)
    M = _pack_keys(total, feas & q_extra, salts.to(torch.int64), N, TB).T.to(torch.int32)
    if NB * block_size != N:
        pad = torch.full((NB * block_size - N, P), NEGK, dtype=torch.int32, device=M.device)
        M = torch.cat([M, pad], dim=0)
    M = M.contiguous()
    Mb = M.view(NB, block_size, P).amax(dim=1)
    return M, Mb, la_feas_T


def run_rounds_plain(M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
                     plugin_weights, q_extra, salts, commit_cap: int, block_size: int):
    """The round loop from the cold init: (hosts [P] int32, scores [P]
    int64, rounds) in queue order.  ``M``/``Mb`` are updated in place."""
    P, N = q_la.est.shape[0], la_nodes.alloc.shape[0]
    dev = q_la.est.device
    K = min(commit_cap, max(P, 1))
    TB = tie_base(N)
    NB = Mb.shape[0]
    salts64 = salts.to(torch.int64)
    qpos = torch.arange(P, device=dev)
    q_extra_T = q_extra.T
    committed = torch.zeros(P, dtype=torch.bool, device=dev)
    hosts = torch.full((P,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(P, dtype=torch.int64, device=dev)
    la, nf = la_nodes, nf_nodes
    i64 = torch.int64
    rounds = 0
    while P and not bool(committed.all()):
        pending = ~committed
        vmax = Mb.amax(dim=0).to(i64)  # [P]
        placed = pending & (vmax > NEGK_THRESH)
        rot = TB - 1 - torch.remainder(vmax, TB)
        picks = torch.where(placed, torch.remainder(rot - salts64 + N, N), 0)
        pickscore = torch.where(placed, torch.div(vmax, TB, rounding_mode="floor"), 0)

        # commit_core: first-picker rule, prefix cut, commit cap
        blockers = pending & placed
        node_first = torch.full((N,), P, dtype=i64, device=dev).scatter_reduce(
            0, torch.where(blockers, picks, 0), torch.where(blockers, qpos, P),
            reduce="amin", include_self=True,
        )
        blocked = blockers & (node_first[picks] != qpos)
        first_blocked = torch.where(blocked, qpos, P).min()
        in_prefix = pending & (qpos < first_blocked)
        place_mask = in_prefix & placed
        placed_rank = torch.cumsum(place_mask.to(i64), 0)
        overflow = place_mask & (placed_rank > K)
        cutpos = torch.where(overflow, qpos, P).min()
        in_prefix = in_prefix & (qpos < cutpos)
        place_mask = place_mask & in_prefix
        hosts = torch.where(in_prefix, torch.where(place_mask, picks, -1), hosts).to(torch.int32)
        scores = torch.where(place_mask, pickscore, torch.where(in_prefix, 0, scores))
        committed = committed | in_prefix

        # the assume path over <= K touched rows; padding slots clamp to
        # N-1 and add zeros
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

        # rescore the touched rows (duplicate padding rows carry identical
        # keys), then re-reduce their blocks
        M[colsc] = _touched_keys(
            q_la, la, la_w, q_nf, nf, nf_static, plugin_weights, la_feas_T, q_extra_T,
            salts64, colsc, TB,
        )
        bc = torch.div(colsc, block_size, rounding_mode="floor")
        Mb[bc] = M.view(NB, block_size, P)[bc].amax(dim=1)
        rounds += 1
    return hosts, scores, rounds


def refresh_plain(M, Mb, la_feas_T, dirty, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
                  plugin_weights, q_extra, salts, block_size: int):
    """The warm carry's delta refresh, in place: for the node rows
    ``dirty`` [D] (padding repeats a real row), the real LoadAware filter
    into ``la_feas_T``, the packed keys into ``M`` from the current node
    state, then the block maxima of their blocks into ``Mb``.  Returns
    (M, Mb, la_feas_T)."""
    N, P = la_feas_T.shape
    NB = Mb.shape[0]
    d = dirty.to(torch.int64)
    la_feas_T[d] = loadaware_filter(q_la, _rows(la_nodes, d)).T
    M[d] = _touched_keys(
        q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights, la_feas_T, q_extra.T,
        salts.to(torch.int64), d, tie_base(N),
    )
    bc = torch.div(d, block_size, rounding_mode="floor")
    Mb[bc] = M.view(NB, block_size, P)[bc].amax(dim=1)
    return M, Mb, la_feas_T


def _refuse(gang, quota, reservation, extra_scores):
    for name, val, slice_name in (
        ("gang", gang, CONSTRAINTS), ("quota", quota, CONSTRAINTS),
        ("reservation", reservation, CONSTRAINTS), ("extra_scores", extra_scores, PLACEMENT),
    ):
        if val is not None:
            raise later(f"{name} inputs to the resolved engine", slice_name)


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
    gang=None,
    quota=None,
    reservation=None,
    commit_cap: int = 16,
    tie_break: str = "salted",
    block_size: int = 16,
    extra_scores=None,
    return_rounds: bool = False,
    warm_init: Optional[tuple] = None,
    dirty_cols: Optional[torch.Tensor] = None,
    refresh_only: bool = False,
    return_warm: bool = False,
):
    """``schedule_batch`` bit-for-bit (same ``tie_break``), via
    prefix-committed rounds, plain PyTorch.  commit_cap and block_size do
    not affect results.  Returns (hosts, scores[, rounds][, warm]).

    The warm start, as in the JAX package: ``warm_init`` (M [N_pad, P]
    int32, Mb [NB, P] int32, la_feas_T [N, P] bool) is the init state a
    cold run over the same inputs would build, and the rounds start from
    it; ``refresh_only`` rebuilds its ``dirty_cols`` rows against the
    current inputs and returns the refreshed carry instead of scheduling;
    ``return_warm`` appends a cold run's init carry to the outputs.  The
    caller's carry tensors are never written."""
    _refuse(gang, quota, reservation, extra_scores)
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
            extra_feasible, order, tie_break,
        )
        return (hosts, scores, 0) if return_rounds else (hosts, scores)
    if not fits_i32(key_bound(plugin_weights), N):
        raise later("the int64-key matrix engine (node axes beyond 2**21)", STRATEGIES)
    xs, q_la, q_nf, salts = _queue(la_pods, nf_pods, order, N, tie_break)
    if extra_feasible is None:
        q_extra = torch.ones((xs.shape[0], N), dtype=torch.bool, device=dev)
    else:
        q_extra = extra_feasible[xs]
    if refresh_only:
        return refresh_plain(
            *(a.clone() for a in warm_init), dirty_cols, q_la, la_nodes, la_weights, q_nf,
            nf_nodes, nf_static, plugin_weights, q_extra, salts, block_size,
        )
    if warm_init is not None:
        M0, Mb0, la_feas_T = warm_init
    else:
        M0, Mb0, la_feas_T = build_keys_plain(
            q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static, plugin_weights, q_extra,
            salts, block_size,
        )
    hosts_q, scores_q, rounds = run_rounds_plain(
        M0.clone(), Mb0.clone(), la_feas_T, q_la, la_nodes, la_weights, q_nf, nf_nodes,
        nf_static, plugin_weights, q_extra, salts, commit_cap, block_size,
    )
    hosts, scores = _submission_order(hosts_q, scores_q, xs, P_full)
    out = (hosts, scores)
    if return_rounds:
        out = out + (rounds,)
    if return_warm:
        out = out + ((M0, Mb0, la_feas_T),)
    return out


# ------------------------------------------------------------------ kernels


def kernel_queue(la_pods, nf_pods, valid, p_real: int, order):
    """The kernels' pod inputs in queue order, as the JAX engine's
    ``schedule_fn`` lays them out: (xs, pod arrays in queue order, salted
    tie salts, ``pod_ok`` marking the real, unpadded pod rows)."""
    xs, q_la, q_nf, salts = _queue(la_pods, nf_pods, order, valid.shape[0], "salted")
    pod_ok = (torch.arange(la_pods.est.shape[0], device=valid.device) < p_real)[xs]
    return xs, q_la, q_nf, salts, pod_ok


def schedule_keys(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok, salts,
                  block_size: int):
    """First launch of the ``schedule`` kernel: the cold key build for pods
    in queue order under the default plugin weights, the extra mask
    factorized as ``pod_ok[q] & valid[n]``.  Returns (M, Mb, la_feas_T)."""
    if valid.device.type == "cpu":
        q_extra = pod_ok[:, None] & valid[None, :]
        return build_keys_plain(
            q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, PluginWeights(), q_extra, salts,
            block_size,
        )
    P, N = q_la.est.shape[0], valid.shape[0]
    dev = valid.device
    args = cuda.pair_args(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid)
    NB = -(-N // block_size)
    pod_ok = cuda._checked(pod_ok, torch.bool, (P,), dev, "pod_ok")
    salts = cuda._checked(salts, torch.int32, (P,), dev, "salts")
    M = torch.empty((NB * block_size, P), dtype=torch.int32, device=dev)
    Mb = torch.empty((NB, P), dtype=torch.int32, device=dev)
    la_feas_T = torch.empty((N, P), dtype=torch.bool, device=dev)
    if P and N:
        cuda.SCHEDULE_KEYS.launch(
            args.pods, args.nodes, args.cfg, args.la_w, args.valid, pod_ok.data_ptr(),
            salts.data_ptr(), P, N, block_size, tie_base(N), M.data_ptr(), Mb.data_ptr(),
            la_feas_T.data_ptr(), cuda.device_index(dev), cuda.stream(dev),
        )
    return M, Mb, la_feas_T


def _launch_rounds(kernel, M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
                   valid, pod_ok, salts, commit_cap: int, block_size: int):
    """One launch of the round-loop kernel on CUDA tensors, counted on
    ``kernel``; ``M``/``Mb`` are updated in place."""
    P, N = q_la.est.shape[0], valid.shape[0]
    dev = valid.device
    K = min(commit_cap, max(P, 1))
    if cuda.rounds_smem(P, K) > cuda.MAX_SMEM:
        raise ValueError(f"{P} pods exceed the round kernel's shared memory")
    NB = -(-N // block_size)
    la_mut = la_nodes._replace(
        base_nonprod=la_nodes.base_nonprod.clone(), base_prod=la_nodes.base_prod.clone()
    )
    nf_mut = nf_nodes._replace(
        requested=nf_nodes.requested.clone(), req_score=nf_nodes.req_score.clone(),
        num_pods=nf_nodes.num_pods.clone(),
    )
    args = cuda.pair_args(q_la, la_mut, la_w, q_nf, nf_mut, nf_static, valid)
    pod_ok = cuda._checked(pod_ok, torch.bool, (P,), dev, "pod_ok")
    salts = cuda._checked(salts, torch.int32, (P,), dev, "salts")
    M = cuda._checked(M, torch.int32, (NB * block_size, P), dev, "M")
    Mb = cuda._checked(Mb, torch.int32, (NB, P), dev, "Mb")
    la_feas_T = cuda._checked(la_feas_T, torch.bool, (N, P), dev, "la_feas_T")
    hosts = torch.full((P,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros(P, dtype=torch.int64, device=dev)
    rounds = torch.zeros(1, dtype=torch.int32, device=dev)
    node_first = torch.empty(N, dtype=torch.int32, device=dev)
    if P and N:
        kernel.launch(
            args.pods, args.nodes, args.cfg, args.la_w, args.valid, pod_ok.data_ptr(),
            salts.data_ptr(), P, N, block_size, tie_base(N), K, M.data_ptr(), Mb.data_ptr(),
            la_feas_T.data_ptr(), node_first.data_ptr(), hosts.data_ptr(), scores.data_ptr(),
            rounds.data_ptr(), cuda.device_index(dev), cuda.stream(dev),
        )
    return hosts, scores, rounds[0]


def _plain_rounds(M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid,
                  pod_ok, salts, commit_cap: int, block_size: int):
    q_extra = pod_ok[:, None] & valid[None, :]
    hosts, scores, rounds = run_rounds_plain(
        M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, PluginWeights(),
        q_extra, salts, commit_cap, block_size,
    )
    return hosts, scores, torch.tensor(rounds, dtype=torch.int32)


def schedule_rounds(M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid,
                    pod_ok, salts, commit_cap: int, block_size: int):
    """Second launch of the ``schedule`` kernel: the whole round loop under
    the default plugin weights.  Returns (hosts [P] int32, scores [P]
    int64, rounds as a 0-d int32 tensor) in queue order.  ``M``/``Mb`` are
    consumed (updated in place); the node arrays are not touched (the
    kernel commits into private copies)."""
    args = (M, Mb, la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok,
            salts, commit_cap, block_size)
    if valid.device.type == "cpu":
        return _plain_rounds(*args)
    return _launch_rounds(cuda.SCHEDULE_ROUNDS, *args)


def _check_carry(carry, N: int, P: int, block_size: int, dev) -> tuple:
    NB = -(-N // block_size)
    M, Mb, la_feas_T = carry
    return (
        cuda._checked(M, torch.int32, (NB * block_size, P), dev, "carry M"),
        cuda._checked(Mb, torch.int32, (NB, P), dev, "carry Mb"),
        cuda._checked(la_feas_T, torch.bool, (N, P), dev, "carry la_feas_T"),
    )


def schedule_rounds_warm(carry, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok,
                         salts, commit_cap: int, block_size: int):
    """The ``sched_rounds`` kernel: the round loop from a warm carry
    (M, Mb, la_feas_T), launched on COPIES of M and Mb — the carry seeds
    the next cycle and is never written.  Returns what ``schedule_rounds``
    returns."""
    P, N = q_la.est.shape[0], valid.shape[0]
    M, Mb, la_feas_T = _check_carry(carry, N, P, block_size, valid.device)
    args = (M.clone(), Mb.clone(), la_feas_T, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
            valid, pod_ok, salts, commit_cap, block_size)
    if valid.device.type == "cpu":
        return _plain_rounds(*args)
    return _launch_rounds(cuda.SCHED_ROUNDS, *args)


def schedule_refresh(carry, dirty, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid,
                     pod_ok, salts, block_size: int):
    """The ``sched_refresh`` kernel: rebuild the carry's rows of the node
    columns ``dirty`` ([D] int32 on the host, a power-of-two bucket padded
    by repeating a real row) against the current node inputs, in place.
    Returns the carry (M, Mb, la_feas_T)."""
    P, N = q_la.est.shape[0], valid.shape[0]
    dev = valid.device
    M, Mb, la_feas_T = _check_carry(carry, N, P, block_size, dev)
    dirty = torch.as_tensor(dirty)
    if dirty.dtype != torch.int32 or dirty.dim() != 1 or dirty.device.type != "cpu":
        raise ValueError(f"dirty: expected a 1-D int32 host index, got {dirty.dtype} "
                         f"{tuple(dirty.shape)} on {dirty.device}")
    if dirty.numel() and (int(dirty.min()) < 0 or int(dirty.max()) >= N):
        raise ValueError(f"dirty rows outside [0, {N})")
    if dev.type == "cpu":
        return refresh_plain(
            M, Mb, la_feas_T, dirty, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
            PluginWeights(), pod_ok[:, None] & valid[None, :], salts, block_size,
        )
    args = cuda.pair_args(q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid)
    pod_ok = cuda._checked(pod_ok, torch.bool, (P,), dev, "pod_ok")
    salts = cuda._checked(salts, torch.int32, (P,), dev, "salts")
    if P and dirty.numel():
        d = dirty.pin_memory().to(dev, non_blocking=True)
        cuda.SCHED_REFRESH.launch(
            args.pods, args.nodes, args.cfg, args.la_w, args.valid, pod_ok.data_ptr(),
            salts.data_ptr(), P, N, block_size, tie_base(N), d.data_ptr(), int(d.shape[0]),
            M.data_ptr(), Mb.data_ptr(), la_feas_T.data_ptr(), cuda.device_index(dev),
            cuda.stream(dev),
        )
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
):
    """The ``schedule`` kernel for plain pods: live node columns x the first
    ``p_real`` pod rows, queue order ``order``, the default plugin weights
    and the salted tie-break, as the JAX engine's ``schedule_fn`` runs it.
    Returns (hosts [P] int32, scores [P] int64, precommit [P] int32, rounds
    as a 0-d int32 tensor, warm) in submission order, where ``warm`` is the
    init carry (M, Mb, la_feas_T) that seeds the next cycle's warm start
    (the rounds run on copies of it).

    On CPU tensors a strategy other than LeastAllocated takes the scan (as
    the JAX package does) and ``warm`` is None; on CUDA tensors it raises."""
    P, N = la_pods.est.shape[0], valid.shape[0]
    dev = valid.device
    if nf_static.strategy != "LeastAllocated" and dev.type == "cpu":
        pad_rows = torch.arange(P, device=dev) < p_real
        hosts, scores, rounds = schedule_batch_resolved(
            la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static,
            extra_feasible=pad_rows[:, None] & valid[None, :], order=order, return_rounds=True,
        )
        return hosts, scores, hosts, torch.tensor(rounds, dtype=torch.int32), None
    if not fits_i32(key_bound(PluginWeights()), N):
        raise later("the int64-key matrix engine (node axes beyond 2**21)", STRATEGIES)
    xs, q_la, q_nf, salts, pod_ok = kernel_queue(la_pods, nf_pods, valid, p_real, order)
    M, Mb, la_feas_T = schedule_keys(
        q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static, valid, pod_ok, salts, block_size,
    )
    hosts_q, scores_q, rounds = schedule_rounds(
        M.clone(), Mb.clone(), la_feas_T, q_la, la_nodes, la_weights, q_nf, nf_nodes, nf_static,
        valid, pod_ok, salts, commit_cap, block_size,
    )
    hosts, scores = _submission_order(hosts_q, scores_q, xs, P)
    return hosts, scores, hosts, rounds, (M, Mb, la_feas_T)
