"""MostAllocated and RequestedToCapacityRatio: the port's scan, resolved
engine and Engine against the JAX package's, on the same numpy-made
inputs, bit for bit (``np.array_equal``).

* the plain scan (``core.cycle.schedule_batch``) against JAX
  ``schedule_batch`` under MostAllocated and RTC (the bin-packing default
  and a non-monotone shape) with no constraint, a gang, tight hierarchical
  quota at ``check_parent_depth`` 0 and 2, a reservation-heavy set, a mask
  with negative extra scores, and all of them together, under both
  tie-breaks, with a partial queue order; ``scan_fn`` (the key build and
  the step kernel's plain version, ``scan_steps_plain``) against the same
  JAX results, and on cases aimed at the step kernel's invariant (an empty
  fleet under MostAllocated, a quota that rejects midway, reservations used
  up on the touched node, a gang rollback, the most negative total, every
  pod infeasible, one pod, padding pods, node blocks that do not divide
  N); the key build under MostAllocated and RTC against JAX
  ``score_batch`` packed as ``score * TB + (TB-1 - rot)``;
* ``impl="matrix"`` against JAX ``impl="matrix"`` and the scan, with the
  full constraint set; ``"auto"`` routing under inflated plugin weights;
  ``schedule_fn``'s int64-key route on CPU tensors; the unknown-``impl``
  ``ValueError`` on every path;
* ``Engine.score`` and ``Engine.schedule`` (``assume=True`` included)
  under both strategies against the JAX engine over gang, quota and
  reservation stores and over device, cpuset and anti-affinity pods, the
  stores after ``assume`` included.

Every case is P <= 64, N <= 300 on the CPU, where the wrappers take their
plain versions; the kernels themselves are held against these on the card
(``chip_smoke.py``, ``tests/test_torch_kernels.py``)."""

import functools

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from koordinator_tpu.core import cycle as jcycle
from koordinator_tpu.core import resolved as jres
from koordinator_tpu.core.cycle import PluginWeights, QuotaInputs, ReservationInputs
from koordinator_tpu.core.quota import QuotaPodArrays
from koordinator_tpu.core.reservation import (
    ReservationArrays,
    reservation_score,
    score_reservation,
)
from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.core import cycle as tcycle
from koordinator_tpu_torch.core import resolved as tres
from koordinator_tpu_torch.core.cycle import PluginWeights as TWeights
from torch_parity import (
    BIN_PACKING,
    NON_MONOTONE,
    assert_same,
    batch,
    constraints_to_torch,
    device_cluster,
    engine_of,
    pkg,
    policy_batch,
    to_jax,
    to_torch,
)

P, N = 48, 120
STRATS = [("MostAllocated", None), ("RequestedToCapacityRatio", BIN_PACKING),
          ("RequestedToCapacityRatio", NON_MONOTONE)]
STRAT_IDS = ["most", "rtc", "rtc-nonmono"]
CASES = ("plain", "gang", "quota-cpd0", "quota-cpd2", "reservations", "neg-extras", "all")


def tight_quota(P: int, seed: int) -> QuotaInputs:
    """A three-level tree (root 0, parents 1-2, leaves 3-6) whose limits
    (70% of the batch's demand at the leaves, 80% at the parents) and mins
    (40%) bind mid-batch; a third of the pods non-preemptible."""
    rng = np.random.default_rng(seed)
    Q = 7
    parent = np.array([0, 0, 0, 1, 1, 2, 2], dtype=np.int32)
    qrow = np.where(rng.random(P) < 0.8, rng.integers(3, Q, P), 0).astype(np.int32)
    req = rng.integers(100, 4000, (P, 2)).astype(np.int64)
    present = rng.random((P, 2)) < 0.9
    eff = np.where(present, req, 0)
    demand = np.zeros((Q, 2), dtype=np.int64)
    np.add.at(demand, qrow, eff)
    np.add.at(demand, parent[qrow], np.where((qrow > 0)[:, None], eff, 0))
    inf = 1 << 60
    limit = np.full((Q, 2), inf, dtype=np.int64)
    limit[1:3] = demand[1:3] * 8 // 10
    limit[3:] = demand[3:] * 7 // 10
    mn = np.full((Q, 2), inf, dtype=np.int64)
    mn[3:] = demand[3:] * 4 // 10
    zeros = np.zeros((Q, 2), dtype=np.int64)
    return QuotaInputs(
        pods=QuotaPodArrays(req=req, present=present, quota=qrow,
                            non_preemptible=rng.random(P) < 0.3),
        used=zeros, limit=limit, npu=zeros.copy(), min=mn, parent=parent)


def heavy_reservations(P: int, N: int, Rf: int, req: np.ndarray, seed: int):
    """16 reservations on 6 nodes, most pods matching several, some already
    over-allocated (a negative remainder, which the restore must not
    clamp), orders with ties."""
    rng = np.random.default_rng(seed)
    Rv = 16
    alloc = rng.integers(0, 6000, (Rv, Rf)).astype(np.int64)
    allocated = rng.integers(0, 3000, (Rv, Rf)).astype(np.int64)
    allocated[::5] = alloc[::5] + 500
    rsv = ReservationArrays(node=rng.integers(0, 6, Rv).astype(np.int32) * (N // 6),
                            allocatable=alloc, allocated=allocated,
                            order=np.where(rng.random(Rv) < 0.5, rng.integers(1, 4, Rv),
                                           0).astype(np.int64))
    matched = rng.random((P, Rv)) < 0.6
    return ReservationInputs(rsv=rsv, matched=matched,
                             rscore=np.asarray(score_reservation(req, rsv)),
                             scores=np.asarray(reservation_score(req, matched, N, rsv)))


def case_inputs(case: str, b, seed: int):
    """(JAX kwargs, port kwargs) of one scan case, with a partial order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(P)[:P - 6].astype(np.int32)
    jkw = {"order": order}
    gang, _, rsv = ge._example_constraints(P, N, Rf=b[3].req.shape[1], seed=seed)
    if case in ("gang", "all"):
        jkw["gang"] = gang
    if case.startswith("quota") or case == "all":
        jkw["quota"] = tight_quota(P, seed)
        jkw["check_parent_depth"] = 2 if case in ("quota-cpd2", "all") else 0
    if case in ("reservations", "all"):
        jkw["reservation"] = heavy_reservations(P, N, b[3].req.shape[1], b[3].req, seed)
    if case in ("neg-extras", "all"):
        jkw["extra_feasible"] = rng.random((P, N)) < 0.85
        jkw["extra_scores"] = rng.integers(-100, 201, (P, N)).astype(np.int64)
    g, q, r = constraints_to_torch(jkw.get("gang"), jkw.get("quota"), jkw.get("reservation"))
    tkw = {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
           for k, v in jkw.items() if k not in ("gang", "quota", "reservation")}
    tkw.update({k: v for k, v in (("gang", g), ("quota", q), ("reservation", r))
                if v is not None})
    return jkw, tkw


@functools.lru_cache(maxsize=None)
def jax_scan(strategy: str, shape, case: str, tie: str):
    """(batch, JAX kwargs, port kwargs, JAX hosts, JAX scores) of one scan
    case, the JAX scan run once for the file's scan tests."""
    seed = CASES.index(case) + 3
    b = batch(P, N, seed, strategy, None if shape is None else list(shape))
    jkw, tkw = case_inputs(case, b, seed)
    jh, js = jcycle.schedule_batch(*to_jax(b), tie_break=tie, **jkw)
    return b, jkw, tkw, np.asarray(jh), np.asarray(js)


def scan_fn_of(b, tkw: dict, tie: str, block_size: int = 16, p_real: int = P):
    """The port's ``scan_fn`` on CPU tensors (the key build and
    ``scan_steps_plain``) over every node column, the case's queue order,
    constraints, mask and extra scores."""
    con = {k: tkw[k] for k in ("gang", "quota", "reservation") if k in tkw} or None
    n = b[1].alloc.shape[0]
    return tcycle.scan_fn(*to_torch(b), torch.ones(n, dtype=torch.bool), p_real,
                          tkw.get("order"), con, tkw.get("check_parent_depth", 0), 8,
                          tkw.get("extra_feasible"), tkw.get("extra_scores"), tie, block_size)


def _shape(shape):
    return None if shape is None else tuple(map(tuple, shape))


@pytest.mark.parametrize("tie", ["salted", "index"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("strategy,shape", STRATS, ids=STRAT_IDS)
def test_scan_matches_jax(strategy, shape, case, tie):
    b, jkw, tkw, jh, js = jax_scan(strategy, _shape(shape), case, tie)
    th, ts = tcycle.schedule_batch(*to_torch(b), tie_break=tie, **tkw)
    assert_same(th, jh, f"hosts {case}")
    assert_same(ts, js, f"scores {case}")
    placed = np.asarray(jh) >= 0
    assert placed.any() and not placed[np.setdiff1d(np.arange(P), jkw["order"])].any()
    if case == "neg-extras":
        assert (np.asarray(js)[placed] != 0).any()


@pytest.mark.parametrize("tie", ["salted", "index"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("strategy,shape", STRATS, ids=STRAT_IDS)
def test_scan_fn_matches_jax(strategy, shape, case, tie):
    """``scan_fn`` on the CPU, the key build then one step a pod over the
    block maxima (``scan_steps_plain``), equals JAX ``schedule_batch``."""
    b, jkw, tkw, jh, js = jax_scan(strategy, _shape(shape), case, tie)
    th, ts = scan_fn_of(b, tkw, tie)
    assert_same(th, jh, f"hosts {case}")
    assert_same(ts, js, f"scores {case}")


def _zero_fleet(b):
    """The batch with every node empty: no usage, requests or pods."""
    la, la_n, w, nf, nf_n, st = b
    z = np.zeros_like
    return (la, la_n._replace(base_nonprod=z(la_n.base_nonprod), base_prod=z(la_n.base_prod)),
            w, nf, nf_n._replace(requested=z(nf_n.requested), num_pods=z(nf_n.num_pods),
                                 req_score=z(nf_n.req_score)), st)


def _used_up_reservations(b):
    """8 reservations, one on each of nodes 0, 15, ..., 105, each with room
    for about one pod, every pod matching all of them: the first pod on a
    reservation node uses its reservation up and the node's restore falls
    for every later pod."""
    from koordinator_tpu.core.cycle import ReservationInputs as JRI

    req = b[3].req
    Rv, Rf = 8, req.shape[1]
    alloc = np.tile(np.median(req, axis=0).astype(np.int64), (Rv, 1))
    rsv = ReservationArrays(node=(np.arange(Rv) * (N // Rv)).astype(np.int32), allocatable=alloc,
                            allocated=np.zeros((Rv, Rf), dtype=np.int64),
                            order=np.zeros(Rv, dtype=np.int64))
    matched = np.ones((P, Rv), dtype=bool)
    return JRI(rsv=rsv, matched=matched, rscore=np.asarray(score_reservation(req, rsv)),
               scores=np.asarray(reservation_score(req, matched, N, rsv)))


def _rollback_gang(seed: int):
    """Gang 1 of 6 members (min_member 6), one of them infeasible on every
    node: the other five place, and commit_gangs takes them back."""
    from koordinator_tpu.core.cycle import GangInputs
    from koordinator_tpu.core.gang import GangArrays, GangPodArrays

    gang = np.zeros(P, dtype=np.int32)
    gang[3:9] = 1
    return GangInputs(
        pods=GangPodArrays(gang=gang, priority=np.zeros(P, dtype=np.int64),
                           sub_priority=np.zeros(P, dtype=np.int64),
                           timestamp=np.zeros(P, dtype=np.float64)),
        gangs=GangArrays(min_member=np.array([0, 6], dtype=np.int64),
                         member_count=np.array([P - 6, 6], dtype=np.int64),
                         has_init=np.ones(2, dtype=bool), once_satisfied=np.zeros(2, dtype=bool)))


# the step kernel's invariant cases: (strategy, shape, what the case sets)
EDGES = {
    "most-empty-fleet": ("MostAllocated", None, {}),
    "quota-midway": ("MostAllocated", None, {"quota": True}),
    "reservations-used-up": ("RequestedToCapacityRatio", BIN_PACKING, {"reservation": True}),
    "gang-rollback": ("MostAllocated", None, {"gang": True}),
    "most-negative-total": ("MostAllocated", None, {"extra": -200}),
    "all-infeasible": ("RequestedToCapacityRatio", NON_MONOTONE, {"infeasible": True}),
    "one-pod": ("MostAllocated", None, {"pods": 1}),
    "padding-pods": ("RequestedToCapacityRatio", NON_MONOTONE, {"p_real": P - 7}),
    "blocks-of-7": ("MostAllocated", None, {"block_size": 7}),
    "blocks-of-64": ("RequestedToCapacityRatio", BIN_PACKING, {"block_size": 64}),
}


@pytest.mark.parametrize("tie", ["salted", "index"])
@pytest.mark.parametrize("edge", list(EDGES))
def test_scan_fn_invariant_cases(edge, tie):
    """``scan_fn`` on the CPU equals JAX ``schedule_batch`` where the step
    kernel's invariant is tested: many pods on one node of an empty fleet
    (its row rescored again and again), a quota that rejects midway (no
    state change), reservations used up on the touched node (its restore
    falls), a gang rolled back after the steps, the most negative total
    the engine admits (every extra score at -EXTRA_SCORE_BOUND), every pod
    infeasible, one pod, padding pods (``p_real`` < P), node blocks that do
    not divide the node axis."""
    strategy, shape, kw = EDGES[edge]
    pods = kw.get("pods", P)
    seed = 40 + list(EDGES).index(edge)
    b = batch(pods, N, seed, strategy, shape)
    if edge == "most-empty-fleet":
        b = _zero_fleet(b)
    jkw = {}
    if kw.get("quota"):
        jkw["quota"] = tight_quota(P, seed)
    if kw.get("reservation"):
        jkw["reservation"] = _used_up_reservations(b)
    if kw.get("gang"):
        jkw["gang"] = _rollback_gang(seed)
        mask = np.ones((P, N), dtype=bool)
        mask[5] = False
        jkw["extra_feasible"] = mask
    if "extra" in kw:
        jkw["extra_scores"] = np.full((P, N), kw["extra"], dtype=np.int64)
    if kw.get("infeasible"):
        jkw["extra_feasible"] = np.zeros((P, N), dtype=bool)
    p_real = kw.get("p_real", pods)
    if p_real < pods:
        jkw["extra_feasible"] = np.repeat((np.arange(pods) < p_real)[:, None], N, axis=1)
    g, q, r = constraints_to_torch(jkw.get("gang"), jkw.get("quota"), jkw.get("reservation"))
    tkw = {k: torch.from_numpy(v) for k, v in jkw.items() if isinstance(v, np.ndarray)}
    tkw.update({k: v for k, v in (("gang", g), ("quota", q), ("reservation", r)) if v is not None})
    jh, js = (np.asarray(a) for a in jcycle.schedule_batch(*to_jax(b), tie_break=tie, **jkw))
    if p_real < pods:
        tkw.pop("extra_feasible")
    th, ts = scan_fn_of(b, tkw, tie, kw.get("block_size", 16), p_real)
    assert_same(th, jh, f"hosts {edge}")
    assert_same(ts, js, f"scores {edge}")
    placed = jh >= 0
    if edge == "most-empty-fleet":
        assert np.bincount(jh[placed]).max() > 3
    elif edge == "quota-midway":
        free, _ = jcycle.schedule_batch(*to_jax(b), tie_break=tie)
        assert placed.sum() < (np.asarray(free) >= 0).sum() and placed[-P // 3:].any()
    elif edge == "reservations-used-up":
        assert np.isin(jh, jkw["reservation"].rsv.node).sum() >= 2
    elif edge == "gang-rollback":
        assert not placed[3:9].any() and placed.any()
    elif edge == "most-negative-total":
        assert (js[placed] < 0).any()
    elif edge == "all-infeasible":
        assert not placed.any() and not js.any()
    elif edge == "padding-pods":
        assert placed.any() and not placed[p_real:].any()
    else:
        assert placed.any()


@pytest.mark.parametrize("con", [False, True], ids=["plain", "reservations"])
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("strategy,shape", STRATS, ids=STRAT_IDS)
def test_key_build_matches_jax_score_batch(strategy, shape, wide, con):
    """The key build's plain route (``schedule_keys`` on CPU tensors) under
    MostAllocated and RTC: M's rows are JAX ``score_batch``'s totals and
    feasibility packed as ``score * TB + (TB-1 - rot)`` (the composite key
    of JAX's ``pack_keys``/``run_matrix``, salted), the sentinel where
    infeasible and in the pad rows; Mb their block maxima."""
    seed = 60 + STRATS.index((strategy, shape))
    b = batch(P, N, seed, strategy, shape)
    jkw, tkw = case_inputs("reservations" if con else "plain", b, seed)
    rsv = jkw.get("reservation")
    jt, jf = jcycle.score_batch(*to_jax(b), PluginWeights(), rsv)
    tb = tres.tie_base(N)
    salts = np.asarray(tcycle.tie_salt(torch.arange(P), N)).astype(np.int64)
    rot = (np.arange(N)[None, :] + salts[:, None]) % N
    neg = tres.NEG if wide else tres.NEGK
    want = np.where(np.asarray(jf), np.asarray(jt) * tb + (tb - 1 - rot), neg)
    xs, q_la, q_nf, tsalts, pod_ok = tres.kernel_queue(*(to_torch(b)[i] for i in (0, 3)),
                                                       torch.ones(N, dtype=torch.bool), P, None)
    t = to_torch(b)
    c = tres.con_inputs(xs, reservation=tkw["reservation"]) if con else None
    BS = 16
    M, Mb, feas = tres.schedule_keys(q_la, t[1], t[2], q_nf, t[4], t[5],
                                     torch.ones(N, dtype=torch.bool), pod_ok, tsalts, BS, c,
                                     wide=wide)
    assert M.dtype == (torch.int64 if wide else torch.int32)
    assert_same(M[:N].T, want, "keys")
    assert (M[N:] == neg).all()
    assert_same(Mb, M.view(-1, BS, P).amax(dim=1), "block maxima")
    assert len({int(v) for v in np.asarray(jt)[np.asarray(jf)]}) > 3


@pytest.mark.parametrize("tie", ["salted", "index"])
@pytest.mark.parametrize("con", [False, True], ids=["plain", "constrained"])
def test_matrix_engine_matches_jax_and_the_scan(con, tie):
    """``impl="matrix"`` under LeastAllocated: the JAX matrix engine's
    hosts, scores and round count, and the scan's hosts and scores; with
    the full constraint set (gang, tight quota at cpd 2, reservations, a
    mask and extra scores) and a small commit cap."""
    b = batch(P, N, 11)
    jkw, tkw = case_inputs("all" if con else "plain", b, 11)
    jh, js, jr = jres.schedule_batch_resolved(*to_jax(b), tie_break=tie, impl="matrix",
                                              commit_cap=4, return_rounds=True, **jkw)
    th, ts, tr = tres.schedule_batch_resolved(*to_torch(b), tie_break=tie, impl="matrix",
                                              commit_cap=4, return_rounds=True, **tkw)
    assert_same(th, jh, "hosts")
    assert_same(ts, js, "scores")
    assert tr == int(jr) > 0
    sh, ss = tcycle.schedule_batch(*to_torch(b), tie_break=tie, **tkw)
    assert_same(th, sh, "hosts vs the scan")
    assert_same(ts, ss, "scores vs the scan")
    ph, ps, pr = tres.schedule_batch_resolved(*to_torch(b), tie_break=tie, commit_cap=4,
                                              impl="matrix_packed", return_rounds=True, **tkw)
    assert_same(ph, th, "hosts vs the packed engine")
    assert pr == tr


def test_auto_routes_inflated_weights_to_the_matrix_engine():
    """Plugin weights whose key bound outgrows int32 send ``"auto"`` (and
    ``matrix_packed``) to the matrix engine, in both packages alike."""
    b = batch(P, N, 12)
    jkw, tkw = case_inputs("all", b, 12)
    jw, tw = PluginWeights(nodefit=100_000), TWeights(nodefit=100_000)
    assert not tres.fits_i32(tres.key_bound(tw), N)
    want = jres.schedule_batch_resolved(*to_jax(b), jw, return_rounds=True, **jkw)
    for impl in ("auto", "matrix_packed", "matrix"):
        got = tres.schedule_batch_resolved(*to_torch(b), tw, impl=impl, return_rounds=True,
                                           **tkw)
        assert_same(got[0], want[0], f"{impl} hosts")
        assert_same(got[1], want[1], f"{impl} scores")
        assert got[2] == int(want[2])
    with pytest.raises(ValueError, match="matrix_packed"):
        tres.schedule_batch_resolved(*to_torch(b), tw, return_warm=True, **tkw)


def test_schedule_fn_int64_route_on_cpu_matches_jax():
    """``schedule_fn`` with an extra-score bound past int32 takes the
    int64-key route (plain versions on CPU tensors): the JAX engine's
    hosts, scores, precommit and round count, no warm carry, no launch."""
    b = batch(P, N, 13)
    jkw, tkw = case_inputs("all", b, 13)
    rng = np.random.default_rng(13)
    valid = rng.random(N) < 0.9
    base = valid[None, :] & (np.arange(P) < P - 4)[:, None] & jkw["extra_feasible"]
    order = rng.permutation(P).astype(np.int32)
    jh, js, jr, jp = jres.schedule_batch_resolved(
        *to_jax(b), extra_feasible=base, extra_scores=jkw["extra_scores"], order=order,
        gang=jkw["gang"], quota=jkw["quota"], reservation=jkw["reservation"],
        extra_score_bound=1 << 30, return_rounds=True, return_precommit=True)
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    con_args = dict(gang=tkw["gang"], quota=tkw["quota"], reservation=tkw["reservation"])
    for impl in ("auto", "matrix"):
        bound = 1 << 30 if impl == "auto" else 0
        th, ts, tp, tr, warm = tres.schedule_fn(
            *to_torch(b), torch.from_numpy(valid), P - 4, torch.from_numpy(order),
            con_args=con_args, extra_feasible=tkw["extra_feasible"],
            extra_scores=tkw["extra_scores"], extra_score_bound=bound, impl=impl)
        assert_same(th, jh, "hosts")
        assert_same(ts, js, "scores")
        assert_same(tp, jp, "precommit")
        assert int(tr[0]) == int(jr) and warm is None
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_unknown_impl_raises_on_every_path():
    """An unknown engine name raises ``ValueError`` under LeastAllocated and
    on the scan route, with and without warm flags, in the resolved
    engine and in ``schedule_fn``, as in the JAX package."""
    for strategy in ("LeastAllocated", "MostAllocated"):
        b = batch(8, 16, 0, strategy)
        t, j = to_torch(b), to_jax(b)
        with pytest.raises(ValueError, match="unknown impl"):
            jres.schedule_batch_resolved(*j, impl="candidates")
        for kw in ({}, {"return_warm": True}, {"return_rounds": True}):
            with pytest.raises(ValueError, match="unknown impl"):
                tres.schedule_batch_resolved(*t, impl="candidates", **kw)
        with pytest.raises(ValueError, match="unknown impl"):
            tres.schedule_fn(*t, torch.ones(16, dtype=torch.bool), 8, impl="speculate")


# ------------------------------------------------------------- the engine


def _constraint_sides(strategy: str, shape):
    """Both packages' stores with the same nodes, gangs, quota groups and
    reservations under ``strategy``; and each one's batch."""
    from koordinator_tpu.api import quota as jq
    from koordinator_tpu.utils import fixtures as jfx
    from koordinator_tpu_torch.api import quota as tq
    from koordinator_tpu_torch.utils import fixtures as tfx

    sides = []
    for which, fx, q in (("jax", jfx, jq), ("torch", tfx, tq)):
        k = pkg(which)
        args = k.NodeFitArgs(strategy=k.ScoringStrategyType(strategy))
        if shape is not None:
            args.shape = list(shape)
        scalars = ("kubernetes.io/batch-cpu", "kubernetes.io/batch-memory")
        st = (k.ClusterState(nf_args=args, extra_scalars=scalars, device_state=False)
              if which == "jax" else k.ClusterState(nf_args=args, extra_scalars=scalars))
        for n in fx.random_cluster(31, num_nodes=40, num_pods=0)[1]:
            st.upsert_node(n)
        st.quota.set_total({"cpu": 40 * 8000, "memory": 40 * (32 << 30)})
        for i in range(4):
            st.quota.upsert(q.QuotaGroup(name=f"q{i}", min={"cpu": 2000, "memory": 8 << 30},
                                         max={"cpu": 12_000, "memory": 64 << 30}))
        for i in range(5):
            st.gangs.upsert(k.GangInfo(name=f"g{i}", min_member=2 + i % 3, total_children=6,
                                       create_time=float(i)))
        for i in range(6):
            st.reservations.upsert(k.ReservationInfo(
                name=f"r{i}", node=f"node-{3 * i}", allocatable={"cpu": 3000, "memory": 8 << 30},
                order=i % 3))
        pods = fx.random_cluster(32, num_nodes=0, num_pods=30)[0]
        for i, p in enumerate(pods):
            p.gang = f"g{i % 5}" if i % 3 else None
            p.quota = f"q{i % 4}"
            p.reservations = [f"r{i % 6}", f"r{(i + 2) % 6}"] if i % 2 else []
        sides.append((k, st, engine_of(k, st), pods))
    return sides


def _stores(st) -> tuple:
    qs = st.quota.snapshot()
    return (st.quota.used_arrays(qs)[0].tolist(),
            sorted((r.name, r.node, sorted(r.allocated.items()))
                   for r in st.reservations._rsv.values()),
            sorted((g.name, g.once_satisfied) for g in st.gangs._gangs.values()),
            sorted(st._pod_node.items()))


@pytest.mark.parametrize("strategy,shape", STRATS, ids=STRAT_IDS)
def test_engine_constraints_match_jax(strategy, shape):
    """SCORE, then SCHEDULE cold, unchanged (a begin-cache hit, still a
    cold scan: 0 rounds, no warm hit), ``assume=True`` with two pending
    reservations, and the next cycle: hosts, scores, allocation records
    and the stores after ``assume`` equal the JAX engine's."""
    from koordinator_tpu.utils.fixtures import NOW

    (jk, jst, je, jp), (tk, tst, te, tp) = _constraint_sides(strategy, shape)
    assert_same(te.score(tp, now=NOW)[0], je.score(jp, now=NOW)[0], "totals")
    for c in range(4):
        if c == 2:
            for k, st in ((jk, jst), (tk, tst)):
                for i in range(2):
                    st.reservations.upsert(k.ReservationInfo(
                        name=f"pend-{i}", node=None, allocatable={"cpu": 2000, "memory": 4 << 30},
                        priority=9000, create_time=float(i)))
        jh, js, _, ja = je.schedule(jp, now=NOW + c, assume=c == 2)
        th, ts, _, ta = te.schedule(tp, now=NOW + c, assume=c == 2)
        assert_same(th, jh, f"hosts cycle {c}")
        assert_same(ts, js, f"scores cycle {c}")
        assert ta == ja, f"allocations cycle {c}"
        assert (te.last_rounds, te.last_ub_rounds, te.sched_warm_hits) == (0, 0, 0)
        assert _stores(tst) == _stores(jst), f"stores cycle {c}"
    assert te.sched_begin_hits >= 1 and te.last_reservations_placed == je.last_reservations_placed
    assert (np.asarray(jh) >= 0).any() and any(a and a["reservation"] for a in ja)


@pytest.mark.parametrize("strategy,shape", STRATS, ids=STRAT_IDS)
def test_engine_devices_match_jax(strategy, shape):
    """The device cluster (GPU, RDMA, cpuset and anti-affinity holders,
    taints, NUMA topologies) and the mixed policy batch under ``strategy``:
    SCORE and SCHEDULE with ``assume=True``, then a second cycle, equal the
    JAX engine's, grants and the stores' device state included."""
    from koordinator_tpu.utils.fixtures import NOW

    sides = []
    for which in ("jax", "torch"):
        k = pkg(which)
        st = device_cluster(k, device_state=which == "torch", strategy=strategy, shape=shape)
        sides.append((k, st, engine_of(k, st), policy_batch(k)))
    (jk, jst, je, jp), (tk, tst, te, tp) = sides
    jt, jf, _ = je.score(jp, now=NOW)
    tt, tf, _ = te.score(tp, now=NOW)
    assert_same(tt, jt, "totals")
    assert_same(tf, jf, "feasible")
    for c in range(2):
        jh, js, _, ja = je.schedule(jp, now=NOW + c, assume=c == 0)
        th, ts, _, ta = te.schedule(tp, now=NOW + c, assume=c == 0)
        assert_same(th, jh, f"hosts cycle {c}")
        assert_same(ts, js, f"scores cycle {c}")
        assert ta == ja, f"allocations cycle {c}"
        assert tst._dev_alloc == jst._dev_alloc and tst._pod_node == jst._pod_node
    assert any(a and ("devices" in a or "cpuset" in a) for a in ja)


def test_engine_rtc_score_varies_with_the_shape():
    """The RTC shape reaches the engine's SCORE: two shapes give different
    totals on the same store, each equal to the JAX engine's."""
    from koordinator_tpu.utils.fixtures import NOW

    got = []
    for shape in (BIN_PACKING, NON_MONOTONE):
        out = {}
        for which in ("jax", "torch"):
            k = pkg(which)
            st = device_cluster(k, device_state=which == "torch",
                                strategy="RequestedToCapacityRatio", shape=shape)
            out[which] = engine_of(k, st).score(policy_batch(k), now=NOW)[0]
        assert_same(out["torch"], out["jax"], f"totals {shape}")
        got.append(np.asarray(out["torch"]))
    assert not np.array_equal(got[0], got[1])
