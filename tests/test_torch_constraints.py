"""Gang, quota and reservation constraints: the port's plain versions
against the JAX package's (core/gang.py, core/quota.py,
core/reservation.py, core/resolved.py), on the same numpy-made inputs,
bit for bit.

The resolved-engine cases are those of tests/test_cycle_resolved.py at
P <= 64: the full constraint set at three shapes under both tie-breaks, a
tiny commit cap, a tight quota binding mid-batch, the hierarchical parent
recheck, a reservation-heavy batch and a partial order; then the warm
carry (``return_warm``/``refresh_only``/``warm_init``) with gang and
reservation inputs.  The per-module cases: ``commit_gangs`` with groups,
bound children and non-strict gangs, ``queue_sort_perm`` with gang
timestamps and ties, ``refresh_runtime`` on flat, three-level,
allow-lent, scaled-min and absent-max trees, and ``score_reservation``,
``reservation_score`` and ``order_ranks`` with tied and absent orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.core import gang as jgang
from koordinator_tpu.core import quota as jquota
from koordinator_tpu.core import reservation as jrsv
from koordinator_tpu.core import resolved as jres
from koordinator_tpu.core.cycle import ReservationInputs
from koordinator_tpu.snapshot.quota import QuotaSnapshot
from koordinator_tpu_torch import convert, cuda
from koordinator_tpu_torch.core import gang as tgang
from koordinator_tpu_torch.core import quota as tquota
from koordinator_tpu_torch.core import reservation as trsv
from koordinator_tpu_torch.core import resolved as tres
from test_cycle_resolved import _fixture, _tight_quota
from test_quota import random_tree
from torch_parity import assert_same, constraints_to_torch, to_jax, to_torch

T = lambda a: convert.tensor(a, torch.device("cpu"))  # noqa: E731


def _both(args, nf_st, gang, quota, rsv, order=None, tie="salted", cap=16, cpd=0):
    """(port, JAX) outputs of the resolved engine with every return."""
    b = (*args, nf_st)
    if order is None:
        order = np.asarray(jgang.queue_sort_perm(gang.pods))
    want = jres.schedule_batch_resolved(
        *to_jax(b), order=order, gang=gang, quota=quota, reservation=rsv,
        check_parent_depth=cpd, commit_cap=cap, tie_break=tie, impl="matrix_packed",
        return_rounds=True, return_precommit=True,
    )
    g, q, r = constraints_to_torch(gang, quota, rsv)
    got = tres.schedule_batch_resolved(
        *to_torch(b), order=torch.from_numpy(np.array(order)), gang=g, quota=q,
        reservation=r, check_parent_depth=cpd, commit_cap=cap, tie_break=tie,
        return_rounds=True, return_precommit=True,
    )
    for name, x, y in zip(("hosts", "scores"), got[:2], want[:2]):
        assert_same(x, y, name)
    assert got[2] == int(want[2]), "rounds"
    assert_same(got[3], want[3], "precommit")
    return np.asarray(want[0])


@pytest.mark.parametrize("tie", ["salted", "index"])
@pytest.mark.parametrize("P,N", [(18, 20), (64, 128), (64, 300)])
def test_full_constraints_match(P, N, tie):
    args, nf_st, gang, quota, rsv = _fixture(P, N, seed=P, cseed=P + 1)
    hosts = _both(args, nf_st, gang, quota, rsv, tie=tie)
    assert (hosts >= 0).sum() > 0


def test_tiny_commit_cap():
    args, nf_st, gang, quota, rsv = _fixture(50, 80, seed=7, cseed=8)
    _both(args, nf_st, gang, quota, rsv, cap=3)


def _ub_rounds(args, nf_st, gang, quota, rsv, cpd):
    """The plain round loop's count of rounds that took the upper bound."""
    b = to_torch((*args, nf_st))
    g, q, r = constraints_to_torch(gang, quota, rsv)
    order = torch.from_numpy(np.asarray(jgang.queue_sort_perm(gang.pods)))
    P, N = b[0].est.shape[0], b[1].alloc.shape[0]
    xs, q_la, q_nf, salts = tres._queue(b[0], b[3], order, N, "salted")
    con = tres.con_inputs(xs, g, q, r)
    q_extra = tres.gang_pass(con)[:, None].expand(P, N)
    M, Mb, feas_T = tres.build_keys_plain(q_la, b[1], b[2], q_nf, b[4], b[5],
                                          tres.PluginWeights(), q_extra, salts, 16,
                                          tres._queue_rsv(con))
    out = tres.run_rounds_plain(M, Mb, feas_T, q_la, b[1], b[2], q_nf, b[4], b[5],
                                    tres.PluginWeights(), q_extra, salts, 16, 16, con, cpd)
    return out[4]


def test_tight_quota_binds_mid_batch():
    P, N = 64, 60
    args, nf_st, gang, _, rsv = _fixture(P, N, seed=9, cseed=10)
    quota = _tight_quota(P, seed=11)
    hosts = _both(args, nf_st, gang, quota, rsv)
    assert 0 < (hosts >= 0).sum() < P
    assert _ub_rounds(args, nf_st, gang, quota, rsv, 0) > 0


@pytest.mark.parametrize("tie", ["salted", "index"])
def test_hierarchical_parent_recheck(tie):
    P, N = 64, 48
    args, nf_st, gang, _, rsv = _fixture(P, N, seed=12, cseed=13)
    quota = _tight_quota(P, seed=14, depth_chain=True)
    hosts = _both(args, nf_st, gang, quota, rsv, tie=tie, cpd=2)
    assert 0 < (hosts >= 0).sum() < P


def _heavy_rsv(P, N, Rf, seed):
    rng = np.random.default_rng(seed)
    Rv = 24
    rsv = jrsv.ReservationArrays(
        node=rng.integers(0, N, Rv).astype(np.int32),
        allocatable=rng.integers(0, 6000, (Rv, Rf)).astype(np.int64),
        allocated=rng.integers(0, 500, (Rv, Rf)).astype(np.int64),
        order=np.where(rng.random(Rv) < 0.5, rng.integers(1, 30, Rv), 0).astype(np.int64),
    )
    matched = rng.random((P, Rv)) < 0.6
    pod_req = rng.integers(0, 3000, (P, Rf)).astype(np.int64)
    return ReservationInputs(
        rsv=rsv, matched=matched,
        rscore=np.asarray(jrsv.score_reservation(pod_req, rsv)),
        scores=np.asarray(jrsv.reservation_score(pod_req, matched, N, rsv)),
    )


def test_reservation_heavy():
    P, N = 64, 40
    args, nf_st, gang, quota, _ = _fixture(P, N, seed=15, cseed=16)
    _both(args, nf_st, gang, quota, _heavy_rsv(P, N, args[3].req.shape[1], 17))


def test_partial_order_leaves_rest_unplaced():
    args, nf_st, gang, quota, rsv = _fixture(30, 50, seed=4, cseed=5)
    order = np.asarray(jgang.queue_sort_perm(gang.pods))[:11]
    hosts = _both(args, nf_st, gang, quota, rsv, order=order)
    assert (hosts[np.setdiff1d(np.arange(30), order)] == -1).all()


@pytest.mark.parametrize("P,N,seed", [(40, 90, 21), (64, 250, 22)])
def test_warm_carry_with_gang_and_reservation(P, N, seed):
    """``return_warm``, ``refresh_only`` and ``warm_init`` with gang and
    reservation inputs: the port's carries and warm rounds equal the
    JAX package's, and a refreshed carry equals a cold one."""
    args, nf_st, gang, quota, rsv = _fixture(P, N, seed=seed, cseed=seed + 1)
    b = (*args, nf_st)
    order = np.asarray(jgang.queue_sort_perm(gang.pods))
    bound = int(np.asarray(rsv.matched).sum(axis=1).max())
    kw = dict(order=order, gang=gang, reservation=rsv, rsv_match_bound=bound)
    g, q, r = constraints_to_torch(gang, quota, rsv)
    tkw = dict(order=torch.from_numpy(order), gang=g, reservation=r, rsv_match_bound=bound)
    jw = jres.schedule_batch_resolved(*to_jax(b), **kw, quota=quota, impl="matrix_packed",
                                      return_warm=True)[2]
    tw = tres.schedule_batch_resolved(*to_torch(b), **tkw, quota=q, return_warm=True)[2]
    for x, y in zip(tw, jw):
        assert_same(x, y, "cold carry")

    # perturb some node rows, refresh them, and schedule from the carry
    rng = np.random.default_rng(seed)
    d = np.sort(rng.choice(N, 9, replace=False)).astype(np.int32)
    dirty = np.concatenate([d, np.full(7, d[0], dtype=np.int32)])
    la_n = args[1]._replace(base_nonprod=np.asarray(args[1].base_nonprod).copy())
    nf_n = args[4]._replace(requested=np.asarray(args[4].requested).copy())
    la_n.base_nonprod[d] += np.asarray(la_n.alloc)[d] // 5
    nf_n.requested[d] += np.asarray(nf_n.alloc)[d] // 4
    b2 = (args[0], la_n, args[2], args[3], nf_n, nf_st)
    jr = jres.schedule_batch_resolved(*to_jax(b2), **kw, impl="matrix_packed", warm_init=jw,
                                      dirty_cols=dirty, refresh_only=True)
    tr = tres.schedule_batch_resolved(*to_torch(b2), **tkw, warm_init=tw,
                                      dirty_cols=torch.from_numpy(dirty), refresh_only=True)
    cold = tres.schedule_batch_resolved(*to_torch(b2), **tkw, return_warm=True)[2]
    for x, y, z in zip(tr, jr, cold):
        assert_same(x, y, "refreshed carry")
        assert_same(x, z, "refreshed vs cold carry")
    jh = jres.schedule_batch_resolved(*to_jax(b2), **kw, quota=quota, impl="matrix_packed",
                                      warm_init=jr, return_precommit=True)
    th = tres.schedule_batch_resolved(*to_torch(b2), **tkw, quota=q, warm_init=tr,
                                      return_precommit=True)
    for name, x, y in zip(("hosts", "scores", "precommit"), th, jh):
        assert_same(x, y, f"warm {name}")


# ---------------------------------------------------------------- modules


def _gang_case(seed, P=40, G=9):
    rng = np.random.default_rng(seed)
    gang_of = rng.integers(0, G, P).astype(np.int32)
    group = np.arange(G, dtype=np.int32)
    group[3], group[4], group[7] = 2, 2, 6  # gangs 2, 3, 4 and 6, 7 share groups
    pods = jgang.GangPodArrays(
        gang=gang_of, priority=rng.integers(0, 3, P).astype(np.int64),
        sub_priority=rng.integers(0, 2, P).astype(np.int64),
        timestamp=rng.integers(0, 4, P).astype(np.float64),
    )
    gangs = jgang.GangArrays(
        min_member=np.array([0] + list(rng.integers(1, 6, G - 1)), dtype=np.int64),
        member_count=np.bincount(gang_of, minlength=G).astype(np.int64),
        has_init=np.array([True] + list(rng.random(G - 1) < 0.85)),
        once_satisfied=np.array([False] + list(rng.random(G - 1) < 0.2)),
        group=group,
        bound_count=np.array([0] + list(rng.integers(0, 3, G - 1)), dtype=np.int64),
        non_strict=np.array([False] + list(rng.random(G - 1) < 0.3)),
    )
    hosts = np.where(rng.random(P) < 0.7, rng.integers(0, 50, P), -1).astype(np.int32)
    return pods, gangs, hosts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("optional", [True, False])
def test_commit_gangs_and_prefilter_match(seed, optional):
    pods, gangs, hosts = _gang_case(seed)
    if not optional:
        gangs = gangs._replace(group=None, bound_count=None, non_strict=None)
    tp = tgang.GangPodArrays(*(T(a) for a in pods))
    tg = tgang.GangArrays(*(None if a is None else T(a) for a in gangs))
    jh, jok = jgang.commit_gangs(jnp.asarray(hosts), pods, gangs)
    th, tok = tgang.commit_gangs(T(hosts), tp, tg)
    assert_same(th, jh, "hosts")
    assert_same(tok, jok, "gang_ok")
    assert_same(tgang.gang_prefilter(tp, tg), jgang.gang_prefilter(pods, gangs), "prefilter")


@pytest.mark.parametrize("seed", [3, 4])
def test_queue_sort_perm_matches_with_gang_timestamps(seed):
    pods, _, _ = _gang_case(seed, P=64)
    want = np.asarray(jgang.queue_sort_perm(pods))
    got = tgang.queue_sort_perm(tgang.GangPodArrays(*(T(a) for a in pods)))
    assert_same(got, want, "queue order")


def _tree(kind):
    from koordinator_tpu.api.quota import ROOT_QUOTA, QuotaGroup

    if kind == "random":
        return random_tree(5, 14)
    cpu, mem = "cpu", "memory"
    if kind == "flat":
        return [QuotaGroup(name=f"q{i}", min={cpu: 1000 * i, mem: 10 * i},
                           max={cpu: 5000 + 1000 * i, mem: 200},
                           pod_requests={cpu: 700 * (i + 3), mem: 40 * i},
                           allow_lent=i % 3 != 0) for i in range(6)]
    groups = [QuotaGroup(name="a", min={cpu: 9000, mem: 400}, max={cpu: 20000, mem: 900},
                         is_parent=True),
              QuotaGroup(name="b", min={cpu: 3000, mem: 100}, max={cpu: 8000, mem: 300},
                         is_parent=True, enable_scale_min=True)]
    for i in range(4):
        groups.append(QuotaGroup(name=f"a{i}", parent="a", min={cpu: 2000, mem: 90},
                                 max={cpu: 9000, mem: 500}, enable_scale_min=i % 2 == 0,
                                 pod_requests={cpu: 3000 * i, mem: 120 * i},
                                 shared_weight={cpu: 1 + i, mem: 2}))
    for i in range(3):
        groups.append(QuotaGroup(name=f"b{i}", parent="b", min={cpu: 1000},
                                 max={cpu: 6000} if kind == "absent_max" else
                                 {cpu: 6000, mem: 200},
                                 guarantee={cpu: 500} if i == 0 else {},
                                 allow_lent=i != 1, is_parent=True))
        groups.append(QuotaGroup(name=f"b{i}x", parent=f"b{i}", min={cpu: 400},
                                 max={cpu: 3000} if kind == "absent_max" else
                                 {cpu: 3000, mem: 150},
                                 pod_requests={cpu: 2500 + 300 * i, mem: 60}))
    if kind == "absent_max":
        groups[1].max = {cpu: 8000}
    return groups


@pytest.mark.parametrize("kind", ["flat", "three_level", "absent_max", "random"])
@pytest.mark.parametrize("scale_min", [True, False])
def test_refresh_runtime_matches(kind, scale_min):
    groups = _tree(kind)
    snap = QuotaSnapshot(groups, ["cpu", "memory"])
    for total in (np.array([30000, 1000], dtype=np.int64), np.array([9000, 300], np.int64)):
        want = np.asarray(jax.jit(jquota.refresh_runtime, static_argnums=(3,))(
            snap.arrays(), snap.level_tuple(), total, scale_min))
        qa = tquota.QuotaArrays(*(T(a) for a in snap.arrays()))
        got = tquota.quota_fn(qa, snap.level_tuple(), T(total), scale_min)
        assert_same(got, want, f"{kind} runtime")
        if scale_min:  # the admission limit always scales the mins
            limit = tquota.quota_limit_fn(qa, snap.level_tuple(), T(total))
            assert_same(limit, snap.used_limit(want), f"{kind} limit")


@pytest.mark.parametrize("seed", [0, 1])
def test_quota_prefilter_matches(seed):
    rng = np.random.default_rng(seed)
    quota = _tight_quota(48, seed, depth_chain=True)
    used = rng.integers(0, 9000, quota.used.shape).astype(np.int64)
    for depth in (0, 1, 2):
        want = jquota.quota_prefilter(quota.pods, used, quota.limit, used // 2, quota.min,
                                      quota.parent, depth)
        got = tquota.quota_prefilter(tquota.QuotaPodArrays(*(T(a) for a in quota.pods)),
                                     T(used), T(quota.limit), T(used // 2), T(quota.min),
                                     T(quota.parent), depth)
        assert_same(got, want, f"depth {depth}")


def _rsv_case(seed, P=48, N=60, Rv=24, Rf=4):
    rng = np.random.default_rng(seed)
    order = np.where(rng.random(Rv) < 0.6, rng.integers(1, 5, Rv), 0).astype(np.int64)  # ties
    rsv = jrsv.ReservationArrays(
        node=rng.integers(0, N // 3, Rv).astype(np.int32),  # several per node
        allocatable=np.where(rng.random((Rv, Rf)) < 0.8,
                             rng.integers(100, 6000, (Rv, Rf)), 0).astype(np.int64),
        allocated=rng.integers(0, 300, (Rv, Rf)).astype(np.int64),
        order=order,
    )
    matched = rng.random((P, Rv)) < 0.25
    pod_req = rng.integers(0, 3000, (P, Rf)).astype(np.int64)
    return rsv, matched, pod_req


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reservation_scoring_matches(seed):
    rsv, matched, pod_req = _rsv_case(seed)
    N = 60
    trv = trsv.ReservationArrays(*(T(a) for a in rsv))
    assert_same(trsv.rsv_rscore(T(pod_req), trv), jrsv.score_reservation(pod_req, rsv), "rscore")
    rank, sidx = trsv.order_ranks(T(rsv.order))
    jrank, jsidx = jrsv.order_ranks(jnp.asarray(rsv.order))
    assert_same(rank, jrank, "rank")
    assert_same(sidx, jsidx, "sorted_idx")
    want = jrsv.reservation_score(pod_req, matched, N, rsv)
    assert_same(trsv.rsv_score(T(pod_req), T(matched), N, trv, rank), want, "scores")
    assert_same(trsv.restore_extra_free(T(matched), trv, N),
                jrsv.restore_extra_free(jnp.asarray(matched), rsv, N), "restore")
    for p in range(0, 48, 7):
        host = int(rsv.node[p % rsv.node.shape[0]])
        rs = jrsv.score_reservation(pod_req, rsv)
        ji, jv = jrsv.nominate_on_node(jnp.asarray(matched[p]), rs[p], rsv, host)
        ti, tv = trsv.nominate_on_node(T(matched[p]), T(np.asarray(rs[p])), trv, host)
        assert bool(tv) == bool(jv) and (not tv or int(ti) == int(ji))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rsv_rows_matches_jax(seed):
    """``rsv_rows`` (one launch for both rows on a card) on CPU tensors
    against the JAX package's ``score_reservation`` and
    ``reservation_score``."""
    rsv, matched, pod_req = _rsv_case(seed)
    trv = trsv.ReservationArrays(*(T(a) for a in rsv))
    rank = trsv.order_ranks(T(rsv.order))[0]
    want = (jrsv.score_reservation(pod_req, rsv), jrsv.reservation_score(pod_req, matched, 60, rsv))
    got = trsv.rsv_rows(T(pod_req), T(matched), 60, trv, rank)
    assert_same(got[0], want[0], "rscore")
    assert_same(got[1], want[1], "scores")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_order_ranks_host_equals_order_ranks(seed):
    """The engine's host ranks (numpy) equal ``order_ranks`` and the JAX
    package's, absent and tied orders included."""
    rng = np.random.default_rng(seed)
    for Rv in (1, 7, 24, 256):
        order = np.where(rng.random(Rv) < 0.6, rng.integers(-2, 5, Rv), 0).astype(np.int64)
        want = np.asarray(jrsv.order_ranks(jnp.asarray(order))[0])
        assert np.array_equal(trsv.order_ranks_host(order), want)
        assert np.array_equal(trsv.order_ranks(T(order))[0].numpy(), want)


def test_upload_stage_views_equal_their_arrays():
    """One pack of a cycle's host arrays (``UploadStage`` on the CPU: a
    fresh host buffer, no copy): every view bit for bit its array, for each
    dtype and odd lengths, every offset a multiple of 256, and the views of
    an earlier pack untouched by a later one."""
    from koordinator_tpu_torch.service.state import UPLOAD_ALIGN, UploadStage, upload_layout

    rng = np.random.default_rng(5)
    arrays = [rng.integers(-(1 << 62), 1 << 62, (7, 3)), rng.random((5, 11)) < 0.5,
              rng.integers(-5, 5, 13).astype(np.int32), np.zeros((0, 4), np.int64),
              rng.integers(0, 1 << 40, 1), rng.random(3).astype(np.float64),
              rng.integers(-9, 9, (3, 3)).astype(np.int32)[:, ::2]]
    offsets, total = upload_layout(a.nbytes for a in arrays)
    assert all(o % UPLOAD_ALIGN == 0 for o in offsets) and total % UPLOAD_ALIGN == 0
    stage = UploadStage()
    views = stage.upload(arrays, "cpu")
    for a, v, o in zip(arrays, views, offsets):
        assert v.dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
        assert tuple(v.shape) == a.shape
        assert np.array_equal(v.numpy().view(np.uint8), np.ascontiguousarray(a).view(np.uint8))
        assert v.storage_offset() * v.element_size() == o and o % UPLOAD_ALIGN == 0
    keep = [v.clone() for v in views]
    stage.upload([np.full_like(a, 1) for a in arrays], "cpu")
    assert all(torch.equal(v, k) for v, k in zip(views, keep))
    assert stage.copies == 2


def test_match_index_lists_every_match():
    _, matched, _ = _rsv_case(3)
    bound = int(matched.sum(axis=1).max())
    midx = trsv.match_index(T(matched), bound + 2).numpy()
    for p in range(matched.shape[0]):
        row = midx[p]
        assert list(row[row >= 0]) == list(np.flatnonzero(matched[p]))


def test_constraint_wrappers_take_cpu_tensors_without_launching():
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    rsv, matched, pod_req = _rsv_case(4)
    trv = trsv.ReservationArrays(*(T(a) for a in rsv))
    trsv.rsv_score(T(pod_req), T(matched), 60, trv, trsv.order_ranks(T(rsv.order))[0])
    trsv.rsv_rscore(T(pod_req), trv)
    trsv.rsv_rows(T(pod_req), T(matched), 60, trv, trsv.order_ranks(T(rsv.order))[0])
    snap = QuotaSnapshot(_tree("flat"), ["cpu", "memory"])
    qa = tquota.QuotaArrays(*(T(a) for a in snap.arrays()))
    tquota.quota_limit_fn(qa, snap.level_tuple(), T(np.array([9000, 300], np.int64)))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_rank_cache_follows_the_reservation_store():
    """The engine's order ranks are built once a change of the reservation
    store: an upsert with a new order label rebuilds them (and they equal
    ``order_ranks`` of the new labels); a metric update, which leaves the
    store and the node-row mapping as they are, does not."""
    from koordinator_tpu_torch.api.model import NodeMetric
    from koordinator_tpu_torch.service.constraints import ReservationInfo
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.service.state import ClusterState
    from koordinator_tpu_torch.utils import fixtures as tfx

    st = ClusterState(initial_capacity=16)
    for n in tfx.random_cluster(3, num_nodes=12, num_pods=0)[1]:
        st.upsert_node(n)
    for i in range(6):
        st.reservations.upsert(ReservationInfo(name=f"r{i}", node=f"node-{i}",
                                               allocatable={"cpu": 3000}, order=[0, 3, 3][i % 3]))
    eng = Engine(st, device="cpu")
    pods = [tfx.random_pod(np.random.default_rng([3, i]), f"p{i}", "pending") for i in range(4)]
    for i, p in enumerate(pods):
        p.reservations = [f"r{i}", f"r{i + 1}"]

    def ranks():
        eng.schedule(pods, now=tfx.NOW)
        order = np.array([st.reservations.get(f"r{i}").order for i in range(6)] + [0, 0])
        assert np.array_equal(eng._rsv_rank_val, trsv.order_ranks(T(order))[0].numpy())
        return eng._rsv_rank_val.copy(), eng.rsv_rank_builds

    first, builds = ranks()
    assert builds == 1
    st.update_metric("node-1", NodeMetric(node_usage={"cpu": 100}, update_time=tfx.NOW))
    again, builds = ranks()
    assert builds == 1 and np.array_equal(again, first)
    st.reservations.upsert(ReservationInfo(name="r0", node="node-0", allocatable={"cpu": 3000},
                                           order=1))
    moved, builds = ranks()
    assert builds == 2 and not np.array_equal(moved, first)
