"""The port's Engine against the JAX package's on op streams with gangs,
ElasticQuota groups and reservations in the stores: hosts, scores and
allocation records, the warm/cold/begin counters, and, after
``assume=True``, the stores — quota used, reservation allocations and
bindings, gang satisfaction — equal bit for bit.  The JAX side runs with
``device_state=False``, the port with its default resident tables.

The cycles follow tests/test_sched_warm.py's constraint cases: a warm hit
on an unchanged store, a quota change that stays warm (and equals a cold
twin), gang and reservation changes that fall cold; then ``assume=True``
with pending reservations, the next batch after it, and a gang group
that misses its quorum and is rolled back as a whole."""

import numpy as np
import pytest

import koordinator_tpu.api.model as jm
import koordinator_tpu.api.quota as jq
import koordinator_tpu.service.constraints as jc
import koordinator_tpu_torch.api.model as tm
import koordinator_tpu_torch.api.quota as tq
import koordinator_tpu_torch.service.constraints as tc
from koordinator_tpu.service.engine import Engine as JEngine
from koordinator_tpu.service.state import ClusterState as JState
from koordinator_tpu.utils import fixtures as jfx
from koordinator_tpu_torch.service.engine import Engine
from koordinator_tpu_torch.service.state import ClusterState
from koordinator_tpu_torch.utils import fixtures as tfx
from torch_parity import assert_same

NOW = jfx.NOW
GB = 1 << 30
SCALARS = (jm.BATCH_CPU, jm.BATCH_MEMORY)


class _Side:
    def __init__(self, state, engine, fx, m, q, c):
        self.state, self.engine, self.fx, self.m, self.q, self.c = state, engine, fx, m, q, c


def _sides(num_nodes, seed):
    j = JState(extra_scalars=SCALARS, initial_capacity=16, device_state=False)
    t = ClusterState(extra_scalars=SCALARS, initial_capacity=16)
    sides = (_Side(j, JEngine(j), jfx, jm, jq, jc), _Side(t, Engine(t, device="cpu"), tfx, tm, tq, tc))
    for s in sides:
        _populate(s, num_nodes, seed)
    return sides


def _populate(s, num_nodes, seed):
    """Nodes, a two-level quota tree, gangs (a group, a non-strict gang, a
    waiting-and-running gang) and reservations with tied orders."""
    st, c, q = s.state, s.c, s.q
    for n in s.fx.random_cluster(seed, num_nodes=num_nodes, num_pods=0)[1]:
        st.upsert_node(n)
    cpu, mem = jm.CPU, jm.MEMORY
    st.quota.upsert(q.QuotaGroup(name="team-a", min={cpu: 20000, mem: 64 * GB},
                                 max={cpu: 60000, mem: 256 * GB}, is_parent=True))
    st.quota.upsert(q.QuotaGroup(name="a0", parent="team-a", min={cpu: 8000, mem: 16 * GB},
                                 max={cpu: 30000, mem: 128 * GB}))
    st.quota.upsert(q.QuotaGroup(name="a1", parent="team-a", min={cpu: 4000, mem: 16 * GB},
                                 max={cpu: 12000, mem: 64 * GB}, allow_lent=False))
    st.quota.upsert(q.QuotaGroup(name="b", min={cpu: 6000, mem: 32 * GB},
                                 max={cpu: 16000, mem: 96 * GB}, enable_scale_min=True))
    st.quota.set_total({cpu: num_nodes * 4000, mem: num_nodes * 16 * GB})
    st.gangs.upsert(c.GangInfo(name="g0", min_member=2, total_children=3, create_time=5.0))
    st.gangs.upsert(c.GangInfo(name="g1", min_member=2, total_children=2, create_time=1.0,
                               gang_group=("g1", "g2")))
    st.gangs.upsert(c.GangInfo(name="g2", min_member=1, total_children=1, create_time=2.0,
                               gang_group=("g1", "g2")))
    st.gangs.upsert(c.GangInfo(name="g3", min_member=5, total_children=6, create_time=0.5,
                               mode=c.GANG_MODE_NON_STRICT))
    st.gangs.upsert(c.GangInfo(name="g4", min_member=2, total_children=2, create_time=3.0,
                               match_policy=c.MATCH_WAITING_AND_RUNNING))
    rng = np.random.default_rng(seed + 5)
    for i in range(10):
        st.reservations.upsert(c.ReservationInfo(
            name=f"r{i}", node=f"node-{int(rng.integers(0, num_nodes))}",
            allocatable={cpu: 3000, mem: 8 * GB}, order=[0, 3, 3, 0, 7, 1][i % 6],
            allocate_once=i == 4, create_time=float(i)))


def _batch(s, seed, n, tag):
    rng = np.random.default_rng(seed)
    pods = [s.fx.random_pod(np.random.default_rng([seed, i]), f"{tag}-{i}", "pending")
            for i in range(n)]
    gangs = ["g0", "g1", "g2", "g3", "g4", "ghost"]
    for i, p in enumerate(pods):
        k = int(rng.integers(0, 10))
        if k < 4:
            p.gang = gangs[int(rng.integers(0, len(gangs)))]
        if rng.random() < 0.6:
            p.quota = ["a0", "a1", "b", "missing"][int(rng.integers(0, 4))]
            p.non_preemptible = bool(rng.random() < 0.3)
        if rng.random() < 0.5:
            p.reservations = [f"r{int(j)}" for j in rng.choice(10, int(rng.integers(1, 3)),
                                                                 replace=False)]
        if i % 5 == 0:
            p.priority, p.create_time = 9500, float(i % 3)
    return pods


def _check(sides, outs, what):
    (jh, js, _, ja), (th, ts, _, ta) = outs
    assert_same(th, jh, f"{what}: hosts")
    assert_same(ts, js, f"{what}: scores")
    assert ta == ja, f"{what}: allocation records"
    je, te = sides[0].engine, sides[1].engine
    assert (te.sched_warm_hits, te.sched_cold_inits, te.sched_begin_hits) == (
        je.sched_warm_hits, je.sched_cold_inits, je.sched_begin_hits), f"{what}: counters"


def _stores_equal(sides):
    js, ts = sides[0].state, sides[1].state
    jqs, tqs = js.quota.snapshot(), ts.quota.snapshot()
    for a, b in zip(js.quota.used_arrays(jqs), ts.quota.used_arrays(tqs)):
        assert_same(b, a, "quota used")
    jr = {r.name: (r.node, dict(r.allocated), r.consumed_once) for r in js.reservations._rsv.values()}
    tr = {r.name: (r.node, dict(r.allocated), r.consumed_once) for r in ts.reservations._rsv.values()}
    assert tr == jr
    assert {n: (g.once_satisfied, sorted(g.bound)) for n, g in ts.gangs._gangs.items()} == \
        {n: (g.once_satisfied, sorted(g.bound)) for n, g in js.gangs._gangs.items()}
    assert ts._pod_node == js._pod_node


def _schedule(sides, batches, now, assume=False):
    return [s.engine.schedule(b, now=now, assume=assume) for s, b in zip(sides, batches)]


@pytest.mark.parametrize("seed,num_nodes,num_pods", [(31, 40, 48), (32, 90, 64)])
def test_constrained_cycles_match_jax(seed, num_nodes, num_pods):
    sides = _sides(num_nodes, seed)
    batches = [_batch(s, seed, num_pods, "p") for s in sides]
    _check(sides, _schedule(sides, batches, NOW), "cold")
    _check(sides, _schedule(sides, batches, NOW + 1), "unchanged (warm)")
    assert sides[1].engine.sched_warm_hits == 1

    # a quota change keeps the carry warm, and equals a cold twin
    for s in sides:
        s.state.quota.upsert(s.q.QuotaGroup(name="a0", parent="team-a",
                                            min={jm.CPU: 2000, jm.MEMORY: 4 * GB},
                                            max={jm.CPU: 6000, jm.MEMORY: 32 * GB}))
    outs = _schedule(sides, batches, NOW + 2)
    _check(sides, outs, "quota change")
    assert sides[1].engine.sched_warm_hits == 2
    twin = Engine(sides[1].state, device="cpu")
    twin.sched_warm_enabled = False
    ch, cs, _, ca = twin.schedule(batches[1], now=NOW + 2)
    assert_same(outs[1][0], ch, "warm vs cold twin")
    assert_same(outs[1][1], cs, "warm vs cold twin scores")
    assert outs[1][3] == ca

    # gang and reservation changes fall cold
    for s in sides:
        s.state.gangs.upsert(s.c.GangInfo(name="g5", min_member=1, total_children=1))
    _check(sides, _schedule(sides, batches, NOW + 3), "gang change")
    for s in sides:
        s.state.reservations.upsert(s.c.ReservationInfo(
            name="r-new", node="node-3", allocatable={jm.CPU: 1000, jm.MEMORY: GB}, order=2))
    _check(sides, _schedule(sides, batches, NOW + 4), "reservation change")
    assert sides[1].engine.sched_cold_inits == 3

    # assume=True with pending reservations: reserve pods go first
    for s in sides:
        for i in range(3):
            s.state.reservations.upsert(s.c.ReservationInfo(
                name=f"pend-{i}", node=None, allocatable={jm.CPU: 2000 + 500 * i,
                                                          jm.MEMORY: 4 * GB},
                priority=9000, create_time=float(i)))
    outs = _schedule(sides, batches, NOW + 5, assume=True)
    _check(sides, outs, "assume")
    assert sides[1].engine.last_reservations_placed == sides[0].engine.last_reservations_placed
    assert sides[1].engine.last_reservations_placed
    _stores_equal(sides)
    assert any(g.once_satisfied for g in sides[1].state.gangs._gangs.values())

    nxt = [_batch(s, seed + 1, num_pods, "q") for s in sides]
    _check(sides, _schedule(sides, nxt, NOW + 6, assume=True), "next batch after assume")
    _stores_equal(sides)


def test_gang_group_rolled_back_as_a_whole():
    """A gang group whose member gang misses minMember loses every
    placement; once the member arrives, the group lands atomically and
    both gangs become once-satisfied."""
    sides = _sides(12, 41)
    for s in sides:
        s.state.gangs.upsert(s.c.GangInfo(name="A", min_member=1, total_children=1,
                                          gang_group=("A", "B")))
        s.state.gangs.upsert(s.c.GangInfo(name="B", min_member=2, total_children=2,
                                          gang_group=("A", "B")))
    pods = [[s.m.Pod(name="a-0", requests={jm.CPU: 1000, jm.MEMORY: GB}, gang="A"),
             s.m.Pod(name="b-0", requests={jm.CPU: 1000, jm.MEMORY: GB}, gang="B")]
            for s in sides]
    outs = _schedule(sides, pods, NOW, assume=True)
    _check(sides, outs, "group missing a member")
    assert (outs[1][0] == -1).all()
    _stores_equal(sides)
    for s, p in zip(sides, pods):
        p.append(s.m.Pod(name="b-1", requests={jm.CPU: 1000, jm.MEMORY: GB}, gang="B"))
    outs = _schedule(sides, pods, NOW + 1, assume=True)
    _check(sides, outs, "group complete")
    assert (outs[1][0] >= 0).all()
    _stores_equal(sides)
    assert sides[1].state.gangs.get("A").once_satisfied
    assert sides[1].state.gangs.get("B").once_satisfied


def test_score_ignores_constraint_fields():
    """SCORE does not read gang, quota or reservation fields, as in the JAX
    package."""
    sides = _sides(30, 51)
    pods = [_batch(s, 51, 20, "s") for s in sides]
    (jt, jf, _), (tt, tf, _) = [s.engine.score(p, now=NOW) for s, p in zip(sides, pods)]
    assert_same(tt, jt, "totals")
    assert_same(tf, jf, "feasible")


def test_quota_refresh_matches_jax():
    from test_quota import random_tree

    groups = random_tree(9, 12)
    total = {"cpu": 90000, "memory": 4000}
    jqs, jrt = JEngine(JState()).quota_refresh(groups, ["cpu", "memory"], total)
    tgroups = [tq.QuotaGroup(**g.__dict__) for g in groups]
    tqs, trt = Engine(ClusterState(), device="cpu").quota_refresh(tgroups, ["cpu", "memory"],
                                                                  total)
    assert_same(trt, jrt, "runtime")
    assert tqs.index == jqs.index


def test_constrained_batch_under_most_allocated_raises():
    """A constrained batch under MostAllocated takes the scan with its gang,
    quota and reservation branches and equals the JAX engine: hosts,
    scores, allocation records, and the stores after ``assume``."""
    from koordinator_tpu.core.config import NodeFitArgs as JArgs, ScoringStrategyType as JT
    from koordinator_tpu_torch.core.config import NodeFitArgs, ScoringStrategyType

    j = JState(nf_args=JArgs(strategy=JT.MOST_ALLOCATED), extra_scalars=SCALARS,
               device_state=False)
    t = ClusterState(nf_args=NodeFitArgs(strategy=ScoringStrategyType.MOST_ALLOCATED),
                     extra_scalars=SCALARS)
    for st, fx, c in ((j, jfx, jc), (t, tfx, tc)):
        for n in fx.random_cluster(3, num_nodes=8, num_pods=0)[1]:
            st.upsert_node(n)
        st.gangs.upsert(c.GangInfo(name="g", min_member=1, total_children=1))
    je, te = JEngine(j), Engine(t, device="cpu")
    for k, (name, gang) in enumerate((("p", None), ("q", "g"))):
        outs = [e.schedule([m.Pod(name=name, requests={jm.CPU: 1000}, gang=gang)], now=NOW + k,
                           assume=True) for e, m in ((je, jm), (te, tm))]
        assert_same(outs[1][0], outs[0][0], f"hosts {name}")
        assert_same(outs[1][1], outs[0][1], f"scores {name}")
        assert outs[1][3] == outs[0][3] and outs[1][0][0] >= 0
    assert t._pod_node == j._pod_node
    assert t.gangs.get("g").once_satisfied == j.gangs.get("g").once_satisfied
