"""The cross-cycle SCHEDULE warm start of the port against the JAX package's.

The JAX ``Engine`` in its defaults (``device_state=True``, warm start on)
and the port's ``Engine(device="cpu")`` get the same plain-pod op streams;
every cycle's hosts, scores and allocation records must be equal, and so
must the warm/cold/begin counters.  The cases are the plain-pod cut of
``tests/test_sched_warm.py``: an unchanged re-schedule refreshes nothing,
the warm start is a pure optimisation, churn refreshes by delta and equals
a cold twin, a metric-expiry gate flip re-dirties exactly the flipped rows,
a mostly-dirty carry and capacity growth fall back cold, a new store or a
changed batch or exclude set never reuses a carry, and ``commit_cap > P``
with padded dirty sets (the duplicate-index trap).  At the resolved level,
``refresh_only`` and ``warm_init`` equal the JAX ``schedule_batch_resolved``
under the same flags, carry for carry.
"""

import jax
import numpy as np
import pytest
import torch

import koordinator_tpu.api.model as jm
import koordinator_tpu_torch.api.model as tm
from koordinator_tpu.core import resolved as jres
from koordinator_tpu.service.engine import Engine as JEngine
from koordinator_tpu.service.kernelprof import PROFILER
from koordinator_tpu.service.state import ClusterState as JState
from koordinator_tpu_torch.core import resolved as tres
from koordinator_tpu_torch.service import engine as tengine
from koordinator_tpu_torch.service.engine import Engine
from koordinator_tpu_torch.service.state import ClusterState
from torch_parity import assert_same, batch, to_jax, to_torch

GB = 1 << 30
NOW = 6_000_000.0
CPU, MEMORY = jm.CPU, jm.MEMORY


def _fill(st, m, n, prefix="w-n"):
    for i in range(n):
        st.upsert_node(m.Node(name=f"{prefix}{i}",
                              allocatable={CPU: 16000, MEMORY: 64 * GB, "pods": 64},
                              labels={"zone": f"z{i % 3}"}))
    for i in range(n):
        st.update_metric(f"{prefix}{i}", m.NodeMetric(
            node_usage={CPU: 200 + 311 * (i % 9), MEMORY: (1 + i % 5) * GB},
            update_time=NOW, report_interval=60.0,
        ))
    return st


def _pods(m, n=40, seed=0, bump=0):
    """Fresh Pod objects every call: the fingerprint is value-based."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(n):
        pods.append(m.Pod(
            name=f"wp-{i}",
            requests={CPU: int(rng.integers(200, 3000)) + (bump if i == 0 else 0),
                      MEMORY: int(rng.integers(1, 6)) * GB},
            priority=[None, 9500, 7500][i % 3],
            create_time=float(i % 4),
        ))
    return pods


class Pair:
    """A JAX engine and the port's CPU engine over twin stores."""

    def __init__(self, n=24, warm=True):
        self.j = _fill(JState(), jm, n)
        self.t = _fill(ClusterState(), tm, n)
        self.je, self.te = JEngine(self.j), Engine(self.t, device="cpu")
        self.je.sched_warm_enabled = self.te.sched_warm_enabled = warm

    def both(self, fn):
        fn(self.j, jm)
        fn(self.t, tm)

    def schedule(self, now, exclude=None, **pod_kw):
        jh, js, _, ja = self.je.schedule(_pods(jm, **pod_kw), now=now, exclude=exclude)
        th, ts, _, ta = self.te.schedule(_pods(tm, **pod_kw), now=now, exclude=exclude)
        assert_same(th, jh, "hosts")
        assert_same(ts, js, "scores")
        assert ta == ja
        assert self.counters() == (
            self.je.sched_warm_hits, self.je.sched_cold_inits, self.je.sched_begin_hits
        )
        assert (th >= 0).any()
        return th, ts, ta

    def counters(self):
        return (self.te.sched_warm_hits, self.te.sched_cold_inits, self.te.sched_begin_hits)


def _churn(st, m, names, t):
    for i, name in enumerate(names):
        st.update_metric(name, m.NodeMetric(
            node_usage={CPU: 7000 + 997 * i, MEMORY: (6 + i) * GB},
            update_time=t, report_interval=60.0,
        ))


@pytest.fixture
def refreshes(monkeypatch):
    """Every ``schedule_refresh`` call of the port's engine, with its
    padded dirty index."""
    calls = []
    orig = tengine.schedule_refresh

    def counting(carry, dirty, *args):
        calls.append(np.asarray(dirty).copy())
        return orig(carry, dirty, *args)

    monkeypatch.setattr(tengine, "schedule_refresh", counting)
    return calls


def _jax_refreshes():
    return PROFILER.snapshot()["kernels"].get("sched_refresh", {}).get("dispatches", 0)


def test_unchanged_re_schedule_refreshes_nothing(refreshes):
    p = Pair()
    first = p.schedule(NOW + 1)
    assert p.counters() == (0, 1, 0) and p.te._sched_carry is not None
    j0 = _jax_refreshes()
    again = p.schedule(NOW + 2)
    assert p.counters() == (1, 1, 1)
    assert refreshes == [] and _jax_refreshes() == j0
    for a, b in zip(first[:2], again[:2]):
        assert_same(a, b)
    assert first[2] == again[2]


def test_warm_disabled_is_pure_optimisation():
    on, off = Pair(), Pair(warm=False)
    for now in (NOW + 1, NOW + 2, NOW + 3):
        a, b = on.schedule(now), off.schedule(now)
        assert_same(a[0], b[0])
        assert_same(a[1], b[1])
    assert on.counters()[:2] == (2, 1)
    assert off.counters()[:2] == (0, 3)


def test_churn_refreshes_by_delta_and_equals_cold_twin(refreshes):
    p = Pair()
    p.schedule(NOW + 1)
    p.both(lambda st, m: _churn(st, m, ["w-n3", "w-n11"], NOW + 2))
    h, s, a = p.schedule(NOW + 3)
    assert p.counters()[:2] == (1, 1)
    assert len(refreshes) == 1 and set(refreshes[0].tolist()) == {
        p.t._imap.get("w-n3"), p.t._imap.get("w-n11")}
    assert refreshes[0].size == 16  # padded by repeating a real row
    twin = Pair()
    twin.both(lambda st, m: _churn(st, m, ["w-n3", "w-n11"], NOW + 2))
    th, ts, ta = twin.schedule(NOW + 3)
    assert twin.counters()[:2] == (0, 1)
    assert_same(h, th)
    assert_same(s, ts)
    assert a == ta


def test_gate_flip_re_dirties_exactly_the_flipped_rows(refreshes):
    p = Pair()
    exp = p.t.la_args.node_metric_expiration_seconds
    assert exp and exp > 0
    flip = ["w-n5", "w-n9"]  # fresh at NOW + 1, expired at NOW + 3
    p.both(lambda st, m: [st.update_metric(n, m.NodeMetric(
        node_usage={CPU: 5000, MEMORY: 5 * GB}, update_time=NOW + 2 - exp,
        report_interval=60.0)) for n in flip])
    p.schedule(NOW + 1)
    vers = p.t.sched_versions()
    h, s, _ = p.schedule(NOW + 3)
    assert p.t.sched_versions() == vers, "the flip must not ride a stamp move"
    assert p.counters()[:2] == (1, 1)
    assert len(refreshes) == 1
    assert set(refreshes[0].tolist()) == {p.t._imap.get(n) for n in flip}
    twin = Pair()
    twin.both(lambda st, m: [st.update_metric(n, m.NodeMetric(
        node_usage={CPU: 5000, MEMORY: 5 * GB}, update_time=NOW + 2 - exp,
        report_interval=60.0)) for n in flip])
    th, ts, _ = twin.schedule(NOW + 3)
    assert_same(h, th)
    assert_same(s, ts)


def test_mostly_dirty_carry_falls_back_cold(refreshes):
    """Past 25% of the 256-column capacity (64 rows) the cold build wins."""
    p = Pair(n=100)
    p.schedule(NOW + 1)
    p.both(lambda st, m: _churn(st, m, [f"w-n{i}" for i in range(80)], NOW + 2))
    h, s, _ = p.schedule(NOW + 3)
    assert p.counters()[:2] == (0, 2) and refreshes == []
    twin = Pair(n=100)
    twin.both(lambda st, m: _churn(st, m, [f"w-n{i}" for i in range(80)], NOW + 2))
    th, ts, _ = twin.schedule(NOW + 3)
    assert_same(h, th)
    assert_same(s, ts)


def test_capacity_growth_fences_cold():
    p = Pair(n=200)
    p.schedule(NOW + 1)
    assert p.t.capacity == 256
    fence = p.t.warm_fence
    p.both(lambda st, m: _fill(st, m, 100, prefix="grow-"))
    assert p.t.capacity == 512 and p.t.warm_fence == fence + 1
    p.schedule(NOW + 2)
    assert p.counters()[:2] == (0, 2)
    p.schedule(NOW + 3)
    assert p.counters()[:2] == (1, 2)


def test_node_add_or_removal_falls_back_cold():
    """A change of the name->row map (``IndexMap.mutations``) voids the
    carry, as in the JAX package, even within one capacity bucket."""
    p = Pair()
    p.schedule(NOW + 1)
    p.both(lambda st, m: st.remove_node("w-n4"))
    p.schedule(NOW + 2)
    assert p.counters()[:2] == (0, 2)
    p.both(lambda st, m: _fill(st, m, 1, prefix="again-"))
    p.schedule(NOW + 3)
    p.schedule(NOW + 4)
    assert p.counters()[:2] == (1, 3)


def test_new_store_changed_batch_or_exclude_never_reuse_a_carry():
    p = Pair()
    p.schedule(NOW + 1)
    p.schedule(NOW + 2, bump=100)  # a different batch
    assert p.counters()[:2] == (0, 2)
    p.schedule(NOW + 3, exclude=["w-n0"])  # the exclusions live in the init
    assert p.counters()[:2] == (0, 3)
    p.schedule(NOW + 4, exclude=["w-n0"])
    assert p.counters()[:2] == (1, 3)
    # a twin store with the same content but its own identity
    other = _fill(ClusterState(), tm, 24)
    assert other.sched_store_token != p.t.sched_store_token
    p.te.state = other
    th, ts, _, _ = p.te.schedule(_pods(tm), now=NOW + 5, exclude=["w-n0"])
    assert p.counters()[:2] == (1, 4)
    jh, js, _, _ = JEngine(_fill(JState(), jm, 24)).schedule(_pods(jm), now=NOW + 5,
                                                            exclude=["w-n0"])
    assert_same(th, jh)
    assert_same(ts, js)


def test_commit_cap_above_p_and_padded_dirty_sets(refreshes):
    """5 pods under the commit cap of 16, and 3 dirty rows padded to 16 by
    repeating the first: duplicate writes must carry identical values."""
    p = Pair()
    p.schedule(NOW + 1, n=5)
    p.both(lambda st, m: _churn(st, m, ["w-n2", "w-n7", "w-n19"], NOW + 2))
    h, s, _ = p.schedule(NOW + 3, n=5)
    assert p.counters()[:2] == (1, 1)
    (idx,) = refreshes
    assert idx.size == 16 and (idx[3:] == idx[0]).all()
    twin = Pair()
    twin.both(lambda st, m: _churn(st, m, ["w-n2", "w-n7", "w-n19"], NOW + 2))
    th, ts, _ = twin.schedule(NOW + 3, n=5)
    assert_same(h, th)
    assert_same(s, ts)


def _perturb(b, rows):
    """The numpy batch with ``rows`` of the node arrays changed as churn
    would change them: more load, more requested, the filter switched."""
    la, la_n, w, nf, nf_n, st = b
    la_n = la_n._replace(base_nonprod=la_n.base_nonprod.copy(),
                         filter_active=la_n.filter_active.copy())
    nf_n = nf_n._replace(requested=nf_n.requested.copy(), num_pods=nf_n.num_pods.copy())
    la_n.base_nonprod[rows] += la_n.alloc[rows] // 8
    la_n.filter_active[rows] = ~la_n.filter_active[rows]
    nf_n.requested[rows] += nf_n.alloc[rows] // 8
    nf_n.num_pods[rows] += 1
    return la, la_n, w, nf, nf_n, st


@pytest.mark.parametrize("P,N,seed,cap,dirty", [
    (50, 300, 1, 16, [4, 77, 180]),
    (16, 256, 2, 100, [0, 15, 16, 255, 128]),
])
def test_resolved_refresh_and_warm_init_match_jax(P, N, seed, cap, dirty):
    b0 = batch(P, N, seed)
    rng = np.random.default_rng(seed)
    extra = rng.random((P, N)) < 0.9
    order = rng.permutation(P).astype(np.int32)
    idx = np.full(16, dirty[0], dtype=np.int32)
    idx[: len(dirty)] = dirty
    b1 = _perturb(b0, np.asarray(dirty))
    jcold = jax.jit(lambda a, e, o: jres.schedule_batch_resolved(
        *a, extra_feasible=e, order=o, impl="matrix_packed", commit_cap=cap, return_warm=True))
    _, _, jwarm0 = jcold(to_jax(b0), extra, order)
    th0 = tres.schedule_batch_resolved(*to_torch(b0), extra_feasible=torch.from_numpy(extra),
                                       order=torch.from_numpy(order), commit_cap=cap,
                                       return_warm=True)
    twarm0 = th0[2]
    for g, w in zip(twarm0, jwarm0):
        assert_same(g, w, "cold carry")

    jref = jax.jit(lambda a, e, o, wi, d: jres.schedule_batch_resolved(
        *a, extra_feasible=e, order=o, impl="matrix_packed", commit_cap=cap, warm_init=wi,
        dirty_cols=d, refresh_only=True))(to_jax(b1), extra, order, jwarm0, idx)
    kept = tuple(a.clone() for a in twarm0)
    tref = tres.schedule_batch_resolved(
        *to_torch(b1), extra_feasible=torch.from_numpy(extra), order=torch.from_numpy(order),
        commit_cap=cap, warm_init=twarm0, dirty_cols=torch.from_numpy(idx), refresh_only=True)
    for g, w in zip(tref, jref):
        assert_same(g, w, "refreshed carry")
    for g, w in zip(twarm0, kept):
        assert_same(g, w, "the caller's carry is not written")
    # the refreshed carry is the cold init of the changed inputs
    _, _, jwarm1 = jcold(to_jax(b1), extra, order)
    for g, w in zip(tref, jwarm1):
        assert_same(g, w, "refreshed carry vs the cold init")

    jh, js = jax.jit(lambda a, e, o, wi: jres.schedule_batch_resolved(
        *a, extra_feasible=e, order=o, impl="matrix_packed", commit_cap=cap,
        warm_init=wi))(to_jax(b1), extra, order, jref)
    th, ts = tres.schedule_batch_resolved(
        *to_torch(b1), extra_feasible=torch.from_numpy(extra), order=torch.from_numpy(order),
        commit_cap=cap, warm_init=tref)
    assert_same(th, jh, "warm hosts")
    assert_same(ts, js, "warm scores")
    ch, cs = tres.schedule_batch_resolved(
        *to_torch(b1), extra_feasible=torch.from_numpy(extra), order=torch.from_numpy(order),
        commit_cap=cap)
    assert_same(th, ch, "warm vs cold hosts")
    assert_same(ts, cs, "warm vs cold scores")


def test_warm_flags_refused_off_the_matrix_engine():
    t = to_torch(batch(8, 16, 0, "MostAllocated"))
    with pytest.raises(ValueError, match="LeastAllocated"):
        tres.schedule_batch_resolved(*t, return_warm=True)
    with pytest.raises(ValueError, match="refresh_only requires"):
        tres.schedule_batch_resolved(*to_torch(batch(8, 16, 0)), refresh_only=True)
