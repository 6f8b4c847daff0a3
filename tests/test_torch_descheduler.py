"""The descheduler's port against the JAX package and the Go-semantics
oracles: the LowNodeLoad functions (``core/lownodeload.py``), the fused
round's plain version (``core/deschedule.py``), the band order, and the
``Descheduler`` on a port store beside the JAX one fed the same ops.

Inputs are made from seeds with numpy and handed to both packages; the
port's side runs on the CPU, where each kernel's wrapper takes its plain
version.  Every comparison is exact (tolerance 0): integers and booleans
equal, float64 percentiles and deviation means bit for bit.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.model import CPU, MEMORY, Node, NodeMetric, Pod
from koordinator_tpu.core import deschedule as jd
from koordinator_tpu.core import lownodeload as jl
from koordinator_tpu.core.evictor import build_evict_arrays, pod_sort_order
from koordinator_tpu.golden import lownodeload_ref as ref
from koordinator_tpu.service import descheduler as jdesched
from koordinator_tpu.service import protocol as jp
from koordinator_tpu.service.engine import Engine as JEngine
from koordinator_tpu.service.state import ClusterState as JState
from koordinator_tpu.service.wireops import apply_wire_ops as japply
from koordinator_tpu_torch.core import deschedule as td
from koordinator_tpu_torch.core import lownodeload as tl
from koordinator_tpu_torch.golden import lownodeload_ref as tref
from koordinator_tpu_torch.service import descheduler as tdesched
from koordinator_tpu_torch.service.engine import Engine as TEngine
from koordinator_tpu_torch.service.state import ClusterState as TState
from koordinator_tpu_torch.service.wireops import apply_wire_ops as tapply

GB = 1 << 30
LOW, HIGH = np.array([30.0, 40.0]), np.array([65.0, 80.0])


def _cluster(rng, N, Pc, R=2, heat=1.1, padded_to=None):
    """(nodes, pods) as numpy NamedTuple fields; candidates beyond ``Pc``
    up to ``padded_to`` are padding rows (node 0, no usage, not
    removable)."""
    alloc = (rng.integers(4, 65, (N, R)) * 1000).astype(np.int64)
    usage = (alloc * rng.uniform(0.05, heat, (N, R))).astype(np.int64)
    nodes = (usage, alloc, rng.random(N) < 0.1, rng.random(N) < 0.9)
    P = padded_to or Pc
    node = np.zeros(P, dtype=np.int32)
    pusage = np.zeros((P, R), dtype=np.int64)
    rm = np.zeros(P, dtype=bool)
    node[:Pc] = rng.integers(0, N, Pc)
    pusage[:Pc] = rng.integers(0, 3000, (Pc, R))
    rm[:Pc] = rng.random(Pc) < 0.7
    return nodes, (node, pusage, rm)


def _j(nodes, pods):
    return jl.LNLNodeArrays(*nodes), jl.LNLPodArrays(*pods)


def _t(nodes, pods):
    return (tl.as_tensors(tl.LNLNodeArrays(*nodes)), tl.as_tensors(tl.LNLPodArrays(*pods)))


def _rows(state):
    return [(int(a), int(b), int(c)) for a, b, c in
            zip(np.asarray(state.anomaly), np.asarray(state.ab), np.asarray(state.norm))]


@pytest.mark.parametrize("seed,deviation,number_of_nodes", [
    (0, False, 0), (1, False, 0), (2, False, 0), (3, False, 0), (4, False, 0),
    (5, True, 0), (6, True, 0), (7, True, 0), (8, True, 0),
    (20, False, 39), (21, False, 39), (22, False, 39),
])
def test_balance_round_rounds_match_jax_and_golden(seed, deviation, number_of_nodes):
    """tests/test_lownodeload.py's rounds: four rounds carrying the detector
    state over drifting usage, static and deviation thresholds and the
    number_of_nodes gate; every output equal to the JAX function's and to
    the golden replay's."""
    rng = np.random.default_rng(seed)
    w = np.array([1, 1], dtype=np.int64)
    N = 40
    js, ts = jl.new_anomaly_state(N), tl.new_anomaly_state(N)
    golden = _rows(ts)
    for r in range(4):
        nodes, pods = _cluster(rng, N, 120)
        kw = dict(use_deviation=deviation, consecutive_abnormalities=2,
                  number_of_nodes=number_of_nodes)
        js, j_ev, j_u, j_o, j_s = jl.balance_round(js, *_j(nodes, pods), LOW, HIGH, w, **kw)
        ts, t_ev, t_u, t_o, t_s = tl.balance_round(ts, *_t(nodes, pods), LOW, HIGH, w, **kw)
        pod_dicts = [{"node": int(pods[0][k]), "usage": pods[1][k].tolist(),
                      "removable": bool(pods[2][k])} for k in range(len(pods[0]))]
        g_ev, golden, g_u, g_o, g_s = tref.replay_round(
            nodes[0].tolist(), nodes[1].tolist(), nodes[3].tolist(), nodes[2].tolist(), golden,
            pod_dicts, LOW.tolist(), HIGH.tolist(), w.tolist(), use_deviation=deviation,
            consecutive_abnormalities=2, number_of_nodes=number_of_nodes)
        ctx = (seed, r)
        for t, j, g in ((t_ev, j_ev, g_ev), (t_u, j_u, g_u), (t_o, j_o, g_o), (t_s, j_s, g_s)):
            assert t.tolist() == np.asarray(j).tolist() == g, ctx
        assert _rows(ts) == _rows(js) == golden, ctx


def test_no_debounce_passes_the_state_through():
    rng = np.random.default_rng(42)
    nodes, pods = _cluster(rng, 40, 120)
    st = tl.AnomalyState(torch.zeros(40, dtype=torch.bool), torch.full((40,), 3),
                         torch.ones(40, dtype=torch.int64))
    w = np.array([1, 1], dtype=np.int64)
    out, _, _, over, source = tl.balance_round(st, *_t(nodes, pods), LOW, HIGH, w,
                                               consecutive_abnormalities=1)
    assert torch.equal(source, over) and _rows(out) == _rows(st)


def test_detector_lifecycle_matches_jax():
    """tests/test_lownodeload.py's Mark/Reset walk on both packages."""
    js, ts = jl.new_anomaly_state(1), tl.new_anomaly_state(1)
    over = np.array([True])
    for _ in range(4):
        js, j_src = jl.mark_abnormal(js, over, 2)
        ts, t_src = tl.mark_abnormal(ts, torch.tensor(over), 2)
        assert _rows(ts) == _rows(js) and bool(t_src[0]) == bool(j_src[0])
    for _ in range(3):
        js = jl.mark_normal(js, over, 2)
        ts = tl.mark_normal(ts, torch.tensor(over), 2)
        assert _rows(ts) == _rows(js)
    for anomaly in (True, False):
        js = jl.AnomalyState(np.array([anomaly]), np.array([2]), np.array([1]))
        ts = tl.AnomalyState(torch.tensor([anomaly]), torch.tensor([2]), torch.tensor([1]))
        assert _rows(tl.reset_ok(ts, torch.tensor(over))) == _rows(jl.reset_ok(js, over))


def _select_case(seed: int) -> int:
    """usage_score against JAX and the golden scorer, then select_evictions
    against JAX; returns the evictions."""
    rng = np.random.default_rng(seed)
    nodes, pods = _cluster(rng, 60, 64)
    w = np.array([1, 3], dtype=np.int64)
    tn, tp = _t(nodes, pods)
    jn, jpods = _j(nodes, pods)
    got = tl.usage_score(tn.usage, tn.alloc, w)
    assert got.tolist() == np.asarray(jl.usage_score(jn.usage, jn.alloc, w)).tolist()
    assert got.tolist() == [tref.usage_score(u, a, w.tolist())
                            for u, a in zip(nodes[0].tolist(), nodes[1].tolist())]
    low_q, high_q = tl.node_thresholds(tn, LOW, HIGH)
    under, over = tl.classify(tn, low_q, high_q)
    source = over & (torch.arange(60) % 3 != 0)
    t_ev, t_reset = tl.select_evictions(tn, tp, low_q, high_q, source, under, w)
    j_ev, j_reset = jl.select_evictions(jn, jpods, np.asarray(low_q), np.asarray(high_q),
                                        source.numpy(), under.numpy(), w)
    assert t_ev.tolist() == np.asarray(j_ev).tolist()
    assert t_reset.tolist() == np.asarray(j_reset).tolist()
    return int(t_ev.sum())


@pytest.mark.parametrize("seed", range(6))
def test_usage_score_and_select_evictions_match_jax_and_golden(seed):
    _select_case(seed)


def test_select_evictions_cases_evict():
    """The cases above are not vacuous."""
    assert sum(_select_case(s) for s in range(6))


@pytest.mark.parametrize("seed", range(20))
def test_deviation_mean_is_the_golden_sum(seed):
    """The deviation mean is summed in node order: bit-equal to the Go
    oracle's; the integer thresholds equal the JAX package's (whose own sum
    order is XLA's)."""
    rng = np.random.default_rng(seed)
    N = int(rng.integers(8, 300))
    nodes, _ = _cluster(rng, N, 1)
    tn = tl.as_tensors(tl.LNLNodeArrays(*nodes))
    mean = tl.mean_usage_pct(tn)
    want = ref.calc_average_usage_pct(nodes[0].tolist(), nodes[1].tolist(), nodes[3].tolist())
    assert np.array_equal(mean.numpy().view(np.int64), np.array(want).view(np.int64))
    t_lo, t_hi = tl.node_thresholds(tn, LOW, HIGH, use_deviation=True)
    j_lo, j_hi = jl.node_thresholds(jl.LNLNodeArrays(*nodes), LOW, HIGH, use_deviation=True)
    g_lo, g_hi = ref.thresholds(nodes[0].tolist(), nodes[1].tolist(), nodes[3].tolist(),
                                LOW.tolist(), HIGH.tolist(), True)
    assert t_lo.tolist() == np.asarray(j_lo).tolist() == g_lo
    assert t_hi.tolist() == np.asarray(j_hi).tolist() == g_hi


def _same_round(t, j) -> None:
    for name in ("evicted", "rank", "under", "over", "source"):
        assert getattr(t, name).tolist() == np.asarray(getattr(j, name)).tolist(), name
    assert _rows(t.state) == _rows(j.state)
    tu, ju = t.util_pct.numpy(), np.asarray(j.util_pct)
    assert np.array_equal(np.isnan(tu), np.isnan(ju))
    assert np.array_equal(tu[~np.isnan(tu)].view(np.int64), ju[~np.isnan(ju)].view(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("deviation", [False, True])
def test_deschedule_round_plain_matches_the_jax_jit(seed, deviation):
    """tests/test_deschedule_kernel.py's fused-round cases: two rounds
    carrying the state, every output (percentiles bit for bit)."""
    rng = np.random.default_rng(seed)
    n, pc = int(rng.integers(4, 24)), int(rng.integers(1, 64))
    alloc = rng.integers(1000, 16000, size=(n, 2)).astype(np.int64)
    usage = (alloc * rng.uniform(0.0, 1.2, size=(n, 2))).astype(np.int64)
    nodes = (usage, alloc, rng.random(n) < 0.1, rng.random(n) < 0.9)
    pods = (rng.integers(0, n, size=pc).astype(np.int32),
            rng.integers(0, 4000, size=(pc, 2)).astype(np.int64), rng.random(pc) < 0.8)
    w = np.array([1, 1], dtype=np.int64)
    kw = dict(use_deviation=deviation, consecutive_abnormalities=2, consecutive_normalities=2)
    js, ts = jl.new_anomaly_state(n), tl.new_anomaly_state(n)
    for _ in range(2):
        j = jd.deschedule_round(js, *_j(nodes, pods), LOW, HIGH, w, **kw)
        t = td.deschedule_round(ts, *_t(nodes, pods), LOW, HIGH, w, **kw)
        _same_round(t, j)
        js, ts = j.state, t.state


@pytest.mark.parametrize("seed,caps,cons", [
    (10, (-1, -1), 1), (11, (1, -1), 2), (12, (2, 3), 2), (13, (-1, 2), 1), (14, (0, -1), 3),
])
def test_deschedule_round_caps_and_padding_match_jax(seed, caps, cons):
    """Caps in the kernel and a candidate bucket with padding rows (inert
    in every output), at 300 nodes and 50 candidates in a bucket of 64."""
    rng = np.random.default_rng(seed)
    nodes, pods = _cluster(rng, 300, 50, heat=1.2, padded_to=64)
    w = np.array([1, 2], dtype=np.int64)
    kw = dict(per_node_cap=caps[0], total_cap=caps[1], consecutive_abnormalities=cons,
              consecutive_normalities=1)
    js, ts = jl.new_anomaly_state(300), tl.new_anomaly_state(300)
    evictions = 0
    for _ in range(3):
        j = jd.deschedule_round(js, *_j(nodes, pods), LOW, HIGH, w, **kw)
        t = td.deschedule_round(ts, *_t(nodes, pods), LOW, HIGH, w, **kw)
        _same_round(t, j)
        assert not t.evicted[50:].any()
        evictions += int(t.evicted.sum())
        js, ts = j.state, t.state
    assert evictions or caps[0] == 0


@pytest.mark.parametrize("seed", range(6))
def test_round_pieces_match_jax(seed):
    """eviction_rank, budget_cut and util_percentiles (bitwise, NaN where
    no node counts) against the JAX functions."""
    rng = np.random.default_rng(seed + 30)
    nodes, pods = _cluster(rng, 30, 40)
    w = np.array([1, 2], dtype=np.int64)
    assert td.eviction_rank(*_t(nodes, pods), w).tolist() == np.asarray(
        jd.eviction_rank(*_j(nodes, pods), w)).tolist()
    evicted = rng.random(40) < 0.5
    rank = rng.permutation(40).astype(np.int64)
    node = rng.integers(0, 6, 40).astype(np.int32)
    for caps in ((-1, -1), (1, -1), (2, 3), (-1, 2), (0, -1)):
        got = td.budget_cut(torch.tensor(evicted), torch.tensor(rank), torch.tensor(node), *caps)
        assert got.tolist() == np.asarray(jd.budget_cut(evicted, rank, node, *caps)).tolist()
    for valid in (nodes[3], np.zeros(30, dtype=bool)):
        n2 = (nodes[0], nodes[1], nodes[2], valid)
        t = td.util_percentiles(tl.as_tensors(tl.LNLNodeArrays(*n2))).numpy()
        j = np.asarray(jd.util_percentiles(jl.LNLNodeArrays(*n2)))
        assert np.array_equal(np.isnan(t), np.isnan(j))
        assert np.array_equal(t[~np.isnan(t)].view(np.int64), j[~np.isnan(j)].view(np.int64))


def test_deschedule_round_refuses_mixed_devices_and_dtypes():
    """The round's wrapper checks every input's dtype, shape and device
    before it picks the plain version or the kernel."""
    rng = np.random.default_rng(1)
    tn, tp = _t(*_cluster(rng, 8, 8))
    meta = tl.LNLNodeArrays(*(a.to("meta") for a in tn))
    with pytest.raises(ValueError, match="on meta"):
        td.deschedule_round(tl.new_anomaly_state(8), meta, tp, LOW, HIGH, np.array([1, 1]))
    with pytest.raises(ValueError, match=r"alloc: expected torch.int64 \(8, 2\)"):
        td.deschedule_round(tl.new_anomaly_state(8), tn._replace(alloc=tn.alloc[:, :1].repeat(
            1, 3)), tp, LOW, HIGH, np.array([1, 1]))
    with pytest.raises(ValueError, match="expected torch.int32"):
        td.deschedule_round(tl.new_anomaly_state(8), tn, tp._replace(node=tp.node.long()), LOW,
                            HIGH, np.array([1, 1]))


def _band_pods(rng, n, cls=Pod):
    return [cls(name=f"b-{i}", requests={"cpu": int(rng.integers(0, 2000))},
                limits=({"cpu": 2000, "memory": 1 << 30} if rng.random() < 0.3 else {}),
                priority=int(rng.choice([0, 1000, 9000, 9500])),
                priority_class_label=str(rng.choice(["koord-prod", "koord-batch", "koord-free",
                                                     ""])) or None,
                qos=str(rng.choice(["LS", "BE", "LSR", ""])) or None,
                deletion_cost=int(rng.integers(-5, 5)), eviction_cost=int(rng.integers(-5, 5)),
                create_time=float(rng.choice([0.0, -0.0, 1.0, 2.5, -3.0, np.nan])),
                owner_uid=f"o{i % 5}") for i in range(n)]


@pytest.mark.parametrize("seed", range(8))
def test_pod_band_rank_matches_jax_and_pod_sort_order(seed):
    """Ties on every key, -0.0 beside 0.0 and NaN create times, with and
    without the usage key."""
    rng = np.random.default_rng(seed)
    from koordinator_tpu_torch.core.evictor import build_evict_arrays as t_build
    from koordinator_tpu_torch.core.evictor import pod_sort_order as t_order

    from koordinator_tpu_torch.api.model import Pod as TPod

    n = int(rng.integers(2, 65))
    arrays = build_evict_arrays(_band_pods(np.random.default_rng([seed, 1]), n))
    t_arrays = t_build(_band_pods(np.random.default_rng([seed, 1]), n, TPod))
    usage = rng.integers(-3, 4, size=len(arrays.pods)).astype(np.int64)
    for u in (None, usage):
        got = td.pod_band_rank(td.band_keys(t_arrays, u)).tolist()
        assert got == np.asarray(jd.pod_band_rank(arrays, usage_score=u)).tolist()
        assert got == pod_sort_order(arrays, usage_score=u).tolist()
        assert got == t_order(t_arrays, usage_score=u).tolist()


def _band_case(case, P):
    """PodSorter key columns of P pods (koord priority rank, priority, k8s
    QoS, koord QoS, deletion cost, eviction cost, create time, usage) for
    one edge case of the kernel's plan, made with numpy."""
    rng = np.random.default_rng([P, len(case)])
    small = lambda: rng.integers(-3, 4, P)  # noqa: E731
    cols = [small() % 3, small() * 100, small() % 3, small() % 4, small(), small(),
            rng.choice([0.0, 1.5, -2.0], P), rng.integers(0, 50, P)]
    if case == "every key constant":
        cols = [np.full(P, v) for v in (1, 7, 2, 3, 0, 5, 2.5, 9)]
    elif case == "keys that do not fit one word":
        cols[1] = rng.choice([-(1 << 63), (1 << 63) - 1, 0], P)
        cols[5] = rng.integers(-(1 << 62), 1 << 62, P)
        cols[6] = rng.standard_normal(P) * 1e300
    elif case == "-(1 << 63) negated":
        cols[7] = rng.choice([-(1 << 63), 0, 3, (1 << 63) - 1], P)
    elif case == "-0.0 and NaN create times":
        cols[6] = rng.choice([0.0, -0.0, float("nan"), -1.0], P)
    dtypes = (np.int8, np.int64, np.int8, np.int8, np.int64, np.int64, np.float64, np.int64)
    return [np.asarray(c).astype(d) for c, d in zip(cols, dtypes)]


@pytest.mark.parametrize("case", ["every key constant", "keys in one composite word",
                                  "keys that do not fit one word", "-(1 << 63) negated",
                                  "-0.0 and NaN create times", "one pod"])
@pytest.mark.parametrize("usage", [False, True])
def test_pod_band_rank_plain_edge_cases_match_jax(case, usage):
    """``pod_band_rank_plain`` against the JAX ``_band_rank``
    (koordinator_tpu/core/deschedule.py:223) on the cases csrc/bandrank.cu
    plans apart: constant keys (no pass), spreads that pack into one 64-bit
    word, int64 extremes that take a word each, the wrapping negation of
    -(1 << 63), -0.0 tying 0.0 with NaN last, and one pod."""
    P = 1 if case == "one pod" else 64
    cols = _band_case(case, P)
    want = jd._band_rank(*(jnp.asarray(c.astype(np.int64) if c.dtype == np.int8 else c)
                           for c in cols), has_usage=usage)
    keys = td.BandKeys(*(torch.from_numpy(c) for c in cols[:7]),
                       torch.from_numpy(cols[7]) if usage else None)
    assert td.pod_band_rank_plain(keys).tolist() == np.asarray(want).tolist()
    assert td.pod_band_rank(keys).tolist() == np.asarray(want).tolist()


# ------------------------------------------------------------ the system


def _store_ops(num_nodes: int = 12, seed: int = 3) -> list:
    """Wire ops of a small cluster: nodes with metrics, two ReplicaSets of
    owned pods heavy on the first nodes, a bare pod, a pod without metric
    usage."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(num_nodes):
        node = Node(name=f"dn-{i}", allocatable={CPU: 10000, MEMORY: 40 * GB, "pods": 64})
        ops.append({"op": "upsert", "node": jp.node_spec_to_wire(node)})
    pods_on = {}
    for i in range(num_nodes):
        k = 6 if i < 3 else int(rng.integers(0, 2))
        for j in range(k):
            p = Pod(name=f"dp-{i}-{j}", requests={CPU: 1200, MEMORY: 2 * GB},
                    owner_uid=f"rs-{(i + j) % 2}", owner_kind="ReplicaSet")
            pods_on.setdefault(i, []).append(p)
            ops.append({"op": "assign", "node": f"dn-{i}", "pod": jp.pod_to_wire(p), "t": 1.0})
    bare = Pod(name="bare", requests={CPU: 500, MEMORY: GB})
    ops.append({"op": "assign", "node": "dn-0", "pod": jp.pod_to_wire(bare), "t": 1.0})
    for i in range(num_nodes):
        pods = pods_on.get(i, [])
        usage = {CPU: 300 + sum(p.requests[CPU] for p in pods),
                 MEMORY: GB + sum(p.requests[MEMORY] for p in pods)}
        m = NodeMetric(node_usage=usage, update_time=10.0, report_interval=60.0)
        m.pods_usage.update({p.key: dict(p.requests) for p in pods[1:]})
        ops.append({"op": "metric", "node": f"dn-{i}", "m": jp.metric_to_wire(m)})
    return ops


def _stores():
    ops = _store_ops()
    js, ts = JState(initial_capacity=8), TState(initial_capacity=8)
    japply(js, copy.deepcopy(ops))
    tapply(ts, copy.deepcopy(ops))
    return js, ts


def _store_view(st) -> tuple:
    nodes = {n: sorted(ap.pod.key for ap in node.assigned_pods) for n, node in st._nodes.items()}
    rsv = {name: (r.node, dict(r.allocatable), r.allocate_once)
           for name, r in st.reservations._rsv.items()}
    return nodes, dict(st._pod_node), rsv, st.desched_anomaly


@pytest.mark.parametrize("cons,limits", [(1, {}), (2, {"total": 3}), (3, {"per_node": 1})])
def test_descheduler_ticks_and_execute_match_jax(cons, limits):
    """``Descheduler.tick`` (dry runs through the debounce, then an
    executing tick) and ``execute`` on a port store and a JAX store fed the
    same ops: plans, completed moves, percentiles, the jobs ledger, the
    anomaly counters and the stores after each tick."""
    js, ts = _stores()
    pool = dict(low_pct={CPU: 30.0, MEMORY: 90.0}, high_pct={CPU: 55.0, MEMORY: 95.0},
                consecutive_abnormalities=cons, consecutive_normalities=2)
    wl = {"rs-0": 16, "rs-1": 16}
    jdd = jdesched.Descheduler(js, JEngine(js), pools=[jdesched.PoolConfig(**pool)],
                               workloads=wl, limits=jdesched.EvictionLimits(**limits))
    tdd = tdesched.Descheduler(ts, TEngine(ts, device="cpu"),
                               pools=[tdesched.PoolConfig(**pool)], workloads=wl,
                               limits=tdesched.EvictionLimits(**limits))
    assert tdd.verify  # on by default on the CPU
    plans = 0
    for t in range(cons + 2):
        now = 20.0 + t
        dry = t < cons + 1
        jplan, tplan = jdd.tick(now, dry_run=dry), tdd.tick(now, dry_run=dry)
        assert tplan == jplan, t
        assert tdd.last_util == jdd.last_util
        plans += len(tplan)
        if not dry:
            assert tdd.execute(tplan, now) == jdd.execute(jplan, now)
            assert tdd.last_migrations == jdd.last_migrations
        assert tdd.jobs == jdd.jobs
        assert tdd.arbitrator.active == jdd.arbitrator.active
        assert _store_view(ts) == _store_view(js), t
    assert plans
    assert tdd.last_migrations or cons > 1  # the plain case moves pods
    assert ts.desched_anomaly == js.desched_anomaly


def test_descheduler_plugins_and_host_path_match_jax():
    """The violation plugins and profiles through the same pipeline, and
    ``use_kernel=False`` (no percentiles in the result)."""
    js, ts = _stores()
    tainted = Node(name="dn-4", allocatable={CPU: 10000, MEMORY: 40 * GB, "pods": 64},
                   taints=[{"key": "k", "value": "v", "effect": "NoExecute"}])
    op = {"op": "upsert", "node": jp.node_spec_to_wire(tainted)}
    japply(js, [copy.deepcopy(op)])
    tapply(ts, [copy.deepcopy(op)])
    wl = {"rs-0": 16, "rs-1": 16}
    jdd = jdesched.Descheduler(js, JEngine(js), workloads=wl, use_kernel=False,
                               pools=[jdesched.PoolConfig(consecutive_abnormalities=1)])
    tdd = tdesched.Descheduler(ts, TEngine(ts, device="cpu"), workloads=wl, use_kernel=False,
                               pools=[tdesched.PoolConfig(consecutive_abnormalities=1)])
    assert tdd.tick(30.0, dry_run=True) == jdd.tick(30.0, dry_run=True)
    assert tdd.last_util is None and jdd.last_util is None
    prof = [("PodLifeTime", {"max_pod_life_time_seconds": 1.0})]
    jdd.profiles = [jdesched.DeschedulerProfile(
        deschedule=tuple(jdesched.PLUGIN_FACTORIES[n](a) for n, a in prof))]
    tdd.profiles = [tdesched.DeschedulerProfile(
        deschedule=tuple(tdesched.PLUGIN_FACTORIES[n](a) for n, a in prof))]
    assert tdd.tick(31.0, dry_run=True) == jdd.tick(31.0, dry_run=True)
    assert sorted(tdesched.PLUGIN_FACTORIES) == sorted(jdesched.PLUGIN_FACTORIES)


def test_arbitrator_defaults_to_cuda():
    """Built without ``device``, the arbitrator wants the card and raises
    without one; on the CPU it is asked for, with ``verify`` on."""
    if torch.cuda.is_available():
        arb = tdesched.Arbitrator(TState())
        assert arb.device.type == "cuda" and not arb.verify
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdesched.Arbitrator(TState())
    arb = tdesched.Arbitrator(TState(), device="cpu")
    assert arb.device.type == "cpu" and arb.verify


def test_verify_catches_a_diverging_round(monkeypatch):
    """``verify`` re-runs the host pipeline and raises on a difference; it
    never replaces the round's result."""
    _, ts = _stores()
    d = tdesched.Descheduler(ts, TEngine(ts, device="cpu"), workloads={"rs-0": 16, "rs-1": 16},
                             pools=[tdesched.PoolConfig(consecutive_abnormalities=1,
                                                        low_pct={CPU: 30.0},
                                                        high_pct={CPU: 55.0})])
    real = tdesched.deschedule_round

    def wrong(*a, **kw):
        rnd = real(*a, **kw)
        return rnd._replace(evicted=~rnd.evicted)

    monkeypatch.setattr(tdesched, "deschedule_round", wrong)
    with pytest.raises(RuntimeError, match="diverged"):
        d.tick(30.0, dry_run=True)
    monkeypatch.undo()
    d.verify = False
    assert d.tick(30.0, dry_run=True) and "verify" not in d.last_split
    d.verify = True
    assert d.tick(30.0, dry_run=True) and "verify" in d.last_split
