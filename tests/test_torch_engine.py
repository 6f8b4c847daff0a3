"""The port's ClusterState and Engine against the JAX package's, after the
same store operations: node upserts past the initial capacity, metric
updates, pod binds, unbinds and node removals with index reuse, then SCORE
and several SCHEDULE cycles whose placements bind between cycles —
published arrays, totals, feasibility, hosts, scores and allocation
records equal bit for bit.  The JAX side runs with ``device_state=False``
(host-built node arrays), the port with its default resident tables: the
two paths serve the same answers.

Also: the slice's refusals (``NotImplementedError``), the CUDA default of
the entry points, and the port importing with JAX unavailable."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import koordinator_tpu.api.model as jm
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
SCALARS = (jm.BATCH_CPU, jm.BATCH_MEMORY)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Side:
    """One package's store, engine and fixture generator, fed identical ops."""

    def __init__(self, state, engine, fx, model):
        self.state, self.engine, self.fx, self.m = state, engine, fx, model


def _sides(initial_capacity=16):
    j = JState(extra_scalars=SCALARS, initial_capacity=initial_capacity, device_state=False)
    t = ClusterState(extra_scalars=SCALARS, initial_capacity=initial_capacity)
    return (_Side(j, JEngine(j), jfx, jm), _Side(t, Engine(t, device="cpu"), tfx, tm))


def _churn(side, seed, num_nodes):
    """Upserts, metric updates, binds, unbinds, a removal and a re-add."""
    _, nodes = side.fx.random_cluster(seed, num_nodes=num_nodes, num_pods=0)
    for n in nodes:
        side.state.upsert_node(n)
    rng = np.random.default_rng(seed + 1)
    for i in rng.choice(num_nodes, 5, replace=False):
        side.state.update_metric(
            f"node-{i}",
            side.m.NodeMetric(
                node_usage={jm.CPU: int(rng.integers(100, 4000)),
                            jm.MEMORY: int(rng.integers(1, 9)) << 30},
                update_time=NOW - 10.0,
            ),
        )
    bound = side.fx.random_cluster(seed + 2, num_nodes=0, num_pods=12)[0]
    for k, pod in enumerate(bound):
        side.state.assign_pod(f"node-{k % num_nodes}", side.m.AssignedPod(pod=pod, assign_time=NOW - 5))
    side.state.unassign_pod(bound[3].key)
    side.state.assign_pod(f"node-{num_nodes - 1}", side.m.AssignedPod(pod=bound[4], assign_time=NOW))
    side.state.remove_node("node-2")
    side.state.assign_pod("node-late", side.m.AssignedPod(pod=bound[5], assign_time=NOW))
    side.state.upsert_node(side.m.Node(name="node-late", allocatable={jm.CPU: 64000, jm.MEMORY: 256 << 30}))


@pytest.mark.parametrize("seed,num_nodes,num_pods", [(11, 40, 30), (12, 120, 64), (13, 300, 50)])
def test_engine_matches_jax_after_store_ops(seed, num_nodes, num_pods):
    sides = _sides()
    for s in sides:
        _churn(s, seed, num_nodes)
    js, ts = sides
    jsnap, tsnap = js.state.publish(NOW), ts.state.publish(NOW)
    for f in jsnap.la_nodes._fields:
        assert_same(getattr(tsnap.la_nodes, f), getattr(jsnap.la_nodes, f), f)
    for f in jsnap.nf_nodes._fields:
        assert_same(getattr(tsnap.nf_nodes, f), getattr(jsnap.nf_nodes, f), f)
    assert_same(tsnap.valid, jsnap.valid, "valid")
    assert tsnap.names == jsnap.names

    pods = [s.fx.random_cluster(seed + 3, num_nodes=0, num_pods=num_pods)[0] for s in sides]
    want, got = js.engine.score(pods[0], now=NOW), ts.engine.score(pods[1], now=NOW)
    assert_same(got[0], want[0], "totals")
    assert_same(got[1], want[1], "feasible")

    for cycle in range(3):
        batch = [
            [s.fx.random_pod(np.random.default_rng([seed, cycle, i]), f"c{cycle}-{i}", "pending")
             for i in range(num_pods)]
            for s in sides
        ]
        for i in range(0, num_pods, 7):  # priorities and creation times set the queue order
            for b in batch:
                b[i].priority, b[i].create_time = 9500, float(i % 3)
        excl = [f"node-{cycle}", "node-missing"]
        jh, jsc, jsnap, jal = js.engine.schedule(batch[0], now=NOW, exclude=excl)
        th, tsc, tsnap, tal = ts.engine.schedule(batch[1], now=NOW, exclude=excl)
        assert_same(th, jh, f"hosts cycle {cycle}")
        assert_same(tsc, jsc, f"scores cycle {cycle}")
        assert tal == jal
        assert (th >= 0).any()
        for s, b, snap, hosts in ((js, batch[0], jsnap, jh), (ts, batch[1], tsnap, th)):
            for pod, h in zip(b, hosts.tolist()):
                if h >= 0:
                    s.state.assign_pod(snap.names[h], s.m.AssignedPod(pod=pod, assign_time=NOW))


def test_engine_other_strategy_on_cpu_matches_jax():
    """MostAllocated routes both SCHEDULE engines to the scan; SCORE
    takes the strategy too (plain versions only: the kernels raise)."""
    from koordinator_tpu.core.config import NodeFitArgs as JArgs, ScoringStrategyType as JT
    from koordinator_tpu_torch.core.config import NodeFitArgs as TArgs, ScoringStrategyType as TT

    j = JState(nf_args=JArgs(strategy=JT.MOST_ALLOCATED), extra_scalars=SCALARS, device_state=False)
    t = ClusterState(nf_args=TArgs(strategy=TT.MOST_ALLOCATED), extra_scalars=SCALARS)
    for st, fx in ((j, jfx), (t, tfx)):
        for n in fx.random_cluster(21, num_nodes=60, num_pods=0)[1]:
            st.upsert_node(n)
    jp = jfx.random_cluster(22, num_nodes=0, num_pods=20)[0]
    tp = tfx.random_cluster(22, num_nodes=0, num_pods=20)[0]
    je, te = JEngine(j), Engine(t, device="cpu")
    assert_same(te.score(tp, now=NOW)[0], je.score(jp, now=NOW)[0])
    assert_same(te.schedule(tp, now=NOW)[0], je.schedule(jp, now=NOW)[0])


def _plain_state(side=None):
    """Eight random nodes; with ``side`` ("jax" or "torch") that package's
    store, the first two nodes carrying a GPU node's inventory and a zone
    label (the JAX side on host-built arrays)."""
    if side is None:
        st = ClusterState(extra_scalars=SCALARS)
        for n in tfx.random_cluster(3, num_nodes=8, num_pods=0)[1]:
            st.upsert_node(n)
        return st
    from torch_parity import pkg

    k = pkg(side)
    fx = jfx if side == "jax" else tfx
    st = (JState(extra_scalars=SCALARS, device_state=False) if side == "jax"
          else ClusterState(extra_scalars=SCALARS))
    for i, n in enumerate(fx.random_cluster(3, num_nodes=8, num_pods=0)[1]):
        if i < 2:
            n.labels = {"zone": "a"}
        st.upsert_node(n)
    st.set_devices("node-0", [k.GPUDevice(minor=m, numa_node=m // 2) for m in range(4)],
                   [k.RDMADevice(minor=0, vfs_free=2)])
    st.set_devices("node-1", [k.GPUDevice(minor=0, core_free=60, memory_ratio_free=60)])
    st.assign_pod("node-2", k.AssignedPod(pod=k.Pod(name="holder", labels={"app": "x"})))
    return st


@pytest.mark.parametrize(
    "field,value",
    [
        ("gang", "g1"),
        ("quota", "team-a"),
        ("reservations", ["r1"]),
        ("node_selector", {"zone": "a"}),
        ("anti_affinity", {"app": "x"}),
        ("requests", {"koordinator.sh/gpu-core": 50}),
        ("requests", {"koordinator.sh/rdma": 1}),
    ],
)
def test_out_of_slice_pods_raise(field, value):
    """Gang, quota and reservation pods are served under every strategy:
    under MostAllocated (the scan route) a batch the stores constrain gives
    the JAX engine's SCORE and SCHEDULE (with ``assume``), allocation
    records and the stores after it included.  Placement and device pods
    are served: SCORE and SCHEDULE (with ``assume``) equal the JAX
    engine's, allocation records and grants included."""
    from koordinator_tpu.api import quota as jq
    from koordinator_tpu.core.config import NodeFitArgs as JArgs, ScoringStrategyType as JT
    from koordinator_tpu.service import constraints as jc
    from koordinator_tpu_torch.core.config import NodeFitArgs, ScoringStrategyType

    pod = tm.Pod(name="p", requests={jm.CPU: 1000})
    setattr(pod, field, value)
    if field in ("gang", "quota", "reservations"):
        j = JState(nf_args=JArgs(strategy=JT.MOST_ALLOCATED), extra_scalars=SCALARS,
                   device_state=False)
        t = ClusterState(nf_args=NodeFitArgs(strategy=ScoringStrategyType.MOST_ALLOCATED),
                         extra_scalars=SCALARS)
        for st, fx, c, q in ((j, jfx, jc, jq), (t, tfx, tc, tq)):
            for n in fx.random_cluster(3, num_nodes=8, num_pods=0)[1]:
                st.upsert_node(n)
            st.gangs.upsert(c.GangInfo(name="g1", min_member=1, total_children=1))
            st.quota.upsert(q.QuotaGroup(name="team-a", min={jm.CPU: 100}, max={jm.CPU: 9000}))
            st.quota.set_total({jm.CPU: 64000, jm.MEMORY: 256 << 30})
            st.reservations.upsert(c.ReservationInfo(name="r1", node="node-1",
                                                     allocatable={jm.CPU: 2000}))
        jpod = jm.Pod(name="p", requests={jm.CPU: 1000})
        setattr(jpod, field, value)
        je, te = JEngine(j), Engine(t, device="cpu")
        for k in range(2):
            assert_same(te.score([pod], now=NOW + k)[0], je.score([jpod], now=NOW + k)[0])
            th, ts, _, ta = te.schedule([pod], now=NOW + k, assume=k == 1)
            jh, js, _, ja = je.schedule([jpod], now=NOW + k, assume=k == 1)
            assert_same(th, jh)
            assert_same(ts, js)
            assert ta == ja and th[0] >= 0
        assert te.last_rounds == 0 and te.last_ub_rounds == 0
        assert t._pod_node == j._pod_node
        assert t.quota.used_arrays(t.quota.snapshot())[0].tolist() == \
            j.quota.used_arrays(j.quota.snapshot())[0].tolist()
        assert t.reservations.get("r1").allocated == j.reservations.get("r1").allocated
        return
    jst, tst = _plain_state("jax"), _plain_state("torch")
    je, te = JEngine(jst), Engine(tst, device="cpu")
    jpod = jm.Pod(name="p", requests={jm.CPU: 1000})
    setattr(jpod, field, value)
    for k in range(2):
        assert_same(te.score([pod], now=NOW + k)[0], je.score([jpod], now=NOW + k)[0])
        assert_same(te.score([pod], now=NOW + k)[1], je.score([jpod], now=NOW + k)[1])
        th, ts, _, ta = te.schedule([pod], now=NOW + k, assume=k == 1)
        jh, js, _, ja = je.schedule([jpod], now=NOW + k, assume=k == 1)
        assert_same(th, jh)
        assert_same(ts, js)
        assert ta == ja
    assert th[0] >= 0 and tst._dev_alloc == jst._dev_alloc


def test_out_of_slice_store_and_modes_raise():
    """The store and modes of the earlier slices' refusals are all served
    now.  ``score_breakdown``/``explain`` (the explain slice) equal the JAX
    engine's.  Device scores under MostAllocated are served (the scan's
    extra-score branch): SCORE and SCHEDULE equal the JAX engine's.  The
    store ops of the placement-and-devices slice are served: taints,
    topologies, device inventories, anti-affinity holders and device
    grants, and a cpuset pod, with ``assume`` too."""
    from koordinator_tpu.core.config import NodeFitArgs as JArgs, ScoringStrategyType as JT
    from koordinator_tpu_torch.core.config import NodeFitArgs, ScoringStrategyType
    from torch_parity import pkg

    t_pkg, j_pkg = pkg("torch"), pkg("jax")
    st = _plain_state()
    assert st.residency.enabled  # device_state=True is the default
    gpu = tm.Pod(name="g", requests={jm.CPU: 1000, "koordinator.sh/gpu-core": 50})
    jgpu = jm.Pod(name="g", requests={jm.CPU: 1000, "koordinator.sh/gpu-core": 50})
    most = ClusterState(nf_args=NodeFitArgs(strategy=ScoringStrategyType.MOST_ALLOCATED),
                        extra_scalars=SCALARS)
    jmost = JState(nf_args=JArgs(strategy=JT.MOST_ALLOCATED), extra_scalars=SCALARS,
                   device_state=False)
    for s_, fx, k in ((most, tfx, t_pkg), (jmost, jfx, j_pkg)):
        for n in fx.random_cluster(3, num_nodes=8, num_pods=0)[1]:
            s_.upsert_node(n)
        s_.set_devices("node-0", [k.GPUDevice(minor=0)])
    eng_most, jeng_most = Engine(most, device="cpu"), JEngine(jmost)
    # SCORE and SCHEDULE add the device scores on any strategy
    assert_same(eng_most.score([gpu], now=NOW)[0], jeng_most.score([jgpu], now=NOW)[0])
    th, ts, _, ta = eng_most.schedule([gpu], now=NOW, assume=True)
    jh, js, _, ja = jeng_most.schedule([jgpu], now=NOW, assume=True)
    assert_same(th, jh)
    assert_same(ts, js)
    assert ta == ja and th[0] >= 0 and most._dev_alloc == jmost._dev_alloc
    eng = Engine(st, device="cpu")
    t_parts, j_parts = eng_most.score_breakdown([gpu], now=NOW)[0], jeng_most.score_breakdown(
        [jgpu], now=NOW)[0]
    assert sorted(t_parts) == sorted(j_parts) == ["extra", "loadaware", "nodefit"]
    for k in j_parts:
        assert_same(t_parts[k], j_parts[k])
    assert eng_most.explain([gpu], now=NOW) == jeng_most.explain([jgpu], now=NOW)
    st.upsert_node(tm.Node(name="t", allocatable={jm.CPU: 64000, jm.MEMORY: 64 << 30},
                           taints=[{"key": "k", "effect": "NoSchedule"}]))
    st.set_topology("node-0", t_pkg.NodeTopologyInfo(topo=t_pkg.CPUTopology(
        sockets=1, nodes_per_socket=2, cores_per_node=4, cpus_per_core=2)))
    st.set_devices("node-1", [t_pkg.GPUDevice(minor=0)])
    st.assign_pod("node-1", tm.AssignedPod(pod=tm.Pod(name="h", anti_affinity={"app": "x"})))
    st.assign_pod("node-0", tm.AssignedPod(pod=tm.Pod(
        name="held", device_allocation={"cpuset": [0, 1]})))
    cpuset = tm.Pod(name="c", requests={jm.CPU: 2000}, qos="LSR")
    hosts, _, snap, allocs = eng.schedule([cpuset], now=NOW)
    assert snap.names[hosts[0]] == "node-0" and allocs[0]["cpuset"] == [2, 3]
    hosts, _, snap, allocs = eng.schedule([cpuset, gpu], now=NOW, assume=True)
    assert snap.names[hosts[1]] == "node-1" and allocs[1]["devices"]["gpu"] == [(0, 50, 50)]
    assert st._dev_alloc["default/c"][3] == [2, 3] and st._pod_node["default/g"] == "node-1"


def test_off_axis_scalar_is_rejected_like_jax():
    eng = Engine(_plain_state(), device="cpu")
    with pytest.raises(ValueError, match="outside the configured filter axis"):
        eng.score([tm.Pod(name="p", requests={"example.com/fpga": 1})], now=NOW)


def test_entry_points_default_to_cuda():
    """Without a card, an engine built without ``device`` raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        assert Engine(_plain_state()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(_plain_state())


def test_port_runs_with_jax_unavailable():
    """The port imports nothing of JAX or the JAX package: a SCORE, a cold
    and a warm SCHEDULE cycle over the resident tables, a constrained cycle
    with ``assume=True``, a placement-and-devices cycle, the device
    table's ``ds_score`` stage and a ``dstate_rows`` adoption, and the
    koordlet slice (a NodeMetric report, sharded SCORE in slice and mesh
    mode, a sharded SCHEDULE, a predictor checkpoint) run in a process
    where importing jax fails."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["koordinator_tpu"] = None
        import koordinator_tpu_torch, chip_smoke
        from koordinator_tpu_torch.service.engine import Engine
        from koordinator_tpu_torch.service.state import ClusterState
        from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster
        from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
        pods, nodes = random_cluster(1, num_nodes=50, num_pods=20)
        st = ClusterState(extra_scalars=(BATCH_CPU, BATCH_MEMORY), device_state=True)
        for n in nodes:
            st.upsert_node(n)
        eng = Engine(st, device="cpu")
        t, f, _ = eng.score(pods, now=NOW)
        h, s, _, _ = eng.schedule(pods, now=NOW)
        assert t.shape == (20, 256) and (h >= 0).any()
        h2, s2, _, _ = eng.schedule(pods, now=NOW + 1)
        assert (h2 == h).all() and (s2 == s).all()
        assert (eng.sched_cold_inits, eng.sched_warm_hits) == (1, 1)
        assert st.residency.full_uploads == 1 and st.residency.verify() == 19
        # one constrained cycle: a gang, a quota group and a reservation
        from koordinator_tpu_torch.api.quota import QuotaGroup
        from koordinator_tpu_torch.service.constraints import GangInfo, ReservationInfo
        st.gangs.upsert(GangInfo(name="g", min_member=2, total_children=2))
        st.quota.upsert(QuotaGroup(name="q", min={"cpu": 1000}, max={"cpu": 90000}))
        st.quota.set_total({"cpu": 400000, "memory": 1 << 40})
        st.reservations.upsert(ReservationInfo(name="r", node=nodes[0].name,
                                               allocatable={"cpu": 4000}))
        pods[0].gang = pods[1].gang = "g"
        pods[2].quota, pods[3].reservations = "q", ["r"]
        h3, _, _, al = eng.schedule(pods, now=NOW + 2, assume=True)
        assert (h3 >= 0).any() and st.gangs.get("g").once_satisfied == (h3[0] >= 0)
        # one placement-and-devices cycle: a taint, a selector, anti-affinity,
        # GPUs under a topology, a GPU pod and a cpuset pod, with assume
        from koordinator_tpu_torch.api.model import AssignedPod, Node, Pod
        from koordinator_tpu_torch.core.deviceshare import GPUDevice
        from koordinator_tpu_torch.core.numa import CPUTopology
        from koordinator_tpu_torch.service.state import NodeTopologyInfo
        st.upsert_node(Node(name="t", allocatable={"cpu": 64000, "memory": 1 << 38},
                            taints=[{"key": "k", "effect": "NoSchedule"}]))
        st.set_devices(nodes[1].name, [GPUDevice(minor=m) for m in range(2)])
        st.set_topology(nodes[1].name, NodeTopologyInfo(topo=CPUTopology(
            sockets=1, nodes_per_socket=2, cores_per_node=4, cpus_per_core=2)))
        st.assign_pod(nodes[2].name, AssignedPod(pod=Pod(name="h", labels={"a": "b"},
                                                          anti_affinity={"a": "b"})))
        gpu = Pod(name="gpu", requests={"cpu": 1000, "koordinator.sh/gpu-core": 100})
        lsr = Pod(name="lsr", requests={"cpu": 2000}, qos="LSR")
        sel = Pod(name="sel", requests={"cpu": 100}, node_selector={"absent": "x"})
        h4, _, snap, al4 = eng.schedule([gpu, lsr, sel], now=NOW + 3, assume=True)
        assert snap.names[h4[0]] == nodes[1].name and al4[0]["devices"]["gpu"]
        assert snap.names[h4[1]] == nodes[1].name and al4[1]["cpuset"] and h4[2] == -1
        assert st.residency.verify() == 19 + 4 + 6
        # the device table's two entry points: the stage's deviceshare score
        # (requests a host block, the weight in the call) and an adoption
        import numpy as np
        from koordinator_tpu_torch.service.state import dstate_rows
        sc = st.residency.device_stage("cpu").score(np.array([[100, 100], [50, 40]]), 2)
        assert sc.shape == (2, st.capacity) and sc.any() and not (sc % 2).any()
        bufs = dstate_rows([st._dv_alloc2, st._dv_used2, st._valid], "cpu")
        assert all((b.numpy() == a).all() for b, a in zip(bufs, (st._dv_alloc2, st._dv_used2,
                                                                 st._valid)))
        # the koordlet's reports into a sharded engine: a store, produce,
        # slice mode and the mesh over four CPU "devices"
        from koordinator_tpu_torch.service.koordlet import (MetricSeriesStore,
                                                            NodeMetricProducer, PeakPredictor)
        from koordinator_tpu_torch.service.sharding import ShardedEngine
        store = MetricSeriesStore(window=32)
        prod = NodeMetricProducer(store, device="cpu")
        for t in range(32):
            store.append(NOW - 10.0 * t, {prod.node_key(n.name, r): 1000.0 + 7 * t
                                          for n in nodes for r in ("cpu", "memory")})
        assert prod.report(st, NOW) == len(nodes)
        mesh = ShardedEngine(st, 4, engine=eng, shard_map=True, devices=["cpu"] * 4)
        t5, f5, _ = mesh.score(pods, now=NOW + 4)
        t6, f6, _ = ShardedEngine(st, 4, engine=eng).score(pods, now=NOW + 4)
        assert (t5 == t6).all() and (f5 == f6).all()
        assert (t5 == eng.score(pods, now=NOW + 4)[0]).all()
        h5, _, _, _ = mesh.schedule(pods, now=NOW + 5)
        assert (h5 == eng.schedule(pods, now=NOW + 5)[0]).all() and (h5 >= 0).any()
        pred = PeakPredictor(store, device="cpu")
        pred.train(NOW, {"e": (100.0, 1e9)})
        assert PeakPredictor.restore(pred.checkpoint(), store, device="cpu").predict(["e"])
        assert not any(m == "jax" or m.startswith(("jax.", "koordinator_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
