"""The sharded engine's port against the JAX package's ``ShardedEngine``,
the twins of tests/test_sharding.py's cases.

Both packages build the same store from the same op stream (nodes across
every shard of the 256-column bucket, quota, gangs, a bound reservation,
GPUs and RDMA, a NUMA topology, a taint, selectors, anti-affinity) and
serve the same probe batch.  The port runs on the CPU: slice mode launches
the ``score`` kernel's plain version per shard, and mesh mode
(``shard_map=True``) takes ``devices=["cpu"] * S`` where the JAX tests take
XLA's eight host devices (tests/conftest.py), running ``shard_score_map``'s
plain version per block.  Tolerance 0 everywhere: totals, feasibility,
placements, scores, allocation records, the stores after ``assume``, the
per-shard cache keys and the sidecars' reply bytes.
"""

import numpy as np
import pytest
import torch

from chip_smoke import Wire, store_view
from koordinator_tpu.service.sharding import ShardedEngine as JSharded
from koordinator_tpu.service.sharding import shard_bounds as j_bounds
from koordinator_tpu.service.sharding import topk_merge as j_topk
from koordinator_tpu.service.wireops import apply_wire_ops as japply
from koordinator_tpu_torch.service import sharding as ts
from koordinator_tpu_torch.service.wireops import apply_wire_ops as tapply
from torch_parity import GB, engine_of, pkg

NOW = 5_000_000.0
SIDES = ("jax", "torch")


def _mixed_ops(k, n=40):
    """tests/test_sharding.py's op stream with package ``k``'s types."""
    C = k.Client
    topo = k.NodeTopologyInfo(topo=k.CPUTopology(sockets=1, nodes_per_socket=2,
                                                 cores_per_node=4, cpus_per_core=2))
    ops = [C.op_upsert(k.Node(
        name=f"s-n{i}", allocatable={"cpu": 16000, "memory": 64 * GB, "pods": 64},
        labels={"zone": f"z{i % 3}"},
        taints=[{"key": "dedic", "value": "gpu", "effect": "NoSchedule"}] if i % 7 == 0 else []))
        for i in range(n)]
    ops += [C.op_metric(f"s-n{i}", k.NodeMetric(
        node_usage={"cpu": 200 + 311 * (i % 9), "memory": (1 + i % 5) * GB},
        update_time=NOW, report_interval=60.0)) for i in range(n)]
    ops += [
        C.op_quota_total({"cpu": 400000, "memory": 1600 * GB}),
        C.op_quota(k.QuotaGroup(name="sq-root", parent="koordinator-root-quota", is_parent=True,
                                min={"cpu": 30000, "memory": 100 * GB},
                                max={"cpu": 100000, "memory": 400 * GB})),
        C.op_quota(k.QuotaGroup(name="sq", parent="sq-root", min={"cpu": 8000, "memory": 32 * GB},
                                max={"cpu": 9000, "memory": 400 * GB})),
        C.op_gang(k.GangInfo(name="sg", min_member=2, total_children=2)),
        C.op_gang(k.GangInfo(name="sg-starved", min_member=4, total_children=2)),
        C.op_reservation(k.ReservationInfo(name="sr-bound", node="s-n9",
                                           allocatable={"cpu": 4000, "memory": 8 * GB})),
        C.op_devices("s-n3", [k.GPUDevice(minor=m, numa_node=m // 2) for m in range(4)],
                     rdma=[k.RDMADevice(minor=0, vfs_free=2)]),
        C.op_devices("s-n33", [k.GPUDevice(minor=0)]),
        C.op_topology("s-n5", topo),
    ]
    return ops


def _probe_pods(k):
    gpu, rdma = "koordinator.sh/gpu-core", "koordinator.sh/rdma"
    P = k.Pod
    return [
        P(name="p-dense", requests={"cpu": 1200, "memory": 3 * GB}),
        P(name="p-q", requests={"cpu": 2000, "memory": GB}, quota="sq"),
        P(name="p-q-over", requests={"cpu": 8000, "memory": GB}, quota="sq"),
        P(name="p-gpu", requests={"cpu": 500, "memory": GB, gpu: 100}),
        P(name="p-rdma", requests={"cpu": 500, "memory": GB, rdma: 1}),
        P(name="p-rsv", requests={"cpu": 1500, "memory": 2 * GB}, reservations=["sr-bound"]),
        P(name="p-g0", requests={"cpu": 400, "memory": GB}, gang="sg"),
        P(name="p-g1", requests={"cpu": 400, "memory": GB}, gang="sg"),
        P(name="p-starved", requests={"cpu": 400, "memory": GB}, gang="sg-starved"),
        P(name="p-sel", requests={"cpu": 300, "memory": GB}, node_selector={"zone": "z1"}),
        P(name="p-tol", requests={"cpu": 300, "memory": GB},
          tolerations=[{"key": "dedic", "operator": "Exists"}]),
        P(name="p-aa", requests={"cpu": 300, "memory": GB}, labels={"app": "aa"},
          anti_affinity={"app": "aa"}),
        P(name="p-huge", requests={"cpu": 99000, "memory": GB}),
    ]


def _side(which):
    k = pkg(which)
    st = k.ClusterState(extra_scalars=("kubernetes.io/batch-cpu", "kubernetes.io/batch-memory"))
    (japply if which == "jax" else tapply)(st, _mixed_ops(k))
    return k, st, engine_of(k, st)


def _sharded(which, st, eng, num_shards, mesh=False):
    if which == "jax":
        return JSharded(st, num_shards=num_shards, engine=eng, shard_map=mesh)
    return ts.ShardedEngine(st, num_shards=num_shards, engine=eng, shard_map=mesh,
                            devices=["cpu"] * num_shards if mesh else None)


def _apply(which, st, ops):
    (japply if which == "jax" else tapply)(st, ops)


def _names(h, snap):
    return [None if x < 0 else snap.names[x] for x in h]


def _node_rows(st, now):
    snap = st.publish(now)
    return [np.asarray(a).tolist() for a in (*snap.la_nodes, *snap.nf_nodes, snap.valid)]


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_score_equals_jax(num_shards, mesh):
    got = {}
    for which in SIDES:
        k, st, eng = _side(which)
        want = eng.score(_probe_pods(k), now=NOW + 1)
        se = _sharded(which, st, eng, num_shards, mesh)
        t, f, snap = se.score(_probe_pods(k), now=NOW + 1)
        assert np.array_equal(t, want[0]) and np.array_equal(f, want[1])
        assert snap.generation == want[2].generation + 1
        got[which] = (t, f)
    assert np.array_equal(got["torch"][0], got["jax"][0])
    assert np.array_equal(got["torch"][1], got["jax"][1])
    assert got["torch"][1].any() and not got["torch"][1].all()


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_schedule_assume_equals_jax(num_shards, mesh):
    """Two assume cycles through each package's sharded engine: the same
    placements, scores, allocation records, reservation bindings and
    stores after each, and equal to an unsharded port engine on a twin
    store."""
    out = {}
    for which in SIDES:
        k, st, eng = _side(which)
        se = _sharded(which, st, eng, num_shards, mesh)
        cycles = []
        for t in (NOW + 1, NOW + 2):
            h, sc, snap, al = se.schedule(_probe_pods(k), now=t, assume=True)
            cycles.append((_names(h, snap), sc.tolist(), al,
                           dict(se.engine.last_reservations_placed), store_view(st),
                           _node_rows(st, t)))
        out[which] = cycles
    assert out["torch"] == out["jax"]
    k, st, eng = _side("torch")
    for c, t in zip(out["torch"], (NOW + 1, NOW + 2)):
        h, sc, snap, al = eng.schedule(_probe_pods(k), now=t, assume=True)
        assert (_names(h, snap), sc.tolist(), al) == c[:3]
    assert any(n is not None for n in out["torch"][0][0])


def test_unchanged_shards_keep_cache_keys():
    """A metric APPLY confined to one shard leaves every other shard's
    cache keys and score blocks as they were; the keys equal the JAX
    engine's at every step."""
    ses, keys = {}, {}
    for which in SIDES:
        k, st, eng = _side(which)
        se = _sharded(which, st, eng, 8)
        se.score(_probe_pods(k), now=NOW + 1)
        assert (se.last_block_hits, se.last_block_misses) == (0, 8)
        ses[which] = (k, st, se)
        keys[which] = [se.cache_keys()]
    touched = ses["torch"][1]._imap.get("s-n0") // (ses["torch"][1].capacity // 8)
    for which, (k, st, se) in ses.items():
        _apply(which, st, [k.Client.op_metric("s-n0", k.NodeMetric(
            node_usage={"cpu": 9000, "memory": 9 * GB}, update_time=NOW, report_interval=60.0))])
        se.score(_probe_pods(k), now=NOW + 1)
        assert (se.last_block_hits, se.last_block_misses) == (7, 1)
        keys[which].append(se.cache_keys())
    assert keys["torch"] == keys["jax"]
    before, after = keys["torch"]
    for s in range(8):
        same = {f: after[s][f] == before[s][f] for f in ("score", "sel", "dev")}
        assert same == ({"score": False, "sel": True, "dev": True} if s == touched
                        else {"score": True, "sel": True, "dev": True}), s


def test_block_cache_keys_on_device_signatures():
    """Device resources live off the NodeFit axis: a GPU pod after a plain
    pod of equal NodeFit arrays must not be served the plain pod's block."""
    k, st, eng = _side("torch")
    se = _sharded("torch", st, eng, 2)
    plain = k.Pod(name="p-x", requests={"cpu": 500, "memory": GB})
    gpu = k.Pod(name="p-x", requests={"cpu": 500, "memory": GB,
                                      "koordinator.sh/gpu-core": 100})
    se.score([plain], now=NOW + 1)
    t1, f1, _ = se.score([gpu], now=NOW + 1)
    t0, f0, _ = eng.score([gpu], now=NOW + 1)
    assert np.array_equal(t0, t1) and np.array_equal(f0, f1)
    assert se.last_block_misses == 2


def test_device_apply_invalidates_only_its_shard():
    keys = {}
    for which in SIDES:
        k, st, eng = _side(which)
        se = _sharded(which, st, eng, 8)
        se.score(_probe_pods(k), now=NOW + 1)
        before = se.cache_keys()
        _apply(which, st, [k.Client.op_devices("s-n33", [k.GPUDevice(minor=0),
                                                          k.GPUDevice(minor=1)])])
        se.score(_probe_pods(k), now=NOW + 1)
        keys[which] = (before, se.cache_keys(), st._imap.get("s-n33") // (st.capacity // 8))
    assert keys["torch"] == keys["jax"]
    before, after, touched = keys["torch"]
    assert [after[s]["dev"] != before[s]["dev"] for s in range(8)] == [s == touched
                                                                        for s in range(8)]


def test_topk_merge_with_ties_equals_jax_and_the_global_sort():
    k, st, eng = _side("torch")
    totals, feasible, _ = eng.score(_probe_pods(k), now=NOW + 1)
    tied = (totals // 50) * 50  # many ties
    for t in (totals, tied):
        for num_shards in (1, 2, 4, 8):
            bounds = ts.shard_bounds(st.capacity, num_shards)
            assert bounds == j_bounds(st.capacity, num_shards)
            for kk in (1, 7, 300):
                idx, sc = ts.topk_merge(t, feasible, bounds, kk)
                jidx, jsc = j_topk(t, feasible, bounds, kk)
                assert np.array_equal(idx, jidx) and np.array_equal(sc, jsc)
                for p in range(t.shape[0]):
                    cols = np.flatnonzero(feasible[p])
                    want = sorted(zip(-t[p, cols], cols))[:kk]
                    n = len(want)
                    assert idx[p, :n].tolist() == [c for _, c in want]
                    assert sc[p, :n].tolist() == [-s for s, _ in want]
                    assert (idx[p, n:] == -1).all()


def test_refusals():
    with pytest.raises(ValueError, match="must divide"):
        ts.shard_bounds(256, 3)
    with pytest.raises(ValueError, match=">= 1"):
        ts.shard_bounds(256, 0)
    assert ts.shard_bounds(256, 8) == [(i * 32, (i + 1) * 32) for i in range(8)]
    k, st, eng = _side("torch")
    with pytest.raises(ValueError, match="num_shards must be >= 1"):
        ts.ShardedEngine(st, num_shards=0, engine=eng)
    # a CPU engine's mesh is its one device unless ``devices`` says more
    with pytest.raises(ValueError, match="shard_map mode needs >= 4 devices, have 1"):
        ts.ShardedEngine(st, num_shards=4, engine=eng, shard_map=True)
    with pytest.raises(ValueError, match="shard_map mode needs >= 8 devices, have 2"):
        ts.ShardedEngine(st, num_shards=8, engine=eng, shard_map=True, devices=["cpu"] * 2)
    assert ts.ShardedEngine(st, num_shards=1, engine=eng, shard_map=True).devices == [
        torch.device("cpu")]
    with pytest.raises(ValueError, match="power of two"):
        k.SidecarServer(initial_capacity=256, shards=3, device="cpu")
    with pytest.raises(ValueError, match="shard_map mode needs >= 4 devices, have 1"):
        k.SidecarServer(initial_capacity=256, shards=4, shard_map=True, device="cpu")
    # the block wrapper checks its buffers before any work
    x = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="outside 8 columns"):
        ts.shard_score_map(*_tiny_inputs(2, 8), None, 4, 9, x, x.bool())
    with pytest.raises(ValueError, match="feasible"):
        ts.shard_score_map(*_tiny_inputs(2, 8), None, 0, 8, x, x)


def _tiny_inputs(P, N):
    from torch_parity import batch, to_torch

    la, la_n, w, nf, nf_n, static = to_torch(batch(P, N, 5))
    return la, la_n, w, nf, nf_n, static, torch.ones(N, dtype=torch.bool)


@pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated",
                                      "RequestedToCapacityRatio"])
def test_shard_score_map_plain_equals_score_fn(strategy):
    """The mesh blocks merged equal the unsharded ``score`` over every
    column, with extras and a ragged valid mask, under each strategy."""
    from koordinator_tpu_torch.core.cycle import score_fn
    from torch_parity import batch, to_torch

    la, la_n, w, nf, nf_n, static = to_torch(batch(24, 96, 8, strategy=strategy))
    rng = np.random.default_rng(4)
    valid = torch.from_numpy(rng.random(96) < 0.9)
    for extra in (None, torch.from_numpy(rng.integers(0, 200, (24, 96))).to(torch.int64)):
        want = score_fn(la, la_n, w, nf, nf_n, static, valid, extra)
        for S in (1, 2, 4):
            t = torch.full((24, 96), -7, dtype=torch.int64)
            f = torch.zeros((24, 96), dtype=torch.bool)
            for lo, hi in ts.shard_bounds(96, S):
                ts.shard_score_map(la, la_n, w, nf, nf_n, static, valid, extra, lo, hi, t, f)
            assert torch.equal(t, want[0]) and torch.equal(f, want[1])


@pytest.mark.parametrize("lo,hi", [(100, 200), (200, 300), (37, 90)])
def test_shard_block_alone_keeps_every_other_column(lo, hi):
    """One block of ``shard_score_map`` written alone into sentinel buffers
    (blocks of ``shard_bounds(300, 3)`` at offsets 100 and 200, off the
    kernel's 128-column tiles, and a 53-column block inside one tile): its
    columns equal the JAX engine's ``score_fn`` body (``score_batch`` + the
    extra scores, feasibility AND ``valid``, koordinator_tpu/service/
    engine.py:134-143) at the same columns, with extras and a ragged valid
    mask, and every other column keeps its sentinel."""
    from koordinator_tpu.core.cycle import score_batch as j_score_batch
    from torch_parity import batch, to_jax, to_torch

    b = batch(24, 300, 12)
    la, la_n, w, nf, nf_n, static = to_torch(b)
    rng = np.random.default_rng(5)
    valid = rng.random(300) < 0.9
    extra = rng.integers(-100, 200, (24, 300)).astype(np.int64)
    jt, jf = j_score_batch(*to_jax(b))
    want_t, want_f = np.asarray(jt) + extra, np.asarray(jf) & valid[None, :]
    sentinel = -(1 << 40)
    t = torch.full((24, 300), sentinel, dtype=torch.int64)
    f = torch.ones((24, 300), dtype=torch.bool)
    ts.shard_score_map(la, la_n, w, nf, nf_n, static, torch.from_numpy(valid),
                       torch.from_numpy(extra), lo, hi, t, f)
    assert np.array_equal(t[:, lo:hi].numpy(), want_t[:, lo:hi])
    assert np.array_equal(f[:, lo:hi].numpy(), want_f[:, lo:hi])
    outside = np.ones(300, dtype=bool)
    outside[lo:hi] = False
    assert (t.numpy()[:, outside] == sentinel).all() and f.numpy()[:, outside].all()


def test_warm_carry_never_crosses_a_shard_layout():
    """Solo, 2 shards, 2 again, 4, solo: a carry taken under one layout
    never seeds a cycle under another (each change is a cold init), the
    repeat under an unchanged layout is warm, and the counters and outputs
    equal the JAX engine's through the same sequence."""
    seq = [0, 2, 2, 4, 4, 0, 0]
    out = {}
    for which in SIDES:
        k, st, eng = _side(which)
        rec = []
        for i, S in enumerate(seq):
            runner = eng if S == 0 else _sharded(which, st, eng, S)
            pods = [p for p in _probe_pods(k) if p.name in ("p-dense", "p-sel", "p-tol", "p-g0")]
            h, sc, snap, al = runner.schedule(pods, now=NOW + 1 + i)
            rec.append((_names(h, snap), sc.tolist(), al, eng.sched_cold_inits,
                        eng.sched_warm_hits))
        out[which] = rec
    assert out["torch"] == out["jax"]
    colds = [r[3] for r in out["torch"]]
    warms = [r[4] for r in out["torch"]]
    assert colds == [1, 2, 2, 3, 3, 4, 4] and warms == [0, 0, 1, 1, 2, 2, 3]


def _score_frames(k, proto):
    M = proto.MsgType
    pods = [proto.pod_to_wire(p) for p in _probe_pods(k)]
    frames = [proto.encode(M.HELLO, 1, {})]
    ops = _mixed_ops(k)
    frames.append(proto.encode(M.APPLY, 2, {"ops": ops}))
    frames.append(proto.encode(M.SCORE, 3, {"pods": pods, "now": NOW + 1, "names_version": -1}))
    frames.append(proto.encode(M.SCHEDULE, 4, {"pods": pods, "now": NOW + 2, "names_version": 1}))
    frames.append(proto.encode(M.SCHEDULE, 5, {"pods": pods, "now": NOW + 3, "names_version": 1,
                                               "assume": True}))
    frames.append(proto.encode(M.SCHEDULE, 6, {"pods": pods, "now": NOW + 4, "names_version": 1}))
    frames.append(proto.encode(M.SCORE, 7, {"pods": pods, "now": NOW + 5, "names_version": 1}))
    return frames


def test_sidecar_shards_beside_plain_twin_and_jax():
    """A port sidecar with ``shards=4`` answers the frames byte for byte as
    the JAX sidecar with ``shards=4`` does, and as a plain port twin does
    past HELLO, whose ``shards`` field appears only when sharded; the
    stores after ``assume`` equal the twin's."""
    jk, tk = pkg("jax"), pkg("torch")
    scalars = ("kubernetes.io/batch-cpu", "kubernetes.io/batch-memory")
    jsrv = jk.SidecarServer(initial_capacity=256, extra_scalars=scalars, shards=4)
    tsrv = tk.SidecarServer(initial_capacity=256, extra_scalars=scalars, shards=4, device="cpu")
    plain = tk.SidecarServer(initial_capacity=256, extra_scalars=scalars, device="cpu")
    try:
        wires = [Wire(s.address) for s in (jsrv, tsrv, plain)]
        frames = _score_frames(tk, tk.proto)
        for i, frame in enumerate(frames):
            want, got, solo = (w.call(frame) for w in wires)
            assert got == want, i
            if i == 0:
                assert tk.proto.decode((0, 0, memoryview(got)[tk.proto._HDR.size:]))[2][
                    "shards"] == 4
                assert "shards" not in tk.proto.decode(
                    (0, 0, memoryview(solo)[tk.proto._HDR.size:]))[2]
            else:
                assert got == solo, i
        for w in wires:
            w.close()
        assert store_view(tsrv.state) == store_view(plain.state) == store_view(jsrv.state)
        assert tsrv._serving_engine() is tsrv._serving_engine()
        assert isinstance(tsrv._serving_engine(), ts.ShardedEngine)
        assert plain._serving_engine() is plain.engine
    finally:
        for s in (jsrv, tsrv, plain):
            s.close()
