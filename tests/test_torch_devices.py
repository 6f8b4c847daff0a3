"""The device path of the port against the JAX package: the ``dev_feasible``
and ``ds_score`` kernels' plain versions and the amplified-CPU score
against the JAX functions, the engine's NUMA/deviceshare inputs against the
host-loop oracle under every topology-manager policy, and engine twins
(the JAX ``Engine`` and ``Engine(device="cpu")`` fed one op stream) for the
cases of the JAX package's sidecar device tests
(tests/test_service_devices.py), driven through ``Engine``: hosts, scores,
allocation records with their grants, and the stores' device state equal
bit for bit."""

import numpy as np
import pytest
import torch

from koordinator_tpu.service.engine import _shared_jits
from koordinator_tpu.utils.fixtures import NOW
from koordinator_tpu_torch.core import numa as tnuma
from koordinator_tpu_torch.core import placement as pl
from torch_parity import GB, assert_same, engine_of, host, pkg

CPU, MEMORY = "cpu", "memory"
GPU_CORE, GPU_RATIO, RDMA = ("koordinator.sh/gpu-core", "koordinator.sh/gpu-memory-ratio",
                             "koordinator.sh/rdma")


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("M,N,Gm,seed", [(8, 40, 8, 0), (16, 300, 16, 1), (8, 1, 8, 2),
                                         (128, 70, 8, 3), (200, 333, 16, 4)])
def test_dev_feasible_and_ds_score_match_jax(M, N, Gm, seed):
    """Both kernels' public calls on the same numpy-made inputs as the JAX
    jits; ``ds_score`` also through a ``DeviceStage`` bound to the six
    device rows, on the requests' host block, at weight 1, the engine's
    numa weight and 3, over every node and at a shard's columns: the JAX
    ``ds_score`` times the weight (M 128 and 200: the launch parameters'
    cap and past it on a card)."""
    import chip_smoke
    from koordinator_tpu_torch.core.cycle import PluginWeights

    feas_in, score_in = chip_smoke.device_inputs(torch.device("cpu"), M, N, Gm, seed)
    core, mem, full, vfs, sigs = feas_in
    jits = _shared_jits()
    want = jits["dev_feasible"](*(t.numpy() for t in (core, mem, full, vfs, *sigs)))
    assert_same(pl.dev_feasible(*feas_in), want, "dev_feasible")
    from koordinator_tpu.core.nodefit import NodeFitNodeArrays, NodeFitPodArrays, NodeFitStatic

    req, alloc2, used2 = (t.numpy() for t in score_in)
    jds = jits["ds_score"](
        NodeFitPodArrays(req=req, req_score=req, has_any_request=np.ones(M, dtype=bool)),
        NodeFitNodeArrays(alloc=alloc2, requested=used2, num_pods=np.zeros(N, np.int64),
                          allowed_pods=np.full(N, 1 << 30, np.int64), alloc_score=alloc2,
                          req_score=used2),
        NodeFitStatic(always_check=(False, False), scalar_bypass=(True, True), weights=(1, 1),
                      strategy="MostAllocated"))
    assert_same(pl.ds_score(*score_in), jds, "ds_score")
    stage = pl.DeviceStage()
    rows = (core, mem, full, vfs, score_in[1], score_in[2])
    lo, hi = N // 3, N - N // 4
    for w in (1, PluginWeights().numa, 3):
        stage.bind(rows)
        assert_same(stage.score(req, w), np.asarray(jds) * w, f"the stage's ds_score, weight {w}")
        stage.bind(rows, (lo, hi))
        assert_same(stage.score(req, w), np.asarray(jds)[:, lo:hi] * w,
                    f"the stage's ds_score at columns [{lo}, {hi}), weight {w}")


def _jax_feasible(core, mem, full, vfs, sigs):
    # copies: a tensor whose memory numpy still views cannot be resized
    return _shared_jits()["dev_feasible"](*(t.clone().numpy() for t in (core, mem, full, vfs,
                                                                       *sigs)))


def test_device_sigs_pack_round_trip():
    """The signatures' host block (``pack_device_sigs``): its flags word and
    four int32 words give back ``DeviceSigs``' seven fields, from CPU
    tensors and from numpy arrays alike; a field of another dtype or
    length, or on another device, is refused."""
    import chip_smoke

    sigs = chip_smoke.device_inputs(torch.device("cpu"), 37, 5, 8, 4)[0][4]
    block = pl.pack_device_sigs(sigs)
    assert block.dtype == np.int32 and block.shape == (37, pl.SIG_WORDS)
    back = pl.unpack_device_sigs(block)
    for name, a, b in zip(pl.DeviceSigs._fields, sigs, back):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert np.array_equal(pl.pack_device_sigs(pl.DeviceSigs(*(t.numpy() for t in sigs))), block)
    assert ((block[:, pl.SIG_FLAGS] & pl.SIG_VALID) != 0).sum() == int(sigs.sig_valid.sum())
    with pytest.raises(ValueError, match="core_req"):
        pl.pack_device_sigs(sigs._replace(core_req=sigs.core_req.long()))
    with pytest.raises(ValueError, match="rdma_need"):
        pl.pack_device_sigs(sigs._replace(rdma_need=sigs.rdma_need[:3]))
    with pytest.raises(ValueError, match="host data"):
        pl.pack_device_sigs(sigs._replace(is_multi=sigs.is_multi.to("meta")))


def test_dev_feasible_takes_host_signatures_only():
    """``dev_feasible`` takes its signatures on the host, as ``DeviceSigs``
    of CPU tensors or numpy arrays or as their packed block, each equal to
    the JAX package's ``dev_feasible``; signatures on another device are
    refused with a ``ValueError`` before any launch."""
    import chip_smoke
    from koordinator_tpu_torch import cuda

    (core, mem, full, vfs, sigs), _ = chip_smoke.device_inputs(torch.device("cpu"), 16, 90, 8, 5)
    want = _jax_feasible(core, mem, full, vfs, sigs)
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    for form in (sigs, pl.DeviceSigs(*(t.numpy() for t in sigs)), pl.pack_device_sigs(sigs)):
        assert_same(pl.dev_feasible(core, mem, full, vfs, form), want, "dev_feasible")
    meta = pl.DeviceSigs(*(t.to("meta") for t in sigs))
    with pytest.raises(ValueError, match="host data"):
        pl.dev_feasible(core, mem, full, vfs, meta)
    with pytest.raises(ValueError, match="host data"):
        pl.dev_feasible(core, mem, full, vfs, torch.from_numpy(pl.pack_device_sigs(sigs)).to(
            "meta"))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


@pytest.mark.parametrize("move", ["set_", "resize_"])
def test_device_stage_rebinds_when_a_row_moves_under_the_same_tensor(move):
    """A bound device row given new storage and new values under the same
    tensor (``set_``, or a ``resize_`` that reallocates and back) rebinds
    the stage, as the gate's does, and the public ``dev_feasible`` then
    reads the new values: equal to the JAX package's ``dev_feasible`` on
    them.  A strided row (a column slice of a wider table) is refused
    before any work; a stage bound at a node shard's columns equals the
    JAX function on those columns."""
    import chip_smoke

    (core, mem, full, vfs, sigs), _ = chip_smoke.device_inputs(torch.device("cpu"), 16, 64, 8, 6)
    rows = [t.clone() for t in (core, mem, full, vfs)]  # resizable storage
    core, mem, full, vfs = rows
    stage = pl.DeviceStage()
    stage.bind(rows)
    assert stage.bound_to(rows) and stage.binds == 1
    assert_same(stage.feasible(sigs), _jax_feasible(core, mem, full, vfs, sigs))
    fresh = torch.where(core >= 0, 100 - core, core)
    ident = [id(t) for t in rows]
    if move == "set_":
        core.set_(fresh.clone())
        full.set_(torch.flip(full, (0,)).clone())
    else:
        for t, new in ((core, fresh), (full, torch.flip(full, (0,)))):
            new = new.clone()
            t.resize_(4096, *t.shape[1:])
            t.resize_(new.shape)
            t.copy_(new)
    assert [id(t) for t in rows] == ident and not stage.bound_to(rows)
    want = _jax_feasible(core, mem, full, vfs, sigs)
    binds = pl._DEV.binds
    assert_same(pl.dev_feasible(core, mem, full, vfs, sigs), want, "dev_feasible after the move")
    assert pl._DEV.binds == binds + 1 and pl._DEV.bound_to(rows)
    stage.bind(rows)
    assert_same(stage.feasible(sigs), want)
    stage.bind(rows, (10, 50))
    assert stage.bound_to(rows, (10, 50)) and not stage.bound_to(rows)
    assert_same(stage.feasible(sigs), _jax_feasible(core[10:50], mem[10:50], full[10:50],
                                                    vfs[10:50], sigs))
    wide = torch.cat([core, core], dim=1)
    with pytest.raises(ValueError, match="contiguous"):
        pl.dev_feasible(wide[:, :8], mem, full, vfs, sigs)
    with pytest.raises(ValueError, match="contiguous"):
        stage.bind([core, mem, torch.stack([full, full], 1)[:, 0], vfs])


def test_residency_rebinds_its_device_stage():
    """The residency's device table keeps one ``DeviceStage`` bound to its
    resident rows: a warm sync's scatter keeps it (in place), a capacity
    growth rebuilds the table and rebinds it; its output equals the JAX
    package's ``dev_feasible`` on the store's host rows each time."""
    import chip_smoke

    from torch_parity import device_cluster

    st = device_cluster(pkg("torch"), initial_capacity=16)
    cpu = torch.device("cpu")
    sigs = chip_smoke.device_inputs(cpu, 8, 5, 4, 7)[0][4]

    def check():
        stage = st.residency.device_stage(cpu)
        host = [getattr(st, a) for a in st.residency._DEVICE[:4]]
        assert stage.bound_to(st.residency._tables["device"].bufs)
        if host[0].shape[1] == 4:
            assert_same(stage.feasible(sigs), _jax_feasible(*host, sigs))
        return stage.binds

    binds = check()
    st.set_devices("ep-1", [pkg("torch").GPUDevice(minor=m, numa_node=0, pcie=0)
                            for m in range(4)], [])
    assert check() == binds
    k = pkg("torch")
    cap = st.capacity
    for i in range(12, cap + 1):
        st.upsert_node(k.Node(name=f"ep-{i}", allocatable={"cpu": 64000, "memory": 512 * GB,
                                                           "pods": 64}))
    assert st.capacity > cap and check() == binds + 1


def test_ds_score_stage_takes_host_requests_only():
    """The stage's ``score`` takes its requests on the host (an int64 [M,
    2] numpy block or CPU tensor); requests on another device, of another
    dtype or shape, and a stage bound without the aggregates are refused
    with a ``ValueError`` before any launch, as is a stage bound without
    the feasibility rows asked for ``feasible``."""
    import chip_smoke
    from koordinator_tpu_torch import cuda

    (core, mem, full, vfs, sigs), (req, alloc2, used2) = chip_smoke.device_inputs(
        torch.device("cpu"), 16, 90, 8, 8)
    want = pl.ds_score_plain(req, alloc2, used2)
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    scoring = pl.DeviceStage()
    scoring.bind((None,) * 4 + (alloc2, used2))
    for form in (req, req.numpy(), np.asfortranarray(req.numpy())):
        assert_same(scoring.score(form, 2), want * 2, "ds_score")
    with pytest.raises(ValueError, match="host data"):
        scoring.score(req.to("meta"))
    with pytest.raises(ValueError, match="int64"):
        scoring.score(req.int())
    with pytest.raises(ValueError, match="int64"):
        scoring.score(req[:, :1])
    with pytest.raises(ValueError, match="feasibility rows"):
        scoring.feasible(sigs)
    feasing = pl.DeviceStage()
    feasing.bind((core, mem, full, vfs))
    with pytest.raises(ValueError, match="aggregates"):
        feasing.score(req)
    with pytest.raises(ValueError, match="alloc2"):
        feasing.bind((core, mem, full, vfs, alloc2.int(), used2))
    with pytest.raises(ValueError, match="used2"):
        feasing.bind((None,) * 4 + (alloc2, used2[:5]))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_amplify_and_amplified_score_match_jax():
    """float64 ceil(origin * ratio), the ratio <= 1 identity, and the
    amplified NodeFit score under both scorers."""
    from koordinator_tpu.core import numa as jnuma
    from torch_parity import batch, to_jax, to_torch

    rng = np.random.default_rng(3)
    origin = rng.integers(0, 1 << 40, 64).astype(np.int64)
    origin[:4] = (1, 3, 999, 1 << 52)
    ratio = rng.choice([0.5, 1.0, 1.5, 1.1, 2.0, 3.3333], 64)
    assert_same(tnuma.amplify(torch.from_numpy(origin), torch.from_numpy(ratio)),
                jnuma.amplify(origin, ratio), "amplify")
    for strategy in ("LeastAllocated", "MostAllocated"):
        b = batch(12, 40, 4, strategy)
        _, _, _, jnf, jnn, jst = to_jax(b)
        _, _, _, tnf, tnn, tst = to_torch(b)
        alloc = rng.integers(0, 8, 40).astype(np.int64) * 1000
        r = np.where(np.arange(40) % 3 == 0, 1.5, 1.0)
        want = jnuma.amplified_cpu_score(jnf, jnn, jst, 0, alloc, r)
        got = tnuma.amplified_cpu_score(tnf, tnn, tst, 0, torch.from_numpy(alloc),
                                        torch.from_numpy(r))
        assert_same(got, want, f"amplified_cpu_score {strategy}")


# ---------------------------------------------------- the engine's inputs


def _policy_cluster(k, policy: str):
    """Six topology nodes under ``policy`` (two with CPU amplification 1.5),
    four of them with GPUs split over both NUMA nodes and RDMA NICs, one
    with cpusets already held, and two device-free nodes."""
    st = k.ClusterState(initial_capacity=16)
    for i in range(8):
        st.upsert_node(k.Node(name=f"np-{i}", allocatable={CPU: 32000, MEMORY: 128 * GB,
                                                           "pods": 64}))
        if i < 6:
            st.set_topology(f"np-{i}", k.NodeTopologyInfo(
                topo=k.CPUTopology(sockets=1, nodes_per_socket=2, cores_per_node=4,
                                   cpus_per_core=2),
                policy=policy, cpu_ratio=1.5 if i in (1, 4) else 1.0))
        if i < 4:
            st.set_devices(f"np-{i}", [k.GPUDevice(minor=m, numa_node=(m + i) % 2, pcie=m // 2)
                                       for m in range(4)],
                           [k.RDMADevice(minor=m, numa_node=m, vfs_free=2) for m in range(2)])
    st.note_device_alloc("default/held", "np-2", [(0, 100, 100), (1, 50, 50)], [(0, 1)],
                         [0, 1, 4, 5])
    return st


def _device_batch(k):
    return [
        k.Pod(name="g-full", requests={CPU: 4000, MEMORY: GB, GPU_CORE: 100}),
        k.Pod(name="g-half", requests={CPU: 2000, MEMORY: GB, GPU_CORE: 50, GPU_RATIO: 40}),
        k.Pod(name="g-two", requests={CPU: 4000, MEMORY: GB, GPU_CORE: 200, RDMA: 1}),
        k.Pod(name="g-bad", requests={CPU: 1000, MEMORY: GB, GPU_CORE: 150}),
        k.Pod(name="nic", requests={CPU: 500, MEMORY: GB, RDMA: 3}),
        k.Pod(name="lsr", requests={CPU: 4000, MEMORY: GB}, qos="LSR"),
        k.Pod(name="lse-spread", requests={CPU: 2000, MEMORY: GB}, qos="LSE",
              cpu_bind_policy="SpreadByPCPUs", cpu_exclusive_policy="PCPULevel"),
        k.Pod(name="g-lsr", requests={CPU: 2000, MEMORY: GB, GPU_CORE: 100}, qos="LSR"),
        k.Pod(name="plain", requests={CPU: 1000, MEMORY: GB}),
    ]


@pytest.mark.parametrize("policy", ["none", "best-effort", "restricted", "single-numa-node"])
def test_numa_device_inputs_match_jax_and_host_oracle(policy):
    """``_numa_device_inputs`` of both engines and the port's host-loop
    oracle agree: scores, feasibility and the admitted NUMA sets, cold and
    from the epoch caches after a grant changes one node."""
    sides = {w: pkg(w) for w in ("jax", "torch")}
    st = {w: _policy_cluster(k, policy) for w, k in sides.items()}
    eng = {w: engine_of(sides[w], st[w]) for w in sides}
    pods = {w: _device_batch(k) for w, k in sides.items()}
    for step in range(2):
        if step:
            for s in st.values():
                s.note_device_alloc("default/late", "np-0", [(1, 100, 100)], [], [2, 3])
        got = {}
        for w in sides:
            st[w].publish(NOW)
            xs, xf, adm = eng[w]._numa_device_inputs(pods[w], 16, st[w].capacity)
            got[w] = (host(xs), host(xf), adm)
        ref = sides["torch"].engine_mod.numa_device_inputs_host(
            st["torch"], eng["torch"]._nf_static, pods["torch"], 16, st["torch"].capacity)
        for k in (0, 1):
            assert_same(got["torch"][k], got["jax"][k], f"step {step} output {k} vs JAX")
            assert_same(got["torch"][k], ref[k], f"step {step} output {k} vs the host oracle")
        for i in range(len(pods["jax"])):
            for name in st["jax"]._nodes:
                want = got["jax"][2].get((i, name))
                assert got["torch"][2].get((i, name)) == want == ref[2].get((i, name))


def _gpu_writers_cluster(k, late_ops: bool):
    """Ten nodes through every writer of the device rows: GPUs with
    grants held (n-0 to n-3), ``gpus=None`` (n-4 never given devices, n-5
    a topology alone, n-6 RDMA alone through ``set_devices`` with no
    GPUs: ``gpus=[]``), GPUs removed (n-7), a zeroed row reused (n-8
    removed, n-late upserted into its row), and n-9 with 2 GPUs; with
    ``late_ops`` also a grant moved, an inventory reset and a removal
    after the first read."""
    st = k.ClusterState(initial_capacity=16)
    for i in range(10):
        st.upsert_node(k.Node(name=f"n-{i}", allocatable={CPU: 32000, MEMORY: 128 * GB,
                                                          "pods": 64}))
    for i in (0, 1, 2, 3, 7, 8):
        st.set_devices(f"n-{i}", [k.GPUDevice(minor=m, numa_node=m % 2, pcie=m // 2)
                                  for m in range(4 if i != 3 else 8)],
                       [k.RDMADevice(minor=0, vfs_free=2)])
    st.set_devices("n-9", [k.GPUDevice(minor=m) for m in range(2)])
    st.set_topology("n-5", k.NodeTopologyInfo(topo=k.CPUTopology(
        sockets=1, nodes_per_socket=2, cores_per_node=4, cpus_per_core=2)))
    st.set_devices("n-6", [], [k.RDMADevice(minor=0, vfs_free=4)])
    st.note_device_alloc("default/a", "n-1", [(0, 100, 100), (1, 30, 50)], [], [])
    st.note_device_alloc("default/b", "n-2", [(2, 70, 20)], [(0, 1)], [])
    st.note_device_alloc("default/c", "n-9", [(0, 100, 100), (1, 100, 100)], [], [])
    st.remove_devices("n-7")
    st.remove_node("n-8")
    st.upsert_node(k.Node(name="n-late", allocatable={CPU: 8000, MEMORY: 32 * GB, "pods": 8}))
    if late_ops:
        st.note_device_alloc("default/d", "n-0", [(3, 40, 40)], [], [])
        st.set_devices("n-2", [k.GPUDevice(minor=m) for m in range(3)])
        st.remove_devices("n-1")
        st.remove_node("n-3")
    return st


GREQS = [(100, 100), (50, 40), (200, 100), (30, 0), (0, 60), (400, 100), (800, 100)]


@pytest.mark.parametrize("late_ops", [False, True])
def test_gpu_free_rows_hold_zero_aggregates(late_ops):
    """Every writer of the device rows leaves a node without GPUs (``gpus``
    None, ``gpus=[]``, GPUs removed, a removed node's row reused) at
    aggregates (0, 0), in the port's store and its resident device table,
    as in the JAX package's store: so ``ds_score`` scores such a node 0
    and the engine needs no mask of ``_dv_in_gpus``."""
    cpu = torch.device("cpu")
    for which in ("jax", "torch"):
        st = _gpu_writers_cluster(pkg(which), late_ops)
        off = ~st._dv_in_gpus
        assert off[st._imap.get("n-4")] and off[st._imap.get("n-5")] and off[st._imap.get("n-7")]
        gpu_free = off | (st._dv_alloc2 == 0).all(axis=1)
        assert gpu_free.sum() > off.sum()  # n-6's gpus=[] is in the GPU mask, at (0, 0)
        assert not st._dv_alloc2[off].any(), which
        if which == "torch":
            alloc2 = st.residency.device_rows(cpu)[4]
            assert not alloc2.numpy()[off].any()
            score = pl.ds_score_plain(torch.tensor(GREQS), alloc2, st.residency.device_rows(
                cpu)[5])
            assert not score.numpy()[:, gpu_free].any()


@pytest.mark.parametrize("late_ops", [False, True])
@pytest.mark.parametrize("shards", [0, 4])
def test_engine_ds_rows_match_jax(late_ops, shards):
    """The port engine's deviceshare score rows (one ``ds_score`` launch
    through the device table's stage, the numa weight in the launch, no
    mask) equal the JAX engine's ``_compute_device_score_rows`` rows
    (the kernel, the weight and the ``~_dv_in_gpus`` mask) on the
    ``_gpu_writers_cluster`` stores, over every node and (``shards``) at
    each shard's columns of a ``ShardedEngine``, whose merged device
    inputs equal the JAX sharded engine's."""
    from koordinator_tpu.core.cycle import PluginWeights as JWeights
    from koordinator_tpu.service.sharding import ShardedEngine as JSharded
    from koordinator_tpu_torch.service.sharding import ShardedEngine as TSharded

    sides = {w: pkg(w) for w in ("jax", "torch")}
    st = {w: _gpu_writers_cluster(k, late_ops) for w, k in sides.items()}
    eng = {w: engine_of(sides[w], st[w]) for w in sides}
    cap = st["torch"].capacity
    assert cap == st["jax"].capacity
    if not shards:
        eng["jax"]._compute_device_score_rows(GREQS, cap, JWeights())
        eng["torch"]._compute_device_score_rows(GREQS, cap)
        for g in GREQS:
            assert_same(eng["torch"]._ds_rows[g], eng["jax"]._ds_rows[g], f"ds row {g}")
        assert sum(int(np.count_nonzero(eng["jax"]._ds_rows[g])) for g in GREQS) >= 10
        return
    sharded = {"jax": JSharded(st["jax"], num_shards=shards, engine=eng["jax"]),
               "torch": TSharded(st["torch"], num_shards=shards, engine=eng["torch"])}
    bounds = sharded["torch"].all_bounds()
    assert bounds == sharded["jax"].all_bounds() and len(bounds) == shards
    for lo, hi in bounds:
        jout, tout = {}, {}
        eng["jax"]._compute_device_score_rows(GREQS, cap, JWeights(), out=jout, cols=(lo, hi))
        eng["torch"]._compute_device_score_rows(GREQS, cap, out=tout, cols=(lo, hi))
        for g in GREQS:
            assert_same(tout[g], jout[g], f"ds row {g} at [{lo}, {hi})")
    pods = {w: _device_batch(k) for w, k in sides.items()}
    got = {}
    for w in sides:
        st[w].publish(NOW)
        xs, xf, _ = sharded[w]._numa_device_inputs(pods[w], 16, cap)
        got[w] = (host(xs), host(xf))
    assert_same(got["torch"][0], got["jax"][0], "sharded device scores")
    assert_same(got["torch"][1], got["jax"][1], "sharded device feasibility")


# ------------------------------------------------------------ engine twins


class Twin:
    """One package's store and engine, driven by the device test cases;
    every served result is logged for the comparison."""

    def __init__(self, which: str):
        self.k = pkg(which)
        self.st = self.k.ClusterState(initial_capacity=16)
        self.eng = engine_of(self.k, self.st)
        self.log = []

    def cluster(self, names):
        from koordinator_tpu.utils import fixtures as jfx
        from koordinator_tpu_torch.utils import fixtures as tfx

        fx = jfx if self.k.which == "jax" else tfx
        rng = np.random.default_rng(7)
        for n in (fx.random_node(rng, name, pods_per_node=1) for name in names):
            n.assigned_pods = []
            n.allocatable = {CPU: 16000, MEMORY: 64 * GB, "pods": 64}
            n.metric = None
            self.st.upsert_node(n)
            self.st.update_metric(n.name, self.k.NodeMetric(
                node_usage={CPU: 100, MEMORY: GB}, update_time=NOW, report_interval=60.0))

    def gpus(self, n, numa_of=lambda m: 0, pcie_of=lambda m: 0):
        return [self.k.GPUDevice(minor=m, numa_node=numa_of(m), pcie=pcie_of(m))
                for m in range(n)]

    def gpu_pod(self, name, core, ratio=None, cpu=1000, **kw):
        req = {CPU: cpu, MEMORY: GB, GPU_CORE: core}
        if ratio is not None:
            req[GPU_RATIO] = ratio
        return self.k.Pod(name=name, requests=req, **kw)

    def schedule(self, pods, now=NOW, assume=False):
        hosts, scores, snap, allocs = self.eng.schedule(pods, now=now, assume=assume)
        names = [snap.names[h] if h >= 0 else None for h in hosts]
        self.log.append(("schedule", names, scores.tolist(), allocs))
        return names, allocs

    def score(self, pods, now=NOW):
        totals, feas, snap = self.eng.score(pods, now=now)
        self.log.append(("score", totals.tolist(), feas.tolist()))
        return totals, feas, snap

    def device_state(self):
        import chip_smoke

        return chip_smoke.device_view(self.st) + (sorted(self.st._pod_node.items()),)


def case_grant(t):
    t.cluster(["d-n0", "d-n1", "d-n2"])
    t.st.set_devices("d-n1", t.gpus(2))
    for k in range(3):
        t.schedule([t.gpu_pod(f"g{k}", 100)], now=NOW + k, assume=True)
    return t.log[-1][1] == [None] and t.log[0][3][0]["devices"]["gpu"] == [(0, 100, 100)]


def case_binpack(t):
    t.cluster(["b-n0", "b-n1"])
    for n in ("b-n0", "b-n1"):
        t.st.set_devices(n, t.gpus(2))
    warm, _ = t.schedule([t.gpu_pod("warm", 60, cpu=500)], assume=True)
    part, allocs = t.schedule([t.gpu_pod("part", 30, cpu=500)], now=NOW + 1)
    t.score([t.gpu_pod("probe", 50, cpu=500)], now=NOW + 2)
    return part == warm and allocs[0]["devices"]["gpu"][0][0] == 0


def case_no_devices(t):
    t.cluster(["nd-n0"])
    hosts, _ = t.schedule([t.gpu_pod("g", 100)])
    _, feas, _ = t.score([t.gpu_pod("g", 100)])
    return hosts == [None] and not feas.any()


def case_unassign_releases(t):
    t.cluster(["r-n0"])
    t.st.set_devices("r-n0", t.gpus(1))
    first, _ = t.schedule([t.gpu_pod("g0", 100)], assume=True)
    full, _ = t.schedule([t.gpu_pod("g1", 100)], now=NOW + 1)
    t.st.unassign_pod("default/g0")
    again, _ = t.schedule([t.gpu_pod("g1", 100)], now=NOW + 2)
    return first == ["r-n0"] and full == [None] and again == ["r-n0"]


def case_authoritative_assign(t):
    t.cluster(["a-n0"])
    t.st.set_devices("a-n0", t.gpus(2))
    bound = t.k.Pod(name="bound", requests={CPU: 500, MEMORY: GB, GPU_CORE: 100},
                    device_allocation={"gpu": [[1, 100, 100]]})
    t.st.assign_pod("a-n0", t.k.AssignedPod(pod=bound, assign_time=NOW))
    _, allocs = t.schedule([t.gpu_pod("g", 100)], now=NOW + 1)
    return allocs[0]["devices"]["gpu"] == [(0, 100, 100)]


def _topo(t, sockets=1, nodes=2, cores=4, threads=2, **kw):
    return t.k.NodeTopologyInfo(topo=t.k.CPUTopology(sockets=sockets, nodes_per_socket=nodes,
                                                     cores_per_node=cores,
                                                     cpus_per_core=threads), **kw)


def case_cpuset_grant(t):
    t.cluster(["c-n0", "c-n1"])
    t.st.set_topology("c-n1", _topo(t))
    hosts, allocs = t.schedule([t.k.Pod(name="lsr", requests={CPU: 4000, MEMORY: GB},
                                        qos="LSR")], assume=True)
    return hosts == ["c-n1"] and allocs[0]["cpuset"] == [0, 1, 2, 3]


def case_cpuset_exhaustion(t):
    t.cluster(["x-n0"])
    t.st.set_topology("x-n0", _topo(t, nodes=1, cores=2))
    pods = [t.k.Pod(name="lsr-a", requests={CPU: 4000, MEMORY: GB}, qos="LSR"),
            t.k.Pod(name="lsr-b", requests={CPU: 2000, MEMORY: GB}, qos="LSR")]
    hosts, allocs = t.schedule(pods, assume=True)
    t.st.unassign_pod("default/lsr-a")
    hosts2, allocs2 = t.schedule([pods[1]], now=NOW + 1)
    return hosts == ["x-n0", None] and allocs[1] is None and len(allocs2[0]["cpuset"]) == 2


def case_single_numa_gate(t):
    t.cluster(["p-n0", "p-n1"])
    for n in ("p-n0", "p-n1"):
        t.st.set_topology(n, _topo(t, policy="single-numa-node"))
    t.st.set_devices("p-n0", t.gpus(2, numa_of=lambda m: m))
    t.st.set_devices("p-n1", t.gpus(2, numa_of=lambda m: 0))
    hosts, _ = t.schedule([t.gpu_pod("two", 200, cpu=500)])
    return hosts == ["p-n1"]


def case_rdma_only(t):
    t.cluster(["v-n0", "v-n1"])
    t.st.set_devices("v-n1", [], [t.k.RDMADevice(minor=0, vfs_free=2)])
    hosts, allocs = t.schedule([t.k.Pod(name="nic", requests={CPU: 500, MEMORY: GB, RDMA: 2})],
                               assume=True)
    hosts2, _ = t.schedule([t.k.Pod(name="nic2", requests={CPU: 500, MEMORY: GB, RDMA: 1})],
                           now=NOW + 1)
    return hosts == ["v-n1"] and allocs[0]["devices"]["rdma"] == [(0, 2)] and hosts2 == [None]


def case_gang_rollback(t):
    t.cluster(["gg-n0"])
    t.st.set_devices("gg-n0", t.gpus(1))
    t.st.gangs.upsert(t.k.GangInfo(name="pair", min_member=2, total_children=2))
    hosts, allocs = t.schedule([t.gpu_pod("pg-0", 100, cpu=500, gang="pair"),
                                t.gpu_pod("pg-1", 100, cpu=500, gang="pair")], assume=True)
    return (hosts == [None, None] and allocs == [None, None] and t.st._dev_alloc == {}
            and all(not n.assigned_pods for n in t.st._nodes.values()))


def case_no_reservation_leak(t):
    t.cluster(["lr-n0"])
    t.st.set_devices("lr-n0", t.gpus(1))
    t.st.reservations.upsert(t.k.ReservationInfo(name="lr-rsv", node="lr-n0",
                                                 allocatable={CPU: 4000, MEMORY: 8 * GB}))
    hosts, allocs = t.schedule([t.gpu_pod("lw", 100, cpu=500),
                                t.gpu_pod("ll", 100, cpu=500, reservations=["lr-rsv"])],
                               assume=True)
    rsv = t.st.reservations.get("lr-rsv")
    t.log.append(("reservation", sorted(rsv.allocated.items())))
    demoted = hosts.index(None)
    return (hosts.count(None) == 1 and allocs[demoted] is None
            and (demoted == 0 or all(v == 0 for v in rsv.allocated.values())))


def case_missing_minor(t):
    t.cluster(["ri-n0"])
    t.st.set_devices("ri-n0", t.gpus(2))
    _, allocs = t.schedule([t.gpu_pod("holder", 100)], assume=True)
    other = 1 - allocs[0]["devices"]["gpu"][0][0]
    t.st.set_devices("ri-n0", [t.k.GPUDevice(minor=other)])
    hosts, allocs2 = t.schedule([t.gpu_pod("next", 100)], now=NOW + 1)
    return hosts == ["ri-n0"] and allocs2[0]["devices"]["gpu"] == [(other, 100, 100)]


def case_admitted_affinity(t):
    t.cluster(["m-n0"])
    t.st.set_topology("m-n0", _topo(t, policy="single-numa-node"))
    t.st.set_devices("m-n0", [t.k.GPUDevice(minor=0, numa_node=0, pcie=0),
                              t.k.GPUDevice(minor=1, numa_node=0, pcie=0),
                              t.k.GPUDevice(minor=2, numa_node=0, pcie=1),
                              t.k.GPUDevice(minor=3, numa_node=1, pcie=2)])
    for m in (1, 2):
        t.st.assign_pod("m-n0", t.k.AssignedPod(pod=t.k.Pod(
            name=f"half-{m}", requests={CPU: 100, MEMORY: GB, GPU_CORE: 50},
            device_allocation={"gpu": [[m, 50, 50]]}), assign_time=NOW))
    hosts, _ = t.schedule([t.gpu_pod("span", 200, cpu=500)])
    return hosts == [None]


def case_device_reservation_pending(t):
    t.cluster(["dr-n0"])
    t.st.set_devices("dr-n0", t.gpus(1))
    t.st.reservations.upsert(t.k.ReservationInfo(
        name="dr-rsv", node=None, allocatable={CPU: 1000, MEMORY: GB, GPU_CORE: 100}))
    t.schedule([], assume=True)
    hosts, _ = t.schedule([t.gpu_pod("direct", 100)], now=NOW + 1)
    return t.st.reservations.get("dr-rsv").node is None and hosts == ["dr-n0"]


def case_reassign_moves(t):
    t.cluster(["mv-a", "mv-b"])
    for n in ("mv-a", "mv-b"):
        t.st.set_devices(n, t.gpus(1))
    hosts, _ = t.schedule([t.gpu_pod("mv", 100)], assume=True)
    src = hosts[0]
    dst = "mv-b" if src == "mv-a" else "mv-a"
    moved = t.k.Pod(name="mv", requests={CPU: 1000, MEMORY: GB, GPU_CORE: 100},
                    device_allocation={"gpu": [[0, 100, 100]]})
    t.st.assign_pod(dst, t.k.AssignedPod(pod=moved, assign_time=NOW + 1))
    hosts2, _ = t.schedule([t.gpu_pod("fresh", 100)], now=NOW + 2)
    return (t.st._gpus[src][0].full_free() and not t.st._gpus[dst][0].full_free()
            and hosts2 == [src])


def case_exclusive_policies(t):
    t.cluster(["e-n0", "s-n0"])
    t.st.set_topology("e-n0", _topo(t, cores=2))
    a = t.k.Pod(name="excl-a", requests={CPU: 2000, MEMORY: GB}, qos="LSR",
                cpu_exclusive_policy="NUMANodeLevel", node_selector={"host": "e"})
    b = t.k.Pod(name="excl-b", requests={CPU: 2000, MEMORY: GB}, qos="LSR",
                cpu_exclusive_policy="NUMANodeLevel", node_selector={"host": "e"})
    t.st.set_topology("s-n0", _topo(t, nodes=1, cores=2, threads=1, max_ref_count=2))
    for name, lab in (("e-n0", "e"), ("s-n0", "s")):
        node = t.st._nodes[name]
        spec = t.k.Node(name=name, allocatable=dict(node.allocatable), labels={"host": lab})
        t.st.upsert_node(spec)
    hosts, allocs = t.schedule([a, b], assume=True)
    pods = [t.k.Pod(name=f"share-{i}", requests={CPU: 2000, MEMORY: GB}, qos="LSR",
                    node_selector={"host": "s"}) for i in range(5)]
    hosts2, _ = t.schedule(pods, now=NOW + 1, assume=True)
    numa = [{c // 4 for c in al["cpuset"]} for al in allocs]
    return (hosts == ["e-n0", "e-n0"] and numa[0].isdisjoint(numa[1])
            and hosts2 == ["s-n0", "s-n0", None, None, None])


CASES = [case_grant, case_binpack, case_no_devices, case_unassign_releases,
         case_authoritative_assign, case_cpuset_grant, case_cpuset_exhaustion,
         case_single_numa_gate, case_rdma_only, case_gang_rollback, case_no_reservation_leak,
         case_missing_minor, case_admitted_affinity, case_device_reservation_pending,
         case_reassign_moves, case_exclusive_policies]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_engine_twins_match_jax(case):
    """One op stream into the JAX ``Engine`` and ``Engine(device="cpu")``:
    every SCHEDULE and SCORE result, the allocation records with their
    grants and the stores' device state equal, and the case's own outcome
    holds on the port."""
    j, t = Twin("jax"), Twin("torch")
    want = case(j)
    got = case(t)
    assert got, f"{case.__name__}: the case's outcome does not hold on the port"
    assert want, f"{case.__name__}: the case's outcome does not hold on the JAX package"
    assert len(t.log) == len(j.log)
    for a, b in zip(t.log, j.log):
        assert a == b
    assert t.device_state() == j.device_state()
