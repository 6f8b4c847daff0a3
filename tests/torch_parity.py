"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Every input is made from a seed with numpy — the JAX package's fixtures and
snapshot builders — and handed to both sides: as jnp arrays to the JAX
function, and through ``koordinator_tpu_torch.convert`` as CPU tensors to
its port.  All of the compared math is integer, so parity is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from koordinator_tpu.core.config import LoadAwareArgs, NodeFitArgs, ScoringStrategyType
from koordinator_tpu.snapshot import loadaware as la_snap
from koordinator_tpu.snapshot import nodefit as nf_snap
from koordinator_tpu.utils.fixtures import NOW, random_cluster
from koordinator_tpu_torch import convert

CPU = torch.device("cpu")
STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")


NON_MONOTONE = [(0, 2), (40, 10), (70, 3), (100, 6)]
BIN_PACKING = [(0, 0), (100, 10)]  # the RequestedToCapacityRatio default


def nodefit_args(strategy: str = "LeastAllocated", shape=None) -> NodeFitArgs:
    args = NodeFitArgs(strategy=ScoringStrategyType(strategy))
    if strategy == "RequestedToCapacityRatio":
        # by default a non-monotone shape, which exercises the truncating
        # interpolation on decreasing segments
        args.shape = list(NON_MONOTONE if shape is None else shape)
    return args


def batch(P: int, N: int, seed: int, strategy: str = "LeastAllocated", shape=None):
    """(la_pods, la_nodes, weights, nf_pods, nf_nodes, nf_static) as numpy,
    from ``random_cluster`` through the JAX package's builders; the
    NodeFit static is the JAX package's (``shape``: the RTC shape in
    config units, the non-monotone one when None)."""
    pods, nodes = random_cluster(seed, num_nodes=N, num_pods=P, pods_per_node=4,
                                 with_aggregated=True)
    la_args, nf_args = LoadAwareArgs(), nodefit_args(strategy, shape)
    nf_pa, nf_na, nf_st = nf_snap.build_all(pods, nodes, nf_args)
    return (
        la_snap.build_pod_arrays(pods, la_args),
        la_snap.build_node_arrays(nodes, la_args, now=NOW),
        la_snap.build_weights(la_args),
        nf_pa,
        nf_na,
        nf_st,
    )


def to_jax(b):
    la, la_n, w, nf, nf_n, st = b
    arr = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return arr(la), arr(la_n), jnp.asarray(w), arr(nf), arr(nf_n), st


def to_torch(b, device=CPU):
    la, la_n, w, nf, nf_n, st = b
    return (
        convert.la_pods(la, device),
        convert.la_nodes(la_n, device),
        convert.weights(w, device),
        convert.nf_pods(nf, device),
        convert.nf_nodes(nf_n, device),
        convert.nf_static(st),
    )


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, what: str = "") -> None:
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert np.array_equal(g, w), f"{what}: first difference at {np.argwhere(g != w)[:3].tolist()}"


def constraints_to_torch(gang=None, quota=None, reservation=None, device=CPU):
    """The JAX package's GangInputs / QuotaInputs / ReservationInputs (numpy
    or jnp fields) as the port's NamedTuples on ``device``; None stays None
    at every level."""
    from koordinator_tpu_torch.core import cycle as tc, gang as tg, quota as tq
    from koordinator_tpu_torch.core import reservation as tr

    def conv(cls, a):
        return cls(*(None if getattr(a, f) is None else convert.tensor(getattr(a, f), device)
                     for f in cls._fields))

    g = q = r = None
    if gang is not None:
        g = tc.GangInputs(pods=conv(tg.GangPodArrays, gang.pods),
                          gangs=conv(tg.GangArrays, gang.gangs))
    if quota is not None:
        q = tc.QuotaInputs(pods=conv(tq.QuotaPodArrays, quota.pods),
                           **{f: convert.tensor(getattr(quota, f), device)
                              for f in tc.QuotaInputs._fields[1:]})
    if reservation is not None:
        r = tc.ReservationInputs(rsv=conv(tr.ReservationArrays, reservation.rsv),
                                 **{f: convert.tensor(getattr(reservation, f), device)
                                    for f in tc.ReservationInputs._fields[1:]})
    return g, q, r


def pkg(which: str):
    """One package's classes for building the same store on both sides:
    ``which`` is "jax" (the JAX package) or "torch" (the port)."""
    import types

    if which == "jax":
        import koordinator_tpu.api.model as m
        import koordinator_tpu.api.quota as q
        import koordinator_tpu.core.config as cfg
        import koordinator_tpu.core.deviceshare as ds
        import koordinator_tpu.core.numa as nm
        import koordinator_tpu.service.client as cl
        import koordinator_tpu.service.constraints as c
        import koordinator_tpu.service.engine as e
        import koordinator_tpu.service.protocol as pr
        import koordinator_tpu.service.server as sv
        import koordinator_tpu.service.state as s
    else:
        import koordinator_tpu_torch.api.model as m
        import koordinator_tpu_torch.api.quota as q
        import koordinator_tpu_torch.core.config as cfg
        import koordinator_tpu_torch.core.deviceshare as ds
        import koordinator_tpu_torch.core.numa as nm
        import koordinator_tpu_torch.service.client as cl
        import koordinator_tpu_torch.service.constraints as c
        import koordinator_tpu_torch.service.engine as e
        import koordinator_tpu_torch.service.protocol as pr
        import koordinator_tpu_torch.service.server as sv
        import koordinator_tpu_torch.service.state as s
    return types.SimpleNamespace(
        which=which, Node=m.Node, Pod=m.Pod, AssignedPod=m.AssignedPod, NodeMetric=m.NodeMetric,
        GPUDevice=ds.GPUDevice, RDMADevice=ds.RDMADevice, CPUTopology=nm.CPUTopology,
        NodeTopologyInfo=s.NodeTopologyInfo, ClusterState=s.ClusterState, Engine=e.Engine,
        GangInfo=c.GangInfo, ReservationInfo=c.ReservationInfo, engine_mod=e, state_mod=s,
        NodeFitArgs=cfg.NodeFitArgs, ScoringStrategyType=cfg.ScoringStrategyType,
        QuotaGroup=q.QuotaGroup, Client=cl.Client, proto=pr, SidecarServer=sv.SidecarServer,
    )


def sidecar(k, **kw):
    """A sidecar of one package: the JAX package's, or the port's on the
    CPU."""
    if k.which == "torch":
        kw.setdefault("device", "cpu")
    return k.SidecarServer(**kw)


def engine_of(k, st):
    """An engine over ``st``: the JAX package's, or the port's on the CPU."""
    return k.Engine(st) if k.which == "jax" else k.Engine(st, device="cpu")


def host(x):
    """A mask or score matrix as numpy (None stays None)."""
    return None if x is None else np_of(x)


GB = 1 << 30


def device_cluster(k, initial_capacity=16, device_state=True, strategy=None, shape=None):
    """The JAX package's device cluster (tests/test_state_incremental.py
    ``_device_cluster``): 12 nodes with pool/zone labels, every 4th tainted
    dedicated=ml:NoSchedule, every 3rd with 4 GPUs and one RDMA NIC, every
    5th with a 2-NUMA topology (ep-0 single-numa-node), and 6 assigned pods
    with team labels, the odd ones holding anti-affinity.  ``strategy``
    (and an RTC ``shape`` in config units) sets the NodeFit scoring
    strategy, LeastAllocated when None."""
    kw = {}
    if strategy is not None:
        args = k.NodeFitArgs(strategy=k.ScoringStrategyType(strategy))
        if shape is not None:
            args.shape = list(shape)
        kw["nf_args"] = args
    st = k.ClusterState(initial_capacity=initial_capacity, device_state=device_state, **kw)
    for i in range(12):
        name = f"ep-{i}"
        taints = ([{"key": "dedicated", "value": "ml", "effect": "NoSchedule"}]
                  if i % 4 == 0 else [])
        st.upsert_node(k.Node(name=name, allocatable={"cpu": 64000, "memory": 512 * GB,
                                                      "pods": 64},
                              labels={"pool": "gold" if i % 2 else "silver", "zone": f"z{i % 3}"},
                              taints=taints))
        if i % 3 == 0:
            st.set_devices(name, [k.GPUDevice(minor=m, numa_node=m // 2, pcie=m // 2)
                                  for m in range(4)], [k.RDMADevice(minor=0, vfs_free=4)])
        if i % 5 == 0:
            st.set_topology(name, k.NodeTopologyInfo(
                topo=k.CPUTopology(sockets=1, nodes_per_socket=2, cores_per_node=4,
                                   cpus_per_core=2),
                policy="single-numa-node" if i == 0 else "none"))
    for j in range(6):
        st.assign_pod(f"ep-{j}", k.AssignedPod(pod=k.Pod(
            name=f"held-{j}", requests={"cpu": 500}, labels={"team": f"t{j % 2}"},
            anti_affinity={"team": f"t{(j + 1) % 2}"} if j % 2 else None)))
    return st


def policy_batch(k):
    """The JAX package's mixed policy batch (``_policy_batch``)."""
    gpu, rdma = "koordinator.sh/gpu-core", "koordinator.sh/rdma"
    return [
        k.Pod(name="b-gpu", requests={"cpu": 4000, "memory": GB, gpu: 100}),
        k.Pod(name="b-share", requests={"cpu": 2000, "memory": GB, gpu: 50}),
        k.Pod(name="b-multi", requests={"cpu": 8000, "memory": GB, gpu: 200, rdma: 1}),
        k.Pod(name="b-rdma", requests={"cpu": 500, "memory": GB, rdma: 2}),
        k.Pod(name="b-lsr", requests={"cpu": 4000, "memory": GB}, qos="LSR"),
        k.Pod(name="b-sel", requests={"cpu": 1000, "memory": GB}, node_selector={"pool": "gold"},
              labels={"team": "t0"}, anti_affinity={"team": "t1"},
              tolerations=[{"key": "dedicated", "operator": "Exists", "effect": "NoSchedule"}]),
        k.Pod(name="b-plain", requests={"cpu": 1000, "memory": GB}),
    ]


EXPLAIN_NOW = 5_000_000.0


def explain_feed(k, cli):
    """tests/test_explain.py's ``_feed`` with package ``k``'s types: dense,
    gang, reservation, quota and device/selector stores, and one assumed
    cycle, sent through ``cli``."""
    nodes = [k.Node(name=f"e-n{i}", allocatable={"cpu": 16000, "memory": 64 * GB, "pods": 64},
                    labels={"zone": f"z{i % 2}"}) for i in range(8)]
    cli.apply(upserts=[k.proto.spec_only(n) for n in nodes])
    cli.apply(metrics={n.name: k.NodeMetric(
        node_usage={"cpu": 300 + 797 * min(i, 6), "memory": (1 + 3 * min(i, 6)) * GB},
        update_time=EXPLAIN_NOW, report_interval=60.0) for i, n in enumerate(nodes)})
    C = k.Client
    cli.apply_ops([
        C.op_quota_total({"cpu": 200000, "memory": 800 * GB}),
        C.op_quota(k.QuotaGroup(name="eq-root", parent="koordinator-root-quota", is_parent=True,
                                min={"cpu": 30000, "memory": 100 * GB},
                                max={"cpu": 100000, "memory": 400 * GB})),
        C.op_quota(k.QuotaGroup(name="eq", parent="eq-root", min={"cpu": 8000, "memory": 32 * GB},
                                max={"cpu": 9000, "memory": 400 * GB})),
        C.op_gang(k.GangInfo(name="eg", min_member=2, total_children=2)),
        C.op_gang(k.GangInfo(name="eg-big", min_member=5, total_children=5)),
        C.op_gang(k.GangInfo(name="eg-few", min_member=4, total_children=2)),
        C.op_reservation(k.ReservationInfo(name="er-bound", node="e-n1",
                                           allocatable={"cpu": 4000, "memory": 8 * GB})),
        C.op_devices("e-n1", [k.GPUDevice(minor=m, numa_node=m // 2) for m in range(4)],
                     rdma=[k.RDMADevice(minor=0, vfs_free=2)]),
        C.op_devices("e-n2", [k.GPUDevice(minor=0)]),
        C.op_topology("e-n3", k.NodeTopologyInfo(topo=k.CPUTopology(
            sockets=1, nodes_per_socket=2, cores_per_node=4, cpus_per_core=2))),
    ])
    gpu = "koordinator.sh/gpu-core"
    cli.schedule_full([
        k.Pod(name="g-0", requests={"cpu": 1000, "memory": 2 * GB}, gang="eg"),
        k.Pod(name="g-1", requests={"cpu": 1000, "memory": 2 * GB}, gang="eg"),
        k.Pod(name="q-0", requests={"cpu": 2000, "memory": 4 * GB}, quota="eq"),
        k.Pod(name="d-warm", requests={"cpu": 500, "memory": GB, gpu: 100}),
    ], now=EXPLAIN_NOW + 1, assume=True)


def explain_probe_pods(k):
    """tests/test_explain.py's ``_probe_pods`` with package ``k``'s types."""
    gpu, rdma = "koordinator.sh/gpu-core", "koordinator.sh/rdma"
    return [
        k.Pod(name="pr-tie", requests={"cpu": 1200, "memory": 3 * GB}),
        k.Pod(name="pr-q", requests={"cpu": 4000, "memory": GB}, quota="eq"),
        k.Pod(name="pr-q2", requests={"cpu": 4000, "memory": GB}, quota="eq"),
        k.Pod(name="pr-gpu", requests={"cpu": 500, "memory": GB, gpu: 100}),
        k.Pod(name="pr-rdma", requests={"cpu": 500, "memory": GB, rdma: 1}),
        k.Pod(name="pr-rsv", requests={"cpu": 1500, "memory": 2 * GB}, reservations=["er-bound"]),
        k.Pod(name="pr-gg0", requests={"cpu": 400, "memory": GB}, gang="eg-big"),
        k.Pod(name="pr-gg1", requests={"cpu": 400, "memory": GB}, gang="eg-big"),
        k.Pod(name="pr-few", requests={"cpu": 400, "memory": GB}, gang="eg-few"),
        k.Pod(name="pr-sel", requests={"cpu": 300, "memory": GB}, node_selector={"zone": "z1"}),
        k.Pod(name="pr-huge", requests={"cpu": 64000, "memory": GB}),
    ]
