"""The port's sidecar over the KTPU wire: the Go shim's golden transcript,
byte-identical replies beside the JAX sidecar on a churned stream, the
refusals of later slices, the binary, a process where JAX cannot be
imported, and the C++ wire client against both sidecars.

Every sidecar of the port here runs on the CPU (``device="cpu"``); the
same frames go to both sidecars as raw bytes, and the replies are compared
as raw bytes."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from chip_smoke import Wire
from chip_smoke import decoded as decode
from koordinator_tpu.api.model import BATCH_CPU, BATCH_MEMORY
from koordinator_tpu.api.quota import QuotaGroup
from koordinator_tpu.core.deviceshare import GPUDevice, RDMADevice
from koordinator_tpu.core.numa import CPUTopology
from koordinator_tpu.service import protocol as jp
from koordinator_tpu.service.client import Client as JClient
from koordinator_tpu.service.constraints import GangInfo, ReservationInfo
from koordinator_tpu.service.server import SidecarServer as JServer
from koordinator_tpu.service.state import NodeTopologyInfo
from koordinator_tpu.utils.features import FeatureGates as JGates
from koordinator_tpu.utils.fixtures import NOW, random_cluster
from koordinator_tpu_torch.service import protocol as tp
from koordinator_tpu_torch.service.client import Client
from koordinator_tpu_torch.service.server import SidecarServer
from koordinator_tpu_torch.utils.features import FeatureGates

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "shim" / "go" / "testdata" / "golden_transcript.json"
GB = 1 << 30
SCALARS = (BATCH_CPU, BATCH_MEMORY)
M = jp.MsgType


def test_go_golden_transcript_replays_byte_for_byte():
    golden = json.loads(GOLDEN.read_text())
    srv = SidecarServer(initial_capacity=8, device="cpu")
    try:
        # handshake on a throwaway client, as bench/gen_go_transcript.py does
        Client(*srv.address).close()
        wire = Wire(srv.address)
        for e in golden["entries"]:
            got = wire.call(bytes.fromhex(e["request_hex"]))
            assert got.hex() == e["response_hex"], e["name"]
        wire.close()
    finally:
        srv.close()


def _ops_for(nodes) -> list:
    ops = []
    for n in nodes:
        ops.append(JClient.op_upsert(jp.spec_only(n)))
        if n.metric is not None:
            ops.append(JClient.op_metric(n.name, n.metric))
        ops += [JClient.op_assign(n.name, ap) for ap in n.assigned_pods]
    return ops


def _pods(pods, **extra) -> list:
    return [dict(jp.pod_to_wire(p), **extra) for p in pods]


def churned_stream(seed: int = 5):
    """(name, frame bytes) of one deterministic frame stream: node upserts with
    metrics and assigned pods, gangs, quota groups, reservations, devices
    and topologies; SCORE with and without breakdown and with a stale
    names_version; SCHEDULE with and without assume; churn (metrics,
    unassigns, removes, a re-added node, store removals); EXPLAIN,
    QUOTA_REFRESH and ECHO."""
    rng = np.random.default_rng(seed)
    pods, nodes = random_cluster(seed, num_nodes=40, num_pods=40, with_aggregated=True)
    names = [n.name for n in nodes]
    out = []
    rid = iter(range(1, 1000))

    def frame(name, t, fields, arrays=None):
        out.append((name, jp.encode(t, next(rid), fields, arrays)))

    frame("hello", M.HELLO, {})
    ops = _ops_for(nodes)
    for i in range(0, len(ops), 50):
        frame(f"apply nodes {i}", M.APPLY, {"ops": ops[i:i + 50]})
    gpu, rdma = "koordinator.sh/gpu-core", "koordinator.sh/rdma"
    frame("apply stores", M.APPLY, {"ops": [
        JClient.op_quota_total({"cpu": 40 * 16000, "memory": 40 * 64 * GB}),
        JClient.op_quota(QuotaGroup(name="qa", min={"cpu": 20000, "memory": 64 * GB},
                                    max={"cpu": 60000, "memory": 256 * GB}, is_parent=True)),
        JClient.op_quota(QuotaGroup(name="qa0", parent="qa", min={"cpu": 8000, "memory": 16 * GB},
                                    max={"cpu": 9000, "memory": 128 * GB})),
        JClient.op_quota(QuotaGroup(name="qb", min={"cpu": 6000, "memory": 32 * GB},
                                    max={"cpu": 16000, "memory": 96 * GB})),
        JClient.op_gang(GangInfo(name="g0", min_member=2, total_children=3, create_time=5.0)),
        JClient.op_gang(GangInfo(name="g1", min_member=4, total_children=4, create_time=1.0)),
        JClient.op_reservation(ReservationInfo(name="r0", node=names[3],
                                               allocatable={"cpu": 4000, "memory": 8 * GB},
                                               order=2)),
        JClient.op_reservation(ReservationInfo(name="r1", node=names[5],
                                               allocatable={"cpu": 2000, "memory": 4 * GB},
                                               allocate_once=True)),
        JClient.op_devices(names[1], [GPUDevice(minor=m, numa_node=m // 2) for m in range(4)],
                           rdma=[RDMADevice(minor=0, vfs_free=2)]),
        JClient.op_devices(names[2], [GPUDevice(minor=0)]),
        JClient.op_topology(names[4], NodeTopologyInfo(topo=CPUTopology(
            sockets=1, nodes_per_socket=2, cores_per_node=4, cpus_per_core=2))),
        # an assigned pod claiming the reserve-pod identity is refused by
        # the admission webhook (the reply's rejects)
        {"op": "assign", "node": names[0], "t": NOW,
         "pod": {"name": "reserve-nope", "ns": "koord-reservation"}},
    ]})
    batch = _pods(pods[:16])
    for i, p in enumerate(batch):
        if i % 5 == 1:
            p["gang"] = "g0"
        if i % 4 == 2:
            p["quota"] = ["qa0", "qb"][i % 2]
        if i % 7 == 3:
            p["rsv"] = ["r0", "r1"]
    batch.append(jp.pod_to_wire(type(pods[0])(name="b-gpu", requests={
        "cpu": 500, "memory": GB, gpu: 100})))
    batch.append(jp.pod_to_wire(type(pods[0])(name="b-rdma", requests={
        "cpu": 500, "memory": GB, rdma: 1})))
    frame("score", M.SCORE, {"pods": batch, "now": NOW, "names_version": -1})
    frame("score breakdown", M.SCORE, {"pods": batch, "now": NOW, "names_version": 1,
                                       "breakdown": True})
    frame("schedule", M.SCHEDULE, {"pods": batch, "now": NOW + 1, "names_version": 1})
    frame("schedule assume", M.SCHEDULE, {"pods": batch, "now": NOW + 2, "names_version": 1,
                                          "assume": True})
    frame("explain", M.EXPLAIN, {"pods": batch[:6], "now": NOW + 2})
    churn = []
    for j in rng.choice(len(nodes), 8, replace=False):
        n = nodes[int(j)]
        if n.metric is not None and n.metric.node_usage:
            m = type(n.metric)(node_usage={k: v // 2 for k, v in n.metric.node_usage.items()},
                               update_time=NOW + 3, report_interval=60.0)
            churn.append(JClient.op_metric(n.name, m))
    assigned = [ap.pod.key for n in nodes for ap in n.assigned_pods]
    churn += [JClient.op_unassign(k) for k in assigned[:5]]
    churn += [JClient.op_remove(names[7]), JClient.op_remove(names[9]),
              JClient.op_upsert(jp.spec_only(nodes[9])), JClient.op_gang_remove("g1"),
              JClient.op_reservation_remove("r0"), JClient.op_devices_remove(names[2]),
              JClient.op_topology_remove(names[4]), JClient.op_quota_remove("qb")]
    frame("apply churn", M.APPLY, {"ops": churn})
    frame("score stale names", M.SCORE, {"pods": batch[:8], "now": NOW + 3, "names_version": 1,
                                         "breakdown": True})
    frame("schedule after churn", M.SCHEDULE, {"pods": batch, "now": NOW + 4,
                                               "names_version": 2})
    frame("explain after churn", M.EXPLAIN, {"pods": batch, "now": NOW + 4})
    frame("explain again (cached)", M.EXPLAIN, {"pods": batch, "now": NOW + 4})
    groups = [jp.quota_group_to_wire(QuotaGroup(
        name=f"t{i}", parent="t0" if i > 1 and i % 2 else "koordinator-root-quota",
        is_parent=i == 1, min={"cpu": 1000 * i, "memory": i * GB},
        max={"cpu": 5000 * i, "memory": 4 * i * GB})) for i in range(1, 6)]
    groups[0]["name"] = "t0"
    frame("quota refresh", M.QUOTA_REFRESH, {"groups": groups, "resources": ["cpu", "memory"],
                                             "total": {"cpu": 20000, "memory": 40 * GB}})
    frame("echo", M.ECHO, {"resp_like": [{"name": "s", "shape": [4, 8], "dtype": "<i2"}]},
          {"x": np.arange(6, dtype=np.int32)})
    frame("ping", M.PING, {})
    return out


def test_churned_stream_byte_identical_to_jax():
    jsrv = JServer(initial_capacity=16, extra_scalars=SCALARS)
    tsrv = SidecarServer(initial_capacity=16, extra_scalars=SCALARS, device="cpu")
    try:
        jw, tw = Wire(jsrv.address), Wire(tsrv.address)
        for name, frame in churned_stream():
            want, got = jw.call(frame), tw.call(frame)
            assert decode(want)[0] != M.ERROR, (name, decode(want)[2])
            assert got == want, (name, decode(got)[2], decode(want)[2])
        jw.close()
        tw.close()
    finally:
        jsrv.close()
        tsrv.close()


def _refusal(srv, frame: bytes):
    w = Wire(srv.address)
    try:
        t, _, fields, _ = decode(w.call(frame))
    finally:
        w.close()
    assert t == M.ERROR and fields["code"] == tp.ErrCode.BAD_REQUEST and not fields["retryable"]
    return fields["error"]


@pytest.mark.parametrize("verb,slice_name", [
    (M.METRICS, "observability"), (M.HEALTH, "observability"), (M.DIGEST, "observability"),
    (M.TRACE, "observability"), (M.REVOKE, "preemption"), (M.RECONCILE, "manager"),
    (M.HOOK, "runtime-hooks"), (M.SUBSCRIBE, "durability"), (M.PROMOTE, "durability"),
])
def test_other_verbs_are_refused_naming_their_slice(verb, slice_name):
    srv = SidecarServer(initial_capacity=8, device="cpu")
    try:
        msg = _refusal(srv, tp.encode(verb, 1, {}))
        assert f"the {slice_name} slice of the port" in msg and "NotImplementedError" in msg
        # NAMES has no handler in the JAX server either: an unknown verb
        assert "unknown message type 7" in _refusal(srv, tp.encode(M.NAMES, 2, {}))
    finally:
        srv.close()


def test_preempt_trailers_anomaly_and_debug_scores_are_refused():
    srv = SidecarServer(initial_capacity=8, device="cpu")
    off = SidecarServer(initial_capacity=8, device="cpu",
                        gates=FeatureGates({"ElasticQuotaPreemption": False}))
    try:
        pods = [{"name": "p", "req": {"cpu": 100}}]
        sched = tp.encode(M.SCHEDULE, 1, {"pods": pods, "now": NOW, "preempt": True})
        assert "the preemption slice" in _refusal(srv, sched)
        # with the gate off, preempt asks for nothing and SCHEDULE serves
        w = Wire(off.address)
        assert decode(w.call(sched))[0] == M.SCHEDULE
        w.close()
        ping = tp.encode(M.PING, 2, {})
        assert "the tenant trailer" in _refusal(srv, tp.with_tenant(ping, "acme"))
        assert "the QoS trailer" in _refusal(srv, tp.with_qos(ping, "batch"))
        upsert = {"op": "upsert", "node": {"name": "n0", "alloc": {"cpu": 1000}}}
        anomaly = {"op": "anomaly", "pool": "p", "names": [], "anomaly": [], "ab": [], "norm": []}
        # the descheduler's anomaly op now applies, as on the JAX sidecar
        w = Wire(srv.address)
        assert decode(w.call(tp.encode(M.APPLY, 3, {"ops": [upsert, anomaly]})))[0] == M.APPLY
        w.close()
        assert srv.state.num_live == 1
        assert srv.state.desched_anomaly == {"p": {"names": [], "anomaly": [], "ab": [],
                                                   "norm": []}}
        msg = _refusal(srv, tp.encode(M.SCORE, 4, {"pods": pods, "debug_scores": 3}))
        assert "the observability slice" in msg
        # a trace trailer is echoed, as the JAX sidecar does
        w = Wire(srv.address)
        t, _, fields, _ = decode(w.call(tp.with_trace(ping, 77)))
        w.close()
        assert t == M.PING and fields == {"gen": 0}
    finally:
        srv.close()
        off.close()


def test_sidecar_binary_serves_and_drains():
    proc = subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.sidecar", "--device", "cpu",
         "--port", "0", "--capacity", "8"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        banner = proc.stdout.readline().strip()
        assert banner.startswith("koord-tpu-sidecar listening on "), banner
        host, port = banner.rsplit(" ", 1)[1].rsplit(":", 1)
        cli = Client(host, int(port))
        from koordinator_tpu_torch.service.state import ClusterState

        assert cli.hello["capacity"] == ClusterState(initial_capacity=8).capacity
        assert cli.hello["names_version"] == 0
        assert cli.ping() == {"gen": 0}
        cli.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "koord-tpu-sidecar drained" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_sidecar_serves_with_jax_unavailable():
    """SCORE with breakdown and EXPLAIN over the wire, in a process where
    importing jax (or the JAX package) fails."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["koordinator_tpu"] = None
        from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
        from koordinator_tpu_torch.service.client import Client
        from koordinator_tpu_torch.service.server import SidecarServer
        from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster
        pods, nodes = random_cluster(2, num_nodes=30, num_pods=6)
        srv = SidecarServer(initial_capacity=8, extra_scalars=(BATCH_CPU, BATCH_MEMORY),
                            device="cpu")
        cli = Client(*srv.address)
        cli.apply(upserts=nodes, metrics={n.name: n.metric for n in nodes if n.metric})
        parts = cli.score_breakdown(pods, now=NOW)
        assert sorted(parts) == ["loadaware", "nodefit"] and parts["nodefit"].shape == (6, 30)
        rep = cli.explain(pods, now=NOW)
        names, scores, _ = cli.schedule(pods, now=NOW)
        assert [e["node"] for e in rep["explain"]] == list(names)
        cli.close()
        srv.close()
        assert not any(m == "jax" or m.startswith(("jax.", "koordinator_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.fixture(scope="module")
def shim_binary(tmp_path_factory):
    out = tmp_path_factory.mktemp("shim") / "shim_client"
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(out),
                    str(ROOT / "bench" / "shim_client.cpp")], check=True)
    return out


@pytest.mark.parametrize("default_gates", [False, True])
def test_cpp_client_bitmatches_against_both_sidecars(shim_binary, tmp_path, default_gates):
    """bench/shim_client.cpp's scenario (tests/test_shim_client_cpp.py's
    builder) against the JAX sidecar and the port's; the canonical replies
    are equal line for line.  The scenario's SCHEDULE asks for preempt:
    with ElasticQuotaPreemption off on both sidecars, which the JAX sidecar
    answers without a preemption plan, it runs as written.  Under the
    default gates it runs without that flag, and the port answers the
    SCHEDULE with it by the named ``BAD_REQUEST`` refusal of the preemption
    slice (the C++ client then stops with its ERROR exit code, 4)."""
    from test_shim_client_cpp import build_script

    script = build_script()
    lines = script.lines
    assert sum(" preempt=1" in ln for ln in lines) == 1
    scenario = tmp_path / "scenario.txt"
    scenario.write_text("\n".join(lines) + "\n")
    run_on = scenario
    if default_gates:
        run_on = tmp_path / "no-preempt.txt"
        run_on.write_text("\n".join(ln.replace(" preempt=1", "") for ln in lines) + "\n")
    gates = {} if default_gates else {"ElasticQuotaPreemption": False}
    texts = []
    for srv in (JServer(initial_capacity=32, gates=JGates(gates)),
                SidecarServer(initial_capacity=32, device="cpu", gates=FeatureGates(gates))):
        try:
            out_file = tmp_path / f"cpp-{len(texts)}.out"
            subprocess.run([str(shim_binary), *map(str, srv.address), str(run_on), str(out_file)],
                           check=True, timeout=600)
            texts.append(out_file.read_text())
        finally:
            srv.close()
    jlines, tlines = texts[0].splitlines(), texts[1].splitlines()
    for i, (j, t) in enumerate(zip(jlines, tlines)):
        assert t == j, f"line {i}: port={t!r} jax={j!r}"
    assert len(tlines) == len(jlines) and any(ln.startswith("SCHEDULE") for ln in tlines)
    if not default_gates:
        return
    srv = SidecarServer(initial_capacity=32, device="cpu")
    try:
        run = subprocess.run([str(shim_binary), *map(str, srv.address), str(scenario),
                              str(tmp_path / "refused.out")], capture_output=True, text=True,
                             timeout=600)
        assert run.returncode == 4, run.stderr
        assert "the preemption slice of the port" in run.stderr
        # the same SCHEDULE as a raw frame: the refusal's code
        _, arg = next(st for st in script.steps if st[0] == "schedule")
        frame = tp.encode(M.SCHEDULE, 1, {"pods": [jp.pod_to_wire(p) for p in arg["pods"]],
                                          "now": arg["now"], "assume": arg["assume"],
                                          "preempt": True})
        assert "the preemption slice" in _refusal(srv, frame)
    finally:
        srv.close()
