"""DESCHEDULE over the KTPU wire: the port's sidecar beside the JAX one.

The same raw frames go to both sidecars (the port's on the CPU): a small
fleet, ReplicaSet-owned pods and ``chip_smoke.desched_frames``'s ticks,
then ticks with plugins, profiles, ``use_kernel: false`` and ``verify``,
and refused configurations; every reply byte-identical (ERROR frames carry
a traceback, so those compare by code and message).  Also the ``anomaly``
op through APPLY, the ``cmd/descheduler`` binary against the port's
sidecar, and a process where JAX cannot be imported.
"""

import os
import pathlib
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from chip_smoke import Wire, decoded, desched_frames
from koordinator_tpu.service import protocol as jp
from koordinator_tpu.service.client import Client as JClient
from koordinator_tpu.service.server import SidecarServer as JServer
from koordinator_tpu.utils.features import FeatureGates as JGates
from koordinator_tpu.utils.fixtures import NOW, random_cluster
from koordinator_tpu_torch.service.client import Client
from koordinator_tpu_torch.service.server import SidecarServer
from koordinator_tpu_torch.utils.features import FeatureGates

ROOT = pathlib.Path(__file__).resolve().parent.parent
M = jp.MsgType


def _fleet_frames(num_nodes: int, seed: int = 11) -> tuple:
    _, nodes = random_cluster(seed, num_nodes=num_nodes, num_pods=0)
    ops = []
    for n in nodes:
        ops.append(JClient.op_upsert(jp.spec_only(n)))
        if n.metric is not None:
            ops.append(JClient.op_metric(n.name, n.metric))
        ops += [JClient.op_assign(n.name, ap) for ap in n.assigned_pods]
    frames = [("APPLY fleet", jp.encode(M.APPLY, 1, {"ops": ops[i:i + 200]}))
              for i in range(0, len(ops), 200)]
    return frames, [n.name for n in nodes]


def _tick(label, fields, rid=[5000]):
    rid[0] += 1
    return label, jp.encode(M.DESCHEDULE, rid[0], dict({"now": NOW + rid[0] % 1000}, **fields))


def _stream(num_nodes: int = 60) -> list:
    frames, names = _fleet_frames(num_nodes)
    frames += desched_frames(names, 3, 5)
    pool = {"name": "hot", "node_prefix": "node-1", "low": {"cpu": 35},
            "high": {"cpu": 70, "memory": 85}, "abnormalities": 1, "weights": {"cpu": 2}}
    frames += [
        _tick("deviation pool", {"pools": [{"name": "dev", "deviation": True,
                                            "low": {"cpu": 10, "memory": 10},
                                            "high": {"cpu": 10, "memory": 10},
                                            "abnormalities": 1}]}),
        _tick("prefix pool, no percentiles", {"pools": [pool], "use_kernel": False}),
        _tick("plugins", {"use_kernel": True, "plugins": [
            "RemovePodsViolatingNodeTaints",
            {"name": "PodLifeTime", "args": {"max_pod_life_time_seconds": 5.0}}]}),
        _tick("profiles", {"profiles": [{"name": "p",
                                         "deschedule": ["RemovePodsViolatingNodeAffinity"],
                                         "balance": [{"name": "RemoveDuplicates"}]}]}),
        _tick("two pools, per-node limit, verify", {
            "verify": True, "pools": [pool, {"name": "rest", "abnormalities": 1,
                                             "low": {"cpu": 40}, "high": {"cpu": 60}}],
            "limits": {"per_node": 1, "per_namespace": 3}}),
        _tick("execute two pools", {"verify": False, "execute": True, "limits": {"total": 4}}),
        _tick("unknown plugin (refused)", {"plugins": ["NoSuchPlugin"]}),
        _tick("balance plugin under deschedule (refused)",
              {"profiles": [{"deschedule": ["RemoveDuplicates"]}]}),
        _tick("after the refusals", {"execute": True}),
    ]
    return frames


def _send_both(jsrv, tsrv, frames) -> dict:
    jw, tw = Wire(jsrv.address), Wire(tsrv.address)
    out = {}
    try:
        for label, frame in frames:
            want, got = jw.call(frame), tw.call(frame)
            wt, _, wf, _ = decoded(want)
            gt, _, gf, _ = decoded(got)
            if label.endswith("(refused)"):
                assert wt == gt == M.ERROR, label
                assert (gf["code"], gf["error"]) == (wf["code"], wf["error"]), label
            else:
                assert wt != M.ERROR, (label, wf)
                assert got == want, (label, gf, wf)
            out[label] = gf
    finally:
        jw.close()
        tw.close()
    return out


def test_deschedule_frames_byte_identical_to_jax():
    jsrv, tsrv = JServer(initial_capacity=16), SidecarServer(initial_capacity=16, device="cpu")
    try:
        replies = _send_both(jsrv, tsrv, _stream())
        assert replies["DESCHEDULE dry 3"]["plan"] and replies["DESCHEDULE execute"]["executed"]
        assert replies["DESCHEDULE execute"]["migrated"]
        assert "util" in replies["DESCHEDULE dry 1"]
        assert "util" not in replies["prefix pool, no percentiles"]
        assert replies["execute two pools"]["plan"]
        assert tsrv.state.desched_anomaly == jsrv.state.desched_anomaly
        assert tsrv.state.desched_anomaly
    finally:
        jsrv.close()
        tsrv.close()


def test_deschedule_with_the_gate_off_plans_nothing():
    gates = {"LowNodeLoad": False}
    jsrv = JServer(initial_capacity=16, gates=JGates(gates))
    tsrv = SidecarServer(initial_capacity=16, device="cpu", gates=FeatureGates(gates))
    try:
        frames, names = _fleet_frames(30)
        replies = _send_both(jsrv, tsrv, frames + desched_frames(names, 2, 3))
        assert replies["DESCHEDULE execute"] == {"plan": [], "executed": 0}
        assert tsrv._descheduler is None
    finally:
        jsrv.close()
        tsrv.close()


def test_anomaly_op_applies_through_apply():
    """The descheduler's counters as an APPLY op, as the JAX sidecar takes
    them; a fresh descheduler seeds its debounce from them."""
    op = {"op": "anomaly", "pool": "p", "names": ["node-0", "node-1"],
          "anomaly": [True, False], "ab": [0, 2], "norm": [1, 0]}
    frames, _ = _fleet_frames(20)
    frames.append(("APPLY anomaly", jp.encode(M.APPLY, 9, {"ops": [op]})))
    jsrv, tsrv = JServer(initial_capacity=16), SidecarServer(initial_capacity=16, device="cpu")
    try:
        _send_both(jsrv, tsrv, frames)
        want = {k: v for k, v in op.items() if k not in ("op", "pool")}
        assert tsrv.state.desched_anomaly == jsrv.state.desched_anomaly == {"p": want}
        _send_both(jsrv, tsrv, [_tick("seeded", {"pools": [{"name": "p", "abnormalities": 3}]})])
        (state, names), (jstate, jnames) = (tsrv._descheduler._anomaly["p"],
                                            jsrv._descheduler._anomaly["p"])
        assert names == jnames and [a.tolist() for a in state] == [
            np.asarray(a).tolist() for a in jstate]
        assert names[1] == "node-1" and int(state.ab[1]) == 2  # carried from the op
    finally:
        jsrv.close()
        tsrv.close()


def test_descheduler_binary_against_the_port_sidecar(tmp_path):
    srv = SidecarServer(initial_capacity=16, device="cpu")
    try:
        frames, names = _fleet_frames(40)
        w = Wire(srv.address)
        for _, frame in frames + desched_frames(names, 2, 3)[:-5]:  # the owned pods
            assert decoded(w.call(frame))[0] == M.APPLY
        w.close()
        (tmp_path / "wl.json").write_text('{"wl-0": 20, "wl-1": 20}')
        proc = subprocess.Popen(
            [sys.executable, "-m", "koordinator_tpu_torch.cmd.descheduler", "--sidecar",
             "%s:%d" % srv.address, "--interval", "0.2", "--execute", "--max-total", "3",
             "--workloads-json", f"@{tmp_path / 'wl.json'}",
             "--evictor-json", '{"max_per_node": 1}'],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            lines = [proc.stdout.readline().strip() for _ in range(3)]
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, err
        assert lines[0].startswith("koord-tpu-descheduler ticking every 0.2s")
        ticks = [ln for ln in lines[1:] + out.splitlines() if ln.startswith("deschedule tick")]
        assert ticks and all("plan=" in ln and "executed=" in ln for ln in ticks)
        assert srv._descheduler.arbitrator.workloads == {"wl-0": 20, "wl-1": 20}
        assert srv._descheduler.limits.total == 3
    finally:
        srv.close()


def test_deschedule_serves_with_jax_unavailable():
    """A DESCHEDULE tick that plans and executes, in a process where
    importing jax (or the JAX package) fails."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["koordinator_tpu"] = None
        from chip_smoke import Wire, decoded, desched_frames
        from koordinator_tpu_torch.service import protocol as proto
        from koordinator_tpu_torch.service.client import Client
        from koordinator_tpu_torch.service.server import SidecarServer
        from koordinator_tpu_torch.utils.fixtures import random_cluster
        _, nodes = random_cluster(11, num_nodes=40, num_pods=0)
        srv = SidecarServer(initial_capacity=16, device="cpu")
        cli = Client(*srv.address)
        cli.apply(upserts=nodes, metrics={n.name: n.metric for n in nodes if n.metric})
        w = Wire(srv.address)
        replies = [decoded(w.call(f))[2] for _, f in desched_frames([n.name for n in nodes], 2, 3)]
        assert replies[-1]["plan"] and replies[-1]["executed"] > 0, replies[-1]
        plan, executed = cli.deschedule(now=2e6, execute=False)
        w.close()
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


@pytest.mark.parametrize("verb", ["deschedule", "deschedule_full"])
def test_client_deschedule_verbs_match_jax(verb):
    """The port's ``Client.deschedule``/``deschedule_full`` beside the JAX
    client's, each against its own sidecar fed the same frames."""
    frames, names = _fleet_frames(40)
    frames += desched_frames(names, 2, 3)[:-5]
    results = []
    for srv, cls in ((JServer(initial_capacity=16), JClient),
                     (SidecarServer(initial_capacity=16, device="cpu"), Client)):
        try:
            w = Wire(srv.address)
            for _, frame in frames:
                w.call(frame)
            w.close()
            cli = cls(*srv.address)
            kw = dict(pools=[{"name": "x", "abnormalities": 1, "low": {"cpu": 30, "memory": 30},
                              "high": {"cpu": 80, "memory": 80}}],
                      workloads={"wl-0": 20, "wl-1": 20})
            if verb == "deschedule":
                results.append([cli.deschedule(now=NOW + t, execute=t == 2, limits={"total": 2},
                                               evictor={"max_per_node": 1}, **kw)
                                for t in range(3)])
            else:
                results.append([cli.deschedule_full(now=NOW + t, execute=t == 2, verify=True,
                                                    **kw) for t in range(3)])
            cli.close()
        finally:
            srv.close()
    assert results[0] == results[1]
    assert any(r[0] if verb == "deschedule" else r["plan"] for r in results[1])


def test_timed_loop_ticks_through_the_worker():
    """``start_descheduler``: a thread enqueues executing ticks into the
    worker's queue; each reply lands in ``descheduler_history``."""
    import time

    srv = SidecarServer(initial_capacity=16, device="cpu")
    try:
        frames, names = _fleet_frames(30)
        w = Wire(srv.address)
        for _, frame in frames + desched_frames(names, 2, 3)[:-5]:
            w.call(frame)
        w.close()
        srv.start_descheduler(0.05, {"pools": [{"name": "t", "abnormalities": 1,
                                                "low": {"cpu": 30, "memory": 30},
                                                "high": {"cpu": 80, "memory": 80}}],
                                     "workloads": {"wl-0": 15, "wl-1": 15}})
        deadline = time.time() + 60
        while len(srv.descheduler_history) < 2 and time.time() < deadline:
            time.sleep(0.05)
        history = list(srv.descheduler_history)
        assert len(history) >= 2 and all("migrated" in h for h in history)
        assert any(h["executed"] for h in history)
    finally:
        srv.close()
