"""The explain slice: the per-plugin scores of SCORE's breakdown
(``la_score``, ``nf_score``), the LoadAware library entry point
(``loadaware_score_and_filter``), ``Engine.score_breakdown`` and
``Engine.explain``, against the JAX package on the same inputs, bit for
bit.

The plain versions face the JAX package's jitted programs under all three
NodeFit strategies; the engines face each other on plain, constraint and
device stores (the breakdown moving no residency counter); the
explanations face the JAX engine's on tests/test_explain.py's workload,
and a SCHEDULE reply of the port over the same store."""

import jax
import numpy as np
import pytest

from koordinator_tpu.core import loadaware as jla
from koordinator_tpu.core import nodefit as jnf
from koordinator_tpu_torch.core import loadaware as tla
from koordinator_tpu_torch.core import nodefit as tnf
from torch_parity import (
    EXPLAIN_NOW,
    NON_MONOTONE,
    STRATEGIES,
    assert_same,
    batch,
    device_cluster,
    engine_of,
    explain_feed,
    explain_probe_pods,
    pkg,
    policy_batch,
    sidecar,
    to_jax,
    to_torch,
)

_J_LA = jax.jit(jla.loadaware_score)
_J_NF = jax.jit(jnf.nodefit_score, static_argnums=(2,))


@pytest.mark.parametrize("strategy,shape", [
    ("LeastAllocated", None), ("MostAllocated", None),
    ("RequestedToCapacityRatio", None), ("RequestedToCapacityRatio", [(0, 0), (100, 10)]),
])
@pytest.mark.parametrize("P,N,seed", [(7, 33, 0), (64, 300, 1)])
def test_plugin_scores_match_jax_jits(strategy, shape, P, N, seed):
    """``la_score`` and ``nf_score``'s plain versions (the wrappers on CPU
    tensors) against the JAX engine's jits (service/engine.py:1169-1175),
    and ``loadaware_score_and_filter`` against JAX's."""
    b = batch(P, N, seed, strategy, shape)
    j, t = to_jax(b), to_torch(b)
    assert_same(tla.loadaware_score(t[0], t[1], t[2]), _J_LA(j[0], j[1], j[2]), "la_score")
    assert_same(tnf.nodefit_score(t[3], t[4], t[5]), _J_NF(j[3], j[4], j[5]),
                f"nf_score {strategy}")
    ts, tf_ = tla.loadaware_score_and_filter(t[0], t[1], t[2])
    js, jf = jla.loadaware_score_and_filter(j[0], j[1], j[2])
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tf_.numpy(), np.asarray(jf))
    # the plain versions are what the wrappers return on the CPU
    assert_same(tnf.nodefit_score(t[3], t[4], t[5]), tnf.nodefit_score_plain(t[3], t[4], t[5]))
    assert_same(ts, tla.loadaware_score_plain(t[0], t[1], t[2]))


def _residency_counters(st) -> tuple:
    r = st.residency
    return (r.h2d_bytes_total, r.full_uploads, r.scatters, r.extends, r.verifies,
            r.last_dirty_rows, r._reads)


def _breakdown_twins(jst, tst, jpods, tpods, now):
    je, te = engine_of(pkg("jax"), jst), engine_of(pkg("torch"), tst)
    # a SCORE first: the residency is bound and warm
    assert_same(te.score(tpods, now=now)[0], je.score(jpods, now=now)[0], "score")
    before = _residency_counters(tst)
    (jout, jsnap), (tout, tsnap) = je.score_breakdown(jpods, now=now), te.score_breakdown(
        tpods, now=now)
    assert _residency_counters(tst) == before, "score_breakdown moved a residency counter"
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert_same(tout[k], jout[k], f"breakdown {k}")
    assert tsnap.generation == jsnap.generation
    return tout


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_score_breakdown_plain_store(strategy):
    from koordinator_tpu.api.model import BATCH_CPU, BATCH_MEMORY

    out = {}
    for which in ("jax", "torch"):
        k = pkg(which)
        fx = __import__(f"{'koordinator_tpu' if which == 'jax' else 'koordinator_tpu_torch'}"
                        ".utils.fixtures", fromlist=["random_cluster"])
        args = k.NodeFitArgs(strategy=k.ScoringStrategyType(strategy))
        if strategy == "RequestedToCapacityRatio":
            args.shape = list(NON_MONOTONE)
        st = k.ClusterState(nf_args=args, extra_scalars=(BATCH_CPU, BATCH_MEMORY),
                            initial_capacity=16, **({"device_state": False}
                                                    if which == "jax" else {}))
        pods, nodes = fx.random_cluster(11, num_nodes=60, num_pods=20, with_aggregated=True)
        for n in nodes:
            st.upsert_node(n)
        out[which] = (st, pods)
    tout = _breakdown_twins(out["jax"][0], out["torch"][0], out["jax"][1], out["torch"][1],
                            fx.NOW)
    assert "extra" not in tout and tout["loadaware"].shape == (20, out["torch"][0].capacity)
    assert tout["loadaware"].any() and tout["nodefit"].any()


def test_score_breakdown_constraint_store():
    """Gangs, a quota tree and reservations in the store and on the pods:
    the breakdown ignores them, as the JAX engine's does."""
    from test_torch_engine_constraints import _batch, _sides

    sides = _sides(40, 31)
    batches = [_batch(s, 31, 24, "p") for s in sides]
    _breakdown_twins(sides[0].state, sides[1].state, batches[0], batches[1], EXPLAIN_NOW)


@pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated"])
def test_score_breakdown_device_store(strategy):
    """The device cluster and the mixed policy batch: 'extra' is present,
    pre-weighted, exactly as the JAX engine serves it."""
    jk, tk = pkg("jax"), pkg("torch")
    jst = device_cluster(jk, device_state=False, strategy=strategy)
    tst = device_cluster(tk, strategy=strategy)
    tout = _breakdown_twins(jst, tst, policy_batch(jk), policy_batch(tk), EXPLAIN_NOW)
    assert "extra" in tout and tout["extra"].any()


def test_explain_matches_jax_and_the_schedule_reply():
    """``Engine.explain`` over tests/test_explain.py's ``_feed`` store and
    ``_probe_pods``: every entry dict-equal to the JAX engine's, and the
    chosen nodes and totals equal to the port's SCHEDULE over the same
    store."""
    entries, servers = {}, []
    try:
        for which in ("jax", "torch"):
            k = pkg(which)
            srv = sidecar(k, initial_capacity=16)
            servers.append(srv)
            cli = k.Client(*srv.address)
            explain_feed(k, cli)
            entries[which] = srv.engine.explain(explain_probe_pods(k), now=EXPLAIN_NOW + 10)
            if which == "torch":
                names, scores, _ = cli.schedule(explain_probe_pods(k), now=EXPLAIN_NOW + 10)
            cli.close()
    finally:
        for srv in servers:
            srv.close()
    assert entries["torch"] == entries["jax"]
    assert [e["node"] for e in entries["torch"]] == list(names)
    assert [e["total"] for e in entries["torch"]] == [int(s) for s in scores]
    by_pod = {e["pod"]: e for e in entries["torch"]}
    assert by_pod["default/pr-gg0"].get("demoted") == "GangPermit"
    assert not by_pod["default/pr-few"]["stages"]["gang"]["ok"]
    assert "Device" in by_pod["default/pr-gpu"]["infeasible"]["e-n0"]


def test_explain_on_a_random_store_matches_jax():
    """A plain fleet with metrics and assigned pods: the decomposition of a
    batch equals the JAX engine's, and the port's own SCHEDULE."""
    from koordinator_tpu.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu.utils import fixtures as jfx
    from koordinator_tpu_torch.utils import fixtures as tfx

    out = {}
    for which, fx in (("jax", jfx), ("torch", tfx)):
        k = pkg(which)
        st = k.ClusterState(extra_scalars=(BATCH_CPU, BATCH_MEMORY), initial_capacity=16)
        pods, nodes = fx.random_cluster(3, num_nodes=40, num_pods=12)
        for n in nodes:
            st.upsert_node(n)
        out[which] = (engine_of(k, st), pods)
    (je, jp), (te, tp) = out["jax"], out["torch"]
    got = te.explain(tp, now=jfx.NOW)
    assert got == je.explain(jp, now=jfx.NOW)
    hosts, scores, snap, _ = te.schedule(tp, now=jfx.NOW)
    assert [e["node"] for e in got] == [snap.names[h] if h >= 0 else None for h in hosts]
    assert [e["total"] for e in got] == [int(s) for s in scores]
