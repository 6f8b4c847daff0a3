"""The placement-policy path of the port against the JAX package: the
``placement`` kernel's plain version against the JAX ``placement`` jit, the
engine's node-selector/taint/anti-affinity mask against the JAX engine's
and both host-loop oracles on churned stores, the store's label indexes,
the engine cases of the JAX package's evictor tests, the resident policy
table through vocabulary growth (``dstate_extend``), and a policy change
refreshing a warm SCHEDULE carry that then equals a cold twin and the JAX
engine — bit for bit."""

import copy

import numpy as np
import pytest
import torch

from koordinator_tpu.service.engine import _shared_jits
from koordinator_tpu.utils.fixtures import NOW
from koordinator_tpu_torch.core import placement as pl
from torch_parity import GB, assert_same, device_cluster, engine_of, host, pkg, policy_batch

CPU, MEMORY = "cpu", "memory"


# ------------------------------------------------------------------ kernel


@pytest.mark.parametrize("M,N,Lb,Tb,Sb,Gb,seed", [
    (8, 40, 16, 8, 8, 8, 0),
    (16, 300, 64, 4, 16, 32, 1),
    (8, 20, 0, 0, 0, 0, 2),  # empty vocabularies
    (4, 1, 8, 8, 8, 8, 3),
])
def test_placement_plain_matches_jax_jit(M, N, Lb, Tb, Sb, Gb, seed):
    """Dense indicator rows for the JAX jit and their CSR lists for the
    port, from one numpy draw; selectors with pairs absent from the vocab
    (counted in ``sel_cnt``, never matched) included."""
    rng = np.random.default_rng(seed)

    def ind(rows, cols, p):
        return rng.random((rows, cols)) < p

    sel_need = ind(M, Lb, 3.0 / max(Lb, 1))
    absent = rng.integers(0, 2, M) * (np.arange(M) % 3 == 0)
    sel_cnt = (sel_need.sum(axis=1) + absent).astype(np.int32)
    tol_bad, hold_hit, aa_hit = ind(M, Tb, 0.4), ind(M, Sb, 0.2), ind(M, Gb, 0.2)
    labels, taints = ind(N, Lb, 0.3), ind(N, Tb, 0.1)
    aa_cnt = (rng.integers(0, 3, (N, Sb)) * ind(N, Sb, 0.1)).astype(np.int32)
    sig_cnt = (rng.integers(0, 3, (N, Gb)) * ind(N, Gb, 0.1)).astype(np.int32)
    want = _shared_jits()["placement"](sel_need, sel_cnt, tol_bad, hold_hit, aa_hit, labels,
                                       taints, aa_cnt, sig_cnt)

    def lists(dense):
        return pl.csr([np.flatnonzero(r).tolist() for r in dense])

    sigs = pl.PlacementSigs(*lists(sel_need), torch.from_numpy(sel_cnt), *lists(tol_bad),
                            *lists(hold_hit), *lists(aa_hit))
    rows = tuple(torch.from_numpy(a) for a in (labels, taints, aa_cnt, sig_cnt))
    assert_same(pl.placement(sigs, *rows), want, "placement")
    assert_same(pl.placement_plain(sigs, *rows), want, "placement_plain")


def test_placement_refuses_bad_inputs_before_any_work():
    sigs, rows = _tiny_sigs()
    bad_rows = (rows[0].to(torch.int32),) + rows[1:]
    with pytest.raises(ValueError, match="labels"):
        pl.placement(sigs, *bad_rows)
    with pytest.raises(ValueError, match="indices outside"):
        pl.placement(sigs._replace(sel_idx=torch.tensor([99], dtype=torch.int32)), *rows)
    with pytest.raises(ValueError, match="not a partition"):
        pl.placement(sigs._replace(sel_off=torch.tensor([0, 2], dtype=torch.int32)), *rows)
    with pytest.raises(ValueError, match="host offsets"):
        pl.placement(sigs._replace(tol_off=sigs.tol_off.to(torch.int64)), *rows)


_EDGE_CASES = ("every list empty", "a signature with no lists", "indices listed twice",
               "absent selector pairs")


@pytest.mark.parametrize("case", _EDGE_CASES)
def test_placement_plain_edge_cases_match_jax_jit(case):
    """The plain version on the lists' edge cases against the JAX jit, from
    one numpy draw: the JAX form takes each signature's list entries as
    int32 counts over the vocabulary (an index listed twice counts two),
    the port the lists themselves; holder counts may be negative (a sum
    <= 0 stays open)."""
    rng = np.random.default_rng(_EDGE_CASES.index(case) + 40)
    M, N, widths = 7, 50, (12, 4, 6, 6)
    lists = [[sorted(rng.choice(w, int(rng.integers(1, 4)), replace=False).tolist())
              for _ in range(M)] for w in widths]
    sel_cnt = np.array([len(x) for x in lists[0]], dtype=np.int32)
    if case == "every list empty":
        lists = [[[] for _ in range(M)] for _ in widths]
        sel_cnt = (np.arange(M) % 2).astype(np.int32)  # the odd ones name an absent pair
    elif case == "a signature with no lists":
        for t in range(4):
            lists[t][2] = []
        sel_cnt[2] = 0
    elif case == "indices listed twice":
        lists = [[x + x[:1] for x in tl] for tl in lists]
        sel_cnt = np.array([len(x) for x in lists[0]], dtype=np.int32)
    else:
        sel_cnt[::2] += 1
    dense = []
    for tl, w in zip(lists, widths):
        a = np.zeros((M, w), dtype=np.int32)
        for m, x in enumerate(tl):
            np.add.at(a[m], x, 1)
        dense.append(a)
    labels, taints = rng.random((N, widths[0])) < 0.6, rng.random((N, widths[1])) < 0.1
    aa_cnt = (rng.integers(-2, 3, (N, widths[2])) * (rng.random((N, widths[2])) < 0.3)
              ).astype(np.int32)
    sig_cnt = (rng.integers(0, 3, (N, widths[3])) * (rng.random((N, widths[3])) < 0.2)
               ).astype(np.int32)
    want = _shared_jits()["placement"](dense[0], sel_cnt, dense[1], dense[2], dense[3], labels,
                                       taints, aa_cnt, sig_cnt)
    sigs = pl.PlacementSigs(*pl.csr(lists[0]), torch.from_numpy(sel_cnt), *pl.csr(lists[1]),
                            *pl.csr(lists[2]), *pl.csr(lists[3]))
    rows = tuple(torch.from_numpy(a) for a in (labels, taints, aa_cnt, sig_cnt))
    assert 0 < int(np.asarray(want).sum()) < M * N or case == "every list empty"
    assert_same(pl.placement(sigs, *rows), want, case)
    assert_same(pl.placement_plain(sigs, *rows), want, case)


# ------------------------------------------------------------- the plan

_PLAN_WRAP = """
#include "placeplan.cuh"
static koord_place::Plan g;
extern "C" int plan(const int* flat, int M, const int* dims, int budget, int* info, int* out,
                    int cap) {
  info[0] = koord_place::make_plan(flat, M, dims, dims + 4, budget, g);
  info[1] = (int)g.desc.size();
  info[2] = g.smem;
  info[3] = g.carries;
  if (info[0] == 0 && info[1] <= cap) std::copy(g.desc.begin(), g.desc.end(), out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/placeplan.cuh (the library's host plan, plain C++) built with
    g++ behind a one-function C wrapper."""
    import ctypes
    import subprocess
    from pathlib import Path

    d = tmp_path_factory.mktemp("placeplan")
    (d / "wrap.cpp").write_text(_PLAN_WRAP)
    csrc = Path(pl.__file__).resolve().parent.parent / "csrc"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{csrc}", "-o",
                    str(d / "libplan.so"), str(d / "wrap.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libplan.so"))
    lib.plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib


def _plan(lib, sigs, rows, budget):
    import ctypes

    flat, dims = pl.host_lists(sigs, rows)
    info = (ctypes.c_int * 4)()
    out = np.zeros(1 << 20, dtype=np.int32)
    lib.plan(flat.data_ptr(), sigs.sel_cnt.shape[0], dims, budget, info, out.ctypes.data,
             out.size)
    return info[0], out[:info[1]].copy(), info[2], bool(info[3])


_TILE_BYTES = (1, 1, 4, 4)  # an element of each table in shared memory
_SEG_WORDS = 12  # a segment's words in the descriptor (csrc/placeplan.cuh kSegWords)


def _read_as_the_kernel(desc, rows, smem, budget):
    """csrc/placement.cu's ``placement_tile`` over a plan's descriptor, its
    tiles taken at once: each phase's segments' union columns gathered
    (their shared memory inside the plan's and the budget), each
    signature's entries inside a segment summed, a table's sums carried
    across phases, the verdicts ANDed.  Returns the [M, N] mask."""
    d = desc.astype(np.int64)
    M, P = int(d[0]), int(d[1])
    sel = d[d[3]:d[3] + M]
    host = [r.numpy().astype(np.int64) for r in rows]
    N = host[0].shape[0]
    out = np.zeros((M, N), dtype=bool)
    acc = np.zeros((M, N), dtype=np.int64)
    at = 4 + 2 * P
    for ph in range(P):
        segs = [d[at + _SEG_WORDS * s: at + _SEG_WORDS * (s + 1)].tolist()
                for s in range(int(d[4 + 2 * ph]), int(d[5 + 2 * ph]))]
        assert len(segs) <= 4 and len({s[0] for s in segs}) == len(segs)
        end = cols = 0
        for t, u0, u1, stride, off, _, _, _, _, _, _, first in segs:
            size = (pl.PLACEMENT_TILE * stride * _TILE_BYTES[t] + 15) & ~15
            assert stride == (u1 - u0) | 1 and off >= end and first == cols
            cols += u1 - u0
            if u1 > u0:
                end = off + size
        assert end <= smem <= budget
        gathered = [host[t][:, d[co + u0:co + u1] - cb]
                    for t, u0, u1, _, _, _, _, _, _, co, cb, _ in segs]
        for m in range(M):
            ok = np.ones(N, dtype=bool) if ph == 0 else out[m].copy()
            for (t, u0, u1, _, _, fl, b, e, po, _, _, _), g in zip(segs, gathered):
                p = d[po + d[b + m]:po + d[e + m]] - u0
                p = p[(p >= 0) & (p < u1 - u0)]
                total = g[:, p].sum(axis=1) + (0 if fl & 1 else acc[m])
                if not fl & 2:
                    acc[m] = total
                else:
                    ok &= (total == sel[m]) if t == 0 else (total <= 0)
            out[m] = ok
    return out


@pytest.mark.parametrize("budget", [pl.PLACEMENT_SMEM, 1024, 256])
def test_library_plan_read_as_the_kernel_reads_it(plan_lib, budget):
    """The library's host plan (csrc/placeplan.cuh, built here with g++) on
    ``chip_smoke.placement_cases`` and the kernel table's shape cut to 300
    nodes: each descriptor read as the kernel reads it equals the plain
    version, with the phases' shared memory inside the plan's figure and
    the budget; budgets of 1,024 and 256 bytes split every table across
    phases (a table's sums carried, entries outside a phase's columns left
    to the next)."""
    import chip_smoke

    cpu = torch.device("cpu")
    cases = chip_smoke.placement_cases(cpu) + [
        ("the table's shape, 300 nodes", *chip_smoke.placement_inputs(cpu, 64, 300, 16_384,
                                                                         27))]
    for label, sigs, rows in cases:
        status, desc, smem, carries = _plan(plan_lib, sigs, rows, budget)
        assert status == 0, label
        if budget == pl.PLACEMENT_SMEM:
            assert carries == ("phases" in label), label
        got = _read_as_the_kernel(desc, rows, smem, budget)
        assert np.array_equal(got, pl.placement_plain(sigs, *rows).numpy()), label


def test_library_plan_refuses_what_the_checks_refuse(plan_lib):
    """Offsets that are not a partition and indices outside a table are
    refused by the library's plan as by the sequential checks."""
    sigs, rows = _tiny_sigs()
    assert _plan(plan_lib, sigs, rows, pl.PLACEMENT_SMEM)[0] == 0
    for bad in (sigs._replace(sel_idx=torch.tensor([99], dtype=torch.int32)),
                sigs._replace(sel_idx=torch.tensor([-1], dtype=torch.int32)),
                sigs._replace(sel_off=torch.tensor([0, 2], dtype=torch.int32)),
                sigs._replace(tol_off=torch.tensor([1, 0], dtype=torch.int32))):
        assert _plan(plan_lib, bad, rows, pl.PLACEMENT_SMEM)[0] == -1
        with pytest.raises(ValueError):
            pl.placement(bad, *rows)


def _tiny_sigs():
    sigs = pl.PlacementSigs(*pl.csr([[0]]), torch.tensor([1], dtype=torch.int32), *pl.csr([[]]),
                            *pl.csr([[]]), *pl.csr([[]]))
    rows = (torch.ones((3, 4), dtype=torch.bool), torch.zeros((3, 2), dtype=torch.bool),
            torch.zeros((3, 2), dtype=torch.int32), torch.zeros((3, 2), dtype=torch.int32))
    return sigs, rows


# ------------------------------------------------------------- the store


def test_label_indexes_track_churn_like_jax():
    """The inverted label indexes, the tainted/holder sets, the vocabularies
    and the dense policy rows follow label changes, pod moves and node
    removal exactly as the JAX store's."""
    def drive(k):
        st = k.ClusterState(initial_capacity=8)
        st.upsert_node(k.Node(name="i-a", allocatable={CPU: 1000},
                              labels={"pool": "gold", "zone": "z1"}))
        st.upsert_node(k.Node(name="i-b", allocatable={CPU: 1000}, labels={"pool": "gold"},
                              taints=[{"key": "k", "value": "v", "effect": "NoExecute"}]))
        st.upsert_node(k.Node(name="i-a", allocatable={CPU: 1000}, labels={"pool": "silver"}))
        p1 = k.Pod(name="ip-1", labels={"app": "web", "tier": "fe"}, anti_affinity={"app": "db"})
        p2 = k.Pod(name="ip-2", labels={"app": "web"})
        st.assign_pod("i-a", k.AssignedPod(pod=p1))
        st.assign_pod("i-b", k.AssignedPod(pod=p2))
        st.assign_pod("i-b", k.AssignedPod(pod=p1))
        st.unassign_pod("default/ip-2")
        snaps = [_policy_state(st)]
        st.remove_node("i-b")
        snaps.append(_policy_state(st))
        return snaps

    assert drive(pkg("torch")) == drive(pkg("jax"))


def _policy_state(st):
    return (
        sorted((k, sorted(v)) for k, v in st._node_label_rows.items()),
        sorted((k, sorted(v.items())) for k, v in st._pod_label_rows.items()),
        sorted(st._tainted_nodes), sorted(st._aa_holder_count.items()),
        list(st._label_vocab.items()), list(st._taint_vocab.items()),
        list(st._aa_vocab.items()), list(st._sig_vocab.items()),
        [a.tolist() for a in (st._pp_label, st._pp_taint, st._pp_aa, st._pp_sig,
                              st._pp_row_ver)],
        st.policy_epoch, st.device_epoch,
    )


def _toleration_batch(k):
    """Equal, Exists and empty-effect tolerations, a holder-selected pod
    and an anti-affine one, on top of the JAX package's policy batch."""
    return policy_batch(k) + [
        k.Pod(name="t-equal", requests={CPU: 500, MEMORY: GB},
              tolerations=[{"key": "dedicated", "operator": "Equal", "value": "ml",
                            "effect": "NoSchedule"}]),
        k.Pod(name="t-wrong", requests={CPU: 500, MEMORY: GB},
              tolerations=[{"key": "dedicated", "operator": "Equal", "value": "db",
                            "effect": "NoSchedule"}]),
        k.Pod(name="t-any", requests={CPU: 500, MEMORY: GB},
              tolerations=[{"key": "", "operator": "Exists"}]),
        k.Pod(name="t-noeffect", requests={CPU: 500, MEMORY: GB},
              tolerations=[{"key": "dedicated", "operator": "Exists"}]),
        k.Pod(name="held-by", requests={CPU: 500, MEMORY: GB}, labels={"team": "t0"}),
        k.Pod(name="anti", requests={CPU: 500, MEMORY: GB}, anti_affinity={"team": "t1"},
              node_selector={"zone": "z1", "absent": "pair"}),
    ]


def _mutations(k, st):
    def relabel(name, labels):
        spec = copy.copy(st._nodes[name])
        spec.labels = labels
        st.upsert_node(spec)

    return [
        lambda: relabel("ep-1", {"pool": "bronze"}),
        lambda: relabel("ep-3", dict(st._nodes["ep-3"].labels, flip="x")),
        lambda: st.assign_pod("ep-5", k.AssignedPod(pod=k.Pod(
            name="aa-new", labels={"team": "t1"}, anti_affinity={"team": "t0"}))),
        lambda: st.set_devices("ep-3", [k.GPUDevice(minor=0, numa_node=0)],
                               [k.RDMADevice(minor=0, vfs_free=1)]),
        lambda: st.note_device_alloc("default/burn", "ep-0", [(0, 100, 100)], [], []),
        lambda: st.unassign_pod("default/held-1"),
        lambda: st.remove_node("ep-6"),
    ]


def test_node_selector_mask_matches_jax_and_host_oracles():
    """After each mutation class the port's mask (cached rows where the
    epoch holds, recomputed where it moved) equals the JAX engine's and
    both host-loop oracles; the device inputs ride along."""
    sides = {w: pkg(w) for w in ("jax", "torch")}
    st = {w: device_cluster(k) for w, k in sides.items()}
    eng = {w: engine_of(sides[w], st[w]) for w in sides}
    pods = {w: _toleration_batch(k) for w, k in sides.items()}
    muts = {w: _mutations(sides[w], st[w]) for w in sides}
    cached = None
    for step in range(len(muts["jax"]) + 1):
        if step:
            for w in sides:
                muts[w][step - 1]()
        for s in st.values():
            s.publish(NOW)
        cap = st["jax"].capacity
        got = host(eng["torch"]._node_selector_mask(pods["torch"], 16, cap))
        want = eng["jax"]._node_selector_mask(pods["jax"], 16, cap)
        assert_same(got, want, f"mask after mutation {step}")
        assert_same(got, sides["torch"].engine_mod.placement_mask_host(
            st["torch"], pods["torch"], 16, cap), f"port oracle after mutation {step}")
        assert_same(got, sides["jax"].engine_mod.placement_mask_host(
            st["jax"], pods["jax"], 16, cap), f"JAX oracle after mutation {step}")
        xt = eng["torch"]._numa_device_inputs(pods["torch"], 16, cap)
        xj = eng["jax"]._numa_device_inputs(pods["jax"], 16, cap)
        assert_same(host(xt[0]), xj[0])
        assert_same(host(xt[1]), xj[1])
        if step == 0:
            cached = dict(eng["torch"]._sel_rows)
            eng["torch"]._node_selector_mask(pods["torch"], 16, cap)
            assert all(eng["torch"]._sel_rows[key] is row for key, row in cached.items())


def _node(k, name, taints=(), rng=None):
    """An 8-core node with a fresh NodeMetric; from ``random_node`` when
    ``rng`` is given, as the JAX package's evictor tests build theirs."""
    if rng is None:
        n = k.Node(name=name)
    else:
        from koordinator_tpu.utils import fixtures as jfx
        from koordinator_tpu_torch.utils import fixtures as tfx

        n = (jfx if k.which == "jax" else tfx).random_node(rng, name, pods_per_node=1)
        n.assigned_pods = []
    n.allocatable = {CPU: 8000, MEMORY: 32 * GB, "pods": 64}
    n.taints = list(taints)
    n.metric = k.NodeMetric(node_usage={CPU: 100, MEMORY: GB}, update_time=NOW,
                            report_interval=60.0)
    return n


def _evictor_cases(k):
    """tests/test_evictor.py::test_engine_enforces_taints_and_antiaffinity_at_placement
    and ::test_in_batch_antiaffinity_demotes_second_pod through one
    package's engine; returns every served result and the port's
    demotion counts."""
    out = []

    def sched(eng, pods, now):
        hosts, scores, snap, allocs = eng.schedule(pods, now=now, assume=True)
        out.append(([snap.names[h] if h >= 0 else None for h in hosts], scores.tolist(), allocs,
                    getattr(eng, "last_demotions", None)))
        return out[-1][0]

    def score(eng, pods):
        totals, feas, snap = eng.score(pods, now=NOW)
        out.append((totals.tolist(), feas.tolist(), list(snap.names)))
        return feas, snap

    rng = np.random.default_rng(41)
    st = k.ClusterState(initial_capacity=4)
    for nm in ("pp-a", "pp-b", "pp-c"):
        taints = [{"key": "maint", "effect": "NoSchedule"}] if nm != "pp-c" else []
        st.upsert_node(_node(k, nm, taints, rng))
    eng = engine_of(k, st)
    assert sched(eng, [k.Pod(name="into", requests={CPU: 1000, MEMORY: GB})], NOW) == ["pp-c"]
    feas, snap = score(eng, [k.Pod(name="tol", requests={CPU: 1000, MEMORY: GB},
                                   tolerations=[{"key": "maint", "operator": "Exists"}])])
    assert feas[0][snap.names.index("pp-a")]
    h1 = sched(eng, [k.Pod(name="holder", requests={CPU: 1000, MEMORY: GB},
                           labels={"team": "x"}, anti_affinity={"team": "x"})], NOW)
    feas, snap = score(eng, [k.Pod(name="clash", requests={CPU: 1000, MEMORY: GB},
                                   labels={"team": "x"})])
    assert not feas[0][snap.names.index(h1[0])]

    rng = np.random.default_rng(42)
    st = k.ClusterState(initial_capacity=4)
    st.upsert_node(_node(k, "only", rng=rng))
    eng = engine_of(k, st)
    pair = [k.Pod(name="h", requests={CPU: 1000, MEMORY: GB}, labels={"team": "x"},
                  anti_affinity={"team": "x"}),
            k.Pod(name="c", requests={CPU: 1000, MEMORY: GB}, labels={"team": "x"})]
    assert sum(h is not None for h in sched(eng, pair, NOW)) == 1
    st.upsert_node(_node(k, "second", rng=rng))
    pair2 = [k.Pod(name="h3", requests={CPU: 1000, MEMORY: GB}, labels={"team": "y"},
                   anti_affinity={"team": "y"}),
             k.Pod(name="c3", requests={CPU: 1000, MEMORY: GB}, labels={"team": "y"})]
    hosts = sched(eng, pair2, NOW + 1)
    assert None not in hosts and hosts[0] != hosts[1]
    return out


def test_evictor_placement_cases_match_jax():
    t, j = _evictor_cases(pkg("torch")), _evictor_cases(pkg("jax"))
    assert t[4][3] == {"anti_affinity": 1, "devices": 0}  # the pair's demotion
    strip = lambda log: [e[:3] if len(e) == 4 else e for e in log]  # noqa: E731
    assert strip(t) == strip(j)


# ------------------------------------------------- residency and warm start


def test_vocab_growth_extends_resident_policy_table_warm():
    """Label-vocabulary growth past its bucket widens the resident policy
    table with ``dstate_extend`` (no wholesale upload), the table verifies
    against the host bytes, and the engine serves what a residency-off
    twin and the JAX engine serve (tests/test_device_residency.py)."""
    t, j = pkg("torch"), pkg("jax")
    st_a = t.ClusterState(initial_capacity=16)
    st_b = t.ClusterState(initial_capacity=16, device_state=False)
    st_j = j.ClusterState(initial_capacity=16, device_state=False)
    for st, k in ((st_a, t), (st_b, t), (st_j, j)):
        for i in range(12):
            node = _node(k, f"v-{i}")
            node.labels = {"zone": f"z{i % 3}"}
            st.upsert_node(node)
    ea, eb, ej = (engine_of(t, st_a), engine_of(t, st_b), engine_of(j, st_j))

    def serve(now, pods_t, pods_j, call="score"):
        got = [getattr(e, call)(pods_t, now=now) for e in (ea, eb)]
        want = getattr(ej, call)(pods_j, now=now)
        for g in got:
            for a, b in zip(g[:2], want[:2]):
                assert_same(a, b)

    sel = lambda k: [k.Pod(name="vg", requests={CPU: 300, MEMORY: GB},  # noqa: E731
                           node_selector={"zone": "z1"})]
    serve(NOW + 1, sel(t), sel(j))
    res = st_a.residency
    assert res.is_warm("policy") and res.extends == 0
    uploads = res.full_uploads
    for st, k in ((st_a, t), (st_b, t), (st_j, j)):
        for i in range(12):
            st.upsert_node(k.Node(name=f"v-{i}", allocatable={CPU: 8000, MEMORY: 32 * GB},
                                  labels={"zone": f"z{i % 3}", "rack": f"r{i}"}))
    serve(NOW + 2, sel(t), sel(j))
    assert res.extends > 0 and res.full_uploads == uploads
    assert res.verify() == 19 + 4
    rack = lambda k: [k.Pod(name="vg-r3", requests={CPU: 300, MEMORY: GB},  # noqa: E731
                            node_selector={"rack": "r3"})]
    serve(NOW + 3, rack(t), rack(j), call="schedule")
    assert res.full_uploads == uploads and res.verify() == 19 + 4


def test_policy_change_refreshes_warm_carry():
    """A label flip and a new anti-affinity holder move only their rows'
    policy stamps: the warm carry refreshes exactly those rows (with the
    metric rows), and the warm result equals a warm-disabled twin and the
    JAX engine, allocation records included."""
    sides = {w: pkg(w) for w in ("jax", "torch")}
    st = {w: device_cluster(k) for w, k in sides.items()}
    st["cold"] = device_cluster(sides["torch"])
    eng = {w: engine_of(sides["torch" if w == "cold" else w], st[w]) for w in st}
    eng["cold"].sched_warm_enabled = False
    pods = {w: _toleration_batch(sides["torch" if w == "cold" else w]) for w in st}
    warm0 = None
    for step in range(3):
        if step == 1:
            for w, s in st.items():
                k = sides["torch" if w == "cold" else w]
                spec = copy.copy(s._nodes["ep-7"])
                spec.labels = {"pool": "silver", "zone": "z1"}
                s.upsert_node(spec)
        if step == 2:
            for w, s in st.items():
                k = sides["torch" if w == "cold" else w]
                s.assign_pod("ep-9", k.AssignedPod(pod=k.Pod(
                    name="late", labels={"team": "t0"}, anti_affinity={"team": "t1"})))
        vers = st["torch"].sched_versions()
        out = {w: eng[w].schedule(pods[w], now=NOW + step) for w in st}
        if step:
            assert eng["torch"].sched_warm_hits == warm0 + 1
            assert eng["torch"].sched_last_dirty == len(st["torch"].sched_dirty_rows(vers)) == 1
        warm0 = eng["torch"].sched_warm_hits
        for w in ("cold", "jax"):
            assert_same(out["torch"][0], out[w][0], f"step {step} hosts vs {w}")
            assert_same(out["torch"][1], out[w][1], f"step {step} scores vs {w}")
            assert out["torch"][3] == out[w][3]
