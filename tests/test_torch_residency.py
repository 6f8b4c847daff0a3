"""The port's device residency against the host arrays and the JAX package's.

``ClusterState(device_state=True)`` keeps the node tables resident on the
engine's device (here the CPU, where the plain versions of ``dstate_rows``,
``dstate_scatter`` and ``dstate_gate`` run).  After op sequences — upserts
past the capacity, metrics, binds, removals with index reuse — the resident
tables equal the store's host arrays and the JAX package's resident tables,
and the served (gated) node inputs equal the JAX package's.  Also: zero
host->device bytes in steady state, the wholesale re-upload past 25% dirty
rows, the audit that catches a corrupted row and rebuilds cold, the
refusals of the policy and device tables, the gate at NaN and boundary
times, the scatter with duplicate padded indices, one device per store,
and the scatter's staging: its packed layout, its descriptor, rebuilt
only when a table's buffers are replaced, and its buffers, started anew
on another device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu.api.model as jm
import koordinator_tpu_torch.api.model as tm
from koordinator_tpu.service import state as jstate_mod
from koordinator_tpu.service.state import ClusterState as JState
from koordinator_tpu.utils import fixtures as jfx
from koordinator_tpu_torch.service import state as sm
from koordinator_tpu_torch.service.engine import Engine
from koordinator_tpu_torch.service.state import ClusterState, ResidencyMismatch
from koordinator_tpu_torch.utils import fixtures as tfx
from torch_parity import assert_same, np_of

NOW = jfx.NOW
SCALARS = (jm.BATCH_CPU, jm.BATCH_MEMORY)
CPU_DEV = torch.device("cpu")


def _ops(st, fx, m, seed, num_nodes):
    """A generator of op steps: upserts past the initial capacity, metric
    updates, binds and unbinds, a removal and an add that reuses its row."""
    _, nodes = fx.random_cluster(seed, num_nodes=num_nodes, num_pods=0)
    for n in nodes[: num_nodes // 2]:
        st.upsert_node(n)
    yield "first half"
    for n in nodes[num_nodes // 2:]:
        st.upsert_node(n)
    yield "upserts past the capacity"
    rng = np.random.default_rng(seed + 1)
    for i in rng.choice(num_nodes, 7, replace=False):
        st.update_metric(f"node-{i}", m.NodeMetric(
            node_usage={jm.CPU: int(rng.integers(100, 4000)),
                        jm.MEMORY: int(rng.integers(1, 9)) << 30},
            update_time=NOW - 10.0))
    yield "metrics"
    bound = fx.random_cluster(seed + 2, num_nodes=0, num_pods=10)[0]
    for k, pod in enumerate(bound):
        st.assign_pod(f"node-{k % num_nodes}", m.AssignedPod(pod=pod, assign_time=NOW - 5))
    st.unassign_pod(bound[3].key)
    yield "binds"
    st.remove_node("node-2")
    st.remove_node("node-5")
    yield "removals"
    st.upsert_node(m.Node(name="node-late", allocatable={jm.CPU: 64000, jm.MEMORY: 256 << 30}))
    yield "an add into a freed row"


def _jax_rows(jst):
    return [np.asarray(b) for b in jst.residency._dres_tables["rows"].bufs]


def _same_la(got, want):
    for f in want._fields:
        assert_same(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("seed,num_nodes", [(31, 40), (32, 300)])
def test_resident_tables_equal_host_and_jax_after_ops(seed, num_nodes):
    j = JState(extra_scalars=SCALARS, initial_capacity=16)
    t = ClusterState(extra_scalars=SCALARS, initial_capacity=16)
    steps = zip(_ops(j, jfx, jm, seed, num_nodes), _ops(t, tfx, tm, seed, num_nodes))
    for k, (step, _) in enumerate(steps):
        now = NOW + k
        j.publish(now)
        t.publish(now)
        jla, jnf, jvalid = j.residency.serving_node_inputs(now)
        tla, tnf, tvalid = t.residency.serving_node_inputs(now, CPU_DEV)
        _same_la(tla, jla)
        for f in jnf._fields:
            assert_same(getattr(tnf, f), getattr(jnf, f), f"{step}: {f}")
        assert_same(tvalid, jvalid, f"{step}: valid")
        for attr, buf, jbuf in zip(sm.DeviceResidency._ROWS, t.residency._tables["rows"].bufs,
                                   _jax_rows(j)):
            host = getattr(t, attr)
            assert np.array_equal(np_of(buf), host, equal_nan=host.dtype.kind == "f"), attr
            assert np.array_equal(np_of(buf), jbuf, equal_nan=host.dtype.kind == "f"), attr
        assert t.residency.verify() == len(sm.DeviceResidency._ROWS)
        for c in ("h2d_bytes_total", "full_uploads", "scatters", "last_dirty_rows"):
            assert getattr(t.residency, c) == getattr(j.residency, c), f"{step}: {c}"
        assert t.sched_versions() == j.sched_versions(), step
    assert t.residency.scatters > 0
    assert t.residency.full_uploads == (2 if num_nodes > 256 else 1)  # growth re-uploads
    # a cold adoption after the growth (an audit's invalidation), on both
    # sides: the table's one staging reused, the buffers one new slab of
    # 256-byte-aligned views equal to the host and to the JAX package's
    staging = t.residency._tables["rows"].upload
    grows = staging.grows
    now = NOW + 100
    for st in (j, t):
        st.publish(now)
        st.residency.invalidate("rows")
    jla, jnf, jvalid = j.residency.serving_node_inputs(now)
    tla, tnf, tvalid = t.residency.serving_node_inputs(now, CPU_DEV)
    _same_la(tla, jla)
    for f in jnf._fields:
        assert_same(getattr(tnf, f), getattr(jnf, f), f"cold adoption: {f}")
    assert_same(tvalid, jvalid, "cold adoption: valid")
    bufs = t.residency._tables["rows"].bufs
    _assert_slab(bufs, [getattr(t, a) for a in sm.DeviceResidency._ROWS])
    for buf, jbuf in zip(bufs, _jax_rows(j)):
        assert np.array_equal(np_of(buf), jbuf, equal_nan=jbuf.dtype.kind == "f")
    assert staging.grows == grows and staging.copies == t.residency.full_uploads
    assert t.residency.full_uploads == j.residency.full_uploads
    assert t.residency.h2d_bytes_total == j.residency.h2d_bytes_total


def _assert_slab(bufs, host):
    """``bufs`` are one adoption's: typed, contiguous views of one slab,
    each at its ``upload_layout`` offset (a multiple of 256 bytes), equal
    to its host array byte for byte."""
    bufs = list(bufs)
    offsets, total = sm.upload_layout(a.nbytes for a in host)
    slab = bufs[0].untyped_storage()
    assert slab.nbytes() == total
    for k, (a, b, o) in enumerate(zip(host, bufs, offsets)):
        if b.numel():  # an empty view's data_ptr is 0
            assert b.untyped_storage().data_ptr() == slab.data_ptr(), k
            assert b.data_ptr() - slab.data_ptr() == o and o % 256 == 0, k
        assert b.dtype == torch.from_numpy(a).dtype and tuple(b.shape) == a.shape, k
        assert b.is_contiguous(), k
        assert np.array_equal(b.numpy().view(np.uint8).reshape(-1),
                              np.ascontiguousarray(a).view(np.uint8).reshape(-1)), k


def test_upload_layout_aligns_each_array_to_256_bytes():
    """Each array of an adoption starts at the next multiple of 256 bytes
    (as ``cudaMalloc`` aligns an allocation); an empty array takes no
    room."""
    assert sm.upload_layout([]) == ([], 0)
    assert sm.upload_layout([0, 1, 256, 257, 8, 0]) == ([0, 0, 256, 512, 1024, 1280], 1280)
    assert sm.upload_layout(np.array([16384 * 8, 16384])) == ([0, 131072], 147456)


def test_adoption_is_one_slab_of_aligned_private_views():
    """``dstate_rows`` on the CPU route, which packs as a card's does: the
    buffers are typed, contiguous views of one slab at 256-byte-aligned
    offsets, equal to their host arrays byte for byte (any dtype, a
    strided source included), and private: writing the store's arrays
    after the adoption, or adopting again into the same staging, leaves
    them as they were."""
    rng = np.random.default_rng(11)
    host = [rng.integers(-1 << 40, 1 << 40, (37, 3)), rng.random(37) < 0.5,
            rng.integers(-9, 9, (37, 5)).astype(np.int32), rng.random((37, 2)),
            rng.integers(0, 9, 5).astype(np.int16), np.zeros((0, 4), np.int64),
            rng.integers(0, 9, (37, 8)).astype(np.int32)[:, ::2]]
    host[3][0, 0] = np.nan
    bufs = sm.dstate_rows(host, CPU_DEV)
    _assert_slab(bufs, host)
    kept = [a.copy() for a in host]
    for a in host:
        a[...] = 0 if a.dtype != bool else True
    again = sm.dstate_rows(host, CPU_DEV)
    _assert_slab(again, host)
    _assert_slab(bufs, kept)
    assert again[0].untyped_storage().data_ptr() != bufs[0].untyped_storage().data_ptr()


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_packing_shares_cover_every_byte_once(threads, monkeypatch):
    """The packing's shares (``_pack_shares``): at most ``PACK_THREADS`` of
    them, each but the last at least ``PACK_SHARE_BYTES``, together every
    byte of every array once at its layout offset, an array cut across two
    shares where a share ends in it; a several-MB adoption packed on the
    host threads equals its arrays (shares of 512 KB here, so that a few
    MB take several)."""
    monkeypatch.setattr(sm, "PACK_THREADS", threads)
    monkeypatch.setattr(sm, "PACK_SHARE_BYTES", 1 << 19)
    rng = np.random.default_rng(12)
    host = [rng.integers(-1 << 40, 1 << 40, (70_000, 3)), rng.random(300_000) < 0.5,
            np.zeros(0, np.int32), rng.random((50_000, 5)), rng.integers(0, 9, 7).astype(np.int16)]
    srcs = [a.reshape(-1).view(np.uint8) for a in host]
    offsets, total = sm.upload_layout(a.nbytes for a in host)
    shares = sm._pack_shares(srcs, offsets)
    size = sum(a.nbytes for a in host)
    assert len(shares) == min(threads, size // sm.PACK_SHARE_BYTES)
    sizes = [sum(src.size for _, src in job) for job in shares]
    assert sum(sizes) == size and all(n >= sm.PACK_SHARE_BYTES for n in sizes[:-1])
    raw = np.zeros(total, np.uint8)
    hits = np.zeros(total, np.int64)
    for job in shares:
        for o, src in job:
            raw[o:o + src.size] = src
            hits[o:o + src.size] += 1
    for a, o in zip(host, offsets):
        assert np.array_equal(raw[o:o + a.nbytes], a.reshape(-1).view(np.uint8))
        assert (hits[o:o + a.nbytes] == 1).all()
    assert hits.sum() == size
    _assert_slab(sm.UploadStage().upload(host, CPU_DEV), host)


def test_adoption_staging_is_reused_and_grows_with_the_capacity():
    """A table's adoption stage keeps one staging: a second cold adoption
    at the same capacity reuses it (no new staging), a capacity growth
    grows it at least twofold, once; each adoption's buffers stay equal
    to the host arrays they were adopted from while the next adoptions
    reuse the staging."""
    st = _store(n=120, initial_capacity=128)
    res = st.residency
    rows = res._tables["rows"]
    res.serving_node_inputs(NOW, CPU_DEV)
    first, first_host = rows.bufs, [getattr(st, a).copy() for a in rows.attrs]
    staging = rows.upload._host
    assert rows.upload.grows == 1 and res.full_uploads == 1
    res.invalidate("rows")
    st.update_metric("node-3", tm.NodeMetric(node_usage={jm.CPU: 999, jm.MEMORY: 1 << 30},
                                             update_time=NOW - 1))
    st.publish(NOW + 1)
    res.serving_node_inputs(NOW + 1, CPU_DEV)
    assert rows.upload.grows == 1 and rows.upload._host is staging
    assert rows.bufs is not first and res.full_uploads == 2
    cap = st.capacity
    for node in tfx.random_cluster(42, num_nodes=cap + 10, num_pods=0)[1][120:]:
        st.upsert_node(node)
    assert st.capacity > cap
    st.publish(NOW + 2)
    res.serving_node_inputs(NOW + 2, CPU_DEV)
    assert rows.upload.grows == 2 and rows.upload._host.numel() >= 2 * staging.numel()
    _assert_slab(rows.bufs, [getattr(st, a) for a in rows.attrs])
    _assert_slab(first, first_host)
    assert res.verify() == len(sm.DeviceResidency._ROWS)


def _store(n=120, **kw):
    st = ClusterState(extra_scalars=SCALARS, **kw)
    for node in tfx.random_cluster(41, num_nodes=n, num_pods=0)[1]:
        st.upsert_node(node)
    return st


def test_steady_state_ships_no_bytes_and_one_row_ships_one_bucket():
    st = _store()
    eng = Engine(st, device="cpu")
    pods = tfx.random_cluster(42, num_nodes=0, num_pods=12)[0]
    eng.score(pods, now=NOW)
    before = st.residency.h2d_bytes_total
    eng.score(pods, now=NOW + 1)
    eng.schedule(pods, now=NOW + 2)
    assert st.residency.h2d_bytes_total == before
    st.update_metric("node-3", tm.NodeMetric(node_usage={tm.CPU: 999, tm.MEMORY: 3 << 30},
                                             update_time=NOW + 2))
    uploads = st.residency.full_uploads
    eng.score(pods, now=NOW + 3)
    row = sum(getattr(st, a)[0].nbytes for a in sm.DeviceResidency._ROWS)
    assert st.residency.full_uploads == uploads and st.residency.last_dirty_rows == 1
    assert st.residency.h2d_bytes_total - before == 16 * 4 + 16 * row  # one padded bucket
    assert st.residency.verify() == len(sm.DeviceResidency._ROWS)


def test_dense_churn_reuploads_wholesale():
    st = _store(n=120)  # capacity 256: 64 dirty rows is the line
    eng = Engine(st, device="cpu")
    pods = tfx.random_cluster(43, num_nodes=0, num_pods=8)[0]
    eng.score(pods, now=NOW)
    uploads, scatters = st.residency.full_uploads, st.residency.scatters
    for i in range(70):
        st.update_metric(f"node-{i}", tm.NodeMetric(node_usage={tm.CPU: 100 + i},
                                                    update_time=NOW))
    eng.score(pods, now=NOW + 1)
    assert st.residency.full_uploads == uploads + 1 and st.residency.scatters == scatters
    assert st.residency.last_dirty_rows == st.capacity
    assert st.residency.verify() == len(sm.DeviceResidency._ROWS)


def test_corrupted_row_raises_invalidates_and_rebuilds_cold():
    st, host_twin = _store(), _store(device_state=False)
    eng, ref = Engine(st, device="cpu"), Engine(host_twin, device="cpu")
    pods = tfx.random_cluster(44, num_nodes=0, num_pods=10)[0]
    eng.score(pods, now=NOW)
    st.residency._tables["rows"].bufs[1][5, 0] += 1  # one resident row diverges
    with pytest.raises(ResidencyMismatch, match="_la_base_nonprod"):
        st.residency.verify()
    assert st.residency._tables["rows"].bufs is None  # invalidated before raising
    uploads = st.residency.full_uploads
    got, want = eng.score(pods, now=NOW + 1), ref.score(pods, now=NOW + 1)
    assert st.residency.full_uploads == uploads + 1
    assert_same(got[0], want[0], "totals after the cold rebuild")
    assert_same(got[1], want[1], "feasible after the cold rebuild")
    assert st.residency.verify() == len(sm.DeviceResidency._ROWS)


def test_periodic_audit_samples_a_rotating_window():
    st = _store()
    st.residency.verify_every, st.residency.verify_sample_rows = 2, 100
    eng = Engine(st, device="cpu")
    pods = tfx.random_cluster(45, num_nodes=0, num_pods=4)[0]
    cursors = []
    for k in range(6):
        eng.score(pods, now=NOW + k)
        cursors.append(st.residency._tables["rows"].audit_cursor)
    assert st.residency.verifies == 3
    assert cursors[1::2] == [100, 200, 0]  # 256 rows swept in windows of 100


def test_policy_and_device_tables_raise():
    """The policy and device tables are served now, on the bound device
    only; what still raises is a read on another device and a widening the
    kernel cannot take (a narrower table, a width on a 1-D array)."""
    from torch_parity import pkg

    k = pkg("torch")
    st = _store(n=4)
    st.upsert_node(k.Node(name="node-0", allocatable={"cpu": 1000}, labels={"zone": "a"},
                          taints=[{"key": "k", "effect": "NoSchedule"}]))
    st.set_devices("node-1", [k.GPUDevice(minor=m) for m in range(2)])
    st.publish(NOW)
    st.residency.serving_node_inputs(NOW, "cpu")
    labels, taints, aa, sig = st.residency.policy_rows("cpu")
    assert labels.shape == (st.capacity, st._Lb) and bool(taints[0].any())
    core, mem, full, vfs, alloc2, used2 = st.residency.device_rows("cpu")
    assert int(full[1]) == 2 and int(core[1, 2]) == -1
    assert st.residency.verify() == 19 + 4 + 6
    with pytest.raises(ValueError, match="resident tables live on cpu"):
        st.residency.policy_rows(torch.device("meta"))
    narrow = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot widen"):
        sm.dstate_extend([narrow], [4], [0])
    with pytest.raises(ValueError, match="cannot widen"):
        sm.dstate_extend([torch.zeros(4, dtype=torch.int32)], [8], [0])
    with pytest.raises(ValueError, match="fill"):
        sm.dstate_extend([torch.zeros((4, 8), dtype=torch.bool)], [16], [-1])


def test_one_device_per_store():
    st = _store(n=4)
    st.publish(NOW)
    st.residency.serving_node_inputs(NOW, "cpu")
    assert st.residency.device == CPU_DEV
    with pytest.raises(ValueError, match="resident tables live on cpu"):
        st.residency.serving_node_inputs(NOW, torch.device("meta"))


def test_host_and_resident_paths_serve_the_same():
    """``device_state=False`` is an explicit knob, not an escape: both paths
    give the same SCORE and SCHEDULE answers, and an exclusion never
    writes the resident valid mask."""
    a, b = _store(), _store(device_state=False)
    ea, eb = Engine(a, device="cpu"), Engine(b, device="cpu")
    pods = tfx.random_cluster(46, num_nodes=0, num_pods=30)[0]
    for k, excl in enumerate((None, ["node-1", "node-7"], ["node-1", "node-7"])):
        ta, tb = ea.score(pods, now=NOW + k), eb.score(pods, now=NOW + k)
        assert_same(ta[0], tb[0])
        assert_same(ta[1], tb[1])
        ha, hb = (e.schedule(pods, now=NOW + k, exclude=excl) for e in (ea, eb))
        assert_same(ha[0], hb[0])
        assert_same(ha[1], hb[1])
        assert ha[3] == hb[3]
        assert bool(np_of(a.residency._tables["rows"].bufs[-1])[a._imap.get("node-1")])
    assert a.residency.verify() == len(sm.DeviceResidency._ROWS)
    assert not b.residency.enabled and b.residency._tables["rows"].bufs is None


def _raw_rows(n, seed, now, exp):
    """The 12 raw LoadAware rows with update times at NaN, at the expiry
    boundary, just inside it, ahead of the clock and random."""
    rng = np.random.default_rng(seed)
    R = 2
    ints = lambda: rng.integers(0, 1 << 40, size=(n, R), dtype=np.int64)  # noqa: E731
    bools = lambda: rng.random(n) < 0.6  # noqa: E731
    ut = now - rng.uniform(0, 400, size=n)
    e = exp or 180
    ut[0:8] = np.nan
    ut[8:16] = now - e
    ut[16:24] = np.nextafter(now - e, np.inf)
    ut[24:32] = np.nextafter(now - e, -np.inf)
    ut[32:40] = now + 3.0
    return (ints(), ints(), ints(), bools(), ut, ints(), bools(), ints(), ints(), bools(),
            ints(), bools())


@pytest.mark.parametrize("exp,fexp", [(180, True), (180, False), (None, True), (0, True)])
def test_gate_matches_jax_at_nan_and_boundary_times(exp, fexp):
    now = NOW + 0.25
    raw = _raw_rows(96, 7, now, exp)
    want = jstate_mod._dstate_jits()["dstate_gate"](
        *(jnp.asarray(a) for a in raw), np.float64(now),
        None if exp is None else float(exp), bool(fexp),
    )
    got = sm.dstate_gate(tuple(torch.from_numpy(a) for a in raw), now, exp, fexp)
    _same_la(got, want)
    from koordinator_tpu_torch.core.config import LoadAwareArgs
    from koordinator_tpu_torch.snapshot.loadaware import assemble_node_arrays

    args = LoadAwareArgs(node_metric_expiration_seconds=exp, filter_expired_node_metrics=fexp)
    _same_la(got, assemble_node_arrays(*raw, args, now))


def test_gate_stage_follows_the_rows_buffers():
    """The rows table's gate stage is bound with its buffers: on the cold
    upload, again after a capacity growth (a full upload of new buffers),
    and not after a scatter (which writes the same buffers in place).  After
    each step the served gated arrays equal the JAX residency's
    (``dstate_gate``, koordinator_tpu/service/state.py:222), some nodes
    expired and one metric ahead of the clock."""
    j = JState(extra_scalars=SCALARS, initial_capacity=16)
    t = ClusterState(extra_scalars=SCALARS, initial_capacity=16)
    _, nodes = tfx.random_cluster(51, num_nodes=270, num_pods=0)
    _, jnodes = jfx.random_cluster(51, num_nodes=270, num_pods=0)
    res, table = t.residency, t.residency._tables["rows"]
    now = NOW + 400.0

    def served(step, binds):
        j.publish(now)
        t.publish(now)
        got = res.serving_node_inputs(now, CPU_DEV)[0]
        _same_la(got, j.residency.serving_node_inputs(now)[0])
        assert table.gate.binds == binds, step
        assert all(a is b for a, b in zip(table.gate.raw, table.bufs[:12])), step
        return got

    for st, ns in ((j, jnodes[:12]), (t, nodes[:12])):
        for n in ns:
            st.upsert_node(n)
    served("cold", 1)
    for k, (st, m) in enumerate(((j, jm), (t, tm))):
        st.update_metric("node-3", m.NodeMetric(node_usage={jm.CPU: 900}, update_time=now + 5))
        st.update_metric("node-4", m.NodeMetric(node_usage={jm.CPU: 900}, update_time=now - 10))
    scatters = res.scatters
    served("a scatter", 1)
    assert res.scatters == scatters + 1
    for st, ns in ((j, jnodes[12:]), (t, nodes[12:])):
        for n in ns:
            st.upsert_node(n)
    uploads = res.full_uploads
    got = served("capacity growth", 2)
    assert res.full_uploads == uploads + 1 and got.score_valid.shape[0] == t.capacity > 256


@pytest.mark.parametrize("move", ["set_", "resize_"])
def test_gate_stage_rebinds_when_a_row_moves_under_the_same_tensor(move):
    """A bound row given new storage and new values under the same tensor
    (``set_``, or a ``resize_`` that reallocates and back) rebinds the
    stage, as a scatter's buffers rebind theirs, and the public
    ``dstate_gate`` then gates the new values: equal to the JAX
    package's ``dstate_gate`` (koordinator_tpu/service/state.py:222) on
    them.  A strided row (a column of an [N, k] table) is refused before
    any work, whatever the device: the kernel reads a row through its
    base pointer."""
    now = NOW + 0.25
    raw = _raw_rows(64, 11, now, 180)
    rows = [torch.from_numpy(a).clone() for a in raw]
    stage = sm.GateStage()
    stage.bind(rows)
    assert stage.bound_to(rows) and stage.binds == 1
    fresh = _raw_rows(64, 12, now, 180)
    ident = [id(t) for t in rows]
    if move == "set_":
        rows[4].set_(torch.from_numpy(fresh[4].copy()))
        rows[3].set_(torch.from_numpy(fresh[3].copy()))
    else:
        for k in (3, 4):
            rows[k].resize_(4096)
            rows[k].resize_(64)
            rows[k].copy_(torch.from_numpy(fresh[k]))
    assert [id(t) for t in rows] == ident and not stage.bound_to(rows)
    moved = raw[:3] + (fresh[3], fresh[4]) + raw[5:]
    want = jstate_mod._dstate_jits()["dstate_gate"](
        *(jnp.asarray(a) for a in moved), np.float64(now), 180.0, True)
    binds = sm._GATE.binds
    _same_la(sm.dstate_gate(rows, now, 180, True), want)
    assert sm._GATE.binds == binds + 1 and sm._GATE.bound_to(rows)
    stage.bind(rows)
    _same_la(stage.gate(now, 180, True), want)
    # strided rows: each gated row a column of an [N, 3] table
    for k in (3, 4, 6, 9, 11):
        wide = torch.stack([rows[k]] * 3, dim=1)
        strided = list(rows)
        strided[k] = wide[:, 1]
        assert not strided[k].is_contiguous()
        with pytest.raises(ValueError, match=f"gate input {k}: expected a contiguous"):
            sm.dstate_gate(strided, now, 180, True)
        with pytest.raises(ValueError, match="contiguous"):
            sm.GateStage().bind(strided)
    _same_la(sm.dstate_gate(rows, now, 180, True), want)


def test_gate_stage_rebound_on_a_device_change():
    """The public ``dstate_gate``'s stage rebinds when its rows are on
    another device (the CPU, then ``meta``: another device's shapes and
    dtypes with no data, where the plain version runs without a card) and
    when they come back; the CPU results equal the JAX package's, and a
    well-formed call after a refused one is served from the rows given."""
    now = NOW + 0.25
    raw = _raw_rows(64, 8, now, 180)
    want = jstate_mod._dstate_jits()["dstate_gate"](
        *(jnp.asarray(a) for a in raw), np.float64(now), 180.0, True)
    cpu = [torch.from_numpy(a) for a in raw]
    meta = [a.to("meta") for a in cpu]
    stage = sm._GATE
    binds = stage.binds
    _same_la(sm.dstate_gate(cpu, now, 180, True), want)
    assert stage.binds == binds + 1 and stage.device == CPU_DEV
    _same_la(sm.dstate_gate(cpu, now, 180, True), want)
    assert stage.binds == binds + 1  # the same rows: no rebind
    got = sm.dstate_gate(meta, now, 180, True)
    assert stage.binds == binds + 2 and stage.device == torch.device("meta")
    assert got.score_valid.device.type == "meta" and stage.desc is None
    broken = list(cpu)
    broken[4] = cpu[4].float()
    with pytest.raises(ValueError, match="gate input 4"):
        sm.dstate_gate(broken, now, 180, True)
    _same_la(sm.dstate_gate(cpu, now, 180, True), want)
    assert stage.binds == binds + 3 and stage.device == CPU_DEV


def test_scatter_with_duplicate_padded_indices_matches_jax():
    rng = np.random.default_rng(9)
    host = [rng.integers(0, 1 << 50, size=(64, 3), dtype=np.int64),
            rng.random(64) < 0.5, rng.uniform(0, 1e6, size=64)]
    host[2][[3, 9]] = np.nan
    real = np.array([5, 9, 40], dtype=np.int32)
    idx = np.full(16, real[0], dtype=np.int32)
    idx[:3] = real
    src = np.full(16, 3, dtype=np.int64)
    src[:3] = [3, 17, 63]
    vals = tuple(np.ascontiguousarray(h[src]) for h in host)
    kept = [h.copy() for h in host]
    got = sm.dstate_scatter(sm.dstate_rows(host, CPU_DEV), idx, vals)
    want = jstate_mod._dstate_jits()["dstate_scatter"](
        tuple(jnp.asarray(h) for h in host), idx, vals)
    for g, w in zip(got, want):
        assert np.array_equal(np_of(g), np.asarray(w), equal_nan=g.dtype.is_floating_point)
    for h, k in zip(host, kept):  # the resident buffers are copies
        assert np.array_equal(h, k, equal_nan=h.dtype.kind == "f")


def test_vocab_growth_counters_match_jax_but_the_device_table():
    """On vocab growth the port's residency counters equal the JAX
    residency's wherever the two do the same thing — the rows and policy
    tables: a label-set vocabulary past its bucket widens the policy table
    warm (``dstate_extend``) and scatters the dirty rows in both.  The
    device table is the one deliberate departure: the JAX residency's
    extend refuses tables holding [N] arrays (``_dv_full``, ``_dv_vfs``)
    and re-uploads it whole, the port widens it warm.  A 16-GPU node in a
    table bucketed for fewer GPUs gives exactly: the port extends +1,
    full_uploads +0, scatters +1 (one padded 16-row bucket); JAX
    full_uploads +1 (the whole table), extends +0.  The served totals stay
    equal throughout."""
    from torch_parity import device_cluster, engine_of, pkg, policy_batch

    counters = ("h2d_bytes_total", "full_uploads", "scatters", "extends")
    sides = {}
    for which in ("jax", "torch"):
        k = pkg(which)
        st = device_cluster(k, device_state=True)
        sides[which] = (k, st, engine_of(k, st), policy_batch(k))

    def step(now):
        totals = {w: np_of(e.score(b, now=now)[0]) for w, (k, st, e, b) in sides.items()}
        assert_same(totals["torch"], totals["jax"], f"totals at {now}")
        return {w: {c: getattr(st.residency, c) for c in counters}
                for w, (k, st, e, b) in sides.items()}

    c0 = step(NOW)
    assert c0["torch"] == c0["jax"]
    for k, st, e, b in sides.values():
        for i in range(st._Gb - len(st._sig_vocab) + 1):
            st.assign_pod(f"ep-{1 + i % 10}", k.AssignedPod(pod=k.Pod(
                name=f"grow-{i}", requests={"cpu": 100}, labels={"team": f"grow-{i}"}),
                assign_time=NOW))
    c1 = step(NOW + 1)
    assert c1["torch"] == c1["jax"]
    assert c1["torch"]["extends"] == c0["torch"]["extends"] + 1
    assert c1["torch"]["full_uploads"] == c0["torch"]["full_uploads"]
    for k, st, e, b in sides.values():
        st.set_devices("ep-3", [k.GPUDevice(minor=m, numa_node=m // 8) for m in range(16)])
    c2 = step(NOW + 2)
    tst, jst = sides["torch"][1], sides["jax"][1]
    row = sum(getattr(tst, a)[0].nbytes for a in sm.DeviceResidency._DEVICE)
    table = sum(getattr(jst, a).nbytes for a in jstate_mod.DeviceResidency._DEVICE)
    d = {w: {c: c2[w][c] - c1[w][c] for c in counters} for w in c2}
    assert d["torch"] == {"h2d_bytes_total": 16 * 4 + 16 * row, "full_uploads": 0, "scatters": 1,
                          "extends": 1}
    assert d["jax"] == {"h2d_bytes_total": table, "full_uploads": 1, "scatters": 0,
                        "extends": 0}
    assert tst.residency.verify() > 0


def test_scatter_staging_packs_as_concatenated_rows():
    """``ScatterStage.gather`` (the residency's entry) and ``pack`` (given
    rows) lay out the index and every array's rows ``host[idx]`` at
    ``scatter_layout``'s offsets: at D = 16 the sections need no padding
    and the staging equals ``np.concatenate`` of the index and the rows'
    bytes; at D = 1 each section does, at its 16-byte boundary."""
    st = _store(n=40)
    host = [getattr(st, a) for a in sm.DeviceResidency._ROWS]
    bufs = sm.dstate_rows(host, CPU_DEV)
    stage = sm.ScatterStage()
    stage.bind(bufs)
    rb = [h[0].nbytes for h in host]
    assert stage.row_bytes == tuple(rb) and stage.row_total == sum(rb)
    rng = np.random.default_rng(5)
    for D in (16, 1):
        idx = rng.choice(host[0].shape[0], D, replace=False).astype(np.int32)
        offsets, total = sm.scatter_layout(rb, D)
        want = [idx.view(np.uint8)] + [np.ascontiguousarray(h[idx]).reshape(-1).view(np.uint8)
                                      for h in host]
        for fill in (lambda: stage.gather(host, idx),
                     lambda: stage.pack(idx, [np.ascontiguousarray(h[idx]) for h in host])):
            assert fill() == D
            got = stage._host.numpy()[:total]
            if D % 16 == 0:
                assert offsets == list(np.cumsum([p.size for p in want])[:-1])
                assert np.array_equal(got, np.concatenate(want))
            for off, part in zip([0] + offsets, want):
                assert np.array_equal(got[off: off + part.size], part)
            assert all(o % 16 == 0 for o in offsets)
    # applied, the staged rows are the host rows
    fresh = sm.dstate_rows([np.zeros_like(h) for h in host], CPU_DEV)
    stage.bind(fresh)
    idx = np.arange(16, dtype=np.int32)
    stage.scatter(fresh, stage.gather(host, idx))
    for b, h in zip(fresh, host):
        assert np.array_equal(b[:16].numpy(), h[:16], equal_nan=h.dtype.kind == "f")


def test_scatter_descriptor_rebuilt_only_with_new_buffers():
    """A table's scatter descriptor names its resident buffers: built on the
    cold upload, kept across scatters, rebuilt after a widening of the
    vocabulary axis (``dstate_extend``) and after a full upload (capacity
    growth), each time with the new buffers' pointers and row bytes."""
    from torch_parity import device_cluster, engine_of, pkg, policy_batch

    k = pkg("torch")
    st = device_cluster(k, device_state=True)
    eng, batch = engine_of(k, st), policy_batch(k)
    res = st.residency

    def named(table):
        t = res._tables[table]
        return t.stage.ptrs == tuple(b.data_ptr() for b in t.bufs) and t.stage.row_bytes == tuple(
            b[0].numel() * b.element_size() for b in t.bufs)

    eng.score(batch, now=NOW)
    binds = {n: t.stage.binds for n, t in res._tables.items()}
    assert binds == {"rows": 1, "policy": 1, "device": 1} and all(map(named, binds))
    st.update_metric("ep-1", k.NodeMetric(node_usage={"cpu": 500}, update_time=NOW))
    scatters = res.scatters
    eng.score(batch, now=NOW + 1)
    assert res.scatters == scatters + 1 and res._tables["rows"].stage.binds == 1
    extends = res.extends
    for i in range(st._Gb - len(st._sig_vocab) + 1):
        st.assign_pod(f"ep-{1 + i % 10}", k.AssignedPod(pod=k.Pod(
            name=f"grow-{i}", requests={"cpu": 100}, labels={"team": f"grow-{i}"}),
            assign_time=NOW))
    eng.score(batch, now=NOW + 2)
    assert res.extends == extends + 1
    assert res._tables["policy"].stage.binds == 2 and named("policy")
    uploads = res.full_uploads
    for i in range(st.capacity + 1):
        st.upsert_node(k.Node(name=f"more-{i}", allocatable={"cpu": 8000, "memory": 16 << 30}))
    eng.score(batch, now=NOW + 3)
    assert res.full_uploads > uploads
    assert res._tables["rows"].stage.binds == 2 and named("rows")
    assert res.verify() > 0


def _bufs_on(host, dev: str):
    """The host arrays as resident buffers on ``dev`` (the CPU, or ``meta``:
    the shapes and dtypes of another device with no data)."""
    bufs = sm.dstate_rows(host, CPU_DEV)
    return bufs if dev == "cpu" else tuple(torch.empty_like(b, device=dev) for b in bufs)


class _Event:
    """An event whose ``synchronize`` is counted (a copy still in flight)."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


@pytest.mark.parametrize("first,then,layout,kept", [
    ("cpu", "meta", "same", False), ("meta", "cpu", "same", False),
    ("meta", "meta", "wider", True), ("cpu", "cpu", "same", True),
    ("cpu", "cpu", "wider", True)])
def test_scatter_stage_rebound_to_another_device_starts_anew(first, then, layout, kept):
    """A stage rebound to buffers on another device drops its staging, its
    device buffer, its event and its stream (each belongs to one device, the
    staging is pinned only for a card), after waiting for the last copy out
    of them; rebound on the same device it keeps them for reuse.  Either way
    the next ``gather`` stages the new buffers' rows."""
    st = _store(n=40)
    host = [getattr(st, a) for a in sm.DeviceResidency._ROWS]
    stage = sm.ScatterStage()
    stage.bind(_bufs_on(host, first))
    idx = np.arange(16, dtype=np.int32)
    stage.gather(host, idx)
    staging, dev_buf, event, stream = stage._host, torch.empty(8, dtype=torch.uint8), _Event(), "s"
    stage._dev, stage._event, stage._stream, stage._pending = dev_buf, event, stream, True
    if layout == "wider":
        n = host[0].shape[0]
        host = host + [np.arange(n * 3, dtype=np.float64).reshape(n, 3)]
    bufs = _bufs_on(host, then)
    stage.bind(bufs)
    assert stage.device == torch.device(then) and stage.ptrs == tuple(b.data_ptr() for b in bufs)
    if kept:
        assert (stage._host, stage._dev, stage._event, stage._stream) == (
            staging, dev_buf, event, stream)
        assert event.waits == 0 and stage._pending
        stage._pending = False  # no copy in flight here
    else:
        assert (stage._host, stage._dev, stage._event, stage._stream) == (None,) * 4
        assert event.waits == 1 and not stage._pending
    D = stage.gather(host, idx)
    _, rows, _ = stage._views[D]
    assert stage._host is not None and not stage._host.is_pinned()
    for h, r in zip(host, rows):
        assert np.array_equal(r, h[idx], equal_nan=h.dtype.kind == "f")
