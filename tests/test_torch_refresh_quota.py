"""The host plans of the one-launch warm refresh and of the planned quota
refresh, walked in plain PyTorch as their kernels walk them, against the
port's plain versions and the JAX package's functions.

The refresh's plan is C++ in the schedule library (csrc/refreshplan.cuh),
built here with g++ behind a one-function C wrapper: its entries (a node
block and a mask of its dirty rows) on padded, clustered, edge and random
indices, and a walk of them (each entry's masked rows rescored, its block
maximum taken from the rows it holds) equal to ``refresh_plain`` and,
through ``schedule_batch_resolved(refresh_only=True)``, to the JAX
package's refresh.  The quota plan (``core.quota.quota_plan``): each
level's members in runs by parent on deep and wide random trees, its
refusals, and a walk of it (one (run, dimension) pair at a time, sums over
the run) equal to ``refresh_runtime`` and the JAX ``refresh_runtime`` and
``quota_limit_fn``'s limit, with mins scaled and not, lending mixed; then
the ``QuotaStage``'s keys: a tree change replans, a new ``own_request``
does not, and a parent row changed in place under the same tensor
replans.  Tolerance 0: every value is an integer.
"""

import ctypes
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from koordinator_tpu.core import quota as jquota
from koordinator_tpu.core import resolved as jres
from koordinator_tpu_torch import convert, cuda
from koordinator_tpu_torch.api.quota import ROOT_QUOTA, QuotaGroup
from koordinator_tpu_torch.core import quota as tquota
from koordinator_tpu_torch.core import resolved as tres
from koordinator_tpu_torch.core.loadaware import loadaware_filter
from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot
from torch_parity import assert_same, batch, to_jax, to_torch

CPU = torch.device("cpu")
T = lambda a: convert.tensor(a, CPU)  # noqa: E731


# ----------------------------------------------------------- the refresh plan


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/refreshplan.cuh (the schedule library's host plan, plain C++)
    built with g++ behind a one-function C wrapper: the plan's words into
    ``out`` (at most ``cap``), its entry count returned (-1 refused, -2 past
    ``cap``)."""
    csrc = Path(cuda.CSRC)
    d = tmp_path_factory.mktemp("refreshplan")
    (d / "plan.cpp").write_text(
        '#include <algorithm>\n#include "refreshplan.cuh"\n'
        'extern "C" int plan(const int* dirty, int D, int BS, int N, unsigned* out, int cap) {\n'
        '  static std::vector<uint32_t> words;\n  static koord_refresh::Scratch s;\n'
        '  const int n = koord_refresh::build(dirty, D, BS, N, words, s);\n'
        '  if (n < 0) return n;\n  if ((int)words.size() > cap) return -2;\n'
        '  std::copy(words.begin(), words.end(), out);\n  return n;\n}\n')
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{csrc}", "-o",
                    str(d / "libplan.so"), str(d / "plan.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libplan.so"))
    lib.plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int]
    lib.plan.restype = ctypes.c_int
    return lib


def refresh_plan(lib, dirty, BS: int, N: int) -> list:
    """The plan of ``dirty`` as [(block, set of its dirty rows' offsets)],
    read as the kernel reads the words."""
    dirty = np.ascontiguousarray(dirty, dtype=np.int32)
    W = (BS + 31) // 32
    out = np.zeros(max(dirty.size, 1) * (1 + W), dtype=np.uint32)
    n = lib.plan(dirty.ctypes.data, dirty.size, BS, N, out.ctypes.data, out.size)
    if n < 0:
        return n
    entries = []
    for e in range(n):
        words = out[e * (1 + W):(e + 1) * (1 + W)]
        entries.append((int(words[0]),
                        {i for i in range(BS) if (int(words[1 + i // 32]) >> (i % 32)) & 1}))
    return entries


def expected_plan(dirty, BS: int) -> dict:
    want = {}
    for j in np.asarray(dirty).tolist():
        want.setdefault(j // BS, set()).add(j % BS)
    return want


@pytest.mark.parametrize("BS", [16, 32])
def test_refresh_plan_collapses_padding_and_shared_blocks(plan_lib, BS):
    N = 300
    cases = {
        "padding duplicates": [5, 9, 40] + [5] * 13,
        "several rows in one block": list(range(BS, 2 * BS)) + [BS] * 16,
        "the first and the last block": [0, N - 1] * 8,
        "one row": [N - 1],
        "every row of the last block": list(range((N - 1) // BS * BS, N)),
    }
    for name, dirty in cases.items():
        got = refresh_plan(plan_lib, dirty, BS, N)
        want = expected_plan(dirty, BS)
        assert dict(got) == want, name
        assert len(got) == len(want), f"{name}: a block planned twice"
    full = refresh_plan(plan_lib, list(range(BS, 2 * BS)), BS, N)
    assert full == [(1, set(range(BS)))]  # a full 32-bit mask at BS 32


@pytest.mark.parametrize("BS", [1, 7, 16, 32, 33, 64])
def test_refresh_plan_random_indices(plan_lib, BS):
    """Random padded indices in any order, masks of one and of several
    words; the blocks come in the order of their first dirty row, and the
    library's scratch stays clear between calls."""
    rng = np.random.default_rng(BS)
    for N in (1, 64, 1000, 16_384):
        for D in (1, 16, 128, 1024):
            real = rng.choice(N, size=min(D, N), replace=True).astype(np.int32)
            dirty = np.r_[real, np.full(D, real[0], np.int32)]
            got = refresh_plan(plan_lib, dirty, BS, N)
            assert dict(got) == expected_plan(dirty, BS)
            firsts = list(dict.fromkeys((dirty // BS).tolist()))
            assert [b for b, _ in got] == firsts


def test_refresh_plan_refuses_rows_outside_the_nodes(plan_lib):
    assert refresh_plan(plan_lib, [0, 300], 16, 300) == -1
    assert refresh_plan(plan_lib, [-1], 16, 300) == -1
    assert refresh_plan(plan_lib, [3], 0, 300) == -1
    assert refresh_plan(plan_lib, [3, 299], 16, 300) == [(0, {3}), (18, {11})]


def walk_refresh(lib):
    """``refresh_plain``'s signature, walking the kernel's plan: per entry,
    the masked rows' LoadAware filter and keys, then the block maximum over
    the block's rows as they now stand."""

    def walk(M, Mb, la_feas_T, dirty, q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static,
             plugin_weights, q_extra, salts, block_size, rsv=None, q_xsc=None):
        N, P = la_feas_T.shape
        for b, rows in refresh_plan(lib, dirty.numpy(), block_size, N):
            d = torch.tensor(sorted(b * block_size + i for i in rows), dtype=torch.int64)
            la_feas_T[d] = loadaware_filter(q_la, tres._rows(la_nodes, d)).T
            M[d] = tres._touched_keys(
                q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, plugin_weights, la_feas_T,
                q_extra.T, salts.to(torch.int64), d, tres.tie_base(N), rsv,
                None if q_xsc is None else q_xsc.T)
            Mb[b] = M[b * block_size:(b + 1) * block_size].amax(dim=0)
        return M, Mb, la_feas_T

    return walk


def _perturb(b, rows):
    la, la_n, w, nf, nf_n, st = b
    la_n = la_n._replace(base_nonprod=la_n.base_nonprod.copy(),
                         filter_active=la_n.filter_active.copy())
    nf_n = nf_n._replace(requested=nf_n.requested.copy(), num_pods=nf_n.num_pods.copy())
    la_n.base_nonprod[rows] += la_n.alloc[rows] // 8
    la_n.filter_active[rows] = ~la_n.filter_active[rows]
    nf_n.requested[rows] += nf_n.alloc[rows] // 8
    nf_n.num_pods[rows] += 1
    return la, la_n, w, nf, nf_n, st


@pytest.mark.parametrize("P,N,seed,dirty", [
    (50, 300, 1, [4, 77, 180, 5, 6, 299]),
    (16, 256, 2, [0, 15, 16, 255, 128]),
    (64, 300, 3, [0]),
])
def test_refresh_walk_matches_plain_and_jax(plan_lib, monkeypatch, P, N, seed, dirty):
    """The walk of the plan equals ``refresh_plain`` on the carry, and, in
    place of it inside the port's ``schedule_batch_resolved``, the JAX
    package's refresh (``sched_refresh_fn``'s call) carry for carry."""
    b0 = batch(P, N, seed)
    rng = np.random.default_rng(seed)
    extra = rng.random((P, N)) < 0.9
    order = rng.permutation(P).astype(np.int32)
    idx = np.full(16, dirty[0], dtype=np.int32)
    idx[: len(dirty)] = dirty
    b1 = _perturb(b0, np.asarray(dirty))
    kw = dict(extra_feasible=torch.from_numpy(extra), order=torch.from_numpy(order))
    carry = tres.schedule_batch_resolved(*to_torch(b0), **kw, return_warm=True)[2]
    plain = tres.schedule_batch_resolved(*to_torch(b1), **kw, warm_init=carry,
                                         dirty_cols=torch.from_numpy(idx), refresh_only=True)
    monkeypatch.setattr(tres, "refresh_plain", walk_refresh(plan_lib))
    walked = tres.schedule_batch_resolved(*to_torch(b1), **kw, warm_init=carry,
                                          dirty_cols=torch.from_numpy(idx), refresh_only=True)
    for g, w in zip(walked, plain):
        assert_same(g, w, "walked carry vs refresh_plain")
    jcold = jax.jit(lambda a, e, o: jres.schedule_batch_resolved(
        *a, extra_feasible=e, order=o, impl="matrix_packed", return_warm=True))
    jwarm0 = jcold(to_jax(b0), extra, order)[2]
    jref = jax.jit(lambda a, e, o, wi, d: jres.schedule_batch_resolved(
        *a, extra_feasible=e, order=o, impl="matrix_packed", warm_init=wi, dirty_cols=d,
        refresh_only=True))(to_jax(b1), extra, order, jwarm0, idx)
    for g, w in zip(walked, jref):
        assert_same(g, w, "walked carry vs JAX")


# ------------------------------------------------------------- the quota plan


def random_quota_tree(seed: int, groups: int, depth: int, fanout: int) -> list:
    """A random tree of ``groups`` quota groups at most ``depth`` levels
    deep, about ``fanout`` children a parent; mins, maxes (some absent),
    weights, guarantees, requests, lending and scaled mins mixed."""
    rng = np.random.default_rng(seed)
    res = ("cpu", "memory")
    out, level_of = [], {ROOT_QUOTA: 0}
    for i in range(groups):
        cands = [n for n, lv in level_of.items() if lv < depth]
        parent = cands[int(rng.integers(0, len(cands)))] if rng.random() < 0.9 or \
            len(cands) < fanout else cands[-1]
        level_of[f"g{i}"] = level_of[parent] + 1
        mx = {r: int(rng.integers(1, 400)) * 100 for r in res}
        if rng.random() < 0.2:
            mx.pop(res[int(rng.integers(0, 2))])
        out.append(QuotaGroup(
            name=f"g{i}", parent=parent,
            min={r: int(rng.integers(0, 12000)) for r in res if rng.random() < 0.9},
            max=mx,
            guarantee={r: int(rng.integers(0, 300)) for r in res} if rng.random() < 0.3 else {},
            shared_weight={r: int(rng.integers(0, 5)) for r in res} if rng.random() < 0.3
            else None,
            pod_requests={r: int(rng.integers(0, 30000)) for r in res if rng.random() < 0.8},
            allow_lent=bool(rng.random() < 0.6), enable_scale_min=bool(rng.random() < 0.5)))
    return out


TREES = [("flat", 0, 120, 1, 120), ("wide", 1, 400, 2, 40), ("deep", 2, 60, 9, 2),
         ("mixed", 3, 250, 4, 6)]


def _snap(seed, groups, depth, fanout):
    return QuotaSnapshot(random_quota_tree(seed, groups, depth, fanout), ["cpu", "memory"])


def unpack_plan(block, L, runs):
    lrun = block[:L + 1]
    rpar = block[L + 1:L + 1 + runs]
    roff = block[L + 1 + runs:L + 2 + 2 * runs]
    return lrun, rpar, roff, block[L + 2 + 2 * runs:]


@pytest.mark.parametrize("name,seed,groups,depth,fanout", TREES)
def test_quota_plan_runs_children_per_parent(name, seed, groups, depth, fanout):
    """Each level's members in one contiguous run a parent, every member
    once, the runs' parents those of their members, in the levels' order;
    the snapshot's own order shuffled within each level plans the same
    runs."""
    snap = _snap(seed, groups, depth, fanout)
    levels = snap.level_tuple()
    rng = np.random.default_rng(seed)
    for lv in (levels, tuple(rng.permutation(a) for a in levels)):
        block, L, runs = tquota.quota_plan(snap.parent, lv)
        lrun, rpar, roff, mem = unpack_plan(block, L, runs)
        assert L == len(levels) and lrun[0] == 0 and lrun[-1] == runs
        assert sorted(mem.tolist()) == sorted(np.concatenate(levels).tolist())
        for depth_i, lev in enumerate(lv):
            seen = set()
            for run in range(lrun[depth_i], lrun[depth_i + 1]):
                kids = mem[roff[run]:roff[run + 1]]
                assert kids.size and (snap.parent[kids] == rpar[run]).all()
                assert rpar[run] not in seen, "a parent in two runs of a level"
                seen.add(int(rpar[run]))
            span = mem[roff[lrun[depth_i]]:roff[lrun[depth_i + 1]]]
            assert sorted(span.tolist()) == sorted(np.asarray(lev).tolist())


def test_quota_plan_refusals():
    snap = _snap(4, 30, 3, 3)
    levels = snap.level_tuple()
    with pytest.raises(ValueError, match="level rows"):
        tquota.quota_plan(snap.parent, (np.array([0, 1]),))
    with pytest.raises(ValueError, match="two levels"):
        tquota.quota_plan(snap.parent, levels + (levels[0][:1],))
    with pytest.raises(ValueError, match="two levels"):
        tquota.quota_plan(snap.parent, (np.r_[levels[0], levels[0][:1]],) + levels[1:])
    with pytest.raises(ValueError, match="earlier level"):
        tquota.quota_plan(snap.parent, (np.concatenate(levels),))
    for bad in (-1, snap.parent.shape[0]):
        parent = snap.parent.copy()
        parent[levels[-1][0]] = bad
        with pytest.raises(ValueError, match="parent rows outside"):
            tquota.quota_plan(parent, levels)


def walk_quota(q, block, L, runs, total, scale_min: bool, row0: bool) -> np.ndarray:
    """The kernel's walk of the plan in plain numpy: bottom-up one run and
    dimension at a time, then top-down each pair's min scaling, starting
    runtime and water-fill over its run alone."""
    lrun, rpar, roff, mem = unpack_plan(block, L, runs)
    mn, mx, wt, gu = (np.asarray(a) for a in (q.min, q.max_eff, q.weight, q.guarantee))
    lent, en = np.asarray(q.allow_lent), np.asarray(q.enable_scale)
    request = np.asarray(q.own_request).copy()
    Q, R = request.shape
    runtime = np.zeros((Q, R), dtype=np.int64)
    runtime[0] = np.asarray(total)
    for lv in range(L - 1, -1, -1):
        for run in range(lrun[lv], lrun[lv + 1]):
            kids = mem[roff[run]:roff[run + 1]]
            for r in range(R):
                req = np.where(lent[kids], request[kids, r], np.maximum(request[kids, r],
                                                                        mn[kids, r]))
                request[kids, r] = req
                request[rpar[run], r] += np.minimum(req, mx[kids, r]).sum()
    f = np.float64
    for lv in range(L):
        for run in range(lrun[lv], lrun[lv + 1]):
            kids = mem[roff[run]:roff[run + 1]]
            for r in range(R):
                tot = runtime[rpar[run], r]
                esum = mn[kids, r][en[kids]].sum() if scale_min else 0
                dsum = mn[kids, r][~en[kids]].sum() if scale_min else 0
                lim = np.minimum(request[kids, r], mx[kids, r])
                rt = np.zeros(kids.size, dtype=np.int64)
                active = np.zeros(kids.size, dtype=bool)
                for k, i in enumerate(kids):
                    m = mn[i, r]
                    if scale_min and en[i] and tot < esum + dsum:
                        avail = tot - dsum
                        m = 0 if avail <= 0 or esum <= 0 else int(f(avail) * f(m) / f(esum))
                    em = max(m, gu[i, r])
                    active[k] = lim[k] > em
                    rt[k] = em if active[k] else (lim[k] if lent[i] else em)
                to_part = tot - rt.sum()
                while True:
                    tw = wt[kids, r][active].sum()
                    if not (to_part > 0 and tw > 0):
                        break
                    surplus = 0
                    for k, i in enumerate(kids):
                        if not active[k]:
                            continue
                        cand = rt[k] + int(f(wt[i, r]) * f(to_part) / f(tw) + 0.5)
                        if cand >= lim[k]:
                            surplus += cand - lim[k]
                            active[k] = False
                        rt[k] = min(cand, lim[k])
                    to_part = surplus
                runtime[kids, r] = rt
    if row0:
        runtime[0] = tquota.INF
    return runtime


@pytest.mark.parametrize("name,seed,groups,depth,fanout", TREES)
@pytest.mark.parametrize("scale_min", [True, False])
def test_quota_walk_matches_plain_and_jax(name, seed, groups, depth, fanout, scale_min):
    snap = _snap(seed, groups, depth, fanout)
    levels = snap.level_tuple()
    block, L, runs = tquota.quota_plan(snap.parent, levels)
    jrefresh = jax.jit(jquota.refresh_runtime, static_argnums=(3,))
    for total in (np.array([3_000_000, 2_000_000]), np.array([40_000, 25_000])):
        total = total.astype(np.int64)
        walked = walk_quota(snap.arrays(), block, L, runs, total, scale_min, False)
        qa = tquota.QuotaArrays(*(T(a) for a in snap.arrays()))
        plain = tquota.refresh_runtime(qa, [torch.from_numpy(a.astype(np.int64))
                                            for a in levels], T(total), scale_min)
        assert_same(walked, plain, f"{name}: walk vs refresh_runtime")
        want = np.asarray(jrefresh(jquota.QuotaArrays(*snap.arrays()), levels, total,
                                   scale_min))
        assert_same(walked, want, f"{name}: walk vs JAX refresh_runtime")
        if scale_min:  # the JAX engine's quota_limit_fn: refresh_runtime, row 0 := 2**60
            limit = walk_quota(snap.arrays(), block, L, runs, total, True, True)
            assert_same(limit, snap.used_limit(want), f"{name}: walk vs JAX quota_limit_fn")
            assert_same(tquota.quota_limit_fn(qa, levels, T(total),
                                              stage=tquota.QuotaStage().bind(snap.parent,
                                                                             levels, CPU)),
                        limit, f"{name}: quota_limit_fn")


def test_quota_stage_follows_the_tree_not_the_requests():
    """The stage plans once a tree: a new ``own_request`` or total keeps
    its plan, a changed tree (a group moved to another parent at the same
    depth) replans, a parent row changed in place under the same tensor
    replans, another device replans; the tier follows the tree's size and
    the budget."""
    snap = _snap(5, 80, 3, 4)
    levels = snap.level_tuple()
    stage = tquota.QuotaStage()
    stage.bind(snap.parent, levels, CPU)
    assert stage.plans == 1 and stage.tier(2) == "shared"
    qa = tquota.QuotaArrays(*(T(a) for a in snap.arrays()))
    for k in range(3):  # new requests and totals, the same tree
        q2 = qa._replace(own_request=qa.own_request + 100 * k)
        tquota.quota_fn(q2, levels, T(np.array([9000, 700 + k], np.int64)),
                        stage=stage.bind(snap.parent, levels, CPU))
    assert stage.plans == 1
    moved = snap.parent.copy()
    lv1 = levels[1]
    olds = np.unique(moved[lv1])
    assert olds.size > 1
    moved[lv1[0]] = olds[olds != moved[lv1[0]]][0]  # another parent of the same level
    stage.bind(moved, levels, CPU)
    assert stage.plans == 2
    _, _, runs_moved = tquota.quota_plan(moved, levels)
    assert stage.runs == runs_moved
    parent_t = torch.from_numpy(snap.parent.copy())
    stage.bind(parent_t.numpy(), levels, CPU)
    assert stage.plans == 3
    parent_t[lv1[0]] = int(moved[lv1[0]])  # in place, the same tensor
    stage.bind(parent_t.numpy(), levels, CPU)
    assert stage.plans == 4 and stage.runs == runs_moved
    stage.bind(parent_t.numpy(), levels, torch.device("meta"))
    assert stage.plans == 5
    assert tquota.QuotaStage(budget=0).bind(snap.parent, levels, CPU).tier(2) == "global"
    big = np.zeros(2100, dtype=np.int32)
    assert tquota.QuotaStage().bind(big, (), CPU).tier(2) == "global"
    assert tquota.QuotaStage().bind(big[:1800], (), CPU).tier(2) == "shared"
    assert tquota.quota_smem_bytes(1800, 2, 1804) <= cuda.MAX_SMEM < \
        tquota.quota_smem_bytes(2100, 2, 2104)


def test_quota_call_binds_its_own_tree():
    """A stage that last held another tree of the same size is bound by the
    call to the call's own tree: the call plans that tree and equals
    ``refresh_runtime`` and the JAX ``refresh_runtime`` on it, whether the
    parent rows come as a host array, a host tensor or (read back) the
    rows of the engine's upload; a second call on it plans nothing."""
    a, b = _snap(11, 90, 3, 5), _snap(12, 90, 4, 3)
    assert a.parent.shape == b.parent.shape and not np.array_equal(a.parent, b.parent)
    stage = tquota.QuotaStage().bind(a.parent, a.level_tuple(), CPU)
    total = np.array([800_000, 600_000], np.int64)
    levels = b.level_tuple()
    want = np.asarray(jax.jit(jquota.refresh_runtime, static_argnums=(3,))(
        jquota.QuotaArrays(*b.arrays()), levels, total, True))
    qa = tquota.QuotaArrays(*(T(x) for x in b.arrays()))
    for parent in (b.parent, T(b.parent)):
        got = tquota.quota_fn(qa._replace(parent=parent), levels, T(total), stage=stage)
        assert_same(got, want, "quota_fn on a stage of another tree")
    assert stage.plans == 2
    assert stage.runs == tquota.quota_plan(b.parent, levels)[2]
    assert_same(tquota.refresh_runtime(qa, [T(x.astype(np.int64)) for x in levels], T(total)),
                want, "refresh_runtime")


def test_private_node_rows_are_those_the_round_loop_commits(monkeypatch):
    """``cuda.with_private_nodes`` clones exactly the node fields the round
    loop's plain version commits into (``_plain_rounds``: base_nonprod,
    base_prod, requested, the NodeFit score's requested, num_pods), equal
    to them in new storage, and keeps every other pointer of the table; the
    same table whichever tensors the layout was checked from."""
    import chip_smoke
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    monkeypatch.setattr(cuda, "_cuda_device", lambda t: t.device)  # lay out CPU tensors
    x = chip_smoke.build_inputs(*random_cluster(3, num_nodes=40, num_pods=8), CPU,
                                (BATCH_CPU, BATCH_MEMORY))
    la, nf = x["la_nodes"], x["nf_nodes"]
    args = cuda.pair_args(x["la_pods"], la, x["weights"], x["nf_pods"], nf, x["static"],
                          x["valid"])
    nodes, priv = args.keep[1], cuda.with_private_nodes(args).keep[1]
    mutable = {t.data_ptr() for t in (la.base_nonprod, la.base_prod, nf.requested,
                                      nf.req_score, nf.num_pods)}
    assert len(mutable) == 5 and len(nodes) == len(priv) == 17
    assert sum(t.data_ptr() in mutable for t in nodes) == 5
    for i, (old, new) in enumerate(zip(nodes, priv)):
        if old.data_ptr() in mutable:
            assert i in cuda._MUTABLE_NODE_PTRS and new.data_ptr() != old.data_ptr()
            assert torch.equal(new, old)
        else:
            assert i not in cuda._MUTABLE_NODE_PTRS and new is old
