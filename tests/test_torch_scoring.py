"""LoadAware and NodeResourcesFit scoring and filtering, and the fused
``score_batch`` / ``score`` kernel's plain version: the port against the
JAX package (core/loadaware.py, core/nodefit.py, core/cycle.py) on the
same numpy-made inputs, bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.core import cycle as jcycle
from koordinator_tpu.core import loadaware as jla
from koordinator_tpu.core import nodefit as jnf
from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.core import cycle as tcycle
from koordinator_tpu_torch.core import loadaware as tla
from koordinator_tpu_torch.core import nodefit as tnf
from torch_parity import STRATEGIES, assert_same, batch, to_jax, to_torch

SHAPES = [(7, 33, 0), (64, 300, 1), (40, 128, 2), (1, 5, 3)]


@pytest.mark.parametrize("P,N,seed", SHAPES)
def test_loadaware_score_and_filter(P, N, seed):
    b = batch(P, N, seed)
    j, t = to_jax(b), to_torch(b)
    assert_same(tla.loadaware_score(t[0], t[1], t[2]), jla.loadaware_score(j[0], j[1], j[2]),
                "loadaware_score")
    assert_same(tla.loadaware_filter(t[0], t[1]), jla.loadaware_filter(j[0], j[1]),
                "loadaware_filter")


LA_CASES = 15  # len(chip_smoke.la_cases(cpu, small)): the LoadAware strip's edge cases


@functools.lru_cache(maxsize=1)
def _la_cases():
    """``chip_smoke.la_cases`` on CPU tensors, with the ragged case cut from
    the fleet ``chip_smoke.py`` cuts it from: the very inputs the strip
    kernel is held to its plain versions on."""
    import chip_smoke
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.utils.fixtures import random_cluster as t_random_cluster

    cpu = torch.device("cpu")
    small = chip_smoke.build_inputs(
        *t_random_cluster(chip_smoke.SEED, num_nodes=300, num_pods=50), cpu,
        (BATCH_CPU, BATCH_MEMORY))
    return chip_smoke.la_cases(cpu, small)


def _exact_score(pods, nodes, w):
    """The LoadAware score in numpy, every quotient floored exactly and
    every sum and product wrapping as int64 does, beside the pairs on which
    the JAX function's ``floor_div_fixup`` is inside its domain (0 <= x <=
    100 d for each quotient: a used capacity in [0, cap] with cap > 0, or a
    guarded resource, and a weighted sum in [0, 100 * sum(w)] with sum(w) >
    0), where its estimate-and-fix-up is the floor."""
    with np.errstate(over="ignore"):
        base = np.where(pods.is_prod_score[:, None, None], nodes.base_prod[None],
                        nodes.base_nonprod[None])
        used = pods.est[:, None, :] + base
        cap = nodes.alloc[None]
        guard = (cap == 0) | (used > cap)
        free100 = (cap - used) * 100
        per = np.where(guard, 0, np.floor_divide(free100, np.where(cap == 0, 1, cap)))
        acc = (per * w).sum(axis=-1)
        wsum = w.sum()
        score = np.where(nodes.score_valid[None], np.floor_divide(acc, wsum), 0)
        ok = guard | ((cap > 0) & (used >= 0) & (free100 // 100 == cap - used))
        dom = ok.all(axis=-1) & (wsum > 0) & (acc >= 0) & (acc <= 100 * wsum)
    return score, dom


@pytest.mark.parametrize("case", range(LA_CASES))
def test_loadaware_cases_match_jax(case):
    """The plain versions against the JAX package's ``loadaware_score`` and
    ``loadaware_filter`` on the strip kernel's edge cases
    (``chip_smoke.la_cases``), exactly.  The filter is compared on every
    pair.  The score is compared on every pair where the JAX function's
    ``floor_div_fixup`` is inside its documented domain: every pair of a
    case whose est, bases and weights are all non-negative, and outside it
    (a negative est, base or weight puts a quotient past 100 or a weighted
    sum below 0, where the fix-up's clip is not the floor) the plain version
    equals the exact floor computed in numpy, as it does on every pair."""
    assert len(_la_cases()) == LA_CASES
    name, (pods, nodes, w) = _la_cases()[case]
    np_pods = jla.LoadAwarePodArrays(*(a.numpy() for a in pods))
    np_nodes = jla.LoadAwareNodeArrays(*(a.numpy() for a in nodes))
    jp, jn = jax.tree.map(jnp.asarray, np_pods), jax.tree.map(jnp.asarray, np_nodes)
    got = tla.loadaware_score_plain(pods, nodes, w).numpy()
    want = np.asarray(jla.loadaware_score(jp, jn, jnp.asarray(w.numpy())))
    exact, dom = _exact_score(np_pods, np_nodes, w.numpy())
    assert_same(got, exact, f"{name}: loadaware_score_plain against the exact floor")
    assert dom.any(), name
    assert_same(got[dom], want[dom], f"{name}: loadaware_score inside the JAX domain")
    if all((a >= 0).all() for a in (np_pods.est, np_nodes.base_nonprod, np_nodes.base_prod,
                                    w.numpy())):
        assert dom.all(), f"{name}: a pair left the JAX function's domain"
    assert_same(tla.loadaware_filter(pods, nodes), jla.loadaware_filter(jp, jn),
                f"{name}: loadaware_filter")


NF_CASES = 16  # len(chip_smoke.nf_cases(cpu, small)): the NodeFit strip's edge cases


@functools.lru_cache(maxsize=1)
def _nf_cases():
    """``chip_smoke.nf_cases`` on CPU tensors, the ragged case cut from the
    fleet ``chip_smoke.py`` cuts it from."""
    import chip_smoke
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.utils.fixtures import random_cluster as t_random_cluster

    cpu = torch.device("cpu")
    small = chip_smoke.build_inputs(
        *t_random_cluster(chip_smoke.SEED, num_nodes=300, num_pods=50), cpu,
        (BATCH_CPU, BATCH_MEMORY))
    return chip_smoke.nf_cases(cpu, small)


def _broken_linear_np(u, shape):
    """The shape at utilisation u, each segment's interpolation truncated
    toward zero as Go divides (the plain version's ``_broken_linear``)."""
    out = np.full_like(u, shape[-1][1])
    for i in range(len(shape) - 1, 0, -1):
        (u0, s0), (u1, s1) = shape[i - 1], shape[i]
        num = (s1 - s0) * (u - u0)
        out = np.where(u <= u1, s0 + np.sign(num) * (np.abs(num) // (u1 - u0)), out)
    return np.where(u <= shape[0][0], shape[0][1], out)


def _exact_nf(pods, nodes, static):
    """The NodeFit score in numpy under ``static``'s strategy, every quotient
    floored exactly and every sum and product wrapping as int64 does,
    beside the pairs on which the JAX functions' ``floor_div_fixup`` is
    inside its domain (0 <= x <= 100 d for each quotient that counts and
    for the weighted mean, every weight below 2**31 in magnitude so that no
    sum wraps), where its estimate-and-fix-up is the floor."""
    with np.errstate(over="ignore"):
        rs, cap = pods.req_score[:, None, :], nodes.alloc_score[None]
        req = rs + nodes.req_score[None]
        w = np.array(static.weights, dtype=np.int64)
        bypass = np.array(static.scalar_bypass, dtype=bool)
        inc = (cap != 0) & ~(bypass & (rs == 0))
        safe = np.where(cap == 0, 1, cap)
        if static.strategy == "MostAllocated":
            used = np.minimum(req, cap)
            per = np.where(cap == 0, 0, np.floor_divide(used * 100, safe))
            ok = (cap > 0) & (used >= 0) & ((used * 100) // 100 == used)
        else:
            over = (cap == 0) | (req > cap)
            free = cap - np.where(over, 0, req)
            q = np.floor_divide(free * 100, safe)
            ok = over | ((cap > 0) & (req >= 0) & ((free * 100) // 100 == free))
            if static.strategy == "RequestedToCapacityRatio":
                per = _broken_linear_np(np.where(over, 100, 100 - q), static.shape)
                inc = inc & (per > 0)
            else:
                per = np.where(over, 0, q)
        acc = np.where(inc, per * w, 0).sum(axis=-1)
        wsum = np.where(inc, w, 0).sum(axis=-1)
        safe_w = np.where(wsum == 0, 1, wsum)
        if static.strategy == "RequestedToCapacityRatio":
            num, den = 2 * acc + safe_w, 2 * safe_w
        else:
            num, den = acc, safe_w
        score = np.where(wsum == 0, 0, np.floor_divide(num, den))
        dom = (np.abs(w) < 2**31).all() & (~inc | ok).all(axis=-1) & (
            (wsum == 0) | ((wsum > 0) & (num >= 0) & (num <= 100 * den)))
    return score, dom


@pytest.mark.parametrize("case", range(NF_CASES))
def test_nodefit_cases_match_jax(case):
    """The plain ``nodefit_score`` against the JAX package's on the NodeFit
    strip's edge cases (``chip_smoke.nf_cases``) under LeastAllocated,
    MostAllocated and both RTC shapes, exactly: on every pair where the JAX
    function's ``floor_div_fixup`` is inside its documented domain (every
    pair of a case whose requests, requested scores and weights are
    non-negative and below 2**31), and outside it (a negative request or
    weight, a product or a weight sum that wraps) the plain version equals
    the exact floor computed in numpy, as it does on every pair."""
    import chip_smoke

    assert len(_nf_cases()) == NF_CASES
    name, (pods, nodes, static) = _nf_cases()[case]
    np_pods = jnf.NodeFitPodArrays(*(a.numpy() for a in pods))
    np_nodes = jnf.NodeFitNodeArrays(*(a.numpy() for a in nodes))
    jp, jn = jax.tree.map(jnp.asarray, np_pods), jax.tree.map(jnp.asarray, np_nodes)
    small_w = all(abs(v) < 2**31 for v in static.weights)
    for sname, st in chip_smoke.nf_case_statics(static):
        got = tnf.nodefit_score_plain(pods, nodes, st).numpy()
        exact, dom = _exact_nf(np_pods, np_nodes, st)
        assert_same(got, exact, f"{name} {sname}: nodefit_score_plain against the exact floor")
        if not small_w:
            assert not dom.any(), f"{name} {sname}"
            continue
        assert dom.any(), f"{name} {sname}"
        want = np.asarray(jnf.nodefit_score(jp, jn, jnf.NodeFitStatic(**vars(st))))
        assert_same(got[dom], want[dom], f"{name} {sname}: nodefit_score inside the JAX domain")
        # (RTC's rounded mean reaches 100.5 times its divisor, past the
        # documented domain, on pairs scoring 100 on every resource)
        rows = (np_pods.req_score, np_nodes.req_score, np_nodes.alloc_score)
        if (min(st.weights) >= 0 and all((a >= 0).all() for a in rows)
                and not sname.startswith("rtc")):
            assert dom.all(), f"{name} {sname}: a pair left the JAX function's domain"


def test_loadaware_guards():
    """Zero allocatable, over-used nodes and a prod-threshold branch, on
    hand-set rows the fixtures rarely hit."""
    b = list(batch(16, 40, 5))
    la_n = b[1]._replace(
        alloc=np.where(np.arange(40)[:, None] % 7 == 0, 0, b[1].alloc),
        base_nonprod=np.where(np.arange(40)[:, None] % 5 == 0, b[1].alloc * 2, b[1].base_nonprod),
        has_prod_thresholds=np.arange(40) % 3 == 0,
        prod_thresholds=np.full_like(b[1].prod_thresholds, 10),
        prod_filter_active=np.ones(40, dtype=bool),
    )
    b[1] = la_n
    j, t = to_jax(tuple(b)), to_torch(tuple(b))
    assert_same(tla.loadaware_score(t[0], t[1], t[2]), jla.loadaware_score(j[0], j[1], j[2]))
    assert_same(tla.loadaware_filter(t[0], t[1]), jla.loadaware_filter(j[0], j[1]))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("P,N,seed", SHAPES[:3])
def test_nodefit_score_and_filter(strategy, P, N, seed):
    b = batch(P, N, seed, strategy)
    j, t = to_jax(b), to_torch(b)
    assert t[5].strategy == strategy
    assert_same(tnf.nodefit_score(t[3], t[4], t[5]), jnf.nodefit_score(j[3], j[4], j[5]),
                f"nodefit_score {strategy}")
    assert_same(tnf.nodefit_filter(t[3], t[4], t[5]), jnf.nodefit_filter(j[3], j[4], j[5]),
                "nodefit_filter")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("P,N,seed", SHAPES)
def test_score_batch(strategy, P, N, seed):
    b = batch(P, N, seed, strategy)
    j, t = to_jax(b), to_torch(b)
    wts = jcycle.PluginWeights(loadaware=2, nodefit=3)
    want = jcycle.score_batch(*j, plugin_weights=wts)
    got = tcycle.score_batch(*t, plugin_weights=tcycle.PluginWeights(loadaware=2, nodefit=3))
    assert_same(got[0], want[0], "totals")
    assert_same(got[1], want[1], "feasible")


@pytest.mark.parametrize("P,N,seed", SHAPES[:2])
def test_score_fn_on_cpu_takes_the_plain_version(P, N, seed):
    """The ``score`` wrapper on CPU tensors: score_batch & live columns,
    as the JAX engine's score_fn, and no kernel launch."""
    b = batch(P, N, seed)
    j, t = to_jax(b), to_torch(b)
    valid = np.random.default_rng(seed).random(N) < 0.8
    before = cuda.SCORE.launches
    got = tcycle.score_fn(*t, torch.from_numpy(valid))
    want = jcycle.score_batch(*j)
    assert_same(got[0], want[0])
    assert_same(got[1], np.asarray(want[1]) & valid[None, :])
    assert cuda.SCORE.launches == before


@pytest.mark.parametrize("N", [1, 2, 3, 255, 256, 257, 16384])
def test_tie_helpers(N):
    pods = np.arange(0, 5000, 7, dtype=np.int32)
    assert tcycle.tie_base(N) == jcycle.tie_base(N)
    assert_same(tcycle.tie_salt(torch.from_numpy(pods), N), jcycle.tie_salt(pods, N), "tie_salt")
    masked = np.random.default_rng(N).integers(0, 300, (3, N)).astype(np.int64)
    salt = np.array([[0], [5 % N], [N - 1]], dtype=np.int64)
    assert_same(tcycle.tie_keys(torch.from_numpy(masked), torch.from_numpy(salt)),
                jcycle.tie_keys(masked, salt), "tie_keys")
