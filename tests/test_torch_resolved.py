"""The SCHEDULE cycle: the port's resolved engine and sequential scan
against the JAX package's (core/resolved.py, core/cycle.py), and against
each other, on the same numpy-made inputs, bit for bit.

Plain pods (no gang, quota or reservation).  The cases cover commit caps
of 1, 16 and more than the pod count (padding slots clamped onto column
N-1), both tie-breaks, node axes that are not a multiple of the block size,
pod counts that are not a multiple of it, a shuffled queue order, and a
live-column mask."""

import jax
import numpy as np
import pytest
import torch

from koordinator_tpu.core import cycle as jcycle
from koordinator_tpu.core import resolved as jres
from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.core import cycle as tcycle
from koordinator_tpu_torch.core import resolved as tres
from torch_parity import STRATEGIES, assert_same, batch, to_jax, to_torch

CASES = [  # (P, N, seed, commit_cap, block_size)
    (20, 30, 0, 1, 16),
    (50, 300, 1, 16, 16),
    (64, 128, 2, 100, 16),
    (33, 77, 3, 16, 8),
    (64, 250, 4, 3, 32),
]


def _mask_and_order(P, N, seed):
    rng = np.random.default_rng(seed + 100)
    return rng.random((P, N)) < 0.9, rng.permutation(P).astype(np.int32)


@pytest.mark.parametrize("tie", ["salted", "index"])
@pytest.mark.parametrize("P,N,seed,cap,bs", CASES)
def test_resolved_matches_jax_and_scan(P, N, seed, cap, bs, tie):
    b = batch(P, N, seed)
    j, t = to_jax(b), to_torch(b)
    extra, order = _mask_and_order(P, N, seed)
    jh, js, jrounds = jax.jit(
        lambda a, e, o: jres.schedule_batch_resolved(
            *a, extra_feasible=e, order=o, commit_cap=cap, block_size=bs, tie_break=tie,
            impl="matrix_packed", return_rounds=True,
        )
    )(j, extra, order)
    th, ts, trounds = tres.schedule_batch_resolved(
        *t, extra_feasible=torch.from_numpy(extra), order=torch.from_numpy(order),
        commit_cap=cap, block_size=bs, tie_break=tie, return_rounds=True,
    )
    assert_same(th, jh, "hosts")
    assert_same(ts, js, "scores")
    assert trounds == int(jrounds)
    sh, ss = tcycle.schedule_batch(
        *t, extra_feasible=torch.from_numpy(extra), order=torch.from_numpy(order), tie_break=tie
    )
    assert_same(th, sh, "hosts vs the port's scan")
    assert_same(ts, ss, "scores vs the port's scan")
    assert (np.asarray(th) >= 0).any()


@pytest.mark.parametrize("tie", ["salted", "index"])
@pytest.mark.parametrize("P,N,seed", [(24, 40, 5), (48, 90, 6)])
def test_scan_matches_jax(P, N, seed, tie):
    b = batch(P, N, seed)
    j, t = to_jax(b), to_torch(b)
    extra, order = _mask_and_order(P, N, seed)
    jh, js = jax.jit(
        lambda a, e, o: jcycle.schedule_batch(*a, extra_feasible=e, order=o, tie_break=tie)
    )(j, extra, order)
    th, ts = tcycle.schedule_batch(
        *t, extra_feasible=torch.from_numpy(extra), order=torch.from_numpy(order), tie_break=tie
    )
    assert_same(th, jh, "hosts")
    assert_same(ts, js, "scores")


@pytest.mark.parametrize("strategy", STRATEGIES[1:])
def test_other_strategies_take_the_scan(strategy):
    P, N = 30, 60
    b = batch(P, N, 7, strategy)
    j, t = to_jax(b), to_torch(b)
    jh, js = jres.schedule_batch_resolved(*j)
    th, ts = tres.schedule_batch_resolved(*t)
    assert_same(th, jh, strategy)
    assert_same(ts, js, strategy)


@pytest.mark.parametrize("P,N,seed,cap", [(50, 300, 8, 16), (16, 256, 9, 100)])
def test_schedule_fn_on_cpu_matches_jax_engine_kernel(P, N, seed, cap):
    """The ``schedule`` wrapper on CPU tensors against the JAX engine's
    jitted cycle shape: live columns x real pod rows, queue order, and
    no kernel launch."""
    b = batch(P, N, seed)
    j, t = to_jax(b), to_torch(b)
    rng = np.random.default_rng(seed)
    valid = rng.random(N) < 0.85
    p_real = P - 3
    order = rng.permutation(P).astype(np.int32)
    base = valid[None, :] & (np.arange(P) < p_real)[:, None]
    jh, js = jres.schedule_batch_resolved(
        *j, extra_feasible=base, order=order, commit_cap=cap, impl="matrix_packed"
    )
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    th, ts, pre, rounds, warm = tres.schedule_fn(
        *t, torch.from_numpy(valid), p_real, torch.from_numpy(order), commit_cap=cap
    )
    assert_same(th, jh, "hosts")
    assert_same(ts, js, "scores")
    assert_same(pre, th, "precommit")
    assert int(rounds) > 0
    jwarm = jres.schedule_batch_resolved(
        *j, extra_feasible=base, order=order, commit_cap=cap, impl="matrix_packed",
        return_warm=True,
    )[2]
    for g, w in zip(warm, jwarm):
        assert_same(g, w, "init carry")
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before


def test_resolved_refuses_constraints():
    """The scan's constraint branches and its extra-score branch are
    served: under MostAllocated the resolved engine takes the scan with
    gang, quota and reservation inputs and extra scores, and equals the
    JAX engine's hosts and scores (0 rounds, the post-commit hosts as
    ``precommit``).  Under LeastAllocated the extra channel is served: a
    random mask and extra scores in [0, 200] (with their bound) give the
    JAX engine's hosts, scores and round count, also with gang, quota and
    reservation inputs."""
    import __graft_entry__ as ge
    from torch_parity import constraints_to_torch

    gang, quota, rsv = ge._example_constraints(8, 16, Rf=5, seed=2)
    g, q, r = constraints_to_torch(gang, quota, rsv)
    mb = batch(8, 16, 0, "MostAllocated")
    most, jmost = to_torch(mb), to_jax(mb)
    xs0 = np.random.default_rng(4).integers(-50, 101, (8, 16)).astype(np.int64)
    for jkw, tkw in (({"gang": gang}, {"gang": g}), ({"quota": quota}, {"quota": q}),
                     ({"reservation": rsv}, {"reservation": r}),
                     ({"extra_scores": xs0}, {"extra_scores": torch.from_numpy(xs0)})):
        jh, js, jr, jp = jres.schedule_batch_resolved(*jmost, return_rounds=True,
                                                      return_precommit=True, **jkw)
        th, ts, tr, tp = tres.schedule_batch_resolved(*most, return_rounds=True,
                                                      return_precommit=True, **tkw)
        assert_same(th, jh, f"hosts {sorted(tkw)}")
        assert_same(ts, js, f"scores {sorted(tkw)}")
        assert_same(tp, jp, f"precommit {sorted(tkw)}")
        assert tr == int(jr) == 0
    b = batch(8, 16, 0)
    j, t = to_jax(b), to_torch(b)
    rng = np.random.default_rng(5)
    extra = rng.random((8, 16)) < 0.8
    xsc = rng.integers(0, 201, (8, 16)).astype(np.int64)
    for con in ({}, {"gang": (gang, g), "quota": (quota, q), "reservation": (rsv, r)}):
        jkw = {k: v[0] for k, v in con.items()}
        tkw = {k: v[1] for k, v in con.items()}
        jh, js, jr = jres.schedule_batch_resolved(
            *j, extra_feasible=extra, extra_scores=xsc, extra_score_bound=200,
            impl="matrix_packed", return_rounds=True, **jkw)
        th, ts, tr = tres.schedule_batch_resolved(
            *t, extra_feasible=torch.from_numpy(extra), extra_scores=torch.from_numpy(xsc),
            extra_score_bound=200, return_rounds=True, **tkw)
        assert_same(th, jh, "hosts")
        assert_same(ts, js, "scores")
        assert tr == int(jr)
