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


def nodefit_args(strategy: str = "LeastAllocated") -> NodeFitArgs:
    args = NodeFitArgs(strategy=ScoringStrategyType(strategy))
    if strategy == "RequestedToCapacityRatio":
        # a non-monotone shape exercises the truncating interpolation on
        # decreasing segments
        args.shape = [(0, 2), (40, 10), (70, 3), (100, 6)]
    return args


def batch(P: int, N: int, seed: int, strategy: str = "LeastAllocated"):
    """(la_pods, la_nodes, weights, nf_pods, nf_nodes, nf_static) as numpy,
    from ``random_cluster`` through the JAX package's builders; the
    NodeFit static is the JAX package's."""
    pods, nodes = random_cluster(seed, num_nodes=N, num_pods=P, pods_per_node=4,
                                 with_aggregated=True)
    la_args, nf_args = LoadAwareArgs(), nodefit_args(strategy)
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
