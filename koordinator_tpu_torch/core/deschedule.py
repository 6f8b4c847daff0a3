"""The fused descheduling round and the arbitrator's band order.

The port of the JAX package's ``core/deschedule.py``.  Two kernels:

- ``deschedule_round``: one LowNodeLoad round for one node pool —
  thresholds, classify, the anomaly debounce, the gates, the eviction walk,
  the total eviction rank (source nodes by usage score descending, each
  node's pods by usage score descending), per-node and total budgets as
  prefix masks, and p50/p90/p99 of the node usage percent;
- ``pod_band_rank``: the arbitrator's QoS/priority-band victim order
  (``core.evictor.pod_sort_order``'s lexsort).

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel, or raises, for CUDA tensors (``csrc/deschedule.cu``,
``csrc/bandrank.cu``, both over ``csrc/radix.cuh``).  ``eviction_rank``,
``budget_cut`` and ``util_percentiles`` are pieces of the round's plain
version; on the card the main path runs them inside the
``deschedule_round`` kernel and never calls them.

Shapes: callers pad the candidate axis to a bucket; padding rows are
``removable=False`` and inert in every output.
"""

from __future__ import annotations

import ctypes
import functools
import math
from fractions import Fraction
from typing import NamedTuple, Optional

import numpy as np
import torch

from koordinator_tpu_torch import cuda
from koordinator_tpu_torch.core.lownodeload import (
    AnomalyState,
    LNLNodeArrays,
    LNLPodArrays,
    balance_round,
    inverse_perm,
    lexsort,
    segment_starts,
    seg_excl_cumsum,
    usage_pct,
    usage_score,
)

# the kernel's limits: int32 candidate and node indices, at most MAXR resources
MAX_AXIS = (1 << 31) - 1
PERCENTILES = (50.0, 90.0, 99.0)


class DeschedRound(NamedTuple):
    """One fused round's outputs."""

    state: AnomalyState  # carried per-node detector state
    evicted: torch.Tensor  # [Pc] bool — post budget masks
    rank: torch.Tensor  # [Pc] int64 — total eviction-order rank
    under: torch.Tensor  # [N] bool
    over: torch.Tensor  # [N] bool
    source: torch.Tensor  # [N] bool
    util_pct: torch.Tensor  # [3, R] float64 — p50/p90/p99 node usage percent


def eviction_rank(nodes: LNLNodeArrays, pods: LNLPodArrays, weights) -> torch.Tensor:
    """[Pc] int64 total order over candidates, the key
    ``(-node_score[node], node, -pod_score, k)``."""
    dev = nodes.usage.device
    Pc = pods.node.shape[0]
    node = pods.node.long()
    node_score = usage_score(nodes.usage, nodes.alloc, weights)
    pod_score = usage_score(pods.usage, nodes.alloc[node], weights)
    order = lexsort((torch.arange(Pc, device=dev), -pod_score, node, -node_score[node]))
    return inverse_perm(order)


def budget_cut(evicted, rank, node, per_node_cap, total_cap) -> torch.Tensor:
    """Eviction budgets as prefix masks: in eviction order (``rank``) keep
    at most ``per_node_cap`` evictions a node, then at most ``total_cap``
    overall; negative caps are unlimited."""
    Pc = evicted.shape[0]
    dev = evicted.device
    big = 1 << 40
    pn = big if per_node_cap < 0 else per_node_cap
    tot = big if total_cap < 0 else total_cap
    order = lexsort((rank, node.long()))
    ev_o = evicted[order].long()
    prior_node = seg_excl_cumsum(ev_o, segment_starts(node.long()[order]))
    keep_node = torch.zeros(Pc, dtype=torch.bool, device=dev)
    keep_node[order] = evicted[order] & (prior_node < pn)
    order_r = torch.argsort(rank, stable=True)
    k_o = keep_node[order_r].long()
    prior_tot = torch.cumsum(k_o, dim=0) - k_o
    keep = torch.zeros(Pc, dtype=torch.bool, device=dev)
    keep[order_r] = keep_node[order_r] & (prior_tot < tot)
    return keep


def util_percentiles(nodes: LNLNodeArrays) -> torch.Tensor:
    """[3, R] float64 p50/p90/p99 of the usage percent of the valid nodes
    with non-zero allocatable, as JAX's ``nanpercentile`` computes them
    (``_quantile``, linear): NaN sorted last, q = p / 100 * (count - 1),
    the floor and ceil order statistics, low * (1 - w) + high * w; NaN
    where no node counts.  The last step is ``fma(high, w, low * (1 - w))``:
    XLA on the CPU contracts ``add(mul(low, lw), mul(high, hw))`` into that
    fused multiply-add (it agrees with the JAX package's result where the
    two-rounding form differs in the last bit), so the port rounds as the
    reference does."""
    pct = usage_pct(nodes)
    srt = torch.sort(pct, dim=0).values
    counts = (~torch.isnan(pct)).sum(dim=0).to(torch.float64)  # [R]
    q = torch.tensor(PERCENTILES, dtype=torch.float64, device=pct.device) / 100
    q = q[:, None] * (counts[None] - 1)  # [3, R]
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1 - hw
    last = counts[None] - 1
    low = torch.clamp_min(torch.minimum(low, last), 0).long()
    high = torch.clamp_min(torch.minimum(high, last), 0).long()
    lv, hv = srt.gather(0, low), srt.gather(0, high)
    return torch.tensor([_fma(*v) for v in zip(hv.flatten().tolist(), hw.flatten().tolist(),
                                                (lv * lw).flatten().tolist())],
                        dtype=torch.float64, device=pct.device).view(lv.shape)


def _fma(a: float, b: float, c: float) -> float:
    """a * b + c rounded once, as a fused multiply-add rounds it (exact
    rationals, then one correctly rounded conversion); NaN and infinities
    pass through the float expression."""
    if not all(map(math.isfinite, (a, b, c))):
        return a * b + c
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def deschedule_round_plain(state: AnomalyState, nodes: LNLNodeArrays, pods: LNLPodArrays,
                           low_pct, high_pct, weights, *, per_node_cap: int = -1,
                           total_cap: int = -1, use_deviation: bool = False,
                           consecutive_abnormalities: int = 5, consecutive_normalities: int = 3,
                           number_of_nodes: int = 0) -> DeschedRound:
    """The round as the composition of the plain functions (JAX
    ``_deschedule_round``)."""
    state, evicted, under, over, source = balance_round(
        state, nodes, pods, low_pct, high_pct, weights, use_deviation=use_deviation,
        consecutive_abnormalities=consecutive_abnormalities,
        consecutive_normalities=consecutive_normalities, number_of_nodes=number_of_nodes,
    )
    rank = eviction_rank(nodes, pods, weights)
    evicted = budget_cut(evicted, rank, pods.node, per_node_cap, total_cap)
    return DeschedRound(state=state, evicted=evicted, rank=rank, under=under, over=over,
                        source=source, util_pct=util_percentiles(nodes))


def _check_round(state, nodes, pods, low_pct, high_pct, weights):
    N, R = nodes.usage.shape
    Pc = pods.node.shape[0]
    dev = nodes.usage.device
    i64, b, f64 = torch.int64, torch.bool, torch.float64
    for what, t, dtype, shape in (
        ("anomaly", state.anomaly, b, (N,)), ("ab", state.ab, i64, (N,)),
        ("norm", state.norm, i64, (N,)), ("usage", nodes.usage, i64, (N, R)),
        ("alloc", nodes.alloc, i64, (N, R)), ("unschedulable", nodes.unschedulable, b, (N,)),
        ("valid", nodes.valid, b, (N,)), ("pod node", pods.node, torch.int32, (Pc,)),
        ("pod usage", pods.usage, i64, (Pc, R)), ("removable", pods.removable, b, (Pc,)),
        ("low_pct", low_pct, f64, (R,)), ("high_pct", high_pct, f64, (R,)),
        ("weights", weights, i64, (R,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"deschedule_round {what}: expected {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not (1 <= N <= MAX_AXIS and 1 <= Pc <= MAX_AXIS and 1 <= R <= cuda.MAXR):
        raise ValueError(f"deschedule_round takes 1..{MAX_AXIS} nodes and candidates and "
                         f"1..{cuda.MAXR} resources, got N={N}, Pc={Pc}, R={R}")
    return N, Pc, R, dev


def _packed_outputs(N: int, Pc: int, R: int, dev) -> dict:
    """The round's outputs as views of ONE device buffer (so ``to_host``
    brings them over in one copy): ab, norm, rank, util, then the bools;
    cut with as few tensor operations as the dtypes allow (each costs
    host time a call)."""
    words = 2 * N + Pc + 3 * R + (4 * N + Pc + 7) // 8
    flat = torch.empty(words, dtype=torch.int64, device=dev)
    ab, norm, rank, util, rest = flat.split_with_sizes(
        [N, N, Pc, 3 * R, words - (2 * N + Pc + 3 * R)])
    anomaly, evicted, under, over, source, _ = rest.view(torch.bool).split_with_sizes(
        [N, Pc, N, N, N, 8 * rest.shape[0] - (4 * N + Pc)])
    return dict(ab=ab, norm=norm, rank=rank, util=util.view(torch.float64).view(3, R),
                anomaly=anomaly, evicted=evicted, under=under, over=over, source=source)


@functools.lru_cache(maxsize=8)
def _scratch(device_index: int, stream: int, N: int, Pc: int, R: int, G: int) -> torch.Tensor:
    """The round's scratch for one shape on one stream, kept between calls:
    launches on one stream run in order, and the launch zeroes the control
    words it reads before writing (csrc/deschedule.cu)."""
    return torch.empty(cuda.scratch_bytes("deschedule", "koord_desched_scratch_bytes",
                                          N, Pc, R, G),
                       dtype=torch.uint8, device=torch.device("cuda", device_index))


def deschedule_round(state: AnomalyState, nodes: LNLNodeArrays, pods: LNLPodArrays, low_pct,
                     high_pct, weights, *, per_node_cap: int = -1, total_cap: int = -1,
                     use_deviation: bool = False, consecutive_abnormalities: int = 5,
                     consecutive_normalities: int = 3, number_of_nodes: int = 0) -> DeschedRound:
    """The ``deschedule_round`` kernel: one whole round for one pool.
    Tensors: state ([N] bool, int64, int64), nodes ([N, R] int64 usage and
    allocatable, [N] bool unschedulable and valid), pods ([Pc] int32 node in
    0..N-1, [Pc, R] int64 usage, [Pc] bool removable), [R] float64
    low/high percents (missing = 100), [R] int64 weights.  Caps < 0 are
    unlimited.  On CUDA one call enqueues csrc/deschedule.cu's one
    cooperative launch (``cuda.desched_grid`` main blocks and the side
    blocks) on the current stream; its outputs are views of one buffer."""
    low_pct = torch.as_tensor(low_pct, dtype=torch.float64, device=nodes.usage.device)
    high_pct = torch.as_tensor(high_pct, dtype=torch.float64, device=nodes.usage.device)
    weights = torch.as_tensor(weights, dtype=torch.int64, device=nodes.usage.device)
    N, Pc, R, dev = _check_round(state, nodes, pods, low_pct, high_pct, weights)
    kw = dict(per_node_cap=int(per_node_cap), total_cap=int(total_cap),
              use_deviation=bool(use_deviation),
              consecutive_abnormalities=int(consecutive_abnormalities),
              consecutive_normalities=int(consecutive_normalities),
              number_of_nodes=int(number_of_nodes))
    if dev.type == "cpu":
        return deschedule_round_plain(state, nodes, pods, low_pct, high_pct, weights, **kw)
    cuda._cuda_device(nodes.usage)
    ins = [t.contiguous() for t in (*state, *nodes, *pods, low_pct, high_pct, weights)]
    o = _packed_outputs(N, Pc, R, dev)
    outs = [o["anomaly"], o["ab"], o["norm"], o["evicted"], o["rank"], o["under"], o["over"],
            o["source"], o["util"]]
    G = cuda.desched_grid(N, Pc, R, kw["use_deviation"], cuda.sm_count(dev))
    params = (ctypes.c_longlong * 10)(
        N, Pc, R, int(kw["use_deviation"]), kw["consecutive_abnormalities"],
        kw["consecutive_normalities"], kw["number_of_nodes"], kw["per_node_cap"],
        kw["total_cap"], G)
    index, stream = cuda.device_index(dev), cuda.stream(dev)
    scratch = _scratch(index, stream, N, Pc, R, G)
    in_tab, out_tab = cuda._ptr_table(ins), cuda._ptr_table(outs)
    cuda.DESCHEDULE_ROUND.launch(in_tab.buffer_info()[0], out_tab.buffer_info()[0], params,
                                 scratch.data_ptr(), index, stream)
    return DeschedRound(
        state=AnomalyState(o["anomaly"], o["ab"], o["norm"]), evicted=o["evicted"],
        rank=o["rank"], under=o["under"], over=o["over"], source=o["source"],
        util_pct=o["util"],
    )


def to_host(rnd: DeschedRound) -> DeschedRound:
    """The round's outputs as numpy arrays.  The kernel's outputs share one
    device buffer and come over in ONE device-to-host copy."""
    flat = [*rnd.state, *rnd[1:]]
    dev = flat[0].device
    if dev.type == "cpu":
        host = [t.numpy() for t in flat]
    else:
        storage = flat[0].untyped_storage()
        if any(t.untyped_storage().data_ptr() != storage.data_ptr() for t in flat):
            raise ValueError("to_host takes the outputs of one deschedule_round launch")
        whole = torch.empty(0, dtype=torch.uint8, device=dev).set_(storage).cpu()
        host = [torch.empty(0, dtype=t.dtype).set_(whole.untyped_storage(), t.storage_offset(),
                                                   t.shape, t.stride()).numpy() for t in flat]
    return DeschedRound(AnomalyState(*host[:3]), *host[3:])


# ---------------------------------------------------------- band ordering


class BandKeys(NamedTuple):
    """The PodSorter's key columns of P pods (``core.evictor.PodEvictArrays``
    on a device), with the optional usage score."""

    koord_prio_rank: torch.Tensor  # [P] int8
    priority: torch.Tensor  # [P] int64
    k8s_qos_rank: torch.Tensor  # [P] int8
    koord_qos_rank: torch.Tensor  # [P] int8
    deletion_cost: torch.Tensor  # [P] int64
    eviction_cost: torch.Tensor  # [P] int64
    create_time: torch.Tensor  # [P] float64
    usage: Optional[torch.Tensor] = None  # [P] int64 (SortPodsByUsage)


def band_keys(arrays, usage_score=None, device=None) -> BandKeys:
    """The band order's key columns of ``arrays`` (PodEvictArrays), on
    ``device``."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return BandKeys(
        t(arrays.koord_prio_rank, torch.int8), t(arrays.priority, torch.int64),
        t(arrays.k8s_qos_rank, torch.int8), t(arrays.koord_qos_rank, torch.int8),
        t(arrays.deletion_cost, torch.int64), t(arrays.eviction_cost, torch.int64),
        t(arrays.create_time, torch.float64),
        None if usage_score is None else t(usage_score, torch.int64),
    )


def _band_columns(keys: BandKeys) -> list:
    """The lexsort's key columns, MINOR first: -create_time, [-usage],
    eviction cost, deletion cost, koord QoS, k8s QoS, priority, koord
    priority class."""
    cols = [("neg", keys.create_time)]
    if keys.usage is not None:
        cols.append(("neg", keys.usage))
    cols += [("", keys.eviction_cost), ("", keys.deletion_cost), ("", keys.koord_qos_rank),
             ("", keys.k8s_qos_rank), ("", keys.priority), ("", keys.koord_prio_rank)]
    return cols


def pod_band_rank_plain(keys: BandKeys) -> torch.Tensor:
    """[P] int64 eviction-order permutation (ascending = least important
    first), ``np.lexsort``'s: stable passes, the index the last tie-break,
    -0.0 equal to 0.0 and NaN last."""
    P = keys.priority.shape[0]
    cols = [-c if neg else c for neg, c in _band_columns(keys)]
    return lexsort([torch.arange(P, device=keys.priority.device)] + cols)


# the cooperative launch's scratch, by (device index, stream): grown by
# doubling, zeroed when allocated (csrc/bandrank.cu leaves its barrier's
# count at 0); launches on one stream run in order
_BAND_SCRATCH: dict = {}
# koord KeyMode of csrc/bandrank.cu
_KEY_SIGNED, _KEY_NEG_SIGNED, _KEY_NEG_F64 = 1, 2, 3


def _band_scratch(dev, index: int, stream: int, P: int, G: int) -> int:
    if G == 1:
        return 0
    need = cuda.scratch_bytes("bandrank", "koord_band_scratch_bytes", P, G)
    buf = _BAND_SCRATCH.get((index, stream))
    if buf is None or buf.numel() < need:
        buf = torch.zeros(1 << (need - 1).bit_length(), dtype=torch.uint8, device=dev)
        _BAND_SCRATCH[(index, stream)] = buf
    return buf.data_ptr()


def pod_band_rank(keys: BandKeys) -> torch.Tensor:
    """The ``pod_band_rank`` kernel: the PodSorter permutation of P pods
    (``band_keys``), [P] int64, bit-identical to
    ``core.evictor.pod_sort_order``.  On CUDA one launch of
    csrc/bandrank.cu (one block up to ``cuda.BAND_SMALL_MAX`` pods, a
    cooperative grid above) through one packed descriptor: the keys less
    their minima, packed into 64-bit words, sorted by the digits that
    vary."""
    P = keys.priority.shape[0]
    dev = keys.priority.device
    want = {"koord_prio_rank": torch.int8, "priority": torch.int64, "k8s_qos_rank": torch.int8,
            "koord_qos_rank": torch.int8, "deletion_cost": torch.int64,
            "eviction_cost": torch.int64, "create_time": torch.float64, "usage": torch.int64}
    for name, t in zip(BandKeys._fields, keys):
        if t is None:
            continue
        if t.dtype != want[name] or tuple(t.shape) != (P,) or t.device != dev:
            raise ValueError(f"pod_band_rank {name}: expected {want[name]} ({P},) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if P > MAX_AXIS:
        raise ValueError(f"pod_band_rank takes at most {MAX_AXIS} pods, got {P}")
    if dev.type == "cpu":
        return pod_band_rank_plain(keys)
    out = torch.empty(P, dtype=torch.int64, device=dev)
    if P == 0:
        return out
    cols = [(neg, c.contiguous()) for neg, c in _band_columns(keys)]
    index, stream = cuda.device_index(dev), cuda.stream(dev)
    G = cuda.band_grid(P, cuda.sm_count(dev))
    words = [len(cols), P, G]
    for neg, c in cols:
        words += [c.data_ptr(), c.element_size(),
                  (_KEY_NEG_F64 if c.dtype == torch.float64 else _KEY_NEG_SIGNED) if neg
                  else _KEY_SIGNED]
    cuda.POD_BAND_RANK.launch((ctypes.c_longlong * len(words))(*words), out.data_ptr(),
                              _band_scratch(dev, index, stream, P, G), index, stream)
    return out
