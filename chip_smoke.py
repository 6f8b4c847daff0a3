"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of ``koordinator_tpu_torch/csrc`` with nvcc;
  3. each kernel against its plain PyTorch version on the card, on the same
     inputs, requiring exact equality (integer outputs, tolerance 0): first
     at a small shape across commit caps, then the round loop's edge cases
     over a grid of many blocks (``ROUND_CASES`` and ``hot_node`` at 2,000
     nodes), the reservation rows' edge cases (``rsv_cases``; one launch
     writes both rows, ``rsv_rows``), the LoadAware strip's (``la_cases``:
     ``la_score`` and ``loadaware_score_and_filter``), then at the main
     path's full shape
     (1,024 pods x 16,384 node columns, and the reservation rows at the
     descheduler's one-pod shape), with each one's time, and the round
     loop under its four knob settings and at the one-pod probe
     (``check_round_loop``);
  4. the warm-start and residency kernels the same way (``sched_refresh``
     at 16, 128 and 1,024 dirty rows, padded indices included, also held
     against a cold key build; ``sched_rounds``, asserting the carry is
     bit-identical after the launch; ``dstate_scatter`` with duplicate
     padded indices, beside the equivalent ``index_copy_`` calls, and on
     ``scatter_cases``: rows of 1 to 56 bytes, one row, scatters back to
     back;
     ``dstate_gate`` at NaN and boundary update times, and in phase 3 on
     ``check_gate_cases``: 1, 257 and 1,001 rows, five expiry modes,
     rebound and back, strided rows refused and rows moved by ``set_``
     and ``resize_``), and the whole-table upload (``dstate_rows``, a
     transfer);
  5. the cold path at 10,000 nodes x 1,000 pods (``random_cluster``) on
     host-built node arrays (``device_state=False``): ``Engine.score``,
     then three cold SCHEDULE cycles with the placements bound between
     cycles through ``ClusterState.assign_pod`` and a fresh 1,000 pending
     pods each cycle;
  6. the warm path at the same size in the default serving configuration
     (resident node tables, warm start): one fixed batch through five
     SCHEDULE cycles — cold; unchanged store; NodeMetric updates on 100
     nodes; a metric-expiry gate flip of 50 nodes with no row stamp
     moving; updates on 5,000 nodes (past the 25% cold fallback) — each
     with the launches the plan names;
  7. the constraint path: gangs, quota groups and reservations through
     six cycles (``CON_CYCLES``) and ``Engine.quota_refresh``;
  8. the placement-and-devices kernels (``placement``, also on
     ``placement_cases`` in phase 3: N below and across the tile, unions
     over several phases; ``dev_feasible``,
     ``ds_score``, ``dstate_extend``, and the score and schedule kernels
     with a random mask and extra scores) at the phase's shapes, then the
     placement-and-devices path: selectors, taints, anti-affinity and
     GPU/RDMA/cpuset pods over a fleet with device inventories and NUMA
     topologies through six cycles (``PLACE_CYCLES``), the stores' device
     state compared after ``assume``;
  9. the strategies' kernels: ``score`` under MostAllocated and
     RequestedToCapacityRatio (the default and a non-monotone shape), the
     scan (the int64 key build and the step kernel; plain and constrained,
     both tie-breaks, with and without extras; its invariant cases, among
     them more pods and more block maxima than the step kernel's threads)
     and the int64-key matrix engine (plain and
     constrained) against their plain versions, at the small and the full
     shape; then the matrix route, ``schedule_fn(impl="matrix")`` at full
     width against the int32 route;
  10. the strategies path: MostAllocated over the constraint phase's store
     and batch (``MOST_CYCLES``, then ``Engine.quota_refresh``) and
     RequestedToCapacityRatio over the placement phase's (``RTC_CYCLES``),
     every SCHEDULE a cold scan;
  11. the explain slice's kernels (``la_score``, ``nf_score`` under the
     three strategies, ``loadaware_score_and_filter``) against their plain
     versions at 64 x 512 and at the full shape (phase 3 and 9's places;
     the LoadAware strip's records with events around a run of 100 calls
     over 100, ``ms_run``: its device time where the host keeps ahead; and
     the ``fill_`` floor of its outputs, one call and a run: the profiler
     read no device time for them late in a full run);
     the LoadAware library call ``loadaware_score_and_filter`` at full
     width from the snapshot builders;
  12. the sidecar path: the port's ``SidecarServer`` on the card and a
     twin on the CPU, fed the same raw KTPU frames over sockets (HELLO;
     APPLY of the fleet and the constraint set; SCORE with ``breakdown``;
     SCHEDULE, warm after 100 metric updates, and with ``assume``;
     SCHEDULE and EXPLAIN of 8 probe pods; QUOTA_REFRESH, PING, ECHO; a
     refused verb), every reply byte-identical, each verb's wall time on
     the client's clock;
  13. the descheduler: ``deschedule_round`` against its plain version at 300
     nodes x 50 candidates (bucket 64; deviation, debounce, caps, the
     ``number_of_nodes`` gate) and at bench/bench_sim.py's 10,000 x 20,000
     (bucket 32,768), ``pod_band_rank`` at P = 64 and 32,768 (ties on every
     key, with and without usage) and on ``band_cases`` (the one-block
     limit less one, at it and above), integers exactly and percentiles bit for
     bit; then the descheduler path, appended to the sidecar phase: one
     ReplicaSet-owned pod a node, three dry-run DESCHEDULE ticks (the
     debounce), one with ``verify``, one executing with a total cap of 32,
     every reply byte-identical to the CPU twin's, each tick's launches
     counted from 0 and its split (``_pool_arrays``, kernel, arbitrate,
     probe, execute); and the round again at the fleet's own shape, on the
     pool's inputs after the last tick.
  14. the koordlet and the sharded sidecar: ``shard_score_map`` against its
     plain version and the unsharded ``score`` kernel at 64 x 512 (S = 1, 2,
     4) and at the full shape (S = 4), under the three strategies, with and
     without extra scores, each block also launched alone into sentinel
     buffers (and, in phase 3, on ``shard_cases``: blocks off the kernel's
     tiles, P = 1 and 65, the generic widths); ``aggregate_node_metrics`` against its plain
     version bit for bit at 64 x 64 (empty series, NaN, ±0.0, tied times,
     counts 20 and 10), on ``agg_cases`` (T from 1 to 2,048 across both
     kernels, the compaction's boundaries, the full sort's valid 1e300,
     +inf and NaN, store windows wrapping the ring) and at the fleet's
     windows, each window timed; then the path: a
     ``MetricSeriesStore`` of 256 ticks for the fleet's nodes and assigned
     pods, ``NodeMetricProducer.produce`` on the card equal to a CPU twin's,
     the NodeMetrics as APPLY to a card sidecar with ``shards=4``, a CPU twin
     and an unsharded card sidecar, SCORE and SCHEDULE cold, warm after a
     second report tick and with ``assume`` (replies byte-identical), and
     the mesh (``shard_map=True`` over the card four times) equal to slice
     mode, each stage's wall time printed.
  Every result of phases 5 to 8 and 10 must equal the plain path's (the
  same engine on the CPU, fed a twin store) and, in phases 6 to 8, a
  warm-disabled engine's on the card; every kernel of each path must have
  launched during that path, counted from 0 just before it.

The last lines are the ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}``.  It imports nothing of the JAX package.

    python3 chip_smoke.py --rounds [--root DIR]

runs only the round loop's study (``check_round_loop`` with the phase
split and a round's synchronisation from the study build
``csrc/roundstudy.cu``, the extension's edge cases and its timing) and
prints one ``round_study`` JSON line, importing the port from ``DIR``
when given (another checkout with the study build unpacked beside, to
compare two versions in one run).

    python3 chip_smoke.py --scan [--root DIR]

runs only the scan's study (``scan_study``) and prints one ``scan_study``
JSON line;

    python3 chip_smoke.py --spread [--root DIR]

prints one ``spread`` JSON line, one sample of the key builds, the int64
constrained round loop and the RequestedToCapacityRatio cycles
(``spread_study``): run it on two checkouts alternately in one call.

    python3 chip_smoke.py --agg [--root DIR]

prints one ``agg_study`` JSON line (``agg_study``): ``aggregate_node_metrics``
at every window of a report tick with its stages, and ``dstate_scatter``'s
call, run and stages beside ``index_copy_``; one sample a run, for two
checkouts alternated in one call.

    python3 chip_smoke.py --rsv [--root DIR]

prints one ``rsv_study`` JSON line (``rsv_study``): the reservation rows'
calls at the check shape and at the descheduler's one-pod shape, the
reservation stage of a constrained cycle split by step, and the executing
DESCHEDULE tick's stages; one sample a run, for two checkouts alternated
in one call.

    python3 chip_smoke.py --shard [--root DIR]
    python3 chip_smoke.py --gate [--root DIR]

print one ``shard_study`` JSON line (``shard_study``: ``shard_score_map``'s
four blocks at 1,024 x 16,384 through the public entry point and as the
mesh launches them, beside ``score``) and one ``gate_study`` JSON line
(``gate_study``: ``dstate_gate`` at 16,384 rows and at 1, its call split
by step on the host clock, and ``dstate_extend`` beside ``F.pad``); one
sample a run, for two checkouts alternated in one call (``--shard`` times
only the public entry points and ``ShardedEngine._score_mesh``, so
``--root`` may name a checkout from before the mesh's redesign;
``--gate`` needs a checkout with ``GateStage``; it also prints what the
public entry gives on strided rows and on rows moved under their tensors,
``gate_fault_cases``).

    python3 chip_smoke.py --place [--root DIR]
    python3 chip_smoke.py --band [--root DIR]
    python3 chip_smoke.py --restate [--root DIR]

print one ``place_study`` JSON line (``place_study``: ``placement`` at 256
x 16,384 with a 16,384-wide label vocabulary, its call split by step,
then every call of the placement and strategies phases replayed), one
``band_study`` JSON line (``band_study``: ``pod_band_rank`` at P = 32,768
with and without usage and at the descheduler path's arbitrations, with
the study build's split by step on this tree) and one ``restate_study``
JSON line (the kernel table's ``sched_refresh``, ``sched_refresh_con``,
``quota`` and ``quota_limit`` rows measured again); ``--root`` takes
another checkout of the port, with the gate's ``GateStage`` or later.

    python3 chip_smoke.py --refresh [--root DIR]
    python3 chip_smoke.py --quota [--root DIR]

print one ``refresh_study`` JSON line (``refresh_study``: ``sched_refresh``
and ``sched_refresh_con`` at 1,024 x 16,384, without and with extras, at
D = 64, 128, 1,024 and 4,096, each held equal to its plain version first:
the call, its device time and activities, its host time, with the
cycle's launch arguments built beside as the engine builds them, and at
D = 128 the call split by step) and one ``quota_study`` JSON line
(``quota_study``: ``quota`` and ``quota_limit`` on the 500-group tree, the
constraint path's 100 groups and a 6,000-group tree past the shared-memory
tier, with their split, and the engine's cache miss); ``--root`` takes
another checkout of the port: one from before the planned refreshes
(with ``core.quota.flat_levels``) or a later one.

    python3 chip_smoke.py --la [--root DIR]

prints one ``la_study`` JSON line (``la_study``): ``la_score`` and
``loadaware_score_and_filter`` through ``core.loadaware``'s entry points
at 1,024 x 16,384, at the library path's 1,000 x 10,000 and at the
sidecar breakdown SCORE's shape, each equal to its plain version first:
the call, its device time and activities, its host time, the call split
by step and the ``fill_`` floor of its outputs; the ``-Xptxas -v`` lines
of the breakdown library and of ``score_kernel``; the edge cases of
``la_cases`` with any mismatch recorded.  ``--root`` takes another
checkout of the port (one from before the strip kernel or a later one):
run two checkouts alternately in one call.

    python3 chip_smoke.py --nf [--root DIR]
    python3 chip_smoke.py --dev [--root DIR]

print one ``nf_study`` JSON line (``nf_study``: ``nf_score`` at 1,024 x
16,384 under the four strategy shapes and at the sidecar breakdown
SCORE's shape, with the call, device time and activities, host time and
split, the ``fill_`` floor; the ``ptxas`` lines of the breakdown
library, ``score_kernel`` and ``rounds_kernel``; the mismatches of
``nf_cases`` and ``repair_cases``) and one ``dev_study`` JSON line
(``dev_study``: ``dev_feasible`` at 16 x 16,384 with Gm 8 and 16 and at
128 and 200 signatures, with ``DeviceSigs`` and the packed block; the
engine's dense device block at the placement path's shapes; the device
library's ``ptxas`` lines; ``dev_cases`` and the rows' binding).
``--root`` takes another checkout of the port, from before the NodeFit
strip or a later one (the older ``dev_feasible`` takes its signatures on
the card).
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

SEED = 7
NUM_NODES = 10_000
NUM_PODS = 1_000
CYCLES = 3

# H100 SXM published peaks (NVIDIA's data sheet): HBM bandwidth, and the
# float32 rate outside the tensor cores (67 TFLOP/s, an FMA counted as two
# operations).  The kernels' work is integer; the data sheet gives no
# integer rate outside the tensor cores, and Hopper's INT32 units issue
# about half as many operations a clock as its FP32 units, with int64
# multiplies and divisions taking several instructions each.  So the
# float32 rate is an upper bound on the integer rate, and an operation
# bound computed with it is a lower bound on the time.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# the host link of an H100 SXM: PCIe Gen5 x16, 128 GB/s both ways together
# (NVIDIA's data sheet), so 64 GB/s host->device
PCIE_BYTES_PER_S = 64e9


class Mismatch(AssertionError):
    """A check of this script failed."""


def fail(msg: str) -> None:
    raise Mismatch(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, setup=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up,
    by CUDA events; ``setup`` runs outside the timed span."""
    times = []
    for i in range(reps + 1):
        if setup is not None:
            setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, launches: int = 100) -> float:
    """Device time of one call of ``fn`` over a run of ``launches``
    back-to-back calls: CUDA events around the run, divided by the count,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


class GcTimer:
    """Host milliseconds spent in Python's cyclic garbage collector while
    installed (``gc.callbacks``), by generation; ``take`` returns the sums
    since the last take."""

    def __enter__(self):
        import gc

        self._gc, self._start, self._ms = gc, None, {}
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            gen = info.get("generation")
            self._ms[gen] = self._ms.get(gen, 0.0) + (time.perf_counter() - self._start) * 1e3
            self._start = None

    def __exit__(self, *exc):
        self._gc.callbacks.remove(self._cb)

    def take(self) -> dict:
        out, self._ms = self._ms, {}
        return out


class LaunchTimer:
    """CUDA events around every kernel launch made while installed, on the
    launching stream: device milliseconds by kernel.  ``take`` returns the
    sums since the last take."""

    def __enter__(self):
        from koordinator_tpu_torch import cuda

        self._cuda, self._orig, self._spans = cuda, cuda.Kernel.launch, []
        names = {id(k): name for name, k in cuda.KERNELS.items()}
        orig, spans = self._orig, self._spans

        def launch(kernel, *args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            orig(kernel, *args)
            end.record()
            spans.append((names[id(kernel)], start, end))

        cuda.Kernel.launch = launch
        return self

    def __exit__(self, *exc):
        self._cuda.Kernel.launch = self._orig

    def take(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for name, start, end in self._spans:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        self._spans.clear()
        return out


def pair_ops(R: int, Rf: int, Rs: int) -> int:
    """Integer operations of one pair evaluation (csrc/pair.cuh), counted
    as arithmetic and comparisons: loadaware score 9 per resource + 2,
    NodeFit LeastAllocated 10 per resource + 2, NodeFit fit 5 per resource
    + 2, loadaware filter 7 per resource + 3, the weighted total 3."""
    return 9 * R + 2 + 10 * Rs + 2 + 5 * Rf + 2 + 7 * R + 3 + 3


def bound_ms(nbytes: float, ops: float) -> tuple:
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def require_equal(what: str, got, want) -> int:
    """Fail unless every output equals the plain version's exactly; return
    the largest absolute difference found (0)."""
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = torch.as_tensor(g).cpu().to(torch.int64), torch.as_tensor(w).cpu().to(torch.int64)
        if g.shape != w.shape:
            fail(f"{what}: output {i} has shape {tuple(g.shape)}, plain {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g - w).abs().max()))
        if not torch.equal(g, w):
            fail(f"{what}: output {i} differs from the plain version "
                 f"(first at {(g != w).nonzero()[:5].tolist()})")
    return err


def require_same(what: str, got, want) -> int:
    """Fail unless every output equals the plain version's bit for bit
    (NaN payloads included); return 0, the largest difference."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.contiguous().cpu(), w.contiguous().cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{what}: output {i} is {g.dtype} {tuple(g.shape)}, plain {w.dtype} "
                 f"{tuple(w.shape)}")
        if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
            fail(f"{what}: output {i} differs from the plain version")
    return 0


def build_inputs(pods, nodes, device, extra_scalars):
    """Dense inputs of one cycle as the engine builds them: (la_pods,
    nf_pods, la_nodes, nf_nodes, valid, weights, static, order, P)."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.core.gang import GangPodArrays, queue_sort_perm
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.service.state import ClusterState, next_bucket
    from koordinator_tpu_torch.utils.fixtures import NOW

    st = ClusterState(extra_scalars=extra_scalars, device_state=False)
    for n in nodes:
        st.upsert_node(n)
    eng = Engine(st, device=device)
    snap = st.publish(NOW)
    p_bucket = next_bucket(len(pods), 16)
    la_pods, nf_pods = eng._pod_arrays(pods, p_bucket)
    return dict(
        la_pods=la_pods, nf_pods=nf_pods,
        la_nodes=convert.la_nodes(snap.la_nodes, device),
        nf_nodes=convert.nf_nodes(snap.nf_nodes, device),
        valid=convert.tensor(snap.valid, device),
        weights=eng._weights, static=eng._nf_static,
        order=queue_sort_perm(GangPodArrays(*map(torch.from_numpy, st.gangs.build(
            pods, [None] * len(pods), p_bucket)[0]))).to(device),
        p_real=len(pods), state=st,
    )


def ragged(inp, N: int, P: int):
    """The first N node columns and P pods, in a shuffled queue order: a
    node axis that is not a multiple of the block size and a pod axis that
    is not a power of two."""
    cut = lambda nt, n: type(nt)(*(a[:n] for a in nt))  # noqa: E731
    perm = np.random.default_rng(SEED).permutation(P)
    dev = inp["valid"].device
    return dict(
        inp, la_pods=cut(inp["la_pods"], P), nf_pods=cut(inp["nf_pods"], P),
        la_nodes=cut(inp["la_nodes"], N), nf_nodes=cut(inp["nf_nodes"], N),
        valid=inp["valid"][:N].clone(), order=torch.from_numpy(perm).to(dev), p_real=P,
    )


def check_kernels(inp, commit_cap: int, timed: bool):
    """Each kernel against its plain version on the inputs' device (raises
    ``Mismatch``); returns the per-kernel records when ``timed``."""
    from koordinator_tpu_torch.core import resolved
    from koordinator_tpu_torch.core.cycle import PluginWeights, score_batch, score_fn

    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    la_nodes, nf_nodes, valid = inp["la_nodes"], inp["nf_nodes"], inp["valid"]
    w, static = inp["weights"], inp["static"]
    pw = PluginWeights()
    P, N = la_pods.est.shape[0], valid.shape[0]
    R, Rf, Rs = la_pods.est.shape[1], nf_pods.req.shape[1], nf_pods.req_score.shape[1]
    BS = 16

    def plain_score():
        t, f = score_batch(la_pods, la_nodes, w, nf_pods, nf_nodes, static, pw)
        return t, f & valid[None, :]

    def kernel_score():
        return score_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid)

    err = {"score": require_equal(f"score {P}x{N}", kernel_score(), plain_score())}

    _, q_la, q_nf, salts, pod_ok = resolved.kernel_queue(
        la_pods, nf_pods, valid, inp["p_real"], inp["order"]
    )
    q_extra = pod_ok[:, None] & valid[None, :]

    def kernel_keys():
        return resolved.schedule_keys(
            q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok, salts, BS
        )

    def plain_keys():
        return resolved.build_keys_plain(
            q_la, la_nodes, w, q_nf, nf_nodes, static, pw, q_extra, salts, BS
        )

    keys = kernel_keys()
    err["schedule_keys"] = require_equal(f"schedule_keys {P}x{N}", keys, plain_keys())
    M0, Mb0, feas_T = keys

    def kernel_rounds(M, Mb):
        return resolved.schedule_rounds(
            M, Mb, feas_T, q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok, salts,
            commit_cap, BS,
        )

    def plain_rounds(M, Mb):
        return resolved.run_rounds_plain(
            M, Mb, feas_T, q_la, la_nodes, w, q_nf, nf_nodes, static, pw, q_extra, salts,
            commit_cap, BS,
        )

    hk, sk, rk = kernel_rounds(M0.clone(), Mb0.clone())
    hp, sp, rp = plain_rounds(M0.clone(), Mb0.clone())
    err["schedule_rounds"] = require_equal(
        f"schedule_rounds {P}x{N} K={commit_cap}", (hk, sk, rk),
        (hp, sp, torch.tensor(rp, dtype=torch.int32)),
    )
    rounds = int(rp)
    print(f"  {P} pods x {N} nodes, commit_cap {commit_cap}: kernels equal plain, {rounds} rounds")
    if not timed:
        return None

    work = {}

    def reset():
        work["M"], work["Mb"] = M0.clone(), Mb0.clone()

    recs = []
    pods_b = nbytes(*la_pods, *nf_pods)
    nodes_b = nbytes(*la_nodes, *nf_nodes, valid)
    ops = pair_ops(R, Rf, Rs)
    b, by = bound_ms(pods_b + nodes_b + P * N * 9, P * N * ops)
    recs.append(dict(
        name="score", source="koordinator_tpu_torch/csrc/score.cu",
        replaces="koordinator_tpu/service/engine.py:134",
        ms=cuda_ms(kernel_score), plain_ms=cuda_ms(plain_score), bound_ms=b, bound_by=by,
        max_abs_err=err["score"],
    ))
    keys_out = nbytes(M0, Mb0, feas_T)
    b, by = bound_ms(pods_b + nodes_b + keys_out, P * N * (ops + 4))
    recs.append(dict(
        name="schedule_keys", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/core/resolved.py:757",
        ms=cuda_ms(kernel_keys), plain_ms=cuda_ms(plain_keys), bound_ms=b, bound_by=by,
        max_abs_err=err["schedule_keys"],
    ))
    # the round loop's data-dependent work, counted for this run: each round
    # reduces Mb ([NB, P]) and rescores and re-reduces K touched rows; the
    # bytes are Mb once, the touched rows of M written and of la_feas_T
    # read, the pod and node rows once, and the outputs
    NB = Mb0.shape[0]
    K = min(commit_cap, P)
    r_ops = rounds * (NB * P + K * P * (ops + 4) + K * BS * P)
    r_bytes = nbytes(Mb0) + rounds * K * P * (4 + 1) + pods_b + nodes_b + P * (4 + 8)
    b, by = bound_ms(r_bytes, r_ops)
    recs.append(dict(
        name="schedule_rounds", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/core/resolved.py:835",
        ms=cuda_ms(lambda: kernel_rounds(work["M"], work["Mb"]), setup=reset),
        plain_ms=cuda_ms(lambda: plain_rounds(work["M"], work["Mb"]), reps=3, setup=reset),
        bound_ms=b, bound_by=by, rounds=rounds, max_abs_err=err["schedule_rounds"],
    ))
    return recs


def perturbed_nodes(la_nodes, nf_nodes, rows):
    """A copy of the node inputs in which ``rows`` changed as a metric
    update or a bind changes them: more load, more requested capacity, one
    more pod, the LoadAware filter switched."""
    la = la_nodes._replace(
        base_nonprod=la_nodes.base_nonprod.clone(), base_prod=la_nodes.base_prod.clone(),
        filter_active=la_nodes.filter_active.clone(),
    )
    nf = nf_nodes._replace(requested=nf_nodes.requested.clone(),
                           num_pods=nf_nodes.num_pods.clone())
    la.base_nonprod[rows] += la.alloc[rows] // 8
    la.base_prod[rows] += la.alloc[rows] // 16
    la.filter_active[rows] = ~la.filter_active[rows]
    nf.requested[rows] += nf.alloc[rows] // 8
    nf.num_pods[rows] += 1
    return la, nf


def padded(real: np.ndarray) -> np.ndarray:
    """A power-of-two index (>= 16) that repeats its first row, as the
    engine and the residency pad theirs."""
    from koordinator_tpu_torch.service.state import next_bucket

    idx = np.full(next_bucket(real.size, 16), real[0], dtype=np.int32)
    idx[: real.size] = real
    return idx


def check_warm_kernels(inp, dirty_sizes, timed: bool, commit_cap: int = 16):
    """The warm-start and residency kernels against their plain versions on
    the inputs' device (raises ``Mismatch``); returns (kernel records,
    transfer records) when ``timed``."""
    from koordinator_tpu_torch.core import resolved
    from koordinator_tpu_torch.core.cycle import PluginWeights
    from koordinator_tpu_torch.service import state as sm

    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    la_nodes, nf_nodes, valid = inp["la_nodes"], inp["nf_nodes"], inp["valid"]
    w, static, dev = inp["weights"], inp["static"], inp["valid"].device
    pw = PluginWeights()
    P, N = la_pods.est.shape[0], valid.shape[0]
    R, Rf, Rs = la_pods.est.shape[1], nf_pods.req.shape[1], nf_pods.req_score.shape[1]
    BS = 16
    rng = np.random.default_rng(SEED + 2)
    _, q_la, q_nf, salts, pod_ok = resolved.kernel_queue(
        la_pods, nf_pods, valid, inp["p_real"], inp["order"]
    )
    q_extra = pod_ok[:, None] & valid[None, :]
    carry0 = resolved.schedule_keys(q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok,
                                    salts, BS)
    clone = lambda c: tuple(a.clone() for a in c)  # noqa: E731
    err = {"sched_refresh": 0}
    runs = {}
    for D in dirty_sizes:
        real = rng.choice(N, size=D - 3, replace=False).astype(np.int32)
        idx = padded(real)
        la2, nf2 = perturbed_nodes(la_nodes, nf_nodes, torch.from_numpy(real).to(dev).long())

        def kernel_refresh(c, idx=idx, la2=la2, nf2=nf2):
            return resolved.schedule_refresh(c, idx, q_la, la2, w, q_nf, nf2, static, valid,
                                             pod_ok, salts, BS)

        def plain_refresh(c, idx=idx, la2=la2, nf2=nf2):
            return resolved.refresh_plain(*c, torch.from_numpy(idx).to(dev), q_la, la2, w, q_nf,
                                          nf2, static, pw, q_extra, salts, BS)

        got = kernel_refresh(clone(carry0))
        require_equal(f"sched_refresh {P}x{N} D={idx.size}", got, plain_refresh(clone(carry0)))
        cold = resolved.schedule_keys(q_la, la2, w, q_nf, nf2, static, valid, pod_ok, salts, BS)
        require_equal(f"sched_refresh D={idx.size} against a cold key build", got, cold)
        runs[idx.size] = (idx, la2, nf2, got, kernel_refresh, plain_refresh)

    # the warm rounds at the main path's dirty count (128 rows)
    D_main = 128 if 128 in runs else max(runs)
    idx, la2, nf2, carry, kernel_refresh, plain_refresh = runs[D_main]
    before = clone(carry)

    def kernel_rounds():
        return resolved.schedule_rounds_warm(carry, q_la, la2, w, q_nf, nf2, static, valid,
                                             pod_ok, salts, commit_cap, BS)

    def plain_rounds():
        return resolved.run_rounds_plain(carry[0].clone(), carry[1].clone(), carry[2], q_la, la2,
                                         w, q_nf, nf2, static, pw, q_extra, salts, commit_cap, BS)

    hk, sk, rk = kernel_rounds()
    for name, a, b in zip(("M", "Mb", "la_feas_T"), carry, before):
        if not torch.equal(a, b):
            fail(f"sched_rounds wrote its carry's {name}")
    hp, sp, rp = plain_rounds()
    err["sched_rounds"] = require_equal(
        f"sched_rounds {P}x{N} K={commit_cap}", (hk, sk, rk),
        (hp, sp, torch.tensor(rp, dtype=torch.int32)),
    )
    rounds = int(rp)

    # the residency: the store's raw rows, resident on the device
    st = inp["state"]
    host = [getattr(st, a) for a in sm.DeviceResidency._ROWS]
    check_adoption(sm, host, dev)
    bufs0 = sm.dstate_rows(host, dev)
    rows = host[0].shape[0]
    real = rng.choice(rows, size=min(100, rows // 4), replace=False).astype(np.int32)
    idx_s = padded(real)
    src = padded(rng.choice(rows, size=real.size, replace=False).astype(np.int32))
    vals = tuple(np.ascontiguousarray(h[src]) for h in host)
    work = {}

    # all three take the index and rows from the host, as the residency
    # hands them over, and move them to the card inside the timed call
    def kernel_scatter():
        return sm.dstate_scatter(work["bufs"], idx_s, vals)

    def plain_scatter():
        return sm.dstate_scatter_plain(work["bufs"], torch.from_numpy(idx_s).to(dev),
                                       [torch.from_numpy(v).to(dev) for v in vals])

    def library_scatter():
        i = torch.from_numpy(idx_s).to(dev).long()
        return tuple(b.index_copy_(0, i, torch.from_numpy(v).to(dev))
                     for b, v in zip(work["bufs"], vals))

    def reset_bufs():
        work["bufs"] = clone(bufs0)

    reset_bufs()
    got = kernel_scatter()
    reset_bufs()
    err["dstate_scatter"] = require_same(f"dstate_scatter D={idx_s.size}", got, plain_scatter())
    reset_bufs()
    require_same("dstate_scatter against index_copy_", got, library_scatter())

    # the gate at NaN and boundary update times
    now = 1_000_010.0
    exp = st.la_args.node_metric_expiration_seconds
    raw = list(bufs0[:12])
    ut = raw[4].clone()
    has = raw[3].clone()
    k = min(64, rows // 8)
    ut[:k] = float("nan")
    ut[k:2 * k] = now - exp  # now - ut == exp: expired
    ut[2 * k:3 * k] = float(np.nextafter(now - exp, np.inf))  # just inside
    ut[3 * k:4 * k] = now + 5.0  # a clock behind the metric
    has[:4 * k] = True
    raw[3], raw[4] = has, ut
    err["dstate_gate"] = 0
    for e, fexp in ((exp, True), (exp, False), (None, True), (0, True)):
        g = sm.dstate_gate(raw, now, e, fexp)
        p = sm.dstate_gate_plain(raw, now, e, fexp)
        require_same(f"dstate_gate exp={e} fexp={fexp}", g, p)
    print(f"  {P} pods x {N} nodes: sched_refresh at D={sorted(runs)}, sched_rounds "
          f"({rounds} rounds, carry untouched), dstate_scatter (D={idx_s.size}) and "
          f"dstate_gate equal plain")
    if not timed:
        return None

    la_b = nbytes(*la_pods, *nf_pods)
    row_b = sum(b[0].numel() * b.element_size() for b in bufs0)  # one node's row, all 19
    ops = pair_ops(R, Rf, Rs)
    recs = []
    d_rows = np.unique(idx)
    blocks = np.unique(d_rows // BS)
    b, by = bound_ms(la_b + d_rows.size * (row_b + P * 5) + blocks.size * P * 4 * (1 + BS),
                     d_rows.size * P * (ops + 4) + blocks.size * BS * P)
    recs.append(dict(
        name="sched_refresh", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/service/engine.py:208", dirty_rows=int(idx.size),
        ms=cuda_ms(lambda: kernel_refresh(work["c"]), setup=lambda: work.update(c=clone(carry0))),
        plain_ms=cuda_ms(lambda: plain_refresh(work["c"]),
                         setup=lambda: work.update(c=clone(carry0))),
        bound_ms=b, bound_by=by, max_abs_err=err["sched_refresh"], library_ms=None,
    ))
    NB = carry[1].shape[0]
    K = min(commit_cap, P)
    nodes_b = nbytes(*la2, *nf2, valid)
    b, by = bound_ms(nbytes(carry[1]) + rounds * K * P * (4 + 1) + la_b + nodes_b + P * (4 + 8),
                     rounds * (NB * P + K * P * (ops + 4) + K * BS * P))
    recs.append(dict(
        name="sched_rounds", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/service/engine.py:238", rounds=rounds,
        ms=cuda_ms(kernel_rounds), plain_ms=cuda_ms(plain_rounds, reps=3),
        bound_ms=b, bound_by=by, max_abs_err=err["sched_rounds"], library_ms=None,
    ))
    # the bound: the larger of the device's bytes (the packed rows read, the
    # rows written) and the packed bytes over the host link
    hbm, _ = bound_ms(idx_s.nbytes + 2 * np.unique(idx_s).size * row_b, 0)
    link = (idx_s.nbytes + idx_s.size * row_b) / PCIE_BYTES_PER_S * 1e3
    stage, resident = sm.ScatterStage(), clone(bufs0)
    stage.bind(resident)

    def residency_scatter():
        # the residency's entry: the rows host[idx] gathered into its staging
        stage.scatter(resident, stage.gather(host, idx_s))

    recs.append(dict(
        name="dstate_scatter", source="koordinator_tpu_torch/csrc/dstate.cu",
        replaces="koordinator_tpu/service/state.py:200", dirty_rows=int(idx_s.size),
        ms=cuda_ms(kernel_scatter), ms_run=run_ms(kernel_scatter),
        residency_ms=cuda_ms(residency_scatter),
        plain_ms=cuda_ms(plain_scatter, setup=reset_bufs),
        library_ms=cuda_ms(library_scatter), library_ms_run=run_ms(library_scatter),
        bound_ms=max(hbm, link), bound_by="bytes", bound_over="PCIe" if link >= hbm else "HBM",
        max_abs_err=err["dstate_scatter"],
    ))
    b, by = bound_ms(rows * (1 + 8 + 1 + 1 + 1) + 4 * rows, rows * 8)
    recs.append(dict(
        name="dstate_gate", source="koordinator_tpu_torch/csrc/dstate.cu",
        replaces="koordinator_tpu/service/state.py:222",
        ms=cuda_ms(lambda: sm.dstate_gate(raw, now, exp, True)),
        plain_ms=cuda_ms(lambda: sm.dstate_gate_plain(raw, now, exp, True)),
        bound_ms=b, bound_by=by, max_abs_err=err["dstate_gate"], library_ms=None,
    ))
    up_b = sum(a.nbytes for a in host)
    transfers = [dict(
        name="dstate_rows", replaces="koordinator_tpu/service/state.py:194",
        what="transfer, no arithmetic: the arrays packed into one reused pinned staging, one "
             "copy into one slab of 256-byte-aligned views",
        bytes=up_b, ms=cuda_ms(lambda: sm.dstate_rows(host, dev)),
        library_ms=cuda_ms(lambda: [torch.from_numpy(a).to(dev) for a in host]),
        bound_ms=up_b / PCIE_BYTES_PER_S * 1e3, bound_by="bytes over PCIe Gen5 x16",
    )]
    return recs, transfers


def slab_fault(bufs, dev):
    """What is wrong with one adoption's buffers as views of one slab, or
    None: each must start 256-byte aligned (on a card at its address, the
    slab being an allocation of the caching allocator, 512-byte aligned;
    on the CPU at its offset in the slab, whose own start is 64-byte
    aligned) and all must share one storage."""
    for k, b in enumerate(bufs):
        if not b.numel():
            continue  # an empty view's data_ptr is 0
        at = b.data_ptr() - (b.untyped_storage().data_ptr() if dev.type == "cpu" else 0)
        if at % 256:
            return f"buffer {k} not 256-byte aligned"
    if len({b.untyped_storage().data_ptr() for b in bufs if b.numel()}) > 1:
        return "the buffers are not views of one slab"
    return None


def check_adoption(sm, host, dev) -> None:
    """``dstate_rows`` twice back to back, the second on changed arrays
    (each reversed and moved: ``~`` for bool, + 1 otherwise) issued right
    after the first with no synchronisation, as two adoptions share the
    module's staging: every buffer of both equals its host array byte for
    byte and both are 256-byte-aligned views of one slab each
    (``slab_fault``; raises ``Mismatch``)."""
    changed = [np.ascontiguousarray(~h[::-1] if h.dtype == bool else h[::-1] + 1) for h in host]
    first = sm.dstate_rows(host, dev)
    second = sm.dstate_rows(changed, dev)
    for what, arrays, bufs in (("first", host, first), ("second", changed, second)):
        for k, (a, b) in enumerate(zip(arrays, bufs)):
            same = b.dtype == torch.from_numpy(a).dtype and tuple(b.shape) == a.shape
            if not (same and np.array_equal(b.cpu().numpy().view(np.uint8),
                                            np.ascontiguousarray(a).view(np.uint8))):
                fail(f"dstate_rows, {what} adoption: buffer {k} differs from its host array")
        fault = slab_fault(bufs, dev)
        if fault:
            fail(f"dstate_rows, {what} adoption: {fault}")
    print(f"  dstate_rows: two adoptions of {len(host)} arrays back to back, each buffer equal "
          "to its host array, 256-byte aligned, one slab an adoption", flush=True)


def drive_main_path(device, num_nodes: int, num_pods: int, pods, scalars):
    """SCORE, then CYCLES cold SCHEDULE cycles binding their placements,
    through ``Engine`` on the card, each result held against the same
    engine on the CPU fed a twin store.  Returns (launches per kernel
    during this phase, wall milliseconds per call, device milliseconds of
    the kernels each call launched, by CUDA events around each launch)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import AssignedPod
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.service.state import ClusterState
    from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster, random_pod

    t0 = time.perf_counter()
    state = ClusterState(extra_scalars=scalars, device_state=False)
    twin = ClusterState(extra_scalars=scalars, device_state=False)
    for st in (state, twin):
        _, fleet = random_cluster(SEED, num_nodes=num_nodes, num_pods=0)
        for n in fleet:
            st.upsert_node(n)
        st.publish(NOW)  # the first publish builds every row: ingest, not a cycle
    print(f"  ingest of two stores: {time.perf_counter() - t0:.1f} s")
    eng, ref = Engine(state, device=device), Engine(twin, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    batches = [
        [random_pod(rng, f"c{c}-pending-{i}", "pending") for i in range(num_pods)]
        for c in range(CYCLES)
    ]
    for k in cuda.KERNELS.values():
        k.launches = 0
    main_ms, kernel_ms = {}, {}
    with LaunchTimer() as timer:
        for key in ("score_first", "score"):  # the first call also warms the allocator
            t0 = time.perf_counter()
            totals, feasible, _ = eng.score(pods, now=NOW)
            torch.cuda.synchronize()
            main_ms[key] = (time.perf_counter() - t0) * 1e3
            kernel_ms[key] = timer.take()
        rt, rf, _ = ref.score(pods, now=NOW)
        if totals.shape != (len(pods), state.capacity) or not feasible.any():
            fail(f"score returned {totals.shape} with {int(feasible.sum())} feasible pairs")
        require_equal("Engine.score", (totals, feasible), (rt, rf))
        placed_total = 0
        for c, batch in enumerate(batches):
            # the rows the previous cycle's binds dirtied refresh in the
            # store's publish (host Python), timed apart from the engine call
            t0 = time.perf_counter()
            state.publish(NOW)
            main_ms[f"publish_{c}"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            hosts, scores, snap, allocs = eng.schedule(batch, now=NOW)
            main_ms[f"schedule_{c}"] = wall = (time.perf_counter() - t0) * 1e3
            kernel_ms[f"schedule_{c}"] = k_ms = timer.take()
            rounds = eng.last_rounds
            rh, rs, _, ralloc = ref.schedule(batch, now=NOW)
            require_equal(f"Engine.schedule cycle {c}", (hosts, scores), (rh, rs))
            if allocs != ralloc:
                fail(f"Engine.schedule cycle {c}: allocation records differ")
            placed = int((hosts >= 0).sum())
            placed_total += placed
            busy = sum(k_ms.values())
            print(f"  cycle {c}: {placed}/{num_pods} placed in {rounds} rounds; publish "
                  f"{main_ms[f'publish_{c}']:.1f} ms, schedule {wall:.1f} ms wall, of which "
                  f"kernels {busy:.2f} ms ({100 * busy / wall:.0f}%): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(k_ms.items())), flush=True)
            for pod, h in zip(batch, hosts.tolist()):
                if h >= 0:
                    for st in (state, twin):
                        st.assign_pod(snap.names[h], AssignedPod(pod=pod, assign_time=NOW))
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    print(f"  launches on the main path: {launches}; score wall {main_ms['score']:.1f} ms, "
          f"kernels {kernel_ms['score']}")
    if placed_total == 0:
        fail("no pod was placed on the main path")
    return launches, main_ms, kernel_ms


class uncounted:
    """Launches made inside are taken back out of the kernels' counts:
    the comparison engines' launches are not the main path's."""

    def __enter__(self):
        from koordinator_tpu_torch import cuda

        self._kernels = cuda.KERNELS
        self._saved = {name: k.launches for name, k in self._kernels.items()}
        return self

    def __exit__(self, *exc):
        for name, k in self._kernels.items():
            k.launches = self._saved[name]


# the warm phase's cycles: (name, clock offset from NOW, NodeMetric updates
# before the cycle, launches expected of the main engine; "refresh_rows" is
# the padded dirty index the refresh takes, "cold" a cold init)
WARM_CYCLES = (
    ("cold", 0.0, 0, dict(schedule_keys=1, schedule_rounds=1, sched_refresh=0, sched_rounds=0,
                          dstate_scatter=0, dstate_gate=1), dict(cold=True, full_upload=True)),
    ("unchanged", 1.0, 0, dict(schedule_keys=0, schedule_rounds=0, sched_refresh=0,
                               sched_rounds=1, dstate_scatter=0, dstate_gate=1),
     dict(begin_hit=True)),
    ("metrics on 100 nodes", 2.0, 100, dict(schedule_keys=0, schedule_rounds=0, sched_refresh=1,
                                            sched_rounds=1, dstate_scatter=1, dstate_gate=1),
     dict(refresh_rows=128)),
    ("gate flip of 50 nodes", 10.0, 0, dict(schedule_keys=0, schedule_rounds=0, sched_refresh=1,
                                            sched_rounds=1, dstate_scatter=0, dstate_gate=1),
     dict(refresh_rows=64, stamps_still=True)),
    ("metrics on 5,000 nodes", 11.0, 5000, dict(schedule_keys=1, schedule_rounds=1,
                                                sched_refresh=0, sched_rounds=0,
                                                dstate_scatter=0, dstate_gate=1),
     dict(cold=True, full_upload=True)),
)
WARM_PATH_KERNELS = ("schedule_keys", "schedule_rounds", "sched_refresh", "sched_rounds",
                     "dstate_scatter", "dstate_gate")


def drive_warm_path(device, num_nodes: int, num_pods: int, scalars):
    """The default serving configuration at full width: a resident store
    (``device_state=True``) and a warm-start engine on the card, one fixed
    batch through ``WARM_CYCLES``.  Each cycle's hosts, scores and
    allocations are held against a warm-disabled engine on the same card
    and store and against the CPU engine on a twin store; each cycle's
    launches against the plan.  Returns (launches per kernel during this
    phase, per-cycle records)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import CPU, MEMORY, NodeMetric
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.service.state import ClusterState, next_bucket
    from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster, random_pod

    t0 = time.perf_counter()
    state = ClusterState(extra_scalars=scalars)
    twin = ClusterState(extra_scalars=scalars)
    exp = state.la_args.node_metric_expiration_seconds
    _, fleet = random_cluster(SEED, num_nodes=num_nodes, num_pods=0)
    names = [n.name for n in fleet]
    rng = np.random.default_rng(SEED + 3)
    order = rng.permutation(num_nodes)
    horizon = [names[i] for i in order[:50]]  # live until NOW + 5, expired at NOW + 10
    updates = {100: [names[i] for i in order[50:150]], 5000: [names[i] for i in order[150:5150]]}
    for st in (state, twin):
        for n in random_cluster(SEED, num_nodes=num_nodes, num_pods=0)[1]:
            st.upsert_node(n)
        for i, name in enumerate(horizon):
            st.update_metric(name, NodeMetric(node_usage={CPU: 1000 + 10 * i, MEMORY: 4 << 30},
                                              update_time=NOW + 5 - exp))
        st.publish(NOW)
    print(f"  ingest of two stores: {time.perf_counter() - t0:.1f} s")
    eng, cold, ref = Engine(state, device=device), Engine(state, device=device), Engine(
        twin, device="cpu")
    cold.sched_warm_enabled = False
    batch = lambda: [random_pod(np.random.default_rng([SEED, 4, i]), f"warm-pending-{i}",  # noqa: E731
                                "pending") for i in range(num_pods)]
    batches = {e: batch() for e in (eng, cold, ref)}
    res = state.residency
    for k in cuda.KERNELS.values():
        k.launches = 0
    records = []
    with LaunchTimer() as timer:
        for c, (name, dt, n_upd, plan, expect) in enumerate(WARM_CYCLES):
            now = NOW + dt
            for st in (state, twin):
                for i, node in enumerate(updates.get(n_upd, ())):
                    st.update_metric(node, NodeMetric(
                        node_usage={CPU: 2000 + 7 * i, MEMORY: (2 + i % 7) << 30},
                        update_time=now))
            # the rows the updates dirtied refresh in the store's publish
            # (host Python), timed apart from the engine call
            t0 = time.perf_counter()
            state.publish(now)
            publish = (time.perf_counter() - t0) * 1e3
            vers = state.sched_versions()
            before = {k: v.launches for k, v in cuda.KERNELS.items()}
            up0, warm0, begin0 = res.full_uploads, eng.sched_warm_hits, eng.sched_begin_hits
            timer.take()
            t0 = time.perf_counter()
            hosts, scores, snap, allocs = eng.schedule(batches[eng], now=now)
            wall = (time.perf_counter() - t0) * 1e3
            k_ms = timer.take()
            launched = {k: v.launches - before[k] for k, v in cuda.KERNELS.items()}
            with uncounted():
                ch, cs, _, ca = cold.schedule(batches[cold], now=now)
            rh, rs, _, ra = ref.schedule(batches[ref], now=now)
            require_equal(f"warm cycle {c} ({name}) vs warm-disabled", (hosts, scores), (ch, cs))
            require_equal(f"warm cycle {c} ({name}) vs the CPU engine", (hosts, scores), (rh, rs))
            if allocs != ca or allocs != ra:
                fail(f"warm cycle {c} ({name}): allocation records differ")
            counters = (eng.sched_warm_hits, eng.sched_cold_inits, eng.sched_begin_hits)
            if counters != (ref.sched_warm_hits, ref.sched_cold_inits, ref.sched_begin_hits):
                fail(f"warm cycle {c} ({name}): warm/cold/begin counters {counters} differ "
                     f"from the CPU engine's")
            want = {k: plan.get(k, 0) for k in launched}
            if launched != want:
                fail(f"warm cycle {c} ({name}): launches {launched}, planned {want}")
            is_cold = eng.sched_warm_hits == warm0
            if is_cold != bool(expect.get("cold")):
                fail(f"warm cycle {c} ({name}): cold={is_cold}, planned {bool(expect.get('cold'))}")
            if (res.full_uploads > up0) != bool(expect.get("full_upload")):
                fail(f"warm cycle {c} ({name}): {res.full_uploads - up0} wholesale uploads")
            if expect.get("begin_hit") and eng.sched_begin_hits != begin0 + 1:
                fail(f"warm cycle {c} ({name}): the begin-input cache missed")
            if "refresh_rows" in expect and next_bucket(eng.sched_last_dirty, 16) != \
                    expect["refresh_rows"]:
                fail(f"warm cycle {c} ({name}): refreshed {eng.sched_last_dirty} rows")
            if expect.get("stamps_still") and state.sched_versions() != vers:
                fail(f"warm cycle {c} ({name}): a row stamp moved")
            res.verify()
            busy = sum(k_ms.values())
            rec = dict(cycle=name, publish_ms=publish, wall_ms=wall, kernel_ms=k_ms,
                       launches=launched,
                       placed=int((hosts >= 0).sum()), rounds=eng.last_rounds,
                       dirty_rows=None if is_cold else eng.sched_last_dirty,
                       warm_hits=eng.sched_warm_hits, cold_inits=eng.sched_cold_inits,
                       begin_hits=eng.sched_begin_hits, full_uploads=res.full_uploads,
                       scatters=res.scatters)
            records.append(rec)
            print(f"  cycle {c} ({name}): {rec['placed']}/{num_pods} placed in "
                  f"{rec['rounds']} rounds, {'cold' if is_cold else 'warm'}, "
                  f"dirty {rec['dirty_rows']}; publish {publish:.1f} ms, schedule "
                  f"{wall:.1f} ms wall, kernels "
                  f"{busy:.2f} ms: " + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(k_ms.items()))
                  + f"; launches {({k: v for k, v in launched.items() if v})}; warm/cold/begin "
                  f"{counters}; uploads {res.full_uploads}, scatters {res.scatters}", flush=True)
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    return launches, records


# --------------------------------------------------------------- constraints

INF = 1 << 60


def con_inputs_for(inp, seed: int):
    """Gang, quota and reservation inputs for the kernel checks, made with
    numpy from ``seed`` at the inputs' shape and laid out as the engine lays
    them out: 50 gangs (gangs 1-3 one gang group, gang 4 non-strict, gang 5
    with a bound child, gang 7 uninitialized, gang 9 once satisfied); a
    three-level quota tree (root, 4 parents, 16 leaves) whose leaf limits
    and mins bind mid-batch; 256 reservation rows, 200 live, on live nodes,
    ordered with ties on odd rows, each pod matching up to 2.  Returns
    (GangInputs, QuotaInputs, ReservationArrays, matched [P, Rv] bool,
    match index [P, 2] int32, ranks [Rv] int64) on the inputs' device."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.core import gang as tg, quota as tq, reservation as tr
    from koordinator_tpu_torch.core.cycle import GangInputs, QuotaInputs

    dev = inp["valid"].device
    P, N = inp["la_pods"].est.shape[0], inp["valid"].shape[0]
    axis = inp["state"].axis
    p_real = inp["p_real"]
    rng = np.random.default_rng(seed)
    T = lambda a: convert.tensor(a, dev)  # noqa: E731

    G = 51
    gang = np.where(rng.random(P) < 0.6, rng.integers(1, G, P), 0).astype(np.int32)
    gang[p_real:] = 0
    min_member = np.r_[0, rng.integers(1, 5, G - 1)].astype(np.int64)
    has_init, once = np.ones(G, dtype=bool), np.zeros(G, dtype=bool)
    has_init[7], once[9] = False, True
    group = np.arange(G, dtype=np.int32)
    group[2] = group[3] = 1
    bound = np.zeros(G, dtype=np.int64)
    bound[5] = 1
    non_strict = np.zeros(G, dtype=bool)
    non_strict[4] = True
    gangs = GangInputs(
        pods=tg.GangPodArrays(gang=T(gang), priority=T(np.zeros(P, np.int64)),
                              sub_priority=T(np.zeros(P, np.int64)),
                              timestamp=T(np.zeros(P, np.float64))),
        gangs=tg.GangArrays(min_member=T(min_member),
                            member_count=T(np.bincount(gang, minlength=G).astype(np.int64)),
                            has_init=T(has_init), once_satisfied=T(once), group=T(group),
                            bound_count=T(bound), non_strict=T(non_strict)),
    )

    Q = 21
    parent = np.zeros(Q, dtype=np.int32)
    parent[5:] = 1 + np.arange(16) // 4
    qrow = np.where(rng.random(P) < 0.7, rng.integers(5, Q, P), 0).astype(np.int32)
    qrow[p_real:] = 0
    req = rng.integers(100, 4000, (P, 2)).astype(np.int64)
    present = rng.random((P, 2)) < 0.9
    eff = np.where(present, req, 0)
    demand = np.zeros((Q, 2), dtype=np.int64)
    np.add.at(demand, qrow, eff)
    np.add.at(demand, parent[qrow], np.where((qrow > 0)[:, None], eff, 0))
    limit = np.full((Q, 2), INF, dtype=np.int64)
    limit[1:5] = demand[1:5] * 8 // 10
    limit[5:] = demand[5:] * 7 // 10
    mn = np.full((Q, 2), INF, dtype=np.int64)
    mn[5:] = demand[5:] * 4 // 10
    zeros = np.zeros((Q, 2), dtype=np.int64)
    quota = QuotaInputs(
        pods=tq.QuotaPodArrays(req=T(req), present=T(present), quota=T(qrow),
                               non_preemptible=T(rng.random(P) < 0.3)),
        used=T(zeros), limit=T(limit), npu=T(zeros.copy()), min=T(mn), parent=T(parent),
    )

    Rv, live_rv = 256, 200
    live = np.flatnonzero(inp["valid"].cpu().numpy())
    node = live[rng.integers(0, live.size, Rv)].astype(np.int32)
    node[live_rv:] = 0
    alloc = np.zeros((Rv, len(axis)), dtype=np.int64)
    allocated = np.zeros_like(alloc)
    cpu, mem = axis.index("cpu"), axis.index("memory")
    alloc[:live_rv, cpu], alloc[:live_rv, mem] = 4000, 16 << 30
    allocated[:live_rv, cpu] = rng.integers(0, 1000, live_rv)
    order = np.where(np.arange(Rv) % 2 == 1, rng.integers(1, 20, Rv), 0).astype(np.int64)
    order[live_rv:] = 0
    matched = np.zeros((P, Rv), dtype=bool)
    midx = np.full((P, 2), -1, dtype=np.int32)
    for i in range(p_real):
        hits = np.sort(rng.choice(live_rv, int(rng.integers(0, 3)), replace=False))
        matched[i, hits] = True
        midx[i, :hits.size] = hits
    rsv = tr.ReservationArrays(node=T(node), allocatable=T(alloc), allocated=T(allocated),
                               order=T(order))
    return gangs, quota, rsv, T(matched), T(midx), tr.order_ranks(T(order))[0]


def con_for(inp, x, xs):
    """The ``ConInputs`` of the checks' constraint inputs ``x`` in queue
    order ``xs``, the reservation rows from the kernels under test."""
    from koordinator_tpu_torch.core import reservation as tr
    from koordinator_tpu_torch.core.cycle import ReservationInputs
    from koordinator_tpu_torch.core.resolved import con_inputs

    gangs, quota, rsv, matched, midx, rank = x
    req, N = inp["nf_pods"].req, inp["valid"].shape[0]
    r = ReservationInputs(rsv=rsv, matched=matched, rscore=tr.rsv_rscore(req, rsv),
                          scores=tr.rsv_score(req, matched, N, rsv, rank))
    return con_inputs(xs, gangs, quota, r, rsv_midx=midx, rsv_rank=rank)


def check_con_kernels(inp, cpd: int, timed: bool, commit_cap: int = 16):
    """The constrained instantiations of the schedule kernels against their
    plain versions (raises ``Mismatch``): the key build, the round loop
    (which must take the quota upper bound at least once and leave the
    quota and reservation inputs untouched), the refresh of 128 padded
    dirty rows (also against a cold key build) and the warm rounds (their
    carry bit-identical after).  Returns the kernel records when
    ``timed``."""
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.core.cycle import PluginWeights

    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    la_nodes, nf_nodes, valid = inp["la_nodes"], inp["nf_nodes"], inp["valid"]
    w, static, dev = inp["weights"], inp["static"], inp["valid"].device
    pw = PluginWeights()
    P, N = la_pods.est.shape[0], valid.shape[0]
    R, Rf, Rs = la_pods.est.shape[1], nf_pods.req.shape[1], nf_pods.req_score.shape[1]
    BS, AD = 16, 8
    x = con_inputs_for(inp, SEED + 11)
    xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(la_pods, nf_pods, valid, inp["p_real"],
                                                    inp["order"])
    con = con_for(inp, x, xs)
    q_extra = pod_ok[:, None] & valid[None, :] & rs.gang_pass(con)[:, None]
    keys_args = (q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok, salts, BS)

    def kernel_keys():
        return rs.schedule_keys(*keys_args, con)

    def plain_keys():
        return rs.build_keys_plain(q_la, la_nodes, w, q_nf, nf_nodes, static, pw, q_extra, salts,
                                   BS, rs._queue_rsv(con))

    keys = kernel_keys()
    err = {"schedule_keys_con": require_equal(f"schedule_keys_con {P}x{N}", keys, plain_keys())}
    M0, Mb0, feas_T = keys
    state0 = [t.clone() for t in (con.quota.used, con.quota.npu, con.rsv.allocated)]
    node_args = (q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok, salts, commit_cap, BS)

    def kernel_rounds(M, Mb):
        return rs.schedule_rounds(M, Mb, feas_T, *node_args, con, cpd, AD)

    def plain_rounds(M, Mb):
        return rs._plain_rounds(M, Mb, feas_T, *node_args, con, cpd, AD)

    got = kernel_rounds(M0.clone(), Mb0.clone())
    want = plain_rounds(M0.clone(), Mb0.clone())
    err["schedule_rounds_con"] = require_equal(
        f"schedule_rounds_con {P}x{N} cpd={cpd}", got, want)
    for a, b in zip((con.quota.used, con.quota.npu, con.rsv.allocated), state0):
        if not torch.equal(a, b):
            fail("schedule_rounds_con wrote its quota or reservation inputs")
    rounds, ub = int(want[3][0]), int(want[3][1])
    if ub == 0:
        fail(f"schedule_rounds_con {P}x{N} cpd={cpd}: no round took the quota upper bound")
    placed, pre = int((want[0] >= 0).sum()), int((want[2] >= 0).sum())

    rng = np.random.default_rng(SEED + 12)
    real = rng.choice(N, size=min(125, N // 2), replace=False).astype(np.int32)
    idx = padded(real)
    la2, nf2 = perturbed_nodes(la_nodes, nf_nodes, torch.from_numpy(real).to(dev).long())
    clone = lambda c: tuple(a.clone() for a in c)  # noqa: E731

    def kernel_refresh(c):
        return rs.schedule_refresh(c, idx, q_la, la2, w, q_nf, nf2, static, valid, pod_ok, salts,
                                   BS, con)

    def plain_refresh(c):
        return rs.refresh_plain(*c, torch.from_numpy(idx).to(dev), q_la, la2, w, q_nf, nf2,
                                static, pw, q_extra, salts, BS, rs.rsv_view(con))

    carry = kernel_refresh(clone(keys))
    err["sched_refresh_con"] = require_equal(f"sched_refresh_con D={idx.size}", carry,
                                             plain_refresh(clone(keys)))
    cold = rs.schedule_keys(q_la, la2, w, q_nf, nf2, static, valid, pod_ok, salts, BS, con)
    require_equal(f"sched_refresh_con D={idx.size} against a cold key build", carry, cold)
    before = clone(carry)
    warm_args = (q_la, la2, w, q_nf, nf2, static, valid, pod_ok, salts, commit_cap, BS, con, cpd,
                 AD)

    def kernel_warm():
        return rs.schedule_rounds_warm(carry, *warm_args)

    def plain_warm():
        return rs._plain_rounds(carry[0].clone(), carry[1].clone(), carry[2], *warm_args)

    got = kernel_warm()
    for name, a, b in zip(("M", "Mb", "la_feas_T"), carry, before):
        if not torch.equal(a, b):
            fail(f"sched_rounds_con wrote its carry's {name}")
    want_w = plain_warm()
    err["sched_rounds_con"] = require_equal(f"sched_rounds_con {P}x{N} cpd={cpd}", got, want_w)
    w_rounds = int(want_w[3][0])
    print(f"  {P} pods x {N} nodes, constrained, check_parent_depth {cpd}: kernels equal plain; "
          f"{rounds} rounds ({ub} on the quota upper bound), {placed} placed after the gang "
          f"rollback of {pre}; refresh D={idx.size}; warm rounds {w_rounds}")
    if not timed:
        return None

    work = {}

    def reset():
        work["M"], work["Mb"] = M0.clone(), Mb0.clone()

    ops = pair_ops(R, Rf, Rs) + 6 * Rf * con.rsv_midx.shape[1] + 4
    pods_b = nbytes(*la_pods, *nf_pods, con.rsv_midx, con.gang_row)
    nodes_b = nbytes(*la_nodes, *nf_nodes, valid)
    rsv_b = nbytes(con.rsv_scores) + nbytes(*con.rsv)
    recs = []
    b, by = bound_ms(pods_b + nodes_b + rsv_b + nbytes(M0, Mb0, feas_T), P * N * (ops + 4))
    recs.append(dict(
        name="schedule_keys_con", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/core/resolved.py:765", ms=cuda_ms(kernel_keys),
        plain_ms=cuda_ms(plain_keys), bound_ms=b, bound_by=by,
        max_abs_err=err["schedule_keys_con"], library_ms=None,
    ))
    NB, K = Mb0.shape[0], min(commit_cap, P)
    Q, R2 = con.quota.used.shape[0], 2 * con.quota.used.shape[1]
    q_ops = P * (8 * R2 + 4 * AD * R2) + Q * R2 * 3
    r_ops = rounds * (NB * P + K * P * (ops + 4) + K * BS * P + q_ops) + ub * P * AD * R2 * 8
    r_bytes = (nbytes(Mb0) + rounds * K * P * (4 + 1 + 8) + pods_b + nodes_b
               + nbytes(*con.quota.pods, *con.quota[1:]) + nbytes(*con.rsv) + P * (4 + 8 + 4))
    b, by = bound_ms(r_bytes, r_ops)
    recs.append(dict(
        name="schedule_rounds_con", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/core/resolved.py:835",
        ms=cuda_ms(lambda: kernel_rounds(work["M"], work["Mb"]), setup=reset),
        plain_ms=cuda_ms(lambda: plain_rounds(work["M"], work["Mb"]), reps=3, setup=reset),
        bound_ms=b, bound_by=by, rounds=rounds, ub_rounds=ub,
        max_abs_err=err["schedule_rounds_con"], library_ms=None,
    ))
    d_rows = np.unique(idx)
    blocks = np.unique(d_rows // BS)
    row_b = sum(a[0].numel() * a.element_size() for a in (*la2, *nf2))
    b, by = bound_ms(pods_b + d_rows.size * (row_b + P * (5 + 8)) + blocks.size * P * 4 * (1 + BS),
                     d_rows.size * P * (ops + 4) + blocks.size * BS * P)
    recs.append(dict(
        name="sched_refresh_con", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/service/engine.py:208", dirty_rows=int(idx.size),
        ms=cuda_ms(lambda: kernel_refresh(work["c"]), setup=lambda: work.update(c=clone(keys))),
        plain_ms=cuda_ms(lambda: plain_refresh(work["c"]),
                         setup=lambda: work.update(c=clone(keys))),
        bound_ms=b, bound_by=by, max_abs_err=err["sched_refresh_con"], library_ms=None,
    ))
    b, by = bound_ms(r_bytes, w_rounds * (NB * P + K * P * (ops + 4) + K * BS * P + q_ops))
    recs.append(dict(
        name="sched_rounds_con", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/service/engine.py:238", rounds=w_rounds,
        ms=cuda_ms(kernel_warm), plain_ms=cuda_ms(plain_warm, reps=3), bound_ms=b, bound_by=by,
        max_abs_err=err["sched_rounds_con"], library_ms=None,
    ))
    return recs


def big_quota_tree(groups: int = 6000, seed: int = SEED + 41):
    """A tree of ``groups`` quota groups past the quota kernel's shared-memory
    tier at two dimensions: 60 under the root, the rest under them, mixed
    lending, scaled mins and an absent max."""
    from koordinator_tpu_torch.api.quota import ROOT_QUOTA, QuotaGroup

    rng = np.random.default_rng(seed)
    res = ("cpu", "memory")
    out = []
    for i in range(groups):
        top = i < 60
        mx = {r: int(rng.integers(2000, 90000)) for r in res}
        if rng.random() < 0.2:
            mx.pop("cpu")
        out.append(QuotaGroup(
            name=f"g{i}", parent=ROOT_QUOTA if top else f"g{int(rng.integers(0, 60))}",
            min={r: int(rng.integers(0, 9000)) for r in res}, max=mx,
            allow_lent=bool(rng.random() < 0.7), enable_scale_min=bool(rng.random() < 0.5),
            pod_requests={} if top else {r: int(rng.integers(0, 20000)) for r in res},
            is_parent=top))
    return out


def quota_trees():
    """(name, groups) of the quota checks: the 500-group tree of the JAX
    package's service benchmark (bench/bench_service.py:205-222: 20 groups
    under the root, 480 under them), a tree with absent max dimensions,
    non-lending groups and scaled mins, and a tree past the kernel's
    shared-memory tier (``big_quota_tree``)."""
    from koordinator_tpu_torch.api.quota import ROOT_QUOTA, QuotaGroup

    rng = np.random.default_rng(SEED + 13)
    res = ("cpu", "memory")
    bench = []
    for i in range(500):
        bench.append(QuotaGroup(
            name=f"q{i}", parent=ROOT_QUOTA if i < 20 else f"q{int(rng.integers(0, 20))}",
            min={r: int(rng.integers(0, 2000)) for r in res},
            max={r: int(rng.integers(2000, 9000)) for r in res},
            pod_requests={r: int(rng.integers(0, 5000)) for r in res},
        ))
    mixed = []
    for i in range(60):
        top = i < 6
        mx = {r: int(rng.integers(2000, 90000)) for r in res}
        if rng.random() < 0.3:
            mx.pop("memory")  # absent: 2**60
        mixed.append(QuotaGroup(
            name=f"m{i}", parent=ROOT_QUOTA if top else f"m{int(rng.integers(0, 6))}",
            min={r: int(rng.integers(0, 9000)) for r in res}, max=mx,
            allow_lent=bool(rng.random() < 0.7), enable_scale_min=bool(rng.random() < 0.5),
            shared_weight={r: int(rng.integers(0, 4)) for r in res} if rng.random() < 0.3 else None,
            pod_requests={} if top else {r: int(rng.integers(0, 60000)) for r in res},
            is_parent=top,
        ))
    return [("bench 500 groups", bench), ("absent max, scaled mins", mixed),
            ("6,000 groups", big_quota_tree())]


def check_quota_kernels(dev, timed: bool):
    """``quota`` and ``quota_limit`` against ``refresh_runtime`` on the same
    device tensors (raises ``Mismatch``), each tree through a stage in its
    own memory tier, a stage forced to the global tier (budget 0) and no
    stage (the call plans its tree); returns the records of the 500-group
    tree, timed through its stage as the engine calls it, when ``timed``."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.core import quota as tq
    from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot

    recs = []
    for name, groups in quota_trees():
        qs = QuotaSnapshot(groups, ["cpu", "memory"])
        qd = tq.QuotaArrays(*(convert.tensor(a, dev) for a in qs.arrays()))
        qa = qd._replace(parent=qs.parent)  # the parent rows on the host, as the engine's
        levels = qs.level_tuple()
        lv_t = [torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev) for a in levels]
        stage = tq.QuotaStage().bind(qs.parent, levels, dev)
        stages = (stage, tq.QuotaStage(budget=0).bind(qs.parent, levels, dev), None)
        errs = {}
        for total in (np.array([1_000_000, 1_000_000]), np.array([40_000, 30_000])):
            tot = convert.tensor(total.astype(np.int64), dev)
            want = {scale: tq.refresh_runtime(qd, lv_t, tot, scale) for scale in (True, False)}
            limit = want[True].clone()
            limit[0] = tq.INF
            for st in stages:  # without a stage, the parent rows read back from the card
                tier = "no stage" if st is None else f"{st.tier(2)} tier"
                q = qd if st is None else qa
                for scale in (True, False):
                    errs["quota"] = require_equal(
                        f"quota ({name}, total {total.tolist()}, scale {scale}, {tier})",
                        (tq.quota_fn(q, levels, tot, scale, stage=st),), (want[scale],))
                errs["quota_limit"] = require_equal(
                    f"quota_limit ({name}, {tier})",
                    (tq.quota_limit_fn(q, levels, tot, stage=st),), (limit,))
        print(f"  quota tree '{name}' ({len(groups)} groups, {len(levels)} levels, "
              f"{stage.tier(2)} tier): quota and quota_limit equal plain in both tiers")
        if timed and not recs:
            Q, R = qs.min.shape
            b, by = bound_ms(nbytes(*qd) + 2 * 8 + (Q + len(levels) + 1) * 4 + Q * R * 8,
                             40 * Q * R)
            for kname, fn in (("quota", lambda: tq.quota_fn(qa, levels, tot, stage=stage)),
                              ("quota_limit",
                               lambda: tq.quota_limit_fn(qa, levels, tot, stage=stage))):
                recs.append(dict(
                    name=kname, source="koordinator_tpu_torch/csrc/quota.cu",
                    replaces=("koordinator_tpu/core/quota.py:138" if kname == "quota"
                              else "koordinator_tpu/service/engine.py:316"),
                    ms=cuda_ms(fn), plain_ms=cuda_ms(lambda: tq.refresh_runtime(qd, lv_t, tot)),
                    bound_ms=b, bound_by=by, max_abs_err=errs[kname], library_ms=None,
                    groups=Q - 1,
                ))
    return recs


def check_rsv_kernels(inp, timed: bool):
    """``rsv_rows`` (one launch writing both rows), ``rsv_rscore`` and
    ``rsv_score`` against ``score_reservation`` and ``reservation_score``
    at the inputs' shape with the checks' 256 reservation rows, and
    ``rsv_rows`` at the descheduler's one-pod shape (one real pod in the
    bucket of 16, ``rsv_shapes``) (raises ``Mismatch``)."""
    from koordinator_tpu_torch.core import reservation as tr

    shapes = {}
    for name, (req, matched, N, rsv, rank) in rsv_shapes(inp):
        P, Rv = matched.shape
        want = (tr.score_reservation(req, rsv), tr.reservation_score(req, matched, N, rsv))
        err = require_equal(f"rsv_rows {name} {P}x{Rv}x{N}", tr.rsv_rows(req, matched, N, rsv, rank),
                            want)
        err = max(err, require_equal(f"rsv_rscore, rsv_score {name} {P}x{Rv}x{N}",
                                     (tr.rsv_rscore(req, rsv),
                                      tr.rsv_score(req, matched, N, rsv, rank)), want))
        shapes[name] = (req, matched, N, rsv, rank, want, err)
        print(f"  {name}: {P} pods x {Rv} reservations x {N} nodes: rsv_rows, rsv_rscore and "
              "rsv_score equal plain")
    if not timed:
        return None
    req, matched, N, rsv, rank, want, err = shapes["check"]
    P, Rf = req.shape
    Rv = rsv.node.shape[0]
    rsv_b = nbytes(*rsv, rank)
    m = int(matched.sum())
    b1 = bound_ms(nbytes(req) + rsv_b + P * Rv * 8, P * Rv * Rf * 6)
    b2 = bound_ms(nbytes(req, matched) + rsv_b + P * Rv * 8 + P * N * 8,
                  P * Rv * Rf * 6 + m * (Rf * 6 + 20))
    oreq, omatched, oN, orsv, orank, _, _ = shapes["one-pod"]
    ob = bound_ms(nbytes(oreq, omatched, *orsv, orank) + oreq.shape[0] * (orsv.node.shape[0]
                                                                         + oN) * 8, 0)
    return [
        dict(name="rsv_rscore", source="koordinator_tpu_torch/csrc/reservation.cu",
             replaces="koordinator_tpu/core/reservation.py:65",
             ms=cuda_ms(lambda: tr.rsv_rscore(req, rsv)),
             plain_ms=cuda_ms(lambda: tr.score_reservation(req, rsv)), bound_ms=b1[0],
             bound_by=b1[1], max_abs_err=err, library_ms=None),
        # the cycle's one launch (``rsv_rows``, both rows); the score row
        # alone beside it
        dict(name="rsv_score", source="koordinator_tpu_torch/csrc/reservation.cu",
             replaces="koordinator_tpu/core/reservation.py:96",
             ms=cuda_ms(lambda: tr.rsv_rows(req, matched, N, rsv, rank)),
             plain_ms=cuda_ms(lambda: (tr.score_reservation(req, rsv),
                                       tr.reservation_score(req, matched, N, rsv))),
             bound_ms=b2[0], bound_by=b2[1], max_abs_err=err, library_ms=None,
             score_ms=cuda_ms(lambda: tr.rsv_score(req, matched, N, rsv, rank)),
             ms_one_pod=cuda_ms(lambda: tr.rsv_rows(oreq, omatched, oN, orsv, orank)),
             plain_ms_one_pod=cuda_ms(lambda: (tr.score_reservation(oreq, orsv),
                                               tr.reservation_score(oreq, omatched, oN, orsv))),
             bound_ms_one_pod=ob[0]),
    ]


def rsv_case(dev, seed: int, P: int, Rv: int, N: int, Rf: int = 2, density: float = 0.02,
             ordered: float = 0.5, nodes: int = 0, uniform: bool = False,
             zero_dims: bool = False, every: bool = False, no_match: bool = True,
             wide: bool = False, real: int = 0):
    """One edge case of the reservation rows, made with numpy from
    ``seed``: (req, matched, N, rsv, rank) on ``dev``.  ``nodes``: the
    reservations on that many nodes only (several a node); ``uniform``:
    one request, allocatable and allocation everywhere (equal rscores);
    ``zero_dims``: capacity 0 in some dimensions and in every dimension of
    some reservations (w == 0); ``every``: pod 1 matches every reservation;
    ``no_match``: pod 0 matches none; ``wide``: values past the quotients'
    fast range, negatives and overflowing products included; ``real``:
    only the first ``real`` pods are real (the others request nothing and
    match nothing, as a bucket's padding)."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.core import reservation as tr

    rng = np.random.default_rng(seed)
    T = lambda a: convert.tensor(a, dev)  # noqa: E731
    if wide:
        req = rng.integers(-1000, 1 << 40, (P, Rf))
        alloc = rng.integers(-4000, 1 << 58, (Rv, Rf))
        allocated = rng.integers(-(1 << 20), 1 << 57, (Rv, Rf))
    else:
        req = rng.integers(0, 3000, (P, Rf))
        alloc = rng.integers(1000, 8000, (Rv, Rf))
        allocated = rng.integers(0, 1000, (Rv, Rf))
    if uniform:
        req[:] = req[0]
        alloc[:] = alloc[0]
        allocated[:] = allocated[0]
    if zero_dims:
        alloc[rng.random((Rv, Rf)) < 0.3] = 0
        alloc[rng.random(Rv) < 0.2] = 0
    node = rng.integers(0, nodes if nodes else N, Rv).astype(np.int32)
    order = np.where(rng.random(Rv) < ordered, rng.integers(1, 20, Rv), 0).astype(np.int64)
    matched = rng.random((P, Rv)) < density
    if every and P > 1:
        matched[1] = True
    if no_match:
        matched[0] = False
    if real:
        req[real:] = 0
        matched[real:] = False
    rsv = tr.ReservationArrays(node=T(node), allocatable=T(alloc.astype(np.int64)),
                               allocated=T(allocated.astype(np.int64)), order=T(order))
    return (T(req.astype(np.int64)), T(matched), N, rsv, tr.order_ranks(T(order))[0])


def rsv_cases(dev) -> list:
    """The reservation rows' edge cases, (name, rsv_case arguments)."""
    from koordinator_tpu_torch import cuda

    return [
        ("one pod in the bucket of 16", dict(P=16, Rv=256, N=16_384, real=1, no_match=False,
                                              density=0.01)),
        ("Rv = 1", dict(P=8, Rv=1, N=300, density=0.6)),
        ("Rv = 257 over blocks of 256", dict(P=200, Rv=257, N=1000)),
        ("Rv = RSV_MAX", dict(P=4, Rv=cuda.RSV_MAX, N=5000, density=0.05)),
        ("an all-zero row", dict(P=4, Rv=64, N=100, ordered=0.0, uniform=True, density=0.3)),
        ("several on one node, ranked", dict(P=40, Rv=96, N=500, nodes=3, density=0.3)),
        ("several on one node, unranked", dict(P=40, Rv=96, N=500, nodes=3, density=0.3,
                                              ordered=0.0)),
        ("equal rscores", dict(P=40, Rv=96, N=500, nodes=5, uniform=True, density=0.3,
                               ordered=0.0)),
        ("cap 0 dimensions and w = 0", dict(P=40, Rv=128, N=500, Rf=5, zero_dims=True,
                                            density=0.2)),
        ("a pod matching every reservation", dict(P=3, Rv=300, N=700, every=True)),
        ("N odd", dict(P=7, Rv=64, N=301, density=0.1)),
        ("N = 1", dict(P=9, Rv=16, N=1, density=0.3)),
        ("N > 2**16", dict(P=5, Rv=64, N=70_001, density=0.1)),
        ("values past the fast range", dict(P=40, Rv=128, N=500, Rf=3, wide=True,
                                            density=0.2)),
    ]


def check_rsv_cases(dev) -> int:
    """``rsv_rows``, ``rsv_rscore`` and ``rsv_score`` against both plain
    versions on every case of ``rsv_cases`` (raises ``Mismatch``); the
    case count."""
    from koordinator_tpu_torch.core import reservation as tr

    cases = rsv_cases(dev)
    for k, (name, kw) in enumerate(cases):
        req, matched, N, rsv, rank = rsv_case(dev, SEED + 70 + k, **kw)
        want = (tr.score_reservation(req, rsv), tr.reservation_score(req, matched, N, rsv))
        require_equal(f"rsv_rows, {name}", tr.rsv_rows(req, matched, N, rsv, rank), want)
        require_equal(f"rsv_rscore, rsv_score, {name}",
                      (tr.rsv_rscore(req, rsv), tr.rsv_score(req, matched, N, rsv, rank)), want)
    print(f"  rsv_rows, rsv_rscore and rsv_score: {len(cases)} edge cases equal plain",
          flush=True)
    return len(cases)


# the constraint phase's cycles: (name, clock offset from NOW, launches
# expected of the main engine, expectations)
CON_CYCLES = (
    ("cold", 0.0, dict(schedule_keys_con=1, schedule_rounds_con=1, quota_limit=1, rsv_score=1,
                       dstate_gate=1), dict(cold=True)),
    ("unchanged", 1.0, dict(sched_rounds_con=1, dstate_gate=1), dict(begin_hit=True)),
    ("20 quota maxes lowered, metrics on 100 nodes", 2.0,
     dict(sched_refresh_con=1, sched_rounds_con=1, quota_limit=1, dstate_scatter=1, dstate_gate=1),
     dict(upper_bound=True)),
    ("a reservation upserted", 3.0, dict(schedule_keys_con=1, schedule_rounds_con=1, rsv_score=1,
                                         dstate_gate=1), dict(cold=True)),
    ("assume with 8 pending reservations", 4.0,
     dict(schedule_keys_con=1, schedule_rounds_con=1, rsv_score=1, dstate_gate=1),
     dict(cold=True, assume=True)),
    ("the next batch", 5.0, dict(schedule_keys_con=1, schedule_rounds_con=1, quota_limit=1,
                                 rsv_score=1, dstate_scatter=1, dstate_gate=1),
     dict(cold=True)),
)
# a cycle's reservation rows are one ``rsv_score`` launch (``rsv_rows``):
# ``rsv_rscore`` is launched on no path
CON_PATH_KERNELS = ("schedule_keys_con", "schedule_rounds_con", "sched_refresh_con",
                    "sched_rounds_con", "quota", "quota_limit", "rsv_score",
                    "dstate_scatter", "dstate_gate")


def con_store(scalars, num_nodes: int, device_state: bool = True, nf_args=None):
    """A store with the JAX package's service-benchmark constraint set
    (bench/bench_service.py:130-170): quota total {cpu: N*8000, memory:
    N*32Gi}; 100 flat groups, min {cpu 50,000, memory 200Gi}, max {cpu
    400,000, memory 2,000Gi}; 50 gangs, min_member 2, 21 children,
    create_time i; 200 reservations on random nodes, {cpu 4000, memory
    16Gi}, ordered 1-999 on odd i."""
    from koordinator_tpu_torch.service.state import ClusterState
    from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster

    st = ClusterState(extra_scalars=scalars, device_state=device_state, nf_args=nf_args)
    for n in random_cluster(SEED, num_nodes=num_nodes, num_pods=0)[1]:
        st.upsert_node(n)
    total, groups, gangs, reservations = con_objects(num_nodes)
    st.quota.set_total(total)
    for g in groups:
        st.quota.upsert(g)
    for g in gangs:
        st.gangs.upsert(g)
    for r in reservations:
        st.reservations.upsert(r)
    st.publish(NOW)
    return st


def con_objects(num_nodes: int) -> tuple:
    """``con_store``'s constraint set: (quota total, quota groups, gangs,
    reservations)."""
    from koordinator_tpu_torch.api.quota import QuotaGroup
    from koordinator_tpu_torch.service.constraints import GangInfo, ReservationInfo

    total = {"cpu": num_nodes * 8000, "memory": num_nodes * (32 << 30)}
    groups = [QuotaGroup(name=f"bq{i}", min={"cpu": 50_000, "memory": 200 << 30},
                         max={"cpu": 400_000, "memory": 2000 << 30}) for i in range(100)]
    gangs = [GangInfo(name=f"bg{i}", min_member=2, total_children=21, create_time=float(i))
             for i in range(50)]
    rng = np.random.default_rng(SEED + 5)
    reservations = [ReservationInfo(
        name=f"br{i}", node=f"node-{int(rng.integers(0, num_nodes))}",
        allocatable={"cpu": 4000, "memory": 16 << 30},
        order=int(rng.integers(1, 1000)) if i % 2 else 0) for i in range(200)]
    return total, groups, gangs, reservations


def con_batch(num_pods: int, tag: str, seed: int):
    """``num_pods`` pending pods, pod i in gang i mod 50, quota group i mod
    100, and 2 random reservations (bench/bench_service.py:163-170)."""
    from koordinator_tpu_torch.utils.fixtures import random_pod

    rng = np.random.default_rng(seed)
    pods = []
    for i in range(num_pods):
        p = random_pod(np.random.default_rng([seed, i]), f"{tag}-{i}", "pending")
        p.gang, p.quota = f"bg{i % 50}", f"bq{i % 100}"
        p.reservations = [f"br{int(rng.integers(0, 200))}" for _ in range(2)]
        pods.append(p)
    return pods


def store_view(st) -> tuple:
    """What ``assume=True`` writes into a store: quota used, reservation
    allocations and bindings, gang satisfaction and bound children, the
    pod -> node map."""
    qs = st.quota.snapshot()
    used, npu = st.quota.used_arrays(qs)
    return (
        used.tolist(), npu.tolist(),
        sorted((r.name, r.node, sorted(r.allocated.items()), r.consumed_once,
                r.unschedulable_count) for r in st.reservations._rsv.values()),
        sorted((g.name, g.once_satisfied, sorted(g.bound)) for g in st.gangs._gangs.values()),
        sorted(st._pod_node.items()),
    )


def drive_con_path(device, num_nodes: int, num_pods: int, scalars):
    """The constraint phase at full width in the default serving
    configuration (resident tables, warm start on): the service
    benchmark's constraint set, one batch through ``CON_CYCLES`` and a
    last ``Engine.quota_refresh``.  Every cycle's hosts, scores and
    allocation records are held against a warm-disabled engine on the card
    and the CPU engine, each on a store of its own fed the same operations;
    the stores after ``assume`` against each other; each cycle's launches
    against the plan.  Returns (launches per kernel during this phase,
    per-cycle records)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import CPU, MEMORY, NodeMetric
    from koordinator_tpu_torch.api.quota import QuotaGroup
    from koordinator_tpu_torch.service.constraints import ReservationInfo
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.utils.fixtures import NOW

    t0 = time.perf_counter()
    stores = [con_store(scalars, num_nodes) for _ in range(3)]
    print(f"  ingest of three stores: {time.perf_counter() - t0:.1f} s")
    state = stores[0]
    eng, cold, ref = (Engine(stores[0], device=device), Engine(stores[1], device=device),
                      Engine(stores[2], device="cpu"))
    cold.sched_warm_enabled = False
    batch = {e: con_batch(num_pods, "con", SEED + 6) for e in (eng, cold, ref)}
    rng = np.random.default_rng(SEED + 7)
    metric_nodes = [f"node-{int(i)}" for i in rng.choice(num_nodes, 100, replace=False)]
    for k in cuda.KERNELS.values():
        k.launches = 0
    records = []
    with LaunchTimer() as timer:
        for c, (name, dt, plan, expect) in enumerate(CON_CYCLES):
            now = NOW + dt
            for st in stores:
                if c == 2:
                    for i in range(20):
                        st.quota.upsert(QuotaGroup(
                            name=f"bq{i}", min={"cpu": 2_000, "memory": 8 << 30},
                            max={"cpu": 10_000, "memory": 2000 << 30}))
                    for i, node in enumerate(metric_nodes):
                        st.update_metric(node, NodeMetric(
                            node_usage={CPU: 3000 + 11 * i, MEMORY: (3 + i % 5) << 30},
                            update_time=now))
                if c == 3:
                    st.reservations.upsert(ReservationInfo(
                        name="br-new", node="node-5", allocatable={"cpu": 3000,
                                                                   "memory": 8 << 30}, order=3))
                if c == 4:
                    for i in range(8):
                        st.reservations.upsert(ReservationInfo(
                            name=f"pend-{i}", node=None,
                            allocatable={"cpu": 2000 + 250 * i, "memory": 4 << 30},
                            priority=9000, create_time=float(i)))
                if c == 5:
                    for e in (eng, cold, ref):
                        batch[e] = con_batch(num_pods, "con-next", SEED + 8)
            t0 = time.perf_counter()
            for st in stores:
                st.publish(now)
            publish = (time.perf_counter() - t0) * 1e3 / len(stores)
            before = {k: v.launches for k, v in cuda.KERNELS.items()}
            warm0, begin0 = eng.sched_warm_hits, eng.sched_begin_hits
            assume = bool(expect.get("assume"))
            timer.take()
            t0 = time.perf_counter()
            hosts, scores, snap, allocs = eng.schedule(batch[eng], now=now, assume=assume)
            wall = (time.perf_counter() - t0) * 1e3
            k_ms = timer.take()
            launched = {k: v.launches - before[k] for k, v in cuda.KERNELS.items()}
            rounds, ub = eng.last_rounds, eng.last_ub_rounds
            with uncounted():
                ch, cs, _, ca = cold.schedule(batch[cold], now=now, assume=assume)
            rh, rs_, _, ra = ref.schedule(batch[ref], now=now, assume=assume)
            require_equal(f"con cycle {c} ({name}) vs warm-disabled", (hosts, scores), (ch, cs))
            require_equal(f"con cycle {c} ({name}) vs the CPU engine", (hosts, scores), (rh, rs_))
            if allocs != ca or allocs != ra:
                fail(f"con cycle {c} ({name}): allocation records differ")
            counters = (eng.sched_warm_hits, eng.sched_cold_inits, eng.sched_begin_hits)
            if counters != (ref.sched_warm_hits, ref.sched_cold_inits, ref.sched_begin_hits):
                fail(f"con cycle {c} ({name}): warm/cold/begin counters {counters} differ from "
                     f"the CPU engine's")
            want = {k: plan.get(k, 0) for k in launched}
            if launched != want:
                fail(f"con cycle {c} ({name}): launches {launched}, planned {want}")
            is_cold = eng.sched_warm_hits == warm0
            if is_cold != bool(expect.get("cold")):
                fail(f"con cycle {c} ({name}): cold={is_cold}, planned {bool(expect.get('cold'))}")
            if expect.get("begin_hit") and eng.sched_begin_hits != begin0 + 1:
                fail(f"con cycle {c} ({name}): the begin-input cache missed")
            if expect.get("upper_bound") and ub == 0:
                fail(f"con cycle {c} ({name}): no round took the quota upper bound")
            if assume:
                views = [store_view(st) for st in stores]
                if views[0] != views[1] or views[0] != views[2]:
                    fail(f"con cycle {c} ({name}): the stores differ after assume")
                placed_rsv = eng.last_reservations_placed
                if placed_rsv != ref.last_reservations_placed or not placed_rsv:
                    fail(f"con cycle {c} ({name}): reserve pods placed {placed_rsv}, CPU "
                         f"engine {ref.last_reservations_placed}")
            state.residency.verify()
            busy = sum(k_ms.values())
            rec = dict(cycle=name, publish_ms=publish, wall_ms=wall, kernel_ms=k_ms,
                       launches={k: v for k, v in launched.items() if v},
                       placed=int((hosts >= 0).sum()), rounds=rounds, ub_rounds=ub,
                       with_reservation=sum(1 for a in allocs if a and a["reservation"]),
                       warm_hits=eng.sched_warm_hits, cold_inits=eng.sched_cold_inits,
                       begin_hits=eng.sched_begin_hits)
            records.append(rec)
            print(f"  cycle {c} ({name}): {rec['placed']}/{len(hosts)} placed "
                  f"({rec['with_reservation']} on a reservation) in {rounds} rounds, {ub} on the "
                  f"quota upper bound, {'cold' if is_cold else 'warm'}; publish {publish:.1f} ms,"
                  f" schedule {wall:.1f} ms wall, kernels {busy:.2f} ms: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(k_ms.items()))
                  + f"; launches {rec['launches']}; warm/cold/begin {counters}", flush=True)
        # the whole-tree runtime refresh (RefreshRuntime), on the quota kernel
        args = (list(state.quota._groups.values()), state.quota.resources,
                state.quota.cluster_total)
        _, runtime = eng.quota_refresh(*args)
        _, want = ref.quota_refresh(*args)
        require_equal("Engine.quota_refresh", (runtime,), (want,))
        print(f"  Engine.quota_refresh over {len(args[0])} groups equals the CPU engine's; "
              f"{timer.take()}")
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    return launches, records


# ------------------------------------------------ placement and devices


def placement_inputs(dev, M: int, N: int, Lb: int, seed: int):
    """The ``placement`` kernel's inputs, made with numpy from ``seed``: N
    node columns whose label vocab is Lb wide (one hostname label per node,
    then 20 pools and 10 zones), two hard taints (on every 97th and every
    89th node), 64 holder selectors and 64 assigned label sets counted on
    random nodes; M signatures whose selectors name a pool and a zone (one
    in eight adds a pair absent from the vocab), which tolerate no taint,
    one or both, and list up to three holder and label-set columns."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.core import placement as pl

    rng = np.random.default_rng(seed)
    T = lambda a: convert.tensor(a, dev)  # noqa: E731
    host = Lb - 30
    labels = np.zeros((N, Lb), dtype=bool)
    rows = np.arange(N)
    labels[rows, rows % host] = True
    labels[rows, host + rows % 20] = True
    labels[rows, host + 20 + rows % 10] = True
    taints = np.zeros((N, 8), dtype=bool)
    taints[::97, 0] = True
    taints[::89, 1] = True
    aa_cnt = np.zeros((N, 64), dtype=np.int32)
    sig_cnt = np.zeros((N, 64), dtype=np.int32)
    for a in (aa_cnt, sig_cnt):
        a[rng.integers(0, N, 2000), rng.integers(0, 64, 2000)] = rng.integers(1, 3, 2000)
    sel, tol, hold, aa = [], [], [], []
    sel_cnt = np.zeros(M, dtype=np.int32)
    for m in range(M):
        pool = int(rng.integers(0, 20))
        pairs = [host + pool, host + 20 + (pool % 10 if m % 4 else int(rng.integers(0, 10)))]
        sel_cnt[m] = len(pairs) + (m % 8 == 0)  # an absent pair never matches
        sel.append(pairs if m % 16 else [])
        if m % 16 == 0:
            sel_cnt[m] = 0
        tol.append([[0, 1], [1], []][m % 3])
        hold.append(sorted(rng.choice(64, int(rng.integers(0, 4)), replace=False).tolist()))
        aa.append(sorted(rng.choice(64, int(rng.integers(0, 4)), replace=False).tolist()))
    sigs = pl.PlacementSigs(*pl.csr(sel), torch.from_numpy(sel_cnt), *pl.csr(tol), *pl.csr(hold),
                            *pl.csr(aa))
    return sigs, (T(labels), T(taints), T(aa_cnt), T(sig_cnt))


def check_placement_kernel(dev, M: int, N: int, Lb: int, timed: bool):
    """``placement`` against its plain version (exact); its record when
    ``timed``."""
    from koordinator_tpu_torch.core import placement as pl

    sigs, rows = placement_inputs(dev, M, N, Lb, SEED + 20)
    got = pl.placement(sigs, *rows)
    want = pl.placement_plain(sigs, *rows)
    err = require_equal(f"placement {M}x{N} Lb={Lb}", (got,), (want,))
    opened = int(want.sum())
    if not 0 < opened < M * N:
        fail(f"placement {M}x{N}: {opened} open pairs, the check is degenerate")
    print(f"  placement {M} signatures x {N} nodes, Lb {Lb}, two hard taints: equal plain, "
          f"{opened} open pairs")
    if not timed:
        return None
    # the work this run's lists need: each listed column of the node rows
    # read once, the mask written once; a few operations per list entry
    need = 0
    for off, idx, t in ((sigs.sel_off, sigs.sel_idx, rows[0]), (sigs.tol_off, sigs.tol_idx, rows[1]),
                        (sigs.hold_off, sigs.hold_idx, rows[2]), (sigs.aa_off, sigs.aa_idx, rows[3])):
        need += np.unique(idx.numpy()).size * N * t.element_size()
    nnz = sum(t.numel() for t in (sigs.sel_idx, sigs.tol_idx, sigs.hold_idx, sigs.aa_idx))
    b, by = bound_ms(need + M * N + nbytes(*sigs), (3 * nnz + 6 * M) * N)
    return dict(name="placement", source="koordinator_tpu_torch/csrc/placement.cu",
                replaces="koordinator_tpu/service/engine.py:276", max_abs_err=err,
                ms=cuda_ms(lambda: pl.placement(sigs, *rows)),
                plain_ms=cuda_ms(lambda: pl.placement_plain(sigs, *rows)),
                bound_ms=b, bound_by=by, library_ms=None)


def placement_case(dev, M: int, N: int, widths, seed: int, per_list: int = 3,
                   dup: bool = False):
    """``placement``'s inputs with random node rows of the given widths
    (labels, taints, aa_cnt, sig_cnt) and M signatures listing up to
    ``per_list`` columns of each table (with ``dup`` one entry listed
    twice); signature 0 lists nothing at all, signature 1 has empty
    selector and taint lists, and every third signature counts an absent
    selector pair in ``sel_cnt``."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.core import placement as pl

    rng = np.random.default_rng(seed)
    Lb, Tb, Sb, Gb = widths
    labels = rng.random((N, Lb)) < 0.7
    taints = rng.random((N, Tb)) < 0.05
    aa_cnt = (rng.integers(-1, 3, (N, Sb)) * (rng.random((N, Sb)) < 0.05)).astype(np.int32)
    sig_cnt = (rng.integers(0, 3, (N, Gb)) * (rng.random((N, Gb)) < 0.05)).astype(np.int32)
    lists = [[], [], [], []]
    sel_cnt = np.zeros(M, dtype=np.int32)
    for m in range(M):
        for t, width in enumerate(widths):
            k = 0 if m == 0 or (m == 1 and t < 2) else int(rng.integers(0, per_list + 1))
            lst = sorted(rng.choice(width, min(k, width), replace=False).tolist()) if width else []
            if dup and lst:
                lst.append(lst[0])
            lists[t].append(lst)
        sel_cnt[m] = len(lists[0][m]) + (m % 3 == 2)
    sigs = pl.PlacementSigs(*pl.csr(lists[0]), torch.from_numpy(sel_cnt), *pl.csr(lists[1]),
                            *pl.csr(lists[2]), *pl.csr(lists[3]))
    return sigs, tuple(convert.tensor(a, dev) for a in (labels, taints, aa_cnt, sig_cnt))


def placement_cases(dev) -> list:
    """(label, sigs, rows) of ``placement``'s edge cases: N below one tile
    (``PLACEMENT_TILE``), N not a multiple of it, one node, one signature,
    indices listed twice, empty vocabularies, and column unions wider than
    one phase of the gather's shared memory (``PLACEMENT_SMEM``): an
    int32 table split across three phases, and every table split."""
    from koordinator_tpu_torch.core import placement as pl

    T = pl.PLACEMENT_TILE
    return [
        ("N below one tile", *placement_case(dev, 16, T // 2 + 5, (40, 4, 16, 16), SEED + 61)),
        ("N not a multiple of the tile", *placement_case(dev, 24, 5 * T + 17, (64, 6, 32, 32),
                                                         SEED + 62, dup=True)),
        ("one node, one signature", *placement_case(dev, 1, 1, (8, 2, 4, 4), SEED + 63)),
        ("empty vocabularies", *placement_case(dev, 9, 300, (0, 0, 0, 0), SEED + 64)),
        ("an int32 union over three phases", *placement_case(
            dev, 40, 300, (32, 4, 512, 8), SEED + 65, per_list=120, dup=True)),
        ("every union over its phases", *placement_case(
            dev, 64, 2 * T + 3, (3000, 900, 400, 400), SEED + 66, per_list=400)),
    ]


def check_placement_cases(dev) -> int:
    """``placement`` on ``placement_cases`` against its plain version
    (exact), on the card each case's plan carrying a table across phases
    where its label names phases; returns the cases checked."""
    from koordinator_tpu_torch.core import placement as pl

    cases = placement_cases(dev)
    for label, sigs, rows in cases:
        if dev.type == "cuda" and ("phases" in label) != pl.placement_plan(sigs, rows)[3]:
            fail(f"placement {label}: the plan's phases do not match")
        require_equal(f"placement {label}", (pl.placement(sigs, *rows),),
                      (pl.placement_plain(sigs, *rows),))
    print(f"  placement: {len(cases)} edge cases (N below and across the {pl.PLACEMENT_TILE}-"
          "column tile, one node, duplicates, empty vocabularies, unions over several phases) "
          "equal plain", flush=True)
    return len(cases)


def device_inputs(dev, M: int, N: int, Gm: int, seed: int):
    """The device kernels' inputs, made with numpy from ``seed``: a third
    of the N nodes hold 1..Gm GPUs with random free shares (padded slots
    -1) and 0..16 VFs; M signatures of partial shares, whole-GPU counts,
    GPU+RDMA draws, RDMA alone and one invalid count (host data, CPU
    tensors), and M GPU requests."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.core import placement as pl

    rng = np.random.default_rng(seed)
    T = lambda a: convert.tensor(a, dev)  # noqa: E731
    ng = np.where(rng.random(N) < 0.33, rng.integers(1, Gm + 1, N), 0)
    slot = np.arange(Gm)[None, :] < ng[:, None]
    free = np.where(rng.random((N, Gm)) < 0.5, 100, rng.integers(0, 100, (N, Gm)))
    core = np.where(slot, free, -1).astype(np.int32)
    mem = np.where(slot, np.where(free == 100, 100, rng.integers(0, 101, (N, Gm))), -1)
    mem = mem.astype(np.int32)
    full = ((core == 100) & (mem == 100)).sum(axis=1).astype(np.int32)
    vfs = np.where(ng > 0, rng.integers(0, 17, N), 0).astype(np.int32)
    kinds = [(True, False, 0, 50, 50, 0), (True, False, 0, 30, 70, 1), (True, True, 1, 0, 0, 0),
             (True, True, 4, 0, 0, 1), (False, False, 0, 0, 0, 2), (True, True, 3, 0, 0, 0)]
    cols = [[] for _ in range(7)]
    for m in range(M):
        has, multi, cnt, c, r, rd = kinds[m % len(kinds)]
        for k, v in enumerate((has, multi, cnt, c + m % 3, r, rd, m != 7)):
            cols[k].append(v)
    sigs = pl.DeviceSigs(*(torch.from_numpy(np.array(c, dtype=bool if k in (0, 1, 6)
                                                     else np.int32))
                           for k, c in enumerate(cols)))
    alloc2 = np.repeat((100 * ng)[:, None], 2, axis=1).astype(np.int64)
    used2 = np.stack([np.where(slot, 100 - core, 0).sum(1), np.where(slot, 100 - mem, 0).sum(1)],
                     axis=1).astype(np.int64)
    req = np.array([[(100, 100), (50, 50), (400, 400), (30, 60)][m % 4] for m in range(M)],
                   dtype=np.int64)
    return (T(core), T(mem), T(full), T(vfs), sigs), (T(req), T(alloc2), T(used2))


def check_ds_stage(dev, N: int, Gm: int, seed: int) -> int:
    """``DeviceStage.score`` over the six device rows against
    ``ds_score_plain`` times the weight (exact), at M = 16, at the launch
    parameters' cap and past it, with weight 1, the engine's numa weight, 7
    and -3; returns the largest difference (0)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import placement as pl
    from koordinator_tpu_torch.core.cycle import PluginWeights

    err = 0
    for M in (16, cuda.DS_REQ_CAP, cuda.DS_REQ_CAP + 72):
        (core, mem, full, vfs, _), (req, alloc2, used2) = device_inputs(dev, M, N, Gm, seed + M)
        stage = pl.DeviceStage()
        stage.bind((core, mem, full, vfs, alloc2, used2))
        want = pl.ds_score_plain(req, alloc2, used2)
        block = np.ascontiguousarray(req.cpu().numpy())
        for w in sorted({1, PluginWeights().numa, 7, -3}):
            err = max(err, require_equal(f"ds_score stage {M}x{N} Gm={Gm} weight {w}",
                                         (stage.score(block, w),), (want * w,)))
    return err


def check_device_kernels(dev, M: int, N: int, Gm: int, timed: bool):
    """``dev_feasible`` and ``ds_score`` against their plain versions
    (exact; ``ds_score`` also through a ``DeviceStage`` at the parameters'
    cap and past it, times each weight: ``check_ds_stage``); their records
    when ``timed``, each timed as the engine calls it: ``dev_feasible`` on
    the packed block of its signatures, ``ds_score`` through the stage on
    the host block of its requests with the numa weight."""
    from koordinator_tpu_torch.core import placement as pl
    from koordinator_tpu_torch.core.cycle import PluginWeights

    feas_in, score_in = device_inputs(dev, M, N, Gm, SEED + 21 + Gm)
    err = {"dev_feasible": require_equal(f"dev_feasible {M}x{N} Gm={Gm}",
                                         (pl.dev_feasible(*feas_in),),
                                         (pl.dev_feasible_plain(*feas_in),)),
           "ds_score": max(require_equal(f"ds_score {M}x{N} Gm={Gm}", (pl.ds_score(*score_in),),
                                         (pl.ds_score_plain(*score_in),)),
                           check_ds_stage(dev, N, Gm, SEED + 23 + Gm))}
    print(f"  dev_feasible and ds_score {M} signatures x {N} nodes, Gm {Gm}: equal plain, "
          f"{int(pl.dev_feasible_plain(*feas_in).sum())} feasible pairs; ds_score through the "
          "stage at 16, 128 and 200 requests, weights 1, numa, 7 and -3: equal plain")
    if not timed:
        return []
    core, mem, full, vfs, sigs = feas_in
    req, alloc2, used2 = score_in
    # timed as the engine calls them: the signatures packed into one block,
    # the requests a host block through the device table's stage
    packed = (core, mem, full, vfs, pl.pack_device_sigs(sigs))
    stage = pl.DeviceStage()
    stage.bind((core, mem, full, vfs, alloc2, used2))
    block, numa = np.ascontiguousarray(req.cpu().numpy()), PluginWeights().numa
    b1 = bound_ms(nbytes(core, mem, full, vfs, *sigs) + M * N, M * N * (2 * Gm + 4))
    b2 = bound_ms(nbytes(*score_in) + M * N * 8, M * N * 12)
    return [
        dict(name="dev_feasible", source="koordinator_tpu_torch/csrc/device.cu",
             replaces="koordinator_tpu/service/engine.py:292", max_abs_err=err["dev_feasible"],
             ms=cuda_ms(lambda: pl.dev_feasible(*packed)),
             plain_ms=cuda_ms(lambda: pl.dev_feasible_plain(*feas_in)), bound_ms=b1[0],
             bound_by=b1[1], library_ms=None, gm=Gm),
        dict(name="ds_score", source="koordinator_tpu_torch/csrc/device.cu",
             replaces="koordinator_tpu/service/engine.py:384", max_abs_err=err["ds_score"],
             ms=cuda_ms(lambda: stage.score(block, numa)),
             plain_ms=cuda_ms(lambda: pl.ds_score_plain(*score_in) * numa), bound_ms=b2[0],
             bound_by=b2[1], library_ms=None),
    ]


def check_extend_kernel(dev, N: int, timed: bool):
    """``dstate_extend`` against its plain version: a [N, 256] bool table
    widened to 512 (fill False) and a [N, 8] int32 one to 16 (fill -1) in
    one launch, the sources untouched; ``F.pad`` on each beside it."""
    import torch.nn.functional as F

    from koordinator_tpu_torch.service import state as sm

    rng = np.random.default_rng(SEED + 22)
    a = torch.from_numpy(rng.random((N, 256)) < 0.01).to(dev)
    b = torch.from_numpy(rng.integers(-1, 101, (N, 8)).astype(np.int32)).to(dev)
    keep = (a.clone(), b.clone())
    args = ([a, b], [512, 16], [False, -1])
    got = sm.dstate_extend(*args)
    err = require_same(f"dstate_extend {N} rows", got, sm.dstate_extend_plain(*args))
    require_same("dstate_extend against F.pad",
                 got, (F.pad(a, (0, 256), value=False), F.pad(b, (0, 8), value=-1)))
    require_same("dstate_extend's sources", (a, b), keep)
    print(f"  dstate_extend [{N}, 256] bool -> 512 and [{N}, 8] int32 -> 16: equal plain and "
          f"F.pad, sources untouched")
    if not timed:
        return None
    bb, by = bound_ms(nbytes(a, b) + nbytes(*got), 0)

    def pad():
        return F.pad(a, (0, 256), value=False), F.pad(b, (0, 8), value=-1)

    # each timed two ways: events around one call (the host's share
    # included), and the device time of a run of 100 back-to-back calls
    return dict(name="dstate_extend", source="koordinator_tpu_torch/csrc/dstate.cu",
                replaces="koordinator_tpu/service/state.py:208", max_abs_err=err,
                ms=cuda_ms(lambda: sm.dstate_extend(*args)),
                ms_run=run_ms(lambda: sm.dstate_extend(*args)),
                plain_ms=cuda_ms(lambda: sm.dstate_extend_plain(*args)),
                library_ms=cuda_ms(pad), library_ms_run=run_ms(pad),
                bound_ms=bb, bound_by=by)


def extend_cases(dev, rows: int = 1000):
    """(what, buffers, widths, fills) of ``dstate_extend``'s edge cases:
    32 buffers in one launch (bool, int32 and int64 tables of varied
    widths, some 16-byte rows, some ragged); row widths that are not
    multiples of 16 bytes (int64 3 -> 5, bool 5 -> 21); zero rows."""
    rng = np.random.default_rng(SEED + 26)

    def table(dtype, r: int, c: int):
        if r == 0:
            return torch.zeros((0, c), dtype=dtype, device=dev)
        if dtype is torch.bool:
            return torch.from_numpy(rng.random((r, c)) < 0.3).to(dev)
        return torch.from_numpy(rng.integers(-5, 100, (r, c))).to(dtype).to(dev)

    kinds = (torch.bool, torch.int32, torch.int64)
    many = [(kinds[i % 3], 4 * (i % 5) + i % 3 + 1, 4 * (i % 5) + i % 3 + 1 + 7 * (i % 4))
            for i in range(32)]
    fills = {torch.bool: True, torch.int32: -1, torch.int64: 0}
    cases = [("32 buffers", [table(d, rows, c) for d, c, _ in many], [w for *_, w in many],
              [fills[d] for d, *_ in many])]
    cases.append(("int64 3 -> 5, bool 5 -> 21",
                  [table(torch.int64, rows, 3), table(torch.bool, rows, 5)], [5, 21], [-1, False]))
    cases.append(("zero rows", [table(torch.bool, 0, 256), table(torch.int32, 0, 8)], [512, 16],
                  [False, -1]))
    return cases


def check_extend_cases(dev) -> None:
    """``dstate_extend`` on ``extend_cases`` against its plain version and
    ``F.pad``, bit for bit, the sources unchanged."""
    import torch.nn.functional as F

    from koordinator_tpu_torch.service import state as sm

    for what, bufs, widths, fills in extend_cases(dev):
        keep = [b.clone() for b in bufs]
        got = sm.dstate_extend(bufs, widths, fills)
        require_same(f"dstate_extend {what}", got, sm.dstate_extend_plain(bufs, widths, fills))
        require_same(f"dstate_extend {what} against F.pad", got, [
            F.pad(b, (0, w - b.shape[1]), value=f) for b, w, f in zip(bufs, widths, fills)])
        require_same(f"dstate_extend {what}: the sources", bufs, keep)
    print("  dstate_extend: 32 buffers, ragged row widths and zero rows equal plain and F.pad")


def scatter_cases(rows: int = 300) -> list:
    """``dstate_scatter``'s cases, (what, host arrays, batches): each batch
    an (index, rows) pair as the residency pads it (the index repeats a
    real row, and so do the rows), applied in order with no synchronise
    between.  The arrays have rows of 1 and 8 bytes and widths that are no
    multiple of 16 (5, 12, 56 bytes) beside one that is; the cases are one
    row (D = 1), duplicate padded indices, and three scatters back to back
    on disjoint rows (the staging reused before the card has read it)."""
    rng = np.random.default_rng(SEED + 91)
    host = [rng.random(rows) < 0.5, rng.integers(-1 << 60, 1 << 60, rows),
            rng.integers(0, 1 << 30, (rows, 3)).astype(np.int32), rng.random((rows, 5)) < 0.5,
            rng.uniform(-1e6, 1e6, (rows, 2)), rng.integers(0, 9, (rows, 7))]
    order = rng.permutation(rows).astype(np.int32)

    def batch(real, pad: bool = True):
        idx = padded(real) if pad else real
        src = rng.choice(rows, real.size, replace=False).astype(np.int32)
        src = padded(src) if pad else src
        return idx, tuple(np.ascontiguousarray(h[src]) for h in host)

    return [
        ("one row", host, [batch(order[:1], pad=False)]),
        ("duplicate padded indices", host, [batch(order[:5])]),
        ("back to back", host, [batch(order[:13]), batch(order[13:40]), batch(order[40:41],
                                                                              pad=False)]),
    ]


def check_scatter_cases(dev) -> None:
    """``dstate_scatter`` on ``scatter_cases``, each batch issued right after
    the last with no synchronise, against its plain version and
    ``index_copy_`` applied in the same order, bit for bit."""
    from koordinator_tpu_torch.service import state as sm

    for what, host, batches in scatter_cases():
        bufs = sm.dstate_rows(host, dev)
        plain = tuple(b.clone() for b in bufs)
        library = tuple(b.clone() for b in bufs)
        for idx, vals in batches:
            sm.dstate_scatter(bufs, idx, vals)
        for idx, vals in batches:
            i = torch.from_numpy(idx).to(dev)
            v = [torch.from_numpy(x).to(dev) for x in vals]
            sm.dstate_scatter_plain(plain, i, v)
            for b, x in zip(library, v):
                b.index_copy_(0, i.long(), x)
        require_same(f"dstate_scatter {what}", bufs, plain)
        require_same(f"dstate_scatter {what} against index_copy_", bufs, library)
    print("  dstate_scatter: rows of 1 to 56 bytes, one row, duplicate padded indices, three "
          "scatters back to back: equal plain and index_copy_", flush=True)


def extras_for(inp, seed: int):
    """A placement-and-devices mask (about 90% open) and extra scores in
    [0, 200] at the inputs' [P, N], made with numpy from ``seed``."""
    from koordinator_tpu_torch import convert

    P, N = inp["la_pods"].est.shape[0], inp["valid"].shape[0]
    rng = np.random.default_rng(seed)
    dev = inp["valid"].device
    return (convert.tensor(rng.random((P, N)) < 0.9, dev),
            convert.tensor(rng.integers(0, 201, (P, N)).astype(np.int64), dev))


def check_extra_kernels(inp, con: bool, timed: bool, commit_cap: int = 16):
    """The schedule kernels with the extra channel (a random mask and
    extra scores), plain (``con`` False) or constrained, against their
    plain versions: the key build, the round loop, a 128-row refresh (also
    against a cold key build) and the warm rounds.  Then an all-open mask
    with zero scores must repeat the results and round counts of the
    launches without extras.  Returns {kernel: ms with extras} when
    ``timed``."""
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.core.cycle import PluginWeights, score_batch, score_fn

    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    la_nodes, nf_nodes, valid = inp["la_nodes"], inp["nf_nodes"], inp["valid"]
    w, static, dev = inp["weights"], inp["static"], inp["valid"].device
    pw = PluginWeights()
    P, N = la_pods.est.shape[0], valid.shape[0]
    BS, AD = 16, 8
    xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(la_pods, nf_pods, valid, inp["p_real"],
                                                    inp["order"])
    c = con_for(inp, con_inputs_for(inp, SEED + 11), xs) if con else None
    x_feas, x_sc = extras_for(inp, SEED + 23)
    xin = rs.extra_inputs(x_feas, x_sc, xs)
    score_args = (la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid, x_sc)
    if not con:  # the score kernel adds the extra scores
        t, f = score_batch(*score_args[:6], pw)
        require_equal(f"score with extra scores {P}x{N}", score_fn(*score_args),
                      (t + x_sc, f & valid[None, :]))
    tag = "_con" if con else ""
    q_extra = pod_ok[:, None] & valid[None, :]
    if con:
        q_extra = q_extra & rs.gang_pass(c)[:, None]
    q_extra_x, q_xsc = rs._q_extras(xin, q_extra)
    rsv_q = rs._queue_rsv(c) if con else None
    keys_args = (q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok, salts, BS, c)
    node_args = (q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok, salts, commit_cap, BS)
    con_kw = (c, 0, AD)

    keys = rs.schedule_keys(*keys_args, xin)
    require_equal(f"schedule_keys{tag} with extras {P}x{N}", keys, rs.build_keys_plain(
        q_la, la_nodes, w, q_nf, nf_nodes, static, pw, q_extra_x, salts, BS, rsv_q, q_xsc))
    got = rs.schedule_rounds(keys[0].clone(), keys[1].clone(), keys[2], *node_args, *con_kw,
                             xin=xin)
    want = rs._plain_rounds(keys[0].clone(), keys[1].clone(), keys[2], *node_args, *con_kw,
                            xin=xin)
    require_equal(f"schedule_rounds{tag} with extras {P}x{N}", got, want)
    rounds = int(want[-1].view(-1)[0])
    rng = np.random.default_rng(SEED + 24)
    real = rng.choice(N, size=min(125, N // 2), replace=False).astype(np.int32)
    idx = padded(real)
    la2, nf2 = perturbed_nodes(la_nodes, nf_nodes, torch.from_numpy(real).to(dev).long())
    clone = lambda t: tuple(a.clone() for a in t)  # noqa: E731
    rargs = (q_la, la2, w, q_nf, nf2, static, valid, pod_ok, salts)
    carry = rs.schedule_refresh(clone(keys), idx, *rargs, BS, c, xin)
    require_equal(f"sched_refresh{tag} with extras D={idx.size}", carry, rs.refresh_plain(
        *clone(keys), torch.from_numpy(idx).to(dev), q_la, la2, w, q_nf, nf2, static, pw,
        q_extra_x, salts, BS, rs.rsv_view(c) if con else None, q_xsc))
    require_equal(f"sched_refresh{tag} with extras against a cold key build", carry,
                  rs.schedule_keys(*rargs, BS, c, xin))
    warm_args = (q_la, la2, w, q_nf, nf2, static, valid, pod_ok, salts, commit_cap, BS, *con_kw)
    got = rs.schedule_rounds_warm(carry, *warm_args, xin=xin)
    want_w = rs._plain_rounds(carry[0].clone(), carry[1].clone(), carry[2], *warm_args, xin=xin)
    require_equal(f"sched_rounds{tag} with extras {P}x{N}", got, want_w)

    # neutral extras repeat the launches without them, round counts included
    ones = rs.ExtraInputs(feas=torch.ones((N, P), dtype=torch.bool, device=dev),
                          scores=torch.zeros((N, P), dtype=torch.int64, device=dev))
    plain_keys = rs.schedule_keys(*keys_args)
    require_equal(f"schedule_keys{tag}, neutral extras", rs.schedule_keys(*keys_args, ones),
                  plain_keys)
    base = rs.schedule_rounds(plain_keys[0].clone(), plain_keys[1].clone(), plain_keys[2],
                              *node_args, *con_kw)
    neutral = rs.schedule_rounds(plain_keys[0].clone(), plain_keys[1].clone(), plain_keys[2],
                                 *node_args, *con_kw, xin=ones)
    require_equal(f"schedule_rounds{tag}, neutral extras", neutral, base)
    print(f"  {P} pods x {N} nodes{', constrained' if con else ''}, with extras: kernels equal "
          f"plain, {rounds} rounds; neutral extras repeat {int(base[-1].view(-1)[0])} rounds")
    if not timed:
        return None
    work = {}

    def reset():
        work["M"], work["Mb"] = keys[0].clone(), keys[1].clone()

    out = {} if con else {"score": cuda_ms(lambda: score_fn(*score_args))}
    return {
        **out,
        f"schedule_keys{tag}": cuda_ms(lambda: rs.schedule_keys(*keys_args, xin)),
        f"schedule_rounds{tag}": cuda_ms(
            lambda: rs.schedule_rounds(work["M"], work["Mb"], keys[2], *node_args, *con_kw,
                                       xin=xin), setup=reset),
        f"sched_refresh{tag}": cuda_ms(lambda: rs.schedule_refresh(work["c"], idx, *rargs, BS, c,
                                                                   xin),
                                       setup=lambda: work.update(c=clone(keys))),
        f"sched_rounds{tag}": cuda_ms(lambda: rs.schedule_rounds_warm(carry, *warm_args, xin=xin)),
    }


# the placement-and-devices phase's cycles: (name, clock offset from NOW,
# launches expected of the main engine, expectations)
PLACE_CYCLES = (
    ("cold, with a SCORE", 0.0, dict(placement=1, dev_feasible=1, ds_score=1, score=1,
                                     schedule_keys=1, schedule_rounds=1, dstate_gate=1),
     dict(cold=True)),
    ("unchanged", 1.0, dict(sched_rounds=1, dstate_gate=1), dict(begin_hit=True)),
    ("a label flipped, metrics on 100 nodes", 2.0,
     dict(placement=1, dstate_scatter=2, sched_refresh=1, sched_rounds=1, dstate_gate=1),
     dict(refresh_rows=128)),
    ("vocab growth and a 16-GPU node", 3.0,
     dict(placement=1, dev_feasible=1, ds_score=1, dstate_extend=2, dstate_scatter=3,
          sched_refresh=1, sched_rounds=1, dstate_gate=1), dict(extends=2)),
    ("assume", 4.0, dict(sched_rounds=1, dstate_gate=1), dict(begin_hit=True, assume=True)),
    # the audit after the assume cycle already synced its policy and device
    # rows; the rows table's refresh waits for this cycle's publish
    ("the next batch", 5.0, dict(placement=1, dev_feasible=1, ds_score=1, schedule_keys=1,
                                 schedule_rounds=1, dstate_scatter=1, dstate_gate=1),
     dict(cold=True)),
)
PLACE_PATH_KERNELS = ("placement", "dev_feasible", "ds_score", "dstate_extend", "score",
                      "schedule_keys", "schedule_rounds", "sched_refresh", "sched_rounds",
                      "dstate_scatter", "dstate_gate")
GB = 1 << 30


def place_hosts(num_nodes: int) -> dict:
    """The phase's roles by node index: the first fifth of the fleet (2,000
    of 10,000) carry GPUs; every 10th of those runs single-numa-node and
    every 10th + 5 amplifies CPU by 1.5; every 100th node is tainted
    dedicated=infra; node-1 hosts the pinned whole-GPU pods and the 50
    nodes after the GPU fleet the pinned anti-affinity pods."""
    gpu = num_nodes // 5
    return dict(gpu=gpu, pinned_gpu="node-1", pinned_aa=[f"node-{gpu + k}" for k in range(50)])


def placement_store(scalars, num_nodes: int, nf_args=None):
    """A store with the composed benchmark's device and selector load
    (bench/bench_composed.py:135-137, :154-175) and the device benchmark's
    anti-affinity load (bench/bench_device.py:160-177), on
    ``random_cluster(seed=7)``: labels {hostname, pool-(i mod 20), z(i mod
    10)}; every 100th node tainted dedicated=infra:NoSchedule; the GPU
    fleet with 8 GPUs (numa m // 4, pcie m // 2), 2 RDMA NICs of 8 VFs and
    a 2-socket x 16-core x 2-thread topology; 2,000 assigned pods labelled
    team t(j mod 50) on random nodes, every 20th with required
    anti-affinity on its own team.  The pinned hosts are made roomy (128
    cores, 1 TiB, no NodeMetric)."""
    from koordinator_tpu_torch.api.model import CPU, MEMORY, AssignedPod, Pod
    from koordinator_tpu_torch.core.deviceshare import GPUDevice, RDMADevice
    from koordinator_tpu_torch.core.numa import CPUTopology
    from koordinator_tpu_torch.service.state import ClusterState, NodeTopologyInfo
    from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster

    roles = place_hosts(num_nodes)
    roomy = {roles["pinned_gpu"], *roles["pinned_aa"]}
    st = ClusterState(extra_scalars=scalars, nf_args=nf_args)
    _, fleet = random_cluster(SEED, num_nodes=num_nodes, num_pods=0)
    for i, n in enumerate(fleet):
        n.labels = dict(n.labels, **{"kubernetes.io/hostname": n.name, "pool": f"pool-{i % 20}",
                                     "zone": f"z{i % 10}"})
        if i % 100 == 99:
            n.taints = [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
        if n.name in roomy:
            n.allocatable = {CPU: 128_000, MEMORY: 1024 * GB}
            n.metric = None
        st.upsert_node(n)
    for i in range(roles["gpu"]):
        name = fleet[i].name
        st.set_devices(name, [GPUDevice(minor=m, numa_node=m // 4, pcie=m // 2) for m in range(8)],
                       [RDMADevice(minor=m, numa_node=m, vfs_free=8) for m in range(2)])
        st.set_topology(name, NodeTopologyInfo(
            topo=CPUTopology(sockets=2, nodes_per_socket=1, cores_per_node=16, cpus_per_core=2),
            policy="single-numa-node" if i % 10 == 0 else "none",
            cpu_ratio=1.5 if i % 10 == 5 else 1.0))
    rng = np.random.default_rng(SEED + 30)
    for j in range(num_nodes // 5):
        team = f"t{j % 50}"
        st.assign_pod(fleet[int(rng.integers(0, num_nodes))].name, AssignedPod(
            pod=Pod(name=f"held-{j}", namespace="held", requests={CPU: 500, MEMORY: GB},
                    labels={"team": team}, anti_affinity={"team": team} if j % 20 == 0 else None),
            assign_time=NOW))
    st.publish(NOW)
    return st


def placement_batch(num_nodes: int, num_pods: int, tag: str, seed: int):
    """``num_pods`` pending pods with the composed benchmark's mix
    (bench/bench_composed.py:209-228): i mod 10 == 1 GPU pods of its four
    signatures, i mod 50 == 2 LSR cpuset pods, i mod 5 == 3 node selectors
    over pool x zone; then i mod 20 == 4 anti-affinity on team t(i mod 50)
    (labelled so, pinned by hostname per team, so a team's second pod on a
    host is demoted in the replay) and i mod 20 == 9 tolerating
    dedicated=infra.  The first three whole-node GPU pods are pinned to one
    8-GPU host: the third finds its devices taken."""
    from koordinator_tpu_torch.api.model import CPU, MEMORY
    from koordinator_tpu_torch.core.deviceshare import GPU_CORE, GPU_MEMORY_RATIO, RDMA
    from koordinator_tpu_torch.utils.fixtures import random_pod

    roles = place_hosts(num_nodes)
    gpu_kinds = ({CPU: 4000, MEMORY: 16 * GB, GPU_CORE: 100, GPU_MEMORY_RATIO: 100},
                 {CPU: 2000, MEMORY: 8 * GB, GPU_CORE: 50, GPU_MEMORY_RATIO: 50},
                 {CPU: 8000, MEMORY: 64 * GB, GPU_CORE: 400, GPU_MEMORY_RATIO: 400},
                 {CPU: 4000, MEMORY: 16 * GB, GPU_CORE: 100, GPU_MEMORY_RATIO: 100, RDMA: 2})
    pods = []
    for i in range(num_pods):
        p = random_pod(np.random.default_rng([seed, i]), f"{tag}-{i}", "pending")
        if i % 10 == 1:
            kind = (i // 10) % 4
            p.requests = dict(gpu_kinds[kind])
            if kind == 2 and i < 120:
                p.node_selector = {"kubernetes.io/hostname": roles["pinned_gpu"]}
        elif i % 50 == 2:
            p.requests, p.qos = {CPU: 8000, MEMORY: 16 * GB}, "LSR"
        elif i % 5 == 3:
            p.node_selector = {"pool": f"pool-{i % 20}", "zone": f"z{i % 10}"}
        elif i % 20 == 4:
            team = f"t{i % 50}"
            p.labels, p.anti_affinity = {"team": team}, {"team": team}
            p.node_selector = {"kubernetes.io/hostname": roles["pinned_aa"][i % 50]}
        elif i % 20 == 9:
            p.tolerations = [{"key": "dedicated", "operator": "Equal", "value": "infra",
                              "effect": "NoSchedule"}]
        pods.append(p)
    return pods


def device_view(st) -> tuple:
    """The store's device state: grants by pod, free shares by GPU, free VFs
    by NIC, held CPUs by node."""
    return (
        sorted((k, v[0], [tuple(x) for x in v[1]], [tuple(x) for x in v[2]], list(v[3]), v[4])
               for k, v in st._dev_alloc.items()),
        sorted((n, d.minor, d.core_free, d.memory_ratio_free) for n, ds in st._gpus.items()
               for d in ds),
        sorted((n, r.minor, r.vfs_free) for n, rs in st._rdma.items() for r in rs),
        sorted((n, sorted((c, tuple(p)) for c, p in held.items()))
               for n, held in st._cpus_taken.items() if held),
    )


def place_cycle_ops(st, c: int, now: float, metric_nodes, flip: str) -> None:
    """The store operations ahead of ``PLACE_CYCLES``' cycle ``c``: before
    cycle 2 a label flipped on ``flip`` and metrics on ``metric_nodes``;
    before cycle 3 assigned pods with new label sets, past the label-set
    vocabulary's bucket, and one node re-inventoried with 16 GPUs."""
    import copy

    from koordinator_tpu_torch.api.model import CPU, MEMORY, AssignedPod, NodeMetric, Pod
    from koordinator_tpu_torch.core.deviceshare import GPUDevice, RDMADevice

    if c == 2:
        spec = copy.copy(st._nodes[flip])
        spec.labels = dict(spec.labels, flip="x")
        st.upsert_node(spec)
        for i, node in enumerate(metric_nodes):
            st.update_metric(node, NodeMetric(
                node_usage={CPU: 3000 + 11 * i, MEMORY: (3 + i % 5) * GB}, update_time=now))
    if c == 3:
        for k in range(st._Gb - len(st._sig_vocab) + 1):
            st.assign_pod(f"node-{100 + 7 * k}", AssignedPod(pod=Pod(
                name=f"grow-{k}", namespace="held", requests={CPU: 100},
                labels={"team": f"grow-{k}"}), assign_time=now))
        st.set_devices("node-3", [GPUDevice(minor=m, numa_node=m // 8, pcie=m // 4)
                                  for m in range(16)],
                       [RDMADevice(minor=m, numa_node=m, vfs_free=8) for m in range(2)])


def drive_placement_path(device, num_nodes: int, num_pods: int, scalars):
    """The placement-and-devices phase at full width in the default serving
    configuration (resident tables, warm start on): ``placement_store``
    and ``placement_batch`` through ``PLACE_CYCLES``.  Every cycle's hosts,
    scores and allocation records (grants included) are held against a
    warm-disabled engine on the card and the CPU engine, each on a store
    of its own fed the same operations; after ``assume`` the stores'
    device state against each other; each cycle's launches against the
    plan.  Returns (launches per kernel during this phase, per-cycle
    records)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.service.state import next_bucket
    from koordinator_tpu_torch.utils.fixtures import NOW

    t0 = time.perf_counter()
    stores = [placement_store(scalars, num_nodes) for _ in range(3)]
    print(f"  ingest of three stores: {time.perf_counter() - t0:.1f} s", flush=True)
    state, res = stores[0], stores[0].residency
    eng, cold, ref = (Engine(stores[0], device=device), Engine(stores[1], device=device),
                      Engine(stores[2], device="cpu"))
    cold.sched_warm_enabled = False
    batch = {e: placement_batch(num_nodes, num_pods, "place", SEED + 31) for e in (eng, cold, ref)}
    rng = np.random.default_rng(SEED + 32)
    metric_nodes = [f"node-{int(i)}" for i in rng.choice(num_nodes, 100, replace=False)]
    flip = f"node-{num_nodes - 2}"
    on_card = device.type == "cuda"
    for k in cuda.KERNELS.values():
        k.launches = 0
    records = []
    with LaunchTimer() as timer:
        for c, (name, dt, plan, expect) in enumerate(PLACE_CYCLES):
            now = NOW + dt
            for st in stores:
                place_cycle_ops(st, c, now, metric_nodes, flip)
                if c == 5:
                    for e in (eng, cold, ref):
                        batch[e] = placement_batch(num_nodes, num_pods, "place-next", SEED + 33)
            t0 = time.perf_counter()
            for st in stores:
                st.publish(now)
            publish = (time.perf_counter() - t0) * 1e3 / len(stores)
            before = {k: v.launches for k, v in cuda.KERNELS.items()}
            warm0, begin0 = eng.sched_warm_hits, eng.sched_begin_hits
            up0, ext0 = res.full_uploads, res.extends
            assume = bool(expect.get("assume"))
            if on_card:
                timer.take()
            t0 = time.perf_counter()
            score_wall = None
            if c == 0:
                totals, feasible, _ = eng.score(batch[eng], now=now)
                score_wall = (time.perf_counter() - t0) * 1e3
                rt, rf, _ = ref.score(batch[ref], now=now)
                require_equal("placement SCORE vs the CPU engine", (totals, feasible), (rt, rf))
                t0 = time.perf_counter()
            hosts, scores, snap, allocs = eng.schedule(batch[eng], now=now, assume=assume)
            wall = (time.perf_counter() - t0) * 1e3
            k_ms = timer.take() if on_card else {}
            launched = {k: v.launches - before[k] for k, v in cuda.KERNELS.items()}
            demotions = dict(eng.last_demotions)
            with uncounted():
                ch, cs, _, ca = cold.schedule(batch[cold], now=now, assume=assume)
            rh, rs_, _, ra = ref.schedule(batch[ref], now=now, assume=assume)
            require_equal(f"place cycle {c} ({name}) vs warm-disabled", (hosts, scores), (ch, cs))
            require_equal(f"place cycle {c} ({name}) vs the CPU engine", (hosts, scores),
                          (rh, rs_))
            if allocs != ca or allocs != ra:
                fail(f"place cycle {c} ({name}): allocation records differ")
            if demotions != ref.last_demotions or demotions != cold.last_demotions:
                fail(f"place cycle {c} ({name}): demotions {demotions}, CPU engine "
                     f"{ref.last_demotions}")
            counters = (eng.sched_warm_hits, eng.sched_cold_inits, eng.sched_begin_hits)
            if counters != (ref.sched_warm_hits, ref.sched_cold_inits, ref.sched_begin_hits):
                fail(f"place cycle {c} ({name}): warm/cold/begin counters {counters} differ from "
                     f"the CPU engine's")
            want = {k: plan.get(k, 0) for k in launched}
            if on_card and launched != want:
                fail(f"place cycle {c} ({name}): launches {launched}, planned {want}")
            is_cold = eng.sched_warm_hits == warm0
            if is_cold != bool(expect.get("cold")):
                fail(f"place cycle {c} ({name}): cold={is_cold}, planned {bool(expect.get('cold'))}")
            if expect.get("begin_hit") and eng.sched_begin_hits != begin0 + 1:
                fail(f"place cycle {c} ({name}): the begin-input cache missed")
            if "refresh_rows" in expect and next_bucket(eng.sched_last_dirty, 16) != \
                    expect["refresh_rows"]:
                fail(f"place cycle {c} ({name}): refreshed {eng.sched_last_dirty} rows")
            if c and res.full_uploads != up0:
                fail(f"place cycle {c} ({name}): {res.full_uploads - up0} wholesale uploads")
            if res.extends - ext0 != expect.get("extends", 0):
                fail(f"place cycle {c} ({name}): {res.extends - ext0} table extensions")
            if assume:
                if min(demotions.values()) == 0:
                    fail(f"place cycle {c} ({name}): demotions {demotions}, planned at least one "
                         f"of each")
                views = [device_view(st) for st in stores]
                if views[0] != views[1] or views[0] != views[2] or not views[0][0]:
                    fail(f"place cycle {c} ({name}): the stores' device state differs after "
                         f"assume")
                if sorted(state._pod_node.items()) != sorted(stores[2]._pod_node.items()):
                    fail(f"place cycle {c} ({name}): the stores' placements differ")
            res.verify()
            placed = int((hosts >= 0).sum())
            grants = sum(1 for a in allocs if a and ("devices" in a or "cpuset" in a))
            busy = sum(k_ms.values())
            rec = dict(cycle=name, publish_ms=publish, wall_ms=wall, score_wall_ms=score_wall,
                       kernel_ms=k_ms, launches={k: v for k, v in launched.items() if v},
                       placed=placed, grants=grants, demotions=demotions, rounds=eng.last_rounds,
                       dirty_rows=None if is_cold else eng.sched_last_dirty,
                       warm_hits=eng.sched_warm_hits, cold_inits=eng.sched_cold_inits,
                       begin_hits=eng.sched_begin_hits, full_uploads=res.full_uploads,
                       scatters=res.scatters, extends=res.extends,
                       h2d_bytes=res.h2d_bytes_total,
                       policy_bytes=res.table_bytes("policy"),
                       device_bytes=res.table_bytes("device"))
            records.append(rec)
            print(f"  cycle {c} ({name}): {placed}/{len(hosts)} placed ({grants} with devices or "
                  f"cpusets; demoted {demotions}) in {rec['rounds']} rounds, "
                  f"{'cold' if is_cold else 'warm'}, dirty {rec['dirty_rows']}; publish "
                  f"{publish:.1f} ms, schedule {wall:.1f} ms wall"
                  + (f", score {score_wall:.1f} ms wall" if score_wall else "")
                  + f", kernels {busy:.2f} ms: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(k_ms.items()))
                  + f"; launches {rec['launches']}; warm/cold/begin {counters}; tables: policy "
                  f"{rec['policy_bytes']} B, device {rec['device_bytes']} B, h2d "
                  f"{rec['h2d_bytes']} B, uploads {res.full_uploads}, scatters {res.scatters}, "
                  f"extends {res.extends}", flush=True)
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    return launches, records


# ------------------------------------------------------------ strategies

# the RequestedToCapacityRatio shapes of the checks, in config units
# (utilization, score 0..10): the bin-packing default, and the parity
# tests' non-monotone shape, whose decreasing segment interpolates with
# truncation toward zero
RTC_SHAPES = (("rtc", ((0, 0), (100, 10))),
              ("rtc-nonmono", ((0, 2), (40, 10), (70, 3), (100, 6))))


def strategy_statics(static) -> list:
    """(name, NodeFitStatic) of MostAllocated and the two RTC shapes over
    ``static``'s resources and weights, the shape scaled as
    ``NodeFitArgs.scaled_shape`` scales it."""
    import dataclasses

    from koordinator_tpu_torch.core.config import NodeFitArgs

    out = [("most", dataclasses.replace(static, strategy="MostAllocated"))]
    for name, shape in RTC_SHAPES:
        scaled = NodeFitArgs(shape=list(shape)).scaled_shape()
        out.append((name, dataclasses.replace(static, strategy="RequestedToCapacityRatio",
                                              shape=scaled)))
    return out


def check_strategy_score(inp, timed: bool):
    """The ``score`` kernel under MostAllocated and both RTC shapes against
    the plain ``score_batch`` (raises ``Mismatch``).  Returns {strategy:
    (ms, plain ms)} when ``timed``."""
    from koordinator_tpu_torch.core.cycle import PluginWeights, score_batch, score_fn

    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    la_nodes, nf_nodes, valid, w = inp["la_nodes"], inp["nf_nodes"], inp["valid"], inp["weights"]
    P, N = la_pods.est.shape[0], valid.shape[0]
    out = {}
    for name, static in strategy_statics(inp["static"]):
        def plain():
            t, f = score_batch(la_pods, la_nodes, w, nf_pods, nf_nodes, static, PluginWeights())
            return t, f & valid[None, :]

        def kernel():
            return score_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid)

        got, want = kernel(), plain()
        require_equal(f"score {name} {P}x{N}", got, want)
        if len(set(want[0][want[1]].tolist()[:4096])) < 2:
            fail(f"score {name}: the feasible totals do not vary")
        if timed:
            out[name] = (cuda_ms(kernel), cuda_ms(plain))
    print(f"  {P} pods x {N} nodes: score under MostAllocated and RTC (default and non-monotone "
          "shapes) equals plain")
    return out if timed else None


def synthetic_inputs(dev, seed: int, P: int, N: int, R: int, Rf: int, Rs: int,
                     bypass=None) -> dict:
    """The pair function's inputs at any widths, made with numpy from
    ``seed``: random rows with zeros, overcommitted nodes, both LoadAware
    branches and the filters' edges; ``bypass`` the NodeFit scalar bypass
    (default none)."""
    from koordinator_tpu_torch.core.loadaware import LoadAwareNodeArrays, LoadAwarePodArrays
    from koordinator_tpu_torch.core.nodefit import (NodeFitNodeArrays, NodeFitPodArrays,
                                                     NodeFitStatic)

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    def ints(lo, hi, shape, zeros=0.1):
        a = rng.integers(lo, hi, size=shape).astype(np.int64)
        return np.where(rng.random(shape) < zeros, 0, a)

    def bools(p, shape):
        return rng.random(shape) < p

    la_alloc = ints(1000, 16000, (N, R))
    la_nodes = LoadAwareNodeArrays(
        t(la_alloc), t(ints(0, 18000, (N, R))), t(ints(0, 18000, (N, R))), t(bools(0.9, N)),
        t(ints(0, 16000, (N, R))), t(bools(0.8, N)), t(ints(0, 100, (N, R), 0.3)),
        t(ints(0, 16000, (N, R))), t(bools(0.7, N)), t(ints(0, 100, (N, R), 0.3)),
        t(bools(0.5, N)))
    la_pods = LoadAwarePodArrays(t(ints(0, 4000, (P, R))), t(bools(0.3, P)), t(bools(0.4, P)),
                                 t(bools(0.1, P)))
    req = ints(0, 4000, (P, Rf), 0.3)
    nf_pods = NodeFitPodArrays(t(req), t(ints(0, 4000, (P, Rs), 0.3)),
                               t(req.any(axis=1) | bools(0.1, P)))
    nf_nodes = NodeFitNodeArrays(t(ints(1000, 64000, (N, Rf))), t(ints(0, 60000, (N, Rf))),
                                 t(ints(0, 110, N, 0.0)), t(np.full(N, 110, np.int64)),
                                 t(ints(1000, 64000, (N, Rs))), t(ints(0, 70000, (N, Rs))))
    static = NodeFitStatic(always_check=tuple(bool(b) for b in bools(0.5, Rf)),
                           scalar_bypass=tuple(bypass or (False,) * Rs),
                           weights=tuple(int(w) for w in rng.integers(1, 4, Rs)))
    return dict(la_pods=la_pods, nf_pods=nf_pods, la_nodes=la_nodes, nf_nodes=nf_nodes,
                valid=t(bools(0.95, N)), weights=t(rng.integers(1, 4, R).astype(np.int64)),
                static=static)


# capacities whose quotients (cap - used) * 100 / cap the boundary case
# sweeps: small, odd, just below 2**55 (the largest the score kernel's
# float estimate takes), near 2**62 / 100, and the largest whose products
# stay below 2**63 (the reference's domain: quantities times 100 fit int64)
BOUNDARY_CAPS = (1, 3, 7, 99, 100, 101, 12_345, 10**9 + 7, 2**55 - 1000, 2**55 - 1,
                 2**62 // 100 - 1, 2**62 // 100, 2**62 // 100 + 1, (2**63 - 1) // 100 - 4)


def boundary_inputs(dev, seed: int) -> dict:
    """Nodes whose quotients fall on each side of every integer step: for
    each capacity of ``BOUNDARY_CAPS`` and k in 0..100, a node whose base
    (and NodeFit requested score) puts the pods' free capacity (cap - used,
    est = q for pod q) at floor(k * cap / 100) - 4 .. + 3, so used == cap
    and used > cap come up too; the second half of the nodes puts the
    requested score itself there (MostAllocated's quotient, a request never
    below 0); a few nodes of capacity 0."""
    base = synthetic_inputs(dev, seed, 8, 2 * 101 * len(BOUNDARY_CAPS) + 4, 2, 3, 2)
    caps, free = [], []
    for cap in BOUNDARY_CAPS:
        for k in range(101):
            caps.append(cap)
            free.append(k * cap // 100 + 3)
    caps = np.array(caps * 2 + [0] * 4, dtype=np.int64)
    free = np.array(free * 2 + [0] * 4, dtype=np.int64)
    half = np.arange(caps.shape[0]) < caps.shape[0] // 2
    rot = lambda a: np.roll(a, 37)  # noqa: E731 — the second resource's steps elsewhere
    dev_t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    la_alloc = np.stack([caps, rot(caps)], axis=1)
    la_base = np.stack([caps - free, rot(caps - free)], axis=1)
    nreq = np.maximum(np.where(half[:, None], la_base, np.stack([free - 7, rot(free - 7)],
                                                                 axis=1)), 0)
    q = np.arange(8, dtype=np.int64)[:, None].repeat(2, axis=1)
    la_nodes = base["la_nodes"]._replace(alloc=dev_t(la_alloc), base_nonprod=dev_t(la_base),
                                         base_prod=dev_t(la_base + 1))
    nf_nodes = base["nf_nodes"]._replace(alloc_score=dev_t(la_alloc), req_score=dev_t(nreq))
    return dict(base, la_nodes=la_nodes, nf_nodes=nf_nodes,
                la_pods=base["la_pods"]._replace(est=dev_t(q)),
                nf_pods=base["nf_pods"]._replace(req_score=dev_t(q)))


def score_cases(dev, small=None) -> list:
    """(name, inputs) of the score kernel's edge cases: a node axis that
    is not a multiple of the block width by a pod axis that is not one of
    the strip (267 x 45, from ``small`` when given); one pod; every pair
    infeasible; the quotient boundaries; a zero request on a bypassed
    resource; widths that take the generic instantiation."""
    out = []
    if small is not None:
        out.append(("267x45", ragged(small, 267, 45)))
    out.append(("one pod", synthetic_inputs(dev, SEED, 1, 300, 2, 5, 2)))
    full = synthetic_inputs(dev, SEED + 1, 40, 200, 2, 3, 2)
    nf = full["nf_nodes"]
    out.append(("all infeasible", dict(full, nf_nodes=nf._replace(allowed_pods=nf.num_pods))))
    out.append(("boundaries", boundary_inputs(dev, SEED + 2)))
    out.append(("bypass", synthetic_inputs(dev, SEED + 3, 50, 300, 2, 3, 2,
                                           bypass=(False, True))))
    out.append(("generic 3x4x3", synthetic_inputs(dev, SEED + 4, 70, 333, 3, 4, 3,
                                                  bypass=(False, True, True))))
    out.append(("generic 1x1x1", synthetic_inputs(dev, SEED + 5, 33, 129, 1, 1, 1)))
    return out


def check_score_cases(dev, small=None) -> int:
    """The score kernel on ``score_cases`` under LeastAllocated,
    MostAllocated and both RTC shapes (one with a decreasing segment),
    without and with extra scores, against the plain ``score_batch``
    (raises ``Mismatch``); returns the cases checked."""
    from koordinator_tpu_torch.core.cycle import PluginWeights, score_batch, score_fn

    n = 0
    for name, inp in score_cases(dev, small):
        la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
        la_nodes, nf_nodes, valid, w = (inp["la_nodes"], inp["nf_nodes"], inp["valid"],
                                        inp["weights"])
        P, N = la_pods.est.shape[0], valid.shape[0]
        xsc = torch.as_tensor(np.random.default_rng(SEED + n).integers(
            -100, 201, (P, N)).astype(np.int64)).to(dev)
        for sname, static in [("least", inp["static"])] + strategy_statics(inp["static"]):
            t, f = score_batch(la_pods, la_nodes, w, nf_pods, nf_nodes, static, PluginWeights())
            f = f & valid[None, :]
            if name == "all infeasible" and f.any():
                fail("score case all infeasible: a pair is feasible")
            for extras in (None, xsc):
                got = score_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid, extras)
                require_equal(f"score case {name} {sname} extras={extras is not None}", got,
                              (t if extras is None else t + extras, f))
                n += 1
    print(f"  score: {n} edge cases (ragged, one pod, all infeasible, quotient boundaries, "
          "bypass, generic widths) x strategies x extras equal plain", flush=True)
    return n


def la_cases(dev, small=None) -> list:
    """(name, (la_pods, la_nodes, weights)) of the LoadAware strip's edge
    cases (``la_score`` and ``loadaware_score_and_filter``), made with numpy
    from fixed seeds: a ragged 267 x 45 (from ``small`` when given); one
    pod, and a pod axis that is not a multiple of the strip; the quotient
    boundaries; the generic widths R = 1 and 3; rows off the float
    estimate's range (capacities of 0 and of 2**55 or more, negative and
    huge est, negative bases); weights with a negative entry, a zero entry
    and a sum of 2**22 or more; nodes without a live NodeMetric; DaemonSet
    pods; prod-class pods on nodes with all-zero prod thresholds and on
    nodes without them; both filters off; usages whose 200 u + t wraps."""
    rng = np.random.default_rng(SEED + 60)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=a.dtype)).to(dev)

    def case(seed, P, N, R=2):
        x = synthetic_inputs(dev, seed, P, N, R, 1, 1)
        return x["la_pods"], x["la_nodes"], x["weights"]

    def host(a):
        return a.cpu().numpy().copy()

    out = []
    if small is not None:
        x = ragged(small, 267, 45)
        out.append(("267x45", (x["la_pods"], x["la_nodes"], x["weights"])))
    out.append(("one pod", case(SEED + 61, 1, 300)))
    out.append(("70x333", case(SEED + 62, 70, 333)))
    x = boundary_inputs(dev, SEED + 2)
    out.append(("boundaries", (x["la_pods"], x["la_nodes"], x["weights"])))
    out.append(("generic R=1", case(SEED + 63, 33, 129, 1)))
    out.append(("generic R=3", case(SEED + 64, 45, 200, 3)))
    # columns by j mod 8: 0 capacity 0, 1 capacity in [2**55, 2**56) with
    # bases below it, 2 negative non-prod bases, 3 negative prod bases;
    # pods by q mod 5: 1 negative est; pod 7 an est of 2**58
    pods, nodes, w = case(SEED + 65, 40, 280)
    col = (np.arange(280) % 8)[:, None]
    big = rng.integers(2**55, 2**56, (280, 2))
    frac = rng.random((280, 2))
    alloc = np.where(col == 0, 0, np.where(col == 1, big, host(nodes.alloc)))
    bnp = np.where(col == 1, (big * frac).astype(np.int64), host(nodes.base_nonprod))
    bp = np.where(col == 1, (big * frac * 0.9).astype(np.int64), host(nodes.base_prod))
    bnp = np.where(col == 2, -rng.integers(1, 20000, (280, 2)), bnp)
    bp = np.where(col == 3, -rng.integers(1, 20000, (280, 2)), bp)
    est = np.where((np.arange(40) % 5 == 1)[:, None], -rng.integers(1, 5000, (40, 2)),
                   host(pods.est))
    est[7] = (2**58, 3)
    out.append(("off the estimate's range", (
        pods._replace(est=t(est), is_prod_score=t(np.arange(40) % 2 == 0)),
        nodes._replace(alloc=t(alloc), base_nonprod=t(bnp), base_prod=t(bp)), w)))
    pods, nodes, _ = case(SEED + 66, 40, 300)
    for name, wv in (("negative", [-1, 3]), ("zero", [0, 3]), ("2**22", [2**21, 2**21 + 3])):
        out.append((f"weights {name}", (pods, nodes, t(np.array(wv, dtype=np.int64)))))
    pods, nodes, w = case(SEED + 67, 40, 300)
    out.append(("no live NodeMetric", (pods, nodes._replace(
        score_valid=t(np.arange(300) % 3 == 0)), w)))
    out.append(("DaemonSet pods", (pods._replace(is_daemonset=t(np.arange(40) % 2 == 0)), nodes,
                                   w)))
    has = np.arange(300) % 2 == 0
    prod_thr = host(nodes.prod_thresholds)
    prod_thr[has] = 0
    on = np.ones(300, dtype=bool)
    out.append(("prod class, zero prod thresholds", (
        pods._replace(is_prod_class=t(np.arange(40) % 2 == 0)),
        nodes._replace(has_prod_thresholds=t(has), prod_thresholds=t(prod_thr),
                       filter_active=t(on), prod_filter_active=t(on)), w)))
    out.append(("filters off", (pods, nodes._replace(filter_active=t(~on),
                                                     prod_filter_active=t(~on)), w)))
    # usages of 2**56 and more on even columns: 200 u wraps past 2**63
    pods, nodes, w = case(SEED + 68, 40, 300)
    wide = (np.arange(300) % 2 == 0)[:, None]
    out.append(("200u + t wraps", (pods._replace(is_prod_class=t(np.arange(40) % 3 == 0)),
                                   nodes._replace(
        filter_usage=t(np.where(wide, rng.integers(2**56, 2**62, (300, 2)),
                                host(nodes.filter_usage))),
        prod_usage=t(np.where(wide, rng.integers(2**56, 2**62, (300, 2)),
                              host(nodes.prod_usage))),
        thresholds=t(rng.integers(1, 100, (300, 2))),
        prod_thresholds=t(rng.integers(1, 100, (300, 2))),
        filter_active=t(on), prod_filter_active=t(on)), w)))
    return out


def check_la_cases(dev, small=None) -> int:
    """``la_score`` and ``loadaware_score_and_filter`` on ``la_cases``, each
    against ``loadaware_score_plain`` and ``loadaware_filter`` exactly
    (raises ``Mismatch``); returns the cases checked.  Fails where a case
    does not build what it names (a negative score under a negative
    weight, every pair feasible with the filters off)."""
    from koordinator_tpu_torch.core import loadaware as la

    n = 0
    for name, (pods, nodes, w) in la_cases(dev, small):
        P, N = pods.est.shape[0], nodes.alloc.shape[0]
        score, feasible = la.loadaware_score_plain(pods, nodes, w), la.loadaware_filter(pods, nodes)
        require_equal(f"la case {name} ({P}x{N}): la_score", (la.loadaware_score(pods, nodes, w),),
                      (score,))
        require_equal(f"la case {name} ({P}x{N}): loadaware_score_and_filter",
                      la.loadaware_score_and_filter(pods, nodes, w), (score, feasible))
        if name == "weights negative" and not bool((score < 0).any()):
            fail("la case weights negative: no negative score")
        if name == "filters off" and not bool(feasible.all()):
            fail("la case filters off: a pair is infeasible")
        n += 1
    print(f"  la_score and loadaware_score_and_filter: {n} edge cases equal plain", flush=True)
    return n


# ------------------------------------------------ the division repairs

# LoadAware and NodeFit weights whose int64 sum wraps to 1
WRAP_WEIGHTS = (2**63 - 1, 2**63 - 1, 3)


def repair_cases(dev) -> list:
    """(name, inputs) of the floored divisions' and the weight sums'
    repairs: full input dicts (the queue in pod order, every pod real) of 40
    pods x 300 nodes made with numpy from fixed seeds.  "la weights
    negative": LoadAware weights [-1, 3]; "nf weights negative": NodeFit
    weights (-1, 3); "requests negative": every third pod's scoring
    requests below minus any node's requested score, so req_score +
    nreq_score < 0 on every column (MostAllocated's req * 100 < 0); "weights
    wrap": LoadAware weights ``WRAP_WEIGHTS`` at R = 3 and NodeFit's the
    same at Rs = 3, whose int64 sums wrap to 1."""
    import dataclasses

    rng = np.random.default_rng(SEED + 80)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    def queued(x):
        # the constraint inputs (con_inputs_for) read the filter axis' names
        P = x["la_pods"].est.shape[0]
        return dict(x, order=torch.arange(P, device=dev), p_real=P,
                    state=types.SimpleNamespace(axis=("cpu", "memory", "ephemeral-storage")))

    out = []
    x = synthetic_inputs(dev, SEED + 81, 40, 300, 2, 3, 2)
    out.append(("la weights negative", queued(dict(x, weights=t(np.array([-1, 3], np.int64))))))
    x = synthetic_inputs(dev, SEED + 82, 40, 300, 2, 3, 2)
    out.append(("nf weights negative",
                queued(dict(x, static=dataclasses.replace(x["static"], weights=(-1, 3))))))
    x = synthetic_inputs(dev, SEED + 83, 40, 300, 2, 3, 2)
    rs = x["nf_pods"].req_score.cpu().numpy().copy()
    neg = np.arange(40) % 3 == 1
    rs[neg] = -rng.integers(70_001, 200_000, (int(neg.sum()), 2))
    out.append(("requests negative",
                queued(dict(x, nf_pods=x["nf_pods"]._replace(req_score=t(rs))))))
    x = synthetic_inputs(dev, SEED + 84, 40, 300, 3, 3, 3)
    out.append(("weights wrap", queued(dict(
        x, weights=t(np.array(WRAP_WEIGHTS, dtype=np.int64)),
        static=dataclasses.replace(x["static"], weights=WRAP_WEIGHTS)))))
    return out


def repair_property(name: str, inp) -> None:
    """Fail unless a repair case builds what it names: a negative LoadAware
    score, a negative NodeFit score, a negative request total and a
    negative MostAllocated score, weight sums that wrap to 1."""
    from koordinator_tpu_torch.core import loadaware as la
    from koordinator_tpu_torch.core import nodefit as nf

    statics = [inp["static"]] + [s for _, s in strategy_statics(inp["static"])]
    if name == "la weights negative" and not bool(
            (la.loadaware_score_plain(inp["la_pods"], inp["la_nodes"], inp["weights"]) < 0).any()):
        fail("repair case la weights negative: no negative LoadAware score")
    if name == "nf weights negative" and not any(
            bool((nf.nodefit_score_plain(inp["nf_pods"], inp["nf_nodes"], s) < 0).any())
            for s in statics):
        fail("repair case nf weights negative: no negative NodeFit score")
    if name == "requests negative":
        tot = inp["nf_pods"].req_score[:, None, :] + inp["nf_nodes"].req_score[None]
        most = nf.nodefit_score_plain(inp["nf_pods"], inp["nf_nodes"], statics[1])
        if not (bool((tot < 0).any()) and bool((most < 0).any())):
            fail("repair case requests negative: no negative total with a negative "
                 "MostAllocated score")
    if name == "weights wrap" and not (
            int(inp["weights"].sum()) == 1
            and int(torch.tensor(inp["static"].weights, dtype=torch.int64).sum()) == 1):
        fail("repair case weights wrap: the weight sums do not wrap to 1")


def repair_checks(name: str, inp) -> list:
    """(kernels, check) of one repair case: each check runs its kernels on
    the case under LeastAllocated, MostAllocated and both RTC shapes where
    they take them, against their plain versions (raises ``Mismatch``):
    ``score``; ``shard_score_map`` over two column blocks; ``nf_score``; the
    key build and the round loop (``check_kernels``, LeastAllocated); every
    key build (``check_key_builds``: MostAllocated and RTC, plain and
    constrained, both key lanes); the scan (both plain routes, both layers;
    under the wrapping weights, whose totals leave the keys' range, its own
    plain route and both layers); ``sched_refresh`` plain and
    constrained."""
    from koordinator_tpu_torch.core import nodefit as nf
    from koordinator_tpu_torch.core.cycle import PluginWeights, score_batch, score_fn
    from koordinator_tpu_torch.service import sharding as sh

    la_pods, nf_pods, la_nodes, nf_nodes, valid, w = (
        inp["la_pods"], inp["nf_pods"], inp["la_nodes"], inp["nf_nodes"], inp["valid"],
        inp["weights"])
    statics = [("least", inp["static"])] + strategy_statics(inp["static"])
    P, N, dev = la_pods.est.shape[0], valid.shape[0], valid.device
    tag = f"repair case {name}"

    def score():
        for sname, static in statics:
            t, f = score_batch(la_pods, la_nodes, w, nf_pods, nf_nodes, static, PluginWeights())
            require_equal(f"{tag}: score {sname}",
                          score_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid),
                          (t, f & valid[None, :]))

    def shard():
        for sname, static in statics:
            for lo, hi in ((100, 200), (37, 90)):
                got, want = sentinel_buffers(P, N, dev), sentinel_buffers(P, N, dev)
                sh.shard_score_map(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid, None,
                                   lo, hi, *got)
                sh.shard_score_map_plain(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid,
                                         None, lo, hi, *want)
                require_equal(f"{tag}: shard_score_map {sname} [{lo}, {hi})", got, want)

    def nf_score():
        for sname, static in statics:
            require_equal(f"{tag}: nf_score {sname}",
                          (nf.nodefit_score(nf_pods, nf_nodes, static),),
                          (nf.nodefit_score_plain(nf_pods, nf_nodes, static),))

    def scan():
        for sname, static in statics:
            if name != "weights wrap":
                check_scan_kernels(inp, static, False, "salted", False, False, what=f" ({tag})")
                continue
            # totals near 2**63 leave the keys' range (score * TB wraps), so
            # the plain scan over totals is no reference: the kernel against
            # its own plain route, and layer by layer
            case = scan_case(inp, static, False, "salted", False)
            require_equal(f"{tag}: scan {sname} against the plain route", case["kernel"](),
                          case["steps"]())
            case["layers"](f"{tag}: scan {sname}")

    def refresh():
        for con in (False, True):
            check_refresh_case(inp, con, False, 16)

    return [("score", score), ("shard_score_map", shard), ("nf_score", nf_score),
            ("schedule_keys, schedule_rounds", lambda: check_kernels(inp, 16, timed=False)),
            ("key builds", lambda: check_key_builds(inp, False)), ("scan", scan),
            ("sched_refresh", refresh)]


def check_repair_cases(dev) -> int:
    """Every ``repair_cases`` case through every kernel of ``repair_checks``,
    each equal to its plain version, after its ``repair_property`` (raises
    ``Mismatch``); returns the checks run."""
    n = 0
    for name, inp in repair_cases(dev):
        repair_property(name, inp)
        for _, check in repair_checks(name, inp):
            check()
            n += 1
    print(f"  the division repairs: {n} checks (negative LoadAware and NodeFit weights, negative "
          "request totals, wrapping weight sums through score, shard_score_map, nf_score, the "
          "key builds, the round loop, the scan and sched_refresh) equal plain", flush=True)
    return n


def repair_case_faults(dev) -> dict:
    """``check_repair_cases`` check by check, a mismatch recorded instead of
    raised: case and kernels -> the mismatch's message (its first
    differing indices)."""
    out = {}
    for name, inp in repair_cases(dev):
        for kernels, check in repair_checks(name, inp):
            try:
                check()
            except Mismatch as e:
                out[f"{name}: {kernels}"] = str(e)
    return out


# ------------------------------------------------- the NodeFit strip

def nf_cases(dev, small=None) -> list:
    """(name, (nf_pods, nf_nodes, static)) of the NodeFit strip's edge cases
    (``nf_score``), made with numpy from fixed seeds: a ragged 267 x 45
    (from ``small`` when given); one pod; a pod axis that is not a multiple
    of the strip (70 x 333); the quotient boundaries; Rs = 3 and 5 and the
    generic widths 1 and 8; rows off the float estimate's range (capacities
    of 0 and of 2**55 or more, negative requested scores, negative and huge
    requests); negative, zero, all-zero, 2**22 and large-sum weights; the
    wrapping weights at Rs = 3; bypassed resources with zero requests."""
    import dataclasses

    rng = np.random.default_rng(SEED + 90)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=a.dtype)).to(dev)

    def case(seed, P, N, Rs=2, bypass=None):
        x = synthetic_inputs(dev, seed, P, N, 2, 1, Rs, bypass=bypass)
        return x["nf_pods"], x["nf_nodes"], x["static"]

    def weighted(c, wv):
        return c[0], c[1], dataclasses.replace(c[2], weights=tuple(wv))

    out = []
    if small is not None:
        x = ragged(small, 267, 45)
        out.append(("267x45", (x["nf_pods"], x["nf_nodes"], x["static"])))
    out.append(("one pod", case(SEED + 91, 1, 300)))
    out.append(("70x333", case(SEED + 92, 70, 333)))
    x = boundary_inputs(dev, SEED + 2)
    out.append(("boundaries", (x["nf_pods"], x["nf_nodes"], x["static"])))
    out.append(("Rs=3", case(SEED + 93, 45, 200, 3)))
    out.append(("Rs=5", case(SEED + 94, 45, 200, 5, bypass=(False, False, True, True, False))))
    out.append(("generic Rs=1", case(SEED + 95, 33, 129, 1)))
    out.append(("generic Rs=8", case(SEED + 96, 33, 129, 8, bypass=(False, True) * 4)))
    # columns by j mod 8: 0 capacity 0, 1 capacity in [2**55, 2**56) with
    # requested scores below it, 2 negative requested scores; pods by q mod
    # 5: 1 negative requests; pod 7 a request of 2**58
    pods, nodes, static = case(SEED + 97, 40, 280)
    col = (np.arange(280) % 8)[:, None]
    big = rng.integers(2**55, 2**56, (280, 2))
    alloc = np.where(col == 0, 0, np.where(col == 1, big, nodes.alloc_score.cpu().numpy()))
    nreq = np.where(col == 1, (big * rng.random((280, 2))).astype(np.int64),
                    nodes.req_score.cpu().numpy())
    nreq = np.where(col == 2, -rng.integers(1, 20000, (280, 2)), nreq)
    req = np.where((np.arange(40) % 5 == 1)[:, None], -rng.integers(1, 5000, (40, 2)),
                   pods.req_score.cpu().numpy())
    req[7] = (2**58, 3)
    out.append(("off the estimate's range", (pods._replace(req_score=t(req)),
                                             nodes._replace(alloc_score=t(alloc),
                                                            req_score=t(nreq)), static)))
    base = case(SEED + 98, 40, 300)
    for name, wv in (("negative", (-1, 3)), ("zero", (0, 3)), ("all zero", (0, 0)),
                     ("2**22", (2**22, 1)), ("sum 2**22", (2**21, 2**21 + 3))):
        out.append((f"weights {name}", weighted(base, wv)))
    out.append(("weights wrap", weighted(case(SEED + 99, 40, 300, 3), WRAP_WEIGHTS)))
    out.append(("bypass, zero requests", case(SEED + 100, 50, 300, 2, bypass=(True, True))))
    return out


def nf_case_statics(static) -> list:
    """The four strategy shapes a NodeFit case runs under."""
    return [("least", static)] + strategy_statics(static)


def check_nf_cases(dev, small=None) -> int:
    """``nf_score`` on ``nf_cases`` under LeastAllocated, MostAllocated and
    both RTC shapes, each against ``nodefit_score_plain`` exactly (raises
    ``Mismatch``); returns the calls checked.  Fails where a case does not
    build what it names (a negative score under a negative weight, a
    bypassed resource with a zero request)."""
    from koordinator_tpu_torch.core import nodefit as nf

    n = 0
    for name, (pods, nodes, static) in nf_cases(dev, small):
        P, N = pods.req.shape[0], nodes.alloc.shape[0]
        neg = False
        for sname, st in nf_case_statics(static):
            want = nf.nodefit_score_plain(pods, nodes, st)
            require_equal(f"nf case {name} {sname} ({P}x{N})", (nf.nodefit_score(pods, nodes, st),),
                          (want,))
            neg = neg or bool((want < 0).any())
            n += 1
        if name == "weights negative" and not neg:
            fail("nf case weights negative: no negative score")
        if name.startswith("bypass") and not bool((pods.req_score == 0).any()):
            fail("nf case bypass: no zero request")
    print(f"  nf_score: {n} edge cases x strategies equal plain", flush=True)
    return n


def nf_case_faults(dev, small) -> dict:
    """``check_nf_cases`` call by call, a mismatch recorded instead of
    raised: case and strategy -> the mismatch's message."""
    from koordinator_tpu_torch.core import nodefit as nf

    out = {}
    for name, (pods, nodes, static) in nf_cases(dev, small):
        for sname, st in nf_case_statics(static):
            try:
                require_equal(f"nf case {name} {sname}", (nf.nodefit_score(pods, nodes, st),),
                              (nf.nodefit_score_plain(pods, nodes, st),))
            except Mismatch as e:
                out[f"{name}: {sname}"] = str(e)
    return out


# ------------------------------------------- the device feasibility

def dev_sigs_for(pl, sigs, dev):
    """``sigs`` (host ``DeviceSigs``) as ``pl.dev_feasible`` takes them: on
    the host (a tree with ``DeviceStage``), else on the rows' device."""
    if hasattr(pl, "DeviceStage"):
        return sigs
    return pl.DeviceSigs(*(t.to(dev) for t in sigs))


def dev_cases(dev) -> list:
    """(name, (core, mem, full, vfs, sigs)) of the device feasibility's
    edge cases, from ``device_inputs`` and fixed seeds: Gm = 1, 8, 16 and 6
    (not a multiple of 4); M = 0, M = 1 and M = 200, above the launch
    parameters' 128; N = 0 and N = 333 (not a multiple of the block's 128);
    every signature an invalid whole-GPU count; RDMA-only signatures; nodes
    with every slot padded (-1)."""
    out = []
    for gm in (1, 8, 16, 6):
        out.append((f"Gm={gm}", device_inputs(dev, 16, 333, gm, SEED + 100 + gm)[0]))
    core, mem, full, vfs, sigs = device_inputs(dev, 200, 500, 8, SEED + 110)[0]
    out.append(("M=200", (core, mem, full, vfs, sigs)))
    out.append(("M=1", (core, mem, full, vfs, type(sigs)(*(s[:1] for s in sigs)))))
    out.append(("M=0", (core, mem, full, vfs, type(sigs)(*(s[:0] for s in sigs)))))
    out.append(("N=0", (core[:0], mem[:0], full[:0], vfs[:0], sigs)))
    M = 16
    on, off = torch.ones(M, dtype=torch.bool), torch.zeros(M, dtype=torch.bool)
    i32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32))  # noqa: E731
    out.append(("invalid counts", (core, mem, full, vfs, type(sigs)(
        on, on, i32(np.arange(M) % 4 + 1), i32(np.zeros(M)), i32(np.zeros(M)),
        i32(np.zeros(M)), off))))
    out.append(("RDMA only", (core, mem, full, vfs, type(sigs)(
        off, off, i32(np.zeros(M)), i32(np.zeros(M)), i32(np.zeros(M)),
        i32(np.arange(M) % 18), on))))
    sig16 = device_inputs(dev, M, 500, 8, SEED + 111)[0][4]
    pad = torch.full_like(core, -1)
    out.append(("every slot padded", (pad, pad.clone(), torch.zeros_like(full), vfs, sig16)))
    return out


def dev_fault_cases(pl, dev, Gm: int = 8, N: int = 333) -> dict:
    """The device rows' binding on ``pl``'s tree: "strided rows" — core as
    a column slice of a wider table ("refused" when ``dev_feasible`` raises
    ``ValueError``, else "equal" or "differs" against the plain version on
    a contiguous copy); "moved row" — ``dev_feasible`` on the rows, then on
    the same tensors after core moved to new storage with new values
    (``set_``): "equal" when the second call equals the plain version on the
    new values, else "differs"."""
    core, mem, full, vfs, sigs = device_inputs(dev, 16, N, Gm, SEED + 112)[0]
    s = dev_sigs_for(pl, sigs, dev)
    out = {}
    wide = torch.cat([core, core], dim=1)[:, :Gm]
    try:
        got = pl.dev_feasible(wide, mem, full, vfs, s)
        out["strided rows"] = "equal" if torch.equal(
            got, pl.dev_feasible_plain(wide.contiguous(), mem, full, vfs, s)) else "differs"
    except ValueError:
        out["strided rows"] = "refused"
    pl.dev_feasible(core, mem, full, vfs, s)
    moved = torch.where(core >= 0, 100 - core, core).contiguous()
    core.set_(moved.untyped_storage(), 0, moved.shape, moved.stride())
    got = pl.dev_feasible(core, mem, full, vfs, s)
    out["moved row"] = "equal" if torch.equal(
        got, pl.dev_feasible_plain(moved.clone(), mem, full, vfs, s)) else "differs"
    return out


def ds_cases(dev) -> list:
    """(name, (alloc2, used2, req)) of ``ds_score``'s edge cases, made with
    numpy from fixed seeds at 333 nodes (not a multiple of the block's 128)
    and 24 requests (core percent, memory ratio): a capacity of 0 in one
    dimension; requests of 0 in one dimension and in both; used above the
    capacity (the clamp); negative used (the floor of a negative total);
    negative capacities; totals past 2**31 / 100 and capacities past 2**31
    (the general path), products that wrap; rows at an 8-byte offset (the
    generic instantiation); M = 0, N = 0."""
    rng = np.random.default_rng(SEED + 120)
    N, M = 333, 24
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)  # noqa: E731
    ng = rng.integers(0, 9, N)
    alloc = np.repeat((100 * ng)[:, None], 2, axis=1)
    used = np.minimum(alloc, rng.integers(0, 800, (N, 2)))
    req = np.array([[(100, 100), (50, 50), (400, 400), (30, 60), (0, 40), (70, 0)][m % 6]
                    for m in range(M)])
    out = []
    one = alloc.copy()
    one[::2, 0], one[1::2, 1] = 0, 0
    out.append(("capacity 0 in one dimension", (one, used, req)))
    zero = req.copy()
    zero[::3], zero[1::3, 0], zero[2::3, 1] = 0, 0, 0
    out.append(("requests of 0", (alloc, used, zero)))
    out.append(("used above capacity", (alloc, alloc + rng.integers(1, 500, (N, 2)), req)))
    neg = -rng.integers(1, 1000, (N, 2))
    out.append(("negative used", (alloc, neg, req + np.array([[0, 0], [-700, 3]] * (M // 2)))))
    out.append(("negative capacity", (-alloc - 1, used, req)))
    big = rng.integers(2 ** 31 // 100, 2 ** 40, (N, 2))
    big[::5] = rng.integers(2 ** 31, 2 ** 62, (len(big[::5]), 2))
    big[1::7] = rng.integers(2 ** 61, 2 ** 62, (len(big[1::7]), 2))
    bused = np.maximum(big - rng.integers(0, 1 << 20, (N, 2)), 0)  # totals past 2**63 / 100 wrap
    out.append(("totals past 2**31 / 100", (big, bused, req * 1000)))
    out.append(("unaligned rows", (alloc, used, req)))
    out.append(("M=0", (alloc, used, req[:0])))
    out.append(("N=0", (alloc[:0], used[:0], req)))
    cases = []
    for name, (a, u, r) in out:
        a2, u2 = T(a), T(u)
        if name == "unaligned rows":
            # each row one int64 past a 16-byte boundary
            flat = torch.empty(2 * a.size + 3, dtype=torch.int64, device=dev)
            a2, u2 = flat[1:1 + a.size].view(-1, 2), flat[3 + a.size:].view(-1, 2)
            a2.copy_(T(a))
            u2.copy_(T(u))
        cases.append((name, (a2, u2, T(r))))
    return cases


def check_ds_cases(dev) -> int:
    """``ds_score`` on ``ds_cases`` through the public entry point and
    through a ``DeviceStage`` over the aggregates alone at weights 1, 7
    and -3, each against ``ds_score_plain`` (times the weight) exactly;
    then a request block on the card refused before any launch (raises
    ``Mismatch``); returns the cases checked.  Fails where a case does not
    build what it names."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import placement as pl

    n = 0
    for name, (alloc2, used2, req) in ds_cases(dev):
        want = pl.ds_score_plain(req, alloc2, used2)
        require_equal(f"ds case {name}", (pl.ds_score(req, alloc2, used2),), (want,))
        stage = pl.DeviceStage()
        stage.bind((None,) * 4 + (alloc2, used2))
        block = np.ascontiguousarray(req.cpu().numpy())
        for w in (1, 7, -3):
            require_equal(f"ds case {name} weight {w}", (stage.score(block, w),), (want * w,))
        aligned = ((alloc2.data_ptr() | used2.data_ptr()) & 15) == 0
        if (name == "unaligned rows") == aligned and alloc2.numel():
            fail(f"ds case {name}: rows {'' if aligned else 'not '}16-byte aligned")
        if name == "totals past 2**31 / 100" and not bool((alloc2 >= 2 ** 31).any()):
            fail("ds case totals past 2**31 / 100: no capacity past 2**31")
        n += 1
    if dev.type == "cuda":
        alloc2, used2, req = ds_cases(dev)[0][1]
        stage = pl.DeviceStage()
        stage.bind((None,) * 4 + (alloc2, used2))
        before = cuda.KERNELS["ds_score"].launches
        try:
            stage.score(req, 1)
            fail("ds_score took requests on the card")
        except ValueError:
            pass
        if cuda.KERNELS["ds_score"].launches != before:
            fail("ds_score launched before refusing requests on the card")
    print(f"  ds_score: {n} edge cases (a capacity of 0, requests of 0, used above capacity, "
          "negative used and capacities, totals past 2**31 / 100, unaligned rows, M 0, N 0) "
          "equal plain at weights 1, 7, -3; requests on the card refused", flush=True)
    return n


def check_dev_cases(dev) -> int:
    """``dev_feasible`` on ``dev_cases``, each against
    ``dev_feasible_plain`` exactly, then ``dev_fault_cases`` (strided rows
    refused, a moved row rebound) and a signature tensor on the card
    refused before any launch, then ``ds_score``'s (``check_ds_cases``;
    raises ``Mismatch``); returns the ``dev_feasible`` cases checked.
    Fails where a case does not build what it names."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import placement as pl

    n = 0
    for name, (core, mem, full, vfs, sigs) in dev_cases(dev):
        want = pl.dev_feasible_plain(core, mem, full, vfs, sigs)
        require_equal(f"dev case {name}", (pl.dev_feasible(core, mem, full, vfs, sigs),), (want,))
        if name == "invalid counts" and bool(want.any()):
            fail("dev case invalid counts: a pair is feasible")
        if name == "RDMA only" and not (bool(want.any()) and not bool(want.all())):
            fail("dev case RDMA only: the VF totals decide nothing")
        if name == "every slot padded" and bool(want[~sigs.is_multi & sigs.has_gpu].any()):
            fail("dev case every slot padded: a partial share passes")
        if name == "M=200" and sigs.has_gpu.shape[0] <= cuda.DEV_SIG_CAP:
            fail("dev case M=200: not above the launch parameters' cap")
        n += 1
    faults = dev_fault_cases(pl, dev)
    if faults != {"strided rows": "refused", "moved row": "equal"}:
        fail(f"dev_feasible's rows: {faults}")
    if dev.type == "cuda":
        core, mem, full, vfs, sigs = device_inputs(dev, 4, 50, 8, SEED + 113)[0]
        before = cuda.KERNELS["dev_feasible"].launches
        try:
            pl.dev_feasible(core, mem, full, vfs, type(sigs)(*(t.to(dev) for t in sigs)))
            fail("dev_feasible took signatures on the card")
        except ValueError:
            pass
        if cuda.KERNELS["dev_feasible"].launches != before:
            fail("dev_feasible launched before refusing signatures on the card")
    print(f"  dev_feasible: {n} edge cases (Gm 1, 6, 8, 16; M 0, 1, 200; N 0, 333; invalid "
          "counts; RDMA only; every slot padded) equal plain; strided rows refused, a moved "
          "row rebound, signatures on the card refused", flush=True)
    check_ds_cases(dev)
    return n


def dev_case_faults(dev) -> dict:
    """``check_dev_cases`` case by case on the imported tree, a mismatch
    recorded instead of raised, and ``dev_fault_cases``' outcomes."""
    from koordinator_tpu_torch.core import placement as pl

    out = {}
    for name, (core, mem, full, vfs, sigs) in dev_cases(dev):
        s = dev_sigs_for(pl, sigs, dev)
        try:
            require_equal(f"dev case {name}", (pl.dev_feasible(core, mem, full, vfs, s),),
                          (pl.dev_feasible_plain(core, mem, full, vfs, s),))
        except (Mismatch, RuntimeError, ValueError) as e:
            out[name] = str(e)
    out.update(dev_fault_cases(pl, dev))
    return out


def scan_extras(inp, seed: int):
    """A placement-and-devices mask (about 90% open) and extra scores in
    [-100, 200] (negative like an amplified-CPU delta) at [P, N]."""
    from koordinator_tpu_torch import convert

    P, N = inp["la_pods"].est.shape[0], inp["valid"].shape[0]
    rng = np.random.default_rng(seed)
    dev = inp["valid"].device
    return (convert.tensor(rng.random((P, N)) < 0.9, dev),
            convert.tensor(rng.integers(-100, 201, (P, N)).astype(np.int64), dev))


def scan_case(inp, static, con: bool, tie: str, extras, cpd: int = 0,
              block_size: int = 16) -> dict:
    """One scan check's calls on ``inp``: ``kernel`` (``scan_fn``),
    ``plain`` (the plain ``schedule_batch``) and ``steps`` (``scan_fn``'s
    plain route on the same tensors: ``build_keys_plain`` on the int64 lane,
    then ``scan_steps_plain``) on the same submission-order inputs, and
    ``layers``: the two launches on their own (the key build's fresh M and
    Mb against ``build_keys_plain``'s, then the step kernel on them against
    ``scan_steps_plain`` on the plain keys: hosts, scores and the updated M
    and Mb); the input tensors a run must leave untouched, and what the
    bound counts.  ``extras``: False, True (``scan_extras``) or a (mask,
    scores) pair."""
    from koordinator_tpu_torch.core import reservation as tr
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.core import cycle
    from koordinator_tpu_torch.core.cycle import (
        PluginWeights,
        ReservationInputs,
        scan_fn,
        schedule_batch,
    )

    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    la_nodes, nf_nodes, valid, w = inp["la_nodes"], inp["nf_nodes"], inp["valid"], inp["weights"]
    P, N = la_pods.est.shape[0], valid.shape[0]
    AD = 8
    p_real, order = inp["p_real"], inp["order"]
    con_args, kw, quota, rsv = None, {}, None, None
    if con:
        gangs, quota, rsv, matched, midx, rank = con_inputs_for(inp, SEED + 41)
        req = nf_pods.req
        r = ReservationInputs(rsv=rsv, matched=matched, rscore=tr.rsv_rscore(req, rsv),
                              scores=tr.rsv_score(req, matched, N, rsv, rank))
        con_args = dict(gang=gangs, quota=quota, reservation=r, rsv_midx=midx, rsv_rank=rank)
        kw = dict(gang=gangs, quota=quota, reservation=r)
    xf, xsc = extras if isinstance(extras, tuple) else (
        scan_extras(inp, SEED + 42) if extras else (None, None))
    base = (torch.arange(P, device=valid.device) < p_real)[:, None] & valid[None, :]
    if xf is not None:
        base = base & xf

    def kernel():
        return scan_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid, p_real, order,
                       con_args, cpd, AD, xf, xsc, tie, block_size)

    def plain():
        return schedule_batch(la_pods, la_nodes, w, nf_pods, nf_nodes, static, PluginWeights(),
                              base, order, check_parent_depth=cpd, ancestor_depth=AD,
                              tie_break=tie, extra_scores=xsc, **kw)

    def queue():
        xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(la_pods, nf_pods, valid, p_real, order,
                                                        tie)
        c = None if con_args is None else rs.con_inputs(xs, **con_args)
        xin = rs.extra_inputs(xf, xsc, xs)
        return xs, q_la, q_nf, salts, pod_ok, c, xin

    def plain_keys(q_la, q_nf, salts, pod_ok, c, xin):
        q_extra, q_xsc = rs._q_extras(xin, pod_ok[:, None] & valid[None, :])
        if c is not None:
            q_extra = q_extra & rs.gang_pass(c)[:, None]
        return rs.build_keys_plain(q_la, la_nodes, w, q_nf, nf_nodes, static, PluginWeights(),
                                   q_extra, salts, block_size, rs._queue_rsv(c) if c else None,
                                   q_xsc, torch.int64)[:2]

    def steps():
        xs, q_la, q_nf, salts, pod_ok, c, xin = queue()
        M, Mb = plain_keys(q_la, q_nf, salts, pod_ok, c, xin)
        h, sc = cycle.scan_steps_plain(M, Mb, q_la, la_nodes, w, q_nf, nf_nodes, static, valid,
                                       pod_ok, salts, block_size, c, cpd, AD, xin)
        return rs._submission_order(h, sc, xs, P)

    def layers(what: str):
        xs, q_la, q_nf, salts, pod_ok, c, xin = queue()
        M, Mb, feas = rs.schedule_keys(q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok,
                                       salts, block_size, c, xin, wide=True, la_feas=False)
        Mp, Mbp = plain_keys(q_la, q_nf, salts, pod_ok, c, xin)
        require_equal(f"{what}: the key build's M, Mb", (M, Mb), (Mp, Mbp))
        if feas is not None:
            fail(f"{what}: the scan's key build wrote the LoadAware filter")
        got = cycle.scan_steps(M, Mb, q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok,
                               salts, block_size, c, cpd, AD, xin)
        want = cycle.scan_steps_plain(Mp, Mbp, q_la, la_nodes, w, q_nf, nf_nodes, static, valid,
                                      pod_ok, salts, block_size, c, cpd, AD, xin)
        return require_equal(f"{what}: the step kernel's hosts, scores, M, Mb", (*got, M, Mb),
                             (*want, Mp, Mbp))

    def rescored(hosts) -> int:
        """The (placed pod, later pod) pairs whose key the steps rescore:
        for each pod placed (``hosts`` in submission order), the pods after
        it in queue order that pass the pod mask (and the gang prefilter)."""
        xs, _, _, _, pod_ok, c, _ = queue()
        ok = (pod_ok & rs.gang_pass(c) if c is not None else pod_ok).long()
        after = ok.flip(0).cumsum(0).flip(0) - ok
        return int(after[hosts[xs] >= 0].sum())

    inputs = [*la_nodes, *nf_nodes] + ([quota.used, quota.npu, rsv.allocated] if con else [])
    in_b = nbytes(*la_pods, *nf_pods, *la_nodes, *nf_nodes, valid)
    if xf is not None:
        in_b += nbytes(xf, xsc)
    if con:
        in_b += nbytes(con_args["reservation"].scores, *rsv, midx, *quota.pods, *quota[1:])
    return dict(kernel=kernel, plain=plain, steps=steps, layers=layers, rescored=rescored,
                inputs=inputs, in_bytes=in_b, tag=f"scan{'_con' if con else ''} {static.strategy} {tie}"
                                   f"{' extras' if xf is not None else ''}")


def check_scan_kernels(inp, static, con: bool, tie: str, extras, timed: bool, cpd: int = 0,
                       block_size: int = 16, both: bool = True, what: str = ""):
    """The scan (the int64 key build and the step kernel, ``scan_con`` with
    gang, quota and reservation inputs) through ``scan_fn`` against the
    plain ``schedule_batch`` and, with ``both``, against ``scan_fn``'s
    plain route (``build_keys_plain`` + ``scan_steps_plain``) and layer by
    layer (``scan_case``'s ``layers``), on the same submission-order inputs
    (raises ``Mismatch``); the node, quota and reservation inputs must be
    left untouched.  Returns the kernel record when ``timed``: events
    around ``scan_fn``, the key build's and the step kernel's device times
    (``torch.profiler``), the bound of each."""
    la_pods, nf_pods, valid = inp["la_pods"], inp["nf_pods"], inp["valid"]
    P, N = la_pods.est.shape[0], valid.shape[0]
    R, Rf, Rs = la_pods.est.shape[1], nf_pods.req.shape[1], nf_pods.req_score.shape[1]
    p_real = inp["p_real"]
    case = scan_case(inp, static, con, tie, extras, cpd, block_size)
    kernel, plain, tag = case["kernel"], case["plain"], case["tag"] + what
    state0 = [t.clone() for t in case["inputs"]]
    got, want = kernel(), plain()
    err = require_equal(f"{tag} {P}x{N}", got, want)
    steps_ms = None
    if both:
        t0 = time.perf_counter()
        steps = case["steps"]()
        if valid.device.type == "cuda":
            torch.cuda.synchronize()
        steps_ms = (time.perf_counter() - t0) * 1e3  # the plain route, one run
        require_equal(f"{tag} {P}x{N}: the plain route", got, steps)
        case["layers"](f"{tag} {P}x{N}")
    if not all(torch.equal(a, b) for a, b in zip(case["inputs"], state0)):
        fail(f"{tag}: the kernel wrote its inputs")
    placed = int((want[0] >= 0).sum())
    if not what and (placed == 0 or (con and placed == p_real)):
        fail(f"{tag}: {placed} of {p_real} placed: the check exercises too little")
    print(f"  {P} pods x {N} nodes, {tag}{f' cpd={cpd}' if con else ''}"
          f"{f' BS={block_size}' if block_size != 16 else ''}: kernel equals plain"
          f"{' (both routes, both layers)' if both else ''}, {placed} placed")
    if not timed:
        return placed
    ops = pair_ops(R, Rf, Rs) + (6 * Rf * 2 + 4 if con else 0)
    NB = -(-N // block_size)
    # the key build: its inputs once, M and Mb written once; the steps: a
    # sweep of NB block maxima a pod and, a placement, the placed row's key
    # and block maximum read and written for each pod after it in queue
    # order (this run's pairs)
    pairs = case["rescored"](want[0])
    kb, kby = bound_ms(case["in_bytes"] + (NB * block_size + NB) * P * 8, P * N * (ops + 4))
    sb, sby = bound_ms(P * NB * 8 + pairs * 32 + P * (4 + 8), pairs * (ops + 4))
    dev_ms = device_split(kernel, (("build_keys", "keys"), ("scan_steps", "steps")), reps=5)
    return dict(
        name="scan_con" if con else "scan", source="koordinator_tpu_torch/csrc/scan.cu",
        replaces="koordinator_tpu/core/cycle.py:248", ms=cuda_ms(kernel),
        plain_ms=cuda_ms(plain, reps=1), steps_plain_ms=steps_ms,
        bound_ms=kb + sb, bound_by=kby if kb >= sb else sby, keys_bound_ms=kb,
        steps_bound_ms=sb, keys_device_ms=dev_ms.get("keys"), steps_device_ms=dev_ms.get("steps"),
        max_abs_err=err, library_ms=None, strategy=static.strategy, placed=placed,
        rescored_pairs=pairs,
    )


def scan_edges(inp) -> list:
    """The step kernel's invariant cases on ``inp``: (name, inputs, strategy
    name, constrained, extras, block size).  Many pods on one node of an
    empty fleet (its row rescored again and again); the constraint inputs
    (a quota that rejects midway, reservations used up on the touched node,
    gangs rolled back); every extra score at -EXTRA_SCORE_BOUND, the most
    negative total the engine admits; every pod infeasible; one pod;
    padding pods; a node axis the block size does not divide; more pods
    than the step kernel's threads (1,030: a thread rescores several) and
    more block maxima than threads (1,100 nodes in blocks of 1: the sweep
    loops instead of loading a step ahead), each from its own cluster."""
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.service.engine import EXTRA_SCORE_BOUND
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    P, N = inp["la_pods"].est.shape[0], inp["valid"].shape[0]
    dev = inp["valid"].device
    scalars = (BATCH_CPU, BATCH_MEMORY)
    many = build_inputs(*random_cluster(SEED + 3, num_nodes=100, num_pods=1030), dev, scalars)
    wide = build_inputs(*random_cluster(SEED + 4, num_nodes=1100, num_pods=64), dev, scalars)
    ones = torch.ones((P, N), dtype=torch.bool, device=dev)
    low = torch.full((P, N), -EXTRA_SCORE_BOUND, dtype=torch.int64, device=dev)
    return [
        ("empty fleet", empty_fleet(inp), "most", False, False, 16),
        ("constraints", inp, "rtc-nonmono", True, True, 16),
        ("the most negative total", inp, "most", False, (ones, low), 16),
        ("every pod infeasible", inp, "rtc", False, (~ones, low), 16),
        ("one pod", ragged(inp, N, 1), "most", False, False, 16),
        ("padding pods", dict(inp, p_real=P - 9), "rtc", True, True, 16),
        ("blocks of 7", ragged(inp, N - 3, P), "most", False, True, 7),
        ("blocks of 64", inp, "rtc-nonmono", True, False, 64),
        ("more pods than threads", ragged(many, 100, 1030), "most", True, True, 16),
        ("more blocks than threads", ragged(wide, 1100, 64), "rtc", True, True, 1),
    ]


def check_scan_edges(inp) -> None:
    """``scan_edges`` through ``check_scan_kernels`` (both plain routes,
    both layers, under both tie-breaks), each case's own property held."""
    statics = dict(strategy_statics(inp["static"]))
    for name, x, strat, con, extras, bs in scan_edges(inp):
        for tie in ("salted", "index"):
            placed = check_scan_kernels(x, statics[strat], con, tie, extras, False,
                                        block_size=bs, what=f" ({name})")
            if (name == "every pod infeasible") != (placed == 0):
                fail(f"scan ({name}, {tie}): {placed} placed")


def check_key_builds(inp, timed: bool) -> dict:
    """The key build (``schedule_keys``) under MostAllocated and both RTC
    shapes, plain and constrained, on both key lanes, against
    ``build_keys_plain`` (M, Mb, la_feas_T) exactly.  Returns {name: {ms,
    plain_ms}} when ``timed``."""
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.core.cycle import PluginWeights

    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    P, N = la_pods.est.shape[0], inp["valid"].shape[0]
    xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(la_pods, nf_pods, inp["valid"], inp["p_real"],
                                                    inp["order"])
    q_extra0 = pod_ok[:, None] & inp["valid"][None, :]
    out = {}
    for name, static in strategy_statics(inp["static"]):
        for con in (False, True):
            c = con_for(inp, con_inputs_for(inp, SEED + 11), xs) if con else None
            q_extra = q_extra0 & rs.gang_pass(c)[:, None] if con else q_extra0
            for kdt, wide in ((torch.int32, False), (torch.int64, True)):
                args = (q_la, inp["la_nodes"], inp["weights"], q_nf, inp["nf_nodes"], static,
                        inp["valid"], pod_ok, salts, 16, c, None, wide)

                def kernel():
                    return rs.schedule_keys(*args)

                def plain():
                    return rs.build_keys_plain(q_la, inp["la_nodes"], inp["weights"], q_nf,
                                               inp["nf_nodes"], static, PluginWeights(), q_extra,
                                               salts, 16, rs._queue_rsv(c) if con else None,
                                               None, kdt)

                tag = f"schedule_keys{'64' if wide else ''}{'_con' if con else ''} {name}"
                require_equal(f"{tag} {P}x{N}", kernel(), plain())
                if timed:
                    out[tag] = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain))
    print(f"  {P} pods x {N} nodes: the key build under MostAllocated and RTC (both shapes), "
          "plain and constrained, int32 and int64 keys, equals plain")
    return out


def check_div_helper(dev) -> int:
    """pair.cuh's exact division (``div_cap`` with ``koord_rcp``, and the
    32-bit ``div_small``) against ``floor_div`` on the card, from the scan's
    study build: divisors 1, 2, 2**k - 1, 2**k, 2**k + 1 up to 2**62 and
    random ones; for each, numerators 0, 1, d - 1, d, d + 1, 2d - 1, 2d, 3d,
    random multiples and their neighbours, 2**31 - 1, 2**32 - 1, 2**32,
    2**63 - 1, random ones, and negatives (which take ``floor_div``), each
    quotient also against Python's exact floor division, as the plain
    versions divide.  Returns the pairs checked."""
    from koordinator_tpu_torch import cuda

    rng = np.random.default_rng(SEED + 71)
    top = (1 << 63) - 1
    divs = {1, 2, 3, top}
    for k in range(1, 63):
        divs |= {(1 << k) - 1, 1 << k, (1 << k) + 1}
    divs |= {int(v) for v in rng.integers(1, top, 64, dtype=np.int64)}
    divs |= {int(v) for v in rng.integers(1, 1 << 20, 64)}
    ns, ds = [], []
    for d in sorted(divs):
        cand = {0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, 3 * d, (1 << 31) - 1, (1 << 32) - 1,
                1 << 32, top, top - 1, -1, -d, -(1 << 62)}
        for m in rng.integers(1, max(2, top // d), 4, dtype=np.int64):
            cand |= {int(m) * d - 1, int(m) * d, int(m) * d + 1}
        cand |= {int(v) for v in rng.integers(-(1 << 62), top, 6, dtype=np.int64)}
        for n in cand:
            if -(1 << 63) <= n <= top:
                ns.append(n)
                ds.append(d)
    n = torch.tensor(ns, dtype=torch.int64, device=dev)
    d = torch.tensor(ds, dtype=torch.int64, device=dev)
    out = torch.empty((len(ns), 3), dtype=torch.int64, device=dev)
    study_build("koord_div_check", (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_int,
                                                            ctypes.c_void_p),
                "scanstudy").launch(n.data_ptr(), d.data_ptr(), out.data_ptr(), len(ns),
                                    cuda.device_index(dev), cuda.stream(dev))
    got = out.cpu().tolist()
    for (fast, slow, small), a, b in zip(got, ns, ds):
        exact = a // b
        if not fast == slow == small == exact:
            fail(f"division {a} / {b}: div_cap {fast}, div_small {small}, floor_div {slow}, "
                 f"exact {exact}")
    print(f"  pair.cuh's division helpers equal the floor on {len(ns)} operand pairs "
          f"({len(divs)} divisors)", flush=True)
    return len(ns)


def check_matrix_kernels(inp, con: bool, extras: bool, timed: bool, commit_cap: int = 16):
    """The int64-key matrix engine's kernels (``schedule_keys64``,
    ``schedule_rounds64``, constrained with ``con``) against their plain
    versions: the key build against ``build_keys_plain`` with int64 keys,
    the round loop's hosts, scores (precommit) and round count against the
    plain ``matrix`` engine (``run_matrix_plain``, JAX's run_matrix); the
    round count must also equal the int32 engine's on the same inputs.
    Returns the kernel records when ``timed``."""
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.core.cycle import PluginWeights

    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    la_nodes, nf_nodes, valid, w = inp["la_nodes"], inp["nf_nodes"], inp["valid"], inp["weights"]
    static, pw = inp["static"], PluginWeights()
    P, N = la_pods.est.shape[0], valid.shape[0]
    R, Rf, Rs = la_pods.est.shape[1], nf_pods.req.shape[1], nf_pods.req_score.shape[1]
    BS, AD = 16, 8
    xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(la_pods, nf_pods, valid, inp["p_real"],
                                                    inp["order"])
    con_ = con_for(inp, con_inputs_for(inp, SEED + 11), xs) if con else None
    xin = None
    if extras:
        xin = rs.extra_inputs(*extras_for(inp, SEED + 25), xs)
    q_extra, q_xsc = rs._q_extras(xin, pod_ok[:, None] & valid[None, :])
    if con:
        q_extra = q_extra & rs.gang_pass(con_)[:, None]
    rsv_q = rs._queue_rsv(con_) if con else None
    keys_args = (q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok, salts, BS)

    def kernel_keys():
        return rs.schedule_keys(*keys_args, con_, xin, wide=True)

    def plain_keys():
        return rs.build_keys_plain(q_la, la_nodes, w, q_nf, nf_nodes, static, pw, q_extra, salts,
                                   BS, rsv_q, q_xsc, torch.int64)

    keys = kernel_keys()
    tag = f"{'_con' if con else ''}{' extras' if extras else ''}"
    err = {"schedule_keys64": require_equal(f"schedule_keys64{tag} {P}x{N}", keys, plain_keys())}
    M0, Mb0, feas_T = keys
    node_args = (q_la, la_nodes, w, q_nf, nf_nodes, static, valid, pod_ok, salts, commit_cap, BS,
                 con_, 0, AD, xin)

    def kernel_rounds(M, Mb):
        return rs.schedule_rounds(M, Mb, feas_T, *node_args)

    def plain_rounds():
        M, feas = rs.masked_init(q_la, la_nodes, w, q_nf, nf_nodes, static, pw, q_extra, rsv_q,
                                 q_xsc)
        return rs.run_matrix_plain(M, feas, q_la, la_nodes, w, q_nf, nf_nodes, static, pw,
                                   q_extra, salts, commit_cap, con_, 0, AD, q_xsc)

    got, want = kernel_rounds(M0.clone(), Mb0.clone()), plain_rounds()
    if con:
        want = (want[0], want[1], want[2], torch.tensor([want[3], want[4]], dtype=torch.int32))
    else:
        want = (want[0], want[1], torch.tensor(want[2], dtype=torch.int32))
    err["schedule_rounds64"] = require_equal(f"schedule_rounds64{tag} {P}x{N}", got, want)
    rounds = int(want[-1].view(-1)[0])
    M32, Mb32, f32 = rs.schedule_keys(*keys_args, con_, xin)
    narrow = rs.schedule_rounds(M32, Mb32, f32, *node_args)
    require_equal(f"schedule_rounds64{tag}: the int32 engine's results and round count", got,
                  narrow)
    print(f"  {P} pods x {N} nodes, int64 keys{tag}: kernels equal the plain matrix engine, "
          f"{rounds} rounds as the int32 engine")
    if not timed:
        return None
    work = {}

    def reset():
        work["M"], work["Mb"] = M0.clone(), Mb0.clone()

    sfx = "_con" if con else ""
    ops = pair_ops(R, Rf, Rs) + (6 * Rf * 2 + 4 if con else 0)
    pods_b = nbytes(*la_pods, *nf_pods)
    nodes_b = nbytes(*la_nodes, *nf_nodes, valid)
    b, by = bound_ms(pods_b + nodes_b + nbytes(M0, Mb0, feas_T), P * N * (ops + 4))
    recs = [dict(
        name=f"schedule_keys64{sfx}", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/core/resolved.py:839", ms=cuda_ms(kernel_keys),
        plain_ms=cuda_ms(plain_keys), bound_ms=b, bound_by=by,
        max_abs_err=err["schedule_keys64"], library_ms=None,
    )]
    NB, K = Mb0.shape[0], min(commit_cap, P)
    r_ops = rounds * (NB * P + K * P * (ops + 4) + K * BS * P)
    r_bytes = nbytes(Mb0) + rounds * K * P * (8 + 1) + pods_b + nodes_b + P * (4 + 8)
    b, by = bound_ms(r_bytes, r_ops)
    recs.append(dict(
        name=f"schedule_rounds64{sfx}", source="koordinator_tpu_torch/csrc/schedule.cu",
        replaces="koordinator_tpu/core/resolved.py:839",
        ms=cuda_ms(lambda: kernel_rounds(work["M"], work["Mb"]), setup=reset),
        plain_ms=cuda_ms(plain_rounds, reps=1), bound_ms=b, bound_by=by, rounds=rounds,
        max_abs_err=err["schedule_rounds64"], library_ms=None,
    ))
    return recs


def drive_matrix_path(inp, con: bool):
    """``schedule_fn(impl="matrix")`` at the inputs' full width, the route
    the engine takes beyond 2**21 node columns: it must launch the int64-key
    kernels and equal ``schedule_fn``'s int32 route (hosts, scores,
    precommit, round count).  Returns the launches of the matrix call."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import reservation as tr
    from koordinator_tpu_torch.core.cycle import ReservationInputs
    from koordinator_tpu_torch.core.resolved import schedule_fn

    args = (inp["la_pods"], inp["la_nodes"], inp["weights"], inp["nf_pods"], inp["nf_nodes"],
            inp["static"], inp["valid"], inp["p_real"], inp["order"])
    kw = {}
    if con:
        gangs, quota, rsv, matched, midx, rank = con_inputs_for(inp, SEED + 11)
        req, N = inp["nf_pods"].req, inp["valid"].shape[0]
        r = ReservationInputs(rsv=rsv, matched=matched, rscore=tr.rsv_rscore(req, rsv),
                              scores=tr.rsv_score(req, matched, N, rsv, rank))
        kw = dict(con_args=dict(gang=gangs, quota=quota, reservation=r, rsv_midx=midx,
                                rsv_rank=rank))
    with uncounted():
        narrow = schedule_fn(*args, **kw)
    for k in cuda.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    wide = schedule_fn(*args, impl="matrix", **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    require_equal(f"schedule_fn(impl='matrix'){' constrained' if con else ''} vs int32 keys",
                  wide[:4], narrow[:4])
    if wide[4] is not None:
        fail("the matrix route left a warm carry")
    print(f"  schedule_fn(impl='matrix'){' constrained' if con else ''} at "
          f"{inp['p_real']} x {inp['valid'].shape[0]}: equals the int32 route, "
          f"{int(wide[3].view(-1)[0])} rounds, {wall:.1f} ms wall; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


# the strategies phase: (name, clock offset, what changes before the cycle,
# assume); every SCHEDULE is a cold scan (the begin cache may hit)
MOST_CYCLES = (("cold, with a SCORE", 0.0, None, False),
               ("unchanged", 1.0, None, False),
               ("metrics on 100 nodes", 2.0, "metrics", False),
               ("assume with 8 pending reservations", 3.0, "reserve", True))
RTC_CYCLES = (("cold, with a SCORE", 0.0, None, False),
              ("unchanged", 1.0, None, False),
              ("assume", 2.0, None, True))
STRATEGY_PATH_KERNELS = ("score", "schedule_keys64", "schedule_keys64_con", "scan", "scan_con",
                         "quota", "quota_limit", "rsv_score", "placement",
                         "dev_feasible", "ds_score", "dstate_gate")
# the kernels a SCHEDULE under MostAllocated or RTC never launches: the
# packed keys and every round loop
PACKED = ("schedule_keys", "schedule_rounds", "sched_refresh", "sched_rounds",
          "schedule_keys_con", "schedule_rounds_con", "sched_refresh_con", "sched_rounds_con",
          "schedule_rounds64", "schedule_rounds64_con")


def drive_strategy_path(device, num_nodes: int, num_pods: int, scalars):
    """The strategies phase at full width: (a) MostAllocated over the
    constraint phase's store and batch (``con_store``, ``con_batch``) —
    SCORE, then ``MOST_CYCLES`` and ``Engine.quota_refresh``; (b)
    RequestedToCapacityRatio with the default shape over the placement
    phase's store and batch — SCORE, then ``RTC_CYCLES``.  Each result is
    held against the CPU engine on a twin store (allocation records and
    grants included); after ``assume`` the stores against each other.
    Every SCHEDULE must launch the int64 key build once and the step
    kernel once, and no packed-key kernel or round loop.  Returns (launches
    per kernel during this phase, per-cycle records)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import CPU, MEMORY, NodeMetric
    from koordinator_tpu_torch.core.config import NodeFitArgs, ScoringStrategyType
    from koordinator_tpu_torch.service.constraints import ReservationInfo
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.utils.fixtures import NOW

    on_card = device.type == "cuda"
    runs = []
    t0 = time.perf_counter()
    most = NodeFitArgs(strategy=ScoringStrategyType.MOST_ALLOCATED)
    rtc = NodeFitArgs(strategy=ScoringStrategyType.REQUESTED_TO_CAPACITY_RATIO)
    stores = [con_store(scalars, num_nodes, nf_args=most) for _ in range(2)]
    runs.append(("MostAllocated", stores, MOST_CYCLES,
                 lambda tag, seed: con_batch(num_pods, tag, seed), store_view))
    rstores = [placement_store(scalars, num_nodes, nf_args=rtc) for _ in range(2)]
    runs.append(("RequestedToCapacityRatio", rstores, RTC_CYCLES,
                 lambda tag, seed: placement_batch(num_nodes, num_pods, tag, seed), device_view))
    print(f"  ingest of four stores: {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED + 51)
    metric_nodes = [f"node-{int(i)}" for i in rng.choice(num_nodes, 100, replace=False)]
    for k in cuda.KERNELS.values():
        k.launches = 0
    records = []
    with LaunchTimer() as timer, GcTimer() as gc_timer:
        for strategy, pair, cycles, make_batch, view in runs:
            eng, ref = Engine(pair[0], device=device), Engine(pair[1], device="cpu")
            batch = {e: make_batch("strat", SEED + 52) for e in (eng, ref)}
            for c, (name, dt, change, assume) in enumerate(cycles):
                now = NOW + dt
                for st in pair:
                    if change == "metrics":
                        for i, node in enumerate(metric_nodes):
                            st.update_metric(node, NodeMetric(
                                node_usage={CPU: 3000 + 11 * i, MEMORY: (3 + i % 5) << 30},
                                update_time=now))
                    if change == "reserve":
                        for i in range(8):
                            st.reservations.upsert(ReservationInfo(
                                name=f"pend-{i}", node=None,
                                allocatable={"cpu": 2000 + 250 * i, "memory": 4 << 30},
                                priority=9000, create_time=float(i)))
                t1 = time.perf_counter()
                for st in pair:
                    st.publish(now)
                publish = (time.perf_counter() - t1) * 1e3 / len(pair)
                before = {k: v.launches for k, v in cuda.KERNELS.items()}
                begin0 = eng.sched_begin_hits
                if on_card:
                    timer.take()
                score_wall = None
                t1 = time.perf_counter()
                if c == 0:
                    totals, feasible, _ = eng.score(batch[eng], now=now)
                    score_wall = (time.perf_counter() - t1) * 1e3
                    rt, rf, _ = ref.score(batch[ref], now=now)
                    require_equal(f"{strategy} SCORE vs the CPU engine", (totals, feasible),
                                  (rt, rf))
                    t1 = time.perf_counter()
                gc_timer.take()
                hosts, scores, snap, allocs = eng.schedule(batch[eng], now=now, assume=assume)
                wall = (time.perf_counter() - t1) * 1e3
                gc_ms = gc_timer.take()
                k_ms = timer.take() if on_card else {}
                launched = {k: v.launches - before[k] for k, v in cuda.KERNELS.items()}
                demotions = dict(eng.last_demotions)
                t1 = time.perf_counter()
                rh, rs_, _, ra = ref.schedule(batch[ref], now=now, assume=assume)
                cpu_wall = (time.perf_counter() - t1) * 1e3
                what = f"{strategy} cycle {c} ({name})"
                require_equal(f"{what} vs the CPU engine", (hosts, scores), (rh, rs_))
                if allocs != ra:
                    fail(f"{what}: allocation records differ")
                if demotions != ref.last_demotions:
                    fail(f"{what}: demotions {demotions}, CPU engine {ref.last_demotions}")
                if (eng.last_rounds, eng.last_ub_rounds) != (0, 0):
                    fail(f"{what}: rounds {eng.last_rounds}/{eng.last_ub_rounds} under the scan")
                if eng.sched_warm_hits or eng.sched_cold_inits != c + 1:
                    fail(f"{what}: warm {eng.sched_warm_hits}, cold {eng.sched_cold_inits}")
                if name == "unchanged" and eng.sched_begin_hits != begin0 + 1:
                    fail(f"{what}: the begin-input cache missed")
                scans = launched["scan"] + launched["scan_con"]
                keys = launched["schedule_keys64"] + launched["schedule_keys64_con"]
                if on_card and (scans != 1 or keys != 1 or any(launched[k] for k in PACKED)):
                    fail(f"{what}: launches {launched}: planned one int64 key build and one "
                         "step kernel, no packed-key kernel or round loop")
                if assume:
                    if view(pair[0]) != view(pair[1]):
                        fail(f"{what}: the stores differ after assume")
                    if strategy == "MostAllocated" and (
                            eng.last_reservations_placed != ref.last_reservations_placed
                            or not eng.last_reservations_placed):
                        fail(f"{what}: reserve pods placed {eng.last_reservations_placed}")
                    if strategy != "MostAllocated" and min(demotions.values()) == 0:
                        fail(f"{what}: demotions {demotions}, planned at least one of each")
                placed = int((hosts >= 0).sum())
                grants = sum(1 for a in allocs if a and ("devices" in a or "cpuset" in a))
                on_rsv = sum(1 for a in allocs if a and a.get("reservation"))
                busy = sum(k_ms.values())
                rec = dict(strategy=strategy, cycle=name, publish_ms=publish, wall_ms=wall,
                           gc_ms=gc_ms, score_wall_ms=score_wall, cpu_wall_ms=cpu_wall,
                           kernel_ms=k_ms,
                           launches={k: v for k, v in launched.items() if v}, placed=placed,
                           grants=grants, with_reservation=on_rsv, demotions=demotions,
                           begin_hits=eng.sched_begin_hits)
                records.append(rec)
                print(f"  {strategy} cycle {c} ({name}): {placed}/{len(hosts)} placed ({on_rsv} "
                      f"on a reservation, {grants} with devices or cpusets, demoted "
                      f"{demotions}); publish {publish:.1f} ms, schedule {wall:.1f} ms wall "
                      f"(garbage collector {sum(gc_ms.values()):.1f} ms: {gc_ms})"
                      + (f", score {score_wall:.1f} ms wall" if score_wall else "")
                      + f", kernels {busy:.2f} ms: "
                      + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(k_ms.items()))
                      + f"; CPU twin {cpu_wall:.0f} ms; launches {rec['launches']}", flush=True)
            if strategy == "MostAllocated":
                st = pair[0]
                args = (list(st.quota._groups.values()), st.quota.resources,
                        st.quota.cluster_total)
                require_equal("MostAllocated Engine.quota_refresh", (eng.quota_refresh(*args)[1],),
                              (ref.quota_refresh(*args)[1],))
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    return launches, records


def check_strategies_small(small) -> None:
    """The strategies' kernel checks at the small shape: ``score`` under
    MostAllocated and both RTC shapes; the key build under them; the scan,
    plain and constrained (check_parent_depth 0 and 2), under both
    tie-breaks, with and without extras, under each strategy; the int64-key
    engine, plain and constrained, with and without extras, across commit
    caps."""
    check_strategy_score(small, timed=False)
    check_key_builds(small, timed=False)
    for name, static in strategy_statics(small["static"]):
        for tie in ("salted", "index"):
            for extras in (False, True):
                check_scan_kernels(small, static, False, tie, extras, timed=False)
                check_scan_kernels(small, static, True, tie, extras, timed=False)
        check_scan_kernels(small, static, True, "salted", True, timed=False, cpd=2)
    for con in (False, True):
        for extras in (False, True):
            check_matrix_kernels(small, con, extras, timed=False)
    check_matrix_kernels(small, True, True, timed=False, commit_cap=1)
    check_matrix_kernels(small, False, False, timed=False, commit_cap=100)


def check_strategies_full(full, records) -> list:
    """The strategies' kernel checks at the full shape, timed: ``score``
    under MostAllocated and both RTC shapes (their times join the score
    record), the scan under each strategy (plain and constrained, salted,
    with extras; the index tie-break untimed), and the int64-key engine
    (plain and constrained, the constrained one with extras too).  Returns
    the new kernel records."""
    score_ms = check_strategy_score(full, timed=True)
    keys_ms = check_key_builds(full, timed=True)
    for rec in records:
        if rec["name"] == "score":
            rec["strategies_ms"] = {k: {"ms": v[0], "plain_ms": v[1]} for k, v in score_ms.items()}
        if rec["name"] in ("schedule_keys", "schedule_keys_con"):
            rec["strategies_ms"] = {k: v for k, v in keys_ms.items()
                                    if k.startswith(rec["name"] + " ")}
    out = {}
    for name, static in strategy_statics(full["static"]):
        for con in (False, True):
            rec = check_scan_kernels(full, static, con, "salted", True, timed=True)
            check_scan_kernels(full, static, con, "index", False, timed=False, both=False)
            if rec["name"] not in out:
                out[rec["name"]] = dict(rec, variants={})
            out[rec["name"]]["variants"][name] = {
                k: rec[k] for k in ("ms", "plain_ms", "steps_plain_ms", "bound_ms",
                                    "keys_device_ms", "steps_device_ms", "placed")}
    # more block maxima (2,048) than the step kernel's threads
    check_scan_kernels(full, strategy_statics(full["static"])[0][1], True, "salted", True,
                       timed=False, block_size=8, what=" (more blocks than threads)")
    new = list(out.values())
    new += check_matrix_kernels(full, False, False, timed=True)
    new += check_matrix_kernels(full, True, False, timed=True)
    check_matrix_kernels(full, True, True, timed=False)
    for rec in new:
        if rec["name"] in ("schedule_keys64", "schedule_keys64_con"):
            rec["strategies_ms"] = {k: v for k, v in keys_ms.items()
                                    if k.startswith(rec["name"] + " ")}
    return new


# ------------------------------------------------------- the explain slice

BREAKDOWN_SOURCE = "koordinator_tpu_torch/csrc/breakdown.cu"


def check_breakdown_kernels(inp, timed: bool):
    """``la_score``, ``nf_score`` (LeastAllocated, MostAllocated, RTC at the
    default and a non-monotone shape) and ``loadaware_score_and_filter``
    against their plain versions on the inputs' device, exactly (raises
    ``Mismatch``); returns their records when ``timed``."""
    from koordinator_tpu_torch.core import loadaware as la
    from koordinator_tpu_torch.core import nodefit as nf

    la_pods, la_nodes, w = inp["la_pods"], inp["la_nodes"], inp["weights"]
    nf_pods, nf_nodes = inp["nf_pods"], inp["nf_nodes"]
    P, N = la_pods.est.shape[0], la_nodes.alloc.shape[0]
    R, Rs = la_pods.est.shape[1], nf_pods.req_score.shape[1]

    def la_kernel():
        return la.loadaware_score(la_pods, la_nodes, w)

    def la_plain():
        return la.loadaware_score_plain(la_pods, la_nodes, w)

    def fused_kernel():
        return la.loadaware_score_and_filter(la_pods, la_nodes, w)

    def fused_plain():
        return la_plain(), la.loadaware_filter(la_pods, la_nodes)

    err = {"la_score": require_equal(f"la_score {P}x{N}", (la_kernel(),), (la_plain(),)),
           "loadaware_score_and_filter": require_equal(
               f"loadaware_score_and_filter {P}x{N}", fused_kernel(), fused_plain())}
    want = fused_plain()
    if not want[0].any() or bool(want[1].all()) or not want[1].any():
        fail("la_score/loadaware_score_and_filter: the inputs do not exercise score and filter")
    statics = [("least", inp["static"])] + strategy_statics(inp["static"])
    nf_ms = {}
    for name, static in statics:
        def nf_kernel(static=static):
            return nf.nodefit_score(nf_pods, nf_nodes, static)

        def nf_plain(static=static):
            return nf.nodefit_score_plain(nf_pods, nf_nodes, static)

        got, ref = nf_kernel(), nf_plain()
        err[f"nf_score {name}"] = require_equal(f"nf_score {name} {P}x{N}", (got,), (ref,))
        if len(set(ref.flatten().tolist()[:8192])) < 2:
            fail(f"nf_score {name}: the scores do not vary")
        if timed:
            nf_ms[name] = (cuda_ms(nf_kernel), cuda_ms(nf_plain))
    print(f"  {P} pods x {N} nodes: la_score, nf_score (LeastAllocated, MostAllocated, RTC "
          "default and non-monotone) and loadaware_score_and_filter equal plain")
    if not timed:
        return None
    la_in = nbytes(la_pods.est, la_pods.is_prod_score, w, la_nodes.alloc, la_nodes.base_nonprod,
                   la_nodes.base_prod, la_nodes.score_valid)
    filt_in = nbytes(la_pods.is_prod_class, la_pods.is_daemonset, la_nodes.filter_usage,
                     la_nodes.filter_active, la_nodes.thresholds, la_nodes.prod_usage,
                     la_nodes.prod_filter_active, la_nodes.prod_thresholds,
                     la_nodes.has_prod_thresholds)
    nf_in = nbytes(nf_pods.req_score, nf_nodes.alloc_score, nf_nodes.req_score)
    recs = []
    b, by = bound_ms(la_in + P * N * 8, P * N * (9 * R + 2))
    floor = la_floor(P, N, la_pods.est.device, False)
    recs.append(dict(name="la_score", source=BREAKDOWN_SOURCE,
                     replaces="koordinator_tpu/core/loadaware.py:77 (engine.py:1173)",
                     ms=cuda_ms(la_kernel), plain_ms=cuda_ms(la_plain), bound_ms=b, bound_by=by,
                     max_abs_err=err["la_score"], ms_run=run_ms(la_kernel),
                     floor_ms=cuda_ms(floor), floor_ms_run=run_ms(floor)))
    b, by = bound_ms(nf_in + P * N * 8, P * N * (10 * Rs + 2))
    recs.append(dict(name="nf_score", source=BREAKDOWN_SOURCE,
                     replaces="koordinator_tpu/core/nodefit.py:84 (engine.py:1169)",
                     ms=nf_ms["least"][0], plain_ms=nf_ms["least"][1], bound_ms=b, bound_by=by,
                     max_abs_err=max(v for k, v in err.items() if k.startswith("nf_score")),
                     strategies_ms={k: {"ms": v[0], "plain_ms": v[1]} for k, v in nf_ms.items()
                                    if k != "least"}))
    b, by = bound_ms(la_in + filt_in + P * N * 9, P * N * (9 * R + 2 + 7 * R + 3))
    floor = la_floor(P, N, la_pods.est.device, True)
    recs.append(dict(name="loadaware_score_and_filter", source=BREAKDOWN_SOURCE,
                     replaces="koordinator_tpu/core/loadaware.py:133", ms=cuda_ms(fused_kernel),
                     plain_ms=cuda_ms(fused_plain), bound_ms=b, bound_by=by,
                     max_abs_err=err["loadaware_score_and_filter"], ms_run=run_ms(fused_kernel),
                     floor_ms=cuda_ms(floor), floor_ms_run=run_ms(floor)))
    return recs


DESCHED_SOURCE = "koordinator_tpu_torch/csrc/deschedule.cu"
BAND_SOURCE = "koordinator_tpu_torch/csrc/bandrank.cu"


def require_same_util(what: str, got, want) -> int:
    """float64 percentiles equal bit for bit, NaN where the plain version
    has NaN (the card's NaN payload may differ); returns 0."""
    g, w = got.cpu(), want.cpu()
    gn, wn = torch.isnan(g), torch.isnan(w)
    if g.shape != w.shape or not torch.equal(gn, wn) or not torch.equal(
            g[~gn].view(torch.int64), w[~wn].view(torch.int64)):
        fail(f"{what}: util {g.tolist()} differs from the plain version's {w.tolist()}")
    return 0


def desched_arrays(dev, N: int, n_cand: int, bucket: int, seed: int, heat: float = 1.2,
                   unsched: float = 0.1, valid: float = 0.9):
    """A pool's round inputs on ``dev``: N nodes with random allocatable and
    usage up to ``heat`` of it, ``n_cand`` candidates on random nodes padded
    to ``bucket`` (padding rows: node 0, usage 0, not removable), R = 2."""
    from koordinator_tpu_torch.core.lownodeload import LNLNodeArrays, LNLPodArrays, as_tensors

    rng = np.random.default_rng(seed)
    alloc = rng.integers(1000, 16000, size=(N, 2)).astype(np.int64)
    usage = (alloc * rng.uniform(0.0, heat, size=(N, 2))).astype(np.int64)
    nodes = LNLNodeArrays(usage=usage, alloc=alloc, unschedulable=rng.random(N) < unsched,
                          valid=rng.random(N) < valid)
    node = np.zeros(bucket, dtype=np.int32)
    pusage = np.zeros((bucket, 2), dtype=np.int64)
    rm = np.zeros(bucket, dtype=bool)
    node[:n_cand] = rng.integers(0, N, size=n_cand)
    pusage[:n_cand] = rng.integers(0, 4000, size=(n_cand, 2))
    rm[:n_cand] = rng.random(n_cand) < 0.8
    return as_tensors(nodes, dev), as_tensors(LNLPodArrays(node=node, usage=pusage, removable=rm),
                                              dev)


def round_outputs(rnd) -> tuple:
    return (*rnd.state, rnd.evicted, rnd.rank, rnd.under, rnd.over, rnd.source)


def desched_round_bytes(state, nodes, pods) -> int:
    """The round's compulsory bytes: every input read once, every output
    written once."""
    N, R = nodes.usage.shape
    Pc = pods.node.shape[0]
    ins = nbytes(*state, *nodes, *pods) + 3 * R * 8  # and the percents and weights
    return ins + nbytes(*state) + Pc * (1 + 8) + 3 * N + 3 * R * 8


def desched_passes(nodes, pods, weights) -> tuple:
    """The radix passes the round's orders need on these inputs (host
    reckoning, as csrc/deschedule.cu sorts): the node order over its keys'
    spread, each candidate order over the candidate scores' spread plus the
    node rank's bits (the unmasked score's spread stands for the walk
    order's too); (node passes, the two candidate orders' passes)."""
    from koordinator_tpu_torch.core.lownodeload import usage_score

    def bits(x) -> int:
        return (int(x.max()) - int(x.min())).bit_length() if x.numel() else 0

    N = nodes.usage.shape[0]
    node = pods.node.long().clamp(0, N - 1)
    ns = usage_score(nodes.usage, nodes.alloc, weights)
    ps = usage_score(pods.usage, nodes.alloc[node], weights)
    rank_bits = (N - 1).bit_length()
    return -(-bits(ns) // 8), 2 * -(-(bits(ps) + rank_bits) // 8)


def device_split(fn, groups, reps: int = 10) -> dict:
    """Device milliseconds a call of ``fn`` by kernel group, from
    ``torch.profiler`` over ``reps`` calls: each kernel's self device time
    goes to the first group whose key its name contains, else "other"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            group = next((g for key, g in groups if key in e.key), "other")
            out[group] = out.get(group, 0.0) + us / 1e3 / reps
    return out


# kernel-name keys of the descheduler's kernels, grouped for device_split
DESCHED_GROUPS = (("round_kernel", "the round"), ("band_kernel", "the band order"),
                  ("util_kernel", "percentile select"), ("tile_", "scans"))


def check_desched_round(what: str, state, nodes, pods, low, high, weights, rounds: int = 1,
                        timed: bool = False, **kw):
    """``deschedule_round`` against its plain version on the same device,
    over ``rounds`` rounds carrying the detector state: integer and bool
    outputs exactly, the percentiles bit for bit.  Returns (the last round's
    plain outputs, its record when ``timed``)."""
    from koordinator_tpu_torch.core import deschedule as ds
    from koordinator_tpu_torch.core.lownodeload import AnomalyState

    def kernel():
        return ds.deschedule_round(state, nodes, pods, low, high, weights, **kw)

    def plain():
        return ds.deschedule_round_plain(state, nodes, pods, low, high, weights, **kw)

    for _ in range(rounds):
        got, want = kernel(), plain()
        err = require_equal(f"deschedule_round {what}", round_outputs(got), round_outputs(want))
        require_same_util(f"deschedule_round {what}", got.util_pct, want.util_pct)
        host = ds.to_host(got)
        if not all(np.array_equal(a, b.cpu().numpy()) for a, b in zip(round_outputs(host),
                                                                        round_outputs(want))):
            fail(f"deschedule_round {what}: to_host differs from the device outputs")
        state = AnomalyState(*want.state)
    if not timed:
        return want, None
    N, R = nodes.usage.shape
    Pc = pods.node.shape[0]
    # integer operations: the usage scores (a node, twice a candidate), the
    # thresholds and walk, and 6 a key element a radix pass, the passes this
    # data needs: the node order's keys span the node scores' range, the
    # candidate orders' the candidate scores' range below the node rank
    passes_n, passes_pc = desched_passes(nodes, pods, weights)
    ops = N * (12 * R + 6 * passes_n + 20 * R) + Pc * (24 * R + 6 * passes_pc + 8 * R)
    b, by = bound_ms(desched_round_bytes(state, nodes, pods), ops)
    return want, dict(name="deschedule_round", source=DESCHED_SOURCE,
                      replaces="koordinator_tpu/core/deschedule.py:144", ms=cuda_ms(kernel),
                      plain_ms=cuda_ms(plain), bound_ms=b, bound_by=by, max_abs_err=err,
                      shape=f"{N} nodes x {Pc} candidates",
                      device_split_ms=device_split(kernel, DESCHED_GROUPS))


def wide_desched_arrays(dev, N: int, n_cand: int, bucket: int, seed: int):
    """A pool whose usage scores span the whole int64 range: allocatable
    among -7, 0, 1, 7, 1e9 and 2**62, usage anywhere in [-2**62, 2**62]
    (0 included), candidates' usage likewise, weights (3, -2) (a weight sum
    of 1, so the sums themselves are the scores); percents negative,
    extreme, 0.0 and NaN (allocatable <= 0, invalid nodes)."""
    from koordinator_tpu_torch.core.lownodeload import LNLNodeArrays, LNLPodArrays, as_tensors

    rng = np.random.default_rng(seed)
    alloc = rng.choice(np.array([-7, 0, 1, 7, 10**9, 2**62], dtype=np.int64), size=(N, 2))
    usage = rng.integers(-2**62, 2**62, size=(N, 2), dtype=np.int64)
    usage[rng.random((N, 2)) < 0.1] = 0
    nodes = LNLNodeArrays(usage=usage, alloc=alloc, unschedulable=rng.random(N) < 0.1,
                          valid=rng.random(N) < 0.9)
    node = np.zeros(bucket, dtype=np.int32)
    pusage = np.zeros((bucket, 2), dtype=np.int64)
    rm = np.zeros(bucket, dtype=bool)
    node[:n_cand] = rng.integers(0, N, size=n_cand)
    pusage[:n_cand] = rng.integers(-2**62, 2**62, size=(n_cand, 2), dtype=np.int64)
    rm[:n_cand] = rng.random(n_cand) < 0.8
    return as_tensors(nodes, dev), as_tensors(LNLPodArrays(node=node, usage=pusage,
                                                           removable=rm), dev)


def desched_cases(dev) -> list:
    """(name, nodes, pods, low, high, weights, kw) of the round's edge
    cases: keys whose high digits are all equal over many blocks (2,000
    nodes x 4,096 candidates), keys spanning the whole 64 bits, one node
    and one candidate, caps of 0, 1 and unlimited, each without and with
    deviation mode, over three rounds carrying the detector state."""
    f64, i64 = torch.float64, torch.int64
    low = torch.tensor([30.0, 40.0], dtype=f64, device=dev)
    high = torch.tensor([60.0, 80.0], dtype=f64, device=dev)
    ones = torch.tensor([1, 1], dtype=i64, device=dev)
    out = []
    nodes, pods = desched_arrays(dev, 2000, 3000, 4096, SEED + 1)
    for caps in ((0, 0), (1, 1), (-1, -1), (2, 300)):
        out.append((f"2000x4096 caps={caps}", nodes, pods, low, high, ones,
                    dict(per_node_cap=caps[0], total_cap=caps[1])))
    nodes, pods = wide_desched_arrays(dev, 500, 900, 1024, SEED + 2)
    out.append(("64-bit keys", nodes, pods, low, high,
                torch.tensor([3, -2], dtype=i64, device=dev), {}))
    one = desched_arrays(dev, 1, 1, 1, SEED + 3, heat=2.0)
    out.append(("N=1 Pc=1", *one, low, high, ones, {}))
    nodes, pods = desched_arrays(dev, 1, 40, 64, SEED + 4, heat=2.0)
    out.append(("N=1 Pc=64", nodes, pods, low, high, ones, dict(per_node_cap=1)))
    nodes, pods = desched_arrays(dev, 70, 1, 1, SEED + 5, heat=1.5)
    out.append(("N=70 Pc=1", nodes, pods, low, high, ones, {}))
    return [(f"{name} dev={d}", n, p, lo, hi, w, dict(kw, use_deviation=d,
                                                      consecutive_abnormalities=2,
                                                      consecutive_normalities=1))
            for name, n, p, lo, hi, w, kw in out for d in (False, True)]


def check_desched_cases(dev) -> int:
    """``deschedule_round`` on ``desched_cases`` against its plain version,
    three rounds each carrying the detector state (raises ``Mismatch``);
    returns the rounds checked."""
    from koordinator_tpu_torch.core.lownodeload import new_anomaly_state

    n = 0
    for name, nodes, pods, low, high, w, kw in desched_cases(dev):
        st = new_anomaly_state(nodes.usage.shape[0], dev)
        check_desched_round(name, st, nodes, pods, low, high, w, rounds=3, **kw)
        n += 3
    print(f"  deschedule_round: {n} rounds of its edge cases (equal high digits over many "
          "blocks, 64-bit keys, N = 1, Pc = 1, caps 0, 1 and unlimited, deviation off and on) "
          "equal plain", flush=True)
    return n


def check_desched_kernels(dev, timed: bool):
    """The round at the small ragged shape (300 nodes, 50 candidates in a
    bucket of 64) across deviation on/off, debounce on/off over three
    rounds, unlimited and positive caps, and a ``number_of_nodes`` gate that
    stops the round; with ``timed``, at bench/bench_sim.py's shape (10,000
    nodes x 20,000 candidates in a bucket of 32,768, caps 8 and 4,096),
    without and with deviation mode.  Returns the timed record."""
    w = torch.tensor([1, 2], dtype=torch.int64, device=dev)
    low = torch.tensor([30.0, 40.0], dtype=torch.float64, device=dev)
    high = torch.tensor([60.0, 80.0], dtype=torch.float64, device=dev)
    from koordinator_tpu_torch.core.lownodeload import new_anomaly_state

    if not timed:
        nodes, pods = desched_arrays(dev, 300, 50, 64, SEED)
        st = new_anomaly_state(300, dev)
        evictions = 0
        for dev_mode in (False, True):
            for cons in (1, 2):
                for caps in ((-1, -1), (2, 5)):
                    want, _ = check_desched_round(
                        f"300x64 dev={dev_mode} cons={cons} caps={caps}", st, nodes, pods, low,
                        high, w, rounds=3, use_deviation=dev_mode, consecutive_abnormalities=cons,
                        consecutive_normalities=1, per_node_cap=caps[0], total_cap=caps[1])
                    evictions += int(want.evicted.sum())
        gated, _ = check_desched_round("300x64 number_of_nodes=299", st, nodes, pods, low, high,
                                       w, consecutive_abnormalities=1, number_of_nodes=299)
        if not evictions or gated.evicted.any() or not gated.source.any():
            fail(f"deschedule_round small: {evictions} evictions, the gate left "
                 f"{int(gated.evicted.sum())}")
        print(f"  deschedule_round at 300 nodes x 50 candidates (bucket 64): 8 variants over 3 "
              f"rounds equal plain ({evictions} evictions), the number_of_nodes gate stops "
              "the round")
        return None
    nodes, pods = desched_arrays(dev, NUM_NODES, 20_000, 32_768, SEED, heat=1.1, unsched=0.05,
                                 valid=1.0)
    want, rec = check_desched_round(
        "bench_sim 10000x32768", new_anomaly_state(NUM_NODES, dev), nodes, pods, low, high,
        torch.tensor([1, 1], dtype=torch.int64, device=dev), timed=True,
        consecutive_abnormalities=1, per_node_cap=8, total_cap=4096)
    print(f"  deschedule_round at {NUM_NODES} nodes x 20,000 candidates (bucket 32,768, caps 8 "
          f"and 4,096): equal plain, {int(want.evicted.sum())} evictions, {rec['ms']:.3f} ms "
          f"(plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.5f} ms); device ms by "
          "kernel group " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      sorted(rec["device_split_ms"].items())), flush=True)
    # deviation mode at the same shape: the thresholds' mean is one thread a
    # resource folding the 10,000 node percents in node order (the "other"
    # group of the split), thresholds at the mean -10 / +10
    off = torch.tensor([10.0, 10.0], dtype=torch.float64, device=dev)
    dwant, drec = check_desched_round(
        "bench_sim 10000x32768 deviation", new_anomaly_state(NUM_NODES, dev), nodes, pods, off,
        off, torch.tensor([1, 1], dtype=torch.int64, device=dev), timed=True,
        use_deviation=True, consecutive_abnormalities=1, per_node_cap=8, total_cap=4096)
    if not dwant.evicted.any():
        fail("deschedule_round bench_sim deviation: no evictions")
    rec.update(ms_deviation=drec["ms"], plain_ms_deviation=drec["plain_ms"],
               device_split_ms_deviation=drec["device_split_ms"])
    print(f"  deschedule_round in deviation mode at the same shape (mean -10/+10): equal plain, "
          f"{int(dwant.evicted.sum())} evictions, {drec['ms']:.3f} ms (plain "
          f"{drec['plain_ms']:.3f} ms); device ms by kernel group "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(drec["device_split_ms"].items())),
          flush=True)
    return rec


def band_arrays(dev, P: int, seed: int, usage: bool):
    """PodSorter keys of P pods with ties on every key: few distinct values
    a column, create times among 0.0, -0.0, 1.5, -2.0 and NaN."""
    from koordinator_tpu_torch.core.deschedule import BandKeys

    rng = np.random.default_rng(seed)

    def col(vals, dtype):
        return torch.as_tensor(np.asarray(rng.choice(vals, size=P)), dtype=dtype).to(dev)

    return BandKeys(
        col([1, 2, 3, 4, 5], torch.int8), col([0, 1000, 9000, 9500, -5], torch.int64),
        col([1, 2, 3], torch.int8), col([1, 2, 3, 4, 5], torch.int8),
        col([-5, 0, 3, 1 << 40], torch.int64), col([-(1 << 62), -1, 0, 2], torch.int64),
        col([0.0, -0.0, 1.5, -2.0, float("nan")], torch.float64),
        col([-3, 0, 7, 1 << 50], torch.int64) if usage else None,
    )


def band_passes(keys) -> tuple:
    """(words, passes) of csrc/bandrank.cu's plan for ``keys``, mirrored on
    the host: each key column mapped to its unsigned order key less its
    minimum, the constant ones dropped, the rest packed minor first into
    64-bit words while their widths fit, and an 8-bit pass for each digit
    of a word's width that is not one value over every pod."""
    from koordinator_tpu_torch.core.deschedule import _band_columns

    mapped = []
    for neg, c in _band_columns(keys):
        a = c.cpu().numpy()
        if a.dtype == np.float64:
            x = -a
            x = np.where(x == 0.0, 0.0, x)
            b = x.view(np.uint64)
            k = np.where(b >> np.uint64(63), ~b, b | np.uint64(1 << 63))
            k = np.where(np.isnan(x), np.uint64(0xFFF8000000000000), k)
        else:
            v = a.astype(np.int64).view(np.uint64)
            k = ((np.uint64(0) - v) if neg else v) ^ np.uint64(1 << 63)
        mapped.append(k.astype(np.uint64))
    words, cur, used = [], None, 0
    for k in mapped:
        k = k - k.min()
        wd = int(k.max()).bit_length()
        if not wd:
            continue
        if cur is not None and used + wd > 64:
            words.append((cur, used))
            cur, used = None, 0
        cur = (k << np.uint64(used)) if cur is None else cur | (k << np.uint64(used))
        used += wd
    if cur is not None:
        words.append((cur, used))
    passes = 0
    for v, wd in words:
        for d in range(-(-wd // 8)):
            digit = (v >> np.uint64(8 * d)) & np.uint64(255)
            passes += int(digit.min() != digit.max())
    return len(words), passes


def band_cases(dev) -> list:
    """(label, keys) of ``pod_band_rank``'s edge cases: one pod; every key
    constant; keys whose spreads fit one composite word; keys that do not
    (int64 extremes); ``-(1 << 63)`` in the negated usage column (it
    wraps); -0.0, 0.0 and NaN creation times among equal keys; and on the
    card the one-block limit (``cuda.BAND_SMALL_MAX``) less one, at it and
    one above, with and without usage."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core.deschedule import BandKeys

    rng = np.random.default_rng(SEED + 60)

    def keys(P, prio, prio_c, k8s, qos, dele, evict, ct, usage=None):
        def t(a, dtype):
            return torch.as_tensor(np.broadcast_to(np.asarray(a), (P,)).copy(),
                                   dtype=dtype).to(dev)
        return BandKeys(t(prio_c, torch.int8), t(prio, torch.int64), t(k8s, torch.int8),
                        t(qos, torch.int8), t(dele, torch.int64), t(evict, torch.int64),
                        t(ct, torch.float64), None if usage is None else t(usage, torch.int64))

    def small(P):
        return rng.integers(-3, 4, P)

    out = [("one pod", keys(1, 7, 2, 1, 3, -4, 9, 1.5, 12)),
           ("every key constant", keys(300, 5, 1, 2, 3, 0, 0, 2.5, 7)),
           ("one composite word", keys(300, small(300) * 100, small(300), small(300) % 3,
                                       small(300) % 4, small(300), small(300),
                                       rng.choice([0.0, -0.0, 1.0, float("nan")], 300))),
           ("int64 extremes", keys(300, rng.choice([-(1 << 63), (1 << 63) - 1, 0], 300),
                                   small(300), 1, 2, rng.integers(-(1 << 62), 1 << 62, 300),
                                   rng.choice([-(1 << 63), (1 << 63) - 1], 300),
                                   rng.standard_normal(300) * 1e300,
                                   rng.choice([-(1 << 63), 5, (1 << 63) - 1], 300))),
           ("-(1 << 63) negated, -0.0 and NaN", keys(
               257, 0, 1, 1, 1, 0, 0, rng.choice([0.0, -0.0, float("nan"), -1.0], 257),
               rng.choice([-(1 << 63), 0, 3], 257)))]
    if dev.type == "cuda":  # the launches' sizes; the plain version takes any
        for P in (cuda.BAND_SMALL_MAX - 1, cuda.BAND_SMALL_MAX, cuda.BAND_SMALL_MAX + 1):
            for usage in (False, True):
                out.append((f"P = {P}, usage {usage}", band_arrays(dev, P, SEED + P, usage)))
    return out


def check_band_cases(dev) -> int:
    """``pod_band_rank`` on ``band_cases`` against its plain version
    (exact); returns the cases checked."""
    from koordinator_tpu_torch.core import deschedule as ds

    cases = band_cases(dev)
    for label, keys in cases:
        require_equal(f"pod_band_rank {label}", (ds.pod_band_rank(keys),),
                      (ds.pod_band_rank_plain(keys),))
    print(f"  pod_band_rank: {len(cases)} edge cases (one pod, constant keys, one composite "
          "word, int64 extremes, -(1 << 63) negated, -0.0/NaN, the one-block limit -1, 0, +1) "
          "equal plain", flush=True)
    return len(cases)


def check_band_kernels(dev, timed: bool):
    """``pod_band_rank`` against its plain version at P = 64 and 32,768,
    with and without the usage key, ties on every key; returns the record
    at 32,768 without usage when ``timed``."""
    from koordinator_tpu_torch.core import deschedule as ds

    rec = None
    for P in (64, 32_768) if timed else (64,):
        for usage in (False, True):
            keys = band_arrays(dev, P, SEED + P, usage)
            err = require_equal(f"pod_band_rank P={P} usage={usage}",
                                (ds.pod_band_rank(keys),), (ds.pod_band_rank_plain(keys),))
            if timed and P > 64 and not usage:
                # this run's passes (band_passes), a few operations an element each
                _, passes = band_passes(keys)
                b, by = bound_ms(nbytes(*keys[:7]) + 8 * P, P * 6 * (passes + len(keys) - 1))
                rec = dict(name="pod_band_rank", source=BAND_SOURCE,
                           replaces="koordinator_tpu/core/deschedule.py:223",
                           ms=cuda_ms(lambda: ds.pod_band_rank(keys)),
                           plain_ms=cuda_ms(lambda: ds.pod_band_rank_plain(keys)), bound_ms=b,
                           bound_by=by, max_abs_err=err, shape=f"{P} pods",
                           device_split_ms=device_split(lambda: ds.pod_band_rank(keys),
                                                        DESCHED_GROUPS))
    print(f"  pod_band_rank at P = {'64 and 32,768' if timed else '64'}, with and without "
          "usage, ties on every key: equal plain"
          + (f", {rec['ms']:.3f} ms at 32,768 (plain {rec['plain_ms']:.3f} ms); device ms by "
             "kernel group " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         sorted(rec["device_split_ms"].items()))
             if rec else ""), flush=True)
    return rec


def drive_library_path(device, num_nodes: int, num_pods: int):
    """The LoadAware plugin's library entry point as its users call it:
    the snapshot builders over ``random_cluster``, then
    ``core.loadaware_score_and_filter`` on the card, held against the same
    call on the CPU.  Returns (launches per kernel during the call, wall
    ms)."""
    from koordinator_tpu_torch import convert, cuda
    from koordinator_tpu_torch.core import loadaware_score_and_filter
    from koordinator_tpu_torch.core.config import LoadAwareArgs
    from koordinator_tpu_torch.snapshot import loadaware as la_snap
    from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster

    args = LoadAwareArgs()
    pods, nodes = random_cluster(SEED, num_nodes=num_nodes, num_pods=num_pods)
    arrays = (la_snap.build_pod_arrays(pods, args), la_snap.build_node_arrays(nodes, args, NOW),
              la_snap.build_weights(args))

    def call(dev):
        pa, na, w = arrays
        return loadaware_score_and_filter(convert.la_pods(pa, dev), convert.la_nodes(na, dev),
                                          convert.weights(w, dev))

    for k in cuda.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    scores, feasible = call(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    ref = call(torch.device("cpu"))
    require_equal("loadaware_score_and_filter (library call)", (scores, feasible), ref)
    if tuple(scores.shape) != (num_pods, num_nodes) or not scores.any() or not feasible.any():
        fail(f"loadaware_score_and_filter returned {tuple(scores.shape)}")
    print(f"  loadaware_score_and_filter over {num_pods} pods x {num_nodes} nodes from the "
          f"snapshot builders: {wall:.1f} ms wall (upload included), equal to the CPU; "
          f"launches {launches['loadaware_score_and_filter']}")
    return launches, wall


SIDECAR_PATH_KERNELS = ("score", "la_score", "nf_score", "schedule_keys_con",
                        "schedule_rounds_con", "quota_limit", "rsv_score", "quota",
                        "dstate_gate")
SIDECAR_PROBES = 8


def sidecar_frames(num_nodes: int, num_pods: int) -> list:
    """The sidecar phase's frames, (label, frame bytes): HELLO; APPLY of
    ``random_cluster``'s fleet (node specs, metrics, assigned pods) in
    frames of about 1,000 ops, then ``con_store``'s gangs, quota groups and
    reservations; SCORE of the batch with ``breakdown``; SCHEDULE; APPLY of
    100 metric updates and SCHEDULE again (the warm start); SCHEDULE with
    ``assume``; SCHEDULE and EXPLAIN of the probe pods; QUOTA_REFRESH, PING, ECHO of a
    [1,024, 16,384] int16 reply; a verb of a later slice (METRICS)."""
    from koordinator_tpu_torch.service import protocol as proto
    from koordinator_tpu_torch.service.client import Client
    from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster, random_pod

    M = proto.MsgType
    out = []
    req = iter(range(1, 1 << 20))

    def frame(label, t, fields, arrays=None):
        out.append((label, proto.encode(t, next(req), fields, arrays)))

    frame("HELLO", M.HELLO, {})
    _, fleet = random_cluster(SEED, num_nodes=num_nodes, num_pods=0)
    ops = []
    for n in fleet:
        ops.append(Client.op_upsert(proto.spec_only(n)))
        if n.metric is not None:
            ops.append(Client.op_metric(n.name, n.metric))
        ops += [Client.op_assign(n.name, ap) for ap in n.assigned_pods]
    for i in range(0, len(ops), 1000):
        frame("APPLY fleet", M.APPLY, {"ops": ops[i:i + 1000]})
    total, groups, gangs, reservations = con_objects(num_nodes)
    frame("APPLY constraints", M.APPLY, {"ops": (
        [Client.op_quota_total(total)] + [Client.op_quota(g) for g in groups]
        + [Client.op_gang(g) for g in gangs] + [Client.op_reservation(r) for r in reservations])})
    batch = [proto.pod_to_wire(p) for p in con_batch(num_pods, "side", SEED + 21)]
    frame("SCORE breakdown", M.SCORE, {"pods": batch, "now": NOW, "names_version": -1,
                                       "breakdown": True})
    frame("SCHEDULE", M.SCHEDULE, {"pods": batch, "now": NOW + 1, "names_version": 1})
    rng = np.random.default_rng(SEED + 22)
    updates = []
    for j in rng.choice(num_nodes, 100, replace=False):
        n = fleet[int(j)]
        if n.metric is not None and n.metric.node_usage:
            m = type(n.metric)(node_usage={k: v * 3 // 4 for k, v in n.metric.node_usage.items()},
                               update_time=NOW + 1, report_interval=60.0)
            updates.append(Client.op_metric(n.name, m))
    frame("APPLY 100 metrics", M.APPLY, {"ops": updates})
    # the warm start over the wire: the same batch after the metric updates
    frame("SCHEDULE warm", M.SCHEDULE, {"pods": batch, "now": NOW + 2, "names_version": 1})
    frame("SCHEDULE assume", M.SCHEDULE, {"pods": batch, "now": NOW + 3, "names_version": 1,
                                          "assume": True})
    probes = []
    for i in range(SIDECAR_PROBES):
        p = random_pod(np.random.default_rng([SEED, 23, i]), f"probe-{i}", "pending")
        if i % 2:
            p.quota = f"bq{i}"
        if i % 4 == 1:
            p.reservations = [reservations[i].name]
        probes.append(proto.pod_to_wire(p))
    frame("SCHEDULE probes", M.SCHEDULE, {"pods": probes, "now": NOW + 4, "names_version": -1})
    frame("EXPLAIN", M.EXPLAIN, {"pods": probes, "now": NOW + 4})
    frame("QUOTA_REFRESH", M.QUOTA_REFRESH, {
        "groups": [proto.quota_group_to_wire(g) for g in groups],
        "resources": ["cpu", "memory"], "total": total})
    frame("PING", M.PING, {})
    frame("ECHO", M.ECHO, {"resp_like": [{"name": "scores", "shape": [1024, 16384],
                                          "dtype": "<i2"}]})
    frame("METRICS (refused)", M.METRICS, {})
    return out


# the descheduler's configuration on the wire, as an operator sets it:
# one pool over the fleet (LowNodeLoad thresholds in percent, the anomaly
# debounce at 2), the defaultevictor/arbitrator knobs, the controllerfinder
# feed of the ReplicaSets the owned pods belong to
DESCHED_POOL = {"name": "fleet", "low": {"cpu": 30, "memory": 30},
                "high": {"cpu": 80, "memory": 80}, "abnormalities": 2}
DESCHED_EVICTOR = {"max_per_node": 2, "max_per_workload": 2}
DESCHED_TOTAL = 32
DESCHED_DRY_TICKS = 3


def desched_frames(names, workloads: int, seed: int) -> list:
    """The descheduler's frames, (label, frame bytes), for a store that holds
    the nodes ``names``: APPLY of one ReplicaSet-owned pod a node (the
    ``workloads`` ReplicaSets round-robin over the nodes, each pod asking
    200-2,000 mCPU and 256 MiB-4 GiB: the evictable population; the
    fixture's own pods have no owner, and the defaultevictor keeps bare
    pods), in frames of 1,000 ops; then DESCHEDULE ticks with
    ``DESCHED_POOL``, ``DESCHED_EVICTOR`` and the workloads feed: three dry
    runs (the debounce turns over-utilised nodes into sources on the
    third), one dry run with ``verify``, and one executing tick with
    ``limits.total`` = ``DESCHED_TOTAL``."""
    from koordinator_tpu_torch.api.model import AssignedPod, Pod
    from koordinator_tpu_torch.service import protocol as proto
    from koordinator_tpu_torch.service.client import Client
    from koordinator_tpu_torch.utils.fixtures import NOW

    M = proto.MsgType
    rng = np.random.default_rng(seed)
    out = []
    req = iter(range(1 << 20, 1 << 21))

    def frame(label, t, fields):
        out.append((label, proto.encode(t, next(req), fields)))

    ops = []
    for i, name in enumerate(names):
        w = i % workloads
        pod = Pod(name=f"wl{w}-{i}", namespace="apps", owner_uid=f"wl-{w}",
                  owner_kind="ReplicaSet",
                  requests={"cpu": int(rng.integers(200, 2001)),
                            "memory": int(rng.integers(256, 4097)) << 20})
        ops.append(Client.op_assign(name, AssignedPod(pod=pod, assign_time=NOW)))
    for i in range(0, len(ops), 1000):
        frame("APPLY owned pods", M.APPLY, {"ops": ops[i:i + 1000]})
    replicas = [len(range(w, len(names), workloads)) for w in range(workloads)]
    config = {"pools": [DESCHED_POOL], "evictor": DESCHED_EVICTOR,
              "workloads": {f"wl-{w}": r for w, r in enumerate(replicas)}}
    for t in range(DESCHED_DRY_TICKS):
        frame(f"DESCHEDULE dry {t + 1}", M.DESCHEDULE, dict(config, now=NOW + 10 * (t + 1)))
    frame("DESCHEDULE verify", M.DESCHEDULE, {"now": NOW + 40, "verify": True})
    frame("DESCHEDULE execute", M.DESCHEDULE, {"now": NOW + 50, "verify": False,
                                               "execute": True,
                                               "limits": {"total": DESCHED_TOTAL}})
    return out


class Wire:
    """One raw connection to a sidecar: frame bytes in, reply bytes out."""

    def __init__(self, addr):
        import socket

        self.sock = socket.create_connection(addr, timeout=600)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def call(self, frame: bytes) -> bytes:
        from koordinator_tpu_torch.service import protocol as proto

        proto.write_frame(self.sock, frame)
        t, r, payload = proto.read_frame(self.sock)
        return proto._HDR.pack(proto.MAGIC, proto.VERSION, t, r, len(payload)) + bytes(payload)

    def close(self):
        self.sock.close()


def decoded(reply: bytes):
    from koordinator_tpu_torch.service import protocol as proto

    t, r = proto._HDR.unpack_from(reply, 0)[2:4]
    return proto.decode((t, r, memoryview(reply)[proto._HDR.size:]))


def drive_sidecar_path(device, num_nodes: int, num_pods: int, scalars):
    """The sidecar over a socket at full width: the port's ``SidecarServer``
    on the card and a twin on the CPU, each on port 0, sent the same raw
    frames (``sidecar_frames``) one at a time.  Replies must be
    byte-identical; ERROR frames carry a traceback, so those compare by
    code and message.  The breakdown SCORE must launch ``la_score`` and
    ``nf_score`` once each; EXPLAIN's chosen nodes and totals must equal
    the probe SCHEDULE's reply.  Then the descheduler path over the same
    sidecars (``drive_desched_path``).  Returns (launches per kernel during
    the phase's frames, per-verb records with the card's wall ms on the
    client's clock, the descheduler path's result)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.service import protocol as proto
    from koordinator_tpu_torch.service.server import SidecarServer
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    M = proto.MsgType
    t0 = time.perf_counter()
    frames = sidecar_frames(num_nodes, num_pods)
    print(f"  {len(frames)} frames ({sum(len(f) for _, f in frames) / 1e6:.1f} MB) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    card = SidecarServer(initial_capacity=16, extra_scalars=scalars, device=device)
    twin = SidecarServer(initial_capacity=16, extra_scalars=scalars, device="cpu")
    records, replies = [], {}
    _, fleet = random_cluster(SEED, num_nodes=num_nodes, num_pods=0)
    try:
        cw, tw = Wire(card.address), Wire(twin.address)
        for k in cuda.KERNELS.values():
            k.launches = 0
        for label, frame in frames:
            before = {name: k.launches for name, k in cuda.KERNELS.items()}
            t0 = time.perf_counter()
            got = cw.call(frame)
            wall = (time.perf_counter() - t0) * 1e3
            delta = {name: k.launches - before[name] for name, k in cuda.KERNELS.items()
                     if k.launches != before[name]}
            t0 = time.perf_counter()
            want = tw.call(frame)
            twin_wall = (time.perf_counter() - t0) * 1e3
            gt, _, gf, ga = decoded(got)
            wt, _, wf, _ = decoded(want)
            if gt == M.ERROR or wt == M.ERROR:
                if (gt, gf.get("code"), gf.get("error")) != (wt, wf.get("code"), wf.get("error")):
                    fail(f"sidecar {label}: card {gf}, CPU twin {wf}")
                if not label.endswith("(refused)"):
                    fail(f"sidecar {label}: ERROR {gf.get('error')}")
            elif got != want:
                fail(f"sidecar {label}: the card's reply differs from the CPU twin's")
            replies[label] = (gt, gf, ga)
            records.append(dict(verb=label, ms=wall, twin_ms=twin_wall, bytes=len(got),
                                launches=delta))
        launches = {name: k.launches for name, k in cuda.KERNELS.items()}
        desched = drive_desched_path(device, card, twin, cw, tw, [n.name for n in fleet])
        cw.close()
        tw.close()
    finally:
        card.close()
        twin.close()
    rec = next(r for r in records if r["verb"] == "SCORE breakdown")
    if device.type == "cuda" and (rec["launches"].get("la_score") != 1
                                  or rec["launches"].get("nf_score") != 1):
        fail(f"the breakdown SCORE launched {rec['launches']}")
    _, sf, sa = replies["SCORE breakdown"]
    if sf["breakdown_plugins"] != ["loadaware", "nodefit"] or sa["scores"].shape != (
            num_pods, num_nodes) or not sa["breakdown_nodefit"].any():
        fail(f"the breakdown SCORE's reply: {sf.get('breakdown_plugins')}, "
             f"{sa['scores'].shape}")
    warm = next(r for r in records if r["verb"] == "SCHEDULE warm")["launches"]
    cold = warm.get("schedule_keys_con") or not (warm.get("sched_refresh_con")
                                                 or warm.get("sched_rounds_con"))
    if device.type == "cuda" and cold:
        fail(f"the SCHEDULE after the metric updates was not a warm start: {warm}")
    _, pf, pa = replies["SCHEDULE probes"]
    _, ef, _ = replies["EXPLAIN"]
    names = pf["names"]
    want_nodes = [names[h] if h >= 0 else None for h in pa["hosts"].tolist()]
    got_nodes = [e["node"] for e in ef["explain"]]
    if got_nodes != want_nodes or [e["total"] for e in ef["explain"]] != pa["scores"].tolist():
        fail(f"EXPLAIN {got_nodes} does not equal the SCHEDULE reply {want_nodes}")
    placed = {lab: int((replies[lab][2]["hosts"] >= 0).sum())
              for lab in ("SCHEDULE", "SCHEDULE assume", "SCHEDULE warm", "SCHEDULE probes")}
    if not all(placed.values()):
        fail(f"a sidecar SCHEDULE placed nothing: {placed}")
    applies = [r for r in records if r["verb"].startswith("APPLY fleet")]
    print(f"  APPLY fleet: {len(applies)} frames, {sum(r['ms'] for r in applies):.0f} ms on the "
          f"card's sidecar ({sum(r['twin_ms'] for r in applies):.0f} ms the twin's)")
    for r in records:
        if not r["verb"].startswith("APPLY fleet"):
            print(f"  {r['verb']}: {r['ms']:.1f} ms wall on the card's sidecar (twin "
                  f"{r['twin_ms']:.1f} ms), {r['bytes']} reply bytes, launches {r['launches']}",
                  flush=True)
    print(f"  placed: {placed}; EXPLAIN of {len(got_nodes)} probes equals their SCHEDULE")
    return launches, records, desched


DESCHED_PATH_KERNELS = ("deschedule_round", "pod_band_rank")


def drive_desched_path(device, card, twin, cw, tw, names):
    """The descheduler over the wire, after the sidecar phase's frames: the
    same ``desched_frames`` to the card's sidecar and the CPU twin, replies
    byte-identical, each tick's launches counted from 0 (one
    ``deschedule_round`` for the pool, one ``pod_band_rank`` per
    arbitration of a non-empty job list), its wall time on the client's
    clock and its split.  The last dry run, the verify tick and the
    executing tick must plan, and the executing tick must move pods.
    Returns (launches during the path, per-tick records, the pool's round
    inputs at the fleet's shape after the last tick)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core.lownodeload import as_tensors
    from koordinator_tpu_torch.service import protocol as proto
    from koordinator_tpu_torch.utils.fixtures import NOW

    M = proto.MsgType
    frames = desched_frames(names, max(len(names) // 100, 2), SEED + 31)
    print(f"  descheduler path: {len(names)} nodes, one owned pod a node in "
          f"{max(len(names) // 100, 2)} ReplicaSets", flush=True)
    for k in cuda.KERNELS.values():
        k.launches = 0
    records = []
    for label, frame in frames:
        before = {name: k.launches for name, k in cuda.KERNELS.items()}
        t0 = time.perf_counter()
        got = cw.call(frame)
        wall = (time.perf_counter() - t0) * 1e3
        delta = {name: k.launches - before[name] for name, k in cuda.KERNELS.items()
                 if k.launches != before[name]}
        t0 = time.perf_counter()
        want = tw.call(frame)
        twin_wall = (time.perf_counter() - t0) * 1e3
        gt, _, gf, _ = decoded(got)
        if gt == M.ERROR or decoded(want)[0] == M.ERROR:
            fail(f"descheduler {label}: ERROR {gf.get('error')} / {decoded(want)[2].get('error')}")
        if got != want:
            fail(f"descheduler {label}: the card's reply differs from the CPU twin's")
        if gt != M.DESCHEDULE:
            continue
        d, dt = card._descheduler, twin._descheduler
        if device.type == "cuda" and (delta.get("deschedule_round") != 1 or delta.get(
                "pod_band_rank", 0) != d.last_arbitrations):
            fail(f"descheduler {label}: launches {delta}, {d.last_arbitrations} arbitrations")
        records.append(dict(verb=label, ms=wall, twin_ms=twin_wall, bytes=len(got),
                            launches=delta, plan=len(gf["plan"]), executed=gf["executed"],
                            split_ms={k: v * 1e3 for k, v in d.last_split.items()},
                            twin_split_ms={k: v * 1e3 for k, v in dt.last_split.items()}))
        r = records[-1]
        print(f"  {label}: {wall:.1f} ms wall on the card's sidecar (twin {twin_wall:.1f} ms), "
              f"plan {r['plan']}, executed {r['executed']}; split "
              + ", ".join(f"{k} {v:.1f}" for k, v in r["split_ms"].items())
              + " ms (twin " + ", ".join(f"{k} {v:.1f}" for k, v in r["twin_split_ms"].items())
              + f" ms); launches {delta}", flush=True)
    planned = {r["verb"]: r["plan"] for r in records}
    if not (planned[f"DESCHEDULE dry {DESCHED_DRY_TICKS}"] and planned["DESCHEDULE verify"]
            and planned["DESCHEDULE execute"]) or not records[-1]["executed"]:
        fail(f"the descheduler planned {planned} and executed {records[-1]['executed']}")
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    d = card._descheduler
    pool = d.pools[0]
    nodes, pods, pool_names, _ = d._pool_arrays(pool, NOW + 60)
    state = d._detector_state(pool, pool_names)
    fleet_round = dict(state=as_tensors(state, device), nodes=as_tensors(nodes, device),
                       pods=as_tensors(pods, device),
                       low=torch.tensor([float(pool.low_pct.get(r, 100.0)) for r in d.resources],
                                        dtype=torch.float64, device=device),
                       high=torch.tensor([float(pool.high_pct.get(r, 100.0))
                                          for r in d.resources], dtype=torch.float64,
                                         device=device),
                       weights=torch.ones(len(d.resources), dtype=torch.int64, device=device),
                       kw=dict(use_deviation=pool.use_deviation,
                               consecutive_abnormalities=pool.consecutive_abnormalities,
                               consecutive_normalities=pool.consecutive_normalities,
                               number_of_nodes=pool.number_of_nodes))
    return launches, records, fleet_round


SHARD_SOURCE = "koordinator_tpu_torch/csrc/score.cu"
METRICSAGG_SOURCE = "koordinator_tpu_torch/csrc/metricsagg.cu"
KOORDLET_SHARDS = 4


SENTINEL = -(1 << 40)  # a total no pair scores


def sentinel_buffers(P: int, N: int, dev) -> tuple:
    """[P, N] totals and feasibility buffers filled with a sentinel (a total
    no pair scores, every pair feasible), so a column no block wrote
    shows."""
    return (torch.full((P, N), SENTINEL, dtype=torch.int64, device=dev),
            torch.ones((P, N), dtype=torch.bool, device=dev))


def mesh_blocks(fn, inp, static, extra, S: int, out=None):
    """One ``[P, N]`` evaluation as S mesh blocks on the inputs' device
    through ``fn`` (``shard_score_map`` or its plain version), into ``out``
    (default fresh ``sentinel_buffers``)."""
    from koordinator_tpu_torch.service.sharding import shard_bounds

    P, N = inp["la_pods"].est.shape[0], inp["valid"].shape[0]
    totals, feasible = out if out is not None else sentinel_buffers(P, N, inp["valid"].device)
    for lo, hi in shard_bounds(N, S):
        fn(inp["la_pods"], inp["la_nodes"], inp["weights"], inp["nf_pods"], inp["nf_nodes"],
           static, inp["valid"], extra, lo, hi, totals, feasible)
    return totals, feasible


def check_shard_kernels(inp, shard_counts, timed: bool):
    """``shard_score_map`` against its plain version on the same device,
    the S blocks merged, under LeastAllocated, MostAllocated and both RTC
    shapes, with and without extra scores, at each shard count; the merged
    output also against the unsharded ``score`` kernel.  Returns the record
    at the last shard count when ``timed`` (LeastAllocated, no extras; the
    other variants' times beside it)."""
    from koordinator_tpu_torch.core.cycle import score_fn
    from koordinator_tpu_torch.service import sharding as sh

    P, N = inp["la_pods"].est.shape[0], inp["valid"].shape[0]
    _, extra = scan_extras(inp, SEED + 41)
    statics = [("least", inp["static"])] + strategy_statics(inp["static"])
    err, variants, bufs = 0, {}, {}

    def fill():
        # the sentinel buffers, allocated and filled outside the timed span
        bufs["out"] = sentinel_buffers(P, N, inp["valid"].device)

    for name, static in statics:
        for x in (None, extra):
            want = score_fn(inp["la_pods"], inp["la_nodes"], inp["weights"], inp["nf_pods"],
                            inp["nf_nodes"], static, inp["valid"], x)
            for S in shard_counts:
                what = f"shard_score_map {name} S={S} extras={x is not None} {P}x{N}"
                got = mesh_blocks(sh.shard_score_map, inp, static, x, S)
                err = max(err, require_equal(what, got,
                                             mesh_blocks(sh.shard_score_map_plain, inp, static,
                                                         x, S)))
                require_equal(what + " against the unsharded score kernel", got, want)
                del got
                for lo, hi in sh.shard_bounds(N, S):
                    # the block alone: its columns, and no other column written
                    alone = sentinel_buffers(P, N, inp["valid"].device)
                    sh.shard_score_map(inp["la_pods"], inp["la_nodes"], inp["weights"],
                                       inp["nf_pods"], inp["nf_nodes"], static, inp["valid"], x,
                                       lo, hi, *alone)
                    require_equal(f"{what} block [{lo}, {hi}) alone",
                                  (alone[0][:, lo:hi], alone[1][:, lo:hi]),
                                  (want[0][:, lo:hi], want[1][:, lo:hi]))
                    if not (bool((alone[0][:, :lo] == SENTINEL).all())
                            and bool((alone[0][:, hi:] == SENTINEL).all())
                            and bool(alone[1][:, :lo].all()) and bool(alone[1][:, hi:].all())):
                        fail(f"{what} block [{lo}, {hi}) alone wrote outside its columns")
                    del alone
            if timed:
                S = shard_counts[-1]
                variants[f"{name}{'+extras' if x is not None else ''}"] = cuda_ms(
                    lambda: mesh_blocks(sh.shard_score_map, inp, static, x, S, bufs["out"]),
                    setup=fill)
    print(f"  shard_score_map at {P} x {N}, S in {list(shard_counts)}, four strategy shapes, "
          "with and without extras: equal plain and the unsharded score kernel, each block "
          "alone writing only its columns", flush=True)
    if not timed:
        return None
    S = shard_counts[-1]
    static = inp["static"]
    la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
    ops = pair_ops(la_pods.est.shape[1], nf_pods.req.shape[1], nf_pods.req_score.shape[1])
    b, by = bound_ms(nbytes(*la_pods, *nf_pods, *inp["la_nodes"], *inp["nf_nodes"], inp["valid"])
                     + P * N * 9, P * N * ops)
    return dict(
        name="shard_score_map", source=SHARD_SOURCE,
        replaces="koordinator_tpu/service/sharding.py:480",
        ms=cuda_ms(lambda: mesh_blocks(sh.shard_score_map, inp, static, None, S, bufs["out"]),
                   setup=fill),
        plain_ms=cuda_ms(lambda: mesh_blocks(sh.shard_score_map_plain, inp, static, None, S,
                                             bufs["out"]), setup=fill),
        score_ms=cuda_ms(lambda: score_fn(la_pods, inp["la_nodes"], inp["weights"], nf_pods,
                                          inp["nf_nodes"], static, inp["valid"])),
        bound_ms=b, bound_by=by, max_abs_err=err, shape=f"{P} pods x {N} columns, {S} blocks",
        variants=variants,
    )


# blocks of N = 300 a ``shard_score_map`` case launches alone: the last two
# blocks of ``shard_bounds(300, 3)`` (offsets 100 and 200, off the score
# kernel's 128-column tiles), and a block of 53 columns inside one tile
SHARD_CASE_BLOCKS = ((100, 200), (200, 300), (37, 90))


def shard_cases(dev) -> list:
    """(name, inputs, lo, hi) of ``shard_score_map``'s blocks launched alone:
    P = 1 and P = 65 (a strip boundary) at the serving widths over each of
    ``SHARD_CASE_BLOCKS``, and the generic instantiation (R = 3) at two
    blocks."""
    out = []
    for P in (1, 65):
        inp = synthetic_inputs(dev, SEED + 50 + P, P, 300, 2, 3, 2)
        out += [(f"P={P} [{lo}, {hi})", inp, lo, hi) for lo, hi in SHARD_CASE_BLOCKS]
    gen = synthetic_inputs(dev, SEED + 60, 65, 300, 3, 4, 3, bypass=(False, True, True))
    out += [(f"generic 3x4x3 P=65 [{lo}, {hi})", gen, lo, hi) for lo, hi in ((100, 200), (37, 90))]
    return out


def check_shard_cases(dev) -> int:
    """Each of ``shard_cases`` under LeastAllocated, MostAllocated and both
    RTC shapes, without and with extra scores: the block written alone into
    ``sentinel_buffers`` equals its plain version written alone the same
    way, its columns equal the unsharded plain ``score_batch``'s and every
    other column keeps its sentinel (raises ``Mismatch``); returns the
    blocks checked."""
    from koordinator_tpu_torch.core.cycle import PluginWeights, score_batch
    from koordinator_tpu_torch.service import sharding as sh

    n = 0
    for name, inp, lo, hi in shard_cases(dev):
        la_pods, nf_pods = inp["la_pods"], inp["nf_pods"]
        la_nodes, nf_nodes, valid, w = (inp["la_nodes"], inp["nf_nodes"], inp["valid"],
                                        inp["weights"])
        P, N = la_pods.est.shape[0], valid.shape[0]
        xsc = torch.as_tensor(np.random.default_rng(SEED + n).integers(
            -100, 201, (P, N)).astype(np.int64)).to(dev)
        for sname, static in [("least", inp["static"])] + strategy_statics(inp["static"]):
            t, f = score_batch(la_pods, la_nodes, w, nf_pods, nf_nodes, static, PluginWeights())
            f = f & valid[None, :]
            for extras in (None, xsc):
                what = f"shard_score_map case {name} {sname} extras={extras is not None}"
                got, want = sentinel_buffers(P, N, dev), sentinel_buffers(P, N, dev)
                sh.shard_score_map(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid,
                                   extras, lo, hi, *got)
                sh.shard_score_map_plain(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid,
                                         extras, lo, hi, *want)
                require_equal(what, got, want)
                full = t if extras is None else t + extras
                require_equal(what + ": the block's columns against score_batch",
                              (got[0][:, lo:hi], got[1][:, lo:hi]),
                              (full[:, lo:hi], f[:, lo:hi]))
                keep = torch.ones(N, dtype=torch.bool, device=dev)
                keep[lo:hi] = False
                if not (bool((got[0][:, keep] == SENTINEL).all())
                        and bool(got[1][:, keep].all())):
                    fail(f"{what}: a column outside [{lo}, {hi}) lost its sentinel")
                n += 1
    print(f"  shard_score_map: {n} blocks alone (offsets 100 and 200 of 300, 53 columns "
          "inside a tile, P 1 and 65, the generic widths) x strategies x extras equal plain, "
          "every other column its sentinel", flush=True)
    return n


GATE_CASE_ROWS = (1, 257, 1001)
# (exp, fexp) of the gate's cases: an expiry, with and without the filters
# following it, none, 0 and negative (no expiry test, NaN still expired)
GATE_MODES = ((180, True), (180, False), (None, True), (0, True), (-5, True))


def gate_case_rows(dev, n: int, seed: int, now: float, exp: float = 180.0) -> list:
    """The 12 raw LoadAware rows of ``n`` nodes made with numpy from
    ``seed``, with update times at NaN, at the expiry boundary, just inside
    and just outside it, ahead of the clock, in turn, then random."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    ints = lambda: t(rng.integers(0, 1 << 40, size=(n, 2), dtype=np.int64))  # noqa: E731
    bools = lambda: t(rng.random(n) < 0.6)  # noqa: E731
    ut = now - rng.uniform(0, 400, size=n)
    special = (np.nan, now - exp, np.nextafter(now - exp, np.inf),
               np.nextafter(now - exp, -np.inf), now + 3.0)
    for i in range(min(n, 40)):
        ut[i] = special[i % len(special)]
    return [ints(), ints(), ints(), bools(), t(ut), ints(), bools(), ints(), ints(), bools(),
            ints(), bools()]


def gate_fault_cases(dev, rows: int = 1001) -> dict:
    """The public ``dstate_gate`` on rows the kernel must not read through a
    stale or base pointer, each beside the plain version on the same rows:
    ``strided``, the five gated rows as columns of [N, 3] tables; ``set_``
    and ``resize_``, a bound update-time and has-metric row moved to new
    storage with new values under the same tensor between two calls.
    Returns case -> "equal", "differs" or "refused: <the ValueError>"."""
    from koordinator_tpu_torch.service import state as sm

    now = 1_000_010.25
    out = {}

    def verdict(raw):
        want = sm.dstate_gate_plain(raw, now, 180, True)
        try:
            got = sm.dstate_gate(raw, now, 180, True)
        except ValueError as e:
            return f"refused: {e}"
        try:
            require_same("gate", got, want)
        except Mismatch:
            return "differs"
        return "equal"

    raw = gate_case_rows(dev, rows, SEED + 40, now)
    strided = list(raw)
    for k in (3, 4, 6, 9, 11):
        wide = torch.stack([raw[k].flip(0), raw[k], ~raw[k] if raw[k].dtype == torch.bool
                            else raw[k] - 400.0], dim=1)
        strided[k] = wide[:, 1]
    out["strided"] = verdict(strided)
    for move in ("set_", "resize_"):
        raw = [t.clone() for t in gate_case_rows(dev, rows, SEED + 41, now)]
        first = verdict(raw)
        fresh = gate_case_rows(dev, rows, SEED + 42, now - 150.0)
        for k in (3, 4):
            if move == "set_":
                raw[k].set_(fresh[k].clone())
            else:
                raw[k].resize_(64 * rows)
                raw[k].resize_(rows)
                raw[k].copy_(fresh[k])
        out[move] = verdict(raw) if first == "equal" else f"first call {first}"
    return out


def check_gate_cases(dev) -> int:
    """``dstate_gate`` at each of ``GATE_CASE_ROWS`` in every mode of
    ``GATE_MODES`` against its plain version, bit for bit; then rebound to
    other rows of the same shape (and their update times moved) and back,
    and through a ``GateStage`` of its own bound to each set in turn
    (raises ``Mismatch``); returns the calls checked."""
    from koordinator_tpu_torch.service import state as sm

    n = 0
    now = 1_000_010.25
    for rows in GATE_CASE_ROWS:
        raw = gate_case_rows(dev, rows, SEED + rows, now)
        other = gate_case_rows(dev, rows, SEED + rows + 1, now + 7.0)
        stage = sm.GateStage()
        for what, r in (("rows", raw), ("other rows", other), ("rows again", raw)):
            binds = stage.binds
            stage.bind(r)
            if stage.binds != binds + 1:
                fail("a GateStage bind did not count")
            for e, fexp in GATE_MODES:
                want = sm.dstate_gate_plain(r, now, e, fexp)
                require_same(f"dstate_gate {rows} {what} exp={e} fexp={fexp}",
                             sm.dstate_gate(r, now, e, fexp), want)
                require_same(f"GateStage {rows} {what} exp={e} fexp={fexp}",
                             stage.gate(now, e, fexp), want)
                n += 1
    faults = gate_fault_cases(dev)
    if not faults["strided"].startswith("refused") or any(
            faults[m] != "equal" for m in ("set_", "resize_")):
        fail(f"dstate_gate on strided or moved rows: {faults}")
    print(f"  dstate_gate: {n} calls (rows {list(GATE_CASE_ROWS)}, exp modes "
          f"{[m[0] for m in GATE_MODES]}, rebound and back) equal plain; strided rows "
          f"refused, rows moved by set_ and resize_ equal plain", flush=True)
    return n


def agg_series(dev, S: int, T: int, seed: int):
    """(values, valid, times) of S series of T samples on ``dev``: integer
    and fractional samples, and edge rows up front — NaN and ±0.0 samples,
    an all -0.0 row, an empty row, counts 20 and 10 (the float32 index of
    p95 and p90), tied and NaN times."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 40, (S, T)).astype(np.float64)
    v[S // 2:] = rng.random((S - S // 2, T)) * 1e4
    valid = rng.random((S, T)) < 0.7
    t = rng.integers(0, 40, (S, T)).astype(np.float64)
    v[0, :6] = [0.0, -0.0, np.nan, -np.nan, 1.0, -0.0]
    v[1], valid[1] = -0.0, True
    valid[2] = False
    for row, cnt in ((3, 20), (4, 10), (5, 1)):
        valid[row] = False
        valid[row, rng.choice(T, min(cnt, T), replace=False)] = True
    t[6] = np.nan
    t[7] = 5.0
    return tuple(torch.from_numpy(a).to(dev) for a in (v, valid, t))


def agg_bound(valid) -> tuple:
    """The aggregation's bound, what these inputs need whatever implements
    them: every valid byte read once, the value and time of each valid
    sample (16 bytes), the [6, S] output written once (48 bytes a series).
    An invalid sample is 0.0 in the mean and 1e300 in the order, and needs
    no load; the order statistics need no operation a byte does not
    outweigh, so no sort is counted."""
    S, T = valid.shape
    return bound_ms(S * T + 16 * int(valid.sum()) + 48 * S, 0)


def check_metricsagg_kernels(dev, windows=(), timed: bool = False):
    """``aggregate_node_metrics`` against its plain version on the same
    device, bit for bit: 64 series x 64 samples with the edge rows of
    ``agg_series``, and each (label, values, valid, times) window of
    ``windows``.  Returns the record at the largest window when
    ``timed``."""
    from koordinator_tpu_torch.core import metricsagg as ma

    args = agg_series(dev, 64, 64, SEED + 51)
    require_same("aggregate_node_metrics 64x64", (ma.aggregate_node_metrics(*args),),
                 (ma.aggregate_node_metrics_plain(*args),))
    for label, *w in windows:
        require_same(f"aggregate_node_metrics {label} {tuple(w[0].shape)}",
                     (ma.aggregate_node_metrics(*w),), (ma.aggregate_node_metrics_plain(*w),))
    print("  aggregate_node_metrics at 64 x 64 (empty series, NaN, ±0.0, tied times, counts 20 "
          "and 10)" + "".join(f", {lab} {tuple(w[0].shape)}" for lab, *w in windows)
          + ": equal plain, bit for bit", flush=True)
    if not timed or not windows:
        return None
    label, *w = max(windows, key=lambda x: x[1].shape[0])
    S, T = w[0].shape
    b, by = agg_bound(w[1])
    groups = (("agg_", "kernel"),)
    return dict(
        name="aggregate_node_metrics", source=METRICSAGG_SOURCE,
        replaces="koordinator_tpu/core/metricsagg.py:54",
        ms=cuda_ms(lambda: ma.aggregate_node_metrics(*w)),
        device_ms=device_split(lambda: ma.aggregate_node_metrics(*w), groups).get("kernel"),
        plain_ms=cuda_ms(lambda: ma.aggregate_node_metrics_plain(*w)),
        bound_ms=b, bound_by=by, max_abs_err=0, shape=f"{label}: {S} series x {T} samples",
        variants={lab: dict(ms=cuda_ms(lambda x=x: ma.aggregate_node_metrics(*x)),
                            device_ms=device_split(lambda x=x: ma.aggregate_node_metrics(*x),
                                                   groups).get("kernel"),
                            bound_ms=agg_bound(x[1])[0])
                  for lab, *x in windows},
    )


AGG_WIDTHS = (1, 33, 256, 257, 2048)  # the warp kernel's and the block kernel's
AGG_COUNTS = (0, 1, 32, 33, 256)  # valid samples: the compaction's boundaries


def agg_cases(dev) -> list:
    """``aggregate_node_metrics``'s edge cases, (what, values, valid,
    times): at each T of ``AGG_WIDTHS``, 64 series with the counts of
    ``AGG_COUNTS`` (as far as T allows), a contiguous arc of 7, a valid
    1e300, +inf and NaN among six (the full sort), valid times of -inf
    (the last taken from an invalid sample) and of -1e300 (tied with the
    invalid samples' time, the first index wins), integer samples with ties and
    fractional ones, invalid samples holding NaN, 1e308 and -0.0; and the
    windows of a ``MetricSeriesStore`` whose valid arc wraps its ring (60
    s and 1,800 s over 256 columns after 262 ticks)."""
    from koordinator_tpu_torch.service.koordlet import MetricSeriesStore

    rng = np.random.default_rng(SEED + 81)
    out = []
    for T in AGG_WIDTHS:
        S = 64
        v = rng.integers(-50, 50, (S, T)).astype(np.float64)
        v[S // 2:] = rng.uniform(-5e3, 5e3, (S - S // 2, T))
        t = rng.integers(0, 40, (S, T)).astype(np.float64)
        valid = rng.random((S, T)) < 0.5
        rows = iter(range(S))
        for c in AGG_COUNTS:
            r = next(rows)
            valid[r] = False
            valid[r, rng.choice(T, min(c, T), replace=False)] = True
        r = next(rows)
        valid[r] = False
        valid[r, (rng.integers(T) + np.arange(min(7, T))) % T] = True
        for big in (1e300, np.inf, np.nan):
            r = next(rows)
            pick = rng.choice(T, min(6, T), replace=False)
            valid[r] = False
            valid[r, pick] = True
            v[r, pick[-1]] = big
        r = next(rows)
        t[r, valid[r]] = -np.inf
        r = next(rows)
        t[r, valid[r]] = -1e300  # ties the invalid samples' time: the first index wins
        v[~valid] = rng.choice([np.nan, 1e308, -0.0], int((~valid).sum()))
        out.append((f"T={T}", v, valid, t))
    store = MetricSeriesStore(window=KOORDLET_TICKS)
    keys = [f"node/n{i}/cpu" for i in range(40)]
    for k in range(KOORDLET_TICKS + 6):
        store.append(1e6 + KOORDLET_CADENCE * k,
                     dict(zip(keys, rng.integers(0, 4000, len(keys)).tolist())))
    now = 1e6 + KOORDLET_CADENCE * (KOORDLET_TICKS + 5)
    for dur in (60.0, 1800.0):
        out.append((f"store window {int(dur)} s, the arc wrapping the ring",
                    *store.window(now, dur, keys)))
    return [(what, *(torch.from_numpy(a).to(dev) for a in arrays)) for what, *arrays in out]


def check_agg_cases(dev) -> None:
    """``aggregate_node_metrics`` on ``agg_cases`` against its plain version,
    bit for bit."""
    from koordinator_tpu_torch.core import metricsagg as ma

    for what, *w in agg_cases(dev):
        require_same(f"aggregate_node_metrics {what}",
                     (ma.aggregate_node_metrics(*w),), (ma.aggregate_node_metrics_plain(*w),))
    print(f"  aggregate_node_metrics at T in {list(AGG_WIDTHS)} (counts {list(AGG_COUNTS)}, an "
          "arc, a valid 1e300, +inf and NaN, times of -inf) and store windows wrapping the "
          "ring: equal plain, bit for bit", flush=True)


KOORDLET_TICKS = 256
KOORDLET_CADENCE = 10.0
KOORDLET_SECOND_TICK = 10  # one koordlet in this many reports between the two SCHEDULEs


def koordlet_fleet(num_nodes: int):
    """``random_cluster``'s fleet (about 3.3 assigned pods a node) with
    every node's custom aggregated-usage thresholds on its 300-s p95
    window (cpu 70%, memory 85%), so the produced windows decide
    feasibility."""
    from koordinator_tpu_torch.api.model import AggregationType
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    _, nodes = random_cluster(SEED, num_nodes=num_nodes, num_pods=0, pods_per_node=12)
    for n in nodes:
        n.has_custom_annotation = True
        n.custom_agg_usage_thresholds = {"cpu": 70, "memory": 85}
        n.custom_agg_type = AggregationType.P95
        n.custom_agg_duration = 300.0
    return nodes


def fleet_series(prod, nodes, seed: int):
    """The fleet's series and a collection tick: (node keys, pods by node,
    ``tick(store, now)``).  A tick samples each node's cpu and memory (a
    per-node base level, noise, and on a third of the nodes a spike every
    seventh tick) and each assigned pod's, as integers."""
    rng = np.random.default_rng(seed)
    keys, caps, pods_by_node = [], [], {}
    for n in nodes:
        for r in ("cpu", "memory"):
            keys.append(prod.node_key(n.name, r))
            caps.append(n.allocatable[r])
        pods_by_node[n.name] = [ap.pod.key for ap in n.assigned_pods]
    node_keys = len(keys)
    for n in nodes:
        for ap in n.assigned_pods:
            for r in ("cpu", "memory"):
                keys.append(prod.pod_key(n.name, ap.pod.key, r))
                caps.append(max(ap.pod.requests.get(r, 0), 1000 if r == "cpu" else 1 << 28))
    caps = np.asarray(caps, dtype=np.float64)
    base = rng.uniform(0.1, 0.6, caps.size)
    spiky = np.flatnonzero(np.repeat(rng.random(len(nodes)) < 1 / 3, 2))
    count = [0]

    def tick(store, now: float) -> None:
        frac = base + rng.normal(0.0, 0.05, caps.size)
        if count[0] % 7 == 0:
            frac[spiky] += 0.35
        count[0] += 1
        store.append(now, dict(zip(keys, np.floor(np.clip(frac, 0.0, 1.2) * caps).tolist())))

    return keys[:node_keys], pods_by_node, tick


def koordlet_frames(nodes, metrics, second, num_pods: int) -> list:
    """The path's frames, (label, frame bytes): HELLO; APPLY of the node
    specs and assigned pods in frames of about 1,000 ops; APPLY of the
    produced NodeMetrics; SCORE of the batch; SCHEDULE; APPLY of the second
    report tick's NodeMetrics; SCHEDULE again (the warm start); SCHEDULE
    with ``assume``."""
    from koordinator_tpu_torch.service import protocol as proto
    from koordinator_tpu_torch.service.client import Client
    from koordinator_tpu_torch.utils.fixtures import NOW, random_pod

    M = proto.MsgType
    out = []
    req = iter(range(1 << 21, 1 << 22))

    def frame(label, t, fields):
        out.append((label, proto.encode(t, next(req), fields)))

    def apply(label, ops):
        for i in range(0, len(ops), 1000):
            frame(label, M.APPLY, {"ops": ops[i:i + 1000]})

    frame("HELLO", M.HELLO, {})
    ops = []
    for n in nodes:
        ops.append(Client.op_upsert(proto.spec_only(n)))
        ops += [Client.op_assign(n.name, ap) for ap in n.assigned_pods]
    apply("APPLY fleet", ops)
    apply("APPLY NodeMetrics", [Client.op_metric(name, m) for name, m in metrics.items()])
    rng = np.random.default_rng(SEED + 61)
    batch = [proto.pod_to_wire(random_pod(rng, f"kl-pending-{i}", "pending"))
             for i in range(num_pods)]
    frame("SCORE", M.SCORE, {"pods": batch, "now": NOW + 1, "names_version": -1})
    frame("SCHEDULE", M.SCHEDULE, {"pods": batch, "now": NOW + 2, "names_version": 1})
    apply("APPLY second tick", [Client.op_metric(name, m) for name, m in second.items()])
    frame("SCHEDULE warm", M.SCHEDULE, {"pods": batch, "now": NOW + 62, "names_version": 1})
    frame("SCHEDULE assume", M.SCHEDULE, {"pods": batch, "now": NOW + 63, "names_version": 1,
                                          "assume": True})
    return out


KOORDLET_PATH_KERNELS = ("aggregate_node_metrics", "shard_score_map", "score", "schedule_keys",
                         "schedule_rounds", "sched_refresh", "sched_rounds", "dstate_scatter")


def same_metrics(a: dict, b: dict) -> bool:
    def view(m):
        return (m.node_usage, m.update_time, m.report_interval, m.pods_usage,
                {d: {k.value: v for k, v in x.items()} for d, x in m.aggregated.items()})

    return a.keys() == b.keys() and all(view(a[n]) == view(b[n]) for n in a)


def fleet_store(device, num_nodes: int):
    """The koordlet path's store: ``koordlet_fleet``'s nodes, a
    ``MetricSeriesStore`` of ``KOORDLET_TICKS`` columns filled with as many
    collection ticks ``KOORDLET_CADENCE`` s apart, ending at ``NOW``, and a
    producer on ``device``.  Returns (nodes, store, producer, node keys,
    pods by node, the collection tick)."""
    from koordinator_tpu_torch.service.koordlet import MetricSeriesStore, NodeMetricProducer
    from koordinator_tpu_torch.utils.fixtures import NOW

    nodes = koordlet_fleet(num_nodes)
    store = MetricSeriesStore(window=KOORDLET_TICKS)
    prod = NodeMetricProducer(store, device=device)
    node_keys, pods_by_node, tick = fleet_series(prod, nodes, SEED + 62)
    for t in range(KOORDLET_TICKS):
        tick(store, NOW - KOORDLET_CADENCE * (KOORDLET_TICKS - 1 - t))
    return nodes, store, prod, node_keys, pods_by_node, tick


def report_windows(prod, node_keys, pods_by_node) -> list:
    """The windows one report tick aggregates, (label, duration, series
    keys): the node series over the report interval and each aggregate
    duration, then the pod series over the report interval."""
    pod_keys = [prod.pod_key(n, pk, r) for n, pks in pods_by_node.items() for pk in pks
                for r in prod.resources]
    return ([(f"node window {int(d)} s", d, node_keys)
             for d in [prod.report_interval] + prod.aggregate_durations]
            + [(f"pod window {int(prod.report_interval)} s", prod.report_interval, pod_keys)])


def drive_koordlet_path(device, num_nodes: int, num_pods: int, scalars):
    """The koordlet's reports into a sharded sidecar at full width: a
    ``MetricSeriesStore`` fed ``KOORDLET_TICKS`` collection ticks for the
    fleet's nodes and assigned pods; ``NodeMetricProducer.produce`` on the
    card and on a CPU twin (equal NodeMetrics); the metrics as APPLY to
    the card's sidecar with ``shards=4``, a CPU twin with ``shards=4`` and
    an unsharded card sidecar, then SCORE and three SCHEDULEs (every reply
    of the sharded two byte-identical, and past HELLO equal to the
    unsharded one's); then the mesh in process: ``ShardedEngine(shard_map=
    True, devices=[card] * 4)`` against slice mode on a twin store.  The
    counts are 0 at the start and read at the end.  Returns (launches, the
    stage records, the fleet windows for the kernel checks)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import AggregationType
    from koordinator_tpu_torch.service import protocol as proto
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.service.koordlet import NodeMetricProducer
    from koordinator_tpu_torch.service.server import SidecarServer
    from koordinator_tpu_torch.service.sharding import ShardedEngine
    from koordinator_tpu_torch.service.state import ClusterState
    from koordinator_tpu_torch.service.wireops import apply_wire_ops
    from koordinator_tpu_torch.utils.fixtures import NOW

    M = proto.MsgType
    stages = {}
    for k in cuda.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    nodes, store, prod, node_keys, pods_by_node, tick = fleet_store(device, num_nodes)
    twin_prod = NodeMetricProducer(store, device="cpu")
    stages["fill_ms"] = (time.perf_counter() - t0) * 1e3
    n_series = len(store._imap)
    print(f"  store: {n_series} series ({len(node_keys)} node, {n_series - len(node_keys)} pod) x "
          f"{KOORDLET_TICKS} ticks filled in {stages['fill_ms'] / 1e3:.1f} s", flush=True)
    # one report tick's stages as produce runs them, timed apart (their
    # launches are not the path's): each window built on the host, then the
    # kernel with its upload and its one read-back
    windows = []
    with uncounted():
        for label, dur, keys in report_windows(prod, node_keys, pods_by_node):
            t0 = time.perf_counter()
            w = store.window(NOW, dur, keys)
            build = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            prod._aggregate(*w)
            stages[label] = dict(build_ms=build, kernel_ms=(time.perf_counter() - t0) * 1e3)
            windows.append((label, *(torch.from_numpy(a).to(device) for a in w)))
    names = [n.name for n in nodes]
    t0 = time.perf_counter()
    metrics = prod.produce(NOW, names, pods_by_node)
    stages["produce_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with uncounted():
        want = twin_prod.produce(NOW, names, pods_by_node)
    stages["produce_twin_ms"] = (time.perf_counter() - t0) * 1e3
    if not same_metrics(metrics, want):
        fail("the card's NodeMetrics differ from the CPU twin's")
    hot = sum(m.aggregated[300.0][AggregationType.P95]["cpu"] > 0.7 * n.allocatable["cpu"]
              for n in nodes for m in (metrics[n.name],))
    print(f"  produce: {len(metrics)} NodeMetrics in {stages['produce_ms']:.0f} ms on the card "
          f"({stages['produce_twin_ms']:.0f} ms the CPU twin's), equal; window build + kernel "
          + ", ".join(f"{k} {v['build_ms']:.0f} + {v['kernel_ms']:.0f} ms"
                      for k, v in stages.items() if isinstance(v, dict))
          + f"; the 300-s p95 cpu over 70% on {hot} nodes", flush=True)
    # the second report tick: six more collection ticks, and a tenth of the
    # koordlets report before the next SCHEDULE
    for t in range(1, 7):
        tick(store, NOW + KOORDLET_CADENCE * t)
    reporting = names[::KOORDLET_SECOND_TICK]
    second = prod.produce(NOW + 60, reporting, {n: pods_by_node[n] for n in reporting})
    with uncounted():
        if not same_metrics(second, twin_prod.produce(NOW + 60, reporting,
                                                      {n: pods_by_node[n] for n in reporting})):
            fail("the card's second-tick NodeMetrics differ from the CPU twin's")
    frames = koordlet_frames(nodes, metrics, second, num_pods)
    card = SidecarServer(initial_capacity=16, extra_scalars=scalars, device=device,
                         shards=KOORDLET_SHARDS)
    twin = SidecarServer(initial_capacity=16, extra_scalars=scalars, device="cpu",
                         shards=KOORDLET_SHARDS)
    solo = SidecarServer(initial_capacity=16, extra_scalars=scalars, device=device)
    records, replies = [], {}
    try:
        wires = [Wire(s.address) for s in (card, twin, solo)]
        for label, frame in frames:
            before = {name: k.launches for name, k in cuda.KERNELS.items()}
            t0 = time.perf_counter()
            got = wires[0].call(frame)
            wall = (time.perf_counter() - t0) * 1e3
            delta = {name: k.launches - before[name] for name, k in cuda.KERNELS.items()
                     if k.launches != before[name]}
            t0 = time.perf_counter()
            want = wires[1].call(frame)
            twin_wall = (time.perf_counter() - t0) * 1e3
            with uncounted():
                t0 = time.perf_counter()
                alone = wires[2].call(frame)
                solo_wall = (time.perf_counter() - t0) * 1e3
            gt, _, gf, ga = decoded(got)
            if gt == M.ERROR or decoded(want)[0] == M.ERROR or decoded(alone)[0] == M.ERROR:
                fail(f"koordlet path {label}: ERROR {gf.get('error')}")
            if got != want:
                fail(f"koordlet path {label}: the sharded card sidecar's reply differs from the "
                     "CPU twin's")
            if label == "HELLO":
                if gf.get("shards") != KOORDLET_SHARDS or "shards" in decoded(alone)[2]:
                    fail(f"HELLO advertises shards {gf.get('shards')}")
            elif got != alone:
                fail(f"koordlet path {label}: the sharded sidecar's reply differs from the "
                     "unsharded card sidecar's")
            replies[label] = (gt, gf, ga)
            records.append(dict(verb=label, ms=wall, twin_ms=twin_wall, solo_ms=solo_wall,
                                bytes=len(got), launches=delta))
        for w in wires:
            w.close()
        se = card._serving_engine()
        if not isinstance(se, ShardedEngine) or se.num_shards != KOORDLET_SHARDS:
            fail("the sharded sidecar did not serve through a ShardedEngine")
    finally:
        for s in (card, twin, solo):
            s.close()
    warm = next(r for r in records if r["verb"] == "SCHEDULE warm")["launches"]
    if device.type == "cuda" and (warm.get("schedule_keys") or not warm.get("sched_rounds")):
        fail(f"the SCHEDULE after the second report tick was not a warm start: {warm}")
    placed = {lab: int((replies[lab][2]["hosts"] >= 0).sum())
              for lab in ("SCHEDULE", "SCHEDULE warm", "SCHEDULE assume")}
    _, sf, sa = replies["SCORE"]
    feasible = np.unpackbits(sa["feasible"], axis=1)[:, : sf["num_live"]]
    if not all(placed.values()) or feasible.all() or not feasible.any():
        fail(f"the sharded sidecar placed {placed}, {int(feasible.sum())} feasible pairs")
    applies = [r for r in records if r["verb"].startswith("APPLY")]
    print(f"  APPLY: {len(applies)} frames, {sum(r['ms'] for r in applies):.0f} ms on the card's "
          f"sharded sidecar ({sum(r['twin_ms'] for r in applies):.0f} ms the twin's, "
          f"{sum(r['solo_ms'] for r in applies):.0f} ms the unsharded one's)")
    for r in records:
        if not r["verb"].startswith("APPLY"):
            print(f"  {r['verb']}: {r['ms']:.1f} ms wall on the card's sharded sidecar (twin "
                  f"{r['twin_ms']:.1f} ms, unsharded {r['solo_ms']:.1f} ms), {r['bytes']} reply "
                  f"bytes, launches {r['launches']}", flush=True)
    print(f"  placed: {placed}; {int(feasible.sum())} of {feasible.size} pairs feasible; every "
          "reply equals the CPU twin's and the unsharded sidecar's", flush=True)

    # the mesh, in process: two stores fed the same frames' ops
    from koordinator_tpu_torch.utils.fixtures import random_pod

    ops = [op for label, f in frames if label.startswith("APPLY")
           for op in decoded(f)[2]["ops"]]
    rng = np.random.default_rng(SEED + 61)
    batch = [random_pod(rng, f"kl-pending-{i}", "pending") for i in range(num_pods)]
    sides = []
    for mesh in (True, False):
        st = ClusterState(extra_scalars=scalars)
        apply_wire_ops(st, ops)
        eng = Engine(st, device=device)
        sides.append(ShardedEngine(st, KOORDLET_SHARDS, engine=eng, shard_map=mesh,
                                   devices=[device] * KOORDLET_SHARDS if mesh else None))
    mesh_se, slice_se = sides
    before = cuda.SHARD_SCORE_MAP.launches
    t0 = time.perf_counter()
    got = mesh_se.score(batch, now=NOW + 64)
    stages["mesh_score_ms"] = (time.perf_counter() - t0) * 1e3
    if device.type == "cuda" and cuda.SHARD_SCORE_MAP.launches - before != KOORDLET_SHARDS:
        fail(f"the mesh SCORE launched shard_score_map "
             f"{cuda.SHARD_SCORE_MAP.launches - before} times")
    with uncounted():
        t0 = time.perf_counter()
        want = slice_se.score(batch, now=NOW + 64)
        stages["slice_score_ms"] = (time.perf_counter() - t0) * 1e3
    require_equal("mesh SCORE against slice mode", got[:2], want[:2])
    for i, assume in enumerate((False, True)):
        t0 = time.perf_counter()
        h, s, snap, al = mesh_se.schedule(batch, now=NOW + 65 + i, assume=assume)
        stages[f"mesh_schedule{'_assume' if assume else ''}_ms"] = (time.perf_counter() - t0) * 1e3
        with uncounted():
            rh, rs, rsnap, ral = slice_se.schedule(batch, now=NOW + 65 + i, assume=assume)
        require_equal(f"mesh SCHEDULE assume={assume} against slice mode", (h, s), (rh, rs))
        if al != ral or list(snap.names) != list(rsnap.names):
            fail(f"mesh SCHEDULE assume={assume}: allocation records differ from slice mode")
    if store_view(mesh_se.state) != store_view(slice_se.state):
        fail("the mesh's store after assume differs from slice mode's")
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    print(f"  mesh (shard_map, {KOORDLET_SHARDS} x {device}): SCORE {stages['mesh_score_ms']:.0f} "
          f"ms (slice mode {stages['slice_score_ms']:.0f} ms), SCHEDULE "
          f"{stages['mesh_schedule_ms']:.0f} ms, with assume "
          f"{stages['mesh_schedule_assume_ms']:.0f} ms; equal to slice mode; launches on the "
          f"path {launches}", flush=True)
    return launches, dict(stages=stages, verbs=records, placed=placed), windows



# the round loop's semantically neutral knobs: (block_size, commit_cap)
ROUND_KNOBS = ((16, 16), (16, 64), (64, 16), (64, 64))


def probe_inputs(inp, P: int = 16):
    """The descheduler's one-pod probe: one real pod in the engine's
    smallest pod bucket (16), over the inputs' node columns."""
    cut = lambda nt: type(nt)(*(a[:P] for a in nt))  # noqa: E731
    dev = inp["valid"].device
    return dict(inp, la_pods=cut(inp["la_pods"]), nf_pods=cut(inp["nf_pods"]),
                order=torch.arange(P, device=dev), p_real=1)


def round_case(inp, BS: int, K: int, what: str, con: bool = False, wide: bool = False,
               extras: bool = False, timed: bool = False, reps: int = 5,
               study: bool = False) -> dict:
    """One launch of the round loop (``schedule_rounds``) on the inputs'
    cold keys against its plain version on the same keys: the outputs
    (hosts, scores, [precommit,] rounds) and the updated M and Mb, exactly;
    under ``con`` (the checks' gangs, quota tree and reservations) the
    quota and reservation inputs untouched.  ``wide`` takes the int64 key
    lane, ``extras`` the extra channel.  Returns the outputs, the rounds,
    the rounds on the quota upper bound, the grid, and with ``timed`` the
    time (events around the call, the median of ``reps``), the kernel's
    device time (``torch.profiler``, the mean of ``reps`` launches); with
    ``study`` one more launch of the study build, equal to the plain
    version too, and its phase split (``round_split``)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import resolved as rs

    xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(
        inp["la_pods"], inp["nf_pods"], inp["valid"], inp["p_real"], inp["order"])
    node = (q_la, inp["la_nodes"], inp["weights"], q_nf, inp["nf_nodes"], inp["static"],
            inp["valid"], pod_ok, salts)
    c = con_for(inp, con_inputs_for(inp, SEED + 11), xs) if con else None
    xin = rs.extra_inputs(*extras_for(inp, SEED + 23), xs) if extras else None
    tail = () if c is None else (c, 0, 8)
    M0, Mb0, feas_T = rs.schedule_keys(*node, BS, c, xin, wide)
    state0 = [] if c is None else [t.clone() for t in (c.quota.used, c.quota.npu,
                                                        c.rsv.allocated)]
    M, Mb = M0.clone(), Mb0.clone()
    got = rs.schedule_rounds(M, Mb, feas_T, *node, K, BS, *tail, xin=xin)
    Mp, Mbp = M0.clone(), Mb0.clone()
    want = rs._plain_rounds(Mp, Mbp, feas_T, *node, K, BS, *tail, xin=xin)
    require_equal(what, (*got, M, Mb), (*want, Mp, Mbp))
    if c is not None:
        for a, b in zip((c.quota.used, c.quota.npu, c.rsv.allocated), state0):
            if not torch.equal(a, b):
                fail(f"{what}: the round loop wrote its quota or reservation inputs")
    counts = want[-1].view(-1)
    P, N = M0.shape[1], inp["valid"].shape[0]
    dev = inp["valid"].device
    out = dict(outputs=got, rounds=int(counts[0]), ub_rounds=int(counts[1]) if c else 0,
               grid=cuda.rounds_grid(P, N, BS, min(K, P), cuda.sm_count(dev))
               if dev.type == "cuda" else None)
    if timed:
        work = {}

        def reset():
            work["M"], work["Mb"] = M0.clone(), Mb0.clone()

        def call():
            return rs.schedule_rounds(work["M"], work["Mb"], feas_T, *node, K, BS, *tail,
                                      xin=xin)

        out["ms"] = cuda_ms(call, reps=reps, setup=reset)
        out["device_ms"] = device_split(lambda: (reset(), call()), (("rounds_kernel", "rounds"),),
                                        reps=reps).get("rounds")
    if study:
        kernel = (cuda.SCHEDULE_ROUNDS64 if wide else cuda.SCHEDULE_ROUNDS) if c is None else (
            cuda.SCHEDULE_ROUNDS64_CON if wide else cuda.SCHEDULE_ROUNDS_CON)
        Ms, Mbs = M0.clone(), Mb0.clone()
        got_s = rs._launch_rounds(study_build(kernel.symbol, tuple(kernel.argtypes)), Ms, Mbs,
                                  feas_T, *node, K, BS, *tail, xin=xin)
        require_equal(f"{what} (study build)", (*got_s, Ms, Mbs), (*want, Mp, Mbp))
        out["split_cycles"] = round_split(dev)
    return out


@functools.lru_cache(maxsize=None)
def study_build(symbol: str, argtypes: tuple, stem: str = "roundstudy"):
    """An entry point of a study build, which no path of the port loads:
    the round loop's (csrc/roundstudy.cu: the round loop with its phase
    split compiled in, the split's read-out, a round's synchronisation
    alone) or the scan's (csrc/scanstudy.cu)."""
    from koordinator_tpu_torch import cuda

    return cuda.Kernel(stem, symbol, list(argtypes))


def round_split(dev) -> list:
    """The phase split of the study build's last round launch: [3, 8] SM
    cycles summed over the rounds, of block 0, the middle block and the
    last (csrc/schedule.cu, ``KOORD_ROUND_STUDY``)."""
    from koordinator_tpu_torch import cuda

    words = torch.zeros(24, dtype=torch.int64, device=dev)
    study_build("koord_round_split", (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)).launch(
        words.data_ptr(), cuda.device_index(dev), cuda.stream(dev))
    return words.view(3, 8).cpu().tolist()


def split_us(cycles, device_ms: float, rounds: int) -> list:
    """The split as microseconds a round: each phase's share of block 0's
    summed cycles (block 0's phases cover its whole loop) times the
    uninstrumented kernel's device time a round."""
    us_round = device_ms * 1e3 / rounds
    total = sum(cycles[0])
    return [[v / total * us_round for v in row] for row in cycles]


def hot_node(inp):
    """The inputs with their first live node made a thousand times larger,
    empty and open to every pod: every pod picks it, so the round loop
    commits one pod a round there and each round's rescoring reads the row
    that the serial middle rewrote on another SM just before (the stale-L1
    case)."""
    j = int(torch.nonzero(inp["valid"])[0])
    la, nf = inp["la_nodes"], inp["nf_nodes"]
    P = inp["la_pods"].est.shape[0]

    def row(t, v):
        t = t.clone()
        t[j] = v
        return t

    big = lambda t: t.max(dim=0).values * 1000  # noqa: E731
    la2 = la._replace(alloc=row(la.alloc, big(la.alloc)), base_nonprod=row(la.base_nonprod, 0),
                      base_prod=row(la.base_prod, 0), score_valid=row(la.score_valid, True),
                      filter_active=row(la.filter_active, False),
                      prod_filter_active=row(la.prod_filter_active, False))
    nf2 = nf._replace(alloc=row(nf.alloc, big(nf.alloc)), requested=row(nf.requested, 0),
                      num_pods=row(nf.num_pods, 0), allowed_pods=row(nf.allowed_pods, P),
                      alloc_score=row(nf.alloc_score, big(nf.alloc_score)),
                      req_score=row(nf.req_score, 0))
    return dict(inp, la_nodes=la2, nf_nodes=nf2), j


# the round loop's cases beyond the paths' shapes, on inputs whose grid has
# many blocks (2,000 nodes cut to 1,995 columns, not a multiple of the block
# size): (pods, commit_cap, round_case keywords)
ROUND_CASES = {
    "pods not a multiple of the pod split": (1000, 16, {}),
    "one pod": (1, 16, {}),
    "commit_cap above the pods": (300, 1000, {}),
    "int64 keys": (1000, 16, dict(wide=True)),
    "int64 keys, constrained, extras": (1000, 16, dict(wide=True, con=True, extras=True)),
    "constrained": (1000, 16, dict(con=True)),
    "extra channel": (1000, 16, dict(extras=True)),
}


def check_round_case(base, case: str) -> dict:
    """One of ``ROUND_CASES`` on ``base`` (2,000 nodes, 1,000 pods) cut to
    1,995 columns and the case's pods, against the plain version; fails
    unless the grid has the case's edge (a last block owning fewer pods,
    one block for one pod) and a constrained case took the quota upper
    bound."""
    P, cap, kw = ROUND_CASES[case]
    rec = round_case(ragged(base, 1995, P), 16, cap, case, **kw)
    G = rec["grid"]
    if G is not None:
        if P == 1 and G != 1:
            fail(f"{case}: {G} blocks for one pod")
        if case == "pods not a multiple of the pod split" and not (G > 1 and P % -(-P // G)):
            fail(f"{case}: {G} blocks split {P} pods evenly")
    if kw.get("con") and rec["ub_rounds"] == 0:
        fail(f"{case}: no round took the quota upper bound")
    return rec


def check_round_hot_node(base) -> dict:
    """``hot_node`` on ``base`` cut to 1,995 columns and 300 pods: more
    than 100 pods on the one node, one a round."""
    x, j = hot_node(ragged(base, 1995, 300))
    rec = round_case(x, 16, 16, "one node every round")
    on_j = int((rec["outputs"][0] == j).sum())
    if not (on_j > 100 and rec["rounds"] >= on_j):
        fail(f"one node every round: {on_j} pods on it in {rec['rounds']} rounds")
    return rec


def check_round_loop(full, timed: bool = True, study: bool = False) -> dict:
    """The round loop under the four settings of its neutral knobs at the
    full shape: each launch equal to the plain version (hosts, scores,
    rounds and the updated M and Mb), the four placements equal, and each
    setting's time and rounds; then the plain and constrained
    instantiations at the one-pod probe.  With ``study`` (timed), each
    setting's phase split from the study build and a round's
    synchronisation alone."""
    P, N = full["la_pods"].est.shape[0], full["valid"].shape[0]
    ref, knobs = None, []
    for BS, K in ROUND_KNOBS:
        rec = round_case(full, BS, K, f"schedule_rounds {P}x{N} BS={BS} K={K}", timed=timed,
                         study=study)
        got = rec.pop("outputs")
        if ref is None:
            ref = got[:2]
        require_equal(f"schedule_rounds BS={BS} K={K} against BS=16 K=16", got[:2], ref)
        ms = rec.get("ms")
        knobs.append(dict(rec, block_size=BS, commit_cap=K,
                          us_per_round=None if ms is None else ms * 1e3 / rec["rounds"]))
        if study:
            knobs[-1]["split_us"] = split_us(rec["split_cycles"], rec["device_ms"],
                                             rec["rounds"])
        print(f"  round loop {P}x{N} BS={BS} K={K}: equal plain and the other settings, "
              f"{rec['rounds']} rounds" + ("" if ms is None else
                                           f", {ms:.3f} ms (kernel {rec['device_ms']:.3f})") +
              f", grid {rec['grid']}" + ("" if not study else
                                         f", split (us a round) {knobs[-1]['split_us']}"),
              flush=True)
    probe = probe_inputs(full)
    plain = round_case(probe, 16, 16, f"schedule_rounds probe 16x{N}", timed=timed, reps=21)
    con = round_case(probe, 16, 16, f"schedule_rounds_con probe 16x{N}", con=True, timed=timed,
                     reps=21)
    print(f"  one-pod probe 16x{N}: plain {plain['rounds']} rounds, constrained {con['rounds']}, "
          f"equal plain" + ("" if not timed else
                            f"; calls {plain['ms']:.4f} and {con['ms']:.4f} ms, kernels "
                            f"{plain['device_ms']:.4f} and {con['device_ms']:.4f} ms"), flush=True)
    out = dict(shape=[P, N], knobs=knobs,
               probe=dict(shape=[16, N], rounds=plain["rounds"], ms=plain.get("ms"),
                          device_ms=plain.get("device_ms"), grid=plain["grid"],
                          con_rounds=con["rounds"], con_ms=con.get("ms"),
                          con_device_ms=con.get("device_ms")))
    if study:
        dev = full["valid"].device
        out["sync_us"] = {G: sync_us(dev, G) for G in (1, 8, 32, 64, 128, 132)}
        print(f"  a round's synchronisation (us by blocks): {out['sync_us']}", flush=True)
    return out


def sync_us(dev, G: int, iters: int = 4096) -> float:
    """Microseconds of one round's synchronisation (every block arrives,
    block 0 waits for them and releases, the others wait for the release)
    across G blocks of the round loop's size, from the study build:
    ``iters`` of them in one launch, over a run of 5."""
    from koordinator_tpu_torch import cuda

    kernel = study_build("koord_round_sync", (ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_void_p))
    words = torch.zeros(2, dtype=torch.int32, device=dev)

    def run():
        words.zero_()
        kernel.launch(G, iters, words.data_ptr(), cuda.device_index(dev), cuda.stream(dev))

    return run_ms(run, launches=5) * 1e3 / iters


def extend_alloc_us(dev, rows: int, reps: int = 2000) -> dict:
    """Host microseconds of the two ways to allocate ``dstate_extend``'s
    outputs (the bool table to 512 columns and the int32 one to 16): a
    ``torch.empty`` each, or one allocation carved into strided views."""
    widths, dtypes = (512, 16), (torch.bool, torch.int32)
    offsets, total = (0, rows * 512), rows * (512 + 64)

    def each():
        return [torch.empty((rows, nc), dtype=d, device=dev) for nc, d in zip(widths, dtypes)]

    def carved():
        flat = torch.empty(total, dtype=torch.uint8, device=dev)
        return [flat.view(d).as_strided((rows, nc), (nc, 1), o // flat.view(d).element_size())
                for nc, d, o in zip(widths, dtypes, offsets)]

    out = {}
    for name, fn in (("each", each), ("carved", carved), ("each_again", each)):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def round_study(dev) -> int:
    """``--rounds``: the round loop's knobs with their phase split, the
    probe, a round's synchronisation and ``dstate_extend``, timed (the port
    imported from ``--root`` when given: a checkout with the study build,
    of this commit or a later one); one JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    cuda.build()
    pods, nodes = random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS)
    full = build_inputs(pods, nodes, dev, (BATCH_CPU, BATCH_MEMORY))
    study = check_round_loop(full, study=True)
    check_extend_cases(dev)
    study["dstate_extend"] = check_extend_kernel(dev, full["valid"].shape[0], timed=True)
    study["extend_alloc_us"] = extend_alloc_us(dev, full["valid"].shape[0])
    print(json.dumps({"round_study": study, "card": card_line()}))
    return 0


# ------------------------------------------------------- the scan's study

SCAN_SPLIT_PHASES = ("sweep", "decision", "commit", "rescoring")
SCAN_BLOCK_SIZES = (8, 16, 32, 64)


def sass_census(lib, key: str) -> dict:
    """A static count of the SASS of the functions of ``lib`` whose name
    holds ``key`` (``cuobjdump -sass``): per function its instructions, the
    subroutines it calls with their lengths (the pair function's only
    callee is the 64-bit division, which the listing leaves unnamed), and
    its largest loop (the widest backward branch) with the calls inside it;
    ``call_share`` is the loop's instructions inside the subroutines, each
    call counted at its subroutine's length, over all of them.  A static
    count: a subroutine's branches are not weighed."""
    import re

    from koordinator_tpu_torch import cuda

    tool = os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
    label = re.compile(r"^\s*([.$\w]+):\s*$")
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {"ins": [], "labels": {}})
            continue
        if cur is None:
            continue
        lm = label.match(line)
        if lm:
            cur["labels"][lm.group(1)] = None
            cur.setdefault("pending", []).append(lm.group(1))
            continue
        m = ins.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in cur.pop("pending", []):
                cur["labels"][name] = addr
            cur["ins"].append((addr, m.group(2)))

    def target(f, op):
        m = re.search(r"`\(([^)]*)\)", op) or re.search(r"(0x[0-9a-f]+)\s*$", op)
        if not m:
            return None
        t = m.group(1)
        return int(t, 16) if t.startswith("0x") else f["labels"].get(t)

    out = {}
    for name, f in funcs.items():
        if key not in name:
            continue
        body = f["ins"]
        calls = [(a, target(f, op), op) for a, op in body if "CALL" in op]
        subs = {}
        for _, t, op in calls:
            if t is None or t in subs:
                continue
            end = next((a for a, o in body if a >= t and o.split()[0].startswith("RET")), None)
            end = end if end is not None else t
            subs[t] = dict(name=op.split("(")[-1].rstrip(")` "), end=end,
                           length=sum(1 for a, _ in body if t <= a <= end))
        in_sub = lambda a: any(t <= a <= v["end"] for t, v in subs.items())  # noqa: E731
        loops = [(target(f, op), a) for a, op in body
                 if "BRA" in op and not in_sub(a) and target(f, op) is not None
                 and target(f, op) < a]
        lo, hi = max(loops, key=lambda r: r[1] - r[0]) if loops else (0, -1)
        n_loop = sum(1 for a, _ in body if lo <= a <= hi)
        loop_calls = [t for a, t, _ in calls if lo <= a <= hi]
        sub_ins = sum(subs[t]["length"] for t in loop_calls if t in subs)
        out[name] = dict(
            instructions=len(body),
            subroutines=[dict(name=v["name"], length=v["length"], at=hex(t))
                         for t, v in subs.items()],
            calls=len(calls), loop_instructions=n_loop, loop_calls=len(loop_calls),
            call_share=sub_ins / ((n_loop + sub_ins) or 1))
    return out


def empty_fleet(inp):
    """The inputs with every node empty (no usage, no requests, no pods):
    under MostAllocated every pod prefers the node its own request fills
    most, until it fills."""
    la, nf = inp["la_nodes"], inp["nf_nodes"]
    z = torch.zeros_like
    la2 = la._replace(base_nonprod=z(la.base_nonprod), base_prod=z(la.base_prod))
    nf2 = nf._replace(requested=z(nf.requested), num_pods=z(nf.num_pods),
                      req_score=z(nf.req_score))
    return dict(inp, la_nodes=la2, nf_nodes=nf2)


def scan_study(dev) -> int:
    """``--scan``: the scan and the key builds at the full shape, timed (the
    port imported from ``--root`` when given: a checkout of this commit or
    a later one), each scan against the plain
    ``schedule_batch`` first: under each strategy, plain and constrained,
    and MostAllocated on an empty fleet; with the package's scan study
    build, each scan's phase split and the division check; the scan under
    each block size (``SCAN_BLOCK_SIZES``, all equal); the key builds under
    each strategy and the probe's; the SASS census of the key build.  One
    JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    for stem in ("schedule", "scan"):
        log = libs[stem].with_suffix(".log")
        fn = ""
        for line in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif any(w in line for w in ("registers", "spill")) and any(
                    key in fn for key in ("build_keys", "scan")):
                print(f"  ptxas {fn[:70]}: {line.strip()}")
    pods, nodes = random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS)
    full = build_inputs(pods, nodes, dev, (BATCH_CPU, BATCH_MEMORY))
    P, N = full["la_pods"].est.shape[0], full["valid"].shape[0]
    groups = (("build_keys", "keys"), ("scan", "steps"))
    out = dict(shape=[P, N], scans=[], keys=[], block_sizes=[])
    try:
        out["div_pairs"] = check_div_helper(dev)
    except Mismatch as e:  # a tree from before the floored divisions (--root)
        out["div_fault"] = str(e)
        print(f"  the division check: {e}", flush=True)
    statics = strategy_statics(full["static"])
    cases = [(name, static, con, "salted", True, full) for name, static in statics
             for con in (False, True)]
    cases.append(("most, empty fleet", statics[0][1], False, "index", False, empty_fleet(full)))
    for name, static, con, tie, extras, inp in cases:
        case = scan_case(inp, static, con, tie, extras)
        want = case["plain"]()
        require_equal(f"{case['tag']} ({name})", case["kernel"](), want)
        rec = dict(case=name, con=con, ms=cuda_ms(case["kernel"]),
                   device_ms=device_split(case["kernel"], groups, reps=5),
                   placed=int((want[0] >= 0).sum()))
        saved = cuda.SCAN, cuda.SCAN_CON
        cuda.SCAN, cuda.SCAN_CON = (study_build(k.symbol, tuple(k.argtypes), "scanstudy")
                                    for k in saved)
        try:
            require_equal(f"{case['tag']} ({name}, study build)", case["kernel"](), want)
        finally:
            cuda.SCAN, cuda.SCAN_CON = saved
        words = torch.zeros(len(SCAN_SPLIT_PHASES), dtype=torch.int64, device=dev)
        study_build("koord_scan_split", (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p),
                    "scanstudy").launch(words.data_ptr(), cuda.device_index(dev),
                                        cuda.stream(dev))
        rec["split_cycles"] = words.cpu().tolist()
        rec["split_us"] = split_us([rec["split_cycles"]], rec["device_ms"].get("steps", 0.0),
                                   P)[0]
        out["scans"].append(rec)
        print(f"  {case['tag']} ({name}): equal plain, {rec['placed']} placed, {rec['ms']:.3f} "
              f"ms, device {rec['device_ms']}, split (us a pod: "
              f"{', '.join(SCAN_SPLIT_PHASES)}) {rec['split_us']}", flush=True)
    ref = {}
    for bs in SCAN_BLOCK_SIZES:
        for con in (False, True):
            case = scan_case(full, statics[0][1], con, "salted", True, block_size=bs)
            got = case["kernel"]()
            if con not in ref:
                ref[con] = case["plain"]()
            require_equal(f"{case['tag']} BS={bs}", got, ref[con])
            rec = dict(block_size=bs, con=con, ms=cuda_ms(case["kernel"]),
                       device_ms=device_split(case["kernel"], groups, reps=5))
            out["block_sizes"].append(rec)
            print(f"  {case['tag']} BS={bs}: equal plain, {rec['ms']:.3f} ms, device "
                  f"{rec['device_ms']}", flush=True)
    xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(
        full["la_pods"], full["nf_pods"], full["valid"], full["p_real"], full["order"])
    probe = probe_inputs(full)
    pxs, p_la, p_nf, p_salts, p_ok = rs.kernel_queue(
        probe["la_pods"], probe["nf_pods"], probe["valid"], probe["p_real"], probe["order"])
    for name, static in [("least", full["static"])] + statics:
        for con in (False, True):
            for wide in (False, True):
                c = con_for(full, con_inputs_for(full, SEED + 11), xs) if con else None
                args = (q_la, full["la_nodes"], full["weights"], q_nf, full["nf_nodes"], static,
                        full["valid"], pod_ok, salts, 16, c, None, wide)
                ms = cuda_ms(lambda: rs.schedule_keys(*args))
                out["keys"].append(dict(strategy=name, con=con, wide=wide, ms=ms))
                print(f"  key build {name}{' con' if con else ''}{' int64' if wide else ''}: "
                      f"{ms}", flush=True)
        if name == "least":
            c = con_for(probe, con_inputs_for(probe, SEED + 11), pxs)
            pargs = (p_la, probe["la_nodes"], probe["weights"], p_nf, probe["nf_nodes"], static,
                     probe["valid"], p_ok, p_salts, 16, c, None)
            out["probe_keys_ms"] = cuda_ms(lambda: rs.schedule_keys(*pargs), reps=21)
            print(f"  the probe's constrained key build (16 x {N}): {out['probe_keys_ms']:.4f} "
                  "ms", flush=True)
    try:
        out["sass"] = sass_census(libs["schedule"], "build_keys")
        for fn, rec in out["sass"].items():
            print(f"  sass {fn[:80]}: {rec['instructions']} instructions, loop "
                  f"{rec['loop_instructions']} with {rec['loop_calls']} calls (share "
                  f"{rec['call_share']:.2f}); subroutines {rec['subroutines']}", flush=True)
    except (OSError, subprocess.CalledProcessError, ValueError) as e:
        out["sass"] = f"not measured: {e}"
        print(f"  sass census: {out['sass']}", flush=True)
    print(json.dumps({"scan_study": out, "card": card_line()}))
    return 0


def spread_study(dev, reps: int = 21) -> int:
    """``--spread``: one sample of the numbers the scan's redesign must not
    move, for runs of two checkouts alternated in one call (``--root``
    imports the port from the other; every call here takes the same
    arguments in both): the key build at the full shape and at the one-pod
    probe, plain and constrained, on the int32 lane (events, the median of
    ``reps``); the int64 constrained round loop at the full shape (the
    median of 5, and its kernel's device time); and the strategies phase's
    RequestedToCapacityRatio cycles on a fresh store (SCORE and SCHEDULE,
    unchanged, ``assume``), each SCHEDULE's host wall after
    ``gc.collect(); gc.freeze()``, with the collector's ms during it.  One
    JSON line."""
    import gc

    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.core.config import NodeFitArgs, ScoringStrategyType
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    cuda.build()
    scalars = (BATCH_CPU, BATCH_MEMORY)
    full = build_inputs(*random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS), dev,
                        scalars)
    out = dict(keys={})
    for shape, inp in (("full", full), ("probe", probe_inputs(full))):
        xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(
            inp["la_pods"], inp["nf_pods"], inp["valid"], inp["p_real"], inp["order"])
        for con in (False, True):
            c = con_for(inp, con_inputs_for(inp, SEED + 11), xs) if con else None
            args = (q_la, inp["la_nodes"], inp["weights"], q_nf, inp["nf_nodes"], inp["static"],
                    inp["valid"], pod_ok, salts, 16, c, None)
            out["keys"][f"{shape}{' con' if con else ''}"] = cuda_ms(
                lambda: rs.schedule_keys(*args), reps=reps)
    rec = round_case(full, 16, 16, "schedule_rounds64_con", con=True, wide=True, timed=True)
    out["rounds64_con"] = dict(ms=rec["ms"], device_ms=rec["device_ms"], rounds=rec["rounds"])
    print(f"  key builds {out['keys']} ms; the int64 constrained round loop {rec['ms']:.3f} ms "
          f"(kernel {rec['device_ms']:.3f}, {rec['rounds']} rounds)", flush=True)
    del full
    rtc = NodeFitArgs(strategy=ScoringStrategyType.REQUESTED_TO_CAPACITY_RATIO)
    st = placement_store(scalars, NUM_NODES, nf_args=rtc)
    eng = Engine(st, device=dev)
    batch = placement_batch(NUM_NODES, NUM_PODS, "strat", SEED + 52)
    out["rtc_cycles"] = []
    with GcTimer() as gc_timer:
        for c, (name, dt, _, assume) in enumerate(RTC_CYCLES):
            st.publish(NOW + dt)
            if c == 0:
                eng.score(batch, now=NOW + dt)
            gc.collect()
            gc.freeze()
            gc_timer.take()
            t0 = time.perf_counter()
            hosts, _, _, _ = eng.schedule(batch, now=NOW + dt, assume=assume)
            wall = (time.perf_counter() - t0) * 1e3
            gc_ms = sum(gc_timer.take().values())
            gc.unfreeze()
            out["rtc_cycles"].append(dict(cycle=name, wall_ms=wall, gc_ms=gc_ms,
                                          placed=int((hosts >= 0).sum())))
            print(f"  RequestedToCapacityRatio cycle {c} ({name}): {wall:.1f} ms wall, garbage "
                  f"collector {gc_ms:.1f} ms", flush=True)
    print(json.dumps({"spread": out, "card": card_line()}))
    return 0


# ------------------------------------------------------- the --agg study

SCATTER_DIRTY = 100  # dirty rows of a warm residency sync: an index of 128


def ptxas_report(path, name: str) -> list:
    """The ``-Xptxas -v`` lines of the entry points of a built library whose
    name contains ``name``: registers, shared memory, spills."""
    log = path.with_suffix(".log")
    out, keep = [], False
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "Compiling entry function" in line:
            keep = name in line
        if keep and any(w in line for w in ("entry function", "properties", "registers", "spill",
                                            "smem")):
            out.append(line.strip())
    return out


def window_stages(ma, dev, w, reps: int = 5):
    """One window's report-tick stages after its host build, as
    ``NodeMetricProducer._aggregate`` runs them: the upload of the three
    [S, T] arrays (host clock to a synchronise), the call (CUDA events
    around one, the median of ``reps``; around a run of 20, a call), the
    kernel's own device time (``torch.profiler``) and the [6, S] read-back
    (host clock).  Returns (the device tensors, the stages)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = tuple(torch.as_tensor(a, device=dev) for a in w)
    torch.cuda.synchronize()
    upload = (time.perf_counter() - t0) * 1e3

    def call():
        return ma.aggregate_node_metrics(*x)

    ms, run = cuda_ms(call, reps=reps), run_ms(call, launches=20)
    device = device_split(call, (("agg_", "kernel"),), reps=reps).get("kernel")
    out = call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out.cpu().numpy()
    return x, dict(upload_ms=upload, ms=ms, ms_run=run, device_ms=device,
                   readback_ms=(time.perf_counter() - t0) * 1e3)


def scatter_table(dev, num_nodes: int):
    """A rows table at the fleet's width (``random_cluster``'s nodes in a
    ``ClusterState``) and ``SCATTER_DIRTY`` of its rows padded as the
    residency pads them: (store, host arrays, index)."""
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.service import state as sm
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    _, nodes = random_cluster(SEED, num_nodes=num_nodes, num_pods=0)
    st = sm.ClusterState(extra_scalars=(BATCH_CPU, BATCH_MEMORY))
    for n in nodes:
        st.upsert_node(n)
    host = [getattr(st, a) for a in sm.DeviceResidency._ROWS]
    rng = np.random.default_rng(SEED + 71)
    real = rng.choice(host[0].shape[0], SCATTER_DIRTY, replace=False).astype(np.int32)
    return st, host, padded(real)


def _stage_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` between two synchronises."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def scatter_split_staged(sm, bufs, host, idx, reps: int = 21) -> dict:
    """One scatter of the residency's entry (``ScatterStage``) split by
    stage, host medians with a synchronise between stages: the dirty rows
    gathered straight into the staging (the index check and the wait for
    the last copy included), the copy and the launch (one call into the
    library) with the event recorded behind them, and the descriptor's
    build (once per set of resident buffers); the device times of the
    copy and of the kernel (``torch.profiler``)."""
    stage = sm.ScatterStage()
    stage.bind(bufs)
    st = {}

    def gather():
        st["D"] = stage.gather(host, idx)

    def launch():
        stage.scatter(bufs, st["D"])

    out = {}
    for name, fn in (("gather", gather), ("copy_launch", launch),
                     ("descriptor", lambda: stage.bind(bufs))):
        fn()
        out[name] = _stage_ms(fn, reps)
    dev_ms = device_split(launch, (("scatter_rows", "kernel"), ("emcpy", "copy")), reps=reps)
    out["kernel_ms"], out["copy_ms"] = dev_ms.get("kernel"), dev_ms.get("copy")
    return out


def scatter_study(dev, reps: int = 21) -> dict:
    """``dstate_scatter`` at the fleet's width, 19 arrays and an index of 128
    (100 dirty rows): the call (events around one, the median of ``reps``)
    and a run of 100 back-to-back calls, beside ``index_copy_``'s; the call
    split by stage; and a warm residency sync of as many dirty rows (host
    clock to a synchronise, the stamps bumped by hand).  Each scatter is
    first held equal to the plain version."""
    from koordinator_tpu_torch.service import state as sm

    st, host, idx = scatter_table(dev, NUM_NODES)
    bufs0 = sm.dstate_rows(host, dev)
    vals = tuple(np.ascontiguousarray(h[idx]) for h in host)
    got = sm.dstate_scatter(tuple(b.clone() for b in bufs0), idx, vals)
    require_same(f"dstate_scatter D={idx.size}", got, sm.dstate_scatter_plain(
        tuple(b.clone() for b in bufs0), torch.from_numpy(idx).to(dev),
        [torch.from_numpy(v).to(dev) for v in vals]))
    bufs = tuple(b.clone() for b in bufs0)

    def call():
        return sm.dstate_scatter(bufs, idx, vals)

    def library():
        i = torch.from_numpy(idx).to(dev).long()
        return tuple(b.index_copy_(0, i, torch.from_numpy(v).to(dev)) for b, v in zip(bufs, vals))

    out = dict(D=int(idx.size), arrays=len(bufs), row_bytes=sum(
        b[0].numel() * b.element_size() for b in bufs))
    out["ms"], out["ms_run"] = cuda_ms(call, reps=reps), run_ms(call)
    out["library_ms"], out["library_ms_run"] = cuda_ms(library, reps=reps), run_ms(library)
    out["split"] = scatter_split_staged(sm, bufs, host, idx, reps)
    res = st.residency
    res._bind(dev)
    res._sync("rows")
    ver, real = st._row_ver, idx[:SCATTER_DIRTY]

    def sync():
        ver[real] = ver.max() + 1
        res._sync("rows")

    out["sync_ms"] = _stage_ms(sync, reps)
    if res.last_dirty_rows != SCATTER_DIRTY:
        fail(f"the residency synced {res.last_dirty_rows} rows, not {SCATTER_DIRTY}")
    res.verify()
    return out


def agg_study(dev, reps: int = 5) -> int:
    """``--agg``: ``aggregate_node_metrics`` at every window one report tick
    of the koordlet path aggregates (the four node windows, the pod
    window), each equal to its plain version bit for bit, with S, T, the
    median valid samples a series, the host build and the upload, kernel
    and read-back (``window_stages``); the ``-Xptxas -v`` lines of the
    aggregation's kernels; and ``scatter_study``.  The port is imported
    from ``--root`` when given (a checkout of this commit or a later one):
    run two checkouts alternately in one call.  One ``agg_study`` JSON
    line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import metricsagg as ma
    from koordinator_tpu_torch.utils.fixtures import NOW

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    out = dict(ptxas=ptxas_report(libs["metricsagg"], "agg"), windows=[])
    for line in out["ptxas"]:
        print(f"  ptxas metricsagg: {line}")
    t0 = time.perf_counter()
    _, store, prod, node_keys, pods_by_node, _ = fleet_store(dev, NUM_NODES)
    out["fill_s"] = time.perf_counter() - t0
    for label, dur, keys in report_windows(prod, node_keys, pods_by_node):
        t0 = time.perf_counter()
        w = store.window(NOW, dur, keys)
        build = (time.perf_counter() - t0) * 1e3
        x, rec = window_stages(ma, dev, w, reps)
        require_same(f"aggregate_node_metrics {label}", (ma.aggregate_node_metrics(*x),),
                     (ma.aggregate_node_metrics_plain(*x),))
        S, T = w[0].shape
        b, by = agg_bound(x[1])
        rec = dict(window=label, S=S, T=T, valid_median=float(np.median(w[1].sum(axis=1))),
                   build_ms=build, **rec, bound_ms=b, bound_by=by)
        out["windows"].append(rec)
        print(f"  {label}: {S} x {T}, median {rec['valid_median']:g} valid; build "
              f"{build:.1f} ms, upload {rec['upload_ms']:.1f}, call {rec['ms']:.4f} (run "
              f"{rec['ms_run']:.4f}, device {rec['device_ms']}; bound {b:.4f}), read-back "
              f"{rec['readback_ms']:.2f}; equal plain", flush=True)
        del x, w
    out["scatter"] = scatter_study(dev)
    sc = out["scatter"]
    print(f"  dstate_scatter D={sc['D']}: call {sc['ms']:.4f} ms, run {sc['ms_run']:.4f}; "
          f"index_copy_ call {sc['library_ms']:.4f}, run {sc['library_ms_run']:.4f}; split "
          f"{sc['split']}; residency sync {sc['sync_ms']:.4f} ms", flush=True)
    print(json.dumps({"agg_study": out, "card": card_line()}))
    return 0


# ---------------------------------------------- the --score and --desched studies

SCORE_STUDY_STRATEGIES = ("least", "most", "rtc")


def score_statics(static) -> list:
    """(name, NodeFitStatic) of LeastAllocated, MostAllocated and the
    default RequestedToCapacityRatio shape over ``static``."""
    return [("least", static)] + [(n, st) for n, st in strategy_statics(static)
                                  if n in SCORE_STUDY_STRATEGIES]


def score_floor_ms(dev, P: int, N: int, reps: int) -> float:
    """The store floor of the score kernel (``koord_score_floor`` of the
    study build ``csrc/scorestudy.cu``): its two [P, N] outputs written
    once and nothing read; CUDA events around one launch, the median."""
    from koordinator_tpu_torch import cuda

    k = study_build("koord_score_floor", (ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p),
                    stem="scorestudy")
    totals = torch.empty((P, N), dtype=torch.int64, device=dev)
    feasible = torch.empty((P, N), dtype=torch.bool, device=dev)
    return cuda_ms(lambda: k.launch(P, N, totals.data_ptr(), feasible.data_ptr(),
                                    cuda.device_index(dev), cuda.stream(dev)), reps=reps)


SCORE_STRIPS = (8, 16, 32, 64)
SCORE_COLS = (64, 96, 128)


def score_sweep(full, reps: int) -> list:
    """The score kernel (LeastAllocated, no extras) under every strip
    height of ``SCORE_STRIPS`` and block width of ``SCORE_COLS``, through
    the study build's ``koord_score_tuned``, each equal to the path's
    launch first; CUDA events around one launch.  Empty when the study
    build has no such entry (a checkout before the redesign)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core.cycle import score_fn

    lib = cuda._library("scorestudy")
    if not hasattr(lib, "koord_score_tuned"):
        return []
    k = study_build("koord_score_tuned", tuple(cuda.SCORE.argtypes[:8]) + (
        ctypes.c_int, ctypes.c_int) + tuple(cuda.SCORE.argtypes[8:]), stem="scorestudy")
    la_pods, nf_pods = full["la_pods"], full["nf_pods"]
    la_nodes, nf_nodes = full["la_nodes"], full["nf_nodes"]
    valid, w = full["valid"], full["weights"]
    static = full["static"]
    P, N = la_pods.est.shape[0], valid.shape[0]
    want = score_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid)
    args = cuda.pair_args(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid)
    totals = torch.empty((P, N), dtype=torch.int64, device=valid.device)
    feasible = torch.empty((P, N), dtype=torch.bool, device=valid.device)
    out = []
    for strip in SCORE_STRIPS:
        for cols in SCORE_COLS:
            def launch():
                k.launch(args.pods, args.nodes, args.cfg, args.la_w, args.valid, 0, P, N, strip,
                         cols, totals.data_ptr(), feasible.data_ptr(),
                         cuda.device_index(valid.device), cuda.stream(valid.device))

            launch()
            require_equal(f"score strip {strip} cols {cols}", (totals, feasible), want)
            out.append(dict(strip=strip, cols=cols, ms=cuda_ms(launch, reps=reps)))

    def path_launch():
        cuda.SCORE.launch(args.pods, args.nodes, args.cfg, args.la_w, args.valid, 0, P, N,
                          totals.data_ptr(), feasible.data_ptr(), cuda.device_index(valid.device),
                          cuda.stream(valid.device))

    out.append(dict(strip="path", cols="path", ms=cuda_ms(path_launch, reps=reps)))
    print("  score by strip x block width, ms: " + ", ".join(
        f"{r['strip']}x{r['cols']} {r['ms']:.4f}" for r in out), flush=True)
    return out


def score_host_split(full, reps: int = 201) -> dict:
    """Host milliseconds of the score wrapper's stages, each alone (the
    median of ``reps``, host clock, synchronised before each): the pair
    tables' validation and layout, the two output allocations, the stream
    and device lookups, the launch itself (ctypes call and enqueue), and
    the whole call."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core.cycle import score_fn

    la_pods, nf_pods = full["la_pods"], full["nf_pods"]
    la_nodes, nf_nodes = full["la_nodes"], full["nf_nodes"]
    valid, w = full["valid"], full["weights"]
    static, dev = full["static"], valid.device
    P, N = la_pods.est.shape[0], valid.shape[0]
    args = cuda.pair_args(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid)
    totals = torch.empty((P, N), dtype=torch.int64, device=dev)
    feasible = torch.empty((P, N), dtype=torch.bool, device=dev)

    def launch():
        cuda.SCORE.launch(args.pods, args.nodes, args.cfg, args.la_w, args.valid, 0, P, N,
                          totals.data_ptr(), feasible.data_ptr(), cuda.device_index(dev),
                          cuda.stream(dev))

    def outputs():
        torch.empty((P, N), dtype=torch.int64, device=dev)
        torch.empty((P, N), dtype=torch.bool, device=dev)

    stages = dict(
        pair_args=lambda: cuda.pair_args(la_pods, la_nodes, w, nf_pods, nf_nodes, static,
                                         valid),
        outputs=outputs, stream=lambda: (cuda.device_index(dev), cuda.stream(dev)),
        launch=launch, call=lambda: score_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static,
                                             valid))
    out = {}
    for name, fn in stages.items():
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    torch.cuda.synchronize()
    return out


def score_study(dev, reps: int = 21) -> int:
    """``--score``: the ``score`` kernel at 1,024 x 16,384 under
    LeastAllocated, MostAllocated and RequestedToCapacityRatio, without and
    with extra scores, each equal to the plain ``score_batch`` first: CUDA
    events around one call (the median of ``reps``), the kernel's device
    time (``torch.profiler``) and the wrapper's host time (host clock
    around the call, which only enqueues, after a synchronise); the store
    floor and the strip sweep from the study build; the ``-Xptxas -v``
    lines and the SASS census of the score library.  The port is imported
    from ``--root`` when given (a checkout of this commit or a later one):
    run two checkouts alternately in one call.  One ``score_study`` JSON
    line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core.cycle import PluginWeights, score_batch, score_fn
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    out = dict(ptxas=ptxas_report(libs["score"], "score"), cases=[])
    for line in out["ptxas"]:
        print(f"  ptxas score: {line}")
    pods, nodes = random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS)
    full = build_inputs(pods, nodes, dev, (BATCH_CPU, BATCH_MEMORY))
    la_pods, nf_pods = full["la_pods"], full["nf_pods"]
    la_nodes, nf_nodes = full["la_nodes"], full["nf_nodes"]
    valid, w = full["valid"], full["weights"]
    P, N = la_pods.est.shape[0], valid.shape[0]
    out["shape"] = dict(P=P, N=N, R=la_pods.est.shape[1], Rf=nf_pods.req.shape[1],
                        Rs=nf_pods.req_score.shape[1])
    xsc = extras_for(full, SEED + 5)[1]
    for name, static in score_statics(full["static"]):
        for extras in (None, xsc):
            def kernel():
                return score_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid, extras)

            t, f = score_batch(la_pods, la_nodes, w, nf_pods, nf_nodes, static, PluginWeights())
            want = (t if extras is None else t + extras, f & valid[None, :])
            require_equal(f"score {name} extras={extras is not None}", kernel(), want)
            del t, f, want
            host = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kernel()
                host.append((time.perf_counter() - t0) * 1e3)
            rec = dict(strategy=name, extras=extras is not None, ms=cuda_ms(kernel, reps=reps),
                       device_ms=device_split(kernel, (("score", "kernel"),), reps=reps)
                       .get("kernel"), host_ms=statistics.median(host))
            out["cases"].append(rec)
            print(f"  score {name}{' with extras' if extras is not None else ''}: equal plain; "
                  f"call {rec['ms']:.4f} ms, kernel {rec['device_ms']} ms, wrapper host "
                  f"{rec['host_ms']:.4f} ms", flush=True)
    out["host_split_ms"] = score_host_split(full)
    print("  the wrapper's host time by stage, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out["host_split_ms"].items()), flush=True)
    if "scorestudy" in cuda.STUDY:
        out["floor_ms"] = score_floor_ms(dev, P, N, reps)
        print(f"  store floor (the two outputs written, nothing read): {out['floor_ms']:.4f} ms")
        out["sweep"] = score_sweep(full, reps)
    out["bound_ms"] = bound_ms(nbytes(*la_pods, *nf_pods, *la_nodes, *nf_nodes, valid)
                               + P * N * 9, 0)[0]
    out["sass"] = sass_census(libs["score"], "score")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "score.sass"), "w") as f:
        f.write(subprocess.run([os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump"),
                                "-sass", str(libs["score"])], capture_output=True, text=True,
                               check=True).stdout)
    for fn, c in out["sass"].items():
        print(f"  sass {fn}: {c['instructions']} instructions, {c['calls']} calls, widest loop "
              f"{c['loop_instructions']} with {c['loop_calls']} calls")
    print(json.dumps({"score_study": out, "card": card_line()}))
    return 0


# kernel-name keys of the round's kernels for its study, the thresholds'
# serial mean apart
DESCHED_STUDY_GROUPS = (("thresholds_kernel", "thresholds"),) + DESCHED_GROUPS


def table_address(table):
    """What a launch takes for a pointer table of ``cuda._ptr_table``: the
    address of an ``array.array`` (a ctypes array, on a checkout from before
    the strip kernel, passes as it is)."""
    return table.buffer_info()[0] if hasattr(table, "buffer_info") else table


def desched_split(kernel, want, cuda, device_ms: float) -> dict:
    """The round's split from the study build ``csrc/deschedstudy.cu`` (the
    port's launch pointed at it for one call, equal to the plain version's
    ``want``): block 0's time between consecutive grid barriers, as shares
    of its SM cycles times its span on the global timer (``step_us``: the
    node phase, the node order's phases, classify, the candidates, the two
    orders' phases, the walk's sums up to the last barrier), and when the
    first side block and the thresholds' block ended, in µs of the global
    timer after block 0 started (null when absent); ``device_ms`` the
    round's device time beside."""
    path = cuda.DESCHEDULE_ROUND
    cuda.DESCHEDULE_ROUND = cuda.Kernel("deschedstudy", "koord_deschedule_round", path.argtypes)
    try:
        got = kernel()
        torch.cuda.synchronize()
    finally:
        cuda.DESCHEDULE_ROUND = path
    require_equal("deschedule_round study build", round_outputs(got), round_outputs(want))
    buf = (ctypes.c_ulonglong * 144)()
    fn = cuda._library("deschedstudy").koord_desched_split
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.addressof(buf)) != 0:
        fail("koord_desched_split failed")
    k = min(int(buf[60]), 60)
    clocks, ns = list(buf[:k]), list(buf[64:64 + k])
    span = max(clocks[-1] - clocks[0], 1)
    # the last phase ends with the kernel: its share is what the barriers
    # leave of the device time
    steps = [(b - a) / span for a, b in zip(clocks, clocks[1:])]
    side = [None if buf[64 + s] == 0 else (buf[64 + s] - ns[0]) / 1e3 for s in (61, 62)]
    cycle_us = (ns[-1] - ns[0]) / 1e3 / span
    sc = list(buf[128:136])
    out = dict(marks=k, step_us=[x * (ns[-1] - ns[0]) / 1e3 for x in steps],
               block0_us=(ns[-1] - ns[0]) / 1e3, device_ms=device_ms,
               percentile_end_us=side[0], thresholds_end_us=side[1],
               first_scatter_us=[(b - a) * cycle_us for a, b in zip(sc, sc[1:])])
    print("  the first scatter's steps, µs: " + ", ".join(f"{x:.2f}"
                                                      for x in out["first_scatter_us"]))
    print(f"  split: {k} marks, block 0 {out['block0_us']:.1f} µs to its last barrier; steps µs "
          + ", ".join(f"{x:.1f}" for x in out["step_us"])
          + f"; percentile block ended at {side[0]} µs, thresholds at {side[1]} µs", flush=True)
    return out


def desched_host_split(st, nodes, pods, low, high, w, kw, reps: int = 201) -> dict:
    """Host milliseconds of the round wrapper's stages, each alone (the
    median of ``reps``, host clock, synchronised before each): the
    inputs' checks and contiguity, the outputs' one buffer and its nine
    views, the grid, parameters and scratch, the pointer tables, the launch
    (ctypes call, the control words' memset and the cooperative launch),
    and the whole call."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import deschedule as ds

    dev = nodes.usage.device
    N, R = nodes.usage.shape
    Pc = pods.node.shape[0]
    ins = [t.contiguous() for t in (*st, *nodes, *pods, low, high, w)]
    o = ds._packed_outputs(N, Pc, R, dev)
    outs = [o["anomaly"], o["ab"], o["norm"], o["evicted"], o["rank"], o["under"], o["over"],
            o["source"], o["util"]]
    G = cuda.desched_grid(N, Pc, R, kw["use_deviation"], cuda.sm_count(dev))
    params = (ctypes.c_longlong * 10)(N, Pc, R, int(kw["use_deviation"]), 1, 3, 0,
                                      kw["per_node_cap"], kw["total_cap"], G)
    scratch = ds._scratch(cuda.device_index(dev), cuda.stream(dev), N, Pc, R, G)
    in_tab, out_tab = cuda._ptr_table(ins), cuda._ptr_table(outs)

    def scratch_stage():
        g = cuda.desched_grid(N, Pc, R, kw["use_deviation"], cuda.sm_count(dev))
        (ctypes.c_longlong * 10)(N, Pc, R, 0, 1, 3, 0, 8, 4096, g)
        ds._scratch(cuda.device_index(dev), cuda.stream(dev), N, Pc, R, g)

    stages = dict(
        inputs=lambda: (ds._check_round(st, nodes, pods, low, high, w),
                        [t.contiguous() for t in (*st, *nodes, *pods, low, high, w)]),
        outputs=lambda: ds._packed_outputs(N, Pc, R, dev), scratch=scratch_stage,
        tables=lambda: (cuda._ptr_table(ins), cuda._ptr_table(outs)),
        launch=lambda: cuda.DESCHEDULE_ROUND.launch(table_address(in_tab), table_address(out_tab),
                                                    params, scratch.data_ptr(),
                                                    cuda.device_index(dev), cuda.stream(dev)),
        call=lambda: ds.deschedule_round(st, nodes, pods, low, high, w, **kw))
    out = {}
    for name, fn in stages.items():
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    torch.cuda.synchronize()
    return out


DESCHED_GRIDS = (4, 8, 16, 32, 64)


def desched_grid_sweep(kernel, want, cuda, reps: int) -> list:
    """The round under every main-block count of ``DESCHED_GRIDS`` (the
    port's ``cuda.desched_grid`` replaced for the sweep), each equal to the
    plain version's ``want``; CUDA events around one call."""
    grid = cuda.desched_grid
    out = []
    try:
        for G in DESCHED_GRIDS:
            cuda.desched_grid = lambda *a, G=G: G
            got = kernel()
            require_equal(f"deschedule_round G={G}", round_outputs(got), round_outputs(want))
            require_same_util(f"deschedule_round G={G}", got.util_pct, want.util_pct)
            out.append(dict(G=G, ms=cuda_ms(kernel, reps=reps)))
    finally:
        cuda.desched_grid = grid
    print("  deschedule_round by main blocks, ms: " + ", ".join(
        f"G={r['G']} {r['ms']:.4f}" for r in out), flush=True)
    return out


def desched_study(dev, reps: int = 21) -> int:
    """``--desched``: ``deschedule_round`` at bench/bench_sim.py's shape
    (10,000 nodes x 20,000 candidates in a bucket of 32,768), without and
    with deviation mode, each equal to its plain version first: CUDA events
    around one call (the median of ``reps``), the device time by kernel
    group (``torch.profiler``) and its sum, and the wrapper's host time
    (host clock around the call, which only enqueues, after a
    synchronise; the median).  The port is imported from ``--root`` when
    given: run two checkouts alternately in one call.  One
    ``desched_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import deschedule as ds
    from koordinator_tpu_torch.core.lownodeload import new_anomaly_state

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    out = dict(ptxas=ptxas_report(libs["deschedule"], ""), cases=[])
    nodes, pods = desched_arrays(dev, NUM_NODES, 20_000, 32_768, SEED, heat=1.1, unsched=0.05,
                                 valid=1.0)
    w = torch.tensor([1, 1], dtype=torch.int64, device=dev)
    for dev_mode in (False, True):
        if dev_mode:
            low = high = torch.tensor([10.0, 10.0], dtype=torch.float64, device=dev)
        else:
            low = torch.tensor([30.0, 40.0], dtype=torch.float64, device=dev)
            high = torch.tensor([60.0, 80.0], dtype=torch.float64, device=dev)
        kw = dict(use_deviation=dev_mode, consecutive_abnormalities=1, per_node_cap=8,
                  total_cap=4096)
        st = new_anomaly_state(NUM_NODES, dev)
        want, _ = check_desched_round(f"study deviation={dev_mode}", st, nodes, pods, low, high,
                                      w, **kw)

        def kernel():
            return ds.deschedule_round(st, nodes, pods, low, high, w, **kw)

        host = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kernel()
            host.append((time.perf_counter() - t0) * 1e3)
        split = device_split(kernel, DESCHED_STUDY_GROUPS, reps=reps)
        rec = dict(deviation=dev_mode, evictions=int(want.evicted.sum()),
                   ms=cuda_ms(kernel, reps=reps), device_split_ms=split,
                   device_sum_ms=sum(split.values()), host_ms=statistics.median(host))
        if hasattr(cuda, "desched_grid"):
            rec["grid"] = cuda.desched_grid(NUM_NODES, pods.node.shape[0], 2, dev_mode,
                                            cuda.sm_count(dev))
            rec["sweep"] = desched_grid_sweep(kernel, want, cuda, reps)
        if "deschedstudy" in cuda.STUDY:
            rec["split"] = desched_split(kernel, want, cuda, rec["device_sum_ms"])
            rec["host_split_ms"] = desched_host_split(st, nodes, pods, low, high, w, kw)
            print("  the wrapper's host time by stage, ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in rec["host_split_ms"].items()), flush=True)
        out["cases"].append(rec)
        print(f"  deschedule_round deviation={dev_mode}: equal plain, {rec['evictions']} "
              f"evictions; call {rec['ms']:.4f} ms, device {rec['device_sum_ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
              + f"), wrapper host {rec['host_ms']:.4f} ms", flush=True)
    print(json.dumps({"desched_study": out, "card": card_line()}))
    return 0


# ------------------------------------------------------------ the --rsv study

# kernel-name keys of the reservation kernels for device_split (both
# instantiations of the one template)
RSV_GROUPS = (("rsv_kernel", "rsv_kernel"),)


def rsv_shapes(full):
    """The two shapes of the reservation calls: (name, (req, matched, N,
    rsv, rank)).  ``check``: the check shape, 1,024 pods x 256 reservations
    x 16,384 columns (``con_inputs_for``); ``one-pod``: the descheduler's
    one-pod cycle, one real pod in the bucket of 16 matching one
    reservation (the migration's own, unordered), over the same 256
    reservation rows (the descheduler store's 200 to 232 reservations
    bucket to 256)."""
    out = []
    for name, inp in (("check", full), ("one-pod", probe_inputs(full, 16))):
        _, _, rsv, matched, _, rank = con_inputs_for(inp, SEED + 11)
        if name == "one-pod":
            matched = torch.zeros_like(matched)
            matched[0, 0] = True
        out.append((name, (inp["nf_pods"].req, matched, inp["valid"].shape[0], rsv, rank)))
    return out


def rsv_calls(tr, req, matched, N, rsv, rank) -> dict:
    """The reservation calls: the cycle's one launch (``rsv_rows``, both
    rows) and each entry point alone."""
    return dict(rsv_rows=lambda: tr.rsv_rows(req, matched, N, rsv, rank),
                rsv_rscore=lambda: tr.rsv_rscore(req, rsv),
                rsv_score=lambda: tr.rsv_score(req, matched, N, rsv, rank))


def host_ms(fn, reps: int) -> float:
    """The host clock around ``fn`` after a synchronise: the median of
    ``reps``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def rsv_kernel_cases(full, reps: int) -> list:
    """Both shapes: every call equal to its plain version first, then CUDA
    events around one call (the median of ``reps``), the device time by
    kernel (``torch.profiler``) and the host time (host clock around the
    call, which only enqueues)."""
    from koordinator_tpu_torch.core import reservation as tr

    out = []
    for name, (req, matched, N, rsv, rank) in rsv_shapes(full):
        want = (tr.score_reservation(req, rsv), tr.reservation_score(req, matched, N, rsv))
        calls = rsv_calls(tr, req, matched, N, rsv, rank)
        require_equal(f"rsv_rows {name}", calls["rsv_rows"](), want)
        require_equal(f"rsv entries {name}", (calls["rsv_rscore"](), calls["rsv_score"]()), want)
        rec = dict(shape=name, P=req.shape[0], Rv=rsv.node.shape[0], N=N,
                   matched=int(matched.sum()), calls={})
        for call, fn in calls.items():
            rec["calls"][call] = dict(ms=cuda_ms(fn, reps=reps),
                                      device_ms=device_split(fn, RSV_GROUPS, reps=reps),
                                      host_ms=host_ms(fn, reps))
        out.append(rec)
        print(f"  {name} ({rec['P']} x {rec['Rv']} x {N}, {rec['matched']} matched): "
              + "; ".join(f"{c} call {v['ms']:.4f} ms, device {v['device_ms']}, host "
                          f"{v['host_ms']:.4f}" for c, v in rec["calls"].items()), flush=True)
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rsv_stage_study(dev, scalars, num_pods: int, reps: int, num_nodes: int = NUM_NODES) -> dict:
    """The reservation stage of a constrained cycle on the host clock, over
    ``con_store`` (``num_nodes`` nodes, 200 reservations): a real SCHEDULE
    of ``num_pods`` pods of ``con_batch`` (one reservation each when one
    pod, as the descheduler's bind), then ``Engine._constraint_inputs``
    again on its arguments ``reps`` times, each after a bump of the
    reservation store's version (every cache keyed on it misses, as in the
    descheduler's cycles): the stage from the store's ``build`` to the
    return (the median and range), and its split inside the same calls,
    each step's host ms from the engine's own methods wrapped (the store's
    ``build``, ``_rsv_match``, ``_rsv_ranks``, the one upload,
    ``_rsv_rows_cached``: the median of each)."""
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.utils.fixtures import NOW

    st = con_store(scalars, num_nodes)
    eng = Engine(st, device=dev)
    pods = con_batch(num_pods, "rsv", SEED + 41)
    if num_pods == 1:
        pods[0].reservations = pods[0].reservations[:1]
    seen = {}
    orig = eng._constraint_inputs

    def capture(*a):
        seen["args"] = a
        return orig(*a)

    eng._constraint_inputs = capture
    eng.schedule(pods, now=NOW)
    del eng._constraint_inputs
    args = seen["args"]
    steps = ((st.reservations, "build", "build"), (eng, "_rsv_match", "match"),
             (eng, "_rsv_ranks", "ranks"), (eng._rsv_upload, "upload", "upload"),
             (eng, "_rsv_rows_cached", "rows"))
    split = {}

    def timed(fn, step):
        def call(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                split[step] = split.get(step, 0.0) + (time.perf_counter() - t0) * 1e3
                seen.setdefault("t0", t0)

        return call

    for owner, attr, step in steps:
        setattr(owner, attr, timed(getattr(owner, attr), step))
    stage, whole, splits = [], [], []
    for _ in range(reps):
        st.reservations.version += 1
        split.clear()
        seen.pop("t0", None)
        sync(dev)
        t0 = time.perf_counter()
        eng._constraint_inputs(*args)
        t1 = time.perf_counter()
        stage.append((t1 - seen["t0"]) * 1e3)
        whole.append((t1 - t0) * 1e3)
        splits.append(dict(split))
    for owner, attr, _ in steps:
        delattr(owner, attr)
    sync(dev)
    out = dict(pods=num_pods, p_bucket=args[1], stage_ms=statistics.median(stage),
               stage_range=[min(stage), max(stage)],
               constraint_inputs_ms=statistics.median(whole),
               split_ms={k: statistics.median(s[k] for s in splits) for k in splits[0]})
    if dev.type == "cuda":
        # the device time of what the engine's own call launches there

        def call():
            st.reservations.version += 1
            eng._constraint_inputs(*args)

        out["device_ms"] = device_split(call, RSV_GROUPS, reps=reps)
    return out


def rsv_desched_tick(dev, scalars, num_nodes: int = NUM_NODES) -> dict:
    """The executing DESCHEDULE tick on a card sidecar fed the sidecar
    phase's frames that shape its store (SCORE, EXPLAIN, ECHO and the
    refused verb left out) and the descheduler's: its ``last_split`` and,
    for each constrained cycle the tick runs, the reservation stage on the
    host clock (the store's ``build`` to the return of
    ``_constraint_inputs``) with the cycle's pod and reservation buckets.
    The collector is held out of the tick: a full collection before it,
    none during it (``GcTimer`` shows what ran, by generation), so that two
    trees' ticks compare without a collection landing in one of them."""
    import gc

    from koordinator_tpu_torch.service import protocol as proto
    from koordinator_tpu_torch.service.server import SidecarServer
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    M = proto.MsgType
    skip = ("SCORE breakdown", "EXPLAIN", "ECHO", "METRICS (refused)")
    frames = [f for f in sidecar_frames(num_nodes, NUM_PODS) if f[0] not in skip]
    names = [n.name for n in random_cluster(SEED, num_nodes=num_nodes, num_pods=0)[1]]
    frames += desched_frames(names, max(len(names) // 100, 2), SEED + 31)
    card = SidecarServer(initial_capacity=16, extra_scalars=scalars, device=dev)
    cycles, mark = [], {}
    try:
        cw = Wire(card.address)
        for label, frame in frames:
            if label == "DESCHEDULE execute":
                eng = card.engine
                st = eng.state
                orig, build = eng._constraint_inputs, st.reservations.build

                def timed_build(node_index, axis, rv_bucket):
                    mark.update(t0=time.perf_counter(), rv=rv_bucket)
                    return build(node_index, axis, rv_bucket)

                def timed(pods, p_bucket, nf_req, n_cols):
                    mark.clear()
                    out = orig(pods, p_bucket, nf_req, n_cols)
                    if "t0" in mark:
                        cycles.append(dict(pods=len(pods), p_bucket=p_bucket, rv=mark["rv"],
                                           ms=(time.perf_counter() - mark["t0"]) * 1e3))
                    return out

                eng._constraint_inputs, st.reservations.build = timed, timed_build
                gc.collect()
                gc.disable()
            try:
                with GcTimer() as gc_timer:
                    t0 = time.perf_counter()
                    reply = cw.call(frame)
                    wall = (time.perf_counter() - t0) * 1e3
                    gc_ms = gc_timer.take()
            finally:
                gc.enable()
            if decoded(reply)[0] == M.ERROR:
                fail(f"rsv study, sidecar {label}: ERROR {decoded(reply)[2].get('error')}")
        cw.close()
        d = card._descheduler
        split = {k: v * 1e3 for k, v in d.last_split.items()}
        executed = len(d.last_migrations)
    finally:
        card.close()
    one = [c["ms"] for c in cycles if c["pods"] == 1]
    return dict(wall_ms=wall, gc_ms=gc_ms, split_ms=split, executed=executed, cycles=len(cycles),
                one_pod_cycles=len(one), rv=sorted({c["rv"] for c in cycles}),
                one_pod_stage_ms=statistics.median(one) if one else None,
                one_pod_stage_sum_ms=sum(one),
                probe_stage_ms=[c["ms"] for c in cycles if c["pods"] > 1])


def rsv_study(dev, reps: int = 21) -> int:
    """``--rsv``: the reservation kernels and the stage around them.
    (1) The cycle's one launch (``rsv_rows``; each entry point alone
    beside) at the check shape and at the descheduler's one-pod shape
    (``rsv_shapes``), each equal to both plain versions first: events
    around one call, the device time by kernel and the host time; (2) the reservation stage of a constrained cycle split by
    step, at one pod and in the constraint phase's cold cycle of 1,000
    (``rsv_stage_study``); (3) the executing DESCHEDULE tick's stages and
    its cycles' reservation stages (``rsv_desched_tick``).  The port is
    imported from ``--root`` when given (a checkout of this commit or a
    later one): run two checkouts alternately in one call.  One
    ``rsv_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    scalars = (BATCH_CPU, BATCH_MEMORY)
    out = dict(ptxas=ptxas_report(libs["reservation"], ""))
    for line in out["ptxas"]:
        print(f"  ptxas reservation: {line}")
    pods, nodes = random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS)
    full = build_inputs(pods, nodes, dev, scalars)
    out["kernels"] = rsv_kernel_cases(full, reps)
    del full
    torch.cuda.empty_cache()
    out["stage"] = [rsv_stage_study(dev, scalars, n, reps) for n in (1, NUM_PODS)]
    for s in out["stage"]:
        print(f"  reservation stage, {s['pods']} pods (bucket {s['p_bucket']}): "
              f"{s['stage_ms']:.4f} ms ({s['stage_range'][0]:.4f}-{s['stage_range'][1]:.4f}) of "
              f"_constraint_inputs' {s['constraint_inputs_ms']:.4f}; split "
              + ", ".join(f"{k} {v:.4f}" for k, v in s["split_ms"].items())
              + f"; device {s['device_ms']}", flush=True)
    out["desched"] = rsv_desched_tick(dev, scalars)
    dt = out["desched"]
    print(f"  DESCHEDULE execute: {dt['wall_ms']:.1f} ms (the garbage collector "
          f"{sum(dt['gc_ms'].values()):.1f} ms: {dt['gc_ms']}), executed {dt['executed']}; split "
          + ", ".join(f"{k} {v:.1f}" for k, v in dt["split_ms"].items())
          + f" ms; {dt['cycles']} constrained cycles ({dt['one_pod_cycles']} of one pod, "
          f"reservation buckets {dt['rv']}): the reservation stage a one-pod cycle "
          f"{dt['one_pod_stage_ms']} ms, {dt['one_pod_stage_sum_ms']:.2f} ms in all; the "
          f"probe's {dt['probe_stage_ms']}", flush=True)
    print(json.dumps({"rsv_study": out, "card": card_line()}))
    return 0


# ------------------------------------------------- the --shard and --gate studies

def per_call_us(fn, reps: int = 21, loop: int = 100) -> float:
    """Host microseconds a call of ``fn``: the host clock around ``loop``
    back-to-back calls after a synchronise, divided by ``loop``; the median
    of ``reps`` such loops after one warm-up loop."""
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(loop):
            fn()
        dt = (time.perf_counter() - t0) / loop * 1e6
        if i:
            times.append(dt)
    torch.cuda.synchronize()
    return statistics.median(times)


def shard_study(dev, reps: int = 21) -> int:
    """``--shard``: ``shard_score_map`` at 1,024 x 16,384, S = 4 blocks on one
    card, LeastAllocated, without and with extra scores, the merged blocks
    first held equal to the unsharded ``score`` kernel: CUDA events around
    the four block calls (the median of ``reps``; the sentinel buffers
    allocated and filled in ``setup``, outside the events), the profiler's
    device time of the four launches, the host time of one block call, the
    mesh's own four launches (``ShardedEngine._score_mesh`` on a stand-in
    engine); and ``score``'s call, kernel and host time in the same process.
    Nothing else of the port is called, so ``--root`` may name the parent
    (any checkout with the mesh): run two checkouts alternately in one call.
    One ``shard_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core.cycle import score_fn
    from koordinator_tpu_torch.service import sharding as sh
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    out = dict(ptxas={stem: ptxas_report(libs[stem], "score_kernel")
                      for stem in ("score", "shard") if stem in libs}, cases=[])
    for stem, lines in out["ptxas"].items():
        for line in lines:
            print(f"  ptxas {stem}: {line}")
    pods, nodes = random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS)
    full = build_inputs(pods, nodes, dev, (BATCH_CPU, BATCH_MEMORY))
    la_pods, nf_pods = full["la_pods"], full["nf_pods"]
    la_nodes, nf_nodes = full["la_nodes"], full["nf_nodes"]
    valid, w, static = full["valid"], full["weights"], full["static"]
    P, N = la_pods.est.shape[0], valid.shape[0]
    S = KOORDLET_SHARDS
    bounds = sh.shard_bounds(N, S)
    out["shape"] = dict(P=P, N=N, S=S)
    xsc = scan_extras(full, SEED + 41)[1]
    kernel_groups = (("score_kernel", "kernel"),)
    mesh_self = types.SimpleNamespace(
        engine=types.SimpleNamespace(_weights=w, _nf_static=static), devices=[dev] * S,
        all_bounds=lambda: bounds)
    for extras in (None, xsc):
        bufs = {}

        def fill():
            bufs["out"] = sentinel_buffers(P, N, dev)

        def blocks():
            for lo, hi in bounds:
                sh.shard_score_map(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid,
                                   extras, lo, hi, *bufs["out"])

        def one_block():
            lo, hi = bounds[1]
            sh.shard_score_map(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid, extras,
                               lo, hi, *bufs["out"])

        def score():
            return score_fn(la_pods, la_nodes, w, nf_pods, nf_nodes, static, valid, extras)

        def mesh():
            # the mesh's own four launches (``ShardedEngine._score_mesh``, its
            # two output allocations included) on a stand-in engine
            return sh.ShardedEngine._score_mesh(mesh_self, la_pods, la_nodes, nf_pods, nf_nodes,
                                                valid, extras)

        fill()
        blocks()
        want = score()
        require_equal(f"shard_score_map S={S} extras={extras is not None}", bufs["out"], want)
        require_equal(f"the mesh's blocks S={S} extras={extras is not None}", mesh(), want)
        del want
        rec = dict(extras=extras is not None,
                   blocks_ms=cuda_ms(blocks, reps=reps, setup=fill),
                   blocks_device_ms=device_split(blocks, kernel_groups, reps=reps).get("kernel"),
                   block_host_ms=host_ms(one_block, reps),
                   mesh_ms=cuda_ms(mesh, reps=reps),
                   mesh_host_ms=host_ms(mesh, reps),
                   score_ms=cuda_ms(score, reps=reps),
                   score_device_ms=device_split(score, kernel_groups, reps=reps).get("kernel"),
                   score_host_ms=host_ms(score, reps))
        out["cases"].append(rec)
        print(f"  shard_score_map S={S}{' with extras' if extras is not None else ''}: equal "
              f"the score kernel; four blocks {rec['blocks_ms']:.4f} ms (device "
              f"{rec['blocks_device_ms']}), one block's host {rec['block_host_ms']:.4f} ms; the "
              f"mesh's four {rec['mesh_ms']:.4f} ms (host {rec['mesh_host_ms']:.4f}); "
              f"score call {rec['score_ms']:.4f} ms (kernel {rec['score_device_ms']}), host "
              f"{rec['score_host_ms']:.4f} ms", flush=True)
    out["bound_ms"] = bound_ms(nbytes(*la_pods, *nf_pods, *la_nodes, *nf_nodes, valid)
                               + P * N * 9, 0)[0]
    print(json.dumps({"shard_study": out, "card": card_line()}))
    return 0


GATE_ROWS = 16_384  # the fleet's rows table: 10,000 nodes in a bucket of 16,384


def gate_rows(dev, rows: int):
    """The 12 raw LoadAware rows of a rows table at the fleet's width
    (``scatter_table``), cut to ``rows``, on ``dev``, with update times at
    NaN, at the expiry boundary, just inside it and ahead of the clock;
    (raw, now, exp)."""
    from koordinator_tpu_torch.service import state as sm

    st, host, _ = scatter_table(dev, NUM_NODES)
    raw = [t[:rows].clone() for t in sm.dstate_rows(host[:12], dev)]
    if raw[4].shape[0] != rows:
        fail(f"the rows table holds {raw[4].shape[0]} rows, not {rows}")
    now = 1_000_010.0
    exp = st.la_args.node_metric_expiration_seconds
    k = max(1, min(64, rows // 8))
    ut, has = raw[4], raw[3]
    ut[:k] = float("nan")
    ut[k:2 * k] = now - exp
    ut[2 * k:3 * k] = float(np.nextafter(now - exp, np.inf))
    ut[3 * k:4 * k] = now + 5.0
    has[:4 * k] = True
    return raw, now, exp


def gate_host_split(sm, cuda, raw, now, exp, reps: int) -> dict:
    """Host microseconds a call of ``dstate_gate`` by step, each in a loop of
    its own (``per_call_us``), through a ``GateStage`` bound to ``raw``: the
    public entry's bound check, the [4, N] output and its four rows as
    views, the flags word, the stream, the library call (through
    ``Kernel.launch``; the bare ctypes function beside), the result's
    build, the stage's call (the residency's entry) and the public call.
    (The wrapper before ``GateStage``, split by its own steps, is in
    PERF.md §6.)"""
    from koordinator_tpu_torch.core.loadaware import LoadAwareNodeArrays

    N, dev = raw[4].shape[0], raw[4].device
    stage = sm.GateStage()
    stage.bind(raw)
    rows = torch.empty((4, N), dtype=torch.bool, device=dev)
    args = (stage._desc_ptr, float(now), float(exp),
            cuda.GATE_HAS_EXP | cuda.GATE_EXP_POS | cuda.GATE_FEXP, rows.data_ptr(),
            cuda.stream(dev))
    bare = cuda.DSTATE_GATE._bind()
    masks = rows.unbind(0)
    sm.dstate_gate(raw, now, exp, True)
    steps = dict(
        bound_check=lambda: sm._GATE.bound_to(raw),
        output=lambda: torch.empty((4, N), dtype=torch.bool, device=dev),
        output_views=lambda: rows.unbind(0),
        flags=lambda: ((cuda.GATE_HAS_EXP | (cuda.GATE_EXP_POS if exp > 0 else 0))
                       if exp is not None else 0) | cuda.GATE_FEXP,
        stream=lambda: cuda.stream(dev),
        launch=lambda: cuda.DSTATE_GATE.launch(*args),
        ctypes_call=lambda: bare(*args),
        result=lambda: LoadAwareNodeArrays(raw[0], raw[1], raw[2], masks[0], raw[5], masks[1],
                                           raw[7], raw[8], masks[2], raw[10], masks[3]),
        stage_call=lambda: stage.gate(now, exp, True),
        call=lambda: sm.dstate_gate(raw, now, exp, True),
    )
    return {name: per_call_us(fn, reps) for name, fn in steps.items()}


def gate_study(dev, reps: int = 21) -> int:
    """``--gate``: ``dstate_gate`` at the fleet's 16,384 rows and at 1 row
    (the route's launch floor), each equal to the plain version in the four
    ``exp`` modes first: CUDA events around one call (the median of
    ``reps``), the profiler's device time, the host time of a call in a
    loop and the call split by step on the host clock
    (``gate_host_split``); and ``dstate_extend``'s call beside ``F.pad``'s
    (``check_extend_kernel``).  ``--root`` takes a checkout of this commit
    or a later one: run two checkouts alternately in one call.  One
    ``gate_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.service import state as sm

    print(f"package: {cuda.CSRC.parent}", flush=True)
    cuda.build()
    out = dict(cases=[])
    for rows in (GATE_ROWS, 1):
        raw, now, exp = gate_rows(dev, rows)
        for e, fexp in ((exp, True), (exp, False), (None, True), (0, True)):
            require_same(f"dstate_gate {rows} rows exp={e} fexp={fexp}",
                         sm.dstate_gate(raw, now, e, fexp), sm.dstate_gate_plain(raw, now, e, fexp))

        def call():
            return sm.dstate_gate(raw, now, exp, True)

        rec = dict(rows=rows, ms=cuda_ms(call, reps=reps),
                   device_ms=device_split(call, (("gate", "kernel"),), reps=reps).get("kernel"),
                   host_us=per_call_us(call, reps),
                   split_us=gate_host_split(sm, cuda, raw, now, exp, reps))
        out["cases"].append(rec)
        print(f"  dstate_gate {rows} rows: equal plain; call {rec['ms']:.4f} ms, device "
              f"{rec['device_ms']} ms, host {rec['host_us']:.2f} us a call; split us "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["split_us"].items()), flush=True)
    out["faults"] = gate_fault_cases(dev)
    print(f"  dstate_gate on strided rows and on rows moved under their tensors: "
          f"{out['faults']}", flush=True)
    out["dstate_extend"] = check_extend_kernel(dev, GATE_ROWS, timed=True)
    out["extend_alloc_us"] = extend_alloc_us(dev, GATE_ROWS)
    print(f"  dstate_extend call {out['dstate_extend']['ms']:.4f} ms, F.pad "
          f"{out['dstate_extend']['library_ms']:.4f} ms; its outputs' host us "
          f"{out['extend_alloc_us']}", flush=True)
    print(json.dumps({"gate_study": out, "card": card_line()}))
    return 0


def device_events(fn, reps: int = 10) -> dict:
    """Each device activity of a call of ``fn`` (kernels, copies, fills) by
    name: (times a call, device milliseconds a call), from
    ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (e.count / reps, us / 1e3 / reps)
    return out


def device_activities(ev: dict) -> float:
    """The device activities a call of ``device_events``' record: kernels,
    copies and fills, without the host operators that launched them (an
    ``aten::`` operator shows the device time of its kernel) and the
    profiler's own buffer requests."""
    return sum(n for k, (n, _) in ev.items()
               if not k.startswith("aten::") and k != "Activity Buffer Request")


def device_time(ev: dict) -> float:
    """The device milliseconds a call of ``device_events``' record, without
    the host operators (an ``aten::`` operator shows its kernel's time)."""
    return sum(ms for k, (_, ms) in ev.items() if not k.startswith("aten::"))


def la_floor(P: int, N: int, dev, fused: bool):
    """The LoadAware entry points' store floor: a function that runs
    ``fill_`` on outputs like theirs ([P, N] int64, and [P, N] bool when
    ``fused``: 8 or 9 bytes a pair written, nothing read)."""
    outs = [torch.empty((P, N), dtype=torch.int64, device=dev)]
    if fused:
        outs.append(torch.empty((P, N), dtype=torch.bool, device=dev))

    def floor():
        for o in outs:
            o.fill_(1)

    return floor


PLACE_STUDY = (256, 16_384)  # the kernel table's signatures and label vocabulary


def place_path_calls(dev, num_nodes: int = NUM_NODES, num_pods: int = NUM_PODS) -> list:
    """The ``placement`` calls the placement phase's six cycles make
    (``PLACE_CYCLES``, one card engine over one ``placement_store``, the
    store operations of ``place_cycle_ops``) and the strategies phase's
    cold RequestedToCapacityRatio SCORE and SCHEDULE make, captured as the
    engine makes them: [(where, sigs, node rows)], the rows copied."""
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import placement as pl
    from koordinator_tpu_torch.core.config import NodeFitArgs, ScoringStrategyType
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.utils.fixtures import NOW

    scalars = (BATCH_CPU, BATCH_MEMORY)
    calls, where = [], ["?"]
    orig = pl.placement

    def record(sigs, *rows):
        calls.append((where[0], pl.PlacementSigs(*(t.clone() for t in sigs)),
                      tuple(r.clone() for r in rows)))
        return orig(sigs, *rows)

    pl.placement = record
    try:
        st = placement_store(scalars, num_nodes)
        eng = Engine(st, device=dev)
        batch = placement_batch(num_nodes, num_pods, "place", SEED + 31)
        rng = np.random.default_rng(SEED + 32)
        metric_nodes = [f"node-{int(i)}" for i in rng.choice(num_nodes, 100, replace=False)]
        for c, (name, dt, _, expect) in enumerate(PLACE_CYCLES):
            now = NOW + dt
            place_cycle_ops(st, c, now, metric_nodes, f"node-{num_nodes - 2}")
            if c == 5:
                batch = placement_batch(num_nodes, num_pods, "place-next", SEED + 33)
            st.publish(now)
            where[0] = f"placement cycle {c} ({name})"
            if c == 0:
                eng.score(batch, now=now)
            eng.schedule(batch, now=now, assume=bool(expect.get("assume")))
        del eng, st
        rtc = NodeFitArgs(strategy=ScoringStrategyType.REQUESTED_TO_CAPACITY_RATIO)
        st = placement_store(scalars, num_nodes, nf_args=rtc)
        eng = Engine(st, device=dev)
        batch = placement_batch(num_nodes, num_pods, "strat", SEED + 52)
        where[0] = "strategies: RequestedToCapacityRatio cycle 0"
        eng.score(batch, now=NOW)
        eng.schedule(batch, now=NOW)
    finally:
        pl.placement = orig
    return calls


def place_host_split(pl, cuda, sigs, rows, reps: int) -> dict:
    """Host microseconds a ``placement`` call by step, each in a loop of
    its own (``per_call_us``): the wrapper's own steps (this tree's: the
    lists' attributes and their one host array, the library's plan, the
    whole plan step; or the parent's: the checks, the ``cat`` of the nine
    lists, ``pin_memory``, the copy and ``split``, the rows'
    ``contiguous``), the [M, N] output, the library call through
    ``Kernel.launch``, and the whole call."""
    import ctypes

    N, dev = rows[0].shape[0], rows[0].device
    M = sigs.sel_cnt.shape[0]
    out = torch.empty((M, N), dtype=torch.bool, device=dev)
    if hasattr(pl, "host_lists"):  # the node tile over the column union
        flat, dims = pl.host_lists(sigs, rows)
        info = (ctypes.c_int * 4)()
        pl.placement_plan(sigs, rows)
        args = (*(t.data_ptr() for t in rows), *(t.shape[1] for t in rows), N, 0, 0,
                out.data_ptr(), cuda.device_index(dev), cuda.stream(dev))
        steps = dict(lists=lambda: (pl._lists_fine(sigs, rows), pl.host_lists(sigs, rows)),
                     library_plan=lambda: cuda.PLACEMENT_PLAN(flat.data_ptr(), M, dims,
                                                              pl.PLACEMENT_SMEM, info),
                     plan=lambda: pl.placement_plan(sigs, rows))
    else:
        flat = torch.cat(list(sigs))
        pinned = flat.pin_memory()
        lists = pinned.to(dev, non_blocking=True).split([t.numel() for t in sigs])
        args = (*(t.data_ptr() for t in lists), *(t.data_ptr() for t in rows),
                *(t.shape[1] for t in rows), M, N, out.data_ptr(), cuda.device_index(dev),
                cuda.stream(dev))
        steps = dict(checks=lambda: pl._check_placement(sigs, *rows),
                     cat=lambda: torch.cat(list(sigs)), pin_memory=lambda: flat.pin_memory(),
                     copy_split=lambda: pinned.to(dev, non_blocking=True).split(
                         [t.numel() for t in sigs]),
                     rows_contiguous=lambda: [t.contiguous() for t in rows])
    steps.update(output=lambda: torch.empty((M, N), dtype=torch.bool, device=dev),
                 launch=lambda: cuda.PLACEMENT.launch(*args),
                 call=lambda: pl.placement(sigs, *rows))
    return {name: per_call_us(fn, reps) for name, fn in steps.items()}


def place_call_split(pl, cuda, sigs, rows, calls: int = 400) -> dict:
    """This tree's ``placement`` call taken apart in place: its steps run in
    order, call after call, each timed on the host clock; the median
    microseconds of each step over ``calls`` calls."""
    dev = rows[0].device
    names = ("plan", "output", "contiguous", "launch")
    out = {n: [] for n in names}
    torch.cuda.synchronize()
    for _ in range(calls):
        t = [time.perf_counter()]
        M, _, _, _ = pl.placement_plan(sigs, rows)
        t.append(time.perf_counter())
        o = torch.empty((M, rows[0].shape[0]), dtype=torch.bool, device=dev)
        t.append(time.perf_counter())
        rs = tuple(r.contiguous() for r in rows)
        t.append(time.perf_counter())
        cuda.PLACEMENT.launch(*(r.data_ptr() for r in rs), *(r.shape[1] for r in rs),
                              rs[0].shape[0], 0, 0, o.data_ptr(), cuda.device_index(dev),
                              cuda.stream(dev))
        t.append(time.perf_counter())
        for n, a, b in zip(names, t, t[1:]):
            out[n].append((b - a) * 1e6)
    torch.cuda.synchronize()
    return {n: statistics.median(v) for n, v in out.items()}


def place_record(pl, sigs, rows, reps: int) -> dict:
    """One ``placement`` call equal to its plain version, then timed:
    events around one call, the profiler's device activities, the host
    time of a call in a loop."""
    M, N = sigs.sel_cnt.shape[0], rows[0].shape[0]
    require_equal(f"placement {M}x{N}", (pl.placement(sigs, *rows),),
                  (pl.placement_plain(sigs, *rows),))

    def call():
        return pl.placement(sigs, *rows)

    ev = device_events(call, reps)
    from koordinator_tpu_torch import cuda

    return dict(M=M, N=N, widths=[int(r.shape[1]) for r in rows],
                list_entries=[int(t.numel()) for t in (sigs.sel_idx, sigs.tol_idx, sigs.hold_idx,
                                                        sigs.aa_idx)],
                ms=cuda_ms(call, reps=reps),
                device_ms=sum(ms for k, (_, ms) in ev.items() if "placement" in k),
                events=ev, host_us=per_call_us(call, reps),
                in_call_us=(place_call_split(pl, cuda, sigs, rows)
                            if hasattr(pl, "host_lists") else None))


def place_study(dev, reps: int = 21) -> int:
    """``--place``: ``placement`` at the kernel table's shape (256
    signatures x 16,384 columns, a 16,384-wide label vocabulary,
    ``placement_inputs``) with its call split by step on the host clock
    (``place_host_split``), and each call the placement and strategies
    phases make (``place_path_calls``) replayed on its own inputs: M, N,
    the widths, the call, its device time and its host time.  ``--root``
    takes another checkout with the gate's ``GateStage`` or later: run two checkouts
    alternately in one call.  One ``place_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import placement as pl

    print(f"package: {cuda.CSRC.parent}", flush=True)
    cuda.build()
    M, L = PLACE_STUDY
    sigs, rows = placement_inputs(dev, M, GATE_ROWS, L, SEED + 20)
    rec = place_record(pl, sigs, rows, reps)
    rec["split_us"] = place_host_split(pl, cuda, sigs, rows, reps)
    print(f"  placement {M} x {GATE_ROWS}, Lb {L}: equal plain; call {rec['ms']:.4f} ms, "
          f"device {rec['device_ms']:.4f} ms, host {rec['host_us']:.1f} us; split us "
          + ", ".join(f"{k} {v:.2f}" for k, v in rec["split_us"].items())
          + f"; in the call {rec['in_call_us']}", flush=True)
    out = dict(study=rec, path=[])
    for where, psigs, prows in place_path_calls(dev):
        r = dict(place_record(pl, psigs, prows, reps), where=where)
        out["path"].append(r)
        print(f"  {where}: M {r['M']}, N {r['N']}, widths {r['widths']}, entries "
              f"{r['list_entries']}: call {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
              f"host {r['host_us']:.1f} us; in the call {r['in_call_us']}", flush=True)
    print(json.dumps({"place_study": out, "card": card_line()}))
    return 0


def band_path_calls(dev, num_nodes: int = NUM_NODES, num_pods: int = NUM_PODS) -> list:
    """The ``pod_band_rank`` calls of the descheduler path
    (``drive_desched_path``'s frames after the sidecar phase's APPLY frames,
    on one card sidecar), captured as the arbitrator makes them: [(tick,
    keys)], the keys copied."""
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core.deschedule import BandKeys
    from koordinator_tpu_torch.service import descheduler as dsm
    from koordinator_tpu_torch.service.server import SidecarServer
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    calls, where = [], ["?"]
    orig = dsm.pod_band_rank

    def record(keys):
        calls.append((where[0], BandKeys(*(None if t is None else t.clone() for t in keys))))
        return orig(keys)

    frames = [(lab, f) for lab, f in sidecar_frames(num_nodes, num_pods)
              if lab.startswith("APPLY")]
    _, fleet = random_cluster(SEED, num_nodes=num_nodes, num_pods=0)
    frames += desched_frames([n.name for n in fleet], max(num_nodes // 100, 2), SEED + 31)
    card = SidecarServer(initial_capacity=16, extra_scalars=(BATCH_CPU, BATCH_MEMORY), device=dev)
    dsm.pod_band_rank = record
    try:
        w = Wire(card.address)
        for label, frame in frames:
            where[0] = label
            w.call(frame)
        w.close()
    finally:
        dsm.pod_band_rank = orig
        card.close()
    return calls


def band_record(ds, keys, reps: int) -> dict:
    """One ``pod_band_rank`` call equal to its plain version, then timed:
    events around one call, the profiler's device activities (their count
    a call), the host time of a call in a loop."""
    P = keys.priority.shape[0]
    require_equal(f"pod_band_rank P={P}", (ds.pod_band_rank(keys),),
                  (ds.pod_band_rank_plain(keys),))

    def call():
        return ds.pod_band_rank(keys)

    ev = device_events(call, reps)
    return dict(P=P, usage=keys.usage is not None, ms=cuda_ms(call, reps=reps),
                device_ms=sum(ms for _, ms in ev.values()),
                device_events=sum(n for n, _ in ev.values()), events=ev,
                host_us=per_call_us(call, reps))


def band_split(ds, keys) -> dict:
    """One ``pod_band_rank`` launch of the study build (csrc/bandstudy.cu):
    block 0's global timer at each step, as microseconds from the
    launch's start: the keys' bounds and the plan, then each word's build
    and, in the cooperative launch, its first counts, then each pass's
    steps (counts, the tiles' counts read, the offsets, the scatter, the
    barrier; the one block's: counts, offsets, scatter, sync)."""
    import ctypes

    from koordinator_tpu_torch import cuda

    rank = study_build("koord_band_rank", (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_void_p),
                       "bandstudy")
    split = cuda.HostFn("bandstudy", "koord_band_split", [ctypes.c_void_p])
    buf = (ctypes.c_ulonglong * 256)()
    orig = ds.cuda.POD_BAND_RANK
    ds.cuda.POD_BAND_RANK = rank
    try:
        ds.pod_band_rank(keys)
        torch.cuda.synchronize()
        split(buf)
        ds.pod_band_rank(keys)
        torch.cuda.synchronize()
        split(buf)
    finally:
        ds.cuda.POD_BAND_RANK = orig
    marks = np.array(buf[:min(int(buf[255]), 255)], dtype=np.float64)
    return dict(total_us=float(marks[-1] - marks[0]) / 1e3,
                steps_us=[round(float(x), 2) for x in np.diff(marks) / 1e3])


def band_study(dev, reps: int = 21) -> int:
    """``--band``: ``pod_band_rank`` at P = 32,768 with and without the usage
    key (``band_arrays``, ties on every key) and at each P the descheduler
    path's arbitrations give it (``band_path_calls``), each equal to its
    plain version first: events around one call, the profiler's device
    time and activities a call, the host time of a call in a loop, and on
    a tree with the study build one launch split by step (``band_split``).
    ``--root`` takes another checkout with the gate's ``GateStage`` or later: run two
    checkouts alternately in one call.  One ``band_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import deschedule as ds

    print(f"package: {cuda.CSRC.parent}", flush=True)
    cuda.build()
    out = dict(cases=[], path=[])
    study = "bandstudy" in cuda.STUDY  # this tree's one launch, split by step
    for usage in (False, True):
        keys = band_arrays(dev, 32_768, SEED + 32_768, usage)
        rec = band_record(ds, keys, reps)
        if study:
            rec["split"] = band_split(ds, keys)
        out["cases"].append(rec)
        print(f"  pod_band_rank P 32768, usage {usage}: equal plain; call {rec['ms']:.4f} ms, "
              f"device {rec['device_ms']:.4f} ms in {rec['device_events']:.0f} activities, "
              f"host {rec['host_us']:.1f} us", flush=True)
    calls = band_path_calls(dev)
    out["path_P"] = [(where, int(k.priority.shape[0])) for where, k in calls]
    print(f"  the descheduler path's arbitrations: {out['path_P']}", flush=True)
    if not calls:
        fail("the descheduler path arbitrated nothing")
    where, keys = max(calls, key=lambda c: c[1].priority.shape[0])
    rec = dict(band_record(ds, keys, reps), where=where, passes=band_passes(keys))
    if study:
        rec["split"] = band_split(ds, keys)
    out["path"].append(rec)
    print(f"  pod_band_rank at the path's largest P {rec['P']} ({where}): call "
          f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms in "
          f"{rec['device_events']:.0f} activities, host {rec['host_us']:.1f} us", flush=True)
    print(json.dumps({"band_study": out, "card": card_line()}))
    return 0


def restate_study(dev) -> int:
    """``--restate``: the kernel table's rows not redesigned since they were ported, measured
    again, with no change to their kernels: ``sched_refresh`` and
    ``sched_refresh_con`` at 1,024 x 16,384 (the warm and constraint
    paths' shape, ``check_warm_kernels``, ``check_con_kernels``), and
    ``quota`` and ``quota_limit`` on the 500-group tree
    (``check_quota_kernels``) and on the constraint path's 100 groups
    (``con_objects``), each equal to its plain version first.  One
    ``restate_study`` JSON line."""
    from koordinator_tpu_torch import convert, cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import quota as tq
    from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    cuda.build()
    keep = ("name", "ms", "plain_ms", "bound_ms", "dirty_rows", "groups")
    full = build_inputs(*random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS), dev,
                        (BATCH_CPU, BATCH_MEMORY))
    recs = [r for r in check_warm_kernels(full, (16, 128, 1024), timed=True)[0]
            + check_con_kernels(full, 0, timed=True) + check_quota_kernels(dev, timed=True)
            if r["name"] in ("sched_refresh", "sched_refresh_con", "quota", "quota_limit")]
    total, groups, _, _ = con_objects(NUM_NODES)
    qs = QuotaSnapshot(groups, ["cpu", "memory"])
    qa = tq.QuotaArrays(*(convert.tensor(a, dev) for a in qs.arrays()))
    levels = qs.level_tuple()
    lv_t = [torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev) for a in levels]
    tot = convert.tensor(np.array([total["cpu"], total["memory"]], dtype=np.int64), dev)
    want = tq.refresh_runtime(qa, lv_t, tot)
    require_equal("quota (the path's tree)", (tq.quota_fn(qa, levels, tot),), (want,))
    want[0] = tq.INF
    require_equal("quota_limit (the path's tree)", (tq.quota_limit_fn(qa, levels, tot),), (want,))
    for name, fn in (("quota", lambda: tq.quota_fn(qa, levels, tot)),
                     ("quota_limit", lambda: tq.quota_limit_fn(qa, levels, tot))):
        recs.append(dict(name=name, groups=len(groups), ms=cuda_ms(fn, reps=21),
                         plain_ms=cuda_ms(lambda: tq.refresh_runtime(qa, lv_t, tot), reps=21)))
    out = [{k: v for k, v in r.items() if k in keep} for r in recs]
    for r in out:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms)"
              + (f", D {r['dirty_rows']}" if r.get("dirty_rows") else "")
              + (f", {r['groups']} groups" if r.get("groups") else ""), flush=True)
    print(json.dumps({"restate_study": out, "card": card_line()}))
    return 0


# ------------------------------------------------ the --refresh and --quota studies

REFRESH_DIRTY = (64, 128, 1024, 4096)  # the warm paths' buckets, and the warm limit's


def refresh_setup(full, con: bool, extras: bool, BS: int = 16):
    """The warm refresh's inputs at ``full``'s shape in queue order: the
    cold carry (``schedule_keys``, node blocks of BS), the constraint inputs of
    ``check_con_kernels`` when ``con``, the extras of
    ``check_extra_kernels`` when ``extras``, and the plain version's pod
    mask."""
    from koordinator_tpu_torch.core import resolved as rs

    la_pods, nf_pods, valid = full["la_pods"], full["nf_pods"], full["valid"]
    xs, q_la, q_nf, salts, pod_ok = rs.kernel_queue(la_pods, nf_pods, valid, full["p_real"],
                                                    full["order"])
    c = con_for(full, con_inputs_for(full, SEED + 11), xs) if con else None
    xin = rs.extra_inputs(*extras_for(full, SEED + 23), xs) if extras else None
    q_extra = pod_ok[:, None] & valid[None, :]
    if con:
        q_extra = q_extra & rs.gang_pass(c)[:, None]
    q_extra, q_xsc = rs._q_extras(xin, q_extra)
    carry = rs.schedule_keys(q_la, full["la_nodes"], full["weights"], q_nf, full["nf_nodes"],
                             full["static"], valid, pod_ok, salts, BS, c, xin)
    return dict(q_la=q_la, q_nf=q_nf, salts=salts, pod_ok=pod_ok, con=c, xin=xin,
                q_extra=q_extra, q_xsc=q_xsc, carry=carry)


def check_refresh_case(inp, con: bool, extras: bool, D: int, seed: int = SEED + 43,
                       BS: int = 16) -> dict:
    """One ``schedule_refresh`` of a padded index of D rows (D - 3 random
    rows, among them the first and the last column, perturbed as a metric
    update perturbs them; ``padded``) in node blocks of BS, plain or
    constrained, without or with extras, against ``refresh_plain`` and a
    cold key build (raises ``Mismatch``).  Returns the launches the call
    took (0 on CPU tensors), the distinct node blocks of the index and the
    words of its plan (which parameter block or device copy carries it)."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.core.cycle import PluginWeights

    s = refresh_setup(inp, con, extras, BS)
    w, static, valid = inp["weights"], inp["static"], inp["valid"]
    dev, N = valid.device, valid.shape[0]
    rng = np.random.default_rng(seed)
    real = np.unique(np.r_[0, N - 1, rng.choice(N, size=min(D, N) - 5, replace=False)])
    real = real[:D - 3].astype(np.int32)
    idx = padded(real)
    la2, nf2 = perturbed_nodes(inp["la_nodes"], inp["nf_nodes"],
                               torch.from_numpy(real).to(dev).long())
    args = (s["q_la"], la2, w, s["q_nf"], nf2, static, valid, s["pod_ok"], s["salts"], BS,
            s["con"], s["xin"])
    clone = lambda c: tuple(a.clone() for a in c)  # noqa: E731
    kernel = cuda.KERNELS["sched_refresh_con" if con else "sched_refresh"]
    before = kernel.launches
    got = rs.schedule_refresh(clone(s["carry"]), idx, *args)
    launched = kernel.launches - before
    what = f"{'sched_refresh_con' if con else 'sched_refresh'} D={idx.size} extras={extras}"
    require_equal(what, got, rs.refresh_plain(
        *clone(s["carry"]), torch.from_numpy(idx).to(dev), s["q_la"], la2, w, s["q_nf"], nf2,
        static, PluginWeights(), s["q_extra"], s["salts"], BS,
        rs.rsv_view(s["con"]) if con else None, s["q_xsc"]))
    require_equal(f"{what} against a cold key build", got,
                  rs.schedule_keys(*args[:9], BS, s["con"], s["xin"]))
    blocks = int(np.unique(idx // BS).size)
    return dict(launches=launched, D=int(idx.size), blocks=blocks,
                plan_words=blocks * (1 + -(-BS // 32)))


def refresh_launch(rs, cuda, full, s, idx, la2, nf2, kernel=None):
    """A ``schedule_refresh`` launch with its arguments built once: the
    entry point (``kernel``, this library's by default) launched on the
    carry in place with the host index; on a tree that copies the index to
    the card first, a copy made once."""
    w, static, valid = full["weights"], full["static"], full["valid"]
    dev, P, N, BS = valid.device, s["q_la"].est.shape[0], valid.shape[0], 16
    con, Rf = s["con"], s["q_nf"].req.shape[1]
    args = cuda.pair_args(s["q_la"], la2, w, s["q_nf"], nf2, static, valid)
    xf, xsc, xkeep = rs._xin_args(s["xin"], P, N, dev)
    head = (args.pods, args.nodes, args.cfg, args.la_w, args.valid, s["pod_ok"].data_ptr(),
            s["salts"].data_ptr(), xf, xsc, P, N, BS, rs.tie_base(N))
    con_t = () if con is None else rs._con_launch_args(con, P, N, Rf, dev, False, 0, 1,
                                                       rs.PluginWeights().reservation)
    if kernel is None:
        kernel = cuda.SCHED_REFRESH if con is None else cuda.SCHED_REFRESH_CON
    M, Mb, feas = s["carry"]
    tail = (M.data_ptr(), Mb.data_ptr(), feas.data_ptr(), cuda.device_index(dev),
            cuda.stream(dev))
    if (cuda.CSRC / "refreshplan.cuh").exists():  # one launch over a plan of the host index
        d, ptr = idx, idx.ctypes.data
    else:
        d = torch.from_numpy(idx).pin_memory().to(dev, non_blocking=True)
        ptr = d.data_ptr()

    def launch(keep=(args, xkeep, con_t, d)):  # the tables the pointers point into
        kernel.launch(*head, *con_t[:2], ptr, int(idx.size), *tail)
    return launch


def refresh_host_split(rs, cuda, full, s, idx, la2, nf2, reps: int) -> dict:
    """Host microseconds of a ``schedule_refresh`` call by step, each in a
    loop of its own (``per_call_us``): the carry's checks, the dirty
    index's checks, the constraint table (constrained), the extras'
    pointers, the pair arguments, the pod mask's and salts' checks, the
    index's pinned copy (a tree that moves the index so), the launch with
    its arguments built, and the whole call."""
    w, static, valid = full["weights"], full["static"], full["valid"]
    dev, P, N, BS = valid.device, s["q_la"].est.shape[0], valid.shape[0], 16
    carry, con, xin = s["carry"], s["con"], s["xin"]
    Rf, w_rsv = s["q_nf"].req.shape[1], rs.PluginWeights().reservation

    def dirty():
        if hasattr(rs, "_host_index"):
            return rs._host_index(idx, N)
        d = torch.as_tensor(idx)
        return d.dtype == torch.int32 and int(d.min()) >= 0 and int(d.max()) < N

    steps = dict(
        check_carry=lambda: rs._check_carry(carry, N, P, BS, dev), dirty=dirty,
        xin_args=lambda: rs._xin_args(xin, P, N, dev),
        pair_args=lambda: cuda.pair_args(s["q_la"], la2, w, s["q_nf"], nf2, static, valid),
        pod_checks=lambda: (cuda._checked(s["pod_ok"], torch.bool, (P,), dev, "pod_ok"),
                            cuda._checked(s["salts"], torch.int32, (P,), dev, "salts")))
    if con is not None:
        steps["con_args"] = lambda: rs._con_launch_args(con, P, N, Rf, dev, False, 0, 1, w_rsv)
    if hasattr(rs, "warm_args"):
        steps["warm_args"] = lambda: rs.warm_args(s["q_la"], la2, w, s["q_nf"], nf2, static,
                                                  valid, s["pod_ok"], s["salts"], con)
    if not (cuda.CSRC / "refreshplan.cuh").exists():
        steps["pin_copy"] = lambda: torch.from_numpy(idx).pin_memory().to(dev, non_blocking=True)
    steps["launch"] = refresh_launch(rs, cuda, full, s, idx, la2, nf2)
    steps["call"] = lambda: rs.schedule_refresh(carry, idx, s["q_la"], la2, w, s["q_nf"], nf2,
                                                static, valid, s["pod_ok"], s["salts"], BS, con,
                                                xin)
    return {name: per_call_us(fn, reps) for name, fn in steps.items()}


def refresh_tiers(rs, cuda, full, s, idx, la2, nf2, reps: int) -> dict:
    """The refresh's launch on one plan with its words in the 2-KB
    parameter block (the library the paths load) and in the 28-KB one (the
    study build csrc/refreshstudy.cu): events around a launch (``ms``) and
    the host time a launch (``host_us``), each measured in two rounds
    alternated, small block first; the medians of the rounds."""
    name = "koord_sched_refresh_con" if s["con"] is not None else "koord_sched_refresh"
    base = cuda.SCHED_REFRESH_CON if s["con"] is not None else cuda.SCHED_REFRESH
    launches = {"small": refresh_launch(rs, cuda, full, s, idx, la2, nf2),
                "large": refresh_launch(rs, cuda, full, s, idx, la2, nf2,
                                        study_build(name, tuple(base.argtypes), "refreshstudy"))}
    got = {k: dict(ms=[], host_us=[]) for k in launches}
    for _ in range(2):
        for k, fn in launches.items():
            got[k]["ms"].append(cuda_ms(fn, reps=reps))
            got[k]["host_us"].append(per_call_us(fn, reps))
    return {k: {m: float(np.median(v)) for m, v in r.items()} for k, r in got.items()}


def refresh_cycle(rs, cuda, s, args, idx):
    """What a warm cycle pays for its refresh and for laying out its round
    loop's launch arguments, the round loop's launch itself left out.  On a
    tree with ``resolved.warm_args``: the cycle's arguments built once, the
    refresh given them, the round loop's private node rows
    (``cuda.with_private_nodes``) and, constrained, its constraint pointers
    from the shared tables.  On an older tree: the refresh building its
    own, then the round loop's node-row clones, pair arguments, pod checks
    and, constrained, constraint tables, built again.  Returns a function
    of the carry."""
    q_la, la_nodes, la_w, q_nf, nf_nodes, nf_static, valid, pod_ok, salts = args[:9]
    con = s["con"]
    dev, P, N = valid.device, q_la.est.shape[0], valid.shape[0]
    rnd = (P, N, q_nf.req.shape[1], dev, True, 0, 8, rs.PluginWeights().reservation)
    if hasattr(rs, "warm_args"):
        def cycle(c):
            wa = rs.warm_args(*args[:9], con)
            rs.schedule_refresh(c, idx, *args, args=wa)
            keep = [cuda.with_private_nodes(wa.pair)]
            if con is not None:
                keep.append(rs._con_launch_args(con, *rnd, tables=wa.con))
            return keep
        return cycle

    def cycle(c):
        rs.schedule_refresh(c, idx, *args)
        la_mut = la_nodes._replace(base_nonprod=la_nodes.base_nonprod.clone(),
                                   base_prod=la_nodes.base_prod.clone())
        nf_mut = nf_nodes._replace(requested=nf_nodes.requested.clone(),
                                   req_score=nf_nodes.req_score.clone(),
                                   num_pods=nf_nodes.num_pods.clone())
        keep = [cuda.pair_args(q_la, la_mut, la_w, q_nf, nf_mut, nf_static, valid),
                cuda._checked(pod_ok, torch.bool, (P,), dev, "pod_ok"),
                cuda._checked(salts, torch.int32, (P,), dev, "salts")]
        if con is not None:
            keep.append(rs._con_launch_args(con, *rnd))
        return keep
    return cycle


def refresh_study(dev, reps: int = 21) -> int:
    """``--refresh``: ``sched_refresh`` and ``sched_refresh_con`` at 1,024 x
    16,384 without and with extras, at D = 64, 128, 1,024 and 4,096 dirty
    rows (a padded index, ``padded``, of random rows perturbed as a metric
    update perturbs them), each first held equal to ``refresh_plain`` and,
    at D = 128, to a cold key build: events around one call (the carry
    cloned outside the span), the profiler's device time and device
    activities a call, the host time a call in a loop, events around a
    run of 100 calls over 100 (``run_ms``), the distinct node blocks; the
    same with the cycle's launch arguments built beside, as the engine
    builds them (``path_*``); what the warm cycle pays for its refresh and
    its round loop's launch arguments (``cycle_*``, ``refresh_cycle``: the
    span that holds what the engine shares, on either tree); at D = 128
    the call split by step (``refresh_host_split``); at D = 64 and 128
    without extras the launch with its plan in the 2-KB and the 28-KB
    parameter block (``refresh_tiers``, this tree only).
    ``--root`` takes another checkout of the port (one from before the
    planned refreshes, with ``core.quota.flat_levels``, or a later one):
    run two checkouts alternately in one call.  One ``refresh_study``
    JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import resolved as rs
    from koordinator_tpu_torch.core.cycle import PluginWeights
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    cuda.build()
    full = build_inputs(*random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS), dev,
                        (BATCH_CPU, BATCH_MEMORY))
    w, static, valid = full["weights"], full["static"], full["valid"]
    N, BS = valid.shape[0], 16
    rng = np.random.default_rng(SEED + 40)
    clone = lambda c: tuple(a.clone() for a in c)  # noqa: E731
    out = []
    for con, extras in ((False, False), (False, True), (True, False), (True, True)):
        s = refresh_setup(full, con, extras)
        name = "sched_refresh_con" if con else "sched_refresh"
        for D in REFRESH_DIRTY:
            real = rng.choice(N, size=D - 3, replace=False).astype(np.int32)
            idx = padded(real)
            la2, nf2 = perturbed_nodes(full["la_nodes"], full["nf_nodes"],
                                       torch.from_numpy(real).to(dev).long())
            args = (s["q_la"], la2, w, s["q_nf"], nf2, static, valid, s["pod_ok"], s["salts"],
                    BS, s["con"], s["xin"])

            def call(c, wa=None):
                return rs.schedule_refresh(c, idx, *args, **({} if wa is None else {"args": wa}))

            got = call(clone(s["carry"]))
            require_equal(f"{name} D={D} extras={extras}", got, rs.refresh_plain(
                *clone(s["carry"]), torch.from_numpy(idx).to(dev), s["q_la"], la2, w, s["q_nf"],
                nf2, static, PluginWeights(), s["q_extra"], s["salts"], BS,
                rs.rsv_view(s["con"]) if con else None, s["q_xsc"]))
            if D == 128:
                require_equal(f"{name} D={D} extras={extras} against a cold key build", got,
                              rs.schedule_keys(*args[:9], BS, s["con"], s["xin"]))
            work = {"c": clone(s["carry"])}
            ev = device_events(lambda: call(work["c"]), reps)
            rec = dict(name=name, extras=extras, D=D, blocks=int(np.unique(idx // BS).size),
                       ms=cuda_ms(lambda: call(work["c"]), reps=reps,
                                  setup=lambda: work.update(c=clone(s["carry"]))),
                       device_ms=sum(ms for k, (_, ms) in ev.items() if not k.startswith("aten::")),
                       device_events=device_activities(ev), events=ev,
                       host_us=per_call_us(lambda: call(work["c"]), reps),
                       run_ms=run_ms(lambda: call(work["c"])))
            if hasattr(rs, "warm_args"):  # the call as the engine makes it: the cycle's
                # launch arguments built once, beside (shared with its round loop)
                wa = rs.warm_args(*args[:9], s["con"])
                ev = device_events(lambda: call(work["c"], wa), reps)
                rec.update(path_ms=cuda_ms(lambda: call(work["c"], wa), reps=reps,
                                           setup=lambda: work.update(c=clone(s["carry"]))),
                           path_device_events=device_activities(ev), path_events=ev,
                           path_host_us=per_call_us(lambda: call(work["c"], wa), reps),
                           path_run_ms=run_ms(lambda: call(work["c"], wa)))
            cycle = refresh_cycle(rs, cuda, s, args, idx)
            rec.update(cycle_ms=cuda_ms(lambda: cycle(work["c"]), reps=reps,
                                        setup=lambda: work.update(c=clone(s["carry"]))),
                       cycle_host_us=per_call_us(lambda: cycle(work["c"]), reps))
            if D == 128:
                rec["split_us"] = refresh_host_split(rs, cuda, full, dict(s, carry=work["c"]),
                                                     idx, la2, nf2, reps)
            if D in (64, 128) and not extras and "refreshstudy" in cuda.STUDY:
                rec["tiers"] = refresh_tiers(rs, cuda, full, dict(s, carry=work["c"]), idx, la2,
                                             nf2, reps)
            out.append(rec)
            print(f"  {name} D {D} ({rec['blocks']} blocks), extras {extras}: equal plain; call "
                  f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms in "
                  f"{rec['device_events']:.0f} activities, host {rec['host_us']:.1f} us"
                  + (f"; with the cycle's arguments call {rec['path_ms']:.4f} ms in "
                     f"{rec['path_device_events']:.0f} activities, host "
                     f"{rec['path_host_us']:.1f} us" if "path_ms" in rec else "")
                  + f"; the cycle's refresh and round-loop arguments {rec['cycle_ms']:.4f} ms, "
                  f"host {rec['cycle_host_us']:.1f} us"
                  + ("; launch with the 2-KB / 28-KB parameter block " + ", ".join(
                      f"{k} {v['ms']:.4f} ms host {v['host_us']:.1f} us"
                      for k, v in rec["tiers"].items()) if "tiers" in rec else "")
                  + (f"; split us " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                rec["split_us"].items())
                     if "split_us" in rec else ""), flush=True)
    print(json.dumps({"refresh_study": out, "card": card_line()}))
    return 0


def quota_study_trees():
    """(name, groups, cluster total) of the ``--quota`` study: the 500-group
    tree of ``check_quota_kernels``, the constraint path's 100 groups
    (``con_objects``) and a tree past the shared-memory tier
    (``big_quota_tree``)."""
    total, groups, _, _ = con_objects(NUM_NODES)
    return [("bench 500 groups", quota_trees()[0][1], np.array([1_000_000, 1_000_000])),
            ("the constraint path's 100 groups", groups,
             np.array([total["cpu"], total["memory"]])),
            ("6,000 groups", big_quota_tree(), np.array([40_000_000, 40_000_000]))]


def quota_host_split(tq, cuda, qa, parent, levels, tot, stage, reps: int) -> dict:
    """Host microseconds of a ``quota_limit`` call by step, each in a loop
    of its own (``per_call_us``): this tree's (the per-call checks, the
    stage's bind on an unchanged tree, the output, the launch) or the
    parent's (the checks and level block, ``flat_levels`` alone, the
    block's pinned copy, the output and scratch, the launch), and the whole
    call."""
    dev = qa.min.device
    Q, R = qa.min.shape
    out = torch.empty((Q, R), dtype=torch.int64, device=dev)
    if stage is not None:
        args = tq.quota_launch_args(qa, tot, stage)
        steps = dict(checks=lambda: tq.quota_launch_args(qa, tot, stage),
                     bind=lambda: stage.bind(parent, levels, dev),
                     output=lambda: torch.empty((Q, R), dtype=torch.int64, device=dev),
                     launch=lambda: cuda.QUOTA_LIMIT.launch(*args, 1, 1, out.data_ptr(),
                                                            cuda.device_index(dev),
                                                            cuda.stream(dev)),
                     call=lambda: tq.quota_limit_fn(qa, levels, tot, stage=stage))
    else:
        a, lv, L = tq._quota_args(qa, levels, tot)
        lv_d = torch.from_numpy(lv).pin_memory().to(dev, non_blocking=True)
        scratch = torch.empty((tq.QUOTA_SCRATCH, Q, R), dtype=torch.int64, device=dev)
        steps = dict(
            checks=lambda: tq._quota_args(qa, levels, tot),
            flat_levels=lambda: tq.flat_levels(levels),
            pin_copy=lambda: torch.from_numpy(lv).pin_memory().to(dev, non_blocking=True),
            outputs=lambda: (torch.empty((Q, R), dtype=torch.int64, device=dev),
                             torch.empty((tq.QUOTA_SCRATCH, Q, R), dtype=torch.int64,
                                         device=dev)),
            launch=lambda: cuda.QUOTA_LIMIT.launch(*(t.data_ptr() for t in a), lv_d.data_ptr(),
                                                   L, Q, R, 1, 1, out.data_ptr(),
                                                   scratch.data_ptr(), cuda.device_index(dev),
                                                   cuda.stream(dev)),
            call=lambda: tq.quota_limit_fn(qa, levels, tot))
    return {name: per_call_us(fn, reps) for name, fn in steps.items()}


def quota_study(dev, reps: int = 21) -> int:
    """``--quota``: ``quota`` and ``quota_limit`` on the 500-group tree, the
    constraint path's 100 groups (R = 2) and a 6,000-group tree past the
    shared-memory tier (``quota_study_trees``), each first held equal to
    ``refresh_runtime`` (scaled mins on and off for ``quota``): events
    around one call, the profiler's device time and activities a call,
    the host time a call in a loop, and the ``quota_limit`` call split by
    step (``quota_host_split``); on a tree with ``QuotaStage`` the calls
    take a stage bound once, as the engine's do, and the engine's cache
    miss (``Engine._quota_limit_cached`` on a store of the constraint
    path's groups and a 1,000-pod batch) is timed too.  ``--root`` takes
    another checkout of the port (one from before the planned refreshes,
    with ``core.quota.flat_levels``, or a later one): run two
    checkouts alternately in one call.  One ``quota_study`` JSON line."""
    from koordinator_tpu_torch import convert, cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import quota as tq
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.service.state import ClusterState
    from koordinator_tpu_torch.snapshot.quota import QuotaSnapshot

    print(f"package: {cuda.CSRC.parent}", flush=True)
    cuda.build()
    staged = hasattr(tq, "QuotaStage")
    out = dict(trees=[])
    for name, groups, total in quota_study_trees():
        qs = QuotaSnapshot(groups, ["cpu", "memory"])
        qd = tq.QuotaArrays(*(convert.tensor(a, dev) for a in qs.arrays()))
        # this tree's calls take the parent rows on the host, as the engine's do
        qa = qd._replace(parent=qs.parent) if staged else qd
        levels = qs.level_tuple()
        lv_t = [torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev) for a in levels]
        tot = convert.tensor(total.astype(np.int64), dev)
        stage = tq.QuotaStage().bind(qs.parent, levels, dev) if staged else None
        kw = {"stage": stage} if staged else {}
        for scale in (True, False):
            require_equal(f"quota ({name}, scale {scale})",
                          (tq.quota_fn(qa, levels, tot, scale, **kw),),
                          (tq.refresh_runtime(qd, lv_t, tot, scale),))
        want = tq.refresh_runtime(qd, lv_t, tot)
        want[0] = tq.INF
        require_equal(f"quota_limit ({name})", (tq.quota_limit_fn(qa, levels, tot, **kw),),
                      (want,))
        rec = dict(tree=name, groups=len(groups), levels=len(levels),
                   tier=stage.tier(2) if staged else None)
        for kname, fn in (("quota", lambda: tq.quota_fn(qa, levels, tot, **kw)),
                          ("quota_limit", lambda: tq.quota_limit_fn(qa, levels, tot, **kw))):
            ev = device_events(fn, reps)
            rec[kname] = dict(ms=cuda_ms(fn, reps=reps), run_ms=run_ms(fn),
                              device_ms=sum(ms for k, (_, ms) in ev.items()
                                            if not k.startswith("aten::")),
                              device_events=device_activities(ev), events=ev,
                              host_us=per_call_us(fn, reps))
        rec["plain_ms"] = cuda_ms(lambda: tq.refresh_runtime(qd, lv_t, tot), reps=5)
        rec["split_us"] = quota_host_split(tq, cuda, qa, qs.parent, levels, tot, stage, reps)
        if staged:  # a call that plans its own tree: a fresh stage each call, the parent
            # rows read back from the card
            rec["unstaged_ms"] = cuda_ms(lambda: tq.quota_limit_fn(qd, levels, tot), reps=reps)
        out["trees"].append(rec)
        print(f"  {name} ({len(groups)} groups, {len(levels)} levels"
              + (f", {stage.tier(2)} tier" if staged else "") + "): equal plain; "
              + "; ".join(f"{k} call {rec[k]['ms']:.4f} ms, device {rec[k]['device_ms']:.4f} ms "
                          f"in {rec[k]['device_events']:.0f} activities, host "
                          f"{rec[k]['host_us']:.1f} us" for k in ("quota", "quota_limit"))
              + "; split us " + ", ".join(f"{k} {v:.2f}" for k, v in rec["split_us"].items()),
              flush=True)
    # the engine's cache miss on the constraint path's groups
    total, groups, _, _ = con_objects(NUM_NODES)
    st = ClusterState(extra_scalars=(BATCH_CPU, BATCH_MEMORY))
    st.quota.set_total(total)
    for g in groups:
        st.quota.upsert(g)
    eng = Engine(st, device=dev)
    batch = con_batch(NUM_PODS, "quota", SEED + 42)
    qs = st.quota.snapshot()

    def miss():
        eng._quota_limit_key = None
        return eng._quota_limit_cached(qs, batch)

    out["engine_miss"] = dict(ms=cuda_ms(miss, reps=reps), host_us=per_call_us(miss, reps, 20))
    print(f"  the engine's cache miss (100 groups, {NUM_PODS} pods): call "
          f"{out['engine_miss']['ms']:.4f} ms, host {out['engine_miss']['host_us']:.1f} us",
          flush=True)
    print(json.dumps({"quota_study": out, "card": card_line()}))
    return 0


def la_study_shapes(dev) -> list:
    """(name, (la_pods, la_nodes, weights)) of the ``--la`` study: the kernel
    table's 1,024 x 16,384 (``build_inputs`` as ``check_breakdown_kernels``
    gets it), the library path's 1,000 x 10,000 from the snapshot builders
    (``drive_library_path``) and the sidecar's breakdown SCORE (its fleet
    and batch as ``sidecar_frames`` sends them, laid out as
    ``Engine.score_breakdown`` lays them out)."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core.config import LoadAwareArgs
    from koordinator_tpu_torch.snapshot import loadaware as la_snap
    from koordinator_tpu_torch.utils.fixtures import NOW, random_cluster

    scalars = (BATCH_CPU, BATCH_MEMORY)
    pods, nodes = random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS)
    full = build_inputs(pods, nodes, dev, scalars)
    args = LoadAwareArgs()
    library = (convert.la_pods(la_snap.build_pod_arrays(pods, args), dev),
               convert.la_nodes(la_snap.build_node_arrays(nodes, args, NOW), dev),
               convert.weights(la_snap.build_weights(args), dev))
    side = build_inputs(con_batch(NUM_PODS, "side", SEED + 21),
                        random_cluster(SEED, num_nodes=NUM_NODES, num_pods=0)[1], dev, scalars)
    return [("table", (full["la_pods"], full["la_nodes"], full["weights"])),
            ("library", library),
            ("sidecar", (side["la_pods"], side["la_nodes"], side["weights"]))]


def la_host_split(la, cuda, pods, nodes, w, fused: bool, reps: int) -> dict:
    """Host microseconds of a LoadAware call by step, each in a loop of its
    own (``per_call_us``): the pod and node tables' checks (``_la_tables``),
    the weights' check, the configuration block (the per-R block where the
    tree has ``loadaware_cfg``, else ``cfg_array``), the pointer tables,
    ``loadaware_args`` whole, the outputs, the launch with its arguments
    built, and the whole call."""
    dev = pods.est.device
    P, R = pods.est.shape
    N = nodes.alloc.shape[0]
    cfg = getattr(cuda, "loadaware_cfg", None) or (lambda r: cuda.cfg_array(r, 0, 0, None))
    tabs = cuda._la_tables(pods, nodes, P, N, dev)
    args = cuda.loadaware_args(pods, nodes, w)

    def outputs():
        s = torch.empty((P, N), dtype=torch.int64, device=dev)
        return (s, torch.empty((P, N), dtype=torch.bool, device=dev)) if fused else (s,)

    outs = outputs()
    tail = (*(o.data_ptr() for o in outs), cuda.device_index(dev), cuda.stream(dev))
    kernel = cuda.LA_SCORE_FILTER if fused else cuda.LA_SCORE
    entry = la.loadaware_score_and_filter if fused else la.loadaware_score
    steps = dict(
        tables=lambda: cuda._la_tables(pods, nodes, P, N, dev),
        weights=lambda: cuda._checked(w, torch.int64, (R,), dev, "LoadAware weights"),
        cfg=lambda: cfg(R),
        pointer_tables=lambda: cuda._pair_args(
            tabs[0] + (None,) * cuda._NF_POD_PTRS, tabs[1] + (None,) * cuda._NF_NODE_PTRS,
            cfg(R), la_w=w),
        loadaware_args=lambda: cuda.loadaware_args(pods, nodes, w),
        outputs=outputs,
        launch=lambda: kernel.launch(args.pods, args.nodes, args.cfg, args.la_w, P, N, *tail),
        call=lambda: entry(pods, nodes, w))
    return {name: per_call_us(fn, reps) for name, fn in steps.items()}


def la_record(la, cuda, pods, nodes, w, fused: bool, reps: int) -> dict:
    """One entry point at one shape, equal to its plain version first: CUDA
    events around one call, the profiler's device time and device
    activities, the host time (host clock around a call after a
    synchronise), the call split by step, the store floor (``fill_`` of the
    same outputs: 8 bytes a pair, 9 fused) and the bytes bound; medians of
    ``reps``."""
    P, N = pods.est.shape[0], nodes.alloc.shape[0]
    name = "loadaware_score_and_filter" if fused else "la_score"
    score = la.loadaware_score_plain(pods, nodes, w)
    if fused:
        call = lambda: la.loadaware_score_and_filter(pods, nodes, w)  # noqa: E731
        require_equal(f"{name} {P}x{N}", call(), (score, la.loadaware_filter(pods, nodes)))
    else:
        call = lambda: la.loadaware_score(pods, nodes, w)  # noqa: E731
        require_equal(f"{name} {P}x{N}", (call(),), (score,))
    del score
    ev = device_events(call, reps)
    floor = la_floor(P, N, pods.est.device, fused)
    floor_ms, floor_device_ms = cuda_ms(floor, reps=reps), device_time(device_events(floor, reps))
    in_b = nbytes(pods.est, pods.is_prod_score, w, nodes.alloc, nodes.base_nonprod,
                  nodes.base_prod, nodes.score_valid)
    if fused:
        in_b += nbytes(pods.is_prod_class, pods.is_daemonset, nodes.filter_usage,
                       nodes.filter_active, nodes.thresholds, nodes.prod_usage,
                       nodes.prod_filter_active, nodes.prod_thresholds,
                       nodes.has_prod_thresholds)
    return dict(name=name, P=P, N=N, ms=cuda_ms(call, reps=reps), device_ms=device_time(ev),
                device_events=device_activities(ev), events=ev, host_ms=host_ms(call, reps),
                split_us=la_host_split(la, cuda, pods, nodes, w, fused, reps),
                floor_ms=floor_ms, floor_device_ms=floor_device_ms,
                bound_ms=bound_ms(in_b + P * N * (9 if fused else 8), 0)[0])


def la_case_faults(dev, small) -> dict:
    """``check_la_cases`` case by case, a mismatch recorded instead of
    raised: case and entry point -> the mismatch's message (its first
    differing indices)."""
    from koordinator_tpu_torch.core import loadaware as la

    out = {}
    for name, (pods, nodes, w) in la_cases(dev, small):
        score, feasible = la.loadaware_score_plain(pods, nodes, w), la.loadaware_filter(pods, nodes)
        for entry, got, want in (
                ("la_score", lambda: (la.loadaware_score(pods, nodes, w),), (score,)),
                ("loadaware_score_and_filter",
                 lambda: la.loadaware_score_and_filter(pods, nodes, w), (score, feasible))):
            try:
                require_equal(f"la case {name}: {entry}", got(), want)
            except Mismatch as e:
                out[f"{name}: {entry}"] = str(e)
    return out


def la_study(dev, reps: int = 21) -> int:
    """``--la``: ``la_score`` and ``loadaware_score_and_filter`` through the
    public entry points (``core.loadaware``) at the kernel table's 1,024 x
    16,384, the library path's 1,000 x 10,000 and the sidecar breakdown
    SCORE's shape (``la_study_shapes``), each record a ``la_record``; the
    ``-Xptxas -v`` lines of the breakdown library and of ``score_kernel``;
    the edge cases of ``la_cases`` with any mismatch recorded
    (``la_case_faults``).  ``--root`` takes another checkout of the port
    (the parent of the strip kernel or a later one): run two checkouts
    alternately in one call.  One ``la_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import loadaware as la
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    out = dict(ptxas={"breakdown": ptxas_report(libs["breakdown"], ""),
                      "score_kernel": ptxas_report(libs["score"], "score_kernel")}, cases=[])
    for lib, lines in out["ptxas"].items():
        for line in lines:
            print(f"  ptxas {lib}: {line}")
    for shape, (pods, nodes, w) in la_study_shapes(dev):
        for fused in (False, True):
            rec = dict(la_record(la, cuda, pods, nodes, w, fused, reps), shape=shape)
            out["cases"].append(rec)
            print(f"  {rec['name']} {shape} {rec['P']}x{rec['N']}: equal plain; call "
                  f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms in "
                  f"{rec['device_events']:.0f} activities, host {rec['host_ms'] * 1e3:.1f} us; "
                  f"fill_ floor {rec['floor_ms']:.4f} ms (device {rec['floor_device_ms']:.4f}); "
                  f"bound {rec['bound_ms']:.4f} ms; split us " + ", ".join(
                      f"{k} {v:.2f}" for k, v in rec["split_us"].items()), flush=True)
        del pods, nodes, w
        torch.cuda.empty_cache()
    small = build_inputs(*random_cluster(SEED, num_nodes=300, num_pods=50), dev,
                         (BATCH_CPU, BATCH_MEMORY))
    out["case_faults"] = la_case_faults(dev, small)
    print(f"  edge cases: {len(la_cases(dev, small))}, mismatches "
          f"{out['case_faults'] or 'none'}", flush=True)
    print(json.dumps({"la_study": out, "card": card_line()}))
    return 0


def nf_study_shapes(dev) -> list:
    """(name, (nf_pods, nf_nodes, static)) of the ``--nf`` study: the kernel
    table's 1,024 x 16,384 (``build_inputs`` as ``check_breakdown_kernels``
    gets it) under LeastAllocated, MostAllocated and both RTC shapes, and
    the sidecar breakdown SCORE's shape (its fleet and batch as
    ``sidecar_frames`` sends them, LeastAllocated)."""
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    scalars = (BATCH_CPU, BATCH_MEMORY)
    full = build_inputs(*random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS), dev,
                        scalars)
    out = [(f"table {sname}", (full["nf_pods"], full["nf_nodes"], static))
           for sname, static in nf_case_statics(full["static"])]
    side = build_inputs(con_batch(NUM_PODS, "side", SEED + 21),
                        random_cluster(SEED, num_nodes=NUM_NODES, num_pods=0)[1], dev, scalars)
    out.append(("sidecar least", (side["nf_pods"], side["nf_nodes"], side["static"])))
    return out


def nf_host_split(nf, cuda, pods, nodes, static, reps: int) -> dict:
    """Host microseconds of an ``nf_score`` call by step, each in a loop of
    its own (``per_call_us``): the pod and node tables' checks
    (``_nf_tables``), the configuration block (``cfg_array``'s memoised
    block), the pointer
    tables, ``nodefit_args`` whole, the output, the launch with its
    arguments built, and the whole call."""
    dev = pods.req.device
    P, Rf = pods.req.shape
    Rs, N = pods.req_score.shape[1], nodes.alloc.shape[0]
    cfg = functools.partial(cuda.cfg_array, 0, 0, Rs, static)
    tabs = cuda._nf_tables(pods, nodes, P, N, dev)
    args = cuda.nodefit_args(pods, nodes, static)
    out = torch.empty((P, N), dtype=torch.int64, device=dev)
    steps = dict(
        tables=lambda: cuda._nf_tables(pods, nodes, P, N, dev),
        cfg=cfg,
        pointer_tables=lambda: cuda._pair_args((None,) * cuda._LA_POD_PTRS + tabs[0],
                                               (None,) * cuda._LA_NODE_PTRS + tabs[1], cfg()),
        nodefit_args=lambda: cuda.nodefit_args(pods, nodes, static),
        outputs=lambda: torch.empty((P, N), dtype=torch.int64, device=dev),
        launch=lambda: cuda.NF_SCORE.launch(args.pods, args.nodes, args.cfg, P, N,
                                            out.data_ptr(), cuda.device_index(dev),
                                            cuda.stream(dev)),
        call=lambda: nf.nodefit_score(pods, nodes, static))
    return {name: per_call_us(fn, reps) for name, fn in steps.items()}


def nf_record(nf, cuda, pods, nodes, static, reps: int) -> dict:
    """``nf_score`` at one shape and strategy, equal to its plain version
    first: CUDA events around one call, the profiler's device time and
    device activities, the host time, the call split by step, the store
    floor (``fill_`` of the same [P, N] int64 output) and the bytes bound;
    medians of ``reps``."""
    P, N = pods.req.shape[0], nodes.alloc.shape[0]
    call = lambda: nf.nodefit_score(pods, nodes, static)  # noqa: E731
    require_equal(f"nf_score {static.strategy} {P}x{N}", (call(),),
                  (nf.nodefit_score_plain(pods, nodes, static),))
    ev = device_events(call, reps)
    floor = la_floor(P, N, pods.req.device, False)
    in_b = nbytes(pods.req_score, nodes.alloc_score, nodes.req_score)
    return dict(name="nf_score", P=P, N=N, strategy=static.strategy, ms=cuda_ms(call, reps=reps),
                ms_run=run_ms(call), device_ms=device_time(ev),
                device_events=device_activities(ev), events=ev, host_ms=host_ms(call, reps),
                split_us=nf_host_split(nf, cuda, pods, nodes, static, reps),
                floor_ms=cuda_ms(floor, reps=reps), floor_ms_run=run_ms(floor),
                floor_device_ms=device_time(device_events(floor, reps)),
                bound_ms=bound_ms(in_b + P * N * 8, 0)[0])


def nf_study(dev, reps: int = 21) -> int:
    """``--nf``: ``nf_score`` through the public entry point
    (``core.nodefit``) at ``nf_study_shapes``, each record a ``nf_record``;
    the ``-Xptxas -v`` lines of the breakdown library, of ``score_kernel``
    and of the round loop; the edge cases of ``nf_cases`` and the division
    repairs of ``repair_cases`` with any mismatch recorded.  ``--root``
    takes another checkout of the port: run two checkouts alternately in
    one call.  One ``nf_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import nodefit as nf
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    out = dict(ptxas={"breakdown": ptxas_report(libs["breakdown"], ""),
                      "score_kernel": ptxas_report(libs["score"], "score_kernel"),
                      "rounds_kernel": ptxas_report(libs["schedule"], "rounds_kernel")},
               cases=[])
    for lib, lines in out["ptxas"].items():
        for line in lines:
            print(f"  ptxas {lib}: {line}")
    for shape, (pods, nodes, static) in nf_study_shapes(dev):
        rec = dict(nf_record(nf, cuda, pods, nodes, static, reps), shape=shape)
        out["cases"].append(rec)
        print(f"  nf_score {shape} {rec['P']}x{rec['N']}: equal plain; call {rec['ms']:.4f} ms "
              f"(run {rec['ms_run']:.4f}), device {rec['device_ms']:.4f} ms in "
              f"{rec['device_events']:.0f} activities, host {rec['host_ms'] * 1e3:.1f} us; "
              f"fill_ floor {rec['floor_ms']:.4f} ms (run {rec['floor_ms_run']:.4f}, device "
              f"{rec['floor_device_ms']:.4f}); bound {rec['bound_ms']:.4f} ms; split us "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["split_us"].items()), flush=True)
    torch.cuda.empty_cache()
    small = build_inputs(*random_cluster(SEED, num_nodes=300, num_pods=50), dev,
                         (BATCH_CPU, BATCH_MEMORY))
    out["case_faults"] = nf_case_faults(dev, small)
    print(f"  nf edge cases: {len(nf_cases(dev, small))}, mismatches "
          f"{out['case_faults'] or 'none'}", flush=True)
    out["repair_faults"] = repair_case_faults(dev)
    print(f"  repair cases: {len(repair_cases(dev))}, mismatches "
          f"{json.dumps(out['repair_faults'], indent=1) if out['repair_faults'] else 'none'}",
          flush=True)
    print(json.dumps({"nf_study": out, "card": card_line()}))
    return 0


def dev_host_split(pl, cuda, rows, sigs, reps: int) -> dict:
    """Host microseconds of a ``dev_feasible`` call by step, each in a loop
    of its own: this tree's (the signatures packed, the stage's key test,
    the output, the launch from the bound stage with the block uploaded
    beforehand past the parameters' cap, the whole call) or the
    parent's (the eleven tensors' checks, the rows' ``contiguous``, the
    output, the launch with its 17 arguments, the whole call)."""
    core, mem, full, vfs = rows
    dev = core.device
    M, N = sigs.has_gpu.shape[0], core.shape[0]
    s = dev_sigs_for(pl, sigs, dev)
    out = torch.empty((M, N), dtype=torch.bool, device=dev)
    if hasattr(pl, "DeviceStage"):
        stage = pl.DeviceStage()
        stage.bind(rows)
        block = pl.pack_device_sigs(sigs)
        dblock = torch.from_numpy(block).to(dev) if M > cuda.DEV_SIG_CAP else None
        dptr = 0 if dblock is None else dblock.data_ptr()
        steps = dict(pack=lambda: pl.pack_device_sigs(sigs),
                     bound_to=lambda: stage.bound_to(rows),
                     output=lambda: torch.empty((M, N), dtype=torch.bool, device=dev),
                     launch=lambda: cuda.DEV_FEASIBLE.launch(
                         stage._desc_ptr, block.__array_interface__["data"][0], dptr, M,
                         out.data_ptr(), cuda.stream(dev)),
                     call=lambda: pl.dev_feasible(*rows, s))
    else:
        crow = [t.contiguous() for t in rows]
        Gm = core.shape[1]
        steps = dict(checks=lambda: pl._check_device(*rows, s),
                     contiguous=lambda: [t.contiguous() for t in rows],
                     output=lambda: torch.empty((M, N), dtype=torch.bool, device=dev),
                     launch=lambda: cuda.DEV_FEASIBLE.launch(
                         *(t.data_ptr() for t in crow), *(t.data_ptr() for t in s), M, N, Gm,
                         out.data_ptr(), cuda.device_index(dev), cuda.stream(dev)),
                     call=lambda: pl.dev_feasible(*rows, s))
    return {name: per_call_us(fn, reps) for name, fn in steps.items()}


def dev_record(pl, cuda, M: int, N: int, Gm: int, reps: int) -> dict:
    """``dev_feasible`` at M signatures x N nodes, Gm slots, equal to its
    plain version first: CUDA events around one call (and a run of 100),
    the profiler's device time and activities, the host time, the call
    split by step and the bytes bound; medians of ``reps``."""
    (core, mem, full, vfs, sigs), _ = device_inputs(torch.device("cuda:0"), M, N, Gm,
                                                    SEED + 21 + Gm)
    rows = (core, mem, full, vfs)
    s = dev_sigs_for(pl, sigs, core.device)
    call = lambda: pl.dev_feasible(*rows, s)  # noqa: E731
    require_equal(f"dev_feasible {M}x{N} Gm={Gm}", (call(),),
                  (pl.dev_feasible_plain(*rows, s),))
    ev = device_events(call, reps)
    rec = dict(name="dev_feasible", M=M, N=N, Gm=Gm, ms=cuda_ms(call, reps=reps),
               ms_run=run_ms(call), device_ms=device_time(ev),
               device_events=device_activities(ev), events=ev, host_ms=host_ms(call, reps),
               split_us=dev_host_split(pl, cuda, rows, sigs, reps),
               bound_ms=bound_ms(nbytes(core, mem, full, vfs) + M * 20 + M * N, 0)[0])
    if hasattr(pl, "pack_device_sigs"):
        # the signatures as the engine passes them: one packed host block
        block = pl.pack_device_sigs(sigs)
        packed = lambda: pl.dev_feasible(*rows, block)  # noqa: E731
        rec.update(ms_block=cuda_ms(packed, reps=reps), host_ms_block=host_ms(packed, reps))
    return rec


def parent_dense_block(eng, pl, dense, cols=None):
    """The dense device block as the engine built it before the packed
    signatures (``Engine._compute_device_rows`` at commit 20f1c81,
    service/engine.py:595-623):
    seven numpy arrays of the signatures padded to a bucket of 8, seven
    uploads, ``dev_feasible`` on the device rows' column slices.  For a
    tree without ``Engine._dense_device_rows``."""
    from koordinator_tpu_torch import convert
    from koordinator_tpu_torch.service.state import next_bucket

    Mb = next_bucket(len(dense), 8)
    has_gpu, is_multi, sig_valid = (np.zeros(Mb, dtype=bool) for _ in range(3))
    count, core_req, ratio_req, rdma_need = (np.zeros(Mb, dtype=np.int32) for _ in range(4))
    for m, (greq, rdma_req, _cs, _bp, _ep) in enumerate(dense):
        sig_valid[m] = True
        if greq is not None:
            has_gpu[m] = True
            c, r = greq
            if c >= 100:
                is_multi[m] = True
                count[m] = c // 100
                if c % 100:
                    sig_valid[m] = False
            else:
                core_req[m] = c
                ratio_req[m] = r
            rdma_need[m] = 1 if rdma_req > 0 else 0
        else:
            rdma_need[m] = rdma_req
    lo, hi = (0, eng.state.capacity) if cols is None else cols
    core, mem, full, vfs = (t[lo:hi] for t in eng._device_node_rows()[:4])
    sigs = pl.DeviceSigs(*(convert.tensor(a, eng.device) for a in (
        has_gpu, is_multi, count, core_req, ratio_req, rdma_need, sig_valid)))
    return pl.dev_feasible(core, mem, full, vfs, sigs)


def dev_engine_block(dev, reps: int) -> dict:
    """The engine's dense device block at the placement path's shapes: a
    card engine over ``placement_store`` at ``NUM_NODES`` schedules the
    placement phase's batch once (building the caches), and its cpuset-free
    device signatures are captured as ``_compute_device_rows`` receives
    them; then, host clock around a call after a synchronise, medians of
    ``reps``: the dense block alone (``Engine._dense_device_rows``, or on a
    tree without it ``parent_dense_block``: the signatures' build, their
    uploads or their packing, the ``dev_feasible`` call), each equal to the
    other form's result, and the whole ``_compute_device_rows`` over them
    into a fresh cache (the dense block and the per-signature candidate
    masks)."""
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import placement as pl
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.utils.fixtures import NOW

    st = placement_store((BATCH_CPU, BATCH_MEMORY), NUM_NODES)
    eng = Engine(st, device=dev)
    batch = placement_batch(NUM_NODES, NUM_PODS, "place", SEED + 31)
    seen = []
    orig = eng._compute_device_rows

    def record(sig_list, sig_rep, cap, *a, **k):
        seen.append((list(sig_list), dict(sig_rep), cap))
        return orig(sig_list, sig_rep, cap, *a, **k)

    eng._compute_device_rows = record
    st.publish(NOW)
    eng.schedule(batch, now=NOW)
    eng._compute_device_rows = orig
    sig_list, sig_rep, cap = seen[0]
    dense = [s for s in sig_list if s[2] is None]
    if hasattr(eng, "_dense_device_rows"):
        block = lambda: eng._dense_device_rows(dense)  # noqa: E731
    else:
        block = lambda: parent_dense_block(eng, pl, dense)  # noqa: E731
    got = block()
    require_equal("the dense device block", (got[:len(dense)],),
                  (pl.dev_feasible_plain(*(t for t in eng._device_node_rows()[:4]),
                                         _dense_sigs_host(pl, dense, dev)),))
    return dict(signatures=len(dense), nodes=cap, ms=host_ms(block, reps),
                rows_ms=host_ms(lambda: eng._compute_device_rows(dense, sig_rep, cap, out={}),
                                reps))


def _dense_sigs_host(pl, dense, dev):
    """The dense signatures as ``DeviceSigs`` for the plain version (on the
    rows' device, which both trees' plain versions take)."""
    cols = [[] for _ in range(7)]
    for greq, rdma_req, _cs, _bp, _ep in dense:
        c, r = greq if greq is not None else (0, 0)
        multi = greq is not None and c >= 100
        vals = (greq is not None, multi, c // 100 if multi else 0, 0 if multi else c,
                0 if multi else r, (1 if rdma_req > 0 else 0) if greq is not None else rdma_req,
                not (multi and c % 100))
        for k, v in enumerate(vals):
            cols[k].append(v)
    return pl.DeviceSigs(*(torch.tensor(c, dtype=torch.bool if k in (0, 1, 6) else torch.int32,
                                        device=dev) for k, c in enumerate(cols)))


def dev_study(dev, reps: int = 21) -> int:
    """``--dev``: ``dev_feasible`` through the public entry point
    (``core.placement``) at the kernel table's 16 x 16,384 with Gm 8 and 16
    and at 128 and 200 signatures (the launch parameters' cap and past it),
    each record a ``dev_record``; the engine's dense device block at the
    placement path's shapes (``dev_engine_block``); the ``-Xptxas -v``
    lines of the device library; the edge cases of ``dev_cases`` and the
    rows' binding (``dev_case_faults``).  ``--root`` takes another
    checkout of the port: run two checkouts alternately in one call.  One
    ``dev_study`` JSON line."""
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.core import placement as pl

    print(f"package: {cuda.CSRC.parent}", flush=True)
    libs = cuda.build()
    out = dict(ptxas=ptxas_report(libs["device"], ""), cases=[])
    for line in out["ptxas"]:
        print(f"  ptxas device: {line}")
    for M, Gm in ((16, 8), (16, 16), (128, 8), (200, 8)):
        rec = dev_record(pl, cuda, M, 16_384, Gm, reps)
        out["cases"].append(rec)
        print(f"  dev_feasible {M}x{rec['N']} Gm {Gm}: equal plain; call {rec['ms']:.4f} ms "
              f"(a packed block {rec.get('ms_block', float('nan')):.4f}, host "
              f"{rec.get('host_ms_block', float('nan')) * 1e3:.1f} us) "
              f"(run {rec['ms_run']:.4f}), device {rec['device_ms']:.4f} ms in "
              f"{rec['device_events']:.0f} activities, host {rec['host_ms'] * 1e3:.1f} us; "
              f"bound {rec['bound_ms']:.5f} ms; split us "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["split_us"].items()), flush=True)
    out["engine_block"] = dev_engine_block(dev, reps)
    eb = out["engine_block"]
    print(f"  the engine's dense device block: {eb['signatures']} signatures x {eb['nodes']} "
          f"nodes, {eb['ms']:.4f} ms; _compute_device_rows over them {eb['rows_ms']:.4f} ms",
          flush=True)
    out["ds_cases"] = []
    for M, N in DS_SHAPES:
        rec = ds_record(pl, cuda, dev, M, N, reps)
        out["ds_cases"].append(rec)
        print(f"  ds_score {M}x{N}: equal plain; call {rec['ms']:.4f} ms (run "
              f"{rec['ms_run']:.4f}), device {rec['device_ms']:.4f} ms in "
              f"{rec['device_events']:.0f} activities, host {rec['host_ms'] * 1e3:.1f} us; stage "
              f"{rec.get('ms_stage', float('nan')):.4f} ms (run "
              f"{rec.get('ms_stage_run', float('nan')):.4f}, device "
              f"{rec.get('device_ms_stage', float('nan')):.4f} in "
              f"{rec.get('device_events_stage', float('nan')):.0f}, host "
              f"{rec.get('host_ms_stage', float('nan')) * 1e3:.1f} us); bound "
              f"{rec['bound_ms']:.5f} ms; split us "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["split_us"].items()), flush=True)
    out["ds_engine_block"] = ds_engine_block(dev, reps)
    eb = out["ds_engine_block"]
    print(f"  the engine's ds score block: {eb['requests']} requests x {eb['nodes']} nodes, "
          f"{eb['ms']:.4f} ms; device {eb['device_ms']:.4f} ms in {eb['device_events']:.0f} "
          "activities", flush=True)
    out["case_faults"] = dev_case_faults(dev)
    print(f"  dev edge cases: {len(dev_cases(dev))}; outcomes {out['case_faults']}", flush=True)
    print(json.dumps({"dev_study": out, "card": card_line()}))
    return 0


DS_SHAPES = ((16, 16_384), (200, 16_384))  # the kernel table's shape, and past the parameters' cap


def ds_inputs(dev, M: int, N: int, seed: int):
    """``ds_score``'s inputs at M requests x N nodes (``device_inputs``,
    Gm 8): the six device rows a ``DeviceStage`` binds (core, mem, full,
    vfs, alloc2, used2) and the [M, 2] int64 requests on ``dev``."""
    (core, mem, full, vfs, _), (req, alloc2, used2) = device_inputs(dev, M, N, 8, seed)
    return (core, mem, full, vfs, alloc2, used2), req


def ds_host_split(pl, cuda, rows, req, reps: int) -> dict:
    """Host microseconds of a ``ds_score`` call by step, each in a loop of
    its own: this tree's (the requests packed into their host block as the
    engine packs them, the stage's key test, the output, the launch from the
    bound stage with the block uploaded beforehand past the parameters'
    cap, the stage's call, the public call on requests on the card) or the
    parent's (the three inputs' ``contiguous``, the output, the launch with
    its eight arguments, the public call)."""
    alloc2, used2 = rows[4:]
    dev = alloc2.device
    M, N = req.shape[0], alloc2.shape[0]
    out = torch.empty((M, N), dtype=torch.int64, device=dev)
    if hasattr(pl.DeviceStage, "score"):
        stage = pl.DeviceStage()
        stage.bind(rows)
        block = np.ascontiguousarray(req.cpu().numpy())
        greqs = [tuple(int(v) for v in r) for r in block]
        dblock = torch.from_numpy(block).to(dev) if M > cuda.DS_REQ_CAP else None
        dptr = 0 if dblock is None else dblock.data_ptr()
        steps = dict(pack=lambda: np.array(greqs, dtype=np.int64),
                     bound_to=lambda: stage.bound_to(rows),
                     output=lambda: torch.empty((M, N), dtype=torch.int64, device=dev),
                     launch=lambda: cuda.DS_SCORE.launch(
                         stage._desc_ptr, block.__array_interface__["data"][0], dptr, M, 1,
                         out.data_ptr(), cuda.stream(dev)),
                     stage=lambda: stage.score(block, 1),
                     call=lambda: pl.ds_score(req, alloc2, used2))
    else:
        steps = dict(contiguous=lambda: [t.contiguous() for t in (req, alloc2, used2)],
                     output=lambda: torch.empty((M, N), dtype=torch.int64, device=dev),
                     launch=lambda: cuda.DS_SCORE.launch(
                         req.data_ptr(), alloc2.data_ptr(), used2.data_ptr(), M, N,
                         out.data_ptr(), cuda.device_index(dev), cuda.stream(dev)),
                     call=lambda: pl.ds_score(req, alloc2, used2))
    return {name: per_call_us(fn, reps) for name, fn in steps.items()}


def ds_record(pl, cuda, dev, M: int, N: int, reps: int) -> dict:
    """``ds_score`` at M requests x N nodes, equal to its plain version
    first: the public call (events around one call and a run of 100, the
    profiler's device time and activities, the host time, the split by
    step) and, on a tree whose ``DeviceStage`` scores, the stage's call on
    the requests' host block as the engine makes it (weights 1 and the
    numa weight equal to the plain version times the weight); the bytes
    bound; medians of ``reps``."""
    from koordinator_tpu_torch.core.cycle import PluginWeights

    rows, req = ds_inputs(dev, M, N, SEED + 22)
    alloc2, used2 = rows[4:]
    want = pl.ds_score_plain(req, alloc2, used2)
    call = lambda: pl.ds_score(req, alloc2, used2)  # noqa: E731
    require_equal(f"ds_score {M}x{N}", (call(),), (want,))
    ev = device_events(call, reps)
    rec = dict(name="ds_score", M=M, N=N, ms=cuda_ms(call, reps=reps), ms_run=run_ms(call),
               device_ms=device_time(ev), device_events=device_activities(ev), events=ev,
               host_ms=host_ms(call, reps), split_us=ds_host_split(pl, cuda, rows, req, reps),
               bound_ms=bound_ms(nbytes(alloc2, used2, req) + M * N * 8, 0)[0])
    if hasattr(pl.DeviceStage, "score"):
        stage = pl.DeviceStage()
        stage.bind(rows)
        block = np.ascontiguousarray(req.cpu().numpy())
        for w in sorted({1, PluginWeights().numa, 7}):
            require_equal(f"ds_score stage {M}x{N} weight {w}", (stage.score(block, w),),
                          (want * w,))
        scall = lambda: stage.score(block, PluginWeights().numa)  # noqa: E731
        sev = device_events(scall, reps)
        rec.update(ms_stage=cuda_ms(scall, reps=reps), ms_stage_run=run_ms(scall),
                   host_ms_stage=host_ms(scall, reps), device_ms_stage=device_time(sev),
                   device_events_stage=device_activities(sev), events_stage=sev)
    return rec


def ds_engine_block(dev, reps: int) -> dict:
    """The engine's deviceshare score block at the placement path's shapes:
    a card engine over ``placement_store`` at ``NUM_NODES`` schedules the
    placement phase's batch once, and the GPU requests are captured as
    ``_compute_device_score_rows`` receives them; its rows into a fresh
    cache equal the plain version times the numa weight, zero off the GPU
    nodes; then the host clock around the block after a synchronise
    (medians of ``reps``) and its device activities."""
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.core import placement as pl
    from koordinator_tpu_torch.core.cycle import PluginWeights
    from koordinator_tpu_torch.service.engine import Engine
    from koordinator_tpu_torch.utils.fixtures import NOW

    st = placement_store((BATCH_CPU, BATCH_MEMORY), NUM_NODES)
    eng = Engine(st, device=dev)
    batch = placement_batch(NUM_NODES, NUM_PODS, "place", SEED + 31)
    seen = []
    orig = eng._compute_device_score_rows

    def record(greqs, cap, *a, **k):
        seen.append((list(greqs), cap))
        return orig(greqs, cap, *a, **k)

    eng._compute_device_score_rows = record
    st.publish(NOW)
    eng.schedule(batch, now=NOW)
    eng._compute_device_score_rows = orig
    greqs, cap = seen[0]
    out: dict = {}
    eng._compute_device_score_rows(greqs, cap, out=out)
    alloc2, used2 = eng._device_node_rows()[4:6]
    req = torch.tensor(greqs, dtype=torch.int64, device=dev)
    off = torch.from_numpy(~st._dv_in_gpus[:cap]).to(dev)
    want = torch.where(off, torch.zeros((), dtype=torch.int64, device=dev),
                       pl.ds_score_plain(req, alloc2, used2) * PluginWeights().numa)
    require_equal("the engine's ds rows", tuple(out[g] for g in greqs), tuple(want))
    block = lambda: eng._compute_device_score_rows(greqs, cap, out={})  # noqa: E731
    ev = device_events(block, reps)
    return dict(requests=len(greqs), nodes=cap, ms=host_ms(block, reps),
                device_ms=device_time(ev), device_events=device_activities(ev), events=ev)


ADOPT_TABLES = ("rows", "policy", "device")


def adopt_host_split(sm, host, dev, reps: int = 5, loop: int = 20) -> dict:
    """Host microseconds of one table's adoption by step, each in a loop of
    its own: this tree's (the arrays packed into the reused pinned staging
    as ``UploadStage`` packs them, on ``PACK_THREADS`` host threads, and by
    the calling thread alone; the one copy's issue into a fresh slab; the
    whole ``dstate_rows``) or the parent's (each array pinned afresh, the
    per-array copies' issue from arrays pinned beforehand, the whole
    ``dstate_rows``)."""
    if hasattr(sm, "_ADOPT"):
        stage, pin = sm.UploadStage(), dev.type != "cpu"
        _, total = stage._pack(host, pin)
        staged = stage._host

        def pack_alone():
            keep = sm.PACK_THREADS
            sm.PACK_THREADS = 1
            try:
                stage._pack(host, pin)
            finally:
                sm.PACK_THREADS = keep

        steps = dict(pack=lambda: stage._pack(host, pin), pack_one_thread=pack_alone,
                     copy=lambda: torch.empty(total, dtype=torch.uint8, device=dev).copy_(
                         staged[:total], non_blocking=True))
    else:
        pinned = [sm._host_tensor(a).pin_memory() for a in host]
        steps = dict(pin=lambda: [sm._host_tensor(a).pin_memory() for a in host],
                     copy=lambda: [torch.empty(p.shape, dtype=p.dtype, device=dev).copy_(
                         p, non_blocking=True) for p in pinned])
    steps["call"] = lambda: sm.dstate_rows(host, dev)
    return {name: per_call_us(fn, reps, loop) for name, fn in steps.items()}


def adopt_record(sm, res, st, name: str, dev, reps: int) -> dict:
    """One resident table's cold adoption at the store's capacity: through
    the residency (``invalidate`` then ``_sync``: the adoption and the
    stages' binds) and ``dstate_rows`` alone, CUDA events around one call
    (the host's packing and the copy's issue included) and the host clock,
    the split by step, one PyTorch call per array from pageable memory
    (``torch.from_numpy(a).to(dev)``, the library column) and the PCIe
    bound; the buffers equal the host arrays byte for byte first and, on a
    tree with the adoption stage, sit in one slab at 256-byte offsets."""
    t = res._tables[name]
    host = [getattr(st, a) for a in t.attrs]
    size = sum(a.nbytes for a in host)

    def residency():
        res.invalidate(name)
        res._sync(name)

    residency()
    if res.verify((name,)) != len(host):
        fail(f"adoption of the {name} table: the audit checked the wrong arrays")
    bufs = sm.dstate_rows(host, dev)
    for a, b in zip(host, bufs):
        if not np.array_equal(b.cpu().numpy().view(np.uint8), np.ascontiguousarray(a).view(
                np.uint8)):
            fail(f"dstate_rows {name}: a buffer differs from its host array")
    rec = dict(table=name, arrays=len(host), bytes=size, rows=host[0].shape[0])
    if hasattr(sm, "_ADOPT"):
        fault = slab_fault(bufs, dev)
        if fault:
            fail(f"dstate_rows {name}: {fault}")
    library = lambda: [torch.from_numpy(a).to(dev) for a in host]  # noqa: E731
    rows_call = lambda: sm.dstate_rows(host, dev)  # noqa: E731
    rec.update(ms=cuda_ms(residency, reps=reps), host_ms=host_ms(residency, reps),
               ms_rows=cuda_ms(rows_call, reps=reps), host_ms_rows=host_ms(rows_call, reps),
               split_us=adopt_host_split(sm, host, dev), library_ms=cuda_ms(library, reps=reps),
               bound_ms=size / PCIE_BYTES_PER_S * 1e3, bound_by="bytes over PCIe Gen5 x16")
    return rec


class AdoptionCount:
    """Cold adoptions (``DeviceResidency.full_uploads``) of the card's
    residencies made while installed: ``take`` returns the sum over the
    residencies bound to a card since the last take (a CPU twin's are not
    counted)."""

    def __enter__(self):
        from koordinator_tpu_torch.service import state as sm

        self._cls, self._orig, self._made = sm.DeviceResidency, sm.DeviceResidency.__init__, []
        orig, made = self._orig, self._made

        def init(res, *a, **k):
            orig(res, *a, **k)
            made.append(res)

        self._cls.__init__ = init
        return self

    def __exit__(self, *exc):
        self._cls.__init__ = self._orig

    def take(self) -> int:
        n = sum(r.full_uploads for r in self._made
                if r.device is not None and r.device.type == "cuda")
        self._made.clear()
        return n


def adoption_paths(dev, scalars) -> dict:
    """Each path of the full run driven once (``--paths``), its cold
    adoptions counted (``AdoptionCount``); the cold path runs on host-built
    arrays and adopts nothing, so it is not driven."""
    out = {}
    with AdoptionCount() as count:
        for path, drive in (("warm", drive_warm_path), ("constraints", drive_con_path),
                            ("placement", drive_placement_path),
                            ("strategies", drive_strategy_path),
                            ("sidecar+descheduler", drive_sidecar_path),
                            ("koordlet", drive_koordlet_path)):
            t0 = time.perf_counter()
            drive(dev, NUM_NODES, NUM_PODS, scalars)
            out[path] = count.take()
            print(f"  {path}: {out[path]} cold adoptions ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        drive_library_path(dev, NUM_NODES, NUM_PODS)
        out["library"] = count.take()
    return out


def adopt_study(dev, reps: int = 21) -> int:
    """``--adopt``: the three resident tables' cold adoption at
    ``NUM_NODES`` (``placement_store``: 16,384 rows, devices and policies),
    each an ``adopt_record``; with ``--paths``, each path's cold adoptions
    (``adoption_paths``).  ``--root`` takes another checkout of the port:
    run two checkouts alternately in one call.  One ``adopt_study`` JSON
    line."""
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.service import state as sm

    print(f"package: {sm.__file__}", flush=True)
    scalars = (BATCH_CPU, BATCH_MEMORY)
    st = placement_store(scalars, NUM_NODES)
    res = st.residency
    res._bind(dev)
    out = dict(tables=[])
    for name in ADOPT_TABLES:
        rec = adopt_record(sm, res, st, name, dev, reps)
        out["tables"].append(rec)
        print(f"  {name}: {rec['arrays']} arrays, {rec['bytes']} bytes at {rec['rows']} rows; "
              f"residency {rec['ms']:.4f} ms (host {rec['host_ms']:.4f}), dstate_rows "
              f"{rec['ms_rows']:.4f} (host {rec['host_ms_rows']:.4f}); library "
              f"{rec['library_ms']:.4f}; bound {rec['bound_ms']:.4f}; split us "
              + ", ".join(f"{k} {v:.1f}" for k, v in rec["split_us"].items()), flush=True)
    if "--paths" in sys.argv:
        from koordinator_tpu_torch import cuda

        cuda.build()
        out["full_uploads_by_path"] = adoption_paths(dev, scalars)
    print(json.dumps({"adopt_study": out, "card": card_line()}))
    return 0


def main() -> int:
    if "--root" in sys.argv:
        # time another checkout's port (a parent commit unpacked beside)
        sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--root") + 1]))
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA card", file=sys.stderr)
        return 1
    if "--rounds" in sys.argv:
        return round_study(torch.device("cuda:0"))
    if "--scan" in sys.argv:
        return scan_study(torch.device("cuda:0"))
    if "--spread" in sys.argv:
        return spread_study(torch.device("cuda:0"))
    if "--agg" in sys.argv:
        return agg_study(torch.device("cuda:0"))
    if "--score" in sys.argv:
        return score_study(torch.device("cuda:0"))
    if "--desched" in sys.argv:
        return desched_study(torch.device("cuda:0"))
    if "--rsv" in sys.argv:
        return rsv_study(torch.device("cuda:0"))
    if "--shard" in sys.argv:
        return shard_study(torch.device("cuda:0"))
    if "--gate" in sys.argv:
        return gate_study(torch.device("cuda:0"))
    if "--place" in sys.argv:
        return place_study(torch.device("cuda:0"))
    if "--band" in sys.argv:
        return band_study(torch.device("cuda:0"))
    if "--restate" in sys.argv:
        return restate_study(torch.device("cuda:0"))
    if "--refresh" in sys.argv:
        return refresh_study(torch.device("cuda:0"))
    if "--quota" in sys.argv:
        return quota_study(torch.device("cuda:0"))
    if "--la" in sys.argv:
        return la_study(torch.device("cuda:0"))
    if "--nf" in sys.argv:
        return nf_study(torch.device("cuda:0"))
    if "--dev" in sys.argv:
        return dev_study(torch.device("cuda:0"))
    if "--adopt" in sys.argv:
        return adopt_study(torch.device("cuda:0"))
    from koordinator_tpu_torch import cuda
    from koordinator_tpu_torch.api.model import BATCH_CPU, BATCH_MEMORY
    from koordinator_tpu_torch.utils.fixtures import random_cluster

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    kind = torch.cuda.get_device_name(0)
    scalars = (BATCH_CPU, BATCH_MEMORY)

    t0 = time.perf_counter()
    # every library the paths load, and the scan's study build (the division
    # check), one nvcc each, all started together
    libs = cuda.build([src.stem for src in sorted(cuda.CSRC.glob("*.cu"))
                       if src.stem != "roundstudy"])
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    # the kernel (templates: ILb0E plain, ILb1E constrained)
                    line = line.split("'")[1] if "'" in line else line
                if any(w in line for w in ("registers", "spill", "_Z")):
                    print(f"  ptxas {path.stem}: {line.strip()}")

    print("kernels vs plain versions:", flush=True)
    pods, nodes = random_cluster(SEED, num_nodes=300, num_pods=50)
    small = build_inputs(pods, nodes, dev, scalars)
    for cap in (1, 16, 100):
        check_kernels(small, cap, timed=False)
    check_kernels(ragged(small, 300, 50), 16, timed=False)
    check_warm_kernels(small, (16, 128), timed=False)
    check_warm_kernels(small, (16,), timed=False, commit_cap=100)
    for cpd in (0, 2):
        check_con_kernels(small, cpd, timed=False)
    check_con_kernels(small, 0, timed=False, commit_cap=1)
    check_rsv_kernels(small, timed=False)
    check_placement_kernel(dev, 32, 600, 700, timed=False)
    check_placement_cases(dev)
    for gm in (8, 16):
        check_device_kernels(dev, 16, 500, gm, timed=False)
    check_extend_kernel(dev, 300, timed=False)
    check_extend_cases(dev)
    check_scatter_cases(dev)
    for con in (False, True):
        check_extra_kernels(small, con, timed=False)
    check_extra_kernels(small, True, timed=False, commit_cap=1)
    check_strategies_small(small)
    check_score_cases(dev, small)
    check_la_cases(dev, small)
    check_nf_cases(dev, small)
    check_dev_cases(dev)
    check_repair_cases(dev)
    check_shard_cases(dev)
    check_gate_cases(dev)
    check_rsv_cases(dev)
    check_div_helper(dev)
    # the explain slice's kernels at 64 pods x 512 columns, and at a node
    # axis that is not a multiple of the block width (267) by 45 pods
    small512 = build_inputs(*random_cluster(SEED, num_nodes=500, num_pods=64), dev, scalars)
    # the scan at 64 x 512: each strategy, then the step kernel's invariant
    # cases
    for name, static in strategy_statics(small512["static"]):
        for con in (False, True):
            check_scan_kernels(small512, static, con, "salted", True, timed=False)
    check_scan_edges(small512)
    check_breakdown_kernels(small512, timed=False)
    check_breakdown_kernels(ragged(small, 267, 45), timed=False)
    # the descheduler's kernels at the small shapes
    check_desched_kernels(dev, timed=False)
    check_desched_cases(dev)
    check_band_kernels(dev, timed=False)
    check_band_cases(dev)
    # the koordlet slice's kernels at the small shapes
    check_shard_kernels(small512, (1, 2, KOORDLET_SHARDS), timed=False)
    check_metricsagg_kernels(dev)
    check_agg_cases(dev)
    del small512
    # the round loop's edge cases over a grid of many blocks
    many = build_inputs(*random_cluster(SEED, num_nodes=2000, num_pods=1000), dev, scalars)
    for case in ROUND_CASES:
        rec = check_round_case(many, case)
        print(f"  round loop, {case}: equal plain, {rec['rounds']} rounds, grid {rec['grid']}")
    rec = check_round_hot_node(many)
    print(f"  round loop, one node every round: equal plain, {rec['rounds']} rounds, grid "
          f"{rec['grid']}", flush=True)
    del many
    pods, nodes = random_cluster(SEED, num_nodes=NUM_NODES, num_pods=NUM_PODS)
    full = build_inputs(pods, nodes, dev, scalars)
    records = check_kernels(full, 16, timed=True)
    print("round loop: the four knob settings, the one-pod probe, a round's synchronisation",
          flush=True)
    round_loop = check_round_loop(full)
    warm_records, transfers = check_warm_kernels(full, (16, 128, 1024), timed=True)
    records += warm_records
    records += check_con_kernels(full, 0, timed=True)
    check_con_kernels(full, 2, timed=False)
    records += check_quota_kernels(dev, timed=True)
    records += check_rsv_kernels(full, timed=True)
    # the placement-and-devices kernels at the phase's shapes, and the
    # schedule kernels with a random mask and extra scores
    n_cols = full["valid"].shape[0]
    records.append(check_placement_kernel(dev, 256, n_cols, 16_384, timed=True))
    dev_recs = {gm: check_device_kernels(dev, 16, n_cols, gm, timed=True) for gm in (8, 16)}
    for rec, rec16 in zip(dev_recs[8], dev_recs[16]):
        records.append(dict(rec, ms_gm16=rec16["ms"], plain_ms_gm16=rec16["plain_ms"],
                            bound_ms_gm16=rec16["bound_ms"]))
    records.append(check_extend_kernel(dev, n_cols, timed=True))
    extra_ms = {}
    for con in (False, True):
        extra_ms.update(check_extra_kernels(full, con, timed=True))
    for rec in records:
        if rec["name"] in extra_ms:
            rec["ms_extras"] = extra_ms[rec["name"]]
    # the strategies: score under MostAllocated and RTC, the scan (plain and
    # constrained, both tie-breaks, with extras), the int64-key engine
    records += check_strategies_full(full, records)
    records += check_breakdown_kernels(full, timed=True)
    records.append(check_shard_kernels(full, (KOORDLET_SHARDS,), timed=True))
    desched_bench = check_desched_kernels(dev, timed=True)
    records.append(check_band_kernels(dev, timed=True))
    print(f"matrix route: {NUM_NODES} nodes x {NUM_PODS} pods, int64 keys", flush=True)
    matrix_launches = drive_matrix_path(full, con=False)
    con_matrix = drive_matrix_path(full, con=True)
    matrix_launches = {k: v + con_matrix[k] for k, v in matrix_launches.items()}
    del full
    torch.cuda.empty_cache()

    # each path's cold adoptions (the cold path's arrays are host-built)
    with AdoptionCount() as adoptions:
        adopted = {}
        print(f"cold path: {NUM_NODES} nodes x {NUM_PODS} pods, host-built node arrays", flush=True)
        cold_launches, main_ms, main_kernel_ms = drive_main_path(dev, NUM_NODES, NUM_PODS, pods,
                                                                 scalars)
        adopted["cold"] = adoptions.take()
        print(f"warm path: {NUM_NODES} nodes x {NUM_PODS} pods, resident node tables", flush=True)
        warm_launches, warm_cycles = drive_warm_path(dev, NUM_NODES, NUM_PODS, scalars)
        adopted["warm"] = adoptions.take()
        print(f"constraint path: {NUM_NODES} nodes x {NUM_PODS} pods, gangs, quota and "
              f"reservations, resident node tables", flush=True)
        con_launches, con_cycles = drive_con_path(dev, NUM_NODES, NUM_PODS, scalars)
        adopted["constraints"] = adoptions.take()
        print(f"placement-and-devices path: {NUM_NODES} nodes x {NUM_PODS} pods, selectors, "
              f"taints, anti-affinity, GPU/RDMA/cpuset pods, resident node tables", flush=True)
        place_launches, place_cycles = drive_placement_path(dev, NUM_NODES, NUM_PODS, scalars)
        adopted["placement"] = adoptions.take()
        print(f"strategies path: {NUM_NODES} nodes x {NUM_PODS} pods, MostAllocated over gangs, "
              f"quota and reservations; RequestedToCapacityRatio over selectors, taints, "
              f"anti-affinity and GPU/RDMA/cpuset pods; the scan kernel", flush=True)
        strat_launches, strat_cycles = drive_strategy_path(dev, NUM_NODES, NUM_PODS, scalars)
        adopted["strategies"] = adoptions.take()
        print(f"library path: loadaware_score_and_filter over {NUM_NODES} nodes x {NUM_PODS} pods",
              flush=True)
        lib_launches, lib_ms = drive_library_path(dev, NUM_NODES, NUM_PODS)
        adopted["library"] = adoptions.take()
        print(f"sidecar path: {NUM_NODES} nodes x {NUM_PODS} pods over the KTPU wire, the card's "
              "sidecar against a CPU twin; then the descheduler path over the same fleet",
              flush=True)
        side_launches, side_verbs, (desched_launches, desched_ticks, fleet_round) = \
            drive_sidecar_path(dev, NUM_NODES, NUM_PODS, scalars)
        adopted["sidecar+descheduler"] = adoptions.take()
        # the round at the fleet's own shape, on the pool's inputs after the
        # last tick; bench_sim's shape beside it
        want, rec = check_desched_round(
            "fleet", fleet_round["state"], fleet_round["nodes"], fleet_round["pods"],
            fleet_round["low"], fleet_round["high"], fleet_round["weights"], timed=True,
            **fleet_round["kw"])
        records.append(dict(rec, ms_bench_sim=desched_bench["ms"],
                            plain_ms_bench_sim=desched_bench["plain_ms"],
                            bound_ms_bench_sim=desched_bench["bound_ms"],
                            ms_bench_sim_deviation=desched_bench["ms_deviation"],
                            plain_ms_bench_sim_deviation=desched_bench["plain_ms_deviation"]))
        print(f"  deschedule_round at the fleet's shape ({rec['shape']}): equal plain, "
              f"{int(want.evicted.sum())} evictions, {rec['ms']:.3f} ms (plain "
              f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.5f} ms)", flush=True)
        print(f"koordlet path: {NUM_NODES} nodes' koordlets report into a sidecar with shards="
              f"{KOORDLET_SHARDS}; the mesh in process", flush=True)
        kl_launches, kl_records, kl_windows = drive_koordlet_path(dev, NUM_NODES, NUM_PODS, scalars)
        adopted["koordlet"] = adoptions.take()
    rec = check_metricsagg_kernels(dev, kl_windows, timed=True)
    del kl_windows
    records.append(rec)
    print(f"  aggregate_node_metrics at the fleet's shape ({rec['shape']}): {rec['ms']:.3f} ms "
          f"a call, {rec['device_ms']} ms of kernel (plain {rec['plain_ms']:.3f} ms, bound "
          f"{rec['bound_ms']:.4f} ms); the windows {rec['variants']}", flush=True)
    for path, launched, kernels in (
        ("cold", cold_launches, ("score", "schedule_keys", "schedule_rounds")),
        ("warm", warm_launches, WARM_PATH_KERNELS),
        ("constraint", con_launches, CON_PATH_KERNELS),
        ("placement", place_launches, PLACE_PATH_KERNELS),
        ("strategies", strat_launches, STRATEGY_PATH_KERNELS),
        ("matrix", matrix_launches, ("schedule_keys64", "schedule_rounds64",
                                     "schedule_keys64_con", "schedule_rounds64_con")),
        ("library", lib_launches, ("loadaware_score_and_filter",)),
        ("sidecar", side_launches, SIDECAR_PATH_KERNELS),
        ("descheduler", desched_launches, DESCHED_PATH_KERNELS),
        ("koordlet", kl_launches, KOORDLET_PATH_KERNELS),
    ):
        idle = [k for k in kernels if launched[k] == 0]
        if idle:
            fail(f"the {path} path never launched {idle}")
    print(f"  launches on the cold path {cold_launches}; on the warm path {warm_launches}; on "
          f"the constraint path {con_launches}; on the placement path {place_launches}; on the "
          f"strategies path {strat_launches}; on the matrix route {matrix_launches}; on the "
          f"library path {lib_launches}; on the sidecar path {side_launches}; on the "
          f"descheduler path {desched_launches}; on the koordlet path {kl_launches}")

    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "rounds", "ub_rounds",
            "dirty_rows", "groups", "ms_extras", "ms_gm16", "plain_ms_gm16", "bound_ms_gm16",
            "strategies_ms", "variants", "placed", "shape", "steps_plain_ms", "keys_bound_ms",
            "steps_bound_ms", "keys_device_ms", "steps_device_ms", "ms_bench_sim",
            "plain_ms_bench_sim", "bound_ms_bench_sim", "ms_bench_sim_deviation",
            "plain_ms_bench_sim_deviation", "device_split_ms", "score_ms", "ms_run",
            "library_ms_run", "residency_ms", "bound_over", "device_ms", "ms_one_pod",
            "plain_ms_one_pod", "bound_ms_one_pod", "floor_ms", "floor_ms_run")
    kernels = []
    for rec in records:
        name = rec["name"]
        by_path = {"cold": cold_launches[name], "warm": warm_launches[name],
                   "constraints": con_launches[name], "placement": place_launches[name],
                   "strategies": strat_launches[name], "matrix": matrix_launches[name],
                   "library": lib_launches[name], "sidecar": side_launches[name],
                   "descheduler": desched_launches[name], "koordlet": kl_launches[name]}
        # only dstate_scatter (index_copy_) and dstate_extend (F.pad) have a
        # PyTorch call computing the same function; the others have none
        rec = dict(rec, route="cuda", launches=sum(by_path.values()), launches_by_path=by_path)
        rec.setdefault("library_ms", None)
        kernels.append({k: v for k, v in rec.items() if k in keys})
    transfers[0]["full_uploads_by_path"] = adopted
    print(f"  cold adoptions by path {adopted}", flush=True)
    print(json.dumps({"kernels": kernels, "transfers": transfers, "card": card,
                      "main_path_ms": main_ms, "main_path_kernel_ms": main_kernel_ms,
                      "warm_cycles": warm_cycles, "constraint_cycles": con_cycles,
                      "placement_cycles": place_cycles, "strategy_cycles": strat_cycles,
                      "library_call_ms": lib_ms, "sidecar_verbs": side_verbs,
                      "descheduler_ticks": desched_ticks, "koordlet_path": kl_records,
                      "round_loop": round_loop}))
    print(f"device: {kind} | {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Mismatch as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
