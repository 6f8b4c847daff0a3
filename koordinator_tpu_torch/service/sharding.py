"""Node-axis sharding for the serving engine.

The port of the JAX package's ``service/sharding.py``.  The store's
epoch-stamped rows are partitioned into S contiguous column blocks of the
capacity axis ("shards").  Every per-(pod, node) computation the engine
serves (the LoadAware/NodeFit score and filter, the placement-policy mask,
device feasibility and the deviceshare scores) is per-column math, so a
shard evaluates on its own and the merge of the S blocks equals the
unsharded result by construction; the parity tests pin it anyway.

Two execution modes share one ownership layout:

- **slice mode** (default): each shard's ``score`` kernel launch runs over
  its slice of the node tables, behind a per-shard epoch cache.  The store
  stamps every row with the epoch at which it last changed (``_row_ver``,
  ``_pp_row_ver``, ``_dv_row_ver``); a shard's version is the largest stamp
  over its block, and a mutation confined to one shard leaves every other
  shard's cached mask rows and score blocks as they were.  Each block comes
  back to the host once.
- **mesh mode** (``shard_map=True``): the ``shard_score_map`` kernel (the
  ``score`` kernel over a column block, ``csrc/score.cu``
  ``koord_shard_score``), one launch per mesh device over that device's
  block.  The mesh is ``devices`` (default ``cuda:0 .. cuda:S-1``; fewer
  devices than shards are refused).  Blocks on the engine's own device
  write straight into one [P, cap] buffer from one validated layout of the
  pair tables; a block on another card gets the pod rows and its node rows
  copied over and comes back once.  The mask and feasibility inputs still
  come from the per-shard caches.

Scheduling reuses the wrapped ``Engine`` end to end: ``schedule`` hands it
this object as its ``_inputs_provider``, so the placement-and-devices
inputs come from the per-shard caches and the warm carry keys on the shard
layout, while the queue order, the constraints, the allocation replay and
the assume path are the engine's own code.

``topk_merge`` is the host-side scatter-gather top-k: per-shard candidate
lists merged into the global per-pod top-k, ties by ascending column.

The per-shard timing of the JAX package (``kernelprof.record_shard``)
arrives with the observability slice of the port.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import convert, cuda
from koordinator_tpu_torch.api.model import Pod
from koordinator_tpu_torch.core.cycle import score_batch, score_fn
from koordinator_tpu_torch.core.deviceshare import RDMA, parse_gpu_request
from koordinator_tpu_torch.service.engine import (
    Engine,
    _AdmittedBySig,
    _amped_nodes,
    _device_pods,
    _device_sig,
    _mask_sig_key,
)
from koordinator_tpu_torch.service.state import ClusterState, next_bucket


def shard_bounds(capacity: int, num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous block partition of the capacity axis.  Capacity buckets
    are powers of two and the shard count must divide them, so blocks stay
    equal-width."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if capacity % num_shards:
        raise ValueError(
            f"num_shards {num_shards} must divide the capacity bucket "
            f"{capacity} (buckets are powers of two; use a power-of-two "
            f"shard count)"
        )
    w = capacity // num_shards
    return [(s * w, (s + 1) * w) for s in range(num_shards)]


def topk_merge(totals, feasible, bounds, k: int):
    """Host-side scatter-gather top-k: per-shard candidate lists merged
    into the global per-pod top-k.

    Returns ``(idx [P, k] int32, scores [P, k] int64)``: global column
    indices ordered by (score desc, column asc); ``idx`` is -1 (score 0)
    past each pod's feasible count.  The composite key
    ``score * TB + (TB - 1 - column)`` is strictly monotone in (score desc,
    column asc), so each shard's partition cut is exact and the merged list
    equals the same cut of a global sort."""
    P = totals.shape[0]
    k = int(k)
    cap = bounds[-1][1]
    tb = 1 << max(int(cap - 1).bit_length(), 1)
    idx_out = np.full((P, k), -1, dtype=np.int32)
    sc_out = np.zeros((P, k), dtype=np.int64)
    for p in range(P):
        cand: List[np.ndarray] = []
        for lo, hi in bounds:
            cols = np.flatnonzero(feasible[p, lo:hi])
            if cols.size == 0:
                continue
            gcols = (lo + cols).astype(np.int64)
            key = totals[p, lo:hi][cols] * tb + (tb - 1 - gcols)
            if cols.size > k:
                part = np.argpartition(-key, k - 1)[:k]
                key, gcols = key[part], gcols[part]
            cand.append(np.stack([key, gcols]))
        if not cand:
            continue
        merged = np.concatenate(cand, axis=1)
        order = np.argsort(-merged[0], kind="stable")[:k]
        n = order.size
        gcols = merged[1, order]
        idx_out[p, :n] = gcols.astype(np.int32)
        sc_out[p, :n] = (merged[0, order] + gcols - (tb - 1)) // tb
    return idx_out, sc_out


def shard_score_map_plain(la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static, valid,
                          extra_scores, lo: int, hi: int, totals, feasible) -> None:
    """The plain version of ``shard_score_map``: ``score_batch`` over
    columns [lo, hi) of the node tables, plus those columns of the extra
    scores, ANDed with those of ``valid``, written into the same columns of
    ``totals`` and ``feasible``."""
    def cols(nt):
        return type(nt)(*(a[lo:hi] for a in nt))

    t, f = score_batch(la_pods, cols(la_nodes), la_weights, nf_pods, cols(nf_nodes), nf_static)
    if extra_scores is not None:
        t = t + extra_scores[:, lo:hi]
    totals[:, lo:hi] = t
    feasible[:, lo:hi] = f & valid[lo:hi][None, :]


def shard_score_map(la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static, valid,
                    extra_scores, lo: int, hi: int, totals, feasible) -> None:
    """One mesh device's block of SCORE: the JAX package's
    ``shard_score_map`` body (``score_batch`` + the extra scores, feasible
    AND ``valid``) over columns [lo, hi) of N, written into the same
    columns of ``totals`` [P, N] int64 and ``feasible`` [P, N] bool.  The
    node tables, ``valid`` [N] and ``extra_scores`` ([P, N] int64 or None)
    cover all N columns.  CPU tensors take the plain version; CUDA tensors
    launch the ``score`` kernel over the block (``csrc/score.cu``
    ``koord_shard_score``, every NodeFit strategy) or raise."""
    P, N = la_pods.est.shape[0], valid.shape[0]
    dev = valid.device
    if not 0 <= lo <= hi <= N:
        raise ValueError(f"shard_score_map: block [{lo}, {hi}) outside {N} columns")
    for what, t, dtype in (("totals", totals, torch.int64), ("feasible", feasible, torch.bool),
                           ("extra_scores", extra_scores, torch.int64)):
        if t is not None and (t.dtype != dtype or tuple(t.shape) != (P, N) or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: expected contiguous {dtype} {(P, N)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type == "cpu":
        shard_score_map_plain(la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static, valid,
                              extra_scores, lo, hi, totals, feasible)
        return
    args = cuda.pair_args(la_pods, la_nodes, la_weights, nf_pods, nf_nodes, nf_static, valid)
    _launch_block(args, extra_scores, P, N, lo, hi, totals, feasible, cuda.device_index(dev),
                  cuda.stream(dev))


def _launch_block(args, extra_scores, P: int, N: int, lo: int, hi: int, totals, feasible,
                  device: int, stream: int) -> None:
    """One ``shard_score_map`` launch over columns [lo, hi) of N from the
    pair tables ``args`` (``cuda.pair_args``), checked by the caller."""
    if P and hi > lo:
        cuda.SHARD_SCORE_MAP.launch(
            args.pods, args.nodes, args.cfg, args.la_w, args.valid,
            0 if extra_scores is None else extra_scores.data_ptr(), P, N, lo, hi - lo,
            totals.data_ptr(), feasible.data_ptr(), device, stream,
        )


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return a.type != "cuda" or cuda.device_index(a) == cuda.device_index(b)


class _ShardCache:
    """One shard's epoch-keyed caches: placement-mask rows, device
    feasibility rows, deviceshare score rows, and the last score block.
    Keys carry the shard's versions: a mutation elsewhere leaves them
    untouched."""

    __slots__ = ("sel_key", "sel_rows", "dev_key", "dev_rows", "ds_rows", "score_key",
                 "score_val")

    def __init__(self):
        self.sel_key: Optional[tuple] = None
        self.sel_rows: Dict[tuple, torch.Tensor] = {}
        self.dev_key: Optional[tuple] = None
        self.dev_rows: Dict[tuple, tuple] = {}
        self.ds_rows: Dict[tuple, torch.Tensor] = {}
        self.score_key: Optional[tuple] = None
        self.score_val: Optional[tuple] = None


class ShardedEngine:
    """The node-sharded serving engine: the inputs, outputs and store
    mutations of the ``Engine`` it wraps (the oracle), with the node axis
    evaluated per shard.  Single-threaded, as the engine it wraps.

    ``devices``: the mesh of ``shard_map=True``, one device a shard
    (default ``cuda:0 .. cuda:S-1`` for an engine on the card, the engine's
    own device otherwise); a device may repeat, and every block on the
    engine's device writes into one buffer."""

    def __init__(self, state: ClusterState, num_shards: int = 1, engine: Optional[Engine] = None,
                 shard_map: bool = False, devices=None):
        self.state = state
        self.engine = engine if engine is not None else Engine(state)
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.shard_map = bool(shard_map)
        self.devices: Optional[List[torch.device]] = None
        if self.shard_map:
            if devices is not None:
                have = [torch.device(d) for d in devices]
            elif self.engine.device.type == "cuda":
                have = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            else:
                have = [self.engine.device]
            if len(have) < self.num_shards:
                raise ValueError(f"shard_map mode needs >= {self.num_shards} devices, have "
                                 f"{len(have)}")
            self.devices = have[: self.num_shards]
        self._shards = [_ShardCache() for _ in range(self.num_shards)]
        # how many shard blocks the last slice-mode score served from cache
        # and how many it recomputed
        self.last_block_hits = 0
        self.last_block_misses = 0

    # ------------------------------------------------------------- layout

    def bounds(self, s: int) -> Tuple[int, int]:
        return shard_bounds(self.state.capacity, self.num_shards)[s]

    def all_bounds(self) -> List[Tuple[int, int]]:
        return shard_bounds(self.state.capacity, self.num_shards)

    def shard_versions(self, s: int) -> Dict[str, int]:
        """The shard's versions, the largest change stamp over its rows a
        family: the per-shard cache keys."""
        lo, hi = self.bounds(s)
        st = self.state
        return {
            "node": int(st._row_ver[lo:hi].max(initial=0)),
            "policy": int(st._pp_row_ver[lo:hi].max(initial=0)),
            "device": int(st._dv_row_ver[lo:hi].max(initial=0)),
        }

    # ----------------------------- the warm carry's provider hooks (engine)

    def sched_warm_token(self) -> tuple:
        """The provider's part of the engine's warm-carry and input-cache
        keys: the shard layout, so a carry taken under one partition (or
        solo) never seeds a cycle under another."""
        return ("shards", self.num_shards, tuple(self.all_bounds()))

    def sched_versions(self) -> tuple:
        """Per-shard (node, policy, device) watermarks: the sharded twin of
        ``ClusterState.sched_versions``."""
        return tuple((v["node"], v["policy"], v["device"])
                     for v in (self.shard_versions(s) for s in range(self.num_shards)))

    def sched_dirty_rows(self, vers: tuple) -> np.ndarray:
        """Rows advanced past the carry's per-shard watermarks; a shard whose
        versions equal the recorded triple contributes none without a scan."""
        st = self.state
        out = []
        for s, (lo, hi) in enumerate(self.all_bounds()):
            v0, v1, v2 = vers[s]
            cur = self.shard_versions(s)
            if (cur["node"], cur["policy"], cur["device"]) == (v0, v1, v2):
                continue
            rows = np.flatnonzero((st._row_ver[lo:hi] > v0) | (st._pp_row_ver[lo:hi] > v1)
                                  | (st._dv_row_ver[lo:hi] > v2))
            if rows.size:
                out.append((lo + rows).astype(np.int32))
        if not out:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(out)

    def cache_keys(self) -> List[dict]:
        """Per-shard live cache keys."""
        return [{"sel": sh.sel_key, "dev": sh.dev_key, "score": sh.score_key}
                for sh in self._shards]

    # ------------------------------------------ the engine's input hooks

    def _node_selector_mask(self, pods, p_bucket: int, cap: int):
        """The sharded twin of ``Engine._node_selector_mask``: per-shard rows
        from per-shard policy-epoch caches, assembled into one [p_bucket,
        cap] mask on the engine's device; None when nothing triggers a
        policy, as the engine's."""
        st = self.state
        eng = self.engine
        if not (any(p.node_selector or p.anti_affinity for p in pods) or st._tainted_nodes
                or st._aa_holder_count):
            return None
        sigs = [_mask_sig_key(p) for p in pods]
        uniq = list(dict.fromkeys(sigs))
        slot = {g: k + 1 for k, g in enumerate(uniq)}
        pick = np.zeros(p_bucket, dtype=np.int64)
        pick[: len(sigs)] = [slot[g] for g in sigs]
        pick_t = convert.tensor(pick, eng.device)
        buf = torch.empty((p_bucket, cap), dtype=torch.bool, device=eng.device)
        for s, (lo, hi) in enumerate(self.all_bounds()):
            sh = self._shards[s]
            skey = (self.shard_versions(s)["policy"], cap)
            if sh.sel_key != skey:
                sh.sel_rows, sh.sel_key = {}, skey
            missing = [g for g in uniq if g not in sh.sel_rows]
            if missing:
                eng._compute_mask_rows(missing, out=sh.sel_rows, cols=(lo, hi))
            rows = torch.stack([torch.ones(hi - lo, dtype=torch.bool, device=eng.device)]
                               + [sh.sel_rows[g] for g in uniq])
            buf[:, lo:hi] = rows[pick_t]
        return buf

    def _numa_device_inputs(self, pods: List[Pod], p_bucket: int, cap: int):
        """The sharded twin of ``Engine._numa_device_inputs``: per-shard
        device feasibility and deviceshare score rows from per-shard
        device-epoch caches (the exact walks ride the engine's fingerprint
        memo, which is shard-agnostic); the merged outputs and the admitted
        NUMA map equal the engine's."""
        st = self.state
        eng = self.engine
        relevant = _device_pods(pods)
        amped = _amped_nodes(st)
        if not relevant and not amped:
            return None, None, {}
        sig_groups: Dict[tuple, list] = {}
        sig_rep: Dict[tuple, Pod] = {}
        for i, p, greq, wants_cs in relevant:
            sig = _device_sig(p, greq, wants_cs)
            sig_groups.setdefault(sig, []).append(i)
            sig_rep.setdefault(sig, p)
        uniq = list(sig_groups)
        pick = np.zeros(p_bucket, dtype=np.int64)
        pod_sig: Dict[int, tuple] = {}
        for k, sig in enumerate(uniq):
            for i in sig_groups[sig]:
                pick[i] = k + 1
                pod_sig[i] = sig
        gpu_pods = [(i, greq) for i, _, greq, _ in relevant if greq is not None]
        want_ds = bool(gpu_pods) and bool(st._dv_in_gpus.any())
        greqs = list(dict.fromkeys(g for _, g in gpu_pods))
        ds_slot = {g: k + 1 for k, g in enumerate(greqs)}
        ds_pick = np.zeros(p_bucket, dtype=np.int64)
        for i, g in gpu_pods:
            ds_pick[i] = ds_slot[g]
        dev = eng.device
        pick_t, ds_pick_t = convert.tensor(pick, dev), convert.tensor(ds_pick, dev)
        admitted_by_sig: Dict[tuple, dict] = {sig: {} for sig in uniq}
        feas = torch.empty((p_bucket, cap), dtype=torch.bool, device=dev)
        scores = torch.zeros((p_bucket, cap), dtype=torch.int64, device=dev)
        for s, (lo, hi) in enumerate(self.all_bounds()):
            sh = self._shards[s]
            dkey = (self.shard_versions(s)["device"], cap)
            if sh.dev_key != dkey:
                sh.dev_rows, sh.ds_rows, sh.dev_key = {}, {}, dkey
            missing = [g for g in uniq if g not in sh.dev_rows]
            if missing:
                eng._compute_device_rows(missing, sig_rep, cap, out=sh.dev_rows, cols=(lo, hi))
            for sig in uniq:
                admitted_by_sig[sig].update(sh.dev_rows[sig][1])
            rows = torch.stack([torch.ones(hi - lo, dtype=torch.bool, device=dev)]
                               + [sh.dev_rows[sig][0] for sig in uniq])
            feas[:, lo:hi] = rows[pick_t]
            if want_ds:
                todo = [g for g in greqs if g not in sh.ds_rows]
                if todo:
                    eng._compute_device_score_rows(todo, cap, out=sh.ds_rows, cols=(lo, hi))
                rows = torch.stack([torch.zeros(hi - lo, dtype=torch.int64, device=dev)]
                                   + [sh.ds_rows[g] for g in greqs])
                scores[:, lo:hi] = rows[ds_pick_t]
        admitted = _AdmittedBySig(pod_sig, admitted_by_sig)
        if amped and pods:
            # the amplified-CPU delta is content-cached on the engine; its
            # columns are global, so it applies once over the merged buffer
            eng._amplified_scores_cached(pods, scores, amped)
        return scores, feas, admitted

    # ------------------------------------------------------------- score

    @staticmethod
    def _pods_key(pods, la_np, nf_np) -> tuple:
        """Exact-content key over everything pod-side a cached score block
        reads: the padded LoadAware/NodeFit arrays, byte for byte, and each
        pod's device-request and placement signatures (device resources
        live off the NodeFit axis, so equal arrays can still ask for
        different deviceshare scores).  The node side is in the block key's
        shard versions."""
        parts = []
        for arrs in (la_np, nf_np):
            for a in arrs:
                a = np.asarray(a)
                parts.append((a.shape, a.tobytes()))
        for p in pods:
            parts.append((parse_gpu_request(p.requests), int(p.requests.get(RDMA, 0)),
                          p.wants_cpuset(), p.cpu_bind_policy, p.cpu_exclusive_policy,
                          _mask_sig_key(p)))
        return tuple(parts)

    def _score_blocks_slice(self, la_pods, la_nodes, nf_pods, nf_nodes, valid, x_scores,
                            totals, feasible, pods_key, now) -> None:
        """Slice mode: one ``score`` launch per shard over its slice of the
        node tables, each block copied back to the host once, behind a
        per-shard (versions, pods, clock) block cache: an unchanged shard
        serves its block without a launch."""
        eng = self.engine
        self.last_block_hits = self.last_block_misses = 0
        cap = valid.shape[0]
        for s, (lo, hi) in enumerate(self.all_bounds()):
            sh = self._shards[s]
            v = self.shard_versions(s)
            skey = (v["node"], v["policy"], v["device"], cap, pods_key, now)
            if sh.score_key == skey and sh.score_val is not None:
                t_blk, f_blk = sh.score_val
                self.last_block_hits += 1
            else:
                self.last_block_misses += 1
                t_dev, f_dev = score_fn(
                    la_pods, type(la_nodes)(*(a[lo:hi] for a in la_nodes)), eng._weights,
                    nf_pods, type(nf_nodes)(*(a[lo:hi] for a in nf_nodes)), eng._nf_static,
                    valid[lo:hi], None if x_scores is None else x_scores[:, lo:hi])
                t_blk, f_blk = t_dev.cpu().numpy(), f_dev.cpu().numpy()
                sh.score_key, sh.score_val = skey, (t_blk, f_blk)
            totals[:, lo:hi] = t_blk
            feasible[:, lo:hi] = f_blk

    def _score_mesh(self, la_pods, la_nodes, nf_pods, nf_nodes, valid, x_scores):
        """Mesh mode: one ``shard_score_map`` launch per mesh device over
        its block; ([P, cap] totals, [P, cap] feasible) on the engine's
        device.  The blocks on the engine's own card share one check and
        layout of the pair tables, device index and stream."""
        eng = self.engine
        home = valid.device
        P, cap = la_pods.est.shape[0], valid.shape[0]
        totals = torch.empty((P, cap), dtype=torch.int64, device=home)
        feasible = torch.empty((P, cap), dtype=torch.bool, device=home)
        x = None if x_scores is None else x_scores.contiguous()
        home_launch = None
        for (lo, hi), dev in zip(self.all_bounds(), self.devices):
            if _same_device(dev, home):
                if home.type == "cpu":
                    shard_score_map(la_pods, la_nodes, eng._weights, nf_pods, nf_nodes,
                                    eng._nf_static, valid, x, lo, hi, totals, feasible)
                    continue
                if home_launch is None:
                    home_launch = (cuda.pair_args(la_pods, la_nodes, eng._weights, nf_pods,
                                                  nf_nodes, eng._nf_static, valid),
                                   cuda.device_index(home), cuda.stream(home))
                args, index, stream = home_launch
                _launch_block(args, x, P, cap, lo, hi, totals, feasible, index, stream)
                continue
            # a block on a card of its own: the pod rows replicated, the
            # block's node rows copied, the result copied back once
            def rep(nt):
                return type(nt)(*(a.to(dev) for a in nt))

            def blk(nt):
                return type(nt)(*(a[lo:hi].to(dev) for a in nt))

            t_b = torch.empty((P, hi - lo), dtype=torch.int64, device=dev)
            f_b = torch.empty((P, hi - lo), dtype=torch.bool, device=dev)
            shard_score_map(rep(la_pods), blk(la_nodes), eng._weights.to(dev), rep(nf_pods),
                            blk(nf_nodes), eng._nf_static, valid[lo:hi].to(dev),
                            None if x is None else x[:, lo:hi].contiguous().to(dev), 0, hi - lo,
                            t_b, f_b)
            totals[:, lo:hi] = t_b.to(home)
            feasible[:, lo:hi] = f_b.to(home)
        return totals, feasible

    def score(self, pods: List[Pod], now: Optional[float] = None):
        """(totals [P, cap] int64, feasible [P, cap] bool, snapshot): the
        ``Engine.score`` contract, evaluated per shard and merged; equal to
        the engine's."""
        eng = self.engine
        pods = eng._prepare(pods)
        now = time.time() if now is None else now
        snap = self.state.publish(now)
        cap = snap.valid.shape[0]
        p_bucket = next_bucket(max(len(pods), 1), eng._pod_bucket_min)
        la_np, nf_np = eng._pod_arrays_np(pods, p_bucket)
        la_pods, nf_pods = convert.la_pods(la_np, eng.device), convert.nf_pods(nf_np, eng.device)
        x_scores, x_feas, _ = self._numa_device_inputs(pods, p_bucket, cap)
        sel_mask = self._node_selector_mask(pods, p_bucket, cap)
        la_nodes, nf_nodes, valid = eng._node_inputs(snap, now)
        P = len(pods)
        masks = [m for m in (x_feas, sel_mask) if m is not None]
        if self.shard_map and self.num_shards > 1:
            totals, feasible = self._score_mesh(la_pods, la_nodes, nf_pods, nf_nodes, valid,
                                                x_scores)
            for m in masks:
                feasible = feasible & m
            return totals[:P].cpu().numpy(), feasible[:P].cpu().numpy(), snap
        totals = np.empty((p_bucket, cap), dtype=np.int64)
        feasible = np.empty((p_bucket, cap), dtype=bool)
        self._score_blocks_slice(la_pods, la_nodes, nf_pods, nf_nodes, valid, x_scores, totals,
                                 feasible, self._pods_key(pods, la_np, nf_np), now)
        totals, feasible = totals[:P], feasible[:P]
        for m in masks:
            feasible = feasible & m[:P].cpu().numpy()
        return totals, feasible, snap

    def score_topk(self, pods: List[Pod], k: int = 16, now: Optional[float] = None):
        """The compact ranking surface: ``(idx [P, k] global columns,
        scores [P, k], snapshot)`` by the per-shard scatter-gather merge."""
        totals, feasible, snap = self.score(pods, now=now)
        idx, sc = topk_merge(totals, feasible, self.all_bounds(), k)
        return idx, sc, snap

    # ---------------------------------------------------------- schedule

    def schedule(self, pods: List[Pod], now: Optional[float] = None, assume: bool = False,
                 exclude: Optional[List[str]] = None):
        """The engine's whole SCHEDULE over the sharded inputs: names,
        scores, allocation records, bindings and the assume path's store
        mutations are the engine's own code path."""
        return self.engine.schedule(pods, now=now, assume=assume, exclude=exclude,
                                    _inputs_provider=self)

    def schedule_begin(self, pods: List[Pod], now: Optional[float] = None, assume: bool = False,
                       exclude: Optional[List[str]] = None):
        return self.engine.schedule_begin(pods, now=now, assume=assume, exclude=exclude,
                                          _inputs_provider=self)
