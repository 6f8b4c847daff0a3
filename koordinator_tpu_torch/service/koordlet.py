"""The koordlet metric pipeline: series store -> aggregation -> NodeMetric
production -> the scheduling state, and the peak-prediction loop.

The port of the JAX package's ``service/koordlet.py`` (pkg/koordlet/
metriccache + statesinformer/impl/states_nodemetric.go +
prediction/predict_server.go):

- ``MetricSeriesStore``: a fixed-capacity ring buffer per series ([S, T]
  host arrays + timestamps), the node-local TSDB stand-in
  (metriccache/metric_cache.go), with its write-ahead log in the JAX
  package's byte format: a log either package writes replays in the other,
  compaction and the torn-tail cut included.
- ``NodeMetricProducer``: the nodeMetricInformer report tick
  (states_nodemetric.go:202-332): each node's and pod's series aggregated
  over the report interval and the aggregate windows into NodeMetric status
  (the avg usage and the p50/p90/p95/p99 AggregatedUsage) by the
  ``aggregate_node_metrics`` kernel, and applied through
  ``ClusterState.update_metric``, the APPLY delta the Go shim sends.  Each
  window goes to the producer's device and comes back in one copy.
- ``PeakPredictor``: the PeakPredictServer training and query loop
  (predict_server.go:65-307): decaying histograms per entity
  (``core.histogram``, plain torch ops on the predictor's device), p95-CPU /
  p98-memory peaks with the safety margin, and a checkpoint blob the JAX
  package's ``PeakPredictor.restore`` reads (and the reverse).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); with no card and no device asked for they raise.
"""

from __future__ import annotations

import io
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.api.model import CPU, MEMORY, AggregationType, NodeMetric
from koordinator_tpu_torch.core.histogram import (
    HistogramOptions,
    add_samples,
    load_checkpoint,
    new_state,
    peak_prediction,
    percentile,
    save_checkpoint,
)
from koordinator_tpu_torch.core.metricsagg import aggregate_node_metrics
from koordinator_tpu_torch.service.state import IndexMap, next_bucket


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the koordlet's aggregation runs on the card unless "
                           "the caller asks for the CPU (device='cpu')")
    return dev


class MetricSeriesStore:
    """Ring-buffered [S, T] sample store; one row per (entity, resource).

    ``wal_path`` adds the reference's metriccache durability
    (metric_cache.go backs its TSDB with on-disk storage): every append
    also lands in a write-ahead log, and a store constructed over an
    existing WAL replays it so a restarted koordlet resumes with its
    aggregation windows intact (aux subsystem #4, checkpoint/resume).
    The log self-compacts once it exceeds ``wal_max_bytes``: a checkpoint
    record of the live ring replaces the history (retention is the ring
    anyway — older samples are unreachable by design).  A torn tail from
    a crash mid-write is detected by record length and dropped.
    """

    def __init__(
        self,
        window: int = 256,
        wal_path: Optional[str] = None,
        wal_max_bytes: int = 8 << 20,
    ):
        # retention is the ring size x the collection cadence; window()'s
        # duration mask does the time-based trimming
        self._imap = IndexMap()
        self.T = window
        self._cap = 0
        self._grow(next_bucket(64))
        self._wal = None
        self._wal_path = wal_path
        self._wal_max = wal_max_bytes
        if wal_path is not None:
            valid_end = self._replay_wal()
            if valid_end is not None:
                import os

                # a torn tail must be CUT before appending — new records
                # written after it would be swallowed into the torn
                # record's declared length on the next restart
                with open(wal_path, "ab") as f:
                    if f.tell() > valid_end:
                        f.truncate(valid_end)
            self._wal = open(wal_path, "ab")

    # ------------------------------------------------------------- WAL

    @staticmethod
    def _pack_batch(now: float, samples: Dict[str, float]) -> bytes:
        import struct

        body = io.BytesIO()
        body.write(struct.pack("<dI", now, len(samples)))
        for key, v in samples.items():
            kb = key.encode()
            body.write(struct.pack("<H", len(kb)))
            body.write(kb)
            body.write(struct.pack("<d", float(v)))
        payload = body.getvalue()
        return b"S" + struct.pack("<I", len(payload)) + payload

    def _checkpoint_bytes(self) -> bytes:
        import struct

        body = io.BytesIO()
        names = [n or "" for n in self._imap._names]
        # names as length-prefixed UTF-8 (never pickle: the WAL is an
        # on-disk input, replay must not execute arbitrary objects)
        body.write(struct.pack("<I", len(names)))
        for n in names:
            nb = n.encode()
            body.write(struct.pack("<H", len(nb)))
            body.write(nb)
        np.save(body, self._values[: len(names)], allow_pickle=False)
        np.save(body, self._times[: len(names)], allow_pickle=False)
        np.save(body, self._cursor_arr[: len(names)], allow_pickle=False)
        payload = body.getvalue()
        return b"C" + struct.pack("<I", len(payload)) + payload

    def _replay_wal(self) -> Optional[int]:
        """Replay the log; returns the byte offset of the last VALID
        record's end (the caller truncates any torn tail to it), or None
        when no file exists."""
        import os
        import struct

        path = self._wal_path
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 5 <= len(data):
            kind = data[pos : pos + 1]
            (length,) = struct.unpack_from("<I", data, pos + 1)
            end = pos + 5 + length
            if end > len(data):
                break  # torn tail: drop the partial record
            payload = data[pos + 5 : end]
            pos = end
            if kind == b"C":
                body = io.BytesIO(payload)
                (n_names,) = struct.unpack("<I", body.read(4))
                names = []
                for _ in range(n_names):
                    (klen,) = struct.unpack("<H", body.read(2))
                    names.append(body.read(klen).decode())
                values = np.load(body, allow_pickle=False)
                times = np.load(body, allow_pickle=False)
                cursor = np.load(body, allow_pickle=False)
                self._imap = IndexMap()
                self.T = values.shape[1]
                self._cap = 0
                self._grow(next_bucket(max(len(names), 64)))
                for k, name in enumerate(names):
                    if name:
                        i = self._imap.add(name)
                        self._values[i] = values[k]
                        self._times[i] = times[k]
                        self._cursor_arr[i] = cursor[k]
            elif kind == b"S":
                (now, count) = struct.unpack_from("<dI", payload, 0)
                off = 12
                samples = {}
                for _ in range(count):
                    (klen,) = struct.unpack_from("<H", payload, off)
                    off += 2
                    key = payload[off : off + klen].decode()
                    off += klen
                    (v,) = struct.unpack_from("<d", payload, off)
                    off += 8
                    samples[key] = v
                self._append_ring(now, samples)
        return pos

    def _maybe_compact(self) -> None:
        import os

        if self._wal.tell() < self._wal_max:
            return
        self._wal.close()
        tmp = self._wal_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self._checkpoint_bytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._wal_path)
        self._wal = open(self._wal_path, "ab")

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def _grow(self, cap: int):
        def grown(name, fill, dtype):
            arr = np.full((cap, self.T), fill, dtype=dtype)
            old = getattr(self, name, None)
            if old is not None:
                arr[: old.shape[0]] = old
            return arr

        self._values = grown("_values", 0.0, np.float64)
        self._times = grown("_times", -np.inf, np.float64)
        self._cursor_arr = (
            np.zeros(cap, dtype=np.int64)
            if not hasattr(self, "_cursor_arr")
            else np.concatenate(
                [self._cursor_arr, np.zeros(cap - self._cap, dtype=np.int64)]
            )
        )
        self._cap = cap

    def append(self, now: float, samples: Dict[str, float]) -> None:
        """One collection tick: {series key: value}."""
        self._append_ring(now, samples)
        if self._wal is not None and samples:
            self._wal.write(self._pack_batch(now, samples))
            self._wal.flush()
            self._maybe_compact()

    def _append_ring(self, now: float, samples: Dict[str, float]) -> None:
        """One tick into the ring, vectorized over its samples: new series
        take rows in the tick's key order, as one-at-a-time appends would
        (a key appears once a tick)."""
        if not samples:
            return
        n = len(samples)
        rows = np.fromiter(map(self._imap._idx.get, samples, itertools.repeat(-1)),
                           dtype=np.int64, count=n)
        if (rows < 0).any():
            rows = np.fromiter(map(self._imap.add, samples), dtype=np.int64, count=n)
        top = int(rows.max())
        if top >= self._cap:
            self._grow(next_bucket(top + 1, self._cap * 2))
        c = self._cursor_arr[rows] % self.T
        self._values[rows, c] = np.fromiter(map(float, samples.values()), dtype=np.float64,
                                            count=n)
        self._times[rows, c] = now
        self._cursor_arr[rows] += 1

    def window(self, now: float, duration: float, keys: List[str]):
        """([K, T] values, [K, T] valid, [K, T] times) for the last
        ``duration`` seconds of the given series (missing series are
        all-invalid rows)."""
        rows = np.fromiter((self._imap._idx.get(k, -1) for k in keys), dtype=np.int64,
                           count=len(keys))
        have = rows >= 0
        src = np.where(have, rows, 0)
        vals = np.where(have[:, None], self._values[src], 0.0)
        times = np.where(have[:, None], self._times[src], -np.inf)
        valid = (times >= now - duration) & (times <= now)
        return vals, valid, times


AGG_ROWS = ("avg", "p50", "p90", "p95", "p99", "last")


class NodeMetricProducer:
    """states_nodemetric.go sync: aggregate the store into NodeMetric
    status objects and apply them to the scheduling state.  ``tracer`` is
    accepted for the JAX package's signature and records nothing: spans
    arrive with the observability slice of the port."""

    def __init__(
        self,
        store: MetricSeriesStore,
        resources: Tuple[str, ...] = (CPU, MEMORY),
        report_interval: float = 60.0,
        aggregate_durations: Tuple[float, ...] = (300.0, 600.0, 1800.0),
        tracer=None,
        device=None,
    ):
        self.store = store
        self.resources = list(resources)
        self.report_interval = report_interval
        self.aggregate_durations = list(aggregate_durations)
        self.tracer = tracer
        self.device = _device(device)

    @staticmethod
    def node_key(node: str, resource: str) -> str:
        return f"node/{node}/{resource}"

    @staticmethod
    def pod_key(node: str, pod_key: str, resource: str) -> str:
        return f"pod/{node}/{pod_key}/{resource}"

    def _aggregate(self, vals, valid, times) -> np.ndarray:
        """[6, K] on the host: one window to the device, the kernel, one
        copy back."""
        dev = self.device
        return aggregate_node_metrics(torch.as_tensor(vals, device=dev),
                                      torch.as_tensor(valid, device=dev),
                                      torch.as_tensor(times, device=dev)).cpu().numpy()

    def produce(
        self, now: float, nodes: List[str], pods_by_node: Dict[str, List[str]]
    ) -> Dict[str, NodeMetric]:
        """One report tick -> {node name: NodeMetric} with the instant usage
        (the avg over the report interval, collectMetric) and the
        p50/p90/p95/p99 AggregatedUsage per configured window."""
        R = len(self.resources)
        keys = [self.node_key(n, r) for n in nodes for r in self.resources]
        out: Dict[str, NodeMetric] = {}
        aggs: Dict[float, np.ndarray] = {}
        valid_r = None
        for dur in [self.report_interval] + self.aggregate_durations:
            vals, valid, times = self.store.window(now, dur, keys)
            if dur == self.report_interval:
                valid_r = valid
            aggs[dur] = self._aggregate(vals, valid, times)
        # a node with no collected samples must not fabricate a zero-usage
        # metric (a blind node would look like the idlest in the cluster):
        # it has nothing to report this tick
        has_samples = valid_r.any(axis=1).reshape(len(nodes), R).any(axis=1)
        levels = (AggregationType.P50, AggregationType.P90, AggregationType.P95,
                  AggregationType.P99)
        for ni, n in enumerate(nodes):
            if not has_samples[ni]:
                continue
            sl = slice(ni * R, (ni + 1) * R)
            inst = aggs[self.report_interval][0, sl]  # avg row
            m = NodeMetric(
                node_usage={r: int(inst[j]) for j, r in enumerate(self.resources)},
                update_time=now,
                report_interval=self.report_interval,
            )
            for dur in self.aggregate_durations:
                a = aggs[dur][:, sl]
                m.aggregated[dur] = {
                    lvl: {r: int(a[1 + k, j]) for j, r in enumerate(self.resources)}
                    for k, lvl in enumerate(levels)
                }
            out[n] = m
        # per-pod usage rows (podsReportMaxNumber order is host-side policy)
        pod_keys = [
            (n, pk, self.pod_key(n, pk, r))
            for n, pks in pods_by_node.items()
            for pk in pks
            for r in self.resources
        ]
        if pod_keys:
            vals, valid, times = self.store.window(now, self.report_interval,
                                                   [k for _, _, k in pod_keys])
            avg = self._aggregate(vals, valid, times)[0]
            for j, (n, pk, _) in enumerate(pod_keys):
                if n in out:
                    r = self.resources[j % len(self.resources)]
                    out[n].pods_usage.setdefault(pk, {})[r] = int(avg[j])
        return out

    def report(self, state, now: float, pods_by_node=None) -> int:
        """Produce and apply into ClusterState (the shim's metric deltas)."""
        nodes = list(state._nodes)
        if pods_by_node is None:
            pods_by_node = {n: [ap.pod.key for ap in state._nodes[n].assigned_pods]
                            for n in nodes}
        metrics = self.produce(now, nodes, pods_by_node)
        for n, m in metrics.items():
            state.update_metric(n, m)
        return len(metrics)


class PeakPredictor:
    """predict_server.go: decaying-histogram peak models per entity,
    trained from the series store, checkpointable."""

    def __init__(
        self,
        store: MetricSeriesStore,
        cpu_options: Optional[HistogramOptions] = None,
        mem_options: Optional[HistogramOptions] = None,
        half_life: float = 12 * 3600.0,
        safety_margin_pct: int = 10,
        device=None,
    ):
        self.store = store
        self.device = _device(device)
        self.cpu_opt = cpu_options or HistogramOptions.exponential(1024 * 1000.0, 25.0, 1.05,
                                                                   1e-10)
        self.mem_opt = mem_options or HistogramOptions.exponential(1 << 40, 1 << 24, 1.05, 1e-10)
        self.half_life = half_life
        self.safety_margin_pct = safety_margin_pct
        self._imap = IndexMap()
        self._cap = next_bucket(16)
        self._cpu = new_state(self._cap, self.cpu_opt, self.device)
        self._mem = new_state(self._cap, self.mem_opt, self.device)
        self._last_sample_time: Dict[str, float] = {}

    def _row(self, entity: str) -> int:
        i = self._imap.add(entity)
        if i >= self._cap:
            grow = next_bucket(i + 1, self._cap * 2)
            for name, opt in (("_cpu", self.cpu_opt), ("_mem", self.mem_opt)):
                old = getattr(self, name)
                fresh = new_state(grow, opt, self.device)
                fresh.weights[: self._cap] = old.weights
                fresh.reference_ts[: self._cap] = old.reference_ts
                setattr(self, name, fresh)
            self._cap = grow
        return i

    def train(self, now: float, usage: Dict[str, Tuple[float, float]]) -> None:
        """One training tick: {entity: (cpu usage, memory usage)}, one
        sample an entity a tick (doTraining)."""
        rows = {entity: self._row(entity) for entity in usage}  # grows first
        E = self._cap
        cpu_v, mem_v, w, ts = (np.zeros(E) for _ in range(4))
        for entity, (c, m) in usage.items():
            i = rows[entity]
            cpu_v[i], mem_v[i] = c, m
            w[i] = 1.0
            ts[i] = now
            self._last_sample_time[entity] = now
        dev = self.device
        w_t, ts_t = torch.as_tensor(w, device=dev), torch.as_tensor(ts, device=dev)
        self._cpu = add_samples(self._cpu, self.cpu_opt, torch.as_tensor(cpu_v, device=dev), w_t,
                                ts_t, self.half_life)
        self._mem = add_samples(self._mem, self.mem_opt, torch.as_tensor(mem_v, device=dev), w_t,
                                ts_t, self.half_life)

    def predict(self, entities: List[str]):
        """{entity: {cpu, memory}}: p95 CPU / p98 memory peaks with the
        safety margin (GetPrediction, peak_predictor.go:176-193)."""
        c, m = peak_prediction(percentile(self._cpu, self.cpu_opt, 0.95),
                               percentile(self._mem, self.mem_opt, 0.98), self.safety_margin_pct)
        c, m = c.cpu().numpy(), m.cpu().numpy()
        out = {}
        for e in entities:
            i = self._imap.get(e)
            if i is not None:
                out[e] = {CPU: int(c[i]), MEMORY: int(m[i])}
        return out

    # ------------------------------------------------------- checkpointing

    def checkpoint(self) -> bytes:
        """doCheckpoint: the batched histogram serialization, one blob."""
        buf = io.BytesIO()
        names = [self._imap._names[i] if i < len(self._imap._names) else None
                 for i in range(self._cap)]
        cw, ct, cr = save_checkpoint(self._cpu, self.cpu_opt)
        mw, mt, mr = save_checkpoint(self._mem, self.mem_opt)
        np.savez(buf, names=np.array([n or "" for n in names]), cw=cw, ct=ct, cr=cr, mw=mw,
                 mt=mt, mr=mr)
        return buf.getvalue()

    @classmethod
    def restore(cls, blob: bytes, store: MetricSeriesStore, **kw) -> "PeakPredictor":
        """restoreModels on restart."""
        z = np.load(io.BytesIO(blob), allow_pickle=False)
        self = cls(store, **kw)
        names = [str(n) for n in z["names"]]
        self._cap = next_bucket(len(names))
        self._cpu = load_checkpoint(z["cw"], z["ct"], z["cr"], self.device)
        self._mem = load_checkpoint(z["mw"], z["mt"], z["mr"], self.device)
        for n in names:
            if n:
                self._imap.add(n)
        return self
