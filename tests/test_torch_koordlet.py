"""The koordlet pipeline's port against the JAX package: the NodeMetric
aggregation (``core/metricsagg.py``, the plain version of the
``aggregate_node_metrics`` kernel), the series store and its write-ahead
log, the NodeMetric producer, and the peak predictor with its checkpoint.

Inputs are made from seeds with numpy and handed to both packages; the
port runs on the CPU.  Tolerances: the percentiles, ``last``, the counts
and every integer NodeMetric field exactly; the mean bit for bit on integer
samples and within ``rtol=1e-15`` on fractional ones (XLA's sum order is
its own); WAL replays and predictor checkpoints exactly.
"""

import io
import struct

import numpy as np
import pytest
import torch

from koordinator_tpu.api import model as jm
from koordinator_tpu.core import histogram as jh
from koordinator_tpu.core import metricsagg as jagg
from koordinator_tpu.service import koordlet as jk
from koordinator_tpu.service.engine import Engine as JEngine
from koordinator_tpu.service.state import ClusterState as JState
from koordinator_tpu.utils.fixtures import NOW
from koordinator_tpu_torch.api import model as tm
from koordinator_tpu_torch.core import histogram as th
from koordinator_tpu_torch.core import metricsagg as tagg
from koordinator_tpu_torch.service import koordlet as tk
from koordinator_tpu_torch.service.engine import Engine as TEngine
from koordinator_tpu_torch.service.state import ClusterState as TState

GB = 1 << 30


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64)).view(np.int64)


def _series(seed: int, S: int, T: int, integer: bool = True):
    """(values, valid, times): integer or fractional samples with the edge
    rows up front — NaN and ±0.0 samples, an all -0.0 row, an empty row,
    count 20 (p95's float32 index) and count 10 (p90's), tied and NaN
    times."""
    rng = np.random.default_rng(seed)
    if integer:
        v = rng.integers(0, 1 << 40, (S, T)).astype(np.float64)
    else:
        v = rng.random((S, T)) * 1e4
    valid = rng.random((S, T)) < 0.7
    t = rng.integers(0, 40, (S, T)).astype(np.float64)  # many ties
    v[0, :6] = [0.0, -0.0, np.nan, -np.nan, 1.0, -0.0]
    v[1], valid[1] = -0.0, True
    valid[2] = False
    for row, cnt in ((3, 20), (4, 10), (5, 1)):
        valid[row] = False
        valid[row, rng.choice(T, cnt, replace=False)] = True
    t[6] = np.nan
    t[7] = 5.0
    return v, valid, t


def _jax(fn, *a):
    return np.asarray(fn(*a))


def _port(fn, *a):
    return fn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in a)).numpy()


@pytest.mark.parametrize("seed,S,T", [(0, 64, 64), (1, 300, 256), (2, 40, 33), (3, 16, 20)])
def test_aggregate_integer_samples_bit_for_bit(seed, S, T):
    v, valid, t = _series(seed, S, T)
    want = _jax(jagg.aggregate_node_metrics, v, valid, t)
    got = _port(tagg.aggregate_node_metrics, v, valid, t)
    assert got.shape == (6, S)
    assert np.array_equal(_bits(got), _bits(want)), np.argwhere(_bits(got) != _bits(want))[:5]


@pytest.mark.parametrize("seed", [4, 5])
def test_aggregate_fractional_samples(seed):
    v, valid, t = _series(seed, 200, 128, integer=False)
    want = _jax(jagg.aggregate_node_metrics, v, valid, t)
    got = _port(tagg.aggregate_node_metrics, v, valid, t)
    assert np.array_equal(_bits(got[1:]), _bits(want[1:]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-15, atol=0)


@pytest.mark.parametrize("cnt,p", [(20, 0.95), (10, 0.9), (100, 0.99), (7, 0.5)])
def test_percentile_index_is_float32(cnt, p):
    """int(float32(cnt) * float32(p)) - 1, as the reference computes it;
    the sample values are their ranks, so the output is the index."""
    T = 128
    v = np.tile(np.arange(T, dtype=np.float64), (2, 1))
    valid = np.zeros((2, T), dtype=bool)
    valid[:, :cnt] = True
    want = _jax(lambda a, b: jagg.agg_percentile(a, b, p), v, valid)
    got = _port(lambda a, b: tagg.agg_percentile(a, b, p), v, valid)
    assert np.array_equal(got, want)
    assert got[0] == max(int(np.float32(cnt) * np.float32(p)) - 1, 0)


def test_aggregation_pieces_equal_jax():
    v, valid, t = _series(6, 100, 96)
    assert np.array_equal(_port(tagg.agg_count, valid), _jax(jagg.agg_count, valid))
    assert np.array_equal(_bits(_port(tagg.agg_avg, v, valid)), _bits(_jax(jagg.agg_avg, v, valid)))
    assert np.array_equal(_bits(_port(tagg.agg_last, v, valid, t)),
                          _bits(_jax(jagg.agg_last, v, valid, t)))
    for p in (0.5, 0.9, 0.95, 0.99, 0.01, 1.0):
        got = _port(lambda a, b: tagg.agg_percentile(a, b, p), v, valid)
        want = _jax(lambda a, b: jagg.agg_percentile(a, b, p), v, valid)
        assert np.array_equal(_bits(got), _bits(want)), p


def test_aggregate_refuses_bad_inputs():
    v, valid, t = (torch.from_numpy(a) for a in _series(7, 8, 32))
    with pytest.raises(ValueError, match="valid"):
        tagg.aggregate_node_metrics(v, valid.to(torch.int8), t)
    with pytest.raises(ValueError, match="times"):
        tagg.aggregate_node_metrics(v, valid, t[:, :4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tagg.aggregate_node_metrics(v.to("meta"), valid.to("meta"), t.to("meta"))


# ------------------------------------------------------------ the store


def _ticks(seed: int, n: int, keys):
    rng = np.random.default_rng(seed)
    for t in range(n):
        yield float(t), {k: float(rng.integers(0, 1000)) for k in keys if rng.random() < 0.8}


_KEYS = [f"node/n{i}/cpu" for i in range(5)] + ["pod/n0/default/p1/memory"]


def _same_windows(a, b, keys, now):
    for dur in (10.0, 50.0, 200.0):
        av, avalid, at = a.window(now, dur, keys)
        bv, bvalid, bt = b.window(now, dur, keys)
        assert np.array_equal(avalid, bvalid)
        assert np.array_equal(av * avalid, bv * bvalid)
        assert np.array_equal(np.where(avalid, at, 0), np.where(bvalid, bt, 0))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("wal_max", [8 << 20, 2048])
def test_wal_replays_across_packages(tmp_path, writer, wal_max):
    """A WAL one package writes (plain records, or compacted into a
    checkpoint record past ``wal_max`` bytes) replays in the other, with a
    torn tail dropped and cut; both logs are byte-identical."""
    W, R = (jk, tk) if writer == "jax" else (tk, jk)
    paths = {m: str(tmp_path / f"{m.__name__.split('.')[0]}.wal") for m in (jk, tk)}
    live = {m: m.MetricSeriesStore(window=32, wal_path=paths[m], wal_max_bytes=wal_max)
            for m in (jk, tk)}
    for now, samples in _ticks(81, 100, _KEYS):  # wraps the ring three times
        for s in live.values():
            s.append(now, samples)
    for s in live.values():
        s.close()
    assert open(paths[jk], "rb").read() == open(paths[tk], "rb").read()
    with open(paths[W], "ab") as f:
        f.write(b"S" + struct.pack("<I", 999) + b"partial")
    restored = R.MetricSeriesStore(window=32, wal_path=paths[W])
    twin = W.MetricSeriesStore(window=32)
    for now, samples in _ticks(81, 100, _KEYS):
        twin.append(now, samples)
    _same_windows(restored, twin, _KEYS, 99.0)
    restored.append(100.0, {"node/n0/cpu": 5.0})
    restored.close()
    again = W.MetricSeriesStore(window=32, wal_path=paths[W])
    vals, valid, _ = again.window(100.0, 0.5, ["node/n0/cpu"])
    assert vals[0][valid[0]].tolist() == [5.0]
    again.close()


# --------------------------------------------------------- the producer


def _fill(m, store, prod, nodes, pods, ticks, seed):
    rng = np.random.default_rng(seed)
    for t in range(ticks):
        samples = {}
        for n in nodes:
            samples[prod.node_key(n, m.CPU)] = float(rng.integers(100, 16000))
            samples[prod.node_key(n, m.MEMORY)] = float(rng.integers(1, 64) * GB)
            for pk in pods.get(n, ()):
                samples[prod.pod_key(n, pk, m.CPU)] = float(rng.integers(10, 4000))
                samples[prod.pod_key(n, pk, m.MEMORY)] = float(rng.integers(1, 8) * GB)
        # a node that stops reporting: its series age out of the windows
        if t > ticks // 2:
            samples = {k: v for k, v in samples.items() if "/n-quiet/" not in k}
        store.append(NOW - 10.0 * (ticks - 1 - t), samples)


def _metric_view(m) -> tuple:
    return (m.node_usage, m.update_time, m.report_interval,
            {d: {str(k.value): dict(v) for k, v in a.items()} for d, a in m.aggregated.items()},
            m.pods_usage)


@pytest.mark.parametrize("ticks", [40, 256])
def test_produce_equals_jax(ticks):
    nodes = [f"n-{i}" for i in range(30)] + ["n-quiet", "n-blind"]
    pods = {n: [f"default/p{i}-{j}" for j in range(i % 3)] for i, n in enumerate(nodes[:30])}
    pods["n-quiet"] = ["default/q"]
    out = {}
    for m, k in ((jm, jk), (tm, tk)):
        store = k.MetricSeriesStore(window=256)
        kw = {} if k is jk else {"device": "cpu"}
        prod = k.NodeMetricProducer(store, report_interval=60.0,
                                    aggregate_durations=(300.0, 600.0, 1800.0), **kw)
        _fill(m, store, prod, [n for n in nodes if n != "n-blind"], pods, ticks, 11)
        out[k] = prod.produce(NOW, nodes, pods)
    assert "n-blind" not in out[tk] and set(out[tk]) == set(out[jk])
    for n in out[jk]:
        assert _metric_view(out[tk][n]) == _metric_view(out[jk][n]), n


def _report_state(m, S, E, k):
    state = S(initial_capacity=16)
    engine = E(state) if E is JEngine else E(state, device="cpu")
    for n in ("km-0", "km-1"):
        state.upsert_node(m.Node(name=n, allocatable={m.CPU: 10000, m.MEMORY: 32 * GB,
                                                      "pods": 32}))
    state.assign_pod("km-0", m.AssignedPod(pod=m.Pod(name="busy", requests={
        m.CPU: 3000, m.MEMORY: 4 * GB}), assign_time=NOW - 600))
    store = k.MetricSeriesStore(window=64)
    prod = k.NodeMetricProducer(store, report_interval=60.0,
                                **({} if k is jk else {"device": "cpu"}))
    for t in range(20):
        now = NOW - 60 + t * 3
        store.append(now, {prod.node_key("km-0", m.CPU): 6000 + 100 * t,
                           prod.node_key("km-0", m.MEMORY): 10 * GB,
                           prod.pod_key("km-0", "default/busy", m.CPU): 3000,
                           prod.pod_key("km-0", "default/busy", m.MEMORY): 4 * GB,
                           prod.node_key("km-1", m.CPU): 500,
                           prod.node_key("km-1", m.MEMORY): 2 * GB})
    return state, engine, prod


def test_produced_nodemetric_feeds_scheduling():
    """tests/test_koordlet_pipeline.py's case on both packages: the
    produced metric is what scheduling consumes, and the idle node wins
    both placements."""
    out = {}
    for m, S, E, k in ((jm, JState, JEngine, jk), (tm, TState, TEngine, tk)):
        state, engine, prod = _report_state(m, S, E, k)
        assert prod.report(state, NOW) == 2
        pods = [m.Pod(name=f"p{i}", requests={m.CPU: 1000, m.MEMORY: GB}) for i in range(2)]
        hosts, scores, snap, _ = engine.schedule(pods, now=NOW + 1)
        out[k] = ([snap.names[h] for h in hosts if h >= 0], scores.tolist(),
                  _metric_view(state._nodes["km-0"].metric))
    assert out[tk] == out[jk]
    assert out[tk][0] == ["km-1", "km-1"]
    assert out[tk][2][4]["default/busy"]["cpu"] == 3000


def test_aggregated_mode_uses_produced_percentiles():
    """A node with a custom aggregated-usage threshold filters on the
    produced p95 window (loadaware helper.go:58), on both packages."""
    out = {}
    for m, S, E, k in ((jm, JState, JEngine, jk), (tm, TState, TEngine, tk)):
        state = S(initial_capacity=16)
        engine = E(state) if E is JEngine else E(state, device="cpu")
        state.upsert_node(m.Node(
            name="agg-0", allocatable={m.CPU: 10000, m.MEMORY: 32 * GB, "pods": 32},
            custom_agg_usage_thresholds={m.CPU: 50}, custom_agg_type=m.AggregationType.P95,
            custom_agg_duration=300.0, has_custom_annotation=True))
        state.upsert_node(m.Node(name="agg-1",
                                 allocatable={m.CPU: 10000, m.MEMORY: 32 * GB, "pods": 32}))
        store = k.MetricSeriesStore(window=64)
        prod = k.NodeMetricProducer(store, report_interval=60.0,
                                    **({} if k is jk else {"device": "cpu"}))
        for t in range(20):
            # spiky: avg ~30%, p95 ~80% -> the aggregated filter rejects
            v = 8000 if t % 5 == 0 else 1500
            store.append(NOW - 60 + t * 3, {prod.node_key(n, m.CPU): v for n in ("agg-0",
                                                                                "agg-1")}
                         | {prod.node_key(n, m.MEMORY): 4 * GB for n in ("agg-0", "agg-1")})
        prod.report(state, NOW)
        totals, feasible, snap = engine.score([m.Pod(name="victim", requests={
            m.CPU: 500, m.MEMORY: GB})], now=NOW + 1)
        out[k] = (totals.tolist(), feasible.tolist(), list(snap.names))
    assert out[tk] == out[jk]
    cols = out[tk][2]
    assert not out[tk][1][0][cols.index("agg-0")] and out[tk][1][0][cols.index("agg-1")]


# ---------------------------------------------------------- the predictor


def _train(k, seed):
    kw = {} if k is jk else {"device": "cpu"}
    pred = k.PeakPredictor(k.MetricSeriesStore(), half_life=3600.0, **kw)
    rng = np.random.default_rng(seed)
    for t in range(60):
        usage = {
            "prod": (float(rng.uniform(900, 1100)), float(rng.uniform(3.8, 4.2) * GB)),
            "batch": (float(rng.uniform(100, 300)), float(rng.uniform(0.9, 1.1) * GB)),
        }
        # entities join late (the histograms grow past 16 rows) and a clock
        # jump past 100 half-lives renormalizes the weights
        usage.update({f"pod-{j}": (float(rng.uniform(10, 5000)), float(rng.uniform(1, 9) * GB))
                      for j in range(t // 3)})
        pred.train(NOW + t * 60 + (400 * 3600.0 if t >= 50 else 0.0), usage)
    return pred


def test_peak_predictor_equals_jax_and_checkpoints_cross():
    entities = ["prod", "batch"] + [f"pod-{j}" for j in range(19)] + ["absent"]
    j, t = _train(jk, 3), _train(tk, 3)
    want = j.predict(entities)
    assert t.predict(entities) == want and "absent" not in want
    assert 1000 <= want["prod"]["cpu"] <= 2200
    jz, tz = (np.load(io.BytesIO(p.checkpoint())) for p in (j, t))
    assert sorted(jz.files) == sorted(tz.files)
    for f in jz.files:
        if f in ("ct", "mt"):
            np.testing.assert_allclose(tz[f], jz[f], rtol=1e-15)
        else:
            assert np.array_equal(tz[f], jz[f]), f
    # a blob from either package restores in the other to the same peaks
    for src, dst in ((j, tk), (t, jk)):
        kw = {} if dst is jk else {"device": "cpu"}
        back = dst.PeakPredictor.restore(src.checkpoint(), dst.MetricSeriesStore(),
                                         half_life=3600.0, **kw)
        same = jk.PeakPredictor.restore(j.checkpoint(), jk.MetricSeriesStore(), half_life=3600.0)
        assert back.predict(entities) == same.predict(entities)


def test_histogram_functions_equal_jax():
    opt_j = jh.HistogramOptions.linear(1000.0, 10.0, 1e-10)
    opt_t = th.HistogramOptions.linear(1000.0, 10.0, 1e-10)
    rng = np.random.default_rng(9)
    sj, st = jh.new_state(8, opt_j), th.new_state(8, opt_t, device="cpu")
    for step in range(30):
        v = rng.uniform(0, 1200, 8)
        w = (rng.random(8) < 0.8).astype(np.float64)
        ts = np.full(8, 100.0 * step)
        sj = jh.add_samples(sj, opt_j, v, w, ts, 600.0)
        st = th.add_samples(st, opt_t, *(torch.from_numpy(a) for a in (v, w, ts)), 600.0)
    for p in (0.5, 0.95, 0.98):
        assert np.array_equal(th.percentile(st, opt_t, p).numpy(),
                              np.asarray(jh.percentile(sj, opt_j, p)))
    np.testing.assert_allclose(st.weights.numpy(), np.asarray(sj.weights), rtol=1e-14)
    c, m = th.peak_prediction(torch.tensor([1000.0]), torch.tensor([2.0 * GB]), 10)
    jc, jmem = jh.peak_prediction(np.array([1000.0]), np.array([2.0 * GB]), 10)
    assert (int(c[0]), int(m[0])) == (int(jc[0]), int(jmem[0]))


def test_histogram_state_names_its_device():
    """``new_state`` and ``load_checkpoint`` take no default device: a
    call without one is refused, as every entry point of the port wants
    its device named."""
    opt = th.HistogramOptions.linear(1000.0, 10.0, 1e-10)
    with pytest.raises(TypeError):
        th.new_state(4, opt)
    st = th.new_state(4, opt, device="cpu")
    stored, total, ref = th.save_checkpoint(st, opt)
    with pytest.raises(TypeError):
        th.load_checkpoint(stored, total, ref)
    back = th.load_checkpoint(stored, total, ref, device="cpu")
    assert back.weights.device.type == "cpu" and back.weights.shape == (4, opt.num_buckets)


def test_koordlet_defaults_to_cuda():
    """Without a card, the producer and the predictor built without
    ``device`` raise instead of falling back to the CPU."""
    for cls in (tk.NodeMetricProducer, tk.PeakPredictor):
        if torch.cuda.is_available():
            assert cls(tk.MetricSeriesStore()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(tk.MetricSeriesStore())
