"""metriccache aggregations as batched tensor ops.

The port of the JAX package's ``core/metricsagg.py``, after
pkg/koordlet/metriccache/util.go: the koordlet aggregates node and pod
series into NodeMetric status (avg / p50 / p90 / p95 / p99 / last / count,
states_nodemetric.go:332 collectMetric).  S series of T samples aggregate
in one shot, a validity mask standing in for ragged series lengths.

The percentile follows fieldPercentileOfMetricList exactly: sort ascending,
index = int(float32(count) * float32(p)) - 1 clamped to >= 0 (not the usual
nearest rank: the float32 product and the -1 are the reference's).

``aggregate_node_metrics`` is the kernel's wrapper: CPU tensors take the
plain version (``aggregate_node_metrics_plain``), CUDA tensors launch
``csrc/metricsagg.cu`` or raise: the kernel takes a warp a series up to
256 samples (every window of the port's store), a block a series above.
The plain version sums in the kernel's
order (a strided halving tree over the samples padded to a power of two),
so the two are bit-identical (a NaN mean is the canonical quiet NaN in
both); against XLA's sum the mean is bit-equal on
integer samples and within an ulp or so on fractional ones.  The sort is
the stable float order of ``jnp.sort``: -0.0 ties 0.0, every NaN last.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch import cuda

BIG = 1e300
PERCENTILES = (0.5, 0.9, 0.95, 0.99)
MAX_T = 2048  # kMaxT in csrc/metricsagg.cu
_NAN_KEY = 0x7FF8000000000000
_MAG = 0x7FFFFFFFFFFFFFFF


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the float order of ``jnp.sort``:
    -0.0 and 0.0 equal, every NaN equal and last."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    bits = x.view(torch.int64)
    keys = torch.where(bits < 0, bits ^ _MAG, bits)
    return torch.where(torch.isnan(x), torch.full_like(keys, _NAN_KEY), keys)


def agg_count(valid: torch.Tensor) -> torch.Tensor:
    """[S] int64 valid samples a series."""
    return valid.sum(dim=-1)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The last axis summed as the kernel sums it: padded with zeros to a
    power of two, then halved (``a[:w] + a[w:2w]``) until one column is
    left, plus the reduction's zero."""
    T = x.shape[-1]
    Tp = 1 << max(T - 1, 0).bit_length()
    if Tp > T:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (Tp - T,))], dim=-1)
    while x.shape[-1] > 1:
        w = x.shape[-1] // 2
        x = x[..., :w] + x[..., w:]
    return x[..., 0] + 0.0


def agg_avg(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[S] mean over the valid samples; 0 when a series is empty."""
    cnt = agg_count(valid)
    s = _tree_sum(torch.where(valid, values, torch.zeros_like(values)))
    avg = s / torch.clamp(cnt, min=1).to(s.dtype)
    # a NaN sample makes the mean the canonical quiet NaN, whatever payload
    # the adds carried along
    avg = torch.where(torch.isnan(avg), torch.full_like(avg, float("nan")), avg)
    return torch.where(cnt == 0, torch.zeros_like(s), avg)


def _sorted_index(values: torch.Tensor, valid: torch.Tensor):
    """(the samples with invalid ones as 1e300, the stable ascending order)."""
    x = torch.where(valid, values, torch.full_like(values, BIG))
    return x, torch.sort(_order_keys(x), dim=-1, stable=True).indices


def _percentile_from(x, order, cnt, p: float) -> torch.Tensor:
    T = x.shape[-1]
    prod = cnt.to(torch.float32) * torch.tensor(p, dtype=torch.float32, device=cnt.device)
    idx = torch.clamp(prod.to(torch.int32).to(torch.int64) - 1, 0, T - 1)
    src = order.gather(-1, idx[..., None])
    out = x.gather(-1, src)[..., 0]
    return torch.where(cnt == 0, torch.zeros_like(out), out)


def agg_percentile(values: torch.Tensor, valid: torch.Tensor, p: float) -> torch.Tensor:
    """[S] percentile per fieldPercentileOfMetricList (see module doc)."""
    x, order = _sorted_index(values, valid)
    return _percentile_from(x, order, agg_count(valid), p)


def agg_last(values: torch.Tensor, valid: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """[S] the value at the first index of the largest valid timestamp
    (fieldLastOfMetricList; a NaN time counts as the largest, as
    ``jnp.argmax`` counts it)."""
    t = torch.where(valid, times, torch.full_like(times, -BIG))
    nan = torch.isnan(t)
    first_nan = nan.to(torch.int8).argmax(dim=-1)
    top = t.amax(dim=-1, keepdim=True)
    first_top = (t == top).to(torch.int8).argmax(dim=-1)
    idx = torch.where(nan.any(dim=-1), first_nan, first_top)
    out = values.gather(-1, idx[..., None])[..., 0]
    return torch.where(valid.any(dim=-1), out, torch.zeros_like(out))


def aggregate_node_metrics_plain(values, valid, times) -> torch.Tensor:
    """[6, S] float64: (avg, p50, p90, p95, p99, last) stacked."""
    cnt = agg_count(valid)
    x, order = _sorted_index(values, valid)
    return torch.stack([agg_avg(values, valid)]
                       + [_percentile_from(x, order, cnt, p) for p in PERCENTILES]
                       + [agg_last(values, valid, times)])


def aggregate_node_metrics(values: torch.Tensor, valid: torch.Tensor,
                           times: torch.Tensor) -> torch.Tensor:
    """The full NodeMetric AggregatedUsage vector per series: [6, S] float64
    (avg, p50, p90, p95, p99, last).  ``values``/``times`` [S, T] float64,
    ``valid`` [S, T] bool, all on one device.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/metricsagg.cu`` (T <= 2,048) or raise."""
    S, T = values.shape
    for name, t, dtype in (("values", values, torch.float64), ("valid", valid, torch.bool),
                           ("times", times, torch.float64)):
        if t.dtype != dtype or tuple(t.shape) != (S, T) or t.device != values.device:
            raise ValueError(f"{name}: expected {dtype} {(S, T)} on {values.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if values.device.type == "cpu":
        return aggregate_node_metrics_plain(values, valid, times)
    dev = cuda._cuda_device(values)
    if not 1 <= T <= MAX_T:
        raise ValueError(f"aggregate_node_metrics: {T} samples a series, the kernel takes "
                         f"1 to {MAX_T}")
    values, valid, times = values.contiguous(), valid.contiguous(), times.contiguous()
    out = torch.empty((6, S), dtype=torch.float64, device=dev)
    if S:
        ps = (ctypes.c_float * 4)(*PERCENTILES)
        cuda.AGGREGATE_NODE_METRICS.launch(
            values.data_ptr(), valid.data_ptr(), times.data_ptr(), S, T, ctypes.addressof(ps),
            out.data_ptr(), cuda.device_index(dev), cuda.stream(dev))
    return out
