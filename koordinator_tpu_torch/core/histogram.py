"""Batched VPA-style exponentially-decaying histograms.

The port of the JAX package's ``core/histogram.py``, after
pkg/util/histogram/{histogram.go,decaying_histogram.go,
histogram_options.go}: the substrate of the koordlet's peak prediction
(pkg/koordlet/prediction/peak_predictor.go trains one histogram per
node/priority-class/pod and queries p95 CPU / p98 memory).  E entities'
histograms are one [E, B] float64 weight tensor, updated and queried with
plain torch ops on the tensors' device; no kernel of its own.

Semantics, as the reference's:
- bucket layout: linear (fixed size) or exponential (bucket n sized
  first*ratio^n, so bucket n >= 1 starts at first*(ratio^n - 1)/(ratio - 1));
- decaying weights: a sample at time t weighs w * 2^((t - ref)/halfLife);
  when the exponent would exceed maxDecayExponent=100, the reference
  timestamp shifts to halfUp(t/halfLife)*halfLife and every weight scales by
  2^floor((ref_old - ref_new)/halfLife + 0.5) (decaying_histogram.go:100-101,137);
- Percentile(p): walk buckets from minBucket (first with weight >= epsilon)
  accumulating until partialSum >= p*totalWeight, stop at maxBucket; return
  the next bucket's start unless at the last bucket; empty -> 0;
- checkpoint: per-bucket uint32 weights normalized so the largest stores
  MaxCheckpointWeight=10000, the float64 total weight and the reference
  timestamp (host numpy, the JAX package's arithmetic, so a blob either
  package writes loads in the other).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

MAX_CHECKPOINT_WEIGHT = 10000  # histogram.go:33
MAX_DECAY_EXPONENT = 100  # decaying_histogram.go


@dataclasses.dataclass(frozen=True)
class HistogramOptions:
    """Static bucket layout (linear or exponential) + epsilon."""

    num_buckets: int
    epsilon: float
    bucket_size: float = 0.0  # linear
    first_bucket_size: float = 0.0  # exponential
    ratio: float = 0.0  # exponential (> 1)

    @staticmethod
    def linear(max_value: float, bucket_size: float, epsilon: float):
        return HistogramOptions(
            num_buckets=int(math.ceil(max_value / bucket_size)) + 1,
            epsilon=epsilon,
            bucket_size=bucket_size,
        )

    @staticmethod
    def exponential(max_value: float, first_bucket_size: float, ratio: float, epsilon: float):
        nb = int(math.ceil(math.log(max_value * (ratio - 1) / first_bucket_size + 1, ratio))) + 1
        return HistogramOptions(
            num_buckets=nb, epsilon=epsilon, first_bucket_size=first_bucket_size, ratio=ratio
        )

    def find_bucket(self, values: torch.Tensor) -> torch.Tensor:
        if self.ratio:
            inner = values * (self.ratio - 1.0) / self.first_bucket_size + 1.0
            b = torch.floor(torch.log(torch.clamp(inner, min=1.0)) / math.log(self.ratio))
        else:
            b = torch.floor(values / self.bucket_size)
        return torch.clamp(b.to(torch.int64), 0, self.num_buckets - 1)

    def bucket_starts(self, device) -> torch.Tensor:
        n = np.arange(self.num_buckets, dtype=np.float64)
        if self.ratio:
            starts = self.first_bucket_size * (self.ratio**n - 1.0) / (self.ratio - 1.0)
        else:
            starts = n * self.bucket_size
        return torch.as_tensor(starts, device=device)


class HistogramState(NamedTuple):
    weights: torch.Tensor  # [E, B] float64
    reference_ts: torch.Tensor  # [E] float64 seconds


def new_state(num_entities: int, options: HistogramOptions, device) -> HistogramState:
    """Empty histograms of ``num_entities`` on ``device`` (required, as
    every entry point of the port names its device: "cpu" or a card)."""
    return HistogramState(
        weights=torch.zeros((num_entities, options.num_buckets), dtype=torch.float64,
                            device=device),
        reference_ts=torch.zeros(num_entities, dtype=torch.float64, device=device),
    )


def add_samples(state: HistogramState, options: HistogramOptions, values, weights, ts,
                half_life: float) -> HistogramState:
    """Batched decayingHistogram.AddSample (one sample per entity; mask an
    entity out with weight 0).  ``values``, ``weights``, ``ts``: [E]
    float64 on the state's device."""
    # renormalize entities whose decay exponent grew too large
    max_allowed = state.reference_ts + half_life * MAX_DECAY_EXPONENT
    need_shift = ts > max_allowed
    # Go time.Round is half away from zero (half up for these non-negative
    # timestamps) and the exponent helper is floor(x+0.5)
    new_ref = torch.floor(ts / half_life + 0.5) * half_life
    exponent = torch.floor((state.reference_ts - new_ref) / half_life + 0.5)
    scale = torch.exp2(exponent)
    w = torch.where(need_shift[:, None], state.weights * scale[:, None], state.weights)
    ref = torch.where(need_shift, new_ref, state.reference_ts)

    decay = torch.exp2((ts - ref) / half_life)
    bucket = options.find_bucket(values)
    onehot = torch.nn.functional.one_hot(bucket, options.num_buckets).to(w.dtype)
    w = w + onehot * (weights * decay)[:, None]
    return HistogramState(weights=w, reference_ts=ref)


def percentile(state: HistogramState, options: HistogramOptions, p: float) -> torch.Tensor:
    """[E] histogram.Percentile(p) (the walk of the module doc)."""
    w = state.weights
    B = options.num_buckets
    nonempty = w >= options.epsilon
    any_ne = nonempty.any(dim=-1)
    idxs = torch.arange(B, device=w.device)
    min_b = nonempty.to(torch.int8).argmax(dim=-1)  # first nonempty (0 if none)
    max_b = B - 1 - nonempty.flip(-1).to(torch.int8).argmax(dim=-1)
    total = w.sum(dim=-1)
    threshold = p * total
    in_range = (idxs[None] >= min_b[:, None]) & (idxs[None] <= max_b[:, None])
    csum = torch.cumsum(torch.where(in_range, w, torch.zeros_like(w)), dim=-1)
    # first bucket in [min_b, max_b - 1] where csum >= threshold, else max_b
    hit = (csum >= threshold[:, None]) & (idxs[None] < max_b[:, None]) & in_range
    bucket = torch.where(hit.any(dim=-1), hit.to(torch.int8).argmax(dim=-1), max_b)
    starts = options.bucket_starts(w.device)
    result = torch.where(bucket < B - 1, starts[torch.clamp(bucket + 1, max=B - 1)],
                         starts[bucket])
    # IsEmpty(): weight at minBucket below epsilon -> 0
    return torch.where(any_ne, result, torch.zeros_like(result))


def save_checkpoint(state: HistogramState, options: HistogramOptions):
    """Batched SaveToCheckpoint: ([E, B] uint32 scaled weights, [E] total,
    [E] reference_ts) as numpy."""
    w = state.weights.cpu().numpy()
    mx = w.max(axis=-1, keepdims=True)
    ratio = np.where(mx > 0, MAX_CHECKPOINT_WEIGHT / np.where(mx == 0, 1, mx), 0.0)
    stored = np.floor(w * ratio + 0.5).astype(np.uint32)
    return stored, w.sum(axis=-1), state.reference_ts.cpu().numpy()


def load_checkpoint(stored, total, reference_ts, device) -> HistogramState:
    """Batched LoadFromCheckpoint: redistribute total over stored weights,
    onto ``device`` (required)."""
    stored = np.asarray(stored, dtype=np.float64)
    s = stored.sum(axis=-1, keepdims=True)
    ratio = np.where(s > 0, np.asarray(total)[:, None] / np.where(s == 0, 1, s), 0.0)
    return HistogramState(
        weights=torch.as_tensor(stored * ratio, device=device),
        reference_ts=torch.as_tensor(np.asarray(reference_ts, dtype=np.float64), device=device),
    )


def peak_prediction(cpu_p95: torch.Tensor, mem_p98: torch.Tensor, safety_margin_pct: int = 10):
    """peak_predictor.go:176-193: scale p95 CPU / p98 memory by
    (100 + safetyMargin)/100 through float64 truncation."""
    ratio = (100.0 + safety_margin_pct) / 100.0
    return ((cpu_p95.to(torch.float64) * ratio).to(torch.int64),
            (mem_p98.to(torch.float64) * ratio).to(torch.int64))
