"""Pure-Python replay of the descheduler LowNodeLoad balance round
(low_node_load.go processOneNodePool + utilization_util.go + scorer.go +
anomaly/basic_detector.go) for bit-match testing of core/lownodeload.py.
Quantities are plain int64 lists keyed by a fixed resource order; the
detector is replayed as an explicit (state, ab, norm) machine mirroring
BasicDetector's Mark/Reset transitions (timeout expiry excluded — it is
wall-clock state the kernel also scopes out)."""

from __future__ import annotations

from typing import List


def resource_threshold(capacity: int, pct: float) -> int:
    return int(float(pct) * 0.01 * float(capacity))


def calc_average_usage_pct(usages, allocs, valid) -> List[float]:
    R = len(usages[0]) if usages else 0
    total = [0.0] * R
    n = 0
    for u, a, v in zip(usages, allocs, valid):
        if not v:
            continue
        n += 1
        for j in range(R):
            if a[j] != 0:
                total[j] += 100.0 * float(u[j]) / float(a[j])
    n = max(n, 1)
    return [t / n for t in total]


def thresholds(usages, allocs, valid, low_pct, high_pct, use_deviation):
    R = len(low_pct)
    if use_deviation:
        avg = calc_average_usage_pct(usages, allocs, valid)
        lo = [min(max(avg[j] - low_pct[j], 0.0), 100.0) for j in range(R)]
        hi = [min(max(avg[j] + high_pct[j], 0.0), 100.0) for j in range(R)]
        lo = [100.0 if low_pct[j] == 0.0 else lo[j] for j in range(R)]
        hi = [100.0 if low_pct[j] == 0.0 else hi[j] for j in range(R)]
    else:
        lo, hi = low_pct, high_pct
    low_q = [[resource_threshold(a[j], lo[j]) for j in range(R)] for a in allocs]
    high_q = [[resource_threshold(a[j], hi[j]) for j in range(R)] for a in allocs]
    return low_q, high_q


def usage_score(usage, alloc, weights) -> int:
    score, wsum = 0, 0
    for u, a, w in zip(usage, alloc, weights):
        if a == 0:
            r = 0
        else:
            r = (min(u, a) * 1000) // a
        score += r * w
        wsum += w
    return score // wsum if wsum else 0


class Detector:
    """anomaly.BasicDetector minus the wall-clock timeout."""

    OK, ANOMALY = 0, 1

    def __init__(self, state=OK, ab=0, norm=0):
        self.state, self.ab, self.norm = state, ab, norm

    def _set_state(self, state):
        if self.state == state:
            return
        self.state = state
        self.ab = self.norm = 0  # toNewGeneration -> counter.clear()

    def mark(self, normality: bool, ab_bound: int, norm_bound: int) -> int:
        if normality:
            self.norm += 1
            self.ab = 0
            if self.state == self.ANOMALY and self.norm > norm_bound:
                self._set_state(self.OK)
        else:
            self.ab += 1
            self.norm = 0
            if self.state == self.OK and self.ab > ab_bound:
                self._set_state(self.ANOMALY)
        return self.state

    def reset(self):
        self._set_state(self.OK)


def replay_round(
    usages,  # [N][R] int
    allocs,  # [N][R] int
    valid,  # [N] bool
    unschedulable,  # [N] bool
    det_state,  # [N][3] (anomaly:int, ab:int, norm:int) — carried detectors
    pods,  # list of {node:int, usage:[R], removable:bool}
    low_pct,
    high_pct,
    weights,
    use_deviation=False,
    consecutive_abnormalities=5,
    consecutive_normalities=3,
    number_of_nodes=0,
):
    """Returns (evicted [Pc] bool, det_state' [N][3], under [N], over [N],
    source [N]) replaying one processOneNodePool round."""
    N, R = len(usages), len(low_pct)
    dets = [Detector(*s) for s in det_state]

    def dump():
        return [(d.state, d.ab, d.norm) for d in dets]

    low_q, high_q = thresholds(usages, allocs, valid, low_pct, high_pct, use_deviation)
    under, over = [], []
    for n in range(N):
        u = valid[n] and not unschedulable[n] and all(
            usages[n][j] <= low_q[n][j] for j in range(R)
        )
        o = (not u) and valid[n] and any(usages[n][j] > high_q[n][j] for j in range(R))
        under.append(u)
        over.append(o)

    evicted = [False] * len(pods)
    debounce = consecutive_abnormalities > 1

    # filterRealAbnormalNodes: Mark(false) on every over node
    if debounce:
        source = [
            over[n]
            and dets[n].mark(False, consecutive_abnormalities, consecutive_normalities)
            == Detector.ANOMALY
            for n in range(N)
        ]
    else:
        source = list(over)

    # gate chain (low_node_load.go:177-201)
    if not any(over) or not any(source) or not any(under):
        return evicted, dump(), under, over, source
    if debounce:
        for n in range(N):
            if under[n]:
                dets[n].reset()
    n_under = sum(under)
    if n_under <= number_of_nodes or n_under == N:
        return evicted, dump(), under, over, source

    # evictPodsFromSourceNodes: shared headroom pool over destinations
    avail = [
        sum(high_q[n][j] - usages[n][j] for n in range(N) if under[n]) for j in range(R)
    ]
    live_usage = [list(u) for u in usages]

    node_order = sorted(
        range(N), key=lambda n: (-usage_score(usages[n], allocs[n], weights), n)
    )
    for n in node_order:
        if not source[n]:
            continue
        # candidates = removable pods only (classifyPods pre-filter)
        overused = [usages[n][j] > high_q[n][j] for j in range(R)]
        pod_w = [weights[j] if overused[j] else 0 for j in range(R)]
        cands = [
            k for k in range(len(pods)) if pods[k]["node"] == n and pods[k]["removable"]
        ]
        cands.sort(key=lambda k: (-usage_score(pods[k]["usage"], allocs[n], pod_w), k))
        for k in cands:
            # continueEvictionCond before each candidate
            if not any(live_usage[n][j] > high_q[n][j] for j in range(R)):
                if debounce:
                    dets[n].reset()  # mid-eviction resetNodesAsNormal
                break
            if not all(a > 0 for a in avail):
                break
            evicted[k] = True
            for j in range(R):
                live_usage[n][j] -= pods[k]["usage"][j]
                avail[j] -= pods[k]["usage"][j]

    # tryMarkNodesAsNormal on all sources (even ones reset mid-eviction)
    if debounce:
        for n in range(N):
            if source[n]:
                dets[n].mark(True, consecutive_abnormalities, consecutive_normalities)
    return evicted, dump(), under, over, source
