"""QuotaGroup list -> dense QuotaArrays + level topology.

Row 0 is the virtual root (extension.RootQuotaName); groups are BFS-ordered
so every level is a contiguous index range and all children of a parent share
a level (webhook quota_topology.go guarantees the tree is acyclic and
parent-complete).  System/default quota groups live OUTSIDE the tree
(refreshRuntimeNoLock:274-276 — their runtime is their max); callers subtract
their used from the cluster total (totalResourceExceptSystemAndDefaultUsed).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from koordinator_tpu_torch.api.quota import ROOT_QUOTA, QuotaGroup

INF = np.int64(1) << 60


class QuotaSnapshot:
    def __init__(self, groups: List[QuotaGroup], resources: List[str]):
        self.resources = resources
        self.index: Dict[str, int] = {ROOT_QUOTA: 0}
        by_parent: Dict[str, List[QuotaGroup]] = {}
        for g in groups:
            by_parent.setdefault(g.parent, []).append(g)

        # BFS levels
        self.levels: List[np.ndarray] = []
        frontier = [ROOT_QUOTA]
        ordered: List[QuotaGroup] = []
        while frontier:
            level_groups: List[QuotaGroup] = []
            for name in frontier:
                level_groups.extend(by_parent.get(name, []))
            if not level_groups:
                break
            start = 1 + len(ordered)
            for g in level_groups:
                ordered.append(g)
                self.index[g.name] = len(ordered)  # 1-based rows
            self.levels.append(np.arange(start, start + len(level_groups), dtype=np.int32))
            frontier = [g.name for g in level_groups]
        self.groups = ordered

        Q, R = 1 + len(ordered), len(resources)
        self.parent = np.zeros(Q, dtype=np.int32)
        self.min = np.zeros((Q, R), dtype=np.int64)
        self.max_eff = np.full((Q, R), INF, dtype=np.int64)
        self.weight = np.zeros((Q, R), dtype=np.int64)
        self.guarantee = np.zeros((Q, R), dtype=np.int64)
        self.own_request = np.zeros((Q, R), dtype=np.int64)
        self.allow_lent = np.ones(Q, dtype=bool)
        self.enable_scale = np.zeros(Q, dtype=bool)
        self.used = np.zeros((Q, R), dtype=np.int64)
        self.npu = np.zeros((Q, R), dtype=np.int64)

        def fill(rl):
            return [rl.get(r, 0) for r in resources]

        for g in ordered:
            i = self.index[g.name]
            self.parent[i] = self.index[g.parent]
            self.min[i] = fill(g.min)
            for j, r in enumerate(resources):
                if r in g.max:
                    self.max_eff[i, j] = g.max[r]
            self.weight[i] = fill(g.effective_shared_weight())
            self.guarantee[i] = fill(g.guarantee)
            self.own_request[i] = fill(g.pod_requests)
            self.allow_lent[i] = g.allow_lent
            self.enable_scale[i] = g.enable_scale_min
            self.used[i] = fill(g.used)
            self.npu[i] = fill(g.non_preemptible_used)

        # used aggregates up the chain (updateGroupDeltaUsedNoLock)
        for lvl in reversed(self.levels):
            for i in lvl:
                p = self.parent[i]
                if p != 0:
                    self.used[p] += self.used[i]
                    self.npu[p] += self.npu[i]

    def arrays(self):
        from koordinator_tpu_torch.core.quota import QuotaArrays

        return QuotaArrays(
            parent=self.parent,
            min=self.min,
            max_eff=self.max_eff,
            weight=self.weight,
            guarantee=self.guarantee,
            own_request=self.own_request,
            allow_lent=self.allow_lent,
            enable_scale=self.enable_scale,
        )

    def level_tuple(self) -> Tuple[np.ndarray, ...]:
        return tuple(self.levels)

    def used_limit(self, runtime: np.ndarray, enable_runtime: bool = True) -> np.ndarray:
        """getQuotaInfoUsedLimit: runtime when EnableRuntimeQuota else max
        (0 on dimensions without a configured max).  Row 0 (virtual root) is
        unlimited so quota-less pods always pass."""
        if enable_runtime:
            limit = runtime.copy()
        else:
            limit = np.where(self.max_eff == INF, 0, self.max_eff)
        limit[0] = INF
        return limit

    def prefilter_min(self) -> np.ndarray:
        """min for the non-preemptible check; virtual root unlimited."""
        mn = self.min.copy()
        mn[0] = INF
        return mn
