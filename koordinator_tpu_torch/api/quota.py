"""Sparse model of the ElasticQuota hierarchy.

Mirrors the slice of apis/thirdparty ElasticQuota + koordinator annotations the
scheduler's GroupQuotaManager consumes (pkg/scheduler/plugins/elasticquota/core):
per group min/max, shared weight (defaults to max when unset — quota_info.go
NewQuotaInfoFromQuota), guarantee, allowLentResource, enableScaleMinQuota
(annotation), the parent edge, and the pod-derived request/used aggregates.

Resource units follow getQuantityValue (runtime_quota_calculator.go:500-505):
CPU in milli, everything else in plain value — all int64.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

ResourceList = Dict[str, int]

# extension.RootQuotaName / SystemQuotaName / DefaultQuotaName
ROOT_QUOTA = "koordinator-root-quota"
SYSTEM_QUOTA = "koordinator-system-quota"
DEFAULT_QUOTA = "koordinator-default-quota"


@dataclass
class QuotaGroup:
    name: str
    parent: str = ROOT_QUOTA
    min: ResourceList = field(default_factory=dict)
    max: ResourceList = field(default_factory=dict)
    shared_weight: Optional[ResourceList] = None  # None -> defaults to max
    guarantee: ResourceList = field(default_factory=dict)
    allow_lent: bool = True  # extension.IsAllowLentResource default true
    enable_scale_min: bool = False  # annotation quota.scheduling.koordinator.sh/enable-min-quota-scale
    is_parent: bool = False
    # pod-derived aggregates for LEAF groups (parents aggregate from children):
    pod_requests: ResourceList = field(default_factory=dict)  # sum of pods' requests
    used: ResourceList = field(default_factory=dict)  # sum of assigned pods' usage
    non_preemptible_used: ResourceList = field(default_factory=dict)

    def effective_shared_weight(self) -> ResourceList:
        return self.max if self.shared_weight is None else self.shared_weight
