"""Coscheduling (gang / PodGroup) as tensor ops, in torch.

The JAX package's core/gang.py, the same three mechanisms:

- QueueSort ``Less`` (coscheduling.go:118-162): priority desc, sub-priority
  desc, creation timestamp (a gang pod takes its gang's creation time),
  gang row, then submission order.  ``queue_sort_perm`` returns the scan
  order (the engine computes it on host tensors).
- PreFilter fast-fail (core/core.go:221-265): ``gang_prefilter``.
- Permit all-or-nothing (core/core.go:312-380): ``commit_gangs`` revokes
  every placement of a gang group that missed minMember, unless the gang
  is non-strict.

The constrained SCHEDULE kernels (``csrc/schedule.cu``) evaluate the
prefilter per pod and run ``commit_gangs`` as their epilogue; these are
the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NO_GANG = 0  # gang row 0 is the "no gang" sentinel


class GangArrays(NamedTuple):
    """[G] dense gangs; row 0 = no-gang sentinel (always passes).  ``group``,
    ``bound_count`` and ``non_strict`` may be None: each gang its own
    group, nothing bound, all strict."""

    min_member: torch.Tensor  # [G] int64
    member_count: torch.Tensor  # [G] int64
    has_init: torch.Tensor  # [G] bool
    once_satisfied: torch.Tensor  # [G] bool
    group: Optional[torch.Tensor] = None  # [G] int32 gang-group row
    bound_count: Optional[torch.Tensor] = None  # [G] int64
    non_strict: Optional[torch.Tensor] = None  # [G] bool


class GangPodArrays(NamedTuple):
    gang: torch.Tensor  # [P] int32 — gang row (0 = none)
    priority: torch.Tensor  # [P] int64
    sub_priority: torch.Tensor  # [P] int64
    timestamp: torch.Tensor  # [P] float64 — gang creation time for gang pods


def dense_gangs(gangs: GangArrays) -> GangArrays:
    """``gangs`` with the optional fields filled by their defaults."""
    G = gangs.min_member.shape[0]
    dev = gangs.min_member.device
    return gangs._replace(
        group=(torch.arange(G, dtype=torch.int32, device=dev)
               if gangs.group is None else gangs.group),
        bound_count=(torch.zeros(G, dtype=torch.int64, device=dev)
                     if gangs.bound_count is None else gangs.bound_count),
        non_strict=(torch.zeros(G, dtype=torch.bool, device=dev)
                    if gangs.non_strict is None else gangs.non_strict),
    )


def gang_prefilter(pods: GangPodArrays, gangs: GangArrays) -> torch.Tensor:
    """[P] bool — PodGroupManager.PreFilter fast-fail."""
    g = pods.gang.long()
    ok = gangs.once_satisfied[g] | (gangs.member_count[g] >= gangs.min_member[g])
    ok = ok & gangs.has_init[g]
    return (g == NO_GANG) | ok


def queue_sort_perm(pods: GangPodArrays) -> torch.Tensor:
    """[P] int64 scan order per the Less above: stable sorts from the minor
    key to the major one (the first sort by index is the identity)."""
    perm = torch.arange(pods.gang.shape[0], device=pods.gang.device)
    for key in (pods.gang, pods.timestamp, -pods.sub_priority, -pods.priority):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def commit_gangs(hosts: torch.Tensor, pods: GangPodArrays, gangs: GangArrays):
    """(final_hosts [P], gang_ok [G]) — revoke every placement of a gang
    GROUP that did not fully reach minMember (placed + bound children, or
    once-satisfied); non-strict gangs keep their placements while
    ``gang_ok`` still reports the group unsatisfied."""
    g = dense_gangs(gangs)
    G = g.min_member.shape[0]
    rows = pods.gang.long()
    placed = torch.zeros(G, dtype=torch.int64, device=hosts.device).index_add(
        0, rows, (hosts >= 0).to(torch.int64))
    satisfied = (placed + g.bound_count >= g.min_member) | g.once_satisfied
    unsat = torch.zeros(G, dtype=torch.int64, device=hosts.device).index_add(
        0, g.group.long(), (~satisfied).to(torch.int64))
    gang_ok = (unsat == 0)[g.group.long()]
    keep_gang = gang_ok | g.non_strict
    keep = (rows == NO_GANG) | keep_gang[rows]
    return torch.where(keep, hosts, torch.full_like(hosts, -1)), gang_ok
