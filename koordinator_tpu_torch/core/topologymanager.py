"""Scheduler-side NUMA topology manager: hint merge under the four kubelet
policies, run per (pod, node) at Filter time.  A copy of the JAX
package's core/topologymanager.py (pure Python).

Reference: pkg/scheduler/frameworkext/topologymanager/{policy.go,
policy_none.go, policy_best_effort.go, policy_restricted.go,
policy_single_numa_node.go} and pkg/util/bitmask/bitmask.go.  Masks are
plain Python ints (the reference's uint64 bitMask); hint providers are the
scheduler plugins (nodenumaresource, deviceshare) whose per-resource hint
lists merge into one admitted NUMA affinity:

- every provider contributes, per resource, a list of (mask, preferred,
  score) hints — or "no preference" (a single nil-mask preferred hint);
- the merge walks the cross product of all lists, ANDing masks
  (policy.go mergePermutation) and keeping the best merged hint:
  preferred beats non-preferred, then narrower (fewer bits; ties by more
  lower-numbered bits), then higher score (policy.go mergeFilteredHints);
- the policy decides admission: none = skip entirely, best-effort =
  always admit, restricted / single-numa-node = admit only preferred
  (policy_restricted.go:40, policy_single_numa_node.go:44), with
  single-numa-node additionally pre-filtering to single-bit hints and
  collapsing a full-machine result to nil
  (policy_single_numa_node.go filterSingleNumaHints).

``generate_resource_hints`` is the kubelet-style provider used by the
NUMA-resources plugin (nodenumaresource/resource_manager.go:418
generateResourceHints): every non-empty NUMA-node subset whose TOTAL
capacity fits updates the per-resource minimal affinity size, subsets
whose FREE capacity also fits become hints, and a hint is preferred iff
its popcount equals the minimal affinity size.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

POLICY_NONE = "none"
POLICY_BEST_EFFORT = "best-effort"
POLICY_RESTRICTED = "restricted"
POLICY_SINGLE_NUMA_NODE = "single-numa-node"


class Hint(NamedTuple):
    """topologymanager.NUMATopologyHint: ``mask`` None = no preference."""

    mask: Optional[int]
    preferred: bool
    score: int = 0


def new_mask(*bits: int) -> int:
    m = 0
    for b in bits:
        m |= 1 << b
    return m


def mask_count(m: int) -> int:
    return bin(m).count("1")


def mask_bits(m: int) -> List[int]:
    return [i for i in range(64) if m >> i & 1]


def is_narrower_than(a: int, b: int) -> bool:
    """bitmask.go:146: fewer bits set; ties by more lower-numbered bits
    (the numerically smaller mask)."""
    ca, cb = mask_count(a), mask_count(b)
    if ca == cb:
        return a < b
    return ca < cb


def iterate_bit_masks(bits: Sequence[int]) -> List[int]:
    """bitmask.go:206 IterateBitMasks — every non-empty subset, ordered by
    ascending size then combination order."""
    out: List[int] = []

    def iterate(rest: Sequence[int], accum: List[int], size: int):
        if len(accum) == size:
            out.append(new_mask(*accum))
            return
        for i in range(len(rest)):
            iterate(rest[i + 1:], accum + [rest[i]], size)

    for size in range(1, len(bits) + 1):
        iterate(list(bits), [], size)
    return out


def _filter_providers_hints(
    providers_hints: Sequence[Dict[str, Optional[List[Hint]]]],
) -> List[List[Hint]]:
    """policy.go:100 filterProvidersHints: no-hints providers / resources
    become a single preferred don't-care; an EMPTY list (provider examined
    the resource and found no possible affinity) becomes a single
    non-preferred don't-care."""
    all_hints: List[List[Hint]] = []
    for hints in providers_hints:
        if not hints:
            all_hints.append([Hint(None, True)])
            continue
        for resource in hints:
            if hints[resource] is None:
                all_hints.append([Hint(None, True)])
            elif len(hints[resource]) == 0:
                all_hints.append([Hint(None, False)])
            else:
                all_hints.append(list(hints[resource]))
    return all_hints


def _merge_filtered_hints(
    numa_nodes: Sequence[int], filtered: List[List[Hint]]
) -> Hint:
    """policy.go:126 mergeFilteredHints — cross-product AND + best-hint
    selection (preference, then narrowness, then score)."""
    default = new_mask(*numa_nodes)
    best = Hint(default, False, 0)

    def visit(permutation: List[Hint]):
        nonlocal best
        preferred = True
        merged = default
        for h in permutation:
            merged &= default if h.mask is None else h.mask
            if not h.preferred:
                preferred = False
        if mask_count(merged) == 0:
            return
        score = 0
        for h in permutation:
            if h.mask is not None and merged == h.mask and h.score > score:
                score = h.score
        m = Hint(merged, preferred, score)
        if m.preferred and not best.preferred:
            best = m
            return
        if not m.preferred and best.preferred:
            return
        if not is_narrower_than(m.mask, best.mask):
            if mask_count(m.mask) == mask_count(best.mask) and m.score > best.score:
                best = m
            return
        best = m

    def iterate(i: int, accum: List[Hint]):
        if i == len(filtered):
            visit(accum)
            return
        for h in filtered[i]:
            iterate(i + 1, accum + [h])

    iterate(0, [])
    return best


def merge(
    providers_hints: Sequence[Dict[str, Optional[List[Hint]]]],
    numa_nodes: Sequence[int],
    policy: str,
) -> Tuple[Hint, bool]:
    """Policy.Merge: (best hint, admit).  POLICY_NONE admits everything
    with no affinity (policy_none.go)."""
    if policy == POLICY_NONE:
        return Hint(None, True), True
    filtered = _filter_providers_hints(providers_hints)
    if policy == POLICY_SINGLE_NUMA_NODE:
        # only don't-care and single-bit preferred hints survive
        filtered = [
            [
                h
                for h in hints
                if (h.mask is None and h.preferred)
                or (h.mask is not None and mask_count(h.mask) == 1 and h.preferred)
            ]
            for hints in filtered
        ]
        best = _merge_filtered_hints(numa_nodes, filtered)
        if best.mask == new_mask(*numa_nodes):
            best = Hint(None, best.preferred, 0)
        return best, best.preferred
    best = _merge_filtered_hints(numa_nodes, filtered)
    if policy == POLICY_RESTRICTED:
        return best, best.preferred
    return best, True  # best-effort always admits


def generate_resource_hints(
    numa_node_resources: Sequence[Tuple[int, Dict[str, int]]],
    available: Dict[int, Dict[str, int]],
    requests: Dict[str, int],
    scores: Optional[Dict[int, int]] = None,
) -> Dict[str, List[Hint]]:
    """nodenumaresource/resource_manager.go:418 generateResourceHints.

    ``numa_node_resources``: [(numa id, total capacity)], ``available``:
    free per numa id, ``requests``: the pod's request, ``scores``:
    optional per-mask score (keyed by mask int).  Memory-class resources
    ("memory" and hugepages-*) are verified together like the reference.
    """
    if not requests:
        return {}
    numa_nodes = [n for n, _ in numa_node_resources]
    total_of = {n: r for n, r in numa_node_resources}
    min_affinity = {r: len(numa_node_resources) for r in requests}
    hints: Dict[str, List[Hint]] = {}
    memory_names = [
        r for r in requests if r == "memory" or r.startswith("hugepages-")
    ]

    def try_group(mask: int, bits: List[int], names: List[str]):
        if not names:
            return
        total = {r: sum(total_of[n].get(r, 0) for n in bits) for r in names}
        free = {r: sum(available.get(n, {}).get(r, 0) for n in bits) for r in names}
        if any(total[r] < requests[r] for r in names):
            return
        count = mask_count(mask)
        for r in names:
            if count < min_affinity[r]:
                min_affinity[r] = count
        if any(free[r] < requests[r] for r in names):
            return
        score = (scores or {}).get(mask, 0)
        for r in names:
            hints.setdefault(r, []).append(Hint(mask, False, score))

    for mask in iterate_bit_masks(numa_nodes):
        bits = mask_bits(mask)
        try_group(mask, bits, memory_names)
        for r in requests:
            if r in memory_names:
                continue
            try_group(mask, bits, [r])

    return {
        r: [
            Hint(h.mask, mask_count(h.mask) == min_affinity[r], h.score)
            for h in hints.get(r, [])
        ]
        for r in requests
    }
