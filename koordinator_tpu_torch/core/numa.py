"""nodenumaresource scoring slice (the JAX package's core/numa.py: the
host side copied, ``amplify`` and ``amplified_cpu_score`` in torch, the
amplification in float64 as there): amplified-CPU scoring on the tensor
path + a host-side cpuset accumulator producing (pod, node) fit masks.

Reference: pkg/scheduler/plugins/nodenumaresource/{scoring.go,
cpu_accumulator.go, cpu_topology.go} and apis/extension's Amplify.

The combinatorial cpuset selection is host-side by design (SURVEY §7 "keep
them host-side initially; only their *scores* join the tensor path"):

- ``CPUTopology`` / ``take_cpus`` — the full cpuAccumulator walk
  (cpu_accumulator.go:87-798): free-core allocation inside one NUMA node,
  then one socket, then the most/least-free-socket spill (FullPCPUs /
  CPUsPerCore==1), or the spread-by-PCPUs free-CPU walks; NUMA candidates
  ordered by the allocate strategy (MostAllocated = least free first,
  LeastAllocated = most free first) with the reference's socket-free and
  id tie-breaks.  Covers ``max_ref_count`` > 1 (CPU sharing: refcounted
  availability, low-refcount-first ordering) and both
  ``CPUExclusivePolicy`` levels — PCPULevel (avoid cores other
  PCPU-exclusive pods hold; spread across distinct cores) and
  NUMANodeLevel (avoid NUMA nodes other NUMANode-exclusive pods hold) —
  each as a preference pass (filterExclusive=True) with a non-filtered
  fallback, exactly the driver's two-pass loops.

- ``amplified_cpu_score`` — scoreWithAmplifiedCPUs (scoring.go:99-118):
  when the node amplifies CPU and the pod requests CPU, the node's
  requested-CPU on the scoring axis swaps the physically allocated cpuset
  milli-CPU for its amplified value (extension.Amplify = ceil through
  float64), then the plugin's own LeastAllocated/MostAllocated scorer runs
  — reused verbatim from core.nodefit.  The result is the fourth score
  plugin, weighted into PluginWeights alongside loadaware / nodefit /
  reservation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.core.nodefit import (
    NodeFitNodeArrays,
    NodeFitPodArrays,
    NodeFitStatic,
    nodefit_score_plain,
)

FULL_PCPUS = "FullPCPUs"
SPREAD_BY_PCPUS = "SpreadByPCPUs"
MOST_ALLOCATED = "MostAllocated"
LEAST_ALLOCATED = "LeastAllocated"

# CPUExclusivePolicy (apis/scheduling config): "" = none
EXCLUSIVE_NONE = ""
PCPU_LEVEL = "PCPULevel"
NUMA_NODE_LEVEL = "NUMANodeLevel"


def amplify(origin, ratio):
    """extension.Amplify: ceil(origin * ratio) through float64; identity
    for ratio <= 1 (node_resource_amplification.go:170-175)."""
    origin = torch.as_tensor(origin)
    r = torch.as_tensor(ratio, dtype=torch.float64, device=origin.device)
    amplified = torch.ceil(origin.to(torch.float64) * r).to(torch.int64)
    return torch.where(r <= 1.0, origin, amplified)


def amplified_cpu_score(
    pods: NodeFitPodArrays,
    nodes: NodeFitNodeArrays,
    static: NodeFitStatic,
    cpu_dim: int,
    allocated_cpuset_milli,  # [N] int64 — milli-CPU held by allocated cpusets
    cpu_ratio,  # [N] float64 — AmplificationRatios[cpu]
):
    """[P, N] scoreWithAmplifiedCPUs: the node's requested CPU swaps the
    raw cpuset-allocated milli-CPU for the amplified value, per-node,
    whenever the pod requests CPU and the node amplifies; the plugin's
    configured scorer (static.strategy) does the rest."""
    pods = NodeFitPodArrays(*(torch.as_tensor(a) for a in pods))
    nodes = NodeFitNodeArrays(*(torch.as_tensor(a) for a in nodes))
    allocated = torch.as_tensor(allocated_cpuset_milli)
    ratio = torch.as_tensor(cpu_ratio, dtype=torch.float64)
    col = nodes.req_score[:, cpu_dim]
    adj = col - allocated + amplify(allocated, ratio)
    req_score = nodes.req_score.clone()
    req_score[:, cpu_dim] = torch.where(ratio > 1.0, adj, col)
    adjusted = nodes._replace(req_score=req_score)
    plain = nodefit_score_plain(pods, nodes, static)
    amped = nodefit_score_plain(pods, adjusted, static)
    # pods with zero CPU request score against the unamplified view
    wants_cpu = pods.req_score[:, cpu_dim] > 0
    return torch.where(wants_cpu[:, None], amped, plain)


# ---------------------------------------------------------------- host side


@dataclasses.dataclass
class CPUTopology:
    """Sockets x NUMA-nodes x cores x hyperthreads (cpu_topology.go:25)."""

    sockets: int
    nodes_per_socket: int
    cores_per_node: int
    cpus_per_core: int

    @property
    def num_nodes(self) -> int:
        return self.sockets * self.nodes_per_socket

    @property
    def cpus_per_node(self) -> int:
        return self.cores_per_node * self.cpus_per_core

    @property
    def cpus_per_socket(self) -> int:
        return self.nodes_per_socket * self.cpus_per_node

    @property
    def num_cpus(self) -> int:
        return self.sockets * self.cpus_per_socket

    def cpu_ids(self, node: int, core: int) -> List[int]:
        base = (node * self.cores_per_node + core) * self.cpus_per_core
        return list(range(base, base + self.cpus_per_core))

    def node_of_cpu(self, cpu: int) -> int:
        return cpu // self.cpus_per_node

    def socket_of_node(self, node: int) -> int:
        return node // self.nodes_per_socket


@dataclasses.dataclass
class CPUAlloc:
    """Per-CPU allocation facts from the node's tracked cpusets
    (resource_manager allocation records): how many pods hold the CPU and
    which exclusive policies those holders declared."""

    ref_count: int = 0
    exclusive_policies: Tuple[str, ...] = ()


class _Accumulator:
    """From-scratch restatement of the reference cpuAccumulator
    (cpu_accumulator.go:234-798): refcounted allocatable set, exclusive
    core/NUMA marks, the sorted free-core / free-CPU views and the take
    bookkeeping.  All orderings replicate the Go comparators including
    tie-breaks."""

    def __init__(
        self,
        topo: CPUTopology,
        available: Sequence[int],
        allocated: Optional[dict],
        num_needed: int,
        exclusive_policy: str,
        numa_strategy: str,
        max_ref_count: int,
    ):
        self.topo = topo
        self.strategy = numa_strategy
        self.max_ref_count = max_ref_count
        self.policy = exclusive_policy
        self.exclusive = exclusive_policy in (PCPU_LEVEL, NUMA_NODE_LEVEL)
        allocated = allocated or {}
        # newCPUAccumulator: exclusive marks from existing allocations
        self.excl_cores: set = set()
        self.excl_nodes: set = set()
        for cpu, alloc in allocated.items():
            for pol in alloc.exclusive_policies:
                if pol == PCPU_LEVEL:
                    self.excl_cores.add(self.core_of(cpu))
                elif pol == NUMA_NODE_LEVEL:
                    self.excl_nodes.add(topo.node_of_cpu(cpu))
        # allocatable cpu -> ref count (refcounts only matter > 1)
        self.allocatable: dict = {
            int(c): (allocated.get(int(c), CPUAlloc()).ref_count if max_ref_count > 1 else 0)
            for c in available
        }
        self.needed = num_needed
        self.result: List[int] = []

    # ---------------------------------------------------------- topology

    def core_of(self, cpu: int) -> int:
        return cpu // self.topo.cpus_per_core

    def node_of_core(self, core: int) -> int:
        return core // self.topo.cores_per_node

    # -------------------------------------------------------------- state

    def needs(self, n: int) -> bool:
        return self.needed >= n

    @property
    def satisfied(self) -> bool:
        return self.needed < 1

    @property
    def failed(self) -> bool:
        return self.needed > len(self.allocatable)

    def take(self, cpus: Sequence[int]) -> None:
        for cpu in cpus:
            self.result.append(cpu)
            self.allocatable.pop(cpu, None)
            if self.exclusive:
                if self.policy == PCPU_LEVEL:
                    self.excl_cores.add(self.core_of(cpu))
                elif self.policy == NUMA_NODE_LEVEL:
                    self.excl_nodes.add(self.topo.node_of_cpu(cpu))
        self.needed -= len(cpus)

    def _excl_pcpu(self, cpu: int) -> bool:
        return self.policy == PCPU_LEVEL and self.core_of(cpu) in self.excl_cores

    def _excl_numa(self, cpu: int) -> bool:
        return (
            self.policy == NUMA_NODE_LEVEL
            and self.topo.node_of_cpu(cpu) in self.excl_nodes
        )

    def _core_ref(self, core: int) -> int:
        return sum(
            self.allocatable.get(cpu, 0)
            for cpu in self.topo.cpu_ids(self.node_of_core(core), core % self.topo.cores_per_node)
        )

    def _sort_cpus_by_ref(self, cpus: List[int]) -> List[int]:
        return sorted(cpus, key=lambda c: (self.allocatable.get(c, 0), c))

    def _sort_cores(self, cores: List[int], cpus_in_cores: dict) -> List[int]:
        """sortCores: more free CPUs first, then (sharing) lower summed
        refcount, then core id."""

        def key(core):
            k = [-len(cpus_in_cores[core])]
            if self.max_ref_count > 1:
                k.append(self._core_ref(core))
            k.append(core)
            return tuple(k)

        return sorted(cores, key=key)

    def _strategy_cmp(self, free: int) -> int:
        # MostAllocated = fewest free first; LeastAllocated = most free
        return free if self.strategy == MOST_ALLOCATED else -free

    def extract_one_per_core(self, cpus: List[int]) -> List[int]:
        seen: set = set()
        out = []
        for c in cpus:
            core = self.core_of(c)
            if core not in seen:
                seen.add(core)
                out.append(c)
        return out

    def spread(self, cpus: List[int]) -> List[int]:
        """spreadCPUs: stable round-robin, one CPU per core per pass."""
        if len(cpus) <= self.topo.cpus_per_core:
            return list(cpus)
        remaining = list(cpus)
        out: List[int] = []
        while remaining:
            reserved = []
            seen: set = set()
            for cpu in remaining:
                core = self.core_of(cpu)
                if core in seen:
                    reserved.append(cpu)
                else:
                    seen.add(core)
                    out.append(cpu)
            remaining = reserved
        return out

    # --------------------------------------------------------- free views

    def free_cores_in_node(
        self, filter_full_free_core: bool, filter_exclusive: bool
    ) -> List[List[int]]:
        """freeCoresInNode: per NUMA node the flat CPUs of its free cores
        (core-sorted), nodes ordered by node-free then socket-free by
        strategy, then id."""
        socket_free: dict = {}
        cpus_in_cores: dict = {}
        for cpu in self.allocatable:
            if filter_exclusive and self._excl_numa(cpu):
                continue
            cpus_in_cores.setdefault(self.core_of(cpu), []).append(cpu)
            socket_free[self.topo.socket_of_node(self.topo.node_of_cpu(cpu))] = (
                socket_free.get(self.topo.socket_of_node(self.topo.node_of_cpu(cpu)), 0) + 1
            )
        cores_in_nodes: dict = {}
        for core, cpus in cpus_in_cores.items():
            if filter_full_free_core and len(cpus) != self.topo.cpus_per_core:
                continue
            cores_in_nodes.setdefault(self.node_of_core(core), []).append(core)
        cpus_in_nodes: dict = {}
        for node, cores in cores_in_nodes.items():
            flat = []
            for c in self._sort_cores(cores, cpus_in_cores):
                flat.extend(sorted(cpus_in_cores[c]))
            cpus_in_nodes[node] = flat

        def node_key(n):
            return (
                self._strategy_cmp(len(cpus_in_nodes[n])),
                self._strategy_cmp(socket_free.get(self.topo.socket_of_node(n), 0)),
                n,
            )

        return [cpus_in_nodes[n] for n in sorted(cpus_in_nodes, key=node_key)]

    def free_cores_in_socket(self, filter_full_free_core: bool) -> List[List[int]]:
        """freeCoresInSocket (no exclusive filtering, like the Go)."""
        cpus_in_cores: dict = {}
        for cpu in self.allocatable:
            cpus_in_cores.setdefault(self.core_of(cpu), []).append(cpu)
        cores_in_sockets: dict = {}
        for core, cpus in cpus_in_cores.items():
            if filter_full_free_core and len(cpus) != self.topo.cpus_per_core:
                continue
            sock = self.topo.socket_of_node(self.node_of_core(core))
            cores_in_sockets.setdefault(sock, []).append(core)
        cpus_in_sockets: dict = {}
        for sock, cores in cores_in_sockets.items():
            flat = []
            for c in self._sort_cores(cores, cpus_in_cores):
                flat.extend(sorted(cpus_in_cores[c]))
            cpus_in_sockets[sock] = flat

        def sock_key(s):
            return (self._strategy_cmp(len(cpus_in_sockets[s])), s)

        return [cpus_in_sockets[s] for s in sorted(cpus_in_sockets, key=sock_key)]

    def free_cpus_in_node(self, filter_exclusive: bool) -> List[List[int]]:
        """freeCPUsInNode: per NUMA node its free CPUs (id-sorted, then
        refcount-sorted when sharing, one-per-core when exclusive)."""
        cpus_in_nodes: dict = {}
        node_free: dict = {}
        socket_free: dict = {}
        for cpu in self.allocatable:
            if filter_exclusive and (self._excl_pcpu(cpu) or self._excl_numa(cpu)):
                continue
            node = self.topo.node_of_cpu(cpu)
            cpus_in_nodes.setdefault(node, []).append(cpu)
            node_free[node] = node_free.get(node, 0) + 1
            sock = self.topo.socket_of_node(node)
            socket_free[sock] = socket_free.get(sock, 0) + 1
        for node, cpus in cpus_in_nodes.items():
            cpus.sort()
            if self.max_ref_count > 1:
                cpus = self._sort_cpus_by_ref(cpus)
            if filter_exclusive:
                cpus = self.extract_one_per_core(cpus)
            cpus_in_nodes[node] = cpus

        def node_key(n):
            return (
                self._strategy_cmp(node_free[n]),
                self._strategy_cmp(socket_free[self.topo.socket_of_node(n)]),
                n,
            )

        return [cpus_in_nodes[n] for n in sorted(cpus_in_nodes, key=node_key)]

    def free_cpus_in_socket(self, filter_exclusive: bool) -> List[List[int]]:
        """freeCPUsInSocket: PCPU-level exclusivity filter only."""
        cpus_in_sockets: dict = {}
        for cpu in self.allocatable:
            if filter_exclusive and self._excl_pcpu(cpu):
                continue
            sock = self.topo.socket_of_node(self.topo.node_of_cpu(cpu))
            cpus_in_sockets.setdefault(sock, []).append(cpu)
        for sock, cpus in cpus_in_sockets.items():
            cpus.sort()
            if self.max_ref_count > 1:
                cpus = self._sort_cpus_by_ref(cpus)
            if filter_exclusive:
                cpus = self.extract_one_per_core(cpus)
            cpus_in_sockets[sock] = cpus

        def sock_key(s):
            return (self._strategy_cmp(len(cpus_in_sockets[s])), s)

        return [cpus_in_sockets[s] for s in sorted(cpus_in_sockets, key=sock_key)]

    def free_cpus(self, filter_exclusive: bool) -> List[int]:
        """freeCPUs: flat core-sorted CPUs preferring sockets already
        colocated with the partial result, then strategy free scores,
        then core fill, socket/refcount/core tie-breaks."""
        cpus_in_cores: dict = {}
        node_free: dict = {}
        socket_free: dict = {}
        for cpu in self.allocatable:
            if filter_exclusive and (self._excl_pcpu(cpu) or self._excl_numa(cpu)):
                continue
            core = self.core_of(cpu)
            cpus_in_cores.setdefault(core, []).append(cpu)
            node = self.topo.node_of_cpu(cpu)
            node_free[node] = node_free.get(node, 0) + 1
            socket_free[self.topo.socket_of_node(node)] = (
                socket_free.get(self.topo.socket_of_node(node), 0) + 1
            )
        socket_colo: dict = {
            s: sum(
                1
                for c in self.result
                if self.topo.socket_of_node(self.topo.node_of_cpu(c)) == s
            )
            for s in socket_free
        }

        def core_key(core):
            node = self.node_of_core(core)
            sock = self.topo.socket_of_node(node)
            k = [
                -socket_colo.get(sock, 0),
                self._strategy_cmp(socket_free[sock]),
                self._strategy_cmp(node_free[node]),
                len(cpus_in_cores[core]),
                sock,
            ]
            if self.max_ref_count > 1:
                k.append(self._core_ref(core))
            k.append(core)
            return tuple(k)

        out: List[int] = []
        for core in sorted(cpus_in_cores, key=core_key):
            cpus = sorted(cpus_in_cores[core])
            if self.max_ref_count > 1:
                cpus = self._sort_cpus_by_ref(cpus)
            out.extend(cpus)
        return out


def take_cpus(
    topo: CPUTopology,
    available: Sequence[int],
    num_needed: int,
    bind_policy: str = FULL_PCPUS,
    numa_strategy: str = MOST_ALLOCATED,
    allocated: Optional[dict] = None,
    max_ref_count: int = 1,
    exclusive_policy: str = EXCLUSIVE_NONE,
    full_pcpus_only: bool = True,
) -> Optional[List[int]]:
    """The takeCPUs driver (cpu_accumulator.go:87-230).  Returns the taken
    CPU ids in take order, or None when the request cannot be satisfied.

    ``allocated`` maps cpu id -> CPUAlloc for CPUs other pods hold — the
    source of refcounts (max_ref_count > 1 CPU sharing) and of the
    exclusive core/NUMA marks both CPUExclusivePolicy levels avoid.
    Exclusivity is a preference, not a hard filter: every stage runs a
    filterExclusive=True pass then falls back unfiltered, like the
    reference's two-pass loops.

    ``full_pcpus_only`` replicates the kubelet-option rejection of
    requests that cannot monopolize whole cores (node FullPCPUsOnly,
    plugin.go Filter); the reference accumulator itself would take a
    partial core.
    """
    acc = _Accumulator(
        topo, available, allocated, num_needed, exclusive_policy,
        numa_strategy, max_ref_count,
    )
    if acc.satisfied:
        return []
    if acc.failed:
        return None

    full = bind_policy == FULL_PCPUS or topo.cpus_per_core == 1
    if full and full_pcpus_only and num_needed % topo.cpus_per_core != 0:
        return None
    if full:
        # whole free cores in one NUMA node (exclusive-preferring pass
        # first), then one socket, then the spill across sockets
        if acc.needed <= topo.cpus_per_node:
            for filter_exclusive in (True, False):
                for cpus in acc.free_cores_in_node(True, filter_exclusive):
                    if len(cpus) >= acc.needed:
                        acc.take(cpus[: acc.needed])
                        return acc.result
        if acc.needed <= topo.cpus_per_socket:
            for cpus in acc.free_cores_in_socket(True):
                if len(cpus) >= acc.needed:
                    acc.take(cpus[: acc.needed])
                    return acc.result
        # spill: most-free sockets whole, then least-free core-by-core
        free = acc.free_cores_in_socket(True)
        free.sort(key=lambda cpus: -len(cpus))
        unsatisfied: List[List[int]] = []
        for cpus in free:
            if not acc.needs(len(cpus)):
                unsatisfied.append(cpus)
            else:
                acc.take(cpus)
                if acc.satisfied:
                    return acc.result
        if acc.needs(topo.cpus_per_core):
            unsatisfied.sort(key=len)
            for cpus in unsatisfied:
                for i in range(0, len(cpus), topo.cpus_per_core):
                    # the final chunk takes only what is still needed —
                    # the Go inner-break quirk would grab a whole core
                    # per remaining socket and over-allocate when the
                    # request is not core-aligned (full_pcpus_only=False)
                    acc.take(cpus[i : i + min(topo.cpus_per_core, acc.needed)])
                    if acc.satisfied:
                        return acc.result
                    if not acc.needs(topo.cpus_per_core):
                        break
    if not full:
        # SpreadByPCPUs: same-NUMA-node first, then same-socket, each with
        # the exclusive-preferring pass
        if acc.needed <= topo.cpus_per_node:
            for filter_exclusive in (True, False):
                for cpus in acc.free_cpus_in_node(filter_exclusive):
                    if len(cpus) >= acc.needed:
                        cpus = acc.spread(cpus)
                        acc.take(cpus[: acc.needed])
                        return acc.result
        if acc.needed <= topo.cpus_per_socket:
            for filter_exclusive in (True, False):
                for cpus in acc.free_cpus_in_socket(filter_exclusive):
                    if len(cpus) >= acc.needed:
                        cpus = acc.spread(cpus)
                        acc.take(cpus[: acc.needed])
                        return acc.result
    # last resort: colocation-preferring flat walk
    for filter_exclusive in (True, False):
        for c in acc.spread(acc.free_cpus(filter_exclusive)):
            if acc.needs(1):
                acc.take([c])
            if acc.satisfied:
                return acc.result
    return None


def cpuset_fit_mask(
    topo: CPUTopology,
    available_by_node: List[Sequence[int]],  # per cluster node: free CPU ids
    cpu_requests_milli: Sequence[int],  # per pod: milli-CPU (bind = whole CPUs)
    bind_policy: str = FULL_PCPUS,
    numa_strategy: str = MOST_ALLOCATED,
    allocated_by_node: Optional[List[dict]] = None,  # per node: cpu -> CPUAlloc
    max_ref_count: int = 1,
    exclusive_policy: str = EXCLUSIVE_NONE,
) -> np.ndarray:
    """[P, N] bool — does a cpuset allocation exist for pod p on node n
    (the host-side fit result entering the tensor path as a mask)."""
    P, N = len(cpu_requests_milli), len(available_by_node)
    out = np.zeros((P, N), dtype=bool)
    for i, milli in enumerate(cpu_requests_milli):
        need = -(-int(milli) // 1000)  # whole CPUs for bound pods
        for j, avail in enumerate(available_by_node):
            out[i, j] = (
                take_cpus(
                    topo, avail, need, bind_policy, numa_strategy,
                    allocated=(allocated_by_node[j] if allocated_by_node else None),
                    max_ref_count=max_ref_count,
                    exclusive_policy=exclusive_policy,
                )
                is not None
            )
    return out
