"""deviceshare slice: GPU share/joint allocation host-side + device-level
scoring joining the tensor path.

Reference: pkg/scheduler/plugins/deviceshare/{device_allocator.go,
scoring.go, device_cache.go} and apis/extension/device_share.go — pods
request ``koordinator.sh/gpu-core`` (percent of one GPU, 100 = a full
device; multiples of 100 = that many full devices) and
``koordinator.sh/gpu-memory-ratio``; the AutopilotAllocator picks device
minors per node and the plugin scores nodes by the configured
least/most-allocated strategy over device resources.

The JAX package's module (core/deviceshare.py), copied: the host-side
allocation walk unchanged, ``deviceshare_score`` over the port's torch
NodeFit scorers on CPU tensors, returning numpy.

Like the NUMA slice (SURVEY §7), the combinatorial device selection is
host-side — ``allocate_gpus`` / ``gpu_fit_mask`` produce per-(pod, node)
feasibility and allocations as data — while ``deviceshare_score`` computes
the [P, N] node scores with the SAME least/most-allocated scorers as
core.nodefit (scoring.go reuses the k8s resource strategies), entering
``score_batch`` through ``NumaInputs``-style frozen inputs.

Scope: GPU core + memory-ratio dimensions, binpack (most-allocated) and
spread (least-allocated) device ordering, plus the AutopilotAllocator's
topology-grouped selection (``allocate_joint``): multi-GPU requests land
inside ONE PCIe switch group when possible, else one NUMA node, else
spill machine-wide (device_allocator.go:214-258 allocateByTopology), and
secondary RDMA virtual functions are drawn from the PCIes of the GPU
allocation — one VF per PCIe under the SamePCIe required scope, one VF
total otherwise (device_allocator.go:292-340 jointAllocate).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.core.nodefit import (
    NodeFitNodeArrays,
    NodeFitPodArrays,
    NodeFitStatic,
    nodefit_score_plain,
)

GPU_CORE = "koordinator.sh/gpu-core"
GPU_MEMORY_RATIO = "koordinator.sh/gpu-memory-ratio"
RDMA = "koordinator.sh/rdma"

BINPACK = "binpack"  # most-allocated device first (scoring.go binpack)
SPREAD = "spread"

SCOPE_SAME_PCIE = "SamePCIe"  # apiext.SamePCIeDeviceJointAllocateScope
SCOPE_SAME_NODE = "SameNode"


@dataclasses.dataclass
class GPUDevice:
    """One device minor's share state (device_cache.go deviceResources)
    plus its hardware topology (DeviceInfo.Topology: NUMA node + PCIe
    switch id, apis/scheduling/v1alpha1 DeviceTopology)."""

    minor: int
    core_free: int = 100  # percent of the device
    memory_ratio_free: int = 100
    numa_node: int = 0
    pcie: int = 0

    def full_free(self) -> bool:
        return self.core_free == 100 and self.memory_ratio_free == 100


@dataclasses.dataclass
class RDMADevice:
    """An RDMA NIC with SR-IOV virtual functions (devicehandler_rdma /
    vf allocation, device_allocator.go:292-340)."""

    minor: int
    vfs_free: int = 1
    numa_node: int = 0
    pcie: int = 0


def parse_gpu_request(requests: Dict[str, int]) -> Optional[Tuple[int, int]]:
    """(gpu-core percent, gpu-memory-ratio percent) or None when the pod
    requests no GPU.  memory-ratio defaults to the core percent
    (device_share.go defaulting)."""
    core = int(requests.get(GPU_CORE, 0))
    if core <= 0:
        return None
    ratio = int(requests.get(GPU_MEMORY_RATIO, core))
    return core, ratio


def allocate_gpus(
    devices: Sequence[GPUDevice],
    core_req: int,
    ratio_req: int,
    strategy: str = BINPACK,
    preferred_pcies: Optional[set] = None,
) -> Optional[List[Tuple[int, int, int]]]:
    """[(minor, core, memory-ratio)] or None (AutopilotAllocator.Allocate's
    GPU path):

    - core_req a multiple of 100: that many FULLY free devices, preferring
      ``preferred_pcies`` members first (allocateDevices' preferred sort,
      device_allocator.go:380-420), then stable minors;
    - partial core_req (< 100): one device with enough free core AND
      memory-ratio;
    - device order by the strategy: binpack takes the most-allocated
      (least free) candidates first, spread the least-allocated.
    Requests above 100 that are not whole multiples are rejected
    (ValidateDeviceRequest semantics)."""
    if core_req >= 100:
        if core_req % 100 != 0:
            return None
        count = core_req // 100
        free = [d for d in devices if d.full_free()]
        if len(free) < count:
            return None
        pref = preferred_pcies or set()
        free.sort(key=lambda d: (d.pcie not in pref, d.minor))
        return [(d.minor, 100, 100) for d in free[:count]]
    cands = [
        d
        for d in devices
        if d.core_free >= core_req and d.memory_ratio_free >= ratio_req
    ]
    if not cands:
        return None
    if strategy == BINPACK:
        cands.sort(key=lambda d: (d.core_free, d.minor))
    else:
        cands.sort(key=lambda d: (-d.core_free, d.minor))
    d = cands[0]
    return [(d.minor, core_req, ratio_req)]


def apply_allocation(
    devices: Sequence[GPUDevice], allocation: Sequence[Tuple[int, int, int]]
) -> None:
    by_minor = {d.minor: d for d in devices}
    for minor, core, ratio in allocation:
        d = by_minor[minor]
        d.core_free -= core
        d.memory_ratio_free -= ratio


def allocate_rdma_vfs(
    rdma_devices: Sequence[RDMADevice], count: int
) -> Optional[List[Tuple[int, int]]]:
    """Standalone RDMA VF allocation (a pod requesting koordinator.sh/rdma
    without GPUs): ``count`` VFs drawn stable-minor-first from NICs with
    free functions.  Returns [(minor, vfs)] or None."""
    taken: List[Tuple[int, int]] = []
    need = count
    for r in sorted(rdma_devices, key=lambda r: r.minor):
        if need <= 0:
            break
        got = min(r.vfs_free, need)
        if got > 0:
            taken.append((r.minor, got))
            need -= got
    return taken if need <= 0 else None


def allocate_joint(
    devices: Sequence[GPUDevice],
    core_req: int,
    ratio_req: int,
    strategy: str = BINPACK,
    rdma_devices: Sequence[RDMADevice] = (),
    want_rdma: bool = False,
    required_scope: Optional[str] = None,
) -> Optional[Dict[str, list]]:
    """The AutopilotAllocator's topology walk
    (device_allocator.go:214-258 allocateByTopology + :292-340
    jointAllocate): try each PCIe group with enough free primary devices,
    then each NUMA-node group, then the whole machine; with ``want_rdma``
    draw VFs from the PCIes of the GPU allocation — one per allocated PCIe
    under SCOPE_SAME_PCIE (validated: allocation fails when a PCIe yields
    no VF, validateJointAllocation), one VF total otherwise.

    Returns {"gpu": [(minor, core, ratio)], "rdma": [(minor, vfs)]} or
    None.  Single-GPU / shared requests skip the grouping (desiredCount
    <= 1 takes any candidate)."""

    def vf_alloc(gpu_alloc) -> Optional[List[Tuple[int, int]]]:
        if not want_rdma:
            return []
        by_minor = {d.minor: d for d in devices}
        pcies = sorted({by_minor[m].pcie for m, _, _ in gpu_alloc})
        taken: List[Tuple[int, int]] = []
        budget = {r.minor: r.vfs_free for r in rdma_devices}
        if required_scope == SCOPE_SAME_PCIE:
            for p in pcies:
                cand = [
                    r
                    for r in rdma_devices
                    if r.pcie == p and budget[r.minor] > 0
                ]
                if not cand:
                    return None  # Joint-Allocate rules violation
                cand.sort(key=lambda r: r.minor)
                budget[cand[0].minor] -= 1
                taken.append((cand[0].minor, 1))
            return taken
        cand = sorted(
            (r for r in rdma_devices if budget[r.minor] > 0),
            key=lambda r: (r.pcie not in set(pcies), r.minor),
        )
        if not cand:
            return None
        return [(cand[0].minor, 1)]

    def attempt(cands, preferred_pcies=None):
        alloc = allocate_gpus(cands, core_req, ratio_req, strategy, preferred_pcies)
        if alloc is None:
            return None
        vfs = vf_alloc(alloc)
        if vfs is None:
            return None
        return {"gpu": alloc, "rdma": vfs}

    count = core_req // 100 if core_req >= 100 else 1
    if count > 1:
        # one PCIe switch group (freeNodeDevicesInPCIe order: pcie id)
        by_pcie: Dict[int, List[GPUDevice]] = {}
        for d in devices:
            by_pcie.setdefault(d.pcie, []).append(d)
        for p in sorted(by_pcie):
            if sum(d.full_free() for d in by_pcie[p]) >= count:
                got = attempt(by_pcie[p])
                if got:
                    return got
        # one NUMA node (freeNodeDevicesInNode), preferring its denser PCIes
        by_numa: Dict[int, List[GPUDevice]] = {}
        for d in devices:
            by_numa.setdefault(d.numa_node, []).append(d)
        for n in sorted(by_numa):
            if sum(d.full_free() for d in by_numa[n]) >= count:
                # prefer the group's densest PCIe switches (most free
                # devices) so a within-NUMA pick spans as few as possible
                free_by_pcie: Dict[int, int] = {}
                for d in by_numa[n]:
                    if d.full_free():
                        free_by_pcie[d.pcie] = free_by_pcie.get(d.pcie, 0) + 1
                best = max(free_by_pcie.values(), default=0)
                got = attempt(
                    by_numa[n],
                    {p for p, c in free_by_pcie.items() if c == best},
                )
                if got:
                    return got
    # machine-wide spill — the SamePCIe scope constrains the VF<->GPU PCIe
    # relationship (validateJointAllocation compares primary vs secondary
    # PCIe sets), not the GPU grouping itself; vf_alloc enforces it
    return attempt(list(devices))


def gpu_topology_hints(
    devices: Sequence[GPUDevice], core_req: int, ratio_req: int
):
    """Per-NUMA-mask hints for the topology manager (deviceshare
    topology_hint.go): free GPU capacity summed per NUMA node enters the
    kubelet-style generator on the gpu-core / gpu-memory-ratio axes."""
    from koordinator_tpu_torch.core.topologymanager import generate_resource_hints

    numa_ids = sorted({d.numa_node for d in devices})
    total = {
        n: {
            GPU_CORE: 100 * sum(1 for d in devices if d.numa_node == n),
            GPU_MEMORY_RATIO: 100 * sum(1 for d in devices if d.numa_node == n),
        }
        for n in numa_ids
    }
    free = {
        n: {
            GPU_CORE: sum(d.core_free for d in devices if d.numa_node == n),
            GPU_MEMORY_RATIO: sum(
                d.memory_ratio_free for d in devices if d.numa_node == n
            ),
        }
        for n in numa_ids
    }
    return generate_resource_hints(
        [(n, total[n]) for n in numa_ids],
        free,
        {GPU_CORE: core_req, GPU_MEMORY_RATIO: ratio_req},
    )


def gpu_fit_mask(
    devices_by_node: Sequence[Sequence[GPUDevice]],
    pod_requests: Sequence[Dict[str, int]],
    strategy: str = BINPACK,
) -> np.ndarray:
    """[P, N] bool — does a device allocation exist for pod p on node n
    (pods without GPU requests fit everywhere; the host-side fit result
    entering the tensor path as a mask)."""
    P, N = len(pod_requests), len(devices_by_node)
    out = np.ones((P, N), dtype=bool)
    for i, req in enumerate(pod_requests):
        parsed = parse_gpu_request(req)
        if parsed is None:
            continue
        core, ratio = parsed
        for j, devs in enumerate(devices_by_node):
            out[i, j] = allocate_gpus(devs, core, ratio, strategy) is not None
    return out


def deviceshare_score(
    devices_by_node: Sequence[Sequence[GPUDevice]],
    pod_requests: Sequence[Dict[str, int]],
    strategy: str = BINPACK,
) -> np.ndarray:
    """[P, N] int64 node scores over the GPU core/memory-ratio axis using
    the SAME least/most-allocated scorers as nodefit (scoring.go runs the
    k8s resource strategies over device totals; binpack = MostAllocated,
    spread = LeastAllocated).  Pods without GPU requests score 0 rows
    (Score's state.skip)."""
    P, N = len(pod_requests), len(devices_by_node)
    alloc = np.zeros((N, 2), dtype=np.int64)
    used = np.zeros((N, 2), dtype=np.int64)
    for j, devs in enumerate(devices_by_node):
        alloc[j] = [100 * len(devs), 100 * len(devs)]
        used[j] = [
            sum(100 - d.core_free for d in devs),
            sum(100 - d.memory_ratio_free for d in devs),
        ]
    req = np.zeros((P, 2), dtype=np.int64)
    has = np.zeros(P, dtype=bool)
    for i, r in enumerate(pod_requests):
        parsed = parse_gpu_request(r)
        if parsed:
            req[i] = parsed
            has[i] = True
    t = torch.from_numpy
    pods = NodeFitPodArrays(
        req=t(req), req_score=t(req), has_any_request=t(has)
    )
    nodes = NodeFitNodeArrays(
        alloc=t(alloc),
        requested=t(used),
        num_pods=torch.zeros(N, dtype=torch.int64),
        allowed_pods=torch.full((N,), 1 << 30, dtype=torch.int64),
        alloc_score=t(alloc),
        req_score=t(used),
    )
    static = NodeFitStatic(
        always_check=(False, False),
        scalar_bypass=(True, True),
        weights=(1, 1),
        strategy="MostAllocated" if strategy == BINPACK else "LeastAllocated",
    )
    scores = nodefit_score_plain(pods, nodes, static).numpy()
    return np.where(has[:, None], scores, 0)
