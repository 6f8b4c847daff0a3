"""koordinator-tpu on PyTorch and CUDA: the port of ``koordinator_tpu`` to an
NVIDIA H100.

The JAX package beside this one is the reference; this package imports
neither JAX nor anything of it, and keeps its own copies of the
framework-free modules it needs.  Every output is bit-identical to the JAX
package's: all of the scoring and scheduling is int64/int32 math with Go's
rounding.

The port carries the main path ``ClusterState`` -> ``Engine.score`` /
``Engine.schedule`` under all three NodeFit scoring strategies
(LeastAllocated through the resolved engine, MostAllocated and
RequestedToCapacityRatio through the greedy scan), in the JAX package's
default serving configuration: node tables resident on the
device and the SCHEDULE warm start, with the gang, quota and reservation
constraints the stores hold, the placement policies (node selectors, hard
taints, required anti-affinity) and the devices (GPU and RDMA requests,
cpusets under NUMA topology policies, the deviceshare and amplified-CPU
scores, the grants of ``assume=True``).  Its device kernels are written by
hand in CUDA C++ for ``sm_90a`` (``csrc/``): ``score``; the two launches of
``schedule`` (int32 keys, and int64 keys for the ``matrix`` engine); the
``scan``; the warm ``sched_refresh`` and ``sched_rounds`` (each schedule
kernel in a plain-pod and a constrained instantiation, all taking the
placement-and-devices mask and scores); the residency's
``dstate_scatter``, ``dstate_extend`` and ``dstate_gate``; ``quota`` and
``quota_limit``; ``rsv_rscore`` and ``rsv_score``; ``placement``,
``dev_feasible`` and ``ds_score``.  Each kernel's wrapper runs its plain
PyTorch version for CPU tensors and launches the kernel, or raises, for
CUDA tensors.

Layout (the JAX package's, with the same relative module names):
  api/       object model, quota groups (copies)
  core/      config, deviceshare, topologymanager (copies); numa (host side
             copied, the amplified score in torch); loadaware, nodefit,
             cycle, resolved, gang, quota, reservation, placement (torch)
  golden/    nodefit_ref (copy), used by the NodeFit snapshot builder
  ops/       Go-exact rounding helpers (torch)
  snapshot/  numpy builders of the dense inputs (copies)
  service/   transformers, constraints, descheduler's ``tolerates``
             (copies); state (with the device residency), engine
  utils/     synthetic cluster fixtures (copy)
  csrc/      the CUDA kernels; ``cuda.py`` builds and binds them
  convert.py numpy arrays -> tensors on a device
"""

__version__ = "0.1.0"
