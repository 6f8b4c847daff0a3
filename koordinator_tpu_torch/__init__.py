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
``dev_feasible`` and ``ds_score``; the per-plugin scores ``la_score`` and
``nf_score`` of SCORE's breakdown, and the LoadAware library entry point
``loadaware_score_and_filter``; the descheduler's ``deschedule_round`` (one
LowNodeLoad round of a node pool) and ``pod_band_rank`` (the arbitrator's
QoS/priority-band order); the sharded engine's ``shard_score_map`` (SCORE
over one mesh device's node block) and the koordlet's
``aggregate_node_metrics`` (a NodeMetric's mean, percentiles and last
value per series).  Each kernel's wrapper runs its plain
PyTorch version for CPU tensors and launches the kernel, or raises, for
CUDA tensors.

Its entry point is the sidecar the Go shim dials over the KTPU wire
(``service.server.SidecarServer``, ``python -m
koordinator_tpu_torch.cmd.sidecar``): HELLO, APPLY, SCORE (with the
per-plugin breakdown), SCHEDULE, EXPLAIN, QUOTA_REFRESH, PING, ECHO and
the descheduler's DESCHEDULE, each reply byte-identical to the JAX
sidecar's, through the node-axis ``service.sharding.ShardedEngine`` with
``--shards N``; ``service.client.Client`` speaks it from Python, and
``python -m koordinator_tpu_torch.cmd.descheduler`` ticks it.  The
koordlet's metric pipeline (``service.koordlet``: the series store, the
NodeMetric producer, the peak predictor) feeds it NodeMetrics.

Layout (the JAX package's, with the same relative module names):
  api/       object model, quota groups (copies)
  core/      config, configio, deviceshare, topologymanager, evictor (copies);
             numa (host side copied, the amplified score in torch);
             loadaware, nodefit, cycle, resolved, gang, quota, reservation,
             placement, lownodeload, deschedule, metricsagg, histogram (torch)
  golden/    the scalar oracles nodefit_ref, loadaware_ref, reservation_ref,
             quota_ref, lownodeload_ref, evictor_ref (copies);
             host_fallback's SCHEDULE pipeline with the EXPLAIN
             decomposition (copy of fallback_schedule_full)
  ops/       Go-exact rounding helpers (torch)
  snapshot/  numpy builders of the dense inputs (copies)
  service/   transformers, constraints, deschedplugins, the wire protocol,
             client, admission webhooks and wire-op switch (copies); state
             (with the device residency), engine, descheduler, sharding,
             koordlet, server
  cmd/       the sidecar and descheduler binaries
  utils/     synthetic cluster fixtures, feature gates (copies)
  csrc/      the CUDA kernels; ``cuda.py`` builds and binds them
  convert.py numpy arrays -> tensors on a device
"""

__version__ = "0.1.0"


def __getattr__(name):
    """The sidecar's entry points, imported on first use."""
    if name == "SidecarServer":
        from koordinator_tpu_torch.service.server import SidecarServer

        return SidecarServer
    if name == "Client":
        from koordinator_tpu_torch.service.client import Client

        return Client
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
