"""The wire-op -> ClusterState application path of APPLY.

One ordered delta batch from the wire: each op goes through the admission
webhooks (``service.webhook.admit_op``), which may reject it or rewrite it
in place, and then applies to the store in the order the informer sent it.
Two callers: the server's APPLY, and the descheduler's controller effects
(reservation create/drop/retire, the source unassign, the rollback
re-assign, the ``anomaly`` counters), which are post-admission forms and
apply with ``admit=False``.
"""

from __future__ import annotations

from typing import List, Sequence

from koordinator_tpu_torch.service import protocol as proto


def apply_wire_ops(state, ops: Sequence[dict], admit: bool = True) -> List[dict]:
    """Apply one ordered delta batch to ``state``; returns the admission
    ``rejects`` list.  The op list preserves informer event order exactly
    — category batching would mis-apply compound sequences (pod moved
    A->B, node removed+recreated) whose meaning depends on that order.
    ``admit=True`` runs the admission webhooks per op (APPLY)."""
    from koordinator_tpu_torch.api.model import AssignedPod
    from koordinator_tpu_torch.service.webhook import admit_op

    rejects: List[dict] = []
    for op_index, op in enumerate(ops):
        k = op["op"]
        # admission webhooks (per-object semantics): a rejected op is
        # skipped with its reason in the reply; mutating webhooks may
        # rewrite the op dict in place
        reason = admit_op(op, state) if admit else None
        if reason is not None:
            rejects.append(
                {
                    "index": op_index,
                    "op": k,
                    "name": op.get("name")
                    or op.get("node")
                    or op.get("pod", {}).get("name", ""),
                    "reason": reason,
                }
            )
            continue
        if k == "upsert":
            state.upsert_node(proto.node_spec_from_wire(op["node"]))
        elif k == "metric":
            state.update_metric(op["node"], proto.metric_from_wire(op["m"]))
        elif k == "assign":
            state.assign_pod(
                op["node"],
                AssignedPod(pod=proto.pod_from_wire(op["pod"]), assign_time=op["t"]),
            )
        elif k == "unassign":
            state.unassign_pod(op["key"])
        elif k == "remove":
            state.remove_node(op["node"])
        elif k == "topology":
            state.set_topology(op["node"], proto.topology_from_wire(op["t"]))
        elif k == "topology_remove":
            state.remove_topology(op["node"])
        elif k == "devices":
            gpus, rdma = proto.devices_from_wire(op["d"])
            state.set_devices(op["node"], gpus, rdma)
        elif k == "devices_remove":
            state.remove_devices(op["node"])
        elif k == "gang":
            state.gangs.upsert(proto.gang_from_wire(op["g"]))
        elif k == "gang_remove":
            state.gangs.remove(op["name"])
        elif k == "quota":
            # topology invariants enforced here: a malformed tree is
            # an ERROR frame, never a wrong waterfill
            state.quota.upsert(proto.quota_group_from_wire(op["g"]))
        elif k == "quota_remove":
            state.quota.remove(op["name"])
        elif k == "quota_total":
            state.quota.set_total({r: int(v) for r, v in op["total"].items()})
        elif k == "rsv":
            state.reservations.upsert(proto.reservation_from_wire(op["r"]))
        elif k == "rsv_remove":
            state.reservations.remove(op["name"])
        elif k == "rsv_retire":
            # migration scavenge: delete the reservation AND its
            # consumption records (rsv_remove keeps the consumer map's
            # entries pointing at the dead name)
            state.reservations.retire(op["name"])
        elif k == "anomaly":
            # one pool's cross-tick anomaly-detector counters
            state.set_desched_anomaly(op["pool"], op["names"], op["anomaly"], op["ab"],
                                      op["norm"])
        else:
            raise ValueError(f"unknown delta op {k!r}")
    return rejects
