"""Admission webhooks at the wire boundary (inventory #35).

The reference's koord-manager serves admission webhooks the apiserver
calls synchronously; objects they reject never reach the informers, and
objects they mutate arrive mutated.  In this framework the wire IS the
apiserver feed, so admission runs per-op inside APPLY: a rejected op is
skipped (never applied) and its reason rides the reply's ``rejects``
list — the per-object semantics of admission, distinct from protocol
errors, which still reject the whole message.

Implemented (matching the reference suites):

- **pod validating** (webhook/pod/validating/verify_annotations.go):
  ordinary pods may not claim the reserve-pod identity — the reserve
  namespace/marker is the sidecar's own synthesis channel
  (forbidAnnotations = [AnnotationReservePod]).
- **node mutating + validating**
  (webhook/node/plugins/resourceamplification): a node carrying
  amplification ratios gets its RAW allocatable saved and its visible
  allocatable amplified (extension.Amplify ceil semantics); ratios must
  be >= 1 and only cpu/memory are supported.
- **elasticquota validating beyond ingestion**
  (webhook/elasticquota/quota_topology.go:153-186 ValidDeleteQuota):
  deleting the system roots, a group with child groups, or a group
  that still charges pods is forbidden.  (Create/update topology
  invariants already validate at ingestion — QuotaStore._validate —
  and stay whole-message errors.)
"""

from __future__ import annotations

import math
from typing import Optional

# the reserve-pod synthesis channel (reservation_handler.go NewReservePod;
# engine.schedule names its synthesized reserve pods into this namespace)
RESERVE_POD_NAMESPACE = "koord-reservation"
ANNOTATION_RESERVE_POD = "scheduling.koordinator.sh/reservation"

# resourceamplification.supportedResources
AMPLIFIABLE = ("cpu", "memory")

# quota groups that may never be deleted (extension System/Root/Default)
PROTECTED_QUOTAS = ("koordinator-system-quota", "koordinator-root-quota", "default")


def admit_op(op: dict, state) -> Optional[str]:
    """Per-op admission: None = allowed (op may have been mutated in
    place — the mutating-webhook side); a string = the rejection reason
    (op is skipped)."""
    kind = op.get("op")
    if kind == "assign":
        return _admit_pod(op.get("pod", {}), state)
    if kind == "upsert":
        return _admit_node(op.get("node", {}))
    if kind == "quota_remove":
        return _admit_quota_delete(op.get("name", ""), state)
    return None


def _admit_pod(pod: dict, state) -> Optional[str]:
    """verify_annotations.go forbidSpecialAnnotations: a pod arriving
    from outside claiming the reserve-pod identity is forbidden.  The
    shim's replay of sidecar-synthesized reserve pods (restart/resync
    contract) is the legitimate exception: name ``reserve-<rsv>`` for a
    reservation the store knows."""
    if pod.get("ns") == RESERVE_POD_NAMESPACE:
        name = pod.get("name", "")
        rsv = name[len("reserve-"):] if name.startswith("reserve-") else None
        if rsv is None or state.reservations.get(rsv) is None:
            return (
                f"annotations.{ANNOTATION_RESERVE_POD}: Forbidden: "
                "cannot set in annotations"
            )
    return None


def _admit_node(node: dict) -> Optional[str]:
    """The node ingestion transformers + amplification plugin, on the
    wire dict (idempotent per message, the codec stays lossless):
    1. TransformNodeWithNodeReservation (util/transformer): under the
       Default apply policy, the node-reservation annotation trims the
       visible allocatable before anything caches the node.
    2. resource-amplification: validate the ratios, then mutate — save
       raw allocatable and amplify the visible one."""
    rsv = node.get("nresv")
    if rsv and rsv.get("applyPolicy", "") in ("", "Default"):
        from koordinator_tpu_torch.api.model import node_reservation_resources

        alloc = node.get("alloc") or {}
        for r, v in node_reservation_resources(rsv).items():
            if r in alloc:
                alloc[r] = max(0, int(alloc[r]) - int(v))
    ratios = node.get("amp")
    if ratios is None:
        # feature off: nothing to do.  (The reference's handleUpdate
        # delete arm cleans ITS saved raw allocatable; here raw_alloc
        # doubles as the standalone AnnotationNodeRawAllocatable surface
        # the estimator consumes, so an amp-less upsert must not strip a
        # user-set raw allocatable — the shim owns that annotation.)
        return None
    for res, ratio in ratios.items():
        if res not in AMPLIFIABLE:
            return (
                f"annotations.node.koordinator.sh/resource-amplification-ratio."
                f"{res}: Invalid value: only supports amplification of cpu "
                "and memory resources"
            )
        if not isinstance(ratio, (int, float)) or ratio < 1.0:
            return (
                f"annotations.node.koordinator.sh/resource-amplification-ratio."
                f"{res}: Invalid value: {ratio!r}: ratio must be >= 1.0"
            )
    alloc = node.get("alloc")
    if not alloc:
        return None
    # the kubelet's reported allocatable is the raw truth; amplify what
    # the scheduler sees (extension.Amplify: ceil through float64)
    raw = dict(node.get("raw_alloc") or {})
    for res, ratio in ratios.items():
        if res not in alloc:
            continue
        base = raw.get(res, alloc[res])
        raw[res] = base
        alloc[res] = int(math.ceil(int(base) * float(ratio)))
    node["raw_alloc"] = raw
    node["alloc"] = alloc
    return None


def _admit_quota_delete(name: str, state) -> Optional[str]:
    """ValidDeleteQuota (quota_topology.go:153-186)."""
    if name in PROTECTED_QUOTAS:
        return f"can not delete quotaGroup :{name}"
    qs = state.quota
    if name not in qs._groups:
        return None  # unknown-name removal stays an idempotent no-op
    if qs._children.get(name):
        return f"delete quota failed, quota{name} has child quota"
    for _pod_key, (group, _vec, _npu) in qs._pod_quota.items():
        if group == name:
            return f"delete quota failed, quota {name} has child pods"
    return None
