"""The host pipeline of SCHEDULE, with the EXPLAIN decomposition.

The port's copy of the JAX package's ``golden/host_fallback.py``
``fallback_schedule_full``: the greedy cycle re-run on the host with the
golden per-(pod, node) oracles (``loadaware_ref``, ``nodefit_ref``) as the
scoring core, weighted exactly like the engine's fused total
(core.cycle.PluginWeights), the placement-policy and device inputs from the
engine's host-loop oracles (``placement_mask_host``,
``numa_device_inputs_host``) and the engine's own allocation replay
(``allocation_records_host``).  ``Engine.explain`` runs it over the live
store with ``explain=`` to decompose a SCHEDULE: its chosen nodes and totals
equal the engine's.

The shim's degraded-mode scorer over a mirror (``fallback_score``,
``fallback_extras``, ``fallback_rank`` in the JAX package) is not carried:
no path of the port's sidecar runs it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from koordinator_tpu_torch.api.model import Pod
from koordinator_tpu_torch.golden.loadaware_ref import golden_filter, golden_score
from koordinator_tpu_torch.golden.nodefit_ref import golden_fit_filter, golden_fit_score


def _strip_device_requests(pod: Pod):
    from dataclasses import replace

    from koordinator_tpu_torch.core.deviceshare import GPU_CORE, GPU_MEMORY_RATIO, RDMA

    dev = (GPU_CORE, GPU_MEMORY_RATIO, RDMA)
    if not any(r in pod.requests for r in dev):
        return pod
    return replace(
        pod, requests={r: v for r, v in pod.requests.items() if r not in dev}
    )


# --------------------------------------------------------------------------
# Degraded-mode schedule(): the FULL placement pipeline on the host.
#
# ``fallback_schedule_full`` reproduces ``Engine.schedule`` over a twin
# ClusterState (StateMirror.build_twin_state replays the mirror through the
# server's own op-application path, so store content AND row layout equal
# the sidecar's).  The greedy cycle is the sequential reference semantics of
# ``core.cycle.schedule_batch`` — the scan the serving kernel
# (schedule_batch_resolved) bit-matches — re-implemented in NumPy with the
# golden per-(pod, node) oracles as the scoring core:
#
# - queue order, salted tie-break, and the carried assume-path state are
#   replayed step by step (placing a pod appends it to the column's node
#   copy; only that column re-scores);
# - ElasticQuota admission uses the golden waterfill (quota_ref) for the
#   runtime and the scan's lower-bound admit/consume walk;
# - reservation restore/nomination/consumption follow the scan's live
#   remainders; reservation plugin scores are batch-frozen like the kernel's;
# - placement-policy masks and device/NUMA extras come from the engine's
#   retained host oracles (placement_mask_host / numa_device_inputs_host);
# - gang PreFilter/Permit commit, the PreBind allocation replay (device
#   grants, demotions, gang rollback) and reserve-pod binding reuse the
#   ENGINE'S OWN host code (engine.allocation_records_host et al.), so the
#   records bit-match by construction.
# --------------------------------------------------------------------------

_NEG = -(1 << 40)  # the scan's infeasible sentinel (core.cycle inlines it)


def _explain_entry(pod, i, host, masked, feas, valid_cols, names, w,
                   S_la, S_nf, F_la, F_nf, restored_nf,
                   xs_scores, x_feas, sel_mask, rsv_in, rsv_names,
                   matched_row, gang_ok, quota_on, q_ok_pod) -> dict:
    """One pod's EXPLAIN record, built at selection time inside the scan:
    chosen node + total (the reply's), raw per-plugin components at the
    chosen column, per-stage verdicts, and a non-empty reason-code list
    for every infeasible live node.  Codes are cumulative — a node lists
    EVERY stage that closed it, not just the first."""
    infeasible: Dict[str, List[str]] = {}
    for j in valid_cols:
        if feas[j]:
            continue
        codes = []
        if not gang_ok:
            codes.append("Gang")
        if quota_on and not q_ok_pod:
            codes.append("Quota")
        if sel_mask is not None and not sel_mask[i, j]:
            codes.append("Placement")
        if x_feas is not None and not x_feas[i, j]:
            codes.append("Device")
        if not F_la[i, j]:
            codes.append("LoadAware")
        if not restored_nf.get(j, bool(F_nf[i, j])):
            codes.append("NodeFit")
        if not codes:  # unreachable by construction; fail loud over empty
            codes.append("Infeasible")
        infeasible[names[j]] = codes
    entry = {
        "pod": pod.key,
        "node": names[host] if host >= 0 else None,
        "total": int(masked[host]) if host >= 0 else 0,
        "components": {},
        "weights": {
            "loadaware": int(w.loadaware),
            "nodefit": int(w.nodefit),
            "reservation": int(w.reservation),
        },
        "stages": {
            "gang": {"gang": pod.gang, "ok": bool(gang_ok)},
            "quota": {
                "group": pod.quota,
                "ok": bool(q_ok_pod) if quota_on else True,
            },
            "reservation": {
                "matched": (
                    [rsv_names[int(v)] for v in np.flatnonzero(matched_row)]
                    if matched_row is not None
                    else []
                )
            },
        },
        "infeasible": infeasible,
    }
    if host >= 0:
        entry["components"] = {
            "loadaware": int(S_la[i, host]),
            "nodefit": int(S_nf[i, host]),
            "extra": int(xs_scores[i, host]) if xs_scores is not None else 0,
            "reservation": (
                int(rsv_in.scores[i, host]) if rsv_in is not None else 0
            ),
        }
    return entry


def _tie_base(n: int) -> int:
    # the kernel's own radix helper — imported, not copied, so a tie-break
    # change there cannot silently desynchronize the degraded path
    from koordinator_tpu_torch.core.cycle import tie_base

    return tie_base(n)


def _tie_salt(i: int, n: int) -> int:
    from koordinator_tpu_torch.core.cycle import _TIE_HASH

    return ((int(i) * _TIE_HASH) & 0xFFFFFFFF) % n


def _host_quota_runtime(state, qs, batch_req) -> Optional[np.ndarray]:
    """Engine._quota_runtime via the golden waterfill (quota_ref): shadow
    groups carry own_request = spec pod_requests + tracked used + pending
    batch, exactly like QuotaStore.request_arrays feeds the kernel."""
    import copy as _copy

    from koordinator_tpu_torch.golden.quota_ref import refresh_runtime

    if not (len(state.quota) and state.quota.cluster_total):
        return None
    resources = state.quota.resources
    own = state.quota.request_arrays(qs, batch_req)  # [Q, R]
    shadow = []
    for g in qs.groups:
        g2 = _copy.copy(g)
        row = qs.index[g.name]
        g2.pod_requests = {
            r: int(own[row][j]) for j, r in enumerate(resources) if own[row][j]
        }
        shadow.append(g2)
    runtime = refresh_runtime(shadow, dict(state.quota.cluster_total))
    Q = 1 + len(qs.groups)
    out = np.zeros((Q, len(resources)), dtype=np.int64)
    out[0] = [state.quota.cluster_total.get(r, 0) for r in resources]
    for g in qs.groups:
        row = qs.index[g.name]
        rt = runtime.get(g.name, {})
        out[row] = [rt.get(r, 0) for r in resources]
    return out


def _order_ranks_np(order: np.ndarray):
    """core.reservation.order_ranks in NumPy (same lexsort tie rule)."""
    Rv = order.shape[0]
    inf = np.int64(1) << 60
    has = order > 0
    sorted_idx = np.lexsort((np.arange(Rv), np.where(has, order, inf)))
    rank = np.zeros(Rv, dtype=np.int64)
    rank[sorted_idx] = np.arange(1, Rv + 1)
    return np.where(has, rank, 0), sorted_idx.astype(np.int32)


def fallback_schedule_full(
    state,
    pods: Sequence[Pod],
    now: float,
    assume: bool = False,
    explain: Optional[list] = None,
    run_transformers: bool = True,
):
    """The degraded-mode SCHEDULE pipeline over a twin store.

    Returns (hosts [P] row index or -1, scores [P] int64, snap,
    allocations, reservations_placed) — ``Engine.schedule``'s contract
    plus the reserve-pod bindings the reply's ``reservations_placed``
    carries.  With ``assume=True`` the placements are applied to the twin
    store (the caller absorbs them into the mirror via ``note_cycle``, so
    the level-triggered resync reconciles them on reconnect).

    ``explain`` (a list the caller owns) switches on the EXPLAIN
    decomposition: the function appends one record per pod — chosen node
    + total (bit-equal to the reply), per-plugin score components AT
    SELECTION TIME (raw loadaware/nodefit, the pre-weighted device/NUMA
    extra channel, the raw reservation score — summing to the weighted
    total), per-stage verdicts (gang PreFilter, quota admission,
    reservation matching), and a reason-code list for EVERY infeasible
    live node (Gang | Quota | Placement | Device | LoadAware | NodeFit),
    plus a ``demoted`` marker when the Permit commit or PreBind replay
    revoked a pre-committed placement.  The decomposition is computed
    inside the very scan that places — the same carried state, salts and
    tie-breaks — so healthy-path and degraded-path explanations both
    bit-match what was served.  ``run_transformers=False`` skips the
    default transformer chain for callers (``Engine.explain``) that
    already ran their own."""
    from koordinator_tpu_torch.core.cycle import (
        GangInputs,
        PluginWeights,
        ReservationInputs,
    )
    from koordinator_tpu_torch.api.model import AssignedPod
    from koordinator_tpu_torch.service import transformers as tf
    from koordinator_tpu_torch.service.engine import (
        allocation_records_host,
        check_pods_axis,
        mark_satisfied_gangs_host,
        numa_device_inputs_host,
        placement_mask_host,
        reserve_pod_specs,
    )
    from koordinator_tpu_torch.service.state import next_bucket
    from koordinator_tpu_torch.service.transformers import default_registry
    from koordinator_tpu_torch.snapshot import nodefit as nf_snap
    from koordinator_tpu_torch.golden.reservation_ref import (
        golden_reservation_scores,
        score_reservation as golden_score_reservation,
    )

    la_args = state.la_args
    nf_args = state.nf_args
    w = PluginWeights()

    if run_transformers:
        reg = default_registry()
        pods = reg.run(tf.BEFORE_PRE_FILTER, list(pods), state)
        pods = reg.run(tf.BEFORE_FILTER, pods, state)
        pods = reg.run(tf.BEFORE_SCORE, pods, state)
    else:
        pods = list(pods)
    check_pods_axis(state, pods)
    reservations_placed: Dict[str, str] = {}
    n_reserve = 0
    if assume:
        reserve_specs = reserve_pod_specs(state)
        n_reserve = len(reserve_specs)
        pods = reserve_specs + list(pods)
    snap = state.publish(now)
    P = len(pods)
    cap = snap.valid.shape[0]
    p_bucket = next_bucket(max(P, 1), 16)
    axis = state.axis
    nf_static = nf_snap.build_static([], nf_args, axis=axis)

    # ---- batch-frozen channels (extras, policy mask, constraint inputs)
    xs_scores, x_feas, admitted = numa_device_inputs_host(
        state, nf_static, pods, p_bucket, cap
    )
    sel_mask = placement_mask_host(state, pods, p_bucket, cap)

    gang_pods_arr, gang_arr, gang_names = state.gangs.build(
        pods, [p.gang for p in pods], p_bucket
    )
    gang_in = GangInputs(pods=gang_pods_arr, gangs=gang_arr)
    g_rows = np.asarray(gang_pods_arr.gang)
    gang_prefilter_ok = (
        np.asarray(gang_arr.once_satisfied)[g_rows]
        | (
            np.asarray(gang_arr.member_count)[g_rows]
            >= np.asarray(gang_arr.min_member)[g_rows]
        )
    ) & np.asarray(gang_arr.has_init)[g_rows]
    gang_mask = (g_rows == 0) | gang_prefilter_ok  # [p_bucket]
    order = np.lexsort(
        (
            np.arange(p_bucket),
            g_rows,
            np.asarray(gang_pods_arr.timestamp),
            -np.asarray(gang_pods_arr.sub_priority),
            -np.asarray(gang_pods_arr.priority),
        )
    )

    quota_on = bool(len(state.quota) and state.quota.cluster_total)
    if quota_on:
        qs = state.quota.snapshot()
        batch_req: Dict[str, np.ndarray] = {}
        for p in pods:
            if p.quota:
                vec = np.array(
                    [p.requests.get(r, 0) for r in state.quota.resources],
                    dtype=np.int64,
                )
                batch_req[p.quota] = batch_req.get(p.quota, 0) + vec
        runtime = _host_quota_runtime(state, qs, batch_req)
        q_used, q_npu = state.quota.used_arrays(qs)
        q_used, q_npu = q_used.copy(), q_npu.copy()
        q_limit = qs.used_limit(runtime)
        q_min = qs.prefilter_min()
        q_parent = qs.parent
        q_pods = state.quota.pod_arrays(
            pods, [p.quota for p in pods], p_bucket
        )

    rsv_in, rsv_names = None, []
    if len(state.reservations):
        rv_bucket = next_bucket(max(len(state.reservations), 1), 8)
        rsv_arr, rsv_names = state.reservations.build(
            state._imap.get, axis, rv_bucket
        )
        if rsv_names:
            row_of = {n: i for i, n in enumerate(rsv_names)}
            matched = np.zeros((p_bucket, rv_bucket), dtype=bool)
            for i, p in enumerate(pods):
                for rn in p.reservations:
                    jr = row_of.get(rn)
                    if jr is not None:
                        matched[i, jr] = True
            rv_alloc = np.asarray(rsv_arr.allocatable)
            rv_node = np.asarray(rsv_arr.node)
            rsv_dicts = [
                {
                    "node": int(rv_node[v]),
                    "allocatable": {
                        r: int(rv_alloc[v, jx]) for jx, r in enumerate(axis)
                    },
                    "allocated": {
                        r: int(np.asarray(rsv_arr.allocated)[v, jx])
                        for jx, r in enumerate(axis)
                    },
                    "order": int(np.asarray(rsv_arr.order)[v]),
                }
                for v in range(rv_bucket)
            ]
            rscore = np.zeros((p_bucket, rv_bucket), dtype=np.int64)
            rsv_scores = np.zeros((P, cap), dtype=np.int64)
            for i, p in enumerate(pods):
                pod_req = {r: p.requests.get(r, 0) for r in axis}
                for v in range(rv_bucket):
                    rscore[i, v] = golden_score_reservation(
                        pod_req,
                        rsv_dicts[v]["allocatable"],
                        rsv_dicts[v]["allocated"],
                    )
                rsv_scores[i] = golden_reservation_scores(
                    pod_req, list(matched[i]), rsv_dicts, cap
                )
            rsv_in = ReservationInputs(
                rsv=rsv_arr, matched=matched, rscore=rscore, scores=rsv_scores
            )
            rsv_rank, rsv_sorted_idx = _order_ranks_np(
                np.asarray(rsv_arr.order)
            )
            rsv_allocated = np.asarray(rsv_arr.allocated).copy()

    # ---- golden base matrices over the live columns -----------------------
    import copy as _copy

    base_pods = [_strip_device_requests(p) for p in pods]
    has_any = [
        any(v > 0 for r, v in p.requests.items() if r != "pods") for p in pods
    ]
    nf_req = np.zeros((P, len(axis)), dtype=np.int64)
    for i, p in enumerate(pods):
        nf_req[i] = [p.requests.get(r, 0) for r in axis]
    valid_cols = [j for j in range(cap) if snap.valid[j]]
    col_node: Dict[int, object] = {}
    for j in valid_cols:
        node = state._nodes[snap.names[j]]
        sim = _copy.copy(node)
        sim.assigned_pods = list(node.assigned_pods)
        col_node[j] = sim
    S = np.full((P, cap), 0, dtype=np.int64)
    F = np.zeros((P, cap), dtype=bool)
    ex = explain is not None
    if ex:
        # raw per-plugin components + per-stage filter verdicts, kept in
        # lockstep with S/F by the very same re-score calls (the carried
        # assume-path column updates land here too)
        S_la = np.zeros((P, cap), dtype=np.int64)
        S_nf = np.zeros((P, cap), dtype=np.int64)
        F_la = np.zeros((P, cap), dtype=bool)
        F_nf = np.zeros((P, cap), dtype=bool)
        ex_entries: List[Optional[dict]] = [None] * P

    def _score_cell(i: int, j: int):
        node = col_node[j]
        sla = golden_score(base_pods[i], node, la_args, now)
        snf = golden_fit_score(base_pods[i], node, nf_args)
        s = sla * w.loadaware + snf * w.nodefit
        ok_la = golden_filter(base_pods[i], node, la_args, now)
        # short-circuit preserved on the serving path; the explain path
        # needs the nodefit verdict even where loadaware already failed
        ok_nf = (
            golden_fit_filter(
                base_pods[i], node, nf_args, has_any_request=has_any[i]
            )
            if (ok_la or ex)
            else False
        )
        if ex:
            S_la[i, j], S_nf[i, j] = sla, snf
            F_la[i, j], F_nf[i, j] = ok_la, ok_nf
        return s, ok_la and ok_nf

    for j in valid_cols:
        for i in range(P):
            S[i, j], F[i, j] = _score_cell(i, j)

    TB = _tie_base(cap)
    cols_idx = np.arange(cap, dtype=np.int64)
    hosts = np.full(p_bucket, -1, dtype=np.int32)
    scores = np.zeros(p_bucket, dtype=np.int64)
    committed = np.zeros(P, dtype=bool)

    # ---- the sequential cycle (schedule_batch scan semantics) -------------
    for i in map(int, order):
        if i >= P:
            continue  # padded queue rows are infeasible by construction
        committed[i] = True
        total = S[i].copy()
        feas = F[i].copy()
        restored_nf: Dict[int, bool] = {}
        if rsv_in is not None and matched[i].any():
            # restore against the LIVE remaining reservation capacity:
            # re-run the fit filter with the per-node extra allowance on
            # the columns carrying matched reservations
            remain = np.asarray(rsv_in.rsv.allocatable) - rsv_allocated
            for jn in {int(rv_node[v]) for v in np.flatnonzero(matched[i])}:
                if jn not in col_node:
                    continue
                on_node = matched[i] & (rv_node == jn)
                extra_vec = np.sum(np.where(on_node[:, None], remain, 0), axis=0)
                extra = {r: int(extra_vec[jx]) for jx, r in enumerate(axis)}
                nf_ok = golden_fit_filter(
                    base_pods[i], col_node[jn], nf_args,
                    extra_free=extra, has_any_request=has_any[i],
                )
                feas[jn] = (
                    golden_filter(base_pods[i], col_node[jn], la_args, now)
                    and nf_ok
                )
                if ex:
                    restored_nf[jn] = nf_ok
        if rsv_in is not None:
            total = total + rsv_in.scores[i] * w.reservation
        if xs_scores is not None:
            total = total + xs_scores[i, :cap]
        feas &= snap.valid
        if x_feas is not None:
            feas &= x_feas[i, :cap]
        if sel_mask is not None:
            feas &= sel_mask[i, :cap]
        if not gang_mask[i]:
            feas &= False
        q_ok_pod = True
        if quota_on:
            gq = int(q_pods.quota[i])
            req = q_pods.req[i]
            present = q_pods.present[i]
            ok = bool(np.all(~present | (q_used[gq] + req <= q_limit[gq])))
            np_ok = bool(np.all(~present | (q_npu[gq] + req <= q_min[gq])))
            if not (ok and (np_ok or not q_pods.non_preemptible[i])):
                q_ok_pod = False
                feas &= False
        any_ok = bool(feas.any())
        masked = np.where(feas, total, np.int64(_NEG))
        salt = _tie_salt(i, cap)
        rot = (cols_idx + salt) % cap
        keys = masked * TB + (TB - 1 - rot)
        host = int(np.argmax(keys))
        if ex:
            ex_entries[i] = _explain_entry(
                pods[i], i, host if any_ok else -1, masked, feas,
                valid_cols, snap.names, w,
                S_la, S_nf, F_la, F_nf, restored_nf,
                xs_scores, x_feas, sel_mask, rsv_in,
                rsv_names if rsv_in is not None else [],
                matched[i] if rsv_in is not None else None,
                bool(gang_mask[i]), quota_on, q_ok_pod,
            )
        if not any_ok:
            continue
        hosts[i] = host
        scores[i] = int(masked[host])
        # assume-path carried state: the placed pod occupies its column
        col_node[host].assigned_pods.append(
            AssignedPod(pod=base_pods[i], assign_time=now)
        )
        # only the touched COLUMN re-scores, and only for queue rows still
        # pending — committed rows are never re-read (matrix-engine rule)
        for p2 in range(P):
            if not committed[p2]:
                S[p2, host], F[p2, host] = _score_cell(p2, host)
        if quota_on:
            gq = int(q_pods.quota[i])
            req = np.where(q_pods.present[i], q_pods.req[i], 0)
            npu_req = req if q_pods.non_preemptible[i] else np.zeros_like(req)
            grp = gq
            for _ in range(8):  # ancestor_depth
                if grp != 0:
                    q_used[grp] += req
                    q_npu[grp] += npu_req
                grp = int(q_parent[grp])
        if rsv_in is not None:
            cand = matched[i] & (rv_node == host)
            if cand.any():
                Rv = rv_node.shape[0]
                key = np.where(
                    cand & (rsv_rank > 0), rsv_rank, np.int64(Rv + 1)
                )
                mn = int(key.min())
                if mn <= Rv:
                    nom = int(rsv_sorted_idx[mn - 1])
                else:
                    nom = int(np.argmax(np.where(cand, rscore[i], -1)))
                remain = np.asarray(rsv_in.rsv.allocatable)[nom] - rsv_allocated[nom]
                consume = np.maximum(np.minimum(nf_req[i], remain), 0)
                rsv_allocated[nom] += consume

    # ---- gang Permit commit (commit_gangs semantics) ----------------------
    G = np.asarray(gang_arr.min_member).shape[0]
    placed_per_gang = np.zeros(G, dtype=np.int64)
    np.add.at(placed_per_gang, g_rows[hosts >= 0], 1)
    bound = (
        np.asarray(gang_arr.bound_count)
        if gang_arr.bound_count is not None
        else np.zeros(G, dtype=np.int64)
    )
    satisfied = (
        placed_per_gang + bound >= np.asarray(gang_arr.min_member)
    ) | np.asarray(gang_arr.once_satisfied)
    if gang_arr.group is not None:
        grp_arr = np.asarray(gang_arr.group)
        bad_in_group = np.zeros(G, dtype=np.int64)
        np.add.at(bad_in_group, grp_arr, (~satisfied).astype(np.int64))
        gang_ok = (bad_in_group == 0)[grp_arr]
    else:
        gang_ok = satisfied
    non_strict = (
        np.asarray(gang_arr.non_strict)
        if gang_arr.non_strict is not None
        else np.zeros(G, dtype=bool)
    )
    keep = (g_rows == 0) | (gang_ok | non_strict)[g_rows]
    precommit = hosts[:P].copy()
    hosts = np.where(keep, hosts, -1)[:P].astype(np.int32)
    scores = np.where(hosts >= 0, scores[:P], 0)
    if ex:
        permit_hosts = hosts.copy()

    # ---- PreBind replay + assume-side commits (engine's own host code) ----
    allocations = allocation_records_host(
        state, pods, hosts, precommit, gang_in, rsv_in, rsv_names,
        snap.names, now, assume, admitted,
    )
    scores = np.where(hosts >= 0, scores, 0)
    if ex:
        # the scan's entries record the SELECTION; the Permit commit and
        # the PreBind replay can still revoke it — reflect the reply
        for i2 in range(P):
            e = ex_entries[i2]
            if e is None:
                continue
            if precommit[i2] >= 0 and permit_hosts[i2] < 0:
                e["demoted"] = "GangPermit"
            elif permit_hosts[i2] >= 0 and hosts[i2] < 0:
                e["demoted"] = "Reserve"
            if hosts[i2] < 0:
                e["node"], e["total"], e["components"] = None, 0, {}
    if assume and gang_names:
        mark_satisfied_gangs_host(state, pods, hosts, gang_in, gang_names)
    if n_reserve:
        for i in range(n_reserve):
            name = pods[i].name[len("reserve-"):]
            if hosts[i] >= 0:
                node_name = snap.names[hosts[i]]
                state.reservations.bind(name, node_name)
                reservations_placed[name] = node_name
            else:
                info = state.reservations.get(name)
                if info is not None:
                    info.unschedulable_count += 1
                    info.last_error = "reserve pod unschedulable"
        hosts = hosts[n_reserve:]
        scores = scores[n_reserve:]
        allocations = allocations[n_reserve:]
    if ex:
        explain.extend(e for e in ex_entries[n_reserve:] if e is not None)
    return hosts, scores, snap, allocations, reservations_placed
