"""Pure-Python oracle for the reservation scoring path (scoring.go 42-203,
nominator.go 134-190): per (pod, node) nominate the matched reservation with
the smallest positive order label, else the highest scoreReservation; the
globally smallest-order reservation's node scores mostPreferredScore=1000;
then DefaultNormalizeScore(100) over nodes."""

from __future__ import annotations

from typing import Dict, List, Optional

MOST_PREFERRED = 1000


def score_reservation(pod_req: Dict[str, int], allocatable: Dict[str, int], allocated: Dict[str, int]) -> int:
    resources = {r: c for r, c in allocatable.items() if c != 0}
    w = len(resources)
    if w <= 0:
        return 0
    s = 0
    for r, cap in resources.items():
        req = pod_req.get(r, 0) + allocated.get(r, 0)
        if req <= cap:
            s += 100 * req // cap
    return s // w


def golden_reservation_scores(
    pod_req: Dict[str, int],
    matched: List[bool],
    reservations: List[dict],  # {node:int, allocatable:{}, allocated:{}, order:int}
    num_nodes: int,
) -> List[int]:
    rscores = [
        score_reservation(pod_req, rv["allocatable"], rv["allocated"])
        for rv in reservations
    ]
    scores = [0] * num_nodes
    # per-node nomination
    for n in range(num_nodes):
        on_node = [i for i, rv in enumerate(reservations) if rv["node"] == n and matched[i]]
        if not on_node:
            continue
        ordered = [i for i in on_node if reservations[i]["order"] > 0]
        if ordered:
            best = min(ordered, key=lambda i: (reservations[i]["order"], i))
            scores[n] = rscores[best]
        else:
            scores[n] = max(rscores[i] for i in on_node)
    # globally most-preferred node
    all_ordered = [i for i, rv in enumerate(reservations) if matched[i] and rv["order"] > 0]
    if all_ordered:
        best = min(all_ordered, key=lambda i: (reservations[i]["order"], i))
        scores[reservations[best]["node"]] = MOST_PREFERRED
    # DefaultNormalizeScore(100, false)
    mx = max(scores) if scores else 0
    if mx == 0:
        return scores
    return [s * 100 // mx for s in scores]
