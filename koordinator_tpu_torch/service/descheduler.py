"""The descheduler's shared predicates, as far as the port needs them.

Only ``tolerates`` is carried so far, copied from the JAX package's
service/descheduler.py: the placement mask's taint check uses it.  The
module keeps its name so the descheduler's port lands beside it.
"""

from __future__ import annotations

from typing import Dict


def tolerates(pod, taint: Dict[str, str]) -> bool:
    """corev1 Toleration.ToleratesTaint: the effect check applies FIRST
    to every toleration (empty toleration effect matches all); then an
    empty key with Exists matches any taint, Exists matches on key, Equal
    needs key+value."""
    for tol in pod.tolerations:
        eff = tol.get("effect", "")
        if eff != "" and eff != taint.get("effect"):
            continue
        op = tol.get("operator", "Equal")
        if tol.get("key", "") == "":
            if op == "Exists":
                return True
            continue
        if tol.get("key") != taint.get("key"):
            continue
        if op == "Exists" or tol.get("value") == taint.get("value"):
            return True
    return False
