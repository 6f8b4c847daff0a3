"""What the port does not carry yet, and which slice brings it.

The names follow the slice order of ROADMAP.md.  Every input outside what
the port serves raises ``NotImplementedError`` through ``later``, never a
silently different answer; the sidecar answers it with a ``BAD_REQUEST``
ERROR frame that carries the same message.
"""

# the serving pipeline: depth-2 SCHEDULE deferral and APPLY group commit
PIPELINE = "the serving-pipeline slice"
# the journal, replication, fencing and the fleet verbs
DURABILITY = "the durability slice"
# tenants (the tenant trailer) and QoS admission (the QoS trailer)
TENANCY = "the tenancy-and-admission slice"
# metrics, tracing, the HTTP debug surface, HEALTH, METRICS, TRACE, DEBUG,
# DIGEST and SCORE's debug_scores
OBSERVABILITY = "the observability slice"
# SCHEDULE's preempt and the REVOKE verb
PREEMPTION = "the preemption slice"
# the RECONCILE verb
MANAGER = "the manager slice"
# the HOOK verb
RUNTIME = "the runtime-hooks slice"
# the koordlet agent around the metric pipeline: metricsadvisor, the
# daemon, koordlet_metrics and cmd/koordlet (they need qosmanager,
# runtimehooks and the observability registry)
KOORDLET = "the koordlet-agent slice"


def later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} arrives with {slice_name} of the port (ROADMAP.md)"
    )
