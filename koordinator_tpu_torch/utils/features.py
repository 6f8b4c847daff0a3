"""Feature gates (pkg/features: features.go, koordlet_features.go,
scheduler_features.go — the per-binary k8s-style gate registry).

Gates default per the reference's defaultFeatureGates tables; components
consult ``enabled`` at setup (the qosmanager strategies, the preemption
PostFilter, the revoke controller, the descheduler pools) and ops override
them via ``set_gates`` — the `--feature-gates=A=true,B=false` flag
semantics, including rejection of unknown gates.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

# the reference's gate names this rebuild implements (koordlet_features.go:33-143,
# scheduler features); defaults mirror the Go tables
_DEFAULTS: Dict[str, bool] = {
    # koordlet
    "BECPUSuppress": True,
    "BECPUEvict": False,
    "BEMemoryEvict": False,
    "CPUBurst": False,
    "CgroupReconcile": False,
    "RdtResctrl": True,
    "BlkIOReconcile": False,
    "NodeMetricProducer": True,
    "PeakPrediction": True,
    # metricsadvisor collectors (koordlet_features.go:33-143)
    "CPICollector": False,
    "PSICollector": False,
    "ColdPageCollector": False,
    # scheduler
    "ElasticQuotaPreemption": True,
    "QuotaOverUseRevoke": False,
    "Coscheduling": True,
    "Reservation": True,
    "LoadAware": True,
    "NodeNUMAResource": True,
    # descheduler / manager
    "LowNodeLoad": True,
    "MigrationReservationFirst": True,
    "BatchResourceOvercommit": True,
    "MidResourceOvercommit": False,
    "ColocationProfileMutation": True,
}


class FeatureGates:
    def __init__(self, overrides: Optional[Dict[str, bool]] = None):
        self._gates = dict(_DEFAULTS)
        if overrides:
            self.set_gates(overrides)

    def enabled(self, name: str) -> bool:
        if name not in self._gates:
            raise KeyError(f"unknown feature gate {name!r}")
        return self._gates[name]

    def set_gates(self, overrides: Dict[str, bool]) -> None:
        """--feature-gates flag semantics: unknown names are errors."""
        unknown = [k for k in overrides if k not in self._gates]
        if unknown:
            raise KeyError(f"unknown feature gates: {sorted(unknown)}")
        self._gates.update(overrides)

    @classmethod
    def parse(cls, spec: str) -> "FeatureGates":
        """Parse 'A=true,B=false' (the component flag format)."""
        overrides = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            name, _, value = part.partition("=")
            if value.lower() not in ("true", "false"):
                raise ValueError(f"feature gate {part!r}: value must be true|false")
            overrides[name] = value.lower() == "true"
        return cls(overrides)

    def known(self) -> Iterable[str]:
        return sorted(self._gates)


DEFAULT_GATES = FeatureGates()
