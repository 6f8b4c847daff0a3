"""Versioned scheduler configuration: load -> convert -> default -> validate.

The reference carries its plugin args as versioned external types with
conversion and validation (pkg/scheduler/apis/config/{types.go, v1beta2/,
validation/validation_pluginargs.go}); a KubeSchedulerConfiguration
profile's ``pluginConfig`` entries deserialize into the external version,
get defaulted (v1beta2/defaults.go), convert to the internal type, and
are validated before the scheduler starts — bad args fail startup with
field-path errors.

This module is that machinery for the sidecar's config surface:

- ``load_scheduler_config(doc)`` takes the parsed YAML/JSON document
  (apiVersion ``kubescheduler.config.koordinator.sh/v1beta2``), walks the
  pluginConfig entries, converts each known plugin's camelCase external
  fields onto the internal dataclasses (core/config.py), applies the
  reference defaults for absent fields (the dataclass defaults ARE the
  v1beta2 defaults), validates, and returns a ``SchedulerConfig``;
- unknown apiVersion / kind / plugin names / fields are errors, not
  warnings — a typo'd knob must not silently run on defaults;
- validation messages restate validation_pluginargs.go phrasing so a
  reference operator reads familiar errors.

Consumed by ``cmd/sidecar --config`` (startup fails on invalid config,
like the reference binary) and by HELLO-time reporting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.model import AggregationType
from koordinator_tpu_torch.core.config import (
    AggregatedArgs,
    LoadAwareArgs,
    NodeFitArgs,
    ScoringStrategyType,
)

API_VERSION = "kubescheduler.config.koordinator.sh/v1beta2"
KIND = "KoordSchedulerConfiguration"

PLUGIN_LOADAWARE = "LoadAwareScheduling"
PLUGIN_NODEFIT = "NodeResourcesFit"
PLUGIN_COSCHEDULING = "Coscheduling"
PLUGIN_ELASTICQUOTA = "ElasticQuota"


class ConfigError(ValueError):
    """A field-path validation error (field.Invalid equivalent)."""


@dataclasses.dataclass
class CoschedulingArgs:
    """CoschedulingArgs (types.go:197): the gang wait default."""

    default_timeout_seconds: float = 600.0
    controller_workers: int = 1


@dataclasses.dataclass
class ElasticQuotaConfigArgs:
    """The ElasticQuotaArgs slice the sidecar consumes (types.go:166):
    revoke cadence + defaults for unbounded groups."""

    delay_evict_time_seconds: float = 300.0
    revoke_pod_interval_seconds: float = 60.0
    default_quota_group_max: Dict[str, int] = dataclasses.field(default_factory=dict)
    system_quota_group_max: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    loadaware: LoadAwareArgs = dataclasses.field(default_factory=LoadAwareArgs)
    nodefit: NodeFitArgs = dataclasses.field(default_factory=NodeFitArgs)
    coscheduling: CoschedulingArgs = dataclasses.field(default_factory=CoschedulingArgs)
    elasticquota: ElasticQuotaConfigArgs = dataclasses.field(
        default_factory=ElasticQuotaConfigArgs
    )


# ------------------------------------------------------------- conversion


def _take(d: dict, known: Dict[str, str], path: str) -> dict:
    """Map external camelCase keys to internal names; unknown keys are
    config errors (strict decoding — a typo must fail startup).  A JSON
    null means "field unset" (v1beta2 pointer semantics) — the default
    applies, so nulls are dropped here."""
    out = {}
    for k, v in d.items():
        if k not in known:
            raise ConfigError(f"{path}: unknown field {k!r}")
        if v is None:
            continue
        out[known[k]] = v
    return out


def _convert_loadaware(args: dict) -> LoadAwareArgs:
    path = f"pluginConfig[{PLUGIN_LOADAWARE}].args"
    agg = args.pop("aggregated", None)
    kw = _take(
        args,
        {
            "filterExpiredNodeMetrics": "filter_expired_node_metrics",
            "nodeMetricExpirationSeconds": "node_metric_expiration_seconds",
            "resourceWeights": "resource_weights",
            "usageThresholds": "usage_thresholds",
            "prodUsageThresholds": "prod_usage_thresholds",
            "scoreAccordingProdUsage": "score_according_prod_usage",
            "estimatedScalingFactors": "estimated_scaling_factors",
        },
        path,
    )
    la = LoadAwareArgs()
    for k, v in kw.items():
        if k.endswith(("_weights", "_thresholds", "_factors")) and v is not None:
            v = {str(r): int(x) for r, x in v.items()}
        setattr(la, k, v)
    if agg is not None:
        akw = _take(
            agg,
            {
                "usageThresholds": "usage_thresholds",
                "usageAggregationType": "usage_aggregation_type",
                "usageAggregatedDuration": "usage_aggregated_duration",
                "scoreAggregationType": "score_aggregation_type",
                "scoreAggregatedDuration": "score_aggregated_duration",
            },
            path + ".aggregated",
        )
        for key in ("usage_aggregation_type", "score_aggregation_type"):
            if akw.get(key) is not None:
                try:
                    akw[key] = AggregationType(akw[key])
                except ValueError:
                    raise ConfigError(
                        f"{path}.aggregated: unsupported aggregation type "
                        f"{akw[key]!r}"
                    ) from None
        la.aggregated = AggregatedArgs(**akw)
    return la


def _convert_nodefit(args: dict) -> NodeFitArgs:
    path = f"pluginConfig[{PLUGIN_NODEFIT}].args"
    kw = _take(
        args,
        {
            "scoringStrategy": "scoring",
            "ignoredResources": "ignored_resources",
            "ignoredResourceGroups": "ignored_resource_groups",
        },
        path,
    )
    nf = NodeFitArgs()
    if "ignored_resources" in kw:
        nf.ignored_resources = [str(r) for r in kw["ignored_resources"]]
    if "ignored_resource_groups" in kw:
        nf.ignored_resource_groups = [str(r) for r in kw["ignored_resource_groups"]]
    scoring = kw.get("scoring")
    if scoring:
        skw = _take(
            scoring,
            {
                "type": "type",
                "resources": "resources",
                "requestedToCapacityRatio": "shape",
            },
            path + ".scoringStrategy",
        )
        if "type" in skw:
            try:
                nf.strategy = ScoringStrategyType(skw["type"])
            except ValueError:
                raise ConfigError(
                    f"{path}.scoringStrategy.type: unknown strategy "
                    f"{skw['type']!r}"
                ) from None
        if "resources" in skw:
            nf.resources = [
                (str(r.get("name")), int(r.get("weight", 1)))
                for r in skw["resources"]
            ]
        if "shape" in skw:
            shape = skw["shape"].get("shape", [])
            nf.shape = [
                (int(pt["utilization"]), int(pt["score"])) for pt in shape
            ]
    return nf


def _convert_coscheduling(args: dict) -> CoschedulingArgs:
    path = f"pluginConfig[{PLUGIN_COSCHEDULING}].args"
    kw = _take(
        args,
        {
            "defaultTimeoutSeconds": "default_timeout_seconds",
            "controllerWorkers": "controller_workers",
        },
        path,
    )
    return CoschedulingArgs(**kw)


def _convert_elasticquota(args: dict) -> ElasticQuotaConfigArgs:
    path = f"pluginConfig[{PLUGIN_ELASTICQUOTA}].args"
    kw = _take(
        args,
        {
            "delayEvictTime": "delay_evict_time_seconds",
            "revokePodInterval": "revoke_pod_interval_seconds",
            "defaultQuotaGroupMax": "default_quota_group_max",
            "systemQuotaGroupMax": "system_quota_group_max",
        },
        path,
    )
    for key in ("default_quota_group_max", "system_quota_group_max"):
        if key in kw:
            kw[key] = {str(r): int(v) for r, v in kw[key].items()}
    return ElasticQuotaConfigArgs(**kw)


_CONVERTERS = {
    PLUGIN_LOADAWARE: ("loadaware", _convert_loadaware),
    PLUGIN_NODEFIT: ("nodefit", _convert_nodefit),
    PLUGIN_COSCHEDULING: ("coscheduling", _convert_coscheduling),
    PLUGIN_ELASTICQUOTA: ("elasticquota", _convert_elasticquota),
}


# ------------------------------------------------------------- validation


def validate_loadaware_args(args: LoadAwareArgs) -> None:
    """ValidateLoadAwareSchedulingArgs (validation_pluginargs.go:31-59)."""
    if (
        args.node_metric_expiration_seconds is not None
        and args.node_metric_expiration_seconds <= 0
    ):
        raise ConfigError(
            "nodeMetricExpiredSeconds: "
            f"{args.node_metric_expiration_seconds}: "
            "nodeMetricExpiredSeconds should be a positive value"
        )
    for name, weight in args.resource_weights.items():
        if weight <= 0:
            raise ConfigError(
                f"resourceWeights: resource Weight of {name} should be a "
                f"positive value, got {weight}"
            )
        if weight > 100:
            raise ConfigError(
                f"resourceWeights: resource Weight of {name} should be "
                f"less than 100, got {weight}"
            )
    for field_name, thresholds, strict in (
        ("usageThresholds", args.usage_thresholds, False),
        ("prodUsageThresholds", args.prod_usage_thresholds, False),
        ("estimatedScalingFactors", args.estimated_scaling_factors, True),
    ):
        for name, pct in thresholds.items():
            if pct < 0 or (strict and pct <= 0):
                raise ConfigError(
                    f"{field_name}: resource Threshold of {name} should be "
                    f"a positive value, got {pct}"
                )
            if pct > 100:
                raise ConfigError(
                    f"{field_name}: resource Threshold of {name} should be "
                    f"less than 100, got {pct}"
                )
    if args.aggregated is not None:
        for name, pct in args.aggregated.usage_thresholds.items():
            if pct < 0 or pct > 100:
                raise ConfigError(
                    f"aggregated.usageThresholds: resource Threshold of "
                    f"{name} not in valid range [0, 100], got {pct}"
                )
    for name in args.resource_weights:
        if name not in args.estimated_scaling_factors:
            raise ConfigError(f"estimatedScalingFactors: {name} not found")


def validate_nodefit_args(args: NodeFitArgs) -> None:
    """validateResources (validation_pluginargs.go:140-149) + shape
    monotonicity (k8s requested-to-capacity-ratio validation)."""
    for i, (name, weight) in enumerate(args.resources):
        if weight <= 0 or weight > 100:
            raise ConfigError(
                f"scoringStrategy.resources[{i}].weight: {weight}: resource "
                f"weight of {name} not in valid range (0, 100]"
            )
    shape = getattr(args, "shape", None) or []
    for i in range(1, len(shape)):
        if shape[i][0] <= shape[i - 1][0]:
            raise ConfigError(
                "scoringStrategy.requestedToCapacityRatio.shape: "
                "utilization values must be sorted in increasing order"
            )
    for i, (util, score) in enumerate(shape):
        if not 0 <= util <= 100:
            raise ConfigError(
                f"shape[{i}].utilization: {util}: not in valid range [0, 100]"
            )
        if not 0 <= score <= 10:
            raise ConfigError(
                f"shape[{i}].score: {score}: not in valid range [0, 10]"
            )


def validate_coscheduling_args(args: CoschedulingArgs) -> None:
    """ValidateCoschedulingArgs (validation_pluginargs.go:128-136)."""
    if args.default_timeout_seconds < 0:
        raise ConfigError("coeSchedulingArgs DefaultTimeoutSeconds invalid")
    if args.controller_workers < 1:
        raise ConfigError("coeSchedulingArgs ControllerWorkers invalid")


def validate_elasticquota_args(args: ElasticQuotaConfigArgs) -> None:
    """ValidateElasticQuotaArgs (validation_pluginargs.go:99-123)."""
    for res, v in args.default_quota_group_max.items():
        if v < 0:
            raise ConfigError(
                "elasticQuotaArgs error, defaultQuotaGroupMax should be a "
                f"positive value, resourceName:{res}, got {v}"
            )
    for res, v in args.system_quota_group_max.items():
        if v < 0:
            raise ConfigError(
                "elasticQuotaArgs error, systemQuotaGroupMax should be a "
                f"positive value, resourceName:{res}, got {v}"
            )
    if args.delay_evict_time_seconds < 0:
        raise ConfigError(
            "elasticQuotaArgs error, DelayEvictTime should be a positive value"
        )
    if args.revoke_pod_interval_seconds < 0:
        raise ConfigError(
            "elasticQuotaArgs error, RevokePodCycle should be a positive value"
        )


_VALIDATORS = {
    "loadaware": validate_loadaware_args,
    "nodefit": validate_nodefit_args,
    "coscheduling": validate_coscheduling_args,
    "elasticquota": validate_elasticquota_args,
}


# ------------------------------------------------------------------ load


def load_scheduler_config(doc: dict) -> SchedulerConfig:
    """External document -> defaulted + validated internal config."""
    api = doc.get("apiVersion")
    if api != API_VERSION:
        raise ConfigError(
            f"apiVersion: {api!r}: no kind {KIND!r} is registered for "
            f"version {api!r} (supported: {API_VERSION})"
        )
    kind = doc.get("kind", KIND)
    if kind != KIND:
        raise ConfigError(f"kind: {kind!r}: expected {KIND!r}")
    cfg = SchedulerConfig()
    for i, entry in enumerate(doc.get("pluginConfig", [])):
        name = entry.get("name")
        if name not in _CONVERTERS:
            raise ConfigError(
                f"pluginConfig[{i}].name: {name!r}: unknown plugin "
                f"(known: {sorted(_CONVERTERS)})"
            )
        field_name, convert = _CONVERTERS[name]
        setattr(cfg, field_name, convert(dict(entry.get("args") or {})))
    for field_name, validate in _VALIDATORS.items():
        validate(getattr(cfg, field_name))
    return cfg
