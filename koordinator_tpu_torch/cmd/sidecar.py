"""The scoring sidecar's binary: ``python -m koordinator_tpu_torch.cmd.sidecar``.

Starts the KTPU sidecar (``service.server.SidecarServer``) the Go shim
dials, on the card unless ``--device cpu`` is given.  It takes the JAX
binary's flags for what the port serves, prints the same ``listening on``
banner, and drains on SIGTERM: new requests are refused retryably, queued
work completes, and the process exits 0.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="koord-tpu-sidecar", description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7420)
    ap.add_argument("--capacity", type=int, default=256,
                    help="initial node-row capacity (grows by doubling)")
    ap.add_argument("--warm", action="store_true",
                    help="build the CUDA kernels before serving")
    ap.add_argument("--extra-scalars", default="",
                    help="comma-separated extra scalar resources on the filter axis")
    ap.add_argument("--feature-gates", default="",
                    help="k8s-style gate overrides, e.g. A=true,B=false")
    ap.add_argument("--config", default=None,
                    help="versioned KoordSchedulerConfiguration JSON file "
                         "(pluginConfig args, validated before serving)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on: cuda (default) or cpu")
    ap.add_argument("--shards", type=int, default=1,
                    help="serve SCORE/SCHEDULE through the node-axis ShardedEngine with "
                         "this many contiguous capacity-axis blocks (power of two; 1 = the "
                         "plain engine); equal to the unsharded engine by construction, "
                         "advertised as 'shards' in HELLO")
    ap.add_argument("--shard-map", action="store_true",
                    help="with --shards N: one shard_score_map launch per card of an "
                         "N-card mesh instead of per-shard slice launches (needs >= N cards)")
    args = ap.parse_args(argv)

    from koordinator_tpu_torch.service.server import SidecarServer
    from koordinator_tpu_torch.utils.features import FeatureGates

    cfg = None
    la_args = nf_args = None
    if args.config:
        import json

        from koordinator_tpu_torch.core.configio import ConfigError, load_scheduler_config

        try:
            with open(args.config) as f:
                cfg = load_scheduler_config(json.load(f))
        except (ConfigError, OSError, ValueError) as e:
            # the reference binary fails startup on invalid config
            print(f"invalid --config: {e}", file=sys.stderr, flush=True)
            return 1
        la_args, nf_args = cfg.loadaware, cfg.nodefit
    gates = FeatureGates.parse(args.feature_gates) if args.feature_gates else FeatureGates()
    extra = tuple(s for s in args.extra_scalars.split(",") if s)
    if args.warm and args.device.startswith("cuda"):
        from koordinator_tpu_torch import cuda

        cuda.build()
    srv = SidecarServer(
        host=args.host, port=args.port, la_args=la_args, nf_args=nf_args,
        extra_scalars=extra, initial_capacity=args.capacity, sched_cfg=cfg, gates=gates,
        device=args.device, shards=args.shards, shard_map=args.shard_map,
    )
    print(f"koord-tpu-sidecar listening on {srv.address[0]}:{srv.address[1]}", flush=True)

    stop = threading.Event()
    graceful = threading.Event()

    def on_sigterm(*_a):
        graceful.set()
        stop.set()

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, lambda *a: stop.set())  # abrupt: ^C
    try:
        stop.wait()
    finally:
        if graceful.is_set():
            drained = srv.shutdown_graceful()
            print("koord-tpu-sidecar drained" if drained
                  else "koord-tpu-sidecar drain timed out", flush=True)
        else:
            srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
