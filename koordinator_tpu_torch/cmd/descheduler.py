"""koord-descheduler entry point: ``python -m koordinator_tpu_torch.cmd.descheduler``.

The counterpart of cmd/koord-descheduler (descheduler.go:246-259): a timed
loop firing DESCHEDULE ticks at the scoring sidecar over the KTPU wire —
the LowNodeLoad balance + migration plan runs server-side against the live
cluster state (``python -m koordinator_tpu_torch.cmd.sidecar``, on the card
unless it was started with ``--device cpu``).  SIGTERM or SIGINT ends the
loop after the tick in flight.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="koord-tpu-descheduler", description=__doc__)
    ap.add_argument("--sidecar", required=True, help="host:port of the scoring sidecar")
    ap.add_argument("--interval", type=float, default=120.0,
                    help="deschedulingInterval seconds")
    ap.add_argument("--execute", action="store_true",
                    help="apply the migration plan (default: dry-run/log)")
    ap.add_argument("--max-total", type=int, default=None,
                    help="total eviction limit per tick")
    ap.add_argument("--evictor-json", default=None,
                    help="defaultevictor/arbitrator config as inline JSON or "
                         "@file (keys: system_critical, local_storage, "
                         "failed_bare, ignore_pvc, priority_threshold, "
                         "label_selector, max_per_node, max_per_namespace, "
                         "max_per_workload, max_unavailable, "
                         "skip_replicas_check, limiter_duration, "
                         "limiter_max_migrating)")
    ap.add_argument("--workloads-json", default=None,
                    help="controllerfinder feed as inline JSON or @file: "
                         "{owner_uid: expectedReplicas}.  Without it, owned "
                         "pods fail the workload filters (the arbitrator "
                         "treats an unresolvable owner as non-migratable)")
    args = ap.parse_args(argv)

    def load_json(arg):
        if arg is None:
            return None
        import json

        if arg.startswith("@"):
            with open(arg[1:]) as f:
                return json.load(f)
        return json.loads(arg)

    from koordinator_tpu_torch.service.client import Client

    host, port = args.sidecar.rsplit(":", 1)
    cli = Client(host, int(port))
    print(f"koord-tpu-descheduler ticking every {args.interval}s", flush=True)
    evictor = load_json(args.evictor_json)
    workloads = load_json(args.workloads_json)
    if workloads is None:
        print(
            "warning: no --workloads-json; owned pods are non-migratable "
            "until a controllerfinder feed arrives",
            flush=True,
        )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    limits = {"total": args.max_total} if args.max_total is not None else None
    try:
        first = True
        while not stop.is_set():
            plan, executed = cli.deschedule(
                now=time.time(),
                limits=limits,
                execute=args.execute,
                # config rides the first tick only; the server keeps it
                evictor=evictor if first else None,
                workloads=workloads if first else None,
            )
            first = False
            print(f"deschedule tick: plan={len(plan)} executed={executed}", flush=True)
            stop.wait(args.interval)
    finally:
        cli.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
