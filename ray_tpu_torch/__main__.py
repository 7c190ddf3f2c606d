"""CLI: python -m ray_tpu_torch <command> (reference: ray scripts/scripts.py:99).

Cluster daemons (``start --head`` / ``start --address``), cluster status,
job submission against a live cluster (dashboard/modules/job/ analog), and
the in-process conveniences (local job run, bench).

Port of ``ray_tpu/__main__.py``, copied with its imports rewritten.
``bench`` raises: ``bench.py`` is the reference's benchmark and imports
``ray_tpu``; the port's cluster burst runs in ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import runpy
import shlex
import sys
import time


def cmd_version(args) -> int:
    from ray_tpu_torch import __version__

    print(__version__)
    return 0


def cmd_start(args) -> int:
    """Start cluster daemons on this host (reference: ray start,
    scripts.py:691). --head starts the head + one agent; --address joins
    an existing cluster with one agent."""
    import logging

    logging.basicConfig(level=logging.INFO)
    resources = json.loads(args.resources)
    head = None
    if args.head:
        from ray_tpu_torch.cluster.head import HeadServer

        head = HeadServer(
            host=args.host,
            port=args.port,
            dashboard_port=None if args.no_dashboard else args.dashboard_port,
            use_device_scheduler=args.device_scheduler,
        )
        address = head.address
        print(f"ray_tpu_torch head started at {address}", flush=True)
        if head.dashboard is not None:
            print(
                f"dashboard at http://{args.host}:{head.dashboard.port}",
                flush=True,
            )
        print(
            f"join more nodes with: python -m ray_tpu_torch start --address {address}",
            flush=True,
        )
    else:
        if not args.address:
            print("either --head or --address is required", file=sys.stderr)
            return 1
        address = args.address
    agent = None
    if not args.head_only:
        from ray_tpu_torch.cluster.agent import NodeAgent

        agent = NodeAgent(
            head_address=address,
            resources=resources,
            num_workers=args.num_workers,
        )
        print(f"ray_tpu_torch agent {agent.node_id} started", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        if agent is not None:
            agent.shutdown()
        if head is not None:
            head.shutdown()
    return 0


def cmd_status(args) -> int:
    if args.address:
        from ray_tpu_torch.cluster.rpc import RpcClient

        client = RpcClient(args.address)
        info = client.call("ClusterInfo")
        print(json.dumps(info, indent=2, default=str))
        return 0
    import ray_tpu_torch

    rt = ray_tpu_torch.init(
        num_nodes=args.num_nodes,
        resources_per_node={"CPU": float(args.cpus), "memory": 4e9},
    )
    print(
        json.dumps(
            {
                "nodes": len(ray_tpu_torch.nodes()),
                "cluster_resources": ray_tpu_torch.cluster_resources(),
                "available_resources": ray_tpu_torch.available_resources(),
            },
            indent=2,
        )
    )
    ray_tpu_torch.shutdown()
    return 0


def cmd_job_submit(args) -> int:
    if args.address:
        from ray_tpu_torch.cluster.jobs import JobSubmissionClient

        client = JobSubmissionClient(args.address)
        entrypoint = shlex.join([args.script] + args.script_args)
        job_id = client.submit_job(entrypoint=entrypoint)
        print(f"submitted job {job_id}")
        if args.no_wait:
            return 0
        status = client.wait_until_finished(job_id, timeout=args.timeout)
        print(client.get_job_logs(job_id), end="")
        print(f"job {job_id} finished: {status}")
        return 0 if status == "SUCCEEDED" else 1
    # local mode: run the script with an in-process runtime around it
    import ray_tpu_torch

    ray_tpu_torch.init(
        num_nodes=args.num_nodes,
        resources_per_node={"CPU": float(args.cpus), "memory": 4e9},
        ignore_reinit_error=True,
    )
    sys.argv = [args.script] + args.script_args
    try:
        runpy.run_path(args.script, run_name="__main__")
        return 0
    finally:
        ray_tpu_torch.shutdown()


def cmd_job_ctl(args) -> int:
    from ray_tpu_torch.cluster.jobs import JobSubmissionClient

    client = JobSubmissionClient(args.address)
    if args.job_command == "list":
        print(json.dumps(client.list_jobs(), indent=2, default=str))
    elif args.job_command == "status":
        print(json.dumps(client.get_job_info(args.job_id), indent=2, default=str))
    elif args.job_command == "logs":
        print(client.get_job_logs(args.job_id), end="")
    elif args.job_command == "stop":
        print(client.stop_job(args.job_id))
    return 0


def cmd_bench(args) -> int:
    raise NotImplementedError(
        "bench.py is the reference's benchmark and imports ray_tpu; the "
        "port's cluster burst runs in chip_smoke.py's phase_cluster"
    )


def cmd_config(args) -> int:
    """Print every declared knob: name, env override, type, value, doc."""
    import json as _json

    from ray_tpu_torch.config import cfg

    rows = cfg.dump()
    if args.json:
        print(_json.dumps(rows, indent=2, default=str))
        return 0
    width = max(len(r["env"]) for r in rows)
    for r in rows:
        star = "*" if r["source"] == "env" else " "
        print(
            f"{star} {r['env']:<{width}}  {r['type']:<5} "
            f"= {r['value']!r:<24} {r['doc']}"
        )
    return 0


def main() -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version")

    st = sub.add_parser("start")
    st.add_argument("--head", action="store_true")
    st.add_argument("--head-only", action="store_true")
    st.add_argument("--address", default=None)
    st.add_argument("--host", default="127.0.0.1")
    st.add_argument("--port", type=int, default=6380)
    st.add_argument("--dashboard-port", type=int, default=8265)
    st.add_argument("--no-dashboard", action="store_true")
    st.add_argument(
        "--device-scheduler",
        default=None,
        action=argparse.BooleanOptionalAction,
        help="device scheduler on the card (default on; "
        "--no-device-scheduler for the NumPy golden model)",
    )
    st.add_argument("--num-workers", type=int, default=None)
    st.add_argument("--resources", default='{"CPU": 8}')

    s = sub.add_parser("status")
    s.add_argument("--address", default=None)
    s.add_argument("--num-nodes", type=int, default=1)
    s.add_argument("--cpus", type=int, default=8)

    j = sub.add_parser("job")
    jsub = j.add_subparsers(dest="job_command", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--address", default=None)
    js.add_argument("--num-nodes", type=int, default=1)
    js.add_argument("--cpus", type=int, default=8)
    js.add_argument("--no-wait", action="store_true")
    js.add_argument("--timeout", type=float, default=600.0)
    js.add_argument("script")
    js.add_argument("script_args", nargs="*")
    for name in ("list", "status", "logs", "stop"):
        jc = jsub.add_parser(name)
        jc.add_argument("--address", required=True)
        if name != "list":
            jc.add_argument("job_id")

    sub.add_parser("bench")

    cf = sub.add_parser(
        "config", help="dump the typed config registry (ray_config_def analog)"
    )
    cf.add_argument("--json", action="store_true")

    args = p.parse_args()
    if args.command == "config":
        return cmd_config(args)
    if args.command == "version":
        return cmd_version(args)
    if args.command == "start":
        return cmd_start(args)
    if args.command == "status":
        return cmd_status(args)
    if args.command == "job":
        if args.job_command == "submit":
            return cmd_job_submit(args)
        return cmd_job_ctl(args)
    if args.command == "bench":
        return cmd_bench(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
