"""``check`` validates a dataflow YAML; ``run`` runs it to completion under
the port's daemon in this process (the JAX CLI's ``daemon
--run-dataflow``) and exits non-zero when a node failed."""

from __future__ import annotations

import argparse
import sys


def cmd_check(args) -> int:
    from pathlib import Path

    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.core.validate import ValidationError

    try:
        descriptor = Descriptor.read(args.dataflow)
        descriptor.check(Path(args.dataflow).parent)
    except (ValidationError, ValueError) as e:
        print(f"{args.dataflow}: {e}", file=sys.stderr)
        return 1
    print(f"{args.dataflow}: OK ({len(descriptor.nodes)} nodes)")
    return 0


def cmd_run(args) -> int:
    from dora_tpu_torch.daemon import run_dataflow

    result = run_dataflow(args.dataflow, local_comm=args.local_comm, timeout_s=args.timeout,
                          stop_after_s=args.stop_after)
    if result.is_ok():
        print(f"dataflow {result.uuid} finished successfully")
        return 0
    for node_id, error in result.errors():
        print(f"node {node_id!r} failed: {error}", file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m dora_tpu_torch.cli",
        description="check and run dataflows under the port's local daemon")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("check", help="validate a dataflow YAML")
    p.add_argument("dataflow")
    p.set_defaults(fn=cmd_check)
    p = sub.add_parser("run", help="run one dataflow to completion on this machine")
    p.add_argument("dataflow")
    p.add_argument("--local-comm", default=None, choices=["tcp", "uds", "shmem"],
                   help="node channel transport; default: the YAML's communication.local, "
                        "else tcp")
    p.add_argument("--stop-after", type=float, default=None, metavar="SECONDS",
                   help="send STOP this long after every node started (a dataflow with "
                        "timers runs until stopped)")
    p.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                   help="give up after this long (default: wait for the end)")
    p.set_defaults(fn=cmd_run)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
