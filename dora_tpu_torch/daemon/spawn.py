"""Node process spawning (dora_tpu/daemon/spawn.py): resolve the node's
source (``shell``, ``module:``, a ``.py`` file, an executable), inject
``DORA_NODE_CONFIG``, pipe stdout and stderr to
``out/<dataflow>/log_<node>.txt``, keep the last stderr lines for the
failure report, hand every line to the daemon's ``on_node_log`` (the
coordinator's log stream), re-publish stdout as an output under
``send_stdout_as``, and watch for the process's exit.
"""

from __future__ import annotations

import asyncio
import base64
import os
import shlex
import sys
from pathlib import Path
from typing import TYPE_CHECKING

from dora_tpu_torch.core.descriptor import SHELL_SOURCE, CustomNode, ResolvedNode
from dora_tpu_torch.message.common import parse_level_prefix
from dora_tpu_torch.message.daemon_to_node import NodeConfig
from dora_tpu_torch.message.serde import encode

if TYPE_CHECKING:
    from dora_tpu_torch.daemon.core import Daemon, DataflowState

#: last stderr lines kept for a failure report
STDERR_RING_LINES = 10

NODE_CONFIG_ENV = "DORA_NODE_CONFIG"


def encode_node_config(cfg: NodeConfig) -> str:
    """NodeConfig -> env-var-safe string (base64 of the wire encoding)."""
    return base64.b64encode(encode(cfg)).decode("ascii")


def log_file_path(working_dir: Path, dataflow_id: str, node_id: str) -> Path:
    """out/<dataflow-id>/log_<node>.txt."""
    return working_dir / "out" / dataflow_id / f"log_{node_id}.txt"


def resolve_command(node: ResolvedNode, working_dir: Path) -> list[str] | str:
    """Resolve a node's source to an argv list (or a shell string).

    - ``path: shell`` runs ``args`` through the shell;
    - ``module:<name>`` and ``*.py`` sources run under this interpreter;
    - a runtime node (operators) runs the port's operator runtime;
    - anything else is an executable path or $PATH name.
    """
    if not isinstance(node.kind, CustomNode):
        return [sys.executable, "-m", "dora_tpu_torch.runtime"]
    custom: CustomNode = node.kind
    source = custom.source
    args = shlex.split(custom.args) if custom.args else []
    if source == SHELL_SOURCE:
        return custom.args or ""
    if source.startswith("module:"):
        return [sys.executable, "-m", source[len("module:"):]] + args
    if source.endswith(".py"):
        path = Path(source)
        if not path.is_absolute():
            path = working_dir / path
        return [sys.executable, str(path)] + args
    path = Path(source)
    if not path.is_absolute():
        local = working_dir / path
        if local.exists():
            return [str(local)] + args
    return [source] + args


async def spawn_node(
    daemon: "Daemon",
    df: "DataflowState",
    node: ResolvedNode,
    node_config: NodeConfig,
) -> asyncio.subprocess.Process:
    """Spawn one node process with its config injected via the environment."""
    working_dir = df.working_dir
    cmd = resolve_command(node, working_dir)

    env = dict(os.environ)
    # SLO targets and QoS knobs before node.env, so the descriptor's env
    # can override them (the serving node reads both).
    if node.slo is not None:
        for key, target in node.slo.as_targets().items():
            env[f"DORA_SLO_{key.upper()}"] = str(target)
    if node.qos is not None:
        for key, val in node.qos.as_env().items():
            env[f"DORA_QOS_{key}"] = val
    env.update({str(k): str(v) for k, v in node.env.items()})
    env[NODE_CONFIG_ENV] = encode_node_config(node_config)
    # Nodes importing the port from a source checkout need the repo root.
    repo_root = str(Path(__file__).resolve().parent.parent.parent)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    kwargs = dict(
        cwd=str(working_dir),
        env=env,
        stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE,
    )
    if isinstance(cmd, str):
        process = await asyncio.create_subprocess_shell(cmd, **kwargs)
    else:
        try:
            process = await asyncio.create_subprocess_exec(*cmd, **kwargs)
        except FileNotFoundError as e:
            raise RuntimeError(f"node {node.id!r}: cannot spawn {cmd[0]!r}: {e}") from e

    log_path = log_file_path(working_dir, df.id, str(node.id))
    log_path.parent.mkdir(parents=True, exist_ok=True)
    log_file = open(log_path, "ab")

    pumps = [
        asyncio.create_task(
            _pump_stream(daemon, df, node, process.stdout, log_file, is_stderr=False)
        ),
        asyncio.create_task(
            _pump_stream(daemon, df, node, process.stderr, log_file, is_stderr=True)
        ),
    ]
    asyncio.create_task(_watch_exit(daemon, df, node, process, log_file, pumps))
    return process


async def _pump_stream(daemon, df, node, stream, log_file, *, is_stderr: bool):
    send_as = node.send_stdout_as
    while True:
        try:
            line = await stream.readline()
        except (ValueError, ConnectionError):
            # Over-long line without newline: fall back to raw chunks.
            try:
                line = await stream.read(1 << 16)
            except Exception:
                break
        if not line:
            break
        try:
            log_file.write(line)
            log_file.flush()
        except ValueError:
            break  # log file closed during shutdown
        text = line.decode(errors="replace").rstrip("\n")
        if is_stderr:
            ring = df.stderr_rings.setdefault(str(node.id), [])
            ring.append(text)
            del ring[:-STDERR_RING_LINES]
        # a level prefix on the line wins over its stream's default
        level = parse_level_prefix(text) or ("error" if is_stderr else "info")
        daemon.on_node_log(df, str(node.id), level, text)
        if not is_stderr and send_as:
            daemon.publish_stdout_line(df, node.id, send_as, text)


async def _watch_exit(daemon, df, node, process, log_file, pumps):
    returncode = await process.wait()
    # Drain stdout and stderr before the result is classified (the stderr
    # ring and send_stdout_as must see every line).
    try:
        await asyncio.wait_for(asyncio.gather(*pumps), timeout=10)
    except (asyncio.TimeoutError, Exception):
        pass
    try:
        log_file.close()
    except Exception:
        pass
    daemon.handle_node_exit(df, node.id, returncode)
