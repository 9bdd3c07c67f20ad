"""The port's dataflow descriptor (dora_tpu_torch.core.descriptor, .validate)
against the JAX package's, on every example dataflow of both packages and on
malformed fixtures.

On each example: the same node ids, kinds, inputs (mapping and queue size),
outputs, timers, env, restart policies and communication. ``check`` gives
JAX's outcome, except where the port refuses by design: a ``jax:``
operator is refused naming ``torch:``, the port's counterpart, and a
``wasm:`` one as unsupported. The port's own examples may hold ``torch:``
operators, which the JAX package reads as its ``jax:`` ones. A malformed
fixture raises the JAX error class with the JAX message text."""

from __future__ import annotations

from pathlib import Path

import pytest
import yaml

from dora_tpu.core import descriptor as jd
from dora_tpu.core.validate import ValidationError as JValidationError
from dora_tpu_torch.core import descriptor as td
from dora_tpu_torch.core.config import TimerMapping
from dora_tpu_torch.core.validate import ValidationError

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(str(p.relative_to(REPO)) for p in (REPO / "examples").glob("*/*.yml"))
PORT_EXAMPLES = sorted(str(p.relative_to(REPO))
                       for p in (REPO / "dora_tpu_torch" / "examples").glob("*.yml"))


def _shape(desc) -> dict:
    """What the daemon builds its routes and spawns from, as plain data (a
    port ``torch:`` source reads as the JAX ``jax:`` one)."""
    out = {}
    for n in desc.nodes:
        kind = type(n.kind).__name__
        ops = None
        if kind == "RuntimeNode":
            ops = [(str(op.id), type(op.source).__name__.replace("TorchSource", "JaxSource"),
                    op.source.source) for op in n.kind.operators]
        out[str(n.id)] = {
            "kind": kind, "operators": ops,
            "source": getattr(n.kind, "source", None), "args": getattr(n.kind, "args", None),
            "inputs": {str(k): (str(v.mapping), v.queue_size) for k, v in n.inputs.items()},
            "timers": sorted(v.mapping.interval_ns for v in n.inputs.values()
                             if type(v.mapping).__name__ == "TimerMapping"),
            "outputs": sorted(map(str, n.outputs)), "env": n.env,
            "restart": None if n.restart is None else vars(n.restart),
            "send_stdout_as": n.send_stdout_as, "machine": n.deploy.machine,
        }
    return {"nodes": out, "local": desc.communication.local.kind}


def _outcome(desc, working_dir) -> tuple:
    try:
        desc.check(working_dir)
    except (ValidationError, JValidationError, ValueError) as e:
        return (type(e).__name__, str(e))
    return ("ok", None)


def _torch_as_jax(raw):
    """The descriptor with each ``torch:`` operator source as ``jax:``."""
    if isinstance(raw, dict):
        return {("jax" if k == "torch" else k): _torch_as_jax(v) for k, v in raw.items()}
    if isinstance(raw, list):
        return [_torch_as_jax(v) for v in raw]
    return raw


@pytest.mark.parametrize("path", EXAMPLES + PORT_EXAMPLES)
def test_examples_parse_and_check_as_jax(path):
    full = REPO / path
    jdesc = jd.Descriptor.parse(_torch_as_jax(yaml.safe_load(full.read_text())))
    tdesc = td.Descriptor.read(full)
    assert _shape(tdesc) == _shape(jdesc)
    want = _outcome(jdesc, full.parent)
    got = _outcome(tdesc, full.parent)
    refused = [(n, op) for n in tdesc.nodes if isinstance(n.kind, td.RuntimeNode)
               for op in n.kind.operators
               if isinstance(op.source, (td.JaxSource, td.WasmSource))]
    if refused and not (want[0] != "ok" and str(refused[0][0].id) not in want[1]):
        node, op = refused[0]
        assert got[0] == "ValidationError" and got[1].startswith(f"operator {node.id}/{op.id}:")
        if isinstance(op.source, td.JaxSource):
            assert "torch:" in got[1]
    else:
        assert got == want  # the JAX outcome, refusals with their texts included


def test_port_examples_name_only_port_modules():
    """Every node of the port's examples is a port module, a dynamic node,
    or an operator node of the port's torch factories."""
    for path in PORT_EXAMPLES:
        for node in td.Descriptor.read(REPO / path).nodes:
            if isinstance(node.kind, td.RuntimeNode):
                for op in node.kind.operators:
                    assert isinstance(op.source, td.TorchSource), (path, node.id, op.id)
                    assert op.source.source.startswith("dora_tpu_torch."), (path, op.source)
                continue
            assert node.source == "dynamic" or node.source.startswith("module:dora_tpu_torch."), \
                (path, node.id, node.source)


@pytest.mark.parametrize("kind,source,reason", [
    ("jax", "dora_tpu.nodehub.ops:make_vlm", "is the JAX package's operator.*torch: <module>"),
    ("python", "op.txt", "python source must be a .py file"),
    ("shared-library", "libop", "source 'libop' not found"),
])
def test_operator_nodes_are_refused_by_name(tmp_path, kind, source, reason):
    """What the port's check refuses of an operator node, by name: a
    ``jax:`` source (naming ``torch:``), a Python operator that is not a
    .py file, a library that does not exist."""
    (tmp_path / "op.txt").write_text("")
    raw = {"nodes": [
        {"id": "cam", "path": "module:dora_tpu_torch.nodehub.camera", "outputs": ["image"]},
        {"id": "vlm", "operators": [{"id": "cap", kind: source, "inputs": {"image": "cam/image"},
                                     "outputs": ["tokens"]}]},
    ]}
    desc = td.Descriptor.parse(raw)
    assert desc.node("vlm").inputs["cap/image"].mapping.source == "cam"
    with pytest.raises(ValidationError, match=f"^operator vlm/cap: .*{reason}"):
        desc.check(tmp_path)


def test_alerts_block_is_parsed_as_jax_parses_it():
    """An ``alerts:`` block parses into the JAX package's policy (the same
    rules, field for field), and ``check`` accepts it, as JAX's does."""
    import dataclasses

    raw = {"nodes": [{"id": "a", "path": "python"}],
           "alerts": {"disable": ["queue-depth"], "rules": [
               {"name": "busy", "kind": "rate", "selector": "srv:*:decode_tokens", "op": ">",
                "threshold": 10, "window_s": 2, "labels": {"team": "serving"}},
               {"name": "hbm-ceiling", "kind": "gauge_ratio",
                "selector": "srv:*:hbm_used_bytes", "denominator": "srv:*:hbm_limit_bytes",
                "op": ">", "threshold": 0.8}]}}
    desc = td.Descriptor.parse(raw)
    want = jd.Descriptor.parse(raw)
    assert dataclasses.asdict(desc.alerts) == dataclasses.asdict(want.alerts)
    assert type(desc.alerts).__module__ == "dora_tpu_torch.alerts"
    desc.check()
    want.check()
    assert td.Descriptor.parse({"nodes": [{"id": "a", "path": "python"}]}).alerts is None
    with pytest.raises(ValueError, match="unknown alerts keys"):
        td.Descriptor.parse({**raw, "alerts": {"rule": []}})


def _node(**kw):
    return {"id": "a", "path": "python", **kw}


MALFORMED = {
    "not a mapping": ["nodes"],
    "unknown top-level key": {"nodes": [_node()], "extra": 1},
    "no nodes": {"nodes": []},
    "node without id": {"nodes": [{"path": "python"}]},
    "two kinds": {"nodes": [_node(operator={"jax": "m:f"})]},
    "no kind": {"nodes": [{"id": "a"}]},
    "bad node id": {"nodes": [{"id": "a b", "path": "python"}]},
    "duplicate ids": {"nodes": [_node(), _node()]},
    "inputs not a mapping": {"nodes": [_node(inputs=["x"])]},
    "outputs not a list": {"nodes": [_node(outputs="x")]},
    "bad output id": {"nodes": [_node(outputs=["a b"])]},
    "bad timer unit": {"nodes": [_node(inputs={"t": "dora/timer/hours/1"})]},
    "zero timer": {"nodes": [_node(inputs={"t": "dora/timer/millis/0"})]},
    "timer not a number": {"nodes": [_node(inputs={"t": "dora/timer/millis/x"})]},
    "mapping without output": {"nodes": [_node(inputs={"i": "b"})]},
    "queue_size zero": {"nodes": [_node(inputs={"i": {"source": "b/o", "queue_size": 0}})]},
    "unknown input key": {"nodes": [_node(inputs={"i": {"source": "b/o", "qs": 2}})]},
    "input without source": {"nodes": [_node(inputs={"i": {"queue_size": 2}})]},
    "input spec a number": {"nodes": [_node(inputs={"i": 3})]},
    "restart unknown key": {"nodes": [_node(restart={"tries": 2})]},
    "restart a string": {"nodes": [_node(restart="always")]},
    "restart negative backoff": {"nodes": [_node(restart={"backoff_base_s": -1})]},
    "slo empty": {"nodes": [_node(slo={})]},
    "slo not a number": {"nodes": [_node(slo={"ttft_p99_ms": "fast"})]},
    "qos bad class": {"nodes": [_node(qos={"default_class": "gold"})]},
    "qos bad depth": {"nodes": [_node(qos={"depth_batch": 0})]},
    "serving not a bool": {"nodes": [_node(serving="yes")]},
    "empty operators": {"nodes": [{"id": "a", "operators": []}]},
    "duplicate operator ids": {"nodes": [{"id": "a", "operators": [
        {"id": "x", "jax": "m:f"}, {"id": "x", "jax": "m:g"}]}]},
    "operator without source": {"nodes": [{"id": "a", "operators": [{"id": "x"}]}]},
    "operator without id": {"nodes": [{"id": "a", "operators": [{"jax": "m:f"}]}]},
    "unknown local comm": {"nodes": [_node()], "communication": {"local": "pigeon"}},
    "remote not tcp": {"nodes": [_node()], "communication": {"remote": "udp"}},
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_raises_as_jax(case):
    raw = MALFORMED[case]
    with pytest.raises(Exception) as jerr:
        jd.Descriptor.parse(raw)
    with pytest.raises(Exception) as terr:
        td.Descriptor.parse(raw)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    # the port's list of operator sources adds its own, torch
    assert str(terr.value).replace("/torch/", "/") == str(jerr.value)


CHECK_FAILS = {
    "source node missing": {"nodes": [_node(inputs={"i": "ghost/out"})]},
    "output missing": {"nodes": [_node(outputs=["o"]),
                                 {"id": "b", "path": "python", "inputs": {"i": "a/x"}}]},
    "source file missing": {"nodes": [{"id": "a", "path": "no_such_node.py"}]},
}


@pytest.mark.parametrize("case", sorted(CHECK_FAILS))
def test_check_fails_as_jax(tmp_path, case):
    raw = CHECK_FAILS[case]
    want = _outcome(jd.Descriptor.parse(raw), tmp_path)
    got = _outcome(td.Descriptor.parse(raw), tmp_path)
    assert got == want and want[0] == "ValidationError"


def test_read_parses_yaml_and_parse_takes_a_mapping(tmp_path):
    raw = {"nodes": [{"id": "t", "path": "python", "inputs": {
        "tick": "dora/timer/secs/2", "x": {"source": "t/o", "queue_size": 3}},
        "outputs": ["o"], "env": {"K": "$HOME"}, "send_stdout_as": "o"}],
        "communication": {"_unstable_local": "UnixDomain"}}
    path = tmp_path / "df.yml"
    path.write_text(yaml.safe_dump(raw))
    a, b = td.Descriptor.read(path), td.Descriptor.parse(raw)
    assert _shape(a) == _shape(b) == _shape(jd.Descriptor.parse(raw))
    node = a.node("t")
    assert node.inputs["tick"].mapping == TimerMapping(interval_ns=2_000_000_000)
    assert a.communication.local.kind == "uds" and node.send_stdout_as == "o"
