"""The port's kernel and VLM measurement tools on the CPU: bench_int8,
bench_flash and bench_vlm of dora_tpu_torch/tools/.

Each runs through ``main`` with ``--device cpu`` at small shapes (bench_vlm
on ``VLMConfig.tiny``) and prints parseable JSON lines: bench_int8 and
bench_flash one a shape with the figures of the JAX tools' text lines,
bench_vlm the JAX modes' lines with their keys (listed here; ``backend`` is
the port's ``device``) and a line of launches. On the tools' own seeded
inputs the plain path equals the JAX package's Pallas ``int8_matmul`` and
``flash_attention`` (run as its tests run them here, the interpreter)
within the tolerances tests/test_torch_int8_matmul.py and
tests/test_torch_flash_attention.py state, and bench_flash's f32 parity
reference equals the JAX tool's. The analytic FLOP counts equal the root
bench_vlm.py's. ``bench_vlm e2e`` hands its dataflow (port nodes only) to
the port's own daemon (its run on the CPU is in
tests/test_torch_dataflow_e2e.py), and without ``--device cpu`` every entry
point raises here. Timing fields are
never compared.
"""

from __future__ import annotations

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu_torch.tools import bench_flash as BF
from dora_tpu_torch.tools import bench_int8 as BI
from dora_tpu_torch.tools import bench_vlm as BV

CPU = torch.device("cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny models' products run faster so, and the
    suite's workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys) -> list[dict]:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def _jax_bench_vlm():
    """The root bench_vlm.py (the JAX package's tool), by path."""
    spec = importlib.util.spec_from_file_location("jax_bench_vlm",
                                                  os.path.join(_REPO, "bench_vlm.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# bench_int8: kernel 7
# ---------------------------------------------------------------------------


def test_int8_lines(capsys):
    assert BI.main(["--device", "cpu", "--shapes", "16x64x96,1x37x53", "--iters", "2"]) == 0
    lines = _lines(capsys)
    assert [ln["shape"] for ln in lines] == [[16, 64, 96], [1, 37, 53]]
    for ln in lines:
        assert {"device", "bf16_us", "bf16_gbs", "int8_us", "int8_gbs", "speedup", "rel_rms",
                "bf16_eager_us", "int8_eager_us", "launches", "plain_calls"} <= set(ln)
        assert ln["device"] == "cpu" and ln["launches"] == {} and ln["plain_calls"] > 0
        assert ln["rel_rms"] == 0.0  # the plain version against itself on the CPU


@pytest.mark.parametrize("m,k,n", [(16, 64, 96), (1, 37, 53), (33, 129, 70)])
def test_int8_inputs_plain_path_matches_jax(m, k, n):
    from dora_tpu.ops import int8_matmul as J
    from dora_tpu_torch.ops import int8_matmul as IM

    x, q, s, w16 = BI.inputs(m, k, n, CPU)
    assert x.dtype == w16.dtype == torch.bfloat16 and q.dtype == torch.int8
    want = np.asarray(J.int8_matmul(jnp.asarray(x.float().numpy()), jnp.asarray(q.numpy()),
                                    jnp.asarray(s.numpy())))
    got = IM.int8_matmul(x.float(), q, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the tool's bf16 call is that f32 product rounded once
    assert torch.equal(IM.int8_matmul(x, q, s), got.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# bench_flash: kernel 11
# ---------------------------------------------------------------------------


def test_flash_lines(capsys):
    assert BF.main(["--device", "cpu", "--seq", "64,100", "--heads", "2", "--head-dim", "16",
                    "--iters", "2"]) == 0
    first, second = _lines(capsys)
    for ln, t in ((first, 64), (second, 100)):
        assert {"device", "t", "heads", "head_dim", "causal", "ms", "tflops", "sdpa_ms",
                "eager_ms", "launches", "plain_calls"} <= set(ln)
        assert (ln["t"], ln["heads"], ln["head_dim"], ln["causal"]) == (t, 2, 16, True)
        assert ln["device"] == "cpu" and ln["launches"] == {} and ln["plain_calls"] > 0
    assert first["parity_max_abs_err"] < 2e-2 and "parity_max_abs_err" not in second


def test_flash_inputs_plain_path_matches_jax():
    from dora_tpu.models import layers as JL
    from dora_tpu.ops import flash_attention as jax_flash
    from dora_tpu_torch.ops import flash_attention as FA

    q, k, v = BF.inputs(128, 2, 64, CPU)
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal=True), np.float32)
    got = FA.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    f32 = [a.float() for a in (q, k, v)]
    want32 = np.asarray(jax_flash(*(jnp.asarray(a.numpy()) for a in f32), causal=True))
    np.testing.assert_allclose(FA.flash_attention(*f32, causal=True).numpy(), want32,
                               atol=2e-5, rtol=2e-5)
    # the parity reference: the JAX tool's dense attention in f32
    ref = JL.attention(*(jnp.asarray(a.numpy()) for a in f32), JL.causal_mask(128, 128))
    np.testing.assert_allclose(BF.dense_f32(q, k, v, True).numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# bench_vlm
# ---------------------------------------------------------------------------

#: the JAX modes' lines: their keys beyond metric / value / unit, by the
#: start of the metric's name (``backend`` as ``device``)
MODEL_KEYS = {
    "prefill latency": {"device", "prefill_tokens"},
    "decode int8 throughput": {"device", "max_new"},
    "decode int8 MBU": {"peak_hbm_gbs"},
    "decode MFU": {"peak_tflops"},
    "prefill MFU": {"peak_tflops"},
    "single-stream FPS": {"device"},
    "speculative decode int8 throughput": {"model_passes", "max_new", "note"},
}
BATCH_KEYS = {"per_stream", "vs_batch1", "ms_per_step"}


def test_vlm_model_lines(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_MAX_NEW", "8")
    monkeypatch.setenv("DORA_INT8_DECODE", "1")
    monkeypatch.setenv("DORA_SPEC_DECODE", "1")
    monkeypatch.delenv("DORA_INT4_DECODE", raising=False)
    assert BV.main(["model", "--device", "cpu", "--size", "tiny"]) == 0
    lines = _lines(capsys)
    assert len(lines) == len(MODEL_KEYS) + 1
    for ln, (name, keys) in zip(lines, MODEL_KEYS.items()):
        assert ln["metric"].startswith(f"vlm-tiny {name}"), (ln["metric"], name)
        assert {"metric", "value", "unit", "device"} | keys <= set(ln)
        assert ln["device"] == "cpu"
    by = {ln["metric"]: ln for ln in lines}
    assert by["vlm-tiny prefill latency"]["prefill_tokens"] == 16 + 16
    assert by["vlm-tiny decode int8 throughput"]["value"] > 0
    assert by["vlm-tiny decode MFU"]["value"] is None  # no card peak on the CPU
    assert 1 <= by["vlm-tiny speculative decode int8 throughput"]["model_passes"] <= 8
    launches = lines[-1]
    assert launches["metric"] == "vlm-tiny kernel launches"
    assert launches["launches"] == {} and launches["plain_calls"] > 0


def test_vlm_batch_lines(capsys):
    assert BV.main(["batch", "--device", "cpu", "--size", "tiny"]) == 0
    lines = _lines(capsys)
    assert [ln["metric"] for ln in lines[:3]] == [
        f"vlm-tiny batched fused decode (batch {b})" for b in (1, 4, 8)]
    for ln in lines[:3]:
        assert {"metric", "value", "unit", "device"} | BATCH_KEYS <= set(ln)
        assert ln["unit"] == "tokens/s" and ln["value"] > 0
    assert lines[0]["vs_batch1"] == 1.0
    assert lines[3]["launches"] == {} and lines[3]["plain_calls"] > 0


@pytest.mark.parametrize("size", ["bench_2b", "tiny"])
def test_vlm_flops_match_the_jax_tool(size):
    from dora_tpu.models import vlm as jvlm
    from dora_tpu_torch.models import vlm as tvlm

    jb = _jax_bench_vlm()
    jcfg, tcfg = getattr(jvlm.VLMConfig, size)(), getattr(tvlm.VLMConfig, size)()
    assert BV.lm_matmul_flops_per_token(tcfg) == jb.lm_matmul_flops_per_token(jcfg)
    assert BV.vision_matmul_flops(tcfg) == jb.vision_matmul_flops(jcfg)
    for context in (1, 272, 2047):
        assert BV.lm_attention_flops(tcfg, context) == jb.lm_attention_flops(jcfg, context)


def test_vlm_e2e_names_the_daemon(monkeypatch):
    """e2e runs camera -> VLM node -> sink through dora_tpu_torch.daemon, every
    node a module of the port, and fails when a node fails."""
    from dora_tpu_torch import daemon
    from dora_tpu_torch.message.common import (DataflowResult, NodeError, NodeErrorCause,
                                               NodeExitStatus, NodeResult)

    seen = []

    def run(desc, **kw):
        seen.append(desc)
        err = NodeError(exit_status=NodeExitStatus(success=False, code=1),
                        cause=NodeErrorCause(kind="other"))
        return DataflowResult(uuid="u", node_results={"vlm": NodeResult(error=err)})

    monkeypatch.setattr(daemon, "run_dataflow", run)
    with pytest.raises(RuntimeError, match="e2e bench failed"):
        BV.main(["e2e", "--device", "cpu", "--size", "tiny"])
    (desc,) = seen
    assert [str(n.id) for n in desc.nodes] == ["camera", "vlm", "sink"]
    assert desc.node("camera").source == "module:dora_tpu_torch.nodehub.camera"
    assert "dora_tpu_torch.runtime --operator op=dora_tpu_torch.nodehub.ops:make_vlm" in \
        desc.node("vlm").args


@pytest.mark.parametrize("main,argv", [
    (BI.main, ["--shapes", "1x8x8"]),
    (BF.main, ["--seq", "16"]),
    (BV.main, ["model", "--size", "tiny"]),
    (BV.main, ["batch", "--size", "tiny"]),
    (BV.main, ["e2e", "--size", "tiny"]),
])
def test_no_cpu_fallback(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
