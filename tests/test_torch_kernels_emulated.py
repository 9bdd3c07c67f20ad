"""The CUDA kernels' sources, built for the host (csrc/emu/: one fiber per
CUDA thread on one OS thread, blocks in turn) and held against their plain PyTorch
versions on the CPU, in bf16 at small sizes: the four kernels of the fp
serving path, the speculative verify kernel, the int8-KV forms of the three
attention kernels, the LoRA gather-matmul, the int8 product, the three
attention kernels over dense caches (the dense engine's decode, batch-1
decode and its verify) and flash attention. The attention kernels run at
head_dim 128 and page 16, and again at the widened shapes: head_dim 64 at
Qwen2-0.5B's 14 / 2 heads, page 32, Qwen2-7B's 28 / 4 heads (36 q + k + v
heads), a group of 10 (two head tiles), and verify chunks of m x group =
66 rows (two row tiles) and of 20 rows (two fold tiles); the LoRA kernel,
rows grouped by adapter with warp ballots and both products on the
emulated mma, over one adapter, distinct adapters, all slot 0, no rows,
ranks 1 to 256 and widths off 16; flash attention at D 16, 40, 80 and
128, full and causal, T of 1 and off its tiles, transposed (strided) and
unaligned inputs. The tensor-core sweeps of every attention kernel run on
the emulated warp collectives (shuffles, the m16n8k16 mma, cp.async): the
mma alone on one tile against torch.matmul, the dense
verify over 3+ context splits with m x group of 20, 35 and 66 rows, the
prefill at groups 6 and 7 (head_dim 128 and 64) from position 0 and from a
later page, fp and int8 KV; the spec verify over 3+ splits of streams at
different positions (page-straddling rows, a frozen stream, fp and int8
KV, head_dim 64, 28 / 4 heads, page 32, m = 11), the paged batch decode
over 3+ splits of streams beside a frozen one and a live one at 0 (fp and
int8 KV, head_dim 64, 28 / 4 heads, page 32), the dense batch decode over
3+ splits of planes from position 0 to S - 1 and batch-1 decode on the
same sweep. The
tensor-core int8 product of mlp_step and lm_head_argmax (ldmatrix of the
int8 bytes, widened in registers, the mma) runs in every band: one tile
against torch.matmul; mlp_step split and fused (the splits each case takes
asserted), with K off the K tile and unaligned weight rows; the head at
16-, 32-, 64- and 128-row bands, and with exact ties across lanes, warps
and vocab tiles, where the smaller index must win. The int8 product
(kernel 7) runs on the same tensor-core product, K split and whole, in
every band. Flash attention runs its scores and P.V on the emulated mma,
P kept in the accumulators' registers.

This checks the kernels' indexing, masking and reductions without a card;
it says nothing of how they compile or run on one (chip_smoke.py does).

Every launch of an emulated library runs in a child process (one per
module, restarted after a failure), never in the test process: an index
that runs out of bounds in hand-written C++ is a segfault, and a fault or a
hang there becomes a failed test that names the signal, within
CHILD_TIMEOUT_S, instead of taking the test worker down. The libraries are
compiled in the test process (no code of theirs runs there); the plain
versions run there too.

Tolerances: the largest error at most 1e-2 of the output's largest
magnitude, the bf16 rounding of the kernels' bf16 intermediates and outputs
(the LoRA kernel's t also as hi + lo bf16); argmax tokens exact; untouched
pool rows and scale entries exact. int8 rows the kernels write: every byte within one
step (1 LSB) of the plain version's, whose f32 K/V differ from the kernel's
by summation order only, the share of differing bytes printed; their scales
within 1e-5 relative. LoRA rows of slot 0 exactly zero. The int8 product
within 1e-2 of its largest magnitude (its bf16 output). Dense caches: every
row at or past the written ones starts as NaN, the outputs must be finite,
the written rows within 1e-2 of the plain version's and every other cache
value bit-unchanged.
"""

from __future__ import annotations

import os
import pickle
import select
import shutil
import signal
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dora_tpu_torch.ops import _build
from dora_tpu_torch.ops import decode_block as DB
from dora_tpu_torch.ops import flash_attention as FA
from dora_tpu_torch.ops import int8_matmul as IM
from dora_tpu_torch.ops import lora as LO
from dora_tpu_torch.ops.int8_matmul import quantize_int8

BF = torch.bfloat16
CHILD_TIMEOUT_S = 60
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER_FLAG = "--emulated-kernel-worker"

#: kernel name -> (module, wrapper that launches it, library)
_KERNELS = {
    "mlp_step": (DB, "_mlp_step_kernel", "mlp"),
    "lm_head_argmax": (DB, "_lm_head_argmax_kernel", "lm_head"),
    "attention_paged_batch_step": (DB, "_attention_paged_batch_step_kernel", "paged_attention"),
    "attention_paged_chunk_step": (DB, "_attention_paged_chunk_step_kernel", "paged_attention"),
    "attention_paged_spec_step": (DB, "_attention_paged_spec_step_kernel", "paged_attention"),
    "lora_gather_matmul": (LO, "_lora_gather_matmul_kernel", "lora"),
    "int8_matmul": (IM, "_int8_matmul_kernel", "int8_matmul"),
    "attention_batch_step": (DB, "_attention_batch_step_kernel", "paged_attention"),
    "attention_step": (DB, "_attention_step_kernel", "paged_attention"),
    "attention_chunk_step": (DB, "_attention_chunk_step_kernel", "paged_attention"),
    "flash_attention": (FA, "_flash_attention_kernel", "flash_attention"),
    "mma_tile": (DB, "mma_tile", "paged_attention"),
    "tc_tile": (DB, "tc_tile", "mlp"),
    "tc_tile4": (DB, "tc_tile4", "mlp"),
}
_SIGNATURES = {**DB._SIGNATURES, **LO._SIGNATURES, **IM._SIGNATURES, **FA._SIGNATURES}


# ---------------------------------------------------------------------------
# the child process that runs the emulated kernels
# ---------------------------------------------------------------------------


def _run_job(job):
    name, args, kw = job
    if name == "__signal__":  # the harness's own check: die as a fault would
        os.kill(os.getpid(), args[0])
    if name == "__sleep__":
        time.sleep(args[0])
        return None
    if name == "sweep_splits":  # the context splits kernel 4 (0) or 10 (1) takes
        lib = _build.library("paged_attention", _SIGNATURES["paged_attention"], compiler="host")
        return lib.dora_sweep_splits(*args)
    if name == "batch_sweep_splits":  # the context splits of kernels 5 and 8 (B streams)
        lib = _build.library("paged_attention", _SIGNATURES["paged_attention"], compiler="host")
        return lib.dora_batch_sweep_splits(*args)
    if name == "mlp_splits":  # the K splits of mlp_step's gate/up and down products
        lib = _build.library("mlp", _SIGNATURES["mlp"], compiler="host")
        m, d, f, *groups = args  # the int4 groups of the two weights (none: int8)
        g_gu, g_down = groups or (0, 0)
        return (lib.dora_mlp_splits(m, d, f, 0, g_gu), lib.dora_mlp_splits(m, d, f, 1, g_down))
    if name == "lora_splits":  # the D splits of the LoRA kernel's first product
        lib = _build.library("lora", _SIGNATURES["lora"], compiler="host")
        return lib.dora_lora_splits(*args)
    if name == "int8_matmul_splits":  # the K splits kernel 7 takes (1: fused epilogue)
        lib = _build.library("int8_matmul", _SIGNATURES["int8_matmul"], compiler="host")
        return lib.dora_int8_matmul_splits(*args)
    module, fn, lib = _KERNELS[name]
    lib = _build.library(lib, _SIGNATURES[lib], compiler="host")
    return getattr(module, fn)(*args, lib=lib, **kw)


def _worker() -> None:
    """Child main loop: length-prefixed pickled jobs on stdin, results (or
    the exception raised) on the original stdout; anything printed goes to
    stderr."""
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    inp = sys.stdin.buffer
    while True:
        head = inp.read(8)
        if len(head) < 8:
            return
        job = pickle.loads(inp.read(struct.unpack("<Q", head)[0]))
        try:
            res = (True, _run_job(job))
        except Exception as e:  # returned to the test, which re-raises it
            res = (False, e)
        body = pickle.dumps(res)
        out.write(struct.pack("<Q", len(body)) + body)
        out.flush()


class _Child:
    """Runs jobs in one child process; a child that dies or overruns its
    time fails the calling test with the cause, and the next call starts a
    fresh child."""

    def __init__(self):
        self.proc = None
        #: seconds of each call that returned since the last read, the
        #: child's start-up included where the call started it
        self.times: list[float] = []

    def _start(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, env.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), _WORKER_FLAG],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=_REPO, env=env,
            bufsize=0,
        )

    def close(self):
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait()
            self.proc = None

    def _read(self, n: int, deadline: float) -> bytes:
        fd = self.proc.stdout.fileno()
        buf = bytearray()
        while len(buf) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError
            ready, _, _ = select.select([fd], [], [], left)
            if ready:
                chunk = os.read(fd, n - len(buf))
                if not chunk:
                    raise EOFError
                buf += chunk
        return bytes(buf)

    def call(self, name: str, *args, timeout: float = CHILD_TIMEOUT_S, **kw):
        """Run kernel ``name``'s wrapper in the child on ``args`` (host
        tensors, returned with the in-place updates the kernel made)."""
        t0 = time.monotonic()
        if self.proc is None or self.proc.poll() is not None:
            self._start()
        body = pickle.dumps((name, args, kw))
        deadline = t0 + timeout
        try:
            self.proc.stdin.write(struct.pack("<Q", len(body)) + body)
            self.proc.stdin.flush()
            n = struct.unpack("<Q", self._read(8, deadline))[0]
            ok, res = pickle.loads(self._read(n, deadline))
        except (EOFError, BrokenPipeError):
            rc = self.proc.wait()
            self.proc = None
            cause = f"signal {signal.Signals(-rc).name}" if rc < 0 else f"exit code {rc}"
            pytest.fail(f"emulated {name} killed its child process: {cause}")
        except TimeoutError:
            self.close()
            pytest.fail(f"emulated {name} hung: no result within {timeout} s")
        self.times.append(time.monotonic() - t0)
        if not ok:
            raise res
        return res


@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the emulated kernel build")
    _build.build(_build.SOURCES, compiler="host")  # compile only; nothing runs here
    child = _Child()
    yield child
    child.close()


@pytest.fixture(autouse=True)
def _slowest_call(request):
    """Each test's slowest emulated call, as the ``emulated_call_s``
    property of the junit report: its margin under CHILD_TIMEOUT_S in the
    run that made the report."""
    yield
    if "emu" in request.fixturenames:
        child = request.getfixturevalue("emu")
        if child.times:
            request.node.user_properties.append(("emulated_call_s", round(max(child.times), 3)))
        child.times.clear()


def test_child_faults_and_hangs_fail_the_test_not_the_worker(emu):
    """A segfault in the child is a failed test naming SIGSEGV, a hang one
    naming the time limit, and the next call gets a fresh child."""
    with pytest.raises(pytest.fail.Exception, match="SIGSEGV"):
        emu.call("__signal__", signal.SIGSEGV)
    with pytest.raises(pytest.fail.Exception, match="hung"):
        emu.call("__sleep__", 30, timeout=1)
    assert emu.call("__sleep__", 0) is None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _attn_setup(rng, d=64, h=4, kv=2, hd=128, seq=128):
    wqkv = quantize_int8(_t(rng.standard_normal((d, (h + 2 * kv) * hd))))
    wo = quantize_int8(_t(rng.standard_normal((h * hd, d))))
    bqkv = _t(rng.standard_normal((h + 2 * kv) * hd))
    nw = _t(rng.standard_normal(d))
    inv = 1.0 / 10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd)
    freqs = torch.outer(torch.arange(seq, dtype=torch.float32), inv)
    return wqkv, wo, bqkv, nw, torch.cos(freqs), torch.sin(freqs)


def _int8_pools(rng, shape):
    """int8 K and V pools with their scale planes, quantized through the
    port's number format from seeded normals."""
    kq, ks = DB.kv_quant_rows(_t(rng.standard_normal(shape) * 0.5))
    vq, vs = DB.kv_quant_rows(_t(rng.standard_normal(shape) * 0.5))
    return kq, vq, ks, vs


def _check_int8_writes(got, want, before, written, what):
    """int8 pools the kernel wrote (got) against the plain version's (want):
    written rows within 1 LSB and their scales within 1e-5 relative; every
    other value and scale entry bit-unchanged from ``before``. Page 0 (the
    null page) is left out."""
    kg, vg, ksg, vsg = got
    kw, vw, ksw, vsw = want
    k0, v0, ks0, vs0 = before
    w = written.clone()
    w[0] = False
    keep = ~written
    keep[0] = False
    diff = 0
    for qg, qw, q0 in ((kg, kw, k0), (vg, vw, v0)):
        step = (qg[w].int() - qw[w].int()).abs()
        assert int(step.max()) <= 1, f"{what}: written int8 rows more than 1 LSB apart"
        diff += int((step > 0).sum())
        assert torch.equal(qg[keep], q0[keep]), f"{what}: unwritten values changed"
    for sg, sw, s0 in ((ksg, ksw, ks0), (vsg, vsw, vs0)):
        assert _rel(sg[w], sw[w]) <= 1e-5, f"{what}: written scales disagree"
        assert torch.equal(sg[keep], s0[keep]), f"{what}: unwritten scales changed"
    n = 2 * int(w.sum()) * kg.shape[-1]
    print(f"{what}: {diff} of {n} written int8 bytes differ by 1 LSB ({diff / n:.2%})")


# ---------------------------------------------------------------------------
# the fp serving path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,bias,residual", [(3, True, True), (20, False, False)])
def test_mlp_kernel_matches_plain(emu, m, bias, residual):
    rng = np.random.default_rng(m)
    d, f = 96, 80
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    wgu = quantize_int8(_t(rng.standard_normal((d, 2 * f))))
    wd = quantize_int8(_t(rng.standard_normal((f, d))))
    b = _t(rng.standard_normal(2 * f)) if bias else None
    args = (x, nw, wgu["int8"], wgu["scale"], b, wd["int8"], wd["scale"])
    want = DB.mlp_step_plain(*args, residual=residual)
    got = emu.call("mlp_step", *args, eps=1e-6, residual=residual)
    assert got.dtype == want.dtype
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("m,vocab", [(3, 300), (20, 1000)])
def test_lm_head_kernel_matches_plain(emu, m, vocab):
    rng = np.random.default_rng(vocab)
    d = 96
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    wh = quantize_int8(_t(rng.standard_normal((d, vocab))))
    ti, tv = DB.lm_head_argmax_plain(x, nw, wh["int8"], wh["scale"], return_val=True)
    gi, gv = emu.call("lm_head_argmax", x, nw, wh["int8"], wh["scale"], eps=1e-6,
                      return_val=True)
    assert torch.equal(gi, ti)
    assert _rel(gv, tv) <= 1e-2


def _batch_case(rng, h=4, kv=2, hd=128, page=16, maxp=6, d=64):
    """Rows mid-page, at a page start, frozen (position 0, zeroed table row)
    and past three pages."""
    positions = torch.tensor([17, 32, 0, 5, 50], dtype=torch.int32)
    b = positions.shape[0]
    bt = torch.zeros((b, maxp), dtype=torch.int32)
    for i in (0, 1, 3, 4):
        bt[i] = 1 + i * maxp + torch.arange(maxp, dtype=torch.int32)
    n_pool = 1 + b * maxp
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, d, h, kv, hd)
    x = _t(rng.standard_normal((b, d)), BF)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, positions)
    written = torch.zeros((n_pool, kv, page), dtype=torch.bool)
    for i, p in enumerate(positions.tolist()):
        written[bt[i, p // page], :, p % page] = True
    written[0] = True
    head = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    return head, (wo["int8"], wo["scale"], positions, bt), (n_pool, kv, page, hd), written


def test_paged_batch_kernel_matches_plain(emu):
    rng = np.random.default_rng(0)
    head, tail, shape, written = _batch_case(rng)
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    kw = dict(heads=4, kv_heads=2, head_dim=128)
    want, k1, v1 = DB.attention_paged_batch_step_plain(
        *head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_batch_step", *head, kp.clone(), vp.clone(),
                           *tail, eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2[1:], k1[1:]) <= 1e-2 and _rel(v2[1:], v1[1:]) <= 1e-2
    assert torch.equal(k2[~written], kp[~written])
    assert torch.equal(v2[~written], vp[~written])


def _chunk_case(rng, position, h=4, kv=2, hd=128, page=16, maxp=6, d=64, m=32):
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, d, h, kv, hd)
    n_pool = maxp + 4
    bt = torch.from_numpy((1 + rng.permutation(n_pool - 1)[:maxp]).astype(np.int32))
    x = _t(rng.standard_normal((m, d)), BF)
    cr, sr = DB.rope_rows(cos_t, sin_t, position, m)
    written = torch.zeros((n_pool, kv, page), dtype=torch.bool)
    written[bt[position // page : position // page + m // page].long()] = True
    head = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    return head, (wo["int8"], wo["scale"], position, bt), (n_pool, kv, page, hd), written


@pytest.mark.parametrize("position", (0, 48))
def test_paged_chunk_kernel_matches_plain(emu, position):
    rng = np.random.default_rng(position + 1)
    head, tail, shape, written = _chunk_case(rng, position)
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    kw = dict(heads=4, kv_heads=2, head_dim=128)
    want, k1, v1 = DB.attention_paged_chunk_step_plain(
        *head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_chunk_step", *head, kp.clone(), vp.clone(),
                           *tail, eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2, k1) <= 1e-2 and _rel(v2, v1) <= 1e-2
    others = ~written[:, 0, 0]
    assert torch.equal(k2[others], kp[others])


def test_kernel_wrappers_refuse_shapes_the_kernels_do_not_take():
    x = torch.zeros((2, 64), dtype=BF)
    with pytest.raises(ValueError, match="head_dim 16: .* take head_dim 64 or 128; "
                                         "page 8: .* multiples of 16"):
        DB._attention_paged_batch_step_kernel(
            x, None, None, None, None, None, None,
            torch.zeros((3, 2, 8, 16), dtype=BF), None, None, None, None,
            torch.zeros((2, 4), dtype=torch.int32), heads=4, kv_heads=2,
            head_dim=16, eps=1e-6, residual=True, lib=object())
    with pytest.raises(ValueError, match="dtype"):
        DB._mlp_step_kernel(
            x.float(), torch.ones(64), torch.zeros((64, 32), dtype=torch.int8),
            torch.ones(1, 32), None, torch.zeros((16, 64), dtype=torch.int8),
            torch.ones(1, 64), eps=1e-6, residual=True, lib=object())


def _spec_case(rng, m=5, h=4, kv=2, hd=128, page=16, maxp=6, d=64, positions=(14, 0, 37, 32)):
    """Streams of m candidate rows; by default four of m = 5: one straddling
    a page (14..18), one frozen (position 0, zeroed table row), one past two
    pages (37) and one at a page start (32). Frozen streams get a zeroed
    table row, the others pages of their own."""
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, d, h, kv, hd, seq=maxp * page)
    positions = torch.tensor(positions, dtype=torch.int32)
    b = positions.shape[0]
    bt = torch.zeros((b, maxp), dtype=torch.int32)
    live = [i for i, p in enumerate(positions.tolist()) if p]
    for i in live:
        bt[i] = 1 + i * maxp + torch.arange(maxp, dtype=torch.int32)
    n_pool = 1 + b * maxp
    x = _t(rng.standard_normal((b * m, d)), BF)
    flat = (positions[:, None] + torch.arange(m, dtype=torch.int32)[None, :]).reshape(-1)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, flat)
    written = torch.zeros((n_pool, kv, page), dtype=torch.bool)
    for i, p in enumerate(positions.tolist()):
        for r in range(p, p + m):
            written[bt[i, r // page], :, r % page] = True
    written[0] = True
    assert int(written[1:].sum()) == len(live) * m * kv
    head = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    return head, (wo["int8"], wo["scale"], positions, bt), (n_pool, kv, page, hd), written


def test_paged_spec_kernel_matches_plain(emu):
    """Outputs and written rows within tolerance, every other row of the
    live pages exact."""
    rng = np.random.default_rng(11)
    head, tail, shape, written = _spec_case(rng)
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    kw = dict(heads=4, kv_heads=2, head_dim=128, m=5)
    want, k1, v1 = DB.attention_paged_spec_step_plain(
        *head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_spec_step", *head, kp.clone(), vp.clone(),
                           *tail, eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2[1:], k1[1:]) <= 1e-2 and _rel(v2[1:], v1[1:]) <= 1e-2
    assert torch.equal(k2[~written], kp[~written])
    assert torch.equal(v2[~written], vp[~written])


def test_spec_wrapper_refuses_shapes_the_kernel_does_not_take():
    """Pages that are not multiples of the 16-row sweep tile, groups that do
    not divide the query heads, rows that are not m per stream and other
    dtypes raise; any m and any m x group run (the sweep tiles both)."""
    x = torch.zeros((10, 64), dtype=BF)
    pools = torch.zeros((3, 2, 16, 128), dtype=BF)
    pos = torch.zeros((2,), dtype=torch.int32)
    bt = torch.zeros((2, 4), dtype=torch.int32)

    def call(x, pos, m, heads=4, pools=pools):
        DB._attention_paged_spec_step_kernel(
            x, None, None, None, None, None, None, pools, pools, None, None,
            pos, bt, heads=heads, kv_heads=2, head_dim=128, m=m, eps=1e-6,
            residual=True, lib=object())

    with pytest.raises(ValueError, match="page 24: .* multiples of 16"):
        call(torch.zeros((34, 64), dtype=BF), pos, 17,
             pools=torch.zeros((3, 2, 24, 128), dtype=BF))
    with pytest.raises(ValueError, match="5 query heads over 2 kv heads: .* whole groups"):
        call(torch.zeros((20, 64), dtype=BF), pos, 10, heads=5)
    with pytest.raises(ValueError, match="rows for each"):
        call(x, torch.zeros((3,), dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="dtype"):
        call(x.float(), pos, 5)


# ---------------------------------------------------------------------------
# the widened shapes: head_dim 64, page 32, many heads, long verify chunks
# ---------------------------------------------------------------------------

#: case -> (heads, kv_heads, head_dim, page)
WIDE = {
    "qwen2_0_5b_hd64": (14, 2, 64, 16),
    "page32": (4, 2, 128, 32),
    "qwen2_7b_36_heads": (28, 4, 128, 16),
    "group10_hd64": (20, 2, 64, 16),
}


@pytest.mark.parametrize("case", sorted(WIDE))
def test_widened_paged_batch_kernel_matches_plain(emu, case):
    h, kv, hd, page = WIDE[case]
    rng = np.random.default_rng(60)
    head, tail, shape, written = _batch_case(rng, h=h, kv=kv, hd=hd, page=page)
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd)
    want, k1, v1 = DB.attention_paged_batch_step_plain(
        *head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_batch_step", *head, kp.clone(), vp.clone(),
                           *tail, eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2[1:], k1[1:]) <= 1e-2 and _rel(v2[1:], v1[1:]) <= 1e-2
    assert torch.equal(k2[~written], kp[~written])
    assert torch.equal(v2[~written], vp[~written])


@pytest.mark.parametrize("case", sorted(WIDE))
def test_widened_paged_chunk_kernel_matches_plain(emu, case):
    """A 32-row chunk after two pages of prior context."""
    h, kv, hd, page = WIDE[case]
    rng = np.random.default_rng(61)
    position = 2 * page
    head, tail, shape, written = _chunk_case(rng, position, h=h, kv=kv, hd=hd, page=page)
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd)
    want, k1, v1 = DB.attention_paged_chunk_step_plain(
        *head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_chunk_step", *head, kp.clone(), vp.clone(),
                           *tail, eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2, k1) <= 1e-2 and _rel(v2, v1) <= 1e-2
    others = ~written[:, 0, 0]
    assert torch.equal(k2[others], kp[others])


#: case -> (heads, kv_heads, head_dim, page, m)
WIDE_SPEC = {
    **{c: (*shape, 5) for c, shape in WIDE.items()},
    "m11_group6_66_rows": (12, 2, 128, 16, 11),
}


@pytest.mark.parametrize("case", sorted(WIDE_SPEC))
def test_widened_paged_spec_kernel_matches_plain(emu, case):
    h, kv, hd, page, m = WIDE_SPEC[case]
    rng = np.random.default_rng(62)
    head, tail, shape, written = _spec_case(rng, m=m, h=h, kv=kv, hd=hd, page=page)
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, m=m)
    want, k1, v1 = DB.attention_paged_spec_step_plain(
        *head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_spec_step", *head, kp.clone(), vp.clone(),
                           *tail, eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2[1:], k1[1:]) <= 1e-2 and _rel(v2[1:], v1[1:]) <= 1e-2
    assert torch.equal(k2[~written], kp[~written])
    assert torch.equal(v2[~written], vp[~written])


@pytest.mark.parametrize("case", ("qwen2_0_5b_hd64", "page32"))
def test_widened_int8kv_kernels_match_plain(emu, case):
    """The int8-KV forms of the batch, chunk and spec kernels at head_dim 64
    (the row scales reduce over 64 threads) and at page 32."""
    h, kv, hd, page = WIDE[case]
    rng = np.random.default_rng(63)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd)
    head, tail, shape, written = _batch_case(rng, h=h, kv=kv, hd=hd, page=page)
    pools = _int8_pools(rng, shape)
    want, *pw = DB.attention_paged_batch_step_plain(
        *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
        pools[3].clone(), **kw)
    got, *pg = emu.call("attention_paged_batch_step", *head, pools[0].clone(),
                        pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                        eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    _check_int8_writes(pg, pw, pools, written, f"batch int8 KV, {case}")
    head, tail, shape, written = _chunk_case(rng, 2 * page, h=h, kv=kv, hd=hd, page=page)
    pools = _int8_pools(rng, shape)
    want, *pw = DB.attention_paged_chunk_step_plain(
        *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
        pools[3].clone(), **kw)
    got, *pg = emu.call("attention_paged_chunk_step", *head, pools[0].clone(),
                        pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                        eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    _check_int8_writes(pg, pw, pools, written, f"chunk int8 KV, {case}")
    head, tail, shape, written = _spec_case(rng, h=h, kv=kv, hd=hd, page=page)
    pools = _int8_pools(rng, shape)
    want, *pw = DB.attention_paged_spec_step_plain(
        *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
        pools[3].clone(), m=5, **kw)
    got, *pg = emu.call("attention_paged_spec_step", *head, pools[0].clone(),
                        pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                        eps=1e-6, residual=True, m=5, **kw)
    assert _rel(got, want) <= 1e-2
    _check_int8_writes(pg, pw, pools, written, f"spec int8 KV, {case}")


# ---------------------------------------------------------------------------
# int8 KV pages
# ---------------------------------------------------------------------------


def test_paged_batch_int8kv_kernel_matches_plain(emu):
    rng = np.random.default_rng(20)
    head, tail, shape, written = _batch_case(rng)
    pools = _int8_pools(rng, shape)
    kw = dict(heads=4, kv_heads=2, head_dim=128)
    want, *pw = DB.attention_paged_batch_step_plain(
        *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
        pools[3].clone(), **kw)
    got, *pg = emu.call("attention_paged_batch_step", *head, pools[0].clone(),
                        pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                        eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    _check_int8_writes(pg, pw, pools, written, "batch int8 KV")


@pytest.mark.parametrize("position", (0, 48))
def test_paged_chunk_int8kv_kernel_matches_plain(emu, position):
    """The chunk writes whole pages and scale rows; the prior pages are
    dequantized, the chunk's own rows fold from fp."""
    rng = np.random.default_rng(position + 21)
    head, tail, shape, written = _chunk_case(rng, position)
    pools = _int8_pools(rng, shape)
    kw = dict(heads=4, kv_heads=2, head_dim=128)
    want, *pw = DB.attention_paged_chunk_step_plain(
        *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
        pools[3].clone(), **kw)
    got, *pg = emu.call("attention_paged_chunk_step", *head, pools[0].clone(),
                        pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                        eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    _check_int8_writes(pg, pw, pools, written, f"chunk int8 KV at {position}")


def test_paged_spec_int8kv_kernel_matches_plain(emu):
    """Exactly m value rows and m scale entries per (live stream, kv head)
    are written, one stream's straddling a page."""
    rng = np.random.default_rng(22)
    head, tail, shape, written = _spec_case(rng)
    pools = _int8_pools(rng, shape)
    kw = dict(heads=4, kv_heads=2, head_dim=128, m=5)
    want, *pw = DB.attention_paged_spec_step_plain(
        *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
        pools[3].clone(), **kw)
    got, *pg = emu.call("attention_paged_spec_step", *head, pools[0].clone(),
                        pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                        eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    _check_int8_writes(pg, pw, pools, written, "spec int8 KV")


# ---------------------------------------------------------------------------
# LoRA gather-matmul
# ---------------------------------------------------------------------------


def _lora_case(rng, rows, d=96, rank=12, slots=5, layers=3, layer=1, ids="mixed"):
    """A [slots, layers, ...] resident stack (slot 0 zero) and one layer's
    strided slice of it, as the fused pass hands it over. ids "mixed":
    random, with slot-0 rows and repeats; "one": every row on the last
    slot; "distinct": row i on slot i + 1 (slots = rows + 1); "base": every
    row on slot 0."""
    if ids == "distinct":
        slots = rows + 1
    a = _t(rng.standard_normal((slots, layers, d, rank)) * 0.3, BF)
    b = _t(rng.standard_normal((slots, layers, rank, d)) * 0.3, BF)
    a[0] = 0
    b[0] = 0
    if ids == "mixed":
        groups = rng.integers(0, slots, size=rows).astype(np.int32)
        groups[:2] = [0, 3][:rows]
    elif ids == "one":
        groups = np.full(rows, slots - 1, np.int32)
    elif ids == "distinct":
        groups = rng.permutation(rows).astype(np.int32) + 1
    else:
        groups = np.zeros(rows, np.int32)
    x = _t(rng.standard_normal((rows, d)), BF)
    return x, torch.from_numpy(groups), a[:, layer], b[:, layer]


#: (rows, width, rank, ids) -> D splits: the two mixed batches of 7 and 33
#: rows first (their test ids unchanged); 80 rows on one adapter (two
#: 64-row windows of the slot's rows) over 96-deep splits (two mma stages
#: each) and a last one 28 deep; every row its own adapter over 23 splits;
#: every row on slot 0; no rows; ranks 1, 24 (16-byte rows, padded to 32;
#: a last split 8 deep) and 256 over 70 rows; widths 100 (rows of x and B
#: copied element by element, D and N off the 64-column tiles) and 88
#: (16-byte rows)
LORA_CASES = {
    "7": ((7, 96, 12, "mixed"), 3),
    "33": ((33, 96, 12, "mixed"), 3),
    "one_adapter_80_rows": ((80, 700, 12, "one"), 8),
    "distinct_adapters": ((9, 1100, 12, "distinct"), 23),
    "all_base": ((12, 96, 12, "base"), 3),
    "no_rows": ((0, 96, 12, "mixed"), 3),
    "rank1": ((7, 96, 1, "mixed"), 3),
    "rank24": ((21, 1000, 24, "mixed"), 32),
    "rank256_70_rows": ((70, 96, 256, "mixed"), 3),
    "width100": ((19, 100, 12, "mixed"), 4),
    "width88_one_adapter": ((40, 88, 16, "one"), 3),
}


@pytest.mark.parametrize("rows", sorted(LORA_CASES))
def test_lora_kernel_matches_plain(emu, rows):
    """The grouped tensor-core kernel against the plain version (1e-2 of the
    largest magnitude: bf16 of f32 sums taken in another order, t fed as hi
    + lo bf16); every slot-0 row exactly zero, with the D splits the case
    takes asserted."""
    (n, d, rank, ids), splits = LORA_CASES[rows]
    rng = np.random.default_rng(n + d + rank)
    x, groups, a, b = _lora_case(rng, n, d=d, rank=rank, ids=ids)
    assert emu.call("lora_splits", d, a.shape[0], rank, n) == splits
    want = LO.lora_gather_matmul_plain(x, groups, a, b)
    got = emu.call("lora_gather_matmul", x, groups, a, b)
    assert got.dtype == BF and got.shape == want.shape == (n, d)
    if n:
        assert _rel(got, want) <= 1e-2
    base = groups == 0
    assert bool(base.any()) == (ids in ("mixed", "base") and n > 0)
    assert not got[base].float().any()


def test_lora_kernel_matches_plain_at_rank_256(emu):
    """The largest rank the kernel takes: 16 column groups of t a block."""
    rng = np.random.default_rng(256)
    x, groups, a, b = _lora_case(rng, 9, rank=256)
    want = LO.lora_gather_matmul_plain(x, groups, a, b)
    got = emu.call("lora_gather_matmul", x, groups, a, b)
    assert _rel(got, want) <= 1e-2
    base = groups == 0
    assert bool(base.any()) and not got[base].float().any()
    with pytest.raises(ValueError, match="LoRA rank 257: .* rank 1..256"):
        LO._lora_gather_matmul_kernel(*_lora_case(rng, 2, rank=257), lib=object())


def test_host_wrappers_check_index_operands():
    """Out-of-range block-table entries, positions whose rows run past the
    table and adapter ids past the stack raise before any launch."""
    rng = np.random.default_rng(5)
    head, (wo, swo, positions, bt), shape, _ = _batch_case(rng)
    kp = torch.zeros(shape, dtype=BF)
    kw = dict(heads=4, kv_heads=2, head_dim=128, eps=1e-6, residual=True, lib=object())
    bad_bt = bt.clone()
    bad_bt[1, 2] = shape[0]
    with pytest.raises(ValueError, match="block table entries"):
        DB._attention_paged_batch_step_kernel(*head, kp, kp, wo, swo, positions, bad_bt, **kw)
    far = positions.clone()
    far[0] = bt.shape[1] * 16
    with pytest.raises(ValueError, match="inside"):
        DB._attention_paged_batch_step_kernel(*head, kp, kp, wo, swo, far, bt, **kw)
    shead, (wo, swo, spos, sbt), sshape, _ = _spec_case(rng)
    sp = torch.zeros(sshape, dtype=BF)
    spos = spos.clone()
    spos[2] = sbt.shape[1] * 16 - 4  # 5 rows from here run past the table
    with pytest.raises(ValueError, match="inside"):
        DB._attention_paged_spec_step_kernel(*shead, sp, sp, wo, swo, spos, sbt,
                                             m=5, **kw)
    x, groups, a, b = _lora_case(rng, 4)
    groups[3] = a.shape[0]
    with pytest.raises(ValueError, match="adapter ids"):
        LO._lora_gather_matmul_kernel(x, groups, a, b, lib=object())
    with pytest.raises(ValueError, match="adapter ids"):
        LO.lora_gather_matmul(x, groups, a, b)


#: (m, d, f, bias, residual) -> K splits of (gate/up, down): the decode
#: bands of 16, 32 and 64 rows split both products (K 264 and 300, neither
#: a multiple of the 32-deep K tile; d 264 and f 300 not multiples of 16, so
#: every weight row is copied element by element); above 64 rows the
#: gate/up product runs whole with the SwiGLU in its epilogue, on unaligned
#: (f 300) and aligned (f 80, cp.async) weights, in one band and in two
MLP_PATHS = {
    (1, 264, 300, True, True): (2, 2),
    (16, 264, 300, False, False): (2, 2),
    (37, 264, 300, True, False): (2, 2),
    (70, 96, 300, True, True): (1, 2),
    (70, 96, 80, False, False): (1, 1),
    (16, 96, 80, True, True): (1, 1),
    (140, 96, 80, True, False): (1, 1),
}


@pytest.mark.parametrize("case", sorted(MLP_PATHS), ids=lambda c: "m{}_d{}_f{}_b{}_r{}".format(*c))
def test_mlp_tensor_core_paths_match_plain(emu, case):
    """The tensor-core products of mlp_step on every path: split K with the
    partials summed by silu_mul and the epilogue, and the fused SwiGLU; the
    splits each case takes are asserted first."""
    m, d, f, bias, residual = case
    assert emu.call("mlp_splits", m, d, f) == MLP_PATHS[case]
    rng = np.random.default_rng(m + d + f)
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    wgu = quantize_int8(_t(rng.standard_normal((d, 2 * f))))
    wd = quantize_int8(_t(rng.standard_normal((f, d))))
    b = _t(rng.standard_normal(2 * f)) if bias else None
    args = (x, nw, wgu["int8"], wgu["scale"], b, wd["int8"], wd["scale"])
    want = DB.mlp_step_plain(*args, residual=residual)
    got = emu.call("mlp_step", *args, eps=1e-6, residual=residual)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("m", (1, 16, 37, 70, 140))
@pytest.mark.parametrize("vocab", (300, 1000))
def test_lm_head_tensor_core_bands_match_plain(emu, m, vocab):
    """lm_head_argmax in one band of 16, 32 or 64 rows and in one and two
    128-row bands above: tokens exactly the plain version's, the max logits
    within 1e-2."""
    rng = np.random.default_rng(m * vocab)
    d = 96
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    wh = quantize_int8(_t(rng.standard_normal((d, vocab))))
    ti, tv = DB.lm_head_argmax_plain(x, nw, wh["int8"], wh["scale"], return_val=True)
    gi, gv = emu.call("lm_head_argmax", x, nw, wh["int8"], wh["scale"], eps=1e-6,
                      return_val=True)
    assert torch.equal(gi, ti)
    assert _rel(gv, tv) <= 1e-2


#: column offsets of a duplicated winner: the same lane (1, 2; a lane holds
#: 4 neighbouring columns of a 16-column group), the next lanes of the quad
#: (4, 8), another warp (16), the warp's other half (64), another vocab tile
#: (128, 130)
TIE_OFFSETS = (1, 2, 4, 8, 16, 64, 128, 130)


@pytest.mark.parametrize("m", (16, 70))
def test_lm_head_ties_pick_the_first_index(emu, m):
    """Each row's winning column is copied, weights and scale, to another
    column at one of TIE_OFFSETS, above or below it, and both are made the
    clear maximum (scale x 4): the logits tie exactly, and the kernel must
    pick the smaller index, as the plain version's torch.max does, whichever
    lane, warp or vocab tile holds it."""
    rng = np.random.default_rng(7 + m)
    d, vocab = 96, 1000
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    wh = quantize_int8(_t(rng.standard_normal((d, vocab))))
    q, s = wh["int8"].clone(), wh["scale"].clone()
    h = DB._rms(x, nw, 1e-6).to(BF)
    win = ((h.double() @ q.double()) * s.double()).argmax(dim=-1).tolist()
    ties, used = {}, set()
    for r, j in enumerate(win):
        off = TIE_OFFSETS[r % len(TIE_OFFSETS)]
        p = j - off if (r // len(TIE_OFFSETS)) % 2 and j - off >= 0 else j + off
        if p >= vocab or p < 0 or {j, p} & used:
            continue
        used |= {j, p}
        q[:, p] = q[:, j]
        s[0, j] *= 4
        s[0, p] = s[0, j]
        ties[r] = min(j, p)
    assert len(ties) >= m // 2
    ti, tv = DB.lm_head_argmax_plain(x, nw, q, s, return_val=True)
    for r, first in ties.items():
        assert int(ti[r]) == first, f"row {r}: the plain version does not see the tie"
    gi, gv = emu.call("lm_head_argmax", x, nw, q, s, eps=1e-6, return_val=True)
    assert torch.equal(gi, ti)
    assert _rel(gv, tv) <= 1e-2


# ---------------------------------------------------------------------------
# the int8 product and the dense caches
# ---------------------------------------------------------------------------


#: (m, k, n) -> the K splits kernel 7 takes: the decode bands of 16, 32 and
#: 64 rows and a 128-row prefill band, each split (partials summed by the
#: epilogue) and whole (the scale applied and bf16 written by the product);
#: odd K and N, and N off the 16-byte weight chunks (copied element by
#: element)
INT8_SPLITS = {
    (1, 37, 53): 1,
    (20, 100, 130): 1,
    (64, 129, 256): 1,
    (16, 300, 200): 2,
    (32, 264, 96): 2,
    (65, 256, 96): 2,
    (65, 100, 300): 1,
}


@pytest.mark.parametrize("m,k,n", sorted(INT8_SPLITS))
def test_int8_matmul_kernel_matches_plain(emu, m, k, n):
    """Odd and even K and N (the 16-byte weight rows and the ragged edge),
    every band, K split and whole: the splits each case takes are asserted
    first."""
    assert emu.call("int8_matmul_splits", m, n, k) == INT8_SPLITS[(m, k, n)]
    rng = np.random.default_rng(m + k)
    x = _t(rng.standard_normal((m, k)), BF)
    w = quantize_int8(_t(rng.standard_normal((k, n))))
    want = IM.int8_matmul_plain(x, w["int8"], w["scale"])
    got = emu.call("int8_matmul", x, w["int8"], w["scale"])
    assert got.dtype == BF and got.shape == want.shape
    assert _rel(got, want) <= 1e-2


SEQ = 48  # dense cache rows: three 16-row tiles


def _bits(t):
    return t.view(torch.int16)


def _dense_check(got, want, caches_got, caches_want, before, written):
    """Finite outputs within tolerance; written cache rows within tolerance
    (NaN elsewhere), every other cache value bit-unchanged."""
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) <= 1e-2
    for g, w, b in zip(caches_got, caches_want, before):
        assert _rel(g[written], w[written]) <= 1e-2
        assert torch.equal(_bits(g)[~written], _bits(b)[~written])


def _nan_caches(rng, shape, live):
    """bf16 caches [B, KV, S, hd] (or one plane [KV, S, hd]) of seeded
    normals whose rows from ``live[b]`` on are NaN in plane b."""
    k = _t(rng.standard_normal(shape) * 0.5, BF)
    v = _t(rng.standard_normal(shape) * 0.5, BF)
    planes = (k, v) if k.dim() == 4 else (k[None], v[None])
    for b, n in enumerate(torch.as_tensor(live).reshape(-1).tolist()):
        for c in planes:
            c[b, :, n:] = float("nan")
    return k, v


@pytest.mark.parametrize("residual", (True, False))
def test_dense_batch_kernel_matches_plain(emu, residual):
    """Four planes: an idle row pinned at 0, rows mid-tile, at a tile start
    and on the last row of the plane."""
    rng = np.random.default_rng(30)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng)
    positions = torch.tensor([0, 17, 32, SEQ - 1], dtype=torch.int32)
    b = positions.shape[0]
    x = _t(rng.standard_normal((b, 64)), BF)
    kc, vc = _nan_caches(rng, (b, 2, SEQ, 128), positions + 1)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, positions)
    args = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    tail = (wo["int8"], wo["scale"], positions)
    kw = dict(heads=4, kv_heads=2, head_dim=128, residual=residual)
    want, k1, v1 = DB.attention_batch_step_plain(*args, kc.clone(), vc.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_batch_step", *args, kc.clone(), vc.clone(), *tail,
                           eps=1e-6, **kw)
    written = torch.zeros((b, 2, SEQ), dtype=torch.bool)
    written[torch.arange(b), :, positions.long()] = True
    _dense_check(got, want, (k2, v2), (k1, v1), (kc, vc), written)


@pytest.mark.parametrize("position,residual", [(0, True), (30, False), (SEQ - 1, True)])
def test_dense_step_kernel_matches_plain(emu, position, residual):
    rng = np.random.default_rng(31 + position)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng)
    x = _t(rng.standard_normal((1, 64)), BF)
    kc, vc = _nan_caches(rng, (2, SEQ, 128), position + 1)
    cr, sr = DB.rope_rows(cos_t, sin_t, position)
    args = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    kw = dict(heads=4, kv_heads=2, head_dim=128, residual=residual)
    want, k1, v1 = DB.attention_step_plain(*args, kc.clone(), vc.clone(), wo["int8"],
                                           wo["scale"], position, **kw)
    got, k2, v2 = emu.call("attention_step", *args, kc.clone(), vc.clone(), wo["int8"],
                           wo["scale"], position, eps=1e-6, **kw)
    written = torch.zeros((2, SEQ), dtype=torch.bool)
    written[:, position] = True
    _dense_check(got, want, (k2, v2), (k1, v1), (kc, vc), written)


@pytest.mark.parametrize("position,residual", [(0, True), (21, False), (SEQ - 5, True)])
def test_dense_chunk_kernel_matches_plain(emu, position, residual):
    """M = 5 rows from the cache start, across a tile boundary, and ending
    on the last row."""
    m = 5
    rng = np.random.default_rng(40 + position)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng)
    x = _t(rng.standard_normal((m, 64)), BF)
    kc, vc = _nan_caches(rng, (2, SEQ, 128), position)
    cr, sr = DB.rope_rows(cos_t, sin_t, position, m)
    args = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    kw = dict(heads=4, kv_heads=2, head_dim=128, residual=residual)
    want, k1, v1 = DB.attention_chunk_step_plain(*args, kc.clone(), vc.clone(), wo["int8"],
                                                 wo["scale"], position, **kw)
    got, k2, v2 = emu.call("attention_chunk_step", *args, kc.clone(), vc.clone(), wo["int8"],
                           wo["scale"], position, eps=1e-6, **kw)
    written = torch.zeros((2, SEQ), dtype=torch.bool)
    written[:, position : position + m] = True
    _dense_check(got, want, (k2, v2), (k1, v1), (kc, vc), written)


#: case -> (kernel, heads, kv_heads, head_dim, rows, position)
WIDE_DENSE = {
    "chunk_m11_group6_66_rows": ("attention_chunk_step", 12, 2, 128, 11, 21),
    "chunk_m20_hd64_two_fold_tiles": ("attention_chunk_step", 4, 2, 64, 20, 9),
    "step_hd64_group7": ("attention_step", 14, 2, 64, 1, 30),
    "batch_36_heads": ("attention_batch_step", 28, 4, 128, 4, None),
}


@pytest.mark.parametrize("case", sorted(WIDE_DENSE))
def test_widened_dense_kernels_match_plain(emu, case):
    name, h, kv, hd, m, position = WIDE_DENSE[case]
    rng = np.random.default_rng(70)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, h=h, kv=kv, hd=hd)
    x = _t(rng.standard_normal((m, 64)), BF)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, residual=True)
    if name == "attention_batch_step":
        positions = torch.tensor([0, 17, 32, SEQ - 1], dtype=torch.int32)
        kc, vc = _nan_caches(rng, (m, kv, SEQ, hd), positions + 1)
        cr, sr = DB.rope_rows_at(cos_t, sin_t, positions)
        where = positions
        written = torch.zeros((m, kv, SEQ), dtype=torch.bool)
        written[torch.arange(m), :, positions.long()] = True
    else:
        kc, vc = _nan_caches(rng, (kv, SEQ, hd), position + (m == 1))
        cr, sr = DB.rope_rows(cos_t, sin_t, position, m)
        where = position
        written = torch.zeros((kv, SEQ), dtype=torch.bool)
        written[:, position : position + m] = True
    args = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    plain = getattr(DB, f"{name}_plain")
    want, k1, v1 = plain(*args, kc.clone(), vc.clone(), wo["int8"], wo["scale"], where, **kw)
    got, k2, v2 = emu.call(name, *args, kc.clone(), vc.clone(), wo["int8"], wo["scale"],
                           where, eps=1e-6, **kw)
    _dense_check(got, want, (k2, v2), (k1, v1), (kc, vc), written)


# ---------------------------------------------------------------------------
# the tensor-core sweeps of kernels 4 and 10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1))
def test_emulated_mma_tile_matches_matmul(emu, seed):
    """The emulated m16n8k16 mma, fed fragments by the sweeps' layout, is
    the plain product of one 16 x 16 by 16 x 8 bf16 tile (f32 sums of exact
    bf16 products: within 1e-5 of the largest magnitude)."""
    rng = np.random.default_rng(seed)
    a = _t(rng.standard_normal((16, 16)) * 4, BF)
    b = _t(rng.standard_normal((16, 8)), BF)
    got = emu.call("mma_tile", a, b)
    want = torch.matmul(a.float(), b.float())
    assert got.dtype == torch.float32 and got.shape == (16, 8)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("seed", (0, 1))
def test_emulated_tc_tile_matches_matmul(emu, seed):
    """The fragment path of kernels 1 and 2's product (the emulated ldmatrix
    of the bf16 tile, ldmatrix.trans of the int8 tile's byte pairs, their
    widening to bf16 and the even / odd column mma) is the plain product of
    one 16 x 16 bf16 tile by a 16 x 16 int8 tile over the full int8 range
    (exact products, f32 sums: within 1e-5)."""
    rng = np.random.default_rng(seed)
    a = _t(rng.standard_normal((16, 16)) * 4, BF)
    w = torch.from_numpy(rng.integers(-128, 128, size=(16, 16)).astype(np.int8))
    got = emu.call("tc_tile", a, w)
    want = torch.matmul(a.float(), w.float())
    assert got.dtype == torch.float32 and got.shape == (16, 16)
    assert _rel(got, want) <= 1e-5


LONG_SEQ = 256  # dense planes long enough for several 32-key context splits

#: case -> (heads, kv_heads, head_dim, rows, position): m x group of 20, 66
#: and 35 query rows, positions off the 32-key tile, 3 or 4 context splits
SPLIT_DENSE = {
    "m10_group2_20_rows": (4, 2, 128, 10, 201),
    "m11_group6_66_rows_hd64": (12, 2, 64, 11, 197),
    "m5_group7_hd64": (14, 2, 64, 5, 250),
}


@pytest.mark.parametrize("case", sorted(SPLIT_DENSE))
def test_dense_chunk_kernel_splits_the_context(emu, case):
    """Kernel 10 over a context split 3+ ways, every row from the position
    on NaN: finite outputs within tolerance of the plain version, written
    rows within tolerance, everything else bit-unchanged."""
    h, kv, hd, m, position = SPLIT_DENSE[case]
    assert emu.call("sweep_splits", 1, m, h, kv, position) >= 3
    rng = np.random.default_rng(80 + m)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, h=h, kv=kv, hd=hd)
    inv = 1.0 / 10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd)
    freqs = torch.outer(torch.arange(LONG_SEQ, dtype=torch.float32), inv)
    cos_t, sin_t = torch.cos(freqs), torch.sin(freqs)
    x = _t(rng.standard_normal((m, 64)), BF)
    kc, vc = _nan_caches(rng, (kv, LONG_SEQ, hd), position)
    cr, sr = DB.rope_rows(cos_t, sin_t, position, m)
    args = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, residual=True)
    want, k1, v1 = DB.attention_chunk_step_plain(*args, kc.clone(), vc.clone(), wo["int8"],
                                                 wo["scale"], position, **kw)
    got, k2, v2 = emu.call("attention_chunk_step", *args, kc.clone(), vc.clone(), wo["int8"],
                           wo["scale"], position, eps=1e-6, **kw)
    written = torch.zeros((kv, LONG_SEQ), dtype=torch.bool)
    written[:, position : position + m] = True
    _dense_check(got, want, (k2, v2), (k1, v1), (kc, vc), written)


#: case -> (heads, kv_heads, head_dim, page, m, int8 KV): Qwen2-1.5B's group
#: of 6 at head_dim 128, Qwen2-0.5B's 7 at 64, Qwen2-7B's 28 / 4 heads, page
#: 32, and an m = 11 verify (66 rows: five warps), fp and int8 KV
SPLIT_SPEC = {
    "group6_hd128": (12, 2, 128, 16, 5, False),
    "group6_hd128_int8kv": (12, 2, 128, 16, 5, True),
    "group7_hd64": (14, 2, 64, 16, 5, False),
    "group7_hd64_int8kv": (14, 2, 64, 16, 5, True),
    "qwen2_7b_28_4": (28, 4, 128, 16, 5, False),
    "page32_int8kv": (4, 2, 128, 32, 5, True),
    "m11_group6_66_rows": (12, 2, 128, 16, 11, False),
}
#: five streams over tables of LONG_SEQ rows: 30 straddles a page of 16 and
#: of 32 (its keys fill two tiles, leaving later splits empty), one is
#: frozen (position 0, zeroed table row), 156 straddles again, 240 reaches
#: the table's last tile, 77 straddles a page of 16 at m = 11
SPLIT_SPEC_POSITIONS = (30, 0, 156, 240, 77)


@pytest.mark.parametrize("case", sorted(SPLIT_SPEC))
def test_spec_kernel_streams_split_the_context(emu, case):
    """Kernel 5 over streams at different positions whose keys are split 3+
    ways across the grid: outputs within tolerance of the plain version,
    written rows within tolerance (int8: 1 LSB), every other row and scale
    of the live pages unchanged."""
    h, kv, hd, page, m, int8kv = SPLIT_SPEC[case]
    maxp = LONG_SEQ // page
    b = len(SPLIT_SPEC_POSITIONS)
    assert emu.call("batch_sweep_splits", b, m, h, kv, LONG_SEQ) >= 3
    rng = np.random.default_rng(100 + h + hd + page + m + int8kv)
    head, tail, shape, written = _spec_case(rng, m=m, h=h, kv=kv, hd=hd, page=page, maxp=maxp,
                                            positions=SPLIT_SPEC_POSITIONS)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, m=m)
    if int8kv:
        pools = _int8_pools(rng, shape)
        want, *pw = DB.attention_paged_spec_step_plain(
            *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
            pools[3].clone(), **kw)
        got, *pg = emu.call("attention_paged_spec_step", *head, pools[0].clone(),
                            pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                            eps=1e-6, residual=True, **kw)
        assert bool(torch.isfinite(got.float()).all())
        assert _rel(got, want) <= 1e-2
        _check_int8_writes(pg, pw, pools, written, f"spec int8 KV over splits, {case}")
        return
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    want, k1, v1 = DB.attention_paged_spec_step_plain(*head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_spec_step", *head, kp.clone(), vp.clone(), *tail,
                           eps=1e-6, residual=True, **kw)
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) <= 1e-2
    assert _rel(k2[1:], k1[1:]) <= 1e-2 and _rel(v2[1:], v1[1:]) <= 1e-2
    assert torch.equal(k2[~written], kp[~written])
    assert torch.equal(v2[~written], vp[~written])


#: case -> (heads, kv_heads, head_dim, page, int8 KV): kernel 3 at the group
#: of 6 at head_dim 128, Qwen2-0.5B's 7 at 64, Qwen2-7B's 28 / 4 heads and
#: page 32, fp and int8 KV
SPLIT_PAGED_BATCH = {
    "group6_hd128": (12, 2, 128, 16, False),
    "group6_hd128_int8kv": (12, 2, 128, 16, True),
    "group7_hd64": (14, 2, 64, 16, False),
    "group7_hd64_int8kv": (14, 2, 64, 16, True),
    "qwen2_7b_28_4": (28, 4, 128, 16, False),
    "page32": (4, 2, 128, 32, False),
    "page32_int8kv": (4, 2, 128, 32, True),
}
#: six streams over tables of LONG_SEQ rows: 30 and 157 mid-page (their
#: context straddles pages and fills a few tiles, leaving later splits
#: empty), a frozen stream (position 0, zeroed table row), a live stream at
#: position 0 (its own page, no context: its row attends itself), the
#: table's last row and 77
SPLIT_PAGED_BATCH_POSITIONS = (30, 0, 0, 157, LONG_SEQ - 1, 77)
SPLIT_PAGED_BATCH_FROZEN = 1


@pytest.mark.parametrize("case", sorted(SPLIT_PAGED_BATCH))
def test_paged_batch_kernel_streams_split_the_context(emu, case):
    """Kernel 3 on the multi-stream sweep, keys split 3+ ways: outputs finite
    and within tolerance of the plain version, written rows within tolerance
    (int8: 1 LSB), every other row and scale of pages 1.. unchanged; the
    frozen stream never reads null page 0, which the frozen and live rows
    race to write."""
    h, kv, hd, page, int8kv = SPLIT_PAGED_BATCH[case]
    positions = torch.tensor(SPLIT_PAGED_BATCH_POSITIONS, dtype=torch.int32)
    b, maxp = positions.shape[0], LONG_SEQ // page
    assert emu.call("batch_sweep_splits", b, 1, h, kv, LONG_SEQ) >= 3
    rng = np.random.default_rng(140 + h + hd + page + int8kv)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, h=h, kv=kv, hd=hd, seq=LONG_SEQ)
    bt = torch.zeros((b, maxp), dtype=torch.int32)
    for i in range(b):
        if i != SPLIT_PAGED_BATCH_FROZEN:
            bt[i] = 1 + i * maxp + torch.arange(maxp, dtype=torch.int32)
    n_pool = 1 + b * maxp
    shape = (n_pool, kv, page, hd)
    written = torch.zeros(shape[:3], dtype=torch.bool)
    for i, p in enumerate(positions.tolist()):
        written[bt[i, p // page], :, p % page] = True
    written[0] = True
    x = _t(rng.standard_normal((b, 64)), BF)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, positions)
    head = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    tail = (wo["int8"], wo["scale"], positions, bt)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd)
    if int8kv:
        pools = _int8_pools(rng, shape)
        want, *pw = DB.attention_paged_batch_step_plain(
            *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
            pools[3].clone(), **kw)
        got, *pg = emu.call("attention_paged_batch_step", *head, pools[0].clone(),
                            pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                            eps=1e-6, residual=True, **kw)
        assert bool(torch.isfinite(got.float()).all())
        assert _rel(got, want) <= 1e-2
        _check_int8_writes(pg, pw, pools, written, f"batch int8 KV over splits, {case}")
        return
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    kp[0] = vp[0] = float("nan")  # a frozen stream that read null page 0 would turn NaN
    want, k1, v1 = DB.attention_paged_batch_step_plain(*head, kp.clone(), vp.clone(), *tail,
                                                       **kw)
    got, k2, v2 = emu.call("attention_paged_batch_step", *head, kp.clone(), vp.clone(), *tail,
                           eps=1e-6, residual=True, **kw)
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) <= 1e-2
    assert _rel(k2[1:], k1[1:]) <= 1e-2 and _rel(v2[1:], v1[1:]) <= 1e-2
    assert torch.equal(k2[~written], kp[~written])
    assert torch.equal(v2[~written], vp[~written])


#: case -> (heads, kv_heads, head_dim)
SPLIT_BATCH = {
    "group2_hd128": (4, 2, 128),
    "group6_hd128": (12, 2, 128),
    "group7_hd64": (14, 2, 64),
    "batch_28_4_heads": (28, 4, 128),
}


@pytest.mark.parametrize("residual", (True, False))
@pytest.mark.parametrize("case", sorted(SPLIT_BATCH))
def test_dense_batch_kernel_streams_split_the_context(emu, case, residual):
    """Kernel 8 over planes of LONG_SEQ rows whose keys are split 3+ ways: an
    idle plane at position 0 (no context: its row attends itself) beside one
    at the last row, S - 1, and two between, every row from each plane's
    position on NaN before the call. Finite outputs within tolerance of the
    plain version, written rows within tolerance, everything else
    bit-unchanged."""
    h, kv, hd = SPLIT_BATCH[case]
    positions = torch.tensor([0, LONG_SEQ - 1, 97, 180], dtype=torch.int32)
    b = positions.shape[0]
    assert emu.call("batch_sweep_splits", b, 1, h, kv, LONG_SEQ) >= 3
    rng = np.random.default_rng(110 + h + hd + residual)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, h=h, kv=kv, hd=hd, seq=LONG_SEQ)
    x = _t(rng.standard_normal((b, 64)), BF)
    kc, vc = _nan_caches(rng, (b, kv, LONG_SEQ, hd), positions)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, positions)
    args = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    tail = (wo["int8"], wo["scale"], positions)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, residual=residual)
    want, k1, v1 = DB.attention_batch_step_plain(*args, kc.clone(), vc.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_batch_step", *args, kc.clone(), vc.clone(), *tail,
                           eps=1e-6, **kw)
    written = torch.zeros((b, kv, LONG_SEQ), dtype=torch.bool)
    written[torch.arange(b), :, positions.long()] = True
    _dense_check(got, want, (k2, v2), (k1, v1), (kc, vc), written)


@pytest.mark.parametrize("kernel", ("attention_paged_spec_step", "attention_batch_step",
                                    "attention_step", "attention_paged_batch_step"))
def test_sweep_wrappers_refuse_unaligned_caches(kernel):
    """The tensor-core sweep copies K/V rows 16 bytes at a time (cp.async):
    a pool or cache that does not start on a 16-byte boundary is refused
    before any launch, as kernels 4 and 10 refuse theirs."""
    rng = np.random.default_rng(130)
    kw = dict(heads=4, kv_heads=2, head_dim=128, eps=1e-6, residual=True, lib=object())

    def unaligned(shape):
        return torch.zeros(int(np.prod(shape)) + 1, dtype=BF)[1:].view(shape)

    if kernel == "attention_paged_batch_step":
        head, (wo, swo, pos, bt), shape, _ = _batch_case(rng)
        with pytest.raises(ValueError, match="k_pool: .* 16-byte aligned"):
            DB._attention_paged_batch_step_kernel(*head, unaligned(shape), unaligned(shape), wo,
                                                  swo, pos, bt, **kw)
        return
    if kernel == "attention_paged_spec_step":
        head, (wo, swo, pos, bt), shape, _ = _spec_case(rng)
        with pytest.raises(ValueError, match="k_pool: .* 16-byte aligned"):
            DB._attention_paged_spec_step_kernel(*head, unaligned(shape), unaligned(shape), wo,
                                                 swo, pos, bt, m=5, **kw)
        return
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng)
    b = 2 if kernel == "attention_batch_step" else 1
    shape = (b, 2, SEQ, 128) if b == 2 else (2, SEQ, 128)
    x = torch.zeros((b, 64), dtype=BF)
    cr, sr = DB.rope_rows(cos_t, sin_t, 3, b)
    where = torch.tensor([3, 5], dtype=torch.int32) if b == 2 else 3
    with pytest.raises(ValueError, match="k_cache: .* 16-byte aligned"):
        getattr(DB, f"_{kernel}_kernel")(x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr,
                                         unaligned(shape), unaligned(shape), wo["int8"],
                                         wo["scale"], where, **kw)


@pytest.mark.parametrize("position", (0, 97, LONG_SEQ - 1))
@pytest.mark.parametrize("case", ("group2_hd128", "group7_hd64"))
def test_dense_step_kernel_splits_the_context(emu, case, position):
    """Kernel 9 (batch-1 decode, one plane, its position a host int) on the
    same sweep as kernel 8, over a LONG_SEQ plane whose keys split 3+ ways:
    no context, mid-plane and the last row, NaN from the position on."""
    h, kv, hd = SPLIT_BATCH[case]
    assert emu.call("batch_sweep_splits", 1, 1, h, kv, LONG_SEQ) >= 3
    rng = np.random.default_rng(120 + h + position)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, h=h, kv=kv, hd=hd, seq=LONG_SEQ)
    x = _t(rng.standard_normal((1, 64)), BF)
    kc, vc = _nan_caches(rng, (kv, LONG_SEQ, hd), position)
    cr, sr = DB.rope_rows(cos_t, sin_t, position)
    args = (x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, residual=True)
    want, k1, v1 = DB.attention_step_plain(*args, kc.clone(), vc.clone(), wo["int8"],
                                           wo["scale"], position, **kw)
    got, k2, v2 = emu.call("attention_step", *args, kc.clone(), vc.clone(), wo["int8"],
                           wo["scale"], position, eps=1e-6, **kw)
    written = torch.zeros((kv, LONG_SEQ), dtype=torch.bool)
    written[:, position] = True
    _dense_check(got, want, (k2, v2), (k1, v1), (kc, vc), written)


@pytest.mark.parametrize("group,hd", [(6, 128), (7, 64)])
@pytest.mark.parametrize("position", (0, 144))
@pytest.mark.parametrize("int8kv", (False, True))
def test_paged_chunk_sweep_groups_and_forms(emu, group, hd, position, int8kv):
    """Kernel 4 at Qwen2-1.5B's group of 6 (head_dim 128) and Qwen2-0.5B's
    7 (head_dim 64), from position 0 and from a later page (the own chunk
    starts inside a 32-key tile, the keys split 3 ways), fp and int8 KV."""
    h, kv = 2 * group, 2
    rng = np.random.default_rng(90 + group + position + int8kv)
    if position:
        assert emu.call("sweep_splits", 0, 32, h, kv, position) == 3
    head, tail, shape, written = _chunk_case(rng, position, h=h, kv=kv, hd=hd, maxp=12)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd)
    if int8kv:
        pools = _int8_pools(rng, shape)
        want, *pw = DB.attention_paged_chunk_step_plain(
            *head, pools[0].clone(), pools[1].clone(), *tail, pools[2].clone(),
            pools[3].clone(), **kw)
        got, *pg = emu.call("attention_paged_chunk_step", *head, pools[0].clone(),
                            pools[1].clone(), *tail, pools[2].clone(), pools[3].clone(),
                            eps=1e-6, residual=True, **kw)
        assert _rel(got, want) <= 1e-2
        _check_int8_writes(pg, pw, pools, written, f"chunk int8 KV, group {group}")
        return
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    want, k1, v1 = DB.attention_paged_chunk_step_plain(
        *head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_chunk_step", *head, kp.clone(), vp.clone(),
                           *tail, eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2, k1) <= 1e-2 and _rel(v2, v1) <= 1e-2
    others = ~written[:, 0, 0]
    assert torch.equal(k2[others], kp[others])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


#: (d, t, causal, strided): D 16 to 128, D 40 not a multiple of 16 (the
#: shared tiles zero-fill each row up to 48); T of 1 and T off the 64-row q
#: tile and the 64-key tile (warps whose rows all lie past T); "unaligned"
#: inputs start 8 bytes past a 16-byte boundary (element loads)
FLASH_CASES = (
    (16, 37, False, False), (16, 37, True, True), (80, 50, False, True),
    (80, 50, True, False), (40, 1, False, False), (40, 1, True, True),
    (40, 70, True, True), (128, 70, False, False), (128, 100, True, False),
    (80, 33, True, "unaligned"),
)


@pytest.mark.parametrize("d,t,causal,strided", FLASH_CASES)
def test_flash_kernel_matches_plain(emu, d, t, causal, strided):
    """The tensor-core flash kernel at every case of FLASH_CASES; strided
    inputs are [B, T, H, D] projections seen as [B, H, T, D] (the vision
    tower's), and the output keeps q's layout."""
    rng = np.random.default_rng(d + t)
    b, h = 2, 3

    def make():
        if strided == "unaligned":
            a = _t(rng.standard_normal(b * h * t * d + 4), BF)
            return a[4:].view(b, h, t, d)
        a = rng.standard_normal((b, t, h, d) if strided else (b, h, t, d))
        a = _t(a, BF)
        return a.transpose(1, 2) if strided else a

    q, k, v = make(), make(), make()
    want = FA.flash_attention_plain(q, k, v, causal)
    got = emu.call("flash_attention", q, k, v, causal=causal)
    assert got.dtype == BF and got.shape == (b, h, t, d) and got.stride() == q.stride()
    assert _rel(got, want) <= 1e-2


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 8, 16), dtype=BF)
    with pytest.raises(ValueError, match="dtype"):
        FA._flash_attention_kernel(q.float(), q.float(), q.float(), lib=object())
    odd = torch.zeros((1, 2, 8, 12), dtype=BF)
    with pytest.raises(ValueError, match="head_dim 12: .* multiples of 8 up to 128"):
        FA._flash_attention_kernel(odd, odd, odd, lib=object())
    wide = torch.zeros((1, 2, 8, 136), dtype=BF)
    with pytest.raises(ValueError, match="head_dim 136"):
        FA._flash_attention_kernel(wide, wide, wide, lib=object())
    with pytest.raises(ValueError, match="shape"):
        FA._flash_attention_kernel(q, q[:, :1], q, lib=object())
    with pytest.raises(ValueError, match="D contiguous"):
        FA._flash_attention_kernel(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3),
                                   lib=object())


def test_dense_wrappers_check_positions_and_refuse_shapes():
    """Positions outside the cache plane, a chunk running past it, and
    shapes or types the kernels do not take raise before any launch."""
    rng = np.random.default_rng(50)
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng)
    kw = dict(heads=4, kv_heads=2, head_dim=128, eps=1e-6, residual=True, lib=object())
    caches = torch.zeros((2, 2, SEQ, 128), dtype=BF)
    plane = torch.zeros((2, SEQ, 128), dtype=BF)

    def batch(positions, kc=caches):
        x = torch.zeros((2, 64), dtype=BF)
        cr, sr = DB.rope_rows_at(cos_t, sin_t, positions.clamp(0, 127))
        DB._attention_batch_step_kernel(x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr,
                                        kc, kc, wo["int8"], wo["scale"], positions, **kw)

    def step(position, x=None, kc=plane):
        x = torch.zeros((1, 64), dtype=BF) if x is None else x
        cr, sr = DB.rope_rows(cos_t, sin_t, max(position, 0), x.shape[0])
        DB._attention_step_kernel(x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr, kc, kc,
                                  wo["int8"], wo["scale"], position, **kw)

    def chunk(position, m=5, heads=4):
        x = torch.zeros((m, 64), dtype=BF)
        cr, sr = DB.rope_rows(cos_t, sin_t, max(position, 0), m)
        DB._attention_chunk_step_kernel(x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr,
                                        plane, plane, wo["int8"], wo["scale"], position,
                                        **dict(kw, heads=heads))

    for bad in ([0, SEQ], [-1, 3]):
        with pytest.raises(ValueError, match="positions must lie"):
            batch(torch.tensor(bad, dtype=torch.int32))
    for bad in (SEQ, -1):
        with pytest.raises(ValueError, match="positions must lie"):
            step(bad)
    with pytest.raises(ValueError, match="positions must lie"):
        chunk(SEQ - 4)
    with pytest.raises(ValueError, match="M >= 1"):
        chunk(0, m=0)
    with pytest.raises(ValueError, match="5 query heads over 2 kv heads: .* whole groups"):
        chunk(0, m=12, heads=5)
    with pytest.raises(ValueError, match="one row"):
        step(3, x=torch.zeros((2, 64), dtype=BF))
    with pytest.raises(ValueError, match="dtype"):
        step(3, kc=plane.float())
    with pytest.raises(ValueError, match="shape"):
        batch(torch.zeros((2,), dtype=torch.int32), kc=torch.zeros((3, 2, SEQ, 128), dtype=BF))
    with pytest.raises(ValueError, match="head_dim 80: .* take head_dim 64 or 128"):
        DB._attention_step_kernel(torch.zeros((1, 64), dtype=BF), nw, None, None, None, None,
                                  None, plane, plane, None, None, 0,
                                  **dict(kw, head_dim=80))
    x = torch.zeros((4, 32), dtype=BF)
    w = quantize_int8(_t(rng.standard_normal((32, 48))))
    with pytest.raises(ValueError, match="dtype"):
        IM._int8_matmul_kernel(x.float(), w["int8"], w["scale"], lib=object())
    with pytest.raises(ValueError, match="shape"):
        IM._int8_matmul_kernel(torch.zeros((4, 33), dtype=BF), w["int8"], w["scale"],
                               lib=object())



# ---------------------------------------------------------------------------
# int4 weights: the int4 form of the tensor-core product (kernels 1-5, 8-10)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1))
def test_emulated_tc_tile4_matches_matmul(emu, seed):
    """The int4 fragment path (one ldmatrix.trans of a 32-row group's packed
    bytes, the low and high nibbles widened to bf16 q by widen_u4_cols, two k
    steps of the even / odd column mma) is the plain product of a 16 x 32 bf16
    tile by the unpacked 32 x 16 q over every byte value (exact products, f32
    sums: within 1e-5)."""
    rng = np.random.default_rng(seed)
    a = _t(rng.standard_normal((16, 32)) * 4, BF)
    w = torch.from_numpy(rng.integers(0, 256, size=(16, 16)).astype(np.uint8))
    q = torch.cat([(w & 15).float() - 8, (w >> 4).float() - 8])  # rows j, then 16 + j
    got = emu.call("tc_tile4", a, w)
    assert got.dtype == torch.float32 and got.shape == (16, 16)
    assert _rel(got, torch.matmul(a.float(), q)) <= 1e-5


def _int4(rng, k, n):
    from dora_tpu_torch.ops.int4 import quantize_int4

    return quantize_int4(_t(rng.standard_normal((k, n))))


#: (m, d, f, bias, residual) -> K splits of (gate/up, down) on int4 weights
#: (groups of 128; decode bands take TcDecode4's 128-deep stages): a 16-row
#: band splits both products at whole groups; a 40-row band on K 128 runs
#: the gate/up product whole with the SwiGLU in its epilogue; a prefill
#: band of 70 rows (64-deep stages) runs it whole and splits the down
#: product over four groups
MLP_INT4_PATHS = {
    (16, 256, 256, True, True): (2, 2),
    (40, 128, 384, False, False): (1, 3),
    (70, 256, 512, True, False): (1, 4),
}


@pytest.mark.parametrize("case", sorted(MLP_INT4_PATHS),
                         ids=lambda c: "m{}_d{}_f{}_b{}_r{}".format(*c))
def test_mlp_int4_paths_match_plain(emu, case):
    """mlp_step on int4 weights (kernel 1's int4 branch): split at group
    boundaries with the partials summed unscaled, and the fused SwiGLU; the
    splits each case takes are asserted first."""
    m, d, f, bias, residual = case
    rng = np.random.default_rng(m + d + f)
    wgu, wd = _int4(rng, d, 2 * f), _int4(rng, f, d)
    groups = (d // wgu["gscale"].shape[0], f // wd["gscale"].shape[0])
    assert emu.call("mlp_splits", m, d, f, *groups) == MLP_INT4_PATHS[case]
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    b = _t(rng.standard_normal(2 * f)) if bias else None
    args = (x, nw, wgu["int4"], wgu["gscale"], b, wd["int4"], wd["gscale"])
    want = DB.mlp_step_plain(*args, residual=residual)
    got = emu.call("mlp_step", *args, eps=1e-6, residual=residual)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("m,d", [(16, 256), (40, 128), (70, 384)])
def test_lm_head_int4_matches_plain(emu, m, d):
    """lm_head_argmax on an int4 head (kernel 2's int4 branch), groups of 128
    over one to three of them, in decode bands of 16 and 64 rows and a
    prefill band: tokens exactly the plain version's, the max logits within
    1e-2."""
    rng = np.random.default_rng(m * d)
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    wh = _int4(rng, d, 300)
    ti, tv = DB.lm_head_argmax_plain(x, nw, wh["int4"], wh["gscale"], return_val=True)
    gi, gv = emu.call("lm_head_argmax", x, nw, wh["int4"], wh["gscale"], eps=1e-6,
                      return_val=True)
    assert torch.equal(gi, ti)
    assert _rel(gv, tv) <= 1e-2


def test_paged_batch_kernel_int4_matches_plain(emu):
    """The paged batch decode (kernel 3) on int4 wqkv (K 256) and wo (K 512),
    groups of 128: its qkv and wo products take the int4 tensor-core product
    into the same partials; outputs and written rows within 1e-2, every other
    pool row bit-unchanged."""
    rng = np.random.default_rng(4)
    d = 256
    head, tail, shape, written = _batch_case(rng, d=d)
    h, kv, hd = 4, 2, 128
    wqkv, wo = _int4(rng, d, (h + 2 * kv) * hd), _int4(rng, h * hd, d)
    head = (head[0], head[1], wqkv["int4"], wqkv["gscale"], *head[4:])
    tail = (wo["int4"], wo["gscale"], *tail[2:])
    kp = _t(rng.standard_normal(shape) * 0.5, BF)
    vp = _t(rng.standard_normal(shape) * 0.5, BF)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd)
    want, k1, v1 = DB.attention_paged_batch_step_plain(
        *head, kp.clone(), vp.clone(), *tail, **kw)
    got, k2, v2 = emu.call("attention_paged_batch_step", *head, kp.clone(), vp.clone(),
                           *tail, eps=1e-6, residual=True, **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2[1:], k1[1:]) <= 1e-2 and _rel(v2[1:], v1[1:]) <= 1e-2
    assert torch.equal(k2[~written], kp[~written])
    assert torch.equal(v2[~written], vp[~written])

if __name__ == "__main__" and sys.argv[1:] == [_WORKER_FLAG]:
    _worker()
