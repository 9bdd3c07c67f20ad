"""The port's parallel tier against dora_tpu's, on the CPU.

In this process: ``make_mesh``'s validation (the JAX package's error
texts), ``shard`` / ``shard_params`` under ``tp_rules`` (each rank's block
equal to the shard JAX places on the same device of its virtual 8-device
mesh, bit for bit), ``maybe_init_distributed``'s reading of the DORA_JAX_*
contract, the fused tp helpers (``_perm_qkv``, ``_perm_gateup``,
``tp_compatible``, ``prepare_decode_params`` and ``shard_caches`` in int8
and int4 equal to JAX's placed shards), and ring / Ulysses at sp 1.

Across ranks: four gloo processes (this file run as a script, with a
``FileStore`` under the test's temporary directory, no TCP port), spawned
once for the module; they run every check and write their results, which
each test then asserts, against (f32, seeded with numpy or by JAX's
``init_params``):

* ``ring_attention`` and ``ulysses_attention`` at sp 2 and 4, causal and
  full: the output and the gradients of q, k, v (this rank's blocks,
  concatenated) equal those of JAX's unsharded dense attention
  (``layers.attention``) within 2e-5 of the largest value (JAX's own ring
  and Ulysses equal it within 2e-5, tests/test_parallel.py; at sp 1 both
  are held to them below);
* ``generate_tp`` at tp 2 in int8 and int4 (a dim-256 model, int4 groups
  of 128), tokens equal to JAX's ``generate_tp``; ``decode_pass_tp`` on a
  5-row chunk, the greedy rows equal to JAX's;
* ``make_train_step`` on dp x tp x sp meshes of 4 ranks (dp 2 x tp 2; tp 2
  x sp 2 ring and Ulysses; dp 2 x sp 2 ring with Adam; sp 4 Ulysses; tp 4
  on a model whose kv heads and vocab do not split, so the gather and
  replication paths run): the loss within rtol 1e-5 of JAX's unsharded
  step and every rank's updated shards within atol 1e-5 + rtol 1e-4 of
  that step's parameters cut by the same rules (SGD at lr 1, so they are
  p - g; Adam at eps 1e-6, as tests/test_torch_train.py explains), each
  shard keeping its shape; ring and Ulysses give the same loss.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

WORLD = 4
TINY = dict(image_size=32, patch_size=8, vision_dim=32, vision_layers=2, vision_heads=2,
            vision_ffn=64, vocab=256, dim=64, layers=2, heads=4, kv_heads=2, ffn=128,
            max_seq=64)
# kv heads (1) and vocab (250) that do not split over tp 4
ODD = dict(TINY, kv_heads=1, vocab=250)
# int4 row shards take whole groups of 128 rows
WIDE = dict(image_size=32, patch_size=8, vision_dim=32, vision_layers=1, vision_heads=2,
            vision_ffn=64, vocab=256, dim=256, layers=1, heads=4, kv_heads=2, ffn=512,
            max_seq=64)
ATTN_SHAPE = (2, 4, 32, 8)
SP_CASES = [(impl, sp, causal) for impl in ("ring", "ulysses") for sp in (2, 4)
            for causal in (False, True)]
DECODE = {"int8": "tiny", "int4": "wide"}  # form: config
MAX_NEW = 6
CHUNK = 5
# name: (config, mesh, sp_impl or None for no ring axis, optimizer, steps)
TRAIN = {
    "dp2_tp2": ("tiny", dict(dp=2, tp=2, sp=1), None, "sgd", 1),
    "tp2_sp2_ring": ("tiny", dict(dp=1, tp=2, sp=2), "ring", "sgd", 1),
    "tp2_sp2_ulysses": ("tiny", dict(dp=1, tp=2, sp=2), "ulysses", "sgd", 1),
    "dp2_sp2_ring_adam": ("tiny", dict(dp=2, tp=1, sp=2), "ring", "adam", 3),
    "sp4_ulysses": ("tiny", dict(dp=1, tp=1, sp=4), "ulysses", "sgd", 1),
    "tp4_odd": ("odd", dict(dp=1, tp=4, sp=1), None, "sgd", 1),
}
CONFIGS = {"tiny": TINY, "odd": ODD, "wide": WIDE}
RANK_TIMEOUT_S = 240


def _flat(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _unflat(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _optimizer(which: str):
    if which == "sgd":
        return functools.partial(torch.optim.SGD, lr=1.0)
    return functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6)


# ---------------------------------------------------------------------------
# the ranks' side: this file run as a script, no jax
# ---------------------------------------------------------------------------


def _rank_attention(data, out):
    from dora_tpu_torch.parallel import make_mesh, ring_attention, ulysses_attention

    q, k, v, g = (data[f"attn/{n}"] for n in "qkvg")
    meshes = {sp: make_mesh(dp=WORLD // sp, sp=sp) for sp in (2, 4)}
    for impl, sp, causal in SP_CASES:
        mesh = meshes[sp]
        n = q.shape[2] // sp
        at = slice(mesh.index("sp") * n, (mesh.index("sp") + 1) * n)
        ins = [torch.from_numpy(np.ascontiguousarray(a[:, :, at])).requires_grad_()
               for a in (q, k, v)]
        fn = ring_attention if impl == "ring" else ulysses_attention
        o = fn(*ins, mesh, causal=causal)
        (o * torch.from_numpy(np.ascontiguousarray(g[:, :, at]))).sum().backward()
        key = f"attn/{impl}/{sp}/{causal}"
        out[f"{key}/out"] = o.detach().numpy()
        for name, t in zip("qkv", ins):
            out[f"{key}/d{name}"] = t.grad.numpy()


def _rank_decode(data, out):
    from dora_tpu_torch.models import layers as L
    from dora_tpu_torch.models import vlm
    from dora_tpu_torch.parallel import fused_tp as FTP
    from dora_tpu_torch.parallel import make_mesh
    from dora_tpu_torch.ops import decode_block as DB

    mesh = make_mesh(dp=2, tp=2)
    for form, which in DECODE.items():
        cfg = vlm.VLMConfig(**CONFIGS[which])
        params = vlm.params_from_jax(_unflat(data, f"params/{which}"), device="cpu")
        if form == "int4":
            os.environ["DORA_INT4_DECODE"] = "1"
        try:
            qp = vlm.quantize_decode(params)
        finally:
            os.environ.pop("DORA_INT4_DECODE", None)
        tp_params = FTP.prepare_decode_params(qp, mesh, heads=cfg.heads, kv_heads=cfg.kv_heads,
                                              head_dim=cfg.head_dim, layers=cfg.layers)
        image = torch.from_numpy(data["decode/image"])
        prompt = torch.from_numpy(data["decode/prompt"])
        out[f"decode/{form}/tokens"] = vlm.generate_tp(qp, tp_params, cfg, image, prompt,
                                                       MAX_NEW, mesh).numpy()
        if form == "int8":
            _, caches, position = vlm.prefill(qp, cfg, image, prompt)
            caches = FTP.shard_caches(caches, mesh)
            cos_t, sin_t = L.rope_table(cfg.max_seq, cfg.head_dim, device="cpu")
            cos, sin = DB.rope_rows(cos_t, sin_t, position, CHUNK)
            greedy, _ = FTP.decode_pass_tp(
                tp_params, vlm._embed(qp, torch.from_numpy(data["decode/chunk"][0])), caches,
                position, cos, sin, heads=cfg.heads, kv_heads=cfg.kv_heads,
                head_dim=cfg.head_dim, layers=cfg.layers, mesh=mesh)
            out["decode/int8/chunk"] = greedy.numpy()


def _rank_train(data, out):
    from dora_tpu_torch.models import layers as L
    from dora_tpu_torch.models import vlm
    from dora_tpu_torch.parallel import make_mesh, shard_params

    batch = {"images": data["batch/images"], "tokens": data["batch/tokens"]}
    for name, (which, shape, impl, opt, steps) in TRAIN.items():
        cfg = vlm.VLMConfig(**CONFIGS[which])
        mesh = make_mesh(**shape)
        params = shard_params(vlm.params_from_jax(_unflat(data, f"params/{which}"), device="cpu"),
                              mesh, L.tp_rules())
        state = vlm.init_opt_state(_optimizer(opt), params)
        step = vlm.make_train_step(cfg, _optimizer(opt), mesh=mesh,
                                   ring_axis="sp" if impl else None, sp_impl=impl)
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
        out[f"train/{name}/loss"] = np.asarray(losses)
        out.update(_flat(params, f"train/{name}/p"))


def _rank_main(root: str, rank: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=WORLD)
    data = dict(np.load(os.path.join(root, "inputs.npz")))
    out: dict = {}
    _rank_attention(data, out)
    _rank_decode(data, out)
    _rank_train(data, out)
    np.savez(os.path.join(root, f"out_{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    _rank_main(sys.argv[1], int(sys.argv[2]))
    sys.exit(0)


# ---------------------------------------------------------------------------
# this process: the JAX references and the checks
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dora_tpu.models import layers as JL  # noqa: E402
from dora_tpu.models import vlm as jvlm  # noqa: E402
from dora_tpu.parallel import fused_tp as JFTP  # noqa: E402
from dora_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from dora_tpu.parallel import ring_attention as jax_ring  # noqa: E402
from dora_tpu.parallel import shard as jax_shard  # noqa: E402
from dora_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from dora_tpu.parallel import ulysses_attention as jax_ulysses  # noqa: E402
from dora_tpu_torch.models import layers as TL  # noqa: E402
from dora_tpu_torch.models import vlm as tvlm  # noqa: E402
from dora_tpu_torch.parallel import Mesh, make_mesh, shard, shard_params  # noqa: E402
from dora_tpu_torch.parallel import fused_tp as TFTP  # noqa: E402


def _close(got, want, atol, rtol=0.0, what="", relative=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if relative else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


# jitted here: the eager forms of these JAX functions trace op by op (the
# decode path's Pallas kernels in the interpreter), several times slower
_init = jax.jit(jvlm.init_params, static_argnums=1)
_quantize = jax.jit(jvlm.quantize_decode)  # reads DORA_INT4_DECODE when it traces
_generate_tp = jax.jit(jvlm.generate_tp, static_argnums=(2, 5, 6))
_prefill = jax.jit(jvlm.prefill, static_argnums=1)
_decode_pass_tp = jax.jit(JFTP.decode_pass_tp, static_argnames=(
    "heads", "kv_heads", "head_dim", "layers", "mesh"))


@functools.lru_cache(maxsize=None)
def _jax_params(which: str):
    return _init(jax.random.PRNGKey(0), jvlm.VLMConfig(**CONFIGS[which]))


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    data = {f"attn/{n}": rng.standard_normal(ATTN_SHAPE).astype(np.float32) for n in "qkvg"}
    data["batch/images"] = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    data["batch/tokens"] = rng.integers(0, ODD["vocab"], (2, 16)).astype(np.int32)
    data["decode/image"] = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    data["decode/prompt"] = rng.integers(0, TINY["vocab"], (1, 6)).astype(np.int32)
    data["decode/chunk"] = rng.integers(0, TINY["vocab"], (1, CHUNK)).astype(np.int32)
    for which in CONFIGS:
        data.update(_flat(_jax_params(which), f"params/{which}"))
    return data


@functools.lru_cache(maxsize=None)
def _jax_quantized(which: str, int4: bool):
    """JAX's quantize_decode of a config's params; each (config, form) pair
    has its own shapes, so its own trace under its own DORA_INT4_DECODE."""
    params = _jax_params(which)
    if int4:
        os.environ["DORA_INT4_DECODE"] = "1"
    try:
        return _quantize(params)
    finally:
        os.environ.pop("DORA_INT4_DECODE", None)


def _jax_refs(data) -> dict:
    refs = {}
    q, k, v, g = (jnp.asarray(data[f"attn/{n}"]) for n in "qkvg")
    for causal in (False, True):  # the unsharded dense attention, its output and gradients

        def loss(q, k, v, causal=causal):
            t = q.shape[2]
            out = JL.attention(q, k, v, JL.causal_mask(t, t) if causal else None)
            return jnp.sum(out * g), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        refs[f"attn/{causal}/out"] = np.asarray(out)
        for name, gr in zip("qkv", grads):
            refs[f"attn/{causal}/d{name}"] = np.asarray(gr)
    mesh = jax_mesh(tp=2, devices=jax.devices()[:2])
    image, prompt = jnp.asarray(data["decode/image"]), jnp.asarray(data["decode/prompt"])
    for form, which in DECODE.items():
        cfg = jvlm.VLMConfig(**CONFIGS[which])
        qp = _jax_quantized(which, form == "int4")
        tp_params = JFTP.prepare_decode_params(qp, mesh, heads=cfg.heads, kv_heads=cfg.kv_heads,
                                               head_dim=cfg.head_dim, layers=cfg.layers)
        refs[f"decode/{form}/tokens"] = np.asarray(
            _generate_tp(qp, tp_params, cfg, image, prompt, MAX_NEW, mesh))
        if form == "int8":
            from dora_tpu.ops import decode_block as JDB

            _, caches, position = _prefill(qp, cfg, image, prompt)
            position = int(position)
            cos_t, sin_t = JL.rope_table(cfg.max_seq, cfg.head_dim)
            cos, sin = JDB.rope_rows(cos_t, sin_t, position, CHUNK)
            chunk = jnp.asarray(data["decode/chunk"][0])
            greedy, _ = _decode_pass_tp(
                tp_params, qp["embed"][chunk].astype(JL.compute_dtype()),
                JFTP.shard_caches(caches, mesh), jnp.asarray(position, jnp.int32), cos, sin,
                heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
                layers=cfg.layers, mesh=mesh)
            refs["decode/int8/chunk"] = np.asarray(greedy)
    import optax

    batch = {"images": jnp.asarray(data["batch/images"]),
             "tokens": jnp.asarray(data["batch/tokens"])}
    runs = {}
    for name, (which, _, _, opt, steps) in TRAIN.items():
        if (which, opt, steps) not in runs:
            cfg = jvlm.VLMConfig(**CONFIGS[which])
            optimizer = optax.sgd(1.0) if opt == "sgd" else optax.adam(1e-3, eps=1e-6)
            p = _jax_params(which)
            state = optimizer.init(p)
            step = jvlm.make_train_step(cfg, optimizer)
            losses = []
            for _ in range(steps):
                p, state, loss = step(p, state, batch)
                losses.append(float(loss))
            runs[which, opt, steps] = (np.asarray(losses),
                                       jax.tree.map(np.asarray, p))
        refs[f"train/{name}"] = runs[which, opt, steps]
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks, compute the JAX references while they run, and
    return (references, each rank's results)."""
    root = tmp_path_factory.mktemp("ranks")
    data = _inputs()
    np.savez(root / "inputs.npz", **data)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(root), str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        refs = _jax_refs(data)
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        pytest.fail("ranks " + ", ".join(map(str, failed)) + " failed:\n"
                    + "\n".join(f"--- rank {r}\n{logs[r][-3000:]}" for r in failed))
    return refs, [dict(np.load(root / f"out_{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,sp,causal", SP_CASES,
                         ids=[f"{i}-sp{s}-{'causal' if c else 'full'}" for i, s, c in SP_CASES])
def test_sequence_parallel_attention_matches_jax(ranks, impl, sp, causal):
    """Ranks 0 .. sp-1 hold the sp blocks of the first dp replica; their
    blocks, concatenated, are JAX's dense output and gradients."""
    refs, outs = ranks
    key = f"attn/{impl}/{sp}/{causal}"
    for part in ("out", "dq", "dk", "dv"):
        got = np.concatenate([outs[r][f"{key}/{part}"] for r in range(sp)], axis=2)
        _close(got, refs[f"attn/{causal}/{part}"], atol=2e-5, what=f"{key}/{part}")
    # the other replica computed the same blocks
    for r in range(sp, WORLD):
        np.testing.assert_array_equal(outs[r][f"{key}/out"], outs[r % sp][f"{key}/out"])


@pytest.mark.parametrize("form", list(DECODE))
def test_generate_tp_matches_jax(ranks, form):
    refs, outs = ranks
    want = refs[f"decode/{form}/tokens"]
    assert want.shape == (1, MAX_NEW)
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r][f"decode/{form}/tokens"], want)


def test_decode_pass_tp_chunk_matches_jax(ranks):
    refs, outs = ranks
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r]["decode/int8/chunk"], refs["decode/int8/chunk"])


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_step_matches_jax(ranks, name):
    refs, outs = ranks
    which, shape, _, _, _ = TRAIN[name]
    want_losses, want = refs[f"train/{name}"]
    grid = np.arange(WORLD).reshape(shape["dp"], shape["tp"], shape["sp"])
    full = tvlm.params_from_jax(want, device="cpu")
    for r in range(WORLD):
        np.testing.assert_allclose(outs[r][f"train/{name}/loss"], want_losses, rtol=1e-5)
        cut = _flat(shard_params(full, Mesh(grid, r), TL.tp_rules()), f"train/{name}/p")
        assert set(cut) == {k for k in outs[r] if k.startswith(f"train/{name}/p/")}
        for key, w in cut.items():
            _close(outs[r][key], w, atol=1e-5, rtol=1e-4, relative=False, what=f"rank {r} {key}")


def test_shards_keep_their_shapes(ranks):
    """tp 2: wq, w_gate, the patch projection and the head hold half their
    columns, wo and the embedding half their rows, norms all of theirs."""
    _, outs = ranks
    p = "train/dp2_tp2/p"
    out = outs[0]
    assert out[f"{p}/blocks/0/wq"].shape == (64, 32)
    assert out[f"{p}/blocks/0/wo"].shape == (32, 64)
    assert out[f"{p}/blocks/0/w_gate"].shape == (64, 64)
    assert out[f"{p}/embed"].shape == (128, 64)
    assert out[f"{p}/lm_head"].shape == (64, 128)
    assert out[f"{p}/vision/patch_proj"].shape == (192, 16)
    assert out[f"{p}/blocks/0/attn_norm"].shape == (64,)
    odd = "train/tp4_odd/p"
    assert out[f"{odd}/embed"].shape == (250, 64)  # 250 rows do not split over 4
    assert out[f"{odd}/blocks/0/wk"].shape == (64, 4)  # one kv head's 16 columns over 4


def test_ring_and_ulysses_train_to_the_same_loss(ranks):
    _, outs = ranks
    for r in range(WORLD):
        np.testing.assert_allclose(outs[r]["train/tp2_sp2_ulysses/loss"],
                                   outs[r]["train/tp2_sp2_ring/loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


def test_make_mesh_one_rank_and_jax_error_texts():
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1, "sp": 1} and mesh.rank == 0
    assert make_mesh(dp=-1).shape["dp"] == 1
    one = jax.devices()[:1]
    for kw in (dict(dp=3), dict(dp=-1, tp=2), dict(tp=2, sp=2)):
        with pytest.raises(ValueError) as want:
            jax_mesh(devices=one, **kw)
        with pytest.raises(ValueError) as got:
            make_mesh(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs torch.distributed"):
        make_mesh(dp=2, devices=[0, 1])


def test_placement_mesh_coordinates():
    grid = np.arange(8).reshape(2, 2, 2)
    mesh = Mesh(grid, 6)
    assert mesh.coords == {"dp": 1, "tp": 1, "sp": 0}
    assert mesh.size("tp") == 2 and mesh.index("sp") == 0
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("tp")
    with pytest.raises(ValueError, match="not on the mesh"):
        Mesh(grid, 9)


def _jax_spec(spec) -> tuple:
    return tuple(spec)


def test_tp_rules_match_jax():
    assert [(n, _jax_spec(s)) for n, s in JL.tp_rules()] == TL.tp_rules()


def test_shard_params_matches_jax_placement():
    """Each of the eight devices' shard of JAX's placed tree is the block the
    port's shard_params gives the rank at that grid position."""
    jp = _jax_params("tiny")
    jmesh = jax_mesh(dp=2, tp=2, sp=2)
    placed = jax_shard_params(jp, jmesh, JL.tp_rules())
    tparams = tvlm.params_from_jax(jp, device="cpu")
    grid = np.arange(8).reshape(2, 2, 2)
    devices = {d.id: pos for pos, d in np.ndenumerate(jmesh.devices)}
    flat_placed = _flat_jax(placed, "")
    for rank in range(8):
        mine = _flat(shard_params(tparams, Mesh(grid, rank), TL.tp_rules()), "")
        assert set(mine) == set(flat_placed)
        for key, arr in flat_placed.items():
            (shard,) = [s for s in arr.addressable_shards
                        if grid[devices[s.device.id]] == rank]
            np.testing.assert_array_equal(mine[key], np.asarray(shard.data), err_msg=key)


def _flat_jax(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_jax(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_shard_params_rules_as_jax():
    """JAX's own cases: exact leaf names, replication where a dimension does
    not tile, and tuple axes splitting over their product."""
    grid8 = np.arange(8).reshape(2, 4, 1)
    params = {"embed": torch.ones(32, 16), "vision": {"pos_embed": torch.ones(196, 16)},
              "blocks": {"0": {"attn_q": torch.ones(16, 16), "norm": torch.ones(16)}}}
    placed = shard_params(params, Mesh(grid8, 5), [("attn_q", (None, "tp")), ("embed", ("tp", None))])
    assert placed["blocks"]["0"]["attn_q"].shape == (16, 4)
    assert placed["embed"].shape == (8, 16)
    assert placed["vision"]["pos_embed"].shape == (196, 16)
    assert placed["blocks"]["0"]["norm"].shape == (16,)
    odd = shard_params({"embed": torch.ones(51865, 16), "w_up": torch.ones(16, 64)},
                       Mesh(np.arange(8).reshape(1, 8, 1), 3),
                       [("embed", ("tp", None)), ("w_up", (None, "tp"))])
    assert odd["embed"].shape == (51865, 16) and odd["w_up"].shape == (16, 8)
    mesh = Mesh(np.arange(8).reshape(4, 2, 1), 5)  # dp 2, tp 1: block 2 * 2 + 1
    w = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    got = shard_params({"w": w}, mesh, [("w", (("dp", "tp"), None))])["w"]
    torch.testing.assert_close(got, w[5:6])
    assert shard_params({"w": torch.ones(4, 16)}, mesh,
                        [("w", (("dp", "tp"), None))])["w"].shape == (4, 16)


def test_shard_matches_jax():
    x = np.arange(2 * 3 * 8 * 4, dtype=np.float32).reshape(2, 3, 8, 4)
    jmesh = jax_mesh(dp=1, tp=1, sp=8)
    placed = jax_shard(jnp.asarray(x), jmesh, None, None, "sp", None)
    for s in placed.addressable_shards:
        rank = int(np.argwhere(jmesh.devices == s.device)[0][2])
        got = shard(torch.from_numpy(x), Mesh(np.arange(8).reshape(1, 1, 8), rank),
                    None, None, "sp", None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))


def test_maybe_init_distributed_reads_the_contract(monkeypatch):
    import torch.distributed as dist

    from dora_tpu_torch.parallel import distributed as D

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(calls))
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    for name in ("DORA_JAX_COORDINATOR", "DORA_JAX_NUM_PROCESSES", "DORA_JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert D.maybe_init_distributed("cpu") is False and not calls
    monkeypatch.setenv("DORA_JAX_COORDINATOR", "10.0.0.7:1234")
    monkeypatch.setenv("DORA_JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("DORA_JAX_PROCESS_ID", "2")
    assert D.maybe_init_distributed("cpu") is True
    assert calls == [(("gloo",), dict(init_method="tcp://10.0.0.7:1234", world_size=4, rank=2))]
    assert D.maybe_init_distributed("cpu") is True and len(calls) == 1  # idempotent


def test_distributed_defaults_to_the_card(monkeypatch):
    """Without a card the default device refuses (no silent gloo); a
    process outside a distributed run gets a one-rank global mesh."""
    import torch.distributed as dist

    from dora_tpu_torch.parallel import distributed as D

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DORA_JAX_COORDINATOR", "10.0.0.7:1234")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.maybe_init_distributed()
    assert not calls
    monkeypatch.delenv("DORA_JAX_COORDINATOR")
    assert D.global_mesh(device="cpu").shape == {"dp": 1, "tp": 1, "sp": 1}


def test_fused_tp_helpers_match_jax():
    for args in ((4, 2, 16, 2), (12, 2, 128, 2), (8, 8, 16, 8)):
        np.testing.assert_array_equal(TFTP._perm_qkv(*args), JFTP._perm_qkv(*args))
    for args in ((128, 2), (8960, 2), (256, 8)):
        np.testing.assert_array_equal(TFTP._perm_gateup(*args), JFTP._perm_gateup(*args))
    for tp, kw in ((8, dict(heads=12, kv_heads=2, ffn=8960, vocab=151936)),
                   (2, dict(heads=12, kv_heads=2, ffn=8960, vocab=151936)),
                   (1, dict(heads=12, kv_heads=2, ffn=8960, vocab=151936)),
                   (4, dict(heads=4, kv_heads=1, ffn=128, vocab=250))):
        assert TFTP.tp_compatible(tp, **kw) == JFTP.tp_compatible(tp, **kw)
    assert TFTP.tp_degree(None) == 1 and TFTP.tp_degree(Mesh(np.arange(4).reshape(1, 4, 1), 0)) == 4


@pytest.mark.parametrize("form", list(DECODE))
def test_prepare_decode_params_and_caches_match_jax(form):
    """Rank r's tree is the shard JAX places on device r of a tp 2 mesh."""
    cfg = jvlm.VLMConfig(**CONFIGS[DECODE[form]])
    qp = _jax_quantized(DECODE[form], form == "int4")
    jmesh = jax_mesh(tp=2, devices=jax.devices()[:2])
    kw = dict(heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, layers=cfg.layers)
    placed = _flat_jax(JFTP.prepare_decode_params(qp, jmesh, **kw), "")
    tq = tvlm.params_from_jax(qp, device="cpu")
    rng = np.random.default_rng(4)
    caches = {str(i): {n: rng.standard_normal((1, cfg.kv_heads, 8, cfg.head_dim)).astype(np.float32)
                       for n in "kv"} for i in range(cfg.layers)}
    jcaches = _flat_jax(JFTP.shard_caches(jax.tree.map(jnp.asarray, caches), jmesh), "")
    for rank, device in enumerate(jax.devices()[:2]):
        mesh = Mesh(np.arange(2).reshape(1, 2, 1), rank)
        mine = _flat(TFTP.prepare_decode_params(tq, mesh, **kw), "")
        assert set(mine) == set(placed)
        for key, arr in placed.items():
            (s,) = [s for s in arr.addressable_shards if s.device == device]
            np.testing.assert_array_equal(mine[key], np.asarray(s.data), err_msg=key)
        mine = _flat(TFTP.shard_caches({i: {n: torch.from_numpy(a) for n, a in c.items()}
                                        for i, c in caches.items()}, mesh), "")
        for key, arr in jcaches.items():
            (s,) = [s for s in arr.addressable_shards if s.device == device]
            np.testing.assert_array_equal(mine[key], np.asarray(s.data), err_msg=key)


def test_int4_row_groups_refused_as_jax():
    w = torch.zeros((64, 8), dtype=torch.uint8)  # K 128
    s = torch.ones((1, 8))  # one group of 128 rows
    with pytest.raises(ValueError) as got:
        TFTP._check_row_groups(w, s, 2, "blocks.0.wo")
    with pytest.raises(ValueError) as want:
        JFTP._check_row_groups(np.zeros((64, 8), np.uint8), np.ones((1, 8)), 2, "blocks.0.wo")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_and_ulysses_at_sp1_are_jax_dense(causal):
    from dora_tpu_torch.parallel import ring_attention, ulysses_attention

    q = np.random.default_rng(1).standard_normal((1, 2, 16, 8)).astype(np.float32)
    jmesh = jax_mesh(dp=8)
    mesh = make_mesh()
    for ours, theirs in ((ring_attention, jax_ring), (ulysses_attention, jax_ulysses)):
        want = np.asarray(theirs(*(jnp.asarray(q),) * 3, jmesh, causal=causal))
        got = ours(*(torch.from_numpy(q),) * 3, mesh, causal=causal)
        _close(got.numpy(), want, atol=2e-6, what=ours.__name__)


def test_ulysses_rejects_indivisible_heads_as_jax():
    from dora_tpu_torch.parallel import ulysses_attention

    q = torch.zeros((1, 6, 8, 8))  # 6 heads over sp 8
    with pytest.raises(ValueError) as got:
        ulysses_attention(q, q, q, Mesh(np.arange(8).reshape(1, 1, 8), 0))
    with pytest.raises(ValueError) as want:
        jax_ulysses(jnp.zeros((1, 6, 64, 8)), jnp.zeros((1, 6, 64, 8)), jnp.zeros((1, 6, 64, 8)),
                    jax_mesh(sp=8))
    assert str(got.value) == str(want.value)
