"""The port's detectors against dora_tpu's, on the CPU, in f32.

* The self-contained detector (``DetectorConfig.tiny``) on a JAX parameter
  tree of ``init_params``' shapes (seeded numpy values) carried over by
  ``detection.params_from_jax`` (HWIO -> OIHW): ``forward`` within 1e-4 rel
  RMS; ``postprocess`` on the same predictions with classes, kept set and
  order exact, boxes and scores within 1e-6 of the largest value; the
  greedy suppression on crafted overlapping boxes and the order of zero
  and equal scores exact.
* YOLOS in both ``use_mid_position_embeddings`` forms, on the tiny
  checkpoint ``transformers`` builds offline: the tree value for value,
  ``forward`` within 1e-4 rel RMS, ``detect`` at threshold 0 and at 0.5
  (every score zeroed, so the rows come back in index order, as
  ``lax.top_k`` returns ties) with classes and order exact; on an image
  whose sides are not whole patches (which the JAX package's reshape
  refuses), ``forward`` within 1e-4 rel RMS of the transformers model,
  whose patch convolution drops the remainder.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models import detection as jdet
from dora_tpu.models.hf import yolos as jyolos
from dora_tpu_torch.models import detection as tdet
from dora_tpu_torch.models.hf import yolos as tyolos

transformers = pytest.importorskip("transformers")

REL_RMS = 1e-4  # f32 floats: the products and convolutions sum in another order


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_rms(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _same_detections(got, want, tol=1e-6):
    """Classes and scores' order exact; floats within ``tol`` of the
    largest value."""
    assert set(got) == set(want)
    np.testing.assert_array_equal(_np(got["classes"]), _np(want["classes"]))
    assert _np(got["classes"]).dtype == np.int32
    for key in ("scores", "boxes"):
        g, w = _np(got[key]), _np(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=key)
    # the same rows are zero (suppressed or under the threshold)
    np.testing.assert_array_equal(_np(got["scores"]) == 0, _np(want["scores"]) == 0)


@pytest.fixture(scope="module")
def detector():
    """The JAX package's parameter tree (``init_params``'s shapes, seeded
    numpy values: its jax.random draws compile op by op) and the port's."""
    cfg = jdet.DetectorConfig.tiny()
    rng = np.random.default_rng(3)
    jparams = jax.tree.map(lambda s: rng.uniform(-0.5, 0.5, s.shape).astype(np.float32),
                           jax.eval_shape(lambda: jdet.init_params(jax.random.PRNGKey(3), cfg)))
    return cfg, jparams, tdet.params_from_jax(jparams, device="cpu")


@jax.jit
def _jax_detect(params, images):
    cfg = jdet.DetectorConfig.tiny()
    preds = jdet.forward(params, cfg, images)
    return preds, jax.vmap(lambda p: jdet.postprocess(cfg, p))(preds)


def test_detector_forward_and_detect_match(detector):
    cfg, jparams, tparams = detector
    assert tdet.DetectorConfig.tiny() == tdet.DetectorConfig(**vars(cfg))
    images = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want, ref = _jax_detect(jparams, jnp.asarray(images))
    want = np.array(want)
    got = tdet.forward(tparams, cfg, torch.from_numpy(images))
    assert got.dtype == torch.float32 and _rel_rms(got, want) < REL_RMS
    # postprocess on the same predictions, one image and the batch
    batched = tdet.postprocess(cfg, torch.from_numpy(want))
    _same_detections(batched, ref)
    for b in range(2):
        _same_detections(tdet.postprocess(cfg, torch.from_numpy(want[b])),
                         {k: np.asarray(v)[b] for k, v in ref.items()})
    full = tdet.detect(tparams, cfg, torch.from_numpy(images))
    _same_detections(full, ref, tol=1e-4)


def _cells(rows, n_classes=4, cells=20):
    """Predictions [cells, 5 + C]: each row (cx, cy, w, h, obj, class,
    class logit); the other cells far below the threshold."""
    pred = np.full((cells, 5 + n_classes), -6.0, np.float32)
    pred[:, :4] = [5.0, 5.0, 1.0, 1.0]
    for i, (cx, cy, w, h, obj, cls, logit) in enumerate(rows):
        pred[i, :5] = [cx, cy, w, h, obj]
        pred[i, 5 + cls] = logit
    return pred


@pytest.mark.parametrize("case", ["nms", "ties"])
def test_postprocess_suppression_and_tie_order(case):
    cfg = jdet.DetectorConfig.tiny()  # K = 10, IoU 0.45, threshold 0.25
    if case == "nms":
        pred = _cells([
            (10, 10, 8, 8, 3.0, 1, 3.0),    # kept
            (11, 10, 8, 8, 2.5, 1, 3.0),    # overlaps the first, same class: suppressed
            (11, 10, 8, 8, 2.4, 2, 3.0),    # same place, another class: kept
            (30, 30, 8, 8, 2.0, 1, 3.0),    # far away: kept
            (30.5, 30, 8, 8, 1.5, 2, 3.0),  # overlaps the fourth, another class: kept
            (31, 30, 8, 8, 1.0, 1, 3.0),    # overlaps the fourth: suppressed
            (12, 12, 8, 8, -3.0, 1, 3.0),   # under the threshold
        ])
    else:
        # equal scores at rows 2, 5 and 9 and the rest equal and tiny: both
        # stacks must return them lowest index first
        pred = _cells([(10 + 5 * i, 10, 2, 2, 2.0 if i in (2, 5, 9) else -6.0, i % 4, 3.0)
                       for i in range(12)])
    want = jdet.postprocess(cfg, jnp.asarray(pred))
    got = tdet.postprocess(cfg, torch.from_numpy(pred))
    _same_detections(got, want)
    kept = np.flatnonzero(_np(got["scores"]))
    assert len(kept) == (4 if case == "nms" else 3)
    # the crafted boxes came back in score order, ties by index
    order = _np(tdet.top_k(torch.from_numpy(pred[:, 4]), cfg.max_detections)[1])
    np.testing.assert_array_equal(order, np.asarray(jax.lax.top_k(jnp.asarray(pred[:, 4]),
                                                                  cfg.max_detections)[1]))


def test_top_k_orders_ties_as_lax():
    scores = np.random.default_rng(1).integers(0, 4, size=(3, 40)).astype(np.float32) / 4
    for k in (1, 7, 40):
        values, idx = tdet.top_k(torch.from_numpy(scores), k)
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(_np(idx), np.asarray(ji))
        np.testing.assert_array_equal(_np(values), np.asarray(jv))


@pytest.fixture(scope="module", params=[True, False], ids=["mid-pos", "no-mid-pos"])
def yolos_dir(request, tmp_path_factory):
    from transformers import YolosConfig, YolosForObjectDetection

    config = YolosConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        image_size=[32, 48], patch_size=8, num_detection_tokens=5, num_labels=7,
        qkv_bias=True, use_mid_position_embeddings=request.param,
        attn_implementation="eager",
    )
    torch.manual_seed(17)
    path = tmp_path_factory.mktemp("yolos-torch")
    model = YolosForObjectDetection(config).eval()
    model.save_pretrained(path, safe_serialization=True)
    return path, request.param, model


def _walk(j, t, path=""):
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for key in j:
            _walk(j[key], t[key], f"{path}/{key}")
    else:
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32), err_msg=path)


def test_yolos_matches(yolos_dir):
    path, mid, _ = yolos_dir
    jcfg, jparams = jyolos.load(path)
    tcfg, tparams = tyolos.load(path, device="cpu")
    assert tcfg == tyolos.YolosConfig(**vars(jcfg)) and tcfg.use_mid_pos == mid
    assert ("mid_pos" in tparams) == mid
    _walk(jparams, tparams)

    rng = np.random.default_rng(18)
    pixels = rng.normal(size=(2, 3, 32, 48)).astype(np.float32)
    jl, jb = jyolos.forward(jparams, jcfg, jyolos.nchw(pixels))
    tl, tb = tyolos.forward(tparams, tcfg, tyolos.nchw(torch.from_numpy(pixels)))
    assert _rel_rms(tl, jl) < REL_RMS and _rel_rms(tb, jb) < REL_RMS

    frames = rng.uniform(size=(1, 32, 48, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tyolos.preprocess(torch.from_numpy(frames), tcfg)),
                               np.asarray(jyolos.preprocess(frames, jcfg)), rtol=0, atol=1e-6)
    for threshold, top_k in ((0.0, 5), (0.0, 3), (0.5, 5)):
        want = jyolos.detect(jparams, jcfg, jyolos.nchw(pixels), threshold, top_k)
        got = tyolos.detect(tparams, tcfg, tyolos.nchw(torch.from_numpy(pixels)), threshold,
                            top_k)
        _same_detections(got, want, tol=1e-4)
        if threshold == 0.5:  # every score zeroed: the rows in index order
            assert not _np(got["scores"]).any()


def test_yolos_drops_partial_patches_as_the_checkpoint(yolos_dir):
    path, _, model = yolos_dir
    cfg, params = tyolos.load(path, device="cpu")
    pixels = np.random.default_rng(19).normal(size=(1, 3, 37, 53)).astype(np.float32)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(pixels))
    logits, boxes = tyolos.forward(params, cfg, tyolos.nchw(torch.from_numpy(pixels)))
    assert _rel_rms(logits, want.logits) < REL_RMS and _rel_rms(boxes, want.pred_boxes) < REL_RMS
