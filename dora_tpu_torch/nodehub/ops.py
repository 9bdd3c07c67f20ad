"""Operator factories of the model zoo for the port's runtime
(dora_tpu/nodehub/ops.py): ``make_detector``, ``make_vlm``, ``make_asr``,
``make_translator``, ``make_tts`` and ``make_vad``, each a
:class:`TorchOperator` whose weights live in its state on the device. A dataflow names them as ``--operator <id>=dora_tpu_torch.nodehub.ops:make_*``
arguments of ``module:dora_tpu_torch.runtime``; the runtime calls them with
``device=`` (default cuda).

The knobs are the JAX package's: ``DORA_MODEL_SIZE`` ("tiny", else the
full configuration), ``DORA_HF_CHECKPOINT`` (a safetensors directory of a
matching family), ``DORA_PARAM_DTYPE``, ``DORA_MAX_NEW_TOKENS``,
``DORA_PROMPT``, ``DORA_INT8_DECODE`` / ``DORA_INT4_DECODE``,
``DORA_SPEC_DECODE``, ``DORA_DETECT_THRESHOLD`` / ``DORA_DETECT_TOPK`` and
``DORA_TTS_STYLE``. Two are refused with an error naming them:
``DORA_CHECKPOINT`` (an orbax directory, which the port cannot read) and
``DORA_MESH`` (the port runs one process a card; a node over a mesh of
them is not built yet). The self-contained
models seed from the port's own generator, so their weights are not the
JAX package's; parity is held by carrying the JAX parameters over
(``models/hf/qwen2.params_from_jax``, and the ``params_from_jax`` of
``models/detection``, ``translation`` and ``tts``, which relay the
convolutions)."""

from __future__ import annotations

import os
from pathlib import Path

import torch

from dora_tpu_torch.tpu.api import TorchOperator


def _size() -> str:
    return os.environ.get("DORA_MODEL_SIZE", "tiny")


def _normalize(image):
    """uint8 camera frames -> f32 in [0, 1]; float frames pass through."""
    if image.dtype == torch.uint8:
        return image.float() / 255.0
    return image


def _maybe_cast(params):
    """``DORA_PARAM_DTYPE`` (e.g. bfloat16): every leaf stored in that
    dtype."""
    dtype = os.environ.get("DORA_PARAM_DTYPE")
    if not dtype:
        return params
    target = getattr(torch, dtype)

    def cast(v):
        return {k: cast(x) for k, x in v.items()} if isinstance(v, dict) else v.to(target)

    return cast(params)


def _maybe_restore(params, name: str):
    """The JAX package restores ``DORA_CHECKPOINT/<name>``, an orbax
    directory; the port has no reader for it, so the knob is refused."""
    path = os.environ.get("DORA_CHECKPOINT")
    if path:
        raise RuntimeError(
            f"DORA_CHECKPOINT={path!r}: the port cannot read the JAX package's orbax "
            f"checkpoints (operator {name!r}); unset DORA_CHECKPOINT, or serve a "
            "safetensors directory with DORA_HF_CHECKPOINT")
    return _maybe_cast(params)


def _hf_checkpoint(model_type_prefix: str) -> str | None:
    """``DORA_HF_CHECKPOINT`` when it holds a checkpoint whose config.json
    ``model_type`` starts with the prefix, else None."""
    import json

    path = os.environ.get("DORA_HF_CHECKPOINT")
    if not path:
        return None
    config = Path(path) / "config.json"
    if not config.exists():
        raise FileNotFoundError(f"DORA_HF_CHECKPOINT={path}: no config.json")
    model_type = json.loads(config.read_text()).get("model_type", "")
    return path if model_type.startswith(model_type_prefix) else None


def _hf_tokenizer(path: str):
    """The byte-level BPE tokenizer of a checkpoint directory that ships a
    ``tokenizer.json``, else None."""
    from dora_tpu_torch.models.tokenizer import BPETokenizer

    if (Path(path) / "tokenizer.json").exists():
        return BPETokenizer.from_file(path)
    return None


def _quantize_knob() -> bool:
    return bool(os.environ.get("DORA_INT8_DECODE") or os.environ.get("DORA_INT4_DECODE"))


def _max_new(default: str) -> int:
    return int(os.environ.get("DORA_MAX_NEW_TOKENS", default))


def make_detector(device=None) -> TorchOperator:
    """Image [H, W, 3] -> boxes [K, 4] (cxcywh in pixels), scores [K] and
    classes [K] int32. With DORA_HF_CHECKPOINT at a YOLOS directory, the
    pretrained detector (the image at the checkpoint's resolution);
    otherwise the self-contained one (``tiny``, or ``DetectorConfig()``)."""
    from dora_tpu_torch.models import detection

    hf_path = _hf_checkpoint("yolos")
    if hf_path:
        from dora_tpu_torch.models.hf import yolos

        cfg, params = yolos.load(hf_path, device=device)
        return yolos_operator(cfg, _maybe_cast(params))

    cfg = detection.DetectorConfig.tiny() if _size() == "tiny" else detection.DetectorConfig()
    params = _maybe_restore(detection.init_params(cfg, seed=0, device=device), "detector")

    def step(state, inputs):
        out = detection.detect(state, cfg, _normalize(inputs["image"])[None])
        return state, {k: out[k][0] for k in ("boxes", "scores", "classes")}

    return TorchOperator(step=step, init_state=params)


def yolos_operator(cfg, params) -> TorchOperator:
    """YOLOS's operator over loaded ``params`` (what ``make_detector``
    builds after ``yolos.load``): ``DORA_DETECT_THRESHOLD`` (default 0.5)
    and ``DORA_DETECT_TOPK`` (default n_det) rows, the boxes turned from
    normalized xyxy into the contract's cxcywh in pixels."""
    from dora_tpu_torch.models.hf import yolos

    threshold = float(os.environ.get("DORA_DETECT_THRESHOLD", "0.5"))
    top_k = int(os.environ.get("DORA_DETECT_TOPK", str(cfg.n_det)))
    img_h, img_w = cfg.image_size

    def step(state, inputs):
        pixels = yolos.preprocess(_normalize(inputs["image"])[None], cfg)
        out = yolos.detect(state, cfg, pixels, threshold, top_k)
        x1, y1, x2, y2 = out["boxes"][0].unbind(-1)
        boxes = torch.stack([(x1 + x2) / 2 * img_w, (y1 + y2) / 2 * img_h,
                             (x2 - x1) * img_w, (y2 - y1) * img_h], dim=-1)
        return state, {"boxes": boxes, "scores": out["scores"][0],
                       "classes": out["classes"][0]}

    return TorchOperator(step=step, init_state=params)


def make_vlm(device=None) -> TorchOperator:
    """Image [H, W, 3] -> greedy caption tokens (prompt from DORA_PROMPT).
    With DORA_HF_CHECKPOINT at a Qwen2-VL or InternVL directory, the
    pretrained model (its BPE tokenizer when shipped); otherwise the
    self-contained VLM (``tiny``, or ``bench_2b``) with the byte codec."""
    from dora_tpu_torch.models import spec_decode, tokenizer, vlm
    from dora_tpu_torch.tpu.fuse import mesh_from_env

    mesh_from_env()  # the JAX package's tensor-parallel branch: refused
    height = int(os.environ.get("IMAGE_HEIGHT", "224"))
    width = int(os.environ.get("IMAGE_WIDTH", "224"))

    internvl_path = _hf_checkpoint("internvl")
    if internvl_path:
        from dora_tpu_torch.models.hf import internvl

        max_new = _max_new("16")
        cfg, params = internvl.load(internvl_path,
                                    max_seq=int(os.environ.get("DORA_MAX_SEQ", "1024")),
                                    device=device)
        params = _maybe_cast(params)
        if _quantize_knob():
            params = internvl.quantize_decode(params, cfg)
        tile = cfg.vision.image_size
        cols, rows, n_tiles = internvl.tile_grid(
            width, height, tile=tile, max_num=int(os.environ.get("DORA_MAX_TILES", "12")))
        tok = _hf_tokenizer(internvl_path)
        prompt_text = os.environ.get("DORA_PROMPT", "Describe this image.")
        text_ids = (tok.encode(prompt_text) if tok is not None
                    else [t % cfg.text.vocab for t in tokenizer.encode(prompt_text)])
        prompt_ids = internvl.build_prompt_ids(cfg, text_ids, n_tiles)
        speculative = spec_decode.gate_speculation(prompt_ids.shape[1], max_new,
                                                   cfg.text.max_seq)
        serve = internvl.make_serving_step(cfg, prompt_ids, cols, rows, tile, max_new,
                                           speculative=speculative)

        def internvl_step(state, inputs):
            return state, {"tokens": serve(state, _normalize(inputs["image"]))[0]}

        return TorchOperator(step=internvl_step, init_state=params)

    hf_path = _hf_checkpoint("qwen2_vl")
    if hf_path:
        from dora_tpu_torch.models.hf import qwen2_vl

        max_new = _max_new("16")
        cfg, params = qwen2_vl.load(hf_path,
                                    max_seq=int(os.environ.get("DORA_MAX_SEQ", "1024")),
                                    device=device)
        if _quantize_knob():
            params = qwen2_vl.quantize_decode(params, cfg)
        tok = _hf_tokenizer(hf_path)
        prompt_text = os.environ.get("DORA_PROMPT", "Describe this image.")
        target_h, target_w = qwen2_vl.smart_resize(
            height, width, factor=cfg.vision.patch_size * cfg.vision.spatial_merge_size)
        text_ids = (tok.encode(prompt_text) if tok is not None
                    else [t % cfg.vocab for t in tokenizer.encode(prompt_text)])
        prompt_ids = qwen2_vl.build_prompt_ids(cfg, text_ids, target_h, target_w)
        speculative = spec_decode.gate_speculation(prompt_ids.shape[1], max_new, cfg.max_seq)
        serve = qwen2_vl.make_serving_step(cfg, prompt_ids, target_h, target_w, max_new,
                                           speculative=speculative)

        def hf_step(state, inputs):
            return state, {"tokens": serve(state, _normalize(inputs["image"]))[0]}

        return TorchOperator(step=hf_step, init_state=params)

    cfg = vlm.VLMConfig.tiny() if _size() == "tiny" else vlm.VLMConfig.bench_2b()
    params = _maybe_restore(vlm.init_params(cfg, seed=0, device=device), "vlm")
    if _quantize_knob():
        # quantized LM weights, from the stored float ones
        params = vlm.quantize_decode(params)
    return vlm_operator(cfg, params)


def vlm_operator(cfg, params) -> TorchOperator:
    """The self-contained VLM's operator over loaded ``params`` (what
    ``make_vlm`` builds after initializing them): greedy ``vlm.generate``,
    or ``vlm.generate_speculative`` when DORA_SPEC_DECODE is set and fits."""
    from dora_tpu_torch.models import spec_decode, tokenizer, vlm

    prompt_text = os.environ.get("DORA_PROMPT", "describe")
    max_new = _max_new("16")
    dev = params["embed"].device
    prompt = torch.tensor([[t % cfg.vocab for t in tokenizer.encode(prompt_text)]],
                          dtype=torch.int32, device=dev)
    speculative = spec_decode.gate_speculation(cfg.n_patches + prompt.shape[1], max_new,
                                               cfg.max_seq, batch_ok=prompt.shape[0] == 1)

    def step(state, inputs):
        image = _normalize(inputs["image"])[None]
        if speculative:
            tokens, _ = vlm.generate_speculative(state, cfg, image, prompt, max_new)
        else:
            tokens = vlm.generate(state, cfg, image, prompt, max_new)
        return state, {"tokens": tokens[0]}

    return TorchOperator(step=step, init_state=params)


def make_asr(device=None) -> TorchOperator:
    """Audio chunk [samples] f32 -> token ids. With DORA_HF_CHECKPOINT at a
    Whisper-family directory, the pretrained model; otherwise the
    self-contained ASR."""
    from dora_tpu_torch.models import asr, tokenizer

    hf_path = _hf_checkpoint("whisper")
    if hf_path:
        from dora_tpu_torch.models.hf import whisper

        return whisper_operator(*whisper.load(hf_path, device=device))

    cfg = asr.ASRConfig.tiny() if _size() == "tiny" else asr.ASRConfig()
    params = _maybe_restore(asr.init_params(cfg, seed=0, device=device), "asr")
    max_new = min(_max_new("16"), cfg.max_tokens)
    bos = tokenizer.BOS % cfg.vocab

    def step(state, inputs):
        return state, {"tokens": asr.transcribe(state, cfg, inputs["audio"][None], bos,
                                                max_new)[0]}

    return TorchOperator(step=step, init_state=params)


def whisper_operator(cfg, params) -> TorchOperator:
    """Whisper's operator over loaded ``params`` (what ``make_asr`` builds
    after ``whisper.load``): ``whisper.make_serving_step`` with
    DORA_MAX_NEW_TOKENS (default 32) new tokens, speculative when
    DORA_SPEC_DECODE is set and fits."""
    from dora_tpu_torch.models.hf import whisper
    from dora_tpu_torch.models.spec_decode import gate_speculation

    max_new = _max_new("32")
    serve = whisper.make_serving_step(cfg, max_new,
                                      speculative=gate_speculation(1, max_new, cfg.max_target))

    def hf_step(state, inputs):
        return state, {"tokens": serve(state, inputs["audio"])[0]}

    return TorchOperator(step=hf_step, init_state=params)


def make_translator(device=None) -> TorchOperator:
    """Text (utf-8 bytes or token ids) -> translated token ids [max_new]
    int32 (the byte codec's ids): the self-contained encoder-decoder
    (``tiny``, or ``TranslatorConfig()``), the source trimmed or padded with
    PAD to ``max_src``, DORA_MAX_NEW_TOKENS (default 16) clamped at the
    cache's ``max_tokens``."""
    from dora_tpu_torch.models import tokenizer, translation

    cfg = (translation.TranslatorConfig.tiny() if _size() == "tiny"
           else translation.TranslatorConfig())
    params = _maybe_restore(translation.init_params(cfg, seed=0, device=device), "translator")
    max_new = min(_max_new("16"), cfg.max_tokens)
    bos = tokenizer.BOS % cfg.vocab
    pad = tokenizer.PAD % cfg.vocab

    def step(state, inputs):
        src = (inputs["text"].to(torch.int32) % cfg.vocab)[: cfg.max_src]
        src = torch.nn.functional.pad(src, (0, cfg.max_src - src.shape[0]), value=pad)
        return state, {"tokens": translation.translate(state, cfg, src[None], bos, max_new)[0]}

    return TorchOperator(step=step, init_state=params)


def make_tts(device=None) -> TorchOperator:
    """Text (utf-8 bytes or token ids) -> waveform samples f32 in [-1, 1].
    With DORA_HF_CHECKPOINT at a VITS / MMS-TTS directory, the pretrained
    model (:func:`vits_operator`); otherwise the self-contained stack
    (``tiny``, or ``TTSConfig()``) in the voice DORA_TTS_STYLE."""
    from dora_tpu_torch.models import tokenizer, tts

    vits_path = _hf_checkpoint("vits")
    if vits_path:
        import json

        from dora_tpu_torch.models.hf import vits

        cfg, params = vits.load(vits_path, device=device)
        vocab_file = Path(vits_path) / "vocab.json"
        vocab = json.loads(vocab_file.read_text()) if vocab_file.exists() else None
        return vits_operator(cfg, params, vocab)

    cfg = tts.TTSConfig.tiny() if _size() == "tiny" else tts.TTSConfig()
    params = _maybe_restore(tts.init_params(cfg, seed=0, device=device), "tts")
    style = int(os.environ.get("DORA_TTS_STYLE", "0")) % cfg.n_styles
    pad = tokenizer.PAD % cfg.vocab

    def step(state, inputs):
        text = (inputs["text"].to(torch.int32) % cfg.vocab)[: cfg.max_text]
        text = torch.nn.functional.pad(text, (0, cfg.max_text - text.shape[0]), value=pad)
        styles = torch.tensor([style], device=text.device)
        return state, {"audio": tts.synthesize(state, cfg, text[None], styles)[0]}

    return TorchOperator(step=step, init_state=params)


def vits_text_ids(raw: bytes, vocab: dict | None, n_vocab: int) -> list[int]:
    """The VITS convention: lowercase characters through the checkpoint's
    ``vocab.json`` (bytes modulo the vocabulary without one), pad 0 around
    each."""
    text = raw.decode("utf-8", "ignore").lower()
    if vocab is None:
        ids = [b % n_vocab for b in text.encode()]
    else:
        ids = [vocab[ch] for ch in text if ch in vocab]
    out = [0]
    for t in ids:
        out += [t, 0]
    return out


def vits_operator(cfg, params, vocab: dict | None = None) -> TorchOperator:
    """VITS's operator over loaded ``params`` (what ``make_tts`` builds
    after ``vits.load``): the input's bytes (uint8 of each value) as VITS
    ids, then ``vits.synthesize_bucketed``. A host operator: the length
    of its output depends on the predicted durations."""
    import numpy as np

    from dora_tpu_torch.models.hf import vits

    def step(state, inputs):
        raw = bytes(inputs["text"].cpu().numpy().astype(np.uint8))
        ids = torch.tensor([vits_text_ids(raw, vocab, cfg.vocab)], dtype=torch.int32)
        return state, {"audio": vits.synthesize_bucketed(state, cfg, ids)[0]}

    return TorchOperator(step=step, init_state=params, host=True)


def make_vad(device=None) -> TorchOperator:
    """Audio chunk [samples] -> speech probability [1]. With
    DORA_HF_CHECKPOINT at a Wav2Vec2 audio-frame classification directory
    (superb/sd-class), the chunk's largest frame speech probability;
    otherwise the self-contained GRU, whose hidden state threads from tick
    to tick on the device."""
    from dora_tpu_torch.models import vad

    hf_path = _hf_checkpoint("wav2vec2")
    if hf_path:
        from dora_tpu_torch.models.hf import wav2vec2

        return wav2vec2_operator(*wav2vec2.load(hf_path, device=device))

    cfg = vad.VADConfig.tiny() if _size() == "tiny" else vad.VADConfig()
    params = _maybe_restore(vad.init_params(cfg, seed=0, device=device), "vad")
    h0 = torch.zeros((1, cfg.hidden), device=params["feat"].device)

    def step(state, inputs):
        params, h = state
        prob, h = vad.speech_prob(params, cfg, inputs["audio"][None], h)
        return (params, h), {"prob": prob}

    return TorchOperator(step=step, init_state=(params, h0))


def wav2vec2_operator(cfg, params) -> TorchOperator:
    """The Wav2Vec2 VAD's operator over loaded ``params`` (what
    ``make_vad`` builds after ``wav2vec2.load``)."""
    from dora_tpu_torch.models.hf import wav2vec2

    def hf_step(state, inputs):
        probs = wav2vec2.speech_probability(state, cfg, inputs["audio"][None])
        return state, {"prob": probs.amax(dim=-1)}

    return TorchOperator(step=hf_step, init_state=params)
