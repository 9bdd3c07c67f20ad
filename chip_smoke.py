#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dora_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--layers N] [--requests N] [--max-new N]

Phases, each printed on its own line:

1. the device: torch's name for it and ``nvidia-smi``'s name and power limit;
2. the kernel build (the six ``dora_tpu_torch/csrc/*.cu``, nvcc started once
   per source, all together), with its time;
3. each of the nine kernels of the paged serving paths (the five fp-KV
   ones, ``lora_gather_matmul`` and the int8-KV forms of the three
   attention kernels) held against its plain PyTorch version on the card,
   in bf16 at the Qwen2-1.5B shapes the serving paths give it (``mlp_step``
   and ``lm_head_argmax`` also at the 1 row of batch-1 decode, and with the
   LoRA kernel at the 80 rows of a speculative verify and the 256 of a
   prefill chunk), with its time, the
   plain version's time, a library yardstick's time and the least time the
   card could take (``bound_ms``); the int8 forms' written rows within 1 LSB
   of the plain version's and every other value and scale bit-unchanged,
   slot-0 LoRA rows exactly zero. The LoRA kernel also runs its grouped
   design's edges (256 rows on one adapter, 16 rows on 16 adapters, 16 rows
   all on slot 0, ranks 12 and 256), each line with its device time, the
   bound, and beside the batched-product yardstick one cuBLAS pair per
   distinct adapter, summed as device time;
4. the slice: a Qwen2-1.5B-shaped engine with seeded random int8 weights
   (16 slots, page 16, chunk 256, K = 8, max_seq 2048) serves 16 requests
   with prompts of 64..1000 tokens and 128 new tokens each; together they
   need more pages than the pool holds, so requests wait for pages. Every
   kernel's launch count is read around this run, and no plain version may
   run in it;
5. two of those requests again through the plain versions on the card: the
   greedy tokens must agree, or part where both tokens are within NEAR_TIE
   of the top logit of the plain path run in f32; and the kernel path's
   logits must be as close to that f32 reference as the bf16 plain path's;
6. speculation and the prefix cache at full width and depth: the engine as
   ``llm_server.make_engine`` builds it with ``DORA_SPEC_K=4`` (prefix cache
   on, K = 8, 16 slots, page 16, chunk 256, 512-page pool) serves 16 chat
   requests that share one 512-token system prefix, each with its own tail
   of 32..480 tokens, 128 new tokens each. Request 0 runs first until it has
   its first token; the other 15 then find its prompt pages in the cache.
   Every decode tick goes through ``attention_paged_spec_step``; the batch
   decode kernel and the plain versions may not run;
7. two of those requests again on the spec-off, cache-off engine on the
   card: the tokens must agree, or part where the served token is within
   NEAR_TIE of the f32 plain path's top logit and the reference's within
   SPEC_REF_TIE;
8. multi-tenant LoRA on int8 KV pages at full width and depth: four seeded
   adapters t0..t3 (ranks 8, 16, 16, 32) written to a temporary catalog,
   the engine as ``make_engine`` builds it with ``DORA_KV_INT8=1`` and
   ``DORA_LORA_DIR`` (prefix cache on, K = 8, 16 slots, page 16, chunk 256,
   992 int8 pages in the 512 fp pages' byte budget, 8 resident adapters),
   16 requests in five groups (t0..t3 three each, base four) sharing one
   256-token prefix with tails of 32..480 tokens, 128 new tokens each. The
   first request of each group runs to its first token, then the other 11
   come through ``serve_prompts(adapters=...)`` and must hit their own
   tenant's prefix pages only (11 hits). The LoRA kernel and the int8-KV
   batch and chunk forms must run, the fp forms and the plain versions
   not. Then agreement: two tenants' first requests alone on a fresh engine,
   the base group's on an engine without a catalog, two requests through
   the plain versions (partings only at near-ties); and a short spec-on run
   (``DORA_SPEC_K=4``, 32 new tokens) through the int8 spec form with the
   LoRA kernel at 80 rows;
9. the dense batch engine at full width and depth: ``make_engine`` with
   ``DORA_PAGED_KV=0`` (4 slots, max_seq 2048) serves 12 requests of 8..1000
   tokens, three of them <= 32 tokens so that ``int8_matmul`` runs their
   whole prefill, 128 new tokens each, through ``serve_prompts``, so that
   later requests join mid-flight. ``int8_matmul``, ``attention_batch_step``,
   ``mlp_step`` and ``lm_head_argmax`` must run, the paged kernels and every
   plain version not; decode tokens/s, step time and TTFT are printed;
10. batch-1 decode: ``qwen2.generate`` on two of phase 9's prompts (128 new
   tokens) through ``attention_step``, then ``spec_decode.run_loop`` with
   ``verify`` over ``qwen2.fused_step`` (k = 4) through
   ``attention_chunk_step``; the dense engine's streams, ``generate``'s and
   ``run_loop``'s must agree or part at near-ties of the f32 plain version
   of this path (its prefill takes the bf16 sidecars, not the paged path's
   int8 weights): the served token within NEAR_TIE, the other within
   SPEC_REF_TIE, as in phases 7 and 8;
11. the self-contained VLM at ``VLMConfig.bench_2b``, full width and depth
   (a 32-layer ViT 1280 wide, 16 heads of 80 over the 256 patches of a
   224 x 224 image; a Qwen2-1.5B-shaped LM), seeded random weights with the
   LM blocks and head in int8 (``vlm.quantize_decode``), one seeded image
   and a 16-token prompt: ``encode_image`` through ``flash_attention``
   (once per vision layer) held against the dense einsum
   (``DORA_FLASH_ATTENTION=0``) and both against the f32 plain path; then
   ``vlm.generate`` (``int8_matmul`` on the prefill's head, then
   ``attention_step``, ``mlp_step`` and ``lm_head_argmax`` a step) and
   ``vlm.generate_speculative`` (k = 4: ``attention_chunk_step`` a verify
   pass) of 128 tokens, each held to the f32 plain path's stream by the
   near-tie rule (NEAR_TIE for generate, SPEC_REF_TIE for the verify path),
   with the exact launches of each run; ViT ms per image, TTFT, decode
   tokens/s and passes per token are printed;
12. int4 weights: phase 4's seeded model quantized under
   ``DORA_WEIGHT_BITS=4`` (groups of 128) serves phase 4's 16 requests
   through ``make_engine`` from the front door (prefix cache on), each
   window one CUDA-graph replay, through the int4 forms of kernels 1-4 alone
   (no int8 kernel, no plain version); every stream equals its
   ``graphs=False`` stream, captures do not grow (``graph`` line), two
   requests are held to the f32 plain path as in phase 5 (the bf16 plain
   stream's token within SPEC_REF_TIE), and ``paths``
   lines set its window and chunk ms against phase 4's int8 ones. Then, at
   INT4_SHORT_NEW new tokens: ``DORA_SPEC_K=4`` (kernel 5's int4 form; two
   requests held to the spec-off engine as in phase 7), the dense engine
   (kernel 8's; graphed against eager, its graph line, its step ms against
   phase 9's) and phase 10 on int4 (``generate`` through kernel 9's,
   ``run_loop`` through kernel 10's);
13. the serving node: the port's ``serve()`` (nodehub/llm_server.py, the
   dataflow node's loop) over an in-process scripted node (INPUT events in,
   each held back until its gate opens; ``send_output`` calls captured;
   no daemon) on the engine ``make_engine`` builds (graphed; 16 slots, page
   16, chunk 256, K = 8, 512 pages, prefix cache on), phase 4's weights:
   (a) phase 4's requests at once, default class, every stream equal to
   phase 4's or parting at a near-tie (served token within NEAR_TIE of the
   f32 plain path's top, phase 4's within SPEC_REF_TIE), one done chunk a
   request with finish "length" and gapless seqs, kernels 1-4 launched and
   no plain version (these are the launches of the ``kernels`` line),
   TTFT, tokens/s and ``dispatch_gap`` from ServingMetrics, then a
   ``graph`` line; (b) ``DORA_QOS_PREEMPT=1``, QOS_MAX_NEW new tokens: the
   shorter half of the prompts as ``batch``, the longer half as
   ``interactive`` once every batch stream decodes; at least one
   preemption, every victim resumed (re-prefilling prompt + emitted) and
   every stream held to phase 4's as in (a); (c) ``DORA_QOS_DEPTH_BATCH``
   SHED_DEPTH under SHED_REQUESTS batch requests at once: sheds end in one
   retriable empty ``overloaded`` chunk, the rest in full, none lost; no
   capture after warmup;
14. the serving node's recovery, on make_engine's graphed engines (phase
   13's and a fresh one) and phase 4's weights and requests: (a)
   ``DORA_CHECKPOINT_DIR`` with ``DORA_CHECKPOINT_EVERY=8`` and
   ``DORA_CHECKPOINT_PAGES=1``; the scripted node raises out of ``recv``
   right after the second cadence checkpoint, whose snapshot must hold a
   decoding, a mid-prefill and a parked stream (phase 4's page pressure at
   128 new tokens gives all three); a fresh engine's ``serve()`` with no new
   traffic restores it: restored_streams equal the snapshot's live
   streams, the restored pools' per-layer checksums the saved ones', the
   chunks of both runs, deduplicated by (request_id, seq), phase 4's
   streams by the near-tie rule of phase 13 (a), kernels 1-4 launched (the
   restored decoding streams read their restored pages through kernel 3,
   the mid-prefill ones re-prefill through kernel 4), no plain version and
   no capture after the fresh engine's first window; checkpoint and pool
   write ms, state.json and pool bytes, restore ms and tokens/s against
   phase 13 (a)'s are printed; (b) a MIGRATE once four streams have a token
   drains phase 13's engine into a handoff file, which the fresh engine
   (``DORA_MIGRATE_DIR``) admits: migrated_out = migrated_in = the drained
   plus the parked streams, every stream's seqs gapless to its full length,
   the parked and mid-prefill streams equal to phase 4's (near-tie rule);
   the decoding ones continue without their KV pages (none are shipped, as
   in the reference), so their agreement with phase 4's is only printed; no
   capture on the target;
15. the HF vision-language families at their published widths: Qwen2-VL-2B
   (QWEN2_VL_2B, its config.json: a 32-layer vision tower 1280 wide, the
   Qwen2-1.5B LM with M-RoPE and a tied head) and InternVL3-1B (INTERNVL3_1B:
   a 24-layer InternViT 1024 wide, a 24-layer LM 896 wide, 14 / 2 heads of
   64, vocab 151674), seeded random tensors under each checkpoint's names
   through the port's ``map_params``, the LM int8 (``quantize_decode``).
   For each: the vision tower on one seeded uint8 frame (448 x 448: 256
   image tokens; 896 x 448: 2 x 1 tiles and the thumbnail, 768 image
   tokens), its bf16 output within VIT_REL_RMS (relative RMS) of its f32
   run; then ``make_serving_step`` of HF_VLM_MAX_NEW tokens, greedy
   (``int8_matmul`` on the prefill's head, ``attention_step``, ``mlp_step``
   and ``lm_head_argmax`` a step) and speculative (k = 4:
   ``attention_chunk_step`` a verify pass), each with its exact launches
   and no plain version; the greedy tokens held to the f32 plain path's,
   the speculative ones to the greedy ones, by the near-tie rule (NEAR_TIE,
   SPEC_REF_TIE), with the kernel path's logits within RMS_MARGIN; ViT ms,
   TTFT, ms a decode token and tokens/s are printed;
16. the operator tier (``operators`` lines): the port's runtime loop
   (``runtime.serve``) over scripted nodes, no daemon. (a) The speech node
   of the speech-to-text example: ``vad`` = Wav2Vec2 at superb/wav2vec2-
   base-superb-sd's widths (W2V2_SUPERB_SD) and ``asr`` = Whisper at
   openai/whisper-large-v3-turbo's (WHISPER_TURBO), built by
   ``nodehub.ops`` from seeded tensors under the checkpoints' names through
   ``map_params``, over eight seeded utterances of 1-30 s, each sent to
   both: every tick's tokens equal ``whisper.make_serving_step``'s on the
   audio it sampled and its probability the VAD operator's, the tokens held
   to the f32 plain path by the near-tie rule and the probability within
   VAD_PROB_TOL of its f32 run, the pipelined run and ``DORA_FETCH_EVERY=4``
   bit for bit the synchronous one's, none of the 11 kernels launched; the
   tick wall p50 / p99, the seconds an utterance and the device busy share
   (``profiling.start_capture``). (b) The VLM node of the VLM example:
   ``make_vlm`` with ``DORA_MODEL_SIZE=bench`` and ``DORA_INT8_DECODE=1``,
   eight seeded 224 x 224 frames in bursts between timer ticks: each tick
   takes the latest frame, its tokens equal ``vlm.generate``'s, the launches
   exact (kernels 11, 7, 9, 1, 2) with no plain version; frames a second
   pipelined against synchronous; then ``DORA_SPEC_DECODE=1``: tokens equal
   ``vlm.generate_speculative``'s, kernel 10 a verify pass;
17. the hub models (``hub`` lines), none of which reaches one of the 11
   kernels (each run asserts no launch and no plain version): (a) the yolo
   example's node, ``make_detector`` at ``DORA_MODEL_SIZE=bench`` (640 x
   640) and then its YOLOS branch at hustvl/yolos-small's widths
   (YOLOS_SMALL, 800 x 1333), each over eight seeded frames: every tick's
   boxes, classes and scores equal to the operator's step called directly,
   the pipelined run bit for bit the synchronous one, the classes of the
   detections the f32 plain path keeps equal to the served bf16 ones but at
   near-ties (f32 top two within NEAR_TIE), the heads' logits within
   VIT_REL_RMS (rel RMS) of f32 as phase 15 holds a vision tower, the
   scores' and boxes' errors stated; (b) the translation
   example's nodes: ``make_translator`` into ``make_tts`` at
   ``DORA_MODEL_SIZE=bench``, the port's Opus node
   (``nodehub.translator.serve``) at Helsinki-NLP/opus-mt-en-de's widths
   (OPUS_MT_EN_DE) greedy and speculative, and ``make_tts``'s VITS branch at
   facebook/mms-tts-eng's (MMS_TTS_ENG, noise_scale 0), over eight seeded
   sentences of 10-200 characters: ticks against direct calls, translator
   tokens held to the f32 plain path by the near-tie rule, speculative
   tokens equal to greedy ones, VITS's durations equal to the f32 plain
   path's (and how many TF32 would move), the waveforms' rel RMS; tick
   wall p50 / p99, frames or tokens a second, ms a sentence, audio seconds
   a wall second and the device busy share;
18. training and the parallel tier (``train`` lines): (a) ``vlm.loss_fn``
   and ``make_train_step`` on bench_2b at full width (about 2.2 B f32
   master weights, Adam at TRAIN_LR, batch TRAIN_BATCH x 256 image + 64
   text tokens): step 1 through kernel 11 (32 ViT + 28 LM launches, its
   backward plain PyTorch) against the same step with
   DORA_FLASH_ATTENTION=0 (loss within TRAIN_LOSS_REL, every leaf's
   gradient finite, nonzero and at cosine >= TRAIN_GRAD_COS to the
   flash-off one), then TRAIN_STEPS steps on one seeded batch: launches
   exact, the loss falling, step ms, tokens a second, peak memory and the
   device busy share of one more step; (b) ``tts.loss_fn`` at phase 17's
   bench TTS widths, TTS_STEPS SGD steps, the loss falling; (c) a one-rank
   NCCL group over a file store: ``vlm.generate_tp`` at tp 1 (its
   all-reduces through NCCL) equal to ``vlm.generate`` token for token with
   exact launches, and ring and Ulysses attention at sp 1 equal to the
   dense einsum in f32 (SP1_REL_TOL). NCCL across cards is not run on this
   one-card machine. The kernels line adds (a)'s launches to kernel 11's;
19. the port's measurement tools (``bench`` lines, dora_tpu_torch/tools/):
   each leg in its own process, the tool run as ``python -m
   dora_tpu_torch.tools.<tool>`` runs it (the process imports torch and
   opens the card while the leg before it runs), on this card at full
   width and depth: bench_serving's default paged /
   dense A/B, ``--multistep``, ``--trace-ab`` and ``--quant-ab`` on the
   seeded Qwen2-1.5B-width model (``DORA_INT8_DECODE=1``), its six stub-
   engine legs, bench_int8, bench_flash, and bench_vlm's ``model`` (int8,
   ``DORA_SPEC_DECODE=1``), ``batch`` and ``e2e`` modes on bench_2b (e2e: the
   camera -> VLM node -> sink dataflow under the port's daemon, E2E_FRAMES
   frames, the node's launches from its own process). Each leg's JSON
   lines are printed; the run fails on a missing line, a null number (a
   spec-off cell's acceptance aside), a plain call, or a kernel the leg
   names with no launch. Where ``--quant-ab``'s int8-KV streams part from
   its fp streams, both tokens must sit at a near-tie of the f32 plain path
   on the same prefix (the int8-KV token within NEAR_TIE, the fp one within
   SPEC_REF_TIE, as phases 7 and 12 hold a second path). The cuts are
   printed on a ``bench cuts`` line. The kernels line does not change;
20. the port's dataflows under the port's own daemon (``dataflow`` lines,
   ``dora_tpu_torch.daemon.run_dataflow``, no YAML read): (a)
   dora_tpu_torch/examples/vlm.yml as a dict at bench_2b, int8 (a seeded 20
   ms camera, the VLM node ticked at 100 ms, its inputs latest-wins, the
   printer and the recorder), run VLM_FLOW_S after its start barrier, then
   with ``DORA_SPEC_DECODE=1`` for VLM_SPEC_FLOW_S: every recorded caption
   equal to ``vlm.generate`` (``generate_speculative``) in this process on
   the frame its metadata names, the VLM node's launches (its own process,
   tools/counted.py) those of its ticks with no plain call (kernels 11, 7,
   9, 1, 2; kernel 10 speculative), frames a second at the recorder and
   tick-to-sink latency beside phase 16's tick wall; (b) phase 4's requests
   from a prompt node to ``nodehub.llm_server --random-config`` (phase 4's
   seeded weights, int8, phase 13's engine) to a sink, over shmem and over
   tcp, after one warmup request of one token: every stream held to phase
   4's by the near-tie rule, kernels 1-4 launched in the node with no plain
   call, TTFT and tokens a second beside phase 13 (a)'s. A failed node fails
   the phase. The kernels line does not change.
21. the cluster tier (``cluster`` lines): ``up --machine-id A`` and ``up
   --machine-id B`` (the port's CLI: a coordinator on the default ports and
   two daemons, detached, their pid files under a scratch
   ``DORA_TPU_STATE_DIR``); (a) ``multiple-daemons.yml`` across A and B
   through ``start --attach``, then ``logs receiver`` (the receiver's
   assertions); (b) ``llm-server.yml``: the port's gateway (concurrent) on A,
   ``llm_server --random-config qwen2_1_5b`` on B on the card (phase 4's
   seeded int8 weights, phase 13's engine, phase 20 (b)'s env), started with
   ``start`` and listed by ``list``; after one streamed request of one token,
   phase 4's 16 prompts posted at once over HTTP as streamed requests, every
   token crossing the daemons' link: each stream held to phase 4's by the
   near-tie rule, TTFT at the HTTP client and tokens a second beside phase
   20 (b)'s; (c) ``migrate`` through the CLI while four long streams are live:
   their handoff file must appear in the directory, naming them, then
   ``stop``; the node's launches (tools/counted.py) kernels 1-4 and no plain
   call; last ``destroy``, after which no process of the cluster is left.
   The kernels line does not change.
22. the observability planes (``phase 22`` lines), on phase 21's cluster:
   ``up`` gives the coordinator ``DORA_PROM_PORT`` and the daemons
   ``DORA_TRACING=1``, ``DORA_METRICS_HISTORY_S=1`` and the JSONL alert sink,
   and ``llm-server.yml`` carries an ``alerts:`` block with OBSERVE_RULE
   (decode tokens over 10 a second) over the default pack. (b) ``alerts
   --json``, polled while phase 21 (b)'s 16 streams run and after: the rule
   firing, then resolved; the sink holds one firing and one resolved record
   of it, the firing inside the streams' window; no rule of the default
   pack fires. (e) ``GET /metrics`` on the coordinator: no finding of
   ``prom.validate_exposition``, ``dora_serving_requests_total`` of the node
   equal to the requests sent. (c) ``trace --out``: no finding of
   ``tracing.validate_chrome_trace``, send / route / deliver / recv spans on
   both machines, one queued -> admitted -> prefill_chunk -> decode_window ->
   finish chain on the node's engine track a request, the dev_compute
   spans over the streams within DEV_COMPUTE_TOL of the node's
   ``device_compute_ns`` over them (read with ``metrics --json`` before and
   after), the dropped events printed; (d) first, the node's first
   capture while it is idle (``profile llm --seconds 2``: it pays the
   profiler's one-time set-up on the node's capture thread), a directory
   with its trace and the capture thread's step timings. Then, while (c)'s
   four streams decode: (a) ``top --once --json``: both machines' samples, at most 1.5
   intervals apart over (b)'s window, the ring's decode tokens over it
   within HISTORY_RATE_TOL of the HTTP client's tokens a second, the node's
   device busy share over a report interval inside the four streams'
   decode at least UTIL_MIN; (d) ``profile llm --seconds 2``: a
   directory with ``torch.profiler``'s ``trace.json`` (a synthetic marker
   fails) and the capture thread's start, stop and export seconds, the
   streams decoding over the whole time the profiler ran, the
   capture's CUDA kernels cut into launches, kernels 1-4 each with its
   launches and device ms, no library product or attention kernel (a
   plain version). After the stop, (b)'s gate over the whole phase: no
   rule of the default pack fired (the node starts, stops and writes the
   capture on a thread of its own, so ``fleet-digest-stale`` must not
   fire), with the oldest the node's fleet digest got. (f) tokens a second
   and TTFT p50 of phase 20 (b) over tcp without ``DORA_TRACING=1`` and,
   under ``--observe``, with it (its third leg), beside phase 21 (b)'s,
   traced. The kernels line gives kernels 1-4 the observed node's
   launches over phases 21 (b)-(c) as ``observed_launches``.
23. operator nodes and peer-to-peer edges (``phase 23`` lines), under the
   port's daemon with peer-to-peer edges on (as phases 20-22 run since
   then): (a) ``dora_tpu_torch/examples/vlm-recorder.yml``, its VLM an
   ``operator: torch:`` node of ``make_vlm`` at bench_2b on int8 weights
   (the source swapped for a file that wraps ``make_vlm`` in the node's
   kernel counters), RECORDER_FRAMES seeded 224 x 224 frames, a recorder of
   the tokens beside it: every caption equal to ``vlm.generate`` on its
   frame in this process, kernels 11, 7, 9, 1 and 2 launched in the node
   with no plain call, the sharegpt dataset and the HTML replay written and
   parsed (their PNGs the camera's frames), the daemon's peer-to-peer edges
   printed; (b) phase 20 (b)'s leg with peer-to-peer edges on and with
   ``DORA_P2P=0``, on, off, off, on over shmem and again over tcp, then
   with ``DORA_P2P=0`` over tcp until it ran P2P_OFF_TCP_RUNS times (a
   lost request fails the leg with every node's log tail; a leg with
   peer-to-peer on fails unless the daemon paired the serving edges), TTFT
   p50 and tokens a second of each leg and of each route; (c) ``examples/c-dataflow``, unchanged, copied
   with ``native/`` into a scratch directory, through the port CLI's
   ``build`` and ``run``: the C sink's lines are the running sums of the C
   node's values (glibc's ``srand(42)``, ``rand() % 100``).

Phase 3 also holds the int4 forms of kernels 1-5 and 8-10 against their
plain versions on phase 12's int4 weights at the main paths' shapes (with
their times, the cuBLAS yardstick on the dequantized weights or the chain of
RMSNorm, cuBLAS qkv, SDPA and cuBLAS wo, and the bound at the int4 bytes),
and the int4 product's fragment path on one tile (``tc_tile4``); and the
four kernels of phases 9 and 10 against their plain versions at Qwen2-1.5B
shapes: ``int8_matmul`` at INT8_SHAPES (1 row on
the head; ``wqkv``, ``wo``, ``w_gateup`` and ``w_down`` at 16 and 32
rows; ``w_gateup`` and ``w_down`` at 256); ``attention_batch_step`` on 4
planes of 2048 rows (positions 0 .. 2047), ``attention_step`` at 1500 and
``attention_chunk_step`` on 5 rows ending on row 2047, every cache row from
the written ones on NaN first: outputs finite, unwritten cache values
bit-unchanged, and each also with ``residual=False``. It holds
``flash_attention`` (phase 11's kernel) at the ViT's (1, 16, 256, 80),
full, and at (1, 12, 2048, 128) and (1, 14, 2048, 64), causal; and the
attention kernels again at the widened shapes, one layer of seeded
weights each: head_dim 64 at
Qwen2-0.5B's 14 / 2 heads, Qwen2-7B's 28 / 4 heads, page 32, and a
``DORA_SPEC_K=10`` verify at Qwen2-1.5B's group of 6 (66 rows), each beside
SDPA alone and the library chain (RMSNorm, cuBLAS qkv and wo on the
dequantized weights, SDPA), with the LoRA kernel at rank 256. It checks the tensor-core helper of kernels 4 and
10 (one m16n8k16 tile, fragments built by the sweeps' layout) and the
fragment path of kernels 1 and 2's int8-weight product (one 16 x 16 bf16
tile by a 16 x 16 int8 tile: ldmatrix, ldmatrix.trans of the int8 bytes,
their widening, the mma) against ``torch.matmul``; it times kernels 7 and
11 at those shapes and kernels 1 and 2 at 1, 16, 80 and 256 rows, launch
by launch (``breakdown`` lines: each launch's device time from
``torch.profiler``, their sum, the wrapper on
CUDA events and on the host, the library products and chain, the bound),
and the attention sublayers of kernels 3-5 and 8-10 the same way
(``sublayer`` lines, with SDPA alone, the library chain of RMSNorm,
cuBLAS products on the dequantized weights and SDPA, and the bound).

``fidelity`` lines hold the tensor-core sweeps' kernels 3-5 and 8-10
and their plain versions to an f32 reference (kernel 4 on phase 4's
prompts; kernel 3 in both KV forms; each must sit within RMS_MARGIN of its
plain version's distance), and kernel 11 and its plain version to f64 at
the ViT's shape and causal over 2048 rows. ``--kernels-only`` stops after
phase 3, ``--breakdown`` runs only kernel 6's lines and the ``breakdown``,
``sublayer`` and ``fidelity`` lines, ``--paths`` only phases 4, 6, 9
and 10, phase 12's main path and the VLM's ``generate`` (prefill chunk, window, spec-on window,
dense step and its short prompts' TTFT, batch-1 prefill, ``run_loop``
pass, VLM step and ViT times; the windows and the dense step graphed and
eager), ``--hf-vlm`` only phase 15, ``--operators`` only phase 16,
``--hub`` only phase 17, ``--train`` only phase 18, ``--bench`` only
phase 19, ``--dataflow`` only phase 20, ``--cluster`` only phase 20 (b)
and phase 21, ``--observe`` only phase 20 (b) with its traced leg, phase 21
and phase 22, and ``--operators-dataflow`` only phase 23, all without the
result line.

Phases 4, 6, 8 and 9 build their engines through the normal factories,
so each decode window (the dense step) is one CUDA-graph replay, and each
then serves its requests again on a ``graphs=False`` engine: every graphed
stream must equal its eager stream token for token, or the run fails
naming the phase, the stream and the token. The wrappers count a graph's
launches once per replay, so launch counts are those that ran. Each of
those phases also prints a ``graph`` line (captures at warmup, and after
three new prompt lengths and a set_window round trip K 8 -> 4 -> 8; the
run fails if the count grew) and a ``paths`` line (window, prefill chunk
and TTFT times, graphed against eager); phases 4, 6 and 9 ``trace`` lines
(one window, or dense step, with every slot decoding, graphed and eager:
wall ms, the kernels' summed device ms from ``torch.profiler``, the device
busy share as the union of kernel intervals over the wall, and the launch
count); phase 4 the ``device plane`` line (the engine's host dispatch /
device compute / fetch split, useful over dispatched FLOPs,
``DeviceMonitor.memory()`` and the MFU its peak implies).

It prints the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that line; so does a machine without CUDA or a directory without the port.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12    # dense bf16 tensor-core peak
# Kernel checks: max|kernel - plain| / max|plain|, each limit about three
# times what this script's seeded inputs show on an H100 (PERF.md). bf16
# intermediates (norm output, attention weights, K/V, activations) round at
# the same points in both versions but from f32 sums taken in another order.
REL_TOL = {
    "mlp_step": 1e-2,                    # seen 8.2e-4 (1 row), 5.3e-3 (16), 2.6e-3 (80), 2.3e-3 (256)
    "lm_head_argmax": 3e-5,              # the max logits; seen 1.3e-7 (1), 6.1e-7 (16), 7.1e-7 (80), 1.1e-6 (256)
    "attention_paged_batch_step": 3e-3,  # seen 9.2e-4
    "attention_paged_chunk_step": 1.3e-2,  # seen 4.3e-3
    "attention_paged_spec_step": 6e-3,     # seen 3.3e-4; 1.5e-3 (Qwen2-7B), 1.7e-3 (m = 11)
    "pools": 3e-3,                       # K/V written; seen 0, 2.0e-4 and 7.8e-4
    "attention_paged_batch_step_int8kv": 3e-3,   # seen 9.5e-4
    "attention_paged_chunk_step_int8kv": 1.3e-2,  # seen 4.1e-3
    "attention_paged_spec_step_int8kv": 5e-3,     # seen 3.3e-4
    "int8kv_scales": 1e-6,               # scales of the rows written; seen 1.6e-7 .. 2.4e-7
    "lora_gather_matmul": 6e-3,          # seen 1.3e-4 (16 rows), 1.0e-3 (80), 1.9e-3 (256)
    "int8_matmul": 5e-3,                 # seen 1.1e-3 (head), 4.7e-6 (16 rows), 1.6e-3 (256)
    "attention_batch_step": 3e-3,        # seen 5.5e-5; 2.1e-4 (Qwen2-7B)
    "attention_step": 1.2e-2,            # seen 4.1e-3: one bf16 step of its one row's largest output
    "attention_chunk_step": 1.3e-2,      # seen 3.6e-3 (3.2e-4 residual=False)
    "flash_attention": 6e-3,             # the bf16 output's rounding; seen 1.4e-3 (ViT), 5.9e-4 (causal 2048)
    # int4 weights (phase 3 on phase 12's weights)
    "mlp_step_int4": 8e-3,                   # seen 0 (1 row), 2.6e-3 (16), 2.4e-3 (80), 2.3e-3 (256)
    "lm_head_argmax_int4": 1e-6,             # seen 6.4e-8 (1), 5.9e-8 (16), 2.4e-7 (256)
    "attention_paged_batch_step_int4": 1.2e-3,   # seen 4.0e-4
    "attention_paged_chunk_step_int4": 1.4e-2,   # seen 4.7e-3
    "attention_paged_spec_step_int4": 1.2e-3,    # seen 4.1e-4
    "attention_batch_step_int4": 8e-4,           # seen 2.4e-4
    "attention_step_int4": 1.2e-2,           # seen 0; one bf16 step of its row, as attention_step
    "attention_chunk_step_int4": 1.2e-2,     # seen 4.0e-3
}
SPEC_K = 4         # drafts per verify in phase 6: m = 5 candidate rows a stream
HEAD_TIE = 1e-3    # logits this close may pick either token (kernel check)
# Served tokens (phase 5): where a served stream parts from the plain path,
# both tokens must be within NEAR_TIE of the f32 plain path's top logit
# (partings seen at 0.010..0.029, logit std 0.79), and the kernel path's
# logits may be at most RMS_MARGIN times as far (RMS) from that f32
# reference as the bf16 plain path's.
NEAR_TIE = 0.05
RMS_MARGIN = 1.5
# Phase 7 compares two bf16 kernel paths, the served spec + cache path and
# the spec-off, cache-off one: the served token is held to NEAR_TIE, the
# reference's to twice that, each path's own near-tie band (a reference
# token seen 0.0525 below the f32 top where the served token was the top).
SPEC_REF_TIE = 2 * NEAR_TIE
# Phase 8: seeded adapters t0..t3 at these ranks (the stack is rank 32 and
# the smaller ones are zero-padded into it), normal with this std in both
# factors: a residual row x gets a delta of norm about std^2 * sqrt(r * dim)
# * |x|, 0.10 to 0.20 of |x| at dim 1536, in each of the 28 layers, so the
# tenants' tokens part from the base model's.
ADAPTER_RANKS = {"t0": 8, "t1": 16, "t2": 16, "t3": 32}
ADAPTER_STD = 0.03
TENANT_SPEC_MAX_NEW = 32  # phase 8's short spec-on run
# Phase 9: prompt lengths (three <= 32 tokens: their prefill runs in
# int8_matmul); phase 10 takes two of them.
DENSE_LENGTHS = (8, 20, 32, 100, 212, 325, 438, 550, 662, 775, 888, 1000)
BATCH1_PICKS = (1, 11)
# Kernel 7 (int8_matmul) at the shapes the paths give it: the head on the
# one row of a dense or VLM prefill; the four block products at the 16 and
# 32 rows of a short prompt (layers.matmul sends <= 32 rows to the kernel);
# w_gateup and w_down at 256 rows (a DORA_INT8_PURE prefill chunk).
INT8_SHAPES = (("lm_head", 1),
               *((w, m) for m in (16, 32) for w in ("wqkv", "wo", "w_gateup", "w_down")),
               ("w_gateup", 256), ("w_down", 256))
# Kernel 11 (flash_attention): the bench_2b ViT's (B, H, T, D), full, and
# causal self-attention over 2048 rows at Qwen2-1.5B's 12 heads of 128 and
# Qwen2-0.5B's 14 of 64 (a training loss); all in the vision tower's layout,
# [B, T, H, D] projections seen as [B, H, T, D].
FLASH_SHAPES = (((1, 16, 256, 80), False), ((1, 12, 2048, 128), True),
                ((1, 14, 2048, 64), True))


class Failed(Exception):
    pass


def _sh(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _rel(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def _time_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


#: the kernels of the spec-off serving path (phase 4)
SPEC_OFF_KERNELS = ("attention_paged_chunk_step", "attention_paged_batch_step", "mlp_step",
                    "lm_head_argmax")


class _PlainCalls:
    """Counts every call of a plain version while it is installed."""

    NAMES = tuple(f"{n}_plain" for n in SPEC_OFF_KERNELS) + (
        "attention_paged_spec_step_plain", "attention_batch_step_plain",
        "attention_step_plain", "attention_chunk_step_plain")

    def __init__(self, DB, LO):
        from dora_tpu_torch.ops import flash_attention as FA
        from dora_tpu_torch.ops import int8_matmul as IM

        self.n = 0
        self.saved = [(DB, name, getattr(DB, name)) for name in self.NAMES]
        self.saved.append((LO, "lora_gather_matmul_plain", LO.lora_gather_matmul_plain))
        self.saved.append((IM, "int8_matmul_plain", IM.int8_matmul_plain))
        self.saved.append((FA, "flash_attention_plain", FA.flash_attention_plain))
        for mod, name, fn in self.saved:
            setattr(mod, name, self._counting(fn))

    def _counting(self, fn):
        def run(*a, **k):
            self.n += 1
            return fn(*a, **k)
        return run

    def restore(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _reset_launches(DB, LO) -> None:
    from dora_tpu_torch.ops import flash_attention as FA
    from dora_tpu_torch.ops import int8_matmul as IM

    DB.reset_launches()
    LO.reset_launches()
    IM.reset_launches()
    FA.reset_launches()


def _launches(DB, LO) -> dict:
    """Every kernel's launches since _reset_launches, int8-KV forms apart."""
    from dora_tpu_torch.ops import flash_attention as FA
    from dora_tpu_torch.ops import int8_matmul as IM

    return {**DB.launch_counts(), "lora_gather_matmul": LO.lora_gather_matmul.launches,
            "int8_matmul": IM.int8_matmul.launches,
            "flash_attention": FA.flash_attention.launches}


def _check_streams(out: dict, max_new: int, vocab: int) -> None:
    for i, toks in out.items():
        if len(toks) != max_new:
            raise Failed(f"request {i} finished with {len(toks)} of {max_new} tokens")
        if not all(0 <= t < vocab for t in toks):
            raise Failed(f"request {i} emitted a token outside the vocab")


#: the ``trace`` lines' window: every slot decodes a prompt of TRACE_PROMPT
#: tokens toward TRACE_MAX_NEW new ones
TRACE_PROMPT = 64
TRACE_MAX_NEW = 400


def _same_streams(what: str, graphed: dict, eager: dict, n: int) -> None:
    """Each graphed stream equals its graphs=False stream over the first n
    tokens; the first difference fails the run, naming the stream and the
    token index."""
    for i in sorted(eager):
        t = _first_parting(graphed[i], eager[i], n)
        if t < n:
            raise Failed(f"{what}: graphed stream {i} differs from its graphs=False stream at "
                         f"token {t} ({graphed[i][t]} against {eager[i][t]})")
    print(f"{what}: all {len(eager)} graphed streams equal their graphs=False streams token "
          f"for token ({n} tokens each)", flush=True)


def _timed(torch, engine) -> dict:
    """Host times, each ending in a sync, of every decode window (the dense
    engine's step) and every prefill chunk the engine runs from now on."""
    times = {"window": [], "chunk": []}

    def timing(fn, key):
        def run(*a):
            if key == "chunk":
                torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t)
            return res
        return run

    if hasattr(engine, "window_step"):
        engine.window_step = timing(engine.window_step, "window")
        engine.chunk_prefill = timing(engine.chunk_prefill, "chunk")
    else:
        engine.runner = timing(engine.runner, "window")
    return times


def _ms(xs) -> str:
    if not xs:
        return "none"
    return f"mean {1e3 * sum(xs) / len(xs):.3f} median {1e3 * sorted(xs)[len(xs) // 2]:.3f}"


def path_line(what: str, graphed: dict, eager: dict, ttft_g, ttft_e) -> None:
    """The ``paths`` line: a phase's window (or step), prefill chunk and
    TTFT times, graphed against graphs=False, from one call."""
    tg, te = sorted(ttft_g), sorted(ttft_e)
    print(f"paths {what}: window ms graphed {_ms(graphed['window'])}, eager "
          f"{_ms(eager['window'])}; prefill chunk ms graphed {_ms(graphed['chunk'])}, eager "
          f"{_ms(eager['chunk'])}; TTFT p50 s graphed {tg[len(tg) // 2]:.4f}, eager "
          f"{te[len(te) // 2]:.4f}", flush=True)


def graph_check(engine, serve_prompts, vocab: int, seed: int, what: str) -> None:
    """The ``graph`` line of a graphed engine after its phase's run: the
    captures at warmup (that run, plus one short run at K = 4 on a paged
    engine), then after serving three new prompt lengths and a set_window
    round trip K 8 -> 4 -> 8 (used keys), with each runner's replays and
    launches per replay. Fails unless the second count equals the first."""
    import numpy as np

    rng = np.random.default_rng(seed)
    paged = hasattr(engine, "set_window")

    def run(lengths):
        serve_prompts(engine, [rng.integers(0, vocab, size=n).tolist() for n in lengths], 16)

    if paged:
        k = engine.window
        engine.set_window(4)
        run((40, 300))
        engine.set_window(k)
    warm = engine.graph_captures
    run((33, 129, 517))
    if paged:
        engine.set_window(4)
        run((71,))
        engine.set_window(k)
        run((250,))
    after = engine.graph_captures
    runners = engine._window_cache if paged else {"step": engine._runner}
    per = "; ".join(f"{key}: {r.replays} replays, per replay {json.dumps(r.launches)}"
                    for key, r in runners.items())
    print(f"graph {what}: captures {warm} at warmup, {after} after 3 new prompt lengths"
          + (" and a set_window round trip" if paged else "") + f"; {per}", flush=True)
    if after != warm:
        raise Failed(f"graph {what}: {after - warm} capture(s) after warmup")


def _union_us(spans) -> float:
    """The length of the union of sorted (start, end) intervals."""
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def trace_window(torch, engine, vocab: int, seed: int, what: str, traces: int = 3) -> None:
    """The ``trace`` line of one decode window (the dense engine's step)
    with every slot decoding: ``traces`` consecutive windows, each traced
    alone with ``torch.profiler`` (CUDA activity), then one untraced. The
    profiler now and then drops kernel records, so the line gives the traced
    window that saw the most launches: its wall ms (and the untraced one's),
    its kernels' summed device ms, the device busy share (the union of
    kernel intervals over the wall) and the launch count, with every traced
    window's count beside it."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed)
    for i in range(engine.max_slots):
        engine.submit(f"trace{i}", rng.integers(0, vocab, size=TRACE_PROMPT).tolist(),
                      TRACE_MAX_NEW)
    while getattr(engine, "prefilling", 0):
        engine.step()
    engine.step()  # the membership settles
    seen = []
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not e.name.startswith(("Memcpy", "Memset")))
        seen.append((len(spans), wall, spans))
    t = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t
    if engine.active != engine.max_slots:
        raise Failed(f"trace {what}: a traced stream finished during the trace")
    n, wall, spans = max(seen, key=lambda x: x[0])
    head = (f"trace {what}: wall {1e3 * wall:.3f} ms traced ({1e3 * untraced:.3f} ms the "
            f"next, untraced)")
    if not spans:
        print(f"{head}; device time not measured (the profiler saw no kernel)", flush=True)
        return
    busy = _union_us(spans)
    # The profiler adds its own host time to every launch of the traced
    # window, so the busy share is given over both walls.
    print(f"{head}; device {sum(e - s for s, e in spans) / 1e3:.3f} ms in {n} kernel launches "
          f"(traced windows saw {[x[0] for x in seen]}); busy share {busy / (wall * 1e6):.3f} "
          f"of the traced wall, {busy / (untraced * 1e6):.3f} of the untraced one "
          f"({busy / 1e3:.3f} ms of kernel intervals' union)", flush=True)


def device_plane_line(engine, wall: float, n_tok: int) -> None:
    """The ``device plane`` line of a paged engine after a run of ``wall``
    seconds that emitted ``n_tok`` tokens: the engine's time split and FLOPs
    ledger, ``DeviceMonitor.memory()`` and the MFU that
    ``device_peak_flops`` implies."""
    from dora_tpu_torch.profiling import DeviceMonitor

    d, u, peak = engine.dispatched_flops, engine.useful_flops, engine.device_peak_flops
    if not (engine.device_monitor and d and engine.device_compute_ns):
        raise Failed("the device plane recorded nothing on the monitored engine")
    if peak:
        source = ("the H100 SXM data sheet's dense bf16" if peak == 989e12
                  else "DORA_DEVICE_PEAK_FLOPS")
        mfu = (f"MFU {u / wall / peak:.4%} over the run's wall, "
               f"{u / (engine.device_compute_ns / 1e9) / peak:.4%} over device_compute_ns, at a "
               f"peak of {peak:.4g} FLOP/s ({source})")
    else:
        mfu = "MFU not measured (no peak known for this card)"
    print(f"device plane: a run of {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} "
          f"tokens/s, no timing wrapper); host_dispatch_ns {engine.host_dispatch_ns}, "
          f"device_compute_ns "
          f"{engine.device_compute_ns}, device_fetch_ns {engine.device_fetch_ns}; useful_flops "
          f"{u} / dispatched_flops {d} = {u / d:.4f}; memory "
          f"{json.dumps(DeviceMonitor('cuda').memory())}; {mfu}", flush=True)


def check_kernels(torch, DB, qwen2, params, cfg, rng_seed: int) -> list[dict]:
    """Phase 3: every kernel against its plain version at serving shapes."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    blk = params["blocks"]["0"]
    d, hd, h, kv = cfg.dim, cfg.head_dim, cfg.heads, cfg.kv_heads
    n_qkv = (h + 2 * kv) * hd
    f = cfg.ffn
    page, n_pool, slots, chunk = 16, 4 * cfg.max_seq // 16, 16, 256
    embed = params["embed"]

    def rows(m):
        tok = torch.randint(0, cfg.vocab, (m,), generator=gen, device=dev)
        return embed[tok].to(torch.bfloat16)

    out = []

    def agree(name, rel, what=""):
        tol = REL_TOL[name]
        print(f"kernel {name}{what}: rel {rel:.3e} (tol {tol})", flush=True)
        if not rel <= tol:
            raise Failed(f"{name}{what} disagrees with its plain version: rel {rel:.3e}")

    def pools_agree(name, k_got, k_want, v_got, v_want):
        _, rel_k = _rel(k_got, k_want)
        _, rel_v = _rel(v_got, v_want)
        agree("pools", max(rel_k, rel_v), f" written by {name} (k {rel_k:.3e} v {rel_v:.3e})")

    # int8-KV forms: int8 pools of n_pool8 pages (the fp pool's byte budget at
    # this width) with their scale planes, quantized from seeded normals.
    n_pool8 = n_pool * qwen2.page_pool_bytes(cfg, page) // qwen2.page_pool_bytes(
        cfg, page, kv_int8=True)
    shape8 = (n_pool8, kv, page, hd)
    kq8, ks8 = DB.kv_quant_rows(torch.randn(shape8, generator=gen, device=dev))
    vq8, vs8 = DB.kv_quant_rows(torch.randn(shape8, generator=gen, device=dev))
    pools8 = (kq8, vq8, ks8, vs8)

    def fresh8():
        return [t.clone() for t in pools8]

    def int8_writes(name, got, want, written):
        """Rows the int8 form wrote: within 1 LSB of the plain version's,
        scales within REL_TOL["int8kv_scales"]; every other value and scale
        of pages 1.. bit-unchanged (frozen streams race on the null page)."""
        w = written.clone()
        w[0] = False
        keep = ~written
        keep[0] = False
        n_diff = n_bytes = 0
        for qg, qw, q0 in zip(got[:2], want[:2], pools8[:2]):
            step = (qg[w].int() - qw[w].int()).abs()
            if int(step.max()) > 1:
                raise Failed(f"{name}: written int8 rows more than 1 LSB from its plain version")
            n_diff += int((step > 0).sum())
            n_bytes += step.numel()
            if not torch.equal(qg[keep], q0[keep]):
                raise Failed(f"{name} changed int8 pool rows it does not own")
        srel = 0.0
        for sg, sw, s0 in zip(got[2:], want[2:], pools8[2:]):
            srel = max(srel, _rel(sg[w], sw[w])[1])
            if not torch.equal(sg[keep], s0[keep]):
                raise Failed(f"{name} changed scale entries it does not own")
        agree("int8kv_scales", srel, f" written by {name}")
        print(f"kernel {name}: {int(w[:, 0].sum())} rows written per kv head; {n_diff} of "
              f"{n_bytes} written int8 bytes 1 LSB from the plain version "
              f"({n_diff / max(n_bytes, 1):.3%}); every unwritten value and scale of pages "
              f"1.. bit-unchanged", flush=True)

    def ctx8(table, n_keys=None):
        """The dequantized context of int8 pools through ``table`` rows, as
        the SDPA yardstick takes it ([rows, H, keys, hd])."""
        t = table.long() if table.dim() == 2 else table.long()[None]
        k = DB.kv_dequant(kq8[t], ks8[t], torch.bfloat16)
        v = DB.kv_dequant(vq8[t], vs8[t], torch.bfloat16)
        n = t.shape[1] * page
        k = k.permute(0, 2, 1, 3, 4).reshape(t.shape[0], kv, n, hd)[:, :, :n_keys]
        v = v.permute(0, 2, 1, 3, 4).reshape(t.shape[0], kv, n, hd)[:, :, :n_keys]
        return k.repeat_interleave(h // kv, dim=1), v.repeat_interleave(h // kv, dim=1)

    def record(name, route_src, replaces, err, rel, ms, plain_ms, lib_ms, nbytes, ops):
        bound, by = _bound_ms(nbytes, ops)
        print(f"kernel {name}: max_abs_err {err:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} bound_ms {bound:.4f} ({by})", flush=True)
        agree(name, rel)
        out.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms,
        })

    wgu, sgu = blk["w_gateup"]["int8"], blk["w_gateup"]["scale"]
    wd, sd = blk["w_down"]["int8"], blk["w_down"]["scale"]
    wgu_bf, wd_bf = (wgu.float() * sgu).bfloat16(), (wd.float() * sd).bfloat16()
    wh, sh = params["lm_head"]["int8"], params["lm_head"]["scale"]
    wh_bf = (wh.float() * sh).bfloat16()

    # mlp_step: decode (16 rows) is the entry; batch 1 (1 row), spec verify
    # (80 rows) and prefill (256 rows) printed too.
    for m in (1, slots, slots * (SPEC_K + 1), chunk):
        x = rows(m)
        args = (x, blk["ffn_norm"], wgu, sgu, blk.get("b_gateup"), wd, sd)
        want = DB.mlp_step_plain(*args)
        got = DB.mlp_step(*args)
        err, rel = _rel(got, want)
        hx = x  # the yardstick's products on the same rows

        def lib():
            gu = torch.matmul(hx, wgu_bf)
            return torch.matmul(gu[:, :f], wd_bf)

        nbytes = m * d * 2 * 2 + d * 4 + d * 2 * f + 2 * f * 4 + f * d + d * 4
        ops = 2 * m * d * 2 * f + 2 * m * f * d
        if m == slots:
            record("mlp_step", "dora_tpu_torch/csrc/mlp.cu",
                   "dora_tpu/ops/decode_block.py:2130", err, rel,
                   _time_ms(torch, lambda: DB.mlp_step(*args)),
                   _time_ms(torch, lambda: DB.mlp_step_plain(*args), 5),
                   _time_ms(torch, lib), nbytes, ops)
        else:
            bound, by = _bound_ms(nbytes, ops)
            agree("mlp_step", rel, f" at {m} rows")
            print(f"kernel mlp_step at {m} rows: ms "
                  f"{_time_ms(torch, lambda: DB.mlp_step(*args), 5):.4f} plain_ms "
                  f"{_time_ms(torch, lambda: DB.mlp_step_plain(*args), 3):.4f} "
                  f"library_ms {_time_ms(torch, lib, 5):.4f} bound_ms {bound:.4f} ({by})",
                  flush=True)

    # lm_head_argmax: tokens equal except at plain near-ties; 1, 16, 80, 256 rows.
    for m in (1, slots, slots * (SPEC_K + 1), chunk):
        x = rows(m)
        args = (x, params["out_norm"], wh, sh)
        hn = DB._rms(x, params["out_norm"], cfg.norm_eps).to(torch.bfloat16)
        logits = DB._wdot(hn, wh, sh)
        top2 = logits.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        want_i, want_v = DB.lm_head_argmax_plain(*args, return_val=True)
        got_i, got_v = DB.lm_head_argmax(*args, return_val=True)
        bad = (got_i != want_i) & (gap >= HEAD_TIE)
        err, rel = _rel(got_v, want_v)
        n_diff = int((got_i != want_i).sum())
        if bool(bad.any()):
            raise Failed(f"lm_head_argmax picks other tokens than its plain version "
                         f"away from ties at {m} rows")
        print(f"kernel lm_head_argmax at {m} rows: {n_diff} token(s) differ, all at "
              f"top-2 gaps < {HEAD_TIE}", flush=True)

        def lib():
            return torch.matmul(hn, wh_bf).argmax(dim=-1)

        nbytes = m * d * 2 + d * 4 + d * cfg.vocab + cfg.vocab * 4 + m * 4
        ops = 2 * m * d * cfg.vocab
        if m == slots:
            record("lm_head_argmax", "dora_tpu_torch/csrc/lm_head.cu",
                   "dora_tpu/ops/decode_block.py:2228", err, rel,
                   _time_ms(torch, lambda: DB.lm_head_argmax(*args)),
                   _time_ms(torch, lambda: DB.lm_head_argmax_plain(*args), 5),
                   _time_ms(torch, lib), nbytes, ops)
        else:
            bound, by = _bound_ms(nbytes, ops)
            agree("lm_head_argmax", rel, f" at {m} rows")
            print(f"kernel lm_head_argmax at {m} rows: ms "
                  f"{_time_ms(torch, lambda: DB.lm_head_argmax(*args), 5):.4f} plain_ms "
                  f"{_time_ms(torch, lambda: DB.lm_head_argmax_plain(*args), 3):.4f} "
                  f"library_ms {_time_ms(torch, lib, 5):.4f} bound_ms {bound:.4f} ({by})",
                  flush=True)

    # attention: a pool with live context at serving positions.
    from dora_tpu_torch.models.layers import rope_table

    cos_t, sin_t = rope_table(cfg.max_seq, hd, base=cfg.rope_theta, device=dev)
    wqkv, sqkv = blk["wqkv"]["int8"], blk["wqkv"]["scale"]
    wo, swo = blk["wo"]["int8"], blk["wo"]["scale"]
    bqkv = blk.get("bqkv")
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, eps=cfg.norm_eps)
    shape = (n_pool, kv, page, hd)
    kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vp = torch.randn(shape, generator=gen, device=dev).bfloat16()
    positions = [int(p) for p in torch.linspace(30, 940, slots).round().tolist()]
    positions[3] = 0  # one frozen row (position 0, zeroed table row)
    bt = torch.zeros((slots, cfg.max_seq // page), dtype=torch.int32)
    nxt = 1
    for b, p in enumerate(positions):
        if p == 0:
            continue
        n = p // page + 1
        bt[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    if nxt > n_pool:
        raise Failed("kernel check positions overflow the pool")
    bt = bt.to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    x = rows(slots)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, pos)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    want, _, _ = DB.attention_paged_batch_step_plain(
        x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, k1, v1, wo, swo, pos, bt, **kw)
    got, _, _ = DB.attention_paged_batch_step(
        x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, k2, v2, wo, swo, pos, bt, **kw)
    err, rel = _rel(got, want)
    # page 0 is left out: frozen rows race to write it (see paged_attention.cu)
    pools_agree("attention_paged_batch_step", k2[1:], k1[1:], v2[1:], v1[1:])
    ctx = sum(positions)
    q_sdpa = torch.randn((slots, h, 1, hd), generator=gen, device=dev).bfloat16()
    maxp = bt.shape[1]
    kctx = kp[bt.long()].permute(0, 2, 1, 3, 4).reshape(slots, kv, maxp * page, hd)
    vctx = vp[bt.long()].permute(0, 2, 1, 3, 4).reshape(slots, kv, maxp * page, hd)
    kctx = kctx.repeat_interleave(h // kv, dim=1)
    vctx = vctx.repeat_interleave(h // kv, dim=1)
    mask = (torch.arange(maxp * page, device=dev)[None, :] <= pos[:, None])[:, None, None, :]

    def lib_batch():
        return torch.nn.functional.scaled_dot_product_attention(q_sdpa, kctx, vctx, attn_mask=mask)

    bargs = (x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, k2, v2, wo, swo, pos, bt)
    nbytes = (slots * d * 2 * 2 + d * 4 + d * n_qkv + n_qkv * 8 + slots * hd * 8
              + h * hd * d + d * 4 + slots * 4 + bt.numel() * 4
              + ctx * kv * hd * 2 * 2 + slots * kv * hd * 2 * 2)
    ops = 2 * slots * d * n_qkv + 2 * 2 * h * hd * (ctx + slots) + 2 * slots * h * hd * d
    record("attention_paged_batch_step", "dora_tpu_torch/csrc/paged_attention.cu",
           "dora_tpu/ops/decode_block.py:1163", err, rel,
           _time_ms(torch, lambda: DB.attention_paged_batch_step(*bargs, **kw)),
           _time_ms(torch, lambda: DB.attention_paged_batch_step_plain(*bargs, **kw), 5),
           _time_ms(torch, lib_batch), nbytes, ops)

    # batch, int8 KV: the same rows, positions and tables
    written8 = torch.zeros((n_pool8, kv, page), dtype=torch.bool)
    for b, p in enumerate(positions):
        written8[int(bt[b, p // page]), :, p % page] = True
    written8[0] = True
    p1, p2 = fresh8(), fresh8()
    b8 = [(x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, P[0], P[1], wo, swo, pos, bt,
           P[2], P[3]) for P in (p1, p2)]
    want, *pw = DB.attention_paged_batch_step_plain(*b8[0], **kw)
    got, *pg = DB.attention_paged_batch_step(*b8[1], **kw)
    err, rel = _rel(got, want)
    int8_writes("attention_paged_batch_step_int8kv", pg, pw, written8.to(dev))
    kctx8, vctx8 = ctx8(bt)

    def lib_batch8():
        return torch.nn.functional.scaled_dot_product_attention(q_sdpa, kctx8, vctx8,
                                                                attn_mask=mask)

    kv8_row = kv * (hd + 4) * 2  # one row of K and V in int8 plus their scales
    nbytes8 = (slots * d * 2 * 2 + d * 4 + d * n_qkv + n_qkv * 8 + slots * hd * 8
               + h * hd * d + d * 4 + slots * 4 + bt.numel() * 4
               + ctx * kv8_row + slots * kv8_row)
    record("attention_paged_batch_step_int8kv", "dora_tpu_torch/csrc/paged_attention.cu",
           "dora_tpu/ops/decode_block.py:1163", err, rel,
           _time_ms(torch, lambda: DB.attention_paged_batch_step(*b8[1], **kw)),
           _time_ms(torch, lambda: DB.attention_paged_batch_step_plain(*b8[0], **kw), 5),
           _time_ms(torch, lib_batch8), nbytes8, ops)

    # chunk: the third 256-row chunk of a prompt (position 512).
    position = 2 * chunk
    btr = torch.arange(1, cfg.max_seq // page + 1, dtype=torch.int32, device=dev)
    x = rows(chunk)
    cr, sr = DB.rope_rows(cos_t, sin_t, position, chunk)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    cargs1 = (x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, k1, v1, wo, swo, position, btr)
    cargs2 = (x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, k2, v2, wo, swo, position, btr)
    want, _, _ = DB.attention_paged_chunk_step_plain(*cargs1, **kw)
    got, _, _ = DB.attention_paged_chunk_step(*cargs2, **kw)
    err, rel = _rel(got, want)
    pools_agree("attention_paged_chunk_step", k2, k1, v2, v1)
    n_keys = position + chunk
    qc = torch.randn((1, h, chunk, hd), generator=gen, device=dev).bfloat16()
    kc = kp[btr[: n_keys // page].long()].permute(1, 0, 2, 3).reshape(1, kv, n_keys, hd)
    vc = vp[btr[: n_keys // page].long()].permute(1, 0, 2, 3).reshape(1, kv, n_keys, hd)
    kc = kc.repeat_interleave(h // kv, dim=1)
    vc = vc.repeat_interleave(h // kv, dim=1)
    cmask = (torch.arange(n_keys, device=dev)[None, :]
             <= position + torch.arange(chunk, device=dev)[:, None])

    def lib_chunk():
        return torch.nn.functional.scaled_dot_product_attention(qc, kc, vc, attn_mask=cmask)

    nbytes = (chunk * d * 2 * 2 + d * 4 + d * n_qkv + n_qkv * 8 + chunk * hd * 8
              + h * hd * d + d * 4 + btr.numel() * 4
              + position * kv * hd * 2 * 2 + chunk * kv * hd * 2 * 2)
    causal_keys = chunk * position + chunk * (chunk + 1) // 2
    ops = 2 * chunk * d * n_qkv + 2 * 2 * h * hd * causal_keys + 2 * chunk * h * hd * d
    record("attention_paged_chunk_step", "dora_tpu_torch/csrc/paged_attention.cu",
           "dora_tpu/ops/decode_block.py:1505", err, rel,
           _time_ms(torch, lambda: DB.attention_paged_chunk_step(*cargs2, **kw)),
           _time_ms(torch, lambda: DB.attention_paged_chunk_step_plain(*cargs1, **kw), 5),
           _time_ms(torch, lib_chunk), nbytes, ops)

    # chunk, int8 KV: the chunk's 16 pages and their scale rows written whole
    written8 = torch.zeros((n_pool8, kv, page), dtype=torch.bool)
    written8[btr[position // page : (position + chunk) // page].long().cpu()] = True
    written8[0] = True
    p1, p2 = fresh8(), fresh8()
    c8 = [(x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, P[0], P[1], wo, swo, position, btr,
           P[2], P[3]) for P in (p1, p2)]
    want, *pw = DB.attention_paged_chunk_step_plain(*c8[0], **kw)
    got, *pg = DB.attention_paged_chunk_step(*c8[1], **kw)
    err, rel = _rel(got, want)
    int8_writes("attention_paged_chunk_step_int8kv", pg, pw, written8.to(dev))
    kc8, vc8 = ctx8(btr[: n_keys // page])

    def lib_chunk8():
        return torch.nn.functional.scaled_dot_product_attention(qc, kc8, vc8, attn_mask=cmask)

    nbytes8 = (chunk * d * 2 * 2 + d * 4 + d * n_qkv + n_qkv * 8 + chunk * hd * 8
               + h * hd * d + d * 4 + btr.numel() * 4 + (position + chunk) * kv8_row)
    record("attention_paged_chunk_step_int8kv", "dora_tpu_torch/csrc/paged_attention.cu",
           "dora_tpu/ops/decode_block.py:1505", err, rel,
           _time_ms(torch, lambda: DB.attention_paged_chunk_step(*c8[1], **kw)),
           _time_ms(torch, lambda: DB.attention_paged_chunk_step_plain(*c8[0], **kw), 5),
           _time_ms(torch, lib_chunk8), nbytes8, ops)

    # spec verify: 16 streams x m candidate rows. Stream 0's rows straddle a
    # page (14..18), stream 3 is frozen, contexts reach 990; streams past 512
    # share the first 32 pages, as streams on a cached system prefix do.
    m = SPEC_K + 1
    bm = slots * m
    positions = [int(p) for p in torch.linspace(14, 990, slots).round().tolist()]
    positions[3] = 0
    shared_n = 32
    bt = torch.zeros((slots, cfg.max_seq // page), dtype=torch.int32)
    nxt = 1 + shared_n
    for b, p in enumerate(positions):
        if p == 0:
            continue
        n = -(-(p + m) // page)
        first = shared_n if p >= shared_n * page else 0
        bt[b, :first] = torch.arange(1, 1 + first, dtype=torch.int32)
        bt[b, first:n] = torch.arange(nxt, nxt + n - first, dtype=torch.int32)
        nxt += n - first
    if nxt > n_pool:
        raise Failed("spec kernel check positions overflow the pool")
    written = torch.zeros((n_pool, kv, page), dtype=torch.bool)
    ctx_rows = torch.zeros((n_pool, page), dtype=torch.bool)
    for b, p in enumerate(positions):
        if p == 0:
            continue
        for r in range(p, p + m):
            written[bt[b, r // page], :, r % page] = True
        for r in range(p):
            ctx_rows[bt[b, r // page], r % page] = True
    written, bt = written.to(dev), bt.to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    flat = (pos[:, None] + torch.arange(m, dtype=torch.int32, device=dev)[None, :]).reshape(bm)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, flat)
    x = rows(bm)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    skw = dict(kw, m=m)
    sargs1 = (x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, k1, v1, wo, swo, pos, bt)
    sargs2 = (x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, k2, v2, wo, swo, pos, bt)
    want, _, _ = DB.attention_paged_spec_step_plain(*sargs1, **skw)
    got, _, _ = DB.attention_paged_spec_step(*sargs2, **skw)
    err, rel = _rel(got, want)
    pools_agree("attention_paged_spec_step", k2[1:], k1[1:], v2[1:], v1[1:])
    keep = ~written
    keep[0] = False  # frozen streams race to write the null page
    if not (torch.equal(k2[keep], kp[keep]) and torch.equal(v2[keep], vp[keep])):
        raise Failed("attention_paged_spec_step changed pool rows it does not own")
    n_written = int(written[1:, 0].sum())
    print(f"kernel attention_paged_spec_step: {n_written} pool rows written per kv head "
          f"(stream 0 across pages {int(bt[0, 0])} and {int(bt[0, 1])}), every other row "
          f"of pages 1.. bit-unchanged", flush=True)
    q_spec = torch.randn((slots, h, m, hd), generator=gen, device=dev).bfloat16()
    kctx = kp[bt.long()].permute(0, 2, 1, 3, 4).reshape(slots, kv, maxp * page, hd)
    vctx = vp[bt.long()].permute(0, 2, 1, 3, 4).reshape(slots, kv, maxp * page, hd)
    kctx = kctx.repeat_interleave(h // kv, dim=1)
    vctx = vctx.repeat_interleave(h // kv, dim=1)
    smask = (torch.arange(maxp * page, device=dev)[None, None, :]
             <= flat.reshape(slots, m)[:, :, None])[:, None]

    def lib_spec():
        return torch.nn.functional.scaled_dot_product_attention(q_spec, kctx, vctx,
                                                                attn_mask=smask)

    ctx = sum(positions)
    nbytes = (bm * d * 2 * 2 + d * 4 + d * n_qkv + n_qkv * 8 + bm * hd * 8
              + h * hd * d + d * 4 + slots * 4 + bt.numel() * 4
              + int(ctx_rows.sum()) * kv * hd * 2 * 2 + bm * kv * hd * 2 * 2)
    ops = (2 * bm * d * n_qkv + 2 * 2 * h * hd * (m * ctx + slots * m * (m + 1) // 2)
           + 2 * bm * h * hd * d)
    record("attention_paged_spec_step", "dora_tpu_torch/csrc/paged_attention.cu",
           "dora_tpu/ops/decode_block.py:1927", err, rel,
           _time_ms(torch, lambda: DB.attention_paged_spec_step(*sargs2, **skw)),
           _time_ms(torch, lambda: DB.attention_paged_spec_step_plain(*sargs1, **skw), 5),
           _time_ms(torch, lib_spec), nbytes, ops)

    # spec verify, int8 KV: exactly m rows and m scales per (stream, kv head)
    written8 = torch.zeros((n_pool8, kv, page), dtype=torch.bool)
    written8[: written.shape[0]] = written.cpu()
    p1, p2 = fresh8(), fresh8()
    s8 = [(x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, P[0], P[1], wo, swo, pos, bt,
           P[2], P[3]) for P in (p1, p2)]
    want, *pw = DB.attention_paged_spec_step_plain(*s8[0], **skw)
    got, *pg = DB.attention_paged_spec_step(*s8[1], **skw)
    err, rel = _rel(got, want)
    int8_writes("attention_paged_spec_step_int8kv", pg, pw, written8.to(dev))
    ks_ctx, vs_ctx = ctx8(bt)

    def lib_spec8():
        return torch.nn.functional.scaled_dot_product_attention(q_spec, ks_ctx, vs_ctx,
                                                                attn_mask=smask)

    nbytes8 = (bm * d * 2 * 2 + d * 4 + d * n_qkv + n_qkv * 8 + bm * hd * 8
               + h * hd * d + d * 4 + slots * 4 + bt.numel() * 4
               + int(ctx_rows.sum()) * kv8_row + bm * kv8_row)
    record("attention_paged_spec_step_int8kv", "dora_tpu_torch/csrc/paged_attention.cu",
           "dora_tpu/ops/decode_block.py:1927", err, rel,
           _time_ms(torch, lambda: DB.attention_paged_spec_step(*s8[1], **skw)),
           _time_ms(torch, lambda: DB.attention_paged_spec_step_plain(*s8[0], **skw), 5),
           _time_ms(torch, lib_spec8), nbytes8, ops)
    return out


def _lora_yardsticks(torch, x, g, a, b):
    """The library's two yardsticks of kernel 6 on the same inputs: one call
    of batched products over each row's gathered slabs, and one cuBLAS pair
    per distinct adapter over its rows (gathered beforehand), whose device
    time is summed (the like-for-like yardstick of the grouped kernel).
    Returns (gathered ms, grouped device ms or None)."""
    gl = g.long()
    per = [(x[g == u], a[u], b[u]) for u in torch.unique(g[g != 0]).tolist()]

    def grouped():
        for xu, au, bu in per:
            torch.matmul(torch.matmul(xu, au), bu)

    launches = _device_launches(torch, grouped) if per else []
    return (_time_ms(torch, lambda: torch.bmm(torch.bmm(x[:, None, :], a[gl]), b[gl])),
            None if launches is None else sum(ms for _, ms in launches))


def _lora_case(torch, LO, what, x, g, a, b, tol_what=""):
    """Kernel 6 on one case against its plain version: slot-0 rows exactly
    zero, within REL_TOL; prints the isolated and device times, the plain
    version's, both library yardsticks and the bound. Returns the numbers."""
    want = LO.lora_gather_matmul_plain(x, g, a, b)
    got = LO.lora_gather_matmul(x, g, a, b)
    err, rel = _rel(got, want)
    base = g == 0
    if bool(base.any()) and got[base].float().abs().max().item() != 0.0:
        raise Failed(f"lora_gather_matmul: slot-0 rows are not exactly zero {what}")
    tol = REL_TOL["lora_gather_matmul"]
    if not rel <= tol:
        raise Failed(f"lora_gather_matmul disagrees with its plain version {what}: "
                     f"rel {rel:.3e}")
    m, d = x.shape
    rank = a.shape[-1]
    distinct = int(torch.unique(g[g != 0]).numel())
    nbytes = distinct * 2 * d * rank * 2 + m * d * 2 * 2 + m * 4
    ops = 4 * int((~base).sum()) * d * rank
    bound, by = _bound_ms(nbytes, ops)
    ms = _time_ms(torch, lambda: LO.lora_gather_matmul(x, g, a, b))
    plain_ms = _time_ms(torch, lambda: LO.lora_gather_matmul_plain(x, g, a, b), 5)
    lib_ms, grouped_ms = _lora_yardsticks(torch, x, g, a, b)
    parts = _launch_parts(torch, lambda: LO.lora_gather_matmul(x, g, a, b))
    grouped = "not measured" if grouped_ms is None else f"{grouped_ms:.4f}"
    print(f"kernel lora_gather_matmul {what} ({distinct} distinct adapters, "
          f"{int(base.sum())} slot-0 rows exactly zero): rel {rel:.3e} (tol {tol}) "
          f"max_abs_err {err:.3e} ms {ms:.4f} (device: {parts}) plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} grouped library device ms {grouped} bound_ms "
          f"{bound:.4f} ({by})", flush=True)
    return err, ms, plain_ms, lib_ms, bound, by


def check_lora_kernel(torch, LO, cfg, rng_seed: int) -> dict:
    """Phase 3, kernel 6: lora_gather_matmul against its plain version at 16
    (decode), 80 (spec verify) and 256 (prefill chunk) rows, over a 9-slot
    stack of rank 32 sliced per layer as the fused pass slices it; ids mixed,
    with slot-0 rows and repeats. Then the grouped design's edges at
    Qwen2-1.5B width: 256 rows on one adapter, 16 rows each on its own
    adapter (a 17-slot stack), 16 rows all on slot 0 (exactly zero), and
    ranks 12 (not a multiple of 16) and 256 (the largest) at 16 rows.
    Returns the 16-row entry."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    d = cfg.dim

    def stack(slots, rank):
        a = (torch.randn((slots, 2, d, rank), generator=gen, device=dev) * ADAPTER_STD).bfloat16()
        b = (torch.randn((slots, 2, rank, d), generator=gen, device=dev) * ADAPTER_STD).bfloat16()
        a[0] = 0
        b[0] = 0
        return a[:, 1], b[:, 1]

    def xs(m):
        return (torch.randn((m, d), generator=gen, device=dev) * 0.5).bfloat16()

    a1, b1 = stack(9, 32)
    entry = None
    for m in (16, 80, 256):
        x = xs(m)
        g = torch.randint(0, 9, (m,), generator=gen, device=dev, dtype=torch.int32)
        g[:4] = torch.tensor([0, 0, 5, 5], dtype=torch.int32)
        err, ms, plain_ms, lib_ms, bound, by = _lora_case(torch, LO, f"at {m} rows", x, g,
                                                          a1, b1)
        if m == 16:
            entry = {"name": "lora_gather_matmul", "route": "cuda",
                     "source": "dora_tpu_torch/csrc/lora.cu",
                     "replaces": "dora_tpu/ops/lora.py:65", "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms}
    one = torch.full((256,), 7, dtype=torch.int32, device=dev)
    _lora_case(torch, LO, "at 256 rows on one adapter", xs(256), one, a1, b1)
    a17, b17 = stack(17, 32)
    distinct = (torch.randperm(16, generator=gen, device=dev) + 1).to(torch.int32)
    _lora_case(torch, LO, "at 16 rows on 16 adapters", xs(16), distinct, a17, b17)
    base = torch.zeros((16,), dtype=torch.int32, device=dev)
    _lora_case(torch, LO, "at 16 rows all on slot 0", xs(16), base, a1, b1)
    for rank in (12, 256):
        ar, br = stack(9, rank)
        g = torch.randint(0, 9, (16,), generator=gen, device=dev, dtype=torch.int32)
        g[:2] = 0
        _lora_case(torch, LO, f"at rank {rank}, 16 rows", xs(16), g, ar, br)
    return entry


def serve_slice(torch, DB, LO, qwen2, serve_prompts, params, cfg, prompts, max_new,
                seed: int):
    """Phase 4: the engine serves every prompt through the kernels, each
    window one CUDA-graph replay; then its graph, device plane, graphs=False
    reference, paths and trace lines. Returns (streams, launches, the served
    run's window and chunk times)."""

    def build(graphs=None):
        return qwen2.make_paged_engine(params, cfg, max_slots=16, page_size=16, chunk=256,
                                       window=8, spec_k=0, prefix_cache=False, device="cuda",
                                       graphs=graphs)

    engine = build()
    if not engine.graphs:
        raise Failed("phase 4's engine runs its windows eagerly")
    need = sum(engine.pages_needed(len(p), max_new) for p in prompts)
    usable = engine.allocator.num_pages - 1
    print(f"slice: {len(prompts)} requests need {need} pages of {usable} usable", flush=True)
    if need <= usable:
        raise Failed("the prompts fit the pool at once; the run would not wait for pages")

    steps = [0]
    admitted_at = {}
    inner_window, inner_chunk = engine.window_step, engine.chunk_prefill
    times = _timed(torch, engine)
    inner_submit, inner_step = engine.submit, engine.step

    def counted_submit(rid, ids, n, **kw):
        admitted_at[int(rid)] = steps[0]
        return inner_submit(rid, ids, n, **kw)

    def counted_step():
        steps[0] += 1
        return inner_step()

    engine.submit, engine.step = counted_submit, counted_step

    plain_calls = _PlainCalls(DB, LO)
    _reset_launches(DB, LO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out, ttft = serve_prompts(engine, prompts, max_new)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        launches = _launches(DB, LO)
        plain_calls.restore()
    engine.submit, engine.step = inner_submit, inner_step
    engine.window_step, engine.chunk_prefill = inner_window, inner_chunk
    times = {k: list(v) for k, v in times.items()}  # the served run's alone
    print(f"slice launches: {json.dumps(launches)}; plain calls {plain_calls.n}", flush=True)
    _check_streams(out, max_new, cfg.vocab)
    if plain_calls.n:
        raise Failed(f"{plain_calls.n} plain-version call(s) ran on the main path")
    if not all(launches[n] > 0 for n in SPEC_OFF_KERNELS):
        raise Failed(f"a kernel never launched on the main path: {launches}")
    if launches["attention_paged_spec_step"]:
        raise Failed("the spec kernel launched with speculation off")
    if any(launches[n] for n in launches if n.endswith("_int8kv") or n.startswith("lora")):
        raise Failed(f"an int8-KV or LoRA kernel launched on the fp path: {launches}")
    if max(admitted_at.values()) == 0:
        raise Failed("no request waited for pages")
    engine.check_invariants()
    window_s, chunk_s = times["window"], times["chunk"]
    n_tok = sum(len(t) for t in out.values())
    decode_tokens = n_tok - len(prompts)
    ttfts = sorted(ttft.values())
    print(f"slice: {n_tok} tokens in {wall:.3f} s; decode {decode_tokens / sum(window_s):.1f} "
          f"tokens/s over {len(window_s)} windows (K=8, window mean "
          f"{1e3 * sum(window_s) / len(window_s):.2f} ms, max {1e3 * max(window_s):.2f} ms); "
          f"end-to-end {n_tok / wall:.1f} tokens/s; TTFT p50 {ttfts[len(ttfts) // 2]:.3f} s "
          f"max {ttfts[-1]:.3f} s; {engine.chunks_run} prefill chunks of 256 rows (mean "
          f"{1e3 * sum(chunk_s) / len(chunk_s):.2f} ms, median "
          f"{1e3 * sorted(chunk_s)[len(chunk_s) // 2]:.2f} ms); "
          f"{sum(1 for s in admitted_at.values() if s > 0)} request(s) waited for pages",
          flush=True)
    # The device plane from a second run of the same requests on this
    # engine with no timing wrapper: the wrappers' syncs would land in its
    # dispatch time.
    for name in ("host_dispatch_ns", "device_compute_ns", "device_fetch_ns",
                 "dispatched_flops", "useful_flops"):
        setattr(engine, name, 0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    again, _ = serve_prompts(engine, prompts, max_new)
    torch.cuda.synchronize()
    _same_streams("slice, served again on the same graphs", out, again, max_new)
    device_plane_line(engine, time.perf_counter() - t, n_tok)
    graph_check(engine, serve_prompts, cfg.vocab, seed, "slice")

    ref = build(graphs=False)
    ref_times = _timed(torch, ref)
    ref_out, ref_ttft = serve_prompts(ref, prompts, max_new)
    _same_streams("slice", out, ref_out, max_new)
    path_line("slice (phase 4, K = 8, spec off)", times, ref_times, ttft.values(),
              ref_ttft.values())
    trace_window(torch, engine, cfg.vocab, seed + 1, "spec-off window (K = 8), graphed")
    trace_window(torch, ref, cfg.vocab, seed + 1, "spec-off window (K = 8), eager")
    return out, launches, times


class _Paths:
    """Switches the model between the kernels and the plain versions and
    reads the logits of a next token off the head on the kernel path, the
    plain path, or the plain path in f32 (the reference)."""

    NAMES = SPEC_OFF_KERNELS + ("attention_paged_spec_step", "attention_batch_step",
                                "attention_step", "attention_chunk_step")

    def __init__(self, torch, DB, LO, IM, qwen2, L, serve_prompts, params, cfg):
        from dora_tpu_torch.ops import flash_attention as FA

        self.torch, self.DB, self.IM, self.qwen2, self.L = torch, DB, IM, qwen2, L
        self.serve_prompts, self.params, self.cfg = serve_prompts, params, cfg
        self.saved = [(DB, n, getattr(DB, n)) for n in self.NAMES]
        self.saved.append((LO, "lora_gather_matmul", LO.lora_gather_matmul))
        self.saved.append((IM, "int8_matmul", IM.int8_matmul))
        self.saved.append((FA, "flash_attention", FA.flash_attention))

    def use(self, plain: bool) -> None:
        for mod, n, fn in self.saved:
            setattr(mod, n, getattr(mod, n + "_plain") if plain else fn)

    def engine(self):
        """The spec-off, cache-off engine of phase 4, eager: the plain and f32
        paths swap the wrappers a captured graph would not call again."""
        return self.qwen2.make_paged_engine(self.params, self.cfg, max_slots=16, page_size=16,
                                            chunk=256, window=8, spec_k=0, prefix_cache=False,
                                            device="cuda", graphs=False)

    def run(self, fn, mode: str):
        """``fn()`` on the ``mode`` path: "kernel", "plain" (the plain
        versions in bf16) or "f32" (the plain versions in f32)."""
        torch, L = self.torch, self.L
        bf16_dtype = L.compute_dtype
        self.use(mode != "kernel")
        if mode == "f32":
            L.compute_dtype = lambda device: torch.float32
        try:
            return fn()
        finally:
            L.compute_dtype = bf16_dtype
            self.use(plain=False)

    def logits_of(self, run, mode: str):
        """The logits [rows, vocab] of the last head that ``run()`` calls on
        the ``mode`` path ("kernel", "plain" or "f32"): a fused pass's
        ``lm_head_argmax``, or the unfused prefill's ``int8_matmul`` on the
        vocabulary (an int4 head: its ``layers.matmul`` product of the
        dequantized head). The kernel path records inside the wrappers, which
        keep counting their launches."""
        DB, IM = self.DB, self.IM
        last: list = [None]
        plain = mode != "kernel"
        head_name = "lm_head_argmax" if plain else "_lm_head_argmax_kernel"
        matmul_name = "int8_matmul" if plain else "_int8_matmul_kernel"

        def recorded():
            head, matmul = getattr(DB, head_name), getattr(IM, matmul_name)
            layers_matmul = self.L.matmul

            def layers_rec(x, w):
                out = layers_matmul(x, w)
                if isinstance(w, dict) and "int4" in w and w["int4"].shape[1] == self.cfg.vocab:
                    last[0] = out.reshape(-1, self.cfg.vocab)
                return out

            def head_rec(x, norm_w, w, s, *, eps=1e-6, return_val=False):
                last[0] = DB._wdot(DB._rms(x, norm_w, eps).to(x.dtype), w, s)
                return head(x, norm_w, w, s, eps=eps, return_val=return_val)

            def matmul_rec(x, q, s, **k):
                out = matmul(x, q, s, **k)
                if q.shape[1] == self.cfg.vocab:
                    last[0] = out.reshape(-1, q.shape[1])
                return out

            setattr(DB, head_name, head_rec)
            setattr(IM, matmul_name, matmul_rec)
            self.L.matmul = layers_rec
            try:
                run()
            finally:
                setattr(DB, head_name, head)
                setattr(IM, matmul_name, matmul)
                self.L.matmul = layers_matmul

        self.run(recorded, mode)
        return last[0].float()

    def after(self, prefix, engine=None, adapter=None):
        """``mode -> logits`` of the next token after ``prefix`` (its final
        chunk's row) on a fresh paged engine from ``engine`` (default
        :meth:`engine`), the request served as ``adapter``'s tenant."""
        made: list = [None]

        def run():
            made[0] = (engine or self.engine)()
            self.serve_prompts(made[0], [prefix], 1, adapters=[adapter])

        return lambda mode: self.logits_of(run, mode)[(len(prefix) - 1) % made[0].chunk]

    def check(self, what: str, logits, parting=None, b_bound: float = NEAR_TIE,
              rms: bool = True) -> None:
        """At one point of a served stream, ``logits(mode)`` reading its next
        token's logits on each path. With ``rms``, the kernel path's logits
        may be at most RMS_MARGIN times as far (RMS) from the f32 plain
        path's as the bf16 plain path's. Where the served stream parts from
        another path, ``parting`` = (a, b), the served token ``a`` must be
        within NEAR_TIE of the f32 top logit and the other path's ``b``
        within ``b_bound``; the bf16 plain path's own deviations there are
        printed beside them."""
        lf, lp = logits("f32"), logits("plain")
        std = float(lf.std())
        if rms:
            lk = logits("kernel")
            rms_k = float((lk - lf).pow(2).mean().sqrt())
            rms_p = float((lp - lf).pow(2).mean().sqrt())
            print(f"{what}: logits vs the f32 plain path: kernel path rms {rms_k:.4e} (max "
                  f"{float((lk - lf).abs().max()):.4e}), bf16 plain path rms {rms_p:.4e} (max "
                  f"{float((lp - lf).abs().max()):.4e}; logit std {std:.3f})", flush=True)
            if not rms_k <= RMS_MARGIN * rms_p:
                raise Failed(f"{what}: the kernel path is further from the f32 reference than "
                             f"bf16 rounding explains")
        if parting is None:
            return
        a, b = parting
        top = float(lf.max())
        da, db = top - float(lf[a]), top - float(lf[b])
        plain_top = int(lp.argmax())
        print(f"{what}: where they part the served token is {da:.4e} and the other "
              f"{db:.4e} below the f32 maximum (bounds {NEAR_TIE} and {b_bound}; logit std "
              f"{std:.3f}); bf16 plain path vs f32 there: max "
              f"{float((lp - lf).abs().max()):.4e}, at the two tokens "
              f"{float(lp[a] - lf[a]):+.4e} and {float(lp[b] - lf[b]):+.4e}; the bf16 plain "
              f"path's top token is "
              f"{'the served one' if plain_top == a else 'the other' if plain_top == b else plain_top}",
              flush=True)
        if not (da <= NEAR_TIE and db <= b_bound):
            raise Failed(f"{what} parts away from a near-tie")


def _first_parting(a, b, n: int) -> int:
    return next((t for t in range(n) if a[t] != b[t]), n)


def check_plain_agreement(paths, prompts, max_new, served, picks, b_bound=NEAR_TIE):
    """Phase 5: requests through the plain versions on the card.

    The served greedy tokens must equal the plain path's, or part where both
    tokens are within NEAR_TIE of the top logit of the plain path run in f32
    on the same prefix (the plain path's within ``b_bound``). That f32 run is
    the reference: the plain path in bf16 shows how far bf16 rounding alone
    moves the logits, and the kernel path must stay as close to the
    reference as that (within RMS_MARGIN)."""
    try:
        paths.use(plain=True)
        plain, _ = paths.serve_prompts(paths.engine(), [prompts[i] for i in picks], max_new)
    finally:
        paths.use(plain=False)
    for j, i in enumerate(picks):
        a, b = served[i], plain[j]
        same = _first_parting(a, b, max_new)
        # Logits where the streams part (else before the last token).
        at = min(same, max_new - 1)
        prefix = prompts[i] + a[:at]
        print(f"plain agreement: request {i}: first {same} of {max_new} greedy tokens "
              f"equal", flush=True)
        paths.check(f"plain agreement: request {i}, after {len(prefix)} tokens",
                    paths.after(prefix), (a[same], b[same]) if same < max_new else None,
                    b_bound)


#: the front-door knobs phases 6 and 8 clear so that make_engine's defaults run
FRONT_DOOR_KNOBS = ("DORA_BATCH_SLOTS", "DORA_PAGE_SIZE", "DORA_PREFILL_CHUNK",
                    "DORA_MULTISTEP_K", "DORA_PREFIX_CACHE", "DORA_PREFIX_CACHE_PAGES",
                    "DORA_SPEC_K", "DORA_SPEC_NGRAM", "DORA_PAGED_KV", "DORA_KV_INT8",
                    "DORA_LORA_DIR", "DORA_LORA_MAX_RESIDENT", "DORA_LORA_RANK")


@contextlib.contextmanager
def _env(**env):
    """The environment with ``env`` set (None: unset), restored after."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def front_door(make_engine, params, cfg, graphs=None, **env):
    """``llm_server.make_engine`` on the card with only ``env`` of the
    front-door knobs set, the caller's environment restored after; its
    windows (or dense step) CUDA graphs unless ``graphs`` is False."""
    with _env(**{**dict.fromkeys(FRONT_DOOR_KNOBS), **env}):
        return make_engine(params, cfg, device="cuda", graphs=graphs)


def serve_spec_cache(torch, DB, LO, vlm, make_engine, serve_prompts, params, cfg, seed: int,
                     max_new: int):
    """Phase 6: speculation and the prefix cache at full width and depth,
    each window one CUDA-graph replay; then its graph, graphs=False
    reference, paths and trace lines. Returns (prompts, {request index:
    tokens}, launches)."""
    import numpy as np

    engine = front_door(make_engine, params, cfg, DORA_SPEC_K=str(SPEC_K))
    if not engine.graphs:
        raise Failed("phase 6's engine runs its windows eagerly")
    got = (engine.spec_k, engine.window, engine.max_slots, engine.page_size, engine.chunk,
           engine.allocator.num_pages, engine.prefix_cache is not None)
    if got != (SPEC_K, 8, 16, 16, 256, 512, True):
        raise Failed(f"make_engine built (spec_k, K, slots, page, chunk, pages, cache) = {got}")

    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, size=512).tolist()
    tails = np.linspace(32, 480, 16).round().astype(int)
    prompts = [system + rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in tails]
    cold = sum(engine.pages_needed(len(p), max_new) for p in prompts)
    shared = engine.pages_needed(len(prompts[0]), max_new) + sum(
        engine.pages_needed(len(p), max_new, 512) - 32 for p in prompts[1:])
    cold_chunks = sum(-(-len(p) // engine.chunk) for p in prompts)
    print(f"spec phase: 16 requests of {len(prompts[0])}..{len(prompts[-1])} tokens need "
          f"{cold} pages cold, {shared} sharing the 512-token prefix, of "
          f"{engine.allocator.num_pages - 1} usable", flush=True)

    per_pass = [0, 0]  # tokens emitted, verification passes of live streams
    times = _timed(torch, engine)
    window_s = times["window"]
    inner = engine.window_step

    def watched_window(*a):
        live = torch.nonzero(a[4]).flatten().tolist()  # before the window moves it
        res = inner(*a)
        mat = res[0].cpu().numpy()
        for b in live:
            n_emit, frozen = vlm.spec_window_row_stats(mat[b], engine.window, engine.spec_k + 1)
            per_pass[0] += n_emit
            per_pass[1] += engine.window if frozen is None else frozen + 1
        return res

    def drive(engine):
        """Request 0 alone to its first token, then the other 15 beside it:
        {request index: tokens} and each request's TTFT from its submit."""
        t0 = time.perf_counter()
        engine.submit("first", prompts[0], max_new)
        first: list[int] = []
        while not first:
            for rid, token, _done in engine.step():
                first.append(token)
        ttft0 = time.perf_counter() - t0
        out, ttft = serve_prompts(engine, prompts[1:], max_new, others={"first": first})
        torch.cuda.synchronize()
        return {0: first, **{i + 1: toks for i, toks in out.items()}}, [ttft0, *ttft.values()]

    engine.window_step = watched_window
    plain_calls = _PlainCalls(DB, LO)
    _reset_launches(DB, LO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        served, ttfts = drive(engine)
    finally:
        wall = time.perf_counter() - t0
        launches = _launches(DB, LO)
        plain_calls.restore()
    times = {k: list(v) for k, v in times.items()}  # the served run's alone
    pc = engine.prefix_cache
    print(f"spec phase launches: {json.dumps(launches)}; plain calls {plain_calls.n}; "
          f"prefix cache {json.dumps(pc.stats())}", flush=True)
    _check_streams(served, max_new, cfg.vocab)
    if plain_calls.n:
        raise Failed(f"{plain_calls.n} plain-version call(s) ran on the spec path")
    if not launches["attention_paged_spec_step"] > 0:
        raise Failed("the spec kernel never launched with speculation on")
    if launches["attention_paged_batch_step"]:
        raise Failed("the batch decode kernel launched with speculation on")
    if (pc.hits, pc.misses, pc.hit_tokens) != (15, 1, 15 * 512):
        raise Failed(f"expected 15 hits of 512 tokens and 1 miss, got {pc.stats()}")
    if not engine.chunks_run < cold_chunks:
        raise Failed(f"{engine.chunks_run} prefill chunks ran, {cold_chunks} cold")
    engine.check_invariants()
    n_tok = sum(len(t) for t in served.values())
    ttft0, ttfts = ttfts[0], sorted(ttfts)  # each from its own submit
    print(f"spec phase: {n_tok} tokens in {wall:.3f} s; decode "
          f"{(n_tok - len(prompts)) / sum(window_s):.1f} tokens/s over {len(window_s)} windows "
          f"(K=8, spec_k={SPEC_K}, window mean {1e3 * sum(window_s) / len(window_s):.2f} ms, "
          f"max {1e3 * max(window_s):.2f} ms); {per_pass[0] / per_pass[1]:.3f} tokens per "
          f"stream per verification pass ({per_pass[0]} over {per_pass[1]}); TTFT p50 "
          f"{ttfts[len(ttfts) // 2]:.3f} s max {ttfts[-1]:.3f} s (request 0 {ttft0:.3f} s); "
          f"{engine.chunks_run} prefill chunks ({cold_chunks} cold); {pc.hits} hits, "
          f"{pc.hit_tokens} hit tokens; end-to-end {n_tok / wall:.1f} tokens/s", flush=True)
    graph_check(engine, serve_prompts, cfg.vocab, seed + 1, "spec phase")

    ref = front_door(make_engine, params, cfg, graphs=False, DORA_SPEC_K=str(SPEC_K))
    ref_times = _timed(torch, ref)
    ref_served, ref_ttfts = drive(ref)
    _same_streams("spec phase", served, ref_served, max_new)
    path_line("spec phase (phase 6, K = 8, spec_k = 4)", times, ref_times, ttfts, ref_ttfts)
    trace_window(torch, engine, cfg.vocab, seed + 2, "spec-on window (K = 8, spec_k = 4), "
                 "graphed")
    trace_window(torch, ref, cfg.vocab, seed + 2, "spec-on window (K = 8, spec_k = 4), eager")
    return prompts, served, launches


def check_spec_agreement(paths, prompts, max_new, served, picks):
    """Phase 7: requests of phase 6 on the spec-off, cache-off kernel path.
    Spec verification and shared-page prefill round in another order than
    decode and cold prefill, so a parting is allowed only at a near-tie."""
    ref, _ = paths.serve_prompts(paths.engine(), [prompts[i] for i in picks], max_new)
    for j, i in enumerate(picks):
        a, b = served[i], ref[j]
        same = _first_parting(a, b, max_new)
        print(f"spec agreement: request {i}: first {same} of {max_new} tokens equal to the "
              f"spec-off, cache-off engine", flush=True)
        if same < max_new:
            paths.check(f"spec agreement: request {i}", paths.after(prompts[i] + a[:same]),
                        (a[same], b[same]), SPEC_REF_TIE, rms=False)


def write_adapters(cfg, root: str, seed: int) -> None:
    """Seeded adapters t0..t3 as ``<name>.npz`` (per layer ``a_{i}`` [dim, r],
    ``b_{i}`` [r, dim]), the layout make_lora_pool reads."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for name, rank in ADAPTER_RANKS.items():
        np.savez(os.path.join(root, f"{name}.npz"), **{
            f"{w}_{i}": (rng.standard_normal(shape) * ADAPTER_STD).astype(np.float32)
            for i in range(cfg.layers)
            for w, shape in (("a", (cfg.dim, rank)), ("b", (rank, cfg.dim)))
        })


#: phase 8's groups: three requests for each tenant, four for the base model
TENANT_GROUPS = ["t0"] * 3 + ["t1"] * 3 + ["t2"] * 3 + ["t3"] * 3 + [None] * 4


def serve_multi_tenant(torch, DB, LO, make_engine, serve_prompts, params, cfg,
                       lora_dir: str, seed: int, max_new: int):
    """Phase 8: multi-tenant LoRA on int8 KV pages at full width and depth.
    Returns (engine factory, prompts, adapters, {request index: tokens},
    launches)."""
    import numpy as np

    def build(graphs=None, **env):
        return front_door(make_engine, params, cfg, graphs=graphs, DORA_KV_INT8="1",
                          DORA_LORA_DIR=lora_dir, **env)

    engine = build()
    if not engine.graphs:
        raise Failed("phase 8's engine runs its windows eagerly")
    got = (engine.kv_dtype, engine.spec_k, engine.window, engine.max_slots, engine.page_size,
           engine.chunk, engine.allocator.num_pages, engine.prefix_cache is not None,
           engine.lora.max_resident, tuple(engine.lora.state()["a"].shape))
    want = ("int8", 0, 8, 16, 16, 256, 992, True, 8, (9, cfg.layers, cfg.dim, 32))
    if got != want:
        raise Failed(f"make_engine built {got}, expected {want}")

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab, size=256).tolist()
    tails = np.linspace(32, 480, len(TENANT_GROUPS)).round().astype(int)
    prompts = [prefix + rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in tails]
    firsts = [TENANT_GROUPS.index(g) for g in dict.fromkeys(TENANT_GROUPS)]
    rest = [i for i in range(len(prompts)) if i not in firsts]
    cold = sum(engine.pages_needed(len(p), max_new) for p in prompts)
    print(f"tenant phase: {len(prompts)} requests of {len(prompts[0])}..{len(prompts[-1])} "
          f"tokens, one 256-token prefix, groups t0..t3 x 3 and base x 4; {cold} pages cold of "
          f"{engine.allocator.num_pages - 1} usable int8 pages (the fp pool holds 511)",
          flush=True)

    def drive(engine):
        """The first request of each group to its first token, then the
        other 11 beside them: {request index: tokens} and TTFTs."""
        t0 = time.perf_counter()
        served = {i: [] for i in firsts}
        ttft = {}
        for i in firsts:
            engine.submit(f"first{i}", prompts[i], max_new, adapter=TENANT_GROUPS[i])
        while not all(served.values()):
            for rid, token, _done in engine.step():
                i = int(rid[len("first"):])
                if not served[i]:
                    ttft[i] = time.perf_counter() - t0
                served[i].append(token)
        t1 = time.perf_counter()
        out, ttft_rest = serve_prompts(engine, [prompts[i] for i in rest], max_new,
                                       others={f"first{i}": served[i] for i in firsts},
                                       adapters=[TENANT_GROUPS[i] for i in rest])
        torch.cuda.synchronize()
        for j, i in enumerate(rest):
            served[i] = out[j]
            ttft[i] = t1 - t0 + ttft_rest[j]
        return served, ttft

    times = _timed(torch, engine)
    window_s = times["window"]
    plain_calls = _PlainCalls(DB, LO)
    _reset_launches(DB, LO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        served, ttft = drive(engine)
    finally:
        wall = time.perf_counter() - t0
        launches = _launches(DB, LO)
        plain_calls.restore()
    times = {k: list(v) for k, v in times.items()}  # the served run's alone
    pc, pool = engine.prefix_cache, engine.lora
    print(f"tenant phase launches: {json.dumps(launches)}; plain calls {plain_calls.n}; "
          f"prefix cache {json.dumps(pc.stats())}; adapters {json.dumps(pool.stats())}",
          flush=True)
    _check_streams(served, max_new, cfg.vocab)
    if plain_calls.n:
        raise Failed(f"{plain_calls.n} plain-version call(s) ran on the tenant path")
    need = ("lora_gather_matmul", "attention_paged_batch_step_int8kv",
            "attention_paged_chunk_step_int8kv")
    if not all(launches[n] > 0 for n in need):
        raise Failed(f"a kernel of the tenant path never launched: {launches}")
    banned = ("attention_paged_batch_step", "attention_paged_chunk_step",
              "attention_paged_spec_step", "attention_paged_spec_step_int8kv")
    if any(launches[n] for n in banned):
        raise Failed(f"an fp-KV or spec kernel launched on the int8, spec-off path: {launches}")
    if (pc.hits, pc.misses, pc.hit_tokens) != (11, 5, 11 * 256):
        raise Failed(f"expected 11 same-tenant hits of 256 tokens and 5 misses, got {pc.stats()}")
    engine.check_invariants()
    pool.check_invariants()
    n_tok = sum(len(t) for t in served.values())
    ttfts = sorted(ttft.values())
    print(f"tenant phase: {n_tok} tokens in {wall:.3f} s; decode "
          f"{(n_tok - len(prompts)) / sum(window_s):.1f} tokens/s over {len(window_s)} windows "
          f"(K=8, window mean {1e3 * sum(window_s) / len(window_s):.2f} ms, max "
          f"{1e3 * max(window_s):.2f} ms); TTFT p50 {ttfts[len(ttfts) // 2]:.3f} s max "
          f"{ttfts[-1]:.3f} s; {engine.chunks_run} prefill chunks; {pc.hits} hits, "
          f"{pc.hit_tokens} hit tokens; pages in use at peak {engine.allocator.peak_in_use} of "
          f"{engine.allocator.num_pages - 1} int8 (the fp pool holds 511); adapter loads "
          f"{pool.loads}, resident {pool.resident}, evictions {pool.evictions}; end-to-end "
          f"{n_tok / wall:.1f} tokens/s", flush=True)
    graph_check(engine, serve_prompts, cfg.vocab, seed + 1, "tenant phase")

    ref = build(graphs=False)
    ref_times = _timed(torch, ref)
    ref_served, ref_ttft = drive(ref)
    _same_streams("tenant phase", served, ref_served, max_new)
    path_line("tenant phase (phase 8, K = 8, int8 KV, LoRA)", times, ref_times, ttft.values(),
              ref_ttft.values())
    return build, prompts, served, launches


def check_tenant_agreement(paths, build, nocat, serve_prompts, prompts, max_new, served):
    """Phase 8, agreement: (a) the first request of t0 and of t3, each alone on
    a fresh engine of the phase's configuration, gives the tokens of the mixed
    batch; (b) the base group's first request gives the tokens of an int8
    engine with no catalog, where the two tenants' prompts run as base
    requests too, for the share of tokens the adapters change; (c) t0's and
    the base's first requests through the plain versions on the card part
    from the served streams, if at all, only at a near-tie. The engines of
    (a) and (b) are graphed; those that read logits or run the plain versions
    are not."""

    def eager():
        return build(graphs=False)

    first = {g: TENANT_GROUPS.index(g) for g in ("t0", "t3", None)}
    for g in ("t0", "t3"):
        i = first[g]
        alone, _ = serve_prompts(build(), [prompts[i]], max_new, adapters=[g])
        same = _first_parting(served[i], alone[0], max_new)
        print(f"tenant agreement (a): request {i} ({g}) alone: first {same} of {max_new} "
              f"tokens equal to the mixed batch"
              + (" (identical)" if same == max_new else ""), flush=True)
        if same < max_new:
            paths.check(f"tenant agreement (a): request {i}",
                        paths.after(prompts[i] + served[i][:same], eager, g),
                        (served[i][same], alone[0][same]), rms=False)
    i = first[None]
    base, _ = serve_prompts(nocat(), [prompts[i], prompts[first["t0"]], prompts[first["t3"]]],
                            max_new)
    same = _first_parting(served[i], base[0], max_new)
    print(f"tenant agreement (b): base request {i} on an int8 engine with no catalog: first "
          f"{same} of {max_new} tokens equal" + (" (identical)" if same == max_new else ""),
          flush=True)
    if same < max_new:
        paths.check(f"tenant agreement (b): request {i}",
                    paths.after(prompts[i] + served[i][:same], eager),
                    (served[i][same], base[0][same]), rms=False)
    differ = sum(a != b for j, g in ((1, "t0"), (2, "t3"))
                 for a, b in zip(served[first[g]], base[j]))
    print(f"tenant agreement: the adapters change {differ} of {2 * max_new} tokens "
          f"({differ / (2 * max_new):.1%}) of t0's and t3's first requests against the base "
          f"model on the same prompts", flush=True)
    if not differ:
        raise Failed("the adapters never changed a token")
    picks = (first["t0"], first[None])
    try:
        paths.use(plain=True)
        plain, _ = serve_prompts(eager(), [prompts[i] for i in picks], max_new,
                                 adapters=[TENANT_GROUPS[i] for i in picks])
    finally:
        paths.use(plain=False)
    for j, i in enumerate(picks):
        same = _first_parting(served[i], plain[j], max_new)
        print(f"tenant agreement (c): request {i} ({TENANT_GROUPS[i] or 'base'}) through the "
              f"int8 plain versions: first {same} of {max_new} tokens equal", flush=True)
        if same < max_new:
            paths.check(f"tenant agreement (c): request {i}",
                        paths.after(prompts[i] + served[i][:same], eager, TENANT_GROUPS[i]),
                        (served[i][same], plain[j][same]), SPEC_REF_TIE)


def serve_tenant_spec(torch, DB, LO, build, serve_prompts, prompts, max_new: int,
                      vocab: int):
    """Phase 8, spec on: four requests of t1, t2 and the base model on the
    same configuration with DORA_SPEC_K=4: the int8 spec form and the LoRA
    kernel at 80 rows run through the served path."""
    engine = build(DORA_SPEC_K=str(SPEC_K))
    picks = [TENANT_GROUPS.index("t1"), TENANT_GROUPS.index("t2"), TENANT_GROUPS.index(None),
             TENANT_GROUPS.index("t1") + 1]
    rows = set()
    kernel = LO._lora_gather_matmul_kernel  # the wrapper counts its launches

    def watched(x, *a, **k):
        rows.add(x.shape[0])
        return kernel(x, *a, **k)

    plain_calls = _PlainCalls(DB, LO)
    _reset_launches(DB, LO)
    LO._lora_gather_matmul_kernel = watched
    try:
        out, _ = serve_prompts(engine, [prompts[i] for i in picks], max_new,
                               adapters=[TENANT_GROUPS[i] for i in picks])
        torch.cuda.synchronize()
    finally:
        LO._lora_gather_matmul_kernel = kernel
        launches = _launches(DB, LO)
        plain_calls.restore()
    print(f"tenant spec run: launches {json.dumps(launches)}; LoRA rows per call "
          f"{sorted(rows)}; plain calls {plain_calls.n}", flush=True)
    _check_streams(out, max_new, vocab)
    if plain_calls.n:
        raise Failed(f"{plain_calls.n} plain-version call(s) ran on the tenant spec path")
    if not (launches["attention_paged_spec_step_int8kv"] > 0 and launches["lora_gather_matmul"] > 0
            and 16 * (SPEC_K + 1) in rows):
        raise Failed("the int8 spec form or the LoRA kernel at 80 rows never ran")
    if launches["attention_paged_batch_step_int8kv"] or launches["attention_paged_spec_step"]:
        raise Failed(f"a decode kernel other than the int8 spec form ran: {launches}")
    engine.check_invariants()
    engine.lora.check_invariants()
    return launches


def check_dense_kernels(torch, DB, IM, params, cfg, rng_seed: int) -> list[dict]:
    """Phase 3, kernels 7-10: ``int8_matmul`` and the dense-cache attention
    kernels against their plain versions at Qwen2-1.5B shapes. Every cache
    row from the written ones on starts as NaN: outputs must be finite, the
    written rows agree, every other cache value is bit-unchanged."""
    from dora_tpu_torch.models.layers import rope_table

    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    blk = params["blocks"]["0"]
    d, hd, h, kv = cfg.dim, cfg.head_dim, cfg.heads, cfg.kv_heads
    n_qkv = (h + 2 * kv) * hd
    seq = cfg.max_seq
    out = []

    def check(name, rel, what=""):
        tol = REL_TOL[name]
        print(f"kernel {name}{what}: rel {rel:.3e} (tol {tol})", flush=True)
        if not rel <= tol:
            raise Failed(f"{name}{what} disagrees with its plain version: rel {rel:.3e}")

    def report(name, source, replaces, err, ms, plain_ms, lib_ms, nbytes, ops, what=""):
        bound, by = _bound_ms(nbytes, ops)
        print(f"kernel {name}{what}: max_abs_err {err:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} bound_ms {bound:.4f} ({by})", flush=True)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

    # int8_matmul at every shape of INT8_SHAPES; the head on one row is the entry.
    for name, m in INT8_SHAPES:
        q, sc = _int8_operands(params, name)
        k, n = q.shape
        x = (torch.randn((m, k), generator=gen, device=dev) * 0.5).bfloat16()
        want = IM.int8_matmul_plain(x, q, sc)
        got = IM.int8_matmul(x, q, sc)
        err, rel = _rel(got, want)
        where = f" at {m} row(s) on {name} ({k} x {n})"
        check("int8_matmul", rel, where)
        w_bf = (q.float() * sc).bfloat16()
        entry = report("int8_matmul", "dora_tpu_torch/csrc/int8_matmul.cu",
                       "dora_tpu/ops/int8_matmul.py:148", err,
                       _time_ms(torch, lambda: IM.int8_matmul(x, q, sc)),
                       _time_ms(torch, lambda: IM.int8_matmul_plain(x, q, sc), 5),
                       _time_ms(torch, lambda: torch.matmul(x, w_bf)), *_int8_cost(m, k, n),
                       where)
        del w_bf
        if name == "lm_head":
            out.append(entry)

    cos_t, sin_t = rope_table(seq, hd, base=cfg.rope_theta, device=dev)
    wqkv, sqkv = blk["wqkv"]["int8"], blk["wqkv"]["scale"]
    wo, swo = blk["wo"]["int8"], blk["wo"]["scale"]
    bqkv = blk.get("bqkv")
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, eps=cfg.norm_eps)

    def caches(live):
        """bf16 caches [planes, KV, S, hd] of seeded normals, plane b's rows
        from live[b] on NaN; and a NaN-free copy for the SDPA yardstick."""
        k = torch.randn((len(live), kv, seq, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((len(live), kv, seq, hd), generator=gen, device=dev).bfloat16()
        for b, n in enumerate(live):
            k[b, :, n:] = float("nan")
            v[b, :, n:] = float("nan")
        return k, v

    def held(name, kernel, plain, pre, kc, vc, post, written, residual=True):
        """Kernel against plain on clones of the caches; returns (err, rel)."""
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        want = plain(*pre, k1, v1, *post, **kw, residual=residual)[0]
        got = kernel(*pre, k2, v2, *post, **kw, residual=residual)[0]
        what = "" if residual else " (residual=False)"
        if not bool(torch.isfinite(got.float()).all()):
            raise Failed(f"{name}{what}: the output is not finite (a NaN row was read)")
        err, rel = _rel(got, want)
        check(name, rel, what)
        rel_k, rel_v = _rel(k2[written], k1[written])[1], _rel(v2[written], v1[written])[1]
        check("pools", max(rel_k, rel_v), f" written by {name}{what}")
        for c2, c0 in ((k2, kc), (v2, vc)):
            if not torch.equal(c2.view(torch.int16)[~written], c0.view(torch.int16)[~written]):
                raise Failed(f"{name}{what} changed cache values it does not own")
        print(f"kernel {name}{what}: {int(written.sum()) // kv} row(s) per kv head written, "
              f"every other value (NaN from the written rows on) bit-unchanged", flush=True)
        return err, rel

    def sdpa(q, kc, vc, mask):
        kk = torch.nan_to_num(kc).repeat_interleave(h // kv, dim=1)
        vv = torch.nan_to_num(vc).repeat_interleave(h // kv, dim=1)
        return lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, vv, attn_mask=mask)

    def attn_bytes(rows, planes, ctx_rows, written_rows):
        return (rows * d * 2 * 2 + d * 4 + d * n_qkv + n_qkv * 8 + rows * hd * 8 + h * hd * d
                + d * 4 + planes * 4 + ctx_rows * kv * hd * 2 * 2 + written_rows * kv * hd * 2 * 2)

    def attn_ops(rows, keys):
        return 2 * rows * d * n_qkv + 2 * 2 * h * hd * keys + 2 * rows * h * hd * d

    def embedded(m):
        tok = torch.randint(0, cfg.vocab, (m,), generator=gen, device=dev)
        return params["embed"][tok].bfloat16()

    # attention_batch_step: the dense engine's 4 planes, rows at 0 .. 2047.
    positions = [0, 700, 1500, seq - 1]
    b = len(positions)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    kc, vc = caches(positions)
    x = embedded(b)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, pos)
    pre = (x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr)
    post = (wo, swo, pos)
    written = torch.zeros((b, kv, seq), dtype=torch.bool, device=dev)
    written[torch.arange(b, device=dev), :, pos.long()] = True
    err, _ = held("attention_batch_step", DB.attention_batch_step,
                  DB.attention_batch_step_plain, pre, kc, vc, post, written)
    held("attention_batch_step", DB.attention_batch_step, DB.attention_batch_step_plain,
         pre, kc, vc, post, written, residual=False)
    k2, v2 = kc.clone(), vc.clone()
    lib = sdpa(torch.randn((b, h, 1, hd), generator=gen, device=dev).bfloat16(), kc, vc,
               (torch.arange(seq, device=dev)[None, :] <= pos[:, None])[:, None, None, :])
    out.append(report(
        "attention_batch_step", "dora_tpu_torch/csrc/paged_attention.cu",
        "dora_tpu/ops/decode_block.py:824", err,
        _time_ms(torch, lambda: DB.attention_batch_step(*pre, k2, v2, *post, **kw)),
        _time_ms(torch, lambda: DB.attention_batch_step_plain(*pre, k2, v2, *post, **kw), 5),
        _time_ms(torch, lib), attn_bytes(b, b, sum(positions), b),
        attn_ops(b, sum(positions) + b)))

    # attention_step: one row at 1500 of a [KV, S, hd] plane.
    position = 1500
    kc, vc = caches([position])
    kc, vc = kc[0], vc[0]
    x = embedded(1)
    cr, sr = DB.rope_rows(cos_t, sin_t, position)
    pre = (x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr)
    post = (wo, swo, position)
    written = torch.zeros((kv, seq), dtype=torch.bool, device=dev)
    written[:, position] = True
    err, _ = held("attention_step", DB.attention_step, DB.attention_step_plain, pre, kc, vc,
                  post, written)
    held("attention_step", DB.attention_step, DB.attention_step_plain, pre, kc, vc, post,
         written, residual=False)
    k2, v2 = kc.clone(), vc.clone()
    lib = sdpa(torch.randn((1, h, 1, hd), generator=gen, device=dev).bfloat16(), kc[None],
               vc[None], (torch.arange(seq, device=dev) <= position)[None, None, None, :])
    out.append(report(
        "attention_step", "dora_tpu_torch/csrc/paged_attention.cu",
        "dora_tpu/ops/decode_block.py:309", err,
        _time_ms(torch, lambda: DB.attention_step(*pre, k2, v2, *post, **kw)),
        _time_ms(torch, lambda: DB.attention_step_plain(*pre, k2, v2, *post, **kw), 5),
        _time_ms(torch, lib), attn_bytes(1, 0, position, 1), attn_ops(1, position + 1)))

    # attention_chunk_step: a k = 4 verify's 5 rows ending on the last row.
    m = SPEC_K + 1
    position = seq - m
    kc, vc = caches([position])
    kc, vc = kc[0], vc[0]
    x = embedded(m)
    cr, sr = DB.rope_rows(cos_t, sin_t, position, m)
    pre = (x, blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr)
    post = (wo, swo, position)
    written = torch.zeros((kv, seq), dtype=torch.bool, device=dev)
    written[:, position:] = True
    err, _ = held("attention_chunk_step", DB.attention_chunk_step,
                  DB.attention_chunk_step_plain, pre, kc, vc, post, written)
    held("attention_chunk_step", DB.attention_chunk_step, DB.attention_chunk_step_plain, pre,
         kc, vc, post, written, residual=False)
    k2, v2 = kc.clone(), vc.clone()
    cmask = (torch.arange(seq, device=dev)[None, :]
             <= position + torch.arange(m, device=dev)[:, None])
    lib = sdpa(torch.randn((1, h, m, hd), generator=gen, device=dev).bfloat16(), kc[None],
               vc[None], cmask)
    out.append(report(
        "attention_chunk_step", "dora_tpu_torch/csrc/paged_attention.cu",
        "dora_tpu/ops/decode_block.py:574", err,
        _time_ms(torch, lambda: DB.attention_chunk_step(*pre, k2, v2, *post, **kw)),
        _time_ms(torch, lambda: DB.attention_chunk_step_plain(*pre, k2, v2, *post, **kw), 5),
        _time_ms(torch, lib), attn_bytes(m, 0, position, m),
        attn_ops(m, m * position + m * (m + 1) // 2)))

    # Times at the main path's own positions, for PERF.md's step times
    # (kernel time x launches): kernel 8 at the middle step (prompt + 63) of
    # each of phase 9's three waves of four slots, kernels 9 and 10 at the
    # middle pass (prompt + 64) of phase 10's streams; beside each, mlp_step
    # and lm_head_argmax at the pass's rows.
    ffn = (blk["ffn_norm"], blk["w_gateup"]["int8"], blk["w_gateup"]["scale"],
           blk.get("b_gateup"), blk["w_down"]["int8"], blk["w_down"]["scale"])
    head = (params["out_norm"], params["lm_head"]["int8"], params["lm_head"]["scale"])

    def pass_ms(what, attention, rows):
        x = embedded(rows)
        a_ms = _time_ms(torch, attention)
        m_ms = _time_ms(torch, lambda: DB.mlp_step(x, *ffn, eps=cfg.norm_eps))
        h_ms = _time_ms(torch, lambda: DB.lm_head_argmax(x, *head, eps=cfg.norm_eps))
        print(f"path times, {what}: attention {a_ms:.4f} ms, mlp_step {m_ms:.4f} ms, "
              f"lm_head_argmax {h_ms:.4f} ms at {rows} row(s); a pass's kernels, "
              f"{cfg.layers} x (attention + mlp_step) + head: "
              f"{cfg.layers * (a_ms + m_ms) + h_ms:.3f} ms", flush=True)

    for w in range(0, len(DENSE_LENGTHS), 4):
        live = [n + 63 for n in DENSE_LENGTHS[w:w + 4]]
        pos = torch.tensor(live, dtype=torch.int32, device=dev)
        kc, vc = caches(live)
        cr, sr = DB.rope_rows_at(cos_t, sin_t, pos)
        args = (embedded(len(live)), blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, kc, vc, wo,
                swo, pos)
        pass_ms(f"dense step at rows {live}", lambda: DB.attention_batch_step(*args, **kw),
                len(live))
    for i in BATCH1_PICKS:
        position = DENSE_LENGTHS[i] + 64
        for rows, attention in ((1, DB.attention_step), (SPEC_K + 1, DB.attention_chunk_step)):
            kc, vc = caches([position])
            cr, sr = DB.rope_rows(cos_t, sin_t, position, rows)
            args = (embedded(rows), blk["attn_norm"], wqkv, sqkv, bqkv, cr, sr, kc[0], vc[0],
                    wo, swo, position)
            pass_ms(f"batch-1 {attention.__name__} at row {position}",
                    lambda: attention(*args, **kw), rows)
    return out


#: the kernels of the dense engine's path (phase 9)
DENSE_KERNELS = ("int8_matmul", "attention_batch_step", "mlp_step", "lm_head_argmax")


def serve_dense(torch, DB, LO, IM, make_engine, serve_prompts, params, cfg, prompts,
                max_new, seed: int):
    """Phase 9: the dense batch engine as ``make_engine`` builds it with
    ``DORA_PAGED_KV=0``, serving every prompt through ``serve_prompts``, each
    step one CUDA-graph replay; then its graph, graphs=False reference, paths
    and trace lines. Returns (streams, launches, the served run's step
    times)."""
    from collections import Counter

    engine = front_door(make_engine, params, cfg, DORA_PAGED_KV="0")
    if not engine.graphs:
        raise Failed("phase 9's engine runs its steps eagerly")
    got = (type(engine).__name__, engine.max_slots, engine.max_seq)
    if got != ("BatchEngine", 4, cfg.max_seq):
        raise Failed(f"make_engine with DORA_PAGED_KV=0 built (kind, slots, max_seq) = {got}")
    print(f"dense phase: {len(prompts)} requests of {min(map(len, prompts))}.."
          f"{max(map(len, prompts))} tokens, {max_new} new tokens each, on "
          f"{engine.max_slots} dense slots", flush=True)

    times = _timed(torch, engine)
    step_s = times["window"]
    inner_submit = engine.submit
    joined = [0]  # submits while other streams were decoding
    products = Counter()  # (rows, N) of every int8_matmul launch
    kernel = IM._int8_matmul_kernel

    def counted_submit(rid, ids, n):
        joined[0] += engine.active > 0
        return inner_submit(rid, ids, n)

    def watched(x, q, s, **k):
        products[(x.numel() // x.shape[-1], q.shape[1])] += 1
        return kernel(x, q, s, **k)

    engine.submit = counted_submit
    plain_calls = _PlainCalls(DB, LO)
    _reset_launches(DB, LO)
    IM._int8_matmul_kernel = watched
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out, ttft = serve_prompts(engine, prompts, max_new)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        IM._int8_matmul_kernel = kernel
        launches = _launches(DB, LO)
        plain_calls.restore()
    engine.submit = inner_submit
    times = {k: list(v) for k, v in times.items()}  # the served run's alone
    print(f"dense phase launches: {json.dumps(launches)}; plain calls {plain_calls.n}; "
          f"int8_matmul (rows, N): {json.dumps({f'{r}x{n}': c for (r, n), c in sorted(products.items())})}",
          flush=True)
    _check_streams(out, max_new, cfg.vocab)
    if plain_calls.n:
        raise Failed(f"{plain_calls.n} plain-version call(s) ran on the dense path")
    if not all(launches[n] > 0 for n in DENSE_KERNELS):
        raise Failed(f"a kernel of the dense path never launched: {launches}")
    stray = [n for n, c in launches.items() if c and n not in DENSE_KERNELS]
    if stray:
        raise Failed(f"kernels off the dense path launched: {stray}")
    if not joined[0]:
        raise Failed("no request joined while others were decoding")
    # every prefill reads its first token off the head on one row; prompts
    # of <= 32 tokens run all their products in int8_matmul (buckets 8, 32)
    n_qkv = (cfg.heads + 2 * cfg.kv_heads) * cfg.head_dim
    short = Counter(8 if len(p) <= 8 else 16 if len(p) <= 16 else 32
                    for p in prompts if len(p) <= 32)
    want = {(1, cfg.vocab): len(prompts)}
    for rows, n in short.items():
        for width in (n_qkv, cfg.dim, 2 * cfg.ffn):
            want[(rows, width)] = want.get((rows, width), 0) + cfg.layers * n * (
                2 if width == cfg.dim else 1)
    if dict(products) != want:
        raise Failed(f"int8_matmul ran {dict(products)}, expected {want}")
    n_tok = sum(len(t) for t in out.values())
    ttfts = sorted(ttft.values())
    print(f"dense phase: {n_tok} tokens in {wall:.3f} s; decode "
          f"{(n_tok - len(prompts)) / sum(step_s):.1f} tokens/s over {len(step_s)} steps "
          f"(step mean {1e3 * sum(step_s) / len(step_s):.2f} ms, max {1e3 * max(step_s):.2f} "
          f"ms); TTFT p50 {ttfts[len(ttfts) // 2]:.3f} s max {ttfts[-1]:.3f} s; "
          f"{joined[0]} request(s) joined mid-flight; {engine.dispatches} dispatches, "
          f"{engine.fetches} fetches; end-to-end {n_tok / wall:.1f} tokens/s; TTFT of the "
          f"<= 32-token prompts (their prefill in int8_matmul): "
          f"{', '.join(f'{len(prompts[i])} tokens {ttft[i]:.4f} s' for i in sorted(ttft) if len(prompts[i]) <= 32)}",
          flush=True)
    graph_check(engine, serve_prompts, cfg.vocab, seed, "dense phase")

    ref = front_door(make_engine, params, cfg, graphs=False, DORA_PAGED_KV="0")
    ref_times = _timed(torch, ref)
    ref_out, ref_ttft = serve_prompts(ref, prompts, max_new)
    _same_streams("dense phase", out, ref_out, max_new)
    path_line("dense phase (phase 9, 4 slots; window = one step)", times, ref_times,
              ttft.values(), ref_ttft.values())
    trace_window(torch, engine, cfg.vocab, seed + 1, "dense step (4 slots), graphed")
    trace_window(torch, ref, cfg.vocab, seed + 1, "dense step (4 slots), eager")
    return out, launches, times


def batch1(torch, DB, LO, qwen2, spec_decode, L, paths, params, cfg, prompts, max_new,
           dense_out, form: str = ""):
    """Phase 10: batch-1 ``generate`` and ``run_loop`` (k = 4) on phase 9's
    prompts BATCH1_PICKS. Each stream is held to its own path's plain
    versions where it parts from the dense engine's stream (else before the
    last token): the prompt through the unfused prefill (the bf16 sidecars
    above 32 rows, so not the paged path's int8 model), then ``generate``'s
    tokens through one-row steps, or ``run_loop``'s verify passes replayed
    through k + 1-row chunks. Returns the launches of the last generate and
    run_loop. ``form`` "_int4": params in int4, whose kernels count their
    launches under ``<name>_int4`` (phase 12)."""
    dev = params["embed"].device
    rope = L.rope_table(cfg.max_seq, cfg.head_dim, base=cfg.rope_theta, device=dev)

    def others(need, *allowed):
        """Every attention kernel's counters but ``need`` and ``allowed`` (in
        this weight form): the paged ones, the dense engine's and the other
        weight form's."""
        ok = {need, *(n + form for n in allowed)}
        return tuple(n for n in DB.launch_counts() if n.startswith("attention") and n not in ok)

    def run(what, fn, need, banned):
        plain_calls = _PlainCalls(DB, LO)
        _reset_launches(DB, LO)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t0
            launches = _launches(DB, LO)
            plain_calls.restore()
        print(f"batch-1 {what}: launches {json.dumps({n: c for n, c in launches.items() if c})}; "
              f"plain calls {plain_calls.n}", flush=True)
        if plain_calls.n:
            raise Failed(f"{plain_calls.n} plain-version call(s) ran in {what}")
        if not launches[need] > 0 or any(launches[n] for n in banned):
            raise Failed(f"{what}: {need} must run and {banned} must not: {launches}")
        return res, wall, launches

    for i in BATCH1_PICKS:
        ids = prompts[i]
        t = len(ids)

        def prefill():
            return qwen2.prefill_padded(
                params, cfg, torch.tensor([ids], dtype=torch.int32, device=dev), t)

        gen, wall, gen_launches = run(
            f"generate, request {i} ({t} tokens)",
            lambda: qwen2.generate(params, cfg, torch.tensor([ids], device=dev), max_new),
            "attention_step" + form, others("attention_step" + form))
        gen = gen[0].tolist()
        _check_streams({i: gen}, max_new, cfg.vocab)
        pre_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            pre_ms.append(1e3 * (time.perf_counter() - t0))
        print(f"batch-1 generate, request {i}: {max_new} tokens in {wall:.3f} s with the "
              f"prompt ({(max_new - 1) / wall:.1f} decode steps/s); its prefill (TTFT) "
              f"{sorted(pre_ms)[2]:.3f} ms, the median of 5", flush=True)

        spec_decode.check_headroom(t, max_new, cfg.max_seq, "prompt", SPEC_K)
        body = spec_decode.fitting_body_passes(t, max_new, cfg.max_seq, SPEC_K)
        verified = []  # (chunk, n_emitted) of every verify pass, for the replay

        def speculate():
            first, caches, _ = prefill()
            history = torch.zeros(cfg.max_seq, dtype=torch.int32, device=dev)
            history[:t] = torch.tensor(ids, dtype=torch.int32, device=dev)
            history[t] = first[0]

            def verify(chunk, n_emitted, caches):
                verified.append((chunk.clone(), n_emitted))
                return qwen2.fused_step(params, cfg, chunk, caches, t + n_emitted - 1, rope)

            return spec_decode.run_loop(
                caches=caches, history=history, hist_len=t + 1, first=first[0],
                max_new_tokens=max_new, seq=cfg.max_seq, verify=verify, k=SPEC_K,
                return_stats=True, body=body)

        (spec, passes, full), wall, spec_launches = run(
            f"run_loop, request {i}", speculate, "attention_chunk_step" + form,
            others("attention_chunk_step" + form, "attention_step"))
        spec = spec[0].tolist()
        _check_streams({i: spec}, max_new, cfg.vocab)
        print(f"batch-1 run_loop, request {i}: {max_new} tokens in {wall:.3f} s; {passes} "
              f"model passes ({1e3 * wall / passes:.2f} ms a pass; {full} full k+1 passes, "
              f"body {body}); "
              f"{(max_new - 1) / max(passes - 1, 1):.3f} tokens per verify pass; "
              f"{spec_launches['attention_chunk_step' + form] // cfg.layers} chunk passes launched "
              f"(overshoot included)", flush=True)

        def stepped(at):
            """generate's path to the logits of token ``at``: its tokens
            before it through one-row steps (kernel 9)."""
            def go():
                _, caches, _ = prefill()
                for j, tok in enumerate(gen[:at]):
                    chunk = torch.tensor([[tok]], dtype=torch.int32, device=dev)
                    _, caches = qwen2.fused_step(params, cfg, chunk, caches, t + j, rope)
            return lambda mode: paths.logits_of(go, mode)[-1]

        def replayed(at):
            """run_loop's path to the logits of token ``at``: its verify
            passes up to the one that emitted it (kernel 10), that pass's
            row for it."""
            upto = [(c, e) for c, e in verified if e <= at]

            def go():
                _, caches, _ = prefill()
                for c, e in upto:
                    _, caches = qwen2.fused_step(params, cfg, c, caches, t + e - 1, rope)
            row = at - upto[-1][1] if upto else -1
            return lambda mode: paths.logits_of(go, mode)[row]

        # The served (dense) token is held to NEAR_TIE; generate's too (kernel
        # 9 runs kernel 8's sweep and folds its row from f32 as it does), run_loop's to
        # SPEC_REF_TIE: kernel 10 folds its chunk from bf16 rows, as its
        # reference does, so its path ranks near-ties in its own order.
        for label, b, path, b_bound in (("generate", gen, stepped, NEAR_TIE),
                                        ("run_loop", spec, replayed, SPEC_REF_TIE)):
            a = dense_out[i]
            same = _first_parting(a, b, max_new)
            at = min(same, max_new - 1)
            print(f"batch-1 agreement, request {i}, dense engine vs {label}: first {same} of "
                  f"{max_new} tokens equal", flush=True)
            paths.check(f"batch-1 agreement, request {i}, {label}, token {at}", path(at),
                        (a[same], b[same]) if same < max_new else None, b_bound)
    return gen_launches, spec_launches


def check_mma_tile(torch, DB, rng_seed: int) -> None:
    """Phase 3: the tensor-core helper of kernels 4 and 10 on one 16 x 16 by
    16 x 8 bf16 tile, fragments built by the sweeps' layout, against
    torch.matmul in f32 (exact bf16 products, f32 sums: 1e-5 of the largest
    magnitude)."""
    gen = torch.Generator(device="cuda").manual_seed(rng_seed)
    a = (torch.randn((16, 16), generator=gen, device="cuda") * 4).bfloat16()
    b = torch.randn((16, 8), generator=gen, device="cuda").bfloat16()
    got = DB.mma_tile(a, b)
    torch.cuda.synchronize()
    err, rel = _rel(got, a.float() @ b.float())
    print(f"mma tile (m16n8k16 bf16, the sweeps' fragment layout): rel {rel:.3e} (tol 1e-5)",
          flush=True)
    if not rel <= 1e-5:
        raise Failed(f"the mma fragment layout disagrees with torch.matmul: rel {rel:.3e}")


def check_tc_tile(torch, DB, rng_seed: int) -> None:
    """Phase 3: the fragment path of kernels 1 and 2's tensor-core product
    (int8 widened to bf16, ldmatrix plain and transposed, two m16n8k16 mma)
    on one 16 x 16 bf16 tile by a 16 x 16 int8 tile over the full int8
    range, against torch.matmul in f32 (exact products, f32 sums: 1e-5)."""
    gen = torch.Generator(device="cuda").manual_seed(rng_seed)
    a = (torch.randn((16, 16), generator=gen, device="cuda") * 4).bfloat16()
    w = torch.randint(-128, 128, (16, 16), generator=gen, device="cuda").to(torch.int8)
    got = DB.tc_tile(a, w)
    torch.cuda.synchronize()
    err, rel = _rel(got, a.float() @ w.float())
    print(f"tc tile (int8 widened, ldmatrix, m16n8k16 bf16): rel {rel:.3e} (tol 1e-5)",
          flush=True)
    if not rel <= 1e-5:
        raise Failed(f"the int8 product's fragment path disagrees with torch.matmul: "
                     f"rel {rel:.3e}")


def _device_kernels(torch, fn, iters: int):
    """Every kernel ``iters`` calls of ``fn`` launch, from ``torch.profiler``'s
    records, in launch order: [(kernel name, us)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    return [(e.name.split("(")[0].replace("void ", ""), e.time_range.elapsed_us())
            for e in kern]


def _device_launches(torch, fn, iters: int = 10):
    """The device time of each kernel one call of ``fn`` launches, in launch
    order, averaged over ``iters`` calls: [(kernel name, ms)], or None when
    the profiler saw no kernel or the calls launched different numbers of
    them."""
    kern = _device_kernels(torch, fn, iters)
    if not kern or len(kern) % iters:
        return None
    per = len(kern) // iters
    return [(kern[j][0], sum(kern[i * per + j][1] for i in range(iters)) / iters / 1e3)
            for j in range(per)]


def _launch_parts(torch, fn) -> str:
    """Each kernel ``fn`` launches with its device ms, and their sum."""
    launches = _device_launches(torch, fn)
    if launches is None:
        return "not measured (the profiler saw no kernel)"
    return (", ".join(f"{n} {ms:.4f}" for n, ms in launches)
            + f"; device sum {sum(ms for _, ms in launches):.4f}")


def _host_ms(torch, fn, iters: int = 20) -> float:
    """Host time of one call of ``fn``: the wrapper's checks, allocations
    and launches, without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    return host


def sublayer_breakdown(torch, DB, params, cfg, rng_seed: int) -> None:
    """Phase 3, the attention sublayers launch by launch: for kernels 3-5 and
    8-10 at the shapes the paths give them (kernel 4 at 256 rows from 0 and
    512, fp and int8 KV; kernel 10's 5 rows at 84, 1064 and 2043), the device
    time of each launch (RMSNorm, qkv product, rope-and-write, the sweep and
    its combine, wo product, epilogue), their sum, the wrapper's time on CUDA
    events, its host time, SDPA alone and the library chain (RMSNorm, cuBLAS
    qkv on the dequantized bf16 weights, SDPA, cuBLAS wo)."""
    from dora_tpu_torch.models.layers import rope_table

    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    blk = params["blocks"]["0"]
    d, hd, h, kv = cfg.dim, cfg.head_dim, cfg.heads, cfg.kv_heads
    seq, page, slots, chunk, m = cfg.max_seq, 16, 16, 256, SPEC_K + 1
    cos_t, sin_t = rope_table(seq, hd, base=cfg.rope_theta, device=dev)
    nw, wqkv, sqkv, bqkv = (blk["attn_norm"], blk["wqkv"]["int8"], blk["wqkv"]["scale"],
                            blk.get("bqkv"))
    wo, swo = blk["wo"]["int8"], blk["wo"]["scale"]
    wqkv_bf = (wqkv.float() * sqkv).bfloat16()
    wo_bf = (wo.float() * swo).bfloat16()
    bq_bf = bqkv.bfloat16() if bqkv is not None else None
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, eps=cfg.norm_eps)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_qkv = (h + 2 * kv) * hd
    kv_row = kv * hd * 2 * 2    # one row of K and V in bf16
    kv8_row = kv * (hd + 4) * 2  # in int8, with their scales

    def rows(n):
        tok = torch.randint(0, cfg.vocab, (n,), generator=gen, device=dev)
        return params["embed"][tok].bfloat16()

    def cost(n, ctx_rows, attended, index_bytes, row_bytes=kv_row):
        """The bound of a sublayer over n rows, as phase 3 counts it: x in and
        out, the int8 weights with their f32 vectors, the rope rows, the
        index operands, ctx_rows context rows of K and V read once and the n
        rows' own written; the two products and attended (query row, key)
        pairs of q.k and p.v."""
        nbytes = (n * d * 2 * 2 + d * 4 + d * n_qkv + n_qkv * 8 + n * hd * 8 + h * hd * d
                  + d * 4 + index_bytes + ctx_rows * row_bytes + n * row_bytes)
        ops = 2 * n * d * n_qkv + 2 * 2 * h * hd * attended + 2 * n * h * hd * d
        return _bound_ms(nbytes, ops)

    def rms(x):
        if hasattr(torch.nn.functional, "rms_norm"):
            return torch.nn.functional.rms_norm(x, (d,), nw.bfloat16(), cfg.norm_eps)
        xf = x.float()
        return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + cfg.norm_eps) * nw).bfloat16()

    def line(what, call, x, q, kk, vv, mask, bound):
        """q [B, H, L, hd] and the context kk, vv [B, H, n, hd] for SDPA;
        x the sublayer's B * L rows for the chain's products; bound (ms,
        by) from cost()."""
        kk = torch.nan_to_num(kk).repeat_interleave(h // kv, dim=1)
        vv = torch.nan_to_num(vv).repeat_interleave(h // kv, dim=1)

        def chain():
            qkv = torch.matmul(rms(x), wqkv_bf)
            if bq_bf is not None:
                qkv = qkv + bq_bf
            o = sdpa(q, kk, vv, attn_mask=mask)
            return torch.matmul(o.transpose(1, 2).reshape(x.shape[0], h * hd), wo_bf)

        parts = _launch_parts(torch, call)
        sdpa_ms = _time_ms(torch, lambda: sdpa(q, kk, vv, attn_mask=mask))
        print(f"sublayer {what}: {parts}; wrapper {_time_ms(torch, call):.4f} ms, host "
              f"{_host_ms(torch, call):.4f} ms; SDPA {sdpa_ms:.4f} ms, library chain "
              f"{_time_ms(torch, chain):.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})",
              flush=True)
        return parts

    # kernel 3: 16 decode rows at 30..940, one frozen (as check_kernels)
    n_pool = 4 * seq // page
    shape = (n_pool, kv, page, hd)
    kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vp = torch.randn(shape, generator=gen, device=dev).bfloat16()
    kq8, ks8 = DB.kv_quant_rows(kp.float())
    vq8, vs8 = DB.kv_quant_rows(vp.float())
    maxp = seq // page
    positions = [int(p) for p in torch.linspace(30, 940, slots).round().tolist()]
    positions[3] = 0
    bt = torch.zeros((slots, maxp), dtype=torch.int32)
    nxt = 1
    for b, p in enumerate(positions):
        if p:
            n = -(-(p + m) // page)
            bt[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
            nxt += n
    bt = bt.to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    kctx = kp[bt.long()].permute(0, 2, 1, 3, 4).reshape(slots, kv, maxp * page, hd)
    vctx = vp[bt.long()].permute(0, 2, 1, 3, 4).reshape(slots, kv, maxp * page, hd)
    keys = torch.arange(maxp * page, device=dev)
    x = rows(slots)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, pos)
    ctx = sum(positions)
    q1 = torch.randn((slots, h, 1, hd), generator=gen, device=dev).bfloat16()
    fp = (x, nw, wqkv, sqkv, bqkv, cr, sr, kp.clone(), vp.clone(), wo, swo, pos, bt)
    q8 = (x, nw, wqkv, sqkv, bqkv, cr, sr, kq8.clone(), vq8.clone(), wo, swo, pos, bt,
          ks8.clone(), vs8.clone())
    for form, bargs, row_bytes in (("fp KV", fp, kv_row), ("int8 KV", q8, kv8_row)):
        parts = line(f"attention_paged_batch_step, {form}, 16 rows at 30..940",
                     lambda: DB.attention_paged_batch_step(*bargs, **kw), x, q1, kctx, vctx,
                     (keys[None, :] <= pos[:, None])[:, None, None, :],
                     cost(slots, ctx, ctx + slots, slots * 4 + bt.numel() * 4, row_bytes))
        if "not measured" not in parts and not ("tc_sweep" in parts and "sweep_combine" in parts):
            raise Failed(f"attention_paged_batch_step ({form}) did not sweep on tc_sweep and "
                         f"sweep_combine: {parts}")

    # kernel 4: 256 rows from 0 and from 512, fp and int8 KV
    btr = torch.arange(1, maxp + 1, dtype=torch.int32, device=dev)
    for position in (0, 2 * chunk):
        x = rows(chunk)
        cr, sr = DB.rope_rows(cos_t, sin_t, position, chunk)
        n_keys = position + chunk
        kc = kp[btr[: n_keys // page].long()].permute(1, 0, 2, 3).reshape(1, kv, n_keys, hd)
        vc = vp[btr[: n_keys // page].long()].permute(1, 0, 2, 3).reshape(1, kv, n_keys, hd)
        cmask = (torch.arange(n_keys, device=dev)[None, :]
                 <= position + torch.arange(chunk, device=dev)[:, None])
        qc = torch.randn((1, h, chunk, hd), generator=gen, device=dev).bfloat16()
        fp = (x, nw, wqkv, sqkv, bqkv, cr, sr, kp.clone(), vp.clone(), wo, swo, position, btr)
        q8 = (x, nw, wqkv, sqkv, bqkv, cr, sr, kq8.clone(), vq8.clone(), wo, swo, position,
              btr, ks8.clone(), vs8.clone())
        causal = chunk * position + chunk * (chunk + 1) // 2
        for form, cargs, row_bytes in (("fp KV", fp, kv_row), ("int8 KV", q8, kv8_row)):
            line(f"attention_paged_chunk_step, {form}, 256 rows at {position}",
                 lambda: DB.attention_paged_chunk_step(*cargs, **kw), x, qc, kc, vc, cmask,
                 cost(chunk, position, causal, btr.numel() * 4, row_bytes))

    # kernel 5: 16 streams x 5 rows at 30..940
    flat = (pos[:, None] + torch.arange(m, dtype=torch.int32, device=dev)[None, :])
    cr, sr = DB.rope_rows_at(cos_t, sin_t, flat.reshape(-1))
    x = rows(slots * m)
    sargs = (x, nw, wqkv, sqkv, bqkv, cr, sr, kp.clone(), vp.clone(), wo, swo, pos, bt)
    line("attention_paged_spec_step, 16 x 5 rows at 30..940",
         lambda: DB.attention_paged_spec_step(*sargs, m=m, **kw), x,
         torch.randn((slots, h, m, hd), generator=gen, device=dev).bfloat16(), kctx, vctx,
         (keys[None, None, :] <= flat[:, :, None])[:, None],
         cost(slots * m, ctx, m * ctx + slots * m * (m + 1) // 2, slots * 4 + bt.numel() * 4))
    del kp, vp, kq8, vq8, kctx, vctx

    def nan_planes(live):
        k = torch.randn((len(live), kv, seq, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((len(live), kv, seq, hd), generator=gen, device=dev).bfloat16()
        for b, n in enumerate(live):
            k[b, :, n:] = float("nan")
            v[b, :, n:] = float("nan")
        return k, v

    # kernel 8: 4 planes at 0, 700, 1500, 2047
    live = [0, 700, 1500, seq - 1]
    dpos = torch.tensor(live, dtype=torch.int32, device=dev)
    kc, vc = nan_planes(live)
    x = rows(len(live))
    cr, sr = DB.rope_rows_at(cos_t, sin_t, dpos)
    dargs = (x, nw, wqkv, sqkv, bqkv, cr, sr, kc.clone(), vc.clone(), wo, swo, dpos)
    skeys = torch.arange(seq, device=dev)
    line("attention_batch_step, 4 planes at 0..2047",
         lambda: DB.attention_batch_step(*dargs, **kw), x,
         torch.randn((len(live), h, 1, hd), generator=gen, device=dev).bfloat16(), kc, vc,
         (skeys[None, :] <= dpos[:, None])[:, None, None, :],
         cost(len(live), sum(live), sum(live) + len(live), len(live) * 4))

    # kernel 9 at 1500; kernel 10's 5 rows at 84, 1064 and 2043
    for n_rows, position in ((1, 1500), (m, 84), (m, 1064), (m, seq - m)):
        kc, vc = nan_planes([position])
        x = rows(n_rows)
        cr, sr = DB.rope_rows(cos_t, sin_t, position, n_rows)
        pargs = (x, nw, wqkv, sqkv, bqkv, cr, sr, kc[0].clone(), vc[0].clone(), wo, swo,
                 position)
        fn = DB.attention_step if n_rows == 1 else DB.attention_chunk_step
        line(f"{fn.__name__}, {n_rows} row(s) at {position}", lambda: fn(*pargs, **kw), x,
             torch.randn((1, h, n_rows, hd), generator=gen, device=dev).bfloat16(), kc, vc,
             skeys[None, :] <= position + torch.arange(n_rows, device=dev)[:, None],
             cost(n_rows, position, n_rows * position + n_rows * (n_rows + 1) // 2, 0))


BREAKDOWN_ROWS = (1, 16, 80, 256)  # batch 1, a decode tick, a verify, a prefill chunk


def ffn_head_breakdown(torch, DB, params, cfg, rng_seed: int) -> None:
    """Kernels 1 and 2 launch by launch at 1, 16, 80 and 256 rows of layer
    0 and the head: the device time of each launch from ``torch.profiler``
    (RMSNorm, the products, their epilogues), their sum, the wrapper on
    CUDA events and its host time, beside the bound and two yardsticks the
    port never calls: the library products alone (cuBLAS on the dequantized
    bf16 weights; for the head with its argmax, as phase 3 times them) and
    the library chain (RMSNorm, the products, SwiGLU and the residual; the
    head's RMSNorm, product and argmax)."""
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    blk = params["blocks"]["0"]
    d, f, vocab, eps = cfg.dim, cfg.ffn, cfg.vocab, cfg.norm_eps
    ffn = (blk["ffn_norm"], blk["w_gateup"]["int8"], blk["w_gateup"]["scale"],
           blk.get("b_gateup"), blk["w_down"]["int8"], blk["w_down"]["scale"])
    wgu_bf = (ffn[1].float() * ffn[2]).bfloat16()
    bgu_bf = ffn[3].bfloat16() if ffn[3] is not None else None
    wd_bf = (ffn[4].float() * ffn[5]).bfloat16()
    head = (params["out_norm"], params["lm_head"]["int8"], params["lm_head"]["scale"])
    wh_bf = (head[1].float() * head[2]).bfloat16()

    def rms(x, w):
        xf = x.float()
        return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * w).bfloat16()

    def ffn_chain(x):
        gu = torch.matmul(rms(x, ffn[0]), wgu_bf)
        if bgu_bf is not None:
            gu = gu + bgu_bf
        return x + torch.matmul(torch.nn.functional.silu(gu[:, :f]) * gu[:, f:], wd_bf)

    def line(what, call, products, chain, nbytes, ops):
        parts = _launch_parts(torch, call)
        bound, by = _bound_ms(nbytes, ops)
        print(f"breakdown {what}: {parts}; wrapper {_time_ms(torch, call):.4f} ms, host "
              f"{_host_ms(torch, call):.4f} ms; library products {_time_ms(torch, products):.4f}"
              f" ms, library chain {_time_ms(torch, chain):.4f} ms; bound {bound:.4f} ms ({by})",
              flush=True)

    for m in BREAKDOWN_ROWS:
        tok = torch.randint(0, vocab, (m,), generator=gen, device=dev)
        x = params["embed"][tok].bfloat16()
        hx = rms(x, ffn[0])
        line(f"mlp_step, {m} row(s)", lambda: DB.mlp_step(x, *ffn, eps=eps),
             lambda: torch.matmul(torch.matmul(hx, wgu_bf)[:, :f], wd_bf),
             lambda: ffn_chain(x),
             m * d * 2 * 2 + d * 4 + d * 2 * f + 2 * f * 4 + f * d + d * 4,
             2 * m * d * 2 * f + 2 * m * f * d)
        hn = rms(x, head[0])
        line(f"lm_head_argmax, {m} row(s)", lambda: DB.lm_head_argmax(x, *head, eps=eps),
             lambda: torch.matmul(hn, wh_bf).argmax(dim=-1),
             lambda: torch.matmul(rms(x, head[0]), wh_bf).argmax(dim=-1),
             m * d * 2 + d * 4 + d * vocab + vocab * 4 + m * 4, 2 * m * d * vocab)


def ffn_fidelity(torch, DB, params, cfg, prompts) -> None:
    """Kernel 1 against an f32 reference (its plain version on f32 rows),
    beside the bf16 plain version, as rel-rms of the delta (residual=False)
    on the embedded rows of three of phase 4's prompts, 16 (decode) and 256
    (prefill) at a time, in every ninth layer's weights; kernel 2's winning
    logits against an f64 product, beside the plain version's f32 ones."""
    dev = params["embed"].device
    for m in (16, 256):
        errs = []
        for req in (0, 1, 5):
            toks = (prompts[req] * (m // len(prompts[req]) + 1))[:m]
            x = params["embed"][torch.tensor(toks, device=dev)].bfloat16()
            for layer in range(0, cfg.layers, 9):
                blk = params["blocks"][str(layer)]
                w = (blk["ffn_norm"], blk["w_gateup"]["int8"], blk["w_gateup"]["scale"],
                     blk.get("b_gateup"), blk["w_down"]["int8"], blk["w_down"]["scale"])
                kw = dict(eps=cfg.norm_eps, residual=False)
                got = DB.mlp_step(x, *w, **kw)
                want = DB.mlp_step_plain(x, *w, **kw)
                ref = DB.mlp_step_plain(x.float(), *w, **kw)

                def rel(a, b):
                    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())

                errs.append((rel(got, ref), rel(want, ref), rel(got, want)))
        e = torch.tensor(errs, dtype=torch.float64)
        print(f"fidelity mlp_step, {m} rows of 3 prompts: rel-rms vs f32, kernel "
              f"{e[:, 0].mean():.4e} (max {e[:, 0].max():.4e}), bf16 plain {e[:, 1].mean():.4e} "
              f"(max {e[:, 1].max():.4e}); kernel vs plain {e[:, 2].mean():.4e}", flush=True)
    # Kernel 2's f32 sums: each row's winning logit against the f64 product of
    # the same bf16 rows and int8 head, beside the plain version's f32 one.
    head = (params["out_norm"], params["lm_head"]["int8"], params["lm_head"]["scale"])
    for m in (16, 256):
        toks = (prompts[0] * (m // len(prompts[0]) + 1))[:m]
        x = params["embed"][torch.tensor(toks, device=dev)].bfloat16()
        h = DB._rms(x, head[0], cfg.norm_eps).to(torch.bfloat16)
        ref = (h.double() @ head[1].double()) * head[2].double()
        gi, gv = DB.lm_head_argmax(x, *head, eps=cfg.norm_eps, return_val=True)
        pv, pi = DB._wdot(h, head[1], head[2]).max(dim=-1)
        ek = ((gv.double() - ref.gather(1, gi.long()[:, None])[:, 0]).abs()
              / ref.gather(1, gi.long()[:, None])[:, 0].abs())
        ep = ((pv.double() - ref.gather(1, pi[:, None])[:, 0]).abs()
              / ref.gather(1, pi[:, None])[:, 0].abs())
        print(f"fidelity lm_head_argmax, {m} rows: the winning logit's rel error vs f64, kernel "
              f"mean {ek.mean():.3e} (max {ek.max():.3e}), plain f32 mean {ep.mean():.3e} (max "
              f"{ep.max():.3e}); {int((gi.long() == pi).sum())} of {m} tokens equal", flush=True)


def sweep_fidelity(torch, DB, params, cfg, prompts, rng_seed: int) -> None:
    """Phase 3: the tensor-core sweeps' kernels 3-5 and 8-10 against an f32
    reference (their plain versions run on f32 rows), beside the bf16 plain
    versions, as rel-rms of the attention delta (residual=False): kernel 4
    on the embedded rows of three of phase 4's prompts (256-row chunks from
    0 and from 512 over a seeded pool), kernel 10 on 5 rows at 84, 1064 and
    2043 over seeded planes, kernel 5 on 16 streams x 5 rows at 30..940 (one
    frozen) over a seeded pool, kernel 3 on 16 decode rows at the same
    positions, fp and int8 KV, kernel 8 on 4 planes at 0, 700, 1500 and 2047
    and kernel 9 on one row at 1500, NaN from each position on, in every
    ninth layer's weights. A kernel as close to f32 as its plain version but
    far from the plain version rounds elsewhere; each case fails the phase
    when its kernel sits more than RMS_MARGIN times as far from f32 as its
    plain version."""
    from dora_tpu_torch.models.layers import rope_table

    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    h, kv, hd, seq, page = cfg.heads, cfg.kv_heads, cfg.head_dim, cfg.max_seq, 16
    cos_t, sin_t = rope_table(seq, hd, base=cfg.rope_theta, device=dev)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, eps=cfg.norm_eps, residual=False)
    layers = range(0, cfg.layers, 9)

    def rel(a, b, n):
        return float((a - b)[:n].pow(2).mean().sqrt() / b[:n].pow(2).mean().sqrt())

    def report(what, errs, hold=False):
        e = torch.tensor(errs, dtype=torch.float64)
        print(f"fidelity {what}: rel-rms vs f32, kernel {e[:, 0].mean():.4e} (max "
              f"{e[:, 0].max():.4e}), bf16 plain {e[:, 1].mean():.4e} (max {e[:, 1].max():.4e}); "
              f"kernel vs plain {e[:, 2].mean():.4e}", flush=True)
        if hold and not e[:, 0].mean() <= RMS_MARGIN * e[:, 1].mean():
            raise Failed(f"{what}: the kernel sits {e[:, 0].mean():.4e} from f32, more than "
                         f"{RMS_MARGIN} x the bf16 plain version's {e[:, 1].mean():.4e}")

    def three(kernel, plain, args, n, **extra):
        got = kernel(*args(False), **kw, **extra)[0]
        want = plain(*args(False), **kw, **extra)[0]
        ref = plain(*args(True), **kw, **extra)[0]
        return rel(got, ref, n), rel(want, ref, n), rel(got, want, n)

    btr = torch.arange(1, seq // page + 1, dtype=torch.int32, device=dev)
    for position in (0, 512):
        errs = []
        for req in (0, 1, 5):
            toks = prompts[req][:256]
            n = len(toks)
            x = params["embed"][torch.tensor(toks + [0] * (256 - n), device=dev)].bfloat16()
            cr, sr = DB.rope_rows(cos_t, sin_t, position, 256)
            for layer in layers:
                blk = params["blocks"][str(layer)]
                shape = (4 * seq // page, kv, page, hd)
                kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
                vp = torch.randn(shape, generator=gen, device=dev).bfloat16()

                def args(f32):
                    return ((x.float() if f32 else x), blk["attn_norm"], blk["wqkv"]["int8"],
                            blk["wqkv"]["scale"], blk.get("bqkv"), cr, sr, kp.clone(),
                            vp.clone(), blk["wo"]["int8"], blk["wo"]["scale"], position, btr)

                errs.append(three(DB.attention_paged_chunk_step,
                                  DB.attention_paged_chunk_step_plain, args, n))
        report(f"attention_paged_chunk_step, 256-row chunks of 3 prompts at {position}", errs,
               hold=True)
    for position in (84, 1064, seq - SPEC_K - 1):
        errs = []
        for layer in layers:
            blk = params["blocks"][str(layer)]
            kc = torch.randn((kv, seq, hd), generator=gen, device=dev).bfloat16()
            vc = torch.randn((kv, seq, hd), generator=gen, device=dev).bfloat16()
            kc[:, position:] = float("nan")
            vc[:, position:] = float("nan")
            tok = torch.randint(0, cfg.vocab, (SPEC_K + 1,), generator=gen, device=dev)
            x = params["embed"][tok].bfloat16()
            cr, sr = DB.rope_rows(cos_t, sin_t, position, SPEC_K + 1)

            def args(f32):
                return ((x.float() if f32 else x), blk["attn_norm"], blk["wqkv"]["int8"],
                        blk["wqkv"]["scale"], blk.get("bqkv"), cr, sr, kc.clone(), vc.clone(),
                        blk["wo"]["int8"], blk["wo"]["scale"], position)

            errs.append(three(DB.attention_chunk_step, DB.attention_chunk_step_plain, args,
                              SPEC_K + 1))
        report(f"attention_chunk_step, 5 rows at {position}", errs, hold=True)

    # kernel 5: 16 streams x 5 rows at 30..940, stream 3 frozen (the sublayer's)
    m, slots, maxp = SPEC_K + 1, 16, seq // page
    positions = [int(p) for p in torch.linspace(30, 940, slots).round().tolist()]
    positions[3] = 0
    bt = torch.zeros((slots, maxp), dtype=torch.int32)
    nxt = 1
    for b, p in enumerate(positions):
        if p:
            n = -(-(p + m) // page)
            bt[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
            nxt += n
    bt = bt.to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    flat = (pos[:, None] + torch.arange(m, dtype=torch.int32, device=dev)[None, :]).reshape(-1)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, flat)
    errs = []
    for layer in layers:
        blk = params["blocks"][str(layer)]
        shape = (4 * seq // page, kv, page, hd)
        kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
        vp = torch.randn(shape, generator=gen, device=dev).bfloat16()
        tok = torch.randint(0, cfg.vocab, (slots * m,), generator=gen, device=dev)
        x = params["embed"][tok].bfloat16()

        def args(f32):
            return ((x.float() if f32 else x), blk["attn_norm"], blk["wqkv"]["int8"],
                    blk["wqkv"]["scale"], blk.get("bqkv"), cr, sr, kp.clone(), vp.clone(),
                    blk["wo"]["int8"], blk["wo"]["scale"], pos, bt)

        errs.append(three(DB.attention_paged_spec_step, DB.attention_paged_spec_step_plain,
                          args, slots * m, m=m))
    report("attention_paged_spec_step, 16 x 5 rows at 30..940", errs, hold=True)

    # kernel 3: 16 decode rows at the same positions and tables, fp and int8 KV
    cr, sr = DB.rope_rows_at(cos_t, sin_t, pos)
    for form in ("fp KV", "int8 KV"):
        errs = []
        for layer in layers:
            blk = params["blocks"][str(layer)]
            shape = (4 * seq // page, kv, page, hd)
            kp = torch.randn(shape, generator=gen, device=dev)
            vp = torch.randn(shape, generator=gen, device=dev)
            if form == "fp KV":
                pools = (kp.bfloat16(), vp.bfloat16())
            else:
                (kq, ks), (vq, vs) = DB.kv_quant_rows(kp), DB.kv_quant_rows(vp)
                pools = (kq, vq, ks, vs)
            tok = torch.randint(0, cfg.vocab, (slots,), generator=gen, device=dev)
            x = params["embed"][tok].bfloat16()

            def args(f32):
                p = [t.clone() for t in pools]
                return ((x.float() if f32 else x), blk["attn_norm"], blk["wqkv"]["int8"],
                        blk["wqkv"]["scale"], blk.get("bqkv"), cr, sr, p[0], p[1],
                        blk["wo"]["int8"], blk["wo"]["scale"], pos, bt, *p[2:])

            errs.append(three(DB.attention_paged_batch_step, DB.attention_paged_batch_step_plain,
                              args, slots))
        report(f"attention_paged_batch_step, {form}, 16 rows at 30..940", errs, hold=True)

    # kernel 8: 4 planes at 0, 700, 1500 and 2047, NaN from each position on
    live = [0, 700, 1500, seq - 1]
    dpos = torch.tensor(live, dtype=torch.int32, device=dev)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, dpos)
    errs = []
    for layer in layers:
        blk = params["blocks"][str(layer)]
        kc = torch.randn((len(live), kv, seq, hd), generator=gen, device=dev).bfloat16()
        vc = torch.randn((len(live), kv, seq, hd), generator=gen, device=dev).bfloat16()
        for b, n in enumerate(live):
            kc[b, :, n:] = float("nan")
            vc[b, :, n:] = float("nan")
        tok = torch.randint(0, cfg.vocab, (len(live),), generator=gen, device=dev)
        x = params["embed"][tok].bfloat16()

        def args(f32):
            return ((x.float() if f32 else x), blk["attn_norm"], blk["wqkv"]["int8"],
                    blk["wqkv"]["scale"], blk.get("bqkv"), cr, sr, kc.clone(), vc.clone(),
                    blk["wo"]["int8"], blk["wo"]["scale"], dpos)

        errs.append(three(DB.attention_batch_step, DB.attention_batch_step_plain, args,
                          len(live)))
    report("attention_batch_step, 4 planes at 0..2047", errs, hold=True)

    # kernel 9: one row at 1500, NaN from there on
    cr, sr = DB.rope_rows(cos_t, sin_t, 1500)
    errs = []
    for layer in layers:
        blk = params["blocks"][str(layer)]
        kc = torch.randn((kv, seq, hd), generator=gen, device=dev).bfloat16()
        vc = torch.randn((kv, seq, hd), generator=gen, device=dev).bfloat16()
        kc[:, 1500:] = float("nan")
        vc[:, 1500:] = float("nan")
        tok = torch.randint(0, cfg.vocab, (1,), generator=gen, device=dev)
        x = params["embed"][tok].bfloat16()

        def args(f32):
            return ((x.float() if f32 else x), blk["attn_norm"], blk["wqkv"]["int8"],
                    blk["wqkv"]["scale"], blk.get("bqkv"), cr, sr, kc.clone(), vc.clone(),
                    blk["wo"]["int8"], blk["wo"]["scale"], 1500)

        errs.append(three(DB.attention_step, DB.attention_step_plain, args, 1))
    report("attention_step, 1 row at 1500", errs, hold=True)


def _int8_operands(params, name):
    """The int8 weight and scale of ``name``: the head, or layer 0's block
    product."""
    w = params["lm_head"] if name == "lm_head" else params["blocks"]["0"][name]
    return w["int8"], w["scale"]


def _int8_cost(m: int, k: int, n: int) -> tuple[int, int]:
    """Kernel 7's (bytes, operations) on an m x k x n product: x, q and the
    scale read once, the bf16 output written once."""
    return m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n


def _flash_inputs(torch, gen, shape):
    """Seeded q, k, v of ``shape`` (B, H, T, D) in bf16, each a [B, T, H, D]
    tensor seen as [B, H, T, D] (the vision tower's projections)."""
    b, h, t, d = shape
    return tuple(torch.randn((b, t, h, d), generator=gen, device=gen.device).bfloat16()
                 .transpose(1, 2) for _ in range(3))


def _flash_cost(shape, causal: bool) -> tuple[int, int]:
    """Kernel 11's (bytes, operations): q, k, v read and out written once;
    the two products over the (query, key) pairs that count."""
    b, h, t, d = shape
    keys = t * (t + 1) // 2 if causal else t * t
    return 4 * b * h * t * d * 2, 4 * b * h * keys * d


def _attention_f64(torch, q, k, v, causal: bool):
    """Softmax attention over [B, H, T, D] in f64: the fidelity reference."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / d ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=q.device).tril(),
                          float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.double())


def check_flash_kernel(torch, FA, rng_seed: int, dev: str = "cuda") -> dict:
    """Phase 3, kernel 11: ``flash_attention`` against its plain version at
    every shape of FLASH_SHAPES, in the layout the vision tower hands it.
    Returns the ViT entry."""
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    entry = None
    for shape, causal in FLASH_SHAPES:
        q, k, v = _flash_inputs(torch, gen, shape)
        want = FA.flash_attention_plain(q, k, v, causal)
        got = FA.flash_attention(q, k, v, causal)
        err, rel = _rel(got, want)
        tol = REL_TOL["flash_attention"]
        what = f" at {shape}{' causal' if causal else ''}"
        if not rel <= tol:
            raise Failed(f"flash_attention{what} disagrees with its plain version: rel {rel:.3e}")

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)

        bound, by = _bound_ms(*_flash_cost(shape, causal))
        ms = _time_ms(torch, lambda: FA.flash_attention(q, k, v, causal))
        plain_ms = _time_ms(torch, lambda: FA.flash_attention_plain(q, k, v, causal), 5)
        lib_ms = _time_ms(torch, lib)
        print(f"kernel flash_attention{what}: rel {rel:.3e} (tol {tol}) max_abs_err {err:.3e} "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
              f"{bound:.4f} ({by})", flush=True)
        if not causal:
            entry = {"name": "flash_attention", "route": "cuda",
                     "source": "dora_tpu_torch/csrc/flash_attention.cu",
                     "replaces": "dora_tpu/ops/flash_attention.py:125", "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms}
    return entry


def int8_flash_breakdown(torch, IM, FA, params, rng_seed: int) -> None:
    """Kernels 7 and 11 launch by launch: ``int8_matmul`` at every shape of
    INT8_SHAPES (its product and, where K is split, its epilogue) beside
    cuBLAS on the dequantized bf16 weight, and ``flash_attention`` at every
    shape of FLASH_SHAPES beside SDPA on the same tensors: the device time
    of each launch from ``torch.profiler``, their sum, the wrapper on CUDA
    events and its host time, and the bound. The yardsticks are never
    called by the port."""
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    for name, m in INT8_SHAPES:
        q, sc = _int8_operands(params, name)
        k, n = q.shape
        x = (torch.randn((m, k), generator=gen, device=dev) * 0.5).bfloat16()
        w_bf = (q.float() * sc).bfloat16()

        def call():
            return IM.int8_matmul(x, q, sc)

        def cublas():
            return torch.matmul(x, w_bf)

        bound, by = _bound_ms(*_int8_cost(m, k, n))
        print(f"breakdown int8_matmul, {m} row(s) on {name} ({k} x {n}): "
              f"{_launch_parts(torch, call)}; wrapper {_time_ms(torch, call):.4f} ms, host "
              f"{_host_ms(torch, call):.4f} ms; cuBLAS on the dequantized weight "
              f"{_time_ms(torch, cublas):.4f} ms (device: {_launch_parts(torch, cublas)}); "
              f"bound {bound:.4f} ms ({by})", flush=True)
        del w_bf
    for shape, causal in FLASH_SHAPES:
        q, k, v = _flash_inputs(torch, gen, shape)

        def call():
            return FA.flash_attention(q, k, v, causal)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)

        bound, by = _bound_ms(*_flash_cost(shape, causal))
        print(f"breakdown flash_attention at {shape}{' causal' if causal else ''}: "
              f"{_launch_parts(torch, call)}; wrapper {_time_ms(torch, call):.4f} ms, host "
              f"{_host_ms(torch, call):.4f} ms; SDPA {_time_ms(torch, sdpa):.4f} ms (device: "
              f"{_launch_parts(torch, sdpa)}); bound {bound:.4f} ms ({by})", flush=True)


def flash_fidelity(torch, FA, rng_seed: int) -> None:
    """Kernel 11 and its plain version (both bf16 out) against softmax
    attention in f64 on the same bf16 inputs, as rel-rms, at the ViT's shape
    and at causal 2048: a kernel that rounded its probabilities to bf16
    would sit further from f64 than the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(rng_seed)
    for shape, causal in FLASH_SHAPES[:2]:
        q, k, v = _flash_inputs(torch, gen, shape)
        ref = _attention_f64(torch, q, k, v, causal)
        got = FA.flash_attention(q, k, v, causal).double()
        plain = FA.flash_attention_plain(q, k, v, causal).double()

        def rel(a, b):
            return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())

        print(f"fidelity flash_attention at {shape}{' causal' if causal else ''}: rel-rms vs "
              f"f64, kernel {rel(got, ref):.4e}, bf16 plain {rel(plain, ref):.4e}; kernel vs "
              f"plain {rel(got, plain):.4e}", flush=True)


#: phase 3's widened shapes: model widths (their config.json) with one layer
#: of seeded weights each
WIDTHS = {
    "Qwen2-0.5B": dict(dim=896, heads=14, kv_heads=2, ffn=4864),
    "Qwen2-1.5B": dict(dim=1536, heads=12, kv_heads=2, ffn=8960),
    "Qwen2-7B": dict(dim=3584, heads=28, kv_heads=4, ffn=18944),
}
#: (width, page, m) -> the attention kernels run there: head_dim 64 at
#: 14 / 2 heads (group 7), 36 q + k + v heads, page 32, and a k = 10 verify
#: of m x group = 11 x 6 = 66 rows
WIDE_CASES = (
    ("Qwen2-0.5B", 16, 5, ("batch", "batch_int8kv", "chunk", "spec", "dense_batch",
                           "dense_step", "dense_chunk")),
    ("Qwen2-7B", 16, 5, ("batch", "chunk", "spec", "dense_batch", "dense_step",
                         "dense_chunk")),
    ("Qwen2-1.5B", 32, 5, ("batch", "chunk", "spec")),
    ("Qwen2-1.5B", 16, 11, ("spec", "dense_chunk")),
)


def check_widened_kernels(torch, DB, LO, qwen2, rng_seed: int, dev: str = "cuda") -> list[str]:
    """Phase 3, the widened shapes: the attention kernels (fp KV; the
    int8-KV batch form at head_dim 64) at WIDE_CASES, one layer of seeded
    int8 weights at each width, against their plain versions; the LoRA
    kernel at rank 256. Each prints its time, the plain version's, the
    library yardstick's (SDPA over the same context; torch.bmm), for the
    attention kernels the library chain's (RMSNorm, cuBLAS qkv on the
    dequantized bf16 weights, SDPA, cuBLAS wo: the sublayer's function, as
    the ``sublayer`` lines time it) and the bound. Returns the printed
    lines."""
    from dora_tpu_torch.models.layers import rope_table

    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    seq, slots, chunk = 2048, 16, 256
    lines = []

    def report(name, what, got, want, ms, plain_ms, lib_ms, nbytes, ops, chain_ms=None):
        err, rel = _rel(got, want)
        tol = REL_TOL[name]
        bound, by = _bound_ms(nbytes, ops)
        chain = f" chain_ms {chain_ms:.4f}" if chain_ms is not None else ""
        line = (f"widened {name} {what}: rel {rel:.3e} (tol {tol}) max_abs_err {err:.3e} ms "
                f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f}{chain} bound_ms "
                f"{bound:.4f} ({by})")
        print(line, flush=True)
        lines.append(line)
        if not rel <= tol:
            raise Failed(f"{name} {what} disagrees with its plain version: rel {rel:.3e}")

    for width, page, m, kinds in WIDE_CASES:
        cfg = qwen2.Qwen2Config(vocab=4096, layers=1, rope_theta=1e6, norm_eps=1e-6,
                                tie_embeddings=False, max_seq=seq, **WIDTHS[width])
        params = qwen2.quantize_decode(
            qwen2.random_params(cfg, seed=rng_seed, std=0.02, device=dev), cfg)
        blk = params["blocks"]["0"]
        d, h, kv, hd = cfg.dim, cfg.heads, cfg.kv_heads, cfg.head_dim
        n_qkv = (h + 2 * kv) * hd
        cos_t, sin_t = rope_table(seq, hd, base=cfg.rope_theta, device=dev)
        w = (blk["attn_norm"], blk["wqkv"]["int8"], blk["wqkv"]["scale"], blk.get("bqkv"))
        wo = (blk["wo"]["int8"], blk["wo"]["scale"])
        kw = dict(heads=h, kv_heads=kv, head_dim=hd, eps=cfg.norm_eps)
        tag = f"at {width} (head_dim {hd}, {h}/{kv} heads), page {page}"
        weight_bytes = d * 4 + d * n_qkv + n_qkv * 8 + h * hd * d + d * 4
        # the chain's operands: the same weights dequantized to bf16
        nw = blk["attn_norm"].bfloat16()
        wqkv_bf = (blk["wqkv"]["int8"].float() * blk["wqkv"]["scale"]).bfloat16()
        wo_bf = (blk["wo"]["int8"].float() * blk["wo"]["scale"]).bfloat16()
        bq_bf = blk["bqkv"].bfloat16() if blk.get("bqkv") is not None else None

        def rows(n):
            tok = torch.randint(0, cfg.vocab, (n,), generator=gen, device=dev)
            return params["embed"][tok].bfloat16()

        def sdpa(q, kctx, vctx, mask):
            """(SDPA over the context alone, x -> the library chain over x's
            rows: RMSNorm, qkv, SDPA, wo)."""
            kk = torch.nan_to_num(kctx).repeat_interleave(h // kv, dim=1)
            vv = torch.nan_to_num(vctx).repeat_interleave(h // kv, dim=1)

            def attend():
                return torch.nn.functional.scaled_dot_product_attention(q, kk, vv,
                                                                        attn_mask=mask)

            def chain(x):
                def run():
                    if hasattr(torch.nn.functional, "rms_norm"):
                        normed = torch.nn.functional.rms_norm(x, (d,), nw, cfg.norm_eps)
                    else:
                        xf = x.float()
                        normed = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True)
                                                   + cfg.norm_eps) * nw).bfloat16()
                    qkv = torch.matmul(normed, wqkv_bf)
                    if bq_bf is not None:
                        qkv = qkv + bq_bf
                    o = attend()
                    return torch.matmul(o.transpose(1, 2).reshape(x.shape[0], h * hd), wo_bf)
                return run

            return attend, chain

        def held(name, what, kernel, plain, args, kwargs, lib, nbytes, ops):
            fresh = lambda: [a.clone() if isinstance(a, torch.Tensor) and a.dim() >= 3  # noqa: E731
                             else a for a in args]
            want = plain(*fresh(), **kwargs)[0]
            got = kernel(*fresh(), **kwargs)[0]
            keep = fresh()
            attend, chain = lib
            report(name, what, got, want, _time_ms(torch, lambda: kernel(*keep, **kwargs)),
                   _time_ms(torch, lambda: plain(*keep, **kwargs), 3),
                   _time_ms(torch, attend), nbytes, ops, _time_ms(torch, chain(args[0])))

        # Paged pools with streams at serving positions; one stream frozen.
        n_pool = 4 * seq // page
        shape = (n_pool, kv, page, hd)
        kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
        vp = torch.randn(shape, generator=gen, device=dev).bfloat16()
        positions = [int(p) for p in torch.linspace(30, 940, slots).round().tolist()]
        positions[3] = 0
        bt = torch.zeros((slots, seq // page), dtype=torch.int32)
        nxt = 1
        for b, p in enumerate(positions):
            if p:
                n = -(-(p + m) // page)
                bt[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
                nxt += n
        bt = bt.to(dev)
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        ctx = sum(positions)
        maxp = bt.shape[1]
        kctx = kp[bt.long()].permute(0, 2, 1, 3, 4).reshape(slots, kv, maxp * page, hd)
        vctx = vp[bt.long()].permute(0, 2, 1, 3, 4).reshape(slots, kv, maxp * page, hd)
        for kind in kinds:
            if kind in ("batch", "batch_int8kv"):
                x = rows(slots)
                cr, sr = DB.rope_rows_at(cos_t, sin_t, pos)
                pools = [kp, vp]
                kv_row = kv * hd * 2 * 2
                if kind == "batch_int8kv":
                    kq, ks = DB.kv_quant_rows(kp.float())
                    vq, vs = DB.kv_quant_rows(vp.float())
                    pools = [kq, vq]
                    kv_row = kv * (hd + 4) * 2
                args = [x, *w, cr, sr, *pools, *wo, pos, bt]
                if kind == "batch_int8kv":
                    args += [ks, vs]
                mask = (torch.arange(maxp * page, device=dev)[None, :] <= pos[:, None])
                held("attention_paged_batch_step" + ("_int8kv" if kind != "batch" else ""),
                     tag, DB.attention_paged_batch_step, DB.attention_paged_batch_step_plain,
                     args, kw,
                     sdpa(torch.randn((slots, h, 1, hd), generator=gen, device=dev).bfloat16(),
                          kctx, vctx, mask[:, None, None, :]),
                     slots * d * 2 * 2 + weight_bytes + slots * hd * 8 + slots * 4
                     + bt.numel() * 4 + (ctx + slots) * kv_row,
                     2 * slots * d * n_qkv + 4 * h * hd * (ctx + slots) + 2 * slots * h * hd * d)
            elif kind == "chunk":
                position = 2 * chunk
                btr = torch.arange(1, seq // page + 1, dtype=torch.int32, device=dev)
                x = rows(chunk)
                cr, sr = DB.rope_rows(cos_t, sin_t, position, chunk)
                n_keys = position + chunk
                kc = kp[btr[: n_keys // page].long()].permute(1, 0, 2, 3).reshape(1, kv, n_keys, hd)
                vc = vp[btr[: n_keys // page].long()].permute(1, 0, 2, 3).reshape(1, kv, n_keys, hd)
                cmask = (torch.arange(n_keys, device=dev)[None, :]
                         <= position + torch.arange(chunk, device=dev)[:, None])
                causal_keys = chunk * position + chunk * (chunk + 1) // 2
                held("attention_paged_chunk_step", f"{tag}, 256 rows at 512", DB.attention_paged_chunk_step,
                     DB.attention_paged_chunk_step_plain,
                     [x, *w, cr, sr, kp, vp, *wo, position, btr], kw,
                     sdpa(torch.randn((1, h, chunk, hd), generator=gen, device=dev).bfloat16(),
                          kc, vc, cmask),
                     chunk * d * 2 * 2 + weight_bytes + chunk * hd * 8 + btr.numel() * 4
                     + n_keys * kv * hd * 2 * 2,
                     2 * chunk * d * n_qkv + 4 * h * hd * causal_keys + 2 * chunk * h * hd * d)
            elif kind == "spec":
                bm = slots * m
                flat = (pos[:, None] + torch.arange(m, dtype=torch.int32, device=dev)[None, :])
                cr, sr = DB.rope_rows_at(cos_t, sin_t, flat.reshape(bm))
                smask = (torch.arange(maxp * page, device=dev)[None, None, :]
                         <= flat[:, :, None])[:, None]
                held("attention_paged_spec_step", f"{tag}, {slots} x {m} rows (m x group "
                     f"{m * (h // kv)})", DB.attention_paged_spec_step,
                     DB.attention_paged_spec_step_plain,
                     [rows(bm), *w, cr, sr, kp, vp, *wo, pos, bt], dict(kw, m=m),
                     sdpa(torch.randn((slots, h, m, hd), generator=gen, device=dev).bfloat16(),
                          kctx, vctx, smask),
                     bm * d * 2 * 2 + weight_bytes + bm * hd * 8 + slots * 4 + bt.numel() * 4
                     + (ctx + bm) * kv * hd * 2 * 2,
                     2 * bm * d * n_qkv + 4 * h * hd * (m * ctx + slots * m * (m + 1) // 2)
                     + 2 * bm * h * hd * d)
            else:  # the dense caches: 4 planes, one row at 1500, m rows ending at 2047
                if kind == "dense_batch":
                    live = [0, 700, 1500, seq - 1]
                    rows_n, ctx_rows, keys = len(live), sum(live), sum(live) + len(live)
                    dpos = torch.tensor(live, dtype=torch.int32, device=dev)
                    cr, sr = DB.rope_rows_at(cos_t, sin_t, dpos)
                    where, qrows, planes = dpos, 1, len(live)
                    mask = (torch.arange(seq, device=dev)[None, :] <= dpos[:, None])[:, None, None, :]
                    kernel, plain = DB.attention_batch_step, DB.attention_batch_step_plain
                    what = "4 planes at 0..2047"
                else:
                    rows_n = 1 if kind == "dense_step" else m
                    position = 1500 if kind == "dense_step" else seq - m
                    live, ctx_rows = [position], position
                    keys = rows_n * position + rows_n * (rows_n + 1) // 2
                    cr, sr = DB.rope_rows(cos_t, sin_t, position, rows_n)
                    where, qrows, planes = position, rows_n, 0
                    mask = (torch.arange(seq, device=dev)[None, :]
                            <= position + torch.arange(rows_n, device=dev)[:, None])
                    kernel, plain = ((DB.attention_step, DB.attention_step_plain)
                                     if kind == "dense_step"
                                     else (DB.attention_chunk_step, DB.attention_chunk_step_plain))
                    what = f"{rows_n} row(s) at {position}" + (
                        f" (m x group {m * (h // kv)})" if rows_n > 1 else "")
                kc = torch.randn((len(live), kv, seq, hd), generator=gen, device=dev).bfloat16()
                vc = torch.randn((len(live), kv, seq, hd), generator=gen, device=dev).bfloat16()
                for b, n in enumerate(live):
                    kc[b, :, n:] = float("nan")
                    vc[b, :, n:] = float("nan")
                q = torch.randn((len(live), h, qrows, hd), generator=gen, device=dev).bfloat16()
                lib = sdpa(q, kc, vc, mask)
                if kind != "dense_batch":
                    kc, vc = kc[0], vc[0]
                held(kernel.__name__, f"at {width} (head_dim {hd}, {h}/{kv} heads), {what}",
                     kernel, plain, [rows(rows_n), *w, cr, sr, kc, vc, *wo, where], kw, lib,
                     rows_n * d * 2 * 2 + weight_bytes + rows_n * hd * 8 + planes * 4
                     + (ctx_rows + rows_n) * kv * hd * 2 * 2,
                     2 * rows_n * d * n_qkv + 4 * h * hd * keys + 2 * rows_n * h * hd * d)
        del params, kp, vp, kctx, vctx

    # LoRA at rank 256, Qwen2-1.5B width, 16 rows over a 9-slot stack.
    d, rank, nslots, rows_n = 1536, 256, 9, 16
    a = (torch.randn((nslots, d, rank), generator=gen, device=dev) * ADAPTER_STD).bfloat16()
    b = (torch.randn((nslots, rank, d), generator=gen, device=dev) * ADAPTER_STD).bfloat16()
    a[0] = 0
    b[0] = 0
    x = (torch.randn((rows_n, d), generator=gen, device=dev) * 0.5).bfloat16()
    g = torch.randint(0, nslots, (rows_n,), generator=gen, device=dev, dtype=torch.int32)
    g[:2] = 0
    got, want = LO.lora_gather_matmul(x, g, a, b), LO.lora_gather_matmul_plain(x, g, a, b)
    if got[g == 0].float().abs().max().item() != 0.0:
        raise Failed("lora_gather_matmul at rank 256: slot-0 rows are not exactly zero")
    distinct = int(torch.unique(g[g != 0]).numel())
    gl = g.long()
    report("lora_gather_matmul", f"at rank 256, {rows_n} rows ({distinct} distinct adapters)",
           got, want, _time_ms(torch, lambda: LO.lora_gather_matmul(x, g, a, b)),
           _time_ms(torch, lambda: LO.lora_gather_matmul_plain(x, g, a, b), 5),
           _time_ms(torch, lambda: torch.bmm(torch.bmm(x[:, None, :], a[gl]), b[gl])),
           distinct * 2 * d * rank * 2 + rows_n * d * 2 * 2 + rows_n * 4, 4 * rows_n * d * rank)
    return lines


#: phase 11's prompt: text tokens after the image's patches
VLM_PROMPT = 16
#: the kernels the VLM's greedy generate runs (phase 11)
VLM_KERNELS = ("flash_attention", "int8_matmul", "attention_step", "mlp_step",
               "lm_head_argmax")


def vlm_step_times(torch, vlm, seed: int, max_new: int) -> None:
    """``--paths``: the VLM's ``generate`` at bench_2b on seeded random
    weights (one image, a 16-token prompt, ``max_new`` tokens), twice: its
    TTFT and its decode step time (``attention_step``, ``mlp_step`` and the
    head a step). The second run is the one printed."""
    import numpy as np

    cfg = vlm.VLMConfig.bench_2b()
    params = vlm.quantize_decode(vlm.init_params(cfg, seed=seed, device="cuda"))
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(
        rng.uniform(size=(1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)).cuda()
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(1, VLM_PROMPT)).astype(np.int32)).cuda()
    real_prefill = vlm.prefill
    t_pre = []

    def timed_prefill(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(*a, **k)
        torch.cuda.synchronize()
        t_pre.append(time.perf_counter() - t)
        return out

    vlm.prefill = timed_prefill
    try:
        for _ in range(2):
            t_pre.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vlm.generate(params, cfg, image, prompt, max_new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        vlm.prefill = real_prefill
    steps = max_new - 1
    vit_ms = _time_ms(torch, lambda: vlm.encode_image(params, cfg, image), 5)
    print(f"path times, vlm generate at bench_2b: prefill (ViT included) {1e3 * t_pre[0]:.2f} "
          f"ms; {steps} decode steps {1e3 * (wall - t_pre[0]) / steps:.3f} ms a step; ViT "
          f"{vit_ms:.3f} ms per image, {_vit_device(torch, vlm, params, cfg, image)}",
          flush=True)


def _vit_device(torch, vlm, params, cfg, image, iters: int = 3) -> str:
    """The device time of one ``encode_image`` (every kernel it launches,
    from ``torch.profiler``, averaged over ``iters`` calls) and, of it,
    flash_attention's."""
    kern = _device_kernels(torch, lambda: vlm.encode_image(params, cfg, image), iters)
    if not kern:
        return "device time not measured (the profiler saw no kernel)"
    flash = [us for n, us in kern if n.startswith("flash_fwd")]
    return (f"device: {len(kern) / iters:.0f} kernels {sum(us for _, us in kern) / iters / 1e3:.3f}"
            f" ms, of them {len(flash) / iters:.0f} flash_attention "
            f"{sum(flash) / iters / 1e3:.3f} ms")


def serve_vlm(torch, DB, LO, vlm, paths, params, cfg, seed: int, max_new: int) -> dict:
    """Phase 11: the self-contained VLM at ``cfg`` (bench_2b) on seeded
    random weights: its vision tower against the dense einsum and an f32
    reference, then ``generate`` and ``generate_speculative`` (k = 4) of
    ``max_new`` tokens, each held to the f32 plain path by the near-tie
    rule. Returns the launches of ``generate``."""
    import numpy as np

    from dora_tpu_torch.ops import flash_attention as FA

    dev = params["embed"].device
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(
        rng.uniform(size=(1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)).to(dev)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(1, VLM_PROMPT)).astype(np.int32)).to(dev)
    position = cfg.n_patches + VLM_PROMPT

    def rms(a):
        return float(a.float().pow(2).mean().sqrt())

    # The vision tower: flash attention (the card's default) against the
    # dense einsum (DORA_FLASH_ATTENTION=0) and both against the f32 plain
    # path; the flash output may be at most RMS_MARGIN times as far from f32.
    with _env(DORA_FLASH_ATTENTION=None):
        FA.reset_launches()
        flash_img = vlm.encode_image(params, cfg, image)
        torch.cuda.synchronize()
        per_image = FA.flash_attention.launches
        vit_ms = _time_ms(torch, lambda: vlm.encode_image(params, cfg, image), 5)
        vit_device = _vit_device(torch, vlm, params, cfg, image)
    with _env(DORA_FLASH_ATTENTION="0"):
        dense_img = vlm.encode_image(params, cfg, image)
        dense_ms = _time_ms(torch, lambda: vlm.encode_image(params, cfg, image), 5)
        ref_img = paths.run(lambda: vlm.encode_image(params, cfg, image), "f32").float()
    r_flash, r_dense = rms(flash_img - ref_img), rms(dense_img - ref_img)
    print(f"vlm phase: encode_image {tuple(flash_img.shape)}: flash_attention launches "
          f"{per_image} per image; flash vs dense einsum rms {rms(flash_img - dense_img):.4e} "
          f"({rms(flash_img - dense_img) / rms(dense_img):.3e} of the output's rms "
          f"{rms(dense_img):.4e}); vs the f32 plain path: flash {r_flash:.4e}, dense {r_dense:.4e}; "
          f"ViT {vit_ms:.3f} ms per image with flash ({vit_device}), {dense_ms:.3f} ms dense",
          flush=True)
    if per_image != cfg.vision_layers:
        raise Failed(f"encode_image launched flash_attention {per_image} times, not once per "
                     f"vision layer ({cfg.vision_layers})")
    if not r_flash <= max(RMS_MARGIN * r_dense, 1e-5 * rms(ref_img)):  # 1e-5: f32 rounding
        raise Failed("the vision tower's flash path is further from the f32 reference than "
                     "the dense einsum's bf16 rounding explains")

    def run(what, fn, want):
        """``fn()`` on the kernel path with every count at 0 first; the
        launches must be exactly ``want(n)`` for n fused passes (every
        other kernel 0)."""
        plain_calls = _PlainCalls(DB, LO)
        _reset_launches(DB, LO)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t0
            launches = _launches(DB, LO)
            plain_calls.restore()
        got = {n: c for n, c in launches.items() if c}
        print(f"vlm {what}: launches {json.dumps(got)}; plain calls {plain_calls.n}", flush=True)
        if plain_calls.n:
            raise Failed(f"{plain_calls.n} plain-version call(s) ran in vlm {what}")
        n = got.get("lm_head_argmax", 0)
        want = {"flash_attention": cfg.vision_layers, "int8_matmul": 1, want: cfg.layers * n,
                "mlp_step": cfg.layers * n, "lm_head_argmax": n}
        if got != want or not n:
            raise Failed(f"vlm {what} launched {got}, expected {want} with passes")
        return res, wall, launches

    ttft = []
    real_prefill, real_chunk = vlm.prefill, vlm.decode_chunk_fused

    def timed_prefill(*a, **k):
        out = real_prefill(*a, **k)
        torch.cuda.synchronize()
        ttft.append(time.perf_counter() - t_call[0])
        return out

    verified = []  # (chunk, cache position) of every verify pass, for the replay

    def recorded(p, c, tokens, caches, pos, rope=None):
        verified.append((tokens.clone(), pos))
        return real_chunk(p, c, tokens, caches, pos, rope)

    steps = max_new - 1
    t_call = [0.0]
    vlm.prefill = timed_prefill
    try:
        t_call[0] = time.perf_counter()
        gen, wall, g_launches = run(
            "generate", lambda: vlm.generate(params, cfg, image, prompt, max_new),
            "attention_step")
        vlm.decode_chunk_fused = recorded
        t_call[0] = time.perf_counter()
        (spec, passes), s_wall, s_launches = run(
            "generate_speculative",
            lambda: vlm.generate_speculative(params, cfg, image, prompt, max_new, k=SPEC_K),
            "attention_chunk_step")
    finally:
        vlm.prefill, vlm.decode_chunk_fused = real_prefill, real_chunk
    if g_launches["lm_head_argmax"] != steps or s_launches["lm_head_argmax"] != len(verified):
        raise Failed("the fused passes do not match the steps and verify passes run")
    gen, spec = gen[0].tolist(), spec[0].tolist()
    _check_streams({"generate": gen, "generate_speculative": spec}, max_new, cfg.vocab)
    print(f"vlm phase: TTFT {ttft[0]:.3f} s (prefill of {position} rows, ViT included); "
          f"generate {max_new} tokens in {wall:.3f} s, decode {steps / (wall - ttft[0]):.1f} "
          f"tokens/s ({1e3 * (wall - ttft[0]) / steps:.2f} ms a step); generate_speculative "
          f"{max_new} tokens in {s_wall:.3f} s, TTFT {ttft[1]:.3f} s, {passes} model passes "
          f"({passes / max_new:.3f} passes per token, {steps / max(passes - 1, 1):.3f} tokens "
          f"per verify pass; {len(verified)} verify passes launched, overshoot included), "
          f"decode {steps / (s_wall - ttft[1]):.1f} tokens/s", flush=True)

    ref = paths.run(lambda: vlm.generate(params, cfg, image, prompt, max_new), "f32")[0].tolist()

    def stepped(at):
        """generate's path to the logits of token ``at``: its tokens before
        it through one-row steps (kernel 9)."""
        def go():
            _, caches, _ = vlm.prefill(params, cfg, image, prompt)
            for j, tok in enumerate(gen[:at]):
                token = torch.tensor([tok], dtype=torch.int32, device=dev)
                _, caches = vlm.decode_step_fused(params, cfg, token, caches, position + j)
        return lambda mode: paths.logits_of(go, mode)[-1]

    def replayed(at):
        """generate_speculative's path to the logits of token ``at``: its
        verify passes up to the one that emitted it (kernel 10), that
        pass's row for it."""
        upto = [(c, p) for c, p in verified if p - position + 1 <= at]

        def go():
            _, caches, _ = vlm.prefill(params, cfg, image, prompt)
            for c, p in upto:
                _, caches = vlm.decode_chunk_fused(params, cfg, c, caches, p)
        row = at - (upto[-1][1] - position + 1) if upto else -1
        return lambda mode: paths.logits_of(go, mode)[row]

    same = _first_parting(gen, spec, max_new)
    print(f"vlm agreement: generate and generate_speculative: first {same} of {max_new} "
          f"tokens equal", flush=True)
    # generate's token is held to NEAR_TIE of the f32 top; the verify path's
    # to SPEC_REF_TIE (kernel 10 folds its rows from bf16, as its reference
    # does), as phases 7, 8c and 10 hold theirs.
    for label, stream, path, bound in (("generate", gen, stepped, NEAR_TIE),
                                       ("generate_speculative", spec, replayed, SPEC_REF_TIE)):
        same = _first_parting(stream, ref, max_new)
        at = min(same, max_new - 1)
        print(f"vlm agreement: {label} vs the f32 plain path: first {same} of {max_new} "
              f"tokens equal", flush=True)
        paths.check(f"vlm agreement, {label}, token {at}", path(at),
                    (ref[same], stream[same]) if same < max_new else None, bound)
    return g_launches


# ---------------------------------------------------------------------------
# phase 15: the HF vision-language families at their published widths
# ---------------------------------------------------------------------------

#: Qwen/Qwen2-VL-2B-Instruct's config.json (the keys its loader reads)
QWEN2_VL_2B = {
    "vocab_size": 151936, "hidden_size": 1536, "intermediate_size": 8960,
    "num_hidden_layers": 28, "num_attention_heads": 12, "num_key_value_heads": 2,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
    "max_position_embeddings": 32768,
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "image_token_id": 151655, "video_token_id": 151656, "vision_start_token_id": 151652,
    "vision_end_token_id": 151653,
    "vision_config": {"depth": 32, "embed_dim": 1280, "num_heads": 16, "mlp_ratio": 4,
                      "patch_size": 14, "temporal_patch_size": 2, "spatial_merge_size": 2,
                      "in_chans": 3, "hidden_size": 1536},
}
#: OpenGVLab/InternVL3-1B-hf's config.json (InternViT-300M and a Qwen2.5-0.5B
#: LM with its own head over the 151674-token vocabulary)
INTERNVL3_1B = {
    "downsample_ratio": 0.5, "image_token_id": 151667,
    "text_config": {"vocab_size": 151674, "hidden_size": 896, "intermediate_size": 4864,
                    "num_hidden_layers": 24, "num_attention_heads": 14,
                    "num_key_value_heads": 2, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
                    "tie_word_embeddings": False, "max_position_embeddings": 32768},
    "vision_config": {"hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
                      "intermediate_size": 4096, "image_size": [448, 448],
                      "patch_size": [14, 14], "use_qk_norm": False, "layer_norm_eps": 1e-6,
                      "attention_bias": True},
}
#: new tokens a serving step; text tokens after the image run
HF_VLM_MAX_NEW = 64
HF_VLM_PROMPT = 16
#: the InternVL3 tokenizer's <img> and </img> around the image run
INTERNVL_IMG_START, INTERNVL_IMG_END = 151665, 151666
#: the vision tower's bf16 output against its f32 run on the card: relative
#: RMS bound, about three times what torch's CPU bf16 products showed on these
#: seeded towers (2.1e-2 for Qwen2-VL's 32 layers, 1.4e-2 for InternViT's
#: 24): bf16 rounds every product, activation and residual of the tower
VIT_REL_RMS = 0.06
#: the kernels of both families' greedy serving step (phase 15); the
#: speculative step runs attention_chunk_step in attention_step's place
HF_VLM_KERNELS = ("int8_matmul", "attention_step", "mlp_step", "lm_head_argmax")


def _qwen2_text_tensors(normal, ones, prefix: str, d: int, heads: int, kv: int, hd: int,
                        ffn: int, vocab: int, layers: int) -> dict:
    """A Qwen2 LM's checkpoint tensors under ``prefix`` (HF names and
    [out, in] shapes, q/k/v biases)."""
    t = {f"{prefix}embed_tokens.weight": normal(vocab, d), f"{prefix}norm.weight": ones(d)}
    for i in range(layers):
        p = f"{prefix}layers.{i}."
        t.update({
            p + "input_layernorm.weight": ones(d),
            p + "self_attn.q_proj.weight": normal(heads * hd, d),
            p + "self_attn.q_proj.bias": normal(heads * hd),
            p + "self_attn.k_proj.weight": normal(kv * hd, d),
            p + "self_attn.k_proj.bias": normal(kv * hd),
            p + "self_attn.v_proj.weight": normal(kv * hd, d),
            p + "self_attn.v_proj.bias": normal(kv * hd),
            p + "self_attn.o_proj.weight": normal(d, heads * hd),
            p + "post_attention_layernorm.weight": ones(d),
            p + "mlp.gate_proj.weight": normal(ffn, d),
            p + "mlp.up_proj.weight": normal(ffn, d),
            p + "mlp.down_proj.weight": normal(d, ffn),
        })
    return t


def hf_vlm_tensors(torch, family: str, cfg, seed: int, dev: str = "cuda") -> dict:
    """Seeded random checkpoint tensors of ``family`` ("qwen2_vl" or
    "internvl") at ``cfg``'s shapes, under the names and [out, in] layouts
    that transformers writes (Qwen2-VL: ``model.*`` and ``visual.*``;
    InternVL: ``language_model.*``, ``vision_tower.*``,
    ``multi_modal_projector.*``): weights and biases normal (std 0.02),
    norm weights one and biases zero, layer scales 0.1."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev) * 0.02

    def ones(*shape):
        return torch.ones(*shape, device=dev)

    def zeros(*shape):
        return torch.zeros(*shape, device=dev)

    if family == "qwen2_vl":
        v = cfg.vision
        t = _qwen2_text_tensors(normal, ones, "model.", cfg.dim, cfg.heads, cfg.kv_heads,
                                cfg.head_dim, cfg.ffn, cfg.vocab, cfg.layers)
        if not cfg.tie_embeddings:
            t["lm_head.weight"] = normal(cfg.vocab, cfg.dim)
        e, f, m = v.embed_dim, int(v.embed_dim * v.mlp_ratio), v.merge_dim
        t["visual.patch_embed.proj.weight"] = normal(e, v.in_channels, v.temporal_patch_size,
                                                     v.patch_size, v.patch_size)
        for i in range(v.depth):
            p = f"visual.blocks.{i}."
            t.update({p + "norm1.weight": ones(e), p + "norm1.bias": zeros(e),
                      p + "attn.qkv.weight": normal(3 * e, e), p + "attn.qkv.bias": normal(3 * e),
                      p + "attn.proj.weight": normal(e, e), p + "attn.proj.bias": normal(e),
                      p + "norm2.weight": ones(e), p + "norm2.bias": zeros(e),
                      p + "mlp.fc1.weight": normal(f, e), p + "mlp.fc1.bias": normal(f),
                      p + "mlp.fc2.weight": normal(e, f), p + "mlp.fc2.bias": normal(e)})
        t.update({"visual.merger.ln_q.weight": ones(e), "visual.merger.ln_q.bias": zeros(e),
                  "visual.merger.mlp.0.weight": normal(m, m), "visual.merger.mlp.0.bias": normal(m),
                  "visual.merger.mlp.2.weight": normal(v.out_dim, m),
                  "visual.merger.mlp.2.bias": normal(v.out_dim)})
        return t
    tc, v = cfg.text, cfg.vision
    t = _qwen2_text_tensors(normal, ones, "language_model.model.", tc.dim, tc.heads,
                            tc.kv_heads, tc.head_dim, tc.ffn, tc.vocab, tc.layers)
    t["language_model.lm_head.weight"] = normal(tc.vocab, tc.dim)
    e, f = v.embed_dim, v.ffn
    pre = "vision_tower.embeddings."
    t.update({pre + "cls_token": normal(1, 1, e),
              pre + "position_embeddings": normal(1, 1 + v.n_patches, e),
              pre + "patch_embeddings.projection.weight": normal(e, 3, v.patch_size,
                                                                 v.patch_size),
              pre + "patch_embeddings.projection.bias": normal(e)})
    for i in range(v.depth):
        p = f"vision_tower.encoder.layer.{i}."
        t.update({p + "layernorm_before.weight": ones(e), p + "layernorm_before.bias": zeros(e),
                  p + "attention.q_proj.weight": normal(e, e), p + "attention.q_proj.bias": normal(e),
                  p + "attention.k_proj.weight": normal(e, e), p + "attention.k_proj.bias": normal(e),
                  p + "attention.v_proj.weight": normal(e, e), p + "attention.v_proj.bias": normal(e),
                  p + "attention.projection_layer.weight": normal(e, e),
                  p + "attention.projection_layer.bias": normal(e),
                  p + "lambda_1": ones(e) * 0.1, p + "lambda_2": ones(e) * 0.1,
                  p + "layernorm_after.weight": ones(e), p + "layernorm_after.bias": zeros(e),
                  p + "mlp.fc1.weight": normal(f, e), p + "mlp.fc1.bias": normal(f),
                  p + "mlp.fc2.weight": normal(e, f), p + "mlp.fc2.bias": normal(e)})
    w = int(e / cfg.downsample_ratio ** 2)
    t.update({"multi_modal_projector.layer_norm.weight": ones(w),
              "multi_modal_projector.layer_norm.bias": zeros(w),
              "multi_modal_projector.linear_1.weight": normal(tc.dim, w),
              "multi_modal_projector.linear_1.bias": normal(tc.dim),
              "multi_modal_projector.linear_2.weight": normal(tc.dim, tc.dim),
              "multi_modal_projector.linear_2.bias": normal(tc.dim)})
    return t


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


def serve_hf_vlms(torch, DB, LO, IM, L, qwen2, serve_prompts, seed: int) -> None:
    """Phase 15: Qwen2-VL-2B, then InternVL3-1B (:func:`serve_hf_vlm`)."""
    for offset, family, hf_config in ((30, "qwen2_vl", QWEN2_VL_2B),
                                      (31, "internvl", INTERNVL3_1B)):
        serve_hf_vlm(torch, DB, LO, IM, L, qwen2, serve_prompts, family, hf_config,
                     seed + offset, HF_VLM_MAX_NEW)
        torch.cuda.empty_cache()


class _HFVLM:
    """One family's serving step on the card, with what phase 15 reads off
    it: the vision tower alone (preprocessing included) and its prompt's
    prefill and fused passes for the near-tie replays."""

    def __init__(self, torch, family: str, hf_config: dict, seed: int, max_new: int,
                 dev: str = "cuda"):
        import numpy as np

        from dora_tpu_torch.models.hf import internvl, qwen2, qwen2_vl

        self.torch, self.family = torch, family
        self.mod = qwen2_vl if family == "qwen2_vl" else internvl
        config_cls = qwen2_vl.Qwen2VLConfig if family == "qwen2_vl" else internvl.InternVLConfig
        cfg = config_cls.from_hf(hf_config, max_seq=2048)
        self.cfg = cfg
        self.text_cfg = cfg if family == "qwen2_vl" else cfg.text
        t0 = time.perf_counter()
        tensors = hf_vlm_tensors(torch, family, cfg, seed, dev)
        self.n_params = sum(v.numel() for v in tensors.values())
        params = self.mod.map_params(tensors, cfg)
        del tensors
        self.n_vision = _numel(params["vision"])
        with _env(DORA_INT4_DECODE=None, DORA_WEIGHT_BITS=None, DORA_INT8_PURE=None):
            self.params = self.mod.quantize_decode(params, cfg)
        del params
        torch.cuda.synchronize()
        self.load_s = time.perf_counter() - t0
        rng = np.random.default_rng(seed)
        text = rng.integers(0, 151643, size=HF_VLM_PROMPT).tolist()
        if family == "qwen2_vl":
            h = w = 448
            self.prompt = qwen2_vl.build_prompt_ids(cfg, text, h, w)
            self.grid_thw = np.array([[1, h // cfg.vision.patch_size, w // cfg.vision.patch_size]])
            pos, delta = qwen2_vl.rope_index(cfg, self.prompt, self.grid_thw)
            self.pos, self.delta = torch.from_numpy(pos).to(dev), int(delta[0])
            self.tables = qwen2_vl._vision_tables(cfg.vision, self.grid_thw, dev)
            self.step = {spec: qwen2_vl.make_serving_step(cfg, self.prompt, h, w, max_new, spec)
                         for spec in (False, True)}
            self.fused_owner, self.fused_name = qwen2_vl, "_fused_pass"
        else:
            h, w = 448, 896
            self.grid = internvl.tile_grid(w, h)
            cols, rows, n_tiles = self.grid
            self.prompt = internvl.build_prompt_ids(cfg, text, n_tiles, INTERNVL_IMG_START,
                                                    INTERNVL_IMG_END)
            self.delta = self.prompt.shape[1]
            self.rope = qwen2._rope(cfg.text, dev)
            self.step = {spec: internvl.make_serving_step(cfg, self.prompt, cols, rows, 448,
                                                          max_new, spec)
                         for spec in (False, True)}
            self.fused_owner, self.fused_name = qwen2, "fused_step"
        self.t = self.prompt.shape[1]
        self.n_image = int((self.prompt == (cfg.image_token_id)).sum())
        self.prompt_t = torch.from_numpy(self.prompt).to(dev)
        self.frame = torch.from_numpy(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).to(dev)

    def pixels(self):
        """The frame through the family's preprocessing."""
        m = self.mod
        if self.family == "qwen2_vl":
            return m.preprocess_image(self.frame, self.cfg.vision, 448, 448)
        cols, rows, _ = self.grid
        return m.preprocess_tiles(self.frame, cols, rows, 448)

    def tower(self, pixels):
        """The vision tower over preprocessed pixels: image tokens [N, dim]."""
        if self.family == "qwen2_vl":
            return self.mod._vision_forward(self.params, self.cfg.vision, pixels, *self.tables)
        return self.mod.encode_images(self.params, self.cfg, pixels)

    def prefill(self):
        """The frame's image tokens and the prompt's prefill, as the serving
        step runs them."""
        feats = self.tower(self.pixels())
        if self.family == "qwen2_vl":
            return self.mod._prefill(self.params, self.cfg, self.prompt_t, feats, self.pos)
        return self.mod._prefill(self.params, self.cfg, self.prompt_t, feats, self.rope)


def serve_hf_vlm(torch, DB, LO, IM, L, qwen2, serve_prompts, family: str, hf_config: dict,
                 seed: int, max_new: int, dev: str = "cuda") -> dict:
    """Phase 15, one family: seeded random weights at the published shapes
    under the checkpoint's tensor names through the port's ``map_params``,
    int8 ``quantize_decode``; the vision tower's bf16 output against its f32
    run; then ``make_serving_step`` on one seeded uint8 frame, greedy and
    speculative (k = 4), each with its exact launches and no plain version;
    greedy tokens held to the f32 plain path's, speculative ones to greedy's,
    by the near-tie rule. Returns the greedy run's launches."""
    vm = _HFVLM(torch, family, hf_config, seed, max_new, dev)
    cfg, tc = vm.cfg, vm.text_cfg
    name = "qwen2_vl" if family == "qwen2_vl" else "internvl"
    vc = cfg.vision
    print(f"hf vlm {name}: {vm.n_params / 1e9:.3f} B parameters (vision {vm.n_vision / 1e9:.3f} "
          f"B: {vc.depth} x {vc.embed_dim}; LM {tc.layers} x {tc.dim}, {tc.heads} / "
          f"{tc.kv_heads} heads of {tc.head_dim}, vocab {tc.vocab}), seeded random under the "
          f"checkpoint's tensor names, mapped and LM int8 in {vm.load_s:.2f} s; frame "
          f"{tuple(vm.frame.shape)} uint8, prompt {vm.t} tokens ({vm.n_image} image tokens, "
          f"next M-RoPE / rope position {vm.delta})", flush=True)
    paths = _Paths(torch, DB, LO, IM, qwen2, L, serve_prompts, vm.params, tc)

    def rms(a):
        return float(a.float().pow(2).mean().sqrt())

    pixels = vm.pixels()
    feats = vm.tower(pixels)
    ref = paths.run(lambda: vm.tower(vm.pixels()), "f32").float()
    rel = rms(feats - ref) / rms(ref)
    vit_ms = _time_ms(torch, lambda: vm.tower(vm.pixels()), 5)
    tower_ms = _time_ms(torch, lambda: vm.tower(pixels), 5)
    print(f"hf vlm {name}: vision tower {tuple(pixels.shape)} -> {tuple(feats.shape)} "
          f"{feats.dtype}: vs its f32 run rel rms {rel:.4e} (bound {VIT_REL_RMS}); ViT "
          f"{vit_ms:.3f} ms per frame with preprocessing, {tower_ms:.3f} ms the tower alone",
          flush=True)
    if tuple(feats.shape) != (vm.n_image, tc.dim) or not bool(torch.isfinite(feats).all()):
        raise Failed(f"hf vlm {name}: the tower gave {tuple(feats.shape)}, not {vm.n_image} "
                     f"finite rows of {tc.dim}")
    if not rel <= VIT_REL_RMS:
        raise Failed(f"hf vlm {name}: the tower's bf16 output is {rel:.3e} (rel rms) from its "
                     f"f32 run")

    owner, fname = vm.fused_owner, vm.fused_name
    real_fused, real_prefill = getattr(owner, fname), vm.mod._prefill
    calls: list = []  # every fused pass's arguments, the caches' slot left empty
    ttft: list = []
    t_call = [0.0]

    def recorded(*a):
        calls.append((*a[:2], a[2].clone(), None, *a[4:]))
        return real_fused(*a)

    def timed_prefill(*a, **k):
        out = real_prefill(*a, **k)
        torch.cuda.synchronize()
        ttft.append(time.perf_counter() - t_call[0])
        return out

    def run(what, spec):
        plain_calls = _PlainCalls(DB, LO)
        _reset_launches(DB, LO)
        calls.clear()
        torch.cuda.synchronize()
        t_call[0] = time.perf_counter()
        setattr(owner, fname, recorded)
        vm.mod._prefill = timed_prefill
        try:
            tokens = vm.step[spec](vm.params, vm.frame)
            torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t_call[0]
            setattr(owner, fname, real_fused)
            vm.mod._prefill = real_prefill
            launches = _launches(DB, LO)
            plain_calls.restore()
        got = {n: c for n, c in launches.items() if c}
        print(f"hf vlm {name} {what}: launches {json.dumps(got)}; plain calls "
              f"{plain_calls.n}", flush=True)
        if plain_calls.n:
            raise Failed(f"{plain_calls.n} plain-version call(s) ran in hf vlm {name} {what}")
        n = len(calls)
        attn = "attention_chunk_step" if spec else "attention_step"
        want = {"int8_matmul": 1, attn: tc.layers * n, "mlp_step": tc.layers * n,
                "lm_head_argmax": n}
        if got != want or not n:
            raise Failed(f"hf vlm {name} {what} launched {got}, expected {want} for {n} passes")
        tokens = tokens[0].tolist()
        _check_streams({what: tokens}, max_new, tc.vocab)
        return tokens, wall, launches, list(calls)

    # The first call pays for its shapes' first products and allocations:
    # its TTFT is printed apart, and the runs below are warm.
    torch.cuda.synchronize()
    t_call[0] = time.perf_counter()
    vm.mod._prefill = timed_prefill
    try:
        vm.step[False](vm.params, vm.frame)
        torch.cuda.synchronize()
    finally:
        vm.mod._prefill = real_prefill
    cold = time.perf_counter() - t_call[0]
    cold_ttft = ttft.pop()
    gen, wall, launches, gen_calls = run("greedy", False)
    spec, s_wall, _, spec_calls = run("speculative", True)
    steps = max_new - 1
    print(f"hf vlm {name}: TTFT {ttft[0]:.3f} s (preprocessing, ViT and the {vm.t}-row "
          f"prefill; the first call's {cold_ttft:.3f} s, its {max_new} tokens in {cold:.3f} s); "
          f"greedy {max_new} tokens in {wall:.3f} s, decode "
          f"{steps / (wall - ttft[0]):.1f} tokens/s ({1e3 * (wall - ttft[0]) / steps:.2f} ms a "
          f"token); speculative {max_new} tokens in {s_wall:.3f} s, TTFT {ttft[1]:.3f} s, "
          f"{len(spec_calls)} verify passes ({steps / len(spec_calls):.3f} tokens a pass, "
          f"overshoot included), decode {steps / (s_wall - ttft[1]):.1f} tokens/s", flush=True)

    # Where a decode token's time goes: the greedy run's middle pass,
    # replayed at its row, on the device (torch.profiler), on the host (the
    # time to issue it) and back to back; the tower's device time beside it.
    _, caches = vm.prefill()
    mid = gen_calls[len(gen_calls) // 2]

    def one_step():
        real_fused(*mid[:3], caches, *mid[4:])

    def device_ms(fn):
        kern = _device_kernels(torch, fn, 3)
        if not kern:
            return "not measured (the profiler saw no kernel)"
        return f"{sum(us for _, us in kern) / 3e3:.3f} ms in {len(kern) // 3} kernels"

    print(f"hf vlm {name}: a decode step at row {mid[4]}: device {device_ms(one_step)}; "
          f"host {_host_ms(torch, one_step, 10):.3f} ms to issue it; "
          f"{_time_ms(torch, one_step, 10):.3f} ms a step back to back; the tower: device "
          f"{device_ms(lambda: vm.tower(pixels))} of its {tower_ms:.3f} ms", flush=True)
    del caches

    def replay(recorded_calls, at):
        """``mode -> logits`` of generated token ``at`` on its run's path:
        the prefill, then the recorded passes up to the one that gave it."""
        upto = [c for c in recorded_calls if c[4] - vm.t + 1 <= at]
        row = at - (upto[-1][4] - vm.t + 1) if upto else -1

        def go():
            _, caches = vm.prefill()
            for c in upto:
                _, caches = real_fused(*c[:3], caches, *c[4:])
        return lambda mode: paths.logits_of(go, mode)[row]

    ref_tokens = paths.run(lambda: vm.step[False](vm.params, vm.frame), "f32")[0].tolist()
    # greedy against the f32 plain path (its token within NEAR_TIE), then
    # speculative against greedy (the verify path's within SPEC_REF_TIE)
    for label, stream, other, recorded_calls, bound in (
            ("greedy vs the f32 plain path", gen, ref_tokens, gen_calls, NEAR_TIE),
            ("speculative vs greedy", spec, gen, spec_calls, SPEC_REF_TIE)):
        same = _first_parting(stream, other, max_new)
        at = min(same, max_new - 1)
        print(f"hf vlm {name} agreement, {label}: first {same} of {max_new} tokens equal",
              flush=True)
        paths.check(f"hf vlm {name} agreement, {label}, token {at}", replay(recorded_calls, at),
                    (other[same], stream[same]) if same < max_new else None, bound)
    return launches


# ---------------------------------------------------------------------------
# int4 weights: phase 3's int4 forms and phase 12
# ---------------------------------------------------------------------------

#: phase 12's spec-on, dense and batch-1 runs: new tokens a stream
INT4_SHORT_NEW = 32
#: the int4 forms of phase 12's main path (spec off, prefix cache on)
INT4_MAIN_KERNELS = tuple(f"{n}_int4" for n in SPEC_OFF_KERNELS)


def int4_params(torch, qwen2, cfg, seed: int):
    """Phase 3's and phase 12's model: the seeded random weights of phase 4,
    quantized by ``quantize_decode`` under ``DORA_WEIGHT_BITS=4``."""
    with _env(DORA_WEIGHT_BITS="4", DORA_INT4_DECODE=None, DORA_INT8_PURE=None):
        params = qwen2.quantize_decode(
            qwen2.random_params(cfg, seed=seed, std=0.02, device="cuda"), cfg)
    torch.cuda.synchronize()
    return params


def _deq(torch, w):
    """An int4 weight dict dequantized to bf16 [K, N]: the yardstick's
    operand."""
    from dora_tpu_torch.ops.int4 import dequantize_int4

    return dequantize_int4(w, torch.bfloat16)


def _int4_bytes(w) -> int:
    """An int4 weight's bytes: the packed nibbles and the f32 group scales."""
    return w["int4"].numel() + w["gscale"].numel() * 4


def _device_pair(torch, a, b):
    """The summed device ms of the kernels one call of ``a`` and one of ``b``
    launch, two forms of one kernel that launch as many kernels a call. The
    profiler now and then drops a kernel's records: a form that shows fewer
    launches than the other, or none, is not measured (None)."""
    seen = [_device_launches(torch, f) for f in (a, b)]
    n = max(len(x or ()) for x in seen)
    return tuple(sum(ms for _, ms in x) if x and len(x) == n else None for x in seen)


def _dev(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def check_int4_kernels(torch, DB, params, params8, cfg, rng_seed: int) -> list[dict]:
    """Phase 3, int4 weights: the int4 form of kernels 1-5 and 8-10 against
    their plain versions on Qwen2-1.5B's layer 0 quantized to int4 (groups of
    128), at the main paths' shapes: ``mlp_step`` and ``lm_head_argmax`` at
    16 rows (and 1, 80 and 256 printed), kernel 3 on 16 streams at 30..940
    (one frozen), kernel 4 on a 256-row chunk at 512, kernel 5 on 16 x 5
    rows at 14..990, kernel 8 on 4 planes at 0, 700, 1500 and 2047, kernel 9
    at 1500 and kernel 10 on 5 rows ending on 2047, all fp KV. Each line:
    rel within REL_TOL["<name>_int4"] (the head's tokens equal but at
    near-ties), the device time, the plain version's, the yardstick (cuBLAS
    on the dequantized bf16 weights: the two products of the MLP, the head's
    product and argmax; for an attention sublayer the chain of RMSNorm, the
    qkv product, SDPA over the same context and the wo product) and the
    bound at the int4 weight bytes; at the entry shapes also the summed
    device time of its launches (``torch.profiler``) beside the int8 form's
    on ``params8``'s weights and the same inputs."""
    from dora_tpu_torch.models.layers import rope_table

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    blk = params["blocks"]["0"]
    d, hd, h, kv, f = cfg.dim, cfg.head_dim, cfg.heads, cfg.kv_heads, cfg.ffn
    n_qkv = (h + 2 * kv) * hd
    seq, page, slots, chunk, m = cfg.max_seq, 16, 16, 256, SPEC_K + 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []

    def rows(n):
        tok = torch.randint(0, cfg.vocab, (n,), generator=gen, device=dev)
        return params["embed"][tok].to(torch.bfloat16)

    def agree(name, rel, what=""):
        tol = REL_TOL[name]
        print(f"kernel {name}{what}: rel {rel:.3e} (tol {tol})", flush=True)
        if not rel <= tol:
            raise Failed(f"{name}{what} disagrees with its plain version: rel {rel:.3e}")

    def record(name, source, replaces, err, rel, kernel, plain, lib, nbytes, ops, what="",
               int8=None):
        bound, by = _bound_ms(nbytes, ops)
        ms, plain_ms, lib_ms = (_time_ms(torch, kernel), _time_ms(torch, plain, 5),
                                _time_ms(torch, lib))
        print(f"kernel {name}{what}: max_abs_err {err:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} bound_ms {bound:.4f} ({by})", flush=True)
        if int8 is not None:
            d4, d8 = _device_pair(torch, kernel, int8)
            print(f"kernel {name}{what}: device ms int4 {_dev(d4)}, int8 {_dev(d8)} on the same "
                  f"inputs (torch.profiler, a call's launches summed)", flush=True)
        agree(name, rel, what)
        if not what:
            out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})

    blk8 = params8["blocks"]["0"]
    wgu, wd, wh = blk["w_gateup"], blk["w_down"], params["lm_head"]
    ffn8 = (blk8["w_gateup"]["int8"], blk8["w_gateup"]["scale"], blk.get("b_gateup"),
            blk8["w_down"]["int8"], blk8["w_down"]["scale"])
    head8 = (params8["lm_head"]["int8"], params8["lm_head"]["scale"])
    wgu_bf, wd_bf, wh_bf = _deq(torch, wgu), _deq(torch, wd), _deq(torch, wh)
    for n in (slots, 1, slots * m, chunk):  # the entry first
        x = rows(n)
        args = (x, blk["ffn_norm"], wgu["int4"], wgu["gscale"], blk.get("b_gateup"),
                wd["int4"], wd["gscale"])
        err, rel = _rel(DB.mlp_step(*args), DB.mlp_step_plain(*args))
        record("mlp_step_int4", "dora_tpu_torch/csrc/mlp.cu",
               "dora_tpu/ops/decode_block.py:2130", err, rel, lambda: DB.mlp_step(*args),
               lambda: DB.mlp_step_plain(*args),
               lambda: torch.matmul(torch.matmul(x, wgu_bf)[:, :f], wd_bf),
               n * d * 2 * 2 + d * 4 + _int4_bytes(wgu) + _int4_bytes(wd),
               2 * n * d * 2 * f + 2 * n * f * d, "" if n == slots else f" at {n} rows",
               (lambda: DB.mlp_step(x, blk["ffn_norm"], *ffn8)) if n in (slots, chunk) else None)
    for n in (slots, 1, chunk):
        x = rows(n)
        args = (x, params["out_norm"], wh["int4"], wh["gscale"])
        hn = DB._rms(x, params["out_norm"], cfg.norm_eps).to(torch.bfloat16)
        logits = DB._wdot(hn, wh["int4"], wh["gscale"])
        top2 = logits.topk(2, dim=-1).values
        want_i, want_v = DB.lm_head_argmax_plain(*args, return_val=True)
        got_i, got_v = DB.lm_head_argmax(*args, return_val=True)
        if bool(((got_i != want_i) & (top2[:, 0] - top2[:, 1] >= HEAD_TIE)).any()):
            raise Failed(f"lm_head_argmax_int4 picks other tokens than its plain version away "
                         f"from ties at {n} rows")
        err, rel = _rel(got_v, want_v)
        record("lm_head_argmax_int4", "dora_tpu_torch/csrc/lm_head.cu",
               "dora_tpu/ops/decode_block.py:2228", err, rel, lambda: DB.lm_head_argmax(*args),
               lambda: DB.lm_head_argmax_plain(*args),
               lambda: torch.matmul(hn, wh_bf).argmax(dim=-1),
               n * d * 2 + d * 4 + _int4_bytes(wh) + n * 4, 2 * n * d * cfg.vocab,
               "" if n == slots else f" at {n} rows",
               (lambda: DB.lm_head_argmax(x, params["out_norm"], *head8))
               if n in (slots, chunk) else None)
    del wgu_bf, wd_bf, wh_bf

    cos_t, sin_t = rope_table(seq, hd, base=cfg.rope_theta, device=dev)
    wqkv, wo, bqkv = blk["wqkv"], blk["wo"], blk.get("bqkv")
    wqkv_bf, wo_bf = _deq(torch, wqkv), _deq(torch, wo)
    w4 = (wqkv["int4"], wqkv["gscale"], bqkv)
    o4 = (wo["int4"], wo["gscale"])
    w8 = (blk8["wqkv"]["int8"], blk8["wqkv"]["scale"], bqkv)
    o8 = (blk8["wo"]["int8"], blk8["wo"]["scale"])
    kw = dict(heads=h, kv_heads=kv, head_dim=hd, eps=cfg.norm_eps)
    weight_bytes = _int4_bytes(wqkv) + _int4_bytes(wo) + d * 4 + n_qkv * 4 + d * 4
    kv_row = kv * hd * 2 * 2  # one row of K and V in bf16

    def chain(x, kctx, vctx, mask):
        """RMSNorm, cuBLAS qkv on the dequantized weights, SDPA over the
        context [rows, H, keys, hd] (q seeded), cuBLAS wo."""
        q = torch.randn((kctx.shape[0], h, mask.shape[-2], hd), generator=gen,
                        device=dev).bfloat16()

        def run():
            hn = DB._rms(x, blk["attn_norm"], cfg.norm_eps).to(torch.bfloat16)
            torch.matmul(hn, wqkv_bf)
            a = sdpa(q, kctx, vctx, attn_mask=mask)
            return torch.matmul(a.transpose(1, 2).reshape(x.shape[0], h * hd), wo_bf)
        return run

    def sublayer(name, replaces, kernel, plain, pre, pools, post, kwx, lib, n, ctx_rows,
                 index_bytes, attended):
        """Kernel against plain on clones of the pools or caches."""
        p1 = [t.clone() for t in pools]
        p2 = [t.clone() for t in pools]
        want = plain(*pre, *p1, *post, **kwx)[0]
        got = kernel(*pre, *p2, *post, **kwx)[0]
        if not bool(torch.isfinite(got.float()).all()):
            raise Failed(f"{name}: the output is not finite")
        err, rel = _rel(got, want)
        # a paged pool's page 0 is left out: frozen rows race to write it
        skip = 1 if "paged" in name else 0
        _, rel_k = _rel(p2[0][skip:], p1[0][skip:])
        _, rel_v = _rel(p2[1][skip:], p1[1][skip:])
        agree("pools", max(rel_k, rel_v), f" written by {name}")
        nbytes = (n * d * 2 * 2 + weight_bytes + n * hd * 8 + index_bytes
                  + ctx_rows * kv_row + n * kv_row)
        ops = 2 * n * d * n_qkv + 2 * 2 * h * hd * attended + 2 * n * h * hd * d
        # the int8 form: the same rows, pools and indices on params8's weights
        pre8 = (pre[0], pre[1], *w8, *pre[5:])
        post8 = (*o8, *post[2:])
        record(name, "dora_tpu_torch/csrc/paged_attention.cu", replaces, err, rel,
               lambda: kernel(*pre, *p2, *post, **kwx), lambda: plain(*pre, *p1, *post, **kwx),
               lib, nbytes, ops, int8=lambda: kernel(*pre8, *p2, *post8, **kwx))

    def ctx_of(pool, table):
        """A pool's pages through ``table`` rows as [rows, H, keys, hd]."""
        c = pool[table.long()].permute(0, 2, 1, 3, 4)
        c = c.reshape(table.shape[0], kv, table.shape[1] * page, hd)
        return c.repeat_interleave(h // kv, dim=1)

    n_pool = 4 * seq // page
    kp = torch.randn((n_pool, kv, page, hd), generator=gen, device=dev).bfloat16()
    vp = torch.randn((n_pool, kv, page, hd), generator=gen, device=dev).bfloat16()
    maxp = seq // page

    def tables(positions, extra):
        bt = torch.zeros((len(positions), maxp), dtype=torch.int32)
        nxt = 1
        for b, p in enumerate(positions):
            if p:
                n = -(-(p + extra) // page)
                bt[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
                nxt += n
        if nxt > n_pool:
            raise Failed("int4 kernel check positions overflow the pool")
        return bt.to(dev)

    # kernel 3: 16 streams, one frozen
    positions = [int(p) for p in torch.linspace(30, 940, slots).round().tolist()]
    positions[3] = 0
    bt = tables(positions, 1)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    x = rows(slots)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, pos)
    mask = (torch.arange(maxp * page, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    sublayer("attention_paged_batch_step_int4", "dora_tpu/ops/decode_block.py:1163",
             DB.attention_paged_batch_step, DB.attention_paged_batch_step_plain,
             (x, blk["attn_norm"], *w4, cr, sr), (kp, vp), (*o4, pos, bt), kw,
             chain(x, ctx_of(kp, bt), ctx_of(vp, bt), mask), slots, sum(positions),
             slots * 4 + bt.numel() * 4, sum(positions) + slots)

    # kernel 4: the third 256-row chunk of a prompt
    position = 2 * chunk
    btr = torch.arange(1, maxp + 1, dtype=torch.int32, device=dev)
    x = rows(chunk)
    cr, sr = DB.rope_rows(cos_t, sin_t, position, chunk)
    n_keys = position + chunk
    cmask = (torch.arange(n_keys, device=dev)[None, :]
             <= position + torch.arange(chunk, device=dev)[:, None])
    sublayer("attention_paged_chunk_step_int4", "dora_tpu/ops/decode_block.py:1505",
             DB.attention_paged_chunk_step, DB.attention_paged_chunk_step_plain,
             (x, blk["attn_norm"], *w4, cr, sr), (kp, vp), (*o4, position, btr), kw,
             chain(x, ctx_of(kp, btr[None, : n_keys // page]),
                   ctx_of(vp, btr[None, : n_keys // page]), cmask),
             chunk, position, btr.numel() * 4, chunk * position + chunk * (chunk + 1) // 2)

    # kernel 5: 16 streams x 5 candidate rows, one frozen
    positions = [int(p) for p in torch.linspace(14, 990, slots).round().tolist()]
    positions[3] = 0
    bt = tables(positions, m)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    flat = (pos[:, None] + torch.arange(m, dtype=torch.int32, device=dev)[None, :]).reshape(-1)
    x = rows(slots * m)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, flat)
    smask = (torch.arange(maxp * page, device=dev)[None, None, :]
             <= flat.reshape(slots, m)[:, :, None])[:, None]
    sublayer("attention_paged_spec_step_int4", "dora_tpu/ops/decode_block.py:1927",
             DB.attention_paged_spec_step, DB.attention_paged_spec_step_plain,
             (x, blk["attn_norm"], *w4, cr, sr), (kp, vp), (*o4, pos, bt), dict(kw, m=m),
             chain(x, ctx_of(kp, bt), ctx_of(vp, bt), smask), slots * m, sum(positions),
             slots * 4 + bt.numel() * 4, m * sum(positions) + slots * m * (m + 1) // 2)

    # kernels 8-10 over dense bf16 caches
    def caches(planes):
        return (torch.randn((planes, kv, seq, hd), generator=gen, device=dev).bfloat16(),
                torch.randn((planes, kv, seq, hd), generator=gen, device=dev).bfloat16())

    def full(c):
        return c.repeat_interleave(h // kv, dim=1)

    positions = [0, 700, 1500, seq - 1]
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    kc, vc = caches(len(positions))
    x = rows(len(positions))
    cr, sr = DB.rope_rows_at(cos_t, sin_t, pos)
    mask = (torch.arange(seq, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    sublayer("attention_batch_step_int4", "dora_tpu/ops/decode_block.py:824",
             DB.attention_batch_step, DB.attention_batch_step_plain,
             (x, blk["attn_norm"], *w4, cr, sr), (kc, vc), (*o4, pos), kw,
             chain(x, full(kc), full(vc), mask), len(positions), sum(positions),
             len(positions) * 4, sum(positions) + len(positions))
    position = 1500
    kc, vc = caches(1)
    x = rows(1)
    cr, sr = DB.rope_rows(cos_t, sin_t, position)
    mask = (torch.arange(seq, device=dev) <= position)[None, None, None, :]
    sublayer("attention_step_int4", "dora_tpu/ops/decode_block.py:309",
             DB.attention_step, DB.attention_step_plain, (x, blk["attn_norm"], *w4, cr, sr),
             (kc[0], vc[0]), (*o4, position), kw, chain(x, full(kc), full(vc), mask), 1,
             position, 0, position + 1)
    position = seq - m
    kc, vc = caches(1)
    x = rows(m)
    cr, sr = DB.rope_rows(cos_t, sin_t, position, m)
    mask = (torch.arange(seq, device=dev)[None, :]
            <= position + torch.arange(m, device=dev)[:, None])
    sublayer("attention_chunk_step_int4", "dora_tpu/ops/decode_block.py:574",
             DB.attention_chunk_step, DB.attention_chunk_step_plain,
             (x, blk["attn_norm"], *w4, cr, sr), (kc[0], vc[0]), (*o4, position), kw,
             chain(x, full(kc), full(vc), mask), m, position, 0,
             m * position + m * (m + 1) // 2)
    return out


def check_tc_tile4(torch, DB, rng_seed: int) -> None:
    """Phase 3: the fragment path of the int4 product (one ldmatrix.trans of
    a 32-row group's packed bytes, both nibbles widened to bf16 q, two k
    steps of the even / odd mma) on a 16 x 32 bf16 tile by every byte value,
    against torch.matmul on the unpacked q in f32 (exact: 1e-5)."""
    gen = torch.Generator(device="cuda").manual_seed(rng_seed)
    a = (torch.randn((16, 32), generator=gen, device="cuda") * 4).bfloat16()
    w = torch.randint(0, 256, (16, 16), generator=gen, device="cuda").to(torch.uint8)
    q = torch.cat([(w & 15).float() - 8, (w >> 4).float() - 8])
    got = DB.tc_tile4(a, w)
    torch.cuda.synchronize()
    _, rel = _rel(got, a.float() @ q)
    print(f"tc tile int4 (nibbles widened, ldmatrix, m16n8k16 bf16): rel {rel:.3e} (tol 1e-5)",
          flush=True)
    if not rel <= 1e-5:
        raise Failed(f"the int4 product's fragment path disagrees with torch.matmul: "
                     f"rel {rel:.3e}")


def _served_run(torch, DB, LO, engine, serve_prompts, prompts, max_new):
    """Serve ``prompts`` on ``engine`` with every kernel's launches counted
    and every plain-version call counted. Returns (streams, TTFTs, wall s,
    launches, plain calls)."""
    plain_calls = _PlainCalls(DB, LO)
    _reset_launches(DB, LO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out, ttft = serve_prompts(engine, prompts, max_new)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        launches = _launches(DB, LO)
        plain_calls.restore()
    return out, ttft, wall, launches, plain_calls.n


def _only(what: str, launches: dict, plain: int, need) -> None:
    """``need`` launched, nothing else did and no plain version ran."""
    print(f"{what} launches: {json.dumps({n: c for n, c in launches.items() if c})}; plain "
          f"calls {plain}", flush=True)
    if plain:
        raise Failed(f"{plain} plain-version call(s) ran in {what}")
    stray = [n for n, c in launches.items() if c and n not in need]
    if stray or not all(launches[n] > 0 for n in need):
        raise Failed(f"{what}: {list(need)} must launch and nothing else; launched {launches}")


def serve_int4(torch, DB, LO, make_engine, serve_prompts, params, cfg, prompts, max_new,
               seed: int, int8_times: dict):
    """Phase 12, the main path on int4 weights: ``make_engine`` from the
    front door (16 slots, page 16, chunk 256, K = 8, prefix cache on) over
    ``int4_params`` serves phase 4's requests, each window one CUDA-graph
    replay, through the int4 forms of kernels 1-4 alone; its graph line,
    the same requests on a graphs=False engine (token for token), and the
    ``paths`` lines: graphed against eager, and int4 against phase 4's int8
    run. Returns (streams, launches)."""
    engine = front_door(make_engine, params, cfg)
    if not engine.graphs:
        raise Failed("phase 12's engine runs its windows eagerly")
    times = _timed(torch, engine)
    out, ttft, wall, launches, plain = _served_run(torch, DB, LO, engine, serve_prompts,
                                                   prompts, max_new)
    times = {k: list(v) for k, v in times.items()}  # the served run's alone
    _only("int4 phase", launches, plain, INT4_MAIN_KERNELS)
    _check_streams(out, max_new, cfg.vocab)
    engine.check_invariants()
    n_tok = sum(len(t) for t in out.values())
    ttfts = sorted(ttft.values())
    print(f"int4 phase: {len(prompts)} requests of {len(prompts[0])}..{len(prompts[-1])} "
          f"tokens, {n_tok} tokens in {wall:.3f} s; decode "
          f"{(n_tok - len(prompts)) / sum(times['window']):.1f} tokens/s over "
          f"{len(times['window'])} windows; TTFT p50 {ttfts[len(ttfts) // 2]:.3f} s max "
          f"{ttfts[-1]:.3f} s", flush=True)
    graph_check(engine, serve_prompts, cfg.vocab, seed, "int4 phase")
    ref = front_door(make_engine, params, cfg, graphs=False)
    ref_times = _timed(torch, ref)
    ref_out, ref_ttft = serve_prompts(ref, prompts, max_new)
    _same_streams("int4 phase", out, ref_out, max_new)
    path_line("int4 phase (phase 12, K = 8, spec off)", times, ref_times, ttft.values(),
              ref_ttft.values())
    print(f"paths int4 against int8, graphed (phase 12 against phase 4, the same requests): "
          f"window ms int4 {_ms(times['window'])}, int8 {_ms(int8_times['window'])}; prefill "
          f"chunk ms int4 {_ms(times['chunk'])}, int8 {_ms(int8_times['chunk'])}", flush=True)
    return out, launches


def serve_int4_others(torch, DB, LO, qwen2, spec_decode, L, make_engine, serve_prompts, paths,
                      params, cfg, prompts, d_prompts, seed: int, dense_times: dict) -> dict:
    """Phase 12 at INT4_SHORT_NEW new tokens: speculation (``DORA_SPEC_K=4``,
    kernel 5's int4 form on every tick; two requests held to the spec-off
    engine as phase 7 holds them), the dense engine (``DORA_PAGED_KV=0``,
    kernel 8's; graphed against eager, its graph line, step ms against
    phase 9's int8 steps) and batch 1 (phase 10 on int4: ``generate``
    through kernel 9's, ``run_loop`` through kernel 10's). Returns each int4
    form's launches."""
    n = INT4_SHORT_NEW
    spec = front_door(make_engine, params, cfg, DORA_SPEC_K=str(SPEC_K))
    out, _, wall, launches, plain = _served_run(torch, DB, LO, spec, serve_prompts, prompts, n)
    _only("int4 spec phase", launches, plain,
          ("attention_paged_chunk_step_int4", "attention_paged_spec_step_int4",
           "mlp_step_int4", "lm_head_argmax_int4"))
    _check_streams(out, n, cfg.vocab)
    print(f"int4 spec phase: {sum(len(t) for t in out.values())} tokens in {wall:.3f} s",
          flush=True)
    check_spec_agreement(paths, prompts, n, out, picks=(1, 15))
    got = dict(launches)

    dense = front_door(make_engine, params, cfg, DORA_PAGED_KV="0")
    times = _timed(torch, dense)
    d_out, _, wall, launches, plain = _served_run(torch, DB, LO, dense, serve_prompts,
                                                  d_prompts, n)
    times = {k: list(v) for k, v in times.items()}
    # prompts of <= 32 tokens prefill through the dequantized products
    # (layers.matmul), as the JAX package's XLA does: no int8_matmul
    _only("int4 dense phase", launches, plain,
          ("attention_batch_step_int4", "mlp_step_int4", "lm_head_argmax_int4"))
    _check_streams(d_out, n, cfg.vocab)
    got["attention_batch_step_int4"] = launches["attention_batch_step_int4"]
    graph_check(dense, serve_prompts, cfg.vocab, seed, "int4 dense phase")
    ref = front_door(make_engine, params, cfg, graphs=False, DORA_PAGED_KV="0")
    ref_times = _timed(torch, ref)
    ref_out, _ = serve_prompts(ref, d_prompts, n)
    _same_streams("int4 dense phase", d_out, ref_out, n)
    print(f"paths int4 against int8, dense step ms graphed (phase 12 against phase 9): int4 "
          f"{_ms(times['window'])} (eager {_ms(ref_times['window'])}), int8 "
          f"{_ms(dense_times['window'])}; int4 dense decode "
          f"{(sum(len(t) for t in d_out.values()) - len(d_prompts)) / sum(times['window']):.1f} "
          f"tokens/s", flush=True)

    g_launches, s_launches = batch1(torch, DB, LO, qwen2, spec_decode, L, paths, params, cfg,
                                    d_prompts, n, d_out, form="_int4")
    got["attention_step_int4"] = g_launches["attention_step_int4"]
    got["attention_chunk_step_int4"] = s_launches["attention_chunk_step_int4"]
    return got

# ---------------------------------------------------------------------------
# phase 13: the serving node, serve() over a scripted node
# ---------------------------------------------------------------------------

#: phase 13 (b) and (c): new tokens a request
QOS_MAX_NEW = 32
#: phase 13 (c): the batch class's depth bound and the requests sent at once
SHED_DEPTH = 2
SHED_REQUESTS = 24
SHED_MAX_NEW = 8


class _ScriptNode:
    """Phase 13's node: INPUT events in order, each held back until its gate
    (a predicate over this node) opens; every ``send_output`` captured with
    its host time; the reports kept. The serving loop sees what a dataflow
    node gives it, without a daemon."""

    def __init__(self, events):
        self._events = list(events)
        self.stream_ended = False
        self.sent: list[tuple[float, str, dict]] = []
        self.arrived: dict[str, float] = {}
        self.snapshots: list[dict] = []
        self.digests: list = []
        self.closed = False

    def recv(self, timeout=None):
        if self._events:
            gate, event = self._events[0]
            if gate is None or gate(self):
                self._events.pop(0)
                if event["type"] == "INPUT":
                    self.arrived[event["metadata"]["request_id"]] = time.perf_counter()
                return event
            return None
        self.stream_ended = True
        return None

    def send_output(self, output_id, value, metadata=None):
        if output_id != "response":
            raise Failed(f"serve() sent on {output_id!r}")
        self.sent.append((time.perf_counter(), value[0], dict(metadata or {})))

    def report_serving(self, snapshot):
        self.snapshots.append(snapshot)

    def report_engine_state(self, digest):
        self.digests.append(digest)

    def report_profile(self, artifact, error=None):
        pass

    def close(self):
        self.closed = True

    def streams(self) -> dict:
        """request id -> (tokens, seqs, final metadata, first-chunk time)."""
        out: dict = {}
        for t, text, meta in self.sent:
            rid = meta["request_id"]
            toks, seqs, _final, t0 = out.get(rid, ([], [], None, t))
            if text:
                toks.append(int(text))
            seqs.append(meta["seq"])
            out[rid] = (toks, seqs, meta if meta["done"] else None, t0)
        return out


def _request(rid: str, ids, max_new: int, qos: str | None = None) -> dict:
    meta = {"request_id": rid, "max_new_tokens": max_new}
    if qos:
        meta["qos_class"] = qos
    return {"type": "INPUT", "metadata": meta, "value": " ".join(map(str, ids)).encode()}


def _serve_script(torch, DB, LO, engine, events, max_new: int, node=None):
    """serve() over ``node`` (default a _ScriptNode of ``events``) on
    ``engine``, every launch counter zeroed just before and read just after,
    the plain versions counted; a _KillNode's kill ends the run as a kill -9
    would. Returns (node, metrics, launches, wall seconds)."""
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.nodehub.llm_server import serve

    node = node if node is not None else _ScriptNode(events)
    metrics = ServingMetrics(engine="paged")
    plain_calls = _PlainCalls(DB, LO)
    _reset_launches(DB, LO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        try:
            serve(node, engine, metrics, encode=lambda text: [int(t) for t in text.split()],
                  decode_one=lambda tok: f" {tok}", max_new_cap=max_new)
        except _Killed:
            pass
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        launches = _launches(DB, LO)
        plain_calls.restore()
    if not node.closed:
        raise Failed("serve() left its node open")
    if plain_calls.n:
        raise Failed(f"{plain_calls.n} plain-version call(s) ran under serve()")
    return node, metrics, launches, wall


def _check_chunks(what: str, node: _ScriptNode, rids, finish: dict) -> dict:
    """Every request of ``rids`` ends in exactly one done chunk, its seqs run
    0, 1, ... without a gap, and its finish is ``finish[rid]`` (a set);
    returns node.streams()."""
    streams = node.streams()
    if set(streams) != set(rids):
        raise Failed(f"{what}: chunks for {sorted(streams)} but requests {sorted(rids)}")
    for rid in rids:
        toks, seqs, final, _t = streams[rid]
        dones = sum(1 for _t, _x, m in node.sent if m["request_id"] == rid and m["done"])
        if dones != 1 or final is None:
            raise Failed(f"{what}: request {rid} ended in {dones} done chunks")
        if seqs != list(range(len(seqs))):
            raise Failed(f"{what}: request {rid}'s seqs have a gap: {seqs[:8]}...")
        if final["finish"] not in finish[rid]:
            raise Failed(f"{what}: request {rid} finished {final['finish']!r}")
    return streams


def _hold_to_phase4(what: str, paths, prompt, got, want, n: int) -> int:
    """A phase-13 stream against phase 4's for the same prompt over its
    first n tokens: equal, or parting where the served token is within
    NEAR_TIE of the f32 plain path's top and phase 4's within SPEC_REF_TIE
    (two bf16 kernel paths). Returns the first parting (n if none)."""
    t = _first_parting(got, want, n)
    if t < n:
        print(f"{what}: parts from phase 4's stream at token {t} ({got[t]} against "
              f"{want[t]})", flush=True)
        paths.check(f"{what}, token {t}", paths.after(prompt + got[:t]), (got[t], want[t]),
                    SPEC_REF_TIE, rms=False)
    return t


def _pct(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


def serve_node(torch, DB, LO, make_engine, serve_prompts, paths, params, cfg, prompts,
               max_new: int, served: dict, seed: int):
    """Phase 13: the port's ``serve()`` on the engine ``make_engine`` builds
    (graphed; 16 slots, page 16, chunk 256, K = 8, 511 pages, prefix cache
    on), driven by a scripted node: (a) phase 4's requests, each stream held
    to phase 4's; (b) preemption under ``DORA_QOS_PREEMPT=1``; (c) shedding
    under ``DORA_QOS_DEPTH_BATCH``. Returns (a)'s launches, the engine and
    (a)'s end-to-end tokens/s."""
    import numpy as np

    from dora_tpu_torch.metrics import percentile_from_counts

    engine = front_door(make_engine, params, cfg, DORA_BATCH_SLOTS="16", DORA_PAGE_SIZE="16",
                        DORA_PREFILL_CHUNK="256", DORA_MULTISTEP_K="8")
    if not engine.graphs or engine.prefix_cache is None or engine.allocator.num_pages != 512:
        raise Failed("phase 13's engine is not make_engine's graphed, cached 512-page engine")

    # (a) phase 4's requests, default class, all at once
    rids = [f"a{i}" for i in range(len(prompts))]
    with _env(DORA_QOS_PREEMPT=None, DORA_QOS_DEPTH_BATCH=None, DORA_FLEET_DIGEST_S="1"):
        node, metrics, launches, wall = _serve_script(
            torch, DB, LO, engine, [(None, _request(r, p, max_new)) for r, p in zip(rids, prompts)],
            max_new)
    print(f"serve (a) launches: {json.dumps(launches)}", flush=True)
    if not all(launches[n] > 0 for n in SPEC_OFF_KERNELS):
        raise Failed(f"serve (a): a kernel of the main path never launched: {launches}")
    if any(launches[n] for n in launches if n not in SPEC_OFF_KERNELS):
        raise Failed(f"serve (a): a kernel off the spec-off fp path launched: {launches}")
    streams = _check_chunks("serve (a)", node, rids, dict.fromkeys(rids, {"length"}))
    parted = 0
    for i, rid in enumerate(rids):
        toks = streams[rid][0]
        if len(toks) != max_new:
            raise Failed(f"serve (a): request {rid} has {len(toks)} of {max_new} tokens")
        parted += _hold_to_phase4(f"serve (a): request {i}", paths, prompts[i], toks, served[i],
                                  max_new) < max_new
    ttft = [streams[r][3] - node.arrived[r] for r in rids]
    gap = metrics.dispatch_gap.counts
    snap = node.snapshots[-1]
    rate_a = metrics.decode_tokens / wall
    EARLIER["serve_a"] = (f"TTFT p50 {_pct(ttft, 50):.4f} s max {max(ttft):.4f} s, "
                          f"{rate_a:.1f} tokens/s")
    print(f"serve (a): {len(rids)} requests, {metrics.decode_tokens} tokens in {wall:.3f} s "
          f"({metrics.decode_tokens / wall:.1f} tokens/s end to end); {len(rids) - parted} "
          f"streams equal phase 4's token for token, {parted} part at near-ties; TTFT p50 "
          f"{_pct(ttft, 50):.4f} s max {max(ttft):.4f} s (metrics: p50 <= "
          f"{percentile_from_counts(metrics.ttft.counts, 50) / 1e6:.4f} s, max bucket <= "
          f"{percentile_from_counts(metrics.ttft.counts, 100) / 1e6:.4f} s); dispatch_gap "
          f"p50 <= {percentile_from_counts(gap, 50)} us p99 <= "
          f"{percentile_from_counts(gap, 99)} us over {metrics.dispatch_gap.count} gaps; "
          f"{snap['host_dispatches']} dispatches, {snap['prefill_chunks']} prefill chunks, "
          f"tokens per dispatch {snap['tokens_per_dispatch']}, compiles (graph captures) "
          f"{snap['compiles']}; {len(node.snapshots)} metrics reports, {len(node.digests)} "
          f"fleet digests", flush=True)
    if snap["compiles"] != 1:
        raise Failed(f"serve (a): {snap['compiles']} graph captures, want the K = 8 window's one")
    graph_check(engine, serve_prompts, cfg.vocab, seed, "serve")
    warm = engine.graph_captures

    # (b) preemption: the shorter half of phase 4's prompts as batch
    # requests; once the last of them decodes (every batch stream admitted,
    # so the youngest, the first victim, holds emitted tokens), the longer
    # half as interactive ones, whose grants the pool cannot cover. The
    # schedule depends only on the chunks sent, so it is the same on every
    # card (the stub engine at these shapes preempts the last two batch
    # streams after 9 and 25 tokens).
    engine.prefix_cache.flush()
    qos_new = min(QOS_MAX_NEW, max_new)
    half = len(prompts) // 2
    brids = [f"b{i}" for i in range(half)]
    irids = [f"i{i}" for i in range(half, len(prompts))]

    def released(node):
        return any(m["request_id"] == brids[-1] for _t, _x, m in node.sent)

    events = [(None, _request(r, prompts[i], qos_new, "batch")) for i, r in enumerate(brids)]
    events += [(released if j == 0 else None,
                _request(r, prompts[half + j], qos_new, "interactive"))
               for j, r in enumerate(irids)]
    victims: list[tuple[str, int]] = []
    inner_preempt = engine.preempt

    def preempt(key):
        meta = inner_preempt(key)
        if meta is not None:
            victims.append((key, meta["emitted"]))
        return meta

    engine.preempt = preempt
    try:
        with _env(DORA_QOS_PREEMPT="1", DORA_QOS_DEPTH_BATCH=None):
            node, metrics, b_launches, wall = _serve_script(torch, DB, LO, engine, events,
                                                            qos_new)
    finally:
        engine.preempt = inner_preempt
    print(f"serve (b) launches: {json.dumps(b_launches)}", flush=True)
    if not all(b_launches[n] > 0 for n in SPEC_OFF_KERNELS):
        raise Failed(f"serve (b): a kernel of the main path never launched: {b_launches}")
    streams = _check_chunks("serve (b)", node, brids + irids,
                            dict.fromkeys(brids + irids, {"length"}))
    if not victims or metrics.resumed != metrics.preempted or len(victims) != metrics.preempted:
        raise Failed(f"serve (b): {len(victims)} victims, {metrics.preempted} preempted, "
                     f"{metrics.resumed} resumed")
    # engine keys are req-N in arrival order: req-(i + 1) carries request i
    by_key = {f"req-{i + 1}": rid for i, rid in enumerate(brids + irids)}
    print(f"serve (b): victims (request, tokens emitted when preempted): "
          f"{[(by_key[k], n) for k, n in victims]}", flush=True)
    parted = 0
    for i, rid in enumerate(brids + irids):
        toks = streams[rid][0]
        if len(toks) != qos_new:
            raise Failed(f"serve (b): request {rid} has {len(toks)} of {qos_new} tokens")
        parted += _hold_to_phase4(f"serve (b): request {rid} (prompt {i})", paths, prompts[i],
                                  toks, served[i], qos_new) < qos_new
    t_in = [streams[r][3] - node.arrived[r] for r in irids]
    t_b = [streams[r][3] - node.arrived[r] for r in brids]
    print(f"serve (b): DORA_QOS_PREEMPT=1, {len(brids)} batch and {len(irids)} interactive "
          f"requests of {qos_new} tokens: {metrics.preempted} preempted, "
          f"{metrics.resumed} resumed; interactive TTFT p50 {_pct(t_in, 50):.4f} s max "
          f"{max(t_in):.4f} s against batch p50 {_pct(t_b, 50):.4f} s max {max(t_b):.4f} s; "
          f"{len(prompts) - parted} streams equal phase 4's first {qos_new} tokens, "
          f"{parted} part at near-ties; {wall:.3f} s", flush=True)

    # (c) shedding: a small batch depth bound under a burst
    rng = np.random.default_rng(seed + 1)
    extra = [rng.integers(0, cfg.vocab, size=n).tolist()
             for n in np.linspace(32, 512, SHED_REQUESTS - len(prompts)).round().astype(int)]
    crids = [f"c{i}" for i in range(SHED_REQUESTS)]
    events = [(None, _request(r, p, SHED_MAX_NEW, "batch"))
              for r, p in zip(crids, list(prompts) + extra)]
    with _env(DORA_QOS_PREEMPT=None, DORA_QOS_DEPTH_BATCH=str(SHED_DEPTH)):
        node, metrics, c_launches, wall = _serve_script(torch, DB, LO, engine, events,
                                                        SHED_MAX_NEW)
    streams = _check_chunks("serve (c)", node, crids,
                            dict.fromkeys(crids, {"length", "overloaded"}))
    shed = [r for r in crids if streams[r][2]["finish"] == "overloaded"]
    if not shed or metrics.shed != len(shed):
        raise Failed(f"serve (c): {len(shed)} overloaded chunks, {metrics.shed} shed")
    for r in shed:
        if streams[r][0] or streams[r][2].get("retry_after_ms", 0) < 100:
            raise Failed(f"serve (c): shed request {r} is not a retriable empty chunk")
    for r in set(crids) - set(shed):
        if len(streams[r][0]) != SHED_MAX_NEW:
            raise Failed(f"serve (c): request {r} has {len(streams[r][0])} tokens")
    print(f"serve (c): DORA_QOS_DEPTH_BATCH={SHED_DEPTH}, {SHED_REQUESTS} batch requests at "
          f"once: {len(shed)} shed with a retriable 'overloaded' chunk (retry_after_ms "
          f"{streams[shed[0]][2]['retry_after_ms']}), {SHED_REQUESTS - len(shed)} served in "
          f"full, none lost; launches {json.dumps({n: c_launches[n] for n in SPEC_OFF_KERNELS})}"
          f"; {wall:.3f} s", flush=True)
    engine.check_invariants()
    print(f"graph serve: captures {engine.graph_captures} after (b) and (c), {warm} at warmup",
          flush=True)
    if engine.graph_captures != warm:
        raise Failed(f"serve: {engine.graph_captures - warm} capture(s) after warmup")
    return launches, engine, rate_a


# ---------------------------------------------------------------------------
# phase 14: the serving node's recovery, checkpoint / restore and migration
# ---------------------------------------------------------------------------

#: phase 14 (a): serve() checkpoints every CKPT_EVERY steps and is killed
#: right after its CKPT_KILL_AT-th cadence checkpoint
CKPT_EVERY = 8
CKPT_KILL_AT = 2
#: phase 14 (b): the MIGRATE goes out once this many streams have a token
MIGRATE_AFTER = 4


class _Killed(Exception):
    """A _KillNode's kill: out of ``recv``, as the process would die."""


class _KillNode(_ScriptNode):
    """Phase 14 (a)'s first node: a _ScriptNode whose ``recv`` raises once
    ``killed()`` holds."""

    def __init__(self, events, killed):
        super().__init__(events)
        self._killed = killed

    def recv(self, timeout=None):
        if self._killed():
            raise _Killed("killed after the checkpoint")
        return super().recv(timeout)


class _TargetNode(_ScriptNode):
    """A migration target's node: no inputs of its own, its stream open,
    and STOP once every request of ``expected`` has its done chunk here."""

    def __init__(self, expected):
        super().__init__([])
        self._expected = set(expected)

    def recv(self, timeout=None):
        done = {m["request_id"] for _t, _x, m in self.sent if m["done"]}
        return {"type": "STOP"} if done >= self._expected else None


def _merged(what: str, rids, max_new: int, *nodes) -> dict:
    """request id -> tokens, from the chunks of ``nodes`` deduplicated by
    (request_id, seq), the first kept (the consumers' rule for a replay);
    every request's seqs run 0, 1, ... without a gap to one done chunk with
    finish "length" after its max_new tokens."""
    seen: dict = {}
    for node in nodes:
        for _t, text, meta in node.sent:
            seen.setdefault((meta["request_id"], meta["seq"]), (text, meta))
    out = {}
    for rid in rids:
        chunks = sorted((seq, tm) for (r, seq), tm in seen.items() if r == rid)
        seqs = [seq for seq, _tm in chunks]
        if seqs != list(range(len(seqs))):
            raise Failed(f"{what}: request {rid}'s merged seqs have a gap: {seqs[:8]}...")
        dones = [tm[1] for _seq, tm in chunks if tm[1]["done"]]
        if len(dones) != 1 or not chunks[-1][1][1]["done"] or dones[0]["finish"] != "length":
            raise Failed(f"{what}: request {rid} ends in {len(dones)} done chunks")
        out[rid] = [int(tm[0]) for _seq, tm in chunks if tm[0]]
        if len(out[rid]) != max_new:
            raise Failed(f"{what}: request {rid} has {len(out[rid])} of {max_new} tokens")
    return out


def _pool_sums(torch, pools) -> list[int]:
    """One checksum a layer of KV pools: their bytes, each times its index
    mod 65521 plus 1, summed (a moved or changed byte changes it)."""
    sums = []
    for layer in sorted(pools, key=int):
        total = 0
        for t in pools[layer].values():
            b = t.contiguous().view(torch.uint8).reshape(-1).to(torch.int64)
            total += int((b * (torch.arange(b.numel(), device=b.device) % 65521 + 1)).sum())
        sums.append(total)
    return sums


def _timed_method(engine, name: str, log: list, after=None):
    """Wrap ``engine.<name>`` (an instance attribute over the method) to
    append (seconds, result, after(*args)) to ``log`` at each call; undo
    with ``delattr(engine, name)``."""
    inner = getattr(engine, name)

    def run(*args):
        t = time.perf_counter()
        res = inner(*args)
        log.append((time.perf_counter() - t, res,
                    after(*args) if after is not None else None))
        return res

    setattr(engine, name, run)


def serve_recovery(torch, DB, LO, make_engine, paths, params, cfg, prompts, max_new: int,
                   served: dict, engine, rate_13a: float, smi: str, scratch: str) -> None:
    """Phase 14: the recovery half of ``serve()`` on make_engine's graphed
    engines (16 slots, page 16, chunk 256, K = 8, 512 pages, prefix cache
    on), phase 4's weights and requests.

    (a) Kill and resume: ``DORA_CHECKPOINT_DIR`` (every CKPT_EVERY steps,
    ``DORA_CHECKPOINT_PAGES=1``) on phase 13's engine; its node raises out
    of ``recv`` right after the CKPT_KILL_AT-th cadence checkpoint, whose
    snapshot must hold a decoding, a mid-prefill and a parked stream. A fresh
    engine's ``serve()`` with no new traffic restores it: restored_streams
    equal the snapshot's live streams, the restored pools' per-layer
    checksums the saved ones', the merged chunks phase 4's streams (near-tie
    rule), kernels 1-4 launched, no plain version, one capture (the K = 8
    window's) and no more.

    (b) Drain and migrate: phase 13's engine (drained) serves phase 4's
    requests again and gets a MIGRATE once MIGRATE_AFTER streams have a
    token; the fresh engine, with ``DORA_MIGRATE_DIR`` on the handoff
    directory, finishes every stream. migrated_out = migrated_in = drained +
    parked streams; every stream's merged seqs gapless to its full length;
    the parked and mid-prefill streams equal phase 4's (near-tie rule); the
    decoding ones continue without their KV pages (none are shipped), so
    only how many still agree with phase 4's is printed; no capture on the
    target."""
    import signal

    rids = [f"k{i}" for i in range(len(prompts))]
    env = dict(DORA_QOS_PREEMPT=None, DORA_QOS_DEPTH_BATCH=None, DORA_FLEET_DIGEST_S="0",
               DORA_CHECKPOINT_EVERY=str(CKPT_EVERY), DORA_CHECKPOINT_PAGES="1",
               DORA_MIGRATE_DIR=None)
    prev_term = signal.getsignal(signal.SIGTERM)
    os.makedirs(scratch, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(prefix="recovery-", dir=scratch) as root:
            ckpt = os.path.join(root, "ckpt")
            # (a) the checkpointing run, killed
            engine.prefix_cache.flush()
            warm = engine.graph_captures
            snaps: list = []
            saves: list = []
            _timed_method(engine, "checkpoint_state", snaps)
            _timed_method(engine, "save_pools", saves,
                          after=lambda path: (_pool_sums(torch, engine.pools),
                                              os.path.getsize(path)))
            node = _KillNode([(None, _request(r, p, max_new)) for r, p in zip(rids, prompts)],
                             lambda: len(snaps) >= CKPT_KILL_AT)
            try:
                with _env(DORA_CHECKPOINT_DIR=ckpt, **env):
                    node1, m1, l1, wall1 = _serve_script(torch, DB, LO, engine, [], max_new,
                                                         node=node)
            finally:
                del engine.checkpoint_state, engine.save_pools
            if len(snaps) != CKPT_KILL_AT or len(saves) != CKPT_KILL_AT:
                raise Failed(f"recover (a): {len(snaps)} checkpoints, {len(saves)} pool saves "
                             f"before the kill")
            with open(os.path.join(ckpt, "state.json")) as f:
                state = json.load(f)
            state_bytes = os.path.getsize(os.path.join(ckpt, "state.json"))
            slots = state["engine"]["slots"]
            decoding = [m for m in slots if m["decode"]]
            prefill = [m for m in slots if not m["decode"]]
            started = [m for m in prefill if m["chunk_base"] > 0]
            if not decoding or not prefill or not state["backlog"]:
                raise Failed(f"recover (a): the snapshot holds {len(decoding)} decoding, "
                             f"{len(prefill)} mid-prefill and {len(state['backlog'])} parked "
                             f"streams; want one of each")
            print(f"recover (a) checkpoint: DORA_CHECKPOINT_EVERY={CKPT_EVERY}, killed after "
                  f"cadence checkpoint {CKPT_KILL_AT} (step {CKPT_EVERY * CKPT_KILL_AT}): "
                  f"{len(decoding)} decoding, {len(prefill)} mid-prefill ({len(started)} with "
                  f"chunks done), {len(state['backlog'])} parked; {m1.decode_tokens} tokens sent; "
                  f"checkpoint_state ms {_ms([t for t, _s, _a in snaps])}; state.json "
                  f"{state_bytes} bytes; pools {saves[-1][2][1]} bytes, written in ms "
                  f"{_ms([t for t, _r, _a in saves])}; {m1.decode_tokens / wall1:.1f} tokens/s "
                  f"end to end over {wall1:.3f} s, checkpoints included, against phase 13 (a)'s "
                  f"{rate_13a:.1f} [{smi}]", flush=True)
            engine.drain_streams()  # the killed process's engine, cleaned for (b)

            # (a) the resume: a fresh engine, no new traffic
            fresh = front_door(make_engine, params, cfg, DORA_BATCH_SLOTS="16",
                               DORA_PAGE_SIZE="16", DORA_PREFILL_CHUNK="256",
                               DORA_MULTISTEP_K="8")
            def addresses():
                return {(i, n): t.data_ptr() for i, lp in fresh.pools.items()
                        for n, t in lp.items()}

            ptrs = addresses()
            loads: list = []
            restores: list = []
            _timed_method(fresh, "restore_pools", loads,
                          after=lambda path: (_pool_sums(torch, fresh.pools), addresses()))
            _timed_method(fresh, "restore_state", restores)
            try:
                with _env(DORA_CHECKPOINT_DIR=ckpt, **env):
                    node2, m2, l2, wall2 = _serve_script(torch, DB, LO, fresh, [], max_new)
            finally:
                del fresh.restore_pools, fresh.restore_state
            print(f"recover (a) launches: {json.dumps(l2)}", flush=True)
            if not all(l2[n] > 0 for n in SPEC_OFF_KERNELS):
                raise Failed(f"recover (a): a kernel of the main path never launched: {l2}")
            if len(loads) != 1 or loads[0][2][1] != ptrs or addresses() != ptrs:
                raise Failed(f"recover (a): {len(loads)} pool restores; a pool tensor moved: "
                             f"{loads[0][2][1] != ptrs if loads else None}, "
                             f"{addresses() != ptrs}")
            if loads[0][2][0] != saves[-1][2][0]:
                bad = [i for i, (a, b) in enumerate(zip(loads[0][2][0], saves[-1][2][0]))
                       if a != b]
                raise Failed(f"recover (a): restored pools differ from the saved ones in "
                             f"layers {bad}")
            if m2.restored_streams != len(slots):
                raise Failed(f"recover (a): {m2.restored_streams} streams restored, the "
                             f"snapshot holds {len(slots)}")
            got = _merged("recover (a)", rids, max_new, node1, node2)
            parted = sum(_hold_to_phase4(f"recover (a): request {i}", paths, prompts[i],
                                         got[r], served[i], max_new) < max_new
                         for i, r in enumerate(rids))
            if fresh.graph_captures != 1 or engine.graph_captures != warm:
                raise Failed(f"recover (a): {fresh.graph_captures} captures on the fresh engine "
                             f"(want the K = 8 window's one), {engine.graph_captures - warm} new "
                             f"on phase 13's")
            print(f"recover (a) resume: restore_pools ms {1e3 * loads[0][0]:.1f}, restore_state "
                  f"ms {1e3 * restores[0][0]:.1f}; restored_streams {m2.restored_streams} of "
                  f"{len(slots)} live + {len(state['backlog'])} parked re-queued; pool checksums "
                  f"equal in all {len(saves[-1][2][0])} layers; {len(rids) - parted} merged "
                  f"streams equal phase 4's token for token, {parted} part at near-ties; "
                  f"{m2.decode_tokens} tokens in {wall2:.3f} s ({m2.decode_tokens / wall2:.1f} "
                  f"tokens/s, restore, capture and {m2.checkpoints} checkpoints included); "
                  f"both runs {(m1.decode_tokens + m2.decode_tokens) / (wall1 + wall2):.1f} "
                  f"tokens/s against phase 13 (a)'s {rate_13a:.1f}; captures on the fresh "
                  f"engine {fresh.graph_captures} [{smi}]", flush=True)

            # (b) drain on phase 13's engine, migrate to the fresh one
            handoff = os.path.join(root, "handoff")
            engine.prefix_cache.flush()
            fresh.prefix_cache.flush()  # admit_streams grants from free pages only
            warm_b = fresh.graph_captures
            mids = [f"m{i}" for i in range(len(prompts))]

            def has_tokens(node):
                return len({m["request_id"] for _t, _x, m in node.sent}) >= MIGRATE_AFTER

            events = [(None, _request(r, p, max_new)) for r, p in zip(mids, prompts)]
            events.append((has_tokens, {"type": "MIGRATE", "metadata": {"handoff_dir": handoff}}))
            with _env(DORA_CHECKPOINT_DIR=None, **env):
                node_a, ma, la, wall_a = _serve_script(torch, DB, LO, engine, events, max_new)
            (fname,) = os.listdir(handoff)
            handoff_bytes = os.path.getsize(os.path.join(handoff, fname))
            with open(os.path.join(handoff, fname)) as f:
                payload = json.load(f)
            wire = payload["wire_ids"]
            moved = {wire[m["request_id"]]: m for m in payload["engine"]["slots"]}
            parked = [wire[e[0]] for e in payload["backlog"]]
            finished = {m["request_id"] for _t, _x, m in node_a.sent if m["done"]}
            with _env(DORA_CHECKPOINT_DIR=None, DORA_MIGRATE_DIR=handoff,
                      **{k: v for k, v in env.items() if k != "DORA_MIGRATE_DIR"}):
                node_b, mb, lb, wall_b = _serve_script(
                    torch, DB, LO, fresh, [], max_new,
                    node=_TargetNode(set(mids) - finished))
            print(f"recover (b) launches on the target: {json.dumps(lb)}", flush=True)
            if not all(lb[n] > 0 for n in SPEC_OFF_KERNELS):
                raise Failed(f"recover (b): a kernel of the main path never launched: {lb}")
            n_moved = len(moved) + len(parked)
            if not (ma.migrated_out == mb.migrated_in == n_moved) or os.listdir(handoff):
                raise Failed(f"recover (b): migrated_out {ma.migrated_out}, migrated_in "
                             f"{mb.migrated_in}, {len(moved)} drained + {len(parked)} parked; "
                             f"left in the handoff directory: {os.listdir(handoff)}")
            got = _merged("recover (b)", mids, max_new, node_a, node_b)
            exact = [r for r in mids if r in parked or (r in moved and not moved[r]["decode"])]
            dec = [r for r in moved if moved[r]["decode"]]
            parted = sum(_hold_to_phase4(f"recover (b): request {r}", paths,
                                         prompts[mids.index(r)], got[r],
                                         served[mids.index(r)], max_new) < max_new
                         for r in exact)
            agree = sum(_first_parting(got[r], served[mids.index(r)], max_new) == max_new
                        for r in dec)
            if fresh.graph_captures != warm_b:
                raise Failed(f"recover (b): {fresh.graph_captures - warm_b} capture(s) on the "
                             f"target after warmup")
            print(f"recover (b): MIGRATE after {MIGRATE_AFTER} streams had a token: "
                  f"{len(dec)} decoding + {len(moved) - len(dec)} mid-prefill drained, "
                  f"{len(parked)} parked, {len(finished)} finished before; migrated_out "
                  f"{ma.migrated_out} = migrated_in {mb.migrated_in}; handoff file "
                  f"{handoff_bytes} bytes; drain run {wall_a:.3f} s, target run {wall_b:.3f} s "
                  f"({mb.decode_tokens} tokens, {mb.decode_tokens / wall_b:.1f} tokens/s); every "
                  f"stream gapless to {max_new} tokens; {len(exact) - parted} of {len(exact)} "
                  f"parked or mid-prefill streams equal phase 4's token for token, {parted} "
                  f"part at near-ties; {agree} of {len(dec)} decoding streams (continued "
                  f"without their KV pages) still equal phase 4's; captures on the target "
                  f"{fresh.graph_captures}, none after warmup [{smi}]", flush=True)
            engine.check_invariants()
            fresh.check_invariants()
    finally:
        signal.signal(signal.SIGTERM, prev_term)


# ---------------------------------------------------------------------------
# phase 16: the operator tier, the port's runtime loop over scripted nodes
# ---------------------------------------------------------------------------

#: openai/whisper-large-v3-turbo's config.json (the keys WhisperConfig.from_hf
#: reads): the model of the reference's dora-distil-whisper node
WHISPER_TURBO = {
    "vocab_size": 51866, "d_model": 1280, "encoder_layers": 32, "decoder_layers": 4,
    "encoder_attention_heads": 20, "decoder_attention_heads": 20, "encoder_ffn_dim": 5120,
    "decoder_ffn_dim": 5120, "num_mel_bins": 128, "max_source_positions": 1500,
    "max_target_positions": 448, "decoder_start_token_id": 50258, "eos_token_id": 50257,
}
#: superb/wav2vec2-base-superb-sd's config.json (wav2vec2-base: a group-norm
#: conv stack of seven 512-channel layers, 12 post-LN layers 768 wide)
W2V2_SUPERB_SD = {
    "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 3072, "conv_dim": [512] * 7, "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "num_conv_pos_embeddings": 128,
    "num_conv_pos_embedding_groups": 16, "num_labels": 2, "layer_norm_eps": 1e-5,
    "feat_extract_norm": "group", "conv_bias": False,
}
#: the speech node's utterances: seeded noise of 1 to 30 s at 16 kHz
SPEECH_UTTERANCES = 8
SPEECH_SECONDS = (1.0, 30.0)
#: the VAD's bf16 speech probability against its f32 run on the card, as an
#: absolute bound: bf16 rounds the conv stack's and the 12 layers' products
#: (torch's bf16 on the CPU moved these seeded probabilities by < 6e-3)
VAD_PROB_TOL = 0.02
#: the VLM node's eight frames, and after which of them a timer tick comes
#: (two, one, three and two frames between ticks)
VLM_FRAMES = 8
VLM_TICK_AFTER = (1, 2, 5, 7)
#: the kernels the greedy VLM node runs (phase 11's), and the verify's
OPERATOR_KERNELS = ("flash_attention", "int8_matmul", "attention_step", "mlp_step",
                    "lm_head_argmax", "attention_chunk_step")


def whisper_tensors(torch, cfg, seed: int, dev: str = "cuda") -> dict:
    """Seeded random tensors of a WhisperForConditionalGeneration checkpoint
    at ``cfg``'s shapes, under its names and layouts ([out, in] linears,
    [out, in, k] convolutions, no k bias): weights and biases normal (std
    0.02), norm weights one and biases zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev) * 0.02

    def ln(name, d):
        return {name + ".weight": torch.ones(d, device=dev), name + ".bias": torch.zeros(d, device=dev)}

    def attn(p, d):
        t = {}
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[f"{p}{n}.weight"] = normal(d, d)
            if n != "k_proj":
                t[f"{p}{n}.bias"] = normal(d)
        return t

    def layer(p, d, f, cross: bool):
        t = {**attn(p + "self_attn.", d), **ln(p + "self_attn_layer_norm", d),
             **ln(p + "final_layer_norm", d), p + "fc1.weight": normal(f, d),
             p + "fc1.bias": normal(f), p + "fc2.weight": normal(d, f), p + "fc2.bias": normal(d)}
        if cross:
            t.update({**attn(p + "encoder_attn.", d), **ln(p + "encoder_attn_layer_norm", d)})
        return t

    d, f = cfg.dim, cfg.ffn
    t = {"model.encoder.conv1.weight": normal(d, cfg.n_mels, 3),
         "model.encoder.conv1.bias": normal(d), "model.encoder.conv2.weight": normal(d, d, 3),
         "model.encoder.conv2.bias": normal(d),
         "model.encoder.embed_positions.weight": normal(cfg.max_source, d),
         **ln("model.encoder.layer_norm", d),
         "model.decoder.embed_tokens.weight": normal(cfg.vocab, d),
         "model.decoder.embed_positions.weight": normal(cfg.max_target, d),
         **ln("model.decoder.layer_norm", d)}
    for i in range(cfg.enc_layers):
        t.update(layer(f"model.encoder.layers.{i}.", d, f, False))
    for i in range(cfg.dec_layers):
        t.update(layer(f"model.decoder.layers.{i}.", d, f, True))
    return t


def wav2vec2_tensors(torch, cfg, seed: int, dev: str = "cuda") -> dict:
    """Seeded random tensors of a Wav2Vec2ForAudioFrameClassification
    checkpoint at ``cfg``'s shapes, under its names (bias-free convolutions,
    the first one group-normed, the positional convolution weight-normed
    as weight_g / weight_v): weights and biases normal (std 0.02), norm
    weights one and biases zero, weight_g one."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev) * 0.02

    def ln(name, d):
        return {name + ".weight": torch.ones(d, device=dev), name + ".bias": torch.zeros(d, device=dev)}

    fe = "wav2vec2.feature_extractor.conv_layers."
    t, c_in = {}, 1
    for i, (c, k) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        t[f"{fe}{i}.conv.weight"] = normal(c, c_in, k)
        c_in = c
    t.update(ln(f"{fe}0.layer_norm", cfg.conv_dims[0]))
    d, f, k = cfg.dim, cfg.ffn, cfg.pos_conv_kernel
    enc = "wav2vec2.encoder."
    t.update({**ln("wav2vec2.feature_projection.layer_norm", c_in),
              "wav2vec2.feature_projection.projection.weight": normal(d, c_in),
              "wav2vec2.feature_projection.projection.bias": normal(d),
              enc + "pos_conv_embed.conv.weight_g": torch.ones(1, 1, k, device=dev),
              enc + "pos_conv_embed.conv.weight_v": normal(d, d // cfg.pos_conv_groups, k),
              enc + "pos_conv_embed.conv.bias": normal(d), **ln(enc + "layer_norm", d),
              "classifier.weight": normal(cfg.num_labels, d),
              "classifier.bias": normal(cfg.num_labels)})
    for i in range(cfg.layers):
        p = f"{enc}layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[f"{p}attention.{n}.weight"] = normal(d, d)
            t[f"{p}attention.{n}.bias"] = normal(d)
        t.update({**ln(p + "layer_norm", d), **ln(p + "final_layer_norm", d),
                  p + "feed_forward.intermediate_dense.weight": normal(f, d),
                  p + "feed_forward.intermediate_dense.bias": normal(f),
                  p + "feed_forward.output_dense.weight": normal(d, f),
                  p + "feed_forward.output_dense.bias": normal(d)})
    return t


class _OpNode:
    """Phase 16's node: INPUT events in order, then the end of the stream;
    every ``send_output`` captured as (output id, host copy, metadata), and
    the runtime's ``wake`` calls counted. The operator runtime's loop sees
    what a dataflow node gives it, without a daemon."""

    def __init__(self, events):
        import threading

        self._events = list(events)
        self.stream_ended = False
        self.sent: list = []
        self.wakes = 0
        self._lock = threading.Lock()

    def recv(self, timeout=None):
        if self._events:
            return self._events.pop(0)
        self.stream_ended = True
        return None

    def wake(self):
        with self._lock:
            self.wakes += 1

    def send_output(self, output_id, data, metadata=None):
        import numpy as np

        self.sent.append((output_id, np.array(data), dict(metadata or {})))

    def __iter__(self):  # a node loop that iterates (nodehub.translator.serve)
        return iter(self.recv, None)


def _event(event_id: str, value=None) -> dict:
    return {"type": "INPUT", "id": event_id, "value": value, "metadata": {}}


@contextlib.contextmanager
def _prebuilt(operators: dict):
    """The runtime's factory loader answering each source of ``operators``
    with its operator, built from seeded weights (a node hosting two HF
    families reads two checkpoints; DORA_HF_CHECKPOINT names one)."""
    from dora_tpu_torch.tpu import fuse

    real = fuse.load_torch_operator

    def load(source, working_dir=None, device=None):
        return operators[source] if source in operators else real(source, working_dir, device)

    fuse.load_torch_operator = load
    try:
        yield
    finally:
        fuse.load_torch_operator = real


def _f32(torch, L, fn):
    """``fn()`` with the models' compute dtype f32 (the plain reference)."""
    saved = L.compute_dtype
    L.compute_dtype = lambda device: torch.float32
    try:
        return fn()
    finally:
        L.compute_dtype = saved


def _run_node(torch, DB, LO, graph, events, depth=None, fetch_every=None, timed=False):
    """The port's runtime loop (``runtime.serve``) over an _OpNode of
    ``events`` on a fresh executor of ``graph``, every launch counter zeroed
    just before and read just after, the plain versions counted. With
    ``timed`` (synchronous only) each tick's wall is kept. Returns (node,
    wall s, launches, plain calls, tick walls)."""
    from dora_tpu_torch.runtime import serve
    from dora_tpu_torch.tpu.fuse import FusedExecutor

    node = _OpNode(events)
    executor = FusedExecutor(graph, pipeline_depth=depth, fetch_every=fetch_every)
    ticks: list = []
    if timed:
        real_tick = executor.tick

        def tick():
            t = time.perf_counter()
            out = real_tick()
            ticks.append(time.perf_counter() - t)
            return out

        executor.tick = tick
    plain_calls = _PlainCalls(DB, LO)
    _reset_launches(DB, LO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        serve(node, executor)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        launches = _launches(DB, LO)
        plain_calls.restore()
    return node, wall, launches, plain_calls.n, ticks


def _same_sends(what: str, a, b) -> None:
    """Two runs' sends equal bit for bit, in order, metadata too but for the
    runtime's ``tick_ns`` (the wall time each tick was dispatched)."""
    if len(a) != len(b):
        raise Failed(f"{what}: {len(a)} sends against {len(b)}")
    for i, ((ka, va, ma), (kb, vb, mb)) in enumerate(zip(a, b)):
        ma, mb = ({k: v for k, v in m.items() if k != "tick_ns"} for m in (ma, mb))
        if ka != kb or ma != mb or va.dtype != vb.dtype or va.tobytes() != vb.tobytes():
            raise Failed(f"{what}: send {i} ({ka}) differs")


def _device_busy(torch, fn, out_dir: str) -> str:
    """``fn()`` under ``profiling.start_capture`` / ``stop_capture``; the
    busy share is the union of its kernels' intervals in the Chrome trace
    over the wall."""
    import shutil

    from dora_tpu_torch import profiling

    err = profiling.start_capture(out_dir)
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t
        artifact = profiling.stop_capture(out_dir, err)
    try:
        with open(os.path.join(artifact, "trace.json")) as f:
            events = json.load(f).get("traceEvents", [])
    except (OSError, NotADirectoryError, ValueError):
        events = []
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel" and "dur" in e)
    if not spans:
        return f"busy share not measured (the capture saw no kernel; wall {wall:.3f} s)"
    busy = _union_us(spans)
    return (f"busy share {busy / (wall * 1e6):.3f} ({len(spans)} kernels, {busy / 1e3:.1f} ms "
            f"of kernel intervals' union in a traced wall of {wall:.3f} s)")


def serve_operators(torch, DB, LO, L, smi: str, seed: int, scratch: str, dev: str = "cuda",
                    whisper_hf=WHISPER_TURBO, w2v_hf=W2V2_SUPERB_SD, vlm_size: str = "bench",
                    seconds=SPEECH_SECONDS) -> dict:
    """Phase 16: the speech node, then the VLM node (:func:`speech_node`,
    :func:`vlm_node`). Returns the VLM node's launches (greedy run and the
    speculative one's attention_chunk_step)."""
    speech_node(torch, DB, LO, L, smi, seed, scratch, dev, whisper_hf, w2v_hf, seconds)
    torch.cuda.empty_cache()
    launches = vlm_node(torch, DB, LO, L, smi, seed + 1, dev, vlm_size)
    torch.cuda.empty_cache()
    return launches


def speech_node(torch, DB, LO, L, smi: str, seed: int, scratch: str, dev: str,
                whisper_hf: dict, w2v_hf: dict, seconds) -> None:
    """Phase 16 (a): the port's runtime node of the speech-to-text example,
    ``vad`` (Wav2Vec2 at ``w2v_hf``) and ``asr`` (Whisper at ``whisper_hf``),
    each built by ``nodehub.ops`` from seeded tensors under the checkpoint's
    names through ``map_params``, over SPEECH_UTTERANCES utterances, each
    sent to both operators: every tick's tokens equal
    ``whisper.make_serving_step`` called directly on the audio the tick
    sampled, and its probability the VAD operator's; the greedy tokens held
    to the f32 plain path by the near-tie rule, the probability within
    VAD_PROB_TOL of its f32 run; the pipelined run (the default depth) and
    ``DORA_FETCH_EVERY=4`` equal the synchronous one bit for bit; no kernel
    of the 11 and no plain version runs."""
    import numpy as np

    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.models.hf import wav2vec2, whisper
    from dora_tpu_torch.nodehub import ops
    from dora_tpu_torch.tpu.fuse import FusedGraph

    wcfg = whisper.WhisperConfig.from_hf(whisper_hf)
    vcfg = wav2vec2.Wav2Vec2Config.from_hf(w2v_hf)
    t = time.perf_counter()
    tensors = whisper_tensors(torch, wcfg, seed, dev)
    n_asr = sum(v.numel() for v in tensors.values())
    wparams = whisper.map_params(tensors, wcfg)
    tensors = wav2vec2_tensors(torch, vcfg, seed + 1, dev)
    n_vad = sum(v.numel() for v in tensors.values())
    vparams = wav2vec2.map_params(tensors, vcfg)
    del tensors
    torch.cuda.synchronize()
    print(f"operators (a) weights: Whisper {wcfg.enc_layers} + {wcfg.dec_layers} layers x "
          f"{wcfg.dim} ({n_asr / 1e6:.1f} M), Wav2Vec2 {vcfg.layers} x {vcfg.dim} "
          f"({n_vad / 1e6:.1f} M), seeded random under the checkpoints' names, through "
          f"map_params in {time.perf_counter() - t:.2f} s [{smi}]", flush=True)
    with _env(DORA_MAX_NEW_TOKENS=None, DORA_SPEC_DECODE=None):
        vad_op = ops.wav2vec2_operator(vcfg, vparams)
        asr_op = ops.whisper_operator(wcfg, wparams)
    max_new = 32  # whisper_operator's default
    desc = Descriptor.parse({"nodes": [
        {"id": "microphone", "path": "module:dora_tpu.nodehub.microphone",
         "outputs": ["audio"]},
        {"id": "speech", "path": "module:dora_tpu_torch.runtime",
         "args": ("--operator vad=dora_tpu_torch.nodehub.ops:make_vad "
                  "--operator asr=dora_tpu_torch.nodehub.ops:make_asr"),
         "inputs": {"vad/audio": {"source": "microphone/audio", "queue_size": 1},
                    "asr/audio": {"source": "microphone/audio", "queue_size": 1}},
         "outputs": ["vad/prob", "asr/tokens"]},
        {"id": "printer", "path": "module:dora_tpu.nodehub.terminal_print",
         "inputs": {"prob": "speech/vad/prob", "tokens": "speech/asr/tokens"}}]})
    with _prebuilt({"dora_tpu_torch.nodehub.ops:make_vad": vad_op,
                    "dora_tpu_torch.nodehub.ops:make_asr": asr_op}):
        graph = FusedGraph.build(desc.node("speech"), desc, device=dev)
    if graph.topo != ["asr", "vad"] or graph.external_outputs != {"vad/prob", "asr/tokens"}:
        raise Failed(f"the speech node's graph is {graph.topo}, out {graph.external_outputs}")

    rng = np.random.default_rng(seed)
    lengths = np.linspace(*seconds, SPEECH_UTTERANCES) * 16000
    audio = [(rng.normal(size=int(n)) * rng.uniform(0.02, 0.3)).astype(np.float32)
             for n in lengths]
    events = [_event(f"{op}/audio", a) for a in audio for op in ("vad", "asr")]
    # event k (from 1) ticks on utterance k // 2 (VAD) and (k - 1) // 2 (ASR)
    sampled = [(k // 2, (k - 1) // 2) for k in range(1, len(events))]

    serve = whisper.make_serving_step(wcfg, max_new)
    on_dev = [torch.from_numpy(a).to(dev) for a in audio]
    ref_tok = [serve(wparams, a)[0] for a in on_dev]
    ref_prob = [vad_op.step(vparams, {"audio": a})[1]["prob"] for a in on_dev]
    torch.cuda.synchronize()

    node, wall, launches, n_plain, ticks = _run_node(torch, DB, LO, graph, events, depth=0,
                                                     timed=True)
    got = [(node.sent[2 * j], node.sent[2 * j + 1]) for j in range(len(node.sent) // 2)]
    if len(got) != len(sampled) or any(a[0] != "asr/tokens" or b[0] != "vad/prob"
                                       for a, b in got):
        raise Failed(f"the speech node sent {[s[0] for s in node.sent]}")
    for j, ((_, tok, tmeta), (_, prob, pmeta)) in enumerate(got):
        v, a = sampled[j]
        if not np.array_equal(tok, ref_tok[a].cpu().numpy()) or tmeta["dtype"] != "int32":
            raise Failed(f"speech tick {j}: the runtime's tokens differ from make_serving_step's "
                         f"on utterance {a}")
        if not np.array_equal(prob, ref_prob[v].cpu().numpy()) or pmeta["dtype"] != "float32":
            raise Failed(f"speech tick {j}: the runtime's probability differs from the VAD "
                         f"operator's on utterance {v}")
    busy = [n for n, c in launches.items() if c]
    print(f"operators (a) speech node: {len(ticks)} ticks over {SPEECH_UTTERANCES} utterances "
          f"of {seconds[0]:.0f}-{seconds[1]:.0f} s, each tick's tokens and probability equal to "
          f"make_serving_step's and the VAD operator's called directly; launches of the 11 "
          f"kernels {json.dumps({n: launches[n] for n in sorted(launches)})} (nonzero: "
          f"{busy or 'none'}), plain calls {n_plain} [{smi}]", flush=True)
    if busy or n_plain:
        raise Failed("the speech node ran a kernel or a plain version of the 11")
    ticks_ms = [1e3 * x for x in ticks]
    print(f"operators (a) speech node, synchronous: wall {wall:.3f} s, "
          f"{wall / SPEECH_UTTERANCES:.3f} s an utterance ({len(ticks)} ticks: ASR {max_new} "
          f"tokens and VAD a tick); tick wall p50 {_pct(ticks_ms, 50):.1f} ms, p99 "
          f"{_pct(ticks_ms, 99):.1f} ms, max {max(ticks_ms):.1f} ms [{smi}]", flush=True)

    for what, depth, every in (("pipelined (default depth)", None, None),
                               ("DORA_FETCH_EVERY=4", None, "4")):
        with _env(DORA_PIPELINE_DEPTH=None, DORA_FETCH_EVERY=every):
            pnode, pwall, _, _, _ = _run_node(torch, DB, LO, graph, events, depth, None)
        _same_sends(f"speech node {what}", pnode.sent, node.sent)
        print(f"operators (a) speech node, {what}: the same {len(pnode.sent)} sends bit for "
              f"bit in tick order; wall {pwall:.3f} s against {wall:.3f} s synchronous; "
              f"{pnode.wakes} wakes [{smi}]", flush=True)

    # the near-tie rule against the f32 plain path, and the VAD's f32 run
    feats = [whisper.log_mel_traced(a[None].float(), wcfg.n_mels,
                                    n_samples=wcfg.max_source * 320) for a in on_dev]
    parts, worst = [], 0.0
    forced = torch.full((1, 1), wcfg.decoder_start_token, dtype=torch.int32, device=dev)
    for u in range(SPEECH_UTTERANCES):
        served = ref_tok[u].tolist()
        ref32 = _f32(torch, L, lambda: serve(wparams, on_dev[u]))[0].tolist()
        t_part = _first_parting(served, ref32, max_new)
        parts.append(t_part)
        if t_part < max_new:
            ids = torch.cat([forced, torch.tensor([served[:t_part]], dtype=torch.int32,
                                                  device=dev)], dim=1)
            lf = _f32(torch, L, lambda: whisper.decoder_logits(
                wparams, wcfg, whisper.encode(wparams, wcfg, feats[u]), ids))[0, -1]
            top = float(lf.max())
            da, db = top - float(lf[served[t_part]]), top - float(lf[ref32[t_part]])
            print(f"operators (a) asr utterance {u}: parts from the f32 plain path at token "
                  f"{t_part} ({served[t_part]} against {ref32[t_part]}): the served token "
                  f"{da:.4e} and the f32 one {db:.4e} below the f32 maximum (bound {NEAR_TIE}) "
                  f"[{smi}]", flush=True)
            if not (da <= NEAR_TIE and db <= NEAR_TIE):
                raise Failed(f"speech utterance {u} parts from the f32 path away from a near-tie")
        p32 = _f32(torch, L, lambda: vad_op.step(vparams, {"audio": on_dev[u]})[1]["prob"])
        worst = max(worst, float((ref_prob[u] - p32).abs().max()))
    print(f"operators (a) agreement: ASR greedy against the f32 plain path, first parting at "
          f"{parts} of {max_new}; VAD bf16 against f32: max |dprob| {worst:.3e} (bound "
          f"{VAD_PROB_TOL}); probabilities {[round(float(p), 4) for p in ref_prob]} [{smi}]",
          flush=True)
    if worst > VAD_PROB_TOL:
        raise Failed(f"the VAD's bf16 probability is {worst:.3e} from its f32 run")
    long_utt = [_event("vad/audio", audio[-1]), _event("asr/audio", audio[-1])]
    share = _device_busy(torch, lambda: _run_node(torch, DB, LO, graph, long_utt, depth=0),
                         os.path.join(scratch, f"trace-speech-{os.getpid()}"))
    print(f"operators (a) device plane: one tick on the {seconds[1]:.0f} s utterance under "
          f"profiling.start_capture: {share} [{smi}]", flush=True)


def vlm_node(torch, DB, LO, L, smi: str, seed: int, dev: str, size: str) -> dict:
    """Phase 16 (b): the port's runtime node of the VLM example, ``op`` =
    ``nodehub.ops.make_vlm`` under ``DORA_MODEL_SIZE=bench`` (bench_2b) and
    ``DORA_INT8_DECODE=1``, its image input sampled latest-wins and ticked
    by a timer: VLM_FRAMES seeded uint8 frames with ticks after
    VLM_TICK_AFTER; every tick takes the latest frame and its tokens equal
    ``vlm.generate`` on that frame; the launches exact (kernels 11, 7, 9, 1
    and 2) with no plain version; then ``DORA_SPEC_DECODE=1`` through the
    operator the factory makes under it: tokens equal ``vlm.generate_speculative``,
    kernel 10 a verify pass; frames per second pipelined against
    synchronous."""
    import numpy as np

    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.models import tokenizer, vlm
    from dora_tpu_torch.nodehub import ops
    from dora_tpu_torch.tpu.fuse import FusedGraph

    desc = Descriptor.parse({"nodes": [
        {"id": "camera", "path": "module:dora_tpu.nodehub.camera", "outputs": ["image"]},
        {"id": "vlm", "path": "module:dora_tpu_torch.runtime",
         "args": "--operator op=dora_tpu_torch.nodehub.ops:make_vlm",
         "inputs": {"op/image": {"source": "camera/image", "queue_size": 1},
                    "op/tick": "dora/timer/millis/100"},
         "outputs": ["op/tokens"]},
        {"id": "printer", "path": "module:dora_tpu.nodehub.terminal_print",
         "inputs": {"tokens": "vlm/op/tokens"}}]})
    t = time.perf_counter()
    knobs = dict(DORA_MODEL_SIZE=size, DORA_INT8_DECODE="1", DORA_INT4_DECODE=None,
                 DORA_INT8_PURE=None, DORA_SPEC_DECODE=None, DORA_MAX_NEW_TOKENS=None,
                 DORA_PROMPT=None, DORA_CHECKPOINT=None, DORA_HF_CHECKPOINT=None,
                 DORA_PARAM_DTYPE=None, DORA_MESH=None)
    with _env(**knobs):
        graph = FusedGraph.build(desc.node("vlm"), desc, device=dev)
    torch.cuda.synchronize()
    cfg = vlm.VLMConfig.bench_2b() if size != "tiny" else vlm.VLMConfig.tiny()
    params = graph.operators["op"].init_state
    if graph.trigger_inputs != {"op/tick"} or graph.timer_inputs != {"op/tick"}:
        raise Failed(f"the VLM node's triggers are {graph.trigger_inputs}")
    print(f"operators (b) VLM node: make_vlm built {cfg.vision_layers}-layer ViT + "
          f"{cfg.layers}-layer LM (DORA_MODEL_SIZE={size}, DORA_INT8_DECODE=1) in "
          f"{time.perf_counter() - t:.2f} s [{smi}]", flush=True)
    max_new = 16  # make_vlm's default
    prompt = torch.tensor([[x % cfg.vocab for x in tokenizer.encode("describe")]],
                          dtype=torch.int32, device=dev)
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, size=(cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
              for _ in range(VLM_FRAMES)]
    events = []
    for i, f in enumerate(frames):
        events.append(_event("op/image", f))
        if i in VLM_TICK_AFTER:
            events.append(_event("op/tick"))
    images = {i: (torch.from_numpy(frames[i]).to(dev).float() / 255.0)[None]
              for i in VLM_TICK_AFTER}
    ref = {i: vlm.generate(params, cfg, images[i], prompt, max_new)[0].cpu().numpy()
           for i in VLM_TICK_AFTER}
    if len({r.tobytes() for r in ref.values()}) < 2:
        print("operators (b): every frame gives the same tokens; the latest-wins check rests "
              "on the sampled frames' sums", flush=True)

    sums = []
    step = graph.operators["op"].step

    def recording(state, inputs):
        sums.append(int(inputs["image"].long().sum()))
        return step(state, inputs)

    graph.operators["op"].step = recording
    try:
        node, wall, launches, n_plain, ticks = _run_node(torch, DB, LO, graph, events, depth=0,
                                                         timed=True)
    finally:
        graph.operators["op"].step = step
    want_sums = [int(frames[i].astype(np.int64).sum()) for i in VLM_TICK_AFTER]
    if sums != want_sums:
        raise Failed(f"the VLM node's ticks sampled frame sums {sums}, not the latest frames' "
                     f"{want_sums}")
    for j, i in enumerate(VLM_TICK_AFTER):
        if not np.array_equal(node.sent[j][1], ref[i]):
            raise Failed(f"VLM tick {j}: tokens differ from vlm.generate on frame {i}")
    n = len(VLM_TICK_AFTER)
    steps = n * (max_new - 1)
    # the prefill's head on one row; a prefill of at most 32 rows (not at
    # bench_2b's 265) also takes the four fused weights of every layer
    per_prefill = 1 + (4 * cfg.layers if cfg.n_patches + prompt.shape[1] <= L.MATVEC_MAX_ROWS
                       else 0)
    got = {k: c for k, c in launches.items() if c}
    want = {"flash_attention": n * cfg.vision_layers, "int8_matmul": n * per_prefill,
            "attention_step": cfg.layers * steps, "mlp_step": cfg.layers * steps,
            "lm_head_argmax": steps}
    print(f"operators (b) VLM node greedy: {n} ticks took frames {list(VLM_TICK_AFTER)} (the "
          f"latest of each burst), tokens equal vlm.generate's; launches {json.dumps(got)}; "
          f"plain calls {n_plain} [{smi}]", flush=True)
    if got != want or n_plain:
        raise Failed(f"the VLM node launched {got} with {n_plain} plain calls, expected {want}")

    walls = {"synchronous": [wall], "pipelined": []}
    for depth, what in ((None, "pipelined"), (None, "pipelined"), (0, "synchronous")):
        with _env(DORA_PIPELINE_DEPTH=None, DORA_FETCH_EVERY=None):
            pnode, pwall, _, _, _ = _run_node(torch, DB, LO, graph, events, depth, None)
        _same_sends(f"VLM node {what}", pnode.sent, node.sent)
        walls[what].append(pwall)
    ticks_ms = [1e3 * x for x in ticks]
    fps = {k: [round(n / w, 3) for w in v] for k, v in walls.items()}
    EARLIER["vlm_tick"] = (f"p50 {_pct(ticks_ms, 50):.1f} ms p99 {_pct(ticks_ms, 99):.1f} ms, "
                           f"{fps['pipelined']} frames a second pipelined")
    print(f"operators (b) VLM node: frames per second (ticks a second) synchronous "
          f"{fps['synchronous']}, pipelined (depth 4) {fps['pipelined']}, every run's tokens "
          f"bit for bit the first's; tick wall p50 {_pct(ticks_ms, 50):.1f} ms, p99 "
          f"{_pct(ticks_ms, 99):.1f} ms ({max_new} tokens a tick) [{smi}]", flush=True)

    # DORA_SPEC_DECODE=1: the operator the factory builds under it
    with _env(**{**knobs, "DORA_SPEC_DECODE": "1"}):
        spec_op = ops.vlm_operator(cfg, params)
    ref_spec = {i: vlm.generate_speculative(params, cfg, images[i], prompt, max_new)[0][0]
                .cpu().numpy() for i in VLM_TICK_AFTER}
    verify = [0]
    real_chunk = vlm.decode_chunk_fused

    def counted(*a, **k):
        verify[0] += 1
        return real_chunk(*a, **k)

    greedy_op = graph.operators["op"]
    graph.operators["op"] = spec_op
    vlm.decode_chunk_fused = counted
    try:
        snode, swall, s_launches, s_plain, _ = _run_node(torch, DB, LO, graph, events, depth=0)
    finally:
        vlm.decode_chunk_fused = real_chunk
        graph.operators["op"] = greedy_op
    for j, i in enumerate(VLM_TICK_AFTER):
        if not np.array_equal(snode.sent[j][1], ref_spec[i]):
            raise Failed(f"VLM spec tick {j}: tokens differ from vlm.generate_speculative")
    got = {k: c for k, c in s_launches.items() if c}
    v = verify[0]
    want = {"flash_attention": n * cfg.vision_layers, "int8_matmul": n * per_prefill,
            "attention_chunk_step": cfg.layers * v, "mlp_step": cfg.layers * v,
            "lm_head_argmax": v}
    same = sum(int(np.array_equal(ref_spec[i], ref[i])) for i in VLM_TICK_AFTER)
    print(f"operators (b) VLM node DORA_SPEC_DECODE=1: tokens equal vlm.generate_speculative's "
          f"({same} of {n} ticks equal greedy's); {v} verify passes, {n * max_new / v:.3f} "
          f"tokens a pass; launches {json.dumps(got)}; plain calls {s_plain}; wall {swall:.3f} s "
          f"({n / swall:.3f} frames a second) [{smi}]", flush=True)
    if got != want or s_plain:
        raise Failed(f"the speculative VLM node launched {got}, expected {want}")
    return {**launches, "attention_chunk_step": s_launches["attention_chunk_step"]}


# ---------------------------------------------------------------------------
# phase 17: the hub models, the yolo and translation dataflows' nodes
# ---------------------------------------------------------------------------

#: hustvl/yolos-small's widths (DeiT-S; the keys YolosConfig.from_hf reads) at
#: its 800 x 1333 input, without mid-position embeddings
YOLOS_SMALL = {
    "hidden_size": 384, "num_hidden_layers": 12, "num_attention_heads": 6,
    "intermediate_size": 1536, "image_size": [800, 1333], "patch_size": 16,
    "num_detection_tokens": 100, "num_labels": 91, "layer_norm_eps": 1e-12,
    "use_mid_position_embeddings": False,
}
#: Helsinki-NLP/opus-mt-en-de's widths (the keys MarianConfig.from_hf reads)
OPUS_MT_EN_DE = {
    "vocab_size": 58101, "d_model": 512, "encoder_layers": 6, "decoder_layers": 6,
    "encoder_attention_heads": 8, "encoder_ffn_dim": 2048, "max_position_embeddings": 512,
    "pad_token_id": 58100, "eos_token_id": 0, "decoder_start_token_id": 58100,
    "scale_embedding": True, "activation_function": "swish", "forced_eos_token_id": 0,
}
#: facebook/mms-tts-eng's widths: transformers.VitsConfig()'s defaults (the
#: keys VitsConfig.from_hf reads)
MMS_TTS_ENG = {
    "vocab_size": 38, "hidden_size": 192, "num_hidden_layers": 6, "num_attention_heads": 2,
    "ffn_dim": 768, "ffn_kernel_size": 3, "window_size": 4, "flow_size": 192,
    "spectrogram_bins": 513, "duration_predictor_kernel_size": 3,
    "duration_predictor_filter_channels": 256, "use_stochastic_duration_prediction": True,
    "duration_predictor_num_flows": 4, "duration_predictor_flow_bins": 10,
    "duration_predictor_tail_bound": 5.0, "depth_separable_num_layers": 3,
    "depth_separable_channels": 2, "prior_encoder_num_flows": 4,
    "prior_encoder_num_wavenet_layers": 4, "wavenet_kernel_size": 5,
    "wavenet_dilation_rate": 1, "upsample_initial_channel": 512, "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4], "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]], "leaky_relu_slope": 0.1,
    "layer_norm_eps": 1e-5, "speaking_rate": 1.0, "noise_scale": 0.667,
    "noise_scale_duration": 0.8, "num_speakers": 1, "speaker_embedding_size": 0,
    "sampling_rate": 16000,
}
#: the detector nodes' frames, and the translation nodes' sentences (10 to
#: 200 characters of HUB_WORDS, a few of them unknown to the fabricated
#: sentencepiece model)
HUB_FRAMES = 8
HUB_SENTENCES = 8
SENTENCE_CHARS = (10, 200)
HUB_WORDS = ("the", "cat", "sat", "on", "a", "mat", "dog", "ran", "to", "green", "house",
             "river", "city", "when", "we", "left", "in", "morning", "train", "was", "late",
             "quickly", "zebra", "xylophone")
#: the fabricated VITS vocabulary: pad 0, then these 37 characters
VITS_CHARS = " abcdefghijklmnopqrstuvwxyz'-.,?!0123"
#: YOLOS's class head at He scale (std sqrt(2 / dim)) and its last layer at
#: this std, so that the seeded class probabilities spread: with every layer
#: at 0.02 each slot's probabilities are near-ties of each other (~1 / 92)
CLASS_HEAD_STD = 0.3
#: the self-contained detector's seeded objectness and class logits sit near
#: 0 (every score near the 0.25 threshold, every class a near-tie): its
#: heads' output kernels' logit rows are scaled to this logit std on the
#: first frame
DETECT_LOGIT_STD = 2.0


def _normal_gen(torch, seed: int, dev: str):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, std=0.02):
        return torch.randn(*shape, generator=gen, device=dev) * std

    return normal


def _ln_tensors(torch, name: str, d: int, dev: str) -> dict:
    return {name + ".weight": torch.ones(d, device=dev), name + ".bias": torch.zeros(d, device=dev)}


def yolos_tensors(torch, cfg, seed: int, dev: str = "cuda") -> dict:
    """Seeded random tensors of a YolosForObjectDetection checkpoint at
    ``cfg``'s shapes, under its names ([out, in] linears, the [dim, 3, ps,
    ps] patch conv): normal (std 0.02), the class head as CLASS_HEAD_STD
    says, norm weights one and biases zero."""
    normal = _normal_gen(torch, seed, dev)
    d, f = cfg.dim, cfg.ffn
    emb = "vit.embeddings."
    t = {emb + "cls_token": normal(1, 1, d), emb + "detection_tokens": normal(1, cfg.n_det, d),
         emb + "position_embeddings": normal(1, 1 + cfg.n_patches + cfg.n_det, d),
         emb + "patch_embeddings.projection.weight": normal(d, 3, cfg.patch_size,
                                                            cfg.patch_size),
         emb + "patch_embeddings.projection.bias": normal(d),
         **_ln_tensors(torch, "vit.layernorm", d, dev)}
    for i in range(cfg.layers):
        p = f"vit.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            t[f"{p}attention.attention.{n}.weight"] = normal(d, d)
            t[f"{p}attention.attention.{n}.bias"] = normal(d)
        t.update({p + "attention.output.dense.weight": normal(d, d),
                  p + "attention.output.dense.bias": normal(d),
                  p + "intermediate.dense.weight": normal(f, d),
                  p + "intermediate.dense.bias": normal(f),
                  p + "output.dense.weight": normal(d, f), p + "output.dense.bias": normal(d),
                  **_ln_tensors(torch, p + "layernorm_before", d, dev),
                  **_ln_tensors(torch, p + "layernorm_after", d, dev)})
    if cfg.use_mid_pos:
        t["vit.encoder.mid_position_embeddings"] = normal(cfg.layers - 1, 1,
                                                          1 + cfg.n_patches + cfg.n_det, d)
    he = (2 / d) ** 0.5
    for head, stds in (("class_labels_classifier", (he, he, CLASS_HEAD_STD)),
                       ("bbox_predictor", (0.02, 0.02, 0.02))):
        for i, (o, std) in enumerate(zip((d, d, cfg.n_labels + 1 if stds[0] == he else 4),
                                         stds)):
            t[f"{head}.layers.{i}.weight"] = normal(o, d, std=std)
            t[f"{head}.layers.{i}.bias"] = normal(o)
    return t


def marian_tensors(torch, cfg, seed: int, dev: str = "cuda") -> dict:
    """Seeded random tensors of a MarianMTModel checkpoint at ``cfg``'s
    shapes, under its names (the shared embedding, [out, in] linears): the
    embedding normal (std 0.02), the linears at 1/sqrt(fan-in) (at 0.02
    the scaled embedding of the start token dominates every layer's
    output, and every source decodes to that token), norm weights one,
    biases and final_logits_bias zero."""
    normal = _normal_gen(torch, seed, dev)
    d, f = cfg.dim, cfg.ffn

    def zeros(n):
        return torch.zeros(n, device=dev)

    def attn(p):
        t = {}
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[f"{p}{n}.weight"], t[f"{p}{n}.bias"] = normal(d, d, std=d ** -0.5), zeros(d)
        return t

    t = {"model.shared.weight": normal(cfg.vocab, d), "final_logits_bias": zeros((1, cfg.vocab))}
    for side, n_layers in (("encoder", cfg.enc_layers), ("decoder", cfg.dec_layers)):
        for i in range(n_layers):
            p = f"model.{side}.layers.{i}."
            t.update({**attn(p + "self_attn."),
                      **_ln_tensors(torch, p + "self_attn_layer_norm", d, dev),
                      p + "fc1.weight": normal(f, d, std=d ** -0.5), p + "fc1.bias": zeros(f),
                      p + "fc2.weight": normal(d, f, std=f ** -0.5), p + "fc2.bias": zeros(d),
                      **_ln_tensors(torch, p + "final_layer_norm", d, dev)})
            if side == "decoder":
                t.update({**attn(p + "encoder_attn."),
                          **_ln_tensors(torch, p + "encoder_attn_layer_norm", d, dev)})
    return t


def vits_tensors(torch, cfg, seed: int, dev: str = "cuda") -> dict:
    """Seeded random tensors of a VitsModel checkpoint (stochastic duration
    predictor) at ``cfg``'s shapes, under its names: torch's [out, in, k]
    convolutions and [in, out, k] transposed ones, the WaveNet layers
    weight-normed as parametrizations (original0 one); weights and biases
    normal (std 0.02) but the text encoder's at 1/sqrt(fan-in), the affine
    flow's translate and log_scale zero, norm weights one."""
    normal = _normal_gen(torch, seed, dev)
    h, f, w = cfg.dim, cfg.ffn, cfg.window_size

    def conv(name, c_out, c_in, k, bias=True, std=0.02):
        t = {name + ".weight": normal(c_out, c_in, k, std=std)}
        if bias:
            t[name + ".bias"] = normal(c_out)
        return t

    def normed(name, c_out, c_in, k):
        return {name + ".parametrizations.weight.original0": torch.ones(c_out, 1, 1, device=dev),
                name + ".parametrizations.weight.original1": normal(c_out, c_in, k),
                name + ".bias": normal(c_out)}

    def dds(p):
        t = {}
        for j in range(cfg.depth_separable_layers):
            t.update({**conv(f"{p}.convs_dilated.{j}", h, 1, cfg.duration_kernel),
                      **conv(f"{p}.convs_pointwise.{j}", h, h, 1),
                      **_ln_tensors(torch, f"{p}.norms_1.{j}", h, dev),
                      **_ln_tensors(torch, f"{p}.norms_2.{j}", h, dev)})
        return t

    t = {"text_encoder.embed_tokens.weight": normal(cfg.vocab, h, std=h ** -0.5),
         **conv("text_encoder.project", 2 * cfg.flow_size, h, 1)}
    for i in range(cfg.layers):
        p = f"text_encoder.encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[f"{p}attention.{n}.weight"] = normal(h, h, std=h ** -0.5)
            t[f"{p}attention.{n}.bias"] = normal(h)
        t.update({p + "attention.emb_rel_k": normal(1, 2 * w + 1, cfg.head_dim),
                  p + "attention.emb_rel_v": normal(1, 2 * w + 1, cfg.head_dim),
                  **_ln_tensors(torch, p + "layer_norm", h, dev),
                  **_ln_tensors(torch, p + "final_layer_norm", h, dev),
                  **conv(p + "feed_forward.conv_1", f, h, cfg.ffn_kernel,
                         std=(h * cfg.ffn_kernel) ** -0.5),
                  **conv(p + "feed_forward.conv_2", h, f, cfg.ffn_kernel,
                         std=(f * cfg.ffn_kernel) ** -0.5)})
    dp = "duration_predictor."
    half = cfg.depth_separable_channels // 2
    t.update({**conv(dp + "conv_pre", h, h, 1), **conv(dp + "conv_proj", h, h, 1),
              **dds(dp + "conv_dds"),
              dp + "flows.0.translate": torch.zeros(cfg.depth_separable_channels, 1, device=dev),
              dp + "flows.0.log_scale": torch.zeros(cfg.depth_separable_channels, 1, device=dev)})
    for i in range(1, cfg.duration_num_flows + 1):
        fp = f"{dp}flows.{i}."
        t.update({**conv(fp + "conv_pre", h, half, 1), **dds(fp + "conv_dds"),
                  **conv(fp + "conv_proj", half * (3 * cfg.duration_flow_bins - 1), h, 1)})
    for i in range(cfg.prior_num_flows):
        fp = f"flow.flows.{i}."
        t.update({**conv(fp + "conv_pre", h, cfg.flow_size // 2, 1),
                  **conv(fp + "conv_post", cfg.flow_size // 2, h, 1)})
        for j in range(cfg.prior_wavenet_layers):
            res = 2 * h if j < cfg.prior_wavenet_layers - 1 else h
            t.update({**normed(f"{fp}wavenet.in_layers.{j}", 2 * h, h, cfg.wavenet_kernel),
                      **normed(f"{fp}wavenet.res_skip_layers.{j}", res, h, 1)})
    ch = cfg.upsample_initial
    t.update(conv("decoder.conv_pre", ch, cfg.flow_size, 7))
    for i, k in enumerate(cfg.upsample_kernels):
        t.update(conv(f"decoder.upsampler.{i}", ch, ch // 2, k))  # [in, out, k]
        t[f"decoder.upsampler.{i}.bias"] = normal(ch // 2)
        ch //= 2
        for j, (rk, dil) in enumerate(zip(cfg.resblock_kernels, cfg.resblock_dilations)):
            rp = f"decoder.resblocks.{i * len(cfg.resblock_kernels) + j}."
            for d in range(len(dil)):
                t.update({**conv(f"{rp}convs1.{d}", ch, ch, rk),
                          **conv(f"{rp}convs2.{d}", ch, ch, rk)})
    t.update(conv("decoder.conv_post", 1, ch, 7, bias=False))
    return t


def hub_sentences(seed: int, n: int = HUB_SENTENCES, chars=SENTENCE_CHARS) -> list[str]:
    """``n`` seeded sentences of HUB_WORDS, their lengths spread over
    ``chars``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for target in np.linspace(*chars, n).round().astype(int):
        words: list = []
        while len(" ".join(words)) < target:
            words.append(str(rng.choice(HUB_WORDS)))
        out.append(" ".join(words)[:target].rstrip() or "a")
    return out


def marian_tokenizer_dir(path: str, vocab_size: int) -> str:
    """A fabricated Opus-MT tokenizer in ``path``: a unigram sentencepiece
    model of HUB_WORDS (the last two left out: unknown) and the letters, and
    a vocab.json that maps its pieces and ``w<i>`` fillers onto every id of
    ``vocab_size`` (``</s>`` 0, ``<unk>`` 1, ``<pad>`` the last)."""
    from dora_tpu_torch.models import spm

    os.makedirs(path, exist_ok=True)
    pieces = [("<unk>", 0.0, spm.TYPE_UNKNOWN), ("<s>", 0.0, spm.TYPE_CONTROL),
              ("</s>", 0.0, spm.TYPE_CONTROL), (spm.WORD_BOUNDARY, -4.0, spm.TYPE_NORMAL)]
    pieces += [(spm.WORD_BOUNDARY + w, -1.0 - 0.1 * i, spm.TYPE_NORMAL)
               for i, w in enumerate(HUB_WORDS[:-2])]
    pieces += [(c, -3.0 - 0.01 * i, spm.TYPE_NORMAL)
               for i, c in enumerate("abcdefghijklmnopqrstuvw")]
    with open(os.path.join(path, "source.spm"), "wb") as f:
        f.write(spm.build_model_proto(pieces))
    vocab = {"</s>": 0, "<unk>": 1, "<pad>": vocab_size - 1}
    for i, (piece, _, _) in enumerate(pieces[3:]):
        vocab[piece] = 2 + (i * 997) % (vocab_size - 3)
    used = set(vocab.values())
    vocab.update({f"w{i}": i for i in range(vocab_size) if i not in used})
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    return path


def serve_hub(torch, DB, LO, L, smi: str, seed: int, scratch: str, dev: str = "cuda",
              detector_size: str = "bench", translator_size: str = "bench",
              yolos_hf=YOLOS_SMALL, opus_hf=OPUS_MT_EN_DE, vits_hf=MMS_TTS_ENG,
              chars=SENTENCE_CHARS) -> None:
    """Phase 17: the yolo dataflow's node (:func:`yolo_node`), then the
    translation dataflow's nodes (:func:`translation_nodes`)."""
    yolo_node(torch, DB, LO, L, smi, seed, scratch, dev, detector_size, yolos_hf)
    torch.cuda.empty_cache()
    translation_nodes(torch, DB, LO, L, smi, seed + 1, scratch, dev, translator_size, opus_hf,
                      vits_hf, chars)
    torch.cuda.empty_cache()


def _no_kernels(what: str, launches: dict, n_plain: int) -> None:
    """None of the 11 kernels and none of their plain versions ran."""
    busy = {n: c for n, c in launches.items() if c}
    if busy or n_plain:
        raise Failed(f"{what} launched {busy} with {n_plain} plain calls; the hub models "
                     "reach none of the 11 kernels")


def _ticks_equal(what: str, node, per_tick: int, direct) -> None:
    """Each tick's sends (``per_tick`` of them, the outputs' sorted ids)
    equal ``direct(j)``, {output id: host array}, bit for bit."""
    import numpy as np

    if len(node.sent) % per_tick:
        raise Failed(f"{what}: {len(node.sent)} sends")
    for j in range(len(node.sent) // per_tick):
        want = direct(j)
        for out_id, data, meta in node.sent[j * per_tick:(j + 1) * per_tick]:
            ref = want[out_id]
            data = data.reshape([int(n) for n in meta["shape"]]) if "shape" in meta else data
            if data.dtype != ref.dtype or data.shape != ref.shape or not np.array_equal(data, ref):
                raise Failed(f"{what}: tick {j}'s {out_id} differs from a direct call")


def _host(outputs: dict, prefix: str = "op/") -> dict:
    return {prefix + k: v.detach().cpu().numpy() for k, v in outputs.items()}


def _rel_rms(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).sum().sqrt() / max(float((want ** 2).sum().sqrt()), 1e-30))


def _class_check(what: str, p16, p32, kept) -> tuple[int, int]:
    """Classes (argmax of the class probabilities ``p16`` / ``p32``, rows
    [n, C]) of the ``kept`` rows equal, except where f32's top two lie within
    NEAR_TIE of each other. Returns (compared, near-tie partings)."""
    c16, c32 = p16.argmax(-1), p32.argmax(-1)
    top2 = p32.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) < NEAR_TIE
    differ = (c16 != c32) & kept
    if bool((differ & ~tie).any()):
        rows = differ & ~tie
        raise Failed(f"{what}: {int(rows.sum())} kept detections' classes part from the f32 "
                     "plain path away from a near-tie")
    return int(kept.sum()), int(differ.sum())


def _timing_line(what: str, ticks, wall: float, n: int, smi: str, unit: str = "frames") -> None:
    ms = [1e3 * x for x in ticks]
    print(f"hub {what}: tick wall p50 {_pct(ms, 50):.2f} ms, p99 {_pct(ms, 99):.2f} ms, "
          f"max {max(ms):.2f} ms; {n / wall:.3f} {unit} a second synchronous ({n} in "
          f"{wall:.3f} s) [{smi}]", flush=True)


def yolo_node(torch, DB, LO, L, smi: str, seed: int, scratch: str, dev: str, size: str,
              yolos_hf: dict) -> None:
    """Phase 17 (a): the port's runtime node of the yolo example, ``op`` =
    ``make_detector``: the self-contained detector (``DORA_MODEL_SIZE``
    ``size``) over HUB_FRAMES seeded frames, then the YOLOS branch (seeded
    tensors at ``yolos_hf`` under the checkpoint's names through
    ``map_params``) over as many frames at its resolution. Each tick's
    boxes, classes and scores equal the operator's step called directly;
    the pipelined run equals the synchronous one; the classes of the
    detections the f32 plain path keeps equal the served (bf16) ones but at
    near-ties, the heads' logits (the detector's objectness and classes,
    YOLOS's classes) within VIT_REL_RMS of f32, and the scores' and boxes'
    errors are stated; none of the 11 kernels and no plain version
    runs."""
    import numpy as np

    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.models import detection
    from dora_tpu_torch.models.hf import yolos
    from dora_tpu_torch.nodehub import ops
    from dora_tpu_torch.tpu.fuse import FusedGraph

    desc = Descriptor.parse({"nodes": [
        {"id": "camera", "path": "module:dora_tpu.nodehub.camera", "outputs": ["image"]},
        {"id": "detector", "path": "module:dora_tpu_torch.runtime",
         "args": "--operator op=dora_tpu_torch.nodehub.ops:make_detector",
         "inputs": {"op/image": {"source": "camera/image", "queue_size": 1}},
         "outputs": ["op/boxes", "op/scores", "op/classes"]},
        {"id": "plot", "path": "module:dora_tpu.nodehub.plot",
         "inputs": {"image": "camera/image", "boxes": "detector/op/boxes"}},
        # the example's plot reads the boxes; a recorder takes the rest here
        {"id": "recorder", "path": "module:dora_tpu.nodehub.record",
         "inputs": {"scores": "detector/op/scores", "classes": "detector/op/classes"}}]})
    knobs = dict(DORA_MODEL_SIZE=size, DORA_HF_CHECKPOINT=None, DORA_CHECKPOINT=None,
                 DORA_PARAM_DTYPE=None, DORA_DETECT_THRESHOLD=None, DORA_DETECT_TOPK=None)
    rng = np.random.default_rng(seed)

    # the self-contained detector through make_detector
    t = time.perf_counter()
    with _env(**knobs):
        graph = FusedGraph.build(desc.node("detector"), desc, device=dev)
    cfg = detection.DetectorConfig.tiny() if size == "tiny" else detection.DetectorConfig()
    params = graph.operators["op"].init_state
    frames = [rng.integers(0, 256, size=(cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
              for _ in range(HUB_FRAMES)]
    first = (torch.from_numpy(frames[0]).to(dev).float() / 255.0)[None]
    scale = DETECT_LOGIT_STD / float(detection.forward(params, cfg, first)[..., 4:].std())
    for head in params["heads"].values():
        head["out"][4:] *= scale
    torch.cuda.synchronize()
    print(f"hub (a) detector: make_detector built DetectorConfig (DORA_MODEL_SIZE={size}: "
          f"{cfg.image_size} x {cfg.image_size}, widths {list(cfg.widths)}, {cfg.num_classes} "
          f"classes, {cfg.max_detections} detections) in {time.perf_counter() - t:.2f} s; its "
          f"heads' logit rows x {scale:.1f} (logit std {DETECT_LOGIT_STD} on the first frame) "
          f"[{smi}]", flush=True)
    _detector_runs(torch, DB, LO, L, smi, "(a) detector", graph, frames,
                   lambda img: detection.forward(params, cfg, img), scratch,
                   lambda p: _detector_probs(torch, cfg, p))
    # what the fixed-shape postprocess (top-K, K - 1 suppression steps) costs
    walls = {"forward": [], "postprocess": []}
    for f in frames:
        img = (torch.from_numpy(f).to(dev).float() / 255.0)[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = detection.forward(params, cfg, img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        detection.postprocess(cfg, preds)
        torch.cuda.synchronize()
        walls["forward"].append(1e3 * (t1 - t0))
        walls["postprocess"].append(1e3 * (time.perf_counter() - t1))
    share = _device_busy(torch, lambda: detection.postprocess(cfg, preds),
                         os.path.join(scratch, f"trace-hub-{os.getpid()}"))
    print(f"hub (a) detector split: forward p50 {_pct(walls['forward'], 50):.2f} ms, "
          f"postprocess (top-{cfg.max_detections}, {cfg.max_detections - 1} suppression steps) "
          f"p50 {_pct(walls['postprocess'], 50):.2f} ms (host clock, each ending in a sync); "
          f"the postprocess alone under profiling.start_capture: {share} [{smi}]", flush=True)

    # YOLOS through yolos_operator, as make_detector builds it after yolos.load
    ycfg = yolos.YolosConfig.from_hf(yolos_hf)
    t = time.perf_counter()
    tensors = yolos_tensors(torch, ycfg, seed + 1, dev)
    n_params = sum(v.numel() for v in tensors.values())
    yparams = yolos.map_params(tensors, ycfg)
    del tensors
    with _env(**{**knobs, "DORA_MODEL_SIZE": None}):
        op = ops.yolos_operator(ycfg, yparams)
    with _prebuilt({"dora_tpu_torch.nodehub.ops:make_detector": op}):
        ygraph = FusedGraph.build(desc.node("detector"), desc, device=dev)
    torch.cuda.synchronize()
    h, w = ycfg.image_size
    print(f"hub (a) YOLOS: {ycfg.layers} layers x {ycfg.dim} ({ycfg.heads} heads, ffn "
          f"{ycfg.ffn}), {ycfg.n_patches} patches + {ycfg.n_det} detection tokens at {h} x {w}, "
          f"{ycfg.n_labels} labels ({n_params / 1e6:.1f} M), seeded random under the "
          f"checkpoint's names through map_params in {time.perf_counter() - t:.2f} s [{smi}]",
          flush=True)
    yframes = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(HUB_FRAMES)]

    def yolos_forward(img):
        return yolos.forward(yparams, ycfg, yolos.preprocess(img, ycfg))

    threshold = 0.5  # yolos_operator's default DORA_DETECT_THRESHOLD
    _detector_runs(torch, DB, LO, L, smi, "(a) YOLOS", ygraph, yframes, yolos_forward, scratch,
                   lambda out: _yolos_probs(torch, out, threshold))


def _detector_probs(torch, cfg, preds):
    """The self-contained detector's [cells, C] class scores (objectness x
    class), its [cells, 4] boxes, the [cells] mask of those its
    postprocess keeps (top-K, over the threshold, not suppressed) and its
    objectness and class logits."""
    from dora_tpu_torch.models import detection

    probs = torch.sigmoid(preds[0, :, 4:5]) * torch.sigmoid(preds[0, :, 5:])
    _, idx = detection.top_k(probs.max(-1).values, cfg.max_detections)
    kept = torch.zeros(probs.shape[0], dtype=torch.bool, device=probs.device)
    kept[idx.long()] = detection.postprocess(cfg, preds[0])["scores"] > 0
    return probs, preds[0, :, :4], kept, preds[0, :, 4:]


def _yolos_probs(torch, out, threshold: float):
    """YOLOS's [n_det, labels] class probabilities, its [n_det, 4] boxes,
    the mask of the slots it keeps (score at the threshold or over) and its
    class logits."""
    logits, boxes = out
    probs = torch.softmax(logits[0], dim=-1)[:, :-1]
    return probs, boxes[0], probs.max(-1).values >= threshold, logits


def _detector_runs(torch, DB, LO, L, smi, what, graph, frames, forward, scratch, decode):
    """One detector node over ``frames``: ticks against direct calls, the
    pipelined run, the f32 plain path, the timings and the busy share."""
    import numpy as np

    op = graph.operators["op"]
    params = op.init_state
    events = [_event("op/image", f) for f in frames]
    on_dev = [torch.from_numpy(f).to(graph.device) for f in frames]
    ref = [_host(op.step(params, {"image": img})[1]) for img in on_dev]
    torch.cuda.synchronize()
    node, wall, launches, n_plain, ticks = _run_node(torch, DB, LO, graph, events, depth=0,
                                                     timed=True)
    _ticks_equal(f"{what} node", node, 3, lambda j: ref[j])
    _no_kernels(f"the {what} node", launches, n_plain)
    kept_rows = [int((r["op/scores"] > 0).sum()) for r in ref]
    print(f"hub {what} node: {len(ticks)} ticks, each tick's boxes, classes and scores equal "
          f"to the operator's step called directly; detections kept a frame {kept_rows}; none "
          f"of the 11 kernels and no plain version ran [{smi}]", flush=True)
    _timing_line(f"{what} node", ticks, wall, len(frames), smi)
    walls = []
    for _ in range(2):
        with _env(DORA_PIPELINE_DEPTH=None, DORA_FETCH_EVERY=None):
            pnode, pwall, _, _, _ = _run_node(torch, DB, LO, graph, events, None, None)
        _same_sends(f"{what} node pipelined", pnode.sent, node.sent)
        walls.append(pwall)
    print(f"hub {what} node pipelined (default depth): the same sends bit for bit; frames a "
          f"second {[round(len(frames) / w, 3) for w in walls]} against "
          f"{len(frames) / wall:.3f} synchronous [{smi}]", flush=True)

    compared = parted = 0
    sq = {"raw": [0.0, 0.0], "boxes": [0.0, 0.0]}
    worst = 0.0
    for i, img in enumerate(on_dev):
        image = (img.float() / 255.0)[None]
        p16, b16, _, r16 = decode(forward(image))
        p32, b32, kept, r32 = decode(_f32(torch, L, lambda: forward(image)))
        c, pt = _class_check(f"{what} frame {i}", p16.float(), p32.float(), kept)
        compared, parted = compared + c, parted + pt
        pairs = [("raw", r16, r32)]
        if c:
            s16, s32 = p16.float().max(-1).values[kept], p32.max(-1).values[kept]
            worst = max(worst, float((s16 - s32).abs().max()))
            pairs.append(("boxes", b16[kept], b32[kept]))
        for key, a, b in pairs:
            sq[key][0] += float(((a.double() - b.double()) ** 2).sum())
            sq[key][1] += float((b.double() ** 2).sum())
    if not compared:
        raise Failed(f"{what}: the f32 plain path kept no detection in {len(frames)} frames, "
                     "so nothing was compared")
    rms = {k: (n / max(d, 1e-30)) ** 0.5 for k, (n, d) in sq.items()}
    print(f"hub {what} agreement: bf16 served against the f32 plain path over {compared} kept "
          f"detections of {len(frames)} frames: classes equal but {parted} near-tie partings "
          f"(f32 top two within {NEAR_TIE}); the heads' logits rel RMS {rms['raw']:.3e} "
          f"(bound {VIT_REL_RMS}); max |dscore| {worst:.3e}; boxes rel RMS {rms['boxes']:.3e} "
          f"[{smi}]", flush=True)
    if not rms["raw"] <= VIT_REL_RMS:
        raise Failed(f"{what}: the heads' logits are {rms['raw']:.3e} (rel RMS) from f32")
    one = [events[0]]
    share = _device_busy(torch, lambda: _run_node(torch, DB, LO, graph, one, depth=0),
                         os.path.join(scratch, f"trace-hub-{os.getpid()}"))
    print(f"hub {what} device plane: one tick under profiling.start_capture: {share} [{smi}]",
          flush=True)


def translation_nodes(torch, DB, LO, L, smi: str, seed: int, scratch: str, dev: str,
                      size: str, opus_hf: dict, vits_hf: dict, chars) -> None:
    """Phase 17 (b): the translation dataflow's nodes over HUB_SENTENCES
    seeded sentences: the runtime nodes ``make_translator`` into
    ``make_tts`` (``DORA_MODEL_SIZE`` ``size``), then the port's Opus node
    (``nodehub.translator.serve``) at ``opus_hf`` greedy and with
    DORA_SPEC_DECODE's speculation, then ``make_tts``'s VITS branch at
    ``vits_hf`` (noise_scale 0). Each tick's output equals a direct call;
    translator tokens part from the f32 plain path only at near-ties;
    speculative tokens equal greedy ones; VITS's durations equal the f32
    plain path's (``vits.synthesize``); none of the 11 kernels and no plain
    version runs."""
    import numpy as np

    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.models import tokenizer, translation, tts
    from dora_tpu_torch.tpu.fuse import FusedGraph

    sentences = hub_sentences(seed, chars=chars)
    desc = Descriptor.parse({"nodes": [
        {"id": "terminal-input", "path": "dynamic", "outputs": ["data"]},
        {"id": "translator", "path": "module:dora_tpu_torch.runtime",
         "args": "--operator op=dora_tpu_torch.nodehub.ops:make_translator",
         "inputs": {"op/text": {"source": "terminal-input/data", "queue_size": 1}},
         "outputs": ["op/tokens"]},
        {"id": "tts", "path": "module:dora_tpu_torch.runtime",
         "args": "--operator op=dora_tpu_torch.nodehub.ops:make_tts",
         "inputs": {"op/text": {"source": "translator/op/tokens", "queue_size": 1}},
         "outputs": ["op/audio"]},
        {"id": "speaker", "path": "module:dora_tpu.nodehub.speaker",
         "inputs": {"audio": "tts/op/audio"}}]})
    knobs = dict(DORA_MODEL_SIZE=size, DORA_HF_CHECKPOINT=None, DORA_CHECKPOINT=None,
                 DORA_PARAM_DTYPE=None, DORA_MAX_NEW_TOKENS=None, DORA_TTS_STYLE=None,
                 DORA_SPEC_DECODE=None)
    t = time.perf_counter()
    with _env(**knobs):
        tr_graph = FusedGraph.build(desc.node("translator"), desc, device=dev)
        tts_graph = FusedGraph.build(desc.node("tts"), desc, device=dev)
    torch.cuda.synchronize()
    tcfg = (translation.TranslatorConfig.tiny() if size == "tiny"
            else translation.TranslatorConfig())
    scfg = tts.TTSConfig.tiny() if size == "tiny" else tts.TTSConfig()
    tr_op, tts_op = tr_graph.operators["op"], tts_graph.operators["op"]
    print(f"hub (b) translator + TTS nodes: make_translator ({tcfg.enc_layers} + "
          f"{tcfg.dec_layers} layers x {tcfg.dim}, vocab {tcfg.vocab}) and make_tts "
          f"({tcfg.enc_layers} + {scfg.dec_layers} layers x {scfg.dim}, {scfg.max_text} tokens "
          f"-> {scfg.max_samples} samples) at DORA_MODEL_SIZE={size} in "
          f"{time.perf_counter() - t:.2f} s; sentences of {[len(s) for s in sentences]} "
          f"characters [{smi}]", flush=True)

    texts = [np.frombuffer(s.encode(), dtype=np.uint8) for s in sentences]
    tr_ref = [_host(tr_op.step(tr_op.init_state, {"text": torch.from_numpy(x).to(dev)})[1])
              for x in texts]
    node, wall, launches, n_plain, ticks = _run_node(
        torch, DB, LO, tr_graph, [_event("op/text", x) for x in texts], depth=0, timed=True)
    _ticks_equal("translator node", node, 1, lambda j: tr_ref[j])
    _no_kernels("the translator node", launches, n_plain)
    max_new = tr_ref[0]["op/tokens"].shape[0]
    _timing_line("(b) translator node", ticks, wall, len(texts) * max_new, smi, "tokens")
    print(f"hub (b) translator node: {len(ticks)} ticks equal make_translator's step called "
          f"directly, {1e3 * wall / len(texts):.2f} ms a sentence ({max_new} tokens each); none "
          f"of the 11 kernels and no plain version ran [{smi}]", flush=True)
    tokens = [s[1] for s in node.sent]
    parts = []
    bos = tokenizer.BOS % tcfg.vocab
    for j, x in enumerate(texts):
        src = (torch.from_numpy(x).to(dev).to(torch.int32) % tcfg.vocab)[: tcfg.max_src]
        src = torch.nn.functional.pad(src, (0, tcfg.max_src - src.shape[0]),
                                      value=tokenizer.PAD % tcfg.vocab)[None]
        served = tokens[j].tolist()
        ref32 = _f32(torch, L, lambda: translation.translate(tr_op.init_state, tcfg, src, bos,
                                                             max_new))[0].tolist()
        at = _first_parting(served, ref32, max_new)
        parts.append(at)
        if at < max_new:
            logits = _f32(torch, L, lambda: _translator_logits(
                torch, L, tr_op.init_state, tcfg, src, bos, served[:at]))
            _near_tie(f"translator sentence {j}", logits, served[at], ref32[at], at, smi)
    print(f"hub (b) translator agreement: bf16 served against the f32 plain path, first "
          f"parting at {parts} of {max_new} [{smi}]", flush=True)

    tts_events = [_event("op/text", tok) for tok in tokens]
    tts_ref = [_host(tts_op.step(tts_op.init_state, {"text": torch.from_numpy(tok).to(dev)})[1])
               for tok in tokens]
    node, wall, launches, n_plain, ticks = _run_node(torch, DB, LO, tts_graph, tts_events,
                                                     depth=0, timed=True)
    _ticks_equal("TTS node", node, 1, lambda j: tts_ref[j])
    _no_kernels("the TTS node", launches, n_plain)
    _timing_line("(b) TTS node", ticks, wall, len(tokens), smi, "sentences")
    rms = []
    for tok, ref in zip(tokens, tts_ref):
        w32 = _f32(torch, L, lambda: tts_op.step(tts_op.init_state,
                                                 {"text": torch.from_numpy(tok).to(dev)})[1])
        rms.append(_rel_rms(torch.from_numpy(ref["op/audio"]), w32["audio"].cpu()))
    audio_s = len(tokens) * scfg.max_samples / scfg.sample_rate
    print(f"hub (b) TTS node: {len(ticks)} ticks equal make_tts's step called directly; "
          f"{audio_s / wall:.2f} audio seconds a wall second ({scfg.max_samples} samples a "
          f"sentence); bf16 waveform against the f32 plain path rel RMS max {max(rms):.3e} "
          f"[{smi}]", flush=True)
    if not all(np.isfinite(r) for r in rms):
        raise Failed("the TTS node's waveform is not finite")
    for what, graph, events in (("translator", tr_graph, [_event("op/text", texts[-1])]),
                                ("TTS", tts_graph, tts_events[-1:])):
        share = _device_busy(torch, lambda: _run_node(torch, DB, LO, graph, events, depth=0),
                             os.path.join(scratch, f"trace-hub-{os.getpid()}"))
        print(f"hub (b) {what} device plane: one tick on the longest sentence under "
              f"profiling.start_capture: {share} [{smi}]", flush=True)
    del tr_graph, tts_graph, tr_op, tts_op
    torch.cuda.empty_cache()

    opus_node(torch, DB, LO, L, smi, seed + 1, scratch, dev, opus_hf, sentences)
    torch.cuda.empty_cache()
    vits_node(torch, DB, LO, L, smi, seed + 2, scratch, dev, vits_hf, sentences)


def _translator_logits(torch, L, params, cfg, src, bos: int, prefix: list):
    """The self-contained translator's next-token logits [vocab] after
    ``prefix``: ``translation.translate``'s loop fed ``prefix``."""
    from dora_tpu_torch.models import translation
    from dora_tpu_torch.models.asr import _decoder_forward, _encoder_kv

    dev = src.device
    dtype = L.compute_dtype(dev)
    enc_kv = _encoder_kv(params, cfg, translation.encode(params, cfg, src))
    shape = (1, cfg.heads, cfg.max_tokens, cfg.head_dim)
    caches = {str(i): {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}
              for i in range(cfg.dec_layers)}
    embed = params["embed"].to(dtype)
    rope = L.rope_table(cfg.max_tokens, cfg.head_dim, device=dev)
    slots = torch.arange(cfg.max_tokens, device=dev)
    h = None
    for pos, token in enumerate([bos] + prefix):
        x = embed[torch.tensor([token], device=dev)][:, None, :]
        h, caches = _decoder_forward(params, cfg, x, enc_kv,
                                     torch.full((1, 1), pos, device=dev),
                                     (slots <= pos)[None, None, None, :], caches, pos, rope)
    return (h[:, -1] @ embed.T).float()[0]


def _near_tie(what: str, logits, served: int, ref: int, at: int, smi: str) -> None:
    """The served and the f32 token are both within NEAR_TIE of the f32
    logits' maximum."""
    top = float(logits.max())
    da, db = top - float(logits[served]), top - float(logits[ref])
    print(f"hub {what}: parts from the f32 plain path at token {at} ({served} against {ref}): "
          f"the served token {da:.4e} and the f32 one {db:.4e} below the f32 maximum (bound "
          f"{NEAR_TIE}) [{smi}]", flush=True)
    if not (da <= NEAR_TIE and db <= NEAR_TIE):
        raise Failed(f"{what} parts from the f32 path away from a near-tie")


def opus_node(torch, DB, LO, L, smi: str, seed: int, scratch: str, dev: str, opus_hf: dict,
              sentences: list) -> None:
    """Phase 17 (b), the Opus node: ``nodehub.translator.serve`` over a
    scripted node, on Marian at ``opus_hf`` (seeded tensors under the
    checkpoint's names through ``map_params``, a fabricated tokenizer),
    greedy and speculative, with the node's defaults (64 new tokens, 64
    source pieces)."""
    import pyarrow as pa

    from dora_tpu_torch.models import spec_decode
    from dora_tpu_torch.models.hf import marian
    from dora_tpu_torch.nodehub import translator

    max_new, max_src = 64, 64  # the node's defaults
    cfg = marian.MarianConfig.from_hf(opus_hf, max_tokens=max_new + 1 + spec_decode.spec_headroom())
    t = time.perf_counter()
    tensors = marian_tensors(torch, cfg, seed, dev)
    n_params = sum(v.numel() for v in tensors.values())
    params = marian.map_params(tensors, cfg)
    del tensors
    tok = marian.MarianTokenizer(marian_tokenizer_dir(os.path.join(scratch, "opus-tokenizer"),
                                                      cfg.vocab))
    torch.cuda.synchronize()
    print(f"hub (b) Opus node: Marian {cfg.enc_layers} + {cfg.dec_layers} layers x {cfg.dim} "
          f"({cfg.heads} heads, ffn {cfg.ffn}, vocab {cfg.vocab}; {n_params / 1e6:.1f} M), "
          f"seeded random under the checkpoint's names through map_params, a fabricated "
          f"sentencepiece model and vocab.json, in {time.perf_counter() - t:.2f} s [{smi}]",
          flush=True)
    srcs = [translator.encode_source(tok, cfg, s, max_src, dev) for s in sentences]
    greedy = [marian.translate(params, cfg, s, max_new, src_mask=m)[0].tolist() for s, m in srcs]
    spec = [marian.translate_speculative(params, cfg, s, max_new, src_mask=m) for s, m in srcs]
    for j, (toks, passes) in enumerate(spec):
        if toks[0].tolist() != greedy[j]:
            raise Failed(f"Opus sentence {j}: speculative tokens differ from greedy ones")
    passes = sum(p for _, p in spec)

    results = {}
    for what, speculative in (("greedy", False), ("DORA_SPEC_DECODE=1", True)):
        fn = translator.translate_fn(cfg, params, tok, max_new, max_src, speculative)
        node = _OpNode([_event("text", pa.array([s])) for s in sentences])
        plain_calls = _PlainCalls(DB, LO)
        _reset_launches(DB, LO)
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            translator.serve(node, fn)
            torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t
            launches = _launches(DB, LO)
            plain_calls.restore()
        _no_kernels(f"the Opus node ({what})", launches, plain_calls.n)
        got = [list(s[1]) for s in node.sent]
        want = [[tok.decode(g[: g.index(cfg.eos_token)] if cfg.eos_token in g else g)]
                for g in greedy]
        if got != want:
            raise Failed(f"the Opus node ({what}) answered {got}, the direct calls {want}")
        results[what] = wall
    print(f"hub (b) Opus node: greedy and DORA_SPEC_DECODE=1 each answer every sentence as the "
          f"direct calls do (speculative tokens equal greedy ones, {max_new} a sentence); "
          f"{1e3 * results['greedy'] / len(sentences):.2f} ms a sentence greedy, "
          f"{1e3 * results['DORA_SPEC_DECODE=1'] / len(sentences):.2f} ms speculative; "
          f"{len(sentences) * max_new / results['greedy']:.1f} tokens a second greedy, "
          f"{len(sentences) * max_new / results['DORA_SPEC_DECODE=1']:.1f} speculative "
          f"({len(sentences) * max_new / passes:.3f} tokens a pass); none of the 11 kernels "
          f"and no plain version ran; translations of {[len(s[1][0]) for s in node.sent]} "
          f"characters, {len({t for g in greedy for t in g})} distinct tokens [{smi}]",
          flush=True)
    parts = []
    for j, (s, m) in enumerate(srcs):
        ref32 = _f32(torch, L, lambda: marian.translate(params, cfg, s, max_new,
                                                        src_mask=m))[0].tolist()
        at = _first_parting(greedy[j], ref32, max_new)
        parts.append(at)
        if at < max_new:
            real = s[:, : int(m.sum())]
            dec = torch.tensor([[cfg.decoder_start_token] + greedy[j][:at]], device=dev)
            logits = _f32(torch, L, lambda: marian.forward(params, cfg, real, dec))[0, -1]
            _near_tie(f"Opus sentence {j}", logits, greedy[j][at], ref32[at], at, smi)
    print(f"hub (b) Opus agreement: bf16 greedy against the f32 plain path, first parting at "
          f"{parts} of {max_new} [{smi}]", flush=True)
    s, m = srcs[-1]
    share = _device_busy(torch, lambda: marian.translate(params, cfg, s, max_new, src_mask=m),
                         os.path.join(scratch, f"trace-hub-{os.getpid()}"))
    print(f"hub (b) Opus device plane: one greedy translation of the longest sentence under "
          f"profiling.start_capture: {share} [{smi}]", flush=True)


def vits_node(torch, DB, LO, L, smi: str, seed: int, scratch: str, dev: str, vits_hf: dict,
              sentences: list) -> None:
    """Phase 17 (b), the VITS node: the runtime node of the translation
    example's ``tts`` with ``make_tts``'s VITS branch (``vits_operator`` over
    seeded tensors at ``vits_hf`` through ``map_params``, a fabricated
    vocabulary, noise_scale 0), a host operator, over the sentences: each
    tick's audio equals the operator's step called directly; the durations
    equal the f32 plain path's (``vits.synthesize``'s host durations), the
    waveform's distance from it stated as rel RMS."""
    import dataclasses

    import numpy as np

    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.models.hf import vits
    from dora_tpu_torch.nodehub import ops
    from dora_tpu_torch.tpu.fuse import FusedGraph

    cfg = dataclasses.replace(vits.VitsConfig.from_hf(vits_hf), noise_scale=0.0)
    t = time.perf_counter()
    tensors = vits_tensors(torch, cfg, seed, dev)
    n_params = sum(v.numel() for v in tensors.values())
    params = vits.map_params(tensors, cfg)
    del tensors
    vocab = {c: i + 1 for i, c in enumerate(VITS_CHARS)}
    op = ops.vits_operator(cfg, params, vocab)
    desc = Descriptor.parse({"nodes": [
        {"id": "opus", "path": "module:dora_tpu_torch.nodehub.translator", "outputs": ["text"]},
        {"id": "tts", "path": "module:dora_tpu_torch.runtime",
         "args": "--operator op=dora_tpu_torch.nodehub.ops:make_tts",
         "inputs": {"op/text": {"source": "opus/text", "queue_size": 1}},
         "outputs": ["op/audio"]},
        {"id": "speaker", "path": "module:dora_tpu.nodehub.speaker",
         "inputs": {"audio": "tts/op/audio"}}]})
    with _prebuilt({"dora_tpu_torch.nodehub.ops:make_tts": op}):
        graph = FusedGraph.build(desc.node("tts"), desc, device=dev)
    torch.cuda.synchronize()
    print(f"hub (b) VITS node: {cfg.layers} layers x {cfg.dim}, stochastic duration "
          f"{cfg.use_stochastic_duration}, upsample {list(cfg.upsample_rates)} "
          f"({n_params / 1e6:.1f} M), seeded random under the checkpoint's names through "
          f"map_params in {time.perf_counter() - t:.2f} s; noise_scale 0 [{smi}]", flush=True)
    import pyarrow as pa

    events = [_event("op/text", pa.array([s])) for s in sentences]
    ref = [_host(op.step(params, {"text": torch.from_numpy(
        np.frombuffer(s.encode(), dtype=np.uint8).copy()).to(dev)})[1]) for s in sentences]
    node, wall, launches, n_plain, ticks = _run_node(torch, DB, LO, graph, events, depth=0,
                                                     timed=True)
    _ticks_equal("VITS node", node, 1, lambda j: ref[j])
    _no_kernels("the VITS node", launches, n_plain)
    samples = sum(r["op/audio"].shape[0] for r in ref)
    _timing_line("(b) VITS node", ticks, wall, len(sentences), smi, "sentences")
    print(f"hub (b) VITS node: {len(ticks)} ticks equal vits_operator's step called directly; "
          f"{samples / cfg.sampling_rate / wall:.2f} audio seconds a wall second "
          f"({samples / cfg.sampling_rate:.2f} s of audio), {1e3 * wall / len(sentences):.2f} ms "
          f"a sentence [{smi}]", flush=True)

    differ, tf32_differ, tokens, rms = 0, 0, 0, []
    for s, r in zip(sentences, ref):
        ids = torch.tensor([ops.vits_text_ids(s.encode(), vocab, cfg.vocab)], device=dev)
        hidden, _, _ = vits.encode_text(params, cfg, ids)
        plain = vits.durations(vits.predict_log_duration(params, cfg, hidden), cfg.speaking_rate)
        served = _served_durations(torch, vits, params, cfg, ids, tf32=False)
        differ += int((served != plain[0]).sum())
        tf32_differ += int((_served_durations(torch, vits, params, cfg, ids, tf32=True)
                            != plain[0]).sum())
        tokens += served.shape[0]
        wave = vits.synthesize(params, cfg, ids)[0].cpu()
        got = torch.from_numpy(r["op/audio"])
        if got.shape != wave.shape:
            raise Failed(f"VITS: the served waveform has {got.shape[0]} samples, the f32 plain "
                         f"path {wave.shape[0]}")
        rms.append(_rel_rms(got, wave))
    print(f"hub (b) VITS agreement: durations of {tokens} tokens against the f32 plain path "
          f"(vits.synthesize's host durations): {differ} differ; with TF32 allowed "
          f"(torch's default for cuDNN convolutions) {tf32_differ} would; waveform rel RMS max "
          f"{max(rms):.3e} [{smi}]", flush=True)
    if differ:
        raise Failed(f"VITS: {differ} durations differ from the f32 plain path's")
    share = _device_busy(torch, lambda: _run_node(torch, DB, LO, graph, events[-1:], depth=0),
                         os.path.join(scratch, f"trace-hub-{os.getpid()}"))
    print(f"hub (b) VITS device plane: one tick on the longest sentence under "
          f"profiling.start_capture: {share} [{smi}]", flush=True)


def _served_durations(torch, vits, params, cfg, ids, tf32: bool):
    """The bucketed serving path's per-token durations (its stage 1), with
    TF32 allowed or not."""
    import numpy as np

    t = ids.shape[1]
    padded = torch.zeros((1, vits._bucket(t, vits.TEXT_BUCKETS)), dtype=torch.long,
                         device=ids.device)
    padded[0, :t] = ids[0]
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            _, cum, _, _ = vits._duration_stage(params, cfg, padded, t, cfg.speaking_rate)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    cum = cum[:t].cpu().numpy().astype(np.int64)
    return np.diff(cum, prepend=0)


# ---------------------------------------------------------------------------
# phase 18: training and the parallel tier
# ---------------------------------------------------------------------------

#: phase 18 (a): the bench_2b VLM's batch, text tokens and Adam steps
TRAIN_BATCH = 2
TRAIN_TEXT = 64
TRAIN_STEPS = 5
TRAIN_LR = 1e-5
# Step 1 through kernel 11 against the same step with DORA_FLASH_ATTENTION=0
# (the dense einsum), both in bf16: the kernel keeps an f32 softmax and feeds
# p to P.V as hi + lo bf16, the einsum rounds p and its backward to bf16
# (PERF.md, the ViT differs by ~1 % RMS), so the two part by rounding, most
# in the ViT's wk, whose gradient nearly cancels under near-uniform weights
# (seen on an H100: cosine 0.9955, median 0.99992; PERF.md). So each leaf's
# gradient is also held to the f32 step (flash off, compute dtype f32): its
# relative L2 distance within RMS_MARGIN x the flash-off bf16 path's, or
# within TRAIN_REL_FLOOR.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_COS = 0.99
TRAIN_REL_FLOOR = 1e-2
#: phase 18 (b): SGD on the TTS at the bench widths of phase 17
TTS_STEPS = 5
TTS_LR = 0.05
#: phase 18 (c): new tokens of generate_tp against generate
TP_MAX_NEW = 32
#: ring and Ulysses at sp 1 against the dense einsum, f32 (rel max err)
SP1_REL_TOL = 1e-5


def _train_grads(torch, vlm, cfg, params, batch) -> tuple[float, dict]:
    """One loss and its gradients; the leaves' .grad cleared after."""
    leaves = dict(_named_leaves(params))
    for p in leaves.values():
        p.grad = None
    loss = vlm.loss_fn(params, cfg, batch)
    loss.backward()
    grads = {k: p.grad for k, p in leaves.items()}
    for p in leaves.values():
        p.grad = None
    return float(loss.detach()), grads


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _grad_distances(torch, grads, ref) -> dict:
    """Per leaf: (cosine, relative L2 distance) of ``grads`` to ``ref``."""
    out = {}
    for k, g in grads.items():
        a, b = g.flatten().double(), ref[k].flatten().double()
        out[k] = (float(torch.nn.functional.cosine_similarity(a, b, dim=0)),
                  float((a - b).norm() / b.norm()))
    return out


def train_vlm(torch, DB, LO, smi: str, seed: int, scratch: str, dev: str = "cuda",
              size: str = "bench") -> int:
    """Phase 18 (a): ``vlm.make_train_step`` on bench_2b (f32 master
    weights, Adam) at full width. Step 1's loss and gradients through
    kernel 11 (32 ViT + 28 LM launches, its backward in plain PyTorch)
    against the same step with DORA_FLASH_ATTENTION=0 and against the f32
    step; every leaf's gradient finite and nonzero; then TRAIN_STEPS Adam
    steps on one seeded batch, the launches exact and the loss falling.
    Returns the steps' launches."""
    import functools

    from dora_tpu_torch.models import layers as L
    from dora_tpu_torch.models import vlm

    cfg = vlm.VLMConfig.bench_2b() if size == "bench" else vlm.VLMConfig.tiny()
    text = TRAIN_TEXT if size == "bench" else 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = vlm.init_params(cfg, seed=seed, device=dev)
    n_params = vlm.param_count(params)
    for leaf in vlm.param_leaves(params):
        leaf.requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {"images": torch.rand((TRAIN_BATCH, cfg.image_size, cfg.image_size, 3),
                                  generator=gen, device=dev),
             "tokens": torch.randint(0, cfg.vocab, (TRAIN_BATCH, text), generator=gen,
                                     device=dev)}
    torch.cuda.synchronize()
    per_step = cfg.vision_layers + cfg.layers
    print(f"train (a) weights: {size} VLM, {n_params / 1e9:.3f} B f32 parameters (ViT "
          f"{cfg.vision_layers} x {cfg.vision_dim}, LM {cfg.layers} x {cfg.dim}), batch "
          f"{TRAIN_BATCH} x ({cfg.n_patches} image + {text} text) tokens, in "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    plain = _PlainCalls(DB, LO)
    try:
        with _env(DORA_FLASH_ATTENTION=None):
            _reset_launches(DB, LO)
            loss_k, grads_k = _train_grads(torch, vlm, cfg, params, batch)
            launched = _launches(DB, LO)
        if launched["flash_attention"] != per_step or plain.n:
            raise Failed(f"train (a): step 1 launched flash_attention "
                         f"{launched['flash_attention']} times (want {per_step}), plain calls "
                         f"{plain.n}")
        others = {k: n for k, n in launched.items() if n and k != "flash_attention"}
        if others:
            raise Failed(f"train (a): step 1 launched other kernels: {others}")
        bad = [k for k, g in grads_k.items()
               if g is None or not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0]
        if bad:
            raise Failed(f"train (a): leaves without a finite nonzero gradient: {bad[:8]} "
                         f"({len(bad)} of {len(grads_k)})")
        with _env(DORA_FLASH_ATTENTION="0"):
            _reset_launches(DB, LO)
            loss_d, grads_d = _train_grads(torch, vlm, cfg, params, batch)
            loss_32, grads_32 = _f32(torch, L, lambda: _train_grads(torch, vlm, cfg, params,
                                                                    batch))
            if _launches(DB, LO)["flash_attention"]:
                raise Failed("train (a): DORA_FLASH_ATTENTION=0 still launched kernel 11")
    finally:
        plain.restore()
    cos = {k: c for k, (c, _) in _grad_distances(torch, grads_k, grads_d).items()}
    worst = min(cos, key=cos.get)
    to32_k = _grad_distances(torch, grads_k, grads_32)
    to32_d = _grad_distances(torch, grads_d, grads_32)
    del grads_k, grads_d, grads_32
    ratio = {k: to32_k[k][1] / max(to32_d[k][1], 1e-30) for k in to32_k}
    far = [k for k in to32_k if to32_k[k][1] > max(RMS_MARGIN * to32_d[k][1], TRAIN_REL_FLOOR)]
    top = max(ratio, key=ratio.get)
    rel = abs(loss_k - loss_d) / abs(loss_d)
    print(f"train (a) step 1: loss {loss_k:.6f} through kernel 11 ({per_step} launches: "
          f"{cfg.vision_layers} ViT full + {cfg.layers} LM causal), {loss_d:.6f} with "
          f"DORA_FLASH_ATTENTION=0: rel {rel:.3e} (bound {TRAIN_LOSS_REL}), f32 {loss_32:.6f}; "
          f"every one of {len(cos)} leaves' gradients finite and nonzero; per-leaf cosine of "
          f"the two paths' gradients min {cos[worst]:.6f} at {worst} (bound {TRAIN_GRAD_COS}), "
          f"median {sorted(cos.values())[len(cos) // 2]:.6f} [{smi}]", flush=True)
    print(f"train (a) step 1 against f32 (rel L2 of each leaf's gradient): kernel path at "
          f"{worst} {to32_k[worst][1]:.3e} (cosine {to32_k[worst][0]:.6f}), flash off "
          f"{to32_d[worst][1]:.3e} ({to32_d[worst][0]:.6f}); largest ratio kernel / flash off "
          f"{ratio[top]:.3f} at {top} ({to32_k[top][1]:.3e} / {to32_d[top][1]:.3e}); kernel "
          f"path median {sorted(d for _, d in to32_k.values())[len(to32_k) // 2]:.3e}, max "
          f"{max(d for _, d in to32_k.values()):.3e}; flash off median "
          f"{sorted(d for _, d in to32_d.values())[len(to32_d) // 2]:.3e}, max "
          f"{max(d for _, d in to32_d.values()):.3e}; beyond max({RMS_MARGIN} x flash off, "
          f"{TRAIN_REL_FLOOR}): {far[:4]} ({len(far)}) [{smi}]", flush=True)
    if not rel <= TRAIN_LOSS_REL:
        raise Failed(f"train (a): kernel-path loss {loss_k} against {loss_d} with flash off")
    if not cos[worst] >= TRAIN_GRAD_COS:
        raise Failed(f"train (a): gradient of {worst} at cosine {cos[worst]} to the flash-off one")
    if far:
        raise Failed(f"train (a): kernel-path gradients farther from f32 than the flash-off "
                     f"path's allows: {far[:8]}")

    opt = functools.partial(torch.optim.Adam, lr=TRAIN_LR)
    state = vlm.init_opt_state(opt, params)
    step = vlm.make_train_step(cfg, opt)
    losses, ms = [], []
    _reset_launches(DB, LO)
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, state, loss = step(params, state, batch)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t) * 1e3)
    launches = _launches(DB, LO)["flash_attention"]
    if launches != TRAIN_STEPS * per_step:
        raise Failed(f"train (a): {TRAIN_STEPS} steps launched flash_attention {launches} times "
                     f"(want {TRAIN_STEPS * per_step})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    warm = sorted(ms[1:])[len(ms[1:]) // 2]
    share = _device_busy(torch, lambda: step(params, state, batch),
                         os.path.join(scratch, f"trace-train-{os.getpid()}"))
    print(f"train (a) steps: losses {[round(x, 6) for x in losses]}; step ms "
          f"{[round(x, 1) for x in ms]} (the first builds Adam's state), median of the rest "
          f"{warm:.1f} ms: {_per_s(TRAIN_BATCH * text, warm)} scored text tokens/s, "
          f"{_per_s(TRAIN_BATCH * (cfg.n_patches + text), warm)} sequence tokens/s; "
          f"flash_attention {launches} launches ({per_step} a step); peak memory "
          f"{peak:.2f} GiB; one more step under profiling.start_capture: {share} [{smi}]",
          flush=True)
    if not losses[-1] < losses[0]:
        raise Failed(f"train (a): the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    del params, state, step, batch
    torch.cuda.empty_cache()
    return launches


def _per_s(tokens: int, ms: float) -> str:
    """Tokens a second of a step of ``ms``."""
    return f"{tokens / (ms / 1e3):.1f}"


def train_tts(torch, smi: str, seed: int, dev: str = "cuda", size: str = "bench") -> None:
    """Phase 18 (b): ``tts.loss_fn`` at the bench widths phase 17 serves,
    TTS_STEPS SGD steps on one seeded batch; the loss must fall."""
    import functools

    from dora_tpu_torch.models import tts, vlm

    cfg = tts.TTSConfig() if size == "bench" else tts.TTSConfig.tiny()
    params = tts.init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {"text": torch.randint(0, cfg.vocab, (2, cfg.max_text), generator=gen, device=dev),
             "style": torch.randint(0, cfg.n_styles, (2,), generator=gen, device=dev),
             "mel": torch.randn((2, cfg.max_frames, cfg.n_mels), generator=gen, device=dev),
             "wave": torch.rand((2, cfg.max_samples), generator=gen, device=dev) - 0.5}
    opt = vlm.init_opt_state(functools.partial(torch.optim.SGD, lr=TTS_LR), params)
    losses, ms = [], []
    for _ in range(TTS_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = tts.loss_fn(params, cfg, batch)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        ms.append((time.perf_counter() - t) * 1e3)
    print(f"train (b) tts.loss_fn at {size} widths ({tts.param_count(params) / 1e6:.1f} M "
          f"parameters, {cfg.enc_layers} + {cfg.dec_layers} layers x {cfg.dim}, batch 2 x "
          f"{cfg.max_text} ids -> {cfg.max_samples} samples), SGD lr {TTS_LR}: losses "
          f"{[round(x, 6) for x in losses]}; step ms {[round(x, 1) for x in ms]} [{smi}]",
          flush=True)
    if not losses[-1] < losses[0]:
        raise Failed(f"train (b): the TTS loss did not fall over {TTS_STEPS} steps: {losses}")
    del params, opt
    torch.cuda.empty_cache()


def parallel_one_rank(torch, DB, LO, smi: str, seed: int, scratch: str, dev: str = "cuda",
                      size: str = "bench") -> None:
    """Phase 18 (c): a one-rank process group (NCCL on the card, a file
    store): ``vlm.generate_tp`` at tp 1 (its all-reduces through NCCL) equal
    to ``vlm.generate`` token for token with exact launches, and ring and
    Ulysses attention at sp 1 equal to the dense einsum in f32. NCCL across
    cards is not run: this machine has one card."""
    import torch.distributed as dist

    from dora_tpu_torch.models import layers as L
    from dora_tpu_torch.models import vlm
    from dora_tpu_torch.parallel import fused_tp as FTP
    from dora_tpu_torch.parallel import make_mesh, ring_attention, ulysses_attention

    store = tempfile.mkdtemp(prefix="store-", dir=scratch)
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store, "s"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(tp=1)
        cfg = vlm.VLMConfig.bench_2b() if size == "bench" else vlm.VLMConfig.tiny()
        qp = vlm.quantize_decode(vlm.init_params(cfg, seed=seed, device=dev))
        tp_params = FTP.prepare_decode_params(qp, mesh, heads=cfg.heads, kv_heads=cfg.kv_heads,
                                              head_dim=cfg.head_dim, layers=cfg.layers)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        image = torch.rand((1, cfg.image_size, cfg.image_size, 3), generator=gen, device=dev)
        prompt = torch.randint(0, cfg.vocab, (1, VLM_PROMPT), generator=gen, device=dev)
        n = TP_MAX_NEW if size == "bench" else 6
        with torch.no_grad():
            _reset_launches(DB, LO)
            t = time.perf_counter()
            got = vlm.generate_tp(qp, tp_params, cfg, image, prompt, n, mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launched = _launches(DB, LO)
            want = vlm.generate(qp, cfg, image, prompt, n)
        # the prefill's head on its last row; a prefill of at most 32 rows also
        # takes its four block products through int8_matmul (layers.matmul)
        rows = cfg.n_patches + VLM_PROMPT
        need = {"flash_attention": cfg.vision_layers,
                "int8_matmul": 1 + (4 * cfg.layers if rows <= L.MATVEC_MAX_ROWS else 0),
                "attention_step": (n - 1) * cfg.layers, "mlp_step": (n - 1) * cfg.layers,
                "lm_head_argmax": n - 1}
        ran = {k: v for k, v in launched.items() if v}
        if ran != need:
            raise Failed(f"train (c): generate_tp launched {ran}, want {need}")
        same = got.tolist() == want.tolist()
        print(f"train (c) {backend} one-rank group: generate_tp at tp 1 ({n} tokens, "
              f"{wall:.3f} s, the all-reduces through {backend}) "
              f"{'equals' if same else 'DIFFERS FROM'} vlm.generate token for token; launches "
              f"{json.dumps(ran)} [{smi}]", flush=True)
        if not same:
            raise Failed(f"train (c): generate_tp {got.tolist()} against generate {want.tolist()}")
        del qp, tp_params
        torch.cuda.empty_cache()
        sp_mesh = make_mesh(sp=1)
        g = torch.Generator(device=dev).manual_seed(seed + 2)
        shape = (TRAIN_BATCH, cfg.heads, cfg.n_patches + TRAIN_TEXT, cfg.head_dim)
        q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        lines = []
        for causal in (False, True):
            mask = L.causal_mask(shape[2], shape[2], device=dev) if causal else None
            dense = L.attention(q, k, v, mask)
            for fn in (ring_attention, ulysses_attention):
                _, rel = _rel(fn(q, k, v, sp_mesh, causal=causal), dense)
                lines.append(f"{fn.__name__} {'causal' if causal else 'full'} {rel:.2e}")
                if not rel <= SP1_REL_TOL:
                    raise Failed(f"train (c): {fn.__name__} at sp 1 is {rel:.3e} from dense")
        print(f"train (c) sp 1 on {tuple(shape)} f32 against the dense einsum (rel max err, "
              f"bound {SP1_REL_TOL}): {'; '.join(lines)}. NCCL across cards is not verified: "
              f"this machine has one card [{smi}]", flush=True)
    finally:
        dist.destroy_process_group()


def serve_train(torch, DB, LO, smi: str, seed: int, scratch: str, dev: str = "cuda",
                size: str = "bench") -> int:
    """Phase 18: (a) :func:`train_vlm`, (b) :func:`train_tts`, (c)
    :func:`parallel_one_rank`. Returns (a)'s kernel 11 launches."""
    launches = train_vlm(torch, DB, LO, smi, seed, scratch, dev, size)
    train_tts(torch, smi, seed + 3, dev, size)
    parallel_one_rank(torch, DB, LO, smi, seed + 5, scratch, dev, size)
    return launches


# ---------------------------------------------------------------------------
# phase 19: the port's measurement tools, each leg in its own process
# ---------------------------------------------------------------------------

#: the paged engine's kernels, the dense engine's, the int8-KV forms (kernels
#: 3 and 4), the int4-weight forms of kernels 1-4, and speculation's (kernel 5)
BENCH_PAGED = SPEC_OFF_KERNELS
BENCH_DENSE = ("int8_matmul", "attention_batch_step", "mlp_step", "lm_head_argmax")
BENCH_QUANT = BENCH_PAGED + (
    "attention_paged_chunk_step_int8kv", "attention_paged_batch_step_int8kv",
    *(f"{n}_int4" for n in BENCH_PAGED),
    "attention_paged_spec_step", "attention_paged_spec_step_int8kv")
BENCH_VLM_MODEL = ("flash_attention", "int8_matmul", "attention_step", "attention_chunk_step",
                   "mlp_step", "lm_head_argmax")
BENCH_VLM_BATCH = ("attention_batch_step", "mlp_step", "lm_head_argmax")
#: bench_vlm e2e's camera frames (10 s at 20 ms: the VLM node's first tick
#: takes seconds, and 100 frames end before it is warm)
E2E_FRAMES = 500
#: bench_vlm e2e's VLM node, greedy: kernels 11, 7, 9, 1, 2 (in its own process)
BENCH_VLM_E2E = ("flash_attention", "int8_matmul", "attention_step", "mlp_step",
                 "lm_head_argmax")
#: each leg: (name, tool, arguments, extra env, the line's key (None: a
#: line per shape or metric), lines, the kernels it must launch)
_MODEL_ENV = {"DORA_INT8_DECODE": "1"}
BENCH_LEGS = (
    ("serving", "bench_serving", [], _MODEL_ENV, "streams4", 1,
     tuple(dict.fromkeys(BENCH_PAGED + BENCH_DENSE))),
    ("serving --multistep", "bench_serving", ["--multistep"], _MODEL_ENV, "multistep", 1,
     BENCH_PAGED),
    ("serving --trace-ab", "bench_serving", ["--trace-ab"], _MODEL_ENV, "trace_ab", 1,
     BENCH_PAGED),
    ("serving --quant-ab", "bench_serving", ["--quant-ab"], _MODEL_ENV, "quant_ab", 1,
     BENCH_QUANT),
    ("serving --spec-ab", "bench_serving", ["--spec-ab"], {}, "spec_ab", 1, ()),
    ("serving --lora-ab", "bench_serving", ["--lora-ab"], {}, "lora_ab", 1, ()),
    ("serving --profiling-ab", "bench_serving", ["--profiling-ab"], {}, "profiling_ab", 1, ()),
    ("serving --fleet-digest-ab", "bench_serving", ["--fleet-digest-ab"], {},
     "fleet_digest_ab", 1, ()),
    ("serving --qos-soak", "bench_serving", ["--qos-soak"], {}, "qos_soak", 1, ()),
    ("serving --prefix-ab", "bench_serving", ["--prefix-ab"], {}, "prefix_ab", 1, ()),
    ("int8", "bench_int8", [], {}, None, 4, ("int8_matmul",)),
    ("flash", "bench_flash", [], {}, None, 3, ("flash_attention",)),
    ("vlm model", "bench_vlm", ["model"], {**_MODEL_ENV, "DORA_SPEC_DECODE": "1"}, None, 8,
     BENCH_VLM_MODEL),
    ("vlm batch", "bench_vlm", ["batch"], _MODEL_ENV, None, 4, BENCH_VLM_BATCH),
    ("vlm e2e", "bench_vlm", ["e2e"], {**_MODEL_ENV, "BENCH_FRAMES": str(E2E_FRAMES)}, None, 2,
     BENCH_VLM_E2E),
)
#: one leg's process may take this long
BENCH_LEG_TIMEOUT_S = 300


def _nulls(obj, path: str = "") -> list[str]:
    """Paths of the null values in a leg's line. Null by definition: a
    spec-off cell's acceptance (k0, nothing drafted) and the percentiles of
    a class that no stream of finished (``n`` 0, e.g. every batch-class
    stream shed in the QoS soak)."""
    if isinstance(obj, dict):
        if obj.get("n") == 0:
            obj = {k: v for k, v in obj.items() if k not in ("p50", "p99")}
        return [p for k, v in obj.items() for p in _nulls(v, f"{path}/{k}")]
    if isinstance(obj, list):
        return [p for i, v in enumerate(obj) for p in _nulls(v, f"{path}/{i}")]
    if obj is None and not (path.endswith("/acceptance") and "/k0_" in path):
        return [path]
    return []


#: a leg's process: the interpreter imports torch and the port and opens the
#: card, waits for a line on stdin, then runs the tool as ``python -m`` runs
#: a module; so each leg starts while the one before it runs
_LEG_MAIN = (
    "import runpy, sys, torch\n"
    "import dora_tpu_torch.tools._common, dora_tpu_torch.models.vlm\n"
    "import dora_tpu_torch.models.hf.qwen2, dora_tpu_torch.nodehub.llm_server\n"
    "torch.zeros(1, device='cuda')\n"
    "sys.stdin.readline()\n"
    "module = 'dora_tpu_torch.tools.' + sys.argv.pop(1)\n"
    "runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
)


def _start_leg(here: str, tool: str, argv: list, env: dict):
    return subprocess.Popen([sys.executable, "-c", _LEG_MAIN, tool, *argv], cwd=here,
                            env={**os.environ, **env}, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_leg(proc, what: str) -> tuple[list[dict], float]:
    """Let a started leg run to its end; its JSON lines and its seconds
    from the go to the end."""
    t = time.perf_counter()
    try:
        out, err = proc.communicate("go\n", timeout=BENCH_LEG_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.communicate()
        raise Failed(f"bench {what}: no end within {e.timeout} s") from e
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise Failed(f"bench {what} exited {proc.returncode}: {err[-3000:]}")
    lines = []
    for text in out.splitlines():
        with contextlib.suppress(json.JSONDecodeError):
            obj = json.loads(text)
            if isinstance(obj, dict):
                lines.append(obj)
    return lines, wall


def _bench_counters(what: str, bodies: list[dict], need) -> dict:
    """Sum a leg's launches; fail on a plain call or a named kernel that
    never launched."""
    launches: dict = {}
    plain = 0
    for body in bodies:
        if "plain_calls" in body:
            plain += body["plain_calls"]
            for n, c in body["launches"].items():
                launches[n] = launches.get(n, 0) + c
    if plain:
        raise Failed(f"bench {what}: {plain} calls of a plain version on the card")
    missing = [n for n in need if not launches.get(n)]
    if missing:
        raise Failed(f"bench {what}: no launch of {', '.join(missing)} ({launches})")
    return launches


def check_quant_partings(torch, DB, LO, IM, L, qwen2, serve_prompts, partings: dict,
                         seed: int) -> None:
    """Where ``--quant-ab``'s int8-KV stream first parts from its fp stream,
    both tokens must be at a near-tie of the f32 plain path on that prefix
    (the leg's seeded model, rebuilt here)."""
    if not partings:
        print("bench quant partings: none (int8-KV streams equal the fp streams)", flush=True)
        return
    cfg = qwen2.Qwen2Config.qwen2_1_5b(max_seq=512)
    params = qwen2.quantize_decode(qwen2.random_params(cfg, seed=seed, std=0.02,
                                                       device="cuda"), cfg)
    paths = _Paths(torch, DB, LO, IM, qwen2, L, serve_prompts, params, cfg)
    for rid, p in sorted(partings.items()):
        prefix = p["prompt"] + p["before"]
        paths.check(f"bench quant parting: stream {rid} at token {p['at']}",
                    paths.after(prefix), (p["kv_int8"], p["fp"]), SPEC_REF_TIE, rms=False)
    del paths, params
    torch.cuda.empty_cache()


def serve_bench(torch, DB, LO, IM, L, qwen2, serve_prompts, smi: str, here: str) -> None:
    """Phase 19: every leg of the port's measurement tools on this card."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuts = []
    qos = os.environ.get("DORA_BENCH_QOS_STREAMS")
    if qos:
        cuts.append(f"DORA_BENCH_QOS_STREAMS={qos}")
    print(f"bench cuts: {', '.join(cuts) or 'none'} ({smi})", flush=True)
    quant = None
    procs = [_start_leg(here, *BENCH_LEGS[0][1:4])]
    try:
        for i, (what, tool, argv, env, key, n_lines, need) in enumerate(BENCH_LEGS):
            if i + 1 < len(BENCH_LEGS):
                procs.append(_start_leg(here, *BENCH_LEGS[i + 1][1:4]))
            lines, wall = _finish_leg(procs[i], what)
            quant = _bench_check(what, lines, key, n_lines, need, wall, smi) or quant
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    check_quant_partings(torch, DB, LO, IM, L, qwen2, serve_prompts, quant["first_parting"],
                         seed=0)
    print(f"bench: phase 19 in {time.perf_counter() - t0:.1f} s", flush=True)


def _bench_check(what: str, lines: list[dict], key, n_lines: int, need, wall: float,
                 smi: str):
    """Print a leg's lines and hold them to phase 19's rules; the
    ``--quant-ab`` leg's body, else None."""
    for line in lines:
        print(f"bench {what}: {json.dumps(line)}", flush=True)
    if len(lines) != n_lines or (key is not None and key not in lines[0]):
        raise Failed(f"bench {what}: {len(lines)} JSON lines, expected {n_lines}"
                     + (f" with {key!r}" if key else ""))
    nulls = [p for line in lines for p in _nulls(line)]
    if nulls:
        raise Failed(f"bench {what}: null numbers at {', '.join(nulls)}")
    # a leg's keys sit under its name; the default leg's at the top
    bodies = [line[key] if key not in (None, "streams4") else line for line in lines]
    devices = {body.get("device") for body in bodies}
    if devices != {smi}:
        raise Failed(f"bench {what}: device {devices}, expected {smi!r}")
    launches = _bench_counters(what, bodies, need)
    print(f"bench {what}: ran {wall:.1f} s, launches {launches}", flush=True)
    return bodies[0] if key == "quant_ab" else None


# ---------------------------------------------------------------------------
# phase 20: the port's dataflows under the port's own daemon
# ---------------------------------------------------------------------------

#: numbers of earlier phases that phase 20 prints beside its own
EARLIER: dict = {}
#: (a): seconds the VLM dataflow runs after its start barrier, greedy and
#: with DORA_SPEC_DECODE=1
VLM_FLOW_S = 12.0
VLM_SPEC_FLOW_S = 10.0
#: (a): the camera's frame seed
VLM_FLOW_SEED = 7
#: the kernels of the greedy VLM node (kernels 11, 7, 9, 1, 2) and of its
#: speculative form (kernel 10 instead of 9)
VLM_GREEDY_KERNELS = ("flash_attention", "int8_matmul", "attention_step", "mlp_step",
                      "lm_head_argmax")
VLM_SPEC_KERNELS = ("flash_attention", "int8_matmul", "attention_chunk_step", "mlp_step",
                    "lm_head_argmax")
#: one dataflow run may take this long, start and weights included
FLOW_TIMEOUT_S = 300

#: (b)'s prompt node: a warmup request of one new token first (the node's
#: process starts its CUDA libraries and loads the kernels on it; one token
#: is a prefill alone, so the decode window's graph is still captured inside
#: the measured requests, as in phase 13 (a)), then, once it is answered,
#: every request at once, their send times written out
_PROMPT_NODE = """
import json
import sys
import time

import pyarrow as pa

from dora_tpu_torch.node import Node

requests = json.load(open(sys.argv[1]))
sent = {}
with Node() as node:
    node.send_output("prompt", pa.array([" ".join(map(str, range(1, 33)))]),
                     {"request_id": "warmup", "max_new_tokens": 1})
    for event in node:
        if event["type"] == "INPUT" and event["metadata"]["done"]:
            break
    for rid, ids, max_new in requests:
        sent[rid] = time.monotonic()
        node.send_output("prompt", pa.array([" ".join(map(str, ids))]),
                         {"request_id": rid, "max_new_tokens": max_new})
json.dump(sent, open(sys.argv[2], "w"))
"""

#: (b)'s sink: every response chunk with its arrival time
_CHUNK_SINK = """
import json
import sys
import time

from dora_tpu_torch.node import Node

chunks = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            meta = event["metadata"]
            if meta["request_id"] != "warmup":
                chunks.append([time.monotonic(), meta["request_id"], meta["seq"], meta["done"],
                               meta.get("finish"), event["value"].to_pylist()[0]])
json.dump(chunks, open(sys.argv[1], "w"))
"""


def _counted_args(counts: str, module_args: str) -> str:
    """A node's args under tools/counted.py: its launches land in ``counts``."""
    return f"{counts} {module_args}"


def _node_counts(what: str, path: str, need, others_ok=()) -> dict:
    """A node process's launches and plain calls (tools/counted.py): every
    kernel of ``need`` launched, none outside ``need`` and ``others_ok``, no
    plain call, a clean exit."""
    with open(path) as f:
        report = json.load(f)
    launches, plain = report["launches"], report["plain_calls"]
    print(f"{what} node launches: {json.dumps(launches)}; plain calls {plain}", flush=True)
    if report["exit"] != 0:
        raise Failed(f"{what}: the node exited {report['exit']}")
    if plain:
        raise Failed(f"{what}: {plain} plain-version call(s) in the node")
    missing = [n for n in need if not launches.get(n)]
    if missing:
        raise Failed(f"{what}: no launch of {', '.join(missing)} in the node ({launches})")
    stray = [n for n in launches if n not in need and n not in others_ok]
    if stray:
        raise Failed(f"{what}: the node launched {stray} off its path")
    return launches


def _flow_logs(work: str, tail: int = 6) -> str:
    """The last lines of each node's log of a dataflow run in ``work``."""
    out = []
    for root, _dirs, files in os.walk(os.path.join(work, "out")):
        for name in sorted(n for n in files if n.startswith("log_")):
            with open(os.path.join(root, name), errors="replace") as f:
                lines = f.read().splitlines()[-tail:]
            out.append(f"{name}: {lines}")
    return "; ".join(out) or "no node log"


def _flow(desc, work: str, what: str, **kw):
    """The dataflow through the port's run_dataflow; a failed node fails the
    phase, with the daemon's report."""
    from dora_tpu_torch.daemon import run_dataflow

    t = time.perf_counter()
    result = run_dataflow(desc, working_dir=work, timeout_s=FLOW_TIMEOUT_S, **kw)
    wall = time.perf_counter() - t
    if not result.is_ok():
        raise Failed(f"{what}: dataflow failed: "
                     + "; ".join(f"{nid}: {err}" for nid, err in result.errors()))
    return wall


def vlm_flow_desc(counts: str, size: str, dev: str) -> dict:
    """dora_tpu_torch/examples/vlm.yml as a dict (no YAML on the card's
    machine is needed): the 20 ms camera with seeded frames, the VLM node
    ticked at 100 ms, its image and tick inputs latest-wins (queue_size 1,
    so a tick's latency is the node's and not a backlog's), the printer and
    the recorder; the VLM node under tools/counted.py."""
    return {"nodes": [
        {"id": "camera", "path": "module:dora_tpu_torch.nodehub.camera",
         "inputs": {"tick": "dora/timer/millis/20"}, "outputs": ["image"],
         "env": {"IMAGE_WIDTH": "224", "IMAGE_HEIGHT": "224", "SEED": str(VLM_FLOW_SEED)}},
        {"id": "vlm", "path": "module:dora_tpu_torch.tools.counted",
         "args": _counted_args(counts, "dora_tpu_torch.runtime --operator "
                               f"op=dora_tpu_torch.nodehub.ops:make_vlm --device {dev}"),
         "inputs": {"op/image": {"source": "camera/image", "queue_size": 1},
                    "op/tick": {"source": "dora/timer/millis/100", "queue_size": 1}},
         "outputs": ["op/tokens"],
         "env": {"DORA_MODEL_SIZE": size, "DORA_INT8_DECODE": "1"}},
        {"id": "printer", "path": "module:dora_tpu_torch.nodehub.terminal_print",
         "inputs": {"tokens": "vlm/op/tokens"}},
        {"id": "recorder", "path": "module:dora_tpu_torch.nodehub.record",
         "inputs": {"tokens": "vlm/op/tokens"}, "env": {"RECORD_DIR": "record"}},
    ]}


def _recorded(path: str) -> list[tuple[list, dict, int]]:
    """The recorder's rows: (tokens, metadata, arrival wall ns)."""
    import pyarrow.parquet as pq

    return [(row["value"], json.loads(row["metadata"]), row["timestamp_utc_ns"])
            for row in pq.read_table(path).to_pylist()]


def vlm_dataflow(torch, smi: str, scratch: str, dev: str = "cuda", size: str = "bench") -> None:
    """Phase 20 (a): vlm.yml under the port's daemon, greedy, then with
    DORA_SPEC_DECODE=1: each caption's metadata names the frame it answers,
    and its tokens equal ``vlm.generate`` (``generate_speculative``) on that
    frame in this process; the node's launches exact for its ticks, no
    plain call; frames a second at the sink and tick-to-sink latency."""
    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.models import tokenizer, vlm
    from dora_tpu_torch.nodehub.camera import seeded_frame

    cfg = vlm.VLMConfig.bench_2b() if size != "tiny" else vlm.VLMConfig.tiny()
    t = time.perf_counter()
    params = vlm.quantize_decode(vlm.init_params(cfg, seed=0, device=dev))  # make_vlm's
    print(f"dataflow (a): make_vlm's weights rebuilt here for the reference in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    prompt = torch.tensor([[x % cfg.vocab for x in tokenizer.encode("describe")]],
                          dtype=torch.int32, device=dev)
    max_new = 16  # make_vlm's default
    knobs = dict(DORA_INT4_DECODE=None, DORA_INT8_PURE=None, DORA_SPEC_DECODE=None,
                 DORA_MAX_NEW_TOKENS=None, DORA_PROMPT=None, DORA_CHECKPOINT=None,
                 DORA_HF_CHECKPOINT=None, DORA_PARAM_DTYPE=None, DORA_MESH=None,
                 DORA_PIPELINE_DEPTH=None, DORA_FETCH_EVERY=None)
    for spec, run_s, need in ((False, VLM_FLOW_S, VLM_GREEDY_KERNELS),
                              (True, VLM_SPEC_FLOW_S, VLM_SPEC_KERNELS)):
        what = "dataflow (a)" + (" DORA_SPEC_DECODE=1" if spec else "")
        with tempfile.TemporaryDirectory(prefix="vlm-flow-", dir=scratch) as work:
            counts = os.path.join(work, "vlm.launches.json")
            with _env(**{**knobs, "DORA_SPEC_DECODE": "1" if spec else None}):
                wall = _flow(Descriptor.parse(vlm_flow_desc(counts, size, dev)), work, what,
                             stop_after_s=run_s)
            launches = _node_counts(what, counts, need)
            recorded = os.path.join(work, "record", "tokens.parquet")
            rows = _recorded(recorded) if os.path.exists(recorded) else []
        if len(rows) < 3:
            raise Failed(f"{what}: {len(rows)} captions recorded in {run_s} s")
        frames = sorted({m["frame"] for _v, m, _t in rows})
        ref = {}
        for i in frames:
            image = (torch.from_numpy(seeded_frame(cfg.image_size, cfg.image_size,
                                                   VLM_FLOW_SEED, i)).to(dev).float()
                     / 255.0)[None]
            if spec:
                ref[i] = vlm.generate_speculative(params, cfg, image, prompt, max_new)[0][0]
            else:
                ref[i] = vlm.generate(params, cfg, image, prompt, max_new)[0]
            ref[i] = ref[i].cpu().tolist()
        for j, (tokens, meta, _t) in enumerate(rows):
            if tokens != ref[meta["frame"]]:
                raise Failed(f"{what}: caption {j} (frame {meta['frame']}) differs from "
                             f"this process's {'generate_speculative' if spec else 'generate'}"
                             f": {tokens} against {ref[meta['frame']]}")
        # every tick the node ran: kernel 11 launches 32 times an image
        ticks = launches["flash_attention"] // cfg.vision_layers
        if ticks < len(rows) or launches["flash_attention"] != ticks * cfg.vision_layers:
            raise Failed(f"{what}: {launches['flash_attention']} flash launches for "
                         f"{len(rows)} captions")
        if not spec:
            steps = ticks * (max_new - 1)
            want = {"attention_step": cfg.layers * steps, "mlp_step": cfg.layers * steps,
                    "lm_head_argmax": steps}
            got = {n: launches[n] for n in want}
            if got != want:
                raise Failed(f"{what}: {ticks} ticks launched {got}, expected {want}")
        # The first ticks carry the node's warmup and the backlog it leaves:
        # the rate and latency of the later half of the captions are the
        # steady state, beside those of every caption after the first.
        def rate(part):
            arrive = [a for _v, _m, a in part]
            lat = [1e-6 * (a - m["tick_ns"]) for _v, m, a in part]
            return (len(part) - 1) / (1e-9 * (arrive[-1] - arrive[0])), lat

        fps, lat = rate(rows[1:])
        fps_s, lat_s = rate(rows[len(rows) // 2:])
        first = 1e-6 * (rows[0][2] - rows[0][1]["tick_ns"])
        t0 = rows[0][1]["tick_ns"]
        print(f"{what} captions (frame, tick ms, tick-to-sink ms from the first tick): "
              + " ".join(f"({m['frame']}, {1e-6 * (m['tick_ns'] - t0):.0f}, "
                         f"{1e-6 * (a - m['tick_ns']):.0f})" for _v, m, a in rows), flush=True)
        print(f"{what}: {len(rows)} captions of {ticks} ticks over frames {frames[:8]}"
              f"{'...' if len(frames) > 8 else ''}, each equal to "
              f"{'vlm.generate_speculative' if spec else 'vlm.generate'} on its frame here; "
              f"the later half {fps_s:.3f} frames a second at the recorder, tick-to-sink p50 "
              f"{_pct(lat_s, 50):.1f} ms p99 {_pct(lat_s, 99):.1f} ms; every caption after the "
              f"first ({first:.1f} ms from its tick, warmup included) {fps:.3f} frames a second, "
              f"tick-to-sink p50 "
              f"{_pct(lat, 50):.1f} ms p99 {_pct(lat, 99):.1f} ms; dataflow wall {wall:.1f} s "
              f"(start barrier and weights included; ran {run_s} s after it); phase 16's tick "
              f"wall {EARLIER.get('vlm_tick', 'not run')} [{smi}]", flush=True)
    del params
    torch.cuda.empty_cache()


class _EdgeLog(logging.Handler):
    """The daemon's log line naming a dataflow's peer-to-peer edges."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        if "peer-to-peer edges" in record.getMessage():
            self.lines.append(record.getMessage())

    def __enter__(self):
        log = logging.getLogger("dora_tpu_torch.daemon.core")
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger("dora_tpu_torch.daemon.core")
        log.removeHandler(self)
        log.setLevel(self._level)


def serve_flow_desc(counts: str, prompts_json: str, sent_json: str, chunks_json: str,
                    layers: int, seed: int, max_new: int, comm: str, dev: str) -> dict:
    """Phase 4's requests from a prompt node to the port's serving node (the
    seeded Qwen2-1.5B-width weights of phase 4, int8, phase 13's engine) to a
    sink, over ``comm``."""
    return {"communication": {"local": comm}, "nodes": [
        {"id": "prompts", "path": "prompt_node.py", "args": f"{prompts_json} {sent_json}",
         "inputs": {"response": {"source": "llm/response", "queue_size": 4096}},
         "outputs": ["prompt"]},
        {"id": "llm", "path": "module:dora_tpu_torch.tools.counted",
         "args": _counted_args(counts, "dora_tpu_torch.nodehub.llm_server --random-config "
                               f"qwen2_1_5b --layers {layers} --seed {seed} --device {dev}"),
         "inputs": {"text": {"source": "prompts/prompt", "queue_size": 64}},
         "outputs": ["response"],
         "env": {"DORA_BATCH_SLOTS": "16", "DORA_PAGE_SIZE": "16", "DORA_PREFILL_CHUNK": "256",
                 "DORA_MULTISTEP_K": "8", "DORA_MAX_SEQ": "2048", "DORA_INT8_DECODE": "1",
                 "DORA_MAX_NEW_TOKENS": str(max_new)}},
        {"id": "sink", "path": "chunk_sink.py", "args": chunks_json,
         "inputs": {"response": {"source": "llm/response", "queue_size": 4096}}},
    ]}


def serve_dataflow(torch, DB, LO, IM, L, qwen2, serve_prompts, smi: str,
                   scratch: str, layers: int, seed: int, prompts, max_new: int, served=None,
                   trace_cost: bool = False, legs=None):
    """Phase 20 (b): phase 4's requests through the port's serving node behind
    the port's daemon, over shmem and over tcp, peer-to-peer edges on (the
    default; and, with ``trace_cost``, over tcp again with DORA_TRACING=1 in
    the daemon and the nodes, for phase 22 (f)): every stream held to phase
    4's by the near-tie rule, TTFT and tokens a second beside phase 13's,
    kernels 1-4 launched in the node, no plain call. ``legs`` replaces the
    legs with (comm, DORA_TRACING, DORA_P2P) triples (phase 23 (b)). A
    request that never gets its done chunk fails the leg with every node's
    log tail; a leg with peer-to-peer edges on fails unless the daemon paired
    SERVING_EDGES and no node left them to its route, a leg with DORA_P2P=0
    fails if it paired any. Returns phase 4's streams (served here when not
    given)."""
    from dora_tpu_torch import telemetry
    from dora_tpu_torch.core.descriptor import Descriptor

    cfg = qwen2.Qwen2Config.qwen2_1_5b(layers=layers, max_seq=2048)
    params = qwen2.quantize_decode(qwen2.random_params(cfg, seed=seed, std=0.02, device="cuda"),
                                   cfg)
    if served is None:  # phase 4's streams (its engine, prefix cache off)
        engine = qwen2.make_paged_engine(params, cfg, max_slots=16, page_size=16, chunk=256,
                                         window=8, spec_k=0, prefix_cache=False, device="cuda")
        served, _ = serve_prompts(engine, prompts, max_new)
        del engine
        print("dataflow (b): phase 4's streams served here for the reference", flush=True)
    paths = _Paths(torch, DB, LO, IM, qwen2, L, serve_prompts, params, cfg)
    rids = [f"a{i}" for i in range(len(prompts))]
    if legs is None:
        legs = [("shmem", None, None), ("tcp", None, None)] + (
            [("tcp", "1", None)] if trace_cost else [])
    repeat: dict = {}
    for comm, tracing, p2p in legs:
        leg = comm + (" traced" if tracing else "") + (f" DORA_P2P={p2p}" if p2p else "")
        repeat[leg] = repeat.get(leg, 0) + 1
        if repeat[leg] > 1:
            leg += f" #{repeat[leg]}"
        what = f"dataflow (b) {leg}"
        with tempfile.TemporaryDirectory(prefix="serve-flow-", dir=scratch) as work:
            files = {k: os.path.join(work, f"{k}.json")
                     for k in ("counts", "prompts", "sent", "chunks")}
            with open(files["prompts"], "w") as f:
                json.dump([[r, p, max_new] for r, p in zip(rids, prompts)], f)
            with open(os.path.join(work, "prompt_node.py"), "w") as f:
                f.write(_PROMPT_NODE)
            with open(os.path.join(work, "chunk_sink.py"), "w") as f:
                f.write(_CHUNK_SINK)
            desc = serve_flow_desc(files["counts"], files["prompts"], files["sent"],
                                   files["chunks"], layers, seed, max_new, comm, "cuda")
            with _env(**{k: None for k in FRONT_DOOR_KNOBS},
                      DORA_QOS_PREEMPT=None, DORA_QOS_DEPTH_BATCH=None, DORA_TRACING=tracing,
                      DORA_P2P=p2p), _EdgeLog() as edges:
                try:
                    wall = _flow(Descriptor.parse(desc), work, what)
                finally:  # the in-process daemon switched this process's recorder
                    telemetry.TRACING.configure_from_env()
                    telemetry.FLIGHT.configure_from_env()
            _serving_edges(what, edges.lines, p2p != "0", work)
            _node_counts(what, files["counts"], SPEC_OFF_KERNELS)
            with open(files["sent"]) as f:
                sent = json.load(f)
            with open(files["chunks"]) as f:
                chunks = json.load(f)
            logs = _flow_logs(work)
        streams: dict = {r: [] for r in rids}
        seqs: dict = {r: [] for r in rids}
        dones: dict = dict.fromkeys(rids, 0)
        first: dict = {}
        for t, rid, seq, done, finish, text in chunks:
            if text:
                streams[rid].append(int(text))
            seqs[rid].append(seq)
            first.setdefault(rid, t)
            if done:
                dones[rid] += 1
                if finish != "length":
                    raise Failed(f"{what}: request {rid} finished {finish!r}")
        for rid in rids:
            if dones[rid] != 1 or seqs[rid] != list(range(len(seqs[rid]))):
                raise Failed(f"{what}: request {rid}: {dones[rid]} done chunks, seqs "
                             f"{seqs[rid][:8]}...; requests with a done chunk "
                             f"{sorted(r for r in rids if dones[r])}; {logs}")
        parted = 0
        for i, rid in enumerate(rids):
            if len(streams[rid]) != max_new:
                raise Failed(f"{what}: request {rid} has {len(streams[rid])} of {max_new} "
                             "tokens")
            parted += _hold_to_phase4(f"{what}: request {i}", paths, prompts[i], streams[rid],
                                      served[i], max_new) < max_new
        ttft = [first[r] - sent[r] for r in rids]
        span = max(t for t, *_ in chunks) - min(sent.values())
        n_tok = sum(len(s) for s in streams.values())
        ref = EARLIER.get("serve_a")
        EARLIER.setdefault("flow_b", {})[leg] = (
            f"TTFT p50 {_pct(ttft, 50):.4f} s max {max(ttft):.4f} s, {n_tok / span:.1f} tokens/s")
        EARLIER.setdefault("flow_b_num", {})[leg] = (_pct(ttft, 50), n_tok / span)
        print(f"{what}: {len(rids)} requests, {n_tok} tokens in {span:.3f} s from the first "
              f"send to the last chunk ({n_tok / span:.1f} tokens/s end to end); "
              f"{len(rids) - parted} streams equal phase 4's token for token, {parted} part at "
              f"near-ties; TTFT p50 {_pct(ttft, 50):.4f} s max {max(ttft):.4f} s; phase 13 (a) "
              f"over a scripted node: {ref or 'not run'}; dataflow wall {wall:.1f} s (node "
              f"start and weights included) [{smi}]", flush=True)
    del paths, params
    torch.cuda.empty_cache()
    return served


#: (b)'s edges that take the peer-to-peer route unless DORA_P2P=0
SERVING_EDGES = ("llm/response -> prompts/response", "llm/response -> sink/response",
                 "prompts/prompt -> llm/text")
#: what a node logs when it leaves peer-to-peer edges to the daemon's route
P2P_ABANDONED = ("peer-to-peer edges off", "no peer-to-peer edges out")


def _serving_edges(what: str, lines: list, p2p: bool, work: str) -> None:
    """The serving leg took the route it was asked for: with peer-to-peer
    on, the daemon paired SERVING_EDGES and no node left them to the daemon;
    with DORA_P2P=0, the daemon paired nothing."""
    if not p2p:
        if lines:
            raise Failed(f"{what}: DORA_P2P=0, yet the daemon paired {lines}")
        return
    paired = lines[-1] if lines else ""
    missing = [e for e in SERVING_EDGES if repr(e) not in paired]
    abandoned = []
    for root, _dirs, files in os.walk(os.path.join(work, "out")):
        for name in sorted(n for n in files if n.startswith("log_")):
            with open(os.path.join(root, name), errors="replace") as f:
                abandoned += [f"{name}: {line}" for line in f.read().splitlines()
                              if any(m in line for m in P2P_ABANDONED)]
    if missing or abandoned:
        raise Failed(f"{what}: peer-to-peer edges not in use: unpaired {missing} (the daemon: "
                     f"{lines or 'no edge line'}); {abandoned}")


def serve_dataflows(torch, DB, LO, IM, L, qwen2, serve_prompts, smi: str,
                    scratch: str, layers: int, seed: int, prompts, max_new: int,
                    served=None, trace_cost: bool = False) -> None:
    """Phase 20: the port's dataflows under the port's daemon."""
    t0 = time.perf_counter()
    vlm_dataflow(torch, smi, scratch)
    serve_dataflow(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch,
                   layers, seed, prompts, max_new, served, trace_cost=trace_cost)
    print(f"dataflow: phase 20 in {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 21: the cluster tier
# ---------------------------------------------------------------------------

#: (c): the shortest prompts, streamed this long so that they are live when
#: the node drains them (and, with phase 22, through its history read and
#: its profile capture first)
MIGRATE_STREAMS = 4
MIGRATE_MAX_NEW = 1700
#: (c): chunks each of those streams must have brought before ``migrate``
MIGRATE_AFTER_CHUNKS = 4
#: the longest a CLI command, the start of the serving node and a request wait
CLUSTER_CMD_S = 120
CLUSTER_START_S = 300


def _cluster_cli(here: str, state: str, *argv, timeout: float = CLUSTER_CMD_S,
                 env: dict | None = None):
    """One command of the port's CLI in its own process, as a user runs it
    (``env`` added to this process's environment); a non-zero exit fails the
    phase with its output."""
    env = dict(os.environ, **(env or {}), DORA_TPU_STATE_DIR=state,
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "dora_tpu_torch.cli", *argv], cwd=here,
                          env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise Failed(f"cluster: `{' '.join(argv)}` exited {proc.returncode}: "
                     f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return proc.stdout


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def llm_flow_desc(counts: str, gateway_port: int, layers: int, seed: int, dev: str,
                  alerts: dict | None = None) -> dict:
    """dora_tpu_torch/examples/llm-server.yml with phase 20 (b)'s serving node:
    the gateway (concurrent) on machine A, ``llm_server --random-config
    qwen2_1_5b`` (phase 4's weights, phase 13's engine) on B under
    tools/counted.py; streams up to MIGRATE_MAX_NEW tokens; ``alerts`` its
    ``alerts:`` block."""
    return {**({"alerts": alerts} if alerts else {}), "nodes": [
        {"id": "api", "path": "module:dora_tpu_torch.nodehub.openai_server",
         "outputs": ["text"], "inputs": {"response": {"source": "llm/response",
                                                      "queue_size": 4096}},
         "env": {"PORT": str(gateway_port), "DORA_OPENAI_CONCURRENT": "1",
                 "RESPONSE_TIMEOUT": str(CLUSTER_START_S)},
         "deploy": {"machine": "A"}},
        {"id": "llm", "path": "module:dora_tpu_torch.tools.counted",
         "args": _counted_args(counts, "dora_tpu_torch.nodehub.llm_server --random-config "
                               f"qwen2_1_5b --layers {layers} --seed {seed} --device {dev}"),
         "inputs": {"text": {"source": "api/text", "queue_size": 64}},
         "outputs": ["response"],
         "env": {"DORA_BATCH_SLOTS": "16", "DORA_PAGE_SIZE": "16", "DORA_PREFILL_CHUNK": "256",
                 "DORA_MULTISTEP_K": "8", "DORA_MAX_SEQ": "2048", "DORA_INT8_DECODE": "1",
                 "DORA_MAX_NEW_TOKENS": str(MIGRATE_MAX_NEW)},
         "deploy": {"machine": "B"}},
    ]}


class _Stream:
    """One streamed chat completion over HTTP, read as it arrives: the time it
    was sent, each content delta with its arrival time, the finish reason."""

    def __init__(self, port: int, ids, max_new: int):
        self.port, self.ids, self.max_new = port, ids, max_new
        self.sent = self.finish = self.error = None
        self.deltas: list[tuple[float, str]] = []

    def run(self) -> None:
        import http.client

        body = json.dumps({"stream": True, "max_tokens": self.max_new, "messages": [
            {"role": "user", "content": " ".join(map(str, self.ids))}]})
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=CLUSTER_START_S)
            self.sent = time.monotonic()
            conn.request("POST", "/v1/chat/completions", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                self.error = f"HTTP {resp.status}: {resp.read()[:200]!r}"
                return
            while line := resp.readline():
                if not line.startswith(b"data: ") or line.strip() == b"data: [DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                text = choice["delta"].get("content")
                if text:
                    self.deltas.append((time.monotonic(), text))
                if choice["finish_reason"] is not None:
                    self.finish = choice["finish_reason"]
            conn.close()
        except Exception as e:  # noqa: BLE001 (reported by the caller)
            self.error = f"{type(e).__name__}: {e}"

    @property
    def tokens(self) -> list[int]:
        return [int(t) for _t, text in self.deltas for t in text.split()]


def _streams(port: int, prompts, max_new: int) -> tuple[list[_Stream], list]:
    """The requests, sent at once, each on its own thread."""
    import threading

    streams = [_Stream(port, p, max_new) for p in prompts]
    threads = [threading.Thread(target=s.run, daemon=True) for s in streams]
    for t in threads:
        t.start()
    return streams, threads


def _wait_gateway(port: int, deadline: float) -> None:
    import urllib.request

    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=5):
                return
        except OSError:
            if time.monotonic() > deadline:
                raise Failed(f"cluster (b): the gateway never answered on port {port}")
            time.sleep(0.2)


def _cluster_pids(state: str) -> dict[str, int]:
    """The cluster's processes that ``up`` started, by pid file."""
    if not os.path.isdir(state):
        return {}
    out = {}
    for name in os.listdir(state):
        if name.endswith(".pid"):
            with open(os.path.join(state, name)) as f:
                out[name] = int(f.read().strip() or 0)
    return out


def _alive(pids: dict[str, int], deadline: float) -> list[str]:
    """Those of ``pids`` still running at ``deadline`` (a zombie counts as
    ended)."""
    def running(pid: int) -> bool:
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] != "Z"
        except (OSError, IndexError):
            return False

    while (left := [n for n, pid in pids.items() if running(pid)]) and time.monotonic() < deadline:
        time.sleep(0.1)
    return left


def _cluster_logs(work: str, state: str) -> None:
    """The tails of the cluster's logs and the dataflows' node logs, on a
    failure."""
    logs = [os.path.join(state, n) for n in sorted(os.listdir(state)) if n.endswith(".log")] \
        if os.path.isdir(state) else []
    out = os.path.join(work, "out")
    for run in sorted(os.listdir(out)) if os.path.isdir(out) else []:
        logs += [os.path.join(out, run, n) for n in sorted(os.listdir(os.path.join(out, run)))]
    for path in logs:
        with open(path, errors="replace") as f:
            tail = f.read()[-3000:]
        print(f"cluster: {os.path.relpath(path, work)}:\n{tail}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# phase 22: the observability planes, on phase 21's cluster
# ---------------------------------------------------------------------------

#: the history ring's cadence on the cluster's daemons (DORA_METRICS_HISTORY_S)
OBSERVE_HISTORY_S = 1.0
#: the daemons' flight-recorder slots: every message of (b) is a few events
#: on each daemon, which must all stay in the ring until the trace is read
OBSERVE_RING = 65536
#: the rule (b) must see fire while the streams decode and resolve after
OBSERVE_RULE = {"name": "serving-busy", "kind": "rate", "selector": "srv:*:decode_tokens",
                "op": ">", "threshold": 10, "window_s": 2, "severity": "info"}
OBSERVE_INSTANCE = "srv:llm:decode_tokens"
#: how long after the streams the rule may take to resolve (its window, the
#: node's report and the sampler's tick)
ALERT_RESOLVE_S = 15.0
#: (a): the ring's decode-token rate over the streams' window, against the
#: HTTP client's tokens a second
HISTORY_RATE_TOL = 0.15
#: (c): the dev_compute spans' sum over the streams' window, against the
#: node's device_compute_ns over it
DEV_COMPUTE_TOL = 0.10
#: (a): the busy share is read from the first sample of the ring taken this
#: long after the four streams were seen decoding: the node reports once a
#: second over the second before, and the ring holds its last report, so
#: the report interval such a sample holds lies inside the decode
UTIL_AFTER_S = 2.5
#: (a): how long ``top`` is asked again for such a sample
UTIL_WAIT_S = 8.0
#: (a): the least busy share of that interval: half of phase 4's graphed
#: K = 8 window (0.90 of its untraced wall, PERF.md PR 24), since the node
#: also emits and polls between windows
UTIL_MIN = 0.45
#: (d): the capture's seconds, and a short request sent this long after the
#: command, so that its prefill (kernel 4) runs inside the capture
PROFILE_S = 2.0
PROFILE_PREFILL_AFTER_S = 1.0
PROFILE_PREFILL_NEW = 8
#: (d): each of kernels 1-4 by the CUDA kernel that only it launches on the
#: main path (its launches open with rmsnorm_rows, which starts a segment):
#: the SwiGLU of kernel 1 (fused, or split over K), kernel 2's reduction,
#: the combine of the paged sweep that folds each decode row's own key
#: (kernel 3) or not (kernel 4)
PROFILE_MARKERS = (
    ("mlp_step", lambda base: base.startswith(("gateup_swiglu", "silu_mul"))),
    ("lm_head_argmax", lambda base: base.startswith("head_reduce")),
    ("attention_paged_batch_step",
     lambda base: base.startswith("sweep_combine<") and base.endswith("true>")),
    ("attention_paged_chunk_step",
     lambda base: base.startswith("sweep_combine<") and base.endswith("false>")),
)
#: a library product or attention kernel: what the plain versions launch
LIBRARY_KERNEL = ("gemm", "gemv", "cutlass", "cublas", "xmma", "flash", "fmha", "attention",
                  "softmax")


def _our_kernel_names(here: str) -> set[str]:
    """The ``__global__`` functions of the port's CUDA sources."""
    import glob
    import re

    names = set()
    for path in glob.glob(os.path.join(here, "dora_tpu_torch", "csrc", "*.c*")):
        with open(path) as f:
            names |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", f.read()))
    return names


def profile_kernels(trace_path: str, ours: set[str]) -> tuple[dict, dict]:
    """The CUDA kernel events of a ``torch.profiler`` Chrome trace, in stream
    order, cut into wrapper launches (each port kernel opens with
    ``rmsnorm_rows``) and each launch named by PROFILE_MARKERS: kernel ->
    [launches, device ms]; and the other kernels by name -> [count, ms]."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("cat") == "kernel" and "dur" in e]
    events.sort(key=lambda e: e["ts"])
    per: dict = {name: [0, 0.0] for name, _ in PROFILE_MARKERS}
    others: dict = {}
    segment: list = []

    def close():
        for name, is_marker in PROFILE_MARKERS:
            if any(is_marker(base) for base, _ in segment):
                per[name][0] += 1
                per[name][1] += sum(us for _, us in segment) / 1e3
                break
        segment.clear()

    for e in events:
        base = e["name"].split("(")[0].replace("void ", "").strip()
        short = base.split("<")[0].strip()
        if short not in ours:
            entry = others.setdefault(short, [0, 0.0])
            entry[0] += 1
            entry[1] += e["dur"] / 1e3
            continue
        if short == "rmsnorm_rows" and segment:
            close()
        segment.append((base, e["dur"]))
    close()
    return per, others


class Observer:
    """Phase 22: the observability planes on phase 21's cluster, through the
    port's CLI as a user runs it (``top``, ``alerts``, ``metrics``,
    ``trace``, ``profile``) and the coordinator's Prometheus endpoint."""

    def __init__(self, here: str, state: str, work: str, smi: str):
        self.here, self.state, self.work, self.smi = here, state, work, smi
        self.prom_port = _free_port()
        self.sink = os.path.join(work, "alerts.jsonl")
        #: a monotonic time plus this is the wall clock (the daemons' stamps)
        self.wall_of = time.time() - time.monotonic()
        self.polls: list = []
        #: moments of the phase on the monotonic clock, named for finish()
        self.marks: dict[str, float] = {}

    def cluster_env(self) -> dict:
        """The settings ``up`` gives the coordinator and the daemons."""
        return {"DORA_PROM_PORT": str(self.prom_port), "DORA_TRACING": "1",
                "DORA_METRICS_HISTORY_S": str(OBSERVE_HISTORY_S), "DORA_ALERT_SINK": "jsonl",
                "DORA_ALERT_SINK_FILE": self.sink,
                "DORA_FLIGHT_RECORDER_SIZE": str(OBSERVE_RING),
                "DORA_PROFILE_DIR": os.path.join(self.work, "profiles")}

    def _cli(self, *argv) -> str:
        return _cluster_cli(self.here, self.state, *argv)

    def _serving(self) -> dict:
        metrics = json.loads(self._cli("metrics", "--name", "serve", "--json"))
        return (metrics.get("serving") or {}).get("llm", {})

    def _alert(self) -> tuple[str, int, dict]:
        """The phase's rule as ``alerts --json`` shows it: state, incidents,
        the whole status."""
        status = json.loads(self._cli("alerts", "--name", "serve", "--json"))
        inst = ((status.get("rules") or {}).get(OBSERVE_RULE["name"], {})
                .get("instances") or {}).get(OBSERVE_INSTANCE, {})
        state = inst.get("state", "absent")
        self.polls.append((time.monotonic(), state))
        return state, int(inst.get("incidents", 0)), status

    def before_streams(self) -> None:
        """After (b)'s warmup: the node's next report, then its device-plane
        counter, the start of (c)'s comparison."""
        time.sleep(1.2)
        self.dev_before = self._serving().get("device_compute_ns") or 0

    def during_streams(self, threads) -> None:
        """``alerts --json`` over and over while (b)'s streams run."""
        while any(th.is_alive() for th in threads):
            self._alert()
        for th in threads:
            th.join(CLUSTER_START_S)

    def after_streams(self, streams) -> None:
        """(b) the rule's resolution and its sink, (e) the scrape, (c) the
        trace; kept for (a): the streams' window."""
        t0 = min(st.sent for st in streams)
        t1 = max(st.deltas[-1][0] for st in streams)
        self.window = (t0, t1)
        self.marks.update({"(b)'s streams sent": t0, "(b)'s last delta": t1})
        self.n_tok = sum(len(st.tokens) for st in streams)
        self.n_requests = len(streams) + 1  # and the warmup
        deadline = time.monotonic() + ALERT_RESOLVE_S
        while True:
            state, incidents, status = self._alert()
            if state == "ok" and incidents >= 1:
                break
            if time.monotonic() > deadline:
                raise Failed(f"phase 22 (b): {OBSERVE_RULE['name']} is {state!r} with "
                             f"{incidents} incidents {ALERT_RESOLVE_S} s after the streams")
            time.sleep(0.2)
        firing_polls = [t for t, st in self.polls if st == "firing"]
        if not firing_polls:
            raise Failed(f"phase 22 (b): `alerts --json` never showed {OBSERVE_RULE['name']} "
                         f"firing ({len(self.polls)} polls: {[st for _, st in self.polls]})")
        with open(self.sink) as f:
            records = [json.loads(line) for line in f if line.strip()]
        mine = [r["phase"] for r in records if r["rule"] == OBSERVE_RULE["name"]]
        if mine.count("firing") != 1 or mine.count("resolved") != 1:
            raise Failed(f"phase 22 (b): the JSONL sink holds {mine} for "
                         f"{OBSERVE_RULE['name']}, not one firing and one resolved")
        fired = next(r for r in records if r["rule"] == OBSERVE_RULE["name"]
                     and r["phase"] == "firing")
        w0, w1 = (t + self.wall_of for t in self.window)
        if not w0 <= fired["unix_s"] <= w1:
            raise Failed(f"phase 22 (b): {OBSERVE_RULE['name']} fired at "
                         f"{fired['unix_s'] - w0:+.3f} s of streams that ran {w1 - w0:.3f} s")
        pack = sorted(({r["rule"] for r in records if r["phase"] == "firing"}
                       | set(status.get("firing_total") or {})) - {OBSERVE_RULE["name"]})
        if pack:
            raise Failed(f"phase 22 (b): default-pack rules fired: {pack}")
        resolved = next(r for r in records if r["rule"] == OBSERVE_RULE["name"]
                        and r["phase"] == "resolved")
        print(f"phase 22 (b): {OBSERVE_RULE['name']} ({OBSERVE_RULE['kind']} of "
              f"{OBSERVE_RULE['selector']} {OBSERVE_RULE['op']} {OBSERVE_RULE['threshold']}/s "
              f"over {OBSERVE_RULE['window_s']} s) firing {fired['unix_s'] - w0:.3f} s into "
              f"streams of {w1 - w0:.3f} s (value {fired['value']}), resolved "
              f"{resolved['unix_s'] - w1:.3f} s after the last delta; `alerts --json` polled "
              f"{len(self.polls)} times, firing in {len(firing_polls)}; the JSONL sink: "
              f"{len(records)} records, {mine}, others "
              f"{[(r['rule'], r['phase']) for r in records if r['rule'] != OBSERVE_RULE['name']]}; "
              f"no default-pack rule fired [{self.smi}]",
              flush=True)
        self.scrape()
        self.trace()
        self.first_capture()

    def scrape(self) -> None:
        """(e) ``GET /metrics`` on the coordinator."""
        import re
        import urllib.request

        from dora_tpu_torch import prom

        with urllib.request.urlopen(f"http://127.0.0.1:{self.prom_port}/metrics",
                                    timeout=30) as r:
            ctype, text = r.headers.get("Content-Type"), r.read().decode()
        problems = prom.validate_exposition(text)
        if problems:
            raise Failed(f"phase 22 (e): the exposition has {len(problems)} findings: "
                         f"{problems[:5]}")
        m = re.search(r'^dora_serving_requests_total\{dataflow="serve",node="llm"\} (\S+)$',
                      text, re.M)
        got = float(m.group(1)) if m else None
        if got != self.n_requests:
            raise Failed(f"phase 22 (e): dora_serving_requests_total is {got}, and phase 21 "
                         f"sent {self.n_requests} requests")
        families = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
        print(f"phase 22 (e): GET /metrics on port {self.prom_port} ({ctype}): "
              f"{len(text.splitlines())} lines, {len(families)} families, no finding; "
              f"dora_serving_requests_total{{node='llm'}} {got:g} = the requests sent",
              flush=True)

    def trace(self) -> None:
        """(c) ``trace --out``: the Chrome trace's validity, the message spans
        on both machines, one request chain on the engine track for each of
        (b)'s requests, and the dev_compute spans against the node's device
        plane over the streams' window."""
        from dora_tpu_torch import tracing

        path = os.path.join(self.work, "trace.json")
        t = time.perf_counter()
        self._cli("trace", "--name", "serve", "--out", path)
        t_trace = time.perf_counter() - t
        with open(path) as f:
            trace = json.load(f)
        problems = tracing.validate_chrome_trace(trace)
        if problems:
            raise Failed(f"phase 22 (c): the trace has {len(problems)} findings: {problems[:5]}")
        events = trace["traceEvents"]
        tracks = {e["pid"]: e["args"]["name"] for e in events
                  if e["ph"] == "M" and e["name"] == "process_name"}
        spans: dict = {}
        for e in events:
            if e["ph"] == "X":
                spans.setdefault(tracks[e["pid"]].split("/")[0], set()).add(e["name"].split()[0])
        for machine in ("A", "B"):
            missing = {"send", "route", "deliver", "recv"} - spans.get(machine, set())
            if missing:
                raise Failed(f"phase 22 (c): no {sorted(missing)} span on machine {machine}'s "
                             f"tracks ({sorted(spans.get(machine, ()))})")
        llm = [pid for pid, name in tracks.items() if name == "B/llm"]
        engine = [e for e in events if e["ph"] == "X" and e["pid"] in llm
                  and e.get("cat") == "serving"]
        chains: dict = {}
        for e in engine:
            tid = (e.get("args") or {}).get("trace_id")
            if tid:
                chains.setdefault(tid, []).append(e)
        links = ("queued", "admitted", "prefill_chunk", "decode_window", "finish")
        full = {}
        for tid, chain in chains.items():
            chain.sort(key=lambda e: e["ts"])
            kinds = [e["name"].split()[0] for e in chain]
            if set(links) <= set(kinds):
                first = [kinds.index(k) for k in links]
                if first != sorted(first) or kinds[-1] != "finish":
                    raise Failed(f"phase 22 (c): request chain {tid} runs {kinds}")
                full[tid] = chain
        if len(full) != self.n_requests - 1:
            raise Failed(f"phase 22 (c): {len(full)} queued -> admitted -> prefill_chunk -> "
                         f"decode_window -> finish chains on the node's engine track, for "
                         f"{self.n_requests - 1} requests ({len(chains)} trace ids there)")
        start = min(c[0]["ts"] for c in full.values())
        end = max(c[-1]["ts"] + c[-1]["dur"] for c in full.values())
        dev = [e for e in engine if e["name"].startswith("dev_compute")
               and start - 5e4 <= e["ts"] and e["ts"] + e["dur"] <= end + 5e4]
        span_ms = sum(e["dur"] for e in dev) / 1e3
        node_ms = ((self._serving().get("device_compute_ns") or 0) - self.dev_before) / 1e6
        truncated = [e["name"] for e in events if e["name"].startswith("trace truncated")]
        print(f"phase 22 (c): `trace --out` in {t_trace:.2f} s: {len(events)} events on "
              f"{len(tracks)} tracks, no finding; send/route/deliver/recv on A and B; "
              f"{len(full)} request chains on B/llm's engine track; {len(dev)} dev_compute "
              f"spans {span_ms:.1f} ms over the streams against the node's device_compute_ns "
              f"{node_ms:.1f} ms ({(span_ms - node_ms) / max(node_ms, 1e-9) * 100:+.2f} %); "
              f"dropped events: {truncated or 0} [{self.smi}]", flush=True)
        if node_ms <= 0 or abs(span_ms - node_ms) > DEV_COMPUTE_TOL * node_ms:
            raise Failed(f"phase 22 (c): dev_compute spans sum {span_ms:.1f} ms, the node's "
                         f"device plane {node_ms:.1f} ms over the streams' window")

    def live(self, streams, gateway: int, prompt) -> None:
        """(a) ``top --once --json`` and (d) ``profile llm`` while the four
        streams of (c) decode (and ``prompt`` is prefilled, for kernel 4)."""
        t_live = time.monotonic()
        after_ns = (t_live + UTIL_AFTER_S + self.wall_of) * 1e9
        busy_key = "srv:llm:device_busy_fraction"
        while True:
            top = json.loads(self._cli("top", "--name", "serve", "--once", "--json"))
            inside = [s for s in top.get("samples") or []
                      if s["t_ns"] >= after_ns and busy_key in s["gauges"]]
            if inside:
                break
            if time.monotonic() > t_live + UTIL_WAIT_S:
                raise Failed(f"phase 22 (a): no sample of {busy_key} in the ring "
                             f"{UTIL_AFTER_S} s after the four streams decoded, "
                             f"{UTIL_WAIT_S} s on")
            time.sleep(0.3)
        util = inside[0]["gauges"][busy_key]
        at = inside[0]["t_ns"] / 1e9 - self.wall_of - t_live
        util_now = (top.get("util") or {}).get("llm", {}).get("device_busy_fraction")
        interval = top.get("interval_s") or OBSERVE_HISTORY_S
        w0, w1 = ((t + self.wall_of) * 1e9 for t in self.window)
        samples = top.get("samples") or []
        cover = []
        for machine in ("A", "B"):
            ts = sorted(s["t_ns"] for s in samples if s["machine"] == machine
                        and w0 - 1.5e9 * interval <= s["t_ns"] <= w1 + 1.5e9 * interval)
            gaps = [(b - a) / 1e9 for a, b in zip(ts, ts[1:])]
            if (not ts or ts[0] > w0 + 1.5e9 * interval or ts[-1] < w1 - 1.5e9 * interval
                    or max(gaps, default=0) > 1.5 * interval):
                raise Failed(f"phase 22 (a): machine {machine}'s history over the streams' "
                             f"{(w1 - w0) / 1e9:.2f} s window: {len(ts)} samples, gaps "
                             f"{[round(g, 3) for g in gaps]}")
            cover.append(f"{machine} {len(ts)} samples (largest gap {max(gaps, default=0):.3f} s)")
        tok = sum(s["counters"].get(OBSERVE_INSTANCE, 0) for s in samples
                  if w0 < s["t_ns"] <= w1 + 2.5e9 * interval)
        span = (w1 - w0) / 1e9
        ring_rate, client_rate = tok / span, self.n_tok / span
        print(f"phase 22 (a): `top --once --json`: machines {top.get('machines')}, "
              f"{len(samples)} samples; over the streams' window {'; '.join(cover)}; the ring's "
              f"decode tokens {tok:g} over {span:.3f} s = {ring_rate:.1f} tokens/s against the "
              f"HTTP client's {client_rate:.1f} ({(ring_rate / client_rate - 1) * 100:+.2f} %); "
              f"rates.tokens_per_s {top.get('rates', {}).get('tokens_per_s')}; busy share "
              f"{util} over the report interval before {at:.2f} s into the four streams' "
              f"decode (the util block now {util_now}) [{self.smi}]",
              flush=True)
        if abs(ring_rate - client_rate) > HISTORY_RATE_TOL * client_rate:
            raise Failed(f"phase 22 (a): the ring's {ring_rate:.1f} decode tokens/s against the "
                         f"client's {client_rate:.1f}")
        if util is None or not UTIL_MIN <= util <= 1 or util_now is None:
            raise Failed(f"phase 22 (a): the device busy share over a report interval of the "
                         f"four streams' decode is {util} (at least {UTIL_MIN}); the util "
                         f"block's {util_now}")
        self.profile(streams, gateway, prompt)

    def _capture(self, out: str, what: str) -> tuple[str, str, dict]:
        """The artifact ``profile`` printed: a directory with the Chrome trace
        and the capture thread's step timings (a synthetic marker fails)."""
        artifact = out.strip().splitlines()[-1]
        trace_path = os.path.join(artifact, "trace.json")
        timings_path = os.path.join(artifact, "capture.json")
        if not os.path.isdir(artifact) or not os.path.isfile(trace_path):
            reason = ""
            if os.path.isfile(artifact):
                with open(artifact) as f:
                    reason = f.read()[:500]
            raise Failed(f"phase 22 (d): {what} is {artifact!r}, not a directory with a "
                         f"torch.profiler trace.json {reason}")
        if not os.path.isfile(timings_path):
            raise Failed(f"phase 22 (d): no capture.json beside {what}'s trace in {artifact}")
        with open(timings_path) as f:
            return artifact, trace_path, json.load(f)

    def _mark(self, what: str, steps: dict) -> None:
        """The moments of a capture, on the monotonic clock, for finish()."""
        started = steps["started_unix"] - self.wall_of
        stopped = steps["stopped_unix"] - self.wall_of
        self.marks[f"{what}'s profiler started"] = started
        self.marks[f"{what}'s profiler stopped"] = stopped
        self.marks[f"{what} exported"] = stopped + steps.get("stop_s", 0) + steps.get(
            "export_s", 0)

    @staticmethod
    def _steps(steps: dict) -> str:
        return (f"the node's capture thread: start {steps['start_s']:.3f} s, stop "
                f"{steps.get('stop_s', 0):.3f} s, export {steps.get('export_s', 0):.3f} s, "
                f"profiling {steps['stopped_unix'] - steps['started_unix']:.3f} s "
                f"({'+'.join(steps['options'])})")

    def first_capture(self) -> None:
        """(d), first: the node process's first capture, with the node idle
        after (b): it pays the profiler's one-time set-up (Kineto's and
        CUPTI's) on the capture thread, and must still answer within the
        coordinator's wait."""
        t = time.monotonic()
        self.marks["the first capture asked"] = t
        out = self._cli("profile", "llm", "--name", "serve", "--seconds", str(PROFILE_S))
        t_reply = time.monotonic() - t
        artifact, trace_path, steps = self._capture(out, "the first capture")
        self._mark("the first capture", steps)
        print(f"phase 22 (d): the node's first capture, idle: `profile llm --seconds "
              f"{PROFILE_S:g}` answered in {t_reply:.2f} s with {artifact} "
              f"({os.path.getsize(trace_path) / 1e6:.2f} MB trace.json); "
              f"{self._steps(steps)} [{self.smi}]", flush=True)

    def profile(self, streams, gateway: int, prompt) -> None:
        """(d) a ``torch.profiler`` capture of the node while the streams
        decode and one more request is prefilled: kernels 1-4 under their
        CUDA names, no plain version; the streams decoded over the whole
        time the profiler ran."""
        import threading

        reply: dict = {}

        def ask():
            try:
                reply["out"] = self._cli("profile", "llm", "--name", "serve", "--seconds",
                                         str(PROFILE_S))
            except Exception as e:  # noqa: BLE001 (raised below, in this thread)
                reply["error"] = e

        t = time.monotonic()
        self.marks["the second capture asked"] = t
        asker = threading.Thread(target=ask, daemon=True)
        asker.start()
        time.sleep(PROFILE_PREFILL_AFTER_S)
        extra, extra_threads = _streams(gateway, [prompt], PROFILE_PREFILL_NEW)
        for th in extra_threads + [asker]:
            th.join(CLUSTER_CMD_S)
        t_reply = time.monotonic() - t
        if "error" in reply:
            raise reply["error"]
        if extra[0].error or len(extra[0].tokens) != PROFILE_PREFILL_NEW:
            raise Failed(f"phase 22 (d): the request sent during the capture ended "
                         f"{extra[0].error or extra[0].finish} with {extra[0].tokens}")
        artifact, trace_path, steps = self._capture(reply["out"], "the capture")
        self._mark("the second capture", steps)
        t0, t1 = (steps[k] - self.wall_of for k in ("started_unix", "stopped_unix"))
        short = [i for i, st in enumerate(streams)
                 if not st.deltas or st.deltas[0][0] > t0 or st.deltas[-1][0] < t1]
        if short:
            raise Failed(f"phase 22 (d): streams {short} did not decode over the "
                         f"{t1 - t0:.3f} s the profiler ran ({self._steps(steps)})")
        t2 = t1 + steps["stop_s"] + steps["export_s"]
        # the four streams' longest wait for a delta: before the capture,
        # while the profiler ran, and while it stopped and exported
        stalls = [max((b[0] - a[0] for st in streams for a, b in zip(st.deltas, st.deltas[1:])
                       if lo <= b[0] and a[0] <= hi), default=0.0)
                  for lo, hi in ((t - 2.0, t), (t0, t1), (t1, t2))]
        per, others = profile_kernels(trace_path, _our_kernel_names(self.here))
        lib = {n: c for n, c in others.items() if any(w in n.lower() for w in LIBRARY_KERNEL)}
        top_others = sorted(others.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"phase 22 (d): `profile llm --seconds {PROFILE_S:g}` answered in {t_reply:.2f} s "
              f"with {artifact} ({os.path.getsize(trace_path) / 1e6:.1f} MB trace.json); "
              f"{self._steps(steps)}; the four streams' longest wait for a delta "
              f"{stalls[0]:.3f} s in the 2 s before the command, {stalls[1]:.3f} s while the "
              f"profiler ran, {stalls[2]:.3f} s while it stopped and exported; "
              + "; ".join(f"{name} {n} launches {ms:.2f} device ms" for name, (n, ms)
                          in per.items())
              + f"; other kernels: {[(n, c, round(ms, 2)) for n, (c, ms) in top_others]} "
              f"[{self.smi}]", flush=True)
        missing = [name for name, (n, _) in per.items() if not n]
        if missing:
            raise Failed(f"phase 22 (d): no launch of {missing} in the capture")
        if lib:
            raise Failed(f"phase 22 (d): library kernels in the capture (a plain version ran): "
                         f"{lib}")

    def finish(self, rate_21: str) -> None:
        """After the stop: (b)'s gate over the whole phase, no rule of the
        default pack fired (the JSONL sink, and the longest the node's fleet
        digest went unpublished); (f) the cost of tracing: phase 20 (b) over
        tcp without DORA_TRACING=1 and, with ``--observe``, with it (the
        same node and requests, this run), and phase 21 (b) with it."""
        with open(self.sink) as f:
            pack = sorted({r["rule"] for r in map(json.loads, filter(str.strip, f))
                           if r["phase"] == "firing"} - {OBSERVE_RULE["name"]})
        top = json.loads(self._cli("top", "--name", "serve", "--once", "--json"))
        ages = sorted((s["gauges"]["fleet:llm:digest_age_s"], s["t_ns"] / 1e9 - self.wall_of)
                      for s in top["samples"] if "fleet:llm:digest_age_s" in s["gauges"])
        age, when = ages[-1] if ages else (None, None)
        where = "no sample"
        if when is not None:
            before = [(t, m) for m, t in self.marks.items() if t <= when]
            where = (f"{when - max(before)[0]:.2f} s after {max(before)[1]}" if before
                     else "before (b)'s streams")
        print(f"phase 22 (b)-(d): default-pack rules that fired over the phase: "
              f"{pack or 'none'}; the node's fleet digest at most {age} s old in the ring, "
              f"{where} [{self.smi}]", flush=True)
        if pack:
            raise Failed(f"phase 22 (b): default-pack rules fired: {pack} (the node's fleet "
                         f"digest at most {age} s old)")
        earlier = EARLIER.get("flow_b", {})
        print(f"phase 22 (f): tracing off / on, phase 20 (b) tcp: "
              f"{earlier.get('tcp', 'not run')} / "
              f"{earlier.get('tcp traced', 'not run (--observe)')}; "
              f"phase 21 (b) through the gateway with DORA_TRACING=1: {rate_21} [{self.smi}]",
              flush=True)


def serve_cluster(torch, DB, LO, IM, L, qwen2, serve_prompts, smi: str, scratch: str,
                  here: str, layers: int, seed: int, prompts, max_new: int, served,
                  dev: str = "cuda", observe: bool = False) -> dict:
    """Phase 21: the port's cluster tier, from ``up`` to HTTP, on one card;
    with ``observe``, phase 22 on the same cluster (an ``Observer``). Returns
    the serving node's launches over (b) and (c)."""
    from dora_tpu_torch.cli.control import ControlConnection
    from dora_tpu_torch.message import coordinator as cm

    t0 = time.perf_counter()
    cfg = qwen2.Qwen2Config.qwen2_1_5b(layers=layers, max_seq=2048)
    params = qwen2.quantize_decode(qwen2.random_params(cfg, seed=seed, std=0.02, device=dev),
                                   cfg)
    paths = _Paths(torch, DB, LO, IM, qwen2, L, serve_prompts, params, cfg)
    with tempfile.TemporaryDirectory(prefix="cluster-", dir=scratch) as work:
        state = os.path.join(work, "state")
        obs = Observer(here, state, work, smi) if observe else None
        try:
            # (a) two machines on this host, then the two-machine example
            t = time.perf_counter()
            for machine in ("A", "B"):
                _cluster_cli(here, state, "up", "--machine-id", machine,
                             env=obs.cluster_env() if obs else None)
            with ControlConnection() as c:
                machines = c.request(cm.ConnectedMachines()).machines
            if machines != ["A", "B"]:
                raise Failed(f"cluster (a): registered machines {machines}, not A and B")
            t_up = time.perf_counter() - t
            example = os.path.join(work, "multiple-daemons.yml")
            with open(os.path.join(here, "dora_tpu_torch/examples/multiple-daemons.yml")) as f:
                text = f.read()
            with open(example, "w") as f:
                f.write(text)
            t = time.perf_counter()
            out = _cluster_cli(here, state, "start", example, "--name", "multi", "--attach")
            t_multi = time.perf_counter() - t
            uuid = out.splitlines()[0].strip()
            if f"dataflow {uuid} finished successfully" not in out:
                raise Failed(f"cluster (a): start --attach printed {out[-1000:]}")
            logs = _cluster_cli(here, state, "logs", "receiver", "--uuid", uuid)
            if "asserted 3 inputs OK" not in logs:
                raise Failed(f"cluster (a): the receiver's log is {logs[-500:]!r}")
            print(f"cluster (a): `up` A and B registered in {t_up:.2f} s; multiple-daemons.yml "
                  f"across them ({uuid}) finished in {t_multi:.2f} s through `start --attach`; "
                  f"`logs receiver`: {logs.strip()!r}", flush=True)

            # (b) the serving node behind the gateway, on two machines
            import yaml

            counts = os.path.join(work, "llm.launches.json")
            gateway = _free_port()
            flow = os.path.join(work, "llm-server.yml")
            with open(flow, "w") as f:
                yaml.safe_dump(llm_flow_desc(counts, gateway, layers, seed, dev,
                                             {"rules": [OBSERVE_RULE]} if obs else None), f)
            t = time.perf_counter()
            serve_uuid = _cluster_cli(here, state, "start", flow, "--name", "serve").strip()
            listed = _cluster_cli(here, state, "list")
            if listed.split() != [serve_uuid, "serve"]:
                raise Failed(f"cluster (b): `list` printed {listed!r}")
            _wait_gateway(gateway, time.monotonic() + CLUSTER_START_S)
            t_start = time.perf_counter() - t
            warm, threads = _streams(gateway, [list(range(1, 33))], 1)
            threads[0].join(CLUSTER_START_S)
            if warm[0].error or warm[0].finish != "length" or len(warm[0].tokens) != 1:
                raise Failed(f"cluster (b): the warmup request ended {warm[0].error or warm[0].finish}"
                             f" with {warm[0].tokens}")
            if obs:
                obs.before_streams()
            streams, threads = _streams(gateway, prompts, max_new)
            if obs:
                obs.during_streams(threads)
            for th in threads:
                th.join(CLUSTER_START_S)
            parted = 0
            for i, st in enumerate(streams):
                if st.error or st.finish != "length" or len(st.tokens) != max_new:
                    raise Failed(f"cluster (b): request {i} ended {st.error or st.finish} with "
                                 f"{len(st.tokens)} of {max_new} tokens")
                parted += _hold_to_phase4(f"cluster (b): request {i}", paths, prompts[i],
                                          st.tokens, served[i], max_new) < max_new
            ttft = [st.deltas[0][0] - st.sent for st in streams]
            span = max(st.deltas[-1][0] for st in streams) - min(st.sent for st in streams)
            n_tok = sum(len(st.tokens) for st in streams)
            earlier = EARLIER.get("flow_b", {})
            rate_21 = (f"TTFT p50 {_pct(ttft, 50):.4f} s max {max(ttft):.4f} s, "
                       f"{n_tok / span:.1f} tokens/s")
            print(f"cluster (b): {len(streams)} streamed requests through the gateway on A to "
                  f"the node on B, {n_tok} tokens in {span:.3f} s from the first send to the last "
                  f"delta ({n_tok / span:.1f} tokens/s at the HTTP client); "
                  f"{len(streams) - parted} streams equal phase 4's token for token, {parted} "
                  f"part at near-ties; TTFT p50 {_pct(ttft, 50):.4f} s max {max(ttft):.4f} s; "
                  f"phase 20 (b) this run: shmem {earlier.get('shmem', 'not run')}, tcp "
                  f"{earlier.get('tcp', 'not run')}; `start` to the gateway's first answer "
                  f"{t_start:.1f} s (node start and weights included) [{smi}]", flush=True)

            if obs:
                obs.after_streams(streams)

            # (c) migrate while streams are live
            handoff = os.path.join(work, "handoff")
            order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:MIGRATE_STREAMS]
            live, threads = _streams(gateway, [prompts[i] for i in order], MIGRATE_MAX_NEW)
            deadline = time.monotonic() + CLUSTER_START_S
            while min(len(st.deltas) for st in live) < MIGRATE_AFTER_CHUNKS:
                if time.monotonic() > deadline or any(st.error for st in live):
                    raise Failed(f"cluster (c): streams before migrate: "
                                 f"{[(len(st.deltas), st.error) for st in live]}")
                time.sleep(0.01)
            if obs:
                obs.live(live, gateway, prompts[order[-1]])
            t = time.perf_counter()
            out = _cluster_cli(here, state, "migrate", "llm", "--handoff-dir", handoff,
                               "--name", "serve")
            deadline = time.monotonic() + CLUSTER_CMD_S
            while not (files := [n for n in (os.listdir(handoff) if os.path.isdir(handoff)
                                             else []) if n.endswith(".json")]):
                if time.monotonic() > deadline:
                    raise Failed(f"cluster (c): no handoff file in {handoff} after `migrate`")
                time.sleep(0.05)
            t_drain = time.perf_counter() - t
            with open(os.path.join(handoff, files[0])) as f:
                handed = json.load(f)
            moved = [m["request_id"] for m in handed["engine"]["slots"]] + \
                [b[0] for b in handed["backlog"]]
            if len(moved) != MIGRATE_STREAMS or len(handed["wire_ids"]) != MIGRATE_STREAMS:
                raise Failed(f"cluster (c): the handoff file holds {moved}, "
                             f"{handed['wire_ids']}; {MIGRATE_STREAMS} live streams were sent")
            got = [len(st.tokens) for st in live]
            print(f"cluster (c): `migrate llm` ({out.strip()}) with {MIGRATE_STREAMS} streams "
                  f"live at {got} tokens: {files[0]} holds {len(moved)} drained streams "
                  f"(wire ids {sorted(handed['wire_ids'].values())}), {t_drain:.3f} s from the "
                  f"command to the file [{smi}]", flush=True)
            # the node reports its serving counters once a second: its
            # migrated_out shows the drain through `metrics`
            deadline = time.monotonic() + 10
            while True:
                metrics = json.loads(_cluster_cli(here, state, "metrics", "--name", "serve",
                                                  "--json"))
                serving = (metrics.get("serving") or {}).get("llm", {})
                if (serving.get("migrated_out") or 0) >= MIGRATE_STREAMS:
                    break
                if time.monotonic() > deadline:
                    raise Failed(f"cluster (c): `metrics` shows migrated_out "
                                 f"{serving.get('migrated_out')} 10 s after the drain")
                time.sleep(0.5)
            out = _cluster_cli(here, state, "stop", "--name", "serve", "--grace-duration", "30")
            if "finished successfully" not in out:
                raise Failed(f"cluster (c): `stop` printed {out[-1000:]}")
            for th in threads:
                th.join(CLUSTER_CMD_S)
            link = metrics["links"].get("llm/response", {})
            print(f"cluster (c): `metrics` before stop: llm/response {link.get('msgs')} messages "
                  f"(sent on B, arrived on A), serving requests {serving.get('requests')} "
                  f"migrated_out {serving.get('migrated_out')}", flush=True)
            launches = _node_counts("cluster (b)-(c)", counts, SPEC_OFF_KERNELS)
            if obs:
                obs.finish(rate_21)
        except Failed:
            _cluster_logs(work, state)
            raise
        finally:
            pids = _cluster_pids(state)
            try:
                _cluster_cli(here, state, "destroy", timeout=CLUSTER_CMD_S)
            except (Failed, subprocess.TimeoutExpired) as e:
                print(f"cluster: destroy: {e}", file=sys.stderr, flush=True)
            left = _alive(pids, time.monotonic() + 30)
        if left or _cluster_pids(state):
            raise Failed(f"cluster: processes {left} or pid files "
                         f"{sorted(_cluster_pids(state))} left after `destroy`")
    del paths, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    print(f"cluster: phase 21{' and 22' if observe else ''} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 23: operator nodes and peer-to-peer edges
# ---------------------------------------------------------------------------

#: (a): frames the camera of vlm-recorder.yml sends (seeded, VLM_FLOW_SEED)
RECORDER_FRAMES = 10
#: (b): runs of the tcp leg with DORA_P2P=0
P2P_OFF_TCP_RUNS = 5
#: (c): the values the C node sends (its srand(42) and rand() % 100)
C_FLOW_VALUES = 20

#: (a): the VLM operator's source: make_vlm, with the node's kernel launches
#: and plain calls (tools/_common.KernelCounters) written when it exits
_COUNTED_VLM = """
import atexit
import json

from dora_tpu_torch.nodehub.ops import make_vlm
from dora_tpu_torch.tools._common import KernelCounters


def make(device=None):
    counters = KernelCounters().__enter__()
    atexit.register(lambda: json.dump({{**counters.report(), "exit": 0}}, open({out!r}, "w")))
    return make_vlm(device=device)
"""


def recorder_dataflow(torch, smi: str, scratch: str, here: str, dev: str = "cuda",
                      size: str = "bench") -> None:
    """Phase 23 (a): dora_tpu_torch/examples/vlm-recorder.yml (its VLM an
    ``operator: torch:`` node of ``make_vlm`` at bench_2b on int8 weights,
    the operator's file counting the node's launches) through the port's
    ``run_dataflow`` with peer-to-peer edges on, RECORDER_FRAMES seeded
    frames, and a recorder of the tokens beside it: every caption equals
    ``vlm.generate`` on the frame it names, kernels 11, 7, 9, 1 and 2
    launched in the node with no plain call, the sharegpt dataset and the
    HTML replay written and parsed (their PNGs read back as the frames), the
    daemon's peer-to-peer edges printed."""
    import numpy as np
    import yaml

    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.models import tokenizer, vlm
    from dora_tpu_torch.nodehub.camera import seeded_frame
    from dora_tpu_torch.nodehub.imaging import decode_png

    cfg = vlm.VLMConfig.bench_2b() if size != "tiny" else vlm.VLMConfig.tiny()
    what = "phase 23 (a) vlm-recorder"
    with open(os.path.join(here, "dora_tpu_torch", "examples", "vlm-recorder.yml")) as f:
        raw = yaml.safe_load(f)
    with tempfile.TemporaryDirectory(prefix="vlm-recorder-", dir=scratch) as work:
        counts = os.path.join(work, "vlm.launches.json")
        with open(os.path.join(work, "counted_vlm.py"), "w") as f:
            f.write(_COUNTED_VLM.format(out=counts))
        nodes = {n["id"]: n for n in raw["nodes"]}
        nodes["camera"]["env"].update(IMAGE_WIDTH=str(cfg.image_size),
                                      IMAGE_HEIGHT=str(cfg.image_size),
                                      SEED=str(VLM_FLOW_SEED), MAX_FRAMES=str(RECORDER_FRAMES))
        op = nodes["vlm"]["operator"]
        if op["torch"] != "dora_tpu_torch.nodehub.ops:make_vlm":
            raise Failed(f"{what}: the example's VLM is {op['torch']!r}")
        op["torch"] = ("counted_vlm.py:make" if dev == "cuda"
                       else {"source": "counted_vlm.py:make", "device": dev})
        nodes["vlm"]["env"] = {"DORA_MODEL_SIZE": size, "DORA_INT8_DECODE": "1"}
        raw["nodes"].append({"id": "tokens", "path": "module:dora_tpu_torch.nodehub.record",
                             "inputs": {"tokens": "vlm/op/tokens"},
                             "env": {"RECORD_DIR": "record"}})
        knobs = dict(DORA_INT4_DECODE=None, DORA_INT8_PURE=None, DORA_SPEC_DECODE=None,
                     DORA_MAX_NEW_TOKENS=None, DORA_PROMPT=None, DORA_CHECKPOINT=None,
                     DORA_HF_CHECKPOINT=None, DORA_PARAM_DTYPE=None, DORA_MESH=None,
                     DORA_PIPELINE_DEPTH=None, DORA_FETCH_EVERY=None, DORA_TOKENIZER=None,
                     DORA_P2P=None)
        with _env(**knobs), _EdgeLog() as edges:
            wall = _flow(Descriptor.parse(raw), work, what)
        launches = _node_counts(what, counts, VLM_GREEDY_KERNELS)
        data = os.path.join(work, "llama-factory-out", "data")
        try:
            rows = _recorded(os.path.join(work, "record", "tokens.parquet"))
            with open(os.path.join(data, "dora_demo.json")) as f:
                records = [json.loads(line) for line in f]
            with open(os.path.join(data, "dataset_info.json")) as f:
                info = json.load(f)
            pngs = []
            for r in records:
                for p in r["images"]:
                    with open(os.path.join(data, p), "rb") as f:
                        pngs.append(decode_png(f.read()))
            with open(os.path.join(work, "rerun-out", "replay.html")) as f:
                html = f.read()
        except (OSError, ValueError, KeyError) as e:
            raise Failed(f"{what}: {type(e).__name__}: {e}; {_flow_logs(work, tail=12)}")
    print(f"{what}: daemon: {'; '.join(edges.lines) or 'no peer-to-peer edge line'}",
          flush=True)
    if not edges.lines or "camera/image -> recorder/image" not in edges.lines[-1]:
        raise Failed(f"{what}: the camera's edges were not paired: {edges.lines}")
    if len(rows) < 2:
        raise Failed(f"{what}: {len(rows)} captions of {RECORDER_FRAMES} frames")
    t = time.perf_counter()
    params = vlm.quantize_decode(vlm.init_params(cfg, seed=0, device=dev))  # make_vlm's
    prompt = torch.tensor([[x % cfg.vocab for x in tokenizer.encode("describe")]],
                          dtype=torch.int32, device=dev)
    ref = {}
    for j, (tokens, meta, _t) in enumerate(rows):
        i = meta["frame"]
        if i not in ref:
            image = (torch.from_numpy(seeded_frame(cfg.image_size, cfg.image_size,
                                                   VLM_FLOW_SEED, i)).to(dev).float()
                     / 255.0)[None]
            ref[i] = vlm.generate(params, cfg, image, prompt, 16)[0].cpu().tolist()
        if tokens != ref[i]:
            raise Failed(f"{what}: caption {j} (frame {i}) differs from this process's "
                         f"vlm.generate: {tokens} against {ref[i]}")
    del params
    torch.cuda.empty_cache()
    ticks = launches["flash_attention"] // cfg.vision_layers
    steps = ticks * 15
    want = {"flash_attention": ticks * cfg.vision_layers, "attention_step": cfg.layers * steps,
            "mlp_step": cfg.layers * steps, "lm_head_argmax": steps}
    got = {n: launches[n] for n in want}
    if ticks != len(rows) or got != want:
        raise Failed(f"{what}: {len(rows)} captions, {ticks} ticks launched {got}, expected "
                     f"{want}")
    answers = sorted(r["messages"][1]["content"] for r in records)
    if answers != sorted(tokenizer.decode(v) for v, _m, _t in rows):
        raise Failed(f"{what}: the dataset's answers are not the captions: {answers[:3]}")
    if info.get("dora_demo", {}).get("formatting") != "sharegpt":
        raise Failed(f"{what}: dataset_info.json {info}")
    def script_json(name: str):
        return json.loads(re.search(rf"const {name} = (.*);\n", html).group(1)
                          .replace("<\\/", "</"))

    frames, texts = script_json("FRAMES"), script_json("TEXTS")
    shown = [decode_png(base64.b64decode(f["png"])) for f in frames]
    known = [seeded_frame(cfg.image_size, cfg.image_size, VLM_FLOW_SEED, i)[..., ::-1]
             for i in range(RECORDER_FRAMES)]
    if (len(frames) != RECORDER_FRAMES or len(texts) != len(rows)
            or not all(np.array_equal(a, b) for a, b in zip(shown, known))
            or not all(any(np.array_equal(p, k) for k in known) for p in pngs)):
        raise Failed(f"{what}: the replay holds {len(frames)} frames and {len(texts)} texts, "
                     f"the dataset {len(pngs)} PNGs, not the camera's frames and the captions")
    print(f"{what}: {len(rows)} captions of {RECORDER_FRAMES} frames (queue_size 1 drops the "
          f"rest), each equal to vlm.generate on its frame here; node launches "
          f"{json.dumps(got)} + int8_matmul {launches['int8_matmul']}, no plain call; "
          f"{len(records)} sharegpt pairs, {len(pngs)} PNGs (the camera's frames), the HTML "
          f"replay {len(frames)} frames and {len(texts)} captions; dataflow wall {wall:.1f} s "
          f"(weights, start and the run; reference {time.perf_counter() - t:.1f} s) [{smi}]",
          flush=True)


def p2p_serving(torch, DB, LO, IM, L, qwen2, serve_prompts, smi: str, scratch: str,
                layers: int, seed: int, prompts, max_new: int, served=None) -> None:
    """Phase 23 (b): phase 20 (b)'s serving leg with peer-to-peer edges on
    and with DORA_P2P=0, over shmem and over tcp, in the order on, off, off,
    on for each transport (so neither route always runs first), then the tcp
    leg with DORA_P2P=0 until it ran P2P_OFF_TCP_RUNS times: every stream
    held to phase 4's, a lost request fails the leg with every node's log
    tail; TTFT p50 and tokens a second of each leg, and each route's mean,
    per transport."""
    legs = []
    for comm in ("shmem", "tcp"):
        legs += [(comm, None, None), (comm, None, "0"), (comm, None, "0"), (comm, None, None)]
    legs += [("tcp", None, "0")] * (P2P_OFF_TCP_RUNS - 2)
    EARLIER.pop("flow_b_num", None)  # phase 20 (b)'s legs ran at another time
    serve_dataflow(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch, layers, seed,
                   prompts, max_new, served, legs=legs)
    nums = EARLIER["flow_b_num"]
    for comm in ("shmem", "tcp"):
        on = [nums[comm], nums[f"{comm} #2"]]
        off = [nums[f"{comm} DORA_P2P=0"], nums[f"{comm} DORA_P2P=0 #2"]]
        mean = [(sum(t for t, _r in v) / 2, sum(r for _t, r in v) / 2) for v in (on, off)]
        print(f"phase 23 (b) {comm}, legs on / off / off / on: TTFT p50 "
              + " / ".join(f"{t:.4f}" for t, _r in (on[0], *off, on[1])) + " s, tokens/s "
              + " / ".join(f"{r:.1f}" for _t, r in (on[0], *off, on[1]))
              + f"; mean peer-to-peer {mean[0][0]:.4f} s, {mean[0][1]:.1f} tokens/s, "
              f"DORA_P2P=0 {mean[1][0]:.4f} s, {mean[1][1]:.1f} tokens/s, peer-to-peer "
              f"{100 * (mean[0][1] / mean[1][1] - 1):+.1f} % tokens/s [{smi}]", flush=True)
    runs = [v for k, v in nums.items() if k.startswith("tcp DORA_P2P=0")]
    print(f"phase 23 (b): {len(runs)} tcp legs with DORA_P2P=0 delivered every request; "
          "TTFT p50 " + ", ".join(f"{t:.4f}" for t, _r in runs) + " s; tokens/s "
          + ", ".join(f"{r:.1f}" for _t, r in runs) + f" [{smi}]", flush=True)


def c_dataflow(smi: str, scratch: str, here: str) -> None:
    """Phase 23 (c): examples/c-dataflow, unchanged, copied with native/ into
    a scratch directory, through the port CLI's ``build`` and ``run``: its
    C sink prints the running sums of the C node's values (glibc's
    srand(42), rand() % 100) as the C operator in the port's runtime
    formats them."""
    import ctypes

    what = "phase 23 (c) c-dataflow"
    libc = ctypes.CDLL(None)
    libc.srand(42)
    total, want = 0, []
    for i in range(1, C_FLOW_VALUES + 1):
        total += libc.rand() % 100
        want.append(f"c sink: sum={total} after {i}")
    with tempfile.TemporaryDirectory(prefix="c-flow-", dir=scratch) as work:
        example = os.path.join(work, "examples", "c-dataflow")
        shutil.copytree(os.path.join(here, "examples", "c-dataflow"), example,
                        ignore=shutil.ignore_patterns("out", "*.o", "*.so", "c_node", "c_sink"))
        shutil.copytree(os.path.join(here, "native"), os.path.join(work, "native"),
                        ignore=shutil.ignore_patterns("build*", "*.so"))
        env = dict(os.environ, PYTHONPATH=here)
        t = time.perf_counter()
        walls = []
        for argv in (["build"], ["run", "--timeout", "120"]):
            res = subprocess.run([sys.executable, "-m", "dora_tpu_torch.cli", argv[0],
                                  "dataflow.yml", *argv[1:]], cwd=example, env=env,
                                 capture_output=True, text=True, timeout=240)
            walls.append(time.perf_counter() - t)
            if res.returncode != 0:
                raise Failed(f"{what}: {argv[0]} exited {res.returncode}: {res.stdout[-1500:]} "
                             f"{res.stderr[-1500:]}")
        logs = [os.path.join(root, n) for root, _d, files in os.walk(os.path.join(example, "out"))
                for n in files if n == "log_c_sink.txt"]
        with open(logs[0]) as f:
            lines = [line for line in f.read().splitlines() if line.startswith("c sink: ")]
    if lines != want:
        raise Failed(f"{what}: the sink printed {lines[-3:]} ({len(lines)} lines), expected "
                     f"{want[-3:]}")
    print(f"{what}: build {walls[0]:.1f} s, run {walls[1] - walls[0]:.1f} s; the C sink's "
          f"{len(lines)} lines equal the C node's sums ({lines[-1]}) [{smi}]", flush=True)


def operators_dataflow(torch, DB, LO, IM, L, qwen2, serve_prompts, smi: str, scratch: str,
                       here: str, layers: int, seed: int, prompts, max_new: int,
                       served=None) -> None:
    """Phase 23: operator nodes and peer-to-peer edges under the port's daemon."""
    t0 = time.perf_counter()
    recorder_dataflow(torch, smi, scratch, here)
    p2p_serving(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch, layers, seed,
                prompts, max_new, served)
    c_dataflow(smi, scratch, here)
    print(f"phase 23 in {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the PyTorch/CUDA port")
    ap.add_argument("--layers", type=int, default=28, help="model depth (width stays)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--breakdown", action="store_true",
                    help="build, then only time kernels 1, 2, 6, 7 and 11 and the attention "
                         "sublayers launch by launch and hold kernels 3-6 and 8-11 to their "
                         "references (prints no result line)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, then only phase 3's kernel checks (prints no result line)")
    ap.add_argument("--hf-vlm", action="store_true",
                    help="build, then only phase 15: the HF vision-language families "
                         "(prints no result line)")
    ap.add_argument("--operators", action="store_true",
                    help="build, then only phase 16: the operator tier's speech and VLM nodes "
                         "(prints no result line)")
    ap.add_argument("--hub", action="store_true",
                    help="build, then only phase 17: the hub models' nodes (detector, YOLOS, "
                         "translator, TTS, Opus, VITS) (prints no result line)")
    ap.add_argument("--train", action="store_true",
                    help="build, then only phase 18: training (bench_2b VLM, TTS) and the "
                         "parallel tier on a one-rank group (prints no result line)")
    ap.add_argument("--bench", action="store_true",
                    help="build, then only phase 19: the port's measurement tools, each leg "
                         "in its own process (prints no result line)")
    ap.add_argument("--dataflow", action="store_true",
                    help="build, then only phase 20: the port's VLM and serving dataflows "
                         "under the port's own daemon (prints no result line)")
    ap.add_argument("--cluster", action="store_true",
                    help="build, then only phase 20 (b) and phase 21: the serving dataflow under "
                         "the port's daemon, then the cluster tier from `up` to HTTP (prints no "
                         "result line)")
    ap.add_argument("--observe", action="store_true",
                    help="build, then only phase 20 (b) (with its traced leg), phase 21 and "
                         "phase 22: the observability planes on phase 21's cluster (prints no "
                         "result line)")
    ap.add_argument("--operators-dataflow", action="store_true",
                    help="build, then only phase 23: vlm-recorder.yml in the operator form, "
                         "the serving leg with peer-to-peer edges on and off, and "
                         "examples/c-dataflow (prints no result line)")
    ap.add_argument("--paths", action="store_true",
                    help="build, then only phases 4, 6, 9 and 10, phase 12's main path and the "
                         "VLM's generate, for their times (prints no result line)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from dora_tpu_torch.models import layers as L
        from dora_tpu_torch.models import spec_decode, vlm
        from dora_tpu_torch.models.hf import qwen2
        from dora_tpu_torch.nodehub.llm_server import make_engine, serve_prompts
        from dora_tpu_torch.ops import _build
        from dora_tpu_torch.ops import decode_block as DB
        from dora_tpu_torch.ops import flash_attention as FA
        from dora_tpu_torch.ops import int8_matmul as IM
        from dora_tpu_torch.ops import lora as LO
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 sums stay f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = _sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"{torch.cuda.device_count()} visible", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)

    try:
        t = time.perf_counter()
        libs = _build.build()
        print(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t:.2f} s "
              f"({', '.join(p.name for p in libs.values())})", flush=True)

        cfg = qwen2.Qwen2Config.qwen2_1_5b(layers=args.layers, max_seq=2048)
        t = time.perf_counter()
        params = qwen2.quantize_decode(
            qwen2.random_params(cfg, seed=args.seed, std=0.02, device="cuda"), cfg)
        torch.cuda.synchronize()
        print(f"weights: Qwen2-1.5B width, {cfg.layers} layers, seeded random "
              f"(std 0.02) int8 in {time.perf_counter() - t:.2f} s", flush=True)
        t = time.perf_counter()
        params4 = int4_params(torch, qwen2, cfg, args.seed)
        print(f"weights: the same, int4 (DORA_WEIGHT_BITS=4, groups of "
              f"{DB.weight_groups(params4)['blocks/0/wqkv']}) in {time.perf_counter() - t:.2f} s",
              flush=True)

        rng = np.random.default_rng(args.seed)
        lengths = np.linspace(64, 1000, args.requests).round().astype(int)
        prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in lengths]
        d_rng = np.random.default_rng(args.seed + 7)
        d_prompts = [d_rng.integers(0, cfg.vocab, size=n).tolist() for n in DENSE_LENGTHS]
        if args.breakdown:
            check_lora_kernel(torch, LO, cfg, args.seed + 3)
            int8_flash_breakdown(torch, IM, FA, params, args.seed + 17)
            flash_fidelity(torch, FA, args.seed + 18)
            ffn_head_breakdown(torch, DB, params, cfg, args.seed + 15)
            ffn_fidelity(torch, DB, params, cfg, prompts)
            sublayer_breakdown(torch, DB, params, cfg, args.seed + 12)
            sweep_fidelity(torch, DB, params, cfg, prompts, args.seed + 14)
            return 0
        if args.hf_vlm:
            serve_hf_vlms(torch, DB, LO, IM, L, qwen2, serve_prompts, args.seed)
            return 0
        scratch = os.path.join(here, "_scratch")
        os.makedirs(scratch, exist_ok=True)
        if args.operators:
            del params, params4
            serve_operators(torch, DB, LO, L, smi, args.seed + 40, scratch)
            return 0
        if args.hub:
            del params, params4
            serve_hub(torch, DB, LO, L, smi, args.seed + 50, scratch)
            return 0
        if args.train:
            del params, params4
            serve_train(torch, DB, LO, smi, args.seed + 60, scratch)
            return 0
        if args.bench:
            del params, params4
            serve_bench(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, here)
            return 0
        if args.dataflow:
            del params, params4
            serve_dataflows(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch,
                            args.layers, args.seed, prompts, args.max_new)
            return 0
        if args.operators_dataflow:
            del params, params4
            operators_dataflow(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch, here,
                               args.layers, args.seed, prompts, args.max_new)
            return 0
        if args.cluster or args.observe:
            del params, params4
            served = serve_dataflow(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch,
                                    args.layers, args.seed, prompts, args.max_new,
                                    trace_cost=args.observe)
            serve_cluster(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch, here,
                          args.layers, args.seed, prompts, args.max_new, served,
                          observe=args.observe)
            return 0
        if args.paths:  # phases 4, 6, 9, 10 and 12's main path and the VLM's generate alone
            _, _, slice_times = serve_slice(torch, DB, LO, qwen2, serve_prompts, params, cfg,
                                            prompts, args.max_new, args.seed + 20)
            serve_int4(torch, DB, LO, make_engine, serve_prompts, params4, cfg, prompts,
                       args.max_new, args.seed + 25, slice_times)
            serve_spec_cache(torch, DB, LO, vlm, make_engine, serve_prompts, params, cfg,
                             args.seed + 2, args.max_new)
            d_served, _, _ = serve_dense(torch, DB, LO, IM, make_engine, serve_prompts, params,
                                         cfg, d_prompts, args.max_new, args.seed + 22)
            batch1(torch, DB, LO, qwen2, spec_decode, L,
                   _Paths(torch, DB, LO, IM, qwen2, L, serve_prompts, params, cfg), params,
                   cfg, d_prompts, args.max_new, d_served)
            del params
            vlm_step_times(torch, vlm, args.seed + 10, args.max_new)
            return 0
        kernels = check_kernels(torch, DB, qwen2, params, cfg, args.seed + 1)
        kernels.insert(2, check_lora_kernel(torch, LO, cfg, args.seed + 3))
        kernels += check_dense_kernels(torch, DB, IM, params, cfg, args.seed + 6)
        kernels.append(check_flash_kernel(torch, FA, args.seed + 8))
        kernels += check_int4_kernels(torch, DB, params4, params, cfg, args.seed + 23)
        check_mma_tile(torch, DB, args.seed + 13)
        check_tc_tile(torch, DB, args.seed + 16)
        check_tc_tile4(torch, DB, args.seed + 24)
        check_widened_kernels(torch, DB, LO, qwen2, args.seed + 9)
        int8_flash_breakdown(torch, IM, FA, params, args.seed + 17)
        flash_fidelity(torch, FA, args.seed + 18)
        ffn_head_breakdown(torch, DB, params, cfg, args.seed + 15)
        ffn_fidelity(torch, DB, params, cfg, prompts)
        sublayer_breakdown(torch, DB, params, cfg, args.seed + 12)
        sweep_fidelity(torch, DB, params, cfg, prompts, args.seed + 14)
        if args.kernels_only:
            return 0
        by_name = {k["name"]: k for k in kernels}

        served, launches, slice_times = serve_slice(torch, DB, LO, qwen2, serve_prompts,
                                                    params, cfg, prompts, args.max_new,
                                                    args.seed + 20)
        for n in SPEC_OFF_KERNELS:
            by_name[n]["launches"] = launches[n]

        paths = _Paths(torch, DB, LO, IM, qwen2, L, serve_prompts, params, cfg)
        check_plain_agreement(paths, prompts, args.max_new, served, picks=(0, 1))

        spec_prompts, spec_served, spec_launches = serve_spec_cache(
            torch, DB, LO, vlm, make_engine, serve_prompts, params, cfg, args.seed + 2,
            args.max_new)
        by_name["attention_paged_spec_step"]["launches"] = spec_launches[
            "attention_paged_spec_step"]
        check_spec_agreement(paths, spec_prompts, args.max_new, spec_served, picks=(1, 15))

        with tempfile.TemporaryDirectory(prefix="adapters-", dir=scratch) as lora_dir:
            write_adapters(cfg, lora_dir, args.seed + 4)
            build, t_prompts, t_served, t_launches = serve_multi_tenant(
                torch, DB, LO, make_engine, serve_prompts, params, cfg, lora_dir,
                args.seed + 5, args.max_new)
            for n in ("lora_gather_matmul", "attention_paged_batch_step_int8kv",
                      "attention_paged_chunk_step_int8kv"):
                by_name[n]["launches"] = t_launches[n]
            check_tenant_agreement(
                paths, build,
                lambda: front_door(make_engine, params, cfg, DORA_KV_INT8="1"),
                serve_prompts, t_prompts, args.max_new, t_served)
            ts_launches = serve_tenant_spec(torch, DB, LO, build, serve_prompts, t_prompts,
                                            TENANT_SPEC_MAX_NEW, cfg.vocab)
            by_name["attention_paged_spec_step_int8kv"]["launches"] = ts_launches[
                "attention_paged_spec_step_int8kv"]

        d_served, d_launches, dense_times = serve_dense(torch, DB, LO, IM, make_engine,
                                                        serve_prompts, params, cfg, d_prompts,
                                                        args.max_new, args.seed + 22)
        for n in ("int8_matmul", "attention_batch_step"):
            by_name[n]["launches"] = d_launches[n]
        g_launches, s_launches = batch1(torch, DB, LO, qwen2, spec_decode, L, paths, params,
                                        cfg, d_prompts, args.max_new, d_served)
        by_name["attention_step"]["launches"] = g_launches["attention_step"]
        by_name["attention_chunk_step"]["launches"] = s_launches["attention_chunk_step"]

        vcfg = vlm.VLMConfig.bench_2b()
        t = time.perf_counter()
        vparams = vlm.init_params(vcfg, seed=args.seed + 10, device="cuda")
        n_params = vlm.param_count(vparams)
        vparams = vlm.quantize_decode(vparams)
        torch.cuda.synchronize()
        print(f"vlm weights: bench_2b ({n_params / 1e9:.3f} B parameters: ViT "
              f"{vcfg.vision_layers} x {vcfg.vision_dim}, LM {vcfg.layers} x {vcfg.dim}), seeded "
              f"random, LM blocks and head int8 in {time.perf_counter() - t:.2f} s", flush=True)
        vpaths = _Paths(torch, DB, LO, IM, qwen2, L, serve_prompts, vparams, vcfg)
        v_launches = serve_vlm(torch, DB, LO, vlm, vpaths, vparams, vcfg, args.seed + 11,
                               args.max_new)
        by_name["flash_attention"]["launches"] = v_launches["flash_attention"]
        del vparams, vpaths

        i_served, i_launches = serve_int4(torch, DB, LO, make_engine, serve_prompts, params4,
                                          cfg, prompts, args.max_new, args.seed + 25,
                                          slice_times)
        for n in INT4_MAIN_KERNELS:
            by_name[n]["launches"] = i_launches[n]
        paths4 = _Paths(torch, DB, LO, IM, qwen2, L, serve_prompts, params4, cfg)
        # The served token is held to NEAR_TIE; the bf16 plain stream's to
        # SPEC_REF_TIE, as phases 7, 8c and 10 hold a reference path's: its
        # decode steps round in their own order (seen 0.051 below the f32 top
        # where the served token was the top, the plain path's own prefill
        # of the same prefix picking the served token).
        check_plain_agreement(paths4, prompts, args.max_new, i_served, picks=(0, 1),
                              b_bound=SPEC_REF_TIE)
        o_launches = serve_int4_others(torch, DB, LO, qwen2, spec_decode, L, make_engine,
                                       serve_prompts, paths4, params4, cfg, prompts, d_prompts,
                                       args.seed + 26, dense_times)
        for n in ("attention_paged_spec_step_int4", "attention_batch_step_int4",
                  "attention_step_int4", "attention_chunk_step_int4"):
            by_name[n]["launches"] = o_launches[n]
        del paths4, params4
        n_launches, n_engine, rate_13a = serve_node(
            torch, DB, LO, make_engine, serve_prompts, paths, params, cfg, prompts,
            args.max_new, served, args.seed + 27)
        for n in SPEC_OFF_KERNELS:  # the main path: serve() on make_engine's engine
            by_name[n]["launches"] = n_launches[n]
        serve_recovery(torch, DB, LO, make_engine, paths, params, cfg, prompts, args.max_new,
                       served, n_engine, rate_13a, smi, os.path.join(here, "_scratch"))
        serve_hf_vlms(torch, DB, LO, IM, L, qwen2, serve_prompts, args.seed)
        del paths, params
        serve_operators(torch, DB, LO, L, smi, args.seed + 40, scratch)
        serve_hub(torch, DB, LO, L, smi, args.seed + 50, scratch)
        by_name["flash_attention"]["launches"] += serve_train(torch, DB, LO, smi,
                                                              args.seed + 60, scratch)
        serve_bench(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, here)
        serve_dataflows(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch, args.layers,
                        args.seed, prompts, args.max_new, served)
        observed = serve_cluster(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch,
                                 here, args.layers, args.seed, prompts, args.max_new, served,
                                 observe=True)
        for n in SPEC_OFF_KERNELS:  # the node that phase 22 observes, in its own process
            by_name[n]["observed_launches"] = observed[n]
        operators_dataflow(torch, DB, LO, IM, L, qwen2, serve_prompts, smi, scratch, here,
                           args.layers, args.seed, prompts, args.max_new, served)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
