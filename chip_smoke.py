"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``vietnamese_qa_system_tpu_torch/
csrc`` (one nvcc per source, all at once), holds each kernel against its
plain PyTorch version at the shapes of its serving path, times it beside
its bound and a PyTorch library call (the cluster scans also with their
scan and merge apart), prints the registers, shared memory and blocks per
SM of every flash variant, of every form of the K1 / K2 / K3 cluster scan
and of K6 (ptxas must report no spills), holds K1 on exact ties across its
tiles, warpgroups and clusters at every batch, form and route
(TOPK_BATCHES x TIE_KS), K2 on repeated rows (INT8_BATCHES x INT8_KS) and
K3 at TOPK_BATCHES x INT8_KS on random, repeated and tie-heavy low-range
codes, runs the tile scans through their route (SCAN_D), holds K1, K2 and
K3 at the edges of the cluster forms (TOPK_EDGES), checks that a K6 call
is one kernel launch, holds K9 (decode attention over the bf16 cache)
against its plain version at DECODE_ATTN_CASES, holds the flash forward
and backward against their plain versions at the edges of their tiles
(FLASH_EDGES), then drives its serving paths once:

- retrieval, at the full width of the ``mpnet_class`` encoder (random
  weights from a seed, written as an HF MPNet directory by this script's
  own name map and safetensors writer, and loaded back through the CLI's
  ``--encoder DIR`` path: tensors and embeddings bit-equal): four 1M-row
  vector stores, ingest of 2,048 synthetic Vietnamese passages at max_len
  512 (the flash kernel) with a BM25 index, an HTTP server answering
  /search and /ingest, and top-k on the three int8 stores and a rerank of
  256 on the bf16 store (K1's pool form) held against the plain path;
- hybrid BM25 + dense retrieval over the bf16 and the int8_res store:
  12 concurrent HTTP /search at k 10 and weight 0.5, their dense
  candidates (K1 at m 40; K2 at 160, then the residual rerank) held
  against the plain versions on the same query vectors, and their fused
  results against a host recomputation (``fuse_scores`` over the plain
  candidates and the Python scorer's BM25), the native scorer (``csrc/bm25.cpp``, g++) shown
  to answer them, /ingest then a keyword-only query, the shutdown save of
  bm25.json, /search p50 / p99 hybrid against dense-only, and BM25 ms per
  query, native against Python, at 100,000 passages;
- question answering, at the full width of ``phogpt_4b_class`` (32 layers,
  d 3072): drawn bf16 weights written as a PhoGPT-4B MPT directory
  (MosaicML config.json, sharded bf16 safetensors) and loaded through
  ``serve --reader-params DIR --reader-size phogpt4b --reader-quantize
  int8c`` (int8c codes and scales bit-equal to the script's own
  quantization of the same values, the process's peak RSS below the f32
  model's bytes); ``QAPipeline`` behind HTTP ``/qa`` answering concurrent
  questions over the retrieval path's 1M-row bf16 store, every
  decode-step dense layer through the w8 GEMM kernel, answers and greedy
  tokens equal to the reference reader's; a torch.profiler trace of the
  decode loop says where a step's time goes; then a two-layer twin of the
  same weights decodes greedily on the card and on the host (plain path),
  held to agree by logits and by the top-2 margin rule;
- raw completions over the same reader: the continuous-batching engine
  that ``serve --continuous-slots 8 --gen-total 1024 --gen-chunk-steps 16
  --prefix-cache-mb 512`` builds, behind HTTP ``/generate``: 23
  concurrent requests (slots freed and reused, one run to the cache end,
  a prefix-cache hit) and one over the largest bucket (400), every greedy
  stream held to a B=1 ``generate()`` by the margin rule, again with
  sampled co-riders; tokens/s, time to first token, inter-token latency,
  occupancy and accepted drafts; a traced speculative and plain chunk,
  and the speculative chunk again with its M 72 projections on the
  dequantize route; an int8 KV engine against
  ``generate(kv_dtype="int8")`` with its peak memory under twice its int8
  cache; chunked prefill in 128-token pieces.  K6 runs every decode
  projection (M 8 plain, 72 speculative) and every prefill at a bucket up
  to 256 rows (M 32-256); each (M, K, N) of the burst must be one that
  phase_w8 held against the plain version;
- the reader's other decode strategies over the same reader and the QA
  questions: /qa as ``serve`` builds it by default (``--speculative
  ngram``: prompt-lookup drafts verified 9 tokens a row at a time, K6 at
  M 72, and M 9 for one question alone), draft-model speculation with
  serve's ``--speculative draft --reader-draft-size gpt125m`` draft, and
  W 4 beams (K6 at M 32), each held to plain greedy decode by the margin
  rule (beams: W 1 against greedy, W 4 against the whole-cache reorder
  of the JAX package and greedy's log-probability over the batch);
  passes, accepted drafts, tokens/s, the beam step and its reorder's
  share, traced verify passes (one synchronisation each) and beam steps
  (none); then sampled speculation of both drafters against the
  enumerated marginals of a 1-layer V 13 model;
- IVF retrieval at the repo's IVF configuration: a clustered 1,048,576 x
  768 corpus drawn on the card (2,048 unit-norm centres, noise of total
  norm 0.35, rows normalised; the retrieval path's 2,048 passage
  embeddings among them), flat bf16 and int8_res stores (the int8 codes
  through the K8 quantizer), ``IVFIndex.build`` at the defaults (4,096
  clusters, cap 512), top-10 at nprobe 8 against the exact f32 oracle,
  exact mode against the flat scan (K1), the int8_res rerank, spill adds,
  HTTP /search over the index ``select_serving_index`` picks at batch 8
  (the probe-score kernel K5), and the IVF-vs-flat latency sweep that
  sets ``IVF_KAPPA``;
- sharded serving over a mesh of the one card repeated: BASELINE config
  4's 10M x 768 corpus (clustered rows drawn on the card in 1M-row
  blocks) in bf16, int8 and int8_res stores of 4 shards (``ingest
  --shards 4``'s layout; K8 codes), B 256 top-10 with recall by the
  rank-count rule against chunked f32 products (bf16 1.000), K1 / K2 once
  a shard a call, the ms a call beside a one-shard store of the same rows
  (built after the sharded one is freed) and the merged scores equal to
  it; an IVF index over the 4-shard int8_res store (K5 once a shard a
  call, recall); then the tensor-parallel reader of ``serve
  --reader-strategy tp`` at PhoGPT-4B width (8 of its 32 layers, drawn
  bf16 weights, 6 heads a device over a ``{"model": 4}`` mesh): /qa at B 8 and a /generate
  burst through the continuous engine, each held to the unsharded
  reader by the margin rule, the engine's prefills through K4 on every
  device, and decode ms a step beside the unsharded reader's;
- training at the full width of ``phogpt_4b_class`` (32 layers, int8 base
  drawn on the card from a seed, LoRA r 8, proj_bf16 remat, adamw):
  the causal flash forward (K4 with the ALiBi key-only bias) and its
  backward (K7) held against their plain versions at the training shapes
  (and the sliding-window form at a GPT-Neo-like local layer's), three
  ``Trainer.fit`` steps of global batch 8 at T = 1024 through K4 and K7 in
  every layer, a profiler trace of one step, ``cli train`` in-process over
  the repo's sample file, and a two-layer twin trained on the card and on
  the host (plain versions) and resumed from a checkpoint, and the twin's
  ``cli train --do-eval --do-generative-eval --num-beams 2`` (predictions
  file and gen_tokens_per_s);
- the offline path at PhoGPT-4B width (4 of its 32 layers): ``cli parse
  --parser alpaca`` over the repo's sample, ``cli train`` over the parsed
  file (int8 + LoRA, two steps, K4 / K7, a checkpoint, ``--push-to-hub
  --push-dry-run``: the manifest lists the npz export), ``cli
  convert-ckpt --format hf`` (an f32 MPT directory; seconds, bytes and
  peak resident set), its tensors bit-equal to the merged model's
  dequantized weights, and the directory loaded as int8c giving the merged
  model's greedy tokens (K6);
- model-backed translation (``etl.translate_texts``): the mt5-small
  int8c reader with flash over 64 drawn texts on four threads, every
  chunk failed once and resubmitted, the strings equal to a one-thread
  pass (K4, K6); mbart-large-50's width with W 4 beams and a forced
  language id, equal to ``generate_with_config``'s decoded rows;
- multi-LoRA ``/generate`` over the int8c reader, after the /generate
  phase: three r 8 adapters written as ``adapter.npz`` and served through
  ``serve --continuous-slots 8 --adapter a=... --adapter b=... --adapter
  c=...``, 24 concurrent requests (six each for the base and each adapter,
  one sampled), every greedy stream held to a B=1 ``generate()`` under its
  adapter by the margin rule, two adapters on one prompt (different
  streams, no shared prefix-cache entry), an unknown adapter 400,
  ``/healthz``, and a speculative chunk with the bank traced beside the
  same chunk without it (no host synchronisation; K6 under the bank);
- nf4 and nf4-dq readers of the QA phase's drawn bf16 weights (``serve
  --reader-params DIR --reader-quantize nf4|nf4-dq``): codes equal to
  quantizing the same values, 8 concurrent ``/qa`` (K1; no K6), prefill
  and decode rates, the weights' bytes beside int8c and bf16, the first
  decode step's logits against the float reader's, a traced decode step
  and the dequantization's share of it;
- QLoRA over an nf4-dq base at PhoGPT-4B width (8 of its 32 layers;
  global batch 8 x 1,024): two steps with each dequant placement (fused, once, once_folded; K4 and
  K7) from the same base and initial adapter, their first losses held
  together, the fused run again with ``host_offload="all"`` (the same
  losses), step s, device busy ms and peak memory per placement; then the
  2-layer twin's ``cli train --profile-steps 1 --sharded-checkpoint`` (a
  trace with CUDA kernel events, ``host_0`` files) resumed from its
  checkpoint;
- the seq2seq readers: mt5-small at full width (drawn bf16 weights
  written as an HF MT5 directory by this script's own name map, loaded
  through ``serve --reader-params DIR --reader-size mt5small
  --reader-quantize int8c`` bit-equal to the script's quantization), 8
  concurrent ``/qa`` at 512-token prompts over the 1M-row bf16 store (K1;
  K6 in every decoder projection), the same reader with
  ``use_flash_attention`` (K4 bidirectional with the full relative
  bias), a 2-layer twin on the card and the host; ``/generate`` as
  ``serve --continuous-slots 8 --gen-total 256`` builds it (16 requests,
  every fourth sampled, one over the largest encoder bucket; each greedy
  stream held to a B=1 ``generate_seq2seq`` by the margin rule; a traced
  chunk with no host synchronisation); mbart-large-50's width through
  ``chat --arch seq2seq --init-params DIR`` (greedy and W 4 beams with a
  forced language id, the beams' summed log-probability at least
  greedy's, a 2-layer twin); K4 / K7 at mt5-small's training shapes (full
  bias, scale 1, both forms) against their plain versions and SDPA; three
  mt5-small LoRA steps over an int8 base with flash at batch 8 x (512 +
  256), one traced, and the 2-layer twin's ``cli train --arch seq2seq
  --do-eval --do-generative-eval`` on the card and the host;
- training over a mesh of the one card repeated four times (``["cuda:0"]
  * 4``) at PhoGPT-4B width (int8 base, LoRA r 8, proj_bf16, 8 x 1,024,
  grad_accum 2): two steps under each of dp, zero2 and fsdp on ``{"data":
  4}``, tp on ``{"model": 4}`` (6 heads a part) and fsdp_tp on ``{"data":
  2, "model": 2}``, each held to a one-device trainer on the same weights,
  adapter and batches (K4 / K7 on every part), with the bytes a position
  holds; ``perplexity_eval(mesh=)`` over the fsdp_tp rows; one ``cli train
  --strategy fsdp_tp --mesh`` step.

The B=1 ``generate()`` references of the ``/generate`` phases replay their
decode step from a CUDA graph (``graph_greedy_reference``; the first two
of each path also run eagerly and must give the same tokens).  Each
phase's seconds are printed as it ends.

Each path resets the kernels' launch counters just before it runs and
reads them just after; every kernel of the path must have launched.

Output: the GPU's name and power limit, one line per check, a JSON line
with each kernel's launches, error, times and bound, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero; it also exits non-zero, printing no result, when no GPU is
visible.  Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import glob
import itertools
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SEED = 0
B, D, N, K, K_RERANK = 256, 768, 1 << 20, 10, 40
# K4's encoder shape: the ingest's batch of 256 passages at max_len 512,
# mpnet_class's 12 heads of 64
FLASH_B, FLASH_H, FLASH_T, FLASH_D = 256, 12, 512, 64
N_PASSAGES = 2048
FLASH_O_TOL = 2e-2   # bf16 output: a few ulps at |o| < 2
FLASH_LSE_TOL = 1e-2  # f32 log-sum-exp after bf16 probabilities
# K4 / K7 at the edges of their tiles (flash_variants prints each variant's
# BQ and BK): T off the tiles, every head dim, causal rows with kv_len 0, 1
# and T, a window edge inside a tile, the bidirectional kv_len skip over
# mixed lengths, both bias forms at every head dim (the causal full-bias
# forms too), T not a multiple of 4 (the padded rows of the bias, lse and
# dd); (D, T, causal, window, bias, lens)
FLASH_EDGES = (
    (32, 200, True, None, None, "edge"),
    (64, 1000, True, 100, None, "edge"),
    (128, 200, True, None, "key", "edge"),
    (128, 1000, True, 37, "key", "mixed"),
    (32, 1000, False, None, "full", "mixed"),
    (64, 200, False, None, "key", "mixed"),
    (64, 1000, False, None, None, "mixed"),
    (128, 1000, False, None, "full", "edge"),
    (32, 201, True, None, "full", "edge"),
    (64, 203, True, 37, "full", "mixed"),
    (128, 201, True, None, "full", "mixed"),
    (64, 510, False, None, "full", "edge"),
    (128, 1001, True, None, "key", "mixed"),
    (32, 203, False, None, "key", "edge"),
)
ENCODER_COS_TOL = 0.9999
RERANK_SCORE_TOL = 1e-5  # f32 re-score sums in another order on the host
# K6 at the PhoGPT-4B decode shapes: M = the bucketed batch, (K, N) of
# wq/wk/wv/wo, the MLP up and the MLP down projections
# M 72: the continuous engine's speculative chunk, 8 slots x (8 drafts + 1)
W8_ROWS = (1, 8, 16, 72)
W8_SHAPES = ((3072, 3072), (3072, 12288), (12288, 3072))
W8_PER_LAYER = {(3072, 3072): 4, (3072, 12288): 1, (12288, 3072): 1}
W8_REL_TOL = 1e-4  # max abs err / max |plain|: the same exact products summed in another order
# the engine's B=1 prefills at buckets 32-256 (and its prefix-extension and
# chunked-prefill pieces) take K6 at these rows, and so do the verify window
# of one /qa question (9 = 1 x (8 drafts + 1)), of a /qa bucket of 4 (36) and
# W 4 beams at the /qa batch of 8 (32): checked and timed at every shape
W8_CHECK_ROWS = (9, 32, 36, 64, 128, 256)
W8_LAYER_ROWS = (8, 72, 128, 256)  # a layer's six calls summed: /qa decode, the speculative chunk, prefills
# K6 off the main shapes: a unit's second weight box past N (N % 256 == 128
# at <= 72 rows), a lone row, rows off every bucket, one unit of K
W8_EDGES = ((1, 128, 384), (37, 384, 640), (72, 128, 128), (100, 256, 384), (200, 384, 1152), (256, 128, 128))
# K9 (decode attention over the bf16 cache): (label, B, H, kvH, D, Tq, bias, a free row); the cell's shape is
# PhoGPT-4B's decode step at 32 slots of a 1,024-column cache (1,025 with the guard column), ALiBi, with
# valid lengths drawn in DECODE_LENS and a padding hole in each row; Tq 9 is a speculative verify window
DECODE_ATTN_CASES = (
    ("decode", 32, 24, 24, 128, 1, "alibi", False),
    ("spec", 32, 24, 24, 128, 9, "alibi", False),
    ("qa_b1", 1, 24, 24, 128, 1, "alibi", False),
    ("gqa", 8, 32, 8, 128, 1, None, True),
    ("gqa_spec", 8, 32, 8, 128, 9, None, False),
    ("t5_bias", 8, 6, 6, 64, 1, "rows", True),
    ("gqa_d64_spec", 4, 8, 2, 64, 9, "alibi", False),
)
DECODE_TOTAL = 1024
DECODE_LENS = (192, 896)
# K9 against its plain version: each probability is rounded to bf16 against the plain version's denominator
# or, split over blocks, its block's; the two roundings (2^-9 each) move the output by at most 2^-8 of max |v|,
# and the f32 sums in another order by far less
DECODE_ATTN_REL_TOL = 2.0 ** -8
# K6 at mt5-small's projections (K, N): q / k / v (512, 384), the attention
# out (384, 512), the gated MLP's gate and up (512, 1024) and its down
# (1024, 512); N 384 is three 128-column tiles and K 384 three k-steps,
# few units for the stream-K partition.  A decoder layer's calls a step:
# self q k v o, cross q o, gate, up, down (the cross K / V are projected
# once a sequence)
MT5_W8_SHAPES = ((512, 384), (384, 512), (512, 1024), (1024, 512))
MT5_PER_DECODER_LAYER = {(512, 384): 4, (384, 512): 2, (512, 1024): 2, (1024, 512): 1}
K1_SCORE_TOL = 2e-3  # wgmma sums the exact bf16 products in another order than the f32 product
TOPK_BATCHES = (1, 8, 32, 200, 256, 512)  # 1-, 2- and 4-CTA clusters, and two groups of 256
# K1's list form at 10 and at hybrid's 40 dense candidates, and its pool
# form past it; K2 / K3's list form at 10 and 40, pool form at 160 (the
# int8_res rerank's candidates under hybrid's 40) and 256
TIE_KS = (K, K_RERANK, 61, 100, 256)
INT8_BATCHES, INT8_KS = (1, 8, 256, 512), (K, K_RERANK, 4 * K_RERANK, 256)
SCAN_D = 720  # a width off the cluster scan's 64-column panels: the tile scans' route
# K1 / K2 at the edges of the cluster scan's forms: one bf16 panel and a
# half-empty int8 one (D 64), an int8 panel and a half (D 192), the widest
# int8 (D 1024); corpora of a few tiles (fewer clusters than the card
# holds, too few published maxima for a floor) and valid_n = 256 = k;
# batches of 3 and 300 (two groups of 256); (D, N, valid_n)
TOPK_EDGES = ((64, 200_000, 199_923), (192, 3_000, 256), (1024, 300, 256))
RERANK_BATCH = 32  # the Retriever's query batch on the HTTP /search path
READER_QUESTIONS, READER_PROMPT_LEN, READER_NEW_TOKENS = 8, 512, 32
# 4 rows x (48 + 15) tokens = 252 rows: the teacher-forced check takes K6 too
TWIN_LAYERS, TWIN_ROWS, TWIN_PROMPT_LEN, TWIN_NEW_TOKENS = 2, 4, 48, 16
TRACE_STEPS = 8  # decode steps in the profiler trace of the QA path
# /generate as `serve --continuous-slots 8 --gen-total 1024 --gen-chunk-steps 16
# --prefix-cache-mb 512` builds it (default buckets 32-512, --gen-speculative
# ngram): 20 drawn requests, the 256-token prefix two requests share (its
# extension sent once it is answered), one prompt of 500 tokens budgeted
# past the cache end, one over the largest bucket (400)
ENGINE_FLAGS = ("--continuous-slots", "8", "--gen-total", "1024", "--gen-chunk-steps", "16", "--prefix-cache-mb", "512")
ENGINE_DRAWN, ENGINE_PROMPT, ENGINE_NEW = 20, (16, 500), (16, 96)
ENGINE_SHARED, ENGINE_LONG, ENGINE_OVER = 256, 500, 600
ENGINE_SAMPLED = {"temperature": 0.8, "top_k": 40, "top_p": 0.9}  # every third request of the second burst
ENGINE_INT8_REQUESTS, ENGINE_PREFILL_CHUNK, ENGINE_SIDE_NEW = 4, 128, 32
TWIN_LOGIT_TOL = 5e-2  # |logits| ~ 1-5; bf16-rounded inputs flip where card and host differ by an ulp
# the reader's other decode strategies over the QA phase's batch: W 4 beams
# (and W 1 against greedy), a draft model of this preset widened to the
# reader's vocabulary
BEAM_WIDTH, DRAFT_PRESET = 4, "gpt125m"
# sampled speculation against the enumerated marginals of a 1-layer V 13
# model (tests/test_speculative.py:192, :387); TV noise at N 4,096 is ~0.03
SAMPLED_V, SAMPLED_ROWS, SAMPLED_TV_TOL = 13, 4096, 0.08
# the IVF path: clustered corpus (probe_ivf.py's 2,048 centres and sigma),
# the repo's IVF configuration, the probe-score batches, the latency sweep
IVF_CENTRES, IVF_SIGMA, IVF_QUERIES, IVF_NPROBE = 2048, 0.35, 32, 8
PROBE_BATCHES = (1, 8, 32, 256)
SWEEP_TO, SWEEP_MAX, SWEEP_REPS = 256, 4096, 9  # batches 1, 2, 4 .. 256, on to 4096 while IVF still wins
PROBE_REL_TOL = 1e-5  # max abs err / max |s|: exact products, f32 sums in another order
IVF_RECALL_FLOOR = 0.9
# the sharded serving phase: BASELINE config 4's corpus (10M x 768) over a
# {"shard": 4} mesh of the one card repeated, filled in 1M-row blocks; the
# int8 dtypes' recall floors against the f32 corpus (bf16 must be 1.000
# against its stored rows); S = 4 scores against S = 1's (the same products
# a row; the int8_res re-score sums in another batch layout)
SHARDS, SHARDED_N, SHARDED_BLOCK, SHARDED_ITERS = 4, 10_000_000, 1 << 20, 5
SHARDED_DTYPES = ("bf16", "int8", "int8_res")
SHARDED_INT8_FLOOR, SHARDED_RES_FLOOR, SHARDED_SCORE_TOL = 0.8, 0.95, 1e-5
# the TP reader: PhoGPT-4B over {"model": 4} (6 heads a device); /qa at B 8
# (128-character questions, 32 new tokens); a /generate burst of 8 requests
# of 16-200 tokens through the engine `serve --continuous-slots 8 --gen-total
# 512 --gen-chunk-steps 16` builds
TP_DEVICES, TP_QA_ROWS, TP_PROMPT, TP_NEW = 4, 8, 128, 32
TP_LAYERS = 8  # of PhoGPT-4B's 32, at full width: the depth cut that pays for the offline ETL phases
TP_ENGINE_FLAGS = ("--continuous-slots", "8", "--gen-total", "512", "--gen-chunk-steps", "16")
TP_ENGINE_REQUESTS, TP_ENGINE_PROMPT, TP_ENGINE_NEW = 8, (16, 200), 24
# the TP seq2seq readers (phase_tp_seq2seq): mt5-small's bf16 weights (the
# directory phase_seq2seq_qa writes) with the flash route, over {"model": 2}
# (3 heads a device: K4 a part) and {"model": 4} (6 heads do not split over
# 4: attention whole on the lead); /qa at B 8 of 512-token prompts (a
# 240-token question is its own context), 32 new tokens; 16 greedy /generate
# of 16-128 encoder tokens and 16-64 new through serve's seq2seq engine;
# mBART at mbart-large-50's width over {"model": 4}
TP_S2S_MESHES, TP_S2S_QUESTION, TP_S2S_REQUESTS, TP_S2S_NEW, MBART_TP_DEVICES = (2, 4), 240, 16, (16, 64), 4
# the bank on the TP reader (phase_tp_adapters): 8 concurrent /generate, two
# a name over the base and ADAPTER_NAMES, 16-200 prompt tokens, 16-64 new
TP_ADAPTER_NEW = (16, 64)
# the TP reader's logits under an adapter against the unsharded reader's, as
# a share of that adapter's own change of the logits: a wrongly sliced
# factor errs by the order of the change itself; the split's rounding drift
# (its row-parallel sums' order, through bf16 activations) grows with depth
ADAPTER_TP_REL_TOL = 0.1
# the training path: PhoGPT-4B QLoRA steps of global batch 8 (grad_accum 2)
# at T = 1024; K7 against its plain version relative to each gradient's
# max |g| (bf16 P and dS summed in another tile order); the 2-layer twin's
# card-vs-host agreement (loss relative; gradients relative to each
# leaf's max: the kernels' bf16 P and dS against the plain version's)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_T = 3, 8, 1024
FLASH_GRAD_REL_TOL = 2e-2
TWIN_T, TWIN_LOSS_TOL, TWIN_GRAD_REL_TOL = 128, 1e-3, 5e-2
TWIN_EVAL_EXAMPLES = 8  # the twin's cli train decodes this many eval prompts with W 2 beams
# training over a mesh of the one card repeated: each strategy on the
# axes of JAX tests/test_trainer.py::test_sharded_train_step at four
# positions; the step-1 loss and every grad_norm against the one-device
# trainer's (the rows' products and sums run in another order)
# (PhoGPT-4B at 8 of its 32 layers, full width); an nf4-dq QLoRA step under
# fsdp_tp, and host_offload="all" under MESH_OFFLOAD against the same
# strategy without it (the same operations: QLORA_OFFLOAD_RTOL)
MESH_DEVICES, MESH_STEPS, MESH_EVAL_BATCHES, MESH_LAYERS = 4, 2, 1, 8
MESH_STRATEGIES = (("dp", {"data": 4}), ("zero2", {"data": 4}), ("fsdp", {"data": 4}), ("tp", {"model": 4}),
                   ("fsdp_tp", {"data": 2, "model": 2}))
MESH_OFFLOAD = ("fsdp", "tp")
MESH_LOSS_RTOL, MESH_GRAD_RTOL = 1e-3, 5e-2
# seq2seq training over a model axis: mt5-small at full width and depth
# (the seq2seq train phase's batch, grad_accum 2) under each of these, an
# mBART-large-50-width bf16 LoRA step under tp {"model": 2}, and K4 / K7 at
# a TP part's shapes (mt5's 6 heads split 3 + 3: 4 rows a microbatch x 3
# heads; name, B, H, first head, T, D, causal)
MESH_S2S_STRATEGIES = (("tp", {"model": 2}), ("tp", {"model": 4}), ("fsdp_tp", {"data": 2, "model": 2}))
MESH_S2S_ACCUM = 2
T5_TP_FLASH = (("mt5 TP part encoder", 4, 3, 3, 512, 64, False), ("mt5 TP part decoder", 4, 3, 3, 256, 64, True))
MESH_B0_STD = 1e-3  # the adapters' B at the start of the mesh phase: small noise, so that A trains from step 1
# multi-LoRA /generate: three r 8 / alpha 16 adapters over the default
# targets (serve's --adapter-r / --adapter-alpha defaults) with B drawn
# N(0, ADAPTER_B_STD^2) (init_lora's B = 0 would equal the base); six
# requests each for the base and the three adapters, 16-500 prompt tokens,
# 16-48 new ones
ADAPTER_NAMES, ADAPTER_B_STD, ADAPTER_PER, ADAPTER_NEW = ("a", "b", "c"), 0.05, 6, (16, 48)
ADAPTER_SHARED = 300  # the prompt adapters a and b both get; a's extension of it hits a's entry alone
ADAPTER_CACHE_MB = 8192  # above the burst's 24 prompt KVs (<= 201 MB each at bucket 512)
# nf4 readers of the QA phase's drawn bf16 weights: the first decode
# step's logits against the float reader's, relative to its max |logit|
# (tests/test_quantize_base.py:250-268 bounds nf4 by 0.35)
NF4_MODES, NF4_LOGIT_REL_TOL = ("nf4", "nf4-dq"), 0.35
# QLoRA over an nf4-dq base at PhoGPT-4B width (the train phase's batch):
# each dequant placement's first loss against fused's (same data, same
# initial adapter, whose B = 0: the same forward), and host_offload="all"
# against the device run (the same operations)
QLORA_STEPS, QLORA_LOSS_RTOL, QLORA_OFFLOAD_RTOL = 2, 1e-4, 1e-5
QLORA_LAYERS = 8  # of PhoGPT-4B's 32, at full width: the depth cut that pays for the seq2seq mesh and ETL phases
# hybrid retrieval: 12 concurrent /search at k 10 and weight 0.5 over the
# ingested passages; served scores are rounded to 6 decimals (HYBRID_TOL);
# the BM25 timing index; /search latency rounds for p50 / p99
HYBRID_K, HYBRID_WEIGHT, HYBRID_QUERIES, HYBRID_TOL = 10, 0.5, 12, 1e-6
BM25_PASSAGES, BM25_TIMED_QUERIES, LATENCY_ROUNDS = 100_000, 12, 5
# the PhoGPT-4B import: sharded bf16 safetensors of 4 layers a shard; the
# process's resident set while loading must stay below the f32 model's bytes
PHOGPT_LAYERS_PER_SHARD = 4
# H100 SXM5 data sheet (dense, 700 W): HBM 3.35 TB/s, 989 TFLOP/s bf16,
# 1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s f32 on the CUDA cores
HBM_BYTES_S, BF16_OPS_S, INT8_OPS_S, F32_OPS_S = 3.35e12, 989e12, 1979e12, 67e12
L2_BYTES = 50 << 20
# the seq2seq paths: mt5-small's /qa with flash (logits against the dense
# path within JAX test_t5.py:337's atol), its /generate engine as `serve
# --continuous-slots 8 --gen-total 256` builds it (encoder buckets 32-128:
# prompts of 16-128 tokens, and one over the largest), mBART-large-50's
# greedy and W 4 beams with vi_VN's language id (mbart-50's vocabulary)
# forced, mt5-small LoRA steps of batch 8 x (encoder 512, target 256), and
# K4 / K7 at those two shapes (name, B, H, T, D, causal)
S2S_FLASH_LOGIT_TOL = 0.1
S2S_ENGINE_FLAGS = ("--continuous-slots", "8", "--gen-total", "256", "--gen-chunk-steps", "16")
S2S_ENGINE_REQUESTS, S2S_ENGINE_PROMPT = 16, (16, 128)
MBART_ROWS, MBART_PROMPT_LEN, MBART_NEW_TOKENS, MBART_LANG_ID = 8, 64, 32, 250024
S2S_TRAIN_STEPS, S2S_TRAIN_BATCH, S2S_TRAIN_ENC, S2S_TRAIN_DEC = 3, 8, 512, 256
T5_FLASH = (("mt5 encoder", 8, 6, 0, 512, 64, False), ("mt5 decoder", 8, 6, 0, 256, 64, True))
# the offline ETL: mt5-small translation (chunks on a thread pool, every
# chunk failed once), and the parse -> train -> convert-ckpt -> reload path
# at PhoGPT-4B's width with 4 of its 32 layers (an f32 export of all 32 is
# ~15 GB: the cut is for time and host memory)
TRANSLATE_TEXTS, TRANSLATE_CHUNK, TRANSLATE_WORKERS, TRANSLATE_NEW_TOKENS = 64, 8, 4, 32
CONVERT_LAYERS, CONVERT_PROMPTS, CONVERT_PROMPT_LEN, CONVERT_NEW_TOKENS = 4, 8, 256, 16
CONVERT_REPO = "org/phogpt-4b-vi-lora"
EXPORT_W_REL_TOL = 1e-6  # f32: the file's weight is codes x scale + A @ B rounded once
EXPORT_LORA_MIN = 100  # the folded A @ B must stand this many tolerances above the weights' error bound
EXPORT_LOGIT_REL_TOL = 5e-2  # bf16 products: the trained model rounds W and its LoRA term apart, the export W + AB


SAFETENSORS_CODES = {"torch.float32": "F32", "torch.bfloat16": "BF16"}


def safetensors_header(entries: list) -> bytes:
    """The 8-byte length and JSON header of a safetensors file holding
    ``entries`` [(name, dtype, shape)] in that order (a writer of this
    script's own, independent of the port's reader)."""
    header, offset = {}, 0
    for name, dtype, shape in entries:
        n = (2 if str(dtype) == "torch.bfloat16" else 4) * math.prod(shape)
        header[name] = {"dtype": SAFETENSORS_CODES[str(dtype)], "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return len(raw).to_bytes(8, "little") + raw


def write_tensor(f, t) -> None:
    """A tensor's bytes, little-endian, row-major."""
    import torch

    f.write(memoryview(t.detach().cpu().contiguous().view(torch.uint8).numpy()))


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))


class RssPeak:
    """The largest resident set of this process while the block runs,
    sampled every 10 ms."""

    def __enter__(self):
        self.peak, self._stop = rss_bytes(), threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")
    print(f"ok: {what}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the host's per-call cost (Python, ctypes, the
    allocator) is out of the measurement, which microsecond kernels need."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def graph_nodes(fn) -> list[tuple[str, str]]:
    """The work one call of ``fn`` puts on the stream, as (node type,
    label) pairs of a CUDA graph captured around it and printed by the
    runtime (``cudaGraphDebugDotPrint``): a kernel node's label holds its
    mangled name and launch shape.  Unlike a profiler pass, the capture
    sees every launch, copy and memset of the call whatever the state of
    the activity tracer."""
    import re
    import warnings

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # debug_dump warns that it is a debugging call
        path = os.path.join(d, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    graph.reset()
    return re.findall(r'"graph_\d+_node_\d+"\[[^\n]*label="\{(\w+)\n(.*?)\}"\];', dot, re.S)


def bound(n_bytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at the peak
    rate of their type, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rank_recall(q, corpus, ids, k: int) -> float:
    """bench.py's rank-count rule: an id is a true top-k member iff fewer
    than k corpus rows score strictly higher (plain f32 scores)."""
    import torch

    scores = q.float() @ corpus.float().T
    picked = torch.gather(scores, 1, ids.long())
    ranked = torch.sort(scores, dim=1).values
    del scores
    higher = ranked.shape[1] - torch.searchsorted(ranked, picked.contiguous(), right=True)
    return (higher < k).sum().item() / higher.numel()  # counted exactly: a CUDA mean multiplies by 1 / n


def ptxas_report(file: str, function: str) -> str:
    """The -Xptxas -v lines of one kernel function of a source's build log:
    its stack frame, spill stores and loads, registers and barriers, and
    whether ptxas serialized its wgmma (info C7515 or C7518)."""
    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels

    with open(cuda_kernels._lib_path(file)[:-3] + ".log") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and function in line:
            rest = []
            for x in lines[i + 1:]:
                if "Compiling entry function" in x:
                    break
                if "bytes stack frame" in x or "Used" in x:
                    rest.append(x.split("ptxas info    :")[-1].strip())
            for code in ("C7515", "C7518"):
                if any(code in x and function in x for x in lines):
                    rest.append(f"wgmma serialized ({code})")
            return " / ".join(rest)
    raise RuntimeError(f"{file}: no ptxas report of {function}")


def tie_corpus(torch, T, corpus, valid: int, gen):
    """``corpus`` with exact ties at the edges of K1's work: rows 16 h at
    the first row of every cluster's corpus range and the row before it
    (the ranges of 1-, 2- and 4-CTA clusters), on both sides of every 54th
    tile edge (tiles alternate between the warpgroups), at valid - 1 and at
    valid (past valid_n: never a result).  h is +-2^-5, so each tied row
    scores exactly 12 against q = h in any summation order, far above every
    random row (|q . r| < 5), and the ties resolve by index alone."""
    h = (torch.randint(0, 2, (D,), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16) / 32
    tiles = -(-valid // 128)
    rows = {valid - 1, valid}
    for b in (1, 100, 256):
        _, clusters = T.cluster_plan(b, K, D, valid, torch.device("cuda"))
        for c in range(1, clusters):
            start = c * tiles // clusters * 128
            rows |= {start - 1, start}
    step = tiles // 151
    rows |= {e for j in range(1, 151) for e in (128 * j * step - 1, 128 * j * step)}
    tied = corpus.clone()
    tied[sorted(rows)] = 16 * h
    return tied, h


def cluster_times(torch, T, kernel, q, corpus, scales, n: int, k: int, route: str) -> dict:
    """A cluster-scan call's device time, and its scan and merge apart (the
    same scratch: the scan's candidates feed the merge)."""
    _, _, scratch = T._cluster_cuda(kernel, q, corpus, scales, n, k, route)
    scan = cuda_ms(lambda: T._cluster_cuda(kernel, q, corpus, scales, n, k, route, what=1, scratch=scratch), 10)
    merge = cuda_ms(lambda: T._cluster_cuda(kernel, q, corpus, scales, n, k, route, what=2, scratch=scratch), 10)
    total = cuda_ms(lambda: T._cluster_cuda(kernel, q, corpus, scales, n, k, route, scratch=scratch), 10)
    return {"ms": total, "scan_ms": scan, "merge_ms": merge}


def repeated_codes(torch, quant, gen, n: int, distinct: int):
    """An int8 corpus of n rows drawn from `distinct` rows: their codes
    with row scales (K2), and their codes under one global scale (K3).
    Integer scores tie across every copy of a row."""
    base = torch.randn(distinct, D, generator=gen, device="cuda")
    codes, scales = quant.quantize_int8_reference(base)
    gcodes, _ = quant.quantize_int8_global(base)
    pick = torch.randint(0, distinct, (n,), generator=gen, device="cuda")
    return codes[pick].contiguous(), scales[pick].contiguous(), gcodes[pick].contiguous()


def low_range_codes(torch, gen, n: int, b: int):
    """A tie-heavy K3 input: corpus codes in {-1, 0, 1}, and query codes of
    +-127 on 6, 8, 10 or 12 features (by row), 0 elsewhere.  A raw score is
    127 x an integer of at most 12, so dozens to thousands of the n rows tie
    at the k-th score."""
    codes = torch.randint(-1, 2, (n, D), generator=gen, device="cuda", dtype=torch.int8)
    keys = torch.rand(b, D, generator=gen, device="cuda")
    m = 6 + 2 * (torch.arange(b, device="cuda") % 4)
    cut = keys.sort(dim=1).values.gather(1, (m - 1)[:, None])
    signs = torch.randint(0, 2, (b, D), generator=gen, device="cuda") * 2 - 1
    return codes, ((keys <= cut) * signs * 127).to(torch.int8)


def cluster_resources(torch, T, report) -> None:
    """Registers, shared memory, ring stages and clusters at once of every
    cluster-scan form at D 768, and no ptxas spill in any of them."""
    # (kernel, element form, k, whether its report row times this form)
    for name, elem, k, timed in (("matmul_topk_bf16", "bf16", K, True), ("matmul_topk_bf16_large", "bf16", T.MAX_K, True),
                                 ("matmul_topk_int8", "int8", K, True), ("matmul_topk_int8", "int8", K_RERANK, False),
                                 ("matmul_topk_int8", "int8", T.MAX_K, False),
                                 ("matmul_topk_int8_global", "int8_global", K, True),
                                 ("matmul_topk_int8_global", "int8_global", K_RERANK, False),
                                 ("matmul_topk_int8_global", "int8_global", T.MAX_K, False)):
        info = {c: T.cluster_info(c, k, D, elem=elem) for c in (1, 2, 4)}
        for c, row in info.items():
            print(f"{name} ({row['form']} form), {c}-CTA clusters, k={k}, D={D}: {row['registers']} registers, "
                  f"{row['shared_bytes']} B shared, {row['stages']} ring stages, {row['max_clusters']} clusters at once, "
                  f"{row['local_bytes']} B local", flush=True)
        if not timed:
            continue
        report[name].update(
            registers=info[4]["registers"], shared_bytes=info[4]["shared_bytes"], stages=info[4]["stages"],
            clusters_at_once={c: r["max_clusters"] for c, r in info.items()})
    # every instantiation: element type x (pool form, lists of 4 and 16
    # entries a lane); K3 reads its sums where each score is read, so
    # nothing but the wgmma writes its accumulators
    for elem in ("4Bf16", "2S8", "5S8Raw"):
        for kq in (0, 4, 16):
            rep = ptxas_report("topk.cu", f"topk_cluster_kernelINS0_{elem}ELi{kq}E")
            print(f"cluster scan <{elem[1:]}, KQ={kq}>, ptxas: {rep}", flush=True)
            check("0 bytes spill stores, 0 bytes spill loads" in rep and (elem != "5S8Raw" or "C7515" not in rep),
                  f"cluster scan <{elem[1:]}, KQ={kq}>: no ptxas spills" + (", wgmma not serialized" if elem == "5S8Raw"
                                                                           else ""))


def phase_topk(torch, T, quant, gen, report):
    """K1 (list, pool and tile-scan routes), K2 and K3 (list and pool forms,
    and their tile scans) against their plain versions at the serving
    shape; K1 on exact ties, K2 on repeated rows and K3 on repeated rows and
    a tie-heavy low-range corpus at every batch and k."""
    corpus = torch.randn(N, D, generator=gen, device="cuda").to(torch.bfloat16)
    for b in (B, 8):
        q = torch.randn(b, D, generator=gen, device="cuda").to(torch.bfloat16)
        s, i = T.topk_bf16(q, corpus, N, K)
        s2, i2 = T.topk_bf16(q, corpus, N, K)
        ps, _ = T.topk_bf16_plain(q, corpus, N, K)
        torch.cuda.synchronize()
        rec, err = rank_recall(q, corpus, i, K), (s - ps).abs().max().item()
        print(f"K1 bf16 B={b} top-{K} ({T.bf16_route(K, D)} route): recall by rank count {rec:.3f}, scores within "
              f"{err:.2e} of the plain version", flush=True)
        check(rec == 1.0 and err <= K1_SCORE_TOL and torch.equal(i, i2) and torch.equal(s, s2),
              f"K1 bf16 B={b} N={N} k={K}: recall 1.000 by the rank-count rule, scores within {K1_SCORE_TOL} of the "
              "plain version, repeats bit for bit")
        t = cluster_times(torch, T, T.TOPK_BF16, q, corpus, None, N, K, "cluster")
        lib_ms = cuda_ms(lambda: torch.topk(q @ corpus.T, K), 5)
        bnd = bound(b * D * 2 + N * D * 2 + b * K * 8, 2 * b * N * D, BF16_OPS_S)
        print(f"K1 bf16 B={b} N={N} D={D} k={K}: kernel {t['ms']:.4f} ms (scan {t['scan_ms']:.4f}, merge "
              f"{t['merge_ms']:.4f}), library (matmul + topk) {lib_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), {bnd['bound_ms'] / t['ms']:.2f} of the bound", flush=True)
        if b == B:
            report["matmul_topk_bf16"] = {
                "max_abs_err": err, **t, "plain_ms": cuda_ms(lambda: T.topk_bf16_plain(q, corpus, N, K), 3),
                "library_ms": lib_ms, "library_call": "composite: torch.matmul (bf16 scores) then torch.topk", **bnd}
        else:
            report["matmul_topk_bf16"].update(b8_ms=t["ms"], b8_library_ms=lib_ms, b8_bound_ms=bnd["bound_ms"])
    valid = N - 12345
    q = torch.randn(B, D, generator=gen, device="cuda").to(torch.bfloat16)
    _, iv = T.topk_bf16(q, corpus, valid, K)
    torch.cuda.synchronize()
    check(int(iv.max()) < valid and rank_recall(q, corpus[:valid], iv, K) == 1.0,
          f"K1 bf16 B={B} valid_n={valid} < N: ids below valid_n, recall 1.000")

    # K1's pool form at an explicit rerank's k, at the serving path's query
    # batch; the tile scan timed at the same shape (called directly: the
    # route sends it only what no cluster form fits)
    qr = q[:RERANK_BATCH].contiguous()
    s, i = T.topk_bf16(qr, corpus, N, T.MAX_K)
    s2, i2 = T.topk_bf16(qr, corpus, N, T.MAX_K)
    ps, pi = T.topk_bf16_plain(qr, corpus, N, T.MAX_K)
    torch.cuda.synchronize()
    err = (s - ps).abs().max().item()
    check(T.bf16_route(T.MAX_K, D) == "large" and T.bf16_route(100, D) == "large" and err <= K1_SCORE_TOL
          and rank_recall(qr, corpus, i, T.MAX_K) == 1.0 and torch.equal(i, i2) and torch.equal(s, s2),
          f"K1 bf16 pool form B={RERANK_BATCH} k={T.MAX_K}: scores within {K1_SCORE_TOL} of the plain version, "
          "recall 1.000, repeats bit for bit")
    t = cluster_times(torch, T, T.TOPK_BF16_LARGE, qr, corpus, None, N, T.MAX_K, "large")
    lib_ms = cuda_ms(lambda: torch.topk(qr @ corpus.T, T.MAX_K), 5)
    bnd = bound(RERANK_BATCH * D * 2 + N * D * 2 + RERANK_BATCH * T.MAX_K * 8, 2 * RERANK_BATCH * N * D, BF16_OPS_S)
    report["matmul_topk_bf16_large"] = {
        "max_abs_err": err, **t, "plain_ms": cuda_ms(lambda: T.topk_bf16_plain(qr, corpus, N, T.MAX_K), 3),
        "library_ms": lib_ms, "library_call": "composite: torch.matmul (bf16 scores) then torch.topk",
        "shape": f"B {RERANK_BATCH}, k {T.MAX_K}", **bnd}
    print(f"K1 bf16 pool form B={RERANK_BATCH} k={T.MAX_K}: kernel {t['ms']:.4f} ms (scan {t['scan_ms']:.4f}, merge "
          f"{t['merge_ms']:.4f}), library {lib_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms", flush=True)
    for b, k in ((RERANK_BATCH, 100), (B, T.MAX_K)):
        qb = q[:b].contiguous()
        t = cluster_times(torch, T, T.TOPK_BF16_LARGE, qb, corpus, None, N, k, "large")
        lib = cuda_ms(lambda: torch.topk(qb @ corpus.T, k), 5)
        print(f"K1 bf16 pool form B={b} k={k} ({T.cluster_size(b)}-CTA clusters): kernel {t['ms']:.4f} ms (scan "
              f"{t['scan_ms']:.4f}, merge {t['merge_ms']:.4f}), library {lib:.4f} ms", flush=True)
        report["matmul_topk_bf16_large"][f"b{b}_k{k}_ms"] = t["ms"]
        report["matmul_topk_bf16_large"][f"b{b}_k{k}_library_ms"] = lib
    s, i = T._scan_cuda(T.TOPK_BF16_SCAN, 0, qr, corpus, None, N, T.MAX_K)
    torch.cuda.synchronize()
    report["matmul_topk_bf16_scan"] = {
        "max_abs_err": (s - ps).abs().max().item(), "ms": cuda_ms(lambda: T._scan_cuda(
            T.TOPK_BF16_SCAN, 0, qr, corpus, None, N, T.MAX_K), 3),
        "plain_ms": report["matmul_topk_bf16_large"]["plain_ms"], "library_ms": lib_ms,
        "library_call": "composite: torch.matmul (bf16 scores) then torch.topk",
        "shape": f"B {RERANK_BATCH}, k {T.MAX_K}, called directly", **bnd}
    check(rank_recall(qr, corpus, i, T.MAX_K) == 1.0 and report["matmul_topk_bf16_scan"]["max_abs_err"] <= K1_SCORE_TOL,
          f"K1 tile scan B={RERANK_BATCH} k={T.MAX_K} (called directly): recall 1.000, scores within {K1_SCORE_TOL}")

    # exact ties across tiles, warpgroups and clusters: ids equal the plain version's
    tied, h = tie_corpus(torch, T, corpus, valid, gen)
    del corpus
    for b in TOPK_BATCHES:
        q = (h[None, :] * 2.0 ** -(torch.arange(b, device="cuda")[:, None] % 3)).to(torch.bfloat16)
        for k in TIE_KS:
            s, i = T.topk_bf16(q, tied, valid, k)
            s2, i2 = T.topk_bf16(q, tied, valid, k)
            ps, pi = T.topk_bf16_plain(q, tied, valid, k)
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and (s - ps).abs().max().item() == 0.0 and torch.equal(i, i2)
                  and torch.equal(s, s2) and rank_recall(q, tied[:valid], i, k) == 1.0,
                  f"K1 ties B={b} k={k} ({T.bf16_route(k, D)} route, {T.cluster_size(b)}-CTA clusters): ids and "
                  "scores equal the plain version's, recall 1.000, repeats bit for bit")
    del tied

    base = torch.randn(N, D, generator=gen, device="cuda")
    codes, scales = quant.quantize_int8_reference(base)
    gcodes, _ = quant.quantize_int8_global(base)
    del base
    q_i8, _ = T.quantize_queries(torch.randn(max(INT8_BATCHES), D, generator=gen, device="cuda"))
    worst = 0.0
    for b in INT8_BATCHES:
        qb = q_i8[:b].contiguous()
        for n in (N, N - 777):
            for k in INT8_KS:
                (s, i), (ps, pi) = T.topk_int8(qb, codes, scales, n, k), T.topk_int8_plain(qb, codes, scales, n, k)
                torch.cuda.synchronize()
                check(torch.equal(i, pi) and torch.equal(s, ps),
                      f"matmul_topk_int8 B={b} valid_n={n} k={k} ({T.int8_route(k, D)} form, "
                      f"{T.cluster_size(b)}-CTA clusters): ids and scores equal the plain version exactly")
                worst = max(worst, (s - ps).abs().max().item())
    rcodes, rscales, rgcodes = repeated_codes(torch, quant, gen, N, 4096)
    for b in INT8_BATCHES:
        qb = q_i8[:b].contiguous()
        for k in INT8_KS:
            (s, i), (ps, pi) = T.topk_int8(qb, rcodes, rscales, N - 777, k), T.topk_int8_plain(qb, rcodes, rscales,
                                                                                                N - 777, k)
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and torch.equal(s, ps),
                  f"matmul_topk_int8 on repeated rows B={b} k={k}: ids and scores equal the plain version exactly")
    del rcodes, rscales
    phase_k3(torch, T, q_i8, gcodes, rgcodes, gen, report)
    del rgcodes
    q8 = q_i8[:B].contiguous()
    t = cluster_times(torch, T, T.TOPK_INT8, q8, codes, scales, N, K, "cluster")
    report["matmul_topk_int8"] = {
        "max_abs_err": worst, **t, "plain_ms": cuda_ms(lambda: T.topk_int8_plain(q8, codes, scales, N, K), 3),
        "library_ms": cuda_ms(lambda: torch.topk(torch._int_mm(q8, codes.T).float() * scales, K), 5),
        "library_call": "composite: torch._int_mm (int32 scores) then torch.topk",
        **bound(B * D + N * D + N * 4 + B * K * 8, 2 * B * N * D, INT8_OPS_S)}
    r = report["matmul_topk_int8"]
    print(f"K2 int8 B={B} k={K}: kernel {r['ms']:.4f} ms (scan {r['scan_ms']:.4f}, merge {r['merge_ms']:.4f}), "
          f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms", flush=True)
    for b, k in ((8, K), (B, K_RERANK), (B, T.MAX_K)):
        qb = q_i8[:b].contiguous()
        t = cluster_times(torch, T, T.TOPK_INT8, qb, codes, scales, N, k, T.int8_route(k, D))
        qp = qb if b > 16 else torch.cat([qb, qb.new_zeros(32 - b, D)])  # _int_mm takes more than 16 rows
        lib = cuda_ms(lambda: torch.topk(torch._int_mm(qp, codes.T).float() * scales, k), 5)
        print(f"K2 int8 B={b} k={k} ({T.int8_route(k, D)} form): kernel {t['ms']:.4f} ms (scan {t['scan_ms']:.4f}, "
              f"merge {t['merge_ms']:.4f}), library {lib:.4f} ms", flush=True)
        r[f"b{b}_k{k}_ms"] = t["ms"]
        r[f"b{b}_k{k}_library_ms"] = lib
    del codes, scales, gcodes

    # the tile scans of K1 and K2 through their route: a width off the
    # 64-column panels
    bcorpus = torch.randn(N, SCAN_D, generator=gen, device="cuda").to(torch.bfloat16)
    qb = torch.randn(RERANK_BATCH, SCAN_D, generator=gen, device="cuda").to(torch.bfloat16)
    s, i = T.topk_bf16(qb, bcorpus, N - 777, K)
    ps, _ = T.topk_bf16_plain(qb, bcorpus, N - 777, K)
    torch.cuda.synchronize()
    check(T.bf16_route(K, SCAN_D) == "scan" and (s - ps).abs().max().item() <= K1_SCORE_TOL
          and rank_recall(qb, bcorpus[:N - 777], i, K) == 1.0,
          f"K1 tile scan route D={SCAN_D} B={RERANK_BATCH} k={K}: recall 1.000, scores within {K1_SCORE_TOL}")
    del bcorpus
    base = torch.randn(N, SCAN_D, generator=gen, device="cuda")
    codes, scales = quant.quantize_int8_reference(base)
    gcodes, _ = quant.quantize_int8_global(base)
    del base
    q8, _ = T.quantize_queries(torch.randn(B, SCAN_D, generator=gen, device="cuda"))
    worst = 0.0
    for n, k in ((N, K), (N - 777, K_RERANK)):
        (s, i), (ps, pi) = T.topk_int8(q8, codes, scales, n, k), T.topk_int8_plain(q8, codes, scales, n, k)
        torch.cuda.synchronize()
        check(T.int8_route(k, SCAN_D) == "scan" and torch.equal(i, pi) and torch.equal(s, ps),
              f"matmul_topk_int8 tile scan route D={SCAN_D} valid_n={n} k={k}: ids and scores equal the plain version")
        worst = max(worst, (s - ps).abs().max().item())
    report["matmul_topk_int8_scan"] = {
        "max_abs_err": worst, "ms": cuda_ms(lambda: T.topk_int8(q8, codes, scales, N, K), 5),
        "plain_ms": cuda_ms(lambda: T.topk_int8_plain(q8, codes, scales, N, K), 3),
        "library_ms": cuda_ms(lambda: torch.topk(torch._int_mm(q8, codes.T).float() * scales, K), 5),
        "library_call": "composite: torch._int_mm (int32 scores) then torch.topk", "shape": f"B {B}, D {SCAN_D}, k {K}",
        **bound(B * SCAN_D + N * SCAN_D + N * 4 + B * K * 8, 2 * B * N * SCAN_D, INT8_OPS_S)}
    worst = 0.0
    for n, k in ((N, K), (N - 777, K_RERANK)):
        (s, i), (ps, pi) = T.topk_int8_global(q8, gcodes, n, k), T.topk_int8_global_plain(q8, gcodes, n, k)
        torch.cuda.synchronize()
        check(T.int8_global_route(k, SCAN_D) == "scan" and torch.equal(i, pi) and torch.equal(s, ps),
              f"matmul_topk_int8_global tile scan route D={SCAN_D} valid_n={n} k={k}: ids and scores equal the plain "
              "version")
        worst = max(worst, (s - ps).abs().max().item())
    report["matmul_topk_int8_global_scan"] = {
        "max_abs_err": worst, "ms": cuda_ms(lambda: T.topk_int8_global(q8, gcodes, N, K), 5),
        "plain_ms": cuda_ms(lambda: T.topk_int8_global_plain(q8, gcodes, N, K), 3),
        "library_ms": cuda_ms(lambda: torch.topk(torch._int_mm(q8, gcodes.T), K), 5),
        "library_call": "composite: torch._int_mm (int32 scores) then torch.topk", "shape": f"B {B}, D {SCAN_D}, k {K}",
        **bound(B * SCAN_D + N * SCAN_D + B * K * 8, 2 * B * N * SCAN_D, INT8_OPS_S)}
    del codes, scales, gcodes
    cluster_resources(torch, T, report)


def phase_k3(torch, T, q_i8, gcodes, rgcodes, gen, report) -> None:
    """K3 (int8 codes under one global scale, selected on the raw sums)
    against its plain version, ids and scores equal: at TOPK_BATCHES x
    INT8_KS x valid_n N and N - 777 on random codes, on repeated rows and
    on a tie-heavy low-range corpus; then its times at the serving shape
    (list form), at B 8, at k 40 and k 256 (pool form), and the tile scan
    at B 256, k 10 (called directly: the route sends it only what no
    cluster form takes)."""
    worst = 0.0
    for b in TOPK_BATCHES:
        qb = q_i8[:b].contiguous()
        for n in (N, N - 777):
            for k in INT8_KS:
                (s, i), (ps, pi) = T.topk_int8_global(qb, gcodes, n, k), T.topk_int8_global_plain(qb, gcodes, n, k)
                torch.cuda.synchronize()
                check(torch.equal(i, pi) and torch.equal(s, ps),
                      f"matmul_topk_int8_global B={b} valid_n={n} k={k} ({T.int8_global_route(k, D)} form, "
                      f"{T.cluster_size(b)}-CTA clusters): ids and scores equal the plain version exactly")
                worst = max(worst, (s - ps).abs().max().item())
        for k in INT8_KS:
            (s, i), (ps, pi) = (T.topk_int8_global(qb, rgcodes, N - 777, k),
                                T.topk_int8_global_plain(qb, rgcodes, N - 777, k))
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and torch.equal(s, ps),
                  f"matmul_topk_int8_global on repeated rows B={b} k={k}: ids and scores equal the plain version")
    lcodes, lq = low_range_codes(torch, gen, N, max(TOPK_BATCHES))
    for b in TOPK_BATCHES:
        qb = lq[:b].contiguous()
        for k in INT8_KS:
            (s, i), (ps, pi) = T.topk_int8_global(qb, lcodes, N - 777, k), T.topk_int8_global_plain(qb, lcodes,
                                                                                                     N - 777, k)
            torch.cuda.synchronize()
            ties = ""
            if b == RERANK_BATCH:
                tied = (T._int8_raw(qb, lcodes, N - 777) == ps[:, -1:]).sum(1)
                ties = f", {int(tied.min())}-{int(tied.max())} rows tie at the k-th score"
            check(torch.equal(i, pi) and torch.equal(s, ps),
                  f"matmul_topk_int8_global on low-range codes B={b} k={k}{ties}: ids and scores equal the plain "
                  "version exactly")
    del lcodes, lq

    q8 = q_i8[:B].contiguous()
    t = cluster_times(torch, T, T.TOPK_INT8_GLOBAL, q8, gcodes, None, N, K, "cluster")
    s, i = T._scan_cuda(T.TOPK_INT8_GLOBAL_SCAN, T.ELEMS["int8_global"], q8, gcodes, None, N, K)
    ps, pi = T.topk_int8_global_plain(q8, gcodes, N, K)
    torch.cuda.synchronize()
    check(torch.equal(i, pi) and torch.equal(s, ps),
          f"K3 tile scan B={B} k={K} (called directly): ids and scores equal the plain version")
    report["matmul_topk_int8_global"] = {
        "max_abs_err": worst, **t, "plain_ms": cuda_ms(lambda: T.topk_int8_global_plain(q8, gcodes, N, K), 3),
        "library_ms": cuda_ms(lambda: torch.topk(torch._int_mm(q8, gcodes.T), K), 5),
        "library_call": "composite: torch._int_mm (int32 scores) then torch.topk",
        "tile_scan_ms": cuda_ms(lambda: T._scan_cuda(T.TOPK_INT8_GLOBAL_SCAN, T.ELEMS["int8_global"], q8, gcodes,
                                                     None, N, K), 5),
        **bound(B * D + N * D + B * K * 8, 2 * B * N * D, INT8_OPS_S)}
    r = report["matmul_topk_int8_global"]
    print(f"K3 int8_global B={B} k={K}: kernel {r['ms']:.4f} ms (scan {r['scan_ms']:.4f}, merge {r['merge_ms']:.4f}), "
          f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
          f"{r['bound_ms'] / r['ms']:.2f} of the bound; the tile scan {r['tile_scan_ms']:.4f} ms", flush=True)
    for b, k in ((8, K), (B, K_RERANK), (RERANK_BATCH, T.MAX_K), (B, T.MAX_K)):
        qb = q_i8[:b].contiguous()
        route = T.int8_global_route(k, D)
        t = cluster_times(torch, T, T.TOPK_INT8_GLOBAL, qb, gcodes, None, N, k, route)
        qp = qb if b > 16 else torch.cat([qb, qb.new_zeros(32 - b, D)])  # _int_mm takes more than 16 rows
        lib = cuda_ms(lambda: torch.topk(torch._int_mm(qp, gcodes.T), k), 5)
        bnd = bound(b * D + N * D + b * k * 8, 2 * b * N * D, INT8_OPS_S)
        print(f"K3 int8_global B={b} k={k} ({route} form, {T.cluster_size(b)}-CTA clusters): kernel {t['ms']:.4f} ms "
              f"(scan {t['scan_ms']:.4f}, merge {t['merge_ms']:.4f}), library {lib:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms", flush=True)
        r.update({f"b{b}_k{k}_ms": t["ms"], f"b{b}_k{k}_scan_ms": t["scan_ms"], f"b{b}_k{k}_merge_ms": t["merge_ms"],
                  f"b{b}_k{k}_library_ms": lib, f"b{b}_k{k}_bound_ms": bnd["bound_ms"]})


def phase_topk_edges(torch, T, quant, gen) -> None:
    """K1, K2 and K3 against their plain versions at TOPK_EDGES, every form."""
    for d, n, valid in TOPK_EDGES:
        corpus = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
        base = torch.randn(n, d, generator=gen, device="cuda")
        codes, scales = quant.quantize_int8_reference(base)
        gcodes, _ = quant.quantize_int8_global(base)
        for b in (3, 300):
            qf = torch.randn(b, d, generator=gen, device="cuda")
            q, (q8, _) = qf.to(torch.bfloat16), T.quantize_queries(qf)
            for k in (K, 61, 256):
                s, i = T.topk_bf16(q, corpus, valid, k)
                ps, _ = T.topk_bf16_plain(q, corpus, valid, k)
                (s8, i8), (ps8, pi8) = T.topk_int8(q8, codes, scales, valid, k), T.topk_int8_plain(q8, codes, scales,
                                                                                                   valid, k)
                (sg, ig), (psg, pig) = T.topk_int8_global(q8, gcodes, valid, k), T.topk_int8_global_plain(q8, gcodes,
                                                                                                          valid, k)
                torch.cuda.synchronize()
                check((s - ps).abs().max().item() <= K1_SCORE_TOL and rank_recall(q, corpus[:valid], i, k) == 1.0
                      and torch.equal(i8, pi8) and torch.equal(s8, ps8) and torch.equal(ig, pig) and torch.equal(sg, psg),
                      f"K1 / K2 / K3 edge D={d} N={n} valid_n={valid} B={b} k={k} ({T.bf16_route(k, d)} / "
                      f"{T.int8_route(k, d)} / {T.int8_global_route(k, d)}): K1 recall 1.000 and scores within "
                      f"{K1_SCORE_TOL}, K2 and K3 equal")


def ingest_lens(torch):
    """kv_lens of the ingest's first batch: the token counts of the first
    FLASH_B chunks of the passages phase_slice ingests, at max_len FLASH_T."""
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer, batch_encode
    from vietnamese_qa_system_tpu_torch.engine.chunking import chunk_text

    chunks = [c for text in passages(N_PASSAGES, SEED) for c in chunk_text(text)][:FLASH_B]
    _, mask = batch_encode(ByteTokenizer(), chunks, FLASH_T)
    return torch.from_numpy(mask).sum(1).to("cuda", torch.int32)


def phase_flash(torch, A, gen, report, rel_bias_of, variants):
    """K4 against its plain version at the encoder's shape in the ingest:
    its batch, its first batch's kv_lens, the MPNet relative bias."""
    b, h, t, d = FLASH_B, FLASH_H, FLASH_T, FLASH_D
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda") for _ in range(3))
    lens = ingest_lens(torch)
    bias = rel_bias_of(t)[0].contiguous()  # (H, T, T) MPNet relative bias

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).to(torch.bfloat16).contiguous()

    qb, kb, vb = to_bh(q * d ** -0.5), to_bh(k), to_bh(v)
    lens_bh = lens.repeat_interleave(h).contiguous()
    o, lse = A.flash_fwd(qb, kb, vb, lens_bh, bias, h)
    po, plse = A.flash_fwd_plain(qb, kb, vb, lens_bh, bias, h)
    torch.cuda.synchronize()
    diff = (o.float() - po.float()).abs()
    lse_diff = (lse - plse).abs()
    print(f"flash o: max abs err {diff.max().item():.6f}, mean {diff.mean().item():.3e}; "
          f"lse: max abs err {lse_diff.max().item():.6f}, mean {lse_diff.mean().item():.3e}")
    check(bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(lse).all()),
          f"K4 flash: o and lse finite (kv_lens {int(lens.min())}..{int(lens.max())}, mean {lens.float().mean():.1f})")
    check(diff.max().item() <= FLASH_O_TOL, f"K4 flash B={b} H={h} T={t} D={d}: o max abs err <= {FLASH_O_TOL}")
    check(lse_diff.max().item() <= FLASH_LSE_TOL, f"K4 flash: lse max abs err <= {FLASH_LSE_TOL}")
    # the library yardstick: SDPA with the bias and the key mask folded
    # into one float mask (built outside the timed call)
    keys = torch.arange(t, device="cuda")
    key_mask = torch.where(keys[None, :] < lens[:, None], 0.0, float("-inf"))
    sdpa_mask = (bias[None] + key_mask[:, None, None, :]).to(torch.bfloat16)
    q4, k4, v4 = (x.view(b, h, t, d) for x in (qb, kb, vb))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    io_bytes = 4 * b * h * t * d * 2 + h * t * t * 4 + b * h * 4 + b * h * t * 4  # q k v o, bias, lens, lse
    report["flash_attention_fwd"] = {
        "max_abs_err": diff.max().item(),
        "ms": cuda_ms(lambda: A.flash_fwd(qb, kb, vb, lens_bh, bias, h), 20),
        "plain_ms": cuda_ms(lambda: A.flash_fwd_plain(qb, kb, vb, lens_bh, bias, h), 5),
        "library_ms": cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=sdpa_mask, scale=1.0), 20),
        "library_call": "torch.nn.functional.scaled_dot_product_attention, bias + key mask as a bf16 attn_mask",
        **bound(io_bytes, 4 * t * d * h * int(lens.sum()), BF16_OPS_S),  # keys this run's kv_lens admit
    }
    fwd = report["flash_attention_fwd"]
    useful = 4 * t * d * h * int(lens.sum())
    bk, bq = variants[("fwd", d, 0, 1)][4:6]
    issued = issued_flops(A, lens_bh.tolist(), t, t, d, False, None, bq, bk)
    print(f"K4 encoder B={b} H={h} T={t} D={d}: kernel {fwd['ms']:.4f} ms, SDPA {fwd['library_ms']:.4f} ms (ratio "
          f"{fwd['ms'] / fwd['library_ms']:.2f}), plain {fwd['plain_ms']:.3f} ms; useful work "
          f"{useful / fwd['ms'] / 1e9:.1f} TFLOP/s, issued (tiles the kv_len skip leaves) {issued / 1e9:.2f} GFLOP "
          f"= {issued / fwd['ms'] / 1e9:.1f} TFLOP/s, a dense kernel's {4 * t * t * d * b * h / 1e9:.2f} GFLOP",
          flush=True)


def flash_variants(torch) -> dict:
    """Registers, shared memory and blocks per SM of every compiled variant
    of K4 and K7 (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocks...),
    and the ptxas log (-Xptxas -v) of both sources: no spills anywhere.
    Returns {("fwd", D, causal, bias) | ("bwd", D, 0 dK/dV | 1 dQ, bias):
    (registers, shared bytes, blocks per SM, local bytes, ...)}."""
    import ctypes

    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels

    libs = cuda_kernels.library()
    fwd_info, bwd_info = libs["flash_fwd.cu"].vqa_flash_fwd_info, libs["flash_bwd.cu"].vqa_flash_bwd_info
    for fn in (fwd_info, bwd_info):
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    bias_names = {0: "no bias", 1: "full bias", 2: "key-only bias"}
    rows = {}
    for hd in (32, 64, 128):
        for bias in (0, 1, 2):
            for causal in (0, 1):
                check(fwd_info(hd, causal, bias, out) == 0, "K4 variant info")
                rows[("fwd", hd, causal, bias)] = tuple(out)
                print(f"K4 D={hd} {'causal' if causal else 'bidirectional'} {bias_names[bias]}: {out[0]} registers, "
                      f"{out[1]} B shared, {out[2]} block(s)/SM, {out[3]} B local, BK {out[4]}, BQ {out[5]}")
            for which, label in ((0, "K7 dK/dV"), (1, "K7 dQ")):
                check(bwd_info(hd, bias, which, out) == 0, f"{label} variant info")
                rows[("bwd", hd, which, bias)] = tuple(out)[:5]
                print(f"{label} D={hd} {bias_names[bias]}: {out[0]} registers, {out[1]} B shared, {out[2]} block(s)/SM, "
                      f"{out[3]} B local")
    for file in ("flash_fwd.cu", "flash_bwd.cu"):
        with open(cuda_kernels._lib_path(file)[:-3] + ".log") as f:
            spills = [line.strip() for line in f if "spill" in line]
        check(spills and all(line.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
                             for line in spills), f"{file}: ptxas reports no spills in {len(spills)} functions")
    check(all(r[3] == 0 and r[2] >= 1 for r in rows.values()), "every K4 / K7 variant: no local memory, fits an SM")
    # the encoder form's shared memory fits two blocks an SM by 32 bytes
    check(rows[("fwd", 64, 0, 1)][2] == 2, "K4 encoder form (D 64, bidirectional, full bias): 2 blocks an SM")
    return rows


def edge_lens(torch, kind: str, bh: int, t: int, gen):
    """kv_lens for the edge checks: 'edge' cycles 0, 1, T (causal rows at
    each), 'mixed' draws them with 0, 1 and T among them."""
    if kind == "edge":
        return torch.tensor([(0, 1, t)[i % 3] for i in range(bh)], dtype=torch.int32, device="cuda")
    lens = torch.randint(1, t + 1, (bh,), generator=gen, device="cuda").to(torch.int32)
    lens[0], lens[1], lens[-1] = 0, 1, t
    return lens


def phase_flash_edges(torch, A, gen) -> None:
    """K4 and K7 against their plain versions at FLASH_EDGES, with the
    tolerances of the main shapes; K7 must repeat bit for bit."""
    b, h = 3, 2
    for d, t, causal, window, bias_kind, lens_kind in FLASH_EDGES:
        bh = b * h
        q, k, v, do = (torch.randn(bh, t, d, generator=gen, device="cuda") for _ in range(4))
        qb, kb, vb = (q * d ** -0.5).to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
        dob = (do * 0.1).to(torch.bfloat16)
        lens = edge_lens(torch, lens_kind, bh, t, gen)
        bias = None
        if bias_kind == "full":
            bias = torch.randn(h, t, t, generator=gen, device="cuda")
        elif bias_kind == "key":
            bias = (torch.arange(t, device="cuda") - t + 1).float()[None, None, :] * torch.tensor(
                [0.05, 0.2], device="cuda")[:, None, None]
        label = (f"D={d} T={t} {'causal' if causal else 'bidirectional'} window={window} bias={bias_kind} "
                 f"kv_lens {lens_kind} {lens.tolist()}")
        o, lse = A.flash_fwd(qb, kb, vb, lens, bias, h, causal, window)
        po, plse = A.flash_fwd_plain(qb, kb, vb, lens, bias, h, causal, window)
        grads = A.flash_bwd(qb, kb, vb, o, lse, dob, lens, bias, h, causal, window)
        again = A.flash_bwd(qb, kb, vb, o, lse, dob, lens, bias, h, causal, window)
        plain = A.flash_bwd_plain(qb, kb, vb, o, lse, dob, lens, bias, h, causal, window)
        torch.cuda.synchronize()
        o_err = (o.float() - po.float()).abs().max().item()
        lse_err = (lse - plse).abs().max().item()
        rels = [(g.float() - p.float()).abs().max().item() / max(p.float().abs().max().item(), 1e-30)
                for g, p in zip(grads, plain)]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in (o, lse, *grads))
        check(finite and o_err <= FLASH_O_TOL and lse_err <= FLASH_LSE_TOL and max(rels) <= FLASH_GRAD_REL_TOL
              and all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"K4/K7 edge {label}: o err {o_err:.2e}, lse err {lse_err:.2e}, dq/dk/dv rel err "
              f"{', '.join(f'{r:.2e}' for r in rels)}; K7 repeats bit for bit")


def issued_flops(A, bh_lens, tq: int, tk: int, d: int, causal: bool, window, bq: int, bk: int,
                 products: int = 2) -> float:
    """The products a kernel issues: for each consumer warpgroup (64 rows)
    the key tiles ``key_tile_range`` leaves, ``products`` (64 x bk x d)
    products each (2 in K4)."""
    tiles = 0
    for kv_len in bh_lens:
        for r0 in range(0, tq, bq):
            lo, hi = A.key_tile_range(r0, bq, bk, tq, tk, int(kv_len), causal, window)
            if lo > hi:
                continue
            for w0 in range(r0, min(r0 + bq, tq), 64):
                wlo, whi = A.key_tile_range(w0, 64, bk, tq, tk, int(kv_len), causal, window)
                tiles += max(0, whi - wlo + 1)
    return tiles * products * 2.0 * 64 * bk * d


def phase_w8(torch, report):
    """K6 against its plain version at the PhoGPT-4B shapes, at the decode
    rows (W8_ROWS) and at the engine's prefill rows (W8_CHECK_ROWS), and at
    the edge shapes W8_EDGES.  Every row is timed over enough weight copies
    to stream them from HBM as a forward does (one layer's weights never
    stay in L2 across 32 layers).  Device times come from CUDA graph
    replays; the host-paced time of the same calls (events around plain
    launches) is printed beside them, and a captured CUDA graph counts one
    call's kernels."""
    from vietnamese_qa_system_tpu_torch.models.quantize import dequantize_weight, quantize_weight
    from vietnamese_qa_system_tpu_torch.ops import w8_matmul as W

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    instances = {}
    for mp in W.ROW_BUCKETS:
        info = W.kernel_info(mp)
        rep = ptxas_report("w8_matmul.cu", f"w8_gemm_kernelILi{mp}E")
        print(f"K6 w8_matmul, {mp} rows: {info['threads']} threads, {info['cols']} columns a unit, {info['stages']} "
              f"stages, {info['registers']} registers, {info['shared_bytes']} B shared, {info['blocks_per_sm']} blocks "
              f"an SM, {info['local_bytes']} B local; ptxas: {rep}", flush=True)
        check("0 bytes spill stores, 0 bytes spill loads" in rep and "serialized" not in rep and info["local_bytes"] == 0
              and info["blocks_per_sm"] >= 1,
              f"K6, {mp} rows: ptxas reports no spills and no serialized wgmma, the kernel fits an SM")
        instances[mp] = info
    layers = {m: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0) for m in W8_LAYER_ROWS}
    mt5_layer = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    worst = 0.0

    def held(m, k, n, x, w_q, w_s):
        y = W.w8_matmul(x, w_q, w_s, out_dtype=torch.float32)
        again = W.w8_matmul(x, w_q, w_s, out_dtype=torch.float32)
        ref = W.w8_matmul_reference(x, w_q, w_s, torch.float32)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        plan = W.partition(m, k, n, W.resident_slots(0, W.padded_rows(m)))
        check(rel <= W8_REL_TOL and torch.equal(y, again),
              f"K6 w8_matmul M={m} K={k} N={n} ({plan.rows}-row instance, {plan.grid} blocks, {plan.units} units of "
              f"{plan.cols} columns): max abs err {err:.3e} ({rel:.2e} of max |y|) <= {W8_REL_TOL}, repeats bit for bit")
        return err

    for k, n in W8_SHAPES + MT5_W8_SHAPES:
        leaf = quantize_weight(torch.randn(k, n, generator=gen, device="cuda") * 0.02, "int8c")
        copies = max(2, -(-3 * L2_BYTES // (k * n)))
        wqs = [leaf["w_q"].clone() for _ in range(copies)]
        w_bf16 = [dequantize_weight(wq, leaf["w_s"], torch.bfloat16) for wq in wqs]
        ws = leaf["w_s"]
        for m in W8_ROWS + W8_CHECK_ROWS:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            worst = max(worst, held(m, k, n, x, wqs[0], ws))

            def kernel(it=itertools.cycle(wqs)):
                return W.w8_matmul(x, next(it), ws, out_dtype=torch.float32)

            rows = {
                "ms": graph_ms(kernel, 24),
                "plain_ms": graph_ms(lambda: W.w8_matmul_reference(x, wqs[0], ws, torch.float32), 6),
                "library_ms": graph_ms(lambda it=itertools.cycle(w_bf16): torch.matmul(x, next(it)), 24),
                **bound(m * k * 2 + k * n + n * 4 + m * n * 4, 2 * m * k * n, BF16_OPS_S),
            }
            print(f"K6 M={m:3d} K={k:5d} N={n:5d}: kernel {rows['ms'] * 1e3:7.2f} us ({k * n / rows['ms'] / 1e9:.2f} TB/s "
                  f"of weights, {rows['bound_ms'] / rows['ms']:.2f} of the bound; host-paced "
                  f"{cuda_ms(kernel, 60) * 1e3:6.2f}), plain {rows['plain_ms'] * 1e3:8.2f} us, library (bf16 weight, "
                  f"twice the bytes) {rows['library_ms'] * 1e3:7.2f} us, bound {rows['bound_ms'] * 1e3:6.2f} us "
                  f"({rows['bound_by']})", flush=True)
            if m in layers and (k, n) in W8_PER_LAYER:
                for key in layers[m]:
                    layers[m][key] += W8_PER_LAYER[(k, n)] * rows[key]
            if m == 8 and (k, n) in MT5_PER_DECODER_LAYER:
                for key in mt5_layer:
                    mt5_layer[key] += MT5_PER_DECODER_LAYER[(k, n)] * rows[key]
        del wqs, w_bf16
    for m, k, n in W8_EDGES:
        leaf = quantize_weight(torch.randn(k, n, generator=gen, device="cuda") * 0.02, "int8c")
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        worst = max(worst, held(m, k, n, x, leaf["w_q"], leaf["w_s"]))
    # one call is one kernel launch (the split-K sum happens inside it): the
    # call captured in a CUDA graph holds one node, a kernel node of the
    # call's row instance at the partition's grid
    leaf = quantize_weight(torch.randn(3072, 3072, generator=gen, device="cuda") * 0.02, "int8c")
    for m in (8, 72):
        x = torch.randn(m, 3072, generator=gen, device="cuda").to(torch.bfloat16)
        nodes = graph_nodes(lambda: W.w8_matmul(x, leaf["w_q"], leaf["w_s"], out_dtype=torch.float32))
        plan = W.partition(m, 3072, 3072, W.resident_slots(0, W.padded_rows(m)))
        shown = [(kind, label.split("|")[3].strip() if label.count("|") >= 3 else label[:200]) for kind, label in nodes]
        check(len(nodes) == 1 and nodes[0][0] == "KERNEL" and f"w8_gemm_kernelILi{plan.rows}E" in nodes[0][1]
              and f"<<<{plan.grid}," in nodes[0][1].replace("\\", ""),
              f"K6: one call at M={m} K=3072 N=3072 is one kernel launch of the {plan.rows}-row instance on "
              f"{plan.grid} blocks (captured graph: {shown})")
    for m, acc in layers.items():
        print(f"K6, one PhoGPT-4B layer's six calls at M={m}: kernel {acc['ms'] * 1e3:.2f} us, plain "
              f"{acc['plain_ms'] * 1e3:.2f}, library {acc['library_ms'] * 1e3:.2f}, bound {acc['bound_ms'] * 1e3:.2f}",
              flush=True)
    print(f"K6, one mt5-small decoder layer's nine calls a step at M=8: kernel {mt5_layer['ms'] * 1e3:.2f} us, plain "
          f"{mt5_layer['plain_ms'] * 1e3:.2f}, library {mt5_layer['library_ms'] * 1e3:.2f}, bound "
          f"{mt5_layer['bound_ms'] * 1e3:.2f}", flush=True)
    report["w8_matmul"] = {
        "max_abs_err": worst, **layers[8], "bound_by": "bytes",
        "m72_layer": layers[72], "m128_layer": layers[128], "m256_layer": layers[256], "mt5_m8_decoder_layer": mt5_layer,
        "library_call": "composite: torch.matmul of bf16 x with a pre-dequantized bf16 weight (twice the bytes)",
        "shape": "one PhoGPT-4B layer's six calls at M=8: 4x (3072,3072) + (3072,12288) + (12288,3072)",
        "timing": "device time, CUDA graph replay of 24 calls over weight copies larger than L2",
        **instances[8], "instances": {str(mp): info for mp, info in instances.items()},
    }


def decode_attn_inputs(torch, gen, b, h, kv_h, d, tq, bias_kind, free_row):
    """One K9 call at a cache of DECODE_TOTAL columns and its guard column:
    q, the bf16 buffers (NaN in the guard column, which no query may read),
    the mask (each row's valid prefix drawn in DECODE_LENS with a padding
    hole of 0-96 columns; a Tq 9 window the spec chunk's per-query mask),
    the bias, and the columns any query attends."""
    from vietnamese_qa_system_tpu_torch.models.layers import alibi_bias

    total = DECODE_TOTAL
    q = torch.randn(b, tq, h, d, generator=gen, device="cuda")
    k, v = (torch.randn(b, total + 1, kv_h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    k[:, total], v[:, total] = float("nan"), float("nan")
    lens = torch.randint(DECODE_LENS[0], DECODE_LENS[1] + 1, (b,), generator=gen, device="cuda")
    hole_at = (torch.rand(b, generator=gen, device="cuda") * (lens - 100).float()).long()
    hole_len = torch.randint(0, 97, (b,), generator=gen, device="cuda")
    cols = torch.arange(total, device="cuda")[None, :]
    valid = (cols < lens[:, None]) & ~((cols >= hole_at[:, None]) & (cols < (hole_at + hole_len)[:, None]))
    if tq == 1:
        mask = valid[:, None, :]
    else:
        steps = torch.arange(tq, device="cuda")[None, :, None]
        mask = valid[:, None, :] | ((cols[:, None, :] >= lens[:, None, None]) & (cols[:, None, :] <= lens[:, None, None] + steps))
    if free_row:
        mask = mask.clone()
        mask[0] = False
    bias = None
    if bias_kind == "alibi":
        bias = alibi_bias(h, total, "mpt", 8.0, "cuda")
    elif bias_kind == "rows":  # a T5 decoder's per-row bias (B, H, 1, Tk)
        bias = torch.randn(b, h, 1, total, generator=gen, device="cuda")
    return q, k, v, mask, bias, int(mask.any(dim=1).sum())


def phase_decode_attn(torch, report):
    """K9 against its plain version at PhoGPT-4B's decode shapes (DECODE_ATTN_CASES),
    its launches, registers and shared memory, and its time beside its
    bound (the attended columns' K and V read once, q, the output, the mask
    and the bias), the plain version (the einsum branch it replaced) and SDPA."""
    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels as ck
    from vietnamese_qa_system_tpu_torch.ops import decode_attention as DA

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    ck.DECODE_ATTN.launches = 0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for label, b, h, kv_h, d, tq, bias_kind, free_row in DECODE_ATTN_CASES:
        q, k, v, mask, bias, n_cols = decode_attn_inputs(torch, gen, b, h, kv_h, d, tq, bias_kind, free_row)
        before = ck.DECODE_ATTN.launches
        out = DA.decode_attention(q, k, v, mask, bias)
        torch.cuda.synchronize()
        check(ck.DECODE_ATTN.launches == before + 1, f"K9 {label}: one launch a call")
        want = DA.decode_attention_plain(q, k, v, mask, bias)
        vmax = v[:, :DECODE_TOTAL].float().abs().max().item()
        err = (out - want).abs().max().item()
        p = DA.plan(b, h, kv_h, tq, DECODE_TOTAL, sms)
        check(bool(torch.isfinite(out).all()), f"K9 {label}: every output finite (the guard column holds NaN)")
        check(err <= DECODE_ATTN_REL_TOL * vmax,
              f"K9 {label} B={b} H={h} kvH={kv_h} D={d} Tq={tq} bias {bias_kind} ({p.splits} splits of {p.per} "
              f"tiles, {p.row_blocks} x {p.block_rows} rows): max abs err {err:.3e} <= 2^-8 x max|v| {vmax:.2f}")
        if free_row:
            check(bool((out[0] == 0).all()), f"K9 {label}: a row with no valid key gives 0")
        info = ck.query("decode_attn.cu", "vqa_decode_attn_info", d, p.block_rows, p.per)
        check(info[3] == 0, f"K9 {label}: no local memory (spills) a thread, {info[0]} registers")
        mrows = 1 if mask.shape[1] == 1 else tq
        io = (n_cols * kv_h * d * 2 * 2 + b * tq * h * d * (2 + 4) + b * mrows * DECODE_TOTAL
              + (0 if bias is None else bias.numel() * 4))
        ops = 4 * tq * h * d * n_cols
        row = {"max_abs_err": err, "max_abs_v": vmax, "splits": p.splits, "tiles_a_split": p.per,
               "row_blocks": p.row_blocks, "block_rows": p.block_rows, "registers": info[0], "shared_bytes": info[1],
               "blocks_per_sm": info[2], "attended_columns": n_cols,
               "ms": graph_ms(lambda: DA.decode_attention(q, k, v, mask, bias), 20),
               "plain_ms": cuda_ms(lambda: DA.decode_attention_plain(q, k, v, mask, bias), 5),
               **bound(io, ops, F32_OPS_S)}
        if not free_row:
            # the library yardstick: SDPA over the cache's columns, the bias and the mask folded into one bf16 mask
            keys = torch.where(mask[:, None, :, :], 0.0, float("-inf"))
            amask = (keys if bias is None else keys + bias).to(torch.bfloat16)
            qh = q.transpose(1, 2).to(torch.bfloat16)
            kh, vh = (x[:, :DECODE_TOTAL].transpose(1, 2) for x in (k, v))
            row["library_ms"] = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=amask, enable_gqa=kv_h != h), 20)
        rows[label] = row
        print(f"K9 {label}: B={b} H={h} kvH={kv_h} D={d} Tq={tq}, {n_cols} attended columns: kernel "
              f"{row['ms']:.4f} ms against a {row['bound_ms']:.4f} ms bound ({row['bound_by']}; "
              f"{100 * row['bound_ms'] / row['ms']:.1f}%), plain {row['plain_ms']:.4f} ms, SDPA "
              f"{row.get('library_ms', float('nan')):.4f} ms; {info[0]} registers, {info[1]} B shared, "
              f"{info[2]} blocks/SM; err {err:.3e}", flush=True)
    cell = rows["decode"]
    report["decode_attention"] = {
        "phase_launches": ck.DECODE_ATTN.launches,
        **{key: cell[key] for key in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                      "registers", "shared_bytes", "blocks_per_sm")},
        "library_call": "torch.nn.functional.scaled_dot_product_attention, bias + key mask as a bf16 attn_mask",
        "cases": rows,
    }


def phase_k8(torch, quant, gen, report):
    """K8 against its plain version at 1,048,576 x 768 f32: codes and
    scales bit-equal (and from a bf16 input)."""
    x = torch.randn(N, D, generator=gen, device="cuda") * (torch.rand(N, 1, generator=gen, device="cuda") * 10 + 0.01)
    x[0] = 0.0  # the 1e-12 scale floor
    for inp in (x, x.to(torch.bfloat16)):
        (q, s), (pq, ps) = quant.quantize_int8(inp), quant.quantize_int8_reference(inp)
        torch.cuda.synchronize()
        check(torch.equal(q, pq) and torch.equal(s, ps),
              f"K8 quantize_int8 {N} x {D} {inp.dtype}: codes and scales bit-equal to the plain version")
    report["quantize_int8"] = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: quant.quantize_int8(x), 20),
        "plain_ms": cuda_ms(lambda: quant.quantize_int8_reference(x), 5),
        "library_ms": None,
        "library_call": "none: no single PyTorch call quantizes per row",
        # |x|, max, divide, round per element on the CUDA cores
        **bound(N * D * 4 + N * D + N * 4, 4 * N * D, F32_OPS_S),
    }


def passages(n: int, seed: int) -> list[str]:
    """Synthetic Vietnamese passages, each unique by its opening words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ("học sinh trường đại học nghiên cứu khoa học Việt Nam thành phố Hà Nội Hồ Chí Minh "
             "kinh tế văn hóa lịch sử sông Hồng đồng bằng miền núi nông nghiệp công nghiệp giáo dục "
             "sức khỏe bệnh viện người dân chính phủ luật pháp môi trường khí hậu mùa mưa").split()
    out = []
    for i in range(n):
        n_words = int(rng.integers(6, 90))
        body = " ".join(words[j] for j in rng.integers(0, len(words), n_words))
        # at most 500 characters: one passage is one 512-character chunk
        out.append(f"Tài liệu {i}: {body}"[:499].rsplit(" ", 1)[0] + ".")
    return out


def on_cpu(store):
    """A host twin of a store: its top-k runs the plain versions."""
    import torch

    cpu = torch.device("cpu")
    twin = copy.copy(store)
    twin.device, twin.devices, twin._tail = cpu, [cpu] * store.n_shards, store._tail.cpu()
    twin.slabs = [dataclasses.replace(slab, device=cpu, **{
        name: None if getattr(slab, name) is None else getattr(slab, name).cpu()
        for name in ("vectors", "scales", "res_vectors", "res_scales")}) for slab in store.slabs]
    return twin


def post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def serve(app):
    """An HTTP server for ``app`` on an ephemeral port; returns (url, stop)."""
    from vietnamese_qa_system_tpu_torch.engine import make_server

    httpd = make_server(app, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        app.close()
        thread.join(timeout=30)

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


def ask_all(url: str, path: str, payloads: list[dict]) -> list:
    """POST every payload at once, one thread each; a failed request
    leaves None."""
    answers = [None] * len(payloads)

    def ask(j):
        answers[j] = post(url + path, payloads[j])

    threads = [threading.Thread(target=ask, args=(j,)) for j in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return answers


MPNET_CONFIG = {  # paraphrase-mpnet-base-v2's config.json, the fields that shape the model
    "architectures": ["MPNetModel"], "model_type": "mpnet", "vocab_size": 30527, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu",
    "max_position_embeddings": 514, "layer_norm_eps": 1e-05, "relative_attention_num_buckets": 32, "pad_token_id": 1,
    "bos_token_id": 0, "eos_token_id": 2, "initializer_range": 0.02, "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1,
}


def mpnet_names(n_layers: int) -> dict:
    """The port's encoder tensor name -> (HF MPNetModel name, transposed)."""
    names = {"tok_embed": ("embeddings.word_embeddings.weight", False),
             "pos_embed": ("embeddings.position_embeddings.weight", False),
             "emb_ln.scale": ("embeddings.LayerNorm.weight", False), "emb_ln.bias": ("embeddings.LayerNorm.bias", False),
             "rel_bias": ("encoder.relative_attention_bias.weight", False)}
    for i in range(n_layers):
        hf = f"encoder.layer.{i}."
        for ours, theirs in (("attn.wq", "attention.attn.q"), ("attn.wk", "attention.attn.k"),
                             ("attn.wv", "attention.attn.v"), ("attn.wo", "attention.attn.o"),
                             ("mlp.wi", "intermediate.dense"), ("mlp.wo", "output.dense")):
            names[f"blocks.{i}.{ours}.w"] = (hf + theirs + ".weight", True)
            names[f"blocks.{i}.{ours}.b"] = (hf + theirs + ".bias", False)
        for ours, theirs in (("ln1", "attention.LayerNorm"), ("ln2", "output.LayerNorm")):
            names[f"blocks.{i}.{ours}.scale"] = (hf + theirs + ".weight", False)
            names[f"blocks.{i}.{ours}.bias"] = (hf + theirs + ".bias", False)
    return names


def write_mpnet_dir(encoder, out_dir: str) -> None:
    """``encoder`` as an HF MPNet directory: config.json and one f32
    model.safetensors."""
    state = encoder.state_dict()
    names = mpnet_names(encoder.cfg.n_layers)
    check(sorted(names) == sorted(state), "the smoke's MPNet name map covers the encoder")
    tensors = [(hf, state[ours].T if t else state[ours]) for ours, (hf, t) in names.items()]
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(MPNET_CONFIG, f, indent=2)
    with open(os.path.join(out_dir, "model.safetensors"), "wb") as f:
        f.write(safetensors_header([(name, t.dtype, tuple(t.shape)) for name, t in tensors]))
        for _, t in tensors:
            write_tensor(f, t)


def phase_hf_encoder(torch, drawn, tok, texts):
    """The drawn mpnet_class encoder written as an HF MPNet directory and
    loaded through the CLI's encoder path; returns the imported encoder."""
    from vietnamese_qa_system_tpu_torch.cli.main import _encoder
    from vietnamese_qa_system_tpu_torch.data import batch_encode

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mpnet_") as d:
        write_mpnet_dir(drawn, d)
        size = os.path.getsize(os.path.join(d, "model.safetensors"))
        t0 = time.perf_counter()
        with RssPeak() as rss:
            encoder = _encoder(d, SEED, "cuda")
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    print(f"HF encoder import: mpnet directory ({size / 1e6:.1f} MB f32 safetensors) loaded through the CLI's "
          f"--encoder path in {load_s:.2f} s, process peak RSS while loading {rss.peak / 1e9:.2f} GB", flush=True)
    check(encoder.cfg == drawn.cfg, "the imported encoder's ModelConfig (from config.json) equals mpnet_class()")
    same = all(torch.equal(a, b) for a, b in zip(encoder.state_dict().values(), drawn.state_dict().values()))
    check(same and list(encoder.state_dict()) == list(drawn.state_dict()),
          "imported encoder tensors equal the drawn encoder's, bit for bit")
    with torch.inference_mode():
        ids, mask = batch_encode(tok, texts[:FLASH_B], FLASH_T)
        ids, mask = torch.from_numpy(ids).cuda().long(), torch.from_numpy(mask).cuda().long()
        same = torch.equal(encoder.sentence_embed(ids, mask), drawn.sentence_embed(ids, mask))
    check(same, f"imported encoder's embeddings of {FLASH_B} passages at max_len {FLASH_T} equal the drawn one's, "
                "bit for bit")
    return encoder


def phase_slice(torch, pkg, gen):
    """The retrieval serving path once, end to end, with the launch
    counters reset; returns the launches and what the QA path reuses."""
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer, batch_encode
    from vietnamese_qa_system_tpu_torch.engine import (BM25Index, DocStore, IngestPipeline, Retriever, ServingApp,
                                                       VectorStore)
    from vietnamese_qa_system_tpu_torch.models import init_encoder, mpnet_class
    from vietnamese_qa_system_tpu_torch.ops.cuda_kernels import FLASH_FWD

    cfg = mpnet_class()
    drawn = init_encoder(cfg, make_generator(SEED), device="cuda")
    tok = ByteTokenizer()
    texts = passages(N_PASSAGES, SEED)

    # the flash path (T = 512) on the card against the plain path on the
    # host, same weights, on a few passages
    with torch.inference_mode():
        ids, mask = batch_encode(tok, texts[:4] + [""], 512)
        gpu = drawn.sentence_embed(torch.from_numpy(ids).cuda().long(), torch.from_numpy(mask).cuda().long())
        host = copy.deepcopy(drawn).cpu().sentence_embed(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    cos = (gpu.cpu()[:4] * host[:4]).sum(1)
    print(f"encoder T=512 card vs host plain path: min cos {cos.min().item():.6f}")
    check(bool(torch.isfinite(gpu).all()) and gpu.shape == (5, cfg.d_model),
          "mpnet_class sentence_embed: finite (5, 768) output")
    check(cos.min().item() >= ENCODER_COS_TOL, f"encoder on the card agrees with the plain path: cos >= {ENCODER_COS_TOL}")
    # the rest of the path serves the encoder imported from an HF directory
    encoder = phase_hf_encoder(torch, drawn, tok, texts)
    del drawn

    for kern in pkg.KERNELS:
        kern.launches = 0

    room = 4096  # capacity left for the ingested passages and /ingest
    stores = {dt: VectorStore(N, cfg.d_model, dtype=dt, device="cuda") for dt in ("bf16", "int8", "int8_global", "int8_res")}
    filled = stores["bf16"].capacity - room
    for start in range(0, filled, 1 << 17):
        rows = min(1 << 17, filled - start)
        v = torch.randn(rows, cfg.d_model, generator=gen, device="cuda")
        v = v / v.norm(dim=1, keepdim=True)
        for st in stores.values():
            st.add(v)
    check(all(st.size == filled for st in stores.values()), f"four 1M-capacity stores filled with {filled} unit vectors")

    docstore = DocStore()
    lexical = BM25Index()
    t0 = time.perf_counter()
    ingest = IngestPipeline(encoder, tok, stores["bf16"], docstore, batch_size=FLASH_B, max_len=FLASH_T,
                            lexical=lexical)
    doc_ids = ingest.add_documents(texts, ["synthetic"] * len(texts))
    torch.cuda.synchronize()
    print(f"ingest (with a BM25 index): {len(doc_ids)} chunks at max_len 512 in {time.perf_counter() - t0:.2f} s")
    k4_launches = N_PASSAGES // FLASH_B * cfg.n_layers
    check(len(doc_ids) == N_PASSAGES and FLASH_FWD.launches == k4_launches and lexical.n_docs == N_PASSAGES,
          f"ingest of {N_PASSAGES} passages ran the flash kernel {FLASH_FWD.launches} times ({N_PASSAGES // FLASH_B} "
          f"batches x {cfg.n_layers} layers) and indexed them for BM25")

    retriever = Retriever(encoder, tok, stores["bf16"], docstore, max_len=128, query_batch=32)
    app = ServingApp(retriever, ingest=IngestPipeline(encoder, tok, stores["bf16"], docstore, batch_size=32,
                                                      max_len=128, lexical=lexical), k=5, max_batch=32)
    url, stop = serve(app)
    # queries: passages whose tokens fit max_len 128, so the query and the
    # ingested passage see the same tokens
    short = [i for i, t in enumerate(texts) if len(tok.encode(t)) <= 128]
    try:
        check(len(short) >= 12 + READER_QUESTIONS, f"{len(short)} passages fit the 128-token query length")
        asked = short[:12]
        answers = ask_all(url, "/search", [{"query": texts[i], "k": 5} for i in asked])
        hits = 0
        for i, ans in zip(asked, answers):
            found = [r for r in (ans or {}).get("results", []) if r["id"] == int(doc_ids[i])]
            hits += bool(found) and found[0]["doc"] == texts[i]
        check(hits == len(asked), f"{hits}/{len(asked)} HTTP /search answers return their passage's id and doc in the top-5")
        new = post(f"{url}/ingest", {"texts": ["Bài viết mới về giáo dục ở Việt Nam."], "sources": ["http"]})
        check(new["ids"] == [filled + N_PASSAGES] and new["index_size"] == filled + N_PASSAGES + 1,
              "HTTP /ingest appended one document")
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["ok"] and health["stats"]["search"]["requests"] == len(asked), "HTTP /healthz counts the searches")
    finally:
        stop()

    # the three int8 stores against the plain path (a host twin of each)
    qv = stores["bf16"].get_vectors(list(range(32)))
    queries = torch.from_numpy(qv).cuda() + 0.01 * torch.randn(32, cfg.d_model, generator=gen, device="cuda")
    for dt in ("int8", "int8_global", "int8_res"):
        s, i = stores[dt].topk(queries, K)
        ps, pi = on_cpu(stores[dt]).topk(queries.cpu(), K)
        same_ids = torch.equal(i.cpu(), pi)
        if dt == "int8_res":
            # the re-rank sums in f32 in another order on the host
            ok = same_ids and (s.cpu() - ps).abs().max().item() <= RERANK_SCORE_TOL
        else:
            ok = same_ids and torch.equal(s.cpu(), ps)
        check(ok and bool((i[:, 0].cpu() == torch.arange(32)).all()),
              f"{dt} store top-{K} equals the plain path; each query finds its source vector first")
    # an explicit rerank of MAX_K candidates on the bf16 store (K1's pool form)
    s, i = stores["bf16"].topk(queries, K, rerank=pkg.MAX_K)
    ps, pi = on_cpu(stores["bf16"]).topk(queries.cpu(), K, rerank=pkg.MAX_K)
    check(torch.equal(i.cpu(), pi) and (s.cpu() - ps).abs().max().item() <= RERANK_SCORE_TOL
          and bool((i[:, 0].cpu() == torch.arange(32)).all()),
          f"bf16 store top-{K} after a rerank of {pkg.MAX_K} equals the plain path; each query finds its source first")
    launches = {k.name: k.launches for k in pkg.KERNELS}
    ctx = {"encoder": encoder, "tok": tok, "store": stores["bf16"], "docstore": docstore, "texts": texts,
           "doc_ids": doc_ids, "questions": short[12: 12 + READER_QUESTIONS], "lexical": lexical,
           "res_store": stores["int8_res"]}
    return launches, ctx


def plain_candidates(torch, T, store, qvecs, m: int):
    """The store's top-m (scores, ids) of ``qvecs`` through the plain
    versions on the card: K1's over a bf16 store; over int8_res, K2's at
    the store's 4m scan candidates, then the store's exact re-score with
    the residual."""
    import numpy as np

    q = torch.as_tensor(np.asarray(qvecs), device="cuda").float()
    slab = store.slabs[0]
    if store.dtype == "bf16":
        s, i = T.topk_bf16_plain(q.to(torch.bfloat16), slab.vectors, store.size, m)
    else:
        q_i8, _ = T.quantize_queries(q)
        _, slots = T.topk_int8_plain(q_i8, slab.vectors, slab.scales, store.size, min(4 * m, T.MAX_K))
        slots = slots.long()
        rs = (torch.einsum("bd,bkd->bk", q, slab.vectors[slots].float()) * slab.scales[slots]
              + torch.einsum("bd,bkd->bk", q, slab.res_vectors[slots].float()) * slab.res_scales[slots])
        s, pos = torch.sort(rs, dim=1, descending=True, stable=True)
        s, i = s[:, :m], torch.gather(slots, 1, pos[:, :m])
    return s.cpu().numpy(), i.cpu().numpy()


def host_fused(store, python_bm25, query: str, qvec, dense_s, dense_i, k: int) -> list:
    """The fused top-k recomputed on the host: ``fuse_scores`` over the
    given dense candidates and the Python scorer's BM25 candidates, exact
    dense scores of the BM25-only ones from the stored rows."""
    from vietnamese_qa_system_tpu_torch.engine import fuse_scores

    dense = {int(g): max(float(sc), 0.0) for g, sc in zip(dense_i, dense_s) if g >= 0}
    sparse = dict(python_bm25.search(query, k=len(dense_s)))
    fused = fuse_scores(dense, sparse, HYBRID_WEIGHT)
    missing = [g for g in sparse if g not in dense]
    if missing:
        for g, sc in zip(missing, store.get_vectors(missing) @ qvec):
            fused[g] = HYBRID_WEIGHT * max(float(sc), 0.0) + (1 - HYBRID_WEIGHT) * sparse[g]
    return sorted(fused.items(), key=lambda kv: -kv[1])[:k]


def same_ranking(ids: list, scores: list, want_ids: list, want_scores: list, tol: float) -> bool:
    """Scores equal within ``tol`` position by position; ids equal except
    where a score within ``tol`` of theirs makes the order a tie (sums in
    another order, equal scores kept in another order)."""
    if len(ids) != len(want_ids) or any(abs(a - b) > tol for a, b in zip(scores, want_scores)):
        return False
    for j, (a, b) in enumerate(zip(ids, want_ids)):
        if a != b:
            tied = [i for i, sc in enumerate(want_scores) if abs(sc - want_scores[j]) <= tol]
            if b not in [ids[i] for i in tied] and abs(want_scores[j] - want_scores[-1]) > tol:
                return False
    return True


def percentile(values: list, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


def timed_search(url: str, payloads: list) -> list:
    """Each request's wall ms, all sent at once."""
    out = [0.0] * len(payloads)

    def ask(j):
        t0 = time.perf_counter()
        post(url + "/search", payloads[j])
        out[j] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=ask, args=(j,)) for j in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return out


def phase_bm25_timing(torch) -> dict:
    """BM25 ms per query, native scorer against the Python loop, over an
    index of BM25_PASSAGES synthetic passages."""
    from vietnamese_qa_system_tpu_torch.engine import BM25Index

    big = passages(BM25_PASSAGES, SEED + 7)
    idx = BM25Index()
    t0 = time.perf_counter()
    idx.add(list(range(len(big))), big)
    add_s = time.perf_counter() - t0
    import numpy as np

    rng = np.random.default_rng(SEED)
    queries = [" ".join(big[j].split()[2:7]) for j in rng.choice(len(big), BM25_TIMED_QUERIES, replace=False)]
    t0 = time.perf_counter()
    idx.scores(queries[0])  # freezes the posting arrays
    freeze_s = time.perf_counter() - t0
    python = copy.copy(idx)
    python.native, python.scored = False, {"native": 0, "python": 0}
    times = {}
    for name, index in (("native", idx), ("python", python)):
        ms = []
        for q in queries:
            t0 = time.perf_counter()
            index.scores(q)
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = sorted(ms)[len(ms) // 2]
    a, b = idx.scores(queries[1]), python.scores(queries[1])
    check(set(a) == set(b) and all(abs(a[g] - b[g]) <= 1e-9 * abs(b[g]) for g in b),
          f"native BM25 scores equal the Python loop's within rtol 1e-9 at {len(big)} passages")
    postings = sum(len(p) for p in idx.postings.values())
    with open("/proc/cpuinfo") as f:
        cpu = next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")), "not given")
    print(f"BM25 over {len(big)} passages ({postings} postings; add {add_s:.2f} s, freeze {freeze_s:.2f} s; host CPU "
          f"model name {cpu!r} in /proc/cpuinfo, {os.cpu_count()} cores): median ms per query over {len(queries)} queries: native "
          f"{times['native']:.3f}, Python {times['python']:.3f}", flush=True)
    return times


def phase_hybrid(torch, pkg, ctx):
    """Hybrid BM25 + dense retrieval served over HTTP at weight 0.5, over
    the bf16 store and the int8_res store (the ingested passages written
    into it through the ingest's write half), with the launch counters
    reset; returns the launches."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.engine import BM25Index, DocStore, IngestPipeline, Retriever, ServingApp
    from vietnamese_qa_system_tpu_torch.engine import lexical as L
    from vietnamese_qa_system_tpu_torch.ops import topk as T

    lib = L.native_bm25()
    check(lib is not None and os.path.exists(L.bm25_lib_path()) and L.bm25_lib_path().startswith(
        os.path.join(L.CSRC, "build")), f"native BM25 scorer built by g++ from csrc/bm25.cpp: {L.bm25_lib_path()}")
    encoder, tok, texts, doc_ids = ctx["encoder"], ctx["tok"], ctx["texts"], ctx["doc_ids"]
    for kern in pkg.KERNELS:
        kern.launches = 0
    res_lexical = BM25Index()
    res_ingest = IngestPipeline(encoder, tok, ctx["res_store"], DocStore(), batch_size=32, max_len=128,
                                lexical=res_lexical)
    ids = res_ingest.index_vectors(ctx["store"].get_vectors(doc_ids), texts, ["synthetic"] * len(texts))
    check(ids.tolist() == doc_ids.tolist() and res_lexical.n_docs == len(texts),
          f"int8_res store and its BM25 index took the {len(texts)} passages under the same ids")
    rng = np.random.default_rng(SEED + 3)
    picks = rng.choice(len(texts), HYBRID_QUERIES, replace=False)
    # keyword queries: a passage's number (a term no other passage holds) and a few of its words
    queries = [" ".join(texts[i].split()[2:7]) for i in picks]
    for name, store, lexical, docstore, ingest in (
            ("bf16", ctx["store"], ctx["lexical"], ctx["docstore"], None), ("int8_res", ctx["res_store"], res_lexical,
                                                                              res_ingest.docstore, res_ingest)):
        retriever = Retriever(encoder, tok, store, docstore, max_len=128, query_batch=32, lexical=lexical,
                              hybrid_weight=HYBRID_WEIGHT)
        served_dense, pending = {}, []
        dense_of, hybrid_of = retriever._dense_candidates, retriever._hybrid_search

        def dense(qvecs, m, dense_of=dense_of, pending=pending):
            out = dense_of(qvecs, m)
            pending.append(out)
            return out

        def hybrid(qs, qvecs, k, fetch_docs, hybrid_of=hybrid_of, pending=pending, served_dense=served_dense):
            out = hybrid_of(qs, qvecs, k, fetch_docs)
            ds, di = pending.pop()
            for r, q in enumerate(qs):
                served_dense[q] = (qvecs[r], ds[r], di[r])
            return out

        retriever._dense_candidates, retriever._hybrid_search = dense, hybrid
        ingest = ingest or IngestPipeline(encoder, tok, store, docstore, batch_size=32, max_len=128, lexical=lexical)
        app = ServingApp(retriever, ingest=ingest, k=HYBRID_K, max_batch=32)
        native_before = lexical.scored["native"]
        url, stop = serve(app)
        try:
            answers = ask_all(url, "/search", [{"query": q, "k": HYBRID_K} for q in queries])
            # the served dense candidates against the plain versions on the same query vectors
            qv = np.stack([served_dense[q][0] for q in queries])
            m = len(served_dense[queries[0]][1])
            ps, pi = plain_candidates(torch, T, store, qv, m)
            tol = K1_SCORE_TOL if name == "bf16" else RERANK_SCORE_TOL
            err = max(float(np.abs(served_dense[q][1] - ps[r]).max()) for r, q in enumerate(queries))
            ranked = [len(set(served_dense[q][2].tolist())) == m and same_ranking(
                served_dense[q][2].tolist(), served_dense[q][1].tolist(), pi[r].tolist(), ps[r].tolist(), tol)
                for r, q in enumerate(queries)]
            same = sum(int((served_dense[q][2] == pi[r]).sum()) for r, q in enumerate(queries))
            rec = 1.0
            if name == "bf16":  # each served id a true top-m member by the plain f32 scores
                rec = rank_recall(torch.as_tensor(qv, device="cuda").to(torch.bfloat16), store.slabs[0].vectors[:store.size],
                                  torch.as_tensor(np.stack([served_dense[q][2] for q in queries]), device="cuda"), m)
            print(f"hybrid dense candidates ({name} store, m {m}): scores within {err:.2e} of the plain version's, "
                  f"ids equal at {same}/{m * len(queries)} positions, recall by rank count {rec:.3f}", flush=True)
            check(all(ranked) and rec == 1.0,
                  f"{sum(ranked)}/{len(queries)} hybrid queries' dense candidates ({name} store, m {m}) equal the "
                  f"plain version's: scores within {tol}, ids equal except within a tie of {tol}, no id twice"
                  + (", recall 1.000 by the rank-count rule" if name == "bf16" else ""))
            python = copy.copy(lexical)
            python.native, python.scored = False, {"native": 0, "python": 0}
            # fused over the plain candidates: scores differ by the weight times the candidates' difference
            fused_tol = HYBRID_TOL + HYBRID_WEIGHT * err
            good = [a is not None and same_ranking(
                [x["id"] for x in a["results"]], [x["score"] for x in a["results"]],
                *zip(*host_fused(store, python, q, qv[r], ps[r], pi[r], HYBRID_K)), fused_tol)
                for r, (q, a) in enumerate(zip(queries, answers))]
            check(all(good), f"{sum(good)}/{len(queries)} concurrent hybrid /search answers ({name} store, k "
                             f"{HYBRID_K}, weight {HYBRID_WEIGHT}) equal the host recomputation (fuse_scores over the "
                             f"plain candidates and the Python scorer's BM25) within {fused_tol:.2e}")
            native = lexical.scored["native"] - native_before
            check(native >= len(queries) and lexical.scored["python"] == 0,
                  f"the native scorer answered the hybrid queries ({native} native, 0 Python)")
            hits = sum(int(doc_ids[i]) in [r["id"] for r in a["results"]] for i, a in zip(picks, answers))
            check(hits == len(queries), f"hybrid /search over the {name} store: {hits}/{len(queries)} keyword queries "
                                        f"find their passage in the top {HYBRID_K}")
            if name == "bf16":
                new = post(f"{url}/ingest", {"texts": ["Bài viết mới về zirconium và quasar ở Hà Nội."]})
                top = post(f"{url}/search", {"query": "zirconium quasar", "k": 3})["results"]
                check(top[0]["id"] == new["ids"][0] and "zirconium" in top[0]["doc"],
                      "after /ingest a keyword-only hybrid query finds the new passage first")
                lat = {}
                for label, weight in (("hybrid", HYBRID_WEIGHT), ("dense-only", 1.0)):
                    retriever.hybrid_weight = weight
                    found = ask_all(url, "/search", [{"query": q, "k": HYBRID_K} for q in queries])
                    hits = sum(int(doc_ids[i]) in [r["id"] for r in a["results"]] for i, a in zip(picks, found))
                    print(f"{label} /search: {hits}/{len(queries)} keyword queries find their passage in the top "
                          f"{HYBRID_K}", flush=True)
                    timed_search(url, [{"query": q, "k": HYBRID_K} for q in queries])  # warm
                    ms = [t for _ in range(LATENCY_ROUNDS)
                          for t in timed_search(url, [{"query": q, "k": HYBRID_K} for q in queries])]
                    lat[label] = (percentile(ms, 0.5), percentile(ms, 0.99))
                print(f"/search latency, {HYBRID_QUERIES} concurrent, {LATENCY_ROUNDS} rounds, k {HYBRID_K}, bf16 "
                      f"store of {store.size} rows: hybrid p50 {lat['hybrid'][0]:.2f} ms p99 {lat['hybrid'][1]:.2f} "
                      f"ms; dense-only p50 {lat['dense-only'][0]:.2f} ms p99 {lat['dense-only'][1]:.2f} ms", flush=True)
        finally:
            stop()
        if name == "bf16":
            check(app.dirty, "the /ingest left the app dirty")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_bm25_") as d:
                path = os.path.join(d, "bm25.json")
                lexical.save(path)  # serve's shutdown save
                back = BM25Index.load(path)
            check(back.n_docs == lexical.n_docs and all(back.scores(q) == lexical.scores(q) for q in queries),
                  f"the shutdown save wrote bm25.json ({back.n_docs} docs); it reloads to the same scores")
    return {k.name: k.launches for k in pkg.KERNELS}


def phogpt_config(cfg) -> dict:
    """vinai/PhoGPT-4B's MosaicML config.json layout at ``cfg``'s sizes:
    nested attn_config, no tie_word_embeddings key (MPT ties its head)."""
    return {
        "architectures": ["MPTForCausalLM"], "model_type": "mpt", "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "n_layers": cfg.n_layers, "expansion_ratio": cfg.d_ff // cfg.d_model, "max_seq_len": cfg.max_seq_len,
        "vocab_size": cfg.vocab_size, "no_bias": True, "norm_type": "low_precision_layernorm", "learned_pos_emb": True,
        "logit_scale": None, "emb_pdrop": 0.0, "resid_pdrop": 0.0, "embedding_fraction": 1.0, "init_device": "cpu",
        "torch_dtype": "bfloat16", "use_cache": False, "verbose": 0, "ffn_config": {"ffn_type": "mptmlp"},
        "attn_config": {"alibi": True, "alibi_bias_max": 8, "attn_impl": "flash", "attn_pdrop": 0.0,
                        "attn_type": "multihead_attention", "attn_uses_sequence_id": False, "clip_qkv": None,
                        "prefix_lm": False, "qk_ln": False, "softmax_scale": None},
    }


def mpt_layer_shapes(cfg, i: int) -> list:
    """(HF MPT name, shape) of layer i's tensors, in file order."""
    d, f = cfg.d_model, cfg.d_ff
    pre = f"transformer.blocks.{i}."
    return [(pre + "norm_1.weight", (d,)), (pre + "attn.Wqkv.weight", (3 * d, d)), (pre + "attn.out_proj.weight", (d, d)),
            (pre + "norm_2.weight", (d,)), (pre + "ffn.up_proj.weight", (f, d)), (pre + "ffn.down_proj.weight", (d, f))]


def draw_mpt_layer(torch, cfg, i: int, gen) -> dict:
    """Layer i in the HF MPT layout, drawn on the card and rounded to bf16:
    dense weights U(-1/sqrt(d_in), 1/sqrt(d_in)), norm scales 1 + N(0, 0.1^2)."""
    out = {}
    for name, shape in mpt_layer_shapes(cfg, i):
        if len(shape) == 1:
            t = 1.0 + 0.1 * torch.randn(shape, generator=gen, device="cuda")
        else:
            t = (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) / shape[1] ** 0.5
        out[name] = t.to(torch.bfloat16)
    return out


def mpt_to_port(torch, hf: dict, cfg, i: int, quantize="int8c") -> dict:
    """Layer i's HF MPT tensors -> the port's names, f32, dense weights
    quantized by models/quantize.py in mode ``quantize`` (None: kept f32)
    (the smoke's own map: Wqkv rows are q, k, v in turn; Linear weights
    are (out, in); MPT norms have no bias)."""
    from vietnamese_qa_system_tpu_torch.models import quantize_weight

    d, pre = cfg.d_model, f"transformer.blocks.{i}."
    wqkv = hf[pre + "attn.Wqkv.weight"].float()
    dense = {"attn.wq": wqkv[:d].T, "attn.wk": wqkv[d:2 * d].T, "attn.wv": wqkv[2 * d:].T,
             "attn.wo": hf[pre + "attn.out_proj.weight"].float().T, "mlp.wi": hf[pre + "ffn.up_proj.weight"].float().T,
             "mlp.wo": hf[pre + "ffn.down_proj.weight"].float().T}
    out = {}
    for name, w in dense.items():
        leaf = {"w": w.contiguous()} if quantize is None else quantize_weight(w, quantize)
        out.update({f"blocks.{i}.{name}.{key}": t for key, t in leaf.items()})
    for ours, theirs in (("ln1", "norm_1"), ("ln2", "norm_2")):
        out[f"blocks.{i}.{ours}.scale"] = hf[pre + theirs + ".weight"].float()
        out[f"blocks.{i}.{ours}.bias"] = torch.zeros(d, device="cuda")
    return out


def write_phogpt_dir(torch, cfg, out_dir: str, gen, quantize="int8c"):
    """A PhoGPT-4B-size MPT directory of drawn weights (MosaicML config.json,
    sharded bf16 safetensors behind model.safetensors.index.json, tied
    head: no lm_head.weight), written layer by layer; returns the
    reference reader built from the same bf16 values, in mode ``quantize``
    (None: the float reader)."""
    from vietnamese_qa_system_tpu_torch.models import causal_from_state_dict

    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(phogpt_config(cfg), f, indent=2)
    n_shards = -(-cfg.n_layers // PHOGPT_LAYERS_PER_SHARD)
    weight_map, ref, total = {}, {}, 0
    for shard in range(n_shards):
        file = f"model-{shard + 1:05d}-of-{n_shards:05d}.safetensors"
        layers = range(shard * PHOGPT_LAYERS_PER_SHARD, min((shard + 1) * PHOGPT_LAYERS_PER_SHARD, cfg.n_layers))
        entries = [(n, sh) for i in layers for n, sh in mpt_layer_shapes(cfg, i)]
        if shard == 0:
            entries = [("transformer.wte.weight", (cfg.vocab_size, cfg.d_model)),
                       ("transformer.norm_f.weight", (cfg.d_model,))] + entries
        with open(os.path.join(out_dir, file), "wb") as f:
            f.write(safetensors_header([(n, torch.bfloat16, sh) for n, sh in entries]))
            if shard == 0:
                wte = (0.02 * torch.randn(cfg.vocab_size, cfg.d_model, generator=gen, device="cuda")).to(torch.bfloat16)
                norm_f = (1.0 + 0.1 * torch.randn(cfg.d_model, generator=gen, device="cuda")).to(torch.bfloat16)
                for t in (wte, norm_f):
                    write_tensor(f, t)
                ref.update({"tok_embed": wte.float(), "ln_f.scale": norm_f.float(),
                            "ln_f.bias": torch.zeros(cfg.d_model, device="cuda")})
            for i in layers:
                hf = draw_mpt_layer(torch, cfg, i, gen)
                for name, _ in mpt_layer_shapes(cfg, i):
                    write_tensor(f, hf[name])
                ref.update(mpt_to_port(torch, hf, cfg, i, quantize))
        weight_map.update({n: file for n, _ in entries})
        total += os.path.getsize(os.path.join(out_dir, file))
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return causal_from_state_dict(ref, cfg), total, n_shards


def phase_hf_reader(torch, tok):
    """A PhoGPT-4B-size MPT directory of drawn bf16 weights, loaded through
    ``serve --reader-params DIR --reader-size phogpt4b --reader-quantize
    int8c``; returns the imported reader and the reference reader built
    from the same bf16 values."""
    from vietnamese_qa_system_tpu_torch.cli.main import _reader, build_parser
    from vietnamese_qa_system_tpu_torch.models import phogpt_4b_class

    cfg = phogpt_4b_class()
    d = tempfile.mkdtemp(prefix="chip_smoke_phogpt_")
    try:
        free = shutil.disk_usage(d).free
        t0 = time.perf_counter()
        reference, total, n_shards = write_phogpt_dir(torch, cfg, d, torch.Generator(device="cuda").manual_seed(SEED + 1))
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
        args = build_parser().parse_args(["serve", "--index", d, "--db", ":memory:", "--reader-size", "phogpt4b",
                                          "--reader-params", d, "--reader-quantize", "int8c"])
        before = rss_bytes()
        t0 = time.perf_counter()
        with RssPeak() as rss:
            reader = _reader(args.reader_size, tok, args.seed + 1, "cuda", args.reader_quantize, args.reader_params)
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n_params = sum(math.prod(sh) for i in range(cfg.n_layers) for _, sh in mpt_layer_shapes(cfg, i)) + \
        cfg.vocab_size * cfg.d_model + cfg.d_model
    f32_bytes = 4 * n_params
    n_bytes = sum(t.numel() * t.element_size() for t in reader.state_dict().values())
    print(f"HF reader import: PhoGPT-4B-size MPT directory ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
          f"heads, vocab {cfg.vocab_size}; {n_params / 1e9:.3f}B parameters) written as {n_shards} bf16 safetensors "
          f"shards ({total / 1e9:.2f} GB; {free / 1e9:.0f} GB free) in {write_s:.1f} s; loaded through serve "
          f"--reader-params --reader-size phogpt4b --reader-quantize int8c in {load_s:.1f} s ({n_bytes / 1e9:.2f} GB "
          f"on the card); process RSS {before / 1e9:.2f} GB before, peak {rss.peak / 1e9:.2f} GB while loading (the "
          f"f32 model: {f32_bytes / 1e9:.2f} GB)", flush=True)
    check(rss.peak < f32_bytes, f"peak RSS while loading {rss.peak / 1e9:.2f} GB < the f32 model's {f32_bytes / 1e9:.2f} GB")
    got, want = reader.state_dict(), reference.state_dict()
    same = list(got) == list(want) and all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
    check(same, "imported int8c codes and scales (and every other tensor) equal quantizing the same bf16 values with "
                "models/quantize.py, bit for bit")
    return reader, reference


def phase_reader(torch, pkg, ctx):
    """The QA serving path once at PhoGPT-4B width over a reader imported
    from an HF directory (int8c), with the launch counters reset; returns
    its launches and the reader."""
    from vietnamese_qa_system_tpu_torch.data import batch_encode
    from vietnamese_qa_system_tpu_torch.engine import QAPipeline, Retriever, ServingApp
    from vietnamese_qa_system_tpu_torch.models import generate as G

    tok, texts = ctx["tok"], ctx["texts"]
    reader, reference = phase_hf_reader(torch, tok)
    cfg = reader.cfg
    retriever = Retriever(ctx["encoder"], tok, ctx["store"], ctx["docstore"], max_len=128, query_batch=16)
    qa = QAPipeline(retriever, reader, tok, k=3, max_prompt_len=READER_PROMPT_LEN, max_new_tokens=READER_NEW_TOKENS)
    # one batch of every question, so the reference answers the same batch
    batches = []
    retrieve = qa.retrieve
    qa.retrieve = lambda qs: batches.append(list(qs)) or retrieve(qs)
    app = ServingApp(retriever, qa, k=3, max_batch=16, max_wait_s=2.0)
    url, stop = serve(app)
    questions = [texts[i] for i in ctx["questions"]]
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        t0 = time.perf_counter()
        answers = ask_all(url, "/qa", [{"question": q} for q in questions])
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in pkg.KERNELS}
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            stats = json.loads(resp.read())["stats"]["qa"]
    finally:
        stop()
    print(f"/qa: {len(questions)} concurrent questions answered in {wall:.2f} s over {stats['batches']} batch(es); "
          f"launches {json.dumps(launches)}", flush=True)
    good = [a is not None and not a["refused"] and a["contexts"][:1] == [q] and isinstance(a["answer"], str)
            for q, a in zip(questions, answers)]
    check(all(good), f"{sum(good)}/{len(questions)} HTTP /qa answers (200) carry their own passage as contexts[0]")
    per_call = 6 * cfg.n_layers * READER_NEW_TOKENS
    check(stats["requests"] == len(questions) and launches["w8_matmul"] == per_call * stats["batches"],
          f"K6 launched {per_call} times (6 x {cfg.n_layers} layers x {READER_NEW_TOKENS} steps) per generate call, "
          f"{stats['batches']} call(s); the prefill ({READER_PROMPT_LEN}-token rows) took the dequantize route")
    # the reference reader (the same bf16 values quantized by the smoke)
    # answers the served batch, in the served order
    check(len(batches) == 1, f"the {len(questions)} concurrent /qa requests were served as one batch ({len(batches)})")
    ref_qa = QAPipeline(retriever, reference, tok, k=3, max_prompt_len=READER_PROMPT_LEN,
                        max_new_tokens=READER_NEW_TOKENS)
    ref = {q: a.answer for q, a in zip(batches[0], ref_qa.answer(batches[0]))}
    same = [a["answer"] == ref[q] for q, a in zip(questions, answers)]
    check(all(same), f"{sum(same)}/{len(questions)} /qa answers of the imported reader equal the reference reader's")

    # prefill seconds and decode tokens/s of the same prompts in one batch
    prompts, _ = qa.retrieve(questions)
    ids, mask = batch_encode(tok, prompts, READER_PROMPT_LEN, pad_side="left")
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    out = G.generate(reader, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda(),
                     max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id, timings=timings)
    tps = len(prompts) * READER_NEW_TOKENS / timings["decode_s"]
    print(f"reader B={len(prompts)} T={READER_PROMPT_LEN}: prefill {timings['prefill_s']:.3f} s, decode "
          f"{READER_NEW_TOKENS} steps in {timings['decode_s']:.3f} s = {tps:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB (the reference reader held as well)", flush=True)
    ref_out = G.generate(reference, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda(),
                         max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id)
    check(torch.equal(out, ref_out), f"greedy tokens of the imported reader equal the reference reader's "
                                     f"({len(prompts)} prompts x {READER_NEW_TOKENS} new tokens)")
    del reference, ref_qa
    trace_decode(torch, reader, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda(), tok.eos_id,
                 timings["decode_s"] / READER_NEW_TOKENS)
    return launches, reader


def trace_decode(torch, reader, ids, mask, eos_id, step_s):
    """Where a decode step's time goes: a trace of one generate call's
    decode loop (its ``generate.decode`` span, TRACE_STEPS steps)."""
    from vietnamese_qa_system_tpu_torch.models import generate as G

    trace_span(torch, f"decode trace ({TRACE_STEPS} steps, B={ids.shape[0]}, torch.profiler)", "generate.decode",
               TRACE_STEPS, step_s,
               lambda: G.generate(reader, ids, mask, max_new_tokens=TRACE_STEPS, eos_id=eos_id, timings={}))


def trace_span(torch, label: str, span: str, n: int, step_s: float, run) -> dict | None:
    """Where a step's time goes: a torch.profiler trace of ``run``, whose
    ``span`` (a record_function region) holds ``n`` steps, gives the
    device's busy time a step (the union of its kernels), that time by the
    aten call that launched each kernel (or by the hand-written kernel's
    name: those launch through ctypes, inside no aten call), and the host's
    operator calls, kernel launches and synchronisations a step (with their
    callers).  The idle share compares the busy time with ``step_s``, the
    wall time of a step of an untraced run (the profiler slows the host).
    Returns the busy ms a step, the idle share, the host's top-level aten
    calls a step and synchronisations in the span, and the device ms a step
    by caller, None where the trace did not measure them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.events()
    # the host's span (kineto adds a device-side twin of the same name)
    found = [e for e in events if e.name == span and e.device_type == DeviceType.CPU]
    if len(found) != 1:
        print(f"{label}: {len(found)} {span} spans recorded; breakdown not measured", flush=True)
        return
    t0, t1 = found[0].time_range.start, found[0].time_range.end
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA and e.time_range.start >= t0
                      and e.name != span),
                     key=lambda e: e.time_range.start)
    if not kernels:
        print(f"{label}: the profiler recorded no device kernels; device time a step not measured", flush=True)
        return
    # each kernel's device time goes to the outermost aten call that launched
    # it: a device event shares its id with the runtime call (cudaLaunchKernel,
    # cudaMemcpyAsync) whose host parent is the innermost aten call
    runtime = {e.id: e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cu")}

    def outer_aten(op) -> str:
        while op is not None and op.cpu_parent is not None and op.cpu_parent.name.startswith("aten::"):
            op = op.cpu_parent
        return op.name if op is not None and op.name.startswith("aten::") else "(no aten call)"

    def caller(kernel) -> str:
        launch = runtime.get(kernel.id)
        key = outer_aten(None if launch is None else launch.cpu_parent)
        if key != "(no aten call)":
            return key
        short = kernel.name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
        return f"hand-written {short}"

    busy, reach, by_caller = 0.0, t0, {}
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        key = caller(e)
        by_caller[key] = by_caller.get(key, 0.0) + (end - start)
    host = [e for e in events if e.device_type != DeviceType.CUDA and t0 <= e.time_range.start <= t1]
    ops = sum(1 for e in host if e.name.startswith("aten::")
              and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    sync_callers = {}
    for e in host:
        if "Synchronize" in e.name:
            key = f"{e.name} in {outer_aten(e.cpu_parent)}"
            sync_callers[key] = sync_callers.get(key, 0) + 1
    syncs = sum(sync_callers.values())
    launch_calls = sum(1 for e in host if "LaunchKernel" in e.name)
    busy_ms, step_ms = busy / 1e3 / n, step_s * 1e3
    print(f"{label}: device busy {busy_ms:.3f} ms a step ({len(kernels) / n:.0f} kernels); traced wall "
          f"{(reach - t0) / 1e3 / n:.3f} ms a step; untraced wall {step_ms:.3f} ms a step -> device idle share "
          f"{1 - busy_ms / step_ms:.3f}; host a step: {ops / n:.0f} top-level aten calls, {launch_calls / n:.0f} "
          f"kernel-launch API calls, {syncs / n:.1f} synchronize calls", flush=True)
    for key, us in sorted(by_caller.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  device a step, kernels of {key}: {us / 1e3 / n:.3f} ms", flush=True)
    for key, count in sorted(sync_callers.items(), key=lambda kv: -kv[1]):
        print(f"  host a step, {key}: {count / n:.1f}", flush=True)
    return {"busy_ms": round(busy_ms, 3), "idle": round(1 - busy_ms / step_ms, 3), "ops": round(ops / n),
            "syncs": syncs, "ms_by_caller": {key: us / 1e3 / n for key, us in by_caller.items()}}


def device_busy_ms(torch, run) -> float:
    """The device's busy ms over ``run``: the union of its kernels' time
    ranges in a torch.profiler trace of the device alone.  Without the
    host's operators a QLoRA step (~90,000 aten calls) traces in seconds,
    where ``trace_span``'s attribution takes tens of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                             if e.device_type == DeviceType.CUDA):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy / 1e3


def phase_twin(torch, reader):
    """Two layers of the reader's weights, full width: greedy decode on the
    card (through K6) against the host plain path."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.models import causal_from_state_dict
    from vietnamese_qa_system_tpu_torch.models import generate as G

    cfg = dataclasses.replace(reader.cfg, n_layers=TWIN_LAYERS, use_flash_attention=False)
    state = {k: v for k, v in reader.state_dict().items()
             if not k.startswith("blocks.") or int(k.split(".")[1]) < TWIN_LAYERS}
    card = causal_from_state_dict(state, cfg)
    host = causal_from_state_dict({k: v.cpu() for k, v in state.items()}, cfg)
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(4, 260, (TWIN_ROWS, TWIN_PROMPT_LEN)).astype(np.int32))
    mask = torch.ones_like(ids)
    mask[1::2, :8] = 0
    ids = ids * mask
    out_card = G.generate(card, ids.cuda(), mask.cuda(), max_new_tokens=TWIN_NEW_TOKENS).cpu()
    out_host = G.generate(host, ids, mask, max_new_tokens=TWIN_NEW_TOKENS)
    # logits that chose each token, teacher-forced on the card's stream
    full = torch.cat([mask, torch.ones((TWIN_ROWS, TWIN_NEW_TOKENS - 1), dtype=mask.dtype)], dim=1)
    pos = (torch.cumsum(full, 1) - 1).clamp_min(0)
    seq = out_card[:, :-1].long()
    with torch.inference_mode():
        lc = card(seq.cuda(), full.cuda(), positions=pos.cuda()).cpu()[:, TWIN_PROMPT_LEN - 1:]
        lh = host(seq, full, positions=pos)[:, TWIN_PROMPT_LEN - 1:]
    err = (lc - lh).abs().max().item()
    top2 = torch.topk(lh, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = True
    first_tie = []
    for r in range(TWIN_ROWS):
        ties = torch.nonzero(margin[r] < TWIN_LOGIT_TOL).flatten()
        until = int(ties[0]) if len(ties) else TWIN_NEW_TOKENS
        first_tie.append(until)
        agree &= torch.equal(out_card[r, TWIN_PROMPT_LEN: TWIN_PROMPT_LEN + until],
                             out_host[r, TWIN_PROMPT_LEN: TWIN_PROMPT_LEN + until])
    print(f"twin ({TWIN_LAYERS} layers, full width): logits max abs err {err:.3e} over {TWIN_NEW_TOKENS} steps, "
          f"smallest top-2 margin {margin.min().item():.3e}, tokens compared up to steps {first_tie}", flush=True)
    check(err <= TWIN_LOGIT_TOL, f"twin greedy logits on the card agree with the host plain path within {TWIN_LOGIT_TOL}")
    check(agree, "twin greedy tokens agree with the host until the first top-2 margin below the tolerance")


def engine_text(rng, n: int) -> str:
    """n bytes of lower-case ASCII words: n tokens of the byte tokenizer."""
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz     "), n))


def bucket_of(buckets, n: int) -> int:
    return min(b for b in buckets if b >= n)


def greedy_reference(torch, reader, ids: list, width: int, n_new: int, eos_id, kv_dtype="bf16") -> list:
    """A B=1 greedy ``generate()`` of ``ids`` left-padded to ``width``, its
    first ``n_new`` tokens, cut after the first eos."""
    from vietnamese_qa_system_tpu_torch.models import generate as G

    x = torch.zeros((1, width), dtype=torch.int32)
    m = torch.zeros((1, width), dtype=torch.int32)
    x[0, width - len(ids):] = torch.tensor(ids, dtype=torch.int32)
    m[0, width - len(ids):] = 1
    out = G.generate(reader, x.cuda(), m.cuda(), max_new_tokens=n_new, eos_id=eos_id, kv_dtype=kv_dtype)
    out = out[0, width:].tolist()
    return out[: out.index(eos_id) + 1] if eos_id in out else out


# eager B=1 generate() runs each label's first calls beside the graph
# replay, which must give the same tokens
GRAPH_REF_CHECKS = 2
_graph_checks: dict = {}


@contextlib.contextmanager
def device_alibi_slopes(L):
    """``layers.alibi_slopes`` answered from a device copy made once a
    configuration: its host tensor's copy to the card is the one host
    transfer of a decode step, which a CUDA graph cannot capture."""
    real = L.alibi_slopes
    memo = {}

    def slopes(n_heads, mode="bloom", bias_max=8.0, device=None):
        key = (n_heads, mode, bias_max, str(device))
        if key not in memo:
            memo[key] = real(n_heads, mode, bias_max, device)
        return memo[key]

    L.alibi_slopes = slopes
    try:
        yield
    finally:
        L.alibi_slopes = real


def graph_greedy_reference(torch, reader, ids: list, width: int, n_new: int, eos_id, kv_dtype="bf16",
                           label: str = "") -> list:
    """:func:`greedy_reference` with its decode steps replayed from one CUDA
    graph: the prefill and the first step run eagerly, as ``generate()``
    runs them, then the step -- argmax, the eos fill, the cache write, the
    next logits -- is captured once and replayed; the cache cursor, the
    position and the mask's last key advance in device buffers that the
    graph reads (a cursor tensor writes the slot ``generate()``'s integer
    index writes).  The same operators on the same values as
    ``generate()``; each ``label``'s first GRAPH_REF_CHECKS calls also run
    the eager reference and fail unless the tokens are equal."""
    from vietnamese_qa_system_tpu_torch.models import generate as G
    from vietnamese_qa_system_tpu_torch.models import layers as L

    x = torch.zeros((1, width), dtype=torch.int32)
    m = torch.zeros((1, width), dtype=torch.int32)
    x[0, width - len(ids):] = torch.tensor(ids, dtype=torch.int32)
    m[0, width - len(ids):] = 1
    x, m = x.cuda(), m.cuda()
    total = width + n_new
    with torch.inference_mode(), device_alibi_slopes(L):
        cache, last, key_valid, n_prompt = G._prefill(reader, x, m, total, kv_dtype)
        j = torch.arange(total, device="cuda")[None, None, :]
        slot = torch.full((1,), width, dtype=torch.long, device="cuda")
        pos = n_prompt.long()[:, None].clone()
        done = torch.zeros((1,), dtype=torch.bool, device="cuda")
        out = torch.zeros((1, n_new), dtype=torch.int32, device="cuda")
        eos = torch.full((), eos_id, dtype=torch.int32, device="cuda")

        def step():
            tok = torch.where(done, eos, torch.argmax(last.float(), dim=-1).to(torch.int32))
            done.copy_(done | (tok == eos))
            out.index_copy_(1, slot - width, tok[:, None])
            step_mask = key_valid[:, None, :] | ((j >= width) & (j <= slot[:, None, None]))
            h = reader.hidden_states(tok[:, None].long(), step_mask, positions=pos, cache=cache, cache_index=slot)
            last.copy_(reader.head(h[:, 0]))
            slot.add_(1)
            pos.add_(1)

        step()
        if n_new > 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            for _ in range(n_new - 1):
                graph.replay()
        got = out[0].tolist()
    got = got[: got.index(eos_id) + 1] if eos_id in got else got
    left = _graph_checks.setdefault(label, GRAPH_REF_CHECKS)
    if left > 0:
        _graph_checks[label] = left - 1
        want = greedy_reference(torch, reader, ids, width, n_new, eos_id, kv_dtype)
        check(got == want, f"the CUDA-graph B=1 reference ({label}, {len(ids)}-token prompt, {n_new} new tokens) "
                           f"equals generate()'s token for token")
    return got


def teacher_forced(torch, reader, ids: list, new: list, kv_dtype="bf16"):
    """The reader's f32 logits (len(new), V) that chose each of ``new``
    after the prompt ``ids``: one prefill of ``ids + new[:-1]`` through a KV
    cache of ``kv_dtype``."""
    n = len(ids) + len(new) - 1
    seq = torch.tensor([ids + new[:-1]], device="cuda")
    mask = torch.tril(torch.ones((1, n, n), dtype=torch.bool, device="cuda"))
    with torch.inference_mode():
        logits = reader(seq, mask, positions=torch.arange(n, device="cuda")[None],
                        cache=reader.make_cache(1, n, kv_dtype), cache_index=0)
    return logits[0, len(ids) - 1:].float()


def margin_rule(torch, reader, ids: list, got: list, want: list, kv_dtype="bf16") -> tuple[bool, int]:
    """``got`` equals the reference ``want`` until the first step whose top-2
    logit margin (the reader teacher-forced on ``want`` through a KV cache
    of ``kv_dtype``, as a prefill) is below TWIN_LOGIT_TOL; returns (agree,
    steps compared)."""
    if got == want:
        return True, len(want)
    top2 = torch.topk(teacher_forced(torch, reader, ids, want, kv_dtype), 2, dim=-1).values
    ties = torch.nonzero(top2[:, 0] - top2[:, 1] < TWIN_LOGIT_TOL).flatten().tolist()
    until = ties[0] if ties else len(want)
    return got[:until] == want[:until], until


@contextlib.contextmanager
def k6_tally(L):
    """K6's calls by (rows, K, N) while the block runs: a tally beside its
    launch counter, through a wrapper of ``layers.w8_matmul``."""
    calls: dict = {}
    real = L.w8_matmul

    def tallied(x, w_q, *a, **kw):
        key = (x.shape[0], *w_q.shape)
        calls[key] = calls.get(key, 0) + 1
        return real(x, w_q, *a, **kw)

    L.w8_matmul = tallied
    try:
        yield calls
    finally:
        L.w8_matmul = real


def check_k6_rows(calls: dict, launches: int, path: str) -> None:
    """Every K6 launch of ``path`` at a (M, K, N) that phase_w8 checked."""
    print(f"{path}: K6 launches {launches}; rows seen {sorted({m for m, _, _ in calls})}; by (M, K, N): "
          f"{sorted(calls.items())}", flush=True)
    check(launches > 0 and sum(calls.values()) == launches
          and all(m in W8_ROWS + W8_CHECK_ROWS and (k, n) in W8_SHAPES for m, k, n in calls),
          f"K6 launched on {path}, every launch at a (M, K, N) that phase_w8 held against the plain version")


def engine_burst(url: str, payloads: list, after: dict) -> list:
    """POST every payload at once, one thread each; payload ``j`` in
    ``after`` waits for payload ``after[j]``'s answer first.  Returns each
    answer, or the HTTP error code."""
    import urllib.error

    answers = [None] * len(payloads)
    done = [threading.Event() for _ in payloads]

    def ask(j):
        try:
            if j in after:
                done[after[j]].wait(600)
            answers[j] = post(url + "/generate", payloads[j])
        except urllib.error.HTTPError as exc:
            answers[j] = exc.code
        finally:
            done[j].set()

    threads = [threading.Thread(target=ask, args=(j,)) for j in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    return answers


def phase_engine(torch, pkg, reader, ctx):
    """The continuous-batching engine at PhoGPT-4B width, as ``serve
    --continuous-slots`` builds it behind HTTP ``/generate``: a burst of
    concurrent requests (slot reuse, a slot run to the cache end, a prefix
    hit, a 400), every greedy stream held to a B=1 ``generate()`` by the
    margin rule; a second burst with sampled co-riders; a traced chunk; an
    int8 KV engine against ``generate(kv_dtype="int8")`` with the slab kept
    folded; chunked prefill.  Returns the launches of the first burst."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import build_parser, continuous_engine
    from vietnamese_qa_system_tpu_torch.core import tracing
    from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine, Retriever, ServingApp
    from vietnamese_qa_system_tpu_torch.models import decode_engine as de
    from vietnamese_qa_system_tpu_torch.models import layers as L

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    tok = ctx["tok"]
    cfg = reader.cfg
    rng = np.random.default_rng(SEED + 10)
    args = build_parser().parse_args(["serve", "--index", "-", "--db", ":memory:", "--reader-size", "phogpt4b",
                                      "--reader-quantize", "int8c", "--port", "0", *ENGINE_FLAGS])
    engine = continuous_engine(args, reader, tok, "cuda")
    buckets = engine.buckets
    check(engine.speculative and buckets == [32, 64, 128, 256, 512] and engine.total == 1024,
          "serve's /generate engine: 8 slots x 1024, buckets 32-512, n-gram speculation on by default")
    retriever = Retriever(ctx["encoder"], tok, ctx["store"], ctx["docstore"], max_len=128, query_batch=16)
    app = ServingApp(retriever, gen=engine, tokenizer=tok, k=3, max_batch=16)
    # each request's token times, by its prompt (the stream callback of submit)
    marks: dict = {}
    submit = engine.submit

    def timed_submit(ids, max_new=None, stream=None, **kw):
        t0, stamps = time.perf_counter(), []
        fut = submit(ids, max_new, stream=lambda tok_id: stamps.append(time.perf_counter()), **kw)
        marks[tuple(ids)] = (t0, stamps)
        return fut

    engine.submit = timed_submit
    shared = engine_text(rng, ENGINE_SHARED)
    payloads = [{"prompt": engine_text(rng, int(rng.integers(*ENGINE_PROMPT, endpoint=True))),
                 "max_new_tokens": int(rng.integers(*ENGINE_NEW, endpoint=True))} for _ in range(ENGINE_DRAWN)]
    payloads += [{"prompt": shared, "max_new_tokens": 24},
                 {"prompt": shared + engine_text(rng, 100), "max_new_tokens": 24},
                 {"prompt": engine_text(rng, ENGINE_LONG), "max_new_tokens": 600},
                 {"prompt": engine_text(rng, ENGINE_OVER), "max_new_tokens": 16}]
    after = {ENGINE_DRAWN + 1: ENGINE_DRAWN}  # the extension waits for the prefix's answer
    long_j, over_j = ENGINE_DRAWN + 2, ENGINE_DRAWN + 3
    url, stop = serve(app)
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        einsum0 = tracing.totals().get(L.CACHED_EINSUM, 0)
        # K6's calls by (rows, K, N), to split the launches into decode and prefill rows
        with k6_tally(L) as k6_calls:
            t0 = time.perf_counter()
            answers = engine_burst(url, payloads, after)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in pkg.KERNELS}
        einsum = tracing.totals().get(L.CACHED_EINSUM, 0) - einsum0
        print(f"/generate cached attention: {launches['decode_attention']} calls through K9, {einsum} through the "
              f"einsum (the prefills at bucket width): K9's share "
              f"{100 * launches['decode_attention'] / max(1, launches['decode_attention'] + einsum):.1f}%", flush=True)
        decode_calls = sum(c for (m, _, _), c in k6_calls.items() if m in (8, 72))
        rows = sorted({m for m, _, _ in k6_calls})
        print(f"/generate K6 launches: {launches['w8_matmul']}; decode {decode_calls} (M 8 plain, M 72 speculative), "
              f"prefill {sum(k6_calls.values()) - decode_calls} (B=1 prompts at buckets <= 256, prefix-extension "
              f"and chunked-prefill pieces); rows seen {rows}; by (M, K, N): {sorted(k6_calls.items())}", flush=True)
        check(sum(k6_calls.values()) == launches["w8_matmul"]
              and all(m in W8_ROWS + W8_CHECK_ROWS and (k, n) in W8_SHAPES for m, k, n in k6_calls),
              "every K6 launch of the /generate burst is at a (M, K, N) that phase_w8 held against the plain version")
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            stats1 = json.loads(resp.read())["stats"]["generate"]
        valid = [j for j in range(len(payloads)) if j != over_j]
        check(answers[over_j] == 400 and all(isinstance(answers[j], dict) for j in valid),
              f"{len(valid)} concurrent /generate answered 200, the {ENGINE_OVER}-token prompt 400")
        ids = {j: tok.encode(payloads[j]["prompt"]) for j in valid}
        outs = {j: answers[j]["ids"] for j in valid}
        check(len(outs[long_j]) == 1 + engine.total - len(ids[long_j]),
              f"the {ENGINE_LONG}-token prompt ran its slot to the cache end: {len(outs[long_j])} tokens")
        check(stats1["prefix_hits"] >= 1, f"the shared {ENGINE_SHARED}-token prefix hit the prefix cache "
                                          f"({stats1['prefix_hits']} hits, {stats1['prefix_tokens_reused']} tokens)")
        tokens = sum(len(o) for o in outs.values())
        ttft = [(stamps[0] - t_in) * 1e3 for t_in, stamps in marks.values() if stamps]
        itl = [(stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3 for _, stamps in marks.values() if len(stamps) > 1]
        print(f"/generate ({card}): {len(valid)} concurrent requests, {tokens} tokens in {wall:.2f} s = "
              f"{tokens / wall:.1f} tokens/s aggregate; time to first token p50 {percentile(ttft, 0.5):.1f} ms, p99 "
              f"{percentile(ttft, 0.99):.1f} ms; inter-token latency p50 {percentile(itl, 0.5):.2f} ms (a request's "
              f"(last - first) / (n - 1)); mean occupancy {stats1['avg_occupancy']} of 8 slots, {stats1['chunks']} "
              f"chunks ({stats1['spec_chunks']} speculative, {stats1['drafted_accepted']} drafts accepted), "
              f"{stats1['prefills']} prefills, {stats1['prefix_hits']} prefix hits", flush=True)

        # every greedy stream against a B=1 generate() at its bucket width
        t_ref = time.perf_counter()
        refs = {j: graph_greedy_reference(torch, reader, ids[j], bucket_of(buckets, len(ids[j])), len(outs[j]),
                                          tok.eos_id, label="engine") for j in valid}
        agree = {j: margin_rule(torch, reader, ids[j], outs[j], refs[j]) for j in valid}
        same = sum(outs[j] == refs[j] for j in valid)
        print(f"/generate greedy streams against B=1 generate() ({time.perf_counter() - t_ref:.1f} s): {same} of "
              f"{len(valid)} equal token for token; the rest compared up to the first near-tie: "
              f"{[(len(refs[j]), agree[j][1]) for j in valid if outs[j] != refs[j]]}", flush=True)
        check(all(a for a, _ in agree.values()), f"{len(valid)} greedy /generate streams equal B=1 generate() by "
                                                 f"the margin rule ({TWIN_LOGIT_TOL})")

        # the same prompts again, every third sampled: those chunks run plain
        marks.clear()
        second = [dict(payloads[j], **(ENGINE_SAMPLED if i % 3 == 2 else {})) for i, j in enumerate(valid)]
        answers2 = engine_burst(url, second, {valid.index(k): valid.index(v) for k, v in after.items()})
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            stats2 = json.loads(resp.read())["stats"]["generate"]
        ok = True
        for i, j in enumerate(valid):
            got = answers2[i]["ids"] if isinstance(answers2[i], dict) else None
            if got is None:
                ok = False
            elif i % 3 == 2:
                ok &= 1 <= len(got) <= payloads[j]["max_new_tokens"] and all(0 <= t < cfg.vocab_size for t in got)
            else:
                ok &= margin_rule(torch, reader, ids[j], got, refs[j])[0]
        plain = (stats2["chunks"] - stats2["spec_chunks"]) - (stats1["chunks"] - stats1["spec_chunks"])
        check(ok and plain > 0, f"with {len(valid) // 3} sampled co-riders ({plain} plain chunks): the greedy streams "
                                f"still equal generate(), the sampled ones are well-formed")
    finally:
        stop()
    del engine, app

    # one traced chunk of each kind, 8 live slots, on this thread
    state = de.make_decode_state(cfg, 8, 1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for slot, j in enumerate(valid[:8]):
        width = bucket_of(buckets, len(ids[j]))
        x = np.zeros((1, width), np.int32)
        x[0, : len(ids[j])] = ids[j]
        m = (np.arange(width) < len(ids[j]))[None].astype(np.int32)
        kv, first, n = de.prefill(reader, x, m, gen, 0.0, 0, 1.0, sampled=False)
        de.insert(state, kv, x, m, first, n, slot, 0.0, 0, 1.0)
    # the speculative chunk once more with K6 refused above 64 rows, so that
    # its M 72 projections take the dequantize route (a transient bf16
    # weight, multiplied in f32): the engine's other route at M 72
    real_supports = L.w8_supports
    busy = {}
    for label, run, supports in (
            ("speculative, 4 steps of 8 x 9 rows", lambda: de.decode_chunk_spec(reader, state), real_supports),
            ("speculative, M 72 on the dequantize route", lambda: de.decode_chunk_spec(reader, state),
             lambda m, k, n: m <= 64 and real_supports(m, k, n)),
            ("plain, 16 steps of 8 rows",
             lambda: de.decode_chunk(reader, state, gen, sampled=False, n_steps=16), real_supports)):
        L.w8_supports = supports
        try:
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            chunk_s = time.perf_counter() - t0
            busy[label] = (chunk_s * 1e3, trace_span(
                torch, f"engine chunk trace ({label}; {card}; untraced {chunk_s * 1e3:.1f} ms a chunk)",
                "engine.chunk", 1, chunk_s, run))
        finally:
            L.w8_supports = real_supports
    (k6_wall, k6_trace), (dq_wall, dq_trace) = busy["speculative, 4 steps of 8 x 9 rows"], \
        busy["speculative, M 72 on the dequantize route"]
    plain_trace = busy["plain, 16 steps of 8 rows"][1]
    check(k6_trace is not None and plain_trace is not None and k6_trace["syncs"] == 0 and plain_trace["syncs"] == 0,
          "no host synchronisation inside a traced speculative or plain chunk (profiler: "
          f"{None if k6_trace is None else k6_trace['syncs']} / {None if plain_trace is None else plain_trace['syncs']})")
    k6_ms = sum(ms for key, ms in k6_trace["ms_by_caller"].items() if "w8_gemm_kernel" in key)
    print(f"speculative chunk ({card}): M 72 through K6 device busy {k6_trace['busy_ms']} ms, of which K6 "
          f"{k6_ms:.1f} ms ({k6_ms / k6_trace['busy_ms']:.1%}; the stream-K kernel of 16-row tiles it replaced: "
          f"134.6 ms busy, K6 35.2, PERF.md) (untraced {k6_wall:.1f}); through the dequantize route "
          f"{dq_trace['busy_ms'] if dq_trace else 'not measured'} ms (untraced {dq_wall:.1f})", flush=True)
    del state

    # int8 KV: the streams of generate(kv_dtype="int8"), the slab never dequantized
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng8 = ContinuousEngine(reader, cfg, n_slots=8, total=1024, eos_id=tok.eos_id, kv_dtype="int8", device="cuda")
    try:
        slab = sum(t.numel() * t.element_size() for layer in eng8._state["cache"] for t in layer.values())
        picks = valid[:ENGINE_INT8_REQUESTS]
        futs = [eng8.submit(ids[j], ENGINE_SIDE_NEW) for j in picks]
        got8 = [f.result(timeout=600)["ids"] for f in futs]
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
    finally:
        eng8.close()
    del eng8
    ok = all(margin_rule(torch, reader, ids[j], g, graph_greedy_reference(
        torch, reader, ids[j], bucket_of(buckets, len(ids[j])), len(g), tok.eos_id, "int8", label="engine int8 KV"),
        "int8")[0] for j, g in zip(picks, got8))
    print(f"int8 KV engine: {len(picks)} requests; cache {slab / 1e9:.3f} GB (bf16: {2 * slab / (1 + 4 / cfg.head_dim) / 1e9:.3f}); "
          f"peak allocation above the weights {extra / 1e9:.3f} GB ({card})", flush=True)
    check(ok, f"{len(picks)} int8 KV engine streams equal B=1 generate(kv_dtype='int8') by the margin rule")
    check(extra < 2 * slab, f"the int8 pass allocated {extra / 1e9:.3f} GB above the weights, under twice its int8 "
                            f"cache ({2 * slab / 1e9:.3f} GB): the slab was never dequantized whole")

    # chunked prefill of the 500-token prompt in 128-token pieces
    engc = ContinuousEngine(reader, cfg, n_slots=8, total=1024, eos_id=tok.eos_id,
                            prefill_chunk=ENGINE_PREFILL_CHUNK, device="cuda")
    try:
        got = engc.generate_ids(ids[long_j], ENGINE_SIDE_NEW, timeout=600)
        pieces = engc.snapshot_stats()["prefill_pieces"]
    finally:
        engc.close()
    agree_c = margin_rule(torch, reader, ids[long_j], got, refs[long_j][:len(got)])[0]
    check(agree_c and pieces == -(-len(ids[long_j]) // ENGINE_PREFILL_CHUNK),
          f"prefill_chunk={ENGINE_PREFILL_CHUNK}: the {len(ids[long_j])}-token prompt admitted in {pieces} pieces, "
          "its stream equal to generate() by the margin rule")
    print(f"/generate phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def batch_rows(ids, mask, out, eos_id) -> list:
    """Each row of a left-padded batch as (its real prompt, its new tokens
    up to the first eos), lists on the host."""
    t = ids.shape[1]
    ids, mask, out = ids.cpu(), mask.cpu(), out.cpu()
    rows = []
    for r in range(ids.shape[0]):
        new = out[r, t:].tolist()
        rows.append((ids[r][mask[r].bool()].tolist(), new[: new.index(eos_id) + 1] if eos_id in new else new))
    return rows


def batch_margin_rule(torch, reader, ids, mask, got, want, eos_id) -> tuple[bool, int, list]:
    """Each row of ``got`` against ``want`` by :func:`margin_rule`; returns
    (every row agrees, rows equal token for token, (tokens, steps compared)
    of the others)."""
    rows_got, rows_want = batch_rows(ids, mask, got, eos_id), batch_rows(ids, mask, want, eos_id)
    agree, equal, others = True, 0, []
    for (prompt, g), (_, w) in zip(rows_got, rows_want):
        ok, until = margin_rule(torch, reader, prompt, g, w)
        agree &= ok
        equal += g == w
        if g != w:
            others.append((len(w), until))
    return agree, equal, others


def seq_logprob(torch, reader, prompt: list, new: list) -> float:
    """The reader's log-probability of ``new`` after ``prompt`` (a teacher-
    forced prefill)."""
    logp = torch.log_softmax(teacher_forced(torch, reader, prompt, new), dim=-1)
    return logp.gather(-1, torch.tensor(new, device="cuda")[:, None]).sum().item()


def phase_decode_strategies(torch, pkg, reader, ctx) -> int:
    """The reader's other decode strategies at PhoGPT-4B width over the QA
    phase's questions (512-token prompts, 32 new tokens):

    - /qa as ``serve`` builds it by default: ``QAPipeline(speculative=
      "ngram")`` behind ``ServingApp``, 8 concurrent questions and then one
      alone, every answer the decode of the prompt-lookup tokens, held to
      plain greedy decode of the same batch by the margin rule; passes,
      accepted drafts and tokens/s beside the plain decode; a traced run
      (at most one synchronisation a verify pass);
    - draft-model speculation with serve's ``--speculative draft
      --reader-draft-size gpt125m`` draft (random weights, widened to the
      reader's vocabulary), held to plain greedy the same way;
    - ``generate_with_config(num_beams=4)``: the same beams with the whole
      cache reordered every step (the JAX package's way), a higher sequence
      log-probability than greedy's over the batch (printed by row), W 1
      equal to greedy by the margin rule, the step time and the share of
      its cache reorder, a traced run.

    K6's calls on each path are tallied by shape.  Returns K6's launches
    on the three paths (each counted from zero)."""
    from vietnamese_qa_system_tpu_torch.cli.main import _draft, build_parser
    from vietnamese_qa_system_tpu_torch.engine import QAPipeline, Retriever, ServingApp
    from vietnamese_qa_system_tpu_torch.models import GenerationConfig, make_cache
    from vietnamese_qa_system_tpu_torch.models import generate as G
    from vietnamese_qa_system_tpu_torch.models import layers as L

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    tok, texts = ctx["tok"], ctx["texts"]
    eos, n_new = tok.eos_id, READER_NEW_TOKENS
    serve_args = ["serve", "--index", "-", "--db", ":memory:", "--reader-size", "phogpt4b", "--reader-quantize",
                  "int8c"]
    args = build_parser().parse_args(serve_args)
    check(args.speculative == "ngram" and (args.draft_tokens, args.draft_ngram) == (8, 3),
          "serve decodes /qa with prompt-lookup speculation by default (--speculative ngram, 8 drafts, 3-grams)")
    gamma = args.draft_tokens
    retriever = Retriever(ctx["encoder"], tok, ctx["store"], ctx["docstore"], max_len=128, query_batch=16)
    qa = QAPipeline(retriever, reader, tok, k=3, max_prompt_len=READER_PROMPT_LEN, max_new_tokens=n_new,
                    speculative=args.speculative, draft_tokens=gamma, draft_ngram=args.draft_ngram)
    batches, calls = [], []
    retrieve, real_spec = qa.retrieve, G.generate_speculative
    qa.retrieve = lambda qs: batches.append(list(qs)) or retrieve(qs)

    def recorded(model, ids, mask, **kw):
        out, stats = real_spec(model, ids, mask, return_stats=True, **kw)
        calls.append((ids, mask, out, stats))
        return out

    app = ServingApp(retriever, qa, k=3, max_batch=16, max_wait_s=2.0)
    url, stop = serve(app)
    questions = [texts[i] for i in ctx["questions"]]
    G.generate_speculative = recorded
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        with k6_tally(L) as k6_spec:
            t0 = time.perf_counter()
            answers = ask_all(url, "/qa", [{"question": q} for q in questions])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            single = ask_all(url, "/qa", [{"question": questions[0]}])[0]
            torch.cuda.synchronize()
        spec_launches = {k.name: k.launches for k in pkg.KERNELS}
    finally:
        G.generate_speculative = real_spec
        stop()
    check(len(batches) == 2 and len(batches[0]) == len(questions) and len(calls) == 2,
          f"the {len(questions)} concurrent /qa requests were served as one speculative batch, the single one as "
          f"another ({[len(b) for b in batches]})")
    good = [a is not None and not a["refused"] and a["contexts"][:1] == [q] for q, a in zip(questions, answers)]
    check(all(good) and single is not None and not single["refused"],
          f"{sum(good)}/{len(questions)} speculative /qa answers (200) carry their own passage as contexts[0]")
    ids, mask, out, stats = calls[0]
    t = ids.shape[1]
    served = {q: a["answer"] for q, a in zip(questions, answers)}
    decoded = [tok.decode([x for x in row if x not in (tok.pad_id, eos)]).strip() for row in out[:, t:].tolist()]
    check(all(served[q] == d for q, d in zip(batches[0], decoded)) and single["answer"] == tok.decode(
        [x for x in calls[1][2][0, calls[1][0].shape[1]:].tolist() if x not in (tok.pad_id, eos)]).strip(),
        "every /qa answer is the decode of its generate_speculative tokens")
    check_k6_rows(k6_spec, spec_launches["w8_matmul"], "the speculative /qa path (verify windows at M 8 x 9 = 72 "
                                                       "and 1 x 9)")
    check(spec_launches["matmul_topk_bf16"] > 0, "matmul_topk_bf16 launched on the speculative /qa path")
    plain_t, spec_t = {}, {}
    plain = G.generate(reader, ids, mask, max_new_tokens=n_new, eos_id=eos, timings=plain_t)
    again, again_stats = G.generate_speculative(reader, ids, mask, max_new_tokens=n_new, eos_id=eos,
                                                draft_tokens=gamma, draft_ngram=args.draft_ngram, return_stats=True,
                                                timings=spec_t)
    agree, equal, others = batch_margin_rule(torch, reader, ids, mask, out, plain, eos)
    b = ids.shape[0]
    print(f"speculative /qa ({card}): {len(questions)} concurrent questions in {wall:.2f} s; B={b} T={t}: "
          f"{stats['iterations']} verify passes of {b} x {gamma + 1} rows for {n_new} tokens a row, "
          f"{stats['drafted_accepted']} drafts accepted ({stats['drafted_accepted'] / (b * (n_new - 1)):.1%} of "
          f"the tokens after the first); decode {spec_t['decode_s'] * 1e3:.1f} ms = "
          f"{b * n_new / spec_t['decode_s']:.1f} tokens/s against plain decode {plain_t['decode_s'] * 1e3:.1f} ms = "
          f"{b * n_new / plain_t['decode_s']:.1f} tokens/s (prefill {spec_t['prefill_s'] * 1e3:.1f} / "
          f"{plain_t['prefill_s'] * 1e3:.1f} ms); {equal} of {b} rows equal plain greedy token for token, the "
          f"rest compared up to the first near-tie: {others}", flush=True)
    check(agree, f"{b} speculative /qa token streams equal plain greedy decode of the batch by the margin rule "
                 f"({TWIN_LOGIT_TOL})")
    check(torch.equal(again, out) and again_stats == stats, "a second speculative decode of the batch repeats the "
                                                          "served tokens and stats")
    traced = []
    span = trace_span(
        torch, f"speculative verify trace (B={b}, {gamma + 1}-token windows, {card})", "generate.speculative",
        stats["iterations"], spec_t["decode_s"] / stats["iterations"],
        lambda: traced.append(G.generate_speculative(reader, ids, mask, max_new_tokens=n_new, eos_id=eos,
                                                     draft_tokens=gamma, draft_ngram=args.draft_ngram,
                                                     return_stats=True, timings={})[1]))
    check(span is not None and span["syncs"] <= traced[0]["iterations"] + 1,
          f"one host synchronisation a traced verify pass, the loop's exit test ({None if span is None else span['syncs']}"
          f" over {traced[0]['iterations']} passes and the test that ends the loop)")

    # draft-model speculation with serve's --speculative draft model
    dargs = build_parser().parse_args(serve_args + ["--speculative", "draft", "--reader-draft-size", DRAFT_PRESET])
    draft = _draft(dargs.reader_draft_size, reader.cfg.vocab_size, dargs.seed + 7, "cuda", dargs.reader_draft_params,
                   "--reader-draft-params")
    check(draft.cfg.vocab_size == reader.cfg.vocab_size and draft.cfg.d_model == 768,
          f"the {DRAFT_PRESET} draft is widened to the reader's {reader.cfg.vocab_size} tokens")
    draft_t = {}
    for kern in pkg.KERNELS:
        kern.launches = 0
    with k6_tally(L) as k6_draft:
        out_d, stats_d = G.generate_speculative_draft(reader, draft, ids, mask, max_new_tokens=n_new, eos_id=eos,
                                                      draft_tokens=gamma, return_stats=True, timings=draft_t)
        torch.cuda.synchronize()
    draft_launches = {k.name: k.launches for k in pkg.KERNELS}
    agree, equal, others = batch_margin_rule(torch, reader, ids, mask, out_d, plain, eos)
    print(f"draft speculation ({DRAFT_PRESET}-class draft, random weights, {card}): {stats_d['iterations']} verify "
          f"passes for {n_new} tokens a row, {stats_d['drafted_accepted']} drafts accepted; decode "
          f"{draft_t['decode_s'] * 1e3:.1f} ms = {b * n_new / draft_t['decode_s']:.1f} tokens/s; {equal} of {b} rows "
          f"equal plain greedy, the rest up to the first near-tie: {others}", flush=True)
    check(agree, f"{b} draft-model speculative streams equal plain greedy decode by the margin rule")
    check_k6_rows(k6_draft, draft_launches["w8_matmul"], "the draft-model path (the reader's verify windows)")
    check(spec_launches["decode_attention"] > 0 and draft_launches["decode_attention"] > 0,
          "decode_attention launched on the speculative /qa and the draft-model verify windows")
    del draft

    # W 4 beams through generate_with_config
    for kern in pkg.KERNELS:
        kern.launches = 0
    with k6_tally(L) as k6_beam:
        beams = G.generate_with_config(reader, ids, mask, GenerationConfig(max_new_tokens=n_new, num_beams=BEAM_WIDTH))
        beam1 = G.generate_with_config(reader, ids, mask, GenerationConfig(max_new_tokens=n_new, num_beams=1))
        w1 = G.beam_search(reader, ids, mask, max_new_tokens=n_new, num_beams=1, eos_id=eos)
        torch.cuda.synchronize()
    beam_launches = {k.name: k.launches for k in pkg.KERNELS}
    check(beam_launches["decode_attention"] > 0, "decode_attention launched on the beam path")
    greedy = G.generate(reader, ids, mask, max_new_tokens=n_new)
    check(torch.equal(beam1, greedy), "generate_with_config(num_beams=1) is greedy decode")
    agree, equal, others = batch_margin_rule(torch, reader, ids, mask, w1, plain, eos)
    check(agree, f"W 1 beam search equals greedy decode by the margin rule ({equal} of {b} rows token for token, "
                 f"the rest up to the first near-tie: {others})")
    # the whole cache reordered every step, as the JAX package's
    # _reorder_cache does, must give the same beams as the port's reorder
    # of the generated slots alone
    real_reorder = G._reorder_cache
    G._reorder_cache = lambda cache, idx, cols=None: real_reorder(cache, idx)
    try:
        whole = G.generate_with_config(reader, ids, mask, GenerationConfig(max_new_tokens=n_new, num_beams=BEAM_WIDTH))
    finally:
        G._reorder_cache = real_reorder
    check(torch.equal(whole, beams), f"W {BEAM_WIDTH} beams with the whole cache reordered every step (the JAX "
                                     "package's way) equal the port's, which reorders the generated slots alone")
    lp = [(seq_logprob(torch, reader, p, g), seq_logprob(torch, reader, p, w))
          for (p, g), (_, w) in zip(batch_rows(ids, mask, greedy, None), batch_rows(ids, mask, beams, None))]
    print(f"beams W {BEAM_WIDTH} ({card}): sequence log-probabilities (greedy, best beam) by row: "
          f"{[(round(g, 3), round(w, 3)) for g, w in lp]}; the beam's higher on {sum(w > g for g, w in lp)} of {b} "
          f"rows (a width-{BEAM_WIDTH} beam may prune greedy's path: not a property of beam search)", flush=True)
    check(sum(w for _, w in lp) > sum(g for g, _ in lp),
          f"W {BEAM_WIDTH} beams score a higher sequence log-probability than greedy over the batch")
    check_k6_rows(k6_beam, beam_launches["w8_matmul"], f"the beam path (B x W = {b} x {BEAM_WIDTH} rows, W 1 at {b})")
    beam_t = {}
    G.beam_search(reader, ids, mask, max_new_tokens=n_new, num_beams=BEAM_WIDTH, timings=beam_t)
    step_ms = beam_t["decode_s"] / n_new * 1e3
    cache = make_cache(reader.cfg, b * BEAM_WIDTH, t + n_new, "cuda")
    cache_bytes = sum(x.numel() * x.element_size() for layer in cache for x in layer.values())
    idx = torch.randperm(b * BEAM_WIDTH, device="cuda")
    cols_ms = cuda_ms(lambda: G._reorder_cache(cache, idx, slice(t, t + n_new // 2)), 5)
    full_ms = cuda_ms(lambda: G._reorder_cache(cache, idx), 3)
    del cache
    print(f"beams W {BEAM_WIDTH} at B={b} T={t} ({card}): prefill and expansion {beam_t['prefill_s'] * 1e3:.1f} ms; a "
          f"step {step_ms:.3f} ms (selection over {BEAM_WIDTH} x {reader.cfg.vocab_size} candidates, the cache reorder, "
          f"a forward at M {b * BEAM_WIDTH}); the reorder of the generated slots as the port does it ({n_new // 2} "
          f"slots, the mean step) {cols_ms:.3f} ms = {cols_ms / step_ms:.1%} of a step; the whole cache's reorder, "
          f"as the JAX package's _reorder_cache does it every step: {full_ms:.3f} ms ({2 * cache_bytes / 1e9:.2f} GB "
          f"read and written, bound {2 * cache_bytes / HBM_BYTES_S * 1e3:.3f} ms) = {full_ms / step_ms:.1%} of a "
          f"step", flush=True)
    span = trace_span(torch, f"beam step trace (B={b} x W {BEAM_WIDTH}, {card})", "beam.decode", TRACE_STEPS,
                      step_ms / 1e3, lambda: G.beam_search(reader, ids, mask, max_new_tokens=TRACE_STEPS + 1,
                                                           num_beams=BEAM_WIDTH, timings={}))
    check(span is not None and span["syncs"] == 0, "no host synchronisation inside a traced beam decode")
    print(f"decode strategies phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return spec_launches["w8_matmul"] + draft_launches["w8_matmul"] + beam_launches["w8_matmul"]


def phase_spec_sampled(torch) -> None:
    """Sampled speculation on the card: prompt lookup and a different draft
    model draw SAMPLED_ROWS rows of a 1-layer V 13 model, whose produced
    positions must follow the exactly enumerated marginals, as plain
    sampled ``generate`` (the control) does."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.models import ModelConfig, init_causal_lm
    from vietnamese_qa_system_tpu_torch.models import generate as G

    v = SAMPLED_V
    cfg = ModelConfig(arch="causal", vocab_size=v, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq_len=64)
    model = init_causal_lm(cfg, torch.Generator(device="cuda").manual_seed(SEED + 20))
    draft = init_causal_lm(dataclasses.replace(cfg, d_model=8, n_heads=1, d_ff=16),
                           torch.Generator(device="cuda").manual_seed(SEED + 21))
    prompt = np.random.default_rng(SEED).integers(0, v, (1, 6)).astype(np.int32)

    def dist_after(prefix):
        x = torch.from_numpy(prefix).to("cuda")
        with torch.inference_mode():
            lg = model(x.long(), torch.ones_like(x))[:, -1].double()
        return torch.softmax(lg, dim=-1).cpu().numpy()

    p0 = dist_after(prompt)[0]
    p1 = dist_after(np.concatenate([np.tile(prompt, (v, 1)), np.arange(v)[:, None]], axis=1).astype(np.int32))
    pairs = np.stack(np.meshgrid(np.arange(v), np.arange(v), indexing="ij"), -1).reshape(-1, 2)
    p2 = dist_after(np.concatenate([np.tile(prompt, (v * v, 1)), pairs], axis=1).astype(np.int32)).reshape(v, v, v)
    exact = [p0, p0 @ p1, np.einsum("i,ij,ijk->k", p0, p1, p2)]
    ids = torch.from_numpy(np.tile(prompt, (SAMPLED_ROWS, 1))).to("cuda")
    mask = torch.ones_like(ids)

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(SEED + seed)

    runs = {
        "prompt lookup": G.generate_speculative(model, ids, mask, max_new_tokens=4, draft_tokens=3, draft_ngram=2,
                                                temperature=1.0, generator=gen(22)),
        "draft model": G.generate_speculative_draft(model, draft, ids, mask, max_new_tokens=3, draft_tokens=2,
                                                    temperature=1.0, generator=gen(23)),
        "plain control": G.generate(model, ids, mask, max_new_tokens=4, temperature=1.0, generator=gen(24)),
    }
    tvs = {}
    for name, out in runs.items():
        toks = out[:, 6:].cpu().numpy()
        tvs[name] = [0.5 * float(np.abs(np.bincount(toks[:, pos], minlength=v) / SAMPLED_ROWS - exact[pos]).sum())
                     for pos in range(min(3, toks.shape[1]))]
    print(f"sampled speculation (V {v}, {SAMPLED_ROWS} rows): TV to the exact marginals by position: "
          f"{ {k: [round(x, 4) for x in tv] for k, tv in tvs.items()} }", flush=True)
    check(all(x < SAMPLED_TV_TOL for tv in tvs.values() for x in tv),
          f"sampled prompt-lookup and draft-model speculation draw the exact marginals (TV < {SAMPLED_TV_TOL}), as "
          f"plain sampling does")


def clustered(torch, n: int, gen):
    """n unit rows around IVF_CENTRES unit-norm centres (random membership),
    Gaussian noise of total norm IVF_SIGMA, as tests/test_recall_clustered.py
    builds its corpus."""
    cents = torch.randn(IVF_CENTRES, D, generator=gen, device="cuda")
    cents /= cents.norm(dim=1, keepdim=True)
    pts = cents[torch.randint(0, IVF_CENTRES, (n,), generator=gen, device="cuda")]
    pts += IVF_SIGMA / D ** 0.5 * torch.randn(n, D, generator=gen, device="cuda")
    return pts / pts.norm(dim=1, keepdim=True)


def perturbed(torch, rows, gen):
    """Queries near corpus rows: 0.05 total-norm noise, renormalised."""
    q = rows + 0.05 / D ** 0.5 * torch.randn(rows.shape, generator=gen, device="cuda")
    return q / q.norm(dim=1, keepdim=True)


def host_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn`` ending in a synchronize, after a warm-up:
    what a serving loop pays for one call, the host's work included."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_ivf(torch, pkg, ctx, gen):
    """The IVF serving path once at full width, with the launch counters
    reset; returns its launches and the built indexes for the K5 phase."""
    from vietnamese_qa_system_tpu_torch.engine import (IVF_KAPPA, DocStore, IVFIndex, Retriever, ServingApp,
                                                       VectorStore, ivf_crossover_batch, select_serving_index)

    texts, n_pass = ctx["texts"], len(ctx["doc_ids"])
    # the passages keep their embeddings and take ids 0 .. n_pass - 1
    pass_vecs = torch.from_numpy(ctx["store"].get_vectors(ctx["doc_ids"])).cuda()
    corpus = torch.cat([pass_vecs, clustered(torch, N - n_pass, gen)])
    del pass_vecs
    ctx["store"] = None  # the retrieval path's 1M-row store goes
    torch.cuda.empty_cache()
    docstore = DocStore()
    docstore.insert(list(range(n_pass)), texts, ["synthetic"] * n_pass)

    for kern in pkg.KERNELS:
        kern.launches = 0
    stores = {dt: VectorStore(N, D, dtype=dt, device="cuda") for dt in ("bf16", "int8_res")}
    for st in stores.values():
        for lo in range(0, N, 1 << 18):
            st.add(corpus[lo: lo + (1 << 18)])
    ivfs = {}
    for dt, st in stores.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivfs[dt] = IVFIndex.build(st)
        torch.cuda.synchronize()
        ivf = ivfs[dt]
        print(f"IVF {dt} build over {N} rows: {time.perf_counter() - t0:.2f} s; {ivf.n_clusters} clusters x cap "
              f"{ivf.cap}, {ivf.spill_count} spilled ({100.0 * ivf.spill_count / N:.2f}%), spill_cap {ivf.spill_cap}",
              flush=True)
    check(ivfs["bf16"].n_clusters == 4096 and ivfs["bf16"].cap == 512,
          "IVF at the build defaults over 1M rows: 4,096 clusters, cap 512")

    qi = torch.randperm(N - n_pass, generator=torch.Generator().manual_seed(SEED))[:IVF_QUERIES] + n_pass
    q = perturbed(torch, corpus[qi.cuda()], gen)
    oracle = torch.sort(q @ corpus.T, dim=1, descending=True, stable=True)[1][:, :K]

    def recall(ids):
        return sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(), oracle.tolist())) / oracle.numel()

    rec = {}
    for dt, ivf in ivfs.items():
        scores, ids = ivf.topk(q, K, nprobe=IVF_NPROBE)
        rec[dt] = recall(ids)
        print(f"IVF {dt} nprobe {IVF_NPROBE}: recall@{K} {rec[dt]:.4f} against the exact f32 oracle of "
              f"{IVF_QUERIES} queries", flush=True)
        check(rec[dt] >= IVF_RECALL_FLOOR, f"IVF {dt} recall@{K} at nprobe {IVF_NPROBE} >= {IVF_RECALL_FLOOR}")
        if dt == "int8_res":
            true = torch.gather(q @ corpus.T, 1, ids.long())
            err = (scores - true).abs().max().item()
            check(err <= 2e-3, f"IVF int8_res auto-rerank scores within 2e-3 of the f32 dot products ({err:.2e})")
    bq = q.to(torch.bfloat16)
    flat_vecs = stores["bf16"].slabs[0].vectors[:N]
    _, exact_ids = ivfs["bf16"].topk(q, K, mode="exact")
    _, flat_ids = stores["bf16"].topk(q, K)
    check(rank_recall(bq, flat_vecs, exact_ids, K) == 1.0 and rank_recall(bq, flat_vecs, flat_ids, K) == 1.0,
          f"IVF bf16 exact-mode top-{K} equals the flat K1 scan's by the rank-count rule")
    new = perturbed(torch, corpus[qi[:4].cuda()], gen)
    added = ivfs["int8_res"].add(new)
    _, found = ivfs["int8_res"].topk(new, 1)
    check(found[:, 0].cpu().tolist() == added.tolist(), "IVF int8_res spill adds (K8 codes) are found first")
    del corpus

    chosen, cross = select_serving_index(stores["bf16"], ivfs["bf16"], 8)
    picked = "ivf" if chosen is ivfs["bf16"] else "flat"
    print(f"select_serving_index at query batch 8: {picked} (crossover ~{cross}, IVF_KAPPA {IVF_KAPPA})", flush=True)
    retriever = Retriever(ctx["encoder"], ctx["tok"], chosen, docstore, max_len=128, query_batch=8)
    app = ServingApp(retriever, k=5, max_batch=8, max_wait_s=0.05)
    url, stop = serve(app)
    asked = ctx["questions"]
    try:
        answers = ask_all(url, "/search", [{"query": texts[i], "k": 5} for i in asked])
    finally:
        stop()
    hits = sum(any(r["id"] == i for r in (a or {}).get("results", [])) for i, a in zip(asked, answers))
    check(hits == len(asked), f"{hits}/{len(asked)} concurrent HTTP /search over the {picked} index find their "
                              "passage in the top-5")

    # where an interactive IVF query's time goes (batch 8, the HTTP phase's)
    q8 = q[:8].contiguous()

    def queries():
        with torch.profiler.record_function("ivf.topk"):
            for _ in range(TRACE_STEPS):
                ivfs["bf16"].topk(q8, K)
            torch.cuda.synchronize()

    trace_span(torch, f"IVF query trace ({TRACE_STEPS} IVFIndex.topk calls, B=8, nprobe {IVF_NPROBE}, bf16)",
               "ivf.topk", TRACE_STEPS, host_ms(lambda: ivfs["bf16"].topk(q8, K), SWEEP_REPS) / 1e3, queries)

    # the IVF-vs-flat latency sweep on the 1M bf16 corpus: IVF_KAPPA.  The
    # crossover is the largest batch at which IVF is faster with the flat
    # scan faster at every larger swept batch; the sweep goes on doubling
    # past SWEEP_TO until the flat scan wins twice running (or SWEEP_MAX)
    sweep, batch = [], 1
    while batch <= SWEEP_MAX:
        qb = perturbed(torch, flat_vecs[torch.randint(0, N, (batch,), generator=gen, device="cuda")].float(), gen)
        ivf_t = host_ms(lambda: ivfs["bf16"].topk(qb, K), SWEEP_REPS)
        flat_t = host_ms(lambda: stores["bf16"].topk(qb, K), SWEEP_REPS)
        sweep.append((batch, ivf_t, flat_t))
        print(f"IVF-vs-flat B={batch:4d}: IVFIndex.topk {ivf_t:8.3f} ms, VectorStore.topk {flat_t:8.3f} ms", flush=True)
        if batch >= SWEEP_TO and len(sweep) >= 2 and all(i > f for _, i, f in sweep[-2:]):
            break
        batch *= 2
    wins = [b for b, i, f in sweep if i <= f]
    ivf_b = ivfs["bf16"]
    if not wins:
        print("IVF crossover: the flat scan wins at every swept batch; kappa not derived", flush=True)
    else:
        cross_b, bounded = wins[-1], wins[-1] == sweep[-1][0]
        kappa = ivf_b.size / (ivf_b.nprobe * ivf_b.cap * cross_b)
        print(f"IVF crossover: {'none up to' if bounded else ''} B={cross_b}; kappa = {ivf_b.size} / ({ivf_b.nprobe} "
              f"* {ivf_b.cap} * {cross_b}) = {kappa:.4f} ({'upper bound' if bounded else 'measured'}); IVF_KAPPA in "
              f"engine/ivf.py: {IVF_KAPPA}, crossover it gives {ivf_crossover_batch(ivf_b)}", flush=True)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in pkg.KERNELS}
    del stores
    return launches, ivfs


def phase_k5(torch, P, ivfs, gen, report):
    """K5 against its plain version at the 1M index's shapes: bf16 codes,
    int8 codes with scales, and int8 codes with a global scale folded into
    the query; probes from the queries' nearest centroids at P = nprobe.
    Device times by CUDA graph replay over enough query batches that the
    probed slabs come from HBM, not L2."""
    ivf_bf, ivf_i8 = ivfs["bf16"], ivfs["int8_res"]
    g_scale = torch.tensor(0.0123, device="cuda")
    worst = 0.0
    for b in PROBE_BATCHES:
        for kind, ivf, scales in (("bf16", ivf_bf, None), ("int8", ivf_i8, ivf_i8.shards[0].bucket_scales),
                                  ("int8_global", ivf_i8, None)):
            elt = 2 if kind == "bf16" else 1
            cents_t = ivf.centroids.to(torch.bfloat16).float().T
            per_call = b * IVF_NPROBE * ivf.cap * (D * elt + 8)
            calls = []
            for _ in range(max(1, -(-3 * L2_BYTES // per_call))):
                q = perturbed(torch, torch.randn(b, D, generator=gen, device="cuda"), gen)
                probe = torch.sort(q.to(torch.bfloat16).float() @ cents_t, dim=1, descending=True,
                                   stable=True)[1][:, :IVF_NPROBE].to(torch.int32).contiguous()
                calls.append((q * g_scale if kind == "int8_global" else q, probe))
            q, probe = calls[0]
            args = (ivf.shards[0].buckets, scales, ivf.shards[0].bucket_gids)
            (s, g), (ps, pg) = P.ivf_probe_scores(q, probe, *args), P.ivf_probe_scores_plain(q, probe, *args)
            torch.cuda.synchronize()
            fin = torch.isfinite(ps)
            err = (s - ps).abs()[fin].max().item()
            rel = err / ps.abs()[fin].max().item()
            check(torch.equal(g, pg) and torch.equal(torch.isneginf(s), torch.isneginf(ps)) and rel <= PROBE_REL_TOL,
                  f"K5 {kind} B={b} P={IVF_NPROBE} cap={ivf.cap}: gids and -inf pattern equal, max abs err "
                  f"{err:.2e} ({rel:.1e} of max |s|) <= {PROBE_REL_TOL}")
            worst = max(worst, err)
            cycle = itertools.cycle(calls)

            def kernel():
                qq, pp = next(cycle)
                return P.ivf_probe_scores(qq, pp, *args)

            def library():
                # a yardstick only: bf16 scores of a gathered copy of the slabs
                qq, pp = next(cycle)
                slab = ivf.shards[0].buckets.index_select(0, pp.reshape(-1).long()).view(b, -1, D).to(torch.bfloat16)
                sc = torch.bmm(slab, qq.to(torch.bfloat16)[:, :, None])[..., 0].view(b, IVF_NPROBE, -1).float()
                if scales is not None:
                    sc = sc * scales[pp.long()]
                return torch.where(ivf.shards[0].bucket_gids[pp.long()] >= 0, sc, float("-inf"))

            distinct = torch.unique(probe).numel()
            n_bytes = (distinct * ivf.cap * (D * elt + 4 + (4 if scales is not None else 0)) + b * D * 4
                       + b * IVF_NPROBE * (4 + ivf.cap * 8))
            iters = 24 if b < 256 else 6
            row = {
                "ms": graph_ms(kernel, iters),
                "plain_ms": cuda_ms(lambda: P.ivf_probe_scores_plain(q, probe, *args), 3),
                "library_ms": graph_ms(library, iters),
                **bound(n_bytes, 2 * b * IVF_NPROBE * ivf.cap * D, BF16_OPS_S),
            }
            print(f"K5 {kind:11s} B={b:3d}: kernel {row['ms'] * 1e3:8.2f} us, plain {row['plain_ms'] * 1e3:9.2f} us, "
                  f"library {row['library_ms'] * 1e3:8.2f} us, bound {row['bound_ms'] * 1e3:7.2f} us "
                  f"({row['bound_by']}; {distinct} distinct probed buckets)", flush=True)
            if kind == "bf16" and b == 8:
                report["ivf_probe_scores"] = dict(
                    row, shape=f"bf16 buckets (4096, {ivf.cap}, {D}), B=8, P={IVF_NPROBE} (the HTTP phase's batch)",
                    library_call="composite: index_select of the probed slabs, bf16 torch.bmm, scales, mask",
                    timing="device time, CUDA graph replay over query batches whose slabs exceed L2")
    report["ivf_probe_scores"]["max_abs_err"] = worst


def pairs_kept(t: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps in a T x T tile of one head."""
    if not causal:
        return t * t
    if window is None:
        return t * (t + 1) // 2
    return sum(min(q + 1, window) for q in range(t))


def bwd_launch_args(torch, A, qb, kb, vb, o, lse, do, lens, bias, h, causal, window):
    """The operands of K7's two C entry points, as ops/attention.flash_bwd
    builds them (dd = rowsum(dO * O) plain torch), for timing each alone."""
    bh, tq, d = qb.shape
    dd = (do.float() * o.float()).sum(dim=-1).contiguous()
    keep = (dd,)  # the caller keeps dd alive while the pointers are used
    common = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
              lens.data_ptr(), None if bias is None else bias.data_ptr(), 0 if bias is None else bias.shape[1], bh, h,
              tq, kb.shape[1], d, int(causal), int(window or 0))
    return common, keep


def phase_train_kernels(torch, A, gen, report):
    """K4's causal forms and K7 against their plain versions at the
    training shapes: the PhoGPT-4B shape (BH = 4 x 24, T = 1024, D = 128,
    causal, MPT key-only ALiBi bias) and a GPT-Neo-like local layer (BH = 48,
    T = 2048, D = 64, window 256).  K7 runs twice: its gradients must repeat
    bit for bit.  Timed with CUDA events after a warm-up, beside the plain
    versions and SDPA with the bias and mask as one float mask."""
    from vietnamese_qa_system_tpu_torch.models.layers import alibi_bias
    from vietnamese_qa_system_tpu_torch.ops.cuda_kernels import FLASH_BWD_DKDV, FLASH_BWD_DQ

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, b, h, t, d, window, alibi in (("PhoGPT-4B layer", 4, 24, TRAIN_T, 128, None, True),
                                              ("local layer", 4, 12, 2048, 64, 256, False)):
        bh = b * h
        q, k, v, do = (torch.randn(bh, t, d, generator=gen, device="cuda") for _ in range(4))
        qb, kb, vb = (q * d ** -0.5).to(torch.bfloat16).contiguous(), k.to(torch.bfloat16), v.to(torch.bfloat16)
        dob = (do * 0.1).to(torch.bfloat16)
        lens = torch.full((bh,), t, dtype=torch.int32, device="cuda")
        bias = alibi_bias(h, t, "mpt", 8.0, "cuda")[0].contiguous() if alibi else None  # (H, 1, T)
        o, lse = A.flash_fwd(qb, kb, vb, lens, bias, h, True, window)
        po, plse = A.flash_fwd_plain(qb, kb, vb, lens, bias, h, True, window)
        grads = A.flash_bwd(qb, kb, vb, o, lse, dob, lens, bias, h, True, window)
        again = A.flash_bwd(qb, kb, vb, o, lse, dob, lens, bias, h, True, window)
        plain = A.flash_bwd_plain(qb, kb, vb, o, lse, dob, lens, bias, h, True, window)
        torch.cuda.synchronize()
        o_err = (o.float() - po.float()).abs().max().item()
        lse_err = (lse - plse).abs().max().item()
        check(o_err <= FLASH_O_TOL and lse_err <= FLASH_LSE_TOL,
              f"K4 causal {label} BH={bh} T={t} D={d} window={window} bias={'key-only' if alibi else None}: o max abs "
              f"err {o_err:.2e} <= {FLASH_O_TOL}, lse {lse_err:.2e} <= {FLASH_LSE_TOL}")
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
            errs[name] = (got.float() - want.float()).abs().max().item()
            rel = errs[name] / want.float().abs().max().item()
            check(rel <= FLASH_GRAD_REL_TOL and bool(torch.isfinite(got.float()).all()),
                  f"K7 {label} {name}: max abs err {errs[name]:.2e} ({rel:.2e} of max |{name}|) <= "
                  f"{FLASH_GRAD_REL_TOL}")
        check(all(torch.equal(x, y) for x, y in zip(grads, again)), f"K7 {label}: dq, dk, dv repeat bit for bit")

        pairs = bh * pairs_kept(t, True, window)
        tile = bh * t * d * 2  # one (BH, T, D) bf16 tensor
        # the library yardstick: SDPA with the ALiBi bias and the causal /
        # band mask folded into one bf16 float mask, built outside the calls
        pos = torch.arange(t, device="cuda")
        keep = pos[None, :] <= pos[:, None]
        if window:
            keep &= pos[None, :] > pos[:, None] - window
        mask = torch.where(keep, 0.0, float("-inf"))[None]
        if bias is not None:
            mask = mask + bias
        mask = mask[None].to(torch.bfloat16)
        q4, k4, v4 = (x.view(b, h, t, d) for x in (qb, kb, vb))
        ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q4, k4, v4))
        dol = dob.view(b, h, t, d)

        def sdpa_fwd_bwd():
            out = sdpa(ql, kl, vl, attn_mask=mask, scale=1.0)
            torch.autograd.grad(out, (ql, kl, vl), dol)

        fwd = {
            "ms": cuda_ms(lambda: A.flash_fwd(qb, kb, vb, lens, bias, h, True, window), 10),
            "plain_ms": cuda_ms(lambda: A.flash_fwd_plain(qb, kb, vb, lens, bias, h, True, window), 2),
            "library_ms": cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask, scale=1.0), 10),
            # q k v o, lse, the key-only bias, lens; two products per kept pair
            **bound(4 * tile + bh * t * 4 + (h * t * 4 if alibi else 0) + bh * 4, 4 * d * pairs, BF16_OPS_S),
        }
        common, _keep = bwd_launch_args(torch, A, qb, kb, vb, o, lse, dob, lens, bias, h, True, window)
        dk, dv, dq = torch.empty_like(kb), torch.empty_like(vb), torch.empty_like(qb)
        st = torch.cuda.current_stream().cuda_stream
        lib_bwd = cuda_ms(sdpa_fwd_bwd, 5)
        dkdv = {
            "ms": cuda_ms(lambda: FLASH_BWD_DKDV.launch(*common, dk.data_ptr(), dv.data_ptr(), st), 10),
            "plain_ms": cuda_ms(lambda: A.flash_bwd_plain(qb, kb, vb, o, lse, dob, lens, bias, h, True, window), 2),
            "library_ms": lib_bwd,
            # reads q k v dO lse dd (+ bias), writes dk dv; S, dP, dV, dK
            **bound(6 * tile + 2 * bh * t * 4 + (h * t * 4 if alibi else 0), 8 * d * pairs, BF16_OPS_S),
        }
        dqr = {
            "ms": cuda_ms(lambda: FLASH_BWD_DQ.launch(*common, dq.data_ptr(), st), 10),
            "plain_ms": dkdv["plain_ms"],
            "library_ms": lib_bwd,
            # reads q k v dO lse dd (+ bias), writes dq; S, dP, dQ
            **bound(5 * tile + 2 * bh * t * 4 + (h * t * 4 if alibi else 0), 6 * d * pairs, BF16_OPS_S),
        }
        print(f"K4 causal {label}: kernel {fwd['ms']:.3f} ms, plain {fwd['plain_ms']:.3f} ms, SDPA fwd "
              f"{fwd['library_ms']:.3f} ms, bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); K7 dK/dV "
              f"{dkdv['ms']:.3f} ms (bound {dkdv['bound_ms']:.4f}, {dkdv['bound_by']}), dQ {dqr['ms']:.3f} ms (bound "
              f"{dqr['bound_ms']:.4f}, {dqr['bound_by']}), plain backward {dkdv['plain_ms']:.3f} ms, SDPA fwd+bwd "
              f"{lib_bwd:.3f} ms", flush=True)
        sdpa_bwd = lib_bwd - fwd["library_ms"]
        print(f"K4 causal {label}: {4 * d * pairs / fwd['ms'] / 1e9:.1f} TFLOP/s of useful work, K4 / SDPA forward "
              f"{fwd['ms'] / fwd['library_ms']:.2f}; K7 (dK/dV + dQ) {dkdv['ms'] + dqr['ms']:.3f} ms, "
              f"{14 * d * pairs / (dkdv['ms'] + dqr['ms']) / 1e9:.1f} TFLOP/s, / SDPA backward (fwd+bwd - fwd "
              f"{sdpa_bwd:.3f} ms) {(dkdv['ms'] + dqr['ms']) / sdpa_bwd:.2f}", flush=True)
        if alibi:
            shape = f"BH={bh} (B={b} x H={h}), T={t}, D={d}, causal, MPT key-only ALiBi bias (the train path)"
            report["flash_attention_fwd_causal"] = dict(
                fwd, max_abs_err=o_err, shape=shape,
                library_call="torch.nn.functional.scaled_dot_product_attention, ALiBi + causal mask as a bf16 "
                             "attn_mask")
            lib = "SDPA forward + backward (torch.autograd.grad), ALiBi + causal mask as a bf16 attn_mask"
            report["flash_attention_bwd_dkdv"] = dict(dkdv, max_abs_err=max(errs["dk"], errs["dv"]), shape=shape,
                                                      library_call=lib, plain_call="flash_bwd_plain (dq, dk, dv)")
            report["flash_attention_bwd_dq"] = dict(dqr, max_abs_err=errs["dq"], shape=shape, library_call=lib,
                                                    plain_call="flash_bwd_plain (dq, dk, dv)")
        del q, k, v, do, qb, kb, vb, dob, o, lse, po, plse, grads, again, plain, mask, ql, kl, vl
        torch.cuda.empty_cache()


def train_batch(rng, b: int, t: int, vocab: int) -> dict:
    """Seeded token ids; the first quarter of each row's labels is -100."""
    import numpy as np

    ids = rng.integers(3, vocab, (b, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, : t // 4] = -100
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels}


def phase_train(torch, pkg, logdir: str):
    """The QLoRA training path at PhoGPT-4B width (32 layers, nothing cut;
    int8 base drawn on the card layer by layer from the seed; LoRA r 8,
    alpha 16 on the default targets; proj_bf16 remat; adamw, lr 2e-4):
    TRAIN_STEPS Trainer.fit steps of global batch TRAIN_BATCH (grad_accum
    2) at T = TRAIN_T, the launch counters reset just before and read just
    after; then one more step under a torch.profiler trace."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.models import LoraConfig, phogpt_4b_class
    from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer
    from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(phogpt_4b_class(), remat_policy="proj_bf16")
    tcfg = TrainConfig(model=cfg, lora=LoraConfig(r=8, alpha=16), quantize_base="int8", optimizer="adamw", lr=2e-4,
                       grad_accum=2, log_every=1, log_dir=logdir, run_name="train", seed=SEED + 7)
    t0 = time.perf_counter()
    trainer = Trainer(tcfg, total_steps=TRAIN_STEPS + 1, device="cuda")
    torch.cuda.synchronize()
    model = trainer.model
    base = {n: t.clone() for n, t in model.state_dict().items() if n.endswith((".w_q", ".w_s"))}
    base_gb = sum(t.numel() * t.element_size() for t in base.values()) / 1e9
    adapter0 = [leaf.detach().clone() for leaf in tree_leaves(trainer.adapter)]
    print(f"train phogpt_4b_class: {cfg.n_layers} layers, d {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} heads, "
          f"vocab {cfg.vocab_size}, int8 base {base_gb:.2f} GB + LoRA r 8 ({sum(a.numel() for a in adapter0)} "
          f"adapter parameters), drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED)
    batches = [train_batch(rng, TRAIN_BATCH, TRAIN_T, cfg.vocab_size) for _ in range(TRAIN_STEPS + 1)]
    marks, peaks = [], []

    def factory():  # a step ends when the next batch is asked for (log_every=1 syncs)
        for bt in batches[:TRAIN_STEPS]:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if len(marks) > 1:
                peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            yield bt

    for kern in pkg.KERNELS:
        kern.launches = 0
    trainer.fit(factory, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in pkg.KERNELS}
    marks.append(time.perf_counter())
    peaks.append(torch.cuda.max_memory_allocated())
    with open(os.path.join(logdir, "train.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    tokens = TRAIN_BATCH * TRAIN_T
    for rec, s, peak in zip(logged, step_s, peaks):
        print(f"train step {rec['step']}: loss {rec['loss']:.6f}, grad_norm {rec['grad_norm']:.6f}, {s:.3f} s, "
              f"{tokens / s:.1f} tokens/s, peak memory {peak / 1e9:.2f} GB", flush=True)
    print("launches in the train run: " + json.dumps(launches), flush=True)
    check(len(logged) == TRAIN_STEPS and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in logged),
          f"{TRAIN_STEPS} train steps at PhoGPT-4B width: losses and grad norms finite")
    moved = max((a - b).abs().max().item() for a, b in zip(tree_leaves(trainer.adapter), adapter0))
    check(moved > 0, f"the adapter moved (max |delta| {moved:.3e})")
    state = model.state_dict()
    check(all(torch.equal(state[n], t) for n, t in base.items()),
          f"the int8 base ({len(base)} code and scale tensors) is unchanged byte for byte")
    calls = TRAIN_STEPS * tcfg.grad_accum * cfg.n_layers
    for name in ("flash_attention_fwd_causal", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        check(launches[name] == calls, f"{name} launched {launches[name]} = {TRAIN_STEPS} steps x {tcfg.grad_accum} "
                                       f"microbatches x {cfg.n_layers} layers (proj_bf16 keeps the forward's o "
                                       f"and lse: no re-launch in the recompute)")
    del base
    dev_batch = trainer.device_batch(batches[-1])
    trace_span(torch, f"train step trace (B={TRAIN_BATCH}, T={TRAIN_T}, torch.profiler)", "train.step", 1,
               float(np.median(step_s)), lambda: trainer.run_step(dev_batch))
    return launches


def phase_cli_train(torch, logdir: str) -> None:
    """``cli train`` in-process at PhoGPT-4B width over the repo's sample."""
    from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main

    here = os.path.dirname(os.path.abspath(__file__))
    argv = ["train", "--model-size", "phogpt4b", "--use-lora", "--quantize-base", "int8", "--remat-policy",
            "proj_bf16", "--train-files", os.path.join(here, "examples", "sample_instruct.jsonl"), "--max-steps",
            "2", "--batch-size", "8", "--log-every", "1", "--log-dir", logdir, "--run-name", "cli"]
    t0 = time.perf_counter()
    rc = cli_main(argv)
    with open(os.path.join(logdir, "cli.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    print(f"cli train: exit {rc} in {time.perf_counter() - t0:.1f} s; " + "; ".join(
        f"step {r['step']} loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f}" for r in logged), flush=True)
    check(rc == 0 and len(logged) == 2, "cli train --model-size phogpt4b --use-lora --quantize-base int8 "
                                        "--remat-policy proj_bf16 --max-steps 2 --batch-size 8 exits 0")


def phase_train_twin(torch, logdir: str) -> None:
    """Two layers at PhoGPT-4B width: one microbatch's loss and adapter
    gradients on the card (K4, K7) against the host (plain versions); then
    a step resumed from a checkpoint equals the uninterrupted run's step."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.models import (LoraConfig, causal_from_state_dict, clear_lora, loss_fn,
                                                       merge_lora, phogpt_4b_class)
    from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer
    from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(phogpt_4b_class(), n_layers=TWIN_LAYERS, remat_policy="proj_bf16")
    lora = LoraConfig(r=8, alpha=16)
    rng = np.random.default_rng(SEED + 3)

    def make(ckpt_dir=None):
        tcfg = TrainConfig(model=cfg, lora=lora, quantize_base="int8", lr=2e-4, grad_accum=2, log_every=1,
                           log_dir=logdir, run_name="twin", seed=SEED + 9, checkpoint_dir=ckpt_dir,
                           save_every_steps=1)
        return Trainer(tcfg, total_steps=4, device="cuda")

    twin = make()
    with torch.no_grad():  # B != 0, so the gradients of A are not zero
        for leaf in tree_leaves(twin.adapter)[1::2]:
            leaf.normal_(0.0, 0.02, generator=torch.Generator(device="cuda").manual_seed(SEED))
    mb = train_batch(rng, 2, TWIN_T, cfg.vocab_size)

    def grads(model, adapter, device):
        merge_lora(model, adapter, lora)
        loss, _ = loss_fn(model, {k: torch.from_numpy(v.astype(np.int64)).to(device) for k, v in mb.items()})
        g = torch.autograd.grad(loss, tree_leaves(adapter))
        clear_lora(model)
        return loss.item(), [x.float().cpu() for x in g]

    card_loss, card_g = grads(twin.model, twin.adapter, "cuda")
    host = causal_from_state_dict({k: v.cpu() for k, v in twin.model.state_dict().items()}, cfg)
    host_ad = tree_map(lambda t: t.detach().cpu().requires_grad_(True), twin.adapter)
    t0 = time.perf_counter()
    host_loss, host_g = grads(host, host_ad, "cpu")
    worst = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(card_g, host_g))
    print(f"train twin ({TWIN_LAYERS} layers, full width, B=2, T={TWIN_T}): loss card {card_loss:.6f} host "
          f"{host_loss:.6f}; adapter gradients max abs err {worst:.3e} of each leaf's max (host {time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(abs(card_loss - host_loss) <= TWIN_LOSS_TOL * abs(host_loss),
          f"twin loss on the card agrees with the host plain path within {TWIN_LOSS_TOL} (relative)")
    check(worst <= TWIN_GRAD_REL_TOL, f"twin adapter gradients agree within {TWIN_GRAD_REL_TOL} of each leaf's max")
    del host, host_ad

    ckpt = os.path.join(logdir, "twin_ckpt")
    batches = [train_batch(rng, 4, TWIN_T, cfg.vocab_size) for _ in range(2)]
    straight = make(ckpt)
    straight.fit(lambda: iter(batches), max_steps=2)  # saves step_1 and step_2
    resumed = make()
    restored, meta = straight.ckpt.restore(resumed.whole_state(), step=1)
    resumed.load_state(restored)
    resumed.train_step(batches[1])
    diff = max((a - b).abs().max().item() for a, b in zip(tree_leaves(straight.adapter), tree_leaves(resumed.adapter)))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(straight.whole_state()),
                                                  tree_leaves(resumed.whole_state())))
    print(f"twin checkpoint: restored step {meta['step']}, next step's adapter max abs diff {diff:.3e} from the "
          f"uninterrupted run (state bit-equal: {same})", flush=True)
    check(same, "checkpoint -> resume -> next step on the card equals the uninterrupted run's step, bit for bit")

    # generative eval: cli train of the twin with --do-eval --do-generative-eval --num-beams 2
    from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main

    cfg_path = os.path.join(logdir, "twin_config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    sample = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "sample_instruct.jsonl")
    argv = ["train", "--model-config", cfg_path, "--use-lora", "--quantize-base", "int8", "--train-files", sample,
            "--eval-files", sample, "--max-examples", str(TWIN_EVAL_EXAMPLES), "--max-steps", "1", "--batch-size",
            "4", "--log-every", "1", "--log-dir", logdir, "--run-name", "twin_gen", "--do-eval",
            "--do-generative-eval", "--num-beams", "2", "--max-new-tokens", str(TWIN_NEW_TOKENS)]
    t0 = time.perf_counter()
    rc = cli_main(argv)
    wall = time.perf_counter() - t0
    preds = sorted(glob.glob(os.path.join(logdir, "predictions", "log_dir_e0_twin_gen_*.txt")))
    with open(os.path.join(logdir, "twin_gen.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval_gen_tokens_per_s" in r]
    n_pred = open(preds[0]).read().count("### prediction:") if len(preds) == 1 else 0
    print(f"twin cli train --do-eval --do-generative-eval --num-beams 2: exit {rc} in {wall:.1f} s; {len(preds)} "
          f"predictions file(s) with {n_pred} predictions; logged {evals}", flush=True)
    check(rc == 0 and n_pred == TWIN_EVAL_EXAMPLES and len(evals) == 1 and evals[0]["eval_gen_tokens_per_s"] > 0,
          f"cli train --do-generative-eval --num-beams 2 wrote {TWIN_EVAL_EXAMPLES} predictions and logged "
          "gen_tokens_per_s")


def under_adapter(torch, reader, bank, ix: int):
    """The context that runs ``reader`` under bank adapter ``ix`` (0, the
    base: no factors), as a B=1 reference of the engine's streams."""
    from vietnamese_qa_system_tpu_torch.models import select_adapters
    from vietnamese_qa_system_tpu_torch.models import layers as L

    return L.row_adapters(select_adapters(reader, bank, ix)) if ix else contextlib.nullcontext()


def phase_adapters(torch, pkg, reader, ctx):
    """Multi-LoRA serving at PhoGPT-4B width: three adapters written as
    ``adapter.npz`` and loaded through ``serve --continuous-slots 8
    --adapter a=... --adapter b=... --adapter c=...`` over the int8c reader
    (serve's default n-gram speculation), 24 concurrent ``/generate``
    requests (six each for the base and the three adapters; one sampled;
    adapters a and b on one prompt, a's extension of it after), every
    greedy stream held to a B=1 ``generate()`` under its adapter by the
    margin rule, the same-prompt streams apart and keyed apart in the
    prefix cache, an unknown adapter 400, ``/healthz``; a speculative chunk
    with the bank traced beside the same chunk without it (no host
    synchronisation).  Returns the burst's launches."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import build_parser, continuous_engine
    from vietnamese_qa_system_tpu_torch.engine import Retriever, ServingApp
    from vietnamese_qa_system_tpu_torch.models import LoraConfig, init_lora
    from vietnamese_qa_system_tpu_torch.models import decode_engine as de
    from vietnamese_qa_system_tpu_torch.models import layers as L
    from vietnamese_qa_system_tpu_torch.train.checkpoint import save_pytree
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    tok, cfg = ctx["tok"], reader.cfg
    rng = np.random.default_rng(SEED + 20)
    d = tempfile.mkdtemp(prefix="chip_smoke_adapters_")
    try:
        flags = []
        for i, name in enumerate(ADAPTER_NAMES):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 30 + i)
            adapter = init_lora(gen, reader, LoraConfig())
            with torch.no_grad():
                for path, leaf in flatten_paths(adapter).items():
                    if path.endswith(".b"):
                        leaf.normal_(0.0, ADAPTER_B_STD, generator=gen)
            os.makedirs(os.path.join(d, name))
            save_pytree(os.path.join(d, name, "adapter.npz"), adapter)
            flags += ["--adapter", f"{name}={os.path.join(d, name, 'adapter.npz')}"]
        # a prefix cache that holds every prompt of the burst: no entry is evicted before it is looked up
        args = build_parser().parse_args(["serve", "--index", "-", "--db", ":memory:", "--reader-size", "phogpt4b",
                                          "--reader-quantize", "int8c", "--port", "0", *ENGINE_FLAGS,
                                          "--prefix-cache-mb", str(ADAPTER_CACHE_MB), *flags])
        t0 = time.perf_counter()
        engine = continuous_engine(args, reader, tok, "cuda")
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    bank, index, buckets = engine._bank, engine._adapter_idx, engine.buckets
    bank_gb = sum(f.numel() * f.element_size() for pair in bank.values() for f in pair if f is not None) / 1e9
    check(engine.adapter_names == list(ADAPTER_NAMES) and engine.speculative,
          f"serve --adapter loaded {engine.adapter_names} into one bank ({bank_gb:.3f} GB, index 0 the base) in "
          f"{load_s:.1f} s; n-gram speculation on by default")
    retriever = Retriever(ctx["encoder"], tok, ctx["store"], ctx["docstore"], max_len=128, query_batch=16)
    app = ServingApp(retriever, gen=engine, tokenizer=tok, k=3, max_batch=16)
    marks: dict = {}
    submit = engine.submit

    def timed_submit(ids, max_new=None, stream=None, **kw):
        t0, stamps = time.perf_counter(), []
        fut = submit(ids, max_new, stream=lambda tok_id: stamps.append(time.perf_counter()), **kw)
        marks[(tuple(ids), kw.get("adapter"))] = (t0, stamps)
        return fut

    engine.submit = timed_submit
    names = [None] * ADAPTER_PER + [n for n in ADAPTER_NAMES for _ in range(ADAPTER_PER)]
    payloads = []
    for name in names:
        p = {"prompt": engine_text(rng, int(rng.integers(*ENGINE_PROMPT, endpoint=True))),
             "max_new_tokens": int(rng.integers(*ADAPTER_NEW, endpoint=True))}
        payloads.append(p if name is None else dict(p, adapter=name))
    # a and b on one prompt (b after a's answer), then a's extension of it
    ja, jb = ADAPTER_PER, 2 * ADAPTER_PER
    ja2 = ja + 1
    shared = engine_text(rng, ADAPTER_SHARED)
    payloads[ja]["prompt"] = payloads[jb]["prompt"] = shared
    payloads[ja2]["prompt"] = shared + engine_text(rng, 60)
    after = {jb: ja, ja2: jb}
    sampled = ADAPTER_PER - 1  # a base request
    payloads[sampled].update(ENGINE_SAMPLED)
    url, stop = serve(app)
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        t0 = time.perf_counter()
        answers = engine_burst(url, payloads, after)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in pkg.KERNELS}
        import urllib.error

        try:
            post(url + "/generate", {"prompt": "xin chao", "adapter": "zz"})
            unknown = 200
        except urllib.error.HTTPError as exc:
            unknown = (exc.code, json.loads(exc.read())["error"])
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            stats = json.loads(resp.read())["stats"]["generate"]
    finally:
        stop()
    check(all(isinstance(a, dict) for a in answers), f"{len(payloads)} concurrent /generate under "
                                                     f"{ADAPTER_PER} x (base, a, b, c) answered 200")
    check(unknown != 200 and unknown[0] == 400 and "unknown adapter 'zz'" in unknown[1],
          f"an unknown adapter answers 400 ({unknown})")
    check(stats["adapters"] == list(ADAPTER_NAMES), f"/healthz lists generate.adapters {stats['adapters']}")
    ids = [tok.encode(p["prompt"]) for p in payloads]
    outs = [a["ids"] for a in answers]
    check(outs[ja] != outs[jb], "adapters a and b continue the same prompt differently")
    check(stats["prefix_hits"] == 1, f"the prefix cache is keyed by adapter: b's copy of a's prompt took no hit, a's "
                                     f"extension took a's entry ({stats['prefix_hits']} hit(s))")
    tokens = sum(len(o) for o in outs)
    ttft = [(stamps[0] - t_in) * 1e3 for t_in, stamps in marks.values() if stamps]
    print(f"/generate with adapters ({card}): {len(payloads)} concurrent requests, {tokens} tokens in {wall:.2f} s = "
          f"{tokens / wall:.1f} tokens/s aggregate; time to first token p50 {percentile(ttft, 0.5):.1f} ms, p99 "
          f"{percentile(ttft, 0.99):.1f} ms; mean occupancy {stats['avg_occupancy']} of 8 slots, {stats['chunks']} "
          f"chunks ({stats['spec_chunks']} speculative, {stats['drafted_accepted']} drafts accepted), "
          f"{stats['prefills']} prefills; K6 launches {launches['w8_matmul']}", flush=True)
    t_ref = time.perf_counter()
    agree, refs = {}, {}
    for j, (name, got) in enumerate(zip(names, outs)):
        if j == sampled:
            continue
        with under_adapter(torch, reader, bank, index.get(name, 0)):
            refs[j] = graph_greedy_reference(torch, reader, ids[j], bucket_of(buckets, len(ids[j])), len(got),
                                             tok.eos_id, label="adapters")
            agree[j] = margin_rule(torch, reader, ids[j], got, refs[j])
    same = sum(outs[j] == refs[j] for j in refs)
    print(f"/generate adapter streams against B=1 generate() under each adapter ({time.perf_counter() - t_ref:.1f} "
          f"s): {same} of {len(agree)} equal token for token; the rest (request, steps compared up to the first "
          f"near-tie): {[(j, agree[j][1]) for j in refs if outs[j] != refs[j]]}", flush=True)
    check(all(a for a, _ in agree.values()), f"{len(agree)} greedy streams equal B=1 generate() under their "
                                             f"adapter by the margin rule ({TWIN_LOGIT_TOL})")
    got = outs[sampled]
    check(1 <= len(got) <= payloads[sampled]["max_new_tokens"] and all(0 <= t < cfg.vocab_size for t in got),
          "the sampled request is well-formed")
    del engine, app

    # one speculative chunk of 8 slots under bank indices 0-3, traced with
    # the bank and without it, from the same state
    state = de.make_decode_state(cfg, 8, 1024, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for slot in range(8):
        j = slot * 3
        width = bucket_of(buckets, len(ids[j]))
        x = np.zeros((1, width), np.int32)
        x[0, : len(ids[j])] = ids[j]
        m = (np.arange(width) < len(ids[j]))[None].astype(np.int32)
        aix = [slot % (len(ADAPTER_NAMES) + 1)]
        kv, first, n = de.prefill(reader, x, m, gen, 0.0, 0, 1.0, sampled=False, bank=bank, adapter=aix)
        de.insert(state, kv, x, m, first, n, slot, 0.0, 0, 1.0, adapter=aix)
    traces = {}
    for label, bk in (("no bank", None), ("bank of 3", bank)):
        def run():
            return de.decode_chunk_spec(reader, state, bank=bk)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        traces[label] = (chunk_s * 1e3, trace_span(
            torch, f"engine chunk trace (speculative, 4 steps of 8 x 9 rows, {label}; {card}; untraced "
                   f"{chunk_s * 1e3:.1f} ms a chunk)", "engine.chunk", 1, chunk_s, run))
    (plain_ms, plain), (bank_ms, banked) = traces["no bank"], traces["bank of 3"]
    check(banked is not None and banked["syncs"] == 0,
          f"no host synchronisation inside a traced speculative chunk with the bank "
          f"({None if banked is None else banked['syncs']})")
    print(f"adapter bank, speculative chunk ({card}): device busy {banked['busy_ms']} ms (no bank "
          f"{plain['busy_ms'] if plain else 'not measured'}), untraced {bank_ms:.1f} ms ({plain_ms:.1f}), idle share "
          f"{banked['idle']} ({plain['idle'] if plain else '-'}), {banked['ops']} top-level aten calls "
          f"({plain['ops'] if plain else '-'})", flush=True)
    print(f"adapters phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def first_step_logits(torch, model, ids, mask, nxt):
    """f32 logits (B, V) at the last prompt position and at one cached
    decode step of ``nxt`` (B,), as ``generate`` runs a left-padded batch."""
    from vietnamese_qa_system_tpu_torch.models import make_cache

    b, t = ids.shape
    key_valid = torch.cat([mask.bool(), torch.zeros((b, 1), dtype=torch.bool, device=ids.device)], dim=1)
    positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0).long()
    cols = torch.arange(t + 1, device=ids.device)
    prefill_mask = (cols[None, None, :] <= cols[:t][None, :, None]) & key_valid[:, None, :]
    step_mask = key_valid[:, None, :] | (cols == t)[None, None, :]
    cache = make_cache(model.cfg, b, t + 1, "cuda")
    with torch.inference_mode():
        l0 = model(ids.long(), prefill_mask, positions=positions, cache=cache, cache_index=0)[:, -1]
        l1 = model(nxt.long()[:, None], step_mask, positions=mask.sum(1, keepdim=True).long(), cache=cache,
                   cache_index=t)[:, 0]
    return l0.float(), l1.float()


def phase_nf4(torch, pkg, ctx, int8c_bytes: int):
    """``serve --reader-quantize nf4`` and ``nf4-dq`` over the QA phase's
    drawn bf16 weights (the same seed, rewritten as a PhoGPT-4B MPT
    directory and imported through ``--reader-params``): codes equal to
    quantizing the same values, 8 concurrent ``/qa`` at 512-token prompts
    (the retrieval's K1; no K6: nf4 codes dequantize at each matmul), prefill
    s and decode tokens/s, the weights' bytes beside int8c and bf16, the
    first decode step's logits against the float reader's, a traced decode
    step and the dequantization's share of it.  Returns the /qa runs'
    launches."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import _reader, build_parser
    from vietnamese_qa_system_tpu_torch.data import batch_encode
    from vietnamese_qa_system_tpu_torch.engine import QAPipeline, Retriever, ServingApp
    from vietnamese_qa_system_tpu_torch.models import phogpt_4b_class, quantize_weight, tree_bytes
    from vietnamese_qa_system_tpu_torch.models import generate as G
    from vietnamese_qa_system_tpu_torch.models import layers as L

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    tok, texts = ctx["tok"], ctx["texts"]
    cfg = phogpt_4b_class()
    readers = {}
    d = tempfile.mkdtemp(prefix="chip_smoke_phogpt_nf4_")
    try:
        reference, total, _ = write_phogpt_dir(torch, cfg, d, torch.Generator(device="cuda").manual_seed(SEED + 1),
                                               quantize=None)
        for mode in NF4_MODES:
            args = build_parser().parse_args(["serve", "--index", d, "--db", ":memory:", "--reader-size", "phogpt4b",
                                              "--reader-params", d, "--reader-quantize", mode])
            t0 = time.perf_counter()
            readers[mode] = _reader(args.reader_size, tok, args.seed + 1, "cuda", args.reader_quantize,
                                    args.reader_params)
            torch.cuda.synchronize()
            print(f"{mode} reader imported through serve --reader-params --reader-quantize {mode} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    dense_names = [n for n, m in reference.named_modules() if isinstance(m, L.Dense) and m.w is not None]
    float_dense = sum(reference.get_submodule(n).w.numel() for n in dense_names)
    bf16_bytes = 2 * sum(t.numel() for t in reference.state_dict().values())
    retriever = Retriever(ctx["encoder"], tok, ctx["store"], ctx["docstore"], max_len=128, query_batch=16)
    questions = [texts[i] for i in ctx["questions"]]
    launches = {k.name: 0 for k in pkg.KERNELS}
    for mode, reader in readers.items():
        leaf_ok = all(torch.equal(getattr(reader.get_submodule(n), key), val)
                      for n in dense_names[:6] + dense_names[-6:]
                      for key, val in quantize_weight(reference.get_submodule(n).w, mode).items())
        check(leaf_ok, f"{mode}: imported codes and scales of the first and last layers equal quantizing the same "
                       f"bf16 values with models/quantize.py, bit for bit")
        dense = [m for m in reader.modules() if isinstance(m, L.Dense) and m.w_q is not None]
        w_bytes = sum(t.numel() * t.element_size() for m in dense for t in (m.w_q, m.w_s, m.s_q, m.s_s, m.s_m)
                      if t is not None)
        code_bytes = sum(m.w_q.numel() for m in dense)
        qa = QAPipeline(retriever, reader, tok, k=3, max_prompt_len=READER_PROMPT_LEN,
                        max_new_tokens=READER_NEW_TOKENS)
        app = ServingApp(retriever, qa, k=3, max_batch=16, max_wait_s=2.0)
        url, stop = serve(app)
        try:
            for kern in pkg.KERNELS:
                kern.launches = 0
            t0 = time.perf_counter()
            answers = ask_all(url, "/qa", [{"question": q} for q in questions])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = {k.name: k.launches for k in pkg.KERNELS}
        finally:
            stop()
        good = [a is not None and not a["refused"] and a["contexts"][:1] == [q] and isinstance(a["answer"], str)
                for q, a in zip(questions, answers)]
        check(all(good), f"{mode}: {sum(good)}/{len(questions)} HTTP /qa answers carry their own passage")
        check(run["matmul_topk_bf16"] > 0 and run["w8_matmul"] == 0,
              f"{mode} /qa: K1 launched {run['matmul_topk_bf16']} times (retrieval); K6 none (nf4 codes never "
              f"reach it)")
        for name, n in run.items():
            launches[name] += n
        prompts, _ = qa.retrieve(questions)
        ids, mask = (torch.from_numpy(a).cuda() for a in batch_encode(tok, prompts, READER_PROMPT_LEN,
                                                                       pad_side="left"))
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        G.generate(reader, ids, mask, max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id, timings=timings)
        tps = len(prompts) * READER_NEW_TOKENS / timings["decode_s"]
        f0, f1 = first_step_logits(torch, reference, ids, mask, torch.zeros(ids.shape[0], dtype=torch.int32,
                                                                           device="cuda"))
        nxt = f0.argmax(-1).to(torch.int32)
        f0, f1 = first_step_logits(torch, reference, ids, mask, nxt)
        q0, q1 = first_step_logits(torch, reader, ids, mask, nxt)
        rel = [((q - f).abs().max() / f.abs().max()).item() for q, f in ((q0, f0), (q1, f1))]
        print(f"{mode} reader ({card}): /qa {len(questions)} concurrent in {wall:.2f} s; B={len(prompts)} "
              f"T={READER_PROMPT_LEN}: prefill {timings['prefill_s']:.3f} s, decode {READER_NEW_TOKENS} steps in "
              f"{timings['decode_s']:.3f} s = {tps:.1f} tokens/s; dense weights {w_bytes / 1e9:.3f} GB ({code_bytes / 1e9:.3f} "
              f"codes + {(w_bytes - code_bytes) / 1e9:.3f} scales; {8 * w_bytes / float_dense:.3f} bits a weight), "
              f"whole model {tree_bytes(reader) / 1e9:.3f} GB against int8c {int8c_bytes / 1e9:.3f} and bf16 "
              f"{bf16_bytes / 1e9:.3f}; logits max |nf4 - float| / max |float|: last prompt position {rel[0]:.4f}, "
              f"first decode step {rel[1]:.4f}", flush=True)
        check(max(rel) <= NF4_LOGIT_REL_TOL, f"{mode}: the first decode step's logits within {NF4_LOGIT_REL_TOL} "
                                             f"(relative) of the float reader's")
        step_s = timings["decode_s"] / READER_NEW_TOKENS
        trace = trace_span(torch, f"{mode} decode trace ({TRACE_STEPS} steps, B={ids.shape[0]}, {card})",
                           "generate.decode", TRACE_STEPS, step_s,
                           lambda: G.generate(reader, ids, mask, max_new_tokens=TRACE_STEPS, eos_id=tok.eos_id,
                                              timings={}))
        def dequantize_all():
            for m in dense:
                m.dequantized()

        deq_ms = cuda_ms(dequantize_all, 3)
        print(f"{mode} dequantization of every dense weight to bf16 (once a decode step): {deq_ms:.3f} ms = "
              f"{deq_ms / trace['busy_ms'] if trace else float('nan'):.1%} of a step's device busy "
              f"{trace['busy_ms'] if trace else 'not measured'} ms", flush=True)
        del qa, app
    del readers, reference
    print(f"nf4 phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_qlora(torch, pkg, logdir: str):
    """QLoRA at PhoGPT-4B width (QLORA_LAYERS of its 32 layers) over an
    nf4-dq base (drawn on the card layer by layer; LoRA r 8 on the default
    targets; proj_bf16; adamw;
    global batch 8 x 1,024, grad_accum 2): QLORA_STEPS steps with each
    dequant placement (fused, once, once_folded) from the same base and
    initial adapter, then fused with host_offload="all"; step s, device
    busy ms (``device_busy_ms``; host staging included with offload) and
    peak memory per placement; then the 2-layer twin through
    ``cli train --profile-steps 1 --sharded-checkpoint`` and a resume from
    that checkpoint.  Returns the fused run's launches."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main
    from vietnamese_qa_system_tpu_torch.models import LoraConfig, phogpt_4b_class
    from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    cfg = dataclasses.replace(phogpt_4b_class(), remat_policy="proj_bf16", n_layers=QLORA_LAYERS)
    rng = np.random.default_rng(SEED + 40)
    batches = [train_batch(rng, TRAIN_BATCH, TRAIN_T, cfg.vocab_size) for _ in range(QLORA_STEPS)]
    model, runs, launches = None, {}, None
    for placement, offload in (("fused", None), ("once", None), ("once_folded", None), ("fused", "all")):
        label = placement + ("" if offload is None else f", host_offload={offload}")
        tcfg = TrainConfig(model=cfg, lora=LoraConfig(r=8, alpha=16), quantize_base="nf4-dq", optimizer="adamw",
                           lr=2e-4, grad_accum=2, log_every=1, log_dir=logdir, seed=SEED + 11,
                           run_name=f"qlora_{placement}_{offload}", qlora_dequant=placement, host_offload=offload)
        t0 = time.perf_counter()
        trainer = Trainer(tcfg, params=model, total_steps=QLORA_STEPS + 1, device="cuda")
        torch.cuda.synchronize()
        if model is None:
            model = trainer.model
            print(f"qlora phogpt_4b_class ({cfg.n_layers} of 32 layers, full width): nf4-dq base drawn in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        marks, peaks = [], []

        def factory():
            for bt in batches:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                if len(marks) > 1:
                    peaks.append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                yield bt

        first = launches is None
        if first:
            for kern in pkg.KERNELS:
                kern.launches = 0
        trainer.fit(factory, max_steps=QLORA_STEPS)
        torch.cuda.synchronize()
        if first:
            launches = {k.name: k.launches for k in pkg.KERNELS}
        marks.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated())
        with open(os.path.join(logdir, f"qlora_{placement}_{offload}.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        step_s = [b - a for a, b in zip(marks, marks[1:])]
        dev_batch = trainer.device_batch(batches[-1])
        busy = device_busy_ms(torch, lambda: trainer.run_step(dev_batch))
        runs[label] = (losses, step_s, peaks, busy)
        print(f"qlora {label} ({card}): losses {losses}, step s {[round(x, 3) for x in step_s]}, peak memory "
              f"{[round(p / 1e9, 2) for p in peaks]} GB; a traced step's device busy {busy:.1f} ms (idle share "
              f"{1 - busy / 1e3 / float(np.median(step_s)):.3f} of the untraced median step)", flush=True)
        check(len(losses) == QLORA_STEPS and all(np.isfinite(losses)), f"qlora {label}: finite losses")
        del trainer
        torch.cuda.empty_cache()
    fused = runs["fused"][0]
    for label in ("once", "once_folded"):
        got = runs[label][0]
        check(abs(got[0] - fused[0]) <= QLORA_LOSS_RTOL * abs(fused[0]),
              f"qlora {label}: first loss {got[0]:.6f} within {QLORA_LOSS_RTOL} (relative) of fused's {fused[0]:.6f}")
    off = runs["fused, host_offload=all"]
    check(all(abs(a - b) <= QLORA_OFFLOAD_RTOL * abs(b) for a, b in zip(off[0], fused)),
          f"host_offload=all: losses {off[0]} equal the device run's {fused} within {QLORA_OFFLOAD_RTOL}")
    print(f"host_offload=all ({card}): step s {[round(x, 3) for x in off[1]]} against the device run's "
          f"{[round(x, 3) for x in runs['fused'][1]]}", flush=True)
    for name in ("flash_attention_fwd_causal", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        check(launches[name] > 0, f"{name} launched {launches[name]} times in the nf4-dq QLoRA run")
    del model
    torch.cuda.empty_cache()

    # the 2-layer twin: a profiler trace and a sharded checkpoint through cli train, then a resume from it
    twin = dataclasses.replace(cfg, n_layers=TWIN_LAYERS)
    cfg_path = os.path.join(logdir, "qlora_twin.json")
    with open(cfg_path, "w") as f:
        f.write(twin.to_json())
    prof, ck = os.path.join(logdir, "qlora_prof"), os.path.join(logdir, "qlora_ckpt")
    sample = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "sample_instruct.jsonl")
    argv = ["train", "--model-config", cfg_path, "--use-lora", "--quantize-base", "nf4-dq", "--qlora-dequant", "once",
            "--host-offload", "all", "--train-files", sample, "--batch-size", "4", "--log-every", "1", "--log-dir",
            logdir, "--sharded-checkpoint", "--checkpoint-dir", ck, "--save-every-steps", "1"]
    rc = cli_main(argv + ["--max-steps", "2", "--run-name", "qlora_twin", "--profile-steps", "1", "--profile-dir", prof])
    traces = glob.glob(os.path.join(prof, "trace_*.json"))
    kernels = 0
    if len(traces) == 1:
        with open(traces[0]) as f:
            kernels = sum(1 for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel")
    step2 = sorted(os.listdir(os.path.join(ck, "step_2"))) if os.path.isdir(os.path.join(ck, "step_2")) else []
    rc2 = cli_main(argv + ["--max-steps", "3", "--resume", "--run-name", "qlora_twin_resumed"])
    with open(os.path.join(logdir, "qlora_twin_resumed.jsonl")) as f:
        resumed = [json.loads(line)["step"] for line in f]
    print(f"qlora twin cli train --qlora-dequant once --host-offload all --profile-steps 1 --sharded-checkpoint: exit "
          f"{rc}; {len(traces)} trace file(s) with {kernels} CUDA kernel events; step_2 holds {step2}; resumed: exit "
          f"{rc2}, logged steps {resumed}", flush=True)
    check(rc == 0 and len(traces) == 1 and kernels > 0, "cli train --profile-steps 1 wrote one trace with CUDA "
                                                        "kernel events")
    check(step2 == ["host_0.layout.json", "host_0.npz", "meta.json"] and rc2 == 0 and resumed == [3],
          "the sharded checkpoint (host_0) resumed: step 3 trained from step 2")
    print(f"qlora phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ------------------------------------------------------------- seq2seq paths


def mt5_config_json(cfg) -> dict:
    """google/mt5-small's config.json at ``cfg``'s sizes (the fields that
    shape the model; MT5Config's defaults give the rest)."""
    return {"architectures": ["MT5ForConditionalGeneration"], "model_type": "mt5", "d_model": cfg.d_model,
            "d_kv": cfg.head_dim, "d_ff": cfg.d_ff, "num_layers": cfg.n_layers, "num_decoder_layers": cfg.decoder_layers,
            "num_heads": cfg.n_heads, "vocab_size": cfg.vocab_size, "relative_attention_num_buckets":
            cfg.relative_attention_buckets, "relative_attention_max_distance": cfg.relative_attention_max_distance,
            "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False, "layer_norm_epsilon": 1e-6,
            "decoder_start_token_id": 0, "pad_token_id": 0, "eos_token_id": 1, "torch_dtype": "bfloat16"}


def mbart_config_json(cfg) -> dict:
    """facebook/mbart-large-50's config.json at ``cfg``'s sizes."""
    return {"architectures": ["MBartForConditionalGeneration"], "model_type": "mbart", "d_model": cfg.d_model,
            "encoder_layers": cfg.n_layers, "decoder_layers": cfg.decoder_layers,
            "encoder_attention_heads": cfg.n_heads, "decoder_attention_heads": cfg.n_heads,
            "encoder_ffn_dim": cfg.d_ff, "decoder_ffn_dim": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.max_seq_len, "activation_function": "gelu", "scale_embedding": True,
            "normalize_before": True, "add_final_layer_norm": True, "pad_token_id": 1, "bos_token_id": 0,
            "eos_token_id": 2, "decoder_start_token_id": 2, "forced_eos_token_id": 2, "torch_dtype": "bfloat16"}


def mt5_tensors(cfg) -> list:
    """(HF name, shape, port name, kind) of an mT5 checkpoint in file order
    (the smoke's own map: Linear weights are (out, in); wi_0 is the gelu
    gate, the port's wg).  kind: "dense" (a Linear), "norm", "embed"."""
    d, inner, f, h = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff, cfg.n_heads
    out = [("shared.weight", (cfg.vocab_size, d), "tok_embed", "embed")]
    for stack, hf_stack, n in (("enc_blocks", "encoder", cfg.n_layers), ("dec_blocks", "decoder", cfg.decoder_layers)):
        for i in range(n):
            pre = f"{hf_stack}.block.{i}.layer."
            attns = [("0.SelfAttention", "attn", "ln1")]
            if stack == "dec_blocks":
                attns.append(("1.EncDecAttention", "cross_attn", "ln_cross"))
            for hf_attn, ours, ln in attns:
                layer = hf_attn.split(".")[0]
                for proj, shape in (("q", (inner, d)), ("k", (inner, d)), ("v", (inner, d)), ("o", (d, inner))):
                    out.append((f"{pre}{hf_attn}.{proj}.weight", shape, f"{stack}.{i}.{ours}.w{proj}", "dense"))
                if i == 0 and ours == "attn":
                    out.append((f"{pre}0.SelfAttention.relative_attention_bias.weight",
                                (cfg.relative_attention_buckets, h), f"{stack[:3]}_rel_bias", "embed"))
                out.append((f"{pre}{layer}.layer_norm.weight", (d,), f"{stack}.{i}.{ln}.scale", "norm"))
            ff = 1 if stack == "enc_blocks" else 2
            for hf_w, ours, shape in (("wi_0", "wg", (f, d)), ("wi_1", "wi", (f, d)), ("wo", "wo", (d, f))):
                out.append((f"{pre}{ff}.DenseReluDense.{hf_w}.weight", shape, f"{stack}.{i}.mlp.{ours}", "dense"))
            out.append((f"{pre}{ff}.layer_norm.weight", (d,), f"{stack}.{i}.ln2.scale", "norm"))
        out.append((f"{hf_stack}.final_layer_norm.weight", (d,), f"{stack[:3]}_ln_f.scale", "norm"))
    out.append(("lm_head.weight", (cfg.vocab_size, d), "lm_head", "head"))
    return out


def mbart_tensors(cfg) -> list:
    """(HF name, shape, port name, kind) of an mBART checkpoint in file
    order; kind adds "bias" (a Linear's or a norm's bias, drawn
    N(0, 0.02^2)) and "zeros" (final_logits_bias, zero as published)."""
    d, f, rows = cfg.d_model, cfg.d_ff, cfg.max_seq_len + 2
    out = [("model.shared.weight", (cfg.vocab_size, d), "tok_embed", "embed")]
    for stack, hf_stack, n in (("enc_blocks", "encoder", cfg.n_layers), ("dec_blocks", "decoder", cfg.decoder_layers)):
        pre = f"model.{hf_stack}."
        out.append((pre + "embed_positions.weight", (rows, d), f"{stack[:3]}_pos_embed", "embed"))
        out += [(pre + "layernorm_embedding.weight", (d,), f"{stack[:3]}_ln_emb.scale", "norm"),
                (pre + "layernorm_embedding.bias", (d,), f"{stack[:3]}_ln_emb.bias", "bias")]
        for i in range(n):
            lp = f"{pre}layers.{i}."
            attns = [("self_attn", "attn", "self_attn_layer_norm", "ln1")]
            if stack == "dec_blocks":
                attns.append(("encoder_attn", "cross_attn", "encoder_attn_layer_norm", "ln_cross"))
            for hf_attn, ours, hf_ln, ln in attns:
                for proj, hf_proj in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "out_proj")):
                    out += [(f"{lp}{hf_attn}.{hf_proj}.weight", (d, d), f"{stack}.{i}.{ours}.{proj}", "dense"),
                            (f"{lp}{hf_attn}.{hf_proj}.bias", (d,), f"{stack}.{i}.{ours}.{proj}.b", "bias")]
                out += [(f"{lp}{hf_ln}.weight", (d,), f"{stack}.{i}.{ln}.scale", "norm"),
                        (f"{lp}{hf_ln}.bias", (d,), f"{stack}.{i}.{ln}.bias", "bias")]
            out += [(f"{lp}fc1.weight", (f, d), f"{stack}.{i}.mlp.fc1", "dense"),
                    (f"{lp}fc1.bias", (f,), f"{stack}.{i}.mlp.fc1.b", "bias"),
                    (f"{lp}fc2.weight", (d, f), f"{stack}.{i}.mlp.fc2", "dense"),
                    (f"{lp}fc2.bias", (d,), f"{stack}.{i}.mlp.fc2.b", "bias"),
                    (f"{lp}final_layer_norm.weight", (d,), f"{stack}.{i}.ln2.scale", "norm"),
                    (f"{lp}final_layer_norm.bias", (d,), f"{stack}.{i}.ln2.bias", "bias")]
        out += [(pre + "layer_norm.weight", (d,), f"{stack[:3]}_ln_f.scale", "norm"),
                (pre + "layer_norm.bias", (d,), f"{stack[:3]}_ln_f.bias", "bias")]
    out.append(("final_logits_bias", (1, cfg.vocab_size), None, "zeros"))
    return out


def write_s2s_dir(torch, config: dict, tensors: list, out_dir: str, gen, quantize=None,
                  embed_std=0.02) -> tuple[dict, int]:
    """One bf16 safetensors file (and config.json) of drawn weights, written
    tensor by tensor: dense weights U(-1/sqrt(d_in), 1/sqrt(d_in)), norm
    scales 1 + N(0, 0.1^2), biases N(0, 0.02^2), embeddings and tables
    N(0, embed_std^2) (the head N(0, 0.02^2)).  Returns the port's state
    built from the same bf16 values (dense weights of the blocks quantized
    in mode ``quantize`` by models/quantize.py, the LM head float) and the
    file's bytes."""
    from vietnamese_qa_system_tpu_torch.models import quantize_weight

    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    path = os.path.join(out_dir, "model.safetensors")
    state = {}
    with open(path, "wb") as f:
        f.write(safetensors_header([(name, torch.bfloat16, shape) for name, shape, _, _ in tensors]))
        for name, shape, ours, kind in tensors:
            if kind == "dense":
                t = (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) / shape[1] ** 0.5
            elif kind == "norm":
                t = 1.0 + 0.1 * torch.randn(shape, generator=gen, device="cuda")
            elif kind == "zeros":
                t = torch.zeros(shape, device="cuda")
            else:
                std = 0.02 if kind in ("bias", "head") else embed_std
                t = std * torch.randn(shape, generator=gen, device="cuda")
            t = t.to(torch.bfloat16)
            write_tensor(f, t)
            if ours is None:
                continue
            if kind in ("dense", "head"):
                w = t.float().T.contiguous()
                leaf = quantize_weight(w, quantize) if quantize and kind == "dense" else {"w": w}
                state.update({f"{ours}.{key}": v for key, v in leaf.items()})
            else:
                state[ours] = t.float()
    return state, os.path.getsize(path)


def s2s_teacher_forced(torch, model, enc, mask, stream, bos: int):
    """Decoder logits (B, N, V) f32 that chose each token of ``stream``
    (B, N): one cache-less decode of ``[bos] + stream[:-1]``."""
    dec = torch.cat([torch.full_like(stream[:, :1], bos), stream[:, :-1]], dim=1)
    with torch.inference_mode():
        return model({"input_ids": enc, "attention_mask": mask, "decoder_input_ids": dec}).float()


def s2s_margin_rule(torch, model, enc, mask, got, want, bos: int) -> tuple[bool, list]:
    """Row by row, ``got`` equals ``want`` (both (B, N)) up to the first
    step whose top-2 margin of ``model`` teacher-forced on ``want`` is
    below TWIN_LOGIT_TOL; returns (agree, steps compared a row)."""
    if torch.equal(got.cpu(), want.cpu()):
        return True, [want.shape[1]] * want.shape[0]
    top2 = torch.topk(s2s_teacher_forced(torch, model, enc, mask, want.to(enc.device), bos), 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu()
    agree, until = True, []
    for r in range(want.shape[0]):
        ties = torch.nonzero(margin[r] < TWIN_LOGIT_TOL).flatten()
        u = int(ties[0]) if len(ties) else want.shape[1]
        until.append(u)
        agree &= torch.equal(got[r, :u].cpu(), want[r, :u].cpu())
    return agree, until


def s2s_twin(torch, model, n_layers: int):
    """``n_layers`` encoder and decoder layers of ``model``'s weights, full
    width, on the card and on the host."""
    from vietnamese_qa_system_tpu_torch.models import seq2seq_from_state_dict

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers, n_decoder_layers=n_layers, use_flash_attention=False)
    state = {k: v for k, v in model.state_dict().items()
             if not k.startswith(("enc_blocks.", "dec_blocks.")) or int(k.split(".")[1]) < n_layers}
    return seq2seq_from_state_dict(state, cfg), seq2seq_from_state_dict({k: v.cpu() for k, v in state.items()}, cfg)


def check_twin_decode(torch, label: str, card, host, enc, mask, n_new: int, **kw) -> None:
    """Greedy ``generate_seq2seq`` of the card twin against the host twin:
    teacher-forced logits within TWIN_LOGIT_TOL, tokens by the margin rule."""
    from vietnamese_qa_system_tpu_torch.models import generate as G

    bos = kw.get("bos_id", 0)
    out_card = G.generate_seq2seq(card, enc.cuda(), mask.cuda(), max_new_tokens=n_new, **kw).cpu()
    out_host = G.generate_seq2seq(host, enc, mask, max_new_tokens=n_new, **kw)
    lc = s2s_teacher_forced(torch, card, enc.cuda(), mask.cuda(), out_card.cuda(), bos).cpu()
    lh = s2s_teacher_forced(torch, host, enc, mask, out_card, bos)
    err = (lc - lh).abs().max().item()
    agree, until = s2s_margin_rule(torch, host, enc, mask, out_card, out_host, bos)
    print(f"{label}: logits max abs err {err:.3e} over {n_new} steps, tokens compared up to steps {until}", flush=True)
    check(err <= TWIN_LOGIT_TOL, f"{label}: greedy logits on the card agree with the host within {TWIN_LOGIT_TOL}")
    check(agree, f"{label}: greedy tokens agree with the host until the first top-2 margin below the tolerance")


def check_s2s_k6(calls: dict, launches: int, path: str) -> None:
    """Every K6 launch of ``path`` at a (M, K, N) that phase_w8 checked."""
    print(f"{path}: K6 launches {launches}; by (M, K, N): {sorted(calls.items())}", flush=True)
    check(launches > 0 and sum(calls.values()) == launches
          and all(m in W8_ROWS + W8_CHECK_ROWS and (k, n) in MT5_W8_SHAPES for m, k, n in calls),
          f"K6 launched on {path}, every launch at an mt5-small (M, K, N) that phase_w8 held against the plain version")


def phase_seq2seq_qa(torch, pkg, ctx):
    """mt5-small at full width (nothing cut): drawn bf16 weights written as
    an HF MT5 directory and loaded through ``serve --reader-params DIR
    --reader-size mt5small --reader-quantize int8c`` (codes bit-equal to
    the smoke's own quantization); 8 concurrent /qa over the 1M-row bf16
    store (K1; K6 at M 8 in every decoder step), answers equal the
    reference reader's; a 2-layer twin on the card and the host; the same
    reader with ``use_flash_attention`` (K4 bidirectional with the full
    relative bias over the 512-token encoder).  Returns the /qa launches,
    the flash encode's launches, the reader and the HF directory, which
    phase_tp_seq2seq loads again (the caller removes it)."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import _reader, build_parser
    from vietnamese_qa_system_tpu_torch.data import batch_encode
    from vietnamese_qa_system_tpu_torch.engine import QAPipeline, Retriever, ServingApp
    from vietnamese_qa_system_tpu_torch.models import generate as G
    from vietnamese_qa_system_tpu_torch.models import layers as L
    from vietnamese_qa_system_tpu_torch.models import mt5_small_class, seq2seq_from_state_dict

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    tok, texts = ctx["tok"], ctx["texts"]
    cfg = mt5_small_class()
    d = tempfile.mkdtemp(prefix="chip_smoke_mt5_")
    try:
        t0 = time.perf_counter()
        ref_state, n_bytes = write_s2s_dir(torch, mt5_config_json(cfg), mt5_tensors(cfg), d,
                                           torch.Generator(device="cuda").manual_seed(SEED + 21), "int8c",
                                           embed_std=1.0)
        write_s = time.perf_counter() - t0
        args = build_parser().parse_args(["serve", "--index", d, "--db", ":memory:", "--reader-size", "mt5small",
                                          "--reader-params", d, "--reader-quantize", "int8c"])
        t0 = time.perf_counter()
        reader = _reader(args.reader_size, tok, args.seed + 1, "cuda", args.reader_quantize, args.reader_params)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    reference = seq2seq_from_state_dict(ref_state, cfg)
    got, want = reader.state_dict(), reference.state_dict()
    print(f"mt5-small HF directory (d {cfg.d_model}, {cfg.n_heads} heads x d_kv {cfg.head_dim}, {cfg.n_layers} + "
          f"{cfg.decoder_layers} layers, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, untied head): {n_bytes / 1e9:.2f} GB "
          f"bf16 written in {write_s:.1f} s, loaded through serve --reader-params --reader-size mt5small "
          f"--reader-quantize int8c in {load_s:.1f} s", flush=True)
    check(sorted(got) == sorted(want) and all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                                              for k in want),
          "imported mt5-small int8c codes and scales (and every other tensor) equal quantizing the same bf16 values "
          "with models/quantize.py, bit for bit")
    check(reader.lm_head.w_q is None and reader.dec_blocks[0].cross_attn.wk.w_q.dtype == torch.int8,
          "every encoder and decoder projection is int8c; the untied LM head stays float")

    retriever = Retriever(ctx["encoder"], tok, ctx["store"], ctx["docstore"], max_len=128, query_batch=16)
    qa = QAPipeline(retriever, reader, tok, k=3, max_prompt_len=READER_PROMPT_LEN, max_new_tokens=READER_NEW_TOKENS,
                    speculative="ngram")
    batches = []
    retrieve = qa.retrieve
    qa.retrieve = lambda qs: batches.append(list(qs)) or retrieve(qs)
    app = ServingApp(retriever, qa, k=3, max_batch=16, max_wait_s=2.0)
    url, stop = serve(app)
    questions = [texts[i] for i in ctx["questions"]]
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        with k6_tally(L) as k6_calls:
            t0 = time.perf_counter()
            answers = ask_all(url, "/qa", [{"question": q} for q in questions])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in pkg.KERNELS}
    finally:
        stop()
    print(f"mt5 /qa: {len(questions)} concurrent questions in {wall:.2f} s; launches {json.dumps(launches)}",
          flush=True)
    good = [a is not None and not a["refused"] and a["contexts"][:1] == [q] and isinstance(a["answer"], str)
            for q, a in zip(questions, answers)]
    check(all(good) and len(batches) == 1 and qa.speculative == "none",
          f"{sum(good)}/{len(questions)} mt5 /qa answers (200) carry their own passage, one batch, speculation off")
    per_call = 9 * cfg.decoder_layers * READER_NEW_TOKENS
    check(launches["matmul_topk_bf16"] > 0 and launches["w8_matmul"] == per_call,
          f"mt5 /qa: K1 launched; K6 {launches['w8_matmul']} = 9 projections x {cfg.decoder_layers} decoder layers x "
          f"{READER_NEW_TOKENS} steps (the 512-token encoder and cross K/V of 8 x 512 rows take the dequantize route)")
    check_s2s_k6(k6_calls, launches["w8_matmul"], "the mt5 /qa path")
    ref_qa = QAPipeline(retriever, reference, tok, k=3, max_prompt_len=READER_PROMPT_LEN,
                        max_new_tokens=READER_NEW_TOKENS)
    ref = {q: a.answer for q, a in zip(batches[0], ref_qa.answer(batches[0]))}
    check(all(a["answer"] == ref[q] for q, a in zip(questions, answers)),
          "every mt5 /qa answer equals the reference reader's")
    del ref_qa, reference, ref_state

    prompts, _ = qa.retrieve(questions)
    ids, mask = batch_encode(tok, prompts, READER_PROMPT_LEN, pad_side="right")
    enc, emask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    timings = {}
    out = G.generate_seq2seq(reader, enc, emask, max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id, timings=timings)
    tps = len(prompts) * READER_NEW_TOKENS / timings["decode_s"]
    print(f"mt5 reader ({card}) B={len(prompts)} T_enc={READER_PROMPT_LEN}: encode + cross K/V "
          f"{timings['prefill_s']:.3f} s, {READER_NEW_TOKENS} decoder steps in {timings['decode_s']:.3f} s = "
          f"{tps:.1f} tokens/s ({timings['decode_s'] / READER_NEW_TOKENS * 1e3:.2f} ms a step)", flush=True)
    trace_span(torch, f"mt5 decode trace (B={len(prompts)}, {READER_NEW_TOKENS} steps, torch.profiler)",
               "generate.seq2seq", READER_NEW_TOKENS, timings["decode_s"] / READER_NEW_TOKENS,
               lambda: G.generate_seq2seq(reader, enc, emask, max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id,
                                          timings={}))

    # the same weights with the flash route: the encoder's self-attention
    # (T 512 >= 256) through K4, bidirectional with the full (H, T, T) bias
    dense_cfg = reader.cfg
    with torch.inference_mode():
        enc_dense = reader.encode(enc, emask)
        step_dense = reader.decode(out[:, :1].long(), enc_dense, emask)
    reader.cfg = dataclasses.replace(dense_cfg, use_flash_attention=True)
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        out_flash = G.generate_seq2seq(reader, enc, emask, max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id)
        torch.cuda.synchronize()
        flash_launches = {k.name: k.launches for k in pkg.KERNELS}
        with torch.inference_mode():
            enc_flash = reader.encode(enc, emask)
            step_flash = reader.decode(out[:, :1].long(), enc_flash, emask)
    finally:
        reader.cfg = dense_cfg
    valid = emask.bool()[:, :, None]
    h_err = ((enc_flash - enc_dense).abs() * valid).max().item()
    l_err = (step_flash - step_dense).abs().max().item()
    agree, until = s2s_margin_rule(torch, reader, enc, emask, out_flash, out, 0)
    print(f"mt5 flash route: K4 launches {flash_launches['flash_attention_fwd']} (bidirectional, full bias, kv_lens); "
          f"encoder hidden max abs err {h_err:.3e} (valid rows), first-step logits {l_err:.3e}; tokens compared up to "
          f"steps {until}", flush=True)
    check(flash_launches["flash_attention_fwd"] == cfg.n_layers,
          f"K4 launched once an encoder layer ({cfg.n_layers}) in generate_seq2seq with use_flash_attention")
    check(l_err <= S2S_FLASH_LOGIT_TOL and agree,
          f"flash-route logits within {S2S_FLASH_LOGIT_TOL} of the dense path, greedy tokens equal by the margin rule")

    # a 2-layer twin of the same weights (int8c: K6 on the card) against the host
    card_twin, host_twin = s2s_twin(torch, reader, TWIN_LAYERS)
    rng = np.random.default_rng(SEED + 22)
    tw_ids = torch.from_numpy(rng.integers(4, 260, (TWIN_ROWS, TWIN_PROMPT_LEN)).astype(np.int32))
    tw_mask = torch.ones_like(tw_ids)
    tw_mask[1::2, -8:] = 0
    check_twin_decode(torch, f"mt5 twin ({TWIN_LAYERS} + {TWIN_LAYERS} layers, full width, int8c)", card_twin,
                      host_twin, tw_ids * tw_mask, tw_mask, TWIN_NEW_TOKENS)
    del card_twin, host_twin
    print(f"mt5 /qa phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, flash_launches, reader, d


def phase_seq2seq_engine(torch, pkg, reader, ctx):
    """``serve --continuous-slots 8 --gen-total 256`` over the mt5 reader:
    16 concurrent /generate (16-128 encoder tokens, 16-96 new tokens, every
    fourth sampled) and one over the largest encoder bucket (a 400); every
    greedy stream equal to a B=1 ``generate_seq2seq`` at its bucket width
    by the margin rule; a traced chunk with no host synchronisation.
    Returns the burst's launches."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import build_parser, continuous_engine
    from vietnamese_qa_system_tpu_torch.engine import Retriever, ServingApp
    from vietnamese_qa_system_tpu_torch.models import decode_engine as de
    from vietnamese_qa_system_tpu_torch.models import generate as G
    from vietnamese_qa_system_tpu_torch.models import layers as L

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    tok = ctx["tok"]
    args = build_parser().parse_args(["serve", "--index", "-", "--db", ":memory:", "--reader-size", "mt5small",
                                      "--reader-quantize", "int8c", "--port", "0", *S2S_ENGINE_FLAGS])
    engine = continuous_engine(args, reader, tok, "cuda")
    buckets = engine.buckets
    check(not engine.speculative and engine.total == 256 and buckets == [32, 64, 128],
          f"serve's seq2seq /generate engine: 8 slots x 256 decoder columns, encoder buckets {buckets}, no speculation")
    app = ServingApp(Retriever(ctx["encoder"], tok, ctx["store"], ctx["docstore"], max_len=128, query_batch=16),
                     gen=engine, tokenizer=tok, k=3, max_batch=16)
    marks: dict = {}
    submit = engine.submit

    def timed_submit(ids, max_new=None, stream=None, **kw):
        t0, stamps = time.perf_counter(), []
        fut = submit(ids, max_new, stream=lambda tok_id: stamps.append(time.perf_counter()), **kw)
        marks[tuple(ids)] = (t0, stamps)
        return fut

    engine.submit = timed_submit
    rng = np.random.default_rng(SEED + 23)
    payloads = [{"prompt": engine_text(rng, int(rng.integers(*S2S_ENGINE_PROMPT, endpoint=True))),
                 "max_new_tokens": int(rng.integers(*ENGINE_NEW, endpoint=True)),
                 **(ENGINE_SAMPLED if j % 4 == 3 else {})} for j in range(S2S_ENGINE_REQUESTS)]
    payloads.append({"prompt": engine_text(rng, buckets[-1] + 1), "max_new_tokens": 16})
    url, stop = serve(app)
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        with k6_tally(L) as k6_calls:
            t0 = time.perf_counter()
            answers = engine_burst(url, payloads, {})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in pkg.KERNELS}
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            stats = json.loads(resp.read())["stats"]["generate"]
    finally:
        stop()
    del engine, app
    valid = list(range(S2S_ENGINE_REQUESTS))
    check(answers[-1] == 400 and all(isinstance(answers[j], dict) for j in valid),
          f"{len(valid)} concurrent seq2seq /generate answered 200, the {buckets[-1] + 1}-token prompt 400")
    check_s2s_k6(k6_calls, launches["w8_matmul"], "the mt5 /generate path")
    outs = {j: answers[j]["ids"] for j in valid}
    tokens = sum(len(o) for o in outs.values())
    ttft = [(stamps[0] - t_in) * 1e3 for t_in, stamps in marks.values() if stamps]
    itl = [(stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3 for _, stamps in marks.values() if len(stamps) > 1]
    print(f"mt5 /generate ({card}): {len(valid)} concurrent requests, {tokens} tokens in {wall:.2f} s = "
          f"{tokens / wall:.1f} tokens/s aggregate; time to first token p50 {percentile(ttft, 0.5):.1f} ms, p99 "
          f"{percentile(ttft, 0.99):.1f} ms; inter-token latency p50 {percentile(itl, 0.5):.2f} ms; mean occupancy "
          f"{stats['avg_occupancy']} of 8 slots, {stats['chunks']} chunks, {stats['prefills']} prefills", flush=True)
    ok, compared = True, []
    for j in valid:
        ids = tok.encode(payloads[j]["prompt"])
        if "temperature" in payloads[j]:
            ok &= 1 <= len(outs[j]) <= payloads[j]["max_new_tokens"] and all(0 <= t < reader.cfg.vocab_size
                                                                             for t in outs[j])
            continue
        width = bucket_of(buckets, len(ids))
        x = torch.zeros((1, width), dtype=torch.int32)
        m = torch.zeros((1, width), dtype=torch.int32)
        x[0, : len(ids)] = torch.tensor(ids, dtype=torch.int32)
        m[0, : len(ids)] = 1
        want = G.generate_seq2seq(reader, x.cuda(), m.cuda(), max_new_tokens=len(outs[j]), eos_id=tok.eos_id)
        agree, until = s2s_margin_rule(torch, reader, x.cuda(), m.cuda(), torch.tensor([outs[j]]), want.cpu(), 0)
        ok &= agree
        compared.append(until[0])
    print(f"mt5 /generate greedy streams against B=1 generate_seq2seq at their bucket widths: compared up to steps "
          f"{compared}", flush=True)
    check(ok, f"{len(compared)} greedy seq2seq /generate streams equal B=1 generate_seq2seq by the margin rule "
              f"({TWIN_LOGIT_TOL}); {len(valid) - len(compared)} sampled ones well-formed")

    # one traced chunk: 8 live slots, on this thread
    state = de.make_decode_state_seq2seq(reader.cfg, 8, 256, buckets[-1], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for slot in range(8):
        ids = tok.encode(payloads[slot]["prompt"])
        width = bucket_of(buckets, len(ids))
        x = np.zeros((1, width), np.int32)
        x[0, : len(ids)] = ids
        m = (np.arange(width) < len(ids))[None].astype(np.int32)
        ckv, dec_kv, first = de.prefill_seq2seq(reader, x, m, gen, 0.0, 0, 1.0, sampled=False)
        de.insert_seq2seq(state, ckv, np.pad(m, ((0, 0), (0, buckets[-1] - width))), dec_kv, first, slot, 0.0, 0, 1.0)

    def run():
        return de.decode_chunk_seq2seq(reader, state, gen, sampled=False, n_steps=16)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    traced = trace_span(torch, f"mt5 engine chunk trace (16 steps of 8 rows; {card}; untraced {chunk_s * 1e3:.1f} ms)",
                        "engine.chunk", 16, chunk_s / 16, run)
    check(traced is not None and traced["syncs"] == 0,
          f"no host synchronisation inside a traced seq2seq chunk (profiler: {None if traced is None else traced['syncs']})")
    del state
    print(f"mt5 /generate phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_mbart(torch):
    """mBART at facebook/mbart-large-50's published width (d 1,024, 12 + 12
    layers, 16 heads, FFN 4,096, V 250,054, scale_embedding): drawn bf16
    weights written as an HF mbart directory and loaded through ``chat
    --arch seq2seq --init-params DIR``, tensors bit-equal to the drawn
    values; greedy and W 4 beams with a forced BOS at B 8 (beams' summed
    log-probability >= greedy's on the batch), the beam step's ms, and a
    2-layer twin on the card and the host.  Returns the model, which
    phase_tp_seq2seq splits."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import _reader, _tokenizer, build_parser
    from vietnamese_qa_system_tpu_torch.models import ModelConfig
    from vietnamese_qa_system_tpu_torch.models import generate as G

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    cfg = ModelConfig(arch="seq2seq", seq2seq_family="bart", vocab_size=250054, d_model=1024, n_heads=16, n_layers=12,
                      n_decoder_layers=12, d_ff=4096, max_seq_len=1024, positional="learned", scale_embedding=True,
                      norm_eps=1e-5, tie_embeddings=True, attention_bias=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_mbart_")
    try:
        t0 = time.perf_counter()
        ref_state, n_bytes = write_s2s_dir(torch, mbart_config_json(cfg), mbart_tensors(cfg), d,
                                           torch.Generator(device="cuda").manual_seed(SEED + 31))
        write_s = time.perf_counter() - t0
        args = build_parser().parse_args(["chat", "--arch", "seq2seq", "--init-params", d])
        t0 = time.perf_counter()
        model = _reader(args.model_size, _tokenizer(args.tokenizer), args.seed, "cuda", args.quantize,
                        args.init_params, args.arch)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = model.state_dict()
    print(f"mbart-large-50-width HF directory ({n_bytes / 1e9:.2f} GB bf16) written in {write_s:.1f} s, loaded "
          f"through chat --arch seq2seq --init-params in {load_s:.1f} s", flush=True)
    check(model.cfg == cfg and sorted(got) == sorted(ref_state) and all(torch.equal(got[k], ref_state[k])
                                                                        for k in ref_state),
          "the imported mBART equals the drawn bf16 values (config from config.json; final_logits_bias zero, so "
          "not kept)")
    del ref_state
    rng = np.random.default_rng(SEED + 32)
    enc = torch.from_numpy(rng.integers(4, cfg.vocab_size, (MBART_ROWS, MBART_PROMPT_LEN)).astype(np.int32)).cuda()
    mask = torch.ones_like(enc)
    mask[1::2, MBART_PROMPT_LEN // 2:] = 0
    enc = enc * mask
    kw = dict(max_new_tokens=MBART_NEW_TOKENS, eos_id=2, bos_id=2, forced_bos_id=MBART_LANG_ID, forced_eos_id=2)
    t_greedy, t_beam = {}, {}
    greedy = G.generate_seq2seq(model, enc, mask, timings=t_greedy, **kw)
    beams = G.beam_search_seq2seq(model, enc, mask, num_beams=BEAM_WIDTH, length_penalty=0.0, timings=t_beam, **kw)

    def logprob(stream):
        """The summed log-probability a row, steps 1.. up to its first eos
        (step 0 is forced), teacher-forced."""
        logp = torch.log_softmax(s2s_teacher_forced(torch, model, enc, mask, stream, 2), dim=-1)
        tok_lp = logp.gather(-1, stream.long()[..., None])[..., 0]
        keep = torch.cumsum((stream == 2).int(), dim=1) - (stream == 2).int() == 0
        keep[:, 0] = False
        return (tok_lp * keep).sum(dim=1)

    lp_g, lp_b = logprob(greedy), logprob(beams)
    step_ms = t_beam["decode_s"] / MBART_NEW_TOKENS * 1e3
    print(f"mbart ({card}) B={MBART_ROWS} T_enc={MBART_PROMPT_LEN}: greedy {MBART_NEW_TOKENS} steps "
          f"{t_greedy['decode_s'] / MBART_NEW_TOKENS * 1e3:.2f} ms a step; W {BEAM_WIDTH} beams {step_ms:.2f} ms a step "
          f"({BEAM_WIDTH * MBART_ROWS} rows); log-probability summed over the batch: beams {lp_b.sum().item():.3f}, "
          f"greedy {lp_g.sum().item():.3f} (rows where beams < greedy: {int((lp_b < lp_g - 1e-3).sum())})", flush=True)
    check(bool((greedy[:, 0] == MBART_LANG_ID).all() and (beams[:, 0] == MBART_LANG_ID).all()),
          f"the forced BOS ({MBART_LANG_ID}) opens every greedy and beam row")
    check(lp_b.sum().item() >= lp_g.sum().item() - 1e-3,
          f"W {BEAM_WIDTH} beams' summed log-probability >= greedy's on the batch")
    card_twin, host_twin = s2s_twin(torch, model, TWIN_LAYERS)
    check_twin_decode(torch, f"mbart twin ({TWIN_LAYERS} + {TWIN_LAYERS} layers, full width)", card_twin, host_twin,
                      enc.cpu(), mask.cpu(), TWIN_NEW_TOKENS, eos_id=2, bos_id=2, forced_bos_id=MBART_LANG_ID)
    print(f"mbart phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return model


def id_tokenizer():
    """The byte tokenizer with a ``decode`` that writes every id (drawn
    weights over a 250k vocabulary mostly produce ids past the byte
    tokenizer's 259, which its own decode drops), so equal strings mean
    equal tokens."""
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        def decode(self, ids):
            return " ".join(str(int(i)) for i in ids)

    return IdTokenizer()


def phase_translate(torch, pkg, mt5, mbart) -> dict:
    """The offline ETL's model-backed translation (etl/translate.py) on the
    card.  mt5-small (the int8c reader of phase_seq2seq_qa, full width,
    with flash): ``translate_texts`` of TRANSLATE_TEXTS drawn passages
    through ``FlakyWrapper(Seq2SeqTranslator(mt5, max_len 256,
    max_new_tokens 32), fail_times=1)`` in chunks of TRANSLATE_CHUNK on
    TRANSLATE_WORKERS threads (every chunk fails once and is resubmitted),
    the strings equal to a one-thread pass over the same chunks, K4 (the
    encoder at T 256) and K6 (the decoder at M 8) launched; texts/s and
    tokens/s.  mBART at mbart-large-50's width: W 4 beams from eos with
    vi_VN's id forced, the strings equal to decoding ``generate_with_config``
    called directly, the forced id never in the text.  Strings spell every
    token id (``id_tokenizer``).  Returns the pooled mt5 run's launches."""
    from vietnamese_qa_system_tpu_torch.data import batch_encode
    from vietnamese_qa_system_tpu_torch.etl.translate import FlakyWrapper, Seq2SeqTranslator, translate_texts
    from vietnamese_qa_system_tpu_torch.models import generate as G

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    tok = id_tokenizer()
    texts = passages(TRANSLATE_TEXTS, SEED + 41)
    dense_cfg = mt5.cfg
    mt5.cfg = dataclasses.replace(dense_cfg, use_flash_attention=True)
    try:
        backend = Seq2SeqTranslator(mt5, tok, max_len=256, max_new_tokens=TRANSLATE_NEW_TOKENS,
                                    prompt="translate {src} to {dst}: {text}")
        flaky = FlakyWrapper(backend, fail_times=1)
        backend.translate_batch(texts[:TRANSLATE_CHUNK], "en", "vi")  # warm: both timed passes run warm
        torch.cuda.synchronize()
        for kern in pkg.KERNELS:
            kern.launches = 0
        t0 = time.perf_counter()
        pooled = translate_texts(texts, flaky, chunk_size=TRANSLATE_CHUNK, max_workers=TRANSLATE_WORKERS)
        torch.cuda.synchronize()
        pooled_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in pkg.KERNELS}
        t0 = time.perf_counter()
        single = translate_texts(texts, backend, chunk_size=TRANSLATE_CHUNK, max_workers=1)
        single_s = time.perf_counter() - t0
    finally:
        mt5.cfg = dense_cfg
    n_chunks = -(-TRANSLATE_TEXTS // TRANSLATE_CHUNK)
    new_tokens = TRANSLATE_TEXTS * TRANSLATE_NEW_TOKENS
    print(f"mt5 translation ({card}): {TRANSLATE_TEXTS} texts in {n_chunks} chunks of {TRANSLATE_CHUNK} on "
          f"{TRANSLATE_WORKERS} threads, every chunk failed once and resubmitted: {pooled_s:.2f} s = "
          f"{TRANSLATE_TEXTS / pooled_s:.1f} texts/s, {new_tokens / pooled_s:.1f} tokens/s ({TRANSLATE_NEW_TOKENS} "
          f"decoder steps a text); one thread {single_s:.2f} s = {TRANSLATE_TEXTS / single_s:.1f} texts/s, "
          f"{new_tokens / single_s:.1f} tokens/s; launches {json.dumps(launches)}", flush=True)
    check(sum(flaky._failures.values()) == n_chunks and len(pooled) == TRANSLATE_TEXTS,
          f"each of the {n_chunks} chunks failed once and was resubmitted; {len(pooled)} strings back")
    check(pooled == single,
          f"the {TRANSLATE_WORKERS}-thread strings equal the one-thread pass over the same chunks, text for text")
    check(launches["flash_attention_fwd"] > 0 and launches["w8_matmul"] > 0,
          f"K4 ({launches['flash_attention_fwd']}; {n_chunks} chunks x {dense_cfg.n_layers} encoder layers expected) "
          f"and K6 ({launches['w8_matmul']}) launched on the translation path")

    mb = Seq2SeqTranslator(mbart, tok, max_len=MBART_PROMPT_LEN, max_new_tokens=MBART_NEW_TOKENS,
                           num_beams=BEAM_WIDTH, bos_id=2, forced_bos_id=MBART_LANG_ID)
    mb_texts = texts[:MBART_ROWS]
    t0 = time.perf_counter()
    got = translate_texts(mb_texts, mb, chunk_size=MBART_ROWS, max_workers=1)
    mb_s = time.perf_counter() - t0
    ids, mask = batch_encode(tok, mb_texts, MBART_PROMPT_LEN)
    out = G.generate_with_config(mbart, ids, mask, G.GenerationConfig(
        max_new_tokens=MBART_NEW_TOKENS, num_beams=BEAM_WIDTH, forced_bos_token_id=MBART_LANG_ID),
        eos_id=tok.eos_id, bos_id=2).cpu().tolist()
    skip = {tok.pad_id, tok.eos_id, MBART_LANG_ID}
    want = [tok.decode([t for t in row if t not in skip]) for row in out]
    print(f"mbart translation ({card}): {MBART_ROWS} texts, W {BEAM_WIDTH} beams, {MBART_NEW_TOKENS} steps in "
          f"{mb_s:.2f} s", flush=True)
    check(got == want and all(row[0] == MBART_LANG_ID for row in out)
          and all(str(MBART_LANG_ID) not in t.split() for t in got),
          f"mBART W {BEAM_WIDTH} translations equal generate_with_config's rows decoded; the forced id "
          f"{MBART_LANG_ID} opens every row and is never in the text")
    print(f"translate phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def export_witness(torch, trained, plain, ids, mask) -> dict:
    """The exported directory against the model it was trained as, by code
    that the export does not run: ``plain`` is the directory loaded back
    through the import half (the file's f32 weights), ``trained`` the
    resumed trainer's model (int8 codes, the LoRA factors applied lazily,
    as in training).  Returns every dense weight's largest error against
    its codes x scale + A @ B over the largest |weight| (``w_rel``), the
    largest |A @ B| on the same scale (``lora_rel``: the fold that a wrong
    export would drop or misplace), and the logits' largest error over
    their largest |logit| at the prompts' valid positions
    (``logit_rel``; right-padded prompts)."""
    from vietnamese_qa_system_tpu_torch.models.layers import Dense

    w_err = w_max = lora_max = 0.0
    with torch.no_grad():
        for name, dense in trained.named_modules():
            if isinstance(dense, Dense) and dense.w_q is not None:
                base = dense.dequantized(torch.float32)
                lora = dense.lora_a.float() @ dense.lora_b.float()
                w_err = max(w_err, (plain.get_submodule(name).w.float() - (base + lora)).abs().max().item())
                w_max = max(w_max, base.abs().max().item())
                lora_max = max(lora_max, lora.abs().max().item())
        valid = mask.bool()
        want = trained(ids, mask)[valid]
        got = plain(ids, mask)[valid]
        logit_rel = (got - want).abs().max().item() / want.abs().max().item()
    return {"w_rel": w_err / w_max, "lora_rel": lora_max / w_max, "logit_rel": logit_rel}


def phase_convert_ckpt(torch, pkg, logdir: str) -> dict:
    """The offline path end to end at PhoGPT-4B's width (CONVERT_LAYERS of
    its 32 layers): ``cli parse --parser alpaca`` over the repo's sample,
    ``cli train`` over the parsed file (int8 base + LoRA, two steps, a
    checkpoint, ``--push-to-hub REPO --push-dry-run``), ``cli convert-ckpt
    --use-lora --quantize-base int8 --format hf`` (an f32 MPT directory;
    seconds, bytes and the process's peak resident set); the file, read
    back through hf_io, holds the export's tensors bit for bit; loaded back
    in f32 it holds the trained model's weights and computes its logits
    (:func:`export_witness`, against the resumed trainer's int8 codes and
    lazy LoRA); the directory loaded as int8c equals the merged model
    quantized the same way and gives its greedy tokens on CONVERT_PROMPTS
    /qa prompts (K6);
    the push manifest lists the export.  Returns the launches of the
    train run (K4 causal, K7) and of the reload's decode (K6)."""
    from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main
    from vietnamese_qa_system_tpu_torch.data import batch_encode
    from vietnamese_qa_system_tpu_torch.data.templates import DEFAULT_BANK
    from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, causal_from_state_dict,
                                                       phogpt_4b_class, quantize_dense_tree)
    from vietnamese_qa_system_tpu_torch.models import convert_hf as C
    from vietnamese_qa_system_tpu_torch.models import generate as G
    from vietnamese_qa_system_tpu_torch.models import hf_io
    from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    here = os.path.dirname(os.path.abspath(__file__))
    parsed = os.path.join(logdir, "parsed")
    rc = cli_main(["parse", "--parser", "alpaca", "--input", os.path.join(here, "examples", "sample_instruct.jsonl"),
                   "--output-dir", parsed])
    data = os.path.join(parsed, "AlpacaParser.jsonl")
    with open(data, encoding="utf-8") as f:
        n_rows = sum(1 for _ in f)
    check(rc == 0 and n_rows > 0, f"cli parse --parser alpaca wrote {n_rows} records")

    cfg = dataclasses.replace(phogpt_4b_class(), n_layers=CONVERT_LAYERS)
    cfg_path = os.path.join(logdir, "convert_model.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    ckpt, runs, out = (os.path.join(logdir, d) for d in ("convert_ckpt", "convert_logs", "convert_hf"))
    for kern in pkg.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    rc = cli_main(["train", "--model-config", cfg_path, "--use-lora", "--quantize-base", "int8", "--remat-policy",
                   "proj_bf16", "--train-files", data, "--max-steps", "2", "--batch-size", "8", "--log-every", "1",
                   "--checkpoint-dir", ckpt, "--save-every-steps", "2", "--log-dir", runs, "--run-name", "convert",
                   "--push-to-hub", CONVERT_REPO, "--push-dry-run"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in pkg.KERNELS}
    with open(os.path.join(runs, "convert.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    print(f"cli train ({cfg.n_layers} of 32 PhoGPT-4B layers, int8 + LoRA, 2 steps, checkpoint, push dry run): exit "
          f"{rc} in {train_s:.1f} s; " + "; ".join(f"step {r['step']} loss {r['loss']:.6f}" for r in logged
                                                   if "loss" in r) + f"; launches {json.dumps(launches)}", flush=True)
    check(rc == 0 and launches["flash_attention_fwd_causal"] > 0 and launches["flash_attention_bwd_dkdv"] > 0
          and launches["flash_attention_bwd_dq"] > 0,
          "cli train over the parsed file exits 0; K4 causal and K7 launched on the step")
    export = os.path.join(runs, "export")
    with open(os.path.join(export, "push_manifest.json")) as f:
        manifest = json.load(f)
    listed = {e["path"]: e["bytes"] for e in manifest["files"]}
    on_disk = {n: os.path.getsize(os.path.join(export, n)) for n in os.listdir(export) if n != "push_manifest.json"}
    print(f"push manifest: {json.dumps({k: v for k, v in manifest.items() if k != 'files'})}, files {listed}",
          flush=True)
    check(listed == on_disk and {"params.npz", "config.json"} <= set(listed) and manifest["repo_id"] == CONVERT_REPO
          and not manifest["pushed"] and manifest["reason"] == "dry run requested",
          "train --push-to-hub --push-dry-run: push_manifest.json lists every file of the export with its size")
    shutil.rmtree(export)

    rss0 = rss_bytes()
    with RssPeak() as peak:
        t0 = time.perf_counter()
        rc = cli_main(["convert-ckpt", "--checkpoint-dir", ckpt, "--out-dir", out, "--model-config", cfg_path,
                       "--use-lora", "--quantize-base", "int8", "--format", "hf"])
        convert_s = time.perf_counter() - t0
    files = sorted(n for n in os.listdir(out) if n != "_logs")
    n_bytes = sum(os.path.getsize(os.path.join(out, n)) for n in files)
    print(f"cli convert-ckpt --format hf ({card}): exit {rc} in {convert_s:.1f} s, {n_bytes / 1e9:.3f} GB written "
          f"({', '.join(files)}); process resident set {rss0 / 1e9:.2f} GB before, peak {peak.peak / 1e9:.2f} GB "
          f"during (+{(peak.peak - rss0) / 1e9:.2f} GB)", flush=True)
    check(rc == 0 and files == ["config.json", "generation_config.json", hf_io.BIN],
          "convert-ckpt wrote config.json, generation_config.json and pytorch_model.bin")

    tcfg = TrainConfig(model=ModelConfig.from_json(cfg.to_json()), lora=LoraConfig(), quantize_base="int8",
                       checkpoint_dir=ckpt, resume=True, seed=42, log_dir=os.path.join(logdir, "convert_check"))
    merged = Trainer(tcfg, total_steps=1, device="cuda").merged_params()
    seen, equal = set(), True
    with hf_io.Checkpoint(out) as written:
        for group in C.export_groups(merged, C.EXPORTERS[C.causal_export_type(cfg)]):
            for name, t in group.items():
                seen.add(name)
                equal = equal and torch.equal(written[name].cuda(), t)
        names = set(written)
    check(equal and seen == names, f"the {len(names)} tensors of the file, read back through hf_io, equal the "
                                   "export's tensors of the resumed model bit for bit (the write and read are lossless)")
    tok = id_tokenizer()
    rng = random.Random(SEED + 51)
    docs = passages(CONVERT_PROMPTS, SEED + 52)
    prompts = [DEFAULT_BANK.render_random("prompt", rng, question=f"{d.split(':')[0]} nói về gì?", context=d)
               for d in docs]
    ids, mask = batch_encode(tok, prompts, CONVERT_PROMPT_LEN, pad_side="left")
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    # right-padded, as in training: the trained model's flash route reads a
    # mask as right padding (kv_lens), as the JAX package's does
    right = [torch.from_numpy(a).cuda() for a in batch_encode(tok, prompts, CONVERT_PROMPT_LEN, pad_side="right")]
    plain = C.load_causal_auto(out)
    witness = export_witness(torch, merged, plain, *right)
    del plain
    print(f"export witness (the f32 reload against the trainer's int8 codes + lazy LoRA): {json.dumps(witness)}",
          flush=True)
    check(witness["w_rel"] <= EXPORT_W_REL_TOL and witness["lora_rel"] >= EXPORT_LORA_MIN * EXPORT_W_REL_TOL
          and witness["logit_rel"] <= EXPORT_LOGIT_REL_TOL,
          f"the export loaded back in f32 holds the trained weights (codes x scale + A @ B within "
          f"{EXPORT_W_REL_TOL} of max |W|, the LoRA term {witness['lora_rel']:.2e} of it) and computes the trained "
          f"model's logits within {EXPORT_LOGIT_REL_TOL} of max |logit| on {CONVERT_PROMPTS} prompts")

    loaded = C.load_causal_auto(out, quantize="int8c")
    ref = causal_from_state_dict(flatten_paths(C.export_tree(merged)), loaded.cfg)
    del merged
    quantize_dense_tree(ref, "int8c")
    got_sd, want_sd = loaded.state_dict(), ref.state_dict()
    check(sorted(got_sd) == sorted(want_sd) and all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd),
          "the export loaded as int8c (load_causal_auto) equals the merged model quantized to int8c, bit for bit")
    for kern in pkg.KERNELS:
        kern.launches = 0
    got = G.generate(loaded, ids, mask, max_new_tokens=CONVERT_NEW_TOKENS, eos_id=tok.eos_id)
    torch.cuda.synchronize()
    reload = {k.name: k.launches for k in pkg.KERNELS}
    want = G.generate(ref, ids, mask, max_new_tokens=CONVERT_NEW_TOKENS, eos_id=tok.eos_id)
    check(torch.equal(got, want) and reload["w8_matmul"] > 0,
          f"greedy tokens of the reloaded int8c export on {CONVERT_PROMPTS} /qa prompts equal the in-memory merged "
          f"model's; K6 launched {reload['w8_matmul']} times")
    del loaded, ref
    shutil.rmtree(out)
    print(f"convert_ckpt phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {name: launches[name] + reload[name] for name in launches}


def s2s_train_batch(rng, b: int, t_enc: int, t_dec: int, vocab: int) -> dict:
    """Seeded encoder ids (right-padded rows) and decoder labels (-100 past
    each row's length)."""
    import numpy as np

    ids = rng.integers(3, vocab, (b, t_enc)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1::2, t_enc - t_enc // 8:] = 0
    labels = rng.integers(3, vocab, (b, t_dec)).astype(np.int32)
    labels[1::2, t_dec - t_dec // 8:] = -100
    return {"input_ids": ids * mask, "attention_mask": mask, "labels": labels}


def phase_seq2seq_train(torch, pkg, logdir: str):
    """mt5-small LoRA over an int8 base with ``use_flash_attention``
    (``train --arch seq2seq --model-config`` JSON; r 8, adamw): three
    Trainer.fit steps of batch 8 x (encoder 512, target 256), so both
    stacks' self-attention takes K4 and K7 with the full relative bias; one
    traced step; then the 2-layer twin's ``cli train --arch seq2seq
    --do-eval --do-generative-eval`` on the card and the host from the same
    HF directory.  Returns the launches of the three steps."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import _train_config, build_parser
    from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main
    from vietnamese_qa_system_tpu_torch.models import LoraConfig, mt5_small_class
    from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer

    t_phase = time.perf_counter()
    cfg_path = os.path.join(logdir, "mt5_flash.json")
    with open(cfg_path, "w") as f:
        f.write(dataclasses.replace(mt5_small_class(), use_flash_attention=True).to_json())
    cfg = _train_config(build_parser().parse_args(["train", "--arch", "seq2seq", "--model-config", cfg_path]))
    tcfg = TrainConfig(model=cfg, lora=LoraConfig(r=8, alpha=16), quantize_base="int8", lr=2e-4, log_every=1,
                       log_dir=logdir, run_name="s2s_train", seed=SEED + 41)
    trainer = Trainer(tcfg, total_steps=S2S_TRAIN_STEPS + 1, device="cuda")
    rng = np.random.default_rng(SEED + 42)
    batches = [s2s_train_batch(rng, S2S_TRAIN_BATCH, S2S_TRAIN_ENC, S2S_TRAIN_DEC, cfg.vocab_size)
               for _ in range(S2S_TRAIN_STEPS + 1)]
    marks, peaks = [], []

    def factory():
        for bt in batches[:S2S_TRAIN_STEPS]:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if len(marks) > 1:
                peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            yield bt

    for kern in pkg.KERNELS:
        kern.launches = 0
    trainer.fit(factory, max_steps=S2S_TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in pkg.KERNELS}
    marks.append(time.perf_counter())
    peaks.append(torch.cuda.max_memory_allocated())
    with open(os.path.join(logdir, "s2s_train.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    step_s = [b - a for a, b in zip(marks, marks[1:])]
    tokens = S2S_TRAIN_BATCH * (S2S_TRAIN_ENC + S2S_TRAIN_DEC)
    for rec, s, peak in zip(logged, step_s, peaks):
        print(f"mt5 train step {rec['step']} ({gpu_name_and_power()}): loss {rec['loss']:.6f}, grad_norm "
              f"{rec['grad_norm']:.6f}, {s:.3f} s, {tokens / s:.1f} tokens/s (encoder + decoder), peak memory "
              f"{peak / 1e9:.2f} GB", flush=True)
    print("launches in the mt5 train run: " + json.dumps(launches), flush=True)
    check(len(logged) == S2S_TRAIN_STEPS and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                                                 for r in logged),
          f"{S2S_TRAIN_STEPS} mt5-small LoRA steps over an int8 base with flash: losses and grad norms finite")
    layers = S2S_TRAIN_STEPS * cfg.n_layers
    check(launches["flash_attention_fwd"] == layers and launches["flash_attention_fwd_causal"] == layers
          and launches["flash_attention_bwd_dkdv"] == 2 * layers and launches["flash_attention_bwd_dq"] == 2 * layers,
          f"K4 launched once an encoder layer (bidirectional) and once a decoder layer (causal), K7 twice a layer pair, "
          f"each step ({json.dumps({k: v for k, v in launches.items() if 'flash' in k})})")
    dev_batch = trainer.device_batch(batches[-1])
    trace_span(torch, f"mt5 train step trace (B={S2S_TRAIN_BATCH}, T_enc={S2S_TRAIN_ENC}, T_dec={S2S_TRAIN_DEC})",
               "train.step", 1, float(np.median(step_s)), lambda: trainer.run_step(dev_batch))
    del trainer, dev_batch
    torch.cuda.empty_cache()

    # the twin's cli train on the card and the host from one HF directory
    twin_cfg = dataclasses.replace(mt5_small_class(), n_layers=TWIN_LAYERS, n_decoder_layers=TWIN_LAYERS)
    twin_dir = os.path.join(logdir, "mt5_twin")
    os.makedirs(twin_dir)
    write_s2s_dir(torch, mt5_config_json(twin_cfg), mt5_tensors(twin_cfg), twin_dir,
                  torch.Generator(device="cuda").manual_seed(SEED + 43), embed_std=1.0)
    twin_json = os.path.join(logdir, "mt5_twin.json")
    with open(twin_json, "w") as f:
        f.write(twin_cfg.to_json())
    sample = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "sample_instruct.jsonl")
    losses = {}
    for device in ("cuda", "cpu"):
        run = f"s2s_twin_{device}"
        argv = ["train", "--arch", "seq2seq", "--model-config", twin_json, "--init-params", twin_dir, "--use-lora",
                "--quantize-base", "int8", "--train-files", sample, "--eval-files", sample, "--max-examples",
                str(TWIN_EVAL_EXAMPLES), "--max-steps", "1", "--batch-size", "4", "--max-len", "256", "--log-every",
                "1", "--log-dir", logdir, "--run-name", run, "--do-eval", "--do-generative-eval", "--max-new-tokens",
                "8", "--device", device]
        t0 = time.perf_counter()
        rc = cli_main(argv)
        with open(os.path.join(logdir, f"{run}.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        preds = glob.glob(os.path.join(logdir, "predictions", f"log_dir_e0_{run}_*.txt"))
        n_pred = open(preds[0]).read().count("### prediction:") if len(preds) == 1 else 0
        losses[device] = next(r["loss"] for r in logged if "loss" in r)
        evals = [r for r in logged if "eval_gen_tokens_per_s" in r]
        print(f"mt5 twin cli train --arch seq2seq --do-eval --do-generative-eval on {device}: exit {rc} in "
              f"{time.perf_counter() - t0:.1f} s, first loss {losses[device]:.6f}, {n_pred} predictions, eval {evals}",
              flush=True)
        check(rc == 0 and n_pred == TWIN_EVAL_EXAMPLES and len(evals) == 1,
              f"the mt5 twin's cli train --arch seq2seq --do-generative-eval on {device} wrote {TWIN_EVAL_EXAMPLES} "
              "predictions and its eval")
    check(abs(losses["cuda"] - losses["cpu"]) <= TWIN_LOSS_TOL * abs(losses["cpu"]),
          f"the twin's first loss (B = 0: the base's) on the card agrees with the host within {TWIN_LOSS_TOL} (relative)")
    print(f"mt5 train phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_t5_flash_kernels(torch, A, gen, report):
    """K4 and K7 against their plain versions at the mt5-small training
    shapes: the encoder's bidirectional self-attention (B 8 x H 6, T 512)
    and the decoder's causal one (T 256), D 64, T5's full (H, T, T)
    relative bias and unscaled scores (their maxima run larger than the
    scaled forms' that FLASH_EDGES draws), right-padded rows; timed beside
    the plain versions and SDPA with the bias and mask as one float mask."""
    t5_flash_check(torch, A, gen, report, T5_FLASH, "t5")


def t5_flash_check(torch, A, gen, report, shapes, prefix: str) -> None:
    """K4 and K7 against their plain versions at each (label, B, H, first
    head, T, D, causal) of ``shapes``: the heads ``[h0, h0 + H)`` of mt5's
    relative bias (a tensor-parallel part reads its slice of the table's
    bias in place), timed beside the plain versions and SDPA; recorded in
    ``report`` under ``{prefix}_encoder`` / ``{prefix}_decoder``."""
    from vietnamese_qa_system_tpu_torch.models.config import mt5_small_class
    from vietnamese_qa_system_tpu_torch.models.encoder import relative_attention_bias
    from vietnamese_qa_system_tpu_torch.models.t5 import full_decoder_bias
    from vietnamese_qa_system_tpu_torch.ops.cuda_kernels import FLASH_BWD_DKDV, FLASH_BWD_DQ

    sdpa = torch.nn.functional.scaled_dot_product_attention
    cfg = mt5_small_class()
    table = torch.randn(cfg.relative_attention_buckets, cfg.n_heads, generator=gen, device="cuda") * 0.5
    for label, b, h, h0, t, d, causal in shapes:
        bh = b * h
        # T5 scale: q and k of unit-variance projections summed unscaled
        q, k, v, do = (torch.randn(bh, t, d, generator=gen, device="cuda") for _ in range(4))
        qb, kb, vb = (q * 0.5).to(torch.bfloat16).contiguous(), k.to(torch.bfloat16), v.to(torch.bfloat16)
        dob = (do * 0.1).to(torch.bfloat16)
        lens = torch.tensor([t - (t // 8 if r % 2 else 0) for r in range(b)], dtype=torch.int32,
                            device="cuda").repeat_interleave(h)
        bias = (full_decoder_bias(table, t, cfg) if causal else relative_attention_bias(table, t, cfg))[0]
        bias = bias.contiguous()[h0:h0 + h]  # a part's heads: a view of the whole bias
        o, lse = A.flash_fwd(qb, kb, vb, lens, bias, h, causal, None)
        po, plse = A.flash_fwd_plain(qb, kb, vb, lens, bias, h, causal, None)
        grads = A.flash_bwd(qb, kb, vb, o, lse, dob, lens, bias, h, causal, None)
        plain = A.flash_bwd_plain(qb, kb, vb, o, lse, dob, lens, bias, h, causal, None)
        torch.cuda.synchronize()
        rows = torch.arange(t, device="cuda")[None, :] < lens[:, None]  # the queries of a row's real tokens
        o_err = ((o.float() - po.float()).abs() * rows[..., None]).max().item()
        lse_err = ((lse - plse).abs() * rows).max().item()
        check(o_err <= FLASH_O_TOL and lse_err <= FLASH_LSE_TOL,
              f"K4 {label} BH={bh} T={t} D={d} causal={causal}, full T5 bias, scale 1: o max abs err {o_err:.2e} <= "
              f"{FLASH_O_TOL}, lse {lse_err:.2e} <= {FLASH_LSE_TOL}")
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
            errs[name] = (got.float() - want.float()).abs().max().item()
            rel = errs[name] / want.float().abs().max().item()
            check(rel <= FLASH_GRAD_REL_TOL and bool(torch.isfinite(got.float()).all()),
                  f"K7 {label} {name}: max abs err {errs[name]:.2e} ({rel:.2e} of max |{name}|) <= {FLASH_GRAD_REL_TOL}")
        pairs = sum(h * (int(n) * (int(n) + 1) // 2 if causal else int(n) * int(n)) for n in lens[::h].tolist())
        tile = bh * t * d * 2
        pos = torch.arange(t, device="cuda")
        keep = (pos[None, None, :] < lens[::h, None, None]) & ((pos[None, :, None] >= pos[None, None, :]) | (not causal))
        mask = (torch.where(keep[:, None], 0.0, float("-inf")) + bias[None]).to(torch.bfloat16)  # (B, H, T, T)
        q4, k4, v4 = (x.view(b, h, t, d) for x in (qb, kb, vb))
        ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q4, k4, v4))
        dol = dob.view(b, h, t, d)

        def sdpa_fwd_bwd():
            out = sdpa(ql, kl, vl, attn_mask=mask, scale=1.0)
            torch.autograd.grad(out, (ql, kl, vl), dol)

        fwd = {
            "ms": cuda_ms(lambda: A.flash_fwd(qb, kb, vb, lens, bias, h, causal, None), 10),
            "plain_ms": cuda_ms(lambda: A.flash_fwd_plain(qb, kb, vb, lens, bias, h, causal, None), 2),
            "library_ms": cuda_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask, scale=1.0), 10),
            # q k v o, lse, the (H, T, T) bias, lens; two products per kept pair
            **bound(4 * tile + bh * t * 4 + h * t * t * 4 + bh * 4, 4 * d * pairs, BF16_OPS_S),
        }
        common, _keep = bwd_launch_args(torch, A, qb, kb, vb, o, lse, dob, lens, bias, h, causal, None)
        dk, dv, dq = torch.empty_like(kb), torch.empty_like(vb), torch.empty_like(qb)
        st = torch.cuda.current_stream().cuda_stream
        lib_bwd = cuda_ms(sdpa_fwd_bwd, 5)
        plain_bwd = cuda_ms(lambda: A.flash_bwd_plain(qb, kb, vb, o, lse, dob, lens, bias, h, causal, None), 2)
        dkdv = {"ms": cuda_ms(lambda: FLASH_BWD_DKDV.launch(*common, dk.data_ptr(), dv.data_ptr(), st), 10),
                "plain_ms": plain_bwd, "library_ms": lib_bwd,
                **bound(6 * tile + 2 * bh * t * 4 + h * t * t * 4, 8 * d * pairs, BF16_OPS_S)}
        dqr = {"ms": cuda_ms(lambda: FLASH_BWD_DQ.launch(*common, dq.data_ptr(), st), 10),
               "plain_ms": plain_bwd, "library_ms": lib_bwd,
               **bound(5 * tile + 2 * bh * t * 4 + h * t * t * 4, 6 * d * pairs, BF16_OPS_S)}
        print(f"K4 {label} ({'causal' if causal else 'bidirectional'}, full bias, BH={bh}, T={t}, D={d}): kernel "
              f"{fwd['ms']:.3f} ms, plain {fwd['plain_ms']:.3f} ms, SDPA fwd {fwd['library_ms']:.3f} ms, bound "
              f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); K7 dK/dV {dkdv['ms']:.3f} ms (bound "
              f"{dkdv['bound_ms']:.4f}, {dkdv['bound_by']}), dQ {dqr['ms']:.3f} ms (bound {dqr['bound_ms']:.4f}, "
              f"{dqr['bound_by']}), plain backward {plain_bwd:.3f} ms, SDPA fwd+bwd {lib_bwd:.3f} ms", flush=True)
        key = f"{prefix}_{'decoder' if causal else 'encoder'}"
        shape = f"BH={bh} (B={b} x H={h}), T={t}, D={d}, {'causal' if causal else 'bidirectional'}, full T5 bias"
        report["flash_attention_fwd_causal" if causal else "flash_attention_fwd"][key] = dict(
            fwd, max_abs_err=o_err, shape=shape)
        report["flash_attention_bwd_dkdv"][key] = dict(dkdv, max_abs_err=max(errs["dk"], errs["dv"]), shape=shape)
        report["flash_attention_bwd_dq"][key] = dict(dqr, max_abs_err=errs["dq"], shape=shape)
        del q, k, v, do, qb, kb, vb, dob, o, lse, po, plse, grads, plain, mask, ql, kl, vl
        torch.cuda.empty_cache()


# ------------------------------------------------------------ sharded serving


def sharded_block(torch, centres, b: int):
    """Block ``b`` of the sharded phase's corpus: SHARDED_BLOCK unit rows
    around the shared ``centres`` (IVF_SIGMA noise, as :func:`clustered`),
    drawn on the card from a generator of its own, so the same rows come
    back on every call."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1000 + b)
    rows = min(SHARDED_BLOCK, SHARDED_N - b * SHARDED_BLOCK)
    pts = centres[torch.randint(0, len(centres), (rows,), generator=g, device="cuda")]
    pts += IVF_SIGMA / D ** 0.5 * torch.randn(rows, D, generator=g, device="cuda")
    return pts / pts.norm(dim=1, keepdim=True)


def sharded_recall(torch, centres, q, ids, k: int, bf16: bool) -> float:
    """bench.py's rank-count rule over the whole SHARDED_N corpus, chunk by
    chunk: an id is a true top-k member iff its score is at least the k-th
    largest (fewer than k rows score strictly higher).  The picked ids'
    scores come out of the same chunked products as the k-th largest, so a
    true member is never lost to a summation order; ``bf16`` scores the
    stored bf16 rows with bf16 queries, else the f32 rows."""
    qr = q.to(torch.bfloat16).float() if bf16 else q.float()
    ids = ids.long()
    picked = torch.full(ids.shape, float("nan"), device="cuda")
    best = None
    for b in range(-(-SHARDED_N // SHARDED_BLOCK)):
        blk = sharded_block(torch, centres, b)
        scores = qr @ (blk.to(torch.bfloat16).float() if bf16 else blk).T
        lo = b * SHARDED_BLOCK
        inside = (ids >= lo) & (ids < lo + len(blk))
        got = torch.gather(scores, 1, (ids - lo).clamp(0, len(blk) - 1))
        picked = torch.where(inside, got, picked)
        top = torch.topk(scores, k, dim=1).values
        best = top if best is None else torch.topk(torch.cat([best, top], dim=1), k, dim=1).values
        del scores, blk
    check(not torch.isnan(picked).any().item(), "every returned id lies in the corpus")
    return (picked >= best[:, k - 1:k]).sum().item() / picked.numel()


def fill_store(torch, store, centres) -> float:
    """Add the corpus block by block; returns the seconds it took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(-(-SHARDED_N // SHARDED_BLOCK)):
        store.add(sharded_block(torch, centres, b))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_sharded(torch, pkg, card: str) -> dict:
    """The corpus-sharded store and IVF index at BASELINE config 4's size
    (10M x 768) over a ``{"shard": 4}`` mesh of the one card, repeated:

    - for bf16 (15.4 GB), int8 and int8_res: the store filled in 1M-row
      blocks (clustered rows drawn on the card; K8 once a shard a block a
      level of the int8 codes), a B 256, k 10 query, its
      recall@10 by the rank-count rule against chunked f32 products on the
      card (bf16 must be 1.000), the scan kernel launched once a shard a
      call (K1 / K2), the ms a call at S = 4 beside S = 1 on the same rows
      (the S = 1 store built after the S = 4 one is freed) and the S = 1
      scores equal to the merged S = 4 ones position for position;
    - an IVF index built over the int8_res store at S = 4 (K5 once a shard
      a call, recall at or above IVF_RECALL_FLOOR).

    One store lives at a time.  Returns the launches of the sharded calls
    (counted from zero)."""
    from vietnamese_qa_system_tpu_torch.core.mesh import SHARD_AXIS, create_mesh
    from vietnamese_qa_system_tpu_torch.engine import IVFIndex, VectorStore
    from vietnamese_qa_system_tpu_torch.ops.cuda_kernels import IVF_PROBE, QUANT_INT8, TOPK_BF16, TOPK_INT8

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = create_mesh({SHARD_AXIS: SHARDS}, devices=["cuda:0"] * SHARDS)
    g = torch.Generator(device="cuda").manual_seed(SEED + 999)
    centres = torch.randn(IVF_CENTRES, D, generator=g, device="cuda")
    centres /= centres.norm(dim=1, keepdim=True)
    first = sharded_block(torch, centres, 0)
    q = perturbed(torch, first[torch.randint(0, len(first), (B,), generator=g, device="cuda")], g)
    del first
    totals = {k.name: 0 for k in pkg.KERNELS}
    scan = {"bf16": TOPK_BF16, "int8": TOPK_INT8, "int8_res": TOPK_INT8}
    floors = {"bf16": 1.0, "int8": SHARDED_INT8_FLOOR, "int8_res": SHARDED_RES_FLOOR}
    for dt in SHARDED_DTYPES:
        results = {}
        for s in (SHARDS, 1):
            store = VectorStore(SHARDED_N, D, dtype=dt, device="cuda", mesh=mesh if s > 1 else None)
            for kern in pkg.KERNELS:
                kern.launches = 0
            fill_s = fill_store(torch, store, centres)
            torch.cuda.synchronize()
            blocks = -(-SHARDED_N // SHARDED_BLOCK)
            k8 = {"bf16": 0, "int8": 1, "int8_res": 2}[dt] * s * blocks
            check(QUANT_INT8.launches == k8, f"quantize_int8 launched {k8} times filling the {s}-shard {dt} store "
                                             f"({QUANT_INT8.launches}: once a shard a block a level)")
            if s > 1:
                totals[QUANT_INT8.name] += QUANT_INT8.launches
            for kern in pkg.KERNELS:
                kern.launches = 0
            scores, ids = store.topk(q, K)
            calls = 1 + 1 + SHARDED_ITERS  # the checked call, cuda_ms's warm-up, its timed calls
            ms = cuda_ms(lambda: store.topk(q, K), SHARDED_ITERS)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in pkg.KERNELS}
            check(launches[scan[dt].name] == s * calls,
                  f"{scan[dt].name} launched once a shard a call on the {s}-shard {dt} store "
                  f"({launches[scan[dt].name]} for {calls} calls)")
            if s > 1:
                for name, n in launches.items():
                    totals[name] += n
            results[s] = scores, ids, ms, fill_s
            if s == 1:
                store_gb = sum(t.numel() * t.element_size() for t in (store.slabs[0].vectors, store.slabs[0].scales,
                                                                       store.slabs[0].res_vectors,
                                                                       store.slabs[0].res_scales) if t is not None)
            if s > 1 and dt == "int8_res":
                t0 = time.perf_counter()
                ivf = IVFIndex.build(store)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                del store
                torch.cuda.empty_cache()
                for kern in pkg.KERNELS:
                    kern.launches = 0
                _, ivf_ids = ivf.topk(q, K)
                ivf_ms = cuda_ms(lambda: ivf.topk(q, K), SHARDED_ITERS)
                torch.cuda.synchronize()
                ivf_launches = {k.name: k.launches for k in pkg.KERNELS}
                check(ivf_launches[IVF_PROBE.name] == SHARDS * calls,
                      f"ivf_probe_scores launched once a shard a call on the {SHARDS}-shard IVF index "
                      f"({ivf_launches[IVF_PROBE.name]} for {calls} calls)")
                for name, n in ivf_launches.items():
                    totals[name] += n
                rec = sharded_recall(torch, centres, q, ivf_ids, K, bf16=False)
                print(f"sharded IVF int8_res over {SHARDED_N} x {D}, S={SHARDS}: build {build_s:.2f} s, "
                      f"{ivf.n_clusters} clusters x cap {ivf.cap} a shard, {ivf.spill_count} spilled; B={B} k={K} "
                      f"nprobe {ivf.nprobe}: {ivf_ms:.4f} ms a call, recall@{K} {rec:.4f} ({card})", flush=True)
                check(rec >= IVF_RECALL_FLOOR, f"sharded IVF int8_res recall@{K} {rec:.4f} >= {IVF_RECALL_FLOOR}")
                print(f"peak card memory of the 4-shard int8_res store and its IVF index: "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})", flush=True)
                del ivf
            else:
                del store
            torch.cuda.empty_cache()
        (s4, i4, ms4, fill4), (s1, _, ms1, fill1) = results[SHARDS], results[1]
        rec = sharded_recall(torch, centres, q, i4, K, bf16=dt == "bf16")
        print(f"sharded store {dt} {SHARDED_N} x {D} ({store_gb / 1e9:.1f} GB): B={B} k={K} S={SHARDS} "
              f"{ms4:.4f} ms a call, S=1 {ms1:.4f} ms (filled in {fill4:.1f} / {fill1:.1f} s), recall@{K} "
              f"{rec:.4f} ({card})", flush=True)
        check(rec >= floors[dt], f"sharded {dt} recall@{K} {rec:.4f} >= {floors[dt]}")
        err = (s4 - s1).abs().max().item()
        check(err <= SHARDED_SCORE_TOL, f"the {SHARDS}-shard merge's {dt} scores equal the one-shard scan's position "
                                        f"for position (max |diff| {err:.2e})")
    print(f"peak card memory of the sharded phase: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return totals


class NoRetrieval:
    """The retriever of the TP phase's app: each question's own text as its
    one context, so /qa exercises the reader alone."""

    class store:  # noqa: N801 -- an attribute namespace
        size = 0

    def search(self, queries, k):
        from vietnamese_qa_system_tpu_torch.engine import SearchResult

        return [[SearchResult(id=0, score=1.0, doc=q, source="question")] for q in queries]


def phase_tp(torch, pkg, card: str) -> dict:
    """The tensor-parallel reader at PhoGPT-4B width (TP_LAYERS of its 32 layers, d 3072, 24
    heads, vocabulary 20,480; drawn bf16 weights) split ``tp`` over a
    ``{"model": 4}`` mesh of the one card repeated (6 heads a device), as
    ``serve --reader-strategy tp`` builds it:

    - /qa over HTTP at B 8 (``QAPipeline`` with serve's default
      prompt-lookup speculation), every row held to the unsharded reader's
      plain greedy decode of the same batch by the margin rule;
    - a /generate burst through the continuous engine ``serve
      --continuous-slots 8`` builds over the TP reader, each stream held to
      the unsharded reader's B=1 ``generate()`` by the margin rule; its
      prefills attend through the split cache, as JAX's engine does (the
      flash route is the cache-less forward's);
    - decode ms a step and tokens/s of B 8 greedy ``generate()``, TP beside
      unsharded (one card: the split runs four devices' work in turn).

    Returns the launches of the TP runs (counted from zero), the TP reader
    and the unsharded one (phase_tp_adapters serves a bank over them)."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import build_parser, continuous_engine
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.core.mesh import MODEL_AXIS, create_mesh
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.engine import QAPipeline, ServingApp
    from vietnamese_qa_system_tpu_torch.models import init_causal_lm, phogpt_4b_class
    from vietnamese_qa_system_tpu_torch.models import generate as G
    from vietnamese_qa_system_tpu_torch.parallel.sharding import shard_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tok = ByteTokenizer()
    cfg = dataclasses.replace(phogpt_4b_class(), n_layers=TP_LAYERS)
    reader = init_causal_lm(cfg, make_generator(SEED + 31, "cuda")).to(torch.bfloat16)
    args = build_parser().parse_args(["serve", "--index", "-", "--db", ":memory:", "--reader-size", "phogpt4b",
                                      "--reader-strategy", "tp",
                                      "--max-new-tokens", str(TP_NEW), *TP_ENGINE_FLAGS])
    check(args.reader_strategy == "tp", "serve --reader-strategy tp parses")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # serve's --reader-strategy takes every visible GPU; this machine has
    # one, so the {"model": 4} mesh repeats it
    tp = shard_params(reader, create_mesh({MODEL_AXIS: TP_DEVICES}, devices=["cuda:0"] * TP_DEVICES),
                      args.reader_strategy)
    torch.cuda.synchronize()
    print(f"TP reader: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab_size}, split "
          f"over {TP_DEVICES} devices in {time.perf_counter() - t0:.2f} s; heads a device {tp.groups[0][1]}", flush=True)
    check(tp.groups is not None and len(tp.groups) == TP_DEVICES and tp.embed_parts is not None
          and len(tp.blocks[0].mlp.parts) == TP_DEVICES,
          "the TP reader splits heads, the MLP hidden and the vocabulary over the 4 devices")

    # /qa at B 8, as serve builds it (prompt-lookup speculation by default)
    rng = np.random.default_rng(SEED + 5)
    questions = [engine_text(rng, TP_PROMPT) for _ in range(TP_QA_ROWS)]
    calls = []
    real_spec = G.generate_speculative

    def recorded(model, ids, mask, **kw):
        out = real_spec(model, ids, mask, **kw)
        calls.append((ids, mask, out))
        return out

    qa = QAPipeline(NoRetrieval(), tp, tok, k=1, max_prompt_len=2 * TP_PROMPT, max_new_tokens=TP_NEW,
                    speculative=args.speculative, draft_tokens=args.draft_tokens, draft_ngram=args.draft_ngram)
    app = ServingApp(NoRetrieval(), qa, k=1, max_batch=TP_QA_ROWS, max_wait_s=2.0)
    url, stop = serve(app)
    G.generate_speculative = recorded
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        answers = ask_all(url, "/qa", [{"question": x} for x in questions])
        torch.cuda.synchronize()
        qa_launches = {k.name: k.launches for k in pkg.KERNELS}
    finally:
        G.generate_speculative = real_spec
        stop()
    check(all(a is not None and "answer" in a for a in answers) and len(calls) == 1
          and calls[0][0].shape[0] == TP_QA_ROWS, f"{TP_QA_ROWS} concurrent /qa over the TP reader answered as one "
                                                   "speculative batch")
    ids, mask, got = calls[0]
    want = G.generate(reader, ids, mask, max_new_tokens=TP_NEW, eos_id=tok.eos_id)
    agree, equal, others = batch_margin_rule(torch, reader, ids, mask, got, want, tok.eos_id)
    check(agree, f"TP /qa rows equal the unsharded reader's greedy decode by the margin rule ({equal}/{TP_QA_ROWS} "
                 f"token for token; others (tokens, steps compared): {others})")

    # /generate: the continuous engine serve builds over the TP reader
    engine = continuous_engine(args, tp, tok, "cuda")
    gapp = ServingApp(NoRetrieval(), gen=engine, tokenizer=tok, k=1, max_wait_s=0.02)
    url, stop = serve(gapp)
    lens = rng.integers(TP_ENGINE_PROMPT[0], TP_ENGINE_PROMPT[1] + 1, TP_ENGINE_REQUESTS)
    prompts = [engine_text(rng, int(n)) for n in lens]
    try:
        for kern in pkg.KERNELS:
            kern.launches = 0
        t0 = time.perf_counter()
        outs = ask_all(url, "/generate", [{"prompt": p, "max_new_tokens": TP_ENGINE_NEW} for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gen_launches = {k.name: k.launches for k in pkg.KERNELS}
    finally:
        stop()
    check(all(o is not None for o in outs), f"{TP_ENGINE_REQUESTS} concurrent /generate over the TP reader answered")
    n_tok, ok_rows = 0, 0
    for p, o in zip(prompts, outs):
        pid = tok.encode(p)
        want = graph_greedy_reference(torch, reader, pid, bucket_of(engine.buckets, len(pid)), len(o["ids"]),
                                      tok.eos_id, label="tp")
        agree, _ = margin_rule(torch, reader, pid, o["ids"], want)
        ok_rows += agree
        n_tok += len(o["ids"])
    check(ok_rows == len(prompts), f"TP /generate streams equal the unsharded B=1 generate() by the margin rule "
                                   f"({ok_rows}/{len(prompts)})")
    print(f"TP /generate: {TP_ENGINE_REQUESTS} requests, {n_tok} tokens in {wall:.2f} s ({n_tok / wall:.1f} tokens/s, "
          f"host-paced) ({card})", flush=True)

    # decode ms a step, B 8 greedy generate(): TP beside unsharded
    x, m = ids, mask
    rows = {}
    for name, model in (("tp", tp), ("unsharded", reader)):
        t = {}
        G.generate(model, x, m, max_new_tokens=TP_NEW, timings=t)  # warm-up
        G.generate(model, x, m, max_new_tokens=TP_NEW, timings=t)
        rows[name] = (t["decode_s"] / (TP_NEW - 1) * 1e3, TP_QA_ROWS * TP_NEW / (t["prefill_s"] + t["decode_s"]))
    print(f"B={TP_QA_ROWS} greedy generate(), {TP_NEW} new tokens after {x.shape[1]}-token prompts: TP "
          f"{rows['tp'][0]:.2f} ms a decode step, {rows['tp'][1]:.1f} tokens/s; unsharded {rows['unsharded'][0]:.2f} ms, "
          f"{rows['unsharded'][1]:.1f} tokens/s (the TP split's {TP_DEVICES} devices are one card here) ({card})",
          flush=True)
    launches = {name: qa_launches[name] + gen_launches[name] for name in qa_launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"TP phase {time.perf_counter() - t_phase:.1f} s; peak card memory {peak:.2f} GiB ({card})", flush=True)
    return launches, tp, reader



def generate_burst(torch, tok, engine, payloads: list) -> tuple[list, float, dict]:
    """POST every payload to /generate of an app over ``engine`` at once;
    returns the answers, the wall seconds and the engine's stats.  The app
    and the engine are closed after."""
    from vietnamese_qa_system_tpu_torch.engine import ServingApp

    url, stop = serve(ServingApp(NoRetrieval(), gen=engine, tokenizer=tok, k=1, max_wait_s=0.02))
    try:
        t0 = time.perf_counter()
        outs = ask_all(url, "/generate", payloads)
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0, engine.snapshot_stats()
    finally:
        stop()


def s2s_stream_rule(torch, reader, prompt: list, width: int, got: list, want: list) -> tuple[bool, int]:
    """A seq2seq /generate stream ``got`` against the reference stream
    ``want`` of the same prompt, right-padded to ``width``: equal over
    their common length up to the first step whose top-2 margin of
    ``reader`` teacher-forced on ``want`` is below TWIN_LOGIT_TOL."""
    n = min(len(got), len(want))
    if got == want:
        return True, n
    x = torch.zeros((1, width), dtype=torch.int32, device="cuda")
    m = torch.zeros_like(x)
    x[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    m[0, :len(prompt)] = 1
    agree, until = s2s_margin_rule(torch, reader, x, m, torch.tensor([got[:n]]), torch.tensor([want[:n]]), 0)
    return agree, until[0]


def phase_tp_seq2seq(torch, pkg, mt5_dir: str, mbart, report) -> dict:
    """The tensor-parallel seq2seq readers, as ``serve --reader-strategy
    tp`` builds them, over meshes of the one card repeated:

    - mt5-small loaded through ``serve --reader-params`` from the bf16 HF
      directory phase_seq2seq_qa wrote (no quantization: TP readers are
      float), the flash route on, split over {"model": 2} (3 heads a
      device: K4 runs a part) and {"model": 4} (6 heads do not divide over
      4: attention whole on the lead, the FFN hidden and the vocabulary
      split).  At each: /qa at B 8 of 512-token prompts, every row held
      to the unsharded reader's greedy decode by the margin rule, K4
      launched once a part (or once) an encoder layer; 16 concurrent
      /generate through serve's seq2seq engine, each stream held to the
      unsharded engine's by the margin rule; the ms of a decode step;
    - K4 against its plain version at a part's shape (3 heads over the
      second part's slice of the 6-head relative bias), timed beside the
      plain version and SDPA;
    - mBART at mbart-large-50's width (phase_mbart's model) over
      {"model": 4}: 16 heads split 4 a device, the vocabulary (250,054)
      and fc1 / fc2 whole as JAX's rules leave them; B 8 greedy decode of
      32 tokens against the unsharded model, and the ms of a decode step
      beside it.

    Returns the launches of the TP /qa and /generate runs."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import _reader, build_parser, continuous_engine
    from vietnamese_qa_system_tpu_torch.core.mesh import MODEL_AXIS, create_mesh
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.engine import QAPipeline, ServingApp
    from vietnamese_qa_system_tpu_torch.models import generate as G
    from vietnamese_qa_system_tpu_torch.models.encoder import relative_attention_bias
    from vietnamese_qa_system_tpu_torch.ops import attention as A
    from vietnamese_qa_system_tpu_torch.parallel.sharding import shard_params

    t_phase = time.perf_counter()
    card = gpu_name_and_power()
    tok = ByteTokenizer()
    args = build_parser().parse_args(["serve", "--index", "-", "--db", ":memory:", "--reader-size", "mt5small",
                                      "--reader-params", mt5_dir, "--reader-strategy", "tp", "--max-new-tokens",
                                      str(READER_NEW_TOKENS), *S2S_ENGINE_FLAGS])
    t0 = time.perf_counter()
    reader = _reader(args.reader_size, tok, args.seed + 1, "cuda", args.reader_quantize, args.reader_params)
    # the flash route of phase_seq2seq_qa's second run: the 512-token encoder through K4
    reader.cfg = cfg = dataclasses.replace(reader.cfg, use_flash_attention=True)
    torch.cuda.synchronize()
    check(reader.dec_blocks[0].cross_attn.wq.w is not None and reader.lm_head.w is not None,
          f"mt5-small loaded as a float reader from phase_seq2seq_qa's bf16 directory "
          f"({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(SEED + 41)
    questions = [engine_text(rng, TP_S2S_QUESTION) for _ in range(READER_QUESTIONS)]
    payloads = [{"prompt": engine_text(rng, int(rng.integers(*S2S_ENGINE_PROMPT, endpoint=True))),
                 "max_new_tokens": int(rng.integers(*TP_S2S_NEW, endpoint=True))} for _ in range(TP_S2S_REQUESTS)]
    # the unsharded engine's streams: what every TP stream is held to
    ref_outs, ref_wall, _ = generate_burst(torch, tok, continuous_engine(args, reader, tok, "cuda"), payloads)
    check(all(isinstance(o, dict) for o in ref_outs), f"{TP_S2S_REQUESTS} /generate over the unsharded mt5 answered")
    ref_tokens = sum(len(o["ids"]) for o in ref_outs)
    print(f"mt5 /generate over the unsharded bf16 reader ({card}): {TP_S2S_REQUESTS} requests, {ref_tokens} tokens in "
          f"{ref_wall:.2f} s ({ref_tokens / ref_wall:.1f} tokens/s)", flush=True)
    launches = {k.name: 0 for k in pkg.KERNELS}
    step_ms, qa_batch = {}, None
    real = G.generate_seq2seq
    for n in TP_S2S_MESHES:
        t0 = time.perf_counter()
        tp = shard_params(reader, create_mesh({MODEL_AXIS: n}, devices=["cuda:0"] * n), args.reader_strategy)
        torch.cuda.synchronize()
        split = tp.groups is not None
        check(split == (cfg.n_heads % n == 0) and len(tp.enc_blocks[0].mlp.parts) == n
              and tp.embed_parts is not None and tp.head_parts is not None,
              f"mt5 over {{'model': {n}}} in {time.perf_counter() - t0:.1f} s: attention "
              f"{f'split, {cfg.n_heads // n} heads a device' if split else 'whole on the lead device'}; the FFN "
              f"hidden, the vocabulary and the untied head split")
        calls = []

        def recorded(model, ids, mask, **kw):
            out = real(model, ids, mask, **kw)
            calls.append((ids, mask, out))
            return out

        qa = QAPipeline(NoRetrieval(), tp, tok, k=1, max_prompt_len=READER_PROMPT_LEN,
                        max_new_tokens=READER_NEW_TOKENS)
        url, stop = serve(ServingApp(NoRetrieval(), qa, k=1, max_batch=READER_QUESTIONS, max_wait_s=2.0))
        G.generate_seq2seq = recorded
        try:
            for kern in pkg.KERNELS:
                kern.launches = 0
            t0 = time.perf_counter()
            answers = ask_all(url, "/qa", [{"question": q} for q in questions])
            torch.cuda.synchronize()
            qa_wall = time.perf_counter() - t0
            qa_launches = {k.name: k.launches for k in pkg.KERNELS}
        finally:
            G.generate_seq2seq = real
            stop()
        check(all(a is not None and "answer" in a for a in answers) and len(calls) == 1
              and tuple(calls[0][0].shape) == (READER_QUESTIONS, READER_PROMPT_LEN),
              f"{READER_QUESTIONS} concurrent /qa over the TP mt5 answered as one batch of {READER_PROMPT_LEN}-token "
              f"prompts")
        ids, mask, got = qa_batch = calls[0]
        want = real(reader, ids, mask, max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id)
        agree, until = s2s_margin_rule(torch, reader, ids, mask, got, want, 0)
        err = (s2s_teacher_forced(torch, tp, ids, mask, want, 0)
               - s2s_teacher_forced(torch, reader, ids, mask, want, 0)).abs().max().item()
        check(agree and err <= TWIN_LOGIT_TOL,
              f"TP mt5 /qa rows ({{'model': {n}}}) equal the unsharded reader's greedy decode by the margin rule "
              f"(compared up to steps {until}; {int((got == want).all(dim=1).sum())}/{READER_QUESTIONS} token for "
              f"token); teacher-forced logits within {err:.2e} of the unsharded reader's (<= {TWIN_LOGIT_TOL})")
        k4 = qa_launches["flash_attention_fwd"]
        check(k4 == (n if split else 1) * cfg.n_layers,
              f"K4 launched {k4} times on the TP /qa path: once {'a part and' if split else 'on the lead an'} "
              f"encoder layer")
        engine = continuous_engine(args, tp, tok, "cuda")
        buckets = engine.buckets
        for kern in pkg.KERNELS:
            kern.launches = 0
        outs, wall, stats = generate_burst(torch, tok, engine, payloads)
        gen_launches = {k.name: k.launches for k in pkg.KERNELS}
        check(all(isinstance(o, dict) for o in outs), f"{TP_S2S_REQUESTS} concurrent /generate over the TP mt5 "
                                                      f"answered")
        agree, compared = [], []
        for p, o, r in zip(payloads, outs, ref_outs):
            pid = tok.encode(p["prompt"])
            ok, u = s2s_stream_rule(torch, reader, pid, bucket_of(buckets, len(pid)), o["ids"], r["ids"])
            agree.append(ok)
            compared.append(u)
        same = sum(o["ids"] == r["ids"] for o, r in zip(outs, ref_outs))
        check(all(agree), f"TP mt5 /generate streams ({{'model': {n}}}) equal the unsharded engine's by the margin "
                          f"rule ({same}/{len(outs)} token for token; compared up to steps {compared})")
        n_tok = sum(len(o["ids"]) for o in outs)
        t = {}
        real(tp, ids, mask, max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id, timings=t)
        step_ms[n] = t["decode_s"] / READER_NEW_TOKENS * 1e3
        print(f"TP mt5 {{'model': {n}}} ({card}): /qa B {READER_QUESTIONS} in {qa_wall:.2f} s, K4 launches {k4}; "
              f"/generate {TP_S2S_REQUESTS} requests, {n_tok} tokens in {wall:.2f} s ({n_tok / wall:.1f} tokens/s, "
              f"mean occupancy {stats['avg_occupancy']} of 8 slots); B {READER_QUESTIONS} greedy generate_seq2seq "
              f"{step_ms[n]:.2f} ms a decode step", flush=True)
        for name in launches:
            launches[name] += qa_launches[name] + gen_launches[name]
        del tp, engine, qa
        torch.cuda.empty_cache()
    ids, mask, _ = qa_batch
    t = {}
    real(reader, ids, mask, max_new_tokens=READER_NEW_TOKENS, eos_id=tok.eos_id, timings=t)
    step_ms[1] = t["decode_s"] / READER_NEW_TOKENS * 1e3
    print(f"mt5 B {READER_QUESTIONS} greedy decode step ({card}): unsharded {step_ms[1]:.2f} ms; "
          + "; ".join(f"{{'model': {n}}} {step_ms[n]:.2f} ms" for n in TP_S2S_MESHES)
          + " (the split's devices are one card here)", flush=True)

    # K4 at a part's shape: the second part's 3 heads and its slice of the 6-head bias
    b, h, t_enc, d = READER_QUESTIONS, cfg.n_heads // 2, READER_PROMPT_LEN, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    with torch.inference_mode():
        # as the flash wrapper receives it from TPAttention: heads h.. of the whole bias, made contiguous
        part_bias = relative_attention_bias(reader.enc_rel_bias, t_enc, cfg)[0, h:].float().contiguous()
    lens = mask.sum(dim=1).to(torch.int32).repeat_interleave(h)
    qb, kb, vb = ((torch.randn(b * h, t_enc, d, generator=gen, device="cuda") * (0.5 if j == 0 else 1.0))
                  .to(torch.bfloat16) for j in range(3))
    o, _ = A.flash_fwd(qb, kb, vb, lens, part_bias, h, False, None)
    po, _ = A.flash_fwd_plain(qb, kb, vb, lens, part_bias, h, False, None)
    rows = torch.arange(t_enc, device="cuda")[None, :] < lens[:, None]
    err = ((o.float() - po.float()).abs() * rows[..., None]).max().item()
    check(err <= FLASH_O_TOL, f"K4 at a TP part's shape (BH {b * h}, T {t_enc}, D {d}, the part's bias slice): o max "
                              f"abs err {err:.2e} <= {FLASH_O_TOL}")
    pairs = sum(h * int(x) * int(x) for x in lens[::h].tolist())
    pos = torch.arange(t_enc, device="cuda")
    keep = pos[None, None, :] < lens[::h, None, None]
    sdpa_mask = (torch.where(keep[:, None], 0.0, float("-inf")) + part_bias[None]).to(torch.bfloat16)
    q4, k4_, v4 = (x.view(b, h, t_enc, d) for x in (qb, kb, vb))
    part = {
        "ms": cuda_ms(lambda: A.flash_fwd(qb, kb, vb, lens, part_bias, h, False, None), 10),
        "plain_ms": cuda_ms(lambda: A.flash_fwd_plain(qb, kb, vb, lens, part_bias, h, False, None), 2),
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4_, v4, attn_mask=sdpa_mask, scale=1.0), 10),
        **bound(4 * b * h * t_enc * d * 2 + b * h * t_enc * 4 + h * t_enc * t_enc * 4 + b * h * 4, 4 * d * pairs,
                BF16_OPS_S),
    }
    print(f"K4 TP mt5 part (bidirectional, the part's bias slice, BH={b * h}, T={t_enc}, D={d}; {card}): kernel "
          f"{part['ms']:.3f} ms, plain {part['plain_ms']:.3f} ms, SDPA {part['library_ms']:.3f} ms, bound "
          f"{part['bound_ms']:.4f} ms ({part['bound_by']})", flush=True)
    report["flash_attention_fwd"]["tp_t5_part"] = dict(
        part, max_abs_err=err, shape=f"BH={b * h} (B={b} x H={h}), T={t_enc}, D={d}, bidirectional, a TP part's "
                                     f"slice of the T5 bias")
    del qb, kb, vb, o, po, sdpa_mask, q4, k4_, v4, reader
    torch.cuda.empty_cache()

    # mBART at mbart-large-50's width over {"model": 4}
    mc = mbart.cfg
    t0 = time.perf_counter()
    mtp = shard_params(mbart, create_mesh({MODEL_AXIS: MBART_TP_DEVICES}, devices=["cuda:0"] * MBART_TP_DEVICES),
                       "tp")
    torch.cuda.synchronize()
    check(mtp.groups is not None and mtp.embed_parts is None and not hasattr(mtp.enc_blocks[0].mlp, "parts"),
          f"mBART over {{'model': {MBART_TP_DEVICES}}} in {time.perf_counter() - t0:.1f} s: "
          f"{mc.n_heads // MBART_TP_DEVICES} heads a device in every attention; the vocabulary ({mc.vocab_size}) and "
          f"fc1 / fc2 whole, as JAX's rules leave them")
    rng = np.random.default_rng(SEED + 43)
    enc = torch.from_numpy(rng.integers(4, mc.vocab_size, (MBART_ROWS, MBART_PROMPT_LEN)).astype(np.int32)).cuda()
    emask = torch.ones_like(enc)
    emask[1::2, MBART_PROMPT_LEN // 2:] = 0
    enc = enc * emask
    kw = dict(max_new_tokens=MBART_NEW_TOKENS, eos_id=2, bos_id=2)
    outs, ms = {}, {}
    for name, model in (("tp", mtp), ("unsharded", mbart)):
        t = {}
        outs[name] = real(model, enc, emask, timings=t, **kw)
        ms[name] = t["decode_s"] / MBART_NEW_TOKENS * 1e3
    agree, until = s2s_margin_rule(torch, mbart, enc, emask, outs["tp"], outs["unsharded"], 2)
    same = int(sum(torch.equal(a, b) for a, b in zip(outs["tp"].cpu(), outs["unsharded"].cpu())))
    err = (s2s_teacher_forced(torch, mtp, enc, emask, outs["unsharded"], 2)
           - s2s_teacher_forced(torch, mbart, enc, emask, outs["unsharded"], 2)).abs().max().item()
    check(agree and err <= TWIN_LOGIT_TOL,
          f"TP mBART greedy rows equal the unsharded model's by the margin rule ({same}/{MBART_ROWS} token for "
          f"token; compared up to steps {until}); teacher-forced logits within {err:.2e} (<= {TWIN_LOGIT_TOL})")
    print(f"mBART B {MBART_ROWS} greedy decode ({card}): TP {{'model': {MBART_TP_DEVICES}}} {ms['tp']:.2f} ms a step, "
          f"unsharded {ms['unsharded']:.2f} ms (the split's devices are one card here)", flush=True)
    del mtp
    torch.cuda.empty_cache()
    print(f"TP seq2seq phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_tp_adapters(torch, pkg, tp, reader, card: str) -> dict:
    """Multi-LoRA serving over the TP reader phase_tp built (PhoGPT-4B
    width, bf16, {"model": 4} of the one card): three adapters drawn as
    phase_adapters draws them, written as adapter.npz and loaded through
    ``serve --reader-strategy tp --continuous-slots 8 --adapter ...``
    (each split part holds its slice of the bank on its device); 8
    concurrent /generate, two each for the base and the three adapters,
    once with plain chunks and once with n-gram speculative chunks
    (``--gen-speculative off|ngram``), every stream held by the margin rule
    to the unsharded engine with the same bank on the same requests,
    tokens/s beside it; a speculative chunk of 8 slots under bank indices
    0-3 traced with no host synchronisation allowed, and its device busy
    ms.  Returns the launches of the TP runs."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import build_parser, continuous_engine
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.models import LoraConfig, init_lora
    from vietnamese_qa_system_tpu_torch.models import decode_engine as de
    from vietnamese_qa_system_tpu_torch.train.checkpoint import save_pytree
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

    t_phase = time.perf_counter()
    tok, cfg = ByteTokenizer(), reader.cfg
    rng = np.random.default_rng(SEED + 44)
    names = [None, *ADAPTER_NAMES] * 2
    payloads = []
    for name in names:
        p = {"prompt": engine_text(rng, int(rng.integers(*TP_ENGINE_PROMPT, endpoint=True))),
             "max_new_tokens": int(rng.integers(*TP_ADAPTER_NEW, endpoint=True))}
        payloads.append(p if name is None else dict(p, adapter=name))
    launches = {k.name: 0 for k in pkg.KERNELS}
    results, banks = {}, {}
    d = tempfile.mkdtemp(prefix="chip_smoke_tp_adapters_")
    try:
        flags = []
        for i, name in enumerate(ADAPTER_NAMES):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 30 + i)
            adapter = init_lora(gen, reader, LoraConfig())
            with torch.no_grad():
                for path, leaf in flatten_paths(adapter).items():
                    if path.endswith(".b"):
                        leaf.normal_(0.0, ADAPTER_B_STD, generator=gen)
            os.makedirs(os.path.join(d, name))
            save_pytree(os.path.join(d, name, "adapter.npz"), adapter)
            flags += ["--adapter", f"{name}={os.path.join(d, name, 'adapter.npz')}"]
        del adapter
        for spec in ("off", "ngram"):
            args = build_parser().parse_args(["serve", "--index", "-", "--db", ":memory:", "--reader-size", "phogpt4b",
                                              "--reader-strategy", "tp", *TP_ENGINE_FLAGS, "--gen-speculative", spec,
                                              *flags])
            for label, model in (("unsharded", reader), ("tp", tp)):
                engine = continuous_engine(args, model, tok, "cuda")
                banks[label] = engine._bank
                for kern in pkg.KERNELS:
                    kern.launches = 0
                results[spec, label] = generate_burst(torch, tok, engine, payloads)
                check(all(isinstance(o, dict) for o in results[spec, label][0]),
                      f"8 concurrent /generate under (base, a, b, c) x 2 over the {label} reader answered "
                      f"(--gen-speculative {spec})")
                if label == "tp":
                    for kern in pkg.KERNELS:
                        launches[kern.name] += kern.launches
    finally:
        shutil.rmtree(d, ignore_errors=True)
    tp_parts = sum(1 for m in banks["tp"] if m.__class__.__name__ == "Dense")
    check(tp_parts == len(banks["unsharded"]) * len(tp.devices),
          f"the bank laid onto the TP reader: {tp_parts} split parts (each of the unsharded reader's "
          f"{len(banks['unsharded'])} adapted layers a part a device) and "
          f"{len(banks['tp']) - tp_parts} row-parallel layers holding B")
    ids = [tok.encode(p["prompt"]) for p in payloads]
    for spec in ("off", "ngram"):
        (outs, wall, stats), (ref_outs, ref_wall, ref_stats) = results[spec, "tp"], results[spec, "unsharded"]
        check((stats["spec_chunks"] > 0) == (spec == "ngram"),
              f"--gen-speculative {spec}: {stats['spec_chunks']} speculative chunks of {stats['chunks']}")
        agree = {}
        for j, name in enumerate(names):
            with under_adapter(torch, reader, banks["unsharded"], ADAPTER_NAMES.index(name) + 1 if name else 0):
                agree[j] = margin_rule(torch, reader, ids[j], outs[j]["ids"], ref_outs[j]["ids"])
        same = sum(o["ids"] == r["ids"] for o, r in zip(outs, ref_outs))
        check(all(a for a, _ in agree.values()),
              f"TP /generate streams with the bank (--gen-speculative {spec}) equal the unsharded engine's with the "
              f"same bank by the margin rule ({same}/{len(outs)} token for token; steps compared "
              f"{[u for _, u in agree.values()]})")
        if spec == "off":
            # teacher-forced on the reference streams: the TP reader's logits against the unsharded reader's,
            # without an adapter (the split's own drift) and under each adapter, beside the adapter's effect
            errs, rel = {0: 0.0}, 0.0
            for j, name in enumerate(names[:len(ADAPTER_NAMES) + 1]):  # one stream a bank index
                ix = ADAPTER_NAMES.index(name) + 1 if name else 0
                with under_adapter(torch, tp, banks["tp"], ix):
                    got_l = teacher_forced(torch, tp, ids[j], ref_outs[j]["ids"])
                with under_adapter(torch, reader, banks["unsharded"], ix):
                    want_l = teacher_forced(torch, reader, ids[j], ref_outs[j]["ids"])
                err = (got_l - want_l).abs().max().item()
                errs[ix] = max(errs.get(ix, 0.0), err)
                if ix:
                    effect = (want_l - teacher_forced(torch, reader, ids[j], ref_outs[j]["ids"])).abs().max().item()
                    rel = max(rel, err / effect)
            check(rel <= ADAPTER_TP_REL_TOL,
                  f"the TP reader's logits under each adapter within {rel:.3f} of the adapter's own change of the "
                  f"unsharded reader's logits (<= {ADAPTER_TP_REL_TOL}); max abs err by bank index "
                  f"{ {k: round(v, 4) for k, v in sorted(errs.items())} } (index 0: no adapter)")
        n_tok, ref_tok = sum(len(o["ids"]) for o in outs), sum(len(o["ids"]) for o in ref_outs)
        print(f"TP /generate with a bank of 3 (--gen-speculative {spec}; {card}): {n_tok} tokens in {wall:.2f} s = "
              f"{n_tok / wall:.1f} tokens/s ({stats['chunks']} chunks, {stats['spec_chunks']} speculative, "
              f"{stats['drafted_accepted']} drafts accepted); unsharded bf16 with the same bank {ref_tok} tokens in "
              f"{ref_wall:.2f} s = {ref_tok / ref_wall:.1f} tokens/s", flush=True)

    # one speculative chunk of 8 slots under bank indices 0-3 over the TP reader
    bank = banks["tp"]
    state = de.make_decode_state(cfg, 8, 512, device="cuda", model=tp)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    buckets = [32, 64, 128, 256]
    for slot in range(8):
        width = bucket_of(buckets, len(ids[slot]))
        x = np.zeros((1, width), np.int32)
        x[0, : len(ids[slot])] = ids[slot]
        m = (np.arange(width) < len(ids[slot]))[None].astype(np.int32)
        aix = [slot % (len(ADAPTER_NAMES) + 1)]
        kv, first, n = de.prefill(tp, x, m, gen, 0.0, 0, 1.0, sampled=False, bank=bank, adapter=aix)
        de.insert(state, kv, x, m, first, n, slot, 0.0, 0, 1.0, adapter=aix)

    def run(steps: int = 4):
        return de.decode_chunk_spec(tp, state, n_steps=steps, bank=bank)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    busy = device_busy_ms(torch, run)
    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    traced = trace_span(torch, f"TP engine chunk trace (speculative, 1 step of 8 x 9 rows, bank of 3; {card}; "
                               f"untraced {one_s * 1e3:.1f} ms)", "engine.chunk", 1, one_s, lambda: run(1))
    check(traced is not None and traced["syncs"] == 0,
          f"no host synchronisation inside a traced TP speculative chunk with the bank "
          f"({None if traced is None else traced['syncs']})")
    print(f"TP adapter bank, speculative chunk (4 steps of 8 x 9 rows; {card}): device busy {busy:.1f} ms, untraced "
          f"{chunk_s * 1e3:.1f} ms, device idle share {1 - busy / (chunk_s * 1e3):.3f} (phase_adapters' line above: "
          f"the unsharded int8c reader's chunk with the same bank shape)", flush=True)
    del state
    torch.cuda.empty_cache()
    print(f"TP adapters phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def mesh_steps(torch, pkg, trainer, batches: list, ad0: dict) -> tuple:
    """``trainer``'s steps over ``batches`` from the adapter ``ad0``: each
    step's (loss, grad_norm, seconds, peak bytes), and the launches of the
    steps (every count set to 0 just before them)."""
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

    rows = []
    with torch.no_grad():
        for n, leaf in flatten_paths(trainer.adapter).items():
            leaf.copy_(ad0[n])
    for kern in pkg.KERNELS:
        kern.launches = 0
    for b in batches:
        dev_batch = trainer.device_batch(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        m = trainer.run_step(dev_batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        rows.append((loss, gnorm, time.perf_counter() - t, torch.cuda.max_memory_allocated()))
    return rows, {k.name: k.launches for k in pkg.KERNELS}


def drawn_adapter(torch, adapter: dict, seed: int) -> dict:
    """The trainers' common start: ``adapter``'s leaves, B drawn
    N(0, MESH_B0_STD^2) on the card so that A trains from the first step."""
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {n: t.detach().clone() + (MESH_B0_STD * torch.randn(t.shape, generator=gen, device="cuda")
                                     if n.endswith(".b") else 0) for n, t in flatten_paths(adapter).items()}


def first_grads(torch, base, loss_of, lora, ad0: dict, mb: dict) -> dict:
    """The one-device gradient of the adapter at ``ad0`` on the microbatch
    ``mb``: which elements carry signal for the move rule."""
    from vietnamese_qa_system_tpu_torch.models import merge_lora
    from vietnamese_qa_system_tpu_torch.models.lora import clear_lora
    from vietnamese_qa_system_tpu_torch.utils.tree import nest

    g_ad = {n: t.clone().requires_grad_(True) for n, t in ad0.items()}
    merge_lora(base, nest(g_ad), lora)
    try:
        return dict(zip(g_ad, torch.autograd.grad(loss_of(base, mb)[0], list(g_ad.values()))))
    finally:
        clear_lora(base)


def move_rule(adapter, g0: dict, ref_ad: dict, ad0: dict, lr: float) -> tuple:
    """(leaves checked, worst median / lr, worst norm ratio) of the adapter's
    moves against the reference's: on the elements whose first-microbatch
    gradient exceeds 5% of the leaf's largest, the median difference of the
    moves; over the leaf, the difference's norm against the reference
    move's (``tests/test_torch_mesh_train.py``'s rule)."""
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

    checked, worst_med, worst_norm = 0, 0.0, 0.0
    for n, t in flatten_paths(adapter).items():
        g = g0[n].abs()
        sure = g > 0.05 * g.max()
        if not bool(sure.any()):
            continue
        d = (t.detach() - ref_ad[n]).abs()
        worst_med = max(worst_med, float(d[sure].median()) / lr)
        worst_norm = max(worst_norm, float(d.norm() / (ref_ad[n] - ad0[n]).norm()))
        checked += 1
    return checked, worst_med, worst_norm


def hold_mesh_steps(label: str, rows: list, ref: list, tokens: int, card: str) -> None:
    """Print each step of a mesh run beside the one-device reference's and
    hold its loss and grad_norm to it."""
    import numpy as np

    for i, ((loss, gnorm, sec, peak), (rloss, rgn, _, _)) in enumerate(zip(rows, ref)):
        print(f"{label} step {i + 1}: loss {loss:.6f} (one device {rloss:.6f}), grad_norm {gnorm:.6f} (one device "
              f"{rgn:.6f}), {sec:.3f} s, {tokens / sec:.1f} tokens/s, peak memory {peak / 1e9:.2f} GB ({card})",
              flush=True)
        check(np.isfinite(loss) and np.isfinite(gnorm), f"{label} step {i + 1}: loss and grad_norm finite")
        check(abs(loss - rloss) <= MESH_LOSS_RTOL * abs(rloss),
              f"{label} step {i + 1} loss within {MESH_LOSS_RTOL} of the one-device trainer's")
        check(abs(gnorm - rgn) <= MESH_GRAD_RTOL * abs(rgn),
              f"{label} step {i + 1} grad_norm within {MESH_GRAD_RTOL} of the one-device trainer's")


def hold_moves(label: str, adapter, g0, ref_ad, ad0, lr: float, card: str) -> None:
    checked, med, ratio = move_rule(adapter, g0, ref_ad, ad0, lr)
    print(f"{label}: adapter after the steps against the one-device trainer's: {checked} of {len(ad0)} leaves "
          f"checked, worst median difference {med:.4f} lr, worst norm ratio {ratio:.4f} ({card})", flush=True)
    check(checked == len(ad0) and med <= 0.05 and ratio <= 0.25,
          f"{label}: every adapter leaf moved as the one-device trainer's (median within 0.05 lr on the elements of "
          f"signal, difference norm within 0.25 of the move's)")


def phase_mesh_train(torch, pkg, logdir: str, card: str) -> dict:
    """Training over a device mesh at PhoGPT-4B width (MESH_LAYERS of its 32
    layers; an int8 base drawn on the card from the seed, LoRA r 8 / alpha
    16, proj_bf16 remat, adamw lr 2e-4; global batch TRAIN_BATCH x TRAIN_T,
    grad_accum 2, as ``phase_train``): MESH_STEPS steps under each strategy
    of MESH_STRATEGIES on a mesh of the one card repeated (``["cuda:0"] *
    4``), each from the same base, adapter and batches as a one-device
    trainer, the reference (every trainer starts from one adapter whose B
    is drawn small, not zero, so that A trains from the first step); the
    same steps with ``host_offload="all"`` under each of MESH_OFFLOAD; one
    nf4-dq QLoRA step under fsdp_tp against the one-device nf4-dq trainer;
    one ``cli train --strategy fsdp_tp --mesh '{"data": 2, "model": 2}'``
    step; and ``perplexity_eval(mesh=)`` over the fsdp_tp trainer's rows
    against the one-device eval of the same weights.  One card shows the
    code paths and their cost, not a multi-GPU speed-up: the four
    positions run in turn.

    Per strategy it prints seconds and tokens/s a step, each step's loss
    and grad_norm beside the reference's, the parameter and optimizer
    bytes a mesh position holds (what it would keep on a card of its own),
    the card's peak memory and the K4 / K7 launches a step; it fails on a
    K4 / K7 launch count of 0, a loss off the reference's by more than
    MESH_LOSS_RTOL, a grad_norm off by more than MESH_GRAD_RTOL, an adapter
    whose moves over the steps break the move rule of
    ``tests/test_torch_mesh_train.py`` against the reference's, an fsdp
    position holding more than a third of a dp position's parameter
    bytes, an offloaded run whose losses or grad_norm differ from the same
    strategy's by more than QLORA_OFFLOAD_RTOL or whose position keeps as
    many bytes on the card.  Returns the launches of the mesh runs
    (counted from zero)."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.core import mesh as mesh_mod
    from vietnamese_qa_system_tpu_torch.models import LoraConfig, init_causal_lm, loss_fn, merge_lora, phogpt_4b_class
    from vietnamese_qa_system_tpu_torch.models.lora import clear_lora
    from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer, perplexity_eval
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths, tree_map

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(phogpt_4b_class(), remat_policy="proj_bf16", n_layers=MESH_LAYERS)
    common = dict(model=cfg, lora=LoraConfig(r=8, alpha=16), quantize_base="int8", optimizer="adamw", lr=2e-4,
                  grad_accum=2, log_every=1, log_dir=logdir, seed=SEED + 41)
    t0 = time.perf_counter()
    base = init_causal_lm(cfg, make_generator(SEED + 41, "cuda"), quantize="int8")
    torch.cuda.synchronize()
    print(f"mesh train: phogpt_4b_class at {MESH_LAYERS} of its 32 layers (full width), int8 base drawn in "
          f"{time.perf_counter() - t0:.1f} s; global batch {TRAIN_BATCH} x {TRAIN_T}, grad_accum 2, {MESH_STEPS} "
          f"steps a strategy on [cuda:0] x {MESH_DEVICES} ({card}; one card runs the positions in turn: code paths "
          "and their cost, no multi-GPU speed-up)", flush=True)
    rng = np.random.default_rng(SEED + 41)
    batches = [train_batch(rng, TRAIN_BATCH, TRAIN_T, cfg.vocab_size) for _ in range(MESH_STEPS)]
    tokens = TRAIN_BATCH * TRAIN_T
    flash = ("flash_attention_fwd_causal", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")

    ref_trainer = Trainer(TrainConfig(**common, run_name="mesh_ref"), params=base, device="cuda", total_steps=8)
    ad0 = drawn_adapter(torch, ref_trainer.adapter, SEED + 42)
    mb0 = {k: torch.from_numpy(np.asarray(v[:TRAIN_BATCH // 2]).astype(np.int64)).cuda() for k, v in batches[0].items()}
    g0 = first_grads(torch, base, loss_fn, common["lora"], ad0, mb0)
    ref, _ = mesh_steps(torch, pkg, ref_trainer, batches, ad0)
    ref_ad = {n: t.detach().clone() for n, t in flatten_paths(ref_trainer.adapter).items()}
    for i, (loss, gnorm, sec, peak) in enumerate(ref):
        print(f"mesh train reference (one device) step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.6f}, {sec:.3f} s, "
              f"{tokens / sec:.1f} tokens/s, peak memory {peak / 1e9:.2f} GB", flush=True)
    del ref_trainer
    torch.cuda.empty_cache()

    launches = {k.name: 0 for k in pkg.KERNELS}
    held = {}
    last = None
    for strategy, axes in MESH_STRATEGIES:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mesh = mesh_mod.create_mesh(axes, devices=["cuda:0"] * MESH_DEVICES)
        trainer = Trainer(TrainConfig(**common, strategy=strategy, mesh_axes=axes, run_name=f"mesh_{strategy}"),
                          params=base, mesh=mesh, device="cuda", total_steps=8)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        pos = trainer.position_bytes()
        held[strategy] = pos[(0, 0)]
        rows, got = mesh_steps(torch, pkg, trainer, batches, ad0)
        for name in launches:
            launches[name] += got[name]
        per_step = {name: got[name] // MESH_STEPS for name in flash}
        print(f"mesh train {strategy} {axes}: built in {built:.2f} s; a position holds "
              f"{pos[(0, 0)]['param_bytes'] / 1e9:.3f} GB of parameters and {pos[(0, 0)]['opt_bytes'] / 1e6:.3f} MB "
              f"of optimizer state; K4 / K7 launches a step {per_step} ({card})", flush=True)
        hold_mesh_steps(f"mesh train {strategy}", rows, ref, tokens, card)
        hold_moves(f"mesh train {strategy}", trainer.adapter, g0, ref_ad, ad0, common["lr"], card)
        for name in flash:
            check(got[name] > 0, f"{name} launched {got[name]} times on the {strategy} mesh path")
        if strategy in MESH_OFFLOAD:
            on_card = trainer.position_bytes(device_only=True)[(0, 0)]
            gc.collect()  # the earlier strategies' trainers, kept by their cycles
            torch.cuda.synchronize()
            plain_alloc = torch.cuda.memory_allocated()
            del trainer
            gc.collect()  # a trainer's layer wrappers and its rows form cycles
            torch.cuda.empty_cache()
            off = Trainer(TrainConfig(**common, strategy=strategy, mesh_axes=axes, host_offload="all",
                                      run_name=f"mesh_{strategy}_offload"), params=base, mesh=mesh, device="cuda",
                          total_steps=8)
            off_rows, off_got = mesh_steps(torch, pkg, off, batches, ad0)
            for name in launches:
                launches[name] += off_got[name]
            off_card = off.position_bytes(device_only=True)[(0, 0)]
            gc.collect()
            torch.cuda.synchronize()
            off_alloc = torch.cuda.memory_allocated()
            for i, ((loss, gnorm, sec, peak), (ploss, pgn, psec, _)) in enumerate(zip(off_rows, rows)):
                print(f"mesh train {strategy} host_offload=all step {i + 1}: loss {loss:.6f} (without offload "
                      f"{ploss:.6f}), grad_norm {gnorm:.6f} ({pgn:.6f}), {sec:.3f} s (without offload {psec:.3f} s), "
                      f"peak memory {peak / 1e9:.2f} GB ({card})", flush=True)
                check(abs(loss - ploss) <= QLORA_OFFLOAD_RTOL * abs(ploss) and
                      abs(gnorm - pgn) <= QLORA_OFFLOAD_RTOL * abs(pgn),
                      f"{strategy} host_offload=all step {i + 1}: loss and grad_norm within {QLORA_OFFLOAD_RTOL} of "
                      "the same strategy's without offload")
            print(f"mesh train {strategy} host_offload=all: between steps a position keeps "
                  f"{off_card['param_bytes'] / 1e9:.3f} GB of parameters and {off_card['opt_bytes'] / 1e6:.3f} MB "
                  f"of optimizer state on the card (without offload {on_card['param_bytes'] / 1e9:.3f} GB, "
                  f"{on_card['opt_bytes'] / 1e6:.3f} MB); card memory allocated after the steps "
                  f"{off_alloc / 1e9:.2f} GB (without offload {plain_alloc / 1e9:.2f} GB) ({card})", flush=True)
            check(off_card["param_bytes"] + off_card["opt_bytes"] < on_card["param_bytes"] + on_card["opt_bytes"]
                  and off_alloc < plain_alloc,
                  f"{strategy} host_offload=all: a position's bytes on the card fall")
            off.merged_replicas()  # the offloaded pieces that alias the drawn base come back to the card
            del off
        elif strategy == "fsdp_tp":
            last = trainer
        else:
            del trainer
    check(held["fsdp"]["param_bytes"] <= held["dp"]["param_bytes"] / 3,
          f"an fsdp position holds {held['fsdp']['param_bytes'] / 1e9:.3f} GB of parameters, at most a third of a "
          f"dp position's {held['dp']['param_bytes'] / 1e9:.3f} GB")
    check(held["zero2"]["opt_bytes"] < held["dp"]["opt_bytes"] and
          held["zero2"]["param_bytes"] == held["dp"]["param_bytes"],
          "a zero2 position holds the whole parameters and part of the optimizer state")

    # perplexity_eval(mesh=) over the fsdp_tp rows against one device, same weights
    eval_batches = batches[:MESH_EVAL_BATCHES]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = perplexity_eval(last.merged_replicas(), cfg, eval_batches, mesh=last.mesh)
    t_split = time.perf_counter() - t0
    adapter = last.adapter
    del last
    torch.cuda.empty_cache()
    merge_lora(base, tree_map(lambda t: t.detach(), adapter), common["lora"])
    t0 = time.perf_counter()
    one = perplexity_eval(base, cfg, eval_batches)
    t_one = time.perf_counter() - t0
    clear_lora(base)
    print(f"perplexity_eval over the fsdp_tp rows ({{'data': 2, 'model': 2}}): eval_loss {split['eval_loss']:.6f}, "
          f"{split['eval_tokens']} tokens in {t_split:.2f} s; one device {one['eval_loss']:.6f} in {t_one:.2f} s "
          f"({card})", flush=True)
    check(split["eval_tokens"] == one["eval_tokens"] and abs(split["eval_loss"] - one["eval_loss"])
          <= MESH_LOSS_RTOL * abs(one["eval_loss"]), f"perplexity_eval(mesh=) within {MESH_LOSS_RTOL} of the "
                                                      "one-device eval of the same weights")
    del base
    torch.cuda.empty_cache()

    # nf4-dq QLoRA under fsdp_tp: the codes, their int8 scale codes and the
    # per-block-row offsets split over the model axis, then over the data axis
    t0 = time.perf_counter()
    nf4 = init_causal_lm(cfg, make_generator(SEED + 43, "cuda"), quantize="nf4-dq")
    nf4_common = dict(common, quantize_base="nf4-dq")
    nf4_ref = Trainer(TrainConfig(**nf4_common, run_name="mesh_nf4_ref"), params=nf4, device="cuda", total_steps=8)
    nf4_ad0 = drawn_adapter(torch, nf4_ref.adapter, SEED + 44)
    ref1, _ = mesh_steps(torch, pkg, nf4_ref, batches[:1], nf4_ad0)
    del nf4_ref
    torch.cuda.empty_cache()
    axes = {"data": 2, "model": 2}
    nf4_tp = Trainer(TrainConfig(**nf4_common, strategy="fsdp_tp", mesh_axes=axes, run_name="mesh_nf4_fsdp_tp"),
                     params=nf4, mesh=mesh_mod.create_mesh(axes, devices=["cuda:0"] * MESH_DEVICES), device="cuda",
                     total_steps=8)
    pos = nf4_tp.position_bytes()[(0, 0)]
    rows1, got = mesh_steps(torch, pkg, nf4_tp, batches[:1], nf4_ad0)
    for name in launches:
        launches[name] += got[name]
    print(f"mesh train nf4-dq fsdp_tp {axes}: a position holds {pos['param_bytes'] / 1e9:.3f} GB of parameters "
          f"(nf4-dq codes and scales); K4 / K7 launches {({n: got[n] for n in flash})}; phase part "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    hold_mesh_steps("mesh train nf4-dq fsdp_tp", rows1, ref1, tokens, card)
    for name in flash:
        check(got[name] > 0, f"{name} launched {got[name]} times on the nf4-dq fsdp_tp mesh path")
    del nf4_tp, nf4
    torch.cuda.empty_cache()

    # cli train over the mesh: every visible GPU is the one card, four times
    here = os.path.dirname(os.path.abspath(__file__))
    cfg_path = os.path.join(logdir, "phogpt_mesh.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    argv = ["train", "--model-config", cfg_path, "--use-lora", "--quantize-base", "int8", "--remat-policy",
            "proj_bf16", "--train-files", os.path.join(here, "examples", "sample_instruct.jsonl"), "--max-steps",
            "1", "--batch-size", "8", "--grad-accum", "2", "--log-every", "1", "--log-dir", logdir, "--run-name",
            "mesh_cli", "--strategy", "fsdp_tp", "--mesh", '{"data": 2, "model": 2}']
    rc, logged, cli_s, got = cli_on_repeated_card(torch, pkg, cli_main, mesh_mod, argv, MESH_DEVICES,
                                                  os.path.join(logdir, "mesh_cli.jsonl"))
    for name in launches:
        launches[name] += got[name]
    print(f"cli train --strategy fsdp_tp --mesh '{{\"data\": 2, \"model\": 2}}' (PhoGPT-4B width, {MESH_LAYERS} "
          f"layers): exit {rc} in {cli_s:.1f} s; " + "; ".join(f"step {r['step']} loss {r['loss']:.6f} grad_norm "
                                                            f"{r['grad_norm']:.6f}" for r in logged if "loss" in r),
          flush=True)
    check(rc == 0 and len([r for r in logged if "loss" in r]) == 1 and np.isfinite(logged[0]["loss"]),
          "cli train --strategy fsdp_tp --mesh over the repeated card exits 0 after one finite step")
    print(f"mesh train phase {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return launches


def cli_on_repeated_card(torch, pkg, cli_main, mesh_mod, argv: list, n: int, log: str) -> tuple:
    """``cli_main(argv)`` with every visible GPU the one card, ``n`` times
    (the CLI takes every visible GPU); (exit code, the logged records,
    seconds, launches)."""
    real = mesh_mod.visible_devices
    mesh_mod.visible_devices = lambda: [torch.device("cuda", 0)] * n
    for kern in pkg.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli_main(argv)
    finally:
        mesh_mod.visible_devices = real
    torch.cuda.synchronize()
    with open(log) as f:
        logged = [json.loads(line) for line in f]
    return rc, logged, time.perf_counter() - t0, {k.name: k.launches for k in pkg.KERNELS}


def implied_flash_launches(trainer, cfg, accum: int) -> dict:
    """K4 / K7 launches a step of a seq2seq trainer with flash (T >= 256 in
    both stacks): each microbatch runs every data row's encoder (K4
    bidirectional) and decoder (K4 causal) self-attention once a layer and
    a part where attention splits (whole where it does not); the backward
    launches K7's two kernels once each of those; fsdp's gathering
    sublayers run under a checkpoint, so their backward runs K4 again."""
    placed = trainer.placed
    parts = placed.n_model if getattr(placed.rows[0], "groups", None) is not None else 1
    runs = accum * placed.n_data * parts
    again = 2 if placed.fsdp else 1
    enc, dec = cfg.n_layers, cfg.decoder_layers
    return {"flash_attention_fwd": runs * enc * again, "flash_attention_fwd_causal": runs * dec * again,
            "flash_attention_bwd_dkdv": runs * (enc + dec), "flash_attention_bwd_dq": runs * (enc + dec)}


def phase_mesh_train_s2s(torch, pkg, A, gen, report, logdir: str, card: str) -> dict:
    """Seq2seq training over a model axis on the one card repeated: mt5-small
    at full width and depth (d 512, 6 heads x d_kv 64, 8 + 8 layers, d_ff
    1,024 gated, vocabulary 250,112, untied head; an int8 base drawn on the
    card from the seed, LoRA r 8 / alpha 16, ``use_flash_attention``;
    global batch S2S_TRAIN_BATCH x (S2S_TRAIN_ENC + S2S_TRAIN_DEC) tokens,
    grad_accum MESH_S2S_ACCUM), MESH_STEPS steps under each of
    MESH_S2S_STRATEGIES (tp {"model": 2}: heads 3 + 3, vocabulary 125,056 a
    part; tp {"model": 4}: attention whole, the MLP and vocabulary split;
    fsdp_tp {"data": 2, "model": 2}), each held to the one-device trainer
    from the same base, adapter (B drawn small) and batches by
    ``phase_mesh_train``'s rules, with the K4 / K7 launches of each step
    equal to the count the code implies (``implied_flash_launches``); K4
    and K7 at a TP part's shapes against their plain versions; one
    mBART-large-50-width bf16 LoRA step under tp {"model": 2} held the
    same way; and one ``cli train --arch seq2seq --model-size mt5small
    --strategy tp --mesh '{"model": 2}' --do-eval`` step.  One card shows
    the code paths and their cost, not a multi-GPU speed-up.  Returns the
    launches of the mesh runs."""
    import numpy as np

    from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.core import mesh as mesh_mod
    from vietnamese_qa_system_tpu_torch.models import LoraConfig, ModelConfig, mt5_small_class
    from vietnamese_qa_system_tpu_torch.models.families import init_seq2seq_model
    from vietnamese_qa_system_tpu_torch.models.families import loss_fn as s2s_loss
    from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

    t_phase = time.perf_counter()
    t5_flash_check(torch, A, gen, report, T5_TP_FLASH, "t5_tp_part")
    print(f"mesh s2s: K4 / K7 at a TP part's shapes checked in {time.perf_counter() - t_phase:.1f} s", flush=True)
    flash = ("flash_attention_fwd", "flash_attention_fwd_causal", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
    launches = {k.name: 0 for k in pkg.KERNELS}
    tokens = S2S_TRAIN_BATCH * (S2S_TRAIN_ENC + S2S_TRAIN_DEC)
    rng = np.random.default_rng(SEED + 51)

    def hold_family(label, cfg, base, quantize, strategies, steps, seed):
        """The one-device reference and each strategy of ``strategies`` from
        ``base``; returns the launches of the mesh runs."""
        common = dict(model=cfg, lora=LoraConfig(r=8, alpha=16), quantize_base=quantize, optimizer="adamw", lr=2e-4,
                      grad_accum=MESH_S2S_ACCUM, log_every=1, log_dir=logdir, seed=seed)
        batches = [s2s_train_batch(rng, S2S_TRAIN_BATCH, S2S_TRAIN_ENC, S2S_TRAIN_DEC, cfg.vocab_size)
                   for _ in range(steps)]
        ref_trainer = Trainer(TrainConfig(**common, run_name=f"{label}_ref"), params=base, device="cuda",
                              total_steps=8)
        ad0 = drawn_adapter(torch, ref_trainer.adapter, seed + 1)
        mb0 = {k: torch.from_numpy(np.asarray(v[:S2S_TRAIN_BATCH // MESH_S2S_ACCUM]).astype(np.int64)).cuda()
               for k, v in batches[0].items()}
        g0 = first_grads(torch, base, s2s_loss, common["lora"], ad0, mb0)
        ref, ref_got = mesh_steps(torch, pkg, ref_trainer, batches, ad0)
        want = implied_flash_launches(ref_trainer, cfg, MESH_S2S_ACCUM) if cfg.use_flash_attention else None
        ref_ad = {n: t.detach().clone() for n, t in flatten_paths(ref_trainer.adapter).items()}
        for i, (loss, gnorm, sec, peak) in enumerate(ref):
            print(f"{label} reference (one device) step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.6f}, {sec:.3f} s, "
                  f"{tokens / sec:.1f} tokens/s, peak memory {peak / 1e9:.2f} GB ({card})", flush=True)
        if want is not None:
            check(all(ref_got[n] == steps * want[n] for n in flash),
                  f"{label} one device: K4 / K7 launches {({n: ref_got[n] for n in flash})} = {steps} steps x "
                  f"{want}")
        del ref_trainer
        torch.cuda.empty_cache()
        out = {k.name: 0 for k in pkg.KERNELS}
        for strategy, axes in strategies:
            t0 = time.perf_counter()
            n = int(np.prod(list(axes.values())))
            trainer = Trainer(TrainConfig(**common, strategy=strategy, mesh_axes=axes,
                                          run_name=f"{label}_{strategy}_{n}"),
                              params=base, mesh=mesh_mod.create_mesh(axes, devices=["cuda:0"] * n), device="cuda",
                              total_steps=8)
            torch.cuda.synchronize()
            built = time.perf_counter() - t0
            pos = trainer.position_bytes()[(0, 0)]
            split = trainer.placed.rows[0].groups is not None
            rows, got = mesh_steps(torch, pkg, trainer, batches, ad0)
            for name in out:
                out[name] += got[name]
            print(f"{label} {strategy} {axes}: built in {built:.2f} s; attention {'split by heads' if split else 'whole'};"
                  f" a position holds {pos['param_bytes'] / 1e9:.3f} GB of parameters and "
                  f"{pos['opt_bytes'] / 1e6:.3f} MB of optimizer state; K4 / K7 launches "
                  f"{({n: got[n] for n in flash})} ({card})", flush=True)
            hold_mesh_steps(f"{label} {strategy} {axes}", rows, ref, tokens, card)
            hold_moves(f"{label} {strategy} {axes}", trainer.adapter, g0, ref_ad, ad0, common["lr"], card)
            if want is not None:
                per = implied_flash_launches(trainer, cfg, MESH_S2S_ACCUM)
                check(all(got[n] == steps * per[n] > 0 for n in flash),
                      f"{label} {strategy} {axes}: K4 / K7 launches {({n: got[n] for n in flash})} = {steps} steps "
                      f"x {per}")
            del trainer
            torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mt5_small_class(), use_flash_attention=True)
    base = init_seq2seq_model(cfg, make_generator(SEED + 51, "cuda"), quantize="int8")
    torch.cuda.synchronize()
    print(f"mesh s2s: mt5-small (full width and depth) int8 base drawn in {time.perf_counter() - t0:.1f} s; global "
          f"batch {S2S_TRAIN_BATCH} x ({S2S_TRAIN_ENC} + {S2S_TRAIN_DEC}), grad_accum {MESH_S2S_ACCUM}, {MESH_STEPS} "
          f"steps a strategy ({card}; one card runs the positions in turn)", flush=True)
    got = hold_family("mesh s2s mt5", cfg, base, "int8", MESH_S2S_STRATEGIES, MESH_STEPS, SEED + 52)
    for name in launches:
        launches[name] += got[name]
    del base
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mbart = ModelConfig(arch="seq2seq", seq2seq_family="bart", vocab_size=250054, d_model=1024, n_heads=16,
                        n_layers=12, n_decoder_layers=12, d_ff=4096, max_seq_len=1024, positional="learned",
                        scale_embedding=True, norm_eps=1e-5, tie_embeddings=True, attention_bias=True)
    base = init_seq2seq_model(mbart, make_generator(SEED + 53, "cuda")).to(torch.bfloat16)
    torch.cuda.synchronize()
    print(f"mesh s2s: mBART-large-50 width (d 1,024, 16 heads, 12 + 12 layers, vocabulary 250,054) bf16 base drawn "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    got = hold_family("mesh s2s mbart", mbart, base, None, (("tp", {"model": 2}),), 1, SEED + 54)
    for name in launches:
        launches[name] += got[name]
    del base
    torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    sample = os.path.join(here, "examples", "sample_instruct.jsonl")
    argv = ["train", "--arch", "seq2seq", "--model-size", "mt5small", "--use-lora", "--train-files", sample,
            "--eval-files", sample, "--max-examples", "8", "--max-steps", "1", "--batch-size", "4", "--max-len",
            "256", "--log-every", "1", "--log-dir", logdir, "--run-name", "mesh_s2s_cli", "--strategy", "tp",
            "--mesh", '{"model": 2}', "--do-eval"]
    rc, logged, cli_s, got = cli_on_repeated_card(torch, pkg, cli_main, mesh_mod, argv, 2,
                                                  os.path.join(logdir, "mesh_s2s_cli.jsonl"))
    for name in launches:
        launches[name] += got[name]
    steps = [r for r in logged if "loss" in r]
    evals = [r for r in logged if "eval_eval_loss" in r]
    print(f"cli train --arch seq2seq --model-size mt5small --strategy tp --mesh '{{\"model\": 2}}' --do-eval: exit "
          f"{rc} in {cli_s:.1f} s; {steps}; eval {evals} ({card})", flush=True)
    check(rc == 0 and len(steps) == 1 and np.isfinite(steps[0]["loss"]) and len(evals) == 1
          and np.isfinite(evals[0]["eval_eval_loss"]),
          "cli train --arch seq2seq --strategy tp --mesh over the repeated card: one finite step and its eval")
    print(f"mesh s2s phase {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return launches


def timed(phase, *args):
    """``phase(*args)``, printing its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {phase.__name__.removeprefix('phase_')}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vietnamese_qa_system_tpu_torch.ops as pkg
    from vietnamese_qa_system_tpu_torch.ops import attention as A
    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels, quant
    from vietnamese_qa_system_tpu_torch.ops import ivf_probe as P
    from vietnamese_qa_system_tpu_torch.ops import topk as T
    from vietnamese_qa_system_tpu_torch.models import mpnet_class, relative_attention_bias, tree_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(gpu_name_and_power(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()
    cuda_kernels.library()
    print(f"kernels built from csrc/ in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report: dict = {}
    timed(phase_topk, torch, T, quant, gen, report)
    timed(phase_topk_edges, torch, T, quant, gen)
    variants = flash_variants(torch)
    table = torch.randn(32, FLASH_H, generator=gen, device="cuda") * 0.02
    timed(phase_flash, torch, A, gen, report, lambda t: relative_attention_bias(table, t, mpnet_class()), variants)
    timed(phase_flash_edges, torch, A, gen)
    timed(phase_w8, torch, report)
    timed(phase_decode_attn, torch, report)
    timed(phase_k8, torch, quant, gen, report)
    retrieval, ctx = timed(phase_slice, torch, pkg, gen)
    print("launches in the retrieval run: " + json.dumps(retrieval))
    for name in ("matmul_topk_bf16", "matmul_topk_bf16_large", "matmul_topk_int8", "matmul_topk_int8_global",
                 "flash_attention_fwd"):
        check(retrieval[name] > 0, f"{name} launched on the retrieval path")
    hybrid = timed(phase_hybrid, torch, pkg, ctx)
    print("launches in the hybrid run: " + json.dumps(hybrid))
    for name in ("matmul_topk_bf16", "matmul_topk_int8", "quantize_int8"):
        check(hybrid[name] > 0, f"{name} launched on the hybrid path")
    timed(phase_bm25_timing, torch)
    reader_launches, reader = timed(phase_reader, torch, pkg, ctx)
    for name in ("matmul_topk_bf16", "w8_matmul", "decode_attention"):
        check(reader_launches[name] > 0, f"{name} launched on the QA path")
    timed(phase_twin, torch, reader)
    engine_launches = timed(phase_engine, torch, pkg, reader, ctx)
    print("launches in the /generate run: " + json.dumps(engine_launches))
    check(engine_launches["w8_matmul"] > 0, "w8_matmul launched on the /generate path")
    check(engine_launches["decode_attention"] > 0, "decode_attention launched on the /generate path")
    adapter_launches = timed(phase_adapters, torch, pkg, reader, ctx)
    print("launches in the /generate run with adapters: " + json.dumps(adapter_launches))
    check(adapter_launches["w8_matmul"] > 0, "w8_matmul launched on the /generate path with the adapter bank")
    check(adapter_launches["decode_attention"] > 0, "decode_attention launched on the /generate path with the bank")
    strategies_w8 = timed(phase_decode_strategies, torch, pkg, reader, ctx)
    int8c_bytes = tree_bytes(reader)
    del reader
    torch.cuda.empty_cache()
    nf4_launches = timed(phase_nf4, torch, pkg, ctx, int8c_bytes)
    print("launches in the nf4 /qa runs: " + json.dumps(nf4_launches))
    check(nf4_launches["matmul_topk_bf16"] > 0, "matmul_topk_bf16 launched on the nf4 /qa path")
    torch.cuda.empty_cache()
    s2s_qa, s2s_flash, mt5, mt5_dir = timed(phase_seq2seq_qa, torch, pkg, ctx)
    try:
        for name in ("matmul_topk_bf16", "w8_matmul"):
            check(s2s_qa[name] > 0, f"{name} launched on the mt5 /qa path")
        s2s_engine = timed(phase_seq2seq_engine, torch, pkg, mt5, ctx)
        print("launches in the mt5 /generate run: " + json.dumps(s2s_engine))
        check(s2s_engine["w8_matmul"] > 0, "w8_matmul launched on the mt5 /generate path")
        check(s2s_engine["decode_attention"] > 0, "decode_attention launched on the mt5 /generate path")
        mbart = timed(phase_mbart, torch)
        translate = timed(phase_translate, torch, pkg, mt5, mbart)
        del mt5
        torch.cuda.empty_cache()
        tp_s2s = timed(phase_tp_seq2seq, torch, pkg, mt5_dir, mbart, report)
    finally:
        shutil.rmtree(mt5_dir, ignore_errors=True)
    del mbart
    torch.cuda.empty_cache()
    print("launches in the TP seq2seq runs: " + json.dumps(tp_s2s))
    check(tp_s2s["flash_attention_fwd"] > 0, "flash_attention_fwd launched on the TP seq2seq /qa path")
    timed(phase_spec_sampled, torch)
    torch.cuda.empty_cache()
    ivf_launches, ivfs = timed(phase_ivf, torch, pkg, ctx, gen)
    del ctx
    print("launches in the IVF run: " + json.dumps(ivf_launches))
    for name in ("ivf_probe_scores", "quantize_int8"):
        check(ivf_launches[name] > 0, f"{name} launched on the IVF path")
    timed(phase_k5, torch, P, ivfs, gen, report)
    del ivfs
    torch.cuda.empty_cache()
    card = gpu_name_and_power()
    sharded = timed(phase_sharded, torch, pkg, card)
    print("launches in the sharded runs: " + json.dumps(sharded))
    for name in ("matmul_topk_bf16", "matmul_topk_int8", "ivf_probe_scores", "quantize_int8"):
        check(sharded[name] > 0, f"{name} launched on the sharded path")
    torch.cuda.empty_cache()
    tp_launches, tp, tp_base = timed(phase_tp, torch, pkg, card)
    print("launches in the TP runs: " + json.dumps(tp_launches))
    check(tp_launches["decode_attention"] > 0, "decode_attention launched on each device of the TP reader")
    tp_adapters = timed(phase_tp_adapters, torch, pkg, tp, tp_base, card)
    print("launches in the TP runs with the adapter bank: " + json.dumps(tp_adapters))
    del tp, tp_base
    torch.cuda.empty_cache()
    timed(phase_train_kernels, torch, A, gen, report)
    timed(phase_t5_flash_kernels, torch, A, gen, report)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as logdir:
        train_launches = timed(phase_train, torch, pkg, logdir)
        torch.cuda.empty_cache()
        for name in ("flash_attention_fwd_causal", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
            check(train_launches[name] > 0, f"{name} launched on the train path")
        timed(phase_cli_train, torch, logdir)
        torch.cuda.empty_cache()
        convert = timed(phase_convert_ckpt, torch, pkg, logdir)
        torch.cuda.empty_cache()
        timed(phase_train_twin, torch, logdir)
        torch.cuda.empty_cache()
        qlora_launches = timed(phase_qlora, torch, pkg, logdir)
        torch.cuda.empty_cache()
        s2s_train = timed(phase_seq2seq_train, torch, pkg, logdir)
        torch.cuda.empty_cache()
        mesh_train = timed(phase_mesh_train, torch, pkg, logdir, card)
        torch.cuda.empty_cache()
        mesh_s2s = timed(phase_mesh_train_s2s, torch, pkg, A, gen, report, logdir, card)
    print("launches in the mesh training runs: " + json.dumps(mesh_train))
    print("launches in the seq2seq mesh training runs: " + json.dumps(mesh_s2s))
    print("launches in the nf4-dq QLoRA run: " + json.dumps(qlora_launches))
    for name in ("flash_attention_fwd", "flash_attention_fwd_causal", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        check(s2s_train[name] > 0, f"{name} launched on the mt5 train path")
        check(mesh_s2s[name] > 0, f"{name} launched on the seq2seq mesh train path")
    print("launches in the offline ETL runs: translate " + json.dumps(translate) + "; convert " + json.dumps(convert))
    etl = {name: translate[name] + convert[name] for name in translate}
    launches = dict(retrieval, w8_matmul=reader_launches["w8_matmul"] + engine_launches["w8_matmul"] + strategies_w8
                    + adapter_launches["w8_matmul"] + s2s_qa["w8_matmul"] + s2s_engine["w8_matmul"]
                    + etl["w8_matmul"],
                    decode_attention=sum(run.get("decode_attention", 0) for run in (
                        reader_launches, engine_launches, adapter_launches, nf4_launches, s2s_qa, s2s_engine,
                        tp_s2s, tp_launches, tp_adapters, translate, convert)) + report["decode_attention"]["phase_launches"],
                    ivf_probe_scores=ivf_launches["ivf_probe_scores"] + sharded["ivf_probe_scores"],
                    quantize_int8=ivf_launches["quantize_int8"] + sharded["quantize_int8"],
                    matmul_topk_bf16=retrieval["matmul_topk_bf16"] + s2s_qa["matmul_topk_bf16"]
                    + sharded["matmul_topk_bf16"],
                    matmul_topk_int8=retrieval["matmul_topk_int8"] + sharded["matmul_topk_int8"],
                    flash_attention_fwd=retrieval["flash_attention_fwd"] + s2s_flash["flash_attention_fwd"]
                    + s2s_train["flash_attention_fwd"] + tp_s2s["flash_attention_fwd"] + mesh_s2s["flash_attention_fwd"]
                    + etl["flash_attention_fwd"],
                    **{name: train_launches[name] + qlora_launches[name] + s2s_train[name] + mesh_train[name]
                       + mesh_s2s[name] + etl[name]
                       for name in ("flash_attention_fwd_causal", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")})
    for name in ("matmul_topk_bf16", "matmul_topk_int8", "ivf_probe_scores", "quantize_int8"):
        report[name]["sharded_launches"] = sharded[name]
    for name in ("w8_matmul", "flash_attention_fwd", "flash_attention_fwd_causal", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        report[name]["etl_launches"] = etl[name]
    report["w8_matmul"]["seq2seq_launches"] = s2s_qa["w8_matmul"] + s2s_engine["w8_matmul"]
    report["matmul_topk_bf16"]["seq2seq_launches"] = s2s_qa["matmul_topk_bf16"]
    report["flash_attention_fwd"]["seq2seq_launches"] = s2s_flash["flash_attention_fwd"] + s2s_train["flash_attention_fwd"]
    report["flash_attention_fwd"]["tp_seq2seq_launches"] = tp_s2s["flash_attention_fwd"]
    for name in ("flash_attention_fwd_causal", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        report[name]["seq2seq_launches"] = s2s_train[name]
        report[name]["mesh_launches"] = mesh_train[name]
    for name in ("flash_attention_fwd", "flash_attention_fwd_causal", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        report[name]["mesh_seq2seq_launches"] = mesh_s2s[name]
    # the occupancy of the variants that the main shapes run
    for name, key in (("flash_attention_fwd", ("fwd", 64, 0, 1)), ("flash_attention_fwd_causal", ("fwd", 128, 1, 2)),
                      ("flash_attention_bwd_dkdv", ("bwd", 128, 0, 2)), ("flash_attention_bwd_dq", ("bwd", 128, 1, 2))):
        regs, smem, blocks = variants[key][:3]
        report[name].update(registers=regs, shared_bytes=smem, blocks_per_sm=blocks)
    kernels = [
        {"name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], **report[k.name]}
        for k in pkg.KERNELS
    ]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
