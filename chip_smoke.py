#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main paths at full width, through the entry points a
user calls: compile the synthetic pattern-pruned VGG16 (CIFAR-10, 13
convs, Table-II statistics) in fp32 and int8, save and reload the fp32
program, and serve seeded requests through ``InferenceService`` on
``cuda``, then sharded over a device mesh (a one-rank mesh in this
process, a 2 x 2 gloo group of four processes on the card) with
flash-decode of granite-3-2b over a split cache; compile it again with
the per-layer crossbar mapping search (``optimize="auto"``), serve it
with skip statistics and price the served traffic with
``hardware_report``; train full-width VGG16 on seeded
class-prototype batches, pattern-prune it with ``admm_pattern_prune``,
compile it verified and range-certified, reload it with verification and
serve it; run ``ops.ou_mvm`` on every conv's dense weight at real
inputs; generate tokens with full-width, full-depth
h2o-danube-1.8B (pattern-sparse MLPs, bf16, weights from the seed)
through ``DecodeService``, every prefill through the flash-attention
kernel; then run the four architectures MoE, MLA and the MTP head
unlock at full width, depth cut to fit one card (``lm_configs``):
DeepSeek-V2 (MLA's absorbed decode against the expanded one, one MoE
layer against its definition and a host recount of its capacity drops,
served in bf16 through ``DecodeService``), DeepSeek-V3's MTP head,
qwen2.5-32b's prefills through the flash kernel at D 128 and
phi3-medium-14b's on the kv-repeat route; then the three the SSM mixer
and the encoder with cross-attention unlock (``ssm_whisper``): the SSD
against a token-by-token recurrence at mamba2's and jamba's widths,
mamba2-780m at all 48 layers (a cached prefill and decode against a
cacheless forward in float32, served in bf16 through
``DecodeService``), jamba-1.5-large's first 5 of 72 layers served in
bf16 (every prefill's attention through the flash kernel, each call
held to the flash phase's rounding limit) and whisper-small whole (the
handoff with frames in float32, a bf16 batch); then the VLM prefix
(``vlm``): paligemma-3b whole, 256 seeded patch embeddings in front of
each prompt, every prefill's attention through the flash kernel's
256-wide build (its calls held to the plain version on both routes), the
cached prefill + decode against a cacheless forward in float32, then in
bf16 the prefix prefills and decode steps through the step functions and
text-only requests through ``DecodeService``; then training (``train``):
full-width, full-depth h2o-danube-1.8B trained through
``runtime.train.Trainer`` on the plain routes (the loss must fall), a
restart drill at 2 of its 24 layers in a spawned process under
deterministic algorithms (a failure injected, the async checkpoint
restored: losses and final state bit-equal to an uninterrupted run), the
trained weights served through the flash kernel (each call held to its
plain version), and every kernel wrapper refusing an input that requires
grad; the drill's process also runs the sharded step on a one-rank mesh
against the unsharded step, bit for bit; then sharded training
(``train_shard``): a 2 x 2 gloo mesh of four spawned ranks on the card
trains danube at full width cut to 4 layers through the sharded step
(params split by their logical specs, ZeRO-1 moments, each rank its rows
of the batch, attention heads, the sparse MLPs' tiles and the
vocabulary of the embedding and the head computed on each rank's
``model`` slab; losses and gathered params held to the unsharded run,
each rank's resident bytes to those reckoned from its placements, no
param all-gathered, and the bytes all-reduced and re-laid out over
``model`` each step to those reckoned from the shapes), checkpoints
whole leaves and restores them in this process bit for bit, runs
``pipeline_apply`` of danube's decoder layer over a 4-stage mesh of the
same ranks against the sequential fold, trains jamba-1.5-large at smoke
width the same way (experts, attention and the SSM's heads on their
slabs, the SSM's packed columns re-laid out), DeepSeek-V2 at full width
cut to its first layer (MLA's heads and the vocabulary of 102,400 split)
and mamba2-780m at full width cut to 8 of its 48 layers (the SSM's heads
and the tied vocabulary split); then (``entry_points``) the
serving launcher ``python -m repro_torch.launch.serve`` serves
full-width, full-depth h2o-danube-1.8B, every prefill through the flash
kernel, and the example twins run (``serve_decode_torch.py``,
``quickstart_torch.py``, ``serve_http_torch.py --check`` on both
backends, its generation trace through ``benchmarks/check_baseline.py
--require-mid-decode``), each a subprocess whose failure fails the run;
then (``dryrun``) the dry run's reckonings held against the card: (a)
``launch.op_stats`` over fake tensors predicts the train phase's
full-width danube step, whose real run on the card must count the same
FLOPs, peak within ``DRYRUN_PEAK_REL`` of the prediction and take no
less than its roofline bound; (b) the predicted collective bytes of the
``train_shard`` phase's (f) step, by kind, equal its ``step.comm``; (c)
four spawned gloo ranks serve danube at full width, cut to 4 layers,
computing on their model slabs, through the placed prefill (the flash
kernel on each rank's query heads, each call held to its plain version;
the sparse MLPs' tiles of each rank through the pattern-spmm kernel,
their layouts' dictionary groups written out as brick tables so the
kernel routes them, each call held to its plain version; the config's
own layouts, groups kept, take dense per-pattern products and launch no
spmm kernel) and 8 placed decode steps, teacher-forced on the greedy
tokens of the config's own layouts served unsharded: their logits
within ``DRYRUN_LOGITS_REL`` of the unsharded tile route's, as those are
of the own layouts' (the same function), every argmax that differs a
near tie the difference explains, each rank's resident bytes its
slabs', every step's collective bytes as ``parallel.tensor.serve_bytes``
reckons them, and a placed decode step's peak and collective bytes as
predicted; (d) two production cells of ``python -m
repro_torch.launch.dryrun`` (256 fake ranks) with status ok; (e) the same
four ranks as a 1 x 4 mesh serve qwen2.5-32B at full width, cut to 2 of
its 64 layers, on both decode routes: tokens equal to the unsharded
run's, every step's bytes as reckoned, no param gathered.
Before each path it builds the CUDA kernels from the sources in ``src/``
and holds each against its plain PyTorch version on the card, at every
shape the path gives it.  The int8 path runs here at CIFAR-10's shapes;
at ImageNet's (224 x 224, 16 slots, through ``InferenceService``) it is
the benchmark cell ``vgg16_imagenet_int8.bulk`` (``BENCHMARK.json``),
and its spmm at conv1_2's 802,816 patch rows is
``tests/test_torch_int8_reference.py``'s card test.

Phases, one JSON line each: ``device``, ``build``, ``compile``,
``kernels`` (kernel vs plain), ``serve``, ``shard``, ``search``,
``prune``, ``ou_mvm``, ``flash`` (kernel vs plain), ``generate``,
``lm_configs``, ``ssm_whisper``, ``vlm``, ``train``, ``train_shard``,
``entry_points``, ``dryrun``, ``times``.  The
conv-patch rows (``kernels``, one per conv of a forward in the executor's
layouts and a ragged case) must equal the plain version bit for bit, the
served forwards launch the kernel once a conv, and ``times`` times it
per conv here and at the benchmark's two shapes (``PATCH_SHAPES``); so
for the int8 patch rows (``conv_patches_q8_cuda``: int8 rows and row
scales bit for bit, once a conv of every int8 forward, timed beside the
float rows' route they replaced).  The
spmm rows carry each layer's split plan (``splits``, ``blocks``) and, in
``times``, its TFLOP/s (fp32) or TOP/s and bound (int8); the ``ou_mvm``
rows carry the column-slab plan (``slab_cols``, ``blocks``) and, in
``times``, GB/s; every kernel must give the same bits on a second run.
The flash rows carry the route (``tensor_core`` for bf16 and fp16,
``simt`` for fp32), and every prefill launch of ``generate`` must take
the tensor-core route.  The ``prune`` phase gates every kernel's pattern
in its layer's dictionary (at most ``num_patterns`` nonzero ones) and its
weights inside that pattern; strict compiles in fp32 and int8 whose
certificates and verifier reports equal the same compiles on the CPU;
``python -m repro_torch.analysis all`` exiting 0 on each saved program;
served fp32 labels equal to the dense ``cnn_apply`` (layers within
``LAYER_TOL``, logits within ``E2E_TOL`` of the CPU plain path); conv1's
kernel output at the input that attains its certified ``pre_hi`` and
``pre_lo`` within ``bound_rounding_limit`` of them; and every layer's
spmm + bias over the served images inside its certificate, fp32 and
int8.  Its spmm launches join the serve phase's in the summary.  The
``shard`` phase runs the sharded path: (a) a one-rank mesh in this process
(``make_mesh``, NCCL): the mesh forward bit-equal to the unsharded one in
fp32 and int8, ``InferenceService(mesh=...)`` serving the same requests
with equal labels, logits and skip statistics, and flash-decode
(granite-3-2b at full width, 4 layers) on the gather strategy's tokens,
each step within ``DECODE_LIMIT`` (bf16 flash no farther from the
float32 model than ``GEN_BF16_NOISE_FACTOR`` times bf16 gather is, and
float32 flash within ``GEN_FP32_REL`` of float32 gather); (b)
``SHARD_MESH`` ranks of a ``gloo`` group spawned on this one card (NCCL
takes one card per rank), each serving the requests through the
programs partitioned with ``partition_network``: each fp32 layer within
``LAYER_TOL`` of the single-device dispatch, logits within ``E2E_TOL``,
equal fp32 labels, int8 within the reference's bars, equal statistics,
every rank's spmm launches counted, flash-decode over two cache
chunks gated as in (a), and DeepSeek-V2's smoke MoE expert-parallel over
the model ranks within ``MOE_REL`` of each data shard's unsharded
result.  Its launches join the summary.  Any failed
check exits non-zero.  The last three lines are the card's name and
power limit as ``nvidia-smi`` prints them, the per-kernel
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": {...}}``.

Needs a CUDA device and ``nvcc``; without a card it exits 1 and prints no
result.  It imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH_SLOTS = 8
# the first 64 requests of benchmarks/bench_engine.py's SERVICE_BURSTS
BURSTS = (1, 7, 19, 2, 30, 5)
N_INT8 = 16
FP32_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's fp32 bound
# int8: every brick partial is an exact integer and the fold rounds as
# the plain version's does, so only the order of float sums may differ
QUANT_REL = 2e-6
# Each layer on the card against the same layer of the plain path on the
# CPU, both fed the same input.
LAYER_TOL = 1e-4
# End to end the served logits against the CPU plain path's, relative to
# the largest CPU logit.  fp32 reassociation noise compounds through 13
# channel_norms (those over 2x2 maps divide by the std of 4 values): on
# seed 0 the CPU's own fp32 plain path is 2.6e-4 off a float64 dense
# forward on logits of ~5 (5e-5 relative) and the card 8.7e-4 off the
# CPU (1.8e-4 relative).  The limit is six times the CPU's own noise, so
# a kernel error that stays under LAYER_TOL per layer but adds up across
# the 14 layers still fails.
E2E_TOL = 3e-4
REPS = 20
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's ~1.98 GHz boost clock
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12  # CUDA cores (IEEE fp32 has no tensor-core path)
PEAK_INT8_OPS = 1979e12  # tensor cores
HBM_BYTES_PER_S = 3.35e12
# ou_mvm: the paper's 9x8 OU; per column, the kernel within
# OU_TOL * (1 + sum_r |x_r w_rc|) of its plain version (the reference's
# 1e-5 bound, tests/test_kernels.py, scaled by the column's magnitude)
OU_ROWS, OU_COLS = 9, 8
OU_TOL = 1e-5
OU_SWEEP = ((100, 52, 9, 8), (64, 64, 16, 8), (27, 8, 9, 8))
# hardware_report fields that depend on no activation: equal exactly
# between the program on the card and the same program on the CPU
PRICE_FIELDS = ("crossbars", "naive_crossbars", "area_cells",
                "naive_area_cells", "energy_pj", "cycles", "index_kb",
                "mapping", "precision")

KERNELS = {
    "pattern_spmm_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pattern_spmm.cu",
        "replaces": "src/repro/kernels/pattern_spmm.py:58",
    },
    "pattern_spmm_quant_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pattern_spmm.cu",
        "replaces": "src/repro/kernels/pattern_spmm.py:126",
    },
    "ou_mvm_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ou_mvm.cu",
        "replaces": "src/repro/kernels/ou_mvm.py:47",
    },
    "flash_attention_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
    },
    "conv_patches_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv_patches.cu",
        "replaces": None,  # the reference leaves im2col to XLA
    },
    "conv_patches_q8_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv_patches_q8.cu",
        "replaces": None,  # XLA's im2col and quantization in the reference
    },
}
# conv patches, timed besides at the benchmark's two served shapes
# (h100bench/configs): VGG16 at 16 x 224^2 and 128 x 32^2, K padded to
# the programs' bricks of PATCH_BLOCK
PATCH_SHAPES = (("vgg16_imagenet", 224, 16), ("vgg16_cifar10", 32, 128))
PATCH_BLOCK = 128
# flash attention: tests/test_kernels.py's sweep (b, hq, hkv, sq, sk, d),
# causal only where sq == sk, with and without a window of 33, in the three
# input types; then the generation path's own calls (h2o-danube-1.8B: 32
# query heads over 8 key heads, D 80, bf16, window 4096), each at a prompt
# length of FLASH_PATH_S both as a bare [S, S] attention and as the
# prefill reads it: keys from the [1, max_seq, 8, 80] cache through a
# transposed view, kv_len = S < max_seq; and once with kv_len < Sq = Sk.
# The last sweep shape is paligemma's heads (16, 8 of them padded, over 1
# kv head) at D 256, the kernels' 256-wide builds
FLASH_SWEEP = ((1, 2, 1, 64, 64, 32), (2, 4, 2, 100, 100, 64),
               (1, 3, 3, 128, 256, 32), (1, 8, 2, 77, 77, 80),
               (1, 16, 1, 130, 130, 256))
FLASH_TYPES = ("float32", "bfloat16", "float16")
FLASH_HEADS = (32, 8, 80)  # query heads, key heads, head dim
FLASH_PATH_S = (17, 128, 1000, 4500)
FLASH_WINDOW = 4096
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense


def flash_tolerance(dtype: str) -> dict:
    """tests/test_kernels.py's ``_tolerance``: bf16 (and fp16) inputs with
    fp32 accumulators differ by a few ULPs of bf16 between two routes."""
    return (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
            else dict(rtol=8e-2, atol=4e-2))


# The rounding limit, for 16-bit inputs besides ``flash_tolerance``: the
# kernel rounds its fp32 result once into the input type, so it lies
# within half an ulp (2^-8 relative in bf16, 2^-11 in fp16) of the plain
# version computed in fp32 from the same inputs, plus the two fp32 sums'
# own difference, FLASH_SUM_SLACK of the query row's largest |value|.
# ``_tolerance`` alone is wider than an output of the path (softmax means
# of ~500-4096 keys, |o| ~ 0.01-0.02) and lets a key too many or too few
# through; scripts/flash_fault_check.py plants such faults and shows that
# this limit fails each of them (PERF.md).
FLASH_HALF_ULP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
FLASH_SUM_SLACK = 2.0 ** -16


# generation: full-width, full-depth h2o-danube-1.8B with the paper's
# pattern-sparse MLPs, weights from the seed
GEN_SCFG = dict(batch_slots=8, max_seq=6144, eos_id=-1)
GEN_REQUESTS = 24
GEN_LENGTHS = (16, 1024)  # seeded prompt lengths, none a multiple of 128
GEN_LONG = 4500  # one prompt longer than the window: it masks in the kernel
GEN_LONG_AT = 9  # its place in the arrival order
GEN_NEW = 32  # new tokens per request
GEN_BURSTS = (1, 7, 5, 2, 6, 4)  # arrivals between service steps
# prefill logits of the kernel route against the plain route on the card.
# bf16: no farther apart than twice the plain bf16 route's own distance
# from the same model in float32 (the bf16 rounding noise of this model
# and prompt); float32: both routes in float32 within GEN_FP32_REL of each
# other (a wrong mask or a wrong softmax moves logits by O(1) relative).
# Relative to the largest logit of the plain route.
GEN_BF16_NOISE_FACTOR = 2.0
GEN_FP32_REL = 1e-3


# prune: the paper's flow on full-width VGG16 for CIFAR-10 (Table II's
# 86.03 % sparsity, 6 patterns a layer), trained on synthetic
# class-prototype batches made from the seed, pixels clipped to the
# certificate's declared input range
PRUNE_BATCH = 64
PRUNE_DENSE_STEPS = 40
PRUNE_CFG = dict(target_sparsity=0.8603, num_patterns=6, admm_steps=40,
                 admm_every=20, retrain_steps=20)
# AdamW's rate for all three stages: at 1e-3 the dense loss of this
# channel_norm VGG16 stays at ln 10 (chance) through the phase
PRUNE_LR = 1e-4
PRUNE_NOISE = 0.7  # tests/test_pruning.py's gen_batch
PRUNE_REQUESTS = sum(BURSTS)  # served in the serve phase's bursts


# shard: the sharded path.  (a) a one-rank mesh in this process (NCCL on
# the card); (b) SHARD_MESH = (data, model) ranks of a gloo group spawned
# on this one card (NCCL takes one card per rank), serving the same
# requests.  int8 against the unsharded int8 run: the reference's bars
# (tests/test_engine_sharded.py::test_sharded_quantized_forward).
SHARD_MESH = (2, 2)
SHARD_BACKEND = "gloo"  # scripts/shard_nccl.py runs (b) on NCCL, a card a rank
SHARD_TIMEOUT_S = 600  # a collective that waits longer fails the run
INT8_SHARD_ATOL = 5e-3
INT8_SHARD_AGREE = 0.98
# flash-decode: granite-3-2b at full width (no window, which the route
# needs), DECODE_LAYERS deep, bf16 weights from the seed; DECODE_BATCH
# prompts of DECODE_PROMPT tokens at one shared position, DECODE_STEPS
# steps.  The cache of DECODE_MAX_SEQ slots splits into SHARD_MESH[1]
# chunks, and the prompt reaches into the last one.
DECODE_LAYERS = 4
DECODE_BATCH = 4
DECODE_PROMPT = 150
DECODE_MAX_SEQ = 256
DECODE_STEPS = 6
# Each step's logits, relative to the largest float32 logit.  bf16 runs
# round their logits to bf16, so two of them differ by whole bf16 steps
# (one step of a logit near the largest is ~2^-8 relative) while either
# one's distance from float32 can be under half a step: a bf16 route is
# held against the float32 model, not against the other bf16 route.
DECODE_LIMIT = (f"bf16 flash vs float32 gather <= {GEN_BF16_NOISE_FACTOR} x "
                f"(bf16 gather vs float32 gather); float32 flash vs float32 "
                f"gather <= {GEN_FP32_REL}")
# (f) of the shard phase: DeepSeek-V2's smoke MoE (8 experts, top-2, 2
# shared), expert-parallel over the model dim, on SHARD_MOE_SHAPE inputs
# at the published capacity factor; within MOE_REL of each data shard's
# own unsharded result (capacity counts a shard's tokens)
SHARD_MOE_SHAPE = (4, 16)  # batch rows (split over data), tokens a row
MOE_REL = 1e-5


# lm_configs: the architectures that MoE, MLA and the MTP head unlock, each
# at its full published width, depth cut only as far as one H100's 80 GB
# forces (lm_config; PERF.md lists each cut with its bytes)
LM_LAYERS = {"deepseek_v2_236b": 3, "deepseek_v3_671b": 1,
             "qwen2_5_32b": 2, "phi3_medium_14b": 40}
# (c) DeepSeek-V2 served in bf16 through DecodeService: LM_REQUESTS seeded
# prompts of LM_LENGTHS tokens in LM_BURSTS, LM_NEW new tokens each
LM_SCFG = dict(batch_slots=4, max_seq=1024, eos_id=-1)
LM_REQUESTS = 8
LM_LENGTHS = (16, 600)
LM_NEW = 16
LM_BURSTS = (1, 3, 2, 2)
# (a) the absorbed MLA decode against the expanded one, fp32 (the
# reference's own bar, tests/test_models.py::test_mla_absorbed_matches_expanded)
MLA_REL = 2e-4
# (b) one MoE layer in fp32 on the first prompt (prefill) and on one token
# of each slot (decode)
# (d) DeepSeek-V3's MTP head on LM_MTP_SHAPE tokens without a cache
LM_MTP_SHAPE = (2, 256)
# (e) qwen2.5-32b and phi3-medium-14b: prefill logits of prompts of
# LM_DENSE_PROMPTS tokens on a cache of LM_DENSE_MAX_SEQ slots, bf16
# against float32 by the generate phase's rule
LM_DENSE_PROMPTS = (17, 300, 1000)
LM_DENSE_MAX_SEQ = 1024

# ssm_whisper: the architectures the SSM mixer and the encoder with
# cross-attention unlock, each at its published width (ssm_config):
# mamba2-780m and whisper-small whole, jamba-1.5-large its first
# JAMBA_LAYERS of 72 layers (48.0 GB of bf16 weights: the 4 SSM layers, the
# attention layer at position 4, 2 MoE layers of 16 experts; 6 layers would
# be 68 GB, and a float32 twin of the 5 96 GB)
JAMBA_LAYERS = 5
# (a) one SSM layer of each width in float32 against a token-by-token
# recurrence written here from the formulas (ssd_recurrence).  The final
# state and the conv window: every value within SSD_ATOL + SSD_RTOL *
# |recurrence|, tests/test_models.py's bound between its chunked scan and
# its recurrence (chunk 4 there).  The output: max|d| <= SSD_OUT_REL *
# max|recurrence|.  At a chunk of 128 the chunked form's decay exp(cum_i -
# cum_j) differences cumulative sums that reach hundreds, so its float32
# error is absolute at the output's scale, and the reference's own JAX
# scan misses the elementwise bound on outputs near zero by 5.1x at
# mamba2's width (scripts/ssd_chunk_error.py: max|d| 1.7e-5 of the
# largest); a wrong mask, group, decay or pad moves the output by O(1).
# S = 1000 pads the last chunk of 128; 4500 is the generate phase's long
# prompt.
SSD_S = {"mamba2_780m": (1000, 4500), "jamba_1_5_large_398b": (1000,)}
SSD_ATOL, SSD_RTOL = 1e-5, 1e-4
SSD_OUT_REL = 1e-4
# (b) and (d): the state handoff in float32.  Prefill P tokens into a
# cache, then HANDOFF_STEPS greedy decode steps (WHISPER_STEPS for
# whisper); the logits at the prefill's last position and at
# every step against one cacheless forward over all the tokens, within
# HANDOFF_REL of the largest logit.  Both run the same float32 model and
# differ only in the order of float sums (the chunked scan against the
# recurrence, a cache read against the in-register keys), ~1e-6 a layer;
# a state or a conv window not carried over, or a memory not kept, moves
# the logits by O(10 %) of the largest.
HANDOFF_PROMPTS = (17, 1000)
HANDOFF_STEPS = 4
HANDOFF_REL = 1e-4
# (c) mamba2 served in bf16 as the generate phase serves h2o-danube
# (GEN_SCFG, gen_prompts, GEN_NEW, GEN_BURSTS)
# jamba served in bf16 through DecodeService(JAMBA_SCFG): JAMBA_REQUESTS
# seeded prompts of JAMBA_LENGTHS tokens in JAMBA_BURSTS, JAMBA_NEW new
# tokens each
JAMBA_SCFG = dict(batch_slots=4, max_seq=1024, eos_id=-1)
JAMBA_REQUESTS = 8
JAMBA_LENGTHS = (16, 1000)
JAMBA_NEW = 16
JAMBA_BURSTS = (1, 3, 2, 2)
# whisper: (d) one prompt of WHISPER_PROMPT tokens on WHISPER_FRAMES stub
# frame embeddings [1, enc_seq, d], then WHISPER_STEPS greedy decode
# steps; (e) a bf16 batch of WHISPER_BATCH prompts against the float32
# model on the same inputs
WHISPER_PROMPT = 32
WHISPER_STEPS = 8
WHISPER_BATCH = 4

# vlm: paligemma-3b whole (18 layers, d_model 2048, vocabulary 257,216),
# weights from the seed, with the stub SigLIP tower's output: prefix_len
# (256) seeded patch embeddings [1, 256, d_model] in front of prompts of
# VLM_PROMPTS tokens, so the flash kernel (16 q heads over 1, D 256) sees
# Sq = 272, 556 and 1256, keys from a cache of VLM_MAX_SEQ slots.
# (a) each prefill's flash calls at those shapes, bf16 on the tensor cores
# at the flash phase's rounding limit and fp32 on the SIMT kernel at
# flash_tolerance, each the same bits on a rerun.  (b) float32: the
# cached prefill with the prefix and VLM_HANDOFF_STEPS greedy decode
# steps against one cacheless forward, within HANDOFF_REL.  (c) bf16
# (the float32 weights rounded): prefill logits by the generate phase's
# rule; the first token of make_prefill_step is the bf16 prefill's
# argmax; VLM_DECODE tokens through make_decode_step after it; text-only
# requests served through DecodeService(VLM_SCFG) as the reference serves
# paligemma, co-batched = alone.  Flash launches = 18 x the prefills, all
# on the tensor cores.
VLM_PROMPTS = (16, 300, 1000)
VLM_MAX_SEQ = 1536
VLM_HANDOFF_STEPS = 8
VLM_DECODE = 32
VLM_SCFG = dict(batch_slots=4, max_seq=1024, eos_id=-1)
VLM_REQUESTS = 8
VLM_LENGTHS = (16, 600)
VLM_NEW = 16
VLM_BURSTS = (1, 3, 2, 2)

# train: h2o-danube-1.8B as the generate phase serves it (24 layers,
# d_model 2560, vocabulary 32,000, pattern-sparse MLPs, bf16 params from
# the seed), AdamW with float32 moments, through runtime.train's Trainer
# on the plain routes.  (a) TRAIN_STEPS steps at full depth on
# TRAIN_BATCH packed batches of a SyntheticCorpus of TRAIN_CORPUS_VOCAB
# tokens (valid ids of the 32,000; the corpus at 32,000 would be a
# 32,000^2 float64 matrix, 8.2 GB): the mean of the last TRAIN_LAST
# losses below the first by more than TRAIN_FALL (tests/test_train.py's
# bar), one checkpoint at the end, timed.  (b) the restart drill at full
# width with the depth cut to DRILL_LAYERS (a full-depth state is ~18 GB
# to write each time): async checkpoints every DRILL_CKPT_EVERY steps, a
# failure injected at DRILL_FAIL_AT, a fresh Trainer restored from the
# latest checkpoint and the data fast-forwarded; every loss and the final
# state bit-equal to an uninterrupted run, under
# torch.use_deterministic_algorithms, in a process of its own.  (c) (a)'s
# trained weights served
# through DecodeService(TRAIN_SCFG): flash launches = 24 x the prefills,
# all on the tensor cores, each prompt's prefill calls held to the flash
# phase's rounding limit, each served first token its prefill's argmax.
# (d) each kernel wrapper refuses a CUDA input that requires grad, and a
# granite-3-2b smoke float32 step on the card gives the CPU's loss and
# grad norm within GUARD_REL.
# (a) runs with the reference's remat (ModelConfig.remat, the default)
# and the state donated to each step, as the launcher's step takes it;
# its peak lies within DRYRUN_PEAK_REL of the donated step's reckoned
# bytes (train_reckoning: the state, the grads and the global norm's
# float32 square of the largest leaf; the grads clipped and the moments
# and params updated in place, AdamW's float32 temporaries a piece's)
# and of the dryrun phase's prediction of one such step.  (b)'s
# interrupted and resumed runs donate too, the uninterrupted one does
# not: their losses and final state equal bit for bit.  (f), in the
# drill's process: one batch's loss and gradients with remat and
# without, bit for bit (step.loss_and_grads).
TRAIN_BATCH = (4, 512)  # rows, tokens a row
TRAIN_STEPS = 8
TRAIN_CORPUS_VOCAB = 1024
TRAIN_LR = 1e-3
TRAIN_LAST = 2
TRAIN_FALL = 0.1
DRILL_LAYERS = 2
DRILL_CKPT_EVERY = 2
DRILL_FAIL_AT = 5
TRAIN_SCFG = dict(batch_slots=4, max_seq=1024, eos_id=-1)
TRAIN_REQUESTS = 8
TRAIN_LENGTHS = (16, 600)
TRAIN_NEW = 16
TRAIN_BURSTS = (1, 3, 2, 2)
GUARD_REL = 1e-5
# cuBLAS is reproducible under torch.use_deterministic_algorithms only
# with this workspace config, read when a process first starts cuBLAS.
# The drill's spawned process gets it in its environment; set for this
# whole script (the earlier phases start cuBLAS), it slowed the generate
# phase's host-bound decode by over a third on an H100 80GB HBM3 at 700
# W (scripts/cublas_workspace_ab.py; PERF.md)
DRILL_CUBLAS_WORKSPACE = ":4096:8"

# a picklable function each rank of (b) calls before anything else (None:
# nothing; the CPU rehearsal installs its counting plain versions there)
SHARD_PREPARE = None

# The train_shard phase: (e) in the drill's process, the sharded
# step on a one-rank mesh (NCCL on the card) for ONE_RANK_STEPS steps of
# the drill's model, bit-equal to the unsharded steps; (f) a
# SHARD_TRAIN_MESH (data, model) gloo mesh of spawned ranks on this card
# training h2o-danube-1.8B at full width cut to SHARD_TRAIN_LAYERS layers
# in float32 params, SHARD_TRAIN_STEPS steps of SHARD_TRAIN_BATCH (each
# rank its rows): every step's loss within SHARD_TRAIN_REL of the
# unsharded float32 run (on rank 0), the params gathered after each step
# by tests/test_torch_train_step.py's rule (off the unsharded step by >=
# ADAM_OFF x lr only where the step-1 gradient is below NOISE_FLOOR of
# its leaf's largest or ADAM_EPS_REGION x Adam's eps, at most MAX_ILL of
# all weights; after step 2 the share alone; where a part's own float32
# reference, stepped from params moved by one ulp (NUDGES seeds), fails
# that rule against its unmoved run (mamba2's on an H100), and the part
# is not held to the fixed floors alone ((f) and (h) are), also where
# that weight's measured change of g (reference_noise) can move Adam's
# first step by ADAM_OFF x lr, with no more weights off than the
# reference's own worst), each rank's resident param and moment bytes =
# those reckoned from param_shardings / _zero1 before the run, the
# checkpoint of the last step (whole leaves, rank 0 writes) restored in
# this one-rank process bit-equal (sha256 per leaf); the same run in bf16
# params reported beside the unsharded bf16 run's distance from float32;
# (g) pipeline_apply over PIPE_STAGES gloo ranks of a stage mesh: one
# danube decoder layer at full width in float32 (kernels=False) as the
# layer, PIPE_LAYERS layers, PIPE_MICRO microbatches of 1 x PIPE_TOKENS,
# within PIPE_REL of the largest |value| of the sequential fold on one
# rank (bit-equality reported); (h) jamba-1.5-large at smoke width
# (jamba_shard_config; a full-width MoE layer in float32 with its moments
# does not fit a quarter of the card), JAMBA_SHARD_BATCH, the gates of
# (f), held to the unsharded run at 2 microbatches: MoE counts capacity
# on each data block's rows alone, as the reference's sharded step does
# (every MoE part on a mesh with data > 1 so: oracle_microbatches); (i) DeepSeek-V2 at full width cut to its first layer (MLA and the
# dense MLP), DEEPSEEK_SHARD_BATCH, and (j) mamba2-780m at full width cut
# to MAMBA_SHARD_LAYERS layers, MAMBA_SHARD_BATCH, the gates of (f) but
# the checkpoint ((f) and (h) cover it); on a WIDE_SHARD_MESH (data,
# model) mesh of the same four ranks, (k) phi3-medium-14B at full width
# cut to PHI3_SHARD_LAYERS layers, PHI3_SHARD_BATCH (its 48 padded query
# heads over 4 ranks, each reading the 3 or 4 of the 10 key heads its
# heads need, re-laid out from 320-column slabs), and (l) whisper-small
# whole, WHISPER_SHARD_BATCH with seeded frames (16 padded heads over 12
# key heads, ungrouped; the encoder's 1500 frames split over 4), the
# gates of (j).  Every part computes on the model slabs
# (parallel.tensor), its residual stream split over model along the
# sequence (512 positions): each step all-gathers no param (the leaves
# not computed on their slabs: none in these models), all-reduces,
# reduce-scatters, all-gathers along the sequence and re-lays out over
# model the bytes parallel.tensor.model_bytes reckons from the shapes for
# the rank's model coordinate (each period's forward again, remat),
# reduce-scatters over data the ZeRO-1 moment slabs' bytes of its
# gradients, and its bf16 run stays within SHARD_TRAIN_BF16_REL of the
# unsharded bf16 run.
ONE_RANK_STEPS = 2
SHARD_TRAIN_MESH = (2, 2)
SHARD_TRAIN_LAYERS = 4
SHARD_TRAIN_BATCH = (4, 512)
SHARD_TRAIN_STEPS = 2
SHARD_TRAIN_REL = 1e-4
ADAM_OFF = 0.05  # of lr
NOISE_FLOOR = 1e-5
ADAM_EPS = 1e-8  # optim.adamw's default eps
ADAM_EPS_REGION = 10
MAX_ILL = 1e-3
NUDGES = 3  # one-ulp moves of the reference's params (seeds)
SGD_LR = 1e3  # p0 - p1 = lr * g recovers the step-1 gradient
SHARD_TRAIN_BF16_REL = 1e-2
JAMBA_SHARD_BATCH = (4, 256)
DEEPSEEK_SHARD_BATCH = (4, 512)
MAMBA_SHARD_LAYERS = 8
MAMBA_SHARD_BATCH = (4, 512)
WIDE_SHARD_MESH = (1, 4)
PHI3_SHARD_LAYERS = 2
PHI3_SHARD_BATCH = (4, 512)
WHISPER_SHARD_BATCH = (4, 512)
PIPE_STAGES = 4
PIPE_LAYERS = 8
PIPE_MICRO = 6
PIPE_TOKENS = 256
PIPE_REL = 1e-6


# The entry_points phase: the launcher serves full-width, full-depth
# h2o-danube-1.8B (ENTRY_NEW tokens a request); the HTTP twin's --check
# serves ENTRY_HTTP requests a backend (ci.yml's serve-smoke count: fewer
# leave generation's occupancy under its floor, in the reference too)
ENTRY_NEW = 16
ENTRY_SERVE_ARGS = ["--arch", "h2o_danube_1_8b", "--requests", "8",
                    "--slots", "4", "--prompt-len", "16", "--new-tokens",
                    str(ENTRY_NEW)]
ENTRY_HTTP = 100
ENTRY_TIMEOUT_S = 300


# the dryrun phase: (a) the train phase's step predicted (remat: the
# checkpointed peak, the FLOPs with the recomputed forward), then
# measured, and the train phase's own peak held to the prediction; then
# the step's loss and gradients alone, with remat and without, each
# peak held to its prediction and the measured fall to at least
# REMAT_FALL_SHARE of the predicted (the activations remat drops); (b)
# (f)'s collectives, its gradients' reduce-scatter over data included;
# (c) placed serving of danube cut as (f) on the 2 x 2 gloo mesh, every
# layer on its model slabs, the sparse MLPs' tiles through the
# pattern-spmm kernel (each call within FP32_TOL of its plain version);
# (d) the production cells planned through run_cell; (e) qwen2.5-32B at
# full width cut to WIDE_SERVE_LAYERS layers, float32 with a bf16 cache,
# placed on a WIDE_SHARD_MESH of the same four ranks, served on the
# gather and the flash decode routes
DRYRUN_PEAK_REL = 0.10
REMAT_FALL_SHARE = 0.5
DRYRUN_BATCH = 4  # (c): prompts, split over data
DRYRUN_PROMPT = 124  # (c): prompt tokens; decode crosses the slab edge at 128
DRYRUN_MAX_SEQ = 256  # (c): cache positions, split over model
DRYRUN_DECODE = 8
# (c): the teacher-forced decode logits of the tile route against the
# config's own layouts, and of each rank's placed steps against the
# unsharded run, relative to each row's largest logit (a bf16 cache
# carries float32 reassociation to about 5e-4; another sparse function
# is O(1) off)
DRYRUN_LOGITS_REL = 1e-2
DRYRUN_CELLS = (("h2o_danube_1_8b", "train_4k"),
                ("qwen2_5_32b", "decode_32k"))
DRYRUN_TIMEOUT_S = 600
WIDE_SERVE_LAYERS = 2
WIDE_SERVE_BATCH = 4  # (e): prompts; data is 1, so every rank serves all
WIDE_SERVE_PROMPT = 124  # (e): split over 4 model ranks along the sequence
WIDE_SERVE_MAX_SEQ = 256  # (e): 4 position slabs of 64; decode crosses 128
WIDE_SERVE_DECODE = 8


def prune_model_config():
    """The ``prune`` phase's network: the paper's VGG16 for CIFAR-10."""
    from repro_torch.models.cnn import vgg16_config

    return vgg16_config(10, 32)


def _jsonable(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"not JSON serializable: {type(v)}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=_jsonable),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_model(seed: int):
    """(cfg, numpy params, pattern bits): ``synthesize_network`` for the
    13 convs with zero biases, as ``benchmarks/bench_engine.py`` builds
    it, and a seeded normal FC (zeros there would tie every logit).  A
    conv bias would make a channel whose inputs are all zero a nonzero
    constant, which ``channel_norm`` divides by its eps."""
    from repro_torch.core.synthetic import synthesize_network
    from repro_torch.models.cnn import vgg16_config

    stats, layers = synthesize_network("cifar10", seed=seed)
    cfg = vgg16_config(num_classes=10, input_hw=stats.input_hw)
    rng = np.random.default_rng(seed + 1)
    params, bits = {}, {}
    for i, layer in enumerate(layers, start=1):
        spec = layer.spec
        params[f"conv{i}"] = {
            "w": layer.weights.reshape(spec.c_out, spec.c_in, 3, 3),
            "b": np.zeros(spec.c_out, np.float32),
        }
        bits[f"conv{i}"] = layer.pattern_bits
    c_last = cfg.conv_channels[-1][1]
    params["fc"] = {
        "w": (rng.normal(size=(c_last, cfg.num_classes))
              / np.sqrt(c_last)).astype(np.float32),
        "b": (0.1 * rng.normal(size=cfg.num_classes)).astype(np.float32),
    }
    return cfg, params, bits


def _host(a):
    import torch

    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def program_mismatches(a, b) -> list[str]:
    """Names of the arrays in which two programs differ (dtype or bits)."""
    bad = []

    def same(name, x, y):
        x, y = _host(x), _host(y)
        if x is None or y is None:
            if not (x is None and y is None):
                bad.append(name)
        elif x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(name)

    layers = [(c.name, c, d) for c, d in zip(a.convs, b.convs)]
    layers.append(("fc", a.fc, b.fc))
    if len(a.convs) != len(b.convs):
        bad.append("convs")
    for name, x, y in layers:
        same(f"{name}.bias", x.bias, y.bias)
        if name != "fc":
            same(f"{name}.pattern_bits", x.pattern_bits, y.pattern_bits)
        for field in ("w_comp", "block_ids", "w_scales", "nnz", "new_order",
                      "inv_order", "dict_masks"):
            same(f"{name}.bp.{field}", getattr(x.bp, field),
                 getattr(y.bp, field))
    return bad


def layer_cases(prog, rng, dev):
    """One kernel case per spmm of a forward at ``BATCH_SLOTS`` images:
    (name, bp, x) with seeded activations in the real feature columns and
    zeros in the padding, as the executor pads them."""
    import torch

    ops = [(op.name, op.bp, BATCH_SLOTS * op.out_hw ** 2, op.k_unpadded)
           for op in prog.convs]
    ops.append(("fc", prog.fc.bp, BATCH_SLOTS, prog.fc.d_in))
    cases = []
    for name, bp, m, k_real in ops:
        x = np.zeros((m, bp.k_in), np.float32)
        x[:, :k_real] = rng.normal(size=(m, k_real))
        cases.append((name, bp.to(dev), torch.as_tensor(x, device=dev)))
    return cases


def small_geometry_case(rng, dev):
    """Block 9, tile 8 (the smallest geometry in use), ragged rows, and a
    first tile with no bricks at all (``nnz[0] == 0``)."""
    import torch

    from repro_torch.core.sparse import build_block_pattern, nonzero_block_masks

    m, k, n, block, tile = 200, 81, 32, 9, 8
    w = rng.normal(size=(k, n)) / np.sqrt(k)
    keep = rng.random((k // block, 1, n)) < 0.4
    w = (w.reshape(k // block, block, n) * keep).reshape(k, n)
    w = w.astype(np.float32)
    w[:, :tile] = 0.0  # all-zero masks sort first: tile 0 holds no brick
    bp = build_block_pattern(w, block=block, tile=tile,
                             masks=nonzero_block_masks(w, block), device=dev)
    check(int(bp.nnz[0]) == 0, "small geometry: tile 0 should hold no brick")
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32), device=dev)
    return ("block9_tile8", bp, x)


def calls(kind, bp, x, dev):
    """(kernel, plain) zero-argument calls of a kernel's wrapper and of its
    plain version on the same operands, made once here as the executor
    makes them (``nnz`` on the device; int8 activations quantized per
    row and the bricks' K-major copy), so a timed call is the launch
    alone."""
    import torch

    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels import pattern_spmm as tk

    nnz = torch.as_tensor(bp.nnz, dtype=torch.int32, device=dev)
    if kind == "pattern_spmm_cuda":
        args = (x, bp.w_comp, bp.block_ids, nnz, bp.block)
        return (lambda: tk.pattern_spmm_cuda(*args),
                lambda: tk.pattern_spmm_plain(*args))
    xq, _ = quantize_rows(x)
    args = (xq, bp.w_comp, bp.block_ids, bp.w_scales, nnz, bp.block)
    wk = tk.kmajor_bricks(bp.w_comp)  # as the executor prepares it
    return (lambda: tk.pattern_spmm_quant_cuda(*args, w_kmajor=wk),
            lambda: tk.pattern_spmm_quant_plain(*args))


def spmm_plan(kind, bp, m: int) -> dict:
    """A spmm kernel's plan for one layer (``_split_plan`` of its shapes
    for fp32, ``_quant_plan`` for int8): block tile, splits and the
    first launch's blocks."""
    from repro_torch.kernels import pattern_spmm as tk

    planner = (tk._split_plan if kind == "pattern_spmm_cuda"
               else tk._quant_plan)
    plan = planner(m, bp.n_tiles, bp.tile, bp.k_max)
    return {"tile_rows": plan.bm, "tile_cols": plan.bn,
            "step_depth": plan.bk, "splits": plan.splits,
            "blocks": plan.blocks}


def reduce_launches_expected(prog, batches: int,
                             kind: str = "pattern_spmm_cuda") -> int:
    """Split reductions a run of ``batches`` forwards of ``prog`` at
    ``BATCH_SLOTS`` images launches: one per layer whose plan splits."""
    ms = [BATCH_SLOTS * op.out_hw ** 2 for op in prog.convs] + [BATCH_SLOTS]
    bps = [op.bp for op in prog.convs] + [prog.fc.bp]
    return batches * sum(spmm_plan(kind, bp, m)["splits"] > 1
                         for bp, m in zip(bps, ms))


def compare(kind, y, want, bp) -> dict:
    """Kernel output against its plain version, with the stated limit."""
    import torch

    torch.cuda.synchronize()
    d = (y - want).abs()
    out = {"max_abs_diff": float(d.max()) if d.numel() else 0.0}
    if kind == "pattern_spmm_cuda":
        lim = FP32_TOL["atol"] + FP32_TOL["rtol"] * want.abs()
        out["limit"] = f"|d| <= {FP32_TOL['atol']} + {FP32_TOL['rtol']}*|plain|"
        out["worst_over_limit"] = float((d / lim).max()) if d.numel() else 0.0
        out["ok"] = out["worst_over_limit"] <= 1.0
    else:
        scale = float(want.abs().max()) if want.numel() else 0.0
        rel = out["max_abs_diff"] / max(scale, 1e-30)
        single = [t for t in range(bp.n_tiles) if int(bp.nnz[t]) <= 1]
        exact = all(
            torch.equal(y[:, t * bp.tile:(t + 1) * bp.tile],
                        want[:, t * bp.tile:(t + 1) * bp.tile])
            for t in single
        )
        out.update(limit=f"max|d|/max|plain| <= {QUANT_REL}; single-brick "
                         "tiles exact",
                   rel=rel, single_brick_tiles=len(single),
                   single_brick_exact=exact, ok=rel <= QUANT_REL and exact)
    empty = [t for t in range(bp.n_tiles) if int(bp.nnz[t]) == 0]
    if empty:
        zero = all(not y[:, t * bp.tile:(t + 1) * bp.tile].any() for t in empty)
        out["empty_tiles_zero"] = zero
        out["ok"] = out["ok"] and zero
    return out


def cost(kind, bp, m: int) -> tuple[float, float]:
    """(bytes, operations) one call must move and do, counted from this
    call's data: each x block some tile uses read once, each stored brick
    read once (padded slots are never read), the index tables and (int8)
    the scales read once, the output written once."""
    nnz = np.asarray(bp.nnz)
    ids = _host(bp.block_ids)
    bricks = int(nnz.sum())
    used = {int(ids[t, k]) for t in range(bp.n_tiles) for k in range(nnz[t])}
    esize = 4 if kind == "pattern_spmm_cuda" else 1
    nbytes = (m * len(used) * bp.block * esize
              + bricks * bp.block * bp.tile * esize
              + ids.size * 4 + nnz.size * 4
              + m * bp.n_tiles * bp.tile * 4)
    if kind == "pattern_spmm_quant_cuda":
        nbytes += bricks * 4  # w_scales
    ops = 2.0 * m * bp.block * bp.tile * bricks
    return float(nbytes), ops


def device_ms(fn, dev) -> float:
    """Median device time of ``fn`` by CUDA events over ``REPS`` calls,
    each after a write of more than the L2 cache, as a forward finds the
    layer's weights (the model's 59 MB of fp32 weights exceed the L2).
    Before each call the device sleeps ``SLEEP_CYCLES`` (about 1 ms) so
    the host has enqueued the start event, the call and the end event
    before the device reaches them: the events time the device's work,
    not the host's wrapper, even for calls shorter than their enqueue."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def patch_cases(prog, rng, dev, batch: int = BATCH_SLOTS):
    """One conv-patch case per conv of a forward of ``prog`` at ``batch``
    images: (layer, x, k, k_pad) with x in the layout the executor hands
    the kernel (the uploaded NCHW images first, then the channels-last
    view of the previous spmm's output)."""
    import torch

    cases = []
    for i, op in enumerate(prog.convs):
        side = op.out_hw
        x = torch.as_tensor(rng.normal(size=(batch, side, side, op.c_in))
                            .astype(np.float32), device=dev)
        x = x.permute(0, 3, 1, 2)
        cases.append((op.name, x.contiguous() if i == 0 else x, op.kernel,
                      op.bp.k_in))
    return cases


def vgg16_patch_cases(input_hw: int, batch: int, dev, seed: int):
    """``patch_cases`` of VGG16 at ``input_hw`` and ``batch`` without a
    program: K padded to ``PATCH_BLOCK`` as the served programs pad it,
    activations drawn on the device."""
    import torch

    from repro_torch.models.cnn import vgg16_config

    cfg = vgg16_config(num_classes=10, input_hw=input_hw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    side, cases = input_hw, []
    for i, (c_in, _) in enumerate(cfg.conv_channels, start=1):
        x = torch.randn((batch, side, side, c_in), generator=gen,
                        device=dev).permute(0, 3, 1, 2)
        k_pad = -(-c_in * 9 // PATCH_BLOCK) * PATCH_BLOCK
        cases.append((f"conv{i}", x.contiguous() if i == 1 else x, 3, k_pad))
        if i in cfg.pool_after:
            side //= 2
    return cases


def patch_cost(x, k_pad: int) -> float:
    """Bytes one conv-patch call must move: the activations read once,
    the padded rows written once."""
    b, _, h, w = x.shape
    return float(4 * (x.numel() + b * h * w * k_pad))


def patch_check(name, x, k: int, k_pad: int) -> dict:
    """The conv-patch kernel against its plain version: a copy, so bit
    for bit, and again on a rerun."""
    import torch

    from repro_torch.kernels import patches as tp
    from repro_torch.kernels.patches import _halo_mode, _patch_plan

    y = tp.conv_patches_cuda(x, k, k_pad)
    want = tp.conv_patches_plain(x, k, k_pad)
    torch.cuda.synchronize()
    b, c, h, w = x.shape
    plan = _patch_plan(b, c, h, w, k)
    equal = bool(torch.equal(y, want))
    rerun = bool(torch.equal(tp.conv_patches_cuda(x, k, k_pad), y))
    return {"case": name, "x": list(x.shape), "k": k, "k_pad": k_pad,
            "halo_mode": _halo_mode(x), "tile": [plan.tb, plan.th, plan.tw],
            "chunk": plan.cc, "blocks": plan.tiles * plan.chunks,
            "max_abs_diff": float((y - want).abs().max()),
            "bit_equal": equal, "rerun_bit_identical": rerun,
            "ok": equal and rerun}


def patch_q8_check(name, x, k: int, k_pad: int) -> dict:
    """The int8 patch kernel against its plain version
    (``quantize_rows`` over the float rows, on the card): int8 rows and
    row scales bit for bit, and again on a rerun; ``max_abs_diff`` is the
    larger of the rows' and the scales' largest difference."""
    import torch

    from repro_torch.kernels import patches as tp
    from repro_torch.kernels.patches import _halo_mode, _q8_plan

    xq, scale = tp.conv_patches_q8_cuda(x, k, k_pad)
    want_q, want_s = tp.conv_patches_q8_plain(x, k, k_pad)
    torch.cuda.synchronize()
    b, c, h, w = x.shape
    plan = _q8_plan(b, c, h, w, k)
    equal = bool(torch.equal(xq, want_q) and torch.equal(scale, want_s))
    again = tp.conv_patches_q8_cuda(x, k, k_pad)
    rerun = bool(torch.equal(again[0], xq) and torch.equal(again[1], scale))
    return {"case": name, "x": list(x.shape), "k": k, "k_pad": k_pad,
            "halo_mode": _halo_mode(x), "tile": [plan.tb, plan.th, plan.tw],
            "chunk": plan.cc, "blocks": plan.tiles,
            "max_abs_diff": max(
                float((xq.int() - want_q.int()).abs().max()),
                float((scale - want_s).abs().max())),
            "bit_equal": equal, "rerun_bit_identical": rerun,
            "ok": equal and rerun}


def patch_q8_cost(x, k_pad: int) -> float:
    """Bytes one int8 patch call must move: the activations read once,
    the int8 rows and a float32 scale a row written once."""
    b, _, h, w = x.shape
    return float(4 * x.numel() + b * h * w * (k_pad + 4))


def patch_q8_times(cases, dev) -> list[dict]:
    """Device ms of the int8 patch kernel, of its plain version and of
    the route it replaced (the float32 patch kernel, then
    ``quantize_rows``) per case, with the bound: its bytes at HBM
    bandwidth."""
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels import patches as tp

    rows = []
    for name, x, k, k_pad in cases:
        ms = device_ms(lambda: tp.conv_patches_q8_cuda(x, k, k_pad), dev)
        plain = device_ms(lambda: tp.conv_patches_q8_plain(x, k, k_pad), dev)
        floats = device_ms(lambda: quantize_rows(
            tp.conv_patches_cuda(x, k, k_pad)), dev)
        nbytes = patch_q8_cost(x, k_pad)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"layer": name, "x": list(x.shape), "k_pad": k_pad,
                     "ms": ms, "plain_ms": plain, "float_rows_ms": floats,
                     "bytes": nbytes, "bound_ms": bound,
                     "hbm_share": bound / ms,
                     "gb_per_s": nbytes / (ms * 1e-3) / 1e9})
    return rows


def patch_times(cases, dev) -> list[dict]:
    """Device ms of the conv-patch kernel and of its plain version (the
    ``F.unfold``, transpose and pad the executor ran before it) per case,
    with the bound: its bytes at HBM bandwidth."""
    from repro_torch.kernels import patches as tp

    rows = []
    for name, x, k, k_pad in cases:
        ms = device_ms(lambda: tp.conv_patches_cuda(x, k, k_pad), dev)
        plain = device_ms(lambda: tp.conv_patches_plain(x, k, k_pad), dev)
        nbytes = patch_cost(x, k_pad)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"layer": name, "x": list(x.shape), "k_pad": k_pad,
                     "ms": ms, "plain_ms": plain, "bytes": nbytes,
                     "bound_ms": bound, "hbm_share": bound / ms,
                     "gb_per_s": nbytes / (ms * 1e-3) / 1e9})
    return rows


def host_ms(fn) -> float:
    """Median host wall time of ``fn`` ending in a device sync."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def layer_parity(prog, want_prog, images, dev, disp=None,
                 want_dev="cpu") -> list[dict]:
    """Each layer of ``prog`` through ``disp`` (default: the
    single-device dispatch on ``dev``) against the same layer of
    ``want_prog`` through the single-device dispatch on ``want_dev`` (the
    plain path on the CPU by default), both fed the latter's input to
    that layer: the per-layer difference without the compounding of
    earlier layers' rounding through 13 ``channel_norm``s."""
    import torch

    from repro_torch.engine.executor import _Dispatch, _run_conv, _run_fc

    got_d = disp or _Dispatch(dev)
    want_d = _Dispatch(torch.device(want_dev))
    x = torch.as_tensor(images, device=want_d.device)
    rows = []
    for op, wop in zip([*prog.convs, prog.fc],
                       [*want_prog.convs, want_prog.fc]):
        if op is prog.fc:
            x = x.mean(dim=(2, 3))
            want = _run_fc(wop, x, want_d, want_d.prepare(wop.bp, wop.bias))
            got = _run_fc(op, x.to(dev), got_d, got_d.prepare(op.bp, op.bias))
        else:
            want, _ = _run_conv(wop, x, want_d,
                                want_d.prepare(wop.bp, wop.bias))
            got, _ = _run_conv(op, x.to(dev), got_d,
                               got_d.prepare(op.bp, op.bias))
        diff = float((got.to(want.device) - want).abs().max())
        scale = float(want.abs().max())
        rows.append({"layer": getattr(op, "name", "fc"), "max_abs_diff": diff,
                     "max_abs": scale, "rel": diff / max(scale, 1.0)})
        x = want
    return rows


def mapping_mismatches(a, b) -> list[str]:
    """Layers whose searched mapping (or the FC reorder) differs."""
    bad = [c.name for c, d in zip(a.convs, b.convs)
           if (c.mapping is None) != (d.mapping is None)
           or (c.mapping is not None
               and c.mapping.to_manifest() != d.mapping.to_manifest())]
    if a.fc.reorder != b.fc.reorder:
        bad.append("fc.reorder")
    return bad


def spmm_checks(prog, rng, dev) -> tuple[list[dict], float]:
    """The fp32 spmm kernel against its plain version at every layer of
    ``prog``; returns the rows and the largest difference."""
    rows, worst = [], 0.0
    for name, bp, x in layer_cases(prog, rng, dev):
        kernel, plain = calls("pattern_spmm_cuda", bp, x, dev)
        res = compare("pattern_spmm_cuda", kernel(), plain(), bp)
        rows.append({"case": name, "m": x.shape[0], "k": bp.k_in,
                     "n": bp.n_out, "k_max": bp.k_max,
                     "bricks": int(bp.nnz.sum()), **res})
        worst = max(worst, res["max_abs_diff"])
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"pattern_spmm_cuda disagrees with its plain version on "
                   f"{bad}")
    return rows, worst


def ratios(rep) -> dict:
    """The paper's efficiency ratios of one ``hardware_report``."""
    return {
        "crossbars": rep["crossbars"],
        "naive_crossbars": rep["naive_crossbars"],
        "area_efficiency": rep["area_efficiency"],
        "area_cells": rep["area_cells"],
        "naive_area_cells": rep["naive_area_cells"],
        "area_cells_ratio": rep["naive_area_cells"] / rep["area_cells"],
        "energy_pj": rep["energy_pj"],
        "naive_energy_pj": rep["naive_energy_pj"],
        "energy_ratio": rep["naive_energy_pj"] / rep["energy_pj"],
    }


def search_phase(seed, cfg, params, tparams, bits, images, dense_labels,
                 fixed_prog, dev) -> dict:
    """Compile with the mapping search on the card, hold it against the
    same compile on the CPU, serve it with skip statistics and price the
    served traffic.  Returns the spmm launches and largest kernel error."""
    import torch

    from repro_torch.core.mapping import MappingCandidate
    from repro_torch.engine import (
        CompileOptions,
        InferenceService,
        compile_network,
        load_program,
        make_forward,
        save_program,
    )
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.api import Request

    tracer = Tracer()
    t0 = time.perf_counter()
    prog = compile_network(
        cfg, tparams, bits,
        options=CompileOptions(optimize="auto", tracer=tracer), device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin = compile_network(cfg, params, bits,
                           options=CompileOptions(optimize="auto"),
                           device="cpu")
    cpu_s = time.perf_counter() - t0
    check(all(isinstance(c.mapping, MappingCandidate) for c in prog.convs),
          "a conv of the searched program carries no MappingCandidate")
    mism = program_mismatches(prog, twin) + mapping_mismatches(prog, twin)
    check(not mism, f"searched compile on the card differs from the CPU's "
                    f"in {mism}")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = save_program(os.path.join(tmp, "vgg16_searched"), prog)
        loaded = load_program(path, device=dev)
        cpu_prog = load_program(path, device="cpu")
    for other, where in ((loaded, "card"), (cpu_prog, "CPU")):
        mism = program_mismatches(prog, other) + mapping_mismatches(prog,
                                                                    other)
        check(not mism, f"searched save/load ({where}) changed {mism}")
    fixed_rep = fixed_prog.hardware_report()
    searched_rep = loaded.hardware_report()
    check(searched_rep["area_cells"] <= fixed_rep["area_cells"]
          and searched_rep["energy_pj"] <= fixed_rep["energy_pj"],
          "the searched mapping is worse than the fixed scheme")

    # the searched reorders give the spmm kernel a new brick layout
    kernel_rows, worst = spmm_checks(loaded, np.random.default_rng(seed + 4),
                                     dev)

    svc = InferenceService(loaded, batch_slots=BATCH_SLOTS, device=dev,
                           collect_stats=True)
    svc.warmup()
    # the searched path: counts from 0, the trace through the service, read
    tk.pattern_spmm_cuda.launches = 0
    tk.pattern_spmm_cuda.reduce_launches = 0
    reqs = [Request(image=img) for img in images]
    serve_s = serve_bursts(svc, reqs)
    launches = tk.pattern_spmm_cuda.launches
    reduce_launches = tk.pattern_spmm_cuda.reduce_launches
    spmms = len(loaded.convs) + 1
    check(all(r.done for r in reqs), "a request was not served")
    check(launches == spmms * svc.batches_run,
          f"pattern_spmm_cuda launches {launches} != {spmms} x "
          f"{svc.batches_run} batches of the searched program")
    want = reduce_launches_expected(loaded, svc.batches_run)
    check(reduce_launches == want, f"searched program's split reductions "
                                   f"{reduce_launches} != {want}")
    labels = np.array([r.label for r in reqs])
    check(bool((labels == dense_labels).all()),
          "the searched program's labels differ from the dense reference's")
    parity = layer_parity(loaded, cpu_prog, images[:BATCH_SLOTS], dev)
    bad = [r["layer"] for r in parity if r["rel"] > LAYER_TOL]
    check(not bad, f"searched layers {bad} differ from the CPU plain path")

    fwd = make_forward(loaded, tracer=Tracer(), device=dev)
    for _ in range(5):
        fwd(images[:BATCH_SLOTS])
    observed = fwd.observed_times()
    t0 = time.perf_counter()
    rep = svc.hardware_report(assumed_skip=0.5, observed=observed)
    report_s = time.perf_counter() - t0
    _, cpu_stats = make_forward(cpu_prog, collect_stats=True,
                                device="cpu")(images)
    cpu_rep = cpu_prog.hardware_report(skip_stats=cpu_stats, assumed_skip=0.5,
                                       observed=observed)
    differ = [f for f in PRICE_FIELDS if rep[f] != cpu_rep[f]]
    check(not differ, f"hardware_report fields {differ} differ between the "
                      f"card's program and the CPU's")
    names = sorted(c.name for c in loaded.convs)
    check(rep["skip"]["measured_layers"] == names,
          f"measured layers {rep['skip']['measured_layers']} != {names}")
    check(rep["energy_pj_measured"] <= rep["energy_pj"],
          "measured-skip energy above the no-skip bound")

    spans = {sp.name: sp for sp in tracer.spans()
             if sp.name.startswith("search:")}
    e_card, e_cpu = rep["energy_pj_measured"], cpu_rep["energy_pj_measured"]
    emit("search", model="vgg16 cifar10 (synthesize_network)",
         compile_seconds={"card": card_s, "cpu_twin": cpu_s},
         search_seconds={n: sp.dur for n, sp in spans.items()},
         evaluations={n: sp.args.get("evaluations") for n, sp in spans.items()
                      if n != "search:fc"},
         chosen={c.name: c.mapping.to_manifest() for c in loaded.convs},
         fc=spans["search:fc"].args if "search:fc" in spans else None,
         bricks={c.name: [int(c.bp.nnz.sum()), int(f.bp.nnz.sum())]
                 for c, f in zip(loaded.convs, fixed_prog.convs)},
         bricks_note="[searched, fixed]",
         bit_equal_vs_cpu_compile=True, round_trip_bit_equal=True,
         fixed=ratios(fixed_rep), searched=ratios(searched_rep),
         never_worse=True, kernel_cases=kernel_rows,
         requests=len(reqs), batches=svc.batches_run, launches=launches,
         reduce_launches=reduce_launches,
         requests_per_s=len(reqs) / serve_s,
         labels_match_dense=True, layer_limit=f"max|d| <= {LAYER_TOL} * "
                                              "max(1, max|cpu layer|)",
         layer_parity_vs_cpu=parity,
         report_seconds=report_s,
         price_fields_equal_cpu=list(PRICE_FIELDS),
         skip={k: rep["skip"][k] for k in (
             "assumed_probability", "measured_windows", "measured_layers",
             "energy_pj_noskip", "energy_pj_assumed", "energy_pj_measured",
             "measured_discount", "measured_vs_assumed_delta_frac")},
         measured_energy_card_vs_cpu={
             "card": e_card, "cpu": e_cpu,
             "rel_diff": (e_card - e_cpu) / e_cpu if e_cpu else None},
         measured_layer_energy=[
             {"layer": a["name"], "card": a["energy_pj_measured"],
              "cpu": b["energy_pj_measured"]}
             for a, b in zip(rep["layers"], cpu_rep["layers"])],
         drift=rep["drift"])
    return {"launches": launches, "max_abs_err": worst, "program": loaded}


def prune_batches(cfg, seed: int, lo: float, hi: float):
    """Endless class-prototype batches ``(x, y)`` of ``PRUNE_BATCH``
    images, as numpy: one seeded prototype per class, each image its
    class's prototype plus ``PRUNE_NOISE`` normal noise, clipped to
    ``[lo, hi]``."""
    rng = np.random.default_rng(seed)
    shape = (cfg.conv_channels[0][0], cfg.input_hw, cfg.input_hw)
    protos = rng.normal(size=(cfg.num_classes, *shape))
    while True:
        y = rng.integers(0, cfg.num_classes, size=PRUNE_BATCH)
        x = protos[y] + PRUNE_NOISE * rng.normal(size=(PRUNE_BATCH, *shape))
        yield np.clip(x, lo, hi).astype(np.float32), y


def attaining_image(w: np.ndarray, j: int, sign: float, amax: float,
                    hw: int) -> np.ndarray:
    """A ``[1, C, hw, hw]`` image whose conv1 patch around the centre
    pixel is ``sign * amax * sign(w[j])`` and zero elsewhere: the input
    in ``[-amax, amax]`` at which output column ``j``'s spmm + bias
    reaches ``b_j + sign * amax * sum|w_j|``, the certificate's
    ``pre_hi`` (``sign=+1``) or ``pre_lo`` (``sign=-1``) when ``j`` is the
    column that sets it."""
    _, c_in, k, _ = w.shape
    img = np.zeros((1, c_in, hw, hw), np.float32)
    c, r = hw // 2, k // 2
    img[0, :, c - r:c + r + 1, c - r:c + r + 1] = sign * amax * np.sign(w[j])
    return img


def bound_rounding_limit(b_j: float, w_j: np.ndarray, amax: float) -> float:
    """How far an fp32 spmm + bias may land from its exact value at the
    attaining input: ``n * 2^-24 * (|b_j| + amax * sum|w_j|)`` for the
    ``n`` terms it sums (the patch's products and the bias; 28 for a
    3x3x3 conv1)."""
    n = np.size(w_j) + 1
    return n * 2.0 ** -24 * (abs(float(b_j))
                             + amax * float(np.abs(w_j).astype(np.float64)
                                            .sum()))


def pre_activations(prog, images, dev) -> list:
    """Each spmm layer's output plus bias (before ``channel_norm``, ReLU
    and pooling; the logits for ``fc``) over ``images``, through the
    dispatch the forward uses on ``dev``, each layer fed the previous
    layer's output: ``[(name, [rows, columns] tensor)]``."""
    import torch

    from repro_torch.engine.executor import _Dispatch, _run_conv, _run_fc

    class Recording(_Dispatch):
        def walk(self, operand, prepared):  # reordered columns
            self.last = super().walk(operand, prepared)
            return self.last

    disp = Recording(dev)
    x = torch.as_tensor(images, device=dev)
    out = []
    for op in prog.convs:
        prep = disp.prepare(op.bp, op.bias)
        x, _ = _run_conv(op, x, disp, prep)
        y = disp.last.index_select(1, prep.inv_order)  # Output Indexing Unit
        out.append((op.name, y[:, :op.c_out] + prep.bias))
    prep = disp.prepare(prog.fc.bp, prog.fc.bias)
    out.append(("fc", _run_fc(prog.fc, x.mean(dim=(2, 3)), disp, prep)))
    return out


def prune_phase(seed: int, dev) -> dict:
    """The paper's flow, entirely in the port on the card: dense training
    of full-width VGG16, ADMM pattern pruning, strict compiles (verified,
    range-certified) in fp32 and int8 held against the same compiles on
    the CPU, save and reload with verification, the analysis CLI on the
    saved programs, serving through both spmm kernels, and the
    certificates held against the kernels' outputs.  Returns the spmm
    launches of its serving and the kernels' largest errors."""
    import torch
    import torch.nn.functional as F

    from repro_torch.analysis.ranges import DEFAULT_INPUT_RANGE
    from repro_torch.core.patterns import ALL_ZERO, kernel_masks, masks_to_bits
    from repro_torch.core.pruning import (
        PruneConfig,
        _grad,
        admm_pattern_prune,
        sparsity_of,
    )
    from repro_torch.engine import (
        CompileOptions,
        InferenceService,
        compile_network,
        load_program,
        make_forward,
        save_program,
    )
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.models.cnn import cnn_apply, conv_weight_names, init_cnn
    from repro_torch.obs.trace import Tracer
    from repro_torch.optim import adamw
    from repro_torch.serve.api import Request

    cfg = prune_model_config()
    names = conv_weight_names(cfg)
    lo, hi = DEFAULT_INPUT_RANGE
    amax = max(abs(lo), abs(hi))
    stream = prune_batches(cfg, seed + 6, lo, hi)

    def batches():
        for x, y in stream:
            yield (torch.as_tensor(x, device=dev),
                   torch.as_tensor(y, device=dev))

    def loss_fn(p, x, y):
        return F.cross_entropy(cnn_apply(cfg, p, x), y)

    # -- dense training ---------------------------------------------------
    params = init_cnn(cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = adamw(weight_decay=0.0)
    state = opt.init(params)
    data = batches()
    losses = []

    def recorded(p, x, y):
        loss = loss_fn(p, x, y)
        losses.append(loss.detach())
        return loss

    t0 = time.perf_counter()
    for _ in range(PRUNE_DENSE_STEPS):
        grads = _grad(recorded, params, *next(data))
        params, state = opt.update(grads, state, params, PRUNE_LR)
    dense_losses = torch.stack(losses).tolist()
    dense_s = time.perf_counter() - t0

    # -- ADMM pattern pruning ---------------------------------------------
    pcfg = PruneConfig(**PRUNE_CFG)
    tracer = Tracer()
    t0 = time.perf_counter()
    res = admm_pattern_prune(params, names, loss_fn, data, pcfg,
                             adamw(weight_decay=0.0), lr=PRUNE_LR, seed=seed,
                             tracer=tracer)
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t0
    stages = {sp.name: sp.dur for sp in tracer.spans("prune")}
    # the retrain span ends when its steps are enqueued; the device's
    # work is done at the synchronize above
    stages["retrain"] = prune_s - sum(v for k, v in stages.items()
                                      if k != "retrain")
    held_x, held_y = next(stream)
    with torch.no_grad():
        final_loss = float(loss_fn(res.params, torch.as_tensor(
            held_x, device=dev), torch.as_tensor(held_y, device=dev)))
    hparams = {n: {k: t.detach().cpu().numpy() for k, t in layer.items()}
               for n, layer in res.params.items()}
    layers = {}
    for n in names:
        pattern = res.pattern_bits[n]
        bits = masks_to_bits(kernel_masks(hparams[n]["w"]))
        used = sorted(set(np.unique(pattern).tolist()) - {ALL_ZERO})
        layers[n] = {
            "patterns_outside_dictionary": int((~np.isin(
                pattern, res.dictionaries[n].patterns)).sum()),
            "kernels_with_weights_outside_pattern": int(
                np.count_nonzero(bits & ~pattern)),
            # a pattern position left exactly zero: pruned before ADMM and
            # never moved by a gradient (its input channel is dead)
            "kernels_below_pattern": int(np.count_nonzero(bits != pattern)),
            "nonzero_patterns": len(used),
            "all_zero_kernels": float((pattern == ALL_ZERO).mean()),
            "sparsity": res.layer_sparsity(n),
        }
    bad = [n for n, r in layers.items()
           if r["patterns_outside_dictionary"]
           or r["kernels_with_weights_outside_pattern"]
           or r["nonzero_patterns"] > pcfg.num_patterns]
    check(not bad, f"pruned layers {bad} leave their pattern dictionaries: "
                   f"{ {n: layers[n] for n in bad} }")
    check(np.isfinite(final_loss) and np.isfinite(dense_losses).all(),
          "training loss not finite")

    # -- strict compiles, card against CPU --------------------------------
    progs, compile_s, spans = {}, {}, {}
    for prec in ("fp32", "int8"):
        ctr = Tracer()
        t0 = time.perf_counter()
        prog = compile_network(cfg, res.params, res.pattern_bits,
                               options=CompileOptions(precision=prec,
                                                      verify="strict",
                                                      tracer=ctr),
                               device=dev)
        compile_s[prec] = time.perf_counter() - t0
        spans[prec] = {sp.name: sp.dur for sp in ctr.spans("compile")
                       if sp.name in ("verify", "ranges")}
        t0 = time.perf_counter()
        twin = compile_network(cfg, hparams, res.pattern_bits,
                               options=CompileOptions(precision=prec,
                                                      verify="strict"),
                               device="cpu")
        compile_s[f"{prec}_cpu_twin"] = time.perf_counter() - t0
        check(prog.certificate is not None, f"{prec}: no certificate")
        check(prog.certificate.to_manifest() == twin.certificate.to_manifest(),
              f"{prec}: the card's certificate differs from the CPU's")
        check(prog.verify().to_json() == twin.verify().to_json(),
              f"{prec}: verifier reports differ between card and CPU")
        mism = program_mismatches(prog, twin)
        check(not mism, f"{prec}: strict compile differs from the CPU's in "
                        f"{mism}")
        progs[prec] = prog

    # -- save, reload with verification, the analysis CLI -----------------
    loaded, cpu_progs, load_s, cli = {}, {}, {}, {}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for prec, prog in progs.items():
            path = save_program(os.path.join(tmp, f"pruned_{prec}"), prog)
            t0 = time.perf_counter()
            loaded[prec] = load_program(path, device=dev)  # verifies
            load_s[prec] = time.perf_counter() - t0
            t0 = time.perf_counter()
            load_program(path, verify=False, device=dev)
            load_s[f"{prec}_unverified"] = time.perf_counter() - t0
            cpu_progs[prec] = load_program(path, device="cpu")
            check(not program_mismatches(prog, loaded[prec]),
                  f"{prec}: save/load changed the program")
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.analysis", "all", path,
                 "--json"], capture_output=True, text=True, env=env,
                cwd=ROOT, timeout=600)
            cli_s = time.perf_counter() - t0
            merged = json.loads(out.stdout) if out.returncode == 0 else {}
            cli[prec] = {
                "exit_code": out.returncode, "seconds": cli_s,
                "certificate_equal": merged.get("ranges", {}).get(
                    "certificate") == prog.certificate.to_manifest()}
            check(out.returncode == 0 and cli[prec]["certificate_equal"],
                  f"python -m repro_torch.analysis all on the {prec} program: "
                  f"exit {out.returncode} {out.stderr[-500:]}")

    # -- each spmm kernel against its plain version on the pruned bricks --
    rng = np.random.default_rng(seed + 7)
    max_err, kernel_rows = {}, {}
    for kname, prec in (("pattern_spmm_cuda", "fp32"),
                        ("pattern_spmm_quant_cuda", "int8")):
        rows = []
        for name, bp, x in layer_cases(loaded[prec], rng, dev):
            kernel, plain = calls(kname, bp, x, dev)
            r = compare(kname, kernel(), plain(), bp)
            rows.append({"case": name, "k_max": bp.k_max,
                         "bricks": int(bp.nnz.sum()), **r})
        kernel_rows[kname] = rows
        max_err[kname] = max(r["max_abs_diff"] for r in rows)
        bad = [r["case"] for r in rows if not r["ok"]]
        check(not bad, f"{kname} disagrees with its plain version on the "
                       f"pruned layers {bad}")

    # -- serving through both spmm kernels --------------------------------
    drawn = [next(stream) for _ in range(-(-PRUNE_REQUESTS // PRUNE_BATCH))]
    images = np.concatenate([x for x, _ in drawn])[:PRUNE_REQUESTS]
    truth = np.concatenate([y for _, y in drawn])[:PRUNE_REQUESTS]
    svc32 = InferenceService(loaded["fp32"], batch_slots=BATCH_SLOTS,
                             device=dev)
    svc8 = InferenceService(loaded["int8"], batch_slots=BATCH_SLOTS,
                            device=dev)
    svc32.warmup()
    svc8.warmup()
    # the pruned path: counts from 0, traffic through both services, read
    tk.pattern_spmm_cuda.launches = 0
    tk.pattern_spmm_quant_cuda.launches = 0
    reqs32 = [Request(image=img) for img in images]
    reqs8 = [Request(image=img) for img in images]
    serve32_s = serve_bursts(svc32, reqs32)
    serve8_s = serve_bursts(svc8, reqs8)
    launches = {"pattern_spmm_cuda": tk.pattern_spmm_cuda.launches,
                "pattern_spmm_quant_cuda": tk.pattern_spmm_quant_cuda.launches}
    spmms = len(cfg.conv_channels) + 1
    batches_run = {"fp32": svc32.batches_run, "int8": svc8.batches_run}
    check(all(r.done for r in reqs32 + reqs8), "a pruned request was not "
                                                "served")
    for kname, prec in (("pattern_spmm_cuda", "fp32"),
                        ("pattern_spmm_quant_cuda", "int8")):
        check(launches[kname] == spmms * batches_run[prec],
              f"{kname} launches {launches[kname]} != {spmms} x "
              f"{batches_run[prec]} {prec} batches of the pruned program")
    logits32 = np.stack([r.logits for r in reqs32])
    labels32 = np.array([r.label for r in reqs32])
    labels8 = np.array([r.label for r in reqs8])
    with torch.no_grad():
        dense = cnn_apply(cfg, res.params, torch.as_tensor(
            images, device=dev)).cpu().numpy()
    top2 = np.sort(dense, axis=1)[:, -2:]
    cpu_logits = make_forward(cpu_progs["fp32"], device="cpu")(images).numpy()
    e2e = float(np.abs(logits32 - cpu_logits).max()
                / max(1.0, float(np.abs(cpu_logits).max())))
    parity = layer_parity(loaded["fp32"], cpu_progs["fp32"],
                          images[:BATCH_SLOTS], dev)
    check(bool(np.isfinite(logits32).all()), "pruned logits not finite")
    check(bool((labels32 == dense.argmax(1)).all()),
          "pruned program's labels differ from the dense reference's")
    bad = [r["layer"] for r in parity if r["rel"] > LAYER_TOL]
    check(not bad, f"pruned layers {bad} differ from the CPU plain path")
    check(e2e <= E2E_TOL, f"pruned logits differ from the CPU plain path by "
                          f"{e2e} (relative) > {E2E_TOL}")

    # -- the certificates against the kernels ------------------------------
    prog32 = loaded["fp32"]
    cert = prog32.certificate.layer(prog32.convs[0].name)
    w1 = hparams[names[0]]["w"].astype(np.float64)
    b1 = np.asarray(prog32.convs[0].bias, np.float64)
    reach = amax * np.abs(w1).reshape(w1.shape[0], -1).sum(axis=1)
    hw = cfg.input_hw
    centre = (hw // 2) * hw + hw // 2
    bound_rows = []
    for which, sign, j, bound in (
        ("pre_hi", 1.0, int(np.argmax(b1 + reach)), cert.pre_hi),
        ("pre_lo", -1.0, int(np.argmin(b1 - reach)), cert.pre_lo),
    ):
        img = attaining_image(hparams[names[0]]["w"], j, sign, amax, hw)
        got = float(pre_activations(prog32, img, dev)[0][1][centre, j])
        limit = bound_rounding_limit(b1[j], hparams[names[0]]["w"][j], amax)
        bound_rows.append({"bound": which, "column": j, "certified": bound,
                           "kernel": got, "distance": abs(got - bound),
                           "limit": limit,
                           "ok": abs(got - bound) <= limit})
    check(all(r["ok"] for r in bound_rows),
          f"conv1 through the kernel misses its certified bound: "
          f"{bound_rows}")
    inside = {}
    for prec, prog in loaded.items():
        rows = []
        for (name, pre), entry in zip(pre_activations(prog, images, dev),
                                      prog.certificate.layers):
            check(name == entry.name, f"certificate order {entry.name} != "
                                      f"{name}")
            got_lo, got_hi = float(pre.min()), float(pre.max())
            rows.append({"layer": name, "min": got_lo, "max": got_hi,
                         "pre_lo": entry.pre_lo, "pre_hi": entry.pre_hi,
                         "inside": entry.pre_lo <= got_lo
                         and got_hi <= entry.pre_hi})
        inside[prec] = rows
        bad = [r["layer"] for r in rows if not r["inside"]]
        check(not bad, f"{prec}: layers {bad} leave their certified "
                       f"[pre_lo, pre_hi]")

    emit("prune", model="vgg16 cifar10, trained on class-prototype batches",
         seed=seed, batch=PRUNE_BATCH, dense_steps=PRUNE_DENSE_STEPS,
         prune_config=PRUNE_CFG, lr=PRUNE_LR,
         seconds={"dense_training": dense_s, **stages, "prune_total": prune_s},
         dense_loss_first_last=[dense_losses[0], dense_losses[-1]],
         final_loss_held_out=final_loss,
         sparsity=sparsity_of(res.params, names), layers=layers,
         compile_seconds=compile_s, verify_ranges_span_seconds=spans,
         load_seconds=load_s, analysis_cli=cli,
         certificate_equal_cpu=True, verifier_reports_equal_cpu=True,
         fp32_safe={p: g.certificate.fp32_safe for p, g in loaded.items()},
         kernel_cases=kernel_rows, requests=PRUNE_REQUESTS,
         batches=batches_run, launches=launches,
         requests_per_s={"fp32": PRUNE_REQUESTS / serve32_s,
                         "int8": PRUNE_REQUESTS / serve8_s},
         labels_match_dense=True,
         min_dense_top2_margin=float((top2[:, 1] - top2[:, 0]).min()),
         served_accuracy={"fp32": float((labels32 == truth).mean()),
                          "int8": float((labels8 == truth).mean())},
         e2e_rel_vs_cpu=e2e, layer_parity_vs_cpu=parity,
         int8_top1_agreement_vs_fp32=float((labels8 == labels32).mean()),
         conv1_bound=bound_rows, layers_inside_certificate=inside)
    return {"launches": launches, "max_abs_err": max_err}


def ou_cases(prog, params, images, dev) -> list[tuple]:
    """(case, x, w, ou_rows, ou_cols) on the card: each conv's dense
    im2col weight [C_in*9, C_out] at two patches of the layer's real
    input on the card (the centre, and the top-left corner, where the
    zero padding and ReLU's zeros empty whole bands), then the
    reference's sweep shapes, an all-zero x, and a NaN in the weights of
    a skipped band."""
    import torch

    from repro_torch.engine.executor import _Dispatch, _run_conv, extract_patches
    from repro_torch.engine.lowering import conv_matrix

    disp = _Dispatch(dev)
    x = torch.as_tensor(images[:1], device=dev)
    cases = []
    with torch.no_grad():
        for op in prog.convs:
            patches = extract_patches(x, op.kernel)[0]  # [H, W, C_in*9]
            mid = patches.shape[0] // 2
            w = torch.as_tensor(
                np.ascontiguousarray(conv_matrix(params[op.name]["w"])),
                dtype=torch.float32, device=dev)
            for where, patch in (("centre", patches[mid, mid]),
                                 ("corner", patches[0, 0])):
                cases.append((f"{op.name}/{where}", patch.contiguous(), w,
                              OU_ROWS, OU_COLS))
            x, _ = _run_conv(op, x, disp, disp.prepare(op.bp, op.bias))
    rng = np.random.default_rng(7)
    for r, c, ou_r, ou_c in OU_SWEEP:
        xs = rng.normal(size=r).astype(np.float32)
        xs[:ou_r] = 0.0
        cases.append((f"sweep_{r}x{c}_ou{ou_r}x{ou_c}",
                      torch.as_tensor(xs, device=dev),
                      torch.as_tensor(rng.normal(size=(r, c)).astype(
                          np.float32), device=dev), ou_r, ou_c))
    w13 = cases[2 * len(prog.convs) - 1][2]
    cases.append(("all_zero_x", torch.zeros(w13.shape[0], device=dev), w13,
                  OU_ROWS, OU_COLS))
    xs = rng.normal(size=27).astype(np.float32)
    xs[9:18] = 0.0
    ws = rng.normal(size=(27, 8)).astype(np.float32)
    ws[12, 3] = np.nan
    cases.append(("nan_in_skipped_band", torch.as_tensor(xs, device=dev),
                  torch.as_tensor(ws, device=dev), OU_ROWS, OU_COLS))
    return cases


def ou_live_rows(x, ou_rows: int):
    """bool [R]: the rows of the bands the kernel does not skip."""
    from repro_torch.kernels.ou_mvm import band_flags

    return band_flags(x, ou_rows).repeat_interleave(ou_rows)[: x.shape[0]]


def ou_mvm_phase(prog, params, images, dev) -> dict:
    """``ops.ou_mvm`` on the card at every case of :func:`ou_cases`,
    each against its plain version.  Returns the launches, the largest
    difference and the cases (for timing)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ou_mvm as tou

    cases = ou_cases(prog, params, images, dev)
    # the ou_mvm path: counts from 0, every case through ops.ou_mvm, read
    tou.ou_mvm_cuda.launches = 0
    outs = [ops.ou_mvm(x, w, ou_rows=r, ou_cols=c)
            for _, x, w, r, c in cases]
    torch.cuda.synchronize()
    launches = tou.ou_mvm_cuda.launches
    plans = [ou_plan(x, w, r) for _, x, w, r, _ in cases]
    check(launches == len(cases),
          f"ou_mvm_cuda launches {launches} != {len(cases)} calls")
    rows, worst = [], 0.0
    for (name, x, w, r, c), y, plan in zip(cases, outs, plans):
        want = tou.ou_mvm_plain(x, w, r, c)
        live = ou_live_rows(x, r)
        mag = ((x * live)[:, None] * torch.where(live[:, None], w, 0.0)).abs()
        lim = OU_TOL * (1.0 + mag.sum(dim=0))
        d = (y - want).abs()
        row = {"case": name, "r": w.shape[0], "c": w.shape[1],
               "ou": [r, c], "skipped_band_share": float(
                   1.0 - tou.band_flags(x, r).float().mean()),
               "max_abs_diff": float(d.max()),
               "worst_over_limit": float((d / lim).max()),
               "finite": bool(torch.isfinite(y).all()),
               # no atomics: a second run is bit for bit the first
               "rerun_bit_identical": bool(torch.equal(
                   tou.ou_mvm_cuda(x, w, r, c), y)), **plan}
        row["ok"] = (row["worst_over_limit"] <= 1.0 and row["finite"]
                     and row["rerun_bit_identical"])
        if name == "all_zero_x":
            row["ok"] = row["ok"] and not y.any()
        rows.append(row)
        worst = max(worst, row["max_abs_diff"])
    emit("ou_mvm", limit=f"|d_c| <= {OU_TOL} * (1 + sum_r |x_r w_rc|) over "
                         "the live bands", calls=len(cases), launches=launches,
         cases=rows)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"ou_mvm_cuda disagrees with its plain version on {bad}")
    return {"launches": launches, "max_abs_err": worst,
            "cases": cases[:2 * len(prog.convs)]}


def ou_plan(x, w, ou_rows: int) -> dict:
    """The ``ou_mvm`` kernel's plan for one call (``_ou_plan`` of its
    shapes): columns a block, blocks, rows a row-lane walks, passes of x
    through shared memory."""
    from repro_torch.kernels import ou_mvm as tou

    plan = tou._ou_plan(w.shape[0], w.shape[1],
                        tou._ou_vec(w.float().contiguous()))
    return {"slab_cols": plan.cols, "blocks": plan.blocks,
            "rows_per_lane": plan.rows_per_lane, "chunks": plan.chunks}


def ou_cost(x, w, ou_rows: int) -> tuple[float, float]:
    """(bytes, operations) of one ``ou_mvm`` call: x read and y written
    once, and the weight rows of the live bands read once; two
    operations per weight read."""
    live = int(ou_live_rows(x, ou_rows).sum())
    c = w.shape[1]
    return 4.0 * (x.shape[0] + c + live * c), 2.0 * live * c


def serve_bursts(svc, reqs, bursts=BURSTS) -> float:
    """Submit ``reqs`` in ``bursts``, one service step after each burst,
    then drain; returns the host seconds it took."""
    import torch

    it = iter(reqs)
    t0 = time.perf_counter()
    for burst in bursts:
        for _ in range(burst):
            svc.submit(next(it))
        svc.step()
    svc.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def flash_pairs(sq: int, kv_len: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves visible: what the attention
    must compute, whatever tiles a kernel walks."""
    q = np.arange(sq)
    hi = np.minimum(q, kv_len - 1) if causal else np.full(sq, kv_len - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cost(b, hq, hkv, sq, kv_len, d, esize, causal, window):
    """(bytes, operations) of one call: q, the kv_len rows of k and v
    and the output, each moved once; 4 * D operations per visible pair
    (the q.k dot and the p.v update) per query head."""
    nbytes = esize * b * d * (2 * sq * hq + 2 * kv_len * hkv)
    ops = 4.0 * d * b * hq * flash_pairs(sq, kv_len, causal, window)
    return float(nbytes), ops


def flash_cases(dev, max_seq: int) -> list[dict]:
    """Every flash case on the card (see ``FLASH_SWEEP``): q, k, v, the
    mask arguments and, for the path's prefill calls, ``path=True``."""
    import torch

    rng = np.random.default_rng(11)
    cases = []

    def normal(*shape):
        return torch.as_tensor((0.5 * rng.normal(size=shape)).astype(
            np.float32), device=dev)

    for b, hq, hkv, sq, sk, d in FLASH_SWEEP:
        for causal in (True, False):
            for window in (None, 33):
                if causal and sq != sk:
                    continue
                q, k, v = normal(b, hq, sq, d), normal(b, hkv, sk, d), \
                    normal(b, hkv, sk, d)
                for dt in FLASH_TYPES:
                    tdt = getattr(torch, dt)
                    cases.append(dict(
                        case=f"sweep_{b}x{hq}/{hkv}x{sq}x{sk}x{d}_"
                             f"{'causal' if causal else 'full'}_w{window}_"
                             f"{dt}",
                        q=q.to(tdt), k=k.to(tdt), v=v.to(tdt), causal=causal,
                        window=window, kv_len=None, dtype=dt, path=False))
    hq, hkv, d = FLASH_HEADS
    for s in FLASH_PATH_S:
        q = normal(1, hq, s, d).bfloat16()
        kv = normal(2, max_seq, hkv, d).bfloat16()  # [k|v, T, Hkv, D]
        k, v = kv[0:1].transpose(1, 2), kv[1:2].transpose(1, 2)
        cases.append(dict(case=f"path_S{s}_bare", q=q,
                          k=k[:, :, :s].contiguous(),
                          v=v[:, :, :s].contiguous(), causal=True,
                          window=FLASH_WINDOW, kv_len=None, dtype="bfloat16",
                          path=False))
        cases.append(dict(case=f"path_S{s}_cache", q=q, k=k, v=v, causal=True,
                          window=FLASH_WINDOW, kv_len=s, dtype="bfloat16",
                          path=True, heads=FLASH_HEADS,
                          model="h2o_danube_1_8b"))
    # padded keys inside the queries' span: kv_len < Sq = Sk
    s = FLASH_PATH_S[-2]
    kv = normal(2, 1, hkv, s, d).bfloat16()
    cases.append(dict(case=f"path_S{s}_kvlen{7 * s // 10}",
                      q=normal(1, hq, s, d).bfloat16(), k=kv[0], v=kv[1],
                      causal=True, window=FLASH_WINDOW, kv_len=7 * s // 10,
                      dtype="bfloat16", path=False))
    # the lm_configs phase's qwen2.5-32b prefills: padded q heads over its
    # kv heads at D 128, no window, keys from its LM_DENSE_MAX_SEQ cache
    acfg = lm_config("qwen2_5_32b").attn_cfg(False)
    heads = (acfg.hq_pad, acfg.n_kv_heads, acfg.d_head)
    for s in LM_DENSE_PROMPTS:
        kv = normal(2, LM_DENSE_MAX_SEQ, heads[1], heads[2]).bfloat16()
        cases.append(dict(case=f"qwen_S{s}_cache",
                          q=normal(1, heads[0], s, heads[2]).bfloat16(),
                          k=kv[0:1].transpose(1, 2), v=kv[1:2].transpose(1, 2),
                          causal=True, window=None, kv_len=s,
                          dtype="bfloat16", path=True, heads=heads,
                          model="qwen2_5_32b"))
    # the vlm phase's paligemma prefills: 16 q heads over 1 at D 256, no
    # window, the patches and the prompt from its VLM_MAX_SEQ cache; bf16
    # (the path's type) and fp32 (the SIMT route at the same shapes)
    vcfg = vlm_config()
    acfg = vcfg.attn_cfg(False)
    heads = (acfg.hq_pad, acfg.n_kv_heads, acfg.d_head)
    for n in VLM_PROMPTS:
        s = vcfg.prefix_len + n
        q = normal(1, heads[0], s, heads[2])
        kv = normal(2, VLM_MAX_SEQ, heads[1], heads[2])
        for dt in ("bfloat16", "float32"):
            tdt = getattr(torch, dt)
            cases.append(dict(
                case=f"paligemma_S{s}_cache" + ("_float32" if dt == "float32"
                                                 else ""),
                q=q.to(tdt), k=kv[0:1].to(tdt).transpose(1, 2),
                v=kv[1:2].to(tdt).transpose(1, 2), causal=True, window=None,
                kv_len=s, dtype=dt, path=dt == "bfloat16", heads=heads,
                model="paligemma_3b"))
    # padded keys inside the queries' span at D 256: kv_len < Sq = Sk
    s = vcfg.prefix_len + VLM_PROMPTS[len(VLM_PROMPTS) // 2]
    kv = normal(2, 1, heads[1], s, heads[2]).bfloat16()
    cases.append(dict(case=f"paligemma_S{s}_kvlen{7 * s // 10}",
                      q=normal(1, heads[0], s, heads[2]).bfloat16(), k=kv[0],
                      v=kv[1], causal=True, window=None, kv_len=7 * s // 10,
                      dtype="bfloat16", path=False))
    return cases


def flash_route(dtype: str) -> str:
    """The route the wrapper takes for an input type: 16-bit inputs the
    tensor cores, fp32 the SIMT kernel."""
    return "simt" if dtype == "float32" else "tensor_core"


def flash_row(c: dict, y) -> dict:
    """One flash case's check of the kernel's output ``y``: against the
    plain version at ``flash_tolerance`` and, for 16-bit inputs, against
    the plain version in fp32 at the rounding limit (``FLASH_HALF_ULP``)."""
    import torch

    from repro_torch.kernels import flash_attention as tfa

    kw = dict(causal=c["causal"], window=c["window"], kv_len=c["kv_len"])
    want = tfa.flash_attention_plain(c["q"], c["k"], c["v"], **kw).float()
    tol = flash_tolerance(c["dtype"])
    d = (y.float() - want).abs()
    lim = tol["atol"] + tol["rtol"] * want.abs()
    row = {"case": c["case"], "q": list(c["q"].shape),
           "k": list(c["k"].shape), "kv_len": c["kv_len"],
           "max_abs_diff": float(d.max()),
           "worst_over_limit": float((d / lim).max()),
           "finite": bool(torch.isfinite(y).all())}
    ok = row["worst_over_limit"] <= 1.0 and row["finite"]
    if c["dtype"] in FLASH_HALF_ULP:
        want32 = tfa.flash_attention_plain(
            c["q"].float(), c["k"].float(), c["v"].float(), **kw)
        d32 = (y.float() - want32).abs()
        mag = want32.abs()
        half = FLASH_HALF_ULP[c["dtype"]] * mag
        row_max = mag.amax(-1, keepdim=True)
        lim32 = half + FLASH_SUM_SLACK * row_max
        over = torch.where(d32 == 0, torch.zeros_like(d32), d32 / lim32)
        row["max_abs_diff_fp32"] = float(d32.max())
        row["max_abs_plain"] = float(mag.max())
        # the rounding alone may reach the first term (half an ulp); what
        # lies beyond it is the fp32 sums' difference, allowed
        # FLASH_SUM_SLACK of the row's largest |value|
        row["fp32_excess_over_row_max"] = float(
            ((d32 - half).clamp(min=0) / row_max.clamp(min=1e-30)).max())
        row["worst_over_rounding_limit"] = float(over.max())
        ok = ok and row["worst_over_rounding_limit"] <= 1.0
    row["ok"] = ok
    return row


def flash_term_limit(c: dict, y) -> dict:
    """A 16-bit flash call's output ``y`` against the plain version in fp32
    at half an ulp of each value plus ``FLASH_SUM_SLACK`` of the sum of
    the absolute terms that value sums, ``sum_j p_j |v_j| / l`` (the plain
    version over ``|v|``): the bound the kernel's arithmetic states (fp32
    sums, P split into two 16-bit terms, ``csrc/flash_attention.cu``).
    The rounding limit (:func:`flash_row`) takes its slack from the row's
    largest |value| instead, which a row whose value cancels (|o| far
    below ``sum_j p_j |v_j| / l``, as trained heads give) can exceed
    while it holds this one."""
    import torch

    from repro_torch.kernels import flash_attention as tfa

    kw = dict(causal=c["causal"], window=c["window"], kv_len=c["kv_len"])
    q, k, v = c["q"].float(), c["k"].float(), c["v"].float()
    want = tfa.flash_attention_plain(q, k, v, **kw)
    terms = tfa.flash_attention_plain(q, k, v.abs(), **kw)
    d = (y.float() - want).abs()
    lim = FLASH_HALF_ULP[c["dtype"]] * want.abs() + FLASH_SUM_SLACK * terms
    over = torch.where(d == 0, torch.zeros_like(d), d / lim)
    return {"worst_over_term_limit": float(over.max()),
            "min_row_max_over_terms": float(
                (want.abs().amax(-1) / terms.amax(-1).clamp(min=1e-30))
                .min())}


def flash_rows(dev, max_seq: int) -> tuple[list[dict], list[dict]]:
    """(rows, cases): the flash kernel against its plain version at every
    case of :func:`flash_cases`, one :func:`flash_row` each."""
    import torch

    from repro_torch.kernels import flash_attention as tfa

    cases = flash_cases(dev, max_seq)
    rows = []
    for c in cases:
        tc0 = tfa.flash_attention_cuda.launches_tensor_core
        y = tfa.flash_attention_cuda(c["q"], c["k"], c["v"],
                                     causal=c["causal"], window=c["window"],
                                     kv_len=c["kv_len"])
        torch.cuda.synchronize()
        route = ("tensor_core" if tfa.flash_attention_cuda.launches_tensor_core
                 > tc0 else "simt")
        rows.append({**flash_row(c, y), "route": route})
    return rows, cases


def flash_phase(dev, max_seq: int) -> dict:
    """The flash kernel against its plain version (the oracle on folded
    heads) at every case of :func:`flash_cases`: at ``flash_tolerance``,
    and the 16-bit cases at the rounding limit too."""
    rows, cases = flash_rows(dev, max_seq)
    worst = max(r["max_abs_diff"] for r, c in zip(rows, cases) if c["path"])
    emit("flash", limit="|d| <= atol + rtol*|plain|, tests/test_kernels.py's "
                        "_tolerance (fp32 2e-5; bf16 and fp16 8e-2, 4e-2)",
         rounding_limit=f"16-bit inputs: |y - plain in fp32| <= half an ulp "
                        f"(bf16 2^-8, fp16 2^-11) x |plain in fp32| + "
                        f"{FLASH_SUM_SLACK} x the row's max |plain in fp32|",
         cases=rows)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"flash_attention_cuda disagrees with its plain version "
                   f"on {bad}")
    wrong = [r["case"] for r, c in zip(rows, cases)
             if r["route"] != flash_route(c["dtype"])]
    check(not wrong, f"flash cases {wrong} took the wrong route")
    return {"max_abs_err": worst, "cases": [c for c in cases if c["path"]]}


def build_lm(seed: int, dev):
    """(cfg, params, statics): full-width, full-depth h2o-danube-1.8B with
    the pattern-sparse MLPs, bf16 weights drawn on the card from the
    seed."""
    import torch

    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models.transformer import init_params

    cfg = h2o_danube_1_8b.config(sparse=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, statics = init_params(cfg, gen, device=dev)
    return cfg, params, statics


def gen_prompts(vocab: int, seed: int) -> list[np.ndarray]:
    """``GEN_REQUESTS`` seeded prompts of ``GEN_LENGTHS`` tokens (none a
    multiple of 128) and the ``GEN_LONG`` one at ``GEN_LONG_AT``."""
    rng = np.random.default_rng(seed)
    lo, hi = GEN_LENGTHS
    lengths = [int(n) + (n % 128 == 0) for n in
               rng.integers(lo, hi + 1, GEN_REQUESTS)]
    lengths.insert(GEN_LONG_AT, GEN_LONG)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def prefill_logits(params, statics, prompt, max_seq, cache_dtype, kernel,
                   dev, prefix=None):
    """float32 [L, vocab] logits of one prompt's prefill on a fresh cache,
    as the service prefills it, by the kernel route or the plain one
    (``apply_model``'s ``prefill`` flag: false keeps every layer on the
    attention's full or chunked route, and nothing else changes).  With
    ``prefix`` ([1, P, d] patch embeddings) in front: L = P + the
    prompt's length, as ``make_prefill_step`` prefills it."""
    import torch

    from repro_torch.models.transformer import apply_model, init_cache

    extra = {} if prefix is None else {"prefix_embeds": prefix}
    n = len(prompt) + (0 if prefix is None else prefix.shape[1])
    row = init_cache(statics, 1, max_seq, dtype=cache_dtype, device=dev)
    toks = torch.as_tensor(prompt[None].astype(np.int64), device=dev)
    with torch.no_grad():
        logits, _, _ = apply_model(
            params, statics, toks, positions=torch.arange(n, device=dev),
            cache=row, cache_pos=0, cache_len=n, prefill=kernel, **extra)
    return logits[0, :, : statics["cfg"].vocab].float()


def rel_diff(a, b) -> float:
    """max|a - b| relative to max(1, max|b|)."""
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def generate_phase(seed: int, dev) -> dict:
    """Token generation at full width and depth through ``DecodeService``:
    seeded prompts in bursts (slots refill mid-decode), every prefill
    through the flash kernel, then the checks and the report."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime.serve import DecodeService, ServeConfig
    from repro_torch.serve.api import Request

    t0 = time.perf_counter()
    cfg, params, statics = build_lm(seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(**GEN_SCFG)
    prompts = gen_prompts(cfg.vocab, seed + 6)
    tracer = Tracer()
    svc = DecodeService(cfg, statics, params, scfg, tracer=tracer, device=dev)
    svc.submit(Request(prompt=np.ones(4, np.int32), max_new_tokens=2))
    svc.run()  # warm-up through the real admit/decode path
    svc.reset_metrics()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the generate path: counts from 0, the bursts through the service, read
    tfa.flash_attention_cuda.launches = 0
    tfa.flash_attention_cuda.launches_tensor_core = 0
    tfa.flash_attention_cuda.launches_simt = 0
    reqs = [Request(prompt=p, max_new_tokens=GEN_NEW) for p in prompts]
    run_s = serve_bursts(svc, reqs, GEN_BURSTS)
    launches = tfa.flash_attention_cuda.launches
    routes = {"tensor_core": tfa.flash_attention_cuda.launches_tensor_core,
              "simt": tfa.flash_attention_cuda.launches_simt}
    peak = torch.cuda.max_memory_allocated()
    m = svc.metrics
    spans = tracer.spans()
    prefill_ms = {}
    for sp in spans:
        if sp.name == "serve.prefill":
            prefill_ms.setdefault(int(sp.args["len"]), []).append(
                sp.dur * 1e3)
    decode = [sp for sp in spans if sp.name == "serve.decode"]
    mid = sum(1 for e in tracer.events()
              if e.get("args", {}).get("event") == "admit_mid_decode")
    out_tokens = sum(len(r.output) for r in reqs)

    # co-batched against alone: two requests again, each alone
    alone = {}
    for i in (0, GEN_LONG_AT):
        r = Request(prompt=prompts[i], max_new_tokens=GEN_NEW)
        svc.submit(r)
        svc.run()
        alone[i] = r.output == reqs[i].output

    # prefill logits, kernel route against plain route, on the card
    bf16 = getattr(torch, scfg.cache_dtype)
    _, params32, statics32 = to_dtype(cfg, params, statics, "float32")
    order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
    compare = [order[0], order[len(order) // 2], GEN_LONG_AT]
    parity, first_agree = [], 0
    for i, p in enumerate(prompts):
        plain = prefill_logits(params, statics, p, scfg.max_seq, bf16, False,
                               dev)
        first_agree += int(int(plain[-1].argmax()) == reqs[i].output[0])
        if i not in compare:
            continue
        kern = prefill_logits(params, statics, p, scfg.max_seq, bf16, True,
                              dev)
        ref32 = prefill_logits(params32, statics32, p, scfg.max_seq,
                               torch.float32, False, dev)
        kern32 = prefill_logits(params32, statics32, p, scfg.max_seq,
                                torch.float32, True, dev)
        noise = rel_diff(plain, ref32)
        row = {"prompt_len": len(p),
               "bf16_kernel_vs_plain": rel_diff(kern, plain),
               "bf16_plain_vs_fp32": noise,
               "bf16_kernel_vs_fp32": rel_diff(kern, ref32),
               "bf16_limit": GEN_BF16_NOISE_FACTOR * noise,
               "fp32_kernel_vs_plain": rel_diff(kern32, ref32),
               "last_token_argmax_equal": bool(
                   int(kern[-1].argmax()) == int(plain[-1].argmax())),
               "max_abs_logit": float(plain.abs().max())}
        row["ok"] = (row["bf16_kernel_vs_plain"] <= row["bf16_limit"]
                     and row["fp32_kernel_vs_plain"] <= GEN_FP32_REL)
        parity.append(row)
    del params32
    torch.cuda.empty_cache()

    prefills = len(reqs)
    dec_s = sum(sp.dur for sp in decode)
    dec_tokens = sum(int(sp.args["live"]) for sp in decode)
    res = dict(
        model=cfg.name, sparse=dataclasses.asdict(cfg.sparse),
        layers=cfg.n_layers, d_model=cfg.d_model, heads=[cfg.n_heads,
                                                          cfg.n_kv_heads],
        d_head=cfg.d_head, window=cfg.window, d_ff=cfg.d_ff, vocab=cfg.vocab,
        param_dtype=cfg.param_dtype, init_seconds=init_s,
        serve_config=GEN_SCFG, requests=len(reqs), new_tokens=GEN_NEW,
        bursts=list(GEN_BURSTS),
        prompt_lengths=[len(p) for p in prompts],
        all_done=all(r.done and len(r.output) == GEN_NEW for r in reqs),
        trace_count=svc.trace_count(),
        prefill_trace_count=svc.prefill_trace_count(),
        admitted_mid_decode=mid, prefills=prefills, launches=launches,
        launches_by_route=routes,
        launches_expected=cfg.n_layers * prefills,
        alone_vs_cobatched_equal=alone,
        logits_limit=(f"relative to max|plain logit|: bf16 kernel vs plain "
                      f"<= {GEN_BF16_NOISE_FACTOR} x (bf16 plain vs fp32 "
                      f"plain); fp32 kernel vs plain <= {GEN_FP32_REL}"),
        prefill_logits=parity,
        first_token_agreement_vs_plain=first_agree / len(prompts),
        prefill_ms_by_len={str(k): v for k, v in sorted(prefill_ms.items())},
        run_seconds=run_s, output_tokens=out_tokens,
        tokens_per_s=out_tokens / run_s,
        decode_steps=len(decode), decode_tokens=dec_tokens,
        decode_tokens_per_s=dec_tokens / dec_s if dec_s else None,
        ttft_p50_s=m["first_result_p50_s"], ttft_p99_s=m["first_result_p99_s"],
        latency_p50_s=m["latency_p50_s"], latency_p99_s=m["latency_p99_s"],
        occupancy_mean=m["occupancy_mean"], peak_memory_bytes=peak,
    )
    emit("generate", **res)
    check(res["all_done"], "a generation request did not complete")
    check(res["trace_count"] == 1,
          f"decode trace_count {res['trace_count']} != 1")
    check(mid > 0, "no slot was refilled mid-decode")
    check(launches == res["launches_expected"],
          f"flash_attention_cuda launches {launches} != {cfg.n_layers} "
          f"layers x {prefills} prefills")
    check(routes["tensor_core"] == launches and routes["simt"] == 0,
          f"flash launches by route {routes}: every prefill launch must go "
          f"through the tensor-core route")
    check(all(alone.values()), f"co-batched tokens differ from alone: {alone}")
    bad = [r["prompt_len"] for r in parity if not r["ok"]]
    check(not bad, f"prefill logits of the kernel route off the plain route "
                   f"for prompts of {bad} tokens")
    return {"launches": launches}


def lm_config(arch: str):
    """The ``lm_configs`` phase's config of ``arch``: its published config
    at full width (the two dense models with their pattern-sparse MLPs),
    the first ``LM_LAYERS[arch]`` layers."""
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").config(
        sparse=arch in ("qwen2_5_32b", "phi3_medium_14b"))
    n = LM_LAYERS[arch]
    return dataclasses.replace(cfg, n_layers=n,
                               layer_types=cfg.layer_types[:n])


def draw_model(cfg, seed: int, dev, dtype: str):
    """(cfg, params, statics) of ``cfg`` with ``dtype`` weights drawn on
    ``dev`` from the seed (drawn in float32 and cast, one tensor at a
    time, so the bf16 weights are the float32 ones rounded)."""
    import torch

    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, statics = init_params(cfg, gen, device=dev)
    return cfg, params, statics


def build_lm_config(arch: str, seed: int, dev, dtype: str):
    """:func:`draw_model` of :func:`lm_config`."""
    return draw_model(lm_config(arch), seed, dev, dtype)


def param_bytes(params) -> int:
    from repro_torch.models.transformer import _leaves

    return sum(t.numel() * t.element_size() for t in _leaves(params))


def to_dtype(cfg, params, statics, dtype: str):
    """The same model with every weight cast to ``dtype``."""
    import torch

    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    tdt = getattr(torch, dtype)
    return cfg, _map_tensors(params, lambda t: t.to(tdt)), {
        **statics, "cfg": cfg}


class RecordedRoutes:
    """Inside ``with``: every MoE layer's ``(tokens, top_e)`` as
    ``models.moe._route`` chose them, in call order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._real = [], moe._route

        def record(params, cfg, xf):
            w, e = self._real(params, cfg, xf)
            self.calls.append((xf.shape[0], e))
            return w, e

        moe._route = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self._real


def recount_kept(top_e: np.ndarray, cap: int, n_experts: int) -> np.ndarray:
    """The capacity rule on the host, by its definition: the (token, k)
    pairs in token-major order, each expert keeping its first ``cap``."""
    seen = np.zeros(n_experts, int)
    keep = np.zeros(top_e.size, bool)
    for i, e in enumerate(top_e.reshape(-1)):
        keep[i] = seen[e] < cap
        seen[e] += 1
    return keep.reshape(top_e.shape)


def moe_loop(params, static, cfg, x, top_w, top_e, keep):
    """The MoE layer by its definition, one expert at a time:
    ``sum_k w_k FFN_e(x) + shared(x)`` over the kept (token, k) pairs, no
    capacity gather, sort or scatter.  x: [T, D]."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import mlp_apply

    t, k = top_e.shape
    contrib = torch.zeros((t, k, x.shape[1]), dtype=x.dtype, device=x.device)
    for e in torch.unique(top_e[keep]).tolist():
        rows, ks = torch.nonzero((top_e == e) & keep, as_tuple=True)
        w = {n: params["experts"][n][e].to(x.dtype)
             for n in ("gate", "up", "down")}
        xe = x[rows]
        y = (F.silu(xe @ w["gate"]) * (xe @ w["up"])) @ w["down"]
        contrib[rows, ks] = top_w[rows, ks, None] * y
    out = contrib.sum(1)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], static["shared"], x)
    return out


def moe_layer_gate(params, statics, tokens, name: str) -> dict:
    """(b) on the first MoE layer of a float32 DeepSeek-V2: its input
    stand-in is the RMS-normed embedding of ``tokens`` [T].  The card's
    top-k ids = a stable host sort of its probabilities; with the
    capacity factor raised so nothing drops, ``moe_apply`` = the loop over
    every pair; at the published factor, the kept pairs = the host
    recount and ``moe_apply`` = the loop over the kept pairs."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.layers import linear, rmsnorm
    from repro_torch.models.transformer import _index

    cfg = statics["cfg"]
    layer = _index(params["body"][0], 0)
    p, st = layer["moe"], statics["body"][0]["moe"]
    x = rmsnorm(layer["norm2"], params["embed"]["w"][tokens])
    top_w, top_e = moe._route(p, cfg.moe, x)
    probs = torch.softmax(linear(p["router"], x).float(), -1)
    host = np.argsort(-probs.cpu().numpy(), axis=-1, kind="stable")[
        :, :cfg.moe.top_k]
    row = {"case": name, "tokens": int(x.shape[0]),
           "top_k_equal_host_stable_sort": bool(np.array_equal(
               top_e.cpu().numpy(), host))}
    no_drop = dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    every = torch.ones_like(top_e, dtype=torch.bool)
    for key, mcfg in (("no_drop", no_drop), ("published", cfg.moe)):
        cap = moe.capacity(x.shape[0], mcfg)
        keep = moe.kept_pairs(top_e, mcfg)
        want_keep = recount_kept(top_e.cpu().numpy(), cap,
                                 mcfg.n_experts)
        got = moe.moe_apply(p, st, mcfg, x[None])[0]
        want = moe_loop(p, st, mcfg, x, top_w, top_e,
                        every if key == "no_drop" else keep)
        row[key] = {"capacity_factor": mcfg.capacity_factor,
                    "capacity": cap,
                    "kept_equal_host_recount": bool(np.array_equal(
                        keep.cpu().numpy(), want_keep)),
                    "dropped_pairs": int((~keep).sum()),
                    "rel_vs_loop": rel_diff(got, want)}
    row["ok"] = (row["top_k_equal_host_stable_sort"]
                 and row["no_drop"]["dropped_pairs"] == 0
                 and all(row[k]["kept_equal_host_recount"]
                         and row[k]["rel_vs_loop"] <= MOE_REL
                         for k in ("no_drop", "published")))
    return row


def mla_decode_gate(params, statics, prompt, dev) -> dict:
    """(a) on a float32 DeepSeek-V2: prefill ``prompt`` into a cache, then
    layer 0's MLA at the next step, absorbed and expanded, each on its own
    copy of that cache."""
    import torch

    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.mla import mla_apply
    from repro_torch.models.transformer import apply_model, init_cache

    cfg = statics["cfg"]
    n = len(prompt)
    cache = init_cache(statics, 1, LM_SCFG["max_seq"], dtype=torch.float32,
                       device=dev)
    toks = torch.as_tensor(prompt[None].astype(np.int64), device=dev)
    logits, _, _ = apply_model(params, statics, toks,
                               positions=torch.arange(n, device=dev),
                               cache=cache, cache_pos=0, cache_len=n)
    tok = logits[:, -1, :cfg.vocab].argmax(-1)
    layer = params["prefix_layers"][0]
    h = rmsnorm(layer["norm1"], params["embed"]["w"][tok][:, None])
    pos = torch.tensor(n, device=dev)
    out = {}
    for absorbed in (True, False):
        c = {k: v.clone() for k, v in cache["prefix_layers"][0].items()}
        out[absorbed], _ = mla_apply(layer["attn"], cfg.mla, h, pos[None],
                                     cache=c, cache_pos=pos,
                                     cache_len=pos + 1, absorbed=absorbed)
    rel = rel_diff(out[True], out[False])
    return {"prompt_len": n, "step": n, "rel": rel, "limit": MLA_REL,
            "ok": rel <= MLA_REL}


def routes_of(calls) -> list:
    return [e.cpu().numpy() for _, e in calls]


def flip_share(a: list, b: list) -> float:
    """Share of (layer, token) rows whose top-k expert sets differ."""
    rows = flips = 0
    for x, y in zip(a, b):
        rows += x.shape[0]
        flips += int((np.sort(x, -1) != np.sort(y, -1)).any(-1).sum())
    return flips / max(rows, 1)


def deepseek_v2_run(seed: int, dev) -> dict:
    """(a), (b) and (c) on DeepSeek-V2: float32 first (the gates and each
    prompt's first-token logits, prefilled alone as the service prefills
    it); then, the float32 copy freed, the same weights drawn again in
    bf16 (the float32 draws rounded) and served through
    ``DecodeService``."""
    import torch

    from repro_torch.models import moe
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime.serve import DecodeService, ServeConfig
    from repro_torch.serve.api import Request

    t0 = time.perf_counter()
    cfg, params, statics = build_lm_config("deepseek_v2_236b", seed, dev,
                                           "float32")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 8)
    lengths = rng.integers(LM_LENGTHS[0], LM_LENGTHS[1] + 1, LM_REQUESTS)
    lengths[0] = LM_LENGTHS[1]
    prompts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32)
               for n in lengths]
    weight_bytes = {"float32": param_bytes(params)}
    res = {"model": cfg.name, "layers": cfg.n_layers,
           "layer_types": [list(t) for t in cfg.layer_types],
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "mla": dataclasses.asdict(cfg.mla),
           "moe": dataclasses.asdict(cfg.moe), "d_ff": cfg.d_ff,
           "init_seconds": init_s}
    with torch.no_grad():
        res["mla_absorbed_vs_expanded"] = mla_decode_gate(
            params, statics, prompts[1], dev)
        pre = torch.as_tensor(prompts[0].astype(np.int64), device=dev)
        dec = torch.as_tensor(np.array([p[-1] for p in prompts[:4]],
                                       np.int64), device=dev)
        res["moe_layer"] = [moe_layer_gate(params, statics, pre, "prefill"),
                            moe_layer_gate(params, statics, dec, "decode")]
        first32, routes32 = [], []
        for p in prompts:
            with RecordedRoutes() as rec:
                lg = prefill_logits(params, statics, p, LM_SCFG["max_seq"],
                                    torch.float32, True, dev)
            first32.append(lg[-1].clone())
            routes32.append(routes_of(rec.calls))
        router32 = params["body"][0]["moe"]["router"]["w"].clone()
        peak = {"float32": torch.cuda.max_memory_allocated()}
        del params, lg
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, statics = build_lm_config("deepseek_v2_236b", seed, dev,
                                               "bfloat16")
        weight_bytes["bfloat16"] = param_bytes(params)
        res["bf16_weights_are_fp32_rounded"] = bool(torch.equal(
            params["body"][0]["moe"]["router"]["w"], router32.bfloat16()))
        del router32
        first16, routes16 = [], []
        for p in prompts:
            with RecordedRoutes() as rec:
                lg = prefill_logits(params, statics, p, LM_SCFG["max_seq"],
                                    torch.bfloat16, True, dev)
            first16.append(lg[-1].clone())
            routes16.append(routes_of(rec.calls))
        del lg
    res["weight_bytes"] = weight_bytes
    res["first_token_vs_fp32"] = [
        {"prompt_len": len(p), "rel": rel_diff(a, b),
         "argmax_equal": bool(int(a.argmax()) == int(b.argmax())),
         "route_flip_share": flip_share(r16, r32),
         "finite": bool(torch.isfinite(a).all())}
        for p, a, b, r16, r32 in zip(prompts, first16, first32, routes16,
                                     routes32)]
    del first32

    scfg = ServeConfig(**LM_SCFG)
    tracer = Tracer()
    svc = DecodeService(cfg, statics, params, scfg, tracer=tracer,
                        device=dev)
    svc.submit(Request(prompt=np.ones(4, np.int32), max_new_tokens=2))
    svc.run()  # warm-up through the real admit/decode path
    svc.reset_metrics()
    tracer.reset()
    reqs = [Request(prompt=p, max_new_tokens=LM_NEW) for p in prompts]
    with RecordedRoutes() as rec:
        run_s = serve_bursts(svc, reqs, LM_BURSTS)
    slots = LM_SCFG["batch_slots"]
    drops = {"prefill": [0, 0], "decode": [0, 0]}
    # the busiest expert's pairs over the mean load, per MoE call: the
    # capacity is 1.25 x the mean, so a call above 1.25 drops pairs
    busiest = {"prefill": [], "decode": []}
    for t, e in rec.calls:
        keep = moe.kept_pairs(e, cfg.moe)
        kind = "decode" if t == slots else "prefill"
        drops[kind][0] += int((~keep).sum())
        drops[kind][1] += keep.numel()
        load = np.bincount(e.cpu().numpy().ravel(),
                           minlength=cfg.moe.n_experts)
        busiest[kind].append(float(load.max() / load.mean()))
    mid = sum(1 for ev in tracer.events()
              if ev.get("args", {}).get("event") == "admit_mid_decode")
    m = svc.metrics
    res.update(
        serve_config=LM_SCFG, requests=len(reqs), new_tokens=LM_NEW,
        bursts=list(LM_BURSTS), prompt_lengths=[len(p) for p in prompts],
        all_done=all(r.done and len(r.output) == LM_NEW for r in reqs),
        trace_count=svc.trace_count(), admitted_mid_decode=mid,
        first_token_is_bf16_prefill_argmax=[
            int(r.output[0]) == int(f.argmax())
            for r, f in zip(reqs, first16)],
        drop_share={k: d / max(n, 1) for k, (d, n) in drops.items()},
        dropped_pairs={k: v[0] for k, v in drops.items()},
        busiest_expert_over_mean_load={
            k: {"median": float(np.median(v)), "max": float(np.max(v))}
            for k, v in busiest.items() if v},
        routed_pairs={k: v[1] for k, v in drops.items()},
        run_seconds=run_s,
        tokens_per_s=sum(len(r.output) for r in reqs) / run_s,
        ttft_p50_s=m["first_result_p50_s"], latency_p50_s=m["latency_p50_s"],
        latency_p99_s=m["latency_p99_s"],
        peak_memory_bytes={**peak,
                           "bfloat16": torch.cuda.max_memory_allocated()})
    return res


def deepseek_v3_mtp_run(seed: int, dev) -> dict:
    """(d): DeepSeek-V3's MTP head, float32 then the same weights in bf16,
    on seeded tokens without a cache."""
    import torch

    from repro_torch.models.transformer import apply_model

    cfg, params, statics = build_lm_config("deepseek_v3_671b", seed, dev,
                                           "float32")
    toks = torch.as_tensor(np.random.default_rng(seed + 9).integers(
        1, cfg.vocab, LM_MTP_SHAPE), device=dev)
    out = {}
    nbytes = {}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            if dtype == "bfloat16":
                cfg, params, statics = to_dtype(cfg, params, statics, dtype)
                torch.cuda.empty_cache()
            nbytes[dtype] = param_bytes(params)
            logits, _, aux = apply_model(params, statics, toks)
            out[dtype] = (logits[..., :cfg.vocab].float(),
                          aux["mtp_logits"][..., :cfg.vocab].float(),
                          tuple(aux["mtp_logits"].shape))
    del params
    noise = rel_diff(out["bfloat16"][0], out["float32"][0])
    far = rel_diff(out["bfloat16"][1], out["float32"][1])
    row = {"model": cfg.name, "layers": cfg.n_layers,
           "layer_types": [list(t) for t in cfg.layer_types],
           "mtp_layer": list(cfg.layer_types[-1]), "d_model": cfg.d_model,
           "vocab": cfg.vocab, "tokens": list(LM_MTP_SHAPE),
           "weight_bytes": nbytes,
           "mtp_logits_shape": list(out["bfloat16"][2]),
           "mtp_logits_finite": bool(all(
               torch.isfinite(o[1]).all() for o in out.values())),
           "bf16_mtp_vs_fp32": far, "bf16_logits_vs_fp32": noise,
           "bf16_limit": GEN_BF16_NOISE_FACTOR * noise,
           "mtp_vs_logits_fp32": rel_diff(out["float32"][1],
                                          out["float32"][0])}
    row["ok"] = (row["mtp_logits_shape"] == [*LM_MTP_SHAPE, cfg.padded_vocab]
                 and row["mtp_logits_finite"] and far <= row["bf16_limit"])
    return row


def dense_lm_run(arch: str, seed: int, dev) -> dict:
    """(e): bf16 weights from the seed, each of ``LM_DENSE_PROMPTS``
    prefilled by the kernel route (the main path: counts from 0, the
    prefills, read), then the generate phase's rule against the same
    weights in float32; the flash calls' head widths as launched."""
    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ops

    cfg, params, statics = build_lm_config(arch, seed, dev, "bfloat16")
    acfg = cfg.attn_cfg(False)
    rng = np.random.default_rng(seed + 10)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in LM_DENSE_PROMPTS]
    widths = []
    real = ops.flash_attention

    def shapes(q, *args, **kwargs):
        widths.append(int(q.shape[-1]))
        return real(q, *args, **kwargs)

    ops.flash_attention = shapes
    try:
        for key in ("launches", "launches_tensor_core", "launches_simt"):
            setattr(tfa.flash_attention_cuda, key, 0)
        kern = [prefill_logits(params, statics, p, LM_DENSE_MAX_SEQ,
                               torch.bfloat16, True, dev) for p in prompts]
        launches = tfa.flash_attention_cuda.launches
        routes = {"tensor_core": tfa.flash_attention_cuda.launches_tensor_core,
                  "simt": tfa.flash_attention_cuda.launches_simt}
    finally:
        ops.flash_attention = real
    _, params32, statics32 = to_dtype(cfg, params, statics, "float32")
    rows = []
    for p, k16 in zip(prompts, kern):
        plain = prefill_logits(params, statics, p, LM_DENSE_MAX_SEQ,
                               torch.bfloat16, False, dev)
        ref32 = prefill_logits(params32, statics32, p, LM_DENSE_MAX_SEQ,
                               torch.float32, False, dev)
        kern32 = prefill_logits(params32, statics32, p, LM_DENSE_MAX_SEQ,
                                torch.float32, True, dev)
        noise = rel_diff(plain, ref32)
        row = {"prompt_len": len(p),
               "bf16_kernel_vs_plain": rel_diff(k16, plain),
               "bf16_plain_vs_fp32": noise,
               "bf16_kernel_vs_fp32": rel_diff(k16, ref32),
               "bf16_limit": GEN_BF16_NOISE_FACTOR * noise,
               "fp32_kernel_vs_plain": rel_diff(kern32, ref32),
               "finite": bool(torch.isfinite(k16).all())}
        row["ok"] = (row["bf16_kernel_vs_plain"] <= row["bf16_limit"]
                     and row["fp32_kernel_vs_plain"] <= GEN_FP32_REL
                     and row["finite"])
        rows.append(row)
    nbytes = {"bfloat16": param_bytes(params),
              "float32": param_bytes(params32)}
    del params, params32
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
            "q_heads_padded": acfg.hq_pad, "grouped": acfg.grouped,
            "d_head": cfg.d_head, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "qkv_bias": cfg.qkv_bias,
            "sparse": cfg.sparse and dataclasses.asdict(cfg.sparse),
            "weight_bytes": nbytes, "prefills": len(prompts),
            "launches": launches, "launches_by_route": routes,
            "launch_head_dims": sorted(set(widths)),
            "launches_expected": (cfg.n_layers * len(prompts)
                                  if acfg.grouped else 0),
            "prefill_logits": rows}


def lm_configs_phase(seed: int, dev) -> dict:
    """The four architectures MoE, MLA and the MTP head unlock, at full
    width: DeepSeek-V2 (a: MLA absorbed vs expanded; b: one MoE layer
    against its definition; c: served in bf16), DeepSeek-V3 (d: the MTP
    head), qwen2.5-32b and phi3-medium-14b (e: prefill logits, qwen's
    through the flash kernel at D 128, phi3's on the kv-repeat route);
    checks and the report."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ds2 = deepseek_v2_run(seed, dev)
    torch.cuda.empty_cache()
    ds3 = deepseek_v3_mtp_run(seed, dev)
    torch.cuda.empty_cache()
    dense = {arch: dense_lm_run(arch, seed, dev)
             for arch in ("qwen2_5_32b", "phi3_medium_14b")}
    seconds = time.perf_counter() - t0
    published = {a: importlib.import_module(f"repro_torch.configs.{a}")
                 .config().n_layers for a in LM_LAYERS}
    emit("lm_configs", seconds=seconds,
         depth={a: f"{n} of {published[a]} layers"
                for a, n in LM_LAYERS.items()},
         mla_limit=f"absorbed vs expanded <= {MLA_REL} x max(1, max|out|)",
         moe_limit=(f"moe_apply vs the per-expert loop <= {MOE_REL} x "
                    f"max(1, max|out|); kept pairs = host recount"),
         mtp_limit=(f"bf16 mtp_logits vs fp32 <= {GEN_BF16_NOISE_FACTOR} x "
                    f"(bf16 logits vs fp32)"),
         deepseek_v2=ds2, deepseek_v3=ds3, **dense,
         # deepseek_v2_run resets the counter between its two stages
         peak_memory_bytes=max(torch.cuda.max_memory_allocated(),
                               *ds2["peak_memory_bytes"].values()))
    check(ds2["mla_absorbed_vs_expanded"]["ok"],
          f"MLA absorbed decode off the expanded one: "
          f"{ds2['mla_absorbed_vs_expanded']}")
    bad = [r["case"] for r in ds2["moe_layer"] if not r["ok"]]
    check(not bad, f"MoE layer off its definition or the host recount: {bad}")
    check(ds2["bf16_weights_are_fp32_rounded"],
          "DeepSeek-V2's bf16 weights are not its float32 weights rounded")
    check(ds2["all_done"], "a DeepSeek-V2 request did not complete")
    check(ds2["trace_count"] == 1,
          f"DeepSeek-V2 decode trace_count {ds2['trace_count']} != 1")
    check(ds2["admitted_mid_decode"] > 0,
          "no DeepSeek-V2 slot was refilled mid-decode")
    check(all(r["finite"] for r in ds2["first_token_vs_fp32"]),
          "DeepSeek-V2 first-token logits not finite")
    # the service prefills each prompt alone too, so its first token is
    # that prefill's argmax: a wrong latent-cache write or slot scatter
    # on the served path breaks it
    check(all(ds2["first_token_is_bf16_prefill_argmax"]),
          f"DeepSeek-V2 served first tokens off the bf16 prefill's argmax: "
          f"{ds2['first_token_is_bf16_prefill_argmax']}")
    check(ds3["ok"], f"DeepSeek-V3 MTP head: {ds3}")
    qwen, phi3 = dense["qwen2_5_32b"], dense["phi3_medium_14b"]
    for name, r in dense.items():
        bad = [x["prompt_len"] for x in r["prefill_logits"] if not x["ok"]]
        check(not bad, f"{name}: prefill logits off the rule for prompts of "
                       f"{bad} tokens")
        check(r["launches"] == r["launches_expected"],
              f"{name}: flash launches {r['launches']} != "
              f"{r['launches_expected']}")
    check(qwen["grouped"] and qwen["launches_by_route"]["simt"] == 0
          and qwen["launches_by_route"]["tensor_core"] == qwen["launches"]
          and qwen["launch_head_dims"] == [qwen["d_head"]],
          f"qwen flash launches by route {qwen['launches_by_route']}, head "
          f"dims {qwen['launch_head_dims']}")
    check(not phi3["grouped"] and phi3["launches"] == 0,
          "phi3 must take the kv-repeat route, no flash launch")
    return {"launches": qwen["launches"], "seconds": seconds}


def ssm_config(arch: str):
    """The ``ssm_whisper`` phase's config of ``arch`` at its published
    width: mamba2-780m and whisper-small whole, jamba-1.5-large its first
    ``JAMBA_LAYERS`` layers."""
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").config()
    if arch == "jamba_1_5_large_398b":
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS,
                                  layer_types=cfg.layer_types[:JAMBA_LAYERS])
    return cfg


def ssd_recurrence(params, cfg, x):
    """One Mamba-2 layer on ``x`` [B, S, D] in float32, token by token from
    its formulas, sharing no code with ``models.ssm``: z, xBC, dt = x W_in;
    xBC through the depthwise causal conv (``conv1d``, groups = channels)
    plus bias and SiLU; dt = softplus(dt + dt_bias), a = -exp(A_log);
    per head h with its group's B and C, s_t = exp(dt_t a) s_{t-1} +
    dt_t x_t B_t^T and y_t = s_t C_t + D x_t; out = RMSNorm(y * SiLU(z))
    W_out.  Returns (out, the last d_conv - 1 rows of xBC, s_S)."""
    import torch
    import torch.nn.functional as F

    b, s, _ = x.shape
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.d_state
    h, p, k = cfg.n_heads, cfg.head_dim, cfg.d_conv
    f = {name: t.float() for name, t in params.items()
         if isinstance(t, torch.Tensor)}
    zxbcdt = x.float() @ params["in_proj"]["w"].float()
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cfg.conv_dim]
    dt = zxbcdt[..., di + cfg.conv_dim:] + f["dt_bias"]
    dt = dt.clamp(min=0) + torch.log1p(torch.exp(-dt.abs()))  # softplus
    a = -torch.exp(f["A_log"])
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)),
                    f["conv_w"].T[:, None, :], f["conv_b"],
                    groups=cfg.conv_dim).transpose(1, 2)
    xc = F.silu(conv)
    xs = xc[..., :di].reshape(b, s, h, p)
    group = torch.arange(h, device=x.device) // (h // g)
    bh = xc[..., di:di + g * n].reshape(b, s, g, n)[:, :, group]
    ch = xc[..., di + g * n:].reshape(b, s, g, n)[:, :, group]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state = (torch.exp(dt[:, t] * a)[..., None, None] * state
                 + (dt[:, t, :, None] * xs[:, t])[..., None]
                 * bh[:, t, :, None, :])
        ys.append((state * ch[:, t, :, None, :]).sum(-1))
    y = (torch.stack(ys, 1) + xs * f["D"][None, None, :, None]).reshape(
        b, s, di)
    y = y * F.silu(z)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6) * params[
        "norm"]["scale"].float()
    return y @ params["out_proj"]["w"].float(), xbc[:, -(k - 1):], state


def ssd_rows(arch: str, seed: int, dev) -> list[dict]:
    """(a): one float32 SSM layer of ``arch``'s width from the seed, on
    seeded inputs of each length of ``SSD_S[arch]``: ``ssm_apply`` (the
    chunked scan, written into a cache) against :func:`ssd_recurrence`,
    the output, the final state and the conv window."""
    import torch

    from repro_torch.models.ssm import init_ssm_cache, ssm_apply, ssm_init

    cfg = ssm_config(arch).ssm
    params = ssm_init(torch.Generator(device=dev).manual_seed(seed + 12),
                      cfg, torch.float32, dev)
    rng = np.random.default_rng(seed + 13)
    rows = []
    for s in SSD_S[arch]:
        x = torch.as_tensor(rng.normal(size=(1, s, cfg.d_model)).astype(
            np.float32), device=dev)
        cache = init_ssm_cache(cfg, 1, device=dev)
        with torch.no_grad():
            out, _ = ssm_apply(params, cfg, x, cache)
            want = ssd_recurrence(params, cfg, x)
        row = {"model": arch, "S": s, "chunk": cfg.chunk,
               "pad": (-s) % cfg.chunk, "heads": cfg.n_heads,
               "head_dim": cfg.head_dim, "d_state": cfg.d_state}
        for name, got, ref in zip(("out", "conv", "state"),
                                  (out, cache["conv"], cache["state"]), want):
            d = (got - ref).abs()
            row[name] = {
                "max_abs_diff": float(d.max()),
                "max_abs_ref": float(ref.abs().max()),
                "rel": float(d.max() / ref.abs().max()),
                "worst_over_elementwise": float(
                    (d / (SSD_ATOL + SSD_RTOL * ref.abs())).max())}
        row["ok"] = (row["out"]["rel"] <= SSD_OUT_REL
                     and row["conv"]["worst_over_elementwise"] <= 1.0
                     and row["state"]["worst_over_elementwise"] <= 1.0)
        rows.append(row)
    return rows


def handoff_row(params, statics, prompt, steps: int, dev,
                frames=None, prefix=None) -> dict:
    """(b) and (d), and the vlm phase's (b): prefill ``prompt`` [n] (after
    ``prefix``'s P patch embeddings, when given) into a float32 cache,
    take ``steps`` greedy decode steps through ``decode_logits`` (what
    ``make_decode_step`` samples from) at positions P + n, ..., then one
    cacheless forward over the prefix and the n + steps tokens; the
    logits at position P + n - 1 and at each step, relative to the
    cacheless forward's largest."""
    import torch

    from repro_torch.models.transformer import apply_model, init_cache
    from repro_torch.runtime.serve import decode_logits

    cfg = statics["cfg"]
    extra = {} if frames is None else {"frames": frames}
    p = 0
    if prefix is not None:
        extra, p = {"prefix_embeds": prefix}, prefix.shape[1]
    n = len(prompt)
    toks = torch.zeros((1, n + steps), dtype=torch.long, device=dev)
    toks[0, :n] = torch.as_tensor(prompt.astype(np.int64), device=dev)
    cache = init_cache(statics, 1, p + n + steps, dtype=torch.float32,
                       device=dev)
    logits, _, _ = apply_model(params, statics, toks[:, :n],
                               positions=torch.arange(p + n, device=dev),
                               cache=cache, cache_pos=0, cache_len=p + n,
                               **extra)
    got = [logits[0, -1, :cfg.vocab].float()]
    for i in range(n, n + steps):
        toks[0, i] = got[-1].argmax()
        lg, cache = decode_logits(statics, params, cache, toks[:, i],
                                  torch.tensor(p + i, device=dev))
        got.append(lg[0])
    full, _, _ = apply_model(params, statics, toks, **extra)
    want = full[0, p + n - 1:, :cfg.vocab].float()
    got = torch.stack(got)
    rel = rel_diff(got, want)
    finite = bool(torch.isfinite(got).all())
    return {"prompt_len": n, "steps": steps, "rel": rel,
            "limit": HANDOFF_REL, "finite": finite,
            "max_abs_logit": float(want.abs().max()),
            "greedy_tokens": toks[0, n:].tolist(),
            "ok": rel <= HANDOFF_REL and finite}


def service_split(tracer) -> dict:
    """Host seconds of a service run's prefill and decode spans, and the
    decode steps and tokens they hold."""
    spans = tracer.spans()
    pre = [sp.dur for sp in spans if sp.name == "serve.prefill"]
    dec = [sp for sp in spans if sp.name == "serve.decode"]
    dec_s = sum(sp.dur for sp in dec)
    tokens = sum(int(sp.args["live"]) for sp in dec)
    return {"prefills": len(pre), "prefill_seconds": sum(pre),
            "decode_steps": len(dec), "decode_seconds": dec_s,
            "decode_tokens_per_s": tokens / dec_s if dec_s else None}


def ssm_cache_bytes(cache, slots: int) -> int:
    """Bytes of the SSM leaves (``conv``, ``state``) of a cache, a slot."""
    from repro_torch.models.transformer import _leaves

    layers = [c for c in cache["prefix_layers"] + cache["body"]
              if "state" in c]
    return sum(t.numel() * t.element_size() for t in _leaves(layers)) // slots


def mamba2_run(seed: int, dev) -> dict:
    """(b) and (c) on mamba2-780m at all 48 layers: float32 first (the
    handoff, and each served prompt's last prefill logits), then the same
    weights in bf16 (the float32 ones rounded) served through
    ``DecodeService`` as the generate phase serves h2o-danube."""
    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime.serve import DecodeService, ServeConfig
    from repro_torch.serve.api import Request

    t0 = time.perf_counter()
    cfg, params, statics = draw_model(ssm_config("mamba2_780m"), seed,
                                       dev, "float32")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 14)
    prompts = gen_prompts(cfg.vocab, seed + 6)
    res = {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "ssm": dataclasses.asdict(cfg.ssm),
           "init_seconds": init_s,
           "weight_bytes": {"float32": param_bytes(params)}}
    with torch.no_grad():
        res["handoff"] = [
            handoff_row(params, statics, rng.integers(1, cfg.vocab, n),
                        HANDOFF_STEPS, dev)
            for n in HANDOFF_PROMPTS]
        first32 = [prefill_logits(params, statics, p, GEN_SCFG["max_seq"],
                                  torch.float32, True, dev)[-1].clone()
                   for p in prompts]
    res["peak_memory_bytes"] = {"float32": torch.cuda.max_memory_allocated()}
    cfg, params, statics = to_dtype(cfg, params, statics, "bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["weight_bytes"]["bfloat16"] = param_bytes(params)

    scfg = ServeConfig(**GEN_SCFG)
    tracer = Tracer()
    svc = DecodeService(cfg, statics, params, scfg, tracer=tracer, device=dev)
    svc.submit(Request(prompt=np.ones(4, np.int32), max_new_tokens=2))
    svc.run()  # warm-up through the real admit/decode path
    svc.reset_metrics()
    tracer.reset()
    launches0 = tfa.flash_attention_cuda.launches
    reqs = [Request(prompt=p, max_new_tokens=GEN_NEW) for p in prompts]
    run_s = serve_bursts(svc, reqs, GEN_BURSTS)
    m = svc.metrics
    split = service_split(tracer)
    mid = sum(1 for e in tracer.events()
              if e.get("args", {}).get("event") == "admit_mid_decode")
    alone = {}
    for i in (0, GEN_LONG_AT):
        r = Request(prompt=prompts[i], max_new_tokens=GEN_NEW)
        svc.submit(r)
        svc.run()
        alone[i] = r.output == reqs[i].output
    first = []
    with torch.no_grad():
        for p, r, f32 in zip(prompts, reqs, first32):
            lg = prefill_logits(params, statics, p, scfg.max_seq,
                                torch.bfloat16, True, dev)[-1]
            first.append({"prompt_len": len(p),
                          "first_token_is_argmax": int(r.output[0]) == int(
                              lg.argmax()),
                          "bf16_vs_fp32": rel_diff(lg, f32),
                          "finite": bool(torch.isfinite(lg).all())})
    out_tokens = sum(len(r.output) for r in reqs)
    res.update(
        serve_config=GEN_SCFG, requests=len(reqs), new_tokens=GEN_NEW,
        bursts=list(GEN_BURSTS), prompt_lengths=[len(p) for p in prompts],
        all_done=all(r.done and len(r.output) == GEN_NEW for r in reqs),
        trace_count=svc.trace_count(), admitted_mid_decode=mid,
        alone_vs_cobatched_equal=alone, first_tokens=first,
        ssm_cache_bytes_per_slot=ssm_cache_bytes(svc.caches,
                                                 scfg.batch_slots),
        flash_launches=tfa.flash_attention_cuda.launches - launches0,
        run_seconds=run_s, output_tokens=out_tokens,
        tokens_per_s=out_tokens / run_s, **split,
        ttft_p50_s=m["first_result_p50_s"], ttft_p99_s=m["first_result_p99_s"],
        latency_p50_s=m["latency_p50_s"], latency_p99_s=m["latency_p99_s"])
    res["peak_memory_bytes"]["bfloat16"] = torch.cuda.max_memory_allocated()
    return res


def recorded_flash_calls(fn):
    """(result of ``fn()``, [(call's arguments, kernel output)]): every
    ``ops.flash_attention`` call ``fn`` makes, recorded."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.flash_attention

    def record(q, k, v, **kw):
        y = real(q, k, v, **kw)
        calls.append((dict(q=q, k=k, v=v, **kw), y))
        return y

    ops.flash_attention = record
    try:
        return fn(), calls
    finally:
        ops.flash_attention = real


def recorded_spmm_calls(fn):
    """(result of ``fn()``, [row]): every fp32 ``pattern_spmm_raw`` call
    that a model's sparse tiles make (``models.layers.sparse_tiles``)
    while ``fn`` runs, each held at once to the kernel's plain version on
    the same inputs at ``FP32_TOL`` (``compare``'s rule)."""
    import torch

    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.models import layers as tl

    rows = []
    real = tl.pattern_spmm_raw

    def record(xm, w_comp, block_ids, block, nnz=None, **kw):
        y = real(xm, w_comp, block_ids, block, nnz=nnz, **kw)
        want = tk.pattern_spmm_plain(xm, w_comp, block_ids, nnz, block)
        d = (y - want).abs()
        lim = FP32_TOL["atol"] + FP32_TOL["rtol"] * want.abs()
        rows.append({"x": list(xm.shape), "tiles": int(w_comp.shape[0]),
                     "max_abs_diff": float(d.max()),
                     "worst_over_limit": float((d / lim).max()),
                     "ok": bool((d <= lim).all()
                                and torch.isfinite(y).all())})
        return y

    tl.pattern_spmm_raw = record
    try:
        return fn(), rows
    finally:
        tl.pattern_spmm_raw = real


def tile_route(statics):
    """``statics`` with every sparse MLP layout's dictionary groups
    written out as its brick table: each tile of a group reads the
    group's pattern blocks (``block_ids``), and the groups are dropped,
    so ``models.layers.sparse_tiles`` takes the pattern-spmm kernel and
    computes the same function as the config's layouts, whose groups
    take one dense product per pattern (the reference's XLA route).  The
    init layouts draw ``block_ids`` apart from the groups, which alone
    say what the layer computes."""
    import numpy as np
    import torch

    def bricks(v):
        ids = np.array(v["block_ids"])
        for g in v["groups"]:
            ids[g["tiles"][0]:g["tiles"][1], :len(g["blocks"])] = g["blocks"]
        dev = v["tables"]["block_ids"].device
        return dict(v, block_ids=ids, groups=[], tables=dict(
            v["tables"], groups=[], block_ids=torch.as_tensor(
                ids, dtype=torch.int32, device=dev)))

    out = dict(statics)
    for key in ("prefix_layers", "body"):
        out[key] = []
        for st in statics[key]:
            st = dict(st)
            if st.get("mlp") and st["mlp"]["sparse"] is not None:
                st["mlp"] = {name: (bricks(v) if isinstance(v, dict)
                                    else v)
                             for name, v in st["mlp"].items()}
            out[key].append(st)
    return out


def jamba_run(seed: int, dev) -> dict:
    """jamba-1.5-large's first ``JAMBA_LAYERS`` layers in bf16 from the
    seed: served through ``DecodeService`` (the main path: flash counts
    from 0, the bursts, read), then each prompt's bf16 prefill again with
    its flash calls recorded (q, k, v at the real hidden state and the
    kernel's output), each held to the flash phase's rounding limit."""
    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import _leaves
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime.serve import DecodeService, ServeConfig
    from repro_torch.serve.api import Request

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, statics = draw_model(
        ssm_config("jamba_1_5_large_398b"), seed, dev, "bfloat16")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = param_bytes(params)
    largest = max(t.numel() for t in _leaves(params))
    res = {"model": cfg.name, "layers": cfg.n_layers,
           "layer_types": [list(t) for t in cfg.layer_types],
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "q_heads_padded": cfg.attn_cfg(False).hq_pad,
           "grouped": cfg.attn_cfg(False).grouped, "d_head": cfg.d_head,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "moe": dataclasses.asdict(cfg.moe),
           "ssm": dataclasses.asdict(cfg.ssm), "init_seconds": init_s,
           "weight_bytes": nbytes,
           # the weights plus the largest tensor's float32 draw, cast
           "reckoned_peak_bytes": nbytes + 4 * largest,
           "draw_peak_memory_bytes": torch.cuda.max_memory_allocated()}
    rng = np.random.default_rng(seed + 15)
    lengths = rng.integers(JAMBA_LENGTHS[0], JAMBA_LENGTHS[1] + 1,
                           JAMBA_REQUESTS)
    lengths[0] = JAMBA_LENGTHS[1]
    prompts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32)
               for n in lengths]
    scfg = ServeConfig(**JAMBA_SCFG)
    tracer = Tracer()
    svc = DecodeService(cfg, statics, params, scfg, tracer=tracer, device=dev)
    svc.submit(Request(prompt=np.ones(4, np.int32), max_new_tokens=2))
    svc.run()  # warm-up through the real admit/decode path
    svc.reset_metrics()
    tracer.reset()
    widths = []
    real = ops.flash_attention

    def shapes(q, *args, **kwargs):
        widths.append(int(q.shape[-1]))
        return real(q, *args, **kwargs)

    ops.flash_attention = shapes
    try:
        # the jamba path: counts from 0, the bursts through the service, read
        for key in ("launches", "launches_tensor_core", "launches_simt"):
            setattr(tfa.flash_attention_cuda, key, 0)
        reqs = [Request(prompt=p, max_new_tokens=JAMBA_NEW) for p in prompts]
        with RecordedRoutes() as rec:
            run_s = serve_bursts(svc, reqs, JAMBA_BURSTS)
        launches = tfa.flash_attention_cuda.launches
        routes = {"tensor_core": tfa.flash_attention_cuda.launches_tensor_core,
                  "simt": tfa.flash_attention_cuda.launches_simt}
    finally:
        ops.flash_attention = real
    drops = {"prefill": [0, 0], "decode": [0, 0]}
    for t, e in rec.calls:
        keep = moe.kept_pairs(e, cfg.moe)
        kind = "decode" if t == scfg.batch_slots else "prefill"
        drops[kind][0] += int((~keep).sum())
        drops[kind][1] += keep.numel()
    mid = sum(1 for ev in tracer.events()
              if ev.get("args", {}).get("event") == "admit_mid_decode")
    m = svc.metrics

    # each prompt's bf16 prefill again, its flash calls recorded
    def first_tokens():
        with torch.no_grad():
            return [int(r.output[0]) == int(prefill_logits(
                params, statics, p, scfg.max_seq, torch.bfloat16, True,
                dev)[-1].argmax()) for p, r in zip(prompts, reqs)]

    first, calls = recorded_flash_calls(first_tokens)
    flash = []
    for c, y in calls:
        case = {**c, "case": f"jamba_S{c['q'].shape[2]}", "dtype": "bfloat16"}
        flash.append(flash_row(case, y))
    res.update(
        serve_config=JAMBA_SCFG, requests=len(reqs), new_tokens=JAMBA_NEW,
        bursts=list(JAMBA_BURSTS), prompt_lengths=[len(p) for p in prompts],
        all_done=all(r.done and len(r.output) == JAMBA_NEW for r in reqs),
        trace_count=svc.trace_count(), admitted_mid_decode=mid,
        first_token_is_bf16_prefill_argmax=first,
        launches=launches, launches_by_route=routes,
        launch_head_dims=sorted(set(widths)),
        launches_expected=sum(mx == "attn" for mx, _ in cfg.layer_types)
        * len(reqs),
        flash_vs_plain=flash,
        drop_share={k: d / max(n, 1) for k, (d, n) in drops.items()},
        routed_pairs={k: v[1] for k, v in drops.items()},
        run_seconds=run_s,
        tokens_per_s=sum(len(r.output) for r in reqs) / run_s,
        **service_split(tracer),
        ttft_p50_s=m["first_result_p50_s"], latency_p50_s=m["latency_p50_s"],
        latency_p99_s=m["latency_p99_s"],
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    return res


def whisper_run(seed: int, dev) -> dict:
    """(d) and (e) on whisper-small whole (12 encoder and 12 decoder
    layers), frames from the seed: float32 first, then the same weights
    in bf16."""
    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.transformer import apply_model, init_cache
    from repro_torch.runtime.serve import ServeConfig, make_prefill_step

    cfg, params, statics = draw_model(ssm_config("whisper_small"), seed,
                                       dev, "float32")
    rng = np.random.default_rng(seed + 16)
    launches0 = tfa.flash_attention_cuda.launches

    def frames(batch):
        return torch.as_tensor(rng.normal(
            size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            device=dev)

    one = frames(1)
    prompt = rng.integers(1, cfg.vocab, WHISPER_PROMPT)
    batch = torch.as_tensor(rng.integers(1, cfg.vocab, (
        WHISPER_BATCH, WHISPER_PROMPT)), device=dev)
    many = frames(WHISPER_BATCH)
    acfg = cfg.attn_cfg(False)
    res = {"model": cfg.name, "layers": {"encoder": cfg.encoder_layers,
                                         "decoder": cfg.n_layers},
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "q_heads_padded": acfg.hq_pad, "grouped": acfg.grouped,
           "enc_seq": cfg.enc_seq, "vocab": cfg.vocab,
           "weight_bytes": {"float32": param_bytes(params)}}
    with torch.no_grad():
        res["handoff"] = handoff_row(params, statics, prompt, WHISPER_STEPS,
                                     dev, frames=one)
        # the step function a user calls: its token is the prefill's argmax
        cache = init_cache(statics, 1, WHISPER_PROMPT, dtype=torch.float32,
                           device=dev)
        tok, cache = make_prefill_step(cfg, statics, ServeConfig())(
            params, cache, torch.as_tensor(prompt[None], device=dev),
            extras={"frames": one})
        res["prefill_step_token_is_handoff_first"] = (
            int(tok[0]) == res["handoff"]["greedy_tokens"][0])
        want, _, _ = apply_model(params, statics, batch, frames=many)
        cfg, params, statics = to_dtype(cfg, params, statics, "bfloat16")
        torch.cuda.empty_cache()
        got, _, _ = apply_model(params, statics, batch,
                                frames=many.to(torch.bfloat16))
    res["weight_bytes"]["bfloat16"] = param_bytes(params)
    res["bf16_batch"] = {
        "shape": list(got.shape), "finite": bool(torch.isfinite(got).all()),
        "bf16_vs_fp32": rel_diff(got[..., :cfg.vocab].float(),
                                 want[..., :cfg.vocab].float())}
    res["flash_launches"] = tfa.flash_attention_cuda.launches - launches0
    return res


def ssm_whisper_phase(seed: int, dev) -> dict:
    """The three architectures the SSM mixer and the encoder with
    cross-attention unlock, at full width: (a) the SSD against a
    token-by-token recurrence at mamba2's and jamba's widths; mamba2 at
    all 48 layers ((b) the state handoff in float32, (c) served in bf16);
    jamba's first 5 layers served in bf16, its prefills through the
    flash kernel; whisper-small ((d) the handoff with frames in float32,
    (e) a bf16 batch); checks and the report."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ssd = [r for arch in SSD_S for r in ssd_rows(arch, seed, dev)]
    torch.cuda.empty_cache()
    mamba = mamba2_run(seed, dev)
    torch.cuda.empty_cache()
    jamba = jamba_run(seed, dev)
    torch.cuda.empty_cache()
    whisper = whisper_run(seed, dev)
    seconds = time.perf_counter() - t0
    emit("ssm_whisper", seconds=seconds,
         depth={"mamba2_780m": "48 of 48 layers",
                "jamba_1_5_large_398b": f"{JAMBA_LAYERS} of 72 layers",
                "whisper_small": "12 + 12 of 12 + 12 layers"},
         ssd_limit=f"output: max|d| <= {SSD_OUT_REL} x max|recurrence|; "
                   f"conv window and state: |d| <= {SSD_ATOL} + {SSD_RTOL} "
                   f"x |recurrence|, each value",
         handoff_limit=f"max|d| <= {HANDOFF_REL} x max(1, max|cacheless "
                       f"logit|)",
         ssd=ssd, mamba2_780m=mamba, jamba_1_5_large_398b=jamba,
         whisper_small=whisper,
         peak_memory_bytes=max(torch.cuda.max_memory_allocated(),
                               *mamba["peak_memory_bytes"].values(),
                               jamba["draw_peak_memory_bytes"],
                               jamba["peak_memory_bytes"]))
    bad = [(r["model"], r["S"]) for r in ssd if not r["ok"]]
    check(not bad, f"SSD off the token-by-token recurrence: {bad}")
    bad = [r["prompt_len"] for r in mamba["handoff"] if not r["ok"]]
    check(not bad, f"mamba2 cached prefill + decode off the cacheless "
                   f"forward for prompts of {bad} tokens")
    check(mamba["all_done"], "a mamba2 request did not complete")
    check(mamba["trace_count"] == 1,
          f"mamba2 decode trace_count {mamba['trace_count']} != 1")
    check(mamba["admitted_mid_decode"] > 0,
          "no mamba2 slot was refilled mid-decode")
    check(all(r["first_token_is_argmax"] and r["finite"]
              for r in mamba["first_tokens"]),
          "mamba2 served first tokens off the bf16 prefill's argmax, or "
          "its prefill logits not finite")
    check(all(mamba["alone_vs_cobatched_equal"].values()),
          f"mamba2 co-batched tokens differ from alone: "
          f"{mamba['alone_vs_cobatched_equal']}")
    check(jamba["all_done"], "a jamba request did not complete")
    check(jamba["admitted_mid_decode"] > 0,
          "no jamba slot was refilled mid-decode")
    check(all(jamba["first_token_is_bf16_prefill_argmax"]),
          f"jamba served first tokens off the bf16 prefill's argmax: "
          f"{jamba['first_token_is_bf16_prefill_argmax']}")
    check(jamba["grouped"] and jamba["launches"] == jamba["launches_expected"]
          and jamba["launches_by_route"]["tensor_core"] == jamba["launches"]
          and jamba["launch_head_dims"] == [jamba["d_head"]],
          f"jamba flash launches {jamba['launches']} (expected "
          f"{jamba['launches_expected']}), by route "
          f"{jamba['launches_by_route']}, head dims "
          f"{jamba['launch_head_dims']}")
    bad = [r["case"] for r in jamba["flash_vs_plain"] if not r["ok"]]
    check(jamba["flash_vs_plain"] and not bad,
          f"jamba's flash calls off the plain version: {bad}")
    check(whisper["handoff"]["ok"],
          f"whisper cached prefill + decode off the cacheless forward: "
          f"{whisper['handoff']}")
    check(whisper["prefill_step_token_is_handoff_first"],
          "make_prefill_step's token is not the prefill's argmax")
    check(whisper["bf16_batch"]["finite"], "whisper bf16 logits not finite")
    check(not whisper["grouped"] and whisper["flash_launches"] == 0,
          "whisper's heads do not group: no flash launch expected")
    return {"launches": jamba["launches"], "seconds": seconds,
            "max_abs_err": max(r["max_abs_diff"]
                               for r in jamba["flash_vs_plain"])}


def vlm_config():
    """The ``vlm`` phase's model: paligemma-3b as published, whole."""
    from repro_torch.configs import paligemma_3b

    return paligemma_3b.config()


def vlm_reckoning(cfg) -> dict:
    """Parameters and bytes of ``cfg``'s weights and of one row's float32
    logits at the longest prefill, reckoned from the config alone."""
    acfg = cfg.attn_cfg(False)
    d, dh = cfg.d_model, cfg.d_head
    attn = d * acfg.hq_pad * dh * 2 + d * acfg.n_kv_heads * dh * 2
    mlp = 2 * d * cfg.d_ff  # gelu: up and down, no gate
    n = cfg.padded_vocab * d + cfg.n_layers * (attn + mlp + 2 * d) + d
    s = cfg.prefix_len + max(VLM_PROMPTS)
    return {"params": n, "attention_per_layer": attn, "mlp_per_layer": mlp,
            "bfloat16_bytes": 2 * n, "float32_bytes": 4 * n,
            "float32_logits_bytes_per_row": 4 * s * cfg.padded_vocab,
            "longest_prefill": s}


def vlm_flash_rows(calls, dtype: str) -> list[dict]:
    """:func:`flash_row` of each recorded paligemma call, and whether the
    kernel gives the same bits on a rerun."""
    import torch

    from repro_torch.kernels import flash_attention as tfa

    rows = []
    for c, y in calls:
        row = flash_row({**c, "case": f"paligemma_S{c['q'].shape[2]}_{dtype}",
                         "dtype": dtype}, y)
        row["rerun_bit_identical"] = bool(torch.equal(
            tfa.flash_attention_cuda(c["q"], c["k"], c["v"],
                                     causal=c["causal"], window=c["window"],
                                     kv_len=c["kv_len"]), y))
        rows.append(row)
    return rows


def vlm_phase(seed: int, dev) -> dict:
    """paligemma-3b whole, its patch prefix in front of every prompt of
    ``VLM_PROMPTS``: (a) each prefill's flash calls at the path's shapes
    against the plain version; (b) the float32 cached prefill + decode
    against a cacheless forward; (c) the bf16 main path: the prefix
    prefills and ``VLM_DECODE`` tokens through the step functions, then
    text-only requests through ``DecodeService``, every prefill through
    the flash kernel at D 256; checks and the report."""
    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.transformer import count_params, init_cache
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime.serve import (
        DecodeService,
        ServeConfig,
        make_decode_step,
        make_prefill_step,
    )
    from repro_torch.serve.api import Request

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, statics = draw_model(vlm_config(), seed, dev, "float32")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    acfg = cfg.attn_cfg(False)
    rng = np.random.default_rng(seed + 17)
    p = cfg.prefix_len
    patches = torch.as_tensor(rng.normal(size=(1, p, cfg.d_model)).astype(
        np.float32), device=dev)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in VLM_PROMPTS]
    res = {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads],
           "q_heads_padded": acfg.hq_pad, "grouped": acfg.grouped,
           "d_head": cfg.d_head, "d_ff": cfg.d_ff, "act": cfg.act,
           "vocab": cfg.vocab, "prefix_len": p,
           "prompt_lengths": list(VLM_PROMPTS),
           "prefill_lengths": [p + n for n in VLM_PROMPTS],
           "reckoned": vlm_reckoning(cfg), "params": count_params(params),
           "weight_bytes": {"float32": param_bytes(params)},
           "init_seconds": init_s}

    # (b) float32: cached prefill with the prefix + decode = cacheless
    with torch.no_grad():
        res["handoff"] = [handoff_row(params, statics, pr, VLM_HANDOFF_STEPS,
                                      dev, prefix=patches) for pr in prompts]
        # (a) the SIMT route at the path's shapes: the kernel route's
        # prefill in float32, its flash calls recorded
        ref32, calls32 = [], []
        for pr in prompts:
            lg, calls = recorded_flash_calls(lambda pr=pr: prefill_logits(
                params, statics, pr, VLM_MAX_SEQ, torch.float32, True, dev,
                prefix=patches))
            ref32.append(prefill_logits(params, statics, pr, VLM_MAX_SEQ,
                                        torch.float32, False, dev,
                                        prefix=patches))
            res.setdefault("fp32_kernel_vs_plain", []).append(
                rel_diff(lg, ref32[-1]))
            calls32 += calls
    res["peak_memory_bytes"] = {"float32": torch.cuda.max_memory_allocated()}
    flash32 = vlm_flash_rows(calls32, "float32")
    del calls32
    cfg, params, statics = to_dtype(cfg, params, statics, "bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["weight_bytes"]["bfloat16"] = param_bytes(params)
    bf16 = torch.bfloat16

    scfg = ServeConfig(**VLM_SCFG)
    svc_tracer = Tracer()
    svc = DecodeService(cfg, statics, params, scfg, tracer=svc_tracer,
                        device=dev)
    svc.submit(Request(prompt=np.ones(4, np.int32), max_new_tokens=2))
    svc.run()  # warm-up through the real admit/decode path
    svc.reset_metrics()
    svc_tracer.reset()
    lengths = rng.integers(VLM_LENGTHS[0], VLM_LENGTHS[1] + 1, VLM_REQUESTS)
    texts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32)
             for n in lengths]
    prefill = make_prefill_step(cfg, statics, scfg)
    decode = make_decode_step(cfg, statics, scfg)

    # the vlm path: counts from 0, the prefix prefills and their decode
    # steps, then the text-only requests through the service, read
    for key in ("launches", "launches_tensor_core", "launches_simt"):
        setattr(tfa.flash_attention_cuda, key, 0)
    served, step_s = [], []
    with torch.no_grad():
        for pr in prompts:
            cache = init_cache(statics, 1, VLM_MAX_SEQ, dtype=bf16,
                               device=dev)
            toks = torch.as_tensor(pr[None].astype(np.int64), device=dev)
            t1 = time.perf_counter()
            tok, cache = prefill(params, cache, toks,
                                 extras={"prefix_embeds": patches})
            out = [int(tok[0])]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pos = p + len(pr)
            for i in range(VLM_DECODE):
                tok, cache = decode(params, cache, tok,
                                    torch.tensor(pos + i, device=dev))
                out.append(int(tok[0]))
            torch.cuda.synchronize()
            step_s.append({"prefill_s": t2 - t1,
                           "decode_s_per_step": (time.perf_counter() - t2)
                           / VLM_DECODE})
            served.append(out)
            del cache
    reqs = [Request(prompt=t, max_new_tokens=VLM_NEW) for t in texts]
    run_s = serve_bursts(svc, reqs, VLM_BURSTS)
    launches = tfa.flash_attention_cuda.launches
    routes = {"tensor_core": tfa.flash_attention_cuda.launches_tensor_core,
              "simt": tfa.flash_attention_cuda.launches_simt}
    m = svc.metrics
    split = service_split(svc_tracer)
    mid = sum(1 for e in svc_tracer.events()
              if e.get("args", {}).get("event") == "admit_mid_decode")
    alone = {}
    for i in (0, VLM_REQUESTS - 1):
        r = Request(prompt=texts[i], max_new_tokens=VLM_NEW)
        svc.submit(r)
        svc.run()
        alone[i] = r.output == reqs[i].output

    # (c) the bf16 prefill logits against float32, and (a) the
    # tensor-core route's calls at the path's shapes
    parity, calls16 = [], []
    with torch.no_grad():
        for pr, f32, out in zip(prompts, ref32, served):
            kern, calls = recorded_flash_calls(lambda pr=pr: prefill_logits(
                params, statics, pr, VLM_MAX_SEQ, bf16, True, dev,
                prefix=patches))
            calls16 += calls
            plain = prefill_logits(params, statics, pr, VLM_MAX_SEQ, bf16,
                                   False, dev, prefix=patches)
            noise = rel_diff(plain, f32)
            row = {"prompt_len": len(pr), "prefill_len": p + len(pr),
                   "bf16_kernel_vs_plain": rel_diff(kern, plain),
                   "bf16_plain_vs_fp32": noise,
                   "bf16_kernel_vs_fp32": rel_diff(kern, f32),
                   "bf16_limit": GEN_BF16_NOISE_FACTOR * noise,
                   "first_token_is_bf16_prefill_argmax": out[0] == int(
                       kern[-1].argmax()),
                   "finite": bool(torch.isfinite(kern).all()),
                   "logits_shape": [p + len(pr), cfg.vocab],
                   "decoded_tokens": len(out) - 1}
            row["ok"] = (row["bf16_kernel_vs_plain"] <= row["bf16_limit"]
                         and row["first_token_is_bf16_prefill_argmax"]
                         and row["finite"] and kern.shape[0] == p + len(pr))
            parity.append(row)
    flash16 = vlm_flash_rows(calls16, "bfloat16")
    del calls16
    res.update(
        fp32_limit=GEN_FP32_REL, prefill_logits=parity,
        prefix_prefill_step_seconds=step_s, prefix_served_tokens=served,
        serve_config=VLM_SCFG, requests=len(reqs), new_tokens=VLM_NEW,
        bursts=list(VLM_BURSTS), text_prompt_lengths=[len(t) for t in texts],
        all_done=all(r.done and len(r.output) == VLM_NEW for r in reqs),
        trace_count=svc.trace_count(), admitted_mid_decode=mid,
        alone_vs_cobatched_equal=alone,
        prefills_with_prefix=len(prompts), launches=launches,
        launches_by_route=routes,
        launches_expected=cfg.n_layers * (len(prompts) + len(reqs)),
        run_seconds=run_s,
        tokens_per_s=sum(len(r.output) for r in reqs) / run_s, **split,
        ttft_p50_s=m["first_result_p50_s"], latency_p50_s=m["latency_p50_s"],
        latency_p99_s=m["latency_p99_s"])
    res["peak_memory_bytes"]["bfloat16"] = torch.cuda.max_memory_allocated()
    flash = {"bfloat16": flash16, "float32": flash32}
    return res, flash


def vlm_phase_run(seed: int, dev) -> dict:
    """:func:`vlm_phase`, its JSON line and its checks."""
    t0 = time.perf_counter()
    res, flash = vlm_phase(seed, dev)
    seconds = time.perf_counter() - t0
    shapes = sorted({tuple(r["q"]) for rows in flash.values() for r in rows})
    emit("vlm", seconds=seconds, depth=f"{res['layers']} of 18 layers",
         handoff_limit=f"max|d| <= {HANDOFF_REL} x max(1, max|cacheless "
                       f"logit|)",
         flash_limit="bf16: flash_tolerance and the rounding limit; fp32: "
                     "flash_tolerance; each the same bits on a rerun",
         flash_shapes=[list(x) for x in shapes],
         flash_vs_plain={dt: {"calls": len(rows),
                              "worst_over_limit": max(
                                  (r["worst_over_limit"] for r in rows),
                                  default=None),
                              "worst_over_rounding_limit": max(
                                  (r.get("worst_over_rounding_limit", 0.0)
                                   for r in rows), default=None),
                              "max_abs_diff": max(
                                  (r["max_abs_diff"] for r in rows),
                                  default=None),
                              "failed": [r["case"] for r in rows
                                         if not r["ok"]
                                         or not r["rerun_bit_identical"]]}
                         for dt, rows in flash.items()},
         **res)
    calls = res["layers"] * len(VLM_PROMPTS)
    for dt, rows in flash.items():
        bad = [r["case"] for r in rows
               if not r["ok"] or not r["rerun_bit_identical"]]
        check(len(rows) == calls and not bad,
              f"paligemma's {dt} flash calls: {len(rows)} of {calls} "
              f"recorded, off the plain version or not rerun-identical: "
              f"{bad}")
    widths = {r["q"][-1] for rows in flash.values() for r in rows}
    check(widths == {res["d_head"]},
          f"paligemma's flash calls at head widths {widths}")
    bad = [r["prompt_len"] for r in res["handoff"] if not r["ok"]]
    check(not bad, f"paligemma cached prefill + decode off the cacheless "
                   f"forward for prompts of {bad} tokens")
    bad = [n for n, r in zip(VLM_PROMPTS, res["fp32_kernel_vs_plain"])
           if r > GEN_FP32_REL]
    check(not bad, f"paligemma's float32 kernel route off the plain route "
                   f"for prompts of {bad} tokens")
    bad = [r["prompt_len"] for r in res["prefill_logits"] if not r["ok"]]
    check(not bad, f"paligemma's bf16 prefill with the prefix failed for "
                   f"prompts of {bad} tokens: {res['prefill_logits']}")
    check(res["all_done"], "a paligemma request did not complete")
    check(res["trace_count"] == 1,
          f"paligemma decode trace_count {res['trace_count']} != 1")
    check(all(res["alone_vs_cobatched_equal"].values()),
          f"paligemma co-batched tokens differ from alone: "
          f"{res['alone_vs_cobatched_equal']}")
    check(all(len(t) == VLM_DECODE + 1 for t in res["prefix_served_tokens"]),
          "paligemma's decode steps did not all run")
    check(res["params"] == res["reckoned"]["params"],
          f"paligemma has {res['params']} parameters, reckoned "
          f"{res['reckoned']['params']}")
    check(res["grouped"] and res["launches"] == res["launches_expected"]
          and res["launches_by_route"]["tensor_core"] == res["launches"],
          f"paligemma flash launches {res['launches']} (expected "
          f"{res['launches_expected']}), by route {res['launches_by_route']}")
    return {"launches": res["launches"], "seconds": seconds,
            "max_abs_err": max(r["max_abs_diff"]
                               for r in flash["bfloat16"])}


def train_config():
    """The ``train`` phase's model: the generate phase's h2o-danube-1.8B."""
    from repro_torch.configs import h2o_danube_1_8b

    return h2o_danube_1_8b.config(sparse=True)


def train_reckoning(params) -> dict:
    """Bytes of a training step's state, from the params: the params and
    their grads in the params' dtype, AdamW's two float32 moments.  The
    donated step (``make_train_step(..., donate=True)``) peaks at the
    state, the grads and the global norm's float32 square of the largest
    leaf (``optim.optimizers.global_norm``; ``donated_peak_bytes``): the
    grads are clipped in place, AdamW writes the moments and the params
    in place, its float32 temporaries a piece's
    (``optim.optimizers.UPDATE_CHUNK``), and with remat the backward's
    activations stay below that (``scripts/step_peak_site.py
    --unsharded``)."""
    from repro_torch.models.transformer import _leaves

    n = sum(t.numel() for t in _leaves(params))
    p = sum(t.numel() * t.element_size() for t in _leaves(params))
    moments = 2 * 4 * n  # mu and nu in float32
    largest = max(t.numel() for t in _leaves(params))
    return {"params": n, "params_bytes": p, "grads_bytes": p,
            "moments_bytes": moments, "state_bytes": p + moments,
            "largest_leaf": largest,
            "donated_peak_bytes": 2 * p + moments + 4 * largest}


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def timed_saves(trainer) -> list:
    """Wrap ``trainer.ckpt.save`` to record how long each call holds the
    loop (the whole write when synchronous, the host snapshot when
    async); returns the list it appends to."""
    seconds = []
    save = trainer.ckpt.save

    def timed(step, tree):
        t0 = time.perf_counter()
        save(step, tree)
        seconds.append(time.perf_counter() - t0)

    trainer.ckpt.save = timed
    return seconds


def train_data(seed: int, corpus, batch):
    """Packed ``batch`` = (rows, tokens a row) batches of ``corpus``."""
    from repro_torch.data import DataConfig, packed_batches

    rows, seq = batch
    return packed_batches(DataConfig(vocab=corpus.vocab, seq_len=seq,
                                     global_batch=rows, seed=seed), corpus)


def train_full(seed: int, dev, corpus, ckpt_dir) -> tuple:
    """(a): TRAIN_STEPS steps of the full model through ``Trainer``;
    returns the report and the trained (cfg, params, statics)."""
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import (
        TrainConfig,
        Trainer,
        init_train_state,
        make_train_step,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = train_config()
    t0 = time.perf_counter()
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reckoned = train_reckoning(params)
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                       ckpt_dir=ckpt_dir)
    step = make_train_step(cfg, statics, opt, lambda s: TRAIN_LR, tcfg,
                           donate=True)
    trainer = Trainer(step, init_train_state(params, opt, tcfg),
                      train_data(seed, corpus, TRAIN_BATCH), tcfg)
    del params
    saves = timed_saves(trainer)
    t0 = time.perf_counter()
    hist = trainer.run()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rows, seq = TRAIN_BATCH
    secs = [h["seconds"] for h in hist]
    losses = [h["loss"] for h in hist]
    last = float(np.mean(losses[-TRAIN_LAST:]))
    res = {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "d_ff": cfg.d_ff,
           "sparse": dataclasses.asdict(cfg.sparse), "remat": cfg.remat,
           "param_dtype": cfg.param_dtype, "optimizer": "adamw, float32 "
           "moments, weight_decay 0", "lr": TRAIN_LR,
           "batch": list(TRAIN_BATCH), "corpus_vocab": TRAIN_CORPUS_VOCAB,
           "init_seconds": init_s, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "loss_first": losses[0], f"loss_mean_last_{TRAIN_LAST}": last,
           "loss_fell": losses[0] - last, "fall_limit": TRAIN_FALL,
           "step_seconds": secs,
           "tokens_per_s_after_first": rows * seq * (len(secs) - 1)
           / sum(secs[1:]),
           "run_seconds": run_s, "reckoned": reckoned,
           "donated": True, "peak_memory_bytes": peak,
           # None off the card, where nothing reads the peak
           "peak_rel": abs(peak - reckoned["donated_peak_bytes"]) / peak
           if peak else None,
           "peak_limit": DRYRUN_PEAK_REL,
           "checkpoint": {"steps": [TRAIN_STEPS], "seconds": saves,
                          "bytes": dir_bytes(ckpt_dir)}}
    return res, (cfg, trainer.state["params"], statics)


def drill_spec(seed: int, dev, ckpt_dir: str) -> dict:
    """What the drill's process needs, its config cut to DRILL_LAYERS."""
    import torch

    full = train_config()
    return {"cfg": dataclasses.replace(
                full, n_layers=DRILL_LAYERS,
                layer_types=full.layer_types[:DRILL_LAYERS]),
            "seed": seed, "device": str(dev), "ckpt_dir": ckpt_dir,
            "threads": torch.get_num_threads(), "batch": TRAIN_BATCH,
            "corpus_vocab": TRAIN_CORPUS_VOCAB, "lr": TRAIN_LR,
            "steps": TRAIN_STEPS, "ckpt_every": DRILL_CKPT_EVERY,
            "fail_at": DRILL_FAIL_AT}


def drill_rank(rank: int, spec: dict) -> None:
    """The drill's process: :func:`train_drill` under deterministic
    algorithms, its result written to ``drill.pkl`` in the checkpoint
    directory."""
    import pickle

    import torch

    torch.set_num_threads(spec["threads"])
    torch.use_deterministic_algorithms(True)
    res = train_drill(spec)
    with open(os.path.join(spec["ckpt_dir"], "drill.pkl"), "wb") as f:
        pickle.dump(res, f)


def train_drill(spec: dict) -> dict:
    """(b): an uninterrupted run against one that fails at
    ``spec["fail_at"]`` and restarts from its latest async checkpoint."""
    import torch

    from repro_torch.data import SyntheticCorpus
    from repro_torch.models.transformer import _leaves, init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import (
        FailureInjector,
        SimulatedFailure,
        TrainConfig,
        Trainer,
        init_train_state,
        make_train_step,
    )

    cfg, seed, dev = spec["cfg"], spec["seed"], torch.device(spec["device"])
    steps, every, fail_at = spec["steps"], spec["ckpt_every"], spec["fail_at"]
    corpus = SyntheticCorpus(spec["corpus_vocab"], seed)
    opt = adamw(weight_decay=0.0)

    def trainer(name, injector=None, donate=True, **kw):
        """A fresh Trainer from the seed (and its batch stream), writing
        its checkpoints under ``name``; its step donates the state, as
        the launcher's does, unless ``donate`` is false."""
        tcfg = TrainConfig(steps=steps, ckpt_dir=os.path.join(
            spec["ckpt_dir"], name), **kw)
        params, statics = init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        step = make_train_step(cfg, statics, opt, lambda s: spec["lr"], tcfg,
                               donate=donate)
        batches = train_data(seed, corpus, spec["batch"])
        return Trainer(step, init_train_state(params, opt, tcfg), batches,
                       tcfg, injector=injector), batches

    drill = dict(ckpt_every=every, async_ckpt=True)
    # the uninterrupted run's step is functional: the donated runs'
    # losses and final state equal its bit for bit
    ref, _ = trainer("uninterrupted", donate=False, ckpt_every=steps)
    ref_hist = ref.run()
    failed, _ = trainer("failed", FailureInjector({fail_at: "node-failure"}),
                        **drill)
    saves = timed_saves(failed)
    try:
        failed.run()
        raised = False
    except SimulatedFailure:
        raised = True
    failed.ckpt.close()  # the writer finishes what it was handed
    ckpt_bytes = dir_bytes(os.path.join(
        spec["ckpt_dir"], "failed", f"step_{failed.ckpt.latest_step():010d}"))
    resumed, batches = trainer("failed", **drill)
    t0 = time.perf_counter()
    at = resumed.maybe_restore()
    restore_s = time.perf_counter() - t0
    for _ in range(at):
        next(batches)
    hist = resumed.run()
    resumed.ckpt.close()
    losses = {h["step"]: h["loss"] for h in failed.history + hist}
    ref_losses = {h["step"]: h["loss"] for h in ref_hist}
    one_rank = one_rank_mesh_steps(spec, corpus)
    return {"one_rank_mesh": one_rank,
            "remat": remat_loss_and_grads(spec, corpus),
            "layers": cfg.n_layers, "steps": steps, "ckpt_every": every,
            "async": True, "failure_at": fail_at, "failure_raised": raised,
            "restored_step": at, "restore_seconds": restore_s,
            "deterministic_algorithms":
                torch.are_deterministic_algorithms_enabled(),
            "cublas_workspace_config": os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG"),
            "losses_uninterrupted": [h["loss"] for h in ref_hist],
            "losses_interrupted": [losses[k] for k in sorted(losses)],
            "losses_bit_equal": losses == ref_losses,
            "final_state_bit_equal": all(torch.equal(a, b) for a, b in zip(
                _leaves(ref.state), _leaves(resumed.state))),
            "async_save_blocking_seconds": saves,
            "checkpoint_bytes": ckpt_bytes,
            "reckoned_checkpoint_bytes": train_reckoning(
                ref.state["params"])["state_bytes"]}


def remat_loss_and_grads(spec: dict, corpus) -> dict:
    """(f): the drill's model on its first batch, the step's loss and
    gradients (``step.loss_and_grads``) with remat and without, compared
    bit for bit."""
    import torch

    from repro_torch.models.transformer import _leaves, init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, make_train_step
    from repro_torch.runtime.train import _to_device

    cfg, seed, dev = spec["cfg"], spec["seed"], torch.device(spec["device"])
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    batch = _to_device(next(train_data(seed, corpus, spec["batch"])), dev)
    out = {}
    for remat in (True, False):
        st = dict(statics, cfg=dataclasses.replace(cfg, remat=remat))
        step = make_train_step(cfg, st, adamw(weight_decay=0.0),
                               lambda s: spec["lr"], TrainConfig())
        loss, grads = step.loss_and_grads(params, batch)
        out[remat] = (loss, list(_leaves(grads)))
    (l1, g1), (l0, g0) = out[True], out[False]
    return {"loss_remat": float(l1), "loss_no_remat": float(l0),
            "loss_bit_equal": torch.equal(l1, l0), "grad_leaves": len(g1),
            "grads_bit_equal": len(g1) == len(g0) and all(
                torch.equal(a, b) for a, b in zip(g1, g0))}


def one_rank_mesh_steps(spec: dict, corpus) -> dict:
    """(e): ONE_RANK_STEPS steps of the drill's model unsharded, then
    through the sharded step on a one-rank mesh (its own group: NCCL on
    the card), from the same seed and batches; losses and every leaf of
    the state compared bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.data import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import (
        _leaves,
        init_params,
        init_specs,
    )
    from repro_torch.optim import adamw
    from repro_torch.runtime import (
        TrainConfig,
        init_train_state,
        make_train_step,
        train_shardings,
    )

    cfg, seed, dev = spec["cfg"], spec["seed"], torch.device(spec["device"])
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
    backend = str(dist.get_backend())
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig(steps=ONE_RANK_STEPS)
    runs = {}
    for name in ("unsharded", "sharded"):
        params, statics = init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        shardings = (train_shardings(init_specs(cfg), params, mesh)
                     if name == "sharded" else None)
        step = make_train_step(cfg, statics, opt, lambda s: spec["lr"], tcfg,
                               shardings=shardings)
        state = init_train_state(params, opt, tcfg, shardings)
        del params
        batches = train_data(seed, corpus, spec["batch"])
        losses = []
        for _ in range(ONE_RANK_STEPS):
            b = next(batches)
            state, m = step(state, shard_batch(b, mesh) if shardings
                            else {k: torch.as_tensor(v, device=dev)
                                  for k, v in b.items()})
            losses.append(float(m["loss"]))
        runs[name] = (losses, state)
    dist.destroy_process_group()
    (l0, s0), (l1, s1) = runs["unsharded"], runs["sharded"]
    return {"mesh": [1, 1], "backend": backend, "steps": ONE_RANK_STEPS,
            "losses_unsharded": l0, "losses_sharded": l1,
            "losses_bit_equal": l0 == l1,
            "state_bit_equal": all(torch.equal(a, b) for a, b in zip(
                _leaves(s0), _leaves(s1))),
            "seconds": time.perf_counter() - t0}


def run_drill(seed: int, dev) -> dict:
    """(b) in a spawned process of its own, so that only it runs cuBLAS
    under ``DRILL_CUBLAS_WORKSPACE``; returns its result and seconds."""
    import pickle

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as ckpt_dir:
        was = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = DRILL_CUBLAS_WORKSPACE
        t0 = time.perf_counter()
        try:
            mp.start_processes(drill_rank, args=(drill_spec(seed, dev,
                                                            ckpt_dir),),
                               nprocs=1, join=True, start_method="spawn")
        finally:
            if was is None:
                del os.environ["CUBLAS_WORKSPACE_CONFIG"]
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = was
        seconds = time.perf_counter() - t0
        with open(os.path.join(ckpt_dir, "drill.pkl"), "rb") as f:
            res = pickle.load(f)
    return {**res, "process_seconds": seconds}


def train_serve(trained, seed: int, dev) -> dict:
    """(c): the trained weights through ``DecodeService`` (the main path:
    flash counts from 0, the bursts, read), then each prompt's prefill
    again with its flash calls recorded and held to the rounding limit."""
    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.runtime.serve import DecodeService, ServeConfig
    from repro_torch.serve.api import Request

    cfg, params, statics = trained
    rng = np.random.default_rng(seed + 21)
    lengths = rng.integers(TRAIN_LENGTHS[0], TRAIN_LENGTHS[1] + 1,
                           TRAIN_REQUESTS)
    lengths[0] = TRAIN_LENGTHS[1]
    prompts = [rng.integers(1, TRAIN_CORPUS_VOCAB, int(n)).astype(np.int32)
               for n in lengths]
    scfg = ServeConfig(**TRAIN_SCFG)
    svc = DecodeService(cfg, statics, params, scfg, device=dev)
    svc.submit(Request(prompt=np.ones(4, np.int32), max_new_tokens=2))
    svc.run()  # warm-up through the real admit/decode path
    # the serve-after-train path: counts from 0, the bursts, read
    for key in ("launches", "launches_tensor_core", "launches_simt"):
        setattr(tfa.flash_attention_cuda, key, 0)
    reqs = [Request(prompt=p, max_new_tokens=TRAIN_NEW) for p in prompts]
    run_s = serve_bursts(svc, reqs, TRAIN_BURSTS)
    launches = tfa.flash_attention_cuda.launches
    routes = {"tensor_core": tfa.flash_attention_cuda.launches_tensor_core,
              "simt": tfa.flash_attention_cuda.launches_simt}

    def first_tokens():
        return [int(prefill_logits(params, statics, p, scfg.max_seq,
                                   torch.bfloat16, True, dev)[-1].argmax())
                for p in prompts]

    firsts, calls = recorded_flash_calls(first_tokens)
    flash = []
    for c, y in calls:
        case = {**c, "case": f"trained_S{c['q'].shape[2]}",
                "dtype": "bfloat16"}
        row = {**flash_row(case, y), **flash_term_limit(case, y)}
        row["ok"] = (row["worst_over_limit"] <= 1.0 and row["finite"]
                     and row["worst_over_term_limit"] <= 1.0)
        flash.append(row)
    outputs = [t for r in reqs for t in r.output]
    attn = sum(m in ("attn", "swa") for m, _ in cfg.layer_types)
    res = {"serve_config": TRAIN_SCFG, "requests": len(reqs),
           "new_tokens": TRAIN_NEW, "bursts": list(TRAIN_BURSTS),
           "prompt_lengths": [len(p) for p in prompts],
           "all_done": all(r.done and len(r.output) == TRAIN_NEW
                           for r in reqs),
           "tokens_below_vocab": all(0 <= t < cfg.vocab for t in outputs),
           "first_token_is_prefill_argmax": [
               int(r.output[0]) == f for r, f in zip(reqs, firsts)],
           "launches": launches, "launches_by_route": routes,
           "launches_expected": attn * len(reqs),
           "flash_calls_checked": len(flash),
           "flash_limit": "flash_tolerance and half an ulp of each value + "
                          f"{FLASH_SUM_SLACK} x sum_j p_j |v_j| / l "
                          "(flash_term_limit)",
           "flash_worst_over_term_limit": max(
               r["worst_over_term_limit"] for r in flash),
           "flash_worst_over_rounding_limit": max(
               r["worst_over_rounding_limit"] for r in flash),
           "flash_calls_over_rounding_limit": [
               {k: r[k] for k in ("case", "worst_over_rounding_limit",
                                  "worst_over_term_limit",
                                  "min_row_max_over_terms")}
               for r in flash if r["worst_over_rounding_limit"] > 1.0],
           "flash_max_abs_diff": max(r["max_abs_diff"] for r in flash),
           "flash_failed": [r for r in flash if not r["ok"]],
           "run_seconds": run_s,
           "tokens_per_s": len(outputs) / run_s}
    return res


def train_guards(seed: int, dev) -> dict:
    """(d): the six wrappers refuse CUDA inputs that require grad, and
    one granite-3-2b smoke float32 step on the card against the CPU."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, packed_batches
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ou_mvm as tou
    from repro_torch.kernels import patches as tp
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.models.transformer import init_params, init_statics
    from repro_torch.optim import adamw
    from repro_torch.runtime import TrainConfig, init_train_state
    from repro_torch.runtime import make_train_step

    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, dtype=torch.float32, grad=False):
        return torch.randn(shape, generator=g, device=dev).to(
            dtype).requires_grad_(grad)

    ids = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    nnz = torch.full((2,), 2, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    calls = {
        "pattern_spmm_cuda": (tk.pattern_spmm_cuda, lambda: (
            rand(3, 8, grad=True), rand(2, 2, 4, 4), ids, nnz, 4)),
        "pattern_spmm_quant_cuda": (tk.pattern_spmm_quant_cuda, lambda: (
            torch.ones((3, 8), dtype=torch.int8, device=dev),
            torch.ones((2, 2, 4, 4), dtype=torch.int8, device=dev), ids,
            rand(2, 2, grad=True), nnz, 4)),
        "ou_mvm_cuda": (tou.ou_mvm_cuda, lambda: (rand(20, grad=True),
                                                  rand(20, 8))),
        "flash_attention_cuda": (tfa.flash_attention_cuda, lambda: (
            rand(1, 2, 5, 16, dtype=bf, grad=True), rand(1, 1, 5, 16, dtype=bf),
            rand(1, 1, 5, 16, dtype=bf))),
        "conv_patches_cuda": (tp.conv_patches_cuda, lambda: (
            rand(2, 3, 4, 4, grad=True), 3, 32)),
        "conv_patches_q8_cuda": (tp.conv_patches_q8_cuda, lambda: (
            rand(2, 3, 4, 4, grad=True), 3, 32)),
    }
    refused = {}
    for name, (fn, args) in calls.items():
        n0 = fn.launches
        try:
            fn(*args())
            refused[name] = False
        except ValueError as e:
            refused[name] = "grad" in str(e) and fn.launches == n0

    cfg = get_smoke_config("granite_3_2b")
    params, _ = init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    batch = next(packed_batches(DataConfig(vocab=cfg.vocab, seq_len=32,
                                           global_batch=8, seed=seed)))
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig(steps=1)
    metrics = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        statics = init_statics(cfg, device)
        p = _map_tensors(params, lambda t: t.to(device))
        step = make_train_step(cfg, statics, opt, lambda s: 1e-3, tcfg)
        _, m = step(init_train_state(p, opt, tcfg),
                    {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()})
        metrics[where] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    rel = {k: abs(metrics["card"][k] - metrics["cpu"][k])
           / abs(metrics["cpu"][k]) for k in ("loss", "grad_norm")}
    res = {"refused": refused, "smoke_step": metrics,
           "smoke_step_rel": rel, "smoke_limit": GUARD_REL,
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    return res


def train_phase(seed: int, dev) -> dict:
    """The ``train`` phase, (a) to (d), and its JSON line."""
    import torch

    from repro_torch.data import SyntheticCorpus

    t0 = time.perf_counter()
    corpus = SyntheticCorpus(TRAIN_CORPUS_VOCAB, seed)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        full, trained = train_full(seed, dev, corpus, ckpt_dir)
    served = train_serve(trained, seed, dev)
    del trained
    torch.cuda.empty_cache()
    drill = run_drill(seed, dev)
    guards = train_guards(seed, dev)
    seconds = time.perf_counter() - t0
    emit("train", seconds=seconds, full=full, drill=drill, serve=served,
         guards=guards)
    train_checks(full, drill, served, guards)
    return {"launches": served["launches"],
            "max_abs_err": served["flash_max_abs_diff"],
            "peak_memory_bytes": full["peak_memory_bytes"]}


def train_checks(full, drill, served, guards) -> None:
    """The ``train`` phase's gates, after its line is printed."""
    losses = full["losses"]
    last = full[f"loss_mean_last_{TRAIN_LAST}"]
    check(all(np.isfinite(losses)), f"danube's losses {losses}")
    check(full["remat"] and full["donated"]
          and (full["peak_rel"] is None and not full["peak_memory_bytes"]
               or full["peak_rel"] <= full["peak_limit"]),
          f"danube's peak {full['peak_memory_bytes']} with remat "
          f"{full['remat']}: {full['peak_rel']} from the donated step's "
          f"reckoned {full['reckoned']['donated_peak_bytes']}, over "
          f"{full['peak_limit']}")
    check(last < losses[0] - TRAIN_FALL,
          f"danube did not learn: {losses[0]} -> {last} over the last "
          f"{TRAIN_LAST} of {TRAIN_STEPS} steps")
    check(drill["deterministic_algorithms"]
          and drill["cublas_workspace_config"] == DRILL_CUBLAS_WORKSPACE,
          f"the drill ran without deterministic algorithms or cuBLAS "
          f"workspace {drill['cublas_workspace_config']}")
    check(drill["failure_raised"], "the injected failure did not fire")
    check(drill["restored_step"]
          == DRILL_FAIL_AT - DRILL_FAIL_AT % DRILL_CKPT_EVERY,
          f"restored step {drill['restored_step']}")
    check(drill["losses_bit_equal"],
          f"restarted losses {drill['losses_interrupted']} != "
          f"uninterrupted {drill['losses_uninterrupted']}")
    check(drill["final_state_bit_equal"], "the restarted run's final "
                                          "state differs from the "
                                          "uninterrupted run's")
    rm = drill["remat"]
    check(rm["loss_bit_equal"] and rm["grads_bit_equal"],
          f"(f) remat changes the loss or the gradients: loss "
          f"{rm['loss_remat']} vs {rm['loss_no_remat']}, gradients equal "
          f"{rm['grads_bit_equal']}")
    one = drill["one_rank_mesh"]
    check(one["losses_bit_equal"] and one["state_bit_equal"],
          f"the sharded step on a one-rank mesh differs from the unsharded "
          f"step: losses {one['losses_sharded']} vs "
          f"{one['losses_unsharded']}, state equal {one['state_bit_equal']}")
    check(served["all_done"], "a request for the trained model did not "
                              "complete")
    check(served["tokens_below_vocab"], "a served token is outside the "
                                        "vocabulary")
    check(all(served["first_token_is_prefill_argmax"]),
          f"served first tokens vs prefill argmax: "
          f"{served['first_token_is_prefill_argmax']}")
    check(served["launches"] == served["launches_expected"]
          and served["launches_by_route"]["tensor_core"]
          == served["launches"],
          f"trained danube's flash launches {served['launches']} (expected "
          f"{served['launches_expected']}), by route "
          f"{served['launches_by_route']}")
    check(served["flash_calls_checked"] == served["launches_expected"]
          and not served["flash_failed"],
          f"trained danube's flash calls off their limit: "
          f"{[r['case'] for r in served['flash_failed']]} "
          f"({served['flash_calls_checked']} checked)")
    check(all(guards["refused"].values()),
          f"a wrapper took an input that requires grad: {guards['refused']}")
    check(max(guards["smoke_step_rel"].values()) <= GUARD_REL,
          f"granite smoke step on the card vs the CPU: "
          f"{guards['smoke_step_rel']}")


def cut_layers(cfg, n: int, dtype: str):
    """``cfg`` cut to its first ``n`` layers (danube's are all alike), in
    ``dtype`` params and compute."""
    if len(set(cfg.layer_types)) != 1:
        raise ValueError(f"{cfg.name} mixes layer kinds; cut it by hand")
    return dataclasses.replace(cfg, n_layers=n,
                               layer_types=cfg.layer_types[:1] * n,
                               param_dtype=dtype, compute_dtype=dtype)


def _cuda_peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _nbytes(tree) -> int:
    from repro_torch.models.transformer import _leaves

    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def adam_rule(got, want, grads, lr: float, noise=None) -> dict:
    """tests/test_torch_train_step.py's rule, leaf by leaf on the device
    of ``got`` (``(key, leaf)`` pairs in checkpoint order; ``want`` and
    ``grads`` may lie on the host):
    weights of ``got`` off ``want`` by >= ADAM_OFF x lr, and how many of
    them have a well-posed gradient (``grads``; None: not classified):
    |g| at or above NOISE_FLOOR of its leaf's largest and at or above
    ADAM_EPS_REGION x Adam's eps (the fixed floors), and, with ``noise``
    (leaf key -> each weight's measured change dg of the reference's
    gradient, ``reference_noise``), where Adam's first step at |g| - dg
    (above 0) lies within ADAM_OFF x lr of its step at |g|.  Below the
    eps region Adam's first step, lr g / (|g| + eps), follows the
    gradient's absolute rounding noise: a change of 0.05 eps in g moves
    it by up to 0.05 lr; where the measured change can move it by
    ADAM_OFF x lr the reference's own step moves by as much (the step is
    concave in |g|, so the change down bounds the change up).  The
    weights off where only the first condition fails to hold are listed,
    and the count the fixed floors alone call well posed is reported
    beside."""
    from repro_torch.checkpoint.checkpointer import _leaf_paths

    off, posed_off, total, worst, near_eps = 0, 0, 0, 0.0, []
    fixed_off = 0
    gs = dict(_leaf_paths(grads)) if grads is not None else {}
    for (key, a), (_, b) in zip(got, _leaf_paths(want)):
        d = (a.float() - b.to(a.device).float()).abs()
        far = d >= ADAM_OFF * lr
        total += d.numel()
        worst = max(worst, float(d.max()))
        off += int(far.sum())
        if grads is None or not bool(far.any()):
            continue
        g = gs[key].to(a.device).abs()
        above_floor = g >= NOISE_FLOOR * g.max()
        fixed = above_floor & (g >= ADAM_EPS_REGION * ADAM_EPS)
        posed = fixed
        if noise is not None:
            low = g - noise[key].to(a.device)
            posed = posed & (low > 0) & (
                g / (g + ADAM_EPS) - low / (low + ADAM_EPS) < ADAM_OFF)
        fixed_off += int((far & fixed).sum())
        posed_off += int((far & posed).sum())
        for i in _flat_nonzero(far & above_floor & ~posed)[:8]:
            near_eps.append({"leaf": key, "abs_grad": float(g.view(-1)[i]),
                             "leaf_max_abs_grad": float(g.max()),
                             "diff_over_lr": float(d.view(-1)[i]) / lr})
    return {"off": off, "total": total, "share_off": off / total,
            "off_where_posed": posed_off if grads is not None else None,
            "off_where_posed_by_fixed_floors": (fixed_off if grads is not None
                                                else None),
            "off_near_eps": near_eps, "max_abs_diff": worst,
            "limit": f">= {ADAM_OFF} x lr off only where |g| < {NOISE_FLOOR} "
            f"x the leaf's max or < {ADAM_EPS_REGION} x eps {ADAM_EPS}"
            + ("" if noise is None else
               " or where the weight's measured one-ulp change of g can "
               f"move Adam's first step by {ADAM_OFF} x lr")
            + f"; share <= {MAX_ILL}"}


def one_ulp(params, seed: int):
    """``params`` with every float32 weight moved by one ulp, up or down
    by a seeded coin: a change far below anything a step's rule is meant
    to see."""
    import torch

    from repro_torch.optim.optimizers import _leaves, _map

    gen = torch.Generator(device=_leaves(params)[0].device).manual_seed(seed)
    return _map(lambda t: t * (1 + 2.0 ** -23 * (2 * torch.randint(
        0, 2, t.shape, generator=gen, device=t.device) - 1)), params)


def _flat_nonzero(mask) -> list:
    """Flat indices where ``mask`` holds."""
    return mask.view(-1).nonzero().view(-1).tolist()


def whole_state_hashes(state, shardings) -> dict | None:
    """sha256 of every leaf of a sharded state gathered whole (every rank
    takes part), by checkpoint key, on rank 0; None elsewhere."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.parallel.sharding import gather_tensor
    from repro_torch.runtime import state_placements

    placed = dict(_leaf_paths(state_placements(shardings, state)))
    out = {}
    for key, leaf in _leaf_paths(state):
        if key in placed:
            leaf = gather_tensor(leaf, placed[key], shardings.mesh)
        out[key] = _sha256(leaf)
    return out if dist.get_rank() == 0 else None


def _sha256(t) -> str:
    """sha256 of a tensor's bytes."""
    import hashlib

    import torch

    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()


def model_inputs(batch) -> dict:
    """``apply_model``'s inputs beside the tokens a part's batch holds
    (whisper's ``frames``)."""
    return {k: batch[k] for k in ("frames",) if k in batch}


def part_batches(spec) -> list:
    """A part's ``spec["steps"]`` packed batches, each with the part's
    seeded stub ``frames`` [rows, enc_seq, d] where its model has an
    encoder."""
    from repro_torch.data import SyntheticCorpus

    seed, cfg = spec["seed"], spec["cfg"]
    stream = train_data(seed, SyntheticCorpus(spec["corpus_vocab"], seed),
                        spec["batch"])
    batches = [next(stream) for _ in range(spec["steps"])]
    if cfg.encoder_layers:
        frames = np.random.default_rng(seed + 41).normal(
            size=(spec["batch"][0], cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
        batches = [dict(b, frames=frames) for b in batches]
    return batches


def unsharded_runs(spec, batches, dev) -> dict:
    """A part's references on one rank, at ``spec["oracle_microbatches"]``
    (a MoE model's on a mesh with data > 1: its data blocks, each counted
    alone): the float32 model's step-1
    gradient (an SGD step at SGD_LR), AdamW's params after each step and
    its losses, and the bf16 model's losses.  The gradient and the params
    are kept in host memory, so the card holds only the sharded run's
    state beside them, and the float32 reference held to itself
    (:func:`reference_noise`)."""
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw, sgd
    from repro_torch.optim.optimizers import _map
    from repro_torch.runtime import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    tcfg = TrainConfig(steps=len(batches),
                       microbatches=spec["oracle_microbatches"])
    out = {}
    for name, cfg in (("float32", spec["cfg"]), ("bfloat16",
                                                 spec["cfg_bf16"])):
        params, statics = init_params(
            cfg, torch.Generator(device=dev).manual_seed(spec["seed"]),
            device=dev)
        put = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b in batches]
        if name == "float32":
            sgd_step = make_train_step(cfg, statics, sgd(),
                                       lambda s: SGD_LR, tcfg,
                                       model_kwargs_fn=model_inputs)

            def grads_at(p):
                p1, _ = sgd_step(init_train_state(p, sgd(), tcfg), put[0])
                return _map(lambda a, b: ((a - b) / SGD_LR).cpu(), p,
                            p1["params"])

            out["grads1"] = grads_at(params)
            start = _map(lambda t: t.cpu(), params)
        opt = adamw(weight_decay=0.0)
        step = make_train_step(cfg, statics, opt, lambda s: spec["lr"], tcfg,
                               model_kwargs_fn=model_inputs)
        state = init_train_state(params, opt, tcfg)
        del params
        losses, kept = [], []
        for b in put:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            if name == "float32":
                kept.append(_map(lambda t: t.cpu(), state["params"]))
        del state
        out[name] = {"losses": losses, "params": kept}
        if name == "float32":
            out["reference_noise"] = reference_noise(
                spec, start, out["grads1"], kept[0], grads_at,
                lambda p: step(init_train_state(p, opt, tcfg), put[0])[0],
                dev)
    return out


def reference_noise(spec, start, grads1, kept1, grads_at, step1,
                    dev) -> dict:
    """The float32 reference held to itself: from ``start`` (host) moved
    by one ulp (``one_ulp``, NUDGES seeds), AdamW's step 1 (``step1``)
    held to the unmoved run's (``kept1``) by ``adam_rule``.
    ``noise_clause``: the part is not held to the fixed floors alone
    (``spec["fixed_floors"]``) and some such step fails them; then
    ``grad_noise`` holds each weight's largest change of the step-1
    gradient (``grads_at``) over the moves, and the steps are held again
    with it."""
    import torch

    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.optim.optimizers import _map

    def moved(k):
        return one_ulp(_map(lambda t: t.to(dev), start), spec["seed"] + 1 + k)

    def held(noise=None):
        rules = []
        for k in range(NUDGES):
            state = step1(moved(k))
            rules.append(adam_rule(_leaf_paths(state["params"]), kept1,
                                   grads1, spec["lr"], noise))
            del state
        return rules

    rules = held()
    out = {"noise_clause": not spec["fixed_floors"] and any(
        r["off_where_posed"] for r in rules), "grad_noise": None,
        "grad_noise_rel_max": None}
    if out["noise_clause"]:
        noise = None
        for k in range(NUDGES):
            g = dict(_leaf_paths(grads_at(moved(k))))
            change = {key: (g[key] - g1).abs()
                      for key, g1 in _leaf_paths(grads1)}
            noise = change if noise is None else {
                key: torch.maximum(noise[key], c)
                for key, c in change.items()}
        out["grad_noise"] = noise
        out["grad_noise_rel_max"] = max(
            float(noise[key].max() / g1.abs().max())
            for key, g1 in _leaf_paths(grads1) if g1.abs().max() > 0)
        rules = held(noise)
    out["self_rules"] = rules
    return out


def sharded_train_run(spec, mesh, dev) -> dict:
    """A part, (f), (h), (i) or (j) (``spec`` the part's), on one rank of
    ``mesh``: the float32 model through the sharded step, which computes
    on the ``model`` slabs (``parallel.tensor``), held to the unsharded
    run (rank 0; the params gathered leaf by leaf), then the bf16 model's
    losses; with ``spec["checkpoint"]`` the steps after the first run
    through ``Trainer``, which checkpoints the last.  Each step's
    collective bytes (``step.comm``) beside those reckoned: the params'
    bytes to be gathered and ``parallel.tensor.model_bytes``'s."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.data import shard_batch
    from repro_torch.models.transformer import (
        _leaves,
        init_params,
        init_specs,
    )
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import _leaves as _flat
    from repro_torch.parallel.sharding import gather_tensor, mesh_axis_sizes
    from repro_torch.parallel.tensor import model_bytes, slab_leaves
    from repro_torch.runtime import (
        TrainConfig,
        Trainer,
        init_train_state,
        make_train_step,
        train_shardings,
    )

    seed, rank = spec["seed"], dist.get_rank()
    batches = part_batches(spec)
    res = {"device": str(dev), "backend": str(dist.get_backend()),
           "coords": {a: mesh.get_local_rank(a) for a in ("data", "model")}}
    ref = None
    if rank == 0:  # the unsharded references, before the main path
        t0 = time.perf_counter()
        ref = unsharded_runs(spec, batches, dev)
        _sync(dev)
        res["unsharded_seconds"] = time.perf_counter() - t0
        res["unsharded_peak_memory_bytes"] = _cuda_peak(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    _reset_peak(dev)
    opt = adamw(weight_decay=0.0)
    sizes = mesh_axis_sizes(mesh)
    n_model = sizes["model"]
    rows, seq = np.shape(batches[0]["tokens"])
    my_rows = rows // (sizes["data"] * sizes.get("pod", 1))

    def rule(state, placements, want, grads, noise):
        """The params rule on rank 0, each leaf gathered in turn (every
        rank takes part in each gather)."""
        pairs = ((k, gather_tensor(t, pl, mesh)) for (k, t), (_, pl) in zip(
            _leaf_paths(state["params"]), _leaf_paths(placements)))
        if rank == 0:
            rules.append(adam_rule(pairs, want, grads, spec["lr"], noise))
        else:
            for _ in pairs:
                pass

    runs = {}
    for name, cfg in (("float32", spec["cfg"]), ("bfloat16",
                                                 spec["cfg_bf16"])):
        t0 = time.perf_counter()
        params, statics = init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        shardings = train_shardings(init_specs(cfg), params, mesh)
        tcfg = TrainConfig(steps=spec["steps"], ckpt_every=spec["steps"],
                           ckpt_dir=os.path.join(spec["out"], name))
        step = make_train_step(cfg, statics, opt, lambda s: spec["lr"], tcfg,
                               model_kwargs_fn=model_inputs,
                               shardings=shardings)
        state = init_train_state(params, opt, tcfg, shardings)
        del params
        size = {"float32": 4, "bfloat16": 2}[name]
        # the leaves the step gathers: split, and not computed on the slab
        gathered = [pl for pl, on_slab in zip(
            _flat(shardings.params), _flat(slab_leaves(
                cfg, statics, shardings.params, n_model)))
            if not on_slab and not pl.whole]
        reckoned = {
            "params": size * sum(math.prod(pl.slab_shape) for pl in
                                 _leaves(shardings.params)),
            "moments": 2 * 4 * sum(math.prod(pl.slab_shape) for pl in
                                   _leaves(shardings.moments)),
            "whole_params": size * sum(math.prod(pl.shape) for pl in
                                       _leaves(shardings.params)),
            "gathered_params": size * sum(math.prod(pl.shape)
                                          for pl in gathered),
            "gathered_leaves": len(gathered),
            # gradients reduce-scattered over data onto the moment slabs
            "data_scatter_bytes": size * sum(
                math.prod(z.slab_shape) for z in _leaves(shardings.moments)
                if sizes["data"] > 1 and "data" in z.pspec),
            **model_bytes(cfg, statics, n_model, my_rows, seq - 1,
                          rank=mesh.get_local_rank("model"))}
        rows = {"reckoned_bytes": reckoned, "comm": []}
        losses, rules = [], []
        if name == "float32":
            # step 1 by the bare step, gathered and held to the reference
            t1 = time.perf_counter()
            state, m = step(state, shard_batch(batches[0], mesh))
            losses.append(float(m["loss"]))
            _sync(dev)
            rows["step1_seconds"] = time.perf_counter() - t1
            rows["comm"].append(dict(step.comm))
            rule(state, shardings.params,
                 ref["float32"]["params"][0] if rank == 0 else None,
                 ref["grads1"] if rank == 0 else None,
                 ref["reference_noise"]["grad_noise"] if rank == 0
                 else None)
            if spec["checkpoint"]:
                # the rest through Trainer, which checkpoints the last step
                trainer = Trainer(step, state, iter(batches[1:]), tcfg,
                                  put_batch=lambda b: shard_batch(b, mesh),
                                  shardings=shardings)
                saves = timed_saves(trainer)
                hist = trainer.run()
                rows["comm"].append(dict(step.comm))
                state = trainer.state
                losses += [h["loss"] for h in hist]
                rows["trainer_step_seconds"] = [h["seconds"] for h in hist]
                rows["checkpoint_seconds"] = saves
            else:
                rows["step_seconds"] = []
                for b in batches[1:]:
                    t1 = time.perf_counter()
                    state, m = step(state, shard_batch(b, mesh))
                    losses.append(float(m["loss"]))
                    _sync(dev)
                    rows["step_seconds"].append(time.perf_counter() - t1)
                    rows["comm"].append(dict(step.comm))
            rule(state, shardings.params,
                 ref["float32"]["params"][-1] if rank == 0 else None, None,
                 None)
            if spec["checkpoint"]:
                rows["state_sha256"] = whole_state_hashes(state, shardings)
        else:
            for b in batches:
                state, m = step(state, shard_batch(b, mesh))
                losses.append(float(m["loss"]))
                rows["comm"].append(dict(step.comm))
        rows["resident_bytes"] = {
            "params": _nbytes(state["params"]),
            "moments": _nbytes(state["opt_state"]["mu"])
            + _nbytes(state["opt_state"]["nu"])}
        rows["losses"] = losses
        rows["rules"] = rules
        _sync(dev)
        rows["seconds"] = time.perf_counter() - t0
        del state
        runs[name] = rows
    res["runs"] = runs
    res["peak_memory_bytes"] = _cuda_peak(dev)
    res["peak_reserved_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                  if dev.type == "cuda" else 0)
    if rank == 0:
        res["unsharded_losses"] = {k: ref[k]["losses"]
                                   for k in ("float32", "bfloat16")}
        res["reference_noise"] = {k: v for k, v in ref[
            "reference_noise"].items() if k != "grad_noise"}
    return res


def pipeline_run(spec, dev) -> dict:
    """(g) on one rank: ``pipeline_apply`` of danube's decoder layer over a
    stage mesh of the world; rank 0 also folds the layers in order."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import (
        _apply_layer,
        _index,
        init_params,
    )
    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh((dist.get_world_size(),), ("stage",),
                     device_type=dev.type)
    cfg = spec["pipe_cfg"]
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(spec["seed"]),
        device=dev)
    stacked, st = params["body"][0], statics["body"][0]
    del params
    n, tokens = spec["pipe_micro"], spec["pipe_tokens"]
    x = torch.as_tensor(np.random.default_rng(spec["seed"] + 31).normal(
        size=(n, 1, tokens, cfg.d_model)).astype(np.float32), device=dev)
    positions = torch.arange(tokens, device=dev)

    def layer(p, h):
        return _apply_layer(p, st, cfg, h, positions, None, None, None,
                            False, kernels=False)[0]

    _reset_peak(dev)
    dist.barrier()
    t0 = time.perf_counter()
    y = pipeline_apply(layer, stacked, x, mesh, "stage")
    _sync(dev)
    res = {"seconds": time.perf_counter() - t0,
           "peak_memory_bytes": _cuda_peak(dev),
           "sha256": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()}
    if dist.get_rank() == 0:
        t0 = time.perf_counter()
        with torch.no_grad():
            fold = []
            for m in range(n):
                h = x[m]
                for i in range(cfg.n_layers):
                    h = layer(_index(stacked, i), h)
                fold.append(h)
            fold = torch.stack(fold)
        _sync(dev)
        top = float(fold.abs().max())
        res.update({"fold_seconds": time.perf_counter() - t0,
                    "max_abs_diff": float((y - fold).abs().max()),
                    "fold_max_abs": top,
                    "bit_equal": bool(torch.equal(y, fold)),
                    "finite": bool(torch.isfinite(y).all())})
    return res


def train_shard_rank(rank: int, spec: dict) -> None:
    """One rank of (f) to (l): joins the gloo group, runs them, each on
    its part's mesh of the group, writes ``rank<r>.pkl`` in
    ``spec["out"]``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, mesh_device

    if spec["prepare"] is not None:
        spec["prepare"]()
    # four ranks share the card: each part's blocks returned to it before
    # the next (empty_cache), and segments that grow in place, so one
    # part's cached blocks do not pile up under the next's larger ones
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    world = math.prod(spec["mesh"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        meshes = {shape: make_mesh(shape, ("data", "model"),
                                   device_type=spec["device_type"])
                  for shape in sorted({spec["mesh"], *(
                      part["mesh"] for part in spec["parts"].values())})}
        dev = mesh_device(meshes[spec["mesh"]])
        out = {}
        for key in ("f", "g", "h", "i", "j", "k", "l"):
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            part = spec["parts"].get(key)
            out[key] = (pipeline_run(spec, dev) if key == "g" else
                        sharded_train_run(part, meshes[part["mesh"]], dev))
            out[key]["part_seconds"] = time.perf_counter() - t0
        with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def restore_one_rank(spec, dev) -> dict:
    """(f)'s checkpoint restored in this process: a one-rank mesh's state
    through ``Trainer.maybe_restore``, each leaf hashed."""
    import torch

    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params, init_specs
    from repro_torch.optim import adamw
    from repro_torch.runtime import (
        TrainConfig,
        Trainer,
        init_train_state,
        make_train_step,
        train_shardings,
    )

    t0 = time.perf_counter()
    cfg = spec["cfg"]
    mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
    params, statics = init_params(cfg, torch.Generator(device=dev).manual_seed(
        spec["seed"]), device=dev)
    shardings = train_shardings(init_specs(cfg), params, mesh)
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig(steps=spec["steps"],
                       ckpt_dir=os.path.join(spec["out"], "float32"))
    trainer = Trainer(make_train_step(cfg, statics, opt, lambda s: 0.0, tcfg,
                                      shardings=shardings),
                      init_train_state(params, opt, tcfg, shardings),
                      iter(()), tcfg, shardings=shardings)
    del params
    at = trainer.maybe_restore()
    hashes = {k: _sha256(v) for k, v in _leaf_paths(trainer.state)}
    return {"restored_step": at, "sha256": hashes,
            "seconds": time.perf_counter() - t0}


def jamba_shard_config():
    """(h)'s model: jamba-1.5-large at smoke width (attention, Mamba and
    MoE layers; a full-width MoE layer and its moments do not fit a
    quarter of the card)."""
    from repro_torch.configs import get_smoke_config

    return get_smoke_config("jamba_1_5_large_398b")


def deepseek_shard_config():
    """(i)'s model: DeepSeek-V2-236B at full width (the phase keeps its
    first layer, MLA and the dense SwiGLU MLP of d_ff 12288; vocabulary
    102,400)."""
    from repro_torch.configs import get_config

    return get_config("deepseek_v2_236b")


def mamba2_shard_config():
    """(j)'s model: mamba2-780m at full width (48 heads of 64, tied
    vocabulary 50,280 padded to 50,432)."""
    from repro_torch.configs import get_config

    return get_config("mamba2_780m")


def phi3_shard_config():
    """(k)'s model: phi3-medium-14B at full width (40 query heads padded
    to 48 over 10 key heads, ungrouped; d_ff 17,920; vocabulary
    100,352)."""
    from repro_torch.configs import get_config

    return get_config("phi3_medium_14b")


def whisper_shard_config():
    """(l)'s model: whisper-small whole (12 encoder and 12 decoder layers,
    12 heads padded to 16 over 12 key heads, 1500 frames)."""
    from repro_torch.configs import get_config

    return get_config("whisper_small")


def with_dtype(cfg, dtype: str):
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)


def train_shard_phase(seed: int, dev) -> dict:
    """The ``train_shard`` phase, (f), (g) and (h), and its JSON line; (e)
    runs in the train phase's drill process."""
    import pickle

    import torch
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    full = train_config()
    world = math.prod(SHARD_TRAIN_MESH)
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cfg_f = cut_layers(full, SHARD_TRAIN_LAYERS, "float32")
        cfg_h = with_dtype(jamba_shard_config(), "float32")
        ds, mamba = deepseek_shard_config(), mamba2_shard_config()
        cfg_i = with_dtype(dataclasses.replace(
            ds, n_layers=1, layer_types=ds.layer_types[:1]), "float32")
        cfg_j = cut_layers(mamba, MAMBA_SHARD_LAYERS, "float32")
        phi3, whisper = phi3_shard_config(), whisper_shard_config()
        cfg_k = cut_layers(phi3, PHI3_SHARD_LAYERS, "float32")
        cfg_l = with_dtype(whisper, "float32")
        parts = {
            "f": {"seed": seed, "cfg": cfg_f, "batch": SHARD_TRAIN_BATCH,
                  "cfg_bf16": cut_layers(full, SHARD_TRAIN_LAYERS,
                                         "bfloat16"),
                  "corpus_vocab": TRAIN_CORPUS_VOCAB, "checkpoint": True,
                  "fixed_floors": True},
            "h": {"seed": seed, "cfg": cfg_h, "batch": JAMBA_SHARD_BATCH,
                  "cfg_bf16": with_dtype(cfg_h, "bfloat16"),
                  "corpus_vocab": min(TRAIN_CORPUS_VOCAB, cfg_h.vocab),
                  "checkpoint": True, "fixed_floors": True}}
        for key, cfg, batch, mesh in (
                ("i", cfg_i, DEEPSEEK_SHARD_BATCH, SHARD_TRAIN_MESH),
                ("j", cfg_j, MAMBA_SHARD_BATCH, SHARD_TRAIN_MESH),
                ("k", cfg_k, PHI3_SHARD_BATCH, WIDE_SHARD_MESH),
                ("l", cfg_l, WHISPER_SHARD_BATCH, WIDE_SHARD_MESH)):
            parts[key] = {"seed": seed, "cfg": cfg, "batch": batch,
                          "cfg_bf16": with_dtype(cfg, "bfloat16"),
                          "corpus_vocab": min(TRAIN_CORPUS_VOCAB, cfg.vocab),
                          "checkpoint": False, "fixed_floors": False,
                          "mesh": mesh}
        for key, part in parts.items():
            part.setdefault("mesh", SHARD_TRAIN_MESH)
            # the unsharded run whose function the sharded step computes:
            # MoE counts capacity on each data block's rows alone
            part.update(steps=SHARD_TRAIN_STEPS, lr=TRAIN_LR,
                        out=os.path.join(tmp, key),
                        oracle_microbatches=part["mesh"][0]
                        if part["cfg"].moe is not None else 1)
        spec = {"mesh": SHARD_TRAIN_MESH, "device_type": dev.type,
                "store": os.path.join(tmp, "store"), "out": tmp,
                "prepare": SHARD_PREPARE, "seed": seed, "parts": parts,
                "pipe_cfg": cut_layers(full, PIPE_LAYERS, "float32"),
                "pipe_micro": PIPE_MICRO, "pipe_tokens": PIPE_TOKENS}
        if PIPE_STAGES != world:
            raise ValueError("the pipeline's stages are the mesh's ranks")
        t0 = time.perf_counter()
        mp.start_processes(train_shard_rank, args=(spec,), nprocs=world,
                           join=True, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        restored = {}
        for key, part in parts.items():
            if not part["checkpoint"]:
                continue
            _reset_peak(dev)
            restored[key] = restore_one_rank(part, dev)
            restored[key]["peak_memory_bytes"] = _cuda_peak(dev)
    reports = {key: shard_train_report(part, [rk[key] for rk in ranks],
                                       restored.get(key), world)
               for key, part in parts.items()}
    f, h, i, j, k, l = (reports[key] for key in "fhijkl")
    f["layers"] = f"{SHARD_TRAIN_LAYERS} of {full.n_layers}"
    h["width"] = "smoke"
    i["layers"] = f"1 of {ds.n_layers}"
    j["layers"] = f"{MAMBA_SHARD_LAYERS} of {mamba.n_layers}"
    k["layers"] = f"{PHI3_SHARD_LAYERS} of {phi3.n_layers}"
    l["layers"] = f"{whisper.n_layers} of {whisper.n_layers} and the " \
        f"encoder's {whisper.encoder_layers}"
    g0 = ranks[0]["g"]
    pcfg = spec["pipe_cfg"]
    g = {"layer": f"{pcfg.name} decoder layer, float32, kernels=False",
         "d_model": pcfg.d_model,
         "layers": PIPE_LAYERS, "stages": PIPE_STAGES,
         "layers_per_stage": PIPE_LAYERS // PIPE_STAGES,
         "microbatches": PIPE_MICRO, "microbatch": [1, PIPE_TOKENS],
         "limit": f"max|pipe - fold| <= {PIPE_REL} x max|fold|",
         "max_abs_diff": g0["max_abs_diff"], "fold_max_abs": g0["fold_max_abs"],
         "bit_equal": g0["bit_equal"], "finite": g0["finite"],
         "ranks_equal": len({rk["g"]["sha256"] for rk in ranks}) == 1,
         "seconds_per_rank": [rk["g"]["seconds"] for rk in ranks],
         "fold_seconds": g0["fold_seconds"],
         "peak_memory_bytes_per_rank": [rk["g"]["peak_memory_bytes"]
                                        for rk in ranks]}
    emit("train_shard", seconds=time.perf_counter() - t_phase,
         spawn_seconds=spawn_s, part_f=f, part_g=g, part_h=h, part_i=i,
         part_j=j, part_k=k, part_l=l)
    for part in (f, h, i, j, k, l):
        train_shard_checks(part)
    check(g["finite"] and g["ranks_equal"]
          and g["max_abs_diff"] <= PIPE_REL * g["fold_max_abs"],
          f"pipeline_apply vs the sequential fold: {g['max_abs_diff']} "
          f"(largest {g['fold_max_abs']}), ranks equal {g['ranks_equal']}")
    # (f)'s first step on rank 0, which the dryrun phase predicts
    return {"f_cfg": cfg_f, "f_comm": f["comm_per_step"][0][0]}


def shard_train_report(part, ranks, restored, world) -> dict:
    """A part's report from every rank's ``sharded_train_run``
    (``restored``: the one-rank restore of its checkpoint, or None)."""
    r0 = ranks[0]
    f32, bf16 = r0["runs"]["float32"], r0["runs"]["bfloat16"]
    ref = r0["unsharded_losses"]

    def rels(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    cfg = part["cfg"]
    return {
        "model": cfg.name, "d_model": cfg.d_model, "vocab": cfg.vocab,
        "layer_types": [list(t) for t in cfg.layer_types],
        "sparse": dataclasses.asdict(cfg.sparse) if cfg.sparse else None,
        "mesh": list(part["mesh"]), "backend": r0["backend"],
        "transport": f"gloo: {world} ranks on "
        f"{len({rk['device'] for rk in ranks})} card(s), CUDA tensors "
        f"staged through host memory",
        "compute": "tensor parallel over model (parallel.tensor): "
        "attention query heads (the key heads they read re-laid out where "
        "they do not split with them), MLA and SSM heads (the SSM's "
        "columns re-laid out), MLP ff or tiles, experts, the vocabulary on "
        "their slabs, the residual stream split along the sequence; what "
        "does not divide gathered",
        "batch": list(part["batch"]), "steps": part["steps"],
        "oracle_microbatches": part["oracle_microbatches"],
        "lr": part["lr"], "loss_limit": f"rel <= {SHARD_TRAIN_REL}",
        "losses_float32": f32["losses"],
        "losses_unsharded_float32": ref["float32"],
        "loss_rel_float32": rels(f32["losses"], ref["float32"]),
        "ranks_losses_equal": all(
            rk["runs"][n]["losses"] == r0["runs"][n]["losses"]
            for rk in ranks for n in ("float32", "bfloat16")),
        "params_rule": f32["rules"],
        "fixed_floors": part["fixed_floors"],
        "reference_noise": r0["reference_noise"],
        "resident_bytes": [rk["runs"]["float32"]["resident_bytes"]
                           for rk in ranks],
        "reckoned_bytes": [rk["runs"]["float32"]["reckoned_bytes"]
                           for rk in ranks],
        "comm_per_step": [rk["runs"]["float32"]["comm"] for rk in ranks],
        "comm_per_step_bf16": [rk["runs"]["bfloat16"]["comm"]
                               for rk in ranks],
        "reckoned_bytes_bf16": [rk["runs"]["bfloat16"]["reckoned_bytes"]
                                for rk in ranks],
        "coords": [rk["coords"] for rk in ranks],
        "step1_seconds": [rk["runs"]["float32"]["step1_seconds"]
                          for rk in ranks],
        "later_step_seconds": [rk["runs"]["float32"].get(
            "trainer_step_seconds", rk["runs"]["float32"].get("step_seconds"))
            for rk in ranks],
        "checkpoint_seconds": f32.get("checkpoint_seconds"),
        "restore": None if restored is None else {
            "restored_step": restored["restored_step"],
            "bit_equal": restored["sha256"] == f32["state_sha256"],
            "leaves": len(restored["sha256"]),
            "seconds": restored["seconds"],
            "peak_memory_bytes": restored["peak_memory_bytes"]},
        "bf16": {
            "limit": f"rel <= {SHARD_TRAIN_BF16_REL} of the unsharded bf16 "
            f"run",
            "losses": bf16["losses"], "losses_unsharded": ref["bfloat16"],
            "rel_vs_unsharded_bf16": rels(bf16["losses"], ref["bfloat16"]),
            "unsharded_bf16_rel_vs_float32": rels(ref["bfloat16"],
                                                  ref["float32"])},
        "unsharded_seconds_rank0": r0["unsharded_seconds"],
        "unsharded_peak_memory_bytes_rank0": r0[
            "unsharded_peak_memory_bytes"],
        "seconds_per_rank": [rk["part_seconds"] for rk in ranks],
        "peak_memory_bytes_per_rank": [rk["peak_memory_bytes"]
                                       for rk in ranks],
        "peak_reserved_bytes_per_rank": [rk["peak_reserved_bytes"]
                                         for rk in ranks]}


def train_shard_checks(f) -> None:
    """The gates of a part, (f), (h), (i) or (j), after the phase's line
    is printed."""
    check(f["ranks_losses_equal"], "the mesh's ranks report different losses")
    check(all(np.isfinite(f["losses_float32"]))
          and max(f["loss_rel_float32"]) <= SHARD_TRAIN_REL,
          f"sharded float32 losses {f['losses_float32']} vs unsharded "
          f"{f['losses_unsharded_float32']}")
    step1, last = f["params_rule"]
    check(step1["off_where_posed"] == 0 and step1["share_off"] <= MAX_ILL,
          f"sharded params after step 1 off the unsharded step: {step1}")
    ref = f["reference_noise"]
    check(not (ref["noise_clause"] and f["fixed_floors"]),
          "a part held to the fixed floors took the measured-noise clause")
    if ref["noise_clause"]:  # the reference fails the fixed floors itself
        check(all(r["off_where_posed"] == 0 for r in ref["self_rules"]),
              f"the reference's own one-ulp steps off where posed: {ref}")
        worst = max(r["off"] for r in ref["self_rules"])
        check(step1["off"] <= worst,
              f"the sharded step moves {step1['off']} weights off, the "
              f"reference's own one-ulp steps at most {worst}")
    check(last["share_off"] <= MAX_ILL,
          f"sharded params after the last step off the unsharded run: {last}")
    for have, want in zip(f["resident_bytes"], f["reckoned_bytes"]):
        check(have["params"] == want["params"]
              and have["moments"] == want["moments"],
              f"a rank's resident bytes {have} != reckoned {want}")
    for comm, want in ((f["comm_per_step"], f["reckoned_bytes"]),
                       (f["comm_per_step_bf16"], f["reckoned_bytes_bf16"])):
        for steps, reck in zip(comm, want):
            check(reck["gathered_params"] == 0,
                  f"a leaf that divides over model is gathered: {reck}")
            for key, want_key in (("param_gather_bytes", "gathered_params"),
                                  ("model_reduce_bytes",
                                   "model_reduce_bytes"),
                                  ("model_scatter_bytes",
                                   "model_scatter_bytes"),
                                  ("model_seq_gather_bytes",
                                   "model_seq_gather_bytes"),
                                  ("model_relayout_bytes",
                                   "model_relayout_bytes"),
                                  ("data_scatter_bytes",
                                   "data_scatter_bytes")):
                check(all(c[key] == reck[want_key] for c in steps),
                      f"{key} per step {[c[key] for c in steps]} != "
                      f"reckoned {reck[want_key]}")
    check(all(c["model_scatter_bytes"] > 0 and c["model_seq_gather_bytes"]
              > 0 for steps in f["comm_per_step"] for c in steps),
          "no activation was reduce-scattered and gathered over model: the "
          "stream not split along the sequence")
    if f["mesh"][0] > 1:
        check(all(c["data_scatter_bytes"] > 0 for steps in f["comm_per_step"]
                  for c in steps),
              "no gradient was reduce-scattered over data")
    if f["restore"] is not None:
        check(f["restore"]["restored_step"] == SHARD_TRAIN_STEPS
              and f["restore"]["bit_equal"],
              f"the mesh's checkpoint restored in one rank: {f['restore']}")
    check(all(np.isfinite(f["bf16"]["losses"]))
          and max(f["bf16"]["rel_vs_unsharded_bf16"]) <= SHARD_TRAIN_BF16_REL,
          f"sharded bf16 losses vs the unsharded bf16 run: {f['bf16']}")


def dryrun_train_predict(cfg, batch, tokens_dtype: str) -> dict:
    """(a)'s prediction: the train phase's unsharded step (AdamW, no
    weight decay, ``TRAIN_LR``, the state donated) over fake tensors on
    the host, counted by ``launch.op_stats``; the state and the batch are
    its inputs.  Then
    the step's loss and gradients alone (``step.loss_and_grads``, the
    params and the batch its inputs) with remat and without: their peaks
    (``grads_peak_bytes``, by remat)."""
    import torch

    from repro_torch.launch.dryrun import _static_tensors
    from repro_torch.launch.op_stats import OpStats, fake_mode
    from repro_torch.models.transformer import init_params, init_statics
    from repro_torch.optim import adamw
    from repro_torch.runtime import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    statics = init_statics(cfg, "cpu")
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig()
    step = make_train_step(cfg, statics, opt, lambda s: TRAIN_LR, tcfg,
                           donate=True)
    mode = fake_mode()
    with mode:
        params, _ = init_params(cfg, torch.Generator(), device="cpu")
        state = init_train_state(params, opt, tcfg)
        del params
        rows, seq = batch
        toks = torch.zeros((rows, seq + 1), dtype=getattr(torch,
                                                          tokens_dtype))
        t0 = time.perf_counter()
        with OpStats() as st:
            st.add_inputs(state, {"tokens": toks},
                          _static_tensors(statics))
            state, _ = step(state, {"tokens": toks})
        trace_s = time.perf_counter() - t0
        grads_peak = {}
        for remat in (True, False):
            rs = dict(statics, cfg=dataclasses.replace(cfg, remat=remat))
            alone = make_train_step(cfg, rs, opt, lambda s: TRAIN_LR, tcfg)
            with OpStats() as g:
                g.add_inputs(state["params"], {"tokens": toks},
                             _static_tensors(rs))
                alone.loss_and_grads(state["params"], {"tokens": toks})
            grads_peak[remat] = g.peak_bytes
    return {"flops": st.flops, "bytes": st.bytes,
            "peak_bytes": st.peak_bytes, "trace_s": trace_s,
            "grads_peak_bytes": grads_peak}


def dryrun_plan(spec: dict, which: str, out: str) -> None:
    """One planning process of the dryrun phase (a fake process group of
    its own): ``which`` is ``"abc"`` (the predictions of (a), (b) and
    (c)) or a cell of ``DRYRUN_CELLS`` by index (d); writes a pickle."""
    import pickle

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    res = {}
    if which == "abc":
        res["a"] = dryrun_train_predict(spec["train_cfg"], spec["batch"],
                                        spec["tokens_dtype"])
        mesh = make_fake_mesh(spec["mesh"], ("data", "model"))
        rows, seq = spec["f_batch"]
        built = build_step("h2o_danube_1_8b", ShapeSpec("part_f", "train",
                                                        seq, rows),
                           mesh, cfg=spec["f_cfg"],
                           opt=adamw(weight_decay=0.0))
        stats, secs = dryrun.measure(built, mesh)
        res["b"] = {"by_kind": dict(stats.collective_bytes_by_kind),
                    "by_dim": dict(stats.collective_bytes_by_dim),
                    "step_comm": dict(built.fn.comm), "trace_s": secs}
        built = build_step("h2o_danube_1_8b", ShapeSpec(
            "part_c", "decode", spec["max_seq"], spec["serve_batch"]),
            mesh, cfg=spec["serve_cfg"])
        stats, secs = dryrun.measure(built, mesh)
        res["c"] = {"by_kind": dict(stats.collective_bytes_by_kind),
                    "peak_bytes": stats.peak_bytes,
                    "flops": stats.flops, "trace_s": secs}
    else:
        arch, shape = spec["cells"][int(which)]
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, False, spec["out"], force=True)
        rec["seconds"] = time.perf_counter() - t0
        res["d"] = rec
    with open(out, "wb") as f:
        pickle.dump(res, f)


def dryrun_serve_rank(rank: int, spec: dict) -> None:
    """One rank of (c): joins the gloo group, holds its slabs of the
    float32 danube (4 layers, full width) and of the bf16 cache (as the
    production steps keep it), runs the
    placed prefill (flash launches counted, each call recorded) and
    ``DRYRUN_DECODE`` placed decode steps, then a measured placed decode
    step on the plain routes (its peak above what was allocated before
    it, and its collectives, by ``launch.op_stats``); rank 0 first serves
    the whole batch unsharded on the config's own layouts, then on the
    tile route decoding those tokens, as the placed steps decode them.
    Writes ``serve<r>.pkl``."""
    import datetime

    import torch.distributed as dist

    if spec["prepare"] is not None:
        spec["prepare"]()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    world = math.prod(spec["mesh"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        dryrun_serve_run(rank, spec)
    except BaseException:
        # the spawn reports the first rank it sees fail, often a peer
        # whose connection this rank's exit closed: keep every cause
        import traceback

        with open(os.path.join(spec["out"], f"serve{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def placed_serve(cfg, statics, params, cache, prompts, steps: int, rows,
                 shardings, dev, comms: list | None = None,
                 forced: list | None = None,
                 logits: list | None = None) -> tuple:
    """A placed (``shardings``) or unsharded prefill of ``prompts[rows]``
    and ``steps`` greedy decode steps: (tokens a step as numpy, the
    cache); ``comms`` gets each placed step's ``step.comm``.  ``forced``
    (a reference run's tokens a step, every row): each decode step reads
    the reference's token in place of its own (teacher forcing), so two
    runs are compared at the same inputs; ``logits`` gets each decode
    step's float32 logits (numpy)."""
    import torch

    from repro_torch.runtime.serve import (
        ServeConfig,
        decode_logits,
        make_prefill_step,
    )

    p = prompts.shape[1]
    step = make_prefill_step(cfg, statics, ServeConfig(
        cache_dtype="bfloat16"), shardings=shardings)
    tok, cache = step(params, cache, prompts[rows])
    toks = [tok]
    if comms is not None:
        comms.append(dict(step.comm))
    for i in range(steps):
        if forced is not None:
            tok = torch.as_tensor(forced[i][rows], device=dev)
        comm: dict = {}
        lg, cache = decode_logits(
            statics, params, cache, tok, torch.tensor(p + i, device=dev),
            shardings, comm=comm)
        tok = lg.argmax(dim=-1)
        toks.append(tok)
        if comms is not None:
            comms.append(comm)
        if logits is not None:
            logits.append(lg.cpu().numpy())
    return [x.cpu().numpy() for x in toks], cache


def forced_agreement(want: list, got: list, want_tokens: list,
                     got_tokens: list) -> dict:
    """Two teacher-forced runs' decode logits (``want`` the reference's,
    same rows): the largest difference relative to each row's largest
    logit, and the argmaxes that differ (``flips``), each with the
    reference's top-2 gap on the same scale.  A flip is explained by the
    difference only where that gap is at most twice it (``unexplained``
    counts the others)."""
    rel, flips = 0.0, []
    for i, (w, g) in enumerate(zip(want, got)):
        scale = np.abs(w).max(axis=-1)
        d = np.abs(g - w).max(axis=-1) / scale
        rel = max(rel, float(d.max()))
        top = np.sort(w, axis=-1)[:, -2:]
        gap = (top[:, 1] - top[:, 0]) / scale
        for r in np.nonzero(want_tokens[i + 1] != got_tokens[i + 1])[0]:
            flips.append({"step": i, "row": int(r), "gap": float(gap[r]),
                          "diff": float(d[r])})
    return {"logits_rel": rel, "flips": flips,
            "prefill_tokens_equal": bool(np.array_equal(want_tokens[0],
                                                        got_tokens[0])),
            "unexplained": sum(f["gap"] > 2 * f["diff"] for f in flips)}


def placed_reckoning(cfg, statics, shardings, mesh, rows: int, prompt: int,
                     decodes: list, max_seq: int, prefill: bool = True
                     ) -> list:
    """The bytes of a prefill of ``prompt`` tokens (with ``prefill``) and
    of a decode at each position of ``decodes``, as
    ``parallel.tensor.serve_bytes`` reckons them for this rank of
    ``mesh`` (a bf16 cache of ``max_seq`` positions)."""
    import torch

    from repro_torch.parallel.sharding import mesh_axis_sizes
    from repro_torch.parallel.tensor import (
        data_shards,
        serve_bytes,
        serve_pods,
        serve_rows,
    )

    n = mesh_axis_sizes(mesh).get("model", 1)
    kw = dict(rank=mesh.get_local_rank("model") if n > 1 else 0,
              blocks=serve_rows(mesh, shardings.batch)[1],
              placements=shardings.params,
              pods=serve_pods(mesh, shardings.batch),
              cache_placements=shardings.cache, dp=data_shards(mesh)[1])
    out = [serve_bytes(cfg, statics, n, rows, prompt, "prefill", max_seq,
                       torch.bfloat16, **kw)] if prefill else []
    return out + [serve_bytes(cfg, statics, n, rows, prompt, "decode",
                              max_seq, torch.bfloat16, pos=pos, **kw)
                  for pos in decodes]


def slab_gathers(fn, params, slab_flags) -> tuple:
    """(result of ``fn()``, how many of the param leaves that
    ``slab_flags`` marks (``parallel.tensor.slab_leaves``) ``fn`` gathered
    through ``runtime.serve``'s ``gather_tensor``)."""
    from repro_torch.models.transformer import _leaves
    from repro_torch.parallel.sharding import _map
    from repro_torch.runtime import serve as rs

    seen = []
    real = rs.gather_tensor

    def spy(t, pl, mesh, axes=None):
        seen.append(t.untyped_storage().data_ptr())
        return real(t, pl, mesh, axes)

    rs.gather_tensor = spy
    try:
        out = fn()
    finally:
        rs.gather_tensor = real
    marked = {ptr for ptr in _leaves(_map(
        lambda t, on: t.untyped_storage().data_ptr() if on else None,
        params, slab_flags)) if ptr is not None}
    return out, sum(ptr in marked for ptr in seen)


def dryrun_serve_run(rank: int, spec: dict) -> None:
    """:func:`dryrun_serve_rank`'s work, in the rank's group: (c), then
    (e) (:func:`wide_serve_run`)."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.launch.dryrun import _static_tensors
    from repro_torch.launch.mesh import make_mesh, mesh_device
    from repro_torch.launch.op_stats import OpStats
    from repro_torch.models.transformer import (
        _leaves,
        init_cache,
        init_params,
        init_specs,
    )
    from repro_torch.parallel.sharding import mesh_axis_sizes
    from repro_torch.parallel.tensor import serve_rows, slab_leaves
    from repro_torch.runtime.serve import (
        decode_logits,
        place_serving_state,
        serve_shardings,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(spec["mesh"], ("data", "model"),
                     device_type=spec["device_type"])
    dev = mesh_device(mesh)
    cfg = spec["serve_cfg"]
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(spec["seed"]),
        device=dev)
    served = tile_route(statics)  # the sparse tiles on the spmm kernel
    b, p, t = spec["serve_batch"], spec["prompt"], spec["max_seq"]
    prompts = torch.as_tensor(np.random.default_rng(spec["seed"] + 41)
                              .integers(1, cfg.vocab, (b, p)), device=dev)
    out = {"device": str(dev)}
    steps = spec["steps"]

    with torch.no_grad():
        # the reference run: the config's own layouts (dense per-pattern
        # products), unsharded, greedy; the tile route unsharded and the
        # placed steps decode its tokens (teacher forcing), so their
        # logits compare at the same inputs
        ref = [None]
        if rank == 0:
            own: list = []
            cache = init_cache(statics, b, t, torch.bfloat16, device=dev)
            ref[0], _ = placed_serve(cfg, statics, params, cache, prompts,
                                     steps, slice(None), None, dev,
                                     logits=own)
            out["own_layout_tokens"], out["own_layout_logits"] = ref[0], own
            out["unsharded_logits"] = []
            cache = init_cache(statics, b, t, torch.bfloat16, device=dev)
            out["unsharded_tokens"], _ = placed_serve(
                cfg, served, params, cache, prompts, steps, slice(None),
                None, dev, forced=ref[0],
                logits=out["unsharded_logits"])
            del cache
        dist.broadcast_object_list(ref, src=0)
        cache = init_cache(statics, b, t, torch.bfloat16, device=dev)
        sh = serve_shardings(init_specs(cfg), params, cache, mesh)
        out["reckoned_bytes"] = sum(
            math.prod(pl.slab_shape) * x.element_size()
            for x, pl in zip([*_leaves(params), *_leaves(cache)],
                             [*_leaves(sh.params), *_leaves(sh.cache)]))
        p_slab, c_slab = place_serving_state(params, cache, sh)
        del params, cache
        gc.collect()
        r, n = serve_rows(mesh, b)
        rows = slice(r * b // n, (r + 1) * b // n)
        n_model = mesh_axis_sizes(mesh)["model"]
        out["reckoned_comm"] = placed_reckoning(
            cfg, statics, sh, mesh, b // n, p, range(p, p + steps), t)
        tfa.flash_attention_cuda.launches = 0
        tk.pattern_spmm_cuda.launches = 0
        comms: list = []
        out["logits"] = []
        (((toks, c_slab), spmm_rows), calls), out["slab_gathered"] = \
            slab_gathers(lambda: recorded_flash_calls(
                lambda: recorded_spmm_calls(lambda: placed_serve(
                    cfg, served, p_slab, c_slab, prompts, steps, rows, sh,
                    dev, comms, forced=ref[0],
                    logits=out["logits"]))), p_slab,
                slab_leaves(cfg, statics, sh.params, n_model))
        out["flash_launches"] = tfa.flash_attention_cuda.launches
        out["spmm_launches"] = tk.pattern_spmm_cuda.launches
        out["spmm_rows"] = spmm_rows
        out["comm"] = comms
        out["rows"] = (rows.start, rows.stop)
        out["tokens"] = toks
        out["flash_rows"] = [flash_row(dict(
            case=f"placed prefill layer {i}", dtype=cfg.compute_dtype,
            **c), y) for i, (c, y) in enumerate(calls)]
        del calls
        out["resident_bytes"] = _nbytes(p_slab) + _nbytes(c_slab)
        # the measured step: a placed decode at the cache's last
        # position on the plain routes, as the dry run plans it (the
        # config's layouts, as the plan's)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        tok = torch.zeros(b // n, dtype=torch.int32, device=dev)
        pos = torch.tensor(t - 1, dtype=torch.int32, device=dev)
        _reset_peak(dev)
        before = (torch.cuda.memory_allocated(dev)
                  if dev.type == "cuda" else 0)
        comm: dict = {}
        with OpStats().name_groups(mesh) as st:
            st.add_inputs(p_slab, c_slab, tok, pos,
                          _static_tensors(statics))
            inputs = int(st.bytes)
            decode_logits(statics, p_slab, c_slab, tok, pos, sh,
                          kernels=False, comm=comm)
        _sync(dev)
        out["measured_peak_bytes"] = (
            _cuda_peak(dev) - before + inputs
            if dev.type == "cuda" else st.peak_bytes)
        out["input_bytes"] = inputs
        out["op_stats_peak_bytes"] = st.peak_bytes
        out["by_kind"] = dict(st.collective_bytes_by_kind)
        out["measured_comm"] = comm
        out["measured_reckoned"] = placed_reckoning(
            cfg, statics, sh, mesh, b // n, p, [t - 1], t, False)[0]
        out["flops"] = st.flops
        del p_slab, c_slab
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["e"] = wide_serve_run(rank, spec)
    with open(os.path.join(spec["out"], f"serve{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def wide_serve_config():
    """(e)'s model: qwen2.5-32B at full width, its first
    ``WIDE_SERVE_LAYERS`` layers, float32."""
    from repro_torch.configs import qwen2_5_32b

    return cut_layers(qwen2_5_32b.config(), WIDE_SERVE_LAYERS, "float32")


def wide_serve_run(rank: int, spec: dict) -> dict:
    """(e) on one rank of a ``WIDE_SHARD_MESH`` of the phase's ranks:
    ``WIDE_SERVE_BATCH`` seeded prompts of ``WIDE_SERVE_PROMPT`` tokens
    and ``WIDE_SERVE_DECODE`` greedy decodes, placed, on the gather and
    the flash decode routes (rank 0 first serves them unsharded); each
    route's tokens, every step's ``step.comm`` beside the reckoning, the
    slab-marked params gathered, the flash calls of the prefill (each
    held to its plain version) and the resident bytes."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch.mesh import make_mesh, mesh_device
    from repro_torch.models.transformer import (
        _leaves,
        init_cache,
        init_params,
        init_specs,
        init_statics,
    )
    from repro_torch.parallel.sharding import mesh_axis_sizes, shard_tree
    from repro_torch.parallel.tensor import slab_leaves
    from repro_torch.runtime.serve import serve_shardings

    mesh = make_mesh(WIDE_SHARD_MESH, ("data", "model"),
                     device_type=spec["device_type"])
    dev = mesh_device(mesh)
    w = spec["wide"]
    cfg, b, p, t, steps = (w["cfg"], w["batch"], w["prompt"], w["max_seq"],
                           w["steps"])
    out = {}
    with torch.no_grad():
        params, statics = init_params(
            cfg, torch.Generator(device=dev).manual_seed(spec["seed"] + 7),
            device=dev)
        prompts = torch.as_tensor(np.random.default_rng(spec["seed"] + 43)
                                  .integers(1, cfg.vocab, (b, p)),
                                  device=dev)
        if rank == 0:
            cache = init_cache(statics, b, t, torch.bfloat16, device=dev)
            out["unsharded_tokens"], _ = placed_serve(
                cfg, statics, params, cache, prompts, steps, slice(None),
                None, dev)
            del cache
        cache = init_cache(statics, b, t, torch.bfloat16, device=dev)
        sh = serve_shardings(init_specs(cfg), params, cache, mesh)
        out["reckoned_bytes"] = sum(
            math.prod(pl.slab_shape) * x.element_size()
            for x, pl in zip([*_leaves(params), *_leaves(cache)],
                             [*_leaves(sh.params), *_leaves(sh.cache)]))
        p_slab = shard_tree(params, sh.params)
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        flags = slab_leaves(cfg, statics, sh.params,
                            mesh_axis_sizes(mesh)["model"])
        out["routes"] = {}
        for strategy in ("gather", "flash"):
            rcfg = dataclasses.replace(cfg, decode_strategy=strategy)
            rst = init_statics(rcfg, dev)
            c_slab = shard_tree(cache, sh.cache)
            tfa.flash_attention_cuda.launches = 0
            comms: list = []
            ((toks, c_slab), calls), gathered = slab_gathers(
                lambda: recorded_flash_calls(lambda: placed_serve(
                    rcfg, rst, p_slab, c_slab, prompts, steps, slice(None),
                    sh, dev, comms)), p_slab, flags)
            out["routes"][strategy] = {
                "tokens": toks, "comm": comms,
                "reckoned_comm": placed_reckoning(
                    rcfg, rst, sh, mesh, b, p, range(p, p + steps), t),
                "slab_gathered": gathered,
                "flash_launches": tfa.flash_attention_cuda.launches,
                "flash_rows": [flash_row(dict(
                    case=f"wide placed prefill layer {i}",
                    dtype=cfg.compute_dtype, **c), y)
                    for i, (c, y) in enumerate(calls)],
                "resident_bytes": _nbytes(p_slab) + _nbytes(c_slab)}
            del calls, c_slab
        del p_slab, cache
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def dryrun_train_measure(seed: int, dev, pred: dict) -> dict:
    """(a) measured: one donated step of the train phase's danube on the
    card under ``launch.op_stats`` (the same counter as the prediction),
    its time, and its peak above what was allocated before it plus its
    inputs (what the prediction counts); then the step's loss and
    gradients alone with remat and without, each one's peak so counted
    and its time."""
    import torch

    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.dryrun import _static_tensors
    from repro_torch.launch.op_stats import OpStats
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )
    from repro_torch.runtime.train import _to_device

    gc.collect()
    torch.cuda.empty_cache()
    cfg = train_config()
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig()
    step = make_train_step(cfg, statics, opt, lambda s: TRAIN_LR, tcfg,
                           donate=True)
    state = init_train_state(params, opt, tcfg)
    del params
    batch = _to_device(next(train_data(seed, SyntheticCorpus(
        TRAIN_CORPUS_VOCAB, seed), TRAIN_BATCH)), dev)
    _sync(dev)
    gc.collect()
    torch.cuda.empty_cache()
    _reset_peak(dev)
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    with OpStats() as st:
        st.add_inputs(state, batch, _static_tensors(statics))
        inputs = int(st.bytes)
        state, _ = step(state, batch)
        _sync(dev)
    measured = (_cuda_peak(dev) - before + inputs
                if dev.type == "cuda" else st.peak_bytes)
    # the step's time without the counter's per-op work
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    _sync(dev)
    seconds = time.perf_counter() - t0
    grads = {}
    for remat in (True, False):
        rs = dict(statics, cfg=dataclasses.replace(cfg, remat=remat))
        alone = make_train_step(cfg, rs, opt, lambda s: TRAIN_LR, tcfg)
        gc.collect()
        torch.cuda.empty_cache()
        _reset_peak(dev)
        before = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                  else 0)
        with OpStats() as g:
            g.add_inputs(state["params"], batch, _static_tensors(rs))
            inputs_g = int(g.bytes)
            out = alone.loss_and_grads(state["params"], batch)
            _sync(dev)
        peak = (_cuda_peak(dev) - before + inputs_g if dev.type == "cuda"
                else g.peak_bytes)
        del out
        # its time without the counter's per-op work
        t0 = time.perf_counter()
        out = alone.loss_and_grads(state["params"], batch)
        _sync(dev)
        grads[remat] = {"peak_measured_bytes": peak, "input_bytes": inputs_g,
                        "seconds": time.perf_counter() - t0}
        del out
    del state
    torch.cuda.empty_cache()
    for remat, rec in grads.items():
        rec["peak_predicted_bytes"] = pred["grads_peak_bytes"][remat]
        rec["peak_rel"] = (abs(rec["peak_predicted_bytes"]
                               - rec["peak_measured_bytes"])
                           / rec["peak_measured_bytes"])
    bound_s = max(pred["flops"] / dryrun_peak_flops(cfg),
                  pred["bytes"] / HBM_BYTES_PER_S)
    return {"model": cfg.name, "batch": list(TRAIN_BATCH),
            "flops_predicted": pred["flops"], "flops_measured": st.flops,
            "peak_predicted_bytes": pred["peak_bytes"],
            "peak_measured_bytes": measured,
            "input_bytes": inputs,
            "peak_rel": abs(pred["peak_bytes"] - measured) / measured,
            "peak_limit": DRYRUN_PEAK_REL,
            "step_seconds": seconds, "bound_seconds": bound_s,
            "bound_by": ("operations" if pred["flops"] / dryrun_peak_flops(
                cfg) >= pred["bytes"] / HBM_BYTES_PER_S else "bytes"),
            "predict_trace_s": pred["trace_s"],
            "loss_and_grads": {"remat": grads[True],
                               "no_remat": grads[False],
                               "fall_limit_share": REMAT_FALL_SHARE}}


def dryrun_peak_flops(cfg) -> float:
    return PEAK_FP32_FLOPS if cfg.compute_dtype == "float32" \
        else PEAK_BF16_FLOPS


def dryrun_phase(seed: int, dev, shard_train: dict,
                 train_peak: int | None = None) -> dict:
    """The ``dryrun`` phase, (a) to (d), and its JSON line; the planning
    runs in three spawned processes (fake process groups of their own)
    while the card measures.  ``train_peak``: the ``train`` phase's peak
    over its (a), which (a)'s prediction of one such step holds too."""
    import pickle

    import torch
    import torch.multiprocessing as mp

    from repro_torch.runtime.train import comm_by_kind

    t_phase = time.perf_counter()
    full = train_config()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        spec = {"train_cfg": full, "batch": TRAIN_BATCH,
                "tokens_dtype": "int32", "mesh": SHARD_TRAIN_MESH,
                "f_cfg": shard_train["f_cfg"], "f_batch": SHARD_TRAIN_BATCH,
                "serve_cfg": cut_layers(full, SHARD_TRAIN_LAYERS, "float32"),
                "wide": {"cfg": wide_serve_config(),
                         "batch": WIDE_SERVE_BATCH,
                         "prompt": WIDE_SERVE_PROMPT,
                         "max_seq": WIDE_SERVE_MAX_SEQ,
                         "steps": WIDE_SERVE_DECODE},
                "serve_batch": DRYRUN_BATCH, "prompt": DRYRUN_PROMPT,
                "max_seq": DRYRUN_MAX_SEQ, "steps": DRYRUN_DECODE,
                "cells": DRYRUN_CELLS, "out": os.path.join(tmp, "cells"),
                "seed": seed, "device_type": dev.type,
                "store": os.path.join(tmp, "store"), "prepare": SHARD_PREPARE}
        ctx = mp.get_context("spawn")
        plans = ["abc"] + [str(i) for i in range(len(DRYRUN_CELLS))]
        procs = [ctx.Process(target=dryrun_plan, args=(
            spec, w, os.path.join(tmp, f"plan_{w}.pkl"))) for w in plans]
        for pr in procs:
            pr.start()
        try:
            world = math.prod(SHARD_TRAIN_MESH)
            t0 = time.perf_counter()
            try:
                mp.start_processes(dryrun_serve_rank,
                                   args=(dict(spec, out=tmp),), nprocs=world,
                                   join=True, start_method="spawn")
            except Exception:
                for r in range(world):
                    err = os.path.join(tmp, f"serve{r}.err")
                    if os.path.exists(err):
                        with open(err) as f:
                            print(f"dryrun rank {r}:\n{f.read()}",
                                  file=sys.stderr)
                raise
            serve_s = time.perf_counter() - t0
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"serve{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
            for pr in procs:
                pr.join(DRYRUN_TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        check(all(pr.exitcode == 0 for pr in procs),
              f"a planning process failed: exit codes "
              f"{[pr.exitcode for pr in procs]}")
        plan = {}
        for w in plans:
            with open(os.path.join(tmp, f"plan_{w}.pkl"), "rb") as f:
                plan[w] = pickle.load(f)
    abc = plan["abc"]
    a = dryrun_train_measure(seed, dev, abc["a"])
    if train_peak is not None:
        a["train_phase_peak_bytes"] = train_peak
        a["train_phase_peak_rel"] = (abs(abc["a"]["peak_bytes"] - train_peak)
                                     / train_peak)
    f_kind = {k: v for k, v in comm_by_kind(shard_train["f_comm"]).items()
              if v}
    b = {"predicted_by_kind": {k: v for k, v in abc["b"]["by_kind"].items()
                               if v},
         "step_comm_by_kind": f_kind, "step_comm": shard_train["f_comm"],
         "predicted_by_dim": abc["b"]["by_dim"],
         "predict_trace_s": abc["b"]["trace_s"]}
    from repro_torch.parallel.tensor import serve_comm_by_kind

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    r0 = ranks[0]
    c = {"model": f"{spec['serve_cfg'].name}, {SHARD_TRAIN_LAYERS} of "
         f"{full.n_layers} layers, float32, bf16 cache",
         "mesh": list(SHARD_TRAIN_MESH), "batch": DRYRUN_BATCH,
         "prompt": DRYRUN_PROMPT, "max_seq": DRYRUN_MAX_SEQ,
         "decode_steps": DRYRUN_DECODE,
         "logits_limit": DRYRUN_LOGITS_REL,
         "tile_route_vs_own_layouts": forced_agreement(
             r0["own_layout_logits"], r0["unsharded_logits"],
             r0["own_layout_tokens"], r0["unsharded_tokens"]),
         "placed_vs_unsharded": [forced_agreement(
             [x[slice(*rk["rows"])] for x in r0["unsharded_logits"]],
             rk["logits"],
             [x[slice(*rk["rows"])] for x in r0["unsharded_tokens"]],
             rk["tokens"]) for rk in ranks],
         "resident_bytes": [rk["resident_bytes"] for rk in ranks],
         "reckoned_bytes": [rk["reckoned_bytes"] for rk in ranks],
         "flash_launches_per_rank": [rk["flash_launches"] for rk in ranks],
         "flash_launches_expected_per_rank": SHARD_TRAIN_LAYERS,
         "flash_rows_ok": all(row["ok"] for rk in ranks
                              for row in rk["flash_rows"]),
         "flash_max_abs_diff": max(row["max_abs_diff"] for rk in ranks
                                   for row in rk["flash_rows"]),
         "spmm_launches_per_rank": [rk["spmm_launches"] for rk in ranks],
         "spmm_calls_per_rank": [len(rk["spmm_rows"]) for rk in ranks],
         "spmm_rows_ok": all(row["ok"] for rk in ranks
                             for row in rk["spmm_rows"]),
         "spmm_max_abs_diff": max(row["max_abs_diff"] for rk in ranks
                                  for row in rk["spmm_rows"]),
         "spmm_worst_over_limit": max(row["worst_over_limit"]
                                      for rk in ranks
                                      for row in rk["spmm_rows"]),
         "comm_per_step": [rk["comm"] for rk in ranks],
         "comm_equals_reckoned": [rk["comm"] == rk["reckoned_comm"]
                                  for rk in ranks],
         "slab_params_gathered": [rk["slab_gathered"] for rk in ranks],
         "decode_peak_predicted_bytes": abc["c"]["peak_bytes"],
         "decode_peak_measured_bytes": [rk["measured_peak_bytes"]
                                        for rk in ranks],
         "decode_input_bytes": [rk["input_bytes"] for rk in ranks],
         "decode_by_kind_predicted": abc["c"]["by_kind"],
         "decode_by_kind_measured": [rk["by_kind"] for rk in ranks],
         "decode_by_kind_reckoned": [
             nonzero(serve_comm_by_kind(rk["measured_reckoned"]))
             for rk in ranks],
         "decode_comm_equals_reckoned": [
             rk["measured_comm"] == rk["measured_reckoned"]
             for rk in ranks],
         "decode_flops_predicted": abc["c"]["flops"],
         "decode_flops_measured": [rk["flops"] for rk in ranks],
         "serve_seconds": serve_s}
    c["decode_peak_rel"] = [abs(abc["c"]["peak_bytes"] - m) / m
                            for m in c["decode_peak_measured_bytes"]]
    wide = [rk["e"] for rk in ranks]
    w = spec["wide"]
    e = {"model": f"{w['cfg'].name}, {w['cfg'].n_layers} of 64 layers, "
         "float32, bf16 cache",
         "mesh": list(WIDE_SHARD_MESH), "batch": w["batch"],
         "prompt": w["prompt"], "max_seq": w["max_seq"],
         "decode_steps": w["steps"],
         "resident_bytes": [w["routes"]["gather"]["resident_bytes"]
                            for w in wide],
         "reckoned_bytes": [w["reckoned_bytes"] for w in wide]}
    for strategy in ("gather", "flash"):
        runs = [w["routes"][strategy] for w in wide]
        e[strategy] = {
            "tokens_equal_unsharded": all(
                all(np.array_equal(tok, wide[0]["unsharded_tokens"][i])
                    for i, tok in enumerate(run["tokens"]))
                for run in runs),
            "comm_equals_reckoned": [run["comm"] == run["reckoned_comm"]
                                     for run in runs],
            "comm_per_step": [run["comm"] for run in runs],
            "slab_params_gathered": [run["slab_gathered"] for run in runs],
            "flash_launches_per_rank": [run["flash_launches"]
                                        for run in runs],
            "flash_rows_ok": all(row["ok"] for run in runs
                                 for row in run["flash_rows"]),
            "flash_max_abs_diff": max(row["max_abs_diff"] for run in runs
                                      for row in run["flash_rows"])}
    d = [{k: plan[str(i)]["d"].get(k) for k in (
        "arch", "shape", "mesh", "status", "error", "chips", "kind",
        "trace_s", "seconds", "hlo_flops_per_device", "memory",
        "dominant_term", "roofline", "useful_flops_ratio")}
        for i in range(len(DRYRUN_CELLS))]
    emit("dryrun", card=nvidia_smi(), seconds=time.perf_counter() - t_phase,
         part_a=a, part_b=b, part_c=c, part_d=d, part_e=e)
    check(a["flops_predicted"] == a["flops_measured"] > 0,
          f"(a) fake FLOPs {a['flops_predicted']} != the card's "
          f"{a['flops_measured']}")
    check(a["peak_rel"] <= DRYRUN_PEAK_REL,
          f"(a) predicted peak {a['peak_predicted_bytes']} vs measured "
          f"{a['peak_measured_bytes']}: rel {a['peak_rel']} > "
          f"{DRYRUN_PEAK_REL}")
    check(train_peak is None
          or a["train_phase_peak_rel"] <= DRYRUN_PEAK_REL,
          f"(a) predicted peak {a['peak_predicted_bytes']} vs the train "
          f"phase's {train_peak}: rel {a.get('train_phase_peak_rel')} > "
          f"{DRYRUN_PEAK_REL}")
    lg = a["loss_and_grads"]
    on, off = lg["remat"], lg["no_remat"]
    check(all(x["peak_rel"] <= DRYRUN_PEAK_REL for x in (on, off)),
          f"(a) loss and gradients' peak predicted vs measured: remat "
          f"{on['peak_predicted_bytes']} vs {on['peak_measured_bytes']}, "
          f"none {off['peak_predicted_bytes']} vs "
          f"{off['peak_measured_bytes']}: over {DRYRUN_PEAK_REL}")
    fall = off["peak_predicted_bytes"] - on["peak_predicted_bytes"]
    check(fall > 0 and off["peak_measured_bytes"] - on["peak_measured_bytes"]
          >= REMAT_FALL_SHARE * fall,
          f"(a) remat lowered the loss and gradients' peak from "
          f"{off['peak_measured_bytes']} to {on['peak_measured_bytes']}: "
          f"less than {REMAT_FALL_SHARE} of the predicted fall {fall}")
    check(a["step_seconds"] >= a["bound_seconds"],
          f"(a) the step took {a['step_seconds']} s, under its roofline "
          f"bound {a['bound_seconds']} s: the count is wrong")
    check(b["predicted_by_kind"] == b["step_comm_by_kind"]
          and b["predicted_by_kind"].get("reduce-scatter"),
          f"(b) predicted collective bytes {b['predicted_by_kind']} != "
          f"(f)'s step.comm {b['step_comm_by_kind']}")
    for what, agree in [("the tile route against the config's own "
                          "layouts", c["tile_route_vs_own_layouts"]),
                         *[(f"rank {i}'s placed steps against the "
                            f"unsharded run", x)
                           for i, x in enumerate(c["placed_vs_unsharded"])]]:
        check(agree["logits_rel"] <= DRYRUN_LOGITS_REL
              and agree["prefill_tokens_equal"]
              and agree["unexplained"] == 0,
              f"(c) {what}: {agree}")
    check(c["resident_bytes"] == c["reckoned_bytes"],
          f"(c) resident bytes {c['resident_bytes']} != reckoned "
          f"{c['reckoned_bytes']}")
    check(c["flash_rows_ok"], "(c) a placed prefill's flash call is off its "
                              "plain version")
    check(c["flash_launches_per_rank"] == [SHARD_TRAIN_LAYERS] * len(ranks),
          f"(c) flash launches {c['flash_launches_per_rank']}")
    check(all(rel <= DRYRUN_PEAK_REL for rel in c["decode_peak_rel"]),
          f"(c) decode peak {c['decode_peak_predicted_bytes']} vs measured "
          f"{c['decode_peak_measured_bytes']}")
    check(all(nonzero(m) == want for m, want in zip(
        c["decode_by_kind_measured"], c["decode_by_kind_reckoned"]))
          and all(c["decode_comm_equals_reckoned"])
          and nonzero(abc["c"]["by_kind"]) == c["decode_by_kind_reckoned"][0],
          f"(c) decode collective bytes: measured "
          f"{c['decode_by_kind_measured']}, reckoned "
          f"{c['decode_by_kind_reckoned']}, planned {abc['c']['by_kind']}")
    check(all(c["comm_equals_reckoned"]),
          f"(c) the placed steps' bytes differ from serve_bytes: "
          f"{c['comm_per_step']}")
    check(c["slab_params_gathered"] == [0] * len(ranks)
          and all(x["param_gather_bytes"] == 0 for comm in
                  c["comm_per_step"] for x in comm),
          f"(c) params gathered: {c['slab_params_gathered']}")
    spmm_expected = 3 * SHARD_TRAIN_LAYERS * (1 + DRYRUN_DECODE)
    check(c["spmm_launches_per_rank"] == [spmm_expected] * len(ranks)
          == c["spmm_calls_per_rank"],
          f"(c) spmm launches {c['spmm_launches_per_rank']}, calls "
          f"{c['spmm_calls_per_rank']}, expected {spmm_expected} a rank")
    check(c["spmm_rows_ok"], f"(c) a sparse tile call is off its plain "
                             f"version: {c['spmm_worst_over_limit']}")
    for strategy in ("gather", "flash"):
        run = e[strategy]
        check(run["tokens_equal_unsharded"],
              f"(e) {strategy}: placed tokens differ from unsharded")
        check(all(run["comm_equals_reckoned"]),
              f"(e) {strategy}: bytes differ from serve_bytes: "
              f"{run['comm_per_step']}")
        check(run["slab_params_gathered"] == [0] * len(ranks)
              and all(x["param_gather_bytes"] == 0 for comm in
                      run["comm_per_step"] for x in comm),
              f"(e) {strategy}: params gathered")
        check(run["flash_launches_per_rank"]
              == [w["cfg"].n_layers] * len(ranks) and run["flash_rows_ok"],
              f"(e) {strategy}: flash launches "
              f"{run['flash_launches_per_rank']} or a call off its plain "
              f"version")
    check(e["resident_bytes"] == e["reckoned_bytes"],
          f"(e) resident bytes {e['resident_bytes']} != reckoned "
          f"{e['reckoned_bytes']}")
    check(all(m == abc["c"]["flops"] for m in c["decode_flops_measured"]),
          "(c) decode FLOPs predicted != measured")
    for cell in d:
        check(cell["status"] == "ok",
              f"(d) {cell['arch']} {cell['shape']}: {cell['status']} "
              f"{cell.get('error')}")
    return {"launches": sum(c["flash_launches_per_rank"]) + sum(
        sum(e[r]["flash_launches_per_rank"]) for r in ("gather", "flash")),
            "max_abs_err": max(c["flash_max_abs_diff"],
                               e["gather"]["flash_max_abs_diff"],
                               e["flash"]["flash_max_abs_diff"]),
            "spmm_launches": sum(c["spmm_launches_per_rank"]),
            "spmm_max_abs_err": c["spmm_max_abs_diff"]}


def entry_points_phase(dev) -> dict:
    """The ``entry_points`` phase: the serving launcher and the example
    twins run as a user runs them, each a subprocess on ``dev``
    (``--device``) from this checkout's ``src``.  ``python -m
    repro_torch.launch.serve`` serves full-width, full-depth
    h2o-danube-1.8B (``ENTRY_SERVE_ARGS``; its report through
    ``--metrics-out``): every request its ``ENTRY_NEW`` tokens, every
    prefill's 24 layers through the flash kernel.  Then
    ``serve_decode_torch.py``, ``quickstart_torch.py`` and
    ``serve_http_torch.py --check`` for both backends (``ENTRY_HTTP``
    requests, traced), the generation trace through the unchanged
    ``benchmarks/check_baseline.py --require-mid-decode``.  Any non-zero
    exit fails the run, after the phase's line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    runs = {}
    t_phase = time.perf_counter()
    ex = os.path.join(ROOT, "examples")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        def run(name, args):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, *args], cwd=tmp, env=env,
                                 capture_output=True, text=True,
                                 timeout=ENTRY_TIMEOUT_S)
            runs[name] = {
                "command": " ".join(os.path.relpath(a, ROOT)
                                    if a.startswith(ROOT) else a
                                    for a in args),
                "exit_code": out.returncode,
                "seconds": time.perf_counter() - t0,
                "stdout_tail": out.stdout.strip().splitlines()[-3:]}
            if out.returncode:
                print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode == 0

        report = os.path.join(tmp, "serve.json")
        serve = None
        if run("launch_serve", ["-m", "repro_torch.launch.serve",
                                *ENTRY_SERVE_ARGS, "--device", dev.type,
                                "--metrics-out", report]):
            with open(report) as f:
                serve = json.load(f)
        run("serve_decode", [os.path.join(ex, "serve_decode_torch.py"),
                             "--device", dev.type])
        run("quickstart", [os.path.join(ex, "quickstart_torch.py"),
                           "--device", dev.type])
        http = [os.path.join(ex, "serve_http_torch.py"), "--check",
                "--device", dev.type, "--requests", str(ENTRY_HTTP)]
        run("serve_http_classify", [*http, "--trace-out",
                                    os.path.join(tmp, "classify.json")])
        trace = os.path.join(tmp, "generate.json")
        run("serve_http_generate", [*http, "--backend", "generate",
                                    "--trace-out", trace])
        run("check_baseline_trace", [
            os.path.join(ROOT, "benchmarks", "check_baseline.py"),
            "--trace", trace, "--require-mid-decode"])
    res = {"seconds": time.perf_counter() - t_phase, "runs": runs}
    launches = 0
    if serve is not None:
        launches = serve["kernel_launches"]["flash_attention_cuda"]
        # on the CPU (the rehearsal) every wrapper takes its plain version
        expected = (serve["layers"] * serve["requests"] if dev.type == "cuda"
                    else 0)
        res["launch_serve"] = {
            "model": serve["arch"], "layers": serve["layers"],
            "device": serve["device"], "requests": serve["requests"],
            "tokens_per_request": sorted({len(o) for o in serve["outputs"]}),
            "tokens": serve["tokens"], "seconds": serve["seconds"],
            "tokens_per_s": serve["tokens_per_s"],
            "occupancy_mean": serve["scheduler"]["occupancy_mean"],
            "latency_mean_s": serve["scheduler"]["latency_mean_s"],
            "flash_launches": launches,
            "flash_launches_expected": expected,
            "kernel_launches": serve["kernel_launches"]}
    emit("entry_points", **res)
    for name, r in runs.items():
        check(r["exit_code"] == 0, f"{name} ({r['command']}) exited "
                                   f"{r['exit_code']}")
    s = res["launch_serve"]
    check(s["tokens_per_request"] == [ENTRY_NEW],
          f"launcher requests returned {s['tokens_per_request']} tokens, "
          f"not {ENTRY_NEW}")
    check(launches == s["flash_launches_expected"],
          f"launcher flash launches {launches} != "
          f"{s['layers']} layers x {s['requests']} prefills")
    return {"launches": launches}


def build_decode_lm(seed: int, dev):
    """(cfg, params, statics): granite-3-2b at full width, DECODE_LAYERS
    deep, ``decode_strategy="flash"``, bf16 weights drawn on ``dev`` from
    the seed (the same on every rank that asks)."""
    import torch

    from repro_torch.configs import granite_3_2b
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(
        granite_3_2b.config(), n_layers=DECODE_LAYERS,
        layer_types=(("attn", "mlp"),) * DECODE_LAYERS,
        decode_strategy="flash")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, statics = init_params(cfg, gen, device=dev)
    return cfg, params, statics


def decode_steps(params, statics, prompts, steps: int, max_seq: int,
                 cache_dtype, dev, teacher=None, mesh=None):
    """Prefill ``prompts`` [B, L] (the flash kernel route), then ``steps``
    decode steps at one shared position through the step
    ``make_decode_step`` takes (``runtime.serve.decode_logits``), under
    ``activation_sharding_ctx(mesh)`` when a mesh is given.  Feeds the
    greedy tokens, or ``teacher``'s.  Returns (float32 logits
    [steps, B, vocab], the tokens fed [steps, B], the greedy token of
    ``make_decode_step`` at the last step)."""
    import contextlib

    import torch

    from repro_torch.models.transformer import apply_model, init_cache
    from repro_torch.parallel.activations import activation_sharding_ctx
    from repro_torch.runtime.serve import (
        ServeConfig,
        decode_logits,
        make_decode_step,
    )

    b, n = prompts.shape
    vocab = statics["cfg"].vocab
    cache = init_cache(statics, b, max_seq, dtype=cache_dtype, device=dev)
    ctx = (activation_sharding_ctx(mesh) if mesh is not None
           else contextlib.nullcontext())
    fed, out = [], []
    with torch.no_grad(), ctx:
        logits, _, _ = apply_model(
            params, statics, torch.as_tensor(prompts, device=dev),
            positions=torch.arange(n, device=dev), cache=cache, cache_pos=0,
            cache_len=n, prefill=True)
        tok = logits[:, -1, :vocab].argmax(-1)
        for i in range(steps):
            if teacher is not None:
                tok = torch.as_tensor(teacher[i], device=dev)
            fed.append(tok)
            lg, cache = decode_logits(statics, params, cache, tok,
                                      torch.tensor(n + i, device=dev))
            out.append(lg)
            tok = lg.argmax(-1)
        decode = make_decode_step(statics["cfg"], statics, ServeConfig())
        last, _ = decode(params, cache, fed[-1],
                         torch.tensor(n + steps - 1, device=dev))
    return torch.stack(out), torch.stack(fed), last


def mesh_overhead(mesh_fn, plain_fn, x) -> dict:
    """Host ms of a forward of ``x`` on the one-rank mesh and unsharded,
    measured in turns (mesh, unsharded, unsharded, mesh), each the mean
    of its two medians."""
    t = [host_ms(lambda fn=fn: fn(x))
         for fn in (mesh_fn, plain_fn, plain_fn, mesh_fn)]
    return {"mesh": (t[0] + t[3]) / 2, "unsharded": (t[1] + t[2]) / 2,
            "turns": t}


def _stats(svc) -> dict:
    return {k: (st.counts, st.windows)
            for k, st in svc.activation_stats.layers.items()}


def _stats_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k][0], b[k][0]) and a[k][1] == b[k][1] for k in a)


def _spmm_counts() -> dict:
    from repro_torch.kernels import pattern_spmm as tk

    return {"pattern_spmm_cuda": tk.pattern_spmm_cuda.launches,
            "pattern_spmm_quant_cuda": tk.pattern_spmm_quant_cuda.launches}


def _zero_counts() -> None:
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import pattern_spmm as tk

    tk.pattern_spmm_cuda.launches = 0
    tk.pattern_spmm_quant_cuda.launches = 0
    tfa.flash_attention_cuda.launches = 0


def flash_decode_runs(cfg, params, prompts, teacher, max_seq: int, dev,
                      mesh) -> dict:
    """Flash-decode under ``mesh`` on the teacher tokens, with the bf16
    weights and with the same weights in float32: both runs' logits
    (numpy), the sharded route's calls and flash-attention launches of
    the bf16 run, those of the float32 run's prefill, and whether
    ``make_decode_step``'s token at the last step is the bf16 logits'
    argmax."""
    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import attention
    from repro_torch.models.transformer import init_statics

    calls = attention.flash_decode_sharded.calls
    lg, _, last = decode_steps(params, init_statics(cfg, dev), prompts,
                               len(teacher), max_seq, torch.bfloat16, dev,
                               teacher=teacher, mesh=mesh)
    calls = attention.flash_decode_sharded.calls - calls
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    flash0 = tfa.flash_attention_cuda.launches
    lg32, _, _ = decode_steps(_map_tensors(params, lambda t: t.float()),
                              init_statics(cfg32, dev), prompts, len(teacher),
                              max_seq, torch.float32, dev, teacher=teacher,
                              mesh=mesh)
    lg = lg.cpu().numpy()
    return {"bf16": lg, "fp32": lg32.cpu().numpy(), "calls": calls,
            "fp32_launches": tfa.flash_attention_cuda.launches - flash0,
            "last_is_argmax": bool(np.array_equal(last.cpu().numpy(),
                                                  lg[-1].argmax(-1)))}


def moe_shard_run(seed: int, dev, mesh) -> dict:
    """(f) on one rank: DeepSeek-V2's smoke MoE (float32 weights from the
    seed, the same on every rank) on a seeded ``SHARD_MOE_SHAPE`` input,
    expert-parallel under ``activation_sharding_ctx(mesh)``, against each
    data shard's rows through the unsharded ``moe_apply`` (capacity
    counted on the shard's tokens, as the sharded route counts it)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.parallel.activations import activation_sharding_ctx
    from repro_torch.parallel.sharding import mesh_axis_sizes

    cfg = get_smoke_config("deepseek_v2_236b").moe
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, static = moe.moe_init(gen, cfg, device=dev)
    x = torch.as_tensor(np.random.default_rng(seed + 12).normal(
        size=(*SHARD_MOE_SHAPE, cfg.d_model)).astype(np.float32), device=dev)
    data = mesh_axis_sizes(mesh).get("data", 1)
    calls = moe._moe_sharded.calls
    with torch.no_grad():
        with activation_sharding_ctx(mesh):
            got = moe.moe_apply(params, static, cfg, x)
        calls = moe._moe_sharded.calls - calls
        want = torch.cat([moe.moe_apply(params, static, cfg, xs)
                          for xs in x.chunk(data)])
        whole = moe.moe_apply(params, static, cfg, x)
    return {"config": dataclasses.asdict(cfg), "shape": list(x.shape),
            "out": got.cpu().numpy(), "sharded_calls": calls,
            "rel_vs_per_shard": rel_diff(got, want),
            "rel_vs_whole_batch": rel_diff(got, whole)}


def shard_rank(rank: int, spec: dict) -> None:
    """One rank of part (b): joins the gloo group, serves the requests
    through ``InferenceService(mesh=...)`` on the partitioned programs,
    holds each fp32 layer against the single-device dispatch, times a
    sharded forward, and decodes with flash-decode on the teacher tokens.
    Writes its results to ``rank<r>.pkl`` in ``spec["out"]``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.engine import (
        InferenceService,
        load_program,
        make_forward,
        partition_from_mesh,
        partition_network,
    )
    from repro_torch.engine.executor import _ShardedDispatch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch.mesh import make_mesh, mesh_device
    from repro_torch.serve.api import Request

    if spec["prepare"] is not None:
        spec["prepare"]()
    world = spec["mesh"][0] * spec["mesh"][1]
    dist.init_process_group(
        spec["backend"], store=dist.FileStore(spec["store"], world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh = make_mesh(spec["mesh"], ("data", "model"),
                         device_type=spec["device_type"])
        dev = mesh_device(mesh)
        data, model = spec["mesh"]
        progs = {prec: partition_network(
            load_program(spec[prec], verify=False, device=dev),
            data=data, model=model) for prec in ("fp32", "int8")}
        svcs = {prec: InferenceService(
            progs[prec], batch_slots=spec["batch_slots"], mesh=mesh,
            collect_stats=True, device=dev) for prec in progs}
        for svc in svcs.values():
            svc.warmup()
        out = {"device": str(dev), "backend": dist.get_backend()}
        # the main path: counts from 0, the requests through both
        # services, read
        _zero_counts()
        t0 = time.perf_counter()
        reqs = {}
        for prec, svc in svcs.items():
            reqs[prec] = [Request(image=img) for img in spec["images"]]
            serve_bursts(svc, reqs[prec], spec["bursts"])
        out["serve_seconds"] = time.perf_counter() - t0
        out["launches"] = _spmm_counts()
        out["batches"] = {p: svc.batches_run for p, svc in svcs.items()}
        for prec in progs:
            out[f"logits_{prec}"] = np.stack([r.logits for r in reqs[prec]])
            out[f"labels_{prec}"] = np.array([r.label for r in reqs[prec]])
            out[f"stats_{prec}"] = _stats(svcs[prec])
        x8 = spec["images"][: spec["batch_slots"]]
        prog = progs["fp32"]
        out["layer_parity"] = layer_parity(
            prog, prog, x8, dev, want_dev=dev, disp=_ShardedDispatch(
                dev, mesh, partition_from_mesh(mesh, prog.partition)))
        fwds = {prec: make_forward(prog, mesh=mesh)
                for prec, prog in progs.items()}
        out["forward_ms"] = {prec: host_ms(lambda f=f: f(x8))
                             for prec, f in fwds.items()}
        del svcs, progs, fwds
        # flash-decode on the teacher tokens, model ranks over the cache
        cfg, params, _ = spec["build_lm"](spec["seed"], dev)
        flash0 = tfa.flash_attention_cuda.launches
        out["flash"] = flash_decode_runs(cfg, params, spec["prompts"],
                                         spec["teacher"], spec["max_seq"],
                                         dev, mesh)
        out["flash_attention_launches"] = (
            tfa.flash_attention_cuda.launches - flash0
            - out["flash"]["fp32_launches"])
        # (f) expert parallelism over the model ranks
        out["moe"] = moe_shard_run(spec["seed"], dev, mesh)
        with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def shard_phase(seed: int, dev, loaded, prog8, images) -> dict:
    """The sharded path: (a) a one-rank mesh in this process, (b) a gloo
    group of ``SHARD_MESH`` ranks on this card; checks and the report."""
    import pickle

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.engine import InferenceService, make_forward, save_program
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_statics
    from repro_torch.serve.api import Request

    progs = {"fp32": loaded, "int8": prog8}
    x8 = images[:BATCH_SLOTS]
    # the single-device references: the same requests, the same bursts
    ref = {}
    for prec, prog in progs.items():
        svc = InferenceService(prog, batch_slots=BATCH_SLOTS, device=dev,
                               collect_stats=True)
        reqs = [Request(image=img) for img in images]
        serve_bursts(svc, reqs)
        ref[prec] = {"logits": np.stack([r.logits for r in reqs]),
                     "labels": np.array([r.label for r in reqs]),
                     "stats": _stats(svc), "batches": svc.batches_run}
    spmms = len(loaded.convs) + 1

    # -- (a) a one-rank mesh in this process ---------------------------
    mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
    fwd = {p: make_forward(prog, mesh=mesh) for p, prog in progs.items()}
    one = {p: make_forward(prog, device=dev) for p, prog in progs.items()}
    want = {p: one[p](images) for p in progs}
    svc = InferenceService(loaded, batch_slots=BATCH_SLOTS, mesh=mesh,
                           collect_stats=True)
    svc.warmup()
    # the main path: counts from 0, the mesh forwards and the service, read
    _zero_counts()
    got = {p: fwd[p](images) for p in progs}
    reqs = [Request(image=img) for img in images]
    serve_bursts(svc, reqs)
    launches_a = _spmm_counts()
    a = {
        "mesh": [1, 1], "backend": str(dist.get_backend()),
        "bit_equal": {p: bool(torch.equal(got[p], want[p])) for p in progs},
        "service_labels_equal": bool(np.array_equal(
            np.array([r.label for r in reqs]), ref["fp32"]["labels"])),
        "service_logits_bit_equal": bool(np.array_equal(
            np.stack([r.logits for r in reqs]), ref["fp32"]["logits"])),
        "service_stats_equal": _stats_equal(_stats(svc),
                                            ref["fp32"]["stats"]),
        "trace_count": svc.trace_count(), "launches": launches_a,
        "launches_expected": {
            "pattern_spmm_cuda": spmms * (1 + svc.batches_run),
            "pattern_spmm_quant_cuda": spmms},
        "forward_ms": {p: mesh_overhead(fwd[p], one[p], x8) for p in progs},
    }
    del fwd, one, svc

    # flash-decode against gather, teacher-forced on gather's tokens (a
    # bf16 near-tie cannot make the runs diverge): bf16 flash no farther
    # from the float32 model than GEN_BF16_NOISE_FACTOR x bf16 gather's
    # own distance from it, float32 flash within GEN_FP32_REL of float32
    # gather (decode_rows)
    cfg, params, _ = build_decode_lm(seed, dev)
    gather = init_statics(dataclasses.replace(cfg, decode_strategy="gather"),
                          dev)
    prompts = np.random.default_rng(seed + 7).integers(
        1, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT)).astype(np.int64)
    flash0 = tfa.flash_attention_cuda.launches
    lg_g, fed, _ = decode_steps(params, gather, prompts, DECODE_STEPS,
                                DECODE_MAX_SEQ, torch.bfloat16, dev)
    teacher = fed.cpu().numpy()
    fl = flash_decode_runs(cfg, params, prompts, teacher, DECODE_MAX_SEQ,
                           dev, mesh)
    flash_a = tfa.flash_attention_cuda.launches - flash0 - fl["fp32_launches"]
    params32 = _map_tensors(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32",
                                decode_strategy="gather")
    lg_32, _, _ = decode_steps(params32, init_statics(cfg32, dev), prompts,
                               DECODE_STEPS, DECODE_MAX_SEQ, torch.float32,
                               dev, teacher=teacher)
    del params32, params
    lg_g, lg_32 = lg_g.cpu().numpy(), lg_32.cpu().numpy()

    def rd(x, y) -> float:
        return rel_diff(torch.as_tensor(x), torch.as_tensor(y))

    def decode_rows(fl) -> list[dict]:
        rows = []
        for i in range(DECODE_STEPS):
            noise = rd(lg_g[i], lg_32[i])
            far = rd(fl["bf16"][i], lg_32[i])
            d32 = rd(fl["fp32"][i], lg_32[i])
            rows.append({
                "step": i, "bf16_flash_vs_fp32": far,
                "bf16_gather_vs_fp32": noise,
                "bf16_limit": GEN_BF16_NOISE_FACTOR * noise,
                "bf16_flash_vs_gather": rd(fl["bf16"][i], lg_g[i]),
                "fp32_flash_vs_gather": d32,
                "argmax_equal": bool(
                    (fl["bf16"][i].argmax(-1) == lg_g[i].argmax(-1)).all()),
                "ok": (far <= GEN_BF16_NOISE_FACTOR * noise
                       and d32 <= GEN_FP32_REL)})
        return rows

    a["decode_limit"] = DECODE_LIMIT
    a["decode"] = decode_rows(fl)
    a["flash_decode_calls"] = fl["calls"]
    a["flash_decode_calls_expected"] = (DECODE_STEPS + 1) * cfg.n_layers
    a["make_decode_step_token_is_argmax"] = fl["last_is_argmax"]
    torch.cuda.empty_cache()

    # -- (b) SHARD_MESH ranks of a gloo group on this card -------------
    data, model = SHARD_MESH
    world = data * model
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        paths = {p: save_program(os.path.join(tmp, p), prog)
                 for p, prog in progs.items()}
        spec = {"mesh": SHARD_MESH, "backend": SHARD_BACKEND,
                "device_type": dev.type,
                "store": os.path.join(tmp, "store"), "out": tmp,
                "prepare": SHARD_PREPARE, "images": images,
                "bursts": BURSTS, "batch_slots": BATCH_SLOTS,
                "build_lm": build_decode_lm, "seed": seed,
                "prompts": prompts, "teacher": teacher,
                "max_seq": DECODE_MAX_SEQ, **paths}
        t0 = time.perf_counter()
        mp.start_processes(shard_rank, args=(spec,), nprocs=world,
                           join=True, start_method="spawn")
        b_seconds = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    r0 = ranks[0]
    same = all(
        all(np.array_equal(rk[k], r0[k]) for k in
            ("logits_fp32", "logits_int8", "labels_fp32"))
        and all(np.array_equal(rk["flash"][k], r0["flash"][k])
                for k in ("bf16", "fp32"))
        and np.array_equal(rk["moe"]["out"], r0["moe"]["out"])
        for rk in ranks[1:])
    l8, w8 = r0["logits_int8"], ref["int8"]["logits"]
    l32, w32 = r0["logits_fp32"], ref["fp32"]["logits"]
    b = {
        "mesh": list(SHARD_MESH), "ranks": world,
        "devices": [rk["device"] for rk in ranks],
        "backend": r0["backend"],
        "transport": (
            f"{SHARD_BACKEND}: {world} ranks on "
            f"{len({rk['device'] for rk in ranks})} card(s)"
            + ("; CUDA tensors staged through host memory, not a "
               "multi-card NCCL run" if SHARD_BACKEND == "gloo" else "")),
        "seconds": b_seconds, "serve_seconds": r0["serve_seconds"],
        "ranks_agree": same,
        "layer_limit": f"max|d| <= {LAYER_TOL} * max(1, max|layer|)",
        "layer_parity": r0["layer_parity"],
        "e2e_limit": f"max|d| <= {E2E_TOL} * max(1, max|unsharded logit|)",
        "e2e_rel": rel_diff(torch.as_tensor(l32), torch.as_tensor(w32)),
        "labels_fp32_equal": bool(np.array_equal(r0["labels_fp32"],
                                                 ref["fp32"]["labels"])),
        "int8_limit": (f"max|d| <= {INT8_SHARD_ATOL}; argmax agreement >= "
                       f"{INT8_SHARD_AGREE}"),
        "int8_max_abs_diff": float(np.abs(l8 - w8).max()),
        "int8_argmax_agreement": float(
            (l8.argmax(-1) == w8.argmax(-1)).mean()),
        "stats_equal": {p: all(_stats_equal(rk[f"stats_{p}"],
                                            ref[p]["stats"]) for rk in ranks)
                        for p in progs},
        "batches": r0["batches"],
        "launches_per_rank": [rk["launches"] for rk in ranks],
        "launches_expected_per_rank": {
            "pattern_spmm_cuda": spmms * ref["fp32"]["batches"],
            "pattern_spmm_quant_cuda": spmms * ref["int8"]["batches"]},
        "forward_ms": r0["forward_ms"],
        "decode_limit": DECODE_LIMIT,
        "decode": decode_rows(r0["flash"]),
        "flash_decode_calls": r0["flash"]["calls"],
        "flash_decode_calls_expected": (DECODE_STEPS + 1) * cfg.n_layers,
        "make_decode_step_token_is_argmax": r0["flash"]["last_is_argmax"],
        "moe_limit": (f"expert-parallel moe_apply vs each data shard's "
                      f"unsharded moe_apply <= {MOE_REL} x max(1, max|out|)"),
        "moe": {k: v for k, v in r0["moe"].items() if k != "out"},
    }
    emit("shard", decode_model=dict(
        name=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], vocab=cfg.vocab,
        batch=DECODE_BATCH, prompt=DECODE_PROMPT, max_seq=DECODE_MAX_SEQ,
        steps=DECODE_STEPS), requests=len(images), part_a=a, part_b=b)
    check(all(a["bit_equal"].values()),
          f"one-rank mesh forward differs from the unsharded one: "
          f"{a['bit_equal']}")
    check(a["service_labels_equal"] and a["service_logits_bit_equal"]
          and a["service_stats_equal"] and a["trace_count"] == 1,
          "one-rank mesh service differs from the unsharded service")
    check(launches_a == a["launches_expected"],
          f"one-rank mesh spmm launches {launches_a} != "
          f"{a['launches_expected']}")
    for part, name in ((a, "one-rank mesh"), (b, f"{SHARD_MESH} gloo mesh")):
        bad = [r["step"] for r in part["decode"] if not r["ok"]]
        check(not bad, f"{name}: flash-decode logits off gather at steps "
                       f"{bad}")
        check(part["flash_decode_calls"] == part[
            "flash_decode_calls_expected"],
              f"{name}: flash-decode ran {part['flash_decode_calls']} times")
        check(part["make_decode_step_token_is_argmax"],
              f"{name}: make_decode_step's token is not the logits' argmax")
    check(same, "the ranks of the gloo mesh returned different results")
    check(b["moe"]["sharded_calls"] == 1
          and b["moe"]["rel_vs_per_shard"] <= MOE_REL,
          f"gloo mesh: expert-parallel MoE {b['moe']}")
    bad = [r["layer"] for r in b["layer_parity"] if r["rel"] > LAYER_TOL]
    check(not bad, f"gloo mesh: layers {bad} differ from the single-device "
                   f"dispatch")
    check(b["e2e_rel"] <= E2E_TOL, f"gloo mesh logits {b['e2e_rel']} "
                                   f"(relative) off the unsharded service")
    check(b["labels_fp32_equal"], "gloo mesh fp32 labels differ")
    check(b["int8_max_abs_diff"] <= INT8_SHARD_ATOL
          and b["int8_argmax_agreement"] >= INT8_SHARD_AGREE,
          f"gloo mesh int8 logits off the unsharded int8 run: "
          f"{b['int8_max_abs_diff']}, agreement "
          f"{b['int8_argmax_agreement']}")
    check(all(b["stats_equal"].values()),
          f"gloo mesh skip statistics differ: {b['stats_equal']}")
    for rk in b["launches_per_rank"]:
        check(rk == b["launches_expected_per_rank"],
              f"gloo mesh rank spmm launches {rk} != "
              f"{b['launches_expected_per_rank']}")
    launches = dict(launches_a)
    for rk in b["launches_per_rank"]:
        for k, n in rk.items():
            launches[k] += n
    launches["flash_attention_cuda"] = flash_a + sum(
        rk["flash_attention_launches"] for rk in ranks)
    return {"launches": launches}


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    return fn(tree)


def run(seed: int, dev) -> dict:
    import torch

    from repro_torch.core.quantize import quantize_bp
    from repro_torch.engine import (
        CompileOptions,
        InferenceService,
        compile_network,
        load_program,
        make_forward,
        save_program,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ou_mvm as tou
    from repro_torch.kernels import patches as tp
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.models.cnn import cnn_apply, params_from_numpy
    from repro_torch.serve.api import Request

    # -- 1. device -------------------------------------------------------
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    ptxas = ([ln.split(":", 1)[1].strip() for ln in log.read_text().splitlines()
              if "Used" in ln] if log.exists() else [])
    emit("build", seconds=build_s, library=os.path.relpath(lib, ROOT),
         ptxas=ptxas)

    # -- 3. compile full-width VGG16, fp32 and int8; save and reload ----
    cfg, params, bits = build_model(seed)
    tparams = params_from_numpy(params, dev)
    t0 = time.perf_counter()
    prog32 = compile_network(cfg, tparams, bits, options=CompileOptions(),
                             device=dev)
    fp32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog8 = compile_network(cfg, tparams, bits,
                            options=CompileOptions(precision="int8"),
                            device=dev)
    int8_s = time.perf_counter() - t0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = save_program(os.path.join(tmp, "vgg16_fp32"), prog32)
        loaded = load_program(path, device=dev)
        cpu_prog = load_program(path, device="cpu")
    mism = program_mismatches(prog32, loaded)
    check(not mism, f"save/load round trip changed {mism}")
    check(not program_mismatches(prog32, cpu_prog), "CPU load differs")
    emit("compile", model="vgg16 cifar10 (synthesize_network)",
         convs=len(prog32.convs), block=prog32.block, tile=prog32.tile,
         fp32_seconds=fp32_s, int8_seconds=int8_s,
         bricks={**{op.name: int(op.bp.nnz.sum()) for op in prog32.convs},
                 "fc": int(prog32.fc.bp.nnz.sum())},
         round_trip_bit_equal=True)

    # -- 4. each kernel against its plain version, on the card ----------
    rng = np.random.default_rng(seed + 2)
    cases = {
        "pattern_spmm_cuda": layer_cases(prog32, rng, dev),
        "pattern_spmm_quant_cuda": layer_cases(prog8, rng, dev),
    }
    extra = small_geometry_case(rng, dev)
    extras = {
        "pattern_spmm_cuda": [extra],
        "pattern_spmm_quant_cuda": [(extra[0], quantize_bp(extra[1]),
                                     extra[2])],
    }
    max_err = {}
    for kname in cases:
        rows, worst = [], 0.0
        for name, bp, x in cases[kname] + extras[kname]:
            kernel, plain = calls(kname, bp, x, dev)
            y = kernel()
            res = compare(kname, y, plain(), bp)
            # no atomics: a second run is bit for bit the first
            res["rerun_bit_identical"] = bool(torch.equal(kernel(), y))
            res["ok"] = res["ok"] and res["rerun_bit_identical"]
            res.update(spmm_plan(kname, bp, x.shape[0]))
            rows.append({"case": name, "m": x.shape[0], "k": bp.k_in,
                         "n": bp.n_out, "k_max": bp.k_max, **res})
            if name != extra[0]:
                worst = max(worst, res["max_abs_diff"])
        max_err[kname] = worst
        emit("kernels", kernel=kname, cases=rows)
        bad = [r["case"] for r in rows if not r["ok"]]
        check(not bad, f"{kname} disagrees with its plain version on {bad}")
    # the conv patches at every conv of a forward, in the layouts the
    # executor hands them, and a ragged map with K not a multiple of 4
    # (4-byte stores) and channels-last C % 4 != 0 (strided 4-byte loads)
    pcases = patch_cases(prog32, rng, dev)
    ragged = torch.as_tensor(rng.normal(size=(3, 7, 9, 5)).astype(np.float32),
                             device=dev).permute(0, 3, 1, 2)
    rows = [patch_check(*c) for c in pcases]
    rows.append(patch_check("ragged", ragged, 3, 47))
    emit("kernels", kernel="conv_patches_cuda", cases=rows)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"conv_patches_cuda differs from its plain version on "
                   f"{bad}")
    max_err["conv_patches_cuda"] = max(r["max_abs_diff"] for r in rows)
    # the int8 patch rows at the same convs and the ragged map (byte
    # stores, strided loads), and one whose chunks end ragged
    chunky = torch.as_tensor(rng.normal(size=(3, 40, 5, 6)).astype(
        np.float32), device=dev).permute(0, 2, 3, 1).contiguous()
    rows = [patch_q8_check(*c) for c in pcases]
    rows += [patch_q8_check("ragged", ragged, 3, 47),
             patch_q8_check("chunks", chunky.permute(0, 3, 1, 2), 3, 368)]
    emit("kernels", kernel="conv_patches_q8_cuda", cases=rows)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"conv_patches_q8_cuda differs from its plain version "
                   f"on {bad}")
    max_err["conv_patches_q8_cuda"] = max(r["max_abs_diff"] for r in rows)

    # -- 5. serve ----------------------------------------------------------
    n32 = sum(BURSTS)
    images = np.random.default_rng(seed + 3).normal(
        size=(n32, cfg.conv_channels[0][0], cfg.input_hw, cfg.input_hw)
    ).astype(np.float32)
    svc32 = InferenceService(loaded, batch_slots=BATCH_SLOTS, device=dev,
                             collect_stats=True)
    svc8 = InferenceService(prog8, batch_slots=BATCH_SLOTS, device=dev)
    svc32.warmup()
    svc8.warmup()
    # the main path: counts from 0, traffic through both services, read
    tk.pattern_spmm_cuda.launches = 0
    tk.pattern_spmm_cuda.reduce_launches = 0
    tk.pattern_spmm_quant_cuda.launches = 0
    tk.pattern_spmm_quant_cuda.reduce_launches = 0
    tp.conv_patches_cuda.launches = 0
    tp.conv_patches_q8_cuda.launches = 0
    reqs32 = [Request(image=img) for img in images]
    serve_s = serve_bursts(svc32, reqs32)
    reqs8 = [Request(image=img) for img in images[:N_INT8]]
    svc8.serve(reqs8)
    torch.cuda.synchronize()
    launches = {"pattern_spmm_cuda": tk.pattern_spmm_cuda.launches,
                "pattern_spmm_quant_cuda": tk.pattern_spmm_quant_cuda.launches,
                "conv_patches_cuda": tp.conv_patches_cuda.launches,
                "conv_patches_q8_cuda": tp.conv_patches_q8_cuda.launches}
    reduce_launches = {
        "pattern_spmm_cuda": tk.pattern_spmm_cuda.reduce_launches,
        "pattern_spmm_quant_cuda": tk.pattern_spmm_quant_cuda.reduce_launches}
    spmms = len(loaded.convs) + 1
    batches = {"fp32": svc32.batches_run, "int8": svc8.batches_run}
    m32 = svc32.metrics

    logits32 = np.stack([r.logits for r in reqs32])
    labels32 = np.array([r.label for r in reqs32])
    logits8 = np.stack([r.logits for r in reqs8])
    with torch.no_grad():
        dense = cnn_apply(cfg, tparams,
                          torch.as_tensor(images, device=dev)).cpu().numpy()
        exact = cnn_apply(
            cfg, {k: {n: t.double() for n, t in v.items()}
                  for k, v in tparams.items()},
            torch.as_tensor(images, dtype=torch.float64, device=dev),
        ).cpu().numpy()
    top2 = np.sort(dense, axis=1)[:, -2:]
    cpu_logits = make_forward(cpu_prog, device="cpu")(images).numpy()
    parity = layer_parity(loaded, cpu_prog, images[:BATCH_SLOTS], dev)
    _, one_shot = make_forward(loaded, collect_stats=True, device=dev)(images)
    stats_exact = all(
        np.array_equal(svc32.activation_stats.layers[k].counts, st.counts)
        and svc32.activation_stats.layers[k].windows == st.windows
        for k, st in one_shot.layers.items()
    )
    alone = Request(image=images[10])
    svc32.serve([alone])
    alone8 = Request(image=images[10])
    svc8.serve([alone8])
    res = dict(
        requests_fp32=n32, requests_int8=N_INT8, batch_slots=BATCH_SLOTS,
        bursts=list(BURSTS), batches=batches,
        all_done=all(r.done for r in reqs32 + reqs8),
        trace_count=[svc32.trace_count(), svc8.trace_count()],
        launches=launches, spmms_per_forward=spmms,
        reduce_launches=reduce_launches,
        reduce_launches_expected={
            "pattern_spmm_cuda": reduce_launches_expected(
                loaded, batches["fp32"]),
            "pattern_spmm_quant_cuda": reduce_launches_expected(
                prog8, batches["int8"], "pattern_spmm_quant_cuda")},
        requests_per_s=n32 / serve_s,
        latency_p50_s=m32["latency_p50_s"],
        latency_p99_s=m32["latency_p99_s"],
        occupancy_mean=m32["occupancy_mean"],
        logits_finite=bool(np.isfinite(logits32).all()
                           and np.isfinite(logits8).all()),
        max_abs_logit=float(np.abs(logits32).max()),
        labels_match_dense=bool((labels32 == dense.argmax(1)).all()),
        max_logit_diff_vs_dense=float(np.abs(logits32 - dense).max()),
        min_dense_top2_margin=float((top2[:, 1] - top2[:, 0]).min()),
        max_logit_diff_vs_cpu=float(np.abs(logits32 - cpu_logits).max()),
        e2e_limit=f"max|d| <= {E2E_TOL} * max(1, max|cpu logit|)",
        e2e_rel_vs_cpu=float(np.abs(logits32 - cpu_logits).max()
                             / max(1.0, float(np.abs(cpu_logits).max()))),
        # fp32 noise of the network itself, against float64 dense
        max_logit_err_vs_float64={
            "served": float(np.abs(logits32 - exact).max()),
            "cpu_plain": float(np.abs(cpu_logits - exact).max()),
            "dense_fp32": float(np.abs(dense - exact).max())},
        layer_limit=f"max|d| <= {LAYER_TOL} * max(1, max|cpu layer|)",
        layer_parity_vs_cpu=parity,
        alone_vs_cobatched_bit_identical=bool(
            np.array_equal(alone.logits, reqs32[10].logits)),
        int8_alone_vs_cobatched_bit_identical=bool(
            np.array_equal(alone8.logits, reqs8[10].logits)),
        stats_exact=stats_exact,
        int8_top1_agreement_vs_fp32=float(
            (logits8.argmax(1) == labels32[:N_INT8]).mean()),
    )
    emit("serve", **res)
    check(res["all_done"], "a request was not served")
    check(res["trace_count"] == [1, 1], f"trace_count {res['trace_count']}")
    check(logits32.shape == (n32, cfg.num_classes) and res["logits_finite"],
          "logits not finite or misshaped")
    for kname, prec in (("pattern_spmm_cuda", "fp32"),
                        ("pattern_spmm_quant_cuda", "int8")):
        check(launches[kname] == spmms * batches[prec],
              f"{kname} launches {launches[kname]} != {spmms} x "
              f"{batches[prec]} {prec} batches")
    # fp32 convs write float rows; int8 convs quantize in the patch kernel
    convs = len(loaded.convs)
    for kname, prec in (("conv_patches_cuda", "fp32"),
                        ("conv_patches_q8_cuda", "int8")):
        check(launches[kname] == convs * batches[prec],
              f"{kname} launches {launches[kname]} != {convs} x "
              f"{batches[prec]} {prec} batches")
    check(reduce_launches == res["reduce_launches_expected"],
          f"split reductions {reduce_launches} != "
          f"{res['reduce_launches_expected']}")
    check(res["labels_match_dense"], "served labels differ from the dense "
                                     "reference's")
    bad = [r["layer"] for r in parity if r["rel"] > LAYER_TOL]
    check(not bad, f"layers {bad} differ from the CPU plain path")
    check(res["e2e_rel_vs_cpu"] <= E2E_TOL,
          f"served logits differ from the CPU plain path by "
          f"{res['e2e_rel_vs_cpu']} (relative) > {E2E_TOL}")
    check(stats_exact, "accumulated skip statistics != one-shot forward")
    check(res["alone_vs_cobatched_bit_identical"],
          "logits served alone differ from co-batched")
    check(res["int8_alone_vs_cobatched_bit_identical"],
          "int8 logits served alone differ from co-batched")

    # -- 5b. the sharded path ------------------------------------------
    shard = shard_phase(seed, dev, loaded, prog8, images)
    for kname in ("pattern_spmm_cuda", "pattern_spmm_quant_cuda"):
        launches[kname] += shard["launches"][kname]

    # -- 6. the mapping search, served and priced -----------------------
    searched = search_phase(seed, cfg, params, tparams, bits, images,
                            labels32, loaded, dev)
    max_err["pattern_spmm_cuda"] = max(max_err["pattern_spmm_cuda"],
                                       searched["max_abs_err"])

    # -- 7. the paper's flow: train, pattern-prune, certify, serve -------
    pruned = prune_phase(seed, dev)
    for kname, n in pruned["launches"].items():
        launches[kname] += n
        max_err[kname] = max(max_err[kname], pruned["max_abs_err"][kname])

    # -- 8. ou_mvm on every conv's weight at real inputs ----------------
    ou = ou_mvm_phase(loaded, params, images, dev)
    launches["ou_mvm_cuda"] = ou["launches"]
    max_err["ou_mvm_cuda"] = ou["max_abs_err"]

    # -- 9. flash attention against its plain version, on the card ------
    fl = flash_phase(dev, GEN_SCFG["max_seq"])
    max_err["flash_attention_cuda"] = fl["max_abs_err"]

    # -- 10. token generation, every prefill through the flash kernel ---
    launches["flash_attention_cuda"] = (
        generate_phase(seed, dev)["launches"]
        + shard["launches"]["flash_attention_cuda"])

    # -- 10b. MoE, MLA, the MTP head: the four configs they unlock -------
    launches["flash_attention_cuda"] += lm_configs_phase(seed,
                                                         dev)["launches"]

    # -- 10c. the SSM mixer, the encoder and cross-attention --------------
    sw = ssm_whisper_phase(seed, dev)
    launches["flash_attention_cuda"] += sw["launches"]
    max_err["flash_attention_cuda"] = max(max_err["flash_attention_cuda"],
                                          sw["max_abs_err"])

    # -- 10d. the VLM prefix: paligemma-3b whole, flash at D 256 ----------
    vlm = vlm_phase_run(seed, dev)
    launches["flash_attention_cuda"] += vlm["launches"]
    max_err["flash_attention_cuda"] = max(max_err["flash_attention_cuda"],
                                          vlm["max_abs_err"])

    # -- 10e. training: danube trained, its restart drill, then served ---
    tr = train_phase(seed, dev)
    launches["flash_attention_cuda"] += tr["launches"]
    max_err["flash_attention_cuda"] = max(max_err["flash_attention_cuda"],
                                          tr["max_abs_err"])

    # -- 10f. sharded training: ZeRO-1 on a 2 x 2 mesh, restore, GPipe ---
    shard_train = train_shard_phase(seed, dev)

    # -- 10g. the serving launcher and the example twins, as users run them
    launches["flash_attention_cuda"] += entry_points_phase(dev)["launches"]

    # -- 10h. the dry run held against the card: op statistics, placed
    # serving, production cells ------------------------------------------
    dr = dryrun_phase(seed, dev, shard_train, tr["peak_memory_bytes"]
                      if dev.type == "cuda" else None)
    launches["flash_attention_cuda"] += dr["launches"]
    max_err["flash_attention_cuda"] = max(max_err["flash_attention_cuda"],
                                          dr["max_abs_err"])
    launches["pattern_spmm_cuda"] += dr["spmm_launches"]
    max_err["pattern_spmm_cuda"] = max(max_err["pattern_spmm_cuda"],
                                       dr["spmm_max_abs_err"])

    # -- 11. times at the main paths' shapes -----------------------------
    summary = []
    per_layer = {}
    for kname in ("pattern_spmm_cuda", "pattern_spmm_quant_cuda"):
        meta = KERNELS[kname]
        peak = (PEAK_FP32_FLOPS if kname == "pattern_spmm_cuda"
                else PEAK_INT8_OPS)
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bytes": 0.0, "ops": 0.0}
        rows = []
        for name, bp, x in cases[kname]:
            kernel, plain_call = calls(kname, bp, x, dev)
            ms = device_ms(kernel, dev)
            plain = device_ms(plain_call, dev)
            lib_ms = None
            if kname == "pattern_spmm_cuda":
                wd = bp.dense()[:, torch.as_tensor(bp.new_order, device=dev)
                                .long()].contiguous()
                lib_ms = device_ms(lambda: x @ wd, dev)
                tot["library_ms"] += lib_ms
            nbytes, ops = cost(kname, bp, x.shape[0])
            tot["ms"] += ms
            tot["plain_ms"] += plain
            tot["bytes"] += nbytes
            tot["ops"] += ops
            row = {"layer": name, "m": x.shape[0], "k": bp.k_in,
                   "n": bp.n_out, "bricks": int(bp.nnz.sum()),
                   "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                   "bytes": nbytes, "ops": ops}
            row.update(spmm_plan(kname, bp, x.shape[0]),
                       bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                    ops / peak) * 1e3)
            if kname == "pattern_spmm_cuda":
                row["tflops"] = ops / (ms * 1e-3) / 1e12
            else:
                row["tops"] = ops / (ms * 1e-3) / 1e12
                row["gb_per_s"] = nbytes / (ms * 1e-3) / 1e9
            rows.append(row)
        bytes_ms = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = tot["ops"] / peak * 1e3
        per_layer[kname] = rows
        summary.append({
            "name": kname, **meta,
            "launches": launches[kname],
            "max_abs_err": max_err[kname],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": (tot["library_ms"] if kname == "pattern_spmm_cuda"
                           else None),
        })
    ou_rows_t, ou_tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                             "bytes": 0.0, "ops": 0.0}
    for name, x, w, r, c in ou["cases"]:
        ms = device_ms(lambda: tou.ou_mvm_cuda(x, w, r, c), dev)
        plain = device_ms(lambda: tou.ou_mvm_plain(x, w, r, c), dev)
        lib_ms = device_ms(lambda: x @ w, dev)
        nbytes, ops = ou_cost(x, w, r)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                       ("bytes", nbytes), ("ops", ops)):
            ou_tot[key] += v
        ou_rows_t.append({"case": name, "r": w.shape[0], "c": w.shape[1],
                          **ou_plan(x, w, r),
                          "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                          "bytes": nbytes, "ops": ops,
                          "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                          "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                          ops / PEAK_FP32_FLOPS) * 1e3})
    per_layer["ou_mvm_cuda"] = ou_rows_t
    bytes_ms = ou_tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = ou_tot["ops"] / PEAK_FP32_FLOPS * 1e3
    summary.append({
        "name": "ou_mvm_cuda", **KERNELS["ou_mvm_cuda"],
        "launches": launches["ou_mvm_cuda"],
        "max_abs_err": max_err["ou_mvm_cuda"],
        "ms": ou_tot["ms"], "plain_ms": ou_tot["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ou_tot["library_ms"],
    })
    fl_rows, fl_tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                           "bytes": 0.0, "ops": 0.0}
    for c in fl["cases"]:
        q, k, v, n = c["q"], c["k"], c["v"], c["kv_len"]
        hq, hkv, d = c["heads"]
        window = c["window"]
        kw = dict(causal=True, window=window, kv_len=n)
        qpos = torch.arange(n, device=dev)[:, None]
        kpos = torch.arange(k.shape[2], device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos < n)
        if window is not None:
            mask &= kpos > qpos - window

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)

        ms = device_ms(lambda: tfa.flash_attention_cuda(q, k, v, **kw), dev)
        plain = device_ms(lambda: tfa.flash_attention_plain(q, k, v, **kw),
                          dev)
        lib_ms = device_ms(sdpa, dev)
        lib_diff = float((sdpa().float() - tfa.flash_attention_plain(
            q, k, v, **kw).float()).abs().max())
        nbytes, ops = flash_cost(1, hq, hkv, n, n, d, 2, True, window)
        for key, val in (("ms", ms), ("plain_ms", plain),
                         ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", ops)):
            fl_tot[key] += val
        fl_rows.append({
            "case": c["case"], "model": c["model"],
            "route": flash_route(c["dtype"]),
            "q": list(q.shape), "k": list(k.shape),
            "kv_len": n, "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
            "library_max_abs_diff_vs_plain": lib_diff,
            "bytes": nbytes, "ops": ops, "visible_pairs_per_head": int(
                ops / (4 * d * hq)), "tflops": ops / (ms * 1e-3) / 1e12,
            "bound_ms_bf16": max(nbytes / HBM_BYTES_PER_S,
                                 ops / PEAK_BF16_FLOPS) * 1e3,
            "bound_ms_fp32_cuda_cores": max(nbytes / HBM_BYTES_PER_S,
                                            ops / PEAK_FP32_FLOPS) * 1e3})
    per_layer["flash_attention_cuda"] = fl_rows
    bytes_ms = fl_tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = fl_tot["ops"] / PEAK_BF16_FLOPS * 1e3
    summary.append({
        "name": "flash_attention_cuda", **KERNELS["flash_attention_cuda"],
        "launches": launches["flash_attention_cuda"],
        "max_abs_err": max_err["flash_attention_cuda"],
        "ms": fl_tot["ms"], "plain_ms": fl_tot["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": fl_tot["library_ms"],
    })
    # the conv patches per forward of BATCH_SLOTS images, then per layer
    # at the benchmark's two served shapes, each held to its plain version
    pt_rows = patch_times(pcases, dev)
    per_layer["conv_patches_cuda"] = pt_rows
    bench_patches = {}
    for name, hw, batch in PATCH_SHAPES:
        bcases = vgg16_patch_cases(hw, batch, dev, seed + 6)
        bad = [c[0] for c in bcases if not patch_check(*c)["ok"]]
        check(not bad, f"conv_patches_cuda differs from its plain version "
                       f"at {name}'s {bad}")
        bench_patches[name] = patch_times(bcases, dev)
        del bcases
    nbytes = sum(r["bytes"] for r in pt_rows)
    summary.append({
        "name": "conv_patches_cuda", **KERNELS["conv_patches_cuda"],
        "launches": launches["conv_patches_cuda"],
        "max_abs_err": max_err["conv_patches_cuda"],
        "ms": sum(r["ms"] for r in pt_rows),
        "plain_ms": sum(r["plain_ms"] for r in pt_rows),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    })
    # the int8 patch rows the same way, beside the route they replaced
    q8_rows = patch_q8_times(pcases, dev)
    per_layer["conv_patches_q8_cuda"] = q8_rows
    bench_q8 = {}
    for name, hw, batch in PATCH_SHAPES:
        bcases = vgg16_patch_cases(hw, batch, dev, seed + 7)
        bad = [c[0] for c in bcases if not patch_q8_check(*c)["ok"]]
        check(not bad, f"conv_patches_q8_cuda differs from its plain "
                       f"version at {name}'s {bad}")
        bench_q8[name] = patch_q8_times(bcases, dev)
        del bcases
    nbytes = sum(r["bytes"] for r in q8_rows)
    summary.append({
        "name": "conv_patches_q8_cuda", **KERNELS["conv_patches_q8_cuda"],
        "launches": launches["conv_patches_q8_cuda"],
        "max_abs_err": max_err["conv_patches_q8_cuda"],
        "ms": sum(r["ms"] for r in q8_rows),
        "plain_ms": sum(r["plain_ms"] for r in q8_rows),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    })
    # the searched program's bricks through the fp32 kernel, per forward
    searched_spmm = {"ms": 0.0, "bound_ms": 0.0}
    for name, bp, x in layer_cases(searched["program"],
                                   np.random.default_rng(seed + 5), dev):
        kernel, _ = calls("pattern_spmm_cuda", bp, x, dev)
        searched_spmm["ms"] += device_ms(kernel, dev)
        nbytes, ops = cost("pattern_spmm_cuda", bp, x.shape[0])
        searched_spmm["bound_ms"] += max(nbytes / HBM_BYTES_PER_S,
                                         ops / PEAK_FP32_FLOPS) * 1e3
    x8 = images[:BATCH_SLOTS]
    fwd32 = make_forward(loaded, device=dev)
    fwd8 = make_forward(prog8, device=dev)
    forward_ms = {"fp32": host_ms(lambda: fwd32(x8)),
                  "int8": host_ms(lambda: fwd8(x8))}
    # the same trace through a service that does not collect skip
    # statistics: what the per-batch statistics cost end to end
    bare = InferenceService(loaded, batch_slots=BATCH_SLOTS, device=dev)
    bare.warmup()
    bare_s = serve_bursts(bare, [Request(image=img) for img in images])
    service_without_stats = {
        "requests_per_s": n32 / bare_s,
        "latency_p50_s": bare.metrics["latency_p50_s"],
        "latency_p99_s": bare.metrics["latency_p99_s"]}
    emit("times", card=smi, unit=f"spmm: ms per forward of {BATCH_SLOTS} "
         f"images ({spmms} launches), summed over layers; ou_mvm: ms per "
         f"call, summed over the {len(ou['cases'])} conv cases, GB/s of its "
         f"bytes (HBM {HBM_BYTES_PER_S / 1e12} TB/s); flash: ms "
         f"per launch of the prefill's call at S in {list(FLASH_PATH_S)} "
         f"(h2o-danube), {list(LM_DENSE_PROMPTS)} (qwen2.5-32b) and "
         f"prefix_len + {list(VLM_PROMPTS)} (paligemma-3b), summed; its "
         f"bound at the bf16 tensor cores' rate; conv patches: ms per "
         f"forward of {BATCH_SLOTS} images, summed over the convs, and per "
         f"conv at {[s[0] for s in PATCH_SHAPES]}'s shapes, its bound its "
         f"bytes at HBM bandwidth; int8 conv patches the same, beside the "
         f"float rows' route they replaced (float_rows_ms)",
         per_layer=per_layer, searched_fp32_spmm_per_forward=searched_spmm,
         conv_patches_at_benchmark_shapes=bench_patches,
         conv_patches_q8_at_benchmark_shapes=bench_q8,
         flash_by_model={
             m: {key: sum(r[key] for r in fl_rows if r["model"] == m)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms_bf16")}
             for m in sorted({r["model"] for r in fl_rows})},
         forward_ms=forward_ms,
         service_without_stats=service_without_stats,
         spmm_share_of_forward={
             "fp32": summary[0]["ms"] / forward_ms["fp32"],
             "int8": summary[1]["ms"] / forward_ms["int8"]})
    return {"smi": smi, "kind": kind, "kernels": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    res = run(args.seed, torch.device("cuda", 0))
    if torch.distributed.is_initialized():  # the shard phase's own group
        torch.distributed.destroy_process_group()
    print(res["smi"])
    print(json.dumps({"kernels": res["kernels"]}, default=_jsonable))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": res["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
