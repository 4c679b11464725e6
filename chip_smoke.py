#!/usr/bin/env python3
"""Drive the PyTorch port (parrot_tts_tpu_torch) on one CUDA card and
check it. Run from the root of the checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: name and power limit (nvidia-smi), torch / CUDA versions, TF32 flags;
2. build: the five kernel sources in csrc/ with nvcc (sm_90a), one nvcc
   per source in parallel, with each one's ptxas register and spill report
   (phases 3, 5 and 10 repeat those of the two attention forwards and of
   every fused-MRF instantiation; phase 5 fails on a fused-MRF spill);
3. flash attention against plain: the flash-attention forward (row 1;
   every kernel of its source has its ptxas registers printed, and a
   spill fails the phase) in its 3xTF32 mode (two kernels: a pre-pass
   writes K and V^T split into TF32 hi and lo planes in wgmma's tile
   layout, bit-equal to its plain version; the kernel on wgmma, 3xTF32
   products summed in short partials that IEEE float32 adds, IEEE float32
   softmax) against its IEEE float32 plain PyTorch version, H=2,
   d_head=128, at B=8 and T up to 3584 (with key padding, one all-masked
   row and a ragged T), at every (B, T) the serving phase gives it, a
   d_head=64 case and (64, 2048, 128), phase 4's full decode batch; max
   |diff| <= 1e-5 on rows with a valid key, all-masked rows exactly 0; the
   mode's ms and each kernel's alone, plain, bound (the 3xTF32
   tensor-core bound beside the float32 CUDA-core one), the pre-pass's
   bound and scaled_dot_product_attention ms (and its max |diff|) per
   shape; and at every shape the 1-pass TF32 mode (its own two kernels: a
   pre-pass writes K and V^T rounded to TF32, bit-equal to its plain
   version; the kernel on wgmma) against its plain version, which rounds
   q, k, P (tile by tile, against the running row max) and v where the
   kernel does (max |diff| <= 2^-10 max |v| + 1e-5, RMS <= 1/4 of the
   plain version's RMS distance from IEEE, all-masked rows exactly 0),
   more than 1e-5 from the IEEE version (so it rounds), the mode's ms and
   each kernel's alone, the TF32 bound, the pre-pass's bound and SDPA's ms
   with TF32 allowed;
4. serving at full width: the default TTEModelConfig (d_model 256, 4+4 FFT
   blocks, 2 heads of 128) and V1 VocoderModelConfig with seeded weights,
   through ParrotTTS.tts twice in its default decode mode,
   "selective-high" (IEEE float32 on this card, as exact=True;
   deterministic, lengths len(units)*320, finite, the
   kernel launched once per FFT block per decode batch), then the same
   decode batches once more in exact=True with plain attention on the
   card: durations and totals equal, max |dlogit| <= 1e-4, codes equal
   wherever the top-2 logit margin exceeds 1e-3. Then the decode modes:
   the plan through ParrotTTS.predict_units in exact=True,
   "selective-high", "selective" and "hybrid" (row 1's launches per mode,
   each mode's counts per FFT block and decode batch: no 1-pass launch in
   exact=True and "selective-high", "selective"'s decoder blocks all
   1-pass and its encoder blocks 3xTF32, the hybrid as "selective" plus
   its re-decode, one pre-pass of its mode per launch; each repeatable;
   TTE seconds per mode over 3 warm
   decodes, CUDA events, beside the card's name and power limit), and each
   decode batch's logits: "selective-high" bit-equal to exact=True (near-tie
   frames counted), two decodes bit-equal, its units those of the default
   serve; "selective" with durations and totals equal, its code agreement
   printed, and every request whose units differ from exact=True's with a
   top-2 margin below 0.5; "hybrid": flagged requests (margin < 0.5) give
   "selective-high"'s units, the others "selective"'s, the flagged share
   printed;
5. fused MRF against plain: the fused-MRF kernel (row 6: 3xTF32 products
   on the TF32 tensor cores, wgmma m64nCk8 with A from registers, TF32
   hi / lo weight slabs of one k-step through an mbarrier ring of bulk
   copies, sums carried in the accumulators) at every (B, T, C) the
   fused serve gives it (the 64-, 32- and 16-channel stages of each vocoder
   batch), a ragged T and a batch whose rows end at different lengths; max
   |diff| <= 1e-5 * max |plain|; each stage's tile (rows, units, weight
   slots, taps a sum is carried over, recompute factor); kernel, plain
   (cuDNN IEEE float32), the unfused cuDNN float32 composition of the
   serve's own resblocks (the library yardstick) and both bounds (3xTF32
   tensor cores, the kernels line's; float32 CUDA cores) ms per launch,
   summed per stage C and per serve; then the float32 mode at every width
   it takes, 8-120, at (2, 16387) (`phase_mrf_widths`: the same gate, two
   launches bit-equal, tile, ms and share of the 3xTF32 bound);
6. int8 conv against plain: the int8 conv kernel at every distinct site
   shape of every int8-static and "int8" vocoder batch, with that batch's
   rows (5 polyphase upsamples, the MRF convs at k 3/7/11 and dilation
   1/3/5 with the leaky epilogue and without it), each with the scale the
   serve passes: the int8-static serve's per-channel scale broadcast over
   the batch, the dynamic serves' per-row (B, Co) scales ("int8-tail"'s
   sites are a subset of "int8"'s), bit-identical; kernel, plain and bound
   ms (the kernel's device time per launch of launches queued ahead of
   the device, and the launch-to-launch time, both from CUDA events), the
   kernel's share of its bound and the plan's branch ("tma", or
   "padded" where an operand goes through a workspace), tile and ring per
   site; the same at every distinct site of bench.py's batch as the int8
   serves launch it (64 x 256 codes); per serve of each mode the kernel's
   total beside the kernel's it replaced (INT8_SERVE_MS_BEFORE), and by
   stage (Ci) against its bound; a launch's fixed cost (INT8_FIXED_SITES
   at T_out = 1, queued);
7. fused serve: ParrotTTS with VocoderModelConfig(fused_mrf=True) on the
   same requests and weights: waveforms within 1e-5 of phase 4's, 3 fused
   launches per vocoder batch, each at a shape phase 5 checked;
8. int8-static serve: ParrotTTS with VocoderModelConfig(quant="int8-static"),
   calibrated explicitly on a batch built from the serve's own units, served
   twice: deterministic, lengths len(units)*320, finite, 95 int8 conv
   launches per vocoder batch, each at a shape phase 6 checked, SNR >= 15
   dB against phase 4's waveforms over all requests and for each one;
8b. dynamic int8 serves: ParrotTTS with quant="int8" and with
   quant="int8-tail" on the same requests and weights, each served twice:
   deterministic, lengths len(units)*320, finite, 95 and 56 int8 conv
   launches per vocoder batch, each at a shape phase 6 checked with
   per-row scales, SNR >= 15 dB against phase 4's waveforms over all
   requests and for each one; then the dynamic int8 conv on the card is
   batch-invariant: a quiet row alone and beside a loud row gives the same
   bits;
9. profile: one more float serve, fused serve, int8-static serve and
   "int8" serve under torch.profiler (device time by kernel, the device's
   busy and idle share, the row-6 and row-7 kernels' device time per
   serve);
10. flash attention with dropout against plain: the forward (wgmma and
   TMA on bf16 operands cast once, two passes over K), dQ (with the
   D = rowsum(dO . O) and the keep bits it writes) and dK/dV kernels (rows
   2-4) at B=6, H=2, d_head 128 and every T the training phase gives them
   (128, 256, 512, 1024, 2048, 3584), a ragged T and a d_head 64 case, each
   with a row whose keys are all padded, at p = 0 and 0.1 on the same mask
   (max |diff| <= 2^-8 of max |plain|, rms <= 1e-4 of rms); dQ's keep bits
   equal to the plain mask's; a second dQ and dK/dV launch on the same
   inputs gives the same bits (determinism); the keep-mask kernel (row 5)
   bit-identical to its plain Philox and its keep rate within 5 sigma of
   0.9; kernel, plain, bound and scaled_dot_product_attention ms, the
   forward, dQ and dK/dV at p = 0 beside p = 0.1, the forward and the
   backward as training runs them (the autograd function: the forward's
   q, k, v casts and kernel; the backward's dO cast, dQ, dK/dV) at both p,
   per launch and per (256, 3584) micro-step beside SDPA's, and the
   registers and spills of every kernel of csrc/flash_dropout.cu from
   phase 2;
11. training at full width: TTEModelConfig(n_speaker=4) and TTETrainConfig
   defaults (warmup 0, so the first update moves the weights) through
   pipeline/train_tte.run for 2 optimizer steps (8 micro-batches, bucket
   pairs (128, 1024) and (256, 3584)) on a seeded synthetic corpus: finite
   losses, weights changed at micro-steps 4 and 8 only, 8 launches of each
   of rows 2-4 per micro-step at shapes phase 10 checked, evaluation
   attention (row 1) at shapes phase 3 checked, the checkpoint equal to the
   live state bit for bit and a resumed run carrying on from micro-step 8;
   then one (256, 3584) micro-batch at dropout 0 with the kernels against
   plain attention at the seeded initial weights that training starts from
   (a state that is the same in every run; deterministic algorithms; the
   kernel pass taken twice must give the same bits): loss within 1e-5,
   |dg|/|g| <= 1e-3, each tensor's max |dg| <= 1e-2 of its max |g|;
12. profile: one training micro-step at (256, 3584) under torch.profiler,
   and micro-steps per second over one optimizer step (a reading);
13. GEMM against plain: the row-8 kernel at the int8 experiment's (8192,
   4096, 4096) in int8 and bf16, at a ragged (1000, 1000, 1000) and a
   small (17, 33, 9) in int8, bf16 and float32: int8 equal, bf16 and
   float32 within MM_RTOL * sqrt(K) of max |plain|, each with the plan's
   route and branch (the ragged shapes take the padded branch); kernel
   (its rate and share of the bound), plain, bound and torch._int_mm /
   torch.matmul ms at the rate shape, and the int8 B^T pass alone; then
   the ported int8 experiment (`python -m parrot_tts_tpu_torch.scripts.exp_int8_rate`)
   parts 1 and 2 with few repetitions, its GEMM launches counted;
14. vocoder GAN training at full width (no TPU kernel lies on its path):
   the V1 VocoderModelConfig and VocoderTrainConfig() defaults (batch 16,
   segments of 8960 samples) through pipeline/train_vocoder.run for 4
   steps on a seeded corpus (32 + 4 wavs of 1-1.6 s over two speakers,
   random units at 50 per second): finite losses, every tensor of the
   generator, the MPD and the MSD changed at every step, the MSD scale-0
   power-iteration vector advanced, the validation mel error logged, the
   checkpoint equal to the live state bit for bit, a resumed run carrying
   on from step 4; then one step from the seeded initial state under
   exact_numerics(True) and deterministic algorithms, taken twice in
   float32 (the same bits required) and once in float64: losses within
   1e-4, |dg|/|g| <= 1e-3 per network, each tensor's max |dg| <= 1e-2 of
   its max |g|; GAN steps per second over 5 warm steps (CUDA events) and
   one profiled step (readings, TF32 as training runs). Then the manifest
   entry points on phase 4's TTE: write_predictions on every non-empty
   request gives the serve's units, and synthesize_text a finite waveform
   of len(units) * 320 samples;
15. HuBERT unit extraction at base width (no TPU kernel on its path): the
   default HubertConfig (7 convs of 512, 12 post-LN layers of 768, output
   layer 11) with seeded random weights and 1000 k-means centers drawn
   from a first pass's features (seeded frames plus noise), through
   pipeline/extract_units.extract_units_corpus on a seeded corpus of 60
   speech-like wavs of 0.5-38.3 s over two speakers and one of 100.5 s
   (the chunk path): feat_extract_output_length codes per wav, all in
   [0, 1000); a second pass, defer_readback and upload_thread=False give
   the same bits; each wav alone at its exact length gives its codes
   from the padded batches wherever the nearest-centroid margin exceeds
   1e-4 |x|^2 (frames below it counted); one batch in float32 against
   float64 on the card (max |df|/|f| <= 1e-4, codes equal above the
   margin); audio-s/s over the corpus, the positional conv's time and one
   profiled batch (readings);
16. f0 on the card (no TPU kernel on its path): estimate_f0 on the card
   against the CPU on tests/test_f0.py's sine, chirp, silence and noise
   fixtures, with interp off and on (voicing equal, voiced f0 within
   1e-2 Hz); an f0-conditioned V1 vocoder (model_in_dim 2E + 1) serving
   phase 4's units with f0_for_codes tracks of phase 15's wavs, in float
   and "int8", each twice: deterministic, len(units) * 320 samples,
   finite, and half the f0 changes exactly the waveforms whose track has
   a voiced frame; int8-static refuses f0; two f0 GAN steps at
   VocoderTrainConfig() defaults through pipeline/train_vocoder.run on
   phase 14's corpus (finite losses, conv_pre's f0 input column with a
   gradient and moved), the checkpoint equal to the live generator and a
   resume;
17. the offline supervision pipeline at reference width (no TPU kernel on
   its path), on phase 15's wavs up to 40.96 s and its units, with seeded
   English transcripts of ~12.5 characters per second: clean_corpus and
   compute_mels_and_tokens on the card (the top bucket pair (2048, 512)
   reached, every row feasible for CTC); pipeline/train_aligner at the
   default AlignerModelConfig / AlignerTrainConfig (checkpoints and text
   artifacts every 2 steps) crashing at step 3 and resumed to step 4;
   then, on a batch of 16 rows of the top pair, one step in float32
   against float64 (loss within 1e-4 relative, |dg|/|g| <= 1e-3), two
   float32 steps and the CTC's eager loops against its CUDA graphs, all
   the same bits under torch.use_deterministic_algorithms(True), and a
   NaN frame's step changing no parameter, BN statistic, moment or count;
   ms per step (CUDA events), the CTC's share, torch's
   F.ctc_loss as a yardstick and one profiled step (readings);
   extract_all_durations in dijkstra and beam modes (durations summing to
   the frames; items/s, device and DP seconds), the card's durations
   against the CPU port's on the same weights (equal but where the
   best-path margin is <= 1e-4, such items counted);
   build_tte_manifests over phase 15's units (every line's durations sum
   to its units); and `python -m parrot_tts_tpu_torch.cli
   run-aligner-pipeline` on three short wavs per speaker, exit 0;
18. the mesh (core/mesh.py, parallel/tensor.py). NCCL refuses two ranks
   on one GPU, so NCCL runs at world size 1 in this process: phase 4's
   serve with mesh= bit-equal to it without, and one TTE optimizer step
   at (128, 1024) under the group bit-equal to the step without it. Then
   2 gloo processes on the one card (`mesh_worker`, joined within
   MESH_DEADLINE_S or killed), full width: sharded serving of phase 4's
   requests and of 64 rows of the (128 -> 2048) bucket (units equal to
   one process's exact=True decode; waveforms bit-equal to each shard's
   rows served solo and within 1e-5 of the unsharded serve); 2 TTE
   optimizer steps at (128, 1024), 6 rows per rank, at dropout 0 (IEEE)
   and 0.1 (TF32) against one process on the 12 rows (losses within
   1e-5; at 0 the first summed gradient within 1e-5 |dg|/|g| of one
   process's sum over the same shards, and within phase 11's 1e-3 / 1e-2
   of the 12-row gradient; at 0.1 the dQ kernel's keep bits gathered
   over the ranks equal to one process's; parameters bit-equal across
   the ranks); 2 V1
   GAN steps, 8 rows per rank, against one process on 16 (phase 14's
   tolerances; parameters and spectral-norm vectors bit-equal across the
   ranks); the TP=2 decode (one head, half the filters and codes per
   rank) against the replicated decode; every rank launching rows 1-4;
   then `synthesize --mesh` through the CLI, its files equal to those
   without --mesh; readings: ms per 2-rank micro-step and GAN step, the
   gloo all-reduce's ms and share of the micro-step;
19. the bf16 compute modes, full V1 width, phase 4's requests and weights:
   row 6's bf16 mode (bf16 wgmma) against its bf16 plain version at every
   (B, T, C) of the bf16 fused serve (max |diff| <= 2^-6 max |plain|,
   mismatched elements counted; no spill in its instantiations; kernel,
   plain, bound and the unfused cuDNN bf16 composition's ms), and at every
   width it takes (8 to 120 by 8) at (2, 16387), two launches bit-equal,
   with its ms and share of the bound; the bf16 fused vocoder at V1's
   rates and 256 channels (fused stages 64, 32, 16, 8) on phase 4's units
   against its bf16 unfused serve (4e-3 / 33 dB) and its float32 fused
   serve (2e-3 / 33 dB); row 7 with
   a bf16 output against its plain version, bit for bit, at every site of
   the bf16 "int8" and "int8-tail" serves (the bf16 int8-static serve's
   int8 convs write float32, phase 6's sites), with the cuDNN bf16 conv
   of each site as a yardstick; ParrotTTS with the bf16 vocoder in every
   mode (float, fused, int8-static, "int8", "int8-tail"), each served
   twice, bit-equal, every fused and int8 launch at a shape checked here
   or in phase 6: the float and fused serves within 2e-3 max |dev| and
   33 dB SNR of phase 4's float32 waveforms (scripts/tpu_parity_check.py's
   budgets; its log-mel L1 < 0.3 printed beside the float32 waveforms'
   own bf16 rounding, BF16_MEL_L1's comment), the int8 modes >= 15 dB over
   all requests and for the worst, the fused against the unfused within
   4e-3 / 33 dB; batch invariance in bf16 (the dynamic int8 conv and a
   float serve's row alone and in a batch; readings); profiles of the
   bf16 float, int8-static and "int8" serves; readings at
   tpu_parity_check.py's fidelity setup (2 x 96 codes, int8-static
   calibrated on 4 x 120 at margins 1.0 and 1.25) and at bench.py's batch
   (64 x 250 codes, float32 and bf16 in every mode: ms per batch, median
   and spread of 5, and the busy time of a profiled batch); 2 GAN steps
   with a bf16 generator through pipeline/train_vocoder.run on phase 14's
   corpus (finite, every network moves, float32 parameters and moments,
   the checkpoint holds the live state), its ms per step beside phase
   14's and its |dg|/|g| against the float32 step's; and
   HubertConfig(dtype="bfloat16") refused.

The second-to-last stdout line is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
from unittest import mock

# cuBLAS's workspace pinned before the first CUDA call: cuDNN's LSTM
# backward (phase 17) repeats bit for bit only with it, and
# torch.use_deterministic_algorithms(True) refuses cuBLAS without it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 20261016
FP32_PEAK = 67e12            # H100 SXM float32 non-tensor FLOP/s (data sheet)
INT8_PEAK = 1979e12          # H100 SXM int8 dense tensor-core OP/s (data sheet)
HBM_RATE = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
ATOL = 1e-5
# row 1's 1-pass mode against its plain version: both take exact products
# of the same TF32 values (q, k, v, and P rounded tile by tile against the
# running row max), and differ by float32 sums in another order, which
# sends the rare weight to the neighbouring TF32 value (<= 2^-10 of it;
# the weights sum to the divisor): max |diff| <= 2^-10 max |v| + ATOL.
# That rare flip is all: the RMS of the difference stays below
# ONE_PASS_RMS_SHARE of the plain version's RMS distance from IEEE, where
# a kernel that truncated P or ran its 3xTF32 mode would read ~1
# (tests/test_torch_kernels.py::test_one_pass_gate_tells_rounding_apart)
ONE_PASS_VREL = 2.0**-10
ONE_PASS_RMS_SHARE = 0.25
DLOGIT_TOL = 1e-4            # kernel decode against plain-attention decode
NEAR_TIE = 1e-3              # codes compared where the top-2 margin exceeds it
HYBRID_THRESHOLD = 0.5       # decode_buckets' default margin_threshold
DECODE_MODES = (True, "selective-high", "selective", "hybrid")
MODE_REPEATS = 3             # timed warm decodes of the plan per mode
MRF_RTOL = 1e-5              # fused MRF: max |diff| <= MRF_RTOL * max |plain|
FUSED_SERVE_ATOL = 1e-5      # fused serve against the float serve
SNR_MIN_DB = 15.0            # int8-static serve against the float serve: the
                             # JAX package's envelope for random weights
# int8 convs per V1 vocoder batch: every conv between conv_pre and
# conv_post; "int8-tail" only the 64-, 32- and 16-channel stages' MRF convs
# (3 x 18) and the two upsamples after the first of them
INT8_SITES = {"int8-static": 95, "int8": 95, "int8-tail": 56}
# row 7's ms per serve of each mode, float32 and bf16 output, with the
# kernel design this one replaced (PERF.md section 6, the same phase on
# the same card)
INT8_SERVE_MS_BEFORE = {"int8-static": 8.3341, "int8": 8.5889,
                        "int8-tail": 5.5775}
INT8_SERVE_MS_BEFORE_BF16 = {"int8": 9.0351, "int8-tail": 5.9908}
# bench.py's vocoder batch as the int8 serves launch it: 64 rows in the
# 256-code bucket (BENCH_BATCH's 250 codes, padded); phase 6 gates its
# sites too
INT8_BENCH_BATCH = (64, 256)
# the sites whose fixed cost phase 6 reads (a launch at T_out = 1, queued):
# (Ci, Co, K, dilation) of a narrow MRF conv, a 64-channel one, a wide one
# and the first upsample
INT8_FIXED_SITES = ((16, 16, 3, 1), (64, 64, 11, 5), (256, 256, 11, 5),
                    (512, 1280, 3, 1))
INT8_CONV_KERNEL = "::conv_kernel<"   # csrc/int8_conv.cu's kernels, by name
MRF_KERNEL = "::mrf_kernel"           # csrc/fused_mrf.cu's kernels, by name
INT8_WARMUP, INT8_TIMED = 2, 10       # phase 6's launches per site
# the GEMM's bf16 and float32 results against plain: the same float32
# products summed in another order (tests/test_torch_kernels.py states why)
MM_RTOL = 1e-5
RATE_SHAPE = (8192, 4096, 4096)   # (M, K, N) of the int8 experiment
BF16_PEAK = 989e12           # H100 SXM bf16 dense tensor-core FLOP/s (data sheet)
TF32_PEAK = 494.7e12         # H100 SXM TF32 dense tensor-core FLOP/s (data sheet)
# flash attention with dropout (rows 2-4) against plain on the same mask:
# both round every product operand to bf16 at the same points and sum in
# float32 in another order, so a few operands land on the other bf16
# neighbour: max |diff| <= FD_MAX * max|plain|, rms diff <= FD_RMS *
# rms(plain), each floored at 1 (tests/test_torch_kernels.py states why)
FD_MAX, FD_RMS = 2.0**-8, 1e-4
FD_P = 0.1                   # the TTE's attention dropout
# (B, T, d_head) of phase 10, H=2: every (B, T) the training phase gives
# rows 2-4 (batch 6; encoder buckets 128/256, decoder 512-3584), a ragged
# T, a narrower head; every shape has a row whose keys are all padded
FD_SHAPES = ([(6, t, 128) for t in (128, 256, 512, 1024, 2048, 3584)]
             + [(6, 777, 128), (6, 512, 64)])
TRAIN_PAIRS = ((128, 1024), (256, 3584))   # phase 11's bucket pairs
# phase 11's training: the loss and gradients of one (256, 3584) micro-batch
# at dropout 0 with the kernels against plain attention, both IEEE float32
# elsewhere: the attention outputs differ by sparse bf16 re-roundings (rms
# 1e-4 of rms, phase 10) that the network carries through linearly
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3       # |dg| / |g| over all parameters
TRAIN_GRAD_MAX = 1e-2        # max |dg| <= this * max |g|, per tensor
# (B, T, d_head) checked against the plain version: B=8 across T (a ragged
# T among them), then the (B, T) of every attention call of the serving
# phase (its decode plan: encoder buckets 64/128/256, decoder 1024/2048/
# 3584, with 3, 5 and 1 requests), then those of the training phase's
# evaluation (batch 6 at its bucket pairs), then a narrower head
KERNEL_SHAPES = ([(8, t, 128) for t in (64, 128, 500, 768, 2048, 3584)]
                 + [(b, t, 128) for b, ts in ((3, (64, 1024)),
                                              (5, (128, 2048)),
                                              (1, (256, 3584))) for t in ts]
                 + [(6, t, 128) for pair in TRAIN_PAIRS for t in pair]
                 + [(8, 768, 64)])
REPORT_SHAPE = (5, 2048, 128)  # whose times go in the kernels line: the
                               # serving phase's largest decode batch
ONE_PASS_LARGE = (64, 2048, 128)   # (B, T, d) of phase 4's full decode
                                   # batch, "selective"'s 1-pass launches
TEXTS = [
    "Hello there, how are you today?",
    "",
    "The quick brown fox jumps over the lazy dog near the quiet river bank.",
    "Speech synthesis turns written text into spoken audio, one sound at a "
    "time, and a vocoder then renders the waveform.",
    "We measured it twice.",
    "A long request makes the decoder work at its largest bucket: it has to "
    "carry many characters, so this sentence keeps going for a while, past "
    "two hundred characters, until the encoder needs its third source bucket.",
    "Numbers like 42 and 1999 are spelled out by the cleaner first.",
    "Short and sweet, this one fits the smallest bucket of all the buckets.",
    "The last request of the batch asks for a medium length answer, with a "
    "few commas, some pauses, and a period at the end.",
]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of reps back-to-back launches of fn (CUDA events),
    with the host's enqueue cost hidden: a spin kernel holds the device
    while the launches are queued behind it. If the device reached the
    first event before the host had queued them all, the spin is made
    longer and the measurement taken again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 4_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the launches could not be queued ahead of the "
                         "device")


def attention_bound_ms(b: int, h: int, t: int, d: int) -> dict:
    """Row 1's bounds: its 3xTF32 products (3 * 4*B*H*T^2*d on the TF32
    tensor cores; the kernels line's bound), its 1-pass mode's (4*B*H*T^2*d
    on them), and the same work as float32 FMAs on the CUDA cores; Q, K, V
    read and O written once, mask bytes."""
    flops = 4.0 * b * h * t * t * d
    nbytes = 4.0 * (4 * b * h * t * d) + b * t
    return {"3xtf32": bound(3 * flops, TF32_PEAK, nbytes),
            "tf32": bound(flops, TF32_PEAK, nbytes),
            "f32": bound(flops, FP32_PEAK, nbytes)}


@contextlib.contextmanager
def recording(module, name: str, key):
    """Patch module.name with a wrapper that adds key(*args, **kwargs) of
    every call to the yielded set, then calls the real function."""
    seen: set = set()
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.add(key(*args, **kwargs))
        return real(*args, **kwargs)

    with mock.patch.object(module, name, spy):
        yield seen


def mrf_key(x, w, b, plan, wk=None) -> tuple:
    return tuple(x.shape)


def int8_key(xq, wt, scale, bias=None, *, pads, dilation=1, leaky=None,
             out_dtype=torch.float32) -> tuple:
    """(B, T, Ci, Co, K, dilation, pads, leaky, per_row, bf16) of an int8
    conv call; per_row: the (B, Co) scale is materialised per row, not one
    (Co,) vector broadcast over the batch; bf16: a bfloat16 output."""
    b, t, ci = xq.shape
    k, co, _ = wt.shape
    return (b, t, ci, co, k, dilation, tuple(pads), leaky,
            scale.stride(0) != 0, out_dtype == torch.bfloat16)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"tf32 flags at start: matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32} (the port turns both off"
          " around every exact=True forward)")
    return smi


def phase_build(kernels) -> dict:
    """Build every source; print and return each one's ptxas report."""
    t0 = time.perf_counter()
    logs = kernels.build("flash_attn_fwd", "fused_mrf", "int8_conv",
                         "flash_dropout", "int8_gemm")
    print(f"build (5 nvcc in parallel): {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "warning")):
                print(f"  {name}: {line.strip()}")
    return logs


def ptxas_registers(log: str) -> dict:
    """{kernel<D>: (registers, spill store bytes, spill load bytes)} of
    each templated kernel in one source's ptxas report (the fused MRF's as
    mrf_kernel<C> and, in bf16, mrf_kernel_bf16<C>)."""
    out, name = {}, None
    for line in log.splitlines():
        if "entry function" in line:
            m = re.search(r"(fwd|dq|dkv)_kernelILi(\d+)E", line)
            name = m and f"{m.group(1)}_kernel<{m.group(2)}>"
            m = re.search(r"(one|three)_pass\d+attn_kernelILi(\d+)E", line)
            if m:       # row 1's kernel of a mode, at D
                name = f"{m.group(1)}_pass::attn_kernel<{m.group(2)}>"
            m = re.search(r"prep_kernelILi(\d+)ELi(\d)E", line)
            if m:       # row 1's pre-pass at <D, planes>
                name = f"prep_kernel<{m.group(1)}, {m.group(2)}>"
            m = re.search(r"mrf_kernelILi(\d+)E", line)
            if m:       # the float32 mode at C
                name = f"mrf_kernel<{m.group(1)}>"
            m = re.search(r"mrf_kernel_bf16ILi(\d+)E", line)
            if m:       # the bf16 mode at C
                name = f"mrf_kernel_bf16<{m.group(1)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = (out.get(name, (0,))[0], int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m[1]),) + out.get(name, (0, 0, 0))[1:]
    return out


def print_registers(registers: dict) -> None:
    for name, (regs, st, ld) in sorted(registers.items()):
        print(f"ptxas {name}: {regs} registers, spill stores {st} bytes, "
              f"spill loads {ld} bytes")


def one_pass_gate(got, want, ieee, v) -> tuple[float, ...]:
    """Row 1's 1-pass output `got` against its plain version `want` and
    the IEEE version `ieee` (rows with a valid key): max |diff|, RMS diff
    and max |diff from IEEE|, and the max and RMS limits (ONE_PASS_VREL,
    ONE_PASS_RMS_SHARE)."""
    def rms(x):
        return float(x.pow(2).mean().sqrt())

    return (float((got - want).abs().max()), rms(got - want),
            float((got - ieee).abs().max()),
            ONE_PASS_VREL * float(v.abs().max()) + ATOL,
            ONE_PASS_RMS_SHARE * rms(want - ieee))


def prep_bound_ms(b: int, h: int, t: int, d: int,
                  parts: int = 1) -> tuple[float, str]:
    """A row-1 pre-pass's bound: k and v read once, the mask bytes, its
    tiles (`parts` planes each of K and V^T and the key bias, 2 * parts *
    D * BK + BK floats per 32-key tile) written once; one operation per
    element to round (parts 1), four to split (parts 2)."""
    from parrot_tts_tpu_torch.ops.flash_attention import BK

    tiles = b * h * -(-t // BK) * (2 * parts * d * BK + BK)
    return bound((2.0 if parts == 1 else 8.0) * b * h * t * d, FP32_PEAK,
                 8.0 * b * h * t * d + b * t + 4.0 * tiles)


def split_readings(fa, exact_numerics, q, k, v, mask, scale, want, keep,
                   masked_row, reps: int) -> dict:
    """Row 1's 3xTF32 mode at one shape (phase 3): its pre-pass bit-equal
    to its plain version; the mode (pre-pass and kernel) within ATOL of
    `want`, the IEEE float32 plain version, all-masked rows exactly 0; ms
    of the mode (calls back to back, as a decode makes them), of each
    kernel alone (queued) and of the plain versions, the 3xTF32, float32
    and pre-pass bounds, and SDPA's ms and max |diff| in float32."""
    b, h, t, d = q.shape
    with exact_numerics(True):
        kv = fa.split_operands(k, v, mask)
        kv_want = fa.split_operands_reference(k, v, mask)
        got = fa.flash_attention(q, k, v, mask, scale)
        torch.cuda.synchronize()
        if not torch.equal(kv, kv_want):
            raise AssertionError(f"B={b} T={t} d={d}: the 3xTF32 pre-pass "
                                 "differs from its plain version")
        del kv_want
        if masked_row is not None and not torch.equal(
                got[masked_row], torch.zeros_like(got[masked_row])):
            raise AssertionError(f"B={b} T={t}: all-masked row is not "
                                 "exactly 0")
        err = float((got[keep] - want[keep]).abs().max())
        if not err <= ATOL:
            raise AssertionError(f"B={b} T={t} d={d}: max |diff| {err} > "
                                 f"{ATOL}")
        del got
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask, scale), reps)
        # each kernel alone, queued ahead of the device
        kernel_ms = queued_ms(lambda: fa.split_attention(q, kv, scale), reps)
        prep_ms = queued_ms(lambda: fa.split_operands(k, v, mask), reps)
        plain_reps = max(2, reps // 4)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, mask, scale), plain_reps)
        prep_plain_ms = cuda_ms(lambda: fa.split_operands_reference(
            k, v, mask), plain_reps)
        attend = ~mask[:, None, None, :]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=attend, scale=scale)

        library_ms = cuda_ms(sdpa, reps)
        lib_err = float((sdpa()[keep] - want[keep]).abs().max())
    del kv
    bounds = attention_bound_ms(b, h, t, d)
    (bound_ms, bound_by), (f32_ms, f32_by) = bounds["3xtf32"], bounds["f32"]
    prep_bound, prep_by = prep_bound_ms(b, h, t, d, parts=2)
    print(f"kernel B={b} T={t:5d} d={d:3d}: max|diff| {err:.3e}  mode "
          f"{ms:.4f} ms = pre-pass {prep_ms:.4f} + kernel {kernel_ms:.4f} "
          f"(queued)  plain {plain_ms:.4f} ms  bound 3xTF32 {bound_ms:.4f} ms"
          f" ({bound_by}: {100 * bound_ms / ms:.1f}% of the mode, "
          f"{100 * bound_ms / kernel_ms:.1f}% of the kernel), float32 "
          f"{f32_ms:.4f} ms ({f32_by})  pre-pass bit-equal to its plain "
          f"version ({prep_plain_ms:.4f} ms), bound {prep_bound:.4f} ms "
          f"({prep_by})  sdpa {library_ms:.4f} ms (max|diff| {lib_err:.3e})")
    return {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "prep": {"ms": prep_ms, "plain_ms": prep_plain_ms,
                     "bound_ms": prep_bound, "bound_by": prep_by,
                     "max_abs_err": 0.0}}


def one_pass_readings(fa, exact_numerics, q, k, v, mask, scale, want, keep,
                      masked_row, reps: int) -> dict:
    """Row 1's 1-pass mode at one shape (phase 3): the pre-pass bit-equal
    to its plain version; the mode (pre-pass and kernel) against the plain
    version that rounds as it does (`one_pass_gate`) and against `want`,
    the IEEE version; all-masked rows exactly 0; ms of the mode (calls
    back to back, as a decode makes them), of each kernel alone (queued)
    and of the plain versions, the TF32 bound and the pre-pass's, and
    SDPA's ms with TF32 allowed."""
    b, h, t, d = q.shape
    with exact_numerics(True):
        kv = fa.one_pass_operands(k, v, mask)
        kv_want = fa.one_pass_operands_reference(k, v, mask)
        got = fa.flash_attention(q, k, v, mask, scale, passes=1)
        plain = fa.flash_attention_reference(q, k, v, mask, scale, passes=1)
        torch.cuda.synchronize()
        if not torch.equal(kv, kv_want):
            raise AssertionError(f"B={b} T={t} d={d}: the 1-pass pre-pass "
                                 "differs from its plain version")
        del kv_want
        if masked_row is not None and not torch.equal(
                got[masked_row], torch.zeros_like(got[masked_row])):
            raise AssertionError(f"B={b} T={t}: 1-pass all-masked row is "
                                 "not exactly 0")
        err, rms, ieee, tol, rms_tol = one_pass_gate(
            got[keep], plain[keep], want[keep], v)
        if not (err <= tol and rms <= rms_tol and ieee > ATOL):
            raise AssertionError(
                f"B={b} T={t} d={d}: 1-pass against its plain version "
                f"max |diff| {err} (<= {tol}), RMS {rms} (<= {rms_tol}); "
                f"{ieee} from IEEE (> {ATOL})")
        del got, plain
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask, scale,
                                                passes=1), reps)
        # each kernel alone, queued ahead of the device (the wrappers' host
        # time would set a small shape's pace)
        kernel_ms = queued_ms(lambda: fa.one_pass_attention(q, kv, scale),
                              reps)
        prep_ms = queued_ms(lambda: fa.one_pass_operands(k, v, mask), reps)
        plain_reps = max(2, reps // 4)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, mask, scale, passes=1), plain_reps)
        prep_plain_ms = cuda_ms(lambda: fa.one_pass_operands_reference(
            k, v, mask), plain_reps)
    attend = ~mask[:, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=attend, scale=scale)

    with exact_numerics(False):        # SDPA with TF32 allowed
        library_ms = cuda_ms(sdpa, reps)
        lib_err = float((sdpa()[keep] - want[keep]).abs().max())
    bound_ms, bound_by = attention_bound_ms(b, h, t, d)["tf32"]
    prep_bound, prep_by = prep_bound_ms(b, h, t, d)
    print(f"  1-pass: max|diff| {err:.3e} (<= {tol:.3e}), RMS {rms:.3e} (<= "
          f"{rms_tol:.3e}; {rms * ONE_PASS_RMS_SHARE / rms_tol:.4f} of the "
          f"plain version's from IEEE) against its plain version, "
          f"{ieee:.3e} from IEEE; mode {ms:.4f} ms = pre-pass "
          f"{prep_ms:.4f} + kernel {kernel_ms:.4f} (bound TF32 "
          f"{bound_ms:.4f} ms, {bound_by}: {100 * bound_ms / ms:.1f}% of the "
          f"mode, {100 * bound_ms / kernel_ms:.1f}% of the kernel); plain "
          f"{plain_ms:.4f} ms; pre-pass bit-equal to its plain version "
          f"({prep_plain_ms:.4f} ms), bound {prep_bound:.4f} ms ({prep_by});"
          f" sdpa TF32 {library_ms:.4f} ms (max|diff| from IEEE "
          f"{lib_err:.3e})")
    return {"max_abs_err": err, "ieee_err": ieee, "ms": ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "prep": {"ms": prep_ms, "plain_ms": prep_plain_ms,
                     "bound_ms": prep_bound, "bound_by": prep_by,
                     "max_abs_err": 0.0}}


def phase_kernel(fa, exact_numerics, registers: dict) -> dict:
    """Row 1 against its plain versions at every KERNEL_SHAPES shape and
    at ONE_PASS_LARGE, with its times, bounds and SDPA's, in its 3xTF32
    mode (`split_readings`) and its 1-pass mode (`one_pass_readings`).
    `registers`: ptxas_registers of the source; a spill raises."""
    print_registers(registers)
    spilled = {k: v for k, v in registers.items() if v[1] or v[2]}
    if spilled:
        raise AssertionError(f"row 1's kernels spill: {spilled}")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rows = []
    for b, t, d in KERNEL_SHAPES:
        h = 2
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                    .astype(np.float32)).to(dev)
                   for _ in range(3))
        lengths = rng.integers(1, t + 1, size=b)
        lengths[0] = t
        mask_np = np.arange(t)[None, :] >= lengths[:, None]
        masked_row = b - 1 if b > 1 else None    # row 0 keeps every key
        if masked_row is not None:
            mask_np[masked_row] = True                    # all-masked row
        mask = torch.from_numpy(mask_np).to(dev)
        scale = 1.0 / math.sqrt(d)
        with exact_numerics(True):
            want = fa.flash_attention_reference(q, k, v, mask, scale)
        keep = torch.ones(b, dtype=torch.bool, device=dev)
        if masked_row is not None:
            keep[masked_row] = False
        reps = max(3, min(50, int(2e5 / t)))
        three = split_readings(fa, exact_numerics, q, k, v, mask, scale,
                               want, keep, masked_row, reps)
        one = one_pass_readings(fa, exact_numerics, q, k, v, mask, scale,
                                want, keep, masked_row, reps)
        rows.append({"B": b, "H": h, "T": t, "d": d, **three,
                     "one_pass": one})
        del q, k, v, want
    # both modes at phase 4's full decode batch
    b, t, d = ONE_PASS_LARGE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((b, 2, t, d), generator=gen, device=dev)
               for _ in range(3))
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lengths[0] = t
    mask = torch.arange(t, device=dev)[None, :] >= lengths[:, None]
    mask[b - 1] = True
    keep = torch.arange(b, device=dev) != b - 1
    scale = 1.0 / math.sqrt(d)
    with exact_numerics(True):
        want = fa.flash_attention_reference(q, k, v, mask, scale)
    print(f"3xTF32 and 1-pass at B={b} T={t} d={d}, H=2:")
    large = split_readings(fa, exact_numerics, q, k, v, mask, scale, want,
                           keep, b - 1, 5)
    large.update(B=b, T=t, d=d, one_pass=one_pass_readings(
        fa, exact_numerics, q, k, v, mask, scale, want, keep, b - 1, 5))
    del q, k, v, want
    torch.cuda.empty_cache()
    return {"rows": rows, "large": large,
            "report": next(r for r in rows if (r["B"], r["T"], r["d"])
                           == REPORT_SHAPE),
            "max_abs_err": max(r["max_abs_err"] for r in rows + [large]),
            "one_pass_max_abs_err": max(
                r["one_pass"]["max_abs_err"] for r in rows + [large])}


def make_tts(tcfg, vcfg, device=None, **kw):
    """ParrotTTS on weights made from SEED: every call gives the same.
    kw go to ParrotTTS (exact, mesh)."""
    from parrot_tts_tpu_torch.infer.serving import ParrotTTS
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.models.vocoder import generator
    from parrot_tts_tpu_torch.text.cleaners import english_cleaners
    from parrot_tts_tpu_torch.text.tokenizer import DFATokenizer

    gen = torch.Generator().manual_seed(SEED)
    tte_state = parrot.init_parrot(tcfg, gen)
    voc_state = generator.init_code_generator(vcfg, gen)
    # ~5 frames per token: exp(log 6) - 1, with a little spread
    tte_state["duration_predictor.proj.weight"] *= 0.2
    tte_state["duration_predictor.proj.bias"].fill_(math.log(6.0))
    tok = DFATokenizer([" "] + list("abcdefghijklmnopqrstuvwxyz,.?"))
    return ParrotTTS(tte_state, tcfg, voc_state, vcfg, tok, english_cleaners,
                     device=device, **kw)


def vocoder_batches(units) -> list[tuple[int, int]]:
    """(rows, code length) of each vocoder batch: units by length bucket."""
    from parrot_tts_tpu_torch.data.tte_data import pick_bucket
    from parrot_tts_tpu_torch.infer.synthesize import CODE_BUCKETS

    rows: dict[int, int] = {}
    for u in units:
        t = pick_bucket(CODE_BUCKETS, len(u))
        rows[t] = rows.get(t, 0) + 1
    return [(n, t) for t, n in sorted(rows.items())]


def phase_serving(fa, tcfg, vcfg, device=None) -> dict:
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.infer.tte_infer import make_batch
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.ops import attention
    from parrot_tts_tpu_torch.ops import length_regulator as lr

    tts = make_tts(tcfg, vcfg, device)
    speakers = [i % tcfg.n_speaker for i in range(len(TEXTS))]
    tokens = [tts.tokenize(t) for t in TEXTS]
    plan = tts.plan(tokens)
    print("requests (tokens):", [len(s) for s in tokens])
    print("decode plan (s_len, out_len, n):",
          [(s, o, len(i)) for s, o, i in plan])
    if not {1024, 2048, 3584} <= {o for _, o, _ in plan}:
        raise AssertionError("the requests do not reach every decoder bucket")
    checked = {(b, t) for b, t, d in KERNEL_SHAPES
               if d == tcfg.d_model // tcfg.encoder.n_head}
    served = {(len(i), t) for s, o, i in plan for t in (s, o)}
    if device is None and not served <= checked:
        raise AssertionError(f"attention shapes {sorted(served - checked)} "
                             "of the plan were not checked against plain")
    n_blocks = tcfg.encoder.n_layer + tcfg.decoder.n_layer

    runs = []
    for run in range(2):
        fa.FLASH_FWD.launches = fa.SPLIT_PREP.launches = 0
        wavs = tts.tts(TEXTS, speakers=speakers)
        launches, split = fa.FLASH_FWD.launches, fa.SPLIT_PREP.launches
        st = tts.last_stats
        runs.append((wavs, launches, st))
        print(f"serve {run}: {st['audio_seconds']:.3f} audio-s in "
              f"{st['wall_s']:.3f} s = {st['audio_seconds_per_second']:.3f} "
              f"audio-s/s (TTE {st['tte_s']:.3f} s, vocoder "
              f"{st['vocoder_s']:.3f} s); decode batches "
              f"{st['decode_batches']}, flash launches {launches}")
        if not launches == split == n_blocks * st["decode_batches"]:
            raise AssertionError(f"{launches} flash launches ({split} "
                                 "3xTF32 pre-pass) for "
                                 f"{st['decode_batches']} decode batches")
    (wavs, launches, _), (wavs2, _, _) = runs
    for i, (a, b) in enumerate(zip(wavs, wavs2)):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: serving is not deterministic")
    units = tts.predict_units(tokens, speakers)
    for i, (w, u) in enumerate(zip(wavs, units)):
        if len(w) != len(u) * vcfg.total_upsample:
            raise AssertionError(f"request {i}: {len(w)} samples for "
                                 f"{len(u)} units")
        if not np.isfinite(w).all():
            raise AssertionError(f"request {i}: non-finite samples")
    if len(wavs[1]) != 0:
        raise AssertionError("the empty request gave a non-empty waveform")
    if min(len(u) for i, u in enumerate(units) if TEXTS[i]) == 0:
        raise AssertionError("a non-empty request decoded to no units")

    # the same decode batches with plain attention on the card
    samples = [(s, speakers[i]) for i, s in enumerate(tokens)]
    near_ties = frames = 0
    for s_len, out_len, idxs in plan:
        batch = parrot.to_batch(make_batch(samples, idxs, s_len), tts.device)
        with torch.no_grad(), exact_numerics(True):
            logits_k, mask_k, logdur_k = parrot.apply_parrot(
                tts.tte, batch, out_len=out_len)
            with mock.patch.object(attention, "flash_attention",
                                   fa.flash_attention_reference):
                logits_p, mask_p, logdur_p = parrot.apply_parrot(
                    tts.tte, batch, out_len=out_len)
        dur_k = torch.where(batch["src_mask"],
                            lr.durations_from_log_pred(logdur_k), 0)
        dur_p = torch.where(batch["src_mask"],
                            lr.durations_from_log_pred(logdur_p), 0)
        if not (torch.equal(dur_k, dur_p) and torch.equal(mask_k, mask_p)):
            raise AssertionError(f"bucket {out_len}: durations differ")
        top2 = torch.topk(logits_p, 2, dim=-1).values
        clear = mask_p & (top2[..., 0] - top2[..., 1] > 1e-3)
        codes_k, codes_p = logits_k.argmax(-1), logits_p.argmax(-1)
        if not torch.equal(codes_k[clear], codes_p[clear]):
            raise AssertionError(f"bucket {out_len}: codes differ off ties")
        frames += int(mask_p.sum())
        near_ties += int((mask_p & ~clear).sum())
        dlogit = float((logits_k - logits_p)[mask_p].abs().max())
        if not dlogit <= DLOGIT_TOL:
            raise AssertionError(f"bucket {out_len}: max |dlogit| {dlogit} "
                                 f"> {DLOGIT_TOL}")
        print(f"plain-attention decode, bucket ({s_len}, {out_len}) x "
              f"{len(idxs)}: durations equal, codes equal off ties; "
              f"max |dlogit| {dlogit:.3e}")
    print(f"frames {frames}, near-tie frames (margin <= 1e-3) {near_ties}")
    return {"launches": launches, "split": split, "wavs": wavs,
            "units": units, "speakers": speakers, "tts": tts,
            "serve": lambda: tts.tts(TEXTS, speakers=speakers)}


def device_seconds(fn) -> float:
    """Seconds of one fn() between two CUDA events (the host clock without
    a card, for a CPU rehearsal)."""
    if torch.cuda.is_available():
        return cuda_ms(fn, 1, warmup=0) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def phase_decode_modes(fa, base: dict, smi: str, device=None) -> dict:
    """Phase 4's mixed-precision decodes: the serve's plan through
    ParrotTTS.predict_units in each of DECODE_MODES (row 1's launches per
    mode counted, the units repeatable, TTE seconds over MODE_REPEATS warm
    decodes; exact=True's units through the serve's vocoder give the default
    serve's waveforms where the units agree), then each decode batch's
    logits in exact=True, "selective-high" (bit-equal to exact=True's) and
    "selective" held to the gates of the default mode and of the fast one,
    the hybrid decode's
    units to its flags, and TTE seconds per mode of one full decode batch
    (the 2048 bucket's requests repeated to the serve's batch size)."""
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets, make_batch
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.ops import length_regulator as lr

    tts, speakers = base["tts"], base["speakers"]
    tokens = [tts.tokenize(t) for t in TEXTS]
    plan = tts.plan(tokens)
    units, launches, stats, secs = {}, {}, {}, {}
    default = tts.exact
    try:
        for mode in DECODE_MODES:
            tts.exact = mode
            st: dict = {}
            fa.FLASH_FWD.launches = fa.FLASH_FWD.one_pass = 0
            fa.ONE_PASS_PREP.launches = fa.SPLIT_PREP.launches = 0
            units[mode] = tts.predict_units(tokens, speakers, stats=st)
            launches[mode] = {3: fa.FLASH_FWD.launches - fa.FLASH_FWD.one_pass,
                              1: fa.FLASH_FWD.one_pass,
                              "prep": fa.ONE_PASS_PREP.launches,
                              "split": fa.SPLIT_PREP.launches}
            stats[mode] = st
            secs[mode] = []
            for _ in range(MODE_REPEATS):
                again = []
                secs[mode].append(device_seconds(
                    lambda: again.extend(tts.predict_units(tokens, speakers))))
                if not all(map(np.array_equal, again, units[mode])):
                    raise AssertionError(f"exact={mode!r}: the decode is not "
                                         "deterministic")
    finally:
        tts.exact = default
    print("row-1 launches per decode mode (3xTF32, 1-pass, 1-pass "
          "pre-pass, 3xTF32 pre-pass): " + ", ".join(
              f"{m!r} ({n[3]}, {n[1]}, {n['prep']}, {n['split']})"
              for m, n in launches.items()))
    # one launch per FFT block per decode batch, in its section's mode; the
    # hybrid's fast decode is "selective"'s, its re-decode "selective-high"
    enc, dec = tts.tte_cfg.encoder.n_layer, tts.tte_cfg.decoder.n_layer
    fast = stats["selective"]["decode_batches"]
    redo = stats["hybrid"]["decode_batches"] - fast
    want = {True: ((enc + dec) * stats[True]["decode_batches"], 0),
            "selective-high": ((enc + dec) * stats["selective-high"][
                "decode_batches"], 0),
            "selective": (enc * fast, dec * fast),
            "hybrid": (enc * fast + (enc + dec) * redo, dec * fast)}
    for mode, (n3, n1) in want.items():
        got = tuple(launches[mode][key] for key in (3, 1, "prep", "split"))
        if device is None and got != (n3, n1, n1, n3):
            raise AssertionError(f"exact={mode!r}: row-1 launches (3xTF32, "
                                 f"1-pass, their pre-passes) {got}; want "
                                 f"{n3}, {n1}, {n1}, {n3}")
    if not all(map(np.array_equal, units["selective-high"], base["units"])):
        raise AssertionError("the default serve's units are not the "
                             "\"selective-high\" decode's")
    # the serve's vocoder runs as exact=True's: equal units, equal bits
    same = [i for i, (a, b) in enumerate(zip(units[True], base["units"]))
            if np.array_equal(a, b)]
    wavs = tts.vocoder.synthesize(units[True], speakers)
    if not all(np.array_equal(wavs[i], base["wavs"][i]) for i in same):
        raise AssertionError("exact=True's units through the serve's vocoder "
                             "differ from the default serve's waveforms")
    print(f"exact=True's units through the serve's vocoder: waveforms "
          f"bit-equal to the default serve's on the {len(same)} of "
          f"{len(TEXTS)} requests whose units agree")

    samples = [(s, speakers[i]) for i, s in enumerate(tokens)]
    margin = {}
    frames = near = 0
    flips = worst = 0
    for s_len, out_len, idxs in plan:
        batch = parrot.to_batch(make_batch(samples, idxs, s_len), tts.device)
        out = {}
        with torch.no_grad():
            for mode in (True, "selective-high", "selective",
                         "selective-high"):
                with exact_numerics(mode is not False):
                    logits, mask, logdur = parrot.apply_parrot(
                        tts.tte, batch, out_len=out_len, exact=mode)
                dur = torch.where(batch["src_mask"],
                                  lr.durations_from_log_pred(logdur), 0)
                if mode in out and not torch.equal(logits, out[mode][0]):
                    raise AssertionError(f"bucket {out_len}: two "
                                         f"{mode!r} decodes differ")
                out[mode] = (logits, mask, dur)
        le, me, de = out[True]
        top2 = torch.topk(le, 2, dim=-1).values
        clear = me & (top2[..., 0] - top2[..., 1] > NEAR_TIE)
        frames += int(me.sum())
        near += int((me & ~clear).sum())
        for j, m in zip(idxs, parrot.code_margin(out["selective"][0], me)):
            margin[j] = float(m)
        # "selective-high" runs as exact=True on this card: the same bits
        if not all(map(torch.equal, out["selective-high"], out[True])):
            raise AssertionError(f"bucket {out_len}: \"selective-high\" "
                                 "logits, durations or mask differ from "
                                 "exact=True's")
        lm, mm, dm = out["selective"]
        if not (torch.equal(dm, de) and torch.equal(mm, me)):
            raise AssertionError(f"bucket {out_len}: \"selective\" "
                                 "durations differ from exact=True's")
        dlogit = float((lm - le)[me].abs().max())
        worst = max(worst, dlogit)
        diff = me & (lm.argmax(-1) != le.argmax(-1))
        flips += int(diff.sum())
        print(f"bucket ({s_len}, {out_len}) x {len(idxs)}: "
              f"\"selective-high\" bit-equal to exact=True; \"selective\" "
              f"durations equal, max |dlogit| {dlogit:.3e}, codes differ at "
              f"{int(diff.sum())} of {int(me.sum())} frames, "
              f"{int((diff & clear).sum())} off ties")
    print(f"frames {frames}, near-tie frames (exact margin <= {NEAR_TIE}) "
          f"{near}; \"selective\" code flips against exact=True {flips} "
          f"(agreement {1 - flips / max(frames, 1):.6f}), max |dlogit| "
          f"{worst:.3e}")

    changed = [i for i, (a, b) in enumerate(zip(units["selective"],
                                                units[True]))
               if not np.array_equal(a, b)]
    low = [i for i in range(len(TEXTS)) if margin[i] < HYBRID_THRESHOLD]
    print(f"\"selective\": requests whose units differ from exact=True's "
          f"{changed}; selective margins "
          f"{[round(margin[i], 6) for i in range(len(TEXTS))]}")
    if not set(changed) <= set(low):
        raise AssertionError("a \"selective\" request with changed units has "
                             f"a margin >= {HYBRID_THRESHOLD}")
    if stats["hybrid"]["hybrid_flagged"] != len(low):
        raise AssertionError(f"hybrid flagged {stats['hybrid']} requests, "
                             f"{len(low)} have a margin < {HYBRID_THRESHOLD}")
    for i, u in enumerate(units["hybrid"]):
        want = units["selective-high" if i in low else "selective"][i]
        if not np.array_equal(u, want):
            raise AssertionError(f"hybrid request {i} ({'' if i in low else 'not '}"
                                 "flagged) differs from its mode's units")
    print(f"hybrid: flagged {len(low)} of {len(TEXTS)} requests "
          f"({len(low) / len(TEXTS):.3f}), {stats['hybrid']['decode_batches']}"
          f" decode batches; flagged requests give \"selective-high\"'s "
          "units, the others \"selective\"'s")
    # one full decode batch: the (128 -> 2048) bucket's requests repeated
    # to batch_size rows, where the decoder's products, not the launches,
    # take the time
    s_len, out_len, idxs = next(p for p in plan if p[1] == 2048)
    rows = [samples[idxs[j % len(idxs)]] for j in range(tts.batch_size)]
    full = [(s_len, out_len, list(range(len(rows))))]
    full_secs = {}
    for mode in DECODE_MODES:
        def decode():
            decode_buckets(tts.tte, rows, full, batch_size=len(rows),
                           exact=mode, device=tts.device)
        decode()
        full_secs[mode] = [device_seconds(decode)
                           for _ in range(MODE_REPEATS)]
    print(smi)
    for name, plan_secs in ((f"the plan ({len(TEXTS)} requests)", secs),
                            (f"one batch of {len(rows)} x ({s_len} -> "
                             f"{out_len})", full_secs)):
        for mode in DECODE_MODES:
            t = plan_secs[mode]
            print(f"TTE seconds, {name}, exact={mode!r}: mean "
                  f"{np.mean(t):.6f} over {MODE_REPEATS} warm decodes (min "
                  f"{min(t):.6f}, max {max(t):.6f}); relative to exact=True "
                  f"{np.mean(t) / np.mean(plan_secs[True]):.3f}")
    return {"launches": launches, "units": units}


def mrf_stages(vcfg) -> list[tuple[int, int, int]]:
    """(stage, the kernel's channels, samples per code) of each stage the
    fused route takes (a stage off the multiples of 8 runs zero-padded to
    the next)."""
    from parrot_tts_tpu_torch.models.vocoder.generator import (
        FUSED_BELOW_CHANNELS)

    out, hop = [], 1
    for i, u in enumerate(vcfg.upsample_rates):
        hop *= u
        c = vcfg.upsample_initial_channel // 2 ** (i + 1)
        if c < FUSED_BELOW_CHANNELS:
            out.append((i, -(-c // 8) * 8, hop))
    return out


def mrf_serve_shapes(vcfg, batches) -> list[tuple[tuple, int]]:
    """((B, T, C), stage) of every fused-MRF launch of one fused serve."""
    return [((n, t * hop, c), i) for n, t in batches
            for i, c, hop in mrf_stages(vcfg)]


def bound(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    ops_s, bytes_s = ops / peak, nbytes / HBM_RATE
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def total(rows: list[dict]) -> dict:
    """Times of a set of launches (each row times its count)."""
    out = {key: sum(r[key] * r["count"] for r in rows)
           for key in ("ms", "plain_ms", "bound_ms")}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"] * r["count"]
                          )["bound_by"]
    return out


def mrf_bounds(b: int, t: int, c: int, w, bias, plan) -> dict:
    """Row 6's bounds at one launch: its 3xTF32 products (3 * 2 * B*T *
    sum over convs of K * C^2 on the TF32 tensor cores; the kernels line's
    bound) and the same work as float32 FMAs on the CUDA cores; x read and
    out written once, the weights and biases read once."""
    flops = 2.0 * b * t * c * c * sum(
        2 * k * len(d) for k, d in zip(plan.kernel_sizes, plan.dilations))
    nbytes = 8.0 * b * t * c + 4.0 * (w.numel() + bias.numel())
    return {"3xtf32": bound(3 * flops, TF32_PEAK, nbytes),
            "f32": bound(flops, FP32_PEAK, nbytes)}


def phase_mrf_kernel(fm, exact_numerics, model, vcfg, batches,
                     registers: dict) -> dict:
    """The fused-MRF kernel against its plain version at every (B, T, C)
    the fused serve gives it, a ragged T, and rows of different lengths,
    with its times, both bounds and, per serve launch, the unfused cuDNN
    float32 composition of the same stage (the serve's own resblocks; the
    library yardstick). `registers`: ptxas_registers of the source (empty
    when it was built before this run)."""
    from parrot_tts_tpu_torch.models.vocoder import generator
    from parrot_tts_tpu_torch.models.vocoder.generator import pack_stage

    mrf_regs = {k: v for k, v in registers.items() if k.startswith("mrf")}
    print_registers(mrf_regs)
    spilled = {k: v for k, v in mrf_regs.items() if v[1] or v[2]}
    if spilled:
        raise AssertionError(f"fused MRF kernels spill: {spilled}")
    rng = np.random.default_rng(SEED + 1)
    nk = len(vcfg.resblock_kernel_sizes)
    stages = mrf_stages(vcfg)
    shapes = [(*shape, i, "serve") for shape, i in mrf_serve_shapes(vcfg,
                                                                    batches)]
    shapes += [(2, 1013, stages[0][1], stages[0][0], "ragged"),
               (3, 4000, stages[1][1], stages[1][0], "lengths")]
    rows = []
    with torch.no_grad(), exact_numerics(True):
        for b, t, c, i, kind in shapes:
            w, bias, plan = pack_stage(model, i)
            wk = fm.kernel_weights(w, plan)
            if all(r["C"] != c for r in rows):
                tile = fm.tile_plan(plan)
                print(f"fused MRF C={c}: tile {tile.tb} rows (least work "
                      f"per row), halo "
                      f"{plan.halo} per side, {tile.warpgroups} warpgroups, "
                      f"1 block per SM, units of "
                      f"{fm.UNIT_ROWS} rows x {c} channels (up to "
                      f"{tile.rounds} per warpgroup), wgmma m64n"
                      f"{tile.wgmma_n}k8, slabs of {tile.slab_ksteps} "
                      f"k-steps ({tile.k_chunk} inputs each) in a ring of "
                      f"{tile.ring_slots} slots, sums carried over "
                      f"{min(tile.sum_taps, max(plan.kernel_sizes))} taps, "
                      f"recompute {tile.recompute:.3f}, shared memory "
                      f"{tile.smem_bytes} bytes")
            tb = fm.tile_plan(plan, (b, t)).tb
            x = torch.from_numpy(rng.standard_normal((b, t, c))
                                 .astype(np.float32)).cuda()
            if kind == "lengths":
                for r, n in enumerate((t, 2 * t // 3, t // 3)):
                    x[r, n:] = 0.0
            got = fm.mrf_fused(x, w, bias, plan, wk=wk)
            want = fm.mrf_fused_reference(x, w, bias, plan)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lim = MRF_RTOL * float(want.abs().max())
            if not err <= lim:
                raise AssertionError(f"fused MRF B={b} T={t} C={c}: max "
                                     f"|diff| {err} > {lim}")
            reps = max(3, min(30, int(3e6 / (b * t))))
            ms = cuda_ms(lambda: fm.mrf_fused(x, w, bias, plan, wk=wk), reps)
            plain_ms = cuda_ms(
                lambda: fm.mrf_fused_reference(x, w, bias, plan), reps)
            stage = model.resblocks[i * nk:(i + 1) * nk]

            def library():
                acc = None
                for rb in stage:
                    y = generator.apply_resblock1(rb, x)
                    acc = y if acc is None else acc + y
                return acc / nk

            # the stage's own resblocks take its unpadded width only
            library_ms = (cuda_ms(library, reps) if kind == "serve" and
                          stage[0].convs1[0].bias.shape[0] == c else None)
            bounds = mrf_bounds(b, t, c, w, bias, plan)
            (bound_ms, bound_by), (f32_ms, _) = bounds["3xtf32"], bounds["f32"]
            rows.append({"B": b, "T": t, "C": c, "kind": kind, "count": 1,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "f32_bound_ms": f32_ms})
            lib = ("" if library_ms is None else
                   f"  cuDNN float32 composition {library_ms:.4f} ms")
            print(f"fused MRF B={b} T={t:7d} C={c:2d} ({kind}, tile {tb}): "
                  f"max|diff| {err:.3e} (limit {lim:.3e})  kernel {ms:.4f} ms"
                  f"  plain {plain_ms:.4f} ms{lib}  bound {bound_ms:.4f} ms "
                  f"3xTF32 ({bound_by}, {100 * bound_ms / ms:.1f}%), "
                  f"{f32_ms:.4f} ms float32")
            del x, got, want
    serve = [r for r in rows if r["kind"] == "serve"]
    for c in sorted({r["C"] for r in serve}, reverse=True):
        st = [r for r in serve if r["C"] == c]
        ms, bnd = (sum(r[k] for r in st) for k in ("ms", "bound_ms"))
        lib = [r["library_ms"] for r in st if r["library_ms"] is not None]
        print(f"fused MRF per serve C={c} ({len(st)} launches): kernel "
              f"{ms:.4f} ms  plain "
              f"{sum(r['plain_ms'] for r in st):.4f} ms  cuDNN float32 "
              f"{sum(lib):.4f} ms  bound {bnd:.4f} ms 3xTF32 "
              f"({100 * bnd / ms:.1f}% of it), "
              f"{sum(r['f32_bound_ms'] for r in st):.4f} ms float32")
    rep = total(serve)
    libs = [r["library_ms"] for r in serve]
    rep["library_ms"] = None if None in libs else sum(libs)
    lib = ("not measured" if rep["library_ms"] is None
           else f"{rep['library_ms']:.4f} ms")
    print(f"fused MRF per serve ({len(serve)} launches): kernel "
          f"{rep['ms']:.4f} ms  plain {rep['plain_ms']:.4f} ms  cuDNN "
          f"float32 composition {lib}  bound "
          f"{rep['bound_ms']:.4f} ms 3xTF32 "
          f"({100 * rep['bound_ms'] / rep['ms']:.1f}% of it), "
          f"{sum(r['f32_bound_ms'] for r in serve):.4f} ms float32")
    return {"report": rep, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "checked": {(r["B"], r["T"], r["C"]) for r in serve}}


def int8_sites(vcfg, n: int, t: int, mode: str) -> dict:
    """(B, T, Ci, Co, K, dilation, pads, leaky, per_row, bf16) -> count,
    for every int8 conv of one vocoder batch of n rows of t codes in quant
    mode `mode`: every conv under "int8-static" (its scale broadcast over
    the batch, float32 out in either dtype), the sites of
    `generator.quant_plan` under "int8" and "int8-tail" (per-row scales;
    bf16 out under vcfg.dtype "bfloat16")."""
    from parrot_tts_tpu_torch.models.vocoder.generator import (LRELU_SLOPE,
                                                               quant_plan)
    from parrot_tts_tpu_torch.ops import conv as conv_ops

    per_row = mode != "int8-static"
    bf16 = per_row and vcfg.dtype == "bfloat16"
    plan = (quant_plan(dataclasses.replace(vcfg, quant=mode), t) if per_row
            else [(True, True)] * len(vcfg.upsample_rates))
    sites: dict = {}

    def add(key):
        sites[key] = sites.get(key, 0) + 1

    hop = 1
    for i, (u, k) in enumerate(zip(vcfg.upsample_rates,
                                   vcfg.upsample_kernel_sizes)):
        cin = vcfg.upsample_initial_channel // 2 ** i
        ch = cin // 2
        ups_q, mrf_q = plan[i]
        *_, pad_left, q_len = conv_ops._polyphase_plan(k, u, (k - u) // 2)
        if ups_q:
            add((n, t * hop, cin, u * ch, q_len, 1,
                 (pad_left, q_len - 1 - pad_left), None, per_row, bf16))
        hop *= u
        for rk, ds in zip(vcfg.resblock_kernel_sizes,
                          vcfg.resblock_dilation_sizes):
            for d in ds if mrf_q else ():
                p1, p2 = conv_ops.get_padding(rk, d), conv_ops.get_padding(rk)
                add((n, t * hop, ch, ch, rk, d, (p1, p1), LRELU_SLOPE,
                     per_row, bf16))
                add((n, t * hop, ch, ch, rk, 1, (p2, p2), None, per_row,
                     bf16))
    return sites


def int8_serve_sites(vcfg, batches, mode: str) -> dict:
    """int8_sites summed over the vocoder batches of one serve."""
    sites: dict = {}
    for n, t_codes in batches:
        batch = int8_sites(vcfg, n, t_codes, mode)
        if sum(batch.values()) != INT8_SITES[mode]:
            raise AssertionError(f"{mode}: {sum(batch.values())} int8 sites,"
                                 f" want {INT8_SITES[mode]}")
        for key, count in batch.items():
            sites[key] = sites.get(key, 0) + count
    return sites


def phase_int8_kernel(qc, vcfg, batches, modes=tuple(INT8_SITES)) -> dict:
    """The int8 conv kernel against its plain version, bit for bit, at
    every distinct site shape of every vocoder batch of the serves of
    `modes` in vcfg.dtype (the int8-static and "int8" serves' sites cover
    "int8-tail"'s) and of bench.py's batch (INT8_BENCH_BATCH), with the
    scale each serve passes and its output type (bfloat16 at the dynamic
    sites of a bf16 serve). A site's "ms" is the device time per launch of
    launches queued ahead of the device (queued_ms): back to back, the
    launches of the small sites are paced by the host, whose
    launch-to-launch time (cuda_ms) is printed beside it. At a bf16 site
    "library_ms" is the same conv in bf16 through cuDNN (F.conv1d with
    its bias), the yardstick no PyTorch int8 conv gives. Then, per serve,
    the time by stage (the sites' Ci) against its bound, and a launch's
    fixed cost: INT8_FIXED_SITES at T_out = 1, queued."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    serves = {mode: int8_serve_sites(vcfg, batches, mode) for mode in modes}
    if "int8" in serves and not set(serves["int8-tail"]) <= set(
            serves["int8"]):
        raise AssertionError("int8-tail sites outside the int8 sites")
    bench = {mode: int8_sites(vcfg, *INT8_BENCH_BATCH, mode)
             for mode in modes}
    sites = {}
    for site_counts in (*serves.values(), *bench.values()):
        sites.update(site_counts)
    rows = []

    def inputs(n, t, ci, co, k, per_row):
        xq, wt = ints(n, t, ci), ints(k, co, ci)
        # the serve's scale: per row (B, Co), or one (Co,) vector broadcast
        # over the batch
        scale = torch.rand(*((n,) if per_row else ()), co, generator=gen,
                           device="cuda") * 1e-4 + 1e-6
        bias = torch.randn(co, generator=gen, device="cuda") * 0.1
        return xq, wt, scale.expand(n, -1), bias

    for key in sites:
        n, t, ci, co, k, d, pads, leaky, per_row, bf16 = key
        out_dtype = torch.bfloat16 if bf16 else torch.float32
        xq, wt, scale, bias = inputs(n, t, ci, co, k, per_row)

        def kern():
            return qc.int8_conv(xq, wt, scale, bias, pads=pads, dilation=d,
                                leaky=leaky, out_dtype=out_dtype)

        def plain():
            return qc.int8_conv_reference(xq, wt, scale, bias, pads=pads,
                                          dilation=d, leaky=leaky,
                                          out_dtype=out_dtype)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not (got.dtype == out_dtype and torch.equal(got, want)):
            raise AssertionError(
                f"int8 conv B={n} T={t} Ci={ci} Co={co} K={k} d={d} "
                f"{out_dtype}: not bit-identical (max |diff| "
                f"{float((got.float() - want.float()).abs().max())})")
        err = float((got.float() - want.float()).abs().max())
        ms = queued_ms(kern, INT8_TIMED, warmup=INT8_WARMUP)
        launch_ms = cuda_ms(kern, INT8_TIMED, warmup=0)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        library_ms = None
        if bf16:
            x16 = xq.bfloat16().transpose(1, 2)
            w16, b16 = wt.bfloat16().permute(1, 2, 0), bias.bfloat16()
            library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(
                torch.nn.functional.pad(x16, pads), w16, b16, dilation=d),
                INT8_TIMED)
            del x16, w16
        t_out = got.shape[1]
        out_bytes = 2 if bf16 else 4
        bound_ms, bound_by = bound(
            2.0 * n * t_out * k * ci * co, INT8_PEAK,
            n * t * ci + k * ci * co + 4.0 * (co + co)
            + out_bytes * n * t_out * co)
        rows.append({"key": key, "max_abs_err": err, "ms": ms,
                     "launch_ms": launch_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
        plan = qc.conv_plan(n, t, ci, k, co, pads, d, out_bytes=out_bytes)
        print(f"int8 conv B={n} T={t:7d} Ci={ci:3d} Co={co:4d} K={k:2d} "
              f"d={d} leaky={int(leaky is not None)} per_row={int(per_row)}"
              f" out {'bf16' if bf16 else 'f32'}: bit-identical  kernel "
              f"{ms:.4f} ms device (launch to launch {launch_ms:.4f} ms)  "
              f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
              f"({bound_by}, {100 * bound_ms / ms:.1f}% of it)"
              + (f"  cuDNN bf16 conv {library_ms:.4f} ms" if bf16 else "")
              + f"  branch {plan['branch']} (tile {plan['bm']} x "
              f"{plan['bn']}, {'resident' if plan['resident'] else 'streamed'}"
              f" weights, chunks of {plan.get('ck', 32)} B, "
              f"{plan['stages']} stages, grid {plan['grid']})")
        del xq, wt, got, want
    by_key = {r["key"]: r for r in rows}

    def report(site_counts: dict) -> dict:
        rows_ = [{**by_key[key], "count": count}
                 for key, count in site_counts.items()]
        out = {**total(rows_), "launch_ms": sum(
            r["launch_ms"] * r["count"] for r in rows_)}
        if all(r["library_ms"] is not None for r in rows_):
            out["library_ms"] = sum(r["library_ms"] * r["count"]
                                    for r in rows_)
        return out

    label = "" if vcfg.dtype == "float32" else f" ({vcfg.dtype})"
    before = INT8_SERVE_MS_BEFORE_BF16 if label else INT8_SERVE_MS_BEFORE
    for mode in modes:
        for n, t_codes in (*batches, INT8_BENCH_BATCH):
            r = report(int8_sites(vcfg, n, t_codes, mode))
            print(f"int8 conv per {mode}{label} "
                  f"{'bench' if (n, t_codes) == INT8_BENCH_BATCH else 'vocoder'}"
                  f" batch of {n} x {t_codes} codes ({INT8_SITES[mode]} "
                  f"launches): kernel {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({100 * r['bound_ms'] / r['ms']:.1f}%)")
        r = report(serves[mode])
        lib = (f"  cuDNN bf16 convs {r['library_ms']:.4f} ms"
               if "library_ms" in r else "")
        print(f"int8 conv per {mode}{label} serve ({len(serves[mode])} "
              f"distinct shapes, {INT8_SITES[mode] * len(batches)} launches):"
              f" kernel {r['ms']:.4f} ms device "
              f"({100 * r['bound_ms'] / r['ms']:.1f}% of the bound; launch to "
              f"launch {r['launch_ms']:.4f} ms; the kernel before it: "
              f"{before[mode]} ms)  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms{lib}")
        for ci in sorted({key[2] for key in serves[mode]}):
            r = report({key: c for key, c in serves[mode].items()
                        if key[2] == ci})
            print(f"int8 conv stage Ci={ci:3d} per {mode}{label} serve: "
                  f"kernel {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({100 * r['bound_ms'] / r['ms']:.1f}%)")
    out_dtype = torch.bfloat16 if label else torch.float32
    for ci, co, k, d in INT8_FIXED_SITES:
        pad = d * (k - 1) // 2
        xq, wt, scale, bias = inputs(1, 1, ci, co, k, True)
        ms = queued_ms(lambda: qc.int8_conv(
            xq, wt, scale, bias, pads=(pad, pad), dilation=d, leaky=0.1,
            out_dtype=out_dtype), INT8_TIMED, warmup=INT8_WARMUP)
        print(f"int8 conv fixed cost{label} (B=1, T_out=1, Ci={ci}, Co={co},"
              f" K={k}, d={d}): {ms:.4f} ms per launch, queued")
    # the three serves together, whose launches the kernels line counts
    all_serves: dict = {}
    for site_counts in serves.values():
        for key, count in site_counts.items():
            all_serves[key] = all_serves.get(key, 0) + count
    return {"report": report(all_serves),
            "serves": {mode: report(c) for mode, c in serves.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "checked": set(sites)}


def serve_line(label: str, st: dict, launches: int) -> None:
    print(f"{label}: {st['audio_seconds']:.3f} audio-s in {st['wall_s']:.3f} s"
          f" = {st['audio_seconds_per_second']:.3f} audio-s/s (TTE "
          f"{st['tte_s']:.3f} s, vocoder {st['vocoder_s']:.3f} s); kernel "
          f"launches {launches}")


def phase_fused_serve(fm, tcfg, vcfg, base: dict, checked: set,
                      device=None) -> dict:
    """The same requests through ParrotTTS with fused_mrf=True."""
    tts = make_tts(tcfg, vcfg, device)
    want = len(mrf_stages(vcfg)) * len(vocoder_batches(base["units"]))
    runs = []
    for run in range(2):
        with recording(fm, "mrf_fused", mrf_key) as shapes:
            fm.FUSED_MRF.launches = 0
            wavs = tts.tts(TEXTS, speakers=base["speakers"])
            launches = fm.FUSED_MRF.launches
        if not shapes <= checked:
            raise AssertionError(f"fused MRF shapes {sorted(shapes - checked)}"
                                 " of the serve were not checked against "
                                 "plain")
        serve_line(f"fused serve {run}", tts.last_stats, launches)
        if launches != want:
            raise AssertionError(f"{launches} fused MRF launches, want {want}")
        runs.append((wavs, launches))
    dev = 0.0
    for i, (a, b, c) in enumerate(zip(runs[0][0], runs[1][0], base["wavs"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: fused serve not deterministic")
        if a.shape != c.shape:
            raise AssertionError(f"request {i}: {a.shape} != {c.shape}")
        if a.size:
            dev = max(dev, float(np.abs(a - c).max()))
    print(f"fused serve against the float serve: max |diff| {dev:.3e}")
    if not dev <= FUSED_SERVE_ATOL:
        raise AssertionError(f"fused serve deviates by {dev}")
    return {"launches": runs[0][1],
            "serve": lambda: tts.tts(TEXTS, speakers=base["speakers"])}


def phase_int8_serve(qc, tcfg, vcfg, base: dict, checked: set,
                     device=None) -> dict:
    """The same requests through ParrotTTS with vcfg.quant an int8 mode,
    served twice; "int8-static" calibrates first on a batch built from the
    serve's own units."""
    mode = vcfg.quant
    tts = make_tts(tcfg, vcfg, device)
    units, speakers = base["units"], base["speakers"]
    batches = vocoder_batches(units)
    if mode == "int8-static":
        length = max(t for _, t in batches)
        rows = [np.tile(u, -(-length // len(u)))[:length] for u in units
                if len(u)]
        spk = [s for u, s in zip(units, speakers) if len(u)]
        t0 = time.perf_counter()
        tts.vocoder.calibrate(rows, spk)
        torch.cuda.synchronize()
        print(f"int8-static calibration on {len(rows)} x {length} codes: "
              f"{time.perf_counter() - t0:.3f} s, "
              f"{len(tts.vocoder.staticq.scales)} sites")
    want = INT8_SITES[mode] * len(batches)
    runs = []
    for run in range(2):
        with recording(qc, "int8_conv", int8_key) as shapes:
            qc.INT8_CONV.launches = 0
            wavs = tts.tts(TEXTS, speakers=speakers)
            launches = qc.INT8_CONV.launches
        if not shapes <= checked:
            raise AssertionError(f"int8 conv shapes {sorted(shapes - checked)}"
                                 " of the serve were not checked against "
                                 "plain")
        serve_line(f"{mode} serve {run}", tts.last_stats, launches)
        if launches != want:
            raise AssertionError(f"{launches} int8 conv launches, want {want}")
        runs.append((wavs, launches))
    sig = err = 0.0
    dev, worst = 0.0, math.inf
    for i, (a, b, u, f) in enumerate(zip(runs[0][0], runs[1][0], units,
                                         base["wavs"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: {mode} serve not "
                                 "deterministic")
        if len(a) != len(u) * vcfg.total_upsample:
            raise AssertionError(f"request {i}: {len(a)} samples for "
                                 f"{len(u)} units")
        if not np.isfinite(a).all():
            raise AssertionError(f"request {i}: non-finite samples")
        if a.size:
            e = float(((a.astype(np.float64) - f) ** 2).sum())
            s = float((f.astype(np.float64) ** 2).sum())
            sig, err = sig + s, err + e
            dev = max(dev, float(np.abs(a - f).max()))
            worst = min(worst, 10 * math.log10(s / max(e, 1e-30)))
    snr = 10 * math.log10(sig / max(err, 1e-30))
    print(f"{mode} serve against the float serve: SNR {snr:.2f} dB "
          f"(worst request {worst:.2f} dB), max |dev| {dev:.4e}")
    if not (snr >= SNR_MIN_DB and worst >= SNR_MIN_DB):
        raise AssertionError(f"{mode} SNR {snr:.2f} dB (worst request "
                             f"{worst:.2f} dB) < {SNR_MIN_DB}")
    return {"launches": runs[0][1], "snr_db": snr,
            "serve": lambda: tts.tts(TEXTS, speakers=speakers)}


def phase_batch_invariance(quant, device="cuda", dtype=torch.float32,
                           gate: bool = True) -> bool:
    """The dynamic int8 conv at a V1 stage-1 MRF site, in dtype: a quiet
    row gives the same bits alone and beside a loud row (per-row scales).
    gate=False reports the result instead of raising."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    quiet, loud = randn(1, 1250, 256, scale=0.01), randn(1, 1250, 256,
                                                         scale=10.0)
    w = randn(3, 256, 256, scale=0.05)
    b = randn(256, scale=0.1)
    solo = quant.int8_conv_nwc(quiet, w, b, pads=(1, 1), leaky=0.1)
    pair = quant.int8_conv_nwc(torch.cat([quiet, loud]), w, b, pads=(1, 1),
                               leaky=0.1)
    same = solo.dtype == dtype and torch.equal(solo[0], pair[0])
    print(f"dynamic int8 conv in {dtype}: a quiet row (std 0.01) alone and "
          f"beside a loud row (std 10) gives the same bits: {same}")
    if gate and not same:
        raise AssertionError("dynamic int8 conv: a quiet row changes beside "
                             "a loud one")
    return same


def phase_profile(serve, label: str, split=(), unprofiled_ms=None) -> None:
    """One more serve under torch.profiler: device time by kernel and the
    device's busy share of the wall time. Busy time is the union of the
    kernels' intervals; the profiler's device-side annotations of aten ops
    span those same kernels and are left out. split: (label, name
    substrings) pairs; each kernel's time goes to the first whose
    substring its name holds, the rest to "other". unprofiled_ms: the
    same call's time without the profiler (CUDA events); the busy and
    idle shares are then also read against it, since the profiler's own
    host work per launch stretches the profiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"profile of one {label}:")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print("profile: the profiler recorded no device time (not measured)")
        return
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy_ms = busy_us / 1e3
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    print(f"profile: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; {len(kernels)} kernels, "
          f"{sum(ms for ms, _ in by_name.values()):.3f} ms summed")
    if unprofiled_ms is not None:
        print(f"profile: against the unprofiled {unprofiled_ms:.3f} ms "
              f"(CUDA events) busy {100 * busy_ms / unprofiled_ms:.1f}%, "
              f"idle {100 * max(0.0, 1 - busy_ms / unprofiled_ms):.1f}%; "
              f"the profiler stretches the wall "
              f"{wall_ms / unprofiled_ms:.2f}x")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    if split:
        groups: dict[str, list] = {}
        for name, (ms, n) in by_name.items():
            group = next((g for g, keys in split
                          if any(k in name for k in keys)), "other")
            acc = groups.setdefault(group, [0.0, 0])
            acc[0] += ms
            acc[1] += n
        print("profile by kind: " + "; ".join(
            f"{g} {ms:.3f} ms / {n} kernels"
            for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for row, source, key in ((6, "fused_mrf", MRF_KERNEL),
                             (7, "int8_conv", INT8_CONV_KERNEL)):
        runs = [v for name, v in by_name.items() if key in name]
        if runs:
            print(f"profile: row {row} (csrc/{source}.cu) "
                  f"{sum(ms for ms, _ in runs):.3f} ms device time over "
                  f"{sum(n for _, n in runs)} launches")


def fd_compare(got, want, what: str) -> tuple[float, float]:
    """Hold a flash-dropout kernel's output to its plain version (FD_MAX,
    FD_RMS); returns the max |diff| and the rms diff over its floored
    rms(plain)."""
    diff = (got - want).abs()
    err = float(diff.max())
    lim = FD_MAX * max(1.0, float(want.abs().max()))
    rms = float(diff.pow(2).mean().sqrt())
    rms_ref = max(1.0, float(want.pow(2).mean().sqrt()))
    if not (err <= lim and rms <= FD_RMS * rms_ref):
        raise AssertionError(f"{what}: max |diff| {err:.3e} (limit {lim:.3e})"
                             f", rms {rms:.3e} (limit {FD_RMS * rms_ref:.3e})")
    return err, rms / rms_ref


def fd_bounds(b: int, h: int, t: int, d: int) -> dict:
    """(bound ms, bound_by) of each row at one launch: the products' bf16
    operations (4, 6, 8 * B*H*T^2*d; D's 2*B*H*T*d float32 ones in dQ are
    below 1e-3 of them and not counted) and each input read once, each
    output written once (float32: fwd q, k, v -> o; dQ q, k, v, dO, O -> dQ;
    dK/dV q, k, v, dO -> dK, dV; besides, bias (B, T), lse (B, H, T) and
    D (B, H, T), which dQ writes and dK/dV reads); the keep mask writes
    B*H*T^2 int32 (its Philox work is integer, not tensor-core)."""
    x, side, row = 4.0 * b * h * t * d, 4.0 * (b * t + b * h * t), 4.0 * b * h * t
    base = 2.0 * b * h * t * t * d
    return {"fwd": bound(2 * base, BF16_PEAK, 4 * x + side),
            "dq": bound(3 * base, BF16_PEAK, 6 * x + side + row),
            "dkv": bound(4 * base, BF16_PEAK, 6 * x + side + row),
            "keep_mask": bound(0.0, BF16_PEAK, 4.0 * b * h * t * t)}


def phase_flash_dropout(fd, registers: dict) -> dict:
    """Rows 2-5 against their plain versions at every FD_SHAPES shape, at
    p = 0 and p = FD_P, on the same mask, dQ's keep bits against the plain
    mask's and two backward launches against each other; then each one's
    time, its plain version's, its bound and scaled_dot_product_attention's,
    and dQ and dK/dV at p = 0. `registers`: ptxas_registers of the source."""
    import torch.nn.functional as F

    print_registers(registers)
    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")
    rows = []
    for b, t, d in FD_SHAPES:
        h = 2
        q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                        .astype(np.float32)).to(dev)
                       for _ in range(4))
        lengths = rng.integers(1, t + 1, size=b)
        lengths[0] = t
        pad_np = np.arange(t)[None, :] >= lengths[:, None]
        pad_np[b - 1] = True                   # a row with no valid key
        pad = torch.from_numpy(pad_np).to(dev)
        bias = fd.padding_bias(pad, b, t, dev)
        scale = 1.0 / math.sqrt(d)
        err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        rms = dict(err)
        for p in (0.0, FD_P):
            seed = SEED + 7 * t + int(100 * p)
            ops = fd.to_bf16(q, k, v, do)
            o, lse = fd.flash_dropout_fwd(q, k, v, bias, seed, p, scale,
                                          operands=ops[:3])
            want_o, want_lse = fd.flash_attention_dropout_reference(
                q, k, v, bias, seed, p, scale)
            # both backward versions on the plain forward's O and lse, and
            # both dK/dV on the plain D; the kernel's dK/dV on dQ's bits,
            # the plain one on the mask drawn from the seed
            qkv, rest = (q, k, v, bias, seed), (want_lse, do, p, scale)
            dq, delta, bits = fd.flash_dropout_dq(*qkv, want_o, *rest,
                                                  operands=ops)
            want_dq, want_delta = fd.flash_dropout_dq_reference(
                *qkv, want_o, *rest)
            dk, dv = fd.flash_dropout_dkv(*qkv, want_delta, *rest, bits=bits,
                                          operands=ops)
            again = (*fd.flash_dropout_dq(*qkv, want_o, *rest, operands=ops),
                     *fd.flash_dropout_dkv(*qkv, want_delta, *rest,
                                           bits=bits, operands=ops))
            torch.cuda.synchronize()
            tag = f"B={b} T={t} d={d} p={p}"
            if not all(x is y or torch.equal(x, y) for x, y in
                       zip((dq, delta, bits, dk, dv), again)):
                raise AssertionError(f"backward {tag}: two launches differ")
            if p and not torch.equal(bits, fd.pack_keep_bits(
                    fd.keep_mask_reference(b, h, t, seed, p, dev))):
                raise AssertionError(f"dQ keep bits {tag}: not the mask's")
            torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-5)
            want_dk, want_dv = fd.flash_dropout_dkv_reference(
                *qkv, want_delta, *rest)
            for name, pairs in (
                    ("fwd", ((o, want_o, "O"),)),
                    ("dq", ((dq, want_dq, "dQ"), (delta, want_delta, "D"))),
                    ("dkv", ((dk, want_dk, "dK"), (dv, want_dv, "dV")))):
                for got, want, what in pairs:
                    e, r = fd_compare(got, want, f"{what} {tag}")
                    err[name], rms[name] = max(err[name], e), max(rms[name], r)
            del (o, lse, want_o, want_lse, dq, delta, want_dq, want_delta, dk,
                 dv, want_dk, want_dv, bits, again, ops)
        seed = SEED + 7 * t + int(100 * FD_P)
        mask = fd.keep_mask(b, h, t, seed, FD_P, dev)
        torch.cuda.synchronize()
        if not torch.equal(mask, fd.keep_mask_reference(b, h, t, seed, FD_P,
                                                        dev)):
            raise AssertionError(f"keep mask B={b} T={t}: not bit-identical")
        # a data-parallel shard's rows: bh counted from its first global row
        off = fd.keep_mask(b - 1, h, t, seed, FD_P, dev, bh_offset=h)
        if not torch.equal(off, mask[1:]):
            raise AssertionError(f"keep mask B={b} T={t}: bh_offset {h} does "
                                 "not give rows 1.. of the whole mask")
        del off
        rate = float(mask.double().mean())
        sigma = math.sqrt(FD_P * (1 - FD_P) / mask.numel())
        if not abs(rate - (1 - FD_P)) <= 5 * sigma:
            raise AssertionError(f"keep rate {rate} not within 5 sigma of "
                                 f"{1 - FD_P}")
        del mask

        # times at the training setting, p = FD_P: the three kernels as
        # training launches them, on operands cast to bf16 once; each at
        # p = 0, without the mask; and the forward and the backward as
        # training runs them (the autograd function's: the casts and the
        # kernels) at both p
        ops = fd.to_bf16(q, k, v, do)
        o, lse = fd.flash_dropout_fwd(q, k, v, bias, seed, FD_P, scale,
                                      operands=ops[:3])
        qkv, rest = (q, k, v, bias, seed), (lse, do, FD_P, scale)
        _, delta, bits = fd.flash_dropout_dq(*qkv, o, *rest, operands=ops)
        reps = max(3, min(50, int(3e5 / t)))
        plain_reps = max(2, reps // 10)

        def backward_ms(p):
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            out = fd.flash_attention_dropout(qg, kg, vg, bias, seed, p, scale)
            return cuda_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), reps)

        def forward_ms(p):
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            return cuda_ms(lambda: fd.flash_attention_dropout(
                qg, kg, vg, bias, seed, p, scale), reps)

        kern = {"fwd": lambda: fd.flash_dropout_fwd(q, k, v, bias, seed,
                                                    FD_P, scale,
                                                    operands=ops[:3]),
                "dq": lambda: fd.flash_dropout_dq(*qkv, o, *rest,
                                                  operands=ops),
                "dkv": lambda: fd.flash_dropout_dkv(*qkv, delta, *rest,
                                                    bits=bits, operands=ops),
                "keep_mask": lambda: fd.keep_mask(b, h, t, seed, FD_P, dev)}
        rest0 = (lse, do, 0.0, scale)
        p0_ms = {"fwd": cuda_ms(lambda: fd.flash_dropout_fwd(
                     q, k, v, bias, seed, 0.0, scale, operands=ops[:3]),
                     reps),
                 "dq": cuda_ms(lambda: fd.flash_dropout_dq(
                     *qkv, o, *rest0, operands=ops), reps),
                 "dkv": cuda_ms(lambda: fd.flash_dropout_dkv(
                     *qkv, delta, *rest0, bits=None, operands=ops), reps)}
        autograd_ms = {FD_P: backward_ms(FD_P), 0.0: backward_ms(0.0)}
        autograd_fwd_ms = {FD_P: forward_ms(FD_P), 0.0: forward_ms(0.0)}
        plain = {"fwd": lambda: fd.flash_attention_dropout_reference(
                     q, k, v, bias, seed, FD_P, scale),
                 "dq": lambda: fd.flash_dropout_dq_reference(*qkv, o, *rest),
                 "dkv": lambda: fd.flash_dropout_dkv_reference(
                     *qkv, delta, *rest),
                 "keep_mask": lambda: fd.keep_mask_reference(
                     b, h, t, seed, FD_P, dev)}
        row = {"B": b, "H": h, "T": t, "d": d, "err": err, "p0_ms": p0_ms,
               "autograd_ms": autograd_ms, "autograd_fwd_ms": autograd_fwd_ms}
        for name in kern:
            row[name] = {"ms": cuda_ms(kern[name], reps),
                         "plain_ms": cuda_ms(plain[name], plain_reps,
                                             warmup=1)}
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        attend = ~pad[:, None, None, :]
        row["fwd"]["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=attend, dropout_p=FD_P, scale=scale),
            reps)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qb, kb, vb))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attend,
                                             dropout_p=FD_P, scale=scale)
        dob = do.to(torch.bfloat16)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), dob, retain_graph=True), reps)
        row["dq"]["library_ms"] = row["dkv"]["library_ms"] = bwd_ms
        row["keep_mask"]["library_ms"] = None
        for name, (bms, by) in fd_bounds(b, h, t, d).items():
            row[name].update(bound_ms=bms, bound_by=by)
        rows.append(row)
        print(f"flash dropout B={b} T={t:5d} d={d:3d}: max|diff| O "
              f"{err['fwd']:.3e} dQ/D {err['dq']:.3e} dK/dV {err['dkv']:.3e}"
              f"; rms diff / rms O {rms['fwd']:.2e} dQ/D {rms['dq']:.2e} "
              f"dK/dV {rms['dkv']:.2e}; mask bit-identical, keep rate "
              f"{rate:.5f}")
        for name in kern:
            r = row[name]
            lib = ("" if r["library_ms"] is None else
                   f"  sdpa {'fwd' if name == 'fwd' else 'bwd'} "
                   f"{r['library_ms']:.4f} ms")
            p0 = (f"  (p=0: {p0_ms[name]:.4f} ms, mask share "
                  f"{1 - p0_ms[name] / r['ms']:.1%})" if name in p0_ms
                  else "")
            print(f"  {name:9s} kernel {r['ms']:.4f} ms{p0}  plain "
                  f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){lib}")
        print(f"  forward as training runs it (autograd: q, k, v casts, "
              f"kernel) {autograd_fwd_ms[FD_P]:.4f} ms (p=0: "
              f"{autograd_fwd_ms[0.0]:.4f} ms); sdpa fwd "
              f"{row['fwd']['library_ms']:.4f} ms")
        print(f"  backward as training runs it (autograd: dO cast, dQ, "
              f"dK/dV) {autograd_ms[FD_P]:.4f} ms (p=0: "
              f"{autograd_ms[0.0]:.4f} ms); dQ + dK/dV alone "
              f"{row['dq']['ms'] + row['dkv']['ms']:.4f} ms; sdpa bwd "
              f"{bwd_ms:.4f} ms")
        del (q, k, v, do, o, lse, delta, qb, kb, vb, qg, kg, vg, out, dob,
             ops, bits)
    # per micro-step at the largest bucket pair: 4 encoder launches at
    # T=256 and 4 decoder launches at T=3584
    step = [r for r in rows if (r["T"], r["d"]) in ((256, 128), (3584, 128))]
    report = {}
    for name in ("fwd", "dq", "dkv", "keep_mask"):
        report[name] = {key: (None if step[0][name][key] is None
                              else 4 * sum(r[name][key] for r in step))
                        for key in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")}
        report[name]["bound_by"] = max(step, key=lambda r: r[name][
            "bound_ms"])[name]["bound_by"]
        p0 = (f" (p=0: {4 * sum(r['p0_ms'][name] for r in step):.4f} ms)"
              if name in step[0]["p0_ms"] else "")
        lib = ("" if report[name]["library_ms"] is None else
               f"  sdpa {'fwd' if name == 'fwd' else 'bwd'} "
               f"{report[name]['library_ms']:.4f} ms")
        print(f"{name} per (256, 3584) micro-step (8 launches): kernel "
              f"{report[name]['ms']:.4f} ms{p0}  plain "
              f"{report[name]['plain_ms']:.4f} ms  bound "
              f"{report[name]['bound_ms']:.4f} ms{lib}")
    print("forward as training runs it, per (256, 3584) micro-step: "
          + ", ".join(f"p={p}: "
                      f"{4 * sum(r['autograd_fwd_ms'][p] for r in step):.4f}"
                      " ms" for p in (FD_P, 0.0))
          + f"; sdpa fwd {report['fwd']['library_ms']:.4f} ms")
    print("backward as training runs it, per (256, 3584) micro-step: "
          + ", ".join(f"p={p}: {4 * sum(r['autograd_ms'][p] for r in step):.4f}"
                      " ms" for p in (FD_P, 0.0))
          + f"; sdpa bwd {report['dq']['library_ms']:.4f} ms")
    print(f"keep-mask kernel: {fd.KEEP_MASK.launches} launches in this "
          "phase, its oracle role (training never launches it)")
    return {"report": report,
            "max_abs_err": {n: max(r["err"][n] for r in rows)
                            for n in ("fwd", "dq", "dkv")},
            "checked": {(r["B"], r["T"], r["d"]) for r in rows}}


def write_train_corpus(root, n_speaker: int, ranges: dict, per_pair: dict,
                       seed: int):
    """A seeded TTE corpus in the format `data/tte_data.py::TTEDataset`
    reads: <root>/tte/{train,val}.txt manifests, speakers.json, and the
    aligner's symbols under <root>/aligner. ranges: bucket pair ->
    ((min, max) tokens, (min, max) codes); each pair gets per_pair[split]
    utterances (durations >= 1 summing to the code count)."""
    from pathlib import Path

    root = Path(root)
    rng = np.random.default_rng(seed)
    symbols = list("abcdefghijklmnopqrstuvwxyz")
    (root / "aligner").mkdir(parents=True)
    (root / "aligner" / "symbols.json").write_text(json.dumps(symbols))
    (root / "tte").mkdir()
    speakers = {f"spk{i}": i for i in range(n_speaker)}
    (root / "tte" / "speakers.json").write_text(json.dumps(speakers))
    for split, count in per_pair.items():
        lines = []
        for (s_lo, s_hi), (t_lo, t_hi) in ranges.values():
            for i in range(count):
                n_tok = int(rng.integers(s_lo, s_hi + 1))
                n_code = int(rng.integers(max(t_lo, n_tok), t_hi + 1))
                durs = rng.multinomial(n_code - n_tok,
                                       np.full(n_tok, 1.0 / n_tok)) + 1
                spk = f"spk{i % n_speaker}"
                lines.append(str({
                    "audio": f"/corpus/{spk}_{split}_{len(lines):04d}.wav",
                    "hubert": " ".join(map(str, rng.integers(0, 1000,
                                                             n_code))),
                    "duration": " ".join(map(str, durs)),
                    "speaker": spk,
                    "characters": " ".join(rng.choice(symbols, n_tok)),
                }))
        (root / "tte" / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return root / "tte", root / "aligner"


def bucket_ranges(pairs, train_cfg, max_len: int) -> dict:
    """(src, tgt) pair -> ((min, max) tokens, (min, max) codes) of the
    utterances the loader puts in that pair (codes capped at max_len)."""
    def lower(buckets, x):
        return max((b for b in buckets if b < x), default=x // 2) + 1

    return {(s, t): ((lower(train_cfg.src_buckets, s), s),
                     (lower(train_cfg.tgt_buckets, t), min(t, max_len)))
            for s, t in pairs}


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic implementations (the length regulator's gather
    backward, a scatter-add, has atomics otherwise), without filling new
    tensors with NaN; the previous settings restored on exit."""
    import torch.utils.deterministic as det

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def phase_train(fd, fa, tcfg, train_cfg, pairs, checked: set,
                checked_eval: set, device=None) -> dict:
    """TTE training through pipeline/train_tte.run: 2 optimizer steps (8
    micro-batches, 4 per bucket pair) from a seeded corpus, then the
    checks; a resumed run; and the kernels' loss and gradients against
    plain attention at one (256, 3584) micro-batch at dropout 0, on the
    seeded initial weights the training starts from."""
    import tempfile

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.data.tte_data import BucketedLoader, TTEDataset
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.ops import attention
    from parrot_tts_tpu_torch.pipeline import train_tte
    from parrot_tts_tpu_torch.train import tte as tte_train

    acc = train_cfg.grad_acc_steps
    n_blocks = tcfg.encoder.n_layer + tcfg.decoder.n_layer
    records: list = []
    real_step = tte_train._micro_step

    def micro_step(state, batch, *args):
        before = [p.detach().clone() for p in state.model.parameters()]
        counts = (fd.FWD.launches, fd.DQ.launches, fd.DKV.launches)
        start = state.step
        metrics = real_step(state, batch, *args)
        changed = any(not torch.equal(a, p) for a, p in
                      zip(before, state.model.parameters()))
        records.append({
            "start": start, "loss": float(metrics["total_loss"]),
            "changed": changed, "shape": tuple(batch["codes"].shape),
            "launches": (fd.FWD.launches - counts[0],
                         fd.DQ.launches - counts[1],
                         fd.DKV.launches - counts[2]),
            "state": state})
        return metrics

    def attention_key(q, *args, **kwargs):
        return tuple(q.shape[i] for i in (0, 2, 3))

    with tempfile.TemporaryDirectory(prefix="parrot_train_") as tmp:
        per_pair = {"train": acc * train_cfg.batch_size,
                    "val": train_cfg.batch_size}
        root, align = write_train_corpus(
            tmp, tcfg.n_speaker, bucket_ranges(pairs, train_cfg,
                                               tcfg.max_len),
            per_pair, SEED + 4)
        cfg = PipelineConfig(root_path=str(root), alignment_path=str(align),
                             tte_model=tcfg, tte_train=train_cfg)
        run_dir = f"{tmp}/run"
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(tte_train, "_micro_step",
                                                  micro_step))
            seen = {name: stack.enter_context(recording(fd, name,
                                                        attention_key))
                    for name in ("flash_dropout_fwd", "flash_dropout_dq",
                                 "flash_dropout_dkv")}
            seen_eval = stack.enter_context(recording(
                attention, "flash_attention", attention_key))
            for kern in (fd.FWD, fd.DQ, fd.DKV, fd.KEEP_MASK, fa.FLASH_FWD):
                kern.launches = 0
            t0 = time.perf_counter()
            out = train_tte.run(cfg, run_dir=run_dir, max_steps=2,
                                device=device)
            wall = time.perf_counter() - t0
            launches = {"fwd": fd.FWD.launches, "dq": fd.DQ.launches,
                        "dkv": fd.DKV.launches,
                        "keep_mask": fd.KEEP_MASK.launches,
                        "flash_attn_fwd": fa.FLASH_FWD.launches}
        print(f"train: {out}, {len(records)} micro-steps in {wall:.3f} s "
              f"(first use included); launches {launches}")
        for r in records:
            print(f"  micro-step {r['start']}: codes {r['shape']}, loss "
                  f"{r['loss']:.5f}, params changed {r['changed']}, rows 2-4 "
                  f"launches {r['launches']}")
        if out["steps"] != 2 or len(records) != 2 * acc:
            raise AssertionError(f"{out}, {len(records)} micro-steps")
        if not all(math.isfinite(r["loss"]) for r in records):
            raise AssertionError("a non-finite loss")
        if [r["changed"] for r in records] != [(i + 1) % acc == 0
                                               for i in range(2 * acc)]:
            raise AssertionError("params did not change at exactly every "
                                 f"{acc}-th micro-step")
        if any(r["launches"] != (n_blocks,) * 3 for r in records):
            raise AssertionError(f"rows 2-4 not launched {n_blocks} times "
                                 "each per micro-step")
        tgts = {r["shape"][1] for r in records}
        if tgts != {t for _, t in pairs}:
            raise AssertionError(f"micro-batches at codes {tgts}")
        for name, shapes in seen.items():
            if device is None and not shapes <= checked:
                raise AssertionError(f"{name} at {sorted(shapes - checked)},"
                                     " which phase 10 did not check")
        if device is None and not seen_eval <= checked_eval:
            raise AssertionError(f"evaluation attention at "
                                 f"{sorted(seen_eval - checked_eval)}, "
                                 "which phase 3 did not check")

        # the checkpoint holds the live state, bit for bit
        state = records[-1]["state"]
        mgr = CheckpointManager(f"{run_dir}/ckpt")
        saved = mgr.restore()
        live = state.state_dict()
        for part in ("params", "mu", "nu", "acc"):
            for key, x in live[part].items():
                if not torch.equal(saved[part][key], x.cpu()):
                    raise AssertionError(f"checkpoint {part}.{key} differs")
        if (saved["step"], saved["count"], mgr.latest_step()) != (
                2 * acc, 2, 2):
            raise AssertionError(f"checkpoint step {saved['step']}, count "
                                 f"{saved['count']}")
        # a resumed run carries on from micro-step 2 * acc
        records.clear()
        with mock.patch.object(tte_train, "_micro_step", micro_step):
            out2 = train_tte.run(cfg, run_dir=run_dir, max_steps=3,
                                 device=device)
        if out2["steps"] != 3 or records[0]["start"] != 2 * acc:
            raise AssertionError(f"resume: {out2}, first micro-step "
                                 f"{records[0]['start']}")
        print(f"resumed: {out2}, first micro-step {records[0]['start']}; "
              "checkpoint restored params, moments and step bit for bit")

        # kernels against plain attention at one (256, 3584) micro-batch,
        # dropout 0, IEEE float32 elsewhere
        ds = TTEDataset(root, align, "train", tcfg.hubert_codes)
        loader = BucketedLoader(ds, train_cfg.batch_size,
                                train_cfg.src_buckets, train_cfg.tgt_buckets,
                                seed=train_cfg.seed)
        batch_np = next(b for b in loader.batches(0)
                        if b["codes"].shape[1] == pairs[-1][1])
    # compared on a state that is the same in every run: the seeded
    # initial weights (`train/tte.py::init_state`), not the trained state,
    # which TF32 training and cuDNN's algorithm choice make differ from run
    # to run
    cfg0 = dataclasses.replace(
        state.model.cfg, dur_dropout_p=0.0,
        encoder=dataclasses.replace(tcfg.encoder, dropout_p=0.0),
        decoder=dataclasses.replace(tcfg.decoder, dropout_p=0.0))
    model0 = parrot.Parrot(cfg0)
    model0.load_state_dict(parrot.init_parrot(
        cfg0, torch.Generator().manual_seed(train_cfg.seed)), strict=True)
    model0 = model0.to(state.model.pe.device)
    batch = tte_train.to_batch(batch_np, model0.pe.device)
    out_len = batch_np["codes"].shape[1]
    params = list(model0.parameters())

    def loss_and_grads():
        with exact_numerics(True), deterministic_algorithms():
            total, _ = tte_train.loss_fn(model0, batch, cfg0, out_len,
                                         (SEED, 0))
            return float(total.detach()), torch.autograd.grad(total,
                                                              params)

    def plain_fwd(*args, operands, bh_offset):
        return fd.flash_attention_dropout_reference(*args, bh_offset)

    def plain_dq(*args, operands, bh_offset):
        return (*fd.flash_dropout_dq_reference(*args, bh_offset), None)

    def plain_dkv(*args, bits, operands, bh_offset):
        return fd.flash_dropout_dkv_reference(*args, bh_offset)

    before = fd.FWD.launches
    loss_k, grads_k = loss_and_grads()
    kernel_launches = fd.FWD.launches - before
    loss_r, grads_r = loss_and_grads()
    repeat = loss_r == loss_k and all(torch.equal(a, b) for a, b in
                                      zip(grads_k, grads_r))
    print(f"kernel loss and gradients taken twice: bit-equal {repeat}")
    if not repeat:
        raise AssertionError("the parity comparison is not reproducible")
    del grads_r
    with mock.patch.object(fd, "flash_dropout_fwd", plain_fwd), \
            mock.patch.object(fd, "flash_dropout_dq", plain_dq), \
            mock.patch.object(fd, "flash_dropout_dkv", plain_dkv):
        loss_p, grads_p = loss_and_grads()
    if device is None and kernel_launches != n_blocks:
        raise AssertionError(f"{kernel_launches} forward launches")
    dl = abs(loss_k - loss_p) / abs(loss_p)
    num = sum(float((a - b).pow(2).sum()) for a, b in zip(grads_k, grads_p))
    den = sum(float(b.pow(2).sum()) for b in grads_p)
    rel = math.sqrt(num / den)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(grads_k, grads_p))
    print(f"kernels against plain attention at codes {tuple(batch_np['codes'].shape)},"
          f" dropout 0, initial weights: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {dl:.2e}), |dg|/|g| {rel:.2e}, worst tensor max|dg|/max|g| "
          f"{worst:.2e}")
    if not (dl <= TRAIN_LOSS_RTOL and rel <= TRAIN_GRAD_RTOL
            and worst <= TRAIN_GRAD_MAX):
        raise AssertionError("training with the kernels departs from plain "
                             "attention")
    return {"launches": launches, "state": state, "cfg": state.model.cfg,
            "batch": batch, "out_len": out_len}


def phase_train_profile(state, model_cfg, train_cfg, batch, out_len) -> None:
    """One more micro-step at (256, 3584) under torch.profiler, and
    micro-steps per second over one optimizer step (a reading, not a
    benchmark)."""
    from parrot_tts_tpu_torch.train import tte as tte_train

    def step():
        tte_train.train_step(state, batch, SEED, model_cfg, train_cfg,
                             out_len)
        torch.cuda.synchronize()

    step()
    phase_profile(step, f"training micro-step at codes "
                        f"{tuple(batch['codes'].shape)}")
    n = train_cfg.grad_acc_steps
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    dt = time.perf_counter() - t0
    print(f"training reading: {n} micro-steps (one optimizer step) in "
          f"{dt:.3f} s = {n / dt:.3f} micro-steps/s at codes "
          f"{tuple(batch['codes'].shape)}")


def phase_gemm(qc) -> dict:
    """The row-8 GEMM against its plain version (int8 equal, bf16 and
    float32 within MM_RTOL * sqrt(K) of max |plain|) at the rate shape, a
    ragged and a small shape, each with the plan's branch; kernel, plain,
    bound and library ms at the rate shape, and the int8 B^T pass alone."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases = [(RATE_SHAPE, (torch.int8, torch.bfloat16))] + [
        (shape, (torch.int8, torch.bfloat16, torch.float32))
        for shape in ((1000, 1000, 1000), (17, 33, 9))]
    report, err_max = {}, 0.0
    for (m, k, n), dtypes in cases:
        for dtype in dtypes:
            if dtype == torch.int8:
                a, b = (torch.randint(-127, 128, s, generator=gen,
                                      device="cuda", dtype=torch.int8)
                        for s in ((m, k), (k, n)))
            else:
                a, b = (torch.randn(s, generator=gen, device="cuda"
                                    ).to(dtype) for s in ((m, k), (k, n)))
            got = qc.matmul(a, b)
            want = qc.matmul_reference(a, b)
            torch.cuda.synchronize()
            if dtype == torch.int8:
                if not torch.equal(got, want):
                    raise AssertionError(f"GEMM int8 {(m, k, n)}: not equal")
                err, lim = 0.0, 0.0
            else:
                err = float((got - want).abs().max())
                lim = MM_RTOL * math.sqrt(k) * float(want.abs().max())
                if not err <= lim:
                    raise AssertionError(f"GEMM {dtype} {(m, k, n)}: max "
                                         f"|diff| {err} > {lim}")
            err_max = max(err_max, err)
            plan = qc.gemm_plan(m, k, n, dtype)
            line = (f"GEMM (M, K, N) = {(m, k, n)} {str(dtype)[6:]}: "
                    f"max|diff| {err:.3e} (limit {lim:.3e})  {plan['route']}"
                    f", branch {plan['branch']}")
            if (m, k, n) == RATE_SHAPE:
                ops = 2.0 * m * k * n
                esize = a.element_size()
                bound_ms, bound_by = bound(
                    ops, INT8_PEAK if dtype == torch.int8 else BF16_PEAK,
                    esize * (m * k + k * n) + 4.0 * m * n)
                row = {"ms": cuda_ms(lambda: qc.matmul(a, b), 20),
                       "plain_ms": cuda_ms(lambda: qc.matmul_reference(a, b),
                                           3, warmup=1),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": cuda_ms(
                           (lambda: torch._int_mm(a, b)) if dtype == torch.int8
                           else (lambda: torch.matmul(a, b)), 20)}
                report[dtype] = row
                unit = "TOP/s" if dtype == torch.int8 else "TFLOP/s"
                peak = (INT8_PEAK if dtype == torch.int8 else BF16_PEAK) / 1e12
                line += (f"  kernel {row['ms']:.4f} ms "
                         f"({ops / row['ms'] / 1e9:.1f} {unit} of {peak:.0f}, "
                         f"{100 * bound_ms / row['ms']:.1f}% of the bound)  "
                         f"plain {row['plain_ms']:.4f} ms  bound "
                         f"{bound_ms:.4f} ms ({bound_by})  "
                         f"{'torch._int_mm' if dtype == torch.int8 else 'torch.matmul'}"
                         f" {row['library_ms']:.4f} ms")
                if dtype == torch.int8:
                    bt_ms = cuda_ms(lambda: qc.transpose_int8_b(
                        b, plan["ldb"]), 20)
                    line += (f"\nGEMM int8 B^T pass alone (part of the kernel"
                             f" time above): {bt_ms:.4f} ms, {2 * k * n} bytes"
                             f" ({2 * k * n / bt_ms / 1e6:.1f} GB/s; the bytes"
                             f" bound {2e3 * k * n / HBM_RATE:.4f} ms)")
            print(line)
            del a, b, got, want
    return {"report": report[torch.int8], "max_abs_err": err_max}


def phase_int8_experiment(qc) -> int:
    """The ported int8 experiment, parts 1 and 2, with few repetitions;
    returns the GEMM launches it made."""
    from parrot_tts_tpu_torch.scripts import exp_int8_rate

    qc.MATMUL.launches = 0
    t0 = time.perf_counter()
    exp_int8_rate.run(reps=3, out=lambda line: print(f"  {line}"))
    launches = qc.MATMUL.launches
    print(f"int8 experiment: {time.perf_counter() - t0:.2f} s, GEMM "
          f"launches {launches}")
    if launches == 0:
        raise AssertionError("the int8 experiment never launched the GEMM")
    return launches


GAN_STEPS = 4                # phase 14's training steps
GAN_TIMED = 5                # warm steps of its steps-per-second reading
# phase 14's parity: one full-width GAN step in IEEE float32 against the
# same step in float64 on the card, from the seeded initial state
GAN_LOSS_RTOL = 1e-4
GAN_GRAD_RTOL = 1e-3         # |dg| / |g| per network
GAN_GRAD_MAX = 1e-2          # max |dg| <= this * max |g|, per tensor
# kinds of kernel in phase 14's profiled step, by name
GAN_PROFILE_SPLIT = (
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions", ("conv", "cudnn", "cutlass", "xmma", "implicit_gemm",
                      "dgrad", "wgrad")),
    ("AdamW (fused)", ("fused_adam", "FusedAdam", "multi_tensor")),
    ("FFT", ("fft", "FFT")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def write_vocoder_corpus(root, n_train: int, n_val: int, seconds,
                         seed: int):
    """A seeded vocoder corpus in the format `data/vocoder_data.py` reads:
    16 kHz wavs of `seconds` = (min, max) length over two speakers (file
    names spk0_x_* / spk1_x_*), and train.txt / val.txt manifests of random
    HuBERT units at 50 per second."""
    from pathlib import Path

    from parrot_tts_tpu_torch.data.audio_io import write_wav
    from parrot_tts_tpu_torch.data.manifest import write_manifest

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        entries = []
        for i in range(n):
            n_samp = int(16000 * rng.uniform(*seconds))
            path = root / "wavs" / f"spk{i % 2}_x_{split}_{i:03d}.wav"
            # a few harmonics under noise, so the mel is not flat
            t = np.arange(n_samp) / 16000.0
            f0 = rng.uniform(90, 250)
            wav = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in (1, 2, 3))
            write_wav(path, 0.3 * wav + 0.05 * rng.standard_normal(n_samp),
                      16000)
            entries.append({"audio": str(path), "hubert": " ".join(map(
                str, rng.integers(0, 1000, n_samp * 50 // 16000)))})
        write_manifest(root / f"{split}.txt", entries)
    return root


def to_float64(state):
    """The GAN state in float64 (networks, buffers and moments; the
    parameters stay the optimizers' own)."""
    for m in (state.gen, state.mpd, state.msd):
        m.double()
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                st[key] = st[key].double()
    return state


def gan_grads(state) -> dict:
    """Each network's gradients of the state's one update from zero
    moments: the first moment is (1 - b1) g."""
    mu = state.moments()
    nets = {"G": mu["mu_g"],
            "MPD": {k: v for k, v in mu["mu_d"].items()
                    if k.startswith("mpd.")},
            "MSD": {k: v for k, v in mu["mu_d"].items()
                    if k.startswith("msd.")}}
    return {n: {k: v.double() for k, v in d.items()} for n, d in nets.items()}


def phase_gan(mcfg, tcfg, mel_cfg, corpus: dict, device=None) -> dict:
    """Vocoder GAN training at full width through pipeline/train_vocoder.run
    for GAN_STEPS steps on a seeded corpus, with the checks; a resumed run;
    one step in IEEE float32 against float64 from the seeded initial
    state; steps per second and a profiled step (readings)."""
    import tempfile

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.core.device import resolve_device
    from parrot_tts_tpu_torch.data.vocoder_data import (VocoderDataset,
                                                        VocoderLoader)
    from parrot_tts_tpu_torch.pipeline import train_vocoder
    from parrot_tts_tpu_torch.train import vocoder as voc_train

    dev = resolve_device(device)
    records: list = []
    real_step = voc_train.train_step

    def step_spy(state, *args, **kwargs):
        nets = (state.gen, state.mpd, state.msd)
        before = [[p.detach().clone() for p in m.parameters()] for m in nets]
        u0 = state.msd.discriminators[0].convs[0].weight_u.clone()
        start = state.step
        t0 = time.perf_counter()
        metrics = real_step(state, *args, **kwargs)
        values = {k: float(v) for k, v in metrics.items()}
        records.append({
            "start": start, "s": time.perf_counter() - t0, **values,
            "changed": [all(not torch.equal(a, p) for a, p in
                            zip(b, m.parameters()))
                        for b, m in zip(before, nets)],
            "u_moved": not torch.equal(
                u0, state.msd.discriminators[0].convs[0].weight_u),
            "state": state})
        return metrics

    with tempfile.TemporaryDirectory(prefix="parrot_gan_") as tmp:
        data = write_vocoder_corpus(tmp, seed=SEED + 7, **corpus)
        cfg = PipelineConfig(vocoder_model=mcfg, vocoder_train=tcfg,
                             mel=mel_cfg)
        run_dir = f"{tmp}/run"
        with mock.patch.object(voc_train, "train_step", step_spy):
            t0 = time.perf_counter()
            out = train_vocoder.run(cfg, data_dir=data, run_dir=run_dir,
                                    max_steps=GAN_STEPS, device=device)
            wall = time.perf_counter() - t0
        print(f"GAN train: {out}, {len(records)} steps in {wall:.3f} s "
              f"(first use, corpus load and checkpoints included)")
        for r in records:
            print(f"  step {r['start']}: {r['s']:.3f} s, D loss "
                  f"{r['loss_disc_all']:.5f}, G loss {r['loss_gen_all']:.5f},"
                  f" mel error {r['mel_error']:.5f}; G / MPD / MSD every "
                  f"tensor changed {r['changed']}, MSD scale-0 u advanced "
                  f"{r['u_moved']}")
        if out["steps"] != GAN_STEPS or len(records) != GAN_STEPS:
            raise AssertionError(f"GAN run: {out}, {len(records)} steps")
        if not all(math.isfinite(r[k]) for r in records
                   for k in ("loss_disc_all", "loss_gen_all", "mel_error")):
            raise AssertionError("a non-finite GAN loss")
        if not all(all(r["changed"]) and r["u_moved"] for r in records):
            raise AssertionError("a GAN step left a network or the MSD's "
                                 "power-iteration vector unchanged")
        logs = [json.loads(line) for line in
                open(f"{run_dir}/logs/metrics.jsonl")]
        val = [x["value"] for x in logs
               if x["tag"] == "validation/mel_spec_error"]
        if len(val) != GAN_STEPS // tcfg.validation_interval or not all(
                math.isfinite(v) for v in val):
            raise AssertionError(f"validation mel errors {val}")
        rates = [round(x["value"], 3) for x in logs
                 if x["tag"] == "train_audio_seconds_per_second"]
        print(f"validation mel error {val}; train audio-s/s logged {rates}")
        # the checkpoint holds the live state, bit for bit
        live = records[-1]["state"].state_dict()
        mgr = CheckpointManager(f"{run_dir}/ckpt")
        saved = mgr.restore()
        for part in ("gen", "mpd", "msd", "mu_g", "nu_g", "mu_d", "nu_d"):
            if saved[part].keys() != live[part].keys() or not all(
                    torch.equal(saved[part][k], v.cpu())
                    for k, v in live[part].items()):
                raise AssertionError(f"checkpoint {part} differs")
        if (saved["step"], mgr.latest_step()) != (GAN_STEPS, GAN_STEPS):
            raise AssertionError(f"checkpoint step {saved['step']}")
        del live, saved
        records.clear()
        with mock.patch.object(voc_train, "train_step", step_spy):
            out2 = train_vocoder.run(cfg, data_dir=data, run_dir=run_dir,
                                     max_steps=GAN_STEPS + 1, device=device)
        if out2["steps"] != GAN_STEPS + 1 or [r["start"] for r in records] \
                != [GAN_STEPS]:
            raise AssertionError(f"resume: {out2}, steps "
                                 f"{[r['start'] for r in records]}")
        print(f"resumed: {out2}, first step {records[0]['start']}; the "
              "checkpoint held the networks, buffers, moments and step "
              "bit for bit")
        records.clear()
        ds = VocoderDataset(data / "train.txt",
                            segment_size=tcfg.segment_size,
                            code_hop_size=tcfg.code_hop_size)
        batch_np = next(VocoderLoader(ds, tcfg.batch_size,
                                      seed=tcfg.seed).batches(0))
        steps_per_epoch = max(1, len(ds) // tcfg.batch_size)

    # one step from the seeded initial state: IEEE float32 (twice) against
    # float64, deterministic algorithms
    def one_step(float64: bool):
        state = voc_train.init_state(tcfg.seed, mcfg, dev)
        batch = voc_train.to_batch(batch_np, dev)
        if float64:
            state = to_float64(state)
            batch["audio"] = batch["audio"].double()
        with deterministic_algorithms():
            m = voc_train.train_step(state, batch, mcfg, tcfg, mel_cfg,
                                     steps_per_epoch, exact=True)
        return {k: float(v) for k, v in m.items()}, state

    m32, s32 = one_step(False)
    m32b, s32b = one_step(False)
    a, b = s32.state_dict(), s32b.state_dict()
    repeat = m32 == m32b and all(
        torch.equal(a[p][k], b[p][k]) for p in a if isinstance(a[p], dict)
        for k in a[p])
    print(f"GAN step in float32 taken twice: bit-equal {repeat}")
    if not repeat:
        raise AssertionError("the float32 GAN step is not reproducible")
    del s32b, a, b
    m64, s64 = one_step(True)
    g32, g64 = gan_grads(s32), gan_grads(s64)
    del s32, s64
    fails = []
    for k in m32:
        rel = abs(m32[k] - m64[k]) / abs(m64[k])
        print(f"  {k}: float32 {m32[k]:.8f} float64 {m64[k]:.8f} rel "
              f"{rel:.2e}")
        if not rel <= GAN_LOSS_RTOL:
            fails.append(k)
    for net in g32:
        num = sum(float((g32[net][k] - v).pow(2).sum())
                  for k, v in g64[net].items())
        den = sum(float(v.pow(2).sum()) for v in g64[net].values())
        worst = max(float((g32[net][k] - v).abs().max())
                    / max(float(v.abs().max()), 1e-30)
                    for k, v in g64[net].items())
        rel = math.sqrt(num / den)
        print(f"  {net} gradients: |dg|/|g| {rel:.2e}, worst tensor "
              f"max|dg|/max|g| {worst:.2e} ({len(g64[net])} tensors)")
        if not (rel <= GAN_GRAD_RTOL and worst <= GAN_GRAD_MAX):
            fails.append(net)
    if fails:
        raise AssertionError(f"GAN step float32 against float64: {fails}")
    del g32, g64

    # readings: steps per second and one profiled step, as training runs
    # (TF32 convolutions)
    state = voc_train.init_state(tcfg.seed, mcfg, dev)
    batch = voc_train.to_batch(batch_np, dev)

    def step():
        voc_train.train_step(state, batch, mcfg, tcfg, mel_cfg,
                             steps_per_epoch)

    ms = None
    if dev.type == "cuda":
        ms = cuda_ms(step, GAN_TIMED)
        audio_s = tcfg.batch_size * tcfg.segment_size / mel_cfg.sampling_rate
        print(f"GAN reading: {1e3 / ms:.3f} steps/s ({ms:.3f} ms per step "
              f"over {GAN_TIMED} warm steps, CUDA events; "
              f"{audio_s * 1e3 / ms:.3f} audio-s/s of {audio_s:.2f} s "
              f"segments per step)")
        phase_profile(lambda: (step(), torch.cuda.synchronize()),
                      f"GAN step at batch {tcfg.batch_size} x "
                      f"{tcfg.segment_size} samples", GAN_PROFILE_SPLIT)
    return {"records": records, "batch_np": batch_np, "ms": ms,
            "steps_per_epoch": steps_per_epoch}


def phase_manifest_io(fa, tts, speakers, device=None) -> None:
    """write_predictions on the phase-4 TTE, for every non-empty request
    and with the serve's encoder buckets (so the same decode batches),
    gives the units that ParrotTTS decodes with exact=True (the mode both
    manifest entry points run); synthesize_text gives a finite waveform of
    len(units) * 320 samples for each."""
    import tempfile
    from pathlib import Path

    from parrot_tts_tpu_torch.data.manifest import parse_manifest_line
    from parrot_tts_tpu_torch.data.tte_data import TTEDataset
    from parrot_tts_tpu_torch.infer import synthesize, tte_infer
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.text.cleaners import english_cleaners

    picked = [i for i, t in enumerate(TEXTS) if len(tts.tokenize(t))]
    tokens = [tts.tokenize(TEXTS[i]) for i in picked]
    spk = [speakers[i] for i in picked]
    want = tte_infer.decode_buckets(
        tts.tte, list(zip(tokens, spk)), tts.plan(tokens),
        batch_size=tts.batch_size, exact=True, device=tts.device)
    with tempfile.TemporaryDirectory(prefix="parrot_pred_") as tmp:
        root = Path(tmp)
        (root / "aligner").mkdir()
        (root / "aligner" / "symbols.json").write_text(json.dumps(
            [" "] + list("abcdefghijklmnopqrstuvwxyz,.?")))
        n_spk = tts.tte_cfg.n_speaker
        (root / "speakers.json").write_text(json.dumps(
            {f"spk{i}": i for i in range(n_spk)}))
        (root / "val.txt").write_text("".join(str({
            "audio": f"{tmp}/req_{i}.wav", "hubert": "0", "duration": "1",
            "speaker": f"spk{s}",
            "characters": " ".join(tts.tokenizer.itos[int(x)] for x in tok),
        }) + "\n" for i, (tok, s) in enumerate(zip(tokens, spk))))
        ds = TTEDataset(root, root / "aligner", "val",
                        tts.tte_cfg.hubert_codes)
        fa.FLASH_FWD.launches = 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # no wavs: durations fall back
            path = tte_infer.write_predictions(
                tts.tte, ds, root / "predictions.txt",
                src_buckets=tts.src_buckets, device=device)
        launches = fa.FLASH_FWD.launches
        got = [parse_manifest_line(line)["hubert"]
               for line in path.read_text().splitlines()]
    same = [g == " ".join(map(str, u.tolist())) for g, u in zip(got, want)]
    print(f"write_predictions: {len(got)} requests of "
          f"{[len(t) for t in tokens]} tokens, units equal to the serve's "
          f"exact decode {same}; row-1 launches {launches}")
    if len(got) != len(want) or not all(same):
        raise AssertionError("write_predictions differs from the serve's "
                             "exact decode")
    if device is None and launches == 0:
        raise AssertionError("write_predictions never launched row 1")
    decoded = []
    real = parrot.infer_codes

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        decoded.append(int(out[1].sum()))
        return out

    lengths = []
    with mock.patch.object(parrot, "infer_codes", spy):
        for i, s in zip(picked, spk):
            decoded.clear()
            wav = synthesize.synthesize_text(
                TEXTS[i], tte_model=tts.tte, tokenizer=tts.tokenizer,
                synthesizer=tts.vocoder, cleaner=english_cleaners,
                speaker_id=s, device=device)
            lengths.append((len(wav), decoded[-1], len(decoded)))
            if len(wav) != decoded[-1] * 320 or not np.isfinite(wav).all():
                raise AssertionError(f"synthesize_text({TEXTS[i]!r}): "
                                     f"{len(wav)} samples for {decoded[-1]}"
                                     " units")
    print(f"synthesize_text: (samples, units, decodes) {lengths}, finite")


# phase 15: HuBERT unit extraction at base width (no TPU kernel on it)
HUB_MARGIN_REL = 1e-4        # codes compared where the nearest-centroid
#                              margin exceeds this * |x|^2 of the frame
HUB_F64_RTOL = 1e-4          # float32 features against float64: max over
#                              frames of |f32 - f64| / |f64| (norms)
HUB_SECONDS = (0.5, 1.2, 2.0, 3.1, 4.4, 5.0, 6.3, 7.7, 9.0, 10.2, 12.5, 14.0,
               16.6, 19.0, 21.7, 24.3, 27.5, 30.1, 33.8, 36.5)
HUB_PER_LENGTH = 3           # wavs of each length (+-5%, so at most
#                              38.3 s: below the 38.4 s bucket), two speakers
HUB_LONG_S = 100.5           # one wav past max_chunk (100 s): the chunk path
HUB_CENTERS = 1000
# phase 16: f0 on the card
F0_ATOL = 1e-2               # Hz on voiced frames, card against CPU
GAN_F0_STEPS = 2


def speech_like(rng, seconds: float, rate: int = 16000) -> np.ndarray:
    """A float wav in [-1, 1]: harmonics of an f0 that glides between
    90 and 250 Hz, syllable-rate amplitude, short pauses, and noise."""
    n = int(seconds * rate)
    t = np.arange(n) / rate
    f0 = rng.uniform(110, 200) * np.exp(0.25 * np.sin(
        2 * np.pi * rng.uniform(0.2, 0.8) * t + rng.uniform(0, 6.3)))
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 5) * t), 0, None) ** 0.5
    return (0.25 * voiced * env
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def hubert_margins(hub, feats: torch.Tensor, centers: torch.Tensor):
    """(codes, margin relative to |x|^2) of feats (T, D) in float64."""
    f = feats.double()
    d2 = hub.kmeans_distances(f, centers.double())
    two = d2.topk(2, dim=-1, largest=False).values
    return (d2.argmin(-1).cpu().numpy(),
            ((two[:, 1] - two[:, 0]) / f.square().sum(-1)).cpu().numpy())


def phase_hubert(cfg, device=None) -> dict:
    """HuBERT unit extraction at `cfg`'s width through extract_units_corpus
    and UnitExtractor, on a seeded corpus in a temp dir, with the checks;
    audio-s/s and one profiled batch (readings)."""
    import copy
    import tempfile
    from pathlib import Path

    from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device
    from parrot_tts_tpu_torch.data.audio_io import read_wav, write_wav
    from parrot_tts_tpu_torch.data.manifest import read_manifest
    from parrot_tts_tpu_torch.infer.unit_extractor import UnitExtractor
    from parrot_tts_tpu_torch.models.hubert import model as hub
    from parrot_tts_tpu_torch.pipeline.extract_units import (
        extract_units_corpus)

    dev = resolve_device(device)
    rng = np.random.default_rng(SEED + 15)
    scale = cfg.max_chunk / 1_600_000       # a tiny rehearsal shrinks it
    seconds = [s * scale * rng.uniform(0.95, 1.05) for s in HUB_SECONDS
               for _ in range(HUB_PER_LENGTH)] + [HUB_LONG_S * scale]
    wavs = [speech_like(rng, s) for s in seconds]
    state = hub.init_hubert(cfg, torch.Generator().manual_seed(SEED + 15))
    model = hub.HubertModel(cfg)
    model.load_state_dict(state, strict=True)
    model.to(dev).eval()
    # what the extractor reads back: int16 sample values in float32
    as_read = [(np.clip(w, -1, 1) * 32767.0).astype(np.int16).astype(
        np.float32) for w in wavs]

    # k-means centers: frames of a first pass's output-layer features at
    # seeded picks, plus a little noise
    feats = []
    for w in as_read[::7]:
        f, _ = hub.apply_hubert(model, w[None], [len(w)], device=dev)
        feats.append(f[0])
    feats = torch.cat(feats)
    pick = torch.as_tensor(rng.choice(len(feats), HUB_CENTERS, replace=False))
    noise = torch.as_tensor(rng.standard_normal(
        (HUB_CENTERS, cfg.d_model)), dtype=torch.float32)
    centers = (feats[pick.to(dev)] + 0.05 * feats.std(0) * noise.to(dev))
    del feats
    ex = UnitExtractor(state, cfg, centers.cpu().numpy(), device=dev)
    buckets = {ex._bucket(len(w)) for w in as_read
               if len(w) <= cfg.max_chunk}
    audio_s = sum(len(w) for w in wavs) / cfg.sample_rate
    print(f"HuBERT corpus: {len(wavs)} wavs, {audio_s:.3f} audio-s, "
          f"{len(buckets)} buckets, longest {max(seconds):.2f} s "
          f"(max_chunk {cfg.max_chunk / cfg.sample_rate:.2f} s)")
    if len(buckets) < 4 or max(len(w) for w in wavs) <= cfg.max_chunk:
        raise AssertionError("the corpus misses a bucket or the chunk path")

    with tempfile.TemporaryDirectory(prefix="parrot_hubert_") as tmp:
        root = Path(tmp) / "corpus"
        for i, w in enumerate(wavs):
            spk = ("spk_a", "spk_b")[i % 2]
            write_wav(root / spk / "wavs" / f"{spk}_{i:03d}.wav", w,
                      cfg.sample_rate)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        entries = extract_units_corpus(ex, root, Path(tmp) / "out")
        wall = time.perf_counter() - t0
        on_disk = read_manifest(Path(tmp) / "out" / "hubert.txt")
        first = read_wav(root / "spk_a" / "wavs" / "spk_a_000.wav")[0]
    if on_disk != entries or not np.array_equal(first, as_read[0]):
        raise AssertionError("hubert.txt differs from the entries, or a "
                             "wav from what was written")
    print(f"extract_units_corpus: {audio_s:.3f} audio-s in {wall:.3f} s = "
          f"{audio_s / wall:.3f} audio-s/s (first pass: wav reads, the "
          "manifest and cuDNN's first use included)")
    # entries follow the sorted paths; map them back to the wavs
    order = sorted(range(len(wavs)),
                   key=lambda i: (("spk_a", "spk_b")[i % 2], i))
    codes = [None] * len(wavs)
    for i, e in zip(order, entries):
        codes[i] = np.array(e["hubert"].split(), np.int64)
    for i, (w, c) in enumerate(zip(as_read, codes)):
        chunks = [min(cfg.max_chunk, len(w) - s)
                  for s in range(0, len(w), cfg.max_chunk)]
        want = sum(hub.feat_extract_output_length(cfg, n) for n in chunks)
        if len(c) != want or not ((c >= 0) & (c < HUB_CENTERS)).all():
            raise AssertionError(f"wav {i}: {len(c)} codes, want {want}, "
                                 f"range [{c.min()}, {c.max()}]")

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = ex.codes_for_wavs(as_read)
    warm = time.perf_counter() - t0
    print(f"codes_for_wavs, second pass: {warm:.3f} s = "
          f"{audio_s / warm:.3f} audio-s/s; the same bits "
          f"{all(np.array_equal(a, c) for a, c in zip(again, codes))}")
    if not all(np.array_equal(a, c) for a, c in zip(again, codes)):
        raise AssertionError("a second pass gave other codes")
    for opts in (dict(defer_readback=True), dict(upload_thread=False),
                 dict(upload_thread=False, defer_readback=True)):
        got = ex.codes_for_wavs(as_read, **opts)
        if not all(np.array_equal(a, c) for a, c in zip(got, codes)):
            raise AssertionError(f"codes_for_wavs({opts}) differs")
    print("codes_for_wavs with defer_readback / upload_thread=False: the "
          "same codes")

    # each wav alone at its exact length (chunked as the extractor
    # chunks) against its codes from the padded batches
    low = frames = 0
    for i, (w, c) in enumerate(zip(as_read, codes)):
        alone, margin = [], []
        for s in range(0, len(w), cfg.max_chunk):
            part = w[s: s + cfg.max_chunk]
            f, _ = hub.apply_hubert(model, part[None], [len(part)],
                                    device=dev)
            a, m = hubert_margins(hub, f[0], ex.centers)
            alone.append(a)
            margin.append(m)
        alone, margin = np.concatenate(alone), np.concatenate(margin)
        sure = margin > HUB_MARGIN_REL
        if not np.array_equal(alone[sure], c[sure]):
            raise AssertionError(f"wav {i}: padded-batch codes differ from "
                                 "the exact-length codes above the margin")
        low += int((~sure).sum())
        frames += len(c)
    print(f"padded batches against exact-length runs: codes equal above the "
          f"margin {HUB_MARGIN_REL:g} |x|^2 on {frames} frames; {low} frames "
          f"({100 * low / frames:.3f}%) below it")

    # one batch in float32 against float64 on the card: the batch with the
    # most audio
    grp = max(ex.batches(as_read),
              key=lambda g: len(g) * ex._bucket(len(as_read[g[0]])))
    batch = ex._prepare_batch([as_read[i] for i in grp])
    model64 = copy.deepcopy(model).double()
    with torch.no_grad(), exact_numerics(True):
        f32, nf = model(batch["wav"], batch["n_samples"])
        f64, _ = model64(batch["wav"].double(), batch["n_samples"])
    del model64
    worst, low64, n64 = 0.0, 0, 0
    for j, i in enumerate(grp):
        t = int(nf[j])
        a, b = f32[j, :t].double(), f64[j, :t]
        worst = max(worst, float(((a - b).norm(dim=-1)
                                  / b.norm(dim=-1)).max()))
        c64, m64 = hubert_margins(hub, b, ex.centers)
        sure = m64 > HUB_MARGIN_REL
        if not np.array_equal(c64[sure], codes[i][:t][sure]):
            raise AssertionError(f"wav {i}: float32 codes differ from "
                                 "float64 above the margin")
        low64 += int((~sure).sum())
        n64 += t
    print(f"float32 against float64, batch of {len(grp)} x "
          f"{batch['wav'].shape[1] / cfg.sample_rate:.2f} s: max |df|/|f| "
          f"{worst:.3e} (<= {HUB_F64_RTOL:g}); codes equal above the margin, "
          f"{low64} of {n64} frames below it")
    if not worst <= HUB_F64_RTOL:
        raise AssertionError(f"float32 features off float64 by {worst}")
    del f32, f64

    if dev.type == "cuda":
        pc = model.encoder.pos_conv_embed.conv
        x = torch.randn(len(grp), cfg.d_model, int(nf.max()), device=dev)
        with torch.no_grad(), exact_numerics(True):
            pos_ms = cuda_ms(lambda: pc(x), 5)
            all_ms = cuda_ms(lambda: ex._run(batch), 3)
        print(f"positional conv (k={cfg.pos_conv_kernel}, "
              f"{cfg.pos_conv_groups} groups, cuDNN deterministic IEEE "
              f"float32) on ({len(grp)}, {cfg.d_model}, {int(nf.max())}): "
              f"{pos_ms:.3f} ms of the batch's {all_ms:.3f} ms (CUDA events)")
        phase_profile(lambda: (ex._run(batch), torch.cuda.synchronize()),
                      f"HuBERT batch of {len(grp)} x "
                      f"{batch['wav'].shape[1] / cfg.sample_rate:.2f} s",
                      HUBERT_PROFILE_SPLIT)
    spk = [("spk_a", "spk_b")[i % 2] for i in range(len(wavs))]
    return {"wavs": wavs, "codes": codes, "speakers": spk,
            "names": [f"{s}_{i:03d}" for i, s in enumerate(spk)]}


HUBERT_PROFILE_SPLIT = (
    ("convolutions", ("fprop", "convolve", "conv", "cudnn")),
    ("matmuls", ("gemm", "Kernel2")),
    ("softmax", ("softmax", "Softmax")),
    ("layer / group norm", ("layer_norm", "LayerNorm", "reduce_kernel")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def phase_f0(vcfg, tcfg, mel_cfg, corpus: dict, units, speakers, wavs,
             device=None) -> None:
    """f0 on the card against the CPU on the fixtures of tests/test_f0.py;
    an f0-conditioned vocoder served in float and "int8" (int8-static
    refuses it); two f0 GAN steps through pipeline/train_vocoder.run with
    checkpoint and resume."""
    import tempfile

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.core.device import resolve_device
    from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer
    from parrot_tts_tpu_torch.models.vocoder import generator
    from parrot_tts_tpu_torch.ops import f0 as f0_ops
    from parrot_tts_tpu_torch.pipeline import train_vocoder
    from parrot_tts_tpu_torch.train import vocoder as voc_train

    dev = resolve_device(device)
    rate = 16000
    t = np.arange(rate) / rate
    n = 8960
    chirp_f = 100.0 + 200.0 * (np.arange(n) / rate) / (n / rate)
    fixtures = {
        "sines": np.stack([0.5 * np.sin(2 * np.pi * f * t)
                           for f in (120.0, 220.0, 330.0)]),
        "chirp": 0.5 * np.sin(2 * np.pi * np.cumsum(chirp_f) / rate)[None],
        "silence": np.zeros((1, rate)),
        "noise": np.random.default_rng(0).normal(0, 0.1, (1, rate)),
    }
    for name, audio in fixtures.items():
        audio = audio.astype(np.float32)
        for interp in (False, True):
            got = f0_ops.estimate_f0(audio, device=dev, interp=interp).cpu()
            want = f0_ops.estimate_f0(audio, device="cpu", interp=interp)
            same = torch.equal(got > 0, want > 0)
            err = float((got - want).abs().max())
            print(f"estimate_f0 {name} (interp {interp}) on {dev.type} "
                  f"against the CPU: voicing equal {same} "
                  f"({int((want > 0).sum())} of {want.numel()} voiced), "
                  f"max |df0| {err:.3e} Hz")
            if not same or not err <= F0_ATOL:
                raise AssertionError(f"estimate_f0 {name}: the card differs")

    # an f0-conditioned vocoder on phase 4's units, tracks from phase 15's
    # wavs
    fcfg = dataclasses.replace(vcfg, f0=True,
                               model_in_dim=2 * vcfg.embedding_dim + 1)
    state = generator.init_code_generator(
        fcfg, torch.Generator().manual_seed(SEED + 16))
    hop = fcfg.total_upsample
    # each request's source: the shortest wav that covers its units
    by_len = sorted(wavs, key=len)
    src = [next((w for w in by_len if len(w) >= len(u) * hop), by_len[-1])
           [: max(1, len(u)) * hop] for u in units]
    tracks = f0_ops.f0_for_codes(src, [len(u) for u in units], code_hop=hop,
                                 device=dev)
    voiced = float(np.mean(np.concatenate(tracks) > 0))
    print(f"f0_for_codes: {len(tracks)} tracks, {100 * voiced:.1f}% of "
          "code frames voiced")
    if dev.type == "cuda":
        seg = np.concatenate(wavs)[: tcfg.batch_size * tcfg.segment_size]
        seg = seg.reshape(tcfg.batch_size, tcfg.segment_size)
        ms = cuda_ms(lambda: f0_ops.estimate_f0(seg, device=dev), 5)
        print(f"estimate_f0 of one GAN batch ({tcfg.batch_size} x "
              f"{tcfg.segment_size} samples, host copy included): {ms:.3f} "
              "ms (CUDA events)")
    for quant in ("none", "int8"):
        synth = VocoderSynthesizer(state, dataclasses.replace(
            fcfg, quant=quant), device=device)
        a = synth.synthesize(units, speakers, f0=tracks)
        b = synth.synthesize(units, speakers, f0=tracks)
        c = synth.synthesize(units, speakers, f0=[x * 0.5 for x in tracks])
        for i, (x, y, z, u) in enumerate(zip(a, b, c, units)):
            if not np.array_equal(x, y):
                raise AssertionError(f"f0 serve ({quant}) request {i}: not "
                                     "deterministic")
            if len(x) != len(u) * hop or not np.isfinite(x).all():
                raise AssertionError(f"f0 serve ({quant}) request {i}: "
                                     f"{len(x)} samples for {len(u)} units")
            if tracks[i].any() == np.array_equal(x, z):
                raise AssertionError(f"f0 serve ({quant}) request {i}: half "
                                     "the f0 must change the waveform iff "
                                     "its track has a voiced frame")
        print(f"f0 serve ({quant}): {len(units)} requests, deterministic, "
              f"len(units) * {hop} samples, finite; half the f0 changes "
              f"the {sum(bool(x.any()) for x in tracks)} waveforms with a "
              f"voiced frame, and only those; {synth.last_rtf:.5f} s per "
              "audio-s (host clock, the last serve)")
    try:
        VocoderSynthesizer(state, dataclasses.replace(
            fcfg, quant="int8-static"), device=device)
    except ValueError as e:
        print(f"int8-static with f0 refused: {str(e)[:60]}...")
    else:
        raise AssertionError("int8-static serving accepted f0")

    # two f0 GAN steps through the training entry point, checkpoint and
    # resume
    records = []
    real_step = voc_train.train_step

    def step_spy(state, batch, *args, **kwargs):
        col = state.gen.conv_pre.weight_v[:, -1].detach().clone()
        metrics = real_step(state, batch, *args, **kwargs)
        grad = state.opt_g.state[state.gen.conv_pre.weight_v]["exp_avg"]
        records.append({
            "start": state.step - 1, "f0": "f0" in batch,
            **{k: float(v) for k, v in metrics.items()},
            "grad": float(grad[:, -1].abs().max()),
            "moved": not torch.equal(col, state.gen.conv_pre.weight_v[:, -1]),
            "state": state})
        return metrics

    with tempfile.TemporaryDirectory(prefix="parrot_gan_f0_") as tmp:
        data = write_vocoder_corpus(tmp, seed=SEED + 7, **corpus)
        cfg = PipelineConfig(vocoder_model=fcfg, vocoder_train=tcfg,
                             mel=mel_cfg)
        run_dir = f"{tmp}/run"
        with mock.patch.object(voc_train, "train_step", step_spy):
            t0 = time.perf_counter()
            out = train_vocoder.run(cfg, data_dir=data, run_dir=run_dir,
                                    max_steps=GAN_F0_STEPS, device=device)
            wall = time.perf_counter() - t0
        for r in records:
            print(f"  f0 GAN step {r['start']}: f0 in the batch {r['f0']}, D "
                  f"loss {r['loss_disc_all']:.5f}, G loss "
                  f"{r['loss_gen_all']:.5f}, mel error {r['mel_error']:.5f}; "
                  f"conv_pre f0 column: max |m1| {r['grad']:.3e}, moved "
                  f"{r['moved']}")
        print(f"f0 GAN train: {out} in {wall:.3f} s")
        if out["steps"] != GAN_F0_STEPS or len(records) != GAN_F0_STEPS:
            raise AssertionError(f"f0 GAN run: {out}")
        if not all(r["f0"] and r["grad"] > 0 and r["moved"]
                   and all(math.isfinite(r[k]) for k in
                           ("loss_disc_all", "loss_gen_all", "mel_error"))
                   for r in records):
            raise AssertionError("an f0 GAN step: no f0, a non-finite loss "
                                 "or an f0 column without gradient")
        live = records[-1]["state"].state_dict()
        saved = CheckpointManager(f"{run_dir}/ckpt").restore()
        for part in ("gen", "mu_g", "nu_g"):
            if not all(torch.equal(saved[part][k], v.cpu())
                       for k, v in live[part].items()):
                raise AssertionError(f"f0 checkpoint {part} differs")
        del live, saved
        records.clear()
        with mock.patch.object(voc_train, "train_step", step_spy):
            out2 = train_vocoder.run(cfg, data_dir=data, run_dir=run_dir,
                                     max_steps=GAN_F0_STEPS + 1,
                                     device=device)
        if out2["steps"] != GAN_F0_STEPS + 1 or [
                r["start"] for r in records] != [GAN_F0_STEPS]:
            raise AssertionError(f"f0 resume: {out2}")
        records.clear()
        print(f"f0 GAN resumed: {out2}; the checkpoint held the generator "
              "and its moments bit for bit")


# phase 17: the aligner, duration extraction and the TTE manifests at
# reference width (no TPU kernel on this path)
ALIGN_STEPS = 4              # train_aligner's steps (a crash at 3, resume)
ALIGN_MAX_S = 40.96          # wavs of phase 15's corpus up to the top bucket
ALIGN_CHARS_PER_S = 12.5     # transcript length per second of audio
ALIGN_LOSS_RTOL = 1e-4       # a float32 step against float64: the loss
ALIGN_GRAD_RTOL = 1e-3       # and |dg| / |g| over the trained parameters
ALIGN_NEAR_TIE = 1e-4        # card against CPU durations may differ only
#                              where the best path is within this of the
#                              second best (`extract_durations_margin`)
ALIGN_POST_ATOL = 1e-6       # eval-mode posteriors, card against the CPU
#                              port: ~10x the float32-against-float64
#                              reading (7e-8 at the reference width on
#                              an H100)
ALIGN_TIMED = 3              # timed steps of the gate batch (CUDA events)
WORDS = ("the", "a", "speech", "voice", "model", "learns", "to", "align",
         "every", "frame", "with", "its", "letter", "while", "small",
         "birds", "sing", "over", "quiet", "rivers", "and", "green", "hills",
         "people", "read", "long", "stories", "about", "distant", "cities",
         "under", "bright", "winter", "skies", "of", "north", "light",
         "music", "from", "old", "radios", "fills", "warm", "kitchens")
ALIGNER_PROFILE_SPLIT = (
    ("CTC (elementwise loop)", ("logaddexp", "where", "CatArray", "cat_",
                                "elementwise", "vectorized", "unrolled")),
    ("LSTM (cuDNN RNN)", ("RNN", "rnn", "lstm", "LSTM", "elemWise",
                          "persist")),
    ("convolutions", ("conv", "Conv", "fprop", "dgrad", "wgrad")),
    ("batch norm", ("bn_", "batch_norm", "BatchNorm")),
    ("matmuls", ("gemm", "Gemm", "Kernel2")),
)


@contextlib.contextmanager
def strict_determinism():
    """torch.use_deterministic_algorithms(True): an op without a
    deterministic implementation raises (CUBLAS_WORKSPACE_CONFIG is set at
    the top of this script, as cuBLAS requires)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def aligner_text(rng, seconds: float) -> str:
    """An English transcript of about ALIGN_CHARS_PER_S characters per
    second: far fewer letters than the 50 mel frames per second, so CTC
    is feasible on every row."""
    words, n = [], 0
    target = max(3, int(ALIGN_CHARS_PER_S * seconds))
    while n < target:
        w = str(rng.choice(WORDS))
        words.append(w)
        n += len(w) + 1
    text = " ".join(words)[:target].strip()
    return text[0].upper() + text[1:] + "."


def aligner_gate_batch(dirs, train_cfg) -> dict:
    """Up to batch_size items of the top (mel, token) bucket pair from the
    speakers' directories, padded to it as the loader pads."""
    import pickle

    from parrot_tts_tpu_torch.data.tte_data import pick_bucket

    mt, lt = train_cfg.mel_bucket_sizes[-1], train_cfg.token_bucket_sizes[-1]
    items = []
    for d in dirs:
        with open(d / "dataset.pkl", "rb") as f:
            for stem, n, l in pickle.load(f):
                if (pick_bucket(train_cfg.mel_bucket_sizes, n) == mt
                        and pick_bucket(train_cfg.token_bucket_sizes, l) == lt):
                    items.append((np.load(d / "mels" / f"{stem}.npy"),
                                  np.load(d / "tokens" / f"{stem}.npy")))
    items = items[: train_cfg.batch_size]
    b = len(items)
    batch = {"mel": np.zeros((b, mt, items[0][0].shape[1]), np.float32),
             "tokens": np.zeros((b, lt), np.int64),
             "mel_lengths": np.zeros(b, np.int64),
             "token_lengths": np.zeros(b, np.int64)}
    for i, (m, t) in enumerate(items):
        nm, nt = min(len(m), mt), min(len(t), lt)
        batch["mel"][i, :nm] = m[:nm]
        batch["tokens"][i, :nt] = t[:nt]
        batch["mel_lengths"][i], batch["token_lengths"][i] = nm, nt
    return batch


def fresh_aligner_state(atrain, model, dtype=torch.float32, graphs=True):
    """A copy of `model` in `dtype` with zero moments; graphs: the CTC's
    CUDA graphs (the card's training path) or the eager loops."""
    import copy

    from parrot_tts_tpu_torch.ops.ctc import CTCGraphs

    m = copy.deepcopy(model).to(dtype)
    return atrain.AlignerTrainState(
        model=m, mu={n: torch.zeros_like(p)
                     for n, p in atrain.trained(m).items()},
        nu={n: torch.zeros_like(p) for n, p in atrain.trained(m).items()},
        ctc_graphs=CTCGraphs() if graphs else None)


def aligner_state_equal(a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(a.mu[k], b.mu[k])
                    and torch.equal(a.nu[k], b.nu[k]) for k in a.mu)
            and (a.count, a.step) == (b.count, b.step))


def phase_aligner(hub: dict, train_cfg, model_kw: dict | None = None,
                  device=None) -> dict:
    """The offline supervision pipeline on phase 15's wavs (those up to
    ALIGN_MAX_S) and units, with the checks: preprocess, train_aligner
    (a crash and a resume), the step's gates on a batch of the top bucket
    pair, extraction on the card against the CPU, the TTE manifests, and
    the CLI's run-aligner-pipeline in a process of its own. model_kw
    narrows the aligner for a CPU rehearsal; None is the reference width
    (train_aligner's default AlignerModelConfig)."""
    import copy
    import pickle
    import shutil
    import tempfile
    from pathlib import Path

    import torch.nn.functional as F

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import AlignerModelConfig
    from parrot_tts_tpu_torch.core.device import exact_numerics, resolve_device
    from parrot_tts_tpu_torch.data.audio_io import write_wav
    from parrot_tts_tpu_torch.data.manifest import read_manifest, write_manifest
    from parrot_tts_tpu_torch.models.aligner.model import Aligner
    from parrot_tts_tpu_torch.ops import ctc as ctc_ops
    from parrot_tts_tpu_torch.ops import monotonic_align as ma
    from parrot_tts_tpu_torch.pipeline import (aligner_preprocess,
                                               extract_durations,
                                               prepare_tte, train_aligner)
    from parrot_tts_tpu_torch.train import aligner as atrain

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(SEED + 17)
    keep = [i for i, w in enumerate(hub["wavs"])
            if len(w) <= ALIGN_MAX_S * 16000]
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="parrot_aligner_") as tmp:
        tmp = Path(tmp)
        corpus, align = tmp / "corpus", tmp / "aligner"
        for i in keep:
            spk, name = hub["speakers"][i], hub["names"][i]
            write_wav(corpus / spk / "wavs" / f"{name}.wav", hub["wavs"][i],
                      16000)
            (corpus / spk / "txt").mkdir(parents=True, exist_ok=True)
            (corpus / spk / "txt" / f"{name}.txt").write_text(
                aligner_text(rng, len(hub["wavs"][i]) / 16000))
        speakers = sorted({hub["speakers"][i] for i in keep})
        t0 = time.perf_counter()
        symbols = aligner_preprocess.clean_corpus(corpus, align)
        for spk in speakers:
            aligner_preprocess.compute_mels_and_tokens(
                corpus / spk, align / spk, symbols, device=device)
        prep_s = time.perf_counter() - t0
        index = {}
        for spk in speakers:
            with open(align / spk / "dataset.pkl", "rb") as f:
                index[spk] = pickle.load(f)
        items = [it for spk in speakers for it in index[spk]]
        top = (train_cfg.mel_bucket_sizes[-1],
               train_cfg.token_bucket_sizes[-1])
        in_top = sum(n > train_cfg.mel_bucket_sizes[-2]
                     and l > train_cfg.token_bucket_sizes[-2]
                     for _, n, l in items)
        print(f"aligner corpus: {len(items)} wavs over {len(speakers)} "
              f"speakers, {len(symbols)} symbols, frames "
              f"{min(n for _, n, _ in items)}-{max(n for _, n, _ in items)}, "
              f"tokens {min(l for _, _, l in items)}-"
              f"{max(l for _, _, l in items)}; {in_top} in the top bucket "
              f"pair {top}; preprocess {prep_s:.3f} s")
        if not in_top or any(2 * l > n for _, n, l in items):
            raise AssertionError("the corpus misses the top bucket pair or "
                                 "a row is too short for its labels")

        # train_aligner: a crash at step 3, then a resume to ALIGN_STEPS
        mcfg = AlignerModelConfig(n_mels=80, num_symbols=len(symbols) + 1,
                                  **(model_kw or {}))
        cfg = dataclasses.replace(train_cfg, checkpoint_steps=2, plot_steps=2)
        data = align / speakers[0]
        t0 = time.perf_counter()
        try:
            train_aligner.train_aligner(
                data, symbols, cfg, model_cfg=None if model_kw is None
                else mcfg, crash_at_step=3, epoch_saves=False, device=device)
        except RuntimeError as e:
            if "simulated crash at step 3" not in str(e):
                raise
        else:
            raise AssertionError("crash_at_step=3 did not raise")
        mgr = CheckpointManager(data / "ckpt")
        if mgr.latest_step() != 2:
            raise AssertionError(f"after the crash: {mgr.latest_step()}")
        res = train_aligner.train_aligner(
            data, symbols, cfg, model_cfg=None if model_kw is None else mcfg,
            max_steps=ALIGN_STEPS, device=device)
        train_s = time.perf_counter() - t0
        recs = [json.loads(l) for l in (data / "logs" / "metrics.jsonl")
                .read_text().splitlines()]
        losses = [(r["step"], r["value"]) for r in recs
                  if r["tag"] == "CTC_Loss"]
        saved = mgr.restore()
        print(f"train_aligner: crash at step 3 (checkpoint 2 kept), resume "
              f"to {res['steps']}; CTC_Loss by step {losses}; "
              f"{train_s:.3f} s for both runs")
        if ([s for s, _ in losses] != [1, 2, 3, 3, 4]
                or not all(math.isfinite(v) for _, v in losses)
                or (res["steps"], saved["step"], saved["count"])
                != (ALIGN_STEPS, ALIGN_STEPS, ALIGN_STEPS)
                or not (data / "logs" / "text"
                        / "Text_Target_Duration_Repeated_4.txt").exists()):
            raise AssertionError(f"train_aligner: {res}, checkpoint step "
                                 f"{saved['step']} count {saved['count']}")
        model = Aligner(mcfg)
        model.load_state_dict(saved["params"], strict=True)
        model.to(dev)
        if not all(torch.isfinite(v).all() for v in
                   model.state_dict().values() if v.is_floating_point()):
            raise AssertionError("non-finite weights after training")

        # the step's gates on a batch of the top bucket pair
        np_batch = aligner_gate_batch([align / s for s in speakers],
                                      train_cfg)
        n_frames = int(np_batch["mel_lengths"].max())
        batch = atrain.to_batch(np_batch, dev)
        shape = tuple(np_batch["mel"].shape)
        with strict_determinism():
            s1 = fresh_aligner_state(atrain, model)
            s2 = fresh_aligner_state(atrain, model)
            se = fresh_aligner_state(atrain, model, graphs=False)
            m1 = atrain.train_step(s1, batch, train_cfg)
            m2 = atrain.train_step(s2, batch, train_cfg)
            me = atrain.train_step(se, batch, train_cfg)
        same = (torch.equal(m1["ctc_loss"], m2["ctc_loss"])
                and aligner_state_equal(s1, s2))
        eager_same = (torch.equal(m1["ctc_loss"], me["ctc_loss"])
                      and aligner_state_equal(s1, se))
        s64 = fresh_aligner_state(atrain, model, torch.float64, graphs=False)
        b64 = dict(batch, mel=batch["mel"].double())
        m64 = atrain.train_step(s64, b64, train_cfg)
        l32, l64 = float(m1["ctc_loss"]), float(m64["ctc_loss"])
        num = math.sqrt(sum(float((s1.mu[k].double() - s64.mu[k]).square()
                                  .sum()) for k in s1.mu))
        den = math.sqrt(sum(float(s64.mu[k].square().sum()) for k in s64.mu))
        loss_rel, grad_rel = abs(l32 - l64) / abs(l64), num / den
        print(f"aligner step on {shape} (tokens {np_batch['tokens'].shape[1]}"
              f", longest row {n_frames} frames): two float32 steps the same "
              f"bits {same}, the CTC's CUDA graphs against its eager loops "
              f"the same bits {eager_same} (torch deterministic algorithms "
              f"on); float32 "
              f"loss {l32:.6f} against float64 {l64:.6f}: rel "
              f"{loss_rel:.3e} (<= {ALIGN_LOSS_RTOL:g}); |dg|/|g| "
              f"{grad_rel:.3e} (<= {ALIGN_GRAD_RTOL:g})")
        if not (same and eager_same and loss_rel <= ALIGN_LOSS_RTOL
                and grad_rel <= ALIGN_GRAD_RTOL):
            raise AssertionError("aligner step gates failed")
        del s64, b64, s2

        sn = fresh_aligner_state(atrain, model)
        ref = fresh_aligner_state(atrain, model)
        nan_batch = dict(batch, mel=batch["mel"].clone())
        nan_batch["mel"][0, 5, 3] = float("nan")
        mn = atrain.train_step(sn, nan_batch, train_cfg)
        ref.step = 1
        print(f"NaN drill: loss {float(mn['ctc_loss'])}; parameters, BN "
              f"statistics, moments and count unchanged "
              f"{aligner_state_equal(sn, ref)}, step counted {sn.step}")
        if math.isfinite(float(mn["ctc_loss"])) or not aligner_state_equal(
                sn, ref):
            raise AssertionError("the NaN step changed the state")
        del sn, ref, nan_batch

        out["steps"] = ALIGN_STEPS
        if on_card:
            step_ms = cuda_ms(lambda: atrain.train_step(
                s1, batch, train_cfg), ALIGN_TIMED, warmup=1)
            eager_ms = cuda_ms(lambda: atrain.train_step(
                se, batch, train_cfg), ALIGN_TIMED, warmup=1)
            with exact_numerics(True):
                logits = model(batch["mel"]).detach().requires_grad_()

                def ctc_port(graphs):
                    ctc_ops.ctc_loss_torch_mean(
                        logits, batch["mel_lengths"], batch["tokens"],
                        batch["token_lengths"], graphs=graphs).backward()

                ctc_ms = cuda_ms(lambda: ctc_port(s1.ctc_graphs),
                                 ALIGN_TIMED, warmup=1)
                ctc_eager_ms = cuda_ms(lambda: ctc_port(None), ALIGN_TIMED,
                                       warmup=1)

                def ctc_torch():
                    logits.grad = None
                    loss = F.ctc_loss(
                        torch.log_softmax(logits, -1).transpose(0, 1),
                        batch["tokens"], batch["mel_lengths"],
                        batch["token_lengths"])
                    loss.backward()
                    return loss

                torch_ms = cuda_ms(ctc_torch, 10)
                ya, ga = ctc_torch().detach(), logits.grad.clone()
                yb, gb = ctc_torch().detach(), logits.grad.clone()
                logits.grad = None
                mine = ctc_ops.ctc_loss_torch_mean(
                    logits, batch["mel_lengths"], batch["tokens"],
                    batch["token_lengths"], graphs=s1.ctc_graphs)
                mine.backward()
                gdiff = float((logits.grad - ga).abs().max()
                              / ga.abs().max())
            print(f"aligner step {step_ms:.3f} ms on {shape} (CUDA events, "
                  f"{ALIGN_TIMED} steps; {eager_ms:.3f} ms with the CTC's "
                  f"eager loops); the port's CTC forward + backward "
                  f"{ctc_ms:.3f} ms as CUDA graphs over all {shape[1]} "
                  f"frames ({100 * ctc_ms / step_ms:.1f}% of the step), "
                  f"{ctc_eager_ms:.3f} ms eager over {n_frames}")
            print(f"yardstick: torch.nn.functional.ctc_loss forward + "
                  f"backward {torch_ms:.3f} ms on the same logits; loss "
                  f"{float(ya):.6f} against the port's "
                  f"{float(mine.detach()):.6f}; "
                  f"its gradient within {gdiff:.3e} of the port's (relative "
                  f"to max); two runs the same bits "
                  f"{torch.equal(ya, yb) and torch.equal(ga, gb)}")
            phase_profile(lambda: (atrain.train_step(s1, batch, train_cfg),
                                   torch.cuda.synchronize()),
                          f"aligner step on {shape}", ALIGNER_PROFILE_SPLIT,
                          unprofiled_ms=step_ms)
            out.update(step_ms=step_ms, eager_step_ms=eager_ms,
                       ctc_ms=ctc_ms, ctc_eager_ms=ctc_eager_ms,
                       torch_ctc_ms=torch_ms)
            del logits
        del s1, se, batch

        # extraction on the device (dijkstra, beam) against the CPU
        model.eval()
        timings = {}
        for method in ("beam", "dijkstra"):
            total = {"device_s": 0.0, "dp_s": 0.0, "wall_s": 0.0}
            for spk in speakers:
                d = align / spk
                if method == "beam":
                    d = tmp / "beam" / spk
                    shutil.copytree(align / spk, d,
                                    ignore=shutil.ignore_patterns(
                                        "outputs", "ckpt", "logs"))
                tm = {}
                n = extract_durations.extract_all_durations(
                    d, model, method=method, timings=tm)["items"]
                if n != len(index[spk]):
                    raise AssertionError(f"{method}: {n} items written")
                for k in total:
                    total[k] += tm[k]
                for stem, frames, toks in index[spk]:
                    durs = np.load(d / "outputs" / "durations"
                                   / f"{stem}.npy")
                    if (durs.sum() != frames
                            or (method == "dijkstra" and len(durs) != toks)):
                        raise AssertionError(f"{method} {stem}: durations "
                                             f"sum {durs.sum()} != {frames}")
            n_items = len(items)
            timings[method] = total
            print(f"extract_all_durations ({method}): {n_items} items in "
                  f"{total['wall_s']:.3f} s = "
                  f"{n_items / total['wall_s']:.3f} items/s; posterior "
                  f"batches {total['device_s']:.3f} s, path jobs "
                  f"{total['dp_s']:.3f} s summed over threads")
        out["extract"] = timings

        cpu_model = copy.deepcopy(model).cpu()
        cpu_model64 = copy.deepcopy(cpu_model).double()
        differ = near = 0
        post_err = post_err64 = host_err64 = 0.0
        for spk in speakers:
            d = align / spk
            order = np.argsort([n for (_, n, _) in index[spk]])
            for off in range(0, len(order), 8):   # extraction's batches
                idxs = order[off: off + 8]
                mels = [np.load(d / "mels" / f"{index[spk][i][0]}.npy")
                        for i in idxs]
                t_pad = ((max(len(m) for m in mels) + 63) // 64) * 64
                mel = np.zeros((len(mels), t_pad, 80), np.float32)
                for j, m in enumerate(mels):
                    mel[j, :len(m)] = m
                x = torch.from_numpy(mel)
                card = atrain.posteriors(model, x.to(dev)).cpu().numpy()
                host = atrain.posteriors(cpu_model, x).numpy()
                host64 = atrain.posteriors(cpu_model64, x.double()).numpy()
                for j, i in enumerate(idxs):
                    stem, frames, _ = index[spk][i]
                    c, h, h64 = (a[j, :frames] for a in (card, host, host64))
                    post_err = max(post_err, float(np.abs(c - h).max()))
                    post_err64 = max(post_err64, float(np.abs(c - h64).max()))
                    host_err64 = max(host_err64, float(np.abs(h - h64).max()))
                    tok = np.load(d / "tokens" / f"{stem}.npy")
                    dc, gc = ma.extract_durations_margin(tok, card[j, :frames])
                    dh, gh = ma.extract_durations_margin(tok, host[j, :frames])
                    written = np.load(d / "outputs" / "durations"
                                      / f"{stem}.npy")
                    if not np.array_equal(dc, written):
                        raise AssertionError(f"{stem}: the written "
                                             "durations differ from a rerun")
                    near += min(gc, gh) <= ALIGN_NEAR_TIE
                    if not np.array_equal(dc, dh):
                        differ += 1
                        if min(gc, gh) > ALIGN_NEAR_TIE:
                            raise AssertionError(
                                f"{stem}: card and CPU durations differ "
                                f"with margins {gc:.3e} / {gh:.3e}")
        print(f"posteriors on the card against the CPU port (same weights, "
              f"eval mode, each item's frames): max |dp| {post_err:.3e} "
              f"(<= {ALIGN_POST_ATOL:g}); against the CPU in float64 "
              f"{post_err64:.3e}, the CPU's float32 {host_err64:.3e}")
        print(f"durations on the card against the CPU port (same weights): "
              f"{len(items) - differ} of {len(items)} equal, {differ} "
              f"differ, all at near-ties; {near} items with a best-path "
              f"margin <= {ALIGN_NEAR_TIE:g}")
        if post_err > ALIGN_POST_ATOL:
            raise AssertionError("the card's posteriors differ from the "
                                 "CPU port's")
        out["near_ties"], out["differ"] = near, differ
        out["posterior_err"] = post_err

        # the TTE manifests over phase 15's units
        hub_lines = [{"audio": str(corpus / hub["speakers"][i] / "wavs"
                                   / f"{hub['names'][i]}.wav"),
                      "hubert": " ".join(map(str, hub["codes"][i])),
                      "duration": len(hub["wavs"][i]) / 16000} for i in keep]
        write_manifest(tmp / "hubert.txt", hub_lines)
        stats = prepare_tte.build_tte_manifests(
            tmp / "hubert.txt", align, tmp / "TTE", val_size=4, seed=0)
        lines = (read_manifest(tmp / "TTE" / "train.txt")
                 + read_manifest(tmp / "TTE" / "val.txt"))
        ok = all(sum(map(int, e["duration"].split()))
                 == len(e["hubert"].split())
                 and len(e["duration"].split())
                 == len(e["characters"].split(" ")) for e in lines)
        print(f"build_tte_manifests over phase 15's units: train "
              f"{stats['train']}, val {stats['val']}, skipped "
              f"{stats['skipped']} (|sum(durations) - units| > 2 or not "
              f"adjustable), speakers {stats['speakers']}; every line's "
              f"durations sum to its units {ok}")
        if (not ok or stats["train"] + stats["val"] + stats["skipped"]
                != len(keep) or set(stats["speakers"]) != set(speakers)):
            raise AssertionError(f"build_tte_manifests: {stats}")
        out["manifests"] = stats

        # the CLI in a process of its own, on the three shortest wavs of
        # each speaker, at its default widths and device
        small = tmp / "small"
        for spk in speakers:
            names = sorted((corpus / spk / "wavs").glob("*.wav"),
                           key=lambda p: p.stat().st_size)[:3]
            for p in names:
                for sub, suffix in (("wavs", ".wav"), ("txt", ".txt")):
                    (small / spk / sub).mkdir(parents=True, exist_ok=True)
                    shutil.copy(corpus / spk / sub / (p.stem + suffix),
                                small / spk / sub)
        # twice, with CUBLAS_WORKSPACE_CONFIG unset in its environment: the
        # CLI pins the workspace itself, so both runs give the same bits
        env = {k: v for k, v in os.environ.items()
               if k != "CUBLAS_WORKSPACE_CONFIG"}
        runs = []
        for run in ("cli_a", "cli_b"):
            cmd = [sys.executable, "-m", "parrot_tts_tpu_torch.cli",
                   "run-aligner-pipeline", "--dataset-dir", str(small),
                   "--out-dir", str(tmp / run), "--epochs", "2",
                   "--batch-size", "4"] + ([] if on_card else
                                           ["--device", "cpu"])
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600, env=env,
                                  cwd=Path(__file__).parent)
            lines = proc.stdout.strip().splitlines() or [""]
            steps = [json.loads(l)["steps"] for l in lines
                     if l.startswith('{"steps"')]
            print(f"python -m parrot_tts_tpu_torch.cli run-aligner-pipeline "
                  f"(CUBLAS_WORKSPACE_CONFIG unset): exit {proc.returncode} "
                  f"in {time.perf_counter() - t0:.3f} s; steps per speaker "
                  f"{steps}; {lines[-1]}")
            if (proc.returncode != 0 or len(steps) != len(speakers)
                    or min(steps) < 2
                    or json.loads(lines[-1]) != {s: "ok" for s in speakers}):
                raise AssertionError(
                    f"the CLI failed:\n{proc.stderr[-3000:]}")
            runs.append(tmp / run)
        same = all(cli_outputs_equal(runs[0] / spk, runs[1] / spk)
                   for spk in speakers)
        print(f"the CLI's two runs: checkpoints (weights, BN statistics, "
              f"moments), mels and durations the same bits {same}")
        if not same:
            raise AssertionError("the CLI's aligner runs differ")
    return out


def cli_outputs_equal(a, b) -> bool:
    """Two run-aligner-pipeline outputs of one speaker: the last
    checkpoint's tensors and every .npy file (mels, tokens, durations)
    equal bit for bit."""
    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager

    ca, cb = (CheckpointManager(d / "ckpt").restore() for d in (a, b))

    def equal(x, y) -> bool:
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(equal(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(equal, x, y))
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return x == y

    files = sorted(p.relative_to(a) for p in a.rglob("*.npy"))
    return (equal(ca, cb) and len(files) > 0
            and files == sorted(p.relative_to(b) for p in b.rglob("*.npy"))
            and all(np.array_equal(np.load(a / f), np.load(b / f))
                    for f in files))



# phase 18: the mesh on the card (core/mesh.py, parallel/tensor.py). One
# card: NCCL refuses two ranks on one GPU, so the NCCL path runs at world
# size 1, in this process, and the multi-rank paths as MESH_WORLD gloo
# processes that share the card (gloo all-reduces and broadcasts CUDA
# tensors; its gathers take host copies)
MESH_WORLD = 2
MESH_DEADLINE_S = 480        # the spawn is joined or killed by then
MESH_PAIR = (128, 1024)      # the data-parallel TTE steps' bucket pair
MESH_ROWS = 64               # rows of the full (128 -> 2048) decode batch
MESH_TTE_RTOL = 1e-5         # 2 ranks against 1 process: each micro-step's
                             # loss; and the first micro-step's gradient
                             # against one process's sum over the same
                             # shards (the shapes the ranks run), |dg|/|g|.
                             # Against the global batch's gradient the
                             # GEMMs' shapes differ (6 against 12 rows),
                             # their last bits too, and the attention
                             # kernels' bf16 rounding of q, k, v turns
                             # some into 2^-9 steps: 2.3e-5 (TF32) and
                             # 5.2e-5 (IEEE) on the card, gated there at
                             # phase 11's TRAIN_GRAD_RTOL / _MAX
MESH_WAV_ATOL = 1e-5         # sharded waveforms against the unsharded serve
MESH_GAN_STEPS = 2
MESH_AR_REPS = 5             # timed all-reduces of the TTE's gradient


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def synthetic_tte_batch(rng, b: int, s: int, t: int, tcfg) -> dict:
    """A training batch at bucket pair (s, t): b rows of token and code
    counts in the pair's upper half, durations >= 1 summing to the code
    count, the last row a filler (weight 0), so the ranks' halves hold
    unequal numbers of valid codes."""
    phones = np.zeros((b, s), np.int64)
    dur = np.zeros((b, s), np.int64)
    codes = np.full((b, t), tcfg.hubert_codes, np.int64)
    src_mask = np.zeros((b, s), bool)
    tgt_mask = np.zeros((b, t), bool)
    for i in range(b):
        n_tok = int(rng.integers(s // 2 + 1, s + 1))
        n_code = int(rng.integers(max(t // 2 + 1, n_tok), t + 1))
        dur[i, :n_tok] = rng.multinomial(n_code - n_tok,
                                         np.full(n_tok, 1.0 / n_tok)) + 1
        phones[i, :n_tok] = rng.integers(2, tcfg.vocab_size, n_tok)
        codes[i, :n_code] = rng.integers(0, tcfg.hubert_codes, n_code)
        src_mask[i, :n_tok] = True
        tgt_mask[i, :n_code] = True
    weight = np.ones((b,), np.float32)
    weight[-1] = 0.0
    return {"phones": phones, "duration": dur, "codes": codes,
            "src_mask": src_mask, "tgt_mask": tgt_mask,
            "speaker": rng.integers(0, tcfg.n_speaker, b),
            "sample_weight": weight}


def shard_solo_wavs(synth, codes, spk, world: int) -> list:
    """Each request's waveform served solo among its shard's rows: its
    vocoder bucket padded to a multiple of `world` with repeats of the
    bucket's first row and cut in `world` shards, as a sharded serve cuts
    it."""
    from parrot_tts_tpu_torch.data.tte_data import pick_bucket
    from parrot_tts_tpu_torch.infer.synthesize import CODE_BUCKETS

    by: dict = {}
    for i, c in enumerate(codes):
        by.setdefault(pick_bucket(CODE_BUCKETS, len(c)), []).append(i)
    out: list = [None] * len(codes)
    for idx in by.values():
        pad = idx + [idx[0]] * (-len(idx) % world)
        n = len(pad) // world
        for r in range(world):
            rows = pad[r * n:(r + 1) * n]
            for gi, w in zip(rows, synth.synthesize([codes[i] for i in rows],
                                                    [spk[i] for i in rows])):
                if out[gi] is None:
                    out[gi] = w
    return out


def check_wavs(label: str, got, solo, whole) -> None:
    """Sharded waveforms: bit-equal to the shard's solo serve, within
    MESH_WAV_ATOL of the unsharded serve."""
    worst = 0.0
    for i, (g, s, w) in enumerate(zip(got, solo, whole)):
        if not np.array_equal(g, s):
            raise AssertionError(f"{label} request {i}: not the bits of its "
                                 "shard served solo")
        if len(g):
            worst = max(worst, float(np.abs(g - w).max()))
    if not worst <= MESH_WAV_ATOL:
        raise AssertionError(f"{label}: max |diff| {worst} against the "
                             "unsharded serve")
    print(f"{label}: {len(got)} waveforms bit-equal to their shards served "
          f"solo; max |diff| {worst:.3e} against the unsharded serve")


def same_on_every_rank(meshlib, tensors) -> bool:
    """Whether every rank holds these tensors' bits (a SHA-256 of them,
    gathered)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    d = torch.tensor(list(h.digest()), dtype=torch.uint8)[None]
    rows = meshlib.fetch(d)
    return bool((rows == rows[0]).all())


def mesh_launches(fa, fd) -> dict:
    return {"flash_attn_fwd": fa.FLASH_FWD.launches,
            "flash_attn_split": fa.SPLIT_PREP.launches, "fwd": fd.FWD.launches,
            "dq": fd.DQ.launches, "dkv": fd.DKV.launches}


def grad_rel(got, want) -> float:
    num = sum(float((a.double() - b.double()).pow(2).sum())
              for a, b in zip(got, want))
    den = sum(float(b.double().pow(2).sum()) for b in want)
    return math.sqrt(num / den)


def mesh_serve(spec, mesh, rank: int, dev) -> None:
    """Sharded serving of phase 4's requests and of the MESH_ROWS-row
    decode batch; rank 0 holds them to one process's serve."""
    from parrot_tts_tpu_torch.infer.tte_infer import decode_buckets

    tcfg, vcfg = spec["tcfg"], spec["vcfg"]
    tts = make_tts(tcfg, vcfg, device=dev, exact=True, mesh=mesh)
    speakers = [i % tcfg.n_speaker for i in range(len(TEXTS))]
    tokens = [tts.tokenize(t) for t in TEXTS]
    units = tts.predict_units(tokens, speakers)
    wavs = tts.tts(TEXTS, speakers=speakers)
    samples = [(s, speakers[i]) for i, s in enumerate(tokens)]
    plan = tts.plan(tokens)     # phase 4's full batch: the 2048 bucket's
    s_len, out_len, idxs = next((p for p in plan if p[1] == 2048),
                                max(plan, key=lambda p: p[1]))
    rows = [samples[idxs[j % len(idxs)]] for j in range(spec["rows"])]
    full = [(s_len, out_len, list(range(len(rows))))]
    units64 = decode_buckets(tts.replicas, rows, full, batch_size=len(rows),
                             exact=True, device=dev, mesh=mesh)
    spk64 = [r[1] for r in rows]
    wavs64 = tts.vocoder.synthesize(units64, spk64)
    if rank:
        return
    solo = make_tts(tcfg, vcfg, device=dev, exact=True)
    want = solo.predict_units(tokens, speakers)
    want64 = decode_buckets(solo.tte, rows, full, batch_size=len(rows),
                            exact=True, device=dev)
    for label, a, b in (("requests", units, want),
                        (f"{len(rows)} x ({s_len} -> {out_len})", units64,
                         want64)):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"sharded decode of the {label}: units "
                                 "differ from one process's exact=True")
        print(f"sharded decode of the {label}: {len(a)} unit sequences "
              "equal to one process's exact=True decode")
    check_wavs("sharded ParrotTTS serve", wavs,
               shard_solo_wavs(solo.vocoder, want, speakers, mesh.n_data),
               solo.tts(TEXTS, speakers=speakers))
    check_wavs(f"sharded vocoder, {len(rows)} rows", wavs64,
               shard_solo_wavs(solo.vocoder, want64, spk64, mesh.n_data),
               solo.vocoder.synthesize(want64, spk64))
    print(f"sharded serve: {tts.last_stats['audio_seconds']:.3f} global "
          "audio-s counted on rank 0")


def mesh_tte_steps(spec, mesh, meshlib, rank: int, dev, fd) -> dict:
    """Two TTE optimizer steps at the spec's bucket pair, at dropout 0
    and 0.1, over the ranks (each its rows of the global batch) against
    one process on the global batch: losses within MESH_TTE_RTOL, the
    first micro-step's gradient too at dropout 0, at 0.1 the dQ kernel's
    keep bits gathered over the ranks equal to one process's, and the
    parameters bit-equal across the ranks. At dropout 0, in IEEE float32,
    the ranks' summed gradient is also held to one process's sum over
    the same shards (`shard_sum_grad`) within MESH_TTE_RTOL, and to the
    global batch's within TRAIN_GRAD_RTOL / TRAIN_GRAD_MAX (MESH_TTE_RTOL
    says why). Dropout 0.1 runs in TF32, as training runs; its times are
    the readings."""
    from parrot_tts_tpu_torch.train import tte as tte_train

    tcfg, train_cfg = spec["tcfg"], spec["train_cfg"]
    s, t = spec["pair"]
    rng = np.random.default_rng(SEED + 18)
    micro = [synthetic_tte_batch(rng, mesh.n_data * train_cfg.batch_size, s,
                                 t, tcfg)
             for _ in range(2 * train_cfg.grad_acc_steps)]
    real_dq = fd.flash_dropout_dq
    readings = {}

    def run(cfg, dp: bool, exact: bool):
        state = tte_train.init_state(SEED, cfg, dev)
        n = len(micro[0]["codes"])
        sl = meshlib.local_rows(n) if dp else slice(0, n)
        losses, ms, bits = [], [], []

        def dq_spy(*args, **kwargs):
            out = real_dq(*args, **kwargs)
            if state.step == 0 and out[2] is not None:
                bits.append(out[2].cpu())
            return out

        grad0 = None
        with mock.patch.object(fd, "flash_dropout_dq", dq_spy), \
                deterministic_algorithms():
            for i, mb in enumerate(micro):
                batch = tte_train.to_batch({k: v[sl] for k, v in mb.items()},
                                           dev)
                sync(dev)
                t0 = time.perf_counter()
                m = tte_train.train_step(state, batch, SEED, cfg, train_cfg,
                                         t, mesh if dp else None,
                                         exact=exact)
                losses.append(float(m["total_loss"]))
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    grad0 = [a.clone() for a in state.acc.values()]
        return state, losses, grad0, bits, ms

    for p in (0.0, 0.1):
        cfg = dataclasses.replace(
            tcfg, encoder=dataclasses.replace(tcfg.encoder, dropout_p=p),
            decoder=dataclasses.replace(tcfg.decoder, dropout_p=p),
            dur_dropout_p=p)
        exact = p == 0.0
        state, losses, grad0, bits, ms = run(cfg, True, exact)
        if not same_on_every_rank(meshlib, state.model.parameters()):
            raise AssertionError(f"TTE p={p}: parameters differ across "
                                 "ranks")
        gathered = [meshlib.fetch(b) for b in bits]
        if not exact:
            readings["tte_micro_ms"] = float(np.mean(ms[1:]))
            grads = [torch.empty_like(a) for a in grad0]
            ar = []
            for _ in range(MESH_AR_REPS):
                sync(dev)
                t0 = time.perf_counter()
                meshlib.all_reduce_sum(grads)
                sync(dev)
                ar.append((time.perf_counter() - t0) * 1e3)
            readings["allreduce_ms"] = float(np.mean(ar))
            readings["grad_mib"] = sum(a.numel() for a in grads) * 4 / 2**20
        if rank:
            continue
        _, want, want_grad0, want_bits, one_ms = run(cfg, False, exact)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        print(f"TTE over {mesh.n_data} ranks at {spec['pair']}, p={p} "
              f"({'IEEE' if exact else 'TF32'}): losses {losses} against one "
              f"process {want}, max rel {max(rel):.2e}")
        if not max(rel) <= MESH_TTE_RTOL:
            raise AssertionError(f"TTE p={p}: losses differ")
        if p == 0.0:
            shards = shard_sum_grad(cfg, micro[0], mesh.n_data, t, dev)
            ds, same = grad_rel(grad0, shards), all(
                torch.equal(a, b) for a, b in zip(grad0, shards))
            dg = grad_rel(grad0, want_grad0)
            worst = max(float((a - b).abs().max()) / float(b.abs().max())
                        for a, b in zip(grad0, want_grad0))
            print(f"TTE p=0: |dg|/|g| {ds:.2e} against one process's sum "
                  f"over the same {mesh.n_data} shards (bit-equal {same}); "
                  f"{dg:.2e} against the global batch's gradient (worst "
                  f"tensor max|dg|/max|g| {worst:.2e}), "
                  f"{grad_rel(shards, want_grad0):.2e} between those two in "
                  "one process")
            if not (ds <= MESH_TTE_RTOL and dg <= TRAIN_GRAD_RTOL
                    and worst <= TRAIN_GRAD_MAX):
                raise AssertionError(f"TTE p=0: |dg|/|g| {ds} (shards), "
                                     f"{dg} / {worst} (global batch)")
            continue
        readings["tte_one_process_micro_ms"] = float(np.mean(one_ms[1:]))
        if dev.type == "cuda":
            if not (len(gathered) == len(want_bits) > 0 and all(
                    torch.equal(torch.from_numpy(g), w)
                    for g, w in zip(gathered, want_bits))):
                raise AssertionError("TTE p=0.1: the ranks' keep bits are not "
                                     "one process's rows")
            print(f"TTE p=0.1: the keep bits of {len(want_bits)} dQ launches "
                  "of the first micro-step, gathered over the ranks, equal "
                  "one process's row for row")
    return readings


def shard_sum_grad(cfg, mb: dict, n_shards: int, out_len: int, dev) -> list:
    """In one process, the gradient a first data-parallel micro-step
    forms: each shard's, from the seeded state, with the global batch's
    loss denominators and the shard's global rows for the masks, summed
    over the shards (IEEE float32, deterministic algorithms)."""
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.models.tte.loss import tte_loss
    from parrot_tts_tpu_torch.train import tte as tte_train

    model = tte_train.init_state(SEED, cfg, dev).model
    params = list(model.parameters())
    full = tte_train.to_batch(mb, dev)
    w = full["sample_weight"][:, None]
    denom = torch.stack([((full["codes"] != cfg.hubert_codes) * w).sum(),
                         (full["src_mask"] * w).sum()])
    b = len(mb["codes"])
    loc = b // n_shards
    total = None
    with exact_numerics(True), deterministic_algorithms():
        for r in range(n_shards):
            part = tte_train.to_batch(
                {k: v[r * loc:(r + 1) * loc] for k, v in mb.items()}, dev)
            logits, _, log_dur = parrot.apply_parrot_train(
                model, part, out_len=out_len, dropout=(SEED, 0),
                rows=(r * loc, b))
            loss = tte_loss(logits, log_dur, part["codes"], part["duration"],
                            part["src_mask"], num_codes=cfg.hubert_codes,
                            sample_weight=part["sample_weight"],
                            reduce=lambda d: d.copy_(denom))[0]
            g = torch.autograd.grad(loss, params)
            total = list(g) if total is None else [
                a + x for a, x in zip(total, g)]
    return total


def mesh_gan_steps(spec, mesh, meshlib, rank: int, dev) -> dict:
    """MESH_GAN_STEPS V1 GAN steps over the ranks (each its half of the
    batch) against one process on the whole batch, at phase 14's
    tolerances; every parameter and spectral-norm vector bit-equal across
    the ranks."""
    from parrot_tts_tpu_torch.train import vocoder as voc_train

    mcfg, tcfg, mel_cfg = spec["gan"]
    rng = np.random.default_rng(SEED + 19)
    b, seg = tcfg.batch_size, tcfg.segment_size
    batch_np = {"audio": (rng.standard_normal((b, seg)) * 0.2).astype(
                    np.float32),
                "code": rng.integers(0, mcfg.num_embeddings,
                                     (b, seg // tcfg.code_hop_size)),
                "spkr": np.arange(b) % mcfg.num_speakers}

    def run(dp: bool):
        state = voc_train.init_state(tcfg.seed, mcfg, dev)
        sl = meshlib.local_rows(b) if dp else slice(0, b)
        batch = voc_train.to_batch({k: v[sl] for k, v in batch_np.items()},
                                   dev)
        metrics, ms, g = [], [], None
        with deterministic_algorithms():
            for i in range(MESH_GAN_STEPS):
                sync(dev)
                t0 = time.perf_counter()
                m = voc_train.train_step(state, batch, mcfg, tcfg, mel_cfg,
                                         10, exact=True,
                                         mesh=mesh if dp else None)
                metrics.append({k: float(v) for k, v in m.items()})
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and not rank:
                    g = gan_grads(state)
        return state, metrics, g, ms

    state, metrics, g, ms = run(True)
    nets = [t for m in (state.gen, state.mpd, state.msd)
            for t in m.state_dict().values()]
    if not same_on_every_rank(meshlib, nets):
        raise AssertionError("GAN: parameters or spectral-norm vectors "
                             "differ across ranks")
    readings = {"gan_step_ms": float(np.mean(ms))}
    if rank:
        return readings
    del state, nets
    _, want, g1, one_ms = run(False)
    readings["gan_one_process_step_ms"] = float(np.mean(one_ms))
    for step, (a, w) in enumerate(zip(metrics, want)):
        for k in w:
            rel = abs(a[k] - w[k]) / abs(w[k])
            if not rel <= GAN_LOSS_RTOL:
                raise AssertionError(f"GAN step {step} {k}: rel {rel}")
    for net in g1:
        keys = list(g1[net])
        rel = grad_rel([g[net][k] for k in keys], [g1[net][k] for k in keys])
        worst = max(float((g[net][k] - g1[net][k]).abs().max())
                    / max(float(g1[net][k].abs().max()), 1e-30)
                    for k in keys)
        print(f"GAN over {mesh.n_data} ranks, {net} gradients of step 1: "
              f"|dg|/|g| {rel:.2e}, worst tensor {worst:.2e}")
        if not (rel <= GAN_GRAD_RTOL and worst <= GAN_GRAD_MAX):
            raise AssertionError(f"GAN {net}: gradients differ")
    print(f"GAN over {mesh.n_data} ranks: {MESH_GAN_STEPS} steps' losses "
          f"within {GAN_LOSS_RTOL} of one process; parameters and "
          "spectral-norm vectors bit-equal across the ranks")
    return readings


def mesh_tensor_parallel(spec, meshlib, rank: int, dev) -> None:
    """The TTE decode with the model axis over the ranks (each its heads,
    filters and codes) against the replicated decode."""
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.infer.tte_infer import make_batch
    from parrot_tts_tpu_torch.models.tte import parrot
    from parrot_tts_tpu_torch.parallel import tensor as tp

    tcfg, vcfg = spec["tcfg"], spec["vcfg"]
    mesh = meshlib.create_mesh([dev], model_parallel_size=meshlib
                               .process_count())
    tts = make_tts(tcfg, vcfg, device=dev, exact=True)
    local = tp.shard_parrot_tp(mesh, tts.tte)
    speakers = [i % tcfg.n_speaker for i in range(len(TEXTS))]
    tokens = [tts.tokenize(t) for t in TEXTS]
    samples = [(s, speakers[i]) for i, s in enumerate(tokens)]
    for s_len, out_len, idxs in tts.plan(tokens):
        raw = make_batch(samples, idxs, s_len)
        batch = parrot.to_batch(raw, dev)
        codes, mask, total = parrot.infer_codes(local, raw, out_len=out_len,
                                                device=dev, mesh=mesh)
        with torch.no_grad(), exact_numerics(True):
            logits = parrot.apply_parrot(local, batch, out_len=out_len,
                                         mesh=mesh)[0]
            if rank:
                continue
            want, want_mask, _ = parrot.apply_parrot(tts.tte, batch,
                                                     out_len=out_len)
        if not torch.equal(mask, want_mask):
            raise AssertionError(f"TP bucket {out_len}: durations differ")
        top2 = torch.topk(want, 2, dim=-1).values
        clear = mask & (top2[..., 0] - top2[..., 1] > 2 * DLOGIT_TOL)
        dlogit = float((logits - want)[mask].abs().max())
        if not (dlogit <= DLOGIT_TOL and torch.equal(
                codes[clear], want.argmax(-1)[clear])):
            raise AssertionError(f"TP bucket {out_len}: max |dlogit| "
                                 f"{dlogit}, or codes differ off ties")
        print(f"TP={mesh.n_model} decode, bucket ({s_len}, {out_len}) x "
              f"{len(idxs)}: durations equal, max |dlogit| {dlogit:.3e} "
              "against the replicated decode, codes equal off ties")


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_worker(spec_path: str, rank: int, world: int, store: str) -> int:
    """One rank of phase 18's gloo group (run by phase_mesh in a process
    of its own): sharded serving, the data-parallel TTE and GAN steps and
    the tensor-parallel decode. Writes its launches and readings to
    <spec_path>.<rank>."""
    from parrot_tts_tpu_torch.core import mesh as meshlib
    from parrot_tts_tpu_torch.ops import flash_attention as fa
    from parrot_tts_tpu_torch.ops import flash_dropout as fd

    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    meshlib.initialize_distributed("gloo", init_method=store,
                                   world_size=world, rank=rank,
                                   timeout_s=MESH_DEADLINE_S)
    mesh = meshlib.create_mesh([dev])
    for k in (fa.FLASH_FWD, fa.SPLIT_PREP, fd.FWD, fd.DQ, fd.DKV):
        k.launches = 0
    t0 = time.perf_counter()
    mesh_serve(spec, mesh, rank, dev)
    serve = mesh_launches(fa, fd)
    t1 = time.perf_counter()
    readings = mesh_tte_steps(spec, mesh, meshlib, rank, dev, fd)
    t2 = time.perf_counter()
    readings.update(mesh_gan_steps(spec, mesh, meshlib, rank, dev))
    t3 = time.perf_counter()
    mesh_tensor_parallel(spec, meshlib, rank, dev)
    print(f"rank {rank} seconds: serving {t1 - t0:.1f}, TTE steps "
          f"{t2 - t1:.1f}, GAN steps {t3 - t2:.1f}, TP decode "
          f"{time.perf_counter() - t3:.1f}")
    with open(f"{spec_path}.{rank}", "w") as f:
        json.dump({"rank": rank, "serve_launches": serve,
                   "launches": mesh_launches(fa, fd),
                   "readings": readings}, f)
    meshlib.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_mesh(fa, fd, base: dict, tcfg, vcfg, smi: str, *, train_cfg,
               gan: tuple, rows: int = MESH_ROWS, device=None) -> dict:
    """Phase 18. NCCL (gloo on the CPU) at world size 1 in this process:
    the serve with mesh= bit-equal to phase 4's without, and one TTE
    optimizer step under the group bit-equal to the step without it.
    Then MESH_WORLD gloo ranks on the one card (`mesh_worker`), joined
    within MESH_DEADLINE_S or killed; then `synthesize --mesh` through
    the CLI against the files without --mesh. Returns the kernel launches
    of the phase (this process's and the ranks')."""
    import tempfile

    from parrot_tts_tpu_torch import cli
    from parrot_tts_tpu_torch.core import mesh as meshlib
    from parrot_tts_tpu_torch.core.checkpoint import (CheckpointManager,
                                                      save_config_json)
    from parrot_tts_tpu_torch.core.config import to_json
    from parrot_tts_tpu_torch.data.audio_io import read_wav
    from parrot_tts_tpu_torch.data.manifest import write_manifest
    from parrot_tts_tpu_torch.train import tte as tte_train

    dev = torch.device(device or "cuda:0")
    for k in (fa.FLASH_FWD, fa.SPLIT_PREP, fd.FWD, fd.DQ, fd.DKV):
        k.launches = 0
    backend = "nccl" if dev.type == "cuda" else "gloo"
    meshlib.initialize_distributed(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0)
    try:
        mesh = meshlib.create_mesh(None if dev.type == "cuda" else [dev])
        tts = make_tts(tcfg, vcfg, device=device, mesh=mesh)
        speakers = base["speakers"]
        wavs = tts.tts(TEXTS, speakers=speakers)
        units = tts.predict_units([tts.tokenize(t) for t in TEXTS], speakers)
        if not (all(np.array_equal(a, b) for a, b in zip(units,
                                                         base["units"]))
                and all(np.array_equal(a, b) for a, b in zip(wavs,
                                                             base["wavs"]))):
            raise AssertionError(f"{backend} world 1: the mesh serve differs "
                                 "from phase 4's")
        print(f"{backend} world 1, mesh {mesh.shape}: units and waveforms "
              "bit-equal to phase 4's serve without a mesh")
        # fetch gathers host copies; at world 1 it skips the collective, so
        # run it here: a group with no CPU backend fails on this call
        host = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        if not torch.equal(meshlib.all_gather_rows(host), host):
            raise AssertionError(f"{backend} world 1: the host gather "
                                 "differs from its input")
        print(f"{backend} world 1: fetch's gather of a host tensor runs on "
              f"the group ({torch.distributed.get_backend()})")
        s, t = MESH_PAIR if dev.type == "cuda" else spec_pair(train_cfg)
        batch = synthetic_tte_batch(np.random.default_rng(SEED + 17),
                                    train_cfg.batch_size, s, t, tcfg)
        one = dataclasses.replace(train_cfg, grad_acc_steps=1)
        params = []
        for m in (mesh, None):
            state = tte_train.init_state(SEED, tcfg, dev)
            with deterministic_algorithms():
                tte_train.train_step(state, tte_train.to_batch(batch, dev),
                                     SEED, tcfg, one, t, m)
            params.append([p.detach().clone()
                           for p in state.model.parameters()])
        if not all(torch.equal(a, b) for a, b in zip(*params)):
            raise AssertionError(f"{backend} world 1: the TTE step under the "
                                 "group differs from the step without it")
        print(f"{backend} world 1: one TTE optimizer step at ({s}, {t}) "
              "under the group bit-equal to the step without it")
        del tts, params, state
    finally:
        torch.distributed.destroy_process_group()
    launches = mesh_launches(fa, fd)

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="parrot_mesh_") as tmp:
        spec = {"device": str(dev), "tcfg": tcfg, "vcfg": vcfg,
                "train_cfg": train_cfg, "gan": gan, "rows": rows,
                "pair": MESH_PAIR if dev.type == "cuda"
                else spec_pair(train_cfg)}
        path = f"{tmp}/spec.pt"
        torch.save(spec, path)
        store = f"file://{tmp}/store"
        code = ("import sys, chip_smoke; sys.exit(chip_smoke.mesh_worker("
                f"{path!r}, {{}}, {MESH_WORLD}, {store!r}))")
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        logs = [open(f"{tmp}/rank{r}.log", "w+") for r in range(MESH_WORLD)]
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code.format(r)],
                                  cwd=here, env=env, stdout=logs[r],
                                  stderr=subprocess.STDOUT)
                 for r in range(MESH_WORLD)]
        deadline = time.monotonic() + MESH_DEADLINE_S
        try:
            for p in procs:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, f in enumerate(logs):
            f.seek(0)
            text = f.read()
            f.close()
            print(f"--- mesh rank {r} (exit {procs[r].returncode}) ---")
            print(text[-6000:].rstrip())
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"phase 18: a gloo rank failed or passed "
                                 f"the {MESH_DEADLINE_S} s deadline")
        outs = [json.load(open(f"{path}.{r}")) for r in range(MESH_WORLD)]
        print(f"{MESH_WORLD} gloo ranks on {dev}: {time.perf_counter() - t0:.1f}"
              " s from spawn to join")
    for o in outs:
        for k, n in o["launches"].items():
            launches[k] += n
        if dev.type == "cuda" and not (o["serve_launches"]["flash_attn_fwd"]
                                       and all(o["launches"].values())):
            raise AssertionError(f"rank {o['rank']}: a kernel of the mesh "
                                 f"path was not launched: {o['launches']}")
    rd = outs[0]["readings"]
    print(f"rank launches (row 1, rows 2-4): "
          + "; ".join(f"rank {o['rank']} {o['launches']}" for o in outs))
    print(f"phase 18 readings, {MESH_WORLD} gloo ranks sharing one card, "
          f"{smi}: TTE micro-step at {spec['pair']} x "
          f"{train_cfg.batch_size} rows per rank {rd['tte_micro_ms']:.3f} ms "
          f"(one process, {MESH_WORLD * train_cfg.batch_size} rows: "
          f"{rd['tte_one_process_micro_ms']:.3f} ms); gloo all-reduce of the "
          f"{rd['grad_mib']:.1f} MiB gradient {rd['allreduce_ms']:.3f} ms "
          f"({rd['allreduce_ms'] / rd['tte_micro_ms']:.3f} of the "
          f"micro-step); V1 GAN step at {gan[1].batch_size // MESH_WORLD} "
          f"rows per rank {rd['gan_step_ms']:.3f} ms (one process, "
          f"{gan[1].batch_size} rows: {rd['gan_one_process_step_ms']:.3f} ms)")

    # synthesize --mesh through the CLI, on this process's devices
    with tempfile.TemporaryDirectory(prefix="parrot_mesh_cli_") as tmp:
        from pathlib import Path

        from parrot_tts_tpu_torch.models.vocoder import generator

        tmp = Path(tmp)
        gen_state = generator.init_code_generator(
            vcfg, torch.Generator().manual_seed(SEED))
        CheckpointManager(tmp / "ckpt").save(1, {"gen": gen_state})
        save_config_json(tmp / "ckpt", to_json(vcfg))
        write_manifest(tmp / "hubert.txt", [
            {"audio": f"/corpus/spk{i % 2}_{i:03d}.wav",
             "hubert": " ".join(map(str, u.tolist()))}
            for i, u in enumerate(base["units"]) if len(u)])
        argv = ["synthesize", "--manifest", str(tmp / "hubert.txt"),
                "--ckpt-dir", str(tmp / "ckpt")]
        dev_arg = [] if dev.type == "cuda" else ["--device", str(dev)]
        cli.main(argv + ["--out-dir", str(tmp / "plain")] + dev_arg)
        cli.main(argv + ["--out-dir", str(tmp / "mesh"), "--mesh"] + dev_arg)
        files = sorted(p.name for p in (tmp / "plain").glob("*.wav"))
        if not files or files != sorted(p.name for p in
                                        (tmp / "mesh").glob("*.wav")) or \
                not all(np.array_equal(read_wav(tmp / "plain" / f)[0],
                                       read_wav(tmp / "mesh" / f)[0])
                        for f in files):
            raise AssertionError("synthesize --mesh: its files differ from "
                                 "those without --mesh")
        print(f"synthesize --mesh through the CLI: {len(files)} files equal "
              "to those without --mesh")
    return launches


# ---- phase 19: the bf16 compute modes ---------------------------------------

BF16_MRF_RTOL = 2.0 ** -6     # row 6 in bf16: max |diff| <= this * max |plain|
# the bf16 budgets of scripts/tpu_parity_check.py:372-374 against float32:
# max |dev| and SNR (dB) gate; its log-mel L1 < 0.3 is printed, not gated:
# with seeded random weights V1's waveform is nearly constant (phase 19
# prints its rms and peak), so every mel bin but the lowest sits near
# the log's 1e-5 clamp, where bf16's rounding alone moves it (the float32
# waveform rounded to bf16 gives 0.10 by itself; printed beside it)
BF16_MAXDEV, BF16_SNR_DB, BF16_MEL_L1 = 2e-3, 33.0, 0.3
# bf16 fused against bf16 unfused: the two round at different points (the
# fused kernel adds each conv's bias before its one rounding and sums the
# branches in float32, the composition rounds the conv, then the bias, and
# averages in bf16), so they differ as the JAX package's two routes do;
# each is within BF16_MAXDEV of float32, so within twice it of the other
BF16_FUSED_MAXDEV, BF16_FUSED_SNR_DB = 2 * BF16_MAXDEV, BF16_SNR_DB
BF16_SERVES = {"bf16": {}, "bf16 fused": {"fused_mrf": True},
               "bf16 int8-static": {"quant": "int8-static"},
               "bf16 int8": {"quant": "int8"},
               "bf16 int8-tail": {"quant": "int8-tail"}}
BENCH_BATCH = (64, 250)       # bench.py's vocoder batch: rows x codes
BENCH_REPS = 5                # timed warm batches per mode and dtype
BENCH_MODES = {"float": {}, "fused": {"fused_mrf": True},
               "int8": {"quant": "int8"}, "int8-tail": {"quant": "int8-tail"},
               "int8-static": {"quant": "int8-static"}}
BF16_GAN_STEPS = 2
MRF_WIDTHS = tuple(range(8, 121, 8))    # every width row 6 takes, either mode
MRF_WIDTH_SHAPE = (2, 16387)            # (B, T) of its sweep: a ragged T
NARROW_CHANNELS = 256                   # V1's rates at 256 channels: fused
                                        # stages of 64, 32, 16 and 8


def bf16_mrf_bounds(b: int, t: int, c: int, w, bias, plan) -> tuple:
    """Row 6's bound in bf16: its products on the bf16 tensor cores (2 *
    B*T * sum over convs of K * C^2), x read and out written once (2 bytes
    each), the weights and biases once."""
    flops = 2.0 * b * t * c * c * sum(
        2 * k * len(d) for k, d in zip(plan.kernel_sizes, plan.dilations))
    nbytes = 4.0 * b * t * c + 2.0 * (w.numel() + bias.numel())
    return bound(flops, BF16_PEAK, nbytes)


def phase_bf16_mrf(fm, exact_numerics, model, vcfg, batches,
                   registers: dict) -> dict:
    """Row 6's bf16 mode against its bf16 plain version at every (B, T, C)
    the bf16 fused serve gives it, on the serve's packed bf16 weights:
    mismatched elements counted, max |diff| <= BF16_MRF_RTOL * max |plain|,
    two launches bit-equal; no ptxas spills; per width the tile, its weight
    slots (a ring, or the whole stream resident) and the share of its bound;
    kernel, plain and bound ms, and the unfused cuDNN bf16 composition of
    the same stage (the library yardstick). `model`: the bf16 fused
    serve's CodeGenerator."""
    from parrot_tts_tpu_torch.models.vocoder import generator

    regs = {k: v for k, v in registers.items()
            if k.startswith("mrf_kernel_bf16")}
    print_registers(regs)
    spilled = {k: v for k, v in regs.items() if v[1] or v[2]}
    if spilled:
        raise AssertionError(f"bf16 fused MRF kernels spill: {spilled}")
    rng = np.random.default_rng(SEED + 19)
    nk = len(vcfg.resblock_kernel_sizes)
    rows = []
    with torch.no_grad(), exact_numerics(True):
        for (b, t, c), i in mrf_serve_shapes(vcfg, batches):
            w, bias = getattr(model, f"mrf_w{i}"), getattr(model, f"mrf_b{i}")
            wk, plan = getattr(model, f"mrf_k{i}"), model.mrf_plans[i]
            if all(r["C"] != c for r in rows):
                tile = fm.tile_plan(plan, dtype=torch.bfloat16)
                slots = (f"all {tile.ring_slots} slabs resident"
                         if tile.resident else
                         f"a ring of {tile.ring_slots} slots")
                print(f"fused MRF bf16 C={c}: tile {tile.tb} rows, halo "
                      f"{plan.halo}, {tile.warpgroups} warpgroups x "
                      f"{tile.rounds} units, wgmma m64n{tile.wgmma_n}k16, "
                      f"slabs of one tap ({tile.k_chunk} inputs) in {slots}, "
                      f"recompute {tile.recompute:.3f}, shared memory "
                      f"{tile.smem_bytes} bytes")
            x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(
                np.float32)).to(model.conv_pre.weight.device).bfloat16()
            got = fm.mrf_fused(x, w, bias, plan, wk=wk)
            again = fm.mrf_fused(x, w, bias, plan, wk=wk)
            want = fm.mrf_fused_reference(x, w, bias, plan)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err, lim = float(diff.max()), BF16_MRF_RTOL * float(
                want.float().abs().max())
            mismatched = int((diff > 0).sum())
            if not (got.dtype == torch.bfloat16 and err <= lim):
                raise AssertionError(f"fused MRF bf16 B={b} T={t} C={c}: max "
                                     f"|diff| {err} > {lim}")
            if not torch.equal(got, again):
                raise AssertionError(f"fused MRF bf16 B={b} T={t} C={c}: two "
                                     f"launches differ")
            stage = model.resblocks[i * nk:(i + 1) * nk]

            def library():
                acc = None
                for rb in stage:
                    y = generator.apply_resblock1(rb, x)
                    acc = y if acc is None else acc + y
                return acc / nk

            reps = max(3, min(30, int(3e6 / (b * t))))
            ms = cuda_ms(lambda: fm.mrf_fused(x, w, bias, plan, wk=wk), reps)
            plain_ms = cuda_ms(
                lambda: fm.mrf_fused_reference(x, w, bias, plan), reps)
            library_ms = cuda_ms(library, reps)
            bound_ms, bound_by = bf16_mrf_bounds(b, t, c, w, bias, plan)
            rows.append({"B": b, "T": t, "C": c, "count": 1,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by})
            print(f"fused MRF bf16 B={b} T={t:7d} C={c:2d}: max|diff| "
                  f"{err:.3e} (limit {lim:.3e}), {mismatched} of "
                  f"{diff.numel()} elements differ  kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  cuDNN bf16 composition "
                  f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms "
                  f"({bound_by}, bf16 tensor cores)")
            del x, got, again, want, diff
    rep = total(rows)
    rep["library_ms"] = sum(r["library_ms"] for r in rows)
    for c in sorted({r["C"] for r in rows}, reverse=True):
        st = [r for r in rows if r["C"] == c]
        ms, bnd = (sum(r[k] for r in st) for k in ("ms", "bound_ms"))
        print(f"fused MRF bf16 per serve C={c} ({len(st)} launches): kernel "
              f"{ms:.4f} ms  plain "
              f"{sum(r['plain_ms'] for r in st):.4f} ms  cuDNN bf16 "
              f"{sum(r['library_ms'] for r in st):.4f} ms  bound "
              f"{bnd:.4f} ms ({100 * bnd / ms:.1f}% of it)")
    print(f"fused MRF bf16 per serve ({len(rows)} launches): kernel "
          f"{rep['ms']:.4f} ms  plain {rep['plain_ms']:.4f} ms  cuDNN bf16 "
          f"{rep['library_ms']:.4f} ms  bound {rep['bound_ms']:.4f} ms "
          f"({rep['bound_by']}; {100 * rep['bound_ms'] / rep['ms']:.1f}% "
          f"of it)")
    return {"report": rep, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "checked": {(r["B"], r["T"], r["C"]) for r in rows}}


def phase_mrf_widths(fm, exact_numerics,
                     dtype: torch.dtype = torch.bfloat16) -> list[dict]:
    """Row 6 in one mode (bf16, phase 19; float32, after phase 5) at every
    width it takes (MRF_WIDTHS) on random packed weights of V1's
    resblocks (fan-in scaled; halo 60) and x of MRF_WIDTH_SHAPE (rows of
    two lengths): max |diff| <= BF16_MRF_RTOL (bf16) or MRF_RTOL
    (float32) * max |plain| against its plain version, two launches
    bit-equal; per width its tile, kernel and bound ms and share of the
    bound (bf16 tensor cores, or 3xTF32 on the TF32 ones)."""
    bf16 = dtype == torch.bfloat16
    label, rtol = ("bf16", BF16_MRF_RTOL) if bf16 else ("float32", MRF_RTOL)
    rng = np.random.default_rng(SEED + (16 if bf16 else 18))
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    b, t = MRF_WIDTH_SHAPE
    dev = torch.device("cuda")
    rows = []
    with torch.no_grad(), exact_numerics(True):
        for c in MRF_WIDTHS:
            def tens(*shape, scale=1.0):
                return torch.from_numpy((rng.standard_normal(shape) * scale)
                                        .astype(np.float32))
            convs = [[(tens(k, c, c, scale=(c * k) ** -0.5),
                       tens(c, scale=0.1), tens(k, c, c, scale=(c * k) ** -0.5),
                       tens(c, scale=0.1)) for _ in d] for k, d in zip(ks, ds)]
            w, bias, plan = fm.pack_mrf(convs, ks, ds)
            w, bias = w.to(dev, dtype), bias.to(dev, dtype)
            wk = fm.kernel_weights(w, plan)
            x = tens(b, t, c)
            x[1, 2 * t // 3:] = 0.0
            x = x.to(dev, dtype)
            got = fm.mrf_fused(x, w, bias, plan, wk=wk)
            again = fm.mrf_fused(x, w, bias, plan, wk=wk)
            want = fm.mrf_fused_reference(x, w, bias, plan)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            lim = rtol * float(want.float().abs().max())
            if not (err <= lim and torch.equal(got, again)):
                raise AssertionError(
                    f"fused MRF {label} C={c}: max |diff| {err} (limit "
                    f"{lim}), two launches bit-equal: "
                    f"{torch.equal(got, again)}")
            ms = cuda_ms(lambda: fm.mrf_fused(x, w, bias, plan, wk=wk), 10)
            bound_ms, bound_by = (
                bf16_mrf_bounds(b, t, c, w, bias, plan) if bf16
                else mrf_bounds(b, t, c, w, bias, plan)["3xtf32"])
            tile = fm.tile_plan(plan, (b, t), dtype=dtype)
            rows.append({"C": c, "max_abs_err": err, "ms": ms,
                         "bound_ms": bound_ms})
            print(f"fused MRF {label} width C={c:3d} B={b} T={t}: max|diff| "
                  f"{err:.3e} (limit {lim:.3e}, {err / lim:.3f} of it), "
                  f"{int((diff > 0).sum())} of {diff.numel()} elements "
                  f"differ, two launches bit-equal; tile {tile.tb} rows, "
                  f"{tile.warpgroups} x {tile.rounds} units, "
                  f"{'resident' if tile.resident else tile.ring_slots}"
                  f" slots; kernel {ms:.4f} ms  bound {bound_ms:.4f} ms "
                  f"({bound_by}{'' if bf16 else ', 3xTF32'}, "
                  f"{100 * bound_ms / ms:.1f}%)")
            del x, got, again, want, diff
    return rows


def phase_bf16_narrow_serve(fm, tcfg, vcfg, base: dict, device=None) -> int:
    """The bf16 fused vocoder of vcfg at upsample_initial_channel
    NARROW_CHANNELS (fused stages of 64, 32, 16 and 8 channels) on phase
    4's units: its launches (one per fused stage per vocoder batch), held
    to its bf16 unfused serve (BF16_FUSED_*) and its float32 fused serve
    (BF16_MAXDEV, BF16_SNR_DB) on the same seeded weights. Returns the
    row-6 launches of both fused serves."""
    units, speakers = base["units"], base["speakers"]
    narrow = dataclasses.replace(vcfg, upsample_initial_channel=NARROW_CHANNELS)
    want = len(mrf_stages(narrow)) * len(vocoder_batches(units))
    wavs, launches = {}, {}
    for label, change in (("bf16 fused", dict(dtype="bfloat16",
                                              fused_mrf=True)),
                          ("bf16", dict(dtype="bfloat16")),
                          ("float32 fused", dict(fused_mrf=True))):
        synth = make_tts(tcfg, dataclasses.replace(narrow, **change),
                         device).vocoder
        fm.FUSED_MRF.launches = 0
        wavs[label] = synth.synthesize(units, speakers)
        launches[label] = fm.FUSED_MRF.launches
        if not all(np.isfinite(w).all() and len(w) == len(u) * vcfg
                   .total_upsample for w, u in zip(wavs[label], units)):
            raise AssertionError(f"{label} serve at {NARROW_CHANNELS} "
                                 "channels: wrong lengths or non-finite")
    stages = [c for _, c, _ in mrf_stages(narrow)]
    if device is None and launches != {"bf16 fused": want, "bf16": 0,
                                       "float32 fused": want}:
        raise AssertionError(f"serves at {NARROW_CHANNELS} channels: row-6 "
                             f"launches {launches}, want {want} per fused "
                             "serve")
    dev = torch.device(device or "cuda")
    unfused = wave_stats(wavs["bf16 fused"], wavs["bf16"], dev)
    f32 = wave_stats(wavs["bf16 fused"], wavs["float32 fused"], dev)
    print(f"bf16 fused serve at upsample_initial_channel {NARROW_CHANNELS} "
          f"(fused stages {stages}, {launches['bf16 fused']} row-6 "
          f"launches): against its bf16 unfused serve {stats_line(unfused)};"
          f" against its float32 fused serve {stats_line(f32)}")
    if not (unfused["maxdev"] <= BF16_FUSED_MAXDEV
            and unfused["snr_db"] >= BF16_FUSED_SNR_DB
            and f32["maxdev"] <= BF16_MAXDEV
            and f32["snr_db"] >= BF16_SNR_DB):
        raise AssertionError(f"bf16 fused serve at {NARROW_CHANNELS} "
                             f"channels outside its budgets: {unfused} "
                             f"{f32}")
    return launches["bf16 fused"] + launches["float32 fused"]


def wave_stats(got: list, want: list, device=None) -> dict:
    """max |dev|, SNR over all requests (sums of squares) and of the worst
    one, and the log-mel L1 (the reference's loss mel, over every frame of
    every request) of waveforms `got` against `want`."""
    from parrot_tts_tpu_torch.ops import stft

    sig = err = 0.0
    dev, worst, mel_sum, mel_n = 0.0, math.inf, 0.0, 0
    for a, f in zip(got, want):
        if a.shape != f.shape:
            raise AssertionError(f"{a.shape} != {f.shape}")
        if not a.size:
            continue
        e = float(((a.astype(np.float64) - f) ** 2).sum())
        s = float((f.astype(np.float64) ** 2).sum())
        sig, err = sig + s, err + e
        dev = max(dev, float(np.abs(a - f).max()))
        worst = min(worst, 10 * math.log10(s / max(e, 1e-30)))
        if a.size > 1024:
            ma, mf = (stft.mel_spectrogram(torch.from_numpy(np.ascontiguousarray(
                v, np.float32))[None].to(device or "cpu")) for v in (a, f))
            mel_sum += float((ma - mf).abs().sum())
            mel_n += ma.numel()
    return {"maxdev": dev, "snr_db": 10 * math.log10(sig / max(err, 1e-30)),
            "worst_db": worst, "mel_l1": mel_sum / max(mel_n, 1)}


def stats_line(st: dict) -> str:
    return (f"max |dev| {st['maxdev']:.4e}, SNR {st['snr_db']:.2f} dB (worst "
            f"request {st['worst_db']:.2f} dB), log-mel L1 {st['mel_l1']:.4f}")


def phase_bf16_serves(fm, qc, tcfg, vcfg, base: dict, mrf_checked: set,
                      int8_checked: set, device=None) -> dict:
    """ParrotTTS with the bf16 vocoder in every serving mode on phase 4's
    requests and weights (the TTE in its default decode mode), each served
    twice: bit-equal, lengths len(units)*320, finite; the fused launches 3
    and the int8 launches INT8_SITES per vocoder batch, each at a shape
    phases 6 and 19 checked; against phase 4's float32 waveforms: bf16 and
    bf16 fused within BF16_MAXDEV and BF16_SNR_DB (log-mel L1 printed),
    the int8 modes >= SNR_MIN_DB over all requests and for the worst; bf16
    fused against bf16 unfused within BF16_FUSED_*."""
    units, speakers = base["units"], base["speakers"]
    batches = vocoder_batches(units)
    out = {}
    for label, change in BF16_SERVES.items():
        cfg = dataclasses.replace(vcfg, dtype="bfloat16", **change)
        tts = make_tts(tcfg, cfg, device)
        if cfg.quant == "int8-static":
            length = max(t for _, t in batches)
            rows = [np.tile(u, -(-length // len(u)))[:length] for u in units
                    if len(u)]
            tts.vocoder.calibrate(rows, [s for u, s in zip(units, speakers)
                                         if len(u)])
        want_mrf = (len(mrf_stages(cfg)) * len(batches) if cfg.fused_mrf
                    else 0)
        want_q8 = INT8_SITES.get(cfg.quant, 0) * len(batches)
        runs = []
        for run in range(2):
            with recording(fm, "mrf_fused", mrf_key) as mrf_shapes, \
                    recording(qc, "int8_conv", int8_key) as q8_shapes:
                fm.FUSED_MRF.launches = qc.INT8_CONV.launches = 0
                wavs = tts.tts(TEXTS, speakers=speakers)
                launches = (fm.FUSED_MRF.launches, qc.INT8_CONV.launches)
            serve_line(f"{label} serve {run}", tts.last_stats, sum(launches))
            if launches != (want_mrf, want_q8):
                raise AssertionError(f"{label}: launches {launches}, want "
                                     f"{(want_mrf, want_q8)}")
            if device is None and not (mrf_shapes <= mrf_checked
                                       and q8_shapes <= int8_checked):
                raise AssertionError(
                    f"{label}: launch shapes {sorted(mrf_shapes - mrf_checked)}"
                    f" {sorted(q8_shapes - int8_checked)} were not checked "
                    "against plain")
            runs.append(wavs)
        for i, (a, b, u) in enumerate(zip(*runs, units)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{label} request {i}: not "
                                     "deterministic")
            if len(a) != len(u) * vcfg.total_upsample or a.dtype != np.float32:
                raise AssertionError(f"{label} request {i}: {len(a)} "
                                     f"{a.dtype} samples for {len(u)} units")
            if not np.isfinite(a).all():
                raise AssertionError(f"{label} request {i}: non-finite")
        st = wave_stats(runs[0], base["wavs"], tts.device)
        print(f"{label} serve against phase 4's float32 serve: "
              f"{stats_line(st)}")
        if cfg.quant == "none":
            print(f"{label}: log-mel L1 {st['mel_l1']:.4f} against "
                  f"tpu_parity_check.py's {BF16_MEL_L1} (a reading: "
                  "BF16_MEL_L1's comment)")
            ok = st["maxdev"] < BF16_MAXDEV and st["snr_db"] >= BF16_SNR_DB
        else:
            ok = st["snr_db"] >= SNR_MIN_DB and st["worst_db"] >= SNR_MIN_DB
        if not ok:
            raise AssertionError(f"{label}: outside its budget: {st}")
        out[label] = {"wavs": runs[0], "launches": launches, "stats": st,
                      "tts": tts,
                      "serve": (lambda t=tts: t.tts(TEXTS, speakers=speakers))}
    floor = [torch.from_numpy(w).bfloat16().float().numpy()
             for w in base["wavs"]]
    level = [(float(np.sqrt(np.mean(np.square(w, dtype=np.float64)))),
              float(np.abs(w).max())) for w in base["wavs"] if w.size]
    print(f"phase 4's float32 waveforms: rms {min(r for r, _ in level):.4f}-"
          f"{max(r for r, _ in level):.4f}, peak "
          f"{min(p for _, p in level):.4f}-{max(p for _, p in level):.4f}; "
          "rounded to bf16, against themselves: "
          + stats_line(wave_stats(floor, base["wavs"], out["bf16"]["tts"]
                                  .device)))
    st = wave_stats(out["bf16 fused"]["wavs"], out["bf16"]["wavs"],
                    out["bf16"]["tts"].device)
    print(f"bf16 fused serve against the bf16 unfused serve: {stats_line(st)}")
    if not (st["maxdev"] <= BF16_FUSED_MAXDEV
            and st["snr_db"] >= BF16_FUSED_SNR_DB):
        raise AssertionError(f"bf16 fused against bf16 unfused: {st}")
    return out


def fidelity_readings(state: dict, vcfg, device=None) -> None:
    """scripts/tpu_parity_check.py::vocoder_fidelity's setup: 2 x 96
    codes, int8-static calibrated on a separate 4 x 120 batch at margins
    1.0 and 1.25; maxdev, SNR and log-mel L1 of every bf16 mode and the
    float32 int8 modes against the float32 serve, as readings."""
    from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer

    rng = np.random.default_rng(2)
    code = rng.integers(0, vcfg.num_embeddings, size=(2, 96))
    spk = rng.integers(0, vcfg.num_speakers, size=(2,))
    calib = rng.integers(0, vcfg.num_embeddings, size=(4, 120))
    calib_spk = rng.integers(0, vcfg.num_speakers, size=(4,))

    def wave(margin=1.0, **change):
        synth = VocoderSynthesizer(state, dataclasses.replace(vcfg, **change),
                                   device=device, calib_margin=margin)
        if synth.cfg.quant == "int8-static":
            synth.calibrate(list(calib), list(calib_spk))
        return synth.synthesize(list(code), list(spk))

    w32 = wave()
    for name, margin, change in (
            ("bf16", 1.0, {"dtype": "bfloat16"}),
            ("bf16_fused", 1.0, {"dtype": "bfloat16", "fused_mrf": True}),
            ("bf16_int8_tail", 1.0, {"dtype": "bfloat16",
                                     "quant": "int8-tail"}),
            ("bf16_int8_full", 1.0, {"dtype": "bfloat16", "quant": "int8"}),
            ("bf16_int8_static_m1.0", 1.0, {"dtype": "bfloat16",
                                            "quant": "int8-static"}),
            ("bf16_int8_static_m1.25", 1.25, {"dtype": "bfloat16",
                                              "quant": "int8-static"}),
            ("f32_int8_tail", 1.0, {"quant": "int8-tail"}),
            ("f32_int8_full", 1.0, {"quant": "int8"}),
            ("f32_int8_static_m1.0", 1.0, {"quant": "int8-static"}),
            ("f32_int8_static_m1.25", 1.25, {"quant": "int8-static"})):
        st = wave_stats(wave(margin, **change), w32, device)
        print(f"fidelity reading (2 x 96 codes, V1, seeded weights) {name}: "
              f"{stats_line(st)}")


def bench_readings(state: dict, vcfg, smi: str, device=None) -> dict:
    """bench.py's vocoder batch (64 rows of 250 codes, the 256-code
    bucket) through VocoderSynthesizer in float32 and bf16 in each mode:
    ms per batch (CUDA events around each warm synthesize, host readback
    included; median and spread over BENCH_REPS) and, on the card, the busy
    time of one more batch (phase_profile). Readings."""
    from parrot_tts_tpu_torch.infer.synthesize import VocoderSynthesizer

    rng = np.random.default_rng(0)
    rows, length = BENCH_BATCH
    code = list(rng.integers(0, vcfg.num_embeddings, size=(rows, length)))
    spk = list(rng.integers(0, vcfg.num_speakers, size=(rows,)))
    out = {}
    for dtype in ("float32", "bfloat16"):
        for mode, change in BENCH_MODES.items():
            synth = VocoderSynthesizer(
                state, dataclasses.replace(vcfg, dtype=dtype, **change),
                device=device)
            if synth.cfg.quant == "int8-static":
                synth.calibrate(code, spk)       # bench.py calibrates on it
            serve = (lambda s=synth: s.synthesize(code, spk))
            times = []
            for rep in range(BENCH_REPS + 1):
                times.append(device_seconds(serve) * 1e3)
            times = sorted(times[1:])            # the first one warms up
            med = times[len(times) // 2]
            out[(dtype, mode)] = med
            print(f"bench batch {rows} x {length} codes, {dtype} {mode}: "
                  f"{med:.3f} ms per batch (median of {BENCH_REPS}, "
                  f"{times[0]:.3f}-{times[-1]:.3f}); {smi}")
            if torch.cuda.is_available() and device is None:
                phase_profile(serve, f"{dtype} {mode} batch of {rows} x "
                              f"{length} codes")
            del synth
    return out


def phase_bf16_gan(mcfg, tcfg, mel_cfg, corpus: dict, gan: dict,
                   device=None) -> None:
    """The GAN with a bf16 generator (bench_gan.py --gen-bf16) through
    pipeline/train_vocoder.run for BF16_GAN_STEPS steps on phase 14's
    seeded corpus: finite metrics, all three networks move, parameters and
    moments stay float32, the checkpoint holds the live state; ms per step
    beside phase 14's float32 (TF32) step, and the bf16 step's |dg|/|g|
    against the float32 step's from the same seeded state (readings)."""
    import tempfile

    from parrot_tts_tpu_torch.core.checkpoint import CheckpointManager
    from parrot_tts_tpu_torch.core.config import PipelineConfig
    from parrot_tts_tpu_torch.core.device import resolve_device
    from parrot_tts_tpu_torch.pipeline import train_vocoder
    from parrot_tts_tpu_torch.train import vocoder as voc_train

    dev = resolve_device(device)
    mcfg16 = dataclasses.replace(mcfg, dtype="bfloat16")
    records = []
    real_step = voc_train.train_step

    def step_spy(state, *args, **kwargs):
        nets = (state.gen, state.mpd, state.msd)
        before = [[p.detach().clone() for p in m.parameters()] for m in nets]
        metrics = real_step(state, *args, **kwargs)
        records.append({**{k: float(v) for k, v in metrics.items()},
                        "changed": [any(not torch.equal(a, p) for a, p in
                                        zip(b, m.parameters()))
                                    for b, m in zip(before, nets)],
                        "state": state})
        return metrics

    tcfg2 = dataclasses.replace(tcfg, checkpoint_interval=BF16_GAN_STEPS,
                                validation_interval=BF16_GAN_STEPS)
    with tempfile.TemporaryDirectory(prefix="parrot_gan16_") as tmp:
        data = write_vocoder_corpus(tmp, seed=SEED + 7, **corpus)
        cfg = PipelineConfig(vocoder_model=mcfg16, vocoder_train=tcfg2,
                             mel=mel_cfg)
        with mock.patch.object(voc_train, "train_step", step_spy):
            out = train_vocoder.run(cfg, data_dir=data, run_dir=f"{tmp}/run",
                                    max_steps=BF16_GAN_STEPS, device=device)
        print(f"bf16-generator GAN train: {out}")
        for r in records:
            print(f"  D loss {r['loss_disc_all']:.5f}, G loss "
                  f"{r['loss_gen_all']:.5f}, mel error {r['mel_error']:.5f};"
                  f" G / MPD / MSD moved {r['changed']}")
        if out["steps"] != BF16_GAN_STEPS or len(records) != BF16_GAN_STEPS:
            raise AssertionError(f"bf16 GAN run: {out}")
        if not all(math.isfinite(r[k]) for r in records
                   for k in ("loss_disc_all", "loss_gen_all", "mel_error")):
            raise AssertionError("a non-finite bf16 GAN loss")
        if not all(all(r["changed"]) for r in records):
            raise AssertionError("a bf16 GAN step left a network unchanged")
        state = records[-1]["state"]
        live = state.state_dict()
        if not all(v.dtype == torch.float32
                   for part in ("gen", "mu_g", "nu_g", "mu_d", "nu_d")
                   for v in live[part].values() if v.is_floating_point()):
            raise AssertionError("a bf16-generator parameter or moment is "
                                 "not float32")
        saved = CheckpointManager(f"{tmp}/run/ckpt").restore()
        for part in ("gen", "mpd", "msd", "mu_g", "nu_g", "mu_d", "nu_d"):
            if saved[part].keys() != live[part].keys() or not all(
                    torch.equal(saved[part][k], v.cpu())
                    for k, v in live[part].items()):
                raise AssertionError(f"bf16 GAN checkpoint {part} differs")
        if json.loads(open(f"{tmp}/run/ckpt/config.json").read()).get(
                "dtype") != "bfloat16":
            raise AssertionError("the checkpoint's config.json lost dtype")
        print("bf16 GAN: parameters and moments float32, the checkpoint "
              "(and its config.json's dtype) holds the live state")
        del live, saved, state
        records.clear()

    steps_per_epoch, batch_np = gan["steps_per_epoch"], gan["batch_np"]
    grads = {}
    for cfg_ in (mcfg, mcfg16):
        state = voc_train.init_state(tcfg.seed, cfg_, dev)
        voc_train.train_step(state, voc_train.to_batch(batch_np, dev), cfg_,
                             tcfg, mel_cfg, steps_per_epoch)
        grads[cfg_.dtype] = gan_grads(state)
        del state
    for net in grads["float32"]:
        g32, g16 = grads["float32"][net], grads["bfloat16"][net]
        num = sum(float((g16[k] - v).pow(2).sum()) for k, v in g32.items())
        den = sum(float(v.pow(2).sum()) for v in g32.values())
        print(f"bf16-generator GAN step against the float32 (TF32) step from "
              f"the seeded state: {net} |dg|/|g| {math.sqrt(num / den):.3e}")
    del grads
    if dev.type == "cuda":
        state = voc_train.init_state(tcfg.seed, mcfg16, dev)
        batch = voc_train.to_batch(batch_np, dev)
        ms = cuda_ms(lambda: voc_train.train_step(
            state, batch, mcfg16, tcfg, mel_cfg, steps_per_epoch), GAN_TIMED)
        print(f"bf16-generator GAN reading: {ms:.3f} ms per step over "
              f"{GAN_TIMED} warm steps (CUDA events), phase 14's float32 "
              f"step {gan['ms']:.3f} ms ({ms / gan['ms']:.3f}x)")


def phase_bf16(fm, qc, quant, exact_numerics, tcfg, vcfg, base: dict,
               q8: dict, registers: dict, smi: str, gan: dict, gan_args,
               device=None) -> dict:
    """Phase 19: the bf16 compute modes (module docstring)."""
    from parrot_tts_tpu_torch.core.config import HubertConfig
    from parrot_tts_tpu_torch.models.hubert.model import HubertModel

    v16 = dataclasses.replace(vcfg, dtype="bfloat16")
    batches = vocoder_batches(base["units"])
    fused = make_tts(tcfg, dataclasses.replace(v16, fused_mrf=True), device)
    mrf = phase_bf16_mrf(fm, exact_numerics, fused.vocoder.model, v16,
                         batches, registers)
    del fused
    widths = phase_mrf_widths(fm, exact_numerics)
    narrow_launches = phase_bf16_narrow_serve(fm, tcfg, vcfg, base, device)
    q16 = phase_int8_kernel(qc, v16, batches, modes=("int8", "int8-tail"))
    serves = phase_bf16_serves(fm, qc, tcfg, vcfg, base, mrf["checked"],
                               q8["checked"] | q16["checked"], device)
    same = phase_batch_invariance(quant, device=base["tts"].device.type,
                                  dtype=torch.bfloat16, gate=False)
    synth = serves["bf16"]["tts"].vocoder
    longest = max(base["units"], key=len)
    alone = synth.synthesize([longest], [0])[0]
    rows = synth.synthesize([longest] * 3, [0, 1, 2])[0]
    print(f"bf16 float serve batch-invariant (a request alone and as the "
          f"first of 3 rows of its batch): {np.array_equal(alone, rows)}; "
          f"the dynamic int8 conv in bf16: {same} (readings, not gates)")
    for label in ("bf16", "bf16 int8-static", "bf16 int8"):
        phase_profile(serves[label]["serve"], f"{label} serve")
    state = base["tts"].vocoder.model.state_dict()
    fidelity_readings(state, vcfg, device)
    bench = bench_readings(state, vcfg, smi, device)
    phase_bf16_gan(*gan_args, gan, device=device)
    try:
        HubertModel(HubertConfig(dtype="bfloat16"))
    except ValueError as e:
        print(f"HubertConfig(dtype='bfloat16') refused: {e}")
    else:
        raise AssertionError("HubertConfig(dtype='bfloat16') did not raise")
    return {"mrf": mrf, "int8": q16, "bench": bench, "widths": widths,
            "mrf_launches": serves["bf16 fused"]["launches"][0],
            "narrow_launches": narrow_launches,
            "int8_launches": sum(s["launches"][1] for s in serves.values())}


def spec_pair(train_cfg) -> tuple[int, int]:
    """The smallest bucket pair of a (rehearsal) training config."""
    return train_cfg.src_buckets[0], train_cfg.tgt_buckets[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from parrot_tts_tpu_torch.core import kernels
    from parrot_tts_tpu_torch.core.config import (AlignerTrainConfig,
                                                  HubertConfig, MelConfig,
                                                  TTEModelConfig,
                                                  TTETrainConfig,
                                                  VocoderModelConfig,
                                                  VocoderTrainConfig)
    from parrot_tts_tpu_torch.core.device import exact_numerics
    from parrot_tts_tpu_torch.ops import flash_attention as fa
    from parrot_tts_tpu_torch.ops import flash_dropout as fd
    from parrot_tts_tpu_torch.ops import fused_mrf as fm
    from parrot_tts_tpu_torch.ops import qconv as qc
    from parrot_tts_tpu_torch.ops import quant

    smi = phase_card()
    build = phase_build(kernels)
    kern = phase_kernel(fa, exact_numerics,
                        ptxas_registers(build["flash_attn_fwd"]))
    # full width: d_model 256, 4+4 FFT blocks of 2 heads, V1 vocoder
    tcfg, vcfg = TTEModelConfig(n_speaker=4), VocoderModelConfig()
    base = phase_serving(fa, tcfg, vcfg)
    modes = phase_decode_modes(fa, base, smi)
    row1_launches = base["launches"] + sum(
        n[3] + n[1] for n in modes["launches"].values())
    batches = vocoder_batches(base["units"])
    print("vocoder batches (rows, codes):", batches)
    mrf = phase_mrf_kernel(fm, exact_numerics, base["tts"].vocoder.model,
                           vcfg, batches, ptxas_registers(build["fused_mrf"]))
    mrf_widths = phase_mrf_widths(fm, exact_numerics, torch.float32)
    q8 = phase_int8_kernel(qc, vcfg, batches)
    fused = phase_fused_serve(
        fm, tcfg, dataclasses.replace(vcfg, fused_mrf=True), base,
        mrf["checked"])
    int8 = {mode: phase_int8_serve(
        qc, tcfg, dataclasses.replace(vcfg, quant=mode), base, q8["checked"])
        for mode in INT8_SITES}
    print("int8 conv launches per serve: " + ", ".join(
        f"{mode} {r['launches']}" for mode, r in int8.items())
        + f" (total {sum(r['launches'] for r in int8.values())})")
    phase_batch_invariance(quant)
    phase_profile(base["serve"], "float serve")
    phase_profile(fused["serve"], "fused serve")
    phase_profile(int8["int8-static"]["serve"], "int8-static serve")
    phase_profile(int8["int8"]["serve"], "int8 serve")
    fdk = phase_flash_dropout(fd, ptxas_registers(build["flash_dropout"]))
    # TTETrainConfig() defaults (batch 6, 4 micro-batches per step, the
    # reference's buckets) with an lr that is not 0 at the first update
    train_cfg = TTETrainConfig(warmup_steps=0, log_every=1, val_every=2,
                               save_every=1)
    tr = phase_train(fd, fa, tcfg, train_cfg, TRAIN_PAIRS, fdk["checked"],
                     set(KERNEL_SHAPES))
    phase_train_profile(tr["state"], tr["cfg"], train_cfg, tr["batch"],
                        tr["out_len"])
    gemm = phase_gemm(qc)
    gemm_launches = phase_int8_experiment(qc)
    # the V1 vocoder and VocoderTrainConfig() defaults (batch 16, segments
    # of 8960 samples), logging every step, validation at the last
    gan_corpus = dict(n_train=32, n_val=4, seconds=(1.0, 1.6))
    gan = phase_gan(vcfg, VocoderTrainConfig(summary_interval=1,
                                             validation_interval=GAN_STEPS,
                                             checkpoint_interval=GAN_STEPS),
                    MelConfig(), gan_corpus)
    phase_manifest_io(fa, base["tts"], base["speakers"])
    hubert = phase_hubert(HubertConfig())
    phase_f0(vcfg, VocoderTrainConfig(summary_interval=1,
                                      validation_interval=GAN_F0_STEPS,
                                      checkpoint_interval=GAN_F0_STEPS),
             MelConfig(), dict(n_train=32, n_val=4, seconds=(1.0, 1.6)),
             base["units"], base["speakers"], hubert["wavs"])
    phase_aligner(hubert, AlignerTrainConfig())
    mesh = phase_mesh(
        fa, fd, base, tcfg, vcfg, smi,
        train_cfg=TTETrainConfig(warmup_steps=0, grad_acc_steps=2),
        gan=(vcfg, VocoderTrainConfig(), MelConfig()))
    b16 = phase_bf16(fm, qc, quant, exact_numerics, tcfg, vcfg, base, q8,
                     ptxas_registers(build["fused_mrf"]), smi, gan,
                     (vcfg, VocoderTrainConfig(summary_interval=1), MelConfig(),
                      gan_corpus))
    rep16, q16 = b16["mrf"]["report"], b16["int8"]["serves"]
    print(f"row 6 bf16 per fused serve ({b16['mrf_launches']} launches): "
          f"kernel {rep16['ms']:.4f} ms, plain {rep16['plain_ms']:.4f} ms, "
          f"cuDNN bf16 composition {rep16['library_ms']:.4f} ms, bound "
          f"{rep16['bound_ms']:.4f} ms ({rep16['bound_by']}); row 7 bf16 "
          "output per serve: " + ", ".join(
              f"{m} kernel {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, cuDNN bf16 {r['library_ms']:.4f})"
              for m, r in q16.items()) + f"; {smi}")
    rep, large = kern["report"], kern["large"]
    one, one_large = rep["one_pass"], large["one_pass"]
    print(f"row 1 at {REPORT_SHAPE} (B, T, d), H=2: 3xTF32 {rep['ms']:.4f} ms"
          f" = pre-pass {rep['prep']['ms']:.4f} + kernel "
          f"{rep['kernel_ms']:.4f} (bound {rep['bound_ms']:.4f}), 1-pass "
          f"{one['ms']:.4f} ms = pre-pass {one['prep']['ms']:.4f} + kernel "
          f"{one['kernel_ms']:.4f} (bound {one['bound_ms']:.4f}, "
          f"{one['bound_by']}; max |diff| {one['max_abs_err']:.3e} against "
          f"its plain version, {one['ieee_err']:.3e} from IEEE), sdpa "
          f"float32 {rep['library_ms']:.4f} ms, sdpa TF32 "
          f"{one['library_ms']:.4f} ms; at {ONE_PASS_LARGE}: 3xTF32 "
          f"{large['ms']:.4f} ms = pre-pass {large['prep']['ms']:.4f} + "
          f"kernel {large['kernel_ms']:.4f} (bound {large['bound_ms']:.4f}),"
          f" sdpa float32 {large['library_ms']:.4f} ms; 1-pass "
          f"{one_large['ms']:.4f} ms = pre-pass {one_large['prep']['ms']:.4f}"
          f" + kernel {one_large['kernel_ms']:.4f} (bound "
          f"{one_large['bound_ms']:.4f}), sdpa TF32 "
          f"{one_large['library_ms']:.4f} ms; {smi}")
    row1_launches += mesh["flash_attn_fwd"]
    one_pass_launches = sum(n[1] for n in modes["launches"].values())
    prep_launches = sum(n["prep"] for n in modes["launches"].values())
    split_launches = (base["split"] + mesh["flash_attn_split"] + sum(
        n["split"] for n in modes["launches"].values()))
    if split_launches != row1_launches - one_pass_launches:
        raise AssertionError(f"{split_launches} 3xTF32 pre-pass launches for "
                             f"{row1_launches - one_pass_launches} 3xTF32 "
                             "attention launches")
    print(f"row 1 launches: {row1_launches} (the default serve "
          f"{base['launches']}, 3xTF32; the decode modes " + ", ".join(
              f"{m!r} {n[3]} 3xTF32 (pre-pass {n['split']}) + {n[1]} 1-pass "
              f"(pre-pass {n['prep']})" for m, n in modes["launches"].items())
          + f"; phase 18 {mesh['flash_attn_fwd']})")
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "parrot_tts_tpu/ops/attention.py:153",
        "launches": row1_launches - one_pass_launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": rep["kernel_ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
    }, {
        "name": "flash_attn_split",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "parrot_tts_tpu/ops/attention.py:153",
        "launches": split_launches,
        **rep["prep"],
        "library_ms": None,
    }, {
        "name": "flash_attn_1pass",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "parrot_tts_tpu/ops/attention.py:153",
        "launches": one_pass_launches,
        "max_abs_err": kern["one_pass_max_abs_err"],
        "ms": one["kernel_ms"],
        "plain_ms": one["plain_ms"],
        "bound_ms": one["bound_ms"],
        "bound_by": one["bound_by"],
        "library_ms": one["library_ms"],
    }, {
        "name": "flash_attn_prep",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "parrot_tts_tpu/ops/attention.py:153",
        "launches": prep_launches,
        **one["prep"],
        "library_ms": None,
    }, {
        "name": "fused_mrf",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/fused_mrf.cu",
        "replaces": "parrot_tts_tpu/ops/fused_mrf.py:115",
        "launches": (fused["launches"] + b16["mrf_launches"]
                     + b16["narrow_launches"]),
        "max_abs_err": max(mrf["max_abs_err"], b16["mrf"]["max_abs_err"],
                           *(r["max_abs_err"] for r in mrf_widths)),
        **{k: mrf["report"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/int8_conv.cu",
        "replaces": "parrot_tts_tpu/ops/pallas_qconv.py:42",
        "launches": (sum(r["launches"] for r in int8.values())
                     + b16["int8_launches"]),
        "max_abs_err": max(q8["max_abs_err"], b16["int8"]["max_abs_err"]),
        **{k: q8["report"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "library_ms": None,
    }, {
        "name": "int8_gemm",
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/int8_gemm.cu",
        "replaces": "parrot_tts_tpu/ops/pallas_qconv.py:162",
        "launches": gemm_launches,
        "max_abs_err": gemm["max_abs_err"],
        **gemm["report"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "parrot_tts_tpu_torch/csrc/flash_dropout.cu",
        "replaces": f"parrot_tts_tpu/ops/flash_dropout.py:{line}",
        "launches": tr["launches"][key] + mesh.get(key, 0),
        "max_abs_err": fdk["max_abs_err"].get(key, 0.0),
        **fdk["report"][key],
    } for name, key, line in (("flash_dropout_fwd", "fwd", 87),
                              ("flash_dropout_dq", "dq", 173),
                              ("flash_dropout_dkv", "dkv", 207),
                              ("keep_mask", "keep_mask", 362))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
