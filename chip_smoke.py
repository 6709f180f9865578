#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demodulator_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. device: the card's name and power limit; fails without CUDA;
2. build: nvcc builds csrc/*.cu into demodulator_tpu_torch/_build/;
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes:
   - NBFM (16 blocks of 256 KiB), > 110 dB on an FM tone capture (SNR and
     max error also printed on noise), the precise K1 and K3 equal to their
     plain versions on the tone and on noise: fused_nbfm (K1) precise/fast
     x shift/normalize x Butterworth/Chebyshev taps; fused_nbfm_cplx (K3)
     with one -L stage and one -q 2 stage x shift/normalize x precise/fast,
     and with both stages precise/fast; K1 and K3 (two stages) precise,
     equal, on rows of 4·(4k + 3) bytes starting 4 bytes past a 16-byte
     boundary, with the CLI's taps and with 32; fused_nbfm_q1 (K4) and
     fused_nbfm_q1_seq (K5) precise/fast, their entering and final offsets
     within 1e-3, K5 also against K4; dma_floor (K2) exactly;
   - the NBFM float64 patches: P3 patch_cplx1 after K3's one stage and P4
     patch_cplx2 after its two on their kernel's output, precise and fast,
     each path's conditionings, at 16 and 2 blocks, on the tone and on
     noise: equal to their plain versions, or, where a float64 dot sums in
     another order than cuBLAS's, within 2 float32 ULP and > 140 dB (the
     reason printed); then every path as the model launches it
     (``fused_call``: K1 with its head rows, P1, in the same launch (q0,
     q3, Chebyshev -m 1 -d 8); K4 with P2's (-q 1); K3, then P3 or P4 as
     its programmatic dependent, nothing between) at 2, 16 and 256 blocks,
     tone and noise, precise and fast, at that bar against the kernel
     alone (a second launch; K4: its own output) with the patch's plain
     version over it, every row compared, and that step captured as a
     CUDA graph and replayed 50 times, each replay equal to the eager
     step (K4, whose look-back order varies: each replay at the bar
     against P2's plain version over it, > 110 dB from the eager step);
   - fused_pfb (K6) for every C of tests/test_torch_cuda.py (2 to 256,
     radix and direct FFT factors, the primes 17 and 251 on the direct
     DFT) and, on its three-factor route, C = 257, 384, 512, 1000, 1024,
     2048 and 4096 at 6.25 kHz channels (1.6 to 25.6 Msps; 384, 512, 1024,
     2048 and 4096 on the compiled-in plans), on two streamed
     0.25 s blocks of an on-grid FM bank capture and of noise (C = 4 also
     on one 10-block bank4 chunk), and on its four-step route at C = 4800,
     8192 and 8198 (30, 51.2 and 51.24 Msps; 4800 and 8192 one launch of
     the cluster kernel, 8198 = 2·4099 the two-pass route, pass 2 a direct
     sum) on two streamed 0.05 s blocks: its launches a call (two on the
     two-pass route), angle-wrapped error < 0.01 rad,
     > 80 dB, the carried history bit-equal;
4. the main paths through their entry point, each in its own process, so
   its launch counts start at 0 (PHASES line), each with its full chunks
   replayed as a CUDA graph (PHASES ``graph`` true):
   - ``python -m demodulator_tpu_torch -i cap.iq -o out.raw -S 96000 -l
     12500`` on a 256 MiB capture (1024 blocks + a 100-byte tail, made on
     the card),
     precise and with --fast-atan2, then precise with each of -L 12500,
     -q 2, -q 2 -L 12500 and -q 1, and -q 2 -L 12500 with --fast-atan2.
     Each run is checked for its output length, > 110 dB against the
     --device cpu plain path on the first and last 32 blocks (-q 1: the
     plain path starts a block earlier, so the carried offset is in
     place), > 60 dB against the numpy golden model on the first 2
     blocks, and 64 launches of its mode's kernel (and, after K3, 64 of
     its path's patch kernel);
   - the channel bank, ``--bank`` with 64 channels at 12.288 Msps (bank64:
     0.25 s blocks, a 256 MiB capture with FM carriers on 8 channels) and
     4 channels at 768 ksps (bank4: 10 blocks per call, a 64 MiB capture,
     a carrier on each).  Each run is checked for fused_pfb launches, the
     length and finiteness of every channel file, and against the --device
     cpu plain pipeline (built with the run's block geometry) on the first
     and last 2 blocks: carrier channels > 80 dB and within 1e-4;
     every channel's discriminator output, recovered from the audio
     through the causal FIR, within 0.01 rad angle-wrapped and > 80 dB
     (noise channels flip at +-pi on a last-ulp difference; that is the
     bar of tests/test_fused_pfb.py); bank64's carrier tones within 15 Hz;
     and bank512, K6's three-factor route: ``--bank`` with 16 channels of
     the 512 of ``--iq-rate 3200000 --channel-rate 6250`` (-l 2500, one
     0.25 s block a call) on a 64 MiB capture with FM carriers of 1 kHz
     deviation on 4 of them: one fused_pfb launch a block, its first 8
     blocks against the --device cpu pipeline at those bars, its carrier
     tones within 15 Hz; and bank8192, K6's four-step route: 16 channels
     of the 8192 of 51.2 Msps at 6.25 kHz on a 160 MiB capture (6 blocks
     of 0.25 s, carriers on 4), captured: 1 launch a block (the cluster
     kernel over the block's 781 frame pairs), the first 2 blocks
     against the --device cpu pipeline at those bars, the carrier tones
     within 15 Hz (phase 4f runs it captured and eager, each traced);
4c. the port's other NBFM options through the same CLI on the same 256 MiB
   capture (256 KiB blocks, 16 per call), each run's PHASES and
   Msamples/s printed with the card's name and power limit:
   - ``--precision float64``: 1024 blocks of float64, > 200 dB against the
     --device cpu float64 path on the first and last 32 blocks, > 60 dB
     against the float64 golden model on the first 2, no kernel launch;
   - ``--profile continuous``, precise and with -q 1: the tail padded to a
     1025th block, > 110 dB against the --device cpu continuous stream fed
     those 32 blocks and the next block as halo (zero at EOF; under -q 1 a
     block earlier), no kernel launch, the full chunks replayed as a CUDA
     graph (PHASES ``graph`` true, ``graph_s``);
   - ``--checkpoint ck --checkpoint-every 64`` on the first 512 blocks (80
     of bank4's 174), then ``--resume`` on the whole capture, for q0 (K1),
     -q 1 (K4) and bank4 (K6): the joined output equal to phase 4's run
     byte for byte (q0, bank4) or > 110 dB with the saved offsets within
     1e-3 of the plain tracker's (-q 1, whose look-back order depends on
     timing); each run reports its kernel's launches;
   - ``--metrics --trace`` on the default run: its metrics JSON line
     counts 1024 blocks; the device's busy and idle share of the traced
     run, its longest idle gaps and the first chunk's split; the trace's
     kernel events of each kernel equal to its PHASES launches (the
     replays' counts, measured on the device);
4e. the parallel layer on this card (run after 4c, while phase 4's capture
   and outputs are on disk; one card shows no scaling, so the runs show
   that the sharded paths launch their kernels and agree with the
   unsharded ones), each run's PHASES, Msamples/s, launches and backend:
   - in this process, ``ShardedStreamProcessor`` (2 blocks a position,
     the CLI's --shard-time) on a (1, 1) mesh precise (K1) and ``-q 2 -L
     12500`` (K3), equal to phase 4's runs byte for byte, ``-q 1`` (K4)
     and ``--profile continuous`` (no kernel) > 110 dB against phase 4's
     and 4c's runs, and on a (4, 1) mesh of the card ``-q 1`` and
     continuous, > 110 dB; each mode twice, its full chunks replayed (a
     CUDA graph a segment a position: two under compat -q 1, and in the
     continuous profile one between each two exchanges, the last time
     position one) and eager (DEMODULATOR_TPU_TORCH_GRAPHS=0), the two
     byte-equal (-q 1 > 110 dB) with equal launches; each run again under
     torch.profiler on the
     capture's first 128 blocks, its kernel events equal to its launches,
     per mesh position for the replays (each graph launch's kernels, by
     the trace's correlation ids); a ``SHARDED {json}`` line per mode
     (graph_s, stream_s, run_s, the median ``step`` span, launches, both
     ways) and ``CHUNKS`` lines of the (1, 1) ``-q 1`` traced runs (the
     steady chunks' host time by operation);
   - two CLI processes on the card, ``--shard-time 2 --distributed`` (the
     ranks share the card, so gloo): precise byte-equal, ``-q 1`` > 110
     dB, and precise with ``--shared-out`` byte-equal;
   - ``--bank --shard-chan 1`` on bank64 (K6), every channel equal to
     phase 4b's run; mixer8 (16 MiB) and a 4-station WBFM bank (4 x 16
     MiB) on a (1, 2) mesh of the card, captured and eager (byte-equal,
     a ``SHARDED`` line each), against the same bank unsharded on the
     card, at the bank bars and > 110 dB;
4d. WBFM and the mixer bank through the same CLI (no kernel: torch ops and
   float32 ``torch.matmul``; 0 launches), each run's PHASES and
   Msamples/s printed with the card's name and power limit:
   - ``--wbfm`` with the defaults (1.0 s blocks, quad 480 kHz, L/M 1/5 then
     1/5) on a 256 MiB broadcast-FM capture at 2.4 Msps (75 kHz deviation,
     tones 1 and 3 kHz, pre-emphasised, 27 blocks), and ``--iq-rate
     2048000`` (L/M 1/7 then 21/64) on 64 MiB (16 blocks): the output
     length, finite values, > 110 dB against the --device cpu receiver on
     the first and last 4 blocks (it starts a block earlier, so its state
     is the run's; the bar also detects TF32), the tone within 15 Hz;
   - ``--wbfm`` ``--checkpoint`` on the first half of the 2.4 Msps
     capture, then ``--resume``: the joined output equal to the
     uninterrupted run byte for byte; ``--wbfm --trace``: the device's
     idle share and the first block's split, no kernel event of the
     port's kernels;
   - ``--wbfm --inputs`` with 4 stations of 64 MiB: each station file
     > 110 dB against that station run alone on the card (through the
     API, in this process);
   - ``mixer8``: ``--bank`` with the 8 half-channel offsets (c - 4 + 0.5)·
     192 kHz at 1.536 Msps (the JAX bench row channel_bank_8ch), 0.25 s
     blocks, 64 MiB with FM carriers on 4 channels: against the --device
     cpu pipeline (the phasor of the span's first block) at the bank bars
     of phase 4, and the final phasor (from the run's checkpoint) within
     1e-5 of the CPU recurrence's;
4f. the warm start, in this process through the API: each
   mode whose full chunks replay a CUDA graph (precise, --fast-atan2, -L,
   -q 2, -q 2 -L, -q 1, -q 1 -L, float64, and the continuous profile
   precise and with -q 1 (1025 blocks, its tail padded) on phase 4's
   capture; bank64,
   bank4, mixer8, bank8192, wbfm and the 4-station bank on the captures
   of phases 4b and 4d) run three ways: replayed, eager
   (DEMODULATOR_TPU_TORCH_GRAPHS=0), and replayed under torch.profiler,
   bank8192 also eagerly under it; the outputs equal byte for byte (-q
   1: > 110 dB, K4's look-back order depends on timing), the launch
   counts equal and exact (64 an NBFM run, and 64 of its patch kernel
   after K3, 43 bank64, 18 bank4, 6 bank8192, 0 elsewhere), and each
   traced run's
   kernel events of each kernel equal to its counts (traced again, at
   most 3 times, while they fall short: the profiler can lose records);
   a ``GRAPHS {json}`` line per mode with the two untraced runs' build_s,
   graph_s, first_output_s, stream_s, run_s, wall_s and launches, and
   the card;
   for precise also the CLI, a new process each run, in turns eager,
   graph, graph, eager (their PHASES under ``cli <turn> eager|graph``,
   each output equal to the graph run's): the cold comparison;
5. timings with CUDA events (median of 20 runs after warm-up; 5 runs of
   one call for a call slower than 5 ms) beside the
   plain versions, and each kernel's device time from torch.profiler,
   with GB/s against dma_floor's and the least time the card could take
   (bound): NBFM kernels at 16 and 256 blocks (K5 beside K4; K4 held to
   one kernel launch per call), and K1, K3 and K4 at a time shard's 2
   blocks, each first held against its plain version there as in phase
   3; fused_pfb at
   C = 64 on one bank64 block and at C = 4 on one bank4 chunk, with its FFT
   plan, and above 256 channels on one 0.25 s block of 6.25 kHz channels:
   the compiled-in plans at C = 384, 512, 1024, 2048 and 4096,
   pfb_big_kernel at 320, 400, 480, 1600 and 3200, the four-step route at
   4800, 6144, 8192, 8198 and 16384 (the cluster kernel but at 8198; a
   ``PFB_WIDE {json}`` line: each C's kernel or kernels, its registers,
   local memory (stack and spills), shared memory and CTAs an SM, a
   cluster plan's CTAs a cluster and the clusters the card holds, and
   ``torch.fft.fft``'s time on the
   block's frames in complex128, the FFT part alone as a yardstick); the
   bank's audio FIR; K1 and K4 with their head rows (P1, P2)
   and the patch kernels P3, P4 at 16, 256 and 2 blocks beside their
   plain versions, with their bounds (the kernel's and the patch's work
   from the geometry, ``nbfm_patch.patch_work``); K2's library call, one
   ``sum(-1, dtype=torch.float32)`` over its [B, rows, 128, 4] bytes;
5b. P3 and P4 alone and overlapped with K3 (-L, -q 2, -q 2 -L, precise
   and fast, 16 and 256 blocks): in CUDA graphs of 20 calls, K3 alone,
   the step (K3 then the patch) and the patch alone, the step less K3;
   the patch's device time alone and in a replayed step (its wait for K3
   included); the launch floor, a one-element fill in a graph;
6. the tools (``demodulator_tpu_torch/tools/``) in this process:
   ``validate_pfb_hw`` at C = 4, 8, 16, 32, 64 (K6 against its plain
   front on two streamed blocks, held to phase 3's bars, and its time
   from a CUDA graph of 50 calls); ``bench_scaling --e2e --diagnose
   --repeats 2`` with its captured step (``graph`` true) and under
   DEMODULATOR_TPU_TORCH_GRAPHS=0 (eager, ``graph`` false) beside it (one
   line per visible device count, every field present; one card gives
   the d = 1 line, efficiency 1.0); and
   ``bench_regression --configs nbfm,bank4,wbfm --repeats 1 --warmup 0
   --blocks 20`` (three CLI processes, each certified and replayed as a
   CUDA graph; 20 blocks give wbfm one 1.0 s block);
7. the benchmark, ``python -m demodulator_tpu_torch.bench --matrix`` in its
   own process: rc 0, its 14 matrix rows and 3 end-to-end rows each
   ``correct`` (its kernel held to its plain version at the row's shape,
   its first step to the plain chain's, one replay of its timed graph to
   the same steps run eagerly), with a positive value, and, timed on the
   card, an ``achieved_frac`` at most 1.05 (the end-to-end rows are timed
   by the host clock and have none), printed as ``BENCH {json}`` lines,
   then its headline.
   The K3 rows' step less K3 alone (phase 5b's, B = 256, fast): one
   ``K3_ROWS {json}`` line.

The line before the last is a JSON object with the kernels' launches
(and ``sharded_launches``, phase 4e's run of the same mode, and
``at_shard_shape``, phase 5's numbers at 2 blocks a call), errors, times
and bounds, K1-K6 (K6 as bank64, bank4, bank512 and, on its four-step
route, bank8192; K2 runs on no path
of the CLI: its launches are
phase 7's memory-floor row's, ``on_main_path`` false), K1 and K4 with
their head rows (P1, P2; ``part_of`` names the kernel, ``replaces`` the
JAX XLA code of the head patch) and the patch kernels P3, P4 (no TPU
kernel: ``replaces`` names the JAX XLA code; also ``k3_step``, phase 5b's
numbers, and ``launch_floor``); the
last line is ``{"ok": true, "device":
{...}}``.  Imports only the port, torch and numpy.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from demodulator_tpu_torch.config import config_from_cli_opts
from demodulator_tpu_torch.models.channel_bank import (ChannelBankConfig,
                                                       ChannelBankPipeline)
from demodulator_tpu_torch.models.nbfm import BlockPipeline
from demodulator_tpu_torch.models.wbfm import WbfmConfig, WbfmPipeline
from demodulator_tpu_torch.ops.channelizer import PolyphaseChannelizer
from demodulator_tpu_torch.ops.conditioning import split_iq
from demodulator_tpu_torch.ops.cuda import build
from demodulator_tpu_torch.ops.cuda.fused_nbfm import (
    dma_floor, dma_floor_ref, fused_nbfm, fused_nbfm_cplx,
    fused_nbfm_cplx_ref, fused_nbfm_q1, fused_nbfm_q1_ref, fused_nbfm_q1_seq,
    fused_nbfm_q1_seq_ref, fused_nbfm_ref)
from demodulator_tpu_torch.ops.cuda.fused_pfb import (
    CLUSTER_PLANS, MAX_CTA_CHANNELS, WIDE_PLANS, WIDE_TAPS, fft_plan,
    four_step_plan, on_cluster,
    four_step_tiles, fused_pfb_demod, fused_pfb_demod_ref, group_pairs,
    launches_per_call,
    kernel_attrs)
from demodulator_tpu_torch.ops.cuda.nbfm_patch import (
    patch_cplx1, patch_cplx1_ref, patch_cplx2, patch_cplx2_ref,
    patch_fused_ref, patch_q1_ref, patch_work)
from demodulator_tpu_torch.oracle.pipeline import OraclePipeline
from demodulator_tpu_torch.parallel.mesh import make_demod_mesh
from demodulator_tpu_torch.runtime.stream import (BankStreamProcessor,
                                                  ShardedStreamProcessor,
                                                  StreamProcessor,
                                                  WbfmStreamProcessor)
from demodulator_tpu_torch.tools.bars import (BAR_ANGLE, BAR_BANK_DB,
                                              BAR_KERNEL_DB, BAR_OFFSET,
                                              wrapped)
from demodulator_tpu_torch.tools.roofline import (CORRECT_IQ_OPS, PEAK_BYTES,
                                                  PEAK_FP32, bound, demod_ops,
                                                  pfb_ops, stage_ops)

REPO = Path(__file__).resolve().parent
FS = 96000.0
BB = 262144              # bytes per block (config.DEFAULT_BUF_SIZE)
NB = 16                  # blocks per device call on the main path
SHARD_BLOCKS = 2         # blocks per call of a time shard (--shard-time)
TRACE_BLOCKS = 128       # phase 4e's traced sharded runs
CAPTURE_BLOCKS = 1024    # 256 MiB
TAIL_BYTES = 100
CLI_ARGS = ["-S", "96000", "-l", "12500"]
BAR_ORACLE_DB = 60.0     # acceptance bar (BASELINE.md)
CSRC = "demodulator_tpu_torch/csrc/"
PALLAS = "demodulator_tpu/ops/pallas/fused_nbfm.py:"
JMODEL = "demodulator_tpu/models/nbfm.py:"
# kernel -> (source, the TPU kernel it replaces)
SOURCES = {"fused_nbfm": (CSRC + "fused_nbfm.cu", PALLAS + "214"),
           "dma_floor": (CSRC + "fused_nbfm.cu", PALLAS + "304"),
           "fused_nbfm_cplx": (CSRC + "fused_nbfm_cplx.cu", PALLAS + "253"),
           "fused_nbfm_q1": (CSRC + "fused_nbfm_q1.cu", PALLAS + "644"),
           "fused_nbfm_q1_seq": (CSRC + "fused_nbfm_q1.cu", PALLAS + "739"),
           "fused_pfb": (CSRC + "fused_pfb.cu",
                         "demodulator_tpu/ops/pallas/fused_pfb.py:196"),
           # K6 on a cluster plan (bank8192's C = 8192)
           "fused_pfb[bank8192]": (CSRC + "fused_pfb_cluster.cu",
                                   "demodulator_tpu/ops/pallas/fused_pfb.py"
                                   ":196"),
           # no TPU kernel: the JAX XLA code each patch replaces (K1 and
           # K4 compute P1's and P2's rows in their launch)
           "fused_nbfm+head": (CSRC + "fused_nbfm.cu", JMODEL + "159-168"),
           "fused_nbfm_q1+head": (CSRC + "fused_nbfm_q1.cu",
                                  JMODEL + "215-246"),
           "patch_cplx1": (CSRC + "nbfm_patch.cu", JMODEL + "288"),
           "patch_cplx2": (CSRC + "nbfm_patch.cu", JMODEL + "385")}
CR = 192000.0            # channel rate of both bank runs
BAR_BANK_ATOL = 1e-4     # tests/test_fused_pfb.py:107
# K6's channel counts in phase 3: tests/test_torch_cuda.py
# test_pfb_kernel_matches_ref; up to 256 at CR, the three-factor route's
# (C > 256) at 6.25 kHz channels (NXDN, dPMR): 1.6 Msps (257), 2.4 (384),
# 3.2 (512), 6.25 (1000), 6.4 (1024), 12.8 (2048) and 25.6 Msps (4096);
# the four-step route's (C > 4096): 30 Msps (4800), 51.2 (8192) and 8198 =
# 2·4099 (pass 2 a direct sum), on blocks of PFB_STEP_SECONDS
PFB_CHANNELS = (2, 3, 4, 5, 8, 12, 16, 17, 32, 48, 64, 128, 251, 256)
NARROW_CR = 6250.0
PFB_WIDE_CHANNELS = (257, 384, 512, 1000, 1024, 2048, 4096, 4800, 8192,
                     8198)
PFB_STEP_SECONDS = 0.05
# phase 5's K6 timings above 256 channels, a 0.25 s block each: the
# compiled-in plans, pfb_big_kernel at the off-plan grids of 2, 2.5, 3, 10
# and 20 Msps (320, 400, 480, 1600, 3200), the four-step route
PFB_WIDE_TIMED = (320, 384, 400, 480, 512, 1024, 1600, 2048, 3200, 4096,
                  4800, 6144, 8192, 8198, 16384)
# bank CLI runs of phase 4: name -> (channels, capture bytes, carrier
# channels (indices into the --bank list), blocks per call)
BANK_RUNS = {"bank64": (64, 256 << 20, (4, 12, 20, 28, 35, 43, 51, 59), 1),
             "bank4": (4, 64 << 20, (0, 1, 2, 3), 10)}
# phase 4b's run of K6's three-factor route: 3.2 Msps split into 6.25 kHz
# channels (C = 512), 16 of them listed in --bank, FM carriers of 1 kHz
# deviation on 4 (indices into the list), one block a call; its first 8
# blocks held to the --device cpu pipeline
NARROW_RUN = ("bank512", 512, 16, 64 << 20, (1, 5, 9, 14))
NARROW_DEV_HZ, NARROW_LOWPASS, NARROW_CHECKED = 1000.0, "2500", 8
# phase 4b's run of K6's four-step route: 51.2 Msps split into 6.25 kHz
# channels (C = 8192), 16 listed, carriers on 4, one block a call; its
# first STEP_CHECKED blocks held to the --device cpu pipeline; phase 4f
# runs it again captured and eager, each traced
STEP_RUN = ("bank8192", 8192, 16, 160 << 20, (2, 6, 9, 13))
STEP_CHECKED = 2
# phase 4d: WBFM runs -> (iq rate, capture bytes); the station bank; the
# mixer bank (channels, capture bytes, carrier channels)
WBFM_RUNS = {"wbfm": (2.4e6, 256 << 20), "wbfm2048": (2.048e6, 64 << 20)}
WBFM_STATIONS, WBFM_STATION_BYTES = 4, 64 << 20
WBFM_DEV, WBFM_TAU = 75000.0, 75e-6
BAR_WBFM_DB = 110.0      # against --device cpu; also the TF32 detector
MIXER_RUN = (8, 64 << 20, (1, 3, 4, 6))
BAR_PHASOR = 1e-5
# phase-4 runs whose outputs phase 4c's resumed runs must reproduce
# (and phase 4e's --shard-time runs)
KEEP_RUNS = {"precise": "q0", "-q 1": "q1", "-q 2 -L": "q2L"}
RESUME_BLOCKS = {"q0": 512, "q1": 512, "bank4": 80}   # the first run's
BAR_F64_DB = 200.0       # float64 against float64 (tests/test_precision.py)
# kernels JSON entry -> phase 4e's run of its mode (the launches key)
SHARDED_RUNS = {"fused_nbfm": ("fused_nbfm", "q0"),
                "fused_nbfm_cplx[-q 2 -L]": ("fused_nbfm_cplx", "q2L"),
                "fused_nbfm_q1": ("fused_nbfm_q1", "q1"),
                "fused_pfb[bank64]": ("fused_pfb", "bank64"),
                "fused_nbfm+head": ("fused_nbfm", "q0"),
                "patch_cplx2[-q 2 -L]": ("patch_cplx2", "q2L"),
                "fused_nbfm_q1+head": ("fused_nbfm_q1", "q1")}
# phase 4e's sharded streams in this process: name -> (mesh shape on the
# card, CLI options, the kernel whose launches it counts or None, the
# phase-4 (4c) run it is held to, byte-equal to it); each captured (the
# continuous profile's segments too) and eager
SHARDED_API = {
    "(1, 1) precise": ((1, 1), [], "fused_nbfm", "q0", True),
    "(1, 1) -q 2 -L": ((1, 1), ["-q", "2", "-L", "12500"],
                       "fused_nbfm_cplx", "q2L", True),
    "(1, 1) -q 1": ((1, 1), ["-q", "1"], "fused_nbfm_q1", "q1", False),
    "(1, 1) continuous": ((1, 1), ["--profile", "continuous"], None,
                          "cont", False),
    "(4, 1) -q 1": ((4, 1), ["-q", "1"], "fused_nbfm_q1", "q1", False),
    "(4, 1) continuous": ((4, 1), ["--profile", "continuous"], None,
                          "cont", False),
}
# phase 4e's run -> the patch kernel launched beside its kernel, once each
# (q0 and -q 1: none, K1 and K4 compute their head rows)
SHARDED_PATCH = {"q2L": "patch_cplx2"}
# a kernel wrapper's name -> its key in kernel_events and PHASES
PATCHES = ("patch_cplx1", "patch_cplx2")
PATCH_FNS = (patch_cplx1, patch_cplx2)
BAR_PATCH_DB = 140.0     # a patch whose float64 dot differs from cuBLAS's
BAR_PATCH_ULP = 2
PATCH_REPLAYS = 50       # graph replays of K3 + P3 / P4, each compared
# phase 3's patch cases: name -> (CLI options, conditioning label); each
# precise and fast.  K1 and K4 with their head rows (P1, P2), P3 and P4
# after K3
PATCH_CASES = {
    "fused_nbfm+head q0": ([], "shift"),
    "fused_nbfm+head q3": (["-q", "3"], "normalize"),
    "fused_nbfm+head chebyshev -m 1 -d 8": (["-m", "1", "-d", "8"], "shift"),
    "fused_nbfm_q1+head": (["-q", "1"], "shift"),
    "patch_cplx1 -L": (["-L", "12500"], "shift"),
    "patch_cplx1 -L -q 3": (["-L", "12500", "-q", "3"], "normalize"),
    "patch_cplx1 -q 2": (["-q", "2"], "shift"),
    "patch_cplx2 -q 2 -L": (["-q", "2", "-L", "12500"], "shift"),
}
COUNTER_KEYS = {"fused_nbfm": "fused_nbfm_launches",
                "fused_nbfm_cplx": "fused_nbfm_cplx_launches",
                "fused_nbfm_q1": "fused_nbfm_q1_launches",
                "fused_pfb_demod": "fused_pfb_launches",
                **{p: f"{p}_launches" for p in PATCHES}}
# CLI runs of phase 4: name -> (extra options, the kernel the mode runs,
# its path's patch kernel after K3 or None: K1 and K4 compute their head
# rows in their launch)
CLI_RUNS = {
    "precise": ([], "fused_nbfm", None),
    "fast": (["--fast-atan2"], "fused_nbfm", None),
    "-L": (["-L", "12500"], "fused_nbfm_cplx", "patch_cplx1"),
    "-q 2": (["-q", "2"], "fused_nbfm_cplx", "patch_cplx1"),
    "-q 2 -L": (["-q", "2", "-L", "12500"], "fused_nbfm_cplx",
                "patch_cplx2"),
    "-q 1": (["-q", "1"], "fused_nbfm_q1", None),
    "-q 2 -L fast": (["-q", "2", "-L", "12500", "--fast-atan2"],
                     "fused_nbfm_cplx", "patch_cplx2"),
}


T0 = time.perf_counter()


def say(*a):
    """Print a line; a phase's heading also gets the seconds since start."""
    if a and str(a[0]).startswith("== "):
        a = (*a, f"[t = {time.perf_counter() - T0:.0f} s]")
    print(*a, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    ref = ref.astype(np.float64).ravel()
    err = ref - test.astype(np.float64).ravel()
    e = float(np.mean(err ** 2))
    return math.inf if e == 0 else 10 * math.log10(float(np.mean(ref ** 2)) / e)


def tone_iq(n_bytes: int, start: int, rng) -> np.ndarray:
    """uint8 IQ of a 1 kHz FM tone at 2.5 kHz deviation plus noise, built
    like tests/conftest.py ``iq_data``; ``start`` is the first complex
    sample's index, so consecutive pieces join without a phase jump."""
    t = (start + np.arange(n_bytes // 2)) / FS
    phase = 2.5 * (1.0 - np.cos(2 * np.pi * 1000.0 * t))
    iq = np.exp(1j * phase) * 80
    iq += (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t))) * 4
    out = np.empty(n_bytes, dtype=np.uint8)
    out[0::2] = np.clip(np.round(iq.real + 127.4), 0, 255)
    out[1::2] = np.clip(np.round(iq.imag + 127.4), 0, 255)
    return out


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def taps_of(opts: dict) -> np.ndarray:
    cfg = config_from_cli_opts(opts)
    return BlockPipeline(cfg, device="cpu").out_fir.host_taps


def pipe_of(extra: list) -> BlockPipeline:
    """The pipeline of ``CLI_ARGS + extra`` (no long options)."""
    args = CLI_ARGS + [a for a in extra if not a.startswith("--")]
    return BlockPipeline(config_from_cli_opts(
        {args[i][1]: args[i + 1] for i in range(0, len(args), 2)}),
        device="cpu")


def compare(label: str, pieces: dict, kernel, plain,
            exact: bool = False) -> float:
    """Kernel against plain version on each piece; > 110 dB on the tone,
    or, ``exact``, equal on every piece (the precise K1 and K3 do the plain
    version's float32 operations in its order).  Returns the tone's max
    |err|."""
    res = {}
    for fname, raw in pieces.items():
        got, want = kernel(raw), plain(raw)
        equal = torch.equal(got, want)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        res[fname] = (snr_db(want, got), float(np.max(np.abs(want - got))))
        check(equal or not exact, f"{label}: differs from its plain version "
              f"on the {fname}")
    (s_t, e_t), (s_n, e_n) = res["tone"], res["noise"]
    say(f"{label}: tone {s_t:.1f} dB max|err| {e_t:.3g}; noise {s_n:.1f} dB "
        f"max|err| {e_n:.3g}" + ("; equal on both" if exact else ""))
    check(s_t > BAR_KERNEL_DB, f"{label}: {s_t:.1f} dB <= {BAR_KERNEL_DB} dB "
          f"on the tone")
    return e_t


def phase_kernels_cplx_q1(pieces: dict, dev) -> dict:
    """Phase 3, K3 and K4: one -L stage, one -q 2 stage and both, and the
    correctIq kernel with its offsets."""
    taps = taps_of({"S": "96000", "l": "12500"})
    errs = {}
    for label, extra, conds in (
            ("-L", ["-L", "12500"], ("shift", "normalize")),
            ("-q 2", ["-q", "2"], ("shift", "normalize")),
            ("-q 2 -L", ["-q", "2", "-L", "12500"], ("shift",))):
        st = pipe_of(extra).stage_consts()
        for precise in (True, False):
            for cond in conds:
                e = compare(
                    f"fused_nbfm_cplx {label} ({len(st)} stage(s), Dc "
                    f"{[len(t) - 1 for t, _ in st]}) "
                    f"{'precise' if precise else 'fast'} {cond}", pieces,
                    lambda r: fused_nbfm_cplx(r, st, taps, cond, precise),
                    lambda r: fused_nbfm_cplx_ref(r, st, taps, cond, precise),
                    exact=precise)
                key = (label, precise)
                errs[key] = max(errs.get(key, 0.0), e)
    q1 = pipe_of(["-q", "1"])
    off_in = torch.tensor([127.3, 126.8], device=dev)
    esr = float(q1.esr)
    for precise in (True, False):
        label = f"fused_nbfm_q1 {'precise' if precise else 'fast'}"
        e = compare(label, pieces,
                    lambda r: fused_nbfm_q1(r, off_in, taps, esr, precise)[0],
                    lambda r: fused_nbfm_q1_ref(r, off_in, taps, esr,
                                                precise)[0])
        _, k_ent, k_fin = fused_nbfm_q1(pieces["tone"], off_in, taps, esr,
                                        precise)
        _, p_ent, p_fin = fused_nbfm_q1_ref(pieces["tone"], off_in, taps, esr,
                                            precise)
        d = max(float((k_ent - p_ent).abs().max()),
                float((k_fin - p_fin).abs().max()))
        say(f"{label} offsets on the tone: max|diff| {d:.3g} (final "
            f"{k_fin.cpu().tolist()})")
        check(d < BAR_OFFSET, f"{label} offsets differ by {d:.3g}")
        errs[("-q 1", precise)] = e
    for precise in (True, False):
        label = f"fused_nbfm_q1_seq {'precise' if precise else 'fast'}"
        e = compare(label, pieces,
                    lambda r: fused_nbfm_q1_seq(r, off_in, taps, esr,
                                                precise)[0],
                    lambda r: fused_nbfm_q1_seq_ref(r, off_in, taps, esr,
                                                    precise)[0])
        got = fused_nbfm_q1_seq(pieces["tone"], off_in, taps, esr, precise)
        for other, want in (
                ("its plain version", fused_nbfm_q1_seq_ref(
                    pieces["tone"], off_in, taps, esr, precise)),
                ("fused_nbfm_q1 (K4)", fused_nbfm_q1(
                    pieces["tone"], off_in, taps, esr, precise))):
            s_db = snr_db(want[0].cpu().numpy(), got[0].cpu().numpy())
            d = max(float((got[1] - want[1]).abs().max()),
                    float((got[2] - want[2]).abs().max()))
            say(f"{label} against {other} on the tone: {s_db:.1f} dB, "
                f"offsets max|diff| {d:.3g}")
            check(s_db > BAR_KERNEL_DB and d < BAR_OFFSET,
                  f"{label} against {other}: {s_db:.1f} dB, offsets {d:.3g}")
        errs[("q1_seq", precise)] = e
    return errs


def phase_kernels(dev) -> dict:
    """Phase 3: each kernel against its plain version on the same bytes."""
    say("== phase 3: kernels against their plain versions on the card")
    rng = np.random.default_rng(3)
    tone = torch.from_numpy(tone_iq(NB * BB, 0, rng).reshape(NB, BB)).to(dev)
    noise = torch.from_numpy(rng.integers(0, 256, (NB, BB), dtype=np.uint8)
                             ).to(dev)
    tap_sets = {"butterworth -l 12500": taps_of({"S": "96000", "l": "12500"}),
                "chebyshev -m 1 -d 8": taps_of({"S": "96000", "l": "12500",
                                                "m": "1", "d": "8"})}
    errs = {("default", True): 0.0, ("default", False): 0.0}
    pieces = {"tone": tone, "noise": noise}
    for tname, taps in tap_sets.items():
        for precise in (True, False):
            for cond in ("shift", "normalize"):
                e = compare(
                    f"fused_nbfm {tname} (D={len(taps) - 1}) "
                    f"{'precise' if precise else 'fast'} {cond}", pieces,
                    lambda r: fused_nbfm(r, taps, cond, precise),
                    lambda r: fused_nbfm_ref(r, taps, cond, precise),
                    exact=precise)
                key = ("default", precise)
                errs[key] = max(errs[key], e)
    phase_kernels_odd_rows(rng, dev)
    got, want = dma_floor(noise), dma_floor_ref(noise)
    errs["dma_floor"] = float((got - want).abs().max())
    check(torch.equal(got, want), "dma_floor differs from dma_floor_ref "
          f"by {errs['dma_floor']:.3g}")
    say("dma_floor: equal to dma_floor_ref")
    errs.update(phase_kernels_cplx_q1(pieces, dev))
    errs.update(phase_kernels_patch(pieces, dev))
    errs.update(phase_kernels_patch_launch(pieces, dev))
    errs.update(phase_kernels_pfb(dev))
    return errs


def card_pipe(extra: list, fast: bool, dev) -> BlockPipeline:
    """The pipeline of ``CLI_ARGS + extra`` with its filters on the card."""
    return BlockPipeline(pipe_of(extra).cfg, fast_atan2=fast, device=dev)


def patch_of(pipe: BlockPipeline) -> tuple:
    """(the patch kernel after K3 of ``pipe``'s kernel path ("cplx1",
    "cplx2") as f(raw, audio, offsets), its plain version as the same, K3
    as f(raw) → (audio, None))."""
    outf, cond = pipe.out_fir, pipe.conditioning
    precise = not pipe.fast_atan2
    st = pipe.stage_consts()

    def main(raw):
        return fused_nbfm_cplx(raw, st, outf.host_taps, cond, precise), None
    if pipe.kernel_path() == "cplx1":
        (inf,) = pipe._cplx_stages()
        return (lambda r, a, o: patch_cplx1(r, a, inf, outf, cond, precise),
                lambda r, a, o: patch_cplx1_ref(r, a, inf, outf, cond,
                                                precise), main)
    dc, inf = pipe.dc_fir, pipe.in_fir
    return (lambda r, a, o: patch_cplx2(r, a, dc, inf, outf, cond, precise),
            lambda r, a, o: patch_cplx2_ref(r, a, dc, inf, outf, cond,
                                            precise), main)


def head_of(pipe: BlockPipeline) -> tuple:
    """K1 or K4 of ``pipe``'s kernel path ("fused", "q1") with its head
    rows, as the model calls it: (f(raw) → (audio, K4's entering offsets
    or None); want(raw, got, offsets) → (what ``got`` must equal: the
    kernel alone, K1 by a second launch, K4 ``got`` itself (its look-back
    order varies), with P1's or P2's plain version over it, from the
    offsets; K1 alone, or None); the plain version f(raw) → audio: the
    kernel's, then the patch's)."""
    outf, cond = pipe.out_fir, pipe.conditioning
    precise = not pipe.fast_atan2
    taps = outf.host_taps
    if pipe.kernel_path() == "fused":
        def call(raw):
            return fused_nbfm(raw, taps, cond, precise, head=outf), None

        def want(raw, got, ent):
            base = fused_nbfm(raw, taps, cond, precise)
            return patch_fused_ref(raw, base.clone(), outf, cond,
                                   precise), base

        def plain(raw):
            return patch_fused_ref(raw, fused_nbfm_ref(raw, taps, cond,
                                                       precise),
                                   outf, cond, precise)
        return call, want, plain
    esr = float(pipe.esr)
    off_in = torch.tensor([127.3, 126.8], device=pipe.device)

    def call(raw):
        audio, ent, _ = fused_nbfm_q1(raw, off_in, taps, esr, precise,
                                      head=outf)
        return audio, ent

    def want(raw, got, ent):
        return patch_q1_ref(raw, got.clone(), ent, outf, esr, precise), None

    def plain(raw):
        audio, ent, _ = fused_nbfm_q1_ref(raw, off_in, taps, esr, precise)
        return patch_q1_ref(raw, audio, ent, outf, esr, precise)
    return call, want, plain


def snr_dev(ref: torch.Tensor, test: torch.Tensor) -> float:
    """``snr_db`` of two tensors on their card, in float64, with nothing
    copied to the host but the result."""
    ref = ref.double()
    err = float(((ref - test.double()) ** 2).mean())
    return math.inf if err == 0 else 10 * math.log10(
        float((ref ** 2).mean()) / err)


def patch_bar(label: str, got: torch.Tensor, want: torch.Tensor,
              notes: list) -> None:
    """``got`` equal to ``want``, or within BAR_PATCH_ULP float32 ULP and
    above BAR_PATCH_DB (a float64 dot summed in the kernel's order rounds
    to another float32 than cuBLAS's sum); a difference goes into
    ``notes``."""
    if torch.equal(got, want):
        return
    u = ulps(got, want)
    s_db = snr_db(want.cpu().numpy(), got.cpu().numpy())
    notes.append(f"{label}: {u} ULP, {s_db:.1f} dB, max|err| "
                 f"{float((got - want).abs().max()):.3g}")
    check(u <= BAR_PATCH_ULP and s_db > BAR_PATCH_DB, notes[-1])


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (as ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def phase_kernels_patch(pieces: dict, dev) -> dict:
    """Phase 3, P3 and P4: each patch kernel after K3 on K3's output of
    the tone and the noise, at 16 and 2 blocks, against its plain version
    on the same output: equal, or within BAR_PATCH_ULP float32 ULP and
    above BAR_PATCH_DB where a float64 dot summed in the kernel's order
    rounds to another float32 than cuBLAS's sum (torch.einsum); each
    writes the rows its plain version writes and no other.  → the tone's
    max |err| per patch kernel and precision."""
    errs = {}
    for label, (extra, cond) in PATCH_CASES.items():
        if not label.startswith("patch_cplx"):
            continue
        for fast in (False, True):
            pipe = card_pipe(extra, fast, dev)
            patch, ref, main = patch_of(pipe)
            check(pipe.conditioning == cond, f"{label}: conditioning "
                  f"{pipe.conditioning}")
            kind = "fast" if fast else "precise"
            notes = []
            for blocks in (NB, SHARD_BLOCKS):
                for fname, piece in pieces.items():
                    raw = piece[:blocks]
                    base, offs = main(raw)
                    got = patch(raw, base.clone(), offs)
                    want = ref(raw, base.clone(), offs)
                    check(torch.equal(got != base, want != base),
                          f"{label} {kind}: rows written differ on the "
                          f"{fname} at B={blocks}")
                    if fname == "tone":
                        key = (label.split()[0], not fast)
                        errs[key] = max(errs.get(key, 0.0), float(
                            (got - want).abs().max()))
                    patch_bar(f"{label} {kind} B={blocks} {fname}", got,
                              want, notes)
            say(f"{label} {kind} ({cond}, path {pipe.kernel_path()}): "
                + ("equal to its plain version at B=16 and B=2 on the tone "
                   "and the noise" if not notes else
                   "within the bar where a float64 dot rounds to another "
                   "float32 than cuBLAS's sum: " + "; ".join(notes)))
    return errs


def graph_of(fn, n: int = 1):
    """``n`` calls of ``fn()`` captured as one CUDA graph on a side
    stream, after one warm-up there → (graph, the last captured call's
    output).  Captured as ``runtime/graphs.py`` captures (``capture_begin``
    with the collector off), not through ``torch.cuda.graph``, whose entry
    synchronizes, collects and empties the caches each time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    with torch.cuda.stream(side):
        fn()
        gc.disable()
        try:
            graph.capture_begin(capture_error_mode="global")
            try:
                for _ in range(n):
                    out = fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        finally:
            if collecting:
                gc.enable()
    torch.cuda.current_stream().wait_stream(side)
    return graph, out


def phase_kernels_patch_launch(pieces: dict, dev) -> dict:
    """Phase 3, every patch as the model launches it, on SHARD_BLOCKS, NB
    and 256 blocks of the tone and the noise, precise and fast: K1 and K4
    with their head rows (P1, P2) in one launch, against the kernel alone
    (K1: a second launch, every row compared, the rows written the head's;
    K4: its own output, whose look-back order varies) with the patch's
    plain version over it; P3 and P4 (``fused_call``: K3, then the patch
    as its programmatic dependent, nothing between) against the plain
    version on the same K3 output (a second K3 run); each at the bar of
    ``patch_bar``.  Then that step captured as a CUDA graph and replayed
    PATCH_REPLAYS times, each replay equal to the eager step (a store
    before K3's completion, or a head row left unwritten or also written
    by a span, would show on some runs only; K4's replays each at the bar
    against P2's plain version over it and > BAR_KERNEL_DB from the eager
    step).  → the tone's max |err| of K1 and K4 with their head rows."""
    errs = {}
    for label, (extra, cond) in PATCH_CASES.items():
        for fast in (False, True):
            pipe = card_pipe(extra, fast, dev)
            check(pipe.conditioning == cond, f"{label}: conditioning "
                  f"{pipe.conditioning}")
            head = pipe.kernel_path() in ("fused", "q1")
            if head:
                call, want_of, _ = head_of(pipe)
            else:
                _, ref, main = patch_of(pipe)
                state = pipe.init_state()

                def call(raw):
                    return pipe.fused_call(state, raw)[1], None

                def want_of(raw, got, ent):
                    base, _ = main(raw)
                    return ref(raw, base.clone(), None), base
            kind = "fast" if fast else "precise"
            notes = []
            for blocks in (SHARD_BLOCKS, NB, 256):
                for fname, piece in pieces.items():
                    raw = piece.repeat(-(-blocks // NB), 1)[:blocks]
                    got, ent = call(raw)
                    want, base = want_of(raw, got, ent)
                    if base is not None:
                        check(torch.equal(got != base, want != base),
                              f"{label} {kind} as launched: rows written "
                              f"differ on the {fname} at B={blocks}")
                    if head and fname == "tone":
                        key = (label.split()[0], not fast)
                        errs[key] = max(errs.get(key, 0.0), float(
                            (got - want).abs().max()))
                    patch_bar(f"{label} {kind} as launched B={blocks} "
                              f"{fname}", got, want, notes)
                    graph, (out, out_ent) = graph_of(lambda: call(raw))
                    for rep in range(PATCH_REPLAYS):
                        out.fill_(float("nan"))
                        graph.replay()
                        if out_ent is None:
                            check(torch.equal(out, got),
                                  f"{label} {kind} B={blocks} {fname}: "
                                  f"replay {rep} of the captured step "
                                  f"differs from the eager step")
                            continue
                        w, _ = want_of(raw, out, out_ent)
                        patch_bar(f"{label} {kind} B={blocks} {fname} "
                                  f"replay {rep}", out, w, [])
                        s_db = snr_dev(got, out)
                        check(s_db > BAR_KERNEL_DB,
                              f"{label} {kind} B={blocks} {fname}: replay "
                              f"{rep} {s_db:.1f} dB from the eager step")
                    del graph, out, out_ent
            how = ("K4 with its head rows, one launch; each replay at the "
                   "bar over its own output, > 110 dB from the eager step"
                   if pipe.kernel_path() == "q1" else
                   "K1 with its head rows, one launch" if head else
                   "K3, then the patch as its programmatic dependent")
            say(f"{label} {kind} as the model launches it ({how}): "
                + ("equal to its plain version" if not notes else
                   "within the bar: " + "; ".join(notes))
                + f" at B={SHARD_BLOCKS}, {NB} and 256 on the tone and the "
                f"noise; {PATCH_REPLAYS} graph replays each"
                + ("" if pipe.kernel_path() == "q1" else
                   ", each equal to the eager step"))
    return errs


def phase_kernels_odd_rows(rng, dev) -> None:
    """Phase 3, K1 and K3 precise on rows of 4·(4k + 3) bytes that start 4
    bytes past a 16-byte boundary (their scalar loads and stores), with the
    CLI's taps and with 32 audio and 32 stage taps (counts read at run
    time): equal to their plain versions."""
    n = 4 * (4 * (BB // 16) + 3)
    buf = torch.empty(NB * n + 32, dtype=torch.uint8, device=dev)
    base = (16 - buf.data_ptr() % 16) % 16 + 4
    raw = buf[base: base + NB * n].view(NB, n)
    raw.copy_(torch.from_numpy(tone_iq(NB * n, 0, rng).reshape(NB, n)))
    taps = taps_of({"S": "96000", "l": "12500"})
    taps32 = rng.uniform(-0.5, 0.5, 32)
    st2 = pipe_of(["-q", "2", "-L", "12500"]).stage_consts()
    st32 = tuple((rng.uniform(-0.3, 0.3, 32), tuple(rng.uniform(-1, 1, 2)))
                 for _ in range(2))
    for label, t, st in (("CLI taps", taps, st2),
                         ("32 audio and stage taps", taps32, st32)):
        got, want = (fused_nbfm(raw, t), fused_nbfm_ref(raw, t))
        got3, want3 = (fused_nbfm_cplx(raw, st, t),
                       fused_nbfm_cplx_ref(raw, st, t))
        check(torch.equal(got, want) and torch.equal(got3, want3),
              f"fused_nbfm / fused_nbfm_cplx on rows of {n} bytes, "
              f"{label}: differ from their plain versions")
        say(f"fused_nbfm and fused_nbfm_cplx (2 stages) precise on {NB} rows "
            f"of {n} bytes starting {raw.data_ptr() % 16} bytes past a "
            f"16-byte boundary, {label}: equal to their plain versions")


def bank_iq(fs: float, offsets, carriers, start: int, n: int, seed: int,
            amp: float, dev, dev_hz: float = 5000.0) -> torch.Tensor:
    """uint8 IQ [2n] made on the card: an FM carrier (``dev_hz``
    deviation, tone 400 + 150·i Hz) on each offset of ``carriers``, plus
    Gaussian noise of 0.05 of full scale (about 6 LSB rms, a receiver's
    noise floor) from ``seed``.  ``start`` is the first sample's index, so
    consecutive pieces join without a phase jump."""
    f64 = torch.float64
    idx = torch.arange(start, start + n, dtype=f64, device=dev)
    re = torch.zeros(n, dtype=f64, device=dev)
    im = torch.zeros(n, dtype=f64, device=dev)
    for i, c in enumerate(carriers):
        tone = 400.0 + 150.0 * i
        ph = (2 * math.pi * torch.remainder(idx * (offsets[c] / fs), 1.0)
              + dev_hz / tone * (1 - torch.cos(2 * math.pi * tone / fs * idx)))
        re += amp * torch.cos(ph)
        im += amp * torch.sin(ph)
    g = torch.Generator(device=dev).manual_seed(seed)
    re += 0.05 * torch.randn(n, generator=g, dtype=f64, device=dev)
    im += 0.05 * torch.randn(n, generator=g, dtype=f64, device=dev)
    iq = torch.stack([re, im], dim=-1).reshape(-1)
    return torch.clamp(torch.round(iq * 127 + 127), 0, 255).to(torch.uint8)


def bank_offsets(nch: int, cr: float = CR, listed: int | None = None) -> list:
    """The --bank list of a run: ``listed`` channels (default: every one of
    the grid's nch) about DC, (c - listed/2)·cr."""
    listed = listed or nch
    return [(c - listed // 2) * cr for c in range(listed)]


def pfb_plan(C: int) -> str:
    """K6's FFT plan of C channels, as printed."""
    if on_cluster(C):
        N1, N2, K, T, sa, sb, held = CLUSTER_PLANS[C]
        return (f"four steps {N1} x {N2} on clusters of {K} CTAs of {T} "
                f"threads, stages {' x '.join(map(str, sa))} / "
                f"{' x '.join(map(str, sb))}, taps "
                f"{'in registers' if held else 'read'}, one launch")
    if C > MAX_CTA_CHANNELS:
        N1, N2 = four_step_plan(C)
        T1, T2 = four_step_tiles(C)
        return (f"four steps {N1} x {N2}, tiles {T1} / {T2 or 'direct'}, "
                f"{group_pairs(C)} pairs a group")
    return " x ".join(map(str, fft_plan(C)))


def phase_kernels_pfb(dev) -> dict:
    """Phase 3, K6: two streamed 0.25 s blocks per C of an on-grid FM bank
    capture and of noise (blocks of PFB_STEP_SECONDS above 4096 channels),
    and C = 4 on a 10-block bank4 chunk; up to 256 channels of CR, above
    of 6.25 kHz, in whole frame pairs.  Returns the max angle-wrapped error
    on the bank capture of each route: "pfb" up to 256 channels, "pfb
    wide" up to 4096, "pfb four-step" above."""
    worst = {"pfb": 0.0, "pfb wide": 0.0, "pfb four-step": 0.0}
    rng = np.random.default_rng(11)
    for C, blocks in ([(C, 1) for C in PFB_CHANNELS] + [(4, 10)]
                      + [(C, 1) for C in PFB_WIDE_CHANNELS]):
        pfb = PolyphaseChannelizer(C)
        wide = C > 256
        route = ("pfb four-step" if C > MAX_CTA_CHANNELS
                 else "pfb wide" if wide else "pfb")
        fs = C * (NARROW_CR if wide else CR)
        secs = PFB_STEP_SECONDS if C > MAX_CTA_CHANNELS else 0.25
        n = int(secs * fs) // (2 * C) * (2 * C) * blocks
        offs = bank_offsets(C, NARROW_CR if wide else CR)
        car = tuple(range(0, C, max(1, C // 4)))
        for data in ("bank", "noise"):
            hist_k = torch.zeros((2, pfb.hist_len), device=dev)
            hist_r = hist_k.clone()
            res = []
            for b in range(2):
                raw = (bank_iq(fs, offs, car, b * n, n, 100 + C, 0.2, dev,
                               NARROW_DEV_HZ if wide else 5000.0)
                       if data == "bank" else torch.from_numpy(
                           rng.integers(0, 256, 2 * n, np.uint8)).to(dev))
                n0 = fused_pfb_demod.launches
                d, hist_k = fused_pfb_demod(raw, hist_k, pfb._h_np, C)
                check(fused_pfb_demod.launches - n0
                      == launches_per_call(C, n),
                      f"fused_pfb C={C}: {fused_pfb_demod.launches - n0} "
                      f"launches, want {launches_per_call(C, n)}")
                want, hist_r = fused_pfb_demod_ref(raw, hist_r, pfb._h_np, C)
                res.append(wrapped(want, d))
                check(torch.equal(hist_k, hist_r),
                      f"fused_pfb C={C} {data}: history differs")
            err = max(r[0] for r in res)
            snr = min(r[1] for r in res)
            say(f"fused_pfb C={C} (FFT {pfb_plan(C)}; {blocks} block(s) of "
                f"{secs:g} s, {n} samples, {launches_per_call(C, n)} "
                f"launch(es) a call) {data}: angle-wrapped max|err| "
                f"{err:.3g} rad, {snr:.1f} dB, history bit-equal")
            check(err < BAR_ANGLE and snr > BAR_BANK_DB,
                  f"fused_pfb C={C} {data}: {err:.3g} rad, {snr:.1f} dB")
            if data == "bank":
                worst[route] = max(worst[route], err)
    return worst


def tone_iq_card(n_bytes: int, start: int, seed: int, dev) -> torch.Tensor:
    """:func:`tone_iq` made on the card in float64 (its noise from a torch
    generator seeded with ``seed``): the 256 MiB capture in about a second
    instead of twenty."""
    f64, n = torch.float64, n_bytes // 2
    t = (start + torch.arange(n, dtype=f64, device=dev)) / FS
    phase = 2.5 * (1.0 - torch.cos(2 * math.pi * 1000.0 * t))
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((2, n), generator=g, dtype=f64, device=dev) * 4
    iq = torch.stack([80 * torch.cos(phase) + noise[0],
                      80 * torch.sin(phase) + noise[1]], dim=-1).reshape(-1)
    return torch.clamp(torch.round(iq + 127.4), 0, 255).to(torch.uint8)


def write_capture(path: Path, dev) -> None:
    step = NB * BB
    with open(path, "wb") as f:
        for k in range(CAPTURE_BLOCKS // NB):
            f.write(tone_iq_card(step, k * step // 2, 7000 + k,
                                 dev).cpu().numpy().tobytes())
        f.write(tone_iq_card(TAIL_BYTES, CAPTURE_BLOCKS * BB // 2, 6999,
                             dev).cpu().numpy().tobytes())


def run_cli(cap: Path, out: Path, extra: list,
            graphs: bool = True) -> tuple[dict, str]:
    """(PHASES of the run, its stderr); ``graphs`` False runs it under
    DEMODULATOR_TPU_TORCH_GRAPHS=0."""
    env = {**os.environ, "DEMODULATOR_TPU_TORCH_PHASES": "1",
           "DEMODULATOR_TPU_TORCH_GRAPHS": "1" if graphs else "0"}
    # paths relative to the repository: an -i/-o argument containing '-'
    # selects stdin/stdout (the reference's strstr quirk)
    cmd = [sys.executable, "-m", "demodulator_tpu_torch",
           "-i", os.path.relpath(cap, REPO), "-o", os.path.relpath(out, REPO),
           *CLI_ARGS, *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{' '.join(cmd)} exited {r.returncode}:\n"
          f"{r.stderr[-4000:]}")
    lines = [ln for ln in r.stderr.splitlines() if ln.startswith("PHASES ")]
    check(len(lines) == 1, f"no PHASES line from the CLI:\n{r.stderr}")
    phases = json.loads(lines[0][len("PHASES "):])
    phases["wall_s"] = round(wall, 3)
    return phases, r.stderr


def plain_blocks(cap: Path, first_block: int, count: int, fast: bool,
                 extra: list, precision: str = "float32") -> np.ndarray:
    """The --device cpu plain path on ``count`` blocks of the capture.
    Under -q 1 it starts a block earlier (from block 0 it starts as the run
    did) and drops that block: a^(n/4) ~ e^-68 at 96 kHz, so the offset it
    carries out is the one the run carried in."""
    cfg = pipe_of(extra).cfg
    cfg.precision = precision
    pipe = BlockPipeline(cfg, fast_atan2=fast, device="cpu")
    lead = 1 if pipe.kind == 1 and first_block > 0 else 0
    raw = np.fromfile(cap, dtype=np.uint8, count=(count + lead) * BB,
                      offset=(first_block - lead) * BB).reshape(-1, BB)
    _, audio = pipe(pipe.init_state(), torch.from_numpy(raw))
    return audio.numpy()[lead:]


def phase_main_path(work: Path, dev) -> dict:
    """Phase 4: the CLI on a 256 MiB capture in each mode.  The outputs of
    the precise and -q 1 runs stay for phase 4c (``out.<run>.raw``)."""
    say("== phase 4: main paths through python -m demodulator_tpu_torch")
    cap = work / "cap.iq"
    t0 = time.perf_counter()
    write_capture(cap, dev)
    say(f"capture: {cap.stat().st_size} bytes ({CAPTURE_BLOCKS} blocks + "
        f"{TAIL_BYTES} bytes) written in {time.perf_counter() - t0:.1f} s")
    n_out = CAPTURE_BLOCKS * (BB // 4)
    results = {}
    for name, (extra, kernel, patch) in CLI_RUNS.items():
        out = work / "out.raw"
        # the CLI process starts with its launch counts at 0 and reports
        # them at its end (PHASES line)
        phases, _ = run_cli(cap, out, extra)
        counts = launch_counts(phases)
        launches = counts[f"{kernel}_launches"]
        say(f"cli {name}: PHASES {json.dumps(phases)}")
        check(phases["graph"] is True, f"cli {name}: graph "
              f"{phases['graph']}")
        audio = np.fromfile(out, dtype=np.float32)
        check(audio.shape == (n_out,), f"cli {name}: {audio.shape[0]} "
              f"floats, want {n_out}")
        check(bool(np.all(np.isfinite(audio))), f"cli {name}: non-finite")
        audio = audio.reshape(CAPTURE_BLOCKS, BB // 4)
        fast = "--fast-atan2" in extra
        s_first = snr_db(plain_blocks(cap, 0, 32, fast, extra), audio[:32])
        s_last = snr_db(plain_blocks(cap, CAPTURE_BLOCKS - 32, 32, fast,
                                     extra), audio[-32:])
        say(f"cli {name} vs --device cpu plain path: first 32 blocks "
            f"{s_first:.1f} dB, last 32 blocks {s_last:.1f} dB")
        check(min(s_first, s_last) > BAR_KERNEL_DB,
              f"cli {name} vs plain path below {BAR_KERNEL_DB} dB")
        data = np.fromfile(cap, dtype=np.uint8, count=2 * BB).tobytes()
        oracle = OraclePipeline(pipe_of(extra).cfg).process_stream(data)
        s_or = snr_db(oracle, audio[:2])
        say(f"cli {name} vs OraclePipeline (first 2 blocks): {s_or:.1f} dB")
        check(s_or > BAR_ORACLE_DB, f"cli {name} vs oracle {s_or:.1f} dB")
        # K3's patch kernel once a step; K1 and K4 carry their head rows
        patches = counts[f"{patch}_launches"] if patch else 0
        check(launches == CAPTURE_BLOCKS // NB
              and patches == (launches if patch else 0)
              and sum(counts[f"{p}_launches"] for p in PATCHES) == patches,
              f"cli {name}: {kernel} launched {launches} times, {patch} "
              f"{patches} (launches {counts}), want {CAPTURE_BLOCKS // NB} "
              f"of {kernel}" + (" and of its patch" if patch else
                                " and no patch kernel"))
        msps = CAPTURE_BLOCKS * BB / 2 / phases["run_s"] / 1e6
        say(f"cli {name}: launches {counts}; end to end {msps:.1f} "
            f"Msamples/s of complex input (run {phases['run_s']} s of "
            f"{phases['wall_s']} s wall)")
        results[name] = {"launches": launches, "patch_launches": patches,
                         "msps": msps}
        if name in KEEP_RUNS:
            out.rename(work / f"out.{KEEP_RUNS[name]}.raw")
        else:
            out.unlink()
    return results


def bank_args(nch: int, cr: float = CR, listed: int | None = None) -> list:
    return ["--bank", ",".join(f"{o:.0f}" for o in bank_offsets(nch, cr,
                                                                  listed)),
            "--iq-rate", f"{nch * cr:.0f}", "--channel-rate", f"{cr:.0f}"]


def write_bank_capture(path: Path, nch: int, n_bytes: int, carriers,
                       dev, offsets=None, cr: float = CR,
                       dev_hz: float = 5000.0) -> None:
    """``n_bytes`` of synthetic IQ at nch·cr, written in pieces of 8 Mi
    samples made on the card with a running sample index; the carriers sit
    on ``offsets`` (default: the grid's)."""
    offs, piece = offsets or bank_offsets(nch, cr), 1 << 23
    amp = 0.8 / len(carriers)
    with open(path, "wb") as f:
        for k, start in enumerate(range(0, n_bytes // 2, piece)):
            n = min(piece, n_bytes // 2 - start)
            f.write(bank_iq(nch * cr, offs, carriers, start, n, 1000 + k, amp,
                            dev, dev_hz).cpu().numpy().tobytes())


def deconvolve(y: np.ndarray, h: np.ndarray) -> tuple[np.ndarray, int, int]:
    """x with y = causal FIR h of x over a span, per row → (x, head, tail):
    the first ``head`` and last ``tail`` samples of x depend on values
    outside the span (the recursion starts there from zeros; its error
    shrinks by the zeros' modulus per step).  A minimum-phase h (zeros
    inside the unit circle) runs forward, x[t] = (y[t] - sum_j h[j]
    x[t - j]) / h[0]; a maximum-phase one backward, solving for x[t - K + 1]
    from y[t]."""
    K = len(h)
    z = np.abs(np.roots(h)) if K > 1 else np.zeros(1)
    check(bool(np.all(z < 1) or np.all(z > 1)),
          f"audio taps {h}: zeros on both sides of the unit circle")
    fwd = bool(np.all(z < 1))
    r = float(np.max(z) if fwd else np.max(1 / z))
    settle = 0 if K == 1 else int(math.ceil(28 / -math.log(r))) * (K - 1)
    x = np.zeros_like(y, dtype=np.float64)
    T = y.shape[1]
    if fwd:
        for t in range(T):
            acc = y[:, t].astype(np.float64)
            for j in range(1, min(K, t + 1)):
                acc = acc - h[j] * x[:, t - j]
            x[:, t] = acc / h[0]
        return x, settle, 0
    for t in range(T - 1, K - 2, -1):
        acc = y[:, t].astype(np.float64)
        for j in range(K - 1):
            acc = acc - h[j] * x[:, t - j]
        x[:, t - K + 1] = acc / h[K - 1]
    return x, 0, settle


def bank_compare(name: str, cli: np.ndarray, plain: np.ndarray,
                 taps: np.ndarray, carriers, lo: int, hi: int) -> float:
    """Over samples [lo, hi) of the span: carrier channels > 80 dB and
    within 1e-4 of the plain pipeline; every channel's discriminator
    output, recovered from the audio by deconvolving the whole span (the
    plain path starts at the span's start from a zero state), within
    0.01 rad angle-wrapped and > 80 dB, where the deconvolution is pinned
    down.  Returns the carriers' max |err|."""
    diff = cli.astype(np.float64) - plain
    d_plain, _, tail = deconvolve(plain, taps)
    e, head, _ = deconvolve(diff, taps)
    a_lo, a_hi = max(lo, head), min(hi, plain.shape[1] - tail)
    d_plain, e = d_plain[:, a_lo:a_hi], e[:, a_lo:a_hi]
    flips = int(np.sum(np.abs(e) > 1.0))
    e = np.mod(e + np.pi, 2 * np.pi) - np.pi
    worst, snrs = 0.0, []
    for c in carriers:
        s_db = snr_db(plain[c, lo:hi], cli[c, lo:hi])
        m = float(np.abs(diff[c, lo:hi]).max())
        check(s_db > BAR_BANK_DB and m < BAR_BANK_ATOL,
              f"{name} channel {c}: {s_db:.1f} dB, max|err| {m:.3g}")
        worst = max(worst, m)
        snrs.append(round(s_db, 1))
    a_err = float(np.abs(e).max())
    a_snr = min(10 * math.log10(np.mean(d_plain[c] ** 2)
                                / max(np.mean(e[c] ** 2), 1e-300))
                for c in range(cli.shape[0]))
    say(f"{name}: carrier channels {snrs} dB, max|err| {worst:.3g}; "
        f"discriminator of all {cli.shape[0]} channels (samples {a_lo}-"
        f"{a_hi} of the span) angle-wrapped max|err| {a_err:.3g} rad, worst "
        f"channel {a_snr:.1f} dB, {flips} flip(s) at +-pi")
    check(a_err < BAR_ANGLE and a_snr > BAR_BANK_DB,
          f"{name}: discriminator {a_err:.3g} rad, {a_snr:.1f} dB")
    return worst


def phase_bank(work: Path, dev) -> dict:
    """Phase 4, the channel bank: bank64 and bank4 through the CLI."""
    results = {}
    for name, (nch, n_bytes, carriers, per_call) in BANK_RUNS.items():
        cap = work / f"{name}.iq"
        t0 = time.perf_counter()
        write_bank_capture(cap, nch, n_bytes, carriers, dev)
        cfg = ChannelBankConfig(sample_rate=nch * CR, channel_rate=CR,
                                offsets_hz=tuple(bank_offsets(nch)),
                                block_seconds=0.25)
        pipe = ChannelBankPipeline(cfg, device="cpu")
        bb, A = pipe.block_bytes, pipe.audio_per_block
        nblk = n_bytes // bb
        say(f"{name} capture: {n_bytes} bytes ({nblk} blocks of {bb} bytes "
            f"+ a {n_bytes - nblk * bb}-byte tail, dropped) written in "
            f"{time.perf_counter() - t0:.1f} s")
        out = work / name
        phases, _ = run_cli(cap, out, bank_args(nch))
        say(f"cli {name}: PHASES {json.dumps(phases)}")
        check(phases["graph"] is True, f"cli {name}: graph "
              f"{phases['graph']}")
        launches = int(phases["fused_pfb_launches"])
        check(launches > 0, f"cli {name}: fused_pfb was not launched")
        check(launches == -(-nblk // per_call),
              f"cli {name}: {launches} launches for {nblk} blocks")
        audio = np.stack([np.fromfile(f"{out}.ch{c}.raw", np.float32)
                          for c in range(nch)])
        check(audio.shape == (nch, nblk * A), f"cli {name}: {audio.shape}, "
              f"want {(nch, nblk * A)}")
        check(bool(np.all(np.isfinite(audio))), f"cli {name}: non-finite")
        taps = np.asarray(pipe.audio.taps, np.float64)
        raw = np.fromfile(cap, np.uint8)
        err = 0.0
        # spans of blocks [b0, b1) run through the plain path from a fresh
        # state, compared on blocks [c0, c0 + 2): the first two with a block
        # after them, the last two with two before them to settle
        for b0, b1, c0 in ((0, 3, 0), (nblk - 4, nblk, nblk - 2)):
            blocks = torch.from_numpy(raw[b0 * bb:b1 * bb].reshape(-1, bb))
            _, plain = pipe.call_u16(pipe.init_state(), blocks)
            err = max(err, bank_compare(
                f"cli {name} blocks {c0}-{c0 + 1} vs --device cpu plain "
                f"pipeline", audio[:, b0 * A:b1 * A],
                plain.numpy().astype(np.float64), taps, carriers,
                (c0 - b0) * A, (c0 - b0 + 2) * A))
        if name == "bank64":
            carrier_tones(name, audio, CR / 2, carriers)
        msps = nblk * bb / 2 / phases["run_s"] / 1e6
        say(f"cli {name}: {nblk} blocks, {nch} channels; end to end "
            f"{msps:.1f} Msamples/s of complex input (run {phases['run_s']} "
            f"s of {phases['wall_s']} s wall)")
        results[name] = {"launches": launches, "msps": msps, "max_err": err,
                         "phases": phases}
        if name == "bank4":
            continue        # capture and outputs stay for phase 4c
        # the capture and the channel files' digests stay for phase 4e
        results[name]["digests"] = channel_digests(out, nch)
        for c in range(nch):
            Path(f"{out}.ch{c}.raw").unlink()
    return results


def carrier_tones(name: str, audio: np.ndarray, rate: float,
                  carriers) -> None:
    """Each carrier channel's tone within 15 Hz of 400 + 150·i Hz."""
    f = np.fft.rfftfreq(audio.shape[1], 1 / rate)
    w = np.hanning(audio.shape[1])
    found = []
    for i, c in enumerate(carriers):
        mag = np.abs(np.fft.rfft(audio[c] * w))
        peak = float(f[np.argmax(mag[3:]) + 3])
        found.append(round(peak, 2))
        check(abs(peak - (400.0 + 150.0 * i)) < 15.0,
              f"cli {name} channel {c}: tone at {peak} Hz, want "
              f"{400.0 + 150.0 * i}")
    say(f"cli {name}: carrier tones found at {found} Hz (within 15 "
        f"Hz of 400 + 150·i)")


def phase_bank_narrow(work: Path, dev) -> dict:
    """Phase 4b, K6's three-factor route through the CLI: bank512, 16
    channels of the 512 of a 3.2 Msps capture at 6.25 kHz."""
    name, nch, listed, n_bytes, carriers = NARROW_RUN
    offs = bank_offsets(nch, NARROW_CR, listed)
    cap = work / f"{name}.iq"
    t0 = time.perf_counter()
    write_bank_capture(cap, nch, n_bytes, carriers, dev, offsets=offs,
                       cr=NARROW_CR, dev_hz=NARROW_DEV_HZ)
    pipe = ChannelBankPipeline(ChannelBankConfig(
        sample_rate=nch * NARROW_CR, channel_rate=NARROW_CR,
        offsets_hz=tuple(offs), lowpass_out=float(NARROW_LOWPASS),
        block_seconds=0.25), device="cpu")
    bb, A = pipe.block_bytes, pipe.audio_per_block
    nblk = n_bytes // bb
    say(f"{name} capture: {n_bytes} bytes at {nch * NARROW_CR / 1e6:g} Msps "
        f"({nblk} blocks of {bb} bytes + a {n_bytes - nblk * bb}-byte tail, "
        f"dropped; K6's plan C = {nch} = "
        f"{' x '.join(map(str, fft_plan(nch)))}) written in "
        f"{time.perf_counter() - t0:.1f} s")
    out = work / name
    phases, _ = run_cli(cap, out, ["-l", NARROW_LOWPASS, "--chunk-blocks",
                                   "1", *bank_args(nch, NARROW_CR, listed)])
    say(f"cli {name}: PHASES {json.dumps(phases)}")
    check(phases["graph"] is True, f"cli {name}: graph {phases['graph']}")
    launches = int(phases["fused_pfb_launches"])
    check(launches == nblk, f"cli {name}: {launches} fused_pfb launches "
          f"for {nblk} blocks")
    audio = np.stack([np.fromfile(f"{out}.ch{c}.raw", np.float32)
                      for c in range(listed)])
    check(audio.shape == (listed, nblk * A), f"cli {name}: {audio.shape}, "
          f"want {(listed, nblk * A)}")
    check(bool(np.all(np.isfinite(audio))), f"cli {name}: non-finite")
    raw = np.fromfile(cap, np.uint8, count=NARROW_CHECKED * bb)
    _, plain = pipe.call_u16(pipe.init_state(),
                             torch.from_numpy(raw.reshape(-1, bb)))
    err = bank_compare(
        f"cli {name} blocks 0-{NARROW_CHECKED - 1} vs --device cpu plain "
        f"pipeline", audio[:, :NARROW_CHECKED * A],
        plain.numpy().astype(np.float64),
        np.asarray(pipe.audio.taps, np.float64), carriers, 0,
        NARROW_CHECKED * A)
    carrier_tones(name, audio, NARROW_CR / 2, carriers)
    msps = nblk * bb / 2 / phases["run_s"] / 1e6
    say(f"cli {name}: {nblk} blocks, {listed} of {nch} channels; end to end "
        f"{msps:.1f} Msamples/s of complex input (run {phases['run_s']} s "
        f"of {phases['wall_s']} s wall)")
    for c in range(listed):
        Path(f"{out}.ch{c}.raw").unlink()
    cap.unlink()
    return {name: {"launches": launches, "msps": msps, "max_err": err,
                   "phases": phases}}


def phase_bank_four_step(work: Path, dev) -> dict:
    """Phase 4b, K6's four-step route through the CLI: bank8192, 16
    channels of the 8192 of a 51.2 Msps capture at 6.25 kHz, captured: one
    launch of the cluster kernel a block, the first STEP_CHECKED
    blocks held to the --device cpu pipeline.  The capture stays for phase
    4f, which runs it captured and eager, each traced (kernel events equal
    to the counted launches, the two byte-equal)."""
    name, nch, listed, n_bytes, carriers = STEP_RUN
    offs = bank_offsets(nch, NARROW_CR, listed)
    cap = work / f"{name}.iq"
    t0 = time.perf_counter()
    write_bank_capture(cap, nch, n_bytes, carriers, dev, offsets=offs,
                       cr=NARROW_CR, dev_hz=NARROW_DEV_HZ)
    pipe = ChannelBankPipeline(ChannelBankConfig(
        sample_rate=nch * NARROW_CR, channel_rate=NARROW_CR,
        offsets_hz=tuple(offs), lowpass_out=float(NARROW_LOWPASS),
        block_seconds=0.25), device="cpu")
    bb, A = pipe.block_bytes, pipe.audio_per_block
    nblk = n_bytes // bb
    per_block = launches_per_call(nch, pipe.block_complex)
    say(f"{name} capture: {n_bytes} bytes at {nch * NARROW_CR / 1e6:g} Msps "
        f"({nblk} blocks of {bb} bytes + a {n_bytes - nblk * bb}-byte tail, "
        f"dropped; K6's plan C = {nch}: {pfb_plan(nch)}, {per_block} "
        f"launches a block) written in {time.perf_counter() - t0:.1f} s")
    out = work / f"{name}.out"
    phases, _ = run_cli(cap, out, [
        "-l", NARROW_LOWPASS, "--chunk-blocks", "1",
        *bank_args(nch, NARROW_CR, listed)])
    say(f"cli {name}: PHASES {json.dumps(phases)}")
    check(phases["graph"] is True, f"cli {name}: graph {phases['graph']}")
    launches = int(phases["fused_pfb_launches"])
    check(launches == nblk * per_block, f"cli {name}: {launches} fused_pfb "
          f"launches for {nblk} blocks of {per_block}")
    audio = np.stack([np.fromfile(f"{out}.ch{c}.raw", np.float32)
                      for c in range(listed)])
    check(audio.shape == (listed, nblk * A), f"cli {name}: {audio.shape}, "
          f"want {(listed, nblk * A)}")
    check(bool(np.all(np.isfinite(audio))), f"cli {name}: non-finite")
    raw = np.fromfile(cap, np.uint8, count=STEP_CHECKED * bb)
    _, plain = pipe.call_u16(pipe.init_state(),
                             torch.from_numpy(raw.reshape(-1, bb)))
    err = bank_compare(
        f"cli {name} blocks 0-{STEP_CHECKED - 1} vs --device cpu plain "
        f"pipeline", audio[:, :STEP_CHECKED * A],
        plain.numpy().astype(np.float64),
        np.asarray(pipe.audio.taps, np.float64), carriers, 0,
        STEP_CHECKED * A)
    carrier_tones(name, audio, NARROW_CR / 2, carriers)
    msps = nblk * bb / 2 / phases["run_s"] / 1e6
    say(f"cli {name}: {nblk} blocks, {listed} of {nch} channels; end to end "
        f"{msps:.1f} Msamples/s of complex input (run {phases['run_s']} s "
        f"of {phases['wall_s']} s wall)")
    for c in range(listed):
        Path(f"{out}.ch{c}.raw").unlink()
    return {name: {"launches": int(phases["fused_pfb_launches"]),
                   "msps": msps, "max_err": err, "phases": phases}}


def channel_digests(prefix: Path, nch: int) -> list:
    return [hashlib.sha256(Path(f"{prefix}.ch{c}.raw").read_bytes())
            .hexdigest() for c in range(nch)]


def launch_counts(phases: dict) -> dict:
    return {k: int(v) for k, v in phases.items() if k.endswith("_launches")}


def report(name: str, phases: dict, blocks: int, block_bytes: int,
           smi: str) -> None:
    """The run's PHASES line and its rate in Msamples/s of complex input
    over ``run_s``, with the card."""
    msps = blocks * block_bytes / 2 / phases["run_s"] / 1e6
    say(f"cli {name}: PHASES {json.dumps(phases)}")
    say(f"cli {name}: {msps:.1f} Msamples/s of complex input end to end "
        f"(run {phases['run_s']} s of {phases['wall_s']} s wall) on {smi}")


def continuous_plain(cap: Path, first: int, count: int,
                     extra: list) -> np.ndarray:
    """The --device cpu continuous stream on blocks [first, first + count)
    of the capture, fed the block after them as halo (to EOF: the padded
    tail block, then a zero halo).  Under -q 1 it starts a block earlier
    and drops it, as plain_blocks does."""
    cfg = pipe_of(extra).cfg
    cfg.profile = "continuous"
    lead = 1 if cfg.conditioning_kind() == 1 and first > 0 else 0
    start = (first - lead) * BB
    end = (first + count + 1) * BB
    with open(cap, "rb") as f:
        f.seek(start)
        data = f.read(end - start)
    out = io.BytesIO()
    StreamProcessor(cfg, chunk_blocks=NB, device="cpu").run(io.BytesIO(data),
                                                            out)
    audio = np.frombuffer(out.getvalue(), np.float32).reshape(-1, BB // 4)
    return audio[lead: lead + count]


def q1_offset_after(cap: Path, blocks: int) -> np.ndarray:
    """The offset the -q 1 tracker carries out of block ``blocks - 1``, by
    the plain path from zero on the two blocks before it (a^(n/4) ~ e^-68
    per block: the earlier blocks do not show)."""
    pipe = pipe_of(["-q", "1"])
    raw = np.fromfile(cap, np.uint8, count=2 * BB,
                      offset=(blocks - 2) * BB).reshape(2, BB)
    st, _ = pipe.process_blocks(pipe.init_state(), torch.from_numpy(raw))
    return st.iq_off.numpy()


def phase_f64_continuous(work: Path, cap: Path, smi: str) -> None:
    """Phase 4c: --precision float64 and --profile continuous (no kernel:
    torch ops on the card)."""
    out = work / "out.raw"
    phases, _ = run_cli(cap, out, ["--precision", "float64"])
    counts = launch_counts(phases)
    check(not any(counts.values()), f"cli float64 launched kernels: {counts}")
    audio = np.fromfile(out, dtype=np.float64)
    check(audio.shape == (CAPTURE_BLOCKS * (BB // 4),),
          f"cli float64: {audio.shape[0]} floats")
    check(bool(np.all(np.isfinite(audio))), "cli float64: non-finite")
    audio = audio.reshape(CAPTURE_BLOCKS, BB // 4)
    s_first = snr_db(plain_blocks(cap, 0, 32, False, [], "float64"),
                     audio[:32])
    s_last = snr_db(plain_blocks(cap, CAPTURE_BLOCKS - 32, 32, False, [],
                                 "float64"), audio[-32:])
    cfg = pipe_of([]).cfg
    cfg.precision = "float64"
    data = np.fromfile(cap, dtype=np.uint8, count=2 * BB).tobytes()
    s_or = snr_db(OraclePipeline(cfg, dtype=np.float64).process_stream(data),
                  audio[:2])
    say(f"cli float64 vs --device cpu float64: first 32 blocks {s_first:.1f} "
        f"dB, last 32 {s_last:.1f} dB; vs the float64 OraclePipeline (first "
        f"2 blocks) {s_or:.1f} dB; launches {counts}")
    check(min(s_first, s_last) > BAR_F64_DB and s_or > BAR_ORACLE_DB,
          "cli float64 below its bars")
    report("float64", phases, CAPTURE_BLOCKS, BB, smi)
    for name, extra in (("continuous", []), ("continuous -q 1", ["-q", "1"])):
        phases, _ = run_cli(cap, out, ["--profile", "continuous", *extra])
        counts = launch_counts(phases)
        check(not any(counts.values()), f"cli {name} launched kernels: "
              f"{counts}")
        check(phases["graph"] is True and phases["graph_s"] is not None,
              f"cli {name}: graph {phases['graph']}, graph_s "
              f"{phases['graph_s']}")
        audio = np.fromfile(out, dtype=np.float32)
        n = CAPTURE_BLOCKS + 1          # the tail, padded
        check(audio.shape == (n * (BB // 4),), f"cli {name}: "
              f"{audio.shape[0]} floats, want {n} blocks")
        check(bool(np.all(np.isfinite(audio))), f"cli {name}: non-finite")
        audio = audio.reshape(n, BB // 4)
        s_first = snr_db(continuous_plain(cap, 0, 32, extra), audio[:32])
        s_last = snr_db(continuous_plain(cap, n - 32, 32, extra), audio[-32:])
        say(f"cli {name} vs the --device cpu continuous stream: first 32 "
            f"blocks {s_first:.1f} dB, last 32 (the padded tail's included) "
            f"{s_last:.1f} dB; launches {counts}")
        check(min(s_first, s_last) > BAR_KERNEL_DB,
              f"cli {name} below {BAR_KERNEL_DB} dB")
        report(name, phases, n, BB, smi)
        if name == "continuous":
            out.rename(work / "out.cont.raw")     # for phase 4e
    out.unlink()


def phase_resume(work: Path, cap: Path, smi: str) -> None:
    """Phase 4c: --checkpoint on the first 512 blocks, then --resume on the
    whole capture, against phase 4's uninterrupted runs: q0 (K1) and -q 1
    (K4)."""
    ck = work / "ck.npz"
    rel = lambda p: os.path.relpath(p, REPO)  # noqa: E731
    for name, extra, kernel in (("q0", [], "fused_nbfm"),
                                ("q1", ["-q", "1"], "fused_nbfm_q1")):
        first = RESUME_BLOCKS[name]
        part = work / "first.iq"
        with open(cap, "rb") as f, open(part, "wb") as g:
            g.write(f.read(first * BB))
        out_a, out_b = work / "a.raw", work / "b.raw"
        ph_a, _ = run_cli(part, out_a, [*extra, "--checkpoint", rel(ck),
                                        "--checkpoint-every", "64"])
        saved = np.load(ck)
        meta = json.loads(bytes(saved["__meta__"]))
        check((meta["byte_offset"], meta["blocks"]) == (first * BB, first),
              f"resume {name}: checkpoint at {meta}")
        off_a = saved[".iq_off"].copy()
        ph_b, _ = run_cli(cap, out_b, [*extra, "--checkpoint", rel(ck),
                                       "--resume"])
        for ph in (ph_a, ph_b):
            check(launch_counts(ph)[f"{kernel}_launches"] > 0,
                  f"resume {name}: {kernel} was not launched")
        joined = np.concatenate([np.fromfile(out_a, np.float32),
                                 np.fromfile(out_b, np.float32)])
        want = np.fromfile(work / f"out.{name}.raw", np.float32)
        check(joined.shape == want.shape, f"resume {name}: {joined.shape} "
              f"floats, want {want.shape}")
        if name == "q0":
            check(np.array_equal(joined, want),
                  "resume q0: joined output differs from phase 4's run")
            verdict = "equal to phase 4's run byte for byte"
        else:
            s_db = snr_db(want, joined)
            d = max(float(np.abs(off_a - q1_offset_after(cap, first)).max()),
                    float(np.abs(np.load(ck)[".iq_off"] - q1_offset_after(
                        cap, CAPTURE_BLOCKS)).max()))
            check(s_db > BAR_KERNEL_DB and d < BAR_OFFSET,
                  f"resume q1: {s_db:.1f} dB, offsets {d:.3g}")
            verdict = (f"{s_db:.1f} dB against phase 4's run; saved offsets "
                       f"within {d:.3g} of the plain tracker's")
        say(f"resume {name}: {first} blocks with --checkpoint-every 64, "
            f"then --resume: {verdict}; launches {launch_counts(ph_a)} and "
            f"{launch_counts(ph_b)}")
        report(f"resume {name} (first run)", ph_a, first, BB, smi)
        report(f"resume {name} (resumed)", ph_b, CAPTURE_BLOCKS - first, BB,
               smi)
        for p in (part, out_a, out_b, ck):      # out.<name>.raw: phase 4e
            p.unlink()


def phase_resume_bank(work: Path, smi: str) -> None:
    """Phase 4c: bank4's first 80 of 174 blocks (8 calls of 10) with
    --checkpoint, then --resume appending to the same channel files,
    against phase 4b's uninterrupted run."""
    ck = work / "ck.npz"
    rel = lambda p: os.path.relpath(p, REPO)  # noqa: E731
    nch, n_bytes, _, _ = BANK_RUNS["bank4"]
    bcap = work / "bank4.iq"
    bb = 2 * int(0.25 * nch * CR)
    first = RESUME_BLOCKS["bank4"]
    part = work / "first.iq"
    with open(bcap, "rb") as f, open(part, "wb") as g:
        g.write(f.read(first * bb))
    out = work / "resumed"
    ph_a, _ = run_cli(part, out, [*bank_args(nch), "--checkpoint",
                                  rel(ck), "--checkpoint-every", "64"])
    ph_b, _ = run_cli(bcap, out, [*bank_args(nch), "--checkpoint",
                                  rel(ck), "--resume"])
    for ph in (ph_a, ph_b):
        check(ph["fused_pfb_launches"] > 0,
              "resume bank4: fused_pfb was not launched")
    for c in range(nch):
        got = Path(f"{out}.ch{c}.raw").read_bytes()
        check(got == Path(f"{work / 'bank4'}.ch{c}.raw").read_bytes(),
              f"resume bank4 channel {c}: differs from phase 4b's run")
    say(f"resume bank4: {first} blocks with --checkpoint-every 64, then "
        f"--resume appending to the channel files: every channel equal to "
        f"phase 4b's run byte for byte; fused_pfb launches "
        f"{ph_a['fused_pfb_launches']} and {ph_b['fused_pfb_launches']}")
    report("resume bank4 (first run)", ph_a, first, bb, smi)
    report("resume bank4 (resumed)", ph_b, n_bytes // bb - first, bb, smi)
    for c in range(nch):
        Path(f"{out}.ch{c}.raw").unlink()
        Path(f"{work / 'bank4'}.ch{c}.raw").unlink()
    for p in (part, ck):        # bank4.iq: phase 4f
        p.unlink()


# launch counter (PHASES ``<name>_launches``) -> the symbol of the CUDA
# kernel its wrapper launches, as a trace names it
KERNEL_SYMBOLS = {"fused_nbfm": "fused_nbfm_kernel",
                  "fused_nbfm_cplx": "fused_nbfm_cplx_kernel",
                  "fused_nbfm_q1": "q1_kernel",
                  "fused_pfb": "pfb_(?:big_|wide_|pass1_|pass2_|cluster_)?"
                               "kernel",
                  **{p: f"{p}_kernel" for p in PATCHES}}


def kernel_events(names) -> dict:
    """Of the device kernel events named ``names``: how many are each
    launch counter's kernel, keyed as PHASES keys the counts."""
    return {f"{key}_launches": sum(
        1 for n in names if re.search(rf"(?<![A-Za-z_]){sym}(?![A-Za-z_])",
                                      n))
            for key, sym in KERNEL_SYMBOLS.items()}


def trace_kernel_names(path: str) -> list:
    """The names of a Chrome trace's device kernel events."""
    with open(path) as f:
        return [e["name"] for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "kernel"]


def check_trace_launches(label: str, path: str, phases: dict) -> dict:
    """Hold the kernel events of a --trace file (the run alone: the
    profiler starts after the build, warm-up and capture) equal to the
    run's PHASES launch counts, which a graph replay adds in Python: the
    counts printed are then the device's.  → the counts."""
    names = trace_kernel_names(path)
    got, want = kernel_events(names), launch_counts(phases)
    check(got == want, f"{label}: kernel events {got} in the trace, PHASES "
          f"{want}; kernels traced: {sorted(set(names))[:12]}")
    say(f"{label}: kernel events in the trace equal the PHASES launches "
        f"{got}")
    return got


def trace_stats(path: str) -> dict:
    """Device busy and idle share of a --trace file over its span (first
    to last event), its longest idle gaps, and the first chunk's split."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    check(bool(xs), f"trace {path}: no events")
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(bool(dev), f"trace {path}: no device events")
    t0 = min(e["ts"] for e in xs)
    t1 = max(e["ts"] + e["dur"] for e in xs)
    merged = [list(dev[0])]
    for a, b in dev[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    by_cat = {}
    for e in xs:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + e["dur"]
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i] - t0)
                   for i in range(0, len(edges), 2)), reverse=True)
    spans = sorted((e["ts"], e["dur"], e["name"]) for e in xs
                   if e.get("cat") == "user_annotation")
    first = {}
    for ts, dur, name in spans:
        first.setdefault(name, (round((ts - t0) / 1e3, 3),
                                round(dur / 1e3, 3)))
    # the first chunk's step: its longest host operations, and the device
    # time inside it
    s0 = next(((ts, ts + dur) for ts, dur, n in spans if n == "step"),
              (t0, t0))
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
           if e.get("cat") in ("cpu_op", "user_annotation")
           and e["name"] not in first and s0[0] <= e["ts"] < s0[1]]
    outer = sorted(((b - a, n) for a, b, n in ops
                    if not any(a2 <= a and b <= b2 and (a2, b2) != (a, b)
                               for a2, b2, _ in ops)), reverse=True)
    first_step_ops = [(n, round(d / 1e3, 3)) for d, n in outer[:8]]
    first_step_device = sum(min(b, s0[1]) - max(a, s0[0]) for a, b in merged
                            if b > s0[0] and a < s0[1])

    def med(name):
        d = [dur for _, dur, n in spans if n == name]
        return round(float(np.median(d)) / 1e3, 3) if d else None
    return {"span_ms": round((t1 - t0) / 1e3, 3),
            "device_busy_ms": round(busy / 1e3, 3),
            "device_busy_share": busy / (t1 - t0),
            "device_idle_share": 1 - busy / (t1 - t0),
            "device_events": len(dev),
            "device_ms_by_kind": {k: round(v / 1e3, 3)
                                  for k, v in sorted(by_cat.items())},
            "longest_idle_gaps_ms_at_ms": [
                (round(g / 1e3, 3), round(at / 1e3, 3)) for g, at in gaps[:5]],
            "first_span_start_and_ms": first,
            "first_step_longest_ops_ms": first_step_ops,
            "first_step_device_ms": round(first_step_device / 1e3, 3),
            "median_span_ms": {n: med(n) for n in first},
            "first_device_event_at_ms": round((dev[0][0] - t0) / 1e3, 3)}


def chunk_breakdown(path: str, top: int = 10) -> dict:
    """Where a --trace file's steady chunks spend their host time: over
    every ``step`` span but the first (which pays first-use set-up), the
    mean span, the mean time per span of each outermost host operation
    (torch ops and CUDA runtime calls) by name, and what no operation
    covers (Python, the wrappers' ctypes calls); with the device's busy
    time over the same spans."""
    with open(path) as f:
        xs = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                   if e.get("cat") == "user_annotation"
                   and e["name"] == "step")[1:]
    check(bool(steps), f"trace {path}: fewer than 2 step spans")
    ops = sorted((e["ts"], -(e["ts"] + e["dur"]), e["name"]) for e in xs
                 if e.get("cat") in ("cpu_op", "cuda_runtime"))
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    by_name, covered, device = {}, 0.0, 0.0
    i = j = 0
    for a0, b0 in steps:
        while i < len(ops) and ops[i][0] < a0:
            i += 1
        end = a0
        while i < len(ops) and ops[i][0] < b0:
            ts, neg_end, name = ops[i]
            i += 1
            if ts >= end:             # outermost: not inside the last one
                end = -neg_end
                by_name[name] = by_name.get(name, 0.0) + (end - ts)
                covered += min(end, b0) - ts
        while j < len(dev) and dev[j][1] <= a0:
            j += 1
        k = j
        while k < len(dev) and dev[k][0] < b0:
            device += min(dev[k][1], b0) - max(dev[k][0], a0)
            k += 1
    n = len(steps)
    total = sum(b - a for a, b in steps)
    return {"chunks": n,
            "step_ms_mean": round(total / n / 1e3, 4),
            "ops_ms_per_chunk": [
                (name, round(t / n / 1e3, 4)) for name, t in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:top]],
            "outer_ops_ms_per_chunk": round(covered / n / 1e3, 4),
            "uncovered_ms_per_chunk": round((total - covered) / n / 1e3, 4),
            "device_ms_in_steps_per_chunk": round(device / n / 1e3, 4)}


def graph_launch_kernels(path: str) -> list:
    """Per ``step`` span of a Chrome trace, in order: the kernel events
    (counted as ``kernel_events`` counts them) of each CUDA-graph launch
    inside it, in launch order, tied to their launch by the trace's
    correlation id."""
    with open(path) as f:
        xs = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                   if e.get("cat") == "user_annotation"
                   and e["name"] == "step")
    launches = sorted((e["ts"], e.get("args", {}).get("correlation"))
                      for e in xs if e["name"].startswith("cudaGraphLaunch"))
    by_corr = {}
    for e in xs:
        if e.get("cat") == "kernel":
            by_corr.setdefault(e.get("args", {}).get("correlation"),
                               []).append(e["name"])
    return [[kernel_events(by_corr.get(c, [])) for ts, c in launches
             if a <= ts < b] for a, b in steps]


def capture_launches(step) -> dict:
    """What one replay of a CapturedStep adds to each launch count, keyed
    as ``kernel_events`` keys them."""
    got = dict.fromkeys(COUNTER_KEYS.values(), 0)
    for c, n in zip(step.counters, step.replay_launches):
        if c.__name__ in COUNTER_KEYS:
            got[COUNTER_KEYS[c.__name__]] += n
    return got


def sharded_inspect(path: str, proc, ph: dict) -> None:
    """``api_run``'s inspection of a traced sharded run: the median
    ``step`` span, the device's idle share and the steady chunks' host
    time (``chunk_breakdown``); with graphs, each mesh position's kernel
    events (those of its captures' graph launches, in the step's order:
    every position's first capture, then under -q 1 every position's
    second) beside the launches its captures counted."""
    stats = trace_stats(path)
    ph["step_ms_median"] = stats["median_span_ms"].get("step")
    ph["median_span_ms"] = stats["median_span_ms"]
    ph["device_idle_share"] = stats["device_idle_share"]
    ph["chunks"] = chunk_breakdown(path)
    if not ph["graph"]:
        return
    step = proc.step
    if hasattr(step, "calls"):              # ShardedStep
        order = [(p, step.calls[p][i]) for p, i in step.order()]
    else:                                   # ChanStep
        order = list(enumerate(step.steps))
    want = [capture_launches(c) for _, c in order]
    replayed = [sp for sp in graph_launch_kernels(path) if sp]
    events, counted = {}, {}
    for sp in replayed:
        for (p, _), got, w in zip(order, sp, want):
            for k in w:
                events.setdefault(str(p), dict.fromkeys(w, 0))[k] += got[k]
                counted.setdefault(str(p), dict.fromkeys(w, 0))[k] += w[k]
    ph["replayed_steps"] = len(replayed)
    ph["graph_launches_per_step"] = sorted({len(sp) for sp in replayed})
    ph["position_kernel_events"] = events
    ph["position_launches"] = counted


def phase_metrics_trace(work: Path, cap: Path, smi: str) -> None:
    """Phase 4c: --metrics and --trace, together, on the default run."""
    out = work / "out.raw"
    tdir = work / "trace"
    phases, err = run_cli(cap, out, ["--metrics", "--trace",
                                     os.path.relpath(tdir, REPO)])
    done = [json.loads(ln) for ln in err.splitlines()
            if ln.startswith("{") and '"stream_done"' in ln]
    check(len(done) == 1 and done[0]["blocks"] == CAPTURE_BLOCKS,
          f"cli --metrics: {done}")
    say(f"cli --metrics: {json.dumps(done[0])}")
    files = sorted(tdir.glob("*.json"))
    check(len(files) == 1, f"cli --trace wrote {files}")
    stats = trace_stats(str(files[0]))
    check_trace_launches("cli --metrics --trace", str(files[0]), phases)
    say(f"cli --trace: TRACE {json.dumps(stats)}")
    say(f"cli --trace: the device is busy {100 * stats['device_busy_share']:.2f}"
        f"% and idle {100 * stats['device_idle_share']:.2f}% of the "
        f"{stats['span_ms']} ms traced ({stats['device_events']} device "
        f"events); longest idle gaps (ms, at ms): "
        f"{stats['longest_idle_gaps_ms_at_ms']}")
    report("--metrics --trace", phases, CAPTURE_BLOCKS, BB, smi)
    out.unlink()
    for f in files:
        f.unlink()


def wbfm_iq(fs: float, start: int, n: int, seed: int, tone: float,
            dev) -> torch.Tensor:
    """uint8 IQ [2n] of a broadcast FM carrier made on the card: 75 kHz
    peak deviation by ``tone`` (0.5) and 3 kHz (0.25), pre-emphasised for
    75 µs as the continuous-time 1 + s·τ (the phase in closed form, so
    pieces from sample ``start`` join), amplitude 0.9 of full scale, plus
    Gaussian noise of 0.01 (about 1.3 LSB rms) from ``seed``."""
    f64 = torch.float64
    t = torch.arange(start, start + n, dtype=f64, device=dev) / fs
    phase = torch.zeros(n, dtype=f64, device=dev)
    for f, a in ((tone, 0.5), (3000.0, 0.25)):
        w = 2 * math.pi * f
        phase += a * ((1 - torch.cos(w * t)) / w
                      + WBFM_TAU * torch.sin(w * t))
    phase *= 2 * math.pi * WBFM_DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    re = 0.9 * torch.cos(phase) + 0.01 * torch.randn(n, generator=g,
                                                     dtype=f64, device=dev)
    im = 0.9 * torch.sin(phase) + 0.01 * torch.randn(n, generator=g,
                                                     dtype=f64, device=dev)
    iq = torch.stack([re, im], dim=-1).reshape(-1)
    return torch.clamp(torch.round(iq * 127 + 127), 0, 255).to(torch.uint8)


def write_wbfm_capture(path: Path, fs: float, n_bytes: int, seed: int,
                       tone: float, dev) -> None:
    piece = 1 << 23
    with open(path, "wb") as f:
        for k, start in enumerate(range(0, n_bytes // 2, piece)):
            n = min(piece, n_bytes // 2 - start)
            f.write(wbfm_iq(fs, start, n, seed + k, tone,
                            dev).cpu().numpy().tobytes())


def wbfm_plain(cap: Path, fs: float, first: int, count: int) -> np.ndarray:
    """The --device cpu receiver (1.0 s blocks, the card's default) on
    blocks [first, first + count) of the capture; from block 0 as the run
    started, else from the block before (its state entering ``first`` is
    then the run's: every history is shorter than a block) → [count, A]."""
    pipe = WbfmPipeline(WbfmConfig(sample_rate=fs, block_seconds=1.0),
                        device="cpu")
    lead = 1 if first else 0
    bb = pipe.block_bytes
    raw = np.fromfile(cap, np.uint8, count=(count + lead) * bb,
                      offset=(first - lead) * bb).reshape(-1, bb)
    st, outs = pipe.init_state(), []
    for blk in raw:
        st, a = pipe.call_u16(st, torch.from_numpy(blk.view(np.uint16)))
        outs.append(a.numpy())
    return np.stack(outs)[lead:]


def tone_at(audio: np.ndarray, rate: float) -> float:
    """The frequency of the audio's strongest spectral line (Hann)."""
    f = np.fft.rfftfreq(len(audio), 1 / rate)
    mag = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    return float(f[np.argmax(mag[3:]) + 3])


def phase_wbfm(work: Path, dev, smi: str) -> dict:
    """Phase 4d: --wbfm at 2.4 Msps (256 MiB) and 2.048 Msps (64 MiB),
    a checkpointed first half then --resume, a traced run, and the station
    bank --wbfm --inputs (4 × 64 MiB) against each station alone."""
    rel = lambda p: os.path.relpath(p, REPO)  # noqa: E731
    results = {}
    for name, (fs, n_bytes) in WBFM_RUNS.items():
        cap = work / f"{name}.iq"
        write_wbfm_capture(cap, fs, n_bytes, 2000, 1000.0, dev)
        pipe = WbfmPipeline(WbfmConfig(sample_rate=fs, block_seconds=1.0),
                            device="cpu")
        bb, A = pipe.block_bytes, pipe.audio_per_block
        nblk = n_bytes // bb
        out = work / f"out.{name}.raw"
        phases, _ = run_cli(cap, out, ["--wbfm", "--iq-rate", f"{fs:.0f}"])
        counts = launch_counts(phases)
        check(phases["blocks"] == nblk and not any(counts.values()),
              f"cli {name}: {phases['blocks']} blocks of {nblk}, launches "
              f"{counts}")
        audio = np.fromfile(out, np.float32)
        check(audio.shape == (nblk * A,), f"cli {name}: {audio.shape[0]} "
              f"floats, want {nblk * A}")
        check(bool(np.all(np.isfinite(audio))), f"cli {name}: non-finite")
        audio = audio.reshape(nblk, A)
        s_first = snr_db(wbfm_plain(cap, fs, 0, 4), audio[:4])
        s_last = snr_db(wbfm_plain(cap, fs, nblk - 4, 4), audio[-4:])
        tone = tone_at(audio[1:].ravel(), pipe.cfg.audio_rate)
        say(f"cli {name}: {nblk} blocks of {bb} bytes (L/M {pipe.chan.L}/"
            f"{pipe.chan.M} then {pipe.audio.L}/{pipe.audio.M}); vs "
            f"--device cpu: first 4 blocks {s_first:.1f} dB, last 4 "
            f"{s_last:.1f} dB; tone at {tone:.2f} Hz")
        check(min(s_first, s_last) > BAR_WBFM_DB,
              f"cli {name} vs --device cpu below {BAR_WBFM_DB} dB")
        check(abs(tone - 1000.0) < 15.0, f"cli {name}: tone at {tone} Hz")
        report(name, phases, nblk, bb, smi)
        results[name] = {"phases": phases, "snr_db": min(s_first, s_last),
                         "msps": nblk * bb / 2 / phases["run_s"] / 1e6}
        if name != "wbfm":
            cap.unlink()
            out.unlink()
    cap, out = work / "wbfm.iq", work / "out.wbfm.raw"
    bb = 2 * int(WBFM_RUNS["wbfm"][0])
    nblk = WBFM_RUNS["wbfm"][1] // bb
    # resume: the first half with checkpoints, then the whole capture
    first, ck, part = nblk // 2, work / "ck.npz", work / "first.iq"
    with open(cap, "rb") as f, open(part, "wb") as g:
        g.write(f.read(first * bb))
    out_a, out_b = work / "a.raw", work / "b.raw"
    ph_a, _ = run_cli(part, out_a, ["--wbfm", "--checkpoint", rel(ck),
                                    "--checkpoint-every", "4"])
    ph_b, _ = run_cli(cap, out_b, ["--wbfm", "--checkpoint", rel(ck),
                                   "--resume"])
    check(out_a.read_bytes() + out_b.read_bytes() == out.read_bytes(),
          "resume wbfm: joined output differs from the uninterrupted run")
    say(f"resume wbfm: {first} blocks with --checkpoint-every 4, then "
        f"--resume: joined output equal to the uninterrupted run byte for "
        f"byte")
    report("resume wbfm (first run)", ph_a, first, bb, smi)
    report("resume wbfm (resumed)", ph_b, nblk - first, bb, smi)
    # the traced run: the device's idle share and the first block's time
    tdir = work / "trace"
    phases, _ = run_cli(cap, out_a, ["--wbfm", "--trace", rel(tdir)])
    files = sorted(tdir.glob("*.json"))
    check(len(files) == 1, f"cli --wbfm --trace wrote {files}")
    stats = trace_stats(str(files[0]))
    check_trace_launches("cli --wbfm --trace", str(files[0]), phases)
    say(f"cli --wbfm --trace: TRACE {json.dumps(stats)}")
    say(f"cli --wbfm --trace: the device is busy "
        f"{100 * stats['device_busy_share']:.2f}% and idle "
        f"{100 * stats['device_idle_share']:.2f}% of the {stats['span_ms']} "
        f"ms traced; first block's step: device "
        f"{stats['first_step_device_ms']} ms, longest host operations "
        f"{stats['first_step_longest_ops_ms']}")
    report("--wbfm --trace", phases, nblk, bb, smi)
    results["wbfm trace"] = stats
    for p in (part, out_a, out_b, out, ck, *files):     # wbfm.iq: phase 4f
        p.unlink()
    results.update(phase_wbfm_stations(work, dev, smi))
    return results


def phase_wbfm_stations(work: Path, dev, smi: str) -> dict:
    """Phase 4d: --wbfm --inputs with 4 station captures of 64 MiB at 2.4
    Msps (tones 700 + 300·c Hz); each station file > 110 dB against that
    station run alone on the card."""
    rel = lambda p: os.path.relpath(p, REPO)  # noqa: E731
    fs, n_bytes = 2.4e6, WBFM_STATION_BYTES
    caps = [work / f"st{c}.iq" for c in range(WBFM_STATIONS)]
    for c, cap in enumerate(caps):
        write_wbfm_capture(cap, fs, n_bytes, 3000 + 100 * c,
                           700.0 + 300.0 * c, dev)
    bb = 2 * int(fs)
    nblk, A = n_bytes // bb, 48000
    prefix = work / "stations"
    phases, _ = run_cli(caps[0], prefix, [
        "--wbfm", "--inputs", ",".join(rel(c) for c in caps)])
    counts = launch_counts(phases)
    check(phases["blocks"] == nblk and phases["stations"] == WBFM_STATIONS
          and not any(counts.values()),
          f"cli wbfm4st: PHASES {json.dumps(phases)}")
    check(not prefix.exists(), "cli wbfm4st: created a file at -o")
    snrs = []
    alone = WbfmStreamProcessor(WbfmConfig(sample_rate=fs), device=dev)
    for c, cap in enumerate(caps):
        got = np.fromfile(f"{prefix}.st{c}.raw", np.float32)
        buf = io.BytesIO()
        with open(cap, "rb") as f:
            alone.run([f], [buf])
        want = np.frombuffer(buf.getvalue(), np.float32)
        check(got.shape == want.shape == (nblk * A,),
              f"cli wbfm4st station {c}: {got.shape} vs {want.shape}")
        check(bool(np.all(np.isfinite(got))),
              f"cli wbfm4st station {c}: non-finite")
        snrs.append(snr_db(want, got))
        check(snrs[-1] > BAR_WBFM_DB, f"cli wbfm4st station {c}: "
              f"{snrs[-1]:.1f} dB against the station alone")
        Path(f"{prefix}.st{c}.raw").unlink()     # st<c>.iq: phase 4f
    say(f"cli wbfm4st: {WBFM_STATIONS} stations x {nblk} blocks; each "
        f"station against the station run alone on the card (through the "
        f"API, in this process): "
        f"{[round(s, 1) for s in snrs]} dB")
    report("wbfm4st", phases, nblk, WBFM_STATIONS * bb, smi)
    return {"wbfm4st": {"phases": phases, "snr_db": min(snrs),
                        "msps": WBFM_STATIONS * nblk * bb / 2
                        / phases["run_s"] / 1e6}}


def phase_mixer(work: Path, dev, smi: str) -> dict:
    """Phase 4d: mixer8, --bank with the 8 half-channel offsets at 1.536
    Msps (the JAX bench row channel_bank_8ch), 0.25 s blocks, a 64 MiB
    capture with FM carriers on 4 channels; against the --device cpu
    pipeline at the bank bars, and its final phasor (the checkpoint's)
    against the CPU recurrence."""
    rel = lambda p: os.path.relpath(p, REPO)  # noqa: E731
    nch, n_bytes, carriers = MIXER_RUN
    offs = [(c - nch // 2 + 0.5) * CR for c in range(nch)]
    cap, out, ck = work / "mixer8.iq", work / "mixer8", work / "ck.npz"
    write_bank_capture(cap, nch, n_bytes, carriers, dev, offsets=offs)
    cfg = ChannelBankConfig(sample_rate=nch * CR, channel_rate=CR,
                            offsets_hz=tuple(offs), block_seconds=0.25)
    pipe = ChannelBankPipeline(cfg, device="cpu")
    check(pipe.method == "mixer", f"mixer8: method {pipe.method}")
    bb, A = pipe.block_bytes, pipe.audio_per_block
    nblk = n_bytes // bb
    phases, _ = run_cli(cap, out, [
        "--bank", ",".join(f"{o:.0f}" for o in offs), "--iq-rate",
        f"{nch * CR:.0f}", "--channel-rate", f"{CR:.0f}", "--checkpoint",
        rel(ck)])
    counts = launch_counts(phases)
    check(phases["blocks"] == nblk and phases["channels"] == nch
          and not any(counts.values()),
          f"cli mixer8: PHASES {json.dumps(phases)}")
    audio = np.stack([np.fromfile(f"{out}.ch{c}.raw", np.float32)
                      for c in range(nch)])
    check(audio.shape == (nch, nblk * A), f"cli mixer8: {audio.shape}")
    check(bool(np.all(np.isfinite(audio))), "cli mixer8: non-finite")
    taps = np.asarray(pipe.audio.taps, np.float64)
    raw = np.fromfile(cap, np.uint8)
    err = 0.0
    for b0, b1, c0 in ((0, 3, 0), (nblk - 4, nblk, nblk - 2)):
        st = pipe.init_state()
        for _ in range(b0):
            st = st._replace(phasor=pipe.advance_phasor(st.phasor))
        blocks = torch.from_numpy(raw[b0 * bb:b1 * bb].reshape(-1, bb))
        _, plain = pipe.call_u16(st, blocks)
        err = max(err, bank_compare(
            f"cli mixer8 blocks {c0}-{c0 + 1} vs --device cpu pipeline",
            audio[:, b0 * A:b1 * A], plain.numpy().astype(np.float64), taps,
            carriers, (c0 - b0) * A, (c0 - b0 + 2) * A))
    ph = pipe.init_state().phasor
    for _ in range(nblk):
        ph = pipe.advance_phasor(ph)
    d_ph = float(np.abs(np.load(ck)[".phasor"] - ph.numpy()).max())
    say(f"cli mixer8: final phasor within {d_ph:.3g} of the CPU "
        f"recurrence's after {nblk} blocks")
    check(d_ph < BAR_PHASOR, f"cli mixer8: phasor off by {d_ph:.3g}")
    report("mixer8", phases, nblk, bb, smi)
    ck.unlink()                     # mixer8.iq: phase 4f
    for c in range(nch):
        Path(f"{out}.ch{c}.raw").unlink()
    return {"mixer8": {"phases": phases, "max_err": err, "phasor": d_ph,
                       "msps": nblk * bb / 2 / phases["run_s"] / 1e6}}


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0 (in this process)."""
    for fn in (fused_nbfm, fused_nbfm_cplx, fused_nbfm_q1, fused_nbfm_q1_seq,
               dma_floor, fused_pfb_demod, *PATCH_FNS):
        fn.launches = 0


def api_launches() -> dict:
    return {f"{fn.__name__}_launches": fn.launches
            for fn in (fused_nbfm, fused_nbfm_cplx, fused_nbfm_q1,
                       fused_pfb_demod, *PATCH_FNS)}


def run_cli_ranks(cap: Path, out: Path, extra: list) -> list:
    """The CLI as ranks 0 and 1 of one torch.distributed group on this
    card (--distributed, the DEMODULATOR_TPU_* variables): [PHASES of each
    rank].  Both are killed if either outlives its time limit."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "demodulator_tpu_torch",
           "-i", os.path.relpath(cap, REPO), "-o", os.path.relpath(out, REPO),
           *CLI_ARGS, *extra, "--distributed"]
    procs = []
    t0 = time.perf_counter()
    for r in (0, 1):
        env = {**os.environ, "DEMODULATOR_TPU_TORCH_PHASES": "1",
               "DEMODULATOR_TPU_COORDINATOR": f"localhost:{port}",
               "DEMODULATOR_TPU_NUM_PROCESSES": "2",
               "DEMODULATOR_TPU_PROCESS_ID": str(r)}
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE))
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=600)[1])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            check(False, f"{' '.join(cmd)}: a rank timed out")
    wall = time.perf_counter() - t0
    out_phases = []
    for r, (p, err) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"{' '.join(cmd)} rank {r} exited "
              f"{p.returncode}:\n{err[-4000:]}")
        lines = [ln for ln in err.splitlines() if ln.startswith("PHASES ")]
        check(len(lines) == 1, f"rank {r}: no PHASES line:\n{err}")
        ph = json.loads(lines[0][len("PHASES "):])
        ph["wall_s"] = round(wall, 3)
        out_phases.append(ph)
    return out_phases


def phase_sharded(work: Path, cap: Path, bank64: dict, dev, smi: str) -> dict:
    """Phase 4e: the parallel layer on the card, at N = 1 and 2 positions
    of the one card (one H100 shows no scaling; the runs show that the
    sharded paths launch their kernels and agree with the unsharded ones).
    Phase 4's capture and outputs (``out.q0``, ``out.q2L``, ``out.q1``)
    and 4c's continuous output (``out.cont``) are the references; → the
    kernels' launches in the replayed (1, 1) runs and the bank64 CLI
    run."""
    launches = {}
    out = work / "sharded.raw"

    def ref(name):
        return np.fromfile(work / f"out.{name}.raw", np.float32)

    def verdict(name, got, want, equal):
        check(got.shape == want.shape, f"{name}: {got.shape} floats, want "
              f"{want.shape}")
        check(bool(np.all(np.isfinite(got))), f"{name}: non-finite")
        if equal:
            check(np.array_equal(got, want), f"{name}: differs from the "
                  f"unsharded run")
            return "equal to the unsharded run byte for byte"
        s_db = snr_db(want, got)
        check(s_db > BAR_KERNEL_DB, f"{name}: {s_db:.1f} dB")
        return f"{s_db:.1f} dB against the unsharded run"

    launches.update(phase_sharded_modes(work, cap, ref, verdict, dev, smi))

    # two processes on the one card: ranks share it, so gloo
    for name, extra, ref_name, equal in (
            ("--shard-time 2 --distributed", [], "q0", True),
            ("--shard-time 2 --distributed -q 1", ["-q", "1"], "q1", False),
            ("--shard-time 2 --distributed --shared-out", ["--shared-out"],
             "q0", True)):
        phs = run_cli_ranks(cap, out, [*extra, "--shard-time", "2"])
        for r, ph in enumerate(phs):
            counts = launch_counts(ph)
            kernel = "fused_nbfm_q1" if "-q" in extra else "fused_nbfm"
            check(ph["backend"] == "gloo" and ph["shards"] == 2
                  and counts[f"{kernel}_launches"] > 0
                  and not any(counts[f"{p}_launches"] for p in PATCHES),
                  f"cli {name} rank {r}: PHASES {json.dumps(ph)}")
            say(f"cli {name} rank {r}: backend {ph['backend']}, launches "
                f"{counts}")
        v = verdict(f"cli {name}", np.fromfile(out, np.float32),
                    ref(ref_name), equal)
        say(f"cli {name}: rank 0's output {v}")
        report(f"{name} rank 0", phs[0], phs[0]["blocks"], BB, smi)

    # --bank --shard-chan 1 on bank64: K6 on the one chan position
    nch = BANK_RUNS["bank64"][0]
    bcap, prefix = work / "bank64.iq", work / "bank64s"
    ph, _ = run_cli(bcap, prefix, [*bank_args(nch), "--shard-chan", "1"])
    counts = launch_counts(ph)
    check(counts["fused_pfb_launches"] == bank64["launches"],
          f"cli bank64 --shard-chan 1: launches {counts}")
    check(channel_digests(prefix, nch) == bank64["digests"],
          "cli bank64 --shard-chan 1: differs from phase 4b's run")
    launches[("fused_pfb", "bank64")] = counts["fused_pfb_launches"]
    say(f"cli bank64 --shard-chan 1: every channel equal to phase 4b's run "
        f"byte for byte; launches {counts}")
    report("bank64 --shard-chan 1", ph, ph["blocks"],
           2 * int(0.25 * nch * CR), smi)
    for c in range(nch):
        Path(f"{prefix}.ch{c}.raw").unlink()
    phase_sharded_banks(work, dev, smi)     # bank64.iq: phase 4f
    for name in ("q0", "q1", "q2L", "cont"):
        (work / f"out.{name}.raw").unlink()
    out.unlink()
    return launches


def sharded_ways(name: str, make, paths: list, nout: int, work: Path,
                 smi: str, tpaths: list | None = None) -> tuple:
    """A sharded processor in this process, captured (its full chunks
    replaying CUDA graphs, a segment each a position) and eager
    (DEMODULATOR_TPU_TORCH_GRAPHS=0), each on ``paths`` and, traced, on
    ``tpaths`` (default ``paths``), the traced run repeated (at most 3
    times) while its kernel events fall short of its counts: the counts
    equal both ways and to the trace's kernel events, per mesh position
    for the graphs.  Prints one ``SHARDED {json}`` line: graph_s,
    stream_s, run_s, the traced median ``step`` span, the launches (per
    position with graphs) and the steady chunks' host time, both ways.
    → ({way: phases}, {way: the outputs' bytes})."""
    ways = (("graph", True), ("eager", False))
    runs, data = {}, {}
    for way, graphs in ways:
        runs[way], data[way] = api_run(make, paths, nout, graphs)
        check(runs[way]["graph"] is graphs,
              f"{name} {way}: graph {runs[way]['graph']}")
        for attempt in range(3):
            tr, _ = api_run(make, tpaths or paths, nout, graphs,
                            work / "4e.json", sharded_inspect)
            events = tr["kernel_events"]
            counted = {COUNTER_KEYS[k.replace("_launches", "")]: v
                       for k, v in tr["launches"].items()}
            if events == counted or any(events[k] > counted[k]
                                        for k in counted):
                break
            say(f"{name} {way}: traced run {attempt}: kernel events "
                f"{events} short of the launches counted {counted}")
        check(events == counted, f"{name} {way}: kernel events {events} in "
              f"the trace, launches counted {counted}")
        if tr["graph"]:
            check(tr["position_kernel_events"] == tr["position_launches"]
                  and tr["replayed_steps"] > 0,
                  f"{name}: kernel events per position "
                  f"{tr['position_kernel_events']}, counted "
                  f"{tr['position_launches']} over {tr['replayed_steps']} "
                  f"replayed steps")
        runs[way + " traced"] = tr
    check(runs["graph"]["launches"] == runs["eager"]["launches"],
          f"{name}: launches {runs['graph']['launches']} replayed, "
          f"{runs['eager']['launches']} eager")
    line = {"mode": name, "card": smi}
    for way, _ in ways:
        ph, tr = runs[way], runs[way + " traced"]
        line[way] = {
            **{k: ph[k] for k in ("graph", "graph_s", "build_s",
                                  "first_output_s", "stream_s", "run_s",
                                  "blocks", "launches")},
            "traced": {k: tr.get(k) for k in (
                "blocks", "step_ms_median", "median_span_ms",
                "device_idle_share",
                "kernel_events", "position_kernel_events",
                "graph_launches_per_step", "chunks")}}
    say("SHARDED " + json.dumps(line))
    return runs, data


def phase_sharded_modes(work: Path, cap: Path, ref, verdict, dev,
                        smi: str) -> dict:
    """Phase 4e, in this process: ``ShardedStreamProcessor`` in each mode
    of SHARDED_API (2 blocks a position, as the CLI's --shard-time) on
    phase 4's capture, captured and eager, at the bars of the unsharded
    runs (``verdict``), the two ways byte-equal (-q 1: > 110 dB, K4's
    look-back order depends on timing), each traced on the capture's
    first TRACE_BLOCKS blocks (``sharded_ways``; the TRACE and CHUNKS
    lines of the -q 1 (1, 1) runs).  → the (1, 1) graph runs' launches,
    keyed (kernel, the run held to)."""
    launches = {}
    tcap = work / "cap_trace.iq"
    with open(cap, "rb") as f:
        tcap.write_bytes(f.read(TRACE_BLOCKS * BB))
    for name, (shape, extra, kernel, ref_name, equal) in \
            SHARDED_API.items():
        continuous = "--profile" in extra
        cfg = pipe_of([] if continuous else extra).cfg
        if continuous:
            cfg.profile = "continuous"
        mesh = make_demod_mesh(*shape, devices=[dev] * shape[0])
        runs, data = sharded_ways(
            f"api {name}", lambda cfg=cfg, mesh=mesh: ShardedStreamProcessor(
                cfg, mesh=mesh, device=dev), [cap], 1, work, smi, [tcap])
        patch = SHARDED_PATCH.get(ref_name)
        for way, (out,) in data.items():
            counts = runs[way]["launches"]
            # its kernel, and K3's patch kernel as often (K1, K4: none)
            nk = counts[f"{kernel}_launches"] if kernel else 0
            patches = sum(counts[f"{p}_launches"] for p in PATCHES)
            check(kernel is None and not any(counts.values())
                  or kernel is not None and nk > 0
                  and patches == (nk if patch else 0)
                  and (not patch or counts[f"{patch}_launches"] == nk),
                  f"api {name} {way}: launches {counts}")
            v = verdict(f"api {name} {way}", np.frombuffer(out, np.float32),
                        ref(ref_name), equal)
            ph = runs[way]
            say(f"api {name} {way}: {v}; launches {counts}; "
                f"{ph['blocks'] * BB / 2 / ph['run_s'] / 1e6:.1f} Msamples/s "
                f"of complex input (run {ph['run_s']} s, first output "
                f"{ph['first_output_s']} s, graph_s {ph['graph_s']}) on {smi}")
        g, e = (np.frombuffer(data[w][0], np.float32)
                for w in ("graph", "eager"))
        if equal or kernel != "fused_nbfm_q1":
            check(np.array_equal(g, e), f"api {name}: graph and eager "
                  f"differ")
        else:
            s_db = snr_db(e, g)
            check(s_db > BAR_KERNEL_DB, f"api {name}: graph vs eager "
                  f"{s_db:.1f} dB")
        if shape == (1, 1) and kernel is not None:
            for kn in (kernel, patch) if patch else (kernel,):
                launches[(kn, ref_name)] = \
                    runs["graph"]["launches"][f"{kn}_launches"]
        if name == "(1, 1) -q 1":
            for way in ("graph", "eager"):
                tr = runs[way + " traced"]
                say(f"api {name} {way} traced: CHUNKS "
                    f"{json.dumps(tr['chunks'])}")
        del data
    tcap.unlink()
    return launches


def phase_sharded_banks(work: Path, dev, smi: str) -> None:
    """Phase 4e: mixer8 and a 4-station WBFM bank on a (1, 2) mesh of this
    card (each position half the channels or stations, its own capture)
    through the API, captured and eager (``sharded_ways``, byte-equal),
    against the same bank unsharded on the card: the mixer at the bank
    bars of phase 4, the stations > 110 dB (the decimator's torch.matmul
    takes other shapes)."""
    mesh = make_demod_mesh(1, 2, devices=[dev] * 2)
    nch, _, carriers = MIXER_RUN
    offs = [(c - nch // 2 + 0.5) * CR for c in range(nch)]
    cap = work / "mixer8s.iq"
    write_bank_capture(cap, nch, 16 << 20, carriers, dev, offsets=offs)
    cfg = ChannelBankConfig(sample_rate=nch * CR, channel_rate=CR,
                            offsets_hz=tuple(offs), block_seconds=0.25)

    def bank(m):
        return BankStreamProcessor(cfg, chunk_blocks=5, device=dev, mesh=m)
    fs, C = 2.4e6, WBFM_STATIONS
    caps = [work / f"sts{c}.iq" for c in range(C)]
    for c, p in enumerate(caps):
        write_wbfm_capture(p, fs, 16 << 20, 5000 + 100 * c,
                           700.0 + 300.0 * c, dev)
    wcfg = WbfmConfig(sample_rate=fs)

    def stations(m):
        return WbfmStreamProcessor(wcfg, stations=C, device=dev, mesh=m)
    # bytes a block of each run reads (all its inputs)
    block_bytes = {"mixer8": ChannelBankPipeline(cfg, device="cpu")
                   .block_bytes,
                   "wbfm4st": C * WbfmPipeline(wcfg, device="cpu")
                   .block_bytes}
    for name, make, paths, nout in (("mixer8", bank, [cap], nch),
                                    ("wbfm4st", stations, caps, C)):
        alone, alone_out = api_run(lambda: make(None), paths, nout, True)
        want = [np.frombuffer(b, np.float32) for b in alone_out]
        runs, data = sharded_ways(f"api {name} (1, 2)", lambda: make(mesh),
                                  paths, nout, work, smi)
        check(data["graph"] == data["eager"],
              f"api {name} (1, 2): graph and eager differ")
        got = [np.frombuffer(b, np.float32) for b in data["graph"]]
        for key, ph in (("unsharded", alone), ("sharded", runs["graph"]),
                        ("sharded eager", runs["eager"])):
            msps = ph["blocks"] * block_bytes[name] / 2 / ph["run_s"] / 1e6
            say(f"api {name} {key}: {ph['blocks']} blocks, {msps:.1f} "
                f"Msamples/s of complex input (run {ph['run_s']} s, graph "
                f"{ph['graph']}) on {smi}")
        if name == "mixer8":
            taps = np.asarray(ChannelBankPipeline(cfg, device="cpu").audio
                              .taps, np.float64)
            bank_compare("api mixer8 (1, 2) vs unsharded", np.stack(got),
                         np.stack(want).astype(np.float64), taps, carriers,
                         0, got[0].shape[0])
            continue
        snrs = [snr_db(w, g) for w, g in zip(want, got)]
        say(f"api wbfm4st (1, 2) vs unsharded: "
            f"{[round(x, 1) for x in snrs]} dB")
        check(all(len(g) > 0 and np.all(np.isfinite(g)) for g in got)
              and min(snrs) > BAR_WBFM_DB, f"api wbfm4st (1, 2): {snrs}")
    for p in (cap, *caps):
        p.unlink()


# phase 4f: every mode whose full chunks replay a CUDA graph -> (kind,
# capture file, the kernel whose launches it counts or None, launches
# per run); NBFM modes on phase 4's capture with their CLI options
GRAPH_NBFM = {"q0": ([], False, "float32"), "fast": ([], True, "float32"),
              "-L": (["-L", "12500"], False, "float32"),
              "-q 2": (["-q", "2"], False, "float32"),
              "-q 2 -L": (["-q", "2", "-L", "12500"], False, "float32"),
              "-q 1": (["-q", "1"], False, "float32"),
              "-q 1 -L": (["-q", "1", "-L", "12500"], False, "float32"),
              "float64": ([], False, "float64"),
              "continuous": ([], False, "float32"),
              "continuous -q 1": (["-q", "1"], False, "float32")}
GRAPH_KERNELS = {"q0": "fused_nbfm", "fast": "fused_nbfm",
                 "-L": "fused_nbfm_cplx", "-q 2": "fused_nbfm_cplx",
                 "-q 2 -L": "fused_nbfm_cplx", "-q 1": "fused_nbfm_q1",
                 "bank64": "fused_pfb_demod", "bank4": "fused_pfb_demod",
                 "bank8192": "fused_pfb_demod"}
# modes whose eager run is traced too (K6's four-step route: its kernel
# events held to its launches eagerly as in the graph)
GRAPH_TRACE_EAGER = ("bank8192",)
# mode -> the patch kernel after K3 (K1 and K4 carry their head rows)
GRAPH_PATCHES = {"-L": "patch_cplx1", "-q 2": "patch_cplx1",
                 "-q 2 -L": "patch_cplx2"}


def graph_modes(work: Path, dev) -> dict:
    """Phase 4f's modes: name -> (make() -> processor, input paths, output
    count, blocks, launches of its GRAPH_KERNELS kernel)."""
    modes = {}
    for name, (extra, fast, precision) in GRAPH_NBFM.items():
        cfg = pipe_of(extra).cfg
        cfg.precision = precision
        if name.startswith("continuous"):
            cfg.profile = "continuous"      # the tail padded to a block
        nblk = CAPTURE_BLOCKS + (cfg.profile == "continuous")
        modes[name] = (lambda cfg=cfg, fast=fast:
                       StreamProcessor(cfg, fast_atan2=fast, chunk_blocks=NB,
                                       device=dev),
                       [work / "cap.iq"], 1, nblk, -(-nblk // NB))
    banks = {"bank64": (bank_offsets(64), 1), "bank4": (bank_offsets(4), 10),
             "mixer8": ([(c - 4 + 0.5) * CR for c in range(8)], 5)}
    for name, (offs, per_call) in banks.items():
        cfg = ChannelBankConfig(sample_rate=len(offs) * CR, channel_rate=CR,
                                offsets_hz=tuple(offs), block_seconds=0.25)
        cap = work / f"{name}.iq"
        nblk = cap.stat().st_size // (2 * int(0.25 * len(offs) * CR))
        modes[name] = (lambda cfg=cfg, per_call=per_call:
                       BankStreamProcessor(cfg, chunk_blocks=per_call,
                                           device=dev),
                       [cap], len(offs), nblk, -(-nblk // per_call))
    name, nch, listed = STEP_RUN[:3]
    cfg = ChannelBankConfig(
        sample_rate=nch * NARROW_CR, channel_rate=NARROW_CR,
        offsets_hz=tuple(bank_offsets(nch, NARROW_CR, listed)),
        lowpass_out=float(NARROW_LOWPASS), block_seconds=0.25)
    pipe = ChannelBankPipeline(cfg, device="cpu")
    cap = work / f"{name}.iq"
    nblk = cap.stat().st_size // pipe.block_bytes
    modes[name] = (lambda: BankStreamProcessor(cfg, chunk_blocks=1,
                                               device=dev),
                   [cap], listed, nblk,
                   nblk * launches_per_call(nch, pipe.block_complex))
    wcfg = WbfmConfig(sample_rate=2.4e6)
    bb = 2 * int(2.4e6)
    modes["wbfm"] = (lambda: WbfmStreamProcessor(wcfg, device=dev),
                     [work / "wbfm.iq"], 1, WBFM_RUNS["wbfm"][1] // bb, 0)
    modes["--inputs"] = (lambda: WbfmStreamProcessor(
        wcfg, stations=WBFM_STATIONS, device=dev),
        [work / f"st{c}.iq" for c in range(WBFM_STATIONS)], WBFM_STATIONS,
        WBFM_STATION_BYTES // bb, 0)
    return modes


@contextlib.contextmanager
def warm_profile(*activities):
    """A torch.profiler session that records only after a warm-up step on
    device work of its own (kernels, copies both ways): a session started
    cold on an H100 lost the device events of its first milliseconds, a
    graph replay's first kernels among them."""
    from torch.profiler import profile, schedule
    with profile(activities=list(activities),
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        x = torch.ones(1 << 16, device="cuda")
        for _ in range(8):
            x.add_(1)
            x.copy_(x.cpu().pin_memory(), non_blocking=True)
        torch.cuda.synchronize()
        time.sleep(0.05)
        prof.step()              # warmed up: record from here
        yield prof


def api_run(make, paths: list, nout: int, graphs: bool,
            trace: Path | None = None, inspect=None) -> tuple[dict, list]:
    """One run through the API in this process: the processor built (its
    graph captured) with DEMODULATOR_TPU_TORCH_GRAPHS set from ``graphs``,
    then run on the inputs with every launch count at 0; with ``trace``
    under torch.profiler (host and device, as the CLI's --trace), its
    Chrome trace written there, given to ``inspect(path, processor,
    phases)`` when given, read and deleted → (its phases as the CLI's
    PHASES names them, and wall_s = build_s + run_s; with ``trace`` the
    kernel events of each launch counter in ``kernel_events``; the
    outputs' bytes)."""
    from torch.profiler import ProfilerActivity
    os.environ["DEMODULATOR_TPU_TORCH_GRAPHS"] = "1" if graphs else "0"
    try:
        t0 = time.perf_counter()
        proc = make()
        build_s = time.perf_counter() - t0
    finally:
        os.environ.pop("DEMODULATOR_TPU_TORCH_GRAPHS")
    outs = [io.BytesIO() for _ in range(nout)]
    fins = [open(p, "rb") for p in paths]
    reset_launches()
    tracing = (contextlib.nullcontext() if trace is None else warm_profile(
        ProfilerActivity.CPU, ProfilerActivity.CUDA))
    try:
        with tracing as prof:
            t1 = time.perf_counter()
            if isinstance(proc, (StreamProcessor, ShardedStreamProcessor)):
                blocks = proc.run(fins[0], outs[0])
            elif isinstance(proc, BankStreamProcessor):
                blocks = proc.run(fins[0], outs)
            else:
                blocks = proc.run(fins, outs)
            torch.cuda.synchronize()
    finally:
        for f in fins:
            f.close()
    run_s = time.perf_counter() - t1
    first = proc.first_output_s or 0.0
    ph = {"build_s": round(build_s, 3), "graph": proc.graph,
          "graph_s": (None if proc.graph_s is None
                      else round(proc.graph_s, 3)),
          "first_output_s": round(first, 3),
          "stream_s": round(run_s - first, 3), "run_s": round(run_s, 3),
          "wall_s": round(build_s + run_s, 3), "blocks": blocks,
          "launches": api_launches()}
    if trace is not None:
        prof.export_chrome_trace(str(trace))
        ph["kernel_events"] = kernel_events(trace_kernel_names(str(trace)))
        if inspect is not None:
            inspect(str(trace), proc, ph)
        trace.unlink()
    return ph, [o.getvalue() for o in outs]


def phase_graphs(work: Path, dev, smi: str) -> dict:
    """Phase 4f: every captured mode in this process through the API, on
    the captures of phases 4, 4b and 4d, three ways: full chunks replayed
    as a CUDA graph, eagerly (DEMODULATOR_TPU_TORCH_GRAPHS=0), and
    replayed under torch.profiler (again, at most 3 times in all, while
    its kernel events fall short of its counts), and a mode of
    GRAPH_TRACE_EAGER eagerly under it too; all byte for byte equal (-q
    1: > 110 dB, K4's look-back order depends on timing), with equal and
    exact launch counts, each traced run's kernel events equal to its
    counts; a GRAPHS line per mode.  Deletes the captures.  → name ->
    {run: phases}."""
    results = {}
    for name, (make, paths, nout, nblk, launches) in graph_modes(
            work, dev).items():
        runs, data, events = {}, {}, {}
        for run, graphs in (("graph", True), ("eager", False)):
            runs[run], data[run] = api_run(make, paths, nout, graphs)
        traced = {"traced": True}
        if name in GRAPH_TRACE_EAGER:
            traced["eager traced"] = False
        for run, graphs in traced.items():
            for attempt in range(3):
                # the profiler can lose records, never add them: a run whose
                # kernel events fall short of its counts is traced again
                runs[run], data[run] = api_run(make, paths, nout, graphs,
                                               work / "4f.json")
                ev = runs[run]["kernel_events"]
                counted = {k.replace("fused_pfb_demod", "fused_pfb"): v
                           for k, v in runs[run]["launches"].items()}
                if ev == counted or any(ev[k] > counted[k] for k in counted):
                    break
                say(f"graphs {name}: {run} run {attempt}: kernel events "
                    f"{ev} short of the launches counted {counted}")
            check(ev == counted, f"graphs {name}: kernel events {ev} in the "
                  f"{run} run, launches counted {counted}")
            events[run] = ev
        for run, ph in runs.items():
            check(ph["graph"] is ("eager" not in run),
                  f"graphs {name} {run}: graph {ph['graph']}")
            check(ph["blocks"] == nblk, f"graphs {name} {run}: "
                  f"{ph['blocks']} blocks, want {nblk}")
            kernel = GRAPH_KERNELS.get(name)
            want = {k: 0 for k in runs["graph"]["launches"]}
            if kernel is not None:
                want[f"{kernel}_launches"] = launches
            if name in GRAPH_PATCHES:       # its patch beside its kernel
                want[f"{GRAPH_PATCHES[name]}_launches"] = \
                    want[f"{kernel}_launches"]
            check(ph["launches"] == want, f"graphs {name} {run}: launches "
                  f"{ph['launches']}, want {want}")
        g = data["graph"]
        check(all(len(b) > 0 for b in g), f"graphs {name}: empty output")
        for run in data:
            if run == "graph":
                continue
            if name == "-q 1":
                a = np.frombuffer(g[0], np.float32)
                b = np.frombuffer(data[run][0], np.float32)
                s_db = snr_db(b, a) if a.shape == b.shape else 0.0
                check(s_db > BAR_KERNEL_DB,
                      f"graphs -q 1: graph vs {run} {s_db:.1f} dB")
                verdict = f"{s_db:.1f} dB (K4's look-back order)"
            else:
                check(data[run] == g, f"graphs {name}: graph and {run} "
                      f"differ")
                verdict = "byte-equal"
        for run in traced:
            runs.pop(run)
        say(f"graphs {name}: the {', '.join(['eager', *traced])} runs "
            f"against the graph run: {verdict}; launches "
            f"{runs['graph']['launches']}, kernel events {events}")
        if name == "q0":
            # the cold comparison: the CLI, each run a new process (every
            # op's first use in it), eager and with graphs in turns
            out = work / "turn.raw"
            for turn, graphs in enumerate((False, True, True, False)):
                ph, _ = run_cli(paths[0], out, [], graphs=graphs)
                check(ph["graph"] is graphs and out.read_bytes() == g[0],
                      f"graphs q0: CLI turn {turn}: graph {ph['graph']}, or "
                      f"its output differs from the graph run's")
                runs[f"cli {turn} {'graph' if graphs else 'eager'}"] = ph
            out.unlink()
            say("cli q0 eager, graph, graph, eager: each output equal to "
                "the graph run's")
        say("GRAPHS " + json.dumps({"mode": name, "card": smi,
                                    "runs": runs}))
        results[name] = runs
        del data, g
    for name in ("cap", "bank64", "bank4", "mixer8", STEP_RUN[0], "wbfm",
                 *(f"st{c}" for c in range(WBFM_STATIONS))):
        (work / f"{name}.iq").unlink()
    return results


def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` runs of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after warm-up.  A call slower than 5 ms (a plain
    version at 256 blocks) gets 5 runs of one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 5e-3:
        reps, inner = 5, 1
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_us(fn, kernel: str, calls: int = 20, tries: int = 3) -> tuple:
    """(device time in µs per call of ``fn`` of the CUDA kernels whose
    names contain ``kernel``, their launches per call), from
    torch.profiler: the kernels alone, without the host's launch overhead.
    A kernel's time per call is its mean per recorded launch times its
    launches per call, rounded (the profiler can drop a record).  A window
    that records no such kernel is profiled again, up to ``tries`` windows
    (one on the H100 recorded none of twenty K6 launches); (None, 0) when
    none does."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with warm_profile(ProfilerActivity.CUDA) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if kernel in e.key]
        if evts:
            break
    else:
        return None, 0
    if len(evts) > 1:
        names = [re.search(r"\w+_kernel", e.key).group(0) for e in evts]
        say("  device time per call by kernel: " + "; ".join(
            f"{name} {e.device_time_total / calls:.1f} us"
            for name, e in zip(names, evts)))
    return (sum(e.device_time_total / e.count * max(1, round(e.count / calls))
                for e in evts),
            sum(e.count for e in evts) / calls)


def run_cases(out: dict, tag, cases: dict, gbytes: float, label: str) -> None:
    """Time each case (CUDA events) and, for a kernel, its device time and
    its bound; store them in ``out`` under (name, tag[, key])."""
    for name, (fn, kernel, nbytes, ops) in cases.items():
        ms = time_ms(fn)
        out[(name, tag)] = ms
        gb = nbytes / 1e9 if nbytes else gbytes     # the case's own bytes
        line = (f"{label} {name:34s} {ms * 1e3:9.1f} us "
                f"{gb / (ms / 1e3):8.1f} GB/s")
        if kernel is not None:
            us, per_call = device_us(fn, kernel)
            # ops: float32 operations, or (float32, float64) operations
            b_ms, b_by = bound(nbytes, *(ops if isinstance(ops, tuple)
                                         else (ops,)))
            out[(name, tag, "device_us")] = us
            out[(name, tag, "bound")] = (b_ms, b_by)
            line += ("; device time not measured (no profiler record)"
                     if us is None else f"; device {us:8.1f} us "
                     f"{gb / (us / 1e6):8.1f} GB/s, "
                     f"{us / (b_ms * 1e3):.1f}x its bound, "
                     f"{per_call:g} launch(es) per call")
            line += f" ({b_ms * 1e3:.2f} us, {b_by})"
            # K4, K1 and K4 with their head rows, and each patch are one
            # kernel: more than one launch per call is a fault (fewer would
            # be a record the profiler dropped)
            check(not name.startswith(("fused_nbfm_q1 ", "fused_nbfm+head",
                                       "fused_nbfm_q1+head", "patch_"))
                  or per_call <= 1,
                  f"{name}: {per_call:g} kernel launches per call")
        say(line)


def shard_checks(out: dict, raw, taps, st1, st2, esr, off_in, rng) -> None:
    """Phase 5 at the sharded path's shape: K1, K3 (one and two stages)
    and K4 against their plain versions on ``raw`` (the tone) and noise of
    its shape, as phase 3 holds them; the tone's max |err| into ``out``
    under (case, blocks, "err")."""
    B = raw.shape[0]
    noise = torch.from_numpy(rng.integers(0, 256, tuple(raw.shape),
                                          dtype=np.uint8)).to(raw.device)
    pieces = {"tone": raw, "noise": noise}
    for case, kern, plain, exact in (
            ("fused_nbfm precise", lambda r: fused_nbfm(r, taps),
             lambda r: fused_nbfm_ref(r, taps), True),
            ("fused_nbfm fast", lambda r: fused_nbfm(r, taps, "shift", False),
             lambda r: fused_nbfm_ref(r, taps, "shift", False), False),
            ("fused_nbfm_cplx 1 stage",
             lambda r: fused_nbfm_cplx(r, st1, taps),
             lambda r: fused_nbfm_cplx_ref(r, st1, taps), True),
            ("fused_nbfm_cplx 2 stages",
             lambda r: fused_nbfm_cplx(r, st2, taps),
             lambda r: fused_nbfm_cplx_ref(r, st2, taps), True),
            ("fused_nbfm_cplx 2 stages fast",
             lambda r: fused_nbfm_cplx(r, st2, taps, precise=False),
             lambda r: fused_nbfm_cplx_ref(r, st2, taps, precise=False),
             False),
            ("fused_nbfm_q1 precise",
             lambda r: fused_nbfm_q1(r, off_in, taps, esr)[0],
             lambda r: fused_nbfm_q1_ref(r, off_in, taps, esr)[0], False)):
        out[(case, B, "err")] = compare(f"B={B} {case}", pieces, kern,
                                        plain, exact=exact)
    _, k_ent, k_fin = fused_nbfm_q1(raw, off_in, taps, esr)
    _, p_ent, p_fin = fused_nbfm_q1_ref(raw, off_in, taps, esr)
    d = max(float((k_ent - p_ent).abs().max()),
            float((k_fin - p_fin).abs().max()))
    say(f"B={B} fused_nbfm_q1 precise offsets on the tone: max|diff| "
        f"{d:.3g}")
    check(d < BAR_OFFSET, f"B={B} fused_nbfm_q1 offsets differ by {d:.3g}")


# phase 5's patch timings: case -> (CLI options, fast); each at the
# phase's block counts, beside its plain version: K1 and K4 with their
# head rows (P1, P2), the patch kernels P3 and P4 on K3's output
PATCH_TIMED = {"fused_nbfm+head precise": ([], False),
               "fused_nbfm+head fast": ([], True),
               "fused_nbfm_q1+head precise": (["-q", "1"], False),
               "patch_cplx1 precise": (["-L", "12500"], False),
               "patch_cplx2 precise": (["-q", "2", "-L", "12500"], False),
               "patch_cplx2 fast": (["-q", "2", "-L", "12500"], True)}
# the profiler's name of the kernel a head case launches
HEAD_KERNELS = {"fused_nbfm+head": "fused_nbfm_kernel",
                "fused_nbfm_q1+head": "q1_kernel"}


def patch_cases(out: dict, raw: torch.Tensor, dev) -> dict:
    """Phase 5's patch cases on ``raw`` (and their plain versions), as
    ``run_cases`` takes them: K1 and K4 with their head rows, their bytes
    and operations the kernel's (2 bytes a raw byte; ``demod_ops``, K4
    also ``CORRECT_IQ_OPS``, a word) and the patch's
    (``nbfm_patch.patch_work``: bytes, float32 and float64 operations);
    P3 and P4 on K3's output, the patch's.  The max |err| against the
    plain version there into ``out`` under (case, blocks, "err")."""
    B = raw.shape[0]
    cases = {}
    for name, (extra, fast) in PATCH_TIMED.items():
        pipe = card_pipe(extra, fast, dev)
        kind = name.split()[0]
        nbytes, ops32, ops64 = patch_work(
            pipe.kernel_path(), pipe.out_fir, tuple(pipe._cplx_stages()), B,
            not fast)
        if kind in HEAD_KERNELS:
            call, want_of, plain = head_of(pipe)
            got, ent = call(raw)
            out[(name, B, "err")] = float(
                (got - want_of(raw, got, ent)[0]).abs().max())
            words = raw.numel() // 4
            k_ops = demod_ops(not fast, len(pipe.out_fir.host_taps)) + (
                CORRECT_IQ_OPS if pipe.kernel_path() == "q1" else 0)
            cases[name] = (lambda c=call: c(raw), HEAD_KERNELS[kind],
                           2 * raw.numel() + nbytes,
                           (k_ops * words + ops32, ops64))
            cases[name.replace(kind, kind + "_ref")] = (
                lambda p=plain: p(raw), None, nbytes, 0)
            continue
        patch, ref, main = patch_of(pipe)
        base, offs = main(raw)
        audio = base.clone()
        got = patch(raw, base.clone(), offs)
        out[(name, B, "err")] = float(
            (got - ref(raw, base.clone(), offs)).abs().max())
        cases[name] = (lambda p=patch, a=audio, o=offs: p(raw, a, o),
                       f"{kind}_kernel", nbytes, (ops32, ops64))
        cases[name.replace(kind, kind + "_ref")] = (
            lambda r=ref, a=audio, o=offs: r(raw, a, o), None, nbytes, 0)
    return cases


# phase 5b: the K3 steps, each its K3 and its patch (P3, P4) as the CLI
# (precise) and the bench's rows (fast) run them: name -> (CLI options,
# fast); bench row -> its step here
K3_STEPS = {"-L": (["-L", "12500"], False),
            "-L fast": (["-L", "12500"], True),
            "-q 2": (["-q", "2"], False),
            "-q 2 fast": (["-q", "2"], True),
            "-q 2 -L": (["-q", "2", "-L", "12500"], False),
            "-q 2 -L fast": (["-q", "2", "-L", "12500"], True)}
K3_BENCH_ROWS = {"nbfm_inlpf_fused": "-L fast",
                 "nbfm_q2_dcblock_fused": "-q 2 fast",
                 "nbfm_q2_inlpf_fused": "-q 2 -L fast"}
GRAPH_CALLS = 20


def graph_us(fn, calls: int = GRAPH_CALLS, reps: int = 20) -> float:
    """µs per call of ``fn`` in one CUDA graph of ``calls`` calls: CUDA
    events around a replay, the median of ``reps`` replays after one (no
    host launch between the calls, as in the CLI's and the bench's
    captured steps)."""
    graph, _ = graph_of(fn, calls)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    del graph
    return float(np.median(times))


def k3_lead_us(replay, kernel: str, reps: int = 10) -> float | None:
    """From torch.profiler's device events of ``reps`` replays of a
    captured K3 step (each synchronized): the median of K3's end less the
    patch kernel's start, µs; above 0 where the patch started while K3 ran
    (the programmatic edge kept by the capture), below where it waited
    for K3's end.  None when the profiler records no pair."""
    from torch.profiler import ProfilerActivity
    replay()
    torch.cuda.synchronize()
    with warm_profile(ProfilerActivity.CUDA) as prof:
        for _ in range(reps):
            replay()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.time_range.start)
    k3 = [e for e in events if "fused_nbfm_cplx_kernel" in e.name]
    patch = [e for e in events if kernel in e.name]
    if not k3 or len(k3) != len(patch):
        return None
    return float(np.median([a.time_range.end - b.time_range.start
                            for a, b in zip(k3, patch)]))


def phase_patch_overlap(out: dict, dev, smi: str) -> None:
    """Phase 5b: P3 and P4 alone and as the model runs them.  In CUDA
    graphs of GRAPH_CALLS calls: K3 alone, the step (K3, then the patch as
    its programmatic dependent) and the patch alone (after a patch, which
    triggers nothing: no overlap); the step less K3 is what the patch adds
    to a step.  Device times from torch.profiler: the patch alone, and in
    a replayed step (which includes its wait for K3), and K3's end less
    the patch's start there (above 0: the patch started while K3 ran, the
    programmatic edge kept in the graph).  The launch floor:
    a one-element fill in a graph (µs a node) and its device time.  →
    ``out[("k3 step", name, B)]``, ``out["launch floor"]``."""
    say("== phase 5b: P3 and P4 alone and overlapped with K3, in CUDA "
        f"graphs of {GRAPH_CALLS} calls (CUDA events, median of 20 "
        "replays) and by torch.profiler; card: " + smi)
    one = torch.zeros(1, device=dev)
    floor = graph_us(lambda: one.fill_(1.0))
    floor_dev, _ = device_us(lambda: one.fill_(1.0), "FillFunctor")
    out["launch floor"] = {"graph_us": floor, "device_us": floor_dev}
    say(f"launch floor: a one-element fill {floor:.2f} us a graph node, "
        "device time " + ("not measured (no profiler record)"
                          if floor_dev is None else f"{floor_dev:.2f} us"))
    rng = np.random.default_rng(5)
    piece = torch.from_numpy(tone_iq(NB * BB, 0, rng).reshape(NB, BB)).to(dev)
    for B in (NB, 256):
        raw = piece.repeat(B // NB, 1)
        for name, (extra, fast) in K3_STEPS.items():
            pipe = card_pipe(extra, fast, dev)
            patch, _, main = patch_of(pipe)
            kernel = f"{pipe.kernel_path().replace('cplx', 'patch_cplx')}_kernel"
            state = pipe.init_state()
            audio, _ = main(raw)
            step = lambda: pipe.fused_call(state, raw)   # noqa: E731
            row = {"k3_us": graph_us(lambda: main(raw)),
                   "step_us": graph_us(step),
                   "alone_us": graph_us(lambda: patch(raw, audio, None))}
            row["step_minus_k3_us"] = row["step_us"] - row["k3_us"]
            row["device_alone_us"], _ = device_us(
                lambda: patch(raw, audio, None), kernel)
            graph, _ = graph_of(step)
            for _ in range(3):      # the profiler can lose a replay's records
                row["device_in_step_us"], per = device_us(graph.replay, kernel)
                if row["device_in_step_us"] is not None:
                    break
            row["k3_end_minus_patch_start_us"] = k3_lead_us(graph.replay,
                                                            kernel)
            del graph
            # one launch a step (fewer: a record the profiler dropped)
            check(per <= 1, f"{name}: {per:g} patch launches a replayed step")
            out[("k3 step", name, B)] = row
            us = {k: "not measured" if v is None else f"{v:.2f} us"
                  for k, v in row.items()}
            say(f"B={B:3d} K3 + {kernel[:-7]} {name:13s}: K3 {us['k3_us']}, "
                f"step {us['step_us']} (step - K3 {us['step_minus_k3_us']}), "
                f"patch alone {us['alone_us']} a node; device: alone "
                f"{us['device_alone_us']}, in the step "
                f"{us['device_in_step_us']} (its wait for K3 included); "
                f"K3's end less the patch's start in a replay "
                f"{us['k3_end_minus_patch_start_us']}")


def phase_timings(dev, smi: str) -> dict:
    say("== phase 5: timings per call, as the caller sees them (CUDA events "
        "around 10 back-to-back calls, median of 20 runs, or 5 single "
        "calls for a call slower than 5 ms; host launch "
        "overhead included), and each CUDA kernel's device time alone "
        "(torch.profiler, mean of 20 calls), against its bound: the larger "
        f"of its bytes over {PEAK_BYTES / 1e12} TB/s and its float32 "
        f"operations over {PEAK_FP32 / 1e12:.0f} TFLOP/s (data sheet)")
    say(f"card: {smi}")
    taps = taps_of({"S": "96000", "l": "12500"})
    nt = len(taps)
    st1 = pipe_of(["-L", "12500"]).stage_consts()
    st2 = pipe_of(["-q", "2", "-L", "12500"]).stage_consts()
    cplx = [stage_ops(len(t)) for t, _ in st2]   # per word, per stage
    cplx1 = stage_ops(len(st1[0][0]))
    esr = float(pipe_of(["-q", "1"]).esr)
    off_in = torch.tensor([127.3, 126.8], device=dev)
    rng = np.random.default_rng(5)
    piece = tone_iq(NB * BB, 0, rng).reshape(NB, BB)
    out = {}
    for B in (SHARD_BLOCKS, NB, 256):
        raw = torch.from_numpy(np.tile(piece, (max(1, B // NB), 1))[:B]
                               ).to(dev)
        nbytes = 2 * raw.numel()      # n bytes read + n bytes written
        words = raw.numel() // 4
        gbytes = nbytes / 1e9
        # name -> (call, the profiler's kernel name or None for a plain
        # version, bytes, operations)
        k1p, k1f = demod_ops(True, nt), demod_ops(False, nt)
        cases = {
            "fused_nbfm precise": (lambda: fused_nbfm(raw, taps, "shift", True),
                                   "fused_nbfm_kernel", nbytes, k1p * words),
            "fused_nbfm fast": (lambda: fused_nbfm(raw, taps, "shift", False),
                                "fused_nbfm_kernel", nbytes, k1f * words),
            "fused_nbfm_ref precise": (
                lambda: fused_nbfm_ref(raw, taps, "shift", True), None, 0, 0),
            "fused_nbfm_ref fast": (
                lambda: fused_nbfm_ref(raw, taps, "shift", False), None, 0, 0),
            "dma_floor": (lambda: dma_floor(raw), "dma_floor_kernel", nbytes,
                          4 * words),
            "dma_floor_ref": (lambda: dma_floor_ref(raw), None, 0, 0),
            "fused_nbfm_cplx 1 stage": (
                lambda: fused_nbfm_cplx(raw, st1, taps), "fused_nbfm_cplx",
                nbytes, (k1p + cplx1) * words),
            "fused_nbfm_cplx_ref 1 stage": (
                lambda: fused_nbfm_cplx_ref(raw, st1, taps), None, 0, 0),
            "fused_nbfm_cplx 2 stages": (
                lambda: fused_nbfm_cplx(raw, st2, taps), "fused_nbfm_cplx",
                nbytes, (k1p + sum(cplx)) * words),
            "fused_nbfm_cplx_ref 2 stages": (
                lambda: fused_nbfm_cplx_ref(raw, st2, taps), None, 0, 0),
            "fused_nbfm_cplx 2 stages fast": (
                lambda: fused_nbfm_cplx(raw, st2, taps, precise=False),
                "fused_nbfm_cplx", nbytes, (k1f + sum(cplx)) * words),
            "fused_nbfm_cplx_ref 2 stages fast": (
                lambda: fused_nbfm_cplx_ref(raw, st2, taps, precise=False),
                None, 0, 0),
            "fused_nbfm_q1 precise": (
                lambda: fused_nbfm_q1(raw, off_in, taps, esr), "q1_",
                nbytes, (k1p + CORRECT_IQ_OPS) * words),
            "fused_nbfm_q1_ref precise": (
                lambda: fused_nbfm_q1_ref(raw, off_in, taps, esr), None, 0, 0),
            "fused_nbfm_q1_seq precise": (
                lambda: fused_nbfm_q1_seq(raw, off_in, taps, esr),
                "q1_seq_kernel", nbytes, (k1p + CORRECT_IQ_OPS) * words),
            "fused_nbfm_q1_seq_ref precise": (
                lambda: fused_nbfm_q1_seq_ref(raw, off_in, taps, esr), None,
                0, 0),
        }
        cases.update(patch_cases(out, raw, dev))
        # K2's function as one PyTorch call (timed here; the port never
        # calls it): the float32 sum of each word's four bytes
        lib_view = raw.view(B, -1, 128, 4)
        check(torch.equal(lib_view.sum(-1, dtype=torch.float32).view(
            B, -1), dma_floor(raw)), "dma_floor's library call differs")
        cases["dma_floor library"] = (
            lambda: lib_view.sum(-1, dtype=torch.float32), None, nbytes, 0)
        if B == SHARD_BLOCKS:
            # the shape the sharded path gives the kernels: K1 and K3 a
            # shard of 2 blocks, K4 one channel's 2 blocks
            cases = {n: c for n, c in cases.items() if "seq" not in n}
            shard_checks(out, raw, taps, st1, st2, esr, off_in, rng)
        run_cases(out, B, cases, gbytes,
                  f"B={B:3d} ({raw.numel() >> 10} KiB in)")
        say(f"B={B:3d} dma_floor library call (sum(-1, dtype=float32) over "
            f"[B, rows, 128, 4]): {out[('dma_floor library', B)] * 1e3:.1f}"
            f" us, dma_floor {out[('dma_floor', B)] * 1e3:.1f} us")
        for name in ("fused_nbfm precise", "fused_nbfm fast",
                     "fused_nbfm_cplx 1 stage", "fused_nbfm_cplx 2 stages",
                     "fused_nbfm_cplx 2 stages fast",
                     "fused_nbfm_q1 precise", "fused_nbfm_q1_seq precise"):
            if (name, B, "device_us") not in out:
                continue
            us, floor = (out[(name, B, "device_us")],
                         out[("dma_floor", B, "device_us")])
            if us is not None and floor is not None:
                say(f"B={B:3d} {name}: device time {us / floor:.2f}x "
                    f"dma_floor's ({gbytes / (us / 1e6):.1f} GB/s against "
                    f"its {gbytes / (floor / 1e6):.1f})")
        del raw
    phase_patch_overlap(out, dev, smi)
    floor_us = out[("dma_floor", NB, "device_us")]
    floor_gbs = None if floor_us is None else 2 * NB * BB / 1e3 / floor_us

    # the channel bank: K6 on one bank64 block (C = 64) and one bank4
    # chunk (C = 4, 10 blocks), its plain version, and the audio FIR
    for name, (nch, _, carriers, per_call) in BANK_RUNS.items():
        pipe = ChannelBankPipeline(ChannelBankConfig(
            sample_rate=nch * CR, channel_rate=CR,
            offsets_hz=tuple(bank_offsets(nch)), block_seconds=0.25),
            device=dev)
        C, P = pipe.pfb.C, pipe.pfb.P
        n = pipe.block_complex * per_call
        say(f"{name}: K6's FFT plan C = {C} = "
            f"{' x '.join(map(str, fft_plan(C)))}")
        raw = bank_iq(nch * CR, bank_offsets(nch), carriers, 0, n, 7,
                      0.8 / len(carriers), dev)
        hist = pipe.pfb.init_hist(device=dev)
        h, h_dev = pipe.pfb._h_np, pipe._h_dev
        d, _ = fused_pfb_demod(raw, hist, h, C, h_dev=h_dev)
        dsel = d.T.index_select(0, pipe._rows)
        ahist = pipe.audio.init_hist((nch,))
        nbytes = raw.numel() + 4 * d.numel() + 2 * 4 * hist.numel()
        label = f"{name} C={C} ({per_call} block(s), {n} samples)"
        run_cases(out, name, {
            "fused_pfb": (lambda: fused_pfb_demod(raw, hist, h, C,
                                                  h_dev=h_dev),
                          "pfb_kernel", nbytes, pfb_ops(n, C, P)),
            "fused_pfb_ref": (lambda: fused_pfb_demod_ref(raw, hist, h, C),
                              None, 0, 0),
            "audio FIR": (lambda: pipe.audio(dsel, ahist), None, 0, 0),
        }, nbytes / 1e9, label)
        us = out[("fused_pfb", name, "device_us")]
        if us is not None and floor_gbs is not None:
            say(f"{label} fused_pfb: {nbytes / 1e3 / us:.1f} GB/s against "
                f"dma_floor's {floor_gbs:.1f} GB/s (B=16)")
        del raw, d, dsel
    # K6 above 256 channels on one 0.25 s block of 6.25 kHz channels:
    # pfb_wide_kernel (the compiled-in plans), pfb_big_kernel, or the
    # four-step route's two kernels
    wide = {}
    for C in PFB_WIDE_TIMED:
        pfb = PolyphaseChannelizer(C)
        fs = C * NARROW_CR
        n = int(0.25 * fs) // (2 * C) * (2 * C)
        raw = bank_iq(fs, bank_offsets(C, NARROW_CR), tuple(range(0, C,
                                                                 C // 4)),
                      0, n, 7, 0.2, dev, NARROW_DEV_HZ)
        hist = pfb.init_hist(device=dev)
        h = pfb._h_np
        h_dev = torch.from_numpy(h.astype(np.float32)).to(dev)
        d, _ = fused_pfb_demod(raw, hist, h, C, h_dev=h_dev)
        nbytes = raw.numel() + 4 * d.numel() + 2 * 4 * hist.numel()
        kern = ("pfb_cluster_kernel" if on_cluster(C, pfb.P)
                else "pfb_pass" if C > MAX_CTA_CHANNELS
                else "pfb_wide_kernel" if C in WIDE_PLANS
                and pfb.P == WIDE_TAPS else "pfb_big_kernel")
        # the FFT part alone, as a yardstick: torch.fft.fft of the block's
        # frames (its branch outputs) in complex128
        z, _ = pfb.branch_filter(torch.stack(split_iq(raw)), hist)
        frames = torch.complex(z[0].double(), z[1].double())
        del z
        run_cases(out, f"wide{C}", {
            "fused_pfb": (lambda: fused_pfb_demod(raw, hist, h, C,
                                                  h_dev=h_dev),
                          kern, nbytes, pfb_ops(n, C, pfb.P)),
            "fused_pfb_ref": (lambda: fused_pfb_demod_ref(raw, hist, h, C),
                              None, 0, 0),
            "torch.fft.fft": (lambda: torch.fft.fft(frames, dim=-1), None,
                              0, 0),
        }, nbytes / 1e9, f"C={C} at {fs / 1e6:g} Msps (FFT "
           f"{pfb_plan(C)}; 0.25 s, {n} samples)")
        if on_cluster(C, pfb.P):
            wide[C] = {"kernel": kern, "plan": list(CLUSTER_PLANS[C]),
                       "launches_per_call": launches_per_call(C, n),
                       **kernel_attrs(C, pfb.P)}
        elif C > MAX_CTA_CHANNELS:
            wide[C] = {"kernel": "pfb_pass1_kernel + pfb_pass2_kernel",
                       "plan": [*four_step_plan(C), *four_step_tiles(C)],
                       "launches_per_call": launches_per_call(C, n),
                       **kernel_attrs(C, pfb.P)}
        else:
            wide[C] = {"kernel": kern, **kernel_attrs(C, pfb.P)}
        say(f"C={C} {wide[C]['kernel']}: {wide[C]}")
        del raw, d, frames
    say("PFB_WIDE " + json.dumps({"card": smi, "C": {
        str(C): {"device_us": out[("fused_pfb", f"wide{C}", "device_us")],
                 "ms": out[("fused_pfb", f"wide{C}")],
                 "plain_ms": out[("fused_pfb_ref", f"wide{C}")],
                 "bound_ms": out[("fused_pfb", f"wide{C}", "bound")][0],
                 "bound_by": out[("fused_pfb", f"wide{C}", "bound")][1],
                 "fft_alone_ms": out[("torch.fft.fft", f"wide{C}")],
                 **wide[C]}
        for C in PFB_WIDE_TIMED}}))
    return out


# phase 6: the tools' runs -> (module, arguments)
TOOL_SCALING = ["--e2e", "--diagnose", "--repeats", "2"]
# 20 blocks (5 MiB): wbfm's 1.0 s block at 2.4 Msps is 4.8 MB
TOOL_REGRESSION = ["--configs", "nbfm,bank4,wbfm", "--repeats", "1",
                   "--warmup", "0", "--blocks", "20"]
SCALING_KEYS = ("devices", "axis", "q", "profile", "blocks", "msps",
                "efficiency", "graph", "backend", "device_name", "card",
                "msps_same_work_1dev", "sharded_frac_of_1dev",
                "step_fixed_ms", "msps_e2e", "e2e_frac_of_device")


def tool_lines(main, argv: list) -> list:
    """A tool's ``main(argv)`` in this process → its stdout's JSON lines
    (fails on a non-zero return)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"tool {main.__module__} {argv}: returned {rc}:\n"
          f"{buf.getvalue()[-2000:]}")
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln]


def phase_tools(dev, smi: str) -> None:
    """Phase 6: the port's tools (demodulator_tpu_torch/tools/) in this
    process on this card: validate_pfb_hw at every C of its table, held to
    phase 3's bars; bench_scaling --e2e --diagnose, one line per visible
    device count with every field; bench_regression on nbfm, bank4 and
    wbfm, each certified and replayed as a CUDA graph."""
    from demodulator_tpu_torch.tools import (bench_regression,
                                             bench_scaling, validate_pfb_hw)
    t0 = time.perf_counter()
    for C in sorted(validate_pfb_hw.ROWS):
        line = validate_pfb_hw.validate(C, dev)
        say("validate_pfb_hw " + json.dumps(line))
        snr = line["snr_db"]
        check(line["max_dphi_rad"] < BAR_ANGLE and line["history_equal"]
              and (snr is None or snr > BAR_BANK_DB),
              f"validate_pfb_hw C={C}: {line['max_dphi_rad']:.3g} rad, "
              f"{snr} dB, history equal {line['history_equal']}")
    n_dev = torch.cuda.device_count()
    counts = [1 << k for k in range(n_dev.bit_length())]
    counts += [n_dev] if counts[-1] != n_dev else []
    # the captured step the CLI runs, and beside it the eager one
    for graphs in (True, False):
        os.environ["DEMODULATOR_TPU_TORCH_GRAPHS"] = "1" if graphs else "0"
        try:
            lines = tool_lines(bench_scaling.main, TOOL_SCALING)
        finally:
            os.environ.pop("DEMODULATOR_TPU_TORCH_GRAPHS")
        for line in lines:
            say("bench_scaling " + json.dumps(line))
            missing = [k for k in SCALING_KEYS if k not in line]
            check(not missing and line["msps"] > 0 and line["msps_e2e"] > 0
                  and line["graph"] is graphs,
                  f"bench_scaling: missing {missing}, no throughput or graph "
                  f"not {graphs}: {line}")
        check([ln["devices"] for ln in lines] == counts
              and lines[0]["efficiency"] == 1.0,
              f"bench_scaling: devices {[ln['devices'] for ln in lines]}, "
              f"want {counts}; efficiency at 1: {lines[0]['efficiency']}")
    lines = tool_lines(bench_regression.main, TOOL_REGRESSION)
    for line in lines:
        say("bench_regression " + json.dumps(line))
        check(line["certified"] and line["graph"] == [True]
              and line["card"] is not None and line["blocks"][0] > 0,
              f"bench_regression {line['config']}: not certified, not "
              f"replayed, no card or no blocks")
    check([ln["config"] for ln in lines] == ["nbfm", "bank4", "wbfm"],
          f"bench_regression: configs {[ln['config'] for ln in lines]}")
    say(f"tools on {smi}: validate_pfb_hw at C = "
        f"{sorted(validate_pfb_hw.ROWS)}, bench_scaling and bench_regression "
        f"as above, in {time.perf_counter() - t0:.1f} s")


def phase_bench(smi: str) -> dict:
    """Phase 7: the port's benchmark, ``python -m demodulator_tpu_torch.bench
    --matrix`` in its own process (its launch counts start at 0): rc 0,
    every row of its file correct, with a positive value, each row timed
    on the card with an achieved_frac at most 1.05 (the end-to-end rows,
    timed by the host clock, with none), each printed as a ``BENCH`` line,
    and the headline last on its stdout.  → {row name: row}."""
    from demodulator_tpu_torch import bench
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as d:
        out = Path(d) / "bench_matrix.json"
        r = subprocess.run([sys.executable, "-m", "demodulator_tpu_torch.bench",
                            "--matrix", "--out", str(out)], cwd=REPO,
                           capture_output=True, text=True, timeout=900,
                           stdin=subprocess.DEVNULL)
        check(r.returncode == 0, f"bench --matrix: rc {r.returncode}:\n"
              f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        rows = json.loads(out.read_text())
    names = [n for n, _ in bench.MATRIX] + [n for n, _ in bench.E2E]
    check([row["metric"] for row in rows]
          == [f"iq_throughput_{n}" for n in names],
          f"bench: rows {[row['metric'] for row in rows]}")
    e2e = {f"iq_throughput_{n}" for n, _ in bench.E2E}
    for row in rows:
        say("BENCH " + json.dumps(row))
        frac = row.get("roofline", {}).get("achieved_frac")
        # a row timed on the card has a share of its bound; an end-to-end
        # row, timed by the host clock, none
        check(row.get("correct") is True and row.get("value", 0) > 0
              and (frac is None if row["metric"] in e2e
                   else frac is not None and 0 < frac <= bench.BAR_FRAC),
              f"bench {row['metric']}: correct {row.get('correct')}, value "
              f"{row.get('value')}, achieved_frac {frac}, error "
              f"{row.get('error')}")
    line = json.loads(r.stdout.splitlines()[-1])
    say("BENCH " + json.dumps(line))
    check(line["metric"] == bench.HEADLINE and line["value"] > 0,
          f"bench: headline {line}")
    say(f"bench --matrix on {smi}: {len(rows)} rows, each correct, in "
        f"{time.perf_counter() - t0:.1f} s")
    return {row["metric"][len("iq_throughput_"):]: row for row in rows}


def shard_shape_entry(times: dict, case: str, plain: str) -> dict | None:
    """The kernels JSON's numbers at SHARD_BLOCKS blocks a call."""
    B = SHARD_BLOCKS
    if (case, B) not in times:
        return None
    b_ms, b_by = times[(case, B, "bound")]
    us = times[(case, B, "device_us")]
    return {"blocks": B, "ms": times[(case, B)],
            "device_ms": None if us is None else us / 1e3,
            "plain_ms": times[(plain, B)], "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": times.get((case, B, "err"))}


def main() -> int:
    say("== phase 1: device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: torch.cuda.is_available() is "
                         "false; this smoke run needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device: {kind}")
    say(smi)

    say("== phase 2: build")
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    say(f"built {lib.relative_to(REPO)} with nvcc "
        f"{' '.join(build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")

    errs = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=REPO) as d:
        main_path = phase_main_path(Path(d), dev)
        say("== phase 4b: the channel bank through python -m "
            "demodulator_tpu_torch --bank")
        main_path.update(phase_bank(Path(d), dev))
        main_path.update(phase_bank_narrow(Path(d), dev))
        main_path.update(phase_bank_four_step(Path(d), dev))
        say("== phase 4c: --precision float64, --profile continuous, "
            "--checkpoint/--resume, --metrics and --trace through python -m "
            f"demodulator_tpu_torch; card: {smi}")
        cap = Path(d) / "cap.iq"
        phase_f64_continuous(Path(d), cap, smi)
        phase_resume(Path(d), cap, smi)
        phase_resume_bank(Path(d), smi)
        phase_metrics_trace(Path(d), cap, smi)
        say("== phase 4e: the parallel layer (--shard-time, --distributed, "
            "--shared-out, --shard-chan; ShardedStreamProcessor and the "
            f"chan-sharded banks) on this card; card: {smi}")
        sharded = phase_sharded(Path(d), cap, main_path["bank64"], dev, smi)
        say("== phase 4d: --wbfm, --wbfm --inputs and the mixer bank "
            "(off-grid --bank) through python -m demodulator_tpu_torch; "
            f"card: {smi}")
        phase_wbfm(Path(d), dev, smi)
        phase_mixer(Path(d), dev, smi)
        say("== phase 4f: the warm start, in this process through the API: "
            "each captured mode's full chunks replayed as a CUDA graph, "
            "against eager steps and under torch.profiler, on the "
            f"captures of phases 4, 4b and 4d; card: {smi}")
        phase_graphs(Path(d), dev, smi)
    times = phase_timings(dev, smi)
    say("== phase 6: the tools (python -m demodulator_tpu_torch.tools.*: "
        "validate_pfb_hw, bench_scaling, bench_regression) in this process; "
        f"card: {smi}")
    phase_tools(dev, smi)
    say("== phase 7: the benchmark (python -m demodulator_tpu_torch.bench "
        f"--matrix) in its own process; card: {smi}")
    bench_rows = phase_bench(smi)
    k3_rows = {}
    for row, name in K3_BENCH_ROWS.items():
        step_us = bench_rows[row]["step_s"] * 1e6
        k3_us = times[("k3 step", name, 256)]["k3_us"]
        k3_rows[row] = {"step_us": step_us, "k3_us": k3_us,
                        "step_minus_k3_us": step_us - k3_us}
        say(f"bench {row}: step {step_us:.2f} us, K3 alone {k3_us:.2f} us "
            f"(phase 5b, {name}, B=256): step - K3 {step_us - k3_us:.2f} us")
    say("K3_ROWS " + json.dumps({"card": smi, "rows": k3_rows}))
    say(smi)
    kernels = []
    # (name, kernel, CLI run whose launches count (None: on no path),
    #  phase-3 error, timing tag, timing case of the kernel and of its plain
    #  version)
    for name, kernel, run, err, tag, (case, plain) in (
            ("fused_nbfm", "fused_nbfm", "precise", errs[("default", True)],
             NB, ("fused_nbfm precise", "fused_nbfm_ref precise")),
            ("fused_nbfm[fast]", "fused_nbfm", "fast",
             errs[("default", False)], NB,
             ("fused_nbfm fast", "fused_nbfm_ref fast")),
            ("fused_nbfm_cplx[-L]", "fused_nbfm_cplx", "-L",
             errs[("-L", True)], NB,
             ("fused_nbfm_cplx 1 stage", "fused_nbfm_cplx_ref 1 stage")),
            ("fused_nbfm_cplx[-q 2]", "fused_nbfm_cplx", "-q 2",
             errs[("-q 2", True)], NB,
             ("fused_nbfm_cplx 1 stage", "fused_nbfm_cplx_ref 1 stage")),
            ("fused_nbfm_cplx[-q 2 -L]", "fused_nbfm_cplx", "-q 2 -L",
             errs[("-q 2 -L", True)], NB,
             ("fused_nbfm_cplx 2 stages", "fused_nbfm_cplx_ref 2 stages")),
            ("fused_nbfm_cplx[-q 2 -L, fast]", "fused_nbfm_cplx",
             "-q 2 -L fast", errs[("-q 2 -L", False)], NB,
             ("fused_nbfm_cplx 2 stages fast",
              "fused_nbfm_cplx_ref 2 stages fast")),
            ("fused_nbfm_q1", "fused_nbfm_q1", "-q 1", errs[("-q 1", True)],
             NB, ("fused_nbfm_q1 precise", "fused_nbfm_q1_ref precise")),
            ("fused_nbfm_q1_seq", "fused_nbfm_q1_seq", None,
             errs[("q1_seq", True)], NB,
             ("fused_nbfm_q1_seq precise", "fused_nbfm_q1_seq_ref precise")),
            ("fused_pfb[bank64]", "fused_pfb", "bank64", errs["pfb"],
             "bank64", ("fused_pfb", "fused_pfb_ref")),
            ("fused_pfb[bank4]", "fused_pfb", "bank4", errs["pfb"], "bank4",
             ("fused_pfb", "fused_pfb_ref")),
            # the three-factor route (C = 512 = 8 x 8 x 8), phase 5 on one
            # 0.25 s block of bank512's geometry
            ("fused_pfb[bank512]", "fused_pfb", "bank512", errs["pfb wide"],
             "wide512", ("fused_pfb", "fused_pfb_ref")),
            # the four-step route (C = 8192 = 64 x 128), phase 5 on one
            # 0.25 s block of bank8192's geometry
            ("fused_pfb[bank8192]", "fused_pfb", "bank8192",
             errs["pfb four-step"], "wide8192",
             ("fused_pfb", "fused_pfb_ref")),
            # the float64 patches (no TPU kernel: XLA code in the JAX
            # package): P1 and P2 in K1's and K4's launch, P3 and P4 after
            # K3
            ("fused_nbfm+head", "fused_nbfm+head", "precise",
             errs[("fused_nbfm+head", True)], NB,
             ("fused_nbfm+head precise", "fused_nbfm+head_ref precise")),
            ("fused_nbfm+head[fast]", "fused_nbfm+head", "fast",
             errs[("fused_nbfm+head", False)], NB,
             ("fused_nbfm+head fast", "fused_nbfm+head_ref fast")),
            ("fused_nbfm_q1+head", "fused_nbfm_q1+head", "-q 1",
             errs[("fused_nbfm_q1+head", True)], NB,
             ("fused_nbfm_q1+head precise",
              "fused_nbfm_q1+head_ref precise")),
            ("patch_cplx1[-L]", "patch_cplx1", "-L",
             errs[("patch_cplx1", True)], NB,
             ("patch_cplx1 precise", "patch_cplx1_ref precise")),
            ("patch_cplx1[-q 2]", "patch_cplx1", "-q 2",
             errs[("patch_cplx1", True)], NB,
             ("patch_cplx1 precise", "patch_cplx1_ref precise")),
            ("patch_cplx2[-q 2 -L]", "patch_cplx2", "-q 2 -L",
             errs[("patch_cplx2", True)], NB,
             ("patch_cplx2 precise", "patch_cplx2_ref precise")),
            ("patch_cplx2[-q 2 -L, fast]", "patch_cplx2", "-q 2 -L fast",
             errs[("patch_cplx2", False)], NB,
             ("patch_cplx2 fast", "patch_cplx2_ref fast"))):
        b_ms, b_by = times[(case, tag, "bound")]
        count = ("patch_launches" if kernel.startswith("patch_")
                 else "launches")
        head = kernel.endswith("+head")     # P1, P2: in K1's, K4's launch
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, SOURCES[kernel])[0],
            "replaces": SOURCES.get(name, SOURCES[kernel])[1],
            "tpu_kernel": not (kernel.startswith("patch_") or head),
            # K5 runs on no path, in either package: held in phase 3
            "launches": 0 if run is None else main_path[run][count],
            "on_main_path": run is not None,
            "max_abs_err": err,
            "ms": times[(case, tag)], "plain_ms": times[(plain, tag)],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            # phase 4e's replayed (1, 1) run of the same mode through the
            # API (--shard-time 1's processor), or its --shard-chan 1 CLI
            # run; null where phase 4e runs no such mode
            "sharded_launches": sharded.get(SHARDED_RUNS.get(name)),
            # phase 5 at a time shard's 2 blocks (null: the kernel takes
            # the unsharded shape on the sharded path, or none)
            "at_shard_shape": shard_shape_entry(times, case, plain),
        })
        if head:
            kernels[-1]["part_of"] = kernel[: -len("+head")]
        if kernel.startswith("patch_cplx"):
            # phase 5b: alone and in its K3 step, at NB and 256 blocks
            step = name[name.index("[") + 1:-1].replace(", ", " ")
            kernels[-1]["k3_step"] = {
                str(B): times[("k3 step", step, B)] for B in (NB, 256)}
            kernels[-1]["launch_floor"] = times["launch floor"]
    # K2 runs on no path of the CLI, in either package: its launches are
    # the bench's memory-floor row's (phase 7), its error phase 3's
    floor = bench_rows["hbm_memcpy_floor"]
    check(floor["launches"].get("dma_floor", 0) > 0,
          "bench hbm_memcpy_floor: no dma_floor launch")
    b_ms, b_by = times[("dma_floor", NB, "bound")]
    kernels.insert(2, {
        "name": "dma_floor", "route": "cuda", "tpu_kernel": True,
        "source": SOURCES["dma_floor"][0],
        "replaces": SOURCES["dma_floor"][1],
        "launches": floor["launches"]["dma_floor"], "on_main_path": False,
        "path": "bench hbm_memcpy_floor", "max_abs_err": errs["dma_floor"],
        "ms": times[("dma_floor", NB)],
        "ms_256_blocks": times[("dma_floor", 256)],
        "plain_ms": times[("dma_floor_ref", NB)], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": times[("dma_floor library", NB)],
        "sharded_launches": None, "at_shard_shape": None})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
