#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the hand-written kernels, holds each against its plain
PyTorch version, trains stablelm-3b at full width and serves it at full
width, trains it as four rank processes over HMAC-framed sockets
(the multi-controller deployment), trains and serves xlstm-125m at full width, trains zamba2-7b at
full width (depth 12) and serves it at full width, trains chatglm3-6b at
full width (depth 4) and granite-moe-1b-a400m at full width and depth,
serves mistral-nemo-12b and olmoe-1b-7b at full width, runs a granite-8b
prefill, serves the enc-dec
seamless-m4t-medium at full width and depth (oneshot) and the VLM
llava-next-34b at full width (depth 12) with its image-token prefix, all
through the port's entry points, with per-layer recompute in training;
runs the tree forms, the leafwise layout, the trivial one-card mesh and
the mesh train step's forms; and reports what ran.

    python3 chip_smoke.py            # everything (one card)
    python3 chip_smoke.py --quick    # build + kernel phases only
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # main-, dropout-, fault-, ring-,
                                     # xLSTM, hybrid and MoE train-path
                                     # steps, of the scanned main, fault
                                     # and ring paths' replayed chunks, of
                                     # a Fig. 2 trimmed-mean replay and of
                                     # the seven serve paths' prefills
                                     # and decode chunks
                                     # (chiprun_out/profile_<path>.json)

Phases, one JSON line each (any failure raises and exits non-zero):
  device      card, power limit, versions, TF32 off, kernel build time
  kernel      B1 obfuscate_update, B3 obfuscate_update_krng, B2 gossip_update
              at (rows, 2^22) against the plain versions; B4
              masked_gossip_update, B5 masked_gossip_update_krng and B6
              guarded_gossip_update at m = 4, 5, 32 in f32 and bf16
  kernel_strided  B1, B2, B4 and B6 launched once per leaf of ragged,
              unaligned leaves on the leaf's columns of flat buffers, in
              place: bitwise the whole-buffer launch
  step_parity stablelm-3b-smoke f32, 4 agents, 2 steps: card vs CPU, for
              PDSGD, DSGD, DSGT, DP-DSGD and PDSGD with the gradient clip
  main_path   stablelm-3b (full width, depth 8), 4 agents on a ring, bf16,
              1 warm-up + 5 timed steps through run_training; then B3 and
              B2 timed and checked at the shapes that run gave them
  fig2_path   the paper's Fig. 2 workload (the North star): 600 PDSGD
              steps (B3 + B2) through the eager loop and through the
              scanned step (a CUDA graph of 100 steps, replayed), in jax's
              earlier threefry stream (partitionable=False); gates: graph
              == eager bitwise, final_err within a relative 1e-3 of
              0.07891825798133546; then one replay traced by
              torch.profiler: kernels and device time a replayed step, B3
              and B2 kernels counted in the trace
  main_path_scanned  the main path at SCANNED_LAYERS = 4 layers (cut
              from 8 for the time limit) with --unroll-k 4: a warm-up chunk,
              then 8 steps replayed from the CUDA graph, beside the same
              12 steps eager; the states equal bit for bit; launches
              counted on the warm-up chunk and, for the replays, from the
              capture
  dropout_path_scanned  the same depth with --topology-dropout 0.25 and
              --unroll-k 4 (a warm-up chunk, then 8 steps replayed from the
              CUDA graph, each W_k realized in it from the device step
              counter, B3 + B4), beside the same 12 steps eager; then with
              --topology-resample-every 4 and 3 (3: redraws inside the
              replayed chunks); the states equal bit for bit;
              B4's launches from the capture
  checkpoint_path  the main path at depth 4 (a 4.6 GB archive, past the
              plain ZIP's 4 GiB: the ZIP64 writer) with --unroll-k 4: 12 steps
              uninterrupted; 4 with --checkpoint-every 4 --keep-last 1,
              then --resume to 12 (a new graph's warm-up chunk, then one
              replay); gates: the manifest holds [4] and no staging
              debris, the resumed state equal to the uninterrupted one
              bit for bit, the losses of steps 4-11 equal, the warm-up's
              and the replay's launches; then 4 steps under
              --checkpoint-sync, the thread and the subprocess writer,
              one commit each at step 4: the caller's ms a save, the
              writer's s a commit, bytes, peak device memory, host peak
              RSS and each child's, load s; the resumed run's ms a
              replayed step after a save; gate: the three step-4
              archives equal leaf for leaf
              (build/chip_checkpoints/, removed after; it fails without
              room for three archives)
  fig2_trimmed_mean  the Fig. 2 workload with trimmed-mean aggregation,
              Markov crash/restart and scale-corrupt senders: 200 steps
              eager and through a CUDA graph of 100 steps (B3; the
              trimmed mean is plain torch), bitwise, losses and fault
              counters equal; --profile traces a replay (idle share)
  fault_realize  FaultProcess realized on the card from a device counter
              against the CPU's realization, steps 0-511, Markov,
              failstop and corrupt, bitwise; the card's log1p against the
              CPU's over all 2^23 uniforms (diagnostic)
  fault_path_scanned  the fault path (below) at the same depth with
              --unroll-k 4: a warm-up
              chunk and two replayed chunks (faults realized in the
              graph, down rows and the skip as where on one held anchor)
              beside the same 12 steps eager; bitwise, records and fault
              counters equal; B3 and B6 4 counted + 8 replayed
  ring_path_scanned  the ring path (below) at the same depth with
              --unroll-k 4, static and
              with Markov crash/restart, each beside 12 eager steps;
              bitwise; B9 4 + 8
  rollback_path  stablelm-3b-smoke f32: nan-corrupt senders, guard off,
              --nan-policy warn, checkpoints every 2 steps: two rollbacks,
              then the exhaustion error (B3 + B6); gate: records and
              error equal to a CPU run's
  rollback_path_scanned  the same with --unroll-k 2: non-finite chunks
              count toward the patience, the prefetch stream restarts at
              the restored step and the one captured graph replays on
              (B3 and B6 counted on one warm-up chunk); records and error
              equal to the CPU's
  privacy_audit  launch/audit.main on the card at the reference's defaults
              (m 5, dim 3, 8 parity steps, 40 attack steps, 200,000
              samples; B3 + B2), then with --topology-dropout 0.3 (B4 in
              the CUDA graph); gates: capture-on == capture-off bitwise on
              every path, the four paths' streams bitwise and ok,
              theta (kNN and binned) within 0.02 of 1.0322, DSGD's
              recovery exact (relative error < 1e-6), PDSGD's least-squares
              MSE at or above the Theorem-5 bound, theorem5 equal to a CPU
              run's; the attack numbers beside the CPU run's, capture on
              against off microseconds a replayed step
  privacy_capture_path  stablelm-3b at full width, depth 2, m 4, bf16: one
              step from one state with capture off, auditor() and
              external_eavesdropper() (concat: B3 + B2), then off and the
              eavesdropper on the ring layout (B9); V is (4, 4, D) f32,
              26.8 GB; gates: x' equal to capture-off bitwise, V's
              diagonal zero, concat V = w x - b u of B3's own u, ring V
              within u's bf16 rounding of concat V; ms on against off,
              peak memory, V's bytes bound
  baselines_path  the main path's configuration, eager, 3 steps each:
              --algorithm dsgt (peak carries the tracker pair), dp_dsgd
              --sigma-dp 0.01, pdsgd --grad-clip-kappa 1.0 (B3 + B2), dsgd
              (6 steps), then dsgd --unroll-k 3 equal to it bit for bit;
              then the plain dsgd and dsgt updates alone, device ms
              beside their bytes bounds; no
              B-kernel for the baselines
  dropout_path  the same model and entry point with --topology-dropout
              0.25 (B3 + B4), 1 warm-up + 6 timed steps, then one
              fused_pdsgd_flat(mask_key=...) update on its buffers (B5);
              B4 and B5 timed and checked there
  fault_path  the same model with Markov crash/restart, nan-corrupt
              senders, guard clip 1e3 and --nan-policy skip (B3 + B6), 6
              steps; B6 timed and checked at that path's shapes
  kernel_attention  B10 flash_attention against ref.flash_attention_ref,
              f32 and bf16, S in {1, 7, 127, 128, 129, 130, 255, 257, 2000}
              x hd in {8, 16, 32, 40, 64, 80, 112, 128} x (causal, causal +
              window 256, non-causal, non-causal + window 100); grouped-query
              prefill through
              models.transformer._attn (k, v repeated to H heads for B10)
              at granite-8b's H = 32, KV = 8, hd = 128, S in {130, 2000},
              f32 and bf16, against the plain grouped attention; timed at
              the serve path's (1, 2000, 32, 80) bf16 causal with its plain
              version and scaled_dot_product_attention (library, timed
              only), and at the hybrid serve path's (1, 2000, 32, 112)
              causal in f32 and bf16, and at the GQA and MoE serve
              paths' (1, 2000, 32, 128), (1, 2000, 16, 128) and (1, 2000,
              16, 64) in bf16 and f32, and at the enc-dec serve path's (8,
              2000, 16, 64) bf16 non-causal (its encoder) and causal (its
              decoder) and the VLM serve path's (1, 2560, 56, 128) bf16
              causal, each beside its plain version, SDPA in the same dtype
              and its bound
  kernel_ssd  B11 ssd_intra_chunk against ref.ssd_intra_chunk_ref, f32 and
              bf16 (bf16 held against f32 on the same inputs), over the
              reference sweep, xlstm-125m's folded shapes (P in {384, 1},
              N = 384, Q in {1, 7, 52, 64}) and zamba2-7b's (G, 64, 112,
              64), N = 64, G in {4, 16, 32}, and both sides of the
              kernel's routes and tiles
              (Q in {2, 15, 16, 17, 63, 65, 127}, ragged P and N); the
              autograd Function's gradients against autograd through the
              plain version; timed at the xLSTM serve prefill's (32, 64, 1,
              384), N = 384, bf16 and f32, then at each shape the xLSTM
              paths give it (training, prefill and decode; memory and
              normalizer calls) and the hybrid paths' (16 and 32, 64, 112,
              64), N = 64, f32 and bf16, each beside its own bound and
              plain version: device time from a CUDA graph of the calls
              replayed, the host's microseconds a call beside it
  kernel_ring B7 ring_gossip_update, B8 ring_obfuscate_gossip and B9
              ring_obfuscate_gossip_krng bitwise against their plain
              versions, f32 and bf16, on rings of m = 2, 4, 5, 32 and the
              (4, 2) torus: capture, a dropped direction, a planted nan, B9's
              bits and B9 == B8 on them; then B9 over leaf layouts that
              stress its per-tile leaf lookup (a boundary inside a tile, a
              leaf of many tiles, one-column leaves, padding past the last
              leaf, n no multiple of a tile)
  ring_path   the main path's model and flags with --kernel-layout ring (B9
              only, one launch a step), 1 warm-up + 6 timed steps, then one
              torus_gossip_pdsgd(None, ..., fused=True) on its buffers (B7);
              B9 and B7 checked and timed (B9 in turns with B3 and B2 on
              the same buffers) there, and the ring update held
              against the concat update (B3 + B2) on the same draws
  bits_path   the same entry point with kernel_rng=False (Lambda bits drawn
              outside the kernel, the reference's HBM-bits route) at depth
              2: B1 + B2, B1 timed and checked at that path's shapes
  ring_bits_path  the bits path with --kernel-layout ring: B8 every step,
              checked and timed at that path's shapes
  tree_forms  obfuscate_tree and gossip_tree (B1, B2 once each over the
              concatenated buffer) on 4 agents' trees of the bits path's
              layout: the bits against the CPU's draw, v bitwise the plain
              version, x' bitwise B2's FMA chains on samples and within
              one bf16 ulp of the plain version; timed
  leafwise_path  the bits path with --kernel-layout leafwise (B1 and B2,
              B4 with dropout 0.25, B6 with the fault flags, once per leaf
              a step), one step each (cut from 2), each beside the concat
              bits path: states and records bitwise; then --unroll-k 2
              beside 4 eager steps
  trivial_mesh_step  the (1, 1, 1) data x fsdp x model mesh on a one-rank
              NCCL group, leaf specs from TRAIN_RULES: three leafwise
              steps over DTensors, each against mesh=None from the same
              state, within B2's bf16 tolerance
  mesh_train_step  launch.steps.make_train_step on a stand-in mesh (m = 4
              on the card) at the bits path's width and depth, bf16,
              batch 2, seq 512, 3 steps: dense (B1 + B2), link dropout
              0.25 (B1 + B4), the ring fused (B7), crash faults (B1 + B4);
              each form's kernels launched every step, its first step
              within B2/B4/B7's bf16 allowance of the plain formula's,
              dense bitwise core.pdsgd.make_decentralized_step; then
              sharded=True on a one-rank NCCL (1, 1, 1) mesh bitwise the
              unsharded step; ms a step and peak memory of each form
  multihost_path  launch/multihost: stablelm-3b at the bits path's depth
              (D = 418,145,280 an agent), m = 4 on a ring, f32 parameters,
              batch 2, seq 512, 2 steps (cut from 3), --grad-clip-kappa
              1.0: --world 4
              (four rank processes on this card, HMAC-framed loopback
              sockets, the pipelined transport, --frames-ahead 1, a
              checkpoint of each shard at the end) against --world 1 in
              this process; gates: each rank's rows bitwise the world=1
              run's, no tag failures or drops, finite, B3 once a step in
              every rank (its counts summed by the launcher), step 0's u
              of agents 2 and 3 bitwise B3's plain version; per rank ms a
              step, compute, comm, wait and HMAC seconds, bytes sent,
              peak device memory and peak RSS; this host's loopback and
              HMAC rates
  multihost_smoke  stablelm-3b-smoke on the card, world 2 x 2 agents:
              the blocking transport against the pipelined one and the
              world=1 run, bitwise; --wiretap's merged stream equal to
              world=1's; --chaos-kill-rank 1 --chaos-kill-step 3, then
              --resume: the overlay's W doubly stochastic, the quorum
              step, generation 1, finite
  serve_parity  stablelm-3b-smoke f32, 4 requests on 2 slots, greedy,
              through launch/serve.run_serving on the card (B10) and on the
              CPU (naive attention), same weights: equal token streams,
              prefill logits within 1e-4
  serve_path  launch/serve with --arch stablelm-3b --slots 8 --requests 9
              --prompt-len 2000 --gen-tokens 64 --decode-chunk 8
              --parity-check: full width, depth 4 (cut from 32), bf16,
              B10 4 times a prefill; gate: the engine's streams equal the
              same-width oracle's exactly (below); --parity-check's M = 1
              comparison printed, and where it differs the batched-vs-B=1
              logit spread, the margin rule's record (the first near tie, a
              top-2 margin below the spread) and a layer-by-layer trace of
              the two residual streams in bf16 and in f32
  xlstm_step_parity  xlstm-125m-smoke f32, 4 agents, 2 steps: card vs CPU
  xlstm_train_path  run_training --arch xlstm-125m, 6 blocks (cut from 12
              for the time limit), d_model 768, 4 agents on a ring, bf16,
              PDSGD, per-agent batch 2, seq 128 (cut for the sLSTM's host
              loop), 1 warm-up + 3 timed steps: B3 + B2 every step, B11 48
              times a step (each mLSTM forward run again in its backward's
              recompute)
  xlstm_train_scanned  xlstm-125m at full width, 2 blocks (cut from 12
              for the time limit), 4 agents, seq 128, with --unroll-k 2: a
              warm-up chunk and two replays of one CUDA graph holding the
              sLSTM token loop, beside 6 eager steps; bitwise; B11 counted
              and replayed; the capture's seconds and the graph's nodes
  xlstm_serve_parity  xlstm-125m-smoke f32, 4 requests on 2 slots: card vs
              CPU
  xlstm_serve_path  launch/serve with --arch xlstm-125m --slots 8
              --requests 9 --prompt-len 500 (cut for the sLSTM's host loop)
              --gen-tokens 32 --decode-chunk 8 --parity-check: full width,
              4 blocks (cut from 12), bf16; B11 4 times a prefill and a
              decode step; the same gate as serve_path
  hybrid_step_parity  zamba2-7b-smoke f32 at 4 layers (both shared
              blocks), 4 agents, 1 step: card vs CPU
  hybrid_train_path  run_training --arch zamba2-7b, full width, 12 mamba
              layers (sites 5 and 11), 4 agents on a ring, bf16, PDSGD,
              per-agent batch 2, seq 512, 1 warm-up + 3 timed steps: B3 +
              B2 every step, B11 96 times a step (112 heads sharing B and
              C; each mamba forward run again in its backward's recompute)
  hybrid_train_scanned  the same with --unroll-k 2 (a warm-up chunk and
              two replays) beside 6 eager steps; bitwise; B11 96 a step
              counted and replayed
  hybrid_serve_parity  zamba2-7b-smoke f32, 4 requests on 2 slots: card vs
              CPU (B11 and B10 in every prefill)
  hybrid_serve_path  launch/serve with --arch zamba2-7b --slots 8
              --requests 9 --prompt-len 2000 --gen-tokens 32
              --decode-chunk 8 --parity-check: full width, 12 mamba layers
              and 2 attention sites (cut from 81 and 13), bf16 weights
              and an f32 residual stream; B11 12 and B10 2 times a
              prefill, none in
              decode; the same gate as serve_path; where the M = 1 check
              differs, the logit spread and a block-by-block trace of one
              decode step (batched against B = 1, after each mamba layer
              and each site: the gap carried so far and the gap that block
              alone makes on the same inputs)
  gqa_step_parity  chatglm3-6b-smoke (KV 2 of 8 heads, half rotary) and
              mistral-nemo's smoke model with 8 query heads of 16 on 2 KV
              heads (H hd 128 against d_model 256), f32, 4 agents, 2 steps:
              card vs CPU, each leaf no farther from a float64 CPU run than
              twice the CPU f32 run is
  moe_step_parity  olmoe-1b-7b-smoke f32 at capacity factor 1.0 (pairs
              dropped, counted on the CPU), 4 agents, 2 steps: card vs CPU
  gqa_train_path  run_training --arch chatglm3-6b, full width, 4 layers, 4
              agents on a ring, bf16, PDSGD, per-agent batch 2, seq 512,
              --grad-clip-kappa 1.0, 1 warm-up + 5 timed steps: B3 + B2
              every step
  gqa_train_scanned  the same with --unroll-k 2 (a warm-up chunk and
              two replays) beside 6 eager steps; bitwise
  recompute_peak_gqa  chatglm3-6b at full width, 4 layers: one agent's
              value and gradients at batch 1, seq 4096 (train_4k's), under
              remat_policy "full", "save_collectives" and no recompute:
              peak memory and ms each, loss and gradients bitwise equal
              (recompute_peak_hybrid: the same for zamba2-7b, 12 layers)
  moe_train_path  run_training --arch granite-moe-1b-a400m at full width
              and depth (24 layers, 32 experts top 8), the same flags;
              the routing in plain torch
  moe_train_scanned  the same with --unroll-k 2 (the routing captured;
              two replays) beside 6 eager steps; bitwise
  gqa_serve_path  launch/serve with --arch mistral-nemo-12b --slots 8
              --requests 8 --prompt-len 2000 --gen-tokens 32
              --decode-chunk 8 --parity-check: full width (KV 8, H hd
              4096 against d_model 5120), depth 20 (cut from 40 for the
              time limit), bf16, B10 20 times a prefill; the same gate as
              serve_path
  moe_serve_path  the same with --arch olmoe-1b-7b (64 experts top 8;
              prefill routes with capacity, decode mixes all experts),
              depth 8 (cut from 16), B10 8 times a prefill; the same gate
  granite_prefill  granite-8b at full width and depth: one 2000-token
              prefill, B10 held in place at each of its 36 layers against
              the plain grouped attention on the same q, k, v; the
              logits beside prefills with plain and with f32 attention
  encdec_serve_parity  seamless-m4t-medium-smoke f32, oneshot (2 rows of
              37 frames and tokens, 12 tokens) through run_serving on the
              card (B10 non-causal in the encoder, causal in the decoder)
              and on the CPU, same weights: rows equal, both --parity-check
              ok, the frames within 3 ulp; then one prefill of that
              batch (logits; k, v, xk, xv) and 4 decode steps (logits; k,
              v) held card against CPU within 1e-3 of each tensor's
              largest entry + rtol 1e-4
  encdec_serve_path  launch/serve with --arch seamless-m4t-medium --mode
              oneshot --slots 8 --prompt-len 2000 --gen-tokens 32
              --decode-chunk 8 --parity-check: full width and depth (12 +
              12 layers, d_model 1024, vocab 256206), bf16, 2000 frames a
              row; B10 24 times a prefill (12 non-causal, 12 causal; the
              encoder alone on one row: 12); cross-attention plain; gate:
              each row equal to the same-width oracle's (the row repeated
              over all 8, prefilled and decoded at that width); the M = 1
              --parity-check printed
  vlm_serve_parity  llava-next-34b-smoke f32 (KV = H) and its variant with
              2 KV heads of 8, 4 requests with 16 prefix embeds on 2 slots:
              card vs CPU (as serve_parity; the prefixes drawn within 3
              ulp of each other)
  vlm_serve_path  launch/serve with --arch llava-next-34b --slots 8
              --requests 8 --prompt-len 2560 --gen-tokens 32
              --decode-chunk 8 --parity-check: full width (d_model 7168,
              56 x 128 on 8 KV heads), depth 12 (cut from 60), bf16, 2304
              image embeddings and 256 text tokens a request; B10 12 times
              a prefill at (1, 2560, 56, 128); the same gate as serve_path
  kernels     every kernel with its launches in its own path's run (B3
              and B2: main_path, B3 also multihost_path's ranks and its
              world=1 run; B1, B2, B4 and B7 also the leafwise runs' and
              mesh_train_step's forms; B10: the seven serve paths and
              granite_prefill; B11: the xLSTM and hybrid train and serve
              paths), error, times and bound
Then B10's time and TFLOP/s at the serve shape beside those of
scaled_dot_product_attention in the same run, the card's name and power
limit, and the result line.  Each phase's line is also appended to
chiprun_out/chip_smoke.jsonl (emptied at the start).

The serve paths' gate is a same-width oracle: each request decoded alone,
its prefill paged into every row of a batch ``--slots`` rows wide and
decoded there at per-row positions, so every product has the engine's
shapes (M = slots); the engine's streams must equal it exactly.  The
M = 1 sequential decode (--parity-check) rounds its products differently
and is a diagnostic only.

Bounds: B1-B9 (elementwise and m <= 32 mixing): bytes each kernel must
move (inputs read once, outputs written once) over 3.35e12 B/s, or its
float operations over 67e12 FLOP/s (f32 outside the tensor cores), or,
for the kernels that draw threefry bits (B3, B9 one word an element, B5
one an edge), their 32-bit integer operations (73 a word, counted from
csrc/threefry.cuh) over 16.7e12 op/s (64 INT32 lanes an SM), whichever is
larger.  B10 (matmul-shaped): its bytes over 3.35e12 B/s or
its FLOPs over the unmasked (query, key) pairs, 4 hd per pair, over
989e12 FLOP/s (dense bf16 tensor cores), whichever is larger; its f32
CUDA-core bound (67e12) is printed beside it.  B11 (its products on tensor
cores): its bytes (x, Bm, Cm, dt, a_cum read once, y and the f32 states
written once) over 3.35e12 B/s or its FLOPs over 989e12 FLOP/s,
whichever is larger: 2 N per causal (i, j) pair for the scores, 2 H P per
pair for y, 2 Q H P N for the states, a chunk; its f32 CUDA-core bound
(67e12, the bound of the FMA kernel it replaced) is printed beside it.
(H100 SXM data sheet.)
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import faulthandler
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# 32-bit integer operations: 64 INT32 lanes an SM (Hopper white paper) x
# 132 SMs x 1.98 GHz, the clock of the f32 rate (132 x 128 x 2 x 1.98e9 =
# 67e12)
INT32_OPS = 132 * 64 * 1.98e9
# integer operations of one threefry draw as csrc/threefry.cuh does it: 2
# initial adds, 20 rounds of add, rotate and xor, 5 key injections of 2
# adds, the final xor (the key-only work, k2 and the injection constants,
# is per key and not counted)
THREEFRY_INT_OPS = 2 + 20 * 3 + 5 * 2 + 1
MAIN_LAYERS = 8
# record_function ranges of core/pdsgd.py's step
STEP_RANGES = ("coupling", "held_state", "agent_grads", "pdsgd_update",
               "dsgd_update", "dsgt_update", "dp_dsgd_update",
               "consensus_error")
BITS_PATH_LAYERS = 2


# every phase record is also kept here: the run's standard output is
# longer than what a caller may see of it
RECORDS = ROOT / "chiprun_out" / "chip_smoke.jsonl"
# each record carries the seconds since the script started (``script_s``):
# the script must end well inside its time limit
_T0 = time.perf_counter()


def emit(obj) -> None:
    line = json.dumps({**obj, "script_s": time.perf_counter() - _T0})
    print(line, flush=True)
    with RECORDS.open("a") as f:
        f.write(line + "\n")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(torch, fn, iters: int = 50, replays: int = 5) -> dict:
    """Device time of one call of ``fn`` apart from its host cost:
    ``iters`` calls captured in a CUDA graph and the graph replayed
    ``replays`` times between CUDA events (``device_ms``, the kernels back
    to back with the graph's launch gaps), and the host's microseconds a
    call with the calls issued eagerly one after another, no sync
    (``host_us``: the wrapper's dispatch, what a host-bound loop pays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    dev = t0.elapsed_time(t1) / (replays * iters)
    del graph
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - h0) / iters * 1e6
    torch.cuda.synchronize()
    return {"device_ms": dev, "host_us": host}


def bound_ms(nbytes: float, flops: float = 0.0,
             int_ops: float = 0.0) -> tuple[float, str]:
    """The least time of a kernel on the card: its bytes over the memory
    rate, its f32 operations over the f32 rate, its 32-bit integer
    operations over the integer rate, whichever is largest."""
    by = nbytes / HBM_BYTES_PER_S * 1e3
    op = max(flops / F32_FLOPS, int_ops / INT32_OPS) * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def same_bits(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bf16_ulps(torch, got, exact, scale) -> float:
    """Max over elements of |got - exact| / (bf16 spacing at |exact| +
    1e-6 * scale): got is a bf16 gossip result, exact the f32 one, scale
    |W| |X| + |B| |U| (the f32 summation-order allowance where the sum
    cancels).  <= 1 means within one bf16 ulp."""
    e = exact.float()
    spacing = torch.exp2(torch.floor(torch.log2(e.abs().clamp_min(1e-30)))
                         - 7)
    return float(((got.float() - e).abs() / (spacing + 1e-6 * scale)).max())


def gossip_scale(W, B, X, U):
    return W.abs() @ X.float().abs() + B.abs() @ U.float().abs()


def same_values(torch, a, b) -> bool:
    """Equal values, nan where the other has nan (payloads aside)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def rand_mask(torch, m: int, gen, dev, p: float = 0.6):
    """A symmetric 0/1 off-diagonal edge mask with agent 0 cut off (the
    row of a down agent)."""
    keep = torch.triu((torch.rand(m, m, generator=gen, device=dev) < p)
                      .float(), diagonal=1)
    mask = keep + keep.T
    mask[0, :] = 0.0
    mask[:, 0] = 0.0
    return mask


def col_stochastic(torch, support, gen):
    B = torch.rand(support.shape, generator=gen,
                   device=support.device) * support
    return B / B.sum(0)


def guarded_abs(torch, K, mask, B, X, U, XT, UT, clip):
    """|w_ii x_i| + |b_ii u_i| + sum_j |guard(w_ij xt_j - b_ij ut_j)|, the
    magnitude the guarded sum is rounded at (a non-finite link counts 0):
    where large clipped links cancel, a summation-order difference is
    relative to this, not to the result."""
    m = X.shape[0]
    w = K.ref.metropolis_ref(mask)
    eye = torch.eye(m, device=w.device)
    x, u = X.float(), U.float()
    total = ((torch.diagonal(w)[:, None] * x).abs()
             + (torch.diagonal(B)[:, None] * u).abs())
    v = ((w * (1 - eye))[:, :, None] * XT.float()[None]
         - (B * (1 - eye))[:, :, None] * UT.float()[None])
    if clip is not None:
        v = torch.clamp(v, -clip, clip)
    return total + v.abs().nan_to_num(0.0, 0.0, 0.0).sum(dim=1)


def guarded_check(torch, K, got, want, exact, mask, B, X, U, XT, UT, clip,
                  what: str):
    """B6 against its plain version: nan and inf exactly where the plain
    version has them; finite entries to B2's tolerances taken relative to
    the magnitude of the summed terms (`guarded_abs`): f32 |got - want| <=
    1e-5 (1 + scale); bf16 within one bf16 ulp of the f32 result ``exact``
    plus 1e-6 scale.  Returns (max abs error, max bf16 ulps) over the
    finite entries."""
    check(torch.equal(torch.isnan(got), torch.isnan(want))
          and torch.equal(torch.isinf(got), torch.isinf(want)),
          f"B6 {what}: non-finite positions differ from the plain version")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0, 0.0
    scale = guarded_abs(torch, K, mask, B, X, U, XT, UT, clip)
    diff = (got.float() - want.float()).abs()
    err = float(diff[fin].max())
    if got.dtype == torch.float32:
        ratio = float((diff / (1e-5 * (1.0 + scale)))[fin].max())
        check(ratio <= 1.0, f"B6 {what}: abs {err}, {ratio} of the "
                            f"tolerance")
        return err, 0.0
    e = exact.float()
    spacing = torch.exp2(torch.floor(torch.log2(
        e.abs().clamp_min(1e-30))) - 7)
    ulps = float(((got.float() - e).abs() / (spacing + 1e-6 * scale))[fin]
                 .max())
    check(ulps <= 1.0, f"B6 {what}: {ulps} bf16 ulps")
    return err, ulps


# --------------------------------------------------------------------------


def phase_device(torch, build):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    built = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in built["logs"].items()}
    rec = {"phase": "device", "nvidia_smi": smi,
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "build_s": built["seconds"], "ptxas": ptxas}
    emit(rec)
    return smi


def phase_kernels(torch, K, prng):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows, cols = 4, 1 << 22
    out = {}
    # B1: bitwise against the plain version, f32 and bf16, step scalars
    # and general ones
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        gr = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        bits = torch.randint(0, 2**32, (rows, cols), generator=g, device=dev,
                             dtype=torch.int64).to(torch.uint32)
        for scal in ((0.07, 0.0, -1.0), (0.13, 0.3, -0.7)):
            v = K.obfuscate_update(x, gr, bits, *scal)
            p = K.ref.obfuscate_ref(x, gr, bits, *scal)
            torch.cuda.synchronize()
            check(same_bits(torch, v, p), f"B1 {dtype} {scal} not bitwise")
        out[f"B1_{str(dtype)[6:]}_bitwise"] = True
    # B3: ragged multi-leaf layout; bits vs prng, v vs plain and vs B1
    sizes = [1_000_003, 5, 2_097_152, 77, 999_999, 1]
    offsets = torch.tensor([0, *itertools.accumulate(sizes)],
                           dtype=torch.int64)
    keys = torch.stack([prng.split(prng.fold_in(prng.key(11), a), len(sizes))
                        for a in range(rows)])
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        gr = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        v, bits = K.obfuscate_update_krng(x, gr, keys, offsets, 0.05, 0.0,
                                          -1.0, return_bits=True)
        want_bits = prng.leaf_bits(keys.to(dev), offsets, rows, cols)
        torch.cuda.synchronize()
        check(torch.equal(bits, want_bits), f"B3 {dtype} bits differ")
        check(same_bits(torch, v, K.ref.obfuscate_ref(x, gr, want_bits, 0.05,
                                                      0.0, -1.0)),
              f"B3 {dtype} v differs from the plain version")
        check(same_bits(torch, v, K.obfuscate_update(x, gr, bits, 0.05, 0.0,
                                                     -1.0)),
              f"B3 {dtype} v differs from B1 fed its bits")
        out[f"B3_{str(dtype)[6:]}_bitwise"] = True
        # jax's earlier threefry stream (the Fig. 2 target's), odd and
        # even leaves
        v, bits = K.obfuscate_update_krng(x, gr, keys, offsets, 0.05, 0.0,
                                          -1.0, return_bits=True,
                                          partitionable=False)
        want_bits = prng.leaf_bits(keys.to(dev), offsets, rows, cols,
                                   partitionable=False)
        torch.cuda.synchronize()
        check(torch.equal(bits, want_bits),
              f"B3 {dtype} original-stream bits differ")
        check(same_bits(torch, v, K.ref.obfuscate_ref(x, gr, want_bits, 0.05,
                                                      0.0, -1.0)),
              f"B3 {dtype} original-stream v differs")
        out[f"B3_{str(dtype)[6:]}_original_stream_bitwise"] = True
    # B2: f32 max abs/rel error; bf16 within 1 bf16 ulp of the f32 result
    for m in (4, 5, 32):
        W = torch.rand(m, m, generator=g, device=dev)
        B = torch.rand(m, m, generator=g, device=dev)
        W, B = W / W.sum(0), B / B.sum(0)
        X = torch.randn(m, cols, generator=g, device=dev)
        U = torch.randn(m, cols, generator=g, device=dev)
        got = K.gossip_update(W, B, X, U)
        want = K.ref.gossip_ref(W, B, X, U)
        err = (got - want).abs()
        abs_err = float(err.max())
        rel_err = float((err / want.abs().clamp_min(1e-6)).max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"B2 f32 m={m} abs {abs_err}")
        got16 = K.gossip_update(W, B, X.bfloat16(), U.bfloat16())
        exact = K.ref.gossip_ref(W, B, X.bfloat16().float(),
                                 U.bfloat16().float())
        ulps = bf16_ulps(torch, got16, exact,
                         gossip_scale(W, B, X.bfloat16(), U.bfloat16()))
        check(ulps <= 1.0, f"B2 bf16 m={m}: {ulps} bf16 ulps")
        out[f"B2_m{m}"] = {"f32_max_abs_err": abs_err,
                           "f32_max_rel_err": rel_err,
                           "bf16_max_ulps_vs_f32": ulps}
    emit({"phase": "kernel", "shape": [rows, cols],
          "tolerances": {"B1": "bitwise", "B3": "bitwise",
                         "B2_f32": "rtol 1e-5 atol 1e-5",
                         "B2_bf16": "1 bf16 ulp of the f32 result, plus 1e-6 (|W||X|+|B||U|) where the sum cancels"},
          "results": out})


def phase_kernels_coupled(torch, K):
    """B4, B5 and B6 against their plain versions at m = 4, 5, 32, f32 and
    bf16; B4's W_k and B5's mask bitwise."""
    from repro_torch.core.mixing import make_mixing
    from repro_torch.core.topology import make_topology
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    cols, gcols = 1 << 22, 1 << 18
    out = {}
    for m in (4, 5, 32):
        eye = torch.eye(m, device=dev)
        mask = rand_mask(torch, m, g, dev)
        B = col_stochastic(torch, mask + eye, g)
        Wk = K.ref.metropolis_ref(mask)
        X = torch.randn(m, cols, generator=g, device=dev)
        U = torch.randn(m, cols, generator=g, device=dev)
        rec = {}
        # B4: f32 to rtol/atol 1e-5, bf16 to one bf16 ulp of the f32 result
        got = K.masked_gossip_update(mask, B, X, U)
        want = K.ref.masked_gossip_ref(mask, B, X, U)
        rec["B4_f32_max_abs_err"] = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"B4 f32 m={m} abs {rec['B4_f32_max_abs_err']}")
        Xb, Ub = X.bfloat16(), U.bfloat16()
        got16 = K.masked_gossip_update(mask, B, Xb, Ub)
        exact = K.ref.gossip_ref(Wk, B, Xb.float(), Ub.float())
        rec["B4_bf16_max_ulps"] = bf16_ulps(torch, got16, exact,
                                            gossip_scale(Wk, B, Xb, Ub))
        check(rec["B4_bf16_max_ulps"] <= 1.0,
              f"B4 bf16 m={m}: {rec['B4_bf16_max_ulps']} bf16 ulps")
        # B4's on-chip W_k: with X = [I | 0] and U = 0 the first m columns
        # of the output are W_k exactly
        Xi = torch.zeros(m, 64, device=dev)
        Xi[:, :m] = eye
        Wgot = K.masked_gossip_update(mask, B, Xi, torch.zeros_like(Xi))
        check(same_bits(torch, Wgot[:, :m].contiguous(), Wk),
              f"B4 m={m}: on-chip W_k not bitwise metropolis_from_mask")
        rec["B4_Wk_bitwise"] = True
        # B5: the exported mask bitwise MixingProcess.realize's, in dropout
        # and resample mode over several steps; the output bitwise B4's on
        # that mask and to B2's tolerance of the plain version
        top = make_topology("ring", m)
        for mode, proc in (
                ("dropout", make_mixing(top, rate=0.25, seed=7)),
                ("resample", make_mixing(top, resample_every=3,
                                         resample_p=0.5, seed=9))):
            adj = proc.mask_adj().to(dev)
            for step in range(6):
                for Xs, Us in ((X, U), (Xb, Ub)):
                    o5, mk = K.masked_gossip_update_krng(
                        proc.mask_key(step), proc.keep_prob, adj, B, Xs, Us)
                    torch.cuda.synchronize()
                    check(same_bits(torch, mk.cpu(), proc.realize_mask(step)),
                          f"B5 m={m} {mode} step {step}: mask differs from "
                          f"MixingProcess.realize")
                    check(same_bits(torch, o5, K.masked_gossip_update(
                        mk, B, Xs, Us)),
                        f"B5 m={m} {mode} step {step}: output differs from "
                        f"B4 on its mask")
            o5, _ = K.masked_gossip_update_krng(
                proc.mask_key(5), proc.keep_prob, adj, B, X, U)
            p5, _ = K.ref.masked_gossip_krng_ref(
                proc.mask_key(5), proc.keep_prob, adj, B, X, U)
            check(torch.allclose(o5, p5, rtol=1e-5, atol=1e-5),
                  f"B5 m={m} {mode}: differs from the plain version")
            rec[f"B5_{mode}_mask_bitwise"] = True
        # B6: every corrupt mode, guard clip 1e3 and none
        corrupt = torch.zeros(m, device=dev)
        corrupt[1] = corrupt[m - 1] = 1.0
        for dtype in (torch.float32, torch.bfloat16):
            Xg = torch.randn(m, gcols, generator=g, device=dev).to(dtype)
            Ug = torch.randn(m, gcols, generator=g, device=dev).to(dtype)
            for cmode in ("nan", "inf", "scale"):
                XT = K.ref.poison_transmit(Xg, corrupt, cmode, 1e4)
                UT = K.ref.poison_transmit(Ug, corrupt, cmode, 1e4)
                for clip in (1e3, None):
                    what = f"m={m} {str(dtype)[6:]} {cmode} clip={clip}"
                    got = K.guarded_gossip_update(
                        mask, B, Xg, Ug, clip=clip, corrupt=corrupt,
                        mode=cmode, scale=1e4)
                    check(same_values(torch, got, K.guarded_gossip_update(
                        mask, B, Xg, Ug, XT, UT, clip)),
                        f"B6 {what}: in-register transmits differ from "
                        f"staged ones")
                    want = K.ref.guarded_gossip_ref(mask, B, Xg, Ug, XT, UT,
                                                    clip)
                    exact = K.ref.guarded_gossip_ref(
                        mask, B, Xg.float(), Ug.float(), XT.float(),
                        UT.float(), clip)
                    err, ulps = guarded_check(torch, K, got, want, exact,
                                              mask, B, Xg, Ug, XT, UT, clip,
                                              what)
                    rec[f"B6_{str(dtype)[6:]}_{cmode}_clip{clip}"] = {
                        "max_abs_err": err, "max_bf16_ulps": ulps,
                        "nonfinite": int((~torch.isfinite(got)).sum())}
        out[f"m{m}"] = rec
    emit({"phase": "kernel_coupled", "shape_B4_B5": [None, cols],
          "shape_B6": [None, gcols],
          "tolerances": {
              "B4_f32": "rtol 1e-5 atol 1e-5", "B4_bf16": "1 bf16 ulp",
              "B4_Wk": "bitwise", "B5_mask": "bitwise",
              "B5_out": "bitwise B4 on its mask",
              "B6": "nan/inf positions exact; finite: f32 1e-5 (1 + S), "
                    "bf16 1 bf16 ulp + 1e-6 S, S = sum of |terms|"},
          "results": out})


# leaves of a flat buffer for the strided launches (the leafwise layout):
# ragged sizes at starts on no vector boundary, a one-column leaf, a leaf
# shorter than the run to its first aligned column
LEAF_SIZES = (1_000_003, 5, 1, 2_097_152, 77, 3, 999_999, 1)


def phase_kernels_strided(torch, K):
    """B1, B2, B4 and B6 launched once per leaf on its columns of (m,
    width) flat buffers, read and written in place (rows width apart,
    starts unaligned), bitwise the same kernel launched once on the
    whole contiguous buffer, at m = 4, 5, 32, f32 and bf16."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    offs = [0, *itertools.accumulate(LEAF_SIZES)]
    width = -(-offs[-1] // 512) * 512
    cols = list(zip(offs[:-1], offs[1:]))
    out = {}
    for m in (4, 5, 32):
        eye = torch.eye(m, device=dev)
        mask = rand_mask(torch, m, g, dev)
        B = col_stochastic(torch, mask + eye, g)
        W = col_stochastic(torch, mask + eye, g)
        corrupt = torch.zeros(m, device=dev)
        corrupt[m - 1] = 1.0
        for dtype in (torch.float32, torch.bfloat16):
            X = torch.randn(m, width, generator=g, device=dev).to(dtype)
            G = torch.randn(m, width, generator=g, device=dev).to(dtype)
            bits = torch.randint(0, 2**32, (m, width), generator=g,
                                 device=dev, dtype=torch.int64
                                 ).to(torch.uint32)
            lam = torch.tensor(0.03, device=dev)
            whole_u = K.obfuscate_update(X, G, bits, lam, 0.0, -1.0)
            U = torch.empty_like(G)
            for o, o1 in cols:
                K.obfuscate_update(X[:, o:o1], G[:, o:o1], bits[:, o:o1],
                                   lam, 0.0, -1.0, out=U[:, o:o1])
            what = f"m={m} {str(dtype)[6:]}"
            check(same_bits(torch, U[:, :offs[-1]], whole_u[:, :offs[-1]]),
                  f"B1 strided {what} differs from the whole-buffer launch")
            runs = {
                "B2": (lambda x, u, o: K.gossip_update(W, B, x, u, out=o)),
                "B4": (lambda x, u, o: K.masked_gossip_update(mask, B, x, u,
                                                              out=o)),
                "B6": (lambda x, u, o: K.guarded_gossip_update(
                    mask, B, x, u, clip=1e3, corrupt=corrupt, mode="scale",
                    scale=1e4, out=o))}
            for name, run in runs.items():
                whole = run(X, whole_u, None)
                Y = X.clone()
                for o, o1 in cols:
                    run(Y[:, o:o1], whole_u[:, o:o1], Y[:, o:o1])
                torch.cuda.synchronize()
                check(same_bits(torch, Y[:, :offs[-1]], whole[:, :offs[-1]]),
                      f"{name} strided {what} differs from the whole-buffer "
                      f"launch")
            out[what] = "bitwise"
    emit({"phase": "kernel_strided", "leaf_sizes": list(LEAF_SIZES),
          "width": width, "tolerance": "bitwise the whole-buffer launch",
          "results": out})


RING_TORI = ((2, 1), (4, 1), (5, 1), (32, 1), (4, 2))
# (leaf sizes, columns) that stress B9's per-tile leaf lookup (a warp's
# tile is 32 VEC columns: 128, 64 or 32 as m <= 4, 8, 32): boundaries
# inside tiles, a leaf of many tiles, one-column leaves, padding starting
# inside a tile, columns no multiple of any tile
RING_LEAF_LAYOUTS = {
    "boundary_in_tile": ([200, 3000, 56, 700], 3960),
    "long_leaf": ([128 * 40 + 40, 8], 5176),
    "one_column": ([1] * 40 + [100], 144),
    "padding": ([1000], 1536),
    "ragged_n": ([600, 560], 1160),
}


def phase_kernels_ring(torch, K, prng):
    """B7, B8 and B9 bitwise against their plain versions on the card, f32
    and bf16, on rings of m = 2, 4, 5, 32 (ndirs 1, 2, 2, 2) and the (4, 2)
    torus (ndirs 3): the capture streams, the output with capture off, a
    dropped direction's v exactly 0, a nan planted in one sender's g at
    the plain version's positions, B9's exported bits = `prng.leaf_bits`
    and B9 = B8 on them; then, on every ring and torus, B9 over
    RING_LEAF_LAYOUTS: bits = `prng.leaf_bits`, output = B8's on them, and
    the same written over X."""
    from repro_torch.dist import collectives as C
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    cols = 1 << 20
    sizes = [300_003, 5, 524_288, 77, 99_999, 1]
    offsets = torch.tensor([0, *itertools.accumulate(sizes)],
                           dtype=torch.int64)
    out = {}
    for n_data, n_pod in RING_TORI:
        m = n_data * n_pod
        P = C.perm_stack(n_data, n_pod)
        src = C.source_table(n_data, n_pod)
        Pd = P.to(dev)
        nd = P.shape[0]
        w = torch.rand(m, 1 + nd, generator=g, device=dev)
        b = C.mask_b_draws(torch.rand(m, 1 + nd, generator=g, device=dev),
                           torch.ones(m, nd, device=dev))
        # direction 0 dropped: its weight folded into the self term, b
        # renormalized onto the other directions
        keep = torch.ones(m, nd, device=dev)
        keep[:, 0] = 0.0
        b_drop = C.mask_b_draws(b, keep)
        w_drop = w.clone()
        w_drop[:, 0] += w_drop[:, 1]
        w_drop[:, 1] = 0.0
        keys = torch.stack([prng.split(prng.fold_in(prng.key(m), a),
                                       len(sizes)) for a in range(m)])
        bits = prng.leaf_bits(keys.to(dev), offsets, m, cols)
        rec = {}
        for dtype in (torch.float32, torch.bfloat16):
            X = torch.randn(m, cols, generator=g, device=dev).to(dtype)
            U = torch.randn(m, cols, generator=g, device=dev).to(dtype)
            G = torch.randn(m, cols, generator=g, device=dev).to(dtype)
            what = f"{n_data}x{n_pod} {str(dtype)[6:]}"
            # B7
            o7, v7 = K.ring_gossip_update(w, b, P, X, U, capture=True)
            p7 = K.ref.ring_gossip_ref(w, b, Pd, X, U)
            check(same_bits(torch, o7, p7[0]) and same_bits(torch, v7, p7[1]),
                  f"B7 {what}: differs from the plain version")
            check(same_bits(torch, K.ring_gossip_update(w, b, src, X, U), o7),
                  f"B7 {what}: capture changes the output")
            od, vd = K.ring_gossip_update(w_drop, b_drop, src, X, U,
                                          capture=True)
            check(bool((vd[0] == 0).all()) and bool((vd[1:] != 0).any()
                                                     or nd == 1),
                  f"B7 {what}: a dropped direction's v is not exactly 0")
            check(same_bits(torch, od, K.ref.ring_gossip_ref(
                w_drop, b_drop, Pd, X, U)[0]),
                f"B7 {what}: dropped direction differs from the plain "
                f"version")
            # B8, with a nan planted in one sender's g
            o8, v8, u8 = K.ring_obfuscate_gossip(w, b, src, X, G, bits, 0.05,
                                                 capture=True)
            p8 = K.ref.ring_obfuscate_gossip_ref(w, b, Pd, X, G, bits, 0.05)
            check(all(same_bits(torch, a, c) for a, c in zip((o8, v8, u8),
                                                             p8)),
                  f"B8 {what}: differs from the plain version")
            check(same_bits(torch, K.ring_obfuscate_gossip(
                w, b, P, X, G, bits, 0.05), o8),
                f"B8 {what}: capture changes the output")
            Gn = G.clone()
            Gn[m - 1, 4099] = float("nan")
            on = K.ring_obfuscate_gossip(w, b, src, X, Gn, bits, 0.05)
            pn = K.ref.ring_obfuscate_gossip_ref(w, b, Pd, X, Gn, bits,
                                                 0.05)[0]
            check(same_values(torch, on.float(), pn.float())
                  and bool(torch.isnan(on[:, 4099]).all()),
                  f"B8 {what}: a planted nan reaches other positions than "
                  f"in the plain version")
            # B9: its bits are leaf_bits, its output B8's on them
            o9, v9, u9, b9 = K.ring_obfuscate_gossip_krng(
                w, b, src, X, G, keys, offsets, 0.05, capture=True,
                export_bits=True)
            check(torch.equal(b9, bits), f"B9 {what}: bits differ from "
                                         f"prng.leaf_bits")
            check(all(same_bits(torch, a, c) for a, c in zip(
                (o9, v9, u9), (o8, v8, u8))),
                f"B9 {what}: differs from B8 on its bits")
            check(same_bits(torch, K.ring_obfuscate_gossip_krng(
                w, b, src, X, G, keys, offsets, 0.05), o8),
                f"B9 {what}: capture changes the output")
            rec[str(dtype)[6:]] = {"bitwise": True, "nan_positions": int(
                torch.isnan(on).sum())}
        out[f"{n_data}x{n_pod}"] = {"m": m, "ndirs": nd, **rec}
    layouts = {}
    for name, (lsizes, lcols) in RING_LEAF_LAYOUTS.items():
        for n_data, n_pod in RING_TORI:
            m = n_data * n_pod
            src = C.source_table(n_data, n_pod)
            nd = src.shape[0]
            w = torch.rand(m, 1 + nd, generator=g, device=dev)
            b = torch.rand(m, 1 + nd, generator=g, device=dev)
            loff = torch.tensor([0, *itertools.accumulate(lsizes)],
                                dtype=torch.int64)
            keys = torch.stack([prng.split(prng.fold_in(prng.key(m + 7), a),
                                           len(lsizes)) for a in range(m)])
            bits = prng.leaf_bits(keys.to(dev), loff, m, lcols)
            for dtype in (torch.float32, torch.bfloat16):
                X = torch.randn(m, lcols, generator=g, device=dev).to(dtype)
                G = torch.randn(m, lcols, generator=g, device=dev).to(dtype)
                what = f"{name} {n_data}x{n_pod} {str(dtype)[6:]}"
                o9, b9 = K.ring_obfuscate_gossip_krng(
                    w, b, src, X, G, keys, loff, 0.05, export_bits=True)
                o8 = K.ring_obfuscate_gossip(w, b, src, X, G, bits, 0.05)
                check(torch.equal(b9, bits), f"B9 {what}: bits differ from "
                                             f"prng.leaf_bits")
                check(same_bits(torch, o9, o8), f"B9 {what}: differs from "
                                                f"B8 on its bits")
                Xi = X.clone()
                K.ring_obfuscate_gossip_krng(w, b, src, Xi, G, keys, loff,
                                             0.05, out=Xi)
                check(same_bits(torch, Xi, o8), f"B9 {what}: in place "
                                                f"differs")
        layouts[name] = {"cols": lcols, "leaves": len(lsizes),
                         "bitwise": True}
    emit({"phase": "kernel_ring", "cols": cols, "leaf_sizes": sizes,
          "tolerances": {"B7": "bitwise", "B8": "bitwise (nan positions "
                         "exact)", "B9": "bitwise, bits = prng.leaf_bits, "
                         "= B8 on its bits"},
          "results": out, "b9_leaf_layouts": layouts})


# 127, 129, 255, 257: both sides of B10's 128-row tile edges
ATTN_SEQS = (1, 7, 127, 128, 129, 130, 255, 257, 2000)
# 8 and 40: hd padded to a multiple of 16 on the tensor-core path; 80 one
# 128-byte and one 32-byte box; 112 (zamba2-7b) one 128-byte and three
# 32-byte boxes; 128 two 128-byte boxes
ATTN_HEAD_DIMS = (8, 16, 32, 40, 64, 80, 112, 128)
# (causal, window): the three modes the serve path and the reference's
# sweep use, and a non-causal window (tiles whose rows are all masked)
ATTN_MODES = ((True, None), (True, 256), (False, None), (False, 100))
# the serve path's prefill attention: (1, prompt 2000, 32 heads, 80) bf16
SERVE_ATTN_SHAPE = (1, 2000, 32, 80)
# the hybrid serve path's: zamba2-7b's shared attention, hd 112, f32 (every
# site follows a mamba block), timed in bf16 too
HYBRID_ATTN_SHAPE = (1, 2000, 32, 112)
# the GQA and MoE serve paths' prefill attention after _attn's repeat of
# k and v: (1, 2000, 32, 128) granite-8b, mistral-nemo-12b and
# chatglm3-6b, (1, 2000, 16, 128) olmoe-1b-7b, (1, 2000, 16, 64)
# granite-moe-1b-a400m
GQA_SERVE_ATTN_SHAPES = ((1, 2000, 32, 128), (1, 2000, 16, 128),
                         (1, 2000, 16, 64))
# the enc-dec serve path's prefill (seamless-m4t-medium, 8 rows of 2000
# frames and 2000 tokens, 16 heads of 64): the encoder's bidirectional
# self-attention (causal False) and the decoder's causal one; the VLM
# serve path's (llava-next-34b, 2560 positions, 56 query heads of 128 after
# _attn's 7x repeat of its 8 KV heads), causal
ENCDEC_ATTN_SHAPE = (8, 2000, 16, 64)
VLM_ATTN_SHAPE = (1, 2560, 56, 128)
# grouped-query prefill through models.transformer._attn: granite-8b's
# heads (H = 32 query, KV = 8, hd = 128)
GQA_HEADS = (32, 8, 128)
GQA_SEQS = (130, 2000)


def attn_tolerance(torch, dtype, S: int) -> float:
    """B10 against its plain version: the reference's sweep tolerance
    (tests/test_kernels.py:31), atol = rtol = 2e-6 in f32 (1e-5 at S =
    2000, where the sums run over 2000 keys in another order) and 2e-2 in
    bf16 (the plain version rounds its logits to bf16, the kernel keeps
    its scores in f32)."""
    if dtype == torch.float32:
        return 1e-5 if S >= 2000 else 2e-6
    return 2e-2


def attn_bound(B: int, S: int, H: int, hd: int, elem: int, causal: bool,
               window):
    """(bytes, FLOPs) B10 must move and do: q, k, v read once and o written
    once; 4 hd FLOPs (q.k and p.v) per unmasked (query, key) pair."""
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        pairs += hi - lo
    return 4 * B * S * H * hd * elem, 4 * hd * H * B * pairs


def phase_kernel_attention(torch, K):
    """B10 flash_attention against ref.flash_attention_ref, f32 and bf16,
    over S x hd x mode; then timed at the serve path's shape with its plain
    version and scaled_dot_product_attention (the library call, timed only),
    and B10's and models.common.attention's bf16 error against f32 on the
    same bf16 inputs."""
    from repro_torch.models.common import attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    worst = {}
    n_cases = 0
    for S, hd, (causal, window), dtype in itertools.product(
            ATTN_SEQS, ATTN_HEAD_DIMS, ATTN_MODES,
            (torch.float32, torch.bfloat16)):
        B, H = 2, 2
        q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        got = K.flash_attention(q, k, v, causal=causal, window=window)
        want = K.ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        tol = attn_tolerance(torch, dtype, S)
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / (tol + tol * want.float().abs())).max())
        what = (f"B10 {str(dtype)[6:]} S={S} hd={hd} causal={causal} "
                f"window={window}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        check(ratio <= 1.0, f"{what}: max abs {float(diff.max())}, "
                            f"{ratio} of the tolerance")
        key = str(dtype)[6:]
        w = worst.setdefault(key, {"max_abs_err": 0.0, "max_tol_ratio": 0.0})
        w["max_abs_err"] = max(w["max_abs_err"], float(diff.max()))
        w["max_tol_ratio"] = max(w["max_tol_ratio"], ratio)
        if S == 2000:
            w["max_abs_err_S2000"] = max(w.get("max_abs_err_S2000", 0.0),
                                         float(diff.max()))
        n_cases += 1
    # grouped-query prefill: _attn repeats k and v to H heads for B10;
    # held against the plain grouped attention on the same inputs
    from repro_torch.models.transformer import _attn
    H, KV, hd = GQA_HEADS
    gqa = {}
    for S, dtype in itertools.product(GQA_SEQS,
                                      (torch.float32, torch.bfloat16)):
        q = torch.randn(1, S, H, hd, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(1, S, KV, hd, generator=g, device=dev).to(dtype)
                for _ in range(2))
        got = _attn(q, k, v, None)
        want = attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        tol = attn_tolerance(torch, dtype, S)
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / (tol + tol * want.float().abs())).max())
        what = f"GQA _attn {str(dtype)[6:]} S={S} H={H} KV={KV} hd={hd}"
        check(got.shape == q.shape and bool(torch.isfinite(got).all()),
              f"{what}: shape or non-finite")
        check(ratio <= 1.0, f"{what}: max abs {float(diff.max())}, {ratio} "
                            f"of the tolerance")
        gqa[f"{str(dtype)[6:]} S={S}"] = {"max_abs_err": float(diff.max()),
                                          "tol_ratio": ratio}
    # the serve path's shape
    B, S, H, hd = SERVE_ATTN_SHAPE
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev)
               .bfloat16() for _ in range(3))
    got = K.flash_attention(q, k, v, causal=True)
    want = K.ref.flash_attention_ref(q, k, v, causal=True)
    exact = K.ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=True)
    naive = attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
          f"B10 serve shape: max abs {err}")
    vs_f32 = {"B10": float((got.float() - exact).abs().max()),
              "attention": float((naive.float() - exact).abs().max()),
              "ref": float((want.float() - exact).abs().max())}
    row = {"ms": time_ms(torch, lambda: K.flash_attention(q, k, v,
                                                          causal=True),
                         iters=20),
           "max_abs_err": err}
    row["plain_ms"] = time_ms(torch, lambda: K.ref.flash_attention_ref(
        q, k, v, causal=True), iters=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"] = time_ms(torch, lambda: sdpa(qh, kh, vh,
                                                    is_causal=True),
                                iters=20)
    nbytes, flops = attn_bound(B, S, H, hd, 2, True, None)
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_TC_FLOPS * 1e3
    row["bound_ms"], row["bound_by"] = (by, "bytes") if by >= op else (
        op, "operations")
    row["bound_f32_cuda_cores_ms"] = flops / F32_FLOPS * 1e3
    row["tflops"] = flops / row["ms"] / 1e9
    row["library_tflops"] = flops / row["library_ms"] / 1e9
    row["ms_over_library"] = row["ms"] / row["library_ms"]
    # the hybrid serve path's shape, f32 (as the path runs it) and bf16,
    # and the GQA and MoE serve paths' shapes (bf16, as they run it, and
    # f32), each beside its plain version, SDPA in the same dtype and its
    # bound
    hybrid = {str(dtype)[6:]: _b10_timed(torch, K, g, HYBRID_ATTN_SHAPE,
                                         dtype)
              for dtype in (torch.float32, torch.bfloat16)}
    gqa_serve = {f"{shape} {str(dtype)[6:]}": _b10_timed(torch, K, g, shape,
                                                         dtype)
                 for shape in GQA_SERVE_ATTN_SHAPES
                 for dtype in (torch.bfloat16, torch.float32)}
    # the enc-dec and VLM serve paths' shapes, bf16 as they run them
    encdec = {("causal" if causal else "non-causal"): _b10_timed(
        torch, K, g, ENCDEC_ATTN_SHAPE, torch.bfloat16, causal)
        for causal in (False, True)}
    vlm = _b10_timed(torch, K, g, VLM_ATTN_SHAPE, torch.bfloat16)
    emit({"phase": "kernel_attention", "cases": n_cases,
          "seqs": ATTN_SEQS, "head_dims": ATTN_HEAD_DIMS,
          "modes": [list(m) for m in ATTN_MODES],
          "tolerance": "allclose atol = rtol = 2e-6 f32 (1e-5 at S=2000), "
                       "2e-2 bf16, vs ref.flash_attention_ref",
          "results": worst, "gqa_heads": list(GQA_HEADS),
          "gqa_vs_attention": gqa, "serve_shape": list(SERVE_ATTN_SHAPE),
          "serve_shape_bf16_max_abs_err_vs_f32": vs_f32,
          "serve_shape_flops": flops, "serve_shape_bytes": nbytes,
          "B10": row, "hybrid_shape": list(HYBRID_ATTN_SHAPE),
          "B10_hybrid_shape": hybrid, "B10_gqa_serve_shapes": gqa_serve,
          "encdec_shape": list(ENCDEC_ATTN_SHAPE), "B10_encdec_shape": encdec,
          "vlm_shape": list(VLM_ATTN_SHAPE), "B10_vlm_shape": vlm})
    return row


def _b10_timed(torch, K, g, shape, dtype, causal: bool = True) -> dict:
    """B10 (``causal`` or bidirectional) at ``shape`` (B, S, H, hd) in
    ``dtype`` on random inputs: held against its plain version
    (`attn_tolerance`), then timed beside the plain version and SDPA in
    the same dtype, with its bound (the tensor-core rate in bf16, the CUDA
    cores' in f32)."""
    B, S, H, hd = shape
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
               for _ in range(3))
    got = K.flash_attention(q, k, v, causal=causal)
    want = K.ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = attn_tolerance(torch, dtype, S)
    diff = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got).all()) and float(
        (diff / (tol + tol * want.float().abs())).max()) <= 1.0,
        f"B10 {shape} causal={causal} {str(dtype)[6:]}: max abs "
        f"{float(diff.max())}")
    del want
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    elem = 4 if dtype == torch.float32 else 2
    nbytes, flops = attn_bound(B, S, H, hd, elem, causal, None)
    by = nbytes / HBM_BYTES_PER_S * 1e3
    op = flops / (F32_FLOPS if dtype == torch.float32
                  else BF16_TC_FLOPS) * 1e3
    h = {"ms": time_ms(torch, lambda: K.flash_attention(q, k, v,
                                                        causal=causal),
                       iters=20),
         "max_abs_err": float(diff.max()),
         "plain_ms": time_ms(torch, lambda: K.ref.flash_attention_ref(
             q, k, v, causal=causal), iters=5),
         "library_ms": time_ms(torch, lambda: sdpa(qh, kh, vh,
                                                   is_causal=causal),
                               iters=20)}
    h["bound_ms"], h["bound_by"] = (by, "bytes") if by >= op else (
        op, "operations")
    h["tflops"] = flops / h["ms"] / 1e9
    h["ms_over_library"] = h["ms"] / h["library_ms"]
    return h


# B11 (G, Q, H, P, N): the reference sweep (tests/test_kernels.py:67-68);
# xlstm-125m's mLSTM with its heads folded into G (H = 1, N = 384): the
# memory (P = 384) and normalizer (P = 1) calls at Q = 1 (decode), 7 and
# 52 (short prompts) and 64 (full chunks); zamba2-7b's native Mamba2 form
# (112 heads, P = N = 64, B and C shared) at a few chunks and at its train
# and prefill calls
SSD_SHAPES = ((2, 64, 2, 8, 16), (4, 32, 3, 16, 8), (1, 128, 1, 4, 32),
              *((16, Q, 1, P, 384) for P in (384, 1) for Q in (1, 7, 52, 64)),
              *((G, 64, 112, 64, 64) for G in (4, 16, 32)),
              # both sides of the decode route's Q < 16 and of the tensor
              # cores' padded chunk (16, 32, 64, 128); P and N past a tile
              # (vector staging), then odd ones (element staging)
              *((3, Q, 2, 72, 80) for Q in (2, 15, 16, 17, 63, 65, 127)),
              (2, 33, 1, 5, 13), (2, 9, 3, 37, 261))
# the xLSTM serve prefill's memory call: a 500-token prompt padded to 8
# chunks of 64, 4 heads folded: G = 32, P = N = 384
SSD_SERVE_SHAPE = (32, 64, 1, 384, 384)
# every shape the xLSTM and hybrid paths give B11 (G, Q, H, P, N): each
# mLSTM block makes a memory call (P = 384) and a normalizer call (P = 1);
# training folds per-agent batch 2 x 2 chunks x 4 heads, a prefill 8
# chunks x 4 heads, a decode step 8 slots x 4 heads at Q = 1.  A zamba2-7b
# mamba layer makes one call, its 112 heads sharing B and C: training
# per-agent batch 2 x 8 chunks of a 512-token sequence, a prefill the 32
# chunks of a 2000-token prompt
SSD_PATH_SHAPES = {
    **{f"{path} {call}": (G, Q, 1, P, 384)
       for path, G, Q in (("train", 16, 64), ("prefill", 32, 64),
                          ("decode", 32, 1))
       for call, P in (("memory", 384), ("normalizer", 1))},
    "hybrid train": (16, 64, 112, 64, 64),
    "hybrid prefill": (32, 64, 112, 64, 64)}
BF16_U = 2.0 ** -8  # bf16's unit roundoff


def ssd_inputs(torch, shape, dtype, g, dev):
    """x, dt, a_cum, Bm, Cm as the reference sweep draws them: dt = |z| / 2,
    a_cum the within-chunk cumsum of dt A with A < 0."""
    G, Q, H, P, N = shape
    x = torch.randn(G, Q, H, P, generator=g, device=dev).to(dtype)
    dt = torch.randn(G, Q, H, generator=g, device=dev).abs() * 0.5
    A = -torch.randn(H, generator=g, device=dev).abs()
    a_cum = torch.cumsum(dt * A, dim=1)
    Bm, Cm = (torch.randn(G, Q, N, generator=g, device=dev).to(dtype)
              for _ in range(2))
    return x, dt, a_cum, Bm, Cm


def ssd_bound(G: int, Q: int, H: int, P: int, N: int, elem: int):
    """(bytes, FLOPs) B11 must move and do: x, Bm, Cm (elem bytes), dt and
    a_cum (f32) read once, y (elem) and the f32 states written once; the
    scores over the causal pairs 2 N Q(Q+1)/2 a chunk, y 2 H P Q(Q+1)/2,
    the states 2 Q H P N."""
    nbytes = (G * Q * H * P * elem * 2 + 2 * G * Q * N * elem
              + 2 * G * Q * H * 4 + G * H * P * N * 4)
    pairs = Q * (Q + 1) // 2
    flops = G * (2 * N * pairs + 2 * H * P * pairs + 2 * Q * H * P * N)
    return nbytes, flops


def ssd_tc_bound(nbytes: float, flops: float) -> tuple[float, str]:
    """B11's bound on tensor cores: its bytes over the memory rate or its
    FLOPs over the dense bf16 tensor-core rate, whichever is larger."""
    by = nbytes / HBM_BYTES_PER_S * 1e3
    op = flops / BF16_TC_FLOPS * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def phase_kernel_ssd(torch, K):
    """B11 ssd_intra_chunk against ref.ssd_intra_chunk_ref over SSD_SHAPES,
    f32 and bf16, each tolerance taken relative to ``mag``, the plain
    version on |x|, |Bm|, |Cm| (the sum of the absolute terms): f32
    |B11 - plain| <= 1e-5 (1 + mag); bf16 held against the f32 computation
    on the same bf16 inputs (``exact``): B11's y within one bf16 rounding,
    2^-8 |exact| + 1e-5 (1 + mag), its f32 states within 1e-5 (1 + mag);
    the plain version's y within 2^-7 mag + 2^-8 |exact| + 1e-5 (1 + mag)
    (it rounds the scores and the weights to bf16 too).  Then the autograd
    Function's gradients (B11 forward, the plain version's backward)
    against autograd through the plain version, f32, atol = rtol = 1e-6;
    then B11 timed at the xLSTM serve prefill's memory call, bf16 (and f32,
    the dtype of the blocks after the first), beside its plain version, and
    at each shape the xLSTM and hybrid paths give it, beside its plain
    version: device time from a CUDA graph of 50 calls replayed
    (`device_ms`), the host's microseconds a call beside it, and the eager
    CUDA-event time (``events_ms``, which at a few microseconds of device
    time measures the host's dispatch)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    plain = K.ref.ssd_intra_chunk_ref
    worst: dict = {}
    n_cases = 0

    def ratio(err, bound):
        return float((err / bound).max())

    for shape, dtype in itertools.product(SSD_SHAPES,
                                          (torch.float32, torch.bfloat16)):
        x, dt, a_cum, Bm, Cm = ssd_inputs(torch, shape, dtype, g, dev)
        y, s = K.ssd_intra_chunk(x, dt, a_cum, Bm, Cm)
        y_p, s_p = plain(x, dt, a_cum, Bm, Cm)
        ex_y, ex_s = plain(x.float(), dt, a_cum, Bm.float(), Cm.float())
        mag_y, mag_s = plain(x.float().abs(), dt, a_cum, Bm.float().abs(),
                             Cm.float().abs())
        torch.cuda.synchronize()
        what = f"B11 {str(dtype)[6:]} (G, Q, H, P, N) = {shape}"
        check(y.shape == x.shape and y.dtype == dtype
              and s.shape == (shape[0], shape[2], shape[3], shape[4])
              and s.dtype == torch.float32, f"{what}: output shapes")
        check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
              f"{what}: non-finite")
        tol_y, tol_s = 1e-5 * (1 + mag_y), 1e-5 * (1 + mag_s)
        err_y = (y.float() - y_p.float()).abs()
        err_s = (s - s_p).abs()
        if dtype == torch.float32:
            r = {"y": ratio(err_y, tol_y), "states": ratio(err_s, tol_s)}
        else:
            r = {"y_vs_f32": ratio((y.float() - ex_y).abs(),
                                   BF16_U * ex_y.abs() + tol_y),
                 "states_vs_f32": ratio((s - ex_s).abs(), tol_s),
                 "plain_y_vs_f32": ratio(
                     (y_p.float() - ex_y).abs(),
                     2 * BF16_U * mag_y + BF16_U * ex_y.abs() + tol_y)}
        check(max(r.values()) <= 1.0, f"{what}: {r} of the tolerance")
        w = worst.setdefault(str(dtype)[6:], {"max_abs_err_y": 0.0,
                                              "max_abs_err_states": 0.0})
        w["max_abs_err_y"] = max(w["max_abs_err_y"], float(err_y.max()))
        w["max_abs_err_states"] = max(w["max_abs_err_states"],
                                      float(err_s.max()))
        for k, v in r.items():
            w[f"max_tol_ratio_{k}"] = max(w.get(f"max_tol_ratio_{k}", 0.0),
                                          v)
        n_cases += 1
    # training: the Function's backward is autograd through the plain
    # version recomputed from the saved inputs
    grads_err = {}
    for shape in ((4, 64, 1, 48, 48), (2, 64, 2, 8, 16)):
        ins = ssd_inputs(torch, shape, torch.float32, g, dev)
        gy = torch.randn(shape[:4], generator=g, device=dev)
        gs = torch.randn((shape[0], shape[2], shape[3], shape[4]),
                         generator=g, device=dev)
        got, want = [], []
        for fn, out in ((K.ssd_intra_chunk, got), (plain, want)):
            leaves = [t.clone().requires_grad_() for t in ins]
            out.extend(torch.autograd.grad(fn(*leaves), leaves, (gy, gs)))
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        check(all(torch.allclose(a, b, atol=1e-6, rtol=1e-6)
                  for a, b in zip(got, want)),
              f"B11 gradients at {shape}: {errs}")
        grads_err[str(shape)] = max(errs)
    # timed at the serve prefill's memory call
    G, Q, H, P, N = SSD_SERVE_SHAPE
    x, dt, a_cum, Bm, Cm = ssd_inputs(torch, SSD_SERVE_SHAPE, torch.bfloat16,
                                      g, dev)
    y, s = K.ssd_intra_chunk(x, dt, a_cum, Bm, Cm)
    y_p, s_p = plain(x, dt, a_cum, Bm, Cm)
    torch.cuda.synchronize()
    timed = device_ms(torch, lambda: K.ssd_intra_chunk(x, dt, a_cum, Bm,
                                                       Cm))
    row = {"ms": timed["device_ms"], "host_us": timed["host_us"],
           "max_abs_err": max(float((y.float() - y_p.float()).abs().max()),
                              float((s - s_p).abs().max())),
           "plain_ms": time_ms(torch, lambda: plain(x, dt, a_cum, Bm, Cm),
                               iters=10),
           "library_ms": None}
    x32, B32, C32 = x.float(), Bm.float(), Cm.float()
    timed = device_ms(torch, lambda: K.ssd_intra_chunk(x32, dt, a_cum, B32,
                                                       C32))
    row["ms_f32"], row["host_us_f32"] = timed["device_ms"], timed["host_us"]
    row["plain_ms_f32"] = time_ms(torch, lambda: plain(x32, dt, a_cum, B32,
                                                       C32), iters=10)
    nbytes, flops = ssd_bound(G, Q, H, P, N, 2)
    row["bound_ms"], row["bound_by"] = ssd_tc_bound(nbytes, flops)
    row["bound_f32_fma_ms"] = bound_ms(nbytes, flops)[0]
    nbytes32, _ = ssd_bound(G, Q, H, P, N, 4)
    row["bound_f32_ms"] = ssd_tc_bound(nbytes32, flops)[0]
    # by shape: each call the xLSTM paths make, beside its own bound
    by_shape = {}
    for name, shape in SSD_PATH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(torch, shape, dtype, g, dev)
            nb, fl = ssd_bound(*shape, 4 if dtype == torch.float32 else 2)
            bms, bby = ssd_tc_bound(nb, fl)
            timed = device_ms(torch, lambda: K.ssd_intra_chunk(*ins))
            by_shape[f"{name} {str(dtype)[6:]}"] = {
                "shape": list(shape), "ms": timed["device_ms"],
                "host_us": timed["host_us"],
                "events_ms": time_ms(torch, lambda: K.ssd_intra_chunk(*ins),
                                     iters=50),
                "plain_ms": time_ms(torch, lambda: plain(*ins), iters=5),
                "bound_ms": bms, "bound_by": bby,
                "bound_f32_fma_ms": bound_ms(nb, fl)[0]}
    row["by_shape"] = by_shape
    emit({"phase": "kernel_ssd", "cases": n_cases,
          "shapes": [list(t) for t in SSD_SHAPES],
          "tolerance": "relative to mag (plain version on |x|, |B|, |C|): "
                       "f32 1e-5 (1 + mag); bf16 vs f32 on the same inputs: "
                       "y 2^-8 |exact| + 1e-5 (1 + mag), states 1e-5 (1 + "
                       "mag), plain y 2^-7 mag + 2^-8 |exact| + 1e-5 (1 + "
                       "mag); gradients atol = rtol = 1e-6",
          "results": worst, "grad_max_abs_err": grads_err,
          "serve_shape": list(SSD_SERVE_SHAPE), "serve_shape_flops": flops,
          "serve_shape_bytes": nbytes, "B11": row,
          "library": "none: no single PyTorch call computes the SSD "
                     "intra-chunk block"})
    return row


PARITY_RUNS = (("pdsgd", ()), ("dsgd", ("--algorithm", "dsgd")),
               ("dsgt", ("--algorithm", "dsgt")),
               ("dp_dsgd", ("--algorithm", "dp_dsgd", "--sigma-dp", "0.01")),
               ("pdsgd_clip", ("--grad-clip-kappa", "0.05")))


def phase_step_parity(torch, train):
    """2 steps of stablelm-3b-smoke (f32) through run_training on the card
    (kernels) and on the CPU (plain versions), same weights and batches,
    for PDSGD, each baseline and the clip.  Tolerance: losses rtol 1e-5;
    params atol 1e-3 + rtol 1e-4 — the smoke model's 0.02-scale embeddings
    under LayerNorm amplify the first step's summation-order difference
    (as on the CPU against the reference, tests/test_torch_train.py)."""
    from repro_torch.core.privacy import tree_leaves
    from repro_torch.models import build_model
    from repro_torch.configs import get_config
    cfg = get_config("stablelm-3b-smoke")
    gen = torch.Generator()
    gen.manual_seed(5)
    p0 = build_model(cfg).init(gen, "cpu")
    for name, extra in PARITY_RUNS:
        flags = ["--arch", "stablelm-3b-smoke", "--agents", "4", "--steps",
                 "2", "--log-every", "1", "--seq-len", "64", "--seed", "5",
                 *extra]
        gpu = train.run_training(train.build_parser().parse_args(
            flags + ["--device", "cuda"]), init_params=p0)
        cpu = train.run_training(train.build_parser().parse_args(
            flags + ["--device", "cpu"]), init_params=p0)
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(gpu["history"], cpu["history"]))
        check(loss_rel <= 1e-5, f"step_parity {name} loss rel {loss_rel}")
        max_abs = 0.0
        for a, b in zip(tree_leaves(gpu["state"].params),
                        tree_leaves(cpu["state"].params)):
            a = a.cpu()
            max_abs = max(max_abs, float((a - b).abs().max()))
            check(torch.allclose(a, b, atol=1e-3, rtol=1e-4),
                  f"step_parity {name} params")
        emit({"phase": "step_parity", "run": name, "flags": list(extra),
              "arch": "stablelm-3b-smoke", "dtype": "float32", "agents": 4,
              "steps": 2,
              "losses_gpu": [r["loss"] for r in gpu["history"]],
              "losses_cpu": [r["loss"] for r in cpu["history"]],
              "max_loss_rel_err": loss_rel, "max_param_abs_err": max_abs,
              "tolerance": "loss rtol 1e-5; params atol 1e-3 + rtol 1e-4"})


def _chunks(n: int, size: int = 1 << 24):
    for s in range(0, n, size):
        yield s, min(n, s + size)


def _plain_ms(torch, fn, width: int) -> float:
    """Host time of ``fn(s, e)`` over every column chunk, synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s, e in _chunks(width):
        fn(s, e)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def _path_args(train, steps: int, extra=(), seq_len: int = 512):
    return train.build_parser().parse_args(
        ["--agents", "4", "--topology", "ring", "--per-agent-batch", "2",
         "--seq-len", str(seq_len), "--steps", str(steps), "--log-every",
         "1", "--lr", "0.4", "--warmup-hold", "200", "--seed", "0",
         "--device", "cuda", *extra])


def _run_path(torch, K, train, cfg, steps: int, kernel_rng: bool,
              extra=(), seq_len: int = 512, held: bool = False):
    """run_training with the launch counts set to 0 just before it.  The
    counts returned are read just after it.  Earlier phases' buffers are
    collected first, so the peak is this run's; with ``held`` the caller
    keeps an earlier run's state for a comparison, and the peak returned
    is this run's above what was allocated before it."""
    args = _path_args(train, steps, extra, seq_len)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    check(held or base < 1 << 30,
          f"{base} B still allocated before a path")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.run_training(args, cfg=cfg, kernel_rng=kernel_rng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    peak = torch.cuda.max_memory_allocated() - (base if held else 0)
    return res, counts, wall, peak


def _finite_flat(torch, flat) -> bool:
    return all(bool(torch.isfinite(flat[:, s:e]).all())
               for s, e in _chunks(flat.shape[1]))


def phase_main_path(torch, K, train, prng, cfg):
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.privacy import sample_B
    steps = 6
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True)
    hist = res["history"]
    losses = [r["loss"] for r in hist]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(X.dtype == torch.bfloat16 and width % 512 == 0, "buffer")
    check(_finite_flat(torch, X), "non-finite parameters")
    check(counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("gossip_update", 0) == steps
          and counts.get("obfuscate_update", 0) == 0,
          f"main-path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    emit({"phase": "main_path", "arch": cfg.name, "num_layers":
          cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "dtype": cfg.dtype, "agents": m, "topology": "ring",
          "per_agent_batch": 2, "seq_len": 512,
          "params_per_agent": state.layout.size, "width": width,
          "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})

    # the kernels at this path's shapes, on its own buffer: u and x' over a
    # gradient-like buffer, the layout's leaves and the step's key table
    gen = torch.Generator(device=X.device)
    gen.manual_seed(1)
    G = torch.randn(X.shape, generator=gen, device=X.device,
                    dtype=torch.bfloat16)
    G[:, state.layout.size:] = 0
    offsets = torch.tensor(state.layout.offsets, dtype=torch.int64)
    keys = lambda_key_table(prng.fold_in(prng.key(1), steps), steps, m,
                            state.layout.n_leaves)
    lam = torch.tensor(0.01, device=X.device)
    n = m * width
    # B3
    V = K.obfuscate_update_krng(X, G, keys, offsets, lam, 0.0, -1.0)
    kd = keys.to(X.device)
    for s, e in _chunks(width):
        bits = prng.leaf_bits(kd, offsets, m, width, start=s, stop=e)
        check(same_bits(torch, V[:, s:e], K.ref.obfuscate_ref(
            X[:, s:e], G[:, s:e], bits, lam, 0.0, -1.0)),
            f"B3 main-path shape differs at columns {s}:{e}")
    b3 = {"ms": time_ms(torch, lambda: K.obfuscate_update_krng(
              X, G, keys, offsets, lam, 0.0, -1.0, out=V), iters=5),
          "max_abs_err": 0.0}
    b3["plain_ms"] = _plain_ms(torch, lambda s, e: K.ref.obfuscate_ref(
        X[:, s:e], G[:, s:e],
        prng.leaf_bits(kd, offsets, m, width, start=s, stop=e), lam, 0.0,
        -1.0), width)
    b3["bound_ms"], b3["bound_by"] = bound_ms(n * 6, n * 5,
                                              n * THREEFRY_INT_OPS)
    b3["bound_bytes_ms"] = bound_ms(n * 6)[0]
    b3["bound_int_ms"] = n * THREEFRY_INT_OPS / INT32_OPS * 1e3
    b3["library_ms"] = None
    # B2 on (X, V), bf16
    from repro_torch.core.topology import make_topology
    top = make_topology("ring", m)
    W = torch.tensor(top.weights, dtype=torch.float32, device=X.device)
    B = sample_B(prng.key(3), torch.tensor(top.adjacency,
                                           dtype=torch.float32,
                                           device=X.device))
    Xn = K.gossip_update(W, B, X, V)
    ulps = 0.0
    for s, e in _chunks(width):
        exact = W @ X[:, s:e].float() - B @ V[:, s:e].float()
        ulps = max(ulps, bf16_ulps(torch, Xn[:, s:e], exact, gossip_scale(
            W, B, X[:, s:e], V[:, s:e])))
    check(ulps <= 1.0, f"B2 main-path shape: {ulps} bf16 ulps")
    max_err = 0.0
    for s, e in _chunks(width):
        p = K.ref.gossip_ref(W, B, X[:, s:e], V[:, s:e])
        max_err = max(max_err, float((Xn[:, s:e].float() - p.float())
                                     .abs().max()))
    b2 = {"ms": time_ms(torch, lambda: K.gossip_update(W, B, X, V, out=Xn),
                        iters=10), "max_abs_err": max_err,
          "max_bf16_ulps_vs_f32": ulps}
    b2["plain_ms"] = _plain_ms(torch, lambda s, e: K.ref.gossip_ref(
        W, B, X[:, s:e], V[:, s:e]), width)
    Wb, Bb = W.bfloat16(), B.bfloat16()
    b2["library_ms"] = time_ms(torch, lambda: Wb @ X - Bb @ V, iters=5)
    b2["bound_ms"], b2["bound_by"] = bound_ms(n * 6, width * 4 * m * m)
    emit({"phase": "main_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B3": b3, "B2": b2})
    del G, V, Xn
    return {"obfuscate_update_krng": (counts, b3),
            "gossip_update": (counts, b2)}


def _step_records(res):
    return [r for r in res["history"] if "loss" in r]


DROPOUT_FLAGS = ("--topology-dropout", "0.25")


def phase_dropout_path(torch, K, train, prng, cfg):
    """The trainer with link dropout (B3 + B4 every step), then one update
    through ``fused_pdsgd_flat(mask_key=...)`` on its buffers (B5: the mask
    of the next step drawn in-kernel).  The launch counts cover both."""
    from repro_torch.core.mixing import metropolis_from_mask
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.privacy import agent_key, sample_B
    steps = 7
    extra = DROPOUT_FLAGS
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        extra)
    hist = _step_records(res)
    losses = [r["loss"] for r in hist]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    mixing = train.build_mixing(_path_args(train, steps, extra))
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(_finite_flat(torch, X), "non-finite parameters")
    check(counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("masked_gossip_update", 0) == steps
          and counts.get("gossip_update", 0) == 0,
          f"dropout-path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    # step `steps`'s update with its mask drawn in the kernel
    k = steps
    dev = X.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    G = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    G[:, state.layout.size:] = 0
    key_k = prng.fold_in(prng.key(1), k)
    mask_k = mixing.realize_mask(k)
    support = (mask_k + torch.eye(m)).to(dev)
    B = sample_B(agent_key(prng.fold_in(key_k, 2), k, 0), support)
    lam = torch.tensor(0.01, device=dev)
    X5, U5 = K.fused_pdsgd_flat(
        metropolis_from_mask(mask_k).to(dev), B, X, G, lam,
        keys=lambda_key_table(key_k, k, m, state.layout.n_leaves),
        offsets=torch.tensor(state.layout.offsets, dtype=torch.int64),
        mask_key=mixing.mask_key(k), mask_keep_prob=mixing.keep_prob,
        mask_adj=mixing.mask_adj())
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    check(counts.get("masked_gossip_update_krng", 0) == 1,
          f"dropout-path launches {counts}")
    del G
    edges = [int(mixing.realize_mask(i).sum()) // 2 for i in range(steps)]
    emit({"phase": "dropout_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": m, "topology": "ring",
          "dropout": 0.25, "per_agent_batch": 2, "seq_len": 512,
          "params_per_agent": state.layout.size, "width": width,
          "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "edges_per_step": edges,
          "base_edges": int(mixing.base_mask.sum()) // 2,
          "b_window": [{key: r[key] for key in r
                        if key.startswith("b_window")} for r in hist],
          "launches": counts})

    # B5 vs the realized mask and vs B4, then both timed at this shape
    adj = mixing.mask_adj().to(dev)
    Y, mask5 = K.masked_gossip_update_krng(mixing.mask_key(k),
                                           mixing.keep_prob, adj, B, X, U5)
    torch.cuda.synchronize()
    check(same_bits(torch, mask5.cpu(), mask_k),
          "B5 main-path shape: exported mask differs from "
          "MixingProcess.realize")
    check(same_bits(torch, Y, X5), "B5 differs between two launches")
    K.masked_gossip_update(mask5, B, X, U5, out=Y)
    check(same_bits(torch, Y, X5),
          "B5 main-path shape: output differs from B4 on its mask")
    Wk = K.ref.metropolis_ref(mask5)
    ulps = err4 = err5 = 0.0
    for s, e in _chunks(width):
        exact = Wk @ X[:, s:e].float() - B @ U5[:, s:e].float()
        ulps = max(ulps, bf16_ulps(torch, Y[:, s:e], exact, gossip_scale(
            Wk, B, X[:, s:e], U5[:, s:e])))
        p4 = K.ref.masked_gossip_ref(mask5, B, X[:, s:e], U5[:, s:e])
        err4 = max(err4, float((Y[:, s:e].float() - p4.float()).abs().max()))
        p5, _ = K.ref.masked_gossip_krng_ref(mixing.mask_key(k),
                                             mixing.keep_prob, adj, B,
                                             X[:, s:e], U5[:, s:e])
        err5 = max(err5, float((X5[:, s:e].float() - p5.float())
                               .abs().max()))
    check(ulps <= 1.0, f"B4 main-path shape: {ulps} bf16 ulps")
    n = m * width
    bound = bound_ms(n * 6, width * 4 * m * m)
    b4 = {"ms": time_ms(torch, lambda: K.masked_gossip_update(
              mask5, B, X, U5, out=Y), iters=10),
          "max_abs_err": err4, "max_bf16_ulps_vs_f32": ulps,
          "plain_ms": _plain_ms(torch, lambda s, e: K.ref.masked_gossip_ref(
              mask5, B, X[:, s:e], U5[:, s:e]), width),
          "bound_ms": bound[0], "bound_by": bound[1]}
    Bb = B.bfloat16()
    b4["library_ms"] = time_ms(
        torch, lambda: metropolis_from_mask(mask5).bfloat16() @ X - Bb @ U5,
        iters=5)
    key5 = mixing.mask_key(k)
    # B5 draws one threefry word per undirected edge
    draws = m * (m - 1) // 2
    bound5 = bound_ms(n * 6, width * 4 * m * m, draws * THREEFRY_INT_OPS)
    b5 = {"ms": time_ms(torch, lambda: K.masked_gossip_update_krng(
              key5, mixing.keep_prob, adj, B, X, U5, out=Y), iters=10),
          "max_abs_err": err5,
          "plain_ms": _plain_ms(torch, lambda s, e:
                                K.ref.masked_gossip_krng_ref(
                                    key5, mixing.keep_prob, adj, B,
                                    X[:, s:e], U5[:, s:e]), width),
          "bound_ms": bound5[0], "bound_by": bound5[1],
          "bound_int_ms": draws * THREEFRY_INT_OPS / INT32_OPS * 1e3,
          "library_ms": None}
    emit({"phase": "dropout_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B4": b4, "B5": b5})
    del X5, U5, Y
    return {"masked_gossip_update": (counts, b4),
            "masked_gossip_update_krng": (counts, b5)}


FAULT_FLAGS = ("--fault-crash-rate", "0.2", "--fault-restart-rate", "0.5",
               "--fault-corrupt-rate", "0.25", "--fault-corrupt-mode", "nan",
               "--fault-guard-clip", "1e3", "--nan-policy", "skip")


def fault_seed(train, steps: int):
    """The first fault seed whose realization over ``steps`` steps has a
    down agent and a corrupt sender, from FaultProcess.realize on the CPU:
    ``(seed, faults)``."""
    for seed in range(100):
        faults = train.build_faults(_path_args(
            train, steps, (*FAULT_FLAGS, "--fault-seed", str(seed))))
        rows = [faults.realize(k) for k in range(steps)]
        if (any(bool((a == 0).any()) for a, _ in rows)
                and any(bool(c.any()) for _, c in rows)):
            return seed, faults
    raise AssertionError("no fault seed below 100 fires in the run")


def phase_fault_path(torch, K, train, prng, cfg):
    """The trainer with Markov crash/restart, nan-corrupt senders, guard
    clip 1e3 and --nan-policy skip (B3 + B6 every step)."""
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.privacy import agent_key, sample_B
    from repro_torch.faults import guarded_gossip_mix, realize_coupling
    steps = 6
    seed, faults = fault_seed(train, steps)
    extra = (*FAULT_FLAGS, "--fault-seed", str(seed))
    realized = [{"down": int((faults.alive_at(k) == 0).sum()),
                 "corrupt": int(faults.realize(k)[1].sum()),
                 "rejoin": int(faults.rejoin_mask(k).sum())}
                for k in range(steps)]
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        extra)
    hist = _step_records(res)
    losses = [r["loss"] for r in hist]
    totals = res["fault_totals"]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(_finite_flat(torch, X), "non-finite parameters")
    check(totals.get("fault_down", 0) > 0 and totals.get("fault_corrupt", 0)
          > 0, f"fault path had no down agent or no corrupt sender: {totals}")
    check(counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("guarded_gossip_update", 0) == steps
          and counts.get("masked_gossip_update", 0) == 0
          and counts.get("gossip_update", 0) == 0,
          f"fault-path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    emit({"phase": "fault_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": m, "topology": "ring",
          "flags": list(extra), "fault_seed": seed, "realized": realized,
          "fault_totals": totals, "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})

    # B6 at this shape, on the realization of a step with a corrupt sender
    # (and a down agent, where one step has both)
    k = max(range(steps), key=lambda i: (realized[i]["corrupt"] > 0,
                                         realized[i]["down"] > 0, -i))
    dev = X.device
    mixing = train.build_mixing(_path_args(train, steps, extra))
    W, support, mask, alive, corrupt = realize_coupling(mixing, faults, k,
                                                        dev)
    key_k = prng.fold_in(prng.key(1), k)
    B = sample_B(agent_key(prng.fold_in(key_k, 2), k, 0), support)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    V = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    V[:, state.layout.size:] = 0
    K.obfuscate_update_krng(
        X, V, lambda_key_table(key_k, k, m, state.layout.n_leaves),
        torch.tensor(state.layout.offsets, dtype=torch.int64),
        torch.tensor(0.01, device=dev), 0.0, -1.0, out=V)
    cdev = corrupt.to(dev)
    Y = K.guarded_gossip_update(mask, B, X, V, clip=1e3, corrupt=cdev,
                                mode="nan", scale=1e4)
    err = ulps = 0.0
    for s, e in _chunks(width):
        x, v = X[:, s:e], V[:, s:e]
        XT = K.ref.poison_transmit(x, cdev, "nan", 1e4)
        UT = K.ref.poison_transmit(v, cdev, "nan", 1e4)
        want = K.ref.guarded_gossip_ref(mask, B, x, v, XT, UT, 1e3)
        exact = K.ref.guarded_gossip_ref(mask, B, x.float(), v.float(),
                                         XT.float(), UT.float(), 1e3)
        e1, u1 = guarded_check(torch, K, Y[:, s:e], want, exact, mask, B, x,
                               v, XT, UT, 1e3,
                               f"main-path shape, columns {s}:{e}")
        err, ulps = max(err, e1), max(ulps, u1)
    n = m * width
    bound = bound_ms(n * 6, width * 7 * m * m)

    def plain(s, e):
        x, v = X[:, s:e], V[:, s:e]
        K.ref.guarded_gossip_ref(
            mask, B, x, v, K.ref.poison_transmit(x, cdev, "nan", 1e4),
            K.ref.poison_transmit(v, cdev, "nan", 1e4), 1e3)

    b6 = {"ms": time_ms(torch, lambda: K.guarded_gossip_update(
              mask, B, X, V, clip=1e3, corrupt=cdev, mode="nan",
              scale=1e4, out=Y), iters=10),
          "max_abs_err": err, "max_bf16_ulps_vs_f32": ulps,
          "plain_ms": _plain_ms(torch, plain, width),
          "library_ms": _plain_ms(torch, lambda s, e: guarded_gossip_mix(
              W, B, X[:, s:e], V[:, s:e], cdev, mode="nan", scale=1e4,
              clip=1e3), width),
          "bound_ms": bound[0], "bound_by": bound[1],
          "step": k, "corrupt": corrupt.tolist(), "alive": alive.tolist()}
    emit({"phase": "fault_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B6": b6})
    del V, Y
    return {"guarded_gossip_update": (counts, b6)}


RING_FLAGS = ("--kernel-layout", "ring")


def phase_ring_path(torch, K, train, prng, cfg):
    """The trainer with --kernel-layout ring (B9 once a step, no B3 or B2),
    then one torus_gossip_pdsgd(None, ..., fused=True) on its buffers (B7);
    the launch counts cover both.  Then B9 and B7 against their plain
    versions at this shape, timed, and one step's ring update against the
    concat update (B3 + B2) on the same draws."""
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.privacy import agent_key, sample_B
    from repro_torch.dist import collectives as C
    steps = 7
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        RING_FLAGS)
    hist = _step_records(res)
    losses = [r["loss"] for r in hist]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"ring-path losses do not fall: {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(_finite_flat(torch, X), "non-finite parameters")
    check(counts.get("ring_obfuscate_gossip_krng", 0) == steps
          and counts.get("obfuscate_update_krng", 0) == 0
          and counts.get("gossip_update", 0) == 0,
          f"ring-path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    # step `steps`'s draws, on this path's buffer
    k = steps
    dev = X.device
    mixing = train.build_mixing(_path_args(train, steps, RING_FLAGS))
    W, support, _ = mixing.realize(k, dev)
    key_k = prng.fold_in(prng.key(1), k)
    B = sample_B(agent_key(prng.fold_in(key_k, 2), k, 0), support)
    tabs = C.directional_weights(W, m, 1)
    w_tab = torch.cat([tabs["w_self"][:, None], tabs["w_dir"]], dim=1)
    b_tab = C.rows_from_dense(B, m, 1)
    src, P = C.source_table(m, 1), C.perm_stack(m, 1).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    G = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    G[:, state.layout.size:] = 0
    # B7 as the single-device torus gossip runs it, u given (here G)
    Y7 = C.torus_gossip_pdsgd(None, X, G, b_tab, W=W, fused=True)
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    check(counts.get("ring_gossip_update", 0) == 1,
          f"ring-path launches {counts}")
    emit({"phase": "ring_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "d_model": cfg.d_model,
          "agents": m, "topology": "ring", "flags": list(RING_FLAGS),
          "dtype": cfg.dtype, "per_agent_batch": 2, "seq_len": 512,
          "params_per_agent": state.layout.size, "width": width,
          "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})

    n = m * width
    # B7 against its plain version, then timed
    for s, e in _chunks(width):
        check(same_bits(torch, Y7[:, s:e], K.ref.ring_gossip_ref(
            w_tab, b_tab, P, X[:, s:e], G[:, s:e])[0]),
            f"B7 ring-path shape differs at columns {s}:{e}")
    del Y7
    Y = torch.empty_like(X)
    b7 = {"ms": time_ms(torch, lambda: K.ring_gossip_update(
              w_tab, b_tab, src, X, G, out=Y), iters=10),
          "max_abs_err": 0.0,
          "plain_ms": _plain_ms(torch, lambda s, e: K.ref.ring_gossip_ref(
              w_tab, b_tab, P, X[:, s:e], G[:, s:e]), width)}
    Wd, Bd = C.dense_coupling(b_tab, m, 1, W=W)
    Wb, Bb = Wd.bfloat16(), Bd.bfloat16()
    b7["library_ms"] = time_ms(torch, lambda: Wb @ X - Bb @ G, iters=5)
    nd = P.shape[0]
    b7["bound_ms"], b7["bound_by"] = bound_ms(n * 6, n * (3 + 4 * nd))

    # one step's update, ring (B9) and concat (B3 + B2) on the same draws:
    # each within one bf16 ulp of the f32 result of its own u (the ring
    # keeps u in f32, the concat path rounds it to bf16 over G)
    keys = lambda_key_table(key_k, k, m, state.layout.n_leaves)
    offsets = torch.tensor(state.layout.offsets, dtype=torch.int64)
    lam = torch.tensor(0.01, device=dev)
    Xr = X.clone()
    K.ring_pdsgd_flat(w_tab, b_tab, src, Xr, G, lam, keys=keys,
                      offsets=offsets, in_place=True)
    Xc, Gc = X.clone(), G.clone()
    K.fused_pdsgd_flat(W, B, Xc, Gc, lam, keys=keys, offsets=offsets,
                       in_place=True)
    kd = keys.to(dev)
    ulps_r = ulps_c = ring_vs_concat = 0.0
    for s, e in _chunks(width):
        bits = prng.leaf_bits(kd, offsets, m, width, start=s, stop=e)
        po, _, pu = K.ref.ring_obfuscate_gossip_ref(
            w_tab, b_tab, P, X[:, s:e], G[:, s:e], bits, lam)
        check(same_bits(torch, Xr[:, s:e], po),
              f"B9 ring-path shape differs at columns {s}:{e}")
        x = X[:, s:e].float()
        exact_r = W @ x - B @ pu
        ulps_r = max(ulps_r, bf16_ulps(torch, Xr[:, s:e], exact_r,
                                       W @ x.abs() + B @ pu.abs()))
        uc = Gc[:, s:e].float()
        exact_c = W @ x - B @ uc
        ulps_c = max(ulps_c, bf16_ulps(torch, Xc[:, s:e], exact_c,
                                       W @ x.abs() + B @ uc.abs()))
        ring_vs_concat = max(ring_vs_concat, float(
            (Xr[:, s:e].float() - Xc[:, s:e].float()).abs().max()))
    check(ulps_r <= 1.0 and ulps_c <= 1.0,
          f"ring {ulps_r} / concat {ulps_c} bf16 ulps from the f32 result")
    del Xc, Gc
    b9 = {"ms": time_ms(torch, lambda: K.ring_obfuscate_gossip_krng(
              w_tab, b_tab, src, X, G, keys, offsets, lam, out=Xr),
              iters=5),
          "max_abs_err": 0.0,
          "plain_ms": _plain_ms(torch, lambda s, e:
                                K.ref.ring_obfuscate_gossip_ref(
                                    w_tab, b_tab, P, X[:, s:e], G[:, s:e],
                                    prng.leaf_bits(kd, offsets, m, width,
                                                   start=s, stop=e), lam),
                                width),
          "library_ms": None}
    b9["bound_ms"], b9["bound_by"] = bound_ms(n * 6, n * (6 + 4 * nd),
                                              n * THREEFRY_INT_OPS)
    b9["bound_bytes_ms"] = bound_ms(n * 6)[0]
    b9["bound_int_ms"] = n * THREEFRY_INT_OPS / INT32_OPS * 1e3
    # in turns with what the concat path runs for the same update: B3 (the
    # same words) and B2 (the same bytes) on these buffers, then B9 again
    V, Xn = Y, torch.empty_like(X)
    b9["b3_ms"] = time_ms(torch, lambda: K.obfuscate_update_krng(
        X, G, keys, offsets, lam, 0.0, -1.0, out=V), iters=5)
    b9["b2_ms"] = time_ms(torch, lambda: K.gossip_update(W, B, X, V, out=Xn),
                          iters=5)
    b9["ms_again"] = time_ms(torch, lambda: K.ring_obfuscate_gossip_krng(
        w_tab, b_tab, src, X, G, keys, offsets, lam, out=Xr), iters=5)
    del V, Xn
    emit({"phase": "ring_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B9": b9, "B7": b7,
          "ring_vs_concat": {"ring_max_bf16_ulps_vs_f32": ulps_r,
                             "concat_max_bf16_ulps_vs_f32": ulps_c,
                             "max_abs_diff": ring_vs_concat}})
    del G, Xr, Y
    return {"ring_obfuscate_gossip_krng": (counts, b9),
            "ring_gossip_update": (counts, b7)}


def phase_ring_bits_path(torch, K, train, prng, cfg):
    """The bits path with --kernel-layout ring: B8 every step (no B1, B2);
    B8 checked and timed at that path's shape."""
    from repro_torch.core.pdsgd import per_agent_bits
    from repro_torch.core.privacy import agent_key, sample_B
    from repro_torch.dist import collectives as C
    steps = 2
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, False,
                                        RING_FLAGS)
    hist = res["history"]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(r["loss"]) for r in hist), "ring bits losses")
    check(_finite_flat(torch, X), "ring bits path non-finite parameters")
    check(counts.get("ring_obfuscate_gossip", 0) == steps
          and counts.get("obfuscate_update", 0) == 0
          and counts.get("gossip_update", 0) == 0,
          f"ring bits path launches {counts}")
    emit({"phase": "ring_bits_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": m,
          "losses": [r["loss"] for r in hist], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})
    k, dev = steps, X.device
    mixing = train.build_mixing(_path_args(train, steps, RING_FLAGS))
    W, support, _ = mixing.realize(k, dev)
    key_k = prng.fold_in(prng.key(1), k)
    B = sample_B(agent_key(prng.fold_in(key_k, 2), k, 0), support)
    tabs = C.directional_weights(W, m, 1)
    w_tab = torch.cat([tabs["w_self"][:, None], tabs["w_dir"]], dim=1)
    b_tab = C.rows_from_dense(B, m, 1)
    src, P = C.source_table(m, 1), C.perm_stack(m, 1).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    G = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    bits = per_agent_bits(key_k, k, state.layout, m, device=dev)
    lam = torch.tensor(0.01, device=dev)
    Y = K.ring_obfuscate_gossip(w_tab, b_tab, src, X, G, bits, lam)
    for s, e in _chunks(width):
        check(same_bits(torch, Y[:, s:e], K.ref.ring_obfuscate_gossip_ref(
            w_tab, b_tab, P, X[:, s:e], G[:, s:e], bits[:, s:e], lam)[0]),
            f"B8 ring-bits-path shape differs at columns {s}:{e}")
    n = m * width
    nd = P.shape[0]
    b8 = {"ms": time_ms(torch, lambda: K.ring_obfuscate_gossip(
              w_tab, b_tab, src, X, G, bits, lam, out=Y), iters=10),
          "max_abs_err": 0.0,
          "plain_ms": _plain_ms(torch, lambda s, e:
                                K.ref.ring_obfuscate_gossip_ref(
                                    w_tab, b_tab, P, X[:, s:e], G[:, s:e],
                                    bits[:, s:e], lam), width)}
    del Y
    Wd, Bd = C.dense_coupling(b_tab, m, 1, W=W)

    def library():
        # the same update as eager torch ops on the whole buffer
        u01 = ((bits.view(torch.int32) >> 9) & 0x7FFFFF
               | 0x3F800000).view(torch.float32) - 1.0
        u = (2.0 * lam * u01).mul_(G.float())
        return torch.addmm(Wd @ X.float(), Bd, u, alpha=-1.0).bfloat16()

    b8["library_ms"] = time_ms(torch, library, iters=3, warmup=1)
    b8["bound_ms"], b8["bound_by"] = bound_ms(n * 10, n * (6 + 4 * nd))
    emit({"phase": "ring_bits_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B8": b8})
    del G, bits
    return {"ring_obfuscate_gossip": (counts, b8)}


def phase_bits_path(torch, K, train, prng, cfg):
    steps = 2
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, False)
    hist = res["history"]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(r["loss"]) for r in hist), "bits_path losses")
    check(_finite_flat(torch, X), "bits_path non-finite parameters")
    check(counts.get("obfuscate_update", 0) == steps
          and counts.get("gossip_update", 0) == steps
          and counts.get("obfuscate_update_krng", 0) == 0,
          f"bits_path launches {counts}")
    emit({"phase": "bits_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": m,
          "losses": [r["loss"] for r in hist], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})
    from repro_torch.core.pdsgd import per_agent_bits
    gen = torch.Generator(device=X.device)
    gen.manual_seed(2)
    G = torch.randn(X.shape, generator=gen, device=X.device,
                    dtype=torch.bfloat16)
    bits = per_agent_bits(prng.fold_in(prng.key(1), steps), steps,
                          state.layout, m, device=X.device)
    lam = torch.tensor(0.01, device=X.device)
    V = K.obfuscate_update(X, G, bits, lam, 0.0, -1.0)
    for s, e in _chunks(width):
        check(same_bits(torch, V[:, s:e], K.ref.obfuscate_ref(
            X[:, s:e], G[:, s:e], bits[:, s:e], lam, 0.0, -1.0)),
            f"B1 bits-path shape differs at columns {s}:{e}")
    n = m * width
    b1 = {"ms": time_ms(torch, lambda: K.obfuscate_update(
              X, G, bits, lam, 0.0, -1.0, out=V), iters=10),
          "max_abs_err": 0.0}
    b1["plain_ms"] = _plain_ms(torch, lambda s, e: K.ref.obfuscate_ref(
        X[:, s:e], G[:, s:e], bits[:, s:e], lam, 0.0, -1.0), width)

    def library():
        # the same expression in as few torch eager ops as it goes
        u01 = ((bits.view(torch.int32) >> 9) & 0x7FFFFF
               | 0x3F800000).view(torch.float32) - 1.0
        return torch.addcmul(0.0 * X.float(), 2.0 * lam * u01, G.float(),
                             value=1.0).bfloat16()

    b1["library_ms"] = time_ms(torch, library, iters=3, warmup=1)
    b1["bound_ms"], b1["bound_by"] = bound_ms(n * 10, n * 5)
    emit({"phase": "bits_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B1": b1})
    return {"obfuscate_update": (counts, b1)}


# a training layer's forward runs twice a step under per-layer recompute:
# in the forward, and again in its backward (`models.common.remat`)
RECOMPUTE = 2
RECOMPUTE_SEQ = 4096  # the reference's train_4k length
RECOMPUTE_RUNS = ("full", "save_collectives", "none")


def _plain_forward_train(cfg):
    """The family's forward_train with its layer bodies called directly (no
    recompute): the phase's own loop."""
    from repro_torch.models import common, hybrid
    from repro_torch.models import transformer as tfm

    def dense(params, batch, cfg):
        x = tfm.embed_tokens(params, batch, cfg)
        rope = common.rope_tables(x.shape[1], cfg.head_dim, cfg.rotary_frac,
                                  cfg.rope_theta, x.device)
        for p in common.layer_views(params["layers"]):
            x = tfm._layer_train(p, x, rope, cfg)
        return tfm.unembed(params, tfm._final_norm(params, x, cfg), cfg)

    def mamba(params, batch, cfg):
        x = tfm.embed_tokens(params, batch, cfg)
        rope = hybrid._rope(cfg, x.shape[1], x.device)
        for p, site in hybrid._blocks(params, cfg):
            x = hybrid.ssm.mamba_block_train(p, x, cfg)
            if site is not None:
                x = tfm._layer_train(site[1], x, rope, cfg)
        return tfm.unembed(params, common.rms_norm(
            x, params["final_norm_gamma"]), cfg)

    if cfg.family == "hybrid":
        return hybrid, mamba
    return tfm, dense


def phase_recompute_peak(torch, K, cfg, phase: str) -> dict:
    """One agent's value and gradients at full width, per-agent batch 1
    and seq 4096 (train_4k's length), under remat_policy "full",
    "save_collectives" and the phase's own loop without recompute: the
    peak of max_memory_allocated (reset before each run; above what was
    allocated before it, the weights and one held gradient set) and the
    ms of each (a warm-up run first).  Gate: the loss and every gradient
    bitwise equal across the three."""
    from repro_torch.core.privacy import tree_leaves, tree_unflatten
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    params = build_model(cfg).init(gen, dev)
    leaves = tree_leaves(params)
    batch = {n: torch.randint(0, cfg.vocab_size, (1, RECOMPUTE_SEQ),
                              generator=gen, device=dev)
             for n in ("tokens", "labels")}
    mod, plain = _plain_forward_train(cfg)

    def run(policy):
        c = dataclasses.replace(
            cfg, remat_policy="full" if policy == "none" else policy)
        saved = mod.forward_train
        if policy == "none":
            mod.forward_train = plain
        try:
            ps = [t.detach().requires_grad_() for t in leaves]
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = build_model(c).loss_fn(tree_unflatten(params, ps), batch)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
        finally:
            mod.forward_train = saved
        return loss.detach(), grads, ms, peak, base

    warm = run("full")  # cuBLAS handles, workspaces, the allocator's pool
    del warm
    rec = {}
    want = None
    for policy in RECOMPUTE_RUNS:
        loss, grads, ms, peak, base = run(policy)
        if want is None:
            want = (loss, grads)
        else:
            check(torch.equal(loss, want[0]),
                  f"{phase} {policy}: loss differs from full's")
            check(all((g is None and w is None) or torch.equal(g, w)
                      for g, w in zip(grads, want[1])),
                  f"{phase} {policy}: gradients differ from full's")
        rec[policy] = {"ms": ms, "peak_bytes": peak,
                       "peak_above_start_bytes": peak - base,
                       "loss": float(loss)}
        del grads
    del want
    out = {"phase": phase, "arch": cfg.name, "num_layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "batch": 1,
           "seq_len": RECOMPUTE_SEQ,
           "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "runs": rec, "bitwise_equal": True}
    emit(out)
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tree_forms(torch, K, prng, cfg):
    """`obfuscate_tree` (B1 over the concatenated buffer, its bits drawn
    from one key over the 256-padded buffer) and `gossip_tree` (B2) on 4
    agents' trees of the bits path's layout, bf16.  Gates: one launch
    each; the bits' first 2^20 columns of every row equal the CPU's draw;
    v bitwise the plain version; x' bitwise B2 on the flat buffers and,
    on three 2^22-column samples, bitwise the f32 FMA chains B2 sums
    (`core.pdsgd.fma_f32`); everywhere within B2's tolerance of the plain
    version.  Timed: the tree calls and the kernels alone."""
    from repro_torch.core.pdsgd import fma_f32
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    m = 4
    layout = ops.FlatLayout.of(build_model(cfg).abstract())
    D, width = layout.size, layout.width
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    X = torch.randn((m, width), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    G = torch.randn((m, width), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    X[:, D:] = 0
    G[:, D:] = 0
    lam = 0.01
    key = prng.key(5)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v_tree = K.obfuscate_tree(key, layout.tree(X), layout.tree(G), lam, 0.0,
                              -1.0)
    torch.cuda.synchronize()
    obf_tree_ms = (time.perf_counter() - t0) * 1e3
    check(K.launch_counts.get("obfuscate_update", 0) == 1,
          f"obfuscate_tree launches {dict(K.launch_counts)}")
    V = layout.flatten(v_tree, m)
    del v_tree
    bits = ops.tree_bits(key.to(dev), m, layout)
    n_cols = -(-D // 256) * 256
    head = min(1 << 20, D)
    idx = (torch.arange(m, dtype=torch.int64)[:, None] * n_cols
           + torch.arange(head, dtype=torch.int64)[None, :])
    check(torch.equal(bits[:, :head].cpu(),
                      prng.bits_at(key, idx, m * n_cols).to(torch.uint32)),
          "tree_forms: the card's bits differ from the CPU's draw")
    for s, e in _chunks(width):
        check(same_bits(torch, V[:, s:e], K.ref.obfuscate_ref(
            X[:, s:e], G[:, s:e], bits[:, s:e], lam, 0.0, -1.0)),
            f"obfuscate_tree differs from the plain version at {s}:{e}")
    Wg = torch.Generator(device=dev)
    Wg.manual_seed(17)
    W = torch.rand(m, m, generator=Wg, device=dev)
    B = torch.rand(m, m, generator=Wg, device=dev)
    W, B = W / W.sum(0), B / B.sum(0)
    K.reset_launch_counts()
    out_tree = K.gossip_tree(W, B, layout.tree(X), layout.tree(V))
    torch.cuda.synchronize()
    check(K.launch_counts.get("gossip_update", 0) == 1,
          f"gossip_tree launches {dict(K.launch_counts)}")
    Y = layout.flatten(out_tree, m)
    del out_tree
    check(same_bits(torch, Y[:, :D], K.gossip_update(W, B, X, V)[:, :D]),
          "gossip_tree differs from B2 on the flat buffers")
    ulps = 0.0
    for s, e in _chunks(width):
        exact = K.ref.gossip_ref(W, B, X[:, s:e].float(), V[:, s:e].float())
        ulps = max(ulps, bf16_ulps(torch, Y[:, s:e], exact, gossip_scale(
            W, B, X[:, s:e], V[:, s:e])))
    check(ulps <= 1.0, f"gossip_tree: {ulps} bf16 ulps from the plain version")
    sample = min(1 << 22, D)
    for s in (0, (D - sample) // 2, D - sample):
        e = s + sample
        mixed = torch.zeros((m, e - s), dtype=torch.float32, device=dev)
        desc = torch.zeros_like(mixed)
        for j in range(m):
            mixed = fma_f32(W[:, j:j + 1], X[j:j + 1, s:e].float(), mixed)
            desc = fma_f32(B[:, j:j + 1], V[j:j + 1, s:e].float(), desc)
        check(same_bits(torch, Y[:, s:e], (mixed - desc).bfloat16()),
              f"gossip_tree at {s}:{e} differs from B2's FMA chains")
    rec = {"phase": "tree_forms", "arch": cfg.name,
           "num_layers": cfg.num_layers, "shape": [m, width],
           "n_leaves": layout.n_leaves, "dtype": "bfloat16",
           "B2_max_bf16_ulps": ulps,
           "obfuscate_tree_ms": obf_tree_ms,
           "gossip_tree_ms": time_ms(torch, lambda: K.gossip_tree(
               W, B, layout.tree(X), layout.tree(V)), iters=3, warmup=1),
           "B1_ms": time_ms(torch, lambda: K.obfuscate_update(
               X, G, bits, lam, 0.0, -1.0, out=V), iters=10),
           "B2_ms": time_ms(torch, lambda: K.gossip_update(W, B, X, V,
                                                           out=Y), iters=10)}
    emit(rec)
    del X, G, V, Y, bits
    gc.collect()
    torch.cuda.empty_cache()
    return rec


LEAFWISE_FLAGS = ("--kernel-layout", "leafwise")
LEAFWISE_STEPS = 1
# the leafwise route's gossip kernel by coupling
LEAFWISE_GOSSIP = {"static": "gossip_update", "dropout":
                   "masked_gossip_update", "fault": "guarded_gossip_update"}


def phase_leafwise_path(torch, K, train, cfg):
    """The bits path's configuration with --kernel-layout leafwise beside
    the concat bits path (both reading the step's Lambda bits), static,
    dropout 0.25 and FAULT_FLAGS: B1 and the gossip kernel (B2, B4, B6)
    once per leaf a step, on the leaf's columns of the flat buffers.
    Gates: the states and step records bitwise the concat runs'; B1 and
    the gossip kernel leaves x steps, B3 0.  Then --unroll-k 2 beside the
    same 4 steps eager (`_scanned_beside_eager`).  Returns the leafwise
    runs' launches, summed."""
    n_leaves = None
    total: dict = {}
    runs = {}
    fseed = fault_seed(train, LEAFWISE_STEPS)[0]
    for name, flags in (("static", ()), ("dropout", DROPOUT_FLAGS),
                        ("fault", (*FAULT_FLAGS, "--fault-seed",
                                   str(fseed)))):
        cres, ccounts, cwall, cpeak = _run_path(
            torch, K, train, cfg, LEAFWISE_STEPS, False, flags)
        concat_flat = cres["state"].flat
        chist = _step_records(cres)
        del cres
        lres, lcounts, lwall, lpeak = _run_path(
            torch, K, train, cfg, LEAFWISE_STEPS, False,
            (*flags, *LEAFWISE_FLAGS), held=True)
        n_leaves = lres["state"].layout.n_leaves
        lhist = _step_records(lres)
        same = same_bits(torch, lres["state"].flat, concat_flat)
        check(same, f"leafwise {name}: state differs from the concat run's")
        check(_strip_times(lhist) == _strip_times(chist),
              f"leafwise {name}: step records differ from the concat run's")
        gk = LEAFWISE_GOSSIP[name]
        n = n_leaves * LEAFWISE_STEPS
        check(lcounts.get("obfuscate_update", 0) == n
              and lcounts.get(gk, 0) == n
              and lcounts.get("obfuscate_update_krng", 0) == 0,
              f"leafwise {name} launches {lcounts}")
        for k, v in lcounts.items():
            total[k] = total.get(k, 0) + v
        runs[name] = {
            "flags": list(flags), "losses": [r["loss"] for r in lhist],
            "first_step_s": lhist[0]["elapsed_s"],
            "first_step_s_concat": chist[0]["elapsed_s"],
            "run_wall_s": lwall, "run_wall_s_concat": cwall,
            "max_memory_allocated": lpeak,
            "max_memory_allocated_concat": cpeak,
            "launches": lcounts, "launches_concat": ccounts,
            "state_equals_concat_bitwise": same}
        del lres, concat_flat
        gc.collect()
        torch.cuda.empty_cache()
    scanned = _scanned_beside_eager(
        torch, K, train, cfg, LEAFWISE_FLAGS,
        {"obfuscate_update": n_leaves, "gossip_update": n_leaves},
        steps=4, unroll=2)
    emit({"phase": "leafwise_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": 4, "topology": "ring",
          "per_agent_batch": 2, "seq_len": 512, "steps": LEAFWISE_STEPS,
          "n_leaves": n_leaves, "runs": runs, "scanned": scanned})
    return total


def phase_trivial_mesh_step(torch, K, train, cfg):
    """`launch.mesh.make_sharded_mesh(agents=4, fsdp=1, tensor=1)` on a
    one-rank NCCL group, leaf specs from TRAIN_RULES, three leafwise steps
    of the bits path's configuration each from the mesh=None leafwise
    trajectory's state.  Gates: equal losses; the parameters within B2's
    bf16 tolerance of mesh=None: |mesh - none| <= (2^-7 + 1e-6) |W||X| +
    2^-6 |x'| per entry (the mesh form rounds its two f32 products and
    their difference to bf16, B2 only the difference: at most 2^-8 (2
    |W X| + 3 |x'|) apart); the max deviation printed."""
    import torch.distributed as dist
    from repro_torch.core.pdsgd import (DecentralizedState, init_state,
                                        make_decentralized_step)
    from repro_torch.core.privacy import tree_leaves, tree_unflatten
    from repro_torch.core.schedules import warmup_harmonic
    from repro_torch.data import make_lm_pipeline
    from repro_torch.dist.sharding import TRAIN_RULES, logical_spec
    from repro_torch.kernels.build import to_device
    from repro_torch.launch.mesh import make_sharded_mesh
    from repro_torch.launch.specs import with_agent_axis
    from repro_torch.models import build_model
    from repro_torch.core import prng
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        m = 4
        mesh = make_sharded_mesh(agents=m, fsdp=1, tensor=1)
        bundle = build_model(cfg)
        abs_m, log_m = with_agent_axis(bundle.abstract(),
                                       bundle.logical_axes(), m)
        specs = tree_unflatten(abs_m, [
            logical_spec(mesh, a.shape, log, TRAIN_RULES)
            for a, log in zip(tree_leaves(abs_m), tree_leaves(log_m))])
        check(all(s == () for s in tree_leaves(specs)),
              "trivial mesh: every leaf replicated")
        args = _path_args(train, 3)
        mixing = train.build_mixing(args)
        sched = warmup_harmonic(args.lr, hold=args.warmup_hold)
        step_mesh = make_decentralized_step(
            bundle.loss_fn, mixing, sched, kernel_rng=False,
            kernel_layout="leafwise", mesh=mesh, leaf_specs=specs)
        step_none = make_decentralized_step(
            bundle.loss_fn, mixing, sched, kernel_rng=False,
            kernel_layout="leafwise")
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        state = init_state(bundle.init(gen, dev), m, device=dev)
        pipeline = make_lm_pipeline(cfg.vocab_size, m, 2, 512,
                                    seed=args.seed)
        key = prng.key(args.seed + 1)
        worst, ratio, times = 0.0, 0.0, {"mesh": [], "none": []}
        losses = []
        K.reset_launch_counts()
        for k in range(3):
            batch = {n: to_device(torch.from_numpy(v), dev)
                     for n, v in pipeline.batch_at(k).items()}
            X0 = state.flat.clone()
            other = DecentralizedState(flat=X0.clone(), layout=state.layout,
                                       step=state.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            other, aux_m = step_mesh(other, batch, prng.fold_in(key, k))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, aux = step_none(state, batch, prng.fold_in(key, k))
            torch.cuda.synchronize()
            times["mesh"].append((t1 - t0) * 1e3)
            times["none"].append((time.perf_counter() - t1) * 1e3)
            check(float(aux_m["loss"]) == float(aux["loss"]),
                  f"trivial mesh step {k}: losses differ")
            losses.append(float(aux["loss"]))
            W = mixing.realize(k, dev)[0]
            for s, e in _chunks(X0.shape[1]):
                a, b = other.flat[:, s:e].float(), state.flat[:, s:e].float()
                diff = (a - b).abs()
                wx = W.abs().float() @ X0[:, s:e].float().abs()
                # + 1e-6 |W||X|: the f32 products' own summation orders
                # (B2's FMA chain, the einsum's), as B2's checks allow
                tol = (2.0 ** -7 + 1e-6) * wx + 2.0 ** -6 * b.abs()
                worst = max(worst, float(diff.max()))
                ratio = max(ratio, float((diff / tol.clamp_min(1e-30))
                                         .max()))
            check(ratio <= 1.0, f"trivial mesh step {k}: {ratio} of B2's "
                                f"bf16 tolerance")
            del other, X0
        counts = dict(K.launch_counts)
        rec = {"phase": "trivial_mesh_step", "arch": cfg.name,
               "num_layers": cfg.num_layers, "mesh": dict(zip(
                   mesh.mesh_dim_names, tuple(mesh.shape))),
               "backend": dist.get_backend(), "agents": m, "steps": 3,
               "losses": losses, "max_abs_deviation": worst,
               "max_share_of_tolerance": ratio,
               "ms_per_step_mesh": times["mesh"],
               "ms_per_step_none": times["none"], "launches": counts}
        emit(rec)
        print(f"trivial_mesh_step: max |mesh - none| {worst} "
              f"({ratio:.3f} of the tolerance)", flush=True)
        del state
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


MESH_STEP_STEPS = 3
# the forms of launch.steps.make_train_step the phase drives: name, its
# keywords (mixing and faults named, built in the phase), the kernels it
# must launch every step
MESH_STEP_FORMS = (
    ("dense", {"use_pallas": True}, ("obfuscate_update", "gossip_update")),
    ("dropout", {"use_pallas": True, "mixing": "dropout"},
     ("obfuscate_update", "masked_gossip_update")),
    ("ring_fused", {"gossip": "ring", "ring_fused": True},
     ("ring_gossip_update",)),
    ("crash", {"use_pallas": True, "faults": "crash"},
     ("obfuscate_update", "masked_gossip_update")))


class _StandIn:
    """A stand-in mesh: m = 4 agents on one card."""
    shape = {"data": 4, "model": 1}


def _flat_of(torch, tree):
    from repro_torch.core.privacy import tree_leaves
    return [t.reshape(t.shape[0], -1) for t in tree_leaves(tree)]


def _gossip_gate(torch, got, want, x0, u0, W, B) -> float:
    """Max over the parameters of |got - want| / tol, tol = 2^-7 (|W||x| +
    |B||u|) + 2^-6 |want| per entry: the kernel route and the plain
    formula round the two bf16 products and their difference apart
    (B2/B4/B7's bf16 allowance of the earlier phases), a column chunk at
    a time."""
    worst = 0.0
    for g, w, x, u in zip(_flat_of(torch, got), _flat_of(torch, want),
                          _flat_of(torch, x0), _flat_of(torch, u0)):
        for s, e in _chunks(g.shape[1]):
            diff = (g[:, s:e].float() - w[:, s:e].float()).abs()
            tol = (2.0 ** -7 * (W.abs() @ x[:, s:e].float().abs()
                                + B.abs() @ u[:, s:e].float().abs())
                   + 2.0 ** -6 * w[:, s:e].float().abs())
            worst = max(worst, float((diff / tol.clamp_min(1e-30)).max()))
    return worst


def phase_mesh_train_step(torch, K, train, cfg):
    """`launch.steps.make_train_step` on a stand-in mesh {"data": 4,
    "model": 1} (m = 4 on the card) at the bits path's width and depth,
    bf16, batch 2, seq 512, 3 steps, four ways: dense (B1 + B2), under
    link dropout 0.25 (B1 + B4), the ring with ``ring_fused`` (B7), crash
    faults (B1 + B4, down rows held).  Gates: every step launches its
    form's kernels; each form's first step against the same step on the
    plain formula (``use_pallas=False``; the ring's dense fallback)
    within B2/B4/B7's bf16 allowance (`_gossip_gate`); the dense form
    bitwise `core.pdsgd.make_decentralized_step` (B1 + B2 on the same
    key, step and lam_base / (k + 1), as the reference's two are);
    finite losses.  Then ``sharded=True`` on a one-rank NCCL (1, 1, 1)
    mesh, bitwise the unsharded step on that mesh (m = 1).  Prints ms a
    step and peak memory of each form beside the bits path's ms a
    step."""
    from repro_torch.core import prng
    from repro_torch.core.mixing import make_mixing
    from repro_torch.core.pdsgd import init_state, make_decentralized_step
    from repro_torch.core.privacy import (agent_key, sample_B, tree_leaves,
                                          tree_unflatten)
    from repro_torch.core.schedules import harmonic
    from repro_torch.data import make_lm_pipeline
    from repro_torch.dist import collectives as C
    from repro_torch.faults import make_faults
    from repro_torch.kernels.build import to_device
    from repro_torch.launch.steps import (_own_u, make_train_step,
                                          torus_topology)
    from repro_torch.models import build_model
    dev = torch.device("cuda", 0)
    m, mesh = 4, _StandIn()
    bundle = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    p0 = bundle.init(gen, dev)
    params0 = tree_unflatten(p0, [p[None].expand((m,) + tuple(p.shape))
                                  .contiguous() for p in tree_leaves(p0)])
    del p0
    pipe = make_lm_pipeline(cfg.vocab_size, m, 2, 512, seed=0)
    batches = [{n: to_device(torch.from_numpy(v), dev)
                for n, v in pipe.batch_at(k).items()}
               for k in range(MESH_STEP_STEPS)]
    tt = torus_topology(mesh)
    named = {"mixing": {"dropout": make_mixing(tt, rate=0.25, seed=0)},
             "faults": {"crash": make_faults(m, crash_rate=0.2,
                                             restart_rate=0.5, seed=0)}}
    # the first step's gradients and u (every form's: one key, one lam,
    # one batch), the scale of the gate's allowance
    from repro_torch.core.pdsgd import DecentralizedState, _agent_grads
    from repro_torch.kernels.ops import FlatLayout
    layout = FlatLayout.of(tree_unflatten(params0, [
        t[0] for t in tree_leaves(params0)]))
    G = torch.empty((m, layout.width), dtype=bundle.dtype, device=dev)
    X0 = layout.flatten(params0, m)
    _agent_grads(bundle.loss_fn, DecentralizedState(flat=X0, layout=layout),
                 batches[0], G)
    key = prng.key(0)
    lam = torch.full((), 0.1, dtype=torch.float32, device=dev)
    U0 = layout.tree(_own_u(G, layout, key.to(dev), 0, lam, 0))
    del G, X0
    launches, forms = {}, {}
    for name, kw, kernels in MESH_STEP_FORMS:
        kw = {k: named[k][v] if k in named else v for k, v in kw.items()}
        step = make_train_step(bundle, mesh, lam_base=0.1, **kw)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        params, times, losses, first = params0, [], [], None
        for k, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, loss = step(params, batch, 0, k)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            print(f"mesh_train_step {name} step {k}: {times[-1]:.1f} ms",
                  flush=True)
            if k == 0:
                first = params
        counts = dict(K.launch_counts)
        peak = torch.cuda.max_memory_allocated() - base
        check(all(math.isfinite(l) for l in losses),
              f"mesh_train_step {name}: losses {losses}")
        for kern in kernels:
            check(counts.get(kern, 0) == MESH_STEP_STEPS,
                  f"mesh_train_step {name}: {kern} launched "
                  f"{counts.get(kern, 0)} times in {MESH_STEP_STEPS} steps")
            launches[kern] = launches.get(kern, 0) + counts.get(kern, 0)
        del params
        # the same first step on the plain formula
        plain_kw = dict(kw, use_pallas=False)
        plain_kw.pop("ring_fused", None)
        K.reset_launch_counts()
        want, _ = make_train_step(bundle, mesh, lam_base=0.1, **plain_kw)(
            params0, batches[0], 0, 0)
        check(not any(K.launch_counts.values()),
              f"mesh_train_step {name}: the plain step launched "
              f"{dict(K.launch_counts)}")
        W, support = step_coupling(named, kw, tt, dev)
        if kw.get("gossip") == "ring":
            b = C.sample_b_draws(agent_key(prng.fold_in(key, 2), 0, 0), m,
                                 m, 1).to(dev)
            _, B = C.dense_coupling(b, m, 1)
        else:
            B = sample_B(agent_key(prng.fold_in(key, 2), 0, 0), support)
        ratio = _gossip_gate(torch, first, want, params0, U0, W.float(),
                             B.float())
        del want
        check(ratio <= 1.0, f"mesh_train_step {name}: {ratio} of the bf16 "
                            f"allowance against the plain step")
        forms[name] = {"ms_per_step": times, "losses": losses,
                       "peak_bytes": peak, "launches": counts,
                       "share_of_allowance": ratio}
        del first
        print(f"mesh_train_step {name}: {times[1:]} ms a step, peak "
              f"{peak / 1e9:.2f} GB, {ratio:.3f} of the allowance",
              flush=True)
    # dense against the single-controller step, bitwise
    gc.collect()
    state = init_state(tree_unflatten(params0, [t[0] for t in tree_leaves(
        params0)]), m, device=dev)
    core = make_decentralized_step(bundle.loss_fn, tt, harmonic(0.1),
                                   kernel_rng=False)
    step = make_train_step(bundle, mesh, lam_base=0.1, use_pallas=True)
    params = params0
    for k in range(2):
        state.step = k
        state, aux = core(state, batches[k], prng.key(0))
        params, loss = step(params, batches[k], 0, k)
        check(float(loss) == float(aux["loss"]),
              f"mesh_train_step vs make_decentralized_step: loss {k}")
        for a, v in zip(tree_leaves(params),
                        state.layout.leaf_views(state.flat)):
            check(same_bits(torch, a, v),
                  f"mesh_train_step vs make_decentralized_step: step {k}")
    del state, params, params0, U0
    gc.collect()
    torch.cuda.empty_cache()
    sharded = _one_rank_sharded_step(torch, bundle, batches[0])
    rec = {"phase": "mesh_train_step", "arch": cfg.name,
           "num_layers": cfg.num_layers, "agents": m, "steps":
           MESH_STEP_STEPS, "forms": forms, "launches": launches,
           "decentralized_step_bitwise": True, "sharded_one_rank": sharded}
    emit(rec)
    return launches


def step_coupling(named, kw, tt, dev):
    """(W, support) of step 0 of a form (the realized dropout or crash
    coupling, else the torus')."""
    from repro_torch.core.mixing import as_process
    from repro_torch.faults.process import realize_coupling
    proc = kw.get("mixing") or as_process(tt)
    if kw.get("faults") is not None:
        W, support, _, _, _ = realize_coupling(proc, kw["faults"], 0, dev)
        return W, support
    W, support, _ = proc.realize(0, dev)
    return W, support


def _one_rank_sharded_step(torch, bundle, batch):
    """``make_train_step(sharded=True)`` on a one-rank NCCL (1, 1, 1) mesh
    (`launch.mesh.make_sharded_mesh`, one agent): the parameters DTensors
    placed by TRAIN_RULES, the loss and its gradient by DTensor
    propagation, the update leafwise (B1, B2 per leaf); bitwise the
    unsharded step on the same mesh (B1 + B2 over the whole row)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.core.privacy import tree_leaves, tree_unflatten
    from repro_torch.dist.sharding import local_block, placements
    from repro_torch.launch.mesh import make_sharded_mesh
    from repro_torch.launch.steps import _leaf_specs, make_train_step
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_sharded_mesh(agents=1, fsdp=1, tensor=1,
                                 device_type=dev.type)
        specs = _leaf_specs(bundle, mesh, 1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        p0 = bundle.init(gen, dev)
        params = tree_unflatten(p0, [
            local_block(mesh, p[None].contiguous(),
                        placements(s, mesh, p.dim() + 1))
            for p, s in zip(tree_leaves(p0), tree_leaves(specs))])
        del p0
        row = {n: v[:1] for n, v in batch.items()}
        K_counts = {}
        from repro_torch import kernels as K
        out = {}
        for sharded in (True, False):
            K.reset_launch_counts()
            step = make_train_step(bundle, mesh, lam_base=0.1,
                                   use_pallas=True, sharded=sharded)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, loss = step(params, row, 0, 0)
            torch.cuda.synchronize()
            out[sharded] = ([t.to_local().clone() if isinstance(t, DTensor)
                             else t.clone() for t in tree_leaves(new)],
                            float(loss), (time.perf_counter() - t0) * 1e3,
                            dict(K.launch_counts))
            del new
        same = (out[True][1] == out[False][1] and all(
            same_bits(torch, a, b) for a, b in zip(out[True][0],
                                                   out[False][0])))
        check(same, "sharded one-rank step differs from the unsharded step")
        check(out[True][3].get("obfuscate_update", 0) == len(out[True][0])
              and out[True][3].get("gossip_update", 0) == len(out[True][0]),
              f"sharded one-rank launches {out[True][3]}")
        return {"bitwise": same, "loss": out[True][1],
                "ms_sharded": out[True][2], "ms_unsharded": out[False][2],
                "launches_sharded": out[True][3],
                "launches_unsharded": out[False][3]}
    finally:
        dist.destroy_process_group()


FIG2_ITERS = 600
FIG2_UNROLL = 100
# the reference's recorded final_err_scanned of the Fig. 2 workload
# (BENCH_pdsgd.json), drawn from jax's earlier threefry stream
NORTH_STAR = 0.07891825798133546
SCANNED_UNROLL = 4
SCANNED_STEPS = 12  # a warm-up chunk, then two replayed chunks
# the stablelm scanned cells' depth (the main path's 8 halved for the
# time limit: those cells are bound by the host's dispatch)
SCANNED_LAYERS = 4
BASELINE_STEPS = 3


def _fig2_workload(torch, prng, dev, partitionable: bool, **step_kw):
    """`benchmarks/run.py::bench_step_path`'s workload on the card: m = 5,
    d = 2, paper_fig1, paper_experiment(0.05), estimation_problem(5, d=2,
    s=3, n_per_agent=100, seed=0), sample indices from default_rng(0),
    keys split(key(0), 600); every draw in the threefry stream
    ``partitionable`` names; ``step_kw`` go to the step (faults,
    aggregation)."""
    import numpy as np
    from repro_torch.core.pdsgd import make_decentralized_step
    from repro_torch.core.schedules import paper_experiment
    from repro_torch.core.topology import make_topology
    from repro_torch.data import estimation_problem
    m, d = 5, 2
    prob = estimation_problem(m, d=d, s=3, n_per_agent=100, seed=0)
    idx = np.random.default_rng(0).integers(0, 100,
                                            size=(FIG2_ITERS, m, 8))
    zb = torch.from_numpy(prob["Z"][np.arange(m)[None, :, None], idx])
    M = torch.from_numpy(prob["M"])

    def loss(p, batch):
        z, Mi = batch
        return torch.mean(torch.sum((z - p @ Mi.T) ** 2, -1))

    step = make_decentralized_step(loss, make_topology("paper_fig1", m),
                                   paper_experiment(0.05),
                                   partitionable=partitionable, **step_kw)
    keys = prng.split(prng.key(0), FIG2_ITERS, partitionable)

    def err(state):
        # as bench_step_path takes it: the f32 agent mean, then the norm
        x = state.flat[:, :d].cpu().numpy()
        return float(np.linalg.norm(x.mean(0) - prob["theta_opt"]))
    return step, zb.to(dev), M.to(dev), keys, err


def _fig2_eager(torch, K, step, zb, M, keys, iters):
    from repro_torch.core.pdsgd import init_state
    state = init_state(torch.zeros(2), 5, device=zb.device)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(iters):
        state, aux = step(state, (zb[k], M), keys[k])
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / iters * 1e6
    return state, aux, us, dict(K.launch_counts)


# kernel names of B3 and B2 in a trace (csrc/obfuscate.cu, csrc/gossip.cu)
TRACE_NAMES = {"obfuscate_update_krng": "obfuscate_krng_kernel",
               "gossip_update": "gossip_kernel"}


def _trace_replay(torch, run, steps: int) -> dict:
    """Device kernels of one call of ``run`` (a replayed chunk of
    ``steps`` steps) from a torch.profiler trace: kernels a step, device
    busy µs a step, the chunk's window, B3's and B2's kernels counted
    (their launches inside the replay, which no wrapper counts) and the
    top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return {"kernel_events": 0}
    lo = min(e.time_range.start for e in kernels)
    hi = max(e.time_range.end for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.end - e.time_range.start
    busy = sum(t for _, t in by_name.values())
    traced = {n: sum(c for k, (c, _) in by_name.items() if sub in k)
              for n, sub in TRACE_NAMES.items()}
    top = [{"kernel": k[:100], "per_step": c / steps, "us_per_step": t / steps}
           for k, (c, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:10]]
    return {"kernel_events": len(kernels),
            "kernels_per_step": len(kernels) / steps,
            "device_busy_us_per_step": busy / steps,
            "window_us_per_step": (hi - lo) / steps,
            "idle_share": 1.0 - busy / (hi - lo) if hi > lo else None,
            "b_kernels_traced": traced, "top": top}


def phase_fig2_path(torch, K, prng):
    """The North star's workload (paper Fig. 2) on the card: 600 PDSGD steps
    (B3 + B2 each) through the eager loop, then through the scanned step
    (`make_scanned_steps`, a CUDA graph of 100 steps: its first chunk the
    warm-up, five replays), every draw in jax's earlier threefry stream,
    the one the target was drawn from (``partitionable=False``); then one
    more replay under torch.profiler, whose trace counts the kernels a
    replayed step runs.  Gates: the graph's state equal to the eager
    loop's bit for bit, final_err within a relative 1e-3 of
    0.07891825798133546, 600 launches of B3 and of B2 counted on the
    eager loop, 100 counted on the graph's warm-up chunk, and the traced
    replay's B3 and B2 kernels equal to what its capture counted (100)."""
    from repro_torch.core.pdsgd import init_state, make_scanned_steps
    dev = torch.device("cuda")
    step, zb, M, keys, err = _fig2_workload(torch, prng, dev, False)
    _fig2_eager(torch, K, step, zb, M, keys, 5)  # warm-up
    eager, aux_e, us_eager, c_eager = _fig2_eager(
        torch, K, step, zb, M, keys, FIG2_ITERS)
    scanned = make_scanned_steps(step, FIG2_UNROLL)
    state = init_state(torch.zeros(2), 5, device=dev)
    Mk = M.expand(FIG2_UNROLL, *M.shape)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    chunk_us = []
    losses = []
    for c in range(FIG2_ITERS // FIG2_UNROLL):
        sl = slice(c * FIG2_UNROLL, (c + 1) * FIG2_UNROLL)
        t0 = time.perf_counter()
        state, aux = scanned(state, (zb[sl], Mk), keys[sl])
        losses.append(aux["loss"])
        torch.cuda.synchronize()
        chunk_us.append((time.perf_counter() - t0) / FIG2_UNROLL * 1e6)
    c_graph = dict(K.launch_counts)
    replayed = scanned.replayed_launches()
    e_eager, e_graph = err(eager), err(state)
    check(same_bits(torch, state.flat, eager.flat),
          "fig2_path: graph state differs from the eager loop's")
    # one more replay (steps 600-699 on the last chunk's batches), traced
    last = slice(FIG2_ITERS - FIG2_UNROLL, FIG2_ITERS)
    trace = _trace_replay(torch, lambda: scanned(state, (zb[last], Mk),
                                                 keys[last]), FIG2_UNROLL)
    gap = abs(e_graph - NORTH_STAR) / NORTH_STAR
    losses = torch.cat(losses)
    check(bool(torch.isfinite(losses).all()), "fig2_path losses")
    check(gap <= 1e-3, f"fig2_path final_err {e_graph}: {gap} from "
                       f"{NORTH_STAR}")
    replays = FIG2_ITERS // FIG2_UNROLL - 1
    for name, c, n in (("eager", c_eager, FIG2_ITERS),
                       ("graph warm-up", c_graph, FIG2_UNROLL),
                       ("graph replays", replayed, replays * FIG2_UNROLL)):
        check(all(c.get(b, 0) == n for b in TRACE_NAMES),
              f"fig2_path {name} launches {c}")
    check(trace.get("b_kernels_traced") == {b: FIG2_UNROLL
                                             for b in TRACE_NAMES},
          f"fig2_path traced replay {trace.get('b_kernels_traced')}")
    emit({"phase": "fig2_path", "workload": "fig2_estimation d=2 m=5 "
          "iters=600, paper_fig1, paper_experiment(0.05)",
          "threefry": "partitionable=False (jax_threefry_partitionable="
                      "False)",
          "us_per_step_eager": us_eager,
          "us_per_step_graph": sum(chunk_us) / len(chunk_us),
          "us_per_step_graph_replays": sum(chunk_us[1:]) / len(chunk_us[1:]),
          "us_per_step_graph_first_chunk": chunk_us[0],
          "unroll_k": FIG2_UNROLL, "final_err_eager": e_eager,
          "final_err_graph": e_graph, "north_star": NORTH_STAR,
          "rel_gap_to_north_star": gap,
          "graph_equals_eager_bitwise": True,
          "launches_eager": c_eager,
          "launches_graph_warmup_counted": c_graph,
          "launches_graph_replays_from_capture": replayed,
          "replays": replays, "traced_replay": trace})


def _ms_per_step(hist, first: int, last: int | None = None) -> float:
    """Host ms a step between the records of steps ``first`` and ``last``
    (default: the last; each record's time is taken after its step's, or
    chunk's, sync)."""
    recs = {r["step"]: r["elapsed_s"] for r in hist if "step" in r}
    last = max(recs) if last is None else last
    return (recs[last] - recs[first]) / (last - first) * 1e3


def phase_main_path_scanned(torch, K, train, cfg):
    """The main path's configuration through `--unroll-k 4`: a warm-up chunk
    (the graph's code path run eagerly, then captured), then two chunks
    replayed (8 steps); beside it the same 12 steps through the eager
    loop.  Gates: finite losses; the scanned run's state equal to the
    eager run's bit for bit after the warm-up and both replays; B3 and B2
    counted once a step of the warm-up chunk, and once a step of each
    replay from the capture (no wrapper sees a replay; `--profile`'s
    trace counts their kernels)."""
    steps, k = SCANNED_STEPS, SCANNED_UNROLL
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        ("--unroll-k", str(k)))
    hist = res["history"]
    losses = [r["loss"] for r in hist]
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and res["state"].step == steps, "steps run")
    replayed = res["replayed_launches"]
    for what, c, n in (("counted", counts, k),
                       ("replayed", replayed, steps - k)):
        check(all(c.get(b, 0) == n for b in TRACE_NAMES),
              f"main_path_scanned {what} launches {c}")
    ms_scanned = _ms_per_step(hist, k - 1)
    scanned_state = res["state"]
    del res
    eager, e_counts, e_wall, e_peak = _run_path(torch, K, train, cfg, steps,
                                                True, held=True)
    same = same_bits(torch, scanned_state.flat, eager["state"].flat)
    check(same, "main_path_scanned: the graph's state differs from the "
                "eager loop's")
    ms_eager = _ms_per_step(eager["history"], k - 1)
    emit({"phase": "main_path_scanned", "arch": cfg.name,
          "num_layers": cfg.num_layers, "dtype": cfg.dtype, "agents": 4,
          "topology": "ring", "per_agent_batch": 2, "seq_len": 512,
          "unroll_k": k, "steps": steps, "losses": losses,
          "ms_per_step_replayed": ms_scanned,
          "ms_per_step_eager_same_steps": ms_eager,
          "first_chunk_s": hist[k - 1]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak,
          "max_memory_allocated_eager": e_peak,
          "state_equals_eager_bitwise": same,
          "launches_warmup_counted": counts,
          "launches_replays_from_capture": replayed})


# resample 4 redraws at each chunk's first step; 3 inside the replayed
# chunks (steps 6 and 9), at a different offset in each
DROPOUT_SCANNED_RUNS = (("dropout", DROPOUT_FLAGS),
                        ("resample", ("--topology-resample-every", "4")),
                        ("resample_3", ("--topology-resample-every", "3")))


def phase_dropout_path_scanned(torch, K, train, cfg):
    """The dropout path through `--unroll-k 4` (a warm-up chunk, then two
    chunks replayed from the CUDA graph, each W_k realized in the graph
    from the device step counter and B4 computing its Metropolis weights),
    beside the same 12 steps eager; then the same with
    `--topology-resample-every 4` and 3 (3 redraws inside the replayed
    chunks).  Gate: the states equal bit for bit.
    B3 and B4 counted once a step of the warm-up chunk, and once a step of
    each replay from the capture."""
    steps, k = SCANNED_STEPS, SCANNED_UNROLL
    out = {}
    for name, flags in DROPOUT_SCANNED_RUNS:
        res, counts, wall, peak = _run_path(
            torch, K, train, cfg, steps, True,
            (*flags, "--unroll-k", str(k)))
        hist = _step_records(res)
        losses = [r["loss"] for r in hist]
        check(all(math.isfinite(l) for l in losses), f"losses {losses}")
        check(len(hist) == steps and res["state"].step == steps,
              "steps run")
        replayed = res["replayed_launches"]
        for what, c, n in (("counted", counts, k),
                           ("replayed", replayed, steps - k)):
            check(c.get("obfuscate_update_krng", 0) == n
                  and c.get("masked_gossip_update", 0) == n
                  and c.get("gossip_update", 0) == 0,
                  f"dropout_path_scanned {name} {what} launches {c}")
        ms_scanned = _ms_per_step(hist, k - 1)
        scanned_state = res["state"]
        del res
        eager, _, e_wall, e_peak = _run_path(torch, K, train, cfg, steps,
                                             True, flags, held=True)
        same = same_bits(torch, scanned_state.flat, eager["state"].flat)
        check(same, f"dropout_path_scanned {name}: the graph's state "
                    f"differs from the eager loop's")
        windows = [r.get("b_window_connected") for r in hist]
        rec = {"phase": "dropout_path_scanned", "mode": name,
               "flags": list(flags), "arch": cfg.name,
               "num_layers": cfg.num_layers, "dtype": cfg.dtype,
               "agents": 4, "topology": "ring", "per_agent_batch": 2,
               "seq_len": 512, "unroll_k": k, "steps": steps,
               "losses": losses,
               "ms_per_step_replayed": ms_scanned,
               "ms_per_step_eager_same_steps": _ms_per_step(
                   _step_records(eager), k - 1),
               "first_chunk_s": hist[k - 1]["elapsed_s"],
               "run_wall_s": wall, "eager_wall_s": e_wall,
               "max_memory_allocated": peak,
               "max_memory_allocated_eager": e_peak,
               "b_window_connected": windows,
               "state_equals_eager_bitwise": same,
               "launches_warmup_counted": counts,
               "launches_replays_from_capture": replayed}
        emit(rec)
        out[name] = rec
        del scanned_state, eager
        gc.collect()
        torch.cuda.empty_cache()
    return out


# the fault modes a FaultProcess realizes on the card against the CPU
FAULT_REALIZE_MODES = {"markov": {"crash_rate": 0.2, "restart_rate": 0.5},
                       "failstop": {"crash_rate": 0.05},
                       "corrupt": {"corrupt_rate": 0.25}}
FAULT_REALIZE_STEPS = 512


def phase_fault_realize(torch, prng):
    """`FaultProcess.realize` from a 0-d int64 counter on the card against
    the CPU's realization from the int, steps 0..511, 4 agents, in the
    Markov (FAULT_FLAGS' rates), failstop and corrupt modes: the gate is
    bitwise.  Diagnostic: the float32 outage-length formula the Markov
    draw stands for (``1 + floor(log1p(-u) / log1p(-0.5))``), evaluated by
    the card and by the CPU over all 2^23 uniforms, and log1p's own
    differences there (the realization compares u with thresholds instead,
    so it takes no log1p on the card)."""
    from repro_torch.faults import make_faults
    dev = torch.device("cuda")
    rec = {"phase": "fault_realize", "agents": 4,
           "steps": FAULT_REALIZE_STEPS, "modes": {}}
    ctr = torch.zeros((), dtype=torch.int64, device=dev)
    for name, kw in FAULT_REALIZE_MODES.items():
        faults = make_faults(4, seed=0, **kw)
        dev_rows, host_rows = [], []
        for k in range(FAULT_REALIZE_STEPS):
            ctr.fill_(k)
            dev_rows.append(torch.stack(faults.realize(ctr)))
            host_rows.append(torch.stack(faults.realize(k)))
        got = torch.stack(dev_rows).cpu()
        want = torch.stack(host_rows)
        forks = int((got != want).any(dim=2).any(dim=1).sum())
        check(forks == 0, f"fault_realize {name}: {forks} of "
                          f"{FAULT_REALIZE_STEPS} steps differ from the CPU")
        rec["modes"][name] = {
            "down_agent_steps": int((want[:, 0] == 0).sum()),
            "corrupt_agent_steps": int((want[:, 1] > 0).sum()),
            "steps_differing": forks}
    u_cpu = prng.bits_to_uniform(torch.arange(1 << 23, dtype=torch.int64)
                                 << 9)
    c = torch.tensor(math.log1p(-0.5), dtype=torch.float32)
    lg_cpu = torch.log1p(-u_cpu)
    lg_dev = torch.log1p(-u_cpu.to(dev)).cpu()
    ulps = (lg_cpu.view(torch.int32).long()
            - lg_dev.view(torch.int32).long()).abs()
    dur_cpu = torch.clamp(1.0 + torch.floor(lg_cpu / c), 1.0, 64.0)
    dur_dev = torch.clamp(1.0 + torch.floor(
        lg_dev.to(dev) / c.to(dev)), 1.0, 64.0).cpu()
    rec["log1p_card_vs_cpu"] = {
        "uniforms": 1 << 23, "log1p_differing": int((ulps > 0).sum()),
        "log1p_max_ulps": int(ulps.max()),
        "outage_lengths_differing": int((dur_cpu != dur_dev).sum())}
    emit(rec)
    return rec


def fault_seed_replayed(train, flags, steps: int, first: int) -> int:
    """The first fault seed whose realization has a down agent (and, with
    a corrupt rate, a corrupt sender) in steps ``first``..``steps - 1``,
    the replayed chunks of a scanned run."""
    for seed in range(100):
        faults = train.build_faults(_path_args(
            train, steps, (*flags, "--fault-seed", str(seed))))
        rows = [faults.realize(k) for k in range(first, steps)]
        if any(bool((a == 0).any()) for a, _ in rows) and (
                faults.corrupt_rate == 0.0
                or any(bool(c.any()) for _, c in rows)):
            return seed
    raise AssertionError(f"no fault seed below 100 fires in the replays "
                         f"of {flags}")


def _strip_times(hist) -> list[str]:
    """Step records without their times, as JSON (nan equals nan)."""
    return [json.dumps({k: v for k, v in r.items() if k != "elapsed_s"})
            for r in hist]


def _scanned_beside_eager(torch, K, train, cfg, extra, kernels: dict,
                          steps: int = SCANNED_STEPS,
                          unroll: int = SCANNED_UNROLL,
                          seq_len: int = 512) -> dict:
    """run_training with ``extra`` at ``--unroll-k unroll`` (a warm-up chunk,
    then replayed chunks), then the same steps eagerly.  Gates: finite
    losses, the states equal bit for bit, the step records (losses,
    consensus errors, cumulative fault counters) and the fault totals
    equal; each of ``kernels`` (name -> launches a step) counted that
    many times a step of the warm-up chunk and, from the capture, of each
    replay.  Returns the phase's numbers."""
    res, counts, wall, peak = _run_path(
        torch, K, train, cfg, steps, True, (*extra, "--unroll-k",
                                            str(unroll)), seq_len)
    hist = _step_records(res)
    losses = [r["loss"] for r in hist]
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and res["state"].step == steps, "steps run")
    replayed = res["replayed_launches"]
    for what, c, n in (("counted", counts, unroll),
                       ("replayed", replayed, steps - unroll)):
        check(all(c.get(b, 0) == per * n for b, per in kernels.items()),
              f"scanned {list(extra)} {what} launches {c}")
    scanned_state, graphs = res["state"], res["graphs"]
    totals = res["fault_totals"]
    ms_scanned = _ms_per_step(hist, unroll - 1)
    del res
    eager, _, e_wall, e_peak = _run_path(torch, K, train, cfg, steps, True,
                                         extra, seq_len, held=True)
    e_hist = _step_records(eager)
    same = same_bits(torch, scanned_state.flat, eager["state"].flat)
    check(same, f"scanned {list(extra)}: the graph's state differs from "
                f"the eager loop's")
    check(_strip_times(hist) == _strip_times(e_hist),
          f"scanned {list(extra)}: step records differ from the eager "
          f"loop's")
    check(totals == eager["fault_totals"],
          f"scanned {list(extra)}: fault totals {totals} against "
          f"{eager['fault_totals']}")
    out = {"flags": list(extra), "unroll_k": unroll, "steps": steps,
           "losses": losses, "fault_totals": totals,
           "ms_per_step_replayed": ms_scanned,
           "ms_per_step_eager_same_steps": _ms_per_step(e_hist, unroll - 1),
           "first_chunk_s": hist[unroll - 1]["elapsed_s"],
           "graphs": graphs, "run_wall_s": wall, "eager_wall_s": e_wall,
           "max_memory_allocated": peak,
           "max_memory_allocated_eager": e_peak,
           "idle_share": "not measured (--profile)",
           "state_equals_eager_bitwise": same,
           "records_equal_eager": True,
           "launches_warmup_counted": counts,
           "launches_replays_from_capture": replayed}
    del scanned_state, eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_fault_path_scanned(torch, K, train, cfg):
    """The fault path (FAULT_FLAGS: Markov crash 0.2 / restart 0.5,
    nan-corrupt 0.25, guard clip 1e3, --nan-policy skip) through
    `--unroll-k 4`: a warm-up chunk, then two chunks replayed from the CUDA
    graph (faults realized in it from the device counter, down rows and
    the skip as ``where`` on one held anchor), beside the same 12 steps
    eager; the fault seed puts down agents and corrupt senders in the
    replays.  Gates: states, step records and fault counters equal; B3
    and B6 counted 4 on the warm-up and 8 on the replays."""
    seed = fault_seed_replayed(train, FAULT_FLAGS, SCANNED_STEPS,
                               SCANNED_UNROLL)
    extra = (*FAULT_FLAGS, "--fault-seed", str(seed))
    rec = _scanned_beside_eager(torch, K, train, cfg, extra,
                                {"obfuscate_update_krng": 1,
                                 "guarded_gossip_update": 1,
                                 "gossip_update": 0})
    check(rec["fault_totals"].get("fault_down", 0) > 0
          and rec["fault_totals"].get("fault_corrupt", 0) > 0,
          f"fault_path_scanned totals {rec['fault_totals']}")
    rec = {"phase": "fault_path_scanned", "arch": cfg.name,
           "num_layers": cfg.num_layers, "dtype": cfg.dtype, "agents": 4,
           "topology": "ring", "per_agent_batch": 2, "seq_len": 512,
           "fault_seed": seed, **rec}
    emit(rec)
    return rec


RING_FAULT_FLAGS = ("--fault-crash-rate", "0.2", "--fault-restart-rate",
                    "0.5")


def phase_ring_path_scanned(torch, K, train, cfg):
    """The ring layout (--kernel-layout ring: B9 once a step) through
    `--unroll-k 4`, static and with Markov crash/restart (the faults the
    ring carries; the seed puts down agents in the replays), each beside
    the same 12 steps eager.  Gates: states and step records equal; B9
    counted 4 on the warm-up and 8 on the replays, no B3 or B2."""
    out = {}
    for name, flags in (("static", ()), ("crash_restart", RING_FAULT_FLAGS)):
        extra = (*RING_FLAGS, *flags)
        if flags:
            extra += ("--fault-seed", str(fault_seed_replayed(
                train, flags, SCANNED_STEPS, SCANNED_UNROLL)))
        rec = _scanned_beside_eager(torch, K, train, cfg, extra,
                                    {"ring_obfuscate_gossip_krng": 1,
                                     "obfuscate_update_krng": 0,
                                     "gossip_update": 0})
        rec = {"phase": "ring_path_scanned", "mode": name,
               "arch": cfg.name, "num_layers": cfg.num_layers,
               "dtype": cfg.dtype, "agents": 4, "topology": "ring",
               "per_agent_batch": 2, "seq_len": 512, **rec}
        emit(rec)
        out[name] = rec
    return out


def phase_rollback_path_scanned(torch, K, train, cfg):
    """ROLLBACK_FLAGS with --unroll-k 2 on stablelm-3b-smoke f32: the
    scanned loop counts non-finite chunks toward --rollback-patience,
    closes its prefetch stream and restarts it from the restored step,
    which is loaded into the graph's own buffers.  Gates: the exhaustion
    error after two rollbacks; the records and the error equal the port's
    CPU run of the same flags; B3 and B6 counted on one warm-up chunk only
    (2 steps), so every chunk after it, those after each rollback too,
    replayed the one captured graph."""
    seed = rollback_seed(train, ROLLBACK_STEPS)
    extra = (*ROLLBACK_FLAGS, "--fault-seed", str(seed), "--unroll-k", "2")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    recs, err = _rollback_run(train, cfg, extra, "cuda",
                              CKPT_DIR / "rollback_scanned_cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    cpu_recs, cpu_err = _rollback_run(train, cfg, extra, "cpu",
                                      CKPT_DIR / "rollback_scanned_cpu")
    check(err is not None and "stayed non-finite through 2 rollback(s)"
          in err, f"rollback_path_scanned error {err!r}")
    check([r["rollback"] for r in recs] == [1, 2],
          f"rollback_path_scanned records {recs}")
    check((recs, err) == (cpu_recs, cpu_err),
          f"rollback_path_scanned: card {recs} {err!r}, CPU {cpu_recs} "
          f"{cpu_err!r}")
    check(counts.get("obfuscate_update_krng", 0) == 2
          and counts.get("guarded_gossip_update", 0) == 2,
          f"rollback_path_scanned launches {counts}")
    rec = {"phase": "rollback_path_scanned", "arch": cfg.name,
           "dtype": cfg.dtype, "agents": 4, "seq_len": 32,
           "steps": ROLLBACK_STEPS, "flags": list(extra), "records": recs,
           "error": err, "records_equal_cpu": True, "run_wall_s": wall,
           "launches_warmup_counted": counts}
    emit(rec)
    return rec


XLSTM_SCANNED_STEPS = 6  # a warm-up chunk, then two replayed chunks
XLSTM_SCANNED_UNROLL = 2
# the scanned xLSTM cell at depth 12 -> 6 blocks, then 4, then 2 (1
# mLSTM, 1 sLSTM) for the script's time limit: on an NVIDIA H100 80GB HBM3
# at 700.00 W its capture took 47.5 s of 106.5 at 12, the phase 49.8 s at
# 6, and 44.9 s at 4 with per-layer recompute (the sLSTM loop's forward
# runs twice a step)
XLSTM_SCANNED_LAYERS = 2


def _family_train_scanned(torch, K, train, cfg, phase: str, b11: int,
                          steps: int, unroll: int, seq_len: int,
                          flags=()) -> dict:
    """A family's train path (4 agents on a ring, per-agent batch 2, and
    ``flags``) through `--unroll-k unroll` beside the same steps eager
    (`_scanned_beside_eager`): B3 and B2 counted once a step and B11
    ``b11`` times a step on the warm-up, and from the capture on the
    replays.  Reports the capture's seconds and the graph's nodes."""
    m = 4
    rec = _scanned_beside_eager(
        torch, K, train, cfg, tuple(flags),
        {"obfuscate_update_krng": 1, "gossip_update": 1,
         "ssd_intra_chunk": b11},
        steps=steps, unroll=unroll, seq_len=seq_len)
    graph = rec["graphs"][0] if rec["graphs"] else {}
    rec = {"phase": phase, "arch": cfg.name, "num_layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "agents": m,
           "topology": "ring", "per_agent_batch": 2, "seq_len": seq_len,
           "capture_s": graph.get("capture_s"),
           "warmup_chunk_s": graph.get("warmup_s"),
           "graph_nodes": graph.get("nodes"), **rec}
    emit(rec)
    return rec


def _mlstm_blocks(cfg) -> int:
    return sum(1 for i in range(cfg.num_layers) if i % cfg.slstm_every != 1)


def phase_xlstm_train_scanned(torch, K, train, cfg):
    """xlstm-125m at full width, XLSTM_SCANNED_LAYERS blocks, 4 agents,
    per-agent batch 2, seq 128, through `--unroll-k 2`: a warm-up chunk,
    then two chunks replayed from one CUDA graph that holds the sLSTM
    token loop unrolled and B11's autograd Function, beside the same 6
    steps eager.  Gates: states and step records equal; B3 and B2 once a
    step and B11 4 agents x the mLSTM blocks x 2 calls x RECOMPUTE a
    step."""
    check(cfg.num_layers == XLSTM_SCANNED_LAYERS and cfg.d_model == 768,
          "xlstm-125m at full width")
    return _family_train_scanned(
        torch, K, train, cfg, "xlstm_train_scanned",
        4 * _mlstm_blocks(cfg) * 2 * RECOMPUTE, XLSTM_SCANNED_STEPS,
        XLSTM_SCANNED_UNROLL, XLSTM_TRAIN_SEQ)


# scale 2: at 50 (or 1e4) the trimmed mean over paper_fig1's two or three
# neighbours lets scaled states through and the run diverges, in the
# reference as in the port (final error 1.3e14 after 200 steps at 50)
TRIMMED_FAULTS = {"crash_rate": 0.1, "restart_rate": 0.5,
                  "corrupt_rate": 0.1, "corrupt_mode": "scale",
                  "corrupt_scale": 2.0, "seed": 4}
TRIMMED_ITERS = 200


def phase_fig2_trimmed_mean(torch, K, prng, profile: bool = False):
    """Trimmed-mean aggregation (trim 1) on the Fig. 2 workload with Markov
    crash/restart and scale-corrupt faults (TRIMMED_FAULTS): 200 steps
    eager, then through a CUDA graph of 100 steps (a warm-up chunk and a
    replay); with ``profile`` one more replay traced by torch.profiler
    (the device's idle share a replayed step; its ~300,000 events take
    tens of seconds to collect).  Gates: the graph's state equal to the
    eager loop's bit for bit, with the same losses and fault counters; B3
    counted 100 on the warm-up and 100 on the replay from the capture
    (the trimmed mean is plain torch, as the reference's is jnp)."""
    from repro_torch.core.pdsgd import init_state, make_scanned_steps
    from repro_torch.faults import make_faults
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    step, zb, M, keys, err = _fig2_workload(
        torch, prng, dev, True, faults=make_faults(5, **TRIMMED_FAULTS),
        aggregation="trimmed_mean")
    _fig2_eager(torch, K, step, zb, M, keys, 3)  # warm-up
    state = init_state(torch.zeros(2), 5, device=dev)
    torch.cuda.synchronize()
    auxes = []
    t0 = time.perf_counter()
    for k in range(TRIMMED_ITERS):
        state, aux = step(state, (zb[k], M), keys[k])
        auxes.append(aux)
    torch.cuda.synchronize()
    us_eager = (time.perf_counter() - t0) / TRIMMED_ITERS * 1e6
    eager = {n: torch.stack([a[n] for a in auxes]) for n in auxes[0]}
    scanned = make_scanned_steps(step, FIG2_UNROLL)
    gstate = init_state(torch.zeros(2), 5, device=dev)
    Mk = M.expand(FIG2_UNROLL, *M.shape)
    K.reset_launch_counts()
    chunk_us, stacks = [], []
    for c in range(TRIMMED_ITERS // FIG2_UNROLL):
        sl = slice(c * FIG2_UNROLL, (c + 1) * FIG2_UNROLL)
        t0 = time.perf_counter()
        gstate, aux = scanned(gstate, (zb[sl], Mk), keys[sl])
        torch.cuda.synchronize()
        chunk_us.append((time.perf_counter() - t0) / FIG2_UNROLL * 1e6)
        stacks.append(aux)
    counts = dict(K.launch_counts)
    replayed = scanned.replayed_launches()
    check(same_bits(torch, gstate.flat, state.flat),
          "fig2_trimmed_mean: the graph's state differs from the eager "
          "loop's")
    for n, want in eager.items():
        check(same_bits(torch, torch.cat([a[n] for a in stacks]), want),
              f"fig2_trimmed_mean: {n} differs from the eager loop's")
    totals = {n: int(v.sum()) for n, v in eager.items()
              if n.startswith("fault_")}
    check(totals["fault_down"] > 0 and totals["fault_corrupt"] > 0,
          f"fig2_trimmed_mean fault totals {totals}")
    for what, c in (("warm-up", counts), ("replay", replayed)):
        check(c.get("obfuscate_update_krng", 0) == FIG2_UNROLL
              and c.get("gossip_update", 0) == 0
              and c.get("guarded_gossip_update", 0) == 0,
              f"fig2_trimmed_mean {what} launches {c}")
    trace = {"idle_share": "not measured (--profile)"}
    if profile:
        last = slice(TRIMMED_ITERS - FIG2_UNROLL, TRIMMED_ITERS)
        trace = _trace_replay(torch, lambda: scanned(
            gstate, (zb[last], Mk), keys[last]), FIG2_UNROLL)
    rec = {"phase": "fig2_trimmed_mean", "workload": "fig2_estimation d=2 "
           "m=5, paper_fig1, paper_experiment(0.05), aggregation="
           "trimmed_mean trim=1", "faults": TRIMMED_FAULTS,
           "iters": TRIMMED_ITERS, "unroll_k": FIG2_UNROLL,
           "us_per_step_eager": us_eager,
           "us_per_step_graph_first_chunk": chunk_us[0],
           "us_per_step_graph_replay": sum(chunk_us[1:]) / len(chunk_us[1:]),
           "final_err": err(gstate), "fault_totals": totals,
           "graph_equals_eager_bitwise": True,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches_warmup_counted": counts,
           "launches_replays_from_capture": replayed,
           "idle_share": trace.get("idle_share"), "traced_replay": trace}
    emit(rec)
    return rec


CKPT_EVERY = 4
CKPT_DIR = ROOT / "build" / "chip_checkpoints"
# the checkpointed model: the main path's width at depth 4 (a 4.61 GB
# archive, not depth 8's 7.15 GB), cut for the script's time limit; past
# the plain ZIP's 4 GiB, so its archives take the ZIP64 route as every
# full-size state's do (checked)
CKPT_LAYERS = 4
CKPT_WRITERS = (("sync", ("--checkpoint-sync",)),
                ("thread", ("--checkpoint-writer", "thread")),
                ("subprocess", ("--checkpoint-writer", "subprocess")))


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return -1


def _peak_rss() -> int:
    """This process's peak resident bytes on the host."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class _ChildPeaks:
    """Polls this process's children (the subprocess writer's commit
    child, multiprocessing's resource tracker) while a run goes on and
    keeps each one's peak resident bytes (shared memory it touched
    included) from /proc/<pid>/status: VmHWM, its high-water mark since
    its exec, where the kernel gives it, else the largest VmRSS seen by
    the polls (a sampled peak; the field is recorded).  RUSAGE_CHILDREN
    cannot tell them: an exec'd child's ru_maxrss starts from its
    parent's peak.  Children are the processes whose parent pid is this
    one's, and multiprocessing's live children."""

    def __init__(self, every_s: float = 0.2):
        import threading
        self.peaks: dict[int, dict] = {}
        self.polls = 0
        self._stop = threading.Event()
        self._every = every_s
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    @staticmethod
    def _children() -> set[str]:
        import multiprocessing as mp
        me = str(os.getpid())
        pids = {str(p.pid) for p in mp.active_children()}
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if stat[stat.rindex(")") + 2:].split()[1] == me:
                pids.add(pid)
        return pids

    def _poll(self) -> None:
        while True:
            for pid in self._children():
                try:
                    with open(f"/proc/{pid}/status") as f:
                        vm = dict(l.split(":", 1) for l in f
                                  if l.startswith(("VmHWM:", "VmRSS:")))
                    field = "VmHWM" if "VmHWM" in vm else "VmRSS"
                    peak = int(vm[field].split()[0]) * 1024
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        cmd = f.read().replace(b"\0", b" ").decode()[:120]
                except (OSError, ValueError, KeyError):
                    continue  # gone, or a kernel thread without either
                rec = self.peaks.setdefault(
                    int(pid), {"cmd": cmd, "field": field, "peak_rss": 0})
                rec["peak_rss"] = max(rec["peak_rss"], peak)
            self.polls += 1
            if self._stop.wait(self._every):
                return


def _archive_digests(step_dir: Path) -> dict:
    """sha256 of every entry of a step's arrays.npz (one leaf's npy
    header and words each), read as a stream, and of its tree.json."""
    import hashlib
    import zipfile
    out = {}
    with zipfile.ZipFile(step_dir / "arrays.npz") as zf:
        for name in zf.namelist():
            h = hashlib.sha256()
            with zf.open(name) as f:
                for block in iter(lambda: f.read(1 << 26), b""):
                    h.update(block)
            out[name] = h.hexdigest()
    out["tree.json"] = hashlib.sha256(
        (step_dir / "tree.json").read_bytes()).hexdigest()
    return out


def _is_zip64(path: Path) -> bool:
    """Whether an archive ends in a ZIP64 end-of-central-directory
    locator (the ZIP64 writer's route)."""
    with open(path, "rb") as f:
        f.seek(-(22 + 20), os.SEEK_END)
        return f.read(4) == b"PK\x06\x07"


def _step_dirs(d: Path) -> list[str]:
    return sorted(p.name for p in d.iterdir())


def _writer_record(res, step_dir: Path, wall, peak, children) -> dict:
    times = res["checkpoint"]
    return {"save_ms": [t * 1e3 for t in times["save_s"]],
            "commit_s": times["commit_s"],
            "archive_bytes": (step_dir / "arrays.npz").stat().st_size,
            "zip64": _is_zip64(step_dir / "arrays.npz"),
            "run_wall_s": wall, "max_memory_allocated": peak,
            "host_peak_rss": _peak_rss(),
            "children_peak_rss": list(children.peaks.values()),
            "children_polls": children.polls}


def phase_checkpoint_path(torch, K, train, cfg):
    """Checkpoints of the main path's configuration at CKPT_LAYERS
    (stablelm-3b, depth 4, m 4 on a ring, bf16, --unroll-k 4), one archive
    the whole 4.61 GB state (the ZIP64 route, checked): 12 steps
    uninterrupted (checkpointing off); 4 steps with
    --checkpoint-every 4 --keep-last 1 and the thread writer, then
    --steps 12 --resume: the load, a new graph's eager warm-up chunk
    (steps 4-7) and one replay (steps 8-11, its device step counter
    restarted from the loaded step); gates: the manifest holds [4] and no
    staging debris, resumed_from 4, the resumed state equal to the
    uninterrupted one bit for bit (the whole flat buffer, padding
    included) at step 12, the losses of steps 4-11 equal, B3 and B2
    counted once a step of the warm-up chunk and replayed once a step of
    the replay.  Then 4 steps (one chunk) under each writer
    (--checkpoint-sync, the thread and the subprocess writer), one commit
    each, at step 4; gate: the three writers' step-4 archives equal entry
    by entry (sha256 of each leaf's npy bytes), tree.json too.  Printed for each writer: the
    caller's ms a save, the writer's seconds a commit, bytes an archive,
    peak device memory, the host's peak RSS and each child's; the resumed
    run's ms a replayed step after the thread writer's save at step 8,
    beside checkpointing off; and the seconds to load a checkpoint.  At most two checkpoints are on disk at once; the
    phase fails if the disk has no room for three."""
    import shutil
    from repro_torch import checkpoint as ckpt
    steps, k = SCANNED_STEPS, SCANNED_UNROLL
    scanned = ("--unroll-k", str(k))
    every = ("--checkpoint-every", str(CKPT_EVERY), "--keep-last", "1")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    try:
        full, _, off_wall, off_peak = _run_path(torch, K, train, cfg, steps,
                                                True, scanned)
        ref_state = full["state"]
        layout = ref_state.layout
        archive_bytes = sum(
            math.prod((4,) + s) for s in layout.shapes) * 2 + 4
        free = shutil.disk_usage(CKPT_DIR).free
        machine = {"disk_free_bytes": free,
                   "mem_available_bytes": _mem_available(),
                   "archive_bytes_estimate": archive_bytes,
                   "checkpoint_dir": str(CKPT_DIR)}
        print(json.dumps({"checkpoint_machine": machine}), flush=True)
        check(free >= 3 * archive_bytes,
              f"checkpoint_path: {free} B free under {CKPT_DIR}, three "
              f"archives of the main path need {3 * archive_bytes} B")
        off = {"ms_per_step_replayed_3_7": _ms_per_step(full["history"], 3,
                                                        7),
               "run_wall_s": off_wall, "max_memory_allocated": off_peak}
        full_losses = {r["step"]: r["loss"] for r in full["history"]}
        del full
        # the thread writer: 4 steps, one save at 4, then the resume
        d = CKPT_DIR / "resume"
        _run_path(torch, K, train, cfg, CKPT_EVERY, True,
                  (*scanned, "--checkpoint-dir", str(d), *every), held=True)
        manifest = json.loads((d / "manifest.json").read_text())
        on_disk = _step_dirs(d)
        check(manifest["completed"] == [CKPT_EVERY],
              f"checkpoint_path manifest {manifest}")
        check(on_disk == ["manifest.json", ckpt.step_dirname(CKPT_EVERY)],
              f"checkpoint_path left {on_disk}")
        res, r_counts, r_wall, r_peak = _run_path(
            torch, K, train, cfg, steps, True,
            (*scanned, "--checkpoint-dir", str(d), *every, "--resume"),
            held=True)
        state = res["state"]
        check(res["resumed_from"] == CKPT_EVERY and state.step == steps,
              f"resumed_from {res['resumed_from']}, step {state.step}")
        same = same_bits(torch, state.flat, ref_state.flat)
        check(same, "checkpoint_path: the resumed state differs from the "
                    "uninterrupted run's")
        r_losses = {r["step"]: r["loss"] for r in res["history"]
                    if "step" in r}
        check(r_losses == {s: full_losses[s]
                           for s in range(CKPT_EVERY, steps)},
              f"checkpoint_path losses {r_losses} vs {full_losses}")
        # steps 4-7: the new graph's warm-up, counted; 8-11: one replay
        r_replayed = res["replayed_launches"]
        for what, c in (("counted", r_counts), ("replayed", r_replayed)):
            check(all(c.get(b, 0) == k for b in TRACE_NAMES),
                  f"checkpoint_path resumed {what} launches {c}")
        check(json.loads((d / "manifest.json").read_text())["completed"]
              == [steps], "checkpoint_path resumed run's manifest")
        resume = {"resumed_wall_s": r_wall, "max_memory_allocated": r_peak,
                  "commit_s": res["checkpoint"]["commit_s"],
                  # the replayed chunk (steps 8-11) after the save at 8
                  "ms_per_step_replayed_7_11": _ms_per_step(
                      res["history"], 7, steps - 1),
                  "state_equals_uninterrupted_bitwise": same}
        del res
        # the seconds to load the step-12 checkpoint into the state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.load_checkpoint(str(d), steps, like=state)
        torch.cuda.synchronize()
        resume["load_s"] = time.perf_counter() - t0
        check(same_bits(torch, state.flat, ref_state.flat),
              "checkpoint_path: a reload changed the state")
        del state
        shutil.rmtree(d)
        writers, digests = {}, {}
        # one chunk and one commit a writer, at step 4 (cut from 8 steps
        # and commits at 4 and 8 for the script's time limit; the resumed
        # run above measures a replayed chunk after a thread writer's
        # save)
        for name, flags in CKPT_WRITERS:
            gc.collect()
            wd = CKPT_DIR / name
            with _ChildPeaks() as children:
                res, _, wall, peak = _run_path(
                    torch, K, train, cfg, CKPT_EVERY, True,
                    (*scanned, "--checkpoint-dir", str(wd), *every,
                     *flags), held=True)
            step_dir = wd / ckpt.step_dirname(CKPT_EVERY)
            writers[name] = _writer_record(res, step_dir, wall, peak,
                                           children)
            del res
            digests[name] = _archive_digests(step_dir)
            shutil.rmtree(wd)
        check(all(w["zip64"] for w in writers.values()),
              f"checkpoint_path: an archive of {archive_bytes} B did not "
              f"take the ZIP64 route")
        equal = all(v == digests["thread"] for v in digests.values())
        check(equal, "checkpoint_path: the writers' step-4 archives differ")
        check(all(len(v) == layout.n_leaves + 2 for v in digests.values()),
              "checkpoint_path archive entries")
        rec = {"phase": "checkpoint_path", "arch": cfg.name,
               "num_layers": cfg.num_layers, "dtype": cfg.dtype,
               "agents": 4, "topology": "ring", "per_agent_batch": 2,
               "seq_len": 512, "unroll_k": k,
               "checkpoint_every": CKPT_EVERY, "machine": machine,
               "off": off, "writers": writers, "resume": resume,
               "archives_equal_leaf_by_leaf": equal,
               "launches_resumed_counted": r_counts,
               "launches_resumed_replayed": r_replayed}
        emit(rec)
        return rec
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


ROLLBACK_FLAGS = ("--fault-corrupt-rate", "0.25", "--fault-corrupt-mode",
                  "nan", "--fault-guard-clip", "0", "--nan-policy", "warn",
                  "--checkpoint-every", "2", "--rollback-patience", "2",
                  "--max-rollbacks", "2", "--rollback-backoff", "0")
ROLLBACK_STEPS = 8


def rollback_seed(train, steps: int) -> int:
    """The first fault seed whose first corrupt sender comes at step 3 or
    later, so step 2 is a durable, finite checkpoint."""
    for seed in range(100):
        faults = train.build_faults(_path_args(
            train, steps, (*ROLLBACK_FLAGS, "--fault-seed", str(seed))))
        first = next((s for s in range(steps)
                      if bool(faults.realize(s)[1].any())), None)
        if first is not None and 3 <= first <= 5:
            return seed
    raise AssertionError("no fault seed below 100 fits the rollback path")


def _rollback_run(train, cfg, argv_extra, device, d: Path):
    """run_training, which must fail with the exhaustion RuntimeError;
    returns its rollback records and the error's text."""
    import contextlib
    import io as _io
    import shutil
    shutil.rmtree(d, ignore_errors=True)
    args = _path_args(train, ROLLBACK_STEPS,
                      (*argv_extra, "--checkpoint-dir", str(d)), seq_len=32)
    args.device = device
    out = _io.StringIO()
    err = None
    try:
        with contextlib.redirect_stdout(out):
            train.run_training(args, cfg=cfg)
    except RuntimeError as e:
        err = str(e)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{") and '"rollback"' in ln]
    return recs, err


def phase_rollback_path(torch, K, train, cfg):
    """stablelm-3b-smoke in f32 on the card with nan-corrupt senders, the
    guard off, --nan-policy warn, --checkpoint-every 2,
    --rollback-patience 2, --max-rollbacks 2, --rollback-backoff 0 (B3 +
    B6 every step).  Gates: the run fails with the exhaustion error after
    two rollbacks, and its rollback records and error equal a CPU run's
    of the port."""
    seed = rollback_seed(train, ROLLBACK_STEPS)
    extra = (*ROLLBACK_FLAGS, "--fault-seed", str(seed))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    recs, err = _rollback_run(train, cfg, extra, "cuda",
                              CKPT_DIR / "rollback_cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    cpu_recs, cpu_err = _rollback_run(train, cfg, extra, "cpu",
                                      CKPT_DIR / "rollback_cpu")
    check(err is not None and "stayed non-finite through 2 rollback(s)"
          in err, f"rollback_path error {err!r}")
    check([r["rollback"] for r in recs] == [1, 2],
          f"rollback_path records {recs}")
    check((recs, err) == (cpu_recs, cpu_err),
          f"rollback_path: card {recs} {err!r}, CPU {cpu_recs} {cpu_err!r}")
    check(counts.get("obfuscate_update_krng", 0) > 0
          and counts.get("guarded_gossip_update", 0) > 0,
          f"rollback_path launches {counts}")
    rec = {"phase": "rollback_path", "arch": cfg.name, "dtype": cfg.dtype,
           "agents": 4, "seq_len": 32, "steps": ROLLBACK_STEPS,
           "flags": list(extra), "records": recs, "error": err,
           "records_equal_cpu": True, "run_wall_s": wall,
           "launches": counts}
    emit(rec)
    return rec


# theta of Theorem 5 at kappa = 5 (Remark 5), the estimators' target
THETA_REMARK5 = 1.0322
THETA_TOL = 0.02
AUDIT_RUNS = (("static", ()), ("dropout", ("--topology-dropout", "0.3")))


def phase_privacy_audit(torch, K):
    """`launch/audit.main` on the card at the reference's defaults (m 5,
    dim 3, 8 parity steps, 40 attack steps, 200,000 samples) through B3 +
    B2, then with --topology-dropout 0.3 (the scanned path under a
    time-varying graph: B4 in the CUDA graph).  First the oracle's mix
    (`core.pdsgd.oracle_mix`, which the eager and ring paths use) against
    B2, bitwise, at m = 4, 5, 32.  Gates: capture-on == capture-off
    bitwise on every path; the four paths' streams bitwise (every
    deviation 0) and the report ``ok``; theta (kNN and binned) within 0.02
    of 1.0322; dsgd_recovery_rel_err < 1e-6; the PDSGD inversion's MSE at
    or above the Theorem-5 bound; the theorem5 section equal to a CPU
    run's on the same config.  The attack numbers printed beside the CPU
    run's, and the report's capture overhead."""
    from repro_torch.core.pdsgd import oracle_mix
    from repro_torch.launch import audit as AU
    # the oracle's mix on the card is B2's FMA chain: bitwise B2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for m in (4, 5, 32):
        W, B = (torch.rand((m, m), device="cuda", generator=gen)
                for _ in range(2))
        X, U = (torch.randn((m, 1 << 18), device="cuda", generator=gen)
                for _ in range(2))
        check(same_bits(torch, K.gossip_update(W, B, X, U),
                        oracle_mix(W, X) - oracle_mix(B, U)),
              f"privacy_audit: the oracle's mix differs from B2 at m={m}")
    out = {}
    for name, extra in AUDIT_RUNS:
        path = RECORDS.parent / f"privacy_report_{name}.json"
        argv = ["--device", "cuda", "--out", str(path), *extra]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc = AU.main(argv)
        wall = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        rep = json.loads(path.read_text())
        cfg = AU.config_from_args(AU.build_parser().parse_args(argv))
        par = rep["parity"]
        check(all(par["trajectory_bitwise"].values()),
              f"privacy_audit {name}: capture changed a trajectory "
              f"{par['trajectory_bitwise']}")
        worst = max(v for dev in par["max_abs_deviation"].values()
                    for v in dev.values())
        check(all(par["observations_bitwise"].values()) and worst == 0.0,
              f"privacy_audit {name}: the paths' streams differ, "
              f"max deviation {worst}")
        check(rc == 0 and rep["ok"], f"privacy_audit {name}: report not ok")
        t5 = rep["theorem5"]
        for est in ("theta_knn", "theta_binned"):
            check(abs(t5[est] - THETA_REMARK5) <= THETA_TOL,
                  f"privacy_audit {name}: {est} {t5[est]}")
        cpu_t5 = json.loads(json.dumps(AU.theorem5_report(cfg)))
        check(t5 == cpu_t5, f"privacy_audit {name}: theorem5 differs "
                            f"from the CPU run's")
        att = rep["attacks"]
        check(att["dsgd_recovery_rel_err"] < 1e-6,
              f"privacy_audit {name}: dsgd {att['dsgd_recovery_rel_err']}")
        check(att["pdsgd_ls_recovery_mse"] >= att["theorem5_mse_bound"],
              f"privacy_audit {name}: PDSGD under the Theorem-5 bound")
        cpu_att = AU.attack_report(cfg, device="cpu")
        check(counts.get("obfuscate_update_krng", 0) > 0
              and counts.get("masked_gossip_update" if extra
                             else "gossip_update", 0) > 0,
              f"privacy_audit {name} launches {counts}")
        rec = {"phase": "privacy_audit", "mode": name, "argv": argv,
               "ok": rep["ok"], "wall_s": wall,
               "trajectory_bitwise": par["trajectory_bitwise"],
               "observations_bitwise": par["observations_bitwise"],
               "max_abs_deviation": par["max_abs_deviation"],
               "theta_knn": t5["theta_knn"],
               "theta_binned": t5["theta_binned"],
               "theorem5_equals_cpu": True,
               "attacks": {k: att[k] for k in (
                   "dsgd_recovery_rel_err", "pdsgd_ls_recovery_mse",
                   "theorem5_mse_bound", "pdsgd_mse_over_bound",
                   "recovery_gap", "kappa")},
               "attacks_cpu": {k: cpu_att[k] for k in (
                   "dsgd_recovery_rel_err", "pdsgd_ls_recovery_mse",
                   "theorem5_mse_bound", "pdsgd_mse_over_bound",
                   "recovery_gap", "kappa")},
               "overhead": rep["overhead"], "launches": counts,
               "memory_allocated_after": torch.cuda.memory_allocated()}
        emit(rec)
        out[name] = rec
    return out


def _step_fn(torch, train, cfg, args, observer):
    """The trainer's step (`run_training`'s configuration) with an
    observer, and its batch 0 on the card."""
    from repro_torch.core.pdsgd import make_decentralized_step
    from repro_torch.core.schedules import warmup_harmonic
    from repro_torch.models import build_model
    bundle = build_model(cfg)
    kernel_layout = "concat" if args.kernel_layout == "auto" \
        else args.kernel_layout
    return make_decentralized_step(
        bundle.loss_fn, train.build_mixing(args),
        warmup_harmonic(args.lr, hold=args.warmup_hold),
        kernel_layout=kernel_layout, observer=observer), bundle


# steps timed per capture configuration (each from the same x^0)
CAPTURE_REPS = 2


def phase_privacy_capture_path(torch, K, train, prng, cfg):
    """stablelm-3b at full width, depth 2, m 4 on a ring, bf16: one step
    from the same state with capture off, with ``auditor()`` and with
    ``external_eavesdropper()`` through the concat layout (B3 + B2), then
    capture off and the eavesdropper through the ring layout (B9).  V is
    (4, 4, D) f32.  Gates: the parameters equal capture-off bit for bit;
    V's diagonal exactly zero; concat V equal to w x - b u formed from the
    auditor record's x and the kernel's own u; ring V equal to concat V
    within the bf16 rounding of u (B9 keeps u in f32, B3 writes it in
    bf16): |dV| <= 2^-8 |b_ij u_j| + 2^-22 (|w_ij x_j| + |b_ij u_j|) (2^-8
    is bf16's half ulp, relative)."""
    from repro_torch.core.pdsgd import DecentralizedState, init_state
    from repro_torch.data import make_lm_pipeline
    from repro_torch.privacy import observe as O
    dev = torch.device("cuda")
    args = _path_args(train, 1)
    gc.collect()
    torch.cuda.synchronize()
    step_off, bundle = _step_fn(torch, train, cfg, args, None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state0 = init_state(bundle.init(gen, dev), 4, device=dev)
    X0 = state0.flat.clone()
    layout = state0.layout
    D, m = layout.size, 4
    pipe = make_lm_pipeline(cfg.vocab_size, args.agents,
                            args.per_agent_batch, args.seq_len,
                            seed=args.seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    key = prng.fold_in(prng.key(1), 0)

    def run(step, label):
        """CAPTURE_REPS steps from x^0, one at a time (the last one's
        record kept): host ms each, ending in a sync, their median and
        minimum; the peak over them; the last step's launches."""
        times, peak, obs = [], 0, None
        for _ in range(CAPTURE_REPS):
            obs = None  # the previous record's V goes before the next
            state0.flat.copy_(X0)
            st = DecentralizedState(flat=state0.flat, layout=layout)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            st, aux = step(st, batch, key)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated())
            obs = aux.get("observation")
            del aux
        return st.flat, obs, {
            "ms": statistics.median(times), "ms_min": min(times),
            "ms_all": times, "peak": peak,
            "launches": dict(K.launch_counts), "label": label}

    runs = []
    run(step_off, "warm-up")
    out, _, r = run(step_off, "concat_off")
    X_off = out.clone()
    runs.append(r)
    # the auditor: V from x^k and B3's own u
    step_aud, _ = _step_fn(torch, train, cfg, args, O.auditor())
    out, rec, r = run(step_aud, "concat_auditor")
    runs.append(r)
    check(same_bits(torch, out, X_off), "auditor capture changed x'")
    check(rec["v"].shape == (m, m, D) and rec["v"].dtype == torch.float32,
          "record shape")
    check(torch.equal(rec["x"], X0[:, :D].float()), "record x is not x^k")
    W, B = rec["W"], rec["B"]
    formed = True
    for s, e in _chunks(D, 1 << 22):
        want = (W[:, :, None] * rec["x"][None, :, s:e]
                - B[:, :, None] * rec["u"][None, :, s:e]) \
            * (1.0 - torch.eye(m, device=dev))[:, :, None]
        formed &= bool(torch.equal(rec["v"][:, :, s:e], want))
    check(formed, "concat V is not w x - b u of the kernel's own u")
    check(all(bool((rec["v"][i, i] == 0).all()) for i in range(m)),
          "V's diagonal is not zero")
    u_concat = rec["u"].to(X0.dtype)
    check(torch.equal(u_concat.float(), rec["u"]),
          "u is not B3's own u (in the parameters' dtype)")
    half_ulp = torch.finfo(X0.dtype).eps / 2
    del rec, out
    gc.collect()
    torch.cuda.empty_cache()
    # the external eavesdropper: V and the support only
    step_eav, _ = _step_fn(torch, train, cfg, args,
                           O.external_eavesdropper())
    out, rec, r = run(step_eav, "concat_eavesdropper")
    runs.append(r)
    check(same_bits(torch, out, X_off), "eavesdropper capture changed x'")
    check(set(rec) == {"v", "support"}, f"eavesdropper view {set(rec)}")
    check(all(bool((rec["v"][i, i] == 0).all()) for i in range(m)),
          "V's diagonal is not zero")
    V_host = rec["v"].cpu()
    del rec, out, X_off
    gc.collect()
    torch.cuda.empty_cache()
    # the ring layout, B9 once: its own staged messages scattered to V
    ring_args = _path_args(train, 1, RING_FLAGS)
    ring_off, _ = _step_fn(torch, train, cfg, ring_args, None)
    out, _, r = run(ring_off, "ring_off")
    runs.append(r)
    X_ring_off = out.clone()
    ring_eav, _ = _step_fn(torch, train, cfg, ring_args,
                           O.external_eavesdropper())
    out, rec, r = run(ring_eav, "ring_eavesdropper")
    runs.append(r)
    check(same_bits(torch, out, X_ring_off), "ring capture changed x'")
    check(r["launches"].get("ring_obfuscate_gossip_krng", 0) == 1,
          f"ring launches {r['launches']}")
    Vr = rec["v"]
    worst, bitwise = 0.0, True
    x0 = X0[:, :D]
    for i in range(m):
        for j in range(m):
            vc = V_host[i, j].to(dev)
            d = (Vr[i, j] - vc).abs()
            bitwise &= bool(torch.equal(Vr[i, j], vc))
            wx = (W[i, j] * x0[j].float()).abs()
            bu = (B[i, j] * u_concat[j].float()).abs()
            tol = bu * half_ulp + (wx + bu) * 2.0 ** -22
            check(bool((d <= tol).all()), f"ring V[{i}, {j}] off concat V")
            worst = max(worst, float(d.max()))
            del vc, d, wx, bu, tol
    v_bytes = m * m * D * 4
    emit({"phase": "privacy_capture_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "dtype": cfg.dtype, "agents": m,
          "topology": "ring", "params_per_agent": D,
          "v_shape": [m, m, D], "v_bytes": v_bytes,
          "v_bytes_bound_ms": v_bytes / HBM_BYTES_PER_S * 1e3,
          "steps": runs, "params_equal_capture_off": True,
          "v_diagonal_zero": True, "concat_v_is_wx_minus_bu": formed,
          "ring_v_equals_concat_bitwise": bitwise,
          "ring_v_max_abs_diff": worst,
          "ms_capture_on_minus_off": {
              "concat_auditor": runs[1]["ms"] - runs[0]["ms"],
              "concat_eavesdropper": runs[2]["ms"] - runs[0]["ms"],
              "ring_eavesdropper": runs[4]["ms"] - runs[3]["ms"]},
          "capture_reps": CAPTURE_REPS})
    del Vr, rec, out, V_host, X0, X_ring_off, u_concat, state0
    gc.collect()
    torch.cuda.empty_cache()


# dsgd last but one: its state is held for the comparison with the graph
BASELINE_RUNS = (
    ("dsgt", ("--algorithm", "dsgt"), BASELINE_STEPS),
    # 2 steps (a warm-up and a timed one) for the script's time limit:
    # DP-DSGD's normals take ~6 s a step in int64 torch ops
    ("dp_dsgd", ("--algorithm", "dp_dsgd", "--sigma-dp", "0.01"), 2),
    ("pdsgd_clip", ("--grad-clip-kappa", "1.0"), 2),
    ("dsgd", ("--algorithm", "dsgd"), 2 * BASELINE_STEPS),
    ("dsgd_unroll3", ("--algorithm", "dsgd", "--unroll-k", "3"),
     2 * BASELINE_STEPS),
)


def phase_baselines_path(torch, K, train, cfg):
    """The paper's baselines on the main path's configuration, eager: DSGT
    (its tracker pair two more (m, width) buffers), DP-DSGD (sigma 0.01;
    its normal draws are int64 threefry in torch ops), PDSGD with
    --grad-clip-kappa 1.0, DSGD (6 steps, the reference for the graph
    below), then DSGD through --unroll-k 3 (a warm-up chunk and a replay;
    its peak taken above the held DSGD state) against the eager DSGD run
    bit for bit.  Gates: finite losses; no B-kernel for the baselines
    (counted or replayed), B3 + B2 once a step with the clip; DSGT's peak
    at least 0.9 x two buffers above DSGD's.  Then the plain updates alone
    at this shape (`_baseline_updates`)."""
    out, states = {}, {}
    b_kernels = tuple(SOURCES)
    for name, extra, steps in BASELINE_RUNS:
        res, counts, wall, peak = _run_path(torch, K, train, cfg, steps,
                                            True, extra,
                                            held=name == "dsgd_unroll3")
        hist = res["history"]
        losses = [r["loss"] for r in hist]
        check(all(math.isfinite(l) for l in losses),
              f"baselines_path {name} losses {losses}")
        check(res["state"].step == steps, f"baselines_path {name} steps")
        if name == "pdsgd_clip":
            check(counts.get("obfuscate_update_krng", 0) == steps
                  and counts.get("gossip_update", 0) == steps,
                  f"baselines_path {name} launches {counts}")
        else:
            replayed = res["replayed_launches"]
            check(not any(counts.get(b, 0) or replayed.get(b, 0)
                          for b in b_kernels),
                  f"baselines_path {name} launched {counts}, {replayed}")
        first = 2 if name == "dsgd_unroll3" else 0
        rec = {"steps": steps, "losses": losses,
               "ms_per_step": _ms_per_step(hist, first),
               "run_wall_s": wall, "max_memory_allocated": peak,
               "launches": counts}
        if name in ("dsgd", "dsgd_unroll3"):
            states[name] = res["state"]
        else:
            del res
        out[name] = rec
    same = same_bits(torch, states["dsgd"].flat, states["dsgd_unroll3"].flat)
    check(same, "baselines_path: dsgd --unroll-k 3 differs from eager dsgd")
    X = states["dsgd"].flat
    two = 2 * X.numel() * X.element_size()
    extra_b = out["dsgt"]["max_memory_allocated"] - \
        out["dsgd"]["max_memory_allocated"]
    check(extra_b >= 0.9 * two,
          f"dsgt's peak carries {extra_b} B more than dsgd's, tracker "
          f"pair {two} B")
    shape, dtype = tuple(X.shape), X.dtype
    del states, X
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "baselines_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "dtype": cfg.dtype, "agents": 4,
          "topology": "ring", "per_agent_batch": 2, "seq_len": 512,
          "runs": out, "dsgt_extra_peak_bytes": extra_b,
          "tracker_pair_bytes": two,
          "dsgd_unroll3_equals_eager_bitwise": same,
          "updates": _baseline_updates(torch, shape, dtype)})


def _baseline_updates(torch, shape, dtype) -> dict:
    """Device ms of the plain baseline updates on (m, width) buffers of the
    main path (CUDA events, 3 calls after one warm-up, each its own
    record): `dsgd_update` in place (bound: read X and G, write X) and the
    step's DSGT `_dsgt_step_` (read X, Y, g^{k-1}, G, write X, Y,
    g^{k-1}), beside their bytes bounds."""
    from repro_torch.core.pdsgd import _dsgt_step_, dsgd_update
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    bufs = [torch.empty(shape, dtype=dtype, device=dev) for _ in range(4)]
    for b in bufs:
        b.normal_(generator=g)
    X, Y, Gp, G = bufs
    W = torch.full((shape[0], shape[0]), 1.0 / shape[0], device=dev)
    lam = torch.full((), 0.01, device=dev)
    one = X.numel() * X.element_size()
    out = {}
    for name, fn, passes in (
            ("dsgd_update", lambda: dsgd_update(X, G, W=W, lam=lam, out=X),
             3),
            ("dsgt_step", lambda: _dsgt_step_(X, Y, Gp, G, W=W, lam=lam),
             7)):
        fn()
        ms = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        check(all(math.isfinite(v) for v in ms), f"{name} timing")
        out[name] = {"ms": ms, "bound_ms": bound_ms(passes * one)[0],
                     "bound_by": "bytes"}
    check(_finite_flat(torch, X), "baseline updates left non-finite X")
    del bufs, X, Y, Gp, G
    return out


def phase_profile_scanned(torch, train, cfg, path: str = "main_path_scanned",
                          extra=(), trace_names=None):
    """Device busy and idle within the replayed chunks of a scanned path
    (``extra``: its flags; --unroll-k 4, 12 steps: kernels that start
    after the second chunk's range opened), from a torch.profiler trace;
    ``trace_names`` (default B3's and B2's) the kernels counted once a
    replayed step in it; written to chiprun_out/profile_<path>.json."""
    from torch.profiler import ProfilerActivity, profile
    trace_names = TRACE_NAMES if trace_names is None else trace_names
    args = _path_args(train, SCANNED_STEPS,
                      (*extra, "--unroll-k", str(SCANNED_UNROLL)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train.run_training(args, cfg=cfg)
    torch.cuda.synchronize()
    events = prof.events()
    lo = min(e.time_range.start for e in events
             if e.name == f"train_chunk_{SCANNED_UNROLL}")
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.start >= lo
               and not e.name.startswith("train_chunk_")]
    hi = max(e.time_range.end for e in kernels) if kernels else lo
    busy = sum((e.time_range.end - e.time_range.start) / 1e3
               for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    n = SCANNED_STEPS - SCANNED_UNROLL
    # the path's kernels in the replays: launches no wrapper counts
    traced = {b: sum(1 for e in kernels if sub in e.name)
              for b, sub in trace_names.items()}
    check(traced == {b: n for b in trace_names},
          f"{path} traced replays {traced}")
    window = (hi - lo) / 1e3
    top = [{"kernel": k[:120], "ms_per_step": v / n}
           for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{path}.json").write_text(json.dumps(
        {"steps": n, "window_ms": window, "busy_ms": busy,
         "kernel_events": len(kernels), "kernels": top}, indent=1))
    emit({"phase": "profile", "path": path,
          "steps_profiled": n, "kernel_events": len(kernels),
          "b_kernels_traced": traced,
          "step_ms": window / n, "device_busy_ms_per_step": busy / n,
          "idle_share": (1.0 - busy / window) if window > 0 else None,
          "top": top[:12]})


def phase_profile(torch, train, cfg, path: str = "main_path", extra=(),
                  steps: int = 4, seq_len: int = 512):
    """Device time by kernel over steps 1..steps-1 (step 0 warms up) of a
    path (``extra``: its flags), from a torch.profiler trace of
    run_training; each step is the range ``train_step_<k>``.  Writes the
    full table to chiprun_out/profile_<path>.json."""
    from torch.profiler import ProfilerActivity, profile
    args = _path_args(train, steps, extra, seq_len)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train.run_training(args, cfg=cfg)
    torch.cuda.synchronize()
    events = prof.events()
    # the GPU finishes each step before the next starts (the loop reads the
    # loss), so every kernel that starts after step 1's range opened
    # belongs to steps 1..steps-1
    lo = min(e.time_range.start for e in events
             if e.name == "train_step_1")
    # (the step's named ranges also appear on the device timeline; they
    # are not kernels)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.start >= lo
               and e.name not in STEP_RANGES
               and not e.name.startswith("train_step_")]
    hi = max(e.time_range.end for e in kernels)
    by_name: dict[str, float] = {}
    busy = 0.0
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3  # us -> ms
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        busy += dur
    n = steps - 1
    window_ms = (hi - lo) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    table = [{"kernel": k[:120], "ms_per_step": v / n,
              "share_of_device": v / busy} for k, v in top]
    # host side: the step's named ranges, and CPU ops by self time
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.time_range.start >= lo]
    ranges: dict[str, float] = {}
    self_ms: dict[str, float] = {}
    for e in host:
        if e.name in STEP_RANGES or e.name.startswith("train_step_"):
            key = "train_step" if e.name.startswith("train_step_") \
                else e.name
            ranges[key] = ranges.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / n
        self_ms[e.name] = self_ms.get(e.name, 0.0) + \
            e.self_cpu_time_total / 1e3 / n
    host_top = [{"op": k[:80], "self_ms_per_step": v} for k, v in
                sorted(self_ms.items(), key=lambda kv: -kv[1])[:15]]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{path}.json").write_text(json.dumps(
        {"steps": n, "window_ms": window_ms, "busy_ms": busy,
         "kernels": table, "host_ranges_ms_per_step": ranges,
         "host_ops": host_top}, indent=1))
    emit({"phase": "profile", "path": path, "steps_profiled": n,
          "step_ms": window_ms / n, "device_busy_ms_per_step": busy / n,
          "idle_share": 1.0 - busy / window_ms,
          "host_ranges_ms_per_step": ranges, "host_top": host_top[:8],
          "top": table[:12]})


SERVE_RANGES = ("serve_prefill", "serve_chunk")


def phase_profile_serve(torch, serve, requests: int = 8, gen: int = 24,
                        path_args=None, path: str = "serve_path", cfg=None):
    """Device time by kernel in a serve path's steady prefills and decode
    chunks (``path_args``, default SERVE_PATH_ARGS, with ``requests``
    requests, where the path takes a count, of ``gen`` tokens, no parity
    check; ``cfg``: a depth-cut config in place of ``--arch``'s), from a
    torch.profiler trace of run_serving: the engine (and the oneshot
    path) names each prefill ``serve_prefill`` and each chunk
    ``serve_chunk``; the first of each (the warm-up's) is left out.  Both
    end in a device sync, so the kernels that start inside a range are its
    own.  Writes chiprun_out/profile_<path>.json."""
    from torch.profiler import ProfilerActivity, profile
    argv = [a for a in (path_args or SERVE_PATH_ARGS)
            if a != "--parity-check"]
    if "--requests" in argv:
        argv[argv.index("--requests") + 1] = str(requests)
    argv[argv.index("--gen-tokens") + 1] = str(gen)
    args = serve.build_parser().parse_args(argv)
    gc.collect()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve.run_serving(args, cfg=cfg)
    torch.cuda.synchronize()
    events = prof.events()
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.name not in SERVE_RANGES),
                     key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in kernels]
    out, table = {}, {}
    for name in SERVE_RANGES:
        ranges = sorted((e.time_range.start, e.time_range.end)
                        for e in events if e.name == name
                        and e.device_type == torch.autograd.DeviceType.CPU)
        ranges = ranges[1:]
        window = busy = 0.0
        by_name: dict[str, float] = {}
        for lo, hi in ranges:
            window += (hi - lo) / 1e3
            i = bisect.bisect_left(starts, lo)
            while i < len(kernels) and starts[i] <= hi:
                e = kernels[i]
                dur = (e.time_range.end - e.time_range.start) / 1e3
                by_name[e.name] = by_name.get(e.name, 0.0) + dur
                busy += dur
                i += 1
        n = max(len(ranges), 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        table[name] = [{"kernel": k[:120], "ms_each": v / n,
                        "share_of_device": v / max(busy, 1e-9)}
                       for k, v in top]
        out[name] = {"count": len(ranges), "ms_each": window / n,
                     "device_busy_ms_each": busy / n,
                     "idle_share": 1.0 - busy / max(window, 1e-9),
                     "top": table[name][:10]}
    path_dir = ROOT / "chiprun_out"
    path_dir.mkdir(exist_ok=True)
    (path_dir / f"profile_{path}.json").write_text(json.dumps(
        {"args": argv, "ranges": out, "kernels": table}, indent=1))
    emit({"phase": "profile", "path": path, "args": argv, **out})


# the stablelm, xLSTM and hybrid serve paths keep more requests than
# slots, so admission refills slots of a live slab.  For the script's time
# limit (1331 s with every cell at its earlier size, 1054 s after a first
# round of cuts, on one H100 80GB HBM3 at 700 W) stablelm-3b is served at
# full width, depth 32 -> 8, then 4, and 16 -> 9 requests; its
# oracle decodes every request's 64 tokens at M = 8
SERVE_LAYERS = 4
SERVE_PATH_ARGS = ("--arch", "stablelm-3b", "--slots", "8", "--requests",
                   "9", "--prompt-len", "2000", "--gen-tokens", "64",
                   "--decode-chunk", "8", "--parity-check")
# xlstm-125m at full width: prompts of 500 (no multiple of 64, so the dt
# = 0 padding runs), cut from stablelm's 2000 for the sLSTM's host loop
# (a few ops a token and block); 9 requests on 8 slots; cut for the
# script's time limit to 6 blocks (12), then 4, and 9 requests (16)
XLSTM_SERVE_LAYERS = 4
XLSTM_SERVE_ARGS = ("--arch", "xlstm-125m", "--slots", "8", "--requests",
                    "9", "--prompt-len", "500", "--gen-tokens", "32",
                    "--decode-chunk", "8", "--parity-check")
# xlstm-125m training: sequence 128, cut from the reference's train shapes
# for the sLSTM's host loop (forward and backward, per token and agent)
XLSTM_TRAIN_SEQ = 128


def _serve_parity(torch, serve, arch: str, kernels: tuple, cfg=None):
    """``arch`` (or ``cfg``, a variant of it) in f32, 4 requests on 2 slots,
    greedy, through run_serving on the card (kernels) and on the CPU
    (plain versions), same weights: equal token streams, both
    --parity-check ok, a VLM's prefix embeds drawn on each device within 3
    ulp of each other (f32 draws differ by up to 2 ulp in about 2e-5 of
    them), and every request's prefill logits on the CPU's request within
    atol = rtol = 1e-4.  Returns (config, card streams, max logit error, the card
    run's launches of each of ``kernels``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serve import request_batch
    cfg = cfg if cfg is not None else get_config(arch)
    gen = torch.Generator()
    gen.manual_seed(7)
    bundle = build_model(cfg)
    p0 = bundle.init(gen, "cpu")
    flags = ["--arch", cfg.name, "--slots", "2", "--requests", "4",
             "--prompt-len", "37", "--gen-tokens", "12", "--decode-chunk",
             "4", "--parity-check"]
    reset_launch_counts()
    gpu = serve.run_serving(serve.build_parser().parse_args(
        flags + ["--device", "cuda"]), init_params=p0, cfg=cfg)
    torch.cuda.synchronize()
    launches = {k: launch_counts[k] for k in kernels}
    cpu = serve.run_serving(serve.build_parser().parse_args(
        flags + ["--device", "cpu"]), init_params=p0, cfg=cfg)
    streams = [{c.req_id: c.tokens for c in run["completions"]}
               for run in (gpu, cpu)]
    check(streams[0] == streams[1], f"{arch} serve parity streams {streams}")
    check(gpu["result"]["parity"] == "ok" and cpu["result"]["parity"] == "ok",
          f"{arch} serve parity --parity-check")
    max_err = 0.0
    with torch.no_grad():
        for r, rc in zip(gpu["requests"], cpu["requests"]):
            if r.prefix_embeds is not None:
                ulps = max_ulps(torch, r.prefix_embeds.cpu(),
                                rc.prefix_embeds)
                check(ulps <= 3, f"{arch}: the prefix embeds drawn on the "
                                 f"card are {ulps} ulp from the CPU's")
            # both devices prefill the CPU's request
            a = gpu["bundle"].prefill_fn(gpu["params"], request_batch(
                rc, "cuda", bundle.dtype))
            b = cpu["bundle"].prefill_fn(cpu["params"], request_batch(
                rc, "cpu", bundle.dtype))
            a, b = a["logits"].cpu(), b["logits"]
            max_err = max(max_err, float((a - b).abs().max()))
            check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
                  f"{arch} serve parity prefill logits of request {r.req_id}")
    return cfg, streams[0], max_err, launches


def phase_serve_parity(torch, serve):
    """stablelm-3b-smoke in f32 (`_serve_parity`): prefill attention through
    B10 on the card, the naive attention on the CPU; the logits tolerance
    is the f32 conditioning of the smoke model's sharp attention
    (tests/test_torch_serve.py)."""
    cfg, tokens, max_err, counts = _serve_parity(torch, serve,
                                                 "stablelm-3b-smoke",
                                                 ("flash_attention",))
    b10 = counts["flash_attention"]
    # prefills: warm-up + 4 requests + 4 sequential, 2 layers each
    check(b10 == cfg.num_layers * 9, f"serve_parity B10 launches {b10}")
    emit({"phase": "serve_parity", "arch": cfg.name, "dtype": "float32",
          "slots": 2, "requests": 4, "tokens_gpu": tokens,
          "streams_equal": True, "prefill_logits_max_abs_err": max_err,
          "flash_attention_launches_gpu": b10,
          "tolerance": "tokens equal; prefill logits atol = rtol = 1e-4"})


def phase_xlstm_serve_parity(torch, serve):
    """xlstm-125m-smoke in f32 (`_serve_parity`): the mLSTM's SSD through
    B11 on the card (prefill and every decode step), its plain version on
    the CPU."""
    cfg, tokens, max_err, counts = _serve_parity(torch, serve,
                                                 "xlstm-125m-smoke",
                                                 ("ssd_intra_chunk",))
    b11 = counts["ssd_intra_chunk"]
    # at least the 9 prefills' two calls in the one mLSTM block
    check(b11 >= 2 * 9, f"xlstm_serve_parity B11 launches {b11}")
    emit({"phase": "xlstm_serve_parity", "arch": cfg.name,
          "dtype": "float32", "slots": 2, "requests": 4,
          "tokens_gpu": tokens, "streams_equal": True,
          "prefill_logits_max_abs_err": max_err,
          "ssd_intra_chunk_launches_gpu": b11,
          "tolerance": "tokens equal; prefill logits atol = rtol = 1e-4"})


def decode_logit_spread(torch, ctx, args, steps: int = 8):
    """(max, per step) of the max |logit difference| between a batched
    decode step (all slots at once, as the engine decodes) and the same
    rows decoded one at a time (B = 1, as the sequential reference
    decodes), over ``steps`` greedy steps of the path's first ``slots``
    prompts, both fed the B = 1 stream's tokens."""
    from repro_torch.launch.serve import _total_len
    from repro_torch.serve import make_layout, request_batch, write_slot
    bundle, params = ctx["bundle"], ctx["params"]
    dev = params["embed"].device
    reqs = ctx["requests"][:args.slots]
    V = bundle.cfg.vocab_size
    cap = _total_len(bundle.cfg, args)
    layout, one = make_layout(bundle, len(reqs), cap), make_layout(bundle, 1,
                                                                   cap)
    slab, singles, toks, starts = layout.init(dev), [], [], []
    for s, r in enumerate(reqs):
        out = bundle.prefill_fn(params, request_batch(r, dev, bundle.dtype))
        write_slot(layout, slab, out["cache"], s)
        singles.append(write_slot(one, one.init(dev), out["cache"], 0))
        toks.append(int(out["logits"][0, :V].float().argmax()))
        starts.append(int(out["pos"]))
    pos = torch.tensor(starts, dtype=torch.int32, device=dev)
    per_step = []
    for t in range(steps):
        cur = torch.tensor(toks, dtype=torch.int32, device=dev)
        batched = bundle.decode_fn(params, cur, slab, pos)["logits"]
        worst = 0.0
        for s in range(len(reqs)):
            row = bundle.decode_fn(params, cur[s:s + 1], singles[s],
                                   int(pos[s]))["logits"][0]
            worst = max(worst, float((batched[s, :V].float()
                                      - row[:V].float()).abs().max()))
            toks[s] = int(row[:V].float().argmax())
        per_step.append(worst)
        pos = pos + 1
    return max(per_step), per_step


def decode_layer_growth(torch, ctx, args, slots: int = 4) -> list[float]:
    """Where a batched decode step leaves the B = 1 one: after each layer,
    the max |residual stream difference| between the path's first
    ``slots`` prompts decoded together (per-slot positions) and each
    decoded alone (scalar position), from the same prefill caches and
    tokens."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import (decode_cache_valid,
                                           decode_positions, layer_views,
                                           rope_tables_at)
    from repro_torch.serve import make_layout, write_slot
    bundle, params = ctx["bundle"], ctx["params"]
    cfg = bundle.cfg
    reqs = ctx["requests"][:slots]
    cap = args.prompt_len + args.gen_tokens
    layout, one = make_layout(bundle, len(reqs), cap), make_layout(bundle, 1,
                                                                   cap)
    slab, singles, toks = layout.init("cuda"), [], []
    for s, r in enumerate(reqs):
        out = bundle.prefill_fn(params, {"tokens": torch.as_tensor(
            r.tokens)[None].cuda()})
        write_slot(layout, slab, out["cache"], s)
        singles.append(write_slot(one, one.init("cuda"), out["cache"], 0))
        toks.append(int(out["logits"][0, :cfg.vocab_size].float().argmax()))
    cur = torch.tensor(toks, dtype=torch.int32, device="cuda")
    pos = torch.full((len(reqs),), args.prompt_len, dtype=torch.int32,
                     device="cuda")
    p0 = torch.tensor(args.prompt_len, device="cuda")
    C = slab["k"].shape[2]

    def tables(at, n):
        return decode_cache_valid(at, C), rope_tables_at(
            decode_positions(at, n), cfg.head_dim, cfg.rotary_frac,
            cfg.rope_theta)

    (valid_b, rope_b), (valid_1, rope_1) = tables(pos, len(reqs)), tables(
        p0, 1)
    x_b = params["embed"][cur.long()][:, None, :]
    x_1 = [params["embed"][cur[s:s + 1].long()][:, None, :]
           for s in range(len(reqs))]
    growth = []
    for i, p in enumerate(layer_views(params["layers"])):
        x_b = tf._layer_decode(p, x_b, slab["k"][i], slab["v"][i], pos,
                               rope_b, cfg, valid_b)
        for s in range(len(reqs)):
            x_1[s] = tf._layer_decode(p, x_1[s], singles[s]["k"][i],
                                      singles[s]["v"][i], p0, rope_1, cfg,
                                      valid_1)
        growth.append(max(float((x_b[s] - x_1[s][0]).float().abs().max())
                          for s in range(len(reqs))))
    return growth


def _diff(x_b, x_1) -> float:
    """Max |batched row s - B = 1 stream s| over the rows."""
    return max(float((x_b[s] - x[0]).float().abs().max())
               for s, x in enumerate(x_1))


def hybrid_decode_trace(torch, ctx, args, slots: int = 4) -> dict:
    """Where a batched hybrid decode step leaves the B = 1 one: the first
    decode step of the path's first ``slots`` prompts, decoded together
    (per-slot positions, as the engine) and each alone (a scalar position,
    as the sequential decode), from the same prefill caches and tokens.
    After each mamba layer and each attention site: ``carried``, the max
    |residual difference| so far; ``local``, the one that block alone
    makes, run batched on the B = 1 streams' inputs against each B = 1
    run (the rounding of that block's batched products, or a fault in
    its batched state or positions); ``scale``, the B = 1 residual's max
    |value|.  The states are not written (the sites' KV writes land at
    the step's own position, which no later read of this step sees)."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import (decode_cache_valid,
                                           decode_positions, rope_tables_at)
    from repro_torch.models.hybrid import _blocks
    from repro_torch.serve import make_layout, write_slot
    bundle, params = ctx["bundle"], ctx["params"]
    dev = params["embed"].device
    cfg = bundle.cfg
    reqs = ctx["requests"][:slots]
    n = len(reqs)
    cap = args.prompt_len + args.gen_tokens
    layout, one = make_layout(bundle, n, cap), make_layout(bundle, 1, cap)
    slab, singles, toks = layout.init(dev), [], []
    for s, r in enumerate(reqs):
        out = bundle.prefill_fn(params, {"tokens": torch.as_tensor(
            r.tokens)[None].to(dev)})
        write_slot(layout, slab, out["cache"], s)
        singles.append(write_slot(one, one.init(dev), out["cache"], 0))
        toks.append(int(out["logits"][0, :cfg.vocab_size].float().argmax()))
    pos_b = torch.tensor([len(r.tokens) for r in reqs], dtype=torch.int32,
                         device=dev)
    pos_1 = [torch.tensor(len(r.tokens), device=dev) for r in reqs]
    C = slab["k"].shape[2]

    def tables(at, b):
        return decode_cache_valid(at, C), rope_tables_at(
            decode_positions(at, b), cfg.head_dim, cfg.rotary_frac,
            cfg.rope_theta)

    valid_b, rope_b = tables(pos_b, n)
    single_tables = [tables(at, 1) for at in pos_1]
    cur = torch.tensor(toks, dtype=torch.int32, device=dev)
    x_b = params["embed"][cur.long()][:, None, :]
    x_1 = [x_b[s:s + 1].clone() for s in range(n)]
    trace = []

    def record(block, x_b, loc, x_1):
        trace.append({"block": block, "carried": _diff(x_b, x_1),
                      "local": _diff(loc, x_1),
                      "scale": max(float(x.float().abs().max())
                                   for x in x_1)})

    for i, (p, site) in enumerate(_blocks(params, cfg)):
        state_b = (slab["ssm"][i], slab["conv"][i])
        x_b = ssm.mamba_block_decode(p, x_b, state_b, cfg)[0]
        loc = ssm.mamba_block_decode(p, torch.cat(x_1), state_b, cfg)[0]
        x_1 = [ssm.mamba_block_decode(p, x_1[s], (singles[s]["ssm"][i],
                                                  singles[s]["conv"][i]),
                                      cfg)[0] for s in range(n)]
        record(f"mamba {i}", x_b, loc, x_1)
        if site is not None:
            k, blk = site
            kv_b = (slab["k"][k], slab["v"][k])
            x_b = tfm._layer_decode(blk, x_b, *kv_b, pos_b, rope_b, cfg,
                                    valid_b)
            loc = tfm._layer_decode(blk, torch.cat(x_1), *kv_b, pos_b,
                                    rope_b, cfg, valid_b)
            x_1 = [tfm._layer_decode(
                blk, x_1[s], singles[s]["k"][k], singles[s]["v"][k],
                pos_1[s], single_tables[s][1], cfg, single_tables[s][0])
                for s in range(n)]
            record(f"site {k} (shared {k % cfg.hybrid_num_shared})", x_b,
                   loc, x_1)
    carried = [t["carried"] for t in trace]
    local = [t["local"] for t in trace]
    worst = max(range(len(trace)), key=lambda j: local[j] / max(
        trace[j]["scale"], 1e-30))
    return {"decode_block_trace": trace,
            "decode_block_trace_slots": n,
            "decode_block_first_nonzero": next(
                (t["block"] for t in trace if t["carried"] > 0), None),
            "decode_block_carried_last": carried[-1],
            "decode_block_local_max": max(local),
            "decode_block_local_max_rel": local[worst]
            / max(trace[worst]["scale"], 1e-30),
            "decode_block_local_max_rel_at": trace[worst]["block"]}


class _Diverged(Exception):
    """Stops a sequential decode at its first token off the engine's."""


def margin_rule(torch, ctx, args, spread: float) -> list[dict]:
    """A diagnostic of the M = 1 comparison: where the engine's stream
    leaves the sequential B = 1 one, the first diverging position, the
    sequential logits' top-2 margin there, and the first position whose
    margin is below ``spread`` (a near tie that the batched and B = 1
    products may order differently), if any up to there.  Each sequential
    decode stops at its first token off the engine's stream: nothing past
    it enters the record."""
    from repro_torch.core import prng
    from repro_torch.launch.serve import _total_len
    from repro_torch.serve import request_batch, sequential_decode
    bundle, params = ctx["bundle"], ctx["params"]
    dev = params["embed"].device
    V = bundle.cfg.vocab_size
    got = {c.req_id: c.tokens for c in ctx["completions"]}
    found = []
    for r in ctx["requests"]:
        rows: list = []
        eng = got[r.req_id]

        def decode(params, tok, cache, p, rows=rows, eng=eng):
            # ``tok`` was sampled from rows[-1]: stop where it leaves eng
            if int(tok[0]) != eng[len(rows) - 1]:
                raise _Diverged
            return bundle.decode_fn(params, tok, cache, p)

        try:
            seq = sequential_decode(
                bundle, params, request_batch(r, dev, bundle.dtype),
                r.req_id, r.max_new_tokens, base_key=prng.key(args.seed),
                max_seq_len=_total_len(bundle.cfg, args), decode=decode,
                logits_out=rows)
        except _Diverged:
            seq = None
        if seq == eng:
            continue
        p = len(rows) - 1 if seq is None else next(
            (j for j, (a, b) in enumerate(zip(eng, seq)) if a != b),
            min(len(eng), len(seq)))
        margins = [float(t[0] - t[1]) for t in
                   (torch.topk(x[:V], 2).values for x in rows[:p + 1])]
        found.append({"req": r.req_id, "first_diverging_pos": p,
                      "margin_there": margins[-1],
                      "first_near_tie_pos": next(
                          (j for j, m in enumerate(margins) if m < spread),
                          None),
                      "min_margin_to_there": min(margins)})
    return found


def same_width_decode(torch, bundle, params, req, slots: int, cap: int,
                      seed: int = 0, temperature: float = 0.0):
    """The serve gate's oracle: ``req`` decoded alone, but in a batch
    ``slots`` rows wide, so that every product has the engine's shapes.
    Its B = 1 prefill is paged into every row of a ``slots``-row slab of
    capacity ``cap`` (`write_slot`); each step decodes all rows at per-row
    positions (`bundle.decode_fn`) with the same sampled token, drawn from
    row 0's logits with the engine's (request, position) key.  Returns
    (row 0's tokens, whether every row gave the same logits at every
    step)."""
    from repro_torch.core import prng
    from repro_torch.serve import (make_layout, request_batch, sample_token,
                                   sampling_key, write_slot)
    dev = params["embed"].device
    V = bundle.cfg.vocab_size
    out = bundle.prefill_fn(params, request_batch(req, dev, bundle.dtype))
    layout = make_layout(bundle, slots, cap)
    slab = layout.init(dev)
    for s in range(slots):
        write_slot(layout, slab, out["cache"], s)
    logits = out["logits"].float().expand(slots, -1)
    p = int(out["pos"])
    pos = torch.full((slots,), p, dtype=torch.int32, device=dev)
    base = prng.key(seed).to(dev)
    toks, rows_equal = [], True
    while True:
        key = sampling_key(base, req.req_id, p) if temperature > 0 else None
        tok = int(sample_token(logits[0], key, temperature, V))
        toks.append(tok)
        if len(toks) >= req.max_new_tokens:
            return toks, rows_equal
        cur = torch.full((slots,), tok, dtype=torch.int32, device=dev)
        logits = bundle.decode_fn(params, cur, slab, pos)["logits"].float()
        rows_equal &= bool((logits == logits[0]).all())
        pos, p = pos + 1, p + 1


def same_width_gate(torch, ctx, args) -> dict:
    """The engine's streams against `same_width_decode` for every request:
    a record of the requests whose streams differ (with the first
    diverging position); the caller fails the phase on any."""
    from repro_torch.launch.serve import _total_len
    bundle, params = ctx["bundle"], ctx["params"]
    got = {c.req_id: c.tokens for c in ctx["completions"]}
    cap = _total_len(bundle.cfg, args)
    mismatches, rows_equal = [], True
    t0 = time.perf_counter()
    for r in ctx["requests"]:
        toks, equal = same_width_decode(torch, bundle, params, r, args.slots,
                                        cap, args.seed, args.temperature)
        rows_equal &= equal
        eng = got[r.req_id]
        if toks != eng:
            p = next((j for j, (a, b) in enumerate(zip(eng, toks))
                      if a != b), min(len(eng), len(toks)))
            mismatches.append({"req": r.req_id, "first_diverging_pos": p,
                               "engine": eng[p:p + 4],
                               "oracle": toks[p:p + 4]})
    return {"oracle": f"same-width decode, {args.slots} rows",
            "requests": len(ctx["requests"]), "equal": not mismatches,
            "mismatches": mismatches, "rows_equal_every_step": rows_equal,
            "seconds": time.perf_counter() - t0}


def _drive_serve(torch, K, serve, argv, cfg=None):
    """run_serving on ``argv`` (``cfg``: a depth-cut config in place of
    ``--arch``'s) with the launch counts set to 0 just before it and read
    just after it; earlier phases' buffers collected first, so the peak is
    this run's."""
    args = serve.build_parser().parse_args(list(argv))
    gc.collect()
    torch.cuda.synchronize()
    check(torch.cuda.memory_allocated() < 1 << 30,
          f"{torch.cuda.memory_allocated()} B still allocated before a path")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    ctx = serve.run_serving(args, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    return args, ctx, counts, torch.cuda.max_memory_allocated(), wall


def _checked(res) -> int:
    """Requests --parity-check re-decoded sequentially: it stops at the
    first mismatching request, as the reference's does."""
    if res["parity"] == "ok":
        return res["requests"]
    return 1 + int(re.match(r"mismatch req (\d+)", res["parity"]).group(1))


def _serve_record(phase: str, res, args, peak, wall, counts, gate) -> dict:
    return {"phase": phase, "entry_point": res,
            "steady_prefill_ms": res["steady_prefill_ms"],
            "steady_chunk_ms": res["steady_chunk_ms"],
            "ms_per_decode_step": res["steady_chunk_ms"] / args.decode_chunk,
            "ms_per_token": 1e3 / res["tokens_per_s"],
            "tokens_per_s": res["tokens_per_s"],
            "ttft_p50_ms": res["ttft_p50_ms"],
            "latency_p50_ms": res["latency_p50_ms"],
            "latency_p99_ms": res["latency_p99_ms"],
            "max_memory_allocated": peak, "run_wall_s": wall,
            "gate": gate, "parity_m1": res["parity"], "launches": counts}


def _serve_path_phase(torch, K, serve, phase: str, argv, full, expect,
                      margins: bool = True, diagnose=None,
                      cfg=None) -> dict:
    """`python -m repro_torch.launch.serve` with ``argv`` (`_drive_serve`).
    ``full(cfg)``: the model is at full width and depth.  ``expect(cfg,
    prefills, steps)``: each kernel's launches for the run's prefills (the
    warm-up request, the admissions and --parity-check's sequential
    re-decodes) and decode steps (the warm-up's chunk, the timed chunks and
    the re-decodes' steps).  Gate: the engine's streams equal the
    same-width oracle's exactly.  --parity-check's M = 1 comparison is
    printed and, where it differs, the batched-vs-B=1 logit spread, with
    ``margins`` the margin rule's record (whose first tokens, from the
    B = 1 prefill on both sides, must agree) and ``diagnose(ctx, args)``'s
    fields.  Returns the run's launch counts."""
    args, ctx, counts, peak, wall = _drive_serve(torch, K, serve, argv, cfg)
    res = ctx["result"]
    cfg = ctx["bundle"].cfg
    n = args.requests
    check(full(cfg), f"{phase}: {cfg.name} is not at full width and depth")
    check(res["completed"] == n and res["generated_tokens"] == n
          * args.gen_tokens,
          f"{phase}: served {res['completed']} / {res['generated_tokens']}")
    checked = _checked(res)
    prefills = 1 + n + checked
    steps = (args.decode_chunk * (1 + len(ctx["engine"].chunk_times))
             + (args.gen_tokens - 1) * checked)
    want = expect(cfg, prefills, steps)
    check(all(counts.get(k, 0) == v for k, v in want.items()),
          f"{phase} launches {counts}, expected {want} for {prefills} "
          f"prefills and {steps} decode steps")
    # every chunk's ms (the first, after the warm-up, is not steady)
    chunks_ms = [t * 1e3 for t in ctx["engine"].chunk_times]
    del ctx["engine"]
    gc.collect()
    diag = {"decode_logit_spread": None, "decode_logit_spread_per_step": None,
            "divergence_m1": []}
    with torch.no_grad():
        gate = same_width_gate(torch, ctx, args)
        if res["parity"] != "ok":
            gc.collect()
            spread, per_step = decode_logit_spread(torch, ctx, args)
            diag.update(decode_logit_spread=spread,
                        decode_logit_spread_per_step=per_step)
            if margins:
                diag["divergence_m1"] = margin_rule(torch, ctx, args, spread)
            if diagnose is not None:
                diag.update(diagnose(ctx, args))
    rec = _serve_record(phase, res, args, peak, wall, counts, gate)
    rec.update({"prefills": prefills, "decode_steps": steps,
                "launches_expected": want, "chunks_ms": chunks_ms,
                "parity": res["parity"], **diag})
    emit(rec)
    check(gate["equal"], f"{phase}: the engine's streams differ from the "
                         f"same-width oracle's: {gate['mismatches']}")
    check(all(d["first_diverging_pos"] > 0 for d in diag["divergence_m1"]),
          f"{phase}: a first token differs from the sequential one")
    del ctx
    return counts


def _dense_decode_growth(torch, ctx, args) -> dict:
    """Why the stablelm M = 1 streams part: the batched and B = 1 residual
    streams after each layer of one decode step, in bf16 and with the
    same weights in f32, and the f32 logit spread over 2 steps."""
    from repro_torch.models import build_model
    growth = decode_layer_growth(torch, ctx, args)
    cfg32 = dataclasses.replace(ctx["bundle"].cfg, dtype="float32")
    ctx32 = {"bundle": build_model(cfg32),
             "params": {k: v.float() if k != "layers" else
                        {n: t.float() for n, t in v.items()}
                        for k, v in ctx["params"].items()},
             "requests": ctx["requests"]}
    spread_f32 = decode_logit_spread(torch, ctx32, args, steps=2)
    return {"decode_logit_spread_f32_per_step": spread_f32[1],
            "decode_layer_growth_bf16": growth,
            "decode_layer_growth_f32": decode_layer_growth(torch, ctx32,
                                                           args)}


def phase_serve_path(torch, K, serve):
    """SERVE_PATH_ARGS: stablelm-3b at full width, SERVE_LAYERS layers,
    bf16, 9 requests of 2000-token prompts on 8 slots, 64 tokens each in
    chunks of 8, every prefill attention through B10 (a launch a layer).
    Where the M = 1 check differs: the logit spread, the margin rule's
    record and a layer-by-layer trace of the two residual streams, in
    bf16 and in f32 (`_serve_path_phase`)."""
    from repro_torch.configs import get_config
    return _serve_path_phase(
        torch, K, serve, "serve_path", SERVE_PATH_ARGS,
        lambda cfg: cfg.num_layers == SERVE_LAYERS and cfg.d_model == 2560,
        lambda cfg, prefills, steps: {
            "flash_attention": cfg.num_layers * prefills},
        diagnose=lambda ctx, args: _dense_decode_growth(torch, ctx, args),
        cfg=dataclasses.replace(get_config("stablelm-3b"),
                                num_layers=SERVE_LAYERS))


def phase_xlstm_serve_path(torch, K, serve):
    """XLSTM_SERVE_ARGS: xlstm-125m at full width, XLSTM_SERVE_LAYERS
    blocks, bf16, 9 requests of 500-token prompts on 8 slots, 32 tokens
    each in chunks of 8.  B11 twice in each mLSTM block of every prefill
    (Q = 64, 8 chunks) and every decode step (Q = 1).  Where the M = 1
    check differs: the logit spread and the margin rule's record
    (`_serve_path_phase`)."""
    from repro_torch.configs import get_config

    def expect(cfg, prefills, steps):
        per_call = 2 * sum(1 for i in range(cfg.num_layers)
                           if i % cfg.slstm_every != 1)
        return {"ssd_intra_chunk": per_call * (prefills + steps)}

    return _serve_path_phase(
        torch, K, serve, "xlstm_serve_path", XLSTM_SERVE_ARGS,
        lambda cfg: (cfg.family == "xlstm" and cfg.d_model == 768
                     and cfg.num_layers == XLSTM_SERVE_LAYERS), expect,
        cfg=dataclasses.replace(get_config("xlstm-125m"),
                                num_layers=XLSTM_SERVE_LAYERS))


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _family_step_parity(torch, K, train, phase: str, cfg, steps: int,
                        b11: int, oracle64: bool = False) -> None:
    """``steps`` steps of ``cfg`` (f32, 4 agents, seq 70: the scan padded
    to 128) through run_training on the card (B3 + B2, and B11 in each
    SSD forward, ``b11`` launches a step) and on the CPU (plain versions),
    same weights and batches.  Tolerance: losses rtol 1e-5, params atol =
    rtol = 1e-4.  With ``oracle64`` the CPU also runs the steps in
    float64, and each leaf of the card's state must lie within twice the
    CPU f32 state's distance (max abs) of it, plus 1e-4: for models whose
    f32 steps are ill-conditioned, where the CPU's own f32 state moves
    more than 1e-4 from the float64 one."""
    from repro_torch.core.privacy import tree_leaves, tree_paths
    from repro_torch.models import build_model
    gen = torch.Generator()
    gen.manual_seed(5)
    p0 = build_model(cfg).init(gen, "cpu")
    flags = ["--arch", cfg.name, "--agents", "4", "--steps", str(steps),
             "--log-every", "1", "--seq-len", "70", "--seed", "5"]
    K.reset_launch_counts()
    gpu = train.run_training(train.build_parser().parse_args(
        flags + ["--device", "cuda"]), cfg=cfg, init_params=p0)
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    cpu = train.run_training(train.build_parser().parse_args(
        flags + ["--device", "cpu"]), cfg=cfg, init_params=p0)
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(gpu["history"], cpu["history"]))
    check(loss_rel <= 1e-5, f"{phase} loss rel {loss_rel}")
    max_abs = 0.0
    gaps = {}
    if oracle64:
        f64 = train.run_training(train.build_parser().parse_args(
            flags + ["--device", "cpu"]), cfg=cfg,
            init_params=_cast_tree(p0, torch.float64))
        for path, a, b, c in zip(tree_paths(cpu["state"].params),
                                 tree_leaves(gpu["state"].params),
                                 tree_leaves(cpu["state"].params),
                                 tree_leaves(f64["state"].params)):
            card, host = (float((t.cpu().double() - c).abs().max())
                          for t in (a, b))
            max_abs = max(max_abs, float((a.cpu() - b).abs().max()))
            gaps[path] = {"card_vs_f64": card, "cpu_vs_f64": host}
            check(card <= 2 * host + 1e-4,
                  f"{phase} {path}: card {card} from float64, CPU {host}")
    else:
        for a, b in zip(tree_leaves(gpu["state"].params),
                        tree_leaves(cpu["state"].params)):
            a = a.cpu()
            max_abs = max(max_abs, float((a - b).abs().max()))
            check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
                  f"{phase} params, max abs {max_abs}")
    check(counts.get("ssd_intra_chunk", 0) == b11 * steps
          and counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("gossip_update", 0) == steps,
          f"{phase} launches {counts}")
    emit({"phase": phase, "arch": cfg.name, "num_layers": cfg.num_layers,
          "dtype": "float32", "agents": 4, "steps": steps, "seq_len": 70,
          "losses_gpu": [r["loss"] for r in gpu["history"]],
          "losses_cpu": [r["loss"] for r in cpu["history"]],
          "max_loss_rel_err": loss_rel, "max_param_abs_err": max_abs,
          "launches": counts, "float64_gaps": gaps or None,
          "tolerance": "loss rtol 1e-5; params " + (
              "within 2 x the CPU f32 state's max abs distance from a "
              "float64 run, + 1e-4, leaf by leaf" if oracle64 else
              "atol = rtol = 1e-4")})


def _family_train_path(torch, K, train, cfg, phase: str, full: bool,
                       seq_len: int, b11: int, steps: int = 4, flags=(),
                       **extra) -> dict:
    """run_training on ``cfg`` (and ``flags``), 4 agents on a ring, bf16,
    PDSGD, per-agent batch 2, ``seq_len``, 1 warm-up + ``steps - 1`` timed
    steps: B3 + B2 every step, B11 ``b11`` times a step (its backward the
    plain version's autograd).  Gates: ``full``, finite losses and buffer,
    the launches.  Returns the run's launch counts."""
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        flags, seq_len=seq_len)
    hist = res["history"]
    losses = [r["loss"] for r in hist]
    state = res["state"]
    m, width = state.flat.shape
    check(full, f"{phase}: {cfg.name} at {cfg.num_layers} layers, "
                f"d_model {cfg.d_model}")
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(state.flat.dtype == torch.bfloat16, "bf16 buffer")
    check(_finite_flat(torch, state.flat), "non-finite parameters")
    check(counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("gossip_update", 0) == steps
          and counts.get("ssd_intra_chunk", 0) == b11 * steps,
          f"{phase} launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    emit({"phase": phase, "arch": cfg.name, "num_layers": cfg.num_layers,
          **extra, "d_model": cfg.d_model, "dtype": cfg.dtype, "agents": m,
          "topology": "ring", "per_agent_batch": 2, "seq_len": seq_len,
          "flags": list(flags), "params_per_agent": state.layout.size,
          "width": width, "losses": losses,
          "consensus_errors": [r["consensus_error"] for r in hist],
          "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})
    return counts


def phase_xlstm_step_parity(torch, K, train):
    """2 steps of xlstm-125m-smoke (one mLSTM and one sLSTM block) on the
    card against the CPU (`_family_step_parity`); B11 16 a step (4 agents x
    1 mLSTM block x 2 calls x RECOMPUTE)."""
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-125m-smoke")
    _family_step_parity(torch, K, train, "xlstm_step_parity", cfg, 2,
                        4 * _mlstm_blocks(cfg) * 2 * RECOMPUTE)


# xlstm-125m's train path cut from 12 to 6 blocks for the script's time
# limit: with per-layer recompute its eager step took 9.97 s at 12 on an
# NVIDIA H100 80GB HBM3 at 700.00 W (the sLSTM's host loop twice a step)
XLSTM_TRAIN_LAYERS = 6


def phase_xlstm_train_path(torch, K, train, cfg):
    """xlstm-125m at full width (d_model 768), XLSTM_TRAIN_LAYERS blocks,
    seq XLSTM_TRAIN_SEQ (`_family_train_path`): B11 in every mLSTM
    forward, 4 agents x 3 mLSTM blocks x 2 calls x RECOMPUTE a step."""
    return _family_train_path(
        torch, K, train, cfg, "xlstm_train_path",
        cfg.num_layers == XLSTM_TRAIN_LAYERS and cfg.d_model == 768,
        XLSTM_TRAIN_SEQ, 4 * _mlstm_blocks(cfg) * 2 * RECOMPUTE)


# zamba2-7b (arXiv:2411.15242, the reference's config): training cut from
# 81 to 12 mamba layers (sites 5 and 11, both shared blocks): 1,462,315,968
# parameters an agent, a (4, D) bf16 buffer of 11.70 GB (at full depth
# 54.7 GB a buffer); per-agent batch 2, seq 512, as the stablelm main path
HYBRID_TRAIN_LAYERS = 12
HYBRID_SCANNED_STEPS = 6  # a warm-up chunk, then two replayed chunks
HYBRID_SCANNED_UNROLL = 2
# served at full width, 2000-token prompts (no multiple of 64: the dt = 0
# padding runs) on 8 slots; 9 requests (one admitted into a live slab) of
# 32 tokens, cut from 16 requests for the script's time limit (a
# request's oracle decode costs a prefill and a chunk's steps); depth 81
# -> 24 mamba layers (4 sites, both shared blocks), then 12 (2 sites, both
# shared blocks) for the same limit
HYBRID_SERVE_LAYERS = 12
HYBRID_SERVE_ARGS = ("--arch", "zamba2-7b", "--slots", "8", "--requests",
                     "9", "--prompt-len", "2000", "--gen-tokens", "32",
                     "--decode-chunk", "8", "--parity-check")


def _hybrid_counts(cfg):
    """(mamba layers, attention sites) of a hybrid config."""
    from repro_torch.models.hybrid import _attn_sites
    return cfg.num_layers, len(_attn_sites(cfg))


def phase_hybrid_step_parity(torch, K, train):
    """One PDSGD step of zamba2-7b-smoke at 4 layers (sites 1 and 3 on
    shared blocks 0 and 1) on the card against the CPU
    (`_family_step_parity`); B11 in each mamba forward with B and C shared
    by the heads, 4 agents x 4 layers x RECOMPUTE a step."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("zamba2-7b-smoke"), num_layers=4)
    _family_step_parity(torch, K, train, "hybrid_step_parity", cfg, 1,
                        4 * cfg.num_layers * RECOMPUTE)


def phase_hybrid_train_path(torch, K, train, cfg):
    """zamba2-7b at full width and HYBRID_TRAIN_LAYERS mamba layers, seq
    512 (`_family_train_path`): B11 in every mamba forward, 4 agents x 12
    layers x RECOMPUTE a step (G = 16 chunks, 112 heads)."""
    n_mamba, n_sites = _hybrid_counts(cfg)
    return _family_train_path(
        torch, K, train, cfg, "hybrid_train_path",
        cfg.family == "hybrid" and cfg.d_model == 3584
        and n_mamba == HYBRID_TRAIN_LAYERS and n_sites == 2, 512,
        4 * n_mamba * RECOMPUTE, attn_sites=n_sites)


def phase_hybrid_train_scanned(torch, K, train, cfg):
    """The hybrid train path through `--unroll-k 2`: a warm-up chunk, then
    two chunks replayed from a CUDA graph, beside the same 6 steps eager
    (`_family_train_scanned`); B11 96 times a step (4 agents x 12 mamba
    layers x RECOMPUTE)."""
    return _family_train_scanned(
        torch, K, train, cfg, "hybrid_train_scanned",
        4 * _hybrid_counts(cfg)[0] * RECOMPUTE, HYBRID_SCANNED_STEPS,
        HYBRID_SCANNED_UNROLL, 512)


def phase_hybrid_serve_parity(torch, serve):
    """zamba2-7b-smoke in f32 (`_serve_parity`): the mamba blocks' SSD
    through B11 and the shared attention through B10 on the card (every
    prefill; decode runs ssd_step, no kernel), the plain versions on the
    CPU."""
    cfg, tokens, max_err, counts = _serve_parity(
        torch, serve, "zamba2-7b-smoke", ("ssd_intra_chunk",
                                          "flash_attention"))
    n_mamba, n_sites = _hybrid_counts(cfg)
    # prefills: warm-up + 4 requests + 4 sequential
    check(counts["ssd_intra_chunk"] == n_mamba * 9
          and counts["flash_attention"] == n_sites * 9,
          f"hybrid_serve_parity launches {counts}")
    emit({"phase": "hybrid_serve_parity", "arch": cfg.name,
          "dtype": "float32", "slots": 2, "requests": 4,
          "tokens_gpu": tokens, "streams_equal": True,
          "prefill_logits_max_abs_err": max_err, "launches_gpu": counts,
          "tolerance": "tokens equal; prefill logits atol = rtol = 1e-4"})


def phase_hybrid_serve_path(torch, K, serve):
    """HYBRID_SERVE_ARGS: zamba2-7b at full width, HYBRID_SERVE_LAYERS
    mamba layers (a shared attention site after every sixth), bf16 weights
    (the residual stream
    f32 from the first mamba block on, as the reference's), 9 requests of
    2000-token prompts on 8 slots, 32 tokens each in chunks of 8.  Every
    prefill runs B11 in each mamba layer (G = 32 chunks, 112 heads) and
    B10 at each site (hd 112, f32); decode runs no kernel.  Where the M = 1
    check differs: the logit spread and a block-by-block trace of one
    decode step (`hybrid_decode_trace`, `_serve_path_phase`)."""

    from repro_torch.configs import get_config

    def full(cfg):
        return (cfg.family == "hybrid" and cfg.d_model == 3584
                and _hybrid_counts(cfg) == (HYBRID_SERVE_LAYERS,
                                            HYBRID_SERVE_LAYERS // 6))

    def expect(cfg, prefills, steps):
        n_mamba, n_sites = _hybrid_counts(cfg)
        return {"ssd_intra_chunk": n_mamba * prefills,
                "flash_attention": n_sites * prefills}

    return _serve_path_phase(
        torch, K, serve, "hybrid_serve_path", HYBRID_SERVE_ARGS, full,
        expect, margins=False,
        diagnose=lambda ctx, args: hybrid_decode_trace(torch, ctx, args),
        cfg=dataclasses.replace(get_config("zamba2-7b"),
                                num_layers=HYBRID_SERVE_LAYERS))


# the dense GQA configs (0c-iii): step parity on the smoke models in f32,
# chatglm3-6b-smoke (KV 2 of 8 heads, half rotary) and mistral-nemo's
# smoke model with 8 query heads of 16 on 2 KV heads (H hd = 128 against
# d_model 256, rope_theta 1e6: what the smoke reduction erases); training
# chatglm3-6b at full width, depth 28 -> 4 (1,348,505,600 parameters an
# agent, a 10.79 GB (4, D) bf16 buffer); serving mistral-nemo-12b at full
# width and depth (40 layers, 11,576,693,760 parameters, 23.15 GB bf16)
GQA_TRAIN_LAYERS = 4
GQA_SCANNED_STEPS = 6  # a warm-up chunk, then two replayed chunks
GQA_SCANNED_UNROLL = 2
# the GQA and MoE train paths clip each gradient element to [-1, 1]
# (Theorem 5's bounded-gradient premise): the random deep models'
# gradients reach 1e3-1e4 (chatglm3-6b, depth 4) and 1e11 (granite-moe,
# 24 layers, f32 and bf16 alike), and unclipped the lr-0.4 step drives
# granite-moe's residual stream past f32's range (its loss then sits at
# ln V, consensus error 1e21)
NEW_TRAIN_FLAGS = ("--grad-clip-kappa", "1.0")
# (8 requests on 8 slots: cut from 9 for the script's time limit, so
# these two cells refill no slot; the other serve cells do; and, for the
# same limit once the enc-dec and VLM cells came, mistral-nemo-12b at full
# width with depth 40 -> 20 and olmoe-1b-7b at 16 -> 8: the two phases
# took 65.8 and 32.7 s at full depth on an NVIDIA H100 80GB HBM3 at
# 700.00 W)
GQA_SERVE_LAYERS = 20
MOE_SERVE_LAYERS = 8
GQA_SERVE_ARGS = ("--arch", "mistral-nemo-12b", "--slots", "8",
                  "--requests", "8", "--prompt-len", "2000", "--gen-tokens",
                  "32", "--decode-chunk", "8", "--parity-check")
# the MoE family (0c-iv): olmoe-1b-7b-smoke in f32 for step parity;
# granite-moe-1b-a400m trained at full width and depth (24 layers, 32
# experts top 8; a 10.68 GB (4, D) bf16 buffer); olmoe-1b-7b served at
# full width and depth (16 layers, 64 experts top 8, 13.63 GB bf16)
MOE_SERVE_ARGS = ("--arch", "olmoe-1b-7b", "--slots", "8", "--requests",
                  "8", "--prompt-len", "2000", "--gen-tokens", "32",
                  "--decode-chunk", "8", "--parity-check")
# granite-8b's prefill: B10 held in place, at every layer, against an f32
# attention on that layer's own bf16 q, k and v; the logits of whole
# prefills with plain and with f32 attention beside it.  The reference's
# init (fan-in of wq and wk the head count) gives logits of std ~256 at
# KV 8: the plain attention's bf16 logits then round by up to 4 and pick
# other keys, so the oracle scores in f32, as B10 does
GRANITE_PROMPT = 2000
# B10 in place: max |B10 - f32 attention| <= this x max |v| (P rounded to
# bf16 for the PV product, 2^-9 of each weight, and the output's own bf16
# rounding, with room for the f32 scores' summation order)
GRANITE_IN_PLACE_OF_V = 2.0 ** -6

def _mistral_gqa_smoke():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mistral-nemo-12b-smoke"),
                               name="mistral-nemo-gqa-smoke", num_heads=8,
                               num_kv_heads=2, head_dim=16)


def phase_gqa_step_parity(torch, K, train):
    """2 PDSGD steps of chatglm3-6b-smoke and of mistral-nemo's KV < H,
    H hd != d_model smoke variant on the card against the CPU
    (`_family_step_parity`; B3 + B2, no B11), held leaf by leaf against a
    float64 run on the CPU: their f32 gradients lie ~3e-4 of the largest
    entry from a float64 evaluation, the reference's as much (0.02-scale
    embeddings into an RMSNorm, sharp random attention;
    tests/test_torch_gqa.py), and after 2 steps the CPU's own f32
    ``embed`` is 6.8e-3 from the float64 run's (an update of 3.9e-2)."""
    from repro_torch.configs import get_config
    for cfg in (get_config("chatglm3-6b-smoke"), _mistral_gqa_smoke()):
        _family_step_parity(torch, K, train, "gqa_step_parity", cfg, 2, 0,
                            oracle64=True)


def _moe_drops(torch, cfg, seq_len: int) -> dict:
    """The pairs capacity drops in one CPU loss evaluation of ``cfg``'s
    first agent batch of the step-parity run (the init of
    `_family_step_parity`'s seed), counted at `models.moe.dispatch`."""
    from repro_torch.data import make_lm_pipeline
    from repro_torch.models import build_model, moe
    gen = torch.Generator()
    gen.manual_seed(5)
    bundle = build_model(cfg)
    params = bundle.init(gen, "cpu")
    batch = make_lm_pipeline(cfg.vocab_size, 4, 2, seq_len,
                             seed=5).batch_at(0)
    seen = {"pairs": 0, "dropped": 0}
    dispatch = moe.dispatch

    def counting(eidx, C, E):
        order, buf_idx = dispatch(eidx, C, E)
        seen["pairs"] += buf_idx.numel()
        seen["dropped"] += int((buf_idx == E * C).sum())
        return order, buf_idx

    moe.dispatch = counting
    try:
        with torch.no_grad():
            bundle.loss_fn(params, {k: torch.from_numpy(v[0])
                                    for k, v in batch.items()})
    finally:
        moe.dispatch = dispatch
    return seen


def phase_moe_step_parity(torch, K, train):
    """2 PDSGD steps of olmoe-1b-7b-smoke (4 experts top 2) on the card
    against the CPU (`_family_step_parity`) at capacity factor 1.0 (35
    slots an expert of a sequence's 140 pairs), where capacity drops pairs
    (counted on the CPU, gated > 0)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("olmoe-1b-7b-smoke"),
                              capacity_factor=1.0)
    drops = _moe_drops(torch, cfg, 70)
    emit({"phase": "moe_step_parity_drops", "arch": cfg.name,
          "capacity_factor": cfg.capacity_factor, **drops})
    check(drops["dropped"] > 0, f"moe_step_parity: no pair dropped {drops}")
    _family_step_parity(torch, K, train, "moe_step_parity", cfg, 2, 0)


def phase_gqa_train_path(torch, K, train, cfg):
    """chatglm3-6b at full width, GQA_TRAIN_LAYERS layers, seq 512, the
    gradients clipped (NEW_TRAIN_FLAGS; `_family_train_path`, 1 warm-up +
    5 timed steps): B3 + B2, KV 2 of 32 heads in every attention."""
    return _family_train_path(
        torch, K, train, cfg, "gqa_train_path",
        cfg.name == "chatglm3-6b" and cfg.d_model == 4096
        and cfg.num_layers == GQA_TRAIN_LAYERS and cfg.num_kv_heads == 2,
        512, 0, steps=6, flags=NEW_TRAIN_FLAGS)


def phase_moe_train_path(torch, K, train, cfg):
    """granite-moe-1b-a400m at full width and depth (24 layers, 32 experts
    top 8, KV 8 of 16 heads), seq 512, the gradients clipped
    (NEW_TRAIN_FLAGS; `_family_train_path`, 1 warm-up + 5 timed steps): B3
    + B2; the routing (sorts, searchsorted, gathers and a
    scatter) and the expert products in plain torch, as the reference's
    have no Pallas kernel."""
    return _family_train_path(
        torch, K, train, cfg, "moe_train_path",
        cfg.name == "granite-moe-1b-a400m" and cfg.num_layers == 24
        and cfg.d_model == 1024 and cfg.num_experts == 32, 512, 0, steps=6,
        flags=NEW_TRAIN_FLAGS)


def phase_family_train_scanned(torch, K, train, cfg, phase: str):
    """A GQA or MoE train path (NEW_TRAIN_FLAGS) through `--unroll-k 2` (a
    warm-up chunk, then two chunks replayed from one CUDA graph), beside
    the same 6 steps eager (`_family_train_scanned`): bitwise, B3 and B2
    once a step."""
    return _family_train_scanned(torch, K, train, cfg, phase, 0,
                                 GQA_SCANNED_STEPS, GQA_SCANNED_UNROLL, 512,
                                 NEW_TRAIN_FLAGS)


def gqa_serve_cfg():
    """mistral-nemo-12b cut to GQA_SERVE_LAYERS layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mistral-nemo-12b"),
                               num_layers=GQA_SERVE_LAYERS)


def moe_serve_cfg():
    """olmoe-1b-7b cut to MOE_SERVE_LAYERS layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("olmoe-1b-7b"),
                               num_layers=MOE_SERVE_LAYERS)


def phase_gqa_serve_path(torch, K, serve):
    """GQA_SERVE_ARGS: mistral-nemo-12b at full width (32 query heads of
    128 on 8 KV heads, d_model 5120), GQA_SERVE_LAYERS layers, bf16, 8
    requests of 2000-token prompts on 8 slots, 32 tokens each in chunks
    of 8; B10 once a layer a prefill (k and v repeated to 32 heads).
    Gate: the engine's streams equal the same-width oracle's
    (`_serve_path_phase`)."""
    return _serve_path_phase(
        torch, K, serve, "gqa_serve_path", GQA_SERVE_ARGS,
        lambda cfg: (cfg.name == "mistral-nemo-12b"
                     and cfg.num_layers == GQA_SERVE_LAYERS
                     and cfg.d_model == 5120 and cfg.num_kv_heads == 8),
        lambda cfg, prefills, steps: {
            "flash_attention": cfg.num_layers * prefills},
        margins=False, cfg=gqa_serve_cfg())


def phase_moe_serve_path(torch, K, serve):
    """MOE_SERVE_ARGS: olmoe-1b-7b at full width (64 experts top 8),
    MOE_SERVE_LAYERS layers, bf16, 8 requests of 2000-token prompts on 8
    slots, 32 tokens each in chunks of 8; B10 once a layer a prefill;
    prefill routes with capacity, decode mixes all experts (the
    reference's).  Gate: the engine's streams equal the same-width
    oracle's."""
    return _serve_path_phase(
        torch, K, serve, "moe_serve_path", MOE_SERVE_ARGS,
        lambda cfg: (cfg.name == "olmoe-1b-7b"
                     and cfg.num_layers == MOE_SERVE_LAYERS
                     and cfg.d_model == 2048 and cfg.num_experts == 64),
        lambda cfg, prefills, steps: {
            "flash_attention": cfg.num_layers * prefills},
        margins=False, cfg=moe_serve_cfg())


def _rel_l2(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def phase_granite_prefill(torch, K):
    """granite-8b at full width and depth (36 layers, 32 query heads of 128
    on 8 KV heads, 16.11 GB bf16): one GRANITE_PROMPT-token prefill through
    `forward_prefill` with B10 (36 launches), each layer's B10 output held
    in place against an f32 grouped attention on the same q, k and v
    (within GRANITE_IN_PLACE_OF_V of max |v|), the plain bf16 attention's
    distance from it recorded beside.  Then the same prefill with `_attn`
    pointed at the plain attention and at the f32 attention: the random
    36-layer model's sharp attention amplifies any rounding, so the three
    runs' logits are a diagnostic (relative L2).  Gates: B10 in place at
    every layer, finite logits, B10's launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import attention
    cfg = get_config("granite-8b")
    check(cfg.num_layers == 36 and cfg.d_model == 4096, "granite-8b full")
    gc.collect()
    torch.cuda.synchronize()
    check(torch.cuda.memory_allocated() < 1 << 30,
          f"{torch.cuda.memory_allocated()} B still allocated before a path")
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    bundle = build_model(cfg)
    params = bundle.init(gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, GRANITE_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    b10_attn = tfm._attn
    in_place = []

    def plain(q, k, v, window, cfg=None):
        return attention(q, k, v, causal=True, window=window)

    def f32_attn(q, k, v, window, cfg=None):
        return attention(q.float(), k.float(), v.float(), causal=True,
                         window=window).to(q.dtype)

    def checked(q, k, v, window, cfg=None):
        got = b10_attn(q, k, v, window, cfg)
        exact = attention(q.float(), k.float(), v.float(), causal=True,
                          window=window)
        in_place.append({
            "b10": float((got.float() - exact).abs().max()),
            "plain_bf16": float((plain(q, k, v, window).float()
                                 - exact).abs().max()),
            "max_v": float(v.float().abs().max())})
        return got

    out = {}
    with torch.no_grad():
        for name, fn in (("b10", checked), ("plain", plain),
                         ("f32_attention", f32_attn)):
            tfm._attn = fn
            try:
                K.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = bundle.prefill_fn(params, {"tokens": tokens})
                torch.cuda.synchronize()
                out[name] = {"logits": res["logits"][:, :cfg.vocab_size]
                             .float(), "ms": (time.perf_counter() - t0) * 1e3,
                             "launches": dict(K.launch_counts)}
                del res
            finally:
                tfm._attn = b10_attn
    b10, ref, f32 = (out[n]["logits"] for n in ("b10", "plain",
                                                "f32_attention"))
    rel_b10_f32, rel_plain_f32 = _rel_l2(torch, b10, f32), _rel_l2(torch,
                                                                   ref, f32)
    rec = {"phase": "granite_prefill", "arch": cfg.name,
           "num_layers": cfg.num_layers, "prompt": GRANITE_PROMPT,
           "dtype": cfg.dtype,
           "in_place_b10_max_abs_err": max(r["b10"] for r in in_place),
           "in_place_b10_of_max_v": max(r["b10"] / r["max_v"]
                                        for r in in_place),
           "in_place_plain_bf16_max_abs_err": max(r["plain_bf16"]
                                                  for r in in_place),
           "in_place_max_v": max(r["max_v"] for r in in_place),
           "in_place_layers": len(in_place),
           "logits_rel_l2_b10_vs_plain": _rel_l2(torch, b10, ref),
           "logits_rel_l2_b10_vs_f32_attention": rel_b10_f32,
           "logits_rel_l2_plain_vs_f32_attention": rel_plain_f32,
           "argmax_b10_plain_f32": [int(t.argmax()) for t in (b10, ref, f32)],
           "logits_scale": float(ref.abs().max()),
           "ms": {n: o["ms"] for n, o in out.items()},
           "launches": {n: o["launches"] for n, o in out.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "tolerance": f"in place, every layer: max |B10 - f32 "
                        f"attention| <= {GRANITE_IN_PLACE_OF_V} x max |v| "
                        f"on the same q, k, v; logits: diagnostic"}
    emit(rec)
    check(all(bool(torch.isfinite(o["logits"]).all())
              for o in out.values()), "granite_prefill: non-finite logits")
    check(out["b10"]["launches"].get("flash_attention", 0) == cfg.num_layers
          and len(in_place) == cfg.num_layers
          and out["plain"]["launches"].get("flash_attention", 0) == 0,
          f"granite_prefill launches {rec['launches']}")
    check(rec["in_place_b10_of_max_v"] <= GRANITE_IN_PLACE_OF_V,
          f"granite_prefill: B10 in place {in_place}")
    del params, out, b10, ref, f32
    gc.collect()
    torch.cuda.empty_cache()
    return rec["launches"]["b10"]

# 0c-v: the enc-dec family and the VLM prefix, served.  seamless-m4t-medium
# at full width and depth (12 + 12 layers, d_model 1024, vocab 256206
# padded to 256512; 615,114,752 parameters, 1.23 GB of bf16 weights on
# one NVIDIA H100 80GB HBM3, 700.00 W), oneshot (the only mode the
# family has): 8 rows of 2000 frames and 2000-token prompts, 32 tokens
ENCDEC_SERVE_ARGS = ("--arch", "seamless-m4t-medium", "--mode", "oneshot",
                     "--slots", "8", "--prompt-len", "2000", "--gen-tokens",
                     "32", "--decode-chunk", "8", "--parity-check")
# llava-next-34b at full width (d_model 7168, 56 x 128 on 8 KV heads,
# d_ff 20480, vocab 64000), depth 60 cut to 24 (13,847,321,600 parameters,
# 27.7 GB bf16; on one NVIDIA H100 80GB HBM3 (700.00 W) full depth's
# 67.9 GB of weights do not fit beside a 9.6 GB KV slab for the engine
# and another for the oracle); the continuous engine, 8 requests of 2560
# positions (2304 image embeddings, then 256 text tokens) on 8 slots, 32
# tokens; depth 24 cut to 12 for the script's time limit
VLM_SERVE_LAYERS = 12
VLM_SERVE_ARGS = ("--arch", "llava-next-34b", "--slots", "8", "--requests",
                  "8", "--prompt-len", "2560", "--gen-tokens", "32",
                  "--decode-chunk", "8", "--parity-check")
# decode steps of the enc-dec parity phase, card against CPU
ENCDEC_PARITY_STEPS = 4


def _smoke_close(torch, got, want) -> float:
    """``got`` (card) within atol 1e-3 of ``want``'s (CPU) largest entry
    plus rtol 1e-4 (tests/test_torch_encdec.py's smoke tolerance);
    returns max |got - want| / max |want|."""
    got, want = got.float().cpu(), want.float()
    scale = float(want.abs().max())
    diff = (got - want).abs()
    ok = bool((diff <= 1e-3 * scale + 1e-4 * want.abs()).all())
    return float(diff.max()) / max(scale, 1e-30) if ok else math.inf


def phase_encdec_serve_parity(torch, K, serve):
    """seamless-m4t-medium-smoke in f32, oneshot through run_serving on the
    card (B10 non-causal in the encoder, causal in the decoder) and on the
    CPU (the plain attention), same weights: both --parity-check ok, the
    rows equal, the prompts drawn bitwise alike; then the CLI's
    batch prefilled on each (logits and the k, v, xk, xv caches) and
    ENCDEC_PARITY_STEPS greedy decode steps from it at per-slot positions
    (logits and the caches, written in place), each tensor within
    `_smoke_close`.  The frames drawn on each device are within 3 ulp of
    each other (`normal_draws_card_vs_cpu` counts the f32 draws that
    differ); the tensors are compared on the CPU's batch."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("seamless-m4t-medium-smoke")
    bundle = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(7)
    p0 = bundle.init(gen, "cpu")
    flags = ["--arch", cfg.name, "--slots", "2", "--prompt-len", "37",
             "--gen-tokens", "12", "--decode-chunk", "4", "--parity-check"]
    K.reset_launch_counts()
    gpu = serve.run_serving(serve.build_parser().parse_args(
        flags + ["--device", "cuda"]), init_params=p0)
    torch.cuda.synchronize()
    b10 = K.launch_counts["flash_attention"]
    cpu = serve.run_serving(serve.build_parser().parse_args(
        flags + ["--device", "cpu"]), init_params=p0)
    for run in (gpu, cpu):
        check(run["result"]["mode"] == "oneshot"
              and run["result"]["parity"] == "ok",
              f"encdec_serve_parity: {run['result']}")
    check(gpu["rows"] == cpu["rows"],
          f"encdec_serve_parity rows {gpu['rows']} != {cpu['rows']}")
    batch = cpu["batch"]
    check(torch.equal(gpu["batch"]["tokens"].cpu(), batch["tokens"]),
          "encdec_serve_parity: the card's prompts differ from the CPU's")
    draws = normal_draws_card_vs_cpu(torch, serve)
    frames_ulps = max_ulps(torch, gpu["batch"]["frames"].cpu(),
                           batch["frames"])
    check(frames_ulps <= 3, f"encdec_serve_parity: the card's frames are "
                            f"{frames_ulps} ulp from the CPU's")
    # prefills: the timed pair and one sequential re-decode a row
    per_prefill = cfg.num_encoder_layers + cfg.num_layers
    check(b10 == per_prefill * (2 + 2),
          f"encdec_serve_parity B10 launches {b10}")
    errs = {}

    def hold(name, a, b):
        errs[name] = max(errs.get(name, 0.0), _smoke_close(torch, a, b))
        check(errs[name] <= 1.0, f"encdec_serve_parity {name}: "
                                 f"beyond 1e-3 of its scale")

    gp = gpu["params"]
    with torch.no_grad():
        a = bundle.prefill_fn(gp, {k: v.cuda() for k, v in batch.items()})
        b = bundle.prefill_fn(p0, batch)
        hold("prefill_logits", a["logits"], b["logits"])
        for name in ("k", "v", "xk", "xv"):
            hold(f"cache_{name}", a["cache"][name], b["cache"][name])
        pos = torch.full((2,), b["pos"], dtype=torch.int32)
        logits = b["logits"]
        for _ in range(ENCDEC_PARITY_STEPS):
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            a = bundle.decode_fn(gp, tok.cuda(), a["cache"], pos.cuda())
            b = bundle.decode_fn(p0, tok, b["cache"], pos)
            hold("decode_logits", a["logits"], b["logits"])
            for name in ("k", "v"):
                hold(f"cache_{name}", a["cache"][name], b["cache"][name])
            logits, pos = b["logits"], pos + 1
    emit({"phase": "encdec_serve_parity", "arch": cfg.name,
          "dtype": "float32", "rows": 2, "tokens_gpu": gpu["rows"],
          "rows_equal": True, "frames_max_ulps_card_vs_cpu": frames_ulps,
          "normal_draws_card_vs_cpu": draws,
          "flash_attention_launches_gpu": b10,
          "decode_steps": ENCDEC_PARITY_STEPS,
          "max_err_over_scale": errs,
          "tolerance": "streams equal; logits and caches within 1e-3 of "
                       "the tensor's largest entry + rtol 1e-4"})


def max_ulps(torch, a, b) -> float:
    """max |a - b| in ulps of b, in b's dtype (f32 or bf16)."""
    mag = b.abs()
    word = torch.int32 if b.dtype == torch.float32 else torch.int16
    ulp = (mag.view(word) + 1).view(b.dtype).float() - mag.float()
    return float(((a.float() - b.float()).abs() / ulp).max())


def normal_draws_card_vs_cpu(torch, serve, n: int = 1 << 20) -> dict:
    """`launch.serve.synthetic_normal` drawn on the card and on the CPU
    from one key, f32 and bf16: how many of ``n`` draws differ and by how
    many ulps (the draw's float64 log1p and polynomial steps are the same
    code on both devices; the libraries' float64 log1p may not be)."""
    from repro_torch.core import prng
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = prng.fold_in(prng.key(1), 1)
        a = serve.synthetic_normal(key, (4, n // 4), dtype, "cuda").cpu()
        b = serve.synthetic_normal(key, (4, n // 4), dtype, "cpu")
        diff = a != b
        out[str(dtype)[6:]] = {
            "draws": n, "differ": int(diff.sum()),
            "max_ulps": max_ulps(torch, a, b) if bool(diff.any()) else 0.0,
            "at": [float(x) for x in b[diff][:8]]}
    return out


def oneshot_same_width_gate(torch, ctx, args) -> dict:
    """The oneshot path's oracle: each row's batch (tokens, frames, prefix)
    repeated over all ``--slots`` rows, prefilled and decoded greedily at
    that width, so every product has the oneshot run's shapes; row 0's
    stream must equal the run's row exactly."""
    from repro_torch.serve import sample_token
    bundle, params, batch = ctx["bundle"], ctx["params"], ctx["batch"]
    V, B = bundle.cfg.vocab_size, args.slots
    mismatches, rows_equal = [], True
    t0 = time.perf_counter()
    for row, got in enumerate(ctx["rows"]):
        out = bundle.prefill_fn(params, {
            k: v[row:row + 1].expand(B, *v.shape[1:]).contiguous()
            for k, v in batch.items()})
        cache, logits = out["cache"], out["logits"].float()
        pos = torch.full((B,), args.prompt_len, dtype=torch.int32,
                         device=logits.device)
        toks = []
        while True:
            toks.append(int(sample_token(logits[0], None, 0.0, V)))
            if len(toks) >= args.gen_tokens:
                break
            cur = torch.full((B,), toks[-1], dtype=torch.int32,
                             device=logits.device)
            logits = bundle.decode_fn(params, cur, cache, pos)["logits"]
            logits = logits.float()
            rows_equal &= bool((logits == logits[0]).all())
            pos = pos + 1
        del out, cache
        if toks != got:
            p = next((j for j, (a, b) in enumerate(zip(got, toks)) if a != b),
                     min(len(got), len(toks)))
            mismatches.append({"row": row, "first_diverging_pos": p,
                               "oneshot": got[p:p + 4],
                               "oracle": toks[p:p + 4]})
    return {"oracle": f"each row repeated over {B} rows", "rows": B,
            "equal": not mismatches, "mismatches": mismatches,
            "rows_equal_every_step": rows_equal,
            "seconds": time.perf_counter() - t0}


def oneshot_m1_divergence(torch, ctx, args, row: int) -> dict:
    """A diagnostic of the oneshot M = 1 comparison at its first
    mismatching ``row``: the B = 1 prefill's logits against the row's in
    the batched (B = --slots) prefill, and the sequential decode's top-2
    margin where its stream leaves the batched one."""
    from repro_torch.core import prng
    from repro_torch.serve import sequential_decode
    bundle, params, batch = ctx["bundle"], ctx["params"], ctx["batch"]
    V = bundle.cfg.vocab_size
    one = {k: v[row:row + 1] for k, v in batch.items()}
    full = bundle.prefill_fn(params, batch)["logits"][row]
    gap = float((bundle.prefill_fn(params, one)["logits"][0].float()
                 - full.float()).abs().max())
    rows: list = []
    seq = sequential_decode(bundle, params, one, row, args.gen_tokens,
                            base_key=prng.key(args.seed), logits_out=rows)
    got = ctx["rows"][row]
    p = next((j for j, (a, b) in enumerate(zip(got, seq)) if a != b), None)
    margins = [float(t[0] - t[1]) for t in
               (torch.topk(x[:V], 2).values for x in rows)]
    return {"row": row, "prefill_logits_gap_b1_vs_batched": gap,
            "first_diverging_pos": p,
            "margin_there": None if p is None else margins[p],
            "min_margin_to_there": None if p is None else min(
                margins[:p + 1])}


def phase_encdec_serve_path(torch, K, serve):
    """ENCDEC_SERVE_ARGS: seamless-m4t-medium at full width and depth, bf16,
    oneshot, 8 rows of 2000 frames and 2000-token prompts, 32 tokens in
    chunks of 8; B10 24 times a prefill (12 non-causal in the encoder, 12
    causal in the decoder; cross-attention plain).  Gate: each row equals
    the same-width oracle's stream (`oneshot_same_width_gate`); the M = 1
    --parity-check printed beside it.  Then the encoder alone on row 0's
    frames: B10 once a layer."""
    from repro_torch.models import encdec
    args, ctx, counts, peak, wall = _drive_serve(torch, K, serve,
                                                 ENCDEC_SERVE_ARGS)
    res, cfg = ctx["result"], ctx["bundle"].cfg
    check(cfg.name == "seamless-m4t-medium" and cfg.num_layers == 12
          and cfg.num_encoder_layers == 12 and cfg.d_model == 1024
          and cfg.vocab_size == 256206,
          f"encdec_serve_path: {cfg.name} is not at full width and depth")
    B = args.slots
    check(res["mode"] == "oneshot" and res["completed"] == B
          and res["generated_tokens"] == B * args.gen_tokens,
          f"encdec_serve_path: served {res['completed']} / "
          f"{res['generated_tokens']}")
    checked = B if res["parity"] == "ok" else 1 + int(re.match(
        r"mismatch row (\d+)", res["parity"]).group(1))
    prefills = 2 + checked
    per_prefill = cfg.num_encoder_layers + cfg.num_layers
    check(counts.get("flash_attention", 0) == per_prefill * prefills,
          f"encdec_serve_path launches {counts}, expected {per_prefill} "
          f"for each of {prefills} prefills")
    with torch.no_grad():
        K.reset_launch_counts()
        enc = encdec.encode(ctx["params"], ctx["batch"]["frames"][:1], cfg)
        torch.cuda.synchronize()
        encoder_b10 = K.launch_counts["flash_attention"]
        check(encoder_b10 == cfg.num_encoder_layers
              and bool(torch.isfinite(enc).all()),
              f"encdec_serve_path: the encoder launched B10 {encoder_b10} "
              f"times")
        del enc
        gate = oneshot_same_width_gate(torch, ctx, args)
        m1 = (None if res["parity"] == "ok" else
              oneshot_m1_divergence(torch, ctx, args, checked - 1))
    rec = {"phase": "encdec_serve_path", "entry_point": res,
           "steady_prefill_ms": res["steady_prefill_ms"],
           "steady_chunk_ms": res["steady_chunk_ms"],
           "ms_per_decode_step": res["steady_chunk_ms"] / args.decode_chunk,
           "tokens_per_s": res["tokens_per_s"],
           "max_memory_allocated": peak, "run_wall_s": wall,
           "prefills": prefills, "flash_attention_per_prefill": per_prefill,
           "encoder_flash_attention_launches": encoder_b10,
           "launches": counts, "gate": gate, "parity_m1": res["parity"],
           "divergence_m1": m1}
    emit(rec)
    check(gate["equal"], f"encdec_serve_path: the oneshot rows differ from "
                         f"the same-width oracle's: {gate['mismatches']}")
    del ctx
    return counts


def _llava_gqa_smoke():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llava-next-34b-smoke"),
                               name="llava-next-34b-gqa-smoke",
                               num_kv_heads=2)


def phase_vlm_serve_parity(torch, serve):
    """llava-next-34b-smoke in f32 (KV = H after the smoke reduction) and
    its variant with 2 KV heads of 8 (`_serve_parity`, prefix embeds in
    every prefill): prefill attention through B10 on the card (k and v
    repeated 4x for the variant), the naive attention on the CPU."""
    out = {}
    for arch, cfg in (("llava-next-34b-smoke", None),
                      ("llava-next-34b-gqa-smoke", _llava_gqa_smoke())):
        cfg, tokens, max_err, counts = _serve_parity(
            torch, serve, arch, ("flash_attention",), cfg)
        b10 = counts["flash_attention"]
        # prefills: warm-up + 4 requests + 4 sequential
        check(b10 == cfg.num_layers * 9,
              f"vlm_serve_parity {arch} B10 launches {b10}")
        out[arch] = {"kv_heads": cfg.num_kv_heads, "tokens_gpu": tokens,
                     "prefill_logits_max_abs_err": max_err,
                     "flash_attention_launches_gpu": b10}
    emit({"phase": "vlm_serve_parity", "dtype": "float32", "slots": 2,
          "requests": 4, "prefix_embeds": 16, "streams_equal": True,
          "archs": out,
          "tolerance": "tokens equal; prefix embeds bitwise; prefill "
                       "logits atol = rtol = 1e-4"})


def phase_vlm_serve_path(torch, K, serve):
    """VLM_SERVE_ARGS: llava-next-34b at full width, VLM_SERVE_LAYERS
    layers, bf16, 8 requests of 2304 image embeddings and 256 text tokens
    on 8 slots, 32 tokens each in chunks of 8; B10 VLM_SERVE_LAYERS times
    a prefill at
    (1, 2560, 56, 128) (k and v repeated 7x).  Gate: the engine's streams
    equal the same-width oracle's, prefixes included
    (`_serve_path_phase`)."""
    return _serve_path_phase(
        torch, K, serve, "vlm_serve_path", VLM_SERVE_ARGS,
        lambda cfg: (cfg.name == "llava-next-34b" and cfg.family == "vlm"
                     and cfg.num_layers == VLM_SERVE_LAYERS
                     and cfg.d_model == 7168 and cfg.num_heads == 56
                     and cfg.num_kv_heads == 8 and cfg.d_ff == 20480
                     and cfg.num_prefix_embeds == 2304),
        lambda cfg, prefills, steps: {
            "flash_attention": cfg.num_layers * prefills},
        margins=False, cfg=vlm_cfg())


def vlm_cfg():
    """llava-next-34b cut to VLM_SERVE_LAYERS layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llava-next-34b"),
                               num_layers=VLM_SERVE_LAYERS)


MULTIHOST_STEPS = 2
MULTIHOST_ARGS = ("--arch", "stablelm-3b", "--num-layers",
                  str(BITS_PATH_LAYERS), "--agents", "4", "--topology",
                  "ring", "--per-agent-batch", "2", "--seq-len", "512",
                  "--steps", str(MULTIHOST_STEPS), "--grad-clip-kappa",
                  "1.0", "--lr", "0.4", "--warmup-hold", "200", "--seed",
                  "0", "--log-every", "1000", "--device", "cuda",
                  "--timeout", "600", "--checkpoint-sync")
MULTIHOST_DIR = ROOT / "build" / "chip_multihost"
MULTIHOST_SMOKE_ARGS = ("--arch", "stablelm-3b-smoke", "--agents", "4",
                        "--topology", "ring", "--per-agent-batch", "2",
                        "--seq-len", "64", "--seed", "0", "--log-every",
                        "1000", "--device", "cuda", "--timeout", "120",
                        "--checkpoint-every", "1", "--checkpoint-sync")


def _mh_args(mh, root: Path | None, base, *extra):
    ckpt = ("--checkpoint-dir", str(root)) if root is not None else ()
    return mh.build_multihost_parser().parse_args([*base, *ckpt, *extra])


def _launch_counted(torch, K, mh, args) -> tuple[dict, dict, float]:
    """`launch.multihost.launch`; returns its summary, the kernel launches
    of the run (the ranks' own counts, each read in its process, summed)
    and the wall seconds.  An in-process rank (world 1) also counts here,
    from 0 just before it, checked against its summary."""
    # (only an in-process rank counts here: launches of rank processes
    # may run beside it on other threads, and leave this count alone)
    if args.world == 1:
        K.reset_launch_counts()
    t0 = time.perf_counter()
    out = mh.launch(args)
    wall = time.perf_counter() - t0
    if args.world == 1:
        here = dict(K.launch_counts)
        check(here == out["launches"],
              f"in-process launches {here} against the summary's "
              f"{out['launches']}")
    check(out["ok"], f"multihost launch failed: {out}")
    return out, out["launches"], wall


def _concurrently(*fns) -> list:
    """Call each of ``fns`` on its own thread; their results in order
    (the first exception re-raised)."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(len(fns)) as ex:
        futures = [ex.submit(fn) for fn in fns]
        return [f.result() for f in futures]


def _rank_record(s: dict) -> dict:
    comm = s["comm"]
    steps = max(1, comm["steps"])
    return {"rank": s["rank"], "us_per_step": s["us_per_step"],
            "compute_s": comm["compute_s"], "comm_s": comm["comm_s"],
            "comm_wait_s": comm["comm_wait_s"], "hmac_s": comm["hmac_s"],
            "bytes_sent_per_step": comm["bytes_sent"] / steps,
            "drops": comm["drops"], "tag_failures": comm["tag_failures"],
            "transport": comm["transport"],
            "peak_device_bytes": s["peak_device_bytes"],
            "peak_rss_bytes": s["peak_rss_bytes"],
            "launches": s["launches"]}


def _loopback_probe(nbytes: int = 1 << 30) -> dict:
    """This host's loopback TCP rate (one stream, ``recv_into`` a
    preallocated buffer, 4 MiB socket buffers, as the pipelined
    transport) and its HMAC-SHA256 rate, over ``nbytes``."""
    import hashlib
    import hmac
    import socket
    import threading
    import numpy as np
    payload = np.ones(nbytes // 4, np.float32)
    sink = np.empty_like(payload)
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    out = {}

    def send():
        s = socket.create_connection(lst.getsockname())
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
        s.sendall(memoryview(payload).cast("B"))
        s.close()

    t = threading.Thread(target=send)
    conn_t0 = time.perf_counter()
    t.start()
    conn, _ = lst.accept()
    conn.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    mv, got = memoryview(sink).cast("B"), 0
    while got < nbytes:
        got += conn.recv_into(mv[got:], nbytes - got)
    out["loopback_GBps"] = nbytes / (time.perf_counter() - conn_t0) / 1e9
    t.join()
    conn.close()
    lst.close()
    t0 = time.perf_counter()
    hmac.new(b"k" * 32, memoryview(payload).cast("B"),
             hashlib.sha256).digest()
    out["hmac_sha256_GBps"] = nbytes / (time.perf_counter() - t0) / 1e9
    return out


def _multihost_b3_parity(torch, K, prng, mh, args) -> dict:
    """Step 0 of the agents [2, 4) of the multihost path's configuration
    on the card, as a rank owning them runs it: the gradients, then u by
    B3 keyed by the global ids 2 and 3, against the plain version of B3
    on the same gradients and key table, bitwise, column chunk by column
    chunk; then B3 timed on that (2, width) f32 buffer."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.schedules import warmup_harmonic
    from repro_torch.data import make_lm_pipeline
    from repro_torch.dist.transport import flatten_one
    from repro_torch.models import build_model
    dev = torch.device(args.device)
    cfg = dataclasses.replace(get_config(args.arch),
                              num_layers=args.num_layers)
    bundle = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    init = bundle.init(gen, dev)
    lo, L = 2, 2
    prog = mh._RankProgram(bundle, init, L, lo, dev, args.grad_clip_kappa,
                           warmup_harmonic(args.lr, hold=args.warmup_hold))
    x = np.tile(flatten_one(init), (L, 1))
    del init
    pipeline = make_lm_pipeline(cfg.vocab_size, args.agents,
                                args.per_agent_batch, args.seq_len,
                                seed=args.seed)
    prog.grads(x, pipeline.batch_at(0, agent_slice=(lo, lo + L)))
    G0 = prog.G.clone()
    _, lam_root = mh._key_roots(args, 0)
    K.reset_launch_counts()
    U = prog.obfuscate(0, lam_root)
    check(dict(K.launch_counts) == {"obfuscate_update_krng": 1},
          f"multihost B3 parity launches {dict(K.launch_counts)}")
    width = U.shape[1]
    keys = lambda_key_table(prng.fold_in(lam_root, 0), 0, L,
                            prog.layout.n_leaves,
                            agents=torch.arange(lo, lo + L)).to(dev)
    offsets = torch.tensor(prog.layout.offsets, dtype=torch.int64)
    lam = prog.lam_bar(0).to(dev)
    for s, e in _chunks(width):
        bits = prng.leaf_bits(keys, offsets, L, width, start=s, stop=e)
        check(same_bits(torch, U[:, s:e], K.ref.obfuscate_ref(
            prog.X[:, s:e], G0[:, s:e], bits, lam, 0.0, -1.0)),
            f"multihost B3 u differs from its plain version at columns "
            f"{s}:{e}")
    kd = keys.to(torch.uint32)
    od = offsets.to(dev)
    n = L * width
    rec = {"shape": [L, width], "dtype": "float32", "agents": [lo, lo + L],
           "u_bitwise_plain": True,
           "ms": time_ms(torch, lambda: K.obfuscate_update_krng(
               prog.X, G0, kd, od, lam, 0.0, -1.0, out=U), iters=5)}
    # f32: x and g read, u written (12 bytes an element)
    rec["bound_ms"], rec["bound_by"] = bound_ms(n * 12, n * 5,
                                                n * THREEFRY_INT_OPS)
    del prog, G0, U
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_multihost_path(torch, K, prng):
    """The multi-controller deployment at full width: stablelm-3b at
    BITS_PATH_LAYERS (D = 418,145,280 per agent), m = 4 on a ring, f32
    parameters (as the reference's ranks), 3 steps with the clip at 1.0
    and a terminal checkpoint of each shard.  --world 4: four rank
    processes on this card over HMAC-framed loopback sockets
    (PipelinedSocketTransport, --frames-ahead 1), each drawing its
    Lambda^k in B3 keyed by its agent's global id; --world 1: the same
    configuration in this process (InProcessTransport).  Gates: each
    rank's final rows bitwise the world=1 run's, no tag failures and no
    drops, every x finite, B3 launched once a step in each rank (one
    launch over the rank's (L, width) buffer: L x steps with L = 1) and
    in the world=1 run, and step 0's u of B3 bitwise its plain version
    (`_multihost_b3_parity`).  Prints MemAvailable before, each rank's
    ms a step, compute / comm / wait / HMAC seconds, bytes sent a step,
    peak device memory and peak RSS."""
    import shutil
    from repro_torch.launch import multihost as mh
    shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
    MULTIHOST_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = _mem_available()
    print(f"multihost_path: MemAvailable {mem0 / 2**30:.1f} GiB, this "
          f"process's RSS peak {_peak_rss() / 2**30:.1f} GiB", flush=True)
    probe = _loopback_probe()
    try:
        a4 = _mh_args(mh, MULTIHOST_DIR / "w4", MULTIHOST_ARGS, "--world",
                      "4", "--frames-ahead", "1")
        # the ranks' peak RSS polled from here (the card's machine has no
        # VmHWM, and an exec'd child's ru_maxrss starts at its parent's)
        with _ChildPeaks() as children:
            o4, c4, wall4 = _launch_counted(torch, K, mh, a4)
        mem_mid = _mem_available()
        torch.cuda.reset_peak_memory_stats()
        # the in-process run writes no shard: its final rows come back in
        # its summary's digests
        a1 = _mh_args(mh, None, MULTIHOST_ARGS, "--world", "1")
        o1, c1, wall1 = _launch_counted(torch, K, mh, a1)
        s1 = o1["ranks"]["0"]
        check(s1["finite"] and s1["final_step"] == MULTIHOST_STEPS,
              f"multihost world=1: {s1}")
        check(c1.get("obfuscate_update_krng", 0) == MULTIHOST_STEPS,
              f"multihost world=1 launches {c1}")
        check(o4["casualties"] == [], f"multihost casualties {o4}")
        for r in range(4):
            s = o4["ranks"][str(r)]
            check(s is not None and s["finite"]
                  and s["final_step"] == MULTIHOST_STEPS,
                  f"multihost rank {r}: {s}")
            check(s["comm"]["tag_failures"] == 0 and s["comm"]["drops"] == 0,
                  f"multihost rank {r} comm {s['comm']}")
            check(s["comm"]["transport"] == "PipelinedSocketTransport",
                  f"multihost rank {r} transport")
            check(s["row_sha256"] == s1["row_sha256"][r:r + 1],
                  f"multihost rank {r}'s final x differs from the world=1 "
                  f"run's row {r}")
            check(s["launches"].get("obfuscate_update_krng", 0)
                  == MULTIHOST_STEPS, f"multihost rank {r} launches "
                                      f"{s['launches']}")
        check(c4.get("obfuscate_update_krng", 0) == 4 * MULTIHOST_STEPS,
              f"multihost world=4 launches {c4}")
        parity = _multihost_b3_parity(torch, K, prng, mh, a1)
    finally:
        shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
    ranks = [_rank_record(o4["ranks"][str(r)]) for r in range(4)]
    for rr, r in zip(ranks, range(4)):
        polled = children.peaks.get(o4["ranks"][str(r)]["pid"], {})
        rr["polled_peak_rss_bytes"] = polled.get("peak_rss")
        rr["polled_field"] = polled.get("field")
    rec = {"phase": "multihost_path", "arch": "stablelm-3b",
           "num_layers": BITS_PATH_LAYERS, "agents": 4, "world": 4,
           "params_per_agent": 418_145_280, "steps": MULTIHOST_STEPS,
           "mem_available_before": mem0, "mem_available_between": mem_mid,
           "world4_wall_s": wall4, "world1_wall_s": wall1,
           "world4_ranks": ranks, "world1": _rank_record(s1),
           "world1_us_per_step": s1["us_per_step"],
           "launches_world4": c4, "launches_world1": c1,
           "b3_parity": parity, **probe}
    emit(rec)
    for rr in ranks:
        print(f"multihost_path rank {rr['rank']}: "
              f"{rr['us_per_step'] / 1e3:.0f} ms a step, compute "
              f"{rr['compute_s']:.1f} s, comm {rr['comm_s']:.1f} s (wait "
              f"{rr['comm_wait_s']:.1f}, HMAC {rr['hmac_s']:.1f}), "
              f"{rr['bytes_sent_per_step'] / 1e9:.2f} GB sent a step, peak "
              f"device {rr['peak_device_bytes'] / 2**30:.1f} GiB, peak RSS "
              f"{(rr['polled_peak_rss_bytes'] or 0) / 2**30:.1f} GiB "
              f"({rr['polled_field']}, polled)", flush=True)
    return rec


def phase_multihost_smoke(torch, K):
    """The multihost launcher's other paths on the card, stablelm-3b-smoke,
    world 2 x 2 agents: the blocking SocketTransport against the pipelined
    one (final rows bitwise), --wiretap (the merged stream and the final
    x bitwise the world=1 run's), then --chaos-kill-rank 1
    --chaos-kill-step 3 over 6 steps and --resume: the survivor's
    fault_log shows the overlay's W doubly stochastic, the resume starts
    at the quorum step with generation 1 and completes finite."""
    import json as _json
    import shutil
    import numpy as np
    from repro_torch.launch import multihost as mh
    root = MULTIHOST_DIR / "smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        base = (*MULTIHOST_SMOKE_ARGS, "--steps", "4")
        chaos = root / "chaos"
        base6 = (*MULTIHOST_SMOKE_ARGS, "--steps", "6", "--world", "2")
        # the three two-rank launches run at once (six rank processes on
        # the card; their start-up dominates), each with its own
        # coordinator and directory, and the world=1 run in this process
        # beside them
        (w1, _, t1), (blk, cb, tb), (pip, cp, tp), (killed, _, tk) = \
            _concurrently(lambda: _launch_counted(torch, K, mh, _mh_args(
                mh, root / "w1", base, "--world", "1", "--wiretap")),
            lambda: _launch_counted(torch, K, mh, _mh_args(
                mh, root / "blk", base, "--world", "2", "--wiretap")),
            lambda: _launch_counted(torch, K, mh, _mh_args(
                mh, root / "pip", base, "--world", "2", "--frames-ahead",
                "1")),
            lambda: _launch_counted(torch, K, mh, _mh_args(
                mh, chaos, base6, "--chaos-kill-rank", "1",
                "--chaos-kill-step", "3")))
        rows1 = w1["ranks"]["0"]["row_sha256"]
        for r in range(2):
            sb, sp = blk["ranks"][str(r)], pip["ranks"][str(r)]
            check(sb["comm"]["transport"] == "SocketTransport"
                  and sp["comm"]["transport"] == "PipelinedSocketTransport",
                  "multihost_smoke transports")
            check(sb["row_sha256"] == sp["row_sha256"]
                  == rows1[2 * r:2 * r + 2],
                  f"multihost_smoke rank {r}: blocking, pipelined and "
                  f"world=1 rows differ")
            for s in (sb, sp):
                check(s["comm"]["drops"] == 0
                      and s["comm"]["tag_failures"] == 0,
                      f"multihost_smoke comm {s['comm']}")
        with np.load(root / "w1" / "wiretap_merged.npz") as z1, \
                np.load(root / "blk" / "wiretap_merged.npz") as z2:
            check(list(z1["steps"]) == list(z2["steps"]) == [0, 1, 2, 3]
                  and z1["v"].tobytes() == z2["v"].tobytes(),
                  "multihost_smoke: merged wiretap differs from world=1's")
        check(killed["casualties"] == [1], f"chaos casualties {killed}")
        log = _json.loads((chaos / "host_0" / "fault_log.json").read_text())
        ev = log["events"][0]
        check(ev["dead"] == [2, 3] and ev["row_sum_err"] < 1e-6
              and ev["col_sum_err"] < 1e-6,
              f"chaos overlay not doubly stochastic: {ev}")
        quorum = mh.quorum_step(str(chaos), 2)
        check(quorum == 3, f"chaos quorum {quorum}")
        resumed, _, tr = _launch_counted(torch, K, mh, _mh_args(
            mh, chaos, base6, "--resume"))
        check(resumed["generation"] == 1 and resumed["casualties"] == [],
              f"resume {resumed}")
        for r in range(2):
            s = resumed["ranks"][str(r)]
            check(s["finite"] and s["final_step"] == 6
                  and s["generation"] == 1, f"resumed rank {r}: {s}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec = {"phase": "multihost_smoke", "arch": "stablelm-3b-smoke",
           "world": 2, "agents": 4, "wall_s": {
               "world1": t1, "blocking": tb, "pipelined": tp,
               "chaos": tk, "resume": tr},
           "blocking_ranks": [_rank_record(blk["ranks"][str(r)])
                              for r in range(2)],
           "pipelined_ranks": [_rank_record(pip["ranks"][str(r)])
                               for r in range(2)],
           "chaos_event": ev, "quorum": quorum,
           "resume_generation": resumed["generation"],
           "launches": {"blocking": cb, "pipelined": cp}}
    emit(rec)
    return rec


SOURCES = {
    "obfuscate_update": ("src/repro_torch/csrc/obfuscate.cu",
                         "src/repro/kernels/obfuscate.py:85"),
    "obfuscate_update_krng": ("src/repro_torch/csrc/obfuscate.cu",
                              "src/repro/kernels/obfuscate.py:153"),
    "gossip_update": ("src/repro_torch/csrc/gossip.cu",
                      "src/repro/kernels/gossip.py:78"),
    "masked_gossip_update": ("src/repro_torch/csrc/gossip.cu",
                             "src/repro/kernels/gossip.py:151"),
    "masked_gossip_update_krng": ("src/repro_torch/csrc/gossip.cu",
                                  "src/repro/kernels/gossip.py:228"),
    "guarded_gossip_update": ("src/repro_torch/csrc/gossip.cu",
                              "src/repro/kernels/gossip.py:316"),
    "ring_gossip_update": ("src/repro_torch/csrc/ring.cu",
                           "src/repro/kernels/gossip.py:446"),
    "ring_obfuscate_gossip": ("src/repro_torch/csrc/ring.cu",
                              "src/repro/kernels/gossip.py:506"),
    "ring_obfuscate_gossip_krng": ("src/repro_torch/csrc/ring.cu",
                                   "src/repro/kernels/gossip.py:598"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:100"),
    "ssd_intra_chunk": ("src/repro_torch/csrc/ssm_scan.cu",
                        "src/repro/kernels/ssm_scan.py:64"),
}


def main(argv=None) -> int:
    # a fault in native code prints the Python stack of every thread
    faulthandler.enable()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel phases only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile main-, dropout-, fault-, ring-, "
                         "xLSTM, hybrid and MoE train-path steps, the "
                         "scanned main, fault and ring paths' replayed "
                         "chunks, a Fig. 2 trimmed-mean replay and the "
                         "seven serve paths with torch.profiler")
    opts = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels run only on a CUDA card", file=sys.stderr)
        return 3
    RECORDS.parent.mkdir(exist_ok=True)
    RECORDS.write_text("")
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train

    smi = phase_device(torch, build)
    phase_kernels(torch, K, prng)
    phase_kernels_coupled(torch, K)
    phase_kernels_strided(torch, K)
    phase_kernels_ring(torch, K, prng)
    b10 = phase_kernel_attention(torch, K)
    b11 = phase_kernel_ssd(torch, K)
    rows = {}
    if not opts.quick:
        phase_step_parity(torch, train)
        full = get_config("stablelm-3b")
        main_cfg = dataclasses.replace(full, num_layers=MAIN_LAYERS)
        rows.update(phase_main_path(torch, K, train, prng, main_cfg))
        torch.cuda.empty_cache()
        if opts.profile:
            phase_profile(torch, train, main_cfg)
            torch.cuda.empty_cache()
        phase_fig2_path(torch, K, prng)
        gc.collect()
        torch.cuda.empty_cache()
        phase_fig2_trimmed_mean(torch, K, prng, opts.profile)
        gc.collect()
        torch.cuda.empty_cache()
        scanned_cfg = dataclasses.replace(full, num_layers=SCANNED_LAYERS)
        phase_main_path_scanned(torch, K, train, scanned_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_dropout_path_scanned(torch, K, train, scanned_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_fault_realize(torch, prng)
        phase_fault_path_scanned(torch, K, train, scanned_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_ring_path_scanned(torch, K, train, scanned_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_checkpoint_path(torch, K, train, dataclasses.replace(
            full, num_layers=CKPT_LAYERS))
        gc.collect()
        torch.cuda.empty_cache()
        smoke = get_config("stablelm-3b-smoke")
        phase_rollback_path(torch, K, train, smoke)
        phase_rollback_path_scanned(torch, K, train, smoke)
        gc.collect()
        torch.cuda.empty_cache()
        phase_privacy_audit(torch, K)
        gc.collect()
        torch.cuda.empty_cache()
        if opts.profile:
            phase_profile_scanned(torch, train, scanned_cfg)
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_scanned(
                torch, train, scanned_cfg, "fault_path_scanned",
                (*FAULT_FLAGS, "--fault-seed", str(fault_seed_replayed(
                    train, FAULT_FLAGS, SCANNED_STEPS, SCANNED_UNROLL))),
                {"obfuscate_update_krng": "obfuscate_krng_kernel",
                 "guarded_gossip_update": "guarded_kernel"})
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_scanned(
                torch, train, scanned_cfg, "ring_path_scanned", RING_FLAGS,
                {"ring_obfuscate_gossip_krng": "ring_krng_kernel"})
            gc.collect()
            torch.cuda.empty_cache()
        phase_baselines_path(torch, K, train, main_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        rows.update(phase_dropout_path(torch, K, train, prng, main_cfg))
        torch.cuda.empty_cache()
        rows.update(phase_fault_path(torch, K, train, prng, main_cfg))
        torch.cuda.empty_cache()
        rows.update(phase_ring_path(torch, K, train, prng, main_cfg))
        torch.cuda.empty_cache()
        if opts.profile:
            for path, extra in (
                    ("dropout_path", DROPOUT_FLAGS),
                    ("fault_path", (*FAULT_FLAGS, "--fault-seed",
                                    str(fault_seed(train, 6)[0]))),
                    ("ring_path", RING_FLAGS)):
                gc.collect()
                phase_profile(torch, train, main_cfg, path, extra)
                torch.cuda.empty_cache()
        bits_cfg = dataclasses.replace(full, num_layers=BITS_PATH_LAYERS)
        rows.update(phase_bits_path(torch, K, train, prng, bits_cfg))
        torch.cuda.empty_cache()
        rows.update(phase_ring_bits_path(torch, K, train, prng, bits_cfg))
        torch.cuda.empty_cache()
        phase_tree_forms(torch, K, prng, bits_cfg)
        leafwise = phase_leafwise_path(torch, K, train, bits_cfg)
        phase_trivial_mesh_step(torch, K, train, bits_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_step = phase_mesh_train_step(torch, K, train, bits_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        multihost = phase_multihost_path(torch, K, prng)
        phase_multihost_smoke(torch, K)
        gc.collect()
        torch.cuda.empty_cache()
        phase_privacy_capture_path(torch, K, train, prng, bits_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_parity(torch, serve)
        gc.collect()
        torch.cuda.empty_cache()
        stablelm_serve = phase_serve_path(torch, K, serve)
        if opts.profile:
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_serve(torch, serve)
        gc.collect()
        torch.cuda.empty_cache()
        phase_xlstm_step_parity(torch, K, train)
        xlstm_cfg = get_config("xlstm-125m")
        train_counts = phase_xlstm_train_path(
            torch, K, train, dataclasses.replace(
                xlstm_cfg, num_layers=XLSTM_TRAIN_LAYERS))
        torch.cuda.empty_cache()
        phase_xlstm_train_scanned(torch, K, train, dataclasses.replace(
            xlstm_cfg, num_layers=XLSTM_SCANNED_LAYERS))
        gc.collect()
        torch.cuda.empty_cache()
        if opts.profile:
            gc.collect()
            # one profiled step and two requests: the profiler's events of
            # the sLSTM loop's small ops take minutes to collect
            phase_profile(torch, train, xlstm_cfg, "xlstm_train_path",
                          steps=2, seq_len=XLSTM_TRAIN_SEQ)
            torch.cuda.empty_cache()
        phase_xlstm_serve_parity(torch, serve)
        gc.collect()
        torch.cuda.empty_cache()
        serve_counts = phase_xlstm_serve_path(torch, K, serve)
        if opts.profile:
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_serve(torch, serve, requests=2, gen=16,
                                path_args=XLSTM_SERVE_ARGS,
                                path="xlstm_serve_path")
        gc.collect()
        torch.cuda.empty_cache()
        phase_hybrid_step_parity(torch, K, train)
        hybrid_cfg = dataclasses.replace(get_config("zamba2-7b"),
                                         num_layers=HYBRID_TRAIN_LAYERS)
        hybrid_train = phase_hybrid_train_path(torch, K, train, hybrid_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        if opts.profile:
            phase_profile(torch, train, hybrid_cfg, "hybrid_train_path",
                          steps=3)
            gc.collect()
            torch.cuda.empty_cache()
        phase_hybrid_train_scanned(torch, K, train, hybrid_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_recompute_peak(torch, K, hybrid_cfg, "recompute_peak_hybrid")
        phase_hybrid_serve_parity(torch, serve)
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_serve = phase_hybrid_serve_path(torch, K, serve)
        if opts.profile:
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_serve(torch, serve, requests=4, gen=16,
                                path_args=HYBRID_SERVE_ARGS,
                                path="hybrid_serve_path")
        gc.collect()
        torch.cuda.empty_cache()
        phase_gqa_step_parity(torch, K, train)
        gqa_cfg = dataclasses.replace(get_config("chatglm3-6b"),
                                      num_layers=GQA_TRAIN_LAYERS)
        phase_gqa_train_path(torch, K, train, gqa_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_family_train_scanned(torch, K, train, gqa_cfg,
                                   "gqa_train_scanned")
        gc.collect()
        torch.cuda.empty_cache()
        phase_recompute_peak(torch, K, gqa_cfg, "recompute_peak_gqa")
        phase_moe_step_parity(torch, K, train)
        moe_cfg = get_config("granite-moe-1b-a400m")
        phase_moe_train_path(torch, K, train, moe_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        if opts.profile:
            phase_profile(torch, train, moe_cfg, "moe_train_path",
                          NEW_TRAIN_FLAGS, steps=3)
            gc.collect()
            torch.cuda.empty_cache()
        phase_family_train_scanned(torch, K, train, moe_cfg,
                                   "moe_train_scanned")
        gc.collect()
        torch.cuda.empty_cache()
        gqa_serve = phase_gqa_serve_path(torch, K, serve)
        if opts.profile:
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_serve(torch, serve, requests=4, gen=16,
                                path_args=GQA_SERVE_ARGS,
                                path="gqa_serve_path", cfg=gqa_serve_cfg())
        gc.collect()
        torch.cuda.empty_cache()
        moe_serve = phase_moe_serve_path(torch, K, serve)
        if opts.profile:
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_serve(torch, serve, requests=4, gen=16,
                                path_args=MOE_SERVE_ARGS,
                                path="moe_serve_path", cfg=moe_serve_cfg())
        gc.collect()
        torch.cuda.empty_cache()
        granite = phase_granite_prefill(torch, K)
        gc.collect()
        torch.cuda.empty_cache()
        phase_encdec_serve_parity(torch, K, serve)
        gc.collect()
        torch.cuda.empty_cache()
        encdec_serve = phase_encdec_serve_path(torch, K, serve)
        gc.collect()
        torch.cuda.empty_cache()
        phase_vlm_serve_parity(torch, serve)
        gc.collect()
        torch.cuda.empty_cache()
        vlm_serve = phase_vlm_serve_path(torch, K, serve)
        gc.collect()
        torch.cuda.empty_cache()
        if opts.profile:
            phase_profile_serve(torch, serve, gen=16,
                                path_args=ENCDEC_SERVE_ARGS,
                                path="encdec_serve_path")
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_serve(torch, serve, requests=4, gen=16,
                                path_args=VLM_SERVE_ARGS,
                                path="vlm_serve_path", cfg=vlm_cfg())
            gc.collect()
            torch.cuda.empty_cache()
        # B10's launches: the serve paths' runs and granite-8b's prefill;
        # B11's: the xLSTM and hybrid train and serve paths' runs
        rows["flash_attention"] = ({"flash_attention": sum(
            c.get("flash_attention", 0) for c in (
                stablelm_serve, hybrid_serve, gqa_serve, moe_serve,
                granite, encdec_serve, vlm_serve))}, b10)
        rows["ssd_intra_chunk"] = ({"ssd_intra_chunk": sum(
            c.get("ssd_intra_chunk", 0) for c in (
                train_counts, serve_counts, hybrid_train, hybrid_serve))},
            b11)
        # B1, B2, B4 and B6 also ran once per leaf in the leafwise runs,
        # and B1, B2, B4 and B7 in the mesh train step's forms
        for name in ("obfuscate_update", "gossip_update",
                     "masked_gossip_update", "guarded_gossip_update",
                     "ring_gossip_update"):
            counts, r = rows[name]
            rows[name] = ({**counts, name: counts.get(name, 0)
                           + leafwise.get(name, 0)
                           + mesh_step.get(name, 0)}, r)
        # B3 also ran in the multihost path's rank processes (their own
        # counts, summed by the launcher) and in its world=1 run
        counts, r = rows["obfuscate_update_krng"]
        rows["obfuscate_update_krng"] = ({**counts, "obfuscate_update_krng":
            counts.get("obfuscate_update_krng", 0) + sum(
                c.get("obfuscate_update_krng", 0)
                for c in (multihost["launches_world4"],
                          multihost["launches_world1"]))}, r)
        # each kernel's launches from its own path's runs, counted there
        # with the counts set to 0 just before each
        kernels = []
        for name, (counts, r) in rows.items():
            src, replaces = SOURCES[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts.get(name, 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        print(json.dumps({"kernels": kernels}), flush=True)
    # B10 at the serve shape against the library call of the same run
    print(json.dumps({"B10_serve_shape": {
        "shape": list(SERVE_ATTN_SHAPE), "ms": b10["ms"],
        "tflops": b10["tflops"], "sdpa_ms": b10["library_ms"],
        "sdpa_tflops": b10["library_tflops"],
        "ms_over_sdpa": b10["ms_over_library"]}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
