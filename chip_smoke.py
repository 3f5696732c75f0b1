#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, one printed line (or more) each:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — ``nvcc`` builds every kernel of the serving and training paths
   from ``src/repro_torch/csrc`` (7 sources, one process each, all at once);
3. kernels — each kernel at the serving path's shapes (kernel 3 also at a
   speculative verify pass, q [4, 5, 48, 128], each of whose rows must
   equal the one-row launch's bit for bit, and at an admission chunk, q
   [1, 180, 48, 128] after 4 cached pages, whose rows must equal the same
   rows of the chunk from position 0) and at small cases
   with window, softcap, ragged lengths, -1 page-table entries, head
   dims from 32 to 256 (40 zero-padded) and S = 300 with a group of 6, held
   against its plain PyTorch version on the card; kernel, plain and library
   times from CUDA events, and the kernel's and the library call's device
   times under torch.profiler (for calls this small the event time is the
   host's issue rate);
3b. ssm kernels — kernels 8 (RMSNorm; the gated norm with z fused in,
   bit for bit the kernel on PyTorch's y * silu(z)) and 9 (the SSD
   intra-chunk pass) at Mamba-2 1.3B's serving shapes (one 256-token
   prefill, generate's 4 x 512 batch, norms at a prefill and a decode tick)
   and at edge cases (L from 1 to 256, odd G, zero, underflowing and
   masked-overflowing decays; T in {1, 257}, D = 48, 12288 and 16384, z of
   +-100), against their plain versions;
4. check  — prefill-then-paged-decode logits against one full-sequence
   prefill of the same tokens;
5. serve  — grok-1-314b at its published widths (depth cut to 4 of 64
   layers), random weights from ``--seed``, serves 8 chat requests
   through ``ServeEngine`` twice: reconfiguration off, then on
   (the on-run permutes the expert weights in place).  Tokens must be
   bit-identical, the control plane must reconfigure, and the launch count
   of every serving kernel (1, 3 and 8: a paged admission runs its prompt as
   a decode-mode chunk through kernel 3, and kernel 8 every norm) must grow
   during the serve; the
   first pure decode tick of each serve runs under the profiler, which
   counts its kernels; then kernel 8 at every (T, D) the serve launched it
   at.  Three more serves, reconfiguration on: sampled (``sample=True,
   sample_seed=1``), speculative (``spec_k=4``, the topk1 draft) greedy,
   whose tokens must equal the first two serves' bit for bit, and
   speculative sampled, whose tokens must equal the sampled serve's; each
   prints tokens/s, its median decode tick, and for the speculative ones
   the acceptance, the median draft and verify times and the kernels one
   round's draft and verify launch (under the profiler); after each
   reconfiguring serve the experts are moved back to their own slots;
5b. fleet — the grok model is freed; grok-1 at its published widths, depth
   2, random weights from ``--seed``, three replica trees (two made by
   ``replica_params``: private experts, every other leaf shared), every
   replica ``ServeConfig(max_len=256, page_size=16, num_devices=4,
   external_control=True, num_regions=4)``; 8 agentic requests (10 new
   tokens, prompts up to 244) through the unsteered single replica (4
   slots) and through ``FleetEngine`` fleets of 1, 2 and 3 replicas (slots
   4, 2, 4) under each steering policy, reconfiguring every 4 fleet ticks,
   then 3 with a failure and with a drain/restore: every fleet's tokens
   equal the single replica's, every request completes, the locality runs
   reconfigure, and a replica a size-3 locality run left unmoved holds the
   initial experts bit for bit; the size-3 locality run is traced, the
   trace validated and summarised through ``repro_torch.measure_run``; then
   8 agentic_shared requests (shared prefixes) through the single replica
   and fleets of 3 (locality, round robin): tokens equal, prefix-cache hits
   that differ from the single replica's; per run completed, ticks, steer
   reasons, reconfigurations, TTFT, SLO attainment, tokens/s and the median
   fleet tick; the phase's seconds and peak memory;
5c. mamba2 — the fleet's model is freed; Mamba-2 1.3B at full width,
   random weights from ``--seed``: prefill 200 tokens and decode 56 one at
   a time against one 256-token prefill (every decoded position's logits),
   held in f32 at all 48 layers and in bf16 at 2 (in bf16 at 48 random
   layers rounding grows chaotically: measured, beside the distance
   between two prefills of different chunk length); each row of a 4 x 512
   prefill against a batch-1 prefill, in f32 at 48 layers; in bf16 at all
   48 layers, 8 chat requests served twice through
   ``ServeEngine(ServeConfig(slots=4, max_len=256))``, tokens
   bit-identical and kernel launches exactly as predicted from the prompts
   and ticks, decode tick against its bytes bound; greedy ``generate`` of
   16 tokens for 4 prompts of 512 (two chunks), its first tokens the
   prefill step's; sampled ``generate`` of the same, twice with seed 1
   (bit-identical) and once with seed 2 (different); then a reduced f32
   prefill and decode step on the card against the CPU;
6. train kernels — every training-path kernel
   (MoE dispatch at the send gather, the pack and the unpack; the combine
   in f32 and, as the send gather's backward, in bf16; the dropless
   grouped GEMM; and the backward
   kernels of the combine, the GEMM (dX, dW), the gate, the norm and
   attention; kernel 8 forward) at
   the Mixtral-8x7B training step's shapes (the grouped GEMM and its dX and
   dW at the w_in and w_out shapes, its forward and dW also at a skewed
   plan, 3/8 of the choices on each of two experts) and at small edge
   cases (experts of more than 256 rows, every row in one expert, K and N
   off the tiles, head dims 32 to 192, S = 300 with a group of 6), against
   its plain version (a
   backward against ``torch.autograd`` of the plain forward); event and
   device times as in phase 3;
7. capacity kernels — kernel 6 (the capacity-layout grouped GEMM) and its
   dX and dW at the capacity step's w_in shapes, built from a real
   two-stage capacity plan (empty send rows, empty expert slots), the same
   three at the w_out shapes, and edge cases (C in {4, 12, 20, 200, 257,
   260, 300, 520}, E = 1, an all-zero expert, f32 and bf16, K and N off
   the tiles), against the plain versions and ``torch.autograd``;
   ``torch.bmm`` as the library yardstick;
8. step   — one training step's loss and EVERY parameter's gradient at a
   reduced width (2 layers, d_model 512, 8 experts of d_ff 1024, f32,
   remat "full"), on the card (kernels) against the CPU (plain versions),
   dropless and with capacity dispatch at a capacity factor that drops;
9. remat  — Mixtral-8x7B at its published widths (2 of 32 layers): one
   forward and backward with remat "none", "full" and "dots" on the same
   weights and batch; loss and every gradient bit-identical, forward
   kernels launched twice under remat; peak memory of each;
10. train — Mixtral-8x7B at its published widths (depth cut to 2 of 32
   layers), random weights from ``--seed``, ``remat="full"`` as configured,
   trains 8 steps through ``Trainer`` with a 4-device control plane
   injected (COPILOT on, a reconfiguration every 2 steps), one ``train``
   call per step, each clocked whole: the step (the trainer's own clock)
   and what follows it (the control loop and the in-place permute).  Every
   loss must be finite, at least one reconfiguration must apply, and every
   training kernel must launch.  Then every applied reconfiguration is
   replayed on the trained weights: a fixed probe batch's loss and expert
   gradients just before and just after the same in-place move must be
   bit-identical once the permutation is undone;
11. train capacity — the same run with ``dispatch="capacity"`` (capacity
   factor 1.25), the dropped fraction printed per step, the trainer
   writing a 31.6 GB checkpoint at step 4 under build/ (it needs that much
   free on the disk and one leaf, up to 3.8 GB, in host memory);
12. resume — a fresh trainer restores that checkpoint: the state must
   equal the saved one and step 5 on the same batch must equal the
   uninterrupted run's, bit for bit; write and read GB/s; the checkpoint
   is removed;
13. serve checkpoint — reduced grok-1 saved mid-reconfiguration and
   restored into a fresh engine gives bit-identical next tokens;
13b. dense — gemma2-2b at its published widths and all 26 layers (local /
   global attention with a 4096-token window, softcaps 50 and 30, head dim
   256, GEGLU, a tied head), random weights from ``--seed``: kernels 2 (and
   its backward, the f32-staged kernels at D = 256) and 8 (and its
   backward) at its training shapes against their plain versions; 6
   training steps of 2 x 256 tokens through ``Trainer`` (no control plane),
   losses finite, peak memory under 80 GB; one reduced step (2 layers,
   d_model 256, head dim 256, window 32 of 64 tokens, f32) on the card
   against the CPU; the 8 chat requests served (paged), a prefix hit whose
   admission logits and tokens equal a miss's bit for bit, decode against
   prefill; one 4,608-token prompt (the window binds on the 13 local
   layers): the prefill's logits (kernel 2) against its paged decode-mode
   admission (kernel 3), and kernel 3 at that chunk against its plain
   version and against kernel 2 on the same K/V; then deepseek-7b (all 30
   layers), deepseek-67b and mistral-large-123b (depth cut to 2) each
   served 4 requests and held decode against prefill; kernel 3 at
   deepseek-7b's group of 1 and kernel 8 at mistral-large's D = 12288;
   the phase's seconds and peak memory;
14. multi-rank — Mixtral-8x7B at its published widths as four ranks
   sharing the card (``torch.multiprocessing``, spawn; gloo, with the
   collectives gloo refuses on CUDA tensors staged through host memory and
   counted): first, in this process, the one-device runs the ranks are held
   to; then on a ``(1, 4)`` ``("data", "model")`` mesh with
   ``a2a_group=2`` (the delegation all-to-all, 2 groups of 2), depth 2, 4
   steps with two plans applied before the first: a whole-device-block
   swap on layer 0 (a wire re-address) and a cross-block slot swap on layer
   1 (expert weights moved across ranks), once through the wire path (the
   main path, launches counted per rank) and once forced through the weight
   path; then a ``(2, 2)`` mesh at depth 1, 4 steps.  Wire and weight runs
   equal bit for bit (losses and every parameter), non-expert parameters
   bit-identical across ranks, losses within 1e-4 relative of one device;
   per-rank step times, wire and host-staged bytes per step, peak memory,
   launches; kernels 4, 5 and 7 timed at one rank's shapes;
14b. pipeline — Mixtral-8x7B at its published widths, depth 2, as two
   pipeline stages of two model ranks (a ``(2, 2)`` ``("stage",
   "model")`` mesh, the same four ranks on the card): first, in this
   process, the flat one-device trainer with 4 microbatches the ranks are
   held to; then 4 steps of 4 x 256 tokens in 4 microbatches of 1 x 256
   through ``Trainer(pp_stages=2)``, with a plan per stage applied before
   the first (layer 0: a weight move across stage 0's ranks; layer 1: a
   wire re-address of stage 1's), launches counted per rank.  Losses
   within 1e-4 relative of one device and equal on every rank, each plan
   counted on its own stage, non-expert parameters bit-identical in each
   stage's model group; per-rank step times, stage-to-stage, wire and
   host-staged bytes, peak memory, launches, the GPipe bubble fraction
   (not measurable on one card); kernel 7 timed at a stage rank's shape;
14c. evaluation — around the multi-rank phase: first, on the host, the
   paper's headline through the port's netsim (Mixtral-8x7B on 128
   servers, MixNet against fat-tree at 100 and 400 Gbps, 5 iterations;
   MixNet's performance per dollar over fat-tree's must exceed 1.2 and 1.9
   and grow with the rate; every number the simulator's A100 cluster, not
   the card), ``autotune.tune`` over the full search space into a cache
   under build/, and a cache miss on the card (the config stays, the miss
   is counted); then, in the four ranks after their runs, the (1, 4) wire
   run again with ``TrainerConfig(autotune_cache=, autotune_key=)``: the
   trainer must take the cache's knobs, and its losses and every parameter
   must equal the one-chunk run's (the wire run when the tuned dispatch is
   dropless) bit for bit, every kernel launched on every rank; per-rank
   step times tuned against one chunk, wire bytes, launches, kernel 7 at
   one tuned chunk's received layout;
15. the kernels of one decode tick of each serve, the sha256 of each
   serve's tokens (to set beside another tree's), the kernels line (JSON),
   the card line, and the result line ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA card or outside a
checkout of the repository.  Every failure propagates.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"
if (SRC / "repro_torch" / "csrc").is_dir():  # else main() refuses to run
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.timing import (
        HBM_BYTES_PER_S, bound_ms, card_line, device_ms, graph_ms, time_ms, trace_decode_tick,
    )

BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)  # torch.testing bf16 defaults
F32_TOL = dict(rtol=1.3e-6, atol=1e-5)  # torch.testing f32 defaults
# f32 sums over thousands of terms in another order than the plain version.
REDUCE_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 attention gradients: the kernel takes delta from the bf16-rounded
# output, the plain version from the f32 one; 2e-2 of the largest magnitude.
BF16_GRAD_REL = 2e-2
# bf16 grouped GEMMs and their gradients: f32 sums over up to 14336 products
# in another order, rounded once to bf16, where results near 0 come from
# cancellation; 1e-2 of the largest magnitude (a bf16 ulp there is 0.4%).
BF16_GEMM_REL = 1e-2
# Kernel 8's dw: f32 sums over the step's 512 rows in another order than
# autograd's, rounded once to bf16: 1e-2 of the largest magnitude.
NORM_DW_REL = 1e-2
LAYERS = 4  # of grok-1's 64: 42.6 GB of weights on an 80 GB card
SPEC_K = 4  # draft tokens a speculative round (the verify pass scores k + 1)
CHUNK_ROWS = 180  # kernel 3's admission-chunk row: a 244-token prompt after 4 cached pages
REQUESTS = 8
TRAIN_LAYERS = 2  # of Mixtral-8x7B's 32: 3.17 B parameters, 38 GB with grads and f32 moments
TRAIN_STEPS = 8
# A paged admission runs the prompt as a decode-mode chunk (kernel 3), so
# serving grok-1 launches no kernel 2.
SERVE_KERNELS = ("topk_gating", "paged_flash_decode", "rmsnorm")

KERNEL_ROWS = {
    "topk_gating": ("src/repro_torch/csrc/topk_gating.cu", "src/repro/kernels/topk_gating.py:44"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:105"),
    "paged_flash_decode": ("src/repro_torch/csrc/paged_flash_decode.cu",
                           "src/repro/kernels/flash_attention.py:226"),
    "moe_dispatch": ("src/repro_torch/csrc/moe_dispatch.cu", "src/repro/kernels/moe_dispatch.py:49"),
    "moe_combine": ("src/repro_torch/csrc/moe_dispatch.cu", "src/repro/kernels/moe_dispatch.py:89"),
    # Kernel 4 at the dropless plan's pack (with zero padding rows) and
    # unpack, kernel 5 at the send gather's backward (unit weights, bf16 out):
    # the same kernels at other shapes of the path (SHAPE_ROWS).
    "moe_dispatch_pack": ("src/repro_torch/csrc/moe_dispatch.cu",
                          "src/repro/kernels/moe_dispatch.py:49"),
    "moe_dispatch_unpack": ("src/repro_torch/csrc/moe_dispatch.cu",
                            "src/repro/kernels/moe_dispatch.py:49"),
    "moe_combine_bf16": ("src/repro_torch/csrc/moe_dispatch.cu",
                         "src/repro/kernels/moe_dispatch.py:89"),
    "grouped_matmul_blocks": ("src/repro_torch/csrc/grouped_matmul.cu",
                              "src/repro/kernels/grouped_matmul.py:116"),
    # Backward kernels: the JAX package has no VJP on its Pallas kernels (it
    # differentiates the jnp references); "replaces" names the forward.
    "moe_combine_bwd": ("src/repro_torch/csrc/moe_dispatch.cu",
                        "src/repro/kernels/moe_dispatch.py:89"),
    "grouped_matmul_blocks_dx": ("src/repro_torch/csrc/grouped_matmul.cu",
                                 "src/repro/kernels/grouped_matmul.py:116"),
    "grouped_matmul_blocks_dw": ("src/repro_torch/csrc/grouped_matmul.cu",
                                 "src/repro/kernels/grouped_matmul.py:116"),
    "topk_gating_bwd": ("src/repro_torch/csrc/topk_gating.cu", "src/repro/kernels/topk_gating.py:44"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:105"),
    "grouped_matmul": ("src/repro_torch/csrc/grouped_matmul.cu",
                       "src/repro/kernels/grouped_matmul.py:62"),
    "grouped_matmul_dx": ("src/repro_torch/csrc/grouped_matmul.cu",
                          "src/repro/kernels/grouped_matmul.py:62"),
    "grouped_matmul_dw": ("src/repro_torch/csrc/grouped_matmul.cu",
                          "src/repro/kernels/grouped_matmul.py:62"),
    # Kernel 6 and its dX again at the w_out shapes: the same kernels, so the
    # same launch counts (each wrapper counts its launches at every shape).
    "grouped_matmul_wout": ("src/repro_torch/csrc/grouped_matmul.cu",
                            "src/repro/kernels/grouped_matmul.py:62"),
    "grouped_matmul_dx_wout": ("src/repro_torch/csrc/grouped_matmul.cu",
                               "src/repro/kernels/grouped_matmul.py:62"),
    # Kernel 7 and its dX and dW at the w_out shapes, kernel 7 and its dW at
    # a skewed plan, and kernel 6's dW at the w_out shapes (SHAPE_ROWS).
    "grouped_matmul_blocks_wout": ("src/repro_torch/csrc/grouped_matmul.cu",
                                   "src/repro/kernels/grouped_matmul.py:116"),
    "grouped_matmul_blocks_dx_wout": ("src/repro_torch/csrc/grouped_matmul.cu",
                                      "src/repro/kernels/grouped_matmul.py:116"),
    "grouped_matmul_blocks_dw_wout": ("src/repro_torch/csrc/grouped_matmul.cu",
                                      "src/repro/kernels/grouped_matmul.py:116"),
    "grouped_matmul_blocks_skew": ("src/repro_torch/csrc/grouped_matmul.cu",
                                   "src/repro/kernels/grouped_matmul.py:116"),
    "grouped_matmul_blocks_dw_skew": ("src/repro_torch/csrc/grouped_matmul.cu",
                                      "src/repro/kernels/grouped_matmul.py:116"),
    "grouped_matmul_dw_wout": ("src/repro_torch/csrc/grouped_matmul.cu",
                               "src/repro/kernels/grouped_matmul.py:62"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu", "src/repro/kernels/ssd_chunk.py:50"),
    # Kernel 3 at a long context; kernel 9 at a 256-token prefill and at
    # generate's batch; kernel 8 at its other shapes of the Mamba-2 serve
    # (SHAPE_ROWS; "rmsnorm" is the prefills' gated norm).
    "paged_flash_decode_long": ("src/repro_torch/csrc/paged_flash_decode.cu",
                                "src/repro/kernels/flash_attention.py:226"),
    # Kernel 3 at a speculative verify pass (C = k + 1), with the launches
    # at that shape of the greedy speculative serve.
    "paged_flash_decode_verify": ("src/repro_torch/csrc/paged_flash_decode.cu",
                                  "src/repro/kernels/flash_attention.py:226"),
    # Kernel 3 at an admission chunk (a prefix-cache hit's remainder), with
    # the grok serve's launches at B = 1 (every admission's chunk).
    "paged_flash_decode_chunk": ("src/repro_torch/csrc/paged_flash_decode.cu",
                                 "src/repro/kernels/flash_attention.py:226"),
    "ssd_chunk_prefill_256": ("src/repro_torch/csrc/ssd_chunk.cu",
                              "src/repro/kernels/ssd_chunk.py:50"),
    "ssd_chunk_generate": ("src/repro_torch/csrc/ssd_chunk.cu",
                           "src/repro/kernels/ssd_chunk.py:50"),
    "rmsnorm_prefill_d": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    "rmsnorm_decode_inner": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    "rmsnorm_decode_d": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    # Kernel 8 at the grok-1 serve's shapes and at Mixtral's training step
    # (SHAPE_ROWS), and its backward (the JAX package differentiates its jnp
    # reference; "replaces" names the forward).
    "rmsnorm_grok": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    "rmsnorm_mixtral": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    # Kernels 4, 7 and 5 at one rank's shapes of the (1, 4) multi-rank run:
    # the received layout packed into 2-expert blocks, those blocks, the
    # return trip combined (SHAPE_ROWS), with rank 0's launches there.
    "moe_dispatch_rank_pack": ("src/repro_torch/csrc/moe_dispatch.cu",
                               "src/repro/kernels/moe_dispatch.py:49"),
    "grouped_matmul_blocks_rank": ("src/repro_torch/csrc/grouped_matmul.cu",
                                   "src/repro/kernels/grouped_matmul.py:116"),
    "moe_combine_rank": ("src/repro_torch/csrc/moe_dispatch.cu",
                         "src/repro/kernels/moe_dispatch.py:89"),
    # Kernel 7 at a stage rank's shapes of the (2, 2) pipeline run (4 local
    # experts, one 1 x 256 microbatch received), with rank 0's launches.
    "grouped_matmul_blocks_stage": ("src/repro_torch/csrc/grouped_matmul.cu",
                                    "src/repro/kernels/grouped_matmul.py:116"),
    # Kernel 7 at one chunk's received layout of the tuned (1, 4) run (the
    # evaluation phase's), with rank 0's launches there.
    "grouped_matmul_blocks_chunk": ("src/repro_torch/csrc/grouped_matmul.cu",
                                    "src/repro/kernels/grouped_matmul.py:116"),
    # The dense phase: kernels 2 (and its backward: the f32-staged kernels at
    # D = 256) and 8 (and its backward) at gemma2-2b's training shapes, with
    # its launches; kernel 3 at gemma2's decode tick, at a 4,608-token
    # admission chunk and at deepseek-7b's group of 1; kernel 8 at the
    # mistral-large serve's shapes (D = 12288: the two-read kernel).
    "flash_attention_gemma2": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:105"),
    "flash_attention_bwd_gemma2": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:105"),
    "rmsnorm_gemma2": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    "rmsnorm_bwd_gemma2": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
    "paged_flash_decode_gemma2": ("src/repro_torch/csrc/paged_flash_decode.cu",
                                  "src/repro/kernels/flash_attention.py:226"),
    "paged_flash_decode_gemma2_admit": ("src/repro_torch/csrc/paged_flash_decode.cu",
                                        "src/repro/kernels/flash_attention.py:226"),
    "paged_flash_decode_group1": ("src/repro_torch/csrc/paged_flash_decode.cu",
                                  "src/repro/kernels/flash_attention.py:226"),
    "rmsnorm_mistral": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30"),
}
# End-to-end numbers the serve phases leave for the summary line (measured,
# not claimed: they move with the host).
E2E: dict = {}
# sha256 of each serve's tokens (request id -> tokens), to set beside another
# tree's.
TOKENS_SHA256: dict = {}


def tokens_sha256(toks: dict) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(sorted(toks.items())).encode()).hexdigest()


def check(torch, got, want, tol, what: str) -> float:
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{what}: {m}")
    return err


def check_rel(got, want, rel: float, what: str) -> float:
    """max |got - want| <= rel * max |want|; returns max |got - want|."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= rel * scale + 1e-6, f"{what}: max |diff| {err} > {rel} x max |want| {scale}"
    return err


def library_time(torch, fn, want, rel: float, iters: int, what: str):
    """(CUDA-event time, the call) of one PyTorch library call that computes
    the same function as a kernel, after checking it does (``check_rel`` at
    ``rel``).  A call this build refuses on these inputs is reported, with
    its error, as (None, None): the library is a yardstick here, not part of
    the path."""
    try:
        check_rel(fn(), want, rel, f"library {what}")
    except (RuntimeError, NotImplementedError, TypeError, AttributeError, AssertionError) as exc:
        print(f"library {what}: refused: {type(exc).__name__}: {str(exc)[:300]}", flush=True)
        return None, None
    return time_ms(torch, fn, iters), fn


def kernel_row(torch, name, err, kernel, iters, plain, library, bytes_moved, flops, dtype, shape,
               graph: bool = False):
    """One row of the kernels line.  ``kernel``: the wrapper's call, timed
    by CUDA events over ``iters`` back-to-back calls; ``library``:
    (CUDA-event time, call) of the library yardstick, or NO_LIBRARY.  Both
    calls are also timed under the profiler: device time, which for calls
    this small is what the card spends (the event time is the host's issue
    rate).  ``graph``: also the wall time per call in a CUDA graph of 20
    calls (``graph_ms``: for a call of two kernels that overlap, whose
    profiler times sum the overlap twice)."""
    lib, lib_fn = library
    bms, by = bound_ms(bytes_moved, flops, dtype)
    ms = time_ms(torch, kernel, iters)
    dev, _ = device_ms(torch, kernel)
    lib_dev = None if lib_fn is None else device_ms(torch, lib_fn)[0]
    r = dict(max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=bms, bound_by=by,
             library_ms=lib, library_device_ms=lib_dev, shape=shape)
    if graph:
        r["graph_ms"] = graph_ms(torch, kernel)
    fmt = lambda v: "null" if v is None else f"{v:.5f}"  # noqa: E731
    print(f"kernel {name} ({shape}): max_abs_err={err:.3e} kernel_ms={ms:.5f} "
          f"device_ms={dev:.5f} plain_ms={plain:.5f} library_ms={fmt(lib)} "
          f"library_device_ms={fmt(lib_dev)} bound_ms={bms:.6f} ({by})"
          + (f" graph_ms={r['graph_ms']:.5f}" if graph else ""), flush=True)
    return r


def timed(torch, fn, iters: int):
    """(CUDA-event time, fn): a library yardstick whose equivalence needs no
    check (the kernel's own check covers it)."""
    return time_ms(torch, fn, iters), fn


NO_LIBRARY = (None, None)


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------


def page_table_for(torch, lengths, c: int, page: int, max_pages: int, num_pages: int, gen):
    """A permuted page table covering positions < t + C of each row, -1 past it."""
    b = len(lengths)
    perm = torch.randperm(num_pages, generator=gen)[: b * max_pages].reshape(b, max_pages)
    used = torch.tensor([-(-(t + c) // page) for t in lengths])
    table = torch.where(torch.arange(max_pages)[None, :] < used[:, None], perm, -1)
    return table.to(torch.int32)


def kernel_phase(torch, cfg, prompt_lens, slots: int, page: int, max_len: int, seed: int):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, paged_flash_decode_cuda
    from repro_torch.kernels.topk_gating import topk_gating_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    cpu_g = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = {}

    # -- topk_gating at a decode tick's shape: [live slots, E] f32, k = top_k.
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = torch.randn((slots, e), generator=g, device=dev)
    w, i = topk_gating_cuda(logits, k)
    rw, ri = ref.topk_gating(logits, k)
    assert torch.equal(i, ri), "topk_gating ids differ from the plain version"
    rows["topk_gating"] = kernel_row(
        torch, "topk_gating", check(torch, w, rw, F32_TOL, "topk_gating"),
        lambda: topk_gating_cuda(logits, k), 200,
        time_ms(torch, lambda: ref.topk_gating(logits, k), 200),
        timed(torch, lambda: torch.topk(torch.softmax(logits, -1), k, dim=-1), 200),
        slots * e * 4 + slots * k * 8, slots * e * (5 + k), "float32",
        f"logits [{slots}, {e}] f32, k={k}",
    )

    # -- flash_attention at the longest prompt's prefill: q [1, Hq, S, D] bf16.
    s = max(prompt_lens)
    q = torch.randn((1, hq, s, d), generator=g, device=dev).to(bf16)
    kk = torch.randn((1, hkv, s, d), generator=g, device=dev).to(bf16)
    vv = torch.randn((1, hkv, s, d), generator=g, device=dev).to(bf16)
    out = flash_attention_cuda(q, kk, vv, causal=True)
    err = check(torch, out, ref.flash_attention(q, kk, vv, causal=True), BF16_TOL, "flash_attention")
    kx = kk.repeat_interleave(hq // hkv, dim=1)
    vx = vv.repeat_interleave(hq // hkv, dim=1)
    pairs = s * (s + 1) / 2
    rows["flash_attention"] = kernel_row(
        torch, "flash_attention", err, lambda: flash_attention_cuda(q, kk, vv, causal=True), 50,
        time_ms(torch, lambda: ref.flash_attention(q, kk, vv, causal=True), 20),
        timed(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True), 50),
        2 * (2 * hq + 2 * hkv) * s * d, 4 * hq * d * pairs, "bfloat16",
        f"q [1, {hq}, {s}, {d}] bf16 causal",
    )

    # -- paged_flash_decode at a decode tick: q [slots, 1, Hq, D] over the pool.
    max_pages = -(-max_len // page)
    num_pages = slots * max_pages
    lengths = [min(n, max_len - 1) for n in prompt_lens[:slots]]
    table = page_table_for(torch, lengths, 1, page, max_pages, num_pages, cpu_g).to(dev)
    tvec = torch.tensor(lengths, dtype=torch.int32, device=dev)
    qd = torch.randn((slots, 1, hq, d), generator=g, device=dev).to(bf16)
    kp = torch.randn((num_pages, page, hkv, d), generator=g, device=dev).to(bf16)
    vp = torch.randn((num_pages, page, hkv, d), generator=g, device=dev).to(bf16)
    out = paged_flash_decode_cuda(qd, kp, vp, table, tvec)
    err = check(torch, out, ref.paged_flash_decode(qd, kp, vp, table, tvec), BF16_TOL,
                "paged_flash_decode")
    plain = time_ms(torch, lambda: ref.paged_flash_decode(qd, kp, vp, table, tvec), 20)
    pos = torch.arange(max_pages * page, device=dev)
    mask = pos[None, None, None, :] <= tvec[:, None, None, None]  # [B, 1, 1, L]

    def sdpa_paged():
        vk = ref.paged_gather_kv(kp, table).transpose(1, 2)
        vv_ = ref.paged_gather_kv(vp, table).transpose(1, 2)
        return F.scaled_dot_product_attention(qd.transpose(1, 2), vk, vv_, attn_mask=mask,
                                              enable_gqa=True)

    kv_bytes = sum((t + 1) * hkv * d * 2 * 2 for t in lengths)
    rows["paged_flash_decode"] = kernel_row(
        torch, "paged_flash_decode", err, lambda: paged_flash_decode_cuda(qd, kp, vp, table, tvec),
        200, plain, timed(torch, sdpa_paged, 100),
        2 * slots * hq * d * 2 + kv_bytes + table.numel() * 4 + slots * 4,
        sum(4 * hq * d * (t + 1) for t in lengths), "bfloat16",
        f"q [{slots}, 1, {hq}, {d}] bf16, pool [{num_pages}, {page}, {hkv}, {d}], t={lengths}",
    )

    # -- paged_flash_decode at a speculative verify pass: q [slots, k + 1, Hq,
    # D] over the same pool, row c attending positions <= t + c.
    c = SPEC_K + 1
    lengths = [min(n, max_len - c) for n in prompt_lens[:slots]]
    table = page_table_for(torch, lengths, c, page, max_pages, num_pages, cpu_g).to(dev)
    tvec = torch.tensor(lengths, dtype=torch.int32, device=dev)
    qv = torch.randn((slots, c, hq, d), generator=g, device=dev).to(bf16)
    out = paged_flash_decode_cuda(qv, kp, vp, table, tvec)
    err = check(torch, out, ref.paged_flash_decode(qv, kp, vp, table, tvec), BF16_TOL,
                "paged_flash_decode verify")
    for j in range(c):  # each row is the one-row launch's, bit for bit
        one = paged_flash_decode_cuda(qv[:, j : j + 1].contiguous(), kp, vp, table, tvec + j)
        assert torch.equal(one[:, 0], out[:, j]), f"kernel 3: verify row {j} != its C = 1 launch"
    verify_mask = (pos[None, None, None, :]
                   <= (tvec[:, None] + torch.arange(c, device=dev)[None, :])[:, None, :, None])

    def sdpa_verify():
        vk = ref.paged_gather_kv(kp, table).transpose(1, 2)
        vv_ = ref.paged_gather_kv(vp, table).transpose(1, 2)
        return F.scaled_dot_product_attention(qv.transpose(1, 2), vk, vv_, attn_mask=verify_mask,
                                              enable_gqa=True)

    rows["paged_flash_decode_verify"] = kernel_row(
        torch, "paged_flash_decode_verify", err,
        lambda: paged_flash_decode_cuda(qv, kp, vp, table, tvec), 200,
        time_ms(torch, lambda: ref.paged_flash_decode(qv, kp, vp, table, tvec), 20),
        timed(torch, sdpa_verify, 100),
        2 * slots * c * hq * d * 2 + sum((t + c) * hkv * d * 2 * 2 for t in lengths)
        + table.numel() * 4 + slots * 4,
        sum(4 * hq * d * (t + j + 1) for t in lengths for j in range(c)), "bfloat16",
        f"q [{slots}, {c}, {hq}, {d}] bf16, pool [{num_pages}, {page}, {hkv}, {d}], t={lengths}",
    )

    # -- paged_flash_decode at an admission chunk: q [1, C, Hq, D], the
    # prompt's last C rows after 4 cached pages (a prefix-cache hit), row c
    # at t + c; each row must equal the same row of the chunk from position
    # 0 (a miss) bit for bit.
    t0_, c = 4 * page, CHUNK_ROWS
    table = page_table_for(torch, [0], t0_ + c, page, max_pages, num_pages, cpu_g).to(dev)
    tvec = torch.tensor([t0_], dtype=torch.int32, device=dev)
    qm = torch.randn((1, t0_ + c, hq, d), generator=g, device=dev).to(bf16)
    qc = qm[:, t0_:].contiguous()
    out = paged_flash_decode_cuda(qc, kp, vp, table, tvec)
    err = check(torch, out, ref.paged_flash_decode(qc, kp, vp, table, tvec), BF16_TOL,
                "paged_flash_decode chunk")
    miss = paged_flash_decode_cuda(qm, kp, vp, table, tvec - t0_)
    assert torch.equal(miss[:, t0_:], out), "kernel 3: a hit's chunk rows != the miss's rows"
    chunk_mask = (pos[None, None, None, :]
                  <= (t0_ + torch.arange(c, device=dev))[None, None, :, None])

    def sdpa_chunk():
        vk = ref.paged_gather_kv(kp, table).transpose(1, 2)
        vv_ = ref.paged_gather_kv(vp, table).transpose(1, 2)
        return F.scaled_dot_product_attention(qc.transpose(1, 2), vk, vv_, attn_mask=chunk_mask,
                                              enable_gqa=True)

    rows["paged_flash_decode_chunk"] = kernel_row(
        torch, "paged_flash_decode_chunk", err,
        lambda: paged_flash_decode_cuda(qc, kp, vp, table, tvec), 200,
        time_ms(torch, lambda: ref.paged_flash_decode(qc, kp, vp, table, tvec), 20),
        timed(torch, sdpa_chunk, 100),
        2 * c * hq * d * 2 + (t0_ + c) * hkv * d * 2 * 2 + table.numel() * 4 + 4,
        sum(4 * hq * d * (t0_ + j + 1) for j in range(c)), "bfloat16",
        f"q [1, {c}, {hq}, {d}] bf16 after {t0_} cached positions, pool [{num_pages}, {page}, "
        f"{hkv}, {d}]",
    )

    # -- paged_flash_decode at a long context: every slot at t = 4095, a pool
    # of 1024 pages (67 MB of K/V read).
    long_t, long_pages = 4095, 1024
    width = -(-(long_t + 1) // page)
    lengths = [long_t] * slots
    table = page_table_for(torch, lengths, 1, page, width, long_pages, cpu_g).to(dev)
    tvec = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kp = torch.randn((long_pages, page, hkv, d), generator=g, device=dev).to(bf16)
    vp = torch.randn((long_pages, page, hkv, d), generator=g, device=dev).to(bf16)
    out = paged_flash_decode_cuda(qd, kp, vp, table, tvec)
    err = check(torch, out, ref.paged_flash_decode(qd, kp, vp, table, tvec), BF16_TOL,
                "paged_flash_decode long context")
    pos = torch.arange(width * page, device=dev)
    long_mask = pos[None, None, None, :] <= tvec[:, None, None, None]

    def sdpa_long():
        vk = ref.paged_gather_kv(kp, table).transpose(1, 2)
        vv_ = ref.paged_gather_kv(vp, table).transpose(1, 2)
        return F.scaled_dot_product_attention(qd.transpose(1, 2), vk, vv_, attn_mask=long_mask,
                                              enable_gqa=True)

    rows["paged_flash_decode_long"] = kernel_row(
        torch, "paged_flash_decode_long", err,
        lambda: paged_flash_decode_cuda(qd, kp, vp, table, tvec), 50,
        time_ms(torch, lambda: ref.paged_flash_decode(qd, kp, vp, table, tvec), 3),
        timed(torch, sdpa_long, 20),
        2 * slots * hq * d * 2 + slots * (long_t + 1) * hkv * d * 2 * 2 + table.numel() * 4
        + slots * 4,
        4.0 * hq * d * (long_t + 1) * slots, "bfloat16",
        f"q [{slots}, 1, {hq}, {d}] bf16, pool [{long_pages}, {page}, {hkv}, {d}], t={lengths}",
    )
    del kp, vp
    edge_cases(torch, g, cpu_g)
    return rows


def edge_cases(torch, g, cpu_g):
    """Window, softcap, ragged S, -1 table entries and C > 1, at head dims 32
    to 256 (40 zero-padded to the kernels' 64), and S = 300 at D = 128 with
    a group of 6, in f32 and bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, paged_flash_decode_cuda
    from repro_torch.kernels.topk_gating import topk_gating_cuda

    dev = torch.device("cuda")
    logits = torch.randn((45, 160), generator=g, device=dev)
    logits[0] = 0.5  # an all-tied row: ids must be 0..k-1
    w, i = topk_gating_cuda(logits, 6)
    rw, ri = ref.topk_gating(logits, 6)
    assert torch.equal(i, ri) and i[0].tolist() == list(range(6)), "topk tie order"
    errs = [check(torch, w, rw, F32_TOL, "topk_gating edge")]
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for d in (32, 40, 64, 96, 128, 192, 256):  # 40: zero-padded to the 64 kernel
            q = torch.randn((2, 6, 77, d), generator=g, device=dev).to(dt)
            k = torch.randn((2, 2, 77, d), generator=g, device=dev).to(dt)
            v = torch.randn((2, 2, 77, d), generator=g, device=dev).to(dt)
            for kw in (dict(causal=True, window=33, softcap=30.0), dict(causal=False)):
                got = flash_attention_cuda(q, k, v, **kw)
                errs.append(check(torch, got, ref.flash_attention(q, k, v, **kw), tol,
                                  f"flash_attention edge {dt} D={d} {kw}"))
        # Several key tiles and a ragged tail at grok-1's group of 6.
        q = torch.randn((1, 12, 300, 128), generator=g, device=dev).to(dt)
        k = torch.randn((1, 2, 300, 128), generator=g, device=dev).to(dt)
        v = torch.randn((1, 2, 300, 128), generator=g, device=dev).to(dt)
        for kw in (dict(causal=True), dict(causal=True, window=100, softcap=30.0),
                   dict(causal=False)):
            got = flash_attention_cuda(q, k, v, **kw)
            errs.append(check(torch, got, ref.flash_attention(q, k, v, **kw), tol,
                              f"flash_attention edge {dt} S=300 GQA 6 {kw}"))
        for c, hd in ((1, 128), (2, 128), (5, 128), (2, 32), (2, 40), (1, 96), (2, 192)):
            lengths = [37, 20, 3]
            table = page_table_for(torch, lengths, c, 8, 7, 30, cpu_g).to(dev)
            tvec = torch.tensor(lengths, dtype=torch.int32, device=dev)
            qd = torch.randn((3, c, 6, hd), generator=g, device=dev).to(dt)
            kp = torch.randn((30, 8, 2, hd), generator=g, device=dev).to(dt)
            vp = torch.randn((30, 8, 2, hd), generator=g, device=dev).to(dt)
            for kw in ({}, dict(window=12, softcap=25.0)):
                got = paged_flash_decode_cuda(qd, kp, vp, table, tvec, **kw)
                errs.append(check(torch, got, ref.paged_flash_decode(qd, kp, vp, table, tvec, **kw),
                                  tol, f"paged_flash_decode edge {dt} C={c} D={hd} {kw}"))
    torch.cuda.synchronize()
    print(f"kernels edge cases: {len(errs)} comparisons within tolerance, "
          f"max_abs_err={max(errs):.3e}", flush=True)


def grok_norm_row(torch, cfg, shapes: dict, seed: int) -> dict:
    """Kernel 8 at every (T, D) the grok-1 serve launched it at (norm1, norm2
    and the final norm of its prefills and decode ticks), against the plain
    version, ``F.rms_norm`` beside it -> one kernels-line row over those
    shapes, with their launches (``shape_row``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    dt, eps = getattr(torch, cfg.dtype), cfg.norm_eps
    timed = {}
    for t, d in sorted(shapes):
        x = torch.randn((t, d), generator=g, device=dev).to(dt)
        w = (torch.randn((d,), generator=g, device=dev) * 0.1).to(dt)
        want = ref.rmsnorm(x, w, eps)
        err = check(torch, rmsnorm_cuda(x, w, eps), want, BF16_TOL, f"rmsnorm grok-1 [{t}, {d}]")
        w1 = (1.0 + w.float()).to(dt)  # the library's weight, formed before timing
        timed[(t, d)] = kernel_row(
            torch, "rmsnorm_grok", err, lambda: rmsnorm_cuda(x, w, eps), 200,
            time_ms(torch, lambda: ref.rmsnorm(x, w, eps), 100),
            library_time(torch, lambda: F.rms_norm(x, (d,), w1, eps), want, BF16_TOL["rtol"], 200,
                         "rmsnorm grok-1 (F.rms_norm)"),
            (2 * t * d + d) * x.element_size(), 4.0 * t * d, "bfloat16",
            f"x [{t}, {d}] {cfg.dtype}, w [{d}]", graph=True,
        )
    return shape_row(timed, shapes, "the grok-1 serve's norms", "(T, D)")


# ---------------------------------------------------------------------------
# phase 4: decode through the paged cache vs one full prefill
# ---------------------------------------------------------------------------


def decode_vs_prefill(torch, params, cfg, plan, tokens, page: int, device="cuda") -> float:
    """Prefill ``tokens[:m]`` into pages, continue ``tokens[m:]`` as a paged
    decode-mode chunk (the flash-decode kernel), and hold the last
    position's logits against one full prefill of all of ``tokens`` (the
    flash kernel).  Tolerance: 5e-2 of the logits' largest magnitude, for
    bf16 activations rounded along two different paths through 4 layers."""
    from repro_torch.models import transformer as tfm

    dev = torch.device(device)
    n = len(tokens)
    m = n // 2
    pages = -(-n // page)
    caches = tfm.init_paged_caches(cfg, pages + 1, page, device=dev)
    table = torch.arange(1, pages + 1, dtype=torch.int32)[None, :]  # page 0 stays unused
    with torch.no_grad():
        _, _, one = tfm.model_apply(
            params, {"tokens": torch.tensor(tokens[None, :m], device=dev)}, cfg, plan,
            mode="prefill",
        )
        # The prefill's K/V [reps, 1, S, Hkv, dh] into pages 1.. of the pools.
        one = tfm.pad_caches(one, pages * page)
        for name, c in caches.items():
            for key, pool in c.items():
                kv = one[name][key][:, 0].reshape(pool.shape[0], pages, page, *pool.shape[3:])
                pool[:, 1:] = kv.to(pool.dtype)
        feats, _, _ = tfm.model_apply(
            params, {"tokens": torch.tensor(tokens[None, m:], device=dev)}, cfg, plan,
            mode="decode", caches=caches, t=torch.tensor([m], dtype=torch.int32, device=dev),
            page_table=table.to(dev),
        )
        paged = tfm.logits_from_features(params, feats[:, -1:], cfg).float()
        feats, _, _ = tfm.model_apply(
            params, {"tokens": torch.tensor(tokens[None, :], device=dev)}, cfg, plan,
            mode="prefill",
        )
        full = tfm.logits_from_features(params, feats[:, -1:], cfg).float()
    assert torch.isfinite(paged).all() and torch.isfinite(full).all(), "non-finite logits"
    scale = full.abs().max().item()
    err = (paged - full).abs().max().item()
    assert err <= 5e-2 * scale, f"paged decode logits differ from prefill: {err} vs scale {scale}"
    return err / scale


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------


def spec_probe(torch, eng, ready) -> dict:
    """Wrap a speculative engine's draft loop (span ``spec_k``) and verify
    step.  Once ``ready()`` (the tick tracer is done: profilers do not
    nest), the first call of each runs under the profiler, which counts the
    kernels it launched on the card (``draft_kernels``, ``verify_kernels``;
    copies and fills not counted, as ``trace_decode_tick`` counts a tick's),
    and every later call is clocked between two synchronizes (``draft_ms``,
    ``verify_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.train_step import make_draft_loop_step

    b = eng.batcher
    out = {"draft_ms": [], "verify_ms": [], "draft_kernels": None, "verify_kernels": None}

    def wrap(fn, what):
        def call(*a):
            if not ready():
                return fn(*a)
            if out[f"{what}_kernels"] is None:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    r = fn(*a)
                    torch.cuda.synchronize()
                out[f"{what}_kernels"] = sum(
                    ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
                    and not any(w in ev.key.lower() for w in ("memcpy", "memset")))
                return r
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            out[f"{what}_ms"].append(1e3 * (time.perf_counter() - t0))
            return r

        return call

    b._verify_fn = wrap(b._verify_fn, "verify")
    b._draft_fns[b.spec_k] = wrap(
        make_draft_loop_step(b._draft_cfg, b.plan, k=b.spec_k, sample=b.sample), "draft")
    return out


def undo_placement(eng) -> None:
    """Move every expert of a reconfigured engine back to its own slot: the
    weights the engine was given are then as they were, for the next serve."""
    import numpy as np

    from repro_torch.core.controlplane import LayerPlan

    stack = eng.controlplane.perm_stack()
    eng.apply_plans([LayerPlan(layer, True, perm=np.argsort(row))
                     for layer, row in enumerate(stack)])
    assert (eng.controlplane.perm_stack() == np.arange(stack.shape[1])).all()


def serve(torch, params, cfg, plan, reqs, gen, *, reconfig_every: int, slots: int,
          max_len: int, page: int, device="cuda", tag: str = "grok", **scfg_kw):
    """Serve ``reqs`` through ``ServeEngine``; ``scfg_kw``: more
    ``ServeConfig`` switches (``sample``, ``sample_seed``, ``spec_k``).  A
    speculative serve's rounds are probed (``spec_probe``).  ``tag`` names
    the model in the printed lines and the end-to-end numbers."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    scfg = ServeConfig(slots=slots, max_len=max_len, page_size=page,
                       reconfig_every=reconfig_every, reconfig_min_gain=0.0, num_devices=4,
                       **scfg_kw)
    label = ", ".join(f"{k}={v}" for k, v in {"reconfig_every": reconfig_every, **scfg_kw}.items())
    eng = ServeEngine(params, cfg, plan, scfg, device=device)
    # The first pure decode tick (a speculative round, when spec_k > 0) runs
    # under the profiler (its kernels counted) and is left out of the tick
    # clocks.
    traced = trace_decode_tick(torch, eng)
    probe = (spec_probe(torch, eng, lambda: traced["launches"] is not None) if scfg.spec_k
             else None)
    # Host clock per tick: every tick ends in a host read of its tokens.
    tick_ms, tick_step = [], eng.step

    def timed_step():
        untraced = traced["launches"] is not None
        t0 = time.perf_counter()
        st = tick_step()
        tick_ms.append((1e3 * (time.perf_counter() - t0),
                        untraced and st.admitted == 0 and st.live > 0))
        return st

    eng.step = timed_step
    ops.reset_launch_counts()
    rep = eng.run(reqs, gen)
    counts, shapes = ops.launch_counts(), ops.launch_shapes()
    toks = {r.rid: list(r.out) for r in eng.batcher.finished}
    TOKENS_SHA256[f"{tag} serve, {label}"] = tokens_sha256(toks)
    decode = sorted(ms for ms, pure in tick_ms if pure)
    admit = sorted(ms for ms, pure in tick_ms if not pure)
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else float("nan")  # noqa: E731
    spec = ""
    if probe is not None:
        spec = (f"; speculative rounds: acceptance {rep.spec_accepted}/{rep.spec_drafted} = "
                f"{rep.spec_acceptance:.4f}, draft_ms median={med(probe['draft_ms']):.3f} "
                f"(n={len(probe['draft_ms'])}), verify_ms median={med(probe['verify_ms']):.3f} "
                f"(n={len(probe['verify_ms'])}), one round launched {probe['draft_kernels']} "
                f"kernels drafting {scfg.spec_k} tokens and {probe['verify_kernels']} verifying "
                f"{scfg.spec_k + 1}; kernel 3 launches by (B, C) {shapes['paged_flash_decode']}")
        E2E[f"{tag} spec round kernels (draft, verify), {label}"] = [probe["draft_kernels"],
                                                                     probe["verify_kernels"]]
        E2E[f"{tag} verify ms, {label}"] = med(probe["verify_ms"])
        E2E[f"{tag} draft ms, {label}"] = med(probe["draft_ms"])
        E2E[f"{tag} acceptance, {label}"] = rep.spec_acceptance
    print(f"serve {tag} {label}: completed={rep.completed}/{rep.requests} "
          f"ticks={rep.ticks} tokens={rep.tokens_out} wall_s={rep.wall_s:.3f} "
          f"tokens_per_s={rep.tokens_per_s:.2f} mean_tick_ms={1e3 * rep.wall_s / rep.ticks:.3f} "
          f"decode_tick_ms median={med(decode):.3f} (n={len(decode)}) "
          f"admit_tick_ms median={med(admit):.3f} (n={len(admit)}) "
          f"reconfig_count={rep.reconfig_count} launches={counts} rmsnorm by (T, D) "
          f"{shapes['rmsnorm']}; one decode tick launched {traced['launches']} kernels "
          f"({traced['device_ms']} ms of device time){spec}",
          flush=True)
    assert rep.completed == len(reqs), f"serve {label}: not every request completed"
    if eng.applier is not None:
        undo_placement(eng)
    E2E[f"{tag} decode tick ms, {label}"] = med(decode)
    E2E[f"{tag} tokens/s, {label}"] = rep.tokens_per_s
    E2E[f"{tag} decode tick kernel launches, {label}"] = traced["launches"]
    E2E[f"{tag} decode tick device ms, {label}"] = traced["device_ms"]
    return rep, toks, counts, shapes


def profile_serve(torch, params, cfg, plan, reqs, gen, scfg, label: str = "profile"):
    """Device time by kernel class over one whole serve (``--profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(params, cfg, plan, scfg, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.run(reqs, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    classes: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key
        low = name.lower()
        if any(w in low for w in ("topk_gating", "flash_fwd", "paged_decode", "rmsnorm",
                                  "ssd_chunk")):
            cls = "ported kernels"
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            cls = "matmul (cuBLAS)"
        elif "memcpy" in low or "memset" in low:
            cls = "copies"
        else:
            cls = "other PyTorch kernels"
        classes[cls] = classes.get(cls, 0.0) + ms
        kernels.append((ms, ev.count, name[:90]))
    busy = sum(classes.values())
    print(f"{label}: {rep.ticks} ticks, wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%), idle {100 * (1 - busy / wall_ms):.1f}%", flush=True)
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"{label} class {cls}: {ms:.2f} ms ({100 * ms / busy:.1f}% of device time)")
    for ms, n, name in sorted(kernels, reverse=True)[:12]:
        print(f"{label} kernel {ms:9.3f} ms x{n:<5} {name}")


# ---------------------------------------------------------------------------
# phase 5b: the serving fleet
# ---------------------------------------------------------------------------

FLEET_LAYERS = 2  # of grok-1's 64: three replicas' experts (19.3 GB each) + 3.6 GB shared
FLEET_SLOTS = (4, 2, 4)  # the replicas' slot counts; a fleet of n takes the first n
FLEET_MAX_LEN = 256  # every replica's: kernel 3's split is a function of the table's width


def fleet_requests_of(cfg, mix: str, seed: int):
    """``REQUESTS`` of ``mix`` clamped as ``examples/fleet.py`` clamps them:
    10 new tokens each, prompts up to 244 tokens."""
    from repro_torch.serve.fleet import fleet_requests
    from repro_torch.serve.workload import WorkloadGenerator, clamp_requests

    gen = WorkloadGenerator(mix, seed=seed, vocab_size=cfg.vocab_size)
    out_cap = max(1, min(10, FLEET_MAX_LEN // 4))
    raw = clamp_requests(gen.generate(REQUESTS), prompt_max=FLEET_MAX_LEN - out_cap - 2,
                         max_new=out_cap)
    return fleet_requests(raw, gen)


def fleet_replica(tree, cfg, plan, slots: int, page: int):
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    scfg = ServeConfig(slots=slots, max_len=FLEET_MAX_LEN, page_size=page, num_devices=4,
                       external_control=True, num_regions=4, reconfig_min_gain=0.0)
    return ServeEngine(tree, cfg, plan, scfg, device="cuda")


def fleet_reference(tree, cfg, plan, freqs, page: int):
    """Unsteered single-replica serving (4 slots): the tokens every fleet
    must reproduce, and the engine (its prefix-cache hits)."""
    from repro_torch.serve.batching import Request

    eng = fleet_replica(tree, cfg, plan, 4, page)
    for fr in sorted(freqs, key=lambda f: (f.arrival_s, f.rid)):
        eng.submit(Request(rid=fr.rid, prompt=fr.prompt, max_new_tokens=fr.max_new_tokens,
                           eos_id=fr.eos_id, region=fr.region))
    while eng.batcher.busy:
        eng.step()
    assert all(r.error is None for r in eng.batcher.finished)
    return {r.rid: list(r.out) for r in eng.batcher.finished}, eng


def fleet_run(torch, trees, cfg, plan, freqs, ref, size: int, policy: str, label: str,
              page: int, **events):
    """One fleet of ``size`` replicas (slots ``FLEET_SLOTS[:size]``) over
    ``freqs``: every request completes with the reference's tokens.  Each
    fleet tick is clocked on the host (every replica tick ends in a host
    read of its tokens).  Returns the fleet and its report; the replicas'
    experts are still where the run left them."""
    from repro_torch.serve.fleet import FleetConfig, FleetEngine

    engines = [fleet_replica(trees[j], cfg, plan, FLEET_SLOTS[j], page) for j in range(size)]
    fleet = FleetEngine(engines, FleetConfig(policy=policy, reconfig_every=4))
    tick_ms, step = [], fleet.step

    def timed_step():
        t0 = time.perf_counter()
        step()
        tick_ms.append(1e3 * (time.perf_counter() - t0))

    fleet.step = timed_step
    t0 = time.perf_counter()
    rep = fleet.run(freqs, **events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = [j for j, e in enumerate(engines) if e.controlplane.reconfig_count]
    med = sorted(tick_ms)[len(tick_ms) // 2] if tick_ms else float("nan")
    print(f"fleet {label}: size {size} slots {list(FLEET_SLOTS[:size])} policy={policy} "
          f"{events or ''} completed={rep.completed}/{rep.requests} ticks={rep.ticks} "
          f"steer={rep.steer_reasons} fleet_reconfigurations={rep.reconfig_events} "
          f"(replicas moved {moved}) ttft_ticks p50/p99={rep.ttft_ticks_p50:.1f}/"
          f"{rep.ttft_ticks_p99:.1f} slo_attainment={rep.slo_attainment} "
          f"tokens_per_s={rep.tokens_out / wall:.2f} fleet_tick_ms median={med:.3f} "
          f"(n={len(tick_ms)}) wall_s={wall:.3f} prefix_hit_pages by replica "
          f"{[r.kv_prefix_hit_pages for r in rep.per_replica]}", flush=True)
    assert rep.completed == len(freqs), f"fleet {label}: not every request completed"
    assert rep.outputs == ref, f"fleet {label}: tokens differ from the single replica's"
    if size > 1:
        assert len(set(fleet.assignment.values())) > 1, f"fleet {label}: one replica served all"
    E2E[f"fleet {label} tokens/s"] = rep.tokens_out / wall
    E2E[f"fleet {label} tick ms"] = med
    E2E[f"fleet {label} ttft ticks p50/p99"] = [rep.ttft_ticks_p50, rep.ttft_ticks_p99]
    return fleet, rep


def expert_leaves_equal(torch, tree, initial) -> bool:
    """Every expert leaf of ``tree`` bit-identical to the host copy
    ``initial`` (one leaf on the card at a time)."""
    from repro_torch.serve.fleet import expert_leaves

    return all(torch.equal(leaf, host.to(leaf.device))
               for leaf, host in zip(expert_leaves(tree), initial, strict=True))


def fleet_phase(torch, seed: int, page: int) -> dict:
    """grok-1 at its published widths, depth 2, random weights from
    ``seed``; three replica trees (the initial one and two made by
    ``replica_params``: private experts, everything else shared).  On the
    agentic mix: the unsteered single replica, then fleets of 1, 2 and 3
    under each policy, a failure and a drain/restore, every one with the
    reference's tokens; replicas that a locality run left unmoved keep the
    initial expert weights bit for bit; the size-3 locality run is traced,
    the trace validated and summarised.  On agentic_shared: the reference
    and two fleets of 3, tokens equal, prefix hits that differ from the
    reference's.  Experts are moved back after every run.  Returns the
    kernel launch counts of the fleet runs."""
    from repro_torch import measure_run
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    from repro_torch.obs import trace
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.serve.fleet import expert_leaves, replica_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("grok-1-314b"), num_layers=FLEET_LAYERS)
    plan = make_plan(None)
    params = init_model(seed, cfg, plan, device="cuda")
    initial = [leaf.cpu() for leaf in expert_leaves(params)]
    trees = [params] + [replica_params(params) for _ in FLEET_SLOTS[1:]]
    torch.cuda.synchronize()
    print(f"fleet: {cfg.name} at published widths, {FLEET_LAYERS}/64 layers, "
          f"{len(trees)} replica trees, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card",
          flush=True)
    agentic = fleet_requests_of(cfg, "agentic", seed)
    ref, _ = fleet_reference(trees[0], cfg, plan, agentic, page)
    ops.reset_launch_counts()
    reconfigs, unmoved_checked = 0, []
    path = REPO / "build" / "fleet_trace.json"
    runs = [(n, p, {}) for n in (1, 2, 3) for p in ("locality", "least_loaded", "round_robin")]
    runs += [(3, "locality", dict(fail_at={0: 4})),
             (3, "locality", dict(drain_at={1: 2}, restore_at={1: 8}))]
    for size, policy, events in runs:
        traced = size == 3 and policy == "locality" and not events
        if traced:
            trace.enable()
        fleet, rep = fleet_run(torch, trees, cfg, plan, agentic, ref, size, policy,
                               f"agentic {size} {policy} {sorted(events)}", page, **events)
        if traced:
            n = trace.export(str(path))
            failures = trace.validate_file(str(path))
            trace.disable()
            trace.default().clear()
            assert not failures, f"fleet trace schema failures: {failures[:3]}"
            obs = measure_run.traffic_reports(measure_run.load_events(str(path)))
            assert {"fleet", "replica0", "replica1", "replica2"} <= set(obs), sorted(obs)
            summary = {scope: {"locality": round(o.locality_score(), 6),
                               "regional_skew": round(o.regional_skew(), 6), "ticks": o.ticks}
                       for scope, o in sorted(obs.items())}
            print(f"fleet trace: {n} events -> {path}, schema OK; measure_run: "
                  f"{json.dumps(summary)}", flush=True)
        reconfigs += rep.reconfig_events if policy == "locality" else 0
        moved = {j for j, e in enumerate(fleet.engines) if e.controlplane.reconfig_count}
        if size == 3 and moved and not unmoved_checked:
            # A replica's reconfiguration must not move another's experts.
            for j in sorted(set(range(size)) - moved):
                assert expert_leaves_equal(torch, trees[j], initial), \
                    f"replica {j} never moved, yet its experts differ from the initial ones"
                unmoved_checked.append(j)
        for e in fleet.engines:
            undo_placement(e)
    assert reconfigs > 0, "the locality fleets never reconfigured a replica"
    # The failure run always leaves one (replica 0 fails before the first
    # reconfiguration tick).
    assert unmoved_checked, "no size-3 locality run left a replica unmoved"
    counts = ops.launch_counts()
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    assert not missing, f"kernels never launched by the fleet: {missing}"
    print(f"fleet: {reconfigs} fleet reconfigurations over the locality runs; replicas "
          f"{unmoved_checked} never moved in a size-3 run and hold the initial experts bit "
          f"for bit; launches {counts}", flush=True)

    shared = fleet_requests_of(cfg, "agentic_shared", seed)
    ref_s, ref_eng = fleet_reference(trees[0], cfg, plan, shared, page)
    ref_hits = ref_eng.batcher.alloc.prefix_hit_pages
    differs = False
    for policy in ("locality", "round_robin"):
        fleet, rep = fleet_run(torch, trees, cfg, plan, shared, ref_s, 3, policy,
                               f"agentic_shared 3 {policy}", page)
        hits = [r.kv_prefix_hit_pages for r in rep.per_replica]
        differs |= sum(hits) > 0 and sum(hits) != ref_hits
        for e in fleet.engines:
            undo_placement(e)
    print(f"fleet agentic_shared: reference prefix_hit_pages={ref_hits}; fleet tokens equal "
          f"the reference's with other hits", flush=True)
    assert differs, "no fleet run hit the prefix cache otherwise than the reference"
    seconds = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"fleet phase: {seconds:.1f} s, peak {peak:.2f} GB on {card_line()}", flush=True)
    E2E["fleet phase s"] = seconds
    E2E["fleet phase peak GB"] = peak
    del params, trees, initial
    return counts


# ---------------------------------------------------------------------------
# phase 6: training-path kernels
# ---------------------------------------------------------------------------


def _grads(torch, fn, inputs, cot):
    """torch.autograd of ``fn`` (the plain forward) w.r.t. ``inputs``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad(out, leaves, cot)


def blocks_rows(torch, rows, suffix, xb, w, dy, be, counts, what, parts=("", "_dx", "_dw")):
    """Kernel 7 (``grouped_matmul_blocks``) and its dX and dW on the tiles
    ``xb [nb, 8, K]`` (``counts[e]`` real rows of expert e), weights ``w [E,
    K, N]`` and the output gradient ``dy [nb, 8, N]``, each against its plain
    version or ``torch.autograd`` of the plain forward, with
    ``torch._grouped_mm`` over the same rows (expert e's tiles as the group
    ending at offs[e]) as the yardstick.  Adds the rows named
    ``grouped_matmul_blocks{part}{suffix}`` for each part."""
    from repro_torch.kernels import grouped_matmul as kgm
    from repro_torch.kernels import ref

    nb, _, kd = xb.shape
    e, _, nd = w.shape
    n = int(counts.sum())
    used = int((counts > 0).sum())
    offs = torch.cumsum(torch.bincount(be, minlength=e) * 8, 0).to(torch.int32)
    x2, w_t, dy2 = xb.reshape(-1, kd), w.transpose(1, 2), dy.reshape(-1, nd)
    gemm, tiles = 2.0 * n * kd * nd, nb * 4
    want_dx, want_dw = _grads(torch, lambda a, b: ref.grouped_matmul_blocks(a, b, be), [xb, w], dy)
    cases = {
        "": (lambda: kgm.grouped_matmul_blocks_cuda(xb, w, be),
             lambda: ref.grouped_matmul_blocks(xb, w, be), None,
             lambda: torch._grouped_mm(x2, w, offs=offs), (n * kd + used * kd * nd + n * nd) * 2,
             f"x [{nb}, 8, {kd}] bf16 @ w [{e}, {kd}, {nd}], {n} rows in {nb} tiles"),
        "_dx": (lambda: kgm.grouped_matmul_blocks_dx_cuda(dy, w, be),
                lambda: ref.grouped_matmul_blocks(dy, w_t, be), want_dx,
                lambda: torch._grouped_mm(dy2, w_t, offs=offs),
                (n * nd + used * kd * nd + n * kd) * 2,
                f"dy [{nb}, 8, {nd}] bf16 @ w[e]^T, w [{e}, {kd}, {nd}]"),
        "_dw": (lambda: kgm.grouped_matmul_blocks_dw_cuda(xb, dy, be, e),
                lambda: ref.grouped_matmul_blocks_dw(xb, dy, be, e), want_dw,
                lambda: torch._grouped_mm(x2.t(), dy2, offs=offs),
                (n * kd + n * nd + e * kd * nd) * 2,
                f"x [{nb}, 8, {kd}], dy [{nb}, 8, {nd}] bf16 -> dW [{e}, {kd}, {nd}]"),
    }
    for part in parts:
        kernel, plain, want, lib, bytes_moved, shape = cases[part]
        name = f"grouped_matmul_blocks{part}{suffix}"
        got = kernel()
        want = plain() if want is None else want
        err = check_rel(got, want, BF16_GEMM_REL, name)
        rows[name] = kernel_row(
            torch, name, err, kernel, 20, time_ms(torch, plain, 5),
            library_time(torch, lib, got.reshape(lib().shape), BF16_GEMM_REL, 20,
                         f"{name} (torch._grouped_mm)"),
            bytes_moved + tiles, gemm, "bfloat16", shape + what,
        )


def train_kernel_phase(torch, cfg, batch: int, seq: int, seed: int):
    """Every training-path kernel at the Mixtral step's shapes: T = batch x
    seq tokens routed top-k over E experts (dropless, P = 1), expert width
    d_ff, attention q [B, Hq, S, D] over k/v [B, Hkv, S, D], all bf16."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import grouped_matmul as kgm
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import topk_gating as ktg
    from repro_torch.models import routing

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    bf16 = torch.bfloat16
    d, f = cfg.d_model, cfg.moe.d_ff
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    t = batch * seq
    n = t * k
    rows = {}
    randn = lambda *shape, dt=torch.float32: torch.randn(shape, generator=g, device=dev).to(dt)

    # The step's routing and dispatch plans at P = 1, as _moe_mixnet_local builds them.
    with torch.no_grad():
        info = routing.compute_routing(randn(t, e), top_k=k, num_virtual=e, replication=1)
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        rank1, _ = routing.bucket_ranks(zeros, 1)
        plan1 = routing.capacity_plan(zeros, rank1, None, 1, n)
        src_tok = torch.where(plan1.src >= 0, plan1.src // k, torch.full_like(plan1.src, -1))
        local_e = info.vdest.reshape(n)
        valid = local_e >= 0
        rank2, counts2 = routing.bucket_ranks(local_e, e, valid=valid)
        plan2 = routing.dropless_plan(local_e, rank2, counts2, valid, e, 8)
    be = plan2.block_experts
    nb = be.shape[0]
    assert bool((src_tok >= 0).all()), "a dropless send buffer at P = 1 has no empty row"

    # -- moe_dispatch: the send gather x [T, D] -> [T * k, D] (exact).
    x = randn(t, d, dt=bf16)
    got = kmd.moe_dispatch_cuda(x, src_tok)
    assert torch.equal(got, ref.moe_dispatch(x, src_tok)), "moe_dispatch differs from plain"
    packed = kmd.moe_dispatch_cuda(got, plan2.src)  # the pack, with -1 padding rows
    assert torch.equal(packed, ref.moe_dispatch(got, plan2.src)), "moe_dispatch pack differs"
    assert not packed[plan2.src < 0].any(), "padding rows must be zero"
    unpacked = kmd.moe_dispatch_cuda(packed, plan2.slot)  # the unpack: back to send order
    assert torch.equal(unpacked, got), "moe_dispatch unpack differs"
    assert bool((plan2.slot >= 0).all()), "a dropless plan places every choice"
    idx, idx_unpack = src_tok.long(), plan2.slot.long()
    distinct = int(torch.unique(src_tok[src_tok >= 0]).numel())  # each read once
    n_pack = plan2.src.shape[0]
    rows["moe_dispatch"] = kernel_row(
        torch, "moe_dispatch", 0.0, lambda: kmd.moe_dispatch_cuda(x, src_tok), 200,
        time_ms(torch, lambda: ref.moe_dispatch(x, src_tok), 200),
        timed(torch, lambda: torch.index_select(x, 0, idx), 200),
        (distinct + n) * d * 2 + n * 4, 0.0, "bfloat16", f"x [{t}, {d}] bf16 -> [{n}, {d}]",
    )
    # The pack has no one-call library equivalent (its padding rows are zeros).
    rows["moe_dispatch_pack"] = kernel_row(
        torch, "moe_dispatch_pack", 0.0, lambda: kmd.moe_dispatch_cuda(got, plan2.src), 200,
        time_ms(torch, lambda: ref.moe_dispatch(got, plan2.src), 200), NO_LIBRARY,
        (n + n_pack) * d * 2 + n_pack * 4, 0.0, "bfloat16",
        f"[{n}, {d}] bf16 -> [{n_pack}, {d}], {n_pack - n} zero padding rows",
    )
    rows["moe_dispatch_unpack"] = kernel_row(
        torch, "moe_dispatch_unpack", 0.0, lambda: kmd.moe_dispatch_cuda(packed, plan2.slot), 200,
        time_ms(torch, lambda: ref.moe_dispatch(packed, plan2.slot), 200),
        timed(torch, lambda: torch.index_select(packed, 0, idx_unpack), 200),
        2 * n * d * 2 + n * 4, 0.0, "bfloat16", f"[{n_pack}, {d}] bf16 -> [{n}, {d}]",
    )
    del unpacked

    # -- grouped_matmul_blocks (kernel 7) and its dX and dW at the w_in
    # shapes: packed [nb, 8, D] @ w [E, D, F]; padding rows get no gradient.
    xb = packed.reshape(nb, 8, d)
    pad = (plan2.src < 0).reshape(nb, 8)
    w = (randn(e, d, f) * d**-0.5).to(bf16)
    dy = randn(nb, 8, f, dt=bf16)
    dy[pad] = 0
    blocks_rows(torch, rows, "", xb, w, dy, be, counts2, "")
    del w, dy
    # -- the same at the w_out shapes: the hidden [nb, 8, F] @ w_out [E, F, D].
    hb = randn(nb, 8, f, dt=bf16)
    hb[pad] = 0
    w_out = (randn(e, f, d) * f**-0.5).to(bf16)
    dy_out = randn(nb, 8, d, dt=bf16)
    dy_out[pad] = 0
    blocks_rows(torch, rows, "_wout", hb, w_out, dy_out, be, counts2, "")
    del hb, w_out, dy_out
    # -- forward and dW at a skewed plan: 3/8 of the choices on each of two
    # experts, the rest spread over the others, as the router's collapse
    # under training gives (PERF.md); torch._grouped_mm beside each.
    hot = 3 * n // 8
    skew = [hot, hot] + [(n - 2 * hot) // (e - 2) + (i < (n - 2 * hot) % (e - 2))
                         for i in range(e - 2)]
    with torch.no_grad():
        sk_e = torch.repeat_interleave(torch.arange(e, device=dev), torch.tensor(skew, device=dev))
        sk_e = sk_e[torch.randperm(n, generator=g, device=dev)].to(torch.int32)
        sk_valid = torch.ones(n, dtype=torch.bool, device=dev)
        sk_rank, sk_counts = routing.bucket_ranks(sk_e, e, valid=sk_valid)
        sk_plan = routing.dropless_plan(sk_e, sk_rank, sk_counts, sk_valid, e, 8)
        xs = kmd.moe_dispatch_cuda(randn(n, d, dt=bf16), sk_plan.src)
    nbs = sk_plan.block_experts.shape[0]
    dys = randn(nbs, 8, f, dt=bf16)
    dys[(sk_plan.src < 0).reshape(nbs, 8)] = 0
    blocks_rows(torch, rows, "_skew", xs.reshape(nbs, 8, d), (randn(e, d, f) * d**-0.5).to(bf16),
                dys, sk_plan.block_experts, sk_counts, f", skewed {skew}", parts=("", "_dw"))
    del xs, dys

    # -- moe_combine: y [T * k, D] bf16 by slot / wfull [T, k] -> [T, D] f32.
    y = randn(n, d, dt=bf16)
    slot = plan1.slot.reshape(t, k)
    wts = info.wfull.float().contiguous()
    got = kmd.moe_combine_cuda(y, slot, wts)
    err = check(torch, got, ref.moe_combine(y, slot, wts), F32_TOL, "moe_combine")
    # Library yardstick: embedding_bag's weighted sum of rows (main-path
    # slots have no -1); it takes weights in y's dtype and returns bf16.
    slot_l, wts_b = slot.long(), wts.to(bf16)
    rows["moe_combine"] = kernel_row(
        torch, "moe_combine", err, lambda: kmd.moe_combine_cuda(y, slot, wts), 200,
        time_ms(torch, lambda: ref.moe_combine(y, slot, wts), 50),
        library_time(torch, lambda: F.embedding_bag(slot_l, y, per_sample_weights=wts_b,
                                                    mode="sum"),
                     got, BF16_GEMM_REL, 200, "moe_combine (F.embedding_bag)"),
        n * d * 2 + t * k * 8 + t * d * 4, 2.0 * n * d, "float32",
        f"y [{n}, {d}] bf16, slot/w [{t}, {k}] -> [{t}, {d}] f32",
    )
    # -- the send gather's backward: the combine of the send rows' gradient
    # with unit weights, bf16 out; embedding_bag's unweighted sum beside it.
    dsend = randn(n, d, dt=bf16)
    ones = torch.ones((t, k), device=dev)
    got = kmd.moe_combine_cuda(dsend, slot, ones, out_dtype=bf16)
    assert torch.equal(got, kmd.moe_combine_cuda(dsend, slot, ones).to(bf16)), \
        "the bf16 combine differs from the f32 combine rounded once"
    rows["moe_combine_bf16"] = kernel_row(
        torch, "moe_combine_bf16", check(torch, got, ref.moe_combine(dsend, slot, ones), BF16_TOL,
                                         "moe_combine bf16"),
        lambda: kmd.moe_combine_cuda(dsend, slot, ones, out_dtype=bf16), 200,
        time_ms(torch, lambda: ref.moe_combine(dsend, slot, ones).to(bf16), 50),
        library_time(torch, lambda: F.embedding_bag(slot_l, dsend, mode="sum"), got,
                     BF16_GEMM_REL, 200, "moe_combine_bf16 (F.embedding_bag)"),
        n * d * 2 + t * k * 8 + t * d * 2, 2.0 * n * d, "float32",
        f"dout [{n}, {d}] bf16, unit weights [{t}, {k}] -> [{t}, {d}] bf16",
    )
    del dsend
    # -- its backward: dy through the inverse map (plan1.src), dw as row dot products.
    dout = randn(t, d)
    want_dy, want_dw = _grads(torch, lambda a, b: ref.moe_combine(a, slot, b), [y, wts], dout)
    gy, gw = kmd.moe_combine_bwd_cuda(dout, y, slot, wts, plan1.src)
    err = max(check(torch, gy, want_dy, BF16_TOL, "moe_combine_bwd dy"),
              check(torch, gw, want_dw, REDUCE_TOL, "moe_combine_bwd dw"))
    rows["moe_combine_bwd"] = kernel_row(
        torch, "moe_combine_bwd", err,
        lambda: kmd.moe_combine_bwd_cuda(dout, y, slot, wts, plan1.src), 200,
        time_ms(torch, lambda: ref.moe_combine_bwd(dout, y, slot, wts, plan1.src), 50),
        NO_LIBRARY,
        t * d * 4 + n * d * 2 + n * d * 2 + t * k * 12 + n * 4, 3.0 * n * d, "float32",
        f"dout [{t}, {d}] f32, y [{n}, {d}] bf16 -> dy, dw [{t}, {k}]",
    )

    # -- topk_gating forward and backward at the step's [T, E] logits.
    logits = randn(t, e)
    wk, ids = ktg.topk_gating_cuda(logits, k)
    rw, ri = ref.topk_gating(logits, k)
    assert torch.equal(ids, ri), "topk_gating ids differ from the plain version"
    rows["topk_gating"] = kernel_row(
        torch, "topk_gating", check(torch, wk, rw, F32_TOL, "topk_gating"),
        lambda: ktg.topk_gating_cuda(logits, k), 200,
        time_ms(torch, lambda: ref.topk_gating(logits, k), 200),
        timed(torch, lambda: torch.topk(torch.softmax(logits, -1), k, dim=-1), 200),
        t * e * 4 + t * k * 8, t * e * (5 + k), "float32", f"logits [{t}, {e}] f32, k={k}",
    )
    dwt = randn(t, k)
    (want,) = _grads(torch, lambda a: ref.topk_gating(a, k), [logits], dwt)
    got = ktg.topk_gating_bwd_cuda(logits, dwt, ids)
    err = check(torch, got, want, F32_TOL, "topk_gating_bwd")
    rows["topk_gating_bwd"] = kernel_row(
        torch, "topk_gating_bwd", err,
        lambda: ktg.topk_gating_bwd_cuda(logits, dwt, ids), 200,
        time_ms(torch, lambda: ref.topk_gating_bwd(logits, dwt, ids), 200), NO_LIBRARY,
        t * e * 8 + t * k * 8, t * e * 10.0, "float32", f"logits [{t}, {e}] f32, k={k}",
    )

    # -- rmsnorm (kernel 8) forward and backward at the step's [T, D]: every
    # norm of the step (norm1, norm2, the final norm) has this shape.
    eps = cfg.norm_eps
    xn, dyn = randn(t, d, dt=bf16), randn(t, d, dt=bf16)
    wn = (randn(d) * 0.1).to(bf16)
    want = ref.rmsnorm(xn, wn, eps)
    w1 = (1.0 + wn.float()).to(bf16)  # the library's weight, formed before timing
    rows["rmsnorm_mixtral"] = kernel_row(
        torch, "rmsnorm_mixtral",
        check(torch, krms.rmsnorm_cuda(xn, wn, eps), want, BF16_TOL, "rmsnorm_mixtral"),
        lambda: krms.rmsnorm_cuda(xn, wn, eps), 200,
        time_ms(torch, lambda: ref.rmsnorm(xn, wn, eps), 100),
        library_time(torch, lambda: F.rms_norm(xn, (d,), w1, eps), want, BF16_TOL["rtol"], 200,
                     "rmsnorm_mixtral (F.rms_norm)"),
        (2 * t * d + d) * 2, 4.0 * t * d, "bfloat16", f"x [{t}, {d}] bf16, w [{d}]", graph=True,
    )
    want_dx, want_dw = _grads(torch, lambda a, b: ref.rmsnorm(a, b, eps), [xn, wn], dyn)
    gdx, gdw = krms.rmsnorm_bwd_cuda(xn, wn, dyn, eps)
    err = max(check(torch, gdx, want_dx, BF16_TOL, "rmsnorm_bwd dx"),
              check_rel(gdw, want_dw, NORM_DW_REL, "rmsnorm_bwd dw"))
    xp, wp = xn.detach().clone().requires_grad_(), wn.detach().clone().requires_grad_()
    plain_out = ref.rmsnorm(xp, wp, eps)
    xl, wl = xn.detach().clone().requires_grad_(), w1.detach().clone().requires_grad_()
    lib_out = F.rms_norm(xl, (d,), wl, eps)
    rows["rmsnorm_bwd"] = kernel_row(
        torch, "rmsnorm_bwd", err, lambda: krms.rmsnorm_bwd_cuda(xn, wn, dyn, eps), 200,
        time_ms(torch, lambda: torch.autograd.grad(plain_out, (xp, wp), dyn, retain_graph=True),
                50),
        timed(torch, lambda: torch.autograd.grad(lib_out, (xl, wl), dyn, retain_graph=True), 100),
        (3 * t * d + 2 * d) * 2, 8.0 * t * d, "bfloat16",
        f"x, dy [{t}, {d}] bf16 -> dx, dw [{d}]", graph=True,
    )
    del xn, dyn, gdx, want_dx, plain_out, lib_out

    # -- flash_attention backward at the step's attention: q [B, Hq, S, D].
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, kk, vv = randn(batch, hq, seq, dh, dt=bf16), randn(batch, hkv, seq, dh, dt=bf16), \
        randn(batch, hkv, seq, dh, dt=bf16)
    do = randn(batch, hq, seq, dh, dt=bf16)
    out, lse = kfa.flash_attention_cuda(q, kk, vv, causal=True, return_lse=True)
    pairs = seq * (seq + 1) / 2
    kx, vx = (a.repeat_interleave(hq // hkv, dim=1) for a in (kk, vv))
    rows["flash_attention"] = kernel_row(
        torch, "flash_attention",
        check(torch, out, ref.flash_attention(q, kk, vv, causal=True), BF16_TOL, "flash_attention"),
        lambda: kfa.flash_attention_cuda(q, kk, vv, causal=True, return_lse=True), 50,
        time_ms(torch, lambda: ref.flash_attention(q, kk, vv, causal=True), 20),
        timed(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True), 50),
        2 * (2 * batch * hq + 2 * batch * hkv) * seq * dh + batch * hq * seq * 4,
        4.0 * dh * pairs * hq * batch, "bfloat16",
        f"q [{batch}, {hq}, {seq}, {dh}] bf16 causal, with log-sum-exp",
    )
    want = _grads(torch, lambda a, b, c: ref.flash_attention(a, b, c, causal=True), [q, kk, vv], do)
    got = kfa.flash_attention_bwd_cuda(q, kk, vv, out, lse, do, causal=True)
    err = max(check_rel(a, b, BF16_GRAD_REL, f"flash_attention_bwd d{nm}")
              for a, b, nm in zip(got, want, "qkv"))
    ql, kl, vl = (a.detach().clone().requires_grad_() for a in (q, kk, vv))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    rows["flash_attention_bwd"] = kernel_row(
        torch, "flash_attention_bwd", err,
        lambda: kfa.flash_attention_bwd_cuda(q, kk, vv, out, lse, do), 20,
        time_ms(torch, lambda: ref.flash_attention_bwd(q, kk, vv, do, causal=True), 5),
        timed(torch, lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True), 20),
        (3 * batch * hq * seq * dh + 4 * batch * hkv * seq * dh + batch * hq * seq * dh) * 2
        + batch * hq * seq * 4, 10.0 * dh * pairs * hq * batch, "bfloat16",
        f"q [{batch}, {hq}, {seq}, {dh}], k/v [{batch}, {hkv}, {seq}, {dh}] bf16 causal",
    )
    train_edge_cases(torch, g)
    return rows


def train_edge_cases(torch, g):
    """-1 sources, fully dropped rows, S in {1, 2}, padding tiles, empty
    experts, experts of more than 256 rows, every row in one expert, K and N
    off the tiles, ragged S with window and softcap at head dims 32, 40, 96,
    128 and 192, and S = 300 at D = 128 with a group of 6, in f32 and bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import grouped_matmul as kgm
    from repro_torch.kernels import moe_dispatch as kmd

    dev = torch.device("cuda")
    cpu = torch.Generator().manual_seed(5)
    errs = []
    for dt, tol in ((torch.float32, REDUCE_TOL), (torch.bfloat16, BF16_TOL)):
        x = torch.randn((37, 40), generator=g, device=dev).to(dt)
        src = torch.randint(-1, 37, (50,), generator=cpu, dtype=torch.int32).to(dev)
        assert torch.equal(kmd.moe_dispatch_cuda(x, src), ref.moe_dispatch(x, src))
        for s in (1, 2):
            t, p = 30, 70
            slot = torch.randperm(p, generator=cpu)[: t * s].reshape(t, s).to(torch.int32)
            slot[torch.rand((t, s), generator=cpu) < 0.25] = -1
            slot[0] = -1  # a fully dropped row
            inv = torch.full((p,), -1, dtype=torch.int32)
            flat = slot.reshape(-1)
            inv[flat[flat >= 0].long()] = torch.nonzero(flat >= 0)[:, 0].to(torch.int32)
            slot, inv = slot.to(dev), inv.to(dev)
            y = torch.randn((p, 40), generator=g, device=dev).to(dt)
            w = torch.rand((t, s), generator=g, device=dev)
            got = kmd.moe_combine_cuda(y, slot, w)
            assert not got[0].any(), "a fully dropped row must be exactly 0"
            errs.append(check(torch, got, ref.moe_combine(y, slot, w), F32_TOL, "combine edge"))
            dout = torch.randn((t, 40), generator=g, device=dev)
            want = _grads(torch, lambda a, b: ref.moe_combine(a, slot, b), [y, w], dout)
            for a, b in zip(kmd.moe_combine_bwd_cuda(dout, y, slot, w, inv), want):
                errs.append(check(torch, a, b, tol, f"combine_bwd edge {dt} S={s}"))
        # Tiles: experts of 100 (two f32 runs), 300 and 257 rows (two bf16
        # runs each), empty ones, ragged tails, every row in one expert,
        # trailing zero tiles clipped to the last expert; K and N multiples
        # of 8 off the 64-deep / 128-wide tiles.
        for counts, kdim, ndim in (([100, 0, 9, 64, 1], 64, 200), ([300, 0, 9, 257, 1], 72, 136),
                                   ([700], 136, 40), ([0, 0, 520, 0], 64, 192)):
            ne = len(counts)
            be = sum(([ei] * -(-c // 8) for ei, c in enumerate(counts)), []) + [ne - 1] * 3
            xb = torch.zeros((len(be) * 8, kdim), device=dev)
            row = 0
            for c in counts:
                xb[row:row + c] = torch.randn((c, kdim), generator=g, device=dev)
                row += -(-c // 8) * 8
            xb = xb.reshape(-1, 8, kdim).to(dt)
            be = torch.tensor(be, dtype=torch.int32, device=dev)
            w = (torch.randn((ne, kdim, ndim), generator=g, device=dev) / 8).to(dt)
            rel = BF16_GEMM_REL if dt == torch.bfloat16 else 1e-5
            what = f"{dt} counts={counts} K={kdim} N={ndim}"
            errs.append(check_rel(kgm.grouped_matmul_blocks_cuda(xb, w, be),
                                  ref.grouped_matmul_blocks(xb, w, be), rel, f"gmm edge {what}"))
            dy = torch.randn((len(be), 8, ndim), generator=g, device=dev).to(dt)
            want_dx, want_dw = _grads(torch, lambda a, b: ref.grouped_matmul_blocks(a, b, be),
                                      [xb, w], dy)
            errs.append(check_rel(kgm.grouped_matmul_blocks_dx_cuda(dy, w, be), want_dx, rel,
                                  f"dX edge {what}"))
            dwk = kgm.grouped_matmul_blocks_dw_cuda(xb, dy, be, ne)
            for ei, c in enumerate(counts):
                assert c or not dwk[ei].any(), "an expert without tiles has a zero gradient"
            errs.append(check_rel(dwk, want_dw, rel, f"dW edge {what}"))
        for hd in (32, 40, 96, 128, 192):  # kernel widths and a zero-padded one (40)
            q = torch.randn((2, 6, 77, hd), generator=g, device=dev).to(dt)
            k = torch.randn((2, 2, 77, hd), generator=g, device=dev).to(dt)
            v = torch.randn((2, 2, 77, hd), generator=g, device=dev).to(dt)
            do = torch.randn((2, 6, 77, hd), generator=g, device=dev).to(dt)
            for kw in (dict(causal=True, window=33, softcap=30.0), dict(causal=False)):
                out, lse = kfa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
                got = kfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
                want = _grads(torch, lambda a, b, c: ref.flash_attention(a, b, c, **kw), [q, k, v],
                              do)
                rel = BF16_GRAD_REL if dt == torch.bfloat16 else 1e-4
                errs += [check_rel(a, b, rel, f"flash bwd edge {dt} D={hd} {kw}")
                         for a, b in zip(got, want)]
        # Several key and q tiles and a ragged tail at grok-1's group of 6.
        q, do = (torch.randn((1, 12, 300, 128), generator=g, device=dev).to(dt) for _ in "qd")
        k, v = (torch.randn((1, 2, 300, 128), generator=g, device=dev).to(dt) for _ in "kv")
        for kw in (dict(causal=True), dict(causal=True, window=100, softcap=30.0),
                   dict(causal=False)):
            out, lse = kfa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            got = kfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
            want = _grads(torch, lambda a, b, c: ref.flash_attention(a, b, c, **kw), [q, k, v], do)
            rel = BF16_GRAD_REL if dt == torch.bfloat16 else 1e-4
            errs += [check_rel(a, b, rel, f"flash bwd edge {dt} S=300 GQA 6 {kw}")
                     for a, b in zip(got, want)]
    torch.cuda.synchronize()
    print(f"train kernels edge cases: {len(errs)} comparisons within tolerance, "
          f"max_abs_err={max(errs):.3e}", flush=True)


def capacity_config(cfg):
    """``cfg`` with GShard/Switch token-dropping dispatch at capacity factor
    1.25."""
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="capacity", capacity_factor=1.25))


def capacity_kernel_phase(torch, cfg, batch: int, seq: int, seed: int):
    """Kernel 6 (the capacity-layout grouped GEMM) and its dX and dW at the
    capacity step's w_in shapes, and at the w_out shapes (rows
    ``grouped_matmul_wout``, ``grouped_matmul_dx_wout``,
    ``grouped_matmul_dw_wout``): T = batch x
    seq tokens routed top-k, stage 1
    packs them into capacity(T, k, 1, cf) send rows (at P = 1 the rows past
    T * k stay empty), stage 2 into E buffers of C = capacity(rows, 1, E, cf)
    rows, empty slots and dropped choices as zero rows.  All bf16, against
    the plain versions and torch.autograd of the plain forward
    (``BF16_GEMM_REL``); ``torch.bmm`` is the library yardstick."""
    from repro_torch.kernels import grouped_matmul as kgm
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.kernels import ref
    from repro_torch.models import routing

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    bf16 = torch.bfloat16
    d, f = cfg.d_model, cfg.moe.d_ff
    e, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    t = batch * seq
    n = t * k
    randn = lambda *shape, dt=torch.float32: torch.randn(shape, generator=g, device=dev).to(dt)
    with torch.no_grad():
        info = routing.compute_routing(randn(t, e), top_k=k, num_virtual=e, replication=1)
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        rank1, _ = routing.bucket_ranks(zeros, 1)
        cp = routing.capacity(t, k, 1, cf)
        plan1 = routing.capacity_plan(zeros, rank1, rank1 < cp, 1, cp)
        src_tok = torch.where(plan1.src >= 0, plan1.src // k, torch.full_like(plan1.src, -1))
        local_e = info.vdest.reshape(n)
        recv_e = torch.where(plan1.src >= 0, local_e[plan1.src.clamp(0, n - 1).long()],
                             torch.full_like(plan1.src, -1)).to(torch.int32)
        valid = recv_e >= 0
        rank2, _ = routing.bucket_ranks(recv_e, e, valid=valid)
        c = routing.capacity(cp, 1, e, cf)
        plan2 = routing.capacity_plan(recv_e, rank2, valid, e, c)
        rx = kmd.moe_dispatch_cuda(randn(t, d, dt=bf16), src_tok)
        x = kmd.moe_dispatch_cuda(rx, plan2.src).reshape(e, c, d)
    empty_send = int((plan1.src < 0).sum())
    empty = int((plan2.src < 0).sum())
    print(f"capacity layout: {n} choices -> {cp} send rows ({empty_send} empty) -> "
          f"[{e}, {c}] expert slots ({empty} empty, {int(plan2.kept)} kept)", flush=True)
    assert empty_send > 0 and not x.reshape(-1, d)[plan2.src < 0].any(), "empty slots not zero"
    w = (randn(e, d, f) * d**-0.5).to(bf16)
    dy = randn(e, c, f, dt=bf16)
    dy.reshape(-1, f)[plan2.src < 0] = 0  # empty slots get no gradient in the layer
    rows = {}
    y = kgm.grouped_matmul_cuda(x, w)
    want = ref.grouped_matmul(x, w)
    err = check_rel(y, want, BF16_GEMM_REL, "grouped_matmul")
    gemm = 2.0 * e * c * d * f
    rows["grouped_matmul"] = kernel_row(
        torch, "grouped_matmul", err,
        lambda: kgm.grouped_matmul_cuda(x, w), 20,
        time_ms(torch, lambda: ref.grouped_matmul(x, w), 5),
        library_time(torch, lambda: torch.bmm(x, w), want, BF16_GEMM_REL, 20,
                     "grouped_matmul (torch.bmm)"),
        (e * c * d + e * d * f + e * c * f) * 2, gemm, "bfloat16",
        f"x [{e}, {c}, {d}] bf16 @ w [{e}, {d}, {f}], {empty} empty slots",
    )
    want_dx, want_dw = _grads(torch, lambda a, b: ref.grouped_matmul(a, b), [x, w], dy)
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    dx = kgm.grouped_matmul_dx_cuda(dy, w)
    rows["grouped_matmul_dx"] = kernel_row(
        torch, "grouped_matmul_dx", check_rel(dx, want_dx, BF16_GEMM_REL, "grouped_matmul dX"),
        lambda: kgm.grouped_matmul_dx_cuda(dy, w), 20,
        time_ms(torch, lambda: ref.grouped_matmul(dy, wt), 5),
        library_time(torch, lambda: torch.bmm(dy, wt), want_dx, BF16_GEMM_REL, 20,
                     "grouped_matmul_dx (torch.bmm)"),
        (e * c * f + e * d * f + e * c * d) * 2, gemm, "bfloat16",
        f"dy [{e}, {c}, {f}] bf16 @ w[e]^T, w [{e}, {d}, {f}]",
    )
    dw = kgm.grouped_matmul_dw_cuda(x, dy)
    rows["grouped_matmul_dw"] = kernel_row(
        torch, "grouped_matmul_dw", check_rel(dw, want_dw, BF16_GEMM_REL, "grouped_matmul dW"),
        lambda: kgm.grouped_matmul_dw_cuda(x, dy), 20,
        time_ms(torch, lambda: ref.grouped_matmul_dw(x, dy), 5),
        library_time(torch, lambda: torch.bmm(xt, dy), want_dw, BF16_GEMM_REL, 20,
                     "grouped_matmul_dw (torch.bmm)"),
        (e * c * d + e * c * f + e * d * f) * 2, gemm, "bfloat16",
        f"x [{e}, {c}, {d}], dy [{e}, {c}, {f}] bf16 -> dW [{e}, {d}, {f}]",
    )
    del w, y, want, want_dx, want_dw, dx, dw, wt, xt
    # The w_out shapes: the hidden [E, C, F] (zero in empty slots) times
    # w_out [E, F, D], and dX of that product, [E, C, D] @ w_out[e]^T.
    h = randn(e, c, f, dt=bf16)
    h.reshape(-1, f)[plan2.src < 0] = 0
    w_out = (randn(e, f, d) * f**-0.5).to(bf16)
    dy_out = randn(e, c, d, dt=bf16)
    dy_out.reshape(-1, d)[plan2.src < 0] = 0
    want = ref.grouped_matmul(h, w_out)
    rows["grouped_matmul_wout"] = kernel_row(
        torch, "grouped_matmul_wout",
        check_rel(kgm.grouped_matmul_cuda(h, w_out), want, BF16_GEMM_REL, "grouped_matmul w_out"),
        lambda: kgm.grouped_matmul_cuda(h, w_out), 20,
        time_ms(torch, lambda: ref.grouped_matmul(h, w_out), 5),
        library_time(torch, lambda: torch.bmm(h, w_out), want, BF16_GEMM_REL, 20,
                     "grouped_matmul_wout (torch.bmm)"),
        (e * c * f + e * f * d + e * c * d) * 2, gemm, "bfloat16",
        f"h [{e}, {c}, {f}] bf16 @ w_out [{e}, {f}, {d}], {empty} empty slots",
    )
    want = ref.grouped_matmul_dw(h, dy_out)
    ht = h.transpose(1, 2)
    rows["grouped_matmul_dw_wout"] = kernel_row(
        torch, "grouped_matmul_dw_wout",
        check_rel(kgm.grouped_matmul_dw_cuda(h, dy_out), want, BF16_GEMM_REL,
                  "grouped_matmul dW w_out"),
        lambda: kgm.grouped_matmul_dw_cuda(h, dy_out), 20,
        time_ms(torch, lambda: ref.grouped_matmul_dw(h, dy_out), 5),
        library_time(torch, lambda: torch.bmm(ht, dy_out), want, BF16_GEMM_REL, 20,
                     "grouped_matmul_dw_wout (torch.bmm)"),
        (e * c * f + e * c * d + e * f * d) * 2, gemm, "bfloat16",
        f"h [{e}, {c}, {f}], dy [{e}, {c}, {d}] bf16 -> dW [{e}, {f}, {d}]",
    )
    del ht
    wt = w_out.transpose(1, 2)
    want = ref.grouped_matmul(dy_out, wt)
    rows["grouped_matmul_dx_wout"] = kernel_row(
        torch, "grouped_matmul_dx_wout",
        check_rel(kgm.grouped_matmul_dx_cuda(dy_out, w_out), want, BF16_GEMM_REL,
                  "grouped_matmul dX w_out"),
        lambda: kgm.grouped_matmul_dx_cuda(dy_out, w_out), 20,
        time_ms(torch, lambda: ref.grouped_matmul(dy_out, wt), 5),
        library_time(torch, lambda: torch.bmm(dy_out, wt), want, BF16_GEMM_REL, 20,
                     "grouped_matmul_dx_wout (torch.bmm)"),
        (e * c * d + e * f * d + e * c * f) * 2, gemm, "bfloat16",
        f"dy [{e}, {c}, {d}] bf16 @ w_out[e]^T, w_out [{e}, {f}, {d}]",
    )
    del x, dy, h, w_out, dy_out, want, wt
    capacity_edge_cases(torch, g)
    return rows


def capacity_edge_cases(torch, g):
    """C in {4, 12, 20, 200, 257, 260, 300, 520}, E = 1, an expert whose
    rows are all zero, f32 and bf16, K and N multiples of 8 that are not
    multiples of the tiles."""
    from repro_torch.kernels import grouped_matmul as kgm
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        rel = BF16_GEMM_REL if dt == torch.bfloat16 else 1e-5
        for e, c, kd, nd in ((3, 4, 64, 192), (3, 12, 72, 136), (1, 20, 40, 200),
                             (3, 200, 136, 72), (2, 260, 4096, 200), (2, 300, 136, 200),
                             (2, 257, 72, 136), (2, 520, 8, 40)):
            x = torch.randn((e, c, kd), generator=g, device=dev)
            x[:, c - c // 4:] = 0  # unfilled slots
            if e > 1:
                x[1] = 0  # an expert that got no choice
            x = x.to(dt)
            w = (torch.randn((e, kd, nd), generator=g, device=dev) / kd**0.5).to(dt)
            dy = torch.randn((e, c, nd), generator=g, device=dev).to(dt)
            y = kgm.grouped_matmul_cuda(x, w)
            errs.append(check_rel(y, ref.grouped_matmul(x, w), rel, f"cap edge {dt} {e}x{c}"))
            want_dx, want_dw = _grads(torch, lambda a, b: ref.grouped_matmul(a, b), [x, w], dy)
            errs.append(check_rel(kgm.grouped_matmul_dx_cuda(dy, w), want_dx, rel, "cap dX edge"))
            dwk = kgm.grouped_matmul_dw_cuda(x, dy)
            errs.append(check_rel(dwk, want_dw, rel, "cap dW edge"))
            if e > 1:
                assert not y[1].any() and not dwk[1].any(), "an empty expert must give zeros"
    torch.cuda.synchronize()
    print(f"capacity kernels edge cases: {len(errs)} comparisons within tolerance, "
          f"max_abs_err={max(errs):.3e}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: one training step, card against CPU
# ---------------------------------------------------------------------------


def step_card_vs_cpu(torch, seed: int, cfg=None, **moe_kw) -> float:
    """Loss and every parameter's gradient of one step at a reduced width,
    f32, on the card (kernels) and on the CPU (plain versions): Mixtral at
    d_model 512, ``moe_kw`` overriding its MoE config (the capacity layout),
    or ``cfg``.  Tolerance: the loss within 1e-4 relative; each gradient
    within 1e-3 of its largest magnitude (f32 sums in another order through
    two layers), and no gradient may be zero on one side only (a cut
    gradient)."""
    from repro_torch.configs.paper_models import MIXTRAL_8X7B_CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.train_step import init_all, loss_fn

    if cfg is None:
        cfg = dataclasses.replace(
            MIXTRAL_8X7B_CONFIG, num_layers=2, d_model=512, num_heads=4, num_kv_heads=2,
            d_ff=1024, dtype="float32",
            moe=dataclasses.replace(MIXTRAL_8X7B_CONFIG.moe, d_ff=1024, **moe_kw),
        )
    plan = make_plan(None)
    params, _, _ = init_all(seed, cfg, plan, AdamWConfig(), device="cpu")
    b = next(iter(SyntheticLM(cfg.vocab_size, 64, 2, seed=seed)))

    def run(dev):
        tree = _map_tree(params, lambda t: t.detach().to(dev).requires_grad_())
        batch = {"tokens": torch.as_tensor(b.tokens, device=dev),
                 "labels": torch.as_tensor(b.labels, device=dev)}
        leaves = dict(_flat_tree(tree))
        loss, _ = loss_fn(tree, batch, cfg, plan)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach().cpu(), {k: g.detach().cpu() for k, g in zip(leaves, grads)}

    loss_cpu, g_cpu = run("cpu")
    loss_gpu, g_gpu = run("cuda")
    assert abs(loss_gpu.item() - loss_cpu.item()) <= 1e-4 * abs(loss_cpu.item()), \
        f"step loss card {loss_gpu.item()} vs cpu {loss_cpu.item()}"
    worst = 0.0
    for name, want in g_cpu.items():
        got = g_gpu[name]
        scale = want.abs().max().item()
        assert (scale == 0.0) == (got.abs().max().item() == 0.0), f"{name}: gradient cut"
        err = (got - want).abs().max().item()
        assert err <= 1e-3 * scale + 1e-7, f"{name}: max |diff| {err} vs max |grad| {scale}"
        worst = max(worst, err / max(scale, 1e-30))
    what = (f"dispatch={cfg.moe.dispatch} (capacity factor {cfg.moe.capacity_factor})"
            if cfg.is_moe else f"{cfg.name} (head dim {cfg.resolved_head_dim}, window "
            f"{cfg.window_size}, softcaps {cfg.logit_softcap}/{cfg.final_softcap}, 64 tokens)")
    print(f"step: card vs cpu, {what}, remat={cfg.remat}, at d_model {cfg.d_model}, "
          f"{cfg.num_layers} layers, "
          f"{len(g_cpu)} gradients: loss {loss_gpu.item():.6f} vs {loss_cpu.item():.6f}, "
          f"worst max|diff|/max|grad| = {worst:.3e}", flush=True)
    return worst


def _flat_tree(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tree(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 8: train Mixtral-8x7B (2 of 32 layers) through Trainer
# ---------------------------------------------------------------------------


def make_trainer(torch, cfg, seed: int, **tcfg_kw):
    """A Mixtral ``Trainer`` on the card with a 4-device control plane
    injected (COPILOT on): placement needs freedom, 2 experts per device, as
    the reference's own trainer test injects (tests/test_train.py:222)."""
    from repro_torch.core.controlplane import ControlPlane
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tr = Trainer(
        cfg, AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS),
        TrainerConfig(total_steps=TRAIN_STEPS, reconfig_every=2, reconfig_min_gain=0.0,
                      **tcfg_kw),
        make_plan(None), seed=seed, device="cuda",
    )
    tr.controlplane = ControlPlane(num_layers=cfg.num_layers, num_experts=cfg.moe.num_experts,
                                   num_devices=4, use_copilot=True, min_gain_fraction=0.0)
    return tr


def train(torch, cfg, seed: int, profile: bool, kernels, *, setup=None, after_call=None):
    """Train ``cfg`` 8 steps through ``Trainer``, one ``train`` call per
    step.  ``setup(tr)`` runs before the first call; ``after_call(step, tr)``
    after each call, outside its clock.  Every kernel in ``kernels`` must
    launch."""
    import numpy as np

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import make_plan

    plan = make_plan(None)
    seq, batch = 256, 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = make_trainer(torch, cfg, seed)
    if setup is not None:
        setup(tr)
    nparams = sum(t.numel() for _, t in _flat_tree(tr.params))
    torch.cuda.synchronize()
    print(f"model: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"experts={cfg.moe.num_experts} top{cfg.moe.top_k} d_ff={cfg.moe.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers}/32 backend={cfg.moe.backend} "
          f"dispatch={cfg.moe.dispatch} capacity_factor={cfg.moe.capacity_factor} "
          f"remat={cfg.remat}: {nparams / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB with moments, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)

    # The main path, one Trainer.train call per step (the loop resumes where
    # it stopped), so that each call's wall clock covers the step AND what
    # follows it: the control loop (observe, COPILOT's refit, plans) and the
    # in-place permute, which the step's own clock leaves out.  Nothing but
    # training runs between the count reset and the read.
    data = iter(SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed))
    perms = [np.asarray(tr.expert_perm).copy()]
    call_ms, peaks = [], []
    ops.reset_launch_counts()
    for s in range(1, TRAIN_STEPS + 1):
        tr.tcfg.total_steps = s
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.train(data)
        torch.cuda.synchronize()
        call_ms.append(1e3 * (time.perf_counter() - t0))
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        perms.append(np.asarray(tr.expert_perm).copy())
        if after_call is not None:
            after_call(s, tr)
    counts = ops.launch_counts()
    log = tr.metrics_log
    losses = [float(m["loss"]) for m in log]
    step_ms = [1e3 * m["step_time_s"] for m in log]
    outside = [c - st for c, st in zip(call_ms, step_ms)]
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    window_tps = batch * seq * (TRAIN_STEPS - 1) / (sum(call_ms[1:]) / 1e3)
    peak = max(peaks)
    moves = [i for i in range(TRAIN_STEPS) if not np.array_equal(perms[i], perms[i + 1])]
    assert all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}"
    assert tr.reconfig_count > 0 and moves, "the control plane never reconfigured"
    missing = [nm for nm in kernels if counts[nm] == 0]
    assert not missing, f"kernels never launched while training: {missing}"
    print(f"train: losses {['%.4f' % v for v in losses]}", flush=True)
    drops = [np.asarray(m["dropped_fraction"]).tolist() for m in log]
    print("train: dropped fraction of routed choices per step (per layer): "
          + ", ".join(f"{i + 1}: {['%.4f' % v for v in dr]}" for i, dr in enumerate(drops)),
          flush=True)
    print(f"train: {TRAIN_STEPS} steps of {batch}x{seq} tokens: median step {med:.1f} ms "
          f"(trainer's clock, steps 2-{TRAIN_STEPS}), {batch * seq / med * 1e3:.1f} tokens/s at "
          f"that median; whole window (steps 2-{TRAIN_STEPS}, control loop and permutes "
          f"included) {sum(call_ms[1:]):.1f} ms, {window_tps:.1f} tokens/s; peak memory "
          f"{peak:.2f} GB (training only); {tr.reconfig_count} layer re-placements in "
          f"{len(moves)} applied reconfigurations (after steps {[i + 1 for i in moves]})",
          flush=True)
    print("train: per step ms (step / after the step: control loop, COPILOT, plans, permute): "
          + ", ".join(f"{i + 1}: {st:.1f} / {o:.1f}{' *' if i in moves else ''}"
                      for i, (st, o) in enumerate(zip(step_ms, outside)))
          + "  (* = weights moved)", flush=True)
    print(f"train: launches {counts} (per step: "
          f"{ {k: v / TRAIN_STEPS for k, v in counts.items() if v} })", flush=True)
    checks = replacement_check(torch, tr, cfg, plan, perms, moves, seq, batch, seed)
    if profile:
        profile_train(torch, tr, data, seq * batch)
    del tr
    torch.cuda.empty_cache()
    return counts, dict(losses=losses, median_ms=med, window_tps=window_tps, peak_gb=peak,
                        checks=checks, call_ms=call_ms, perms=perms, drops=drops)



def replacement_check(torch, tr, cfg, plan, perms, moves, seq: int, batch: int, seed: int):
    """Replays every applied reconfiguration of the run on the trained
    weights: from the slot layout before it, a fixed probe batch's loss and
    expert gradients; then the same in-place move the trainer made
    (``permute_expert_weights``), and the probe again.  Loss and gradients
    must be bit-identical once the permutation is undone.  The weights end
    in the trainer's final layout."""
    import numpy as np

    from repro_torch.core.controlplane import permute_expert_weights
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.train_step import loss_fn

    pb = next(iter(SyntheticLM(cfg.vocab_size, seq, batch, seed=seed + 1)))
    probe_batch = {"tokens": torch.as_tensor(pb.tokens, device="cuda"),
                   "labels": torch.as_tensor(pb.labels, device="cuda")}
    moe = tr.params["blocks"]["0_global"]["moe"]
    names = ("w_in", "w_gate", "w_out")
    ev = cfg.moe.num_experts

    def probe(perm):
        loss, _ = loss_fn(tr.params, probe_batch, cfg, plan,
                          expert_perm=torch.as_tensor(perm, dtype=torch.int32, device="cuda"))
        grads = torch.autograd.grad(loss, [moe[nm] for nm in names])
        return loss.detach(), dict(zip(names, grads))

    def move(src, dst):
        # Slot s of the dst layout takes the expert that sits at src[e] for
        # the expert e that dst puts in s.
        permute_expert_weights(tr.params, np.take_along_axis(src, np.argsort(dst, 1), 1), ev)

    layout = perms[-1]
    checks = []
    for i in moves:
        before, after = perms[i], perms[i + 1]
        move(layout, before)
        loss0, g0 = probe(before)
        move(before, after)
        layout = after
        loss1, g1 = probe(after)
        assert torch.equal(loss0, loss1), f"probe loss moved: {loss0.item()} -> {loss1.item()}"
        for nm in names:
            for li in range(len(before)):
                a = g0[nm][li][torch.as_tensor(before[li], device="cuda").long()]
                b = g1[nm][li][torch.as_tensor(after[li], device="cuda").long()]
                assert torch.equal(a, b), f"{nm} layer {li}: gradient moved with its expert"
        moved = int((before != after).sum())
        checks.append((i + 1, loss0.item(), moved))
        print(f"train: reconfiguration after step {i + 1} moved {moved} expert slots; replayed "
              f"on the trained weights, probe loss {loss0.item():.6f} and expert gradients "
              f"bit-identical", flush=True)
        del g0, g1
    move(layout, perms[-1])
    return checks


TRAIN_KERNELS = (
    "topk_gating", "topk_gating_bwd", "flash_attention", "flash_attention_bwd", "moe_dispatch",
    "moe_combine", "moe_combine_bwd", "grouped_matmul_blocks", "grouped_matmul_blocks_dx",
    "grouped_matmul_blocks_dw", "rmsnorm", "rmsnorm_bwd",
)
CAPACITY_KERNELS = TRAIN_KERNELS[:7] + ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw",
                                        "rmsnorm", "rmsnorm_bwd")
# Kernel rows at a second shape of the path -> the kernel they time.
SHAPE_ROWS = {
    "moe_dispatch_pack": "moe_dispatch", "moe_dispatch_unpack": "moe_dispatch",
    "moe_combine_bf16": "moe_combine",
    "grouped_matmul_wout": "grouped_matmul", "grouped_matmul_dx_wout": "grouped_matmul_dx",
    "grouped_matmul_dw_wout": "grouped_matmul_dw",
    "grouped_matmul_blocks_wout": "grouped_matmul_blocks",
    "grouped_matmul_blocks_dx_wout": "grouped_matmul_blocks_dx",
    "grouped_matmul_blocks_dw_wout": "grouped_matmul_blocks_dw",
    "grouped_matmul_blocks_skew": "grouped_matmul_blocks",
    "grouped_matmul_blocks_dw_skew": "grouped_matmul_blocks_dw",
    "paged_flash_decode_long": "paged_flash_decode", "paged_flash_decode_verify": "paged_flash_decode",
    "paged_flash_decode_chunk": "paged_flash_decode",
    "rmsnorm_prefill_d": "rmsnorm", "rmsnorm_decode_inner": "rmsnorm",
    "rmsnorm_decode_d": "rmsnorm", "rmsnorm_grok": "rmsnorm", "rmsnorm_mixtral": "rmsnorm",
    "ssd_chunk_prefill_256": "ssd_chunk", "ssd_chunk_generate": "ssd_chunk",
    "moe_dispatch_rank_pack": "moe_dispatch", "grouped_matmul_blocks_rank": "grouped_matmul_blocks",
    "moe_combine_rank": "moe_combine", "grouped_matmul_blocks_stage": "grouped_matmul_blocks",
    "grouped_matmul_blocks_chunk": "grouped_matmul_blocks",
    "flash_attention_gemma2": "flash_attention", "flash_attention_bwd_gemma2": "flash_attention_bwd",
    "rmsnorm_gemma2": "rmsnorm", "rmsnorm_bwd_gemma2": "rmsnorm_bwd",
    "paged_flash_decode_gemma2": "paged_flash_decode",
    "paged_flash_decode_gemma2_admit": "paged_flash_decode",
    "paged_flash_decode_group1": "paged_flash_decode", "rmsnorm_mistral": "rmsnorm",
}
# Kernels that only the forward launches (the backward launches moe_dispatch
# and moe_combine too): under remat each launches twice a step.
FORWARD_KERNELS = ("topk_gating", "flash_attention", "grouped_matmul_blocks")


def remat_phase(torch, seed: int):
    """One forward and backward of Mixtral-8x7B (full width, 2 of 32 layers,
    dropless) with remat "none", "full" and "dots" on the same weights and
    batch: loss and every gradient bit-identical; the forward's launches
    equal, and under remat the backward launches the forward again (each
    kernel's total = "none"'s total + its forward launches, but for the
    final norm, which no remat covers).  Peak memory
    and the host clock of each (after one untimed warm-up)."""
    from repro_torch.configs.paper_models import MIXTRAL_8X7B_CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.train_step import loss_fn

    cfg0 = dataclasses.replace(MIXTRAL_8X7B_CONFIG, num_layers=TRAIN_LAYERS)
    plan = make_plan(None)
    params = tfm.init_model(seed, cfg0, plan, device="cuda")
    leaves = [(k, t.requires_grad_(True)) for k, t in _flat_tree(params) if t.is_floating_point()]
    b = next(iter(SyntheticLM(cfg0.vocab_size, 256, 2, seed=seed)))
    batch = {"tokens": torch.as_tensor(b.tokens, device="cuda"),
             "labels": torch.as_tensor(b.labels, device="cuda")}

    def run(remat):
        cfg = dataclasses.replace(cfg0, remat=remat)
        ops.reset_launch_counts()
        loss, _ = loss_fn(params, batch, cfg, plan)
        fwd = ops.launch_counts()
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        torch.cuda.synchronize()
        return loss.detach(), grads, fwd, ops.launch_counts()

    run("none")  # warm-up: cuBLAS handles, allocator pools
    base = None
    for remat in ("none", "full", "dots"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grads, fwd, total = run(remat)
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        print(f"remat {remat}: loss {loss.item():.6f}, forward + backward {ms:.1f} ms (host "
              f"clock), peak {peak / 1e9:.3f} GB ({(peak - held) / 1e9:.3f} GB above the "
              f"{held / 1e9:.3f} GB held before), launches forward {fwd} total {total}",
              flush=True)
        if base is None:
            base = (loss, grads, fwd, total)
            continue
        assert torch.equal(loss, base[0]), f"remat {remat}: loss {loss.item()} != {base[0].item()}"
        for (name, _), a, g in zip(leaves, grads, base[1]):
            assert torch.equal(a, g), f"remat {remat}: gradient of {name} differs"
        for nm, v in fwd.items():
            assert v == base[2][nm], f"remat {remat}: {nm} forward launches {v} != {base[2][nm]}"
            # The final norm runs outside the rematerialised layers: the
            # backward recomputes every forward launch but that one.
            again = v - (nm == "rmsnorm")
            assert total[nm] == base[3][nm] + again, \
                f"remat {remat}: {nm} launched {total[nm]}, want {base[3][nm]} + {again} recomputed"
        for nm in FORWARD_KERNELS:
            assert total[nm] == 2 * base[3][nm] > 0, f"remat {remat}: {nm} did not double"
        del grads
    print(f"remat: loss and all {len(leaves)} gradients bit-identical under none / full / dots; "
          f"forward kernels launch twice under full and dots", flush=True)
    del params, leaves, base
    torch.cuda.empty_cache()


def state_checksum(torch, tree) -> dict:
    """Per leaf, two exact integer sums of its bits (plain and
    position-weighted, int64 with wrap-around), computed on the card."""
    ch = 1 << 26
    weight = torch.arange(ch, device="cuda", dtype=torch.int64) * 40503 % 65521 + 1
    bits_of = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for name, t in _flat_tree(tree):
        flat = t.detach().reshape(-1).view(bits_of[t.element_size()])
        s1 = s2 = 0
        for i in range(0, flat.numel(), ch):
            c = flat[i:i + ch].long()
            s1 += int(c.sum())
            s2 += int((c * weight[: c.numel()]).sum())
        out[name] = (s1, s2)
    return out


def train_capacity_and_resume(torch, seed: int, profile: bool):
    """Mixtral-8x7B (full width, 2 of 32 layers) with dispatch="capacity",
    capacity factor 1.25 and remat "full", trained exactly like the dropless
    run.  The trainer writes a checkpoint at step 4 (synchronous, keep 1)
    under build/; the state after step 4 and step 5's loss and state are
    recorded.  Then a fresh trainer (another init seed) restores it: the
    restored parameters, moments, step and perm stack must equal the saved
    ones bit for bit, and step 5 on the same batch must give the same loss
    and state bit for bit."""
    import shutil

    import numpy as np

    from repro_torch.configs.paper_models import MIXTRAL_8X7B_CONFIG
    from repro_torch.data.pipeline import SyntheticLM

    cfg = capacity_config(dataclasses.replace(MIXTRAL_8X7B_CONFIG, num_layers=TRAIN_LAYERS))
    ckpt_dir = REPO / "build" / "smoke_checkpoint"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec: dict = {}

    def setup(tr):
        tr.tcfg.ckpt_dir, tr.tcfg.ckpt_every = str(ckpt_dir), 4
        tr.tcfg.ckpt_async, tr.tcfg.ckpt_keep = False, 1
        write = tr._checkpoint

        def timed_write():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            write()
            rec["write_s"] = time.perf_counter() - t0

        tr._checkpoint = timed_write

    def after_call(step, tr):
        state = {"params": tr.params, "opt": tr.opt_state}
        if step == 4:
            tr.tcfg.ckpt_every = 0  # one checkpoint: the run resumes from step 4
            rec["sum4"] = state_checksum(torch, state)
            rec["perm4"] = np.asarray(tr.expert_perm).copy()
            rec["bytes"] = sum(t.numel() * t.element_size() for _, t in _flat_tree(state))
        elif step == 5:
            rec["loss5"] = np.float32(tr.metrics_log[-1]["loss"])
            rec["sum5"] = state_checksum(torch, state)

    try:
        counts, info = train(torch, cfg, seed, profile, CAPACITY_KERNELS, setup=setup,
                             after_call=after_call)
        gb = rec["bytes"] / 1e9
        window_ms = sum(info["call_ms"][1:]) - 1e3 * rec["write_s"]
        print(f"train capacity: whole window without the checkpoint write {window_ms:.1f} ms, "
              f"{2 * 256 * (TRAIN_STEPS - 1) / (window_ms / 1e3):.1f} tokens/s; checkpoint at "
              f"step 4: {gb:.3f} GB written in {rec['write_s']:.2f} s, "
              f"{gb / rec['write_s']:.3f} GB/s", flush=True)

        tr = make_trainer(torch, cfg, seed + 1, ckpt_dir=str(ckpt_dir))
        tr.tcfg.total_steps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assert tr.maybe_restore(), "no checkpoint found"
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        state = {"params": tr.params, "opt": tr.opt_state}
        assert tr.step == 4 and int(tr.opt_state["step"]) == 4, (tr.step, tr.opt_state["step"])
        assert state_checksum(torch, state) == rec["sum4"], "restored state differs from saved"
        assert np.array_equal(np.asarray(tr.expert_perm), rec["perm4"]), "perm stack differs"
        data = iter(SyntheticLM(cfg.vocab_size, seq_len=256, global_batch=2, seed=seed))
        for _ in range(4):
            next(data)
        tr.train(data)
        loss5 = np.float32(tr.metrics_log[-1]["loss"])
        assert loss5.tobytes() == rec["loss5"].tobytes(), f"step 5 loss {loss5} != {rec['loss5']}"
        assert state_checksum(torch, state) == rec["sum5"], "state after the resumed step differs"
        print(f"resume: {gb:.3f} GB read back in {read_s:.2f} s, {gb / read_s:.3f} GB/s; "
              f"parameters, moments, step 4 and perm stack bit-identical; resumed step 5 loss "
              f"{float(loss5):.6f} and state bit-identical to the uninterrupted run", flush=True)
        del tr, state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return counts, info


def serve_checkpoint_phase(torch, seed: int):
    """Reduced grok-1, head dim 64 (the port of tests/test_serve.py:253-288 on
    the card):
    serve with reconfiguration until the placement moved, save, restore into
    a fresh engine; the same probe requests then give bit-identical tokens
    on both.  An engine without a control plane refuses the placement."""
    import shutil

    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.workload import WorkloadGenerator

    cfg = get_reduced("grok-1-314b", head_dim=64)  # the kernels take head dims 64, 128, 256
    plan = make_plan(None)
    params = init_model(seed, cfg, plan, device="cuda")

    def requests(gen, n):
        return [dataclasses.replace(r, prompt_len=min(r.prompt_len, 20),
                                    max_new_tokens=min(r.max_new_tokens, 6))
                for r in gen.generate(n)]

    def engine(reconfig_every):
        scfg = ServeConfig(slots=2, max_len=40, reconfig_every=reconfig_every,
                           reconfig_min_gain=0.0, num_devices=4)
        return ServeEngine(_map_tree(params, lambda t: t.clone()), cfg, plan, scfg,
                           device="cuda")

    ckpt_dir = REPO / "build" / "smoke_serve_checkpoint"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        gen = WorkloadGenerator("chat", seed=9, vocab_size=cfg.vocab_size)
        eng = engine(2)
        eng.run(requests(gen, 3), gen)
        stack = eng.controlplane.perm_stack()
        assert eng.controlplane.reconfig_count > 0, "the control plane never reconfigured"
        step = eng.save_checkpoint(str(ckpt_dir))
        fresh = engine(10**9)
        fresh.restore_checkpoint(str(ckpt_dir), step)
        assert (fresh.batcher.expert_perm == stack).all(), "restored perm stack differs"
        probe = requests(WorkloadGenerator("chat", seed=11, vocab_size=cfg.vocab_size), 2)
        eng.scfg.reconfig_every = 10**9
        eng.run(probe, WorkloadGenerator("chat", seed=11, vocab_size=cfg.vocab_size))
        fresh.run(probe, WorkloadGenerator("chat", seed=11, vocab_size=cfg.vocab_size))
        ids = {p.rid for p in probe}
        a = {r.rid: r.out for r in eng.batcher.finished if r.rid in ids}
        b = {r.rid: r.out for r in fresh.batcher.finished}
        assert a == b and len(a) == len(probe), f"tokens differ after restore: {a} vs {b}"
        try:
            engine(0).restore_checkpoint(str(ckpt_dir), step)
            raise AssertionError("an engine without a control plane took the placement")
        except RuntimeError:
            pass
        print(f"serve checkpoint: {cfg.name} reduced, saved at tick {step} after "
              f"{eng.controlplane.reconfig_count} reconfigurations, restored into a fresh "
              f"engine: {sum(len(v) for v in a.values())} probe tokens bit-identical", flush=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def profile_train(torch, tr, data, tokens: int):
    """Device time by kernel class over two training steps (``--profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr.tcfg.total_steps = tr.step + 2
    tr.controlplane = None  # no reconfiguration (and no probes) in the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train(data)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    classes: dict[str, float] = {}
    kernels = []
    ours = ("topk_gating", "flash_fwd", "flash_bwd", "vector_gather_kernel", "combine", "gmm_")
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        low = ev.key.lower()
        if any(w in low for w in ours):
            cls = "ported kernels"
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            cls = "matmul (cuBLAS)"
        elif "memcpy" in low or "memset" in low:
            cls = "copies"
        else:
            cls = "other PyTorch kernels"
        classes[cls] = classes.get(cls, 0.0) + ms
        kernels.append((ms, ev.count, ev.key[:90]))
    busy = sum(classes.values())
    print(f"profile train: 2 steps of {tokens} tokens, wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), idle {100 * (1 - busy / wall_ms):.1f}%",
          flush=True)
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"profile train class {cls}: {ms:.2f} ms ({100 * ms / busy:.1f}% of device time)")
    # The grouped GEMMs (kernel 7 or 6, forward and dX; the dW kernels).
    gmm = [(ms, name.lower()) for ms, _, name in kernels if "gmm_" in name.lower()]
    dw = sum(ms for ms, name in gmm if "dw_" in name)
    fwd = sum(ms for ms, _ in gmm) - dw
    print(f"profile train grouped GEMMs: forward and dX {fwd:.3f} ms ({100 * fwd / busy:.1f}%), "
          f"dW {dw:.3f} ms ({100 * dw / busy:.1f}% of device time)", flush=True)
    # The 16 largest, then every ported kernel below them.
    top = sorted(kernels, reverse=True)
    for ms, n, name in top[:16] + [k for k in top[16:] if any(w in k[2].lower() for w in ours)]:
        print(f"profile train kernel {ms:9.3f} ms ({100 * ms / busy:4.1f}%) x{n:<5} {name}")


# ---------------------------------------------------------------------------
# Mamba-2 (slice 4): kernels 8 and 9, the prefill-then-decode check, serve,
# generate
# ---------------------------------------------------------------------------

MAMBA_REQUESTS = 8
SSM_KERNELS = ("rmsnorm", "ssd_chunk")
# f32 sums over N = 128 products and up to 256 gated terms in another order
# than the plain version, and cumulative sums taken in another order:
# 1e-4 of the largest magnitude.
SSD_REL = 1e-4
# Mamba-2 at full width with random weights amplifies a rounding difference
# through its 48 layers until, in bf16, it is as large as the logits: two
# prefills of the same tokens that differ only in chunk length (L = 201 and
# 256) disagree about as much as the recurrence and the scan do (the ssm
# check prints both; PERF.md has the H100's numbers).  So the path is held
# in f32 at full depth, within 2e-2 of the largest logit (f32 sums in
# another order: cuBLAS, the kernels, the scan against the recurrence), and
# in bf16 at depth 2, within 5e-2 (activations rounded along two paths, as
# the paged decode check); the served bf16 model at full depth is measured,
# not held.  A misplaced state, chunk or row is off by O(1).
MAMBA_F32_LOGIT_REL = 2e-2
MAMBA_LOGIT_REL = 5e-2
# A reduced f32 forward on the card against the CPU: f32 in another order.
REDUCED_FEAT_TOL = dict(rtol=1e-4, atol=1e-4)


def ssd_inputs(torch, g, groups: int, heads: int, l: int, p: int, n: int, da_fill=None):
    """Inputs of kernel 9 as the model builds them: ``x`` dt-weighted,
    ``da = dt * A`` with ``A = -1`` (``A_log`` = 0 at init), B and C once per
    (batch, chunk) -> (x, da, bmat, cmat) on the card, f32."""
    dev = torch.device("cuda")
    dt = torch.nn.functional.softplus(torch.randn((groups, l), generator=g, device=dev))
    x = torch.randn((groups, l, p), generator=g, device=dev) * dt[:, :, None]
    da = -dt if da_fill is None else torch.full((groups, l), float(da_fill), device=dev)
    bmat = torch.randn((groups // heads, l, n), generator=g, device=dev)
    cmat = torch.randn((groups // heads, l, n), generator=g, device=dev)
    return x, da, bmat, cmat


def ssd_plain(torch, x, da, bmat, cmat, heads: int):
    """The plain version on the per-group copy of B and C it takes."""
    from repro_torch.kernels import ref

    ex = lambda m: m.repeat_interleave(heads, dim=0)
    return ref.ssd_chunk(x, da, ex(bmat), ex(cmat))


def ssd_cost(g: int, bc: int, l: int, p: int, n: int) -> tuple[float, float]:
    """(bytes, FLOP) the least work needs: x, da, B and C (once per (batch,
    chunk)) read once, y and the state written once; C B^T once per (batch,
    chunk) and the gated product over the causal half (s <= l) only, plus
    the state product."""
    tri = l * (l + 1) / 2
    bytes_moved = 4.0 * (2 * g * l * p + g * l + 2 * bc * l * n + g * n * p)
    flops = 2.0 * bc * tri * n + 2.0 * g * tri * p + 2.0 * g * l * n * p
    return bytes_moved, flops


def chunk_len(s_len: int, chunk: int) -> int:
    """Kernel 9's L for a prefill of ``s_len`` tokens: the largest divisor
    of S not above the chunk (``models/ssm.py``'s ``_ssd_chunked``)."""
    l = min(chunk, s_len)
    while s_len % l:
        l -= 1
    return l


def ssm_kernel_phase(torch, cfg, seed: int, serve_lens, slots: int):
    """Kernels 8 and 9 at Mamba-2 1.3B's shapes on the serving path, against
    their plain versions on the card, then edge cases.  ``serve_lens``: the
    prompt lengths the Mamba-2 serve prefills, ``slots`` its decode batch.
    -> {row name: {launch shape: row}}: each kernels-line row is timed at
    every shape it stands for, and takes those shapes' launches from the run
    that launches them (``shape_row``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    s = cfg.ssm
    d, inner = cfg.d_model, s.expand * cfg.d_model
    heads, p, n = inner // s.head_dim, s.head_dim, s.state_dim
    rows = {"ssd_chunk": {}, "ssd_chunk_prefill_256": {}, "ssd_chunk_generate": {},
            "rmsnorm": {}, "rmsnorm_prefill_d": {}, "rmsnorm_decode_inner": {},
            "rmsnorm_decode_d": {}}

    # -- kernel 9 at each prefill of the serve (one row, batch 1), at one
    # 256-token prefill (G = 64) and at generate's batch of 4 x 512 tokens
    # (2 chunks each, G = 512).
    shapes = [("ssd_chunk", f"serve prefill of {t} tokens", t // chunk_len(t, s.chunk),
               chunk_len(t, s.chunk)) for t in sorted(set(serve_lens))]
    shapes += [("ssd_chunk_prefill_256", "prefill of 256 tokens", 1, s.chunk),
               ("ssd_chunk_generate", "generate, 4 x 512 tokens", 8, s.chunk)]
    for row_name, what, batch_chunks, l in shapes:
        gg = batch_chunks * heads
        x, da, bm, cm = ssd_inputs(torch, g, gg, heads, l, p, n)
        y, st = ssd_chunk_cuda(x, da, bm, cm, heads)
        wy, wst = ssd_plain(torch, x, da, bm, cm, heads)
        err = max(check_rel(y, wy, SSD_REL, f"ssd_chunk y ({what})"),
                  check_rel(st, wst, SSD_REL, f"ssd_chunk state ({what})"))
        bytes_moved, flops = ssd_cost(gg, batch_chunks, l, p, n)
        # The kernel runs each f32 product as three TF32 products (3xTF32):
        # its bound is three times the least FLOP at the TF32 rate.
        rows[row_name][(gg, l)] = kernel_row(
            torch, row_name, err, lambda: ssd_chunk_cuda(x, da, bm, cm, heads), 50,
            time_ms(torch, lambda: ssd_plain(torch, x, da, bm, cm, heads), 10), NO_LIBRARY,
            bytes_moved, 3 * flops, "tfloat32",
            f"{what}: x [{gg}, {l}, {p}] f32, B/C [{batch_chunks}, {l}, {n}] shared by "
            f"{heads} heads; {flops / 1e9:.4f} GFLOP x 3 TF32", graph=True,
        )

    # -- kernel 8: norm1 and the final norm (D = d_model) and the gated norm
    # (D = inner, the gate z fused in: bit for bit the kernel on PyTorch's
    # y * silu(z), the sequence it replaces, which is the library yardstick
    # with F.rms_norm) at each prefill of the serve and at its decode ticks
    # of ``slots`` rows.
    shapes = [(name, t, dd) for t in sorted(set(serve_lens))
              for name, dd in (("rmsnorm", inner), ("rmsnorm_prefill_d", d))]
    shapes += [("rmsnorm_decode_inner", slots, inner), ("rmsnorm_decode_d", slots, d)]
    eps = cfg.norm_eps
    for row_name, t, dd in shapes:
        x = torch.randn((t, dd), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((dd,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        z = None
        if dd == inner:
            z = (torch.randn((t, dd), generator=g, device=dev) * 3).to(torch.bfloat16)
        got = rmsnorm_cuda(x, w, eps, gate=z)
        want = ref.rmsnorm(x, w, eps, z)
        err = check(torch, got, want, BF16_TOL, f"rmsnorm [{t}, {dd}]")
        if z is not None:
            assert torch.equal(got, rmsnorm_cuda(x * F.silu(z), w, eps)), \
                f"the gated rmsnorm [{t}, {dd}] differs from the unfused sequence"
        w1 = (1.0 + w.float()).to(torch.bfloat16)  # the library's weight, formed before timing
        lib = ((lambda: F.rms_norm(x, (dd,), w1, eps)) if z is None
               else (lambda: F.rms_norm(x * F.silu(z), (dd,), w1, eps)))
        rows[row_name][(t, dd)] = kernel_row(
            torch, row_name, err, lambda: rmsnorm_cuda(x, w, eps, gate=z), 200,
            time_ms(torch, lambda: ref.rmsnorm(x, w, eps, z), 100),
            library_time(torch, lib, want, BF16_TOL["rtol"], 200,
                         "rmsnorm (F.rms_norm" + (")" if z is None else ", silu, multiply)")),
            ((2 if z is None else 3) * t * dd + dd) * 2, 4.0 * t * dd, "bfloat16",
            f"x [{t}, {dd}] bf16, w [{dd}]" + ("" if z is None else ", gate z fused"),
            graph=True,
        )
    ssm_edge_cases(torch, g)
    return rows


def shape_row(rows: dict, counts: dict, what: str, key: str) -> dict:
    """One kernels-line row over the shapes ``rows`` (launch shape -> the row
    timed there), with ``counts`` (launch shape -> launches, as the wrapper
    counted them in one run): launches their sum, every time and the bound
    their launch-weighted mean (so launches x (time - bound) is the sum of
    the shapes' own), the error the largest.  Every shape must have been
    launched in that run."""
    n = {k: counts.get(k, 0) for k in rows}
    assert all(n.values()), f"{what}: shapes timed but never launched: {n}"
    total = sum(n.values())
    first = next(iter(rows.values()))
    out = {"max_abs_err": max(r["max_abs_err"] for r in rows.values())}
    for field in first:
        if field.endswith("ms"):
            vals = [r[field] for r in rows.values()]
            out[field] = (None if any(v is None for v in vals)
                          else sum(n[k] * r[field] for k, r in rows.items()) / total)
    by = {}
    for k, r in rows.items():
        by[r["bound_by"]] = by.get(r["bound_by"], 0) + n[k]
    out["bound_by"] = max(by, key=by.get)
    out["shape"] = (first["shape"] if len(rows) == 1 else
                    f"{what}; times and bound launch-weighted over launches by {key} {n}")
    out["launches"] = total
    return out


def ssm_edge_cases(torch, g):
    """Kernel 9: L in {1, 3, 16, 100, 256}, G = 1 and odd G, P and N off the
    tiles, da = 0, da = -30 a step (every decay underflows), da = -40 a step
    (above the diagonal exp(cum[l] - cum[s]) overflows; only the mask hides
    it: no NaN may come out).  Kernel 8, plain and gated (z of +-100): T in
    {1, 3, 257}, D from 48 to 16384 (the two-pass kernel above 8192 bf16 /
    4096 f32), f32 and bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

    dev = torch.device("cuda")
    errs = []
    cases = [  # (groups, heads, L, P, N, da_fill)
        (1, 1, 1, 64, 128, None), (3, 3, 3, 64, 128, None), (5, 5, 16, 16, 16, None),
        (6, 2, 100, 72, 100, None), (3, 1, 256, 64, 128, None), (4, 4, 256, 64, 128, 0.0),
        (4, 4, 100, 64, 128, -30.0), (2, 2, 256, 64, 128, -40.0), (7, 7, 37, 33, 5, None),
    ]
    for groups, heads, l, p, n, fill in cases:
        x, da, bm, cm = ssd_inputs(torch, g, groups, heads, l, p, n, fill)
        y, st = ssd_chunk_cuda(x, da, bm, cm, heads)
        wy, wst = ssd_plain(torch, x, da, bm, cm, heads)
        what = f"ssd_chunk edge G={groups} H={heads} L={l} P={p} N={n} da={fill}"
        assert torch.isfinite(y).all() and torch.isfinite(st).all(), f"{what}: not finite"
        errs += [check_rel(y, wy, SSD_REL, what), check_rel(st, wst, SSD_REL, what)]
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for t, dd in ((1, 48), (257, 48), (257, 4096), (1, 2048), (3, 12288), (2, 16384)):
            x = (torch.randn((t, dd), generator=g, device=dev) * 3).to(dt)
            w = (torch.randn((dd,), generator=g, device=dev) * 0.1).to(dt)
            errs.append(check(torch, rmsnorm_cuda(x, w), ref.rmsnorm(x, w), tol,
                              f"rmsnorm edge {dt} [{t}, {dd}]"))
            # The gate, with z of +-100 (silu saturates): bit for bit the
            # kernel on PyTorch's x * silu(z).
            z = (torch.randn((t, dd), generator=g, device=dev) * 3).to(dt)
            z[0, :2] = torch.tensor([100.0, -100.0])
            got = rmsnorm_cuda(x, w, gate=z)
            assert torch.equal(got, rmsnorm_cuda(x * torch.nn.functional.silu(z), w)), \
                f"gated rmsnorm edge {dt} [{t}, {dd}] differs from the unfused sequence"
            errs.append(check(torch, got, ref.rmsnorm(x, w, 1e-6, z), tol,
                              f"gated rmsnorm edge {dt} [{t}, {dd}]"))
    torch.cuda.synchronize()
    print(f"ssm kernels edge cases: {len(errs)} comparisons within tolerance, "
          f"max_abs_err={max(errs):.3e}", flush=True)


def mamba_logits(torch, params, cfg, plan, tokens):
    """Full-sequence prefill logits ``[B, S, V]`` (f32) and its caches."""
    from repro_torch.models import transformer as tfm

    with torch.no_grad():
        feats, _, caches = tfm.model_apply(params, {"tokens": tokens}, cfg, plan, mode="prefill")
        return tfm.logits_from_features(params, feats, cfg).float(), caches


def mamba_decode_check(torch, params, cfg, plan, seed: int, rel: float | None,
                       prefix: int = 200, total: int = 256):
    """Prefill ``prefix`` tokens, scatter the caches into f32 slot caches as
    the batcher does, decode the rest one token at a time (the recurrence),
    and hold every decoded position's logits against one prefill of all
    ``total`` tokens (the chunked scan through kernel 9), within ``rel`` of
    the largest logit (``None``: measured, not held).  Beside it, the same
    distance between two prefills that differ only in chunk length: a
    prefill of ``prefix + 1`` tokens at position ``prefix``."""
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 5)
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=gen, dtype=torch.int32).to(dev)
    full, _ = mamba_logits(torch, params, cfg, plan, tokens)
    _, one = mamba_logits(torch, params, cfg, plan, tokens[:, :prefix])
    slots = tfm.init_caches(cfg, 1, total, device=dev)
    for name, leaves in slots.items():
        for key, leaf in leaves.items():
            leaf.copy_(one[name][key])
    worst = 0.0
    scale = full.abs().max().item()
    with torch.no_grad():
        for i in range(prefix, total):
            feats, _, _ = tfm.model_apply(
                params, {"tokens": tokens[:, i:i + 1]}, cfg, plan, mode="decode", caches=slots,
                t=torch.tensor([i], dtype=torch.int32, device=dev),
            )
            # Position i's output predicts token i + 1: the full prefill's row i.
            got = tfm.logits_from_features(params, feats, cfg).float()[0, 0]
            assert torch.isfinite(got).all(), f"decode step {i}: non-finite logits"
            worst = max(worst, (got - full[0, i]).abs().max().item())
    assert torch.isfinite(full).all(), "non-finite prefill logits"
    shorter, _ = mamba_logits(torch, params, cfg, plan, tokens[:, :prefix + 1])
    control = (shorter[0, prefix] - full[0, prefix]).abs().max().item()
    assert rel is None or worst <= rel * scale, \
        f"decoded logits differ from the prefill's: max |diff| {worst} vs max |logit| {scale}"
    print(f"ssm check ({cfg.dtype}, {cfg.num_layers} layers): prefill {prefix} + decode "
          f"{total - prefix} tokens one at a time vs one {total}-token prefill, all "
          f"{total - prefix} decoded positions: max |diff| / max |logit| = {worst / scale:.3e} "
          f"({'measured, not held' if rel is None else f'limit {rel}'}); a {prefix + 1}-token "
          f"prefill vs the {total}-token one at position {prefix}: {control / scale:.3e}",
          flush=True)
    return worst / scale


def mamba_rows_check(torch, params, cfg, plan, seed: int, rel: float, batch: int = 4,
                     prompt: int = 512):
    """Each row's prefill logits in a batch of ``batch`` prompts of
    ``prompt`` tokens (two chunks: the inter-chunk loop runs; G = 512 groups
    in kernel 9) against a batch-1 prefill of that row."""
    prompts = generate_prompts(torch, cfg, seed, batch, prompt)
    logits, _ = mamba_logits(torch, params, cfg, plan, prompts)
    scale = logits.abs().max().item()
    worst = 0.0
    for r in range(batch):
        one, _ = mamba_logits(torch, params, cfg, plan, prompts[r:r + 1])
        worst = max(worst, (one[0] - logits[r]).abs().max().item())
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    assert worst <= rel * scale, \
        f"batch-{batch} prefill logits differ from batch-1: {worst} vs max |logit| {scale}"
    print(f"ssm check ({cfg.dtype}, {cfg.num_layers} layers): each row's prefill logits of "
          f"{batch} x {prompt} tokens vs a batch-1 prefill: max |diff| / max |logit| = "
          f"{worst / scale:.3e} (limit {rel})", flush=True)


def generate_prompts(torch, cfg, seed: int, batch: int, prompt: int):
    gen = torch.Generator().manual_seed(seed + 9)
    return torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         dtype=torch.int32).to("cuda")


def reduced_card_vs_cpu(torch, seed: int):
    """Reduced Mamba-2 (f32, d_model 64, 8 heads of 16, N 16, chunk 16): one
    prefill of [2, 24] tokens (two chunks of 12) and one decode step, on the
    card (kernels 8, the gated norm fused, and 9) and on the CPU (plain
    versions)."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import make_plan

    cfg = get_reduced("mamba2-1.3b")
    plan = make_plan(None)
    params = tfm.init_model(seed, cfg, plan, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 25), generator=torch.Generator().manual_seed(seed))

    def run(dev):
        tree = _map_tree(params, lambda t: t.to(dev))
        tok = tokens.to(dev)
        with torch.no_grad():
            f, _, c = tfm.model_apply(tree, {"tokens": tok[:, :24]}, cfg, plan, mode="prefill")
            slots = tfm.init_caches(cfg, 2, 32, device=dev)
            for name, leaves in slots.items():
                for key, leaf in leaves.items():
                    leaf.copy_(c[name][key])
            fd, _, _ = tfm.model_apply(tree, {"tokens": tok[:, 24:]}, cfg, plan, mode="decode",
                                       caches=slots, t=torch.tensor(24, device=dev))
        return f.cpu(), fd.cpu(), _map_tree(slots, lambda t: t.cpu())

    want = run("cpu")
    ops.reset_launch_counts()
    got = run("cuda")
    counts = ops.launch_counts()
    # Kernel 8: norm1 and the gated norm of every layer and the final norm,
    # in the prefill and in the decode step.
    assert counts["ssd_chunk"] == cfg.num_layers and counts["rmsnorm"] == 4 * cfg.num_layers + 2, \
        counts
    errs = [check(torch, got[0], want[0], REDUCED_FEAT_TOL, "reduced prefill features"),
            check(torch, got[1], want[1], REDUCED_FEAT_TOL, "reduced decode features")]
    for (name, a), (_, b) in zip(_flat_tree(got[2]), _flat_tree(want[2])):
        errs.append(check(torch, a, b, REDUCED_FEAT_TOL, f"reduced cache {name}"))
    print(f"ssm check: reduced Mamba-2 f32 prefill [2, 24] + one decode step, card (kernels) vs "
          f"cpu (plain): features and caches max_abs_err={max(errs):.3e} "
          f"(rtol {REDUCED_FEAT_TOL['rtol']}, atol {REDUCED_FEAT_TOL['atol']})", flush=True)


MAMBA_SLOTS, MAMBA_MAX_LEN = 4, 256  # the Mamba-2 serve's engine
# Kernels-line rows of kernels 8 and 9 -> what a row over several shapes
# stands for (SHAPE_ROWS names their kernel).
SSM_ROWS = {
    "ssd_chunk": "the Mamba-2 serve's prefills", "ssd_chunk_prefill_256": None,
    "ssd_chunk_generate": None, "rmsnorm": "the Mamba-2 serve's prefills, the gated norm",
    "rmsnorm_prefill_d": "the Mamba-2 serve's prefills, norm1",
    "rmsnorm_decode_inner": None, "rmsnorm_decode_d": None,
}


def mamba_requests(gen, max_len: int):
    out_cap = max(1, min(12, max_len // 4))
    return [
        dataclasses.replace(
            r, prompt_len=max(1, min(r.prompt_len, max_len - out_cap - 2)),
            max_new_tokens=min(r.max_new_tokens, out_cap),
        )
        for r in gen.generate(MAMBA_REQUESTS)
    ]


def serve_mamba(torch, params, cfg, plan, reqs, gen, *, slots: int, max_len: int):
    """Serve ``reqs`` through ``ServeEngine`` (dense slot caches, whole-prompt
    prefill).  Prefills are clocked one by one (each ends in a host read of
    its token); decode ticks are those that admitted nothing.  Kernel 8
    launches twice per layer (norm1, the gated norm) and once more (the
    final norm) per prefill and per decode tick, kernel 9 once per layer per
    prefill: the counts must equal that prediction.  Returns the launches by
    shape as the two wrappers counted them, too.  The first pure decode tick
    runs under the profiler (its kernels counted) and is left out of the
    tick clocks."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    eng = ServeEngine(params, cfg, plan, ServeConfig(slots=slots, max_len=max_len), device="cuda")
    prefill_ms, tick_ms = [], []
    prefill = eng.batcher._prefill_fn

    def timed_prefill(params_, batch, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(params_, batch, *a)
        torch.cuda.synchronize()
        prefill_ms.append((batch["tokens"].shape[1], 1e3 * (time.perf_counter() - t0)))
        return out

    def timed_step():
        untraced = traced["launches"] is not None
        t0 = time.perf_counter()
        st = step()
        tick_ms.append((1e3 * (time.perf_counter() - t0),
                        untraced and st.admitted == 0 and st.live > 0))
        return st

    eng.batcher._prefill_fn = timed_prefill
    traced = trace_decode_tick(torch, eng)
    step = eng.step
    eng.step = timed_step
    gc.collect()  # an earlier engine, held only by its clock wrapper's cycle
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = eng.run(reqs, gen)
    torch.cuda.synchronize()
    counts, shapes = ops.launch_counts(), ops.launch_shapes()
    peak = torch.cuda.max_memory_allocated() / 1e9
    prefills = sum(st.admitted for st in eng.tick_log)
    decode_ticks = sum(1 for st in eng.tick_log if st.live > 0)
    layers = cfg.num_layers
    want = {"rmsnorm": (2 * layers + 1) * (prefills + decode_ticks),
            "ssd_chunk": layers * prefills}
    assert {k: counts[k] for k in want} == want, f"launches {counts} != predicted {want}"
    assert len(prefill_ms) == prefills and all(st.gate_load is None for st in eng.tick_log)
    toks = {r.rid: list(r.out) for r in eng.batcher.finished}
    TOKENS_SHA256.setdefault("mamba2 serves", []).append(tokens_sha256(toks))
    decode = sorted(ms for ms, pure in tick_ms if pure)
    med = decode[len(decode) // 2] if decode else float("nan")
    per_prompt = ", ".join(f"{n}: {ms:.2f}" for n, ms in prefill_ms)
    # A decode tick's least bytes: every weight read once (the tied LM head
    # included), every slot's state and conv leaves read and written once.
    nbytes = lambda tree: sum(t.numel() * t.element_size() for _, t in _flat_tree(tree))
    tick_bound = (nbytes(params) + 2 * nbytes(eng.batcher.caches)) / HBM_BYTES_PER_S * 1e3
    print(f"serve mamba2: completed={rep.completed}/{rep.requests} ticks={rep.ticks} "
          f"tokens={rep.tokens_out} wall_s={rep.wall_s:.3f} tokens_per_s={rep.tokens_per_s:.2f} "
          f"decode_tick_ms median={med:.3f} (n={len(decode)}, bytes bound "
          f"{tick_bound:.3f}) peak_gb={peak:.3f}; prefill ms "
          f"by prompt length {{{per_prompt}}}; launches rmsnorm={counts['rmsnorm']} "
          f"ssd_chunk={counts['ssd_chunk']} as predicted ({prefills} prefills, {decode_ticks} "
          f"decode ticks); by shape, rmsnorm (T, D) {shapes['rmsnorm']}, ssd_chunk (G, L) "
          f"{shapes['ssd_chunk']}; one decode tick launched {traced['launches']} kernels",
          flush=True)
    E2E["mamba2 decode tick kernel launches"] = traced["launches"]
    E2E["mamba2 prefill ms by prompt length"] = [[n, round(ms, 3)] for n, ms in prefill_ms]
    E2E["mamba2 prefill ms, mean"] = sum(ms for _, ms in prefill_ms) / max(1, len(prefill_ms))
    E2E["mamba2 decode tick ms"] = med
    return rep, toks, counts, shapes


def generate_phase(torch, params, cfg, plan, seed: int, batch: int = 4, prompt: int = 512,
                   new: int = 16):
    """Greedy ``generate`` of ``new`` tokens for ``batch`` prompts of
    ``prompt`` tokens (two chunks of 256: the inter-chunk loop runs); its
    first tokens must be the prefill step's on the same batch, bit for
    bit."""
    from repro_torch.kernels import ops
    from repro_torch.serve.decode import generate
    from repro_torch.train.train_step import make_prefill_step

    prompts = generate_prompts(torch, cfg, seed, batch, prompt)
    generate(params, cfg, plan, prompts[:, :64], max_new_tokens=2)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(params, cfg, plan, prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, shapes = ops.launch_counts(), ops.launch_shapes()
    want = {"rmsnorm": (2 * cfg.num_layers + 1) * new, "ssd_chunk": cfg.num_layers}
    assert {k: counts[k] for k in want} == want, f"generate launches {counts} != {want}"
    assert out.shape == (batch, new) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
    first, _ = make_prefill_step(cfg, plan)(params, {"tokens": prompts})
    assert torch.equal(out[:, :1], first), "generate's first tokens are not the prefill step's"
    print(f"generate: {batch} prompts x {prompt} tokens, {new} new tokens greedy in "
          f"{1e3 * wall:.1f} ms ({batch * new / wall:.1f} tokens/s, prefill included); "
          f"launches rmsnorm={counts['rmsnorm']} ssd_chunk={counts['ssd_chunk']} (by (G, L) "
          f"{shapes['ssd_chunk']})", flush=True)
    return counts, shapes


def sampled_generate_phase(torch, params, cfg, plan, seed: int, batch: int = 4,
                           prompt: int = 512, new: int = 16):
    """Sampled ``generate`` of ``new`` tokens for ``batch`` prompts of
    ``prompt`` tokens, three times: seeds 1, 1 and 2.  The same seed must
    give the same tokens, the other seed other tokens, and every run's first
    tokens are the prefill's argmax (as in the reference)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.decode import generate
    from repro_torch.train.train_step import make_prefill_step

    prompts = generate_prompts(torch, cfg, seed, batch, prompt)
    first, _ = make_prefill_step(cfg, plan)(params, {"tokens": prompts})
    ops.reset_launch_counts()
    outs, walls = [], []
    for s in (1, 1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(generate(params, cfg, plan, prompts, max_new_tokens=new, sample=True, seed=s))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    want = {"rmsnorm": 3 * (2 * cfg.num_layers + 1) * new, "ssd_chunk": 3 * cfg.num_layers}
    assert {k: counts[k] for k in want} == want, f"sampled generate launches {counts} != {want}"
    a, b, c = outs
    assert a.shape == (batch, new) and bool(((a >= 0) & (a < cfg.vocab_size)).all())
    assert torch.equal(a, b), "sampled generate: the same seed gave different tokens"
    assert not torch.equal(a, c), "sampled generate: another seed gave the same tokens"
    assert all(torch.equal(o[:, :1], first) for o in outs), "the first tokens are not the prefill's"
    for s, o in ((1, a), (2, c)):
        TOKENS_SHA256[f"mamba2 sampled generate, seed={s}"] = tokens_sha256(
            dict(enumerate(o.tolist())))
    print(f"generate sampled: {batch} prompts x {prompt} tokens, {new} new tokens, seeds 1, 1, "
          f"2 in {', '.join(f'{1e3 * w:.1f}' for w in walls)} ms "
          f"({batch * new / walls[1]:.1f} tokens/s, prefill included); seed 1 twice "
          f"bit-identical, seed 2 different; launches rmsnorm={counts['rmsnorm']} "
          f"ssd_chunk={counts['ssd_chunk']}", flush=True)


def mamba_phases(torch, seed: int, profile: bool, slots: int = MAMBA_SLOTS,
                 max_len: int = MAMBA_MAX_LEN):
    """Mamba-2 1.3B at full width, random weights from ``seed``: the
    prefill-then-decode and batch-vs-row checks in f32 at all 48 layers and
    the first in bf16 at 2; then, in bf16 at all 48 layers, the
    prefill-then-decode distance measured, two serves (tokens
    bit-identical) and generate; then the reduced card-vs-CPU forward.
    -> (the serve's launch counts, generate's, and launches by shape: of
    the serve, of generate and of the full-depth bf16 prefill-then-decode
    check)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.serve.workload import WorkloadGenerator

    cfg = get_config("mamba2-1.3b")
    plan = make_plan(None)
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = init_model(seed, f32, plan, device="cuda")
    mamba_decode_check(torch, params, f32, plan, seed, MAMBA_F32_LOGIT_REL)
    mamba_rows_check(torch, params, f32, plan, seed, MAMBA_F32_LOGIT_REL)
    del params
    shallow = dataclasses.replace(cfg, num_layers=2)
    params = init_model(seed, shallow, plan, device="cuda")
    mamba_decode_check(torch, params, shallow, plan, seed, MAMBA_LOGIT_REL)
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = init_model(seed, cfg, plan, device="cuda")
    torch.cuda.synchronize()
    s = cfg.ssm
    nparams = sum(t.numel() for _, t in _flat_tree(params))
    print(f"model: {cfg.name} d_model={cfg.d_model} inner={s.expand * cfg.d_model} "
          f"heads={s.expand * cfg.d_model // s.head_dim}x{s.head_dim} N={s.state_dim} "
          f"conv={s.conv_width} chunk={s.chunk} vocab={cfg.vocab_size} "
          f"layers={cfg.num_layers}/48 {cfg.dtype}: {nparams / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    ops.reset_launch_counts()
    mamba_decode_check(torch, params, cfg, plan, seed, None)
    torch.cuda.synchronize()
    shapes = {"decode_check": ops.launch_shapes()}

    gen = WorkloadGenerator("chat", seed=seed, vocab_size=cfg.vocab_size)
    reqs = mamba_requests(gen, max_len)
    runs = [serve_mamba(torch, params, cfg, plan, reqs, gen, slots=slots, max_len=max_len)
            for _ in range(2)]
    (rep_a, toks_a, _, _), (rep_b, toks_b, counts, shapes["serve"]) = runs
    assert rep_a.completed == rep_b.completed == len(reqs), "not every request completed"
    assert toks_a == toks_b, "two serves of the same requests gave different tokens"
    assert all(0 <= t < cfg.vocab_size for out in toks_b.values() for t in out)
    print(f"serve mamba2: tokens bit-identical across two runs "
          f"({sum(len(v) for v in toks_b.values())} tokens, {len(toks_b)} requests)", flush=True)
    if profile:
        from repro_torch.serve.engine import ServeConfig

        profile_serve(torch, params, cfg, plan, reqs, gen,
                      ServeConfig(slots=slots, max_len=max_len), label="profile mamba2")
    counts_gen, shapes["generate"] = generate_phase(torch, params, cfg, plan, seed)
    sampled_generate_phase(torch, params, cfg, plan, seed)
    del params
    torch.cuda.empty_cache()
    reduced_card_vs_cpu(torch, seed)
    return counts, counts_gen, shapes


def mamba_part(torch, seed: int, profile: bool):
    """Kernels 8 and 9 timed at every shape the Mamba-2 paths give them,
    then those paths (``mamba_phases``) -> (the kernels-line rows of kernels
    8 and 9, the serve's launch counts, generate's).  Each row's launches
    are the wrapper's counts at the shapes the row was timed at, from the
    run that launches them: the serve (its second run), every launch shape
    of which a row covers; the full-depth prefill-then-decode check for the
    256-token prefill; generate for its batch."""
    from repro_torch.configs import get_config
    from repro_torch.serve.workload import WorkloadGenerator

    cfg = get_config("mamba2-1.3b")
    lens = [r.prompt_len for r in mamba_requests(
        WorkloadGenerator("chat", seed=seed, vocab_size=cfg.vocab_size), MAMBA_MAX_LEN)]
    timed = ssm_kernel_phase(torch, cfg, seed, lens, MAMBA_SLOTS)
    counts, counts_gen, shapes = mamba_phases(torch, seed, profile)
    other_runs = {"ssd_chunk_prefill_256": shapes["decode_check"],
                  "ssd_chunk_generate": shapes["generate"]}
    for kernel in SSM_KERNELS:
        keys = [k for nm in SSM_ROWS if SHAPE_ROWS.get(nm, nm) == kernel and nm not in other_runs
                for k in timed[nm]]
        assert sorted(keys) == sorted(shapes["serve"][kernel]), \
            f"{kernel}: timed at {sorted(keys)}, served at {shapes['serve'][kernel]}"
    rows = {}
    for nm, what in SSM_ROWS.items():
        kernel = SHAPE_ROWS.get(nm, nm)
        rows[nm] = shape_row(timed[nm], other_runs.get(nm, shapes["serve"])[kernel], what,
                             "(G, L)" if kernel == "ssd_chunk" else "(T, D)")
    return rows, counts, counts_gen


# ---------------------------------------------------------------------------
# phase 13b: dense models
# ---------------------------------------------------------------------------

DENSE_STEPS = 6
DENSE_LONG = 4608  # one prompt past gemma2's 4096-token window
# Served dense families and their depth: None keeps every layer.
DENSE_SERVED = {"deepseek-7b": None, "deepseek-67b": 2, "mistral-large-123b": 2}
DENSE_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd")
# Prefill (kernel 2) against paged decode-mode logits (kernel 3) over
# gemma2's 26 bf16 layers: the two paths round every activation along
# other sums; 5e-2 of the logits' largest magnitude, decode_vs_prefill's.
DENSE_LOGIT_REL = 5e-2


def dense_attention_rows(torch, cfg, seed: int) -> dict:
    """Kernel 2 forward and backward at gemma2's training shape (q [2, 8,
    256, 256] bf16, causal, its window of 4096 and softcap 50; at 256
    positions the window does not bind), against the plain version and its
    autograd.  SDPA takes no softcap: its time is SDPA's without one."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 26)
    b, s, hq, hkv, d = 2, 256, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(causal=True, window=cfg.window_size, softcap=cfg.logit_softcap)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev).bfloat16()  # noqa: E731
    q, kk, vv, do = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d), randn(b, hq, s, d)
    out, lse = kfa.flash_attention_cuda(q, kk, vv, return_lse=True, **kw)
    kx, vx = (a.repeat_interleave(hq // hkv, dim=1) for a in (kk, vv))
    pairs = sum(min(i + 1, cfg.window_size) for i in range(s))
    shape = (f"q [{b}, {hq}, {s}, {d}], k/v [{b}, {hkv}, {s}, {d}] bf16 causal, window "
             f"{cfg.window_size}, softcap {cfg.logit_softcap}; library: SDPA without softcap")
    rows = {"flash_attention_gemma2": kernel_row(
        torch, "flash_attention_gemma2",
        check(torch, out, ref.flash_attention(q, kk, vv, **kw), BF16_TOL, "flash_attention gemma2"),
        lambda: kfa.flash_attention_cuda(q, kk, vv, return_lse=True, **kw), 50,
        time_ms(torch, lambda: ref.flash_attention(q, kk, vv, **kw), 10),
        timed(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True), 50),
        2 * (2 * b * hq + 2 * b * hkv) * s * d + b * hq * s * 4, 4.0 * d * pairs * hq * b,
        "bfloat16", shape,
    )}
    want = _grads(torch, lambda a, c, e: ref.flash_attention(a, c, e, **kw), [q, kk, vv], do)
    got = kfa.flash_attention_bwd_cuda(q, kk, vv, out, lse, do, **kw)
    err = max(check_rel(a, w, BF16_GRAD_REL, f"flash_attention_bwd gemma2 d{nm}")
              for a, w, nm in zip(got, want, "qkv"))
    ql, kl, vl = (a.detach().clone().requires_grad_() for a in (q, kk, vv))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    rows["flash_attention_bwd_gemma2"] = kernel_row(
        torch, "flash_attention_bwd_gemma2", err,
        lambda: kfa.flash_attention_bwd_cuda(q, kk, vv, out, lse, do, **kw), 20,
        time_ms(torch, lambda: ref.flash_attention_bwd(q, kk, vv, do, **kw), 5),
        timed(torch, lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True), 20),
        (3 * b * hq * s * d + 4 * b * hkv * s * d + b * hq * s * d) * 2 + b * hq * s * 4,
        10.0 * d * pairs * hq * b, "bfloat16", shape,
    )
    return rows


def dense_norm_rows(torch, t: int, d: int, seed: int, suffix: str, backward: bool) -> dict:
    """Kernel 8 (and its backward) at ``x [t, d]`` bf16 against the plain
    version (and its autograd); ``F.rms_norm`` as the library call."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + d)
    x = torch.randn((t, d), generator=g, device=dev).bfloat16()
    dy = torch.randn((t, d), generator=g, device=dev).bfloat16()
    w = (torch.randn((d,), generator=g, device=dev) * 0.1).bfloat16()
    eps = 1e-6
    want = ref.rmsnorm(x, w, eps)
    w1 = (1.0 + w.float()).bfloat16()  # the library's weight, formed before timing
    name = f"rmsnorm_{suffix}"
    rows = {name: kernel_row(
        torch, name, check(torch, krms.rmsnorm_cuda(x, w, eps), want, BF16_TOL, name),
        lambda: krms.rmsnorm_cuda(x, w, eps), 200, time_ms(torch, lambda: ref.rmsnorm(x, w, eps), 50),
        library_time(torch, lambda: F.rms_norm(x, (d,), w1, eps), want, BF16_TOL["rtol"], 200,
                     f"{name} (F.rms_norm)"),
        (2 * t * d + d) * 2, 4.0 * t * d, "bfloat16", f"x [{t}, {d}] bf16, w [{d}]", graph=True,
    )}
    if not backward:
        return rows
    want_dx, want_dw = _grads(torch, lambda a, c: ref.rmsnorm(a, c, eps), [x, w], dy)
    gdx, gdw = krms.rmsnorm_bwd_cuda(x, w, dy, eps)
    err = max(check(torch, gdx, want_dx, BF16_TOL, f"rmsnorm_bwd {suffix} dx"),
              check_rel(gdw, want_dw, NORM_DW_REL, f"rmsnorm_bwd {suffix} dw"))
    xp, wp = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    plain_out = ref.rmsnorm(xp, wp, eps)
    xl, wl = x.detach().clone().requires_grad_(), w1.detach().clone().requires_grad_()
    lib_out = F.rms_norm(xl, (d,), wl, eps)
    name = f"rmsnorm_bwd_{suffix}"
    rows[name] = kernel_row(
        torch, name, err, lambda: krms.rmsnorm_bwd_cuda(x, w, dy, eps), 200,
        time_ms(torch, lambda: torch.autograd.grad(plain_out, (xp, wp), dy, retain_graph=True), 20),
        timed(torch, lambda: torch.autograd.grad(lib_out, (xl, wl), dy, retain_graph=True), 100),
        (3 * t * d + 2 * d) * 2, 8.0 * t * d, "bfloat16", f"x, dy [{t}, {d}] bf16 -> dx, dw [{d}]",
        graph=True,
    )
    return rows


def paged_row(torch, name: str, q, kp, vp, table, tvec, *, window, softcap, iters: int,
              plain_iters: int, what: str) -> dict:
    """Kernel 3 at ``q [B, C, Hq, D]`` over pools ``[N, page, Hkv, D]``, row
    c of slot b at position t_b + c, against the plain version; the library
    call is the gathered view through SDPA with the causal (and window)
    mask and no softcap."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import paged_flash_decode_cuda

    kw = dict(window=window, softcap=softcap)
    b, c, hq, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    out = paged_flash_decode_cuda(q, kp, vp, table, tvec, **kw)
    err = check(torch, out, ref.paged_flash_decode(q, kp, vp, table, tvec, **kw), BF16_TOL, name)
    pos = torch.arange(table.shape[1] * page, device=q.device)
    qpos = tvec[:, None] + torch.arange(c, device=q.device)[None, :]  # [B, C]
    mask = pos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= (qpos[:, :, None] - pos[None, None, :]) < window
    mask = mask[:, None]

    def sdpa():
        vk = ref.paged_gather_kv(kp, table).transpose(1, 2)
        vv = ref.paged_gather_kv(vp, table).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), vk, vv, attn_mask=mask,
                                              enable_gqa=True)

    t_list = tvec.tolist()
    keys = [min(t + j + 1, window or t + j + 1) for t in t_list for j in range(c)]
    kv_rows = sum(t + c if window is None else min(t + c, window + c - 1) for t in t_list)
    return kernel_row(
        torch, name, err, lambda: paged_flash_decode_cuda(q, kp, vp, table, tvec, **kw), iters,
        time_ms(torch, lambda: ref.paged_flash_decode(q, kp, vp, table, tvec, **kw), plain_iters),
        timed(torch, sdpa, max(plain_iters, 3)),
        2 * b * c * hq * d * 2 + kv_rows * hkv * d * 2 * 2 + table.numel() * 4 + b * 4,
        4.0 * hq * d * sum(keys), "bfloat16",
        f"{what}: q [{b}, {c}, {hq}, {d}] bf16, pool [{kp.shape[0]}, {page}, {hkv}, {d}], "
        f"t={t_list if b <= 8 else '...'}, window {window}, softcap {softcap}; library: gathered "
        f"view + SDPA (mask, no softcap)",
    )


def dense_train(torch, cfg, seed: int) -> tuple[dict, dict]:
    """Train ``cfg`` (gemma2-2b, every layer) ``DENSE_STEPS`` steps of 2 x
    256 tokens through ``Trainer``, one ``train`` call per step; no control
    plane (dense).  Losses finite, every dense training kernel launched,
    peak memory (weights, gradients and moments included) under 80 GB."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    seq, batch = 256, 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, AdamWConfig(warmup_steps=2, total_steps=DENSE_STEPS),
                 TrainerConfig(total_steps=DENSE_STEPS), make_plan(None), seed=seed,
                 device="cuda")
    assert tr.controlplane is None
    nparams = sum(t.numel() for _, t in _flat_tree(tr.params))
    torch.cuda.synchronize()
    print(f"dense model: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads}x{cfg.resolved_head_dim} d_ff={cfg.d_ff} {cfg.act} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} (all) pattern={cfg.block_pattern} "
          f"window={cfg.window_size} softcaps={cfg.logit_softcap}/{cfg.final_softcap} "
          f"tied={cfg.tie_embeddings} remat={cfg.remat}: {nparams / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB with moments, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    data = iter(SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed))
    call_ms = []
    ops.reset_launch_counts()
    for s in range(1, DENSE_STEPS + 1):
        tr.tcfg.total_steps = s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(data)
        torch.cuda.synchronize()
        call_ms.append(1e3 * (time.perf_counter() - t0))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in tr.metrics_log]
    step_ms = [1e3 * m["step_time_s"] for m in tr.metrics_log]
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    window_tps = batch * seq * (DENSE_STEPS - 1) / (sum(call_ms[1:]) / 1e3)
    assert all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}"
    missing = [nm for nm in DENSE_KERNELS if counts[nm] == 0]
    assert not missing, f"kernels never launched while training {cfg.name}: {missing}"
    assert peak < 80.0, f"{cfg.name} training peaked at {peak:.2f} GB"
    print(f"dense train {cfg.name}: losses {['%.4f' % v for v in losses]}; {DENSE_STEPS} steps "
          f"of {batch}x{seq} tokens: median step {med:.1f} ms (trainer's clock, steps "
          f"2-{DENSE_STEPS}), {batch * seq / med * 1e3:.1f} tokens/s at that median; whole "
          f"window (steps 2-{DENSE_STEPS}) {sum(call_ms[1:]):.1f} ms, {window_tps:.1f} tokens/s; "
          f"peak memory {peak:.2f} GB (weights, gradients, moments and activations); per step "
          f"ms {['%.1f' % v for v in step_ms]}; launches {counts}", flush=True)
    E2E[f"{cfg.name} train median step ms"] = med
    E2E[f"{cfg.name} train window tokens/s"] = window_tps
    E2E[f"{cfg.name} train peak GB"] = peak
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(losses=losses, median_ms=med, peak_gb=peak)


class _Patches:
    """The part of pytest's ``monkeypatch`` that ``tests/_torch_prefix.py``
    uses (``setattr``), undone by :meth:`undo`."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


def dense_prefix_check(torch, params, cfg) -> None:
    """``tests/_torch_prefix.py``'s check (the card test's): prompt B (a
    64-token prefix and its own tail) admitted into a fresh engine (a miss)
    and after prompt A (the same prefix, another tail: a hit on 4 pages);
    B's admission logits and its 10 greedy tokens must be the miss's bit
    for bit."""
    sys.path.insert(0, str(REPO / "tests"))
    from _torch_prefix import admission_logits, prefix_hit_and_miss

    patches = _Patches()
    try:
        out = prefix_hit_and_miss(params, cfg, "cuda", admission_logits(patches))
    finally:
        patches.undo()
    (miss_logits, miss_toks), (hit_logits, hit_toks) = out[False], out[True]
    assert torch.equal(hit_logits, miss_logits), \
        f"a prefix hit's logits differ: {(hit_logits - miss_logits).abs().max()}"
    assert hit_toks == miss_toks, f"a prefix hit's tokens differ: {hit_toks} vs {miss_toks}"


def long_context_check(torch, params, cfg, seed: int) -> dict:
    """One prompt of ``DENSE_LONG`` tokens, so gemma2's window binds on its
    local layers: the last 8 positions' logits of one prefill (kernel 2,
    windowed) against the same prompt admitted as one paged decode-mode
    chunk from position 0 (kernel 3, as ``batching._admit_paged`` runs it),
    within ``DENSE_LOGIT_REL``; the launches of each."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import make_plan

    plan, dev, page = make_plan(None), torch.device("cuda"), 16
    tokens = torch.as_tensor(np.random.default_rng(seed + 46).integers(
        1, cfg.vocab_size - 1, size=(1, DENSE_LONG)).astype(np.int32), device=dev)
    pages = -(-DENSE_LONG // page)
    ms = {}
    with torch.no_grad():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, _, _ = tfm.model_apply(params, {"tokens": tokens}, cfg, plan, mode="prefill")
        full = tfm.logits_from_features(params, feats[:, -8:], cfg).float()
        torch.cuda.synchronize()
        ms["prefill"] = 1e3 * (time.perf_counter() - t0)
        prefill_counts = ops.launch_counts()
        del feats
        caches = tfm.init_paged_caches(cfg, pages + 1, page, device=dev)
        table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None, :]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        feats, _, _ = tfm.model_apply(params, {"tokens": tokens}, cfg, plan, mode="decode",
                                      caches=caches, t=torch.zeros(1, dtype=torch.int32,
                                                                    device=dev),
                                      page_table=table)
        paged = tfm.logits_from_features(params, feats[:, -8:], cfg).float()
        torch.cuda.synchronize()
        ms["admission"] = 1e3 * (time.perf_counter() - t0)
        admit_counts = ops.launch_counts()
    del caches, feats
    assert torch.isfinite(full).all() and torch.isfinite(paged).all(), "non-finite logits"
    scale = full.abs().max().item()
    err = (paged - full).abs().max().item()
    assert err <= DENSE_LOGIT_REL * scale, \
        f"long context: admission logits differ from prefill: {err} vs scale {scale}"
    assert prefill_counts["flash_attention"] == cfg.num_layers, prefill_counts
    assert admit_counts["paged_flash_decode"] == cfg.num_layers, admit_counts
    same = (paged.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"dense long context {cfg.name}: one {DENSE_LONG}-token prompt (window "
          f"{cfg.window_size} binds on the {cfg.num_layers // 2} local layers): prefill (kernel 2, "
          f"{prefill_counts['flash_attention']} launches) {ms['prefill']:.1f} ms vs paged "
          f"decode-mode admission (kernel 3, {admit_counts['paged_flash_decode']} launches) "
          f"{ms['admission']:.1f} ms; last 8 positions' logits max |diff| / max |logit| = "
          f"{err / scale:.3e} (limit {DENSE_LOGIT_REL}), argmax agreement {same:.3f}", flush=True)
    return dict(rel=err / scale, admit_launches=admit_counts["paged_flash_decode"], ms=ms)


def dense_serve_family(torch, name: str, layers, seed: int, page: int) -> dict:
    """``name`` at its published widths, ``layers`` of them (None: all):
    the first 4 requests (4 new tokens each) through ``ServeEngine``
    (paged), then ``decode_vs_prefill``; kernels 3 and 8 must launch."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan

    cfg = get_config(name)
    full = cfg.num_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    plan = make_plan(None)
    gen, reqs = chat_requests(seed, cfg.vocab_size, 256)
    t0 = time.perf_counter()
    params = init_model(seed, cfg, plan, device="cuda")
    torch.cuda.synchronize()
    nparams = sum(t.numel() for _, t in _flat_tree(params))
    print(f"dense model: {name} d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads}x"
          f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers="
          f"{cfg.num_layers}/{full}{'' if layers is None else ' (depth cut)'}: "
          f"{nparams / 1e9:.3f} B parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
          f"card, init {time.perf_counter() - t0:.1f} s", flush=True)
    few = [dataclasses.replace(r, max_new_tokens=min(r.max_new_tokens, 4)) for r in reqs[:4]]
    rep, toks, counts, shapes = serve(torch, params, cfg, plan, few, gen, reconfig_every=0,
                                      slots=4, max_len=256, page=page, tag=name)
    missing = [k for k in ("paged_flash_decode", "rmsnorm") if counts[k] == 0]
    assert not missing, f"kernels never launched serving {name}: {missing}"
    assert all(0 <= t < cfg.vocab_size for out in toks.values() for t in out)
    probe = gen.prompt_tokens(reqs[0])
    probe = probe if len(probe) >= 40 else probe.repeat(-(-40 // len(probe)))[:40]
    rel = decode_vs_prefill(torch, params, cfg, plan, probe[:64].astype("int32"), page)
    print(f"dense check {name}: paged decode vs full prefill logits, max |diff| / max |logit| = "
          f"{rel:.3e} (limit 5e-2)", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, shapes=shapes, rel=rel, cfg=cfg)


def dense_phase(torch, seed: int, page: int) -> dict:
    """gemma2-2b at its published widths and all 26 layers: kernel rows at
    its shapes, 6 training steps, one reduced step on the card against the
    CPU, the 8 chat requests served, a prefix hit against a miss, decode
    against prefill, a 4,608-token prompt; then deepseek-7b (every layer),
    deepseek-67b and mistral-large-123b (2 layers each) served.  Returns the
    kernel rows and the launch counts of each path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gemma2-2b")
    gen, reqs = chat_requests(seed, cfg.vocab_size, 256)
    rows = dense_attention_rows(torch, cfg, seed)
    rows.update(dense_norm_rows(torch, 512, cfg.d_model, seed, "gemma2", backward=True))
    counts_train, trained = dense_train(torch, cfg, seed)
    for nm, kernel in (("flash_attention_gemma2", "flash_attention"),
                       ("flash_attention_bwd_gemma2", "flash_attention_bwd"),
                       ("rmsnorm_gemma2", "rmsnorm"), ("rmsnorm_bwd_gemma2", "rmsnorm_bwd")):
        rows[nm]["launches"] = counts_train[kernel]
    small = dataclasses.replace(cfg, num_layers=2, d_model=256, d_ff=512, vocab_size=1024,
                                window_size=32, dtype="float32")
    step_card_vs_cpu(torch, seed, cfg=small)

    plan = make_plan(None)
    params = init_model(seed, cfg, plan, device="cuda")
    rep, toks, counts_serve, shapes_serve = serve(torch, params, cfg, plan, reqs, gen,
                                                  reconfig_every=0, slots=4, max_len=256,
                                                  page=page, tag=cfg.name)
    missing = [k for k in ("paged_flash_decode", "rmsnorm") if counts_serve[k] == 0]
    assert not missing, f"kernels never launched serving {cfg.name}: {missing}"
    assert rep.completed == len(reqs)
    dense_prefix_check(torch, params, cfg)
    probe = gen.prompt_tokens(reqs[0])
    probe = probe if len(probe) >= 40 else probe.repeat(-(-40 // len(probe)))[:40]
    rel = decode_vs_prefill(torch, params, cfg, plan, probe[:64].astype("int32"), page)
    print(f"dense serve {cfg.name}: a prefix hit on 4 pages gives the miss's admission "
          f"logits and 10 tokens bit for bit; paged decode vs full prefill logits, max |diff| / "
          f"max |logit| = {rel:.3e} (limit 5e-2)", flush=True)
    long = long_context_check(torch, params, cfg, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # Kernel 3 at the serve's decode tick, at the long prompt's admission
    # chunk, and kernel 2 on the same K/V as that chunk (a dense layout).
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    cpu_g = torch.Generator().manual_seed(seed + 31)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev).bfloat16()  # noqa: E731
    slots, max_pages = 4, 256 // page
    lengths = [min(r.prompt_len, 255) for r in reqs[:slots]]
    table = page_table_for(torch, lengths, 1, page, max_pages, slots * max_pages, cpu_g).to(dev)
    kp, vp = randn(slots * max_pages, page, hkv, d), randn(slots * max_pages, page, hkv, d)
    rows["paged_flash_decode_gemma2"] = paged_row(
        torch, "paged_flash_decode_gemma2", randn(slots, 1, hq, d), kp, vp, table,
        torch.tensor(lengths, dtype=torch.int32, device=dev), window=cfg.window_size,
        softcap=cfg.logit_softcap, iters=200, plain_iters=20, what="gemma2's decode tick")
    rows["paged_flash_decode_gemma2"]["launches"] = counts_serve["paged_flash_decode"]
    pages = -(-DENSE_LONG // page)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None, :]
    kp, vp = randn(pages + 1, page, hkv, d), randn(pages + 1, page, hkv, d)
    qa = randn(1, DENSE_LONG, hq, d)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    kw = dict(window=cfg.window_size, softcap=cfg.logit_softcap)
    rows["paged_flash_decode_gemma2_admit"] = paged_row(
        torch, "paged_flash_decode_gemma2_admit", qa, kp, vp, table, zero, iters=20,
        plain_iters=2, what=f"a {DENSE_LONG}-token admission chunk", **kw)
    rows["paged_flash_decode_gemma2_admit"]["launches"] = long["admit_launches"]
    chunk = kfa.paged_flash_decode_cuda(qa, kp, vp, table, zero, **kw)
    dense_k, dense_v = (p[1:].reshape(1, pages * page, hkv, d)[:, :DENSE_LONG].transpose(1, 2)
                        .contiguous() for p in (kp, vp))
    flash = kfa.flash_attention_cuda(qa.transpose(1, 2).contiguous(), dense_k, dense_v,
                                     causal=True, **kw).transpose(1, 2)
    agree = check(torch, chunk, flash, BF16_TOL, "kernel 3's admission chunk vs kernel 2")
    plain = ref.flash_attention(qa.transpose(1, 2), dense_k, dense_v, causal=True, **kw)
    err2 = check(torch, flash, plain.transpose(1, 2), BF16_TOL, "kernel 2 at the long prompt")
    print(f"dense kernels: at {DENSE_LONG} positions (window {cfg.window_size}, softcap "
          f"{cfg.logit_softcap}) kernel 2 against its plain version: max |diff| {err2:.3e}; "
          f"kernel 3's admission chunk against kernel 2 on the same K/V: max |diff| "
          f"{agree:.3e} (bf16 tolerance)", flush=True)
    del plain
    del kp, vp, qa, chunk, flash, dense_k, dense_v

    served = {}
    for name, layers in DENSE_SERVED.items():
        served[name] = dense_serve_family(torch, name, layers, seed, page)
    ds = served["deepseek-7b"]["cfg"]
    hq, hkv, d = ds.num_heads, ds.num_kv_heads, ds.resolved_head_dim
    table = page_table_for(torch, lengths, 1, page, max_pages, slots * max_pages, cpu_g).to(dev)
    rows["paged_flash_decode_group1"] = paged_row(
        torch, "paged_flash_decode_group1", randn(slots, 1, hq, d),
        randn(slots * max_pages, page, hkv, d), randn(slots * max_pages, page, hkv, d), table,
        torch.tensor(lengths, dtype=torch.int32, device=dev), window=None, softcap=None,
        iters=200, plain_iters=20, what="deepseek-7b's decode tick (a group of 1)")
    rows["paged_flash_decode_group1"]["launches"] = \
        served["deepseek-7b"]["counts"]["paged_flash_decode"]
    mistral = served["mistral-large-123b"]
    shapes = {k: n for k, n in mistral["shapes"]["rmsnorm"].items()
              if k[1] == mistral["cfg"].d_model}
    timed_norms = {k: dense_norm_rows(torch, k[0], k[1], seed, "mistral", False)["rmsnorm_mistral"]
                   for k in sorted(shapes)}
    rows["rmsnorm_mistral"] = shape_row(timed_norms, shapes, "the mistral-large serve's norms",
                                        "(T, D)")
    seconds = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"dense phase: {seconds:.1f} s, peak memory {peak:.2f} GB; gemma2-2b trained "
          f"(median step {trained['median_ms']:.1f} ms, peak {trained['peak_gb']:.2f} GB) and "
          f"served (prefix hit = miss, decode vs prefill {rel:.3e}, {DENSE_LONG}-token admission "
          f"vs prefill {long['rel']:.3e}); served: "
          + ", ".join(f"{n} ({s['cfg'].num_layers} layers, decode vs prefill {s['rel']:.3e})"
                      for n, s in served.items()), flush=True)
    E2E["dense phase s"] = seconds
    counts_dense_serve = {k: counts_serve[k] + sum(s["counts"][k] for s in served.values())
                          for k in counts_serve}
    return dict(rows=rows, train=counts_train, serve=counts_dense_serve)


# ---------------------------------------------------------------------------
# phase 14: multi-rank MixNet training, four ranks sharing the card
# ---------------------------------------------------------------------------


MULTI_RANKS = 4
MULTI_STEPS = 4
MULTI_TIMEOUT_S = 300  # a hung collective fails the run
# P = 4 against P = 1 losses: the card-vs-CPU step check's loss tolerance.
MULTI_LOSS_REL = 1e-4
# The phase's learning rate: at the train phase's 3e-4 (a loss of 10.87 ->
# 11.74 after one step) P = 4 drifted 8.6e-3 from P = 1 by step 4 from a
# 2e-5 difference at step 1; at 1e-5 the runs stay comparable.
MULTI_LR = 1e-5
# Mixtral's 8 slots over a model axis of 4: layer 0 swaps whole device
# blocks (0 <-> 1, 2 <-> 3: a wire re-address, no weight moves), layer 1
# swaps slots 0 and 2 across a block (the weight path, across ranks).
MULTI_PLANS = ((0, (2, 3, 0, 1, 6, 7, 4, 5)), (1, (2, 1, 0, 3, 4, 5, 6, 7)))
MULTI_KERNELS = TRAIN_KERNELS
MULTI_DEVICE = "cuda"


def multi_cfg(layers: int):
    """Mixtral-8x7B at its published widths, the mixnet backend with the
    paper's regional delegation (``a2a_group=2``: 2 groups of 2 over a model
    axis of 4), dropless, remat "full", ``layers`` of its 32 layers.  The
    balance loss's weight is 0: over a mesh it is a per-shard mean (as the
    reference's), another function than one device's, and Adam's first,
    sign-like steps carried that 2e-5 difference to 1.8e-4 in 4 steps; the
    router z-loss (a token mean, the same function) stays."""
    from repro_torch.configs.paper_models import MIXTRAL_8X7B_CONFIG

    c = MIXTRAL_8X7B_CONFIG
    return dataclasses.replace(c, num_layers=layers, moe=dataclasses.replace(
        c.moe, a2a_group=2, dispatch="dropless", balance_loss=0.0))


def multi_trainer(torch, cfg, seed: int, plan, mesh, device, *, plans: bool, wire: bool = True,
                  **tcfg_kw):
    """A ``Trainer`` over ``mesh`` (None: one device) with the two plans of
    MULTI_PLANS applied before the first step when ``plans``: the AdamW
    moments stay in their slots (as the reference's), so a weight move
    after a step would give the weight run other moments than the wire
    run's; before the first step both are zero.  ``tcfg_kw``: more
    ``TrainerConfig`` fields (the evaluation phase's autotune cache)."""
    import numpy as np

    from repro_torch.core.controlplane import ControlPlane, LayerPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tr = Trainer(cfg, AdamWConfig(lr=MULTI_LR, warmup_steps=1, total_steps=TRAIN_STEPS),
                 TrainerConfig(total_steps=0, reconfig_every=10**6, **tcfg_kw), plan, mesh=mesh,
                 seed=seed, device=device)
    if plans:
        tr.controlplane = ControlPlane(num_layers=cfg.num_layers,
                                       num_experts=cfg.moe.num_experts, num_devices=4)
        if not wire:
            tr._wire_capable = lambda: False
        tr._apply_layer_plans([LayerPlan(layer, True, perm=np.array(perm))
                               for layer, perm in MULTI_PLANS if layer < cfg.num_layers])
    return tr


def multi_steps(torch, tr, cfg, seed: int, on_step=None, batch: int = 2):
    """MULTI_STEPS ``Trainer.train`` calls on the ``batch`` x 256 global
    batch of ``SyntheticLM``; ``on_step(i)`` after each, outside nothing."""
    from repro_torch.data.pipeline import SyntheticLM

    data = iter(SyntheticLM(cfg.vocab_size, seq_len=256, global_batch=batch, seed=seed))
    for s in range(1, MULTI_STEPS + 1):
        tr.tcfg.total_steps = s
        tr.train(data)
        torch.cuda.synchronize()
        if on_step is not None:
            on_step(s)
    return [float(m["loss"]) for m in tr.metrics_log]


def multi_reference(torch, seed: int) -> dict:
    """The one-device runs the ranks are held to: the (1, 4) run's model
    (depth 2, the same two plans, realized by weight moves) and the (2, 2)
    run's (depth 1), same seed, same data."""
    from repro_torch.parallel.sharding import make_plan

    out = {}
    for tag, layers, plans in (("14", 2, True), ("22", 1, False)):
        cfg = multi_cfg(layers)
        tr = multi_trainer(torch, cfg, seed, make_plan(None), None, MULTI_DEVICE, plans=plans)
        out[tag] = multi_steps(torch, tr, cfg, seed)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _leaf_digest(t) -> str:
    import hashlib

    import torch

    a = t.detach()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return hashlib.sha1(a.contiguous().cpu().numpy().tobytes()).hexdigest()


def multi_digests(tr) -> dict:
    """sha1 of every parameter leaf of this rank (expert leaves per layer)."""
    out = {}
    for path, leaf in _flat_tree(tr.params):
        if path.split("/")[-1] in ("w_in", "w_gate", "w_out"):
            for li in range(leaf.shape[0]):
                out[f"{path}#{li}"] = _leaf_digest(leaf[li])
        else:
            out[path] = _leaf_digest(leaf)
    return out


def multi_run(torch, cr, cfg, seed: int, mesh, device, *, plans: bool, wire: bool = True,
              count: bool = False, **tcfg_kw) -> dict:
    """One rank's run: MULTI_STEPS steps, each ``train`` call clocked whole,
    the wire bytes and host-staged bytes of each step, peak memory, the
    launch counts when ``count`` (reset just before the first step, read
    just after the last), the digests of the final parameters, and the MoE
    knobs the trainer ran with (``tcfg_kw``: more ``TrainerConfig``
    fields)."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import make_plan

    plan = make_plan(mesh, fsdp=False)
    t0 = time.perf_counter()
    tr = multi_trainer(torch, cfg, seed, plan, mesh, device, plans=plans, wire=wire, **tcfg_kw)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    wires, staged, call_ms = [], [], []
    marks = [cr.wire_bytes(), cr.host_staged_bytes(), time.perf_counter()]

    def on_step(_):
        now = [cr.wire_bytes(), cr.host_staged_bytes(), time.perf_counter()]
        wires.append([a - b for a, b in zip(dataclasses.astuple(now[0]),
                                             dataclasses.astuple(marks[0]))])
        staged.append(now[1] - marks[1])
        call_ms.append(1e3 * (now[2] - marks[2]))
        marks[:] = now

    if count:
        ops.reset_launch_counts()
    losses = multi_steps(torch, tr, cfg, seed, on_step)
    counts = ops.launch_counts() if count else None
    step_ms = [1e3 * m["step_time_s"] for m in tr.metrics_log]
    t0 = time.perf_counter()
    digests = multi_digests(tr)
    res = dict(losses=losses, step_ms=step_ms, call_ms=call_ms, wire_bytes=wires,
               staged_bytes=staged, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               counts=counts, digests=digests, init_s=t_init,
               digest_s=time.perf_counter() - t0,
               wire_perm=None if tr.wire_perm is None else tr.wire_perm.tolist(),
               wire_reconfigs=tr.wire_reconfig_count, reconfigs=tr.reconfig_count,
               params=sum(t.numel() for _, t in _flat_tree(tr.params)),
               overlap_chunks=tr.cfg.moe.overlap_chunks, dispatch=tr.cfg.moe.dispatch)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


def received_layout(torch, cfg, seed: int, p: int, tl: int):
    """The receive side of one rank's dropless dispatch over a model axis of
    ``p``: ``p`` sources each route ``tl`` tokens top-k over the experts
    (``E / p`` of them local); the ``[p * n]`` received expert ids by
    source, their dropless block plan, and source 0's own send plan and
    routing.  Returns ``(randn, valid, counts, plan, own)``, ``randn`` the
    generator's draw for what the caller makes next."""
    from repro_torch.models import routing

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    epd, n = e // p, tl * k
    randn = lambda *shape, dt=torch.float32: torch.randn(shape, generator=g, device=dev).to(dt)
    with torch.no_grad():
        recv, own = [], None
        for src in range(p):
            info = routing.compute_routing(randn(tl, e), top_k=k, num_virtual=e, replication=1)
            flat_dev = (info.vdest // epd).reshape(n)
            local_e = (info.vdest % epd).reshape(n)
            rank1, _ = routing.bucket_ranks(flat_dev, p)
            plan1 = routing.capacity_plan(flat_dev, rank1, None, p, n)
            send_e = torch.where(plan1.src >= 0, local_e[plan1.src.clamp(0, n - 1).long()],
                                 torch.full_like(plan1.src, -1)).reshape(p, n)
            recv.append(send_e[0])
            if src == 0:
                own = (plan1, info)
        re = torch.cat(recv).to(torch.int32)
        valid = re >= 0
        rank2, counts2 = routing.bucket_ranks(re, epd, valid=valid)
        plan2 = routing.dropless_plan(re, rank2, counts2, valid, epd, 8)
    return randn, valid, counts2, plan2, own


def rank_kernel_rows(torch, cfg, seed: int) -> dict:
    """Kernels 4, 5 and 7 at the shapes one rank of the (1, 4) run launches:
    128 tokens a rank routed top-2 over 8 experts, 2 of them local; the
    received layout [P * 256, D] (every source's dropless send buffer for
    this rank) packed into the 2-expert blocks, the blocks through kernel 7,
    the return trip's rows combined back to the rank's tokens (bf16 out)."""
    import torch.nn.functional as F

    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.kernels import ref

    bf16 = torch.bfloat16
    d, f = cfg.d_model, cfg.moe.d_ff
    e, k, p = cfg.moe.num_experts, cfg.moe.top_k, MULTI_RANKS
    epd, tl = e // p, 2 * 256 // p
    n = tl * k
    randn, valid, counts2, plan2, own = received_layout(torch, cfg, seed + 41, p, tl)
    rows = {}
    rx = randn(p * n, d, dt=bf16)
    rx[~valid] = 0
    packed = kmd.moe_dispatch_cuda(rx, plan2.src)
    assert torch.equal(packed, ref.moe_dispatch(rx, plan2.src)), "moe_dispatch rank pack differs"
    n_pack = plan2.src.shape[0]
    nv = int(valid.sum())
    rows["moe_dispatch_rank_pack"] = kernel_row(
        torch, "moe_dispatch_rank_pack", 0.0, lambda: kmd.moe_dispatch_cuda(rx, plan2.src), 200,
        time_ms(torch, lambda: ref.moe_dispatch(rx, plan2.src), 200), NO_LIBRARY,
        (nv + n_pack) * d * 2 + n_pack * 4, 0.0, "bfloat16",
        f"received [{p * n}, {d}] bf16 ({nv} valid) -> [{n_pack}, {d}], {epd} local experts",
    )
    nb = plan2.block_experts.shape[0]
    pad = (plan2.src < 0).reshape(nb, 8)
    dy = randn(nb, 8, f, dt=bf16)
    dy[pad] = 0
    blocks_rows(torch, rows, "_rank", packed.reshape(nb, 8, d), (randn(epd, d, f) * d**-0.5).to(bf16),
                dy, plan2.block_experts, counts2, f", {epd} local experts", parts=("",))
    plan1, info = own
    ret = randn(p * n, d, dt=bf16)
    slot = plan1.slot.reshape(tl, k)
    wts = info.wfull.float().contiguous()
    got = kmd.moe_combine_cuda(ret, slot, wts, out_dtype=bf16)
    err = check(torch, got, ref.moe_combine(ret, slot, wts), BF16_TOL, "moe_combine rank")
    slot_l, wts_b = slot.long(), wts.to(bf16)
    rows["moe_combine_rank"] = kernel_row(
        torch, "moe_combine_rank", err, lambda: kmd.moe_combine_cuda(ret, slot, wts,
                                                                    out_dtype=bf16), 200,
        time_ms(torch, lambda: ref.moe_combine(ret, slot, wts).to(bf16), 50),
        library_time(torch, lambda: F.embedding_bag(slot_l, ret, per_sample_weights=wts_b,
                                                    mode="sum"),
                     got, BF16_GEMM_REL, 200, "moe_combine_rank (F.embedding_bag)"),
        n * d * 2 + tl * k * 8 + tl * d * 2, 2.0 * n * d, "float32",
        f"returned [{p * n}, {d}] bf16, slot/w [{tl}, {k}] -> [{tl}, {d}] bf16",
    )
    return rows


def chunk_kernel_row(torch, cfg, seed: int, tc: int) -> dict:
    """Kernel 7 at one chunk's shapes of the tuned (1, 4) run: ``tc``
    tokens a rank and chunk routed top-2 over 8 experts, 2 of them local;
    every source's dropless send buffer of the chunk for this rank packed
    into the 2-expert blocks."""
    from repro_torch.kernels import ref

    bf16 = torch.bfloat16
    d, f = cfg.d_model, cfg.moe.d_ff
    e, k, p = cfg.moe.num_experts, cfg.moe.top_k, MULTI_RANKS
    epd = e // p
    randn, valid, counts2, plan2, _ = received_layout(torch, cfg, seed + 47, p, tc)
    rx = randn(p * tc * k, d, dt=bf16)
    rx[~valid] = 0
    packed = ref.moe_dispatch(rx, plan2.src)
    nb = plan2.block_experts.shape[0]
    dy = randn(nb, 8, f, dt=bf16)
    dy[(plan2.src < 0).reshape(nb, 8)] = 0
    rows = {}
    blocks_rows(torch, rows, "_chunk", packed.reshape(nb, 8, d),
                (randn(epd, d, f) * d**-0.5).to(bf16), dy, plan2.block_experts, counts2,
                f", {epd} local experts (one chunk of {tc} tokens a rank, the tuned run)",
                parts=("",))
    return rows


def multi_rank_main(rank: int, seed: int, port: int, out_path: str, tuned: str = "") -> None:
    """One of the four ranks (``torch.multiprocessing`` spawn): the (1, 4)
    run through the wire path (the main path, launches counted) and forced
    through the weight path, then the (2, 2) run; with ``tuned`` (the JSON
    of the evaluation phase's cache path and key) the (1, 4) wire run again
    with ``TrainerConfig(autotune_cache=, autotune_key=)`` (launches
    counted; with a tuned dispatch other than dropless also its one-chunk
    run); rank 0 also times kernels 4, 5 and 7 at its shapes (7 also at one
    tuned chunk's) and writes every rank's results."""
    import datetime

    import torch

    from repro_torch.core import commruntime as cr
    from repro_torch.launch.mesh import init_distributed, local_device, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, backend = init_distributed(
        "auto", rank=rank, world_size=MULTI_RANKS, init_method=f"tcp://localhost:{port}",
        device_type=MULTI_DEVICE, timeout=datetime.timedelta(seconds=MULTI_TIMEOUT_S))
    device = local_device(rank, MULTI_DEVICE)
    mesh14 = make_mesh((1, 4), ("data", "model"))
    mesh22 = make_mesh((2, 2), ("data", "model"))
    t0 = time.perf_counter()
    res = {"rank": rank, "backend": backend, "device": str(device)}
    res["wire"] = multi_run(torch, cr, multi_cfg(2), seed, mesh14, device, plans=True, count=True)
    res["weight"] = multi_run(torch, cr, multi_cfg(2), seed, mesh14, device, plans=True,
                              wire=False)
    res["mesh22"] = multi_run(torch, cr, multi_cfg(1), seed, mesh22, device, plans=False)
    res["seconds"] = time.perf_counter() - t0
    tc = None
    if tuned:
        from repro_torch.core.overlap import chunk_count

        t0 = time.perf_counter()
        tuned = json.loads(tuned)
        res["tuned"] = multi_run(torch, cr, multi_cfg(2), seed, mesh14, device, plans=True,
                                 count=True, autotune_cache=tuned["cache"],
                                 autotune_key=tuned["key"])
        if res["tuned"]["dispatch"] != "dropless":
            cfg1 = multi_cfg(2)
            cfg1 = dataclasses.replace(cfg1, moe=dataclasses.replace(
                cfg1.moe, dispatch=res["tuned"]["dispatch"]))
            res["tuned_one_chunk"] = multi_run(torch, cr, cfg1, seed, mesh14, device, plans=True)
        res["tuned_seconds"] = time.perf_counter() - t0
        tl = 2 * 256 // MULTI_RANKS  # a rank's tokens a layer: its sequence slice of 2 x 256
        tc = tl // chunk_count(tl, res["tuned"]["overlap_chunks"])
    rows = None
    if rank == 0:
        rows = rank_kernel_rows(torch, multi_cfg(2), seed)
        if tc is not None:
            rows.update(chunk_kernel_row(torch, multi_cfg(2), seed, tc))
    gathered = cr.all_gather_objects(res)
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps({"ranks": gathered, "rows": rows}))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def multi_rank_phase(torch, seed: int, tuned: dict | None = None) -> dict:
    """Four ranks on the one card (``torch.multiprocessing``, spawn; the
    kernels were built in this process before): the (1, 4) mesh with
    ``a2a_group=2`` at depth 2 (wire and weight runs) and the (2, 2) mesh at
    depth 1, MULTI_STEPS steps each, held to the one-device runs made here
    first (and freed before the spawn).  ``tuned``: the evaluation phase's
    cache path and key; the ranks also run the tuned (1, 4) run, which
    :func:`evaluation_card_checks` holds to the wire run."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    ref = multi_reference(torch, seed)
    t_ref = time.perf_counter() - t_phase
    print(f"multi-rank: one-device references, Mixtral-8x7B full width: depth 2 with the two "
          f"plans {['%.6f' % v for v in ref['14']]}, depth 1 {['%.6f' % v for v in ref['22']]}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out = pathlib.Path(tempfile.mkdtemp(dir=REPO / "build")) / "multi_rank.json"
    mp.spawn(multi_rank_main, args=(seed, port, str(out), json.dumps(tuned) if tuned else ""),
             nprocs=MULTI_RANKS, join=True)
    got = json.loads(out.read_text())
    out.unlink()
    ranks = got["ranks"]
    wire_run = [r["wire"] for r in ranks]
    weight_run = [r["weight"] for r in ranks]
    mesh22 = [r["mesh22"] for r in ranks]
    wire0 = wire_run[0]["wire_perm"]
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    staged = sum(sum(run["staged_bytes"]) for run in wire_run + weight_run + mesh22)
    errs = {tag: max(abs(a - b) / abs(b) for a, b in zip(runs_[0]["losses"], ref[tag]))
            for tag, runs_ in (("14", wire_run), ("22", mesh22))}
    # What was measured first, then the checks.
    print(f"multi-rank: backend {ranks[0]['backend']} ({MULTI_RANKS} ranks share "
          f"{ranks[0]['device']}; NCCL needs a card per rank); host-staged: "
          f"{'yes' if staged else 'no'} ({staged / 1e6:.1f} MB over all ranks and runs, "
          f"comm.host_staged_bytes: gloo took every collective's CUDA tensors)", flush=True)
    for tag, runs_ in (("(1, 4) wire", wire_run), ("(1, 4) weight", weight_run),
                       ("(2, 2)", mesh22)):
        print(f"multi-rank {tag}: losses {['%.6f' % v for v in runs_[0]['losses']]}; per-rank "
              f"median step ms (steps 2-{MULTI_STEPS}, trainer's clock) "
              f"{['%.1f' % med(r['step_ms'][1:]) for r in runs_]}; wire MB per step, rank 0 "
              f"(LinkBytes scale_up / scale_out / cross_region, comm.link_bytes) "
              f"{['/'.join('%.2f' % (v / 1e6) for v in b) for b in runs_[0]['wire_bytes']]}; "
              f"host-staged MB per step (rank 0) "
              f"{['%.2f' % (b / 1e6) for b in runs_[0]['staged_bytes']]}; peak GB per rank "
              f"{['%.2f' % r['peak_gb'] for r in runs_]}; parameters per rank "
              f"{[r['params'] for r in runs_]}", flush=True)
    print(f"multi-rank: P = 4 against one device, max rel loss diff over {MULTI_STEPS} steps: "
          f"(1, 4) {errs['14']:.3e}, (2, 2) {errs['22']:.3e} (limit {MULTI_LOSS_REL})",
          flush=True)
    print(f"multi-rank: kernel launches per rank, (1, 4) wire run: "
          f"{[{k: run['counts'][k] for k in MULTI_KERNELS} for run in wire_run]}", flush=True)
    print(f"multi-rank: phase {time.perf_counter() - t_phase:.1f} s (references "
          f"{t_ref:.1f} s; ranks {['%.1f' % r['seconds'] for r in ranks]} s; rank 0 init / "
          f"steps / digests s: "
          + ", ".join(f"{k} {r['init_s']:.1f} / {sum(r['call_ms']) / 1e3:.1f} / "
                      f"{r['digest_s']:.1f}" for k, r in (("wire", wire_run[0]),
                                                       ("weight", weight_run[0]),
                                                       ("(2, 2)", mesh22[0])))
          + ")", flush=True)
    # Every rank reports the global loss; wire and weight runs bit for bit.
    for r in range(MULTI_RANKS):
        assert wire_run[r]["losses"] == wire_run[0]["losses"], "ranks disagree on the loss"
        assert weight_run[r]["losses"] == wire_run[r]["losses"], \
            f"rank {r}: weight-path losses {weight_run[r]['losses']} != wire {wire_run[r]['losses']}"
        assert mesh22[r]["losses"] == mesh22[0]["losses"], "(2, 2) ranks disagree on the loss"
    assert wire0 is not None and wire0[0] != [0, 1, 2, 3] and wire0[1] == [0, 1, 2, 3], wire0
    assert all(r["wire_reconfigs"] == 1 for r in wire_run), "the wire plan did not land"
    assert all(r["wire_reconfigs"] == 0 and r["reconfigs"] == 2 for r in weight_run)
    for r in range(MULTI_RANKS):
        for key, dg in wire_run[r]["digests"].items():
            _, expert, layer = key.partition("#")
            # The weight run moved layer 0's expert blocks across ranks: rank r
            # holds what the wire run keeps on rank wire0[0][r].
            want = wire_run[wire0[0][r]]["digests"][key] if layer == "0" else dg
            assert weight_run[r]["digests"][key] == want, \
                f"rank {r} {key}: the weight run's parameter differs from the wire run's"
            if not expert:
                assert dg == wire_run[0]["digests"][key], f"{key}: differs across ranks"
        for key, dg in mesh22[r]["digests"].items():
            if "#" not in key:
                assert dg == mesh22[0]["digests"][key], f"(2, 2) {key}: differs across ranks"
    for tag, runs_ in (("14", wire_run), ("22", mesh22)):
        assert errs[tag] <= MULTI_LOSS_REL, \
            f"({tag}) losses {runs_[0]['losses']} vs one device {ref[tag]}: rel {errs[tag]:.3e}"
    for r, run in enumerate(wire_run):
        missing = [k for k in MULTI_KERNELS if not run["counts"][k]]
        assert not missing, f"rank {r}: kernels never launched on the multi-rank path: {missing}"
    assert all(math.isfinite(v) for run in wire_run + mesh22 for v in run["losses"])
    print(f"multi-rank: checks held: (1, 4) wire run == weight run bit for bit (losses and every "
          f"parameter, layer 0's expert blocks on the rank the wire map {wire0[0]} names); "
          f"non-expert parameters bit-identical on all {MULTI_RANKS} ranks in both meshes; "
          f"reconfigurations 1 wire + 1 weight (across ranks) in the wire run, 2 weight in the "
          f"weight run; losses within {MULTI_LOSS_REL} of one device; every kernel of "
          f"{MULTI_KERNELS} launched on every rank", flush=True)
    E2E["multi-rank (1, 4) median step ms per rank"] = [med(r["step_ms"][1:]) for r in wire_run]
    E2E["multi-rank (1, 4) wire bytes per step, rank 0"] = wire_run[0]["wire_bytes"]
    E2E["multi-rank (2, 2) median step ms per rank"] = [med(r["step_ms"][1:]) for r in mesh22]
    E2E["multi-rank (2, 2) wire bytes per step, rank 0"] = mesh22[0]["wire_bytes"]
    rows = got["rows"]
    for name, kernel in (("moe_dispatch_rank_pack", "moe_dispatch"),
                         ("grouped_matmul_blocks_rank", "grouped_matmul_blocks"),
                         ("moe_combine_rank", "moe_combine")):
        rows[name]["launches"] = wire_run[0]["counts"][kernel]
    return {"rows": rows, "counts": [run["counts"] for run in wire_run], "ranks": ranks}


# ---------------------------------------------------------------------------
# phase 14c: the evaluation plane, and the trainer consuming a tuned cache
# ---------------------------------------------------------------------------


EVAL_SERVERS = 128  # the paper's 128-server cluster (tests/test_netsim.py's)
EVAL_ITERS = 5
EVAL_GBPS = 400  # the autotuned link rate
SIM = "simulated: the flow-level netsim's A100 cluster, not the card"


def evaluation_host_phase(torch, seed: int) -> dict:
    """(a) The paper's headline through the port's netsim: Mixtral-8x7B on
    128 servers, MixNet against fat-tree at 100 and 400 Gbps, 5 iterations
    (the first dropped); the cost-efficiency ratio must clear the
    reference's own thresholds.  (b) ``autotune.tune`` over the full
    search space into a cache file under build/.  Then a cache miss on the
    card: a trainer whose key is absent keeps its config and counts
    ``autotune.cache_miss``.  Host-side numpy but the miss; returns the
    cache path, the key and the tuned knobs."""
    import tempfile

    import numpy as np

    from repro_torch.configs.paper_models import MIXTRAL_8X7B
    from repro_torch.core import autotune
    from repro_torch.core import cost as costm
    from repro_torch.core.fabric import FabricConfig, make_fabric
    from repro_torch.core.netsim import simulate_training
    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.obs import metrics
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    ratios = {}
    for gbps in (100, 400):
        iters, cost = {}, {}
        for name in ("mixnet", "fat-tree"):
            fab = make_fabric(name, FabricConfig(num_servers=EVAL_SERVERS, link_gbps=gbps))
            res = simulate_training(MIXTRAL_8X7B, fab, iterations=EVAL_ITERS, seed=seed,
                                    use_copilot=(name == "mixnet"))
            iters[name] = float(np.mean([r.total for r in res[1:]]))
            cost[name] = costm.fabric_cost(name, EVAL_SERVERS, gbps)
        ratios[gbps] = (costm.cost_efficiency(iters["mixnet"], cost["mixnet"])
                        / costm.cost_efficiency(iters["fat-tree"], cost["fat-tree"]))
        print(f"evaluation ({SIM}): {MIXTRAL_8X7B.name} on {EVAL_SERVERS} servers at {gbps} G, "
              f"mean iteration s (iterations 2-{EVAL_ITERS}) mixnet {iters['mixnet']!r}, "
              f"fat-tree {iters['fat-tree']!r}; fabric_cost USD mixnet {cost['mixnet']!r}, "
              f"fat-tree {cost['fat-tree']!r}; performance per dollar mixnet / fat-tree "
              f"{ratios[gbps]!r}", flush=True)
    t_head = time.perf_counter() - t0
    assert ratios[100] > 1.2 and ratios[400] > 1.9 and ratios[400] > ratios[100], ratios
    cache = pathlib.Path(tempfile.mkdtemp(dir=REPO / "build")) / "autotune_cache.json"
    t0 = time.perf_counter()
    tuned = autotune.tune(MIXTRAL_8X7B, "mixnet", EVAL_GBPS, cache_path=str(cache), seed=seed)
    t_tune = time.perf_counter() - t0
    print(f"evaluation: autotune.tune({MIXTRAL_8X7B.name}, mixnet, {EVAL_GBPS} G) over the full "
          f"SEARCH_SPACE ({len(autotune.SEARCH_SPACE)} knobs) -> {cache.relative_to(REPO)}: "
          f"key {tuned.key!r}, knobs {json.dumps(tuned.knobs, sort_keys=True)}, goodput "
          f"{tuned.goodput_tok_s!r} tokens/s against the default's "
          f"{tuned.default_goodput_tok_s!r} ({SIM}), speedup {tuned.speedup!r}; "
          f"{t_tune:.2f} s of host time (the headline {t_head:.2f} s)", flush=True)
    assert tuned.speedup >= 1.0 - 1e-9 and autotune.load_cached(str(cache), tuned.key) == tuned
    # A miss on the card: the configured constants stay, the counter counts.
    cfg = ModelConfig("tiny-moe8", "moe", 2, 64, 4, 2, 0, 128, dtype="bfloat16", remat="none",
                      moe=MoEConfig(num_experts=8, top_k=2, d_ff=64, backend="mixnet",
                                    overlap_chunks=2))
    misses = metrics.counter("autotune.cache_miss").value
    tr = Trainer(cfg, AdamWConfig(), TrainerConfig(autotune_cache=str(cache),
                                                   autotune_key="absent|key"),
                 make_plan(None), seed=seed, device=MULTI_DEVICE)
    assert tr.cfg == cfg, "a cache miss changed the model config"
    assert metrics.counter("autotune.cache_miss").value == misses + 1
    del tr
    print("evaluation: a cache miss on the card (key 'absent|key') kept the configured "
          "constants (overlap_chunks 2, dropless) and counted autotune.cache_miss once",
          flush=True)
    return {"cache": str(cache), "key": tuned.key, "knobs": tuned.knobs}


def evaluation_card_checks(torch, tuned: dict, multi: dict) -> dict:
    """(c) The tuned four-rank (1, 4) run the multi-rank phase made: the
    trainer took the cache's knobs; its losses and every parameter equal,
    bit for bit, the run with the same dispatch at one chunk (the wire run
    when the tuned dispatch is dropless); every kernel of MULTI_KERNELS
    launched on every rank.  Prints each rank's median step, tuned against
    that run, and the wire bytes by link class."""
    from repro_torch.core.overlap import chunk_count

    ranks = multi["ranks"]
    tuned_run = [r["tuned"] for r in ranks]
    ref_key = "wire" if tuned["knobs"]["moe_dispatch"] == "dropless" else "tuned_one_chunk"
    ref_run = [r[ref_key] for r in ranks]
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    tl = 2 * 256 // MULTI_RANKS
    chunks = chunk_count(tl, tuned_run[0]["overlap_chunks"])
    print(f"evaluation (card): tuned (1, 4) run, knobs overlap_chunks "
          f"{tuned_run[0]['overlap_chunks']} ({chunks} chunks of {tl // chunks} of a rank's "
          f"{tl} tokens a layer), dispatch {tuned_run[0]['dispatch']}; losses "
          f"{['%.6f' % v for v in tuned_run[0]['losses']]}; per-rank median step ms (steps "
          f"2-{MULTI_STEPS}) tuned {['%.1f' % med(r['step_ms'][1:]) for r in tuned_run]} against "
          f"one chunk ({ref_key} run) {['%.1f' % med(r['step_ms'][1:]) for r in ref_run]}; wire "
          f"MB per step, rank 0 (scale_up / scale_out / cross_region) tuned "
          f"{['/'.join('%.2f' % (v / 1e6) for v in b) for b in tuned_run[0]['wire_bytes']]}, one "
          f"chunk {['/'.join('%.2f' % (v / 1e6) for v in b) for b in ref_run[0]['wire_bytes']]}; "
          f"host-staged MB per step (rank 0) "
          f"{['%.2f' % (b / 1e6) for b in tuned_run[0]['staged_bytes']]}; peak GB per rank "
          f"{['%.2f' % r['peak_gb'] for r in tuned_run]}; launches per rank "
          f"{[{k: run['counts'][k] for k in MULTI_KERNELS} for run in tuned_run]}; the ranks' "
          f"tuned runs {['%.1f' % r['tuned_seconds'] for r in ranks]} s", flush=True)
    for r in range(MULTI_RANKS):
        run = tuned_run[r]
        assert run["overlap_chunks"] == tuned["knobs"]["overlap_chunks"], run["overlap_chunks"]
        assert run["dispatch"] == tuned["knobs"]["moe_dispatch"], run["dispatch"]
        assert run["losses"] == ref_run[r]["losses"], \
            f"rank {r}: tuned losses {run['losses']} != one chunk's {ref_run[r]['losses']}"
        diff = [k for k, v in run["digests"].items() if ref_run[r]["digests"][k] != v]
        assert not diff, f"rank {r}: the tuned run's parameters differ from one chunk's: {diff}"
        missing = [k for k in MULTI_KERNELS if not run["counts"][k]]
        assert not missing, f"rank {r}: kernels never launched in the tuned run: {missing}"
    assert chunks > 1, "the tuned run did not chunk: nothing was held"
    print(f"evaluation: checks held: the tuned run ({chunks} chunks) equals the one-chunk "
          f"{ref_key} run bit for bit on all {MULTI_RANKS} ranks (losses and every parameter); "
          f"every kernel of {MULTI_KERNELS} launched on every rank", flush=True)
    E2E["evaluation tuned (1, 4) median step ms per rank"] = [med(r["step_ms"][1:])
                                                              for r in tuned_run]
    E2E["evaluation one-chunk (1, 4) median step ms per rank"] = [med(r["step_ms"][1:])
                                                                  for r in ref_run]
    E2E["evaluation tuned (1, 4) wire bytes per step, rank 0"] = tuned_run[0]["wire_bytes"]
    multi["rows"]["grouped_matmul_blocks_chunk"]["launches"] = \
        tuned_run[0]["counts"]["grouped_matmul_blocks"]
    return {"counts": [run["counts"] for run in tuned_run]}


# ---------------------------------------------------------------------------
# phase 14b: pipeline-parallel MixNet training, four ranks sharing the card
# ---------------------------------------------------------------------------


PIPE_STAGES, PIPE_MODEL = 2, 2  # the ("stage", "model") mesh
PIPE_BATCH, PIPE_MICRO = 4, 4  # 4 x 256 a step in 4 microbatches of 1 x 256: M > S
# One plan per stage, each landing on the stage that owns its layer: layer 0
# swaps slots 0 and 4 (across stage 0's two ranks: a weight move), layer 1
# swaps the two device blocks (a wire re-address of stage 1's ranks).
PIPE_PLANS = ((0, (4, 1, 2, 3, 0, 5, 6, 7)), (1, (4, 5, 6, 7, 0, 1, 2, 3)))


def pipe_trainer(torch, cfg, seed: int, plan, mesh, device):
    """A ``Trainer`` with PIPE_MICRO microbatches, pipelined over ``mesh``
    (None: the flat trainer on one device), the two plans of PIPE_PLANS
    applied before the first step (on one device both by weight moves)."""
    import numpy as np

    from repro_torch.core.controlplane import ControlPlane, LayerPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tr = Trainer(cfg, AdamWConfig(lr=MULTI_LR, warmup_steps=1, total_steps=TRAIN_STEPS),
                 TrainerConfig(total_steps=0, reconfig_every=10**6, num_microbatches=PIPE_MICRO,
                               pp_stages=PIPE_STAGES if mesh is not None else 1),
                 plan, mesh=mesh, seed=seed, device=device)
    tr.controlplane = ControlPlane(num_layers=cfg.num_layers, num_experts=cfg.moe.num_experts,
                                   num_devices=PIPE_MODEL)
    tr._apply_layer_plans([LayerPlan(layer, True, perm=np.array(perm))
                           for layer, perm in PIPE_PLANS])
    return tr


def stage_kernel_row(torch, cfg, seed: int) -> dict:
    """Kernel 7 at a stage rank's shape: one 1 x 256 microbatch over the
    stage's model axis of 2 (128 tokens a rank, top-2 over 8 experts, 4 of
    them local), every source's dropless send buffer for this rank packed
    into the 4-expert blocks."""
    from repro_torch.kernels import ref

    bf16 = torch.bfloat16
    d, f = cfg.d_model, cfg.moe.d_ff
    e, k, p = cfg.moe.num_experts, cfg.moe.top_k, PIPE_MODEL
    epd, tl = e // p, 256 // p
    randn, valid, counts2, plan2, _ = received_layout(torch, cfg, seed + 43, p, tl)
    rx = randn(p * tl * k, d, dt=bf16)
    rx[~valid] = 0
    packed = ref.moe_dispatch(rx, plan2.src)
    nb = plan2.block_experts.shape[0]
    dy = randn(nb, 8, f, dt=bf16)
    dy[(plan2.src < 0).reshape(nb, 8)] = 0
    rows = {}
    blocks_rows(torch, rows, "_stage", packed.reshape(nb, 8, d),
                (randn(epd, d, f) * d**-0.5).to(bf16), dy, plan2.block_experts, counts2,
                f", {epd} local experts (a pipeline stage rank)", parts=("",))
    return rows


def pipe_rank_main(rank: int, seed: int, port: int, out_path: str) -> None:
    """One of the four ranks of the ``(2, 2)`` ``("stage", "model")`` run:
    MULTI_STEPS pipelined steps, launches counted (reset just before the
    first step, read just after the last); rank 0 also times kernel 7 at a
    stage rank's shape and writes every rank's results."""
    import datetime

    import torch

    from repro_torch.core import commruntime as cr
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed, local_device, make_mesh
    from repro_torch.obs import metrics
    from repro_torch.parallel.sharding import make_plan, stage_layers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, _, backend = init_distributed(
        "auto", rank=rank, world_size=MULTI_RANKS, init_method=f"tcp://localhost:{port}",
        device_type=MULTI_DEVICE, timeout=datetime.timedelta(seconds=MULTI_TIMEOUT_S))
    device = local_device(rank, MULTI_DEVICE)
    mesh = make_mesh((PIPE_STAGES, PIPE_MODEL), ("stage", "model"))
    plan = make_plan(mesh, fsdp=False)
    cfg = multi_cfg(2)
    t_rank = time.perf_counter()
    tr = pipe_trainer(torch, cfg, seed, plan, mesh, device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_rank
    torch.cuda.reset_peak_memory_stats()
    stage_bytes = lambda: metrics.default().value(  # noqa: E731
        "comm.link_bytes", op="p2p", link="cross_region")
    wires, stage, staged, call_ms = [], [], [], []
    marks = [cr.wire_bytes(), stage_bytes(), cr.host_staged_bytes(), time.perf_counter()]

    def on_step(_):
        now = [cr.wire_bytes(), stage_bytes(), cr.host_staged_bytes(), time.perf_counter()]
        wires.append([a - b for a, b in zip(dataclasses.astuple(now[0]),
                                             dataclasses.astuple(marks[0]))])
        stage.append(now[1] - marks[1])
        staged.append(now[2] - marks[2])
        call_ms.append(1e3 * (now[3] - marks[3]))
        marks[:] = now

    ops.reset_launch_counts()
    losses = multi_steps(torch, tr, cfg, seed, on_step, batch=PIPE_BATCH)
    counts = ops.launch_counts()
    res = dict(rank=rank, backend=backend, device=str(device), losses=losses,
               step_ms=[1e3 * m["step_time_s"] for m in tr.metrics_log], call_ms=call_ms,
               wire_bytes=wires, stage_bytes=stage, staged_bytes=staged,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, counts=counts,
               digests=multi_digests(tr), init_s=t_init,
               stage=stage_layers(mesh, cfg.num_layers)[0],
               applied_here=tr._bound_applier().applied_here,
               wire_perm=None if tr.wire_perm is None else tr.wire_perm.tolist(),
               params=sum(t.numel() for _, t in _flat_tree(tr.params)))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_rank
    rows = stage_kernel_row(torch, cfg, seed) if rank == 0 else None
    gathered = cr.all_gather_objects(res)
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps({"ranks": gathered, "rows": rows}))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def pipeline_phase(torch, seed: int) -> dict:
    """Four ranks on the one card as two pipeline stages of two model ranks
    (``torch.multiprocessing``, spawn), Mixtral-8x7B at its published
    widths, depth 2 (one layer a stage), MULTI_STEPS steps of PIPE_BATCH x
    256 in PIPE_MICRO microbatches, held to the flat one-device trainer made
    here first (and freed before the spawn)."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.parallel.sharding import make_plan

    t_phase = time.perf_counter()
    cfg = multi_cfg(2)
    tr = pipe_trainer(torch, cfg, seed, make_plan(None), None, MULTI_DEVICE)
    ref = multi_steps(torch, tr, cfg, seed, batch=PIPE_BATCH)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    print(f"pipeline: one-device reference, Mixtral-8x7B full width, depth 2, {PIPE_MICRO} "
          f"microbatches, the two plans by weight moves: {['%.6f' % v for v in ref]}", flush=True)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out = pathlib.Path(tempfile.mkdtemp(dir=REPO / "build")) / "pipeline.json"
    mp.spawn(pipe_rank_main, args=(seed, port, str(out)), nprocs=MULTI_RANKS, join=True)
    got = json.loads(out.read_text())
    out.unlink()
    ranks = got["ranks"]
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    err = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], ref))
    bubble = (PIPE_STAGES - 1) / (PIPE_MICRO + PIPE_STAGES - 1)
    staged = sum(sum(r["staged_bytes"]) for r in ranks)
    # What was measured first, then the checks.
    print(f"pipeline: ({PIPE_STAGES}, {PIPE_MODEL}) (\"stage\", \"model\") mesh, backend "
          f"{ranks[0]['backend']} ({MULTI_RANKS} ranks share {ranks[0]['device']}); losses "
          f"{['%.6f' % v for v in ranks[0]['losses']]}; max rel diff from one device "
          f"{err:.3e} (limit {MULTI_LOSS_REL})", flush=True)
    print(f"pipeline: per-rank median step ms (steps 2-{MULTI_STEPS}, trainer's clock) "
          f"{['%.1f' % med(r['step_ms'][1:]) for r in ranks]}; stage-to-stage MB a step "
          f"(p2p cross_region: stage 0 sends the forward activations, stage 1 the backward "
          f"gradients and the loss) {['%.3f' % (med(r['stage_bytes']) / 1e6) for r in ranks]}; "
          f"wire MB a step by rank (LinkBytes scale_up / scale_out / cross_region, "
          f"comm.link_bytes, step 2) "
          f"{['/'.join('%.2f' % (v / 1e6) for v in r['wire_bytes'][1]) for r in ranks]}; "
          f"host-staged MB a step (rank 0) {['%.2f' % (b / 1e6) for b in ranks[0]['staged_bytes']]}"
          f" ({staged / 1e6:.1f} MB over all ranks); peak GB per rank "
          f"{['%.2f' % r['peak_gb'] for r in ranks]}; parameters per rank "
          f"{[r['params'] for r in ranks]}", flush=True)
    print(f"pipeline: kernel launches per rank: "
          f"{[{k: r['counts'][k] for k in MULTI_KERNELS} for r in ranks]}", flush=True)
    print(f"pipeline: GPipe bubble fraction (S - 1) / (M + S - 1) = {bubble:.3f} (S = "
          f"{PIPE_STAGES}, M = {PIPE_MICRO}), by the schedule, not measured: the four ranks "
          f"share one card, so a stage's idle time is another's busy time", flush=True)
    print(f"pipeline: phase {time.perf_counter() - t_phase:.1f} s (reference {t_ref:.1f} s; "
          f"ranks {['%.1f' % r['seconds'] for r in ranks]} s; init "
          f"{['%.1f' % r['init_s'] for r in ranks]} s)", flush=True)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"], "ranks disagree on the loss"
        want = {"weight": 1, "wire": 0} if r["stage"] == 0 else {"weight": 0, "wire": 1}
        assert r["applied_here"] == want, \
            f"rank {r['rank']} (stage {r['stage']}): applied {r['applied_here']}, want {want}"
        assert r["wire_perm"] == [[0, 1], [1, 0]], r["wire_perm"]
        twin = ranks[r["rank"] ^ 1]  # the other rank of the stage's model group
        for key, dg in r["digests"].items():
            if "#" not in key:
                assert dg == twin["digests"][key], f"{key}: differs across a stage's model group"
        missing = [k for k in MULTI_KERNELS if not r["counts"][k]]
        assert not missing, f"rank {r['rank']}: kernels never launched on the pipeline: {missing}"
        assert all(math.isfinite(v) for v in r["losses"])
    assert err <= MULTI_LOSS_REL, f"losses {ranks[0]['losses']} vs one device {ref}: {err:.3e}"
    print(f"pipeline: checks held: losses within {MULTI_LOSS_REL} of one device and equal on "
          f"all {MULTI_RANKS} ranks; 1 weight move on stage 0, 1 wire re-address on stage 1; "
          f"non-expert parameters bit-identical in each stage's model group; every kernel of "
          f"{MULTI_KERNELS} launched on every rank", flush=True)
    E2E["pipeline (2, 2) median step ms per rank"] = [med(r["step_ms"][1:]) for r in ranks]
    E2E["pipeline (2, 2) stage bytes per step per rank"] = [med(r["stage_bytes"]) for r in ranks]
    rows = got["rows"]
    rows["grouped_matmul_blocks_stage"]["launches"] = ranks[0]["counts"]["grouped_matmul_blocks"]
    return {"rows": rows, "counts": [r["counts"] for r in ranks]}


def chat_requests(seed: int, vocab: int, max_len: int):
    """(generator, the ``REQUESTS`` chat requests) every serve takes: prompts
    and outputs capped to fit ``max_len``; token ids below ``vocab``."""
    from repro_torch.serve.workload import WorkloadGenerator

    gen = WorkloadGenerator("chat", seed=seed, vocab_size=vocab)
    out_cap = max(1, min(12, max_len // 4))
    return gen, [
        dataclasses.replace(
            r, prompt_len=max(1, min(r.prompt_len, max_len - out_cap - 2)),
            max_new_tokens=min(r.max_new_tokens, out_cap),
        )
        for r in gen.generate(REQUESTS)
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="weights and workload seed")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one serve and two training steps with torch.profiler and "
                         "print device time by kernel")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke.py: no src/repro_torch beside {REPO}; run it from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.moe import resolve_draft_mode
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {len(built)} libraries {built} in {time.perf_counter() - t0:.1f} s "
          f"-> {build.BUILD_DIR}", flush=True)

    slots, max_len, page = 4, 256, 16
    cfg = dataclasses.replace(get_config("grok-1-314b"), num_layers=LAYERS)
    plan = make_plan(None)
    gen, reqs = chat_requests(args.seed, cfg.vocab_size, max_len)
    prompt_lens = [r.prompt_len for r in reqs]
    rows = kernel_phase(torch, cfg, prompt_lens, slots, page, max_len, args.seed)

    t0 = time.perf_counter()
    params = init_model(args.seed, cfg, plan, device="cuda")
    torch.cuda.synchronize()
    print(f"model: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"experts={cfg.moe.num_experts} top{cfg.moe.top_k} d_ff={cfg.moe.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers}/64, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)

    probe = gen.prompt_tokens(reqs[0])
    probe = probe if len(probe) >= 40 else probe.repeat(-(-40 // len(probe)))[:40]
    rel = decode_vs_prefill(torch, params, cfg, plan, probe[:64].astype("int32"), page)
    print(f"check: paged decode vs full prefill logits, max |diff| / max |logit| = {rel:.3e}",
          flush=True)

    rep_off, toks_off, counts_off, _ = serve(torch, params, cfg, plan, reqs, gen,
                                             reconfig_every=0, slots=slots, max_len=max_len,
                                             page=page)
    rep_on, toks_on, counts_on, shapes_on = serve(torch, params, cfg, plan, reqs, gen,
                                                  reconfig_every=4, slots=slots, max_len=max_len,
                                                  page=page)
    assert rep_off.completed == len(reqs) == rep_on.completed, "not every request completed"
    assert rep_on.reconfig_count > 0, "the control plane never reconfigured"
    assert toks_on == toks_off, "reconfiguration changed the generated tokens"
    assert all(0 <= t < cfg.vocab_size for out in toks_on.values() for t in out)
    for counts in (counts_off, counts_on):
        missing = [n for n in SERVE_KERNELS if counts[n] == 0]
        assert not missing, f"kernels never launched while serving: {missing}"
    print(f"serve: tokens bit-identical with reconfiguration off and on "
          f"({rep_on.reconfig_count} reconfigurations)", flush=True)
    # Sampled and speculative serving, reconfiguration on: speculative
    # tokens must equal serial tokens bit for bit, greedy and sampled.
    kw = dict(reconfig_every=4, slots=slots, max_len=max_len, page=page)
    sampled = dict(sample=True, sample_seed=1)
    rep_s, toks_s, counts_s, _ = serve(torch, params, cfg, plan, reqs, gen, **kw, **sampled)
    rep_sg, toks_sg, counts_sg, shapes_sg = serve(torch, params, cfg, plan, reqs, gen, **kw,
                                                  spec_k=SPEC_K)
    rep_ss, toks_ss, counts_ss, _ = serve(torch, params, cfg, plan, reqs, gen, **kw,
                                          spec_k=SPEC_K, **sampled)
    assert toks_sg == toks_off, "speculative greedy tokens differ from serial greedy tokens"
    assert toks_ss == toks_s, "speculative sampled tokens differ from serial sampled tokens"
    assert toks_s != toks_off, "sampled tokens equal the greedy ones: the draw is not threaded"
    assert all(0 <= t < cfg.vocab_size for out in toks_s.values() for t in out)
    for rep in (rep_s, rep_sg, rep_ss):
        assert rep.reconfig_count > 0, "the control plane never reconfigured"
    assert rep_sg.spec_drafted > 0 and rep_ss.spec_drafted > 0
    for counts in (counts_s, counts_sg, counts_ss):
        missing = [n for n in SERVE_KERNELS if counts[n] == 0]
        assert not missing, f"kernels never launched while serving: {missing}"
    rows["paged_flash_decode_verify"]["launches"] = \
        shapes_sg["paged_flash_decode"].get((slots, SPEC_K + 1), 0)
    rows["paged_flash_decode_chunk"]["launches"] = sum(
        n for (b, _), n in shapes_on["paged_flash_decode"].items() if b == 1)
    print(f"serve: speculative tokens (spec_k={SPEC_K}, the {resolve_draft_mode(cfg)} draft) "
          f"bit-identical to serial tokens, greedy (acceptance {rep_sg.spec_acceptance:.4f}) "
          f"and sampled (acceptance {rep_ss.spec_acceptance:.4f}), reconfiguration on",
          flush=True)
    rows["rmsnorm_grok"] = grok_norm_row(torch, cfg, shapes_on["rmsnorm"], args.seed)
    if args.profile:
        from repro_torch.serve.engine import ServeConfig

        profile_serve(torch, params, cfg, plan, reqs, gen,
                      ServeConfig(slots=slots, max_len=max_len, page_size=page, num_devices=4))

    # Mamba-2 serving, then training: free the serving model first (the
    # served engines' clocked ``step`` wrappers hold them in reference
    # cycles, which only the collector frees).
    del params
    gc.collect()
    torch.cuda.empty_cache()
    counts_fleet = fleet_phase(torch, args.seed, page)
    gc.collect()
    torch.cuda.empty_cache()
    mamba_rows, counts_mamba, counts_gen = mamba_part(torch, args.seed, args.profile)
    rows.update(mamba_rows)
    from repro_torch.configs.paper_models import MIXTRAL_8X7B_CONFIG

    rows.update(train_kernel_phase(torch, MIXTRAL_8X7B_CONFIG, 2, 256, args.seed))
    rows.update(capacity_kernel_phase(torch, capacity_config(MIXTRAL_8X7B_CONFIG), 2, 256,
                                      args.seed))
    # What the kernel phases left for the collector goes before the training
    # phases measure peak memory.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"kernel phases done: {torch.cuda.memory_allocated() / 1e9:.3f} GB still allocated",
          flush=True)
    step_card_vs_cpu(torch, args.seed)
    # A capacity factor of 1.0 drops choices at stage 2 (-1 rows under autograd).
    step_card_vs_cpu(torch, args.seed, dispatch="capacity", capacity_factor=1.0)
    remat_phase(torch, args.seed)
    counts_train, _ = train(
        torch, dataclasses.replace(MIXTRAL_8X7B_CONFIG, num_layers=TRAIN_LAYERS), args.seed,
        args.profile, TRAIN_KERNELS,
    )
    counts_cap, _ = train_capacity_and_resume(torch, args.seed, args.profile)
    serve_checkpoint_phase(torch, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    dense = dense_phase(torch, args.seed, page)
    rows.update(dense["rows"])
    gc.collect()
    torch.cuda.empty_cache()
    tuned = evaluation_host_phase(torch, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    multi = multi_rank_phase(torch, args.seed, tuned)
    counts_eval = evaluation_card_checks(torch, tuned, multi)["counts"]
    rows.update(multi["rows"])
    pipe = pipeline_phase(torch, args.seed)
    rows.update(pipe["rows"])

    # launches: each kernel's count from the path it belongs to — the
    # capacity training run for kernel 6 and its backward, the dropless run
    # for every other kernel it launches, the grok serve (reconfiguration
    # on) for the decode kernel, which only serving runs.  A row at a second
    # shape (SHAPE_ROWS) reports its kernel's count, except the rows of
    # kernels 8 and 9 on the serving paths: each carries the launches at its
    # own shapes (``mamba_part``, ``grok_norm_row``); kernel 8's Mixtral row
    # and its backward take the dropless run's.  The times of the training kernels are at the
    # training steps' shapes.
    line = []
    for row_name, (source, replaces) in KERNEL_ROWS.items():
        r = rows[row_name]
        name = SHAPE_ROWS.get(row_name, row_name)
        launches = (r["launches"] if "launches" in r
                    else counts_train[name] if name in TRAIN_KERNELS
                    else counts_cap[name] if name in CAPACITY_KERNELS else counts_on[name])
        line.append(dict(
            name=row_name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], device_ms=r["device_ms"], graph_ms=r.get("graph_ms"),
            library_device_ms=r["library_device_ms"], shape=r["shape"],
            launches_by_path={"serve": counts_on[name], "train": counts_train[name],
                              "train_capacity": counts_cap[name],
                              "serve_mamba2": counts_mamba[name], "generate": counts_gen[name],
                              "fleet": counts_fleet[name],
                              "multi_rank": [c[name] for c in multi["counts"]],
                              "pipeline": [c[name] for c in pipe["counts"]],
                              "dense_train": dense["train"][name],
                              "dense_serve": dense["serve"][name],
                              "evaluation": [c[name] for c in counts_eval]},
        ))
    assert all(math.isfinite(v) for r in line for k, v in r.items()
               if k.endswith("ms") and v is not None)
    assert all(r["launches"] > 0 for r in line), [r["name"] for r in line if not r["launches"]]
    assert len(line) == len(KERNEL_ROWS) == 51, [r["name"] for r in line]
    spec_key = f"grok spec round kernels (draft, verify), reconfig_every=4, spec_k={SPEC_K}"
    print(f"end to end (measured, not claimed): {json.dumps(E2E)}", flush=True)
    print(f"decode tick kernel launches (one pure decode tick under the profiler): grok-1 "
          f"{E2E['grok decode tick kernel launches, reconfig_every=0']} (reconfiguration off), "
          f"{E2E['grok decode tick kernel launches, reconfig_every=4']} (on); one speculative "
          f"round (draft, verify) {E2E[spec_key]} (greedy); mamba2 "
          f"{E2E['mamba2 decode tick kernel launches']}", flush=True)
    print(f"tokens sha256: {json.dumps(TOKENS_SHA256)}", flush=True)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
