#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failed check:

1. backend: the report of ``python -m repro_torch.backend``, then the build of
   every kernel from ``src/repro_torch/kernels/*/csrc`` with ``nvcc`` (one per
   source, started together) and each library's ``ptxas`` register lines;
2. quantize kernels: each against its plain PyTorch version on the card, at
   the shapes of the connection path — the gradient of one llama3.2-1b
   decoder layer at its published widths (d_model 2048, 32 heads and 8 KV
   heads of 64, d_ff 8192: 60,821,504 float32) at blocks 256 and 64 — and at
   blocks 4, 128, 1024, a ragged tail, block 101 and an offset view, each
   byte- or bit-equal and on the route the wrapper must choose (vector for
   aligned powers of two, else scalar); then timed with CUDA events at
   blocks 256 and 64 beside the plain version and the bound of the card's
   memory rate, and each route through its C entry point, in turns, with
   its GB/s and share of the bound;
3. flash attention: the tensor-core kernel's ptxas registers and spills
   (0 spill bytes required) and its wgmma and TMA instructions in the built
   library (``cuobjdump -sass``: HGMMA and UTMALDG, both nonzero); then the
   kernel against its plain version at the serving path's prefill shape (q
   4 x 2048 x 32 x 64, k/v 4 x 2048 x 8 x 64, bf16, causal), a ragged
   length, a 1024 window, non-causal, float32, head dim 128, hymba's two
   GQA-5 shapes, and the shapes of this slice's served families:
   phi-3-vision's head dim 96 (q 4 x 2048 x 32 x 96, causal, bf16 and
   float32), qwen3-moe's GQA 64/4 at head dim 128, seamless's encoder
   (4 x 512 x 16 x 64, non-causal), decoder self-attention (4 x 2048) and
   cross attention (q 4 x 2048, k/v 4 x 512, non-causal), each within its
   stated tolerance; then timed, with TFLOP/s and the share of the card's
   bound, at llama's prefill shape (beside the plain version), hymba's two,
   a head dim of 128 and this slice's five bf16 shapes, each beside
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
4. connection path: two host agents negotiate a Select of two int8 wires
   (block 256, block 64), stream the layer's gradients as two batches, swap
   the wire under two-phase commit and stream them again. The quantize
   kernels' launch counters are set to 0 just before and read just after:
   2 launches of each kernel at each block, all on the vector route.
   The same run is then repeated under torch.profiler for the device's idle
   share;
5. WAN path: the same two batches, each flattened to one tensor on the card,
   through a ``WanLinkChunnel`` pair (block 256, MTU 4096, window 8) on a
   clean link: 2 launches of each quantize kernel, all on the vector route,
   the received tensors bit-equal to the plain round trip and the wire
   payload byte-equal to the plain encode; then the attention batch again
   over a link that drops 2% of frames (retransmits, no failed send, the
   same bits); then the chaos-regions scenario (``tests/torch_chaos_regions.py``)
   with the WAN links, the gateway and the tensor blob on the card: its
   acceptance predicates, one quantize launch per blob sent, one unpack
   launch per blob the gateway decoded, and no exception in any thread;
6. serving path: ``python -m repro_torch.launch.serve --arch llama3.2-1b
   --batch 4 --prompt-len 2048 --gen 32`` through its ``main``, at the full
   published config (16 layers, 1,235,814,400 float32 parameters drawn from
   a seed), with the flash kernel's counter set to 0 just before and read
   just after: one launch per layer of the prefill, none in decode. Then, on
   a model built again from the same seed: the prefill's logits against the
   same prefill with plain dense attention, decode step 1's logits against
   a prefill over the S + 1 tokens, warm timings, and a profile of prefill
   and decode;
7. SSM scan: the kernel against its plain version on the card at the
   hybrid serving path's prefill chunk (a, bx 4 x 256 x 3200 x 16 float32),
   its decode step (C = 1), a d_in of 300, a chunk that is a strided view of
   a longer sequence, two half chunks against one whole, and a = 1 against
   a float64 sum, each within 1e-5; then timed beside the plain version and
   the bound of the card's memory rate, its decode step beside
   ``torch.addcmul`` (the one PyTorch call of its function at C = 1) with
   the wrapper's host time a call. Then B4 redesigned, the serving route:
   the fused ``selective_scan`` against ``selective_scan_ref`` on the card,
   y and h_last compared with ``torch.equal``, at hymba's prefill (dt, x 4 x
   2048 x 3200, N 16, B and C bf16 column views of an x_proj output), a
   rank's channels on model 2 (d_in 1600, B and C float32), a decode step
   from a carried state and 300 steps; each timed beside the plain version
   and its bound (bytes, or float32 operations) with its expf count at
   MUFU.EX2's rate, the decode step's wrapper host time a call too;
8. hybrid serving path: ``python -m repro_torch.launch.serve --arch
   hymba-1.5b --batch 4 --prompt-len 2048 --gen 32`` through its ``main``, at
   the full published config (32 layers, d_model 1600, 25 heads and 5 KV
   heads of 64, 29 of them with a 1024 window; 1,663,080,000 float32
   parameters drawn from a seed), with the flash and SSM-scan kernels'
   counters set to 0 just before and read just after: one flash launch per
   layer of the prefill and none in decode, one ``selective_scan`` launch
   per layer of the prefill and per layer of each decode step (32 + 32 x
   32) and no ``ssm_scan_chunk``. Then the checks of phase 6, the plain side
   also scanning with the scan's plain version, warm timings and a profile;
8b. the other four families' serving paths, each as phase 6 through the
   launcher's ``main`` with 4 prompts of 2048 tokens and 32 greedy decode
   steps, the kernels' counters set to 0 just before and read just after:
   phi-3-vision-4.2b (vlm; 32 layers, 3,822,259,200 parameters, patches
   (4, 576, 3072) bf16 over the first 576 positions; 32 flash launches at
   head dim 96), qwen3-moe-235b-a22b (moe; its first 3 of 94 layers at the
   published widths, 8,708,976,640 parameters, the expert dispatch
   ``grouped``; 3 flash launches), seamless-m4t-medium (audio; 12 + 12
   layers, 978,972,672 parameters, frames (4, 512, 1024) bf16; 36 flash
   launches: encoder, decoder self and cross attention) and xlstm-125m
   (ssm; 12 layers, 123,558,192 parameters; no kernel), none in decode,
   the flash launches counted by shape by the wrapper. Then phase 6's checks (the prefill
   against ``xla_dense`` within a stated tolerance; decode step 1 against a
   longer prefill, but for qwen3-moe, whose decode drops tokens at a
   capacity of 1 an expert, as the reference does), qwen3-moe's share of
   (token, slot) expert ids on which the kernel and plain prefills agree,
   warm timings, a profile and the peak memory;
8c. serving on a mesh through the serve launcher's rank target
   ``repro_torch.serving.steps.serve_rank`` (``--world``): gloo ranks that
   share the card (NCCL refuses two ranks on one device), the parameters
   laid out by the reference's ``param_specs`` (this rank's float32 blocks,
   bf16 working copies gathered from them), the batch's rows dealt over
   ``data``, the caches by ``cache_shardings`` at a capacity of 2112, decode
   through the negotiated KV-partition chunnel: llama3.2-1b (16 layers) on
   (data 2, model 2) under ``auto`` (heads: 8 KV heads over 2) and then
   ``sequence``; hymba-1.5b (32 layers) on (data 1, model 2), ``auto``
   picking sequence (5 KV heads), its rings and SSM state gathered over
   ``model`` for each step; qwen3-moe-235b-a22b at 1 of 94 layers at the
   published widths on (data 2, model 2), prefill with the expert dispatch
   ``alltoall`` and then ``allgather`` (decode resolves both to
   ``grouped``, expert-parallel: each rank's bf16 banks hold its 64 of 128
   experts, checked, its peak printed beside the whole banks' 10.68 GiB);
   seamless-m4t-medium on (data 2, model 2); xlstm-125m at 4 of 12 layers
   on (data 1, model 2), its mLSTM by heads and its sLSTM by channels (its
   decode sums ``wo`` and gathers no state). Four prompts of 2048 tokens
   from the launcher's seed, 32
   greedy steps. Each rank's counters are set to 0 just before each run's
   prefill and read after it, after a check decode step on seeded tokens
   (from a copy of the prefill's cache) and after the greedy steps: one B3
   launch per attention layer in the prefill, none in decode; hymba's
   ``selective_scan`` 32 times a prefill and 32 times a step, its
   ``ssm_scan_chunk`` never. Checked against the one-rank
   port on the same batch and seed (a model built here): the check step's
   logits and, but for the moe family (whose mesh dispatch routes each
   rank's tokens at its own capacity), the prefill's last logits, within a
   stated tolerance; equal tokens across each model group; B3 against its
   plain version at every shape the ranks launched it at (their 2 rows a
   rank are another batch than phase 7's); for qwen3-moe each rank's
   dispatch output against ``dispatch_grouped`` on the same tokens at the
   same capacity (a wrong exchange fails it), and the share of (token,
   slot) expert ids routed as the one-rank prefill routes them, with the
   pairs each side drops. It prints each rank's prefill ms, decode
   ms/token, peak memory, bytes held and sent by ``op@axis`` (gloo through
   the host, not NCCL);
9. the n-way dequantize-sum kernel ``unpack_dequant_sum`` (not a TPU kernel:
   it computes the body of the reference's ``compressed_allgather_sum``)
   against its plain version on the card, bit-equal: at the gradient of
   phase 10 (n_blocks 1,501,224, block 256) with n = 2 and n = 4, at n = 1
   (the error feedback's dequantize), a ragged tail, block 64 and an offset
   view (the scalar route); then timed at n = 2 and 4 beside the plain
   version and the bound of the card's memory rate. Then, with
   ``quantize_pack``, checked and timed in the same way at the wire of a
   rank's own shard of phase 12 (b)'s gradient (192,161,792 floats, n = 2);
9b. AdamW's two kernels a leaf (not a TPU kernel: the reference leaves
    AdamW to XLA) at llama3.2-1b's 146 leaves at full width (1,235,814,400
    float32 parameters, float32 gradients, bfloat16 moments): one
    ``optim.adamw.update`` on the card (a ``sumsq`` and an ``adamw_step``
    launch a leaf, one ``norm_scale``, every leaf on the kernel route)
    bit-equal to the plain route leaf by leaf (p, m and v against
    ``g.mul_(scale)`` then ``_leaf_update`` at the card's scale), its norm
    within 1e-6 (relative) of ``global_norm``; then the whole update, the
    ``sumsq`` pass and the ``adamw_step`` pass timed beside their plain
    versions and their bounds by bytes (24, 4 and 20 a parameter);
10. training on one rank: ``python -m repro_torch.launch.train --arch
    llama3.2-1b --steps 8 --batch 8 --seq 128 --transport xla --ckpt <tmp>
    --ckpt-every 4`` through its ``main``, at the full published config (16
    layers, 1,235,814,400 float32 parameters from seed 0), every kernel
    counter set to 0 just before and read just after (no kernel runs on
    this path but AdamW's: one rank builds no transport chunnel); every
    loss finite.
    Then the step-4 checkpoint restored into a trainer built again, steps
    4-7 run again, their losses equal to the uninterrupted run's; one warm
    step profiled;
11. training on two ranks that share the card: two processes on cuda:0 in
    a ``gloo`` world (NCCL refuses two ranks on one device), a mesh of
    ``pod`` = 2, llama3.2-1b's published widths with depth cut to 2 layers
    (384,313,344 parameters, 11 reference leaves), global batch 8 x 128,
    the hosts offering [psum, compressed_int8]: 3 steps of psum, a 2PC
    reconfiguration to compressed_int8, 3 steps of it, save, restore and 1
    more step. Each rank's counters are set to 0 before each step and read
    after it: no quantize kernel in a psum step; in each compressed step 12
    ``quantize_pack`` and 12 ``unpack_dequant_sum`` launches (the flat
    gradient's, at n = 2, and one per reference leaf for the error
    feedback, at n = 1), all on the vector route at block 256. The
    parameters are bit-equal on both ranks after every step (an exchanged
    checksum), the first compressed step's all-gather-sum is bit-equal to
    its plain version on the same gathered codes, every loss is finite,
    and both processes exit 0 with no exception in any thread;
12. sharded training on four ranks that share the card (``gloo``), the same
    2-layer model and batch, the state laid out by the reference's sharding
    rules (``train.step.shardings_for``). (a) A mesh of (data 2, model 2),
    FSDP on, ``xla``, 3 steps, then a checkpoint: each rank holds its
    quarter of the parameter bytes (more by the leaves that do not split
    four ways), and the losses are within 1e-2 (relative) of a one-rank run of
    the same model on the same batches in this process. (b) A mesh of
    (pod 2, model 2): (a)'s checkpoint restored onto it (the gathered
    leaves equal the saved ones, bit for bit), the hosts offering [psum,
    compressed_int8]: 2 psum steps, a 2PC switch, 2 compressed steps. The
    parameters are bit-equal across ``pod`` after every step (checksums of
    the blocks of the two ranks that differ only in ``pod``), and each
    compressed step launches 12 ``quantize_pack`` and 12
    ``unpack_dequant_sum`` on each rank, all vector b256: each rank reduces
    its own shard of the gradient (``train.gradshard``; every leaf is own
    at these widths, so none is gathered over ``model``), 192,161,792
    floats, 750,632 blocks on the wire: of its launches, one of each (the
    wire's) is at that size, counted by the wrappers' ``size_launches``,
    the rest at the residuals' leaf blocks. Each step's bytes equal
    ``analysis.roofline``'s, with no ``gather_grad`` or ``gather_state``;
    at the second psum and the second compressed step the transport's
    output and new residual blocks are bit-equal to the rank's slices of
    the whole-tree path (every leaf gathered, the transport on the logical
    flat vector, kernels on both sides; ``gradshard.whole_tree``, run after
    the step's counters are read). (c) A mesh of (pod 2, data 2), FSDP on,
    ``psum``, 1 step from the seed: the moments on their ZeRO-1 blocks
    (the FSDP dim split further over ``pod``), some of them narrowed out of
    the parameter's block on its second dim, which AdamW's kernels take as
    rows of one stride; the losses within 1e-2 of the one-rank run, the
    bytes ``analysis.roofline``'s, the parameters bit-equal across ``pod``.
    It prints ms/step, the bytes each rank sent per step by axis, the
    check's seconds and peak memory, and each rank's peak memory outside
    the checks;
6b. analysis (after phase 6): llama3.2-1b's decode_32k cell priced by the
    dry run on the meta device for the 16x16 mesh (``repro_torch.launch.dryrun
    .lower_cell``, the reference's one-cell test), its record's keys and
    ``fits_16GB`` checked; FlopCounterMode's count of phase 6's prefill (4 x
    2048, full width, ``xla_chunked`` attention) on the card, within 15% of
    ``analysis.flops.fwd_flops_layerwise``; and the H100 roofline's compute
    and memory terms for that prefill beside phase 6's warm prefill, with the
    share of the roofline reached. No kernel launches in it;
13. training the hybrid family on one rank: ``python -m
    repro_torch.launch.train --arch hymba-1.5b --steps 4 --batch 8 --seq 128
    --transport xla`` through its ``main``, at the full published config
    (1,663,080,000 parameters), every kernel counter set to 0 just before
    and read just after (none launches but AdamW's: training scans with the
    plain version and attends with ``xla_chunked``), every loss finite; ms/step
    and peak memory printed;
14. training the vlm, audio, ssm and moe families on one rank at their
    published widths, each through ``repro_torch.launch.train.main`` with
    ``--transport xla --steps 4``: phi-3-vision-4.2b (32 layers,
    3,822,259,200 parameters, batch 4 x 1024: its 576 patch positions need
    S > 576), seamless-m4t-medium (12 + 12 layers, 978,972,672; batch 8 x
    128, frames (8, 32, 1024)), xlstm-125m (12 layers, 123,558,192; 8 x
    128) and qwen3-moe-235b-a22b **reduced** to 1 of its 94 layers at the
    published widths (3,733,467,136; 8 x 128; ``grouped`` on one rank).
    Every kernel counter set to 0 just before and read just after (none
    launches but AdamW's: ``xla_chunked`` attention, the plain scans), every loss
    finite; first and warm ms/step, tokens/s and peak memory printed, and
    one warm step of the same trainer built again profiled (idle share).
    Before each, the card against the CPU: one model drawn on the card from
    the seed at 2 layers of the published widths (2 + 2 for seamless, 1
    for qwen3-moe), copied to the CPU, the first loss within 2e-3
    (relative) and the gradient within 4e-2 (relative L2) on the same
    batch;
15. the compressed transport on a new tree: xlstm-125m at its published
    config on two ranks that share the card (``pod`` = 2, gloo), global
    batch 8 x 128: 2 psum steps, a 2PC switch to compressed_int8, 2
    compressed steps. Each compressed step launches ``quantize_pack`` and
    ``unpack_dequant_sum`` 148 times on each rank (the flat gradient, and
    one per leaf of the reference's tree of 147 leaves: xlstm's layers an
    unstacked list), all on the vector route at block 256; no kernel in a
    psum step; the parameters bit-equal across the ranks after every step;
16. the moe dispatches' backward on CUDA tensors: four gloo ranks sharing
    the card on (data 2, model 2), FSDP, qwen3-moe-235b-a22b at its smoke
    widths (the published widths gathered whole on four ranks of one card
    do not fit), global batch 8 x 64: 2 steps with ``alltoall``, then 2
    with ``allgather``, each from the same parameters; then the same runs
    on the CPU in the same processes. Each rank's own loss of each step
    bit-equal across its ``model`` group, the card's losses within 1e-2
    (relative) of the CPU's, the backward's own collectives present
    (``grad_all_to_all@model``, ``grad_reduce_scatter@model``), no kernel
    launch but AdamW's;
17. the encoder-decoder on the split: seamless-m4t-medium at its published
    widths, 2 + 2 layers, on four gloo ranks (data 2, model 2), 2 steps of
    4 x 128, its losses within 1e-2 of one rank's on the card, each step's
    bytes equal to ``analysis.roofline``'s count;
18. xLSTM on the split: xlstm-125m at its published widths, 2 of 12 layers
    (one mLSTM, one sLSTM), on two gloo ranks (data 1, model 2), 2 steps
    of 2 x 128: the mLSTM by heads, the sLSTM by channels and its MLP by
    width; the losses within 1e-2 of one rank's on the card, each step's
    bytes equal to ``analysis.roofline``'s count (``sum_partials``,
    ``gather_channels``, the "f" conjugates' ``grad_all_reduce``, no
    ``gather_param@model``), no kernel launch but AdamW's.

Every training phase (10-18) counts AdamW's kernels too: each optimizer step
on the card launches a ``sumsq`` and an ``adamw_step`` a leaf of the rank's
optimizer tree and one ``norm_scale`` (2 x leaves + 1), with every leaf on
the kernel route (``kernels.adamw.route_leaves``); ``optim.adamw.update`` is
wrapped to count its calls and leaves, and any other count fails the phase.
Phase 12 prints each rank's AdamW count a step and how its leaves lie under
ZeRO-1 (no split, or the ``pod`` block narrowed on a dim: contiguous, or
rows of one stride).

Each phase prints its seconds (``phase <name>: ... s``) and a line before
the kernels' lists them all. The line before the last is one JSON object
of the kernels' numbers; the last is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from collections import Counter
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
GRAD_SCALE = 1e-3
D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF = 2048, 32, 8, 64, 8192
#: one decoder layer's parameters, as (name, shape), attention batch then MLP
ATTN = [("q", (N_HEADS * HEAD_DIM, D_MODEL)), ("k", (N_KV * HEAD_DIM, D_MODEL)),
        ("v", (N_KV * HEAD_DIM, D_MODEL)), ("o", (D_MODEL, N_HEADS * HEAD_DIM)),
        ("attn_norm", (D_MODEL,))]
MLP = [("gate", (D_FF, D_MODEL)), ("up", (D_FF, D_MODEL)), ("down", (D_MODEL, D_FF)),
       ("mlp_norm", (D_MODEL,))]
LAYER_NUMEL = 60_821_504
BLOCKS = (256, 64)
REPLACES = {"quantize_pack": "src/repro/kernels/quantize/quantize.py:46",
            "unpack_dequant": "src/repro/kernels/quantize/quantize.py:73"}
SOURCE = "src/repro_torch/kernels/quantize/csrc/quantize.cu"
#: elementwise operations per element: abs, max, divide, round, 2 clamps, and
#: the scale's multiply per row; unpack: convert and multiply
OPS_PER_ELEM = {"quantize_pack": 6, "unpack_dequant": 2}
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:109"
SSM_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SSM_REPLACES = "src/repro/kernels/ssm_scan/ssm_scan.py:57"
#: hymba-1.5b's attention (25 query heads over 5 KV heads, window 1024) and
#: SSM scan widths (d_in = 2 x 1600, state 16), and the prefill's scan chunk
HYMBA_HEADS, HYMBA_KV, HYMBA_WINDOW = 25, 5, 1024
SSM_D_IN, SSM_N, SSM_CHUNK = 3200, 16, 256
#: B4's case at a rank's channels of hymba split over model 2 (d_in / 2)
SSM_LOCAL = "hymba local channels d_in/2 (model 2)"
#: scan kernel against its plain version: the reference's own atol = rtol
#: (tests/test_kernels.py::TestSsmScanKernel)
SSM_TOL = 1e-5
#: the serving path: four prompts of 2048 tokens, then 32 decode steps
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
#: kernel against plain version. bfloat16 (the tensor-core route): atol = rtol
#: = 1e-2, as torch.testing.assert_close takes them; the route rounds p to
#: bf16 for P.V, which moves outputs by up to one bf16 step at their
#: magnitude (0.0156 at |o| of 2 to 4). float32 (the SIMT route): max abs
#: error 1e-5, summation order. Both tighter than the reference's own 2e-2 /
#: 2e-3 (tests/test_kernels.py)
FLASH_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
#: the later slices' prefill attention shapes, each checked and timed:
#: (label, (batch, Sq, Skv or None for Sq, hd, (H, KH), keywords), dtypes
#: checked). phi-3-vision-4.2b: 32 heads of 96, MHA, causal; qwen3-moe-235b-a22b:
#: 64 heads over 4 KV heads of 128, causal; seamless-m4t-medium: 16 heads of
#: 64, its encoder over S / 4 frames and its cross attention non-causal; and
#: llama3.2-1b split over model 2 on (data 2, model 2): a rank's 2 rows and
#: its 16 query heads over its 4 KV heads (the compute split, heads mode);
#: then qwen3-moe's and seamless's at a rank's heads on (data 2, model 2)
#: (their families split too): a rank's 2 rows, half the heads
NEW_FLASH_CASES = [
    ("phi-3-vision hd96", (SERVE_BATCH, SERVE_PROMPT, None, 96, (32, 32), dict(causal=True)),
     ("bfloat16", "float32")),
    ("qwen3-moe GQA 64/4 hd128", (SERVE_BATCH, SERVE_PROMPT, None, 128, (64, 4),
                                  dict(causal=True)), ("bfloat16",)),
    ("seamless encoder", (SERVE_BATCH, SERVE_PROMPT // 4, None, 64, (16, 16),
                          dict(causal=False)), ("bfloat16",)),
    ("seamless decoder self", (SERVE_BATCH, SERVE_PROMPT, None, 64, (16, 16),
                               dict(causal=True)), ("bfloat16",)),
    ("seamless cross", (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT // 4, 64, (16, 16),
                        dict(causal=False)), ("bfloat16",)),
    ("llama local heads 16/4 (model 2)", (SERVE_BATCH // 2, SERVE_PROMPT, None, HEAD_DIM,
                                          (N_HEADS // 2, N_KV // 2), dict(causal=True)),
     ("bfloat16",)),
    ("qwen3-moe local heads 32/2 (model 2)", (SERVE_BATCH // 2, SERVE_PROMPT, None, 128,
                                              (32, 2), dict(causal=True)), ("bfloat16",)),
    ("seamless local encoder 8/8 (model 2)", (SERVE_BATCH // 2, SERVE_PROMPT // 4, None, 64,
                                              (8, 8), dict(causal=False)), ("bfloat16",)),
    ("seamless local decoder self 8/8 (model 2)", (SERVE_BATCH // 2, SERVE_PROMPT, None, 64,
                                                   (8, 8), dict(causal=True)), ("bfloat16",)),
    ("seamless local cross 8/8 (model 2)", (SERVE_BATCH // 2, SERVE_PROMPT, SERVE_PROMPT // 4,
                                            64, (8, 8), dict(causal=False)), ("bfloat16",)),
]
#: the mangled name's stem of the tensor-core kernel, in ptxas's log
FLASH_TC_KERNEL = "flash_attention_tc_kernel"
#: serving checks, max abs error on logits of magnitude up to about 5: the
#: kernel's and the dense path's bf16 attention outputs differ by a rounding
#: step, and 16 layers of bf16 residual stream carry it to the logits
LOGITS_TOL = 0.1
#: hymba's serving checks, max abs error on logits of the same magnitude: the
#: scan kernel agrees with its plain version bit for bit, so the difference
#: is again the flash kernel's bf16 rounding step against the dense path,
#: now carried by 32 layers of bf16 residual (twice llama's 16), through
#: each layer's two normalised branches
HYMBA_LOGITS_TOL = 0.15
#: this slice's serve phases: (arch, parameters at the depth served, max abs
#: error on prefill logits of the kernel path against xla_dense and of decode
#: step 1 against a longer prefill, layers or None for the published depth).
#: phi-3-vision: 32 layers of bf16 residual, as hymba's 0.15; qwen3-moe: 3
#: layers (one card's memory: 8,708,976,640 parameters, about 52 GB as
#: float32 masters and bf16 copies), llama's 0.1; seamless: 12 encoder and
#: 12 decoder layers, three attentions each, 0.15; xlstm: 12 layers, no
#: attention and no kernel, llama's 0.1
NEW_SERVE = [("phi-3-vision-4.2b", 3_822_259_200, 0.15, None),
             ("qwen3-moe-235b-a22b", 8_708_976_640, 0.1, 3),
             ("seamless-m4t-medium", 978_972_672, 0.15, None),
             ("xlstm-125m", 123_558_192, 0.1, None)]
#: the WAN phase: the chunnel's own MTU, its window, block 256, and the loss
#: of the lossy rerun's link
WAN_BLOCK, WAN_MTU, WAN_WINDOW, WAN_LOSS = 256, 4096, 8, 0.02
#: the n-way dequantize-sum (not a TPU kernel: the body of the reference's
#: compressed all-gather-sum, src/repro/comm/collectives.py:147-150)
SUM_REPLACES = "src/repro/comm/collectives.py:147 (not a TPU kernel)"
#: AdamW's two passes a leaf (not a TPU kernel: the reference leaves its
#: norm, clip and update to XLA)
ADAMW_SOURCE = "src/repro_torch/kernels/adamw/csrc/adamw.cu"
ADAMW_REPLACES = "src/repro/optim/adamw.py:40 (not a TPU kernel)"
ADAMW_KERNELS = ("sumsq", "norm_scale", "adamw_step")
#: the AdamW phase: llama3.2-1b's leaves at full width (the one-rank
#: training path's tree), the card's norm within this of ``global_norm``
ADAMW_ARCH, ADAMW_NORM_RTOL = "llama3.2-1b", 1e-6
#: leaves of each ``optim.adamw.update`` call since the counters were last
#: set to 0 (``_tap_adamw``)
ADAMW_CALLS: list = []
#: the training phases: llama3.2-1b at full width on one rank; its widths
#: with 2 of 16 layers on two ranks that share the card
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CKPT_EVERY = 8, 8, 128, 4
TRAIN2_LAYERS, TRAIN2_PARAMS, TRAIN2_LEAVES = 2, 384_313_344, 11
#: the two-rank phase's gradient at block 256
SUM_N_BLOCKS = TRAIN2_PARAMS // 256
#: restart continuity: steps 4-7 after restoring the step-4 checkpoint
#: against the uninterrupted run's, relative. The state restores bit for
#: bit and the data is deterministic, so only a run-to-run difference of a
#: library's reduction order could move a loss; none is expected
RESTART_RTOL = 1e-6
#: the sharded phase: four ranks, (a) on (data 2, model 2), (b) on (pod 2,
#: model 2), (c) on (pod 2, data 2) with ZeRO-1 moments; its losses against
#: one rank's, relative (the order of the sums differs: bf16 products summed
#: over other blocks)
SHARDED_WORLD, SHARDED_A_STEPS, SHARDED_B_STEPS, SHARDED_RTOL = 4, 3, 2, 1e-2
SHARDED_C_STEPS = 1
#: a rank's own shard of that gradient on (pod 2, model 2): its floats (the
#: 10,240 replicated ones included) and the wire's blocks of 256
RANK_NUMEL, RANK_N_BLOCKS = 192_161_792, 750_632
#: the hybrid phase: hymba-1.5b at its published config on one rank
HYMBA_TRAIN_STEPS, HYMBA_PARAMS = 4, 1_663_080_000
#: phase 14: the vlm, audio, ssm and moe families trained on one rank at
#: their published widths through the launcher: (arch, the launcher's argv
#: beyond --arch/--steps/--transport, parameters). phi-3-vision's 576 patch
#: positions need S > 576; qwen3-moe at 1 of its 94 layers (one card)
FAMILY_TRAIN_STEPS = 4
FAMILY_TRAIN = [
    ("phi-3-vision-4.2b", ["--batch", "4", "--seq", "1024"], 3_822_259_200),
    ("seamless-m4t-medium", ["--batch", "8", "--seq", "128"], 978_972_672),
    ("xlstm-125m", ["--batch", "8", "--seq", "128"], 123_558_192),
    ("qwen3-moe-235b-a22b", ["--batch", "8", "--seq", "128", "--layers", "1"], 3_733_467_136),
]
#: phase 14's card-against-CPU check: (layers of the published widths, (rows,
#: positions)); 2 layers (2 + 2 for seamless), qwen3-moe's 1 (3.73 B
#: parameters: the CPU side holds them, their gradients and the bf16 banks);
#: phi-3-vision's positions past its 576 patches, a multiple of the loss chunk
FAMILY_CHECK = {"phi-3-vision-4.2b": (2, (1, 1024)), "seamless-m4t-medium": (2, (2, 128)),
                "xlstm-125m": (2, (2, 128)), "qwen3-moe-235b-a22b": (1, (2, 64))}
#: the first loss, relative, and the gradient's relative L2 distance, card
#: against CPU: each side multiplies in bfloat16 with its own accumulation
#: order (cuBLAS against oneDNN); the parity tests' 4e-2 of each leaf holds
#: each side's own bf16 rounding against float32 products
FAMILY_LOSS_RTOL, FAMILY_GRAD_L2 = 2e-3, 4e-2
#: phase 15: xlstm-125m at its published config on two ranks (pod 2): its
#: parameters and reference leaves (an unstacked list of 12 unlike layers)
XLSTM_ARCH, XLSTM_PARAMS, XLSTM_LEAVES = "xlstm-125m", 123_558_192, 147
XLSTM_PSUM_STEPS = XLSTM_COMPRESSED_STEPS = 2
#: phase 16: qwen3-moe's smoke widths on (data 2, model 2), 2 steps with each
#: mesh dispatch; the card's reported losses against the CPU's, relative
#: (bf16 products on either side, two AdamW steps)
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_MESH_DISPATCHES = ("alltoall", "allgather")
MOE_MESH_STEPS, MOE_MESH_BATCH, MOE_MESH_SEQ, MOE_MESH_RTOL = 2, 8, 64, 1e-2
#: phase 17: seamless-m4t-medium at its published widths, 2 + 2 of
#: its 12 + 12 layers, on (data 2, model 2) (FSDP over data), 2 steps of a
#: global batch of 4 x 128 (a source of 32 frames: both residuals split);
#: its losses against one rank's on the card within SHARDED_RTOL
AUDIO_ARCH = "seamless-m4t-medium"
AUDIO_MESH_LAYERS, AUDIO_MESH_STEPS, AUDIO_MESH_BATCH, AUDIO_MESH_SEQ = 2, 2, 4, 128
#: phase 18: xlstm-125m at its published widths, 2 of its 12 layers (one
#: mLSTM, one sLSTM), on (data 1, model 2): its mLSTM by heads, its sLSTM by
#: channels, its MLP by width; 2 steps of a global batch of 2 x 128; its
#: losses against one rank's on the card within SHARDED_RTOL
XLSTM_MESH_LAYERS, XLSTM_MESH_STEPS, XLSTM_MESH_BATCH, XLSTM_MESH_SEQ = 2, 2, 2, 128
#: serving on a mesh of gloo ranks that share the card: four prompts of 2048
#: tokens into a cache of 2112 positions (2048 + 32 rounded up to a multiple
#: of 64, a decode ShapeConfig's), 32 greedy steps. Each case: (arch, layers
#: or None for the published depth, (data, model), runs as (kv partition,
#: moe dispatch or None), max abs gap of the first decode step's logits,
#: and but for the moe family the prefill's, against the one-rank port's).
#: The gap: the sequence branch's flash-decode takes P·V in bfloat16 before
#: it normalises, the local decode after, a bfloat16 step apart; prefill on
#: each rank's 2 rows may round its GEMMs otherwise than on 4; so llama's
#: 0.1 and hymba's 0.15 of the one-rank checks, and llama's 0.1 for
#: qwen3-moe's one layer (its decode routes the global batch's 4 tokens, as
#: the one-rank port's does). seamless: its 12 encoder and 12
#: decoder layers, three attentions each, split by heads, its one-rank
#: serve check's 0.15. xlstm: its mLSTM by heads, its sLSTM by channels
#: and its MLP by width, the vocabulary, the row products' float32 partials
#: summed once: llama's 0.1; at 4 of its 12 layers (its sLSTM's loop over
#: the prompt runs on both ranks of the one card, on half the channels),
#: and its prefill's and first four greedy tokens must equal the one-rank
#: port's. qwen3-moe's bf16 banks hold each rank's 64 of 128 experts
SHARDED_SERVE = [
    ("llama3.2-1b", None, (2, 2), [("auto", None), ("sequence", None)], 0.1),
    ("hymba-1.5b", None, (1, 2), [("auto", None)], 0.15),
    ("qwen3-moe-235b-a22b", 1, (2, 2), [("auto", "alltoall"), ("auto", "allgather")], 0.1),
    ("seamless-m4t-medium", None, (2, 2), [("auto", None)], 0.15),
    ("xlstm-125m", 4, (1, 2), [("auto", None)], 0.1),
]
#: the greedy tokens (the prefill's and the first decode steps') that a
#: sharded xlstm serve must share with the one-rank port
SHARDED_EQUAL_TOKENS = 5
SHARDED_CAPACITY = 2112
#: the share of (token, slot) expert ids of the sharded prefill that must
#: equal the one-rank prefill's (a near-tie in the top-k may flip under the
#: rows' other GEMM rounding)
SHARDED_ROUTE_SHARE = 0.99
#: a mesh dispatch's output against ``dispatch_grouped`` on the same tokens
#: at the same capacity, atol = rtol as torch.testing.assert_close takes
#: them: the bf16 expert products run in other GEMM shapes ((E/n, n*C, D)
#: against (E, C, D)), and allgather sums the ranks' partial outputs in
#: another order, each a bf16 rounding step at the outputs' magnitude; a
#: token sent to another expert or rank moves its row by the whole output
MOE_DISPATCH_TOL = 1e-2
#: exceptions raised in any thread (the WAN receiver, the gateway's loop)
THREAD_ERRORS: list = []


def _record_thread_error(args) -> None:
    THREAD_ERRORS.append(f"{args.thread.name if args.thread else '?'}: "
                         f"{args.exc_type.__name__}: {args.exc_value}")
    traceback.print_exception(args.exc_type, args.exc_value, args.exc_traceback)


def hw(key: str) -> float:
    """The H100 SXM's figure ``key`` from the port's table
    (``repro_torch.launch.mesh.HW``, NVIDIA's data sheet): ``hbm_bw`` the
    device-memory rate in bytes/s, ``peak_flops_f32`` the float32 rate
    outside the tensor cores and ``peak_flops_bf16`` the dense bf16
    tensor-core peak, in operations/s."""
    from repro_torch.launch.mesh import HW

    return HW[key]


#: seconds of each phase of ``main``, in order
PHASE_S: dict = {}


def _clock(label: str, phase, *args):
    """``phase(*args)``, its seconds kept under ``label`` and printed."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_S[label] = time.perf_counter() - t0
    print(f"phase {label}: {PHASE_S[label]:.1f} s")
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(torch, fn, reps: int = 21, group: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``group`` back-to-back calls,
    from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(group):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / group)
    return statistics.median(times)


def within_half_scale(torch, x, y, s):
    """|x - y| <= s/2 + 2 ulp per element, s the row's scale: rint's half
    step, plus the rounding of x / s (at most 1 ulp of x once scaled back)
    and of q * s (half an ulp of y)."""
    mag = torch.maximum(x.abs(), y.abs())
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return (x - y).abs() <= s[:, None] / 2 + 2 * ulp


def layer_grads(torch, spec, gen):
    return [torch.randn(shape, generator=gen, device="cuda") * GRAD_SCALE
            for _, shape in spec]


def phase_backend(torch, backend) -> str:
    rep = backend.report()
    print("backend:", json.dumps(rep))
    check(rep["capability"] == [9, 0], f"capability {rep['capability']}, want [9, 0]")
    t0 = time.monotonic()
    secs = backend.build_kernels()
    print(f"build: {json.dumps(secs)} total {time.monotonic() - t0:.3f}s")
    for name in secs:
        log = backend.lib_path(name).with_suffix(".log")
        lines = [ln for ln in log.read_text().splitlines() if "Used" in ln or "spill" in ln]
        print(f"ptxas {name}:", " | ".join(ln.strip() for ln in lines))
    return rep["nvidia_smi"]


def phase_kernels(torch) -> dict:
    from repro_torch.kernels.quantize.quantize import (
        launch, packed_nbytes, quantize_pack, quantize_pack_ref, unpack_dequant,
        unpack_dequant_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flat = torch.cat([g.reshape(-1) for g in layer_grads(torch, ATTN + MLP, gen)])
    check(flat.numel() == LAYER_NUMEL, f"layer payload {flat.numel()} f32")
    ragged = LAYER_NUMEL - 77
    n_attn = sum(math.prod(shape) for _, shape in ATTN)
    # (label, block, floats, bytes the packed buffer is moved off a 16-byte
    # boundary before unpacking): the whole layer (timed at the main path's
    # blocks) and the main path's two batches at both of its blocks, the
    # layer at the vector route's smallest, a middle and its largest block,
    # a ragged tail padded as encode_batch pads it, a block that puts the
    # scales at an odd byte, and an offset view (floats one float and a
    # packed buffer one byte past a 16-byte boundary), which takes the scalar
    # route
    cases = [(label, block, x, 0) for block in BLOCKS for label, x in
             (("layer", flat), ("attention batch", flat[:n_attn]), ("mlp batch", flat[n_attn:]))]
    cases += [("layer", block, flat, 0) for block in (4, 128, 1024)]
    cases += [("ragged", 256, torch.nn.functional.pad(flat[:ragged], (0, (-ragged) % 256)), 0),
              ("odd-block", 101, flat[:101 * 9999].clone(), 0),
              ("offset view", 64, flat[1:1 + 64 * 9999], 1)]
    results = {}
    for label, block, x, shift in cases:
        x2d = x.view(-1, block)
        n_blocks = x2d.shape[0]
        want = "scalar" if label in ("odd-block", "offset view") else "vector"
        check((x2d.data_ptr() % 16 == 4) == (label == "offset view"),
              f"{label}: floats at data_ptr % 16 = {x2d.data_ptr() % 16}")
        n0 = quantize_pack.route_launches.copy()
        packed = quantize_pack(x2d)
        packed_ref = quantize_pack_ref(x2d)
        torch.cuda.synchronize()
        check(quantize_pack.route_launches - n0 == {(want, block): 1},
              f"quantize_pack at {label} b{block}: want one {want} launch")
        check(packed.shape == (packed_nbytes(n_blocks, block),), "packed shape")
        q_err = (packed.int() - packed_ref.int()).abs().max().item()
        check(torch.equal(packed, packed_ref),
              f"quantize_pack != plain at {label} b{block}: max byte diff {q_err}")
        q_route = want
        src = packed
        if shift:
            src = torch.empty(packed.numel() + shift, dtype=torch.uint8, device="cuda")[shift:]
            src.copy_(packed)
        check(src.data_ptr() % 16 == shift, f"{label}: packed at data_ptr % 16 = "
              f"{src.data_ptr() % 16}, want {shift}")
        n0 = unpack_dequant.route_launches.copy()
        y = unpack_dequant(src, n_blocks, block)
        y_ref = unpack_dequant_ref(packed, n_blocks, block)
        torch.cuda.synchronize()
        check(unpack_dequant.route_launches - n0 == {(want, block): 1},
              f"unpack_dequant at {label} b{block}: want one {want} launch")
        d_err = (y - y_ref).abs().max().item()
        check(torch.equal(y.view(torch.int32), y_ref.view(torch.int32)),
              f"unpack_dequant != plain at {label} b{block}: max abs diff {d_err}")
        s = packed[n_blocks * block:].clone().view(torch.float32)
        check(bool(within_half_scale(torch, x2d, y.view(n_blocks, block), s).all()),
              f"error above scale/2 at {label}")
        print(f"kernel check {label} b{block}: n_blocks {n_blocks}, data_ptr % 16 of floats "
              f"{x2d.data_ptr() % 16} and packed {src.data_ptr() % 16}, routes {q_route} and "
              f"{want}: byte-equal, bit-equal")
        if label != "layer" or block not in BLOCKS:
            continue
        n = x2d.numel()
        io = {"quantize_pack": 4 * n + packed.numel(), "unpack_dequant": packed.numel() + 4 * n}
        y_out = torch.empty_like(y)
        args = {"quantize_pack": (x2d, torch.empty_like(packed)), "unpack_dequant": (packed, y_out)}
        times = {
            "quantize_pack": (time_ms(torch, lambda: quantize_pack(x2d)),
                              time_ms(torch, lambda: quantize_pack_ref(x2d))),
            "unpack_dequant": (time_ms(torch, lambda: unpack_dequant(packed, n_blocks, block)),
                               time_ms(torch, lambda: unpack_dequant_ref(packed, n_blocks, block))),
        }
        for name, (ms, plain_ms) in times.items():
            # both routes through their C entry points, in turns: vector,
            # scalar, scalar, vector; the lower of each route's two times
            route_ms = {"vector": [], "scalar": []}
            for which in ("vector", "scalar", "scalar", "vector"):
                route_ms[which].append(time_ms(
                    torch, lambda: launch(name, which, *args[name], n_blocks, block)))
            route_ms = {which: min(t) for which, t in route_ms.items()}
            bytes_ms = io[name] / hw("hbm_bw") * 1e3
            ops_ms = OPS_PER_ELEM[name] * n / hw("peak_flops_f32") * 1e3
            bound = max(bytes_ms, ops_ms)
            results[(name, block)] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": io[name], "max_abs_err": q_err if name == "quantize_pack" else d_err,
                "routes": {which: {"ms": t, "share_of_bound": bound / t}
                           for which, t in route_ms.items()}}
            print(f"time {name} b{block}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                  f"bound {bound:.4f} ms, {io[name]} bytes, "
                  f"{io[name] / ms / 1e6:.1f} GB/s, {bound / ms:.1%} of the bound)")
            for which, t in route_ms.items():
                print(f"time {name} b{block} {which} route: {t:.4f} ms, "
                      f"{io[name] / t / 1e6:.1f} GB/s, {bound / t:.1%} of the bound")
    return results


def phase_flash(torch) -> dict:
    """The flash-attention kernel against its plain version, then timed at
    the serving paths' prefill shapes."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def qkv(B, S, hd, dtype, heads=(N_HEADS, N_KV), skv=None):
        H, KH = heads
        skv = skv or S
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((B, S, H, hd), (B, skv, KH, hd), (B, skv, KH, hd))]

    bf16, f32 = torch.bfloat16, torch.float32
    B, S, llama, hymba = SERVE_BATCH, SERVE_PROMPT, (N_HEADS, N_KV), (HYMBA_HEADS, HYMBA_KV)
    # (label, (B, S, hd, dtype), (H, KH), Skv or None for S, keywords)
    cases = [("prefill", (B, S, HEAD_DIM, bf16), llama, None, dict(causal=True)),
             ("ragged S=2000", (B, 2000, HEAD_DIM, bf16), llama, None, dict(causal=True)),
             ("window 1024", (B, S, HEAD_DIM, bf16), llama, None,
              dict(causal=True, window=1024)),
             ("non-causal", (B, S, HEAD_DIM, bf16), llama, None, dict(causal=False)),
             ("float32", (B, S, HEAD_DIM, f32), llama, None, dict(causal=True)),
             ("hd128", (1, 1024, 128, bf16), llama, None, dict(causal=True)),
             ("hymba GQA 5, window 1024", (B, S, HEAD_DIM, bf16), hymba, None,
              dict(causal=True, window=HYMBA_WINDOW)),
             ("hymba GQA 5, global", (B, S, HEAD_DIM, bf16), hymba, None, dict(causal=True))]
    cases += [(label if dt == "bfloat16" else f"{label} {dt}", (b, sq, hd, getattr(torch, dt)),
               heads, skv, kw)
              for label, (b, sq, skv, hd, heads, kw), dtypes in NEW_FLASH_CASES for dt in dtypes]
    errs, checked = {}, set()
    for label, (B_, S_, hd, dtype), heads, skv, kw in cases:
        q, k, v = qkv(B_, S_, hd, dtype, heads, skv)
        errs[label] = _flash_check(torch, label, q, k, v, kw)
        if dtype == bf16:
            checked.add((tuple(q.shape), tuple(k.shape), kw.get("causal", True),
                         kw.get("window")))
        del q, k, v

    q, k, v = qkv(B, S, HEAD_DIM, bf16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = (sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2).float()
               - flash_attention_ref(q, k, v).float()).abs().max().item()
    ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v, causal=True), reps=5, group=2)
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "max_abs_err": errs["prefill"], **flash_bound(q, k, None), "cases": {},
           "checked": checked}
    print(f"time flash_attention prefill: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, sdpa vs plain max abs err {lib_err}, "
          f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}: {res['flops']} flops at "
          f"{hw('peak_flops_bf16') / 1e12:.0f} TFLOP/s, {res['bytes']} bytes; "
          f"{res['flops'] / ms / 1e9:.1f} TFLOP/s, {res['bound_ms'] / ms:.1%} of the bound)")

    # hymba's two prefill shapes (29 layers with the window, 3 without), head
    # dim 128 (mistral-nemo's width) at llama's batch, length and heads, then
    # the later slices': phi-3-vision's hd 96, qwen3-moe's GQA 64/4 at hd 128,
    # seamless's encoder, decoder self and cross attention, and a llama rank's
    # heads under the compute split over model 2
    timed = [("hymba window 1024", B, (HYMBA_HEADS, HYMBA_KV), HEAD_DIM, S, None, HYMBA_WINDOW,
              True),
             ("hymba global", B, (HYMBA_HEADS, HYMBA_KV), HEAD_DIM, S, None, None, True),
             ("hd128", B, (N_HEADS, N_KV), 128, S, None, None, True)]
    timed += [(label, b, heads, hd, sq, skv, None, kw["causal"])
              for label, (b, sq, skv, hd, heads, kw), _ in NEW_FLASH_CASES]
    for label, b_, heads, hd, sq, skv, window, causal in timed:
        q, k, v = qkv(b_, sq, hd, bf16, heads, skv)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=causal, window=window))
        plain_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v, causal=causal,
                                                              window=window), reps=5, group=2)
        # sdpa's boolean mask keeps True: causal and inside the window
        pos = torch.arange(sq, device="cuda")
        mask = None if window is None else (
            (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window))
        lib = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                          is_causal=causal and window is None, enable_gqa=True))
        b = flash_bound(q, k, window, causal)
        entry = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib, **b,
                 "max_abs_err": errs.get(label), "q": list(q.shape), "kv": list(k.shape),
                 "causal": causal}
        if label in {c[0] for c in NEW_FLASH_CASES}:
            res["cases"][label] = entry
        else:
            res[label] = entry
        print(f"time flash_attention {label}: q {tuple(q.shape)} k {tuple(k.shape)} bf16 "
              f"{'causal' if causal else 'non-causal'}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"sdpa {lib:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}: "
              f"{b['flops']} flops, {b['bytes']} bytes; {b['flops'] / ms / 1e9:.1f} TFLOP/s, "
              f"{b['bound_ms'] / ms:.1%} of the bound)")
        del q, k, v, qt, kt, vt
    return res


def _flash_check(torch, label, q, k, v, kw) -> float:
    """B3's wrapper against its plain version on q, k, v: within
    ``FLASH_TOL`` of the dtype, or the run fails. Returns the max abs error."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_ref)

    out = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == q.dtype,
          f"flash {label}: {out.dtype} {out.shape}")
    err = (out.float() - want.float()).abs().max().item()
    tol = FLASH_TOL[str(q.dtype).split(".")[1]]
    if q.dtype == torch.bfloat16:
        form = f"atol = rtol = {tol}"
        try:
            torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
            ok = True
        except AssertionError:
            ok = False
    else:
        form, ok = f"max abs err <= {tol}", err <= tol
    print(f"kernel check flash_attention {label}: q {tuple(q.shape)} k {tuple(k.shape)} "
          f"{q.dtype} {kw} max abs err {err} ({form})")
    check(ok, f"flash_attention {label}: max abs err {err}, outside {form}")
    return err


def flash_bound(q, k, window, causal: bool = True) -> dict:
    """The least time of attention over q and k's shapes (causal top-left
    aligned, or not): 4 flops per kept (q, k) pair and head dim (QK^T and
    PV) at the bf16 tensor-core peak, against q, k, v read and o written
    once at the memory rate."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]

    def kept(i):  # keys row i keeps
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window else 0
        return max(0, hi - lo + 1)

    flops = 4 * B * H * hd * sum(kept(i) for i in range(Sq))
    io = 2 * (2 * q.numel() + 2 * k.numel())
    ops_ms, bytes_ms = flops / hw("peak_flops_bf16") * 1e3, io / hw("hbm_bw") * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": io}


def flash_build_report(backend) -> None:
    """The tensor-core kernel's registers and spills from ptxas's log, and
    the count of wgmma (HGMMA) and TMA-load (UTMALDG) instructions in the
    built library from ``cuobjdump -sass``: 0 spill bytes, and both nonzero."""
    lib = backend.lib_path("flash_attention")
    func, props = None, {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif func and FLASH_TC_KERNEL in func and ("spill" in line or "Used" in line):
            props.setdefault(func, []).append(line.strip())
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

    check(len(props) == len(HEAD_DIMS),
          f"ptxas reported {len(props)} instantiations of {FLASH_TC_KERNEL}, want {HEAD_DIMS}")
    for func, lines in props.items():
        print(f"ptxas {FLASH_TC_KERNEL} {func.split('ILi')[1].split('E')[0]}:", " | ".join(lines))
        spills = [int(n) for ln in lines for n in re.findall(r"(\d+) bytes spill", ln)]
        check(len(spills) == 2 and sum(spills) == 0, f"{func}: spill bytes in {lines}")
    cuobjdump = Path(backend.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    print(f"sass flash_attention library: {json.dumps(counts)}")
    check(all(counts.values()), f"the flash library lacks wgmma or TMA loads: {counts}")


def _quantize_counts() -> dict:
    """Launches of each quantize kernel, and by route and block, since the
    counters were last set to 0."""
    from repro_torch.kernels.quantize.quantize import quantize_pack, unpack_dequant

    return {w.__name__: (w.launches, {f"{which} b{block}": n for (which, block), n
                                       in w.route_launches.items()})
            for w in (quantize_pack, unpack_dequant)}


def _reset_quantize_counts() -> None:
    from repro_torch.kernels.quantize.quantize import quantize_pack, unpack_dequant

    for w in (quantize_pack, unpack_dequant):
        w.launches = 0
        w.route_launches.clear()


def phase_main_path(torch) -> dict:
    from repro_torch.comm.session import run_swap_session
    from repro_torch.kernels.quantize.quantize import INV127

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = [layer_grads(torch, ATTN, gen), layer_grads(torch, MLP, gen)]
    torch.cuda.synchronize()
    _reset_quantize_counts()
    res = run_swap_session(batches + batches, blocks=BLOCKS, swap_after=2, device="cuda")
    counts = _quantize_counts()
    launches = {name: n for name, (n, _) in counts.items()}
    by_route = {name: routes for name, (_, routes) in counts.items()}
    print(f"main path: wire blocks client {res.client_blocks} server {res.server_blocks}, "
          f"switches {res.client_switches}/{res.server_switches}, launches {launches}, "
          f"by route and block {json.dumps(by_route)}")
    check(res.swapped and res.client_switches == 1 and res.server_switches == 1,
          "the 2PC swap did not happen exactly once on both sides")
    check(res.client_blocks == [256, 256, 64, 64] == res.server_blocks,
          "both wires must carry traffic, the swap between batch 2 and 3")
    check(launches == {"quantize_pack": 4, "unpack_dequant": 4},
          f"launches {launches}: want one encode and one decode per batch")
    check(all(r == {"vector b256": 2, "vector b64": 2} for r in by_route.values()),
          f"launches by route {by_route}: want all 8 on the vector route, 2 per kernel and block")
    for sent, got, block in zip(batches + batches, res.received, res.client_blocks):
        check(len(got) == len(sent), "tensors lost")
        for a, b in zip(sent, got):
            check(b.device.type == "cuda" and b.shape == a.shape and b.dtype == torch.float32,
                  f"got {b.dtype} {tuple(b.shape)} on {b.device}, sent {tuple(a.shape)}")
        flat = torch.cat([a.reshape(-1) for a in sent])
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block)).view(-1, block)
        s = flat.abs().amax(dim=1) * INV127
        s = torch.where(s > 0, s, torch.ones_like(s))
        y = torch.cat([b.reshape(-1) for b in got])
        y = torch.nn.functional.pad(y, (0, flat.numel() - y.numel())).view(-1, block)
        check(bool(torch.isfinite(y).all()), "non-finite values received")
        check(bool(within_half_scale(torch, flat, y, s).all()),
              f"a received value is off by more than scale/2 at block {block}")
    payload = sum(a.numel() * 4 for batch in batches + batches for a in batch)
    gbps = payload / res.seconds / 1e9
    print(f"main path: {payload} payload bytes in {res.seconds:.4f} s = {gbps:.3f} GB/s "
          f"through the connection, 2PC swap included")
    return launches, by_route, batches


def device_events(torch, averages) -> list:
    """(device us, name, count) of a profile's ``key_averages()``, largest
    first. Device-side events only: a host op (aten::copy_) also carries the
    device time of the copy it launched, and would count it twice; so would
    the program's own ranges (``repro_torch.*``, ``obs/ranges.py``), which
    the profiler puts on the device's timeline around the kernels inside."""
    return sorted(((e.self_device_time_total, e.key, e.count) for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("repro_torch.")), reverse=True)


def phase_profile(torch, batches) -> None:
    """The main path once more under torch.profiler: the device's busy time
    (kernels and copies) against the wall time of the run, and the count of
    launches and copies per batch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm.session import run_swap_session

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run_swap_session(batches + batches, blocks=BLOCKS, swap_after=2,
                               device="cuda")
    dev = device_events(torch, prof.key_averages())
    busy_s = sum(us for us, _, _ in dev) / 1e6
    print(f"profile: wall {res.seconds:.4f} s, device busy {busy_s:.4f} s, "
          f"idle share {1 - busy_s / res.seconds:.4f}")
    for us, key, count in dev[:8]:
        print(f"profile: device {us / 1e3:.3f} ms in {count} x {key}")
    # the cost contract of a batch whose tensors lie on the card: one launch
    # and one device-to-host copy to send, one host-to-device copy and one
    # launch to receive; every launch the vector route's
    n = len(batches) * 2
    for part, want in (("quantize_pack", n), ("unpack_dequant", n),
                       ("quantize_pack_vec_kernel", n), ("unpack_dequant_vec_kernel", n),
                       ("Memcpy DtoH", n), ("Memcpy HtoD", n)):
        got = sum(c for _, k, c in dev if part in k)
        check(got == want, f"profile: {got} x {part} in {n} batches, want {want}")


def _wan_send(torch, xs, loss: float = 0.0) -> dict:
    """Each tensor of ``xs`` in its own ``send([t])`` through a fresh
    ``WanLinkChunnel`` pair on the card, a thread pumping the receiver; the
    receiver's reassembled payloads are kept. Returns what arrived, the
    payloads, the sender's counters and the wall time from the first send to
    the last tensor received and synchronised."""
    from repro_torch.comm.chunnels import WanLinkChunnel
    from repro_torch.core.fabric import Fabric, LinkModel

    fabric = Fabric(seed=SEED)
    if loss:
        for a, b in (("wan-tx", "wan-rx"), ("wan-rx", "wan-tx")):
            fabric.set_link(a, b, LinkModel(loss=loss))
    kw = dict(mtu_bytes=WAN_MTU, window=WAN_WINDOW, block=WAN_BLOCK, device="cuda")
    tx = WanLinkChunnel(fabric.register("wan-tx"), "wan-rx", **kw).connect_wrap(None)
    rx = WanLinkChunnel(fabric.register("wan-rx"), "wan-tx", **kw).connect_wrap(None)
    payloads, got = [], []
    ingest = rx._reasm.ingest

    def keep(frame):
        done = ingest(frame)
        if done is not None:
            payloads.append(done[0])
        return done

    rx._reasm.ingest = keep

    def pump():
        buf = [None]
        deadline = time.monotonic() + 300.0
        while len(got) < len(xs) and time.monotonic() < deadline:
            if rx.recv(buf, timeout=0.05):
                got.append(buf[0])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    receiver = threading.Thread(target=pump, name="wan-receiver")
    receiver.start()
    for x in xs:
        tx.send([x])
    receiver.join(timeout=330.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(not receiver.is_alive() and len(got) == len(xs),
          f"WAN link: {len(got)} of {len(xs)} tensors arrived")
    frames_each = [-(-(len(pl)) // WAN_MTU) for pl in payloads]
    return {"got": got, "payloads": payloads, "stats": tx.stats(), "seconds": seconds,
            "windows": sum(-(-n // WAN_WINDOW) for n in frames_each)}


def _check_wan_bits(torch, label, xs, res) -> int:
    """Every received tensor bit-equal to the plain round trip on the card,
    and the reassembled wire payloads byte-equal to the plain encode; returns
    the count of differing payload bytes (0 required)."""
    import numpy as np

    from repro_torch.kernels.quantize.quantize import quantize_pack_ref, unpack_dequant_ref

    check(len(res["payloads"]) == len(xs), f"{label}: {len(res['payloads'])} blobs reassembled")
    differing = 0
    for x, y, payload in zip(xs, res["got"], res["payloads"]):
        x2d = torch.nn.functional.pad(x.reshape(-1), (0, (-x.numel()) % WAN_BLOCK)).view(
            -1, WAN_BLOCK)
        packed = quantize_pack_ref(x2d)
        want = unpack_dequant_ref(packed, x2d.shape[0], WAN_BLOCK)[:x.numel()].view(x.shape)
        check(isinstance(y, torch.Tensor) and y.device.type == "cuda"
              and y.dtype == torch.float32 and y.shape == x.shape,
              f"{label}: received {type(y).__name__} {getattr(y, 'dtype', None)} "
              f"{tuple(getattr(y, 'shape', ()))}, sent {tuple(x.shape)}")
        check(torch.equal(y.view(torch.int32), want.view(torch.int32)),
              f"{label}: received tensor differs from the plain round trip")
        plain = np.frombuffer(packed.cpu().numpy().tobytes(), np.uint8)
        wire = np.frombuffer(payload, np.uint8)
        check(wire.size == plain.size, f"{label}: payload of {wire.size} bytes, plain {plain.size}")
        differing += int((wire != plain).sum())
    check(differing == 0, f"{label}: {differing} payload bytes differ from the plain encode")
    return differing


def phase_wan(torch) -> dict:
    """The WAN path on the card: the layer gradient at full width through a
    WAN link pair, the attention batch again over a lossy link, then the
    chaos-regions scenario. Returns the quantize launches of the three."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_chaos_regions import assert_regions_acceptance, reference_blob, run_chaos_regions

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    xs = [torch.cat([g.reshape(-1) for g in layer_grads(torch, spec, gen)]) for spec in (ATTN, MLP)]
    check([x.numel() for x in xs] == [10_487_808, 50_333_696], "WAN batch sizes")
    total = {"quantize_pack": 0, "unpack_dequant": 0}
    want_routes = {"vector b256": 2}

    def count(label, want_launches):
        counts = _quantize_counts()
        for name, (n, routes) in counts.items():
            check(n == want_launches[name], f"{label}: {n} {name} launches, want "
                  f"{want_launches[name]}")
            check(set(routes) == {f"vector b{WAN_BLOCK}"} and sum(routes.values()) == n,
                  f"{label}: {name} by route {routes}, want all on the vector route")
            total[name] += n
        check(not THREAD_ERRORS, f"{label}: exceptions in threads: {THREAD_ERRORS}")
        return {name: routes for name, (_, routes) in counts.items()}

    payload = sum(x.numel() * 4 for x in xs)
    _reset_quantize_counts()
    res = _wan_send(torch, xs)
    routes = count("WAN full width", {"quantize_pack": 2, "unpack_dequant": 2})
    check(all(r == want_routes for r in routes.values()), f"WAN full width: routes {routes}")
    differing = _check_wan_bits(torch, "WAN full width", xs, res)
    st = res["stats"]
    wire = sum(len(pl) for pl in res["payloads"])
    print(f"WAN full width: {payload} payload bytes ({wire} wire bytes) in {res['seconds']:.4f} s "
          f"= {payload / res['seconds'] / 1e9:.4f} GB/s payload, {st['frames_sent']} frames in "
          f"{res['windows']} windows of {WAN_WINDOW}, {st['retransmits']} retransmits, "
          f"{st['failed_sends']} failed sends; launches by route {json.dumps(routes)}; "
          f"received bit-equal to the plain round trip, {differing} payload bytes differ")

    _reset_quantize_counts()
    lossy = _wan_send(torch, xs[:1], loss=WAN_LOSS)
    count("WAN lossy", {"quantize_pack": 1, "unpack_dequant": 1})
    _check_wan_bits(torch, "WAN lossy", xs[:1], lossy)
    st = lossy["stats"]
    print(f"WAN lossy (loss {WAN_LOSS} each way): {xs[0].numel() * 4} payload bytes in "
          f"{lossy['seconds']:.4f} s = {xs[0].numel() * 4 / lossy['seconds'] / 1e9:.4f} GB/s "
          f"payload, {st['frames_sent']} frames, {st['retransmits']} retransmits, "
          f"{st['failed_sends']} failed sends; received bit-equal")
    check(st["retransmits"] > 0 and st["failed_sends"] == 0,
          f"WAN lossy: retransmits {st['retransmits']}, failed sends {st['failed_sends']}")

    _reset_quantize_counts()
    t0 = time.perf_counter()
    scen = run_chaos_regions(fast=True, device="cuda",
                             blob=torch.from_numpy(reference_blob()).cuda())
    seconds = time.perf_counter() - t0
    try:
        assert_regions_acceptance(scen)
    except AssertionError as e:
        fail(f"WAN scenario: acceptance predicate failed: {e}")
    gw, ls = scen["gateway"], scen["wan"]["link_stats"]
    sent = scen["wan"]["blobs_sent"]
    routes = count("WAN scenario", {"quantize_pack": sent, "unpack_dequant": gw["wan_blobs"]})
    check(sent >= gw["wan_blobs"] >= 1, f"WAN scenario: {sent} blobs sent, "
          f"{gw['wan_blobs']} decoded by the gateway")
    print(f"WAN scenario (chaos regions, fast): {seconds:.4f} s; WAN region switched at tick "
          f"{scen['wan']['switch_tick']}, storm at {scen['storm_tick']}; {sent} blobs sent, "
          f"{gw['wan_blobs']} decoded by the gateway; link retransmits {ls['retransmits']}, "
          f"failed sends {ls['failed_sends']}, keepalive failures {ls['keepalive_failures']}; "
          f"launches by route {json.dumps(routes)}")
    return total


def phase_ssm_scan(torch) -> dict:
    """The SSM-scan kernel against its plain version on the card, then timed
    at the hybrid serving path's prefill chunk and decode step."""
    from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_chunk, ssm_scan_chunk_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def inputs(B, C, d, h0_scale=0.1):
        """The reference's test inputs: a = sigmoid(normal), a decay in
        (0, 1); bx and h0 normal, scaled."""
        a = torch.sigmoid(torch.randn((B, C, d, SSM_N), generator=gen, device="cuda"))
        bx = torch.randn((B, C, d, SSM_N), generator=gen, device="cuda") * 0.1
        h0 = torch.randn((B, d, SSM_N), generator=gen, device="cuda") * h0_scale
        return a, bx, h0

    def compare(label, got, want) -> float:
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        ok = all(torch.allclose(g, w, atol=SSM_TOL, rtol=SSM_TOL) for g, w in zip(got, want))
        print(f"kernel check ssm_scan_chunk {label}: max abs err {err} "
              f"(atol = rtol = {SSM_TOL})")
        check(ok, f"ssm_scan_chunk {label}: max abs err {err} above atol = rtol = {SSM_TOL}")
        return err

    B = SERVE_BATCH
    prefill, decode = inputs(B, SSM_CHUNK, SSM_D_IN), inputs(B, 1, SSM_D_IN)
    # hymba split over model 2: a rank scans its d_in / 2 channels
    local = inputs(B, SSM_CHUNK, SSM_D_IN // 2)
    errs = []
    for label, (a, bx, h0) in (("prefill chunk", prefill), ("decode step", decode),
                               ("d_in 300", inputs(3, 8, 300)),
                               (SSM_LOCAL, local)):
        n0 = ssm_scan_chunk.launches
        got = ssm_scan_chunk(a, bx, h0)
        check(ssm_scan_chunk.launches == n0 + 1, "ssm_scan_chunk: one launch per call")
        check(got[0].shape == a.shape and got[1].shape == h0.shape
              and got[0].dtype == torch.float32, f"ssm_scan_chunk {label}: output shapes")
        errs.append(compare(f"{label} {tuple(a.shape)}", got, ssm_scan_chunk_ref(a, bx, h0)))
    # a chunk that is a view of a longer sequence, as ssm_apply passes it
    a, bx, h0 = inputs(B, 2 * SSM_CHUNK, SSM_D_IN)
    a, bx = a[:, SSM_CHUNK:], bx[:, SSM_CHUNK:]
    check(not a.is_contiguous(), "the strided case must be a view")
    errs.append(compare(f"strided view, batch stride {a.stride(0)}",
                        ssm_scan_chunk(a, bx, h0), ssm_scan_chunk_ref(a, bx, h0)))
    # two half chunks in turn against the whole chunk
    a, bx, h0 = prefill
    half = SSM_CHUNK // 2
    seq1, h1 = ssm_scan_chunk(a[:, :half], bx[:, :half], h0)
    seq2, h2 = ssm_scan_chunk(a[:, half:], bx[:, half:], h1)
    errs.append(compare("two half chunks vs one whole", (torch.cat([seq1, seq2], dim=1), h2),
                        ssm_scan_chunk(a, bx, h0)))
    # a = 1 accumulates: h_last = h0 + sum_t bx_t, against a float64 sum
    _, bx1, h01 = inputs(B, SSM_CHUNK, SSM_D_IN, h0_scale=1.0)
    compare("a = 1 vs h0 + sum bx in float64", ssm_scan_chunk(torch.ones_like(bx1), bx1, h01)[1:],
            ((h01.double() + bx1.double().sum(dim=1)).float(),))

    ms = time_ms(torch, lambda: ssm_scan_chunk(a, bx, h0))
    plain_ms = time_ms(torch, lambda: ssm_scan_chunk_ref(a, bx, h0), reps=5, group=2)
    decode_ms = time_ms(torch, lambda: ssm_scan_chunk(*decode))
    decode_plain_ms = time_ms(torch, lambda: ssm_scan_chunk_ref(*decode))
    # a and bx read, h_seq written, h0 read and h_last written, float32; a
    # multiply and an add per lane and step
    io = 4 * (3 * a.numel() + 2 * h0.numel())
    flops = 2 * a.numel()
    bytes_ms, ops_ms = io / hw("hbm_bw") * 1e3, flops / hw("peak_flops_f32") * 1e3
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "max_abs_err": max(errs), "bytes": io, "flops": flops, "decode_ms": decode_ms,
           "decode_plain_ms": decode_plain_ms}
    print(f"time ssm_scan_chunk prefill chunk {tuple(a.shape)}: {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms by {res['bound_by']}: {io} bytes, "
          f"{flops} flops; {io / ms / 1e6:.1f} GB/s); decode step {tuple(decode[0].shape)}: "
          f"{decode_ms:.4f} ms (plain {decode_plain_ms:.4f} ms)")
    a, bx, h0 = local
    ms = time_ms(torch, lambda: ssm_scan_chunk(a, bx, h0))
    plain_ms = time_ms(torch, lambda: ssm_scan_chunk_ref(a, bx, h0), reps=5, group=2)
    io, flops = 4 * (3 * a.numel() + 2 * h0.numel()), 2 * a.numel()
    bytes_ms, ops_ms = io / hw("hbm_bw") * 1e3, flops / hw("peak_flops_f32") * 1e3
    case = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "max_abs_err": errs[3],
            "bytes": io, "flops": flops, "shape": list(a.shape)}
    res["cases"] = {SSM_LOCAL: case}
    print(f"time ssm_scan_chunk {SSM_LOCAL} {tuple(a.shape)}: {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, bound {case['bound_ms']:.4f} ms by {case['bound_by']}: {io} "
          f"bytes, {flops} flops; {io / ms / 1e6:.1f} GB/s, {case['bound_ms'] / ms:.1%} of the "
          "bound)")
    # the decode step: at C = 1 the chunk's function is one PyTorch call
    a, bx, h0 = decode
    lib_ms = time_ms(torch, lambda: torch.addcmul(bx[:, 0], a[:, 0], h0))
    io, flops = 4 * (3 * a.numel() + 2 * h0.numel()), 2 * a.numel()
    bytes_ms, ops_ms = io / hw("hbm_bw") * 1e3, flops / hw("peak_flops_f32") * 1e3
    res["cases"]["decode step"] = {
        "ms": decode_ms, "plain_ms": decode_plain_ms, "library_ms": lib_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms
        else "operations", "max_abs_err": errs[1], "bytes": io, "flops": flops,
        "shape": list(a.shape), "host_us": _host_us(torch, lambda: ssm_scan_chunk(a, bx, h0))}
    print(f"time ssm_scan_chunk decode step {tuple(a.shape)}: {decode_ms:.4f} ms, "
          f"torch.addcmul(bx, a, h0) (its library call) {lib_ms:.4f} ms; wrapper host time "
          f"{res['cases']['decode step']['host_us']:.1f} us a call")
    res["fused"] = _clock("selective scan", phase_selective_scan, torch,
                          res["cases"]["decode step"])
    return res


def _host_us(torch, fn, calls: int = 200) -> float:
    """The host's microseconds a call of ``fn`` (the launch's enqueue, not
    the kernel): the calls back to back, timed before the synchronise."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def fused_inputs(torch, gen, batch, S, d_in, bc_dtype, h0=None):
    """Inputs as ``ssm_apply`` hands them to ``selective_scan``: dt the
    softplus of a normal below 0, x silu of a normal in bf16, B and C
    column views of an x_proj output (batch, S, 100 + 2N) (hymba's dt_rank
    100) in ``bc_dtype``, A = -(1..N) (the S4D-real start), h0 zero or the
    given state, D = 1."""
    F = torch.nn.functional
    dt = F.softplus(torch.randn((batch, S, d_in), generator=gen, device="cuda") - 3.0)
    x = F.silu(torch.randn((batch, S, d_in), generator=gen, device="cuda")).to(torch.bfloat16)
    proj = torch.randn((batch, S, 100 + 2 * SSM_N), generator=gen, device="cuda").to(bc_dtype)
    A = -torch.arange(1, SSM_N + 1, dtype=torch.float32, device="cuda").expand(
        d_in, SSM_N).contiguous()
    if h0 is None:
        h0 = torch.zeros((batch, d_in, SSM_N), device="cuda")
    return (dt, x, proj[..., 100:100 + SSM_N], proj[..., 100 + SSM_N:], A, h0,
            torch.ones(d_in, device="cuda"))


def fused_bound(args) -> dict:
    """The least time of one call: each input read once and each output
    written once, against the card's memory rate; seven float32 operations
    per (b, t, d, n) (dt A, its exp, dt x B, a h, + bx, h C, the sum) and
    three per (b, t, d) (dt x, D x, + D x) against the float32 rate. The
    exp counts one operation here; its MUFU.EX2 rate is printed beside."""
    dt, x, Bm, Cm, A, h0, D = args
    Bsz, S, d_in = dt.shape
    N = A.shape[1]
    io = (sum(t.numel() * t.element_size() for t in (dt, x, Bm, Cm, A, h0, D))
          + 4 * (Bsz * S * d_in + Bsz * d_in * N))
    ops = 7 * Bsz * S * d_in * N + 3 * Bsz * S * d_in
    bytes_ms, ops_ms = io / hw("hbm_bw") * 1e3, ops / hw("peak_flops_f32") * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": io, "flops": ops, "exps": Bsz * S * d_in * N}


def phase_selective_scan(torch, chunk_decode: dict) -> dict:
    """B4 redesigned: the fused ``selective_scan`` against its plain
    version (``selective_scan_ref``) on the card, y and h_last bit-equal, at
    hymba's prefill, a rank's channels (model 2: d_in / 2, B and C float32
    as after the x_proj sum), a decode step from a carried state and 300
    steps (not a multiple of 256); then each timed beside the plain version
    and the bound, the decode step's host time a call too."""
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan, selective_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    B, bf16, f32 = SERVE_BATCH, torch.bfloat16, torch.float32
    prefix = fused_inputs(torch, gen, B, 16, SSM_D_IN, bf16)
    carried = selective_scan_ref(*prefix)[1]
    cases = {"prefill": fused_inputs(torch, gen, B, SERVE_PROMPT, SSM_D_IN, bf16),
             SSM_LOCAL: fused_inputs(torch, gen, B, SERVE_PROMPT, SSM_D_IN // 2, f32),
             "decode step": fused_inputs(torch, gen, B, 1, SSM_D_IN, bf16, h0=carried),
             "S 300": fused_inputs(torch, gen, B, 300, SSM_D_IN, bf16, h0=carried)}
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
                            "nounits"], capture_output=True, text=True).stdout.strip()
    mhz = float(clock) if clock.replace(".", "", 1).isdigit() else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, args in cases.items():
        check(all(not t.is_contiguous() for t in args[2:4]), "B and C must be views")
        n0 = selective_scan.launches
        got = selective_scan(*args)
        check(selective_scan.launches == n0 + 1, "selective_scan: one launch per call")
        want = selective_scan_ref(*args)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        shape = f"dt {tuple(args[0].shape)}, N {SSM_N}, B/C {str(args[2].dtype)[6:]}"
        print(f"kernel check selective_scan {label} ({shape}): y and h_last bit-equal to "
              f"selective_scan_ref {equal}, max abs err {err}")
        check(equal and got[0].shape == args[0].shape and got[1].shape == args[5].shape,
              f"selective_scan {label}: differs from its plain version by {err}")
        ms = time_ms(torch, lambda: selective_scan(*args))
        reps = (3, 1) if args[0].shape[1] > 1 else (21, 5)
        plain_ms = time_ms(torch, lambda: selective_scan_ref(*args), reps=reps[0],
                           group=reps[1])
        case = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "max_abs_err": err,
                "shape": list(args[0].shape) + [SSM_N], **fused_bound(args)}
        # the exponentials at MUFU.EX2's 16 a clock and SM, at the max SM clock
        case["exp_bound_ms"] = (case["exps"] / (sms * 16 * mhz * 1e6) * 1e3 if mhz
                                else None)
        exp_ms = f"{case['exp_bound_ms']:.4f} ms" if mhz else "not measured (no SM clock)"
        line = (f"time selective_scan {label} ({shape}): {ms:.4f} ms (plain {plain_ms:.4f} "
                f"ms; bound {case['bound_ms']:.4f} ms by {case['bound_by']}: {case['bytes']} "
                f"bytes, {case['flops']} flops; {case['bound_ms'] / ms:.1%} of the bound; "
                f"{case['exps']} expf, {exp_ms} at MUFU.EX2's rate on {sms} SMs at {clock} "
                "MHz)")
        if label == "decode step":
            case["host_us"] = _host_us(torch, lambda: selective_scan(*args))
            line += (f"; wrapper host time {case['host_us']:.1f} us a call, beside the chunk "
                     f"kernel's decode step: {chunk_decode['ms']:.4f} ms, host "
                     f"{chunk_decode['host_us']:.1f} us a call")
        print(line)
        out[label] = case
    return out


def _wrappers():
    """The serving path's kernel wrappers, by name (the chunk scan too, to
    show that no path launches it)."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan, ssm_scan_chunk

    return {"flash_attention": flash_attention, "selective_scan": selective_scan,
            "ssm_scan_chunk": ssm_scan_chunk}


def _counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def _since(before: dict) -> dict:
    return {name: n - before[name] for name, n in _counts().items()}


def _prefill_inputs(torch, cfg, n_tokens: int):
    """Seeded prompt tokens ``(B, n_tokens)`` and the family's other prefill
    inputs (patches for vlm, frames of the first SERVE_PROMPT tokens for
    audio), for the checks on a rebuilt model."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, n_tokens), generator=gen,
                           device="cuda")
    extra = {}
    if cfg.family == "vlm":
        f = cfg.frontend
        extra["patches"] = torch.randn((SERVE_BATCH, f.num_positions, f.embed_dim),
                                       generator=gen, device="cuda").to(torch.bfloat16)
    if cfg.family == "audio":
        extra["frames"] = torch.randn(
            (SERVE_BATCH, SERVE_PROMPT // cfg.encdec.src_ratio, cfg.frontend.embed_dim),
            generator=gen, device="cuda").to(torch.bfloat16)
    return tokens, extra


def _shape_key(q, k, causal) -> str:
    """The label of a flash wrapper's ``shape_launches`` key."""
    return f"q {tuple(q)} k {tuple(k)} {'causal' if causal else 'non-causal'}"


class _Routes:
    """Records the expert ids ``(B*S, k)`` of every ``models.moe.route``
    call, standing in for the module's name of it."""

    def __init__(self):
        from repro_torch.models import moe

        self.module, self.route, self.ids = moe, moe.route, []

    def __call__(self, *args, **kwargs):
        gates, ids, aux = self.route(*args, **kwargs)
        self.ids.append(ids)
        return gates, ids, aux

    def __enter__(self):
        self.module.route = self
        return self

    def __exit__(self, *exc):
        self.module.route = self.route


def phase_serve(torch, arch: str, n_params: int, tol: float, layers=None) -> dict:
    """The serving path of ``arch`` (its first ``layers`` layers, where
    given) through the launcher's ``main``, with the kernels' counters set
    to 0 just before and read just after; then the checks and timings on a
    model built again from the same seed. Returns the counts of the ``main``
    run, with the flash launches by shape under ``"flash by shape"``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import build

    cfg = get_config(arch)
    if layers is not None:
        cfg = serve.cut_depth(cfg, layers)
    fam = cfg.family
    hybrid = fam == "hybrid"
    L = cfg.num_layers
    # one flash launch per attention of the prefill: one a layer, none in
    # xlstm, three a decoder layer of the encoder-decoder (encoder, self,
    # cross, 12 each); one fused scan launch per layer in prefill and per
    # layer and decode step; no chunk scan
    flash = {"ssm": 0, "audio": 3 * L}.get(fam, L)
    scans = L * hybrid
    want_main = {"flash_attention": flash, "selective_scan": scans + SERVE_GEN * scans,
                 "ssm_scan_chunk": 0}
    argv = ["--arch", arch, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(SERVE_PROMPT), "--gen", str(SERVE_GEN)]
    if layers is not None:
        argv += ["--layers", str(layers)]
    print(f"serve {arch}: python -m repro_torch.launch.serve", " ".join(argv))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in _wrappers().values():
        w.launches = 0
    flash_fn = _wrappers()["flash_attention"]
    flash_fn.shape_launches.clear()
    res = serve.main(argv)
    launches = _counts()
    by_shape = {_shape_key(*key): n for key, n in flash_fn.shape_launches.items()}
    print(f"serve {arch}: launches {json.dumps(launches)} (want {json.dumps(want_main)}: "
          f"{flash} flash launches in the prefill and none in decode"
          + ("; one selective_scan per layer of the prefill and per layer and decode step, "
             "no ssm_scan_chunk" if hybrid else "")
          + f"); flash launches by shape {json.dumps(by_shape)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.max_memory_allocated()} bytes)")
    check(launches == want_main, f"serve {arch}: launches {launches}, want {want_main}")
    check(sum(by_shape.values()) == flash, f"serve {arch}: flash launches by shape {by_shape}")
    check(tuple(res.tokens.shape) == (SERVE_BATCH, SERVE_GEN + 1), "generated tokens' shape")
    check(bool(torch.isfinite(res.logits).all()), "non-finite logits")
    print(f"serve {arch} (first call): prefill {res.prefill_s * 1e3:.3f} ms, decode "
          f"{res.decode_ms_per_token:.4f} ms/token, {res.tokens_per_s:.1f} tokens/s")
    first_tokens = res.tokens
    del res
    gc.collect()
    torch.cuda.empty_cache()

    model = build(cfg.replace(attn_impl="pallas"), device="cuda", seed=serve.SEED)
    got_params = sum(p.numel() for p in model.parameters())
    check(got_params == n_params, f"{got_params} parameters, want {n_params}")
    tokens, extra = _prefill_inputs(torch, cfg, SERVE_PROMPT + 1)
    prompt = tokens[:, :SERVE_PROMPT]

    moe = fam == "moe"
    n0 = _counts()
    with (_Routes() if moe else nullcontext()) as routes:
        cache, logits = model.prefill(prompt, **extra)
    got = _since(n0)
    check(got == {"flash_attention": flash, "selective_scan": scans, "ssm_scan_chunk": 0},
          f"one prefill launched {got}")
    # the plain side: dense attention, and the scan's plain version
    model.attn_impl = "xla_dense"
    if hybrid:
        model.ssm_impl = "jnp"
    n0 = _counts()
    with (_Routes() if moe else nullcontext()) as routes_plain:
        _, logits_plain = model.prefill(prompt, **extra)
    check(not any(_since(n0).values()), "the plain prefill launched a kernel")
    model.attn_impl = "pallas"
    if hybrid:
        model.ssm_impl = "pallas"
    err = (logits.float() - logits_plain.float()).abs().max().item()
    agree = (logits.argmax(-1) == logits_plain.argmax(-1)).float().mean().item()
    plain = "xla_dense" + (" and the plain scan" if hybrid else "")
    if fam == "ssm":
        plain += " (no attention and no kernel on this path: the same computation)"
    print(f"serve {arch} check: prefill logits, kernels vs {plain}: max abs err {err} "
          f"(tolerance {tol}), |logits| max over the real vocab "
          f"{logits[:, :cfg.vocab_size].float().abs().max().item()}, "
          f"argmax agree {agree}")
    if moe:
        # the (token, slot) expert ids of the two prefills, per layer: a
        # near-tie in the top-k can flip under the attention's bf16 rounding
        check(len(routes.ids) == len(routes_plain.ids) == L,
              f"{len(routes.ids)} and {len(routes_plain.ids)} routings, want {L} each")
        pairs = list(zip(routes.ids, routes_plain.ids))
        shares = [(a == b).float().mean().item() for a, b in pairs]
        moved = [int((a != b).any(dim=1).sum()) for a, b in pairs]
        sets = [int((a.sort(dim=1).values != b.sort(dim=1).values).any(dim=1).sum())
                for a, b in pairs]
        print(f"serve {arch} routing: share of (token, slot) expert ids the kernel and plain "
              f"prefills agree on, per layer {shares}; tokens with some slot moved {moved}, "
              f"tokens whose set of {cfg.moe.top_k} experts changed {sets}, of "
              f"{routes.ids[0].shape[0]}")
        del routes, routes_plain, pairs
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(err <= tol, f"{arch}: kernel vs plain prefill logits differ by {err}")

    if moe:
        # decode's capacity at batch 4 is 1 a expert: the reference drops
        # tokens there, so a decode step is not the last row of a prefill
        grown = model.grow_cache(cache, 1)
    elif fam == "audio":
        # the launcher's growth pads the cross keys too (the reference's
        # quirk, held to it on the CPU); the check of decode against a
        # prefill grows the self-attention cache alone
        grown = dict(model.grow_cache(cache, 1), xk=cache["xk"], xv=cache["xv"])
    else:
        grown = model.grow_cache(cache, 1)
    n0 = _counts()
    _, logits_step = model.decode_step(grown, tokens[:, SERVE_PROMPT:])
    got = _since(n0)
    check(got == {"flash_attention": 0, "selective_scan": scans, "ssm_scan_chunk": 0},
          f"one decode step launched {got}")
    check(bool(torch.isfinite(logits_step).all()), "non-finite decode logits")
    del grown
    if not moe:
        _, logits_long = model.prefill(tokens, **extra)
        err = (logits_step.float() - logits_long.float()).abs().max().item()
        agree = (logits_step.argmax(-1) == logits_long.argmax(-1)).float().mean().item()
        print(f"serve {arch} check: decode step 1 vs prefill over {SERVE_PROMPT + 1} tokens: "
              f"max abs err {err} (tolerance {tol}), argmax agree {agree}")
        check(err <= tol, f"{arch}: decode vs prefill logits differ by {err}")
        del logits_long

    # warm timings of the same model, each phase ending in a synchronise
    warm = serve.serve(model, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN)
    print(f"serve {arch} (warm): prefill {warm.prefill_s * 1e3:.3f} ms, decode "
          f"{warm.decode_ms_per_token:.4f} ms/token, {warm.tokens_per_s:.1f} tokens/s")
    check(torch.equal(warm.tokens, first_tokens), "the same seed served other tokens")

    for label, fn in (("prefill", lambda: model.prefill(prompt, **extra)),
                      ("decode x8", lambda: _decode_steps(model, model.grow_cache(cache, 8),
                                                         tokens[:, -1:], 8))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        averages = prof.key_averages()
        dev = device_events(torch, averages)
        busy = sum(us for us, _, _ in dev) / 1e6
        tag = f"profile serve {arch} {label}"
        print(f"{tag}: wall {wall:.4f} s, device busy {busy:.4f} s, "
              f"idle share {1 - busy / wall:.4f}")
        print(f"{tag}: {sum(c for _, _, c in dev)} device kernels and copies")
        for us, key, count in dev[:8]:
            print(f"{tag}: device {us / 1e3:.3f} ms in {count} x {key[:90]}")
        host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in averages
                       if e.device_type == torch.autograd.DeviceType.CPU), reverse=True)
        for us, key, count in host[:6]:
            print(f"{tag}: host {us / 1e3:.3f} ms in {count} x {key[:90]}")
        del prof, averages
    print(f"serve {arch}: peak memory over the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.max_memory_allocated()} bytes)")
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches, **{"flash by shape": by_shape, "warm prefill ms": warm.prefill_s * 1e3})


def _decode_steps(model, cache, tok, n):
    for _ in range(n):
        cache, logits = model.decode_step(cache, tok)
        tok = logits.argmax(dim=-1, keepdim=True)


def _adamw_wrappers() -> dict:
    """AdamW's kernel wrappers, by name (every training step on the card
    launches them)."""
    from repro_torch.kernels.adamw.adamw import adamw_step, norm_scale, sumsq

    return {"sumsq": sumsq, "norm_scale": norm_scale, "adamw_step": adamw_step}


def _tap_adamw() -> None:
    """Wrap ``optim.adamw.update`` (once in a process) so that each call
    puts down its number of leaves in ``ADAMW_CALLS``."""
    from repro_torch import tree as T
    from repro_torch.optim import adamw

    if getattr(adamw.update, "tapped", False):
        return
    real = adamw.update

    def update(grads, state, params, *args, **kwargs):
        ADAMW_CALLS.append(len(T.leaves(params)))
        return real(grads, state, params, *args, **kwargs)

    update.tapped = True
    adamw.update = update


def _reset_adamw() -> None:
    from repro_torch.kernels.adamw import adamw as fused

    _tap_adamw()
    ADAMW_CALLS.clear()
    fused.route_leaves.clear()
    for w in _adamw_wrappers().values():
        w.launches = 0


def _adamw_taken() -> dict:
    """``update``'s calls and their leaves, the AdamW kernels' launches and
    ``update``'s routes since ``_reset_adamw``."""
    from repro_torch.kernels.adamw import adamw as fused

    return {"calls": len(ADAMW_CALLS), "leaves": sum(ADAMW_CALLS),
            **{name: w.launches for name, w in _adamw_wrappers().items()},
            "routes": dict(fused.route_leaves)}


def check_adamw(tag: str, taken: dict, steps: int) -> None:
    """``steps`` optimizer steps on the card: each a ``sumsq`` and an
    ``adamw_step`` launch a leaf and one ``norm_scale`` (2 x leaves + 1),
    every leaf on the kernel route."""
    n = taken["leaves"]
    want = {"calls": steps, "leaves": n, "sumsq": n, "norm_scale": steps, "adamw_step": n,
            "routes": {"kernel": n}}
    check(n > 0 and taken == want, f"{tag}: AdamW {taken}, want {want}")


def _others(launches: dict) -> dict:
    """``launches`` less AdamW's kernels."""
    return {name: n for name, n in launches.items() if name not in ADAMW_KERNELS}


def _all_counts() -> dict:
    """Launches of every kernel wrapper since its counter was last set to 0."""
    from repro_torch.kernels.quantize.quantize import (quantize_pack, unpack_dequant,
                                                       unpack_dequant_sum)

    ws = {**_wrappers(), "quantize_pack": quantize_pack, "unpack_dequant": unpack_dequant,
          "unpack_dequant_sum": unpack_dequant_sum, **_adamw_wrappers()}
    return {name: w.launches for name, w in ws.items()}


def _reset_all_counts() -> None:
    from repro_torch.kernels.quantize.quantize import unpack_dequant_sum

    _reset_quantize_counts()
    unpack_dequant_sum.launches = 0
    unpack_dequant_sum.route_launches.clear()
    for w in _wrappers().values():
        w.launches = 0
    _reset_adamw()


def _sharded_cfg(arch, layers):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(arch).replace(attn_impl="pallas")
    return serve.cut_depth(cfg, layers) if layers is not None else cfg


def _check_tokens(torch, cfg):
    """The seeded next token of each of the SERVE_BATCH rows, for the check
    step of decode on both sides."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    return torch.randint(0, cfg.vocab_size, (SERVE_BATCH, 1), generator=gen, device="cuda")


def _one_rank_check(torch, arch, layers) -> dict:
    """The one-rank port on the seeded batch of the launcher: the first
    decode step's logits on the check tokens, from the prefill's cache
    fitted to the sharded steps' capacity, and the greedy tokens of the
    prefill and the first decode steps (``SHARDED_EQUAL_TOKENS``); for the
    moe family, its prefill's expert ids and the capacity they were kept
    by."""
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import moe, registry
    from repro_torch.serving.steps import fit_cache

    cfg = _sharded_cfg(arch, layers)
    model = registry.build(cfg, device="cuda", seed=serve.SEED)
    tokens, extra = serve.serve_batch(cfg, SERVE_BATCH, SERVE_PROMPT, torch.device("cuda"))
    with (_Routes() if cfg.family == "moe" else nullcontext()) as routes:
        cache, logits_pre = model.prefill(tokens, **extra)
    cache = fit_cache(cache, registry.cache_shapes(
        cfg, ShapeConfig("serve", SHARDED_CAPACITY, SERVE_BATCH, "decode")))
    greedy = T.map(lambda x: x.clone() if torch.is_tensor(x) else x, cache)
    toks = [logits_pre.argmax(-1, keepdim=True)]
    for _ in range(SHARDED_EQUAL_TOKENS - 1):
        greedy, step_logits = model.decode_step(greedy, toks[-1])
        toks.append(step_logits.argmax(-1, keepdim=True))
    del greedy
    _, logits = model.decode_step(cache, _check_tokens(torch, cfg))
    out = {"logits": logits.float().cpu().numpy(), "vocab": cfg.vocab_size,
           "prefill": logits_pre.float().cpu().numpy(),
           "tokens": torch.cat(toks, dim=1).cpu().numpy()}
    if routes is not None:
        ids = routes.ids[0]
        C = moe.capacity(ids.shape[0], cfg)
        _, keep = moe._positions_in_expert(ids, cfg.moe.num_experts, C)
        out.update(ids=ids.cpu().numpy(), keep=keep.cpu().numpy(), C=C)
    del model, cache, tokens, extra, logits, logits_pre
    gc.collect()
    torch.cuda.empty_cache()
    return out


class _DispatchTap:
    """Stands in for ``models.moe``'s two mesh dispatches: records each
    call's MoE layer, input rows, output and expert ids (``route`` tapped
    during the call), for the check against ``dispatch_grouped`` after the
    run."""

    NAMES = ("dispatch_alltoall", "dispatch_allgather")

    def __init__(self):
        from repro_torch.models import moe

        self.module, self.calls = moe, []
        self.real = {n: getattr(moe, n) for n in self.NAMES}

    def _tapped(self, name):
        def call(p, x3d, cfg, mesh, *args, **kwargs):
            with _Routes() as routes:
                y, aux = self.real[name](p, x3d, cfg, mesh, *args, **kwargs)
            self.calls.append({"name": name, "p": p, "x": x3d, "y": y, "cfg": cfg,
                               "mesh": mesh, "ids": routes.ids[0],
                               "positions": kwargs.get("positions", False)})
            return y, aux
        return call

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.module, n, self._tapped(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.real.items():
            setattr(self.module, n, f)


class _WholeBanks:
    """``dispatch_grouped``'s view of a MoE layer whose bfloat16 banks hold
    the rank's experts only (the serving split's): its router and its banks
    gathered over ``model`` (every rank of it builds one, in the same
    order). For the check of the mesh dispatches alone."""

    def __init__(self, p, mesh):
        from repro_torch.comm import collectives

        self.router = p.router
        self.whole = tuple(collectives.gather_dim(b, mesh, "model", 0, op="check_banks")
                           for b in p.banks())

    def banks(self):
        return self.whole


def _dispatch_gap(torch, call, whole: dict) -> dict:
    """A mesh dispatch's output against ``dispatch_grouped`` on one rank, on
    the same tokens at the same capacity, with every expert (the rank's
    banks gathered over ``model`` where they hold its own only; ``whole``
    keeps them by layer): ``alltoall`` routes each model
    rank's S/n slice of the rows alone, ``allgather`` the slices of the
    row's model ranks together, gathered in (model rank, row, position)
    order. Every rank along ``model`` holds the same rows, so this rank's
    rows stand for the others'. On the sequence-parallel residual
    (``positions``: the rank holds its slice alone, and so does the
    output) ``alltoall`` is ``dispatch_grouped`` of the rank's tokens, and
    ``allgather`` the rank's block of ``dispatch_grouped`` of the slices
    gathered over ``model`` (every rank calls this, in the same order)."""
    from repro_torch.comm import collectives
    from repro_torch.models import moe

    p, x, y, cfg = call["p"], call["x"], call["y"], call["cfg"]
    mesh = call["mesh"]
    n = mesh.shape["model"]
    if p.banks()[0].shape[0] != cfg.moe.num_experts:
        if id(p) not in whole:
            whole[id(p)] = _WholeBanks(p, mesh)
        p = whole[id(p)]
    B_l, S, D = x.shape
    s_l = S // n
    if call["positions"]:
        if call["name"] == "dispatch_alltoall":
            ref = moe.dispatch_grouped(p, x.reshape(-1, D), cfg)[0].reshape(B_l, S, D)
        else:
            row = collectives.all_gather(x.to(torch.bfloat16), mesh, "model")
            ref = (moe.dispatch_grouped(p, row.reshape(-1, D), cfg)[0]
                   .reshape(n, B_l, S, D)[mesh.coords["model"]].to(x.dtype))
    elif call["name"] == "dispatch_alltoall":
        ref = torch.cat([moe.dispatch_grouped(p, x[:, m * s_l:(m + 1) * s_l].reshape(-1, D),
                                              cfg)[0].reshape(B_l, s_l, D) for m in range(n)],
                        dim=1)
    else:
        x_row = x.to(torch.bfloat16).reshape(B_l, n, s_l, D).transpose(0, 1).reshape(-1, D)
        ref = (moe.dispatch_grouped(p, x_row, cfg)[0].reshape(n, B_l, s_l, D)
               .transpose(0, 1).reshape(B_l, S, D).to(x.dtype))
    try:
        torch.testing.assert_close(y.float(), ref.float(), atol=MOE_DISPATCH_TOL,
                                   rtol=MOE_DISPATCH_TOL)
        ok = True
    except AssertionError:
        ok = False
    return {"ok": ok, "max_abs_err": (y.float() - ref.float()).abs().max().item(),
            "bit_equal": bool(torch.equal(y, ref)), "max_abs": ref.float().abs().max().item()}


def serve_sharded_rank(spec: dict) -> dict:
    """One rank of a sharded serve case (run by ``spawn``): the serve
    launcher's rank target ``serving.steps.serve_rank`` with the kernels'
    counters set to 0 just before each run's prefill and read after each of
    its phases (prefill, check step, greedy steps), and the MoE mesh
    dispatches tapped: after the runs each call's output is held against
    ``dispatch_grouped`` on the same tokens (``_dispatch_gap``), and the
    first layer's expert ids go back for the routing share."""
    import torch

    from repro_torch.serving.steps import serve_rank

    errors: list = []
    threading.excepthook = lambda a: errors.append(f"{a.thread.name}: {a.exc_value!r}")
    ws = _wrappers()
    seen: list = []

    def observe(run, phase):
        if phase == "start":
            for w in ws.values():
                w.launches = 0
            ws["flash_attention"].shape_launches.clear()
            seen.append({})
        else:
            seen[run][phase] = _counts()
            seen[run]["shapes"] = dict(ws["flash_attention"].shape_launches)

    with _DispatchTap() as tap:
        out = serve_rank(spec, observe)
    per_run = len(tap.calls) // len(out["runs"])
    whole: dict = {}
    for i, (run, c) in enumerate(zip(out["runs"], seen)):
        run["launches_prefill"] = c["prefill"]
        run["launches_check"] = {n: c["check"][n] - c["prefill"][n] for n in c["check"]}
        run["launches_decode"] = {n: c["decode"][n] - c["check"][n] for n in c["decode"]}
        run["flash_shapes"] = c["shapes"]
        calls = tap.calls[i * per_run:(i + 1) * per_run]
        run["dispatch"] = [_dispatch_gap(torch, call, whole) for call in calls]
        if calls:
            run["route_ids"] = calls[0]["ids"].cpu().numpy()
    del tap, whole
    out["thread_errors"] = errors
    return out


def _check_sharded_flash(torch, arch, cfg, shapes, checked: set) -> None:
    """B3 against its plain version at every (q, k, causal) shape that the
    sharded ranks launched it at and that no earlier check covered: each
    rank's rows are another batch than the one-rank path's."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    windows = [None] + ([cfg.sliding_window] if cfg.sliding_window else [])
    for q_shape, k_shape, causal in sorted(shapes):
        for window in windows:
            if (q_shape, k_shape, causal, window) in checked:
                continue
            checked.add((q_shape, k_shape, causal, window))
            q = torch.randn(q_shape, generator=gen, device="cuda").to(torch.bfloat16)
            k, v = (torch.randn(k_shape, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            # a comparison's launch counts for no path
            before = flash_attention.launches, Counter(flash_attention.shape_launches)
            _flash_check(torch, f"serve sharded {arch} window {window}", q, k, v,
                         dict(causal=causal, window=window))
            flash_attention.launches, flash_attention.shape_launches = before
            del q, k, v


def _roofline_serve(cfg, rank: int, n_data: int, n_model: int, kv: str) -> tuple:
    """``analysis.roofline``'s bytes by ``op@axis`` of the rank's prefill and
    of its decode steps (the check step and the greedy ones) in a sharded
    serve case."""
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import ShapeConfig, ShardingConfig
    from repro_torch.launch.mesh import AbstractMesh

    mesh = AbstractMesh({"pod": 1, "data": n_data, "model": n_model}, rank=rank)
    sh = ShardingConfig(kv_partition=kv)
    pre = roofline.step_collectives(cfg, ShapeConfig("p", SERVE_PROMPT, SERVE_BATCH, "prefill"),
                                    mesh, sh=sh)
    dec = roofline.step_collectives(cfg, ShapeConfig("d", SHARDED_CAPACITY, SERVE_BATCH,
                                                     "decode"), mesh, sh=sh)
    return dict(pre), {k: v * (SERVE_GEN + 1) for k, v in dec.items()}


def phase_serve_sharded(torch, checked: set) -> dict:
    """Serving on a mesh of gloo ranks that share the card (NCCL refuses two
    ranks on one device), through the serve launcher's rank target
    (``chip_smoke.serve_sharded_rank`` around ``serving.steps.serve_rank``):
    for each case, the one-rank port's check logits here, then the spawn,
    then every check on the ranks' records, and B3 against its plain
    version at the ranks' attention shapes. Returns each run's launches,
    summed over its ranks, by path."""
    import numpy as np

    from repro_torch.comm.moe_dispatch import configure
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import moe
    from repro_torch.models.pshard import SPLIT_FAMILIES
    from repro_torch.serving.steps import capacity_for

    check(capacity_for(SERVE_PROMPT, SERVE_GEN) == SHARDED_CAPACITY,
          f"serve_rank's capacity {capacity_for(SERVE_PROMPT, SERVE_GEN)}")
    why = "the ranks share one GPU; NCCL refuses two ranks on one device"
    paths = {}
    for arch, layers, (n_data, n_model), runs, tol in SHARDED_SERVE:
        cfg = _sharded_cfg(arch, layers)
        world = n_data * n_model
        one = _one_rank_check(torch, arch, layers)
        cut = f", {layers} of {get_config(arch).num_layers} layers" if layers else ""
        print(f"serve sharded {arch}{cut}: {world} processes on cuda:0, gloo ({why}); mesh "
              f"(data {n_data}, model {n_model}); batch {SERVE_BATCH} x {SERVE_PROMPT}, cache "
              f"{SHARDED_CAPACITY}, {SERVE_GEN} greedy steps; runs {runs}")
        t0 = time.perf_counter()
        spec = {"arch": arch, "world": world, "data": n_data, "model": n_model, "smoke": False,
                "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN,
                "device": "cuda", "attn_impl": "pallas", "layers": layers, "runs": runs,
                "check_tokens": _check_tokens(torch, cfg).cpu().numpy()}
        ranks = spawn("chip_smoke:serve_sharded_rank", world, backend="gloo", args=(spec,),
                      timeout_s=900.0, reason=why)
        wall = time.perf_counter() - t0
        L = cfg.num_layers
        hybrid = cfg.family == "hybrid"
        scans = L * hybrid
        # a prefill's attentions: the encoder-decoder's encoder, decoder
        # self and cross attention; none in xlstm
        attns = {"audio": cfg.encdec.enc_layers + 2 * cfg.encdec.dec_layers if cfg.encdec
                 else 0, "ssm": 0}.get(cfg.family, L)
        for r in ranks:
            check(not r["thread_errors"], f"rank {r['rank']}: {r['thread_errors']}")
            print(f"serve sharded {arch}: rank {r['rank']} at {r['coords']}: layout (draw, "
                  f"blocks, working copies) {r['layout_s']:.3f} s, holds {r['block_bytes']} "
                  f"bytes of float32 blocks and {r['working_bytes']} bytes of working copies "
                  f"({(r['block_bytes'] + r['working_bytes']) / 2**30:.2f} GiB); layout bytes "
                  f"sent {json.dumps(r['layout_sent'])}")
        for i, (kv, dispatch) in enumerate(runs):
            label = f"serve sharded {arch} {kv}" + (f" {dispatch}" if dispatch else "")
            recs = [r["runs"][i] for r in ranks]
            want_pre = {"flash_attention": attns, "selective_scan": scans, "ssm_scan_chunk": 0}
            want_chk = {"flash_attention": 0, "selective_scan": scans, "ssm_scan_chunk": 0}
            want_dec = {"flash_attention": 0, "selective_scan": SERVE_GEN * scans,
                        "ssm_scan_chunk": 0}
            gaps = []
            for r, rec in zip(ranks, recs):
                rank = r["rank"]
                check(bool(np.isfinite(rec["prefill_logits"]).all()
                           and np.isfinite(rec["check_logits"]).all()),
                      f"{label} rank {rank}: non-finite logits")
                check(rec["launches_prefill"] == want_pre, f"{label} rank {rank}: prefill "
                      f"launched {rec['launches_prefill']}, want {want_pre}")
                check(rec["launches_check"] == want_chk and rec["launches_decode"] == want_dec,
                      f"{label} rank {rank}: decode launched {rec['launches_check']} + "
                      f"{rec['launches_decode']}, want {want_chk} + {want_dec}")
                rows = SERVE_BATCH // n_data
                d = r["coords"]["data"]
                ref = one["logits"][d * rows:(d + 1) * rows]
                got = rec["check_logits"]
                gap = float(np.abs(got - ref).max())
                agree = float((got[:, :one["vocab"]].argmax(-1)
                               == ref[:, :one["vocab"]].argmax(-1)).mean())
                gaps.append(gap)
                ref_pre = one["prefill"][d * rows:(d + 1) * rows]
                gap_pre = float(np.abs(rec["prefill_logits"] - ref_pre).max())
                agree_pre = float((rec["prefill_logits"][:, :one["vocab"]].argmax(-1)
                                   == ref_pre[:, :one["vocab"]].argmax(-1)).mean())
                print(f"{label}: rank {rank} ({rec['kv']}): prefill "
                      f"{rec['prefill_s'] * 1e3:.3f} ms, decode "
                      f"{rec['decode_s'] / SERVE_GEN * 1e3:.4f} ms/token (its collectives gloo "
                      f"through the host), peak {rec['peak_memory_bytes'] / 2**30:.2f} GiB "
                      f"({rec['peak_memory_bytes']} bytes); launches prefill "
                      f"{json.dumps(rec['launches_prefill'])}, check step "
                      f"{json.dumps(rec['launches_check'])}, {SERVE_GEN} steps "
                      f"{json.dumps(rec['launches_decode'])}; first decode step vs the "
                      f"one-rank port: max abs gap {gap} (tolerance {tol}), argmax agree {agree}; "
                      f"prefill's last logits: max abs gap {gap_pre} ("
                      + ("not held: the mesh dispatch drops other tokens at its capacity; "
                         "the dispatch is held to dispatch_grouped below"
                         if cfg.family == "moe" else f"tolerance {tol}")
                      + f"), argmax agree {agree_pre}")
                print(f"{label}: rank {rank} bytes sent by op@axis (gloo through the host, not "
                      f"NCCL): prefill {json.dumps(rec['sent_prefill'])}, check step and "
                      f"{SERVE_GEN} steps {json.dumps(rec['sent_decode'])}; compute split "
                      f"{rec['split']}, working copies {rec['working_bytes']} bytes "
                      f"({rec['working_bytes'] / 2**30:.2f} GiB)")
                if cfg.family in SPLIT_FAMILIES:  # the split ran: its sums, no gathers
                    sent, pre = rec["sent_decode"], rec["sent_prefill"]
                    if cfg.family == "ssm":
                        # xlstm: the mLSTM by heads (wo's sums), the sLSTM by
                        # channels (its output's channels gathered), the
                        # vocabulary; the state stays the rank's heads and
                        # channels, so no gather_cache; no sequence split
                        check("sum_partials@model" in sent and "gather_seq@model" not in pre
                              and sent.get("gather_channels@model", 0) > 0
                              and sent.get("embed_sum@model", 0) > 0
                              and pre.get("embed_sum@model", 0) > 0
                              and "gather_cache@model" not in sent
                              and "channels=slice(" in rec["split"]
                              and rec["split"].startswith("Split(heads=Heads("),
                              f"{label} rank {rank}: the xlstm split sent {pre} + {sent}")
                    else:
                        check("sum_partials@model" in sent and "gather_cache@model" not in sent
                              and (rec["mode"] != "heads" or "all_gather@model" not in sent),
                              f"{label} rank {rank}: the split's decode sent {sent}")
                        # the sequence-parallel residual and the vocabulary
                        # split: no whole-activation sums in prefill (but
                        # hymba's x_proj sum, which the SSM's recurrence
                        # reads at every position)
                        check((cfg.family == "hybrid" or "sum_partials@model" not in pre)
                              and pre.get("gather_seq@model", 0) > 0
                              and pre.get("scatter_embed@model", 0) > 0,
                              f"{label} rank {rank}: the split prefill sent {pre}")
                    check(pre.get("gather_logits@model", 0) > 0,
                          f"{label} rank {rank}: the split prefill sent {pre}")
                    # the run's dispatch, as serve_rank configures it
                    run_cfg = configure(cfg, dispatch) if dispatch and cfg.moe else cfg
                    want_p, want_d = _roofline_serve(run_cfg, rank, n_data, n_model, kv)
                    print(f"{label}: rank {rank} bytes against analysis.roofline's count: "
                          f"prefill equal {pre == want_p} (total {sum(pre.values())}, "
                          f"counted {sum(want_p.values())}), decode equal {sent == want_d} "
                          f"(total {sum(sent.values())}, counted {sum(want_d.values())})")
                    check(pre == want_p and sent == want_d, f"{label} rank {rank}: bytes "
                          f"{pre} + {sent}, the roofline counts {want_p} + {want_d}")
                if cfg.family == "moe":  # the serving banks: the rank's experts only
                    E = cfg.moe.num_experts
                    print(f"{label}: rank {rank}: bf16 bank copies hold "
                          f"{rec['bank_experts']} experts a layer (E {E} over model "
                          f"{n_model}); peak {rec['peak_memory_bytes'] / 2**30:.2f} GiB beside "
                          f"10.68 (alltoall) / 10.53 (allgather) GiB measured with whole banks")
                    check(rec["bank_experts"] == [E // n_model] * L and "experts=True"
                          in rec["split"], f"{label} rank {rank}: bank copies hold "
                          f"{rec['bank_experts']} experts, split {rec['split']}")
                check(gap <= tol, f"{label} rank {rank}: first decode step differs from the "
                      f"one-rank port by {gap}")
                check(cfg.family == "moe" or gap_pre <= tol,
                      f"{label} rank {rank}: prefill differs from the one-rank port by {gap_pre}")
            for a, ra in zip(ranks, recs):
                for b, rb in zip(ranks, recs):
                    if a["coords"]["data"] == b["coords"]["data"]:
                        check(np.array_equal(ra["tokens"], rb["tokens"]),
                              f"{label}: ranks {a['rank']} and {b['rank']} share rows, "
                              "generated other tokens")
            print(f"{label}: tokens equal across each model group: True; greedy tokens of "
                  f"row 0 {recs[0]['tokens'][0, :12].tolist()}; largest gap {max(gaps)}")
            n_eq = SHARDED_EQUAL_TOKENS
            for r, rec in zip(ranks, recs):
                rows = SERVE_BATCH // n_data
                d = r["coords"]["data"]
                want_toks = one["tokens"][d * rows:(d + 1) * rows]
                same = float((rec["tokens"][:, :n_eq] == want_toks).mean())
                print(f"{label}: rank {r['rank']}: share of the prefill's and first "
                      f"{n_eq - 1} decode steps' greedy tokens equal to the one-rank port's "
                      f"{same}" + (" (held: 1.0)" if cfg.family == "ssm" else ""))
                check(cfg.family != "ssm" or same == 1.0,
                      f"{label} rank {r['rank']}: greedy tokens {rec['tokens'][:, :n_eq]}, the "
                      f"one-rank port's {want_toks}")
            if cfg.family == "moe":
                for r, rec in zip(ranks, recs):
                    check(len(rec["dispatch"]) == L, f"{label} rank {r['rank']}: "
                          f"{len(rec['dispatch'])} mesh dispatch calls in prefill, want {L}")
                    for layer, g in enumerate(rec["dispatch"]):
                        print(f"{label}: rank {r['rank']} layer {layer} {dispatch} output vs "
                              f"dispatch_grouped on the same tokens at the same capacity: max "
                              f"abs err {g['max_abs_err']} (atol = rtol = {MOE_DISPATCH_TOL}; "
                              f"outputs up to {g['max_abs']}), bit-equal {g['bit_equal']}")
                        check(g["ok"], f"{label} rank {r['rank']} layer {layer}: the mesh "
                              f"dispatch differs from dispatch_grouped by {g['max_abs_err']}")
                    ids = rec["route_ids"]
                    # the global token index (row * S + position) of each routed
                    # token: alltoall routes this rank's S/n slice of its rows,
                    # allgather the slices of every model rank of its row
                    half, rows = SERVE_PROMPT // n_model, SERVE_BATCH // n_data
                    d, m = r["coords"]["data"], r["coords"]["model"]
                    ms = [m] if dispatch == "alltoall" else range(n_model)
                    tok = np.asarray([(d * rows + b) * SERVE_PROMPT + mm * half + s
                                      for mm in ms for b in range(rows) for s in range(half)])
                    C = moe.capacity(ids.shape[0], cfg)
                    _, keep = moe._positions_in_expert(torch.from_numpy(ids),
                                                       cfg.moe.num_experts, C)
                    share = float((ids == one["ids"][tok]).mean())
                    drops = int((~keep).sum())
                    drops_one = int((~one["keep"][tok]).sum())
                    print(f"{label}: rank {r['rank']} routed {len(tok)} tokens (capacity "
                          f"{C} an expert; the one-rank prefill's "
                          f"{one['C']} over {one['ids'].shape[0]}): share of (token, slot) "
                          f"expert ids equal to the one-rank grouped prefill's {share}; "
                          f"(token, slot) pairs dropped {drops}, the one-rank prefill "
                          f"dropped {drops_one} of the same tokens' pairs")
                    check(share >= SHARDED_ROUTE_SHARE, f"{label}: routing share {share}")
            shapes = set()
            for rec in recs:
                shapes |= set(rec["flash_shapes"])
            paths[label] = {
                "flash_attention": sum(sum(rec[k]["flash_attention"] for k in (
                    "launches_prefill", "launches_check", "launches_decode")) for rec in recs),
                **{name: sum(sum(rec[k][name] for k in (
                    "launches_prefill", "launches_check", "launches_decode")) for rec in recs)
                   for name in ("selective_scan", "ssm_scan_chunk")},
                "flash by shape": {_shape_key(*k): n for k, n in sum(
                    (Counter(rec["flash_shapes"]) for rec in recs), Counter()).items()}}
            _check_sharded_flash(torch, arch, cfg, shapes, checked)
        print(f"serve sharded {arch}: spawn to exit {wall:.3f} s; every process exited 0")
        del ranks, one
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def phase_sum_kernel(torch) -> dict:
    """``unpack_dequant_sum`` against its plain version on the card, then
    timed at the two-rank phase's gradient and at the wire of a rank's own
    shard of the sharded phase's (pod 2, model 2), where ``quantize_pack`` is
    checked and timed too."""
    from repro_torch.kernels.quantize.quantize import (launch_sum, quantize_pack,
                                                       quantize_pack_ref, unpack_dequant_sum,
                                                       unpack_dequant_sum_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def gathered(n, n_blocks, block):
        """n ranks' codes and scales, each rank's from its own quantized
        gradient-sized draw, stacked as an all-gather leaves them."""
        codes = torch.empty((n, n_blocks, block), dtype=torch.int8, device="cuda")
        scales = torch.empty((n, n_blocks), dtype=torch.float32, device="cuda")
        nq = n_blocks * block
        for k in range(n):
            x = torch.randn((n_blocks, block), generator=gen, device="cuda") * GRAD_SCALE
            packed = quantize_pack(x)
            codes[k] = packed[:nq].view(torch.int8).view(n_blocks, block)
            scales[k] = packed[nq:].view(torch.float32)
            del x, packed
        return codes, scales

    def check_case(label, codes, scales, want_route):
        n, n_blocks, block = codes.shape
        n0 = unpack_dequant_sum.route_launches.copy()
        out = unpack_dequant_sum(codes, scales)
        ref = unpack_dequant_sum_ref(codes, scales)
        torch.cuda.synchronize()
        check(unpack_dequant_sum.route_launches - n0 == {(want_route, block): 1},
              f"unpack_dequant_sum {label}: want one {want_route} launch")
        check(out.shape == (n_blocks * block,) and out.dtype == torch.float32,
              f"unpack_dequant_sum {label}: {out.dtype} {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
              f"unpack_dequant_sum {label} != plain: max abs diff {err}")
        print(f"kernel check unpack_dequant_sum {label}: n {n}, n_blocks {n_blocks}, block "
              f"{block}, codes at data_ptr % 16 = {codes.data_ptr() % 16}, {want_route} route: "
              "bit-equal")
        return err

    def rank_quantize() -> dict:
        """``quantize_pack`` at a rank's own shard against its plain version,
        then timed."""
        x = torch.randn((RANK_N_BLOCKS, 256), generator=gen, device="cuda") * GRAD_SCALE
        nq = x.numel()
        check(nq == RANK_NUMEL, f"{nq} floats")
        packed = quantize_pack(x)
        err = (packed.int() - quantize_pack_ref(x).int()).abs().max().item()
        check(err == 0, f"quantize_pack at a rank's shard != plain: max byte diff {err}")
        ms = time_ms(torch, lambda: quantize_pack(x))
        plain_ms = time_ms(torch, lambda: quantize_pack_ref(x), reps=5, group=2)
        io = 4 * nq + packed.numel()
        bytes_ms = io / hw("hbm_bw") * 1e3
        ops_ms = OPS_PER_ELEM["quantize_pack"] * nq / hw("peak_flops_f32") * 1e3
        bound = max(bytes_ms, ops_ms)
        print(f"time quantize_pack at a rank's shard ({nq} floats, {RANK_N_BLOCKS} blocks of "
              f"256): {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound:.4f} ms, {io} bytes; "
              f"{io / ms / 1e6:.1f} GB/s, {bound / ms:.1%} of the bound); byte-equal to plain")
        return {"floats": nq, "n_blocks": RANK_N_BLOCKS, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": io, "max_abs_err": err}

    errs = []
    res = {}
    # (key, n, n_blocks): the two-rank phase's gradient, n = 2, 4 and 1; a
    # rank's own shard of the sharded phase's, n = 2
    for key, n, n_blocks in ((2, 2, SUM_N_BLOCKS), (4, 4, SUM_N_BLOCKS), (1, 1, SUM_N_BLOCKS),
                             ("rank", 2, RANK_N_BLOCKS)):
        if key == "rank":
            res["rank quantize_pack"] = rank_quantize()
        codes, scales = gathered(n, n_blocks, 256)
        err = check_case(f"gradient n={n}" if key != "rank" else "a rank's shard n=2",
                         codes, scales, "vector")
        errs.append(err)
        if n == 1:
            continue
        out = torch.empty(n_blocks * 256, dtype=torch.float32, device="cuda")
        ms = time_ms(torch, lambda: unpack_dequant_sum(codes, scales))
        vec_ms = time_ms(torch, lambda: launch_sum("vector", codes, scales, out))
        plain_ms = time_ms(torch, lambda: unpack_dequant_sum_ref(codes, scales), reps=5, group=2)
        io = codes.numel() + 4 * scales.numel() + 4 * out.numel()
        flops = (2 * n - 1) * out.numel()
        bytes_ms, ops_ms = io / hw("hbm_bw") * 1e3, flops / hw("peak_flops_f32") * 1e3
        bound = max(bytes_ms, ops_ms)
        res[key] = {"floats": out.numel(), "n_blocks": n_blocks, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "bytes": io, "flops": flops, "vector_entry_ms": vec_ms, "max_abs_err": err}
        print(f"time unpack_dequant_sum n={n} (codes {tuple(codes.shape)}): {ms:.4f} ms "
              f"(the vector entry point alone {vec_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{bound:.4f} ms by {res[key]['bound_by']}: {io} bytes, {flops} flops; "
              f"{io / ms / 1e6:.1f} GB/s, {bound / ms:.1%} of the bound)")
        del codes, scales, out
        torch.cuda.empty_cache()
    codes, scales = gathered(2, 1001, 256)  # a ragged tail of the vector route's tiles
    errs.append(check_case("ragged n_blocks=1001", codes, scales, "vector"))
    codes, scales = gathered(2, 4 * 9999, 64)
    errs.append(check_case("block 64", codes, scales, "vector"))
    codes_off = torch.empty(codes.numel() + 1, dtype=torch.int8, device="cuda")[1:]
    codes_off = codes_off.view(codes.shape)
    codes_off.copy_(codes)
    check(codes_off.data_ptr() % 16 == 1, "the offset view must sit one byte off")
    errs.append(check_case("offset view", codes_off, scales, "scalar"))
    res["max_abs_err"] = max(errs)
    return res


def phase_adamw(torch) -> dict:
    """AdamW's kernels at llama3.2-1b's leaf shapes, full width: one
    ``optim.adamw.update`` on the card (a ``sumsq`` and an ``adamw_step`` a
    leaf, one ``norm_scale``, every leaf on the kernel route) held to the
    plain route leaf by leaf (``torch.equal`` of p, m and v against
    ``g.mul_(scale)`` and ``_leaf_update`` at the card's scale; the norm
    within ADAMW_NORM_RTOL of ``global_norm``); then each pass timed beside
    its plain version and its bound by bytes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.adamw import adamw as fused
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    shapes = {n: tuple(p.shape) for n, p in
              registry.build(get_config(ADAMW_ARCH), device="meta").named_parameters()}
    n_params = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    draw = lambda s, k: torch.randn(s, generator=gen, device=dev) * k  # noqa: E731
    params = {n: draw(s, 0.02) for n, s in shapes.items()}
    grads = {n: draw(s, 1e-3) for n, s in shapes.items()}
    m = {n: draw(s, 1e-4).to(torch.bfloat16) for n, s in shapes.items()}
    v = {n: draw(s, 1e-4).square_().to(torch.bfloat16) for n, s in shapes.items()}
    cfg, lr = TrainConfig(), 3e-4
    count = 2  # the moments of two steps: the bias corrections of step 3
    clone = lambda tree: {k: t.clone() for k, t in tree.items()}  # noqa: E731
    want_p, want_m, want_v = clone(params), clone(m), clone(v)
    _reset_adamw()
    _, _, met = adamw.update(grads, adamw.AdamWState(m, v, count), params, lr, cfg)
    torch.cuda.synchronize()
    taken = _adamw_taken()
    check_adamw("adamw", taken, 1)
    check(taken["leaves"] == len(shapes), f"adamw: {taken['leaves']} leaves, want {len(shapes)}")
    norm = adamw.global_norm(grads)
    gap = abs(met["grad_norm"].item() - norm.item()) / norm.item()
    check(gap <= ADAMW_NORM_RTOL, f"adamw: norm {met['grad_norm'].item()!r} against "
          f"global_norm {norm.item()!r}: relative gap {gap}")
    scale = torch.clamp(cfg.grad_clip / torch.clamp(met["grad_norm"], min=1e-12), max=1.0)
    c1, c2 = (float(1 - adamw._f32(b) ** adamw._f32(count + 1)) for b in (cfg.beta1, cfg.beta2))
    unequal = []
    for k in shapes:
        adamw._leaf_update(want_p[k], grads[k].clone().mul_(scale), want_m[k], want_v[k], lr,
                           c1, c2, cfg)
        unequal += [f"{k}.{name}" for name, got, want in
                    (("p", params[k], want_p[k]), ("m", m[k], want_m[k]), ("v", v[k], want_v[k]))
                    if not torch.equal(got, want)]
    check(not unequal, f"adamw: the kernel route differs from the plain one at {unequal[:8]}")
    print(f"adamw: {ADAMW_ARCH}'s {len(shapes)} leaves ({n_params} float32 parameters, bfloat16 "
          f"moments): update on the card bit-equal to the plain route leaf by leaf (p, m, v at "
          f"the card's scale); norm {met['grad_norm'].item()!r} against global_norm "
          f"{norm.item()!r}, relative gap {gap:.3e} (tolerance {ADAMW_NORM_RTOL}); launches "
          f"{json.dumps({k: taken[k] for k in ADAMW_KERNELS})}, routes {taken['routes']}")
    del want_p, want_m, want_v

    slots = torch.empty(len(shapes), dtype=torch.float32, device=dev)
    one = torch.ones((), device=dev)

    def sumsq_pass():
        for i, g in enumerate(grads.values()):
            fused.sumsq(g, slots[i])
        fused.norm_scale(slots, cfg.grad_clip)

    def step_pass():
        for k in shapes:
            fused.adamw_step(params[k], grads[k], m[k], v[k], one, lr=lr, c1=c1, c2=c2,
                             beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                             weight_decay=cfg.weight_decay)

    def plain_norm():
        torch.clamp(cfg.grad_clip / torch.clamp(adamw.global_norm(grads), min=1e-12), max=1.0)

    def plain_step():  # the clip's product by 1, then the plain update
        for k in shapes:
            adamw._leaf_update(params[k], grads[k].mul_(one), m[k], v[k], lr, c1, c2, cfg)

    state = adamw.AdamWState(m, v, count)
    host = []  # the host's time to enqueue one update, the card idle before it
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adamw.update(grads, state, params, lr, cfg)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    times = {"update": (time_ms(torch, lambda: adamw.update(grads, state, params, lr, cfg),
                                reps=11, group=3), None, 24),
             "sumsq": (time_ms(torch, sumsq_pass, reps=11, group=3),
                       time_ms(torch, plain_norm, reps=5, group=1), 4),
             "adamw_step": (time_ms(torch, step_pass, reps=11, group=3),
                            time_ms(torch, plain_step, reps=5, group=1), 20)}
    res = {"leaves": len(shapes), "parameters": n_params, "norm_rel_gap": gap,
           "max_abs_err": abs(met["grad_norm"].item() - norm.item()),
           "host_ms": statistics.median(host)}
    for name, (ms, plain_ms, per) in times.items():
        io = per * n_params
        bound = io / hw("hbm_bw") * 1e3
        res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                     "bytes": io}
        plain = "" if plain_ms is None else f"plain {plain_ms:.4f} ms, "
        print(f"time adamw {name} at {ADAMW_ARCH}'s leaves: {ms:.4f} ms ({plain}bound "
              f"{bound:.4f} ms by bytes: {io} bytes; {io / ms / 1e6:.1f} GB/s, "
              f"{bound / ms:.1%} of the bound)")
    res["update"]["plain_ms"] = res["sumsq"]["plain_ms"] + res["adamw_step"]["plain_ms"]
    res["update"]["host_ms"] = res.pop("host_ms")
    print(f"adamw: the host enqueues one update in {res['update']['host_ms']:.4f} ms (median of "
          f"5; {res['update']['host_ms'] / len(shapes) * 1e3:.1f} us a leaf): the timed passes "
          "are the card's time only where the host keeps ahead of it")
    del params, grads, m, v, state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_analysis(torch, smi: str, warm_prefill_ms: float) -> None:
    """The analysis slice (``repro_torch.analysis``, ``launch.dryrun``):
    llama3.2-1b's decode_32k cell priced on the meta device for the 16x16
    mesh, the reference's slow-test cell, its record's keys checked; then
    FlopCounterMode's count of llama3.2-1b's prefill at the serve phase's
    shape (4 x 2048, 16 layers, published widths, seed weights) on the card
    with ``xla_chunked`` attention, held to ``analysis.flops``'
    ``fwd_flops_layerwise`` within 15%; then the H100 roofline's terms for
    that prefill on one card beside the serve phase's warm prefill (B3 on
    the card) and the share of the roofline it reached. No kernel launches
    in this phase."""
    from collections import Counter

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis import flops as F
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, serve
    from repro_torch.models.registry import build

    t0 = time.perf_counter()
    for w in _wrappers().values():
        w.launches = 0
    rec = dryrun.lower_cell("llama3.2-1b", "decode_32k", multi_pod=False)
    keys = {"arch", "shape", "kind", "multi_pod", "mesh", "transport", "kv_partition",
            "moe_dispatch", "lower_s", "compile_s", "memory", "cost_analysis", "roofline",
            "skipped"}
    check(keys <= set(rec) and not rec["skipped"], f"dry-run record keys {sorted(rec)}")
    check(rec["memory"]["fits_16GB"], f"decode_32k does not fit 16 GB: {rec['memory']}")
    r = rec["roofline"]
    print(f"analysis dry run llama3.2-1b decode_32k 16x16 (meta device, "
          f"{rec['count_s']} s): dom={r['dominant']} comp={r['compute_s']:.6e}s "
          f"mem={r['memory_s']:.6e}s coll={r['collective_s']:.6e}s "
          f"mfu={r['mfu']:.6f} fits_16GB={rec['memory']['fits_16GB']} "
          f"per_device_total={rec['memory']['per_device_total']} "
          f"collectives={json.dumps(rec['collectives'])}")

    cfg = get_config("llama3.2-1b").replace(attn_impl="xla_chunked")
    shape = ShapeConfig("serve", SERVE_PROMPT, SERVE_BATCH, "prefill")
    model = build(cfg, device="cuda", seed=serve.SEED)
    tokens, _ = _prefill_inputs(torch, cfg, SERVE_PROMPT)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.prefill(tokens)
    torch.cuda.synchronize()
    counted = fc.get_total_flops()
    analytic = sum(F.fwd_flops_layerwise(cfg, shape, "prefill"))
    ratio = counted / analytic
    print(f"analysis count llama3.2-1b prefill {SERVE_BATCH} x {SERVE_PROMPT} on the card "
          f"(xla_chunked): FlopCounterMode {counted} FLOPs, fwd_flops_layerwise {analytic:.0f}, "
          f"ratio {ratio:.6f} (tolerance 0.85-1.15)")
    check(0.85 < ratio < 1.15, f"counted FLOPs {counted} vs analytic {analytic}: {ratio}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    rf = roofline.analyze(Counter(), cfg, shape, {})
    step_ms = rf.step_time_s * 1e3
    print(f"analysis roofline llama3.2-1b prefill {SERVE_BATCH} x {SERVE_PROMPT}, one "
          f"{smi}: compute {rf.compute_s * 1e3:.4f} ms ({rf.flops_per_dev:.0f} FLOPs at "
          f"{hw('peak_flops_bf16') / 1e12:.0f} TFLOP/s), memory {rf.memory_s * 1e3:.4f} ms "
          f"({rf.bytes_per_dev:.0f} bytes at {hw('hbm_bw') / 1e12} TB/s), dominant "
          f"{rf.dominant}; the serve phase's warm prefill {warm_prefill_ms:.3f} ms (flash "
          f"kernel), share of the roofline {step_ms / warm_prefill_ms:.4f}, model FLOPs "
          f"utilisation {rf.model_flops / hw('peak_flops_bf16') / (warm_prefill_ms / 1e3):.4f}")
    launched = _counts()
    check(not any(launched.values()), f"the analysis phase launched kernels: {launched}")
    print(f"analysis phase: {time.perf_counter() - t0:.1f} s")


def phase_train_one(torch, n_params: int) -> dict:
    """The one-rank training path through the launcher's ``main`` at full
    width, with every kernel counter set to 0 just before and read just
    after; then restart continuity from the step-4 checkpoint and a profile
    of one warm step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        argv = ["--arch", "llama3.2-1b", "--steps", str(TRAIN_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--transport", "xla", "--ckpt", ckpt,
                "--ckpt-every", str(TRAIN_CKPT_EVERY)]
        print("train 1 rank: python -m repro_torch.launch.train", " ".join(argv))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        _reset_all_counts()
        t0 = time.perf_counter()
        run = train.main(argv)
        wall = time.perf_counter() - t0
        launches, taken = _all_counts(), _adamw_taken()
        print(f"train 1 rank: launches {json.dumps(launches)} (want 0 of each but AdamW's: one "
              f"rank builds no transport chunnel, and training attends with xla_chunked); "
              f"AdamW {json.dumps(taken)} (want a sumsq and an adamw_step a leaf and one "
              f"norm_scale a step, every leaf on the kernel route)")
        check(not any(_others(launches).values()), f"train 1 rank launched kernels: {launches}")
        check_adamw("train 1 rank", taken, TRAIN_STEPS)
        losses = run.losses
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(l) for l in losses),
              f"train 1 rank: losses {losses}")
        check(run.transport == "xla", f"negotiated {run.transport}, not xla")
        print(f"train 1 rank: losses {losses}")
        print(f"train 1 rank: first step {run.first_ms:.3f} ms, warm {run.warm_ms:.3f} ms/step "
              f"(median of steps 2-{TRAIN_STEPS}), {run.tokens_per_s:.1f} tokens/s "
              f"({run.tokens_per_step} tokens a step), peak memory "
              f"{run.peak_memory_bytes / 2**30:.2f} GiB ({run.peak_memory_bytes} bytes); step ms "
              f"{[round(t * 1e3, 3) for t in run.step_s]}; main {wall:.3f} s with the "
              f"checkpoints' writes")
        gc.collect()
        torch.cuda.empty_cache()

        tr = train.build(train.parse(argv), make_mesh((1,), ("data",), device="cuda"))
        got = sum(p.numel() for p in tr.model.parameters())
        check(got == n_params, f"train 1 rank: {got} parameters, want {n_params}")
        t0 = time.perf_counter()
        state, at = tr.restore(step=TRAIN_CKPT_EVERY)
        restore_s = time.perf_counter() - t0
        check(at == TRAIN_CKPT_EVERY and state.step == TRAIN_CKPT_EVERY,
              f"restored step {at}, state step {state.step}")
        gen = batches_for(tr.cfg, tr.shape)
        state, hist = tr.run(state, gen, TRAIN_STEPS - TRAIN_CKPT_EVERY)
        again = [h["loss"] for h in hist]
        want = losses[TRAIN_CKPT_EVERY:]
        diff = max(abs(a - b) / abs(b) for a, b in zip(again, want))
        print(f"train 1 rank restart: restored step {at} in {restore_s:.3f} s; steps "
              f"{TRAIN_CKPT_EVERY}-{TRAIN_STEPS - 1} again {again} against {want}: max relative "
              f"difference {diff} (tolerance {RESTART_RTOL}), "
              f"{'equal' if again == want else 'not bit-equal'}")
        check(diff <= RESTART_RTOL, f"restart losses differ by {diff}")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(state, gen, 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = device_events(torch, prof.key_averages())
        busy = sum(us for us, _, _ in dev) / 1e6
        tag = "profile train 1 rank, one warm step"
        print(f"{tag}: wall {wall:.4f} s, device busy {busy:.4f} s, idle share "
              f"{1 - busy / wall:.4f}, {sum(c for _, _, c in dev)} device kernels and copies")
        for us, key, count in dev[:10]:
            print(f"{tag}: device {us / 1e3:.3f} ms in {count} x {key[:90]}")
        host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU), reverse=True)
        for us, key, count in host[:8]:
            print(f"{tag}: host {us / 1e3:.3f} ms in {count} x {key[:90]}")
        del tr, state
        return launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _checksum(torch, params) -> list:
    """Each parameter's float32 bit patterns summed as int64: equal on two
    ranks when the parameters are bit-equal (a difference in one element
    always shows)."""
    return [p.detach().view(torch.int32).sum(dtype=torch.int64).item()
            for _, p in sorted(params.items())]


def train_rank(ckpt_dir: str) -> dict:
    """One rank of the two-rank phase (run by ``spawn`` in a process of its
    own; every rank runs the same calls). Returns its per-step records."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.comm import collectives, compress
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.quantize.quantize import (quantize_pack, unpack_dequant,
                                                       unpack_dequant_sum,
                                                       unpack_dequant_sum_ref)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

    errors: list = []
    threading.excepthook = lambda a: errors.append(f"{a.thread.name}: {a.exc_value!r}")
    torch.cuda.set_device(0)
    rank = dist.get_rank()
    mesh = make_mesh((2,), ("pod",), device="cuda:0")
    cfg = get_config("llama3.2-1b").replace(num_layers=TRAIN2_LAYERS)
    shape = ShapeConfig("train2", TRAIN_SEQ, TRAIN_BATCH, "train")
    offers = ["psum", "compressed_int8"]
    tr = ReconfigurableTrainer(cfg, shape, mesh,
                               tcfg=TrainConfig(warmup_steps=10, total_steps=TRAIN_STEPS),
                               transport="psum", ckpt_dir=ckpt_dir,
                               hosts=[HostSpec(0, list(offers)), HostSpec(1, list(offers))])
    n_params = sum(p.numel() for p in tr.model.parameters())
    n_leaves = len(T.leaves(step_mod.grad_shapes(tr.model)))
    state = tr.init_state(SEED)
    gen = batches_for(cfg, shape)
    tap: dict = {}
    real_sum = compress.unpack_dequant_sum

    def tapped(codes, scales):
        """The first all-gather-sum of two ranks, against its plain
        version on the same gathered codes (not counted: the plain
        version launches no kernel of the port)."""
        out = real_sum(codes, scales)
        if codes.shape[0] == 2 and "bit_equal" not in tap:
            ref = unpack_dequant_sum_ref(codes, scales)
            tap["bit_equal"] = bool(torch.equal(out.view(torch.int32), ref.view(torch.int32)))
            tap["max_abs_err"] = (out - ref).abs().max().item()
            tap["shape"] = list(codes.shape)
        return out

    compress.unpack_dequant_sum = tapped
    wrappers = {"quantize_pack": quantize_pack, "unpack_dequant": unpack_dequant,
                "unpack_dequant_sum": unpack_dequant_sum}
    records = []

    def one_step(state, label):
        for w in wrappers.values():
            w.launches = 0
            w.route_launches.clear()
        _reset_adamw()
        sent0 = sum(collectives.SENT.values())
        state, hist = tr.run(state, gen, 1)
        sums = [None] * mesh.size
        dist.all_gather_object(sums, _checksum(torch, state.params))
        records.append({
            "label": label, "transport": tr.transport_name, "step": state.step,
            "loss": hist[0]["loss"], "ms": tr.step_times[-1] * 1e3,
            "sent_bytes": sum(collectives.SENT.values()) - sent0,
            "launches": {n: w.launches for n, w in wrappers.items()}, "adamw": _adamw_taken(),
            "routes": {n: {f"{r} b{b}": c for (r, b), c in w.route_launches.items()}
                       for n, w in wrappers.items()},
            "params_equal_on_ranks": all(s == sums[0] for s in sums)})
        return state

    for _ in range(3):
        state = one_step(state, "psum")
    state = tr.reconfigure(state, "compressed_int8")
    for _ in range(3):
        state = one_step(state, "compressed_int8")
    t0 = time.perf_counter()
    tr.save(state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, at = tr.restore()
    restore_s = time.perf_counter() - t0
    state = one_step(state, "compressed_int8 after restore")
    compress.unpack_dequant_sum = real_sum
    return {"rank": rank, "n_params": n_params, "n_leaves": n_leaves, "records": records,
            "reconfig_log": tr.reconfig_log, "restored_at": at, "save_s": save_s,
            "restore_s": restore_s, "tap": tap, "thread_errors": errors,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_train_two(torch) -> dict:
    """Two ranks on the one card: spawn, then every check on both ranks'
    records. Returns the launches of each kernel, over both ranks."""
    from repro_torch.launch.mesh import spawn

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt2_")
    why = "the ranks share one GPU; NCCL refuses two ranks on one device"
    print(f"train 2 ranks: two processes on cuda:0, gloo ({why}); llama3.2-1b widths, "
          f"{TRAIN2_LAYERS} of 16 layers; global batch {TRAIN_BATCH} x {TRAIN_SEQ}; psum x 3, "
          "2PC to compressed_int8, compressed_int8 x 3, save, restore, 1 more step")
    try:
        t0 = time.perf_counter()
        ranks = spawn("chip_smoke:train_rank", 2, backend="gloo", args=(ckpt,),
                      timeout_s=900.0, reason=why)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    total = {"quantize_pack": 0, "unpack_dequant": 0, "unpack_dequant_sum": 0,
             **dict.fromkeys(ADAMW_KERNELS, 0)}
    for r in ranks:
        rank = r["rank"]
        check(not r["thread_errors"], f"rank {rank}: exceptions in threads {r['thread_errors']}")
        check(r["n_params"] == TRAIN2_PARAMS and r["n_leaves"] == TRAIN2_LEAVES,
              f"rank {rank}: {r['n_params']} parameters in {r['n_leaves']} leaves")
        check(r["reconfig_log"] == [{"from": "psum", "to": "compressed_int8", "committed": True,
                                     "at_step": 3}], f"rank {rank}: {r['reconfig_log']}")
        check(r["restored_at"] == 6, f"rank {rank}: restored step {r['restored_at']}")
        tap = r["tap"]
        check(tap.get("bit_equal") is True,
              f"rank {rank}: the first all-gather-sum differs from its plain version: {tap}")
        print(f"train 2 ranks, rank {rank}: first compressed all-gather-sum (codes "
              f"{tap['shape']}) bit-equal to its plain version on the same gathered codes; "
              f"save {r['save_s']:.3f} s, restore {r['restore_s']:.3f} s, peak memory "
              f"{r['peak_memory_bytes'] / 2**30:.2f} GiB")
        for rec in r["records"]:
            compressed = rec["transport"] == "compressed_int8"
            want = ({"quantize_pack": 1 + TRAIN2_LEAVES, "unpack_dequant": 0,
                     "unpack_dequant_sum": 1 + TRAIN2_LEAVES} if compressed
                    else {"quantize_pack": 0, "unpack_dequant": 0, "unpack_dequant_sum": 0})
            check(rec["launches"] == want, f"rank {rank} step {rec['step']} ({rec['label']}): "
                  f"launches {rec['launches']}, want {want}")
            if compressed:
                for name in ("quantize_pack", "unpack_dequant_sum"):
                    check(rec["routes"][name] == {"vector b256": want[name]},
                          f"rank {rank} step {rec['step']}: {name} routes {rec['routes'][name]}")
            check(rec["params_equal_on_ranks"],
                  f"rank {rank} step {rec['step']}: parameters differ across the ranks")
            check(math.isfinite(rec["loss"]), f"rank {rank} step {rec['step']}: loss {rec['loss']}")
            check_adamw(f"rank {rank} step {rec['step']}", rec["adamw"], 1)
            for name in total:
                total[name] += {**rec["launches"], **rec["adamw"]}[name]
    r0 = ranks[0]["records"]
    check([rec["loss"] for rec in r0] == [rec["loss"] for rec in ranks[1]["records"]],
          "the ranks report different losses")
    for rec in r0:
        print(f"train 2 ranks: step {rec['step']} {rec['label']}: loss {rec['loss']:.6f}, "
              f"{rec['ms']:.3f} ms (rank 0; rank 1 "
              f"{ranks[1]['records'][r0.index(rec)]['ms']:.3f} ms), {rec['sent_bytes']} bytes "
              f"sent by rank 0, launches {json.dumps(rec['launches'])}, AdamW "
              f"{json.dumps(rec['adamw'])}, parameters bit-equal on both ranks")
    for t in ("psum", "compressed_int8"):
        ms = [rec["ms"] for r in ranks for rec in r["records"] if rec["label"] == t]
        sent = [rec["sent_bytes"] for rec in r0 if rec["label"] == t]
        print(f"train 2 ranks: {t}: median {statistics.median(ms):.3f} ms/step over both ranks' "
              f"{len(ms)} steps (gloo through the host on one shared card, not NCCL), "
              f"{statistics.median(sent)} bytes sent per rank per step")
    print(f"train 2 ranks: launches over both ranks {json.dumps(total)}; spawn to exit "
          f"{wall:.3f} s; both processes exited 0")
    return total


def _block_checksums(torch, params) -> dict:
    """Each parameter block's float32 bit patterns summed as int64, by name."""
    return {n: p.detach().contiguous().view(torch.int32).sum(dtype=torch.int64).item()
            for n, p in sorted(params.items())}


def _zero1_layouts(tr, state) -> dict:
    """The rank's optimizer leaves by how ``update`` views them: with no
    ZeRO-1 split, or as the ``pod`` block narrowed on a dim, contiguous or
    as rows of one stride (the kernels take both)."""
    from repro_torch.kernels.adamw import adamw as fused
    from repro_torch.optim.adamw import _zero1_view
    from repro_torch.train import step as step_mod

    shards = step_mod.adam_shards(tr.state_sh) or {}
    out: Counter = Counter()
    for name, p in state.params.items():
        sh = shards.get(name)
        if sh is None or sh.zero1_dim is None:
            out["no split"] += 1
            continue
        lay = fused.rows(_zero1_view(p, sh))
        kind = "no layout" if lay is None else "contiguous" if lay[0] <= 1 else "rows"
        out[f"dim {sh.zero1_dim} {kind}"] += 1
    return dict(out)


def train_sharded_rank(ckpt_dir: str) -> dict:
    """One rank of the sharded phase (run by ``spawn``; every rank runs the
    same calls). Returns its records of (a) and (b)."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.analysis import roofline
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.comm import collectives
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.quantize.quantize import (quantize_pack, unpack_dequant,
                                                       unpack_dequant_sum)
    from repro_torch.launch.mesh import AbstractMesh, make_mesh
    from repro_torch.train.gradshard import whole_tree
    from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

    errors: list = []
    threading.excepthook = lambda a: errors.append(f"{a.thread.name}: {a.exc_value!r}")
    torch.cuda.set_device(0)
    cfg = get_config("llama3.2-1b").replace(num_layers=TRAIN2_LAYERS)
    shape = ShapeConfig("sharded", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainConfig(warmup_steps=10, total_steps=TRAIN_STEPS)
    gen = batches_for(cfg, shape)
    wrappers = {"quantize_pack": quantize_pack, "unpack_dequant": unpack_dequant,
                "unpack_dequant_sum": unpack_dequant_sum}

    def one_step(tr, state, label, records, check_whole=False):
        for w in wrappers.values():
            w.launches = 0
            w.route_launches.clear()
            w.size_launches.clear()
        _reset_adamw()
        mesh = tr.mesh
        counted = dict(roofline.step_collectives(
            cfg, shape, AbstractMesh(dict(mesh.shape), rank=mesh.rank), sh=tr.sharding,
            transport=tr.transport_name, tcfg=tcfg))
        taken = {}
        if check_whole:  # keep the transport's inputs and outputs of this step
            ch = tr.chunnels[0]
            apply = ch.apply

            def spy(tree, st, ctx):
                out, new = apply(tree, st, ctx)
                taken.update(tree=tree, state=st, ctx=ctx, new=new,
                             out=T.map(lambda x: x.clone(), out))
                return out, new

            ch.apply = spy
        sent0 = dict(collectives.SENT)
        state, hist = tr.run(state, gen, 1)
        sent = {k: v - sent0.get(k, 0) for k, v in collectives.SENT.items()
                if v - sent0.get(k, 0)}
        launches = {n: w.launches for n, w in wrappers.items()}
        opt = _adamw_taken()
        routes = {n: {f"{r} b{b}": c for (r, b), c in w.route_launches.items()}
                  for n, w in wrappers.items()}
        at_rank_shape = {n: w.size_launches[RANK_NUMEL] for n, w in wrappers.items()}
        whole = None
        if check_whole:  # after the counters' window: the whole-tree path
            del ch.apply
            torch.cuda.synchronize()
            # the run's peak so far, then the check's own: the check gathers
            # every leaf, which the step does not
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ref_out, (ref_new,) = whole_tree((ch,), taken["tree"], (taken["state"],),
                                             taken["ctx"])
            torch.cuda.synchronize()
            equal = lambda a, b: all(torch.equal(x, y) for x, y in  # noqa: E731
                                     zip(T.leaves(a), T.leaves(b)))
            whole = {"out_equal": equal(taken["out"], ref_out),
                     "state_equal": equal(taken["new"], ref_new),
                     "n_leaves": len(T.leaves(ref_out)), "s": time.perf_counter() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
            taken.clear()
            del ref_out, ref_new
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        records.append({
            "label": label, "transport": tr.transport_name, "step": state.step,
            "loss": hist[0]["loss"], "ms": tr.step_times[-1] * 1e3,
            "sent_by_axis": collectives.sent_by_axis(sent), "sent": sent, "counted": counted,
            "launches": launches, "routes": routes, "at_rank_shape": at_rank_shape,
            "adamw": opt, "zero1": _zero1_layouts(tr, state),
            "checksums": _block_checksums(torch, state.params), "whole": whole})
        return state

    peaks: list = []  # the peaks read before each whole-tree check

    # (a) FSDP over data, tensor parallelism over model, xla
    mesh_a = make_mesh((2, 2), ("data", "model"), device="cuda:0")
    tr = ReconfigurableTrainer(cfg, shape, mesh_a, tcfg=tcfg, sharding=ShardingConfig(fsdp=True),
                               transport="xla", ckpt_dir=ckpt_dir)
    state = tr.init_state(SEED)
    held = sum(p.numel() * p.element_size() for p in state.params.values())
    whole = sum(4 * math.prod(s) for s in tr.state_sh.shapes.values())
    # a leaf that does not split four ways is held in full or by half
    undivided = sum(4 * math.prod(s) for n, s in tr.state_sh.shapes.items()
                    if len(tr.state_sh.params[n].splits(len(s))) < 2)
    records_a: list = []
    for _ in range(SHARDED_A_STEPS):
        state = one_step(tr, state, "a xla", records_a)
    saved = _block_checksums(torch, tr.gathered_state(state).params)
    tr.save(state)
    out = {"rank": dist.get_rank(), "coords_a": dict(mesh_a.coords), "held": held,
           "whole": whole, "undivided": undivided, "records_a": records_a}
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    peak_a = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # (b) (a)'s checkpoint restored onto (pod 2, model 2); psum, 2PC, compressed
    mesh_b = make_mesh((2, 2), ("pod", "model"), device="cuda:0")
    offers = ["psum", "compressed_int8"]
    tr = ReconfigurableTrainer(cfg, shape, mesh_b, tcfg=tcfg, transport="psum",
                               ckpt_dir=ckpt_dir,
                               hosts=[HostSpec(0, list(offers)), HostSpec(1, list(offers))])
    t0 = time.perf_counter()
    state, at = tr.restore()
    restore_s = time.perf_counter() - t0
    restored = _block_checksums(torch, tr.gathered_state(state).params)
    records_b: list = []
    # the last step of each transport held to the whole-tree path (the
    # compressed one with the residuals of the step before)
    for i in range(SHARDED_B_STEPS):
        state = one_step(tr, state, "b psum", records_b, i == SHARDED_B_STEPS - 1)
    state = tr.reconfigure(state, "compressed_int8")
    for i in range(SHARDED_B_STEPS):
        state = one_step(tr, state, "b compressed_int8", records_b, i == SHARDED_B_STEPS - 1)
    out.update({"coords_b": dict(mesh_b.coords), "restored_at": at,
                "restored_equal": restored == saved, "restore_s": restore_s,
                "records_b": records_b, "reconfig_log": tr.reconfig_log,
                "n_leaves": len(T.leaves(tr.state_sh.comm)),
                "thread_errors": errors, "peak_a_bytes": peak_a,
                "peak_b_bytes": max(peaks + [torch.cuda.max_memory_allocated()])})
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (c) FSDP over data, ZeRO-1 moments over pod (their data dim split
    # further), psum: AdamW's kernels on the moments' blocks, some narrowed
    # out of the parameter's block on a dim past the first
    mesh_c = make_mesh((2, 2), ("pod", "data"), device="cuda:0")
    tr = ReconfigurableTrainer(cfg, shape, mesh_c, tcfg=tcfg, sharding=ShardingConfig(fsdp=True),
                               transport="psum")
    state = tr.init_state(SEED)
    records_c: list = []
    for _ in range(SHARDED_C_STEPS):
        state = one_step(tr, state, "c psum", records_c)
    out.update({"coords_c": dict(mesh_c.coords), "records_c": records_c,
                "peak_c_bytes": torch.cuda.max_memory_allocated()})
    out["peak_memory_bytes"] = max(peak_a, out["peak_b_bytes"], out["peak_c_bytes"])
    return out


def phase_train_sharded(torch) -> dict:
    """Four ranks on the one card: a one-rank run of the same model here,
    then the spawn, then every check on the ranks' records. Returns the
    launches of each kernel, over all ranks."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.mesh import make_mesh, spawn
    from repro_torch.train.trainer import ReconfigurableTrainer

    cfg = get_config("llama3.2-1b").replace(num_layers=TRAIN2_LAYERS)
    shape = ShapeConfig("sharded", TRAIN_SEQ, TRAIN_BATCH, "train")
    tr = ReconfigurableTrainer(cfg, shape, make_mesh((1,), ("data",), device="cuda"),
                               tcfg=TrainConfig(warmup_steps=10, total_steps=TRAIN_STEPS))
    _, hist = tr.run(tr.init_state(SEED), batches_for(cfg, shape), SHARDED_A_STEPS)
    one_rank = [h["loss"] for h in hist]
    del tr, hist
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt4_")
    why = "the ranks share one GPU; NCCL refuses two ranks on one device"
    print(f"train sharded: four processes on cuda:0, gloo ({why}); llama3.2-1b widths, "
          f"{TRAIN2_LAYERS} of 16 layers; global batch {TRAIN_BATCH} x {TRAIN_SEQ}; (a) (data 2, "
          f"model 2) fsdp xla x {SHARDED_A_STEPS}, save; (b) restore onto (pod 2, model 2), "
          f"psum x {SHARDED_B_STEPS}, 2PC to compressed_int8, compressed_int8 x "
          f"{SHARDED_B_STEPS}")
    try:
        t0 = time.perf_counter()
        ranks = spawn("chip_smoke:train_sharded_rank", SHARDED_WORLD, backend="gloo",
                      args=(ckpt,), timeout_s=900.0, reason=why)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    total = {"quantize_pack": 0, "unpack_dequant": 0, "unpack_dequant_sum": 0,
             **dict.fromkeys(ADAMW_KERNELS, 0)}
    checked_whole: set = set()
    at_shape = {"quantize_pack": 0, "unpack_dequant_sum": 0}  # measured, (b)'s steps
    for r in ranks:
        rank = r["rank"]
        check(not r["thread_errors"], f"rank {rank}: exceptions in threads {r['thread_errors']}")
        quarter = r["whole"] / 4
        check(quarter <= r["held"] <= quarter + r["undivided"] * 3 / 4,
              f"rank {rank}: holds {r['held']} parameter bytes, a quarter is {quarter}")
        print(f"train sharded (a), rank {rank} at {r['coords_a']}: holds {r['held']} of "
              f"{r['whole']} parameter bytes ({r['held'] / r['whole']:.6f}; leaves that do "
              f"not split four ways: {r['undivided']} bytes); peak memory outside the "
              f"whole-tree checks {r['peak_memory_bytes'] / 2**30:.2f} GiB "
              f"({r['peak_memory_bytes']} bytes): (a) {r['peak_a_bytes']}, (b) "
              f"{r['peak_b_bytes']} bytes")
        got = [rec["loss"] for rec in r["records_a"]]
        diff = max(abs(a - b) / abs(b) for a, b in zip(got, one_rank))
        check(diff <= SHARDED_RTOL, f"rank {rank}: (a) losses {got}, one rank {one_rank}")
        check(r["restored_at"] == SHARDED_A_STEPS and r["restored_equal"],
              f"rank {rank}: restored step {r['restored_at']}, leaves equal "
              f"{r['restored_equal']}")
        check(r["reconfig_log"] == [{"from": "psum", "to": "compressed_int8", "committed": True,
                                     "at_step": SHARDED_A_STEPS + SHARDED_B_STEPS}],
              f"rank {rank}: {r['reconfig_log']}")
        check(r["n_leaves"] == TRAIN2_LEAVES, f"rank {rank}: {r['n_leaves']} residual leaves")
        for rec in r["records_a"] + r["records_b"]:
            compressed = rec["transport"] == "compressed_int8"
            want = ({"quantize_pack": 1 + TRAIN2_LEAVES, "unpack_dequant": 0,
                     "unpack_dequant_sum": 1 + TRAIN2_LEAVES} if compressed
                    else {"quantize_pack": 0, "unpack_dequant": 0, "unpack_dequant_sum": 0})
            check(rec["launches"] == want, f"rank {rank} step {rec['step']} ({rec['label']}): "
                  f"launches {rec['launches']}, want {want}")
            if compressed:
                for name in ("quantize_pack", "unpack_dequant_sum"):
                    check(rec["routes"][name] == {"vector b256": want[name]},
                          f"rank {rank} step {rec['step']}: {name} routes {rec['routes'][name]}")
            check(math.isfinite(rec["loss"]), f"rank {rank} step {rec['step']}: loss {rec['loss']}")
            check_adamw(f"rank {rank} step {rec['step']} ({rec['label']})", rec["adamw"], 1)
            # the compute split over model ran on the sequence-parallel
            # residual: its gathers and reduce-scatters over S, no sums of
            # whole activations, the bytes the roofline counts
            sent = rec["sent"]
            check(sent.get("scatter_seq@model", 0) > 0 and sent.get("gather_seq@model", 0) > 0
                  and "sum_partials@model" not in sent,
                  f"rank {rank} step {rec['step']}: the split sent {sent}")
            check(sent == rec["counted"], f"rank {rank} step {rec['step']} ({rec['label']}): "
                  f"sent {sent}, analysis.roofline counts {rec['counted']}")
            if rec["label"].startswith("b "):
                # each rank reduces its own shard: nothing of the gradient or
                # its state gathered, its own floats (or blocks) over pod
                gathered = [k for k in sent if k.startswith(("gather_grad", "gather_state"))]
                check(not gathered, f"rank {rank} step {rec['step']}: gathered {gathered}")
                key, want = (("all_gather@pod", RANK_N_BLOCKS * 260) if compressed
                             else ("all_reduce@pod", RANK_NUMEL * 4 + 8))
                check(sent.get(key) == want, f"rank {rank} step {rec['step']}: {key} "
                      f"{sent.get(key)}, want {want}")
                # the wire's one launch of each at the rank's shape; the
                # residuals' at their leaves' blocks
                at = rec["at_rank_shape"]
                want_at = {"quantize_pack": int(compressed), "unpack_dequant": 0,
                           "unpack_dequant_sum": int(compressed)}
                check(at == want_at, f"rank {rank} step {rec['step']}: launches at "
                      f"{RANK_NUMEL} floats {at}, want {want_at}")
                print(f"train sharded (b), rank {rank} step {rec['step']} ({rec['label']}): "
                      f"all_reduce@pod {sent.get('all_reduce@pod', 0)}, all_gather@pod "
                      f"{sent.get('all_gather@pod', 0)} bytes; {sum(sent.values())} in all, "
                      f"equal to analysis.roofline's; launches at {RANK_NUMEL} floats "
                      f"{json.dumps(at)}")
                for name in at_shape:
                    at_shape[name] += at[name]
            if rec["whole"] is not None:
                w = rec["whole"]
                check(w["out_equal"] and w["state_equal"],
                      f"rank {rank} step {rec['step']} ({rec['label']}): own shard against the "
                      f"whole-tree path: output equal {w['out_equal']}, residual equal "
                      f"{w['state_equal']}")
                print(f"train sharded (b), rank {rank} step {rec['step']} ({rec['label']}): "
                      f"output and residual blocks of {w['n_leaves']} leaves bit-equal to the "
                      f"whole-tree path; check {w['s']:.3f} s, its peak memory "
                      f"{w['peak_bytes'] / 2**30:.2f} GiB ({w['peak_bytes']} bytes)")
                checked_whole.add(rec["label"])
            for name in total:
                total[name] += {**rec["launches"], **rec["adamw"]}[name]
        print(f"train sharded (b), rank {rank} at {r['coords_b']}: restored step "
              f"{r['restored_at']} in {r['restore_s']:.3f} s, gathered leaves bit-equal to the "
              "saved ones")
        for part in ("a", "b"):
            rec = r[f"records_{part}"][-1]
            print(f"train sharded ({part}), rank {rank}: AdamW a step {json.dumps(rec['adamw'])}; "
                  f"the optimizer's leaves by ZeRO-1 layout {json.dumps(rec['zero1'])}")
    pairs = 0
    for a in ranks:
        for b in ranks:
            ca, cb = a["coords_b"], b["coords_b"]
            if ca["pod"] < cb["pod"] and ca["model"] == cb["model"]:
                for ra, rb in zip(a["records_b"], b["records_b"]):
                    check(ra["checksums"] == rb["checksums"],
                          f"step {ra['step']}: parameters differ across pod (ranks {a['rank']}, "
                          f"{b['rank']})")
                pairs += 1
    check(pairs == 2, f"{pairs} pod pairs")
    check(checked_whole == {"b psum", "b compressed_int8"},
          f"the whole-tree check ran at {checked_whole}")
    # (c): ZeRO-1 moments, some of them blocks narrowed on a dim past the
    # first (rows of one stride), every leaf on AdamW's kernels
    for r in ranks:
        rank = r["rank"]
        got = [rec["loss"] for rec in r["records_c"]]
        diff = max(abs(a - b) / abs(b) for a, b in zip(got, one_rank))
        check(all(math.isfinite(l) for l in got) and diff <= SHARDED_RTOL,
              f"rank {rank}: (c) losses {got}, one rank {one_rank}")
        for rec in r["records_c"]:
            check_adamw(f"rank {rank} step {rec['step']} ({rec['label']})", rec["adamw"], 1)
            check(rec["sent"] == rec["counted"], f"rank {rank} step {rec['step']} "
                  f"({rec['label']}): sent {rec['sent']}, analysis.roofline counts "
                  f"{rec['counted']}")
            for name in total:
                total[name] += {**rec["launches"], **rec["adamw"]}[name]
        zero1 = r["records_c"][-1]["zero1"]
        check(any(k.endswith(" rows") for k in zero1),
              f"rank {rank}: (c) no ZeRO-1 block narrowed past the first dim: {zero1}")
        print(f"train sharded (c), rank {rank} at {r['coords_c']}: losses {got} (max relative "
              f"difference from one rank {diff:.3e}); AdamW a step "
              f"{json.dumps(r['records_c'][-1]['adamw'])}; the optimizer's leaves by ZeRO-1 "
              f"layout {json.dumps(zero1)}; step ms "
              f"{[round(rec['ms'], 3) for rec in r['records_c']]}; peak "
              f"{r['peak_c_bytes']} bytes")
    pairs = 0
    for a in ranks:
        for b in ranks:
            ca, cb = a["coords_c"], b["coords_c"]
            if ca["pod"] < cb["pod"] and ca["data"] == cb["data"]:
                for ra, rb in zip(a["records_c"], b["records_c"]):
                    check(ra["checksums"] == rb["checksums"],
                          f"(c) step {ra['step']}: parameters differ across pod (ranks "
                          f"{a['rank']}, {b['rank']})")
                pairs += 1
    check(pairs == 2, f"(c): {pairs} pod pairs")
    total["at a rank's shape"] = at_shape
    r0 = ranks[0]
    for rec in r0["records_a"] + r0["records_b"]:
        others = [rr["ms"] for r in ranks[1:] for rr in r["records_a"] + r["records_b"]
                  if rr["step"] == rec["step"]]
        print(f"train sharded: step {rec['step']} {rec['label']}: loss {rec['loss']:.6f}, "
              f"{rec['ms']:.3f} ms (rank 0; ranks 1-3 {[round(m, 3) for m in others]}), bytes "
              f"sent by rank 0 by axis {json.dumps(rec['sent_by_axis'])} "
              f"({json.dumps(rec['sent'])}; equal to analysis.roofline's count), launches "
              f"{json.dumps(rec['launches'])}")
    print(f"train sharded (a): losses {[rec['loss'] for rec in r0['records_a']]} against one "
          f"rank's {one_rank} (tolerance {SHARDED_RTOL} relative)")
    for label in ("a xla", "b psum", "b compressed_int8"):
        ms = [rec["ms"] for r in ranks for rec in r["records_a"] + r["records_b"]
              if rec["label"] == label]
        print(f"train sharded: {label}: median {statistics.median(ms):.3f} ms/step over all "
              f"ranks' {len(ms)} steps (gloo through the host on one shared card, not NCCL); "
              f"peak memory by rank {[r['peak_memory_bytes'] for r in ranks]} bytes")
    print(f"train sharded: launches over all ranks {json.dumps(total)}; spawn to exit "
          f"{wall:.3f} s; every process exited 0; parameters bit-equal across pod after every "
          "step")
    return total


def phase_train_hymba(torch) -> dict:
    """The hybrid family's training path at its published config on one
    rank, through the launcher's ``main``, every counter set to 0 just
    before and read just after."""
    from repro_torch.launch import train

    argv = ["--arch", "hymba-1.5b", "--steps", str(HYMBA_TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--transport", "xla"]
    print("train hymba: python -m repro_torch.launch.train", " ".join(argv))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _reset_all_counts()
    t0 = time.perf_counter()
    run = train.main(argv)
    wall = time.perf_counter() - t0
    launches, taken = _all_counts(), _adamw_taken()
    check(not any(_others(launches).values()), f"train hymba launched kernels: {launches}")
    check_adamw("train hymba", taken, HYMBA_TRAIN_STEPS)
    check(len(run.losses) == HYMBA_TRAIN_STEPS and all(math.isfinite(l) for l in run.losses),
          f"train hymba: losses {run.losses}")
    check(run.n_params == HYMBA_PARAMS, f"train hymba: {run.n_params} parameters")
    print(f"train hymba: launches {json.dumps(launches)} (want 0 of each but AdamW's: the plain "
          f"scan and xla_chunked attention); AdamW {json.dumps(taken)}; {run.n_params} parameters; losses {run.losses}; first step {run.first_ms:.3f} ms, warm "
          f"{run.warm_ms:.3f} ms/step (median of steps 2-{HYMBA_TRAIN_STEPS}), "
          f"{run.tokens_per_s:.1f} tokens/s; peak memory {run.peak_memory_bytes / 2**30:.2f} GiB "
          f"({run.peak_memory_bytes} bytes); step ms {[round(t * 1e3, 3) for t in run.step_s]}; "
          f"main {wall:.3f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _card_routes(torch, moe):
    """``moe.route`` and two wrappers of it: (route, record, follow, the
    recorded ids, [ids alike, calls followed]). ``record`` keeps the
    expert ids of every call, in order; ``follow`` routes each call to the
    recorded ids instead of its own top-k (the gates its own softmax's
    values there, renormalised, and the aux of its probabilities with the
    recorded slot-0 experts, as ``route`` computes them) and counts the
    (token, slot) ids its own top-k would have chosen alike. A near-uniform
    router at a seeded draw has near-ties among 128 experts that one
    bfloat16 step of its input flips, so the card's and the CPU's own
    top-k differ; following the card's ids compares the arithmetic."""
    real, calls, agree = moe.route, [], [0, 0]

    def record(router_w, x2d, cfg):
        out = real(router_w, x2d, cfg)
        calls.append(out[1].cpu())
        return out

    def follow(router_w, x2d, cfg):
        _, own, _ = real(router_w, x2d, cfg)
        ids = calls[agree[1]].to(own.device)
        agree[0] += int((own == ids).sum())
        agree[1] += 1
        probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
        gates = probs.gather(-1, ids)
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        E = cfg.moe.num_experts
        frac = torch.nn.functional.one_hot(ids[:, 0], E).float().mean(dim=0)
        aux = E * torch.sum(frac * probs.mean(dim=0)) * moe.AUX_LOSS_COEF
        return gates, ids, aux

    return real, record, follow, calls, agree


def _family_check(torch, arch: str) -> dict:
    """The first loss and gradient of ``arch`` cut to ``FAMILY_CHECK``'s
    depth, on the card against the CPU: one model drawn on the card from
    the seed, copied to a model on the CPU, the same batch on both; the moe
    family's CPU side routed to the card's expert ids (``_card_routes``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.serve import cut_depth
    from repro_torch.models import moe, registry

    layers, (rows, seq) = FAMILY_CHECK[arch]
    cfg = cut_depth(get_config(arch), layers)
    t0 = time.perf_counter()
    models = {dev: registry.model_class(cfg)(cfg, device=torch.device(dev))
              for dev in ("cuda", "cpu")}
    models["cuda"].init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    with torch.no_grad():
        for (_, p), (_, q) in zip(models["cuda"].named_parameters(),
                                  models["cpu"].named_parameters()):
            q.copy_(p)
    batch = batches_for(cfg, ShapeConfig("check", seq, rows, "train"))(0)
    real, record, follow, calls, agree = _card_routes(torch, moe)
    loss = {}
    try:
        for dev, model in models.items():
            if cfg.family == "moe":
                moe.route = record if dev == "cuda" else follow
            t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            out = registry.loss(model, t)
            out.backward()
            loss[dev] = out.item()
    finally:
        moe.route = real
    if cfg.family == "moe":
        check(agree[1] == len(calls), f"{arch} check: the CPU routed {agree[1]} times, the "
              f"card {len(calls)}")
    diff = total = 0.0
    for (name, p), (_, q) in zip(models["cuda"].named_parameters(),
                                 models["cpu"].named_parameters()):
        check(p.grad is not None and q.grad is not None, f"{arch} check: {name} has no gradient")
        want = q.grad.to("cuda")
        diff += torch.linalg.vector_norm((p.grad - want).double()).item() ** 2
        total += torch.linalg.vector_norm(want.double()).item() ** 2
        del want
    n = sum(p.numel() for p in models["cpu"].parameters())
    del models
    gc.collect()
    torch.cuda.empty_cache()
    routed = sum(c.numel() for c in calls)
    return {"layers": layers, "rows": rows, "seq": seq, "params": n, "loss": loss,
            "loss_rel": abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"]),
            "grad_l2": math.sqrt(diff / total), "s": time.perf_counter() - t0,
            "routed_alike": agree[0] / routed if routed else None}


def phase_train_families(torch) -> dict:
    """Phase 14: the vlm, audio, ssm and moe families' training at their
    published widths on one rank, each through the launcher's ``main`` with
    every kernel counter set to 0 just before and read just after; then one
    profiled warm step of the same trainer built again, and the card against
    the CPU at ``FAMILY_CHECK``'s depth. Returns the launches, summed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh

    total: Counter = Counter()
    for arch, extra, n_params in FAMILY_TRAIN:
        t_phase = time.perf_counter()
        chk = _family_check(torch, arch)
        tag = f"train family {arch}"
        routed = ("" if chk["routed_alike"] is None else
                  f"; the CPU routed to the card's expert ids, its own top-k choosing "
                  f"{chk['routed_alike']:.4f} of the (token, slot) ids alike")
        print(f"{tag}: check at {chk['layers']} layer(s) of the published widths "
              f"({chk['params']} parameters), {chk['rows']} x {chk['seq']}{routed}: first loss card "
              f"{chk['loss']['cuda']:.6f} CPU {chk['loss']['cpu']:.6f}, relative difference "
              f"{chk['loss_rel']:.3e} (tolerance {FAMILY_LOSS_RTOL}); gradient's relative L2 "
              f"distance {chk['grad_l2']:.3e} (tolerance {FAMILY_GRAD_L2}); {chk['s']:.1f} s")
        check(chk["loss_rel"] <= FAMILY_LOSS_RTOL, f"{tag}: card and CPU losses {chk['loss']}")
        check(chk["grad_l2"] <= FAMILY_GRAD_L2, f"{tag}: gradient {chk['grad_l2']} apart")

        argv = ["--arch", arch, "--steps", str(FAMILY_TRAIN_STEPS), "--transport", "xla", *extra]
        print(f"{tag}: python -m repro_torch.launch.train", " ".join(argv))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        _reset_all_counts()
        t0 = time.perf_counter()
        run = train.main(argv)
        wall = time.perf_counter() - t0
        launches, taken = _all_counts(), _adamw_taken()
        total.update(launches)
        check(not any(_others(launches).values()), f"{tag} launched kernels: {launches}")
        check_adamw(tag, taken, FAMILY_TRAIN_STEPS)
        check(len(run.losses) == FAMILY_TRAIN_STEPS and all(math.isfinite(l) for l in run.losses),
              f"{tag}: losses {run.losses}")
        check(run.n_params == n_params, f"{tag}: {run.n_params} parameters, want {n_params}")
        gc.collect()
        torch.cuda.empty_cache()

        tr = train.build(train.parse(argv), make_mesh((1,), ("data",), device="cuda"))
        gen = batches_for(tr.cfg, tr.shape)
        state, _ = tr.run(tr.init_state(SEED), gen, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(state, gen, 1)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        dev = device_events(torch, prof.key_averages())
        busy = sum(us for us, _, _ in dev) / 1e6
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{tag}: launches {json.dumps(launches)} (want 0 of each but AdamW's: xla_chunked "
              f"attention, the plain scans, one rank builds no transport chunnel); AdamW "
              f"{json.dumps(taken)}; {run.n_params} parameters; losses {run.losses}; first step {run.first_ms:.3f} ms, warm "
              f"{run.warm_ms:.3f} ms/step (median of steps 2-{FAMILY_TRAIN_STEPS}), "
              f"{run.tokens_per_s:.1f} tokens/s ({run.tokens_per_step} tokens a step); peak "
              f"memory {run.peak_memory_bytes / 2**30:.2f} GiB ({run.peak_memory_bytes} bytes); "
              f"step ms {[round(t * 1e3, 3) for t in run.step_s]}; main {wall:.3f} s")
        print(f"profile {tag}, one warm step: wall {prof_wall:.4f} s, device busy {busy:.4f} s, "
              f"idle share {1 - busy / prof_wall:.4f}, {sum(c for _, _, c in dev)} device kernels "
              "and copies")
        for us, key, count in dev[:5]:
            print(f"profile {tag}: device {us / 1e3:.3f} ms in {count} x {key[:90]}")
        print(f"{tag}: phase {time.perf_counter() - t_phase:.1f} s")
    return dict(total)


def train_xlstm_rank() -> dict:
    """One rank of phase 15 (run by ``spawn``; every rank runs the same
    calls): xlstm-125m on a mesh of ``pod`` = 2, psum, a 2PC switch, then
    the compressed transport. Returns its per-step records."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.comm import collectives
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.quantize.quantize import (quantize_pack, unpack_dequant,
                                                       unpack_dequant_sum)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

    errors: list = []
    threading.excepthook = lambda a: errors.append(f"{a.thread.name}: {a.exc_value!r}")
    torch.cuda.set_device(0)
    mesh = make_mesh((2,), ("pod",), device="cuda:0")
    cfg = get_config(XLSTM_ARCH)
    shape = ShapeConfig("xlstm2", TRAIN_SEQ, TRAIN_BATCH, "train")
    offers = ["psum", "compressed_int8"]
    tr = ReconfigurableTrainer(cfg, shape, mesh,
                               tcfg=TrainConfig(warmup_steps=10, total_steps=TRAIN_STEPS),
                               transport="psum",
                               hosts=[HostSpec(0, list(offers)), HostSpec(1, list(offers))])
    gen = batches_for(cfg, shape)
    state = tr.init_state(SEED)
    wrappers = {"quantize_pack": quantize_pack, "unpack_dequant": unpack_dequant,
                "unpack_dequant_sum": unpack_dequant_sum}
    records = []

    def one_step(state):
        for w in wrappers.values():
            w.launches = 0
            w.route_launches.clear()
        _reset_adamw()
        sent0 = sum(collectives.SENT.values())
        state, hist = tr.run(state, gen, 1)
        sums = [None] * mesh.size
        dist.all_gather_object(sums, _checksum(torch, state.params))
        records.append({
            "transport": tr.transport_name, "step": state.step, "loss": hist[0]["loss"],
            "ms": tr.step_times[-1] * 1e3,
            "sent_bytes": sum(collectives.SENT.values()) - sent0,
            "launches": {n: w.launches for n, w in wrappers.items()}, "adamw": _adamw_taken(),
            "routes": {n: {f"{r} b{b}": c for (r, b), c in w.route_launches.items()}
                       for n, w in wrappers.items()},
            "params_equal_on_ranks": all(x == sums[0] for x in sums)})
        return state

    for _ in range(XLSTM_PSUM_STEPS):
        state = one_step(state)
    state = tr.reconfigure(state, "compressed_int8")
    for _ in range(XLSTM_COMPRESSED_STEPS):
        state = one_step(state)
    return {"rank": dist.get_rank(), "records": records, "reconfig_log": tr.reconfig_log,
            "n_params": sum(p.numel() for p in tr.model.parameters()),
            "n_leaves": len(T.leaves(step_mod.grad_shapes(tr.model))),
            "thread_errors": errors, "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_train_xlstm_two(torch) -> dict:
    """Phase 15: the compressed transport on xlstm's tree, two ranks on the
    one card; every check on both ranks' records. Returns the launches of
    each kernel, over both ranks."""
    from repro_torch.launch.mesh import spawn

    why = "the ranks share one GPU; NCCL refuses two ranks on one device"
    print(f"train xlstm 2 ranks: two processes on cuda:0, gloo ({why}); {XLSTM_ARCH} at its "
          f"published config; global batch {TRAIN_BATCH} x {TRAIN_SEQ}; psum x "
          f"{XLSTM_PSUM_STEPS}, 2PC to compressed_int8, compressed_int8 x "
          f"{XLSTM_COMPRESSED_STEPS}")
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:train_xlstm_rank", 2, backend="gloo", timeout_s=600.0, reason=why)
    wall = time.perf_counter() - t0
    total = {"quantize_pack": 0, "unpack_dequant": 0, "unpack_dequant_sum": 0,
             **dict.fromkeys(ADAMW_KERNELS, 0)}
    for r in ranks:
        rank = r["rank"]
        check(not r["thread_errors"], f"rank {rank}: exceptions in threads {r['thread_errors']}")
        check(r["n_params"] == XLSTM_PARAMS and r["n_leaves"] == XLSTM_LEAVES,
              f"rank {rank}: {r['n_params']} parameters in {r['n_leaves']} leaves")
        check(r["reconfig_log"] == [{"from": "psum", "to": "compressed_int8", "committed": True,
                                     "at_step": XLSTM_PSUM_STEPS}], f"rank {rank}: {r['reconfig_log']}")
        for rec in r["records"]:
            compressed = rec["transport"] == "compressed_int8"
            want = ({"quantize_pack": 1 + XLSTM_LEAVES, "unpack_dequant": 0,
                     "unpack_dequant_sum": 1 + XLSTM_LEAVES} if compressed
                    else {"quantize_pack": 0, "unpack_dequant": 0, "unpack_dequant_sum": 0})
            check(rec["launches"] == want, f"rank {rank} step {rec['step']}: launches "
                  f"{rec['launches']}, want {want}")
            if compressed:
                for name in ("quantize_pack", "unpack_dequant_sum"):
                    check(rec["routes"][name] == {"vector b256": want[name]},
                          f"rank {rank} step {rec['step']}: {name} routes {rec['routes'][name]}")
            check(rec["params_equal_on_ranks"],
                  f"rank {rank} step {rec['step']}: parameters differ across the ranks")
            check(math.isfinite(rec["loss"]), f"rank {rank} step {rec['step']}: loss {rec['loss']}")
            check_adamw(f"rank {rank} step {rec['step']}", rec["adamw"], 1)
            for name in total:
                total[name] += {**rec["launches"], **rec["adamw"]}[name]
    r0, r1 = ranks[0]["records"], ranks[1]["records"]
    for rec, other in zip(r0, r1):
        print(f"train xlstm 2 ranks: step {rec['step']} {rec['transport']}: loss "
              f"{rec['loss']:.6f}, {rec['ms']:.3f} ms (rank 0; rank 1 {other['ms']:.3f} ms), "
              f"{rec['sent_bytes']} bytes sent by rank 0, launches {json.dumps(rec['launches'])}, "
              f"AdamW {json.dumps(rec['adamw'])}, parameters bit-equal on both ranks")
    print(f"train xlstm 2 ranks: {XLSTM_LEAVES} reference leaves; launches over both ranks "
          f"{json.dumps(total)}; peak memory by rank "
          f"{[r['peak_memory_bytes'] for r in ranks]} bytes; spawn to exit {wall:.3f} s; both "
          "processes exited 0")
    return total


def moe_mesh_rank(params) -> dict:
    """One rank of phase 16 (run by ``spawn``): the moe training step on
    (data 2, model 2) with each mesh dispatch, on the card and then on the
    CPU, from the same parameters ``params`` (the reference's tree)."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import roofline
    from repro_torch.comm import collectives
    from repro_torch.comm.moe_dispatch import configure
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.mesh import AbstractMesh, make_mesh
    from repro_torch.models import registry
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import ReconfigurableTrainer

    errors: list = []
    threading.excepthook = lambda a: errors.append(f"{a.thread.name}: {a.exc_value!r}")
    torch.cuda.set_device(0)
    shape = ShapeConfig("moe mesh", MOE_MESH_SEQ, MOE_MESH_BATCH, "train")
    tcfg = TrainConfig(warmup_steps=10, total_steps=TRAIN_STEPS)
    out = {"rank": dist.get_rank(), "thread_errors": errors}
    for device in ("cuda:0", "cpu"):
        mesh = make_mesh((2, 2), ("data", "model"), device=device)
        out[f"coords {device}"] = dict(mesh.coords)
        for impl in MOE_MESH_DISPATCHES:
            cfg = configure(get_smoke_config(MOE_ARCH), impl)
            tr = ReconfigurableTrainer(cfg, shape, mesh, sharding=ShardingConfig(fsdp=True),
                                       tcfg=tcfg, transport="xla")
            state = tr.init_state(params=params)
            gen = batches_for(cfg, shape)
            _reset_all_counts()
            local, reported, sent = [], [], Counter()
            for step in range(MOE_MESH_STEPS):
                with torch.no_grad():
                    rows = step_mod.local_rows(gen(step), mesh)
                    local.append(registry.loss(tr.model, rows, batch_split=2).item())
                sent0 = dict(collectives.SENT)
                state, hist = tr.run(state, gen, 1)
                sent.update({k: v - sent0.get(k, 0) for k, v in collectives.SENT.items()
                             if v > sent0.get(k, 0)})
                reported.append(hist[0]["loss"])
            counted = roofline.step_collectives(
                cfg, shape, AbstractMesh(dict(mesh.shape), rank=mesh.rank),
                sh=ShardingConfig(fsdp=True), tcfg=tcfg)
            out[(device, impl)] = {
                "local": local, "reported": reported,
                "ms": [t * 1e3 for t in tr.step_times], "launches": _all_counts(),
                "adamw": _adamw_taken(), "sent": dict(sent),
                "counted": {k: v * MOE_MESH_STEPS for k, v in counted.items()},
                "split": repr(tr.model.train_split(MOE_MESH_BATCH // 2, MOE_MESH_SEQ, 2))}
            del tr, state
    return out


def phase_train_moe_mesh(torch) -> dict:
    """Phase 16: the moe dispatches' backward on CUDA tensors, four gloo
    ranks on (data 2, model 2) at qwen3-moe's smoke widths, against the same
    ranks' run on the CPU. Returns the launches, summed over the ranks."""
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import registry
    from repro_torch.models.stacking import stack_layers

    cfg = get_smoke_config(MOE_ARCH)
    model = registry.model_class(cfg)(cfg, device=torch.device("cpu"))
    model.init_weights(torch.Generator().manual_seed(SEED))
    params = T.map(lambda t: t.detach().numpy(),
                   stack_layers(dict(model.named_parameters()), model.stacks()))
    why = "the ranks share one GPU; NCCL refuses two ranks on one device"
    print(f"train moe mesh: four processes on cuda:0, gloo ({why}); {cfg.name} (the published "
          "widths gathered on four ranks of one card do not fit: the smoke widths), (data 2, "
          f"model 2), fsdp, global batch {MOE_MESH_BATCH} x {MOE_MESH_SEQ}; "
          f"{MOE_MESH_STEPS} steps with each of {MOE_MESH_DISPATCHES} on the card, then the same "
          "on the CPU in the same processes")
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:moe_mesh_rank", 4, backend="gloo", args=(params,),
                  timeout_s=600.0, reason=why)
    wall = time.perf_counter() - t0
    total: Counter = Counter()
    for r in ranks:
        check(not r["thread_errors"], f"rank {r['rank']}: exceptions in threads")
        for impl in MOE_MESH_DISPATCHES:
            rec = r[("cuda:0", impl)]
            total.update(rec["launches"])
            check(not any(_others(rec["launches"]).values()),
                  f"rank {r['rank']} {impl}: launched kernels {rec['launches']}")
            check_adamw(f"rank {r['rank']} {impl}", rec["adamw"], MOE_MESH_STEPS)
            check(all(math.isfinite(l) for l in rec["local"] + rec["reported"]),
                  f"rank {r['rank']} {impl}: losses {rec}")
            grads = {k for k in rec["sent"] if k.startswith("grad_")}
            want = {"alltoall": "grad_all_to_all@model",
                    "allgather": "grad_reduce_scatter@model"}[impl]
            check(want in grads, f"rank {r['rank']} {impl}: backward collectives {grads}")
            # the compute split: the rows as the rank's positions, the
            # banks as its experts; no bank or rows' slice gathered back
            check("experts=True" in rec["split"] and "grad_all_gather@model" not in grads
                  and rec["sent"].get("gather_seq@model", 0) > 0,
                  f"rank {r['rank']} {impl}: split {rec['split']}, sent {rec['sent']}")
            check(rec["sent"] == rec["counted"], f"rank {r['rank']} {impl}: sent "
                  f"{rec['sent']}, analysis.roofline counts {rec['counted']}")
    for impl in MOE_MESH_DISPATCHES:
        for device in ("cuda:0", "cpu"):
            by_data: dict = {}
            for r in ranks:
                d = r[f"coords {device}"]["data"]
                by_data.setdefault(d, []).append(r[(device, impl)]["local"])
            for d, losses in by_data.items():
                check(all(l == losses[0] for l in losses),
                      f"{impl} on {device}: losses differ in the model group of data {d}: "
                      f"{losses}")
        card = ranks[0][("cuda:0", impl)]
        cpu = ranks[0][("cpu", impl)]
        diff = max(abs(a - b) / abs(b) for a, b in zip(card["reported"], cpu["reported"]))
        check(diff <= MOE_MESH_RTOL, f"{impl}: card losses {card['reported']}, CPU "
              f"{cpu['reported']}")
        ms = [m for r in ranks for m in r[("cuda:0", impl)]["ms"]]
        print(f"train moe mesh {impl}: losses on the card {card['reported']}, on the CPU "
              f"{cpu['reported']}: max relative difference {diff:.3e} (tolerance "
              f"{MOE_MESH_RTOL}); each rank's own loss bit-equal across its model group on "
              f"both; card step ms {[round(m, 3) for m in ms]} (all ranks, gloo through the "
              f"host); split {card['split']}; rank 0's bytes by op@axis over "
              f"{MOE_MESH_STEPS} steps {json.dumps(card['sent'])} (equal to "
              "analysis.roofline's count on every rank)")
    print(f"train moe mesh: launches over all ranks {json.dumps(dict(total))}; spawn to exit "
          f"{wall:.3f} s; every process exited 0")
    return dict(total)


def _audio_mesh_setup():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import serve

    cfg = serve.cut_depth(get_config(AUDIO_ARCH), AUDIO_MESH_LAYERS)
    shape = ShapeConfig("audio mesh", AUDIO_MESH_SEQ, AUDIO_MESH_BATCH, "train")
    return cfg, shape, TrainConfig(warmup_steps=10, total_steps=TRAIN_STEPS)


def audio_mesh_rank() -> dict:
    """One rank of phase 17 (run by ``spawn``): the encoder-decoder's
    training steps on (data 2, model 2), FSDP over data, on the compute
    split over model; each step's bytes by ``op@axis`` beside
    ``analysis.roofline``'s count."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import roofline
    from repro_torch.comm import collectives
    from repro_torch.configs.base import ShardingConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.mesh import AbstractMesh, make_mesh
    from repro_torch.models.pshard import model_split
    from repro_torch.train.trainer import ReconfigurableTrainer

    errors: list = []
    threading.excepthook = lambda a: errors.append(f"{a.thread.name}: {a.exc_value!r}")
    torch.cuda.set_device(0)
    cfg, shape, tcfg = _audio_mesh_setup()
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda:0")
    sh = ShardingConfig(fsdp=True)
    tr = ReconfigurableTrainer(cfg, shape, mesh, sharding=sh, tcfg=tcfg, transport="xla")
    state = tr.init_state(SEED)
    gen = batches_for(cfg, shape)
    counted = dict(roofline.step_collectives(
        cfg, shape, AbstractMesh(dict(mesh.shape), rank=mesh.rank), sh=sh, tcfg=tcfg))
    _reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    records = []
    for _ in range(AUDIO_MESH_STEPS):
        sent0 = dict(collectives.SENT)
        state, hist = tr.run(state, gen, 1)
        records.append({"loss": hist[0]["loss"], "ms": tr.step_times[-1] * 1e3,
                        "sent": {k: v - sent0.get(k, 0) for k, v in collectives.SENT.items()
                                 if v > sent0.get(k, 0)}})
    split = model_split(cfg, mesh).at(AUDIO_MESH_SEQ, AUDIO_MESH_SEQ // cfg.encdec.src_ratio)
    return {"rank": dist.get_rank(), "coords": dict(mesh.coords), "records": records,
            "counted": counted, "launches": _all_counts(), "adamw": _adamw_taken(),
            "split": repr(split),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "thread_errors": errors}


def phase_train_audio_mesh(torch) -> dict:
    """Phase 17: the encoder-decoder trained on the compute split over
    model (its heads, both stacks' residuals over their lengths, the
    vocabulary) by four gloo ranks on the card, against one rank's run of
    the same model here. Returns the launches, summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.mesh import make_mesh, spawn
    from repro_torch.train.trainer import ReconfigurableTrainer

    cfg, shape, tcfg = _audio_mesh_setup()
    full = get_config(AUDIO_ARCH).encdec
    tr = ReconfigurableTrainer(cfg, shape, make_mesh((1,), ("data",), device="cuda"), tcfg=tcfg)
    _, hist = tr.run(tr.init_state(SEED), batches_for(cfg, shape), AUDIO_MESH_STEPS)
    one_rank = [h["loss"] for h in hist]
    del tr, hist
    gc.collect()
    torch.cuda.empty_cache()
    why = "the ranks share one GPU; NCCL refuses two ranks on one device"
    print(f"train audio mesh: four processes on cuda:0, gloo ({why}); {AUDIO_ARCH} at its "
          f"published widths, {AUDIO_MESH_LAYERS} + {AUDIO_MESH_LAYERS} of its "
          f"{full.enc_layers} + {full.dec_layers} layers, (data 2, model 2), fsdp, global batch "
          f"{AUDIO_MESH_BATCH} x {AUDIO_MESH_SEQ} (source {AUDIO_MESH_SEQ // 4} frames), "
          f"{AUDIO_MESH_STEPS} steps; one rank's losses {one_rank}")
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:audio_mesh_rank", 4, backend="gloo", timeout_s=600.0, reason=why)
    wall = time.perf_counter() - t0
    total: Counter = Counter()
    for r in ranks:
        rank = r["rank"]
        check(not r["thread_errors"], f"rank {rank}: exceptions in threads")
        total.update(r["launches"])
        check(not any(_others(r["launches"]).values()),
              f"rank {rank}: launched kernels {r['launches']}")
        check_adamw(f"train audio mesh rank {rank}", r["adamw"], AUDIO_MESH_STEPS)
        check("src_seq=slice(" in r["split"] and "seq=slice(" in r["split"]
              and "heads=Heads(" in r["split"], f"rank {rank}: split {r['split']}")
        got = [rec["loss"] for rec in r["records"]]
        diff = max(abs(a - b) / abs(b) for a, b in zip(got, one_rank))
        check(all(math.isfinite(l) for l in got) and diff <= SHARDED_RTOL,
              f"rank {rank}: losses {got}, one rank {one_rank}")
        for i, rec in enumerate(r["records"]):
            sent = rec["sent"]
            check("sum_partials@model" not in sent and sent.get("gather_seq@model", 0) > 0
                  and sent.get("scatter_seq@model", 0) > 0,
                  f"rank {rank} step {i}: the split sent {sent}")
            check(sent == r["counted"], f"rank {rank} step {i}: sent {sent}, "
                  f"analysis.roofline counts {r['counted']}")
        print(f"train audio mesh: rank {rank} at {r['coords']}: losses {got} (max relative "
              f"difference from one rank {diff:.3e}, tolerance {SHARDED_RTOL}); step ms "
              f"{[round(rec['ms'], 3) for rec in r['records']]} (gloo through the host); peak "
              f"{r['peak_memory_bytes'] / 2**30:.2f} GiB ({r['peak_memory_bytes']} bytes); "
              f"split {r['split']}; bytes a step by op@axis {json.dumps(r['records'][0]['sent'])}"
              " (equal to analysis.roofline's count)")
    print(f"train audio mesh: launches over all ranks {json.dumps(dict(total))}; spawn to exit "
          f"{wall:.3f} s; every process exited 0")
    return dict(total)


def _xlstm_mesh_setup():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import serve

    cfg = serve.cut_depth(get_config(XLSTM_ARCH), XLSTM_MESH_LAYERS)
    shape = ShapeConfig("xlstm mesh", XLSTM_MESH_SEQ, XLSTM_MESH_BATCH, "train")
    return cfg, shape, TrainConfig(warmup_steps=10, total_steps=TRAIN_STEPS)


def xlstm_mesh_rank() -> dict:
    """One rank of phase 18 (run by ``spawn``): xLSTM's training steps on
    (data 1, model 2), its blocks split over model; each step's bytes by
    ``op@axis`` beside ``analysis.roofline``'s count."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import roofline
    from repro_torch.comm import collectives
    from repro_torch.configs.base import ShardingConfig
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.mesh import AbstractMesh, make_mesh
    from repro_torch.models.pshard import model_split
    from repro_torch.train.trainer import ReconfigurableTrainer

    errors: list = []
    threading.excepthook = lambda a: errors.append(f"{a.thread.name}: {a.exc_value!r}")
    torch.cuda.set_device(0)
    cfg, shape, tcfg = _xlstm_mesh_setup()
    mesh = make_mesh((1, 2), ("data", "model"), device="cuda:0")
    sh = ShardingConfig()
    tr = ReconfigurableTrainer(cfg, shape, mesh, sharding=sh, tcfg=tcfg, transport="xla")
    state = tr.init_state(SEED)
    gen = batches_for(cfg, shape)
    counted = dict(roofline.step_collectives(
        cfg, shape, AbstractMesh(dict(mesh.shape), rank=mesh.rank), sh=sh, tcfg=tcfg))
    _reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    records = []
    for _ in range(XLSTM_MESH_STEPS):
        sent0 = dict(collectives.SENT)
        state, hist = tr.run(state, gen, 1)
        records.append({"loss": hist[0]["loss"], "ms": tr.step_times[-1] * 1e3,
                        "sent": {k: v - sent0.get(k, 0) for k, v in collectives.SENT.items()
                                 if v > sent0.get(k, 0)}})
    return {"rank": dist.get_rank(), "coords": dict(mesh.coords), "records": records,
            "counted": counted, "launches": _all_counts(), "adamw": _adamw_taken(),
            "split": repr(model_split(cfg, mesh).at(XLSTM_MESH_SEQ)),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "thread_errors": errors}


def phase_train_xlstm_mesh(torch) -> dict:
    """Phase 18: xLSTM trained on its blocks' split over model (the
    mLSTM's heads, the sLSTM's channels, its MLP's width, the vocabulary) by
    two gloo ranks on the card, against one rank's run of the same model
    here. Returns the launches, summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.mesh import make_mesh, spawn
    from repro_torch.train.trainer import ReconfigurableTrainer

    t_phase = time.perf_counter()
    cfg, shape, tcfg = _xlstm_mesh_setup()
    tr = ReconfigurableTrainer(cfg, shape, make_mesh((1,), ("data",), device="cuda"), tcfg=tcfg)
    _, hist = tr.run(tr.init_state(SEED), batches_for(cfg, shape), XLSTM_MESH_STEPS)
    one_rank = [h["loss"] for h in hist]
    del tr, hist
    gc.collect()
    torch.cuda.empty_cache()
    why = "the ranks share one GPU; NCCL refuses two ranks on one device"
    print(f"train xlstm mesh: two processes on cuda:0, gloo ({why}); {XLSTM_ARCH} at its "
          f"published widths, {XLSTM_MESH_LAYERS} of its {get_config(XLSTM_ARCH).num_layers} "
          f"layers (one mLSTM, one sLSTM), (data 1, model 2), global batch {XLSTM_MESH_BATCH} "
          f"x {XLSTM_MESH_SEQ}, {XLSTM_MESH_STEPS} steps; one rank's losses {one_rank}")
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:xlstm_mesh_rank", 2, backend="gloo", timeout_s=600.0, reason=why)
    wall = time.perf_counter() - t0
    total: Counter = Counter()
    for r in ranks:
        rank = r["rank"]
        check(not r["thread_errors"], f"rank {rank}: exceptions in threads")
        total.update(r["launches"])
        check(not any(_others(r["launches"]).values()),
              f"rank {rank}: launched kernels {r['launches']}")
        check_adamw(f"train xlstm mesh rank {rank}", r["adamw"], XLSTM_MESH_STEPS)
        check(r["split"].startswith("Split(heads=Heads(") and "channels=slice(" in r["split"]
              and "d_ff=slice(" in r["split"] and "seq=None" in r["split"],
              f"rank {rank}: split {r['split']}")
        got = [rec["loss"] for rec in r["records"]]
        diff = max(abs(a - b) / abs(b) for a, b in zip(got, one_rank))
        check(all(math.isfinite(l) for l in got) and diff <= SHARDED_RTOL,
              f"rank {rank}: losses {got}, one rank {one_rank}")
        for i, rec in enumerate(r["records"]):
            sent = rec["sent"]
            check(sent.get("sum_partials@model", 0) > 0
                  and sent.get("gather_channels@model", 0) > 0
                  and sent.get("grad_all_reduce@model", 0) > 0
                  and "gather_param@model" not in sent,
                  f"rank {rank} step {i}: the split sent {sent}")
            check(sent == r["counted"], f"rank {rank} step {i}: sent {sent}, "
                  f"analysis.roofline counts {r['counted']}")
        print(f"train xlstm mesh: rank {rank} at {r['coords']}: losses {got} (max relative "
              f"difference from one rank {diff:.3e}, tolerance {SHARDED_RTOL}); step ms "
              f"{[round(rec['ms'], 3) for rec in r['records']]} (gloo through the host); peak "
              f"{r['peak_memory_bytes'] / 2**30:.2f} GiB ({r['peak_memory_bytes']} bytes); "
              f"split {r['split']}; bytes a step by op@axis {json.dumps(r['records'][0]['sent'])}"
              " (equal to analysis.roofline's count)")
    print(f"train xlstm mesh: launches over all ranks {json.dumps(dict(total))}; spawn to exit "
          f"{wall:.3f} s; the phase {time.perf_counter() - t_phase:.3f} s; every process "
          "exited 0")
    return dict(total)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch import backend
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}", file=sys.stderr)
        return 2
    threading.excepthook = _record_thread_error
    t_main = time.perf_counter()
    smi = _clock("backend", phase_backend, torch, backend)
    print(f"memory rate used for the bound: H100 SXM {hw('hbm_bw') / 1e12} TB/s "
          "(repro_torch.launch.mesh.HW)")
    timed = _clock("quantize kernels", phase_kernels, torch)
    flash_build_report(backend)
    flash = _clock("flash attention", phase_flash, torch)
    launches, by_route, batches = _clock("connection", phase_main_path, torch)
    _clock("connection profile", phase_profile, torch, batches)
    paths = {"connection": dict(launches), "wan": _clock("wan", phase_wan, torch)}
    paths["serve llama3.2-1b"] = _clock("serve llama3.2-1b", phase_serve, torch, "llama3.2-1b",
                                        1_235_814_400, LOGITS_TOL)
    _clock("analysis", phase_analysis, torch, smi, paths["serve llama3.2-1b"]["warm prefill ms"])
    scan = _clock("ssm scan", phase_ssm_scan, torch)
    paths["serve hymba-1.5b"] = _clock("serve hymba-1.5b", phase_serve, torch, "hymba-1.5b",
                                       1_663_080_000, HYMBA_LOGITS_TOL)
    for arch, n_params, tol, layers in NEW_SERVE:
        paths[f"serve {arch}"] = _clock(f"serve {arch}", phase_serve, torch, arch, n_params,
                                        tol, layers)
    paths.update(_clock("serve sharded", phase_serve_sharded, torch, flash["checked"]))
    dsum = _clock("dequantize-sum", phase_sum_kernel, torch)
    opt = _clock("adamw", phase_adamw, torch)
    for path, phase, args in (("train 1 rank", phase_train_one, (1_235_814_400,)),
                              ("train 2 ranks", phase_train_two, ()),
                              ("train sharded", phase_train_sharded, ()),
                              ("train hymba", phase_train_hymba, ()),
                              ("train families", phase_train_families, ()),
                              ("train xlstm 2 ranks", phase_train_xlstm_two, ()),
                              ("train moe mesh", phase_train_moe_mesh, ()),
                              ("train audio mesh", phase_train_audio_mesh, ()),
                              ("train xlstm mesh", phase_train_xlstm_mesh, ())):
        paths[path] = _clock(path, phase, torch, *args)
    print("phase seconds (ssm scan includes selective scan):",
          json.dumps({k: round(v, 1) for k, v in PHASE_S.items()}),
          f"main {time.perf_counter() - t_main:.1f} s")
    names = ("quantize_pack", "unpack_dequant", "unpack_dequant_sum", "flash_attention",
             "selective_scan", "ssm_scan_chunk", *ADAMW_KERNELS)
    # every serve and train path for every kernel, zeros included; the
    # connection and WAN paths where the kernel ran
    by_path = {name: {path: n.get(name, 0) for path, n in paths.items()
                      if n.get(name) or path.startswith(("train", "serve"))}
               for name in names}
    print("launches by path:", json.dumps(by_path))
    kernels = []
    # the quantize kernels: the numbers at block 256 on top, and each block
    # of the main path with its launches there and both routes' times
    for name in ("quantize_pack", "unpack_dequant"):
        r = timed[(name, 256)]
        blocks = {str(b): {"launches": by_route[name].get(f"vector b{b}", 0),
                           **{k: timed[(name, b)][k] for k in
                              ("ms", "plain_ms", "bound_ms", "routes")}} for b in BLOCKS}
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": (launches[name] + paths["wan"][name]
                                     + paths["train 2 ranks"][name]
                                     + paths["train sharded"][name]
                                     + paths["train xlstm 2 ranks"][name]),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "launches_by_path": by_path[name], "launches_by_route": by_route[name],
                        "blocks": blocks})
    # the wire at a rank's own shard of the sharded phase's gradient, with
    # its launches there (one a compressed step and rank)
    at_shape = paths["train sharded"]["at a rank's shape"]
    kernels[0]["rank_shape"] = {**dsum["rank quantize_pack"],
                                "launches": at_shape["quantize_pack"]}
    # the n-way dequantize-sum: its numbers at n = 2 (the two-rank path's
    # gradient) on top, n = 4 beside; launches of the two training paths
    # that compress
    kernels.append({"name": "unpack_dequant_sum", "route": "cuda", "source": SOURCE,
                    "replaces": SUM_REPLACES,
                    "launches": (paths["train 2 ranks"]["unpack_dequant_sum"]
                                 + paths["train sharded"]["unpack_dequant_sum"]
                                 + paths["train xlstm 2 ranks"]["unpack_dequant_sum"]),
                    "max_abs_err": dsum["max_abs_err"],
                    **{k: dsum[2][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                    "library_ms": None, "launches_by_path": by_path["unpack_dequant_sum"],
                    "n4": {k: dsum[4][k] for k in ("ms", "plain_ms", "bound_ms", "bytes")},
                    "rank_shape": {**dsum["rank"],
                                   "launches": at_shape["unpack_dequant_sum"]}})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # B3's launches: every serve path's; its numbers at llama's prefill on
    # top, this slice's shapes under "cases", each with the launches of its
    # shape over the serve paths. B4's: the hymba serve run's
    serve_paths = [n for path, n in paths.items() if path.startswith("serve")]
    for label, c in flash["cases"].items():
        key = _shape_key(c["q"], c["kv"], c["causal"])
        c["launches"] = sum(n["flash by shape"].get(key, 0) for n in serve_paths)
        check(c["launches"] > 0, f"flash case {label}: no serve path launched {key}")
    kernels.append({"name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
                    "replaces": FLASH_REPLACES,
                    "launches": sum(n["flash_attention"] for n in serve_paths),
                    **{k: flash[k] for k in keys}, "launches_by_path": by_path["flash_attention"],
                    "cases": flash["cases"]})
    # B4's serving route, the fused scan: its numbers at hymba's prefill on
    # top with the one-rank prefill's launches (one a layer), the decode
    # step with the one-rank decode's and the rank's channels with the hymba
    # mesh path's (every one of them on its d_in / 2 channels)
    fused = scan["fused"]
    one = paths["serve hymba-1.5b"]["selective_scan"]
    fused["prefill"]["launches"] = one // (SERVE_GEN + 1)
    fused["decode step"]["launches"] = one - fused["prefill"]["launches"]
    fused["S 300"]["launches"] = 0
    fused[SSM_LOCAL]["launches"] = sum(
        n["selective_scan"] for path, n in paths.items()
        if path.startswith("serve sharded hymba-1.5b"))
    check(fused[SSM_LOCAL]["launches"] > 0, "the hymba mesh path launched no selective_scan")
    kernels.append({"name": "selective_scan", "route": "cuda", "source": SSM_SOURCE,
                    "replaces": SSM_REPLACES,
                    "launches": sum(n["selective_scan"] for n in serve_paths),
                    **{k: fused["prefill"][k] for k in keys},
                    "launches_by_path": by_path["selective_scan"],
                    "cases": {label: c for label, c in fused.items() if label != "prefill"}})
    # the chunk scan, the TPU kernel's literal counterpart: checked and timed
    # above, launched by no path since the fused scan took its place
    scan["cases"][SSM_LOCAL]["launches"] = scan["cases"]["decode step"]["launches"] = 0
    kernels.append({"name": "ssm_scan_chunk", "route": "cuda", "source": SSM_SOURCE,
                    "replaces": SSM_REPLACES,
                    "launches": sum(n["ssm_scan_chunk"] for n in serve_paths),
                    **{k: scan[k] for k in keys}, "launches_by_path": by_path["ssm_scan_chunk"],
                    "serving_route": "selective_scan", "cases": scan["cases"]})
    # AdamW's two passes a leaf: their numbers at llama3.2-1b's leaves, the
    # launches of every training path (norm_scale, once a step, beside sumsq)
    train_paths = [n for path, n in paths.items() if path.startswith("train")]
    for name in ("sumsq", "adamw_step"):
        kernels.append({"name": name, "route": "cuda", "source": ADAMW_SOURCE,
                        "replaces": ADAMW_REPLACES,
                        "launches": sum(n.get(name, 0) for n in train_paths),
                        "max_abs_err": opt["max_abs_err"] if name == "sumsq" else 0.0,
                        **{k: opt[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                        "library_ms": None, "launches_by_path": by_path[name],
                        "shape": f"{ADAMW_ARCH}'s {opt['leaves']} leaves, {opt['parameters']} "
                                 "float32 parameters, bfloat16 moments"})
    kernels[-2]["norm_scale"] = {"launches": sum(n.get("norm_scale", 0) for n in train_paths),
                                 "launches_by_path": by_path["norm_scale"]}
    kernels[-1]["update"] = opt["update"]  # the whole update, host enqueue beside it
    check(all(k["launches"] > 0 for k in kernels[-2:]), "no training path launched AdamW's kernels")
    check(not THREAD_ERRORS, f"exceptions in threads: {THREAD_ERRORS}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
