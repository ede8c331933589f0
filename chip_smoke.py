#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order, but 18-19 run first, after 2, in a child process of
their own (gpt3-1.5b's graph runs need the card to themselves), 20-21
next in another (qwen2-moe-a2.7b: 28.6 GB of weights to serve, ~60 GiB to
train), 22-23 next in a third (deepseek-v3-671b: 50 GB of weights to
serve; in both the training phase first, in a fresh process, as the
memory record it is gated against was measured), 24-27 next in a fourth
(whisper-tiny and llava-next-mistral-7b, the training phases first),
28-29 in a fifth (xlstm-350m), 30-31 in a sixth (recurrentgemma-9b) and
32-33 in a seventh (internlm2-1.8b at seq 4096),
17 after 7, and 16 with its half of 13, then 13's held-out runs,
last, each in a child process of its own (a fresh process, as the
launcher runs); any failed check raises and the exit code is not 0.
internlm2-1.8b's training phases (9-16 and 13's held-out runs) run at
T_LAYERS = 8 of its 24 layers, its serving ones (5-7) at full depth:

1. build   -- compile every CUDA source of ``src/repro_torch/kernels/csrc/``
              with nvcc (sm_90a) into ``build/repro_torch/``, all at once.
2. card    -- the card's name and power limit from nvidia-smi.
3. kernels -- each kernel against its plain PyTorch version on the card at
              the shapes its path gives it, with device times (CUDA events
              around a CUDA graph of many calls) of the kernel, the plain
              version and one PyTorch library call, and the bound.  RMSNorm:
              first a sweep at every width of the port's dense configs and
              deepseek-v3-671b's (48, 64, 2048, 2304, 4096, 5120, 6144,
              7168, 8192), x and g each in bf16
              and f32, N in {1, 2, 1000, 4100}, plus views one element off
              their allocation and rows not a multiple of 16 bytes, each on
              the path its plan names (bulk / latency / rowwise); then the
              serving shapes, gpt3-1.5b's training rows (1024 x 2304),
              gemma2-2b's serving rows (4100 x 2304 and 1 x 2304) and
              deepseek-v3-671b's (1024 x 7168 and 2 x 7168), each
              with its path (every main-path shape of 1024 rows or more on
              bulk, the decode rows on latency) and timed in turns against
              F.rms_norm (kernel, library, library, kernel), warm (inputs
              in L2, as on the path) and, at 1000 rows or more, cold (x and
              y rotated over copies of more than 100 MB, twice the L2).
              wgrad_accum at the four (H, F) shapes of the training step's
              W ops (N = 1024, bf16 a/g, fp32 acc), plus a ragged N, fp32
              and ragged shapes, and gpt3-1.5b's (2304, 2304), (2304, 9216),
              (9216, 2304), all on wgmma, and qwen2-moe-a2.7b's shared
              experts (2048, 5632) and (5632, 2048) on wgmma and its fp32
              router (2048, 60) on fma, and deepseek-v3-671b's mla W ops
              (7168, 1536), (1536, 24576), (7168, 576) (a ragged last
              tile), (512, 16384), (16384, 7168) and shared expert (7168,
              2048), (2048, 7168) on wgmma and its cut's fp32 router
              (7168, 16) on fma, and llava-next-mistral-7b's W ops
              (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096) at
              N = 1600 and its front_proj (1024, 4096) at N = 576, and
              whisper-tiny's (384, 384), (384, 1536), (1536, 384) at the
              encoder's N = 1500 and the decoder's N = 448, on wgmma, and
              xlstm-350m's (1024, 1024) at N = 2048 on wgmma and its
              (1024, 4) gate products on thin, recurrentgemma-9b's
              (4096, 4096), (4096, 256), (4096, 12288), (12288, 4096) on
              wgmma, internlm2's four at phase 32's N = 4096 (RMSNorm:
              llava's, whisper's and xlstm's rows too, 384 and 1024 in the
              sweep, and phase 32's 4096 x 2048):
              it adds into a clone of acc in
              place and is held against the plain version on the original,
              and a second launch on another clone must agree bit for bit;
              its path (wgmma / thin / mma_sync / fma) is printed per
              shape, and for every fp32 and thin shape its plan (tile,
              split, cluster and grid sizes, N's slices), for every fp32
              one the errors of kernel and plain
              version against an fp64 sum, to which the routers are held
              at the stock 1e-5 (deepseek's against the plain version at
              WGRAD_FP32_N1024_ATOL); kernel and library are timed in
              turns, and the wrapper's eager host time per call is
              measured.  slstm_scan (the port's own kernel: the sLSTM time
              loop, forward and backward) at xlstm-350m's training shape
              (1, 2048, 1024) and its serving's prefills (2, 512, 1024)
              and (2, 513, 1024) against the plain loop: h and the state
              bit for bit, the gradients within SLSTM_GRAD_RTOL, two
              launches bit for bit; at the training shape device ms
              beside the plain loop's and the bound (bytes, operations
              and the 2 s-step chain) and the design's own byte floor
              (the 17 arrays the pair moves).
4. reduced -- reduced internlm2, gpt3-1.5b, gemma2-2b, qwen2-moe-a2.7b,
              deepseek-v3-671b, llava-next-mistral-7b, whisper-tiny,
              xlstm-350m and recurrentgemma-9b
              (float32; llava and whisper with their patches and frames)
              served on cuda and on cpu:
              logits within 1e-4 and identical greedy tokens (gemma2's
              19-token prompt rolls its ring of 8), and for the moe models
              identical routing (every moe call's top-k experts and slot
              positions).
5. serve   -- internlm2-1.8b at full width and depth (bf16, random weights
              from a seed): 4 pipeline stages on the one card, 8 request
              groups of 2, 512-token prompts, 4 greedy tokens.  Kernel
              launch counts are read around this run only.
6. consistency -- decoding token s after a prefill of s tokens matches the
              last position of a prefill of s + 1 tokens, at full width.
7. profile -- the device's busy share in prefill and in decode, and the
              kernels that take the device time, from torch.profiler.
8. train-reduced -- reduced internlm2, gpt3-1.5b, gemma2-2b,
              qwen2-moe-a2.7b, deepseek-v3-671b, llava-next-mistral-7b,
              whisper-tiny, xlstm-350m and recurrentgemma-9b (float32), p=2,
              m=4: 2 training steps
              (AdamW + post-validation) on cuda and on cpu under zb-h1 and
              under zb-v (two chunks on the V placement); losses within
              1e-5 relative, grad norms within 1e-4.
9. train   -- internlm2-1.8b at full width, 8 of its 24 layers (bf16,
              random weights from a seed): 4 stages on the one card, 8
              microbatches of
              1 x 1024 tokens from the synthetic stream, 2 steps each under
              all eight schedules of the launcher (1f1b, zb-h1, zb-h2,
              zb-1p, zb-2p on one chunk a stage; zb-v, v-min, v-half on two,
              with the seed-0 weights relaid layer by layer onto the V
              placement, so every schedule starts from the same model; the
              AdamW state and a first walk before the steps, as
              ``launch/calibrate.py`` runs them, for phase 13's peaks):
              step time, tokens/s, peak memory beside the plan's live
              activation and W-context units, losses, grad norms; both
              kernels' launch counts, read around each schedule's run, equal
              the counts the structure implies, and every wgrad_accum launch
              took the wgmma path.
10. train-checks -- step-0 loss in the band of tests/test_arch_smoke.py and
              identical across all eight schedules, later losses within a
              stated tolerance; the step-0 full-width gradient of the
              B/W-split pipeline against plain torch.autograd through the
              same model, and zb-v's step-0 gradient, relaid back, against
              zb-h1's; then zb-h1 and zb-v once more, 2 steps each with
              the clip off, where their losses and grad norms must agree
              within the same tolerance.
11. profile-train -- torch.profiler over one full-width step of zb-h1 and
              one of zb-v, each run right after that schedule's steps in
              phase 9: the plan's ticks and chunk ops, host spans of the
              pipeline and the optimizer, device busy share, top kernels,
              wgrad_accum's share of device time.
12. plan    -- the HBM planner at the train phase's run shape, per-device
              budgets from 1 to 80 GiB, under the model fidelity and under
              the measured one (slot bytes measured on the card): each
              point's choice and itemized breakdown; cost never rises with
              the budget and 1 GiB is refused naming the binding term.
13. plan-vs-card -- the planner's temp term held to the card: for every
              run of phase 9 (eager), of phase 16 (graph; checked after it)
              and of phase 18 (graph, gpt3-1.5b, in its child process), the
              run's own torch.cuda.max_memory_reserved must not pass the
              planner's priced one-card total (``HBMPlanner.
              one_card_bytes``: measured fidelity, every stage's weights,
              moments and fp32 accumulators once, the walk at its worst
              tick, the optimizer's transient by its calibrated overhang
              and reuse, the calibrated remainder of the run's executor
              mode), and the
              total may pass the peak by at most PLAN_OVERSHOOT_MAX of it;
              each overshoot is printed, with the model fidelity's total.
              Then the remainder and shares ``launch/calibrate.py`` would
              write from these runs, beside the checked-in ones (printed,
              not gated).  After phase 16, runs the calibration never saw:
              internlm2 at seq 512 under the graph executor, zb-v, 2
              steps, must stay under its priced total too
              (their launches counted with the main path's).
14. launch  -- ``launch.train.main`` at full width and phase 9's depth
              (``--layers 8``) under a memory
              budget at which the planner picks a zero-bubble schedule,
              with a checkpoint directory; on the card the launcher
              runs the graph executor (its last line says
              ``executor=graph``):
              losses fall, both kernels' launch counts match the chosen
              schedule's one capture (every W op on wgmma), the final
              checkpoint restores bit for bit; save and restore seconds
              and bytes; the reserved bytes after the first step, which the
              launcher prints beside the chosen plan's priced one-card
              total, must not pass that total.
15. replay  -- the fault-tolerant driver at full width, 1 layer a stage,
              under the eager and then the graph executor: a failure at
              step 3 is restored from the step-2 checkpoint onto fresh
              tensors at other addresses (the failed state is held until
              they exist), which in graph mode forces one more capture;
              the replayed losses and grad norms equal an uninterrupted
              run's of the same mode, and the uninterrupted graph run the
              eager one's (within 1e-6 relative: index_add_ atomics).
16. train-graph -- phase 9's run under every schedule again, with the
              pipeline captured once into a CUDA graph and replayed
              (``executor_mode="graph"``, the AdamW state allocated before
              the capture, as in the launcher): the step-0 gradient equals a
              fresh eager walk's bit for bit (the embedding's within 1e-6
              relative), the step-0 loss equals phase 9's bit for bit, the
              losses and grad norms of phase 9's later steps within 1e-6
              relative, over 3 steps (2 replayed); each capture
              launches both kernels as often as one eager step (all W ops
              on wgmma) and the replays launch nothing from Python; capture
              seconds, replay step time (median of 2) beside phase 9's
              eager one (its step 1),
              tokens/s, allocated and reserved peaks; for zb-h1 and zb-v a
              profiled replayed step (host spans, device busy share, kernel
              counts, the two kernels' among them).
17. serve-gemma2 -- gemma2-2b at full width and depth (26 layers alternating
              attn_local, window 4096, and attn; softcap 50; bf16, random
              weights from a seed): 4 stages on the one card, 4 request
              groups of 1, 4100-token prompts (past the window and not a
              multiple of it, so each local layer's ring holds a rolled
              tail), 4 greedy tokens: prefill and decode ms, RMSNorm
              launches == the structure's count, and decoding token 4100
              against a prefill of 4101 tokens within a stated limit.
18. train-gpt3 -- gpt3-1.5b, the paper's model and the launcher's default
              arch, at full width (d 2304, 24 heads of 96, d_ff 9216, vocab
              50257; bf16, random weights from a seed) and G3_LAYERS of its
              22 layers: the step-0 gradient of the eager zb-h1 walk against
              plain torch.autograd; then 4 stages on the one card, 8
              microbatches of 1 x 1024 tokens, 3 steps under one schedule of each
              placement, zb-h1 and zb-v (phase 16 runs all eight under the
              graph), with the
              pipeline captured in a CUDA graph (the AdamW state allocated
              first, as the launcher's driver does): step-0 loss in band and
              equal across schedules, and zb-v's later losses within 1e-4 of
              zb-h1's with the clip off (phase 10's reason); under zb-h1
              the graph's step-0 gradient equals the eager walk's bit for
              bit but the embedding's; launches per capture, replay ms,
              allocated and reserved peaks (a schedule that runs out of
              memory at seq 1024 runs again at seq 512, and says so); a
              profiled replayed zb-h1 step, and the LM head's three GEMMs
              at the odd vocabulary beside a vocabulary padded to 64.
19. launch-gpt3 -- ``launch.train.main`` with the default ``--arch`` at full
              width, 4 steps of zb-h1: it trains gpt3-1.5b, its losses
              fall, one capture's launches, the last line says
              ``executor=graph``; its reserved bytes after the first step
              must not pass phase 18's priced one-card total of zb-h1.
20. serve-qwen2-moe -- qwen2-moe-a2.7b at full width and depth (24 layers
              of attn + moe, d 2048, 16 heads of 128, 60 routed experts of
              1408, top-4, and 4 shared; vocab 151936; bf16, random weights
              from a seed, the routers fp32), served as phase 5 serves
              internlm2: prefill and decode ms, RMSNorm launches == the
              structure's count, the share of (token, choice) selections
              each layer's capacity (86 slots for 1024 tokens) drops in
              prefill, none dropped in decode (4 slots for 2 tokens); then
              decoding token 512 against a prefill of 513 tokens with the
              capacity set to the prefill's tokens, so nothing drops: how
              many (layer, token) top-k sets differ between the two and
              the logits' gap (printed), then the same decode with each
              layer's experts pinned to the prefill's choice (logits within
              MOE_CONSIST_REL_L2 and CONSIST_MAX_ABS).
21. train-qwen2-moe -- qwen2-moe-a2.7b at full width, cut from 24 to 4
              layers: p=2 stages on the one card (two layers a stage; one
              a chunk on the V placement), 8 microbatches of 1 x 1024
              tokens, zb-h1 and zb-v, 2 steps each eager and then with the
              graph executor, the clip off (zb-v gets the seed-0 weights
              relaid); the eager zb-h1 step-0 gradient against plain
              autograd; step-0 loss in band and equal for both schedules,
              later losses within 1e-4; each graph's step-0 gradient against
              its eager walk's, bit for bit but the embedding's, its
              losses within 1e-6 of the eager ones; launches by path (the
              routers' W ops on fma, the rest on wgmma) == the structure's
              count; each run's reserved peak gated as phase 13 gates
              the dense runs: at most ``HBMPlanner.one_card_bytes`` of its
              schedule and executor mode (measured fidelity, the remainder
              and shares of the calibration record that
              ``launch/calibrate.py --layers 4 --p 2`` wrote at this cut),
              which may pass it by at most PLAN_OVERSHOOT_MAX of the peak;
              the memory window is ``launch/calibrate.py``'s.  (Phases 21,
              23-25, 28 and 30 profiled one more zb-h1 graph step until
              phase 32 needed the time; PERF.md §5 keeps their readings.)
22. serve-deepseek-v3 -- deepseek-v3-671b at full width (every matrix at
              its published shape: d 7168, 128 mla heads of 128 + a
              shared rope key of 64, q rank 1536, kv rank 512; 256 routed
              experts of 2048, top-8, 1 shared; vocab 129280; bf16, random
              weights from a seed, the routers fp32), cut from 61 to 2
              layers, p=2, served as phase 20 serves qwen2-moe: prefill
              and decode ms, RMSNorm launches == the structure's count
              (the 7168-wide rows on bulk in prefill, latency in decode),
              capacity drops per layer in prefill (40 slots for 1024
              tokens), none in decode; the absorbed mla decode (cache c and
              kr, 576 numbers a token and layer) against a prefill of 513
              tokens: the top-k flips and the unpinned gap printed, the
              pinned gap within DS_CONSIST_REL_L2.
23. train-deepseek-v3 -- deepseek-v3-671b's training cut (2 layers, p=2,
              16 routed experts, vocab 32768; every mla and expert matrix
              at its published shape), phase 21's checks under zb-h1 and
              zb-h2: the step-0 gradient against plain autograd, losses,
              graph against eager bit for bit, the six mla W ops and the
              shared expert's on wgmma and the router's on fma, the
              reserved peaks gated against the cut's own calibration
              record.
24. train-whisper -- whisper-tiny whole (4 joint encdec blocks, d 384,
              6 heads, d_ff 1536, vocab 51865; bf16, random weights from a
              seed), p=2, 8 microbatches of 1 x (1500 frames + 448 tokens),
              zb-h1 and zb-v, phase 21's checks (zero frames, as the
              launcher feeds; random frames in the gradient check, so
              front_proj's gradient is held too): 18 wgrad_accum launches a
              block and one for front_proj a microbatch, all on wgmma, 5
              norms a block and the sink's, all on bulk; the reserved peaks
              gated against its own record.
25. train-llava -- llava-next-mistral-7b at full width (d 4096, 32 q / 8
              kv heads, d_ff 14336, vocab 32000, 576 patches of 1024) and a
              depth cut, the deepest of LT_DEPTHS layers priced at most
              LT_PRICE_GIB (the price printed first), p=2, 8 microbatches
              of 1 x (576 patches + 1024 tokens), zb-h1 and zb-v: phase
              21's checks and gate, the 8 front_proj launches a step
              counted.
26. serve-llava -- llava-next-mistral-7b at full width and depth (32
              layers, 7.25 B parameters), p=4, phase 5's groups, 576
              patches + 512-token prompts, 4 greedy tokens, the cache
              holding the patches: prefill and decode ms, tok/s, RMSNorm
              launches == the structure's count, decoding token 512
              against a prefill of 513 within LS_CONSIST_REL_L2.
27. serve-whisper -- whisper-tiny whole, p=2, phase 5's groups, 1500
              frames, 432-token prompts, 4 greedy tokens (436 of the decoder's
              448 positions; a decode step runs 3 of a block's 5 norms),
              gated as phase 26 at WS_CONSIST_REL_L2.
28. train-xlstm -- xlstm-350m whole (24 layers: 18 mLSTM, 6 sLSTM; d
              1024, 4 heads of 256, vocab 50304; bf16, random weights from
              a seed), p=3, 8 microbatches of 1 x 2048 (16 mLSTM chunks,
              the sLSTM kernel over 2048 steps), zb-h1 and zb-v: phase 21's
              checks and gate; 5 wgrad_accum launches a sLSTM block and 6
              an mLSTM block (mfg and mig on thin), one rmsnorm a
              block, a forward and a backward sLSTM kernel a sLSTM block
              and microbatch; one zb-h1 graph step profiled: each port
              kernel's share of the device time.
29. serve-xlstm -- xlstm-350m whole, p=3, phase 5's groups, prompts and
              new tokens: prefill and decode ms, RMSNorm and sLSTM kernel
              launches == the structure's count (a forward a sLSTM block
              and group in prefill; decode runs the step form), decoding
              token 512 against a prefill of 513 within XS_CONSIST_REL_L2.
30. train-recurrentgemma -- recurrentgemma-9b at full width, 6 of its 38
              layers and its vocabulary cut to 65536 (the price printed
              first and held to RT_PRICE_GIB), p=2, m=8 of 1 x 1024, zb-h1
              and zb-h2: phase 21's checks and gate; 8 wgrad_accum launches
              a rglru block and 7 an attn_local block.
31. serve-recurrentgemma -- recurrentgemma-9b at full width and depth (38
              layers in 42 slots at p=2; 11.3 B parameters allocated), as
              phase 29, within RS_CONSIST_REL_L2.
32. train-long -- internlm2-1.8b at full width and depth (24 layers) at
              the JAX package's train_4k sequence: p=4, 8 microbatches of 1
              x 4096 (past 2 x 1024 queries: the chunked attention, its
              query blocks recomputed in B), zb-h1 and zb-v under the
              graph executor, 2 steps after the capture, every batch read
              from a token file of the synthetic stream's seed-0 batches
              through TokenFileLM and prefetch: phase 21's checks and gate
              against the record calibrated at seq 4096, the reserved peak
              under TL_RESERVED_MAX_GB, and the measured residual slot per
              token at seq 4096 at most the one at 1024.
33. train-long-reduced -- reduced internlm2 (2 layers, f32) at seq 2304,
              p=2, zb-h1 and zb-v: cuda against cpu (losses 1e-5
              relative, grad norms 1e-4) and the graph against the eager
              walk (phase 16's rules).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits 1 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import io
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import all_configs, get_config, get_reduced  # noqa: E402
from repro_torch.core.executor import PipelineExecutor, slot_bytes  # noqa: E402
from repro_torch.core.memory import cuda_temp_record, record_key  # noqa: E402
from repro_torch.core.planner import HBMPlanner, stage_program_factory  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.core.simulator import TimeModel, simulate  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, TokenFileLM, prefetch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import slstm_scan as slstm_kernel  # noqa: E402
from repro_torch.kernels import wgrad_accum as wgrad_kernel  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref, slstm_scan_ref, wgrad_accum_ref  # noqa: E402
from repro_torch.launch.calibrate import calibration_record, cut_config  # noqa: E402
from repro_torch.launch.serve import draw_front, serve  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, build_train_step  # noqa: E402
from repro_torch.launch.steps import build_serve_step  # noqa: E402
from repro_torch.launch.train import init_state, make_data_at, make_schedule, make_step_fn  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import TrainResult, side_from_batch, train  # noqa: E402
from repro_torch.models.lm import (  # noqa: E402
    RunSpec,
    build_program,
    front_spec,
    group_layout,
    init_params,
    make_chunk_fn,
    make_sink_fn,
    make_src,
)
from repro_torch.models import modules as layers  # noqa: E402
from repro_torch.models.lm import layer_cfg  # noqa: E402
from repro_torch.models.modules import ShardCtx, moe_capacity  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import DriverConfig, TrainDriver, replan_under_budget  # noqa: E402
from repro_torch.tree import keyed_leaves, tree_flatten, tree_leaves, tree_map  # noqa: E402
from repro_torch.tree import tree_unflatten  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores,
# dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

ARCH = "internlm2_1_8b"
# full-width serving run (NEW was 16 until phase 32 needed the time)
P, M, B, PROMPT, NEW = 4, 8, 2, 512, 4
RED_P, RED_M, RED_B, RED_PROMPT, RED_NEW = 2, 4, 2, 16, 4  # reduced cuda-vs-cpu run
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # as tests/test_kernels.py
# phase 3's RMSNorm sweep: every width of the port's dense configs, and rows
RMS_SWEEP_WIDTHS = (48, 64, 384, 1024, 2048, 2304, 4096, 5120, 6144, 7168, 8192)
RMS_SWEEP_ROWS = (1, 2, 1000, 4100)
COLD_BYTES = 100_000_000  # a cold timing's rotation: twice the H100's 50 MB L2
# full-width consistency in bf16: both paths round every product to bf16 (8
# mantissa bits) but in other shapes, so ~1-ulp differences (2^-9 relative)
# enter each of the 48 sublayers and add up like a random walk: about
# sqrt(48) * 2^-9 = 1.4% of the logits' norm.  Twice that is the limit; the
# max bound catches a gross error in a few logits.
CONSIST_REL_L2 = 3e-2
CONSIST_MAX_ABS = 0.25
# norm launches of each ported kind per call: one rmsnorm in attn,
# attn_local and mlp, in prefill (the port reuses the forward's k/v), in
# decode and in a training forward alike (the norm's backward is plain
# torch, no kernel); encdec's five (enc_attn, enc_mlp, dec_attn, xattn,
# dec_mlp), of which a decode step runs the decoder's three
NORMS_PER_KIND = {"attn": 1, "attn_local": 1, "mla": 1, "mlp": 1, "moe": 1, "encdec": 5,
                  "slstm": 1, "mlstm": 1, "rglru": 1}
DECODE_NORMS_PER_KIND = dict(NORMS_PER_KIND, encdec=3)
# deferred linears (W ops, one wgrad_accum launch each) of each kind: mla's
# are its six products (wdq, wuq, wdkv, wuk, wuv, wo); moe's the router and
# the three shared-expert weights (its expert stacks are batched products
# that W adds by torch.bmm, as the JAX W slice does); encdec's 4 in each of
# enc_attn, dec_attn and xattn, 3 in each of enc_mlp and dec_mlp; slstm's
# five (si, sf, sz, sog, so), mlstm's six (mq, mk, mv, mfg, mig, mo),
# rglru's five (rx, ry, ra, ri, ro; its fp32 lam is a cheap leaf).  A vlm
# or encdec model adds one a microbatch: front_proj's, in the source's W
LINEARS_PER_KIND = {"attn": 4, "attn_local": 4, "mla": 6, "mlp": 3, "moe": 4, "encdec": 18,
                    "slstm": 5, "mlstm": 6, "rglru": 5}
# ... of which fp32, on wgrad_accum's fma path: the moe router
FMA_LINEARS_PER_KIND = {"moe": 1}
# ... of which bf16 and n_heads wide, on its thin path where n_heads is no
# multiple of 8 (4 in xlstm-350m): mlstm's gate products mfg and mig
HEADS_WIDE_LINEARS_PER_KIND = {"mlstm": 2}
# sLSTM time-loop kernel launches of a slstm block and microbatch: the
# forward in F (and in a prefill), the backward in B; a decode step runs the
# step form, no kernel
SLSTM_PER_KIND = {"slstm": 1}
# the other archs of phases 4, 8 and 17-31, and their reduced prompts in
# phase 4 (gemma2's and recurrentgemma's are 2W + 3 for their window W = 8:
# a rolled ring tail)
GPT3, GEMMA2, MOE = "gpt3_1_5b", "gemma2_2b", "qwen2_moe_a2_7b"
DEEPSEEK, LLAVA, WHISPER = "deepseek_v3_671b", "llava_next_mistral_7b", "whisper_tiny"
XLSTM, RGEMMA = "xlstm_350m", "recurrentgemma_9b"
RED_PROMPTS = {ARCH: RED_PROMPT, GPT3: RED_PROMPT, GEMMA2: 19, MOE: RED_PROMPT,
               DEEPSEEK: RED_PROMPT, LLAVA: RED_PROMPT, WHISPER: RED_PROMPT, XLSTM: RED_PROMPT,
               RGEMMA: 19}
RED_ARCHS = (ARCH, GPT3, GEMMA2, MOE, DEEPSEEK, LLAVA, WHISPER, XLSTM, RGEMMA)
# gemma2 serving at full width: p stages, m groups of b, prompts past the
# 4096 window and not a multiple of it, new greedy tokens
GS_P, GS_M, GS_B, GS_PROMPT, GS_NEW = 4, 4, 1, 4100, 4
# its decode-vs-prefill limit, derived as CONSIST_REL_L2 is, before any run
# of it: phase 6's rule (twice a random walk of one bf16 ulp, 2^-9, per
# sublayer) gives 2 * sqrt(52) * 2^-9 = 2.8e-2 for gemma2's 52 sublayers,
# but phase 6's own reading, 0.0283 at 48 sublayers (H100, 700 W, every run),
# puts the card's step per sublayer at 0.0283 / sqrt(48) = 4.1e-3, two
# ulps; at that step 52 sublayers walk to sqrt(52) * 4.1e-3 = 2.9e-2, and
# twice that is the limit.  A misplaced ring slot moves the logits by
# O(1) of their norm.
GS_CONSIST_REL_L2 = 6e-2
# gpt3-1.5b training: phase 9's run shape, GPT3_STEPS steps a schedule, one
# schedule a placement (phase 16 runs all eight under the graph on
# internlm2), and the LM head's GEMMs timed at the odd vocabulary and
# padded ones; phases 18-19 at G3_LAYERS of its 22 layers (2 a stage in
# both placements), gated against its record calibrated there (4 steps at
# the full depth until phase 32 needed the time)
GPT3_STEPS, G3_LAYERS = 3, 8
GPT3_SCHEDULES = ("zb-h1", "zb-v")
GPT3_HEAD_VOCABS = (50257, 50264, 50304)
GPT3_CHILD = "--gpt3-phases"  # the argument that runs phases 18-19 alone
MOE_CHILD = "--moe-phases"  # ... and phases 20-21
DEEPSEEK_CHILD = "--deepseek-phases"  # ... and phases 22-23
FRONT_CHILD = "--front-phases"  # ... and phases 24-27
XLSTM_CHILD = "--xlstm-phases"  # ... and phases 28-29
RGEMMA_CHILD = "--recurrentgemma-phases"  # ... and phases 30-31
GRAPH_CHILD = "--graph-phases"  # ... and phase 16 with its plan-vs-card gate
HELDOUT_CHILD = "--heldout-phase"  # ... and phase 13's held-out runs
LONG_CHILD = "--long-phases"  # ... and phases 32-33

# full-width training run: 4 stages on the card, m microbatches of b x seq;
# internlm2's training phases (9-16 and the held-out runs) run at T_LAYERS
# of its 24 layers, 2 a stage (both placements hold 8 without padding), and
# are gated against its calibration record at that cut (its full-depth
# record stays beside it): at the full depth the script passed its 1200 s
# limit on a slow host (PERF.md §4)
T_P, T_M, T_B, T_SEQ, T_STEPS = 4, 8, 1, 1024, 2
T_LAYERS = 8
T_SCHEDULES = ("1f1b", "zb-h1", "zb-h2", "zb-1p", "zb-2p", "zb-v", "v-min", "v-half")
T_PROFILED = ("zb-h1", "zb-v")  # one chunk a stage, and two on the V placement
T_MEM_LIMIT_GB = 75.0  # above this peak, the schedule runs again at seq 512
# reduced cuda-vs-cpu training run
TR_P, TR_M, TR_B, TR_SEQ, TR_STEPS = 2, 4, 2, 32, 2
# the W products of the training step: (H, F) of wq/wo, wk/wv, wu/wg, wd
WGRAD_MAIN = (("wq,wo", 2048, 2048), ("wk,wv", 2048, 1024), ("wu,wg", 2048, 8192),
              ("wd", 8192, 2048))
# ... and of gpt3-1.5b's (multi-head: wk and wv are as wide as wq)
WGRAD_GPT3 = (("gpt3 wq,wk,wv,wo", 2304, 2304), ("gpt3 wu,wg", 2304, 9216),
              ("gpt3 wd", 9216, 2304))
# ... and of qwen2-moe-a2.7b's moe blocks: the 4 shared experts (5632 wide),
# bf16 on wgmma, and the router (60 experts), fp32 on fma; its attention is
# MHA, (2048, 2048) for all four, as wq above
WGRAD_MOE = (("qwen2-moe swu,swg", 2048, 5632), ("qwen2-moe swd", 5632, 2048))
WGRAD_MOE_FP32 = (("qwen2-moe router", 2048, 60),)
# ... and of deepseek-v3-671b's mla blocks (wdkv's 576 = 512 + 64 leaves a
# ragged last 128-column tile; wuk and wuv share a shape), its shared
# expert (2048 wide), bf16 on wgmma, and the training cut's router (16
# experts), fp32 on fma
WGRAD_DS = (("deepseek wdq", 7168, 1536), ("deepseek wuq", 1536, 24576),
            ("deepseek wdkv", 7168, 576), ("deepseek wuk,wuv", 512, 16384),
            ("deepseek wo", 16384, 7168), ("deepseek swu,swg", 7168, 2048),
            ("deepseek swd", 2048, 7168))
WGRAD_DS_FP32 = (("deepseek router", 7168, 16),)
# ... and of llava-next-mistral-7b's blocks (GQA: wk and wv are 1024 wide;
# N = 576 patches + 1024 tokens) and its front_proj (1024 -> 4096, N = the
# 576 patches), and of whisper-tiny's encdec blocks: every attention
# product (384, 384), the mlp's (384, 1536) and (1536, 384), at the
# encoder's N = 1500 (its front_proj's and the cross-attention's k and v
# too) and at the decoder's N = 448
WGRAD_LLAVA = (("llava wq,wo", 4096, 4096), ("llava wk,wv", 4096, 1024),
               ("llava wu,wg", 4096, 14336), ("llava wd", 14336, 4096))
WGRAD_LLAVA_FRONT = (1024, 4096)
WGRAD_WHISPER = (("wq,wk,wv,wo", 384, 384), ("wu,wg", 384, 1536), ("wd", 1536, 384))
# ... and of xlstm-350m's blocks at N = 2048 (every sLSTM and mLSTM product
# is (1024, 1024) but mfg and mig, (1024, 4): bf16 rows of 8 bytes, so on
# thin), and of recurrentgemma-9b's at N = 1024 (rx, ry, ra, ri, ro and
# wq, wo (4096, 4096); its one kv head's wk, wv (4096, 256); the mlp's)
# the sLSTM loop's kernels against the plain loop on the card: h and the
# state are the same fp32 operations in the same order (no contraction into
# FMAs), so they must agree bit for bit; the backward sums a state's
# gradient terms in another order than autograd does, ~1e-7 relative a
# step, which the chain's contraction (each step multiplies the carried
# gradient by the forget gate, at most 1) keeps from growing
SLSTM_GRAD_RTOL = 1e-5
# the chain bound: the dependent fp32 operations that carry a step's state
# to the next, of 4 cycles each at the H100 SXM's 1.98 GHz boost clock
# (NVIDIA's data sheet).  Forward 2: m_t = max(f_t + m_{t-1}, i_t) is an
# add and a max, and c_t = fe c_{t-1} + ie z, n_t = fe n_{t-1} + ie a mul
# and an add each beside it (the exponentials need m_t alone, so they run
# ahead of the c and n chains).  Backward 4: the dm carry's sub, sub, mul,
# add (dc and dn carry an add and a mul each beside it)
SLSTM_CHAIN_OPS, SLSTM_OP_CYCLES, H100_BOOST_HZ = (2, 4), 4, 1.98e9
WGRAD_XLSTM = (("xlstm si,sf,sz,sog,so,mq,mk,mv,mo", 1024, 1024), ("xlstm mfg,mig", 1024, 4))
WGRAD_RGEMMA = (("recurrentgemma rx,ry,ra,ri,ro,wq,wo", 4096, 4096),
                ("recurrentgemma wk,wv", 4096, 256), ("recurrentgemma wu,wg", 4096, 12288),
                ("recurrentgemma wd", 12288, 4096))
# the routers' tolerance: each is held at the stock TOL[float32] against an
# fp64 sum, and qwen2-moe's also against the plain version.  deepseek's
# router is held against the plain version at 1e-4 absolute (1e-5
# relative), as both routers were before the fp32 path split N: there the
# plain version's own error is what 1e-5 cannot take.  cuBLAS sums
# (7168, 16) 1.46e-5 (this phase's draw) to 1.75e-5 (another) away from an
# fp64 sum, the kernel's 8 runs of 128 products 1.02e-5, so the two differ
# by up to 1.62e-5 / 1.72e-5, and even the fp64 sum rounded to fp32 sits
# near the stock limit around the plain version (H100, 700 W;
# tools/wgrad_fp32_variants.py prints where).  The kernel is within ~0.6
# of the stock limit around the fp64 sum (tools/wgrad_fp32_error.py)
WGRAD_FP32_N1024_ATOL = 1e-4
# qwen2-moe serving (phase 20) runs phase 5's shape.  Its decode-vs-prefill
# gap, each routing its own tokens, is printed and not gated: the limit
# derived for it before the first run (7e-2, from ~12 top-k flips of 384
# sets) failed at 0.0844 with 50 flips (H100, 700 W): a router logit
# (N(0, 1) at this init) moves with the stream's whole bf16 walk, ~2e-2
# relative, not one rounding, and the gap between the 4th and 5th of 60
# gates' logits has a mean of only ~0.13, so ~15% of the sets flip, each
# swapping an expert of weight ~1/4.  Gated instead: the same decode with
# each moe layer's experts pinned to the prefill's choice for that token,
# which leaves phase 6's bf16 walk over the same 48 sublayers; its limit,
# derived before any run of the pinned decode as gemma2's is: phase 6's
# reading, 0.0283 at 48 sublayers (every run), twice, 6e-2.  A dropped or
# misplaced token moves its logits by O(1) of their norm.
MOE_CONSIST_REL_L2 = 6e-2
# qwen2-moe training (phase 21): full width, the depth cut from 24 to 4
# layers (24 would hold ~14 bytes x 14.3 B = 200 GB), p=2 so that both
# placements hold the 4 layers without a padded group (at p=4 the V
# placement pads to 8 layer slots, 5.2 B parameters, ~73 GB)
MT_LAYERS, MT_P, MT_STEPS = 4, 2, 2
MT_SCHEDULES = ("zb-h1", "zb-v")
MOE_TRAIN = dict(tag="train-qwen2-moe", p=MT_P, schedules=MT_SCHEDULES)
# deepseek-v3-671b serving (phase 22): every matrix at its published shape
# and the full vocabulary, the depth cut from 61 to 2 layers (24.9 B
# parameters, ~50 GB in bf16; 3 layers would be ~73 GB before any
# activation), p=2, one layer a stage; phase 5's groups, prompts and new
# tokens.  Its pinned decode-vs-prefill limit, derived before any run of it
# on the card: phase 6's reading puts the card's step at 0.0283 / sqrt(48)
# = 4.1e-3 a sublayer (every run); the absorbed decode adds its own
# rounding to each mla sublayer, which tools/serve_consistency.py measures
# on the CPU, where the other sublayers add none (reduced qwen2-moe at 48
# sublayers: 0.0 in both packages; reduced deepseek at 2 layers: 0.0103,
# the mean of 3 seeds, JAX 0.0106): 0.0103 / sqrt(2) = 7.3e-3 a mla
# sublayer.  Over 2 mla and 2 moe sublayers the walk is
# sqrt(4 x 4.1e-3^2 + 2 x 7.3e-3^2) = 1.31e-2; twice that is the limit.
DS_LAYERS, DS_P = 2, 2
DS_CONSIST_REL_L2 = 2.6e-2
# deepseek-v3-671b training (phase 23): one card cannot hold a published
# layer's training state (11.5 B parameters a layer at ~23 bytes each), so
# every mla and expert matrix keeps its shape and the cut takes 2 layers
# at p=2 (linear placement: the V one would pad 2 layers into 4 slots),
# 16 routed experts (top-8 and the shared expert kept) and a vocabulary of
# 32768: 2.34 B parameters, priced at ~50-52 GiB by the planner's model
# fidelity before its first run
DT_LAYERS, DT_P, DT_EXPERTS, DT_VOCAB = 2, 2, 16, 32768
DS_TRAIN = dict(tag="train-deepseek-v3", p=DT_P, schedules=("zb-h1", "zb-h2"))
# llava-next-mistral-7b training (phase 25): full width (its 7.25 B
# parameters would need ~100 GB of weights, moments and accumulators), p=2,
# m=8 microbatches of 1 x (576 patches + 1024 tokens), zb-h1 and zb-v; the
# depth is the deepest of LT_DEPTHS whose priced one-card graph total
# (``HBMPlanner.one_card_bytes``, measured fidelity, the calibration
# record's remainder) stays within LT_PRICE_GIB of the card's 80 GB.  6
# layers are no candidate: the V placement's 4 groups would hold 8 layer
# slots, 2 of them padded, which the seed-0 relay onto it refuses (the
# linear placement holds 6)
LT_DEPTHS, LT_P, LT_PRICE_GIB = (8, 4), 2, 70.0
LLAVA_TRAIN = dict(tag="train-llava", p=LT_P, schedules=("zb-h1", "zb-v"), seq=T_SEQ)
# whisper-tiny training (phase 24): full width and depth (4 joint blocks),
# p=2, m=8 microbatches of 1 x (1500 frames + 448 tokens, its decoder's
# length), zb-h1 and zb-v
WT_SEQ = 448
WHISPER_TRAIN = dict(tag="train-whisper", p=2, schedules=("zb-h1", "zb-v"), seq=WT_SEQ)
# llava serving (phase 26): full width and depth (32 layers, 7.25 B
# parameters, 14.5 GB in bf16), p=4, phase 5's groups and batch, 576
# patches + PROMPT tokens, NEW greedy tokens.  Its decode-vs-prefill limit,
# derived before any run of it as gemma2's is: phase 6's reading puts the
# card's bf16 step at 0.0283 / sqrt(48) = 4.1e-3 a sublayer (H100, 700 W,
# every run); llava's 64 sublayers (32 x attn + mlp) walk to sqrt(64) x
# 4.1e-3 = 3.3e-2, and twice that is the limit.  The max bound scales
# phase 6's CONSIST_MAX_ABS (0.25 at a 3e-2 limit, logits of std ~0.02 x
# sqrt(2048) at the init's head scale) to this limit and to llava's logits
# (std ~0.02 x sqrt(4096)): 0.25 x (6.6e-2 / 3e-2) x sqrt(2) = 0.78, which
# an error of O(1) in a few logits still passes.  A patch position the
# cache dropped or a rope position off by the patches moves the logits by
# O(1) of their norm
LS_P, LS_CONSIST_REL_L2, LS_CONSIST_MAX_ABS = 4, 6.6e-2, 0.78
# whisper serving (phase 27): full width and depth, p=2, phase 5's groups
# and batch, 1500 frames, 432-token prompts and NEW new tokens, within the
# decoder's 448 positions.  Its limit by the same rule: the encoder stream
# is the same in both prefills (its shapes do not depend on the prompt),
# so the walk runs over the decoder's 12 sublayers (4 x self-attention,
# cross-attention, mlp): sqrt(12) x 4.1e-3 = 1.4e-2, twice that 2.8e-2,
# rounded up to 3e-2; the max bound scales CONSIST_MAX_ABS to whisper's
# logits (std ~0.02 x sqrt(384)): 0.25 x sqrt(384 / 2048) = 0.108
WS_P, WS_PROMPT, WS_CONSIST_REL_L2, WS_CONSIST_MAX_ABS = 2, 432, 3e-2, 0.108
# xlstm-350m training (phase 28): whole (24 layers, d 1024, 4 heads of 256,
# vocab 50304), p=3: 8 layers a stage, and the V placement's 6 groups of 4
# hold the 24 layers too (at p=2 the V placement, at p=4 both, pad 8 of 32
# slots); m=8 microbatches of 1 x 2048, so each sequence crosses 16 mLSTM
# chunks and runs the sLSTM kernel over 2048 steps; zb-h1 and zb-v, the
# zb-h1 graph step profiled (the sLSTM and thin W kernels' shares)
XT_P, XT_SEQ = 3, 2048
XLSTM_TRAIN = dict(tag="train-xlstm", p=XT_P, schedules=("zb-h1", "zb-v"), seq=XT_SEQ,
                   profile=True)
# recurrentgemma-9b training (phase 30): full width (d 4096, 16 q / 1 kv
# heads of 256, lru_width 4096, d_ff 12288, window 2048), 6 of its 38
# layers (two periods of rglru, rglru, attn_local), p=2, m=8 of 1 x 1024,
# zb-h1 and zb-h2 (at p=2 the V placement pads 6 layers to 12 slots), its
# vocabulary cut from 256000 to 65536: at the full vocabulary (3.41 B
# parameters, ~14 bytes each with their moments and accumulators, ~44 GiB
# before any activation) launch/calibrate.py's first zb-h1 run ran out of
# the card in the optimizer's step (75.5 GiB in use; H100, 700 W); at
# 65536, 1.85 B parameters.  Its priced one-card total printed before any
# step and held to RT_PRICE_GIB
RT_LAYERS, RT_P, RT_VOCAB, RT_PRICE_GIB = 6, 2, 65536, 70.0
RGEMMA_TRAIN = dict(tag="train-recurrentgemma", p=RT_P, schedules=("zb-h1", "zb-h2"))
# internlm2-1.8b trained at the JAX package's train_4k sequence (phase 32):
# full width and depth (24 layers), p=4, m=8 microbatches of 1 x 4096 (past
# 2 x 1024 queries: the chunked attention and its remat), zb-h1 and zb-v
# under the graph executor, 2 steps after the capture, every batch read from
# a token file (written from the synthetic stream's seed-0 batches) through
# TokenFileLM and prefetch; gated as phase 21 is against the calibration
# record measured at this seq, and its reserved peak held under the card's
# 80 GB.  The remat's own gate: the measured residual slot per token at
# 4096 is at most the one at 1024, where the dense path keeps its scores
TL_P, TL_SEQ, TL_RESERVED_MAX_GB = 4, 4096, 80.0
LONG_TRAIN = dict(tag="train-long", p=TL_P, seq=TL_SEQ, modes=("graph",))
# ... zb-h1 and zb-v do not fit the card at the full depth: at 24 layers
# zb-h1's first optimizer step ran out of memory with 43.05 GiB in the
# graph's pool (the price, measured fidelity: 82.50 GiB, of which the walk
# 41.95: residuals 21.45, W-contexts 14.72, two sink slots 5.71; the
# optimizer's transient 12.34; H100, 700 W), zb-v's is priced 84.28 GiB.
# So the full depth trains under 1F1B (priced 69.65 GiB: W runs beside B,
# so it holds 4.03 GiB of W-contexts), and zb-h1 and zb-v at the deepest
# depth that holds both placements unpadded and fits, 16 layers (priced
# 61.96 and 62.75 GiB), each depth against a record measured there
TL_RUNS = ((24, ("1f1b",)), (16, ("zb-h1", "zb-v")))
# ... and its reduced twin (phase 33): reduced internlm2 (2 layers) in f32 at
# seq 2304, p=2, zb-h1 and zb-v: cuda against cpu as phase 8, the graph
# against the eager walk as phase 16
TLR_P, TLR_M, TLR_B, TLR_SEQ, TLR_STEPS = 2, 2, 1, 2304, 2
# their serving (phases 29 and 31), at phase 5's groups, batch, prompts and
# new tokens: xlstm whole at p=3; recurrentgemma at full width and depth (38
# layers, 10.4 B parameters; p=2 gives 42 slots, 4 of them padded, 11.3 B
# parameters allocated, ~23 GB in bf16; p=4 would pad 10 of 48).  Their
# decode-vs-prefill limits, derived before any card run of them from
# tools/serve_consistency.py --recurrent (bf16, reduced width, CPU, both
# packages; the step form with fp32 state against the chunkwise mLSTM, the
# sLSTM loop and the associative scan) and phase 6's card step of 4.1e-3 a
# sublayer (0.0283 / sqrt(48), every run), each sublayer walking both.
# xlstm at its 24 layers (reduced width, 30 seeds): the JAX package 0.0448,
# the port 0.0490 (larger in 15 of the 30; the port is to be no worse than
# the JAX package, so the limit is the JAX package's reading, not the
# port's), so sqrt(0.0448^2 + 24 x 4.1e-3^2) = 0.0491 and twice that is the
# limit, 0.098; the max bound scales CONSIST_MAX_ABS to it and to xlstm's
# logits (std ~0.02 x sqrt(1024)): 0.25 x (0.098 / 3e-2) x sqrt(1024 /
# 2048) = 0.58.  recurrentgemma at its 38 layers: the port 0.0
# in every seed (its rglru and attn_local decode is the prefill's last
# position to the bit on the CPU; the JAX package 0.061, its prefill's
# per-position decode state), so the card's step alone over its 76
# sublayers, sqrt(76) x 4.1e-3 = 0.0357, twice that 7.2e-2; max 0.25 x
# (7.2e-2 / 3e-2) x sqrt(4096 / 2048) = 0.85.  A state that the prefill
# did not hand over moves the logits by O(1) of their norm
XS_P, RS_P = 3, 2
XS_CONSIST_REL_L2, XS_CONSIST_MAX_ABS = 0.098, 0.58
RS_CONSIST_REL_L2, RS_CONSIST_MAX_ABS = 7.2e-2, 0.85
# later full-width losses across schedules: the embedding gradient is a
# CUDA index_add_ (atomics, no fixed order), so it differs between runs by
# fp32 rounding (~1e-7 relative); AdamW's first steps are nearly
# scale-invariant and the bf16 cast of the updated weights flips a few
# hundred embedding entries by one ulp at most, which moves the loss by
# ~1e-6 relative.  1e-4 relative leaves a wide margin for that and none for
# a real difference between schedules.  Grad norms are held to it only with
# the clip off: the clip scale is 1/sqrt of a sum of squares that each stage
# adds over its own layers, so the V and the linear placements' scales differ
# in their last bit, and the bf16 weights carry one f32 ulp of the scale to
# ~1e-2 of the step-2 grad norm (tools/placement_gap.py; H100, 700 W)
T_LATER_LOSS_RTOL = 1e-4
DEV = "cuda"  # the device of the training phases
# step-0 gradient, pipeline vs plain autograd (bf16): the plain path rounds
# each microbatch's weight gradient to bf16 (2^-9 relative, ~1.1e-3 rms)
# where the pipeline keeps fp32; activation gradients agree to rounding
# (H100, 700 W: 1.63e-3 pooled, 1.66e-3 on the worst of the 58 leaves, the
# same in three runs).  Both limits are 1e-2, six times those readings.  The
# pooled norm is dominated by the embedding and head, so the worst leaf is
# gated too: a fault confined to one leaf kind (the wk and wv pairs swapped,
# one (H, F) case mis-tiled) puts an O(1) relative error on that leaf.  A
# leaf whose plain gradient is zero must be zero in the pipeline as well.
T_GRAD_REL_L2 = 1e-2
T_GRAD_WORST_LEAF = 1e-2
# step-0 gradient, zb-v (two chunks, V placement) relaid back vs zb-h1 on the
# same weights: every block runs the same kernels on the same inputs and each
# (stage, chunk) accumulator sums its microbatches in the same order, so the
# two agree bit for bit apart from the embedding gradient, whose index_add_
# atomics sum colliding rows in no fixed order (fp32 rounding, ~1e-7
# relative).  1e-5 on the worst leaf leaves room for that and for nothing a
# misplaced layer or chunk would cause.
T_V_GRAD_WORST_LEAF = 1e-5
# the planner's sweep at the train phase's run shape, per-device budgets in GiB
PLAN_BUDGETS_GIB = (1, 2, 4, 6, 8, 10, 12, 16, 24, 32, 48, 64, 80)
# the launcher under a budget, priced by the measured fidelity on the card
# with the graph executor's temp term (internlm2-1.8b, p=4, m=8, 1 x 1024)
L_BUDGET_MB, L_STEPS = 36864, 4
# the graph executor against phase 9's eager runs: step-0 gradients and loss
# bit for bit but the embedding gradient (index_add_ atomics, ~1e-7
# relative), and every later loss and grad norm, within 1e-6 relative; it
# runs G_STEPS steps, the first T_STEPS against phase 9, and its step time is
# the median of the G_STEPS - 1 replayed steps after the capturing one (3
# steps until phase 32 needed the time)
G_RTOL, G_STEPS = 1e-6, 2
# the driver's failure replay: full width, 1 layer a stage (a 6.3 GB
# checkpoint against the full depth's 19 GB; 2 a stage, 8.8 GB, until the
# moe phases lengthened the script), a failure at step 3 restored
# from the step-2 checkpoint.  On the card the step is deterministic but for
# the embedding gradient's index_add_ atomics, which reorder fp32 sums
# (~1e-7 relative): 1e-6 relative on the replayed losses and grad norms
R_SCHEDULE, R_LAYERS_PER_STAGE, R_STEPS, R_EVERY, R_FAIL_AT, R_RTOL = "zb-h1", 1, 4, 2, 3, 1e-6


# phase 13: the planner's one-card total (measured fidelity, temp term of the
# run's executor mode) against each run's torch.cuda.max_memory_reserved: the
# peak must not pass it, and it may pass the peak by at most this share of
# the peak, so the term tracks the card and is no blanket constant
PLAN_OVERSHOOT_MAX = 0.10
# ... and on runs the calibration never saw: internlm2 at seq 512 (M_B 0.41
# of the calibration cell's) under the graph executor, on the V placement
# (two chunks a stage: two slot sizes priced; zb-h1's held-out run, its
# one-chunk twin, was cut for the script's time)
H_SEQ, H_SCHEDULES, H_STEPS = 512, ("zb-v",), 2


def train_config():
    """internlm2-1.8b at full width, cut to T_LAYERS layers: the config of
    the training phases 9-16."""
    return dataclasses.replace(get_config(ARCH), n_layers=T_LAYERS)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one call issued eagerly from Python, from CUDA events
    around ``iters`` calls: the device time plus any gap the host leaves."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def _warmup_stream() -> torch.cuda.Stream:
    return torch.cuda.Stream()


def device_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events, so host dispatch is not counted.
    The inputs stay in L2 between calls, as they do on the serving path,
    where the norm reads what the previous op just wrote.  The warm-up runs
    on one side stream shared by all calls: cuBLAS keeps a workspace for
    every stream it has run on, so a new stream per call would leave one
    more workspace allocated for the rest of the run."""
    side = _warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(3):
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
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernel source(s) in {time.perf_counter() - t0:.1f}s: "
          + ", ".join(f"{n} -> {p.relative_to(ROOT)}" for n, p in libs.items()))
    for n, p in libs.items():
        for line in p.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {n}: {line.strip()}")


def phase_card() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(out[0].strip())  # one card: the one this script runs on
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def rmsnorm_bound_ms(n: int, h: int, x_dtype, g_dtype):
    """Least time for the work: bytes (x read, y written, g read, once each)
    over the HBM rate, or ~4 fp32 operations per element over the fp32 rate."""
    xs = torch.tensor([], dtype=x_dtype).element_size()
    gs = torch.tensor([], dtype=g_dtype).element_size()
    byte_ms = (2 * n * h * xs + h * gs) / HBM_BYTES_PER_S * 1e3
    op_ms = 4 * n * h / FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def rotated(fn, x, out_bytes: int):
    """A call of ``fn`` on one of k copies of x in turn, holding its last k
    outputs, so each call reads an x and writes a y that more than
    ``COLD_BYTES`` of other inputs and outputs have passed through since
    they were last touched: the L2 (50 MB) holds neither.  Returns (the
    call, k); time it over a multiple of k calls."""
    per_call = x.numel() * x.element_size() + out_bytes
    k = max(2, -(-COLD_BYTES // per_call) + 1)
    xs = [x.clone() for _ in range(k)]
    held, turn = collections.deque(maxlen=k), [0]

    def call():
        held.append(fn(xs[turn[0]]))
        turn[0] = (turn[0] + 1) % k

    return call, k


def in_turns(kernel, library, **kw):
    """Device ms of the kernel and the library call timed in turns (kernel,
    library, library, kernel): (kernel mean, library mean, the four)."""
    t = [device_ms(fn, **kw) for fn in (kernel, library, library, kernel)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def rmsnorm_sweep():
    """The kernel against the plain version at every width of the port's
    dense configs, both x and g dtypes, N in RMS_SWEEP_ROWS, plus views one
    element off their allocation and rows that are not a multiple of 16
    bytes, each on the path its plan names."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(n, h, xd, gd, 0) for h in RMS_SWEEP_WIDTHS for xd in TOL for gd in TOL
             for n in RMS_SWEEP_ROWS]
    cases += [(n, h, xd, xd, 1) for h in RMS_SWEEP_WIDTHS for xd in TOL for n in (2, 1000)]
    cases += [(1000, 2047, torch.bfloat16, torch.bfloat16, 0),
              (1000, 2050, torch.float32, torch.float32, 0)]
    by_path, worst = {k: 0 for k in rms_kernel.PATHS}, {xd: 0.0 for xd in TOL}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, h, xd, gd, off in cases:
        buf = torch.randn(off + n * h, generator=gen, device="cuda").to(xd)
        x = buf[off:].view(n, h)
        g = (torch.randn(h, generator=gen, device="cuda") * 0.5).to(gd)
        path = rms_kernel.plan_launch(n, h, xd, gd, x.data_ptr(), 0, sms).path
        want = ("rowwise" if off or (h * x.element_size()) % 16 else
                "latency" if n <= sms else "bulk")
        check(path == want, f"rmsnorm N={n} H={h} x={xd} offset {off}: path {path}, want {want}")
        y = rms_kernel.rmsnorm_fused(x, g)
        torch.cuda.synchronize()
        ref = rmsnorm_ref(x, g)
        torch.testing.assert_close(y.float(), ref.float(), rtol=TOL[xd], atol=TOL[xd],
                                   msg=lambda m: f"N={n} H={h} x={xd} g={gd} off={off}: {m}")
        worst[xd] = max(worst[xd], float((y.float() - ref.float()).abs().max()))
        by_path[path] += 1
        del buf, x, g, y, ref
    errs = {str(k).split(".")[-1]: f"{v:.3g} (tol {TOL[k]})" for k, v in worst.items()}
    print(f"[kernels] rmsnorm sweep: {len(cases)} cases (H in {RMS_SWEEP_WIDTHS}, x and g in "
          f"bf16/f32, N in {RMS_SWEEP_ROWS}; views one element off at N 2 and 1000; H 2047 bf16 "
          f"and 2050 f32) all within tolerance; by path {by_path}; max_abs_err {errs}")
    torch.cuda.empty_cache()


def phase_kernels(cfg_full, cfg_red):
    """RMSNorm on the card: the width sweep, then the shapes the serving
    path gives it and gpt3-1.5b's training rows and gemma2-2b's serving
    rows, each with its path, timed warm and cold against F.rms_norm in
    turns."""
    bf16, f32 = torch.bfloat16, torch.float32
    d = cfg_full.d_model
    d2 = get_config(GPT3).d_model
    check(get_config(GEMMA2).d_model == d2, "gpt3-1.5b and gemma2-2b differ in width")
    d3 = get_config(DEEPSEEK).d_model
    lv, wh, xl = get_config(LLAVA), get_config(WHISPER), get_config(XLSTM)
    n_lv, n_wh = front_spec(lv)[1], front_spec(wh)[1]
    rmsnorm_sweep()
    shapes = [  # (label, N rows, H, x dtype, g dtype, the path the main path takes or None)
        ("prefill", B * PROMPT, d, bf16, bf16, "bulk"),
        ("decode", B, d, bf16, bf16, "latency"),
        ("reduced", B * RED_PROMPT, cfg_red.d_model, f32, f32, None),
        ("ragged", 1000, d, bf16, bf16, None),
        ("gpt3-train", T_B * T_SEQ, d2, bf16, bf16, "bulk"),
        ("gemma2-prefill", GS_B * GS_PROMPT, d2, bf16, bf16, "bulk"),
        ("gemma2-decode", GS_B, d2, bf16, bf16, "latency"),
        ("deepseek-prefill", B * PROMPT, d3, bf16, bf16, "bulk"),
        ("deepseek-decode", B, d3, bf16, bf16, "latency"),
        # llava: its blocks' rows in training (patches and tokens) and its
        # sink's (tokens), prefill's blocks, decode's and the prefill sink's
        ("llava-train", T_B * (n_lv + T_SEQ), lv.d_model, bf16, bf16, "bulk"),
        ("llava-sink", T_B * T_SEQ, lv.d_model, bf16, bf16, "bulk"),
        ("llava-prefill", B * (n_lv + PROMPT), lv.d_model, bf16, bf16, "bulk"),
        ("llava-decode", B, lv.d_model, bf16, bf16, "latency"),
        # whisper: the encoder's and the decoder's rows (the decoder's also
        # its sink's) in training and in prefill, and decode's
        ("whisper-encoder", T_B * n_wh, wh.d_model, bf16, bf16, "bulk"),
        ("whisper-decoder", T_B * WT_SEQ, wh.d_model, bf16, bf16, "bulk"),
        ("whisper-prefill-encoder", B * n_wh, wh.d_model, bf16, bf16, "bulk"),
        ("whisper-prefill-decoder", B * WS_PROMPT, wh.d_model, bf16, bf16, "bulk"),
        ("whisper-decode", B, wh.d_model, bf16, bf16, "latency"),
        # xlstm: its training rows (1 x 2048), prefill's and decode's;
        # recurrentgemma's (1024 x 4096 in training and prefill, 2 x 4096 in
        # decode) are llava's sink and decode rows above
        ("xlstm-train", T_B * XT_SEQ, xl.d_model, bf16, bf16, "bulk"),
        ("xlstm-prefill", B * PROMPT, xl.d_model, bf16, bf16, "bulk"),
        ("xlstm-decode", B, xl.d_model, bf16, bf16, "latency"),
        # internlm2 trained at seq 4096: its blocks' and sink's rows
        ("long-train", T_B * TL_SEQ, d, bf16, bf16, "bulk"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for label, n, h, xd, gd, need in shapes:
        x = torch.randn(n, h, generator=gen, device="cuda").to(xd)
        g = (torch.randn(h, generator=gen, device="cuda") * 0.5).to(gd)
        plan = rms_kernel.plan_launch(n, h, xd, gd, x.data_ptr(), 0, sms)
        check(need is None or plan.path == need,
              f"rmsnorm {label} ({n} x {h}) takes the {plan.path} path, not {need}")
        y = rms_kernel.rmsnorm_fused(x, g)
        torch.cuda.synchronize()
        ref = rmsnorm_ref(x, g)
        err = float((y.float() - ref.float()).abs().max())
        tol = TOL[xd]
        torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)
        w = (1.0 + g.float()).to(xd)
        kernel_of = lambda a: rms_kernel.rmsnorm_fused(a, g)  # noqa: E731
        library_of = lambda a: torch.nn.functional.rms_norm(a, (h,), w, 1e-6)  # noqa: E731
        ms, lib_ms, turns = in_turns(lambda: kernel_of(x), lambda: library_of(x))
        row = dict(max_abs_err=err, ms=ms, library_ms=lib_ms, path=plan.path,
                   plain_ms=device_ms(lambda: rmsnorm_ref(x, g)), cold_ms=None,
                   library_cold_ms=None)
        row["bound_ms"], row["bound_by"] = rmsnorm_bound_ms(n, h, xd, gd)
        cold = "cold: not measured (a few rows; on the path they come from the previous op)"
        if n >= 1000:
            out_bytes = x.numel() * x.element_size()
            kernel_cold, k = rotated(kernel_of, x, out_bytes)
            library_cold, _ = rotated(library_of, x, out_bytes)
            iters = k * -(-100 // k)
            row["cold_ms"], row["library_cold_ms"], cold_turns = in_turns(
                kernel_cold, library_cold, iters=iters)
            cold = (f"cold (x and y rotated over {k} copies, {iters} calls a graph): "
                    f"kernel={row['cold_ms']:.5f} library={row['library_cold_ms']:.5f} (in turns "
                    f"{'/'.join(f'{t:.5f}' for t in cold_turns)}), kernel at "
                    f"{row['bound_ms'] / row['cold_ms']:.1%} of the bound")
            del kernel_cold, library_cold
        rows[label] = row
        print(f"[kernels] rmsnorm {label} N={n} H={h} x={xd} g={gd}: path={plan.path} "
              f"(grid {plan.grid}, rows a stage {plan.rows}, warps a row {plan.warps_per_row}, "
              f"stages {plan.stages}, shared bytes {plan.smem_bytes}) max_abs_err={err:.3g} (tol "
              f"{tol}) device ms warm: kernel={ms:.5f} library={lib_ms:.5f} [F.rms_norm] (in "
              f"turns kernel/library/library/kernel: {'/'.join(f'{t:.5f}' for t in turns)}) "
              f"plain={row['plain_ms']:.5f} bound={row['bound_ms']:.5f} ({row['bound_by']}, "
              f"kernel at {row['bound_ms'] / ms:.1%} of it); {cold}; eager ms per call: "
              f"kernel={eager_ms(lambda: kernel_of(x)):.5f} "
              f"library={eager_ms(lambda: library_of(x)):.5f}")
        del x, g, y, ref
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _routes():
    """Every moe layer's routing while active: (its router's address, top_i,
    pos_nk, capacity) of each ``_moe_route`` call, in call order, the
    tensors where they were made."""
    real, log = layers._moe_route, []

    def logged(p, tok, cfg):
        out = real(p, tok, cfg)
        log.append((p["router"].data_ptr(), out[1], out[2], moe_capacity(cfg, tok.shape[0])))
        return out

    layers._moe_route = logged
    try:
        yield log
    finally:
        layers._moe_route = real


def phase_reduced(cfg, prompt=RED_PROMPT):
    spec = RunSpec(p=RED_P, n_chunks=1, microbatch=RED_B, seq_len=prompt, m=RED_M)
    stacked, shared = init_params(cfg, spec, Placement.linear(RED_P), seed=1, device="cpu")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (RED_M, RED_B, prompt))
    front = draw_front(cfg, rng, RED_M, RED_B)  # a vlm's patches, an encdec's frames
    with _routes() as cpu_routes:
        on_cpu = serve(cfg, stacked, shared, prompts, p=RED_P, new_tokens=RED_NEW, front=front)
    to_cuda = lambda a: a.to("cuda")  # noqa: E731
    with _routes() as gpu_routes:
        on_gpu = serve(cfg, tree_map(to_cuda, stacked), tree_map(to_cuda, shared), prompts,
                       p=RED_P, new_tokens=RED_NEW, front=front)
    errs = []
    for a, b in zip(on_gpu.logits, on_cpu.logits):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        errs.append(float((a.cpu() - b).abs().max()))
    check(torch.equal(on_gpu.tokens.cpu(), on_cpu.tokens), "reduced greedy tokens differ")
    routing = ""
    if any("moe" in kinds for kinds in cfg.block_pattern):
        check(len(gpu_routes) == len(cpu_routes) > 0,
              f"{len(gpu_routes)} moe calls on cuda, {len(cpu_routes)} on cpu")
        for (_, gi, gp, _), (_, ci, cp, _) in zip(gpu_routes, cpu_routes):
            check(torch.equal(gi.cpu(), ci) and torch.equal(gp.cpu(), cp),
                  f"{cfg.name}: the routing (top-k experts or slot positions) differs on cuda")
        sel = sum(ci.numel() for _, ci, _, _ in cpu_routes)
        routing = (f"; routing identical in {len(cpu_routes)} moe calls ({sel} (token, choice) "
                   f"selections, their experts and slot positions)")
    print(f"[reduced] {cfg.name} p={RED_P} m={RED_M} b={RED_B} prompt={prompt} new={RED_NEW} f32: "
          f"cuda vs cpu logits max_abs_err per step {[f'{e:.3g}' for e in errs]} (tol 1e-4), "
          f"tokens identical ({on_gpu.tokens.numel()}){routing}")


def _norms_per_group(cfg, p, per_kind):
    blocks, _ = group_layout(cfg, p, 1)
    return p * sum(per_kind[k] for kinds in blocks for k in kinds) + 1  # + sink


def expected_norm_launches(cfg, p, m, steps):
    """RMSNorm launches of a serve call of ``steps`` steps: a prefill, then
    ``steps - 1`` decode steps, m groups each."""
    return m * (_norms_per_group(cfg, p, NORMS_PER_KIND)
                + (steps - 1) * _norms_per_group(cfg, p, DECODE_NORMS_PER_KIND))


def expected_serve_paths(cfg, p, m, new_tokens):
    """RMSNorm launches by kernel path of one serve call: the prefill's
    block norms see b x prompt rows (bulk); its sink norms the last position
    of b rows, and every decode norm b rows (latency)."""
    blocks, _ = group_layout(cfg, p, 1)
    per_stage = sum(NORMS_PER_KIND[k] for kinds in blocks for k in kinds)
    bulk = m * p * per_stage
    want = {k: 0 for k in rms_kernel.PATHS}
    want.update(bulk=bulk, latency=expected_norm_launches(cfg, p, m, 1 + new_tokens) - bulk)
    return want


def _serve_counted(what, cfg, p, m, new_tokens, run):
    """``run()`` with the counters reset before and read after; its RMSNorm
    launches must be the structure's count, on the paths their rows imply,
    and its sLSTM kernel launches one forward a slstm block and group (the
    prefill's).  Returns (result, rmsnorm launches, by path, sLSTM kernel
    launches by kernel)."""
    _reset_counts()
    res = run()
    _, launches, _, by_path, sl = _read_counts()
    want = expected_norm_launches(cfg, p, m, 1 + new_tokens)
    check(launches == want and launches > 0,
          f"{what}: rmsnorm launches {launches} != {want} implied by the port's structure")
    want_paths = expected_serve_paths(cfg, p, m, new_tokens)
    check(by_path == want_paths, f"{what}: rmsnorm launches by path {by_path} != {want_paths}")
    want_sl = dict(fwd=m * p * _per_group(cfg, p, 1, SLSTM_PER_KIND), bwd=0)
    check(sl == want_sl, f"{what}: sLSTM kernel launches {sl} != {want_sl} (a forward a "
          f"slstm block and group in prefill, none in decode)")
    return res, launches, by_path, sl


def _check_served(cfg, res, m, b, new_tokens):
    """A serve call's output: finite logits (m, b, V) at every step and
    greedy tokens (m, b, new_tokens + 1) inside the vocabulary."""
    for lg in res.logits:
        check(lg.shape == (m, b, cfg.vocab), f"{cfg.name} logits shape {tuple(lg.shape)}")
        check(bool(torch.isfinite(lg.float()).all()), f"{cfg.name}: non-finite logits")
    check(res.tokens.shape == (m, b, new_tokens + 1), f"tokens shape {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()), "token out of range")


def phase_serve(cfg):
    spec = RunSpec(p=P, n_chunks=1, microbatch=B, seq_len=PROMPT, m=M)
    t0 = time.perf_counter()
    stacked, shared = init_params(cfg, spec, Placement.linear(P), seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] init {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}, {cfg.dtype}) "
          f"on cuda in {time.perf_counter() - t0:.1f}s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (M, B, PROMPT))
    serve(cfg, stacked, shared, prompts, p=P, new_tokens=1)  # warm-up (cuBLAS, allocator)

    torch.cuda.reset_peak_memory_stats()
    res, launches, by_path, _ = _serve_counted(
        "serve", cfg, P, M, NEW, lambda: serve(cfg, stacked, shared, prompts, p=P, new_tokens=NEW,
                                               log=lambda s: print(f"[serve] {s}")))
    want = expected_norm_launches(cfg, P, M, 1 + NEW)
    _check_served(cfg, res, M, B, NEW)
    decode_ms = [s * 1e3 for s in res.decode_s]
    print(f"[serve] p={P} m={M} b={B} prompt={PROMPT} new={NEW}: "
          f"prefill_ms={res.prefill_s * 1e3:.1f} "
          f"decode_ms_per_step mean={np.mean(decode_ms):.2f} median={np.median(decode_ms):.2f} "
          f"min={min(decode_ms):.2f} max={max(decode_ms):.2f} "
          f"generated_tok_per_s={M * B * NEW / sum(res.decode_s):.1f} "
          f"max_memory_allocated_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    print(f"[serve] rmsnorm launches {launches} == expected {want} "
          f"({1 + NEW} steps x {M} groups x ({P} stages x "
          f"{sum(NORMS_PER_KIND[k] for kinds in group_layout(cfg, P, 1)[0] for k in kinds)} "
          f"norms + 1 sink)), by path {by_path}")
    return stacked, shared, prompts, res, (launches, by_path)


def phase_consistency(cfg, stacked, shared, prompts, res, p=P, limit=CONSIST_REL_L2,
                      tag="consistency", front=None, max_abs=CONSIST_MAX_ABS):
    s = prompts.shape[-1]
    longer = np.concatenate([prompts, res.tokens[..., :1].cpu().numpy()], axis=-1)
    res2 = serve(cfg, stacked, shared, longer, p=p, new_tokens=0, front=front)
    dec, ref = res.logits[1].float(), res2.logits[0].float()
    rel = float((dec - ref).norm() / ref.norm())
    mx = float((dec - ref).abs().max())
    control = float((res.logits[0].float() - ref).norm() / ref.norm())  # one position off
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"[{tag}] decode@{s} vs prefill of {s + 1}: rel_l2={rel:.3g} "
          f"(limit {limit}) max_abs={mx:.3g} (limit {max_abs}) "
          f"top1_agree={agree:.3f}; control, prefill@{s - 1} vs it: rel_l2={control:.3g}; "
          f"prefill of {s + 1}: {res2.prefill_s * 1e3:.1f} ms")
    check(rel <= limit and mx <= max_abs, f"{cfg.name}: prefill->decode consistency")


def wgrad_bound_ms(n: int, h: int, f: int, in_dtype):
    """Least time for acc + a^T g: bytes (a and g read, acc read, out
    written, once each) over the HBM rate, or 2*N*H*F operations over the
    tensor-core bf16 rate (the fp32 rate for fp32 inputs)."""
    es = torch.tensor([], dtype=in_dtype).element_size()
    byte_ms = (n * (h + f) * es + 2 * h * f * 4) / HBM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if in_dtype == torch.bfloat16 else FP32_OPS_PER_S
    op_ms = 2 * n * h * f / rate * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _library_wgrad(a, g, acc):
    """One PyTorch call for acc + a^T g with an fp32 result, the yardstick."""
    return lambda: torch.addmm(acc, a.t(), g, out_dtype=torch.float32)


def host_us(fn, iters: int = 200) -> float:
    """Host time of one eager call: the enqueue alone, no device sync inside
    the window (the launch queue is deeper than ``iters``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def phase_kernels_wgrad(cfg_red):
    """wgrad_accum on the card at the W products of the training step, plus a
    ragged N, fp32 (the reduced model's path) and ragged shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    n = T_B * T_SEQ
    n_lv, n_wh = front_spec(get_config(LLAVA))[1], front_spec(get_config(WHISPER))[1]
    shapes = [(name, n, h, f, bf16)
              for name, h, f in WGRAD_MAIN + WGRAD_GPT3 + WGRAD_MOE + WGRAD_DS] + [
        (name, n, h, f, f32) for name, h, f in WGRAD_MOE_FP32 + WGRAD_DS_FP32] + [
        (name, T_B * (n_lv + T_SEQ), h, f, bf16) for name, h, f in WGRAD_LLAVA] + [
        ("llava front_proj", T_B * n_lv, *WGRAD_LLAVA_FRONT, bf16)] + [
        (f"whisper {stream}{name}", rows, h, f, bf16) for stream, rows in (
            ("enc ", T_B * n_wh), ("dec ", T_B * WT_SEQ)) for name, h, f in WGRAD_WHISPER] + [
        (name, T_B * XT_SEQ, h, f, bf16) for name, h, f in WGRAD_XLSTM] + [
        (name, n, h, f, bf16) for name, h, f in WGRAD_RGEMMA] + [
        (f"long {name}", T_B * TL_SEQ, h, f, bf16) for name, h, f in WGRAD_MAIN] + [
        ("ragged-N", 1000, 2048, 2048, bf16),
        ("fp32", n, 2048, 2048, f32),
        ("reduced", TR_B * TR_SEQ, cfg_red.d_model, cfg_red.d_ff, f32),
        ("ragged-bf16", 1000, 200, 300, bf16),
        ("ragged-fp32", 77, 129, 257, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for label, n_, h, f, dt in shapes:
        a = (torch.randn(n_, h, generator=gen, device="cuda") * 0.5).to(dt)
        g = (torch.randn(n_, f, generator=gen, device="cuda") * 0.5).to(dt)
        acc = torch.randn(h, f, generator=gen, device="cuda")
        path = wgrad_kernel.plan_launch(n_, h, f, dt, a.data_ptr(), g.data_ptr(), acc.data_ptr())
        if label.startswith(("gpt3", "qwen2-moe", "deepseek", "llava", "whisper", "xlstm",
                             "recurrentgemma", "long")):
            # a main-path W op: bf16 on wgmma (on thin where F is no
            # multiple of 8: mlstm's gates), fp32 on fma
            want_path = "fma" if dt == f32 else "thin" if f % 8 else "wgmma"
            check(path == want_path, f"the W op {label} takes the {path} path, not {want_path}")
        ref = wgrad_accum_ref(a, g, acc)  # the plain version, on the original
        out, again = acc.clone(), acc.clone()
        got = wgrad_kernel.wgrad_accum_cuda(a, g, out)  # the kernel, in place on a clone
        wgrad_kernel.wgrad_accum_cuda(a, g, again)  # ... and once more, on another clone
        torch.cuda.synchronize()
        check(got is out, "wgrad_accum did not return the accumulator it updated")
        check(torch.equal(out.view(torch.int32), again.view(torch.int32)),
              f"wgrad_accum {label}: two launches on clones of acc differ")
        err = float((out - ref).abs().max())
        tol = atol = TOL[dt]
        exact = ""
        plan = wgrad_kernel.plan_of(path, n_, h, f, sms)
        if plan is not None:
            print(f"[kernels] wgrad_accum {label} {path} plan: tile {plan.tile_h}x{plan.tile_f}, "
                  f"split {plan.split} (N in slices {[plan.slice(r, n_) for r in range(plan.split)]}"
                  f"), clusters of {plan.split}, grid {plan.grid} blocks of {plan.threads} "
                  f"threads, {plan.smem_bytes} B shared a block")
        if dt == f32:
            ref64 = acc.double() + a.double().t() @ g.double()
            err64 = float((out - ref64).abs().max())
            exact = (f"; against an fp64 sum: kernel {err64:.3g}, "
                     f"plain {float((ref - ref64).abs().max()):.3g}")
            if label in {name for name, _, _ in WGRAD_MOE_FP32 + WGRAD_DS_FP32}:
                torch.testing.assert_close(out.double(), ref64, rtol=tol, atol=tol)
                exact += f" (tol {tol})"
            if label in {name for name, _, _ in WGRAD_DS_FP32}:
                atol = WGRAD_FP32_N1024_ATOL
            del ref64
        torch.testing.assert_close(out, ref, rtol=tol, atol=atol)
        # the plain version and the library call allocate an (H, F) output per
        # call, and the CUDA graph's pool keeps each one: fewer calls when large
        iters = 20 if h * f >= 2048 * 2048 else 100
        kernel = lambda: wgrad_kernel.wgrad_accum_cuda(a, g, out)  # noqa: E731
        library = _library_wgrad(a, g, acc)
        turns = [device_ms(fn, iters=iters) for fn in (kernel, library, library, kernel)]
        row = dict(
            max_abs_err=err,
            ms=(turns[0] + turns[3]) / 2,
            library_ms=(turns[1] + turns[2]) / 2,
            plain_ms=device_ms(lambda: wgrad_accum_ref(a, g, acc), iters=iters),
            path=path, host_us=host_us(kernel),
        )
        if plan is not None:
            row["plan"] = dict(tile_f=plan.tile_f, split=plan.split, grid=plan.grid)
        if dt == f32:
            row["fp64_err"] = err64
        row["bound_ms"], row["bound_by"] = wgrad_bound_ms(n_, h, f, dt)
        rows[label] = row
        print(f"[kernels] wgrad_accum {label} N={n_} H={h} F={f} in={dt}: path={path} "
              f"max_abs_err={err:.3g} (rtol {tol}, atol {atol}{exact}; two launches bit for bit) "
              f"device ms: "
              f"kernel={row['ms']:.5f} "
              f"library={row['library_ms']:.5f} [torch.addmm out_dtype=float32] "
              f"(in turns kernel/library/library/kernel: "
              f"{'/'.join(f'{t:.5f}' for t in turns)}) plain={row['plain_ms']:.5f} "
              f"bound={row['bound_ms']:.5f} ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%} of it); "
              f"kernel TFLOP/s={2 * n_ * h * f / row['ms'] / 1e9:.1f}; "
              f"wrapper host us per eager call={row['host_us']:.1f}")
        del a, g, acc, out, again, got, ref, library
    torch.cuda.empty_cache()
    return rows


def slstm_bound_ms(b: int, s: int, h: int):
    """Least time for the forward and backward of the sLSTM loop: the bytes
    the two functions must move (forward: i, f, z read, h written, the final
    state written; backward: i, f, z and dh read, di, df, dz written; each
    (b, s, h) fp32 once), ~40 fp32 operations a step and channel over the
    fp32 rate, or the chain: each channel's s dependent steps forward and s
    backward, each SLSTM_CHAIN_OPS (forward, backward) dependent fp32
    operations of SLSTM_OP_CYCLES cycles at the H100's boost clock.  The
    chain counts as operations.
    Returns (ms, what bounds it, {bytes, operations, chain: ms})."""
    parts = dict(bytes=(11 * b * s * h + 3 * b * h) * 4 / HBM_BYTES_PER_S * 1e3,
                 operations=40 * b * s * h / FP32_OPS_PER_S * 1e3,
                 chain=s * sum(SLSTM_CHAIN_OPS) * SLSTM_OP_CYCLES / H100_BOOST_HZ * 1e3)
    ms = max(parts.values())
    return ms, "bytes" if ms == parts["bytes"] else "operations", parts


def _slstm_check(b: int, s: int, h: int, seed: int, offset: int = 0):
    """The sLSTM loop's kernels against the plain loop on the card at one
    (b, s, h), forward then backward, on the same inputs: h and the final
    state bit for bit (the same fp32 operations in the same order), the
    gradients within SLSTM_GRAD_RTOL of the largest; two launches bit for
    bit.  ``offset`` > 0 puts the inputs and dh that many floats into their
    buffers, so their bases are not 16-byte aligned.  Returns (inputs, the
    plain pass, {what: (max_abs_err, largest)})."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def placed(t):
        if not offset:
            return t.contiguous()
        buf = torch.empty(offset + t.numel(), device="cuda")
        return buf[offset:].view(t.shape).copy_(t)

    i_pre, f_pre, z = (placed(torch.randn((b, s, h), generator=gen, device="cuda") * sc)
                       for sc in (1.5, 1.5, 0.8))
    dh = placed(torch.randn((b, s, h), generator=gen, device="cuda"))

    def kernels():
        hs, c, n, m = slstm_kernel.forward(i_pre, f_pre, z)
        return (hs, c[:, -1], n[:, -1], m[:, -1]), slstm_kernel.backward(
            i_pre, f_pre, z, c, n, m, dh)

    def plain():
        xs = [t.clone().requires_grad_(True) for t in (i_pre, f_pre, z)]
        hs, state = slstm_scan_ref(*xs)
        hs.backward(dh)
        return (hs.detach(), *(t.detach() for t in state)), tuple(x.grad for x in xs)

    (fwd, grads), (fwd2, grads2), (pfwd, pgrads) = kernels(), kernels(), plain()
    torch.cuda.synchronize()
    what = f"slstm_scan at (b, s, h) = ({b}, {s}, {h})" + (f", {offset} floats in" if offset else "")
    check(all(torch.equal(a, b_) for a, b_ in zip(fwd + grads, fwd2 + grads2)),
          f"{what}: two launches differ")
    check(all(torch.equal(a, b_) for a, b_ in zip(fwd, pfwd)),
          f"{what}: h c n m not bit for bit the plain loop's")
    errs = {}
    for name, got, want in (("h c n m", fwd, pfwd), ("di df dz", grads, pgrads)):
        errs[name] = (max(float((a - b_).abs().max()) for a, b_ in zip(got, want)),
                      max(float(b_.abs().max()) for b_ in want))
    err, scale = errs["di df dz"]
    check(err <= SLSTM_GRAD_RTOL * scale,
          f"{what} di df dz: max_abs_err {err} > {SLSTM_GRAD_RTOL} x {scale}")
    print(f"[kernels] {what} fp32, forward + backward against the plain loop: h c n m bit for "
          f"bit; di df dz max_abs_err={err:.3g} of max {scale:.3g} (rtol {SLSTM_GRAD_RTOL}); "
          f"two launches bit for bit")
    return (i_pre, f_pre, z, dh), (kernels, plain), errs


def phase_kernels_slstm():
    """The sLSTM time loop's kernels on the card at every shape the main
    path gives them (:func:`_slstm_check`): xlstm-350m's training shape
    (1, 2048, 1024) and its serving's, phase 29's prefills of PROMPT and of
    PROMPT + 1 tokens in groups of B (2, 512, 1024) and (2, 513, 1024),
    whose steps are not a whole number of the kernels' chunks; and, bit for
    bit as well, the branches no main-path shape takes: h = 37 (no multiple
    of 4: 4-byte copies, and a last block of 5 of its 8 channels), h = 36
    (16-byte copies, a last block of 4 channels) and h = 1024 with bases
    off 16-byte alignment (4-byte copies).  At the training shape the pair's device ms (CUDA events around a CUDA graph of
    calls) beside the plain version's (eager: ~40 launches a step), the
    bound, and the design's own byte floor: the forward writes c, n, m of
    every step and the backward reads them back, 17 (b, s, h) fp32 arrays
    once each, where the bound counts the 11 the two functions must move.
    No PyTorch call computes the loop, so it has no library time."""
    h = get_config(XLSTM).d_model
    for seed, s in enumerate((PROMPT, PROMPT + 1), start=5):
        _slstm_check(B, s, h, seed)
    for seed, shape in enumerate(((3, 37, 37), (2, 70, 36)), start=7):
        _slstm_check(*shape, seed)
    _slstm_check(B, 70, h, 9, offset=1)
    b, s = T_B, XT_SEQ
    (i_pre, f_pre, z, _), (kernels, plain), errs = _slstm_check(b, s, h, 4)
    ms = device_ms(kernels, iters=20)
    plain_ms = eager_ms(plain, iters=1, warmup=0)  # the check above ran it once
    bound, bound_by, parts = slstm_bound_ms(b, s, h)
    floor = 17 * b * s * h * 4 / HBM_BYTES_PER_S * 1e3
    row = dict(max_abs_err=max(e for e, _ in errs.values()), ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=bound_by, chain_ms=parts["chain"],
               bytes_ms=parts["bytes"], floor_ms=floor, library_ms=None,
               fwd_ms=device_ms(lambda: slstm_kernel.forward(i_pre, f_pre, z), iters=20))
    print(f"[kernels] slstm_scan (b, s, h) = ({b}, {s}, {h}) fp32, {slstm_kernel.grid(b, h)} "
          f"blocks of {slstm_kernel.WARPS} warps, {slstm_kernel.CHANNELS} channels and "
          f"{slstm_kernel.CHUNK}-step chunks a block, forward + backward: device "
          f"ms kernels={ms:.4f} (forward {row['fwd_ms']:.4f}) plain={plain_ms:.1f} (eager, host "
          f"included) bound={bound:.4f} ({bound_by}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"), kernels at {bound / ms:.1%} of it; the design's byte floor (17 arrays once) "
          f"{floor:.4f}, kernels at {floor / ms:.1%} of it; no library call computes the loop")
    del i_pre, f_pre, z, kernels, plain
    torch.cuda.empty_cache()
    return row


def _to(tree, device):
    return tree_map(lambda a: a.to(device), tree)


def phase_train_reduced(cfg):
    """The reduced model's training steps on cuda against cpu (float32),
    under one chunk a stage (zb-h1) and two on the V placement (zb-v)."""
    for name in ("zb-h1", "zb-v"):
        runs = {}
        for device in ("cpu", DEV):
            sched = make_schedule(name, TR_P, TR_M)
            spec = RunSpec(p=TR_P, n_chunks=sched.n_chunks, microbatch=TR_B, seq_len=TR_SEQ,
                           m=TR_M)
            step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement,
                                       TrainStepConfig(adamw.AdamWConfig(lr=3e-3)))
            stacked, shared = init_params(cfg, spec, sched.placement, seed=2, device="cpu")
            data = SyntheticLM(DataConfig(global_batch=TR_M * TR_B, seq_len=TR_SEQ,
                                          vocab=cfg.vocab))
            runs[device] = train(cfg, spec, step, _to(stacked, device), _to(shared, device),
                                 data, TR_STEPS)
        cpu, gpu = runs["cpu"], runs[DEV]
        l_rel = [abs(a - b) / abs(b) for a, b in zip(gpu.losses, cpu.losses)]
        g_rel = [abs(a - b) / abs(b) for a, b in zip(gpu.grad_norms, cpu.grad_norms)]
        print(f"[train-reduced] {cfg.name} p={TR_P} m={TR_M} b={TR_B} seq={TR_SEQ} f32 {name} "
              f"({sched.n_chunks} chunk(s) a stage), {TR_STEPS} steps: losses cuda={gpu.losses} "
              f"cpu={cpu.losses} rel_err={[f'{e:.3g}' for e in l_rel]} (tol 1e-5); grad_norm "
              f"rel_err={[f'{e:.3g}' for e in g_rel]} (tol 1e-4)")
        check(max(l_rel) <= 1e-5, f"{name}: reduced training losses differ between cuda and cpu")
        check(max(g_rel) <= 1e-4,
              f"{name}: reduced training grad norms differ between cuda and cpu")


def _per_group(cfg, p, n_chunks, per_kind):
    """The sum of ``per_kind`` over one (stage, chunk) group's blocks."""
    blocks, _ = group_layout(cfg, p, n_chunks)
    return sum(per_kind.get(k, 0) for kinds in blocks for k in kinds)


def expected_train_launches(cfg, p, n_chunks, m):
    """Per training step: (wgrad_accum, rmsnorm) launches the port's
    structure implies -- one wgrad per deferred linear per W op, one norm
    per attn/mlp forward plus the sink's, per microbatch, over every
    (stage, chunk) group; a vlm or encdec model's front_proj adds one wgrad
    a microbatch."""
    blocks, _ = group_layout(cfg, p, n_chunks)
    groups = p * n_chunks
    wgrad = m * groups * sum(LINEARS_PER_KIND[k] for kinds in blocks for k in kinds)
    wgrad += m * (front_spec(cfg) is not None)
    norms = m * (groups * sum(NORMS_PER_KIND[k] for kinds in blocks for k in kinds) + 1)
    return wgrad, norms


def expected_fma_launches(cfg, p, n_chunks, m):
    """Of those wgrad_accum launches, the fp32 ones (the moe routers), which
    take the fma path by design."""
    blocks, _ = group_layout(cfg, p, n_chunks)
    return m * p * n_chunks * sum(FMA_LINEARS_PER_KIND.get(k, 0) for kinds in blocks for k in kinds)


def expected_narrow_launches(cfg, p, n_chunks, m):
    """Of those wgrad_accum launches, the bf16 ones n_heads wide where
    n_heads is no multiple of 8 (mlstm's mfg and mig), which take the
    thin path."""
    if cfg.n_heads % 8 == 0:
        return 0
    return m * p * n_chunks * _per_group(cfg, p, n_chunks, HEADS_WIDE_LINEARS_PER_KIND)


def expected_slstm_launches(cfg, p, n_chunks, m):
    """sLSTM kernel launches of a training step: a forward and a backward a
    slstm block and microbatch."""
    n = m * p * n_chunks * _per_group(cfg, p, n_chunks, SLSTM_PER_KIND)
    return dict(fwd=n, bwd=n)


def expected_measure_launches(cfg, p):
    """(wgrad_accum, rmsnorm) launches of the measured fidelity's slot
    measurement (``slot_bytes``): microbatch 0's F and B through stage 0's
    chunks and the sink, once for one and once for two chunks a stage; no W."""
    norms = 0
    for n_chunks in (1, 2):
        blocks, _ = group_layout(cfg, p, n_chunks)
        norms += n_chunks * sum(NORMS_PER_KIND[k] for kinds in blocks for k in kinds) + 1
    return 0, norms


def _reset_counts():
    wgrad_kernel.launches = 0
    wgrad_kernel.launches_by_path.update({k: 0 for k in wgrad_kernel.PATHS})
    rms_kernel.launches = 0
    rms_kernel.launches_by_path.update({k: 0 for k in rms_kernel.PATHS})
    slstm_kernel.launches = 0
    slstm_kernel.launches_by_path.update({k: 0 for k in slstm_kernel.PATHS})


def _read_counts():
    """(wgrad_accum, rmsnorm, wgrad_accum by path, rmsnorm by path, the sLSTM
    kernel's by kernel)."""
    return (wgrad_kernel.launches, rms_kernel.launches, dict(wgrad_kernel.launches_by_path),
            dict(rms_kernel.launches_by_path), dict(slstm_kernel.launches_by_path))


def _zero_counts():
    return (0, 0, {k: 0 for k in wgrad_kernel.PATHS}, {k: 0 for k in rms_kernel.PATHS},
            {k: 0 for k in slstm_kernel.PATHS})


def _add_counts(a, b, sign=1):
    """``a + sign * b`` for two count tuples of ``_read_counts``."""
    return (a[0] + sign * b[0], a[1] + sign * b[1],
            *({k: x[k] + sign * y[k] for k in x} for x, y in zip(a[2:], b[2:])))


def _check_counts(what, launches, want_per_step, n_steps, extra=(0, 0), fma_per_step=0,
                  narrow_per_step=0, slstm_per_step=None):
    """The kernels' launches over ``n_steps`` training steps (plus ``extra``
    outside them) equal the counts the port's structure implies, every bf16
    W op on the wgmma path but the ``narrow_per_step`` ones n_heads wide
    (mlstm's gates, on thin) and the ``fma_per_step`` fp32 ones (the moe
    routers) on fma; the sLSTM kernel's ``slstm_per_step`` (by kernel; none
    by default)."""
    want = tuple(n_steps * n + e for n, e in zip(want_per_step, extra))
    check(launches[:2] == want, f"{what}: (wgrad_accum, rmsnorm) launches {launches[:2]} != "
          f"{want} implied by the port's structure")
    fma, narrow = n_steps * fma_per_step, n_steps * narrow_per_step
    want_paths = {k: {"wgmma": want[0] - fma - narrow, "fma": fma, "thin": narrow}.get(k, 0)
                  for k in wgrad_kernel.PATHS}
    check(launches[2] == want_paths, f"{what}: wgrad_accum launches by path {launches[2]} != "
          f"{want_paths}: every bf16 W op of the training step should take the wgmma path but "
          f"the n_heads-wide ones (thin), every fp32 one (a moe router) fma")
    want_sl = {k: n_steps * (slstm_per_step or {}).get(k, 0) for k in slstm_kernel.PATHS}
    check(launches[4] == want_sl, f"{what}: sLSTM kernel launches {launches[4]} != {want_sl} "
          f"(a forward and a backward a slstm block and microbatch)")
    want_rms = {k: (want[1] if k == "bulk" else 0) for k in rms_kernel.PATHS}
    check(launches[3] == want_rms, f"{what}: rmsnorm launches by path {launches[3]} != "
          f"{want_rms}: every norm of the training step (1024 rows) should take the bulk path")
    return want


def _layer_map(cfg, placement):
    """For each layer slot l of the model, padded ones included: ((stage,
    block) under one linear chunk a stage, (chunk, stage, block) on
    ``placement``).  Depth position pos holds slots pos*g .. pos*g + g - 1
    and is chunk c's position k, with (c, k) = divmod(pos, p), on stage
    placement.stage_of(c, k); slot l holds a layer when l < n_layers, in
    either layout."""
    p, C = placement.p, placement.n_chunks
    _, g_lin = group_layout(cfg, p, 1)
    _, g = group_layout(cfg, p, C)
    check(g_lin * p == g * C * p,
          f"{cfg.n_layers} layers take {g_lin * p} slots in {p} x 1 groups but {g * C * p} in "
          f"{p} x {C}")
    out = []
    for layer in range(g_lin * p):
        c, k = divmod(layer // g, p)
        out.append((divmod(layer, g_lin), (c, placement.stage_of(c, k), layer % g)))
    return out


def relay_to_placement(cfg, stacked_lin, placement):
    """The linear placement's stacked parameters (one chunk a stage), laid
    out for ``placement`` slot by slot, the padded slots and their masks
    included: the same model, so every schedule starts from the same
    weights."""
    p, C = placement.p, placement.n_chunks
    _, g = group_layout(cfg, p, C)
    where = {(c, s, bi): lin for lin, (c, s, bi) in _layer_map(cfg, placement)}
    lin_blocks = stacked_lin[0]["blocks"]
    mask = stacked_lin[0]["mask"]
    out = []
    for c in range(C):
        blocks, masks = [], []
        for bi in range(g):
            src = [where[(c, s, bi)] for s in range(p)]
            per_stage = [tree_map(lambda a, st=st: a[st], lin_blocks[lb]) for st, lb in src]
            blocks.append(tree_map(lambda *xs: torch.stack(xs), *per_stage))
            masks.append(torch.stack([mask[st, lb] for st, lb in src]))
        out.append({"mask": torch.stack(masks, dim=1), "blocks": tuple(blocks)})
    return tuple(out)


def plan_units(sched, plan):
    """The plan's memory in units of one stage's activations (M_B): live
    residuals (act) and W-contexts (wctx) summed over stages and chunks at
    the worst tick of their sum (a chunk's slot holds 1/C of a stage's
    layers), and the paper's op-count profile summed over stages
    (``memory_profile(M_B/C, M_W/C)``, M_W = M_B/2)."""
    C = plan.n_chunks
    act = plan.res_live.sum(axis=(0, 1)) / C
    wctx = plan.wctx_live.sum(axis=(0, 1)) / C
    t = int(np.argmax(act + wctx))
    profile = float(sched.memory_profile(1.0 / C, 0.5 / C).peak.sum())
    return float(act[t]), float(wctx[t]), profile


def _init_full(cfg, sched, seq: int):
    """(stacked, shared, spec, data) of the train cell under ``sched`` (at its
    p): every schedule starts from the seed-0 model of the linear placement,
    relaid layer by layer onto its own placement."""
    p = sched.placement.p
    spec = RunSpec(p=p, n_chunks=sched.n_chunks, microbatch=T_B, seq_len=seq, m=T_M)
    lin_spec = RunSpec(p=p, n_chunks=1, microbatch=T_B, seq_len=seq, m=T_M)
    stacked, shared = init_params(cfg, lin_spec, Placement.linear(p), seed=0, device=DEV)
    if sched.n_chunks != 1:
        stacked = relay_to_placement(cfg, stacked, sched.placement)
    data = SyntheticLM(DataConfig(global_batch=T_M * T_B, seq_len=seq, vocab=cfg.vocab))
    return stacked, shared, spec, data


def _train_full(cfg, name: str, seq: int, tcfg=None):
    sched = make_schedule(name, T_P, T_M)
    plan = compile_plan(sched)
    stacked, shared, spec, data = _init_full(cfg, sched, seq)
    step, _ = build_train_step(cfg, spec, plan, sched.placement, tcfg or TrainStepConfig())
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    print(f"[train] {name}: {base_gb:.2f} GB allocated after init (bf16 weights; "
          f"{sched.n_chunks} chunk(s) a stage, {plan.n_ticks} ticks)")
    torch.cuda.reset_peak_memory_stats()
    state, walk = _first_walk_peaks(step, stacked, shared, spec, data)
    _reset_counts()
    res = train(cfg, spec, step, stacked, shared, data, T_STEPS,
                log=lambda s: print(f"[train] {name}: {s}"), state=state)
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return (res, launches, peak_gb, base_gb, plan, (stacked, shared, spec, sched, step, data),
            _mem(walk))


def _first_walk_peaks(step, stacked, shared, spec, data):
    """(AdamW state, the memory window's peaks at the end of the first
    walk), as ``launch/calibrate.py::measure_run`` reads them: the state on
    the card, step 0's walk (in graph mode the capture and a replay), its
    results dropped; the driver then steps from that state, as the
    launcher's does.  The walk's launches are not counted."""
    state = init_state(stacked, shared)
    step.grad_fn(stacked, shared, side_from_batch(data.batch_at(0), spec, DEV))
    return state, _walk_peaks()


def _walk_peaks():
    """The window's reserved and allocated peaks so far (the first walk's end)."""
    torch.cuda.synchronize()
    return dict(walk_reserved=torch.cuda.max_memory_reserved(),
                walk_allocated=torch.cuda.max_memory_allocated())


def _mem(walk):
    """The window's peaks, in bytes, for the plan-vs-card gate: the run's,
    and ``walk``'s at the end of its first walk."""
    torch.cuda.synchronize()
    return dict(reserved=torch.cuda.max_memory_reserved(),
                allocated=torch.cuda.max_memory_allocated(), **walk)


def phase_train(cfg):
    """Full-width training under each schedule, from the same weights."""
    out = {}
    for name in T_SCHEDULES:
        seq, t_sched = T_SEQ, time.perf_counter()
        res, launches, peak_gb, base_gb, plan, state, mem = _train_full(cfg, name, seq)
        if peak_gb > T_MEM_LIMIT_GB:
            print(f"[train] {name}: peak {peak_gb:.1f} GB > {T_MEM_LIMIT_GB} GB at seq {seq}; "
                  f"running it again at seq 512")
            del state
            torch.cuda.empty_cache()
            seq = 512
            res, launches, peak_gb, base_gb, plan, state, mem = _train_full(cfg, name, seq)
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9  # the same window as peak_gb
        sched = state[3]
        want = _check_counts(name, launches, expected_train_launches(cfg, T_P, sched.n_chunks, T_M),
                             T_STEPS)
        for k, (loss, gn) in enumerate(zip(res.losses, res.grad_norms)):
            check(np.isfinite(loss) and np.isfinite(gn), f"{name} step {k}: non-finite loss/norm")
        med = float(np.median(res.step_s))
        tokens = T_M * T_B * seq
        print(f"[train] {name} p={T_P} m={T_M} b={T_B} seq={seq}: ms_per_step "
              f"median={med * 1e3:.1f} all={[round(t * 1e3, 1) for t in res.step_s]} "
              f"tokens_per_s={tokens / med:.0f} max_memory_allocated_GB={peak_gb:.2f} "
              f"max_memory_reserved_GB={reserved_gb:.2f} "
              f"losses={res.losses} grad_norms={res.grad_norms} amended={res.amended} "
              f"launches wgrad_accum={launches[0]} {launches[2]} rmsnorm={launches[1]} "
              f"(expected {want})")
        act, wctx, profile = plan_units(sched, plan)
        bubble = simulate(sched, TimeModel.unit()).bubble_rate
        print(f"[train] {name} memory: peak above the after-init base {peak_gb - base_gb:.2f} GB; "
              f"plan at its worst tick: {act:g} activation + {wctx:g} W-context units = "
              f"{act + wctx:g} (units of one stage's activations, summed over stages); op-count "
              f"profile summed over stages {profile:g} M_B; {plan.n_ticks} ticks, simulated "
              f"bubble rate {bubble:.4f} (unit times, several cards)")
        out[name] = dict(res=res, launches=launches, seq=seq, peak_gb=peak_gb, base_gb=base_gb,
                         reserved_gb=reserved_gb, mem=mem,
                         sched=sched, plan=plan, n_params=sum(
                             t.numel() for t in tree_leaves((state[0], state[1]))),
                         param_bytes=sum(t.numel() * t.element_size()
                                         for t in tree_leaves((state[0], state[1]))))
        if name in T_PROFILED:
            phase_profile_train(name, plan, state)
        del state
        torch.cuda.empty_cache()
        print(f"[train] {name}: {time.perf_counter() - t_sched:.1f} s in all")
    return out


def _plain_grads(cfg, spec, stacked, shared, side):
    """Step-0 gradient by plain torch.autograd through the same model (plain
    x @ w products, the same RMSNorm function), per microbatch, summed in
    fp32; stacked like the pipeline's grads."""
    ctx = ShardCtx()
    chunk_fn, _, _ = make_chunk_fn(cfg, spec.p, 1, ctx)
    src_fwd, _ = make_src(cfg, ctx)
    sink_fn = make_sink_fn(cfg, ctx, spec.m)
    leaves, struct = tree_flatten((stacked, shared))
    alias = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
    st, sh = tree_unflatten(struct, alias)
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
    wrt = [k for k, t in enumerate(alias) if t.requires_grad]
    loss = 0.0
    for j in range(spec.m):
        side_j = tree_map(lambda a: a[j], side)
        with torch.enable_grad():
            x = src_fwd(sh, side_j)
            for s in range(spec.p):
                x = chunk_fn(tree_map(lambda a: a[s], st[0]), x, side_j)
            lj = sink_fn(sh, x, side_j)
            gs = torch.autograd.grad(lj, [alias[k] for k in wrt], allow_unused=True)
        loss += float(lj.detach())
        for k, g in zip(wrt, gs):
            if g is not None:
                acc[k] += g.float()
    return tree_unflatten(struct, acc), loss


def phase_train_checks(cfg, runs):
    band = (0.1 * np.log(cfg.vocab), 3.0 * np.log(cfg.vocab))
    first = {n: r["res"].losses[0] for n, r in runs.items()}
    for n, l0 in first.items():
        check(band[0] < l0 < band[1], f"{n}: step-0 loss {l0} outside {band}")
    same_seq = {r["seq"] for r in runs.values()} == {T_SEQ}
    if same_seq:
        check(len(set(first.values())) == 1, f"step-0 losses differ across schedules: {first}")
        ref = runs["1f1b"]["res"].losses
        worst = max(abs(a - b) / abs(b) for r in runs.values()
                    for a, b in zip(r["res"].losses[1:], ref[1:]))
        check(worst <= T_LATER_LOSS_RTOL, f"later losses differ across schedules by {worst}")
        print(f"[train-checks] step-0 loss {list(first.values())[0]} in band "
              f"({band[0]:.3f}, {band[1]:.3f}) and identical across {list(first)}; later "
              f"losses max rel diff across schedules {worst:.3g} (limit {T_LATER_LOSS_RTOL})")
    else:
        print(f"[train-checks] step-0 losses {first} in band; schedules ran at other seq lengths, "
              f"so no cross-schedule equality check")

    # step-0 gradient: the B/W-split pipeline against plain autograd
    _pipeline_vs_plain(cfg, "train-checks", v_check=True)


def _pipeline_vs_plain(cfg, tag, v_check=False, keep=False, p=T_P, seq=T_SEQ):
    """The step-0 gradient of the B/W-split pipeline (an eager zb-h1 walk at
    p stages, seed-0 weights, batch 0) against plain autograd through the
    same model; with ``v_check`` zb-v's (relaid weights) against the walk's
    as well.  A vlm or encdec model gets random patches or frames here (the
    launcher's are zeros), so front_proj's gradient is not zero.  With
    ``keep`` returns the walk's gradient leaves, keyed, on the host, and
    its loss."""
    sched = make_schedule("zb-h1", p, T_M)
    spec = RunSpec(p=p, n_chunks=1, microbatch=T_B, seq_len=seq, m=T_M)
    stacked, shared = init_params(cfg, spec, sched.placement, seed=0, device=DEV)
    data = SyntheticLM(DataConfig(global_batch=T_M * T_B, seq_len=seq, vocab=cfg.vocab))
    side = side_from_batch(data.batch_at(0), spec, DEV, cfg)
    front = front_spec(cfg)
    if front is not None:
        gen = torch.Generator(device=DEV).manual_seed(5)
        side[front[0]] = torch.randn(side[front[0]].shape, generator=gen,
                                     device=DEV).to(cfg.torch_dtype())
    grad_fn = PipelineExecutor(build_program(cfg, spec, sched.placement),
                               compile_plan(sched)).build_grad_fn()
    g_pipe, sg_pipe, loss_pipe = grad_fn(stacked, shared, side)
    if v_check:
        _check_v_grads(cfg, stacked, shared, side, g_pipe, sg_pipe, loss_pipe)
    kept = [(k, t.cpu()) for k, t in keyed_leaves((g_pipe, sg_pipe))] if keep else None
    pipe = tree_leaves((g_pipe, sg_pipe))
    del g_pipe, sg_pipe
    plain_tree, loss_plain = _plain_grads(cfg, spec, stacked, shared, side)
    plain = tree_leaves((plain_tree[0], plain_tree[1]))
    diff2 = sum(float((a - b).double().pow(2).sum()) for a, b in zip(pipe, plain))
    ref2 = sum(float(b.double().pow(2).sum()) for b in plain)
    rel = (diff2 / ref2) ** 0.5
    worst_leaf = max(float((a - b).double().norm()) / max(float(b.double().norm()), 1e-30)
                     for a, b in zip(pipe, plain))
    print(f"[{tag}] {cfg.name} step-0 gradient, pipeline (zb-h1, wgrad_accum) vs plain autograd: "
          f"rel_l2 over {len(plain)} leaves = {rel:.3g} (limit {T_GRAD_REL_L2}); worst leaf "
          f"rel_l2 {worst_leaf:.3g} (limit {T_GRAD_WORST_LEAF}); loss {float(loss_pipe):.6f} vs "
          f"{loss_plain:.6f}")
    check(rel <= T_GRAD_REL_L2, f"{cfg.name}: pipeline gradient disagrees with plain autograd")
    check(worst_leaf <= T_GRAD_WORST_LEAF,
          f"{cfg.name}: a gradient leaf disagrees with plain autograd")
    check(abs(float(loss_pipe) - loss_plain) <= 1e-3 * abs(loss_plain),
          f"{cfg.name}: step-0 loss differs")
    del pipe, plain, plain_tree, stacked, shared
    torch.cuda.empty_cache()
    return kept, float(loss_pipe)


def phase_train_noclip(cfg, runs):
    """zb-v against zb-h1 from the same weights with the clip off: the
    placements' gap in the clipped runs of phase 9 must vanish here (see
    T_LATER_LOSS_RTOL)."""
    seq = runs["zb-h1"]["seq"]
    if runs["zb-v"]["seq"] != seq:
        print("[train-noclip] zb-h1 and zb-v ran at other seq lengths: no placement check")
        return
    noclip = {}
    for name in ("zb-h1", "zb-v"):
        tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(grad_clip=None))
        res, *_, state = _train_full(cfg, name, seq, tcfg)
        del state
        torch.cuda.empty_cache()
        noclip[name] = res

    def gaps(a, b):
        return ([abs(x - y) / abs(y) for x, y in zip(a.losses, b.losses)],
                [abs(x - y) / abs(y) for x, y in zip(a.grad_norms, b.grad_norms)])

    clip_l, clip_g = gaps(runs["zb-v"]["res"], runs["zb-h1"]["res"])
    off_l, off_g = gaps(noclip["zb-v"], noclip["zb-h1"])
    print(f"[train-noclip] zb-v vs zb-h1, relative gaps per step; clip 1.0 (phase 9): losses "
          f"{[f'{e:.3g}' for e in clip_l]} grad norms {[f'{e:.3g}' for e in clip_g]}; clip off: "
          f"losses {[f'{e:.3g}' for e in off_l]} grad norms {[f'{e:.3g}' for e in off_g]} "
          f"(limit {T_LATER_LOSS_RTOL}); clip off grad norms zb-h1 {noclip['zb-h1'].grad_norms} "
          f"zb-v {noclip['zb-v'].grad_norms}")
    check(max(off_l + off_g) <= T_LATER_LOSS_RTOL, "with the clip off zb-v and zb-h1 still part")


def _check_v_grads(cfg, stacked, shared, side, g_lin, sg_lin, loss_lin):
    """zb-v's step-0 gradient (two chunks on the V placement, the same weights
    relaid) against zb-h1's, layer by layer and on the shared leaves."""
    sched = make_schedule("zb-v", T_P, T_M)
    spec = RunSpec(p=T_P, n_chunks=sched.n_chunks, microbatch=T_B, seq_len=T_SEQ, m=T_M)
    v_stacked = relay_to_placement(cfg, stacked, sched.placement)
    grad_fn = PipelineExecutor(build_program(cfg, spec, sched.placement),
                               compile_plan(sched)).build_grad_fn()
    g_v, sg_v, loss_v = grad_fn(v_stacked, shared, side)
    del v_stacked
    layers = _layer_map(cfg, sched.placement)  # per layer: its block in either layout
    v_layers = [tree_map(lambda a, s=s: a[s], g_v[c]["blocks"][bi]) for _, (c, s, bi) in layers]
    lin_layers = [tree_map(lambda a, s=s: a[s], g_lin[0]["blocks"][bi]) for (s, bi), _ in layers]
    got = tree_leaves((v_layers, sg_v))
    want = tree_leaves((lin_layers, sg_lin))
    check(len(got) == len(want), "zb-v and zb-h1 gradients have other structures")
    rels = [float((a - b).double().norm()) / max(float(b.double().norm()), 1e-30)
            for a, b in zip(got, want)]
    exact = sum(torch.equal(a, b) for a, b in zip(got, want))
    print(f"[train-checks] step-0 gradient, zb-v (2 chunks, V placement, relaid weights) vs "
          f"zb-h1: {exact} of {len(want)} leaves bit-identical, worst leaf rel_l2 "
          f"{max(rels):.3g} (limit {T_V_GRAD_WORST_LEAF}); loss {float(loss_v)!r} vs "
          f"{float(loss_lin)!r}")
    check(float(loss_v) == float(loss_lin), "zb-v's step-0 loss differs from zb-h1's")
    check(max(rels) <= T_V_GRAD_WORST_LEAF, "zb-v's step-0 gradient differs from zb-h1's")
    del g_v, sg_v, got, want, v_layers, lin_layers
    torch.cuda.empty_cache()


def phase_profile_train(name, plan, state, tag="profile-train", opts=None, cfg=None):
    """Device busy share of one full-width training step under ``name``
    (from fresh AdamW moments, or ``opts`` = (opt, shared_opt)); returns
    {kernel name: launches} of that step as the profiler saw them (empty
    when it recorded no device activity).  ``cfg`` gives a vlm or encdec
    model its front's side input."""
    from torch.profiler import ProfilerActivity, profile

    stacked, shared, spec, sched, step, data = state
    opt, sopt = opts if opts is not None else (adamw.init(stacked), adamw.init(shared))
    side = side_from_batch(data.batch_at(T_STEPS), spec, DEV, cfg)
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(stacked, shared, opt, sopt, side)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = {}
    for start, end, span, device in _profile_events(prof):
        if span.startswith("train_step.") and device == torch.autograd.DeviceType.CPU:
            spans[span] = spans.get(span, 0.0) + (end - start)
    print(f"[{tag}] {name} host spans: " + ", ".join(
        f"{k} {v / 1e3:.1f} ms" for k, v in sorted(spans.items())))
    # the spans show up on the device timeline too, as annotations: not kernels
    iv = [x for x in _device_intervals(prof) if not x[2].startswith("train_step.")]
    if not iv:
        print(f"[{tag}] the profiler recorded no device activity: busy share not measured")
        return {}
    busy = _union_us(iv)
    by_name, n_by_name = {}, {}
    for s_, e_, kernel in iv:
        by_name[kernel] = by_name.get(kernel, 0.0) + (e_ - s_)
        n_by_name[kernel] = n_by_name.get(kernel, 0) + 1
    total = sum(by_name.values())
    wg = sum(us for kernel, us in by_name.items() if "wgrad" in kernel)
    print(f"[{tag}] {name} step ({plan.n_ticks} ticks, {plan.total_ops} chunk ops of "
          f"{plan.n_chunks} chunk(s) a stage): wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (idle share {1 - busy / wall_us:.3f}); {len(iv)} device "
          f"activities; wgrad_accum kernels {wg / 1e3:.1f} ms = {wg / total:.1%} of device time")
    for kernel, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[{tag}] {us / total:6.1%} {us / 1e3:9.2f} ms {n_by_name[kernel]:6d}x  {kernel[:100]}")
    shares = []
    for label, key in PORT_KERNELS.items():
        us = sum(v for k, v in by_name.items() if key in k)
        n = sum(c for k, c in n_by_name.items() if key in k)
        if n:
            shares.append(f"{label} {us / 1e3:.2f} ms in {n} launches = {us / total:.2%}")
    print(f"[{tag}] {name}: the port's kernels' shares of device time: " + "; ".join(shares))
    print(f"[{tag}] {name}: profiled step and its reading took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return n_by_name


# the port's hand-written kernels by path, as the profiler names them
PORT_KERNELS = {"wgrad_accum wgmma": "wgrad_wgmma_kernel", "wgrad_accum thin": "wgrad_thin_kernel",
                "wgrad_accum fma": "wgrad_f32_kernel", "wgrad_accum mma_sync": "wgrad_bf16_kernel",
                "rmsnorm": "rmsnorm_", "slstm_scan fwd": "slstm_fwd_kernel",
                "slstm_scan bwd": "slstm_bwd_kernel"}


def _profile_events(prof):
    """(start_us, end_us, name, device type) of every event of a profile,
    read from its kineto results as recorded: ``prof.events()`` would build
    the profiler's event tree first, which took ~30 s of host time for one
    eager training step's ~10^5 events (H100, 700 W) and measures nothing
    more."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return [((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3, e.name(), e.device_type())
            for e in res.events()]


def _device_intervals(prof):
    """(start_us, end_us, name) of every device activity in a profile."""
    return [(start, end, name) for start, end, name, device in _profile_events(prof)
            if device == torch.autograd.DeviceType.CUDA]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_profile(cfg, stacked, shared, prompts, new_tokens: int = 2):
    """Device busy share of the serving path under torch.profiler: a
    prefill-only run and a prefill + decode run (2 decode steps; 4 until
    phase 32 needed the time); decode's share is their difference.  The
    profiler adds host time to every op, so the idle share it shows is an
    upper bound on the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile

    runs, t_phase = {}, time.perf_counter()
    for new in (0, new_tokens):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(cfg, stacked, shared, prompts, p=P, new_tokens=new)
            wall_us = (time.perf_counter() - t0) * 1e6
        iv = _device_intervals(prof)
        runs[new] = (wall_us, _union_us(iv), iv)
    (w0, b0, _), (w1, b1, iv1) = runs[0], runs[new_tokens]
    if not iv1:
        print("[profile] the profiler recorded no device activity: busy share not measured")
        return
    print(f"[profile] prefill: wall {w0 / 1e3:.1f} ms, device busy {b0 / 1e3:.1f} ms "
          f"(idle share {1 - b0 / w0:.3f})")
    print(f"[profile] decode ({new_tokens} steps): wall {(w1 - w0) / 1e3:.1f} ms, device busy "
          f"{(b1 - b0) / 1e3:.1f} ms (idle share {1 - (b1 - b0) / (w1 - w0):.3f})")
    by_name = {}
    for s_, e_, name in iv1:
        by_name[name] = by_name.get(name, 0.0) + (e_ - s_)
    total = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] {us / total:6.1%} {us / 1e3:9.2f} ms  {name[:100]}")
    print(f"[profile] both profiled runs and their reading took "
          f"{time.perf_counter() - t_phase:.1f} s")


def _gib(x: float) -> str:
    return f"{x / 2**30:.3f}"


def phase_plan(cfg):
    """The HBM planner at full width under both fidelities, over a budget
    sweep; the measured fidelity's slot bytes are taken on the card."""
    run = dict(p=T_P, m=T_M, microbatch=T_B, seq_len=T_SEQ)
    t0 = time.perf_counter()
    planners = {"model": HBMPlanner(cfg, **run),
                "measured": HBMPlanner(cfg, program_factory=stage_program_factory(
                    cfg, T_P, T_M, T_B, T_SEQ, DEV), **run)}
    for n_chunks in (1, 2):
        t1 = time.perf_counter()
        _, sl = planners["measured"].slot_bytes(n_chunks)
        bm = planners["model"].bytes_1c if n_chunks == 1 else planners["model"].bytes_2c
        print(f"[plan] measured slot bytes on the card, {n_chunks} chunk(s) a stage "
              f"({time.perf_counter() - t1:.2f}s with init): residual {[_gib(b) for b in sl['res']]} "
              f"GiB, W-context {[_gib(b) for b in sl['wctx']]} GiB (shared with the residual "
              f"{[_gib(b) for b in sl['res_wctx_shared']]}), sink {_gib(sl['sink'])} + W-context "
              f"{_gib(sl['sink_wctx'])} GiB; per stage unit M_B {_gib(sum(sl['res']))} / M_W "
              f"{_gib(sum(sl['wctx']))} GiB against the byte model's {_gib(bm.m_b_bytes)} / "
              f"{_gib(bm.m_w_bytes)} GiB")
    for fid, planner in planners.items():
        prev = None
        for gib in PLAN_BUDGETS_GIB:
            r = planner.plan(gib * 2**30)
            if not r.feasible:
                print(f"[plan] {fid} {gib} GiB: infeasible, cheapest plan needs "
                      f"{_gib(r.min_required_bytes)} GiB")
                continue
            c = r.chosen
            items = " ".join(f"{k}={_gib(v)}" for k, v in c.breakdown.items().items())
            print(f"[plan] {fid} {gib} GiB -> {c.name} cost {c.cost:g} bubble "
                  f"{c.bubble_rate:.4f} total {_gib(c.total_bytes)} GiB ({items})")
            check(prev is None or c.cost <= prev, f"{fid}: cost rose with the budget at {gib} GiB")
            prev = c.cost
        low = PLAN_BUDGETS_GIB[0]
        try:
            replan_under_budget(cfg, T_P, T_M, T_B, T_SEQ, low * 2**30, program_factory=(
                planner.program_factory if fid == "measured" else None))
        except RuntimeError as e:
            msg = str(e)
            check("binding term: " in msg, f"{fid}: the {low} GiB refusal names no binding term")
            print(f"[plan] {fid} {low} GiB refused: {msg.splitlines()[0]}")
        else:
            check(False, f"{fid}: {low} GiB did not raise RuntimeError")
    print(f"[plan] sweep of {len(PLAN_BUDGETS_GIB)} budgets under both fidelities in "
          f"{time.perf_counter() - t0:.1f}s")
    return planners


def _gate(tag, what, one, mem, share=PLAN_OVERSHOOT_MAX):
    """A run's reserved peak against its priced one-card total (phase 13):
    the peak must not pass the total, and with ``share`` the total may pass
    the peak by at most that share of it.  Returns the overshoot in bytes."""
    peak = mem["reserved"]
    over = one.total - peak
    print(f"[{tag}] {what}: max_memory_reserved {_gib(peak)} GiB (allocated "
          f"{_gib(mem['allocated'])}; {_gib(mem['walk_reserved'])} and {_gib(mem['walk_allocated'])} "
          f"at the first walk's end) against "
          f"the priced one-card total {one.report()}: overshoot (priced - peak) {_gib(over)} GiB, "
          f"{over / peak:.2%} of the peak")
    check(peak <= one.total, f"{what}: the card reserved {_gib(peak)} GiB, more than the priced "
          f"one-card total {_gib(one.total)} GiB")
    if share is not None:
        check(over <= share * peak, f"{what}: the priced total passes the peak by {over / peak:.2%}, "
              f"more than {share:.0%}")
    return over


def _own_record(cfg, mode, p, seq=T_SEQ, own_seq=False):
    """The calibration record that prices a gated run of ``cfg`` on ``p``
    stages at ``seq``, checked to be measured at the run's own depth: its
    cut's, or the published depth's where it has no cut; with ``own_seq``
    at the run's own seq as well."""
    rec = cuda_temp_record(cfg.name, mode, layers=cfg.n_layers, p=p, seq_len=seq)
    check(rec is not None, f"{cfg.name}: no calibration record under the {mode} executor")
    full = {c.name: c.n_layers for c in all_configs().values()}[cfg.name]
    layers_at, p_at, seq_at = record_key(rec)
    check((layers_at or full, p_at) == (cfg.n_layers, p) and (seq_at == seq or not own_seq),
          f"{cfg.name} {mode}: priced with a record measured at "
          f"{rec.get('cut') or 'the full depth'}, not at this run's {cfg.n_layers} layers at "
          f"p={p}" + (f", seq {seq}" if own_seq else ""))
    return rec


def _fresh_calibration(tag, cfg, mode, priced_runs):
    """The record ``launch/calibrate.py`` would write now from this run's
    own runs ({schedule: (one-card parts, memory peaks)}), printed beside
    the checked-in one; not gated."""
    runs = {name: dict(**mem, priced=one.weights + one.accumulators + one.walk, walk=one.walk,
                       transient=one.transient) for name, (one, mem) in priced_runs.items()}
    weights = next(iter(priced_runs.values()))[0].weights
    rec = calibration_record(cfg, mode, runs, p=T_P, m=T_M, microbatch=T_B, seq_len=T_SEQ,
                             weights_bytes=weights, card="", steps=0, seed=0)
    table = _own_record(cfg, mode, T_P)
    def parts(r):
        return (f"remainder {_gib(r.get('cuda_temp_bytes', 0.0))} GiB (allocator "
                f"{_gib(r.get('cuda_temp_fixed_bytes', 0.0))} + unpriced live "
                f"{_gib(r.get('cuda_temp_scaled_bytes', 0.0))}), optimizer overhang "
                f"{r.get('optimizer_overhang', float('nan')):.4f} and reuse "
                f"{r.get('optimizer_reuse', float('nan')):.4f}")

    print(f"[{tag}] {cfg.name} {mode}: from this run's {len(runs)} schedules {parts(rec)}; "
          f"checked in {parts(table)} ({table.get('card')})")


def phase_plan_vs_card(cfg, runs, planners, mode, tag="plan-vs-card"):
    """Phase 13 for the runs of one executor mode: each run's reserved peak
    against the planner's one-card total (measured fidelity, the temp term
    of ``mode``), gated; the model fidelity's total beside it; then the
    remainder and overhang ``launch/calibrate.py`` would write from them."""
    priced, overs = {}, []
    for name, r in runs.items():
        if r["seq"] != T_SEQ:
            print(f"[{tag}] {name} ran at seq {r['seq']}: not compared")
            continue
        one = planners["measured"].one_card_bytes(r["sched"], mode)
        overs.append(_gate(tag, f"{cfg.name} {mode} {name}", one, r["mem"]))
        print(f"[{tag}] {cfg.name} {mode} {name}: the model fidelity's total "
              f"{_gib(planners['model'].one_card_bytes(r['sched'], mode).total)} GiB")
        priced[name] = (one, r["mem"])
    if overs:
        print(f"[{tag}] {cfg.name} {mode}: overshoot over {len(overs)} schedules min "
              f"{_gib(min(overs))} max {_gib(max(overs))} GiB")
    _fresh_calibration(tag, cfg, mode, priced)


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*") if f.is_file())


def phase_launch_budget(cfg):
    """``launch.train.main`` at full width and the training phases' depth
    (``--layers``) under a memory budget
    at which the planner picks a zero-bubble schedule, checkpointing into a
    temporary directory, on the card under the graph executor; the
    final checkpoint restores bit for bit.  The launches are those of the
    one capture (a warm-up walk and the captured one: the replays launch
    nothing from Python) plus those of the planner's slot measurement on
    the card."""
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    out = io.StringIO()
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        try:
            with contextlib.redirect_stdout(out):
                res = train_main(["--arch", ARCH, "--layers", str(cfg.n_layers),
                                  "--pipe-size", str(T_P), "--m", str(T_M),
                                  "--microbatch", str(T_B), "--seq-len", str(T_SEQ), "--steps",
                                  str(L_STEPS), "--lr", "1e-3", "--memory-budget-mb",
                                  str(L_BUDGET_MB), "--ckpt-dir", ckpt, "--device", DEV])
        finally:
            print(out.getvalue(), end="")
        launches = _read_counts()
        lines = out.getvalue().splitlines()
        check(lines[-1].endswith(" executor=graph"),
              f"the launcher's last line does not say executor=graph: {lines[-1]!r}")
        _launcher_reserved_gate("launch", f"launcher {res.schedule.name} under {L_BUDGET_MB} MiB",
                                lines)
        sched = res.schedule
        check(sched.name not in ("1f1b", "1f1b-interleaved"),
              f"the planner picked {sched.name} at {L_BUDGET_MB} MiB, not a zero-bubble schedule")
        want = _check_counts(f"launcher {sched.name}", launches,
                             expected_train_launches(cfg, T_P, sched.n_chunks, T_M), 2,
                             extra=expected_measure_launches(cfg, T_P))
        check(res.losses[-1] < res.losses[0], f"launcher losses did not fall: {res.losses}")
        step = store.latest_step(ckpt)
        check(step == L_STEPS, f"newest checkpoint is step {step}, not {L_STEPS}")
        nbytes = _dir_bytes(pathlib.Path(ckpt) / f"step_{step:08d}")
        spec = RunSpec(p=T_P, n_chunks=sched.n_chunks, microbatch=T_B, seq_len=T_SEQ, m=T_M)
        proto = init_state(*init_params(cfg, spec, sched.placement, seed=1, device=DEV))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = store.restore(ckpt, step, proto)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        leaves = list(zip(tree_leaves(got), tree_leaves(res.state)))
        exact = sum(torch.equal(a, b) for a, b in leaves)
        print(f"[launch] {sched.name} ({sched.n_chunks} chunk(s) a stage) under "
              f"{L_BUDGET_MB} MiB: losses {res.losses}, ms per step "
              f"{[round(t * 1e3, 1) for t in res.step_s]}, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches wgrad_accum "
              f"{launches[0]} {launches[2]} rmsnorm {launches[1]} (expected {want}: the "
              f"planner's measurement and one capture's warm-up and captured walks); checkpoint "
              f"step {step}: {nbytes / 1e9:.2f} GB, save {res.save_s} s, restore {restore_s:.2f} s "
              f"({nbytes / 1e9 / restore_s:.2f} GB/s); {exact} of {len(leaves)} leaves restored "
              f"bit for bit")
        check(exact == len(leaves), "the final checkpoint did not restore bit for bit")
        del got, proto, leaves, res
        return launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()


def _launcher_reserved_gate(tag, what, lines, priced=None):
    """The launcher's reserved bytes after its first step against the
    priced one-card total of the schedule it ran: the one it prints beside
    them when it planned, else ``priced`` (bytes)."""
    found = [ln for ln in lines if ln.startswith("max_memory_reserved after the first step ")]
    check(len(found) == 1, f"{what}: the launcher printed {len(found)} reserved lines, want 1")
    words = found[0].split()
    reserved = float(words[5]) * 2**20
    if priced is None:
        check("priced one-card total" in found[0], f"{what}: no priced total beside the reserved "
              f"bytes: {found[0]!r}")
        priced = float(found[0].split("priced one-card total ")[1].split()[0]) * 2**20
    print(f"[{tag}] {what}: max_memory_reserved after the first step {_gib(reserved)} GiB <= "
          f"priced one-card total {_gib(priced)} GiB: overshoot {_gib(priced - reserved)} GiB "
          f"({(priced - reserved) / reserved:.2%} of the peak)")
    check(reserved <= priced, f"{what}: the launcher's run reserved {_gib(reserved)} GiB, more "
          f"than its priced one-card total {_gib(priced)} GiB")


def phase_replay(cfg):
    """The driver's failure replay at full width, depth cut to
    R_LAYERS_PER_STAGE layers a stage, under each executor mode: a failure
    at step R_FAIL_AT restores the step-R_EVERY checkpoint onto fresh
    tensors (in graph mode they must be captured again); the replayed
    losses and grad norms must equal an uninterrupted run's of the same
    mode, and the graph's uninterrupted run the eager one's.  Returns both
    kernels' launches over the four runs."""
    cut = dataclasses.replace(cfg, n_layers=R_LAYERS_PER_STAGE * T_P)
    sched = make_schedule(R_SCHEDULE, T_P, T_M)
    spec = RunSpec(p=T_P, n_chunks=sched.n_chunks, microbatch=T_B, seq_len=T_SEQ, m=T_M)
    plan = compile_plan(sched)
    data = SyntheticLM(DataConfig(global_batch=T_M * T_B, seq_len=T_SEQ, vocab=cut.vocab))
    data_at = make_data_at(data, spec, DEV)
    per_step = expected_train_launches(cut, T_P, sched.n_chunks, T_M)
    total = _zero_counts()
    clean_by_mode = {}
    for mode in ("eager", "graph"):
        launches, clean_by_mode[mode] = _replay_one_mode(cut, sched, spec, plan, data_at, mode,
                                                        per_step)
        total = _add_counts(total, launches)
    gaps = [abs(g[key] - e[key]) / abs(e[key])
            for g, e in zip(clean_by_mode["graph"], clean_by_mode["eager"])
            for key in ("loss", "grad_norm")]
    print(f"[replay] uninterrupted graph run vs eager run: max rel gap {max(gaps):.3g} (limit "
          f"{R_RTOL})")
    check(max(gaps) <= R_RTOL, "the graph executor's uninterrupted run differs from the eager one")
    return total


def _replay_one_mode(cut, sched, spec, plan, data_at, mode, per_step):
    """Phase 15 under one executor mode: an uninterrupted run and one that
    fails once; returns both kernels' launches and the uninterrupted run's
    metrics by step."""

    def make_step():
        step, _ = build_train_step(cut, spec, plan, sched.placement,
                                   TrainStepConfig(executor_mode=mode))
        return step

    held = []

    def fresh():
        # the state this one replaces stays alive until it exists, so a
        # restore always lands at other addresses and a graph must capture
        # again (the allocator could otherwise hand back the same blocks)
        state = init_state(*init_params(cut, spec, sched.placement, seed=0, device=DEV))
        held[:] = [state]
        return state

    def tracked(step):
        """make_step_fn(step), logging the parameters' addresses at every step."""
        step_fn, ptrs = make_step_fn(step), []

        def fn(state, side):
            ptrs.append(tuple(t.data_ptr() for t in tree_leaves((state["params"],
                                                                 state["shared"]))))
            return step_fn(state, side)

        return fn, ptrs

    def moves(ptrs):
        return sum(a != b for a, b in zip(ptrs, ptrs[1:]))

    ckpt = tempfile.mkdtemp(prefix="repro_torch_replay_")
    failed = []

    def fail_once(k):
        if k == R_FAIL_AT and not failed:
            failed.append(k)
            raise RuntimeError("simulated node failure")

    try:
        _reset_counts()
        step = make_step()
        fn, clean_ptrs = tracked(step)
        _, clean_log = TrainDriver(DriverConfig(ckpt_dir=None), fn, fresh, data_at).run(R_STEPS)
        clean_captures = getattr(step.grad_fn, "captures", None)
        held.clear()
        del step, fn  # the uninterrupted run's state, graph and pool
        torch.cuda.empty_cache()
        step = make_step()
        fn, ptrs = tracked(step)
        driver = TrainDriver(DriverConfig(ckpt_dir=ckpt, ckpt_every=R_EVERY, max_retries=1), fn,
                             fresh, data_at)
        _, log = driver.run(R_STEPS, fail_hook=fail_once)
        captures = getattr(step.grad_fn, "captures", None)
        held.clear()
        del step, fn
        launches = _read_counts()
        ran = [k for k, _ in log]
        resumed = R_FAIL_AT // R_EVERY * R_EVERY  # the newest checkpoint at the failure
        check(failed == [R_FAIL_AT] and ran == list(range(R_FAIL_AT)) + list(range(resumed, R_STEPS)),
              f"{mode} replay ran steps {ran}")
        check(moves(clean_ptrs) == 0 and moves(ptrs) == 1,
              f"{mode}: the parameters moved {moves(clean_ptrs)} time(s) uninterrupted and "
              f"{moves(ptrs)} with the failure; want 0 and 1 (the restore onto fresh tensors)")
        if mode == "graph":
            check(clean_captures == 1 + moves(clean_ptrs) and captures == 1 + moves(ptrs),
                  f"captures: {clean_captures} uninterrupted, {captures} with the failure; want "
                  f"one and one more for each move of the parameters")
            # two walks (warm-up and captured) a capture; replays launch nothing from Python
            walks = 2 * (clean_captures + captures)
        else:
            walks = R_STEPS + len(log)  # one walk a step
        _check_counts(f"{mode} replay", launches, per_step, walks)
        clean = dict(clean_log)
        gaps, exact = [], 0
        for k, met in log:
            for key in ("loss", "grad_norm"):
                gaps.append(abs(met[key] - clean[k][key]) / abs(clean[k][key]))
                exact += met[key] == clean[k][key]
        graphs = (f" ({clean_captures} capture uninterrupted, {captures} with the failure)"
                  if mode == "graph" else "")
        print(f"[replay] {R_SCHEDULE} {cut.n_layers} layers ({R_LAYERS_PER_STAGE} a stage, depth cut "
              f"to keep checkpoints small), full width, executor {mode}{graphs}: {R_STEPS} steps, "
              f"checkpoint every {R_EVERY}, failure at step {R_FAIL_AT}; steps run {ran}; "
              f"parameters moved {moves(ptrs)} time(s); losses clean "
              f"{[clean[k]['loss'] for k in range(R_STEPS)]} replayed "
              f"{[m['loss'] for _, m in log]}; grad norms clean "
              f"{[clean[k]['grad_norm'] for k in range(R_STEPS)]} replayed "
              f"{[m['grad_norm'] for _, m in log]}; {exact} of {len(gaps)} equal bit for bit, "
              f"max rel gap {max(gaps):.3g} (limit {R_RTOL}: the embedding gradient's index_add_ "
              f"sums colliding rows with atomics in no fixed order); checkpoint "
              f"{_dir_bytes(pathlib.Path(ckpt) / f'step_{R_STEPS:08d}') / 1e9:.2f} GB, saves "
              f"{[round(t, 2) for t in driver.save_times]} s")
        check(max(gaps) <= R_RTOL, f"{mode}: the replayed steps differ from the uninterrupted run")
        return launches, [clean[k] for k in range(R_STEPS)]
    finally:
        held.clear()
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()


def _count_walks(grad_fn):
    """Wrap a graph-mode ``grad_fn``'s eager walk; the returned list gets,
    for each walk it runs (warm-up, capture, warm-up, capture, ...), both
    kernels' launches during it and its host seconds."""
    walk, log = grad_fn.walk, []

    def counted(*args):
        before, t0 = _read_counts(), time.perf_counter()
        out = walk(*args)
        after = _read_counts()
        log.append((_add_counts(after, before, -1), time.perf_counter() - t0))
        return out

    grad_fn.walk = counted
    return log


def _kernel_launches(n_by_name, needle):
    return sum(n for kernel, n in n_by_name.items() if needle in kernel)


def _profile_replay(name, grad_fn, stacked, shared, side):
    """The pipeline alone under torch.profiler: one graph-mode ``grad_fn``
    call (the side-input copies, the replay, the loss's clone)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grad_fn(stacked, shared, side)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    iv = _device_intervals(prof)
    if not iv:
        print(f"[profile-graph] {name} pipeline alone: no device activity recorded, not measured")
        return
    busy = _union_us(iv)
    print(f"[profile-graph] {name} pipeline alone (one grad_fn call: side copies, replay, loss "
          f"clone): {len(iv)} device activities, wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (idle share {1 - busy / wall_us:.3f})")


def _graph_vs_eager(name, ref, got_keyed):
    """The graph's gradient leaves against an eager walk's (``ref``, keyed,
    on the host): bit for bit, but the embedding's within G_RTOL relative
    (index_add_ atomics).  Returns (leaves equal bit for bit, embedding gap)."""
    exact, embed_gap = 0, None
    for (k, want), (k2, got) in zip(ref, got_keyed):
        check(k == k2, f"{name}: gradient leaves {k} and {k2} out of order")
        got = got.cpu()
        if k == "[1]['embed']":  # index_add_ atomics: no fixed order of the fp32 sums
            embed_gap = float((got - want).double().norm() / want.double().norm())
            check(embed_gap <= G_RTOL, f"{name}: graph embedding gradient off by {embed_gap}")
        else:
            check(torch.equal(got, want), f"{name}: graph gradient leaf {k} differs from eager")
            exact += 1
    check(embed_gap is not None, f"{name}: no embedding gradient leaf")
    return exact, embed_gap


def phase_train_graph(cfg, runs):
    """Phase 9's runs again under ``executor_mode="graph"``, schedule by
    schedule from the same seed-0 weights, against phase 9 and a fresh
    eager walk; returns ({schedule: both kernels' launches over its walks},
    {schedule: run for phase 13's graph gate})."""
    out, mem_runs = {}, {}
    for name in T_SCHEDULES:
        eager, t_sched = runs[name], time.perf_counter()
        seq, sched, plan = eager["seq"], eager["sched"], eager["plan"]
        per_step = expected_train_launches(cfg, T_P, sched.n_chunks, T_M)
        stacked, shared, spec, data = _init_full(cfg, sched, seq)
        side0 = side_from_batch(data.batch_at(0), spec, DEV)
        # the step-0 gradient of a fresh eager walk, kept on the host; the
        # walk must not wait for the device (a capture would refuse it)
        torch.cuda.set_sync_debug_mode("error")
        try:
            g_e, sg_e, loss_e = PipelineExecutor(build_program(cfg, spec, sched.placement),
                                                 plan).build_grad_fn()(stacked, shared, side0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ref = [(k, t.cpu()) for k, t in keyed_leaves((g_e, sg_e))]
        loss_e = float(loss_e)
        del g_e, sg_e
        step, _ = build_train_step(cfg, spec, plan, sched.placement,
                                   TrainStepConfig(executor_mode="graph"))
        walks = _count_walks(step.grad_fn)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(stacked, shared)  # the moments exist at capture, as in the launcher
        t0 = time.perf_counter()
        g_g, sg_g, loss_g = step.grad_fn(stacked, shared, side0)  # capture, then replay
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        walk = _walk_peaks()
        exact, embed_gap = _graph_vs_eager(name, ref, keyed_leaves((g_g, sg_g)))
        check(float(loss_g) == loss_e, f"{name}: graph step-0 loss {float(loss_g)!r} != eager "
              f"{loss_e!r}")
        del g_g, sg_g, ref
        _reset_counts()
        res = train(cfg, spec, step, stacked, shared, data, G_STEPS,
                    log=lambda s: print(f"[train-graph] {name}: {s}"), state=state)
        del state
        replay_launches = _read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        mem_runs[name] = dict(seq=seq, sched=sched, mem=_mem(walk))
        gf = step.grad_fn
        check(gf.captures == 1 and len(walks) == 2,
              f"{name}: {gf.captures} captures and {len(walks)} walks, want 1 and 2")
        for what, (launches, _) in zip(("warm-up", "capture"), walks):
            want = _check_counts(f"{name} {what}", launches, per_step, 1)
        check(replay_launches == _zero_counts(),
              f"{name}: the replayed steps launched {replay_launches} from Python")
        e_res = eager["res"]
        check(res.losses[0] == e_res.losses[0] == loss_e,
              f"{name}: graph step-0 loss {res.losses[0]!r} != phase 9's {e_res.losses[0]!r}")
        gaps_l = [abs(a - b) / abs(b) for a, b in zip(res.losses[1:T_STEPS], e_res.losses[1:])]
        gaps_g = [abs(a - b) / abs(b) for a, b in zip(res.grad_norms[:T_STEPS], e_res.grad_norms)]
        check(len(gaps_l) == T_STEPS - 1 and len(gaps_g) == T_STEPS,
              f"{name}: {len(e_res.losses)} eager steps to compare, want {T_STEPS}")
        check(all(np.isfinite(res.losses + res.grad_norms)), f"{name}: non-finite graph metrics")
        check(max(gaps_l + gaps_g) <= G_RTOL,
              f"{name}: graph losses/grad norms differ from phase 9's by {max(gaps_l + gaps_g)}")
        med, e_med = float(np.median(res.step_s[1:])), float(np.median(e_res.step_s[1:]))
        tokens = T_M * T_B * seq
        print(f"[train-graph] {name} p={T_P} m={T_M} b={T_B} seq={seq}: capture "
              f"{gf.capture_s[0]:.2f} s (host: warm-up walk {walks[0][1]:.2f} s, captured walk "
              f"{walks[1][1]:.2f} s), first call {first_s:.2f} s; ms_per_step replay median(steps "
              f"1-{G_STEPS - 1})={med * 1e3:.1f} all={[round(t * 1e3, 1) for t in res.step_s]} | "
              f"eager (phase 9) median(steps 1-{T_STEPS - 1})={e_med * 1e3:.1f} median="
              f"{float(np.median(e_res.step_s)) * 1e3:.1f}; tokens_per_s graph={tokens / med:.0f} "
              f"eager={tokens / e_med:.0f}; peak GB graph allocated={peak_gb:.2f} reserved="
              f"{reserved_gb:.2f} | eager allocated={eager['peak_gb']:.2f} reserved="
              f"{eager['reserved_gb']:.2f}; launches per capture and per warm-up "
              f"wgrad_accum={walks[1][0][0]} {walks[1][0][2]} rmsnorm={walks[1][0][1]} (expected "
              f"{want}), from Python during the replayed steps {replay_launches[:2]}")
        print(f"[train-graph] {name} checks: step-0 loss {res.losses[0]!r} == eager walk == "
              f"phase 9; step-0 gradient {exact} of {exact + 1} leaves bit for bit, embedding "
              f"rel_l2 {embed_gap:.3g} (limit {G_RTOL}); later losses rel gaps "
              f"{[f'{e:.3g}' for e in gaps_l]}, grad norms {[f'{e:.3g}' for e in gaps_g]} (limit "
              f"{G_RTOL}); losses {res.losses} grad_norms {res.grad_norms} amended {res.amended}")
        if name in T_PROFILED:
            n_by_name = phase_profile_train(name, plan, (stacked, shared, spec, sched, step, data),
                                            tag="profile-graph")
            if n_by_name:
                got = (_kernel_launches(n_by_name, "wgrad_wgmma_kernel"),
                       _kernel_launches(n_by_name, "rmsnorm_bulk_kernel"))
                check(got == per_step, f"{name}: a profiled replay ran (wgrad_wgmma, rmsnorm) "
                      f"kernels {got}, the structure implies {per_step}")
                print(f"[profile-graph] {name}: one replayed step ran {got[0]} wgrad_wgmma_kernel "
                      f"and {got[1]} rmsnorm_bulk_kernel (expected {per_step}); "
                      f"{gf.captures} capture(s) in all")
            _profile_replay(name, gf, stacked, shared, side_from_batch(data.batch_at(G_STEPS),
                                                                      spec, DEV))
        out[name] = _add_counts(walks[0][0], walks[1][0])
        del step, gf, stacked, shared, res
        torch.cuda.empty_cache()
        print(f"[train-graph] {name}: {time.perf_counter() - t_sched:.1f} s in all")
    return out, mem_runs


def phase_heldout(cfg):
    """Phase 13 on runs the calibration never saw: internlm2 at seq H_SEQ
    under the graph executor, H_STEPS steps of each of H_SCHEDULES, priced by
    a planner whose slots are measured at that sequence (the remainder
    scaled by the M_B ratio).  Returns {run: both kernels' launches}."""
    planner = HBMPlanner(cfg, p=T_P, m=T_M, microbatch=T_B, seq_len=H_SEQ, executor_mode="graph",
                         program_factory=stage_program_factory(cfg, T_P, T_M, T_B, H_SEQ, DEV))
    for c in (1, 2):
        planner.slot_bytes(c)
    torch.cuda.empty_cache()
    out = {}
    for name in H_SCHEDULES:
        sched = make_schedule(name, T_P, T_M)
        plan = compile_plan(sched)
        stacked, shared, spec, data = _init_full(cfg, sched, H_SEQ)
        step, _ = build_train_step(cfg, spec, plan, sched.placement,
                                   TrainStepConfig(executor_mode="graph"))
        walks = _count_walks(step.grad_fn)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, walk = _first_walk_peaks(step, stacked, shared, spec, data)
        _reset_counts()
        res = train(cfg, spec, step, stacked, shared, data, H_STEPS, state=state)
        del state
        check(_read_counts() == _zero_counts(), f"held-out {name}: the replays launched kernels")
        check(all(np.isfinite(res.losses + res.grad_norms)), f"held-out {name}: non-finite metrics")
        per_step = expected_train_launches(cfg, T_P, sched.n_chunks, T_M)
        for what, (launches, _) in zip(("warm-up", "capture"), walks):
            _check_counts(f"held-out {name} {what}", launches, per_step, 1)
        _gate("plan-vs-card", f"held out: {cfg.name} graph {name} at seq {H_SEQ}, {H_STEPS} steps "
              f"(losses {res.losses})", planner.one_card_bytes(sched), _mem(walk),
              share=None)
        out[f"heldout-{name}"] = _add_counts(walks[0][0], walks[1][0])
        del step, stacked, shared, res
        torch.cuda.empty_cache()
    return out


def phase_serve_gemma2(cfg):
    """Phase 17: gemma2-2b served at full width and depth with prompts past
    its window; returns the RMSNorm launches of the timed run and their
    kernel paths."""
    window = cfg.extras_dict()["window"]
    check(GS_PROMPT > window and GS_PROMPT % window != 0,
          f"the prompt ({GS_PROMPT}) must pass the window ({window}) and not be a multiple of it")
    spec = RunSpec(p=GS_P, n_chunks=1, microbatch=GS_B, seq_len=GS_PROMPT, m=GS_M)
    placement = Placement.linear(GS_P)
    S = GS_PROMPT + GS_NEW
    _, _, cache_init = build_serve_step(cfg, spec, placement, "prefill")
    blocks, g = group_layout(cfg, GS_P, 1)
    meta = cache_init(GS_B, S, device="meta", lead=(GS_P, GS_M))
    slots = {kinds[0]: tuple(c[0]["k"].shape)[-3] for kinds, c in zip(blocks, meta)}
    check(slots == {"attn_local": window, "attn": S},
          f"cache slots {slots}: want the ring of {window} and the global {S}")
    t0 = time.perf_counter()
    stacked, shared = init_params(cfg, spec, placement, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"[serve-gemma2] init {cfg.name} ({cfg.n_layers} layers in {GS_P} groups of {g}, "
          f"{GS_P * g - cfg.n_layers} padded; kinds {[k[0] for k in blocks[:2]]} alternating; "
          f"d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.d_model // cfg.n_heads}, "
          f"vocab {cfg.vocab}, {cfg.dtype}) on {DEV} in {time.perf_counter() - t0:.1f}s; cache "
          f"slots a layer: ring {slots['attn_local']}, global {slots['attn']}")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (GS_M, GS_B, GS_PROMPT))
    serve(cfg, stacked, shared, prompts, p=GS_P, new_tokens=1)  # warm-up (cuBLAS, allocator)

    torch.cuda.reset_peak_memory_stats()
    res, launches, by_path, _ = _serve_counted(
        "serve-gemma2", cfg, GS_P, GS_M, GS_NEW,
        lambda: serve(cfg, stacked, shared, prompts, p=GS_P, new_tokens=GS_NEW,
                      log=lambda s: print(f"[serve-gemma2] {s}")))
    want = expected_norm_launches(cfg, GS_P, GS_M, 1 + GS_NEW)
    _check_served(cfg, res, GS_M, GS_B, GS_NEW)
    decode_ms = [s * 1e3 for s in res.decode_s]
    print(f"[serve-gemma2] p={GS_P} m={GS_M} b={GS_B} prompt={GS_PROMPT} new={GS_NEW}: "
          f"prefill_ms={res.prefill_s * 1e3:.1f} "
          f"decode_ms_per_step mean={np.mean(decode_ms):.2f} median={np.median(decode_ms):.2f} "
          f"min={min(decode_ms):.2f} max={max(decode_ms):.2f} "
          f"generated_tok_per_s={GS_M * GS_B * GS_NEW / sum(res.decode_s):.1f} "
          f"max_memory_allocated_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}; "
          f"rmsnorm launches {launches} == expected {want}, by path {by_path}")
    phase_consistency(cfg, stacked, shared, prompts, res, p=GS_P, limit=GS_CONSIST_REL_L2,
                      tag="serve-gemma2")
    del stacked, shared, res
    torch.cuda.empty_cache()
    return launches, by_path


def _gpt3_graph_run(cfg, name, seq, ref=None, loss_ref=None, clip=True):
    """One schedule of phase 18 at ``seq``: the seed-0 model (relaid onto the
    V placement where it has two chunks), the AdamW state allocated, the
    pipeline captured in a CUDA graph at the first call, then GPT3_STEPS
    training steps through the driver, all replays (``clip`` False: the
    optimizer's global-norm clip off).  With ``ref`` (keyed host leaves of
    an eager walk) the step-0 gradient is held to it."""
    sched = make_schedule(name, T_P, T_M)
    plan = compile_plan(sched)
    per_step = expected_train_launches(cfg, T_P, sched.n_chunks, T_M)
    stacked, shared, spec, data = _init_full(cfg, sched, seq)
    acfg = adamw.AdamWConfig() if clip else adamw.AdamWConfig(grad_clip=None)
    step, _ = build_train_step(cfg, spec, plan, sched.placement,
                               TrainStepConfig(adamw=acfg, executor_mode="graph"))
    if not clip:
        name = f"{name} (clip off)"
    walks = _count_walks(step.grad_fn)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    state = init_state(stacked, shared)  # the moments exist at capture, as in the launcher
    side0 = side_from_batch(data.batch_at(0), spec, DEV)
    t0 = time.perf_counter()
    g, sg, loss0 = step.grad_fn(stacked, shared, side0)  # capture, then replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    walk = _walk_peaks()
    loss0 = float(loss0)
    gap = ""
    if ref is not None:
        exact, embed_gap = _graph_vs_eager(f"gpt3 {name}", ref, keyed_leaves((g, sg)))
        check(loss0 == loss_ref, f"gpt3 {name}: graph step-0 loss {loss0!r} != eager {loss_ref!r}")
        gap = (f"; step-0 gradient against the eager walk: {exact} of {exact + 1} leaves bit for "
               f"bit, embedding rel_l2 {embed_gap:.3g} (limit {G_RTOL}), loss equal")
    del g, sg
    _reset_counts()
    res = train(cfg, spec, step, stacked, shared, data, GPT3_STEPS,
                log=lambda s: print(f"[train-gpt3] {name}: {s}"), state=state)
    del state
    replay_launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    gf = step.grad_fn
    check(gf.captures == 1 and len(walks) == 2,
          f"gpt3 {name}: {gf.captures} captures and {len(walks)} walks, want 1 and 2")
    for what, (launches, _) in zip(("warm-up", "capture"), walks):
        want = _check_counts(f"gpt3 {name} {what}", launches, per_step, 1)
    check(replay_launches == _zero_counts(),
          f"gpt3 {name}: the replayed steps launched {replay_launches} from Python")
    check(res.losses[0] == loss0, f"gpt3 {name}: step-0 loss {res.losses[0]!r} != {loss0!r}")
    check(all(np.isfinite(res.losses + res.grad_norms)), f"gpt3 {name}: non-finite metrics")
    med = float(np.median(res.step_s[1:]))
    tokens = T_M * T_B * seq
    print(f"[train-gpt3] {name} p={T_P} m={T_M} b={T_B} seq={seq} ({sched.n_chunks} chunk(s) a "
          f"stage, {plan.n_ticks} ticks): {base_gb:.2f} GB after init; capture "
          f"{gf.capture_s[0]:.2f} s (host: warm-up walk {walks[0][1]:.2f} s, captured walk "
          f"{walks[1][1]:.2f} s), first call {first_s:.2f} s; ms_per_step replay median(steps "
          f"1-{GPT3_STEPS - 1})={med * 1e3:.1f} all={[round(x * 1e3, 1) for x in res.step_s]}; "
          f"tokens_per_s={tokens / med:.0f}; peak GB allocated={peak_gb:.2f} "
          f"reserved={reserved_gb:.2f}; launches per capture and per warm-up "
          f"wgrad_accum={walks[1][0][0]} {walks[1][0][2]} rmsnorm={walks[1][0][1]} (expected "
          f"{want}), from Python during the steps {replay_launches[:2]}; losses {res.losses} "
          f"grad_norms {res.grad_norms} amended {res.amended}{gap}")
    if name == T_PROFILED[0] and clip:
        n_by_name = phase_profile_train(name, plan, (stacked, shared, spec, sched, step, data),
                                        tag="profile-gpt3")
        if n_by_name:
            got = (_kernel_launches(n_by_name, "wgrad_wgmma_kernel"),
                   _kernel_launches(n_by_name, "rmsnorm_bulk_kernel"))
            check(got == per_step, f"gpt3 {name}: a profiled replay ran (wgrad_wgmma, rmsnorm) "
                  f"kernels {got}, the structure implies {per_step}")
            print(f"[profile-gpt3] {name}: one replayed step ran {got[0]} wgrad_wgmma_kernel and "
                  f"{got[1]} rmsnorm_bulk_kernel (expected {per_step})")
    out = dict(res=res, seq=seq, chunks=sched.n_chunks, peak_gb=peak_gb,
               reserved_gb=reserved_gb, ms=med * 1e3, sched=sched, mem=_mem(walk),
               launches=_add_counts(walks[0][0], walks[1][0]))
    del step, gf, stacked, shared, res
    torch.cuda.empty_cache()
    return out


def _gpt3_schedule(cfg, name, ref, loss_ref):
    """``_gpt3_graph_run`` at seq T_SEQ, or, when that runs out of card
    memory, at seq 512 (PERF.md §2's rule), saying so; ``ref`` is held
    against the seq-T_SEQ run only."""
    oom = None
    try:
        return _gpt3_graph_run(cfg, name, T_SEQ, ref, loss_ref)
    except torch.OutOfMemoryError as e:
        oom = str(e).splitlines()[0][:300]
    gc.collect()  # the failed run's tensors, held by the traceback until here
    torch.cuda.empty_cache()
    print(f"[train-gpt3] {name}: out of memory at seq {T_SEQ} ({oom}); running it again at seq "
          f"512")
    return _gpt3_graph_run(cfg, name, 512)


def _head_gemms(cfg):
    """The LM head's three products for one microbatch of the train cell
    (bf16, n = 1024 tokens, d = d_model, V columns), as the sink runs them:
    F ``yn @ head``, B ``dlogits @ head^T``, W ``acc + (yn^T @ dlogits)`` in
    fp32; at the arch's vocabulary and at padded ones, beside the bound
    (operations at the bf16 tensor rate, or bytes)."""
    n, d = T_B * T_SEQ, cfg.d_model
    gen = torch.Generator(device=DEV).manual_seed(3)
    rows = {}
    for v in GPT3_HEAD_VOCABS:
        yn = torch.randn(n, d, generator=gen, device=DEV).to(torch.bfloat16)
        head = (torch.randn(d, v, generator=gen, device=DEV) * 0.02).to(torch.bfloat16)
        dl = (torch.randn(n, v, generator=gen, device=DEV) * 1e-4).to(torch.bfloat16)
        acc = torch.zeros(d, v, device=DEV)
        fns = {"F": lambda: yn @ head, "B": lambda: dl @ head.t(),
               "W": lambda: acc + (yn.t() @ dl).to(acc.dtype)}
        # bytes each reads once and writes once: F yn, head -> logits; B
        # dlogits, head -> dx; W yn, dlogits, acc -> acc (fp32)
        moved = {"F": 2 * (n * d + d * v + n * v), "B": 2 * (n * v + d * v + n * d),
                 "W": 2 * (n * d + n * v) + 8 * d * v}
        ms = {k: device_ms(fn, iters=10) for k, fn in fns.items()}
        bound = {k: max(2 * n * d * v / BF16_OPS_PER_S, moved[k] / HBM_BYTES_PER_S) * 1e3
                 for k in fns}
        rows[v] = ms
        print(f"[head-gpt3] V={v} (row of {2 * v} bytes, {'' if 2 * v % 16 == 0 else 'not '}a "
              f"multiple of 16): device ms F={ms['F']:.4f} B={ms['B']:.4f} W={ms['W']:.4f} "
              f"(sum {sum(ms.values()):.4f}; x {T_M} microbatches a step = "
              f"{T_M * sum(ms.values()):.2f} ms); bound F={bound['F']:.4f} B={bound['B']:.4f} "
              f"W={bound['W']:.4f}")
        del yn, head, dl, acc, fns
        torch.cuda.empty_cache()
    return rows


def phase_train_gpt3(cfg):
    """Phase 18: gpt3-1.5b at full width under every schedule, graph
    executor; returns {schedule: run}."""
    t0 = time.perf_counter()
    ref, loss_ref = _pipeline_vs_plain(cfg, "train-gpt3", keep=True)
    print(f"[train-gpt3] eager zb-h1 walk and plain autograd in {time.perf_counter() - t0:.1f}s")
    runs = {name: _gpt3_schedule(cfg, name, ref if name == "zb-h1" else None, loss_ref)
            for name in GPT3_SCHEDULES}
    del ref
    band = (0.1 * np.log(cfg.vocab), 3.0 * np.log(cfg.vocab))
    for seq in sorted({r["seq"] for r in runs.values()}, reverse=True):
        group = {n: r["res"] for n, r in runs.items() if r["seq"] == seq}
        first = {n: r.losses[0] for n, r in group.items()}
        for n, l0 in first.items():
            check(band[0] < l0 < band[1], f"gpt3 {n}: step-0 loss {l0} outside {band}")
        check(len(set(first.values())) == 1, f"gpt3 step-0 losses differ at seq {seq}: {first}")
        # later losses: within a placement (one or two chunks a stage); across
        # the two, with the clip on, the clip scale's last f32 bit parts them
        # (T_LATER_LOSS_RTOL's comment), so they are held with the clip off
        worst, across = 0.0, {}
        for chunks in (1, 2):
            part = [r for n, r in group.items() if runs[n]["chunks"] == chunks]
            for r in part:
                worst = max([worst] + [abs(a - b) / abs(b)
                                       for a, b in zip(r.losses[1:], part[0].losses[1:])])
            across[chunks] = part[0].losses if part else None
        check(worst <= T_LATER_LOSS_RTOL,
              f"gpt3 later losses differ across the schedules of one placement by {worst}")
        gap = ""
        if None not in across.values():
            apart = max(abs(a - b) / abs(b) for a, b in zip(across[2][1:], across[1][1:]))
            gap = f"; across the placements, clip on, {apart:.3g}"
        print(f"[train-gpt3] seq {seq}: step-0 loss {list(first.values())[0]} in band "
              f"({band[0]:.3f}, {band[1]:.3f}) and identical across {list(first)}; later losses "
              f"max rel diff within a placement {worst:.3g} (limit {T_LATER_LOSS_RTOL}){gap}")
    planners = _gpt3_plan_vs_card(cfg, runs)
    seq = runs["zb-h1"]["seq"]
    if runs["zb-v"]["seq"] == seq:
        noclip = {n: _gpt3_graph_run(cfg, n, seq, clip=False)["res"] for n in ("zb-h1", "zb-v")}
        gaps = [abs(a - b) / abs(b) for a, b in zip(
            noclip["zb-v"].losses + noclip["zb-v"].grad_norms,
            noclip["zb-h1"].losses + noclip["zb-h1"].grad_norms)]
        print(f"[train-gpt3] zb-v vs zb-h1 with the clip off: losses and grad norms max rel gap "
              f"{max(gaps):.3g} (limit {T_LATER_LOSS_RTOL})")
        check(max(gaps) <= T_LATER_LOSS_RTOL, "gpt3: with the clip off zb-v and zb-h1 still part")
    else:
        print("[train-gpt3] zb-h1 and zb-v ran at other seq lengths: no placement check")
    _head_gemms(cfg)
    return runs, planners


def _gpt3_plan_vs_card(cfg, runs):
    """Phase 13 for phase 18's graph runs: a measured-fidelity planner for
    gpt3-1.5b at each sequence a run took (slots measured on the card),
    each run's reserved peak gated against its one-card total, and the
    remainder and overhang ``launch/calibrate.py`` would write; returns
    {seq: planner}."""
    planners = {}
    for seq in sorted({r["seq"] for r in runs.values()}):
        planners[seq] = HBMPlanner(cfg, p=T_P, m=T_M, microbatch=T_B, seq_len=seq,
                                   executor_mode="graph", program_factory=stage_program_factory(
                                       cfg, T_P, T_M, T_B, seq, DEV))
        for c in (1, 2):
            planners[seq].slot_bytes(c)
    torch.cuda.empty_cache()
    if T_SEQ in planners:
        model = HBMPlanner(cfg, p=T_P, m=T_M, microbatch=T_B, seq_len=T_SEQ, executor_mode="graph")
        phase_plan_vs_card(cfg, runs, {"measured": planners[T_SEQ], "model": model}, "graph")
    for name, r in runs.items():
        if r["seq"] != T_SEQ:
            _gate("plan-vs-card", f"{cfg.name} graph {name} at seq {r['seq']}",
                  planners[r["seq"]].one_card_bytes(r["sched"]), r["mem"])
    return planners


def phase_launch_gpt3(cfg, runs, planners):
    """Phase 19: ``launch.train.main`` with its default ``--arch`` (zb-h1 at
    the seq and ``--layers`` phase 18 ran it at); returns both kernels'
    launches."""
    name = "zb-h1"
    seq = runs[name]["seq"]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    try:
        with contextlib.redirect_stdout(out):
            res = train_main(["--pipe-size", str(T_P), "--m", str(T_M), "--microbatch", str(T_B),
                              "--seq-len", str(seq), "--steps", str(GPT3_STEPS), "--lr", "1e-3",
                              "--schedule", name, "--device", DEV, "--layers", str(cfg.n_layers)])
    finally:
        print(out.getvalue(), end="")
    launches = _read_counts()
    lines = out.getvalue().splitlines()
    check(lines[-1].endswith(" executor=graph"),
          f"the launcher's last line does not say executor=graph: {lines[-1]!r}")
    _launcher_reserved_gate("launch-gpt3", f"launcher {name} (default arch) at seq {seq}", lines,
                            priced=planners[seq].one_card_bytes(runs[name]["sched"]).total)
    embed = tuple(res.state["shared"]["embed"].shape)
    check(embed == (cfg.vocab, cfg.d_model), f"the default arch's embedding is {embed}, not "
          f"gpt3-1.5b's {(cfg.vocab, cfg.d_model)}")
    want = _check_counts("launcher gpt3", launches, expected_train_launches(cfg, T_P, 1, T_M), 2)
    check(res.losses[-1] < res.losses[0], f"launcher losses did not fall: {res.losses}")
    ref = runs[name]["res"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(res.losses + res.grad_norms,
                                                ref.losses + ref.grad_norms)]
    print(f"[launch-gpt3] default arch, {name}, seq {seq}: losses {res.losses}, ms per step "
          f"{[round(x * 1e3, 1) for x in res.step_s]}, peak GB allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f}; launches wgrad_accum {launches[0]} "
          f"{launches[2]} rmsnorm {launches[1]} (expected {want}: one capture's warm-up and "
          f"captured walks); losses and grad norms against phase 18's {name} run: max rel gap "
          f"{max(gaps):.3g} (limit {G_RTOL})")
    check(max(gaps) <= G_RTOL, "the launcher's gpt3 run differs from phase 18's")
    del res
    torch.cuda.empty_cache()
    return launches

# --------------------------------------------------------------------- #
# phases 20-21: qwen2-moe-a2.7b, served at full depth, trained at 4 layers
# --------------------------------------------------------------------- #
def _routes_by_layer(log, layer_of, n_tok):
    """{layer: [(top_i, pos_nk, cap) of each call with n_tok tokens, in call
    order]}: the serve walks the groups in the same order in every call."""
    out = collections.defaultdict(list)
    for ptr, top_i, pos, cap in log:
        if top_i.shape[0] == n_tok:
            out[layer_of[ptr]].append((top_i, pos, cap))
    return out


@contextlib.contextmanager
def _pinned_routes(layer_of, experts, n_tok):
    """While active, each moe call of ``n_tok`` tokens routes them to the
    experts given for its layer (``experts[layer]``, one (n_tok, k) tensor a
    call, in call order), with the gates and slot positions the port's
    ``_moe_route`` computes for such a choice; other calls route as the port
    does.  Yields the calls pinned per layer."""
    real, used = layers._moe_route, [0] * len(experts)

    def pinned(p, tok, cfg):
        if tok.shape[0] != n_tok:
            return real(p, tok, cfg)
        layer = layer_of[p["router"].data_ptr()]
        top_i = experts[layer][used[layer]].to(tok.device)
        used[layer] += 1
        gates = torch.softmax(tok.float() @ p["router"], dim=-1)
        pos_nk, onehot = layers._slot_positions(top_i, layers._e_pad(cfg))
        return layers._chosen_gates(gates, top_i), top_i, pos_nk, onehot

    layers._moe_route = pinned
    try:
        yield used
    finally:
        layers._moe_route = real


def phase_serve_moe(cfg, tag="serve-qwen2-moe", p=P, limit=MOE_CONSIST_REL_L2):
    """Phase 20 (qwen2-moe-a2.7b at full width and depth) and phase 22
    (deepseek-v3-671b at full width, 2 layers): a moe model served at
    phase 5's shape on p stages; returns the RMSNorm launches of the timed
    run, in all and by path."""
    lcfg = layer_cfg(cfg)
    spec = RunSpec(p=p, n_chunks=1, microbatch=B, seq_len=PROMPT, m=M)
    blocks, g = group_layout(cfg, p, 1)
    check(g * p == cfg.n_layers and all(k == cfg.block_pattern[0] for k in blocks),
          f"{cfg.name}: {g} blocks a stage of kinds {blocks}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    stacked, shared = init_params(cfg, spec, Placement.linear(p), seed=0, device=DEV)
    torch.cuda.synchronize()
    leaves = tree_leaves((stacked, shared))
    n_params = sum(t.numel() for t in leaves)
    routers = {str(t.dtype) for t in (blk[1]["router"] for blk in stacked[0]["blocks"])}
    check(routers == {"torch.float32"}, f"the routers are {routers}, not float32")
    print(f"[{tag}] init {cfg.name} ({cfg.n_layers} layers of {'+'.join(cfg.block_pattern[0])}, "
          f"d={cfg.d_model}, {cfg.n_heads} heads, {lcfg['n_experts']} experts of "
          f"{lcfg['moe_d_ff']} top-{lcfg['topk']} + {lcfg['n_shared_experts']} shared, vocab "
          f"{cfg.vocab}, {cfg.dtype}, routers float32): {n_params / 1e9:.3f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB, on {DEV} in "
          f"{time.perf_counter() - t0:.1f}s (peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    layer_of = {blk[1]["router"][st].data_ptr(): st * g + bi
                for bi, blk in enumerate(stacked[0]["blocks"]) for st in range(p)}
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (M, B, PROMPT))
    with _routes() as log:  # the warm-up (cuBLAS, allocator), its routing logged
        serve(cfg, stacked, shared, prompts, p=p, new_tokens=1)
    pre = _routes_by_layer(log, layer_of, B * PROMPT)
    dec = _routes_by_layer(log, layer_of, B)
    caps = {c for calls in pre.values() for _, _, c in calls}
    check(sorted(pre) == list(range(cfg.n_layers)) and all(len(c) == M for c in pre.values()),
          f"prefill routed {sum(map(len, pre.values()))} calls over layers {sorted(pre)}")
    check(caps == {moe_capacity(lcfg, B * PROMPT)}, f"prefill capacities {caps}")
    dropped = {layer: float(sum(int((pos >= cap).sum()) for _, pos, cap in calls))
               / sum(pos.numel() for _, pos, _ in calls) for layer, calls in sorted(pre.items())}
    check(all(cap == 4 and int((pos >= cap).sum()) == 0 for calls in dec.values()
              for _, pos, cap in calls), "decode dropped a selection or has a capacity but 4")
    print(f"[{tag}] prefill of {B} x {PROMPT} tokens a group: capacity "
          f"{caps.pop()} slots an expert for {B * PROMPT * lcfg['topk']} selections over "
          f"{lcfg['n_experts']} experts; share dropped per layer "
          f"{[round(d, 4) for d in dropped.values()]} (mean {np.mean(list(dropped.values())):.4f},"
          f" max {max(dropped.values()):.4f}); decode: capacity 4 for {B} tokens, "
          f"{lcfg['n_experts']} x 4 expert rows for {B * lcfg['topk']} selections, none dropped")
    del log, pre, dec

    torch.cuda.reset_peak_memory_stats()
    res, launches, by_path, _ = _serve_counted(
        tag, cfg, p, M, NEW,
        lambda: serve(cfg, stacked, shared, prompts, p=p, new_tokens=NEW,
                      log=lambda s: print(f"[{tag}] {s}")))
    want = expected_norm_launches(cfg, p, M, 1 + NEW)
    _check_served(cfg, res, M, B, NEW)
    decode_ms = [x * 1e3 for x in res.decode_s]
    print(f"[{tag}] p={p} m={M} b={B} prompt={PROMPT} new={NEW}: "
          f"prefill_ms={res.prefill_s * 1e3:.1f} "
          f"decode_ms_per_step mean={np.mean(decode_ms):.2f} median={np.median(decode_ms):.2f} "
          f"min={min(decode_ms):.2f} max={max(decode_ms):.2f} "
          f"generated_tok_per_s={M * B * NEW / sum(res.decode_s):.1f} "
          f"max_memory_allocated_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}; "
          f"rmsnorm launches {launches} == expected {want}, by path {by_path}")
    del res

    # decode vs prefill with nothing dropped: the capacity is the longer
    # prefill's tokens, which no expert can pass (a token picks an expert once)
    cap = B * (PROMPT + 1)
    cfg_all = dataclasses.replace(cfg, extras=cfg.extras + (("capacity", cap),))
    with _routes() as log:
        res = serve(cfg_all, stacked, shared, prompts, p=p, new_tokens=1)
    longer = np.concatenate([prompts, res.tokens[..., :1].cpu().numpy()], axis=-1)
    with _routes() as log_ref:
        ref = serve(cfg_all, stacked, shared, longer, p=p, new_tokens=0)
    dec = _routes_by_layer(log, layer_of, B)
    pre = _routes_by_layer(log_ref, layer_of, B * (PROMPT + 1))
    check(all(int((pos >= c).sum()) == 0 for calls in (*dec.values(), *pre.values())
              for _, pos, c in calls), "a selection was dropped at the full capacity")
    last = {layer: [p_i.reshape(B, PROMPT + 1, -1)[:, -1] for p_i, _, _ in calls]
            for layer, calls in pre.items()}
    differ = sum(int((d_i.sort(-1).values != want.sort(-1).values).any(-1).sum())
                 for layer in range(cfg.n_layers)
                 for (d_i, _, _), want in zip(dec[layer], last[layer], strict=True))
    # the same decode with each moe layer's experts pinned to the prefill's
    # choice for that token: what is left is the bf16 walk of phase 6
    with _pinned_routes(layer_of, last, B) as used:
        pinned = serve(cfg_all, stacked, shared, prompts, p=p, new_tokens=1)
    check(used == [M] * cfg.n_layers, f"pinned decode calls per layer {used}")
    want = ref.logits[0].float()
    gaps = {}
    for what, got in (("routed", res.logits[1]), ("pinned", pinned.logits[1])):
        got = got.float()
        gaps[what] = (float((got - want).norm() / want.norm()), float((got - want).abs().max()),
                      float((got.argmax(-1) == want.argmax(-1)).float().mean()))
    print(f"[{tag}] decode@{PROMPT} vs prefill of {PROMPT + 1}, capacity {cap} (nothing "
          f"dropped): (layer, token) top-k sets that differ {differ} of "
          f"{cfg.n_layers * M * B}; each routing its own tokens: rel_l2={gaps['routed'][0]:.3g} "
          f"max_abs={gaps['routed'][1]:.3g} top1_agree={gaps['routed'][2]:.3f} (not gated: the "
          f"flips); the decode's experts pinned to the prefill's: rel_l2={gaps['pinned'][0]:.3g} "
          f"(limit {limit}) max_abs={gaps['pinned'][1]:.3g} (limit "
          f"{CONSIST_MAX_ABS}) top1_agree={gaps['pinned'][2]:.3f}; prefill of {PROMPT + 1}: "
          f"{ref.prefill_s * 1e3:.1f} ms")
    check(gaps["pinned"][0] <= limit and gaps["pinned"][1] <= CONSIST_MAX_ABS,
          f"{cfg.name}: prefill->decode consistency with the experts pinned")
    del ref, pinned
    del stacked, shared, res, log
    torch.cuda.empty_cache()
    return launches, by_path


def _cut_run(cfg, tr, name, mode, seq, eager=None):
    """One schedule of phase 21, 23, 24, 25, 28, 30 or 32 (``tr``: its tag,
    p, schedules, seq and, for phase 32, its ``data``) under ``mode``: the
    seed-0 model (relaid onto the V placement when it has two chunks), the
    AdamW state allocated, a first walk whose gradient
    is kept on the host (in graph mode the capture and its replay), then
    MT_STEPS driver steps from that state, the clip off; the memory window
    is ``launch/calibrate.py::measure_run``'s (the cache emptied and the
    peaks reset after init, read after the steps).  With ``eager`` (this
    schedule's eager run) the graph's step-0 gradient, loss and later losses
    are held to it."""
    tag, p = tr["tag"], tr["p"]
    sched = make_schedule(name, p, T_M)
    plan = compile_plan(sched)
    per_step = expected_train_launches(cfg, p, sched.n_chunks, T_M)
    fma = expected_fma_launches(cfg, p, sched.n_chunks, T_M)
    kw = dict(fma_per_step=fma, narrow_per_step=expected_narrow_launches(
        cfg, p, sched.n_chunks, T_M), slstm_per_step=expected_slstm_launches(
        cfg, p, sched.n_chunks, T_M))
    stacked, shared, spec, data = _init_full(cfg, sched, seq)
    if "data" in tr:  # the run's own batches
        data = tr["data"]()
    step, _ = build_train_step(cfg, spec, plan, sched.placement, TrainStepConfig(
        adamw=adamw.AdamWConfig(grad_clip=None), executor_mode=mode))
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(stacked, shared)
    walks = _count_walks(step.grad_fn) if mode == "graph" else None
    _reset_counts()
    t0 = time.perf_counter()
    g, sg, loss0 = step.grad_fn(stacked, shared,
                                side_from_batch(data.batch_at(0), spec, DEV, cfg))
    torch.cuda.synchronize()
    first_s, first = time.perf_counter() - t0, _read_counts()
    keyed = [(k, t.cpu()) for k, t in keyed_leaves((g, sg))]
    loss0 = float(loss0)
    del g, sg
    walk = _walk_peaks()
    _reset_counts()
    res = train(cfg, spec, step, stacked, shared, data, MT_STEPS,
                log=lambda x: print(f"[{tag}] {name} {mode}: {x}"), state=state)
    launches = _read_counts()
    mem = _mem(walk)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    if mode == "graph" and name == tr["schedules"][0] and tr.get("profile"):
        # one more step, profiled, its moments
        phase_profile_train(f"{name} {mode}", plan, (stacked, shared, spec, sched, step, data),
                            tag=tag.replace("train", "profile"),
                            opts=(state["opt"], state["shared_opt"]), cfg=cfg)
    del state
    what = f"{cfg.name} {name}"
    if mode == "eager":
        want = _check_counts(f"{what} eager first walk", first, per_step, 1, **kw)
        _check_counts(f"{what} eager steps", launches, per_step, MT_STEPS, **kw)
        counted = _add_counts(first, launches)
    else:
        check(step.grad_fn.captures == 1 and len(walks) == 2,
              f"{what}: {step.grad_fn.captures} captures and {len(walks)} walks")
        for when, (c, _) in zip(("warm-up", "capture"), walks):
            want = _check_counts(f"{what} {when}", c, per_step, 1, **kw)
        check(launches == _zero_counts(),
              f"{what}: the replayed steps launched {launches} from Python")
        counted = _add_counts(walks[0][0], walks[1][0])
    check(res.losses[0] == loss0, f"{what} {mode}: step-0 loss {res.losses[0]!r} != "
          f"its first walk's {loss0!r}")
    check(all(np.isfinite(res.losses + res.grad_norms)), f"{what}: non-finite metrics")
    gap = ""
    if eager is not None:
        exact, embed_gap = _graph_vs_eager(what, eager["keyed"], keyed)
        check(loss0 == eager["loss0"], f"{what}: graph step-0 loss {loss0!r} != eager "
              f"{eager['loss0']!r}")
        later = max(abs(a - b) / abs(b) for a, b in zip(
            res.losses + res.grad_norms, eager["res"].losses + eager["res"].grad_norms))
        check(later <= G_RTOL, f"{what}: graph losses/grad norms differ from eager by "
              f"{later}")
        gap = (f"; against the eager run: step-0 gradient {exact} of {exact + 1} leaves bit for "
               f"bit, embedding rel_l2 {embed_gap:.3g} (limit {G_RTOL}), step-0 loss equal, "
               f"losses and grad norms max rel gap {later:.3g} (limit {G_RTOL})")
    med = float(np.median(res.step_s[1:] if mode == "graph" else res.step_s))
    tokens = T_M * T_B * seq
    capture = (f"capture {step.grad_fn.capture_s[0]:.2f} s, " if mode == "graph" else "")
    print(f"[{tag}] {name} {mode} p={p} m={T_M} b={T_B} seq={seq} "
          f"({sched.n_chunks} chunk(s) a stage, {plan.n_ticks} ticks): {base_gb:.2f} GB after "
          f"init; {capture}first walk {first_s:.2f} s; ms_per_step median={med * 1e3:.1f} "
          f"all={[round(x * 1e3, 1) for x in res.step_s]} tokens_per_s={tokens / med:.0f}; peak GB "
          f"allocated={peak_gb:.2f} reserved={reserved_gb:.2f}; launches a step wgrad_accum="
          f"{want[0]} (fma {fma}, thin {kw['narrow_per_step']}) rmsnorm={want[1]} sLSTM "
          f"kernel={kw['slstm_per_step']}, by path {counted[2]} {counted[3]} {counted[4]} over "
          f"{'the first walk and the steps' if mode == 'eager' else 'the warm-up and captured walks'}; "
          f"losses {res.losses} grad_norms {res.grad_norms}{gap}")
    out = dict(res=res, keyed=keyed, loss0=loss0, seq=seq, sched=sched, peak_gb=peak_gb,
               reserved_gb=reserved_gb, mem=mem, launches=counted)
    del step, stacked, shared
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cut_schedule(cfg, tr, name, mode, eager=None):
    """``_cut_run`` at the seq of ``tr`` (default T_SEQ), again at 512 when
    its allocated peak passes T_MEM_LIMIT_GB at seq T_SEQ (PERF.md §2's
    rule), saying so."""
    seq = eager["seq"] if eager is not None else tr.get("seq", T_SEQ)
    run = _cut_run(cfg, tr, name, mode, seq, eager)
    if run["peak_gb"] > T_MEM_LIMIT_GB and seq == T_SEQ:
        print(f"[{tr['tag']}] {name} {mode}: peak {run['peak_gb']:.1f} GB > {T_MEM_LIMIT_GB} "
              f"GB at seq {seq}; running it again at seq 512")
        del run
        run = _cut_run(cfg, tr, name, mode, 512)
    return run


def phase_train_cut(cfg, tr=MOE_TRAIN):
    """Phase 21 (qwen2-moe-a2.7b at full width, 4 layers, p=2, zb-h1 and
    zb-v), phase 23 (deepseek-v3-671b's cut, p=2, zb-h1 and zb-h2), phase
    24 (whisper-tiny whole, p=2, zb-h1 and zb-v) and phase 25
    (llava-next-mistral-7b at full width and a depth cut, p=2, zb-h1 and
    zb-v), 28 and 30 (xlstm, recurrentgemma): both schedules of ``tr``
    eager then graph, and each run's reserved peak gated against its
    priced one-card total as phase 13 gates the dense runs; returns {run:
    both kernels' launches}.  Phase 32's ``tr`` names its ``modes`` (the
    graph alone): its record must be its seq's, and it returns the runs
    without the plain autograd walk.  The runs come first in
    their process (the children run this phase before their serving one)
    and in ``launch/calibrate.py``'s order, every schedule eager and then
    every one under the graph, so each run's memory window follows what
    it follows when the record is measured, as a launcher's fresh process
    has nothing before its run: after a serving phase in the same process
    deepseek's eager zb-h2 run reserved 0.48 GiB more (H100, 700 W)."""
    tag, p, names, modes = tr["tag"], tr["p"], tr["schedules"], tr.get("modes", ("eager", "graph"))
    runs = {}
    for mode in modes:
        for name in names:
            runs[(name, mode)] = _cut_schedule(cfg, tr, name, mode, runs.get((name, "eager")))
    for r in runs.values():
        r.pop("keyed")
    band = (0.1 * np.log(cfg.vocab), 3.0 * np.log(cfg.vocab))
    eager = {n: runs[(n, modes[0])] for n in names}
    first = {n: r["res"].losses[0] for n, r in eager.items()}
    for n, l0 in first.items():
        check(band[0] < l0 < band[1], f"{cfg.name} {n}: step-0 loss {l0} outside {band}")
    if len(names) == 1:
        print(f"[{tag}] step-0 loss {first} in band ({band[0]:.3f}, {band[1]:.3f}); one schedule")
    elif len({r["seq"] for r in eager.values()}) == 1:
        check(len(set(first.values())) == 1, f"{cfg.name} step-0 losses differ: {first}")
        later = max(abs(a - b) / abs(b) for a, b in zip(eager[names[1]]["res"].losses[1:],
                                                        eager[names[0]]["res"].losses[1:]))
        check(later <= T_LATER_LOSS_RTOL, f"{cfg.name} later losses differ by {later}")
        print(f"[{tag}] step-0 loss {first[names[0]]} in band ({band[0]:.3f}, {band[1]:.3f}) and "
              f"equal under {' and '.join(names)}; later losses max rel diff {later:.3g} (limit "
              f"{T_LATER_LOSS_RTOL})")
    else:
        print(f"[{tag}] step-0 losses {first} in band; the schedules ran at other seq lengths, so "
              f"no cross-schedule check")
    for mode in modes:
        rec = _own_record(cfg, mode, p, tr.get("seq", T_SEQ), own_seq="modes" in tr)
        print(f"[{tag}] {cfg.name} {mode}: priced with the calibration record measured at "
              f"{rec.get('cut')} on {rec['card']}")
    overs = []
    for seq in sorted({r["seq"] for r in runs.values()}):
        kw = dict(p=p, m=T_M, microbatch=T_B, seq_len=seq)
        model = HBMPlanner(cfg, **kw)
        measured = HBMPlanner(cfg, program_factory=stage_program_factory(
            cfg, p, T_M, T_B, seq, DEV), **kw)
        for (name, mode), r in runs.items():
            if r["seq"] != seq:
                continue
            overs.append(_gate(tag, f"{cfg.name} {mode} {name} at seq {seq}",
                               measured.one_card_bytes(r["sched"], mode), r["mem"]))
            if r["sched"].n_chunks == 1 and "modes" in tr:  # phase 32's remat gate reads it
                tr["res_per_token"] = measured.slot_bytes(1)[1]["res"][0] / (T_B * seq)
            print(f"[{tag}] {cfg.name} {mode} {name}: the model fidelity's total "
                  f"{_gib(model.one_card_bytes(r['sched'], mode).total)} GiB")
        del measured
        torch.cuda.empty_cache()
    print(f"[{tag}] {cfg.name}: overshoot over {len(overs)} runs min {_gib(min(overs))} max "
          f"{_gib(max(overs))} GiB")
    if "modes" in tr:  # phase 32: its own gates in place of the plain autograd walk
        return runs
    t0 = time.perf_counter()
    _pipeline_vs_plain(cfg, tag, p=p, seq=tr.get("seq", T_SEQ))
    print(f"[{tag}] eager zb-h1 walk and plain autograd in {time.perf_counter() - t0:.1f}s")
    return {f"{tag}-{n}-{mode}": r["launches"] for (n, mode), r in runs.items()}


# --------------------------------------------------------------------- #
# phases 32-33: internlm2-1.8b at seq 4096, the chunked attention's remat
# --------------------------------------------------------------------- #
class _Fetched:
    """``batch_at(k)`` over a prefetched stream, for ``TrainDriver``'s
    ``data_at``: batches are taken from the stream in order and kept, so a
    step may read one again (the first walk and step 0 read batch 0)."""

    def __init__(self, stream):
        self.stream, self.got = stream, []

    def batch_at(self, k: int) -> dict:
        while len(self.got) <= k:
            self.got.append(next(self.stream))
        return self.got[k]


def _token_file(path, cfg, seq: int, n_batches: int) -> str:
    """A flat int32 token file of the synthetic stream's seed-0 batches
    0..n_batches-1 at ``seq`` (each row's tokens, then the last label), so
    ``TokenFileLM`` at that seq reads the same tokens back."""
    data = SyntheticLM(DataConfig(global_batch=T_M * T_B, seq_len=seq, vocab=cfg.vocab))
    batches = [data.batch_at(k) for k in range(n_batches)]
    flat = np.concatenate([b["tokens"].reshape(-1) for b in batches]
                          + [batches[-1]["labels"][-1, -1:]]).astype(np.int32)
    flat.tofile(path)
    files = TokenFileLM(path, DataConfig(global_batch=T_M * T_B, seq_len=seq, vocab=cfg.vocab))
    for k, b in enumerate(batches):
        check(np.array_equal(files.batch_at(k)["tokens"], b["tokens"]),
              f"the token file's batch {k} is not the synthetic stream's")
    return path


def _res_per_token(cfg, seq: int) -> float:
    """The measured residual slot of one chunk a stage (``slot_bytes``:
    stage 0's F of one microbatch on the card), per token, as phase 32's
    gating planner measures it at seq 4096."""
    prog, stage, shared, side = stage_program_factory(cfg, TL_P, T_M, T_B, seq, DEV)(1)
    res = slot_bytes(prog, stage, shared, side)["res"][0]
    del prog, stage, shared, side
    gc.collect()
    torch.cuda.empty_cache()
    return res / (T_B * seq)


def phase_train_long(cfg):
    """Phase 32: internlm2-1.8b at full width, p=4, 8 x 4096 under the
    graph executor, each depth of TL_RUNS with its schedules (the full one
    first, in a fresh process, as its record was measured), each run's
    batches read from a token file through ``TokenFileLM`` and
    ``prefetch``: phase 21's checks and gate against the record of the
    run's depth at this seq, the reserved peak under TL_RESERVED_MAX_GB, and
    the remat's gate on the measured residual per token; returns {run: the
    kernels' launches}."""
    t0 = time.perf_counter()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = _token_file(str(pathlib.Path(tmp) / "tokens.bin"), cfg, TL_SEQ, MT_STEPS + 2)
        files = TokenFileLM(path, DataConfig(global_batch=T_M * T_B, seq_len=TL_SEQ,
                                             vocab=cfg.vocab))
        print(f"[train-long] token file of {files.n_seq} sequences of {TL_SEQ} "
              f"({pathlib.Path(path).stat().st_size} bytes) written in "
              f"{time.perf_counter() - t0:.1f} s; batches through TokenFileLM and "
              f"prefetch(depth=2)")
        for layers, names in TL_RUNS:
            cut = dataclasses.replace(cfg, n_layers=layers)
            tag = f"train-long-{layers}L"
            tr = dict(LONG_TRAIN, tag=tag, schedules=names, profile="zb-h1" in names,
                      data=lambda: _Fetched(prefetch(iter(files), depth=2)))
            runs = phase_train_cut(cut, tr)
            if layers == cfg.n_layers:
                long = tr["res_per_token"]
            for (name, mode), r in runs.items():
                print(f"[{tag}] {name} {mode}: reserved peak {r['reserved_gb']:.2f} GB (limit "
                      f"{TL_RESERVED_MAX_GB} GB), allocated {r['peak_gb']:.2f} GB")
                check(r["reserved_gb"] < TL_RESERVED_MAX_GB, f"{cut.name} {layers} layers {name} "
                      f"{mode} at seq {TL_SEQ}: reserved {r['reserved_gb']:.2f} GB")
                counts[f"{tag}-{name}-{mode}"] = r["launches"]
            del runs
            gc.collect()
            torch.cuda.empty_cache()
    short = _res_per_token(cfg, T_SEQ)
    print(f"[train-long] {cfg.n_layers} layers: measured residual slot per token (one chunk a "
          f"stage): {short:.0f} B at seq {T_SEQ} (dense: the scores kept), {long:.0f} B at seq "
          f"{TL_SEQ} (query blocks recomputed in B): {long / short:.3f} of it")
    check(long <= short, f"{cfg.name}: the residual per token at seq {TL_SEQ} ({long:.0f} B) "
          f"passes the one at seq {T_SEQ} ({short:.0f} B)")
    return counts


def _reduced_long_run(cfg, name, device, mode):
    """Phase 33's run: the reduced model (seed 2) under ``name`` at seq
    TLR_SEQ on ``device`` under ``mode``: its first walk's gradient (keyed,
    on the host) and loss, then TLR_STEPS steps."""
    sched = make_schedule(name, TLR_P, TLR_M)
    spec = RunSpec(p=TLR_P, n_chunks=sched.n_chunks, microbatch=TLR_B, seq_len=TLR_SEQ, m=TLR_M)
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement,
                               TrainStepConfig(adamw.AdamWConfig(lr=3e-3), executor_mode=mode))
    stacked, shared = (_to(t, device) for t in init_params(cfg, spec, sched.placement, seed=2,
                                                           device="cpu"))
    data = SyntheticLM(DataConfig(global_batch=TLR_M * TLR_B, seq_len=TLR_SEQ, vocab=cfg.vocab))
    state = init_state(stacked, shared)
    g, sg, loss0 = step.grad_fn(stacked, shared, side_from_batch(data.batch_at(0), spec, device))
    keyed = [(k, t.cpu()) for k, t in keyed_leaves((g, sg))]
    res = train(cfg, spec, step, stacked, shared, data, TLR_STEPS, state=state)
    return res, keyed, float(loss0)


def phase_train_long_reduced(cfg):
    """Phase 33: the reduced model in f32 at seq 2304 (the chunked
    attention and its remat), p=2, zb-h1 and zb-v: the card's eager run
    against the CPU's (losses 1e-5 relative, grad norms 1e-4, as phase 8),
    and the card's graph against its eager walk (step-0 gradient bit for
    bit but the embedding's, G_RTOL; step-0 loss equal; later losses and
    grad norms within G_RTOL, as phase 16)."""
    for name in ("zb-h1", "zb-v"):
        cpu, _, _ = _reduced_long_run(cfg, name, "cpu", "eager")
        eager, ref, loss_e = _reduced_long_run(cfg, name, DEV, "eager")
        graph, got, loss_g = _reduced_long_run(cfg, name, DEV, "graph")
        l_rel = max(abs(a - b) / abs(b) for a, b in zip(eager.losses, cpu.losses))
        g_rel = max(abs(a - b) / abs(b) for a, b in zip(eager.grad_norms, cpu.grad_norms))
        check(l_rel <= 1e-5 and g_rel <= 1e-4, f"{cfg.name} {name} at seq {TLR_SEQ}: cuda vs "
              f"cpu losses {l_rel:.3g}, grad norms {g_rel:.3g}")
        exact, embed_gap = _graph_vs_eager(f"{cfg.name} {name} seq {TLR_SEQ}", ref, got)
        check(loss_g == loss_e, f"{name}: graph step-0 loss {loss_g!r} != eager {loss_e!r}")
        later = max(abs(a - b) / abs(b) for a, b in zip(graph.losses + graph.grad_norms,
                                                        eager.losses + eager.grad_norms))
        check(later <= G_RTOL, f"{name}: graph losses/grad norms differ from eager by {later}")
        print(f"[train-long-reduced] {cfg.name} p={TLR_P} m={TLR_M} b={TLR_B} seq={TLR_SEQ} f32 "
              f"{name}, {TLR_STEPS} steps: losses cuda={eager.losses} cpu={cpu.losses} max "
              f"rel_err {l_rel:.3g} (tol 1e-5), grad norms max rel_err {g_rel:.3g} (tol 1e-4); "
              f"graph vs eager: step-0 gradient {exact} of {exact + 1} leaves bit for bit, "
              f"embedding rel_l2 {embed_gap:.3g} (limit {G_RTOL}), step-0 loss equal, later "
              f"max rel gap {later:.3g} (limit {G_RTOL})")


# --------------------------------------------------------------------- #
# phases 24-27: whisper-tiny and llava-next-mistral-7b, the fronted families
# --------------------------------------------------------------------- #
def _llava_depth(cfg):
    """The training cut's depth: the deepest of LT_DEPTHS whose priced
    one-card total under the graph executor (``_priced``), the larger of
    zb-h1's and zb-v's, is at most LT_PRICE_GIB."""
    for layers in LT_DEPTHS:
        worst = _priced(dataclasses.replace(cfg, n_layers=layers), LLAVA_TRAIN)
        if worst <= LT_PRICE_GIB * 2**30:
            print(f"[train-llava] depth {layers} of {cfg.n_layers}: priced at most "
                  f"{_gib(worst)} GiB <= {LT_PRICE_GIB} GiB")
            return layers
        print(f"[train-llava] depth {layers}: priced {_gib(worst)} GiB > {LT_PRICE_GIB} GiB")
    check(False, f"no depth of {LT_DEPTHS} prices llava's training within {LT_PRICE_GIB} GiB")


def _priced(cfg, tr):
    """The largest priced one-card total of the schedules of ``tr`` under
    the graph executor (``HBMPlanner.one_card_bytes``, measured fidelity,
    the slots measured on the card, the calibration record's remainder),
    each printed before any step runs."""
    p, seq = tr["p"], tr.get("seq", T_SEQ)
    planner = HBMPlanner(cfg, p=p, m=T_M, microbatch=T_B, seq_len=seq, executor_mode="graph",
                         program_factory=stage_program_factory(cfg, p, T_M, T_B, seq, DEV))
    priced = {n: planner.one_card_bytes(make_schedule(n, p, T_M)) for n in tr["schedules"]}
    del planner
    gc.collect()
    torch.cuda.empty_cache()
    for n, one in priced.items():
        print(f"[{tr['tag']}] {cfg.n_layers} layers, p={p}, vocab {cfg.vocab}, {n} graph: "
              f"priced one-card total {one.report()}")
    return max(one.total for one in priced.values())


def _serve_counts(rms, rms_by_path, sl=None):
    """A serve run's count tuple (``_read_counts``'s layout): no W op."""
    return (0, rms, {k: 0 for k in wgrad_kernel.PATHS}, rms_by_path,
            sl or {k: 0 for k in slstm_kernel.PATHS})


def phase_serve_full(cfg, tag, p, prompt, limit, max_abs):
    """Phase 26 (llava-next-mistral-7b at full width and depth), phase 27
    (whisper-tiny whole), phase 29 (xlstm-350m whole) and phase 31
    (recurrentgemma-9b at full width and depth): served at phase 5's groups,
    batch and new tokens, prompts of ``prompt`` tokens (behind the front,
    patches or frames from the seed as the launcher draws them, where the
    family has one); prefill and decode ms, tok/s, RMSNorm launches == the
    structure's count (prefill blocks on bulk, the sinks and decode on
    latency) and the sLSTM kernel's (a forward a slstm block and group),
    then decoding token ``prompt`` against a prefill of ``prompt + 1``
    within ``limit`` and ``max_abs``.  Returns the RMSNorm launches of the
    timed run, in all and by path, and the sLSTM kernel's."""
    spec = RunSpec(p=p, n_chunks=1, microbatch=B, seq_len=prompt, m=M)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    stacked, shared = init_params(cfg, spec, Placement.linear(p), seed=0, device=DEV)
    torch.cuda.synchronize()
    leaves = tree_leaves((stacked, shared))
    key, n_front, width = front_spec(cfg) or ("front", 0, 0)
    pattern = ", ".join("+".join(kinds) for kinds in cfg.block_pattern)
    print(f"[{tag}] init {cfg.name} ({cfg.n_layers} layers of {pattern}, "
          f"d={cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv_heads} kv), d_ff={cfg.d_ff}, vocab "
          f"{cfg.vocab}, {n_front} {key} of {width}, {cfg.dtype}): "
          f"{sum(t.numel() for t in leaves) / 1e9:.3f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB, on {DEV} in "
          f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (M, B, prompt))
    front = draw_front(cfg, rng, M, B)
    serve(cfg, stacked, shared, prompts, p=p, new_tokens=1, front=front)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    res, launches, by_path, sl = _serve_counted(
        tag, cfg, p, M, NEW,
        lambda: serve(cfg, stacked, shared, prompts, p=p, new_tokens=NEW, front=front,
                      log=lambda x: print(f"[{tag}] {x}")))
    _check_served(cfg, res, M, B, NEW)
    decode_ms = [x * 1e3 for x in res.decode_s]
    cached = n_front if cfg.family == "vlm" else 0
    print(f"[{tag}] p={p} m={M} b={B} {key}={n_front} prompt={prompt} new={NEW} (cache of "
          f"{cached + prompt + NEW} positions, decode from position {cached + prompt}): "
          f"prefill_ms={res.prefill_s * 1e3:.1f} "
          f"decode_ms_per_step mean={np.mean(decode_ms):.2f} median={np.median(decode_ms):.2f} "
          f"min={min(decode_ms):.2f} max={max(decode_ms):.2f} "
          f"generated_tok_per_s={M * B * NEW / sum(res.decode_s):.1f} "
          f"max_memory_allocated_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}; "
          f"rmsnorm launches {launches} == expected {expected_norm_launches(cfg, p, M, 1 + NEW)}, "
          f"by path {by_path}")
    print(f"[{tag}] sLSTM kernel launches {sl}")
    phase_consistency(cfg, stacked, shared, prompts, res, p=p, limit=limit, tag=tag,
                      front=front, max_abs=max_abs)
    del stacked, shared, res
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_path, sl


def _kernel_row(name, source, replaces, launches, by_path, row, **extra):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": by_path,
        **extra,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card visible to torch; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_full, cfg_red = get_config(ARCH), get_reduced(ARCH)
    cfg_train = train_config()
    t_start = time.perf_counter()
    phase_build()
    phase_card()
    print(f"[time] build and card done at {time.perf_counter() - t_start:.1f}s")
    more = run_child(GPT3_CHILD, "gpt3_launches")
    print(f"[time] gpt3 phases (child process) done at {time.perf_counter() - t_start:.1f}s")
    more.update(run_child(MOE_CHILD, "moe_launches"))
    print(f"[time] qwen2-moe phases (child process) done at {time.perf_counter() - t_start:.1f}s")
    more.update(run_child(DEEPSEEK_CHILD, "deepseek_launches"))
    print(f"[time] deepseek-v3 phases (child process) done at "
          f"{time.perf_counter() - t_start:.1f}s")
    more.update(run_child(FRONT_CHILD, "front_launches"))
    print(f"[time] whisper and llava phases (child process) done at "
          f"{time.perf_counter() - t_start:.1f}s")
    more.update(run_child(XLSTM_CHILD, "xlstm_launches"))
    print(f"[time] xlstm phases (child process) done at {time.perf_counter() - t_start:.1f}s")
    more.update(run_child(RGEMMA_CHILD, "recurrentgemma_launches"))
    print(f"[time] recurrentgemma phases (child process) done at "
          f"{time.perf_counter() - t_start:.1f}s")
    more.update(run_child(LONG_CHILD, "long_launches"))
    print(f"[time] seq-4096 phases (child process) done at {time.perf_counter() - t_start:.1f}s")
    rows = phase_kernels(cfg_full, cfg_red)
    print(f"[time] rmsnorm kernel phase done at {time.perf_counter() - t_start:.1f}s")
    wrows = phase_kernels_wgrad(cfg_red)
    print(f"[time] wgrad_accum kernel phase done at {time.perf_counter() - t_start:.1f}s")
    srow = phase_kernels_slstm()
    print(f"[time] slstm_scan kernel phase done at {time.perf_counter() - t_start:.1f}s")
    for arch in RED_ARCHS:
        phase_reduced(get_reduced(arch), RED_PROMPTS[arch])
    print(f"[time] reduced serving phase done at {time.perf_counter() - t_start:.1f}s")
    stacked, shared, prompts, res, serve_launches = phase_serve(cfg_full)
    print(f"[time] serve phase (5) done at {time.perf_counter() - t_start:.1f}s")
    phase_consistency(cfg_full, stacked, shared, prompts, res)
    phase_profile(cfg_full, stacked, shared, prompts)
    print(f"[time] internlm2 serving phases (5-7) done at {time.perf_counter() - t_start:.1f}s")
    del stacked, shared, res
    torch.cuda.empty_cache()
    gemma2_launches = phase_serve_gemma2(get_config(GEMMA2))
    print(f"[time] serving phases done at {time.perf_counter() - t_start:.1f}s")
    for arch in RED_ARCHS:
        phase_train_reduced(get_reduced(arch))
    print(f"[time] reduced training phase done at {time.perf_counter() - t_start:.1f}s")
    runs = phase_train(cfg_train)
    print(f"[time] train phase (9) done at {time.perf_counter() - t_start:.1f}s")
    phase_train_checks(cfg_train, runs)
    print(f"[time] train-checks phase (10) done at {time.perf_counter() - t_start:.1f}s")
    phase_train_noclip(cfg_train, runs)
    print(f"[time] training phases done at {time.perf_counter() - t_start:.1f}s")
    planners = phase_plan(cfg_train)
    phase_plan_vs_card(cfg_train, runs, planners, "eager")
    print(f"[time] planner phases done at {time.perf_counter() - t_start:.1f}s")
    more["launcher"] = phase_launch_budget(cfg_train)
    print(f"[time] launcher phase done at {time.perf_counter() - t_start:.1f}s")
    more["replay"] = phase_replay(cfg_train)
    print(f"[time] replay phase done at {time.perf_counter() - t_start:.1f}s")
    del planners
    more.update(run_child(GRAPH_CHILD, "graph_launches", runs))
    print(f"[time] graph phases (child process) done at {time.perf_counter() - t_start:.1f}s")
    more.update(run_child(HELDOUT_CHILD, "heldout_launches"))
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    check(all(sum(c[4].values()) > 0 for n, c in more.items() if n.startswith(
        ("train-xlstm", "serve-xlstm"))), "a run of xlstm launched no sLSTM kernel")

    counted = {**{f"train-{n}": r["launches"] for n, r in runs.items()}, **more}
    wgrad_by_run = {n: c[0] for n, c in counted.items()}
    wgrad_by_path = {k: sum(c[2][k] for c in counted.values()) for k in wgrad_kernel.PATHS}
    rms_by_run = {"serve": serve_launches[0], "serve-gemma2": gemma2_launches[0],
                  **{n: c[1] for n, c in counted.items()}}
    rms_by_path = {k: serve_launches[1][k] + gemma2_launches[1][k]
                   + sum(c[3][k] for c in counted.values()) for k in rms_kernel.PATHS}
    slstm_by_run = {n: sum(c[4].values()) for n, c in counted.items() if sum(c[4].values())}
    slstm_by_path = {k: sum(c[4][k] for c in counted.values()) for k in slstm_kernel.PATHS}

    def by_shape(table):
        keys = ("path", "plan", "ms", "cold_ms", "bound_ms", "library_ms", "library_cold_ms",
                "max_abs_err", "fp64_err")
        return {label: {k: r[k] for k in keys if k in r} for label, r in table.items()}

    print(json.dumps({"kernels": [
        _kernel_row("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:29", sum(rms_by_run.values()), rms_by_run,
                    rows["prefill"], launches_by_kernel_path=rms_by_path,
                    by_shape=by_shape(rows)),
        _kernel_row("wgrad_accum", "src/repro_torch/kernels/csrc/wgrad_accum.cu",
                    "src/repro/kernels/wgrad_accum.py:51", sum(wgrad_by_run.values()),
                    wgrad_by_run, wrows["wu,wg"], launches_by_kernel_path=wgrad_by_path,
                    by_shape=by_shape(wrows)),
        _kernel_row("slstm_scan", "src/repro_torch/kernels/csrc/slstm_scan.cu",
                    "none: port-only, the lax.scan of src/repro/models/modules.py:500 "
                    "(apply_slstm)", sum(slstm_by_run.values()), slstm_by_run, srow,
                    launches_by_kernel_path=slstm_by_path, chain_ms=srow["chain_ms"],
                    bytes_ms=srow["bytes_ms"], floor_ms=srow["floor_ms"],
                    fwd_ms=srow["fwd_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def gpt3_child_main() -> int:
    """Phases 18 and 19, alone in this process; the last line is a JSON
    object with both kernels' launches of each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()  # the parent built them: this only loads the cached libraries
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(GPT3), n_layers=G3_LAYERS)
    runs, planners = phase_train_gpt3(cfg)
    print(f"[time] gpt3 training phase done at {time.perf_counter() - t0:.1f}s (child)")
    counts = {f"train-gpt3-{n}": r["launches"] for n, r in runs.items()}
    counts["launcher-gpt3"] = phase_launch_gpt3(cfg, runs, planners)
    print(f"[time] gpt3 launcher phase done at {time.perf_counter() - t0:.1f}s (child)")
    print(json.dumps({"gpt3_launches": counts}))
    return 0


def moe_child_main() -> int:
    """Phases 21 and 20, in that order (``phase_train_cut`` says why),
    alone in this process; the last line is a JSON object with both
    kernels' launches of each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    t0 = time.perf_counter()
    cfg = get_config(MOE)
    counts = phase_train_cut(dataclasses.replace(cfg, n_layers=MT_LAYERS))
    print(f"[time] qwen2-moe training phase done at {time.perf_counter() - t0:.1f}s (child)")
    gc.collect()
    torch.cuda.empty_cache()
    rms, rms_by_path = phase_serve_moe(cfg)
    print(f"[time] qwen2-moe serving phase done at {time.perf_counter() - t0:.1f}s (child)")
    counts["serve-qwen2-moe"] = _serve_counts(rms, rms_by_path)
    print(json.dumps({"moe_launches": counts}))
    return 0


def deepseek_child_main() -> int:
    """Phases 23 and 22, in that order (``phase_train_cut`` says why),
    alone in this process; the last line is a JSON object with both
    kernels' launches of each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    t0 = time.perf_counter()
    cfg = get_config(DEEPSEEK)
    counts = phase_train_cut(cut_config(cfg, DT_LAYERS, DT_EXPERTS, DT_VOCAB), DS_TRAIN)
    print(f"[time] deepseek-v3 training phase done at {time.perf_counter() - t0:.1f}s (child)")
    gc.collect()
    torch.cuda.empty_cache()
    rms, rms_by_path = phase_serve_moe(dataclasses.replace(cfg, n_layers=DS_LAYERS),
                                       tag="serve-deepseek-v3", p=DS_P, limit=DS_CONSIST_REL_L2)
    print(f"[time] deepseek-v3 serving phase done at {time.perf_counter() - t0:.1f}s (child)")
    counts["serve-deepseek-v3"] = _serve_counts(rms, rms_by_path)
    print(json.dumps({"deepseek_launches": counts}))
    return 0


def front_child_main() -> int:
    """Phases 24-27: whisper-tiny's and llava's training phases first, each
    in ``launch/calibrate.py``'s order (``phase_train_cut`` says why),
    whisper's first, as small as it is, then both served; alone in this
    process; the last line is a JSON object with both kernels' launches of
    each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    t0 = time.perf_counter()
    whisper, llava = get_config(WHISPER), get_config(LLAVA)
    counts = phase_train_cut(whisper, WHISPER_TRAIN)
    print(f"[time] whisper training phase done at {time.perf_counter() - t0:.1f}s (child)")
    layers = _llava_depth(llava)
    counts.update(phase_train_cut(dataclasses.replace(llava, n_layers=layers), LLAVA_TRAIN))
    print(f"[time] llava training phase done at {time.perf_counter() - t0:.1f}s (child)")
    gc.collect()
    torch.cuda.empty_cache()
    for cfg, tag, p, prompt, limit, max_abs in (
            (llava, "serve-llava", LS_P, PROMPT, LS_CONSIST_REL_L2, LS_CONSIST_MAX_ABS),
            (whisper, "serve-whisper", WS_P, WS_PROMPT, WS_CONSIST_REL_L2, WS_CONSIST_MAX_ABS)):
        counts[tag] = _serve_counts(*phase_serve_full(cfg, tag, p, prompt, limit, max_abs))
        print(f"[time] {tag} phase done at {time.perf_counter() - t0:.1f}s (child)")
    print(json.dumps({"front_launches": counts}))
    return 0


def xlstm_child_main() -> int:
    """Phases 28 and 29: xlstm-350m trained in ``launch/calibrate.py``'s
    order (``phase_train_cut`` says why), then served; alone in this
    process; the last line is a JSON object with the kernels' launches of
    each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    t0 = time.perf_counter()
    cfg = get_config(XLSTM)
    counts = phase_train_cut(cfg, XLSTM_TRAIN)
    print(f"[time] xlstm training phase done at {time.perf_counter() - t0:.1f}s (child)")
    gc.collect()
    torch.cuda.empty_cache()
    counts["serve-xlstm"] = _serve_counts(*phase_serve_full(
        cfg, "serve-xlstm", XS_P, PROMPT, XS_CONSIST_REL_L2, XS_CONSIST_MAX_ABS))
    print(f"[time] xlstm serving phase done at {time.perf_counter() - t0:.1f}s (child)")
    print(json.dumps({"xlstm_launches": counts}))
    return 0


def recurrentgemma_child_main() -> int:
    """Phases 30 and 31: recurrentgemma-9b's training cut priced, then
    trained in ``launch/calibrate.py``'s order, in a fresh process of its
    own (after xlstm's phases in one process its eager zb-h1 run reserved
    0.6 GiB more and passed the price; H100, 700 W), then served at full
    depth; the last line is a JSON object with the kernels' launches of
    each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    t0 = time.perf_counter()
    cfg = get_config(RGEMMA)
    cut = cut_config(cfg, RT_LAYERS, vocab=RT_VOCAB)
    worst = _priced(cut, RGEMMA_TRAIN)
    check(worst <= RT_PRICE_GIB * 2**30, f"{cut.name} at {RT_LAYERS} layers prices "
          f"{_gib(worst)} GiB > {RT_PRICE_GIB} GiB")
    counts = phase_train_cut(cut, RGEMMA_TRAIN)
    print(f"[time] recurrentgemma training phase done at {time.perf_counter() - t0:.1f}s (child)")
    gc.collect()
    torch.cuda.empty_cache()
    counts["serve-recurrentgemma"] = _serve_counts(*phase_serve_full(
        cfg, "serve-recurrentgemma", RS_P, PROMPT, RS_CONSIST_REL_L2, RS_CONSIST_MAX_ABS))
    print(f"[time] recurrentgemma serving phase done at {time.perf_counter() - t0:.1f}s (child)")
    print(json.dumps({"recurrentgemma_launches": counts}))
    return 0


def long_child_main() -> int:
    """Phases 32 and 33: internlm2-1.8b at seq 4096 first, in a fresh
    process as its record was measured, then the reduced twin at 2304;
    the last line is a JSON object with the kernels' launches of each
    run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    t0 = time.perf_counter()
    counts = phase_train_long(get_config(ARCH))
    print(f"[time] train-long phase done at {time.perf_counter() - t0:.1f}s (child)")
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_long_reduced(get_reduced(ARCH))
    print(f"[time] train-long-reduced phase done at {time.perf_counter() - t0:.1f}s (child)")
    print(json.dumps({"long_launches": counts}))
    return 0


def graph_child_main(eager_path) -> int:
    """Phase 16 with its half of phase 13 (the graph gate), alone in this
    process, against phase 9's results read from
    ``eager_path``; the last line is a JSON object with both kernels'
    launches of each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    t0 = time.perf_counter()
    cfg = train_config()
    runs = {}
    for name, r in json.loads(pathlib.Path(eager_path).read_text()).items():
        sched = make_schedule(name, T_P, T_M)
        runs[name] = dict(r, sched=sched, plan=compile_plan(sched), res=TrainResult(
            r["losses"], r["grad_norms"], [], r["step_s"]))
    graph_runs, graph_mem = phase_train_graph(cfg, runs)
    run = dict(p=T_P, m=T_M, microbatch=T_B, seq_len=T_SEQ)
    planners = {"model": HBMPlanner(cfg, **run),
                "measured": HBMPlanner(cfg, program_factory=stage_program_factory(
                    cfg, T_P, T_M, T_B, T_SEQ, DEV), **run)}
    phase_plan_vs_card(cfg, graph_mem, planners, "graph")
    print(f"[time] graph phases done at {time.perf_counter() - t0:.1f}s (child)")
    print(json.dumps({"graph_launches": {f"train-graph-{n}": c for n, c in graph_runs.items()}}))
    return 0


def heldout_child_main() -> int:
    """Phase 13's held-out runs, alone in this process, as a launcher run
    at that shape would be; the last line is a JSON object with both
    kernels' launches of each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    print(json.dumps({"heldout_launches": phase_heldout(train_config())}))
    return 0


def run_child(flag, key, eager_runs=None):
    """Phases in a child process with the card to itself, as a launcher
    run has it; returns the child's launch counts by run.  ``GPT3_CHILD``
    runs phases 18-19 before this process allocates anything: gpt3-1.5b's
    graph runs reserve up to ~80 GB of the card's 85, and after the
    internlm2 phases in this process they came within 1.1 GB of it;
    ``MOE_CHILD`` runs phases 20-21 next, for the same reason (28.6 GB of
    weights to serve, ~60 GiB to train), ``DEEPSEEK_CHILD`` phases
    22-23 after it (50 GB of weights to serve, ~50-65 GiB to train), and
    ``FRONT_CHILD`` phases 24-27 after that (llava: 14.5 GB of weights to
    serve, up to LT_PRICE_GIB to train).
    ``GRAPH_CHILD`` runs phase 16 and its gate against ``eager_runs``
    (phase 9's results, passed in a file), ``HELDOUT_CHILD`` the held-out
    runs: in this process, after phases 3-15, the graph runs reserved up to
    2.0 GiB more than in a fresh one, and the held-out runs 3.1 GiB more
    after phase 16's in one process (H100, 700 W); the planner prices a
    process that trains one model, as the launcher's does."""
    args, tmp = [flag], None
    if eager_runs is not None:
        torch.cuda.empty_cache()
        tmp = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
        json.dump({n: {k: r[k] for k in ("seq", "peak_gb", "reserved_gb")}
                   | {"losses": r["res"].losses, "grad_norms": r["res"].grad_norms,
                      "step_s": r["res"].step_s} for n, r in eager_runs.items()}, tmp)
        tmp.close()
        args.append(tmp.name)
    try:
        out = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), *args],
                             capture_output=True, text=True, timeout=900)
    finally:
        if tmp is not None:
            pathlib.Path(tmp.name).unlink()
    print(out.stdout, end="", flush=True)
    print(out.stderr, end="", file=sys.stderr, flush=True)
    check(out.returncode == 0, f"the phases of {flag} failed in their child process (exit "
          f"{out.returncode})")
    counts = json.loads(out.stdout.strip().splitlines()[-1])[key]
    return {run: tuple(c) for run, c in counts.items()}


if __name__ == "__main__":
    if sys.argv[1:2] == [GPT3_CHILD]:
        sys.exit(gpt3_child_main())
    if sys.argv[1:2] == [MOE_CHILD]:
        sys.exit(moe_child_main())
    if sys.argv[1:2] == [DEEPSEEK_CHILD]:
        sys.exit(deepseek_child_main())
    if sys.argv[1:2] == [FRONT_CHILD]:
        sys.exit(front_child_main())
    if sys.argv[1:2] == [XLSTM_CHILD]:
        sys.exit(xlstm_child_main())
    if sys.argv[1:2] == [RGEMMA_CHILD]:
        sys.exit(recurrentgemma_child_main())
    if sys.argv[1:2] == [GRAPH_CHILD]:
        sys.exit(graph_child_main(sys.argv[2]))
    if sys.argv[1:2] == [HELDOUT_CHILD]:
        sys.exit(heldout_child_main())
    if sys.argv[1:2] == [LONG_CHILD]:
        sys.exit(long_child_main())
    sys.exit(main())
