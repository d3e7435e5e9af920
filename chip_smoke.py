#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing is caught:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Build: compiles the five hand-written kernels from ``src/repro_torch``
   and K5's frozen witness, one ``nvcc`` per source, all started together
   (set-up time, printed).
3. Kernels against their plain PyTorch versions, on the card, at every GEMM
   shape of CIFAR_Alex+ at 256 frames, at ragged shapes, for fp32 and bf16
   inputs and every fused epilogue.  TF32 is off for both matmul and cuDNN.
   ``vpu_mm`` is also checked at the runtime's 32-row panel shapes, bitwise
   against ``tiled_mm`` for every fp32 case, and its SASS must hold no
   tensor-core instruction.  ``qmm`` (slice 3) at the Alex+ GEMMs, their
   panels, the ragged shapes and k = 75 with n = 10: raw int32 bitwise,
   fused fp32/bf16 none/relu bitwise and silu within 2 ulp; one build
   serves four activation scales.  Slice 4: ``flash_attention`` (K4)
   against ``attention_ref`` at zamba2's prefill call (bf16 and fp32),
   GQA 32/8 D 64, 40/10 D 128, 64/8 D 112, 16/16 D 256, whisper's
   non-causal encoder (S = Sk = 1500) and cross attention (16 / 1500), and
   a ragged S = 200; ``ssd`` (K5) against the chunked torch path at
   zamba2's prefill call (fp32, the main path's type, and bf16),
   mamba2-130m's N = 128, L = 1000 (padded) and chunk 64, y and state.
   Tolerances relative to max|ref|: fp32 2e-5·sqrt(Sk or L), bf16 3e-2.
   Slice 5: K1's bf16 paths at zamba2's GEMMs and the ragged shapes,
   each on the path its (n, k) picks (wgmma for n, k % 8 == 0, else mma:
   the per-path launch counts show it), row panels, m = 1 vs m = 4 and
   an unaligned view bitwise the whole GEMM; K1's SASS holds HGMMA, HMMA
   and FFMA, K4's HMMA; K4 and K5 also at the reduced configs' shapes
   (head dim 16; P 16, N 16, chunk 16).  Slice 6: K2 and K3 also at the
   tile borders of their redesigns: every (m, n, k) with m in {1, 31, 32,
   33, 127, 129}, n in {1, 10, 63, 65}, k in {1, 31, 33, 75}; K2 with
   every operand at -128 or 127, and both kernels on a row panel cut from a
   k = 75 GEMM (a base off every 16-byte boundary) bitwise the whole GEMM's
   rows; K2's SASS holds IMMA and no IDP (dp4a), K3's FFMA and no *MMA.
   Slice 11: K5 bitwise (``torch.equal`` on y and the final state) its
   frozen witness, ``csrc/ssd_witness.cu`` (its first version), at every
   SSD_CASES and BWD_SSD_CASES shape in fp32 and bf16.
4. Main path, dispatcher (slice 1): ``cnn_forward`` of CIFAR_Alex+ at its
   published widths on 256 frames, with launch counts set to 0 just before
   and read just after; logits are held against the same forward with
   every GEMM pinned to the plain fp32 oracle.  The other six paper CNNs
   run at 64 frames, held the same way.
   Main path, runtime (slice 2): the same forward through
   ``SynergyRuntime(["cuda-tiled", "neon-vpu"])``, every GEMM split into
   32-row panels over both kernels and balanced by stealing, counts set to
   0 just before and read just after; logits must be BITWISE equal to the
   dispatcher forward, both kernels must run panels, and launches must
   equal panels.  The other six CNNs run through it at 16 frames, bitwise.
   Int8 (slice 3): the quantizers on the card bitwise equal to the CPU
   over the Alex+ weights and patch panels; ``register_quantized`` calibrates
   ``cuda-tiled-int8``; the decode forward through the dispatcher (K2 once
   per GEMM, K1/K3 never, logits within ``rel_err`` 0.05 of fp32) and through
   ``SynergyRuntime(["cuda-tiled", "cuda-tiled-int8"])`` (K2 once per panel
   on both workers, bitwise equal to a one-worker int8 pool from the same
   calibrator state); fp32 through that pool launches K2 never and is
   bitwise the dispatcher forward.  The other six CNNs run both decode
   paths at 16 frames.
   LM serving (slice 4): zamba2-2.7b at its published widths and all 54
   layers (param fp32, compute bf16, random weights from a seed, on the
   card): 4 x 1,024-token prompts through ``prefill_fn`` (counts set to 0
   just before and read just after: K4 9, K5 54, K1 55), then 32 greedy
   ``decode_fn`` steps from a cache of max_len 1,057 (each: K4 0, K5 0,
   K1 55); against the same prefill with ``impl="ref"``, within
   ``rel_err`` 3e-2: the logits in fp32 compute, and the bf16 prefill
   block by block (a bf16 logit comparison is printed, not held: at 54
   layers any last-bit difference grows past 3e-2); at full width in
   fp32, 16 decode steps from an empty cache reproduce ``lm_forward``
   (which runs K4 and K5) within 2e-3.  Every K1 launch of the prefill
   and of each decode step takes the wgmma path, every one of the fp32
   CNN forward the ffma path.  Slice 5: the reduced zamba2-2.7b (4
   layers) and mamba2-130m (2 layers) prefill 2 x 70 tokens on the card
   through K4 and K5 (counts set to 0 just before, read just after),
   within 1e-4 of the same prefill on the CPU.  Slice 8, ``serving``: the
   continuous-batching server (``core/serving.py``) on zamba2-2.7b at full
   width (the LM slice's params), 4 slots, max_len 64, the default MNIST
   prefill CNN, 8 requests of 16 prompt and 8 new tokens, over
   ``SynergyRuntime(["cuda-tiled", "neon-vpu"])``: wave admission with
   batched and with per-slot decode, single admission, chunked prefill,
   then int8-calibrated over ``["cuda-tiled", "cuda-tiled-int8"]``
   batched and per-slot (both from one calibrator state), counts set to 0
   just before each run and read just after.  Every run gives each
   request the first run's tokens; batched and per-slot decode-GEMM
   outputs are BITWISE in each precision; every run's decode GEMMs
   (216 x 10,240 x 2,560 batched, 54 rows per slot) are held against
   their plain versions on the same inputs: fp32 within 1e-5·sqrt(k) of
   ``tiled_mm_ref``, int8 bitwise ``qmm_ref``; fp32 runs launch K1 and K3
   and not K2, int8 runs launch K2, no run launches K4 or K5.  A reduced
   granite-3-2b server (the stacked-wi decode GEMM) on the CPU and, in
   both decode modes, on the card with the same weights: equal tokens,
   the card's modes bitwise, decode GEMMs within 1e-5·sqrt(d_model) of
   the CPU's.  Tokens/s, ms and host µs per engine step, and the
   card's busy share of one decode step under ``torch.profiler``.
   Slice 9, ``durability``: the same zamba2-2.7b server with
   ``Durability`` (snapshots every 4 steps, 2 kept, in a temporary
   directory removed afterwards) crashes at engine step 6 by a
   ``CrashPlan`` (a snapshot taken, decode live, requests queued), its
   runtime shut down, and ``SynergyServer.restore`` on a fresh runtime
   runs to the end: wave + batched over ``["cuda-tiled", "neon-vpu"]``
   and int8 batched over ``["cuda-tiled", "cuda-tiled-int8"]`` from the
   serving phase's int8 calibrator state.  Each request's tokens equal
   the serving run's, ``tokens_out + replayed_tokens`` its
   ``tokens_out``, ``restores`` 1; counts set to 0 just before the
   restore and read just after: fp32 launches K1 and K3 and not K2, int8
   K2, neither K4 nor K5; every decode GEMM of the restored server held
   against its plain version as in ``serving``.  Then one real kill: a
   child process (``python3 -c``, the port only) serves the reduced
   granite-3-2b on the card with ``Durability`` and is SIGKILLed once its
   journal holds 4 token records; the parent restores on the card and
   runs to the end, and every request's tokens, as the journal delivered
   them, equal the card's uninterrupted run.  Snapshot bytes, ms per
   snapshot (host copy, wait on the writer), restore ms (load, replay),
   replayed tokens and jobs, torn-tail bytes and the phase's seconds.
   Slice 10, ``training`` (after phase 5's LM times, as the last user of
   the LM parameters): zamba2-2.7b at full width and depth, 2 x 1,024
   tokens a step from ``synthetic_batches(seed=0)`` through ``prefetch``,
   remat per scanned block.  In fp32 compute one forward and backward
   through K4 and K5 (``impl="auto"``, counts set to 0 just before and
   read just after: K4 9, K5 108, K1-K3 0) and one through the plain
   formulations (an op variant ``plain`` of both mixers): every leaf's
   gradient non-zero in both and within ||diff|| / ||plain|| 3e-2.  Then
   3 bf16 AdamW steps (``build_train_step``, the state written in place),
   counts set to 0 just before each and read just after (K4 9, K5 108,
   K1-K3 0): loss and grad norm finite, the first loss within 1 of
   ln(vocab), after step 1 every leaf moved and its first moment finite
   and non-zero; ms per step, tokens/s, the share of the bf16 dense peak
   at 6·N·D, peak memory, and one more step under ``torch.profiler``
   (busy share, the five largest device ops, K4's and K5's backward
   device time).  The reduced zamba2 (4 layers, fp32) trained 3 steps on
   the card and on the CPU from one CPU state (losses and every state
   leaf within 1e-4 of the CPU leaf's largest entry), and resumed:
   ``train_loop`` with a ``Checkpointer`` every 2 steps under
   ``run_with_recovery``, a failure after step 3, bitwise equal to an
   uninterrupted 4-step run.
5. Times (CUDA events, warm-up, median of 25): per Alex+ GEMM, each kernel,
   its plain version, ``torch.addmm`` + ReLU as the library yardstick, and
   the bound; both kernels also at the runtime's panel shapes, weighted by
   the panels each ran in phase 4's runtime forward; frames/s of the whole
   forward on both paths, and the runtime's host cost per panel; one
   runtime forward under ``torch.profiler``: each kernel's device time and
   the card's busy share.  Slice 3: K2 per whole GEMM (fused) and per panel
   (raw) beside its plain version, its bound and ``torch._int_mm``; the
   quantization pass per GEMM; frames/s of both decode forwards beside
   both fp32 forwards; one profiled runtime decode forward.  Slice 4:
   prefill ms and tokens/s (median of 3), decode ms per step and tokens/s
   (median of 32); K4 and K5 at the main path's call beside their plain
   versions, the bound and (K4) ``F.scaled_dot_product_attention``; K5
   also at the training step's call, both beside its witness (slice 11:
   witness, kernel, kernel, witness, the faster of each pair); one
   prefill and one decode step under ``torch.profiler``.  Slice 5: K1 at
   every GEMM of one prefill and one decode step (recorded by an engine
   pinned with ``engine_scope``), beside its plain version, one bf16
   ``torch.matmul`` per GEMM and the bound at the bf16 peak, and K1's
   TFLOP/s on the prefill.  Slice 7, after the runtime path's times:
   ``pipeline``, CIFAR_Alex+ x256 as 8 micro-batches of 32 through a
   ``ThreadedPipeline`` of three stages pinned to K1, K3 and K1 (counts
   set to 0 just before, read just after; logits BITWISE the dispatcher
   forward's), frames/s beside the dispatcher's and the runtime's;
   ``runtime_steal``, ``benchmarks/paper_figs.py::runtime_steal`` on the
   card (8 conv2 im2col panels of 8,192 rows through ``EngineStage.gemm``
   pinned, then under ``SynergyRuntime(POOL).scope()``; outputs equal;
   steals, busy fractions and ``runtime_beats_pinned`` printed, not
   gated); ``graph``, the conv front-end as 8 wave graphs in flight at
   once (``conv_wave_graph`` + ``submit_graph``, counts set to 0 just
   before, read just after) and as a chain with a reap after every layer,
   every wave BITWISE the dispatcher's conv4 output, a ``cancel()`` that
   drains queued panels, frames/s of both and the card's busy share of a
   profiled graph run.  Slice 18, ``faults`` (after ``graph``): the
   runtime's fault paths on the card. The CIFAR_Alex+ x256 forward through
   ``wrap_pool(POOL, plan)`` under ``RetryPolicy(check_outputs=True)``
   with two ``raise`` on ``cuda-tiled``, a ``corrupt`` and a ``drop`` on
   ``neon-vpu`` and its ``die`` half-way through the panels seeded onto it:
   logits BITWISE phase 4's, every panel merged once, one worker death,
   orphans re-seeded, K1 + K3 launches equal to the panels plus the
   attempts thrown away; the fault-free forward with the NaN/Inf screen off
   and on in turns (host µs a panel); the int8 decode forward over
   ``QPOOL`` from phase 4's calibrator state with two ``raise`` on the int8
   worker, BITWISE phase 4's int8 runtime forward; the reduced granite
   server over a faulted pool, tokens equal to the fault-free card run and
   ``runtime_retries`` >= 1; ``PanelRetryExhausted`` with a
   ``retry_exhausted`` flight dump; a x50 ``slowdown`` that quarantines
   ``neon-vpu`` under a ``HealthPolicy``.  Slice 12, ``mesh`` (after
   phase 5's LM profile, on the LM parameters; the train step after
   ``training``): a process
   group of one NCCL rank, ``make_test_mesh(data=1, model=1)``.
   ``build_prefill_step`` on the LM prefill's 4 x 1,024 tokens,
   ``build_decode_step`` (donate) 8 steps from a fresh cache, and 2 bf16
   AdamW steps of ``build_train_step(cfg, cell, mesh)`` on a state made
   from seed 0 and placed by its specs, each ``torch.equal`` to the
   unsharded function on the same inputs (the train step: losses, grad
   norms and every state leaf's digest and first 4,096 entries; the
   unsharded run first, its state freed before the mesh's is made), with
   the same launches, counts set to 0 just before and read just after
   (prefill K1 55, K4 9, K5 54; decode K1 55 a step; train K4 9, K5 108 a
   step); the decode cache written into the tensors ``init_cache`` made.
   ``build_pp_forward`` on a one-stage mesh, granite-3-2b at its
   published widths and 4 layers, ``torch.equal`` to the sequential
   blocks; ``sync_pods_compressed`` with one pod bitwise ``anchor +
   dequantize(quantize(delta))``.  Wall times of both sides and peak
   memory; a mesh of one rank measures nothing about scaling.  Slice 13,
   ``dryrun`` (last): ``python -m repro_torch.launch.dryrun`` of
   zamba2-2.7b ``train_4k`` on the (16, 16) and (2, 16, 16) production
   meshes of fake ranks, in two subprocesses (each record must be
   ``ok``; memory, accounting and trace seconds printed); meanwhile the
   LM phase's prefill and the training phase's AdamW step traced on
   ``meta`` by ``analyze_step``: traced calls per kernel (K1 by path)
   equal to the card's launch counts of the same runs (prefill K1 55 on
   wgmma, K4 9, K5 54; train step K4 9, K5 108), the traced train-step
   peak within 10 % of ``max_memory_allocated`` over the unsharded
   mesh-phase steps, and traced flops over the profiled device busy
   time as TFLOP/s.  Slice 14: in phase 3, K5 at a rank's share of P
   (every P 4-64 x N 16/64/128 at zamba2's, mamba2-130m's and the
   reduced prefill shapes) within 2e-5·sqrt(L) of its plain version,
   every P-column slab ``torch.equal`` the P 64 call's, timed beside
   ``ssd_bound``; after ``mesh``, ``mesh_tp``: the serving steps
   partitioned over 'model' by two gloo ranks sharing the card (each a
   process of its own with a time limit), zamba2-2.7b fp32 at full width
   and TP_LAYERS (18) of its 54 layers, prefill and 8 greedy decode steps
   (at the LM phase's depth: positions 1,024 on of a 1,057 cache holding
   a seeded random history) within 1e-4 of the unsharded steps (rank 0
   runs them), equal tokens, every rank's cache shards; per rank K5 18
   at P 32, K4 3 at 16 heads, K1 19 (ffma); one bf16 layer mixer by
   mixer; prefill, decode and collective ms and peak memory per rank.
   Slice 15, ``mesh_tp_train``: the same ranks train the same model
   (fp32, 2 AdamW steps), held to rank 0's unsharded steps.  Slice 16,
   ``mesh_fsdp``: two such ranks over 'data' with ``fsdp=True``, each
   layer gathered just before it and its gradient reduce-scattered:
   zamba2-2.7b at all 54 layers trained (2 fp32 AdamW steps), and served
   at FSDP_SERVE_LAYERS (12) layers (prefill and 8 decode steps), and
   dbrx-132b's decode at 2 of its 40 layers (FSDP_MOE_DECODE steps, the
   MoE gathering its input's rows), each held to rank 0's unsharded run.
   Slice 17, ``adafactor`` (after the one-rank mesh's train steps):
   kimi-k2 at d_model 1,024 cut to 3 layers of 8 experts (fp32), 2
   Adafactor train steps of 2 x 256 tokens from one state made on the
   CPU, every stacked leaf updated one layer's slice at a time: losses
   and factored parameters within 1e-4 of the CPU's, the statistics
   within 1e-3, unfactored parameters within Adafactor's own per-entry
   bound (``adafactor_step_bound``), the launches a step
   equal to the step's calls traced on ``meta``, and the traced peak
   within 10 % of ``max_memory_allocated``; the ``dryrun`` phase also
   prints each record's peak phase and largest origins, and the traced
   ranks now save each rematerialized block's input as their 'model'
   slice.
6. One ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.  K1's and K3's ``plain_note`` says
   that their plain times are of a float64-summed GEMM.  A kernel's
   top-level numbers are the runtime path's (this slice's main path):
   launches in phase 4's runtime forward, and times of the panels it ran there (``qmm``: the runtime
   decode forward's); ``by_path`` gives each path's launches and times on
   its own basis (``qmm``: with its launches by path, ``async`` and
   ``shift``).  K4's and K5's are the LM prefill's: launches in it, and
   per-call medians times the calls one prefill makes.  K1's ``by_path``
   also gives ``lm_prefill`` and ``lm_decode`` (per step): launches by
   path, times, bound and library time over the LM GEMMs; K1's and K3's
   give ``pipeline``, ``runtime_steal`` and ``graph``: their launches in
   slice 7's runs; K1's, K2's and K3's ``faults``: in each run of slice
   18's faults phase; every kernel's gives ``serving``: its launches in
   each of slice 8's serving runs, ``durability``: in each of slice 9's
   restored runs, ``training``: per train step (K4's and K5's also
   their backward's time per call and per step), ``mesh``: in slice
   12's runs over the one-rank mesh, ``mesh_tp``: per rank in slice
   14's partitioned steps, ``mesh_tp_train`` and ``mesh_fsdp``: per rank
   in slices 15's and 16's, ``dryrun``: its calls in slice 13's
   traced prefill and train step, and ``adafactor``: per step in slice
   17's; K5's ``widths``: a row per (P, N)
   with its time, plain time and bound.

Exits non-zero, with no result line, when no card is present or when run
outside a checkout of the repository.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCHS, PAPER_CNNS, reduced  # noqa: E402
from repro_torch.core.im2col import (conv_out_shape, im2col,  # noqa: E402
                                     im2col_wave)
from repro_torch.core.pipeline import (EngineStage,  # noqa: E402
                                       ThreadedPipeline)
from repro_torch.core.synergy_mm import (SynergyTrace,  # noqa: E402
                                         synergy_matmul)
from repro_torch.engines import (CostModel, Engine,  # noqa: E402
                                 engine_scope, get_engine, list_engines)
from repro_torch.kernels.common import build as kernel_build  # noqa: E402
from repro_torch.kernels.common.build import sass_opcodes  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention_cuda, flash_attention_library,
    load_flash_attention)
from repro_torch.kernels.qmm import (load_qmm, qmm_library,  # noqa: E402
                                    qmm_matmul, qmm_ref)
from repro_torch.kernels.qmm.qmm import PATHS as QMM_PATHS  # noqa: E402
from repro_torch.kernels.ssd import (load_ssd, ssd, ssd_chunked,  # noqa: E402
                                     ssd_cuda)
from repro_torch.kernels.ssd.ops import _prescale  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_witness  # noqa: E402
from repro_torch.kernels.ssd.ssd import (SSD_HEAD_DIMS,  # noqa: E402
                                         load_ssd_witness)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.tiled_mm import (PATHS,  # noqa: E402
                                          ffma_chain_ref, load_tiled_mm,
                                          tiled_matmul, tiled_mm_library,
                                          tiled_mm_ref)
from repro_torch.kernels.vpu_mm import (load_vpu_mm,  # noqa: E402
                                        vpu_matmul, vpu_mm_library,
                                        vpu_mm_ref)
from repro_torch.models import (decode_fn, init_cache,  # noqa: E402
                                init_model, lm_forward, prefill_fn)
from repro_torch.models.cnn import (cnn_forward, conv_graph_steps,  # noqa: E402
                                    conv_jobsets, conv_wave_graph, init_cnn,
                                    maxpool2d)
from repro_torch.quant import (DEFAULT_TOL, one_shot_act_scale,  # noqa: E402
                               dequant_finish, quantize_activations,
                               quantize_weights, register_quantized, rel_err)
from repro_torch.core.serving import Request, SynergyServer  # noqa: E402
from repro_torch.soc import (CrashPlan, Durability,  # noqa: E402
                             FaultPlan, FaultSpec, GraphCancelled,
                             HealthPolicy, PanelRetryExhausted,
                             RequestJournal, RetryPolicy, SimulatedCrash,
                             SynergyRuntime, wrap_pool)
from repro_torch.core.job import JobSet  # noqa: E402
from repro_torch.obs.flightrec import FlightRecorder  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.data import prefetch, synthetic_batches  # noqa: E402
from repro_torch.engines import register_op_impl  # noqa: E402
from repro_torch.launch import (build_train_step,  # noqa: E402
                                loss_and_grads, make_train_state, train_loop)
from repro_torch.models import model_flops  # noqa: E402
from repro_torch.models.attention import flash_attention_torch  # noqa: E402
from repro_torch.optim import (AdafactorConfig, AdamWConfig,  # noqa: E402
                               adamw_init, cosine_lr)
from repro_torch.runtime import run_with_recovery  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import (gather_tree, make_test_mesh,  # noqa: E402
                                place_tree)
from repro_torch.launch.hlo_analysis import analyze_step  # noqa: E402
from repro_torch.launch.sharding import (axes_of,  # noqa: E402
                                         data_gather_of, gather_over,
                                         local_tree)
from repro_torch.launch.pipeline_mode import (  # noqa: E402
    build_pp_forward, split_stages)
from repro_torch.launch.serve import (build_decode_step,  # noqa: E402
                                      build_prefill_step)
from repro_torch.models.partition import (gather_for_use,  # noqa: E402
                                          use_data_gather)
from repro_torch.models.transformer import (_attn_block_fwd,  # noqa: E402
                                            _layer_slice, _scan_blocks)
from repro_torch.optim.compress import (dequantize_int8,  # noqa: E402
                                        init_error_feedback, quantize_int8)
from repro_torch.runtime import sync_pods_compressed  # noqa: E402

DEVICE = "cuda"

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32 on
#: the CUDA cores (no tensor cores, which is what the kernel uses) and HBM3
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAK_NOTE = "fp32 non-tensor 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)"

#: int8 dense on the tensor cores (data sheet): the card's least time for
#: int8 products, whatever K2 runs them on
INT8_PEAK_OPS = 1979e12
INT8_NOTE = "int8 dense 1,979 TOP/s, HBM 3.35 TB/s (H100 SXM data sheet)"

FRAMES = 256
OTHER_FRAMES = 64
RUNTIME_OTHER_FRAMES = 16
REPS = 25
#: the runtime's pool on the card: the two hand-written kernels
POOL = ["cuda-tiled", "neon-vpu"]
#: CIFAR_Alex+ GEMMs at 256 frames: (name, m, n, k, fused ReLU)
ALEX_GEMMS = [("conv0", 262144, 64, 75, True), ("conv2", 65536, 64, 1600, True),
              ("conv4", 16384, 128, 1600, True), ("fc6", 256, 128, 2048, True),
              ("fc7", 256, 10, 128, False)]
#: the runtime's row panels of those GEMMs (TS = 32): (m, n, k)
PANELS = [(32, n, k) for _, _, n, k, _ in ALEX_GEMMS]
RAGGED = [(70, 45, 33), (1, 257, 129), (130, 1, 31)]
#: the int8 pool of slice 3: K1's engine and its int8 twin, both on K2
QPOOL = ["cuda-tiled", "cuda-tiled-int8"]
#: conv0's k with fc7's n: ragged in k and in n at once (m, n, k)
QMM_EDGE = (130, 10, 75)
#: slice 6: the borders of K2's and K3's tiles (32-row panels, 16 x 8 and
#: 32 x 32 block tiles, k steps of 32 and 64), crossed (m, n, k)
EDGES = [(m, n, k) for m in (1, 31, 32, 33, 127, 129) for n in (1, 10, 63, 65)
         for k in (1, 31, 33, 75)]
LOGIT_TOL = 1e-4     # fp32 logits, five GEMMs summed in another order
#: slice 7: frames per pipeline micro-batch and per graph wave; the 256
#: frames make 8 of them
MICRO = 32
#: the pipeline phase's stages over CIFAR_Alex+'s layers [lo, hi), each
#: pinned to one kernel's engine: (name, lo, hi, engine)
PIPE_STAGES = [("conv0+pool1", 0, 2, "cuda-tiled"),
               ("conv2+pool3", 2, 4, "neon-vpu"),
               ("conv4+pool5+fc6+fc7", 4, 8, "cuda-tiled")]
#: slice 18: the faults phase's recovery knobs (a heartbeat of 1 s; the
#: stall timeout well above it, so the stall sweep never takes a dead
#: worker's panel before the monitor does), its wait for one future, and
#: the slowdown that must quarantine neon-vpu
FAULT_RETRY = {"max_attempts": 4, "heartbeat_timeout_s": 1.0,
               "monitor_interval_s": 0.05, "stall_timeout_s": 3.0}
FAULT_TIMEOUT = 120
SLOW_FACTOR = 50.0
SLOW_GEMM = (65536, 64, 1600)   # conv2's (m, n, k) at 256 frames
SLOW_GEMMS = 16                 # at most, until neon-vpu is quarantined
#: seconds a graph, a wave or a chained GEMM may take before the phase fails
GRAPH_TIMEOUT = 300
BF16_TOL = 3e-2

#: bf16 dense on the tensor cores (data sheet): the card's least time for
#: bf16 products, whatever K4 runs them on
BF16_PEAK_FLOPS = 989e12
BF16_NOTE = "bf16 dense 989 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)"

#: slice 4's main path: zamba2-2.7b at its published widths and depth, 4
#: requests of 1,024-token prompts, then 32 greedy decode steps from a cache
#: of max_len 1,057 (examples/serve_pipeline.py drives repro the same way)
LM_ARCH = "zamba2-2.7b"
LM_BATCH = 4
LM_PROMPT = 1024
LM_DECODE = 32
LM_MAX_LEN = LM_PROMPT + LM_DECODE + 1
LM_CHECK_TOKENS = 16
LM_REF_TOL = 3e-2      # prefill vs the same prefill with impl="ref"
LM_DECODE_TOL = 2e-3   # fp32 decode vs forward (tests/test_models.py:104)
#: K4 against its plain version: (label, B, Hq, Hkv, S, Sk, D, causal,
#: dtype); the first is the main path's call (zamba2's prefill, bf16)
FA_CASES = [
    ("zamba2 prefill", 4, 32, 32, 1024, 1024, 80, True, torch.bfloat16),
    ("zamba2 prefill", 4, 32, 32, 1024, 1024, 80, True, torch.float32),
    ("granite GQA 32/8", 2, 32, 8, 1024, 1024, 64, True, torch.bfloat16),
    ("phi3 GQA 40/10", 1, 40, 10, 1024, 1024, 128, True, torch.bfloat16),
    ("kimi GQA 64/8", 1, 64, 8, 1024, 1024, 112, True, torch.bfloat16),
    ("gemma D 256", 1, 16, 16, 1024, 1024, 256, True, torch.bfloat16),
    ("whisper encoder", 2, 12, 12, 1500, 1500, 64, False, torch.bfloat16),
    ("whisper cross", 2, 12, 12, 16, 1500, 64, False, torch.bfloat16),
    ("ragged S 200", 2, 32, 8, 200, 200, 64, True, torch.float32),
    ("reduced D 16", 2, 4, 4, 70, 70, 16, True, torch.bfloat16),
    ("reduced D 16", 2, 4, 4, 70, 70, 16, True, torch.float32),
]
#: K5 against its plain version: (label, B, L, H, P, N, chunk, dtype); the
#: first is the main path's call (zamba2's prefill hands K5 fp32: the conv
#: weights are fp32 and promote x, as in repro)
SSD_CASES = [
    ("zamba2 prefill", 4, 1024, 80, 64, 64, 128, torch.float32),
    ("zamba2 prefill", 4, 1024, 80, 64, 64, 128, torch.bfloat16),
    ("mamba2-130m", 4, 1024, 24, 64, 128, 128, torch.float32),
    ("mamba2-130m", 4, 1024, 24, 64, 128, 128, torch.bfloat16),
    ("L 1000, padded", 2, 1000, 80, 64, 64, 128, torch.float32),
    ("chunk 64", 2, 1024, 80, 64, 64, 64, torch.float32),
    ("reduced P 16 N 16", 2, 96, 8, 16, 16, 16, torch.float32),
]
#: slice 5: the reduced configs (configs/base.py::reduced) prefill on the
#: card through K4 and K5 at P = 16, N = 16, head dim 16, chunk 16, held
#: within REDUCED_TOL of the same prefill on the CPU: (arch, n_layers)
REDUCED_ARCHS = [("zamba2-2.7b", 4), ("mamba2-130m", 2)]
REDUCED_TOL = 1e-4
#: K1's bf16 GEMMs at zamba2's published widths, against the plain version
#: (m, n, k): the shared block's attention projections and MLP at 4 x 1,024
#: tokens, and one decode-step GEMM
LM_GEMMS = [(4096, 2560, 2560), (4096, 20480, 2560), (4096, 2560, 10240),
            (4, 2560, 10240)]
#: slice 8: the continuous-batching server on LM_ARCH at full width, its
#: default MNIST prefill CNN and SERVE_REQUESTS requests of SERVE_PROMPT
#: tokens and SERVE_NEW new tokens each; the chunked run replays
#: SERVE_CHUNK_TOKENS prompt tokens per quantum of a full wave, whose MAC
#: budget is SERVE_CHUNK_MACS (the server costs a replayed token
#: n_layers·4·d_model² per slot).  The dense real-FFN check runs
#: SERVE_DENSE (arch, n_layers), reduced, on the card and the CPU.
SERVE_SLOTS = 4
SERVE_MAX_LEN = 64
SERVE_REQUESTS = 8
SERVE_PROMPT = 16
SERVE_NEW = 8
SERVE_CHUNK_TOKENS = 4
SERVE_CHUNK_MACS = (SERVE_CHUNK_TOKENS * SERVE_SLOTS * ARCHS[LM_ARCH].n_layers
                    * 4 * ARCHS[LM_ARCH].d_model ** 2)
SERVE_TIMEOUT = 300
SERVE_DENSE = ("granite-3-2b", 2)
#: (run name, pool, server keywords), in the order they run; every run
#: must give each request the first run's tokens
SERVE_RUNS = [("wave, batched", POOL, {}),
              ("wave, per-slot", POOL, {"decode_mode": "per-slot"}),
              ("single admission", POOL, {"admission": "single"}),
              ("chunked prefill", POOL, {"prefill_chunk_macs": SERVE_CHUNK_MACS}),
              ("int8, batched", QPOOL, {}),
              ("int8, per-slot", QPOOL, {"decode_mode": "per-slot"})]
#: the (batched, per-slot) pairs whose decode-GEMM outputs must be bitwise
SERVE_BITWISE = [("wave, batched", "wave, per-slot"),
                 ("int8, batched", "int8, per-slot")]
#: slice 9, durable serving on the serving runs' server: snapshots every
#: DUR_SNAPSHOT_EVERY engine steps, the newest DUR_KEEP kept; the
#: CrashPlan fires at the start of engine step DUR_CRASH_AT (0-based): the
#: first wave was admitted at step 1 and has decoded since, the snapshot
#: after step 4 was taken, and SERVE_REQUESTS - SERVE_SLOTS requests are
#: still queued (the phase checks all three)
DUR_SNAPSHOT_EVERY = 4
DUR_KEEP = 2
DUR_CRASH_AT = 6
#: (serving run whose tokens a restored run must give, pool)
DUR_RUNS = [("wave, batched", POOL), ("int8, batched", QPOOL)]
#: the real kill: SERVE_DENSE on the card in a child process serving
#: DUR_KILL_REQUESTS requests of SERVE_PROMPT + DUR_KILL_NEW tokens,
#: SIGKILLed once its journal holds DUR_KILL_TOKEN_RECORDS token records
DUR_KILL_REQUESTS = 16
DUR_KILL_NEW = 24
DUR_KILL_TOKEN_RECORDS = 4
DUR_KILL_TIMEOUT = 300
#: the child: ``python3 -c KILL_CHILD <checkout> <directory>``
KILL_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "import chip_smoke; chip_smoke.kill_child(sys.argv[2])")
#: slice 10, the training path: LM_ARCH at its published widths and all 54
#: layers, param fp32, compute bf16, remat per scanned block, AdamW with
#: repro's defaults, 2 x 1,024-token batches from synthetic_batches(seed=0)
#: through prefetch (examples/train_lm.py drives repro the same way)
TRAIN_CELL = ShapeCell("train", 1024, 2, "train")
TRAIN_STEPS = 3
#: fp32 gradients, kernels (impl="auto") vs the plain formulations:
#: ||a - b|| / ||b|| per leaf, the tolerance the fp32 prefill is held to
TRAIN_GRAD_TOL = 3e-2
#: K4's and K5's backward (their Functions) against autograd of their
#: plain versions on the same inputs: the training path's calls (zamba2's
#: shared block, bf16; its SSD layers, fp32 as the conv promotes them) and
#: the reduced configs' shapes.  K4: (label, B, Hq, Hkv, S, Sk, D, causal,
#: dtype); K5: (label, B, L, H, P, N, chunk, dtype)
BWD_FA_CASES = [
    ("zamba2 training", 2, 32, 32, 1024, 1024, 80, True, torch.bfloat16),
    ("zamba2 training", 2, 32, 32, 1024, 1024, 80, True, torch.float32),
    ("reduced D 16", 2, 4, 4, 64, 64, 16, True, torch.float32),
    ("reduced D 16", 2, 4, 4, 64, 64, 16, True, torch.bfloat16),
]
BWD_SSD_CASES = [
    ("zamba2 training", 2, 1024, 80, 64, 64, 128, torch.float32),
    ("zamba2 training", 2, 1024, 80, 64, 64, 128, torch.bfloat16),
    ("reduced P 16 N 16", 2, 64, 8, 16, 16, 16, torch.float32),
]
#: the reduced LM_ARCH (fp32) trained on the card and on the CPU from one
#: state made on the CPU; and resumed after a failure at TRAIN_FAIL_AT
TRAIN_REDUCED_LAYERS = 4
TRAIN_REDUCED_CELL = ShapeCell("train", 64, 2, "train")
TRAIN_REDUCED_TOL = 1e-4
TRAIN_RESUME_STEPS = 4
TRAIN_CKPT_EVERY = 2
TRAIN_FAIL_AT = 3

#: slice 12, ``mesh``: the launchers over a mesh of ONE rank (one NCCL rank
#: on the card), held bitwise to the unsharded functions.  A mesh of one
#: rank shows the mesh path's bits and its cost, and measures nothing
#: about scaling.
MESH_NOTE = ("a mesh of one rank: the mesh path's bits and its overhead "
             "over the unsharded step; it measures nothing about scaling")
MESH_DECODE = 8
MESH_MAX_LEN = 64
MESH_TRAIN_STEPS = 2
MESH_REPS = 3
PP_ARCH, PP_LAYERS, PP_MICRO, PP_TOKENS = "granite-3-2b", 4, 4, 1024

#: slice 14: K5 at a rank's share of P.  Each (label, B, L, H, N, chunk)
#: is the shape one state size N is held at (zamba2's and mamba2-130m's
#: prefills, the reduced configs'), at every P of SSD_HEAD_DIMS
SSD_WIDTH_SHAPES = [("zamba2 prefill", 4, 1024, 80, 64, 128),
                    ("mamba2-130m prefill", 4, 1024, 24, 128, 128),
                    ("reduced", 2, 96, 8, 16, 16)]
#: slice 14, ``mesh_tp``: the serving steps partitioned over a 'model' axis
#: of TP_MODEL gloo ranks sharing the card (NCCL refuses two ranks on one
#: device), each a process of its own with TP_TIMEOUT seconds; zamba2-2.7b
#: at full width and TP_LAYERS of its 54 layers in fp32 (the depth cut to
#: leave room for ``mesh_fsdp`` in the time limit), held to the unsharded
#: steps within
#: TP_TOL of the logits' scale, decoding at the LM phase's depth (a cache
#: of LM_MAX_LEN, from position LM_PROMPT); the one-layer bf16 check at
#: BF16_TOL
TP_MODEL = 2
TP_LAYERS = 18
TP_DECODE = 8
TP_TOL = 1e-4
TP_REPS = 2
TP_TIMEOUT = 600
TP_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.mesh_tp_rank(int(sys.argv[2]), sys.argv[3])")

#: slice 15, ``mesh_tp_train``: the train step partitioned over a 'model'
#: axis of TP_MODEL gloo ranks sharing the card (each a process of its own
#: with TP_TIMEOUT seconds), zamba2-2.7b at full width and TP_LAYERS of its
#: 54 layers in fp32,
#: MESH_TRAIN_STEPS AdamW steps of TRAIN_CELL from seed 0, held to the
#: unsharded steps: the loss within TPT_LOSS_TOL and the grad norm within
#: TPT_NORM_TOL (relative), the moments within TPT_STATE_TOL of each
#: leaf's largest entry, the parameters within AdamW's own bound
#: (:func:`adamw_step_bound`); see :func:`phase_mesh_tp_train`
TPT_LOSS_TOL = 1e-4
TPT_NORM_TOL = 1e-3
TPT_STATE_TOL = 1e-3
TPT_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
             "chip_smoke.mesh_tp_train_rank(int(sys.argv[2]), sys.argv[3])")

#: slice 16, ``mesh_fsdp``: FSDP gathered layer by layer, by TP_MODEL gloo
#: ranks sharing the card on a (data TP_MODEL, model 1) mesh (each a
#: process of its own, TP_TIMEOUT seconds): LM_ARCH with ``fsdp=True``
#: trained at all 54 layers as ``mesh_tp_train`` trains it (one sequence a
#: rank) and served as ``mesh_tp`` serves it at FSDP_SERVE_LAYERS layers
#: (two rows a rank), and FSDP_MOE_ARCH's decode at published widths cut to
#: FSDP_MOE_LAYERS layers, bf16 parameters computed in fp32, FSDP_MOE_BATCH
#: rows, FSDP_MOE_DECODE steps from position FSDP_MOE_POS of a seeded
#: cache of FSDP_MOE_MAX_LEN: the MoE gathers its input's rows.  Every
#: step gathers its parameters anew over gloo (~0.8 GB/s on one card),
#: which sets the serving depths and the MoE's steps
FSDP_SERVE_LAYERS = 12
FSDP_MOE_ARCH, FSDP_MOE_LAYERS, FSDP_MOE_DECODE = "dbrx-132b", 2, 3
FSDP_MOE_BATCH, FSDP_MOE_POS, FSDP_MOE_MAX_LEN = 4, 32, 64
FSDP_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
              "chip_smoke.mesh_fsdp_rank(int(sys.argv[2]), sys.argv[3])")

#: slice 17, ``adafactor``: ADA_ARCH (MoE, Adafactor) at ADA_WIDTHS cut to
#: ADA_LAYERS layers of ADA_EXPERTS experts, fp32, ADA_STEPS train steps of
#: ADA_CELL from one state made on the CPU, on the card and on the CPU:
#: every stacked leaf (ADA_LAYERS slices) updated slice by slice
ADA_ARCH, ADA_LAYERS, ADA_EXPERTS, ADA_STEPS = "kimi-k2-1t-a32b", 3, 8, 2
ADA_WIDTHS = {"d_model": 1024, "n_heads": 16, "d_ff": 1024, "vocab": 8192}
ADA_CELL = ShapeCell("train", 256, 2, "train")

#: slice 13, ``dryrun``: the production cell traced in subprocesses, and
#: the tolerance of the traced train-step peak against the card's
DRYRUN_SHAPE = "train_4k"
DRYRUN_TIMEOUT = 600
DRYRUN_PEAK_TOL = 0.10


#: K1's and K3's plain versions sum in float64 and round once to fp32, so a
#: row's bits do not depend on m on the CPU; their plain_ms is a float64
#: GEMM's time on the card, slower than an fp32-summing plain version's
PLAIN_F64_NOTE = ("plain_ms: tiled_mm_ref / vpu_mm_ref sum in float64 and "
                  "round once to fp32; not comparable with fp32-summed "
                  "plain times")


def fp32_tol(k: int) -> float:
    """fp32 kernel vs plain: 1e-5 (the reference's own tolerance) scaled by
    sqrt(k), since the two sum k products in different orders."""
    return 1e-5 * max(1.0, math.sqrt(k))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(m: int, n: int, k: int, itemsize: int = 4) -> tuple[float, str]:
    """Least time in ms for act(A @ B + bias): each input read once and
    the output written once at the HBM rate, or the FMAs at the fp32 peak,
    whichever is larger."""
    t_ops = 2.0 * m * n * k / FP32_PEAK_FLOPS
    t_bytes = (itemsize * (m * k + k * n + m * n) + 4 * n) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> float:
    """Phase 3: the kernel against its plain version.  Returns the largest
    abs error over the main path's own GEMMs (fp32, their epilogues)."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    acts = {"none": None, "relu": torch.relu, "silu": F.silu}
    main_err = 0.0
    shapes = [(m, n, k) for _, m, n, k, _ in ALEX_GEMMS] + RAGGED
    for m, n, k in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(m, k, device=DEVICE, generator=g).to(dtype)
            b = torch.randn(k, n, device=DEVICE, generator=g).to(dtype)
            bias = torch.randn(n, device=DEVICE, generator=g)
            tol = fp32_tol(k) if dtype == torch.float32 else BF16_TOL
            for act_name, act in acts.items():
                y = tiled_matmul(a, b, bias=bias, activation=act)
                r = tiled_mm_ref(a, b, bias=bias, activation=act)
                torch.cuda.synchronize()
                if y.dtype != dtype or y.shape != (m, n):
                    raise AssertionError(f"{m}x{n}x{k} {dtype}: got "
                                         f"{y.dtype} {tuple(y.shape)}")
                torch.testing.assert_close(
                    y.float(), r.float(), rtol=tol, atol=tol,
                    msg=lambda s: f"{m}x{n}x{k} {dtype} {act_name}: {s}")
                err = (y.float() - r.float()).abs().max().item()
                main_gemm = (m, n, k) in {(gm, gn, gk)
                                          for _, gm, gn, gk, _ in ALEX_GEMMS}
                if main_gemm and dtype == torch.float32:
                    main_err = max(main_err, err)
    # bf16 in, fp32 out; an activation the kernel does not fuse
    a = torch.randn(70, 33, device=DEVICE, generator=g).to(torch.bfloat16)
    b = torch.randn(33, 45, device=DEVICE, generator=g).to(torch.bfloat16)
    y = tiled_matmul(a, b, out_dtype=torch.float32)
    torch.testing.assert_close(y, tiled_mm_ref(a, b, out_dtype=torch.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    a, b = a.float(), b.float()
    torch.testing.assert_close(tiled_matmul(a, b, activation=torch.tanh),
                               tiled_mm_ref(a, b, activation=torch.tanh),
                               rtol=fp32_tol(33), atol=fp32_tol(33))
    # a row panel computed alone gives the same bits as the whole GEMM
    _, m, n, k, _ = ALEX_GEMMS[1]
    a = torch.randn(m, k, device=DEVICE, generator=g)
    b = torch.randn(k, n, device=DEVICE, generator=g)
    whole = tiled_matmul(a, b)
    panel = tiled_matmul(a[1000:3003].contiguous(), b)
    torch.cuda.synchronize()
    if not torch.equal(whole[1000:3003], panel):
        raise AssertionError("row panel differs from the whole GEMM")
    print(f"kernels: {len(shapes) * 6 + 3} cases agree with the plain "
          f"version (fp32 tol 1e-5*sqrt(k), bf16 tol {BF16_TOL}); "
          f"row panel bitwise equal", flush=True)
    return main_err


def phase_k1_bf16() -> None:
    """Phase 3, slice 5: K1's bf16 paths.  The LM GEMMs of zamba2
    (LM_GEMMS) and the ragged shapes against the plain version within
    BF16_TOL for every fused epilogue, each on the path its (n, k) picks:
    wgmma when n % 8 == 0 and k % 8 == 0, else mma, as the per-path launch
    counts must show.  On both paths a row panel, and m = 1 against m = 4,
    gives the whole GEMM's bits, and a view off a 16-byte boundary (which
    the wrapper copies for TMA) gives the aligned tensor's bits."""
    g = torch.Generator(device=DEVICE).manual_seed(15)
    acts = {"none": None, "relu": torch.relu, "silu": F.silu}
    cases = 0
    for m, n, k in LM_GEMMS + RAGGED:
        a = torch.randn(m, k, device=DEVICE, generator=g).to(torch.bfloat16)
        b = torch.randn(k, n, device=DEVICE, generator=g).to(torch.bfloat16)
        bias = torch.randn(n, device=DEVICE, generator=g)
        path = "wgmma" if n % 8 == 0 and k % 8 == 0 else "mma"
        before = dict(tiled_matmul.launches_by_path)
        for act_name, act in acts.items():
            y = tiled_matmul(a, b, bias=bias, activation=act)
            r = tiled_mm_ref(a, b, bias=bias, activation=act)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                y.float(), r.float(), rtol=BF16_TOL, atol=BF16_TOL,
                msg=lambda s: f"bf16 {m}x{n}x{k} {act_name}: {s}")
            cases += 1
        ran = {p: c - before[p] for p, c in tiled_matmul.launches_by_path.items()}
        if ran != {p: len(acts) * (p == path) for p in PATHS}:
            raise AssertionError(f"bf16 {m}x{n}x{k}: launches by path {ran}, "
                                 f"expected all {len(acts)} on {path}")
    for m, n, k in ((1000, 256, 320), (300, 45, 33)):
        a = torch.randn(m, k, device=DEVICE, generator=g).to(torch.bfloat16)
        b = torch.randn(k, n, device=DEVICE, generator=g).to(torch.bfloat16)
        bias = torch.randn(n, device=DEVICE, generator=g)
        whole = tiled_matmul(a, b, bias=bias, activation=torch.relu)
        for lo, hi in ((0, 1), (0, 4), (3, 67), (m // 2, m)):
            panel = tiled_matmul(a[lo:hi].contiguous(), b, bias=bias,
                                 activation=torch.relu)
            if not torch.equal(panel, whole[lo:hi]):
                raise AssertionError(f"bf16 {m}x{n}x{k}: rows {lo}:{hi} "
                                     f"alone differ from the whole GEMM")
        flat = torch.empty(m * k + 3, device=DEVICE, dtype=torch.bfloat16)
        view = flat[3:].view(m, k)
        view.copy_(a)
        if not torch.equal(tiled_matmul(view, b, bias=bias,
                                         activation=torch.relu), whole):
            raise AssertionError(f"bf16 {m}x{n}x{k}: an unaligned view of A "
                                 f"differs from A")
    print(f"tiled_mm bf16: {cases} cases agree with the plain version (tol "
          f"{BF16_TOL}), each on its path (wgmma for n, k % 8 == 0, else "
          f"mma); row panels, m = 1 vs m = 4 and an unaligned view bitwise "
          f"the whole GEMM on both paths", flush=True)


def phase_vpu_kernel() -> float:
    """Phase 3, K3: ``vpu_mm`` against its plain version at the runtime's
    panel shapes, the whole Alex+ GEMMs and the ragged shapes, and bitwise
    against ``tiled_mm`` for every fp32 case.  Returns the largest abs
    error over the main path's shapes (fp32, panels and whole GEMMs)."""
    g = torch.Generator(device=DEVICE).manual_seed(2)
    acts = {"none": None, "relu": torch.relu, "silu": F.silu}
    main_shapes = set(PANELS) | {(m, n, k) for _, m, n, k, _ in ALEX_GEMMS}
    shapes = (PANELS + [(m, n, k) for _, m, n, k, _ in ALEX_GEMMS] + RAGGED
              + EDGES)
    main_err, bitwise, bf16_bitwise = 0.0, 0, 0
    for m, n, k in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(m, k, device=DEVICE, generator=g).to(dtype)
            b = torch.randn(k, n, device=DEVICE, generator=g).to(dtype)
            bias = torch.randn(n, device=DEVICE, generator=g)
            tol = fp32_tol(k) if dtype == torch.float32 else BF16_TOL
            for act_name, act in acts.items():
                y = vpu_matmul(a, b, bias=bias, activation=act)
                r = vpu_mm_ref(a, b, bias=bias, activation=act)
                y1 = tiled_matmul(a, b, bias=bias, activation=act)
                torch.cuda.synchronize()
                if y.dtype != dtype or y.shape != (m, n):
                    raise AssertionError(f"vpu_mm {m}x{n}x{k} {dtype}: got "
                                         f"{y.dtype} {tuple(y.shape)}")
                torch.testing.assert_close(
                    y.float(), r.float(), rtol=tol, atol=tol,
                    msg=lambda s: f"vpu_mm {m}x{n}x{k} {dtype} "
                                  f"{act_name}: {s}")
                same = torch.equal(y, y1)
                if dtype == torch.float32:
                    if not same:
                        raise AssertionError(
                            f"vpu_mm {m}x{n}x{k} {act_name}: not bitwise "
                            f"equal to tiled_mm, max |diff| "
                            f"{(y - y1).abs().max().item():.3g}")
                    bitwise += 1
                    if (m, n, k) in main_shapes:
                        main_err = max(main_err,
                                       (y - r).abs().max().item())
                else:
                    bf16_bitwise += int(same)
    a = torch.randn(70, 33, device=DEVICE, generator=g).to(torch.bfloat16)
    b = torch.randn(33, 45, device=DEVICE, generator=g).to(torch.bfloat16)
    torch.testing.assert_close(vpu_matmul(a, b, out_dtype=torch.float32),
                               vpu_mm_ref(a, b, out_dtype=torch.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    a, b = a.float(), b.float()
    torch.testing.assert_close(vpu_matmul(a, b, activation=torch.tanh),
                               vpu_mm_ref(a, b, activation=torch.tanh),
                               rtol=fp32_tol(33), atol=fp32_tol(33))
    # row panels of a k = 75 GEMM, one of them off every 16-byte boundary
    a = torch.randn(4096, 75, device=DEVICE, generator=g)
    b = torch.randn(75, 64, device=DEVICE, generator=g)
    whole = vpu_matmul(a, b, activation=torch.relu)
    for lo, hi in ((32, 64), (33, 66), (4095, 4096)):
        panel = a[lo:hi]
        if not torch.equal(vpu_matmul(panel, b, activation=torch.relu),
                           whole[lo:hi]):
            raise AssertionError(f"vpu_mm: rows {lo}:{hi} of a k = 75 GEMM "
                                 f"(base at byte {panel.data_ptr() % 16} "
                                 f"mod 16) differ from the whole GEMM")
    n_cases = len(shapes) * 6 + 2
    print(f"vpu_mm: {n_cases} cases agree with the plain version (fp32 tol "
          f"1e-5*sqrt(k), bf16 tol {BF16_TOL}), {len(EDGES)} of them tile "
          f"borders; {bitwise} fp32 cases bitwise equal to tiled_mm "
          f"({bf16_bitwise} of {len(shapes) * 3} bf16 cases too); unaligned "
          f"row panels bitwise the whole GEMM", flush=True)
    return main_err


def phase_fmaf_witness() -> None:
    """Phase 3: K1's ``ffma`` path and K3 hold the bits of one fmaf per k
    in increasing k, as ``ffma_chain_ref`` emulates them on the CPU, at
    the main path's fp32 shapes (the five Alex+ GEMMs on rows at their
    first and last tiles' borders, and their 32-row panels).  The two
    kernels share their mainloop, so only this witness, which depends on
    no CUDA source, would see a change of its order."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    shapes = [(m, n, k) for _, m, n, k, _ in ALEX_GEMMS] + PANELS
    before = dict(tiled_matmul.launches_by_path)
    for m, n, k in shapes:
        a = torch.randn(m, k, device=DEVICE, generator=g)
        b = torch.randn(k, n, device=DEVICE, generator=g)
        bias = torch.randn(n, device=DEVICE, generator=g)
        rows = sorted({*range(min(m, 40)), *range(max(0, m - 40), m)})
        want = ffma_chain_ref(a[rows], b, bias=bias, activation=torch.relu)
        for kernel in (tiled_matmul, vpu_matmul):
            got = kernel(a, b, bias=bias, activation=torch.relu)[rows].cpu()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{kernel.__name__} {m}x{n}x{k}: not the bits of the "
                    f"host fmaf chain, max |diff| "
                    f"{(got - want).abs().max().item():.3g}")
    ran = {p: c - before[p] for p, c in tiled_matmul.launches_by_path.items()}
    if ran["ffma"] != len(shapes):
        raise AssertionError(f"fp32 GEMMs took K1's paths {ran}")
    print(f"ffma witness: K1 (ffma path) and K3 bitwise the host fmaf chain "
          f"at {len(shapes)} main-path shapes", flush=True)


def phase_sass() -> None:
    """Phase 3: what the built libraries run.  K3 runs CUDA-core FMAs and
    no tensor-core instruction (HMMA, HGMMA, IMMA, ...: any *MMA opcode);
    K1 (slice 5) holds HGMMA (its wgmma path), HMMA (its mma path) and
    FFMA (its fp32 path); K4 holds HMMA (its bf16 path); K2 (slice 6)
    holds IMMA (int8 on the tensor cores) and no IDP (``__dp4a``)."""
    ops = sass_opcodes(vpu_mm_library())
    mma = sorted(op for op in ops if "MMA" in op)
    if mma:
        raise AssertionError(f"vpu_mm SASS holds tensor-core ops {mma}")
    if ops["FFMA"] == 0:
        raise AssertionError(f"vpu_mm SASS holds no FFMA: {dict(ops)}")
    print(f"vpu_mm SASS: {sum(ops.values())} instructions, {ops['FFMA']} "
          f"FFMA, no *MMA opcode; opcodes {sorted(ops)}", flush=True)
    for name, library, want in (
            ("tiled_mm", tiled_mm_library(), ("HGMMA", "HMMA", "FFMA")),
            ("flash_attention", flash_attention_library(), ("HMMA",)),
            ("qmm", qmm_library(), ("IMMA",))):
        ops = sass_opcodes(library)
        missing = [op for op in want if ops[op] == 0]
        if missing:
            raise AssertionError(f"{name} SASS holds no {missing}: "
                                 f"{sorted(ops)}")
        if name == "qmm" and ops["IDP"]:
            raise AssertionError(f"qmm SASS holds {ops['IDP']} IDP (dp4a)")
        print(f"{name} SASS: " + ", ".join(f"{ops[op]} {op}" for op in want)
              + (", no IDP" if name == "qmm" else ""), flush=True)


def rand_int8(g: torch.Generator, *shape: int) -> torch.Tensor:
    """Uniform int8 on the card, -128 included."""
    return torch.randint(-128, 128, shape, device=DEVICE, generator=g,
                         dtype=torch.int8)


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units in the last place of want, in want's
    type (float32 or bfloat16)."""
    bits = 23 if want.dtype == torch.float32 else 7
    _, e = torch.frexp(want.float().abs())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                      (e - 1 - bits).clamp_min(-126 - bits))
    return float(((got.float() - want.float()).abs() / ulp).max())


def phase_qmm_kernel() -> float:
    """Phase 3, K2: ``qmm`` against its plain version at the five Alex+
    GEMMs whole, their 32-row panels, the ragged shapes and conv0's k with
    fc7's n: the raw int32 accumulator BITWISE; the fused epilogue (fp32
    and bf16 out, none/relu/silu) bitwise for none and relu, within 2 ulp
    for silu.  Then one build serves four activation scales.  Returns the
    largest abs error over the main path's modes (raw, and fp32 with
    none/relu) at its shapes."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    acts = {"none": None, "relu": torch.relu, "silu": F.silu}
    main_shapes = set(PANELS) | {(m, n, k) for _, m, n, k, _ in ALEX_GEMMS}
    shapes = ([(m, n, k) for _, m, n, k, _ in ALEX_GEMMS] + PANELS + RAGGED
              + [QMM_EDGE] + EDGES)
    main_err, silu_ulps, cases = 0.0, 0.0, 0
    for m, n, k in shapes:
        a, w = rand_int8(g, m, k), rand_int8(g, k, n)
        w_scale = torch.rand(1, n, device=DEVICE, generator=g) * 1e-3
        bias = torch.randn(n, device=DEVICE, generator=g)
        acc = qmm_matmul(a, w, w_scale, fuse_dequant=False)
        want = qmm_ref(a, w, w_scale, fuse_dequant=False)
        torch.cuda.synchronize()
        if acc.dtype != torch.int32 or not torch.equal(acc, want):
            raise AssertionError(f"qmm {m}x{n}x{k} raw: not bitwise equal to "
                                 f"the plain version")
        cases += 1
        act_scale = 0.02
        scale = w_scale * act_scale        # folded as the wrapper folds it
        for dtype in (torch.float32, torch.bfloat16):
            for act_name, act in acts.items():
                y = qmm_matmul(a, w, w_scale, act_scale=act_scale, bias=bias,
                               activation=act, out_dtype=dtype)
                r = qmm_ref(a, w, scale, bias=bias, activation=act,
                            out_dtype=dtype)
                torch.cuda.synchronize()
                if y.dtype != dtype or y.shape != (m, n):
                    raise AssertionError(f"qmm {m}x{n}x{k} {dtype}: got "
                                         f"{y.dtype} {tuple(y.shape)}")
                if act is F.silu:
                    u = ulps(y, r)
                    if u > 2:
                        raise AssertionError(f"qmm {m}x{n}x{k} {dtype} silu: "
                                             f"{u} ulp from the plain version")
                    silu_ulps = max(silu_ulps, u)
                else:
                    if not torch.equal(y, r):
                        d = (y.float() - r.float()).abs().max().item()
                        raise AssertionError(
                            f"qmm {m}x{n}x{k} {dtype} {act_name}: not bitwise "
                            f"equal, max |diff| {d:.3g}")
                    if (m, n, k) in main_shapes and dtype == torch.float32:
                        main_err = max(main_err, (y - r).abs().max().item())
                cases += 1
    # every operand at -128 or 127, at the borders of both tiles and paths
    for m, n, k in ((33, 65, 75), (129, 64, 1600), (1, 10, 31)):
        for va, vw in ((-128, -128), (-128, 127), (127, -128), (127, 127)):
            a = torch.full((m, k), va, dtype=torch.int8, device=DEVICE)
            w = torch.full((k, n), vw, dtype=torch.int8, device=DEVICE)
            acc = qmm_matmul(a, w, torch.ones(n, device=DEVICE),
                             fuse_dequant=False)
            if not (torch.equal(acc, qmm_ref(a, w, torch.ones(n, device=DEVICE),
                                             fuse_dequant=False))
                    and bool((acc == va * vw * k).all())):
                raise AssertionError(f"qmm {m}x{n}x{k} at {va} x {vw}: not "
                                     f"the exact sum {va * vw * k}")
            cases += 1
    # row panels of a k = 75 GEMM (the runtime's conv0 panels), one of them
    # off every 16-byte boundary, and a W view off its boundary
    a, w = rand_int8(g, 4096, 75), rand_int8(g, 75, 64)
    w_scale = torch.rand(64, device=DEVICE, generator=g)
    whole = qmm_matmul(a, w, w_scale, fuse_dequant=False)
    for lo, hi in ((32, 64), (33, 66), (4095, 4096)):
        panel = a[lo:hi]
        if not torch.equal(qmm_matmul(panel, w, w_scale, fuse_dequant=False),
                           whole[lo:hi]):
            raise AssertionError(f"qmm: rows {lo}:{hi} of a k = 75 GEMM "
                                 f"(base at byte {panel.data_ptr() % 16} "
                                 f"mod 16) differ from the whole GEMM")
        cases += 1
    w_view = torch.empty(75 * 64 + 5, dtype=torch.int8, device=DEVICE)[5:]
    w_view = w_view.view(75, 64)
    w_view.copy_(w)
    if not torch.equal(qmm_matmul(a, w_view, w_scale, fuse_dequant=False),
                       whole):
        raise AssertionError("qmm: a W view off its 16-byte boundary differs")
    cases += 1
    # scales are operands: four activation scales, one library
    m, n, k = QMM_EDGE
    a, w = rand_int8(g, m, k), rand_int8(g, k, n)
    w_scale = torch.rand(1, n, device=DEVICE, generator=g)
    lib = kernel_build._libs["qmm"]
    built = sorted(kernel_build._BUILD_DIR.glob("qmm-*.so"))
    for s in (0.011, 0.012, 0.013, 0.014):
        y = qmm_matmul(a, w, w_scale, act_scale=s, activation=torch.relu)
        if not torch.equal(y, qmm_ref(a, w, w_scale * s,
                                      activation=torch.relu)):
            raise AssertionError(f"qmm at act_scale {s}: not bitwise equal")
    if (kernel_build._libs["qmm"] is not lib
            or sorted(kernel_build._BUILD_DIR.glob("qmm-*.so")) != built):
        raise AssertionError("a new activation scale rebuilt qmm")
    print(f"qmm: {cases} cases against the plain version ({len(EDGES)} "
          f"shapes at tile borders, -128/127 operands, unaligned row panels "
          f"and W): raw int32 and fused none/relu (fp32, bf16) bitwise, "
          f"fused silu within {silu_ulps:.3g} ulp (limit 2); launches by "
          f"path {qmm_matmul.launches_by_path}; one build served 4 "
          f"activation scales ({built[0].name})", flush=True)
    return main_err


class CaptureEngine(Engine):
    """Runs K1 and keeps each GEMM's operands: the main path's patch
    panels and weights, for the quantization checks."""

    def __init__(self):
        super().__init__("capture", {"gemm", "epilogue"},
                         cost=CostModel(1e12))
        self.operands: list[tuple[torch.Tensor, torch.Tensor]] = []

    def execute(self, a, b, *, bias=None, activation=None, tile=None,
                out_dtype=None):
        self.operands.append((a, b))
        return tiled_matmul(a, b, bias=bias, activation=activation,
                            out_dtype=out_dtype)


def phase_quantization(card: str, main: tuple) -> None:
    """Phase 3, K2's operands: ``quantize_weights`` and
    ``quantize_activations`` on the card BITWISE equal to the same calls on
    the CPU, over the five Alex+ weights and patch panels of phase 4's fp32
    forward; and the quantization pass's time per GEMM (max|a| and
    quantize, CUDA events) beside its bound (A read twice, int8 written)."""
    cfg, params, x, *_ = main
    cap = CaptureEngine()
    cnn_forward(cfg, params, x, engine=cap, device=DEVICE)
    torch.cuda.synchronize()
    for (name, m, n, k, _), (a, b) in zip(ALEX_GEMMS, cap.operands):
        if tuple(a.shape) != (m, k) or tuple(b.shape) != (k, n):
            raise AssertionError(f"{name}: captured {tuple(a.shape)} @ "
                                 f"{tuple(b.shape)}")
        a_cpu, b_cpu = a.cpu(), b.cpu()
        qw, qw_cpu = quantize_weights(b), quantize_weights(b_cpu)
        s, s_cpu = one_shot_act_scale(a), one_shot_act_scale(a_cpu)
        a_q = quantize_activations(a, s)
        if not (torch.equal(qw.q.cpu(), qw_cpu.q)
                and torch.equal(qw.scale.cpu(), qw_cpu.scale)):
            raise AssertionError(f"{name}: quantize_weights on the card "
                                 f"differs from the CPU")
        if s != s_cpu or not torch.equal(
                a_q.cpu(), quantize_activations(a_cpu, s_cpu)):
            raise AssertionError(f"{name}: quantize_activations on the card "
                                 f"differs from the CPU")
        emit({"quantize": f"{cfg.name}/{name}", "m": m, "k": k, "n": n,
              "amax_ms": median_ms(lambda: a.abs().amax()),
              "quantize_ms": median_ms(lambda: quantize_activations(a, s)),
              "weights_ms": median_ms(lambda: quantize_weights(b)),
              "bound_ms": 1e3 * 9 * m * k / HBM_BYTES_PER_S,
              "bound": "A read twice (fp32), A_q written (int8), at HBM rate",
              "card": card})
    print(f"quantization: weights and activations of the {len(ALEX_GEMMS)} "
          f"{cfg.name} GEMMs bitwise equal on the card and the CPU",
          flush=True)


def phase_main_path() -> tuple:
    """Phase 4: the CNN forward through the dispatcher onto the kernel."""
    cfg = PAPER_CNNS["CIFAR_Alex+"]
    g = torch.Generator().manual_seed(0)
    params = init_cnn(cfg, g, device=DEVICE)
    x = torch.randn(FRAMES, cfg.input_hw, cfg.input_hw, cfg.cin, generator=g)

    tr = SynergyTrace()
    reset_launches()
    for e in list_engines():
        e.telemetry.reset()
    with tr.activate():
        logits = cnn_forward(cfg, params, x, device=DEVICE)
    torch.cuda.synchronize()
    launches, k3_launches = tiled_matmul.launches, vpu_matmul.launches
    if qmm_matmul.launches != 0:
        raise AssertionError(f"qmm launched {qmm_matmul.launches} times in "
                             f"the fp32 dispatcher forward")
    torch_gemms = get_engine("torch").telemetry.gemms

    if launches != len(ALEX_GEMMS):
        raise AssertionError(f"tiled_mm launched {launches} times in the "
                             f"forward, expected {len(ALEX_GEMMS)}")
    if tiled_matmul.launches_by_path["ffma"] != launches:
        raise AssertionError(f"tiled_mm launches by path "
                             f"{tiled_matmul.launches_by_path} in the fp32 "
                             f"forward, expected all on ffma")
    if k3_launches != 0:
        raise AssertionError(f"vpu_mm launched {k3_launches} times in the "
                             f"dispatcher forward, expected 0")
    if torch_gemms != 0:
        raise AssertionError(f"torch engine ran {torch_gemms} GEMMs")
    got = [(js.m, js.n, js.k) for js in tr.jobsets]
    want = [(m, n, k) for _, m, n, k, _ in ALEX_GEMMS]
    if got != want:
        raise AssertionError(f"trace jobsets {got} != {want}")
    if set(tr.engine_stats) != {"cuda-tiled"}:
        raise AssertionError(f"GEMMs went to {sorted(tr.engine_stats)}")
    ref = cnn_forward(cfg, params, x, engine="reference", device=DEVICE)
    if logits.shape != (FRAMES, cfg.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    torch.testing.assert_close(logits, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    err = (logits - ref).abs().max().item()
    print(f"main path (dispatcher): {cfg.name} x{FRAMES} frames, tiled_mm "
          f"launches {launches}, vpu_mm launches {k3_launches}, "
          f"torch-engine GEMMs {torch_gemms}, "
          f"{len(tr.jobsets)} jobsets, logits max |err| vs reference "
          f"{err:.3g} (tol {LOGIT_TOL})", flush=True)

    for name, other in sorted(PAPER_CNNS.items()):
        if name == cfg.name:
            continue
        p = init_cnn(other, g, device=DEVICE)
        xo = torch.randn(OTHER_FRAMES, other.input_hw, other.input_hw,
                         other.cin, generator=g)
        n_gemm = sum(1 for s in other.layers if s[0] in ("conv", "fc"))
        before = tiled_matmul.launches
        y = cnn_forward(other, p, xo, device=DEVICE)
        yr = cnn_forward(other, p, xo, engine="reference", device=DEVICE)
        torch.cuda.synchronize()
        if tiled_matmul.launches - before != n_gemm:
            raise AssertionError(f"{name}: {tiled_matmul.launches - before}"
                                 f" launches, expected {n_gemm}")
        torch.testing.assert_close(y, yr, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        print(f"  {name} x{OTHER_FRAMES}: {n_gemm} launches, max |err| "
              f"{(y - yr).abs().max().item():.3g}", flush=True)
    return cfg, params, x, {"tiled_mm": launches,
                            "vpu_mm": k3_launches}, logits


def phase_runtime_path(main: tuple) -> dict:
    """Phase 4, slice 2: the forward through the work-stealing runtime over
    both kernels, bitwise against the dispatcher forward of phase 4."""
    cfg, params, x, _, logits = main
    tr = SynergyTrace()
    with SynergyRuntime(POOL, name="cnn", device=DEVICE) as rt:
        for e in list_engines():
            e.telemetry.reset()
        rt.reset_stats()
        reset_launches()
        with tr.activate():
            got = cnn_forward(cfg, params, x, runtime=rt, device=DEVICE)
        torch.cuda.synchronize()
        k1, k3 = tiled_matmul.launches, vpu_matmul.launches
        stats = rt.stats()
    if qmm_matmul.launches != 0:
        raise AssertionError(f"qmm launched {qmm_matmul.launches} times in "
                             f"the fp32 runtime forward")
    panels = sum(js.grid[0] for js in tr.jobsets)
    # panels each engine ran, per GEMM (a panel is one row of tile jobs)
    panels_by = {(js.m, js.n, js.k): {e: jobs // js.grid[1]
                                      for e, jobs in shares.items()}
                 for js, shares in tr.runtime_shares}
    ran = {e: sum(p.get(e, 0) for p in panels_by.values()) for e in POOL}
    per = stats["engines"]
    if set(per) != set(POOL):
        raise AssertionError(f"runtime pool {sorted(per)} != {POOL}")
    if not torch.equal(got, logits):
        raise AssertionError(
            f"runtime logits differ from the dispatcher forward: max |diff| "
            f"{(got - logits).abs().max().item():.3g}")
    if k1 == 0 or k3 == 0:
        raise AssertionError(f"a kernel ran no panel: tiled_mm {k1}, "
                             f"vpu_mm {k3}")
    if k1 + k3 != panels:
        raise AssertionError(f"launches {k1} + {k3} != {panels} panels")
    if ran != {"cuda-tiled": k1, "neon-vpu": k3}:
        raise AssertionError(f"runtime accounting {ran} != launches "
                             f"tiled_mm {k1}, vpu_mm {k3}")
    if stats["total_jobs"] != tr.num_jobs or stats["submissions"] != len(
            ALEX_GEMMS):
        raise AssertionError(f"runtime booked {stats['total_jobs']} tile "
                             f"jobs in {stats['submissions']} submissions, "
                             f"expected {tr.num_jobs} in {len(ALEX_GEMMS)}")
    others = {e.name: e.telemetry.jobs for e in list_engines()
              if e.name not in POOL and e.telemetry.jobs}
    if others or set(tr.engine_stats) - set(POOL):
        raise AssertionError(f"engines outside the pool ran work: {others} "
                             f"{sorted(tr.engine_stats)}")
    print(f"main path (runtime): {cfg.name} x{FRAMES} frames through "
          f"SynergyRuntime({POOL}): {panels} panels = tiled_mm {k1} + "
          f"vpu_mm {k3} launches, {stats['total_steals']} steals, logits "
          f"bitwise equal to the dispatcher forward", flush=True)
    for name in POOL:
        p = per[name]
        print(f"  {name}: {p['jobs']} tile jobs, {p['steals']} steals, "
              f"wall_busy_s {p['wall_busy_s']:.4f}, idle_s "
              f"{p['idle_s']:.4f}", flush=True)

    g = torch.Generator().manual_seed(3)
    with SynergyRuntime(POOL, name="others", device=DEVICE) as rt:
        for name, other in sorted(PAPER_CNNS.items()):
            if name == cfg.name:
                continue
            p = init_cnn(other, g, device=DEVICE)
            xo = torch.randn(RUNTIME_OTHER_FRAMES, other.input_hw,
                             other.input_hw, other.cin, generator=g)
            want = cnn_forward(other, p, xo, device=DEVICE)
            before = (tiled_matmul.launches, vpu_matmul.launches)
            y = cnn_forward(other, p, xo, runtime=rt, device=DEVICE)
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"{name}: runtime logits differ from "
                                     f"the dispatcher forward")
            print(f"  {name} x{RUNTIME_OTHER_FRAMES}: bitwise equal, "
                  f"tiled_mm {tiled_matmul.launches - before[0]} + vpu_mm "
                  f"{vpu_matmul.launches - before[1]} panels", flush=True)
    return {"panels": panels, "tiled_mm": k1, "vpu_mm": k3,
            "panels_by": panels_by, "steals": stats["total_steals"],
            "engines": {n: {k: per[n][k] for k in ("jobs", "steals",
                                                   "wall_busy_s", "idle_s")}
                        for n in POOL}}


def reset_launches() -> None:
    tiled_matmul.launches = 0
    tiled_matmul.launches_by_path.update(dict.fromkeys(PATHS, 0))
    vpu_matmul.launches = 0
    qmm_matmul.launches = 0
    qmm_matmul.launches_by_path.update(dict.fromkeys(QMM_PATHS, 0))
    flash_attention_cuda.launches = 0
    ssd_cuda.launches = 0


#: the CNN paths launch neither of the LM slice's kernels
NO_LM_KERNELS = {"flash_attention": 0, "ssd": 0}


def launch_counts() -> dict:
    return {"tiled_mm": tiled_matmul.launches, "vpu_mm": vpu_matmul.launches,
            "qmm": qmm_matmul.launches,
            "flash_attention": flash_attention_cuda.launches,
            "ssd": ssd_cuda.launches}


def qmm_paths_of(calls: list) -> dict:
    """K2's launches by path for ``(n, k, launches)`` with operands on
    16-byte boundaries, as every main-path operand (and row panel of a GEMM
    with k % 16 == 0) is: ``async`` for k and n multiples of 16, else
    ``shift``."""
    paths = dict.fromkeys(QMM_PATHS, 0)
    for n, k, count in calls:
        paths["async" if n % 16 == 0 and k % 16 == 0 else "shift"] += count
    return paths


def phase_decode_paths(main: tuple) -> dict:
    """Phase 4, slice 3: int8 inference of CIFAR_Alex+ x256 on K2.

    ``register_quantized("cuda-tiled")`` calibrates ``cuda-tiled-int8`` on
    the card.  The dispatcher decode forward must launch K2 once per GEMM
    and K1/K3 never, within ``rel_err`` DEFAULT_TOL of phase 4's fp32
    logits.  From the same calibrator state, the runtime decode forward
    over ``QPOOL`` must launch K2 once per panel (both workers, with
    steals) and K1/K3 never, be BITWISE equal to the same forward on a
    one-worker int8 pool, and come within DEFAULT_TOL of the dispatcher
    decode forward (the fused epilogue rounds once, the merge per step;
    a last-bit difference can move an int8 value of the next layer).  An
    fp32 forward through the same mixed pool launches K2 never and is
    bitwise phase 4's dispatcher forward.  The other six CNNs run both
    decode paths at 16 frames."""
    cfg, params, x, _, logits = main
    eng = register_quantized("cuda-tiled", device=DEVICE)
    rep = eng.calibration
    rows = [{k: r[k] for k in ("m", "k", "n", "rel_err")} for r in rep.rows]
    print(f"calibration: {rep}; rows {rows}; measured "
          f"{rep.measured_macs_per_s:.4g} MAC/s", flush=True)
    state0 = eng.calibrator.export_state()

    tr = SynergyTrace()
    reset_launches()
    with tr.activate():
        q_logits = cnn_forward(cfg, params, x, job_class="decode",
                               device=DEVICE)
    torch.cuda.synchronize()
    disp = launch_counts()
    disp_paths = dict(qmm_matmul.launches_by_path)
    if disp != {**NO_LM_KERNELS, "tiled_mm": 0, "vpu_mm": 0,
                 "qmm": len(ALEX_GEMMS)}:
        raise AssertionError(f"dispatcher decode forward launched {disp}")
    want_paths = qmm_paths_of([(n, k, 1) for _, _, n, k, _ in ALEX_GEMMS])
    if disp_paths != want_paths:
        raise AssertionError(f"dispatcher decode forward: qmm launches by "
                             f"path {disp_paths}, expected {want_paths}")
    if set(tr.engine_stats) != {"cuda-tiled-int8"}:
        raise AssertionError(f"decode GEMMs went to {sorted(tr.engine_stats)}")
    if q_logits.shape != logits.shape or not bool(
            torch.isfinite(q_logits).all()):
        raise AssertionError(f"decode logits {tuple(q_logits.shape)}, finite "
                             f"{bool(torch.isfinite(q_logits).all())}")
    disp_err = rel_err(q_logits, logits)
    if disp_err > DEFAULT_TOL:
        raise AssertionError(f"decode logits rel_err {disp_err:.4g} vs fp32 "
                             f"> {DEFAULT_TOL}")
    print(f"main path (dispatcher, int8): {cfg.name} x{FRAMES}, launches "
          f"{disp}, qmm by path {disp_paths}, logits rel_err vs fp32 "
          f"{disp_err:.4g} (tol {DEFAULT_TOL})", flush=True)

    eng.calibrator.import_state(state0)
    tr = SynergyTrace()
    with SynergyRuntime(QPOOL, name="int8", device=DEVICE) as rt:
        for e in list_engines():
            e.telemetry.reset()
        rt.reset_stats()
        reset_launches()
        with tr.activate():
            got = cnn_forward(cfg, params, x, runtime=rt, job_class="decode",
                              device=DEVICE)
        torch.cuda.synchronize()
        run = launch_counts()
        run_paths = dict(qmm_matmul.launches_by_path)
        stats = rt.stats()
    panels_per_gemm = [js.grid[0] for js in tr.jobsets]
    want_paths = qmm_paths_of([(js.n, js.k, js.grid[0]) for js in tr.jobsets])
    if run_paths != want_paths:
        raise AssertionError(f"runtime decode forward: qmm launches by path "
                             f"{run_paths}, expected {want_paths}")
    panels = sum(panels_per_gemm)
    per = stats["engines"]
    if run != {**NO_LM_KERNELS, "tiled_mm": 0, "vpu_mm": 0,
                "qmm": panels}:
        raise AssertionError(f"runtime decode forward launched {run}, "
                             f"{panels} panels")
    if min(per[e]["jobs"] for e in QPOOL) == 0 or stats["total_steals"] == 0:
        raise AssertionError(f"a worker ran no panel or nothing was stolen: "
                             f"{ {e: per[e]['jobs'] for e in QPOOL} }, "
                             f"{stats['total_steals']} steals")
    rt_err = rel_err(got, q_logits)
    if rt_err > DEFAULT_TOL:
        raise AssertionError(f"runtime decode logits rel_err {rt_err:.4g} vs "
                             f"the dispatcher decode forward")
    eng.calibrator.import_state(state0)
    with SynergyRuntime(QPOOL[1:], name="int8-one", device=DEVICE) as rt:
        one = cnn_forward(cfg, params, x, runtime=rt, job_class="decode",
                          device=DEVICE)
    torch.cuda.synchronize()
    if not torch.equal(got, one):
        raise AssertionError(
            f"runtime decode logits differ from the one-worker pool's: max "
            f"|diff| {(got - one).abs().max().item():.3g}")
    print(f"main path (runtime, int8): {cfg.name} x{FRAMES} through "
          f"SynergyRuntime({QPOOL}): {panels} panels = qmm {run['qmm']} "
          f"launches (by path {run_paths}; tiled_mm {run['tiled_mm']}, "
          f"vpu_mm {run['vpu_mm']}), "
          f"{stats['total_steals']} steals, logits bitwise equal to the "
          f"one-worker int8 pool, rel_err vs the dispatcher decode forward "
          f"{rt_err:.4g} (tol {DEFAULT_TOL})", flush=True)
    for name in QPOOL:
        p = per[name]
        print(f"  {name}: {p['jobs']} tile jobs, {p['steals']} steals, "
              f"wall_busy_s {p['wall_busy_s']:.4f}, idle_s "
              f"{p['idle_s']:.4f}", flush=True)

    tr = SynergyTrace()
    reset_launches()
    with SynergyRuntime(QPOOL, name="int8-fp32", device=DEVICE) as rt, \
            tr.activate():
        fp = cnn_forward(cfg, params, x, runtime=rt, device=DEVICE)
    torch.cuda.synchronize()
    fp_run = launch_counts()
    if fp_run != {**NO_LM_KERNELS, "tiled_mm": panels, "vpu_mm": 0,
                   "qmm": 0}:
        raise AssertionError(f"fp32 forward through the int8 pool launched "
                             f"{fp_run}, {panels} panels")
    if not torch.equal(fp, logits):
        raise AssertionError("fp32 forward through the int8 pool differs "
                             "from the dispatcher forward")
    print(f"  fp32 through the same pool: launches {fp_run}, logits bitwise "
          f"equal to the dispatcher forward", flush=True)

    g = torch.Generator().manual_seed(6)
    with SynergyRuntime(QPOOL, name="int8-others", device=DEVICE) as rt:
        for name, other in sorted(PAPER_CNNS.items()):
            if name == cfg.name:
                continue
            p = init_cnn(other, g, device=DEVICE)
            xo = torch.randn(RUNTIME_OTHER_FRAMES, other.input_hw,
                             other.input_hw, other.cin, generator=g)
            want = cnn_forward(other, p, xo, device=DEVICE)
            n_gemm = sum(1 for sp in other.layers if sp[0] in ("conv", "fc"))
            eng.calibrator.import_state(state0)
            before = qmm_matmul.launches
            yd = cnn_forward(other, p, xo, job_class="decode", device=DEVICE)
            torch.cuda.synchronize()
            if qmm_matmul.launches - before != n_gemm:
                raise AssertionError(f"{name}: dispatcher decode launched "
                                     f"qmm {qmm_matmul.launches - before}")
            eng.calibrator.import_state(state0)
            tr_o = SynergyTrace()
            before = qmm_matmul.launches
            with tr_o.activate():
                yr = cnn_forward(other, p, xo, runtime=rt, job_class="decode",
                                 device=DEVICE)
            torch.cuda.synchronize()
            n_panels = sum(js.grid[0] for js in tr_o.jobsets)
            if qmm_matmul.launches - before != n_panels:
                raise AssertionError(f"{name}: runtime decode launched qmm "
                                     f"{qmm_matmul.launches - before}, "
                                     f"{n_panels} panels")
            errs = (rel_err(yd, want), rel_err(yr, want), rel_err(yr, yd))
            if max(errs) > DEFAULT_TOL:
                raise AssertionError(f"{name}: decode rel_err {errs}")
            print(f"  {name} x{RUNTIME_OTHER_FRAMES}: qmm {n_gemm} + "
                  f"{n_panels} launches; rel_err dispatcher/runtime vs fp32 "
                  f"{errs[0]:.4g} / {errs[1]:.4g}, runtime vs dispatcher "
                  f"{errs[2]:.4g}", flush=True)
    eng.calibrator.import_state(state0)
    return {"dispatcher": disp, "runtime": run, "panels": panels,
            "dispatcher_paths": disp_paths, "runtime_paths": run_paths,
            "panels_per_gemm": panels_per_gemm, "disp_err": disp_err,
            "rt_err": rt_err, "steals": stats["total_steals"],
            "engines": {n: {k: per[n][k] for k in ("jobs", "steals",
                                                   "wall_busy_s", "idle_s")}
                        for n in QPOOL},
            "state0": state0, "runtime_logits": got}


def phase_times(card: str, main: tuple) -> tuple[dict, float]:
    """Phase 5: per-GEMM times beside the bound, and frames/s.  Returns
    the K1 totals over one forward's GEMMs and the dispatcher forward's
    seconds."""
    cfg, params, x, *_ = main
    g = torch.Generator(device=DEVICE).manual_seed(1)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "by_ops_ms": 0.0, "by_bytes_ms": 0.0}
    for name, m, n, k, relu in ALEX_GEMMS:
        a = torch.randn(m, k, device=DEVICE, generator=g)
        b = torch.randn(k, n, device=DEVICE, generator=g)
        bias = torch.randn(n, device=DEVICE, generator=g)
        act = torch.relu if relu else None

        def library():
            y = torch.addmm(bias, a, b)
            return torch.relu_(y) if relu else y

        ms = median_ms(lambda: tiled_matmul(a, b, bias=bias, activation=act))
        plain_ms = median_ms(lambda: tiled_mm_ref(a, b, bias=bias,
                                                  activation=act))
        library_ms = median_ms(library)
        bound_ms, bound_by = bound(m, n, k)
        emit({"gemm": f"{cfg.name}/{name}", "m": m, "n": n, "k": k,
              "kernel": "tiled_mm", "ms": ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "peak": PEAK_NOTE, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "torch.addmm + relu_",
              "tflops": 2e-9 * m * n * k / ms, "card": card})
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += library_ms
        totals["bound_ms"] += bound_ms
        totals["by_ops_ms" if bound_by == "operations"
               else "by_bytes_ms"] += bound_ms

    im2col_ms = 0.0
    for spec, h, w, c in cfg.trace_shapes()[0]:
        if spec[0] == "conv":
            _, _, kk, stride, pad = spec
            xi = torch.randn(FRAMES, h, w, c, device=DEVICE, generator=g)
            im2col_ms += median_ms(lambda: im2col(xi, kk, kk, stride, pad))

    def forward(engine=None):
        cnn_forward(cfg, params, x, engine=engine, device=DEVICE)

    fwd = {}
    for engine in (None, "reference"):
        for _ in range(3):
            forward(engine)
        samples = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(engine)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        fwd[engine or "auto"] = statistics.median(samples)
    emit({"forward": cfg.name, "frames": FRAMES,
          "frames_per_s": FRAMES / fwd["auto"], "ms": 1e3 * fwd["auto"],
          "tiled_mm_ms": totals["ms"], "im2col_ms": im2col_ms,
          "reference_pinned_frames_per_s": FRAMES / fwd["reference"],
          "timer": "host clock around synchronize, median of 20",
          "card": card})
    return totals, fwd["auto"]


def gemm_times(kernel, plain, m: int, n: int, k: int, relu: bool,
               g: torch.Generator) -> dict:
    """One GEMM shape: the kernel, its plain version and torch.addmm +
    ReLU (CUDA events, median of REPS), beside the bound."""
    a = torch.randn(m, k, device=DEVICE, generator=g)
    b = torch.randn(k, n, device=DEVICE, generator=g)
    bias = torch.randn(n, device=DEVICE, generator=g)
    act = torch.relu if relu else None

    def library():
        y = torch.addmm(bias, a, b)
        return torch.relu_(y) if relu else y

    bound_ms, bound_by = bound(m, n, k)
    return {"m": m, "n": n, "k": k,
            "ms": median_ms(lambda: kernel(a, b, bias=bias, activation=act)),
            "plain_ms": median_ms(lambda: plain(a, b, bias=bias,
                                                activation=act)),
            "library_ms": median_ms(library), "bound_ms": bound_ms,
            "bound_by": bound_by}


def add_times(totals: dict, t: dict, times: int = 1) -> None:
    """Add ``times`` calls of one timed shape to per-forward totals."""
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        totals[key] += times * t[key]
    totals["by_ops_ms" if t["bound_by"] == "operations"
           else "by_bytes_ms"] += times * t["bound_ms"]


def new_totals() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "by_ops_ms": 0.0, "by_bytes_ms": 0.0}


def phase_panel_times(card: str, run: dict) -> tuple[dict, dict]:
    """Phase 5, slice 2: both kernels at the runtime's panel shapes.  The
    per-forward totals weight each panel's times by the panels that kernel
    ran of that GEMM in phase 4's runtime forward.  Also ``vpu_mm`` per
    whole Alex+ GEMM, kept apart as a comparison with ``tiled_mm``'s
    whole GEMMs (the runtime never runs a whole GEMM)."""
    g = torch.Generator(device=DEVICE).manual_seed(4)
    kernels = {"tiled_mm": (tiled_matmul, tiled_mm_ref, "cuda-tiled"),
               "vpu_mm": (vpu_matmul, vpu_mm_ref, "neon-vpu")}
    runtime = {name: new_totals() for name in kernels}
    for (name, m, n, k, relu), panel in zip(ALEX_GEMMS, PANELS):
        shares = run["panels_by"][(m, n, k)]
        for kname, (kernel, plain, engine) in kernels.items():
            t = gemm_times(kernel, plain, *panel, relu, g)
            ran = shares.get(engine, 0)
            add_times(runtime[kname], t, ran)
            emit({"panel": f"CIFAR_Alex+/{name}", **t, "kernel": kname,
                  "panels_run": ran, "peak": PEAK_NOTE,
                  "library": "torch.addmm + relu_", "card": card})
    whole = new_totals()
    for name, m, n, k, relu in ALEX_GEMMS:
        t = gemm_times(vpu_matmul, vpu_mm_ref, m, n, k, relu, g)
        emit({"gemm": f"CIFAR_Alex+/{name}", **t, "kernel": "vpu_mm",
              "peak": PEAK_NOTE, "library": "torch.addmm + relu_",
              "tflops": 2e-9 * m * n * k / t["ms"], "card": card})
        add_times(whole, t)
    return runtime, whole


def runtime_forwards(cfg, params, x, pool: list, reps: int,
                     name: str = "timed", job_class: str | None = None
                     ) -> dict:
    """The runtime forward over ``pool``: host clock around synchronize,
    median of ``reps`` after 1 warm-up, whose trace gives the panels."""
    tr = SynergyTrace()
    with SynergyRuntime(pool, name=name, device=DEVICE) as rt:
        with tr.activate():
            cnn_forward(cfg, params, x, runtime=rt, job_class=job_class,
                        device=DEVICE)
        rt.reset_stats()
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cnn_forward(cfg, params, x, runtime=rt, job_class=job_class,
                        device=DEVICE)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        stats = rt.stats()
    wall = statistics.median(samples)
    panels = sum(js.grid[0] for js in tr.jobsets)
    return {"pool": pool, "frames": len(x), "frames_per_s": len(x) / wall,
            "ms": 1e3 * wall, "panels": panels,
            "host_us_per_panel": 1e6 * wall / panels,
            "steals_per_forward": stats["total_steals"] / reps,
            "engines": {n: {k: stats["engines"][n][k] / reps
                            for k in ("jobs", "steals", "wall_busy_s",
                                      "idle_s")} for n in pool},
            "timer": f"host clock around synchronize, median of {reps} "
                     f"after 1 warm-up; engines: means over the {reps}"}


def phase_runtime_times(card: str, main: tuple, run: dict,
                        dispatcher_s: float) -> dict:
    """Phase 5, slice 2: frames/s of the runtime forward (median of 5
    after 1 warm-up) beside the dispatcher forward of this run, and the
    host cost per panel."""
    cfg, params, x, *_ = main
    t = runtime_forwards(cfg, params, x, POOL, reps=5)
    if t["panels"] != run["panels"]:
        raise AssertionError(f"timed forward ran {t['panels']} panels, "
                             f"phase 4 {run['panels']}")
    emit({"forward": cfg.name, "path": "runtime", **t,
          "dispatcher_frames_per_s": FRAMES / dispatcher_s, "card": card})
    return t


def qmm_bound(m: int, n: int, k: int, fused: bool) -> tuple[float, str]:
    """Least time in ms for K2: int8 A and W read once, the 4-byte output
    (fp32 or int32) written once, plus scale and bias when fused, at the
    HBM rate; or the products at the int8 tensor-core peak."""
    t_ops = 2.0 * m * n * k / INT8_PEAK_OPS
    t_bytes = (m * k + k * n + 4 * m * n + (8 * n if fused else 0)
               ) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def qmm_times(m: int, n: int, k: int, relu: bool, fused: bool,
              g: torch.Generator) -> dict:
    """One K2 shape: the kernel, its plain version and ``torch._int_mm`` on
    operands zero-padded to multiples of 8 (its requirement; padded before
    timing) plus the epilogue as torch ops, beside the bound.  ``fused``
    is the dispatcher's mode (fp32 out, bias, ReLU unless the last layer);
    otherwise the runtime's raw int32 panel."""
    a, w = rand_int8(g, m, k), rand_int8(g, k, n)
    w_scale = torch.rand(1, n, device=DEVICE, generator=g) * 1e-3
    bias = torch.randn(n, device=DEVICE, generator=g)
    act = torch.relu if relu else None
    scale = w_scale * 0.02
    kp, np8 = -(-k // 8) * 8, -(-n // 8) * 8
    a_p = torch.zeros(m, kp, dtype=torch.int8, device=DEVICE)
    w_p = torch.zeros(kp, np8, dtype=torch.int8, device=DEVICE)
    a_p[:, :k], w_p[:k, :n] = a, w
    if fused:
        def kernel():
            return qmm_matmul(a, w, w_scale, act_scale=0.02, bias=bias,
                              activation=act)

        def plain():
            return qmm_ref(a, w, scale, bias=bias, activation=act)

        def library():
            y = torch.addcmul(bias, torch._int_mm(a_p, w_p)[:, :n].float(),
                              scale)
            return torch.relu_(y) if relu else y
    else:
        def kernel():
            return qmm_matmul(a, w, w_scale, fuse_dequant=False)

        def plain():
            return qmm_ref(a, w, w_scale, fuse_dequant=False)

        def library():
            return torch._int_mm(a_p, w_p)
    bound_ms, bound_by = qmm_bound(m, n, k, fused)
    return {"m": m, "n": n, "k": k, "mode": "fused" if fused else "raw",
            "ms": median_ms(kernel), "plain_ms": median_ms(plain),
            "library_ms": median_ms(library), "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_qmm_times(card: str, decode: dict) -> tuple[dict, dict]:
    """Phase 5, slice 3: K2 per whole Alex+ GEMM in the dispatcher's fused
    mode (the dispatcher decode forward runs exactly these), and per 32-row
    panel in the runtime's raw mode, weighted by the panels of each GEMM in
    phase 4's runtime decode forward (every panel runs on K2, whichever
    worker took it)."""
    g = torch.Generator(device=DEVICE).manual_seed(7)
    dispatcher, runtime = new_totals(), new_totals()
    lib = "torch._int_mm (operands zero-padded to 8) + torch epilogue"
    for (name, m, n, k, relu), panel, ran in zip(
            ALEX_GEMMS, PANELS, decode["panels_per_gemm"]):
        t = qmm_times(m, n, k, relu, True, g)
        add_times(dispatcher, t)
        emit({"gemm": f"CIFAR_Alex+/{name}", **t, "kernel": "qmm",
              "peak": INT8_NOTE, "library": lib,
              "tops": 2e-9 * m * n * k / t["ms"], "card": card})
        t = qmm_times(*panel, relu, False, g)
        add_times(runtime, t, ran)
        emit({"panel": f"CIFAR_Alex+/{name}", **t, "kernel": "qmm",
              "panels_run": ran, "peak": INT8_NOTE, "library": lib,
              "card": card})
    return dispatcher, runtime


def phase_decode_times(card: str, main: tuple, decode: dict,
                       dispatcher_s: float, runtime_fp32: dict) -> None:
    """Phase 5, slice 3: frames/s of both decode forwards beside both fp32
    forwards of this call, and the runtime decode forward's host cost per
    panel.  The calibrator keeps folding batches in while they run."""
    cfg, params, x, *_ = main
    for _ in range(3):
        cnn_forward(cfg, params, x, job_class="decode", device=DEVICE)
    samples = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cnn_forward(cfg, params, x, job_class="decode", device=DEVICE)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    wall = statistics.median(samples)
    emit({"forward": cfg.name, "path": "dispatcher", "job_class": "decode",
          "frames": FRAMES, "frames_per_s": FRAMES / wall, "ms": 1e3 * wall,
          "fp32_frames_per_s": FRAMES / dispatcher_s,
          "timer": "host clock around synchronize, median of 20",
          "card": card})
    t = runtime_forwards(cfg, params, x, QPOOL, reps=5, name="int8-timed",
                         job_class="decode")
    if t["panels"] != decode["panels"]:
        raise AssertionError(f"timed decode forward ran {t['panels']} "
                             f"panels, phase 4 {decode['panels']}")
    emit({"forward": cfg.name, "path": "runtime", "job_class": "decode", **t,
          "fp32_runtime_frames_per_s": runtime_fp32["frames_per_s"],
          "fp32_runtime_pool": runtime_fp32["pool"],
          "fp32_dispatcher_frames_per_s": FRAMES / dispatcher_s,
          "card": card})


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def kernel_name(event: str) -> str:
    """The port's kernel a profiler event belongs to, or "other": its
    device functions are ``<name>_kernel`` or, for a kernel with several
    paths, ``<name>_<path>_kernel``."""
    for name in ("tiled_mm", "vpu_mm", "qmm", "flash_attention", "ssd"):
        if re.search(rf"\b{name}_(?:[a-z0-9]+_)?kernel\b", event):
            return name
    return "other"


def phase_runtime_profile(card: str, main: tuple, pool: list = POOL,
                          job_class: str | None = None,
                          label: str = "two-kernel pool") -> dict:
    """Phase 5: one runtime forward (after a warm-up one) under
    ``torch.profiler``: each kernel's device time and launches, and the
    share of the wall time in which at least one kernel ran on the card.
    Returns ``{kernel: {"count", "device_ms"}}``."""
    cfg, params, x, *_ = main
    with SynergyRuntime(pool, name="profiled", device=DEVICE) as rt:
        cnn_forward(cfg, params, x, runtime=rt, job_class=job_class,
                    device=DEVICE)
        torch.cuda.synchronize()
        kernels, busy_ms, wall = profiled_run(
            lambda: cnn_forward(cfg, params, x, runtime=rt,
                                job_class=job_class, device=DEVICE))
    emit({"profile": f"one runtime forward, {label}",
          "wall_ms_under_profiler": 1e3 * wall, "kernels": kernels,
          "device_busy_ms": busy_ms,
          "device_busy_share": None if busy_ms is None
          else busy_ms / (1e3 * wall), "card": card})
    return kernels


def profiled_run(fn) -> tuple[dict, float | None, float]:
    """``fn()`` once under ``torch.profiler``, ended by a synchronize:
    ``({kernel: {"count", "device_ms"}}, ms in which at least one kernel
    ran on the card or None, wall seconds)``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, intervals = {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = kernel_name(ev.name)
        k = kernels.setdefault(name, {"count": 0, "device_ms": 0.0})
        k["count"] += 1
        k["device_ms"] += (ev.time_range.end - ev.time_range.start) / 1e3
        intervals.append((ev.time_range.start, ev.time_range.end))
    busy_ms = union_us(intervals) / 1e3 if intervals else None
    return kernels, busy_ms, wall


def cnn_stage(cfg, params: dict, lo: int, hi: int):
    """Layers [lo, hi) of ``cfg`` as one stage function, from the port's
    public pieces: im2col + ``synergy_matmul`` for CONV and FC layers,
    ``maxpool2d`` for pooling, in ``cnn_forward``'s order and with its
    tile, so a stage pinned to K1 or K3 gives the dispatcher's bits."""
    shapes, _ = cfg.trace_shapes()
    last_fc = max(i for i, (spec, *_) in enumerate(shapes)
                  if spec[0] == "fc")

    def stage(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            for i in range(lo, hi):
                spec, h, w, _ = shapes[i]
                n = x.shape[0]
                if spec[0] == "conv":
                    _, cout, k, s, p = spec
                    oh, ow = conv_out_shape(h, w, k, k, s, p)
                    a = im2col(x, k, k, s, p).reshape(n * oh * ow, -1)
                    x = synergy_matmul(
                        a, params[f"conv{i}_w"].reshape(-1, cout),
                        bias=params[f"conv{i}_b"], activation=torch.relu,
                        tile=cfg.tile, name=f"{cfg.name}/conv{i}"
                    ).reshape(n, oh, ow, cout)
                elif spec[0] == "pool":
                    x = maxpool2d(x, spec[1])
                else:
                    x = synergy_matmul(
                        x.reshape(n, -1), params[f"fc{i}_w"],
                        bias=params[f"fc{i}_b"],
                        activation=None if i == last_fc else torch.relu,
                        tile=cfg.tile, name=f"{cfg.name}/fc{i}")
        return x
    return stage


def pipeline_stages(cfg, params: dict, split=PIPE_STAGES) -> list:
    """The pipeline phase's stages: ``EngineStage``s over ``split``."""
    return [EngineStage(name, cnn_stage(cfg, params, lo, hi), engine)
            for name, lo, hi, engine in split]


def conv_front(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The dispatcher's conv front-end (every layer up to the last conv
    before the first FC, through ``cnn_stage``) as the flat ``(m, cout)``
    output of that conv: what a wave graph's last node holds."""
    last, *_, (_, _, cout) = conv_graph_steps(cfg)[-1]
    return cnn_stage(cfg, params, 0, last + 1)(x).reshape(-1, cout)


def graph_waves(rt, cfg, params: dict, waves: list, name: str = "wave"
                ) -> list:
    """Submit every wave's conv front-end as a dataflow graph
    (``conv_wave_graph``), all in flight at once; returns the futures."""
    steps = conv_graph_steps(cfg)
    futs = []
    for w, xw in enumerate(waves):
        jss = [js for _, js in conv_jobsets(cfg, len(xw),
                                            name_prefix=f"{name}{w}/")]
        nodes, edges = conv_wave_graph(cfg, params, xw, steps, jss, len(xw))
        futs.append(rt.submit_graph(nodes, edges, name=f"{name}{w}"))
    return futs


def chain_waves(rt, cfg, params: dict, waves: list) -> list:
    """The same conv front-ends as a chain (``paper_figs.py::run_chain``):
    one wave at a time, gather, ``submit_gemm``, ``result()`` after every
    layer.  Returns each wave's flat last conv output."""
    steps = conv_graph_steps(cfg)
    outs = []
    for w, x in enumerate(waves):
        n = len(x)
        jss = conv_jobsets(cfg, n, name_prefix=f"chain{w}/")
        for (i, pools, (k, s, p), (oh, ow, cout)), (_, js) in zip(steps,
                                                                  jss):
            for size in pools:
                x = maxpool2d(x, size)
            y = rt.submit_gemm(
                im2col_wave(x, k, k, s, p),
                params[f"conv{i}_w"].reshape(-1, cout), jobset=js,
                bias=params[f"conv{i}_b"], activation=torch.relu,
                tile=(js.ts_m, js.ts_n, js.ts_k), job_class="prefill"
            ).result(GRAPH_TIMEOUT)
            x = y.reshape(n, oh, ow, cout)
        outs.append(y)
    return outs


def host_timed(fn, reps: int) -> tuple[list, list]:
    """``fn()`` once to warm up, then ``reps`` times, each between two
    synchronizes on the host clock: (seconds, results)."""
    fn()
    samples, results = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(fn())
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return samples, results


def pipe_launches(cfg, split=PIPE_STAGES) -> dict:
    """Launches of K1 and K3 per micro-batch through ``split``: one per
    CONV or FC layer of each stage, on its engine's kernel."""
    kernel = {"cuda-tiled": "tiled_mm", "neon-vpu": "vpu_mm"}
    out = {"tiled_mm": 0, "vpu_mm": 0}
    for _, lo, hi, engine in split:
        out[kernel[engine]] += sum(1 for spec in cfg.layers[lo:hi]
                                   if spec[0] in ("conv", "fc"))
    return out


def phase_pipeline(card: str, main: tuple, dispatcher_s: float,
                   runtime_fp32: dict) -> dict:
    """Slice 7: CIFAR_Alex+ x256 as 8 micro-batches of 32 frames through a
    ``ThreadedPipeline`` of three stages pinned to K1, K3 and K1, counts
    set to 0 just before and read just after; the logits must be BITWISE
    the dispatcher forward's.  Then frames/s (median of 5 after 1) beside
    the dispatcher's and the runtime's of this call, with the stages'
    utilisation."""
    cfg, params, x, _, logits = main
    frames = list(x.to(DEVICE).split(MICRO))
    reset_launches()
    outs, _ = ThreadedPipeline(pipeline_stages(cfg, params)).run(frames)
    torch.cuda.synchronize()
    counts = launch_counts()
    got = torch.cat(outs)
    if not torch.equal(got, logits):
        raise AssertionError(
            f"pipeline logits differ from the dispatcher forward: max "
            f"|diff| {(got - logits).abs().max().item():.3g}")
    want = {k: len(frames) * v for k, v in pipe_launches(cfg).items()}
    if {k: counts[k] for k in want} != want or counts["qmm"] != 0:
        raise AssertionError(f"pipeline launches {counts}, expected {want}")
    if tiled_matmul.launches_by_path["ffma"] != counts["tiled_mm"]:
        raise AssertionError(f"tiled_mm launches by path "
                             f"{tiled_matmul.launches_by_path} in the "
                             f"pipeline, expected all on ffma")
    print(f"pipeline: {cfg.name} x{FRAMES} as {len(frames)} micro-batches "
          f"of {MICRO} through {[n for n, *_ in PIPE_STAGES]} pinned to "
          f"{[e for *_, e in PIPE_STAGES]}: tiled_mm {counts['tiled_mm']} + "
          f"vpu_mm {counts['vpu_mm']} launches, logits bitwise equal to the "
          f"dispatcher forward", flush=True)

    samples, runs = host_timed(lambda: ThreadedPipeline(
        pipeline_stages(cfg, params)).run(frames), reps=5)
    mid = sorted(range(len(samples)), key=samples.__getitem__)[2]
    wall = statistics.median(samples)
    emit({"pipeline": cfg.name, "frames": FRAMES,
          "micro_batches": len(frames),
          "stages": {n: e for n, _, _, e in PIPE_STAGES},
          "frames_per_s": FRAMES / wall, "ms": 1e3 * wall,
          "dispatcher_frames_per_s": FRAMES / dispatcher_s,
          "runtime_frames_per_s": runtime_fp32["frames_per_s"],
          "stage_utilization": runs[mid][1]["stage_utilization"],
          "launches": {k: counts[k] for k in want},
          "timer": "host clock around synchronize, median of 5 after 1 "
                   "warm-up; stage_utilization of the median run (host "
                   "seconds in each stage over the pipeline's wall)",
          "card": card})
    return counts


def phase_runtime_steal(card: str, main: tuple) -> dict:
    """Slice 7: ``benchmarks/paper_figs.py::runtime_steal`` on the card.
    8 frames, each one 32-frame micro-batch's conv2 im2col panel (8,192 x
    1,600), through a ``ThreadedPipeline`` of ``EngineStage.gemm`` pinned
    to ``cuda-tiled`` (TS 32) and a host post-stage: pinned, then under
    ``SynergyRuntime(POOL).scope()``.  The two runs' outputs must be
    equal; steals, jobs, busy fractions (cost-model basis, as ``repro``
    computes them), frames/s and ``runtime_beats_pinned`` are printed,
    not gated."""
    cfg, params, x, *_ = main
    i, _, (k, s, p), (_, _, cout) = conv_graph_steps(cfg)[1]
    front = cnn_stage(cfg, params, 0, i)
    with torch.inference_mode():
        frames = [im2col_wave(front(mb), k, k, s, p)
                  for mb in x.to(DEVICE).split(MICRO)]
    w = params[f"conv{i}_w"].reshape(-1, cout)
    engines = [get_engine(n) for n in POOL]

    def stages():
        return [EngineStage.gemm("mm", w, engine="cuda-tiled",
                                 tile=cfg.tile),
                ("post", lambda y: (y, float(y.sum())))]

    def busy_frac(before, after):
        d = [a.busy_s - b.busy_s for b, a in zip(before, after)]
        return sum(d) / (len(d) * max(d)) if max(d) > 0 else 0.0

    def snap():
        return [e.telemetry.snapshot() for e in engines]

    def measure(rt) -> dict:
        reset_launches()
        outs, _ = ThreadedPipeline(stages()).run(frames)
        torch.cuda.synchronize()
        counts = launch_counts()
        if rt is not None:
            rt.reset_stats()
        b0 = snap()
        samples, _ = host_timed(
            lambda: ThreadedPipeline(stages()).run(frames), reps=3)
        return {"outs": outs, "counts": counts, "frac": busy_frac(b0, snap()),
                "fps": len(frames) / statistics.median(samples),
                "stats": rt.stats() if rt is not None else None}

    pinned = measure(None)
    with SynergyRuntime(POOL, name="steal", device=DEVICE) as pool, \
            pool.scope():
        rt = measure(pool)
    for (y0, s0), (y1, s1) in zip(pinned["outs"], rt["outs"]):
        if not torch.equal(y0, y1) or s0 != s1:
            raise AssertionError("runtime_steal: the pooled run's GEMM "
                                 "outputs differ from the pinned run's")
    panels = len(frames) * -(-frames[0].shape[0] // cfg.tile)
    if (pinned["counts"]["tiled_mm"], pinned["counts"]["vpu_mm"]) != (
            len(frames), 0):
        raise AssertionError(f"pinned run launches {pinned['counts']}")
    if rt["counts"]["tiled_mm"] + rt["counts"]["vpu_mm"] != panels:
        raise AssertionError(f"pooled run launches {rt['counts']}, "
                             f"expected {panels} panels")
    per = rt["stats"]["engines"]
    emit({"runtime_steal": f"{cfg.name}/conv{i}", "frames": len(frames),
          "frame": list(frames[0].shape), "w": list(w.shape),
          "tile": cfg.tile, "pool": POOL,
          "pinned": {"engine": "cuda-tiled", "frames_per_s": pinned["fps"],
                     "busy_fraction": pinned["frac"],
                     "launches": pinned["counts"]},
          "runtime": {"frames_per_s": rt["fps"], "busy_fraction": rt["frac"],
                      "steals": rt["stats"]["total_steals"],
                      "jobs": {n: per[n]["jobs"] for n in POOL},
                      "wall_busy_fraction": {n: per[n]["busy_fraction"]
                                             for n in POOL},
                      "launches": rt["counts"]},
          "runtime_beats_pinned": rt["frac"] > pinned["frac"],
          "runtime_faster_than_pinned": rt["fps"] > pinned["fps"],
          "timer": "host clock around synchronize, median of 3 after 1 "
                   "warm-up; busy_fraction on the cost-model basis over "
                   "the 3 timed runs, as repro's runtime_steal; jobs and "
                   "steals summed over them",
          "card": card})
    print(f"runtime_steal: outputs of the pinned and pooled runs equal; "
          f"pooled launches tiled_mm {rt['counts']['tiled_mm']} + vpu_mm "
          f"{rt['counts']['vpu_mm']} = {panels} panels", flush=True)
    return rt["counts"]


def phase_graph(card: str, main: tuple) -> dict:
    """Slice 7: the conv front-end of CIFAR_Alex+ x256 as 8 waves of 32
    frames on ``SynergyRuntime(POOL)`` (32-row panels): (a) graph mode,
    ``conv_wave_graph`` + ``submit_graph``, every wave in flight at once,
    counts set to 0 just before and read just after; (b) chain mode, one
    wave at a time with ``result()`` after every layer.  Each wave's last
    node must be BITWISE the dispatcher's conv front-end for its frames, in
    both modes; one ``GraphFuture.cancel()`` must drain its wave's queued
    panels and end its descendants in ``GraphCancelled``, and the runtime
    must run waves afterwards.  Then frames/s of both modes (median of 3
    after 1), their ratio, and the card's busy share under
    ``torch.profiler`` for one graph run."""
    cfg, params, x, *_ = main
    xd = x.to(DEVICE)
    want = conv_front(cfg, params, xd)
    torch.cuda.synchronize()
    waves = list(xd.split(MICRO))
    rows = want.shape[0] // len(waves)
    panels = len(waves) * sum(js.grid[0]
                              for _, js in conv_jobsets(cfg, MICRO))

    def check(vals: list, mode: str) -> None:
        for w, v in enumerate(vals):
            if not torch.equal(v, want[w * rows:(w + 1) * rows]):
                raise AssertionError(f"graph ({mode}): wave {w} differs from "
                                     f"the dispatcher's conv front-end")

    def graph_run():
        return [f.result(GRAPH_TIMEOUT)[-1]
                for f in graph_waves(rt, cfg, params, waves)]

    with SynergyRuntime(POOL, name="graph", device=DEVICE) as rt:
        rt.reset_stats()
        reset_launches()
        vals = graph_run()
        torch.cuda.synchronize()
        counts, stats = launch_counts(), rt.stats()
        check(vals, "graph")
        if counts["tiled_mm"] == 0 or counts["vpu_mm"] == 0:
            raise AssertionError(f"graph: a kernel ran no panel: {counts}")
        if counts["tiled_mm"] + counts["vpu_mm"] != panels or counts[
                "qmm"] != 0:
            raise AssertionError(f"graph launches {counts}, expected "
                                 f"{panels} panels")
        reset_launches()
        check(chain_waves(rt, cfg, params, waves), "chain")
        torch.cuda.synchronize()
        chain_counts = launch_counts()

        # cancel one wave while its conv0 panels are queued
        reset_launches()
        gf, = graph_waves(rt, cfg, params, waves[:1], name="cancel")
        deadline = time.monotonic() + GRAPH_TIMEOUT
        while gf.node_future(1) is None and not gf.done():
            if time.monotonic() > deadline:
                raise AssertionError("cancel: conv0 was never submitted")
            time.sleep(1e-4)
        cancelled = gf.cancel("chip_smoke cancel")
        try:
            gf.result(GRAPH_TIMEOUT)
        except GraphCancelled:
            pass
        else:
            raise AssertionError("cancel: the graph finished normally")
        torch.cuda.synchronize()
        ran = tiled_matmul.launches + vpu_matmul.launches
        conv0 = conv_jobsets(cfg, MICRO)[0][1].grid[0]
        states = gf.node_states()
        if ran >= conv0 or states[:2] != ["done", "failed"] or any(
                st != "cancelled" for st in states[2:]):
            raise AssertionError(f"cancel: {ran} of {conv0} conv0 panels "
                                 f"ran, node states {states}")
        print(f"graph: cancel drained {conv0 - ran} of {conv0} queued conv0 "
              f"panels, {cancelled} nodes never started, states {states}",
              flush=True)

        graph_s, graph_vals = host_timed(graph_run, reps=3)
        chain_s, chain_vals = host_timed(
            lambda: chain_waves(rt, cfg, params, waves), reps=3)
        for vals in graph_vals + chain_vals:
            check(vals, "timed")
        kernels, busy_ms, wall = profiled_run(graph_run)
    graph_fps = FRAMES / statistics.median(graph_s)
    chain_fps = FRAMES / statistics.median(chain_s)
    emit({"graph": f"{cfg.name} conv front-end", "frames": FRAMES,
          "waves": len(waves), "panels": panels, "pool": POOL,
          "graph_frames_per_s": graph_fps, "chain_frames_per_s": chain_fps,
          "graph_over_chain": graph_fps / chain_fps,
          "steals": stats["total_steals"],
          "jobs": {n: stats["engines"][n]["jobs"] for n in POOL},
          "launches": {"graph": {k: counts[k] for k in
                                 ("tiled_mm", "vpu_mm")},
                       "chain": {k: chain_counts[k] for k in
                                 ("tiled_mm", "vpu_mm")}},
          "cancel": {"conv0_panels": conv0, "ran": ran,
                     "nodes_cancelled": cancelled},
          "profile": {"wall_ms_under_profiler": 1e3 * wall,
                      "kernels": kernels, "device_busy_ms": busy_ms,
                      "device_busy_share": None if busy_ms is None
                      else busy_ms / (1e3 * wall)},
          "timer": "host clock around synchronize, median of 3 after 1 "
                   "warm-up; steals and jobs of the checked graph run; "
                   "profile: one more graph run",
          "card": card})
    print(f"graph: {len(waves)} waves x {MICRO} frames, {panels} panels, "
          f"tiled_mm {counts['tiled_mm']} + vpu_mm {counts['vpu_mm']}; "
          f"graph and chain bitwise the dispatcher's conv front-end",
          flush=True)
    return counts


def fault_pool(names: list, plan) -> list:
    """The registered engines of ``names``, ``plan``'s targets wrapped in
    ``FaultyEngine``s (``wrap_pool``)."""
    return wrap_pool([get_engine(n) for n in names], plan)


def recorded_futures(rt) -> list:
    """Wrap ``rt.submit_gemm`` so that every future it returns is kept."""
    futs, submit = [], rt.submit_gemm

    def recorded(*args, **kw):
        fut = submit(*args, **kw)
        futs.append(fut)
        return fut

    rt.submit_gemm = recorded
    return futs


def panels_merged(futs: list) -> dict:
    """Panels each engine completed into a merge, over ``futs``."""
    ran = collections.Counter()
    for f in futs:
        for eng, acct in f.accounting.items():
            ran[eng] += acct["jobs"] // f.jobset.grid[1]
    return dict(ran)


def fault_forward(cfg, params, x, pool: list, retry,
                  job_class: str | None = None) -> dict:
    """One CNN forward through ``SynergyRuntime(pool, retry=retry)``, launch
    counts set to 0 just before and read just after the final
    synchronize; every future of the forward kept."""
    with SynergyRuntime(pool, name="faults", device=DEVICE,
                        retry=retry) as rt:
        futs = recorded_futures(rt)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits = cnn_forward(cfg, params, x, runtime=rt, job_class=job_class,
                             device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        stats = rt.stats()
    bad = [f.jobset.name for f in futs
           if f.execution_counts != [1] * len(f.execution_counts)]
    if bad:
        raise AssertionError(f"faults: panels of {bad} merged other than "
                             f"exactly once")
    return {"logits": logits, "futs": futs, "stats": stats,
            "launches": counts, "wall_s": wall,
            "panels": sum(len(f.execution_counts) for f in futs)}


def injected_kinds(plan) -> dict:
    return dict(collections.Counter(kind for _, kind, _ in plan.injected))


def phase_faults(card: str, main: tuple, run: dict, decode: dict,
                 serving: dict, runtime_fp32: dict) -> dict:
    """Slice 18: the live runtime's fault paths on the card, each scenario
    of ``tests/test_faults.py`` that a card changes.

    (a) Chaos forward: CIFAR_Alex+ x256 through ``SynergyRuntime(
    wrap_pool(POOL, plan), retry=RetryPolicy(check_outputs=True, ...))``:
    two ``raise`` on ``cuda-tiled``, one ``corrupt`` and one ``drop`` on
    ``neon-vpu``, then ``die`` on ``neon-vpu`` half-way through the panels
    seeded onto it.  Logits BITWISE phase 4's; every future's
    execution counts all 1; one worker death and at least one orphan
    re-seed; K1 + K3 launches = the panels + the attempts that launched
    and were thrown away (the corrupt and the dropped panel, and any late
    stall-sweep duplicate: retries beyond the raises, the corruption and
    the drop), counts set to 0 just before, read just after.  (b) The
    same forward fault-free, with the screen off and on in turns (off,
    on, on, off): host µs a panel of each.  (c) Int8: the decode forward
    over ``QPOOL`` from phase 4's calibrator state, two ``raise`` on the
    int8 worker: BITWISE phase 4's int8 runtime forward, K2 once a panel.
    (d) The reduced granite server of ``phase_serving_dense`` over a
    faulted POOL (a ``die`` on ``neon-vpu``, two ``raise`` on
    ``cuda-tiled``): its tokens, and ``runtime_retries`` >= 1.  (e) Retry
    exhaustion: ``PanelRetryExhausted`` and a ``retry_exhausted`` flight
    dump in a temporary directory.  (f) A ``slowdown`` (x SLOW_FACTOR) on
    ``neon-vpu`` under a ``HealthPolicy`` quarantines it within
    SLOW_GEMMS conv2-shaped GEMMs seeded on it, each bitwise K1's."""
    cfg, params, x, _, logits = main
    t_phase = time.perf_counter()
    seconds, counts, out = {}, {}, {}

    def check_forward(r: dict, want: torch.Tensor, label: str) -> None:
        if not torch.equal(r["logits"], want):
            raise AssertionError(
                f"faults ({label}): logits differ from the fault-free "
                f"forward by {(r['logits'] - want).abs().max().item():.3g}")

    # (b) fault-free, screen off and on in turns
    t0 = time.perf_counter()
    screen = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        r = fault_forward(cfg, params, x, POOL, RetryPolicy(
            check_outputs=label == "on", **FAULT_RETRY))
        check_forward(r, logits, f"screen {label}")
        if r["launches"]["tiled_mm"] + r["launches"]["vpu_mm"] != r["panels"]:
            raise AssertionError(f"faults (screen {label}): launches "
                                 f"{r['launches']}, {r['panels']} panels")
        screen[label].append(r)
    us = {label: [1e6 * r["wall_s"] / r["panels"] for r in rs]
          for label, rs in screen.items()}
    clean_fps = FRAMES / statistics.median(r["wall_s"]
                                           for r in screen["on"])
    counts["screen_on"] = screen["on"][0]["launches"]
    seconds["screen"] = time.perf_counter() - t0
    print(f"faults: fault-free forward, host us a panel with the screen "
          f"off {us['off']}, on {us['on']}; {clean_fps:.2f} frames/s "
          f"(screen on)", flush=True)

    # (a) the chaos forward
    t0 = time.perf_counter()
    # neon-vpu dies half-way through the panels LPT seeds onto it (its
    # cost model gives it 1/17 of each GEMM), which it runs whatever the
    # steals: after the corruption its retry sits at cuda-tiled's queue
    # tail, and avoid_failed_engine keeps neon-vpu from stealing there
    die_at = max(8, run["panels"] // 34)
    plan = FaultPlan((FaultSpec("cuda-tiled", "raise", at_call=0, count=2),
                      FaultSpec("neon-vpu", "corrupt", at_call=2),
                      FaultSpec("neon-vpu", "drop", at_call=4),
                      FaultSpec("neon-vpu", "die", at_call=die_at)), seed=18)
    chaos = fault_forward(cfg, params, x, fault_pool(POOL, plan),
                          RetryPolicy(check_outputs=True, **FAULT_RETRY))
    check_forward(chaos, logits, "chaos")
    kinds = injected_kinds(plan)
    if kinds != {"raise": 2, "corrupt": 1, "drop": 1, "die": 1}:
        raise AssertionError(f"faults (chaos): injected {plan.injected}")
    st = chaos["stats"]
    if st["worker_deaths"] != 1 or st["orphan_reseeds"] < 1:
        raise AssertionError(f"faults (chaos): worker deaths "
                             f"{st['worker_deaths']}, orphan re-seeds "
                             f"{st['orphan_reseeds']}")
    # every retry is a raise, the corruption or a stall-sweep duplicate:
    # of the drop (unless the death re-seeded it first, as an orphan), or
    # a late one, whose original ran too
    stall = st["retries"] - kinds["raise"] - kinds["corrupt"]
    late = max(0, stall - kinds["drop"])
    if stall < 0:
        raise AssertionError(f"faults (chaos): {st['retries']} retries for "
                             f"{kinds}")
    merged = panels_merged(chaos["futs"])
    k1, k3 = chaos["launches"]["tiled_mm"], chaos["launches"]["vpu_mm"]
    wasted_k3 = kinds["corrupt"] + kinds["drop"]
    if k1 + k3 != chaos["panels"] + wasted_k3 + late or (
            late == 0 and (k1, k3) != (merged.get("cuda-tiled", 0),
                                       merged.get("neon-vpu", 0)
                                       + wasted_k3)):
        raise AssertionError(
            f"faults (chaos): launches K1 {k1}, K3 {k3} for "
            f"{chaos['panels']} panels (merged {merged}), {wasted_k3} "
            f"thrown away by plan, {late} late duplicates")
    counts["chaos"] = chaos["launches"]
    chaos_fps = FRAMES / chaos["wall_s"]
    seconds["chaos"] = time.perf_counter() - t0
    print(f"faults: chaos forward bitwise, injected {plan.injected}, "
          f"{st_line(st)}, launches K1 {k1} + K3 {k3} for "
          f"{chaos['panels']} panels (merged {merged}, {late} late "
          f"duplicates), {chaos_fps:.2f} frames/s", flush=True)
    out["chaos"] = {"plan": [dataclasses.asdict(s) for s in plan.specs],
                    "injected": plan.injected, "panels": chaos["panels"],
                    "merged": merged, "late_duplicates": late,
                    **{k: st[k] for k in ("retries", "worker_deaths",
                                          "orphan_reseeds")},
                    "frames_per_s": chaos_fps,
                    "fault_free_frames_per_s": clean_fps,
                    "phase5_runtime_frames_per_s":
                        runtime_fp32["frames_per_s"]}

    # (c) int8 from phase 4's calibrator state
    t0 = time.perf_counter()
    qeng = get_engine("cuda-tiled-int8")
    qplan = FaultPlan((FaultSpec("cuda-tiled-int8", "raise", at_call=1,
                                 count=2),), seed=18)
    qeng.calibrator.import_state(decode["state0"])
    try:
        q = fault_forward(cfg, params, x, fault_pool(QPOOL, qplan),
                          RetryPolicy(**FAULT_RETRY), job_class="decode")
    finally:
        qeng.calibrator.import_state(decode["state0"])
    check_forward(q, decode["runtime_logits"], "int8")
    if (injected_kinds(qplan) != {"raise": 2} or q["stats"]["retries"] != 2
            or q["launches"] != {**NO_LM_KERNELS, "tiled_mm": 0,
                                 "vpu_mm": 0, "qmm": q["panels"]}):
        raise AssertionError(f"faults (int8): injected {qplan.injected}, "
                             f"retries {q['stats']['retries']}, launches "
                             f"{q['launches']} for {q['panels']} panels")
    counts["int8"] = q["launches"]
    seconds["int8"] = time.perf_counter() - t0
    print(f"faults: int8 forward bitwise, injected {qplan.injected}, "
          f"{st_line(q['stats'])}, qmm {q['launches']['qmm']} launches "
          f"for {q['panels']} panels", flush=True)

    # (d) serving over a faulted pool
    t0 = time.perf_counter()
    dcfg, dparams, dcnn = dense_model()
    splan = FaultPlan((FaultSpec("neon-vpu", "die", at_call=3),
                       FaultSpec("cuda-tiled", "raise", at_call=0, count=2)),
                      seed=18)
    served = serve_run(dcfg, to_device(dparams), fault_pool(POOL, splan),
                       cnn_params=to_device(dcnn), n=SERVE_SLOTS,
                       retry=RetryPolicy(**FAULT_RETRY))
    if served["tokens"] != serving["dense"]["tokens"]:
        raise AssertionError("faults (serving): tokens differ from the "
                             "fault-free card run")
    if served["stats"].runtime_retries < 1:
        raise AssertionError(f"faults (serving): runtime_retries "
                             f"{served['stats'].runtime_retries}, injected "
                             f"{splan.injected}")
    counts["serving"] = served["launches"]
    out["serving"] = {"injected": splan.injected,
                      "runtime_retries": served["stats"].runtime_retries,
                      "decode_gemms_vs_plain": served["checked"]}
    seconds["serving"] = time.perf_counter() - t0
    print(f"faults: serving tokens equal, injected {splan.injected}, "
          f"runtime_retries {served['stats'].runtime_retries}",
          flush=True)

    # (e) retry exhaustion and its flight dump
    t0 = time.perf_counter()
    eplan = FaultPlan(tuple(FaultSpec(n, "raise", at_call=0, count=10 ** 6)
                            for n in POOL), seed=18)
    g = torch.Generator(device=DEVICE).manual_seed(18)
    a = torch.randn(64, 75, device=DEVICE, generator=g)
    b = torch.randn(75, 64, device=DEVICE, generator=g)
    workdir = tempfile.mkdtemp(prefix="faults-")
    try:
        tracer = Tracer()
        with SynergyRuntime(fault_pool(POOL, eplan), name="exhaust",
                            device=DEVICE, tracer=tracer,
                            flight_recorder=FlightRecorder(tracer,
                                                           dir=workdir),
                            retry=RetryPolicy(**{**FAULT_RETRY,
                                                 "max_attempts": 2})) as rt:
            reset_launches()
            fut = rt.submit_gemm(a, b, jobset=JobSet.for_gemm(
                0, 64, 64, 75, 32, name="doom"), tile=(32, 32, 32))
            try:
                fut.result(FAULT_TIMEOUT)
            except PanelRetryExhausted as e:
                exhausted = e
            else:
                raise AssertionError("faults (exhaustion): the GEMM "
                                     "completed")
        dumps = sorted(Path(workdir).glob("flightrec-*retry_exhausted*.json"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if not dumps or exhausted.attempts != 2:
        raise AssertionError(f"faults (exhaustion): {len(dumps)} dumps, "
                             f"{exhausted}")
    counts["exhaustion"] = launch_counts()
    seconds["exhaustion"] = time.perf_counter() - t0

    # (f) a slowdown quarantines neon-vpu
    t0 = time.perf_counter()
    m, n, k = SLOW_GEMM
    a = torch.randn(m, k, device=DEVICE, generator=g)
    b = torch.randn(k, n, device=DEVICE, generator=g)
    want = tiled_matmul(a, b)
    hplan = FaultPlan((FaultSpec("neon-vpu", "slowdown", at_call=4,
                                 count=10 ** 6, factor=SLOW_FACTOR),), seed=18)
    with SynergyRuntime(fault_pool(POOL, hplan), name="health", device=DEVICE,
                        health=HealthPolicy(alpha=0.5, quarantine_below=0.05,
                                            min_samples=3,
                                            probe_interval_s=1e9)) as rt:
        torch.cuda.synchronize()
        reset_launches()
        # the GEMM seeded on neon-vpu, which takes a panel from its own
        # queue's head between slowed ones while cuda-tiled steals the
        # tail; again until neon-vpu is quarantined (a few slowed panels)
        gemms, bitwise = 0, True
        while gemms < SLOW_GEMMS and not rt.stats()["quarantines"]:
            y = rt.submit_gemm(a, b, jobset=JobSet.for_gemm(0, m, n, k, 32),
                               tile=(32, 32, 32),
                               affinity="neon-vpu").result(FAULT_TIMEOUT)
            bitwise = bitwise and torch.equal(y, want)
            gemms += 1
        torch.cuda.synchronize()
        counts["slowdown"] = launch_counts()
        st = rt.stats()
    health = st["engines"]["neon-vpu"]
    if not bitwise or not health["quarantined"] or st[
            "engines"]["cuda-tiled"]["quarantined"]:
        raise AssertionError(f"faults (slowdown): bitwise {bitwise} over "
                             f"{gemms} GEMMs, engines "
                             f"{ {e: st['engines'][e] for e in POOL} }")
    out["slowdown"] = {"factor": SLOW_FACTOR, "gemms": gemms,
                       "slowed_panels": len(hplan.injected),
                       "quarantines": st["quarantines"],
        "neon_vpu": {key: health[key] for key in ("health", "jobs")}}
    seconds["slowdown"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase

    figures = {"screen_host_us_per_panel": us,
               "chaos_frames_per_s": chaos_fps,
               "fault_free_frames_per_s": clean_fps}
    emit({"faults": cfg.name, "frames": FRAMES, "pool": POOL,
          "retry": FAULT_RETRY, **out, **figures,
          "launches": counts, "seconds": seconds,
          "timer": "host clock around synchronize, one forward each "
                   "(screen: two each, off, on, on, off)",
          "card": card})
    print(f"faults: exhaustion dumped; slowdown quarantined neon-vpu "
          f"after {len(hplan.injected)} slowed panels in {gemms} GEMMs; "
          f"seconds {seconds}; card {card}", flush=True)
    return {"launches": counts, "seconds": seconds, **figures}


def st_line(st: dict) -> str:
    return ", ".join(f"{k} {st[k]}" for k in ("retries", "worker_deaths",
                                              "orphan_reseeds"))


def faults_launches(faults: dict, name: str) -> dict:
    """A kernel's launches in each of phase_faults's runs."""
    return {"launches": {run: c[name] for run, c in
                         faults["launches"].items()},
            "per": "each run of the faults phase (chaos forward, the "
                   "fault-free forward with the screen on, int8 decode, "
                   "serving, retry exhaustion, slowdown), counts set to 0 "
                   "just before and read just after"}


def fa_tol(sk: int, dtype: torch.dtype) -> float:
    """K4 vs its plain version, relative to max|ref|: fp32 2e-5·sqrt(Sk)
    (tests/test_flash_attention.py's 2e-5, scaled by the Sk products each
    output sums in another order), bf16 3e-2 (p is rounded to bf16 before
    the PV product in the kernel, not in the plain version)."""
    return 2e-5 * math.sqrt(sk) if dtype == torch.float32 else BF16_TOL


def fa_inputs(g: torch.Generator, b: int, hq: int, hkv: int, s: int,
              sk: int, d: int, dtype: torch.dtype) -> tuple:
    return (torch.randn(b, hq, s, d, device=DEVICE, generator=g).to(dtype),
            torch.randn(b, hkv, sk, d, device=DEVICE, generator=g).to(dtype),
            torch.randn(b, hkv, sk, d, device=DEVICE, generator=g).to(dtype))


def ssd_inputs(g: torch.Generator, b: int, l: int, h: int, p: int, n: int,
               dtype: torch.dtype) -> tuple:
    """x (B,L,H,P), dt (B,L,H) post-softplus, a (H,), bm/cm (B,L,N), as
    tests/test_ssd.py draws them."""
    x = (torch.randn(b, l, h, p, device=DEVICE, generator=g) * 0.5)
    dt = F.softplus(torch.randn(b, l, h, device=DEVICE, generator=g) - 1.0)
    a = -torch.exp(torch.randn(h, device=DEVICE, generator=g) * 0.5)
    bm = torch.randn(b, l, n, device=DEVICE, generator=g) * 0.3
    cm = torch.randn(b, l, n, device=DEVICE, generator=g) * 0.3
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


def phase_flash_kernel() -> float:
    """Phase 3, K4: ``flash_attention`` against its plain version
    (``attention_ref``) at every FA_CASES shape.  Returns the largest abs
    error at the main path's case (the first)."""
    g = torch.Generator(device=DEVICE).manual_seed(11)
    errs = []
    for label, b, hq, hkv, s, sk, d, causal, dtype in FA_CASES:
        q, k, v = fa_inputs(g, b, hq, hkv, s, sk, d, dtype)
        o = flash_attention_cuda(q, k, v, causal=causal)
        r = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if o.dtype != dtype or o.shape != q.shape:
            raise AssertionError(f"flash_attention {label}: got {o.dtype} "
                                 f"{tuple(o.shape)}")
        err, tol = rel_err(o, r), fa_tol(sk, dtype)
        if not err <= tol:
            raise AssertionError(f"flash_attention {label} {dtype}: rel_err "
                                 f"{err:.3g} > {tol:.3g}")
        errs.append((o.float() - r.float()).abs().max().item())
        emit({"kernel_check": "flash_attention", "case": label,
              "shape": [b, hq, hkv, s, sk, d], "causal": causal,
              "dtype": str(dtype), "rel_err": err, "tol": tol,
              "max_abs_err": errs[-1]})
    print(f"flash_attention: {len(FA_CASES)} cases agree with the plain "
          f"version (fp32 2e-5*sqrt(Sk), bf16 {BF16_TOL}, relative to "
          f"max|ref|)", flush=True)
    return errs[0]


def phase_ssd_kernel() -> float:
    """Phase 3, K5: ``ssd`` through the kernel against its plain version
    (the chunked torch path) at every SSD_CASES shape, y and the final
    state.  Returns the largest abs error of y at the main path's case."""
    g = torch.Generator(device=DEVICE).manual_seed(12)
    errs = []
    for label, b, l, h, p, n, chunk, dtype in SSD_CASES:
        inp = ssd_inputs(g, b, l, h, p, n, dtype)
        y, st = ssd(*inp, chunk=chunk, impl="cuda")
        ry, rst = ssd(*inp, chunk=chunk, impl="torch")
        torch.cuda.synchronize()
        if y.dtype != dtype or y.shape != inp[0].shape \
                or st.shape != (b, h, p, n):
            raise AssertionError(f"ssd {label}: got {y.dtype} "
                                 f"{tuple(y.shape)}, {tuple(st.shape)}")
        tol = 2e-5 * math.sqrt(l) if dtype == torch.float32 else BF16_TOL
        err_y, err_s = rel_err(y, ry), rel_err(st, rst)
        if not (err_y <= tol and err_s <= tol):
            raise AssertionError(f"ssd {label} {dtype}: rel_err y "
                                 f"{err_y:.3g}, state {err_s:.3g} > "
                                 f"{tol:.3g}")
        errs.append((y.float() - ry.float()).abs().max().item())
        emit({"kernel_check": "ssd", "case": label,
              "shape": [b, l, h, p, n], "chunk": chunk, "dtype": str(dtype),
              "rel_err_y": err_y, "rel_err_state": err_s, "tol": tol,
              "max_abs_err": errs[-1]})
    print(f"ssd: {len(SSD_CASES)} cases agree with the plain version, y and "
          f"state (fp32 2e-5*sqrt(L), bf16 {BF16_TOL}, relative to "
          f"max|ref|)", flush=True)
    return errs[0]


def ssd_operands(x, dt, a, bm, cm, chunk: int) -> tuple:
    """The kernel's operands as ``ssd`` hands them over: the chunk cut to
    L, L padded with zeros to a chunk multiple, xdt and dta pre-scaled,
    all contiguous.  Returns (xdt, dta, bm, cm, chunk)."""
    l = x.shape[1]
    chunk = min(chunk, max(1, l))
    pad = (-l) % chunk
    if pad:
        padl = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])  # noqa: E731
        x, dt, bm, cm = padl(x), padl(dt), padl(bm), padl(cm)
    xdt, dta = _prescale(x, dt, a)
    return (xdt.contiguous(), dta.contiguous(), bm.contiguous(),
            cm.contiguous(), chunk)


def first_mismatch(got: torch.Tensor, want: torch.Tensor) -> str:
    """How many elements differ and the first index that does."""
    diff = (got != want) & ~(torch.isnan(got) & torch.isnan(want))
    idx = diff.nonzero()
    if not len(idx):
        return "0 differ"
    first = tuple(idx[0].tolist())
    return (f"{len(idx)} of {got.numel()} differ, first at {first}: "
            f"{got[first].item()!r} vs {want[first].item()!r}")


def witness_shapes() -> list:
    """Every (label, B, L, H, P, N, chunk) of SSD_CASES and BWD_SSD_CASES,
    once each."""
    seen = {}
    for label, *shape, _ in SSD_CASES + BWD_SSD_CASES:
        seen.setdefault(tuple(shape), label)
    return [(label, *shape) for shape, label in seen.items()]


def phase_ssd_witness() -> int:
    """Phase 3, K5: the kernel bitwise against its frozen witness (its
    first version, ``csrc/ssd_witness.cu``) at every SSD_CASES and
    BWD_SSD_CASES shape in fp32 and bf16: ``torch.equal`` on y and on the
    final state.  Returns the number of cases."""
    g = torch.Generator(device=DEVICE).manual_seed(15)
    cases = 0
    for label, b, l, h, p, n, chunk in witness_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            xdt, dta, bm, cm, q = ssd_operands(
                *ssd_inputs(g, b, l, h, p, n, dtype), chunk)
            y, st = ssd_cuda(xdt, dta, bm, cm, chunk=q)
            wy, wst = ssd_witness(xdt, dta, bm, cm, chunk=q)
            torch.cuda.synchronize()
            same = torch.equal(y, wy) and torch.equal(st, wst)
            emit({"kernel_witness": "ssd", "case": label,
                  "shape": [b, l, h, p, n], "chunk": q, "dtype": str(dtype),
                  "y_equal": torch.equal(y, wy),
                  "state_equal": torch.equal(st, wst)})
            if not same:
                raise AssertionError(
                    f"ssd {label} {dtype}: not bitwise the witness; y "
                    f"{first_mismatch(y, wy)}; state "
                    f"{first_mismatch(st, wst)}")
            cases += 1
    print(f"ssd: bitwise its witness (y and state, torch.equal) in "
          f"{cases} cases", flush=True)
    return cases


def phase_ssd_widths(card: str) -> list:
    """Phase 3, slice 14, K5 at a rank's share of P: at each shape of
    SSD_WIDTH_SHAPES (fp32, the prefill's dtype), one call at P = 64, then
    for every P of SSD_HEAD_DIMS the kernel on the first P columns within
    2e-5·sqrt(L) of its plain version (``ssd_chunked`` on the same
    operands), and on every P-column slab equal (``torch.equal``, y and
    state) to that slab of the P = 64 call (at N = 16 also of a P = 16
    call); its time (CUDA events, median of REPS) beside the plain
    version's and ``ssd_bound``.  Returns one row per (P, N)."""
    g = torch.Generator(device=DEVICE).manual_seed(28)
    rows = []
    for label, b, l, h, n, chunk in SSD_WIDTH_SHAPES:
        x, dt, a, bm, cm = ssd_inputs(g, b, l, h, 64, n, torch.float32)
        xdt, dta, bm, cm, q = ssd_operands(x, dt, a, bm, cm, chunk)
        fulls = {64: ssd_cuda(xdt, dta, bm, cm, chunk=q)}
        if n == 16:
            fulls[16] = ssd_cuda(xdt[..., :16].contiguous(), dta, bm, cm,
                                 chunk=q)
        for p in SSD_HEAD_DIMS:
            cols = xdt[..., :p].contiguous()
            y, st = ssd_cuda(cols, dta, bm, cm, chunk=q)
            ry, rst = ssd_chunked(cols, dta, bm, cm, chunk=q)
            tol = 2e-5 * math.sqrt(l)
            err_y, err_s = rel_err(y, ry), rel_err(st, rst)
            if not (err_y <= tol and err_s <= tol):
                raise AssertionError(f"ssd P {p} N {n} ({label}): rel_err "
                                     f"y {err_y:.3g}, state {err_s:.3g} > "
                                     f"{tol:.3g}")
            slabs = 0
            for full, (wy, ws) in fulls.items():
                for p0 in range(0, full, p) if p < full else ():
                    sy, ss = ssd_cuda(xdt[..., p0:p0 + p].contiguous(), dta,
                                      bm, cm, chunk=q)
                    torch.cuda.synchronize()
                    if not (torch.equal(sy, wy[..., p0:p0 + p])
                            and torch.equal(ss, ws[:, :, p0:p0 + p])):
                        raise AssertionError(
                            f"ssd P {p} N {n} ({label}): columns "
                            f"[{p0}, {p0 + p}) of the P = {full} call "
                            f"differ; y "
                            f"{first_mismatch(sy, wy[..., p0:p0 + p])}")
                    slabs += 1
            ms = median_ms(lambda: ssd_cuda(cols, dta, bm, cm, chunk=q))
            plain = median_ms(lambda: ssd_chunked(cols, dta, bm, cm,
                                                  chunk=q), reps=5)
            b_ms, by = ssd_bound(b, l, h, p, n, 4)
            rows.append({"p": p, "n": n, "shape": label,
                         "call": [b, l, h, p, n], "chunk": q,
                         "rel_err_y": err_y, "rel_err_state": err_s,
                         "tol": tol, "bitwise_slabs": slabs,
                         "max_abs_err": (y - ry).abs().max().item(),
                         "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": by, "library_ms": None})
            emit({"kernel_width": "ssd", **rows[-1]})
    print(f"ssd: {len(rows)} widths (P {list(SSD_HEAD_DIMS)} x N 16/64/128) "
          f"within 2e-5*sqrt(L) of the plain version and bitwise the wide "
          f"calls' column slabs; ms / bound: "
          + ", ".join(f"P{r['p']}N{r['n']} {r['ms']:.3f}/{r['bound_ms']:.4f}"
                      for r in rows) + f"; card {card}", flush=True)
    return rows


def expect_counts(stage: str, want: dict) -> dict:
    """The launch counts since the last reset; raises unless each kernel
    of ``want`` ran exactly that often."""
    got = launch_counts()
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{stage}: launches (got, want) {bad}")
    return {k: got[k] for k in want}


def expect_paths(stage: str, gemms: int) -> dict:
    """K1's launches by path since the last reset; raises unless all
    ``gemms`` of them (the LM zoo's bf16 GEMMs, every one aligned) took the
    wgmma path."""
    got = dict(tiled_matmul.launches_by_path)
    if got != {p: gemms * (p == "wgmma") for p in PATHS}:
        raise AssertionError(f"{stage}: tiled_mm launches by path {got}, "
                             f"expected all {gemms} on wgmma")
    return got


def expect_fp32_paths(stage: str, gemms: int) -> dict:
    """K1's launches by path since the last reset; raises unless all
    ``gemms`` of them (fp32 GEMMs) took the ffma path."""
    got = dict(tiled_matmul.launches_by_path)
    if got != {p: gemms * (p == "ffma") for p in PATHS}:
        raise AssertionError(f"{stage}: tiled_mm launches by path {got}, "
                             f"expected all {gemms} on ffma")
    return got


def timed(fn) -> tuple:
    """(fn(), seconds) on the host clock, between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_lm(card: str) -> dict:
    """Phase 4, slice 4: LM serving of zamba2-2.7b at its published widths
    and all 54 layers (param fp32, compute bf16, random weights from a
    seed, made on the card).  4 x 1,024-token prompts through
    ``prefill_fn`` (counts set to 0 just before and read just after: K4 9,
    K5 54, K1 55), then 32 greedy ``decode_fn`` steps (each: K4 0, K5 0,
    K1 55).  Against ``impl="ref"`` (both oracles), within ``rel_err``
    LM_REF_TOL: the prefill logits in fp32 compute at the same shapes, and
    the bf16 prefill block by block (each mixer on the kernels and on the
    oracles from the same input); the bf16 logits' ``rel_err`` is printed
    beside the bf16-vs-fp32 one.  At full width with compute fp32, 16
    decode steps from an empty cache reproduce ``lm_forward`` within
    LM_DECODE_TOL."""
    cfg = ARCHS[LM_ARCH]
    groups = cfg.n_layers // cfg.attn_every
    per_prefill = {"flash_attention": groups, "ssd": cfg.n_layers,
                   "tiled_mm": 6 * groups + 1}
    per_step = {"flash_attention": 0, "ssd": 0, "tiled_mm": 6 * groups + 1}
    params, init_s = timed(lambda: init_model(cfg, 0, device=DEVICE))
    n_params = sum(t.numel() for t in tree_leaves(params))
    g = torch.Generator(device=DEVICE).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           device=DEVICE, generator=g)

    # the main path: one prefill, then the decode steps
    reset_launches()
    logits, first_prefill_s = timed(
        lambda: prefill_fn(cfg, params, tokens=tokens))
    prefill_counts = expect_counts("prefill", per_prefill)
    prefill_paths = expect_paths("prefill", per_prefill["tiled_mm"])
    if logits.shape != (LM_BATCH, 1, cfg.padded_vocab) \
            or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {logits.dtype} "
                             f"{tuple(logits.shape)} or not finite")
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    cache = init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=DEVICE)
    generated, step_s = [tok], []
    for i in range(LM_DECODE):
        reset_launches()
        (step_logits, cache), s = timed(
            lambda: decode_fn(cfg, params, cache, tok, LM_PROMPT + i))
        expect_counts(f"decode step {i}", per_step)
        step_paths = expect_paths(f"decode step {i}", per_step["tiled_mm"])
        if not bool(torch.isfinite(step_logits).all()):
            raise AssertionError(f"decode step {i}: logits not finite")
        tok = step_logits[:, -1].argmax(dim=-1, keepdim=True)
        generated.append(tok)
        step_s.append(s)
    print(f"lm: {LM_ARCH} ({n_params:,} params) prefill {LM_BATCH} x "
          f"{LM_PROMPT} tokens: launches {prefill_counts}, tiled_mm by path "
          f"{prefill_paths}; {LM_DECODE} decode steps: launches per step "
          f"{per_step}, tiled_mm by path {step_paths}", flush=True)

    # the prefill against impl="ref" (both oracles).  In bf16 every block
    # re-rounds the 54-layer residual stream, and a last-bit difference
    # anywhere grows to a few per cent of the logits whichever engines run
    # (PERF.md §6), so the logits are held to LM_REF_TOL in fp32 compute
    # at the same shapes, and the bf16 prefill block by block
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    logits32 = prefill_fn(cfg32, params, tokens=tokens)
    ref_err = rel_err(logits32, prefill_fn(cfg32, params, tokens=tokens,
                                           impl="ref"))
    if not ref_err <= LM_REF_TOL:
        raise AssertionError(f"fp32 prefill vs impl='ref': rel_err "
                             f"{ref_err:.4g} > {LM_REF_TOL}")
    mixer_errs = mixer_errors(cfg, params, tokens)
    worst = max(max(errs) for errs in mixer_errs.values())
    if not worst <= LM_REF_TOL:
        raise AssertionError(f"bf16 prefill, a block's mixer vs impl='ref': "
                             f"rel_err {worst:.4g} > {LM_REF_TOL}")
    bf16_ref_err = rel_err(logits, prefill_fn(cfg, params, tokens=tokens,
                                              impl="ref"))
    bf16_vs_fp32 = rel_err(logits, logits32)
    prefill_s = statistics.median(
        timed(lambda: prefill_fn(cfg, params, tokens=tokens))[1]
        for _ in range(3))

    # decode reproduces the forward, at full width in fp32
    check = tokens[:1, :LM_CHECK_TOKENS]
    reset_launches()
    with torch.inference_mode():
        full = lm_forward(cfg32, params, tokens=check)
    forward_counts = expect_counts("fp32 forward", per_prefill)
    cache32 = init_cache(cfg32, 1, LM_CHECK_TOKENS, device=DEVICE)
    outs = []
    reset_launches()
    for i in range(LM_CHECK_TOKENS):
        step_logits, cache32 = decode_fn(cfg32, params, cache32,
                                         check[:, i:i + 1], i)
        outs.append(step_logits[:, 0])
    expect_counts("fp32 decode", {k: v * LM_CHECK_TOKENS
                                  for k, v in per_step.items()})
    inc = torch.stack(outs, dim=1)
    torch.testing.assert_close(inc, full, rtol=LM_DECODE_TOL,
                               atol=LM_DECODE_TOL)
    consistency = (inc - full).abs().max().item()

    decode_step_s = statistics.median(step_s)
    result = {
        "lm": LM_ARCH, "params": n_params, "param_dtype": cfg.param_dtype,
        "compute_dtype": cfg.compute_dtype, "init_s": init_s,
        "prefill": {"requests": LM_BATCH, "prompt": LM_PROMPT,
                    "launches": prefill_counts,
                    "tiled_mm_launches_by_path": prefill_paths,
                    "first_ms": 1e3 * first_prefill_s,
                    "ms": 1e3 * prefill_s,
                    "tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
                    "fp32_rel_err_vs_ref": ref_err,
                    "bf16_mixer_rel_err_vs_ref": {
                        "mamba_max": max(mixer_errs["mamba"]),
                        "attention": mixer_errs["attention"]},
                    "tol": LM_REF_TOL,
                    "bf16_rel_err_vs_ref_not_held": bf16_ref_err,
                    "bf16_rel_err_vs_fp32_not_held": bf16_vs_fp32},
        "decode": {"steps": LM_DECODE, "max_len": LM_MAX_LEN,
                   "launches_per_step": per_step,
                   "tiled_mm_launches_by_path_per_step": step_paths,
                   "ms_per_step": 1e3 * decode_step_s,
                   "ms_per_step_max": 1e3 * max(step_s),
                   "tokens_per_s": LM_BATCH / decode_step_s,
                   "tokens": torch.cat(generated, dim=1)[0].tolist()},
        "fp32_decode_vs_forward": {"tokens": LM_CHECK_TOKENS,
                                   "forward_launches": forward_counts,
                                   "max_abs_diff": consistency,
                                   "tol": LM_DECODE_TOL},
        "timer": "host clock around synchronize; prefill median of 3 "
                 "after the first, decode median of the 32 steps",
        "card": card}
    emit(result)
    return {"cfg": cfg, "params": params, "tokens": tokens,
            "prefill": result["prefill"], "decode": result["decode"],
            "per_prefill": per_prefill}


def mixer_errors(cfg, params: dict, tokens: torch.Tensor) -> dict:
    """The bf16 prefill block by block, on the kernels' path: one
    ``prefill_fn(impl="cuda")`` with ``transformer.mixer_probe`` set, which
    recomputes each Mamba2 mixer (K5) and each application of the shared
    block's attention (K4) on the oracles (``impl="ref"``) from the same
    input; ``rel_err`` of each pair, by kind, in the order the backbone
    runs them."""
    from repro_torch.models import transformer as tf
    errs = {"mamba": [], "attention": []}
    tf.mixer_probe = lambda kind, out, rerun: errs[kind].append(
        rel_err(out, rerun("ref")))
    try:
        prefill_fn(cfg, params, tokens=tokens, impl="cuda")
    finally:
        tf.mixer_probe = None
    want = {"mamba": cfg.n_layers,
            "attention": cfg.n_layers // cfg.attn_every}
    got = {kind: len(e) for kind, e in errs.items()}
    if got != want:
        raise AssertionError(f"mixer probe: mixers (got, want) {got}, "
                             f"{want}")
    return errs


def flash_bound(b: int, hq: int, hkv: int, s: int, sk: int, d: int,
                causal: bool, itemsize: int) -> tuple[float, str]:
    """Least ms for one K4 call: q, k, v read once and o written once at
    the HBM rate, or the QK and PV products this run needs (the causal
    triangle: row i sees i + 1 keys) at the tensor-core peak of the inputs'
    type (bf16 989 TFLOP/s; fp32 inputs count at the 67 TFLOP/s of fp32)."""
    pairs = s * (s + 1) // 2 if causal else s * sk
    t_ops = 4.0 * b * hq * d * pairs / (
        BF16_PEAK_FLOPS if itemsize == 2 else FP32_PEAK_FLOPS)
    t_bytes = itemsize * (2 * b * hq * s * d + 2 * b * hkv * sk * d) \
        / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def ssd_bound(b: int, l: int, h: int, p: int, n: int,
              itemsize: int) -> tuple[float, str]:
    """Least ms for one K5 call: xdt, dta, B, C read once and y, the state
    written once at the HBM rate, or the least work of the function, the
    recurrence's 2·P·N multiply-adds per token and head (the state update
    and its product with C), at the fp32 67 TFLOP/s (bf16 inputs at the
    bf16 tensor-core peak).  The chunked algorithm the kernel runs does
    more: per chunk and head the causal half of C·Bᵀ's product with xdt
    besides C·Sᵀ and the state update, and C·Bᵀ once per (batch, chunk),
    since B and C have no head index."""
    macs = 2 * b * h * l * p * n
    t_ops = 2.0 * macs / (BF16_PEAK_FLOPS if itemsize == 2
                          else FP32_PEAK_FLOPS)
    t_bytes = (itemsize * (2 * b * h * l * p + 2 * b * l * n)
               + 4 * (b * h * l + b * h * p * n)) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_lm_kernel_times(card: str, lm: dict) -> dict:
    """Phase 5, slice 4: K4 and K5 at the main path's shapes (CUDA events,
    median of REPS): the kernel, its plain version, the library yardstick
    (K4: ``F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)``; K5: none, no single PyTorch call computes SSD) and
    the bound; per call and per prefill (times the calls one prefill
    makes).  K5 also at the training step's call (BWD_SSD_CASES[0]), and
    at both shapes beside its frozen witness, the kernel's first version,
    timed in turns with it."""
    cfg = lm["cfg"]
    g = torch.Generator(device=DEVICE).manual_seed(14)
    out = {}
    _, b, hq, hkv, s, sk, d, causal, dtype = FA_CASES[0]
    q, k, v = fa_inputs(g, b, hq, hkv, s, sk, d, dtype)
    per_call = {
        "ms": median_ms(lambda: flash_attention_cuda(q, k, v,
                                                     causal=causal)),
        "plain_ms": median_ms(lambda: attention_ref(q, k, v,
                                                    causal=causal)),
        "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))}
    per_call["bound_ms"], bound_by = flash_bound(b, hq, hkv, s, sk, d,
                                                 causal, q.element_size())
    out["flash_attention"] = (per_call, bound_by, [b, hq, hkv, s, sk, d],
                              str(dtype), "F.scaled_dot_product_attention")
    ssd_calls = {}
    for key, case in (("lm_prefill", SSD_CASES[0]),
                      ("training", BWD_SSD_CASES[0])):
        _, b, l, h, p, n, chunk, dtype = case
        xdt, dta, bm, cm, chunk = ssd_operands(
            *ssd_inputs(g, b, l, h, p, n, dtype), chunk)
        # the witness (the kernel's first version) in turns with the kernel
        # on the same inputs: witness, kernel, kernel, witness
        runs = {"ms": [], "witness_ms": []}
        for name in ("witness_ms", "ms", "ms", "witness_ms"):
            fn = ssd_cuda if name == "ms" else ssd_witness
            runs[name].append(median_ms(
                lambda: fn(xdt, dta, bm, cm, chunk=chunk)))
        per_call = {"ms": min(runs["ms"]),
                    "witness_ms": min(runs["witness_ms"]),
                    "plain_ms": median_ms(lambda: ssd_chunked(
                        xdt, dta, bm, cm, chunk=chunk)),
                    "library_ms": None}
        per_call["bound_ms"], bound_by = ssd_bound(b, l, h, p, n,
                                                   xdt.element_size())
        ssd_calls[key] = (per_call, bound_by, [b, l, h, p, n], str(dtype))
    out["ssd"] = (*ssd_calls["lm_prefill"], None)
    totals = {}
    for name, (per_call, bound_by, shape, dt_name, library) in out.items():
        calls = lm["per_prefill"][name]
        totals[name] = {key: None if val is None else calls * val
                        for key, val in per_call.items()}
        totals[name]["bound_by"] = bound_by
        emit({"lm_kernel": name, "shape": shape, "dtype": dt_name,
              "per_call": per_call, "bound_by": bound_by,
              "calls_per_prefill": calls,
              "peak": BF16_NOTE if dt_name == "torch.bfloat16" else PEAK_NOTE,
              "library": library, "card": card})
    # K5 per call at the prefill's and the training step's shapes, beside
    # its witness (the kernel's first version) timed in turns with it
    totals["ssd"]["per_call"] = {
        key: {**per_call, "bound_by": bound_by, "shape": shape,
              "dtype": dt_name}
        for key, (per_call, bound_by, shape, dt_name) in ssd_calls.items()}
    emit({"lm_kernel": "ssd", "per_call_by_path": totals["ssd"]["per_call"],
          "card": card})
    return totals


class ShapeEngine(Engine):
    """Runs K1 (through the ``cuda-tiled`` engine) and records each GEMM's
    shape, types and epilogue: the LM path's GEMMs, to time K1 beside its
    yardsticks at the same shapes."""

    def __init__(self):
        super().__init__("shapes", {"gemm", "epilogue"},
                         cost=CostModel(1e12))
        self.calls: list[tuple] = []

    def execute(self, a, b, *, bias=None, activation=None, tile=None,
                out_dtype=None):
        self.calls.append((a.shape[0], b.shape[1], a.shape[1], a.dtype,
                           activation, bias is not None,
                           out_dtype or a.dtype))
        return get_engine("cuda-tiled").execute(
            a, b, bias=bias, activation=activation, tile=tile,
            out_dtype=out_dtype)


def gemm_bound(m: int, n: int, k: int, itemsize: int, out_itemsize: int,
               peak: float) -> tuple[float, str]:
    """Least ms for act(A @ B + bias) with inputs of ``itemsize`` bytes:
    each input read once and the output written once at the HBM rate, or
    the products at ``peak``, whichever is larger."""
    t_ops = 2.0 * m * n * k / peak
    t_bytes = (itemsize * (m * k + k * n) + out_itemsize * m * n
               + 4 * n) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def lm_gemm_times(calls: list, g: torch.Generator) -> dict:
    """K1 over the recorded GEMMs (CUDA events, median of REPS per distinct
    GEMM, times the calls of it): the kernel, its plain version, one
    PyTorch call in the same types as the yardstick (``torch.matmul``, then
    the bias and the activation), and the bound at the bf16 tensor-core
    peak; also the FLOP the calls do."""
    totals = {**new_totals(), "flop": 0.0}
    for (m, n, k, dtype, act, has_bias, out_dtype), count in \
            collections.Counter(calls).items():
        a = torch.randn(m, k, device=DEVICE, generator=g).to(dtype)
        b = torch.randn(k, n, device=DEVICE, generator=g).to(dtype)
        bias = torch.randn(n, device=DEVICE, generator=g) if has_bias \
            else None
        kw = dict(bias=bias, activation=act, out_dtype=out_dtype)

        def library():
            y = torch.matmul(a, b)
            if bias is not None:
                y = y + bias
            return (y if act is None else act(y)).to(out_dtype)

        bound_ms, bound_by = gemm_bound(
            m, n, k, a.element_size(),
            torch.empty((), dtype=out_dtype).element_size(), BF16_PEAK_FLOPS)
        add_times(totals, {
            "ms": median_ms(lambda: tiled_matmul(a, b, **kw)),
            "plain_ms": median_ms(lambda: tiled_mm_ref(a, b, **kw)),
            "library_ms": median_ms(library), "bound_ms": bound_ms,
            "bound_by": bound_by}, count)
        totals["flop"] += 2.0 * m * n * k * count
    return totals


def phase_lm_gemm_times(card: str, lm: dict) -> dict:
    """Phase 5, slice 5: K1 on the LM paths.  One more prefill and one
    more decode step run on K1 through a ShapeEngine pinned with
    ``engine_scope`` (their launches are not the main path's); each
    recorded GEMM is then timed by :func:`lm_gemm_times`.  Per prefill and
    per decode step: K1, its plain version, ``torch.matmul`` and the bound
    (prefill: the bf16 products; decode: the bytes of the weights), and
    K1's achieved TFLOP/s."""
    cfg, params, tokens = lm["cfg"], lm["params"], lm["tokens"]
    g = torch.Generator(device=DEVICE).manual_seed(17)
    cache = init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=DEVICE)
    stages = {
        "lm_prefill": lambda: prefill_fn(cfg, params, tokens=tokens),
        "lm_decode": lambda: decode_fn(cfg, params, cache, tokens[:, -1:],
                                       LM_PROMPT)}
    calls = {"lm_prefill": lm["per_prefill"]["tiled_mm"],
             "lm_decode": lm["decode"]["launches_per_step"]["tiled_mm"]}
    out = {}
    for stage, fn in stages.items():
        rec = ShapeEngine()
        with engine_scope(rec):
            fn()
        want = calls[stage]
        if len(rec.calls) != want:
            raise AssertionError(f"{stage}: recorded {len(rec.calls)} GEMMs, "
                                 f"expected {want}")
        t = lm_gemm_times(rec.calls, g)
        out[stage] = {**summary(t), "tflops": 1e-9 * t["flop"] / t["ms"],
                      "gemms": len(rec.calls),
                      "shapes": sorted({c[:3] for c in rec.calls})}
        label = "prefill" if stage == "lm_prefill" else "decode step"
        emit({"lm_gemms": stage, **out[stage], "peak": BF16_NOTE,
              "library": "torch.matmul (+ bias, activation)",
              "per": f"one {LM_ARCH} {label} of {LM_BATCH} requests: "
                     f"per-GEMM medians (CUDA events) times the calls",
              "card": card})
        print(f"tiled_mm on the {stage}: {t['ms']:.3f} ms over "
              f"{len(rec.calls)} GEMMs, {out[stage]['tflops']:.1f} TFLOP/s; "
              f"torch.matmul {t['library_ms']:.3f} ms, bound "
              f"{t['bound_ms']:.3f} ms ({out[stage]['bound_by']})",
              flush=True)
    return out


def to_device(tree):
    """A parameter tree of tensors, moved to the card."""
    if isinstance(tree, dict):
        return {k: to_device(v) for k, v in tree.items()}
    return tree.to(DEVICE)


def phase_reduced_lm() -> list:
    """Phase 4, slice 5: each REDUCED_ARCHS config (``reduced()``: head dim
    16, SSM head dim 16, state 16, chunk 16; fp32) prefills 2 x 70 tokens
    on the card, counts set to 0 just before and read just after: K4 once
    per attention application, K5 once per SSM layer.  The logits must
    come within REDUCED_TOL of the same prefill on the CPU."""
    results = []
    for arch, n_layers in REDUCED_ARCHS:
        cfg = reduced(ARCHS[arch], n_layers=n_layers)
        params = init_model(cfg, 0, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 70),
                               generator=torch.Generator().manual_seed(16))
        want = prefill_fn(cfg, params, tokens=tokens)
        dev_params = to_device(params)
        reset_launches()
        got = prefill_fn(cfg, dev_params, tokens=tokens.to(DEVICE))
        torch.cuda.synchronize()
        groups = n_layers // cfg.attn_every if cfg.attn_every else 0
        counts = expect_counts(f"reduced {arch} prefill",
                               {"flash_attention": groups, "ssd": n_layers})
        counts["tiled_mm"] = tiled_matmul.launches
        if counts["tiled_mm"] == 0:
            raise AssertionError(f"reduced {arch} prefill launched no K1")
        torch.testing.assert_close(got.cpu(), want, rtol=REDUCED_TOL,
                                   atol=REDUCED_TOL)
        err = (got.cpu() - want).abs().max().item()
        results.append({"arch": arch, "n_layers": n_layers,
                        "head_dim": cfg.resolved_head_dim,
                        "ssm": [cfg.ssm_head_dim, cfg.ssm_state,
                                cfg.ssm_chunk],
                        "launches": counts, "max_abs_diff_vs_cpu": err,
                        "tol": REDUCED_TOL})
        print(f"reduced {arch} ({n_layers} layers, head dim "
              f"{cfg.resolved_head_dim}, SSM P/N/chunk {cfg.ssm_head_dim}/"
              f"{cfg.ssm_state}/{cfg.ssm_chunk}) prefill on the card: "
              f"launches {counts}, logits max |diff| vs the CPU {err:.3g}",
              flush=True)
    emit({"reduced_prefill": results})
    return results


def phase_lm_profile(card: str, lm: dict) -> dict:
    """Phase 5, slice 4: one prefill and one decode step (after the main
    path's) under ``torch.profiler``: each kernel's device time and
    launches, and the share of the wall time in which any kernel ran.
    Returns the prefill's ``{kernel: {"count", "device_ms"}}``; each
    stage's device busy time goes to ``lm["device_busy_ms"]``."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params, tokens = lm["cfg"], lm["params"], lm["tokens"]
    cache = init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=DEVICE)
    tok = tokens[:, -1:]
    stages = {
        "prefill": lambda: prefill_fn(cfg, params, tokens=tokens),
        "decode step": lambda: decode_fn(cfg, params, cache, tok, LM_PROMPT)}
    found = {}
    for stage, fn in stages.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = timed(fn)
        kernels, others, intervals = {}, {}, []
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = (ev.time_range.end - ev.time_range.start) / 1e3
            name = kernel_name(ev.name)
            for table, key in ((kernels, name),) + (
                    ((others, ev.name[:80]),) if name == "other" else ()):
                k = table.setdefault(key, {"count": 0, "device_ms": 0.0})
                k["count"] += 1
                k["device_ms"] += ms
            intervals.append((ev.time_range.start, ev.time_range.end))
        busy_ms = union_us(intervals) / 1e3 if intervals else None
        top = sorted(others.items(), key=lambda kv: -kv[1]["device_ms"])[:8]
        emit({"profile": f"one {LM_ARCH} {stage}, {LM_BATCH} requests",
              "wall_ms_under_profiler": 1e3 * wall, "kernels": kernels,
              "other_top": dict(top),
              "device_busy_ms": busy_ms,
              "device_busy_share": None if busy_ms is None
              else busy_ms / (1e3 * wall), "card": card})
        found[stage] = kernels
        lm.setdefault("device_busy_ms", {})[stage] = busy_ms
    return found["prefill"]


def serve_requests(cfg, n: int = SERVE_REQUESTS, prompt: int = SERVE_PROMPT,
                   new: int = SERVE_NEW) -> list:
    """``n`` requests of ``prompt`` token ids (CPU int32, seeded) asking
    for ``new`` tokens each."""
    toks = torch.randint(0, cfg.vocab_size, (n, prompt), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(22))
    return [Request(i, toks[i].clone(), new) for i in range(n)]


def record_decode_gemms(rt, qeng) -> list:
    """Wrap ``rt.submit_gemm`` so that each decode-GEMM submission is kept
    as (A, W, act scale, future): the scale is the one ``qeng`` (the
    pool's int8 engine, or None) publishes for the GEMM's (k, n) just
    before the submit, which the runtime's int8 split reads (None: fp32).
    Only the serving thread feeds that calibrator, and only at reap."""
    log, submit = [], rt.submit_gemm

    def recorded(a, b, **kw):
        scale = (None if qeng is None
                 or not kw["jobset"].name.startswith("decode/")
                 else qeng.act_scale_for(*b.shape))
        fut = submit(a, b, **kw)
        if kw["jobset"].name.startswith("decode/"):
            log.append((a, b, scale, fut))
        return fut

    rt.submit_gemm = recorded
    return log


def check_decode_gemms(log: list, qeng) -> dict:
    """Every recorded decode GEMM's result against its plain version on
    the same inputs: an fp32 one (K1/K3 row panels) within
    fp32_tol(k) of ``tiled_mm_ref``, an int8 one (K2's exact int32 panels,
    dequantized at the recorded scale) BITWISE the raw ``qmm_ref`` through
    the same ``dequant_finish``.  Returns the counts and the fp32 max
    |err|; raises on a mismatch."""
    out = {"fp32": 0, "int8": 0, "max_abs_err": 0.0}
    if not log:
        raise AssertionError("serving: no decode GEMM was submitted")
    for a, b, scale, fut in log:
        got = fut.result(SERVE_TIMEOUT)
        if scale is None:
            want = tiled_mm_ref(a, b)
            tol = fp32_tol(b.shape[0])
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            out["max_abs_err"] = max(out["max_abs_err"],
                                     (got - want).abs().max().item())
            out["fp32"] += 1
        else:
            qw = qeng.quantized(b)
            acc = qmm_ref(quantize_activations(a, scale), qw.q, qw.scale,
                          fuse_dequant=False)
            want = dequant_finish(acc, qw, act_scale=scale,
                                  out_dtype=torch.float32)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"serving: int8 decode GEMM {tuple(a.shape)} x "
                    f"{tuple(b.shape)} differs from qmm_ref by "
                    f"{(got - want).abs().max().item():.3g}")
            out["int8"] += 1
    return out


def serve_run(cfg, params: dict, pool: list, device: str | None = None,
              n: int = SERVE_REQUESTS, new: int = SERVE_NEW,
              retry: RetryPolicy | None = None, **kw) -> dict:
    """One server over a fresh ``SynergyRuntime(pool)``: ``n`` requests
    submitted and run to the end (``run()`` drains the in-flight
    window), launch counts set to 0 just before the submits and read just
    after the final synchronize; then every decode GEMM of the run held
    against its plain version (check_decode_gemms).  Returns the tokens,
    the decode-GEMM outputs and that check, the counts, the stats and the
    times: wall and the serving thread's own CPU time
    (``time.thread_time``).  ``device`` defaults to DEVICE; ``retry`` is
    the runtime's RetryPolicy."""
    device = device or DEVICE
    reqs = serve_requests(cfg, n=n, new=new)
    qeng = (get_engine("cuda-tiled-int8") if "cuda-tiled-int8" in pool
            else None)
    with SynergyRuntime(pool, name="serving", device=device,
                        retry=retry) as rt:
        log = record_decode_gemms(rt, qeng)
        srv = SynergyServer(cfg, params, slots=SERVE_SLOTS,
                            max_len=SERVE_MAX_LEN, prefill_len=SERVE_PROMPT,
                            runtime=rt, submit_timeout=SERVE_TIMEOUT,
                            keep_decode_outputs=True, device=device, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        reset_launches()
        cpu0, t0 = time.thread_time(), time.perf_counter()
        for r in reqs:
            srv.submit(r)
        stats = srv.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host = time.thread_time() - cpu0
        counts = launch_counts()
        steals = rt.stats()["total_steals"]
        checked = check_decode_gemms(log, qeng)
    generated = sum(len(r.out) for r in reqs)
    return {"tokens": [list(r.out) for r in reqs],
            "outputs": srv.decode_gemm_outputs, "checked": checked,
            "launches": counts,
            "stats": stats, "steals": steals, "wall_s": wall,
            "generated": generated,
            "figures": {
                "tokens_per_s": generated / wall,
                "decode_tokens_per_s": stats.tokens_out / wall,
                "ms_per_engine_step": 1e3 * wall / stats.engine_steps,
                "host_us_per_engine_step": 1e6 * host / stats.engine_steps,
                "wall_s": wall, "host_s": host}}


def serve_profile(cfg, params: dict) -> dict:
    """The card's busy share of one decode step (``decode_step`` and the
    coalesced decode GEMM, drained) under ``torch.profiler``, on a
    wave-batched server over ``SynergyRuntime(POOL)`` whose first wave is
    admitted and whose first decode step warms up, both unprofiled."""
    reqs = serve_requests(cfg, n=SERVE_SLOTS)
    with SynergyRuntime(POOL, name="serving-profile", device=DEVICE) as rt:
        srv = SynergyServer(cfg, params, slots=SERVE_SLOTS,
                            max_len=SERVE_MAX_LEN, prefill_len=SERVE_PROMPT,
                            runtime=rt, submit_timeout=SERVE_TIMEOUT,
                            device=DEVICE)
        for r in reqs:
            srv.submit(r)
        for _ in range(2):               # the admission, a warm-up step
            srv.step()
            srv.drain()
        torch.cuda.synchronize()
        kernels, busy_ms, wall = profiled_run(
            lambda: (srv.step(), srv.drain()))
        srv.run()
    return {"wall_ms_under_profiler": 1e3 * wall, "kernels": kernels,
            "device_busy_ms": busy_ms,
            "device_busy_share": None if busy_ms is None
            else busy_ms / (1e3 * wall)}


def phase_serving(card: str, lm: dict) -> dict:
    """Slice 8: the continuous-batching server (``core/serving.py``) on
    ``lm``'s LM_ARCH at full width (its params, on the card), SERVE_SLOTS
    slots, max_len SERVE_MAX_LEN, the default MNIST prefill CNN, over
    ``SynergyRuntime(POOL)`` and, for the int8 runs, ``QPOOL``: the
    SERVE_RUNS in turn, each with counts set to 0 just before and read
    just after.  Every run must give each request the first run's tokens;
    each SERVE_BITWISE pair's decode-GEMM outputs must be bitwise; the fp32
    runs launch K1 and K3 and never K2, the int8 runs launch K2, and no
    run launches K4 or K5 (the prompt replay is ``decode_step``).  Both
    int8 runs start from one calibrator state in which the decode GEMM's
    scale is published (the fp32 runs fed it through their decode
    hint).  Every decode GEMM of every run is held against its plain
    version on its own inputs (check_decode_gemms: fp32 within
    fp32_tol(k) of tiled_mm_ref, int8 bitwise qmm_ref).  Then the dense
    real-FFN check (phase_serving_dense); then one decode step under the
    profiler.  Prints tokens/s, ms and host µs per engine step
    and the busy share beside the card, and the seconds each part took.
    Returns each run's launches, the first run's tokens and
    ``tokens_out``, and the calibrator state the int8 runs start from."""
    t_phase = time.perf_counter()
    cfg, params = lm["cfg"], lm["params"]
    qeng = get_engine("cuda-tiled-int8")
    key = qeng.act_key(cfg.d_model, 4 * cfg.d_model)
    runs, q_state = {}, None
    for name, pool, kw in SERVE_RUNS:
        if pool is QPOOL:
            if q_state is None:
                if qeng.act_scale_for(*key) is None:
                    raise AssertionError(f"serving: no published int8 scale "
                                         f"for the decode GEMM {key}")
                q_state = qeng.calibrator.export_state()
            qeng.calibrator.import_state(q_state)
        run = serve_run(cfg, params, pool, **kw)
        counts = run["launches"]
        if counts["flash_attention"] or counts["ssd"]:
            raise AssertionError(f"serving ({name}) launched K4/K5: {counts}")
        if pool is QPOOL:
            if counts["qmm"] == 0 or counts["tiled_mm"] == 0:
                raise AssertionError(f"serving ({name}): launches {counts}")
        elif (counts["tiled_mm"] == 0 or counts["vpu_mm"] == 0
                or counts["qmm"] != 0):
            raise AssertionError(f"serving ({name}): launches {counts}")
        first = next(iter(runs.values()), run)
        if run["tokens"] != first["tokens"]:
            raise AssertionError(f"serving ({name}): tokens differ from "
                                 f"{SERVE_RUNS[0][0]}")
        if (run["generated"] != SERVE_REQUESTS * SERVE_NEW
                or run["stats"].prefills != SERVE_REQUESTS):
            raise AssertionError(f"serving ({name}): {run['generated']} "
                                 f"tokens, {run['stats'].prefills} prefills")
        runs[name] = run
        st = run["stats"]
        print(f"serving ({name}): {st.prefill_waves} waves, "
              f"{st.engine_steps} engine steps, {st.decode_steps} decode "
              f"steps, {st.prefill_chunks} chunks, launches {counts}; "
              f"decode GEMMs vs plain {run['checked']}; "
              f"{run['figures']['tokens_per_s']:.1f} tokens/s, "
              f"{run['figures']['ms_per_engine_step']:.1f} ms and "
              f"{run['figures']['host_us_per_engine_step']:.0f} host µs "
              f"per engine step", flush=True)
    for a, b in SERVE_BITWISE:
        ya, yb = runs[a]["outputs"], runs[b]["outputs"]
        if len(ya) != len(yb) or not ya or any(
                x.shape != y.shape or not torch.equal(x, y)
                for x, y in zip(ya, yb)):
            raise AssertionError(f"serving: decode-GEMM outputs of {a!r} "
                                 f"and {b!r} are not bitwise equal")
        if not all(bool(torch.isfinite(x).all()) for x in ya):
            raise AssertionError(f"serving ({a}): decode GEMM not finite")
    runs_s = time.perf_counter() - t_phase
    dense = phase_serving_dense()
    dense_s = time.perf_counter() - t_phase - runs_s
    profile = serve_profile(cfg, params)
    phase_s = time.perf_counter() - t_phase
    emit({"serving": LM_ARCH, "slots": SERVE_SLOTS,
          "max_len": SERVE_MAX_LEN, "requests": SERVE_REQUESTS,
          "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
          "prefill_cnn": "MNIST",
          "runs": [{"run": name, "pool": pool,
                    "launches": runs[name]["launches"],
                    "engine_steps": runs[name]["stats"].engine_steps,
                    "decode_steps": runs[name]["stats"].decode_steps,
                    "prefill_waves": runs[name]["stats"].prefill_waves,
                    "prefill_chunks": runs[name]["stats"].prefill_chunks,
                    "decode_stall_steps":
                        runs[name]["stats"].decode_stall_steps,
                    "runtime_jobs": runs[name]["stats"].runtime_jobs,
                    "precision_jobs": runs[name]["stats"].precision_jobs,
                    "steals": runs[name]["steals"],
                    "decode_gemms_vs_plain": runs[name]["checked"],
                    **runs[name]["figures"]}
                   for name, pool, _ in SERVE_RUNS],
          "tokens": runs[SERVE_RUNS[0][0]]["tokens"],
          "bitwise_pairs": SERVE_BITWISE, "dense_check": dense,
          "profile": {"one decode step": profile},
          "seconds": {"runs": runs_s, "dense_check": dense_s,
                      "profile": phase_s - runs_s - dense_s,
                      "phase": phase_s},
          "timer": "host clock from the first submit to the synchronize "
                   "after run(); host = the serving thread's CPU time",
          "card": card})
    print(f"serving: {len(SERVE_RUNS)} runs of {LM_ARCH} at full width, "
          f"every request's tokens equal across runs, decode GEMMs bitwise "
          f"in {SERVE_BITWISE}; busy share of a decode step "
          f"{profile['device_busy_share']}; runs {runs_s:.1f} s, dense "
          f"check {dense_s:.1f} s, phase {phase_s:.1f} s; card {card}",
          flush=True)
    return {"launches": {name: runs[name]["launches"]
                         for name, _, _ in SERVE_RUNS},
            "tokens": {name: runs[name]["tokens"] for name, _, _ in SERVE_RUNS},
            "tokens_out": {name: runs[name]["stats"].tokens_out
                           for name, _, _ in SERVE_RUNS},
            "q_state": q_state, "dense": dense}


def dense_model() -> tuple:
    """SERVE_DENSE reduced, its LM params and the MNIST prefill CNN's, on
    the CPU, from seed 0."""
    arch, n_layers = SERVE_DENSE
    cfg = reduced(ARCHS[arch], n_layers=n_layers)
    params = init_model(cfg, 0, device="cpu")
    cnn = init_cnn(PAPER_CNNS["MNIST"], torch.Generator().manual_seed(0),
                   device="cpu")
    return cfg, params, cnn


def phase_serving_dense() -> dict:
    """Slice 8, the real-FFN decode GEMM: SERVE_DENSE reduced (the
    stacked-``wi`` decode weight) served over ``SynergyRuntime(POOL)`` on
    the CPU (batched) and on the card (batched and per-slot) with the same
    LM and CNN weights, one wave of SERVE_SLOTS requests: equal tokens per
    request, the card's batched decode-GEMM outputs BITWISE its per-slot
    ones and within 1e-5·sqrt(d_model) of the CPU's, K1 launched on the
    card and no kernel on the CPU."""
    arch, n_layers = SERVE_DENSE
    cfg, params, cnn = dense_model()
    cpu = serve_run(cfg, params, POOL, device="cpu", cnn_params=cnn,
                    n=SERVE_SLOTS)
    card, slot = (serve_run(cfg, to_device(params), POOL,
                            cnn_params=to_device(cnn), n=SERVE_SLOTS,
                            decode_mode=mode)
                  for mode in ("batched", "per-slot"))
    if not card["tokens"] == slot["tokens"] == cpu["tokens"]:
        raise AssertionError(f"serving dense {arch}: the card's tokens "
                             f"(batched, per-slot) differ from the CPU's")
    if not (len(card["outputs"]) == len(slot["outputs"])
            == len(cpu["outputs"]) > 0):
        raise AssertionError(f"serving dense {arch}: decode outputs "
                             f"{len(card['outputs'])}, "
                             f"{len(slot['outputs'])} vs "
                             f"{len(cpu['outputs'])}")
    tol = fp32_tol(cfg.d_model)
    err = 0.0
    for got, per_slot, want in zip(card["outputs"], slot["outputs"],
                                   cpu["outputs"]):
        if not torch.equal(got, per_slot):
            raise AssertionError(f"serving dense {arch}: batched and "
                                 f"per-slot decode GEMMs differ on the card")
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
        err = max(err, (got.cpu() - want).abs().max().item())
    if card["launches"]["tiled_mm"] == 0 or slot["launches"]["tiled_mm"] == 0:
        raise AssertionError(f"serving dense {arch}: no K1 launch")
    if any(cpu["launches"].values()):
        raise AssertionError(f"serving dense {arch}: the CPU run launched "
                             f"kernels {cpu['launches']}")
    print(f"serving dense {arch} ({n_layers} layers, decode GEMM "
          f"{cfg.d_model} x {n_layers * 2 * cfg.d_ff}): tokens equal on the "
          f"card (batched, per-slot) and the CPU, card decode GEMMs bitwise "
          f"across modes, max |diff| to the CPU {err:.3g} (tol {tol:.3g}); "
          f"card launches {card['launches']}, {slot['launches']}",
          flush=True)
    return {"arch": arch, "n_layers": n_layers, "max_abs_diff": err,
            "tol": tol, "launches": card["launches"],
            "per_slot_launches": slot["launches"],
            "cpu_launches": cpu["launches"],
            "decode_steps": card["stats"].decode_steps,
            "tokens": card["tokens"]}


def serving_launches(serving: dict, name: str) -> dict:
    """A kernel's launches in each of phase_serving's runs."""
    return {"launches": {run: counts[name]
                         for run, counts in serving["launches"].items()},
            "per": (f"each {LM_ARCH} serving run: {SERVE_REQUESTS} requests "
                    f"of {SERVE_PROMPT} + {SERVE_NEW} tokens, "
                    f"{SERVE_SLOTS} slots")}


def durability_launches(durability: dict, name: str) -> dict:
    """A kernel's launches in each of phase_durability's restored runs."""
    return {"launches": {run: counts[name] for run, counts
                         in durability["launches"].items()},
            "per": (f"each {LM_ARCH} durability run, from the restore "
                    f"(snapshot load and journal replay) to the end")}


def timed_snapshots(srv) -> list:
    """Wrap ``srv.snapshot`` (which ``step()`` calls on its cadence) so
    that each snapshot's wall seconds are kept in the returned list."""
    times, snapshot = [], srv.snapshot

    def timed():
        t0 = time.perf_counter()
        step = snapshot()
        times.append(time.perf_counter() - t0)
        return step

    srv.snapshot = timed
    return times


def snapshot_figures(srv, times: list) -> dict:
    """A durable server's snapshots so far: how many, the last one's
    bytes, and ms per snapshot in all (the window reaped, the pool
    quiesced, the save) and of its two parts on the serving thread: the
    host copy and the wait on the previous snapshot's writer."""
    ck, n = srv._ck, max(1, len(times))
    return {"snapshots": len(times), "bytes": ck.last_bytes,
            "ms_per_snapshot": 1e3 * sum(times) / n,
            "host_copy_ms": 1e3 * ck.copy_s / n,
            "writer_wait_ms": 1e3 * ck.wait_s / n}


def journal_streams(path: str) -> dict:
    """Each request's tokens as the journal delivered them: its "first"
    token, then its "tok" tokens, in order."""
    out: dict = {}
    for rec in RequestJournal.scan(path)[0]:
        if rec["t"] in ("first", "tok"):
            for rid, _, tok in rec["e"]:
                out.setdefault(rid, []).append(tok)
    return out


def durable_run(cfg, params: dict, pool: list, workdir: str) -> dict:
    """One crash and restore of the serving runs' server over ``pool``:
    SERVE_REQUESTS requests served with ``Durability(workdir)`` until the
    CrashPlan fires at DUR_CRASH_AT; that server's runtime shut down; then
    ``SynergyServer.restore`` on a fresh runtime, run to the end, launch
    counts set to 0 just before the restore and read just after the final
    synchronize, and every decode GEMM from the restore on held against
    its plain version (check_decode_gemms).  Returns the tokens, counts,
    stats and the snapshot and restore figures."""
    reqs = serve_requests(cfg)
    qeng = (get_engine("cuda-tiled-int8") if "cuda-tiled-int8" in pool
            else None)
    d = Durability(workdir, snapshot_every=DUR_SNAPSHOT_EVERY, keep=DUR_KEEP)
    kw = dict(slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
              prefill_len=SERVE_PROMPT, submit_timeout=SERVE_TIMEOUT,
              device=DEVICE)
    with SynergyRuntime(pool, name="durable", device=DEVICE) as rt:
        srv = SynergyServer(cfg, params, runtime=rt, durable=d,
                            crash_plan=CrashPlan(at_step=DUR_CRASH_AT), **kw)
        times = timed_snapshots(srv)
        try:
            for r in reqs:
                srv.submit(r)
            srv.run()
        except SimulatedCrash:
            pass
        else:
            raise AssertionError("durability: the CrashPlan never fired")
        live = sum(r is not None for r in srv.slot_req)
        queued = len(srv.pending)
        if not (srv.stats.snapshots and live and queued):
            raise AssertionError(
                f"durability: at the crash {srv.stats.snapshots} snapshots, "
                f"{live} live slots, {queued} queued requests")
        crashed = snapshot_figures(srv, times)
        srv._ck.wait()          # a killed process's writer dies with it
    with SynergyRuntime(pool, name="durable-restored", device=DEVICE) as rt:
        log = record_decode_gemms(rt, qeng)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        srv2 = SynergyServer.restore(cfg, params, durable=d, runtime=rt, **kw)
        times2 = timed_snapshots(srv2)
        stats = srv2.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        restored = snapshot_figures(srv2, times2)
        srv2._ck.wait()
        checked = check_decode_gemms(log, qeng)
    got = {rid: list(r.out) for rid, r in srv2.restored_requests.items()}
    return {"tokens": [got.get(r.rid, list(r.out)) for r in reqs],
            "launches": counts, "stats": stats, "checked": checked,
            "at_crash": {"engine_steps": DUR_CRASH_AT, "live": live,
                         "queued": queued, **crashed},
            "restored": restored, "restore_wall_s": wall,
            "restore_ms": {k: 1e3 * v
                           for k, v in srv2.restore_seconds.items()}}


def kill_child(workdir: str) -> None:
    """The child process of phase_durability's real kill: SERVE_DENSE on
    the card over ``SynergyRuntime(POOL)`` with ``Durability(workdir)``,
    DUR_KILL_REQUESTS requests, one line per engine step.  It is meant
    to be SIGKILLed; it prints DONE if it is not."""
    cfg, params, cnn = dense_model()
    d = Durability(workdir, snapshot_every=DUR_SNAPSHOT_EVERY, keep=DUR_KEEP)
    with SynergyRuntime(POOL, name="durable-child", device=DEVICE) as rt:
        srv = SynergyServer(cfg, to_device(params), runtime=rt,
                            cnn_params=to_device(cnn), durable=d,
                            slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                            prefill_len=SERVE_PROMPT,
                            submit_timeout=SERVE_TIMEOUT, device=DEVICE)
        for r in serve_requests(cfg, n=DUR_KILL_REQUESTS, new=DUR_KILL_NEW):
            srv.submit(r)
        while srv.step():
            print("step", srv.stats.engine_steps, flush=True)
        srv.close()
    print("DONE", flush=True)


def durable_kill() -> dict:
    """One real kill, at the reduced size: ``kill_child`` in a child
    process (``python3 -c``, the port only), SIGKILLed once its journal
    holds DUR_KILL_TOKEN_RECORDS token records; then ``restore`` on the
    card from its directory, run to the end.  Every request's tokens — as
    the journal delivered them, once each, across the kill — must equal
    the card's uninterrupted run of the same server (serve_run)."""
    cfg, params, cnn = dense_model()
    params, cnn = to_device(params), to_device(cnn)
    ref = serve_run(cfg, params, POOL, n=DUR_KILL_REQUESTS,
                    new=DUR_KILL_NEW, cnn_params=cnn)
    workdir = tempfile.mkdtemp(prefix="durable-kill-")
    try:
        d = Durability(workdir, snapshot_every=DUR_SNAPSHOT_EVERY,
                       keep=DUR_KEEP)
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-c", KILL_CHILD, str(ROOT), workdir],
            stdout=subprocess.PIPE, text=True)
        watchdog = threading.Timer(DUR_KILL_TIMEOUT, child.kill)
        watchdog.start()
        records, killed_at = 0, None
        try:
            for line in child.stdout:
                if line.startswith("DONE"):
                    break
                records = sum(r["t"] == "tok" for r in
                              RequestJournal.scan(d.journal_path)[0])
                if records >= DUR_KILL_TOKEN_RECORDS:
                    killed_at = line.split()[-1]
                    child.send_signal(signal.SIGKILL)
                    break
            child.wait(timeout=DUR_KILL_TIMEOUT)
        finally:
            watchdog.cancel()
            if child.poll() is None:
                child.kill()
                child.wait()
            child.stdout.close()
        child_s = time.perf_counter() - t0
        if killed_at is None or child.returncode != -signal.SIGKILL:
            raise AssertionError(f"durability kill: the child was not "
                                 f"killed mid-run (rc {child.returncode}, "
                                 f"{records} token records)")
        _, end, torn = RequestJournal.scan(d.journal_path)
        torn_bytes = os.path.getsize(d.journal_path) - end
        with SynergyRuntime(POOL, name="durable-kill", device=DEVICE) as rt:
            srv = SynergyServer.restore(
                cfg, params, durable=d, runtime=rt, cnn_params=cnn,
                slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                prefill_len=SERVE_PROMPT, submit_timeout=SERVE_TIMEOUT,
                device=DEVICE)
            if srv._journal.truncated_bytes != torn_bytes:
                raise AssertionError(
                    f"durability kill: restore truncated "
                    f"{srv._journal.truncated_bytes} bytes, the scan found "
                    f"{torn_bytes}")
            srv.run()
            srv._ck.wait()
        streams = journal_streams(d.journal_path)
        want = {i: toks for i, toks in enumerate(ref["tokens"])}
        if streams != want:
            raise AssertionError("durability kill: the journal's streams "
                                 "differ from the uninterrupted run's")
        for rid, r in srv.restored_requests.items():
            if list(r.out) != want[rid]:
                raise AssertionError(f"durability kill: request {rid}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"killed_after_step": int(killed_at), "token_records": records,
            "torn_tail_bytes": torn_bytes, "torn": torn,
            "replayed_tokens": srv.stats.replayed_tokens,
            "restores": srv.stats.restores,
            "restore_ms": {k: 1e3 * v
                           for k, v in srv.restore_seconds.items()},
            "child_s": child_s}


def phase_durability(card: str, lm: dict, serving: dict) -> dict:
    """Slice 9: durable serving (``soc/durable.py``, ``checkpoint/`` and
    the journal, snapshots and restore of ``core/serving.py``) on the
    serving phase's zamba2-2.7b server at full width: for each DUR_RUNS
    pool, a crash at DUR_CRASH_AT and a restore on a fresh runtime
    (durable_run; the int8 run from the calibrator state the serving
    phase's int8 runs started from).  Each request's tokens must equal the
    serving run's; ``tokens_out + replayed_tokens`` its ``tokens_out``,
    ``restores`` 1; from the restore on, fp32 launches K1 and K3 and not
    K2, int8 launches K2, neither K4 nor K5, and every decode GEMM is held
    against its plain version.  Then one real SIGKILL at the reduced size
    (durable_kill).  Prints the snapshot bytes and ms (host copy, wait on
    the writer), the restore ms (load, replay), the replayed tokens and
    jobs and the phase's seconds, beside the card."""
    t_phase = time.perf_counter()
    cfg, params = lm["cfg"], lm["params"]
    qeng = get_engine("cuda-tiled-int8")
    print(f"durability: CrashPlan(at_step={DUR_CRASH_AT}), snapshots every "
          f"{DUR_SNAPSHOT_EVERY} steps, keep {DUR_KEEP}", flush=True)
    runs = {}
    for name, pool in DUR_RUNS:
        if pool is QPOOL:
            qeng.calibrator.import_state(serving["q_state"])
        workdir = tempfile.mkdtemp(prefix="durable-")
        try:
            run = durable_run(cfg, params, pool, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        st, counts = run["stats"], run["launches"]
        if run["tokens"] != serving["tokens"][name]:
            raise AssertionError(f"durability ({name}): restored tokens "
                                 f"differ from the serving run's")
        if (st.tokens_out + st.replayed_tokens != serving["tokens_out"][name]
                or st.restores != 1 or not st.replayed_tokens):
            raise AssertionError(
                f"durability ({name}): tokens_out {st.tokens_out} + "
                f"replayed {st.replayed_tokens} vs "
                f"{serving['tokens_out'][name]}, restores {st.restores}")
        if counts["flash_attention"] or counts["ssd"]:
            raise AssertionError(f"durability ({name}) launched K4/K5: "
                                 f"{counts}")
        if pool is QPOOL:
            if counts["qmm"] == 0:
                raise AssertionError(f"durability ({name}): launches {counts}")
        elif (counts["tiled_mm"] == 0 or counts["vpu_mm"] == 0
                or counts["qmm"] != 0):
            raise AssertionError(f"durability ({name}): launches {counts}")
        runs[name] = run
        print(f"durability ({name}): crashed at step {DUR_CRASH_AT} with "
              f"{run['at_crash']['live']} live, {run['at_crash']['queued']} "
              f"queued, {run['at_crash']['snapshots']} snapshots of "
              f"{run['at_crash']['bytes']} bytes, "
              f"{run['at_crash']['ms_per_snapshot']:.1f} ms each (host copy "
              f"{run['at_crash']['host_copy_ms']:.1f}, writer wait "
              f"{run['at_crash']['writer_wait_ms']:.1f}); restore load "
              f"{run['restore_ms']['load']:.1f} ms, replay "
              f"{run['restore_ms']['replay']:.1f} ms, {st.replayed_tokens} "
              f"tokens and {st.replayed_jobs} jobs replayed; tokens equal "
              f"the serving run's; launches from the restore {counts}; "
              f"decode GEMMs vs plain {run['checked']}; card {card}",
              flush=True)
    runs_s = time.perf_counter() - t_phase
    kill = durable_kill()
    phase_s = time.perf_counter() - t_phase
    emit({"durability": LM_ARCH, "crash_at": DUR_CRASH_AT,
          "snapshot_every": DUR_SNAPSHOT_EVERY, "keep": DUR_KEEP,
          "runs": [{"run": name, "pool": pool,
                    "launches": runs[name]["launches"],
                    "at_crash": runs[name]["at_crash"],
                    "restored_snapshots": runs[name]["restored"],
                    "restore_ms": runs[name]["restore_ms"],
                    "restore_to_end_s": runs[name]["restore_wall_s"],
                    "tokens_out": runs[name]["stats"].tokens_out,
                    "replayed_tokens": runs[name]["stats"].replayed_tokens,
                    "replayed_jobs": runs[name]["stats"].replayed_jobs,
                    "decode_gemms_vs_plain": runs[name]["checked"]}
                   for name, pool in DUR_RUNS],
          "kill": {"arch": SERVE_DENSE[0], "n_layers": SERVE_DENSE[1],
                   "requests": DUR_KILL_REQUESTS, "new_tokens": DUR_KILL_NEW,
                   **kill},
          "seconds": {"runs": runs_s, "kill": phase_s - runs_s,
                      "phase": phase_s},
          "timer": "host clock; snapshot ms per snapshot() call, restore "
                   "ms inside SynergyServer.restore",
          "card": card})
    print(f"durability: {len(DUR_RUNS)} crash/restore runs of {LM_ARCH} at "
          f"full width restored to the serving tokens; {SERVE_DENSE[0]} "
          f"child SIGKILLed after step {kill['killed_after_step']} "
          f"({kill['token_records']} token records), torn tail "
          f"{kill['torn_tail_bytes']} bytes, {kill['replayed_tokens']} "
          f"tokens replayed, restore load {kill['restore_ms']['load']:.1f} "
          f"ms, replay {kill['restore_ms']['replay']:.1f} ms, tokens equal "
          f"the uninterrupted run's; runs {runs_s:.1f} s, phase "
          f"{phase_s:.1f} s; card {card}", flush=True)
    return {"launches": {name: runs[name]["launches"]
                         for name, _ in DUR_RUNS}}


def norm_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| (inf when want is all zero)."""
    den = float(torch.linalg.vector_norm(want.float()))
    num = float(torch.linalg.vector_norm(got.float() - want.float()))
    return num / den if den else math.inf


def grads_of(out: tuple, upstream: tuple, inputs: tuple) -> tuple:
    return torch.autograd.grad(out, inputs, upstream, retain_graph=True)


def phase_kernel_backward(card: str) -> dict:
    """Phase 3, slice 10: K4's and K5's backward on the card.  At every
    BWD_FA_CASES / BWD_SSD_CASES shape, the input gradients of
    ``flash_attention_cuda`` and ``ssd(impl="cuda")`` under autograd (the
    kernel's forward, ``FlashAttentionFunction`` / ``SSDFunction``'s
    backward: the plain formulation's VJP) against autograd of the plain
    versions (``attention_ref``; ``ssd(impl="torch")``, the chunked torch
    path) on the same inputs and upstream gradients (K5's reach y and the
    final state), within fp32 2e-5·sqrt(Sk or L), bf16 3e-2, relative to
    max|ref|.  At the training path's calls (the first case of each) the
    backward's time per call (CUDA events, median of REPS, the forward's
    graph kept) beside the plain version's.  Returns ``{kernel: {...}}``."""
    g = torch.Generator(device=DEVICE).manual_seed(20)
    out = {}
    for i, (label, b, hq, hkv, s, sk, d, causal, dtype) in \
            enumerate(BWD_FA_CASES):
        q, k, v = (t.requires_grad_() for t in
                   fa_inputs(g, b, hq, hkv, s, sk, d, dtype))
        go = torch.randn(b, hq, s, d, device=DEVICE, generator=g).to(dtype)
        o = flash_attention_cuda(q, k, v, causal=causal)
        r = attention_ref(q, k, v, causal=causal)
        if type(o.grad_fn).__name__ != "FlashAttentionFunctionBackward":
            raise AssertionError(f"flash_attention {label}: no Function "
                                 f"under autograd ({o.grad_fn})")
        got, want = grads_of(o, go, (q, k, v)), grads_of(r, go, (q, k, v))
        torch.cuda.synchronize()
        tol = fa_tol(sk, dtype)
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        if not max(errs) <= tol:
            raise AssertionError(f"flash_attention backward {label} {dtype}:"
                                 f" rel_err dq, dk, dv {errs} > {tol:.3g}")
        entry = {"case": label, "shape": [b, hq, hkv, s, sk, d],
                 "dtype": str(dtype), "rel_err_dq_dk_dv": errs, "tol": tol}
        if i == 0:
            entry["backward_ms_per_call"] = median_ms(
                lambda: grads_of(o, go, (q, k, v)))
            entry["plain_backward_ms_per_call"] = median_ms(
                lambda: grads_of(r, go, (q, k, v)))
            out["flash_attention"] = entry
        emit({"kernel_backward_check": "flash_attention", **entry})
    for i, (label, b, l, h, p, n, chunk, dtype) in enumerate(BWD_SSD_CASES):
        inp = tuple(t.requires_grad_() for t in
                    ssd_inputs(g, b, l, h, p, n, dtype))
        gy = torch.randn(b, l, h, p, device=DEVICE, generator=g).to(dtype)
        gs = torch.randn(b, h, p, n, device=DEVICE, generator=g)
        y, st = ssd(*inp, chunk=chunk, impl="cuda")
        ry, rst = ssd(*inp, chunk=chunk, impl="torch")
        got = grads_of((y, st), (gy, gs), inp)
        want = grads_of((ry, rst), (gy, gs), inp)
        torch.cuda.synchronize()
        tol = 2e-5 * math.sqrt(l) if dtype == torch.float32 else BF16_TOL
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        if not max(errs) <= tol:
            raise AssertionError(f"ssd backward {label} {dtype}: rel_err "
                                 f"dx, ddt, da, dB, dC {errs} > {tol:.3g}")
        entry = {"case": label, "shape": [b, l, h, p, n], "chunk": chunk,
                 "dtype": str(dtype), "rel_err_dx_ddt_da_dB_dC": errs,
                 "tol": tol}
        if i == 0:
            entry["backward_ms_per_call"] = median_ms(
                lambda: grads_of((y, st), (gy, gs), inp))
            entry["plain_backward_ms_per_call"] = median_ms(
                lambda: grads_of((ry, rst), (gy, gs), inp))
            out["ssd"] = entry
        emit({"kernel_backward_check": "ssd", **entry})
    print(f"backward: flash_attention ({len(BWD_FA_CASES)} cases) and ssd "
          f"({len(BWD_SSD_CASES)}) under autograd agree with autograd of "
          f"their plain versions; per call at the training shapes "
          f"{out['flash_attention']['backward_ms_per_call']:.3f} and "
          f"{out['ssd']['backward_ms_per_call']:.3f} ms; card {card}",
          flush=True)
    return out


def register_plain_variants() -> str:
    """The training check's plain run: an op variant ``plain`` of both
    mixers, never picked by ``auto`` — ``attention_scores`` on
    ``flash_attention_torch`` (the counterpart of repro's ``flash_xla``,
    which repro differentiates) and ``ssd`` on ``ssd_chunked`` (of
    ``ssd_chunked_xla``).  Returns the variant's name."""
    register_op_impl(
        "attention_scores", "plain",
        lambda q, k, v, *, causal, blk_q, blk_k: flash_attention_torch(
            q, k, v, causal=causal, blk_q=blk_q, blk_k=blk_k),
        priority=-100, override=True)
    register_op_impl(
        "ssd", "plain",
        lambda xdt, dta, bm, cm, *, chunk: ssd_chunked(xdt, dta, bm, cm,
                                                       chunk=chunk),
        priority=-100, override=True)
    return "plain"


def train_counts(cfg, steps: int = 1) -> dict:
    """The launches of ``steps`` train steps of ``cfg`` with remat: K4
    once per application of the shared block (not remat'd), K5 twice per
    SSD layer (the forward and its recomputation), K1-K3 never (every
    GEMM is differentiated and takes the grad-safe engine)."""
    groups = cfg.n_layers // cfg.attn_every
    return {"tiled_mm": 0, "vpu_mm": 0, "qmm": 0,
            "flash_attention": groups * steps,
            "ssd": (2 if cfg.remat else 1) * cfg.n_layers * steps}


def sample_leaves(tree) -> list:
    """A copy of the first 4,096 entries of every leaf (the witness that a
    leaf moved)."""
    return [t.reshape(-1)[:4096].clone() for t in tree_leaves(tree)]


def phase_training(card: str, lm: dict) -> dict:
    """Slice 10, ``training``: LM_ARCH at full width and depth on the LM
    phase's parameters (taken over: this phase is their last user).

    1. fp32 gradients: one forward and backward in fp32 compute with
       ``impl="auto"`` (K4 and K5, launches counted) and one with the
       plain formulations; every leaf's gradient from both is non-zero
       and within ``norm_rel_err`` TRAIN_GRAD_TOL.
    2. TRAIN_STEPS bf16 train steps (``build_train_step``, donate): loss
       and grad norm finite, the first loss within 1 of ln(vocab), after
       step 1 every leaf moved and its first moment (0.1 x its clipped
       gradient) finite and non-zero; launches per step exactly
       :func:`train_counts`; ms per step (median of steps 2-3), tokens/s,
       the share of the bf16 dense peak at 6·N·D, peak memory; one more
       step under ``torch.profiler``: busy share, the five largest device
       ops and the device time of K4's and K5's backward.
    3. The reduced LM_ARCH (fp32) trained on the card and on the CPU from
       one CPU state: losses, parameters and optimizer state within
       TRAIN_REDUCED_TOL of the leaf's largest entry.
    4. The reduced resume: ``train_loop`` with a ``Checkpointer`` every
       TRAIN_CKPT_EVERY steps under ``run_with_recovery``, a failure after
       step TRAIN_FAIL_AT, bitwise equal to an uninterrupted run."""
    t_phase = time.perf_counter()
    cfg = lm["cfg"]
    params = lm.pop("params")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batches = prefetch(synthetic_batches(cfg, TRAIN_CELL, seed=0,
                                         device=DEVICE), depth=2)
    first = next(batches)

    # 1. fp32 gradients through the kernels against the plain formulations
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    plain = register_plain_variants()
    reset_launches()
    loss_k, grads_k = loss_and_grads(cfg32, params, first)
    torch.cuda.synchronize()
    fp32_counts = expect_counts("fp32 forward and backward",
                                train_counts(cfg))
    _, grads_p = loss_and_grads(cfg32, params, first, impl=plain)
    expect_counts("fp32 plain forward and backward",
                  {"flash_attention": fp32_counts["flash_attention"],
                   "ssd": fp32_counts["ssd"]})
    names = leaf_names(params)
    worst = (0.0, None)
    for name, a, b in zip(names, tree_leaves(grads_k), tree_leaves(grads_p)):
        if not (float(a.abs().max()) > 0 and float(b.abs().max()) > 0):
            raise AssertionError(f"fp32 gradients: {name} has none")
        err = norm_rel_err(a, b)
        if not err <= TRAIN_GRAD_TOL:
            raise AssertionError(f"fp32 gradient of {name}: ||kernels - "
                                 f"plain|| / ||plain|| {err:.4g} > "
                                 f"{TRAIN_GRAD_TOL}")
        worst = max(worst, (err, name))
    del grads_k, grads_p
    grad_check = {"leaves": len(names), "max_rel_err": worst[0],
                  "leaf": worst[1], "tol": TRAIN_GRAD_TOL,
                  "loss": float(loss_k), "launches": fp32_counts}
    print(f"training: fp32 gradients of all {len(names)} leaves through K4 "
          f"and K5 within {TRAIN_GRAD_TOL} of the plain formulations' "
          f"(largest ||diff||/||plain|| {worst[0]:.3g} at {worst[1]})",
          flush=True)

    # 2. bf16 train steps, the state's tensors written in place
    step_fn, _, _ = build_train_step(cfg, TRAIN_CELL)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}
    del params
    before = sample_leaves(state["params"])
    per_step = train_counts(cfg)
    losses, norms, step_s, batch = [], [], [], first
    for i in range(TRAIN_STEPS):
        batch = batch if i == 0 else next(batches)
        reset_launches()
        (state, metrics), s = timed(lambda: step_fn(state, batch))
        expect_counts(f"train step {i + 1}", per_step)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        step_s.append(s)
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            raise AssertionError(f"train step {i + 1}: loss {losses[-1]}, "
                                 f"grad norm {norms[-1]}")
        if i == 0:
            for name, m, old, new in zip(
                    names, tree_leaves(state["opt"]["m"]), before,
                    sample_leaves(state["params"])):
                if not (bool(torch.isfinite(m).all())
                        and float(m.abs().max()) > 0):
                    raise AssertionError(f"train step 1: the gradient of "
                                         f"{name} is zero or not finite")
                if torch.equal(old, new):
                    raise AssertionError(f"train step 1: {name} did not "
                                         f"move")
    ln_vocab = math.log(cfg.vocab_size)
    if not abs(losses[0] - ln_vocab) <= 1.0:
        raise AssertionError(f"first loss {losses[0]:.4f} is not within 1 "
                             f"of ln(vocab) {ln_vocab:.4f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = 1e3 * statistics.median(step_s[1:])
    tokens = TRAIN_CELL.global_batch * TRAIN_CELL.seq_len
    flops = model_flops(cfg, TRAIN_CELL)
    profile = train_profile(lambda: step_fn(state, next(batches)))
    steps = {"steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
             "step_ms": [1e3 * t for t in step_s], "ms_per_step": ms,
             "tokens_per_step": tokens, "tokens_per_s": tokens / (ms / 1e3),
             "model_flops_per_step": flops,
             "bf16_peak_share_at_6ND": flops / (ms / 1e3) / BF16_PEAK_FLOPS,
             "peak_memory_gb": peak_gb, "launches_per_step": per_step,
             "profile": profile}
    print(f"training: {LM_ARCH} {TRAIN_STEPS} bf16 steps of {tokens} tokens, "
          f"losses {[round(x, 4) for x in losses]}, {ms:.1f} ms per step "
          f"(median of steps 2-{TRAIN_STEPS}), {tokens / (ms / 1e3):,.0f} "
          f"tokens/s, {100 * steps['bf16_peak_share_at_6ND']:.2f}% of the "
          f"bf16 dense peak at 6·N·D, peak memory {peak_gb:.2f} GB, launches "
          f"per step {per_step}; card {card}", flush=True)
    del state, batch, first, before
    torch.cuda.empty_cache()

    reduced_run = phase_training_reduced()
    resume = phase_training_resume()
    result = {"training": LM_ARCH, "cell": dataclasses.asdict(TRAIN_CELL),
              "param_dtype": cfg.param_dtype, "compute_dtype":
              cfg.compute_dtype, "remat": cfg.remat, "optimizer": "adamw",
              "fp32_gradients": grad_check, "bf16_steps": steps,
              "reduced_card_vs_cpu": reduced_run, "reduced_resume": resume,
              "peak": BF16_NOTE, "phase_s": time.perf_counter() - t_phase,
              "timer": "host clock around synchronize; ms per step the "
                       "median of steps 2-3",
              "card": card}
    emit(result)
    return {"launches_per_step": per_step,
            "device_busy_ms_per_step": profile["device_busy_ms"],
            "kernel_device_ms_per_step": profile["kernel_device_ms"],
            "backward_device_ms_per_step": profile["backward_device_ms"]}


def leaf_names(tree, prefix: str = "") -> list:
    """The leaves' paths in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def train_profile(step) -> dict:
    """One train step under ``torch.profiler``: the card's busy share, the
    five largest device ops by total time, the device time of the port's
    kernels (their forward launches, booked by ``kernel_name``) and of the
    kernels' Functions' backward (K4's and K5's VJP, the plain
    formulations') from autograd's node ranges."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(step)
    ops, intervals, backward, kernels = {}, [], {}, {}
    nodes = {"flash_attention": "FlashAttentionFunctionBackward",
             "ssd": "SSDFunctionBackward"}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = (ev.time_range.end - ev.time_range.start) / 1e3
            for key, table in ((ev.name[:80], ops),
                               (kernel_name(ev.name), kernels)):
                op = table.setdefault(key, {"count": 0, "device_ms": 0.0})
                op["count"] += 1
                op["device_ms"] += ms
            intervals.append((ev.time_range.start, ev.time_range.end))
            continue
        for kernel, node in nodes.items():
            parent = ev.cpu_parent
            if ev.name.endswith(node) and not (
                    parent is not None and parent.name.endswith(node)):
                b = backward.setdefault(kernel, {"calls": 0,
                                                 "device_ms": 0.0})
                b["calls"] += 1
                b["device_ms"] += ev.device_time_total / 1e3
    busy_ms = union_us(intervals) / 1e3 if intervals else None
    top = sorted(ops.items(), key=lambda kv: -kv[1]["device_ms"])[:5]
    return {"wall_ms_under_profiler": 1e3 * wall,
            "device_busy_ms": busy_ms,
            "device_busy_share": None if busy_ms is None
            else busy_ms / (1e3 * wall),
            "top5_device_ops": dict(top),
            "kernel_device_ms": {k: v for k, v in kernels.items()
                                 if k != "other"},
            "backward_device_ms": backward}


def copy_state(state: dict, device) -> dict:
    return tree_map(lambda t: t.to(device, copy=True), state)


def phase_training_reduced() -> dict:
    """The reduced LM_ARCH (TRAIN_REDUCED_LAYERS layers, fp32) from one
    state made on the CPU: TRAIN_STEPS steps on the card (launches
    counted) and on the CPU; losses and every leaf of the state within
    TRAIN_REDUCED_TOL of the CPU leaf's largest entry."""
    cfg = reduced(ARCHS[LM_ARCH], n_layers=TRAIN_REDUCED_LAYERS)
    state0 = make_train_state(cfg, 21, device="cpu")
    runs = {}
    for dev in ("cpu", DEVICE):
        state = copy_state(state0, dev)
        step_fn, _, _ = build_train_step(cfg, TRAIN_REDUCED_CELL)
        losses = []
        reset_launches()
        for step, batch in zip(range(TRAIN_STEPS), synthetic_batches(
                cfg, TRAIN_REDUCED_CELL, seed=3, device=dev)):
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
        runs[dev] = (state, losses, launch_counts())
    (cpu, cpu_losses, _), (card, card_losses, counts) = runs["cpu"], \
        runs[DEVICE]
    want = train_counts(cfg, TRAIN_STEPS)
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"reduced training on the card: launches "
                             f"{counts}, expected {want}")
    worst = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    names = leaf_names(cpu)
    for name, a, b in zip(names, tree_leaves(card), tree_leaves(cpu)):
        err = rel_err(a.cpu(), b) if b.dim() else \
            abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
        worst = max(worst, err)
        if not err <= TRAIN_REDUCED_TOL:
            raise AssertionError(f"reduced training, card vs CPU: {name} "
                                 f"rel_err {err:.3g} > {TRAIN_REDUCED_TOL}")
    print(f"training: reduced {LM_ARCH} ({TRAIN_REDUCED_LAYERS} layers, fp32) "
          f"{TRAIN_STEPS} steps on the card within {TRAIN_REDUCED_TOL} of the "
          f"CPU (largest rel_err {worst:.3g} over losses and {len(names)} "
          f"state leaves), launches {want}", flush=True)
    return {"arch": LM_ARCH, "n_layers": TRAIN_REDUCED_LAYERS,
            "cell": dataclasses.asdict(TRAIN_REDUCED_CELL),
            "steps": TRAIN_STEPS, "losses_card": card_losses,
            "losses_cpu": cpu_losses, "max_rel_err": worst,
            "tol": TRAIN_REDUCED_TOL, "launches": want}


class InjectedFault(RuntimeError):
    pass


def phase_training_resume() -> dict:
    """The reduced LM_ARCH on the card through ``train_loop`` (donate) with
    a ``Checkpointer`` every TRAIN_CKPT_EVERY steps under
    ``run_with_recovery``, a failure injected after step TRAIN_FAIL_AT;
    the supervisor restores the last checkpoint and runs to
    TRAIN_RESUME_STEPS.  The final state must be bitwise that of an
    uninterrupted run from the same CPU state."""
    cfg = reduced(ARCHS[LM_ARCH], n_layers=TRAIN_REDUCED_LAYERS)
    cell = TRAIN_REDUCED_CELL
    state0 = make_train_state(cfg, 22, device="cpu")
    straight, _ = train_loop(
        cfg, steps=TRAIN_RESUME_STEPS, cell=cell,
        state=copy_state(state0, DEVICE),
        batch_iter=synthetic_batches(cfg, cell, seed=4, device=DEVICE))
    workdir = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        ck = Checkpointer(workdir, keep=2, async_write=True)
        fired, starts = [], []

        def on_step(step, metrics):
            if step == TRAIN_FAIL_AT and not fired:
                fired.append(step)
                ck.wait()        # the last checkpoint is on disk
                raise InjectedFault(f"injected after step {step}")

        def run_steps(start, end, state):
            starts.append(start)
            it = prefetch(synthetic_batches(cfg, cell, seed=4,
                                            start_step=start, device=DEVICE))
            state, _ = train_loop(cfg, steps=end - start, cell=cell,
                                  state=copy_state(state, DEVICE),
                                  batch_iter=it, checkpointer=ck,
                                  ckpt_every=TRAIN_CKPT_EVERY,
                                  on_step=on_step)
            ck.wait()
            return state

        resumed, failures = run_with_recovery(
            steps=TRAIN_RESUME_STEPS, run_steps=run_steps, checkpointer=ck,
            state0=state0)
        saved = ck.all_steps()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    restored = TRAIN_FAIL_AT - TRAIN_FAIL_AT % TRAIN_CKPT_EVERY
    if len(failures) != 1 or starts != [0, restored] \
            or int(resumed["step"]) != TRAIN_RESUME_STEPS:
        raise AssertionError(f"resume: failures {failures}, runs from "
                             f"{starts}, step {int(resumed['step'])}")
    names = leaf_names(straight)
    differ = [n for n, a, b in zip(names, tree_leaves(resumed),
                                   tree_leaves(straight))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"resume: {len(differ)} leaves differ from the "
                             f"uninterrupted run, first {differ[:4]}")
    print(f"training: reduced {LM_ARCH} failed after step {TRAIN_FAIL_AT}, "
          f"restored the checkpoint of step {restored} and ran to step "
          f"{TRAIN_RESUME_STEPS} (checkpoints kept {saved}), bitwise the "
          f"uninterrupted run ({len(names)} leaves)", flush=True)
    return {"steps": TRAIN_RESUME_STEPS, "ckpt_every": TRAIN_CKPT_EVERY,
            "failed_after": TRAIN_FAIL_AT, "restored_step": restored,
            "checkpoints": saved, "bitwise_leaves": len(names)}


@contextlib.contextmanager
def one_rank_group():
    """A process group of one rank for the phase (NCCL on the card, gloo
    on the CPU), destroyed at its end so later phases run as before."""
    if DEVICE == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(
            "nccl", store=dist.HashStore(), rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def leaf_digest(t: torch.Tensor) -> tuple:
    """Two integer sums of a leaf's bit patterns (plain and position-
    weighted, in int64 with wraparound), computed on its device: equal
    leaves give equal digests, and the bits of a different leaf almost
    surely change them."""
    flat = t.detach().contiguous().reshape(-1)
    bits = flat.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                      1: torch.int8}[flat.element_size()]).to(torch.int64)
    w = torch.arange(bits.numel(), device=bits.device) % 1000003 + 1
    return int(bits.sum()), int((bits * w).sum())


def in_turns(fns: dict, reps: int = MESH_REPS) -> dict:
    """Each function's wall times (host clock around synchronize), run in
    turns ``reps`` times."""
    out = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            out[k].append(timed(fn)[1])
    return out


def ms_of(times: dict) -> dict:
    return {k: {"ms": [1e3 * t for t in v],
                "median_ms": 1e3 * statistics.median(v)}
            for k, v in times.items()}


def per_layer_gathers(cfg, placed: dict, pspecs: dict, mesh) -> None:
    """The gathers over the data axes that a step makes of ``placed``
    (``gather_for_use``): each layer's slice, the shared block, the
    embedding and the head."""
    local = local_tree(placed)
    with use_data_gather(data_gather_of(pspecs, mesh)):
        for l in range(cfg.n_layers):
            gather_for_use(_layer_slice(local["blocks"], l), "blocks")
        for path in ("shared", "embed", "lm_head"):
            if path in local:
                gather_for_use(local[path], path)


def phase_mesh(card: str, lm: dict) -> dict:
    """Slice 12, ``mesh``: the mesh launchers over a mesh of one rank
    (one NCCL rank, ``make_test_mesh(data=1, model=1)``), on the LM
    phase's zamba2-2.7b parameters at full width and depth:

    1. ``build_prefill_step`` on the LM phase's 4 x 1,024 tokens, the
       parameters placed once before: logits ``torch.equal`` to
       ``prefill_fn``'s; launches exactly the prefill's (K4 9, K5 54, K1
       55, all on wgmma), counts set to 0 just before and read just
       after.  Timed in turns with the unsharded prefill and with the
       mesh's own parts alone: placing the parameters (once, before the
       steps), the per-layer gathers over the data axes (each step: at
       one rank, what they cost doing nothing) and the logits' gather.
    2. ``build_decode_step`` (donate) MESH_DECODE greedy steps from a fresh
       cache of MESH_MAX_LEN, beside ``decode_fn`` on a cache of its own:
       logits ``torch.equal`` every step, every cache leaf ``torch.equal``
       at the end and written into the very tensors ``init_cache`` made;
       launches per step K1 55, K4 0, K5 0.
    3. ``build_pp_forward`` on a one-stage mesh for PP_ARCH at its
       published widths, depth cut to PP_LAYERS: ``torch.equal`` to the
       sequential ``_scan_blocks`` over each of PP_MICRO microbatches,
       with the same launches.
    4. ``sync_pods_compressed`` with one pod: bitwise ``anchor +
       dequantize(quantize(delta))`` and its error feedback.
    Wall times of both sides in turns, and peak memory.  The
    steps take trees placed once, as a caller places them."""
    t_phase = time.perf_counter()
    cfg, params, tokens = lm["cfg"], lm["params"], lm["tokens"]
    per_prefill = lm["per_prefill"]
    per_step = {"flash_attention": 0, "ssd": 0,
                "tiled_mm": per_prefill["tiled_mm"]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with one_rank_group():
        mesh = make_test_mesh(data=1, model=1, device_type=DEVICE)

        # 1. prefill, the parameters placed once; how many of the
        # gathered leaves are the placed tensors themselves
        prefill, (_, pspecs), (_, bspecs) = build_prefill_step(
            cfg, ShapeCell("prefill", LM_PROMPT, LM_BATCH, "prefill"), mesh)
        placed = place_tree(params, pspecs, mesh)
        shared = sum(g.data_ptr() == t.data_ptr() for g, t in zip(
            tree_leaves(gather_tree(placed)), tree_leaves(params)))
        axes = axes_of(bspecs["tokens"][0])
        want = prefill_fn(cfg, params, tokens=tokens)
        reset_launches()
        got = prefill(placed, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_counts = expect_counts("mesh prefill", per_prefill)
        expect_paths("mesh prefill", per_prefill["tiled_mm"])
        if not torch.equal(got, want):
            raise AssertionError(f"mesh prefill: logits differ from "
                                 f"prefill_fn's by up to "
                                 f"{(got - want).abs().max().item():.3g}")
        prefill_ms = ms_of(in_turns({
            "unsharded": lambda: prefill_fn(cfg, params, tokens=tokens),
            "mesh": lambda: prefill(placed, {"tokens": tokens}),
            "place_tree": lambda: place_tree(params, pspecs, mesh),
            "gather_for_use": lambda: per_layer_gathers(cfg, placed,
                                                        pspecs, mesh),
            "gather_logits": lambda: gather_over(want, axes, mesh)}))
        del got, placed

        # 2. decode from a fresh cache, the cache written in place
        decode, (_, dspecs), (_, bspecs) = build_decode_step(
            cfg, ShapeCell("decode", MESH_MAX_LEN, LM_BATCH, "decode"), mesh)
        placed = place_tree(params, dspecs, mesh)
        ref_cache = init_cache(cfg, LM_BATCH, MESH_MAX_LEN, device=DEVICE)
        fresh = init_cache(cfg, LM_BATCH, MESH_MAX_LEN, device=DEVICE)
        cache = place_tree(fresh, bspecs["cache"], mesh)
        tok = want[:, -1].argmax(dim=-1, keepdim=True)
        step_s = {"unsharded": [], "mesh": []}
        for i in range(MESH_DECODE):
            (w, ref_cache), s_ref = timed(
                lambda: decode_fn(cfg, params, ref_cache, tok, i))
            reset_launches()
            (g, cache), s = timed(lambda: decode(placed, cache, tok, i))
            expect_counts(f"mesh decode step {i}", per_step)
            expect_paths(f"mesh decode step {i}", per_step["tiled_mm"])
            if not torch.equal(g, w):
                raise AssertionError(f"mesh decode step {i}: logits differ")
            step_s["unsharded"].append(s_ref)
            step_s["mesh"].append(s)
            tok = w[:, -1].argmax(dim=-1, keepdim=True)
        for name, a, b, f in zip(leaf_names(ref_cache), tree_leaves(cache),
                                 tree_leaves(ref_cache), tree_leaves(fresh)):
            if not torch.equal(a.to_local(), b):
                raise AssertionError(f"mesh decode: cache leaf {name} "
                                     f"differs from decode_fn's")
            if a.to_local().data_ptr() != f.data_ptr():
                raise AssertionError(f"mesh decode: cache leaf {name} was "
                                     f"not written in place")
        del ref_cache, cache, fresh, placed
        serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # 3. pipeline mode on a one-stage mesh
        pipeline = mesh_pipeline()
        # 4. local SGD with one pod
        sgd = mesh_local_sgd(params)

    decode_ms = ms_of(step_s)
    result = {
        "mesh": "make_test_mesh(data=1, model=1): one NCCL rank"
                if DEVICE == "cuda" else "one gloo rank",
        "lm": LM_ARCH, "note": MESH_NOTE,
        "prefill": {"tokens": [LM_BATCH, LM_PROMPT], "bitwise": True,
                    "launches": prefill_counts, **prefill_ms},
        "decode": {"steps": MESH_DECODE, "max_len": MESH_MAX_LEN,
                   "bitwise_logits_and_cache": True, "cache_in_place": True,
                   "launches_per_step": per_step, **decode_ms},
        "serve_peak_memory_gb": serve_peak_gb,
        "gathered_leaves_sharing_the_placed_storage": [
            shared, len(tree_leaves(params))],
        "pipeline": pipeline, "local_sgd": sgd,
        "timer": f"host clock around synchronize; prefill {MESH_REPS} "
                 f"runs of each side and of the mesh's parts alone "
                 f"(place_tree once before the steps, gather_for_use "
                 f"and gather_logits in each) in turns, decode each step of "
                 f"both",
        "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    print(f"mesh: {LM_ARCH} prefill {LM_BATCH} x {LM_PROMPT} tokens "
          f"bitwise, median {prefill_ms['mesh']['median_ms']:.1f} ms on "
          f"the mesh vs {prefill_ms['unsharded']['median_ms']:.1f} ms "
          f"unsharded (placing once "
          f"{prefill_ms['place_tree']['median_ms']:.3f} ms, the "
          f"per-layer gathers over the data axis "
          f"{prefill_ms['gather_for_use']['median_ms']:.3f} and "
          f"the logits {prefill_ms['gather_logits']['median_ms']:.3f} ms "
          f"a step); {MESH_DECODE} decode steps bitwise, cache in place, "
          f"median {decode_ms['mesh']['median_ms']:.1f} vs "
          f"{decode_ms['unsharded']['median_ms']:.1f} ms; pipeline mode "
          f"and local SGD bitwise; peak memory {serve_peak_gb:.2f} GB; "
          f"{MESH_NOTE}; card {card}", flush=True)
    return {"prefill": prefill_counts, "decode_per_step": per_step,
            "pipeline": pipeline["launches"]}


def shard_of(t: torch.Tensor, spec, rank: int, axis: str = "model",
             ranks: int = TP_MODEL) -> torch.Tensor:
    """``t``'s shard under ``spec`` at rank ``rank`` of ``axis``, the only
    axis of more than one rank (``ranks``) of the mesh."""
    for dim, entry in enumerate(spec):
        if axis in axes_of(entry):
            size = t.shape[dim] // ranks
            t = t.narrow(dim, rank * size, size)
    return t


class _Recorder:
    """The widths K5 and K4 are launched at (P; q-heads) while set, by
    wrapping the kernels' forwards (their launch counts are unchanged:
    the wrapped functions count)."""

    def __init__(self):
        self.ssd_p, self.fa_heads = set(), set()
        self._saved = (ssd_ops._ssd_forward, fa_ops._flash_forward)

    def __enter__(self):
        ssd_fwd, fa_fwd = self._saved

        def ssd_rec(xdt, *a, **k):
            self.ssd_p.add(xdt.shape[-1])
            return ssd_fwd(xdt, *a, **k)

        def fa_rec(q, *a, **k):
            self.fa_heads.add(q.shape[1])
            return fa_fwd(q, *a, **k)

        ssd_ops._ssd_forward, fa_ops._flash_forward = ssd_rec, fa_rec
        return self

    def __exit__(self, *exc):
        ssd_ops._ssd_forward, fa_ops._flash_forward = self._saved


@contextlib.contextmanager
def timed_collectives(log: dict, sync: bool = True):
    """Each all_reduce, all_gather, reduce_scatter_tensor and
    all_to_all_single timed on the host clock between synchronizes, into
    ``log``: ms, calls and bytes (of the first argument: the result) by
    type.  Without ``sync`` only counted: the ms is then the host's time
    in the call."""
    saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                            "reduce_scatter_tensor",
                                            "all_to_all_single")}
    barrier = torch.cuda.synchronize if sync else (lambda: None)

    def wrap(name, fn):
        def run(*a, **k):
            barrier()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            barrier()
            entry = log.setdefault(name, {"ms": 0.0, "calls": 0, "bytes": 0})
            entry["ms"] += 1e3 * (time.perf_counter() - t0)
            entry["calls"] += 1
            first = a[0]
            entry["bytes"] += sum(t.numel() * t.element_size() for t in (
                first if isinstance(first, list) else [first]))
            return out
        return run

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def run_ranks(child: str, label: str) -> list:
    """TP_MODEL processes (``python3 -c child ROOT rank workdir``), each a
    gloo rank on card 0; their results (``workdir/rank<r>.json``), in rank
    order.  Fails, killing every rank, as soon as one fails or TP_TIMEOUT
    seconds pass."""
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix=f"{label}-")
    logs = [open(os.path.join(workdir, f"log{r}.txt"), "w+")
            for r in range(TP_MODEL)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", child, str(ROOT), str(r), workdir],
        cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(TP_MODEL)]
    deadline = time.monotonic() + TP_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.poll() is not None):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        shutil.rmtree(workdir, ignore_errors=True)
        raise AssertionError(f"{label}: ranks failed or ran past "
                             f"{TP_TIMEOUT} s: " + "\n".join(
                                 f"rank {r} (exit {procs[r].returncode}):\n"
                                 f"{texts[r][-3000:]}" for r in failed))
    ranks = []
    for r in range(TP_MODEL):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(workdir, ignore_errors=True)
    return ranks


def gloo_rank(rank: int, workdir: str, body) -> None:
    """One rank of a ``run_ranks`` phase: a gloo rank of TP_MODEL on card
    0 running ``body(rank, workdir)``, its result written to
    ``workdir/rank<rank>.json``."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import datetime
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "pg"),
        rank=rank, world_size=TP_MODEL,
        timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    try:
        result = body(rank, workdir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def mesh_tp_rank(rank: int, workdir: str) -> None:
    """One rank of slice 14's ``mesh_tp`` phase (``TP_CHILD``)."""
    gloo_rank(rank, workdir, mesh_tp_run)


def rel_scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def mesh_tp_run(rank: int, workdir: str) -> dict:
    """The body of one ``mesh_tp`` rank; rank 0 also runs the unsharded
    steps and holds the results to them (see :func:`phase_mesh_tp`)."""
    from repro_torch.models import transformer as tf
    mesh = make_test_mesh(data=1, model=TP_MODEL, device_type=DEVICE)
    cfg = dataclasses.replace(ARCHS[LM_ARCH], n_layers=TP_LAYERS,
                              compute_dtype="float32")
    params = init_model(cfg, 0, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(14)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           device=DEVICE, generator=g)
    prefill, (_, pspecs), _ = build_prefill_step(
        cfg, ShapeCell("prefill", LM_PROMPT, LM_BATCH, "prefill"), mesh)
    decode, (_, dspecs), (_, bspecs) = build_decode_step(
        cfg, ShapeCell("decode", LM_MAX_LEN, LM_BATCH, "decode"), mesh)
    if tree_leaves(pspecs) != tree_leaves(dspecs):
        raise AssertionError("mesh_tp: the prefill and decode specs differ; "
                             "the parameters are placed once for both")
    placed = place_tree(params, pspecs, mesh)
    reference = rank == 0
    if not reference:
        del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per_prefill = {"tiled_mm": cfg.n_layers // cfg.attn_every * 6 + 1,
                   "flash_attention": cfg.n_layers // cfg.attn_every,
                   "ssd": cfg.n_layers}
    per_step = {"tiled_mm": per_prefill["tiled_mm"], "flash_attention": 0,
                "ssd": 0}
    out: dict = {"rank": rank}

    # 1. the partitioned prefill: launches, the widths, the logits
    with _Recorder() as rec:
        reset_launches()
        got, s = timed(lambda: prefill(placed, {"tokens": tokens}))
        launches = expect_counts(f"mesh_tp rank {rank} prefill", per_prefill)
        paths = expect_fp32_paths(f"mesh_tp rank {rank} prefill",
                                  per_prefill["tiled_mm"])
    prefill_s = [s] + [timed(lambda: prefill(placed, {"tokens": tokens}))[1]
                       for _ in range(TP_REPS)]
    out["prefill"] = {"launches": launches, "tiled_mm_paths": paths,
                      "ssd_p": sorted(rec.ssd_p),
                      "flash_attention_heads": sorted(rec.fa_heads),
                      "ms": [1e3 * t for t in prefill_s],
                      "median_ms": 1e3 * statistics.median(prefill_s)}
    if reference:
        want = prefill_fn(cfg, params, tokens=tokens)
        ref_s = [timed(lambda: prefill_fn(cfg, params, tokens=tokens))[1]
                 for _ in range(TP_REPS)]
        err = rel_scale_err(got, want)
        if not err <= TP_TOL:
            raise AssertionError(f"mesh_tp prefill: logits differ by "
                                 f"{err:.3g} of their scale > {TP_TOL}")
        out["prefill"].update(err_of_scale=err, unsharded_ms=[
            1e3 * t for t in ref_s], unsharded_median_ms=1e3
            * statistics.median(ref_s))
    dist.barrier()

    # 2. greedy decode at the LM phase's depth, from a cache whose every
    # leaf holds a seeded random history (the same on every rank), placed
    # once: the scores' sum over 'model' runs over LM_PROMPT + 1 ..
    # LM_PROMPT + TP_DECODE live positions of LM_MAX_LEN
    gc = torch.Generator(device=DEVICE).manual_seed(15)
    fresh = tree_map(
        lambda t: torch.randn(t.shape, generator=gc, device=DEVICE,
                              dtype=t.dtype),
        init_cache(cfg, LM_BATCH, LM_MAX_LEN, device=DEVICE))
    ref_cache = tree_map(torch.clone, fresh) if reference else None
    cache = place_tree(fresh, bspecs["cache"], mesh)
    tok = got[:, -1].argmax(dim=-1, keepdim=True)
    ref_tok = want[:, -1].argmax(dim=-1, keepdim=True) if reference else None
    steps = {"ms": [], "unsharded_ms": [], "err_of_scale": [], "tokens": []}
    for i in range(TP_DECODE):
        if reference and not torch.equal(tok, ref_tok):
            raise AssertionError(f"mesh_tp decode step {i}: greedy tokens "
                                 f"{tok.flatten().tolist()} vs unsharded "
                                 f"{ref_tok.flatten().tolist()}")
        reset_launches()
        (lg, cache), s = timed(
            lambda: decode(placed, cache, tok, LM_PROMPT + i))
        expect_counts(f"mesh_tp rank {rank} decode step {i}", per_step)
        steps["ms"].append(1e3 * s)
        steps["tokens"].append(tok.flatten().tolist())
        if reference:
            (w, ref_cache), s_ref = timed(
                lambda: decode_fn(cfg, params, ref_cache, ref_tok,
                                  LM_PROMPT + i))
            err = rel_scale_err(lg, w)
            if not err <= TP_TOL:
                raise AssertionError(f"mesh_tp decode step {i}: logits "
                                     f"differ by {err:.3g} of their scale")
            steps["unsharded_ms"].append(1e3 * s_ref)
            steps["err_of_scale"].append(err)
            ref_tok = w[:, -1].argmax(dim=-1, keepdim=True)
        dist.barrier()
        tok = lg[:, -1].argmax(dim=-1, keepdim=True)
    out["decode"] = {**steps, "launches_per_step": per_step,
                     "median_ms": statistics.median(steps["ms"])}
    if reference:
        out["decode"]["unsharded_median_ms"] = statistics.median(
            steps["unsharded_ms"])

    # 3. every rank's cache shards against the unsharded cache's slices
    local = [d.to_local() for d in tree_leaves(cache)]
    torch.save([t.cpu() for t in local],
               os.path.join(workdir, f"cache{rank}.pt"))
    dist.barrier()
    if reference:
        worst = 0.0
        names = leaf_names(ref_cache)
        specs = tree_leaves(bspecs["cache"])
        for r in range(TP_MODEL):
            shards = torch.load(os.path.join(workdir, f"cache{r}.pt"))
            for name, t, w, sp in zip(names, shards, tree_leaves(ref_cache),
                                      specs):
                e = rel_scale_err(t, shard_of(w, sp, r).cpu())
                if not e <= TP_TOL:
                    raise AssertionError(f"mesh_tp: rank {r}'s cache shard "
                                         f"{name} differs by {e:.3g}")
                worst = max(worst, e)
        out["cache"] = {"leaves": len(names), "ranks": TP_MODEL,
                        "worst_err_of_scale": worst}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # 4. the collectives' time: one more prefill and decode step, each
    # collective timed between synchronizes
    coll: dict = {"prefill": {}, "decode": {}}
    with timed_collectives(coll["prefill"]):
        prefill(placed, {"tokens": tokens})
    with timed_collectives(coll["decode"]):
        decode(placed, cache, tok, LM_PROMPT + TP_DECODE)
    out["collectives"] = coll
    del placed, cache, fresh, ref_cache
    if reference:
        del params
    torch.cuda.empty_cache()
    dist.barrier()

    # 5. one zamba2 layer (a Mamba2 layer, then the shared block) in
    # bf16, mixer by mixer against the unsharded run: each mixer's input
    # differs from the unsharded run's by what the mixers before it did
    cfg16 = dataclasses.replace(ARCHS[LM_ARCH], n_layers=1, attn_every=1)
    p16 = init_model(cfg16, 1, device=DEVICE)
    pre16, (_, specs16), _ = build_prefill_step(
        cfg16, ShapeCell("prefill", LM_PROMPT, LM_BATCH, "prefill"), mesh)
    placed16 = place_tree(p16, specs16, mesh)
    mixers = {"mamba": [], "attention": []}
    tf.mixer_probe = lambda kind, o, rerun: mixers[kind].append(o.clone())
    try:
        got16 = pre16(placed16, {"tokens": tokens})
    finally:
        tf.mixer_probe = None
    if reference:
        ref_mixers = {"mamba": [], "attention": []}
        tf.mixer_probe = lambda kind, o, rerun: ref_mixers[kind].append(o)
        try:
            want16 = prefill_fn(cfg16, p16, tokens=tokens)
        finally:
            tf.mixer_probe = None
        errs = {k: [rel_err(a, b) for a, b in zip(mixers[k], ref_mixers[k])]
                for k in mixers}
        errs["logits"] = [rel_err(got16, want16)]
        worst = max(e for v in errs.values() for e in v)
        if not worst <= BF16_TOL or any(
                len(mixers[k]) != len(ref_mixers[k]) for k in mixers):
            raise AssertionError(f"mesh_tp bf16 layer: rel_err {errs}")
        out["bf16_layer"] = {"layers": cfg16.n_layers, "rel_err": errs,
                             "tol": BF16_TOL}
    dist.barrier()
    return out


def phase_mesh_tp(card: str) -> dict:
    """Slice 14, ``mesh_tp``: the serving steps partitioned over 'model',
    by TP_MODEL gloo ranks that share the card (each a process of its own,
    ``make_test_mesh(data=1, model=TP_MODEL, device_type="cuda")``), on
    zamba2-2.7b at its published widths and TP_LAYERS of its 54 layers
    (18: 3 groups of 6 and the shared block 3 times), compute in fp32,
    made on each rank from seed 0 and placed once:

    1. ``build_prefill_step`` on LM_BATCH x LM_PROMPT tokens: each rank's
       launches (counts set to 0 just before, read just after) K5 18 at
       P = 32, K4 3 at 16 q-heads, K1 19; rank 0 holds the logits within
       TP_TOL of their scale to the unsharded ``prefill_fn`` on the same
       card.
    2. ``build_decode_step`` TP_DECODE greedy steps at the LM phase's
       depth: a cache of LM_MAX_LEN holding a seeded random history,
       positions LM_PROMPT on (K1 19, K4 0, K5 0 a step): logits within
       TP_TOL, greedy tokens equal to the unsharded decode's; then every
       rank's cache shards (``to_local``, written in place) within
       TP_TOL of their slices of the unsharded cache.
    3. One more prefill and decode step with each collective timed.
    4. One zamba2 layer in bf16 (a Mamba2 layer and the shared block),
       mixer by mixer against the unsharded run at BF16_TOL.
    Per rank: prefill ms, decode ms a step, ``max_memory_allocated`` and
    collective ms, beside rank 0's unsharded times.  Fails if a rank
    fails or outlives TP_TIMEOUT."""
    t_phase = time.perf_counter()
    ranks = run_ranks(TP_CHILD, "mesh_tp")
    for res in ranks:
        pre = res["prefill"]
        if pre["ssd_p"] != [ARCHS[LM_ARCH].ssm_head_dim // TP_MODEL] or \
                pre["flash_attention_heads"] != [
                    ARCHS[LM_ARCH].n_heads // TP_MODEL]:
            raise AssertionError(f"mesh_tp rank {res['rank']}: K5 at P "
                                 f"{pre['ssd_p']}, K4 at heads "
                                 f"{pre['flash_attention_heads']}")
    result = {"mesh_tp": LM_ARCH, "mesh": f"make_test_mesh(data=1, model="
              f"{TP_MODEL}): {TP_MODEL} gloo ranks sharing one card",
              "compute": "float32", "prompt": [LM_BATCH, LM_PROMPT],
              "decode_steps": TP_DECODE, "max_len": LM_MAX_LEN,
              "first_pos": LM_PROMPT,
              "tol": TP_TOL, "ranks": ranks,
              "timer": f"host clock around synchronize; prefill "
                       f"{TP_REPS + 1} runs, decode each step; collectives "
                       f"of one more prefill and decode step, each between "
                       f"synchronizes",
              "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    for res in ranks:
        coll = {k: sum(e["ms"] for e in v.values())
                for k, v in res["collectives"].items()}
        r0 = ranks[0]
        print(f"mesh_tp rank {res['rank']}: {LM_ARCH} fp32 prefill "
              f"{LM_BATCH} x {LM_PROMPT} median "
              f"{res['prefill']['median_ms']:.1f} ms (unsharded "
              f"{r0['prefill']['unsharded_median_ms']:.1f}), decode at "
              f"positions {LM_PROMPT}.. of {LM_MAX_LEN} "
              f"{res['decode']['median_ms']:.1f} ms a step (unsharded "
              f"{r0['decode']['unsharded_median_ms']:.1f}), "
              f"collectives {coll['prefill']:.1f} ms a prefill and "
              f"{coll['decode']:.1f} ms a decode step, peak "
              f"{res['peak_memory_gb']:.2f} GB; launches a prefill "
              f"{res['prefill']['launches']} (K5 at P "
              f"{res['prefill']['ssd_p']}, K4 at "
              f"{res['prefill']['flash_attention_heads']} heads, K1 paths "
              f"{res['prefill']['tiled_mm_paths']}); card {card}",
              flush=True)
    r0 = ranks[0]
    print(f"mesh_tp: logits within {TP_TOL} of the unsharded step's scale "
          f"(prefill {r0['prefill']['err_of_scale']:.3g}, decode worst "
          f"{max(r0['decode']['err_of_scale']):.3g}), greedy tokens equal "
          f"over {TP_DECODE} steps, {r0['cache']['leaves']} cache leaves "
          f"of {TP_MODEL} ranks within {r0['cache']['worst_err_of_scale']:.3g}"
          f"; one bf16 layer, worst rel_err "
          f"{max(e for v in r0['bf16_layer']['rel_err'].values() for e in v):.3g}"
          f"; card {card}", flush=True)
    return {"prefill_per_rank": r0["prefill"]["launches"],
            "decode_per_step_per_rank": r0["decode"]["launches_per_step"]}


def adamw_step_bound(opt_cfg, steps: int) -> float:
    """The most an entry of two AdamW runs from one state can differ after
    ``steps`` steps when their gradients differ (by rounding, or in sign
    where an entry's gradient is at rounding level): step t moves an
    entry by lr_t·(m̂_t/(√v̂_t + ε) + wd·p), and by Cauchy–Schwarz
    |m̂_t/√v̂_t| <= r_t = √(Σ_k c_k²/d_k)·√(1 - b2^t)/(1 - b1^t) over the
    weights c_k = (1 - b1)·b1^(t-k) of the gradients in m and d_k =
    (1 - b2)·b2^(t-k) in v (r_1 = 1), so two moves differ by at most
    2·lr_t·r_t, and a difference of the parameters by a factor
    1 + lr_t·wd more."""
    b1, b2, bound = opt_cfg.b1, opt_cfg.b2, 0.0
    for t in range(1, steps + 1):
        lr = float(cosine_lr(opt_cfg, torch.tensor(t, dtype=torch.int32)))
        r = math.sqrt(sum(((1 - b1) * b1 ** (t - k)) ** 2
                          / ((1 - b2) * b2 ** (t - k))
                          for k in range(1, t + 1))
                      * (1 - b2 ** t)) / (1 - b1 ** t)
        bound = bound * (1 + lr * opt_cfg.weight_decay) + 2 * lr * r
    return bound


def held_state_shards(label: str, rank: int, state: dict, sspecs: dict,
                      names: list, ref_state, axis: str) -> dict | None:
    """Every rank's shard of every leaf of the placed train ``state``
    (split over ``axis``, TP_MODEL ranks) after MESH_TRAIN_STEPS AdamW
    steps, against the slice of the unsharded state's leaf (``ref_state``,
    on rank 0's host), leaf by leaf: rank 1's shards go to rank 0 (one
    all-to-all each), which holds them and its own to the reference.  The
    step counters equal, each parameter within :func:`adamw_step_bound`
    plus 2 ulps of the slice's largest entry, m and v within
    TPT_STATE_TOL of its largest entry.  Rank 0 returns the worst errors,
    the others None."""
    reference = rank == 0
    bound = adamw_step_bound(AdamWConfig(), MESH_TRAIN_STEPS)
    worst = {"params": [0.0, None], "moments": [0.0, None]}
    for j, (name, leaf, spec) in enumerate(zip(
            names, tree_leaves(state), tree_leaves(sspecs))):
        local = leaf.to_local()
        flat = local.contiguous().reshape(-1)
        n = flat.numel()
        sizes = [n if (rank == 0 and r > 0) else 0 for r in range(TP_MODEL)]
        got = flat.new_empty((sum(sizes),))
        dist.all_to_all_single(
            got, flat if rank > 0 else flat[:0], sizes,
            [n if (d == 0 and rank > 0) else 0 for d in range(TP_MODEL)])
        if not reference:
            continue
        want = ref_state[j].to(DEVICE)
        parts = [local] + list(got.view(TP_MODEL - 1, *local.shape))
        for r, part in enumerate(parts):
            w = shard_of(want, spec, r, axis)
            if name.endswith("step"):
                ok, err = torch.equal(part, w), 0.0
            elif name.startswith("/params/"):
                err = (part.float() - w.float()).abs().max().item()
                tol = bound + 2 ** -22 * w.float().abs().max().item()
                ok = err <= tol
                err = err / tol
                key = "params"
            else:
                err = rel_scale_err(part, w)
                ok = err <= TPT_STATE_TOL
                key = "moments"
            if not ok:
                raise AssertionError(f"{label}: rank {r}'s shard of {name} "
                                     f"differs from the unsharded state's "
                                     f"slice ({err:.3g})")
            if not name.endswith("step") and err >= worst[key][0]:
                worst[key] = [err, f"{name} (rank {r})"]
        del want, parts, got
    if not reference:
        return None
    return {"leaves": len(names), "ranks": TP_MODEL, "param_bound": bound,
            "worst_param_err_of_bound": worst["params"],
            "worst_moment_err_of_scale": worst["moments"],
            "moment_tol": TPT_STATE_TOL}


def mesh_tp_train_rank(rank: int, workdir: str) -> None:
    """One rank of slice 15's ``mesh_tp_train`` phase (``TPT_CHILD``)."""
    gloo_rank(rank, workdir, mesh_tp_train_run)


def mesh_tp_train_run(rank: int, workdir: str) -> dict:
    """The body of one ``mesh_tp_train`` rank; rank 0 also runs the
    unsharded steps first and holds the results to them (see
    :func:`phase_mesh_tp_train`)."""
    cfg = dataclasses.replace(ARCHS[LM_ARCH], n_layers=TP_LAYERS,
                              compute_dtype="float32")
    per_step = train_counts(cfg)
    batches = list(itertools.islice(
        synthetic_batches(cfg, TRAIN_CELL, seed=0, device=DEVICE),
        MESH_TRAIN_STEPS))
    names = leaf_names(make_train_state(cfg, 0, device="meta"))
    reference, ref_state = rank == 0, None
    ref_path = os.path.join(workdir, "unsharded.json")
    out: dict = {"rank": rank}

    # 1. the unsharded steps, rank 0 alone; the state kept on the host
    if reference:
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(cfg, 0, device=DEVICE)
        step_fn = build_train_step(cfg, TRAIN_CELL)[0]
        ref = {"losses": [], "grad_norms": [], "step_ms": []}
        for i, batch in enumerate(batches):
            reset_launches()
            (state, m), s = timed(lambda: step_fn(state, batch))
            expect_counts(f"mesh_tp_train unsharded step {i + 1}", per_step)
            ref["losses"].append(float(m["loss"]))
            ref["grad_norms"].append(float(m["grad_norm"]))
            ref["step_ms"].append(1e3 * s)
        ref["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        ref_state = [t.cpu() for t in tree_leaves(state)]
        del state
        torch.cuda.empty_cache()
        with open(ref_path, "w") as f:
            json.dump(ref, f)
        out["unsharded"] = ref
    dist.barrier()
    with open(ref_path) as f:
        ref = json.load(f)

    # 2. the partitioned steps; one rank at a time makes the whole state
    # from the seed and keeps its shards
    mesh = make_test_mesh(data=1, model=TP_MODEL, device_type=DEVICE)
    step_fn, (_, sspecs), _ = build_train_step(cfg, TRAIN_CELL, mesh)
    state = None
    for r in range(TP_MODEL):
        if r == rank:
            state = place_tree(make_train_state(cfg, 0, device=DEVICE),
                               sspecs, mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []
    with _Recorder() as rec:
        for i, batch in enumerate(batches):
            reset_launches()
            (state, m), s = timed(lambda: step_fn(state, batch))
            launches = expect_counts(f"mesh_tp_train rank {rank} step "
                                     f"{i + 1}", per_step)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(s)
    out.update(losses=losses, grad_norms=norms,
               step_ms=[1e3 * t for t in secs],
               median_ms=1e3 * statistics.median(secs),
               launches_per_step=launches, ssd_p=sorted(rec.ssd_p),
               flash_attention_heads=sorted(rec.fa_heads),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

    # 3. the losses and grad norms against the unsharded steps'
    errs = {"loss": [abs(a - b) / abs(b) for a, b in
                     zip(losses, ref["losses"])],
            "grad_norm": [abs(a - b) / abs(b) for a, b in
                          zip(norms, ref["grad_norms"])]}
    if not (max(errs["loss"]) <= TPT_LOSS_TOL
            and max(errs["grad_norm"]) <= TPT_NORM_TOL):
        raise AssertionError(f"mesh_tp_train rank {rank}: losses {losses} "
                             f"vs {ref['losses']}, grad norms {norms} vs "
                             f"{ref['grad_norms']}")
    out["rel_err"] = errs

    # 4. every rank's shard of every state leaf against the unsharded
    # state's slice
    held = held_state_shards("mesh_tp_train", rank, state, sspecs, names,
                             ref_state, "model")
    if reference:
        out["state"] = held
    del ref_state
    dist.barrier()

    # 5. one more step, each collective timed between synchronizes
    coll: dict = {}
    with timed_collectives(coll):
        state, _ = step_fn(state, batches[-1])
    out["collectives"] = coll
    del state
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def phase_mesh_tp_train(card: str) -> dict:
    """Slice 15, ``mesh_tp_train``: the train step partitioned over
    'model', by TP_MODEL gloo ranks that share the card (each a process
    of its own, ``make_test_mesh(data=1, model=TP_MODEL)``), on
    zamba2-2.7b at its published widths and TP_LAYERS of its 54 layers,
    compute in fp32, AdamW, MESH_TRAIN_STEPS steps of TRAIN_CELL from
    seed 0.

    1. Rank 0 runs the unsharded steps (``build_train_step(cfg, cell)``)
       alone while rank 1 waits, keeps the losses, the grad norms and the
       state on the host, and frees the card.
    2. Each rank makes the state from the seed in turn and keeps its
       shards (``place_tree``), then both run the partitioned steps:
       launches a step on each rank (counts set to 0 just before, read
       just after) :func:`train_counts` (K5 108 at P 32, K4 9 at 16
       q-heads, K1-K3 0).
    3. Each step's loss within TPT_LOSS_TOL and grad norm within
       TPT_NORM_TOL of the unsharded step's, relative.  Derivation: both
       runs are fp32 and differ only in the order of sums (the
       row-parallel products' halves, the all-reduces); ``mesh_tp`` holds
       this model's partitioned fp32 logits to TP_TOL (1e-4) of their
       scale and has measured them within 3e-5 (``PERF.md``), and the
       loss moves by at most twice the logits' error: 1e-4.  The
       gradients go back through as many layers again, and the norm adds
       the squares of every leaf: ten times that, 1e-3.
    4. Every rank's shard of every state leaf after the last step against
       the unsharded state's slice: m and v (linear and quadratic in the
       clipped gradient) within TPT_STATE_TOL of the slice's largest
       entry, as the grad norm; each parameter within
       :func:`adamw_step_bound` (1.8e-5 after the warm-up's steps 1-2:
       an entry whose gradient is at rounding level may move either way)
       plus 2 ulps of the slice's largest entry; the step counters equal.
    5. One more step with each collective timed.
    Per rank: ms a step, collective ms and ``max_memory_allocated``,
    beside the unsharded step's.  Fails if a rank fails or outlives
    TP_TIMEOUT."""
    t_phase = time.perf_counter()
    ranks = run_ranks(TPT_CHILD, "mesh_tp_train")
    lm = ARCHS[LM_ARCH]
    for res in ranks:
        if res["ssd_p"] != [lm.ssm_head_dim // TP_MODEL] or \
                res["flash_attention_heads"] != [lm.n_heads // TP_MODEL]:
            raise AssertionError(f"mesh_tp_train rank {res['rank']}: K5 at "
                                 f"P {res['ssd_p']}, K4 at heads "
                                 f"{res['flash_attention_heads']}")
        if res["losses"] != ranks[0]["losses"] or \
                res["grad_norms"] != ranks[0]["grad_norms"]:
            raise AssertionError("mesh_tp_train: the ranks report different "
                                 "losses or grad norms")
    r0 = ranks[0]
    ref = r0["unsharded"]
    result = {"mesh_tp_train": LM_ARCH, "mesh": f"make_test_mesh(data=1, "
              f"model={TP_MODEL}): {TP_MODEL} gloo ranks sharing one card",
              "compute": "float32", "optimizer": "adamw",
              "cell": dataclasses.asdict(TRAIN_CELL),
              "steps": MESH_TRAIN_STEPS,
              "tol": {"loss": TPT_LOSS_TOL, "grad_norm": TPT_NORM_TOL,
                      "moments": TPT_STATE_TOL,
                      "params": r0["state"]["param_bound"]},
              "ranks": ranks,
              "timer": "host clock around synchronize, each step; "
                       "collectives of one more step, each between "
                       "synchronizes",
              "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    for res in ranks:
        coll = res["collectives"]
        print(f"mesh_tp_train rank {res['rank']}: {LM_ARCH} fp32 train "
              f"step of {TRAIN_CELL.global_batch} x {TRAIN_CELL.seq_len} "
              f"{[round(t, 1) for t in res['step_ms']]} ms (unsharded "
              f"{[round(t, 1) for t in ref['step_ms']]}), collectives "
              f"{sum(e['ms'] for e in coll.values()):.1f} ms a step ("
              + ", ".join(f"{k} {e['calls']} x {e['bytes'] / 1e9:.3f} GB"
                          for k, e in sorted(coll.items()))
              + f"), peak {res['peak_memory_gb']:.2f} GB (unsharded "
              f"{ref['peak_memory_gb']:.2f}); launches a step "
              f"{res['launches_per_step']} (K5 at P {res['ssd_p']}, K4 at "
              f"{res['flash_attention_heads']} heads); card {card}",
              flush=True)
    st = r0["state"]
    print(f"mesh_tp_train: losses {r0['losses']} vs {ref['losses']} "
          f"(rel_err {max(r0['rel_err']['loss']):.3g}), grad norms "
          f"{r0['grad_norms']} vs {ref['grad_norms']} (rel_err "
          f"{max(r0['rel_err']['grad_norm']):.3g}); {st['leaves']} state "
          f"leaves of {TP_MODEL} ranks: moments within "
          f"{st['worst_moment_err_of_scale'][0]:.3g} of scale, parameters "
          f"within {st['worst_param_err_of_bound'][0]:.3g} of AdamW's "
          f"bound {st['param_bound']:.3g}; card {card}", flush=True)
    return {"per_step_per_rank": r0["launches_per_step"]}


def mesh_fsdp_rank(rank: int, workdir: str) -> None:
    """One rank of slice 16's ``mesh_fsdp`` phase (``FSDP_CHILD``)."""
    gloo_rank(rank, workdir, mesh_fsdp_run)


def coll_summary(log: dict, times: int = 1) -> dict:
    """Calls and GB by collective type from a ``timed_collectives`` log,
    per one of ``times`` steps."""
    return {k: {"calls": e["calls"] / times, "gb": e["bytes"] / times / 1e9}
            for k, e in sorted(log.items())}


def mesh_fsdp_train(rank: int, workdir: str, mesh) -> dict:
    """Part 1 of a ``mesh_fsdp`` rank: LM_ARCH with ``fsdp=True``, fp32,
    MESH_TRAIN_STEPS AdamW steps of TRAIN_CELL from seed 0, each rank one
    sequence, beside rank 0's unsharded steps (run first, alone; the
    state kept on the host)."""
    cfg = dataclasses.replace(ARCHS[LM_ARCH], compute_dtype="float32",
                              fsdp=True)
    per_step = train_counts(cfg)
    batches = list(itertools.islice(
        synthetic_batches(cfg, TRAIN_CELL, seed=0, device=DEVICE),
        MESH_TRAIN_STEPS))
    names = leaf_names(make_train_state(cfg, 0, device="meta"))
    reference, ref_state = rank == 0, None
    ref_path = os.path.join(workdir, "fsdp_train_unsharded.json")
    out: dict = {}
    if reference:
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(cfg, 0, device=DEVICE)
        step_fn = build_train_step(cfg, TRAIN_CELL)[0]
        ref = {"losses": [], "grad_norms": [], "step_ms": []}
        for i, batch in enumerate(batches):
            reset_launches()
            (state, m), s = timed(lambda: step_fn(state, batch))
            expect_counts(f"mesh_fsdp unsharded step {i + 1}", per_step)
            ref["losses"].append(float(m["loss"]))
            ref["grad_norms"].append(float(m["grad_norm"]))
            ref["step_ms"].append(1e3 * s)
        ref["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        ref_state = [t.cpu() for t in tree_leaves(state)]
        del state
        torch.cuda.empty_cache()
        with open(ref_path, "w") as f:
            json.dump(ref, f)
        out["unsharded"] = ref
    dist.barrier()
    with open(ref_path) as f:
        ref = json.load(f)

    step_fn, (_, sspecs), _ = build_train_step(cfg, TRAIN_CELL, mesh)
    split = sum(1 for s in tree_leaves(sspecs["params"])
                if any("data" in axes_of(e) for e in s))
    state = None
    for r in range(TP_MODEL):
        if r == rank:
            state = place_tree(make_train_state(cfg, 0, device=DEVICE),
                               sspecs, mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs, coll = [], [], [], {}
    with timed_collectives(coll, sync=False):
        for i, batch in enumerate(batches):
            reset_launches()
            (state, m), s = timed(lambda: step_fn(state, batch))
            launches = expect_counts(f"mesh_fsdp rank {rank} train step "
                                     f"{i + 1}", per_step)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(s)
    out.update(losses=losses, grad_norms=norms,
               step_ms=[1e3 * t for t in secs],
               launches_per_step=launches, leaves_split_over_data=split,
               collectives_per_step=coll_summary(coll, len(batches)),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    errs = {"loss": [abs(a - b) / abs(b) for a, b in
                     zip(losses, ref["losses"])],
            "grad_norm": [abs(a - b) / abs(b) for a, b in
                          zip(norms, ref["grad_norms"])]}
    if not (max(errs["loss"]) <= TPT_LOSS_TOL
            and max(errs["grad_norm"]) <= TPT_NORM_TOL):
        raise AssertionError(f"mesh_fsdp rank {rank}: losses {losses} vs "
                             f"{ref['losses']}, grad norms {norms} vs "
                             f"{ref['grad_norms']}")
    out["rel_err"] = errs
    held = held_state_shards("mesh_fsdp", rank, state, sspecs, names,
                             ref_state, "data")
    if reference:
        out["state"] = held
    del state, ref_state
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def random_cache(cfg, batch: int, max_len: int, seed: int) -> dict:
    """A decode cache whose every leaf holds a seeded random history."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tree_map(
        lambda t: torch.randn(t.shape, generator=g, device=DEVICE,
                              dtype=t.dtype),
        init_cache(cfg, batch, max_len, device=DEVICE))


def mesh_fsdp_serve(rank: int, workdir: str, mesh, label: str, cfg,
                    batch: int, prompt: int, max_len: int, first_pos: int,
                    steps: int, per_prefill: dict | None,
                    per_step: dict) -> dict:
    """Parts 2 and 3 of a ``mesh_fsdp`` rank: ``cfg``'s prefill of
    ``batch`` x ``prompt`` seeded tokens (none where ``per_prefill`` is
    None: the first token is then seeded) and ``steps`` greedy decode
    steps from ``first_pos`` of a seeded cache of ``max_len``, by
    ``build_prefill_step`` / ``build_decode_step`` on ``mesh`` (the
    parameters made from seed 0 by one rank at a time and placed), beside
    rank 0's unsharded ``prefill_fn`` / ``decode_fn``, run first and
    alone, its results kept on the host: logits within TP_TOL of their
    scale, greedy tokens equal, every rank's cache shards within TP_TOL
    of the unsharded cache's rows."""
    reference = rank == 0
    g = torch.Generator(device=DEVICE).manual_seed(16)
    tokens = torch.randint(0, cfg.vocab_size, (batch, max(prompt, 1)),
                           device=DEVICE, generator=g)
    out: dict = {}
    ref: dict = {}
    if reference:
        params = init_model(cfg, 0, device=DEVICE)
        if per_prefill is not None:
            want, s = timed(lambda: prefill_fn(cfg, params, tokens=tokens))
            ref["prefill"], ref["prefill_ms"] = want.cpu(), 1e3 * s
            tok = want[:, -1].argmax(dim=-1, keepdim=True)
        else:
            tok = tokens[:, :1]
        cache = random_cache(cfg, batch, max_len, 17)
        ref.update(decode=[], tokens=[], decode_ms=[])
        for i in range(steps):
            (w, cache), s = timed(lambda: decode_fn(cfg, params, cache, tok,
                                                    first_pos + i))
            ref["decode"].append(w.cpu())
            ref["tokens"].append(tok.flatten().tolist())
            ref["decode_ms"].append(1e3 * s)
            tok = w[:, -1].argmax(dim=-1, keepdim=True)
        ref["cache"] = [t.cpu() for t in tree_leaves(cache)]
        ref["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, cache, w
        torch.cuda.empty_cache()
        out["unsharded"] = {"prefill_ms": ref.get("prefill_ms"),
                            "decode_ms": ref["decode_ms"],
                            "peak_memory_gb": ref["peak_memory_gb"]}
    dist.barrier()

    prefill, (_, pspecs), _ = build_prefill_step(
        cfg, ShapeCell("prefill", max(prompt, 1), batch, "prefill"), mesh)
    decode, (_, dspecs), (_, bspecs) = build_decode_step(
        cfg, ShapeCell("decode", max_len, batch, "decode"), mesh)
    if tree_leaves(pspecs) != tree_leaves(dspecs):
        raise AssertionError(f"{label}: the prefill and decode specs "
                             f"differ; the parameters are placed once")
    placed = None
    for r in range(TP_MODEL):
        if r == rank:
            placed = place_tree(init_model(cfg, 0, device=DEVICE), pspecs,
                                mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    coll: dict = {"prefill": {}, "decode": {}}
    if per_prefill is not None:
        reset_launches()
        with timed_collectives(coll["prefill"], sync=False):
            got, s = timed(lambda: prefill(placed, {"tokens": tokens}))
        out["prefill"] = {
            "launches": expect_counts(f"{label} rank {rank} prefill",
                                      per_prefill),
            "tiled_mm_paths": expect_fp32_paths(
                f"{label} rank {rank} prefill", per_prefill["tiled_mm"]),
            "ms": 1e3 * s}
        if reference:
            err = rel_scale_err(got.cpu(), ref["prefill"])
            if not err <= TP_TOL:
                raise AssertionError(f"{label} prefill: logits differ by "
                                     f"{err:.3g} of their scale")
            out["prefill"]["err_of_scale"] = err
        tok = got[:, -1].argmax(dim=-1, keepdim=True)
    else:
        tok = tokens[:, :1]
    cache = place_tree(random_cache(cfg, batch, max_len, 17),
                       bspecs["cache"], mesh)
    done = {"ms": [], "err_of_scale": []}
    for i in range(steps):
        if reference and tok.flatten().tolist() != ref["tokens"][i]:
            raise AssertionError(f"{label} decode step {i}: greedy tokens "
                                 f"{tok.flatten().tolist()} vs unsharded "
                                 f"{ref['tokens'][i]}")
        reset_launches()
        with timed_collectives(coll["decode"], sync=False):
            (lg, cache), s = timed(lambda: decode(placed, cache, tok,
                                                  first_pos + i))
        expect_counts(f"{label} rank {rank} decode step {i}", per_step)
        expect_fp32_paths(f"{label} rank {rank} decode step {i}",
                          per_step["tiled_mm"])
        done["ms"].append(1e3 * s)
        if reference:
            err = rel_scale_err(lg.cpu(), ref["decode"][i])
            if not err <= TP_TOL:
                raise AssertionError(f"{label} decode step {i}: logits "
                                     f"differ by {err:.3g} of their scale")
            done["err_of_scale"].append(err)
        tok = lg[:, -1].argmax(dim=-1, keepdim=True)
    out["decode"] = {**done, "launches_per_step": per_step,
                     "median_ms": statistics.median(done["ms"])}
    out["collectives"] = {
        "prefill": coll_summary(coll["prefill"]),
        "decode_per_step": coll_summary(coll["decode"], steps)}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # every rank's cache rows against the unsharded cache's
    torch.save([d.to_local().cpu() for d in tree_leaves(cache)],
               os.path.join(workdir, f"{label}-cache{rank}.pt"))
    dist.barrier()
    if reference:
        worst = 0.0
        for r in range(TP_MODEL):
            shards = torch.load(os.path.join(workdir,
                                             f"{label}-cache{r}.pt"))
            for t, w, sp in zip(shards, ref["cache"],
                                tree_leaves(bspecs["cache"])):
                e = rel_scale_err(t, shard_of(w, sp, r, "data"))
                if not e <= TP_TOL:
                    raise AssertionError(f"{label}: rank {r}'s cache rows "
                                         f"differ by {e:.3g}")
                worst = max(worst, e)
        out["cache"] = {"leaves": len(ref["cache"]),
                        "worst_err_of_scale": worst}
    del placed, cache
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def mesh_fsdp_run(rank: int, workdir: str) -> dict:
    """The body of one ``mesh_fsdp`` rank (see :func:`phase_mesh_fsdp`)."""
    mesh = make_test_mesh(data=TP_MODEL, model=1, device_type=DEVICE)
    lm = dataclasses.replace(ARCHS[LM_ARCH], n_layers=FSDP_SERVE_LAYERS,
                             compute_dtype="float32", fsdp=True)
    moe = dataclasses.replace(ARCHS[FSDP_MOE_ARCH], n_layers=FSDP_MOE_LAYERS,
                              compute_dtype="float32", fsdp=True)
    lm_prefill = {"tiled_mm": lm.n_layers // lm.attn_every * 6 + 1,
                  "flash_attention": lm.n_layers // lm.attn_every,
                  "ssd": lm.n_layers}
    out = {"rank": rank, "train": mesh_fsdp_train(rank, workdir, mesh)}
    out["serve"] = mesh_fsdp_serve(
        rank, workdir, mesh, "mesh_fsdp serve", lm, LM_BATCH, LM_PROMPT,
        LM_MAX_LEN, LM_PROMPT, TP_DECODE, lm_prefill,
        {**lm_prefill, "flash_attention": 0, "ssd": 0})
    out["moe_decode"] = mesh_fsdp_serve(
        rank, workdir, mesh, "mesh_fsdp moe", moe, FSDP_MOE_BATCH, 0,
        FSDP_MOE_MAX_LEN, FSDP_MOE_POS, FSDP_MOE_DECODE, None,
        {"tiled_mm": 4 * moe.n_layers + 1, "flash_attention": 0, "ssd": 0})
    return out


def phase_mesh_fsdp(card: str) -> dict:
    """Slice 16, ``mesh_fsdp``: FSDP gathered layer by layer, by TP_MODEL
    gloo ranks that share the card (each a process of its own,
    ``make_test_mesh(data=TP_MODEL, model=1)``): every leaf that
    ``fsdp=True`` splits over 'data' is the rank's shard, gathered just
    before its layer and its gradient reduce-scattered.

    1. LM_ARCH (zamba2-2.7b) at its published widths and all 54 layers,
       fp32, ``fsdp=True``: MESH_TRAIN_STEPS AdamW steps of TRAIN_CELL
       from seed 0, one sequence a rank, beside rank 0's unsharded steps
       (run first, alone): losses within TPT_LOSS_TOL and grad norms
       within TPT_NORM_TOL relative, every rank's state shards as
       ``mesh_tp_train`` holds them (:func:`held_state_shards`, the
       derivations of :func:`phase_mesh_tp_train`); launches a step
       :func:`train_counts`.
    2. LM_ARCH served at FSDP_SERVE_LAYERS (12) of its layers, so the
       shared block serves two groups: a prefill of LM_BATCH x LM_PROMPT
       and TP_DECODE greedy decode steps at the LM phase's cache depth,
       two rows a rank, against rank 0's unsharded steps at TP_TOL,
       greedy tokens equal, the cache rows too
       (:func:`mesh_fsdp_serve`); K1 13 (ffma), K4 2 and K5 12 a
       prefill, K1 13 a decode step.
    3. FSDP_MOE_ARCH (dbrx-132b) at published widths cut to
       FSDP_MOE_LAYERS of its 40 layers, bf16 parameters computed in
       fp32: FSDP_MOE_DECODE greedy decode steps of FSDP_MOE_BATCH rows, two a
       rank, the MoE's input rows gathered over 'data' for its one
       expert-choice group; held as part 2; K1 4 a layer and the head's
       1 a step.
    Per rank: peak memory, ms a step, the collectives' calls and GB by
    type (counted, not timed), launches.  Fails if a rank fails or
    outlives TP_TIMEOUT."""
    t_phase = time.perf_counter()
    ranks = run_ranks(FSDP_CHILD, "mesh_fsdp")
    for res in ranks:
        if res["train"]["losses"] != ranks[0]["train"]["losses"] or \
                res["train"]["grad_norms"] != ranks[0]["train"]["grad_norms"]:
            raise AssertionError("mesh_fsdp: the ranks report different "
                                 "losses or grad norms")
    r0 = ranks[0]
    result = {"mesh_fsdp": [LM_ARCH, FSDP_MOE_ARCH],
              "mesh": f"make_test_mesh(data={TP_MODEL}, model=1): "
                      f"{TP_MODEL} gloo ranks sharing one card",
              "compute": "float32", "optimizer": "adamw",
              "train_cell": dataclasses.asdict(TRAIN_CELL),
              "train_steps": MESH_TRAIN_STEPS,
              "serve": {"layers": FSDP_SERVE_LAYERS,
                        "prompt": [LM_BATCH, LM_PROMPT], "max_len":
                        LM_MAX_LEN, "decode_steps": TP_DECODE},
              "moe_decode": {"layers": FSDP_MOE_LAYERS, "params": "bfloat16",
                             "batch": FSDP_MOE_BATCH, "first_pos":
                             FSDP_MOE_POS, "max_len": FSDP_MOE_MAX_LEN,
                             "decode_steps": FSDP_MOE_DECODE},
              "tol": {"loss": TPT_LOSS_TOL, "grad_norm": TPT_NORM_TOL,
                      "moments": TPT_STATE_TOL,
                      "params": r0["train"]["state"]["param_bound"],
                      "logits": TP_TOL},
              "ranks": ranks,
              "timer": "host clock around synchronize, each step; the "
                       "collectives counted, not timed",
              "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)

    def colls(c):
        return ", ".join(f"{k} {e['calls']:g} x {e['gb']:.3f} GB"
                         for k, e in c.items())

    for res in ranks:
        tr, sv, moe = res["train"], res["serve"], res["moe_decode"]
        print(f"mesh_fsdp rank {res['rank']}: {LM_ARCH} fsdp fp32 train "
              f"step {[round(t, 1) for t in tr['step_ms']]} ms (unsharded "
              f"{[round(t, 1) for t in r0['train']['unsharded']['step_ms']]}"
              f"), peak {tr['peak_memory_gb']:.2f} GB (unsharded "
              f"{r0['train']['unsharded']['peak_memory_gb']:.2f}), "
              f"{tr['leaves_split_over_data']} leaves split over 'data', a "
              f"step {colls(tr['collectives_per_step'])}, launches "
              f"{tr['launches_per_step']}; serving ({FSDP_SERVE_LAYERS} "
              f"layers) prefill "
              f"{sv['prefill']['ms']:.1f} ms (unsharded "
              f"{r0['serve']['unsharded']['prefill_ms']:.1f}), "
              f"{colls(sv['collectives']['prefill'])}; decode "
              f"{sv['decode']['median_ms']:.1f} ms a step (unsharded "
              f"{statistics.median(r0['serve']['unsharded']['decode_ms']):.1f}"
              f"), {colls(sv['collectives']['decode_per_step'])}, peak "
              f"{sv['peak_memory_gb']:.2f} GB; {FSDP_MOE_ARCH} "
              f"{FSDP_MOE_LAYERS}-layer decode "
              f"{moe['decode']['median_ms']:.1f} ms a step (unsharded "
              f"{statistics.median(r0['moe_decode']['unsharded']['decode_ms']):.1f}"
              f"), {colls(moe['collectives']['decode_per_step'])}, peak "
              f"{moe['peak_memory_gb']:.2f} GB (unsharded "
              f"{r0['moe_decode']['unsharded']['peak_memory_gb']:.2f}), "
              f"launches a step {moe['decode']['launches_per_step']}; card "
              f"{card}", flush=True)
    tr, st = r0["train"], r0["train"]["state"]
    print(f"mesh_fsdp: train losses {tr['losses']} vs "
          f"{tr['unsharded']['losses']} (rel_err "
          f"{max(tr['rel_err']['loss']):.3g}), grad norms rel_err "
          f"{max(tr['rel_err']['grad_norm']):.3g}; {st['leaves']} state "
          f"leaves: moments within {st['worst_moment_err_of_scale'][0]:.3g} "
          f"of scale, parameters within "
          f"{st['worst_param_err_of_bound'][0]:.3g} of AdamW's bound; "
          f"serving logits within {TP_TOL} (prefill "
          f"{r0['serve']['prefill']['err_of_scale']:.3g}, decode worst "
          f"{max(r0['serve']['decode']['err_of_scale']):.3g}), MoE decode "
          f"worst {max(r0['moe_decode']['decode']['err_of_scale']):.3g}, "
          f"greedy tokens equal, caches within "
          f"{r0['serve']['cache']['worst_err_of_scale']:.3g} / "
          f"{r0['moe_decode']['cache']['worst_err_of_scale']:.3g}; card "
          f"{card}", flush=True)
    return {"train_per_step_per_rank": tr["launches_per_step"],
            "prefill_per_rank": r0["serve"]["prefill"]["launches"],
            "decode_per_step_per_rank":
                r0["serve"]["decode"]["launches_per_step"],
            "moe_decode_per_step_per_rank":
                r0["moe_decode"]["decode"]["launches_per_step"]}


def mesh_pipeline() -> dict:
    """``build_pp_forward`` on a one-stage ('pod',) mesh: PP_ARCH at its
    published widths and PP_LAYERS layers (random weights from a seed),
    PP_MICRO microbatches of 1 x PP_TOKENS tokens in the compute dtype,
    against the sequential ``_scan_blocks`` on each."""
    cfg = dataclasses.replace(ARCHS[PP_ARCH], n_layers=PP_LAYERS)
    params = init_model(cfg, 0, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(17)
    mbs = torch.randn((PP_MICRO, 1, PP_TOKENS, cfg.d_model), generator=g,
                      device=DEVICE).to(cfg.compute_torch_dtype)
    stage = init_device_mesh(DEVICE, (1,), mesh_dim_names=("pod",))
    fn, stages = build_pp_forward(cfg, stage, stage_axis="pod",
                                  microbatches=PP_MICRO)
    body = lambda p, h: _attn_block_fwd(cfg, p, h)
    with torch.inference_mode():
        reset_launches()
        want = torch.stack([_scan_blocks(body, mbs[i], params["blocks"],
                                         cfg.n_layers)
                            for i in range(PP_MICRO)])
        torch.cuda.synchronize()
        seq_counts = launch_counts()
        reset_launches()
        got = fn(split_stages(params, stages), mbs)
        torch.cuda.synchronize()
        pp_counts = launch_counts()
    if stages != 1 or not torch.equal(got, want):
        raise AssertionError("pipeline mode: the one-stage pipeline differs "
                             "from the sequential blocks")
    if pp_counts != seq_counts or not (pp_counts["tiled_mm"]
                                       and pp_counts["flash_attention"]):
        raise AssertionError(f"pipeline mode: launches {pp_counts}, the "
                             f"sequential blocks' {seq_counts}")
    return {"arch": PP_ARCH, "layers": PP_LAYERS, "microbatches": PP_MICRO,
            "tokens_per_microbatch": PP_TOKENS, "bitwise": True,
            "launches": pp_counts}


def mesh_local_sgd(params: dict) -> dict:
    """``sync_pods_compressed`` over a (pod 1, data 1) mesh on two of the
    LM's largest leaves with a random drift: bitwise ``anchor +
    dequantize(quantize(delta))`` and ``delta - dequantize(...)``."""
    mesh = init_device_mesh(DEVICE, (1, 1), mesh_dim_names=("pod", "data"))
    g = torch.Generator(device=DEVICE).manual_seed(19)
    anchor = {"embed": params["embed"],
              "out_proj": params["blocks"]["mixer"]["out_proj"]}
    cur = tree_map(lambda a: a + 1e-3 * torch.randn(
        a.shape, generator=g, device=DEVICE, dtype=a.dtype), anchor)
    err = init_error_feedback(anchor)
    (new_p, new_a, new_e), s = timed(
        lambda: sync_pods_compressed(cur, anchor, err, mesh=mesh))
    for name in anchor:
        p, a, e = cur[name], anchor[name], err[name]
        delta = (p - a).to(torch.float32) + e
        deq = dequantize_int8(*quantize_int8(delta), p.shape)
        want_p = (a.to(torch.float32) + deq).to(p.dtype)
        if not (torch.equal(new_p[name], want_p) and new_a is new_p
                and torch.equal(new_e[name], delta - deq)):
            raise AssertionError(f"local SGD: {name} is not anchor + "
                                 f"dequantize(quantize(delta)) bit for bit")
    n = sum(t.numel() for t in anchor.values())
    return {"leaves": sorted(anchor), "elements": n, "bitwise": True,
            "ms": 1e3 * s}


def phase_mesh_training(card: str) -> dict:
    """Slice 12, ``mesh``, the train step: LM_ARCH at full width and depth,
    MESH_TRAIN_STEPS bf16 AdamW steps of TRAIN_CELL from the state of
    seed 0, first unsharded (``build_train_step(cfg, cell)``), then, the
    state freed and made again from the seed, over a one-rank mesh
    (``build_train_step(cfg, cell, mesh)``, the state placed by its
    specs).  Launches per step exactly :func:`train_counts` on both; each
    step's loss and grad norm bitwise, and every state leaf's digest
    (:func:`leaf_digest`) and first 4,096 entries equal after the last
    step.  The two states never share the card."""
    t_phase = time.perf_counter()
    cfg = ARCHS[LM_ARCH]
    per_step = train_counts(cfg)
    batches = list(itertools.islice(
        synthetic_batches(cfg, TRAIN_CELL, seed=0, device=DEVICE),
        MESH_TRAIN_STEPS))

    def run(kind, step_fn, place=None):
        state = make_train_state(cfg, 0, device=DEVICE)
        if place is not None:
            state = place(state)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, secs = [], [], []
        for i, batch in enumerate(batches):
            reset_launches()
            (state, m), s = timed(lambda: step_fn(state, batch))
            expect_counts(f"{kind} train step {i + 1}", per_step)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(s)
        leaves = [t.to_local() if place is not None else t
                  for t in tree_leaves(state)]
        out = {"losses": losses, "grad_norms": norms,
               "step_ms": [1e3 * t for t in secs],
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "digests": [leaf_digest(t) for t in leaves],
               "samples": [t.reshape(-1)[:4096].cpu() for t in leaves]}
        del state, leaves
        torch.cuda.empty_cache()
        return out

    ref = run("unsharded", build_train_step(cfg, TRAIN_CELL)[0])
    with one_rank_group():
        mesh = make_test_mesh(data=1, model=1, device_type=DEVICE)
        step_fn, (_, sspecs), _ = build_train_step(cfg, TRAIN_CELL, mesh)
        got = run("mesh", step_fn,
                  lambda state: place_tree(state, sspecs, mesh))
    names = leaf_names(make_train_state(cfg, 0, device="meta"))
    if got["losses"] != ref["losses"] or got["grad_norms"] != ref[
            "grad_norms"]:
        raise AssertionError(f"mesh train steps: losses {got['losses']} / "
                             f"{ref['losses']}, grad norms "
                             f"{got['grad_norms']} / {ref['grad_norms']}")
    for name, a, b, x, y in zip(names, got["digests"], ref["digests"],
                                got["samples"], ref["samples"]):
        if a != b or not torch.equal(x, y):
            raise AssertionError(f"mesh train steps: state leaf {name} "
                                 f"differs from the unsharded step's")
    result = {"mesh": "make_test_mesh(data=1, model=1)", "lm": LM_ARCH,
              "cell": dataclasses.asdict(TRAIN_CELL), "optimizer": "adamw",
              "steps": MESH_TRAIN_STEPS, "note": MESH_NOTE,
              "bitwise": {"losses": ref["losses"],
                          "grad_norms": ref["grad_norms"],
                          "state_leaves": len(names)},
              "launches_per_step": per_step,
              "step_ms": {"unsharded": ref["step_ms"],
                          "mesh": got["step_ms"]},
              "peak_memory_gb": {"unsharded": ref["peak_memory_gb"],
                                 "mesh": got["peak_memory_gb"]},
              "timer": "host clock around synchronize, each step",
              "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    print(f"mesh: {LM_ARCH} {MESH_TRAIN_STEPS} train steps on a one-rank "
          f"mesh bitwise the unsharded steps (losses {ref['losses']}, all "
          f"{len(names)} state leaves), ms per step {got['step_ms']} vs "
          f"{ref['step_ms']}, peak memory {got['peak_memory_gb']:.2f} vs "
          f"{ref['peak_memory_gb']:.2f} GB; {MESH_NOTE}; card {card}",
          flush=True)
    return {"per_step": per_step,
            "unsharded_peak_bytes": ref["peak_memory_bytes"]}


def phase_adafactor(card: str) -> dict:
    """Slice 17, ``adafactor``: ADA_ARCH cut to ADA_LAYERS layers of
    ADA_EXPERTS experts at ADA_WIDTHS (fp32), ADA_STEPS train steps
    (``build_train_step``, donate) from one state made on the CPU, on the
    CPU and on the card: Adafactor takes each stacked leaf one layer's
    slice at a time.  Held to the CPU's with the train tolerances of
    ``mesh_tp_train``'s kind: each step's loss within TRAIN_REDUCED_TOL
    (relative), the statistics within TPT_STATE_TOL of each leaf's
    largest entry, a factored parameter within TRAIN_REDUCED_TOL of its
    largest entry, an unfactored one within Adafactor's own bound
    (:func:`adafactor_step_bound`: its update is g/√v elementwise, which
    gives an entry whose gradient is at rounding level a move of either
    sign up to lr), the step counter equal.  The step traced on ``meta``
    by ``analyze_step`` calls each kernel as often as the card launched
    it in each step, and its peak (the state and a batch plus the
    trace's peak) is within DRYRUN_PEAK_TOL of the card's
    ``max_memory_allocated`` over the last step, less what else was
    allocated (the BLAS workspaces, the earlier phases' leftovers, which
    the trace does not see)."""
    t_phase = time.perf_counter()
    cfg = reduced(ARCHS[ADA_ARCH], n_layers=ADA_LAYERS,
                  n_experts=ADA_EXPERTS, **ADA_WIDTHS)
    if cfg.optimizer != "adafactor" or cfg.family != "moe":
        raise AssertionError(f"adafactor: {ADA_ARCH} is {cfg.family} with "
                             f"{cfg.optimizer}")
    step_fn, (aval, _), (ins, _) = build_train_step(cfg, ADA_CELL)
    argument = sum(t.numel() * t.element_size()
                   for t in tree_leaves(aval) + tree_leaves(ins))
    _, traced = analyze_step(step_fn, aval, ins)
    per_step = {k: traced.kernels.get(k, 0) for k in launch_counts()}
    if not per_step["flash_attention"]:
        raise AssertionError(f"adafactor: the traced step calls no "
                             f"flash_attention: {traced.kernels}")
    state0 = make_train_state(cfg, 31, device="cpu")
    runs = {}
    for dev in ("cpu", DEVICE):
        step_fn, _, _ = build_train_step(cfg, ADA_CELL)
        batches = list(itertools.islice(
            synthetic_batches(cfg, ADA_CELL, seed=4, device=dev), ADA_STEPS))
        state = copy_state(state0, dev)
        losses, secs = [], []
        for i, batch in enumerate(batches):
            # the card's bytes of the last step: its state and batch, and
            # what it allocates above everything else live (the BLAS
            # workspaces, the earlier phases' leftovers, the other batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() - sum(
                t.numel() * t.element_size()
                for t in tree_leaves(state) + tree_leaves(batch))
            reset_launches()
            (state, metrics), s = timed(lambda: step_fn(state, batch))
            if dev != "cpu":
                expect_counts(f"adafactor train step {i + 1}", per_step)
            losses.append(float(metrics["loss"]))
            secs.append(s)
        runs[dev] = {"state": state, "losses": losses,
                     "step_ms": [1e3 * s for s in secs],
                     "peak": torch.cuda.max_memory_allocated() - base}
        del batches
    cpu, got = runs["cpu"], runs[DEVICE]
    errs = {"loss": (max(abs(a - b) / abs(b) for a, b in zip(
        got["losses"], cpu["losses"])), "losses", TRAIN_REDUCED_TOL)}
    bound = adafactor_step_bound(AdafactorConfig(), ADA_STEPS)
    names = leaf_names(cpu["state"])
    for name, a, b in zip(names, tree_leaves(got["state"]),
                          tree_leaves(cpu["state"])):
        if not b.dim():
            if int(a) != int(b):
                raise AssertionError(f"adafactor: {name} {int(a)} on the "
                                     f"card, {int(b)} on the CPU")
            continue
        diff = float((a.cpu().float() - b.float()).abs().max())
        scale = max(float(b.float().abs().max()), 1e-30)
        if name.startswith("/opt/"):
            kind, err, tol = "statistics", diff / scale, TPT_STATE_TOL
        elif b.dim() >= 2 and min(b.shape[-2:]) >= 32:
            kind, err, tol = "factored", diff / scale, TRAIN_REDUCED_TOL
        else:       # an entry's own bound, whatever its gradient's size
            kind, err = "unfactored", diff / (
                bound + 2 * scale * torch.finfo(b.dtype).eps)
            tol = 1.0
        if not err <= tol:
            raise AssertionError(f"adafactor, card vs CPU: {name} ({kind}) "
                                 f"error {err:.3g} > {tol}")
        if err > errs.get(kind, (-1.0,))[0]:
            errs[kind] = (err, name, tol)
    traced_peak = argument + traced.peak_bytes
    ratio = traced_peak / got["peak"]
    if not abs(ratio - 1.0) <= DRYRUN_PEAK_TOL:
        raise AssertionError(f"adafactor: traced train-step peak "
                             f"{traced_peak / 1e9:.4f} GB vs the card's "
                             f"{got['peak'] / 1e9:.4f} GB (ratio "
                             f"{ratio:.4f}, tolerance {DRYRUN_PEAK_TOL})")
    stacked = sum(1 for t in tree_leaves(aval["params"]) if t.dim() > 2)
    top = [{k: g[k] for k in ("phase", "origin", "shape", "bytes")}
           for g in traced.peak_by_origin[:3]]
    result = {"adafactor": ADA_ARCH, "n_layers": ADA_LAYERS,
              "n_experts": ADA_EXPERTS, "widths": ADA_WIDTHS,
              "cell": dataclasses.asdict(ADA_CELL), "steps": ADA_STEPS,
              "stacked_leaves": stacked, "losses_card": got["losses"],
              "losses_cpu": cpu["losses"],
              "worst": {k: {"err": e, "leaf": n, "tol": t}
                        for k, (e, n, t) in errs.items()},
              "unfactored_bound": bound, "launches_per_step": per_step,
              "step_ms": {"card": got["step_ms"], "cpu": cpu["step_ms"]},
              "peak_bytes": {"card": got["peak"], "traced": traced_peak,
                             "ratio": ratio, "tol": DRYRUN_PEAK_TOL},
              "traced_peak_phase": traced.peak_phase,
              "traced_phase_peaks": {p: argument + n for p, n in
                                     traced.phase_peaks.items()},
              "traced_top_origins": top,
              "timer": "host clock around synchronize, each step",
              "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    print(f"adafactor: {ADA_ARCH} at {ADA_LAYERS} layers of {ADA_EXPERTS} "
          f"experts, {ADA_STEPS} Adafactor steps ({stacked} stacked leaves "
          f"taken slice by slice) on the card against the CPU over "
          f"{len(names)} state leaves, worst (error, leaf, tolerance): "
          f"{errs}; launches a step {per_step} = "
          f"traced; peak {got['peak'] / 1e9:.4f} GB max_memory_allocated vs "
          f"{traced_peak / 1e9:.4f} GB traced (ratio {ratio:.4f}), traced "
          f"peak in the {traced.peak_phase} phase: {top}; ms a step "
          f"{got['step_ms']}; card {card}", flush=True)
    return {"launches_per_step": per_step}


def adafactor_step_bound(opt_cfg, steps: int) -> float:
    """The most an entry of an unfactored leaf (its second moment ``v``
    elementwise) of two Adafactor runs from one state can differ after
    ``steps`` steps when their gradients differ (by rounding, or in sign
    where an entry's gradient is at rounding level): step t moves an
    entry by lr·(u_t/c_t + wd·p) with c_t >= 1 and |u_t| = |g_t|/√v_t
    <= 1/√(1 - β_t) = t^(decay/2), since v_t >= (1 - β_t)·g_t², so two
    moves differ by at most 2·lr·t^(decay/2), and a difference of the
    parameters by a factor 1 + lr·wd more (AdamW's counterpart:
    :func:`adamw_step_bound`)."""
    bound = 0.0
    for t in range(1, steps + 1):
        bound = (bound * (1 + opt_cfg.lr * opt_cfg.weight_decay)
                 + 2 * opt_cfg.lr * t ** (opt_cfg.decay / 2))
    return bound


def adafactor_launches(ada: dict, name: str) -> dict:
    """A kernel's launches in slice 17's Adafactor train steps."""
    return {"launches_per_step": ada["launches_per_step"].get(name, 0),
            "per": f"one {ADA_ARCH} train step at {ADA_LAYERS} layers of "
                   f"{ADA_EXPERTS} experts ({ADA_WIDTHS}), "
                   f"{ADA_CELL.global_batch} x {ADA_CELL.seq_len} tokens"}


def dryrun_cells(out_dir: str) -> list:
    """``python -m repro_torch.launch.dryrun`` of LM_ARCH at DRYRUN_SHAPE
    on both production meshes (256 and 512 fake ranks), each started in
    a process of its own (a process has one default group, and this one
    has held NCCL groups): their ``Popen`` handles."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         LM_ARCH, "--shape", DRYRUN_SHAPE, "--out", out_dir]
        + (["--multipod"] if multipod else []),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for multipod in (False, True)]


def phase_dryrun(card: str, lm: dict, training: dict,
                 mesh_train: dict) -> dict:
    """Slice 13, ``dryrun``: the dry run on this machine, and its traces
    against what the card measured on the same configs and inputs.

    1. ``python -m repro_torch.launch.dryrun --arch LM_ARCH --shape
       DRYRUN_SHAPE``, with and without ``--multipod``, in subprocesses:
       each record's status must be ``ok``; its memory, accounting and
       ``trace_s`` are printed.
    2. Meanwhile, here, LM_ARCH's unsharded prefill (LM_BATCH x LM_PROMPT)
       and AdamW train step (TRAIN_CELL, donate) traced on ``meta`` by
       ``analyze_step``: the traced calls per kernel (and K1's by path)
       must equal the launch counts the card gave the same runs (``lm``,
       ``training``); the traced train-step peak (the state and batch
       plus the trace's peak) must be within DRYRUN_PEAK_TOL of the
       card's ``max_memory_allocated`` over the unsharded mesh-phase
       steps; traced flops over the profiled device busy time as TFLOP/s.
    """
    t_phase = time.perf_counter()
    cfg = lm["cfg"]
    out_dir = tempfile.mkdtemp(prefix="dryrun-")
    procs = dryrun_cells(out_dir)
    try:
        params = init_model(cfg, 0, device="meta")
        tokens = torch.empty((LM_BATCH, LM_PROMPT), dtype=lm["tokens"].dtype,
                             device="meta")
        _, pre = analyze_step(prefill_fn, cfg, params, tokens=tokens)
        want = {k: v for k, v in lm["prefill"]["launches"].items() if v}
        paths = {p: n for p, n in
                 lm["prefill"]["tiled_mm_launches_by_path"].items() if n}
        if pre.kernels != want or pre.kernel_paths.get("tiled_mm") != paths:
            raise AssertionError(f"dryrun: traced prefill calls "
                                 f"{pre.kernels} {pre.kernel_paths}, the "
                                 f"card launched {want}, tiled_mm {paths}")
        step_fn, (state, _), (batch, _) = build_train_step(cfg, TRAIN_CELL)
        argument = sum(t.numel() * t.element_size()
                       for t in tree_leaves(state) + tree_leaves(batch))
        _, train = analyze_step(step_fn, state, batch)
        want_train = {k: v for k, v in training["launches_per_step"].items()
                      if v}
        if train.kernels != want_train:
            raise AssertionError(f"dryrun: traced train-step calls "
                                 f"{train.kernels}, the card launched "
                                 f"{want_train}")
        traced_peak = argument + train.peak_bytes
        card_peak = mesh_train["unsharded_peak_bytes"]
        ratio = traced_peak / card_peak
        if not abs(ratio - 1.0) <= DRYRUN_PEAK_TOL:
            raise AssertionError(f"dryrun: traced train-step peak "
                                 f"{traced_peak / 1e9:.3f} GB vs the card's "
                                 f"{card_peak / 1e9:.3f} GB (ratio "
                                 f"{ratio:.4f}, tolerance "
                                 f"{DRYRUN_PEAK_TOL})")
        traces_s = time.perf_counter() - t_phase
        cells = []
        for proc in procs:
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
            if proc.returncode != 0:
                raise AssertionError(f"dryrun exited {proc.returncode}: "
                                     f"{text[-3000:]}")
        for name in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, name)) as f:
                rec = json.load(f)
            if rec.get("status") != "ok":
                raise AssertionError(f"dryrun {name}: {rec.get('status')} "
                                     f"{rec.get('error')}\n"
                                     f"{rec.get('traceback', '')}")
            cells.append(rec)
        if len(cells) != 2:
            raise AssertionError(f"dryrun: {len(cells)} records, not 2")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)

    def tflops(flops, busy_ms):
        return None if not busy_ms else flops / (busy_ms / 1e3) / 1e12

    busy_pre = lm.get("device_busy_ms", {}).get("prefill")
    busy_train = training.get("device_busy_ms_per_step")
    result = {
        "dryrun": LM_ARCH,
        "production_cells": [
            {k: rec[k] for k in ("arch", "shape", "mesh", "kind", "memory",
                                 "hlo_accounting", "kernels", "trace_s")}
            for rec in cells],
        "against_the_card": {
            "prefill": {"requests": LM_BATCH, "prompt": LM_PROMPT,
                        "traced_calls": pre.kernels,
                        "traced_tiled_mm_paths": pre.kernel_paths.get(
                            "tiled_mm"),
                        "card_launches": want,
                        "traced_flops": pre.flops,
                        "traced_hbm_bytes": pre.hbm_bytes,
                        "device_busy_ms": busy_pre,
                        "tflops_per_s": tflops(pre.flops, busy_pre)},
            "train_step": {"cell": dataclasses.asdict(TRAIN_CELL),
                           "traced_calls": train.kernels,
                           "card_launches": want_train,
                           "traced_flops": train.flops,
                           "traced_hbm_bytes": train.hbm_bytes,
                           "device_busy_ms": busy_train,
                           "tflops_per_s": tflops(train.flops, busy_train),
                           "traced_peak_bytes": traced_peak,
                           "card_peak_bytes": card_peak,
                           "peak_ratio": ratio,
                           "peak_tol": DRYRUN_PEAK_TOL}},
        "traces_s": traces_s, "phase_s": time.perf_counter() - t_phase,
        "timer": "host clock; busy times from the LM and training "
                 "phases' profiled runs",
        "card": card}
    emit(result)
    for rec in cells:
        mem = rec["memory"]
        top = "; ".join(f"{g['origin']} {g['shape'] or ''} "
                        f"({g['phase'] or 'given'}) {g['bytes'] / 1e9:.3f}"
                        for g in mem["peak_by_origin"][:4])
        print(f"dryrun: {rec['arch']} {rec['shape']} on {rec['mesh']}: "
              f"argument {mem['argument_size_in_bytes'] / 1e9:.3f} GB, peak "
              f"{mem['peak_memory_in_bytes'] / 1e9:.3f} GB of 80 per rank, "
              f"in the {mem['peak_phase']} phase; largest origins (GB): "
              f"{top}; accounting {rec['hlo_accounting']}, kernels "
              f"{rec['kernels']}, trace {rec['trace_s']} s", flush=True)
    print(f"dryrun: traced vs card: prefill calls {pre.kernels} = "
          f"{want}; train step {train.kernels} = {want_train}; train peak "
          f"{traced_peak / 1e9:.3f} GB traced vs {card_peak / 1e9:.3f} GB "
          f"max_memory_allocated (ratio {ratio:.4f}); prefill "
          f"{tflops(pre.flops, busy_pre)} TFLOP/s, train step "
          f"{tflops(train.flops, busy_train)} TFLOP/s of traced flops over "
          f"profiled device busy time; card {card}", flush=True)
    return {"prefill": pre.kernels, "train_per_step": train.kernels}


def dryrun_calls(dry: dict, name: str) -> dict:
    """A kernel's traced calls in slice 13's dryrun phase."""
    return {"prefill": dry["prefill"].get(name, 0),
            "train_per_step": dry["train_per_step"].get(name, 0),
            "per": f"{LM_ARCH} traced on meta by analyze_step: a prefill of "
                   f"{LM_BATCH} x {LM_PROMPT} and a train step of "
                   f"{TRAIN_CELL.global_batch} x {TRAIN_CELL.seq_len}"}


def mesh_launches(mesh: dict, mesh_train: dict, name: str) -> dict:
    """A kernel's launches on slice 12's mesh paths."""
    return {"prefill": mesh["prefill"].get(name, 0),
            "decode_per_step": mesh["decode_per_step"].get(name, 0),
            "train_per_step": mesh_train["per_step"].get(name, 0),
            "pipeline": mesh["pipeline"].get(name, 0),
            "per": (f"{LM_ARCH} prefill {LM_BATCH} x {LM_PROMPT} and decode "
                    f"steps, {LM_ARCH} train steps of "
                    f"{TRAIN_CELL.global_batch} x {TRAIN_CELL.seq_len}, and "
                    f"{PP_ARCH} at {PP_LAYERS} layers in pipeline mode, over "
                    f"a one-rank mesh")}


def mesh_tp_launches(mesh_tp: dict, name: str) -> dict:
    """A kernel's launches on each rank of slice 14's partitioned steps."""
    return {"prefill_per_rank": mesh_tp["prefill_per_rank"].get(name, 0),
            "decode_per_step_per_rank":
                mesh_tp["decode_per_step_per_rank"].get(name, 0),
            "per": f"{LM_ARCH} fp32, prefill {LM_BATCH} x {LM_PROMPT} and "
                   f"decode steps, partitioned over {TP_MODEL} gloo ranks "
                   f"sharing the card"}


def mesh_tp_train_launches(mesh_tp_train: dict, name: str) -> dict:
    """A kernel's launches on each rank of slice 15's partitioned train
    step."""
    return {"per_step_per_rank":
                mesh_tp_train["per_step_per_rank"].get(name, 0),
            "per": f"one {LM_ARCH} fp32 train step of "
                   f"{TRAIN_CELL.global_batch} x {TRAIN_CELL.seq_len} "
                   f"tokens (remat), partitioned over {TP_MODEL} gloo "
                   f"ranks sharing the card"}


def mesh_fsdp_launches(mesh_fsdp: dict, name: str) -> dict:
    """A kernel's launches on each rank of slice 16's FSDP steps."""
    return {k: v.get(name, 0) for k, v in mesh_fsdp.items()} | {
        "per": f"{LM_ARCH} fp32 with fsdp: a train step on one of "
               f"{TRAIN_CELL.global_batch} sequences of "
               f"{TRAIN_CELL.seq_len} tokens; at "
               f"{FSDP_SERVE_LAYERS} layers a prefill of "
               f"{LM_BATCH // TP_MODEL} x {LM_PROMPT} and decode steps; "
               f"{FSDP_MOE_ARCH} at {FSDP_MOE_LAYERS} layers, decode steps "
               f"of {FSDP_MOE_BATCH // TP_MODEL} rows; each rank of "
               f"{TP_MODEL} gloo ranks over 'data' sharing the card"}


def training_launches(training: dict, name: str) -> dict:
    return {"launches_per_step": training["launches_per_step"][name],
            "per": f"one {LM_ARCH} train step of "
                   f"{TRAIN_CELL.global_batch} x {TRAIN_CELL.seq_len} "
                   f"tokens (remat)"}


def summary(t: dict) -> dict:
    """The kernels line's time keys from per-forward totals."""
    return {"ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["by_ops_ms"] >= t["by_bytes_ms"]
                         else "bytes"),
            "library_ms": t["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    # phase 1: device
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build, one nvcc per source, all started together
    t0 = time.perf_counter()
    errors = []

    def build(load):
        try:
            load()
        except BaseException as e:     # re-raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(load,))
               for load in (load_tiled_mm, load_vpu_mm, load_qmm,
                            load_flash_attention, load_ssd,
                            load_ssd_witness)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"set-up: tiled_mm, vpu_mm, qmm, flash_attention, ssd and ssd's "
          f"witness built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    # phase 3: kernels against their plain versions
    main_err = phase_kernels()
    phase_k1_bf16()
    vpu_err = phase_vpu_kernel()
    phase_fmaf_witness()
    phase_sass()
    qmm_err = phase_qmm_kernel()
    flash_err = phase_flash_kernel()
    ssd_err = phase_ssd_kernel()
    phase_ssd_witness()
    ssd_widths = phase_ssd_widths(card)
    backward = phase_kernel_backward(card)

    # phase 4: the main paths (fp32, then int8)
    main = phase_main_path()
    run = phase_runtime_path(main)
    phase_quantization(card, main)
    decode = phase_decode_paths(main)
    lm = phase_lm(card)
    phase_reduced_lm()
    serving = phase_serving(card, lm)
    durability = phase_durability(card, lm, serving)

    # phase 5: times
    totals, dispatcher_s = phase_times(card, main)
    runtime_totals, vpu_whole = phase_panel_times(card, run)
    runtime_fp32 = phase_runtime_times(card, main, run, dispatcher_s)
    profiled = phase_runtime_profile(card, main)
    # slice 7: the inter-frame pipeline and the dataflow-graph runtime
    pipe = phase_pipeline(card, main, dispatcher_s, runtime_fp32)
    steal = phase_runtime_steal(card, main)
    graph = phase_graph(card, main)
    # slice 18: the runtime's fault paths on the card
    faults = phase_faults(card, main, run, decode, serving, runtime_fp32)
    qmm_dispatcher, qmm_runtime = phase_qmm_times(card, decode)
    phase_decode_times(card, main, decode, dispatcher_s, runtime_fp32)
    q_profiled = phase_runtime_profile(card, main, QPOOL, "decode",
                                       "int8 pool, decode")
    lm_totals = phase_lm_kernel_times(card, lm)
    lm_gemms = phase_lm_gemm_times(card, lm)
    lm_profiled = phase_lm_profile(card, lm)
    # slice 12: the launchers over a one-rank mesh, on the LM parameters
    mesh = phase_mesh(card, lm)
    # slice 14: the serving steps partitioned over two ranks on the card
    mesh_tp = phase_mesh_tp(card)
    # slice 10: the training path, last user of the LM phase's parameters
    training = phase_training(card, lm)
    mesh_train = phase_mesh_training(card)
    # slice 17: Adafactor slice by slice on an MoE at reduced depth
    ada = phase_adafactor(card)
    # slice 15: the train step partitioned over two ranks on the card
    mesh_tp_train = phase_mesh_tp_train(card)
    # slice 16: FSDP layer by layer, and the MoE decode on its own rows
    mesh_fsdp = phase_mesh_fsdp(card)
    # slice 13: the dry run, and its traces against the card's counts
    dry = phase_dryrun(card, lm, training, mesh_train)

    # phase 6: the kernels line, the card, the result
    on_runtime = (f"one CIFAR_Alex+ forward at {FRAMES} frames through the "
                  f"runtime: per-panel medians times the panels this kernel "
                  f"ran of each GEMM")
    whole = (f"one CIFAR_Alex+ forward at {FRAMES} frames: sum over its 5 "
             f"GEMMs, whole")
    sources = {"tiled_mm": ("src/repro_torch/kernels/tiled_mm/csrc/"
                            "tiled_mm.cu",
                            "src/repro/kernels/tiled_mm/tiled_mm.py:89",
                            main_err, totals),
               "vpu_mm": ("src/repro_torch/kernels/vpu_mm/csrc/vpu_mm.cu",
                          "src/repro/kernels/vpu_mm/vpu_mm.py:87",
                          vpu_err, None)}
    entries = []
    for name, (source, replaces, err, dispatcher) in sources.items():
        runtime = {"launches": run[name], **summary(runtime_totals[name]),
                   "per": on_runtime,
                   "profiled": {**profiled.get(name, {}), "per": (
                       "device time of another runtime forward under "
                       "torch.profiler")}}
        by_path = {"dispatcher": {"launches": main[3][name]},
                   "runtime": runtime,
                   "pipeline": {"launches": pipe[name], "per": (
                       f"CIFAR_Alex+ x{FRAMES} as {FRAMES // MICRO} "
                       f"micro-batches through the three-stage pipeline")},
                   "runtime_steal": {"launches": steal[name], "per": (
                       "the pooled runtime_steal run: 8 conv2 panels of "
                       "8,192 rows")},
                   "graph": {"launches": graph[name], "per": (
                       f"the conv front-end of CIFAR_Alex+ x{FRAMES} as "
                       f"{FRAMES // MICRO} wave graphs")},
                   "faults": faults_launches(faults, name),
                   "serving": serving_launches(serving, name),
                   "durability": durability_launches(durability, name),
                   "training": training_launches(training, name),
                   "mesh": mesh_launches(mesh, mesh_train, name),
                   "mesh_tp": mesh_tp_launches(mesh_tp, name),
                   "mesh_tp_train": mesh_tp_train_launches(mesh_tp_train,
                                                           name),
                   "mesh_fsdp": mesh_fsdp_launches(mesh_fsdp, name),
                   "dryrun": dryrun_calls(dry, name),
                   "adafactor": adafactor_launches(ada, name)}
        if name == "tiled_mm":
            lm_per = (f"one {LM_ARCH} {{}} of {LM_BATCH} requests: per-GEMM "
                      f"medians (CUDA events) times the calls; library: "
                      f"torch.matmul in bf16; bound at the bf16 peak")
            by_path["lm_prefill"] = {
                "launches": lm["prefill"]["launches"]["tiled_mm"],
                "launches_by_path":
                    lm["prefill"]["tiled_mm_launches_by_path"],
                **lm_gemms["lm_prefill"], "per": lm_per.format("prefill"),
                "profiled": {**lm_profiled.get("tiled_mm", {}),
                             "per": f"device time of one {LM_ARCH} prefill "
                                    f"under torch.profiler"}}
            by_path["lm_decode"] = {
                "launches_per_step":
                    lm["decode"]["launches_per_step"]["tiled_mm"],
                "launches_by_path_per_step":
                    lm["decode"]["tiled_mm_launches_by_path_per_step"],
                **lm_gemms["lm_decode"], "per": lm_per.format("decode step")}
        if dispatcher is not None:
            by_path["dispatcher"].update(summary(dispatcher), per=whole)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": run[name],
                 "max_abs_err": err, **summary(runtime_totals[name]),
                 "per": on_runtime, "by_path": by_path}
        entry["plain_note"] = PLAIN_F64_NOTE
        if name == "vpu_mm":
            entry["whole_gemms"] = {**summary(vpu_whole),
                                    "tiled_mm_ms": totals["ms"],
                                    "per": (whole + "; a comparison with "
                                            "tiled_mm's whole GEMMs")}
        entries.append(entry)
    q_on_runtime = (f"one CIFAR_Alex+ decode forward at {FRAMES} frames "
                    f"through the runtime: per-panel medians (raw int32) "
                    f"times the panels of each GEMM, every one on qmm")
    q_runtime = {"launches": decode["runtime"]["qmm"], **summary(qmm_runtime),
                 "per": q_on_runtime,
                 "profiled": {**q_profiled.get("qmm", {}), "per": (
                     "device time of another runtime decode forward under "
                     "torch.profiler")}}
    entries.append({
        "name": "qmm", "route": "cuda",
        "source": "src/repro_torch/kernels/qmm/csrc/qmm.cu",
        "replaces": "src/repro/kernels/qmm/qmm.py:123",
        "launches": decode["runtime"]["qmm"], "max_abs_err": qmm_err,
        **summary(qmm_runtime), "per": q_on_runtime,
        "by_path": {"dispatcher": {"launches": decode["dispatcher"]["qmm"],
                                   "launches_by_path":
                                       decode["dispatcher_paths"],
                                   **summary(qmm_dispatcher),
                                   "per": whole + ", fused epilogue"},
                    "runtime": {**q_runtime, "launches_by_path":
                                decode["runtime_paths"]},
                    "serving": serving_launches(serving, "qmm"),
                    "faults": faults_launches(faults, "qmm"),
                    "durability": durability_launches(durability, "qmm"),
                    "training": training_launches(training, "qmm"),
                    "mesh": mesh_launches(mesh, mesh_train, "qmm"),
                    "mesh_tp": mesh_tp_launches(mesh_tp, "qmm"),
                    "mesh_tp_train": mesh_tp_train_launches(mesh_tp_train,
                                                            "qmm"),
                    "mesh_fsdp": mesh_fsdp_launches(mesh_fsdp, "qmm"),
                    "dryrun": dryrun_calls(dry, "qmm"),
                    "adafactor": adafactor_launches(ada, "qmm")}})
    lm_per = (f"one {LM_ARCH} prefill of {LM_BATCH} x {LM_PROMPT} tokens: "
              f"the per-call median (CUDA events) times the calls it makes")
    for name, source, replaces, err in (
            ("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:96",
             flash_err),
            ("ssd", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
             "src/repro/kernels/ssd/ssd.py:88", ssd_err)):
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": lm["prefill"]["launches"][name],
            "max_abs_err": err, **lm_totals[name], "per": lm_per,
            "by_path": {
                "lm_prefill": {"launches": lm["prefill"]["launches"][name],
                               "profiled": {**lm_profiled.get(name, {}),
                                            "per": "device time of another "
                                                   "prefill under "
                                                   "torch.profiler"}},
                "lm_decode": {"launches_per_step":
                              lm["decode"]["launches_per_step"][name]},
                "serving": serving_launches(serving, name),
                "durability": durability_launches(durability, name),
                "mesh": mesh_launches(mesh, mesh_train, name),
                "mesh_tp": mesh_tp_launches(mesh_tp, name),
                "mesh_tp_train": mesh_tp_train_launches(mesh_tp_train,
                                                        name),
                "mesh_fsdp": mesh_fsdp_launches(mesh_fsdp, name),
                "dryrun": dryrun_calls(dry, name),
                "adafactor": adafactor_launches(ada, name),
                "training": {**training_launches(training, name),
                             "profiled": {
                                 **training["kernel_device_ms_per_step"].get(
                                     name, {}),
                                 "per": "device time of the forward "
                                        "launches of one profiled train "
                                        "step"},
                             "backward": {
                                 "is": "the plain formulation's VJP "
                                       "(attention_ref / ssd_chunked, the "
                                       "latter in float64), "
                                       "recomputed from the saved inputs",
                                 **backward[name],
                                 "device_ms_per_step": training[
                                     "backward_device_ms_per_step"].get(
                                     name)}}}})
    entries[-1]["widths"] = {
        "rows": ssd_widths,
        "per": "one call at a rank's share of P (SSD_WIDTH_SHAPES, fp32): "
               "CUDA-event median of REPS; bound by ssd_bound"}
    emit({"kernels": entries})
    print(f"card: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
