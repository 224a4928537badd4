#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # needs one CUDA GPU and nvcc

Phases, each of which ends the script with a non-zero exit if it fails:

1. print the card's name and power limit; build the kernels of
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all together);
2. main path: ``LuminSys(backend='kernel')`` renders 12 frames (two S^2
   sharing windows) of a 1,000,000-Gaussian ``structured_scene`` at
   1920x1080 under the ``lumina_3dgs`` config, with every kernel's launch
   count set to 0 just before and read just after;
3. reference: the same 12 frames through ``backend='reference'`` (plain
   rasterizer and cache): per-frame hit counts and cache state must be
   identical and images within 128 ulps x magnitude; PSNR of Lumina, S^2
   alone and RC alone against ``render_frame_baseline`` (exact 3DGS), each
   with its SSIM;
4. paper (``paper_phase``), on the main path's scene and config: (a) frame
   0's features through the dense differentiable walk
   (``rasterize_tiles(..., early_exit=False)``, grad on) equal the chunked
   walk's bit for bit on the colors and every aux field; the chunked walk,
   the dense forward and the dense forward + backward timed (CUDA events)
   with the backward's peak memory; (b) ``finetune`` of the same seed's
   scene with a quarter of its Gaussians oversized, against targets
   rendered from the main path's scene over 6 cameras at 30 FPS, for 12
   steps of Eqn. 4's loss (alpha 8, theta 0.03): per step the loss terms,
   PSNR, time and peak memory; every gradient leaf finite, ``l_scale``
   falling and each camera's loss lower on its second visit; (c) RC-only
   frames (``use_s2=False``) of the scene before and after on the kernel
   backend (launch counts set to 0 just before, read just after) and the
   reference backend, held as in 3, with PSNR, SSIM and the hit rate of
   frames 1-5; (d) the hardware model (``core.hwmodel``) fed with the main
   path's 12 frames (baseline aux, the main path's hit rates, one sort a
   window): the variant table as measured and rescaled to the paper's
   stage mix, MODELED for the paper's hardware and not times of this card,
   finite with ``GPU`` at 1.0, and the orderings
   ``tests/test_integration.py::test_hwmodel_orderings`` asserts, printed;
5. where the time goes: CUDA-event times of each stage of a shade frame and
   of a sort frame, replayed from the main path's saved states;
6. kernels: the inputs of each kernel are captured from one more real frame
   of the main path, and each kernel is held against its plain version on
   them (integer outputs exactly, floats within 128 ulps x magnitude) and
   timed with CUDA events beside it; ``rasterize`` also in full mode and in
   resume mode (start at phase A's ``iter_at_k``, live where phase B works),
   with the pixel-Gaussian pairs of its walk counted three ways (in walked
   chunks and examined, from the kernel's outputs, and left after the band
   cull as its plain mirror ``tile_cull_plain`` predicts);
   ``rasterize_compact`` in both addressing modes (home lanes, as phase B
   calls it, and the explicit lanes of the JAX package's contract), with
   counters of what its lanes ask of it (``compact_counters``), and the
   CUDA route of ``ops.rasterize_resume_compacted`` against its plain route;
   ``rc_lookup`` in its fused mode (the whole probe, as the path calls it)
   against ``rc.lookup_all_groups_multi`` and in its lookup-only mode (the
   TPU kernel's function) against ``rc_lookup_plain``, its kernel alone and
   its wrapper timed in three rounds, with the counters of its LRU touch
   (``probe_times``, ``probe_counters``); then
   three stress phases on seeded synthetic data, held exactly against the
   plain versions: ``rasterize`` (all three modes, and resume with some
   transmittances NaN) and ``rasterize_slots`` on tiles whose Gaussians sit
   on tile borders and on the edge of the cull's ellipse, with extreme
   conics (near-singular, non-finite) and opacities; ``rasterize_compact``
   in both modes on full-width lists, with lanes that start at their cap,
   NaN and floor transmittances, dead lanes and n_live 0, 1, 256, 257;
   ``rc_lookup`` in both modes on cold, full and duplicate-way caches, hot
   slots, both index modes, odd batch shapes and dead viewers;
7. serve: the multi-viewer serving tick (``SessionManager`` + ``SyncDriver``
   + ``BatchedStepper``) serves 4 viewers of 12 frames each, arriving 2
   ticks apart, in 4 slots at the same size, once with one viewer per scene
   (4 scenes whose orbits start 90 deg apart) and once with all 4 viewers
   on one scene and one orbit.  Each run goes through the kernel backend
   with the launch counts set to 0 just before and read just after, then
   through the reference backend: sorted flags, hit counts, the sort log
   and the cache tags/age/clock must be identical on every tick and images
   within 128 ulps x magnitude.  In the first run, slot 0 is also held
   against ``LuminSys(backend='kernel')`` on its 12 cameras.  The inputs of
   the serving tick's three kernels (``rasterize_slots``,
   ``rasterize_compact`` over the miss lanes of all slots, ``rc_lookup``
   over the scene's groups) are captured from a tick of the second run with
   all 4 lanes live, and each kernel is held against its plain version
   there and timed, as is the CUDA route of
   ``ops.rasterize_resume_compacted_slots`` against its plain route;
8. serving state (``serve_state_phase``), at the same size on one scene of
   4 slots: (a) 8 pace-2 viewers oversubscribe the 4 slots
   (``oversubscribe=True``), on the kernel backend (launch counts set to 0
   just before, read just after) and on the reference backend, with lane
   swaps, sorted flags, hits, the sort log and the cache identical on every
   tick, images within 128 ulps, and every viewer finished within 2 x
   frames + 4 ticks; (b) the kernel run again, checkpointed every 4 ticks
   through ``CheckpointManager`` under ``build/`` and killed at tick 9, is
   restored into the reset stepper and must continue exactly as the
   uninterrupted run (images ``torch.equal``, hits, flags, sort log, final
   cache); (c) the shared 4-viewer run under one fault of each host kind
   the sync driver reaches, on both backends: both drain with identical
   decisions, the fault counters equal the fired events, the poisoned slot
   is quarantined and the cache stays finite; then a NaN camera shades one
   slot of a private stepper on both backends: both caches stay finite and
   differ only where the kernel path inserts its black NaN-frame misses,
   which the reference's NaN colors keep out (``nan_camera_check``);
9. real time (``realtime_phase``), at the same size on one scene of 4
   slots, every run on the kernel backend with the launch counts set to 0
   just before and read just after: (a) the shared run of phase 7 under
   ``SyncDriver`` and then ``ThreadedDriver``, both traced, each equal to
   phase 7's sync run bit for bit on every tick (images, hits, sorted
   flags, sort log, cache); it prints both tick medians and loop walls,
   each tick's ``host_ms`` and ``overlap_ms``, the ``host_overlap`` share,
   the ticks where a worker ``plan_tick`` span overlaps a device ``shade``
   span, the time from ``step_dispatch`` returning to ``step_finish``
   returning, and the host syncs inside the tick-11 ``step_dispatch``
   (``torch.cuda.set_sync_debug_mode('warn')``, by source line), and writes
   the trace to ``build/realtime_trace.json``, checked by
   ``validate_chrome_trace``; (b) phase 8's faults run plus a planner-worker
   death and a worker ``plan_exc`` under the threaded driver with the plan
   wait bounded at 2 s: it drains with every frame rendered, the counters
   equal the fired events, no planner thread leaks, and every tick equals
   phase 8's sync faults run; (c) ``partition_scene`` of the scene (cells
   of 0.4, chunks of 64) streamed, FULL within 3 cells and LOD within 5,
   through an unbounded arena under ``SyncDriver`` and through an arena
   sized to the prefetch ring of the run's cameras under
   ``ThreadedDriver``: every tick bit-identical, no stall after the first
   tick, prefetch hits, fewer resident bytes than the scene's;
10. fleet (``fleet_phase``), at the same size: 6 viewers of 12 frames
   (arrivals 0, 0, 1, 2, 3, 5; sid 3 at pace 2; each on its own orbit and
   scene block) on 2 ``FleetManager`` workers of 4 slots that share the
   one card, every kernel-backend sync run with each worker's launches
   counted (``LAUNCHES`` across each sync-driver leg): (a) the sync fleet
   and a reference-backend sync fleet in lockstep, with slots, sort logs
   and caches equal after every tick and every frame's hits and sorted
   flag equal (images within 128 ulps), then the ``ThreadedFleetDriver``
   fleet against the sync fleet (integers, final caches and launch counts
   equal; whether its images are bit-identical is printed), with the
   fleet and worker tick medians, both loop walls and each worker's
   ``StragglerDetector`` EWMA; (b) sid 5 moved cold at tick 8 and sid 3
   aligned at tick 13, against the never-moved run: the aligned and the
   unmoved viewers equal it on every integer, the cold one renders every
   frame once; (c) checkpoints every 4 ticks under ``build/fleet_ckpt``
   (deleted after): ``restore_at_launch`` of the tick-4 snapshots in a
   fresh fleet continues as the never-moved run, then worker 0 is lost at
   tick 6 and the fleet rolls back: the survivors' and the aligned
   victim's renders equal the never-moved run on every integer, the
   spilled viewers re-queue at their snapshot cursors, every viewer
   drains and the loss counters match ``plan_shrink`` on the snapshots;
   it prints the time to recover with the restores split out and the
   checkpoint bytes of each worker;
11. LM serve (``lm_serve_phase``, once for each of ``LM_ARCHS``): the
   continuous-batching token server (``repro_torch.launch.serve``) with
   smollm-360m (dense), granite-moe-1b-a400m (moe), whisper-base
   (encdec), xlstm-1.3b (ssm) and zamba2-1.2b (hybrid), each at its
   published widths and depth in bfloat16, with random weights from a
   generator seeded 0 on the card; its parameter count and decode-state
   bytes must equal the JAX package's for the config: (a)
   ``Server(slots=4, max_seq=256, full=True)`` drains the JAX package's
   ``run()`` requests (8, prompts of 8, 16 new tokens each) through
   ``drain``, twice: all complete with 128 tokens and the second run's
   tokens equal the first's; ticks, tokens, tokens/s, wall time and the
   second run's peak memory above what it started with printed; (b) 12
   tokens decoded one at a time match the registry's prefill (forward +
   logits; whisper: ``decode_step`` over ``prepare_cross`` of seeded frames
   against ``decode_train``) within 8 bfloat16 ulps of the largest logit;
   (c) float32 copies of the weights (granite cut to 2 layers, xlstm to 8,
   zamba2 to 6) on the card and on the CPU: ``prefill`` of 8 tokens then
   4 ``decode_step``s, logits within 5e-3 of the largest and argmax equal;
   (d) the decode step at 4 slots x 256 positions: its median over 20
   steps by CUDA events beside its bound (the weights it reads, every
   expert's for MoE, plus the whole decode state, over 3.35 TB/s), the
   host's clock around it with and without a sync, and its kernel time
   and launches from ``torch.profiler``.  Then ``lm_maverick_phase``:
   llama4-maverick at published widths and 2 layers (18,553,267,200
   parameters drawn in bfloat16 on the card): prefill of 8 tokens x 4
   rows and 4 more decode steps, decode against forward within (b)'s
   bound, peak memory.  No hand-written kernel lies on these paths;
12. LM train (``lm_train_phase``, once for each of ``LM_ARCHS``): each
   config at its published widths and depth, bfloat16 weights with its
   config's remat and float32 Adam moments: (a)
   ``repro_torch.launch.train.train(full=True)`` for 3 steps of 8 x 256
   tokens (the JAX trainer's batch) with 1 of warmup: every loss and grad
   norm finite; the loss history, wall time and peak memory above what was
   held printed (a config that does not fit halves its batch and says
   so); (b) 3 steps of ``registry.make_train_step`` at lr 1e-4 on one
   fixed batch from a fresh draw of the weights: the last loss below the
   first; (c) float32 copies of the
   weights (depth cut as in 11 (c)) on the card and on the CPU, one
   ``make_train_step`` each on the same 1 x 64 tokens: losses within 1e-5
   relative, grad norms within 1e-3 and every gradient leaf within 3e-2
   in relative L2 norm, as run; where the model runs ``flash_attention``,
   once more with its bfloat16 roundings taken out on both devices; every
   gradient leaf of that second pair (xlstm: of the first) within 5e-3 of
   the leaf's largest gradient; (d) smollm-360m only: one step with remat
   and one without on the same weights and batch: equal losses, both
   peaks and times and the gradient gap printed; (e) the step's median
   over 3 steps by CUDA events beside its bounds (``flops.model_flops``
   over 989 TFLOP/s; 22 B a parameter of Adam traffic plus the weights
   read twice, over 3.35 TB/s), tokens/s, the host's clock, and the
   kernel time, launches and device-busy share of one step from
   ``torch.profiler`` tracing the device alone.  Then (f), the sLSTM
   walk in chunks (``slstm_chunk_check``): one sLSTM block of xlstm-1.3b
   at its published widths, bfloat16, on 16 x 1,024 tokens (four
   256-step chunks), forward and backward: the forward with grad on
   equal to a no-grad forward bit for bit, the bytes that autograd saves
   during the walk's forward (less its inputs') under one chunk's
   float32 intermediates (its first chunk walked without a checkpoint)
   plus the carries and the walk's float32 copy of the recurrent
   weights, every gradient finite.  No hand-written kernel lies
   on this path;
13. mesh (``mesh_phase``): a one-rank NCCL process group and a (data 1,
    model 1) ``DeviceMesh`` on the card: (a) granite-moe-1b-a400m at its
    published widths cut to 2 layers, bfloat16, one train step of 8 x 256
    tokens with the mesh (the expert-parallel MoE body, its all_to_all
    and gathers one-rank NCCL calls) and one without, from the same draw:
    each MoE layer's drop fraction equal exactly, the loss within 1e-5
    relative and the grad norm within 1e-3, then 3 timed steps of each
    and one profiled; (b) ``psum_compressed`` of (a)'s gradients over
    ``data``: each leaf equal to ``decompress(compress(g))``; (d) (a)'s
    train state placed with ``reshard_tree`` on a mesh rebuilt from
    ``plan_remesh(1, 0, model=1)``: every value back bit for bit; (c) the
    ``render_1080p`` dry-run cell's frame (1,048,576 Gaussians of
    ``structured_scene`` at 1920x1088, capacity 512, sorted) through
    ``render_dist._serve_frame`` on the mesh equal to the mesh-free frame
    bit for bit (colors and n_significant), each timed 3 times in turns
    with the plain walk's share; (e) GPipe needs two ranks: a line says
    so.  No hand-written kernel lies on this path;
14. analysis (``analysis_phase``): the op counter (``analysis.op_count``)
    and the roofline (``analysis.roofline``): (a) smollm-360m at its
    published widths and depth, bfloat16, seeded 0: one
    ``make_train_step`` call of 8 x 256 tokens counted on the card and
    again on ``meta`` from ``abstract_params``, FLOPs, matmul FLOPs, bytes
    and ops equal exactly; the count's FLOPs beside ``flops.model_flops``,
    the step's median of 3 by CUDA events (outside the counter) beside
    ``roofline.step_time``, the counter's peak on ``meta`` beside the
    card's peak memory above the start; (b) the ``render_720p`` dry-run
    cell's frame (1,048,576 Gaussians of ``structured_scene`` at 1280x720,
    capacity 512, sorted) on the card, counted, with its walk's chunks
    beside the ``meta`` walk's worst case (which must bound its count),
    and timed beside the roofline; (c) ``python -m
    repro_torch.launch.dryrun`` of smollm-360m at ``train_4k``, yi-34b
    at ``decode_32k`` and ``render_1080p`` on the single mesh of 256
    fake ranks, each in a subprocess that must exit 0, with its roofline
    row and count time; (d) a bfloat16 matmul of 8192 cubed and a 4 GiB
    device copy, the TFLOP/s and TB/s they reach beside the roofline's
    datasheet peaks.  (c)'s two LM cells count the partitioned program:
    each row must say so, read a ``useful_ratio`` of at least 0.25 and
    count collectives.
    (c)'s subprocesses start before ``mesh_phase`` and run beside it and
    the tp phase.  No hand-written kernel lies on these paths;
15. tp (``tp_phase``, between the mesh and analysis phases): a one-rank
    NCCL process group and a (data 1, model 1) mesh; at their published
    widths, bfloat16, seeded 0: smollm-360m, granite-moe-1b-a400m,
    zamba2-1.2b and whisper-base at their published depths, yi-34b cut to
    2 layers and xlstm-1.3b to 16 (two super-blocks, each with its sLSTM
    block): the
    train step of 8 x 256 tokens through the DTensor layout of
    ``registry.shard_step_inputs`` and plainly, from the same draw: the
    loss within 1e-6 and the grad norm within 1e-5 relative (bit for bit
    is printed), the layout hooks called on DTensors, every parameter a
    DTensor; each way the step's median of 3 by CUDA events and the
    host clock of the same calls, kernel time and launches from
    ``torch.profiler`` and the peak memory.  Then each decodes 8 rows (caches of 4,096
    positions, 32,768 for yi-34b; xlstm has no cache, only its recurrent
    state; whisper's cross pair is ``prepare_cross`` of 4,096 seeded
    frames, through the layout bit for bit with the plain one) 16 steps
    from position 0 through the DTensor layout of
    ``registry.shard_decode_inputs`` and plainly, from one draw and the
    same seeded tokens: logits and every state leaf bit for bit, the
    hooks called on DTensors, every state leaf a DTensor; each way the
    step at position 16 timed as the train step is.  Last, zamba2-1.2b's
    ``long_500k`` decode: one row, caches of 524,288 positions filled
    with seeded values and laid out by ``shard_decode_inputs(
    long_context=True)`` (25.8 GB each way), 4 steps at the cache's last
    positions checked as above, the step at the last position timed and
    printed beside its bound, the caches' bytes over the card's copy
    rate.  No hand-written kernel lies on this path;
16. print the total wall time, the ``{"kernels": [...]}`` line, then the
    last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time
import types
import warnings

HERE = pathlib.Path(__file__).resolve().parent
ULPS = 128
# float operations per examined pixel-Gaussian pair (dx, dy, quadratic form,
# power, exp counted as one, opacity product, clamp) and per contribution
# (weight, three color multiply-adds, transmittance update)
OPS_EXAMINED, OPS_CONTRIB = 14, 9
FEATURE_BYTES = 40      # mean2d 8 + conic 12 + color 12 + opacity 4 + id 4
# Lumina's images against exact 3DGS on this scene sit near 21 dB (S^2 and
# RC together); an image of wrong content scores under 10 dB
PSNR_FLOOR_DB = 15.0
# the main path's shapes: the lumina_3dgs workload at full width and depth
GAUSSIANS, WIDTH, HEIGHT, FRAMES, SEED = 1_000_000, 1920, 1080, 12, 0
# the serving phase: 4 viewers of FRAMES frames arriving 2 ticks apart in 4
# slots; ticks 0 and 10 are profiled stage by stage (tick 10 has all 4
# lanes live and no sort), and the serving kernels' inputs are captured at
# tick 11 (all 4 lanes live, no sort, not profiled)
VIEWERS, STAGGER, PROFILE_EVERY, CAPTURE_TICK = 4, 2, 10, 11
# the serving-state phase: STATE_VIEWERS pace-2 viewers of STATE_FRAMES
# frames oversubscribe the VIEWERS slots of one scene; the checkpointed run
# saves every CKPT_EVERY ticks and is killed at KILL_TICK; the fault trace
# holds one event of each kind the sync driver reaches, at distinct ticks
STATE_VIEWERS, STATE_FRAMES, CKPT_EVERY, KILL_TICK = 8, FRAMES, 4, 9
FAULT_EVENTS = (('plan_exc', 2, {}),
                ('dispatch_transient', 3, {'count': 1}),
                ('dispatch_persistent', 5, {}),
                ('stall', 7, {'delay_s': 0.05}),
                ('nan_poison', 9, {'slot': 1}))
# the real-time phase: the shared run under the threaded driver; under the
# faults run's events plus a planner-worker death and a worker plan_exc,
# with the plan wait bounded at REALTIME_WATCHDOG_S; and streamed through a
# device arena of the scene's pose-cell chunks (the JAX CLI's cells and
# chunks; FULL within 3 cells of a camera and LOD within 5, as the JAX
# package's streaming tests and benchmark hold them: at the orbit's radius
# the CLI's 2 and 4 leave no chunk at FULL).  The streamed orbit starts at
# 24 deg, where the cameras cross into a nearer grid cell at frame 3: an
# orbit from 0 deg stays in one cell for all FRAMES frames, and its
# residency would never change after the first tick.
REALTIME_FAULTS = FAULT_EVENTS + (('worker_death', 4, {}),
                                  ('plan_exc', 11, {}))
REALTIME_WATCHDOG_S = 2.0
STREAM_CELL, STREAM_CHUNK, STREAM_NEAR, STREAM_LOD = 0.4, 64, 3, 5
STREAM_START_DEG = 24.0
# the fleet phase: FLEET_VIEWERS viewers of FRAMES frames, each on its own
# orbit and scene block, arriving at FLEET_ARRIVALS with FLEET_PACES (one
# pace-2 viewer), on FLEET_WORKERS workers of FLEET_SLOTS slots that all
# share the one card.  The migration run moves sid 5 at tick 8 to worker 0,
# whose slot 2 is taken (a cold move), and sid 3 at tick 13 to worker 0,
# whose slot 1 has just been freed (an aligned move); the loss run
# checkpoints every FLEET_CKPT_EVERY ticks and loses worker 0 at
# FLEET_LOSS_TICK, so it rolls back to tick 4 with one victim aligned onto
# the survivor and two spilled.
FLEET_WORKERS, FLEET_SLOTS, FLEET_VIEWERS = 2, 4, 6
FLEET_ARRIVALS = (0, 0, 1, 2, 3, 5)
FLEET_PACES = (1, 1, 1, 2, 1, 1)
FLEET_COLD_MOVE, FLEET_ALIGNED_MOVE = (8, 5, 0), (13, 3, 0)
FLEET_CKPT_EVERY, FLEET_LOSS_TICK = 4, 6
# the paper phase: PAPER_STEPS fine-tuning steps (Eqn. 4's loss, alpha and
# theta of the JAX package's example) of the seed's scene with a
# PAPER_LARGE_FRAC share of oversized Gaussians against targets rendered
# from the main path's scene, over PAPER_FRAMES cameras at 30 FPS (the
# example's trajectory: the camera moves 5 deg a frame), each visited twice
PAPER_FRAMES, PAPER_FPS, PAPER_STEPS, PAPER_LARGE_FRAC = 6, 30.0, 12, 0.25
PAPER_ALPHA, PAPER_THETA = 8.0, 0.03
# the LM serve phases: each arch of LM_ARCHS at its published widths and
# depth (LM_FULL) serving the JAX package's run() defaults (8 requests,
# prompts of 8, 16 new tokens each) in 4 slots of 256 positions; (b)
# decodes LM_CHECK_TOKENS tokens against forward; (c) prefills
# LM_CPU_PROMPT tokens and decodes LM_CPU_STEPS more on the card and on the
# CPU; (d) times the decode step over LM_TIMED_STEPS steps.  Per arch: its
# parameters in this layout (untied embed and unembed) and its decode-state
# bytes at 4 x 256 (whisper's with the zero cross pair), both as the JAX
# package's registry.abstract_params and abstract_decode_state give them,
# and the depth of (c)'s float32 copies (None: the served model; xlstm's 8
# is one super-block, with its sLSTM block; zamba2's 6 holds one
# shared-attention point).  Whisper's (b) and (c) decode over
# prepare_cross of LM_FRAMES seeded frames.
LM_ARCHS = (('smollm-360m', 409_007_040, 41_943_040, None),
            ('granite-moe-1b-a400m', 1_384_963_072, 50_331_648, 2),
            ('whisper-base', 97_428_480, 25_165_824, None),
            ('xlstm-1.3b', 3_730_780_160, 2_822_111_232, 8),
            ('zamba2-1.2b', 1_170_160_128, 213_567_488, 6))
LM_FULL = True
LM_SLOTS, LM_MAX_SEQ, LM_REQUESTS, LM_PROMPT, LM_MAX_NEW = 4, 256, 8, 8, 16
LM_CHECK_TOKENS, LM_CPU_PROMPT, LM_CPU_STEPS, LM_TIMED_STEPS = 12, 8, 4, 20
LM_FRAMES = 16
# maverick at its published widths and LM_MAVERICK_DEPTH layers (one dense
# + MoE super-block): LM_MAVERICK_PARAMS parameters, 37.1 GB in bfloat16;
# prefill of LM_CPU_PROMPT tokens x LM_SLOTS rows, then LM_CPU_STEPS more
# decode steps, each held against forward within (b)'s bound
LM_MAVERICK, LM_MAVERICK_DEPTH = 'llama4-maverick-400b-a17b', 2
LM_MAVERICK_PARAMS = 18_553_267_200
# (b): bfloat16 weights and activations; forward's flash attention rounds
# Q, K, P and V to bfloat16 where decode keeps float32 scores.  Measured on
# an H100 for smollm-360m: 0.0508 on logits up to 2.77, 3.25 bfloat16 ulps
# of the largest.  Bound: 8 ulps of the largest logit (0.125 at 2-4).
LM_DECODE_ULPS = 8
# (b) for the archs of LM_DECODE_F32: xlstm-1.3b's decode and forward part
# at the first blocks by a rounding, and the gap grows ~1.3x a block
# through all 48, in float32 as in bfloat16: each block rmsnorm-s its
# input, so an input's relative rounding error reaches a branch of rms
# 0.07, 3.4x the embedding's 0.02.  On an H100 the last block's gap is
# 1.574 on 1.69 in bfloat16, 0.0396 on 1.57 in float32 (from 0 and 3.1e-7
# at block 0; tools/lm_block_gap.py, chip call 2, PR 22), and the logits'
# bfloat16 gap 3.59 on 4.0, argmax unequal.  There (b) holds decode against
# forward on float32 copies of the weights (TF32 off) within the same 8
# ulps and prints the bfloat16 gap beside it, ungated.
LM_DECODE_F32 = ('xlstm-1.3b',)
# (c): float32 weights on both devices (TF32 off); the two differ by the
# order of float32 sums and the bfloat16 roundings in flash attention that
# such differences flip (measured on an H100 for smollm-360m: up to
# 1.12e-3, at the prefill).  Bound on max |card - cpu| / max |cpu| of the
# logits.
LM_CPU_REL = 5e-3
# the parameters that a decode step does not read: the embedding table
# (a gather of LM_SLOTS rows) and whisper's encoder
LM_NOT_DECODED = ('tok.embed', 'enc.', 'frontend_proj', 'enc_norm')
# the LM train phase, for each arch of LM_ARCHS at its published widths and
# depth (LM_FULL): (a) TRAIN_STEPS steps of launch.train.train at the JAX
# trainer's TRAIN_BATCH x TRAIN_SEQ with TRAIN_WARMUP steps of warmup; (b)
# TRAIN_FIT_STEPS steps at lr TRAIN_FIT_LR on one fixed batch; (c) one step
# on TRAIN_CPU_BATCH x TRAIN_CPU_SEQ tokens of float32 copies (the depth of
# LM_ARCHS' (c)) on the card and on the CPU, the loss within TRAIN_LOSS_REL
# and the grad norm within TRAIN_NORM_REL relative, each gradient leaf
# within TRAIN_LEAF_L2 in relative L2 norm as run and within LM_CPU_REL of
# its largest with flash's roundings taken out (lm_train_card_vs_cpu says
# why); (d) remat on and off for
# TRAIN_REMAT_ARCHS; (e) TRAIN_TIMED_STEPS steps timed.
# TRAIN_FIT_LR: tests/test_models.py's 3e-3 suits the reduced configs; at
# full width Adam's first sign-sized steps of lr 1e-3 (40 % of the 0.0025
# scale of smollm's wo and w_down) raised the loss on the fixed batch before
# it fell (smollm: 10.985, 11.001, 11.263 from (a)'s weights, on an H100 80GB
# HBM3 at 700 W).  (b) starts from a fresh draw, as tests/test_models.py
# does: from (a)'s weights, where xlstm's gradient norm is ~1e5, its loss
# rose even at 1e-4 (11.214, 11.221, 11.236, the same card).  The byte bound
# counts ADAM_BYTES a parameter (bfloat16 weight and gradient read, weight
# written; float32 moments read and written) plus the weights read twice
# (forward and backward).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 8, 256, 3, 1
TRAIN_FIT_STEPS, TRAIN_FIT_LR = 3, 1e-4
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 1, 64
TRAIN_LOSS_REL, TRAIN_NORM_REL = 1e-5, 1e-3
TRAIN_LEAF_L2 = 3e-2
TRAIN_REMAT_ARCHS = ('smollm-360m',)
TRAIN_TIMED_STEPS = 3
ADAM_BYTES = 22
# the LM train phase's (f): one sLSTM block of SLSTM_ARCH at its published
# widths on SLSTM_ROWS x SLSTM_SEQ tokens (SLSTM_SEQ / 256 chunks)
SLSTM_ARCH, SLSTM_ROWS, SLSTM_SEQ = 'xlstm-1.3b', 16, 1024
# the mesh phase on a one-rank (data 1, model 1) mesh of this card: (a)
# MESH_ARCH at its published widths and MESH_DEPTH layers (lm_train_phase
# (c)'s depth) trains one step of TRAIN_BATCH x TRAIN_SEQ with the mesh
# (the expert-parallel MoE body, its all_to_all a one-rank NCCL call) and
# one without, from the same draw, then MESH_TIMED_STEPS more each, timed;
# (c) the render dry-run cell MESH_FRAME's frame, sharded and mesh-free,
# MESH_FRAME_REPS timings each (MESH_FRAME_SIZE, where set, overrides its
# (Gaussians, width, height, capacity) for a CPU rehearsal)
MESH_ARCH, MESH_DEPTH, MESH_TIMED_STEPS = 'granite-moe-1b-a400m', 2, 3
MESH_FRAME, MESH_FRAME_REPS, MESH_FRAME_SIZE = 'render_1080p', 3, None
# the analysis phase: (a) ANALYSIS_ARCH at its published widths and depth
# trains one step of TRAIN_BATCH x TRAIN_SEQ under the op counter on the
# card and once on ``meta``, then ANALYSIS_TIMED_STEPS timed steps; (b) the
# ANALYSIS_FRAME dry-run cell's frame (ANALYSIS_FRAME_SIZE, where set,
# overrides its (Gaussians, width, height, capacity) for a CPU rehearsal),
# counted and timed ANALYSIS_TIMED_STEPS times; (c) the ANALYSIS_DRYRUNS
# cells of ``launch.dryrun`` on the single mesh, each in a subprocess (a
# fake group of 256 ranks cannot share this process with mesh_phase's NCCL
# group) within ANALYSIS_DRYRUN_TIMEOUT_S; (d) a bfloat16 matmul of
# ANALYSIS_MATMUL_N cubed and a device-to-device copy of
# ANALYSIS_COPY_BYTES, ANALYSIS_PEAK_REPS times each
ANALYSIS_ARCH, ANALYSIS_TIMED_STEPS = 'smollm-360m', 3
ANALYSIS_FRAME, ANALYSIS_FRAME_SIZE = 'render_720p', None
ANALYSIS_DRYRUNS = (('smollm-360m', 'train_4k'), ('yi-34b', 'decode_32k'),
                    ('lumina-3dgs', 'render_1080p'))
ANALYSIS_DRYRUN_TIMEOUT_S = 300
ANALYSIS_MATMUL_N, ANALYSIS_COPY_BYTES, ANALYSIS_PEAK_REPS = 8192, 4 << 30, 10
# the partitioned LM dry runs of ANALYSIS_DRYRUNS must read at least this
# useful share (the replicated program read 1 / 256)
ANALYSIS_MIN_USEFUL = 0.25
# the tp phase on a one-rank (data 1, model 1) mesh of this card: each of
# TP_ARCHS (arch, layers or None for the published depth) at its published
# widths, bfloat16, steps TRAIN_BATCH x TRAIN_SEQ through the DTensor layout
# of registry.shard_step_inputs and plainly, from the same draw (seed 0):
# the first step's loss within TP_LOSS_REL and grad norm within TP_NORM_REL
# relative, then TP_TIMED_STEPS more each, timed.  An moe arch's DTensor
# step takes the expert-parallel body (a one-rank all_to_all) in every MoE
# layer, where the plain step takes the local path.  xlstm is cut to 16 of
# its 48 layers (two super-blocks): its plain step took 3.5-4.0 s at 48
# and DTensor's dispatch adds 2-3x
TP_ARCHS = (('smollm-360m', None), ('yi-34b', 2),
            ('granite-moe-1b-a400m', None), ('xlstm-1.3b', 16),
            ('zamba2-1.2b', None), ('whisper-base', None))
TP_LOSS_REL, TP_NORM_REL, TP_TIMED_STEPS = 1e-6, 1e-5, 3
# the tp phase's decode part: each of TP_ARCHS decodes TP_DECODE_ROWS rows
# against caches of TP_DECODE_SEQ[arch] positions (TP_DECODE_CPU_SEQ in a
# CPU rehearsal; xlstm's recurrent state has no length), TP_DECODE_STEPS
# steps from position 0 through the DTensor layout of
# registry.shard_decode_inputs and plainly, from one draw (seed 0) and the
# same seeded tokens: logits and every state leaf bit for bit, then
# TP_TIMED_STEPS more each at the next position, timed.  whisper's cross
# pair is prepare_cross of TP_DECODE_SEQ seeded frames a row
TP_DECODE_SEQ = {'smollm-360m': 4096, 'yi-34b': 32768,
                 'granite-moe-1b-a400m': 4096, 'xlstm-1.3b': 4096,
                 'zamba2-1.2b': 4096, 'whisper-base': 4096}
TP_DECODE_CPU_SEQ, TP_DECODE_ROWS, TP_DECODE_STEPS = 32, 8, 16
# the long-context decode of the tp phase: TP_LONG's arch at the
# long_500k shape (one row, caches of its 524,288 positions, or
# TP_DECODE_CPU_SEQ in a CPU rehearsal) laid out by
# shard_decode_inputs(long_context=True), its caches filled with seeded
# values; TP_LONG_STEPS steps at the cache's last positions checked as
# above, then the step at the last position timed against the caches'
# bytes over TP_COPY_TBPS, the device-to-device copy rate that
# analysis_phase (d) measured on an H100 80GB HBM3 at 700 W (3.035 TB/s)
TP_LONG, TP_LONG_STEPS, TP_COPY_TBPS = 'zamba2-1.2b', 4, 3.035
DEVICE = 'cuda'


def peaks():
    """The card's datasheet peaks, ``analysis/roofline.py`` of the package
    that ``load_package`` put on the path."""
    import repro_torch.analysis.roofline as roofline
    return roofline


def serve_kernels(pkg) -> list:
    """The serving tick's kernel wrappers, as ``patched`` targets."""
    return [(pkg.rk, 'rasterize_slots', 'rasterize_slots'),
            (pkg.rk, 'rasterize_compact_home', 'rasterize_compact'),
            (pkg.ops, '_rc_probe_kernel', 'rc_lookup')]


def fail(msg: str) -> None:
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def ulp_close(got, want, ulps: int = ULPS) -> bool:
    import torch
    scale = torch.clamp(torch.maximum(got.abs(), want.abs()), min=1.0)
    eps = torch.finfo(torch.float32).eps
    return bool(((got - want).abs() <= ulps * eps * scale).all())


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def patched(targets, wrap):
    """Replace each ``(owner, attr, label)`` function by ``wrap(label, fn)``
    for the duration (the package looks these names up at call time)."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    try:
        for (owner, attr, label), (_, _, fn) in zip(targets, saved):
            setattr(owner, attr, wrap(label, fn))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def capture_inputs(pkg, run_frame, targets=None) -> dict:
    """The arguments of each kernel wrapper's last call during one frame
    (or of each of ``targets``, ``patched`` targets)."""
    calls = {}

    def wrap(label, fn):
        def recorder(*args, **kwargs):
            calls[label] = (args, kwargs)
            return fn(*args, **kwargs)
        return recorder

    if targets is None:
        targets = [(pkg.rk, 'rasterize', 'rasterize'),
                   (pkg.rk, 'rasterize_compact_home', 'rasterize_compact'),
                   (pkg.ops, '_rc_probe_kernel', 'rc_lookup'),
                   (pkg.ops, 'rasterize_resume_compacted', 'resume')]
    with patched(targets, wrap):
        run_frame()
    return calls


def stage_times(pkg, run_frame, reps: int) -> dict:
    """Median CUDA-event ms of each stage of a frame over ``reps`` runs."""
    import torch
    events = collections.defaultdict(list)

    def wrap(label, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events[label].append((start, end))
            return out
        return timed

    targets = [(pkg.lp, 'render_step', 'frame'),
               (pkg.lp, 'sort_phase', 'sort (predict, project, sort)'),
               (pkg.lp, '_prep_features', 'prep (reproject, gather)'),
               (pkg.ops, 'trim_features', 'trim'),
               (pkg.ops, 'rasterize_prefix', 'phase A (rasterize kernel)'),
               (pkg.ops, 'rc_probe', 'probe (fused rc_lookup kernel)'),
               (pkg.ops, 'rasterize_resume_compacted',
                'phase B (compaction + rasterize_compact kernel)'),
               (pkg.ops.rc, 'insert_all_groups', 'insert')]
    with patched(targets, wrap):
        for _ in range(reps):
            run_frame()
    torch.cuda.synchronize()
    per_run = {label: [s.elapsed_time(e) for s, e in pairs]
               for label, pairs in events.items()}
    out = {label: statistics.median(v) for label, v in per_run.items()}
    out['other (pad, regroup, assemble, stats)'] = out['frame'] - sum(
        v for k, v in out.items() if k != 'frame')
    return out


def raster_bound(st, chunk: int, n_feature_chunks: int, lanes: int,
                 lane_inputs: int) -> tuple:
    """(bound_ms, bound_by) for a rasterize launch: the feature bytes of the
    chunks its data needs, plus ``lanes`` lanes that need work, each reading
    ``lane_inputs`` 4-byte words and writing its state once (acc 3, trans,
    record k, count, n_sig, n_iter, iter_at_k), against the operations of
    the examined and contributing pixel-Gaussian pairs."""
    k = st.record.shape[-1]
    state_bytes = lanes * 4 * (lane_inputs + (3 + 1 + k + 4))
    nbytes = n_feature_chunks * chunk * FEATURE_BYTES + state_bytes
    ops = (OPS_EXAMINED * int(st.n_iter.sum())
           + OPS_CONTRIB * int(st.n_sig.sum()))
    rl = peaks()
    t_bytes, t_ops = nbytes / rl.PEAK_BYTES_PER_S, ops / rl.PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def check_raster(name: str, got, want) -> float:
    for field in ('record', 'rec_cnt', 'n_sig', 'n_iter', 'iter_at_k', 'chunks'):
        if not bool((getattr(got, field) == getattr(want, field)).all()):
            fail(f'{name}: {field} differs from the plain version')
    for field in ('acc', 'trans'):
        if not ulp_close(getattr(got, field), getattr(want, field)):
            fail(f'{name}: {field} differs by more than {ULPS} ulps')
    return max(float((got.acc - want.acc).abs().max()),
               float((got.trans - want.trans).abs().max()))


def check_raster_nan(name: str, got, want) -> None:
    """``check_raster`` for states that may hold NaN transmittances: the NaN
    lanes must match, then the rest is held as usual."""
    import torch
    if not torch.equal(got.trans.isnan(), want.trans.isnan()):
        fail(f'{name}: NaN lanes differ')
    check_raster(name, dataclasses.replace(got, trans=got.trans.nan_to_num(0.0)),
                 dataclasses.replace(want, trans=want.trans.nan_to_num(0.0)))


def pair_counts(rk, feats, walked, n_iter, chunk: int, tiles_x: int) -> dict:
    """The pixel-Gaussian pairs of one tile walk ([T, K] features, each
    tile walking ``walked[t]`` chunks from the front): in the walked chunks
    and examined (n_iter), both from the kernel's outputs, and the
    candidates that the kernel's band cull leaves as its plain mirror
    predicts them (``tile_cull_plain`` on the walked chunks; the kernel
    reports no such count)."""
    import torch
    mean2d, conic, _, opacity, ids = feats
    keep = rk.tile_cull_plain(mean2d, conic, opacity, ids, tiles_x=tiles_x)
    in_walk = (torch.arange(ids.shape[-1], device=ids.device)[None]
               < walked[:, None] * chunk)
    return {'walked': int(in_walk.sum()) * rk.P,
            'examined': int(n_iter.sum()),
            'candidates': int((keep & in_walk[..., None]).sum())
            * (rk.P // keep.shape[-1])}


def print_pairs(name: str, pairs: dict) -> None:
    print(f'kernel {name}: pixel-Gaussian pairs in walked chunks '
          f'{pairs["walked"]}, examined {pairs["examined"]}; candidates after '
          f'the band cull as tile_cull_plain predicts them '
          f'{pairs["candidates"]} '
          f'({pairs["candidates"] / max(pairs["walked"], 1):.4f} of walked)',
          flush=True)


def kernel_phase(calls, pkg, launches, chunk: int) -> list:
    import torch
    rk = pkg.rk
    rows = []

    # -- rasterize, prefix mode (phase A), as the main path calls it
    args, kw = calls['rasterize']
    got = rk.rasterize(*args, **kw)
    want = rk.rasterize_plain(*args, **kw)
    err = check_raster('rasterize', got, want)
    # the same inputs in full mode (stop_at_k=False) hold the other branch
    full_kw = dict(kw, stop_at_k=False)
    err_full = check_raster('rasterize[full]', rk.rasterize(*args, **full_kw),
                            rk.rasterize_plain(*args, **full_kw))
    # resume mode, the whole-tile phase B (rc_compact=False): phase A's state,
    # each pixel starting at its iter_at_k, live where phase B works
    st_a, miss = calls['resume'][0][2:4]
    live = pkg.ops.resume_live_mask(st_a, miss, kw['k_record']).to(torch.int32)
    res_args = (*args[:5], st_a.acc, st_a.trans, st_a.record, st_a.rec_cnt,
                st_a.iter_at_k, live, args[11])
    got_res = rk.rasterize(*res_args, **full_kw)
    err_res = check_raster('rasterize[resume]', got_res,
                           rk.rasterize_plain(*res_args, **full_kw))
    res_ms = time_ms(lambda: rk.rasterize(*res_args, **full_kw), 20)
    # a live pixel reads acc 3, trans, record k, count, start and live
    res_bound, res_by = raster_bound(got_res, chunk, int(got_res.chunks.sum()),
                                     int(live.sum()), 6 + kw['k_record'])
    print(f'kernel rasterize[resume]: exact ints, max_abs_err {err_res}; '
          f'{res_ms:.4f} ms, bound {res_bound:.4f} ms ({res_by}); '
          f'{int(live.sum())} live pixels, {int(got_res.chunks.sum())} chunks',
          flush=True)
    pairs = pair_counts(rk, args[:5], got.chunks[:, 0], got.n_iter, chunk,
                        kw['tiles_x'])
    print_pairs('rasterize', pairs)
    ms = time_ms(lambda: rk.rasterize(*args, **kw), 20)
    plain_ms = time_ms(lambda: rk.rasterize_plain(*args, **kw), 3)
    # every pixel's state is an output; the initial state of phase A is a
    # constant (zeros, ones, -1, all live) that a kernel need not read
    bound_ms, bound_by = raster_bound(got, chunk, int(got.chunks.sum()),
                                      got.trans.numel(), 0)
    rows.append(dict(name='rasterize', route='cuda',
                     source='src/repro_torch/kernels/csrc/rasterize.cu',
                     replaces='src/repro/kernels/rasterize.py:185',
                     launches=launches['rasterize'],
                     max_abs_err=max(err, err_full, err_res), ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=None))
    print(f'kernel rasterize: exact ints, max_abs_err {err} (full mode '
          f'{err_full}); {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound '
          f'{bound_ms:.4f} ms ({bound_by}); {int(got.chunks.sum())} chunks '
          f'over {got.chunks.numel()} tiles', flush=True)

    rows.append(compact_row(rk, calls['rasterize_compact'],
                            launches['rasterize_compact'], chunk, plain_reps=3))
    resume_route_check(pkg, pkg.ops.rasterize_resume_compacted, calls['resume'],
                       'ops.rasterize_resume_compacted')
    rows.append(rc_lookup_row(pkg, calls['rc_lookup'], launches['rc_lookup']))
    return rows


def compact_row(rk, call, launches: int, chunk: int, *, plain_reps: int,
                label: str = 'rasterize_compact') -> dict:
    """rasterize_compact (phase B over miss-compacted lanes) against its
    plain version on one captured call, in both addressing modes: home lanes
    (``rasterize_compact_home``, as the main path calls it) and the explicit
    lanes of the JAX package's contract (``rasterize_compact`` on the same
    lanes, gathered by ``compact_lanes``)."""
    import torch
    args, kw = call
    got = rk.rasterize_compact_home(*args, **kw)
    want = rk.rasterize_compact_home_plain(*args, **kw)
    err = check_raster(f'{label}[home]', got, want)
    lane_kw = dict(k_record=kw['k_record'], chunk=kw['chunk'])
    lane_args = (*args[:5], *rk.compact_lanes(
        *args[5:10], *args[12:15], tiles_x=kw['tiles_x'], t_img=kw['t_img']))
    got_l = rk.rasterize_compact(*lane_args, **lane_kw)
    err_l = check_raster(f'{label}[lanes]', got_l,
                         rk.rasterize_compact_plain(*lane_args, **lane_kw))
    if not torch.equal(got_l.chunks, got.chunks):
        fail(f'{label}: the two addressing modes count different chunks')
    ms = time_ms(lambda: rk.rasterize_compact_home(*args, **kw), 20)
    lanes_ms = time_ms(lambda: rk.rasterize_compact(*lane_args, **lane_kw), 20)
    plain_ms = time_ms(lambda: rk.rasterize_compact_home_plain(*args, **kw),
                       plain_reps)
    # feature chunks the live lanes need: distinct (source tile, chunk) pairs
    ids, src, ncap, start, live = (lane_args[4], lane_args[7], lane_args[8],
                                   lane_args[13], lane_args[14])
    nc_total = ids.shape[1] // chunk
    c_lo = torch.where(live != 0, start, ids.shape[1]).amin(1, keepdim=True) // chunk
    c_hi = c_lo + got.chunks
    need = torch.zeros((ids.shape[0], nc_total), dtype=torch.bool, device=ids.device)
    for c in range(nc_total):
        lanes = (live != 0) & (c >= c_lo) & (c < c_hi) & (c < ncap) & (c >= start // chunk)
        need[src[lanes].long(), c] = True
    # only live lanes need work: a dead lane's output is its input state.
    # A live lane reads acc 3, trans, record k, count, start, live, px, py,
    # src and ncap.
    k = got.record.shape[-1]
    bound_ms, bound_by = raster_bound(got_l, chunk, int(need.sum()),
                                      int((live != 0).sum()), 11 + k)
    print(f'kernel {label}: exact ints and chunks in both addressing modes, '
          f'max_abs_err {max(err, err_l)}; home lanes {ms:.4f} ms, explicit '
          f'lanes {lanes_ms:.4f} ms, vs plain {plain_ms:.4f} ms, bound '
          f'{bound_ms:.4f} ms ({bound_by}); {int((live != 0).sum())} live '
          f'lanes in {src.shape[0]} lane tiles over {ids.shape[0]} source '
          f'tiles, {int(got.chunks.sum())} chunks', flush=True)
    compact_counters(rk, call, lane_args, lane_kw, got_l, label)
    return dict(name='rasterize_compact', route='cuda',
                source='src/repro_torch/kernels/csrc/rasterize.cu',
                replaces='src/repro/kernels/rasterize.py:355',
                launches=launches, max_abs_err=max(err, err_l), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def compact_counters(rk, call, args, kw, got, label: str) -> None:
    """What rasterize_compact's lanes ask of it on one captured call, printed
    only: the lane tiles holding a live lane out of all; the lane-chunks the
    tiles walk (trip count x P) against those the live lanes need each on
    its own (own stop chunk minus own start chunk, from the plain mirror
    ``compact_lane_stops_plain``, whose trip count must equal the
    kernel's); the Gaussians each warp walks in sequence (its longest
    lane's), longest and mean; distinct source tiles per warp of live lanes
    (median, 90th percentile); and the wrapper's time with every lane dead
    (explicit lanes all dead; home lanes with n_live 0)."""
    import torch
    src, live = args[7], args[14] != 0
    stop, start, c0 = rk.compact_lane_stops_plain(*args, **kw)
    mirror = torch.clamp(stop.amax(1) - c0, min=0).to(torch.int32)[:, None]
    if not torch.equal(mirror, got.chunks):
        fail(f'{label}: the plain mirror of the trip count differs from the '
             f'kernel\'s chunks')
    own = torch.where(live, torch.clamp(stop - start, min=0), 0)
    need = int(own.sum())
    # a warp walks as long as its longest lane: Gaussians in sequence
    steps = (own.reshape(-1, 32).amax(1) * kw['chunk']).float()
    steps = steps[steps > 0] if bool((steps > 0).any()) else steps[:1]
    lanes = torch.where(live, src, -1).reshape(-1, 32)
    ordered = lanes.sort(1).values
    distinct = ((ordered[:, 1:] != ordered[:, :-1]).sum(1) + 1
                - (ordered[:, 0] < 0).int())
    distinct = distinct[live.reshape(-1, 32).any(1)].float()
    dead = list(args)
    dead[14] = torch.zeros_like(args[14])
    dead_ms = time_ms(lambda: rk.rasterize_compact(*dead, **kw), 20)
    home_args, home_kw = call
    home_dead = (*home_args[:14], torch.zeros_like(home_args[14]))
    home_dead_ms = time_ms(lambda: rk.rasterize_compact_home(*home_dead,
                                                             **home_kw), 20)
    print(f'counters {label}: lane tiles with a live lane '
          f'{int(live.any(1).sum())} of {src.shape[0]}; lane-chunks '
          f'walked {int(got.chunks.sum()) * rk.P}, needed by the live lanes '
          f'alone {need}; Gaussians a warp walks in sequence, longest '
          f'{int(steps.max())}, mean {float(steps.mean()):.1f}; distinct '
          f'source tiles per warp median '
          f'{float(distinct.quantile(0.5))}, p90 {float(distinct.quantile(0.9))}'
          f' over {distinct.numel()} warps; all lanes dead {dead_ms:.4f} ms '
          f'(explicit lanes), {home_dead_ms:.4f} ms (home lanes)', flush=True)


def resume_route_check(pkg, fn, call, label: str) -> None:
    """The CUDA route of a compacted phase B (``fn``, an ``ops`` wrapper)
    against its plain route (gather, ``rasterize_compact_plain``, scatter)
    on the same captured inputs: records, counts and chunks exactly, colors
    within the ulp bound."""
    import torch
    args, kw = call
    got = fn(*args, **kw)
    with patched([(pkg.rk, 'rasterize_compact_home', 'plain')],
                 lambda _, __: pkg.rk.rasterize_compact_home_plain):
        want = fn(*args, **kw)
    for field in ('alpha_record', 'n_significant', 'n_iterated', 'iter_at_k'):
        if not torch.equal(getattr(got[1], field), getattr(want[1], field)):
            fail(f'{label}: {field} differs between the CUDA and plain routes')
    if not torch.equal(got[2], want[2]):
        fail(f'{label}: chunks differ between the CUDA and plain routes')
    for name, x, y in (('colors', got[0], want[0]),
                       ('transmittance', got[1].transmittance,
                        want[1].transmittance)):
        if not ulp_close(x, y):
            fail(f'{label}: {name} differ by more than {ULPS} ulps')
    print(f'{label}: CUDA route equals the plain route (ints and chunks '
          f'exact, {int(got[2].sum())} chunks)', flush=True)


def rc_lookup_row(pkg, call, launches: int, label: str = 'rc_lookup') -> dict:
    """rc_lookup on one captured call of its fused probe (``rcl.rc_probe``,
    as the path calls it): the fused mode against
    ``rc.lookup_all_groups_multi`` (hit, value, way, and the cache's age and
    clock exactly), the lookup-only mode (the TPU kernel's function) on the
    slot-major batch against ``rc_lookup_plain``; then ``probe_times`` and
    ``probe_counters``.  The row's times are the fused probe's: ``ms`` its
    wrapper against ``bound_ms``, and ``kernel_ms`` its kernel alone against
    ``kernel_bound_ms``."""
    import torch
    rc, rcl = pkg.ops.rc, pkg.rcl
    cache, ids, cfg, live = probe_args(pkg, call)
    hit, val, way, age, clock = rcl.rc_probe(cache.tags, cache.values, cache.age,
                                             cache.clock, ids, cfg, live=live)
    w_hit, w_val, _, w_way, w_cache = rc.lookup_all_groups_multi(cache, ids, cfg,
                                                                 live=live)
    for field, x, y in (('hit', hit, w_hit), ('value', val, w_val),
                        ('way', way, w_way), ('age', age, w_cache.age),
                        ('clock', clock, w_cache.clock)):
        if not torch.equal(x, y.to(x.dtype)):
            fail(f'{label}: fused {field} differs from rc.lookup_all_groups_multi')
    ids_f = rc.slot_major(ids).contiguous()
    got = rcl.rc_lookup(cache.tags, cache.values, ids_f, cfg)
    want = rcl.rc_lookup_plain(cache.tags, cache.values, ids_f, cfg)
    for field, x, y in zip(('hit', 'value', 'set_idx', 'way'), got, want):
        if not torch.equal(x, y):
            fail(f'{label}: lookup-only {field} differs from rc_lookup_plain')
    times = probe_times(pkg, call, label)
    plain_ms = time_ms(lambda: rc.lookup_all_groups_multi(cache, ids, cfg,
                                                          live=live), 5)
    g, s, w, k = cache.tags.shape
    set_g = got[2].long() + s * torch.arange(g, device=ids.device)[:, None]
    sets = torch.unique(set_g)
    slot = set_g * w + got[3].long()
    touched = got[0] if live is None else got[0] & rc.slot_major(
        rc.viewer_live(live, ids.shape[:3]))
    live_bytes = 0 if live is None else live.numel()
    # the wrapper: ids, each probed set's tags and values, the outputs of
    # lookup only (hit, value, set, way) or of the fused probe (hit, value,
    # way; the copy of age read and written, clock read and written)
    lookup_bytes = ids.numel() * 4 + sets.numel() * w * (k + 3) * 4
    lookup_bound = (lookup_bytes + hit.numel() * (1 + 12 + 4 + 4)) / peaks().PEAK_BYTES_PER_S * 1e3
    nbytes = (lookup_bytes + hit.numel() * (1 + 12 + 4) + age.numel() * 8
              + clock.numel() * 8 + live_bytes)
    bound_ms = nbytes / peaks().PEAK_BYTES_PER_S * 1e3
    # the fused kernel alone: ids, each probed set's tags, the chosen way's
    # value, hit/value/way, each touched slot read and written, clock in and
    # out (the age copy is the wrapper's)
    kernel_bytes = (ids.numel() * 4 + sets.numel() * w * k * 4
                    + torch.unique(slot).numel() * 12 + hit.numel() * (1 + 12 + 4)
                    + torch.unique(slot[touched]).numel() * 8 + clock.numel() * 8
                    + live_bytes)
    kernel_bound_ms = kernel_bytes / peaks().PEAK_BYTES_PER_S * 1e3
    ms = statistics.median(times['probe_wrapper_ms'])
    kernel_ms = statistics.median(times['probe_kernel_ms'])
    print(f'kernel {label}: exact (fused against rc.lookup_all_groups_multi, '
          f'lookup only against rc_lookup_plain); fused {ms:.4f} ms, bound '
          f'{bound_ms:.4f} ms (bytes); kernel alone {kernel_ms:.4f} ms, bound '
          f'{kernel_bound_ms:.4f} ms (bytes); lookup only '
          f'{statistics.median(times["lookup_wrapper_ms"]):.4f} ms, kernel '
          f'alone {statistics.median(times["lookup_kernel_ms"]):.4f} ms, bound '
          f'{lookup_bound:.4f} ms (bytes); plain {plain_ms:.4f} ms; ids '
          f'{list(ids.shape)}, {int(hit.sum())}/{hit.numel()} hits, '
          f'{sets.numel()} sets probed', flush=True)
    probe_counters(pkg, call, label)
    return dict(name='rc_lookup', route='cuda',
                source='src/repro_torch/kernels/csrc/rc_lookup.cu',
                replaces='src/repro/kernels/rc_lookup.py:49',
                launches=launches, max_abs_err=float((val - w_val).abs().max()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by='bytes',
                library_ms=None, kernel_ms=kernel_ms,
                kernel_bound_ms=kernel_bound_ms)


class LaunchRecorder:
    """Stands in for a loaded kernel library and records each ``*_launch``
    call (the C entry and its ctypes arguments) on its way through."""

    def __init__(self, lib):
        self.lib, self.launches = lib, []

    def __getattr__(self, attr):
        fn = getattr(self.lib, attr)
        if not attr.endswith('_launch'):
            return fn

        def record(*args):
            self.launches.append((fn, args))
            return fn(*args)
        return record


def kernel_alone(pkg, fn, reps: int = 50) -> tuple:
    """The rc_lookup kernel alone, without its wrapper: ``fn`` runs once with
    the loaded library replaced by a ``LaunchRecorder``, then its last
    ctypes launch is made again ``reps`` times back to back, each between
    two CUDA events.  Returns (median ms, what ``fn`` returned, which holds
    the launch's buffers alive)."""
    import torch
    build = pkg.build
    lib = build.load('rc_lookup', pkg.rcl._SIGNATURES)
    rec = LaunchRecorder(lib)
    build._LIBS['rc_lookup'] = rec
    try:
        out = fn()
    finally:
        build._LIBS['rc_lookup'] = lib
    if not rec.launches:
        fail('kernel_alone: the call made no rc_lookup launch')
    launch, args = rec.launches[-1]
    launch(*args)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        code = launch(*args)
        end.record()
        if code:
            fail(f'kernel_alone: the replayed launch returned CUDA error {code}')
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs), out


def probe_args(pkg, call) -> tuple:
    """A captured probe as (cache, viewer-major ids [V, G, B, k], cfg, live
    or None), from a call of ``ops.rc_probe(cache, ids_g, cfg)``,
    ``ops.rc_probe_multi(cache, ids, cfg, live=...)`` or
    ``rcl.rc_probe(tags, values, age, clock, ids, cfg, live=...)``."""
    rc = pkg.ops.rc
    args, kw = call
    if isinstance(args[0], rc.CacheState):
        cache, ids, cfg = args[:3]
        return cache, ids if ids.ndim == 4 else ids[None], cfg, kw.get('live')
    tags, values, age, clock, ids, cfg = args
    return (rc.CacheState(tags, values, age, clock),
            ids if ids.ndim == 4 else ids[None], cfg, kw.get('live'))


def probe_times(pkg, call, label: str, rounds: int = 3) -> dict:
    """The LuminCache probe's times on one captured call, in ``rounds``
    rounds of medians of 50 (CUDA events): the fused probe's kernel alone
    and its wrapper (``rcl.rc_probe``), and the lookup-only mode's, on the
    slot-major batch (``rcl.rc_lookup``)."""
    rc, rcl = pkg.ops.rc, pkg.rcl
    cache, ids, cfg, live = probe_args(pkg, call)
    ids_f = rc.slot_major(ids).contiguous()
    fused = lambda: rcl.rc_probe(cache.tags, cache.values, cache.age,  # noqa: E731
                                 cache.clock, ids, cfg, live=live)
    lookup = lambda: rcl.rc_lookup(cache.tags, cache.values, ids_f, cfg)  # noqa: E731
    out = collections.defaultdict(list)
    for _ in range(rounds):
        out['probe_kernel_ms'].append(kernel_alone(pkg, fused)[0])
        out['probe_wrapper_ms'].append(time_ms(fused, 50))
        out['lookup_kernel_ms'].append(kernel_alone(pkg, lookup)[0])
        out['lookup_wrapper_ms'].append(time_ms(lookup, 50))
    print(f'probe times {label} (ms, {rounds} rounds of medians of 50; ids '
          f'{list(ids.shape)}): ' + json.dumps(out), flush=True)
    return out


def probe_counters(pkg, call, label: str) -> dict:
    """What the LRU touch asks of memory on one captured probe, printed only:
    records that touch (hit and live) of all, distinct (group, set, way)
    slots touched, the most touches of one slot, and the distinct slots
    touched per warp of 32 consecutive records of the slot-major batch
    (median and 90th percentile over warps that touch)."""
    import torch
    rc, rcl = pkg.ops.rc, pkg.rcl
    cache, ids, cfg, live = probe_args(pkg, call)
    ids_f = rc.slot_major(ids).contiguous()
    hit, _, sidx, way = rcl.rc_lookup_plain(cache.tags, cache.values, ids_f, cfg)
    touched = hit if live is None else hit & rc.slot_major(
        rc.viewer_live(live, ids.shape[:3]))
    g, s, w, _ = cache.tags.shape
    slot = ((torch.arange(g, device=ids.device)[:, None] * s + sidx.long()) * w
            + way.long())
    hits = torch.bincount(slot[touched], minlength=g * s * w)
    key = torch.where(touched, slot, -1).reshape(-1)
    key = torch.cat([key, key.new_full((-key.numel() % 32,), -1)]).reshape(-1, 32)
    ordered = key.sort(1).values
    distinct = ((ordered[:, 1:] != ordered[:, :-1]).sum(1) + 1
                - (ordered[:, 0] < 0).long())
    distinct = distinct[(key >= 0).any(1)].float()
    out = dict(records=int(touched.numel()), touched=int(touched.sum()),
               distinct_slots=int((hits > 0).sum()), max_touches_one_slot=int(hits.max()),
               warp_distinct_median=float(distinct.quantile(0.5)),
               warp_distinct_p90=float(distinct.quantile(0.9)),
               warps=int(distinct.numel()))
    print(f'counters {label}: ' + json.dumps(out), flush=True)
    return out


def stress_features(pkg, gen, shape: tuple, tiles_x: int, chunk: int):
    """Seeded synthetic tile lists of ``shape`` = (..., T, K) on the card:
    Gaussians on and near tile borders, on the edge of the kernel's cull
    ellipse, and anywhere; axis-aligned to singular conics, some non-finite
    or negative; opacities from 0 through 1/255 (and a few float32 ulps
    on either side) to 1 and beyond; -1 holes, and each list cut at a random
    length.  Returns the five feature tensors and the tiles' chunk caps."""
    import torch
    dev, f32 = DEVICE, torch.float32
    *lead, t, k = shape

    def uniform(lo, hi, size=shape):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=dev)

    def pick(values, size=shape):
        v = torch.tensor(values, dtype=torch.float64, device=dev)
        return v[torch.randint(0, len(v), size, generator=gen, device=dev)]

    tix = torch.arange(t, device=dev)[:, None]
    x0 = (tix % tiles_x * 16).double()
    y0 = (tix // tiles_x * 16).double()
    kind = torch.randint(0, 6, shape, generator=gen, device=dev)
    la, lc = 10 ** uniform(-4.0, 1.0), 10 ** uniform(-4.0, 1.0)
    rho = pick([0.0, 0.5, 0.99, 0.9995, 0.99999, 1.0, -0.9999])
    b = rho * torch.sqrt(la * lc)
    k_sig = float(torch.tensor(1 / 255, dtype=f32))
    op = pick([0.0, 1e-3, k_sig * (1 - 2e-7), k_sig, k_sig * (1 + 2e-7),
               0.004, 0.05, 0.5, 0.99, 1.0, 1.5])
    op = torch.where(uniform(0.0, 1.0) < 0.3, uniform(0.0, 1.0), op)
    # the tangent distance of the ellipse alpha = 1/255 from the mean
    r2 = 2 * torch.log(torch.clamp(op, min=1e-30) / k_sig)
    det = la * lc - b * b
    ex = torch.nan_to_num(torch.sqrt(r2 * lc / det), nan=4.0, posinf=4.0)
    edge = 1 + uniform(-2e-3, 2e-3)
    border = pick([-0.5, 0.0, 0.5, 15.5, 16.0, 16.5, -3.0, 19.0], (*shape, 2))
    mx = torch.where(kind < 3, x0 + border[..., 0] + 0.3 * torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float64), x0 + 15.5 + ex * edge)
    my = torch.where(kind < 3, y0 + border[..., 1], y0 + uniform(0.0, 16.0))
    anywhere = kind == 5
    mx = torch.where(anywhere, uniform(-20.0, 16.0 * tiles_x + 20), mx)
    my = torch.where(anywhere, uniform(-20.0, (t // tiles_x + 1) * 16.0 + 20), my)
    bad = uniform(0.0, 1.0) < 0.02
    la = torch.where(bad, pick([float('inf'), float('nan'), -1.0]), la)
    ids = torch.arange(k, device=dev, dtype=torch.int32).expand(shape)
    n_valid = torch.randint(0, k + 1, (*lead, t, 1), generator=gen, device=dev)
    ids = torch.where((uniform(0.0, 1.0) < 0.05)
                      | (torch.arange(k, device=dev) >= n_valid), -1, ids)
    mean2d = torch.stack([mx, my], -1).to(f32).contiguous()
    conic = torch.stack([la, b, lc], -1).to(f32).contiguous()
    color = torch.rand((*shape, 3), generator=gen, device=dev)
    ncap = pkg.ops.chunk_caps(ids.reshape(-1, k), chunk).reshape(*lead, t)
    return ((mean2d, conic, color, op.to(f32).contiguous(), ids.contiguous()),
            ncap.contiguous())


def stress_state(gen, shape: tuple, k_record: int, k: int, resume: bool):
    """Initial pixel state [*shape, P]: phase A's, or a random resume state
    (transmittance down to its floor, counts to k, starts anywhere)."""
    import torch
    dev, i32 = DEVICE, torch.int32
    shape = (*shape, 256)
    live = (torch.rand(shape, generator=gen, device=dev) < 0.85).to(i32)
    if not resume:
        return (torch.zeros((*shape, 3), device=dev), torch.ones(shape, device=dev),
                torch.full((*shape, k_record), -1, dtype=i32, device=dev),
                torch.zeros(shape, dtype=i32, device=dev),
                torch.zeros(shape, dtype=i32, device=dev), live)
    trans = torch.rand(shape, generator=gen, device=dev)
    trans = torch.where(trans < 0.05, 1e-5, trans)
    return (torch.rand((*shape, 3), generator=gen, device=dev), trans,
            torch.randint(-1, 1000, (*shape, k_record), generator=gen,
                          device=dev, dtype=i32),
            torch.randint(0, k_record + 1, shape, generator=gen, device=dev,
                          dtype=i32),
            torch.randint(0, k, shape, generator=gen, device=dev, dtype=i32),
            live)


def stress_phase(pkg) -> None:
    """rasterize (full, prefix, resume, resume with NaN transmittances)
    and rasterize_slots (full, prefix) on seeded synthetic tiles, held
    exactly against their plain versions."""
    import torch
    rk = pkg.rk
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    tiles_x, t, k, s, chunk, kr = 12, 96, 512, 4, 64, 5
    kw = dict(tiles_x=tiles_x, k_record=kr, chunk=chunk)
    feats, ncap = stress_features(pkg, gen, (t, k), tiles_x, chunk)
    # a cap below the lists' own ends, too, as the single-slot kernel allows
    ncap = torch.minimum(ncap, torch.randint(1, k // chunk + 1, (t,), generator=gen,
                                             device=DEVICE, dtype=torch.int32))
    keep = rk.tile_cull_plain(feats[0], feats[1], feats[3], feats[4],
                              tiles_x=tiles_x)
    valid = feats[4] >= 0
    for mode in ('full', 'prefix', 'resume'):
        state = stress_state(gen, (t,), kr, k, mode == 'resume')
        mkw = dict(kw, stop_at_k=mode == 'prefix')
        check_raster(f'stress rasterize[{mode}]',
                     rk.rasterize(*feats, *state, ncap, **mkw),
                     rk.rasterize_plain(*feats, *state, ncap, **mkw))
    feats_s, ncap_s = stress_features(pkg, gen, (s, t, k), tiles_x, chunk)
    state_s = stress_state(gen, (s, t), kr, k, False)
    state_s = state_s[:4] + state_s[5:]           # the slots take no start
    for stop in (False, True):
        mkw = dict(kw, stop_at_k=stop)
        check_raster(f'stress rasterize_slots[{"prefix" if stop else "full"}]',
                     rk.rasterize_slots(*feats_s, *state_s, ncap_s, **mkw),
                     rk.rasterize_slots_plain(*feats_s, *state_s, ncap_s, **mkw))
    # resume with some transmittances NaN: neither done nor active, so the
    # tile walks on and such a pixel examines nothing, as in the reference
    state = stress_state(gen, (t,), kr, k, True)
    nan = torch.rand(state[1].shape, generator=gen, device=DEVICE) < 0.02
    state = (state[0], torch.where(nan, float('nan'), state[1]), *state[2:])
    check_raster_nan('stress rasterize[resume, NaN trans]',
                     rk.rasterize(*feats, *state, ncap, **kw),
                     rk.rasterize_plain(*feats, *state, ncap, **kw))
    print(f'stress: rasterize (full, prefix, resume, resume with NaN '
          f'transmittances) on {t} tiles x {k} and '
          f'rasterize_slots (full, prefix) on {s} x {t} x {k} synthetic '
          f'Gaussians exact; the band cull removes '
          f'{float(1 - keep[valid].float().mean()):.4f} of the valid '
          f'(Gaussian, band) pairs of the single-slot lists', flush=True)


def compact_stress_phase(pkg) -> None:
    """rasterize_compact in both addressing modes on seeded synthetic lanes
    over full-width lists (a 1920-pixel-wide band of 120 x 8 tiles, K =
    1024, chunk 64), held exactly against ``rasterize_compact_plain`` (home
    lanes: ``rasterize_compact_home_plain``), and each trip count against
    its plain mirror ``compact_chunks_plain``.  The lanes: a tenth start at
    their source tile's cap (start chunk = ncap, as iter_at_k can be
    ncap * chunk), 2 % have a NaN transmittance and 5 % one below the floor;
    home lanes with n_live 0, 1, 256, 257 and 6,000; explicit lanes with
    all-dead lane tiles and dead lanes inside live ones."""
    import torch
    rk, ops = pkg.rk, pkg.ops
    dev, i32 = DEVICE, torch.int32
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tiles_x, t, k, chunk, kr = 120, 960, 1024, 64, 5
    kw = dict(k_record=kr, chunk=chunk)
    feats, ncap = stress_features(pkg, gen, (t, k), tiles_x, chunk)
    acc0, trans0, rec0, cnt0, start, _ = stress_state(gen, (t,), kr, k, True)
    full = cnt0 + kr      # home lanes hold a full record, as phase B's do
    cap_pos = (ncap * chunk)[:, None]
    start = torch.minimum(start, cap_pos)
    start = torch.where(torch.rand(start.shape, generator=gen, device=dev) < 0.1,
                        cap_pos, start).to(i32).contiguous()
    nan = torch.rand(trans0.shape, generator=gen, device=dev) < 0.02
    trans0 = torch.where(nan, float('nan'), trans0).contiguous()
    nsig0 = torch.randint(0, 50, start.shape, generator=gen, device=dev, dtype=i32)
    niter0 = torch.randint(0, 500, start.shape, generator=gen, device=dev, dtype=i32)
    hkw = dict(kw, tiles_x=tiles_x, t_img=t)
    chunks = []
    for n in (0, 1, 256, 257, 6000):
        live = torch.zeros(t * rk.P, dtype=torch.bool, device=dev)
        live[torch.randperm(t * rk.P, generator=gen, device=dev)[:n]] = True
        home, n_live = ops.compaction_order(live.reshape(t, rk.P))
        args = (*feats, ncap, acc0, trans0, rec0, full, nsig0, niter0, start,
                home, n_live)
        got = rk.rasterize_compact_home(*args, **hkw)
        check_raster_nan(f'stress rasterize_compact[home, n_live {n}]', got,
                         rk.rasterize_compact_home_plain(*args, **hkw))
        lane_args = (*feats, *rk.compact_lanes(ncap, acc0, trans0, rec0, full,
                                               start, home, n_live,
                                               tiles_x=tiles_x, t_img=t))
        got_l = rk.rasterize_compact(*lane_args, **kw)
        check_raster_nan(f'stress rasterize_compact[lanes, n_live {n}]', got_l,
                         rk.rasterize_compact_plain(*lane_args, **kw))
        if not (torch.equal(got.chunks, got_l.chunks) and torch.equal(
                got.chunks, rk.compact_chunks_plain(*lane_args, **kw))):
            fail(f'stress rasterize_compact[n_live {n}]: chunks differ between '
                 f'the addressing modes or from the plain mirror')
        chunks.append(int(got.chunks.sum()))
    # explicit lanes of any source tile, source-tile-major as the wrappers
    # pack them, with dead lanes anywhere and two all-dead lane tiles
    ct = 32
    src = torch.randint(0, t, (ct * rk.P,), generator=gen, device=dev).sort().values
    pix = torch.randint(0, rk.P, (ct * rk.P,), generator=gen, device=dev)
    h = src * rk.P + pix

    def lanes(x):
        return x.reshape(t * rk.P, *x.shape[2:])[h].reshape(ct, rk.P, *x.shape[2:])

    px = ((src % tiles_x) * 16 + pix % 16).float().reshape(ct, rk.P) + 0.5
    py = ((src // tiles_x) * 16 + pix // 16).float().reshape(ct, rk.P) + 0.5
    live = (torch.rand((ct, rk.P), generator=gen, device=dev) < 0.85).to(i32)
    live[[3, 17]] = 0
    lane_args = (*feats, px, py, src.to(i32).reshape(ct, rk.P),
                 ncap[src].reshape(ct, rk.P),
                 *(lanes(x) for x in (acc0, trans0, rec0, cnt0, start)), live)
    got = rk.rasterize_compact(*lane_args, **kw)
    check_raster_nan('stress rasterize_compact[lanes, dead lanes anywhere]',
                     got, rk.rasterize_compact_plain(*lane_args, **kw))
    if not torch.equal(got.chunks, rk.compact_chunks_plain(*lane_args, **kw)):
        fail('stress rasterize_compact[lanes, dead lanes anywhere]: chunks '
             'differ from the plain mirror')
    if int(got.chunks[3]) or int(got.chunks[17]):
        fail('stress rasterize_compact: an all-dead lane tile walked')
    print(f'stress: rasterize_compact (home and explicit lanes, n_live 0, 1, '
          f'256, 257, 6000: {chunks} chunks; explicit lanes with dead lanes '
          f'anywhere: {int(got.chunks.sum())} chunks) on {t} tiles x {k} '
          f'synthetic Gaussians exact, trip counts equal to the plain mirror',
          flush=True)


def probe_stress_phase(pkg) -> None:
    """rc_lookup in both modes on seeded synthetic caches and records, held
    exactly against the plain versions: the lookup-only mode against
    ``rc_lookup_plain`` and the fused probe against
    ``rc.lookup_all_groups_multi`` (hit, value, way, age, clock).  Cases:
    an all-miss (cold) cache, an all-hit cache, a mixed one whose sets hold
    a tag in two ways (the first must win), hot slots hit by every record of
    a block, both index modes, G*B not a multiple of the block, B = 1, one
    and four viewers, live as [V] and [V, G] with dead viewers, and -1
    padded records."""
    import torch
    rc, rcl = pkg.ops.rc, pkg.rcl
    dev, i32 = DEVICE, torch.int32
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = []
    for mode in ('hash', 'bitconcat'):
        cfg = rc.CacheConfig(n_sets=1024, n_ways=4, k=5, index_mode=mode)
        for g, v, b in ((510, 4, 4096), (7, 1, 100), (33, 4, 1), (3, 2, 777)):
            cases.append((cfg, g, v, b))
    names = []
    for cfg, g, v, b in cases:
        # 64 records a group, a tenth of them -1 padded (fewer than k
        # significant ids); whole blocks of one record (hot slots)
        pool = torch.randint(0, 3000, (g, 64, cfg.k), generator=gen, device=dev,
                             dtype=i32)
        pad = torch.rand((g, 64, 1), generator=gen, device=dev) < 0.1
        pool = torch.where(pad & (torch.arange(cfg.k, device=dev) >= 2), -1, pool)
        pick = torch.randint(0, 64, (v, g, b), generator=gen, device=dev)
        ids = torch.gather(pool[None].expand(v, -1, -1, -1), 2,
                           pick[..., None].expand(-1, -1, -1, cfg.k))
        hot = (torch.arange(v * g * b, device=dev) // 256 % 5 == 0).reshape(v, g, b)
        ids = torch.where(hot[..., None], pool[None, :, :1, :].expand(v, -1, b, -1),
                          ids).contiguous()
        cold = rc.init_cache(g, cfg, device=dev)
        full = rc.insert_all_groups_multi(
            cold, ids, torch.rand((v, g, b, 3), generator=gen, device=dev),
            torch.ones((v, g, b), dtype=torch.bool, device=dev), cfg)
        # a record that found no room (more than W in a set) is replaced by
        # its group's first record that did, so that every record hits
        ids_f = rc.slot_major(ids)
        hit_f = rcl.rc_lookup_plain(full.tags, full.values, ids_f, cfg)[0]
        first = ids_f[torch.arange(g, device=dev), hit_f.int().argmax(1)]
        ids = rc.slot_split(torch.where(hit_f[..., None], ids_f, first[:, None]),
                            v).contiguous()
        # the same tag in two ways of a set: copy way 0 into way 2 where set
        # parity is odd, with another value, and age the cache at random
        dup = torch.arange(cfg.n_sets, device=dev) % 2 == 1
        tags = full.tags.clone()
        tags[:, dup, 2] = tags[:, dup, 0]
        values = torch.rand(full.values.shape, generator=gen, device=dev)
        age = torch.randint(0, 1000, full.age.shape, generator=gen, device=dev,
                            dtype=i32)
        clock = torch.randint(1000, 5000, (g,), generator=gen, device=dev,
                              dtype=i32)
        mixed = rc.CacheState(tags, values, age, clock)
        lives = [None, torch.tensor([True] + [False] * (v - 1), device=dev),
                 torch.rand((v, g), generator=gen, device=dev) < 0.6]
        for cname, cache in (('all-miss', cold), ('all-hit', full),
                             ('duplicate ways', mixed)):
            ids_f = rc.slot_major(ids).contiguous()
            got = rcl.rc_lookup(cache.tags, cache.values, ids_f, cfg)
            want = rcl.rc_lookup_plain(cache.tags, cache.values, ids_f, cfg)
            label = f'stress rc_lookup[{cfg.index_mode}, G {g}, V {v}, B {b}, {cname}]'
            for field, x, y in zip(('hit', 'value', 'set_idx', 'way'), got, want):
                if not torch.equal(x, y):
                    fail(f'{label}: lookup-only {field} differs from rc_lookup_plain')
            if cname == 'all-miss' and bool(got[0].any()):
                fail(f'{label}: a hit in a cold cache')
            if cname == 'all-hit' and not bool(got[0].all()):
                fail(f'{label}: a miss in a cache that holds every record')
            for live in lives:
                fused = rcl.rc_probe(cache.tags, cache.values, cache.age,
                                     cache.clock, ids, cfg, live=live)
                ref = rc.lookup_all_groups_multi(cache, ids, cfg, live=live)
                ref = (ref[0], ref[1], ref[3], ref[4].age, ref[4].clock)
                if v == 1:      # one viewer's ids as [G, B, k], as ops.rc_probe passes them
                    one = rcl.rc_probe(cache.tags, cache.values, cache.age,
                                       cache.clock, ids[0], cfg, live=live)
                    fused = (*(x[None] for x in one[:3]), *one[3:])
                for field, x, y in zip(('hit', 'value', 'way', 'age', 'clock'),
                                       fused, ref):
                    if not torch.equal(x, y.to(x.dtype)):
                        fail(f'{label}, live {None if live is None else list(live.shape)}: '
                             f'fused {field} differs from the plain probe')
        names.append(f'{cfg.index_mode} G{g} V{v} B{b}')
    print(f'stress: rc_lookup (lookup only and fused, all-miss, all-hit and '
          f'duplicate-way caches, hot slots, -1 padded records, live None, [V] '
          f'and [V, G]) exact on {", ".join(names)}', flush=True)


def lumina_config(pkg, **overrides):
    c = pkg.CONFIG
    return pkg.lp.LuminaConfig(
        window=c.window, margin=c.margin, capacity=c.capacity,
        k_record=c.k_record, group_tiles=c.group_tiles,
        sort_method=c.sort_method, **overrides)


def main_path(pkg) -> tuple:
    """12 frames through ``LuminSys(backend='kernel')``.  Returns the scene,
    config, cameras, the state before each frame, the per-frame records
    (hits, image, cache tags/age/clock) and the launch counts."""
    import torch
    cfg = lumina_config(pkg, backend='kernel')
    t0 = time.perf_counter()
    scene = pkg.structured_scene(SEED, GAUSSIANS, device='cuda')
    cams = pkg.orbit_trajectory(FRAMES, width=WIDTH, height_px=HEIGHT,
                                device='cuda')
    torch.cuda.synchronize()
    print(f'scene: {GAUSSIANS} Gaussians, {FRAMES} frames at '
          f'{WIDTH}x{HEIGHT}, made in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)

    sys_ = pkg.lp.LuminSys(scene, cfg, cams[0], device='cuda')
    states, records, frame_ms = [], [], []
    pkg.kernels.reset_launches()
    for i, cam in enumerate(cams):
        states.append(sys_.state)
        torch.cuda.synchronize()
        t = time.perf_counter()
        image, st = sys_.step(cam)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        sorted_ = bool(float(st.sorted_this_frame))
        frame_ms.append((sorted_, ms))
        print(f'frame {i:2d} {"sort+shade" if sorted_ else "shade":10s} '
              f'{ms:9.3f} ms  hit_rate {float(st.hit_rate):.4f}  saved_frac '
              f'{float(st.saved_frac):.4f}  mean_iterated '
              f'{float(st.mean_iterated):.2f}', flush=True)
        if tuple(image.shape) != (HEIGHT, WIDTH, 3):
            fail(f'frame {i}: image shape {tuple(image.shape)}')
        if not bool(torch.isfinite(image).all()):
            fail(f'frame {i}: non-finite image')
        c = sys_.cache
        records.append((round(float(st.hit_rate) * WIDTH * HEIGHT),
                        image, c.tags.clone(), c.age.clone(), c.clock.clone()))
    launches = dict(pkg.kernels.LAUNCHES)
    print(f'launches in the main path: {json.dumps(launches)}', flush=True)
    for name in ('rasterize', 'rasterize_compact', 'rc_lookup'):
        if launches[name] <= 0:
            fail(f'kernel {name} was not launched by the main path')
    shade = [ms for s, ms in frame_ms[1:] if not s]
    sort = [ms for s, ms in frame_ms[1:] if s]
    print(f'frame time (frame 0 excluded: first use): shade frames median '
          f'{statistics.median(shade):.3f} ms, max {max(shade):.3f} ms over '
          f'{len(shade)}; sort frames {", ".join(f"{m:.3f}" for m in sort)} ms',
          flush=True)
    return scene, cfg, cams, states, records, launches


def reference_check(pkg, scene, cams, records) -> None:
    """The same frames through the plain reference backend: identical
    decisions and ulp-close images."""
    import torch
    sys_ = pkg.lp.LuminSys(scene, lumina_config(pkg, backend='reference'),
                           cams[0], device='cuda')
    worst_abs, worst_ulps = 0.0, 0.0
    eps = torch.finfo(torch.float32).eps
    for i, cam in enumerate(cams):
        image, st = sys_.step(cam)
        c = sys_.cache
        hits = round(float(st.hit_rate) * WIDTH * HEIGHT)
        want = records[i]
        same = hits == want[0] and all(
            bool((x == y).all()) for x, y in zip((c.tags, c.age, c.clock), want[2:]))
        if not same:
            fail(f'frame {i}: kernel and reference backends made different '
                 f'cache decisions (hits {want[0]} vs {hits})')
        if not ulp_close(want[1], image):
            fail(f'frame {i}: kernel and reference images differ by more '
                 f'than {ULPS} ulps')
        diff = (want[1] - image).abs()
        scale = torch.clamp(torch.maximum(want[1].abs(), image.abs()), min=1.0)
        worst_abs = max(worst_abs, float(diff.max()))
        worst_ulps = max(worst_ulps, float((diff / (eps * scale)).max()))
    print(f'reference backend: identical hits and cache state on all '
          f'{len(cams)} frames; images within {ULPS} ulps (largest difference '
          f'{worst_abs!r}, {worst_ulps!r} ulps x magnitude)', flush=True)


def quality(pkg, scene, cams, records) -> None:
    """PSNR and SSIM against exact 3DGS of Lumina, S^2 alone and RC alone."""
    frames = sorted({pkg.CONFIG.window - 1, len(cams) - 1})
    exact = {i: pkg.lp.render_frame_baseline(
        scene, cams[i], lumina_config(pkg), device='cuda')[0] for i in frames}
    variants = {'S2+RC (main path)': {i: records[i][1] for i in frames}}
    for name, opts in (('S2 only', dict(use_rc=False)),
                       ('RC only', dict(use_s2=False))):
        sys_ = pkg.lp.LuminSys(scene, lumina_config(pkg, backend='kernel', **opts),
                               cams[0], device='cuda')
        variants[name] = {}
        for i, cam in enumerate(cams):
            image, _ = sys_.step(cam)
            if i in frames:
                variants[name][i] = image
    for name, images in variants.items():
        dbs = {i: float(pkg.psnr(images[i], exact[i])) for i in frames}
        ssims = {i: float(pkg.ssim(images[i], exact[i])) for i in frames}
        print(f'PSNR vs render_frame_baseline, {name}: ' + ', '.join(
            f'frame {i} {db:.2f} dB (SSIM {ssims[i]:.4f})'
            for i, db in dbs.items()), flush=True)
        if name.startswith('S2+RC') and not min(dbs.values()) > PSNR_FLOOR_DB:
            fail(f'PSNR {min(dbs.values()):.2f} dB against the baseline')


def dense_walk_check(pkg, scene, cam, cfg) -> dict:
    """(a) The dense differentiable walk on frame 0's features at full
    width, with grad on, against the chunked early-exit walk: every output
    bit for bit.  Times (CUDA events) of the chunked walk, the dense
    forward and the dense forward + backward (gradient of the colors' sum
    into the four float feature arrays), and the peak memory of the
    backward."""
    import torch
    rz = pkg.rasterize
    with torch.no_grad():
        proj = pkg.lp.project(scene, cam)
        lists = pkg.lp.sort_scene(proj, cam.width, cam.height, cfg.capacity,
                                  method=cfg.sort_method,
                                  max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)
        feats = pkg.lp.gather_tile_features(proj, lists)
    names = ('mean2d', 'conic', 'color', 'opacity')
    leaves = {n: getattr(feats, n).clone().requires_grad_() for n in names}
    gfeats = dataclasses.replace(feats, **leaves)
    with torch.no_grad():
        want_c, want = rz.rasterize_tiles(feats, lists.tiles_x,
                                          k_record=cfg.k_record)
    got_c, got = rz.rasterize_tiles(gfeats, lists.tiles_x,
                                    k_record=cfg.k_record, early_exit=False)
    if not got_c.requires_grad:
        fail('paper (a): the dense walk built no graph')
    if not torch.equal(got_c.detach(), want_c):
        fail('paper (a): dense and chunked walks differ on the colors')
    for f in dataclasses.fields(rz.RasterAux):
        if not torch.equal(getattr(got, f.name).detach(),
                           getattr(want, f.name)):
            fail(f'paper (a): dense and chunked walks differ on {f.name}')
    del got_c, got

    def forward():
        return rz.rasterize_tiles(gfeats, lists.tiles_x,
                                  k_record=cfg.k_record, early_exit=False)

    def forward_backward():
        colors, _ = forward()
        grads = torch.autograd.grad(colors.sum(), list(leaves.values()))
        for n, g in zip(names, grads):
            if not bool(torch.isfinite(g).all()):
                fail(f'paper (a): the dense walk gave a non-finite {n} gradient')

    chunked_ms = time_ms(lambda: rz.rasterize_tiles(
        feats, lists.tiles_x, k_record=cfg.k_record), 3)
    with torch.no_grad():
        nograd_ms = time_ms(forward, 3)
    fwd_ms = time_ms(forward, 3)
    peak = None
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    fb_ms = time_ms(forward_backward, 3)
    if DEVICE == 'cuda':
        peak = torch.cuda.max_memory_allocated()
    out = dict(tiles=int(feats.ids.shape[0]), list_len=int(feats.ids.shape[1]),
               pairs=int(feats.ids.shape[0]) * int(feats.ids.shape[1]) * rz.P,
               chunked_ms=chunked_ms, dense_nograd_ms=nograd_ms,
               dense_forward_ms=fwd_ms, dense_forward_backward_ms=fb_ms,
               peak_bytes=peak,
               peak_above_inputs_bytes=None if peak is None else peak - base)
    print('paper (a): the dense walk equals the chunked walk bit for bit on '
          'the colors and every aux field, frame 0 at full width; '
          + json.dumps(out), flush=True)
    return out


def paper_finetune_config(pkg, lr: float | None = None):
    """Eqn. 4's loss with PAPER_ALPHA and PAPER_THETA; ``lr``, where given,
    replaces the JAX example's one learning rate for every parameter."""
    fcfg = pkg.finetune.FinetuneConfig(scale_alpha=PAPER_ALPHA,
                                       scale_theta=PAPER_THETA)
    if lr is None:
        return fcfg
    return dataclasses.replace(fcfg, adam=dataclasses.replace(fcfg.adam,
                                                              lr=lr))


def finetune_run(pkg, start, cams, gts, cfg_r, fcfg) -> tuple:
    """(b) ``finetune`` for PAPER_STEPS steps, each step timed (host clock,
    synchronised) with its peak memory, every gradient leaf checked finite
    as ``adam.step`` receives it.  Returns (tuned scene, per-step rows)."""
    import torch
    rows, bad = [], []

    def wrap(label, fn):
        if label == 'adam':
            def checked(params, grads, *a, **kw):
                for name, g in zip(pkg.FIELDS, grads):
                    if not bool(torch.isfinite(g).all()):
                        bad.append((len(rows), name))
                return fn(params, grads, *a, **kw)
            return checked

        def make_timed(*a, **kw):
            step = fn(*a, **kw)

            def timed(*sa, **skw):
                if DEVICE == 'cuda':
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                out = step(*sa, **skw)
                if DEVICE == 'cuda':
                    torch.cuda.synchronize()
                rows.append(dict(
                    ms=(time.perf_counter() - t) * 1e3,
                    peak_bytes=torch.cuda.max_memory_allocated()
                    if DEVICE == 'cuda' else None))
                return out
            return timed
        return make_timed

    with patched([(pkg.finetune, 'make_train_step', 'make_train_step'),
                  (pkg.adam, 'step', 'adam')], wrap):
        tuned, hist = pkg.finetune.finetune(start, cams, gts, fcfg, cfg_r,
                                            PAPER_STEPS, device=DEVICE)
    if bad:
        fail(f'paper (b): non-finite gradients (step, leaf) {bad}')
    for i, (row, m) in enumerate(zip(rows, hist)):
        row.update({k: float(getattr(m, k)) for k in m._fields})
        if not all(torch.isfinite(getattr(m, k)) for k in m._fields):
            fail(f'paper (b): step {i} metrics not finite: {row}')
        print(f'paper (b): step {i:2d} camera {i % len(cams)} '
              f'loss {row["loss"]:.6f} l1 {row["l1"]:.6f} dssim '
              f'{row["dssim"]:.6f} l_scale {row["l_scale"]:.6f} psnr '
              f'{row["psnr"]:.4f} dB  {row["ms"]:.1f} ms  peak '
              f'{row["peak_bytes"]} B', flush=True)
    for p in pkg.finetune.params_of(tuned):
        if not bool(torch.isfinite(p).all()):
            fail('paper (b): the tuned scene is not finite')
    if not rows[-1]['l_scale'] < rows[0]['l_scale']:
        fail(f'paper (b): l_scale did not fall ({rows[0]["l_scale"]} -> '
             f'{rows[-1]["l_scale"]})')
    n = len(cams)
    for j in range(min(n, len(rows) - n)):
        if not rows[j + n]['loss'] < rows[j]['loss']:
            fail(f'paper (b): camera {j} loss did not fall on its second '
                 f'visit ({rows[j]["loss"]} -> {rows[j + n]["loss"]})')
    return tuned, rows


def rc_only_run(pkg, scene, cams, backend: str) -> list:
    """RC-only frames (``use_s2=False``) through ``LuminSys``: per frame
    (hits, image, cache tags, age, clock)."""
    import torch
    cfg = lumina_config(pkg, backend=backend, use_s2=False)
    sys_ = pkg.lp.LuminSys(scene, cfg, cams[0], device=DEVICE)
    out = []
    with torch.no_grad():
        for cam in cams:
            image, st = sys_.step(cam)
            c = sys_.cache
            out.append((round(float(st.hit_rate) * WIDTH * HEIGHT), image,
                        c.tags.clone(), c.age.clone(), c.clock.clone()))
    return out


def rc_quality_check(pkg, label: str, scene, cams, gts) -> dict:
    """(c) RC-only frames of ``scene`` on the kernel backend (launch counts
    set to 0 just before, read just after) and on the reference backend:
    hits and cache state identical, images within 128 ulps; PSNR and SSIM
    against ``gts`` and the hit rate of frames 1.. ."""
    import torch
    pkg.kernels.reset_launches()
    kern = rc_only_run(pkg, scene, cams, 'kernel')
    launches = dict(pkg.kernels.LAUNCHES)
    for name in ('rasterize', 'rasterize_compact', 'rc_lookup'):
        if launches[name] <= 0:
            fail(f'paper (c) {label}: kernel {name} was not launched')
    ref = rc_only_run(pkg, scene, cams, 'reference')
    for i, (k, r) in enumerate(zip(kern, ref)):
        if k[0] != r[0] or not all(torch.equal(x, y)
                                   for x, y in zip(k[2:], r[2:])):
            fail(f'paper (c) {label}: frame {i}: the backends made different '
                 f'cache decisions (hits {k[0]} vs {r[0]})')
        if not ulp_close(k[1], r[1]):
            fail(f'paper (c) {label}: frame {i}: kernel and reference images '
                 f'differ by more than {ULPS} ulps')
    pixels = WIDTH * HEIGHT
    out = dict(psnr_db=[float(pkg.psnr(k[1], g)) for k, g in zip(kern, gts)],
               ssim=[float(pkg.ssim(k[1], g)) for k, g in zip(kern, gts)],
               hit_rate=[k[0] / pixels for k in kern], launches=launches)
    out['mean_psnr_db'] = statistics.mean(out['psnr_db'])
    out['mean_ssim'] = statistics.mean(out['ssim'])
    out['mean_hit_rate_frames_1_on'] = statistics.mean(out['hit_rate'][1:])
    print(f'paper (c) RC-only, {label}: the reference backend made identical '
          f'decisions on all {len(cams)} frames, images within {ULPS} ulps; '
          + json.dumps(out), flush=True)
    return out


def hwmodel_check(pkg, scene, cams, records, cfg) -> dict:
    """(d) The hardware model fed with the main path's frames: the
    baseline's aux, the main path's hit rates, sorts amortised over the
    window.  Its numbers are MODELED for the paper's hardware (mobile
    Volta GPU, LuminCore, GSCore), not times of this card."""
    import math
    hw = pkg.hwmodel
    pixels = WIDTH * HEIGHT
    stats = []
    for i, cam in enumerate(cams):
        _, _, aux, lists = pkg.lp.render_frame_baseline(
            scene, cam, lumina_config(pkg), device=DEVICE)
        stats.append(hw.measure_frame(lists, aux,
                                      hit_rate=records[i][0] / pixels,
                                      sorted_this_frame=1.0 / cfg.window))
    out = {}
    for name, st in (('measured', stats),
                     ('paper_mix', [hw.rescale_to_paper_mix(s) for s in stats])):
        table = hw.evaluate_variants(st, window=cfg.window)
        out[name] = table
        if not all(math.isfinite(x) for row in table.values()
                   for x in row.values()):
            fail(f'paper (d): the {name} variant table is not finite')
        if table['GPU']['speedup'] != 1.0:
            fail(f'paper (d): GPU speedup {table["GPU"]["speedup"]} != 1.0')
        print(f'paper (d): MODELED for the paper\'s hardware (not times of '
              f'this card), stats {name}: ' + json.dumps(
                  {v: {k: float(x) for k, x in row.items()}
                   for v, row in table.items()}), flush=True)
    out['masked_fraction'] = [s.masked_fraction for s in stats]
    out['sig_fraction'] = [s.sig_fraction for s in stats]
    print('paper (d): measured on this run, per frame: ' + json.dumps(
        {k: out[k] for k in ('masked_fraction', 'sig_fraction')}), flush=True)
    sp = {v: m['speedup'] for v, m in out['measured'].items()}
    en = {v: m['norm_energy'] for v, m in out['measured'].items()}
    orderings = {
        "sp['Lumina'] >= sp['S2-Acc'] >= sp['NRU+GPU'] > 1.0":
            sp['Lumina'] >= sp['S2-Acc'] >= sp['NRU+GPU'] > 1.0,
        "sp['Lumina'] > sp['GPU'] == 1.0": sp['Lumina'] > sp['GPU'] == 1.0,
        "sp['RC-GPU'] < sp['NRU+GPU']": sp['RC-GPU'] < sp['NRU+GPU'],
        "en['Lumina'] < en['NRU+GPU'] < 1.0":
            en['Lumina'] < en['NRU+GPU'] < 1.0,
        "0 < sp['GSCore'] < sp['Lumina']": 0 < sp['GSCore'] < sp['Lumina']}
    print('paper (d): orderings of test_hwmodel_orderings on the modeled '
          'table (a finding, not a gate): ' + json.dumps(
              {k: bool(v) for k, v in orderings.items()}),
          flush=True)
    return out


def paper_phase(pkg, scene, cams, records, cfg) -> None:
    """The paper's evaluation on the main path's scene at full width: (a)
    the dense differentiable walk against the chunked walk, (b) fine-tuning
    a copy of the scene with oversized Gaussians, (c) RC-only quality
    before and after, (d) the hardware model on the main path's frames."""
    import torch
    t0 = time.perf_counter()
    dense_walk_check(pkg, scene, cams[0], cfg)
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()
    print(f'paper (a) took {time.perf_counter() - t0:.1f} s', flush=True)

    t0 = time.perf_counter()
    ft_cams = pkg.orbit_trajectory(PAPER_FRAMES, fps=PAPER_FPS, width=WIDTH,
                                   height_px=HEIGHT, device=DEVICE)
    cfg_r = lumina_config(pkg, use_s2=False, use_rc=False)
    gts = [pkg.lp.render_frame_baseline(scene, c, cfg_r, device=DEVICE)[0]
           for c in ft_cams]
    start = pkg.structured_scene(SEED, GAUSSIANS,
                                 large_gaussian_frac=PAPER_LARGE_FRAC,
                                 device=DEVICE)
    tuned, _ = finetune_run(pkg, start, ft_cams, gts, cfg_r,
                            paper_finetune_config(pkg))
    print(f'paper (b) took {time.perf_counter() - t0:.1f} s', flush=True)
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    before = rc_quality_check(pkg, 'before fine-tuning', start, ft_cams, gts)
    after = rc_quality_check(pkg, 'after fine-tuning', tuned, ft_cams, gts)
    print('paper (c): RC-only mean PSNR {:.4f} -> {:.4f} dB, SSIM {:.4f} -> '
          '{:.4f}, hit rate of frames 1-{} {:.4f} -> {:.4f}'.format(
              before['mean_psnr_db'], after['mean_psnr_db'],
              before['mean_ssim'], after['mean_ssim'], PAPER_FRAMES - 1,
              before['mean_hit_rate_frames_1_on'],
              after['mean_hit_rate_frames_1_on']), flush=True)
    print(f'paper (c) took {time.perf_counter() - t0:.1f} s', flush=True)
    del start, tuned, gts
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hwmodel_check(pkg, scene, cams, records, cfg)
    print(f'paper (d) took {time.perf_counter() - t0:.1f} s', flush=True)


def serve_sessions(pkg, viewers_per_scene: int,
                   start_deg: float = 0.0) -> list:
    """VIEWERS sessions of FRAMES frames arriving STAGGER ticks apart; the
    viewers of a scene ride one orbit, and the scenes' orbits start 90 deg
    apart, from ``start_deg``."""
    orbits = {}
    sessions = []
    for sid in range(VIEWERS):
        scene_id = sid // viewers_per_scene
        if scene_id not in orbits:
            orbits[scene_id] = pkg.orbit_trajectory(
                FRAMES, width=WIDTH, height_px=HEIGHT,
                start_deg=90.0 * scene_id + start_deg, device=DEVICE)
        sessions.append(pkg.serve.ViewerSession(
            sid=sid, cams=orbits[scene_id], arrival_tick=sid * STAGGER,
            scene_id=scene_id))
    return sessions


def serve_run(pkg, scene, backend: str, viewers_per_scene: int, *,
              check=None, capture=None, targets=None) -> dict:
    """Serve the sessions through ``SessionManager`` + ``SyncDriver`` on one
    backend.  Every frame's image, hit count and sorted flag, and the
    cache's tags/age/clock after every tick, are recorded, or handed to
    ``check(tick, slot_frames, cache)``.  ``capture``, a dict, receives the
    arguments of each serving kernel's first call at CAPTURE_TICK, keyed by
    the kernel's name (``targets``: other ``patched`` targets to capture).
    The launch counts are set to 0 just before the run and read just
    after."""
    import torch
    cfg = lumina_config(pkg, backend=backend)
    sessions = serve_sessions(pkg, viewers_per_scene)
    stepper = pkg.serve.BatchedStepper(
        scene, cfg, sessions[0].cams[0], VIEWERS,
        profile_every=PROFILE_EVERY if backend == 'kernel' else 0,
        viewers_per_scene=viewers_per_scene, device=DEVICE)
    mgr = pkg.serve.SessionManager(stepper, VIEWERS)
    for sess in sessions:
        mgr.submit(sess)
    pixels = stepper.tiles_x * stepper.tiles_y * 256
    run = {'frames': {}, 'caches': {}}
    finish = stepper.step_finish

    def recording_finish(infl):
        tick = stepper.global_tick - 1
        out = finish(infl)
        frames = {slot: (img, round(float(st.hit_rate) * pixels),
                         float(st.sorted_this_frame))
                  for slot, (img, st, _) in out.items()}
        c = stepper.shared.cache
        cache = (c.tags.clone(), c.age.clone(), c.clock.clone())
        if check is None:
            run['frames'].update({(tick, s): f for s, f in frames.items()})
            run['caches'][tick] = cache
        else:
            check(tick, frames, cache)
        return out

    stepper.step_finish = recording_finish

    def wrap(label, fn):
        def recorder(*args, **kwargs):
            if stepper.global_tick == CAPTURE_TICK and label not in capture:
                capture[label] = (args, kwargs)
            return fn(*args, **kwargs)
        return recorder

    if targets is None:
        targets = [] if capture is None else [
            *serve_kernels(pkg),
            (pkg.ops, 'rasterize_resume_compacted_slots', 'resume')]
    pkg.kernels.reset_launches()
    t0 = time.perf_counter()
    with patched(targets, wrap):
        finished = mgr.run(driver='sync')
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    run.update(wall_s=time.perf_counter() - t0,
               launches=dict(pkg.kernels.LAUNCHES), mgr=mgr, stepper=stepper,
               finished=sorted(finished, key=lambda s: s.sid))
    return run


def serve_summary(pkg, label: str, run: dict) -> dict:
    """Print the serving numbers of one kernel-backend run."""
    import numpy as np
    mgr, stepper = run['mgr'], run['stepper']
    log = mgr.tick_log
    lat = sorted(t['latency_ms'] for t in log if t['tick'] > 0)
    summaries = [s.telemetry.summary() for s in run['finished']]
    agg = pkg.serve.aggregate(summaries)
    due = int(sum(sum(s.telemetry.sorted_flags) for s in run['finished']))
    executed = sum(e['scheduled'] + e['admit'] for e in stepper.sort_log)
    saved = [f for s in run['finished'] for f in s.telemetry.saved_fracs]
    steady = next((t['kernel_ms'] for t in log
                   if t['tick'] == PROFILE_EVERY and t.get('kernel_ms')), None)
    last = log[-1]
    out = dict(ticks=mgr.tick, frames=agg['frames'],
               # with this few ticks the largest is the nearest-rank p95
               ticks_timed=len(lat), tick_ms_median=float(np.median(lat)),
               tick_ms_max=lat[-1], viewer_fps=agg['fleet_fps'],
               sorts_executed=executed, sorts_due=due,
               hit_rate=agg['mean_hit_rate'],
               saved_frac=float(np.mean(saved)),
               occupancy=float(last['occupancy']),
               state_bytes=max(t['state_bytes'] for t in log),
               state_alloc_bytes=max(t['state_alloc_bytes'] for t in log),
               stage_ms_tick10=steady, wall_s=run['wall_s'],
               launches=run['launches'])
    print(f'serve {label}: ' + json.dumps(out), flush=True)
    return out


def serve_phase(pkg, scene) -> tuple:
    """Both serving modes on both backends; returns (the launch counts of
    the shared kernel run, the serving kernels' inputs captured in it, the
    shared kernel run's records: every tick's frames and cache, its sort
    log and tick latencies, the oracle of ``realtime_phase``)."""
    import torch
    eps = torch.finfo(torch.float32).eps
    capture = {}
    shared_launches = shared = None
    for label, vps in (('private', 1), ('shared', VIEWERS)):
        run = serve_run(pkg, scene, 'kernel', vps,
                        capture=capture if vps > 1 else None)
        for name in ('rasterize_slots', 'rasterize_compact', 'rc_lookup'):
            if run['launches'][name] <= 0:
                fail(f'serve {label}: kernel {name} was not launched by the '
                     f'serving path')
        if vps > 1:
            shared_launches = run['launches']
        for (tick, slot), (img, _, _) in run['frames'].items():
            if tuple(img.shape) != (HEIGHT, WIDTH, 3) or \
                    not bool(torch.isfinite(img).all()):
                fail(f'serve {label}: tick {tick} slot {slot} image is '
                     f'{tuple(img.shape)} or not finite')
        serve_summary(pkg, label, run)
        worst = [0.0, 0.0]

        def check(tick, frames, cache, run=run, label=label, worst=worst):
            for slot, (img, hits, flag) in frames.items():
                want = run['frames'].get((tick, slot))
                if want is None or (hits, flag) != want[1:]:
                    fail(f'serve {label}: tick {tick} slot {slot}: reference '
                         f'(hits, sorted) {(hits, flag)} != kernel '
                         f'{None if want is None else want[1:]}')
                if not ulp_close(want[0], img):
                    fail(f'serve {label}: tick {tick} slot {slot}: images '
                         f'differ by more than {ULPS} ulps')
                diff = (want[0] - img).abs()
                scale = torch.clamp(torch.maximum(want[0].abs(), img.abs()),
                                    min=1.0)
                worst[0] = max(worst[0], float(diff.max()))
                worst[1] = max(worst[1], float((diff / (eps * scale)).max()))
            for name, x, y in zip(('tags', 'age', 'clock'), cache,
                                  run['caches'][tick]):
                if not bool(torch.equal(x, y)):
                    fail(f'serve {label}: tick {tick}: cache {name} differs '
                         f'between the backends')

        ref = serve_run(pkg, scene, 'reference', vps, check=check)
        if ref['stepper'].sort_log != run['stepper'].sort_log:
            fail(f'serve {label}: the backends logged different sorts')
        print(f'serve {label}: reference backend made identical decisions on '
              f'all {ref["mgr"].tick} ticks ({len(run["frames"])} frames, '
              f'sort_log {json.dumps(run["stepper"].sort_log)}); images '
              f'within {ULPS} ulps (largest difference {worst[0]!r}, '
              f'{worst[1]!r} ulps x magnitude); reference run took '
              f'{ref["wall_s"]:.1f} s', flush=True)
        if vps == 1:
            single_viewer_oracle(pkg, scene, run)
        else:
            shared = dict(
                frames=run['frames'], caches=run['caches'],
                log=dict(enumerate(run['stepper'].sort_log)),
                lat=sorted(t['latency_ms'] for t in run['mgr'].tick_log
                           if t['tick'] > 0))
        del run, ref
        if DEVICE == 'cuda':
            torch.cuda.empty_cache()
    for name in [label for _, _, label in serve_kernels(pkg)] + ['resume']:
        if name not in capture:
            fail(f'{name} was not called at tick {CAPTURE_TICK}')
    return shared_launches, capture, shared


def single_viewer_oracle(pkg, scene, run) -> None:
    """Slot 0 (admitted at tick 0) against ``LuminSys`` on its cameras."""
    import torch
    cams = run['finished'][0].cams
    sys_ = pkg.lp.LuminSys(scene, lumina_config(pkg, backend='kernel'),
                           cams[0], device=DEVICE)
    pixels = run['stepper'].tiles_x * run['stepper'].tiles_y * 256
    for f, cam in enumerate(cams):
        image, st = sys_.step(cam)
        img, hits, flag = run['frames'][(f, 0)]
        got = (round(float(st.hit_rate) * pixels),
               float(st.sorted_this_frame))
        if got != (hits, flag):
            fail(f'serve private: slot 0 frame {f}: LuminSys (hits, sorted) '
                 f'{got} != {(hits, flag)}')
        if not ulp_close(image, img):
            fail(f'serve private: slot 0 frame {f}: images differ from '
                 f'LuminSys by more than {ULPS} ulps')
    c = sys_.cache
    tags, age, clock = run['caches'][len(cams) - 1]
    if not (torch.equal(c.tags, tags[0]) and torch.equal(c.age, age[0])
            and torch.equal(c.clock, clock[0])):
        fail('serve private: slot 0 cache differs from LuminSys')
    print(f'serve private: slot 0 equals LuminSys(backend="kernel") on all '
          f'{len(cams)} frames (hits, sorted flags, images, cache)',
          flush=True)


def serve_kernel_rows(pkg, capture, launches: dict, chunk: int) -> tuple:
    """Each serving kernel against its plain version at the shapes the
    shared run gave it: the rasterize_slots row, and the rasterize_compact
    and rc_lookup rows at serving shapes."""
    slots = slots_kernel_row(pkg, capture['rasterize_slots'],
                             launches['rasterize_slots'], chunk)
    compact = compact_row(pkg.rk, capture['rasterize_compact'],
                          launches['rasterize_compact'], chunk, plain_reps=1,
                          label='rasterize_compact[serve]')
    resume_route_check(pkg, pkg.ops.rasterize_resume_compacted_slots,
                       capture['resume'], 'ops.rasterize_resume_compacted_slots')
    lookup = rc_lookup_row(pkg, capture['rc_lookup'],
                           launches['rc_lookup'], label='rc_lookup[serve]')
    return slots, compact, lookup


def slots_kernel_row(pkg, call, launches: int, chunk: int) -> dict:
    """rasterize_slots against its plain version on the captured inputs."""
    import torch
    rk = pkg.rk
    args, kw = call
    got = rk.rasterize_slots(*args, **kw)
    want = rk.rasterize_slots_plain(*args, **kw)
    err = check_raster('rasterize_slots', got, want)
    # what the walked (slot, tile) blocks read: each slot's own trip count,
    # from the single-slot kernel on the same inputs; their max per tile
    # must be the shared count (the argument of the kernel's source note)
    mean2d, conic, color, opacity, ids, acc0, trans0, rec0, cnt0, live, ncap = args
    per_slot = torch.stack([rk.rasterize(
        mean2d[i], conic[i], color[i], opacity[i], ids[i], acc0[i], trans0[i],
        rec0[i], cnt0[i], torch.zeros_like(cnt0[i]), live[i], ncap[i],
        **kw).chunks[:, 0] for i in range(ids.shape[0])])
    if not bool((per_slot.amax(0) == got.chunks[:, 0]).all()):
        fail('rasterize_slots: chunks is not the max of the per-slot counts')
    counts = [pair_counts(rk, [x[i] for x in args[:5]], per_slot[i],
                          got.n_iter[i], chunk, kw['tiles_x'])
              for i in range(ids.shape[0])]
    pairs = {key: sum(c[key] for c in counts) for key in counts[0]}
    print_pairs('rasterize_slots', pairs)
    ms = time_ms(lambda: rk.rasterize_slots(*args, **kw), 20)
    plain_ms = time_ms(lambda: rk.rasterize_slots_plain(*args, **kw), 1)
    bound_ms, bound_by = raster_bound(got, chunk, int(per_slot.sum()),
                                      got.trans.numel(), 0)
    live_slots = int((live != 0).flatten(1).any(1).sum())
    print(f'kernel rasterize_slots: exact ints and chunks, max_abs_err {err}; '
          f'{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms '
          f'({bound_by}); {live_slots} live slots, shared trip count '
          f'{int(got.chunks.sum())} chunks over {got.chunks.numel()} tiles, '
          f'per-slot blocks walked {int(per_slot.sum())} chunks', flush=True)
    return dict(name='rasterize_slots', route='cuda',
                source='src/repro_torch/kernels/csrc/rasterize.cu',
                replaces='src/repro/kernels/rasterize.py:510',
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def oversub_sessions(pkg) -> list:
    """STATE_VIEWERS pace-2 sessions, all arriving at tick 0, each on its
    own orbit (85 deg apart, so in its own pose cell), all on one scene."""
    return [pkg.serve.ViewerSession(
        sid=i, cams=pkg.orbit_trajectory(STATE_FRAMES, width=WIDTH,
                                         height_px=HEIGHT,
                                         start_deg=85.0 * i + 7.0,
                                         device=DEVICE), pace=2)
            for i in range(STATE_VIEWERS)]


def state_manager(pkg, scene, backend: str, *, slots: int = VIEWERS,
                  viewers_per_scene: int = VIEWERS, streaming=None,
                  **mgr_kw) -> tuple:
    """A ``BatchedStepper`` of one scene block (streamed through
    ``streaming`` when given) and its ``SessionManager``."""
    cam0 = pkg.orbit_trajectory(1, width=WIDTH, height_px=HEIGHT,
                                device=DEVICE)[0]
    stepper = pkg.serve.BatchedStepper(
        scene, lumina_config(pkg, backend=backend), cam0, slots,
        viewers_per_scene=viewers_per_scene, streaming=streaming,
        device=DEVICE)
    return pkg.serve.SessionManager(stepper, slots, **mgr_kw), stepper


def record_ticks(mgr, stepper) -> dict:
    """Record every tick: each slot's (image, hits, sorted flag), the sort
    log entry and the cache's tags/age/clock, keyed by the stepper's global
    tick (which a restore carries over), and the lane swaps keyed by the
    manager's tick."""
    pixels = stepper.tiles_x * stepper.tiles_y * 256
    rec = {'frames': {}, 'log': {}, 'caches': {}, 'switches': {}}
    finish, apply = stepper.step_finish, mgr.apply_plan

    def recording_finish(infl):
        tick = stepper.global_tick - 1
        out = finish(infl)
        rec['frames'].update({
            (tick, slot): (img, round(float(st.hit_rate) * pixels),
                           float(st.sorted_this_frame))
            for slot, (img, st, _) in out.items()})
        rec['log'][tick] = dict(stepper.sort_log[-1])
        c = stepper.shared.cache
        rec['caches'][tick] = (c.tags.clone(), c.age.clone(), c.clock.clone())
        return out

    def recording_apply(plan):
        rec['switches'][plan.tick] = plan.switches
        apply(plan)

    stepper.step_finish = recording_finish
    mgr.apply_plan = recording_apply
    return rec


def drive(mgr, limit: int, until: int | None = None) -> float:
    """The sync driver's loop (tick, evict, checkpoint) until the manager
    drains or reaches tick ``until``; returns its wall seconds."""
    import torch
    t0 = time.perf_counter()
    while not mgr.drained() and (until is None or mgr.tick < until):
        mgr.run_tick()
        mgr.evict_finished()
        mgr.maybe_checkpoint()
        if mgr.tick > limit:
            fail(f'serving run did not drain in {limit} ticks')
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def compare_records(label: str, want: dict, got: dict, *, exact: bool,
                    ticks=None,
                    parts=('log', 'caches', 'switches')) -> tuple:
    """Hold ``got`` against ``want`` on every recorded tick (from tick
    ``ticks`` on, when given): hits, sorted flags and the ``parts`` (sort
    log, cache, lane swaps) identical; images ``torch.equal`` when
    ``exact``, else within ULPS.  Returns the largest image difference
    (absolute, ulps)."""
    import torch
    eps = torch.finfo(torch.float32).eps
    start = -1 if ticks is None else ticks
    keep = {k: v for k, v in want['frames'].items() if k[0] >= start}
    if sorted(got['frames']) != sorted(keep):
        fail(f'{label}: rendered (tick, slot) pairs differ')
    worst = [0.0, 0.0]
    for key, (img, hits, flag) in keep.items():
        g = got['frames'][key]
        if (g[1], g[2]) != (hits, flag):
            fail(f'{label}: tick {key[0]} slot {key[1]}: (hits, sorted) '
                 f'{(g[1], g[2])} != {(hits, flag)}')
        if exact and not bool(torch.equal(g[0], img)):
            fail(f'{label}: tick {key[0]} slot {key[1]}: images differ')
        if not ulp_close(g[0], img):
            fail(f'{label}: tick {key[0]} slot {key[1]}: images differ by '
                 f'more than {ULPS} ulps')
        diff = (g[0] - img).abs()
        scale = torch.clamp(torch.maximum(g[0].abs(), img.abs()), min=1.0)
        worst[0] = max(worst[0], float(diff.max()))
        worst[1] = max(worst[1], float((diff / (eps * scale)).max()))
    for part in parts:
        keep = {t: v for t, v in want[part].items() if t >= start}
        if sorted(got[part]) != sorted(keep):
            fail(f'{label}: {part} recorded on different ticks')
        for t, v in keep.items():
            same = (all(bool(torch.equal(x, y))
                        for x, y in zip(v, got[part][t]))
                    if part == 'caches' else v == got[part][t])
            if not same:
                fail(f'{label}: tick {t}: {part} differ')
    return tuple(worst)


def check_launched(label: str, launches: dict) -> None:
    for name in ('rasterize_slots', 'rasterize_compact', 'rc_lookup'):
        if launches[name] <= 0:
            fail(f'{label}: kernel {name} was not launched')


def serve_state_phase(pkg, scene) -> tuple:
    """(a) oversubscription, (b) kill and restore, (c) faults; see the
    module docstring.  Returns the printed numbers and the kernel faults
    run's records (the oracle of ``realtime_phase`` (b))."""
    import torch
    out = {}
    # (a) oversubscribed, both backends
    runs = {}
    for backend in ('kernel', 'reference'):
        mgr, stepper = state_manager(pkg, scene, backend, oversubscribe=True)
        rec = record_ticks(mgr, stepper)
        for sess in oversub_sessions(pkg):
            mgr.submit(sess)
        pkg.kernels.reset_launches()
        wall = drive(mgr, 2 * STATE_FRAMES + 4)
        launches = dict(pkg.kernels.LAUNCHES)
        done = sorted(s.sid for s in mgr.finished)
        if done != list(range(STATE_VIEWERS)) or any(
                s.telemetry.frames != STATE_FRAMES for s in mgr.finished):
            fail(f'oversub {backend}: finished {done} with frames '
                 f'{[s.telemetry.frames for s in mgr.finished]}')
        for (tick, slot), (img, _, _) in rec['frames'].items():
            if tuple(img.shape) != (HEIGHT, WIDTH, 3) or \
                    not bool(torch.isfinite(img).all()):
                fail(f'oversub {backend}: tick {tick} slot {slot} image is '
                     f'{tuple(img.shape)} or not finite')
        oversub = mgr.metrics['serve.oversubscribed'].value
        if oversub <= 0:
            fail(f'oversub {backend}: no session was co-placed')
        runs[backend] = dict(rec=rec, ticks=mgr.tick, wall=wall,
                             log=list(stepper.sort_log), oversub=oversub,
                             lat=sorted(t['latency_ms'] for t in mgr.tick_log
                                        if t['tick'] > 0),
                             launches=launches)
        if backend == 'kernel':
            check_launched('oversub', launches)
            golden_cache = [x.clone() for x in (
                stepper.shared.cache.tags, stepper.shared.cache.age,
                stepper.shared.cache.clock)]
        del mgr, stepper
    worst = compare_records('oversub reference', runs['kernel']['rec'],
                            runs['reference']['rec'], exact=False)
    if runs['kernel']['log'] != runs['reference']['log']:
        fail('oversub: the backends logged different sorts')
    k = runs['kernel']
    out['oversub'] = dict(ticks=k['ticks'],
                          frames=STATE_VIEWERS * STATE_FRAMES,
                          oversubscribed=k['oversub'],
                          tick_ms_median=statistics.median(k['lat']),
                          tick_ms_max=k['lat'][-1], wall_s=k['wall'],
                          reference_wall_s=runs['reference']['wall'],
                          launches=k['launches'])
    print(f'serve_state oversub: {STATE_VIEWERS} pace-2 viewers x '
          f'{STATE_FRAMES} frames on {VIEWERS} slots in {k["ticks"]} ticks '
          f'(limit {2 * STATE_FRAMES + 4}); serve.oversubscribed '
          f'{k["oversub"]}; reference backend identical on every tick (lane '
          f'swaps, hits, sorted flags, sort_log, cache), images within '
          f'{ULPS} ulps (largest difference {worst[0]!r}, {worst[1]!r} '
          f'ulps x magnitude): ' + json.dumps(out['oversub']), flush=True)
    golden = runs['kernel']['rec']
    del runs
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    # (b) kill at KILL_TICK, restore, continue
    ckdir = HERE / 'build' / 'serve_state_ckpt'
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr, stepper = state_manager(pkg, scene, 'kernel', oversubscribe=True)
    ckpt = pkg.ckpt.CheckpointManager(ckdir, keep=3)
    mgr.enable_checkpoints(ckpt, every=CKPT_EVERY)
    for sess in oversub_sessions(pkg):
        mgr.submit(sess)
    saves, writes = [], []
    save = ckpt.save

    def timed_save(tree, **kw):
        # save() first waits for the previous save's write (at most one in
        # flight): time that wait apart from the copy to the host
        t0 = time.perf_counter()
        ckpt.wait()
        t1 = time.perf_counter()
        save(tree, **kw)
        saves.append((kw['step'], (t1 - t0) * 1e3,
                      (time.perf_counter() - t1) * 1e3))

    def wrap(label, fn):
        def timed_write(path, names, arrays, **kw):
            t = time.perf_counter()
            res = fn(path, names, arrays, **kw)
            writes.append((kw['step'], sum(a.nbytes for a in arrays),
                           time.perf_counter() - t))
            return res
        return timed_write

    ckpt.save = timed_save
    with patched([(pkg.ckpt, '_write', 'write')], wrap):
        drive(mgr, 2 * STATE_FRAMES + 4, until=KILL_TICK)
        if mgr.drained():
            fail('checkpoint: the kill must land mid-run')
        ckpt.wait()
    extra = ckpt.manifest_extra(KILL_TICK - 1)
    if extra is None or not extra['stepper']['stash'] \
            or extra['stepper']['pool_cap'] <= 1:
        fail(f'checkpoint at tick {KILL_TICK - 1} holds no stashed lane or '
             f'grown pool')
    del mgr
    stepper.reset()
    mgr = pkg.serve.SessionManager(stepper, VIEWERS, oversubscribe=True)
    rec = record_ticks(mgr, stepper)
    t = time.perf_counter()
    restored = mgr.restore_serving(pkg.ckpt.CheckpointManager(ckdir),
                                   oversub_sessions(pkg))
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if restored != KILL_TICK - 1:
        fail(f'restore_serving returned {restored}, not {KILL_TICK - 1}')
    pkg.kernels.reset_launches()
    drive(mgr, 2 * STATE_FRAMES + 4)
    launches = dict(pkg.kernels.LAUNCHES)
    check_launched('restored run', launches)
    compare_records('restored run', golden, rec, exact=True, ticks=restored)
    c = stepper.shared.cache
    if not all(bool(torch.equal(x, y)) for x, y in
               zip((c.tags, c.age, c.clock), golden_cache)):
        fail('restored run: final cache differs from the uninterrupted run')
    shutil.rmtree(ckdir)
    out['checkpoint'] = dict(
        restored=restored, bytes=writes[-1][1],
        save_wait_ms=[round(w, 3) for _, w, _ in saves],
        save_ms=[round(ms, 3) for _, _, ms in saves],
        write_s=[round(s_, 3) for _, _, s_ in writes], restore_s=restore_s,
        launches=launches)
    print(f'serve_state checkpoint: killed at tick {KILL_TICK}, restored '
          f'tick {restored} with a stash and pool capacity '
          f'{extra["stepper"]["pool_cap"]}; continuation equals the '
          f'uninterrupted run bit for bit (images, hits, sorted flags, '
          f'sort_log, cache): ' + json.dumps(out['checkpoint']), flush=True)
    del mgr, stepper, golden, rec
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    # (c) faults, both backends
    F = pkg.faults
    trace = F.FaultTrace(seed=0, events=tuple(
        F.FaultEvent(tick=t, kind=kind, **kw) for kind, t, kw in FAULT_EVENTS))
    fault_runs = {}
    for backend in ('kernel', 'reference'):
        inj = F.FaultInjector(trace)
        mgr, stepper = state_manager(pkg, scene, backend, injector=inj)
        rec = record_ticks(mgr, stepper)
        for sess in serve_sessions(pkg, VIEWERS):
            mgr.submit(sess)
        pkg.kernels.reset_launches()
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', RuntimeWarning)
            drive(mgr, 4 * FRAMES + VIEWERS * STAGGER)
        launches = dict(pkg.kernels.LAUNCHES)
        if backend == 'kernel':
            check_launched('faults', launches)
        if sorted(s.sid for s in mgr.finished) != list(range(VIEWERS)) or \
                any(s.telemetry.frames != FRAMES for s in mgr.finished):
            fail(f'faults {backend}: the run did not finish every frame')
        fired = inj.fired_counts()
        if fired != trace.counts() or inj.outstanding():
            fail(f'faults {backend}: fired {fired}, outstanding '
                 f'{inj.outstanding()}')
        counted = {key[len('serve.faults{kind='):-1]: mgr.metrics[key].value
                   for key in mgr.metrics.names()
                   if key.startswith('serve.faults{')}
        if counted != fired:
            fail(f'faults {backend}: counters {counted} != fired {fired}')
        quarantined = mgr.metrics['serve.quarantined'].value
        if quarantined != fired['nan_poison']:
            fail(f'faults {backend}: {quarantined} quarantined')
        if not bool(torch.isfinite(stepper.shared.cache.values).all()):
            fail(f'faults {backend}: non-finite values in the cache')
        fault_runs[backend] = dict(
            rec=rec, ticks=mgr.tick, fired=fired, quarantined=quarantined,
            degraded=mgr.metrics['serve.degraded_ticks'].value,
            retries=mgr.metrics['serve.retries'].value, launches=launches)
        del mgr, stepper
    worst = compare_records('faults reference', fault_runs['kernel']['rec'],
                            fault_runs['reference']['rec'], exact=False)
    k = fault_runs['kernel']
    fault_rec = k['rec']
    out['faults'] = {key: k[key] for key in ('ticks', 'fired', 'quarantined',
                                             'degraded', 'retries',
                                             'launches')}
    print(f'serve_state faults: both backends drained with identical '
          f'decisions (largest image difference {worst[0]!r}, {worst[1]!r} '
          f'ulps x magnitude); counters equal the fired events: '
          + json.dumps(out['faults']), flush=True)
    del fault_runs
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    nan_camera_check(pkg, scene)
    return out, fault_rec


def nan_camera_check(pkg, scene) -> None:
    """A NaN camera through the real shade of one private slot, after one
    finite frame, on both backends (``tests/test_chaos.py``'s check at full
    width).  Both caches must stay finite.  The backends differ on NaN input
    as the JAX package's do (``tests/test_torch_faults.py`` holds each
    against its JAX counterpart): the reference's raw colors are NaN, so
    its insert gate keeps every miss out, while the kernel path skips the
    non-significant pairs and shades a miss black, which it inserts under
    the all -1 record.  So: the same hits and clock; the reference's tags
    unchanged by the NaN frame; every slot where the backends' tags differ
    holds the all -1 record and black in the kernel's cache; everywhere
    else identical tags and ages and values within ULPS."""
    import torch
    cams = pkg.orbit_trajectory(2, width=WIDTH, height_px=HEIGHT,
                                device=DEVICE)
    got = {}
    for backend in ('kernel', 'reference'):
        _, stepper = state_manager(pkg, scene, backend, slots=1,
                                   viewers_per_scene=1)
        stepper.admit(0)
        stepper.step({0: cams[0]})
        before = stepper.shared.cache.tags.clone()
        _, st, _ = stepper.step({0: pkg.faults.poison_camera(cams[1])})[0]
        c = stepper.shared.cache
        if not bool(torch.isfinite(c.values).all()):
            fail(f'NaN camera ({backend}): non-finite values in the cache')
        got[backend] = (c, before, float(st.hit_rate))
        del stepper
    (k, _, k_hit), (r, r_before, r_hit) = got['kernel'], got['reference']
    if k_hit != r_hit or not torch.equal(k.clock, r.clock):
        fail(f'NaN camera: hit rates {k_hit} / {r_hit} or clocks differ')
    if not torch.equal(r.tags, r_before):
        fail('NaN camera: the reference backend inserted a NaN frame miss')
    moved = (k.tags != r.tags).any(-1)
    if not (bool((k.tags[moved] == -1).all())
            and bool((k.values[moved] == 0).all())):
        fail('NaN camera: the kernel backend inserted other than black '
             'under the all -1 record')
    same = ~moved
    if not (torch.equal(k.tags[same], r.tags[same])
            and torch.equal(k.age[same], r.age[same])
            and ulp_close(k.values[same], r.values[same])):
        fail('NaN camera: the backends differ outside the black inserts')
    print(f'serve_state NaN camera: both caches finite; hit rate {k_hit!r} '
          f'on both; {int(moved.sum())} slots hold the kernel backend\'s '
          f'black all -1 insert, every other slot identical (values within '
          f'{ULPS} ulps)', flush=True)


def timed_dispatch(stepper, spans: list, syncs: dict) -> None:
    """Wrap the stepper's ``step_dispatch``/``step_finish``: ``spans`` gets
    each tick's (global tick, dispatch returned, finish returned) host
    times, and the dispatch at CAPTURE_TICK runs under
    ``torch.cuda.set_sync_debug_mode('warn')``, its synchronising calls
    counted into ``syncs`` by source line."""
    import torch
    dispatch, finish = stepper.step_dispatch, stepper.step_finish
    state = {}

    def timed_dispatch_call(cams, plan=None):
        tick = stepper.global_tick
        if tick == CAPTURE_TICK and DEVICE == 'cuda':
            torch.cuda.set_sync_debug_mode('warn')
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter('always')
                    out = dispatch(cams, plan)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            for w in caught:
                if 'synchroniz' in str(w.message):
                    key = f'{pathlib.Path(w.filename).name}:{w.lineno}'
                    syncs[key] = syncs.get(key, 0) + 1
        else:
            out = dispatch(cams, plan)
        state['tick'], state['t'] = tick, time.perf_counter()
        return out

    def timed_finish(infl):
        out = finish(infl)
        if infl is not None:
            spans.append((state['tick'], state['t'], time.perf_counter()))
        return out

    stepper.step_dispatch, stepper.step_finish = timed_dispatch_call, \
        timed_finish


def realtime_run(pkg, scene, *, driver: str, streaming=None, tracer=None,
                 injector=None, start_deg: float = 0.0) -> dict:
    """The shared run (VIEWERS sessions on one scene block) under
    ``driver`` on the kernel backend, every tick recorded
    (``record_ticks``), dispatch and finish timed (``timed_dispatch``); the
    launch counts are set to 0 just before and read just after."""
    import torch
    kw = {}
    if injector is not None:
        kw = dict(injector=injector, watchdog_s=REALTIME_WATCHDOG_S)
    mgr, stepper = state_manager(pkg, scene, 'kernel', streaming=streaming,
                                 tracer=tracer, **kw)
    rec = record_ticks(mgr, stepper)
    spans, syncs = [], {}
    timed_dispatch(stepper, spans, syncs)
    for sess in serve_sessions(pkg, VIEWERS, start_deg=start_deg):
        mgr.submit(sess)
    pkg.kernels.reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        finished = mgr.run(driver=driver, max_ticks=4 * FRAMES + 20)
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pkg.kernels.LAUNCHES)
    if sorted(s.sid for s in finished) != list(range(VIEWERS)) or any(
            s.cursor != FRAMES for s in finished):
        fail(f'realtime {driver}: not every frame was rendered')
    return dict(rec=rec, mgr=mgr, stepper=stepper, launches=launches,
                wall_s=wall, syncs=syncs,
                finish_ms=[round((t2 - t1) * 1e3, 3)
                           for _, t1, t2 in spans],
                lat=sorted(t['latency_ms'] for t in mgr.tick_log
                           if t['tick'] > 0))


def realtime_phase(pkg, scene, shared: dict, fault_rec: dict) -> dict:
    """(a) the shared run under ``ThreadedDriver``, held tick by tick
    against the sync run of ``serve_phase`` (``shared``) bit for bit, with
    its trace written and checked, and timed beside the same run under
    ``SyncDriver`` with the same instrumentation (tracer, records, no
    profiled ticks); (b) the faults run under the threaded
    driver with a worker death and a worker plan_exc more, held against the
    sync faults run (``fault_rec``); (c) the shared run streamed through an
    unbounded arena (sync driver) and a budgeted one (threaded driver),
    bit-identical.  Returns the printed numbers."""
    import torch
    out = {}
    # (a) sync, then threaded, both traced
    sync = realtime_run(pkg, scene, driver='sync', tracer=pkg.obs.Tracer())
    check_launched('realtime sync', sync['launches'])
    compare_records('realtime sync', shared, sync['rec'], exact=True,
                    parts=('log', 'caches'))
    tracer = pkg.obs.Tracer()
    run = realtime_run(pkg, scene, driver='threaded', tracer=tracer)
    check_launched('realtime threaded', run['launches'])
    compare_records('realtime threaded', shared, run['rec'], exact=True,
                    parts=('log', 'caches'))
    mgr = run['mgr']
    if mgr.tick != max(shared['log']) + 1:
        fail(f'realtime threaded: {mgr.tick} ticks, the sync run took '
             f'{max(shared["log"]) + 1}')
    if 'serve.thread_leaks' in mgr.metrics:
        fail('realtime threaded: a planner thread leaked')
    roll = pkg.serve.tick_rollup(mgr.tick_log, warmup_ticks=1)
    path = HERE / 'build' / 'realtime_trace.json'
    path.parent.mkdir(exist_ok=True)
    payload = pkg.obs.write_trace(str(path), tracer)
    events = pkg.obs.validate_chrome_trace(
        json.loads(path.read_text()))
    lanes = {e['tid']: e['args']['name'] for e in events
             if e['ph'] == 'M' and e['name'] == 'thread_name'}
    per_track = collections.Counter(lanes[e['tid']] for e in events
                                    if e['ph'] != 'M')
    worker = [w for w in pkg.obs.track_spans(payload, 'host-worker')
              if w[2] == 'plan_tick']
    shades = [d for d in pkg.obs.track_spans(payload, 'device')
              if d[2] == 'shade']
    overlapped = sorted({d[3]['tick'] for d in shades for w in worker
                         if max(w[0], d[0]) < min(w[1], d[1])})
    if not worker or not shades:
        fail('realtime threaded: the trace holds no worker plan or no '
             'device shade span')
    out['threaded'] = dict(
        ticks=mgr.tick, tick_ms_median=statistics.median(run['lat']),
        tick_ms_max=run['lat'][-1],
        sync_tick_ms_median=statistics.median(sync['lat']),
        sync_tick_ms_max=sync['lat'][-1],
        serve_phase_tick_ms_median=statistics.median(shared['lat']),
        wall_s=run['wall_s'], sync_wall_s=sync['wall_s'],
        sync_host_ms_mean=pkg.serve.tick_rollup(
            sync['mgr'].tick_log, warmup_ticks=1).get('host_ms'),
        host_ms=[round(t['host_ms'], 4) for t in mgr.tick_log],
        overlap_ms=[round(t['overlap_ms'], 4) for t in mgr.tick_log],
        host_ms_mean=roll.get('host_ms'),
        host_overlap=roll.get('host_overlap'),
        ticks_worker_plan_over_shade=len(overlapped),
        dispatch_to_finish_ms=run['finish_ms'],
        dispatch_syncs_tick=CAPTURE_TICK,
        dispatch_syncs=sum(run['syncs'].values()),
        dispatch_sync_sites=run['syncs'],
        trace_events=dict(per_track), trace_path=str(path.relative_to(HERE)),
        launches=run['launches'])
    print(f'realtime threaded: {VIEWERS} viewers x {FRAMES} frames under '
          f'ThreadedDriver equal the sync run of serve_phase bit for bit on '
          f'every tick (images, hits, sorted flags, sort_log, cache); trace '
          f'valid: ' + json.dumps(out['threaded']), flush=True)
    del run, sync, mgr, tracer, payload, events
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    # (b) threaded under faults
    F = pkg.faults
    trace = F.FaultTrace(seed=0, events=tuple(
        F.FaultEvent(tick=t, kind=kind, **kw)
        for kind, t, kw in REALTIME_FAULTS))
    inj = F.FaultInjector(trace)
    run = realtime_run(pkg, scene, driver='threaded', injector=inj)
    check_launched('realtime faults', run['launches'])
    mgr = run['mgr']
    fired = inj.fired_counts()
    if fired != trace.counts() or inj.outstanding():
        fail(f'realtime faults: fired {fired}, outstanding '
             f'{inj.outstanding()}')
    counted = {key[len('serve.faults{kind='):-1]: mgr.metrics[key].value
               for key in mgr.metrics.names()
               if key.startswith('serve.faults{')}
    if counted != fired:
        fail(f'realtime faults: counters {counted} != fired {fired}')
    degraded = mgr.metrics['serve.degraded_ticks'].value
    if degraded < fired['worker_death']:
        fail(f'realtime faults: {degraded} degraded ticks for '
             f'{fired["worker_death"]} worker deaths')
    if not bool(torch.isfinite(run['stepper'].shared.cache.values).all()):
        fail('realtime faults: non-finite values in the cache')
    if 'serve.thread_leaks' in mgr.metrics:
        fail('realtime faults: a planner thread leaked')
    compare_records('realtime faults', fault_rec, run['rec'], exact=True,
                    parts=('log', 'caches'))
    out['faults'] = dict(
        ticks=mgr.tick, fired=fired, degraded=degraded,
        watchdog=mgr.metrics['serve.watchdog'].value
        if 'serve.watchdog' in mgr.metrics else 0,
        quarantined=mgr.metrics['serve.quarantined'].value,
        wall_s=run['wall_s'], launches=run['launches'])
    print(f'realtime faults: drained with every frame rendered, counters '
          f'equal the fired events, no planner thread leaked, and every '
          f'tick equals the sync faults run bit for bit: '
          + json.dumps(out['faults']), flush=True)
    del run, mgr
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    # (c) streamed: unbounded arena (sync) and budgeted arena (threaded)
    t0 = time.perf_counter()
    chunked = pkg.scenes.partition_scene(scene, cell_size=STREAM_CELL,
                                         chunk_cap=STREAM_CHUNK)
    partition_s = time.perf_counter() - t0
    positions = [c.host_pose[0] for c in pkg.orbit_trajectory(
        FRAMES, width=WIDTH, height_px=HEIGHT, start_deg=STREAM_START_DEG,
        device=DEVICE)]
    live = int((pkg.scenes.chunk_levels(chunked, positions, STREAM_NEAR,
                                        STREAM_LOD) > 0).sum())
    # the prefetch ring: one cell further at each level
    ring = int((pkg.scenes.chunk_levels(chunked, positions, STREAM_NEAR + 1,
                                        STREAM_LOD + 1) > 0).sum())
    frame_bytes = STREAM_CHUNK * pkg.scenes.BYTES_PER_GAUSSIAN
    if not live < ring < chunked.num_chunks:
        fail(f'stream: working set {live}, ring {ring} and partition '
             f'{chunked.num_chunks} chunks leave no budget between them')
    runs = {}
    for label, budget, driver in (('unbounded', None, 'sync'),
                                  ('budgeted', ring * frame_bytes,
                                   'threaded')):
        res = pkg.streaming.ResidencyManager(
            chunked, near_radius=STREAM_NEAR, lod_radius=STREAM_LOD,
            budget_bytes=budget, device=DEVICE)
        tracer = pkg.obs.Tracer()
        run = realtime_run(pkg, scene, driver=driver, streaming=res,
                           tracer=tracer, start_deg=STREAM_START_DEG)
        check_launched(f'stream {label}', run['launches'])
        roll = pkg.serve.tick_rollup(run['mgr'].tick_log, warmup_ticks=1)
        apply_ms = [e.dur * 1e3 for e in tracer.events
                    if e.name == 'stream.apply']
        run.update(res=res, roll=roll, apply_ms=apply_ms)
        runs[label] = run
        del tracer
    compare_records('stream budgeted', runs['unbounded']['rec'],
                    runs['budgeted']['rec'], exact=True,
                    parts=('log', 'caches'))
    b = runs['budgeted']
    counters = b['res'].counters()
    if b['roll'].get('stream_stalls_tail', 0) != 0:
        fail(f'stream budgeted: {b["roll"]["stream_stalls_tail"]} stalls '
             f'after warm-up')
    if counters['prefetch_hits'] <= 0:
        fail('stream budgeted: no prefetch hit')
    if not b['res'].resident_bytes < chunked.scene_bytes:
        fail(f'stream budgeted: {b["res"].resident_bytes} B resident, the '
             f'scene holds {chunked.scene_bytes} B')
    out['stream'] = dict(
        chunks=chunked.num_chunks, live_chunks=live, ring_chunks=ring,
        partition_s=partition_s, arena_bytes=b['res'].arena_bytes,
        resident_bytes=b['res'].resident_bytes,
        full_bytes=chunked.scene_bytes,
        unbounded_arena_bytes=runs['unbounded']['res'].arena_bytes,
        counters=counters,
        unbounded_counters=runs['unbounded']['res'].counters(),
        stalls_tail=b['roll'].get('stream_stalls_tail', 0),
        tick_ms_median=statistics.median(b['lat']),
        tick_ms_max=b['lat'][-1],
        unbounded_tick_ms_median=statistics.median(
            runs['unbounded']['lat']),
        unstreamed_tick_ms_median=statistics.median(shared['lat']),
        apply_ms=[round(x, 3) for x in b['apply_ms']],
        unbounded_apply_ms=[round(x, 3) for x in runs['unbounded']['apply_ms']],
        host_ms_mean=b['roll'].get('host_ms'),
        unbounded_host_ms_mean=runs['unbounded']['roll'].get('host_ms'),
        host_overlap=b['roll'].get('host_overlap'),
        wall_s=b['wall_s'], unbounded_wall_s=runs['unbounded']['wall_s'],
        launches=b['launches'])
    print(f'realtime stream: partition_scene(cell {STREAM_CELL}, chunk '
          f'{STREAM_CHUNK}); near {STREAM_NEAR}, lod {STREAM_LOD}; the '
          f'budgeted arena under ThreadedDriver equals the unbounded arena '
          f'under SyncDriver bit for bit on every tick: '
          + json.dumps(out['stream']), flush=True)
    del runs
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()
    return out


def fleet_sessions(pkg) -> list:
    """FLEET_VIEWERS sessions of FRAMES frames, each on its own orbit (60
    deg apart) and its own scene block, arriving at FLEET_ARRIVALS with
    FLEET_PACES."""
    return [pkg.serve.ViewerSession(
        sid=sid, cams=pkg.orbit_trajectory(FRAMES, width=WIDTH,
                                           height_px=HEIGHT,
                                           start_deg=60.0 * sid,
                                           device=DEVICE),
        arrival_tick=arrival, scene_id=sid, pace=pace)
        for sid, (arrival, pace) in enumerate(zip(FLEET_ARRIVALS,
                                                  FLEET_PACES))]


def fleet_build(pkg, scene, backend: str, **kw):
    """FLEET_WORKERS workers of FLEET_SLOTS private slots, all on the card
    (``launch.mesh.serve_devices`` cycles over the one card)."""
    cam0 = pkg.orbit_trajectory(1, width=WIDTH, height_px=HEIGHT,
                                device=DEVICE)[0]
    return pkg.fleet.FleetManager.build(
        scene, lumina_config(pkg, backend=backend), cam0,
        num_devices=FLEET_WORKERS, slots_per_device=FLEET_SLOTS,
        device=DEVICE, **kw)


def fleet_record(fm) -> dict:
    """Record every frame the fleet renders under ``(sid, frame index)``:
    a list of ``(image, hit count, sorted flag)``, one entry a render (a
    rollback replays frames)."""
    rec = {}
    for w in fm.workers:
        mgr, stepper = w.mgr, w.mgr.stepper
        pixels = stepper.tiles_x * stepper.tiles_y * 256

        def recording_finish(infl, finish=stepper.step_finish, mgr=mgr,
                             pixels=pixels):
            out = finish(infl)
            for slot, (img, st, _) in out.items():
                sess = mgr.slot_session[slot]
                rec.setdefault((sess.sid, sess.cursor), []).append(
                    (img, round(float(st.hit_rate) * pixels),
                     float(st.sorted_this_frame)))
            return out

        stepper.step_finish = recording_finish
    return rec


def fleet_instrument(pkg, fm) -> dict:
    """Count each worker's kernel launches and time its legs (the sync
    driver runs the legs one after another, so a leg's change of
    ``LAUNCHES`` is its own)."""
    out = {'launches': {w.device_id: collections.Counter()
                        for w in fm.workers},
           'leg_ms': {w.device_id: [] for w in fm.workers}}
    leg = fm._worker_tick

    def counted(w):
        before = dict(pkg.kernels.LAUNCHES)
        t0 = time.perf_counter()
        frames = leg(w)
        out['leg_ms'][w.device_id].append((time.perf_counter() - t0) * 1e3)
        for name, n in pkg.kernels.LAUNCHES.items():
            out['launches'][w.device_id][name] += n - before[name]
        return frames

    fm._worker_tick = counted
    return out


def fleet_drive(fm, limit: int, until: int | None = None,
                tick_ms: list | None = None) -> float:
    """The sync fleet driver's loop until the fleet drains or reaches tick
    ``until``; each fleet tick's wall (ms) goes to ``tick_ms``.  Returns
    the loop's wall seconds."""
    import torch
    t0 = time.perf_counter()
    while not fm.drained() and (until is None or fm.tick < until):
        t = time.perf_counter()
        fm.run_tick()
        if tick_ms is not None:
            tick_ms.append((time.perf_counter() - t) * 1e3)
        if fm.tick > limit:
            fail(f'fleet run did not drain in {limit} ticks')
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def fleet_compare(label: str, want: dict, got: dict, keys=None, *,
                  replays: bool = False) -> tuple:
    """Hold the renders of ``got`` (under ``keys``, all of ``want``'s by
    default) against ``want``: hit counts and sorted flags equal, images
    within ULPS.  With ``replays`` every render of a key is held against
    ``want``'s only render of it, else the renders pair up one to one.
    Returns (every image bit-identical, largest absolute difference,
    largest difference in ulps x magnitude)."""
    import torch
    eps = torch.finfo(torch.float32).eps
    keys = sorted(want) if keys is None else sorted(keys)
    identical, worst = True, [0.0, 0.0]
    for key in keys:
        if key not in got or key not in want:
            fail(f'{label}: frame {key} rendered in one run only')
        w, g = want[key], got[key]
        if not replays and len(w) != len(g):
            fail(f'{label}: frame {key} rendered {len(g)} times, '
                 f'{len(w)} in the oracle')
        for i, (img, hits, flag) in enumerate(g):
            w_img, w_hits, w_flag = w[0 if replays else i]
            if (hits, flag) != (w_hits, w_flag):
                fail(f'{label}: frame {key}: (hits, sorted) {(hits, flag)} '
                     f'!= {(w_hits, w_flag)}')
            if not ulp_close(img, w_img):
                fail(f'{label}: frame {key}: images differ by more than '
                     f'{ULPS} ulps')
            identical &= bool(torch.equal(img, w_img))
            diff = (img - w_img).abs()
            scale = torch.clamp(torch.maximum(img.abs(), w_img.abs()),
                                min=1.0)
            worst[0] = max(worst[0], float(diff.max()))
            worst[1] = max(worst[1], float((diff / (eps * scale)).max()))
    return identical, worst[0], worst[1]


def fleet_state_check(label: str, fm, want) -> None:
    """Each worker's clock, placement, sort log and cache equal
    ``want``'s."""
    import torch
    for w, v in zip(fm.workers, want.workers):
        a, b = w.mgr.stepper, v.mgr.stepper
        if (w.mgr.tick, a.global_tick) != (v.mgr.tick, b.global_tick):
            fail(f'{label}: device {w.device_id} clocks differ')
        if [s and s.sid for s in w.mgr.slot_session] != \
                [s and s.sid for s in v.mgr.slot_session]:
            fail(f'{label}: device {w.device_id} slots differ')
        if a.sort_log != b.sort_log:
            fail(f'{label}: device {w.device_id} sort logs differ')
        for f in ('tags', 'age', 'clock'):
            if not torch.equal(getattr(a.shared.cache, f),
                               getattr(b.shared.cache, f)):
                fail(f'{label}: device {w.device_id} cache {f} differs')


def fleet_check_drained(label: str, fm, restored: bool = False) -> None:
    """Every viewer finished at its last frame, with each frame counted
    once (a restored run counts only the frames after its snapshot)."""
    done = fm.finished_sessions()
    if [s.sid for s in done] != list(range(FLEET_VIEWERS)) or any(
            s.cursor != FRAMES or not 0 < s.telemetry.frames <= FRAMES
            or (s.telemetry.frames != FRAMES and not restored)
            for s in done):
        fail(f'{label}: finished {[s.sid for s in done]} with frames '
             f'{[s.telemetry.frames for s in done]}')


def fleet_phase(pkg, scene) -> dict:
    """(a) conformance, (b) migration, (c) device loss and restore at
    launch; see the module docstring.  Returns the printed numbers."""
    import torch
    out = {}
    limit = 4 * FRAMES + 20
    # (a) the sync fleet on both backends in lockstep, then threaded
    golden = fleet_build(pkg, scene, 'kernel')
    ref = fleet_build(pkg, scene, 'reference')
    g_rec, r_rec = fleet_record(golden), fleet_record(ref)
    inst = fleet_instrument(pkg, golden)
    for fm in (golden, ref):
        for sess in fleet_sessions(pkg):
            fm.submit(sess)
    tick_ms, ref_s = [], 0.0
    pkg.kernels.reset_launches()
    while not (golden.drained() and ref.drained()):
        t = time.perf_counter()
        golden.run_tick()
        tick_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        ref.run_tick()
        ref_s += time.perf_counter() - t
        fleet_state_check(f'fleet reference tick {golden.tick - 1}', ref,
                          golden)
        if golden.tick > limit:
            fail(f'fleet conformance did not drain in {limit} ticks')
    sync_launches = dict(pkg.kernels.LAUNCHES)
    for d, n in inst['launches'].items():
        check_launched(f'fleet sync device {d}', n)
    fleet_check_drained('fleet sync', golden)
    if golden.home != ref.home:
        fail('fleet reference: routing differs')
    _, ref_abs, ref_ulps = fleet_compare('fleet reference', g_rec, r_rec)
    del ref, r_rec
    # the sync driver's own loop is run_tick after run_tick
    sync_wall = sum(tick_ms) / 1e3
    sync_det = pkg.straggler.StragglerDetector(FLEET_WORKERS)
    for t in range(len(tick_ms)):
        sync_det.observe_step({d: ms[t] / 1e3
                               for d, ms in inst['leg_ms'].items()
                               if t < len(ms)})
    threaded = fleet_build(pkg, scene, 'kernel')
    t_rec = fleet_record(threaded)
    for sess in fleet_sessions(pkg):
        threaded.submit(sess)
    drv = pkg.fleet.ThreadedFleetDriver(threaded)
    t_tick_ms, t_leg_ms = [], {d: [] for d in range(FLEET_WORKERS)}
    run_tick, observe = drv.run_tick, drv.detector.observe_step

    def timed_tick():
        t = time.perf_counter()
        frames = run_tick()
        t_tick_ms.append((time.perf_counter() - t) * 1e3)
        return frames

    def observed(timings):
        for d, s in timings.items():
            t_leg_ms[d].append(s * 1e3)
        return observe(timings)

    drv.run_tick, drv.detector.observe_step = timed_tick, observed
    pkg.kernels.reset_launches()
    t0 = time.perf_counter()
    drv.run(limit)
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    threaded_wall = time.perf_counter() - t0
    launches = dict(pkg.kernels.LAUNCHES)
    if launches != sync_launches:
        fail(f'fleet threaded: launches {launches} != the sync run\'s '
             f'{sync_launches}')
    fleet_check_drained('fleet threaded', threaded)
    if 'serve.thread_leaks' in threaded.metrics:
        fail('fleet threaded: a worker thread leaked')
    if (threaded.tick, threaded.home) != (golden.tick, golden.home):
        fail('fleet threaded: ticks or routing differ from the sync run')
    fleet_state_check('fleet threaded', threaded, golden)
    t_identical, t_abs, _ = fleet_compare('fleet threaded', g_rec, t_rec)

    def worker_medians(fm):
        return {w.device_id: statistics.median(
            t['latency_ms'] for t in w.mgr.tick_log if t['tick'] > 0)
            for w in fm.workers}

    out['conformance'] = dict(
        ticks=golden.tick, frames=FLEET_VIEWERS * FRAMES,
        fleet_tick_ms_median=statistics.median(tick_ms),
        fleet_tick_ms_max=max(tick_ms),
        worker_tick_ms_median=worker_medians(golden),
        worker_leg_ms_median={d: statistics.median(ms)
                              for d, ms in inst['leg_ms'].items()},
        sync_wall_s=sync_wall, reference_wall_s=ref_s,
        threaded_wall_s=threaded_wall,
        threaded_fleet_tick_ms_median=statistics.median(t_tick_ms),
        threaded_worker_tick_ms_median=worker_medians(threaded),
        threaded_worker_leg_ms_median={d: statistics.median(ms)
                                       for d, ms in t_leg_ms.items()},
        straggler_ewma_ms={d: s.ewma * 1e3
                           for d, s in enumerate(drv.detector.stats)},
        sync_straggler_ewma_ms={d: s.ewma * 1e3
                                for d, s in enumerate(sync_det.stats)},
        straggler_flagged=sorted(drv.detector.flagged),
        threaded_bit_identical=t_identical,
        threaded_max_abs_diff=t_abs,
        reference_max_abs_diff=ref_abs, reference_max_ulps=ref_ulps,
        home=golden.home, launches=sync_launches,
        launches_per_worker={d: dict(n)
                             for d, n in inst['launches'].items()})
    print(f'fleet conformance: {FLEET_VIEWERS} viewers x {FRAMES} frames '
          f'on {FLEET_WORKERS} workers x {FLEET_SLOTS} slots, one card; '
          f'the reference backend made the sync fleet\'s decisions on every '
          f'tick (routing, slots, sort_log, cache; hits and sorted flags of '
          f'every frame, images within {ULPS} ulps); the threaded fleet '
          f'equals the sync fleet on every integer: '
          + json.dumps(out['conformance']), flush=True)
    del threaded, t_rec, golden, drv
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    # (b) a cold move and an aligned move against the golden run
    fm = fleet_build(pkg, scene, 'kernel')
    m_rec = fleet_record(fm)
    inst = fleet_instrument(pkg, fm)
    for sess in fleet_sessions(pkg):
        fm.submit(sess)
    moves = {}
    for kind, (tick, sid, dst) in (('cold', FLEET_COLD_MOVE),
                                   ('aligned', FLEET_ALIGNED_MOVE)):
        fleet_drive(fm, limit, until=tick)
        src = fm.home[sid]
        slot = next(i for i, s in enumerate(fm.workers[src].mgr.slot_session)
                    if s is not None and s.sid == sid)
        t0 = time.perf_counter()
        target = fm.migrate(sid, dst)
        if DEVICE == 'cuda':
            torch.cuda.synchronize()
        moves[kind] = dict(tick=tick, sid=sid, src=src, dst=dst,
                           slot=slot, target=target,
                           ms=(time.perf_counter() - t0) * 1e3)
        key = f'fleet.migrations{{kind={kind}}}'
        if key not in fm.metrics or fm.metrics[key].value != 1 or \
                (target == slot) != (kind == 'aligned'):
            fail(f'fleet migration: the {kind} move of sid {sid} landed in '
                 f'slot {target} from slot {slot}')
    fleet_drive(fm, limit)
    for d, n in inst['launches'].items():
        check_launched(f'fleet migration device {d}', n)
    fleet_check_drained('fleet migration', fm)
    a_sid, c_sid = FLEET_ALIGNED_MOVE[1], FLEET_COLD_MOVE[1]
    a_identical, a_abs, _ = fleet_compare(
        'fleet aligned move', g_rec, m_rec,
        [k for k in g_rec if k[0] == a_sid])
    cold = {f: len(m_rec.get((c_sid, f), ())) for f in range(FRAMES)}
    if set(cold.values()) != {1} or any(
            k[0] == c_sid and k[1] >= FRAMES for k in m_rec):
        fail(f'fleet cold move: frames rendered {cold}')
    u_identical, u_abs, _ = fleet_compare(
        'fleet unmoved', g_rec, m_rec,
        [k for k in g_rec if k[0] not in (a_sid, c_sid)])
    out['migration'] = dict(
        moves=moves, aligned_bit_identical=a_identical,
        aligned_max_abs_diff=a_abs, unmoved_bit_identical=u_identical,
        unmoved_max_abs_diff=u_abs, ticks=fm.tick,
        launches_per_worker={d: dict(n)
                             for d, n in inst['launches'].items()})
    print(f'fleet migration: sid {c_sid} moved cold and sid {a_sid} aligned '
          f'mid-run; the aligned viewer and the unmoved viewers equal the '
          f'golden run on every integer, the cold viewer rendered every '
          f'frame once: ' + json.dumps(out['migration']), flush=True)
    del fm, m_rec
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()

    # (c) device loss with checkpoint rollback; restore at launch
    ckdir = HERE / 'build' / 'fleet_ckpt'
    shutil.rmtree(ckdir, ignore_errors=True)
    F = pkg.faults
    inj = F.FaultInjector(F.FaultTrace(seed=0, events=(F.FaultEvent(
        tick=FLEET_LOSS_TICK, kind='device_loss', slot=0),)))
    fm = fleet_build(pkg, scene, 'kernel', ckpt_root=ckdir,
                     ckpt_every=FLEET_CKPT_EVERY, injector=inj)
    l_rec = fleet_record(fm)
    inst = fleet_instrument(pkg, fm)
    saves = {w.device_id: [] for w in fm.workers}
    for w in fm.workers:
        def timed_save(tree, save=w.ckpt.save, d=w.device_id, **kw):
            t0 = time.perf_counter()
            save(tree, **kw)
            saves[d].append((time.perf_counter() - t0) * 1e3)
        w.ckpt.save = timed_save
    for sess in fleet_sessions(pkg):
        fm.submit(sess)
    pkg.kernels.reset_launches()
    fleet_drive(fm, limit, until=FLEET_LOSS_TICK)
    for w in fm.workers:
        w.ckpt.wait()
    snap = {w.device_id: w.ckpt.manifest_extra(w.ckpt.latest())
            for w in fm.workers}
    step = snap[0]['tick']
    ckpt_bytes = {d: sum(p.stat().st_size for p in
                         (ckdir / f'device{d}' / f'step_{step:010d}').iterdir())
                  for d in snap}

    # restore at launch in a fresh fleet from the same directory (read
    # only), while the loss run waits at its tick boundary
    rfm = fleet_build(pkg, scene, 'kernel', ckpt_root=ckdir)
    rr_rec = fleet_record(rfm)
    t0 = time.perf_counter()
    restored = rfm.restore_at_launch(fleet_sessions(pkg))
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    launch_restore_s = time.perf_counter() - t0
    if restored != step:
        fail(f'fleet restore at launch: restored tick {restored}, the '
             f'snapshot is at {step}')
    fleet_drive(rfm, limit)
    fleet_check_drained('fleet restore at launch', rfm, restored=True)
    cont = {}
    for d, meta in snap.items():
        for m in meta['slots']:
            if m is not None:
                cont[m['sid']] = m['cursor']
    want_keys = [k for k in g_rec if k[1] >= cont.get(k[0], 0)]
    if sorted(rr_rec) != sorted(want_keys):
        fail(f'fleet restore at launch: rendered {sorted(rr_rec)}, '
             f'expected {sorted(want_keys)}')
    r_identical, r_abs, _ = fleet_compare('fleet restore at launch', g_rec,
                                          rr_rec, want_keys)
    del rfm, rr_rec

    # the loss at FLEET_LOSS_TICK, timed with its restores split out
    restore_ms = collections.defaultdict(list)
    for w in fm.workers:
        mgr = w.mgr
        for name in ('restore_serving', '_restore_arrays'):
            def timed(*a, fn=getattr(mgr, name), d=w.device_id, name=name,
                      **kw):
                t0 = time.perf_counter()
                res = fn(*a, **kw)
                restore_ms[f'{name} device {d}'].append(
                    (time.perf_counter() - t0) * 1e3)
                return res
            setattr(mgr, name, timed)
    lose, at_loss = fm.lose_device, {}
    recover = {}

    def timed_lose(victim):
        at_loss.update({s.sid: s.cursor for s in fm.sessions.values()})
        t0 = time.perf_counter()
        lose(victim)
        if DEVICE == 'cuda':
            torch.cuda.synchronize()
        recover['s'] = time.perf_counter() - t0

    fm.lose_device = timed_lose
    fleet_drive(fm, limit)
    for d, n in inst['launches'].items():
        check_launched(f'fleet loss device {d}', n)
    fleet_check_drained('fleet loss', fm)
    victims = tuple((m['sid'], slot) for slot, m in enumerate(snap[0]['slots'])
                    if m is not None)
    free = {1: tuple(i for i, m in enumerate(snap[1]['slots']) if m is None)}
    aligned, spilled = pkg.fleet.plan_shrink(victims, free, {1})
    counters = {k: fm.metrics[k].value for k in fm.metrics.names()
                if k.startswith('fleet.')}
    want = {'fleet.device_lost{device=0}': 1,
            'fleet.migrations{kind=loss_aligned}': len(aligned),
            'fleet.migrations{kind=loss_spilled}': len(spilled),
            'fleet.alive_devices': 1}
    if not aligned or not spilled or any(counters.get(k) != v
                                         for k, v in want.items()):
        fail(f'fleet loss: counters {counters}, expected {want} '
             f'(aligned {aligned}, spilled {spilled})')
    kept = [m['sid'] for m in snap[1]['slots'] if m is not None]
    exact_sids = kept + [sid for sid, _, _ in aligned]
    l_identical, l_abs, _ = fleet_compare(
        'fleet loss survivors', g_rec, l_rec,
        [k for k in g_rec if k[0] in exact_sids], replays=True)
    for sid in spilled:
        c_snap = cont[sid]
        counts = {f: len(l_rec.get((sid, f), ())) for f in range(FRAMES)}
        twice = {f for f, n in counts.items() if n == 2}
        if set(counts.values()) - {1, 2} or \
                twice != set(range(c_snap, at_loss[sid])):
            fail(f'fleet loss: spilled sid {sid} (snapshot cursor {c_snap}, '
                 f'{at_loss[sid]} at the loss) rendered {counts}')
        fleet_compare(f'fleet loss spilled sid {sid}', g_rec, l_rec,
                      [(sid, f) for f in range(c_snap)])
    for w in fm.workers:
        w.ckpt.wait()
    shutil.rmtree(ckdir, ignore_errors=True)
    out['loss'] = dict(
        loss_tick=FLEET_LOSS_TICK, snapshot_tick=step, ticks=fm.tick,
        aligned=aligned, spilled=spilled, counters=counters,
        recover_s=recover['s'],
        restore_ms={k: v for k, v in restore_ms.items()},
        survivors_bit_identical=l_identical, survivors_max_abs_diff=l_abs,
        checkpoint_bytes=ckpt_bytes, save_ms=saves,
        launch_restore_s=launch_restore_s,
        launch_restore_bit_identical=r_identical,
        launch_restore_max_abs_diff=r_abs,
        launches_per_worker={d: dict(n)
                             for d, n in inst['launches'].items()})
    print(f'fleet loss: device 0 lost at tick {FLEET_LOSS_TICK}, the fleet '
          f'rolled back to tick {step}; survivors and the aligned victim '
          f'equal the golden run on every integer of every render, the '
          f'spilled viewers re-queued at their snapshot cursors, every '
          f'viewer drained; restore_at_launch from the same snapshots '
          f'continued as the golden run: ' + json.dumps(out['loss']),
          flush=True)
    del fm, l_rec, g_rec
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()
    return out


def lm_leaves(tree) -> list:
    """The tensors of a decode state (a pair, or nested dicts of them)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in lm_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in lm_leaves(v)]
    return [tree]


def lm_batch(pkg, cfg, seed: int, rows: int, n: int, device) -> dict:
    """Seeded tokens [rows, n] and, for encdec, seeded standard-normal
    frames [rows, LM_FRAMES, D] in the model dtype; made on the CPU, so the
    same values land on every device."""
    import torch
    out = {'tokens': pkg.tokens.synthetic_batch(seed, 0, rows, n, cfg.vocab,
                                                device='cpu')['tokens']}
    if cfg.family == 'encdec':
        gen = torch.Generator().manual_seed(seed)
        out['frames'] = torch.randn((rows, LM_FRAMES, cfg.d_model),
                                    generator=gen).to(getattr(torch,
                                                              cfg.dtype))
    return {k: v.to(device) for k, v in out.items()}


def lm_prefill(pkg, model, cfg, batch, n: int):
    """The registry's prefill logits over the first ``n`` tokens."""
    ctx = pkg.registry.make_ctx(None, cfg)
    return pkg.registry.make_prefill(cfg, ctx)(
        model, dict(batch, tokens=batch['tokens'][:, :n]))


def lm_decode(pkg, model, cfg, batch, max_seq: int) -> list:
    """The logits of every token of ``batch`` teacher-forced through the
    registry's decode step from a zeroed state (over ``prepare_cross`` of
    the frames for encdec)."""
    registry = pkg.registry
    toks = batch['tokens']
    state = registry.init_decode_state(cfg, toks.shape[0], max_seq,
                                       device=toks.device)
    if cfg.family == 'encdec':
        state['cross'] = model.prepare_cross(batch['frames'])
    step = registry.make_decode_step(cfg, registry.make_ctx(None, cfg))
    out = []
    for t in range(toks.shape[1]):
        lg, state = step(model, toks[:, t:t + 1], state, t)
        out.append(lg)
    return out


def lm_prefill_then_decode(pkg, model, cfg, batch, n_prompt: int) -> list:
    """Logits of ``prefill`` over the first ``n_prompt`` tokens, then of one
    teacher-forced ``decode_step`` a further token, as float32 CPU
    tensors.  The dense family's decode continues from prefill's caches;
    the other families' prefill returns no state, so their decode starts
    from a zeroed state at position 0, as the server's admission does, and
    the steps past the prompt are kept."""
    toks = batch['tokens']
    if cfg.family not in ('dense', 'vlm'):
        steps = lm_decode(pkg, model, cfg, batch, toks.shape[1])
        return [lm_prefill(pkg, model, cfg, batch, n_prompt).float().cpu()] \
            + [lg.float().cpu() for lg in steps[n_prompt:]]
    lg, (k, v) = model.prefill(toks[:, :n_prompt])
    out = [lg.float().cpu()]
    state = pkg.registry.init_decode_state(cfg, toks.shape[0],
                                           toks.shape[1], device=toks.device)
    state[0][:, :, :n_prompt] = k
    state[1][:, :, :n_prompt] = v
    for t in range(n_prompt, toks.shape[1]):
        lg, state = model.decode_step(toks[:, t:t + 1], state, t)
        out.append(lg.float().cpu())
    return out


def lm_gap(lg, fwd) -> dict:
    """Decode's logits against forward's, in bfloat16 ulps of forward's
    largest logit; ``ok`` within LM_DECODE_ULPS of them."""
    lg, fwd = lg.float(), fwd.float()
    gap = float((lg - fwd).abs().max())
    peak = float(fwd.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(peak)) - 7)
    return {'max_abs_gap': gap, 'max_abs_logit': peak,
            'bound': LM_DECODE_ULPS * ulp, 'gap_in_bf16_ulps': gap / ulp,
            'argmax_equal': bool((lg.argmax(-1) == fwd.argmax(-1)).all()),
            'ok': gap <= LM_DECODE_ULPS * ulp}


def lm_device_busy(fn, reps: int) -> dict | None:
    """Kernel time and launches a call of ``fn``, and its five costliest
    kernels, from ``torch.profiler`` over ``reps`` calls; None where the
    profiler shows no device time.  The device alone is traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in kernels)
    if not kernel_us:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {'kernel_ms': kernel_us / reps / 1e3,
            'launches': sum(e.count for e in kernels) / reps,
            'top_kernels_ms': {e.key[:80]: e.self_device_time_total / reps
                               / 1e3 for e in top}}


def lm_serve_phase(pkg, arch: str, want_params: int, want_state_bytes: int,
                   cpu_depth: int | None) -> dict:
    """The LM token server for ``arch`` at its full width and depth: (a)
    the served run, twice; (b) decode against forward; (c) the card against
    the CPU on float32 copies of the weights (of a ``cpu_depth``-layer
    model drawn alike, where given); (d) the decode step's time beside its
    bound.  Returns the printed numbers."""
    import torch
    t_phase = time.perf_counter()
    lm, registry = pkg.lm_serve, pkg.registry
    cuda = DEVICE == 'cuda'
    server = lm.Server(arch, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                       full=LM_FULL, device=DEVICE)
    cfg, model = server.cfg, server.params
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    param_bytes = sum(p.numel() * p.element_size() for p in named.values())
    state_bytes = sum(c.numel() * c.element_size()
                      for c in lm_leaves(server.state))
    out = {'arch': arch, 'family': cfg.family, 'n_layers': cfg.n_layers,
           'd_model': cfg.d_model,
           'heads': [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()],
           'd_ff': cfg.d_ff, 'vocab': cfg.vocab, 'dtype': cfg.dtype,
           'params': n_params, 'param_bytes': param_bytes,
           'decode_state_bytes': state_bytes}
    print(f'lm serve {arch}: ' + json.dumps(out), flush=True)
    if LM_FULL and (n_params, state_bytes) != (want_params, want_state_bytes):
        fail(f'lm serve: {arch} has {n_params} parameters and '
             f'{state_bytes} decode-state bytes at {LM_SLOTS} x '
             f'{LM_MAX_SEQ}, not {want_params} and {want_state_bytes}')

    # (a) the served run, twice on the same weights; the second run's peak
    # memory is read beside what was held when it started (the weights, its
    # decode state, and whatever earlier phases still hold)
    runs = []
    for i in range(2):
        if i:
            server = lm.Server(arch, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                               full=LM_FULL, device=DEVICE)
            server.params = model
        pending = lm.synthetic_requests(LM_REQUESTS, LM_PROMPT, LM_MAX_NEW,
                                        cfg.vocab, device=server.device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        done, ticks = lm.drain(server, pending)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = {r.rid: list(r.out) for r in done}
        tokens = sum(len(o) for o in outs.values())
        runs.append(outs)
        row = {'run': i + 1, 'completed': len(done), 'ticks': ticks,
               'tokens': tokens, 'wall_s': wall, 'tok_per_s': tokens / wall}
        print(f'lm serve {arch} (a) run {i + 1}: ' + json.dumps(row),
              flush=True)
        out[f'run{i + 1}'] = row
        if len(done) != LM_REQUESTS or tokens != LM_REQUESTS * LM_MAX_NEW:
            fail(f'lm serve {arch} (a): {len(done)} of {LM_REQUESTS} '
                 f'requests, {tokens} tokens')
        if not all(0 <= t < cfg.vocab for o in outs.values() for t in o):
            fail(f'lm serve {arch} (a): a token outside the vocab')
    if cuda:
        out['memory'] = {'held_bytes': held,
                         'peak_above_held_bytes':
                             torch.cuda.max_memory_allocated() - held}
    if runs[0] != runs[1]:
        fail(f'lm serve {arch} (a): the second run emitted other tokens')
    del server
    print(f'lm serve {arch} (a): identical tokens in both runs; request 0 '
          f'{runs[0][0]}; run 2 memory {out.get("memory")}', flush=True)

    # (b) decode against forward at full width, in bfloat16 (and on float32
    # copies for LM_DECODE_F32)
    batch = lm_batch(pkg, cfg, 0, 2, LM_CHECK_TOKENS, DEVICE)

    def gap(m, c):
        return lm_gap(lm_decode(pkg, m, c, batch, LM_CHECK_TOKENS + 4)[-1],
                      lm_prefill(pkg, m, c, batch, LM_CHECK_TOKENS))

    out['decode_vs_forward'] = gap(model, cfg)
    gated = 'decode_vs_forward'
    if arch in LM_DECODE_F32:
        gated = 'decode_vs_forward_float32'
        out[gated] = gap(copy.deepcopy(model).to(torch.float32),
                         dataclasses.replace(cfg, dtype='float32'))
    out[gated]['gated'] = True
    for key in ('decode_vs_forward', 'decode_vs_forward_float32'):
        if key in out:
            print(f'lm serve {arch} (b) {key}, {LM_CHECK_TOKENS} tokens: '
                  + json.dumps(out[key]), flush=True)
    if not out[gated]['ok']:
        fail(f'lm serve {arch} (b): decode and forward differ: '
             f'{out[gated]}')
    if cuda:
        torch.cuda.empty_cache()

    # (c) the card against the CPU, float32 copies of the same weights
    base, cfg_c = model, cfg
    if cpu_depth is not None and LM_FULL:
        cfg_c = dataclasses.replace(cfg, n_layers=cpu_depth)
        base = registry.init_params(1, cfg_c, device=DEVICE)
    cfg32 = dataclasses.replace(cfg_c, dtype='float32')
    batch = lm_batch(pkg, cfg32, 1, 1, LM_CPU_PROMPT + LM_CPU_STEPS, 'cpu')
    t0 = time.perf_counter()
    got = lm_prefill_then_decode(
        pkg, copy.deepcopy(base).to(DEVICE, torch.float32), cfg32,
        {k: v.to(DEVICE) for k, v in batch.items()}, LM_CPU_PROMPT)
    want = lm_prefill_then_decode(
        pkg, copy.deepcopy(base).to('cpu', torch.float32), cfg32, batch,
        LM_CPU_PROMPT)
    rels = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    argmax = [int(g.argmax()) == int(w.argmax()) for g, w in zip(got, want)]
    out['card_vs_cpu'] = {'n_layers': cfg_c.n_layers, 'rel_err': rels,
                          'bound': LM_CPU_REL, 'argmax_equal': argmax,
                          'wall_s': time.perf_counter() - t0}
    print(f'lm serve {arch} (c) card vs CPU, float32, prefill then '
          f'{LM_CPU_STEPS} decode steps: ' + json.dumps(out['card_vs_cpu']),
          flush=True)
    if not (max(rels) <= LM_CPU_REL and all(argmax)):
        fail(f'lm serve {arch} (c): card and CPU differ: '
             f'{out["card_vs_cpu"]}')
    del got, want, base
    if cuda:
        torch.cuda.empty_cache()

    # (d) the decode step at the served shape: device time, host time
    state = registry.init_decode_state(cfg, LM_SLOTS, LM_MAX_SEQ,
                                       device=DEVICE)
    tok = pkg.tokens.synthetic_tokens(2, 0, LM_SLOTS, 1, cfg.vocab,
                                      device=DEVICE)
    pos = LM_MAX_SEQ // 2
    decode = registry.make_decode_step(cfg, registry.make_ctx(None, cfg))

    def step():
        decode(model, tok, state, pos)

    ms = time_ms(step, LM_TIMED_STEPS)
    host, host_sync = [], []
    for _ in range(LM_TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            torch.cuda.synchronize()
        host_sync.append((time.perf_counter() - t0) * 1e3)
    # the weights a step reads, and its products: each expert's weights
    # multiply a bucket of moe_capacity rows, the rest LM_SLOTS rows
    read = {k: p for k, p in named.items()
            if not k.startswith(LM_NOT_DECODED)}
    rows = {k: (pkg.moe.moe_capacity(cfg, LM_SLOTS)
                if '.moe.w_' in k else LM_SLOTS) for k in read}
    nbytes = sum(p.numel() * p.element_size() for p in read.values()) \
        + state_bytes
    flops = sum(2 * p.numel() * rows[k] for k, p in read.items())
    busy = lm_device_busy(step, 3) if cuda else None
    out['decode_step'] = {
        'ms': ms, 'host_enqueue_ms': statistics.median(host),
        'host_synced_ms': statistics.median(host_sync),
        'device_busy': busy,
        'bytes': nbytes, 'bound_ms': nbytes / peaks().PEAK_BYTES_PER_S * 1e3,
        'flop_bound_ms': flops / peaks().PEAK_BF16_PER_S * 1e3,
        'slots': LM_SLOTS, 'pos': pos}
    print(f'lm serve {arch} (d) decode step (CUDA events, median of '
          f'{LM_TIMED_STEPS}; host clock without and with a sync): '
          + json.dumps(out['decode_step']), flush=True)
    del state, model, named, read
    if cuda:
        torch.cuda.empty_cache()
    out['phase_s'] = time.perf_counter() - t_phase
    print(f'lm serve {arch} phase took {out["phase_s"]:.1f} s', flush=True)
    return out


def lm_maverick_phase(pkg) -> dict:
    """llama4-maverick at its published widths and LM_MAVERICK_DEPTH
    layers, its weights drawn in bfloat16 on the card: prefill of
    LM_CPU_PROMPT tokens x LM_SLOTS rows, then LM_CPU_STEPS more decode
    steps; decode held against forward at the prompt's end and at the
    last token within (b)'s bound; peak memory."""
    import torch
    t_phase = time.perf_counter()
    registry = pkg.registry
    cuda = DEVICE == 'cuda'
    cfg = pkg.configs.get_config(LM_MAVERICK)
    cfg = dataclasses.replace(cfg, n_layers=LM_MAVERICK_DEPTH) if LM_FULL \
        else cfg.reduced()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    model = registry.init_params(0, cfg, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    out = {'arch': LM_MAVERICK, 'n_layers': cfg.n_layers,
           'd_model': cfg.d_model, 'n_experts': cfg.n_experts,
           'params': n_params,
           'param_bytes': sum(p.numel() * p.element_size()
                              for p in model.parameters())}
    if LM_FULL and n_params != LM_MAVERICK_PARAMS:
        fail(f'lm maverick: {n_params} parameters, not '
             f'{LM_MAVERICK_PARAMS}')
    n = LM_CPU_PROMPT + LM_CPU_STEPS
    batch = lm_batch(pkg, cfg, 0, LM_SLOTS, n, DEVICE)
    steps = lm_decode(pkg, model, cfg, batch, n)
    for at in (LM_CPU_PROMPT, n):
        out[f'decode_vs_forward_{at}'] = lm_gap(
            steps[at - 1], lm_prefill(pkg, model, cfg, batch, at))
    if cuda:
        torch.cuda.synchronize()
        out['memory'] = {'held_bytes': held,
                         'peak_above_held_bytes':
                             torch.cuda.max_memory_allocated() - held}
    out['phase_s'] = time.perf_counter() - t_phase
    print('lm maverick: ' + json.dumps(out), flush=True)
    for at in (LM_CPU_PROMPT, n):
        if not out[f'decode_vs_forward_{at}']['ok']:
            fail(f'lm maverick: decode and forward differ at {at} tokens: '
                 f'{out[f"decode_vs_forward_{at}"]}')
    del model, steps
    if cuda:
        torch.cuda.empty_cache()
    return out


def lm_train_batch(pkg, cfg, seed: int, rows: int, n: int, device) -> dict:
    """Seeded next-token ``tokens`` and ``labels`` [rows, n] and, for
    encdec, the trainer's ``_frames_for`` frames; made on the CPU, so the
    same values land on every device."""
    out = pkg.tokens.synthetic_batch(seed, 0, rows, n, cfg.vocab,
                                     device='cpu')
    if cfg.family == 'encdec':
        out['frames'] = pkg.lm_train._frames_for(cfg, out['tokens'])
    return {k: v.to(device) for k, v in out.items()}


@contextlib.contextmanager
def adam_calls(pkg, keep_grads: bool = False):
    """Record, for each ``adam.step`` inside, the pre-clip grad norm (and,
    with ``keep_grads``, the gradients it was given, by position)."""
    calls = []

    def wrap(_, fn):
        def step(params, grads, *a, **kw):
            out = fn(params, grads, *a, **kw)
            calls.append({'grad_norm': float(out[2]),
                          'grads': list(grads) if keep_grads else None})
            return out
        return step

    with patched([(pkg.adam, 'step', 'adam')], wrap):
        yield calls


def peak_since(held: int) -> int:
    import torch
    return torch.cuda.max_memory_allocated() - held


def memory_mark() -> int:
    """Free the allocator's cache and start a peak window; returns the
    bytes held now."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def lm_train_trainer(pkg, arch: str) -> tuple:
    """(a): ``launch.train.train`` at TRAIN_BATCH rows, halved while the
    card runs out of memory.  Returns (the model's config, the rows it
    trained at, the printed numbers)."""
    import torch
    cuda = DEVICE == 'cuda'
    rows = TRAIN_BATCH
    while True:
        held = memory_mark() if cuda else 0
        t0 = time.perf_counter()
        try:
            with adam_calls(pkg) as calls:
                model, _, hist = pkg.lm_train.train(
                    arch, steps=TRAIN_STEPS, batch=rows, seq=TRAIN_SEQ,
                    warmup=TRAIN_WARMUP, full=LM_FULL, device=DEVICE,
                    log_every=0)
            break
        except torch.cuda.OutOfMemoryError as e:
            if rows == 1:
                fail(f'lm train {arch} (a): out of memory at 1 row: {e}')
            print(f'lm train {arch} (a): out of memory at {rows} x '
                  f'{TRAIN_SEQ} tokens ({str(e).splitlines()[0]}); halving '
                  'the batch', flush=True)
            rows //= 2
    norms = [c['grad_norm'] for c in calls]
    row = {'rows': rows, 'seq': TRAIN_SEQ, 'steps': TRAIN_STEPS,
           'warmup': TRAIN_WARMUP, 'loss': hist, 'grad_norm': norms,
           'wall_s': time.perf_counter() - t0}
    if cuda:
        row['memory'] = {'held_bytes': held,
                         'peak_above_held_bytes': peak_since(held)}
    print(f'lm train {arch} (a) trainer: ' + json.dumps(row), flush=True)
    if not (len(hist) == len(norms) == TRAIN_STEPS
            and all(math.isfinite(x) for x in hist + norms)):
        fail(f'lm train {arch} (a): a loss or grad norm is not finite: '
             f'{row}')
    return model.cfg, rows, row


def lm_train_fit_and_time(pkg, model, rows: int, arch: str) -> dict:
    """(b) TRAIN_FIT_STEPS steps of ``model`` (a fresh draw, as
    ``tests/test_models.py`` starts) on one fixed batch, the loss falling;
    (e) TRAIN_TIMED_STEPS more, timed, beside the step's bounds."""
    import torch
    registry, adam = pkg.registry, pkg.adam
    cuda = DEVICE == 'cuda'
    cfg = model.cfg
    acfg = adam.AdamConfig(lr=TRAIN_FIT_LR, state_dtype=torch.float32)
    step_fn, _ = registry.make_train_step(cfg, registry.make_ctx(None, cfg),
                                          acfg)
    opt = adam.init(list(model.parameters()), acfg)
    batch = lm_train_batch(pkg, cfg, 1, rows, TRAIN_SEQ, DEVICE)
    state = {'opt': opt}

    def step():
        _, state['opt'], m = step_fn(model, state['opt'], batch)
        return m

    losses = [float(step()['loss']) for _ in range(TRAIN_FIT_STEPS)]
    out = {'fit': {'lr': TRAIN_FIT_LR, 'loss': losses}}
    print(f'lm train {arch} (b) {TRAIN_FIT_STEPS} steps on one batch: '
          + json.dumps(out['fit']), flush=True)
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail(f'lm train {arch} (b): the loss did not fall: {losses}')

    # (e) the step's time: CUDA events, and the host's clock without and
    # with a sync, in the same steps
    ms, host, host_sync = [], [], []
    for _ in range(TRAIN_TIMED_STEPS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        host_sync.append((time.perf_counter() - t0) * 1e3)
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    param_bytes = sum(p.numel() * p.element_size() for p in named.values())
    shape = pkg.ShapeConfig('train', TRAIN_SEQ, rows, 'train')
    flops = pkg.flops.model_flops(cfg, shape)
    nbytes = ADAM_BYTES * n_params + 2 * param_bytes
    med = statistics.median(ms) if ms else statistics.median(host_sync)
    busy = lm_device_busy(step, 1) if cuda else None
    out['step'] = {
        'ms': med if cuda else None, 'host_enqueue_ms':
        statistics.median(host), 'host_synced_ms':
        statistics.median(host_sync), 'device_busy': busy,
        'busy_share': busy['kernel_ms'] / med if busy else None,
        'tokens_per_s': rows * TRAIN_SEQ / (med / 1e3),
        'model_flops': flops, 'flop_bound_ms': flops / peaks().PEAK_BF16_PER_S * 1e3,
        'bytes': nbytes, 'byte_bound_ms': nbytes / peaks().PEAK_BYTES_PER_S * 1e3,
        'params': n_params, 'rows': rows, 'seq': TRAIN_SEQ,
        'remat': cfg.remat}
    out['step']['bound_ms'] = max(out['step']['flop_bound_ms'],
                                  out['step']['byte_bound_ms'])
    print(f'lm train {arch} (e) train step (CUDA events, median of '
          f'{TRAIN_TIMED_STEPS}; host clock without and with a sync; '
          'torch.profiler over one step): ' + json.dumps(out['step']),
          flush=True)
    return out


def lm_train_remat(pkg, model, rows: int, arch: str) -> dict:
    """(d) steps with remat and without, on copies of the same weights and
    the same batch: equal first losses; the first steps' peaks and
    gradient gap and the second steps' times printed."""
    import torch
    registry, adam = pkg.registry, pkg.adam
    cuda = DEVICE == 'cuda'
    batch = lm_train_batch(pkg, model.cfg, 2, rows, TRAIN_SEQ, DEVICE)
    runs = {}
    for remat in (True, False):
        m = copy.deepcopy(model)
        m.cfg = dataclasses.replace(model.cfg, remat=remat)
        step_fn, acfg = registry.make_train_step(
            m.cfg, registry.make_ctx(None, m.cfg),
            adam.AdamConfig(state_dtype=torch.float32))
        opt = adam.init(list(m.parameters()), acfg)
        held = memory_mark() if cuda else 0
        with adam_calls(pkg, keep_grads=True) as calls:
            _, opt, metrics = step_fn(m, opt, batch)
        loss = metrics['loss'].clone()
        peak = peak_since(held) if cuda else None
        # a second step, timed once the allocator holds what a step needs
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(m, opt, batch)
        if cuda:
            torch.cuda.synchronize()
        runs[remat] = {'loss': loss, 'grads': calls[0]['grads'],
                       'ms': (time.perf_counter() - t0) * 1e3,
                       'peak_above_held_bytes': peak}
        del m, opt
    on, off = runs[True], runs[False]
    gap = max(float((a.float() - b.float()).abs().max())
              / max(float(b.float().abs().max()), 1e-30)
              for a, b in zip(on['grads'], off['grads']))
    out = {'loss': [float(on['loss']), float(off['loss'])],
           'ms': [on['ms'], off['ms']],
           'peak_above_held_bytes': [on['peak_above_held_bytes'],
                                     off['peak_above_held_bytes']],
           'worst_leaf_grad_gap': gap}
    print(f'lm train {arch} (d) remat on, off (the first step\'s loss, '
          'peak and gradients; the second step\'s host clock with a sync): '
          + json.dumps(out), flush=True)
    if not torch.equal(on['loss'], off['loss']):
        fail(f'lm train {arch} (d): remat changed the loss: {out}')
    return out


def f32_dot(eq: str, a, b):
    """``layers._bf16_dot`` without its bfloat16 roundings."""
    import torch
    return torch.einsum(eq, a.float(), b.float())


def lm_train_step_pair(pkg, base, cfg32, batch: dict) -> list:
    """One ``make_train_step`` on float32 copies of ``base`` on the card
    and on the CPU: per device the loss, the grad norm and the gradients
    (as float32 CPU tensors, by parameter name)."""
    import torch
    registry = pkg.registry
    res = []
    for dev in (DEVICE, 'cpu'):
        m = copy.deepcopy(base).to(dev, torch.float32)
        m.cfg = cfg32
        step_fn, acfg = registry.make_train_step(
            cfg32, registry.make_ctx(None, cfg32))
        opt = pkg.adam.init(list(m.parameters()), acfg)
        with adam_calls(pkg, keep_grads=True) as calls:
            _, _, metrics = step_fn(m, opt, {k: v.to(dev)
                                              for k, v in batch.items()})
        res.append({'loss': float(metrics['loss']),
                    'grad_norm': calls[0]['grad_norm'],
                    'grads': dict(zip([k for k, _ in m.named_parameters()],
                                      (g.float().cpu()
                                       for g in calls[0]['grads'])))})
        del m, opt, calls
    return res


def lm_train_gaps(got: dict, want: dict) -> dict:
    """The losses, the grad norms and the worst gradient leaf, by its gap
    over the leaf's largest gradient and by its relative L2 gap (as
    ``tools/lm_grad_flips.py`` reads them)."""
    gaps, l2 = {}, {}
    for k, g in got['grads'].items():
        w = want['grads'][k]
        gaps[k] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
        l2[k] = float((g - w).norm()) / max(float(w.norm()), 1e-30)
    worst, worst_l2 = max(gaps, key=gaps.get), max(l2, key=l2.get)
    return {'loss': [got['loss'], want['loss']],
            'loss_rel': abs(got['loss'] - want['loss']) / abs(want['loss']),
            'grad_norm': [got['grad_norm'], want['grad_norm']],
            'grad_norm_rel': abs(got['grad_norm'] - want['grad_norm'])
            / want['grad_norm'],
            'worst_leaf': worst, 'worst_leaf_gap': gaps[worst],
            'worst_l2_leaf': worst_l2, 'worst_leaf_l2': l2[worst_l2]}


def lm_train_card_vs_cpu(pkg, base, cfg_c, arch: str) -> dict:
    """(c) one ``make_train_step`` on float32 copies of ``base`` on the card
    and on the CPU, the same tokens: the losses, the grad norms and every
    gradient leaf held.  As run, each leaf is held by its relative L2 gap:
    its largest element's gap is no test there, since a 1-ulp difference
    of a float32 sum flips a bfloat16 rounding of Q, K, P, V or of their
    cotangents in ``flash_attention``, and through the depth such flips
    move single elements of attention's gradients by up to a tenth of the
    leaf's largest.  Where the model runs ``flash_attention``, the leaves'
    largest elements are held on a second pair of steps with its roundings
    taken out on both devices (``f32_dot``).  ``tools/lm_grad_flips.py``
    measures both readings under 1-ulp noise on the weights, beside a
    faulty attention backward."""
    cfg32 = dataclasses.replace(cfg_c, dtype='float32', remat=False)
    batch = lm_train_batch(pkg, cfg32, 3, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ,
                           'cpu')
    t0 = time.perf_counter()
    out = {'n_layers': cfg_c.n_layers,
           'tokens': [TRAIN_CPU_BATCH, TRAIN_CPU_SEQ],
           'bounds': {'loss_rel': TRAIN_LOSS_REL, 'leaf_l2': TRAIN_LEAF_L2,
                      'leaf_gap_unrounded': LM_CPU_REL,
                      'grad_norm_rel': TRAIN_NORM_REL}}
    out['as_run'] = lm_train_gaps(*lm_train_step_pair(pkg, base, cfg32,
                                                      batch))
    gated = [out['as_run']]
    if cfg32.family != 'ssm':
        with patched([(pkg.layers, '_bf16_dot', 'f32_dot')],
                     lambda _, fn: f32_dot):
            out['unrounded'] = lm_train_gaps(*lm_train_step_pair(
                pkg, base, cfg32, batch))
        gated.append(out['unrounded'])
    out['wall_s'] = time.perf_counter() - t0
    print(f'lm train {arch} (c) card vs CPU, float32, one step: '
          + json.dumps(out), flush=True)
    ok = all(g['loss_rel'] <= TRAIN_LOSS_REL
             and g['grad_norm_rel'] <= TRAIN_NORM_REL for g in gated)
    if not (ok and out['as_run']['worst_leaf_l2'] <= TRAIN_LEAF_L2
            and gated[-1]['worst_leaf_gap'] <= LM_CPU_REL):
        fail(f'lm train {arch} (c): card and CPU differ: {out}')
    return out


def slstm_chunk_check(pkg) -> dict:
    """(f) of the LM train phase: the sLSTM walk in chunks on the card."""
    import torch
    t0 = time.perf_counter()
    xl = pkg.xlstm
    base = pkg.configs.get_config(SLSTM_ARCH)
    cfg = base if LM_FULL else base.reduced()
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    p = {k: v.requires_grad_() for k, v in
         xl.slstm_params(gen, cfg, dtype).items()}
    x = torch.randn((SLSTM_ROWS, SLSTM_SEQ, cfg.d_model), generator=gen,
                    device=DEVICE, dtype=dtype).requires_grad_()
    di, heads = 2 * cfg.d_model, cfg.n_heads
    w = xl.slstm_chunk(SLSTM_SEQ)
    with torch.no_grad():
        y_ng = xl.slstm_block(p, x, cfg)
    y = xl.slstm_block(p, x, cfg)
    grads = torch.autograd.grad(y.float().square().mean(),
                                [x] + list(p.values()))
    # gate 2 on the walk alone, from the block's own pre-activations
    pre = pkg.layers.project(pkg.layers.rmsnorm(x, p['ln'], cfg.norm_eps),
                             p['w_x'])[0].detach().requires_grad_()
    w_h = p['w_h_blocks']
    w32 = w_h.detach().float().requires_grad_()
    ins = (pre, w_h, w32)
    saved_bytes = pkg.op_count.saved_bytes
    walk, hs = saved_bytes(xl._slstm_scan, pre, w_h, heads, inputs=ins)
    zero = torch.zeros((SLSTM_ROWS, di), device=DEVICE)
    one, _ = saved_bytes(xl._slstm_walk, pre[:, :w], zero, zero, w32,
                         heads, inputs=ins)
    carries = (SLSTM_SEQ // w) * 2 * SLSTM_ROWS * di * 4
    # the walk's float32 copy of the recurrent weights, made once a walk
    # and an input of every chunk
    w32_bytes = 0 if w_h.dtype == torch.float32 else w32.numel() * 4
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    out = {'arch': cfg.name, 'rows': SLSTM_ROWS, 'seq': SLSTM_SEQ,
           'chunk': w, 'bit_for_bit': bool(torch.equal(y, y_ng)),
           'walk_saved_bytes': walk, 'one_chunk_bytes': one,
           'carry_bytes': carries, 'w32_bytes': w32_bytes,
           'grads_finite': all(bool(torch.isfinite(g).all()) for g in grads),
           'seconds': time.perf_counter() - t0}
    print('lm train (f) the sLSTM walk in chunks (saved bytes: autograd\'s '
          'storages during the forward, less its inputs\'): '
          + json.dumps(out), flush=True)
    del grads, hs, y, y_ng
    if not out['bit_for_bit']:
        fail('lm train (f): the sLSTM forward with grad on differs from the '
             'no-grad forward')
    if not walk < one + carries + w32_bytes:
        fail(f'lm train (f): the sLSTM walk saved {walk} bytes, more than '
             f'one chunk\'s {one} plus the carries\' {carries} and the '
             f'float32 weights\' {w32_bytes}')
    if not out['grads_finite']:
        fail('lm train (f): a gradient of the sLSTM block is not finite')
    return out


def lm_train_phase(pkg, arch: str, cpu_depth: int | None) -> dict:
    """LM training of ``arch`` at its full width and depth: (a) the
    trainer, (b) learning on one batch from a fresh draw of the weights
    (seed 0), (e) the step's time, (d) remat on
    and off (TRAIN_REMAT_ARCHS), (c) the card against the CPU on float32
    copies (of a ``cpu_depth``-layer model drawn alike, where given).
    Returns the printed numbers."""
    import torch
    t_phase = time.perf_counter()
    cuda = DEVICE == 'cuda'
    cfg, rows, out = lm_train_trainer(pkg, arch)
    if cuda:
        torch.cuda.empty_cache()
    model = pkg.registry.init_params(0, cfg, device=DEVICE)
    out.update(lm_train_fit_and_time(pkg, model, rows, arch))
    if arch in TRAIN_REMAT_ARCHS:
        out['remat'] = lm_train_remat(pkg, model, rows, arch)
    if cpu_depth is not None and LM_FULL:
        del model
        if cuda:
            torch.cuda.empty_cache()
        cfg_c = dataclasses.replace(cfg, n_layers=cpu_depth)
        base = pkg.registry.init_params(1, cfg_c, device=DEVICE)
    else:
        base, cfg_c = model, cfg
        del model
    out['card_vs_cpu'] = lm_train_card_vs_cpu(pkg, base, cfg_c, arch)
    del base
    if cuda:
        torch.cuda.empty_cache()
    out['phase_s'] = time.perf_counter() - t_phase
    print(f'lm train {arch} phase took {out["phase_s"]:.1f} s', flush=True)
    return out


def mesh_train(pkg, mesh) -> tuple:
    """(a) one train step of MESH_ARCH with ``mesh`` in its context and one
    without, from the same draw on the same batch: the expert-parallel
    calls, each MoE layer's drop fraction (equal exactly: at one rank the
    per-rank capacity is the global one), the loss and the grad norm
    (within lm_train_phase (c)'s bounds); then MESH_TIMED_STEPS more steps
    each, timed, and one profiled (kernel time and launches).  Returns
    (the printed numbers, the mesh run's model, optimizer state and
    step-0 gradients)."""
    import torch
    registry = pkg.registry
    base = pkg.configs.get_config(MESH_ARCH)
    cfg = (dataclasses.replace(base, n_layers=MESH_DEPTH) if LM_FULL
           else base.reduced())
    batch = lm_train_batch(pkg, cfg, 5, TRAIN_BATCH, TRAIN_SEQ, DEVICE)
    runs, keep = {}, None
    for label, m in (('mesh', mesh), ('no_mesh', None)):
        model = registry.init_params(0, cfg, device=DEVICE)
        step_fn, acfg = registry.make_train_step(cfg,
                                                 registry.make_ctx(m, cfg))
        opt = pkg.adam.init(list(model.parameters()), acfg)
        drops, ep = [], []

        def record_drop(_, fn):
            def moe_ffn(*a, **kw):
                out = fn(*a, **kw)
                drops.append(float(out[1]))
                return out
            return moe_ffn

        def record_ep(_, fn):
            def body(*a, **kw):
                ep.append(tuple(a[1].shape))
                return fn(*a, **kw)
            return body

        with adam_calls(pkg, keep_grads=True) as calls, \
                patched([(pkg.moe, 'moe_ffn', 'moe_ffn')], record_drop), \
                patched([(pkg.moe, '_moe_ffn_ep', 'ep')], record_ep):
            _, opt, metrics = step_fn(model, opt, batch)
            loss = float(metrics['loss'])
        grads = calls[0]['grads']
        held = {'opt': opt}

        def step():
            _, held['opt'], _ = step_fn(model, held['opt'], batch)

        runs[label] = {'loss': loss, 'grad_norm': calls[0]['grad_norm'],
                       'drops': drops, 'ep_calls': len(ep),
                       'step_ms': time_ms(step, MESH_TIMED_STEPS),
                       'device_busy': (lm_device_busy(step, 1)
                                       if DEVICE == 'cuda' else None)}
        if m is not None:
            keep = (model, held['opt'], grads)
        del model, held, calls, grads
    got, want = runs['mesh'], runs['no_mesh']
    out = {'arch': MESH_ARCH, 'n_layers': cfg.n_layers, 'dtype': cfg.dtype,
           'tokens': [TRAIN_BATCH, TRAIN_SEQ], **runs,
           'loss_rel': abs(got['loss'] - want['loss']) / abs(want['loss']),
           'grad_norm_rel': abs(got['grad_norm'] - want['grad_norm'])
           / want['grad_norm']}
    print('mesh (a) expert-parallel train step on (data 1, model 1) vs no '
          f'mesh (step_ms: {"CUDA events" if DEVICE == "cuda" else "host"}'
          f', median of {MESH_TIMED_STEPS} after the checked step and a '
          'warm-up): '
          + json.dumps(out), flush=True)
    # every MoE layer's forward takes the EP body (remat's recompute may
    # enter it again)
    n_moe = cfg.n_layers // cfg.moe_every
    if got['ep_calls'] < n_moe or want['ep_calls'] != 0:
        fail(f'mesh (a): expert-parallel calls {got["ep_calls"]} with the '
             f'mesh (want {n_moe} or more), {want["ep_calls"]} without '
             '(want 0)')
    if got['drops'] != want['drops'] or len(got['drops']) != n_moe:
        fail(f'mesh (a): drops differ: {got["drops"]} vs {want["drops"]}')
    if not (out['loss_rel'] <= TRAIN_LOSS_REL
            and out['grad_norm_rel'] <= TRAIN_NORM_REL
            and math.isfinite(got['loss'])):
        fail(f'mesh (a): the mesh step differs: {out}')
    return out, keep


def mesh_psum(pkg, mesh, grads) -> dict:
    """(b) ``psum_compressed`` of (a)'s gradients over ``data``: at one
    rank each leaf is ``decompress(compress(g))`` exactly."""
    import torch
    comp = pkg.compression
    t0 = time.perf_counter()
    red, _ = comp.psum_compressed(list(grads), None, mesh.get_group('data'))
    if DEVICE == 'cuda':
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    bad = [i for i, (g, r) in enumerate(zip(grads, red))
           if not torch.equal(r, comp.decompress(comp.compress(g)[0]))]
    out = {'leaves': len(red), 'elements': sum(g.numel() for g in grads),
           'wall_ms': wall, 'unequal_leaves': bad}
    print('mesh (b) psum_compressed over data (first call, host clock): '
          + json.dumps(out), flush=True)
    if bad:
        fail(f'mesh (b): psum_compressed differs from decompress(compress) '
             f'on leaves {bad}')
    return out


def mesh_frame(pkg, mesh) -> dict:
    """(c) the dry-run cell's frame on the mesh and without it: colors and
    n_significant bit for bit; then MESH_FRAME_REPS frames of each, in
    turns, timed by the host clock around synchronised work, the plain
    walk (``rasterize_tiles``) timed inside each frame."""
    import torch
    rd = pkg.render_dist
    n, w, h, cap = MESH_FRAME_SIZE or rd.RENDER_SHAPE_TABLE[MESH_FRAME]
    c = pkg.CONFIG
    lcfg = pkg.lp.LuminaConfig(capacity=cap, window=c.window, margin=c.margin,
                               k_record=c.k_record, sort_method='sorted')
    scene = pkg.structured_scene(SEED, n, device=DEVICE)
    cam = pkg.orbit_trajectory(1, width=w, height_px=h, device=DEVICE)[0]
    colors, nsig = rd._serve_frame(scene, cam, mesh, lcfg)
    alone = rd._serve_frame(scene, cam, None, lcfg)
    tiles = ((w + 15) // 16) * ((h + 15) // 16)
    if tuple(colors.shape) != (tiles, 256, 3) or \
            not bool(torch.isfinite(colors).all()) or int(nsig.sum()) <= 0:
        fail(f'mesh (c): frame {tuple(colors.shape)}, finite '
             f'{bool(torch.isfinite(colors).all())}, n_significant '
             f'{int(nsig.sum())}')
    if not (torch.equal(colors, alone[0]) and torch.equal(nsig, alone[1])):
        fail('mesh (c): the sharded frame differs from the mesh-free frame')

    def sync():
        if DEVICE == 'cuda':
            torch.cuda.synchronize()

    walk_s = []

    def timed(_, fn):
        def walk(*a, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            walk_s.append(time.perf_counter() - t)
            return out
        return walk

    times = {'mesh': [], 'no_mesh': []}
    walks = {'mesh': [], 'no_mesh': []}
    with patched([(rd, 'rasterize_tiles', 'walk')], timed):
        for _ in range(MESH_FRAME_REPS):
            for label, m in (('mesh', mesh), ('no_mesh', None)):
                sync()
                t = time.perf_counter()
                rd._serve_frame(scene, cam, m, lcfg)
                sync()
                times[label].append((time.perf_counter() - t) * 1e3)
                walks[label].append(walk_s[-1] * 1e3)
    _, _, flops = rd.build_dryrun_cell(c, mesh, MESH_FRAME)
    med = {k: statistics.median(v) for k, v in times.items()}
    share = [wk / fr for wk, fr in zip(walks['mesh'], times['mesh'])]
    out = {'cell': MESH_FRAME, 'gaussians': n, 'size': [w, h],
           'capacity': cap, 'tiles': tiles,
           'n_significant': int(nsig.sum()), 'frame_ms': med['mesh'],
           'no_mesh_frame_ms': med['no_mesh'], 'frame_ms_all': times,
           'plain_walk_ms': statistics.median(walks['mesh']),
           'plain_walk_share': statistics.median(share),
           'model_flops': flops}
    print(f'mesh (c) sharded frame == mesh-free frame (host clock, '
          f'synchronised; median of {MESH_FRAME_REPS} in turns): '
          + json.dumps(out), flush=True)
    return out


def mesh_elastic(pkg, cfg_model, opt) -> dict:
    """(d) (a)'s train state placed on a mesh rebuilt from
    ``plan_remesh(1, 0, model=1)`` with ``reshard_tree``: every value comes
    back bit for bit."""
    import torch
    el, P = pkg.elastic, pkg.sharding.P
    plan = el.plan_remesh(1, 0, model=1)
    mesh = el.build_mesh(plan, device=DEVICE)
    state = pkg.lm_train.train_state(cfg_model, opt)
    pspecs = pkg.registry.param_specs(cfg_model.cfg, cfg_model, mesh)
    ordered = tuple(pspecs[k] for k in state[0])
    specs = (pspecs, opt._replace(step=P(), mu=ordered, nu=ordered))
    t0 = time.perf_counter()
    placed = el.reshard_tree(state, specs, mesh)

    def is_t(x):
        return isinstance(x, torch.Tensor)

    got = [x.full_tensor() for x in pkg.tree.leaves(placed, is_t)]
    want = pkg.tree.leaves(state, is_t)
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not torch.equal(g, w)]
    out = {'plan': dataclasses.asdict(plan), 'leaves': len(want),
           'bytes': sum(x.numel() * x.element_size() for x in want),
           'wall_s': time.perf_counter() - t0, 'unequal_leaves': bad}
    print('mesh (d) elastic reshard of the train state: ' + json.dumps(out),
          flush=True)
    if bad or len(got) != len(want):
        fail(f'mesh (d): resharded values differ: {bad}')
    return out


def mesh_phase(pkg) -> dict:
    """The device mesh on this card: a one-rank process group (NCCL; gloo
    on the CPU) and a (data 1, model 1) mesh, then (a) expert-parallel
    training, (b) ``psum_compressed``, (c) the sharded frame, (d) the
    elastic round trip; GPipe needs two ranks (e)."""
    import torch
    import torch.distributed as dist
    t_phase = time.perf_counter()
    dist.init_process_group('nccl' if DEVICE == 'cuda' else 'gloo', rank=0,
                            world_size=1, store=dist.HashStore())
    try:
        mesh = pkg.mesh.make_test_mesh((1, 1), device=DEVICE)
        out = {}
        out['train'], (model, opt, grads) = mesh_train(pkg, mesh)
        out['psum'] = mesh_psum(pkg, mesh, grads)
        del grads
        out['elastic'] = mesh_elastic(pkg, model, opt)
        del model, opt
        if DEVICE == 'cuda':
            torch.cuda.empty_cache()
        out['frame'] = mesh_frame(pkg, mesh)
        print('mesh (e) GPipe: its schedule runs 2 stages on 2 ranks over '
              "'pod'; one card makes one rank, so it does not run here "
              '(tests/test_torch_mesh_ops.py holds it on 4 CPU ranks)',
              flush=True)
    finally:
        dist.destroy_process_group()
    out['phase_s'] = time.perf_counter() - t_phase
    print(f'mesh phase took {out["phase_s"]:.1f} s', flush=True)
    return out


def tp_hook_calls(pkg):
    """Patch ``ShardCtx._constrain`` to count the layout hooks' calls on
    DTensors (a list that grows by one a call)."""
    from torch.distributed.tensor import DTensor
    calls = []

    def wrap(_, fn):
        def constrain(self, x, assignments):
            if isinstance(x, DTensor):
                calls.append(1)
            return fn(self, x, assignments)
        return constrain

    return calls, patched([(pkg.sharding.ShardCtx, '_constrain', 'hooks')],
                          wrap)


def tp_ep_calls(pkg):
    """Patch ``moe._moe_ffn_ep`` to record the MoE parameters of each call
    (a list that grows by one a call)."""
    calls = []

    def wrap(_, fn):
        def body(p, *a, **kw):
            calls.append(p)
            return fn(p, *a, **kw)
        return body

    return calls, patched([(pkg.moe, '_moe_ffn_ep', 'ep')], wrap)


def tp_times(step, reps: int) -> dict:
    """Medians over ``reps`` calls of ``step()``, each after a sync:
    ``step_ms`` by CUDA events (the host clock to the sync on the CPU) and
    ``host_ms``, the host clock of the call alone (no sync after it), the
    time the host takes to issue the step."""
    import torch
    cuda = DEVICE == 'cuda'
    ms, host = [], []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            ms.append((time.perf_counter() - t0) * 1e3)
    return {'step_ms': statistics.median(ms),
            'host_ms': statistics.median(host)}


def tp_leaves(state) -> list:
    """The tensors of a decode state in one order: a K/V pair's in turn,
    a dict's by sorted key, nested dicts within."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in tp_leaves(state[k])]
    if isinstance(state, (tuple, list)):
        return [t for x in state for t in tp_leaves(x)]
    return [state]


def tp_config(pkg, arch: str, layers: int | None):
    """``arch``'s config in the tp phase: published widths, ``layers``
    deep where given (reduced in a CPU rehearsal)."""
    base = pkg.configs.get_config(arch)
    if not LM_FULL:
        return base.reduced()
    return base if layers is None else dataclasses.replace(base,
                                                           n_layers=layers)


def tp_train(pkg, mesh, arch: str, layers: int | None) -> dict:
    """One config of the tp phase: the step through the DTensor layout
    and plainly from one draw, checked, then timed both ways."""
    import torch
    registry = pkg.registry
    cfg = tp_config(pkg, arch, layers)
    cuda = DEVICE == 'cuda'
    plain = registry.init_params(0, cfg, device=DEVICE)
    batch = lm_train_batch(pkg, cfg, 6, TRAIN_BATCH, TRAIN_SEQ, DEVICE)
    # the layout copies every block (one rank keeps the whole value)
    model, _, dbatch = registry.shard_step_inputs(cfg, mesh, plain,
                                                  batch=batch)
    n_params = sum(p.numel() for p in plain.parameters())
    runs = {}
    for label, m, b, ctx_mesh in (('plain', plain, batch, None),
                                  ('dtensor', model, dbatch, mesh)):
        held = memory_mark() if cuda else 0
        step_fn, acfg = registry.make_train_step(
            cfg, registry.make_ctx(ctx_mesh, cfg))
        state = {'opt': pkg.adam.init(list(m.parameters()), acfg)}
        calls, hooks = tp_hook_calls(pkg)
        ep, ep_calls = tp_ep_calls(pkg)
        with hooks, ep_calls:
            _, state['opt'], metrics = step_fn(m, state['opt'], b)
        loss = metrics['loss']
        gnorm = metrics['grad_norm']
        if label == 'dtensor':
            loss, gnorm = loss.full_tensor(), gnorm.full_tensor()

        def step(step_fn=step_fn, m=m, b=b, state=state):
            _, state['opt'], _ = step_fn(m, state['opt'], b)

        runs[label] = {
            'loss': float(loss), 'grad_norm': float(gnorm),
            'hook_calls': len(calls), 'ep_calls': len(ep),
            'ep_layers': len({id(p) for p in ep}),
            **tp_times(step, TP_TIMED_STEPS),
            'device_busy': lm_device_busy(step, 1) if cuda else None,
            'peak_bytes': peak_since(held) if cuda else None}
        del state, step
    got, want = runs['dtensor'], runs['plain']
    out = {'arch': arch, 'n_layers': cfg.n_layers, 'dtype': cfg.dtype,
           'params': n_params, 'tokens': [TRAIN_BATCH, TRAIN_SEQ], **runs,
           'loss_rel': abs(got['loss'] - want['loss']) / abs(want['loss']),
           'grad_norm_rel': abs(got['grad_norm'] - want['grad_norm'])
           / want['grad_norm'],
           'bit_for_bit': (got['loss'] == want['loss']
                           and got['grad_norm'] == want['grad_norm']),
           'placements': sorted({str(tuple(p.placements))
                                 for p in model.parameters()})}
    print(f'tp {arch} ({cfg.n_layers} layers) through the DTensor layout on '
          '(data 1, model 1) vs plainly, from one draw (step_ms: '
          f'{"CUDA events" if cuda else "host"}, host_ms: host clock of the '
          f'call, medians of the same {TP_TIMED_STEPS} calls after the '
          'checked step; '
          'launches and kernel_ms: torch.profiler, one step; peak_bytes: '
          'above what was held as the run began, both models held): '
          + json.dumps(out), flush=True)
    if not (math.isfinite(got['loss']) and math.isfinite(got['grad_norm'])
            and out['loss_rel'] <= TP_LOSS_REL
            and out['grad_norm_rel'] <= TP_NORM_REL):
        fail(f'tp {arch}: the DTensor step differs from the plain step: '
             f'{out}')
    if got['hook_calls'] == 0 or want['hook_calls'] != 0:
        fail(f'tp {arch}: layout hooks on DTensors {got["hook_calls"]} '
             f'times through the layout (want some), {want["hook_calls"]} '
             'plainly (want 0)')
    if not all(isinstance(p, torch.distributed.tensor.DTensor)
               for p in model.parameters()):
        fail(f'tp {arch}: a parameter of the layout is not a DTensor')
    # every MoE layer's forward takes the EP body through the layout (remat's
    # recompute enters it again), none plainly
    n_moe = cfg.n_layers // cfg.moe_every if cfg.family == 'moe' else 0
    if got['ep_layers'] != n_moe or want['ep_calls'] != 0:
        fail(f'tp {arch}: the expert-parallel body ran in '
             f'{got["ep_layers"]} MoE layers through the layout (want '
             f'{n_moe}), {want["ep_calls"]} times plainly (want 0)')
    del plain, model, batch, dbatch
    if cuda:
        torch.cuda.empty_cache()
    return out


def tp_decode(pkg, mesh, arch: str, layers: int | None,
              long_context: bool = False) -> dict:
    """The decode part of one config of the tp phase: TP_DECODE_STEPS
    steps from position 0 through the DTensor layout and plainly, from one
    draw and the same tokens, logits and caches checked bit for bit, then
    the step at the next position timed both ways.  encdec decodes over
    the cross pair of ``prepare_cross``, made through the layout too and
    checked bit for bit.  ``long_context``: the long_500k shape, one row
    against caches of its whole length filled with seeded values, laid
    out by the long-context rule, TP_LONG_STEPS steps at the cache's last
    positions, the timed step beside the caches' bytes over
    TP_COPY_TBPS."""
    import torch
    registry = pkg.registry
    cfg = tp_config(pkg, arch, layers)
    cuda = DEVICE == 'cuda'
    long = pkg.configs.base.SHAPES['long_500k']
    rows, seq = ((long.global_batch, long.seq_len) if long_context
                 else (TP_DECODE_ROWS, TP_DECODE_SEQ[arch]))
    seq = seq if LM_FULL else TP_DECODE_CPU_SEQ
    n_steps = TP_LONG_STEPS if long_context else TP_DECODE_STEPS
    first = seq - n_steps - 1 if long_context else 0
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    plain = registry.init_params(0, cfg, device=DEVICE)
    state = registry.init_decode_state(cfg, rows, seq, device=DEVICE)
    if long_context:      # a full cache: every position holds a key
        for key in ('kv_k', 'kv_v'):
            state[key].normal_(generator=gen)
    cross_same = None
    if cfg.family == 'encdec':
        frames = torch.randn((rows, seq, cfg.d_model), generator=gen,
                             device=DEVICE).to(getattr(torch, cfg.dtype))
        state['cross'] = plain.prepare_cross(frames)
    # the layout copies every block (one rank keeps the whole value)
    model, dstate, _ = registry.shard_decode_inputs(
        cfg, mesh, plain, state, long_context=long_context)
    if cfg.family == 'encdec':
        dframes = registry.shard_step_inputs(cfg, mesh, None, batch={
            'frames': frames})[2]['frames']
        dcross = model.prepare_cross(dframes, registry.make_ctx(mesh, cfg))
        cross_same = all(torch.equal(d.to_local(), c)
                         for d, c in zip(dcross, state['cross']))
        del frames, dframes, dcross
    toks = torch.randint(0, cfg.vocab, (n_steps + 1, rows, 1),
                         generator=gen, device=DEVICE, dtype=torch.int32)
    progs = {'plain': (plain, state, None, list(toks)),
             'dtensor': (model, dstate, mesh, [
                 registry.shard_decode_inputs(cfg, mesh, token=t)[2]
                 for t in toks])}
    runs, logits = {}, {}
    for label, (m, st, ctx_mesh, tk) in progs.items():
        step = registry.make_decode_step(cfg, registry.make_ctx(
            ctx_mesh, cfg, long_context=long_context and bool(ctx_mesh)))
        held = memory_mark() if cuda else 0
        calls, hooks = tp_hook_calls(pkg)
        lgs = []
        with hooks:
            for i in range(n_steps):
                lg, out = step(m, tk[i], st, first + i)
                # written in place: the leaves given (encdec's step
                # returns them in a new dict, as the JAX package's does)
                if [id(t) for t in tp_leaves(out)] != [
                        id(t) for t in tp_leaves(st)]:
                    fail(f'tp decode {arch}: the {label} step returned '
                         'another state than it was given')
                lgs.append(lg.full_tensor() if ctx_mesh else lg)
        logits[label] = torch.stack(lgs)
        runs[label] = {'hook_calls': len(calls), 'step': step,
                       'peak_bytes': peak_since(held) if cuda else None}
    got, want = runs['dtensor'], runs['plain']
    same_logits = torch.equal(logits['dtensor'], logits['plain'])
    same_caches = [torch.equal(d.to_local(), c)
                   for d, c in zip(tp_leaves(dstate), tp_leaves(state))]
    for label, (m, st, _, tk) in progs.items():
        step = runs[label].pop('step')

        def one(step=step, m=m, st=st, t=tk[-1]):
            step(m, t, st, first + n_steps)

        runs[label].update(**tp_times(one, TP_TIMED_STEPS),
                           device_busy=lm_device_busy(one, 1) if cuda
                           else None)
    out = {'arch': arch, 'n_layers': cfg.n_layers, 'dtype': cfg.dtype,
           'rows': rows, 'cache_len': seq, 'steps': n_steps,
           'first_pos': first, 'long_context': long_context, **runs,
           'logits_max_abs': float((logits['dtensor'] - logits['plain'])
                                   .abs().max()),
           'bit_for_bit': same_logits and all(same_caches),
           'cross_bit_for_bit': cross_same,
           'state_leaves': len(same_caches),
           'state_placements': sorted({str(tuple(c.placements))
                                       for c in tp_leaves(dstate)})}
    if long_context:
        kv = sum(state[k].numel() * state[k].element_size()
                 for k in ('kv_k', 'kv_v'))
        out.update(cache_bytes=kv, bound_ms=kv / (TP_COPY_TBPS * 1e12) * 1e3)
    print(f'tp decode {arch} ({cfg.n_layers} layers, {rows} rows, cache '
          f'{seq}{", long-context layout" if long_context else ""}) '
          'through the DTensor layout on (data 1, model 1) vs plainly, '
          f'{n_steps} steps from position {first} (step_ms: '
          f'{"CUDA events" if cuda else "host"}, host_ms: host clock of the '
          f'call, medians of the same {TP_TIMED_STEPS} calls at position '
          f'{first + n_steps}; launches and kernel_ms: torch.profiler, one '
          'step; peak_bytes: above what was held as the checked steps '
          'began, both models held'
          + ('; bound_ms: cache_bytes over the copy rate '
             f'{TP_COPY_TBPS} TB/s' if long_context else '') + '): '
          + json.dumps(out), flush=True)
    if not same_logits or not all(same_caches) or cross_same is False:
        fail(f'tp decode {arch}: the DTensor decode differs from the plain '
             f'decode (logits equal: {same_logits}, state leaves equal: '
             f'{same_caches}, cross pair equal: {cross_same})')
    if got['hook_calls'] == 0 or want['hook_calls'] != 0:
        fail(f'tp decode {arch}: layout hooks on DTensors '
             f'{got["hook_calls"]} times through the layout (want some), '
             f'{want["hook_calls"]} plainly (want 0)')
    if not all(isinstance(c, torch.distributed.tensor.DTensor)
               for c in tp_leaves(dstate)):
        fail(f'tp decode {arch}: a state leaf of the layout is not a '
             'DTensor')
    del plain, model, state, dstate, progs
    if cuda:
        torch.cuda.empty_cache()
    return out


def tp_phase(pkg) -> dict:
    """The partitioned LM program on this card: a one-rank process group
    (NCCL; gloo on the CPU) and a (data 1, model 1) mesh, then each of
    TP_ARCHS stepped through the DTensor layout and plainly, its train
    step and its decode, and TP_LONG's decode at long_500k.  NCCL takes
    one rank a card, so the layouts that split work need more cards
    (tests/test_torch_mesh_tp.py, tests/test_torch_mesh_decode.py,
    tests/test_torch_mesh_ep.py, tests/test_torch_mesh_ssm.py,
    tests/test_torch_mesh_encdec.py and tests/test_torch_mesh_long.py
    hold them on 4 CPU ranks)."""
    import torch.distributed as dist
    import torch.distributed.tensor  # noqa: F401  (DTensor for tp_train)
    t_phase = time.perf_counter()
    dist.init_process_group('nccl' if DEVICE == 'cuda' else 'gloo', rank=0,
                            world_size=1, store=dist.HashStore())
    try:
        mesh = pkg.mesh.make_test_mesh((1, 1), device=DEVICE)
        out = {arch: {'train': tp_train(pkg, mesh, arch, layers),
                      'decode': tp_decode(pkg, mesh, arch, layers)}
               for arch, layers in TP_ARCHS}
        out[TP_LONG]['long_500k'] = tp_decode(pkg, mesh, TP_LONG,
                                              dict(TP_ARCHS)[TP_LONG],
                                              long_context=True)
    finally:
        dist.destroy_process_group()
    out['phase_s'] = time.perf_counter() - t_phase
    print(f'tp phase took {out["phase_s"]:.1f} s', flush=True)
    return out


def op_names(fn, *args) -> collections.Counter:
    """The aten and c10d ops that one call of ``fn`` dispatches, by name
    (to show where two counts part)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    names = collections.Counter()

    class Names(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            names[str(func)] += 1
            return func(*a, **(kw or {}))

    with Names():
        fn(*args)
    return names


def analysis_train(pkg) -> dict:
    """(a) one train step of ANALYSIS_ARCH counted on the card and on
    ``meta`` (FLOPs, matmul FLOPs, bytes and ops equal exactly), beside the
    model FLOPs; the step's time beside the roofline's; the counter's peak
    on ``meta`` beside the card's peak memory above the start."""
    import torch
    registry, oc = pkg.registry, pkg.op_count
    cuda = DEVICE == 'cuda'
    base = pkg.configs.get_config(ANALYSIS_ARCH)
    cfg = base if LM_FULL else base.reduced()
    step_fn, acfg = registry.make_train_step(cfg, registry.make_ctx(None, cfg))
    batch = lm_train_batch(pkg, cfg, 1, TRAIN_BATCH, TRAIN_SEQ, DEVICE)
    model = registry.init_params(SEED, cfg, device=DEVICE)
    state = {'opt': pkg.adam.init(list(model.parameters()), acfg)}
    held = memory_mark() if cuda else 0
    card = oc.analyze(step_fn, model, state['opt'], batch)
    card_peak = peak_since(held) if cuda else None
    meta_model = registry.abstract_params(cfg)
    meta_args = (meta_model, pkg.adam.init(list(meta_model.parameters()),
                                           acfg),
                 {k: torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                         device='meta')
                  for k, v in batch.items()})
    meta = oc.analyze(step_fn, *meta_args)
    keys = ('flops', 'dot_flops', 'bytes', 'n_ops')
    if any(card[k] != meta[k] for k in keys):
        got = op_names(step_fn, model, state['opt'], batch)
        want = op_names(step_fn, *meta_args)
        print(f'analysis (a) ops on {DEVICE} not on meta: {dict(got - want)}'
              f'; on meta not on {DEVICE}: {dict(want - got)}', flush=True)
        fail(f'analysis (a): the {DEVICE} count differs from the meta count: '
             + json.dumps({k: [card[k], meta[k]] for k in keys}))

    def step():
        _, state['opt'], _ = step_fn(model, state['opt'], batch)

    ms = time_ms(step, ANALYSIS_TIMED_STEPS)
    shape = pkg.ShapeConfig('train', TRAIN_SEQ, TRAIN_BATCH, 'train')
    mf = pkg.flops.model_flops(cfg, shape)
    roof = pkg.roofline.from_counts(ANALYSIS_ARCH, 'train', DEVICE, 1, card,
                                    model_flops=mf)
    out = {'arch': ANALYSIS_ARCH, 'n_layers': cfg.n_layers,
           'dtype': cfg.dtype, 'tokens': [TRAIN_BATCH, TRAIN_SEQ],
           'counts': {k: card[k] for k in keys + ('collective_bytes',
                                                   'kernels', 'peak_bytes')},
           'model_flops': mf, 'flops_over_model_flops': card['flops'] / mf,
           'step_ms': ms, 'roofline_step_ms': roof.step_time * 1e3,
           'roofline_bound': roof.bottleneck,
           't_compute_ms': roof.t_compute * 1e3,
           't_memory_ms': roof.t_memory * 1e3,
           'roofline_share': roof.step_time * 1e3 / ms,
           'meta_peak_bytes': meta['peak_bytes'],
           'card_peak_above_start_bytes': card_peak,
           'peak_ratio': (meta['peak_bytes'] / card_peak
                          if card_peak else None)}
    print(f'analysis (a) {ANALYSIS_ARCH} train step counted on {DEVICE} == '
          f'on meta (step_ms: {"CUDA events" if cuda else "host"}, median '
          f'of {ANALYSIS_TIMED_STEPS} outside the counter): '
          + json.dumps(out), flush=True)
    del model, state
    return out


def analysis_frame(pkg) -> dict:
    """(b) the ANALYSIS_FRAME cell's frame on this device: its walk's real
    chunks against the ``meta`` branch's worst case (every tile through
    capacity / chunk chunks), its op count on the device and on ``meta``,
    and its time beside the roofline's."""
    import torch
    rd, oc, rast = pkg.render_dist, pkg.op_count, pkg.rasterize
    n, w, h, cap = ANALYSIS_FRAME_SIZE or rd.RENDER_SHAPE_TABLE[ANALYSIS_FRAME]
    c = pkg.CONFIG
    lcfg = pkg.lp.LuminaConfig(capacity=cap, window=c.window, margin=c.margin,
                               k_record=c.k_record, sort_method='sorted')
    scene = pkg.structured_scene(SEED, n, device=DEVICE)
    cam = pkg.orbit_trajectory(1, width=w, height_px=h, device=DEVICE)[0]
    rows = []

    def walked(_, fn):
        def step(px, *a, **kw):
            rows.append(px.shape[0])
            return fn(px, *a, **kw)
        return step

    with patched([(rast, '_walk_step', 'walk')], walked):
        card = oc.analyze(rd._serve_frame, scene, cam, None, lcfg)
        walk_steps = len(rows)
        row_positions = sum(rows)
        rows.clear()
        meta_cam = pkg.orbit_trajectory(1, width=w, height_px=h,
                                        device='meta')[0]
        meta = oc.analyze(rd._serve_frame, rd.abstract_scene(n), meta_cam,
                          None, lcfg)
        meta_steps = len(rows)
    tiles = ((w + 15) // 16) * ((h + 15) // 16)
    chunk = rast.rasterize_tiles.__kwdefaults__['chunk']
    keys = ('flops', 'bytes', 'n_ops', 'peak_bytes')
    shown = ('flops', 'dot_flops', 'bytes', 'n_ops', 'peak_bytes')
    if walk_steps > meta_steps or meta_steps != cap or any(
            card[k] > meta[k] for k in keys):
        fail(f'analysis (b): the meta walk ({meta_steps} steps) does not '
             f'bound the real one ({walk_steps}): '
             + json.dumps({k: [card[k], meta[k]] for k in keys}))
    ms = time_ms(lambda: rd._serve_frame(scene, cam, None, lcfg),
                 ANALYSIS_TIMED_STEPS)
    _, _, mf = rd.build_dryrun_cell(c, None, ANALYSIS_FRAME)
    roof = pkg.roofline.from_counts('lumina-3dgs', ANALYSIS_FRAME, DEVICE, 1,
                                    card, model_flops=mf)
    out = {'cell': ANALYSIS_FRAME, 'gaussians': n, 'size': [w, h],
           'capacity': cap, 'tiles': tiles,
           'walk_chunks': walk_steps // chunk,
           'meta_walk_chunks': meta_steps // chunk,
           'walk_tile_chunks': row_positions // chunk,
           'meta_walk_tile_chunks': tiles * (cap // chunk),
           'counts': {k: card[k] for k in shown},
           'meta_counts': {k: meta[k] for k in shown},
           'frame_ms': ms, 'roofline_ms': roof.step_time * 1e3,
           'roofline_bound': roof.bottleneck,
           'roofline_share': roof.step_time * 1e3 / ms, 'model_flops': mf}
    print(f'analysis (b) {ANALYSIS_FRAME} frame on {DEVICE} (frame_ms: '
          f'{"CUDA events" if DEVICE == "cuda" else "host"}, median of '
          f'{ANALYSIS_TIMED_STEPS}): ' + json.dumps(out), flush=True)
    del scene
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()
    return out


def analysis_dryruns_start() -> list:
    """(c) one ``launch.dryrun`` subprocess per cell of ANALYSIS_DRYRUNS,
    started together: (cell, process, log path, start time)."""
    import os
    logs = HERE / 'build' / 'dryrun' / 'logs'
    logs.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(HERE / 'src'), OMP_NUM_THREADS='1')
    procs = []
    for arch, shape in ANALYSIS_DRYRUNS:
        log = logs / f'{arch}__{shape}__single.log'
        with open(log, 'w') as f:
            p = subprocess.Popen(
                [sys.executable, '-m', 'repro_torch.launch.dryrun', '--arch',
                 arch, '--shape', shape, '--mesh', 'single'],
                stdout=f, stderr=subprocess.STDOUT, cwd=HERE, env=env)
        procs.append(((arch, shape), p, log, time.perf_counter()))
    return procs


def analysis_dryruns_finish(pkg, procs) -> list:
    """(c) wait for each dry run: exit 0 within ANALYSIS_DRYRUN_TIMEOUT_S,
    then print its roofline row and count time."""
    out = []
    for (arch, shape), p, log, t0 in procs:
        try:
            rc = p.wait(timeout=max(1.0, ANALYSIS_DRYRUN_TIMEOUT_S
                                    - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            fail(f'analysis (c): the {arch} {shape} dry run took more than '
                 f'{ANALYSIS_DRYRUN_TIMEOUT_S} s')
        if rc != 0:
            fail(f'analysis (c): the {arch} {shape} dry run exited {rc}: '
                 + log.read_text()[-2000:])
        rec = json.loads((HERE / 'build' / 'dryrun'
                          / f'{arch}__{shape}__single.json').read_text())
        row = {'cell': [arch, shape, 'single'], 'chips': rec['chips'],
               'count_s': rec['count_s'], 'n_ops': rec['n_ops'],
               'wall_s': time.perf_counter() - t0,
               'memory_analysis': rec['memory_analysis'],
               'cost_analysis': rec['cost_analysis'],
               'roofline': rec['roofline']}
        print(f'analysis (c) dry run {arch} {shape} on the single mesh of '
              f'{rec["chips"]} fake ranks (meta): ' + json.dumps(row),
              flush=True)
        print('  ' + pkg.roofline.fmt_table([rec['roofline']]).replace(
            '\n', '\n  '), flush=True)
        if arch != 'lumina-3dgs' and not (
                'partitioned' in rec['roofline']['note']
                and rec['roofline']['useful_ratio'] >= ANALYSIS_MIN_USEFUL
                and sum(rec['roofline']['collective_counts'].values()) > 0):
            fail(f'analysis (c): the {arch} {shape} dry run is not the '
                 'partitioned program, or reads a useful share below '
                 f'{ANALYSIS_MIN_USEFUL} or no collectives: '
                 f'{rec["roofline"]}')
        out.append(row)
    return out


def analysis_peaks(pkg) -> dict:
    """(d) the card's own yardsticks: a bfloat16 matmul of
    ANALYSIS_MATMUL_N cubed and a copy of ANALYSIS_COPY_BYTES (read and
    written once), each median of ANALYSIS_PEAK_REPS, beside the roofline's
    datasheet constants."""
    import torch
    rl = peaks()
    n = ANALYSIS_MATMUL_N
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    a = torch.randn((n, n), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: torch.matmul(a, b), ANALYSIS_PEAK_REPS)
    del a, b
    src = torch.empty(ANALYSIS_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), ANALYSIS_PEAK_REPS)
    del src, dst
    if DEVICE == 'cuda':
        torch.cuda.empty_cache()
    flops = 2 * n ** 3
    moved = 2 * ANALYSIS_COPY_BYTES
    out = {'matmul': [n, n, n], 'matmul_ms': mm_ms,
           'bf16_tflops': flops / (mm_ms / 1e3) / 1e12,
           'datasheet_bf16_tflops': rl.PEAK_BF16_PER_S / 1e12,
           'copy_bytes': ANALYSIS_COPY_BYTES, 'copy_ms': copy_ms,
           'copy_tb_s': moved / (copy_ms / 1e3) / 1e12,
           'datasheet_hbm_tb_s': rl.PEAK_BYTES_PER_S / 1e12}
    out['bf16_share'] = out['bf16_tflops'] / out['datasheet_bf16_tflops']
    out['hbm_share'] = out['copy_tb_s'] / out['datasheet_hbm_tb_s']
    print(f'analysis (d) the card\'s own peaks (median of '
          f'{ANALYSIS_PEAK_REPS}, {"CUDA events" if DEVICE == "cuda" else "host"}'
          '): ' + json.dumps(out), flush=True)
    return out


def analysis_phase(pkg, procs=None) -> dict:
    """The analysis tools on this card: (c)'s dry runs start in
    subprocesses (unless ``procs`` holds them, started earlier), then (a)
    the counted train step on the card and on ``meta``, (b) the counted
    render frame, (d) the card's own peaks, and (c)'s records are read."""
    t_phase = time.perf_counter()
    procs = procs if procs is not None else analysis_dryruns_start()
    try:
        out = {'train': analysis_train(pkg), 'frame': analysis_frame(pkg),
               'peaks': analysis_peaks(pkg),
               'dryruns': analysis_dryruns_finish(pkg, procs)}
    finally:
        for _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out['phase_s'] = time.perf_counter() - t_phase
    print(f'analysis phase took {out["phase_s"]:.1f} s', flush=True)
    return out


def load_package(src: pathlib.Path):
    """Import the ``repro_torch`` package under ``src`` and gather the
    modules that the phases use."""
    sys.path.insert(0, str(src.resolve()))
    import repro_torch.checkpoint.manager as ckpt
    import repro_torch.configs.lumina_3dgs as arch
    import repro_torch.core.finetune as finetune
    import repro_torch.core.gaussians as gaussians
    import repro_torch.core.hwmodel as hwmodel
    import repro_torch.core.metrics as metrics
    import repro_torch.core.pipeline as lp
    import repro_torch.core.rasterize as rasterize
    import repro_torch.data.scenes as scenes
    import repro_torch.data.trajectory as trajectory
    import repro_torch.kernels as kernels
    import repro_torch.kernels.build as build
    import repro_torch.kernels.ops as ops
    import repro_torch.kernels.rasterize as rk
    import repro_torch.kernels.rc_lookup as rcl
    import repro_torch.configs as configs
    import repro_torch.launch.serve as lm_serve
    import repro_torch.launch.train as lm_train
    import repro_torch.analysis.flops as flops
    import repro_torch.analysis.op_count as op_count
    import repro_torch.analysis.roofline as roofline
    from repro_torch.configs.base import ShapeConfig
    import repro_torch.models.layers as layers
    import repro_torch.models.moe as moe
    import repro_torch.models.registry as registry
    import repro_torch.models.xlstm as xlstm
    import repro_torch.data.tokens as tokens
    import repro_torch.optim.adam as adam
    import repro_torch.obs as obs
    import repro_torch.serve as serve
    import repro_torch.runtime.straggler as straggler
    import repro_torch.serve.faults as faults
    import repro_torch.serve.fleet as fleet
    import repro_torch.serve.streaming as streaming
    import repro_torch.core.render_dist as render_dist
    import repro_torch.launch.mesh as mesh
    import repro_torch.optim.compression as compression
    import repro_torch.runtime.elastic as elastic
    import repro_torch.runtime.sharding as sharding
    import repro_torch.tree as tree
    return types.SimpleNamespace(
        kernels=kernels, CONFIG=arch.CONFIG, lp=lp, psnr=metrics.psnr,
        ssim=metrics.ssim, finetune=finetune, adam=adam, hwmodel=hwmodel,
        rasterize=rasterize, FIELDS=gaussians.FIELDS, ops=ops,
        rk=rk, rcl=rcl, serve=serve, structured_scene=scenes.structured_scene,
        orbit_trajectory=trajectory.orbit_trajectory, build=build,
        ckpt=ckpt, faults=faults, obs=obs, scenes=scenes,
        streaming=streaming, fleet=fleet, straggler=straggler,
        lm_serve=lm_serve, registry=registry, tokens=tokens, moe=moe,
        configs=configs, lm_train=lm_train, flops=flops, layers=layers,
        ShapeConfig=ShapeConfig, render_dist=render_dist, mesh=mesh,
        compression=compression, elastic=elastic, sharding=sharding,
        tree=tree, op_count=op_count, roofline=roofline, xlstm=xlstm)


def main() -> int:
    if not (HERE / 'src' / 'repro_torch').is_dir():
        print('chip_smoke: src/repro_torch not found beside this script',
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(HERE / 'src')
    lp, build = pkg.lp, pkg.build

    t_start = time.perf_counter()
    print(f'card: {card_line()}', flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}',
          flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f'kernels built in {time.perf_counter() - t0:.2f} s '
          f'({json.dumps({k: round(v, 2) for k, v in build.BUILD_SECONDS.items()})})',
          flush=True)
    for name in build.NAMES:
        for line in build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  ptxas {name}: {line.strip()}', flush=True)

    scene, cfg, cams, states, records, launches = main_path(pkg)
    reference_check(pkg, scene, cams, records)
    quality(pkg, scene, cams, records)
    t0 = time.perf_counter()
    paper_phase(pkg, scene, cams, records, cfg)
    print(f'paper phase took {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()

    last = len(cams) - 1
    sort_frame = cfg.window if len(cams) > cfg.window else 0
    for label, i, reps in (('shade', last, 5), ('sort+shade', sort_frame, 3)):
        t = stage_times(pkg, lambda: lp.render_step(scene, states[i], cams[i], cfg),
                        reps)
        print(f'stages of {label} frame {i} (median of {reps}, CUDA events, ms): '
              + json.dumps({k: round(v, 4) for k, v in t.items()}), flush=True)

    calls = capture_inputs(pkg, lambda: lp.render_step(scene, states[last],
                                                       cams[last], cfg))
    rows = kernel_phase(calls, pkg, launches, cfg.shade_chunk)
    del states, records, calls
    torch.cuda.empty_cache()
    stress_phase(pkg)
    compact_stress_phase(pkg)
    probe_stress_phase(pkg)

    serve_launches, capture, shared = serve_phase(pkg, scene)
    slots, compact, lookup = serve_kernel_rows(pkg, capture, serve_launches,
                                               cfg.shade_chunk)
    # rasterize_compact and rc_lookup run on both paths: their rows hold the
    # main path's call, and 'serve' holds the shared serving run's
    serve_keys = ('launches', 'max_abs_err', 'ms', 'kernel_ms', 'plain_ms',
                  'bound_ms', 'kernel_bound_ms', 'bound_by')
    for row, srow in ((rows[1], compact), (rows[2], lookup)):
        row['serve'] = {key: srow[key] for key in serve_keys if key in srow}
    rows.insert(1, slots)
    del capture
    torch.cuda.empty_cache()
    _, fault_rec = serve_state_phase(pkg, scene)
    t0 = time.perf_counter()
    realtime_phase(pkg, scene, shared, fault_rec)
    print(f'realtime phase took {time.perf_counter() - t0:.1f} s',
          flush=True)
    del shared, fault_rec
    t0 = time.perf_counter()
    fleet_phase(pkg, scene)
    print(f'fleet phase took {time.perf_counter() - t0:.1f} s', flush=True)
    torch.cuda.empty_cache()
    for arch, n_params, state_bytes, cpu_depth in LM_ARCHS:
        lm_serve_phase(pkg, arch, n_params, state_bytes, cpu_depth)
    lm_maverick_phase(pkg)
    t0 = time.perf_counter()
    for arch, _, _, cpu_depth in LM_ARCHS:
        lm_train_phase(pkg, arch, cpu_depth)
    slstm_chunk_check(pkg)
    print(f'LM train phases took {time.perf_counter() - t0:.1f} s',
          flush=True)
    # the dry runs of analysis (c) run in subprocesses beside the mesh and
    # tp phases
    procs = analysis_dryruns_start()
    try:
        mesh_phase(pkg)
        tp_phase(pkg)
    except BaseException:
        for _, p, _, _ in procs:
            p.kill()
            p.wait()
        raise
    analysis_phase(pkg, procs)
    print(f'total wall time {time.perf_counter() - t_start:.1f} s',
          flush=True)
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
